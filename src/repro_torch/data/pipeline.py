"""Deterministic synthetic data pipeline with locality-aware host sharding.

The corpus is a seeded synthetic token stream (Zipfian unigram mixture with
injected n-gram structure so a ~100M model has something learnable); it is
split into SHARDS, and shard→host assignment goes through the paper's
schedule builder (repro.core.assignment): each host preferentially reads
the shards that feed the device slice it hosts ("first touch"), and a host
that runs dry steals the next shard from the most-loaded peer — the
locality-queue policy applied to input pipelines.  A prefetch thread keeps
`prefetch` batches staged.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ..core.assignment import build_assignment


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 64
    num_hosts: int = 1
    seed: int = 1234
    ngram_order: int = 3


class SyntheticCorpus:
    """Deterministic shard generator: shard i is reproducible in isolation
    (seeded by (seed, shard)), so restarts and elastic re-shards replay
    identically regardless of which host reads the shard."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # shared Zipf unigram table + a small deterministic bigram kick
        ranks = np.arange(1, v + 1)
        self.unigram = 1.0 / ranks ** 1.1
        self.unigram /= self.unigram.sum()
        self.bigram_shift = base.integers(1, v, size=257)

    def shard_tokens(self, shard: int, n_tokens: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, shard))
        toks = rng.choice(cfg.vocab_size, size=n_tokens, p=self.unigram)
        # inject learnable structure: token t+1 depends on t (mod table)
        mask = rng.random(n_tokens) < 0.5
        prev = np.roll(toks, 1)
        deterministic = (prev + self.bigram_shift[prev % 257]) % cfg.vocab_size
        return np.where(mask, deterministic, toks).astype(np.int32)


class ShardedLoader:
    """Locality-scheduled shard reader + prefetching batch iterator."""

    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.host_id = host_id
        self.corpus = SyntheticCorpus(cfg)
        # shard homes: shard s "lives" near host s % num_hosts (e.g. a
        # co-located storage volume); the schedule builder balances with
        # bounded stealing — the paper's technique at the pipeline layer.
        homes = np.arange(cfg.num_shards) % cfg.num_hosts
        cost = np.ones(cfg.num_shards)
        self.assignment = build_assignment(homes, cost, cfg.num_hosts,
                                           max_imbalance=0.05)
        self.my_shards = list(self.assignment.lists[host_id])
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # host-local slice of the global batch
    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.num_hosts

    def _producer(self) -> None:
        cfg = self.cfg
        need = self.host_batch * (cfg.seq_len + 1)
        step = 0
        while not self._stop.is_set():
            shard = self.my_shards[step % len(self.my_shards)]
            epoch = step // len(self.my_shards)
            toks = self.corpus.shard_tokens(shard * 100003 + epoch, need)
            chunk = toks.reshape(self.host_batch, cfg.seq_len + 1)
            batch = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()
        while True:
            _, batch = self._q.get()
            yield batch

    def close(self) -> None:
        self._stop.set()


def make_batch_iterator(vocab_size: int, seq_len: int, global_batch: int,
                        seed: int = 0) -> Iterator[dict[str, np.ndarray]]:
    """Simple non-threaded iterator for tests and the quickstart example."""
    cfg = DataConfig(vocab_size=vocab_size, seq_len=seq_len,
                     global_batch=global_batch, seed=seed)
    loader = ShardedLoader(cfg)
    corpus = loader.corpus
    step = 0
    while True:
        toks = corpus.shard_tokens(step, global_batch * (seq_len + 1))
        chunk = toks.reshape(global_batch, seq_len + 1)
        yield {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
        step += 1
