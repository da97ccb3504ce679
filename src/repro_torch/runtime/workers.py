"""Workers: the runtime's consumer threads.

A ``Worker`` is the online analogue of one pinned OpenMP thread: it has an
identity (``wid``) and a locality domain it is bound to (the paper's
``ld_ID`` map).  The executor steps workers cooperatively in a fixed
round-robin order — a deterministic stand-in for parallel hardware threads
(ordering, not wall-clock timing, is what the scheduling layer controls),
matching the discrete-event style used across this repo.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence


@dataclasses.dataclass
class WorkerStats:
    executed: int = 0
    local: int = 0
    stolen: int = 0
    idle_polls: int = 0


class Worker:
    """One consumer bound to a locality domain."""

    def __init__(self, wid: int, domain: int):
        self.wid = wid
        self.domain = domain
        self.stats = WorkerStats()

    def __repr__(self) -> str:
        return f"Worker(wid={self.wid}, domain={self.domain})"


class WorkerPool:
    """A fixed team of workers, iterated in wid order every scheduling round."""

    def __init__(self, domain_of_worker: Sequence[int]):
        if not domain_of_worker:
            raise ValueError("need at least one worker")
        self.workers = [Worker(wid, int(d)) for wid, d in enumerate(domain_of_worker)]

    @classmethod
    def uniform(cls, num_domains: int, workers_per_domain: int = 1) -> "WorkerPool":
        """Pinned layout: workers [0..k) on domain 0, [k..2k) on domain 1, …
        (the paper's core→LD map, ``topology.ld_id_map``)."""
        return cls([d for d in range(num_domains)
                    for _ in range(workers_per_domain)])

    def domains_covered(self) -> set[int]:
        return {w.domain for w in self.workers}

    def __len__(self) -> int:
        return len(self.workers)

    def __iter__(self) -> Iterator[Worker]:
        return iter(self.workers)

    def __getitem__(self, wid: int) -> Worker:
        return self.workers[wid]
