"""Serving scenario: the locality-queue request router vs naive policies.

The twin of ``serve_router.py`` on the PyTorch/CUDA port.  Multi-turn chat
sessions have KV/prefix-cache affinity to the replica that served their
first turn; the paper's router (local queue first, steal when idle)
minimizes cache-miss re-prefills while keeping replicas busy.

    PYTHONPATH=src python examples/torch_serve_router.py --device cpu

The model runs on the card unless ``--device cpu`` asks for the CPU (there
attention runs in K3, the hand-written Hopper flash attention kernel).  Its
weights come from a ``torch.Generator`` seeded 0, so its tokens are the
port's own; the schedule numbers (local%, steals, prefill tokens) do not
depend on the weights and are the reference example's.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServingEngine


def workload(cfg, n=18, replicas=3, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size, size=int(rng.integers(8, 20)))
        # 70% are follow-up turns with an existing cache home; skew the homes
        # (replica 0 is hot) so stealing has something to balance
        if rng.random() < 0.7:
            home = int(rng.choice([0, 0, 1, 2]))
        else:
            home = -1
        reqs.append(Request(uid=i, tokens=toks, max_new=6, home_replica=home))
    return reqs


def main(device=None):
    cfg = reduce_config(get_config("qwen2-0.5b"))
    model = build_model(cfg, max_pos=96, device=device)
    params = model.init_params(torch.Generator(device=model.device).manual_seed(0))

    print(f"{'policy':14s} {'local%':>7s} {'steals':>7s} {'prefill_toks':>13s}")
    baseline = None
    for policy in ("single_queue", "round_robin", "locality"):
        eng = ServingEngine(model, params, num_replicas=3, max_seq=64,
                            policy=policy, device=model.device)
        for r in workload(cfg):
            eng.submit(r)
        done = eng.run_until_drained()
        s = eng.stats
        if baseline is None:
            baseline = {r.uid: tuple(r.out_tokens) for r in done}
        else:
            assert baseline == {r.uid: tuple(r.out_tokens) for r in done}, \
                "routing must not change results"
        print(f"{policy:14s} {s.locality_fraction:7.0%} {s.stolen:7d} "
              f"{s.prefill_tokens:13d}")
    print("\nidentical outputs under every policy; locality routing "
          "maximizes cache hits (local%), stealing keeps replicas busy.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu for the CPU)")
    main(ap.parse_args().device)
