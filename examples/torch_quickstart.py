"""Quickstart with the PyTorch/CUDA port (the twin of ``quickstart.py``):

1. Simulate the paper's Fig. 3 experiment: blocked Jacobi under
   dynamic scheduling with and without locality queues.
2. Train a reduced LM from the assigned-architecture zoo for a few steps.
3. Serve it through the locality-queue request router.

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The model runs on the card unless ``--device cpu`` asks for the CPU.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import (NEHALEM_EP, SMALL_GRID, OpenMPLocalityQueues,
                              OpenMPTasking, StaticWorksharing, place, simulate)
from repro_torch.data.pipeline import make_batch_iterator
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optimizer import AdamWConfig


def part1_locality_queues():
    print("=" * 64)
    print("1. The paper's experiment: ccNUMA locality under tasking")
    print("=" * 64)
    topo = NEHALEM_EP
    ft = simulate(SMALL_GRID, topo, StaticWorksharing(),
                  place("static", SMALL_GRID, topo))
    task = simulate(SMALL_GRID, topo, OpenMPTasking("ijk"),
                    place("static", SMALL_GRID, topo), seed=0)
    lq = simulate(SMALL_GRID, topo, OpenMPLocalityQueues("kji"),
                  place("static1", SMALL_GRID, topo), seed=0)
    print(f"static first-touch (best case):   {ft.mlups:7.0f} MLUPs")
    print(f"plain OpenMP tasking (worst mix): {task.mlups:7.0f} MLUPs "
          f"(local access: {task.local_fraction:.0%})")
    print(f"locality queues (paper's fix):    {lq.mlups:7.0f} MLUPs "
          f"(local access: {lq.local_fraction:.0%})")
    print(f"-> locality queues recover {lq.mlups/ft.mlups:.1%} of optimal\n")


def part2_train(device, steps):
    print("=" * 64)
    print("2. Train a reduced qwen2-0.5b on the synthetic corpus")
    print("=" * 64)
    cfg = reduce_config(get_config("qwen2-0.5b"))
    model = build_model(cfg, max_pos=64, device=device)
    trainer = Trainer(model, make_batch_iterator(cfg.vocab_size, 32, 8),
                      LoopConfig(total_steps=steps, checkpoint_every=1000,
                                 log_every=5),
                      AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps))
    out = trainer.run()
    print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}\n")
    return cfg, model, out


def part3_serve(cfg, model, params):
    print("=" * 64)
    print("3. Serve it through the locality-queue request router")
    print("=" * 64)
    engine = ServingEngine(model, params, num_replicas=2, max_seq=64,
                           policy="locality", device=model.device)
    rng = np.random.default_rng(0)
    for i in range(6):
        toks = rng.integers(0, cfg.vocab_size, size=8)
        engine.submit(Request(uid=i, tokens=toks, max_new=4,
                              home_replica=i % 2))
    done = engine.run_until_drained()
    for r in done[:3]:
        print(f"  request {r.uid}: generated {r.out_tokens}")
    s = engine.stats
    print(f"  locality fraction: {s.locality_fraction:.0%}, "
          f"steals: {s.stolen}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu for the CPU)")
    args = ap.parse_args()
    part1_locality_queues()
    cfg, model, out = part2_train(args.device, args.steps)
    part3_serve(cfg, model, out["params"])
    print("\nDone. Next: examples/torch_train_100m.py, "
          "python -m repro_torch.launch.train --device cpu --smoke --arch qwen2-0.5b")
