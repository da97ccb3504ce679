"""Elastic failover with the PyTorch/CUDA port (the twin of
``elastic_failover.py``): lose devices mid-run, re-mesh, resume.

  1. train with checkpointing on the full "fleet";
  2. a pod row "fails" -> plan_elastic_mesh computes the largest healthy
     rectangular mesh (model axis preserved, degraded data rows dropped);
  3. the locality schedule (data-pipeline shard ownership) is rebuilt for
     the survivor domains;
  4. training resumes from the latest checkpoint and continues.

    PYTHONPATH=src python examples/torch_elastic_failover.py --device cpu

The run is on the card unless ``--device cpu`` asks for the CPU.
"""
import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch.configs import get_config, reduce_config
from repro_torch.data.pipeline import make_batch_iterator
from repro_torch.distributed.fault import (DeviceSet, StragglerMonitor,
                                           plan_elastic_mesh, rebuild_schedule)
from repro_torch.models.model import build_model
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optimizer import AdamWConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40,
                    help="total steps; the failure comes after half of them")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_elastic_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu for the CPU)")
    args = ap.parse_args()
    cfg = reduce_config(get_config("qwen2-0.5b"))
    model = build_model(cfg, max_pos=64, device=args.device)
    ckpt_dir = args.ckpt
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    half = args.steps // 2

    def make_trainer(steps):
        return Trainer(model, make_batch_iterator(cfg.vocab_size, 32, 8, seed=7),
                       LoopConfig(total_steps=steps, checkpoint_every=max(half // 2, 1),
                                  checkpoint_dir=ckpt_dir, log_every=10),
                       AdamWConfig(lr=2e-3, warmup_steps=3, total_steps=args.steps))

    print(f"=== phase 1: healthy fleet, steps 0-{half} ===")
    out1 = make_trainer(half).run(seed=0)

    print("\n=== failure injected: chip (pod 0, data row 3, model 7) dies ===")
    fleet = DeviceSet(pods=2, data=16, model=16,
                      failed=frozenset({(0, 3, 7)}))
    plan = plan_elastic_mesh(fleet)
    print(f"re-mesh plan: {plan['mesh_shape']} "
          f"(lost {plan['lost_fraction']:.1%} of the fleet; "
          f"dropped rows: every pod trimmed to {plan['mesh_shape'][1]} rows)")

    # rebuild the data-pipeline locality schedule for the survivor count
    n_old = 2 * 16
    n_new = plan["mesh_shape"][0] * plan["mesh_shape"][1]
    homes = np.arange(64) % n_old
    sched = rebuild_schedule(homes, np.ones(64), n_old, n_new)
    print(f"data-shard schedule rebuilt: locality={sched.locality_fraction:.0%} "
          f"imbalance={sched.imbalance:.1%} moved={sched.moved}")

    print(f"\n=== phase 2: resume on the degraded fleet, steps {half}-{args.steps} ===")
    out2 = make_trainer(args.steps).run(seed=0)    # restores the step-`half` checkpoint

    l1 = out1["losses"]
    l2 = out2["losses"]
    print(f"\nloss at failure: {l1[-1]:.4f}; first post-resume losses: "
          f"{[round(x, 4) for x in l2[:3]]}")
    assert l2[0] < l1[0], "resumed run should continue, not restart"
    mon = StragglerMonitor(num_domains=4)
    for _ in range(6):
        report = mon.update([1.0, 1.0, 1.02, 1.55])
    print(f"straggler monitor post-failure: domains {report['stragglers']} "
          f"flagged, shedding {report['shed_fraction']}")
    print("\nelastic failover complete: re-mesh + schedule rebuild + resume.")


if __name__ == "__main__":
    main()
