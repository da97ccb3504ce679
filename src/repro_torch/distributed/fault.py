"""Fault tolerance: elastic re-meshing, straggler mitigation, restart policy.

On a 1000+-node fleet the failure model is: a pod loses chips (or a whole
pod drops), training must resume on the survivors from the last checkpoint.
Because the paper's schedule builder makes work→domain assignment an
explicit, recomputable artifact, elasticity is a *pure re-assignment*:

  1. detect the degraded device set (here: injected via DeviceSet),
  2. rebuild the mesh from survivors (largest rectangle that keeps the
     model axis intact — TP shards cannot be dropped, DP replicas can),
  3. re-run the locality schedule builder over the new domain set,
  4. restore the latest checkpoint with the new shardings and continue.

Straggler mitigation follows the paper's steal rule: the host-side loaders
and the serving router already steal from the slowest domain; for the
synchronous train step, the mitigation is micro-rebalancing the *data*
assignment (slow host gets fewer shards next epoch).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.assignment import Assignment, build_assignment


@dataclasses.dataclass(frozen=True)
class DeviceSet:
    """A (possibly degraded) fleet: pods x (data x model) grid per pod."""
    pods: int
    data: int
    model: int
    failed: frozenset[tuple[int, int, int]] = frozenset()  # (pod, d, m)

    @property
    def total(self) -> int:
        return self.pods * self.data * self.model - len(self.failed)


def plan_elastic_mesh(devs: DeviceSet) -> dict:
    """Largest healthy mesh after failures.

    Rule: the model axis must stay whole (a TP shard loss kills its data
    row); any data row containing a failure is dropped from the mesh; a pod
    that loses every row is dropped.  Returns the new mesh shape plus which
    rows survive — the input to re-sharding and schedule rebuild.
    """
    surviving_rows: list[tuple[int, int]] = []
    for p in range(devs.pods):
        for d in range(devs.data):
            row_ok = all((p, d, m) not in devs.failed for m in range(devs.model))
            if row_ok:
                surviving_rows.append((p, d))
    if not surviving_rows:
        raise RuntimeError("no healthy data rows survive — cannot re-mesh")
    pods_alive = sorted({p for p, _ in surviving_rows})
    # equalize rows per pod (SPMD needs a rectangular mesh)
    rows_per_pod = min(sum(1 for q, _ in surviving_rows if q == p)
                       for p in pods_alive)
    kept = []
    for p in pods_alive:
        rows = [r for r in surviving_rows if r[0] == p][:rows_per_pod]
        kept.extend(rows)
    return {
        "mesh_shape": (len(pods_alive), rows_per_pod, devs.model),
        "axes": ("pod", "data", "model"),
        "kept_rows": kept,
        "dropped_rows": [r for r in surviving_rows if r not in kept],
        "lost_fraction": 1.0 - (len(pods_alive) * rows_per_pod * devs.model
                                ) / (devs.pods * devs.data * devs.model),
    }


def rebuild_schedule(task_homes: np.ndarray, task_cost: np.ndarray,
                     old_domains: int, new_domains: int) -> Assignment:
    """Re-run the locality schedule for a changed domain count.

    Tasks homed in vanished domains become free (-1) and are placed by the
    balance rule; everything else keeps locality — the paper's scheduler
    makes elasticity cheap by construction.
    """
    homes = np.where(task_homes < new_domains, task_homes, -1)
    return build_assignment(homes, task_cost, new_domains)


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA per-domain step times; flags domains slower than k x median and
    proposes a data rebalance (shed fraction proportional to slowdown)."""
    num_domains: int
    alpha: float = 0.2
    threshold: float = 1.3
    _ewma: Optional[np.ndarray] = None

    def update(self, step_times: Sequence[float]) -> dict:
        t = np.asarray(step_times, dtype=np.float64)
        if self._ewma is None:
            self._ewma = t.copy()
        else:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * t
        med = float(np.median(self._ewma))
        ratio = self._ewma / max(med, 1e-9)
        stragglers = np.flatnonzero(ratio > self.threshold)
        rebalance = {int(d): float(min(0.5, 1.0 - 1.0 / ratio[d]))
                     for d in stragglers}
        return {"stragglers": stragglers.tolist(),
                "shed_fraction": rebalance,
                "ewma": self._ewma.copy()}
