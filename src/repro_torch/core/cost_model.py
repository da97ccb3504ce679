"""Bandwidth cost model: weighted max-min fair rate allocation on the ccNUMA graph.

A running block update is a *flow* pulling the block's bytes from the memory
of the block's home locality domain.  Resources (calibrated to the paper's
Table 1 STREAM numbers):

  * ``bus[l]``      — LD l's memory bus, capacity ``local_bw``; used by every
                      flow homed in l, local or remote.
  * ``ingress[l]``  — the interconnect path out of LD l, capacity
                      ``remote_factor * local_bw``; used by flows homed in l
                      but executing elsewhere.  This is the aggregate "NUMA
                      effect": even perfectly balanced nonlocal traffic cannot
                      exceed it (strongest on Nehalem EP, paper §1.4).
  * per-flow caps   — one core draws at most ``core_bw`` locally and
                      ``remote_factor * core_bw`` remotely.

``home_ld = -1`` marks an *interleaved* flow (``numactl -i`` page placement,
paper §1.1): its traffic spreads uniformly over all LDs, so it loads every
bus with weight 1/L and every foreign ingress with weight 1/L.

Rates are the weighted max-min fair allocation (progressive filling).  The
model reproduces the paper's three reference regimes: serial placement ⇒ all
flows homed in LD0 ⇒ aggregate ≤ one bus; parallel first touch ⇒ all local ⇒
aggregate ≈ full machine; round-robin interleave ⇒ in between, degraded by
the ingress pipes.
"""
from __future__ import annotations

import numpy as np

from .topology import MachineTopology


def maxmin_rates(home_ld: np.ndarray, exec_ld: np.ndarray,
                 topo: MachineTopology) -> np.ndarray:
    """Weighted max-min fair rates (GB/s) for the active flows.

    Args:
      home_ld: (F,) home LD of each flow's block; -1 = page-interleaved.
      exec_ld: (F,) LD of the core executing each flow.
    Returns:
      (F,) rates in GB/s.
    """
    f = len(home_ld)
    if f == 0:
        return np.zeros(0)
    home_ld = np.asarray(home_ld, dtype=np.int64)
    exec_ld = np.asarray(exec_ld, dtype=np.int64)
    ndom = topo.num_domains

    # resources: [bus 0..L-1, ingress 0..L-1]
    nres = 2 * ndom
    cres = np.empty(nres)
    cres[:ndom] = topo.local_bw
    cres[ndom:] = topo.remote_factor * topo.local_bw

    w = np.zeros((f, nres))
    cap = np.empty(f)
    for i in range(f):
        h, e = home_ld[i], exec_ld[i]
        if h < 0:  # interleaved over all LDs
            w[i, :ndom] = 1.0 / ndom
            for l in range(ndom):
                if l != e:
                    w[i, ndom + l] = 1.0 / ndom
            cap[i] = topo.core_bw
        elif h == e:
            w[i, h] = 1.0
            cap[i] = topo.core_bw
        else:
            w[i, h] = 1.0
            w[i, ndom + h] = 1.0
            cap[i] = topo.core_bw * topo.remote_factor

    rate = np.zeros(f)
    frozen = np.zeros(f, dtype=bool)
    eps = 1e-12

    while not frozen.all():
        unfrozen = ~frozen
        growth = w[unfrozen].sum(axis=0)            # per-resource fill speed
        slack = cres - rate @ w
        with np.errstate(divide="ignore", invalid="ignore"):
            d_res = np.where(growth > eps, slack / growth, np.inf)
        d_cap = cap[unfrozen] - rate[unfrozen]
        d = min(d_res.min(), d_cap.min())
        d = max(d, 0.0)
        rate[unfrozen] += d
        # freeze flows at their cap
        at_cap = unfrozen & (rate >= cap - eps)
        # freeze flows touching a saturated resource
        slack = cres - rate @ w
        sat = slack <= eps * np.maximum(cres, 1.0)
        touches_sat = (w[:, sat] > eps).any(axis=1) if sat.any() else np.zeros(f, bool)
        newly = at_cap | (unfrozen & touches_sat)
        if not newly.any():       # numerical guard: freeze the slowest flow
            idx = np.flatnonzero(unfrozen)[0]
            newly = np.zeros(f, bool)
            newly[idx] = True
        frozen |= newly
    return rate


def stream_sanity(topo: MachineTopology) -> dict[str, float]:
    """Aggregate bandwidths for the limiting regimes (vs Table 1)."""
    t = topo.num_cores
    exec_ld = np.array([topo.domain_of_core(c) for c in range(t)])
    local = maxmin_rates(exec_ld.copy(), exec_ld, topo)          # first touch
    serial = maxmin_rates(np.zeros(t, np.int64), exec_ld, topo)  # all in LD0
    inter = maxmin_rates(np.full(t, -1, np.int64), exec_ld, topo)  # numactl -i
    return {
        "full_local_bw": float(local.sum()),
        "serial_ld0_bw": float(serial.sum()),
        "interleaved_bw": float(inter.sum()),
    }
