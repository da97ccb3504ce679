"""Discrete-event execution simulator for the paper's benchmark runs.

Simulates a team of pinned (or unpinned) threads executing the blocked Jacobi
sweep under a scheduling ``Policy`` on a ccNUMA ``MachineTopology``.  Memory
is the only resource that matters (the solver is strictly memory-bound,
paper §1.4); running blocks are fluid flows whose rates are the max-min fair
allocation of ``cost_model.maxmin_rates``, re-evaluated whenever the flow set
changes.

OpenMP tasking semantics (paper §2.1) are modelled faithfully:
  * a single submitter thread feeds a bounded task pool (default cap 256 —
    "the limit is set to roughly 256 tasks with the compiler used");
  * when the pool is full the submitter executes one task itself, then
    resumes submitting ("the submitting thread is used for processing tasks
    for some time");
  * after the last submission the submitter joins the consumers.

Per-task dispatch/steal/submit overheads carry multiplicative jitter, which
is the source of the (small) run-to-run variability of Fig. 4.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .cost_model import maxmin_rates
from .scheduler import Policy
from .tasks import BlockGrid, block_bytes
from .topology import MachineTopology

IDLE, SUBMIT, OVERHEAD, RUN, DONE = range(5)


@dataclasses.dataclass
class SimParams:
    dispatch_overhead_us: float = 1.0   # consumer per-task dispatch cost
    submit_overhead_us: float = 0.5     # submitter per-task cost
    steal_overhead_us: float = 0.5      # extra scan cost on a steal
    jitter_frac: float = 0.03           # multiplicative noise on overheads
    pool_cap: int = 256                 # OpenMP queued-task limit


@dataclasses.dataclass
class SimResult:
    makespan_s: float
    mlups: float                 # mega lattice-site updates per second
    local_fraction: float        # fraction of blocks executed in home LD
    steal_fraction: float        # fraction of blocks obtained by stealing
    policy: str
    topology: str

    @property
    def glups(self) -> float:
        return self.mlups / 1e3


def simulate(grid: BlockGrid, topo: MachineTopology, policy: Policy,
             homes: np.ndarray, params: SimParams | None = None,
             seed: int = 0, pinned: bool = True) -> SimResult:
    params = params or SimParams()
    rng = np.random.default_rng(seed)
    nthreads = topo.num_cores
    nblocks = grid.num_blocks

    if pinned:
        thread_ld = np.array(topo.ld_id_map())
    else:
        # unpinned threads wander; model as a random core assignment that the
        # policy cannot see coming (paper: "n-p" TBB runs).
        thread_ld = np.array(topo.ld_id_map())[rng.permutation(nthreads)]

    policy.reset(grid, homes, topo, thread_ld, rng)

    bpb = float(block_bytes(grid, topo.nt_stores))

    def jit(us: float) -> float:
        return max(us * (1.0 + params.jitter_frac * rng.standard_normal()), 0.01) * 1e-6

    state = np.full(nthreads, IDLE, dtype=np.int64)
    ready = np.zeros(nthreads)          # wake time for SUBMIT/OVERHEAD states
    cur = np.full(nthreads, -1, dtype=np.int64)   # block being dispatched/run
    rem = np.zeros(nthreads)            # remaining bytes for RUN flows
    rate = np.zeros(nthreads)           # bytes/s for RUN flows

    submitter = 0 if policy.uses_submitter else -1
    if submitter >= 0:
        state[submitter] = SUBMIT
        ready[submitter] = 0.0

    t = 0.0
    executed = 0
    local_count = 0
    steal_count = 0
    rates_dirty = False

    def try_dispatch(th: int) -> bool:
        """Idle/finished thread asks the policy for work."""
        nonlocal steal_count
        got = policy.pop(th)
        if got is None:
            state[th] = IDLE
            return False
        cur[th] = got.block
        ov = jit(params.dispatch_overhead_us)
        if got.stolen:
            steal_count += 1
            ov += jit(params.steal_overhead_us)
        state[th] = OVERHEAD
        ready[th] = t + ov
        return True

    def wake_idle() -> None:
        for th in range(nthreads):
            if state[th] == IDLE:
                try_dispatch(th)

    def recompute_rates() -> None:
        running = np.flatnonzero(state == RUN)
        if len(running) == 0:
            return
        h = np.array([homes[cur[th]] for th in running])
        r = maxmin_rates(h, thread_ld[running], topo)
        rate[running] = r * 1e9

    # prime: non-submitter policies have everything available at t=0
    wake_idle()
    recompute_rates()

    guard = 0
    while executed < nblocks:
        guard += 1
        if guard > 40 * nblocks + 10000:
            raise RuntimeError("simulator failed to converge (livelock?)")

        # --- next event time ------------------------------------------------
        tnext = np.inf
        for th in range(nthreads):
            if state[th] in (SUBMIT, OVERHEAD):
                tnext = min(tnext, ready[th])
            elif state[th] == RUN and rate[th] > 0:
                tnext = min(tnext, t + rem[th] / rate[th])
        if not np.isfinite(tnext):
            raise RuntimeError(
                "deadlock: no runnable thread but blocks remain "
                f"(executed={executed}/{nblocks}, policy={policy.name})")

        # --- advance fluid flows -------------------------------------------
        dt = max(tnext - t, 0.0)
        running = state == RUN
        rem[running] -= rate[running] * dt
        t = tnext

        eps = 1e-12
        pool_changed = False

        # --- completions ----------------------------------------------------
        for th in np.flatnonzero(running):
            if rem[th] <= bpb * 1e-12 + eps:
                executed += 1
                if homes[cur[th]] == thread_ld[th]:
                    local_count += 1
                cur[th] = -1
                rates_dirty = True
                if state[th] == RUN:
                    # submitter resumes submitting if work remains
                    if th == submitter and policy.has_unsubmitted():
                        state[th] = SUBMIT
                        ready[th] = t
                    else:
                        try_dispatch(th)
                pool_changed = True

        # --- overhead expiry: start the flow --------------------------------
        for th in range(nthreads):
            if state[th] == OVERHEAD and ready[th] <= t + eps:
                state[th] = RUN
                rem[th] = bpb
                rates_dirty = True

        # --- submitter ------------------------------------------------------
        if submitter >= 0 and state[submitter] == SUBMIT and ready[submitter] <= t + eps:
            capacity = params.pool_cap - policy.pool_size()
            if not policy.has_unsubmitted():
                # join the team (paper: "this thread will join the others")
                if not try_dispatch(submitter):
                    state[submitter] = IDLE
            elif capacity > 0:
                k = 0
                dt_sub = 0.0
                while capacity > 0 and policy.has_unsubmitted():
                    policy.submit_one()
                    dt_sub += jit(params.submit_overhead_us)
                    capacity -= 1
                    k += 1
                ready[submitter] = t + dt_sub
                pool_changed = True
            else:
                # pool full: execute one task, then resume submitting
                try_dispatch(submitter)

        if pool_changed:
            wake_idle()
        if rates_dirty:
            recompute_rates()
            rates_dirty = False

    mlups = grid.total_sites / t / 1e6
    return SimResult(
        makespan_s=t,
        mlups=mlups,
        local_fraction=local_count / nblocks,
        steal_fraction=steal_count / nblocks,
        policy=policy.name,
        topology=topo.name,
    )


def run_samples(grid: BlockGrid, topo: MachineTopology, make_policy,
                homes: np.ndarray, n_samples: int = 15,
                params: SimParams | None = None, pinned: bool = True,
                seed0: int = 0) -> list[SimResult]:
    """n_samples independent runs (fresh policy + RNG each) — Fig. 4 style."""
    out = []
    for s in range(n_samples):
        out.append(simulate(grid, topo, make_policy(), homes, params,
                            seed=seed0 + s, pinned=pinned))
    return out


def summarize(results: list[SimResult]) -> dict[str, float]:
    # percentiles via the shared deterministic helper (repro.obs): exact
    # nearest-rank over the full sample, so every quantile is an observed
    # trial value rather than an interpolation artifact.
    from ..obs.metrics import percentile
    m = [r.mlups for r in results]
    return {
        "median_mlups": float(percentile(m, 50)),
        "q25": float(percentile(m, 25)),
        "q75": float(percentile(m, 75)),
        "q05": float(percentile(m, 5)),
        "q95": float(percentile(m, 95)),
        "local_fraction": float(np.mean([r.local_fraction for r in results])),
        "steal_fraction": float(np.mean([r.steal_fraction for r in results])),
    }
