"""Streaming metrics for the runtime executor.

Mirrors the quantities the paper reports for its scheduling experiments —
the local/steal split of executed tasks (Fig. 3's locality story) and the
price paid for balance (here an explicit steal-penalty account, e.g.
re-prefilled tokens in the serving engine) — plus online-only signals:
per-domain queue depth over time and the high-water mark of the bounded
submission pool (backpressure verification).
"""
from __future__ import annotations

import dataclasses
from collections import deque


@dataclasses.dataclass
class RuntimeStats:
    submitted: int = 0
    executed: int = 0
    local: int = 0           # executed in the task's home domain, not stolen
    stolen: int = 0          # executed from a foreign queue
    remote_steals: int = 0   # steals that crossed a topology tier (level >= 2)
    inline_runs: int = 0     # executed by the submitter under backpressure
    idle_polls: int = 0      # dequeue attempts that found nothing eligible
    steal_penalty: float = 0.0   # accumulated nonlocal-access cost
    max_pool_depth: int = 0      # high-water mark of queued-but-unrun tasks

    @property
    def local_fraction(self) -> float:
        return self.local / max(self.executed, 1)

    @property
    def steal_fraction(self) -> float:
        return self.stolen / max(self.executed, 1)

    @property
    def remote_fraction(self) -> float:
        """Cross-tier (level >= 2) steals over executed tasks — always 0 on
        flat machines, the quantity the topology benchmark minimizes."""
        return self.remote_steals / max(self.executed, 1)


class MetricsRecorder:
    """Counters plus a bounded time series of per-domain queue depths."""

    def __init__(self, depth_window: int = 4096, depth_stride: int = 1):
        if depth_stride < 1:
            raise ValueError(f"depth_stride must be >= 1, got {depth_stride}")
        self.stats = RuntimeStats()
        self.depth_stride = depth_stride
        self._depths: deque[tuple[int, tuple[int, ...]]] = deque(maxlen=depth_window)

    # -- hooks called by the executor --------------------------------------
    def on_submit(self, pool_depth: int) -> None:
        self.stats.submitted += 1
        self.stats.max_pool_depth = max(self.stats.max_pool_depth, pool_depth)

    def on_execute(self, local: bool, stolen: bool, penalty: float,
                   inline: bool, remote: bool = False) -> None:
        self.stats.executed += 1
        if local:
            self.stats.local += 1
        if stolen:
            self.stats.stolen += 1
            self.stats.steal_penalty += penalty
            if remote:
                self.stats.remote_steals += 1
        if inline:
            self.stats.inline_runs += 1

    def on_idle(self) -> None:
        self.stats.idle_polls += 1

    def wants_depths(self, step: int) -> bool:
        """Whether ``step`` falls on the depth-sampling stride.  The
        executor consults this before building the O(domains) size list, so
        a stride > 1 skips the sampling cost, not just the storage."""
        return step % self.depth_stride == 0

    def sample_depths(self, step: int, sizes: list[int]) -> None:
        self._depths.append((step, tuple(sizes)))

    # -- read side ----------------------------------------------------------
    def depth_series(self) -> list[tuple[int, tuple[int, ...]]]:
        return list(self._depths)

    def snapshot(self) -> dict[str, float]:
        s = self.stats
        return {
            "submitted": s.submitted,
            "executed": s.executed,
            "local": s.local,
            "stolen": s.stolen,
            "remote_steals": s.remote_steals,
            "inline_runs": s.inline_runs,
            "idle_polls": s.idle_polls,
            "steal_penalty": s.steal_penalty,
            "max_pool_depth": s.max_pool_depth,
            "local_fraction": s.local_fraction,
            "steal_fraction": s.steal_fraction,
        }
