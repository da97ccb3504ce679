"""Continuous batching: adapt the executor's batch-grab size online.

A batch grab amortizes one scheduling round over several same-queue tasks
(``Executor(batch=...)``): the bigger the batch, the higher the per-round
throughput — but also the longer one grab monopolizes a worker, so batches
must shrink when tasks get expensive (long prefills) and may grow when
tasks are cheap.  ``BatchGovernor`` closes that loop from measurements: it
tracks an EMA of the per-task service actually delivered per batch (task
cost plus any steal penalty — the deterministic service proxy used across
the repo, so controlled runs stay replayable) and sizes the next batch to
fit a fixed per-grab service budget:

    size = clamp(round(target_service / per_task_service), batch_min, batch_cap)

The governor also exposes ``target_service`` as the grab's cost ``budget``
(the executor stops draining before a batch's summed cost exceeds it), so
every grab delivers ≈ ``target_service`` cost units per round regardless of
the cost mix — cheap tasks run wide, one long prefill fills the budget
alone.  That constant cost-per-round drain rate is what makes a queue's
total queued cost an honest backlog-*time* estimate, i.e. what makes
``CostRouter``'s join-shortest-work routing correct.

Steal penalties inflate measured service, so batches automatically thin
out exactly when grabs start migrating work — the batching analogue of the
``AdaptiveSteal`` throttle.
"""
from __future__ import annotations

_MIN_SERVICE = 1e-9


class BatchGovernor:
    """Adaptive batch-size policy for ``Executor(batch=...)``.

    Implements the executor's batch-policy duck type: a ``size`` property
    read before each grab and an ``on_batch(n_tasks, service)`` feedback
    call after it.

    With ``per_domain=True`` the governor keeps one service EMA *per source
    queue* under the same global ``target_service`` budget — a domain
    serving long prefills grabs thin batches while a domain of cheap tasks
    grabs wide ones, instead of one global estimate splitting the
    difference and mis-sizing both.  The executor then reads
    ``size_for(domain)`` per grab and feeds back
    ``on_batch(n_tasks, service, domain)``; the global EMA keeps updating
    alongside (it sizes domains never yet observed, and remains the
    ``service_estimate``/``size`` surface).

    Parameters
    ----------
    target_service:  service budget (cost units) one grab should fill.
    batch_min/cap:   hard clamp on the adapted size.
    ema:             smoothing of the per-task service estimate in (0, 1].
    init_size:       batch size before the first measurement.
    per_domain:      size grabs from each queue by that queue's own EMA.
    """

    per_domain: bool

    def __init__(self, target_service: float = 8.0, batch_min: int = 1,
                 batch_cap: int = 8, ema: float = 0.25, init_size: int = 1,
                 per_domain: bool = False):
        if target_service <= 0:
            raise ValueError("target_service must be positive")
        if not 1 <= batch_min <= batch_cap:
            raise ValueError("need 1 <= batch_min <= batch_cap")
        if not 0.0 < ema <= 1.0:
            raise ValueError("ema must be in (0, 1]")
        self.target_service = target_service
        self.batch_min = batch_min
        self.batch_cap = batch_cap
        self.ema = ema
        self.per_domain = per_domain
        self._size = min(max(init_size, batch_min), batch_cap)
        self._per_task: float | None = None
        self._domain_per_task: dict[int, float] = {}
        self.batches = 0
        self.tasks = 0

    @property
    def size(self) -> int:
        """Batch-grab limit for the next grab (the global estimate)."""
        return self._size

    def size_for(self, domain: int) -> int:
        """Grab limit for a batch sourced from ``domain``: sized by that
        domain's own service EMA when ``per_domain`` and one exists, else
        the global ``size``."""
        if not self.per_domain:
            return self._size
        per = self._domain_per_task.get(domain)
        if per is None:
            return self._size
        return self._clamp(per)

    @property
    def budget(self) -> float:
        """Cost budget per grab (the executor's budgeted drain bound)."""
        return self.target_service

    @property
    def service_estimate(self) -> float | None:
        """EMA of per-task service over observed batches (None pre-warmup)."""
        return self._per_task

    def domain_service_estimates(self) -> dict[int, float]:
        """Per-domain per-task service EMAs (domain -> estimate); empty
        unless ``per_domain`` has observed grabs.  Snapshot surface for
        ``repro.spec.BatchStateSpec``."""
        return dict(self._domain_per_task)

    def seed_state(self, service_estimate: float | None = None,
                   size: int | None = None,
                   domain_estimates: dict[int, float] | None = None) -> None:
        """Restore learned state onto a fresh governor (checkpoint/restore
        counterpart of ``service_estimate``/``size``/
        ``domain_service_estimates``)."""
        if service_estimate is not None:
            self._per_task = float(service_estimate)
        if size is not None:
            self._size = min(max(int(size), self.batch_min), self.batch_cap)
        if domain_estimates:
            self._domain_per_task.update(
                {int(d): float(v) for d, v in domain_estimates.items()})

    def _clamp(self, per_task: float) -> int:
        return min(max(round(self.target_service / per_task),
                       self.batch_min), self.batch_cap)

    def on_batch(self, n_tasks: int, service: float,
                 domain: int = -1) -> None:
        """Feed one executed grab: ``n_tasks`` served, ``service`` total
        cost+penalty delivered, ``domain`` the queue the grab drained (only
        used when ``per_domain``).  Called by the executor after every
        grab."""
        if n_tasks < 1:
            return
        per = max(service / n_tasks, _MIN_SERVICE)
        self._per_task = (per if self._per_task is None else
                          (1 - self.ema) * self._per_task + self.ema * per)
        self._size = self._clamp(self._per_task)
        if self.per_domain and domain >= 0:
            prev = self._domain_per_task.get(domain)
            self._domain_per_task[domain] = (
                per if prev is None else (1 - self.ema) * prev + self.ema * per)
        self.batches += 1
        self.tasks += n_tasks
