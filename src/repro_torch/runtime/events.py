"""Streaming event trace for the runtime.

Every scheduling decision emits one ``Event``; the ``EventLog`` is a bounded
ring buffer so long-running (online) executors can keep tracing without
growing memory.  Events are the raw material for the metrics layer and for
offline debugging of steal behaviour — the online analogue of the
per-thread timelines behind the paper's Fig. 4 variability analysis.

Event kinds:
  ``submit``  — a task entered a domain queue
  ``run``     — a worker executed a task from its own domain's queue
  ``steal``   — a worker executed a task taken from a foreign queue
  ``inline``  — the submitter executed a task because the pool was full
                (OpenMP §2.1 backpressure)
  ``idle``    — a worker polled for work and found none it may take

Window vs totals: the ring buffer retains only the newest ``maxlen`` events,
but ``counts()`` (and ``total``) keep counting every event ever emitted.  Any
export of the buffer therefore covers a *window* of the run, not the run —
``to_csv_lines()`` says so explicitly in a leading marker line.

Storage is columnar (struct-of-arrays): one preallocated ring per ``Event``
field, written in place by ``emit`` — appending an event is eight scalar
stores, not a frozen-dataclass construction plus a deque append plus a
Counter update (``BENCH_overhead.json`` event_append).  The per-field rings
are plain Python lists, not numpy arrays: a scalar store into a numpy array
pays dtype coercion (~5x a list store — measured, and ``emit`` is nothing
*but* scalar stores); numpy enters only at the bulk boundary, via
``columns()``, which exports the retained window as one typed numpy array
per field for vectorized analytics.  ``Event`` objects are materialized
lazily, only when the log is iterated / exported; readers see the exact
same frozen dataclass as before.  ``ReferenceEventLog`` keeps the original
object-per-event implementation as the executable specification the
columnar ring is equivalence-tested against
(``benchmarks.scheduler_overhead`` fast_vs_slow).
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import Counter, deque
from typing import Iterator

import numpy as np

KINDS = ("submit", "run", "steal", "inline", "idle")

_OVERFLOW_MSG = (
    "EventLog overflow: ring buffer (maxlen={maxlen}) is "
    "dropping oldest events; exports now cover a window of the "
    "run, not the run (counts()/total remain whole-run)")


@dataclasses.dataclass(frozen=True)
class Event:
    step: int          # executor scheduling round (0 for submissions)
    kind: str
    worker: int        # worker id, -1 for submit events
    domain: int        # queue domain acted on
    task_uid: int      # -1 for idle polls
    src_domain: int = -1   # for steals: the victim queue
    cost: float = 0.0      # task's local execution cost (run/steal/inline)
    penalty: float = 0.0   # nonlocal penalty actually charged (steal only)

    @property
    def service(self) -> float:
        """Measured service time of an execution event: the local cost plus
        any nonlocal penalty paid.  0.0 for submit/idle events."""
        return self.cost + self.penalty


def _check_maxlen(maxlen) -> int:
    if maxlen is None or maxlen < 1:
        raise ValueError(f"EventLog maxlen must be >= 1, got {maxlen!r} "
                         "(a degenerate ring would drop every event)")
    return int(maxlen)


class EventLog:
    """Bounded ring buffer of events (oldest dropped first), stored as one
    column per field.

    ``emit``'s one-shot overflow warning is raised at ``stacklevel=2`` —
    it points at ``emit``'s direct caller (``Executor._emit`` for
    executor-driven logs, the call site itself for direct use).
    """

    def __init__(self, maxlen: int = 65536):
        maxlen = _check_maxlen(maxlen)
        self.maxlen = maxlen
        self._step = [0] * maxlen
        self._kind = [0] * maxlen          # index into the kind registry
        self._worker = [0] * maxlen
        self._domain = [0] * maxlen
        self._uid = [0] * maxlen
        self._src = [0] * maxlen
        self._cost = [0.0] * maxlen
        self._penalty = [0.0] * maxlen
        self._n = 0                        # events ever emitted
        # per-instance kind registry: the canonical KINDS up front, unknown
        # kinds appended on first use (the old Counter accepted any string)
        self._kinds: list[str] = list(KINDS)
        self._kind_id: dict[str, int] = {k: i for i, k in enumerate(KINDS)}
        self._kind_counts: list[int] = [0] * len(KINDS)
        self._warned_overflow = False

    def emit(self, step: int, kind: str, worker: int, domain: int,
             task_uid: int, src_domain: int = -1, cost: float = 0.0,
             penalty: float = 0.0) -> None:
        n = self._n
        maxlen = self.maxlen
        if n >= maxlen and not self._warned_overflow:
            # One-shot: overflow used to be silent, and window-sensitive
            # analyses (storm detection, span assembly) quietly degraded.
            # counts()/total stay whole-run; only the retained window drops.
            self._warned_overflow = True
            warnings.warn(_OVERFLOW_MSG.format(maxlen=maxlen),
                          RuntimeWarning, stacklevel=2)
        try:
            k = self._kind_id[kind]
        except KeyError:
            k = self._register_kind(kind)
        i = n % maxlen
        self._step[i] = step
        self._kind[i] = k
        self._worker[i] = worker
        self._domain[i] = domain
        self._uid[i] = task_uid
        self._src[i] = src_domain
        self._cost[i] = cost
        self._penalty[i] = penalty
        self._n = n + 1
        self._kind_counts[k] += 1

    def _register_kind(self, kind: str) -> int:
        if len(self._kinds) >= 256:   # uint8 kind column in columns()
            raise ValueError("EventLog supports at most 256 distinct kinds")
        k = len(self._kinds)
        self._kinds.append(kind)
        self._kind_id[kind] = k
        self._kind_counts.append(0)
        return k

    def counts(self) -> dict[str, int]:
        """Totals per kind over the whole run (not just the retained window)."""
        return {k: c for k, c in zip(self._kinds, self._kind_counts) if c}

    @property
    def total(self) -> int:
        """Events emitted over the whole run (retained + dropped)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Events the ring buffer has already discarded (oldest first)."""
        return max(self._n - self.maxlen, 0)

    def _window(self, lo: int, hi: int) -> list[int]:
        """Ring indices for absolute emit indices ``[lo, hi)``, unwrapped."""
        maxlen = self.maxlen
        lo_i, hi_i = lo % maxlen, ((hi - 1) % maxlen) + 1
        if lo_i < hi_i:
            return list(range(lo_i, hi_i))
        return list(range(lo_i, maxlen)) + list(range(hi_i))

    def _materialize(self, lo: int, hi: int) -> list[Event]:
        """Decode absolute emit indices ``[lo, hi)`` into ``Event`` objects.

        One gather per column over the unwrapped ring window, then a
        plain-tuple zip into the dataclass — every field is already a
        native Python int/float (JSON-safe).
        """
        if lo >= hi:
            return []
        idx = self._window(lo, hi)
        kinds = self._kinds
        return [Event(s, kinds[k], w, d, u, sd, c, p)
                for s, k, w, d, u, sd, c, p in zip(
                    [self._step[i] for i in idx],
                    [self._kind[i] for i in idx],
                    [self._worker[i] for i in idx],
                    [self._domain[i] for i in idx],
                    [self._uid[i] for i in idx],
                    [self._src[i] for i in idx],
                    [self._cost[i] for i in idx],
                    [self._penalty[i] for i in idx])]

    def columns(self) -> dict[str, np.ndarray]:
        """The retained window as one typed numpy array per field, oldest
        first — the bulk boundary where columnar storage pays off: trace
        export and vectorized analytics read whole columns, never an
        ``Event`` object per row.  ``kind`` comes out as ``uint8`` indices
        into ``kind_names()``."""
        lo = self._n - len(self)
        idx = self._window(lo, self._n) if self._n else []
        dtypes = {"step": np.int64, "kind": np.uint8, "worker": np.int32,
                  "domain": np.int32, "task_uid": np.int64,
                  "src_domain": np.int32, "cost": np.float64,
                  "penalty": np.float64}
        cols = {"step": self._step, "kind": self._kind,
                "worker": self._worker, "domain": self._domain,
                "task_uid": self._uid, "src_domain": self._src,
                "cost": self._cost, "penalty": self._penalty}
        return {name: np.array([col[i] for i in idx], dtype=dtypes[name])
                for name, col in cols.items()}

    def kind_names(self) -> tuple[str, ...]:
        """Registry decoding ``columns()['kind']`` indices to kind strings."""
        return tuple(self._kinds)

    def tail(self, n: int = 50) -> list[Event]:
        lo = max(self._n - min(n, len(self)), 0)
        return self._materialize(lo, self._n)

    def __len__(self) -> int:
        return min(self._n, self.maxlen)

    def __iter__(self) -> Iterator[Event]:
        return iter(self._materialize(self._n - len(self), self._n))

    def to_csv_lines(self) -> list[str]:
        """CSV export of the *retained window* only.

        The first line is a ``#`` marker recording total vs retained vs
        dropped so a truncated export can never be mistaken for the whole
        run (``counts()`` always covers the whole run).
        """
        out = [f"# events total={self.total} retained={len(self)} "
               f"dropped={self.dropped} window={self.maxlen}",
               "step,kind,worker,domain,task_uid,src_domain,cost,penalty"]
        out += [f"{e.step},{e.kind},{e.worker},{e.domain},{e.task_uid},"
                f"{e.src_domain},{e.cost:g},{e.penalty:g}" for e in self]
        return out


class ReferenceEventLog:
    """The pre-columnar object-per-event ring: one frozen ``Event`` built
    per emit into a ``deque``.  Kept as the executable specification —
    ``benchmarks.scheduler_overhead``'s fast_vs_slow block and the runtime
    tests hold ``EventLog`` to producing the identical event sequence,
    counts, and CSV export."""

    def __init__(self, maxlen: int = 65536):
        maxlen = _check_maxlen(maxlen)
        self.maxlen = maxlen
        self._buf: deque[Event] = deque(maxlen=maxlen)
        self._counts: Counter[str] = Counter()
        self._warned_overflow = False

    def emit(self, step: int, kind: str, worker: int, domain: int,
             task_uid: int, src_domain: int = -1, cost: float = 0.0,
             penalty: float = 0.0) -> None:
        if not self._warned_overflow and len(self._buf) == self.maxlen:
            self._warned_overflow = True
            warnings.warn(_OVERFLOW_MSG.format(maxlen=self.maxlen),
                          RuntimeWarning, stacklevel=2)
        self._buf.append(Event(step, kind, worker, domain, task_uid,
                               src_domain, cost, penalty))
        self._counts[kind] += 1

    def counts(self) -> dict[str, int]:
        return dict(self._counts)

    @property
    def total(self) -> int:
        return sum(self._counts.values())

    @property
    def dropped(self) -> int:
        return self.total - len(self._buf)

    def tail(self, n: int = 50) -> list[Event]:
        return list(self._buf)[-n:]

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[Event]:
        return iter(self._buf)

    def to_csv_lines(self) -> list[str]:
        out = [f"# events total={self.total} retained={len(self._buf)} "
               f"dropped={self.dropped} window={self.maxlen}",
               "step,kind,worker,domain,task_uid,src_domain,cost,penalty"]
        out += [f"{e.step},{e.kind},{e.worker},{e.domain},{e.task_uid},"
                f"{e.src_domain},{e.cost:g},{e.penalty:g}" for e in self._buf]
        return out
