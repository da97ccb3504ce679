"""Hierarchical locality-domain distances: the runtime's topology model.

The paper treats locality domains as flat peers — every nonlocal access
costs the same bounded penalty, so the steal scan may visit victims in any
order (§2.2).  Real ccNUMA machines are trees: cores share a socket, sockets
share a host, hosts share a pod.  The hierarchical-runtime line of work
(Thibault et al., arxiv 0706.2073; Tahan, arxiv 1411.7131) shows that a
scheduler which knows the tree steals from siblings before cousins and pays
the deep-link penalty only when the near tiers are truly dry.

``DistanceMatrix`` is the runtime-facing form of that tree: an n×n symmetric
matrix of relative access costs (diagonal 0), from which *levels* are
derived by ranking the distinct off-diagonal distances — level 1 is the
nearest tier (e.g. same socket), level 2 the next (cross socket), and so on.
The runtime consumes only the derived structure:

  * ``peers(domain, level)``        — foreign domains at exactly that level,
                                      in ascending domain order (the
                                      deterministic scan universe);
  * ``cyclic_peers(domain, level)`` — the same set rotated to start just
                                      after the caller, so the paper's
                                      cyclic scan keeps its §2.2 shape
                                      *within* a level;
  * ``distance(a, b)``              — the penalty scale factor a steal
                                      across that link pays.

Three builders cover the repo's layouts: ``flat`` (the paper's machines as
PR 1 modelled them — one level, distance 1 everywhere, byte-compatible with
no topology at all), ``grouped`` (two-level socket/domain trees), and
``pods`` (the TPU tier: domains grouped into pods, with the cross-pod
distance priced from ``core.topology.tpu_topology``'s ICI-vs-DCN bandwidth
ratio — crossing a pod boundary costs what the DCN link's relative slowdown
says it costs).

A ``DistanceMatrix`` is pure data (``to_dict``/``from_dict`` round-trip
exactly), so trace headers can embed it and a recorded hierarchical run
replays from its header alone.
"""
from __future__ import annotations

from typing import Any, Sequence

from ..core.topology import tpu_topology


class TopologyError(ValueError):
    """Raised for malformed distance matrices or builder arguments."""


class DistanceMatrix:
    """Symmetric inter-domain distances plus the derived level structure.

    ``distances[a][b]`` is the relative cost scale of domain ``a`` accessing
    domain ``b``'s memory: 0 on the diagonal, positive elsewhere, symmetric
    (the runtime's links are bidirectional buses, not routes).  Levels rank
    the distinct off-diagonal values ascending: ``level(a, b)`` is 1 for the
    nearest tier, ``num_levels`` for the farthest, 0 only for ``a == b``.
    """

    def __init__(self, distances: Sequence[Sequence[float]]):
        rows = [tuple(float(x) for x in row) for row in distances]
        n = len(rows)
        if n < 1:
            raise TopologyError("distance matrix needs at least one domain")
        for a, row in enumerate(rows):
            if len(row) != n:
                raise TopologyError(
                    f"distance matrix is not square: row {a} has {len(row)} "
                    f"entries for {n} domains")
            if row[a] != 0.0:
                raise TopologyError(
                    f"distance({a},{a}) must be 0, got {row[a]}")
            for b, d in enumerate(row):
                if b != a and d <= 0.0:
                    raise TopologyError(
                        f"distance({a},{b}) must be positive, got {d}")
                if rows[b][a] != d:
                    raise TopologyError(
                        f"distance matrix is asymmetric at ({a},{b}): "
                        f"{d} != {rows[b][a]}")
        self._d = tuple(rows)
        self.num_domains = n
        tiers = sorted({d for row in rows for d in row if d > 0.0})
        self.num_levels = len(tiers)
        rank = {d: i + 1 for i, d in enumerate(tiers)}
        self._level = tuple(
            tuple(0 if b == a else rank[rows[a][b]] for b in range(n))
            for a in range(n))
        # per-domain scan universes: peers grouped by level, ascending domain
        # order, plus the cyclic rotation (domains after the caller first) so
        # the paper's (domain + off) % n scan survives inside each level.
        self._peers = tuple(
            tuple(tuple(b for b in range(n) if self._level[a][b] == lv)
                  for lv in range(1, self.num_levels + 1))
            for a in range(n))
        self._cyclic = tuple(
            tuple(tuple(b for b in ps if b > a) + tuple(b for b in ps if b < a)
                  for ps in self._peers[a])
            for a in range(n))

    # -- structure reads -----------------------------------------------------
    def distance(self, a: int, b: int) -> float:
        return self._d[a][b]

    def level(self, a: int, b: int) -> int:
        """Tier of the ``a``→``b`` link: 0 for self, 1 = nearest tier, up to
        ``num_levels`` = farthest."""
        return self._level[a][b]

    def peers(self, domain: int, level: int) -> tuple[int, ...]:
        """Foreign domains exactly ``level`` away, ascending domain order."""
        if not 1 <= level <= self.num_levels:
            raise TopologyError(f"level {level} outside 1..{self.num_levels}")
        return self._peers[domain][level - 1]

    def cyclic_peers(self, domain: int, level: int) -> tuple[int, ...]:
        """``peers`` rotated to start just after ``domain`` — the §2.2 cyclic
        visiting order restricted to one level."""
        if not 1 <= level <= self.num_levels:
            raise TopologyError(f"level {level} outside 1..{self.num_levels}")
        return self._cyclic[domain][level - 1]

    @property
    def hierarchical(self) -> bool:
        """True when there is more than one steal tier — the runtime's
        nearest-first scan only engages then (a single tier is scan-identical
        to the flat PR-1 behaviour by construction)."""
        return self.num_levels > 1

    def remote_level(self) -> int:
        """The first *cross* tier (2), the boundary the storm detectors and
        the breaker treat as "remote"; equals ``num_levels`` + 1 when the
        matrix is flat (i.e. nothing is remote)."""
        return 2

    # -- value semantics -----------------------------------------------------
    def __eq__(self, other: object) -> bool:
        return isinstance(other, DistanceMatrix) and self._d == other._d

    def __hash__(self) -> int:
        return hash(self._d)

    def __repr__(self) -> str:
        return (f"DistanceMatrix(num_domains={self.num_domains}, "
                f"num_levels={self.num_levels})")

    # -- serialization (trace headers embed this) ----------------------------
    def to_dict(self) -> dict[str, Any]:
        return {"num_domains": self.num_domains,
                "distances": [list(row) for row in self._d]}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DistanceMatrix":
        if not isinstance(d, dict) or "distances" not in d:
            raise TopologyError(
                f"expected a distance-matrix object with 'distances', "
                f"got {d!r}")
        m = cls(d["distances"])
        n = d.get("num_domains")
        if n is not None and int(n) != m.num_domains:
            raise TopologyError(
                f"num_domains {n} does not match a "
                f"{m.num_domains}x{m.num_domains} matrix")
        return m


# -- builders ----------------------------------------------------------------

def flat(num_domains: int, distance: float = 1.0) -> DistanceMatrix:
    """The paper's flat machine: every foreign domain one uniform hop away.

    With ``distance=1.0`` (the default) this is behaviour-identical to no
    topology at all — one steal level, penalty scale 1 — which is the
    back-compat anchor the replay goldens pin.
    """
    if num_domains < 1:
        raise TopologyError("need at least one domain")
    if distance <= 0:
        raise TopologyError("distance must be positive")
    return DistanceMatrix(
        [[0.0 if a == b else float(distance) for b in range(num_domains)]
         for a in range(num_domains)])


def grouped(groups: Sequence[int], near: float = 1.0,
            far: float = 4.0) -> DistanceMatrix:
    """A two-level socket/domain tree: ``groups[i]`` domains share socket
    ``i`` at distance ``near``; crossing sockets costs ``far``.

    ``far == near`` degenerates to a flat matrix (one level) — useful for
    A/B arms that differ only in the tree, not the link costs.
    """
    gs = [int(g) for g in groups]
    if not gs or any(g < 1 for g in gs):
        raise TopologyError(f"groups must be positive ints, got {groups!r}")
    if near <= 0 or far < near:
        raise TopologyError(f"need far >= near > 0, got near={near} far={far}")
    socket = []
    for i, g in enumerate(gs):
        socket += [i] * g
    n = len(socket)
    return DistanceMatrix(
        [[0.0 if a == b else (near if socket[a] == socket[b] else far)
          for b in range(n)] for a in range(n)])


def pods(num_pods: int, domains_per_pod: int, near: float = 1.0,
         chips_per_pod: int = 256) -> DistanceMatrix:
    """The TPU tier as a distance tree: ``domains_per_pod`` domains share a
    pod (ICI, distance ``near``); crossing pods rides the DCN.

    The cross-pod distance is priced from ``core.topology.tpu_topology``'s
    calibrated ``remote_factor`` (DCN effective bandwidth relative to ICI):
    a link that delivers ``remote_factor`` of the local bandwidth costs
    ``near / remote_factor`` to cross — the same bandwidth→cost inversion
    the ccNUMA simulator applies to the paper's Table 1 machines.
    """
    if num_pods < 1 or domains_per_pod < 1:
        raise TopologyError("need num_pods >= 1 and domains_per_pod >= 1")
    machine = tpu_topology(num_pods, chips_per_pod)
    far = near / machine.remote_factor
    return grouped([domains_per_pod] * num_pods, near=near, far=far)
