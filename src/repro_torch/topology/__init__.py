"""repro.topology — hierarchical locality domains as distance trees.

The runtime-facing topology model: a ``DistanceMatrix`` of inter-domain
access costs with levels derived by ranking the distinct distances, plus
builders for the repo's layouts (``flat``, ``grouped`` sockets, TPU
``pods``).  Declared in a ``repro.spec.TopologySpec`` and consumed by
``runtime.DomainQueues`` (nearest-first steal scans), ``runtime.Executor``
(distance-scaled penalties), ``runtime.AdaptiveSteal`` (per-level θ), and
the ``repro.control`` plane (level-aware spilling and storm breaking).
"""
from .distance import DistanceMatrix, TopologyError, flat, grouped, pods

__all__ = ["DistanceMatrix", "TopologyError", "flat", "grouped", "pods"]
