"""Locality queues (paper §2.2) — simulator-facing shim.

The canonical implementation of the per-domain FIFO queues and the cyclic
steal scan lives in ``repro.runtime.queues.DomainQueues`` (the online
runtime); this class only preserves the simulator's historical interface,
where items are integer block ids and ``dequeue`` returns a plain
``(block_idx, stolen)`` pair.

The *semantics* are the paper's exactly: FIFO per locality domain, local
queue served first, cyclic steal scan starting right after the caller's
own domain — load balance is deliberately given priority over strict
locality.
"""
from __future__ import annotations

from typing import Optional

from ..runtime.queues import DomainQueues


class LocalityQueues(DomainQueues):
    """Per-LD FIFO queues with a cyclic steal scan (thin runtime shim)."""

    def __init__(self, num_domains: int):
        super().__init__(num_domains, steal_order="cyclic")

    def dequeue(self, ld: int) -> Optional[tuple[int, bool]]:  # type: ignore[override]
        """Pop the oldest block for domain ``ld``; steal cyclically otherwise.

        Returns ``(block_idx, stolen)`` or ``None`` if every queue is empty.
        ``stolen`` is True when the block came from a foreign queue.
        """
        got = super().dequeue(ld)
        return None if got is None else (got.item, got.stolen)
