"""First-touch page-placement policies (paper §1.1, §1.4, §2.1).

Placement decides each block's *home locality domain* — the LD whose memory
holds the block's pages after initialization.  Blocks here are much larger
than a page (600*10*10 sites * 8 B = 480 kB vs 4 kB pages), so modelling
placement at block granularity is exact for every policy except round-robin
page interleaving, where it is a <1% idealization (a block's pages spread over
all LDs; we charge the whole block cyclically, which the bandwidth model makes
equivalent in aggregate).

Policies (labels follow the paper's Fig. 3):
  serial        — sequential init loop: every page lands in LD0.
  static        — parallel first touch, OpenMP ``static`` schedule over the
                  collapsed block loops in a given order ("s").
  static1       — parallel first touch, ``static,1`` round-robin over threads
                  ("s-1").
  round_robin   — ``numactl -i`` page interleaving across LDs.
"""
from __future__ import annotations

import numpy as np

from .tasks import BlockGrid
from .topology import MachineTopology


def serial_placement(grid: BlockGrid, topo: MachineTopology) -> np.ndarray:
    """Sequential initialization: all pages first-touched by thread 0 ⇒ LD0."""
    return np.zeros(grid.num_blocks, dtype=np.int64)


def round_robin_placement(grid: BlockGrid, topo: MachineTopology) -> np.ndarray:
    """``numactl -i 0..L-1``: pages interleaved cyclically across LDs.

    A block (480 kB) spans ~120 pages, so every block's traffic spreads
    uniformly over all LDs; the cost model marks this with home = -1
    ("interleaved flow").
    """
    return np.full(grid.num_blocks, -1, dtype=np.int64)


def _static_chunks(n: int, t: int) -> np.ndarray:
    """OpenMP ``static`` schedule: thread owning each of n iterations
    split into t near-equal contiguous chunks (first n%t chunks one longer)."""
    base = n // t
    rem = n % t
    owner = np.empty(n, dtype=np.int64)
    pos = 0
    for th in range(t):
        size = base + (1 if th < rem else 0)
        owner[pos:pos + size] = th
        pos += size
    return owner


def static_placement(grid: BlockGrid, topo: MachineTopology,
                     order: str = "ijk") -> np.ndarray:
    """Parallel first touch with ``schedule(static)`` over the collapsed block
    loops iterated in ``order``.  Thread t is pinned, so its pages land in
    ``topo.domain_of_core(t)``."""
    seq = grid.submit_order(order)
    owner_thread = _static_chunks(grid.num_blocks, topo.num_cores)
    homes = np.empty(grid.num_blocks, dtype=np.int64)
    for pos, blk in enumerate(seq):
        homes[blk] = topo.domain_of_core(int(owner_thread[pos]))
    return homes


def static1_placement(grid: BlockGrid, topo: MachineTopology,
                      order: str = "ijk") -> np.ndarray:
    """Parallel first touch with ``schedule(static,1)``: iteration p of the
    collapsed loop (in ``order``) goes to thread p mod T."""
    seq = grid.submit_order(order)
    homes = np.empty(grid.num_blocks, dtype=np.int64)
    ncores = topo.num_cores
    for pos, blk in enumerate(seq):
        homes[blk] = topo.domain_of_core(pos % ncores)
    return homes


PLACEMENTS = {
    "serial": serial_placement,
    "round_robin": round_robin_placement,
    "static": static_placement,
    "static1": static1_placement,
}


def place(policy: str, grid: BlockGrid, topo: MachineTopology,
          order: str = "ijk") -> np.ndarray:
    """Return ld_home[num_blocks] for a named policy."""
    if policy in ("serial", "round_robin"):
        return PLACEMENTS[policy](grid, topo)
    if policy in ("static", "static1"):
        return PLACEMENTS[policy](grid, topo, order=order)
    raise ValueError(f"unknown placement policy {policy!r}")
