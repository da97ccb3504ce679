"""Tasks and the blocked 3D domain decomposition of the paper's Jacobi solver.

One *task* = one lattice block (paper §2.1: "we define one task to be a single
block").  The paper's reference problem is a 600^2 x 2400 grid.  The text
quotes a block size of "600 x 10 x 100 (dk x dj x di)" but its own task
arithmetic ("one ib-jb layer comprises 60 tasks ... 240 layers ... 14400 tasks
in total") requires (dk, dj, di) = (600, 10, 10) with (Nk, Nj, Ni) =
(600, 600, 2400); we follow the task arithmetic, since the 256-task-cap
dynamics the paper analyses depend on it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Block:
    """One stencil block == one task (the paper's scheduling entity)."""

    idx: int                       # linear submission-independent id
    coord: tuple[int, int, int]    # (ib, jb, kb) block coordinates
    sites: int                     # lattice sites in the block
    ld_home: int = -1              # locality domain of its pages (placement.py)


@dataclasses.dataclass(frozen=True)
class BlockGrid:
    """Blocked decomposition of an (Ni, Nj, Nk) lattice.

    ``k`` is the innermost (fast) index; the k block size equals Nk (paper:
    required for hardware prefetching), so there is a single k block.
    """

    ni: int
    nj: int
    nk: int
    di: int
    dj: int
    dk: int

    def __post_init__(self) -> None:
        for n, d, ax in ((self.ni, self.di, "i"), (self.nj, self.dj, "j"),
                         (self.nk, self.dk, "k")):
            if n % d != 0:
                raise ValueError(f"extent {n} not divisible by block {d} on {ax}")

    @property
    def blocks_i(self) -> int:
        return self.ni // self.di

    @property
    def blocks_j(self) -> int:
        return self.nj // self.dj

    @property
    def blocks_k(self) -> int:
        return self.nk // self.dk

    @property
    def num_blocks(self) -> int:
        return self.blocks_i * self.blocks_j * self.blocks_k

    @property
    def sites_per_block(self) -> int:
        return self.di * self.dj * self.dk

    @property
    def total_sites(self) -> int:
        return self.ni * self.nj * self.nk

    def linear_index(self, ib: int, jb: int, kb: int) -> int:
        """Canonical linear id — ijk order (i outermost), independent of
        submission order so placement and scheduling can be composed."""
        return (ib * self.blocks_j + jb) * self.blocks_k + kb

    def coords(self, idx: int) -> tuple[int, int, int]:
        kb = idx % self.blocks_k
        jb = (idx // self.blocks_k) % self.blocks_j
        ib = idx // (self.blocks_k * self.blocks_j)
        return ib, jb, kb

    # -- submission orders (paper §2.1: "ijk" vs "kji") --------------------
    def submit_order(self, order: str) -> np.ndarray:
        """Linear block ids in the order a single thread submits the tasks.

        ``"ijk"``: i outermost, k innermost (the paper's default loop nest).
        ``"kji"``: reversed nest — consecutive tasks cycle through i, hence
        through locality domains under static first-touch placement.
        """
        ib, jb, kb = np.meshgrid(
            np.arange(self.blocks_i), np.arange(self.blocks_j),
            np.arange(self.blocks_k), indexing="ij")
        lin = (ib * self.blocks_j + jb) * self.blocks_k + kb
        if order == "ijk":
            return lin.transpose(0, 1, 2).ravel()
        if order == "kji":
            return lin.transpose(2, 1, 0).ravel()
        raise ValueError(f"unknown submit order {order!r} (want 'ijk' or 'kji')")

    def make_blocks(self, ld_home: np.ndarray | None = None) -> list[Block]:
        homes = ld_home if ld_home is not None else np.full(self.num_blocks, -1)
        return [
            Block(idx=i, coord=self.coords(i), sites=self.sites_per_block,
                  ld_home=int(homes[i]))
            for i in range(self.num_blocks)
        ]

    def __iter__(self) -> Iterator[tuple[int, int, int]]:
        for i in range(self.blocks_i):
            for j in range(self.blocks_j):
                for k in range(self.blocks_k):
                    yield (i, j, k)


# The paper's reference decomposition (see module docstring).
PAPER_GRID = BlockGrid(ni=2400, nj=600, nk=600, di=10, dj=10, dk=600)

# A scaled-down grid with identical *structure* (60 j-blocks per layer,
# single k block) for fast CI runs of the simulator benchmarks.
SMALL_GRID = BlockGrid(ni=240, nj=600, nk=600, di=10, dj=10, dk=600)


def bytes_per_site(nt_stores: bool) -> int:
    """Main-memory traffic per lattice-site update (paper §1.4).

    One 8-byte load (the streamed source plane miss) + one 8-byte store;
    without nontemporal stores the store miss additionally write-allocates a
    cache line's worth of reads (+8 bytes/site effective).
    """
    return 16 if nt_stores else 24


def block_bytes(grid: BlockGrid, nt_stores: bool) -> int:
    return grid.sites_per_block * bytes_per_site(nt_stores)
