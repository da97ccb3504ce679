"""Three-term roofline of one rank's counted work.

    compute term    = FLOPs / peak FLOP/s              (per card)
    memory term     = bytes / HBM bandwidth            (per card)
    collective term = collective bytes / link rate     (per card)

The port of ``repro.roofline.analysis``.  The inputs come from
``op_cost``, which counts the local ops one rank runs (the reference reads
them off the partitioned HLO), so they are per card already.  Per
collective kind the wire volume per device is, as in the reference:

    all-gather          result bytes          (receive volume)
    reduce-scatter      operand bytes         (send volume)
    all-reduce          2 x operand bytes     (reduce-scatter + all-gather)
    all-to-all          operand bytes
    collective-permute  operand bytes

Hardware constants: one NVIDIA H100 SXM5 80 GB, from NVIDIA's datasheet
(not measured): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, and 450 GB/s of
NVLink 4 per direction per card.  The single link term assumes every mesh
axis stays inside one NVLink domain of 8 cards; a mesh axis wider than a
node crosses InfiniBand (about 50 GB/s a card with one 400 Gb/s NDR
adapter), which the one term does not model, as the reference's one ICI
term does not model its own slower links.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from .op_cost import KINDS, Cost, OpRecord, wire_bytes

PEAK_FLOPS = 989e12          # dense bf16 per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, NVLink 4, one direction


def collective_bytes(records: Iterable[OpRecord]) -> dict[str, float]:
    """Per-device wire bytes by collective kind, from recorded op calls
    (``op_cost.measure(..., record=True)``)."""
    out: dict[str, float] = {k: 0.0 for k in KINDS}
    for rec in records:
        wire = wire_bytes(rec)
        if wire is not None:
            out[wire[0]] += wire[1]
    return out


@dataclasses.dataclass
class Roofline:
    flops: float                  # per card
    hbm_bytes: float              # per card
    coll_bytes: float             # per card (weighted wire volume)
    coll_by_kind: dict[str, float]

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "coll_by_kind": self.coll_by_kind,
        }


def analyze(cost: Cost) -> Roofline:
    """The roofline of one rank's ``op_cost.Cost``."""
    coll = dict(cost.coll)
    return Roofline(flops=cost.flops, hbm_bytes=cost.bytes,
                    coll_bytes=sum(coll.values()), coll_by_kind=coll)


def model_flops_train(n_active_params: int, tokens: int) -> float:
    """6·N·D for a train step (fwd+bwd) over `tokens` tokens."""
    return 6.0 * n_active_params * tokens


def model_flops_infer(n_active_params: int, tokens: int) -> float:
    """2·N·D for inference."""
    return 2.0 * n_active_params * tokens
