"""MLP blocks: gated (SwiGLU/GeGLU) and plain (whisper's GELU MLP).

The port of ``repro.models.mlp``.  The reference's ``shard`` constraint on
the hidden activation is a no-op without mesh rules and is dropped here.
"""
from __future__ import annotations

import torch

from .common import Params, act_fn, dense_init, matmul_lowp


def mlp_init(gen: torch.Generator, d: int, f: int, gated: bool = True,
             dtype: torch.dtype = torch.float32) -> Params:
    p = {"w_up": dense_init(gen, d, f, dtype),
         "w_down": dense_init(gen, f, d, dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, d, f, dtype)
    return p


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = act_fn(act)(x @ p["w_gate"]) * h
    else:
        h = act_fn(act)(h)
    return matmul_lowp(h, p["w_down"])
