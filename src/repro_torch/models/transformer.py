"""The decoder stack: one residual block per layer, applied in a loop.

The port of ``repro.models.transformer``.  The reference stacks each
pattern position's parameters over repeats and applies them with
``lax.scan`` to keep compile time independent of depth; PyTorch runs
eagerly, so here the stack is a plain list of per-layer parameter dicts in
layer order (``cfg.layer_kinds()``), and caches are a list of per-layer
dicts beside it.  ``repro_torch.models.convert`` unstacks the reference's
``{"groups", "remainder"}`` tree into that list.

The "full" and "local" (sliding-window) attention kinds with a dense MLP,
the "rglru" kind (Griffin's recurrent block and its gated MLP) and the
"rwkv" kind are ported; the "cross" kind, MLA and MoE raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..configs.base import ModelConfig
from .attention import attention_block, attn_init
from .common import Params, layer_norm, layer_norm_init, rms_norm, rms_norm_init
from .mlp import mlp, mlp_init
from .rglru import rglru_block, rglru_init
from .rwkv import rwkv_channel_mix, rwkv_init, rwkv_time_mix

_NOT_PORTED = {
    "cross": "ROADMAP B8 (cross-attention layers)",
}


def check_ported(cfg: ModelConfig, kind: str) -> None:
    """Raise unless the port can build and run a ``kind`` layer of ``cfg``."""
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet: {_NOT_PORTED[kind]}")
    if kind in ("rwkv", "rglru"):
        return
    if kind not in ("full", "local"):
        raise ValueError(f"unknown layer kind {kind!r}")
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet: ROADMAP D")
    if cfg.moe is not None:
        raise NotImplementedError("MoE blocks are not ported yet: ROADMAP D")


def _norm_init(cfg: ModelConfig, d: int, dtype, device):
    return rms_norm_init(d, dtype, device) if cfg.norm == "rms" else \
        layer_norm_init(d, dtype, device)


def _norm(cfg: ModelConfig, p: Params, x):
    return rms_norm(p, x) if cfg.norm == "rms" else layer_norm(p, x)


# ---------------------------------------------------------------------------
# one residual block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype: torch.dtype = torch.float32) -> Params:
    check_ported(cfg, kind)
    d = cfg.d_model
    if kind == "rwkv":
        # channel-mix params live inside the tmix dict (shared init fn)
        return {"ln1": _norm_init(cfg, d, dtype, gen.device),
                "tmix": rwkv_init(gen, cfg, dtype),
                "ln2": _norm_init(cfg, d, dtype, gen.device)}
    if kind == "rglru":
        return {"ln1": _norm_init(cfg, d, dtype, gen.device),
                "rec": rglru_init(gen, cfg, dtype),
                "ln2": _norm_init(cfg, d, dtype, gen.device),
                "mlp": mlp_init(gen, d, cfg.d_ff, gated=True, dtype=dtype)}
    gated = cfg.act in ("silu", "gelu")
    return {"ln1": _norm_init(cfg, d, dtype, gen.device),
            "attn": attn_init(gen, cfg, dtype=dtype),
            "ln2": _norm_init(cfg, d, dtype, gen.device),
            "mlp": mlp_init(gen, d, cfg.d_ff, gated=gated, dtype=dtype)}


def block_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype) -> dict[str, tuple[tuple[int, ...], Any]]:
    """``{name: (shape, dtype)}`` of one layer's decode cache."""
    check_ported(cfg, kind)
    if kind == "rwkv":
        d, hd = cfg.d_model, cfg.rwkv_head_dim
        return {"s": ((batch, d // hd, hd, hd), torch.float32),
                "x_tm": ((batch, d), dtype),
                "x_cm": ((batch, d), dtype)}
    if kind == "rglru":
        return {"h": ((batch, cfg.d_model), dtype),
                "conv": ((batch, 3, cfg.d_model), dtype)}
    # a "local" layer's cache is a ring of at most attn_window slots
    s = min(cfg.attn_window, max_seq) if (kind == "local" and cfg.attn_window) \
        else max_seq
    kvd = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (kvd, dtype), "v": (kvd, dtype)}


def apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                pos_offset: int, cache: Optional[Params] = None,
                cross_x: Optional[torch.Tensor] = None, causal: bool = True,
                use_kernel: bool = True):
    """Pre-norm residual block. Returns (x, new_cache, aux_loss).

    ``aux_loss`` is the MoE router's loss in the reference; the ported dense,
    RG-LRU and RWKV blocks have none and return 0.0."""
    check_ported(cfg, kind)
    if kind == "rwkv":
        h, c1 = rwkv_time_mix(p["tmix"], _norm(cfg, p["ln1"], x), cfg,
                              cache=None if cache is None else
                              {"s": cache["s"], "x_tm": cache["x_tm"]},
                              use_kernel=use_kernel)
        x = x + h
        h, c2 = rwkv_channel_mix(p["tmix"], _norm(cfg, p["ln2"], x), cfg,
                                 cache=None if cache is None else
                                 {"x_cm": cache["x_cm"]})
        x = x + h
        return x, None if cache is None else {**c1, **c2}, 0.0
    if kind == "rglru":
        h, c1 = rglru_block(p["rec"], _norm(cfg, p["ln1"], x), cfg,
                            cache=None if cache is None else
                            {"h": cache["h"], "conv": cache["conv"]},
                            use_kernel=use_kernel)
        x = x + h
        x = x + mlp(p["mlp"], _norm(cfg, p["ln2"], x), cfg.act)
        return x, c1, 0.0
    attn_cache = None
    if cache is not None:
        attn_cache = {k: v for k, v in cache.items() if k in ("k", "v")}
    h, c_attn = attention_block(
        p["attn"], _norm(cfg, p["ln1"], x), cfg, kind=kind,
        pos_offset=pos_offset, cache=attn_cache, cross_x=cross_x,
        causal=causal, use_kernel=use_kernel)
    x = x + h
    new_cache = None if cache is None else dict(c_attn or {})
    x = x + mlp(p["mlp"], _norm(cfg, p["ln2"], x), cfg.act)
    return x, new_cache, 0.0


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def stack_init(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype = torch.float32) -> list[Params]:
    return [block_init(gen, cfg, kind, dtype) for kind in cfg.layer_kinds()]


def stack_cache_specs(cfg: ModelConfig, batch: int, max_seq: int, dtype):
    return [block_cache_spec(cfg, kind, batch, max_seq, dtype)
            for kind in cfg.layer_kinds()]


def apply_stack(params: list[Params], x: torch.Tensor, cfg: ModelConfig, *,
                pos_offset: int, caches: Optional[list[Params]] = None,
                cross_x: Optional[torch.Tensor] = None, causal: bool = True,
                use_kernel: bool = True):
    """Returns (x, new_caches, total_aux)."""
    new_caches = None if caches is None else []
    aux_total = 0.0
    for i, kind in enumerate(cfg.layer_kinds()):
        c = None if caches is None else caches[i]
        x, nc, aux = apply_block(params[i], x, cfg, kind, pos_offset=pos_offset,
                                 cache=c, cross_x=cross_x, causal=causal,
                                 use_kernel=use_kernel)
        if new_caches is not None:
            new_caches.append(nc)
        aux_total = aux_total + aux
    return x, new_caches, aux_total
