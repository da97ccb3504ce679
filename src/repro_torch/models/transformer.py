"""The decoder stack: one residual block per layer, applied in a loop.

The port of ``repro.models.transformer``.  The reference stacks each
pattern position's parameters over repeats and applies them with
``lax.scan`` to keep compile time independent of depth; PyTorch runs
eagerly, so here the stack is a plain list of per-layer parameter dicts in
layer order (``cfg.layer_kinds()``), and caches are a list of per-layer
dicts beside it.  ``repro_torch.models.convert`` unstacks the reference's
``{"groups", "remainder"}`` tree into that list.

Every kind of the reference is ported: "full" and "local" (sliding-window)
attention, "cross" (self-attention, then cross-attention to whisper's
encoder output or the VLM's vision tokens, gated by ``tanh(gate_x)`` and
``tanh(gate_m)`` in the VLM), "rglru" (Griffin's recurrent block and its
gated MLP) and "rwkv".  An attention layer's attention is MLA
(``models/mla.py``) when the config has ``mla`` and its MLP is a
mixture of experts (``models/moe.py``) when it has ``moe``; the MoE block's
auxiliary load-balance loss is what ``apply_block`` returns beside the
output and cache.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..configs.base import ModelConfig
from .attention import attention_block, attn_init
from .common import Params, layer_norm, layer_norm_init, rms_norm, rms_norm_init
from .mla import mla_block, mla_init
from .mlp import mlp, mlp_init
from .moe import moe_block, moe_init
from .rglru import rglru_block, rglru_init
from .rwkv import rwkv_channel_mix, rwkv_init, rwkv_time_mix

KINDS = ("full", "local", "cross", "rglru", "rwkv")


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
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind!r}")
    p: Params = {"ln1": _norm_init(cfg, d, dtype, gen.device),
                 "attn": mla_init(gen, cfg, dtype) if cfg.mla is not None
                 else attn_init(gen, cfg, dtype=dtype),
                 "ln2": _norm_init(cfg, d, dtype, gen.device)}
    if cfg.moe is not None:
        p["moe"] = moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, gated=cfg.act in ("silu", "gelu"),
                            dtype=dtype)
    if kind == "cross":
        p["ln_x"] = _norm_init(cfg, d, dtype, gen.device)
        p["xattn"] = attn_init(gen, cfg, dtype=dtype)
        if cfg.family == "vlm":        # llama-vision gates cross layers
            p["gate_x"] = torch.zeros((), dtype=dtype, device=gen.device)
            p["gate_m"] = torch.zeros((), dtype=dtype, device=gen.device)
    return p


def block_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype) -> dict[str, tuple[tuple[int, ...], Any]]:
    """``{name: (shape, dtype)}`` of one layer's decode cache."""
    if kind == "rwkv":
        d, hd = cfg.d_model, cfg.rwkv_head_dim
        return {"s": ((batch, d // hd, hd, hd), torch.float32),
                "x_tm": ((batch, d), dtype),
                "x_cm": ((batch, d), dtype)}
    if kind == "rglru":
        return {"h": ((batch, cfg.d_model), dtype),
                "conv": ((batch, 3, cfg.d_model), dtype)}
    if kind not in KINDS:
        raise ValueError(kind)
    if cfg.mla is not None:
        m = cfg.mla
        spec = {"ckv": ((batch, max_seq, m.kv_lora_rank), dtype),
                "kr": ((batch, max_seq, m.qk_rope_head_dim), dtype)}
    else:
        # a "local" layer's cache is a ring of at most attn_window slots
        s = min(cfg.attn_window, max_seq) if (kind == "local" and cfg.attn_window) \
            else max_seq
        kvd = (batch, s, cfg.num_kv_heads, cfg.head_dim)
        spec = {"k": (kvd, dtype), "v": (kvd, dtype)}
    if kind == "cross":
        n_kv = cfg.vision.num_image_tokens if cfg.vision else cfg.encoder.num_frames
        kvd = (batch, n_kv, cfg.num_kv_heads, cfg.head_dim)
        spec["xk"] = (kvd, dtype)
        spec["xv"] = (kvd, dtype)
    return spec


def apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                pos_offset: int, cache: Optional[Params] = None,
                cross_x: Optional[torch.Tensor] = None, causal: bool = True,
                use_kernel: bool = True):
    """Pre-norm residual block. Returns (x, new_cache, aux_loss).

    ``aux_loss`` is the MoE router's load-balance loss (a 0-d f32 tensor);
    every other block returns 0.0."""
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

    # attention kinds
    attn_cache = None
    if cache is not None:
        attn_cache = {k: v for k, v in cache.items() if k in ("k", "v", "ckv", "kr")}
    if cfg.mla is not None:
        h, c_attn = mla_block(p["attn"], _norm(cfg, p["ln1"], x), cfg,
                              pos_offset=pos_offset, cache=attn_cache or None)
    else:
        h, c_attn = attention_block(
            p["attn"], _norm(cfg, p["ln1"], x), cfg,
            kind="local" if kind == "local" else "full", pos_offset=pos_offset,
            cache=attn_cache, causal=causal, use_kernel=use_kernel)
    x = x + h
    new_cache = None if cache is None else dict(c_attn or {})

    if kind == "cross":
        x_cache = None
        if cache is not None:
            x_cache = {k: v for k, v in cache.items() if k in ("xk", "xv")}
        h, c_x = attention_block(p["xattn"], _norm(cfg, p["ln_x"], x), cfg,
                                 kind="full", cross_x=cross_x, cache=x_cache,
                                 use_kernel=use_kernel)
        if "gate_x" in p:
            h = torch.tanh(p["gate_x"]) * h
        x = x + h
        if cache is not None and c_x:
            new_cache.update(c_x)

    h2 = _norm(cfg, p["ln2"], x)
    aux = 0.0
    if cfg.moe is not None:
        h2, aux = moe_block(p["moe"], h2, cfg)
    else:
        h2 = mlp(p["mlp"], h2, cfg.act)
    if kind == "cross" and "gate_m" in p:
        h2 = torch.tanh(p["gate_m"]) * h2
    return x + h2, new_cache, aux


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
