"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.

The port of ``repro.models.rwkv``.  Time-mix recurrence per head (state
S ∈ R^{hd x hd}):

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    o_t = (S_{t-1} + diag(u) k_t v_tᵀ)ᵀ r_t

with per-channel, data-dependent decay w_t = exp(-exp(ŵ_t)) and token-shift
interpolation (a small LoRA makes the lerp amounts data-dependent).

The reference runs prefill through a chunked ``lax.scan``
(``_wkv_chunk_scan``, whose chunking serves rematerialisation in the
backward pass) and decode through an inline one-step update.  Both compute
the same recurrence, so the port sends both, at any T, through
``repro_torch.kernels.rwkv6.ops.wkv6``: K4 on the card, ``wkv6_ref`` (one
loop over T) otherwise.  As in the reference, r, k and v are rounded to
bf16 before the recurrence even in an f32 model, and w, u and the state
stay f32.  With a cache the final state is written into ``cache["s"]`` in
place (ROADMAP P8).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rwkv6.ops import wkv6
from .common import Params, dense_init


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def _uniform(gen: torch.Generator, shape: tuple[int, ...], scale: float,
             dtype: torch.dtype) -> torch.Tensor:
    """U[0, 1) times ``scale``, drawn in f32 and then cast (as the reference)."""
    return (torch.rand(shape, generator=gen, device=gen.device) * scale).to(dtype)


def rwkv_init(gen: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype = torch.float32) -> Params:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = _heads(cfg)
    lora = 64
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return {
        # time-mix
        "mix_base": _uniform(gen, (5, d), 0.5, dtype),
        "mix_lora_a": dense_init(gen, d, 32, dtype),
        "mix_lora_b": full((32, 5 * d), 0.0),
        "w_r": dense_init(gen, d, d, dtype),
        "w_k": dense_init(gen, d, d, dtype),
        "w_v": dense_init(gen, d, d, dtype),
        "w_g": dense_init(gen, d, d, dtype),
        "decay_base": full((d,), -6.0),
        "decay_lora_a": dense_init(gen, d, lora, dtype),
        "decay_lora_b": full((lora, d), 0.0),
        "u": _uniform(gen, (h, hd), 0.5, dtype),
        "gn_scale": full((d,), 1.0),
        "gn_bias": full((d,), 0.0),
        "w_o": dense_init(gen, d, d, dtype),
        # channel-mix
        "cmix_k": _uniform(gen, (d,), 0.5, dtype),
        "cmix_r": _uniform(gen, (d,), 0.5, dtype),
        "w_ck": dense_init(gen, d, cfg.d_ff, dtype),
        "w_cv": dense_init(gen, cfg.d_ff, d, dtype),
        "w_cr": dense_init(gen, d, d, dtype),
    }


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} sequence (first step uses carried state or zeros)."""
    first = x_prev[:, None] if x_prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: Optional[Params] = None, use_kernel: bool = True):
    """Returns (out, new_cache). cache = {"s": (B,H,hd,hd) f32, "x_tm": (B,D)}."""
    b, t, d = x.shape
    h, hd = _heads(cfg), cfg.rwkv_head_dim

    x_last = _token_shift(x, cache["x_tm"] if cache is not None else None)
    dx = x_last - x
    # data-dependent lerp amounts (5 projections share a LoRA), in the
    # order r, k, v, w, g
    lora = torch.tanh(x @ p["mix_lora_a"]) @ p["mix_lora_b"]
    mix = p["mix_base"][:, None, None] + lora.reshape(b, t, 5, d).permute(2, 0, 1, 3)
    xr, xk, xv, xw, xg = [x + dx * mix[i] for i in range(5)]

    # r, k, v stream in bf16 whatever the model's dtype (the reference does
    # so on prefill and decode alike); decay, u and the state stay f32
    r, k, v = ((xs @ p[name]).reshape(b, t, h, hd).to(torch.bfloat16)
               for xs, name in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    g = F.silu(xg @ p["w_g"])

    decay = p["decay_base"].float() + \
        (torch.tanh(xw @ p["decay_lora_a"]) @ p["decay_lora_b"]).float()
    w = torch.exp(-torch.exp(decay)).reshape(b, t, h, hd)

    s0 = cache["s"] if cache is not None else None
    o, st = wkv6(r, k, v, w, p["u"].float(), use_kernel, s0=s0)

    # group norm over each head (population variance, as jnp.var)
    og = o.reshape(b, t, h, hd)
    mu = og.mean(-1, keepdim=True)
    var = og.var(-1, keepdim=True, unbiased=False)
    og = (og - mu) * torch.rsqrt(var + 1e-5)
    o = og.reshape(b, t, d) * p["gn_scale"].float() + p["gn_bias"].float()
    out = (o.to(x.dtype) * g) @ p["w_o"]

    new_cache = None
    if cache is not None:
        new_cache = {"s": st, "x_tm": x[:, -1]}
    return out, new_cache


def rwkv_channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     cache: Optional[Params] = None):
    """relu² channel mix with token shift. cache = {"x_cm": (B,D)}."""
    x_last = _token_shift(x, cache["x_cm"] if cache is not None else None)
    dx = x_last - x
    xk = x + dx * p["cmix_k"]
    xr = x + dx * p["cmix_r"]
    v = torch.square(F.relu(xk @ p["w_ck"])) @ p["w_cv"]
    out = torch.sigmoid(xr @ p["w_cr"]) * v
    new_cache = {"x_cm": x[:, -1]} if cache is not None else None
    return out, new_cache
