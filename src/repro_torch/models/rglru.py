"""Griffin / RecurrentGemma recurrent block: conv1d + RG-LRU.

The port of ``repro.models.rglru``.  RG-LRU (Real-Gated Linear Recurrent
Unit, arXiv:2402.19427):

    r_t = sigmoid(W_a x_t + b_a)              (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)              (input gate)
    a_t = exp(-c * softplus(Λ) * r_t)         (data-dependent decay, c=8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The surrounding block is Griffin's: two input branches (GeLU gate x
conv1d -> RG-LRU), merged by an output projection.

The reference runs the recurrence through an associative scan (short or
ragged T), a chunked ``lax.scan`` (whose chunks serve rematerialisation in
the backward pass) or, at decode, one inline update.  All compute the same
recurrence, so the port sends every one, at any T, through
``repro_torch.kernels.rglru.ops.rglru_scan``: K5 on the card,
``rglru_scan_ref`` (one loop over T) otherwise.  The recurrence runs in
f32 and, as in the reference, the cached state ``h`` is rounded to the
model's dtype after every prefill and decode step.  ``softplus`` is the
reference's ``jax.nn.softplus``, ``logaddexp(x, 0)``, written out, not
``F.softplus`` (whose linear branch above 20 rounds differently).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rglru.ops import rglru_scan
from .common import Params, _trunc_normal, dense_init, matmul_lowp

_C = 8.0
_CONV_W = 4


def _gate_blocks(w: int) -> int:
    """Griffin's RG-LRU gates use BLOCK-DIAGONAL weights (one block per
    head in the reference implementation)."""
    for nb in (16, 8, 4, 2):
        if w % nb == 0 and (w // nb) >= 8:
            return nb
    return 1


def rglru_init(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype = torch.float32) -> Params:
    d = cfg.d_model
    w = d  # lru width = d_model
    nb = _gate_blocks(w)
    bw = w // nb
    dev = gen.device
    scale = 1.0 / math.sqrt(bw)
    zeros = torch.zeros((w,), dtype=dtype, device=dev)
    # Λ init so that a = exp(-c*softplus(Λ)) spans ~(0.9, 0.999)
    spread = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=dev)
    return {
        "w_gate_branch": dense_init(gen, d, w, dtype),
        "w_x_branch": dense_init(gen, d, w, dtype),
        "conv_w": _trunc_normal(gen, (_CONV_W, w), 0.1, dtype),
        "conv_b": zeros,
        "w_a": _trunc_normal(gen, (nb, bw, bw), scale, dtype),
        "b_a": zeros.clone(),
        "w_i": _trunc_normal(gen, (nb, bw, bw), scale, dtype),
        "b_i": zeros.clone(),
        "lam": torch.log(torch.expm1(-torch.log(spread) / _C)),
        "w_out": dense_init(gen, w, d, dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``jnp.logaddexp(x, 0)``, term for term."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _block_diag_matmul(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u (B,T,W) x block-diagonal w (nb, W/nb, W/nb) -> (B,T,W)."""
    b, t, width = u.shape
    nb, bw, _ = w.shape
    ub = u.reshape(b, t, nb, bw)
    out = torch.einsum("btnw,nwv->btnv", ub, w)
    return out.reshape(b, t, width)


def _rglru_scan(a: torch.Tensor, bx: torch.Tensor,
                h0: Optional[torch.Tensor] = None, *,
                use_kernel: bool = True) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t over axis 1 (time), from ``h0``.

    The reference folds ``a_0 * h0`` into ``bx_0`` and scans from zero;
    the plain loop and K5 add the same two rounded terms at step 0."""
    return rglru_scan(a, bx, use_kernel, h0=h0)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d, width 4. x (B,T,W); state (B,3,W) history.

    Returns (y, new_state).  The taps are summed in the reference's order,
    from a Python 0, each product and sum rounded to x's dtype."""
    hist = state if state is not None else torch.zeros(
        (x.shape[0], _CONV_W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([hist, x], dim=1)
    t = x.shape[1]
    y = sum(xp[:, i:i + t] * w[i] for i in range(_CONV_W)) + b
    return y, xp[:, -(_CONV_W - 1):]


def rglru_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[Params] = None, use_kernel: bool = True):
    """Griffin recurrent block. cache = {"h": (B,W), "conv": (B,3,W)}.

    Returns (y, new_cache); the new cache holds new tensors, as the
    reference's does.  Prefill and the one-token decode step share one
    path: the reference's inline decode update is the scan's one step."""
    gate = F.gelu(x @ p["w_gate_branch"], approximate="tanh")
    u = x @ p["w_x_branch"]
    u, conv_state = _causal_conv(u, p["conv_w"], p["conv_b"],
                                 cache["conv"] if cache is not None else None)

    r = torch.sigmoid((_block_diag_matmul(u, p["w_a"]) + p["b_a"]).float())
    i = torch.sigmoid((_block_diag_matmul(u, p["w_i"]) + p["b_i"]).float())
    log_a = -_C * _softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    # (beta * i) folds to the input dtype before touching u, as in the
    # reference: in a bf16 model bx is rounded twice
    bx = ((beta * i).to(u.dtype) * u).float()

    h0 = cache["h"].float() if cache is not None else None
    out = _rglru_scan(a, bx, h0, use_kernel=use_kernel)
    new_cache = None
    if cache is not None:
        new_cache = {"h": out[:, -1].to(cache["h"].dtype), "conv": conv_state}

    y = matmul_lowp(out.to(x.dtype) * gate, p["w_out"])
    return y, new_cache
