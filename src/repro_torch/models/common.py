"""Shared building blocks for the model zoo (plain dicts of tensors, functional).

The port of ``repro.models.common``.  Parameters are nested dicts of
tensors and layers are plain functions, so the reference's functional
signatures carry over.  Initialisers take an explicit ``torch.Generator``
and draw on its device; they do not reproduce ``jax.random``'s numbers, so
the parity tests carry the reference's parameters across with
``repro_torch.models.convert`` instead.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _trunc_normal(gen: torch.Generator, shape: tuple[int, ...],
                  std: float, dtype: torch.dtype) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], times ``std``, drawn in f32 on
    the generator's device and then cast (as the reference does).  Scaled
    in place: a full-width embedding is gigabytes in f32."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return t.mul_(std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (matches common LM practice)."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _trunc_normal(gen, (d_in, d_out), std, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _trunc_normal(gen, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm_init(d: int, dtype: torch.dtype = torch.float32,
                  device: torch.device | str | None = None) -> Params:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with (1 + scale) parameterization (gemma/llama style).

    Statistics in f32, application in the input dtype, at the reference's
    exact dtype points."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    mult = (torch.rsqrt(var + eps) * (1.0 + p["scale"].float())).to(x.dtype)
    return x * mult


def layer_norm_init(d: int, dtype: torch.dtype = torch.float32,
                    device: torch.device | str | None = None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    mult = torch.rsqrt(var + eps) * p["scale"].float()
    return (x - mu.to(x.dtype)) * mult.to(x.dtype) + p["bias"].to(x.dtype)


# ---------------------------------------------------------------------------
# rotary / positional embeddings
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    """(head_dim/2,) f32 rotary frequencies.  Cached: every layer of every
    step asks for the same ones, and eager PyTorch would launch four kernels
    each time (the reference's XLA computes them once per compiled step)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., None].float() * freqs                # (..., T, hd/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., T, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int,
                         device: torch.device | str | None = None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (n, d)."""
    log_timescale = math.log(10000) / (d // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(d // 2, dtype=torch.float32,
                                                  device=device))
    t = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


# ---------------------------------------------------------------------------
# activations / losses
# ---------------------------------------------------------------------------

def matmul_lowp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-parallel projection matmul with low-precision partials.

    The reference asks XLA for a bf16 result so that sharded partial sums
    travel in bf16.  A PyTorch matmul of two bf16 tensors already returns
    bf16 (accumulated in f32), and the port has no sharded contraction yet,
    so this is a plain product kept under the reference's name.
    """
    return a @ b


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_exact": lambda x: F.gelu(x, approximate="none"),
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V) in any float dtype.

    The reference's vocab-parallel form (max, sum-exp and gold pick as plain
    reductions over the vocab axis), kept so a later sharded port needs no
    rewrite."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - m
    z = torch.sum(torch.exp(shifted), dim=-1)
    vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
    gold_shifted = torch.sum(
        torch.where(vocab_iota == labels[..., None], shifted, 0.0), dim=-1)
    nll = torch.log(z) - gold_shifted
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
