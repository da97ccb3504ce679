"""Shared building blocks for the model zoo (plain dicts of tensors, functional).

The port of ``repro.models.common``.  Parameters are nested dicts of
tensors and layers are plain functions, so the reference's functional
signatures carry over.  Initialisers take an explicit ``torch.Generator``
and draw on its device; they do not reproduce ``jax.random``'s numbers, so
the parity tests carry the reference's parameters across with
``repro_torch.models.convert`` instead.  Inside ``abstract_init()`` they
put everything on ``meta`` (``draw_device``): shapes and dtypes with no
memory, which is how ``Model.abstract_params`` builds a full-width tree.
A CPU generator is taken there and never advanced (a ``torch.Generator``
cannot live on ``meta``; the draws on ``meta`` tensors read none of it).
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

_ABSTRACT = threading.local()


def draw_device(gen: torch.Generator) -> torch.device:
    """Where an initialiser puts what it draws from ``gen``: the
    generator's device, or ``meta`` inside ``abstract_init()``."""
    return torch.device("meta") if getattr(_ABSTRACT, "on", False) else gen.device


@contextlib.contextmanager
def abstract_init():
    """Initialisers build ``meta`` tensors (no memory) while open."""
    prev = getattr(_ABSTRACT, "on", False)
    _ABSTRACT.on = True
    try:
        yield
    finally:
        _ABSTRACT.on = prev


def _trunc_normal(gen: torch.Generator, shape: tuple[int, ...],
                  std: float, dtype: torch.dtype) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], times ``std``, drawn in f32 on
    the generator's device and then cast (as the reference does).  Scaled
    in place: a full-width embedding is gigabytes in f32."""
    t = torch.empty(shape, dtype=torch.float32, device=draw_device(gen))
    if t.is_meta:
        return t.to(dtype)
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


def _vocab_iota(logits: torch.Tensor) -> torch.Tensor:
    """0..V-1 along the vocab axis, for logits whose vocab axis is whole on
    every rank: under a mesh a replicated DTensor, else a plain ``arange``."""
    from torch.distributed.tensor import DTensor, Replicate

    iota = torch.arange(logits.shape[-1], device=logits.device)
    if not isinstance(logits, DTensor):
        return iota
    return DTensor.from_local(iota, logits.device_mesh,
                              [Replicate()] * logits.device_mesh.ndim, run_check=False)


def _vocab_dims(logits: torch.Tensor) -> list[int]:
    """The mesh dims that shard a DTensor's last (vocab) axis; [] for a
    plain tensor or a whole vocab."""
    from torch.distributed.tensor import DTensor

    if not isinstance(logits, DTensor):
        return []
    last = logits.ndim - 1
    return [m for m, p in enumerate(logits.placements)
            if p.is_shard() and p.dim % logits.ndim == last]


def _vocab_shard(logits, dims: list[int]) -> tuple[int, int]:
    """(offset, length) of this rank's vocab shard of DTensor ``logits``,
    sharded over mesh ``dims``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    pl = [Shard(0) if m in dims else Replicate() for m in range(logits.device_mesh.ndim)]
    (n,), (lo,) = compute_local_shape_and_global_offset(
        (logits.shape[-1],), logits.device_mesh, pl)
    return lo, n


def _gold(labels: torch.Tensor, offset: int, n: int) -> torch.Tensor:
    """(..., n) bool: where a shard of ``n`` words from ``offset`` holds
    each token's label."""
    return torch.arange(offset, offset + n, device=labels.device) == labels[..., None]


class VocabParallelNLL(torch.autograd.Function):
    """Per-token cross-entropy on one rank's vocab shard of the logits: the
    reference's vocab-parallel form with its collectives made explicit.

    Forward, on local tensors: the f32 max, all-reduced MAX over the vocab's
    process groups; the sum of ``exp(logits - max)`` and the gold pick at
    the shard's own offset, each all-reduced SUM.  Three (B, S)-sized
    all-reduces, nothing vocab-sized on the wire.  Saved: the local logits
    shard and the (B, S) max and sum.  Backward, without a collective:
    ``exp(shifted) * (g / z) + where(gold, -g, 0)``, the product and the
    sum the plain form's autograd forms, so that groups of one rank give
    its gradient bit for bit."""

    @staticmethod
    def forward(ctx, logits, labels, offset, groups):
        import torch.distributed as dist

        x = logits.float()
        m = torch.amax(x, dim=-1, keepdim=True)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        shifted = x - m
        del x
        z = torch.sum(torch.exp(shifted), dim=-1)
        gold = torch.sum(torch.where(_gold(labels, offset, shifted.shape[-1]), shifted, 0.0),
                         dim=-1)
        del shifted
        for g in groups:
            dist.all_reduce(z, group=g)
        for g in groups:
            dist.all_reduce(gold, group=g)
        ctx.offset = offset
        ctx.save_for_backward(logits, labels, m, z)
        return torch.log(z) - gold

    @staticmethod
    def backward(ctx, g):
        logits, labels, m, z = ctx.saved_tensors
        d = logits.to(torch.float32, copy=True).sub_(m).exp_().mul_((g / z)[..., None])
        d.add_(torch.where(_gold(labels, ctx.offset, d.shape[-1]), -g[..., None], 0.0))
        return d.to(logits.dtype), None, None, None


def _vocab_parallel_nll(logits, labels: torch.Tensor, dims: list[int]):
    """Per-token nll of vocab-sharded DTensor ``logits`` as a DTensor placed
    as the labels are: the logits' placements on the other axes,
    replicated over the vocab's mesh dims."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = logits.device_mesh
    want = [Replicate() if m in dims else p for m, p in enumerate(logits.placements)]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    local_labels = labels.redistribute(mesh, want).to_local()
    offset, _ = _vocab_shard(logits, dims)
    nll = VocabParallelNLL.apply(logits.to_local(), local_labels, offset,
                                 tuple(mesh.get_group(m) for m in dims))
    return DTensor.from_local(nll, mesh, want, run_check=False, shape=labels.shape,
                              stride=labels.stride())


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V) in any float dtype.

    The reference's vocab-parallel form: max, sum-exp and gold pick as
    reductions over the vocab axis.  Logits whose vocab axis a mesh shards
    (a DTensor) take :class:`VocabParallelNLL` on each rank's shard, which
    XLA's partitioner makes of the same form in the reference: local
    partials and (B, S)-sized all-reduces, no rank holding its rows'
    logits over the whole vocab.  Other logits take the form as written."""
    dims = _vocab_dims(logits)
    if dims:
        nll = _vocab_parallel_nll(logits, labels, dims)
    else:
        logits = logits.float()
        m = torch.amax(logits, dim=-1, keepdim=True).detach()
        shifted = logits - m
        z = torch.sum(torch.exp(shifted), dim=-1)
        vocab_iota = _vocab_iota(logits)
        gold_shifted = torch.sum(
            torch.where(vocab_iota == labels[..., None], shifted, 0.0), dim=-1)
        nll = torch.log(z) - gold_shifted
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
