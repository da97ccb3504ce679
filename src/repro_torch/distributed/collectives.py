"""Collective helpers: compressed all-reduce, LSE combine, halo exchange.

The port of ``repro.distributed.collectives``, on ``torch.distributed``:
each helper takes a process ``group`` (``None``: the default group) where
the reference takes a mesh axis name inside ``shard_map``, and is called
on every rank of it with that rank's local tensor.

``compressed_psum``'s "int8" mode does the reference's f32 operations in
its order (one global scale synced by ``MAX``, ``torch.round``'s half to
even as ``jnp.round``, the sum in int32, the residual rounded once as
XLA's fused multiply-add rounds it), so its result and error state equal
the JAX package's bit for bit.  ``ring_halo_exchange`` sends only
the pairs whose result is kept: the reference's ring also sends the
wrap-around pair and then zeroes it on arrival.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def compressed_psum(x: torch.Tensor, group=None, *, compression: str = "bf16",
                    error_state: torch.Tensor | None = None):
    """All-reduce (sum) with on-the-wire compression + error feedback.

    compression:
      "none" — plain sum, in f32.
      "bf16" — cast to bf16 before the reduce (2x wire saving).
      "int8" — per-tensor scale quantization with error feedback: the
               quantization residual is returned and should be added to the
               NEXT step's tensor (standard EF-SGD).

    Returns (reduced_f32, new_error_state).
    """
    if compression == "none":
        return _all_reduce(x.float(), dist.ReduceOp.SUM, group), error_state
    if compression == "bf16":
        return _all_reduce(x.to(torch.bfloat16), dist.ReduceOp.SUM, group).float(), \
            error_state
    if compression == "int8":
        xf = x.float()
        if error_state is not None:
            xf = xf + error_state
        # one global scale first, so every member quantizes on the same grid
        # and the int32 sum dequantizes exactly
        scale = _all_reduce(torch.clamp(torch.amax(torch.abs(xf)), min=1e-12),
                            dist.ReduceOp.MAX, group) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        # XLA compiles the reference's ``xf - q * scale`` into one fused
        # multiply-add (one rounding); the product is exact in f64 and so is
        # the difference (|xf - q*scale| <= scale/2), so this rounds once too
        err = (xf.double() - q.double() * scale.double()).float()
        total_q = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
        return total_q.float() * scale, err
    raise ValueError(f"unknown compression {compression!r}")


def lse_combine(partial_out: torch.Tensor, partial_max: torch.Tensor,
                partial_sum: torch.Tensor, group=None) -> torch.Tensor:
    """Flash-decode combine: merge per-rank attention partials over ``group``.

    partial_out: (..., d) = sum_j exp(s_j - m) v_j   (local)
    partial_max: (...,)   = m                        (local max logit)
    partial_sum: (...,)   = sum_j exp(s_j - m)       (local)
    """
    g_max = _all_reduce(partial_max, dist.ReduceOp.MAX, group)
    alpha = torch.exp(partial_max - g_max)
    num = _all_reduce(partial_out * alpha[..., None], dist.ReduceOp.SUM, group)
    den = _all_reduce(partial_sum * alpha, dist.ReduceOp.SUM, group)
    return num / torch.clamp(den[..., None], min=1e-37)


def _peer(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def ring_halo_exchange(local: torch.Tensor, group=None):
    """(prev_plane, next_plane) for 1D domain decomposition (Dirichlet):
    the last plane of the previous rank and the first plane of the next,
    zeros at the two ends."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    up = torch.zeros_like(local[-1])
    down = torch.zeros_like(local[0])
    ops = []
    if idx < n - 1:
        ops += [dist.P2POp(dist.isend, local[-1].contiguous(), _peer(group, idx + 1), group),
                dist.P2POp(dist.irecv, down, _peer(group, idx + 1), group)]
    if idx > 0:
        ops += [dist.P2POp(dist.isend, local[0].contiguous(), _peer(group, idx - 1), group),
                dist.P2POp(dist.irecv, up, _peer(group, idx - 1), group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return up, down


def reduce_scatter_then_all_gather(x: torch.Tensor, group,
                                   update: Callable[[torch.Tensor], torch.Tensor]):
    """Decomposed all-reduce: reduce-scatter → local update → all-gather.

    The overlap-friendly form of a gradient reduction + optimizer update
    (ZeRO-style): each member updates only its 1/n slice of dim 0.  The
    gather is ``all_gather`` into a list, a name every supported torch has.
    """
    n = dist.get_world_size(group)
    scattered = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(scattered, x.contiguous(), group=group)
    updated = update(scattered).contiguous()
    parts = [torch.empty_like(updated) for _ in range(n)]
    dist.all_gather(parts, updated, group=group)
    return torch.cat(parts, dim=0)
