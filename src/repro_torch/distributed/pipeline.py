"""Pipeline parallelism (GPipe-style) over a process group.

The port of ``repro.distributed.pipeline``.  The reference runs the stage
loop inside ``shard_map`` over the mesh's "pod" axis and hands activations
on with ``ppermute``; here each rank of ``group`` is one stage, called
with its own stage parameters, and hands activations to the next rank
with ``isend``/``irecv`` in a ring.  Stage s owns layers [s*L/P,
(s+1)*L/P); each of M microbatches flows stage to stage; the loop runs
M + P - 1 ticks, each one stage compute + one handoff.  Bubble fraction =
(P-1)/(M+P-1).

Keeping weight shards pod-local and moving only microbatch activations
between stages is the paper's locality rule (keep bandwidth-hungry traffic
inside the locality domain, let only the thin stream cross) applied to the
parallelism layout itself; ``pipeline_wire_bytes`` is the napkin model that
decides between DP-over-pods and PP-over-pods.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .collectives import _peer


def _ring_shift(y: torch.Tensor, group, stage: int, n_stage: int) -> torch.Tensor:
    """Send ``y`` to the next stage, receive from the previous (a ring)."""
    if n_stage == 1:
        return y
    incoming = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(), _peer(group, (stage + 1) % n_stage), group),
           dist.P2POp(dist.irecv, incoming, _peer(group, (stage - 1) % n_stage), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return incoming


def pipelined_apply(layer_fn: Callable, stage_params, x_mb: torch.Tensor,
                    group=None, gather_output: bool = True) -> torch.Tensor:
    """Run M microbatches through P pipeline stages, one per rank of ``group``.

    layer_fn(params_slice, x) -> x : one stage's computation.
    stage_params: this rank's stage parameters (the reference's leading
      stage axis, local to the stage: length 1).
    x_mb: (M, mb, ...) microbatched inputs, the same on every stage.

    Returns (M, mb, ...) outputs: with ``gather_output`` on every stage,
    else valid on the LAST stage only (zeros elsewhere).
    """
    n_stage = dist.get_world_size(group)
    stage = dist.get_rank(group)
    m = x_mb.shape[0]
    state = torch.zeros_like(x_mb[0])
    outputs = torch.zeros_like(x_mb)
    for t in range(m + n_stage - 1):
        # stage 0 injects microbatch t (if any remain); others use incoming
        x_in = x_mb[min(t, m - 1)] if stage == 0 else state
        y = layer_fn(stage_params, x_in)
        # the last stage records finished microbatch t - (P-1)
        out_idx = t - (n_stage - 1)
        if stage == n_stage - 1 and out_idx >= 0:
            outputs[out_idx] = y
        state = _ring_shift(y, group, stage, n_stage)
    if gather_output:
        # results exist only on the last stage (zeros elsewhere): a sum is
        # exactly the broadcast from the last stage
        dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
    return outputs


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def pipeline_wire_bytes(param_bytes: float, act_bytes_per_mb: float,
                        num_stages: int, num_microbatches: int) -> dict:
    """Napkin model: inter-pod traffic per step, DP-over-pods vs PP-over-pods.

    DP: 2x param_bytes gradient all-reduce across pods.
    PP: one activation handoff per microbatch per stage boundary
        (forward + backward), no cross-pod gradient traffic.
    """
    dp = 2.0 * param_bytes
    pp = 2.0 * act_bytes_per_mb * num_microbatches * (num_stages - 1) / num_stages
    return {"dp_bytes": dp, "pp_bytes": pp,
            "pp_wins": pp < dp,
            "bubble": bubble_fraction(num_stages, num_microbatches)}
