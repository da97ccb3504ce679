"""AdamW with fp32 master weights (the port of ``repro.train.optimizer``).

State layout per parameter leaf: an fp32 master copy and fp32 first and
second moments, in the parameters' tree, plus the step as a 0-d int32
tensor, all on the parameters' device.  The update is the reference's,
operation for operation and in its order (``adamw_update``), as plain
per-leaf tensor code: an optimizer step reads and writes each state byte
once, so it is bound by memory and needs no kernel of its own.  Like the
reference it is functional by default: it returns new tensors and changes
none it was given.  Given ``params`` it is donated (divergence P21, the
counterpart of the reference's ``donate_argnums=(0, 1)``): it writes the
new master, m, v and step into the state's own leaves and the new
parameters into ``params``' leaves, and returns those trees.  Both modes
run one body of separately rounded ops (``mul``, ``add`` of a product
already computed, ``div``, ``sqrt``, ``sub``; on the temporaries in
place, which rounds as the op does), so they give the same bits;
a fused form (``add_(..., alpha=)``, ``addcmul_``, ``addcdiv_``, ``lerp_``,
the ``_foreach`` kernels) contracts a multiply-add and would not.  The
leaves may be DTensors (a sharded train step, under
``distributed.sharding.use_rules``): every operation here then runs
sharded.  An in-place op keeps its destination's placements and DTensor
redistributes the source, so the donated update leaves the parameters on
``param_shardings`` and the state on ``opt_state_shardings``, as the
reference's ``out_shardings`` do.

``opt_state_shardings`` is the reference's ZeRO-1 layout: the state's
placements are the parameters', plus the "zero" logical axis (the data
mesh dim) on the first still-unsharded dimension it divides.  The port's
stack is a list of per-layer leaves, so that dimension is a layer leaf's
own; the reference's stacked leaves put it on the layer-stack axis when it
divides (its ``param_tree`` decides, and the same tree gives the same
specs in both packages).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .._tree import flatten_with_path, leaves, tree_map, unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(c: AdamWConfig, step: torch.Tensor | float) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32 (``step`` a tensor or number)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return c.lr * warm * (c.min_lr_frac + (1 - c.min_lr_frac) * cos)


def init_opt_state(params: Params) -> dict:
    device = leaves(params)[0].device
    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Params) -> torch.Tensor:
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_update(c: AdamWConfig, grads: Params, opt_state: dict,
                 param_dtype=torch.bfloat16, *, params: Params = None):
    """Returns (new_params, new_opt_state, metrics).  With ``params``
    given, the update is donated: ``opt_state``'s leaves and ``params``'
    leaves take the new values in place (each parameter by ``copy_`` from
    its master, which rounds as ``.to(param_dtype)`` does), and the two
    trees themselves are returned."""
    donate = params is not None
    # the first op of each update makes the new tensor, or writes the old
    mul = torch.Tensor.mul_ if donate else torch.Tensor.mul
    sub = torch.Tensor.sub_ if donate else torch.Tensor.sub
    with torch.no_grad():
        step = opt_state["step"].add_(1) if donate else opt_state["step"] + 1
        stepf = step.float()
        lr = schedule(c, stepf)

        gnorm = global_norm(grads)
        scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

        b1c = 1 - torch.pow(torch.tensor(c.b1, dtype=torch.float32,
                                         device=stepf.device), stepf)
        b2c = 1 - torch.pow(torch.tensor(c.b2, dtype=torch.float32,
                                         device=stepf.device), stepf)

        def upd(g, m, v, master):
            g = g.float() * scale
            m = mul(m, c.b1).add_((1 - c.b1) * g)
            v = mul(v, c.b2).add_(torch.square(g).mul_(1 - c.b2))
            del g
            # mhat / (sqrt(vhat) + eps) + wd * master, then times lr: each
            # temporary written over by the next op, at most two of them live
            delta = (m / b1c).div_((v / b2c).sqrt_().add_(c.eps))
            delta.add_(c.weight_decay * master)
            master = sub(master, delta.mul_(lr))
            return m, v, master

        out = [upd(g, m, v, w) for g, m, v, w in zip(
            leaves(grads), leaves(opt_state["m"]), leaves(opt_state["v"]),
            leaves(opt_state["master"]))]
        metrics = {"grad_norm": gnorm, "lr": lr}
        if donate:
            for p, (_, _, w) in zip(leaves(params), out):
                p.copy_(w)
            return params, opt_state, metrics
        new_m = unflatten(grads, [o[0] for o in out])
        new_v = unflatten(grads, [o[1] for o in out])
        new_master = unflatten(grads, [o[2] for o in out])
        new_params = tree_map(lambda w: w.to(param_dtype), new_master)
    new_state = {"master": new_master, "m": new_m, "v": new_v, "step": step}
    return new_params, new_state, metrics


def opt_state_shardings(param_shardings_tree, rules, param_tree):
    """Placements for the opt state: like params, plus the "zero" axis on
    the first still-unsharded, divisible dimension (ZeRO-1)."""
    from ..distributed.sharding import _names, placements, spec_of
    from ..models.model import _placement_leaves

    zero_axis = rules.rules.get("zero")
    data_size = rules.axis_size(zero_axis) if zero_axis is not None else 1

    def zero_shard(pl, leaf):
        spec = list(spec_of(rules.mesh, pl, len(leaf.shape)))
        used = {a for s in spec for a in _names(s)}
        if zero_axis is not None and zero_axis not in used:
            for i, s in enumerate(spec):
                if s is None and leaf.shape[i] % data_size == 0 and data_size > 1:
                    spec[i] = zero_axis
                    break
        return placements(rules.mesh, spec)

    like_params = unflatten(param_tree, [
        zero_shard(pl, leaf) for pl, (_, leaf) in
        zip(_placement_leaves(param_tree, param_shardings_tree),
            flatten_with_path(param_tree))])
    return {"master": like_params, "m": like_params, "v": like_params,
            "step": placements(rules.mesh, ())}
