"""AdamW with fp32 master weights (the port of ``repro.train.optimizer``).

State layout per parameter leaf: an fp32 master copy and fp32 first and
second moments, in the parameters' tree, plus the step as a 0-d int32
tensor, all on the parameters' device.  The update is the reference's,
operation for operation and in its order (``adamw_update``), as plain
per-leaf tensor code: an optimizer step reads and writes each state byte
once, so it is bound by memory and needs no kernel of its own.  Like the
reference it is functional: it returns new tensors and changes none it
was given.

``opt_state_shardings`` (the reference's ZeRO-1 layout over a mesh) waits
for a mesh in the port (ROADMAP E3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .._tree import leaves, tree_map, unflatten

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
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Params) -> torch.Tensor:
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_update(c: AdamWConfig, grads: Params, opt_state: dict,
                 param_dtype=torch.bfloat16):
    """Returns (new_params, new_opt_state, metrics)."""
    with torch.no_grad():
        step = opt_state["step"] + 1
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
            m = c.b1 * m + (1 - c.b1) * g
            v = c.b2 * v + (1 - c.b2) * torch.square(g)
            mhat = m / b1c
            vhat = v / b2c
            delta = mhat / (torch.sqrt(vhat) + c.eps) + c.weight_decay * master
            master = master - lr * delta
            return m, v, master

        out = [upd(g, m, v, w) for g, m, v, w in zip(
            leaves(grads), leaves(opt_state["m"]), leaves(opt_state["v"]),
            leaves(opt_state["master"]))]
        new_m = unflatten(grads, [o[0] for o in out])
        new_v = unflatten(grads, [o[1] for o in out])
        new_master = unflatten(grads, [o[2] for o in out])
        new_params = tree_map(lambda w: w.to(param_dtype), new_master)
    new_state = {"master": new_master, "m": new_m, "v": new_v, "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
