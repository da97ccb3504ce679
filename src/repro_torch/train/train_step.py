"""The train, prefill and decode steps (the port of ``repro.train.train_step``).

The train step keeps the reference's functional shape,
``(params, opt_state, batch) -> (params, opt_state, metrics)``: the
gradient is ``torch.autograd.grad`` of ``Model.loss_fn`` over the flat
parameter leaves, so nothing is stored on the tensors.  It supports
gradient accumulation (``cfg.microbatches``): microbatch j holds rows j,
j + k, j + 2k, ... of the batch, as the reference's device-major split
gives them; gradients flow in the param dtype and are accumulated in
fp32; the loss is the microbatches' mean and the other metrics are the
last microbatch's.  On the card, attention's, the WKV6 recurrence's and
the RG-LRU scan's gradients run in K3's, K4's and K5's backward kernels
(``FlashAttentionFn``, ``WKV6Fn``, ``RGLRUScanFn`` in ``kernels``), so
every configuration trains there.

``donate=True`` is the counterpart of the reference's jitted
``donate_argnums=(0, 1)`` (divergence P21): the step writes the new
parameters and optimizer state into the leaves it was given and returns
those same trees (``optimizer.adamw_update(..., params=)``), so the old
and the new state are never live at once.  It gives the functional step's
bits.  Under DTensor the in-place writes keep each leaf's placements, so
the parameters come back on ``param_shardings`` and the state on
``opt_state_shardings``, as the reference's ``out_shardings`` put them.
The ``Trainer`` and the dry run's train cell donate, as the reference's
do; ``donate=False`` changes nothing it was given.  Either way the
microbatches' gradients are summed in place into one fp32 accumulator
placed like the parameters (the reference's scan carry), in the
reference's order.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._tree import leaves, unflatten
from ..models.model import Model
from .optimizer import AdamWConfig, adamw_update

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _split_microbatches(batch: dict, k: int) -> list[dict]:
    """(B, ...) -> k microbatches of B / k rows: microbatch j takes rows j,
    j + k, ... (the reference reshapes to (B / k, k, ...) and moves k in
    front)."""
    def split(x):
        b = x.shape[0]
        return x.reshape(b // k, k, *x.shape[1:]).transpose(0, 1)
    parts = {name: split(x) for name, x in batch.items()}
    return [{name: xs[j] for name, xs in parts.items()} for j in range(k)]


def make_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None, *,
                    donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); with ``donate`` the returned trees are the arguments,
    updated in place."""
    cfg = model.cfg
    opt_cfg = opt_cfg or AdamWConfig()
    pdtype = _DTYPES[cfg.dtype]
    k = max(cfg.microbatches, 1)

    def value_and_grad(params, mb):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss, metrics = model.loss_fn(unflatten(params, flat), mb)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        metrics = {name: m.detach() if isinstance(m, torch.Tensor) else m
                   for name, m in metrics.items()}
        return loss.detach(), metrics, grads

    def grads_of(params, batch):
        if k == 1:
            loss, metrics, grads = value_and_grad(params, batch)
            return loss, metrics, unflatten(params, grads)
        # zeros_like keeps a DTensor leaf's placements: each rank
        # accumulates its own shard of the gradient
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
        total = torch.zeros((), dtype=torch.float32, device=acc[0].device)
        for mb in _split_microbatches(batch, k):
            loss, metrics, grads = value_and_grad(params, mb)
            for a, g in zip(acc, grads):
                a.add_(g.float() / k)
            del grads           # not live through the next backward
            total = total + loss / k
        return total, metrics, unflatten(params, acc)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, grads, opt_state, param_dtype=pdtype,
            params=params if donate else None)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch, caches):
        return model.prefill(params, batch, caches)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, tokens, pos, caches):
        return model.decode_step(params, tokens, pos, caches)
    return decode_step
