"""The parameter bridge from the JAX package to the port (ROADMAP B2).

``repro.models.model.Model.init_params`` returns a tree whose stack is
``{"groups": [...], "remainder": [...]}``: each pattern position's
parameters stacked over its repeats (a leading ``reps`` axis, from
``jax.vmap``), then the unrolled remainder layers.  The port's stack is a
list of per-layer dicts in layer order.  ``params_from_jax`` takes the
reference's tree with every leaf already a numpy array (``np.asarray`` of
each JAX array; the port imports no JAX) and returns the port's tree, with
the reference's leaf names, on ``device``.  Whisper's encoder has a stack
of its own (``tree["encoder"]["stack"]``, at the encoder's widths), which
is unstacked the same way.

The reverse direction (B2b): ``params_to_jax`` stacks the port's layers
back into the reference's ``{"groups", "remainder"}`` tree as numpy
arrays (bf16 leaves as ``ml_dtypes.bfloat16``, the type JAX takes); it is
the exact inverse of ``params_from_jax``.  ``opt_state_to_jax`` and
``opt_state_from_jax`` do the same for the optimizer state (``master``,
``m`` and ``v`` like params, ``step`` a scalar).  ``to_reference_layout``
is the stacking alone, over any tensors (on the host, or ``meta`` for a
shape-only tree): the trainer writes and reads checkpoints in the
reference's layout through it, so a step directory written by either
package's manager resumes the other's trainer.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from .._tree import tree_map
from .common import Params
from .model import _enc_cfg

# leaf names of the reference's _LEAF_AXES (models/model.py) (attention,
# dense and expert MLPs, the router, MLA, RG-LRU, RWKV), plus the norms'
# own leaves and the VLM's cross-attention gates
LEAVES = frozenset({"tok", "head", "dec_pos", "scale", "bias", "wq", "wk", "wv", "wo",
                    "bq", "bk", "bv", "w_up", "w_gate", "w_down", "router",
                    "w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "w_kr",
                    "gate_x", "gate_m",
                    "w_gate_branch", "w_x_branch", "conv_w", "conv_b", "w_a",
                    "b_a", "w_i", "b_i", "lam", "w_out",
                    "w_r", "w_k", "w_v", "w_g", "w_o", "decay_lora_a",
                    "decay_lora_b", "mix_lora_a", "mix_lora_b", "mix_base",
                    "decay_base", "u", "gn_scale", "gn_bias", "w_ck", "w_cv",
                    "w_cr", "cmix_k", "cmix_r"})


def _tensor(a: Any, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # numpy has no bf16 of its own
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(tree: Any, device, path: str, index=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, f"{path}/{k}", index) for k, v in tree.items()}
    name = path.rsplit("/", 1)[-1]
    if name not in LEAVES:
        raise NotImplementedError(f"parameter {path!r} is not a leaf of any "
                                  "ported module")
    a = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return _tensor(a if index is None else a[index], device)


def _unstack(stack: dict[str, Any], cfg: ModelConfig, device, path: str) -> list[Params]:
    """The reference's ``{"groups", "remainder"}`` stack as a list of
    per-layer dicts in layer order."""
    kinds = cfg.layer_kinds()
    pattern = cfg.pattern
    reps = cfg.num_layers // len(pattern)
    groups, remainder = stack["groups"], stack["remainder"]
    if len(groups) != len(pattern) or len(remainder) != len(kinds) - reps * len(pattern):
        raise ValueError(f"{path} has {len(groups)} groups and {len(remainder)} "
                         f"remainder layers; {cfg.name} needs {len(pattern)} and "
                         f"{len(kinds) - reps * len(pattern)}")
    layers = [_convert(groups[pos], device, f"{path}/groups/{pos}", index=r)
              for r in range(reps) for pos in range(len(pattern))]
    return layers + [_convert(layer, device, f"{path}/remainder/{j}")
                     for j, layer in enumerate(remainder)]


def params_from_jax(tree: dict[str, Any], cfg: ModelConfig,
                    device: str | torch.device) -> Params:
    """The reference's parameter tree (numpy leaves, or host tensors as a
    checkpoint restores them) as the port's tree."""
    out = {k: _convert(v, device, k) for k, v in tree.items()
           if k not in ("stack", "encoder")}
    out["stack"] = _unstack(tree["stack"], cfg, device, "stack")
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "stack": _unstack(enc["stack"], _enc_cfg(cfg), device, "encoder/stack"),
            **{k: _convert(v, device, f"encoder/{k}") for k, v in enc.items()
               if k != "stack"}}
    return out


def _stack(layers: list[Params], cfg: ModelConfig, path: str, stack) -> dict[str, Any]:
    """The inverse of ``_unstack``: per-layer dicts as the reference's
    ``{"groups", "remainder"}``, each pattern position's repeats stacked
    along a new leading axis by ``stack``."""
    kinds = cfg.layer_kinds()
    pattern = cfg.pattern
    reps = cfg.num_layers // len(pattern)
    if len(layers) != len(kinds) or reps == 0:
        raise ValueError(f"{path} has {len(layers)} layers; {cfg.name} needs "
                         f"{len(kinds)} (at least one repeat of its pattern)")
    groups = [tree_map(lambda *xs: stack(list(xs)),
                       *[layers[r * len(pattern) + pos] for r in range(reps)])
              for pos in range(len(pattern))]
    return {"groups": groups, "remainder": list(layers[reps * len(pattern):])}


def _host_stack(xs: list[torch.Tensor]) -> torch.Tensor:
    """``torch.stack`` of the layers' leaves into one new tensor on the host
    (``meta`` stays ``meta``), one copy of each."""
    x0 = xs[0]
    device = "meta" if x0.device.type == "meta" else "cpu"
    out = torch.empty((len(xs), *x0.shape), dtype=x0.dtype, device=device)
    if device == "cpu":
        for i, x in enumerate(xs):
            out[i].copy_(x.detach())
    return out


def to_reference_layout(params: Params, cfg: ModelConfig) -> dict[str, Any]:
    """The port's tree in the reference's structure: the stack (and the
    encoder's) stacked on the host (``meta`` leaves stay ``meta``); the
    other leaves are the port's own tensors, uncopied."""
    out = {k: v for k, v in params.items() if k not in ("stack", "encoder")}
    out["stack"] = _stack(params["stack"], cfg, "stack", _host_stack)
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"stack": _stack(enc["stack"], _enc_cfg(cfg), "encoder/stack",
                                          _host_stack),
                          **{k: v for k, v in enc.items() if k != "stack"}}
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes                    # JAX's own bf16 type; present wherever JAX is
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_jax(params: Params, cfg: ModelConfig) -> dict[str, Any]:
    """The port's parameter tree as the reference's (numpy leaves): the
    exact inverse of ``params_from_jax``."""
    return tree_map(_numpy, to_reference_layout(params, cfg))


def opt_state_to_jax(opt_state: dict, cfg: ModelConfig) -> dict[str, Any]:
    """The port's optimizer state as the reference's ``init_opt_state``
    tree: ``master``, ``m`` and ``v`` like params, ``step`` an int32 scalar."""
    out = {k: params_to_jax(opt_state[k], cfg) for k in ("master", "m", "v")}
    out["step"] = _numpy(torch.as_tensor(opt_state["step"], dtype=torch.int32))
    return out


def opt_state_from_jax(tree: dict[str, Any], cfg: ModelConfig,
                       device: str | torch.device) -> dict:
    """The reference's optimizer state (numpy leaves or host tensors) as the
    port's."""
    out = {k: params_from_jax(tree[k], cfg, device) for k in ("master", "m", "v")}
    step = tree["step"]
    step = step if isinstance(step, torch.Tensor) else torch.from_numpy(np.array(step))
    out["step"] = step.to(device=device, dtype=torch.int32)
    return out
