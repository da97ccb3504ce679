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
is unstacked the same way.  The reverse direction waits for checkpoint
parity (ROADMAP E2).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
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
    a = np.asarray(tree)
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
    """The reference's parameter tree (numpy leaves) as the port's tree."""
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
