"""The parameter bridge from the JAX package to the port (ROADMAP B2).

``repro.models.model.Model.init_params`` returns a tree whose stack is
``{"groups": [...], "remainder": [...]}``: each pattern position's
parameters stacked over its repeats (a leading ``reps`` axis, from
``jax.vmap``), then the unrolled remainder layers.  The port's stack is a
list of per-layer dicts in layer order.  ``params_from_jax`` takes the
reference's tree with every leaf already a numpy array (``np.asarray`` of
each JAX array; the port imports no JAX) and returns the port's tree, with
the reference's leaf names, on ``device``.  The reverse direction waits for
checkpoint parity (ROADMAP E2).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from .common import Params
from .transformer import check_ported

# leaf names of the reference's _LEAF_AXES (models/model.py) that the
# ported layers use (attention and dense MLP, RG-LRU, RWKV), plus the
# norms' own leaves
LEAVES = frozenset({"tok", "head", "scale", "bias", "wq", "wk", "wv", "wo",
                    "bq", "bk", "bv", "w_up", "w_gate", "w_down",
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
        raise NotImplementedError(f"parameter {path!r} belongs to a module not "
                                  "ported yet")
    a = np.asarray(tree)
    return _tensor(a if index is None else a[index], device)


def params_from_jax(tree: dict[str, Any], cfg: ModelConfig,
                    device: str | torch.device) -> Params:
    """The reference's parameter tree (numpy leaves) as the port's tree."""
    kinds = cfg.layer_kinds()
    for kind in set(kinds):
        check_ported(cfg, kind)
    if cfg.encoder is not None or cfg.vision is not None:
        raise NotImplementedError("encoder/vision parameters are not ported "
                                  "yet: ROADMAP D")
    pattern = cfg.pattern
    reps = cfg.num_layers // len(pattern)
    groups, remainder = tree["stack"]["groups"], tree["stack"]["remainder"]
    if len(groups) != len(pattern) or len(remainder) != len(kinds) - reps * len(pattern):
        raise ValueError(f"stack has {len(groups)} groups and {len(remainder)} "
                         f"remainder layers; {cfg.name} needs {len(pattern)} and "
                         f"{len(kinds) - reps * len(pattern)}")
    stack = [_convert(groups[pos], device, f"stack/groups/{pos}", index=r)
             for r in range(reps) for pos in range(len(pattern))]
    stack += [_convert(layer, device, f"stack/remainder/{j}")
              for j, layer in enumerate(remainder)]
    out = {k: _convert(v, device, k) for k, v in tree.items() if k != "stack"}
    out["stack"] = stack
    return out
