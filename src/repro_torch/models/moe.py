"""Mixture-of-Experts with capacity-bounded dispatch and locality-biased
routing.

The port of ``repro.models.moe``.  A router picks each token's top-k
experts; each expert takes at most ``cap`` (token, choice) pairs per token
group, in arrival order (token-major), and the overflow is dropped to the
residual path: the paper's bounded stealing.  ``_local_expert_bias`` is its
"local queue first" in logit space: a bias towards experts resident with
the token group.  It reads the size A of the mesh dim that the rules give
"experts" (1 without rules, where the bias is zero, as in the reference).
The batched form's expert inputs and outputs carry the reference's
``shard`` constraints (groups over the batch axes, experts over the model
axis), no-ops without rules.

The block is split into its four phases so that each can be timed alone:
``route`` (router product, softmax, top-k), ``dispatch`` (queue positions,
capacity), ``expert products`` and ``combine``.

Two dispatch forms, one function (divergence P12):

  * the batched product over the experts (prefill, and whenever a group's
    ``tokens * k`` exceeds the expert count): the reference's
    Switch-Transformer one-hot einsums, each expert running its ``cap``
    slots in one batched matmul;
  * the gather (decode: ``tokens * k <= E`` in every group): only the
    chosen experts' weights are read, one (d, f) slice per (token, choice).
    The reference's one-hot einsums read every expert's weights at every
    step (at qwen3-moe-30b-a3b's width 1.21 GB a layer, against 75.5 MB
    for the 8 chosen experts).  Dropped pairs weigh zero.  No value goes to
    the host.

Ties between equal gates (a bf16 router product makes them common) go to
the lowest expert index, as ``jax.lax.top_k`` breaks them: a stable
descending sort, not ``torch.topk``, which promises no order.  The expert
products are plain ``torch`` matmuls on every device: the reference
computes them as einsums outside any Pallas kernel, so no kernel is ported
here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import current_rules, is_dtensor, on_local_shards, shard
from .common import Params, _trunc_normal, dense_init

GROUP_TOKENS = 512   # dispatch/combine one-hots are O(T_g^2): keep T_g small


def moe_init(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype = torch.float32) -> Params:
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    return {
        "router": dense_init(gen, d, e, torch.float32),
        "w_gate": _trunc_normal(gen, (e, d, f), 1.0 / math.sqrt(d), dtype),
        "w_up": _trunc_normal(gen, (e, d, f), 1.0 / math.sqrt(d), dtype),
        "w_down": _trunc_normal(gen, (e, f, d), 1.0 / math.sqrt(f), dtype),
    }


def _local_expert_bias(num_groups: int, num_experts: int, bias: float,
                       device: torch.device | str | None = None) -> torch.Tensor:
    """(G, E) bias favoring experts co-resident with each token group.

    Group g's tokens live on expert-axis coordinate (g % A) when groups are
    laid out batch-major over a (data, model)-flattened device order;
    expert e lives on coordinate (e // (E/A)).  The bias is the paper's
    "local queue first" preference in logit space.  Zeros when A is 1 or
    does not divide E."""
    rules = current_rules()
    a = 1
    if rules is not None and rules.rules.get("experts") is not None:
        a = rules.axis_size(rules.rules["experts"])
    if a <= 1 or num_experts % a:
        return torch.zeros((num_groups, num_experts), dtype=torch.float32, device=device)
    per = num_experts // a
    g_coord = torch.arange(num_groups, device=device) % a
    e_coord = torch.arange(num_experts, device=device) // per
    return torch.where(g_coord[:, None] == e_coord[None, :], bias, 0.0).float()


def num_groups_for(b: int, t: int) -> int:
    """The reference's token groups: one per GROUP_TOKENS of each sequence."""
    return b * max(t // GROUP_TOKENS, 1)


def group(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """x (B, T, D) as (G, B*T/G, D).  The reference's ``reshape`` raises
    ``TypeError`` when G does not divide B*T (a prefill of 1025 tokens makes
    2 groups of 512): so does this (ROADMAP R5)."""
    b, t, d = x.shape
    per = (b * t) // num_groups
    if per * num_groups != b * t:
        raise TypeError(f"cannot reshape array of shape {(b, t, d)} into shape "
                        f"{(num_groups, per, d)}")
    if is_dtensor(x):
        # on each rank's rows (a rank's groups are its rows'): in the
        # backward DTensor reshapes the groups' gradient back to (B, T, D)
        # and mis-sizes a rank's rows when that gradient is split over more
        # mesh dims than the batch
        return on_local_shards(lambda xl: xl.reshape(num_groups * xl.shape[0] // b, per, d),
                               [(x, ("batch", None, None))], ("batch", None, None))
    return x.reshape(num_groups, per, d)


def route(p: Params, xg: torch.Tensor, cfg: ModelConfig):
    """Router and top-k: (gates (G,T,E) f32, topv (G,T,k) f32 normalised,
    topi (G,T,k)), ties to the lowest expert index."""
    m = cfg.moe
    g = xg.shape[0]
    logits = (xg @ p["router"].to(xg.dtype)).float()
    if m.locality_bias:
        logits = logits + _local_expert_bias(g, m.num_experts, m.locality_bias,
                                             xg.device)[:, None, :]
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :m.top_k], topi[..., :m.top_k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return gates, topv, topi


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``idx``'s one-hot rows of width ``n``, by comparison (``F.one_hot``
    checks its indices' range on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    return max(int(tokens * m.top_k / m.num_experts * m.capacity_factor), 1)


def dispatch(xg: torch.Tensor, topv: torch.Tensor, topi: torch.Tensor,
             cfg: ModelConfig) -> dict:
    """Queue positions, capacity and the experts' inputs.

    Each (token, choice) pair's position in its expert's queue is a
    cumulative sum over the pairs flattened token-major, as in the
    reference; a pair is kept when its position is below ``cap`` and its
    combine weight (``topv`` in the model's dtype) is non-zero (the
    reference's ``dispatch = combine > 0``).  Returns the plan the next
    phases read: ``onehot`` (G,T,k,E), ``weight`` (G,T,k), zero where
    dropped, the experts' inputs ``x``, and either ``idx`` (the gather: the
    expert of each of the G*T*k rows of ``x``) or ``combine`` (G,T,E,C) with
    ``x`` as (E, G*C, D), each expert's ``cap`` slots."""
    e = cfg.moe.num_experts
    g, tokens, d = xg.shape
    k = topi.shape[-1]
    cap = capacity(tokens, cfg)
    onehot = _one_hot(topi, e, torch.int32)                       # (G,T,k,E)
    pos = torch.cumsum(onehot.reshape(g, tokens * k, e), dim=1) - 1
    pos = (pos.reshape(g, tokens, k, e) * onehot).sum(-1)         # (G,T,k)
    weight = torch.where(pos < cap, topv, 0.0).to(xg.dtype)
    plan = {"onehot": onehot, "weight": weight}
    if tokens * k <= e:
        plan["idx"] = topi.reshape(-1)
        plan["x"] = xg.reshape(g * tokens, 1, d).expand(g * tokens, k, d).reshape(-1, 1, d)
        return plan
    slot = _one_hot(torch.clamp(pos, max=cap - 1), cap, xg.dtype)      # (G,T,k,C)
    combine = torch.einsum("gtke,gtkc->gtec", onehot.to(xg.dtype) * weight[..., None],
                           slot)                                         # (G,T,E,C)
    # (E, G, C, D), the reference's (G, E, C, D) with its first two axes
    # swapped by the einsum itself: DTensor turns a reshape of a permuted
    # DTensor into a view of each rank's shard, which cannot flatten it
    expert_in = torch.einsum("gtec,gtd->egcd", (combine > 0).to(xg.dtype), xg)
    expert_in = shard(expert_in, "experts", "batch", None, None)
    plan["combine"] = combine
    plan["x"] = expert_in.reshape(e, g * cap, d)
    return plan


def expert_products(p: Params, plan: dict) -> torch.Tensor:
    """The gated expert MLP on the dispatched rows: one batched matmul per
    weight, over the experts' slots or over the gathered (token, choice)
    rows, whose (d, f) weight slices are gathered on the device."""
    x = plan["x"]
    if "idx" in plan:
        idx = plan["idx"]
        w_gate, w_up, w_down = p["w_gate"][idx], p["w_up"][idx], p["w_down"][idx]
    else:
        w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up)
    return torch.bmm(h, w_down)


def combine(plan: dict, y: torch.Tensor) -> torch.Tensor:
    """Each token's kept choices' outputs, weighted: (G, T, D)."""
    weight = plan["weight"]
    g, tokens, k = weight.shape
    if "idx" in plan:
        return torch.einsum("gtk,gtkd->gtd", weight, y.reshape(g, tokens, k, -1))
    comb = plan["combine"]
    e, cap = comb.shape[2], comb.shape[3]
    expert_out = shard(y.reshape(e, g, cap, -1), "experts", "batch", None, None)
    return torch.einsum("gtec,egcd->gtd", comb, expert_out)


def moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
              num_groups: Optional[int] = None):
    """x: (B, T, D) -> (out, aux_loss).

    Tokens are grouped as (G, T', D), one group per GROUP_TOKENS tokens of
    each sequence; capacity and the load-balance loss are per group."""
    m = cfg.moe
    b, t, d = x.shape
    g = num_groups if num_groups is not None else num_groups_for(b, t)
    xg = group(x, g)

    gates, topv, topi = route(p, xg, cfg)
    plan = dispatch(xg, topv, topi, cfg)
    out = combine(plan, expert_products(p, plan))

    # load-balance aux loss (Switch): E * sum_e f_e * P_e, f_e the share of
    # the group's tokens dispatched to expert e
    kept = (plan["onehot"] * (plan["weight"] > 0)[..., None]).amax(dim=2)   # (G,T,E)
    density = kept.float().mean(dim=1)
    router_prob = gates.mean(dim=1)
    aux = (density * router_prob).sum(-1).mean() * m.num_experts * m.router_aux_weight
    if is_dtensor(out):
        # back to (B, T, D) on each rank's groups, as ``group`` made them
        return on_local_shards(lambda ol: ol.reshape(-1, t, d),
                               [(out, ("batch", None, None))], ("batch", None, None)), aux
    return out.reshape(b, t, d), aux
