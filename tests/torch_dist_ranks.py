"""One rank of the port's distribution checks (``tests/test_torch_distributed.py``).

    python tests/torch_dist_ranks.py BACKEND RANK WORLD INIT_METHOD DIR

Every rank joins one ``torch.distributed`` group (gloo on the CPU, NCCL on
the card with one rank a card), runs the checks below on its own shards,
and writes what the test compares to ``DIR/rank<R>.pt``.  The inputs come
from ``DIR/inputs.pt``, written by the test before the ranks start.  This
file imports only the port (``repro_torch``); the test holds the results
against the JAX package.

Checks, as ``tests/distributed_checks.py`` has them:

  * train: one train step of the reduced qwen2-0.5b on a (2, 4) debug mesh
    with ``make_rules(fsdp=False, shard_heads=False)``, then with
    ``fsdp=True, shard_heads=True``; parameters placed by
    ``param_shardings``, the optimizer state by ``opt_state_shardings``, the
    batch over the data axis; rank 0 also runs the unsharded step;
  * forward: the loss of the reduced rwkv6-3b and recurrentgemma-9b,
    sharded against unsharded;
  * pipeline: ``pipelined_apply`` over the first 4 ranks, one ``tanh``
    layer a stage;
  * collectives: ``compressed_psum`` in its three modes and
    ``lse_combine`` over all ranks, ``ring_halo_exchange`` and
    ``reduce_scatter_then_all_gather``;
  * seq_parallel: ``seq_parallel_attention`` on a (2, 4) mesh at windows 0
    and 300, and each case in which it returns ``None``;
  * mla: MLA's absorbed attention with its query sequence sharded;
  * kernel_site: the kernel call site's head-shard wrapper
    (``attention._on_head_shards``) with ``shard_heads=True``, its per-shard
    piece K3's plain version, against the unsharded attention, forward and
    gradient;
  * ring: a prefill into a ring cache sharded over its slots
    (``attention._ring_write``) against the write into the whole ring.

The train check also runs the step with 2 microbatches (FSDP, heads
sharded) against the unsharded one, and, under both rule sets, two steps
of the donated step (``make_train_step(donate=True)``, F11): the
placements every leaf has after the first (they must be those it was
placed on), and the loss and parameters after the second.
"""
import dataclasses
import datetime
import pathlib
import sys
import time

import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch._tree import leaves, tree_map  # noqa: E402
from repro_torch.distributed import collectives, pipeline  # noqa: E402
from repro_torch.distributed.sharding import (is_dtensor, make_rules,  # noqa: E402
                                              use_rules)
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402

TIMEOUT_S = 120


def _full(x):
    return x.full_tensor() if is_dtensor(x) else x


def check_train(inp, dev, out):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models.model import build_model, param_shardings, place
    from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                             opt_state_shardings)
    from repro_torch.train.train_step import make_train_step

    # remat on: each layer's recomputation re-enters the rules (numbers as
    # without it)
    cfg = dataclasses.replace(reduce_config(get_config("qwen2-0.5b")), remat=True)
    model = build_model(cfg, max_pos=64, device=dev)
    params = _to(inp["params"], dev)
    batch = _to(inp["batch"], dev)
    step = make_train_step(model, AdamWConfig(lr=1e-2))
    if dist.get_rank() == 0:
        p1, _, m1 = step(params, init_opt_state(params), batch)
        out["train_single_loss"] = m1["loss"].cpu()
        out["train_single_leaves"] = [x.cpu() for x in leaves(p1)]

    mesh = make_debug_mesh(*inp["train_mesh"], device=dev)
    # the reference check's rules, then FSDP with the query heads sharded
    for tag, fsdp, heads in (("", False, False), ("fsdp_heads_", True, True)):
        rules = make_rules(mesh, fsdp=fsdp, shard_heads=heads)
        t0 = time.perf_counter()
        with use_rules(rules):
            p_sh = param_shardings(cfg, params, rules)
            params_s = place(params, p_sh, rules)
            opt_s = place(init_opt_state(params_s),
                          opt_state_shardings(p_sh, rules, params), rules)
            batch_s = {k: place(v, rules.sharding("batch", None), rules)
                       for k, v in batch.items()}
            p2, o2, m2 = step(params_s, opt_s, batch_s)
            loss = _full(m2["loss"])
            full = [_full(x).cpu() for x in leaves(p2)]
        out[f"train_{tag}seconds"] = time.perf_counter() - t0
        out[f"train_{tag}loss"] = loss.cpu()
        out[f"train_{tag}leaves"] = full
        out[f"train_{tag}param_placements"] = [str(tuple(x.placements))
                                               for x in leaves(params_s)]
        out[f"train_{tag}opt_placements"] = [str(tuple(x.placements))
                                             for x in leaves(opt_s["m"])]
        # F11: the donated step hands every leaf back on the placements it
        # was given; a second step runs from them
        donated = make_train_step(model, AdamWConfig(lr=1e-2), donate=True)
        with use_rules(rules):
            params_d = place(tree_map(torch.clone, params), p_sh, rules)
            opt_d = place(init_opt_state(params_d),
                          opt_state_shardings(p_sh, rules, params), rules)
            want = _placements(params_d, opt_d)
            p3, o3, _ = donated(params_d, opt_d, batch_s)
            out[f"donate_{tag}want"], out[f"donate_{tag}got"] = want, _placements(p3, o3)
            p3, _, m3 = donated(p3, o3, batch_s)
            out[f"donate_{tag}loss2"] = _full(m3["loss"]).cpu()
            out[f"donate_{tag}leaves2"] = [_full(x).cpu() for x in leaves(p3)]
        if fsdp:
            from repro_torch.models.transformer import _gather_fsdp
            with use_rules(rules):
                layer = _gather_fsdp(params_s["stack"][0])
            out["gather_fsdp"] = {path: str(tuple(x.placements)) for path, x in
                                  zip(("attn/wq", "mlp/w_down"),
                                      (layer["attn"]["wq"], layer["mlp"]["w_down"]))}

    # gradient accumulation over 2 microbatches: each rank accumulates its
    # own shard of the gradient
    step_mb = make_train_step(build_model(dataclasses.replace(cfg, microbatches=2),
                                          max_pos=64, device=dev), AdamWConfig(lr=1e-2))
    if dist.get_rank() == 0:
        p1, _, m1 = step_mb(params, init_opt_state(params), batch)
        out["train_mb_single_loss"] = m1["loss"].cpu()
        out["train_mb_single_leaves"] = [x.cpu() for x in leaves(p1)]
    rules = make_rules(mesh, fsdp=True, shard_heads=True)
    with use_rules(rules):
        p_sh = param_shardings(cfg, params, rules)
        params_s = place(params, p_sh, rules)
        opt_s = place(init_opt_state(params_s),
                      opt_state_shardings(p_sh, rules, params), rules)
        batch_s = {k: place(v, rules.sharding("batch", None), rules)
                   for k, v in batch.items()}
        p2, _, m2 = step_mb(params_s, opt_s, batch_s)
        out["train_mb_loss"] = _full(m2["loss"]).cpu()
        out["train_mb_leaves"] = [_full(x).cpu() for x in leaves(p2)]


def _placements(params, opt_state):
    """Each leaf's placements, as strings, by tree."""
    return {"params": [str(tuple(x.placements)) for x in leaves(params)],
            **{k: [str(tuple(x.placements)) for x in leaves(opt_state[k])]
               for k in ("master", "m", "v", "step")}}


def check_forward(inp, dev, out):
    """The loss of the reduced recurrent configurations, sharded against
    unsharded: the K4 and K5 call sites run on local shards."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models.model import build_model, param_shardings, place

    mesh = make_debug_mesh(*inp["train_mesh"], device=dev)
    rules = make_rules(mesh, fsdp=False, shard_heads=False)
    for arch in ("rwkv6-3b", "recurrentgemma-9b"):
        cfg = reduce_config(get_config(arch))
        model = build_model(cfg, max_pos=64, device=dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        batch = _to(inp["batch"], dev)
        loss, _ = model.loss_fn(params, batch)
        with use_rules(rules):
            params_s = place(params, param_shardings(cfg, params, rules), rules)
            batch_s = {k: place(v, rules.sharding("batch", None), rules)
                       for k, v in batch.items()}
            loss_s, _ = model.loss_fn(params_s, batch_s)
            loss_s = _full(loss_s)
        out[f"forward_{arch}"] = (loss.detach().cpu(), loss_s.detach().cpu())


def check_pipeline(inp, dev, out):
    group = dist.new_group(list(range(4)))
    if dist.get_rank() >= 4:
        return
    stage = dist.get_rank(group)
    w, x = inp["pipe_w"].to(dev), inp["pipe_x"].to(dev)
    out["pipeline"] = pipeline.pipelined_apply(
        lambda wi, xi: torch.tanh(xi @ wi[0]), w[stage:stage + 1], x, group=group).cpu()


def check_collectives(inp, dev, out):
    rank = dist.get_rank()
    for name, x, err in (("arange", inp["coll_arange"], None),
                         ("random", inp["coll_random"], inp["coll_error"])):
        local = x[rank:rank + 1].to(dev)
        e = None if err is None else err[rank:rank + 1].to(dev)
        for mode in ("none", "bf16", "int8"):
            r, new_err = collectives.compressed_psum(local, compression=mode, error_state=e)
            out[f"psum_{name}_{mode}"] = r.cpu()
            if mode == "int8":
                out[f"psum_{name}_int8_err"] = new_err.cpu()
    try:
        collectives.compressed_psum(inp["coll_arange"][:1], compression="fp4")
    except ValueError as exc:
        out["psum_unknown"] = str(exc)
    ll = inp["lse_logits"][rank:rank + 1].to(dev)
    vv = inp["lse_v"][rank:rank + 1].to(dev)
    m = ll.amax(dim=-1)
    e = torch.exp(ll - m[..., None])
    part = torch.einsum("bs,bsd->bd", e, vv)
    out["lse"] = collectives.lse_combine(part, m, e.sum(-1)).cpu()
    local = torch.arange(6, dtype=torch.float32, device=dev).reshape(3, 2) + 10 * rank
    up, down = collectives.ring_halo_exchange(local)
    out["halo"] = (up.cpu(), down.cpu())
    g = torch.Generator().manual_seed(rank)
    xs = torch.randn((2 * dist.get_world_size(), 3), generator=g).to(dev)
    out["rs_ag_in"] = xs.cpu()
    out["rs_ag"] = collectives.reduce_scatter_then_all_gather(xs, None, lambda s: 2 * s).cpu()


def check_seq_parallel(inp, dev, out):
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models.attention import seq_parallel_attention

    mesh = make_debug_mesh(2, 4, device=dev)
    rules = make_rules(mesh, fsdp=False, shard_heads=False)
    q, k, v = (inp[f"sp_{n}"].to(dev) for n in "qkv")
    with use_rules(rules):
        for window in (0, 300):
            o = seq_parallel_attention(q, k, v, pos_offset=0, window=window, rules=rules)
            out[f"sp_placements_{window}"] = str(tuple(o.placements))
            out[f"sp_{window}"] = o.full_tensor().cpu()
        # the output projection on the sequence shards, then gathered
        from repro_torch.models.attention import seq_shard_projection
        wo = inp["sp_wo"].to(dev)
        h = seq_shard_projection(o, wo)
        out["sp_projection"] = ((o.full_tensor() @ wo).cpu(), h.full_tensor().cpu(),
                                str(tuple(h.placements)))
    # the gradient through the shards: k and v are read whole by every
    # query shard, so theirs is summed over the shards
    from repro_torch.models.attention import chunked_attention
    from repro_torch.models.model import place
    leaves_ = [x.detach().requires_grad_(True) for x in (q, k, v)]
    do = inp["sp_do"].to(dev)
    want = torch.autograd.grad(chunked_attention(*leaves_, 0), leaves_, do)
    with use_rules(rules):
        o = seq_parallel_attention(*leaves_, pos_offset=0, window=0, rules=rules)
        got = torch.autograd.grad(o, leaves_, place(do, list(o.placements), rules))
    out["sp_grad"] = [(a.cpu(), b.cpu()) for a, b in zip(want, got)]
    flat = make_debug_mesh(8, 1, device=dev)
    none = {
        "no rules": seq_parallel_attention(q, k, v, pos_offset=0, window=0, rules=None),
        "heads shard": seq_parallel_attention(q, k, v, pos_offset=0, window=0,
                                              rules=make_rules(mesh, shard_heads=True)),
        "seq_q two dims": seq_parallel_attention(
            q, k, v, pos_offset=0, window=0,
            rules=ShardingRules(mesh, {**rules.rules, "seq_q": ("data", "model")})),
        "one shard": seq_parallel_attention(q, k, v, pos_offset=0, window=0,
                                            rules=make_rules(flat, shard_heads=False)),
        "T % n": seq_parallel_attention(q[:, :4094], k[:, :4094], v[:, :4094],
                                        pos_offset=0, window=0, rules=rules),
        "T/n % 128": seq_parallel_attention(q[:, :2400], k[:, :2400], v[:, :2400],
                                            pos_offset=0, window=0, rules=rules),
    }
    out["sp_none"] = {name: r is None for name, r in none.items()}


def check_mla(inp, dev, out):
    """MLA's absorbed attention over the latent, its query sequence sharded
    over the model dim (4 shards of 1024, multiples of 512), against the
    local form on the whole sequence."""
    from repro_torch.models.mla import _absorbed_chunked, _absorbed_chunked_local

    mesh = make_debug_mesh(2, 4, device=dev)
    rules = make_rules(mesh, fsdp=False, shard_heads=False)
    q_lat, q_rope, ckv, kr = (inp[f"mla_{n}"].to(dev) for n in ("q_lat", "q_rope", "ckv", "kr"))
    want = _absorbed_chunked_local(q_lat, q_rope, ckv, kr, 0, 0.25)
    with use_rules(rules):
        got = _absorbed_chunked(q_lat, q_rope, ckv, kr, 0, 0.25)
        out["mla_placements"] = str(tuple(got.placements))
        got = got.full_tensor()
    out["mla"] = (want.cpu(), got.cpu())


def check_kernel_site(inp, dev, out):
    from repro_torch.models.attention import _kernel_attention, _on_head_shards
    from repro_torch.models.model import place

    mesh = make_debug_mesh(2, 4, device=dev)
    rules = make_rules(mesh, fsdp=False, shard_heads=True)
    q, k, v = (inp[f"ks_{n}"].to(dev).requires_grad_(True) for n in "qkv")
    do = inp["ks_do"].to(dev)
    want = _kernel_attention(q, k, v, causal=True, q_offset=0)
    want_grads = torch.autograd.grad(want, (q, k, v), do)
    with use_rules(rules):
        qs = place(q, rules.sharding("batch", None, "heads", None), rules)
        ks = place(k, rules.sharding("batch", None, "kv_heads", None), rules)
        vs = place(v, rules.sharding("batch", None, "kv_heads", None), rules)
        got = _on_head_shards(lambda ql, kl, vl: _kernel_attention(
            ql, kl, vl, causal=True, q_offset=0), qs, ks, vs)
        out["kernel_site_placements"] = str(tuple(got.placements))
        # k and v's gradients are summed over the query-head shards
        grads = torch.autograd.grad(got, (q, k, v), place(do, list(got.placements), rules))
        got = got.full_tensor()
    out["kernel_site"] = (want.detach().cpu(), got.detach().cpu())
    out["kernel_site_grad"] = [(a.cpu(), b.cpu()) for a, b in zip(want_grads, grads)]


def check_ring(inp, dev, out):
    """A prefill into a "local" layer's ring cache sharded over its slots
    (``kv_seq`` over the model dim), on each rank's shard, against the same
    write into the whole ring: 24 positions from 0 (the last 16 kept, the
    ring wrapped) and 12 from position 10 (slots 10-15, then 0-5)."""
    from repro_torch.models.attention import _ring_write
    from repro_torch.models.model import place

    mesh = make_debug_mesh(2, 4, device=dev)
    rules = make_rules(mesh)
    for t, pos in ((24, 0), (12, 10)):
        x = inp["ring_x"][:, :t].to(dev)
        want = torch.full((2, 16, 2, 4), 7.0, device=dev)
        _ring_write(want, x, pos)
        with use_rules(rules):
            buf = place(torch.full((2, 16, 2, 4), 7.0, device=dev),
                        rules.sharding("batch", "kv_seq", None, None), rules)
            _ring_write(buf, place(x, rules.sharding("batch", None, None, None), rules),
                        pos)
            got = buf.full_tensor()
        out[f"ring_{t}_{pos}"] = (want.cpu(), got.cpu())

def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def main(backend, rank, world, init, outdir):
    outdir = pathlib.Path(outdir)
    dev = "cuda" if backend == "nccl" else "cpu"
    if dev == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    inp = torch.load(outdir / "inputs.pt", weights_only=False)
    out = {}
    try:
        for name in inp["checks"]:
            globals()[f"check_{name}"](inp, dev, out)
    finally:
        dist.destroy_process_group()
    torch.save(out, outdir / f"rank{rank}.pt")


if __name__ == "__main__":
    b, r, w, i, d = sys.argv[1:6]
    main(b, int(r), int(w), i, d)
