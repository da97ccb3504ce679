"""Production-mesh dry run: count every (arch x shape x mesh) cell's step.

The port of ``repro.launch.dryrun``.  For each cell it opens PyTorch's fake
process group at the production mesh's size (``launch.mesh.fake_world``:
256 ranks single-pod, 512 multi-pod; collectives move nothing), builds the
mesh, places the model's abstract parameters, optimizer state, batch and
caches as DTensors of ``meta`` tensors (each rank's shard, no memory), and
runs one train, prefill or decode step (``pos = seq_len - 1``) under
``roofline.op_cost``'s counter, which counts rank 0's local ops, their
collectives and its live bytes.  That the step runs proves the sharding
rules are coherent; the counted bytes say whether it fits; the counts
feed the roofline table (``roofline.analysis``).

The model is built with ``use_kernel=True``, so a cell counts the step
that ``Trainer`` and ``ServingEngine`` run on the card: attention in K3,
the WKV recurrence in K4 and the RG-LRU scan in K5, forward and backward,
each on the rank's local shards under the mesh.  On meta tensors a kernel
wrapper launches nothing: it allocates what its launch would (results,
saved statistics, scratch and workspaces, so the peak holds them) and
reports the launch (``op_cost.kernel_launch``: its operands read once,
its results written once, its own flops).  The plain versions' per-step
states and score-sized intermediates, which no card runs, are not
counted; ``count_cell(..., kernel=False)`` still counts them, for tests.

A cell's keys are the reference's; in the port they mean:

* ``lower_s``: seconds to build and place the abstract state;
* ``compile_s``: seconds of the counted step (there is nothing to compile);
* ``memory``, per card (rank 0's shards): ``argument_bytes_per_chip`` the
  step's arguments; ``output_bytes_per_chip`` its results;
  ``alias_bytes_per_chip`` the results that are argument storages the
  step updated in place (the caches of prefill and decode; the
  parameters and the optimizer state of the train step, which is
  counted donated, ``make_train_step(donate=True)``, as the reference
  compiles it with ``donate_argnums=(0, 1)``: its outputs beyond them are
  the metrics' scalars); ``temp_bytes_per_chip`` the peak of the live
  bytes beyond arguments and fresh results; ``peak_estimate_per_chip``
  argument + output + temp - alias, which is the counted peak.  The train
  step's peak holds the gradient accumulator and a microbatch's
  activations;
* ``roofline``: ``analysis.Roofline.as_dict()`` of the counted cost;
* ``model_flops_global`` and ``useful_flops_ratio``: 6 N D (train) or
  2 N D (inference) over the counted FLOPs of all ranks.

A train step of k > 2 microbatches runs its first two, and the second's
cost counts k - 2 more times (``_two_microbatches_only``): the
microbatches have one shape, and from the second on each runs the same
ops (the first may also meet DTensor's caches cold, whose misses run
ops of their own), so this is the reference's trip-count multiplier of
its accumulation loop, exact against the whole count (tests).  Run whole,
llama-3.2-vision-90b's train cell (100 layers, 16 microbatches) took more
than five minutes on the CPU.  The memory peak is the two microbatches',
with the gradient accumulator live.

Usage (the whole table, 80 cells, as the reference's CLI defaults to):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh both --device cpu --out experiments/torch_dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from .._tree import leaves, unflatten
from ..configs import SHAPES, cell_is_applicable, get_config, list_archs
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import ShardingRules, make_rules, use_rules
from ..models.model import _placement_leaves, build_model, param_shardings
from ..roofline.analysis import analyze, model_flops_infer, model_flops_train
from ..roofline.op_cost import Cost, OpCounter
from ..train import train_step as train_step_module
from ..train.optimizer import init_opt_state, opt_state_shardings
from ..train.train_step import make_decode_step, make_prefill_step, make_train_step
from .mesh import fake_world, make_production_mesh

DEFAULT_OUT = "experiments/torch_dryrun.json"


def _mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _data_parallel(size: dict[str, int]) -> int:
    return size.get("pod", 1) * size.get("data", 1)


def cell_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> ShardingRules:
    size = _mesh_sizes(mesh)
    model_size = size["model"]
    dp = _data_parallel(size)
    shard_heads = cfg.num_heads > 0 and cfg.num_heads % model_size == 0
    rules = make_rules(mesh, fsdp=cfg.fsdp, shard_heads=shard_heads)
    r = dict(rules.rules)
    r["qheads"] = "model" if shard_heads else None
    r["lru"] = "model"
    r["lru_blocks"] = "model"
    r["rwkv_ffn"] = "model"
    r["zero"] = "data"
    # batch shardability per shape
    b = shape.global_batch
    if shape.kind == "train" and cfg.microbatches > 1:
        b = b // cfg.microbatches
    if b % dp != 0:
        # cannot shard batch (e.g. long_500k B=1): replicate batch, shard the
        # KV sequence over every axis instead
        r["batch"] = None
        r["kv_seq"] = tuple(a for a in ("pod", "data", "model") if a in size)
    return ShardingRules(mesh=mesh, rules=r)


def batch_shardings(specs: dict, rules: ShardingRules) -> dict:
    out = {}
    for name, s in specs.items():
        if name in ("tokens", "labels"):
            out[name] = rules.sharding("batch", *([None] * (len(s.shape) - 1)))
        else:  # frames / vision
            out[name] = rules.sharding("batch", None, None)
    return out


_CACHE_AXES = {
    "k": ("batch", "kv_seq", None, None), "v": ("batch", "kv_seq", None, None),
    "ckv": ("batch", "kv_seq", None), "kr": ("batch", "kv_seq", None),
    "xk": ("batch", None, None, None), "xv": ("batch", None, None, None),
    "h": ("batch", "lru"), "conv": ("batch", None, "lru"),
    "x_tm": ("batch", None), "x_cm": ("batch", None),
    "s": ("batch", None, None, None),
}


def cache_shardings(cache_specs: list[dict], rules: ShardingRules) -> list[dict]:
    """Placements of the per-layer caches (the port's stack is a list of
    layers, so no leaf has a stacked leading axis)."""
    return [{name: rules.sharding(*_CACHE_AXES.get(name, (None,) * x.ndim))
             for name, x in layer.items()} for layer in cache_specs]


def capped_config(cfg: ModelConfig, shape: ShapeConfig, mesh) -> ModelConfig:
    """Keep each microbatch shardable across the (pod, data) axes, as the
    reference does: otherwise the batch silently replicates."""
    if shape.kind == "train" and cfg.microbatches > 1:
        dp = _data_parallel(_mesh_sizes(mesh))
        mb = max(min(cfg.microbatches, shape.global_batch // dp), 1)
        if mb != cfg.microbatches:
            cfg = dataclasses.replace(cfg, microbatches=mb)
    return cfg


def _placed(tree, shardings, mesh):
    """``tree``'s meta leaves as DTensors with ``shardings``' placements,
    each local shard a storage of its own (rank 0's shard)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def leaf(x, pl):
        local, _ = compute_local_shape_and_global_offset(x.shape, mesh, pl)
        return DTensor.from_local(torch.empty(local, dtype=x.dtype, device="meta"),
                                  mesh, pl, run_check=False, shape=x.shape,
                                  stride=torch.empty(x.shape, device="meta").stride())
    return unflatten(tree, [leaf(x, pl) for x, pl in
                            zip(leaves(tree), _placement_leaves(tree, shardings))])


@contextlib.contextmanager
def _two_microbatches_only(counter: OpCounter, k: int):
    """Within: a train step runs only the first two of its ``k`` > 2
    microbatches.  On exit the second's cost is added ``k - 2`` more times:
    the second is what each further microbatch costs.
    This rebinds ``train_step._split_microbatches`` for the process, so one
    cell is counted at a time."""
    split = train_step_module._split_microbatches
    one = Cost()

    def first_two(batch, n):
        parts = split(batch, n)
        yield parts[0]
        before = Cost()
        before.add(counter.cost)
        yield parts[1]
        one.add(counter.cost)
        one.add(before, -1.0)

    train_step_module._split_microbatches = first_two
    try:
        yield
    finally:
        train_step_module._split_microbatches = split
    counter.cost.add(one, k - 2)


def _memory(counter, args, out, arg_bytes: int) -> dict:
    arg_ids = counter.storage_ids(args)
    out_ids = counter.storage_ids(out)
    output = sum(out_ids.values())
    alias = sum(n for k, n in out_ids.items() if k in arg_ids)
    temp = max(counter.peak - arg_bytes - (output - alias), 0)
    return {
        "argument_bytes_per_chip": arg_bytes,
        "output_bytes_per_chip": output,
        "temp_bytes_per_chip": temp,
        "alias_bytes_per_chip": alias,
        "peak_estimate_per_chip": arg_bytes + output + temp - alias,
    }


def _count_step(cfg: ModelConfig, shape: ShapeConfig, mesh, whole: bool = False,
                kernel: bool = True):
    """Place ``cfg``'s abstract state and count one step: (cost, memory,
    seconds placing, seconds counting).  A train step of k > 2
    microbatches runs two and counts the second k - 2 more times unless
    ``whole``.  ``kernel=False`` counts the plain versions in place of
    the kernels."""
    t0 = time.time()
    rules = cell_rules(cfg, shape, mesh)
    model = build_model(cfg, max_pos=shape.seq_len, device=mesh.device_type,
                        use_kernel=kernel)
    with use_rules(rules):
        params_abs = model.abstract_params()
        p_sh = param_shardings(cfg, params_abs, rules)
        params = _placed(params_abs, p_sh, mesh)
        if shape.kind == "train":
            o_sh = opt_state_shardings(p_sh, rules, params_abs)
            opt = _placed(init_opt_state(params_abs), o_sh, mesh)
            batch_abs = model.input_specs(shape)
            batch = _placed(batch_abs, batch_shardings(batch_abs, rules), mesh)
            step, args = make_train_step(model, donate=True), (params, opt, batch)
        elif shape.kind == "prefill":
            cache_abs = model.cache_specs(shape)
            caches = _placed(cache_abs, cache_shardings(cache_abs, rules), mesh)
            batch_abs = model.input_specs(shape)
            batch = _placed(batch_abs, batch_shardings(batch_abs, rules), mesh)
            step, args = make_prefill_step(model), (params, batch, caches)
        else:  # decode
            cache_abs = model.cache_specs(shape)
            caches = _placed(cache_abs, cache_shardings(cache_abs, rules), mesh)
            tok_abs = {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                             device="meta")}
            tokens = _placed(tok_abs, {"tokens": rules.sharding("batch", None)},
                             mesh)["tokens"]
            step = make_decode_step(model)
            args = (params, tokens, shape.seq_len - 1, caches)

        t_lower = time.time() - t0
        counter = OpCounter()
        arg_bytes = counter.track(args)
        k = cfg.microbatches if shape.kind == "train" and not whole else 1
        with counter, (_two_microbatches_only(counter, k) if k > 2
                       else contextlib.nullcontext()):
            out = step(*args)
        t_compile = time.time() - t0 - t_lower
        return counter.cost, _memory(counter, args, out, arg_bytes), t_lower, t_compile


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, kernel: bool = True) -> dict:
    """Count one step of ``cfg`` at ``shape`` on ``mesh`` (under an open
    process group of the mesh's size): the result's keys from ``chips`` on.
    The kernel path unless ``kernel=False``.

    A prefill or decode stack of more than four repeats of its layer
    pattern is counted at three and at four repeats (with its remainder
    layers) and extrapolated to its depth: the first and the last layer
    differ from the others (the placements they meet), the middle ones cost
    the same, so the two counts differ by one middle repeat (exact against
    the whole count, tests).  A train step is counted whole: its peak is not
    linear in depth.  It lies in the backward of a layer at small depths and
    moves to the gradients' accumulation at full depth (minicpm3-4b), so no
    count at a few repeats predicts it.  Where a stack has more than four
    repeats, a first count of three is thrown away: it warms DTensor's
    caches, whose misses run ops of their own, as a training loop's first
    step does."""
    period = len(cfg.pattern)
    reps, rem = divmod(cfg.num_layers, period)
    if reps > 4:
        three = dataclasses.replace(cfg, num_layers=3 * period + rem)
        _count_step(three, shape, mesh, kernel=kernel)
    if reps > 4 and shape.kind != "train":
        c3, m3, l3, s3 = _count_step(three, shape, mesh, kernel=kernel)
        c4, m4, l4, s4 = _count_step(dataclasses.replace(cfg, num_layers=4 * period + rem),
                                     shape, mesh, kernel=kernel)
        cost = Cost()
        cost.add(c3)
        cost.add(c4, reps - 3)
        cost.add(c3, -(reps - 3))
        memory = {k: m3[k] + (reps - 3) * (m4[k] - m3[k]) for k in m3}
        t_lower, t_compile = l3 + l4, s3 + s4
    else:
        cost, memory, t_lower, t_compile = _count_step(cfg, shape, mesh, kernel=kernel)

    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mf = (model_flops_train if shape.kind == "train" else model_flops_infer)(
        cfg.active_params(), tokens)
    roof = analyze(cost)
    n_chips = mesh.size()
    flops_global = roof.flops * n_chips
    return {
        "chips": n_chips,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "memory": memory,
        "roofline": roof.as_dict(),
        "model_flops_global": mf,
        "useful_flops_ratio": mf / flops_global if flops_global else 0.0,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, device=None) -> dict:
    """One cell, in a fake process group of its own (``device`` is the
    mesh's device type: ``cuda`` unless the caller names another)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": why}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        return {"status": "ok", "mesh": "multi_pod" if multi_pod else "single_pod",
                **count_cell(capped_config(cfg, shape, mesh), shape, mesh)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default cuda; cpu for the CPU)")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = {}
    if out_path.exists() and not args.force:
        results = json.loads(out_path.read_text())

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
                if key in results and results[key].get("status") in ("ok", "skipped") \
                        and not args.force:
                    print(f"[cached] {key}")
                    continue
                print(f"[run]    {key} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mp, device=args.device)
                except Exception as e:  # noqa: BLE001 — record and continue
                    res = {"status": "error", "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                results[key] = res
                out_path.write_text(json.dumps(results, indent=1))
                status = res.get("status")
                extra = ""
                if status == "ok":
                    r = res["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" t=({r['t_compute_s']:.2e},{r['t_memory_s']:.2e},"
                             f"{r['t_collective_s']:.2e})s"
                             f" mem={res['memory']['peak_estimate_per_chip']/2**30:.2f}GiB")
                elif status == "error":
                    extra = " " + res["error"][:160]
                print(f"[done]   {key}: {status}{extra}", flush=True)

    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_skip = sum(1 for r in results.values() if r.get("status") == "skipped")
    n_err = sum(1 for r in results.values() if r.get("status") == "error")
    print(f"\ntotal: {len(results)} cells — ok={n_ok} skipped={n_skip} errors={n_err}")


if __name__ == "__main__":
    main()
