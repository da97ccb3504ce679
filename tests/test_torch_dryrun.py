"""The port's production-mesh dry run (``repro_torch.launch.dryrun``) held
against the JAX package's (``repro.launch.dryrun``).

Two processes of their own, started together and waited for with a time
limit: one holds PyTorch's fake process group (``python
tests/test_torch_dryrun.py fakepg DIR``) and counts the twin of
``tests/distributed_checks.py``'s ``check_dryrun_cell_small_mesh`` and one
full-width production cell; the other has 512 JAX host devices (``...
jax DIR``) and gives the reference's sharding rules, batch shardings and
cache shardings of every arch x shape on both production meshes.  The
port's side of that comparison reads only the mesh's names and sizes, so
it runs here.  Last, the committed ``experiments/torch_dryrun.json`` is
checked as ``tests/test_system.py`` checks the reference's.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import time
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIME_LIMIT_S = 240
ARCHS = ["gemma3-1b", "llama-3.2-vision-90b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
         "qwen2-0.5b", "qwen2-1.5b", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
         "rwkv6-3b", "whisper-base"]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = {False: (("data", "model"), (16, 16)),
          True: (("pod", "data", "model"), (2, 16, 16))}


def _norm(spec, nd):
    spec = tuple(spec) + (None,) * (nd - len(spec))
    return [list(s) if isinstance(s, tuple) else s for s in spec]


def _table(rules):
    return {k: list(v) if isinstance(v, tuple) else v for k, v in rules.items()}


# -- the JAX side: 512 host devices -------------------------------------------

def _jax_main(out):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))
    import jax

    from repro.configs import SHAPES, get_config
    from repro.launch.dryrun import batch_shardings, cache_shardings, cell_rules
    from repro.launch.mesh import make_production_mesh
    from repro.models.model import build_model

    res = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in ARCHS:
            for name in SHAPE_NAMES:
                shape, cfg = SHAPES[name], get_config(arch)
                # the reference's run_cell caps the microbatches so
                if shape.kind == "train" and cfg.microbatches > 1:
                    dp = mesh.size // mesh.shape["model"]
                    mb = max(min(cfg.microbatches, shape.global_batch // dp), 1)
                    if mb != cfg.microbatches:
                        cfg = dataclasses.replace(cfg, microbatches=mb)
                rules = cell_rules(cfg, shape, mesh)
                model = build_model(cfg, max_pos=shape.seq_len)
                batch = model.input_specs(shape)
                caches = model.cache_specs(shape)
                c_leaves = jax.tree_util.tree_flatten_with_path(caches)[0]
                c_sh = jax.tree.leaves(cache_shardings(caches, rules))
                res[f"{arch}|{name}|{multi}"] = {
                    "microbatches": cfg.microbatches, "rules": _table(rules.rules),
                    "batch": {k: _norm(s.spec, len(batch[k].shape))
                              for k, s in batch_shardings(batch, rules).items()},
                    "caches": [[str(path[-1].key), _norm(s.spec, len(leaf.shape))]
                               for (path, leaf), s in zip(c_leaves, c_sh)]}
    pathlib.Path(out, "jax.json").write_text(json.dumps(res))


# -- the fake process group ------------------------------------------------------

def _fakepg_main(out):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import SHAPES, get_config, reduce_config
    from repro_torch.launch.dryrun import _count_step, cell_rules, count_cell, run_cell
    from repro_torch.launch.mesh import fake_world, make_debug_mesh
    from repro_torch.models.model import build_model, param_shardings
    from repro_torch.train import train_step

    res = {}
    cfg = dataclasses.replace(reduce_config(get_config("qwen2-0.5b")), dtype="bfloat16")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
    with fake_world(8):
        mesh = make_debug_mesh(2, 4, device="cpu")
        res["small"] = count_cell(cfg, shape, mesh)

        # two microbatches under FSDP: the accumulated gradient keeps the
        # parameters' placements (each rank sums its own shard)
        cfg_mb = dataclasses.replace(cfg, microbatches=2, fsdp=True)
        rules = cell_rules(cfg_mb, shape, mesh)
        want = param_shardings(cfg_mb, build_model(cfg_mb, device="cpu").abstract_params(),
                               rules)
        seen = []
        update = train_step.adamw_update

        def spy(c, grads, opt_state, **kw):
            from repro_torch._tree import leaves
            seen.extend(str(tuple(g.placements)) if hasattr(g, "placements") else "plain"
                        for g in leaves(grads))
            return update(c, grads, opt_state, **kw)
        train_step.adamw_update = spy
        try:
            count_cell(cfg_mb, shape, mesh)
        finally:
            train_step.adamw_update = update
        from repro_torch.models.model import _placement_leaves
        res["grad_placements"] = seen
        res["param_placements"] = [str(tuple(pl)) for pl in _placement_leaves(
            build_model(cfg_mb, device="cpu").abstract_params(), want)]
        # six layers of a prefill: counted at three and four and
        # extrapolated, against the whole stack counted with DTensor's caches
        # as warm; a train step of six layers is counted whole.  Each on the
        # kernel path (the dry run's) and on the plain path
        six = dataclasses.replace(cfg, num_layers=6)
        prefill = dataclasses.replace(SHAPES["prefill_32k"], seq_len=64, global_batch=8)
        cfg4 = dataclasses.replace(cfg, microbatches=4)
        shape16 = dataclasses.replace(shape, global_batch=16)
        for path, kernel in (("kernel", True), ("plain", False)):
            res[path] = run = {}
            run["extrapolated"] = count_cell(six, prefill, mesh, kernel=kernel)
            cost, memory, _, _ = _count_step(six, prefill, mesh, kernel=kernel)
            run["whole"] = {"flops": cost.flops, "bytes": cost.bytes,
                            "coll": dict(cost.coll), "memory": memory}
            run["train_six"] = count_cell(six, shape, mesh, kernel=kernel)
            cost, memory, _, _ = _count_step(six, shape, mesh, kernel=kernel)
            run["train_six_whole"] = {"flops": cost.flops, "bytes": cost.bytes,
                                      "coll": dict(cost.coll), "memory": memory}
            # four microbatches: two run, the second counted twice more,
            # against all four counted (DTensor's caches warmed by a first
            # count)
            _count_step(cfg4, shape16, mesh, kernel=kernel)
            for name, whole in (("multiplied", False), ("all_microbatches", True)):
                cost, memory, _, _ = _count_step(cfg4, shape16, mesh, whole=whole,
                                                 kernel=kernel)
                run[name] = {"flops": cost.flops, "bytes": cost.bytes,
                             "coll": dict(cost.coll), "memory": memory}
    res["production"] = run_cell("qwen2-0.5b", "train_4k", False, device="cpu")
    pathlib.Path(out, "fakepg.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, __file__, side, str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for side in ("jax", "fakepg")]
    deadline = time.monotonic() + TIME_LIMIT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a process ran past {TIME_LIMIT_S} s and was killed")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return types.SimpleNamespace(jax=json.loads((d / "jax.json").read_text()),
                                 fake=json.loads((d / "fakepg.json").read_text()))


# -- the cells ---------------------------------------------------------------------

REF_KEYS = {"status", "mesh", "chips", "lower_s", "compile_s", "memory", "roofline",
            "model_flops_global", "useful_flops_ratio"}
MEMORY_KEYS = {"argument_bytes_per_chip", "output_bytes_per_chip", "temp_bytes_per_chip",
               "alias_bytes_per_chip", "peak_estimate_per_chip"}


def test_small_mesh_cell(sides):
    """The twin of ``check_dryrun_cell_small_mesh``: reduced qwen2-0.5b in
    bf16, train_4k cut to 8 x 64, on the (2, 4) debug mesh."""
    got = sides.fake["small"]
    assert got["chips"] == 8
    assert got["memory"]["temp_bytes_per_chip"] > 0
    assert got["roofline"]["flops_per_chip"] > 0
    assert set(got["memory"]) == MEMORY_KEYS


def test_gradient_accumulates_on_the_parameters_shards(sides):
    """Over each mesh dim that shards a parameter, its accumulated gradient
    is sharded the same way: no rank holds more of a gradient than of its
    parameter (over a dim that replicates the parameter DTensor may keep a
    partial sum or shard the sum)."""
    got, want = sides.fake["grad_placements"], sides.fake["param_placements"]
    assert len(got) == len(want) > 10
    assert sum("Shard" in p for p in want) > 10
    for g, p in zip(got, want):
        for gm, pm in zip(re.findall(r"\w+\([^()]*\)", g), re.findall(r"\w+\([^()]*\)", p)):
            assert gm == pm or pm == "Replicate()", (g, p)


PATHS = ["kernel", "plain"]


@pytest.mark.parametrize("path", PATHS)
def test_depth_extrapolation_is_the_whole_count(sides, path):
    """A prefill stack of six layers counted at three and four and
    extrapolated gives the whole stack's FLOPs, bytes, collectives and
    memory, on the kernel path (K3's records in the count) and on the
    plain path."""
    got, want = sides.fake[path]["extrapolated"], sides.fake[path]["whole"]
    roof = got["roofline"]
    assert roof["flops_per_chip"] == want["flops"]
    assert roof["hbm_bytes_per_chip"] == want["bytes"]
    assert roof["coll_by_kind"] == pytest.approx(want["coll"], rel=1e-12)
    assert got["memory"] == want["memory"]


@pytest.mark.parametrize("path", PATHS)
def test_train_step_is_counted_whole(sides, path):
    """A train step's peak is not linear in depth, so a train cell counts
    the whole stack (after a warm-up count): the whole count's FLOPs,
    bytes, collectives and memory, on either path."""
    got, want = sides.fake[path]["train_six"], sides.fake[path]["train_six_whole"]
    roof = got["roofline"]
    assert roof["flops_per_chip"] == want["flops"]
    assert roof["hbm_bytes_per_chip"] == want["bytes"]
    assert roof["coll_by_kind"] == pytest.approx(want["coll"], rel=1e-12)
    assert got["memory"] == want["memory"]


@pytest.mark.parametrize("path", PATHS)
def test_microbatch_multiplier_is_the_whole_count(sides, path):
    """Four microbatches on the (2, 4) mesh: two run and the second counted
    twice more give all four's FLOPs, bytes, collectives and memory, on
    either path (on the kernel path K3's records are multiplied with the
    rest)."""
    got, want = sides.fake[path]["multiplied"], sides.fake[path]["all_microbatches"]
    assert got["flops"] == want["flops"]
    assert got["bytes"] == want["bytes"]
    assert got["coll"] == pytest.approx(want["coll"], rel=1e-12)
    assert got["memory"] == want["memory"]


def _local_bytes(shape, spec, sizes, itemsize):
    n = itemsize
    for dim, entry in zip(shape, spec):
        names = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        split = 1
        for name in names:
            split *= sizes[name]
        n *= -(-dim // split)          # rank 0's shard: the ceiling
    return n


def test_production_cell_argument_bytes(sides):
    """qwen2-0.5b|train_4k|single: ``ok``, and the argument bytes a card are
    the local shards of the parameters, the optimizer state and the batch,
    counted here from the specs; the aliased bytes are the parameters and
    the optimizer state (the step is donated)."""
    from repro_torch._tree import leaves
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import spec_of
    from repro_torch.launch.dryrun import batch_shardings, capped_config, cell_rules
    from repro_torch.models.model import _placement_leaves, build_model, param_shardings
    from repro_torch.train.optimizer import opt_state_shardings

    got = sides.fake["production"]
    assert got["status"] == "ok" and set(got) == REF_KEYS
    assert got["chips"] == 256 and got["mesh"] == "single_pod"
    names, sizes = MESHES[False]
    mesh = types.SimpleNamespace(mesh_dim_names=names, shape=sizes, ndim=2)
    shape = SHAPES["train_4k"]
    cfg = capped_config(get_config("qwen2-0.5b"), shape, mesh)
    rules = cell_rules(cfg, shape, mesh)
    model = build_model(cfg, device="cpu")
    params = model.abstract_params()
    p_sh = param_shardings(cfg, params, rules)
    o_sh = opt_state_shardings(p_sh, rules, params)
    batch = model.input_specs(shape)
    size = dict(zip(names, sizes))

    def tree_bytes(tree, sh, itemsize=None):
        return sum(_local_bytes(x.shape, spec_of(mesh, pl, x.ndim), size,
                                itemsize or x.element_size())
                   for x, pl in zip(leaves(tree), _placement_leaves(tree, sh)))
    donated = tree_bytes(params, p_sh) + 3 * tree_bytes(params, o_sh["master"], 4) + 4
    want = donated + tree_bytes(batch, batch_shardings(batch, rules))
    assert got["memory"]["argument_bytes_per_chip"] == want
    # the step is donated, as the reference's: its params and optimizer
    # state come back in their own storages, and its only other outputs are
    # the metrics' four f32 scalars (loss, ce, grad_norm, lr)
    assert got["memory"]["alias_bytes_per_chip"] == donated
    assert got["memory"]["output_bytes_per_chip"] == donated + 4 * 4
    mem = got["memory"]
    assert mem["peak_estimate_per_chip"] == (mem["argument_bytes_per_chip"]
                                             + mem["output_bytes_per_chip"]
                                             + mem["temp_bytes_per_chip"]
                                             - mem["alias_bytes_per_chip"])
    assert 0 < got["useful_flops_ratio"] < 1


# -- the sharding tables against the reference -------------------------------------

def _port_side(arch, name, multi):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import spec_of
    from repro_torch.launch.dryrun import (batch_shardings, cache_shardings, capped_config,
                                           cell_rules)
    from repro_torch.models.model import build_model

    names, sizes = MESHES[multi]
    mesh = types.SimpleNamespace(mesh_dim_names=names, shape=sizes, ndim=len(names))
    shape = SHAPES[name]
    cfg = capped_config(get_config(arch), shape, mesh)
    rules = cell_rules(cfg, shape, mesh)
    model = build_model(cfg, max_pos=shape.seq_len, device="cpu")
    batch = model.input_specs(shape)
    caches = model.cache_specs(shape)
    return {
        "microbatches": cfg.microbatches, "rules": _table(rules.rules),
        "batch": {k: _norm(spec_of(mesh, pl, batch[k].ndim), batch[k].ndim)
                  for k, pl in batch_shardings(batch, rules).items()},
        "caches": [[k, _norm(spec_of(mesh, pl, layer[k].ndim), layer[k].ndim)]
                   for layer, sh in zip(caches, cache_shardings(caches, rules))
                   for k, pl in sh.items()]}


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_shardings_equal_the_reference(sides, arch, multi):
    """``cell_rules``, ``batch_shardings`` and ``cache_shardings`` as
    PartitionSpec tuples, for every shape.  The reference stacks layers of
    one kind into a leaf with leading layer axes (replicated); the port's
    caches are per layer, so each cache leaf's spec is compared past
    them."""
    for name in SHAPE_NAMES:
        want = sides.jax[f"{arch}|{name}|{multi}"]
        got = _port_side(arch, name, multi)
        assert got["microbatches"] == want["microbatches"]
        assert got["rules"] == want["rules"]
        assert got["batch"] == want["batch"]
        port = {}
        for k, spec in got["caches"]:
            port.setdefault(k, set()).add(json.dumps(spec))
        ref = {}
        for k, spec in want["caches"]:
            nd = len(json.loads(next(iter(port[k]))))
            assert all(s is None for s in spec[:-nd])
            ref.setdefault(k, set()).add(json.dumps(spec[-nd:]))
        assert port == ref


def test_long_500k_skips_are_the_reference(monkeypatch):
    """The seven pure full-attention configurations skip long_500k with the
    reference's reason, before any process group opens."""
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import cell_is_applicable as ref_applicable
    from repro.configs import get_config as ref_config
    from repro_torch.configs import SHAPES, cell_is_applicable, get_config
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "fake_world", None)      # no cell may run here
    skipped = {}
    for arch in ARCHS:
        ok, why = ref_applicable(ref_config(arch), REF_SHAPES["long_500k"])
        if not ok:
            skipped[arch] = why
            for multi in (False, True):
                assert dryrun.run_cell(arch, "long_500k", multi) == {
                    "status": "skipped", "reason": why}
        else:
            assert cell_is_applicable(get_config(arch), SHAPES["long_500k"])[0]
    assert len(skipped) == 7


def test_dryrun_results_present_and_clean():
    """The committed table is one ``--mesh both`` run (the twin of
    ``test_dryrun_results_present_and_clean``): all 80 cells, each mesh's
    40 with no errors, 33 ``ok`` and the seven ``long_500k`` cells skipped
    with the port's (the reference's) reason.  Every train cell's counted
    peak is under 80 GiB (F9: no rank holds its rows' logits over the
    whole vocab) and every train cell counts the donated step (F11).  The
    cells count the kernel path (F14): rwkv6-3b's ``train_4k`` moves at
    most 1.9e14 B a card, where the plain recurrence's per-step states
    made 9.56e14."""
    from repro_torch.configs import SHAPES, cell_is_applicable, get_config

    d = json.loads((ROOT / "experiments" / "torch_dryrun.json").read_text())
    assert len(d) == 80
    for mesh, chips in (("single", 256), ("multi", 512)):
        cells = {k: v for k, v in d.items() if k.endswith(f"|{mesh}")}
        assert len(cells) == 40
        assert all(v["status"] in ("ok", "skipped") for v in cells.values()), \
            {k: v.get("error") for k, v in cells.items() if v["status"] == "error"}
        ok = [v for v in cells.values() if v["status"] == "ok"]
        assert len(ok) == 33
        for key, v in cells.items():
            arch, shape, _ = key.split("|")
            applicable, why = cell_is_applicable(get_config(arch), SHAPES[shape])
            assert (v["status"] == "ok") == applicable, key
            if not applicable:
                assert shape == "long_500k" and v["reason"] == why, key
        for v in ok:
            assert set(v) == REF_KEYS and set(v["memory"]) == MEMORY_KEYS
            assert v["chips"] == chips and v["roofline"]["flops_per_chip"] > 0
    card = 80 * 2 ** 30
    train = {k: v["memory"] for k, v in d.items() if "|train_4k|" in k}
    assert len(train) == 20
    over = {k: m["peak_estimate_per_chip"] / 2 ** 30 for k, m in train.items()
            if m["peak_estimate_per_chip"] >= card}
    assert not over, over
    # the train step is counted donated: its params and optimizer state are
    # aliased, and beyond them it returns only the metrics' scalars
    for k, m in train.items():
        assert 0 < m["alias_bytes_per_chip"] < m["argument_bytes_per_chip"], k
        assert 0 < m["output_bytes_per_chip"] - m["alias_bytes_per_chip"] <= 64, k
    assert d["rwkv6-3b|train_4k|single"]["roofline"]["hbm_bytes_per_chip"] <= 1.9e14

if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(sys.argv[2])
    else:
        _fakepg_main(sys.argv[2])
