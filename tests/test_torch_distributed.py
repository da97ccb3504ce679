"""The port's distribution (``repro_torch.distributed``, ``launch.mesh``, the
model's sharding names, ``seq_parallel_attention``) held against the JAX
package: the port's twin of ``tests/distributed_checks.py``'s first five
checks (the sixth, the dry-run cell, is E3b's).

Eight gloo ranks of ``tests/torch_dist_ranks.py`` run the multi-rank checks
(one process group, the CPU); one JAX process with 8 host devices computes
the reference's side (``python tests/test_torch_distributed.py jax DIR``),
and one more process builds the production meshes over the fake process
group (``... fakepg DIR``).  Every process is waited for with a time limit
and killed on overrun.  Inputs come from numpy seeds and the JAX package's
``init_params`` (carried across by ``params_from_jax``).

Limits are the reference check's: the sharded train step's loss to rtol
2e-5 and every leaf to atol 2e-4 (against the JAX single-device step and
against the port's own unsharded step; the donated step's second step
against two JAX steps, its placements exactly); the pipeline to 1e-5; "none" to
rtol 1e-6, "bf16" 2e-2, "int8" 8e-2/2.0 against numpy, and "int8" against
the JAX package's ``compressed_psum`` bit for bit (result and error state);
``lse_combine`` against the full softmax to 1e-5; ``seq_parallel_attention``
against the JAX package's ``banded_attention``/``chunked_attention`` to
2e-5.  Specs and shapes are compared exactly.
"""
import json
import os
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 8
TIME_LIMIT_S = 240
CHECKS = ("train", "forward", "pipeline", "collectives", "seq_parallel", "mla",
          "kernel_site", "ring")
RULE_SETS = ((False, True), (True, False))          # (fsdp, shard_heads)


# -- the JAX side (its own process, 8 host devices) -------------------------

def _jax_main(out):
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import SHAPES, get_config, list_archs, reduce_config
    from repro.distributed.collectives import compressed_psum
    from repro.distributed.sharding import make_rules, use_rules
    from repro.launch.mesh import make_debug_mesh
    from repro.models.model import build_model, param_shardings
    from repro.models.moe import _local_expert_bias
    from repro.train.optimizer import AdamWConfig, init_opt_state, opt_state_shardings
    from repro.train.train_step import make_train_step
    from repro_torch.configs import get_config as port_config
    from repro_torch.configs import reduce_config as port_reduce
    from repro_torch.models.model import build_model as port_build

    res = {}
    out = pathlib.Path(out)
    inp = torch.load(out / "inputs.pt", weights_only=False)

    # the single-device train step of the reference check
    cfg = reduce_config(get_config("qwen2-0.5b"))
    model = build_model(cfg, max_pos=64)
    params = model.init_params(jax.random.key(0))
    batch = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in inp["batch"].items()}
    step = jax.jit(make_train_step(model, AdamWConfig(lr=1e-2)))
    p1, o1, m1 = step(params, init_opt_state(params), batch)
    np.savez(out / "jax_step.npz", loss=np.asarray(m1["loss"]),
             **{f"leaf{i}": np.asarray(x, np.float32) for i, x in enumerate(jax.tree.leaves(p1))})
    # and a second step, the same batch again
    p2, _, m2 = step(p1, o1, batch)
    np.savez(out / "jax_step2.npz", loss=np.asarray(m2["loss"]),
             **{f"leaf{i}": np.asarray(x, np.float32) for i, x in enumerate(jax.tree.leaves(p2))})

    # compressed_psum on 8 devices, the inputs the ranks take
    mesh8 = jax.make_mesh((WORLD,), ("d",), axis_types=(jax.sharding.AxisType.Auto,))
    psum = {}
    for name, err_key in (("arange", None), ("random", "coll_error")):
        x = jnp.asarray(inp[f"coll_{name}"].numpy())
        e = None if err_key is None else jnp.asarray(inp[err_key].numpy())

        def inner(xl, el=None):
            return compressed_psum(xl, "d", compression="int8", error_state=el)
        specs = (P("d", None),) if e is None else (P("d", None), P("d", None))
        with jax.set_mesh(mesh8):
            r, err = jax.jit(jax.shard_map(inner, mesh=mesh8, in_specs=specs,
                                           out_specs=(P("d", None), P("d", None))))(
                *((x,) if e is None else (x, e)))
        psum[name] = (np.asarray(r), np.asarray(err))
    np.savez(out / "jax_psum.npz", **{f"{n}_{i}": a for n, pair in psum.items()
                                      for i, a in enumerate(pair)})

    # param_shardings / opt_state_shardings specs on a (2, 4) mesh, on the
    # reference's stacked tree and on the port's per-layer tree
    mesh = make_debug_mesh(2, 4)

    def norm(spec, nd):
        spec = tuple(spec) + (None,) * (nd - len(spec))
        return [list(s) if isinstance(s, tuple) else s for s in spec]

    def specs_of(tree, shardings):
        return [norm(s.spec, len(leaf.shape)) for leaf, s in
                zip(jax.tree.leaves(tree), jax.tree.leaves(
                    shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))]

    def port_tree(arch):
        pm = port_build(port_reduce(port_config(arch)), max_pos=64, device="cpu")
        return jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
                            pm.abstract_params(), is_leaf=lambda t: isinstance(t, torch.Tensor))

    specs = {}
    for fsdp, heads in RULE_SETS:
        rules = make_rules(mesh, fsdp=fsdp, shard_heads=heads)
        for arch in list_archs():
            for layout, tree in (("stacked", build_model(reduce_config(get_config(arch)),
                                                          max_pos=64).abstract_params()),
                                 ("port", port_tree(arch))):
                p_sh = param_shardings(reduce_config(get_config(arch)), tree, rules)
                o_sh = opt_state_shardings(p_sh, rules, tree)
                specs[f"{fsdp}-{heads}-{arch}-{layout}"] = {
                    "params": specs_of(tree, p_sh), "opt": specs_of(tree, o_sh["master"]),
                    "step": norm(o_sh["step"].spec, 0)}
        with use_rules(rules):
            res[f"bias-{fsdp}-{heads}"] = np.asarray(_local_expert_bias(6, 8, 0.5)).tolist()
    res["specs"] = specs

    # abstract params, input and cache specs at full width
    def shapes(tree):
        return [[list(x.shape), str(x.dtype)] for x in jax.tree.leaves(tree)]
    full = {}
    for arch in list_archs():
        m = build_model(get_config(arch))
        full[arch] = {"params": shapes(m.abstract_params()),
                      "inputs": {s: {k: [list(v.shape), str(v.dtype)]
                                     for k, v in m.input_specs(SHAPES[s]).items()}
                                 for s in SHAPES},
                      "caches": {s: shapes(m.cache_specs(SHAPES[s])) for s in SHAPES}}
    res["full"] = full
    (out / "jax.json").write_text(json.dumps(res))


def _fakepg_main(out):
    """make_production_mesh over the fake process group, at every size."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import fake_world, make_debug_mesh, make_production_mesh

    res = {}
    for size in (8, 256, 512):
        with fake_world(size):
            for multi in (False, True):
                try:
                    m = make_production_mesh(multi_pod=multi, device="cpu")
                    res[f"{size}-{multi}"] = [list(m.shape), list(m.mesh_dim_names)]
                except ValueError as exc:
                    res[f"{size}-{multi}"] = str(exc)
            try:
                make_debug_mesh(device="cpu")
                res[f"{size}-debug"] = "built"
            except ValueError as exc:
                res[f"{size}-debug"] = str(exc)
    try:
        make_debug_mesh(device="cpu")
    except RuntimeError as exc:
        res["no group"] = str(exc)
    pathlib.Path(out, "fakepg.json").write_text(json.dumps(res))


# -- running the processes --------------------------------------------------

def _inputs():
    import jax

    from repro.configs import get_config, reduce_config
    from repro.models.model import build_model
    from repro_torch.configs import get_config as pget
    from repro_torch.configs import reduce_config as pred
    from repro_torch.models.convert import params_from_jax

    cfg = reduce_config(get_config("qwen2-0.5b"))
    params = build_model(cfg, max_pos=64).init_params(jax.random.key(0))
    batch = {"tokens": jax.random.randint(jax.random.key(1), (8, 16), 0, 100),
             "labels": jax.random.randint(jax.random.key(2), (8, 16), 0, 100)}

    def f32(seed, shape, scale=1.0):
        return torch.from_numpy((np.random.default_rng(seed).standard_normal(shape)
                                 * scale).astype(np.float32))
    rng = np.random.default_rng(0)
    pipe_w = (rng.standard_normal((4, 16, 16)) * 0.2).astype(np.float32)
    pipe_x = rng.standard_normal((8, 4, 16)).astype(np.float32)
    rng = np.random.default_rng(0)
    sp = {n: torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32))
          for n, s in (("q", (2, 4096, 4, 16)), ("k", (2, 4096, 2, 16)),
                       ("v", (2, 4096, 2, 16)))}
    sp["do"] = torch.from_numpy(rng.standard_normal((2, 4096, 64)).astype(np.float32))
    sp["wo"] = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    rng = np.random.default_rng(6)
    mla = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for n, s in (("q_lat", (2, 4096, 4, 8)), ("q_rope", (2, 4096, 4, 4)),
                        ("ckv", (2, 4096, 8)), ("kr", (2, 4096, 4)))}
    rng = np.random.default_rng(3)
    ks = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for n, s in (("q", (2, 32, 8, 16)), ("k", (2, 32, 2, 16)), ("v", (2, 32, 2, 16)),
                       ("do", (2, 32, 128)))}
    return {
        "checks": CHECKS, "train_mesh": (2, 4), "ring_x": f32(7, (2, 24, 2, 4)),
        "params": params_from_jax(jax.tree.map(np.asarray, params),
                                  pred(pget("qwen2-0.5b")), "cpu"),
        "batch": {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in batch.items()},
        "pipe_w": torch.from_numpy(pipe_w), "pipe_x": torch.from_numpy(pipe_x),
        "coll_arange": torch.arange(WORLD * 4, dtype=torch.float32).reshape(WORLD, 4),
        "coll_random": f32(4, (WORLD, 4)), "coll_error": f32(5, (WORLD, 4), 0.01),
        "lse_logits": f32(1, (WORLD, 16)), "lse_v": f32(2, (WORLD, 16, 4)),
        **{f"sp_{n}": t for n, t in sp.items()}, **{f"ks_{n}": t for n, t in ks.items()},
        **{f"mla_{n}": t for n, t in mla.items()}}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


def _join(procs, deadline):
    """Wait for every process until ``deadline``; kill them all and fail on
    overrun or on a non-zero exit."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a process ran past {TIME_LIMIT_S} s and was killed")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _spawn(script, args, env):
    return subprocess.Popen([sys.executable, str(script), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    torch.save(_inputs(), d / "inputs.pt")
    env = _env()
    deadline = time.monotonic() + TIME_LIMIT_S
    this = pathlib.Path(__file__).resolve()
    side = [_spawn(this, ["jax", str(d)], env), _spawn(this, ["fakepg", str(d)], env)]
    init = f"file://{d / 'rendezvous'}"
    ranks = [_spawn(ROOT / "tests" / "torch_dist_ranks.py",
                    ["gloo", str(r), str(WORLD), init, str(d)], env) for r in range(WORLD)]
    _join(ranks + side, deadline)
    return types.SimpleNamespace(
        ranks=[torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)],
        inputs=torch.load(d / "inputs.pt", weights_only=False),
        jax=json.loads((d / "jax.json").read_text()),
        step=dict(np.load(d / "jax_step.npz")), step2=dict(np.load(d / "jax_step2.npz")),
        psum=dict(np.load(d / "jax_psum.npz")),
        fakepg=json.loads((d / "fakepg.json").read_text()))


# -- multi-rank checks --------------------------------------------------------

class TestShardedTrain:
    def test_loss_matches_jax_single_device(self, world):
        r0 = world.ranks[0]
        np.testing.assert_allclose(float(r0["train_loss"]), float(world.step["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(r0["train_loss"]), float(r0["train_single_loss"]),
                                   rtol=2e-5)

    @pytest.mark.parametrize("against", ["jax", "port_unsharded"])
    def test_every_leaf(self, world, against):
        from repro_torch.configs import get_config, reduce_config
        from repro_torch.models.convert import params_to_jax

        r0 = world.ranks[0]
        cfg = reduce_config(get_config("qwen2-0.5b"))
        got = params_to_jax(_unflat(world.inputs["params"], r0["train_leaves"]), cfg)
        import jax
        got = jax.tree.leaves(got)
        if against == "jax":
            want = [world.step[f"leaf{i}"] for i in range(len(got))]
        else:
            want = jax.tree.leaves(params_to_jax(
                _unflat(world.inputs["params"], r0["train_single_leaves"]), cfg))
        assert len(got) == len(want) > 10
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                       atol=2e-4)

    def test_fsdp_and_sharded_heads_match_the_unsharded_step(self, world):
        """FSDP over the data dim and query heads over the model dim (the
        kernel call site's head slicing and its summed kv gradients)."""
        r0 = world.ranks[0]
        np.testing.assert_allclose(float(r0["train_fsdp_heads_loss"]),
                                   float(r0["train_single_loss"]), rtol=2e-5)
        for a, b in zip(r0["train_fsdp_heads_leaves"], r0["train_single_leaves"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)
        assert any("Shard(dim=0), Shard(dim=1)" in p
                   for p in r0["train_fsdp_heads_param_placements"])   # wq: fsdp, qheads

    def test_gather_fsdp_drops_the_data_shard(self, world):
        assert world.ranks[0]["gather_fsdp"] == {
            "attn/wq": "(Replicate(), Shard(dim=1))", "mlp/w_down": "(Replicate(), Shard(dim=0))"}

    def test_microbatches_match_the_unsharded_step(self, world):
        """Two microbatches, FSDP and sharded heads: the gradient accumulated
        on each rank's shards gives the unsharded step's loss and leaves."""
        r0 = world.ranks[0]
        np.testing.assert_allclose(float(r0["train_mb_loss"]),
                                   float(r0["train_mb_single_loss"]), rtol=2e-5)
        assert len(r0["train_mb_leaves"]) == len(r0["train_mb_single_leaves"]) > 10
        for a, b in zip(r0["train_mb_leaves"], r0["train_mb_single_leaves"]):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=2e-4)

    def test_every_rank_holds_the_same_result(self, world):
        for r in world.ranks[1:]:
            assert float(r["train_loss"]) == float(world.ranks[0]["train_loss"])
            for a, b in zip(r["train_leaves"], world.ranks[0]["train_leaves"]):
                assert torch.equal(a, b)

    def test_placements_follow_the_rules(self, world):
        """Parameters by ``param_shardings`` (vocab and ffn over the model
        dim), the optimizer state with ZeRO's data dim added."""
        r0 = world.ranks[0]
        assert "(Replicate(), Shard(dim=0))" in r0["train_param_placements"]
        assert any("Shard(dim=0), Shard(dim=1)" in p or "Shard(dim=1), Shard(dim=0)" in p
                   for p in r0["train_opt_placements"])

    @pytest.mark.parametrize("tag", ["", "fsdp_heads_"], ids=["reference_rules", "fsdp_heads"])
    def test_donated_step_keeps_the_placements(self, world, tag):
        """F11: after the donated step every parameter is on
        ``param_shardings``' placements and master, m, v and step on
        ``opt_state_shardings``', as the reference's ``out_shardings`` put
        them; no partial sum is left."""
        for r in world.ranks:
            want, got = r[f"donate_{tag}want"], r[f"donate_{tag}got"]
            assert len(got["params"]) == len(want["params"]) > 10
            assert got == want
            assert not any("Partial" in p for pls in got.values() for p in pls)
        assert any("Shard" in p for p in world.ranks[0][f"donate_{tag}want"]["m"])

    @pytest.mark.parametrize("tag", ["", "fsdp_heads_"], ids=["reference_rules", "fsdp_heads"])
    def test_second_donated_step_matches_two_jax_steps(self, world, tag):
        """A second sharded step, from the placements the first handed
        back, against two single-device steps of the JAX package (the same
        batch twice), at the reference check's limits."""
        from repro_torch.configs import get_config, reduce_config
        from repro_torch.models.convert import params_to_jax
        import jax

        r0 = world.ranks[0]
        np.testing.assert_allclose(float(r0[f"donate_{tag}loss2"]),
                                   float(world.step2["loss"]), rtol=2e-5)
        cfg = reduce_config(get_config("qwen2-0.5b"))
        got = jax.tree.leaves(params_to_jax(
            _unflat(world.inputs["params"], r0[f"donate_{tag}leaves2"]), cfg))
        want = [world.step2[f"leaf{i}"] for i in range(len(got))]
        assert len(got) == len(want) > 10
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.asarray(a, np.float32), b, atol=2e-4)

    @pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
    def test_recurrent_forward_on_local_shards(self, world, arch):
        plain, sharded = world.ranks[0][f"forward_{arch}"]
        np.testing.assert_allclose(float(sharded), float(plain), rtol=2e-5)


@pytest.mark.parametrize("case", ["24_0", "12_10"])
def test_ring_write_on_slot_shards(world, case):
    for r in world.ranks:
        want, got = r[f"ring_{case}"]
        assert torch.equal(want, got)
        assert (want != 7.0).all()          # every slot written or zeroed


def _unflat(like, leaves_):
    from repro_torch._tree import unflatten
    return unflatten(like, leaves_)


def test_pipeline_parallel(world):
    ref = world.inputs["pipe_x"]
    for s in range(4):
        ref = torch.tanh(ref @ world.inputs["pipe_w"][s])
    for r in world.ranks[:4]:
        np.testing.assert_allclose(r["pipeline"].numpy(), ref.numpy(), atol=1e-5)


class TestCollectives:
    @pytest.mark.parametrize("mode,rtol,atol", [("none", 1e-6, 0), ("bf16", 2e-2, 0),
                                                ("int8", 8e-2, 2.0)])
    def test_compressed_psum_against_numpy(self, world, mode, rtol, atol):
        x = world.inputs["coll_arange"].numpy()
        for r in world.ranks:
            np.testing.assert_allclose(r[f"psum_arange_{mode}"].numpy()[0], x.sum(0),
                                       rtol=rtol, atol=atol)

    @pytest.mark.parametrize("name", ["arange", "random"])
    def test_int8_bit_for_bit_against_jax(self, world, name):
        got = np.concatenate([r[f"psum_{name}_int8"].numpy() for r in world.ranks])
        err = np.concatenate([r[f"psum_{name}_int8_err"].numpy() for r in world.ranks])
        np.testing.assert_array_equal(got, world.psum[f"{name}_0"])
        np.testing.assert_array_equal(err, world.psum[f"{name}_1"])

    def test_unknown_mode_raises_as_reference(self, world):
        assert world.ranks[0]["psum_unknown"] == "unknown compression 'fp4'"

    def test_lse_combine_is_the_full_softmax(self, world):
        logits, v = world.inputs["lse_logits"], world.inputs["lse_v"]
        w = torch.softmax(logits.reshape(1, -1), -1)
        ref = torch.einsum("bs,bsd->bd", w, v.reshape(1, -1, 4))
        for r in world.ranks:
            np.testing.assert_allclose(r["lse"].numpy(), ref.numpy(), atol=1e-5)

    def test_ring_halo_exchange(self, world):
        for rank, r in enumerate(world.ranks):
            up, down = r["halo"]
            want_up = [0, 0] if rank == 0 else [10 * (rank - 1) + 4, 10 * (rank - 1) + 5]
            want_down = [0, 0] if rank == WORLD - 1 else [10 * (rank + 1), 10 * (rank + 1) + 1]
            assert up.tolist() == want_up and down.tolist() == want_down

    def test_reduce_scatter_then_all_gather(self, world):
        total = sum(r["rs_ag_in"] for r in world.ranks)
        for r in world.ranks:
            np.testing.assert_allclose(r["rs_ag"].numpy(), (2 * total).numpy(), atol=1e-5)


class TestSeqParallel:
    @pytest.mark.parametrize("window", [0, 300])
    def test_against_jax_banded_or_chunked(self, world, window):
        import jax.numpy as jnp
        from repro.models.attention import banded_attention, chunked_attention

        q, k, v = (jnp.asarray(world.inputs[f"sp_{n}"].numpy()) for n in "qkv")
        ref = banded_attention(q, k, v, 0, window) if window else chunked_attention(q, k, v, 0)
        for r in world.ranks:
            np.testing.assert_allclose(r[f"sp_{window}"].numpy(), np.asarray(ref), atol=2e-5)
        assert world.ranks[0][f"sp_placements_{window}"] == "(Shard(dim=0), Shard(dim=1))"

    def test_projection_on_the_sequence_shards(self, world):
        """The output projection of a sequence-sharded result runs on each
        rank's shard, then the shards are gathered: the residual stream is
        sharded on the batch only."""
        for r in world.ranks:
            want, got, placements = r["sp_projection"]
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
            assert placements == "(Shard(dim=0), Replicate())"

    @pytest.mark.parametrize("i,name", [(0, "q"), (1, "k"), (2, "v")])
    def test_gradient_through_the_shards(self, world, i, name):
        """k's and v's gradients are summed over the query shards (every
        shard reads them whole), as the transpose of ``shard_map`` sums them."""
        for r in world.ranks:
            want, got = r["sp_grad"][i]
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)

    @pytest.mark.parametrize("case", ["no rules", "heads shard", "seq_q two dims",
                                      "one shard", "T % n", "T/n % 128"])
    def test_none_where_reference_gives_none(self, world, case):
        assert world.ranks[0]["sp_none"][case] is True

    def test_mla_absorbed_sequence_shards(self, world):
        want, got = world.ranks[0]["mla"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
        assert world.ranks[0]["mla_placements"] == "(Shard(dim=0), Shard(dim=1))"

    def test_kernel_site_on_local_head_shards(self, world):
        """Query heads over the model dim (2 a shard, 4 to a kv head): each
        shard keeps its kv head, and the joined result is the unsharded one."""
        want, got = world.ranks[0]["kernel_site"]
        assert torch.equal(got, want)
        assert world.ranks[0]["kernel_site_placements"] == "(Shard(dim=0), Shard(dim=2))"

    @pytest.mark.parametrize("i,name", [(0, "q"), (1, "k"), (2, "v")])
    def test_kernel_site_gradient(self, world, i, name):
        """Through ``FlashAttentionFn`` on each shard: the kv heads'
        gradients are summed over the query-head shards that read them (f32
        sums regrouped by shard: a few ulps of values up to about 10)."""
        for r in world.ranks:
            want, got = r["kernel_site_grad"][i]
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# -- in-process checks ---------------------------------------------------------

def _mesh(names, shape):
    """What ``make_rules`` and the specs read of a DeviceMesh."""
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape, ndim=len(shape))


@pytest.mark.parametrize("names", [("data", "model"), ("pod", "data", "model")])
@pytest.mark.parametrize("fsdp,heads", [(False, True), (True, False), (True, True)])
def test_make_rules_table_is_the_reference(names, fsdp, heads):
    from repro.distributed.sharding import make_rules as ref_rules
    from repro_torch.distributed.sharding import make_rules

    want = ref_rules(types.SimpleNamespace(axis_names=names), fsdp=fsdp, shard_heads=heads)
    got = make_rules(_mesh(names, (2,) * len(names)), fsdp=fsdp, shard_heads=heads)
    assert got.rules == want.rules


def _port_specs(arch, fsdp, heads, layout):
    from repro_torch._tree import leaves
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.distributed.sharding import make_rules, spec_of
    from repro_torch.models.convert import to_reference_layout
    from repro_torch.models.model import build_model, param_shardings
    from repro_torch.train.optimizer import opt_state_shardings

    cfg = reduce_config(get_config(arch))
    tree = build_model(cfg, max_pos=64, device="cpu").abstract_params()
    if layout == "stacked":
        tree = to_reference_layout(tree, cfg)
    mesh = _mesh(("data", "model"), (2, 4))
    rules = make_rules(mesh, fsdp=fsdp, shard_heads=heads)
    p_sh = param_shardings(cfg, tree, rules)
    o_sh = opt_state_shardings(p_sh, rules, tree)
    from repro_torch.models.model import _placement_leaves

    def specs(sh):
        return [[list(s) if isinstance(s, tuple) else s
                 for s in spec_of(mesh, pl, x.ndim)]
                for pl, x in zip(_placement_leaves(tree, sh), leaves(tree))]
    return {"params": specs(p_sh), "opt": specs(o_sh["master"]),
            "step": list(spec_of(mesh, o_sh["step"], 0))}


ARCHS = ["gemma3-1b", "llama-3.2-vision-90b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
         "qwen2-0.5b", "qwen2-1.5b", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
         "rwkv6-3b", "whisper-base"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["stacked", "port"])
def test_param_and_opt_state_specs_equal_the_reference(world, arch, layout):
    for fsdp, heads in RULE_SETS:
        want = world.jax["specs"][f"{fsdp}-{heads}-{arch}-{layout}"]
        got = _port_specs(arch, fsdp, heads, layout)
        assert got["params"] == want["params"]
        assert got["opt"] == want["opt"]
        assert got["step"] == want["step"]


@pytest.mark.parametrize("fsdp,heads", RULE_SETS)
def test_local_expert_bias_at_four_expert_shards(world, fsdp, heads):
    from repro_torch.distributed.sharding import make_rules, use_rules
    from repro_torch.models.moe import _local_expert_bias

    rules = make_rules(_mesh(("data", "model"), (2, 4)), fsdp=fsdp, shard_heads=heads)
    with use_rules(rules):
        got = _local_expert_bias(6, 8, 0.5)
    assert got.tolist() == world.jax[f"bias-{fsdp}-{heads}"]
    assert got.abs().sum() > 0
    assert _local_expert_bias(6, 8, 0.5).abs().sum() == 0      # no rules: zeros


def test_param_logical_axes_are_the_reference_table():
    from repro.models import model as ref
    from repro_torch.models import model as port

    assert port._LEAF_AXES == ref._LEAF_AXES
    assert port._MOE_LEAF_AXES == ref._MOE_LEAF_AXES
    from repro_torch.configs import get_config, reduce_config
    cfg = reduce_config(get_config("qwen3-moe-30b-a3b"))
    tree = port.build_model(cfg, device="cpu").abstract_params()
    axes = port.param_logical_axes(cfg, tree)
    assert axes["stack"][0]["moe"]["w_gate"] == ("experts", "fsdp", None)
    assert axes["stack"][0]["attn"]["wq"] == ("fsdp", "qheads")
    assert axes["final_norm"]["scale"] == (None,)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_abstract_params_and_specs(world, arch):
    """Every leaf at full width is a ``meta`` tensor (no memory), with the
    reference's ``jax.eval_shape`` shape and dtype."""
    from repro_torch._tree import leaves
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.convert import _host_stack, _stack, to_reference_layout
    from repro_torch.models.model import build_model

    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    want = world.jax["full"][arch]

    def shapes(tree):
        xs = leaves(tree)
        assert all(x.is_meta for x in xs)
        return [[list(x.shape), str(x.dtype).replace("torch.", "")] for x in xs]

    assert shapes(to_reference_layout(model.abstract_params(), cfg)) == want["params"]
    for name, shape in SHAPES.items():
        got = model.input_specs(shape)
        assert {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                for k, v in got.items()} == want["inputs"][name]
        assert all(v.is_meta for v in got.values())
        caches = _stack(model.cache_specs(shape), cfg, "caches", _host_stack)
        assert shapes(caches) == want["caches"][name]


def test_production_mesh_over_the_fake_group(world):
    got = world.fakepg
    assert got["256-False"] == [[16, 16], ["data", "model"]]
    assert got["512-True"] == [[2, 16, 16], ["pod", "data", "model"]]
    assert got["8-debug"] == "built"
    for key in ("8-False", "8-True", "256-True", "512-False", "256-debug", "512-debug"):
        assert "needs a world of" in got[key], (key, got[key])
    assert "needs an initialised torch.distributed process group" in got["no group"]


def test_pipeline_napkin_model_is_the_reference():
    from repro.distributed import pipeline as ref
    from repro_torch.distributed import pipeline as port

    for p, m in ((2, 8), (4, 8), (4, 32), (16, 4)):
        assert port.bubble_fraction(p, m) == ref.bubble_fraction(p, m)
        assert port.pipeline_wire_bytes(1e9, 3e6, p, m) == \
            ref.pipeline_wire_bytes(1e9, 3e6, p, m)


def test_errors_match_the_reference():
    import jax.numpy as jnp
    from repro.distributed import sharding as ref
    from repro_torch.distributed import sharding as port

    with ref.use_rules(ref.make_rules(types.SimpleNamespace(axis_names=("data", "model")))):
        with pytest.raises(ValueError) as want:
            ref.shard(jnp.zeros((2, 3)), "batch")
    with port.use_rules(port.make_rules(_mesh(("data", "model"), (2, 4)))):
        with pytest.raises(ValueError) as got:
            port.shard(torch.zeros((2, 3)), "batch")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="both shard over mesh dim 'model'"):
        port.placements(_mesh(("data", "model"), (2, 4)), ("model", "model"))


def test_remat_recompute_keeps_the_rules_in_another_thread(monkeypatch):
    """Autograd runs a CUDA backward on a device thread of its own, where
    the thread-local rules are absent: a layer's recomputation (remat) must
    still run under the rules its forward ran under.  Here the backward is
    started on another thread by hand."""
    import dataclasses
    import threading

    from repro_torch._tree import leaves, unflatten
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.distributed.sharding import current_rules, make_rules, use_rules
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(reduce_config(get_config("qwen2-0.5b")), remat=True)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    seen = []
    real = transformer.apply_block

    def spy(*args, **kw):
        seen.append(current_rules())
        return real(*args, **kw)

    monkeypatch.setattr(transformer, "apply_block", spy)
    rules = make_rules(_mesh(("data", "model"), (2, 4)))
    tokens = torch.randint(0, 100, (2, 8), generator=torch.Generator().manual_seed(1))
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with use_rules(rules):
        loss, _ = model.loss_fn(unflatten(params, flat), {"tokens": tokens, "labels": tokens})
        worker = threading.Thread(target=lambda: torch.autograd.grad(loss, flat))
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive()
    assert len(seen) == 2 * cfg.num_layers            # forward, then the recomputation
    assert all(r is rules for r in seen)


def test_placements_of_a_tuple_axis():
    """``batch -> ("pod", "data")`` shards tensor dim 0 over both mesh dims;
    ``spec_of`` gives the reference's spec back."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import make_rules, spec_of

    mesh = _mesh(("pod", "data", "model"), (2, 2, 2))
    rules = make_rules(mesh)
    got = rules.sharding("batch", None, "vocab")
    assert got == [Shard(0), Shard(0), Shard(2)]
    assert spec_of(mesh, got, 3) == (("pod", "data"), None, "model")
    assert rules.sharding(None, "embed") == [Replicate()] * 3
    assert rules.axis_size(rules.rules["batch"]) == 4


def test_shard_without_rules_is_a_no_op():
    from repro_torch.distributed.sharding import shard

    x = torch.randn(2, 3)
    assert shard(x, "batch", None) is x


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(sys.argv[2])
    else:
        _fakepg_main(sys.argv[2])
