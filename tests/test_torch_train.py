"""The port's training path (``repro_torch.train``, ``data``,
``distributed.fault``, ``launch.train`` and the example twins) held
against the JAX package on the CPU, plus ``cuda`` tests of the backward
kernels (K3, K4, K5) and of the kernels that must refuse a gradient (K1,
K2).

The numbers: the reduced qwen2-0.5b (``reduce_config``, f32) with the
reference's own initial parameters carried across by ``params_from_jax``,
the reference's synthetic corpus (seed 3), AdamW lr 1e-3 with 2 warmup
steps.  On the CPU the port's attention is the plain path.  Tolerances:

* step 1: loss within 1e-5 relative of the JAX ``make_train_step`` under
  ``jax.jit``; each leaf's gradient within 1e-5 of that leaf's largest
  |g| (the same f32 math, sums in another order);
* steps 2 and 3: losses within 1e-4;
* parameters after 3 steps: Adam's m / sqrt(v) turns a noise-level
  gradient into a step of +-lr, so where step 1's |g| exceeds 1e-3 of the
  leaf's largest, within 1e-4 of max(|value|, 2 lr x 3 steps); everywhere
  else within 2 lr x 3 steps.  The floor: a value that Adam moved from
  near zero (a bias) is made of its updates, and an update's m / sqrt(v)
  amplifies the gradient's relative error, which is up to 1e-5 / 1e-3 at
  the mask's edge; against |value| alone, bk of layer 0 (0.0015 after 3
  steps, 1.8e-7 apart) took 1.2x that limit;
* ``schedule`` and ``adamw_update`` alone: 1e-6 relative;
* the donated step (``make_train_step(donate=True)``) against the
  functional one: bit for bit; the ``Trainer``, which donates, against the
  reference's step jitted with ``donate_argnums=(0, 1)``: the limits above.

One jitted JAX step and one reference run per module fixture keep the
file fast.
"""
import dataclasses
import pathlib
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.pipeline as ref_pipeline
import repro.distributed.fault as ref_fault
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models.model import build_model as jax_build_model
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro_torch import _tree
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import pipeline
from repro_torch.distributed import fault
from repro_torch.models.convert import (opt_state_from_jax, opt_state_to_jax,
                                        params_from_jax, params_to_jax)
from repro_torch.models.model import build_model
from repro_torch.train import optimizer, train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
SEQ, BATCH, SEED, STEPS = 32, 4, 3, 3
LR = 1e-3


def _opt_cfgs():
    kw = dict(lr=LR, warmup_steps=2, total_steps=10)
    return ref_opt.AdamWConfig(**kw), optimizer.AdamWConfig(**kw)


def _batches(cfg, n, batch=BATCH):
    it = ref_pipeline.make_batch_iterator(cfg.vocab_size, SEQ, batch, seed=SEED)
    return [next(it) for _ in range(n)]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _models(microbatches=1):
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(ARCH)),
                               microbatches=microbatches)
    cfg = dataclasses.replace(reduce_config(get_config(ARCH)), microbatches=microbatches)
    jm = jax_build_model(jcfg, max_pos=64)
    pm = build_model(cfg, max_pos=64, device="cpu")
    jp = jm.init_params(jax.random.key(0))
    return cfg, jm, jp, pm, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _port_tree(tree, cfg):
    """A reference params-shaped tree (JAX arrays) in the port's layout."""
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg, "cpu")


def _assert_three_steps_close(got_params, want_params, grads):
    """The parameters after three steps, by the limits in the module's
    docstring (``grads``: the reference's step-1 gradient)."""
    grads = dict(_tree.flatten_with_path(grads))
    for (path, want), got in zip(_tree.flatten_with_path(want_params),
                                 _tree.leaves(got_params)):
        g1 = grads[path].abs()
        big = g1 > 1e-3 * g1.max()
        err = (got - want).abs()
        scale = torch.clamp(want.abs(), min=2 * LR * STEPS)
        assert bool((err[big] <= 1e-4 * scale[big]).all()), path
        assert float(torch.cat([err[~big], err.new_zeros(1)]).max()) <= 2 * LR * STEPS, path


@pytest.fixture(scope="module")
def run():
    """Three steps of each package's train step from the same params and
    batches, and the reference's step-1 gradient."""
    cfg, jm, jp, pm, pp = _models()
    jopt, opt = _opt_cfgs()
    batches = _batches(cfg, STEPS)
    jstep = jax.jit(ref_step.make_train_step(jm, jopt))
    pstep = train_step.make_train_step(pm, opt)
    (_, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, _jb(batches[0]))
    js, jo, ps, po = jp, ref_opt.init_opt_state(jp), pp, optimizer.init_opt_state(pp)
    jl, pl = [], []
    for b in batches:
        js, jo, jmet = jstep(js, jo, _jb(b))
        ps, po, pmet = pstep(ps, po, _tb(b))
        jl.append(jmet)
        pl.append(pmet)
    return dict(cfg=cfg, pm=pm, pp=pp, batches=batches, grads=_port_tree(jg, cfg),
                jparams=_port_tree(js, cfg), jopt=jo, params=ps, opt=po,
                jmetrics=jl, metrics=pl)


class TestTrainStep:
    def test_step1_loss(self, run):
        want, got = float(run["jmetrics"][0]["loss"]), float(run["metrics"][0]["loss"])
        assert abs(got - want) <= 1e-5 * abs(want)
        for name in ("ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(run["metrics"][0][name]),
                                       float(run["jmetrics"][0][name]), rtol=1e-5, atol=1e-7)

    def test_step1_gradient_per_leaf(self, run):
        pm, pp, cfg = run["pm"], run["pp"], run["cfg"]
        flat = [p.detach().requires_grad_(True) for p in _tree.leaves(pp)]
        loss, _ = pm.loss_fn(_tree.unflatten(pp, flat), _tb(run["batches"][0]))
        got = torch.autograd.grad(loss, flat)
        want = _tree.flatten_with_path(run["grads"])
        assert len(got) == len(want)
        for (path, w), g in zip(want, got):
            lim = 1e-5 * float(w.abs().max())
            assert float((g - w).abs().max()) <= lim, path

    def test_steps_2_and_3_losses(self, run):
        for j, p in zip(run["jmetrics"][1:], run["metrics"][1:]):
            assert abs(float(p["loss"]) - float(j["loss"])) <= 1e-4

    def test_params_after_three_steps(self, run):
        _assert_three_steps_close(run["params"], run["jparams"], run["grads"])

    def test_opt_state_after_three_steps(self, run):
        cfg = run["cfg"]
        want = opt_state_from_jax(jax.tree.map(np.asarray, run["jopt"]), cfg, "cpu")
        assert int(run["opt"]["step"]) == int(want["step"]) == STEPS
        for (path, w), g in zip(_tree.flatten_with_path(want["master"]),
                                _tree.leaves(run["opt"]["master"])):
            assert float((g - w).abs().max()) <= 2 * LR * STEPS, path

    def test_microbatches_take_the_reference_rows(self):
        x = np.arange(8 * 3).reshape(8, 3)
        want = np.asarray(ref_step._split_microbatches({"t": jnp.asarray(x)}, 2)["t"])
        got = train_step._split_microbatches({"t": torch.as_tensor(x)}, 2)
        assert [mb["t"].tolist() for mb in got] == want.tolist()
        assert got[1]["t"][:, 0].tolist() == [3, 9, 15, 21]   # rows 1, 3, 5, 7

    def test_microbatches_2_step(self):
        cfg, jm, jp, pm, pp = _models(microbatches=2)
        jopt, opt = _opt_cfgs()
        b = _batches(cfg, 1)[0]
        js, _, jmet = jax.jit(ref_step.make_train_step(jm, jopt))(
            jp, ref_opt.init_opt_state(jp), _jb(b))
        ps, _, pmet = train_step.make_train_step(pm, opt)(pp, optimizer.init_opt_state(pp),
                                                          _tb(b))
        assert abs(float(pmet["loss"]) - float(jmet["loss"])) <= 1e-5 * abs(float(jmet["loss"]))
        np.testing.assert_allclose(float(pmet["ce"]), float(jmet["ce"]), rtol=1e-5)
        np.testing.assert_allclose(float(pmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-5)
        for (path, w), g in zip(_tree.flatten_with_path(_port_tree(js, cfg)),
                                _tree.leaves(ps)):
            assert float((g - w).abs().max()) <= 2 * LR, path


class TestOptimizer:
    def test_schedule(self):
        jc, pc = _opt_cfgs()
        for step in (0, 1, 2, 3, 5, 9, 10, 12):
            np.testing.assert_allclose(float(optimizer.schedule(pc, step)),
                                       float(ref_opt.schedule(jc, jnp.float32(step))),
                                       rtol=1e-6)

    def test_adamw_update_alone(self):
        rng = np.random.default_rng(0)
        shapes = {"a": (5, 7), "b": {"c": (3,), "d": (2, 2, 4)}}
        mk = lambda s: rng.standard_normal(s).astype(np.float32)
        grads = jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))
        params = jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))
        m = jax.tree.map(lambda x: 0.1 * x, params)
        v = jax.tree.map(lambda x: np.abs(x) * 0.01, grads)
        jc, pc = _opt_cfgs()
        jstate = {"master": jax.tree.map(jnp.asarray, params), "m": jax.tree.map(jnp.asarray, m),
                  "v": jax.tree.map(jnp.asarray, v), "step": jnp.asarray(3, jnp.int32)}
        pstate = {"master": _tree.tree_map(torch.as_tensor, params),
                  "m": _tree.tree_map(torch.as_tensor, m),
                  "v": _tree.tree_map(torch.as_tensor, v),
                  "step": torch.tensor(3, dtype=torch.int32)}
        jp, js, jmet = ref_opt.adamw_update(jc, jax.tree.map(jnp.asarray, grads), jstate,
                                            param_dtype=jnp.float32)
        pp, ps, pmet = optimizer.adamw_update(pc, _tree.tree_map(torch.as_tensor, grads),
                                              pstate, param_dtype=torch.float32)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pmet[name]), float(jmet[name]), rtol=1e-6)
        for key in ("master", "m", "v"):
            for w, g in zip(jax.tree.leaves(js[key]), _tree.leaves(ps[key])):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
        for w, g in zip(jax.tree.leaves(jp), _tree.leaves(pp)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
        assert int(ps["step"]) == int(js["step"]) == 4

    def test_init_opt_state_copies(self):
        p = {"w": torch.ones(3)}
        s = optimizer.init_opt_state(p)
        assert s["master"]["w"].data_ptr() != p["w"].data_ptr()
        assert s["step"].dtype == torch.int32 and int(s["step"]) == 0
        assert float(optimizer.global_norm({"a": torch.full((4,), 2.0)})) == 4.0

    def test_same_public_names(self):
        for name in ("AdamWConfig", "schedule", "init_opt_state", "global_norm",
                     "adamw_update"):
            assert hasattr(optimizer, name) and hasattr(ref_opt, name)
        assert dataclasses.asdict(optimizer.AdamWConfig()) == \
            dataclasses.asdict(ref_opt.AdamWConfig())


def _clone(tree):
    return _tree.tree_map(lambda t: t.clone(), tree)


def _donation_models(arch, microbatches, dtype=None):
    cfg = dataclasses.replace(reduce_config(get_config(arch)), microbatches=microbatches)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg, max_pos=64, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    return cfg, model, params


class TestDonation:
    """``make_train_step(donate=True)`` (P21, the reference's
    ``donate_argnums=(0, 1)``): the new state is written into the
    arguments' leaves, with the functional step's bits."""

    @pytest.mark.parametrize("arch,microbatches,dtype", [
        (ARCH, 1, None), (ARCH, 2, None), ("rwkv6-3b", 1, None), ("rwkv6-3b", 2, None),
        ("recurrentgemma-9b", 1, None), ("recurrentgemma-9b", 2, None),
        (ARCH, 2, "bfloat16")])
    def test_donated_equals_functional_bit_for_bit(self, arch, microbatches, dtype):
        """Three steps from the same state and batches (2 x 32 tokens):
        params, master, m, v, step and every metric equal bit for bit (bf16: the parameters'
        ``copy_`` from the master rounds as ``.to`` does)."""
        cfg, model, params = _donation_models(arch, microbatches, dtype)
        _, opt = _opt_cfgs()
        functional = train_step.make_train_step(model, opt)
        donated = train_step.make_train_step(model, opt, donate=True)
        fp, fo = _clone(params), optimizer.init_opt_state(params)
        dp, do = _clone(params), optimizer.init_opt_state(params)
        for b in _batches(cfg, STEPS, batch=2):
            fp, fo, fm = functional(fp, fo, _tb(b))
            dp2, do2, dm = donated(dp, do, _tb(b))
            assert dp2 is dp and do2 is do
            assert sorted(fm) == sorted(dm)
            for name in fm:
                assert torch.equal(torch.as_tensor(fm[name]), torch.as_tensor(dm[name])), name
        got, want = _tree.leaves({"p": dp, "o": do}), _tree.leaves({"p": fp, "o": fo})
        assert len(got) == len(want) > 10
        for (path, a), b in zip(_tree.flatten_with_path({"p": dp, "o": do}), want):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        assert int(do["step"]) == STEPS

    def test_donated_step_returns_its_arguments_storages(self):
        cfg, model, params = _donation_models(ARCH, 2, "bfloat16")
        opt_state = optimizer.init_opt_state(params)
        before = [x.untyped_storage().data_ptr()
                  for x in _tree.leaves({"p": params, "o": opt_state})]
        first = _tree.leaves(params)[0].clone()
        step = train_step.make_train_step(model, _opt_cfgs()[1], donate=True)
        p, o, _ = step(params, opt_state, _tb(_batches(cfg, 1)[0]))
        after = [x.untyped_storage().data_ptr() for x in _tree.leaves({"p": p, "o": o})]
        assert after == before
        assert not torch.equal(_tree.leaves(p)[0], first)      # written, in place

    def test_functional_step_leaves_its_arguments_unchanged(self):
        cfg, model, params = _donation_models(ARCH, 2, "bfloat16")
        opt_state = optimizer.init_opt_state(params)
        args = {"p": params, "o": opt_state}
        saved = _clone(args)
        step = train_step.make_train_step(model, _opt_cfgs()[1])
        p, o, _ = step(params, opt_state, _tb(_batches(cfg, 1)[0]))
        for (path, a), b in zip(_tree.flatten_with_path(args), _tree.leaves(saved)):
            assert torch.equal(a, b), path
        ptrs = {x.untyped_storage().data_ptr() for x in _tree.leaves(args)}
        assert not ptrs & {x.untyped_storage().data_ptr()
                           for x in _tree.leaves({"p": p, "o": o})}

    def test_trainer_matches_the_jitted_donated_reference(self, run):
        """``Trainer`` (which donates) for three steps from the reference's
        initial parameters against ``jax.jit(make_train_step(...),
        donate_argnums=(0, 1))``, at this file's limits."""
        from repro_torch.train.loop import LoopConfig, Trainer

        cfg, jm, jp, pm, pp = _models()
        jopt, opt = _opt_cfgs()
        batches = _batches(cfg, STEPS)
        jstep = jax.jit(ref_step.make_train_step(jm, jopt), donate_argnums=(0, 1))
        js = jax.tree.map(jnp.array, jp)
        jo = ref_opt.init_opt_state(js)
        jl = []
        for b in batches:
            js, jo, jmet = jstep(js, jo, _jb(b))
            jl.append(float(jmet["loss"]))
        trainer = Trainer(pm, iter(batches), LoopConfig(total_steps=STEPS, log_every=100),
                          opt, log_fn=lambda s: None)
        trainer.init_state = lambda seed=0: (pp, optimizer.init_opt_state(pp))
        out = trainer.run()
        assert out["params"] is pp                    # updated in place
        assert abs(out["losses"][0] - jl[0]) <= 1e-5 * abs(jl[0])
        for got, want in zip(out["losses"][1:], jl[1:]):
            assert abs(got - want) <= 1e-4
        _assert_three_steps_close(out["params"], _port_tree(js, cfg), run["grads"])

    @pytest.mark.parametrize("microbatches", [1, 2])
    def test_counted_peak_drops_by_the_f32_state(self, microbatches):
        """``roofline.op_cost``'s counted peak of one step of rwkv6-3b at
        full width and 8 of its 32 layers (bf16, on ``meta`` tensors, 16
        tokens a microbatch, so that the state outweighs the activations).  The functional step
        holds the old and the new params and f32 state at its update: 30 B
        a parameter, 32 with the f32 accumulator.  The donated step's is
        lower by at least the f32 master, m and v, 12 B a parameter; with
        microbatches its peak moves to the last one's accumulation, where
        one leaf's two f32 temporaries (its cast and its share, 8 B of the
        largest leaf's parameters) stand beside the bf16 gradient."""
        from repro_torch.roofline.op_cost import measure

        cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=8,
                                  microbatches=microbatches)
        model = build_model(cfg, max_pos=64, device="cpu", use_kernel=False)
        params = model.abstract_params()
        batch = {k: torch.empty((microbatches, 16), dtype=torch.int64, device="meta")
                 for k in ("tokens", "labels")}
        sizes = [x.numel() for x in _tree.leaves(params)]
        n = sum(sizes)
        peaks = {}
        for donate in (False, True):
            step = train_step.make_train_step(model, donate=donate)
            _, counter = measure(step, params, optimizer.init_opt_state(params), batch)
            peaks[donate] = counter.peak
        assert n > 1e9
        assert peaks[False] >= (30 if microbatches == 1 else 32) * n
        drop = 12 * n - (0 if microbatches == 1 else 8 * max(sizes))
        assert peaks[False] - peaks[True] >= drop, (peaks, n)


class TestBridge:
    def test_params_round_trip_exactly(self, run):
        cfg, pp = run["cfg"], run["pp"]
        tree = params_to_jax(pp, cfg)
        back = params_from_jax(tree, cfg, "cpu")
        for a, b in zip(_tree.leaves(pp), _tree.leaves(back)):
            assert torch.equal(a, b)

    def test_params_to_jax_is_the_reference_tree(self):
        _, _, jp, _, pp = _models()
        cfg = reduce_config(get_config(ARCH))
        got = params_to_jax(pp, cfg)
        assert jax.tree.structure(got) == jax.tree.structure(jp)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(a, np.asarray(b))

    def test_bf16_leaves_round_trip_bit_for_bit(self):
        cfg = dataclasses.replace(reduce_config(get_config(ARCH)), dtype="bfloat16")
        pm = build_model(cfg, max_pos=64, device="cpu")
        pp = pm.init_params(torch.Generator().manual_seed(0))
        tree = params_to_jax(pp, cfg)
        assert jax.tree.leaves(tree)[0].dtype.name == "bfloat16"
        for a, b in zip(_tree.leaves(pp), _tree.leaves(params_from_jax(tree, cfg, "cpu"))):
            assert a.dtype == b.dtype == torch.bfloat16
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))

    def test_opt_state_round_trip(self, run):
        cfg = run["cfg"]
        tree = opt_state_to_jax(run["opt"], cfg)
        assert jax.tree.structure(tree) == jax.tree.structure(run["jopt"])
        back = opt_state_from_jax(tree, cfg, "cpu")
        for a, b in zip(_tree.leaves(run["opt"]), _tree.leaves(back)):
            assert torch.equal(a, b)


class TestCopies:
    """``data.pipeline`` and ``distributed.fault`` are copies of the
    reference's numpy-only modules: every observable equal."""

    def test_batch_iterator_equal(self):
        a = ref_pipeline.make_batch_iterator(512, 16, 4, seed=5)
        b = pipeline.make_batch_iterator(512, 16, 4, seed=5)
        for _ in range(3):
            x, y = next(a), next(b)
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])

    def test_sharded_loader_equal(self):
        kw = dict(vocab_size=300, seq_len=8, global_batch=4, num_shards=12, num_hosts=3,
                  seed=2)
        a = ref_pipeline.ShardedLoader(ref_pipeline.DataConfig(**kw), host_id=1)
        b = pipeline.ShardedLoader(pipeline.DataConfig(**kw), host_id=1)
        assert a.my_shards == b.my_shards and a.host_batch == b.host_batch
        ia, ib = iter(a), iter(b)
        for _ in range(3):
            x, y = next(ia), next(ib)
            np.testing.assert_array_equal(x["tokens"], y["tokens"])
        a.close()
        b.close()

    def test_fault_planning_equal(self):
        devs = dict(pods=2, data=4, model=2, failed=frozenset({(0, 1, 1), (1, 3, 0)}))
        assert fault.plan_elastic_mesh(fault.DeviceSet(**devs)) == \
            ref_fault.plan_elastic_mesh(ref_fault.DeviceSet(**devs))
        homes = np.arange(40) % 8
        a = ref_fault.rebuild_schedule(homes, np.ones(40), 8, 5)
        b = fault.rebuild_schedule(homes, np.ones(40), 8, 5)
        assert [list(x) for x in a.lists] == [list(x) for x in b.lists]
        assert (a.locality_fraction, a.imbalance, a.moved) == \
            (b.locality_fraction, b.imbalance, b.moved)
        with pytest.raises(RuntimeError):
            fault.plan_elastic_mesh(fault.DeviceSet(pods=1, data=1, model=2,
                                                    failed=frozenset({(0, 0, 0)})))

    def test_straggler_monitor_equal(self):
        ma, mb = ref_fault.StragglerMonitor(4), fault.StragglerMonitor(4)
        for t in ([1, 1, 1, 2], [1, 1.1, 1, 2.5], [1, 1, 1, 1.9]):
            ra, rb = ma.update(t), mb.update(t)
            assert ra["stragglers"] == rb["stragglers"]
            assert ra["shed_fraction"] == rb["shed_fraction"]

    def test_same_public_names(self):
        for ref, port in ((ref_pipeline, pipeline), (ref_fault, fault)):
            names = lambda m: sorted(n for n in vars(m) if not n.startswith("_")
                                     and getattr(getattr(m, n), "__module__", m.__name__)
                                     == m.__name__)
            assert names(port) == names(ref)


def _run(args, capsys, monkeypatch):
    """Run a script (``path.py ...``) or module (``-m name ...``) in this
    process, as ``python`` would, and return what it printed."""
    monkeypatch.chdir(ROOT)
    if args[0] == "-m":
        monkeypatch.setattr(sys, "argv", [args[1], *args[2:]])
        runpy.run_module(args[1], run_name="__main__", alter_sys=True)
    else:
        monkeypatch.setattr(sys, "argv", list(args))
        runpy.run_path(str(ROOT / args[0]), run_name="__main__")
    return capsys.readouterr().out


class TestEntryPoints:
    def test_launch_train_smoke_cpu(self, tmp_path, capsys, monkeypatch):
        out = _run(["-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
                    "--steps", "4", "--batch", "2", "--seq", "16", "--device", "cpu",
                    "--ckpt", str(tmp_path / "ck"), "--ckpt-every", "2"], capsys, monkeypatch)
        lines = out.strip().splitlines()
        assert re.fullmatch(r"first-10 mean loss: \d+\.\d{4}", lines[-2])
        assert re.fullmatch(r"last-10  mean loss: \d+\.\d{4}", lines[-1])
        assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
            ["step_00000002", "step_00000004"]

    @pytest.mark.parametrize("example,args,expect", [
        ("torch_train_100m.py", ["--steps", "2", "--batch", "2", "--seq", "16",
                                 "--ckpt", ""], r"loss: first-1 mean"),
        ("torch_elastic_failover.py", ["--steps", "8", "--ckpt", "{tmp}"],
         r"elastic failover complete"),
        ("torch_quickstart.py", ["--steps", "3"], r"locality fraction"),
    ])
    def test_example_twin_cpu(self, tmp_path, capsys, monkeypatch, example, args, expect):
        args = [a.replace("{tmp}", str(tmp_path / "ck")) for a in args]
        out = _run([f"examples/{example}", "--device", "cpu", *args], capsys, monkeypatch)
        assert re.search(expect, out), out[-2000:]

    def test_new_modules_import_neither_jax_nor_repro(self):
        bad = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
        files = [p for d in ("train", "checkpoint", "data", "distributed")
                 for p in sorted((ROOT / "src" / "repro_torch" / d).glob("*.py"))]
        files += [ROOT / "src/repro_torch/launch/train.py", ROOT / "src/repro_torch/_tree.py",
                  ROOT / "src/repro_torch/models/convert.py"]
        files += sorted((ROOT / "examples").glob("torch_*.py"))
        assert len(files) >= 14
        assert [str(p.relative_to(ROOT)) for p in files if bad.search(p.read_text())] == []


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3's backward has no CPU mode)")
    return torch.device("cuda")


def _grad_inputs(dev, b, hq, hkv, tq, tk, hd, dtype, seed=0):
    """q, k, v as the model's (B, T, H, hd) transposed views and dO, numpy-seeded."""
    rng = np.random.default_rng(seed)
    mk = lambda h, t: torch.from_numpy(
        rng.standard_normal((b, t, h, hd)).astype(np.float32)).to(dev, dtype).transpose(1, 2)
    return mk(hq, tq), mk(hkv, tk), mk(hkv, tk), mk(hq, tq)


def _plain_grads(q, k, v, do, **mask):
    from repro_torch.kernels.flash_attention.ref import mha_ref
    leaves = [x.float().detach().requires_grad_(True) for x in (q, k, v)]
    out = mha_ref(*leaves, **mask)
    return torch.autograd.grad(out, leaves, do.float())


# phase 7a's shapes of chip_smoke.py: b, hq, hkv, tq, tk, hd, causal, window, q_offset
BWD_CASES = [(2, 14, 2, 1024, 1024, 64, True, 0, 0),      # qwen2-0.5b's training shape, cut to B 2
             (1, 32, 4, 1024, 1024, 128, True, 0, 0),     # qwen3-moe
             (1, 4, 1, 1024, 1024, 256, True, 512, 0),    # gemma3-1b's window
             (1, 8, 8, 1536, 1536, 64, False, 0, 0),      # whisper's encoder, no mask
             (1, 8, 8, 128, 1536, 64, False, 0, 0),       # cross, Tq != Tk
             (1, 4, 2, 77, 333, 64, True, 40, 256)]       # ragged, windowed, offset


def _limit_share(got, want, dtype):
    mx = float(want.abs().max())
    lim = (1e-4 * mx if dtype == torch.float32
           else 2 ** -7 * want.abs() + 2 ** -8 * mx)
    return float(((got.float() - want).abs() / lim).max())


@pytest.mark.cuda
class TestK3BackwardOnCard:
    """K3's backward kernel per element against autograd of ``mha_ref`` on
    f32 copies: 1e-4 of the largest |ref| in f32; 2^-7 |ref| + 2^-8 max|ref|
    in bf16 (the gradient is rounded once to bf16)."""

    @pytest.mark.parametrize("case", BWD_CASES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_against_plain_autograd(self, cuda, case, dtype):
        from repro_torch.kernels.flash_attention.kernel import flash_attention_backward
        b, hq, hkv, tq, tk, hd, causal, window, qo = case
        q, k, v, do = _grad_inputs(cuda, b, hq, hkv, tq, tk, hd, dtype)
        mask = dict(causal=causal, window=window, q_offset=qo)
        got = flash_attention_backward(q, k, v, do, **mask)
        want = _plain_grads(q, k, v, do, **mask)
        torch.cuda.synchronize()
        for g, w, x in zip(got, want, (q, k, v)):
            assert g.shape == x.shape and g.dtype == dtype
            assert _limit_share(g, w, dtype) <= 1.0

    def test_planted_faults_exceed_the_limit(self, cuda):
        from repro_torch.kernels.flash_attention.kernel import flash_attention_backward
        from repro_torch.kernels.flash_attention.ref import mha_ref
        q, k, v, do = _grad_inputs(cuda, 1, 14, 2, 512, 512, 64, torch.float32)
        dq, dk, _ = flash_attention_backward(q, k, v, do)
        # dK summed over one head of the group
        leaves = [x.detach().requires_grad_(True) for x in
                  (q, k.repeat_interleave(7, 1), v.repeat_interleave(7, 1))]
        gk = torch.autograd.grad(mha_ref(*leaves), leaves[1], do)[0]
        assert _limit_share(dk, gk[:, ::7], torch.float32) > 1.0
        # the mask dropped in dQ
        assert _limit_share(dq, _plain_grads(q, k, v, do, causal=False)[0],
                            torch.float32) > 1.0

    def test_repeat_is_bit_identical(self, cuda):
        from repro_torch.kernels.flash_attention.kernel import flash_attention_backward
        q, k, v, do = _grad_inputs(cuda, 2, 14, 2, 1024, 1024, 64, torch.bfloat16)
        a = flash_attention_backward(q, k, v, do)
        b = flash_attention_backward(q, k, v, do)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    @pytest.mark.parametrize("case", BWD_CASES)
    def test_forward_with_stats_keeps_the_bits(self, cuda, case):
        """The statistics K3's forward writes for its backward change none of
        o's bits; lse is each row's log-sum-exp, o32 is o before rounding."""
        from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                                 forward_with_stats)
        b, hq, hkv, tq, tk, hd, causal, window, qo = case
        q, k, v, _ = _grad_inputs(cuda, b, hq, hkv, tq, tk, hd, torch.bfloat16)
        mask = dict(causal=causal, window=window, q_offset=qo)
        out, lse, o32 = forward_with_stats(q, k, v, **mask)
        assert torch.equal(out, flash_attention(q, k, v, bq=tq, bk=tk, **mask))
        assert torch.equal(out, o32.to(torch.bfloat16))
        qf, kf = q.float(), k.float().repeat_interleave(hq // hkv, 1)
        s = qf @ kf.transpose(-1, -2) * hd ** -0.5
        t, key = torch.arange(tq, device=cuda)[:, None] + qo, torch.arange(tk, device=cuda)
        if causal:
            seen = key <= t
            if window:
                seen &= key > t - window
            s = s.masked_fill(~seen, float("-inf"))
        torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0, atol=1e-5)

    def test_autograd_function_counts_one_of_each(self, cuda):
        from repro_torch.kernels.flash_attention import kernel
        q, k, v, do = _grad_inputs(cuda, 1, 14, 2, 128, 128, 64, torch.bfloat16)
        q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
        kernel.flash_attention.launches = kernel.flash_attention_backward.launches = 0
        out = kernel.FlashAttentionFn.apply(q, k, v, True, 0, 0)
        out.backward(do)
        assert (kernel.flash_attention.launches,
                kernel.flash_attention_backward.launches) == (1, 1)
        want = _plain_grads(q, k, v, do)
        for g, w in zip((q.grad, k.grad, v.grad), want):
            assert _limit_share(g, w, torch.bfloat16) <= 1.0


# K4's backward against autograd of wkv6_ref, per element: WKV_BWD_REL of
# the largest |ref| of each gradient (chip_smoke.py's limit, fixed from the
# first reading on the card: 0.994 of 1e-5 at worst), plus one bf16 ulp
# (2^-7 |ref|) for the bf16 gradients (dr, dk, dv of bf16 inputs), which
# both round once from f32 sums taken in other orders; K5's backward bit
# for bit
WKV_BWD_REL = 3e-5
# b, t, h, hd: either side of the backward's 8-step sub-chunk, K4's
# 128-step time chunk and every compiled head dim; then either side of the
# backward's time chunk C (BWD_CHUNK, 64) and past two of them, B 2 for
# du's order over batch rows and chunks
_C = 64
WKV_BWD_CASES = [(1, 1, 2, 64), (2, 17, 2, 64), (1, 130, 3, 32), (1, 40, 2, 16),
                 (1, 33, 1, 8), (2, _C - 1, 2, 64), (2, _C, 2, 64), (2, _C + 1, 2, 64),
                 (2, 2 * _C + 17, 2, 64), (2, 2 * _C + 17, 3, 16)]
# b, t, w: either side of K5's 32-step stage, and a width off 4 (4-byte copies)
RGLRU_BWD_CASES = [(1, 1, 64), (2, 31, 64), (1, 33, 96), (2, 100, 67)]


def _wkv_grad_inputs(dev, b, t, h, hd, dtype, decay=0.0, seed=0):
    """r, k, v (``dtype``), w = exp(-exp(decay + noise)), u, s0, do, dsT."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)
    r, k, v = (f(b, t, h, hd, scale=sc).to(dtype) for sc in (1.0, 0.3, 0.3))
    w = torch.exp(-torch.exp(decay + f(b, t, h, hd, scale=0.5)))
    return r, k, v, w, f(h, hd, scale=0.3), f(b, h, hd, hd, scale=0.3), f(b, t, h, hd), \
        f(b, h, hd, hd)


def _wkv_plain_grads(r, k, v, w, u, s0, do, dsT):
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    leaves = [x.detach().requires_grad_(True) for x in (r, k, v, w, u, s0)]
    o, st = wkv6_ref(*leaves)
    return torch.autograd.grad((o, st), leaves, (do, dsT))


def _wkv_share(got, want):
    """The largest |got - want| over its limit (see WKV_BWD_REL)."""
    worst = 0.0
    for g, x in zip(got, want):
        x32 = x.float()
        lim = WKV_BWD_REL * max(float(x32.abs().max()), 1e-30) + \
            (2 ** -7 * x32.abs() if x.dtype == torch.bfloat16 else 0.0)
        worst = max(worst, float(((g.float() - x32).abs() / lim).max()))
    return worst


@pytest.mark.cuda
class TestGradientsOnCard:
    def test_other_kernels_refuse_a_gradient(self, cuda):
        from repro_torch.kernels.jacobi.kernel import jacobi_sweep_cuda
        from repro_torch.kernels.jacobi.temporal import jacobi_two_step_cuda
        f = torch.randn(20, 20, 20, device=cuda, requires_grad=True)
        with pytest.raises(RuntimeError, match="jacobi_sweep_cuda.*ROADMAP"):
            jacobi_sweep_cuda(f)
        with pytest.raises(RuntimeError, match="jacobi_two_step_cuda.*ROADMAP"):
            jacobi_two_step_cuda(f)
        with torch.no_grad():                        # no gradient asked: they run
            jacobi_sweep_cuda(f)

    @pytest.mark.parametrize("case", WKV_BWD_CASES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("decay", [-8.0, 0.0, 4.0])     # w near 1, mid, near 0
    def test_wkv6_backward_against_plain_autograd(self, cuda, case, dtype, decay):
        from repro_torch.kernels.rwkv6.kernel import wkv6_backward
        r, k, v, w, u, s0, do, dsT = _wkv_grad_inputs(cuda, *case, dtype, decay)
        got = wkv6_backward(r, k, v, w, u, s0, do, dsT)
        want = _wkv_plain_grads(r, k, v, w, u, s0, do, dsT)
        torch.cuda.synchronize()
        for g, x in zip(got, (r, k, v, w, u, s0)):
            assert g.shape == x.shape and g.dtype == x.dtype
        assert _wkv_share(got, want) <= 1.0

    def test_wkv6_fn_counts_repeats_and_leaves_s0(self, cuda):
        from repro_torch.kernels.rwkv6 import kernel, ops
        r, k, v, w, u, s0, do, dsT = _wkv_grad_inputs(cuda, 2, 150, 2, 64, torch.bfloat16)
        leaves = [x.detach().requires_grad_(True) for x in (r, k, v, w, u, s0)]
        before = s0.clone()
        kernel.wkv6_cuda.launches = kernel.wkv6_backward.launches = 0
        o, st = ops.wkv6(*leaves[:5], s0=leaves[5])
        with torch.no_grad():
            o_serving, _ = ops.wkv6(r, k, v, w, u, s0=s0.clone())
        assert torch.equal(o, o_serving)                 # the forward's bits
        assert torch.equal(leaves[5].detach(), before) and st is not leaves[5]
        grads = torch.autograd.grad((o, st), leaves, (do, dsT))
        assert (kernel.wkv6_cuda.launches, kernel.wkv6_backward.launches) == (2, 1)
        assert _wkv_share(grads, _wkv_plain_grads(r, k, v, w, u, s0, do, dsT)) <= 1.0
        again = kernel.wkv6_backward(r, k, v, w, u, s0, do, dsT)
        assert all(torch.equal(x, y) for x, y in zip(grads, again))

    @pytest.mark.parametrize("t", [100, 128, 129, 300])
    def test_wkv6_fn_either_side_of_the_time_chunk(self, cuda, t):
        """Through WKV6Fn, at T up to and past K4's 128-step time chunk."""
        from repro_torch.kernels.rwkv6 import kernel
        assert kernel.BWD_CHUNK == _C and kernel.TIME_CHUNK == 128
        r, k, v, w, u, s0, do, dsT = _wkv_grad_inputs(cuda, 2, t, 2, 64, torch.bfloat16, seed=t)
        leaves = [x.detach().requires_grad_(True) for x in (r, k, v, w, u, s0)]
        kernel.wkv6_cuda.launches = kernel.wkv6_backward.launches = 0
        o, st = kernel.WKV6Fn.apply(*leaves)
        grads = torch.autograd.grad((o, st), leaves, (do, dsT))
        assert (kernel.wkv6_cuda.launches, kernel.wkv6_backward.launches) == (1, 1)
        assert _wkv_share(grads, _wkv_plain_grads(r, k, v, w, u, s0, do, dsT)) <= 1.0

    def test_wkv6_planted_faults_cross_the_chunks(self, cuda):
        """Past two backward chunks: u dropped, s0 not carried in (through
        the forward carry) and dsT dropped (through the reverse carry)."""
        from repro_torch.kernels.rwkv6.kernel import wkv6_backward
        r, k, v, w, u, s0, do, dsT = _wkv_grad_inputs(cuda, 1, 2 * _C + 17, 2, 64,
                                                      torch.float32, decay=-8.0)
        got = wkv6_backward(r, k, v, w, u, s0, do, dsT)
        assert _wkv_share(got, _wkv_plain_grads(r, k, v, w, u, s0, do, dsT)) <= 1.0
        for fault in ((r, k, v, w, u * 0, s0, do, dsT), (r, k, v, w, u, s0 * 0, do, dsT),
                      (r, k, v, w, u, s0, do, dsT * 0)):
            assert _wkv_share(got, _wkv_plain_grads(*fault)) > 1.0

    def test_wkv6_planted_faults_exceed_the_limit(self, cuda):
        from repro_torch.kernels.rwkv6.kernel import wkv6_backward
        r, k, v, w, u, s0, do, dsT = _wkv_grad_inputs(cuda, 1, 40, 2, 64, torch.float32)
        got = wkv6_backward(r, k, v, w, u, s0, do, dsT)
        assert _wkv_share(got, _wkv_plain_grads(r, k, v, w, u * 0, s0, do, dsT)) > 1.0
        assert _wkv_share(got, _wkv_plain_grads(r, k, v, w, u, s0 * 0, do, dsT)) > 1.0

    @pytest.mark.parametrize("case", RGLRU_BWD_CASES)
    @pytest.mark.parametrize("with_h0", [False, True])
    def test_rglru_backward_bit_for_bit(self, cuda, case, with_h0):
        from repro_torch.kernels.rglru.kernel import rglru_scan_backward, rglru_scan_cuda
        from repro_torch.kernels.rglru.ref import rglru_scan_bwd_ref, rglru_scan_ref
        rng = np.random.default_rng(1)
        b, t, w = case
        a, bx, dh = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (
            rng.uniform(0.0, 1.0, (b, t, w)), rng.standard_normal((b, t, w)),
            rng.standard_normal((b, t, w))))
        h0 = torch.from_numpy(rng.standard_normal((b, w)).astype(np.float32)).to(cuda) \
            if with_h0 else None
        h = rglru_scan_cuda(a, bx, chunk=t, h0=h0)
        got = rglru_scan_backward(a, h, dh, h0)
        want = rglru_scan_bwd_ref(a, h, dh, h0)
        leaves = [x.detach().requires_grad_(True) for x in (a, bx)] + \
            ([h0.detach().requires_grad_(True)] if with_h0 else [])
        auto = torch.autograd.grad(rglru_scan_ref(*leaves[:2], leaves[2] if with_h0 else None),
                                   leaves, dh)
        torch.cuda.synchronize()
        assert (got[2] is None) == (not with_h0)
        for g, x, y in zip(got, want, auto):
            assert torch.equal(g, x) and torch.equal(g, y)

    def test_rglru_fn_counts_and_repeats(self, cuda):
        from repro_torch.kernels.rglru import kernel, ops
        rng = np.random.default_rng(2)
        a, bx, dh = (torch.from_numpy(rng.uniform(0.1, 1.0, (1, 70, 128)).astype(np.float32))
                     .to(cuda) for _ in range(3))
        leaves = [x.detach().requires_grad_(True) for x in (a, bx)]
        kernel.rglru_scan_cuda.launches = kernel.rglru_scan_backward.launches = 0
        h = ops.rglru_scan(*leaves)
        with torch.no_grad():
            assert torch.equal(h, ops.rglru_scan(a, bx))
        da, db = torch.autograd.grad(h, leaves, dh)
        assert (kernel.rglru_scan_cuda.launches, kernel.rglru_scan_backward.launches) == (2, 1)
        again = kernel.rglru_scan_backward(a, h.detach(), dh)
        assert torch.equal(da, again[0]) and torch.equal(db, again[1])

    def test_rglru_planted_faults_differ(self, cuda):
        """The bit-for-bit check catches a shifted decay and a shifted state."""
        from repro_torch.kernels.rglru.kernel import rglru_scan_backward, rglru_scan_cuda
        rng = np.random.default_rng(3)
        a, bx, dh = (torch.from_numpy(rng.uniform(0.1, 1.0, (1, 50, 64)).astype(np.float32))
                     .to(cuda) for _ in range(3))
        h = rglru_scan_cuda(a, bx, chunk=50)
        da, db, _ = rglru_scan_backward(a, h, dh)
        g, shifted_g = dh.clone(), dh.clone()
        for i in range(48, -1, -1):
            g[:, i] = dh[:, i] + a[:, i + 1] * g[:, i + 1]
            shifted_g[:, i] = dh[:, i] + a[:, i] * shifted_g[:, i + 1]    # a_t for a_{t+1}
        assert torch.equal(db, g) and not torch.equal(db, shifted_g)
        assert not torch.equal(da, g * h)                                  # h_t for h_{t-1}

    def test_loss_gradient_reaches_every_attention_projection(self, cuda):
        cfg = dataclasses.replace(get_config(ARCH), num_layers=2)
        model = build_model(cfg, device=cuda)
        params = model.init_params(torch.Generator(device=cuda).manual_seed(0))
        rng = np.random.default_rng(0)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 129)), device=cuda)
        flat = [p.detach().requires_grad_(True) for p in _tree.leaves(params)]
        tree = _tree.unflatten(params, flat)
        loss, _ = model.loss_fn(tree, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        grads = dict(zip([path for path, _ in _tree.flatten_with_path(params)],
                         torch.autograd.grad(loss, flat, allow_unused=True)))
        for layer in range(cfg.num_layers):
            for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
                g = grads[f"stack/{layer}/attn/{name}"]
                assert g is not None and bool(torch.isfinite(g).all()) and \
                    float(g.abs().max()) > 0, (layer, name)

    def test_serving_call_launches_as_before(self, cuda):
        """No grad asked: the attention block calls K3 directly, the same
        bits as ``flash_attention`` and no backward."""
        from repro_torch.kernels.flash_attention import kernel
        from repro_torch.models.attention import _kernel_attention
        rng = np.random.default_rng(1)
        q, k, v = (torch.from_numpy(rng.standard_normal((1, 200, h, 64)).astype(np.float32))
                   .to(cuda, torch.bfloat16) for h in (14, 2, 2))
        kernel.flash_attention.launches = kernel.flash_attention_backward.launches = 0
        got = _kernel_attention(q, k, v, causal=True, q_offset=0)
        want = kernel.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), bq=200, bk=200)
        assert torch.equal(got, want.transpose(1, 2).reshape(1, 200, 14 * 64))
        assert got.grad_fn is None
        assert (kernel.flash_attention.launches,
                kernel.flash_attention_backward.launches) == (2, 0)
