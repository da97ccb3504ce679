"""The port's serving engine (``repro_torch.serving.engine``) and its driver
(``repro_torch.launch.serve``) held against the JAX package on the CPU.

Both engines serve the same reduced model, qwen2-0.5b, rwkv6-3b or
recurrentgemma-9b (the tests against the reference take the architecture
as a parameter; recurrentgemma-9b's 16-slot ring wraps in the longer
requests), with
the same parameters (the reference's, carried across by
``params_from_jax``) and the same requests (numpy draws).  The scheduler is the same code in both packages, so
``ServeStats`` and recorded traces must be equal, and greedy decoding of
f32 logits that agree to 1e-4 must pick exactly the same tokens.  Also
mirrors ``tests/test_serving.py`` on the port alone.
"""
import contextlib
import dataclasses
import functools
import io
import sys

import jax
import numpy as np
import pytest
import torch

from repro import spec as jax_spec
from repro import trace as rtrace
from repro.control import ControlLoop as JaxControlLoop
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.launch import serve as jax_serve
from repro.models.model import build_model as jax_build_model
from repro.serving import engine as jax_engine
from repro_torch import spec as port_spec
from repro_torch import trace as port_trace
from repro_torch.configs import get_config, reduce_config
from repro_torch.control import ControlLoop
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.runtime import Executor
from repro_torch.serving.engine import POLICIES, Request, ServingEngine


ARCHS = ["qwen2-0.5b", "rwkv6-3b", "recurrentgemma-9b"]


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(cfg, JAX model, JAX params, port model, port params), reduced."""
    cfg = reduce_config(get_config(arch))
    jm = jax_build_model(jax_reduce_config(jax_get_config(arch)), max_pos=96)
    jp = jm.init_params(jax.random.key(0))
    pm = build_model(cfg, max_pos=96, device="cpu")
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jm, jp, pm, pp


@pytest.fixture(scope="module")
def models():
    return _models("qwen2-0.5b")


def _requests(cls, cfg, n=8, replicas=2, seed=0, max_new=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size, size=int(rng.integers(6, 14)))
        home = int(rng.integers(0, replicas)) if rng.random() < 0.7 else -1
        out.append(cls(uid=i, tokens=toks, max_new=max_new, home_replica=home))
    return out


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained()
    return {r.uid: list(r.out_tokens) for r in done}, engine.stats


class TestAgainstReference:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("replicas,batch,seed", [(2, 1, 0), (3, 2, 5)])
    def test_same_tokens_and_stats(self, arch, policy, replicas, batch, seed):
        cfg, jm, jp, pm, pp = _models(arch)
        kw = dict(num_replicas=replicas, max_seq=64, policy=policy, batch=batch)
        want, wstats = _serve(jax_engine.ServingEngine(jm, jp, **kw),
                              _requests(jax_engine.Request, cfg, 10, replicas, seed))
        got, gstats = _serve(ServingEngine(pm, pp, device="cpu", **kw),
                             _requests(Request, cfg, 10, replicas, seed))
        assert got == want
        assert dataclasses.asdict(gstats) == dataclasses.asdict(wstats)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_recorded_traces_agree(self, arch):
        cfg, jm, jp, pm, pp = _models(arch)
        traces = []
        for eng, cls in ((jax_engine.ServingEngine(jm, jp, num_replicas=2, max_seq=64,
                                                   trace=rtrace.TraceRecorder()),
                          jax_engine.Request),
                         (ServingEngine(pm, pp, num_replicas=2, max_seq=64,
                                        trace=rtrace.TraceRecorder(), device="cpu"),
                          Request)):
            _serve(eng, _requests(cls, cfg, 8, seed=3))
            traces.append(eng.trace.finish())
        want, got = traces
        assert got.n_tasks == want.n_tasks == 8
        assert got.stats == want.stats
        assert got.submissions == want.submissions


def _serving_spec(pkg, policy="locality", replicas=2, record=False):
    """``controlled_serving`` of ``pkg``'s spec package, with the serving
    block's policy and replica count (and domains to match) replaced; a
    policy that routes explicitly drops the cost router."""
    s = pkg.named("controlled_serving")
    s = dataclasses.replace(
        s, num_domains=1 if policy == "single_queue" else replicas,
        serving=dataclasses.replace(s.serving, policy=policy, num_replicas=replicas),
        trace=pkg.TraceSpec(record=record))
    if policy != "locality":
        s = dataclasses.replace(s, router=pkg.RouterSpec(kind="none"))
    return s


class TestSpecAndControl:
    """``tests/test_spec.py``'s engine cases and ``tests/test_control.py``'s
    serving cases, on the port, and the controlled and spec-built engines
    against the JAX package's."""

    def test_engine_requires_serving_block(self, models):
        _, _, _, pm, pp = models
        with pytest.raises(port_spec.SpecError, match="serving"):
            port_spec.named("paper_cyclic").build_engine(pm, pp, device="cpu")

    def test_engine_rejects_domain_mismatch(self, models):
        _, _, _, pm, pp = models
        bad = dataclasses.replace(port_spec.named("controlled_serving"), num_domains=3)
        with pytest.raises(port_spec.SpecError, match="num_domains"):
            bad.build_engine(pm, pp, device="cpu")

    def test_engine_rejects_pinned_workers_mismatch(self, models):
        _, _, _, pm, pp = models
        bad = dataclasses.replace(port_spec.named("controlled_serving"),
                                  worker_domains=(0, 1, 1))
        with pytest.raises(port_spec.SpecError, match="worker_domains"):
            bad.build_engine(pm, pp, device="cpu")

    def test_engine_rejects_router_bypassed_by_policy(self, models):
        _, _, _, pm, pp = models
        s = port_spec.named("controlled_serving")      # router.kind == "cost"
        bad = dataclasses.replace(
            s, serving=dataclasses.replace(s.serving, policy="round_robin"))
        with pytest.raises(port_spec.SpecError, match="bypass"):
            bad.build_engine(pm, pp, device="cpu")

    @pytest.mark.parametrize("kwarg,value", [
        ("batch", 4), ("num_replicas", 4), ("max_seq", 256),
        ("policy", "round_robin"), ("pool_cap", 16), ("control", "loop")])
    def test_engine_rejects_conflicting_kwargs(self, models, kwarg, value):
        """Every spec-superseded raw kwarg is refused, not silently ignored;
        the port's ``device`` stays allowed beside ``spec``."""
        _, _, _, pm, pp = models
        if value == "loop":
            value = ControlLoop.full()
        with pytest.raises(port_spec.SpecError, match=kwarg):
            port_spec.named("controlled_serving").build_engine(
                pm, pp, device="cpu", **{kwarg: value})

    def test_spec_declared_recording(self, models):
        cfg, _, _, pm, pp = models
        s = _serving_spec(port_spec, record=True)
        eng = ServingEngine(pm, pp, spec=s, device="cpu")
        assert eng.trace is not None
        _serve(eng, _requests(Request, cfg, 6, seed=2))
        t = eng.trace.finish()
        assert t.n_tasks == 6
        res = port_trace.replay(t, assert_match=True)     # the header's spec alone
        assert res.matches_recorded
        with pytest.raises(port_spec.SpecError, match="trace="):
            ServingEngine(pm, pp, spec=s, trace=port_trace.TraceRecorder(), device="cpu")

    def test_spec_built_engine_schedule_matches_raw(self):
        """The spec path wires the executor the raw kwargs do: the same
        routing and steal schedule on the same submissions (no model)."""
        def drive_exec(ex):
            for i in range(24):
                home = 0 if i % 4 else 1
                ex.submit(ex.make_task(home=home, cost=float(4 + i % 5)))
                ex.step()
            ex.run_until_drained()
            return ex.metrics.snapshot()

        base = dataclasses.replace(
            port_spec.named("controlled_serving"),
            governor=port_spec.GovernorSpec(kind="greedy"),
            router=port_spec.RouterSpec(kind="none"), batch=port_spec.BatchSpec())
        raw = Executor(2, [0, 1], steal_order="longest",
                       steal_penalty=port_spec.build_penalty(base.penalty),
                       pool_cap=256, seed=0)
        assert drive_exec(base.build().executor) == drive_exec(raw)

    def test_batched_outputs_token_identical_all_policies(self, models):
        cfg, _, _, pm, pp = models
        for policy in POLICIES:
            outs = {}
            for batch in (1, 3):
                eng = ServingEngine(pm, pp, num_replicas=2, max_seq=64, policy=policy,
                                    batch=batch, device="cpu")
                got, stats = _serve(eng, _requests(Request, cfg, max_new=3))
                assert stats.served == 8
                outs[batch] = got
            assert outs[1] == outs[3], policy

    @pytest.mark.parametrize("seed", [4, 7])
    def test_controlled_engine_matches_reference(self, models, seed):
        """``ControlLoop.full(batch_cap=4)`` on both engines: the JAX
        engine's tokens and ``ServeStats``, and the uncontrolled tokens."""
        cfg, jm, jp, pm, pp = models
        kw = dict(num_replicas=2, max_seq=64, policy="locality")
        want, wstats = _serve(jax_engine.ServingEngine(
            jm, jp, control=JaxControlLoop.full(batch_cap=4), **kw),
            _requests(jax_engine.Request, cfg, seed=seed, max_new=3))
        eng = ServingEngine(pm, pp, control=ControlLoop.full(batch_cap=4), device="cpu", **kw)
        got, gstats = _serve(eng, _requests(Request, cfg, seed=seed, max_new=3))
        base, _ = _serve(ServingEngine(pm, pp, device="cpu", **kw),
                         _requests(Request, cfg, seed=seed, max_new=3))
        assert got == want == base
        assert dataclasses.asdict(gstats) == dataclasses.asdict(wstats)
        assert eng.runtime.router is not None and eng.control is not None

    @pytest.mark.parametrize("policy,replicas", [("locality", 2), ("locality", 3),
                                                 ("round_robin", 2),
                                                 ("single_queue", 2)])
    def test_spec_built_engine_matches_reference(self, models, policy, replicas):
        """The same spec in both packages: the JAX engine's tokens, stats and
        recorded trace (line for line), and the tokens of the raw engine."""
        cfg, jm, jp, pm, pp = models
        traces = []
        for spec_pkg, trace_pkg, eng_cls, req_cls, m, p, kw in (
                (jax_spec, rtrace, jax_engine.ServingEngine, jax_engine.Request,
                 jm, jp, {}),
                (port_spec, port_trace, ServingEngine, Request, pm, pp,
                 {"device": "cpu"})):
            rec = trace_pkg.TraceRecorder()
            eng = eng_cls(m, p, spec=_serving_spec(spec_pkg, policy, replicas),
                          trace=rec, **kw)
            traces.append(_serve(eng, _requests(req_cls, cfg, 10, replicas, seed=5,
                                                max_new=3))
                          + (trace_pkg.dumps_lines(rec.finish()),))
        (want, wstats, wlines), (got, gstats, glines) = traces
        raw, _ = _serve(ServingEngine(pm, pp, num_replicas=replicas, max_seq=128,
                                      policy=policy, device="cpu"),
                        _requests(Request, cfg, 10, replicas, seed=5, max_new=3))
        assert got == want == raw
        assert dataclasses.asdict(gstats) == dataclasses.asdict(wstats)
        assert glines == wlines
        for trace_pkg in (rtrace, port_trace):
            assert trace_pkg.replay(trace_pkg.loads_lines(glines)).matches_recorded


class TestPortEngine:
    """``tests/test_serving.py``, on the port."""

    def test_outputs_identical_across_policies(self, models):
        cfg, _, _, pm, pp = models
        outs = {p: _serve(ServingEngine(pm, pp, num_replicas=2, max_seq=64, policy=p,
                                        device="cpu"), _requests(Request, cfg))[0]
                for p in POLICIES}
        assert outs["locality"] == outs["round_robin"] == outs["single_queue"]

    def test_locality_policy_maximizes_local_fraction(self, models):
        cfg, _, _, pm, pp = models
        stats = {p: _serve(ServingEngine(pm, pp, num_replicas=2, max_seq=64, policy=p,
                                         device="cpu"),
                           _requests(Request, cfg, n=12, seed=2))[1]
                 for p in ("locality", "round_robin")}
        assert stats["locality"].locality_fraction >= \
            stats["round_robin"].locality_fraction

    def test_steal_happens_under_skewed_load(self, models):
        cfg, _, _, pm, pp = models
        eng = ServingEngine(pm, pp, num_replicas=2, max_seq=64, device="cpu")
        rng = np.random.default_rng(1)
        for i in range(6):
            toks = rng.integers(0, cfg.vocab_size, size=8)
            eng.submit(Request(uid=i, tokens=toks, max_new=2, home_replica=0))
        eng.run_until_drained()
        assert eng.stats.stolen > 0 and eng.stats.served == 6

    def test_trace_hook_records_replayable_router_trace(self, models):
        cfg, _, _, pm, pp = models
        rec = rtrace.TraceRecorder()
        eng = ServingEngine(pm, pp, num_replicas=2, max_seq=64, trace=rec, device="cpu")
        _serve(eng, _requests(Request, cfg, n=8, seed=3))
        t = rec.finish()
        assert t.n_tasks == 8 and t.stats["executed"] == eng.stats.served
        assert all(s.cost >= 1 for s in t.submissions)
        res = rtrace.replay(t, lambda tr: rtrace.executor_from_meta(
            tr, steal_penalty=lambda task, w: task.cost))
        assert res.stats["executed"] == 8

    def test_greedy_decode_matches_model(self, models):
        cfg, _, _, pm, pp = models
        toks = np.arange(7) % cfg.vocab_size
        eng = ServingEngine(pm, pp, num_replicas=1, max_seq=64, device="cpu")
        eng.submit(Request(uid=0, tokens=toks, max_new=3))
        done = eng.run_until_drained()

        caches = pm.init_cache(1, 64)
        logits, caches = pm.prefill(pp, {"tokens": torch.from_numpy(toks)[None]}, caches)
        pos, expect = len(toks), []
        cur = torch.argmax(logits[:, -1], -1)[:, None]
        for _ in range(3):
            expect.append(int(cur[0, 0]))
            logits, caches = pm.decode_step(pp, cur, pos, caches)
            cur = torch.argmax(logits[:, -1], -1)[:, None]
            pos += 1
        assert done[0].out_tokens == expect


class TestEntryPoints:
    def test_needs_a_card_unless_asked_for_cpu(self, models):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        _, _, _, pm, pp = models
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(pm, pp)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--requests", "1"])

    def test_model_on_another_device_is_refused(self, models):
        _, _, _, pm, pp = models
        with pytest.raises(ValueError, match="lives on"):
            ServingEngine(pm, pp, device="meta")

    @pytest.mark.parametrize("kwarg,item", [("spec", "B6"), ("control", "B7")])
    def test_unported_paths_raise(self, models, kwarg, item):
        """Both paths are ported now (name and cases kept from before): a
        spec with no serving block is refused with SpecError, and a control
        loop attaches to one engine's router only."""
        _, _, _, pm, pp = models
        if kwarg == "spec":
            with pytest.raises(port_spec.SpecError, match="serving"):
                ServingEngine(pm, pp, device="cpu", spec=port_spec.named("paper_cyclic"))
            return
        loop = ControlLoop.full()
        eng = ServingEngine(pm, pp, device="cpu", control=loop)
        assert eng.control is loop and eng.runtime.router is not None
        with pytest.raises(RuntimeError):
            ServingEngine(pm, pp, device="cpu", control=loop)

    def test_rejects_unknown_policy(self, models):
        _, _, _, pm, pp = models
        with pytest.raises(ValueError):
            ServingEngine(pm, pp, policy="fastest", device="cpu")

    @pytest.mark.parametrize("seed", [0, 3])
    def test_synth_requests_match_reference(self, seed):
        want = jax_serve.synth_requests(9, 500, 3, seed=seed)
        got = serve.synth_requests(9, 500, 3, seed=seed)
        assert [(r.uid, r.tokens.tolist(), r.max_new, r.home_replica) for r in got] == \
            [(r.uid, r.tokens.tolist(), r.max_new, r.home_replica) for r in want]

    @pytest.mark.parametrize("arch", ARCHS)
    def test_driver_prints_the_reference_stats(self, monkeypatch, arch):
        """The random weights differ (torch.Generator vs jax.random), so the
        tokens do too; the router's statistics line must not."""
        args = ["--arch", arch, "--requests", "6", "--replicas", "2",
                "--policy", "round_robin"]
        out = {}
        for name, run in (("jax", jax_serve.main),
                          ("port", lambda: serve.main(args + ["--device", "cpu"]))):
            monkeypatch.setattr(sys, "argv", ["serve"] + args)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                run()
            out[name] = buf.getvalue().splitlines()
        assert out["port"][-1] == out["jax"][-1]
        assert out["port"][-1].startswith("policy=round_robin served=6 ")
        assert len(out["port"]) == len(out["jax"])
