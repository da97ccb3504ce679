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

from repro import trace as rtrace
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.launch import serve as jax_serve
from repro.models.model import build_model as jax_build_model
from repro.serving import engine as jax_engine
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
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
        _, _, _, pm, pp = models
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            ServingEngine(pm, pp, device="cpu", **{kwarg: object()})

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
