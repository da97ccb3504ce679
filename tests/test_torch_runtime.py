"""The port's runtime (``repro_torch.runtime``, a copy of ``repro.runtime``)
and its main path, ``repro_torch.stencil.jacobi.run_runtime_sweep``, held
against the JAX package: same lattice, same ``RuntimeStats``, same event
stream, and traces that the reference's replay and model checker accept.
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import repro.runtime as ref_rt
import repro_torch.runtime as port_rt
from repro import check, trace
from repro.stencil.jacobi import run_runtime_sweep as ref_sweep
from repro_torch.stencil.jacobi import run_runtime_sweep as port_sweep

ROOT = pathlib.Path(__file__).resolve().parents[1]


class _Grab:
    """Duck-typed ``trace=`` recorder that keeps the executor it is given."""

    def attach(self, ex):
        self.ex = ex
        return ex


def _events(ex):
    return [(e.step, e.kind, e.worker, e.domain, e.task_uid) for e in ex.events]


# (governor class name or None, steal_order, seed, workers_per_domain, pool_cap)
SWEEP_POLICIES = [
    (None, "cyclic", 0, 2, 256),
    ("NoSteal", "cyclic", 0, 2, 256),
    ("AdaptiveSteal", "longest", 0, 2, 256),
    (None, "random", 1, 2, 256),
    (None, "random", 7, 1, 256),
    ("GreedySteal", "cyclic", 3, 3, 2),     # tiny pool: inline runs
]


def _governor(pkg, name):
    return None if name is None else getattr(pkg, name)()


class TestRuntimeSweepParity:
    @pytest.mark.parametrize("gov,order,seed,wpd,cap", SWEEP_POLICIES)
    def test_matches_reference(self, gov, order, seed, wpd, cap):
        f = np.random.default_rng(seed).standard_normal((40, 6, 8)).astype(np.float32)
        kw = dict(c=0.25, di=5, num_domains=4, workers_per_domain=wpd,
                  steal_order=order, pool_cap=cap, seed=seed)
        g_ref, g_port = _Grab(), _Grab()
        want, s_ref = ref_sweep(f, governor=_governor(ref_rt, gov),
                                trace=g_ref, **kw)
        got, s_port = port_sweep(f, governor=_governor(port_rt, gov),
                                 trace=g_port, device="cpu", **kw)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert dataclasses.asdict(s_port) == dataclasses.asdict(s_ref)
        assert _events(g_port.ex) == _events(g_ref.ex)

    @pytest.mark.parametrize("shape,di,domains", [((10, 6, 8), 5, 2),
                                                  ((15, 4, 6), 5, 3),
                                                  ((12, 5, 7), 3, 4),
                                                  ((8, 3, 5), 1, 4)])
    def test_edge_slabs_match_reference(self, shape, di, domains):
        """Each slab task sweeps its rows of the whole lattice: the first and
        last slabs take their missing halo plane as zeros, as the
        reference's zero-padded slabs do."""
        f = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
        g_ref, g_port = _Grab(), _Grab()
        kw = dict(c=0.25, di=di, num_domains=domains, workers_per_domain=2)
        want, s_ref = ref_sweep(f, trace=g_ref, **kw)
        got, s_port = port_sweep(f, trace=g_port, device="cpu", **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert dataclasses.asdict(s_port) == dataclasses.asdict(s_ref)
        assert _events(g_port.ex) == _events(g_ref.ex)
        assert s_port.executed == shape[0] // di

    def test_single_slab_has_two_zero_halos(self):
        f = np.random.default_rng(2).standard_normal((5, 4, 6)).astype(np.float32)
        want, _ = ref_sweep(f, di=5, num_domains=2)
        got, _ = port_sweep(f, di=5, num_domains=2, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    def test_recorded_trace_replays_and_checks(self):
        f = np.random.default_rng(1).standard_normal((40, 6, 8)).astype(np.float32)
        rec = trace.TraceRecorder()
        _, stats = port_sweep(f, di=5, num_domains=4, trace=rec, device="cpu")
        t = rec.finish()
        assert t.n_tasks == 8 and t.stats["executed"] == stats.executed
        trace.replay(t, assert_match=True)   # sweep pays no steal penalty
        result = check.check_trace(t, path="port_sweep")
        assert result.ok, result.violations

    def test_rejects_like_reference(self):
        f = np.zeros((21, 4, 4), np.float32)
        with pytest.raises(ValueError) as want:
            ref_sweep(f, di=5)
        with pytest.raises(ValueError) as got:
            port_sweep(f, di=5, device="cpu")
        assert str(got.value) == str(want.value)

    def test_spec_path_not_ported_yet(self):
        with pytest.raises(NotImplementedError, match="repro.spec"):
            port_sweep(np.zeros((10, 4, 4), np.float32), di=5, spec=object(),
                       device="cpu")

    def test_needs_a_card_unless_asked_for_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_sweep(np.zeros((10, 4, 4), np.float32), di=5)


def _drive(pkg, script, **kw):
    """Run one submit/step script on ``pkg``'s Executor; return what the
    run observably did."""
    calls = []
    ex = pkg.Executor(4, [0, 0, 1, 2, 3, 3],
                      handler=lambda t, w: calls.append((t.payload, w.wid)),
                      steal_penalty=lambda t, w: t.cost * 0.5, **kw)
    for op, payload, home, cost in script:
        if op == "submit":
            ex.submit(ex.make_task(payload, home=home, cost=cost))
        else:
            ex.step()
    ex.run_until_drained()
    return dataclasses.asdict(ex.stats), _events(ex), calls, ex.step_count


def _script(seed, n=120):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        if rng.random() < 0.6:
            ops.append(("submit", i, int(rng.integers(0, 4)),
                        float(rng.integers(1, 5))))
        else:
            ops.append(("step", None, None, None))
    return ops


class TestExecutorParity:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("order", ["cyclic", "longest", "random",
                                       "cost_weighted"])
    def test_random_submit_step_sequences(self, seed, order):
        script = _script(seed)
        kw = dict(steal_order=order, seed=seed, pool_cap=(4 if seed % 2 else 64),
                  batch=1 + seed % 3)
        want = _drive(ref_rt, script, governor=_governor(ref_rt, "AdaptiveSteal"),
                      **kw)
        got = _drive(port_rt, script, governor=_governor(port_rt, "AdaptiveSteal"),
                     **kw)
        assert got == want

    @pytest.mark.parametrize("gov", ["GreedySteal", "NoSteal", "AdaptiveSteal"])
    def test_governors(self, gov):
        script = _script(11)
        want = _drive(ref_rt, script, governor=_governor(ref_rt, gov))
        got = _drive(port_rt, script, governor=_governor(port_rt, gov))
        assert got == want

    def test_same_public_names(self):
        assert sorted(port_rt.__all__) == sorted(ref_rt.__all__)


def test_port_imports_neither_jax_nor_repro():
    """The port and its chip script stand alone: no ``jax``, no ``repro``."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if bad.search(p.read_text())]
    assert offenders == []
