"""The port's copy of the numpy-only scheduling stack (``repro_torch.core``,
``topology``, ``trace``, ``obs``, ``check``, ``control``, ``spec``) held
against the JAX package's originals.

The copies differ from the originals only in their docstrings' usage
lines, so every observable must agree: recorded traces (line for line as
JSONL, and each replays under either package's ``replay``), the model
checker's verdicts, the linter's findings, every named spec's JSON, and
the simulator's results.
"""
import dataclasses

import numpy as np
import pytest

import repro.check as ref_check
import repro.core as ref_core
import repro.spec as ref_spec
import repro.trace as ref_trace
import repro_torch.check as port_check
import repro_torch.core as port_core
import repro_torch.spec as port_spec
import repro_torch.trace as port_trace
from repro.stencil.jacobi import run_runtime_sweep as ref_sweep
from repro_torch.spec import validate as port_validate
from repro_torch.stencil.jacobi import run_runtime_sweep as port_sweep

FIXTURE = "tests/data/v1_trace_fixture.jsonl"
SEGMENTS = "tests/data/v1_segments"

# (spec name or None for the kwargs path, slab rows, domains, workers per domain)
SWEEPS = [(None, 5, 4, 2), (None, 4, 3, 1), ("paper_cyclic", 5, 4, 1),
          ("adaptive_theta", 4, 4, 1), ("tasking_round_robin", 5, 4, 1),
          ("static_local", 5, 4, 1), ("measured_theta", 5, 4, 1),
          ("controlled_replay", 4, 4, 1)]


def _lattice(ni=40, seed=1):
    return np.random.default_rng(seed).standard_normal((ni, 5, 6)).astype(np.float32)


def _recorded_sweep(pkg, name, di, domains, wpd):
    """(lattice, stats, JSONL lines) of one sweep recorded by ``pkg``'s own
    ``TraceRecorder``; ``pkg`` is the reference (``ref``) or the port."""
    trace, spec, sweep = ((ref_trace, ref_spec, ref_sweep) if pkg == "ref"
                          else (port_trace, port_spec, port_sweep))
    kw = {} if pkg == "ref" else {"device": "cpu"}
    rec = trace.TraceRecorder()
    if name is None:
        kw.update(num_domains=domains, workers_per_domain=wpd)
    else:
        kw.update(spec=spec.named(name))
    out, stats = sweep(_lattice(), di=di, trace=rec, **kw)
    return np.asarray(out), stats, trace.dumps_lines(rec.finish())


class TestTraces:
    @pytest.mark.parametrize("name,di,domains,wpd", SWEEPS)
    def test_runtime_sweep_traces_equal_line_for_line(self, name, di, domains, wpd):
        want, wstats, wlines = _recorded_sweep("ref", name, di, domains, wpd)
        got, gstats, glines = _recorded_sweep("port", name, di, domains, wpd)
        assert glines == wlines
        assert dataclasses.asdict(gstats) == dataclasses.asdict(wstats)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("name,di,domains,wpd", SWEEPS)
    def test_each_trace_replays_under_both_packages(self, name, di, domains, wpd):
        """A sweep pays no steal penalty, so a kwargs-path trace replays on
        its metadata alone; a spec-path trace embeds its spec."""
        snapshots = []
        for pkg in ("ref", "port"):
            lines = _recorded_sweep(pkg, name, di, domains, wpd)[2]
            for trace in (ref_trace, port_trace):
                res = trace.replay(trace.loads_lines(lines), assert_match=True)
                assert res.matches_recorded
                snapshots.append((res.stats, [
                    (e.step, e.kind, e.worker, e.domain, e.task_uid)
                    for e in res.executor.events]))
        assert all(s == snapshots[0] for s in snapshots)

    def test_readers_agree_on_the_v1_fixture(self):
        want = ref_trace.dumps_lines(ref_trace.TraceReader(FIXTURE).read())
        got = port_trace.dumps_lines(port_trace.TraceReader(FIXTURE).read())
        assert got == want


class TestChecker:
    @pytest.mark.parametrize("path", [FIXTURE, SEGMENTS])
    def test_check_trace_verdicts_equal(self, path):
        want, got = ref_check.check_path(path), port_check.check_path(path)
        assert got.ok == want.ok
        assert got.to_dict() == want.to_dict()

    @pytest.mark.parametrize("path", [FIXTURE, SEGMENTS])
    def test_a_broken_trace_gets_the_same_verdict(self, path):
        """Drop the first run event: both checkers must flag the same rules."""
        verdicts = []
        for trace, check in ((ref_trace, ref_check), (port_trace, port_check)):
            t = trace.TraceReader(path).read()
            i = next(k for k, e in enumerate(t.events) if e.kind == "run")
            t = dataclasses.replace(t, events=t.events[:i] + t.events[i + 1:])
            verdicts.append(check.check_trace(t, path="broken").to_dict())
        assert verdicts[0] == verdicts[1]
        assert verdicts[0]["ok"] is False

    def test_port_sweep_trace_passes_both_checkers(self):
        lines = _recorded_sweep("port", "paper_cyclic", 5, 4, 1)[2]
        for trace, check in ((ref_trace, ref_check), (port_trace, port_check)):
            result = check.check_trace(trace.loads_lines(lines), path="port_sweep")
            assert result.ok, result.violations

    def test_lint_sets_equal(self):
        def findings(check):
            return sorted((v.file, v.rule, v.suppressed) for v in check.lint_tree())

        assert findings(port_check) == findings(ref_check)
        assert port_check.repro_root().endswith("repro_torch")


class TestSpecs:
    def test_same_policy_names(self):
        assert port_spec.policy_names() == ref_spec.policy_names()

    @pytest.mark.parametrize("name", ref_spec.policy_names())
    def test_named_spec_serialises_the_same(self, name):
        assert port_spec.named(name).to_json() == ref_spec.named(name).to_json()
        assert ref_spec.RuntimeSpec.from_json(port_spec.named(name).to_json()) \
            == ref_spec.named(name)

    @pytest.mark.parametrize("path", ["specs", "specs/experiments"])
    def test_validate_passes_on_checked_in_specs(self, path, capsys):
        assert port_validate.main([path]) == 0
        assert "FAIL" not in capsys.readouterr().err


def _grid(core):
    """A grid small enough to simulate every policy x placement."""
    return core.BlockGrid(ni=40, nj=60, nk=16, di=10, dj=10, dk=16)


POLICIES = {
    "static_ws": lambda core: core.StaticWorksharing(),
    "omp_task": lambda core: core.OpenMPTasking(submit_order="kji", pool_cap=16),
    "omp_lq": lambda core: core.OpenMPLocalityQueues(submit_order="kji", pool_cap=16),
    "tbb_pf": lambda core: core.TBBParallelFor(affinity=False),
    "tbb_pf_affinity": lambda core: core.TBBParallelFor(
        affinity=True, replay=core.tbb_first_touch(
            _grid(core), core.NEHALEM_EP, np.random.default_rng(0))[1]),
    "tbb_lq": lambda core: core.TBBLocalityQueues(),
}
PLACEMENTS = ("serial", "round_robin", "static", "static1")
R1 = pytest.mark.xfail(
    raises=ValueError, strict=True,
    reason="R1 (ROADMAP §3): round_robin placement gives every block home -1, "
           "and the locality queues shift by it (runtime/queues.py:213); the "
           "copy carries the reference's bug")


@pytest.mark.parametrize("policy,placement", [
    pytest.param(p, pl, marks=R1) if p in ("omp_lq", "tbb_lq") and pl == "round_robin"
    else (p, pl) for p in POLICIES for pl in PLACEMENTS])
def test_simulate_agrees(policy, placement):
    results = []
    for core in (ref_core, port_core):
        grid = _grid(core)
        homes = core.place(placement, grid, core.NEHALEM_EP)
        res = core.simulate(grid, core.NEHALEM_EP, POLICIES[policy](core), homes, seed=3)
        results.append(dataclasses.asdict(res))
    assert results[1] == results[0]
