"""An experiment is a JSON file: policy + workload + seeds, run end to end
(the twin of ``run_experiment.py``, on the PyTorch/CUDA port's numpy-only
copies of ``spec`` and ``trace``; nothing here touches a device).

    PYTHONPATH=src python examples/torch_run_experiment.py [experiment.json|name]

``repro_torch.spec.ExperimentSpec`` completes what ``spec_policies.py`` started:
where a policy file names *how* to schedule, an experiment file also names
*what* arrives (the workload block) and *how the run is conducted*
(repeats, drain budget).  This example

  1. loads a checked-in experiment (default: the registry's
     ``replay_hot_skew`` — the trace-replay benchmark's hot-skew cell),
  2. runs it: the declared policy is built and the declared workload is
     driven through it while recording,
  3. replays the recorded trace from its header alone and asserts the
     stats reproduce bit-identically (the conformance gate every
     ``specs/experiments/*.json`` file passes in CI),
  4. checkpoints the governor's learned θ state into a new spec
     (``GovernorStateSpec``) — declarative mid-run restore, no trace
     re-read — and prints the derived experiment JSON ready to check in.
"""
import dataclasses
import os
import sys

from repro_torch import spec, trace


def main():
    arg = sys.argv[1] if len(sys.argv) > 1 else "replay_hot_skew"
    if os.path.exists(arg):
        exp = spec.load_experiment(arg)
        print(f"experiment file: {arg}")
    else:
        exp = spec.experiment(arg)
        print(f"registry experiment: {arg}")
    wl = exp.workload
    print(f"  workload: kind={wl.kind} steps={wl.steps} seed={wl.seed}"
          f" skew={wl.skew is not None} heavy_tail={wl.costs is not None}")
    print(f"  policy: governor={exp.policy.governor.kind}"
          f" router={exp.policy.router.kind} seed={exp.policy.seed}")

    result = exp.run()
    run = result.primary
    s = run.executor.stats
    print(f"ran {result.workload.name}: executed={s.executed} "
          f"local={s.local_fraction:.0%} steal={s.steal_fraction:.0%} "
          f"penalty={s.steal_penalty:.0f}")

    # the trace names the whole experiment; its header alone replays it
    t = trace.loads_lines(trace.dumps_lines(run.trace))
    assert spec.ExperimentSpec.from_dict(t.experiment_dict) == exp
    replayed = trace.replay(t, assert_match=True)
    print(f"header-only replay: bit-identical stats "
          f"({replayed.matches_recorded})")

    # derive a measured-governor variant seeded from this run's trace —
    # the learned state is spec data, so the variant is pure JSON
    seeded = trace.MeasuredPenalty.from_trace(t)
    variant = dataclasses.replace(
        exp, policy=dataclasses.replace(
            exp.policy,
            governor=spec.GovernorSpec(
                kind="measured",
                state=spec.GovernorStateSpec.from_governor(seeded))))
    assert spec.ExperimentSpec.from_json(variant.to_json()) == variant
    theta = variant.policy.governor.state
    print(f"derived measured-θ variant (penalty≈{theta.penalty_estimate:.2f}"
          f" / local cost≈{theta.task_cost:.2f}); as JSON:")
    print("\n".join(variant.to_json().splitlines()[:8]) + "\n  ...")


if __name__ == "__main__":
    main()
