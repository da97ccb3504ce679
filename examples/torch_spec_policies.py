"""A policy is a JSON file: load → build → run → record → replay, no code
(the twin of ``spec_policies.py``, on the PyTorch/CUDA port's numpy-only
copies of ``spec`` and ``trace``; nothing here touches a device).

    PYTHONPATH=src python examples/torch_spec_policies.py [spec.json]

The whole point of ``repro_torch.spec``: a scheduling experiment is named by a
serializable ``RuntimeSpec``, so trying a new policy is editing a JSON
file, not wiring constructors.  This example

  1. loads a checked-in policy file (default: the full control plane,
     ``specs/controlled_replay.json``),
  2. builds the declared system (executor + control loop) and drives a
     seeded hot-skew arrival stream through it while recording,
  3. writes the trace — whose v2 header embeds the policy — to JSONL,
  4. reads it back and replays it with ``trace.replay(t)`` and *no
     executor argument*: the recorded configuration is reconstructed from
     the header alone and reproduces the recorded stats bit-for-bit,
  5. derives a variant policy in three lines and prints its JSON, ready to
     be checked in as a new named experiment.
"""
import dataclasses
import os
import sys
import tempfile

from repro_torch import spec, trace

NUM_STEPS = 32


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "specs/controlled_replay.json"
    policy = spec.load(path)
    print(f"policy file: {path}")
    print(f"  steal_order={policy.steal_order} governor={policy.governor.kind}"
          f" breaker={policy.governor.breaker is not None}"
          f" router={policy.router.kind} batch={policy.batch.kind}")

    # build + drive: the declared system, a recorder attached on top
    # (unless the policy itself declares trace recording)
    built = policy.build()
    rec = built.recorder
    if rec is None:
        rec = trace.TraceRecorder()
        rec.attach(built.executor)
    wl = trace.hot_skew(
        trace.poisson(rate=policy.num_domains, steps=NUM_STEPS,
                      num_domains=policy.num_domains, seed=11),
        hot_domain=0, p_hot=0.8, seed=11)
    trace.drive(built.executor, wl)
    t = rec.finish()
    s = built.executor.stats
    print(f"ran {wl.name}: executed={s.executed} "
          f"local={s.local_fraction:.0%} steal={s.steal_fraction:.0%}")
    if built.control is not None:
        print(f"controller: {built.control.snapshot()}")

    # the trace file fully names the system that produced it
    tpath = os.path.join(tempfile.mkdtemp(prefix="repro-torch-spec-"),
                         "policy-run.trace.jsonl")
    trace.TraceWriter(tpath).write(t)
    t2 = trace.TraceReader(tpath).read()
    assert t2.spec_dict is not None, "v2 header should embed the spec"
    res = trace.replay(t2, assert_match=True)      # no executor argument
    print(f"replayed from {tpath} header alone: bit-identical "
          f"(executed={res.stats['executed']:.0f})")

    # deriving a new experiment is a value edit, not a constructor change
    variant = dataclasses.replace(
        policy,
        router=dataclasses.replace(policy.router, spill="measured"),
        governor=dataclasses.replace(policy.governor, kind="adaptive"))
    print("\na derived policy (router prices spill from measurements):")
    print(variant.to_json())
    print("spec policies smoke OK")


if __name__ == "__main__":
    main()
