"""Self-tuning serving with the PyTorch/CUDA port: the control plane driving
the serving engine (the twin of ``control_serving.py``).

    PYTHONPATH=src python examples/torch_control_serving.py --device cpu

The model runs on the card unless ``--device cpu`` asks for the CPU (there
attention runs in K3, the hand-written Hopper flash attention kernel).  Its
weights come from a ``torch.Generator`` seeded 0, so its tokens are the
port's own; the scheduling statistics, the controller's snapshot and the
replayed schedule do not depend on the weights and are the reference
example's.

Serves one stream of skewed requests through the ``ServingEngine`` twice —
uncontrolled (home routing, greedy stealing, one request per grab) and
controlled (cost-aware routing, adaptive continuous batching, storm
circuit-breaker) — and checks the contract that makes online control safe
to turn on: decoded tokens are bit-identical, only the scheduling
statistics move.

Both arms are declarative ``repro.spec`` policies: the controlled arm is
the registry entry ``controlled_serving`` and the uncontrolled arm is the
same spec with the control plane edited out — no constructor wiring.
Finally the controlled router's behaviour is recorded as a trace and
replayed *from the header spec alone* (``trace.replay(t)``, no factory),
asserting the replayed scheduler statistics are bit-identical to the
recorded ones.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import spec, trace
from repro_torch.configs import get_config, reduce_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServingEngine

NUM_REPLICAS = 2
N_REQUESTS = 10


def make_requests(cfg, seed=0):
    # skewed session affinity: most requests' KV caches live on replica 0
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(N_REQUESTS):
        toks = rng.integers(0, cfg.vocab_size, size=int(rng.integers(6, 14)))
        home = 0 if rng.random() < 0.8 else int(rng.integers(NUM_REPLICAS))
        reqs.append(Request(uid=i, tokens=toks, max_new=4, home_replica=home))
    return reqs


def serve(model, params, cfg, policy_spec, *, rec=None):
    eng = ServingEngine(model, params, spec=policy_spec, trace=rec, device=model.device)
    for r in make_requests(cfg):
        eng.submit(r)
    done = eng.run_until_drained()
    return eng, {r.uid: tuple(r.out_tokens) for r in done}


def main(device=None):
    cfg = reduce_config(get_config("qwen2-0.5b"))
    model = build_model(cfg, max_pos=96, device=device)
    params = model.init_params(torch.Generator(device=model.device).manual_seed(0))

    ctl_spec = spec.named("controlled_serving")
    # the uncontrolled arm = the same declared system minus the control
    # plane: greedy stealing, default routing, single-request grabs.
    base_spec = dataclasses.replace(
        ctl_spec, governor=spec.GovernorSpec(kind="greedy"),
        router=spec.RouterSpec(kind="none"), batch=spec.BatchSpec())

    base_eng, base_out = serve(model, params, cfg, base_spec)
    print(f"uncontrolled: served={base_eng.stats.served} "
          f"local={base_eng.stats.locality_fraction:.0%} "
          f"stolen={base_eng.stats.stolen} "
          f"prefill_tokens={base_eng.stats.prefill_tokens}")

    rec = trace.TraceRecorder()
    ctl_eng, ctl_out = serve(model, params, cfg, ctl_spec, rec=rec)
    loop = ctl_eng.control
    print(f"controlled:   served={ctl_eng.stats.served} "
          f"local={ctl_eng.stats.locality_fraction:.0%} "
          f"stolen={ctl_eng.stats.stolen} "
          f"prefill_tokens={ctl_eng.stats.prefill_tokens}")
    print(f"controller:   {loop.snapshot()}")

    assert ctl_out == base_out, "control plane changed decoded tokens!"
    print("decoded tokens bit-identical under control: OK")
    assert ctl_eng.stats.prefill_tokens <= base_eng.stats.prefill_tokens, \
        "control plane should never re-prefill more than greedy stealing"

    # the controlled router's schedule replays deterministically from the
    # header-embedded spec alone — no factory, no rebuilt control loop
    # (scheduling only: payloads are opaque, the model does not re-run)
    t = rec.finish()
    res = trace.replay(t, assert_match=True)
    print(f"replayed controlled schedule from header spec: bit-identical "
          f"(executed={res.stats['executed']:.0f})")
    print(trace.render_timeline(t.events, num_workers=NUM_REPLICAS, width=2))
    print("\ncontrol serving smoke OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu for the CPU)")
    main(ap.parse_args().device)
