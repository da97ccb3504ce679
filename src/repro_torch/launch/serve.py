"""Serving driver: batched requests through the locality-queue router.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
        --requests 12 --replicas 3 --policy locality [--device cpu]

``--arch`` takes all ten architectures of ``repro_torch.configs``
(``list_archs()``).  As in the reference, the engine prefills the prompt's
tokens only, so whisper-base's and llama-3.2-vision-90b's cross layers
attend to their zeroed cross caches.

The port of ``repro.launch.serve``.  Compares router policies on the same
workload (multi-turn sessions whose follow-ups have cache affinity to the
replica that served turn one) and prints the locality/steal statistics next
to the generated tokens.  Runs on ``cuda`` unless ``--device`` names
another device.  As in the reference, ``--smoke`` is on by default and
cannot be switched off (its ``store_true`` has ``default=True``), so the
driver always serves the reduced config.

The random weights are drawn from a CPU ``torch.Generator`` seeded
``--seed`` and then moved to the device, so one seed serves one model on
every device, as ``jax.random.key(seed)`` does in the reference: a CUDA
generator draws other numbers than a CPU one, and the tokens on the card
would then differ from those of ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve_device
from .._tree import tree_map
from ..configs import get_config, reduce_config
from ..models.model import build_model
from ..serving.engine import Request, ServingEngine


def synth_requests(n: int, vocab: int, num_replicas: int,
                   seed: int = 0) -> list[Request]:
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(8, 24))
        toks = rng.integers(0, vocab, size=plen)
        # ~2/3 of requests are session follow-ups with a cached prefix home
        home = int(rng.integers(0, num_replicas)) if rng.random() < 0.67 else -1
        reqs.append(Request(uid=i, tokens=toks, max_new=8, home_replica=home))
    return reqs


def random_params(cfg, max_pos: int, seed: int, device) -> dict:
    """The model's random parameters, drawn on the CPU from ``seed`` and
    moved to ``device``: the same numbers whatever the device."""
    cpu = build_model(cfg, max_pos=max_pos, device="cpu")
    return tree_map(lambda t: t.to(device),
                    cpu.init_params(torch.Generator().manual_seed(seed)))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--policy", default="locality",
                    choices=["locality", "round_robin", "single_queue"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    model = build_model(cfg, max_pos=256, device=dev)
    params = random_params(cfg, 256, args.seed, dev)

    engine = ServingEngine(model, params, num_replicas=args.replicas,
                           max_seq=64, policy=args.policy, device=dev)
    for req in synth_requests(args.requests, cfg.vocab_size, args.replicas,
                              seed=args.seed):
        engine.submit(req)
    done = engine.run_until_drained()
    for req in sorted(done, key=lambda r: r.uid)[:5]:
        print(f"req {req.uid:3d} -> {req.out_tokens}")
    s = engine.stats
    print(f"policy={args.policy} served={s.served} "
          f"local={s.locality_fraction:.2f} stolen={s.stolen} "
          f"prefill_tokens={s.prefill_tokens}")


if __name__ == "__main__":
    main()
