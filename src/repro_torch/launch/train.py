"""End-to-end training entry point (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt CKPT_DIR --device cpu

``--smoke`` shrinks the arch to its reduced config; without it the full
config is used.  The run is on the card unless ``--device cpu`` asks for
the CPU.  The loop resumes from the newest checkpoint in ``--ckpt``
automatically.  ``make_trainer`` builds this entry point's ``Trainer``
for callers that run it themselves.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np

from ..configs import get_config, reduce_config
from ..data.pipeline import make_batch_iterator
from ..models.model import build_model
from ..train.loop import LoopConfig, Trainer
from ..train.optimizer import AdamWConfig


def _with_extras(it, cfg, batch: int):
    """whisper / vlm runs need their stub extras in every batch"""
    for b in it:
        if cfg.encoder is not None:
            b["frames"] = np.zeros(
                (batch, cfg.encoder.num_frames, cfg.encoder.d_model), np.float32)
        if cfg.vision is not None:
            b["vision"] = np.zeros(
                (batch, cfg.vision.num_image_tokens, cfg.d_model), np.float32)
        yield b


def make_trainer(arch: str, *, smoke: bool = False, steps: int = 100,
                 batch: int = 8, seq: int = 128, lr: float = 3e-3,
                 ckpt: Optional[str] = None, ckpt_every: int = 25,
                 seed: int = 0, device=None,
                 log_fn: Callable[[str], None] = print) -> Trainer:
    """The ``Trainer`` of ``main``: ``arch``'s config (reduced with
    ``smoke``), the synthetic corpus from ``seed``, AdamW with ``main``'s
    warmup and schedule, on ``device`` (the card by default)."""
    cfg = get_config(arch)
    if smoke:
        cfg = reduce_config(cfg)
    model = build_model(cfg, max_pos=max(seq, 128), device=device)
    data = make_batch_iterator(cfg.vocab_size, seq, batch, seed=seed)
    return Trainer(
        model, _with_extras(data, cfg, batch),
        LoopConfig(total_steps=steps, checkpoint_every=ckpt_every,
                   checkpoint_dir=ckpt, log_every=max(steps // 20, 1)),
        AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps),
        log_fn=log_fn)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu for the CPU)")
    args = ap.parse_args(argv)

    out = make_trainer(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
                       seq=args.seq, lr=args.lr, ckpt=args.ckpt,
                       ckpt_every=args.ckpt_every, seed=args.seed,
                       device=args.device).run(seed=args.seed)
    losses = out["losses"]
    print(f"first-10 mean loss: {sum(losses[:10])/max(len(losses[:10]),1):.4f}")
    print(f"last-10  mean loss: {sum(losses[-10:])/max(len(losses[-10:]),1):.4f}")


if __name__ == "__main__":
    main()
