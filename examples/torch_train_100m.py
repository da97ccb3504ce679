"""End-to-end training with the PyTorch/CUDA port (the twin of
``train_100m.py``): train a narrowed qwen2-family model on the synthetic
corpus, with AdamW, async checkpoints and resume.

    PYTHONPATH=src python examples/torch_train_100m.py --steps 300
    PYTHONPATH=src python examples/torch_train_100m.py --device cpu --steps 20

The run is on the card unless ``--device cpu`` asks for the CPU.  An empty
``--ckpt`` turns checkpoints off.  ``--narrow`` is on whatever the command
line says, as in the reference; ``narrow_100m`` is the narrowed config.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_batch_iterator
from repro_torch.models.model import build_model
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optimizer import AdamWConfig


def narrow_100m(cfg):
    """qwen2-0.5b narrowed (CPU-trainable)."""
    return dataclasses.replace(
        cfg, name="qwen2-100m", num_layers=6, d_model=512, num_heads=8,
        num_kv_heads=2, head_dim=64, d_ff=2048, vocab_size=32768,
        microbatches=1, dtype="float32")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--narrow", action="store_true", default=True)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu for the CPU)")
    args = ap.parse_args()

    cfg = get_config("qwen2-0.5b")
    if args.narrow:
        cfg = narrow_100m(cfg)
    model = build_model(cfg, max_pos=args.seq, device=args.device)
    n_params = cfg.num_params()
    print(f"training {cfg.name} on {model.device}: ~{n_params/1e6:.0f}M params, "
          f"{args.steps} steps x {args.batch}x{args.seq} tokens")

    trainer = Trainer(
        model, make_batch_iterator(cfg.vocab_size, args.seq, args.batch),
        LoopConfig(total_steps=args.steps, checkpoint_every=100,
                   checkpoint_dir=args.ckpt or None, log_every=20),
        AdamWConfig(lr=1e-3, warmup_steps=30, total_steps=args.steps),
    )
    out = trainer.run()
    losses = out["losses"]
    k = max(len(losses) // 10, 1)
    print(f"loss: first-{k} mean {sum(losses[:k])/k:.4f} -> "
          f"last-{k} mean {sum(losses[-k:])/k:.4f}")


if __name__ == "__main__":
    main()
