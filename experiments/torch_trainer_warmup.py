"""The trainers of ``chip_smoke.py``'s phase 7k under other AdamW schedules,
and the gate leaves of llama-3.2-vision-90b's f32 train step, on the card.

    python3 experiments/torch_trainer_warmup.py [--out PATH]

For each setting (configuration, warmup steps, peak lr, kernel or plain
path, tied or untied embedding) it runs ``chip_smoke.train_run`` as 7k
does (the donated ``Trainer``, 6 steps of 8 x 1024, whisper 8 x 448, each
configuration's own microbatches and 7k's depth) and prints one
``SETTING`` line: the per-step losses, the held-out loss from the initial
params and from the last step's, its fall, the peak and the steady ms a
step.  Every setting is read to its end: the smoke's gates print instead
of ending the run.  Then the VLM's f32 step at one full and one cross
layer (7k's), kernel path against plain path: each gate leaf's gradient
gap over its largest |plain|.  Needs one CUDA card; the output goes to
``--out`` as well (default ``chiprun_out/trainer_warmup.log``).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (configuration, warmup steps, peak lr, use_kernel, tie_embeddings or None
# for the configuration's own)
SETTINGS = [(arch, warmup, lr, True, None)
            for arch in ("qwen2-1.5b", "minicpm3-4b", "gemma3-1b", "whisper-base",
                         "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
            for warmup, lr in ((1, 3e-3), (3, 3e-3), (1, 1e-3))]
SETTINGS += [("qwen2-1.5b", 2, 3e-3, True, None), ("qwen2-1.5b", 1, 3e-3, False, None),
             ("qwen2-1.5b", 1, 3e-3, True, False), ("minicpm3-4b", 2, 3e-3, True, None)]


class _Tee:
    def __init__(self, *files):
        self.files = files

    def write(self, text):
        for f in self.files:
            f.write(text)
        return len(text)

    def flush(self):
        for f in self.files:
            f.flush()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "trainer_warmup.log"))
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as log:
        sys.stdout = _Tee(sys.__stdout__, log)
        try:
            run()
        finally:
            sys.stdout = sys.__stdout__


def run() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    smoke.fail = lambda msg: print(f"gate not met: {msg}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.optimizer import AdamWConfig

    _build.build()
    dev, card = torch.device("cuda"), smoke.card_line()
    print(card)
    for arch, warmup, lr, use_kernel, tie in SETTINGS:
        base = get_config(arch)
        depth, _, _ = smoke.trainer_depth(base)
        cfg = dataclasses.replace(base, num_layers=depth)
        if tie is not None:
            cfg = dataclasses.replace(cfg, tie_embeddings=tie)
        seq, bsz = smoke.ARCHS_TRAIN_SEQ.get(arch, 1024), smoke.ARCHS_TRAIN_BATCH
        steps = smoke.ARCHS_TRAIN_STEPS
        label = (f"{arch} warmup {warmup} lr {lr}" + ("" if use_kernel else " plain path")
                 + ("" if tie is None else f" tie_embeddings={tie}"))
        smoke.free_device_memory()
        trainer = Trainer(
            build_model(cfg, max_pos=seq, device=dev, use_kernel=use_kernel),
            launch_train._with_extras(make_batch_iterator(cfg.vocab_size, seq, bsz, seed=0),
                                      cfg, bsz),
            LoopConfig(total_steps=steps, checkpoint_every=10 ** 9, log_every=1),
            AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=steps), log_fn=print)
        r = smoke.train_run(dev, card, label, trainer, cfg, batch=bsz, seq=seq,
                            peak_limit=smoke.ARCHS_TRAIN_PEAK)
        print(f"SETTING {label}: losses {[round(x, 4) for x in r['losses']]} held-out "
              f"{r['held_out_losses']} fall {r['held_out_fall']:.4f} peak "
              f"{r['peak_bytes'] / 1e9:.2f} GB steady {r['steady_ms_per_step']:.2f} ms "
              f"[{card}]", flush=True)
        del trainer

    vlm = get_config("llama-3.2-vision-90b")
    cfg = dataclasses.replace(vlm, dtype="float32", num_layers=2, pattern=("full", "cross"))
    batch = smoke.step_batch(dev, vlm, smoke.ARCHS_STEP_BATCH, 512)
    grads = {}
    for use_kernel in (True, False):
        model = build_model(cfg, max_pos=512, device=dev, use_kernel=use_kernel)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        for layer in params["stack"]:
            if "gate_x" in layer:
                layer["gate_x"].fill_(smoke.VLM_GATES[0])
                layer["gate_m"].fill_(smoke.VLM_GATES[1])
        paths = [p for p, _ in _tree.flatten_with_path(params)]
        grads[use_kernel] = smoke.loss_and_grads(model, params, batch)[1]
    per, _ = smoke.grad_gaps(paths, grads[True], grads[False])
    print(f"{vlm.name} f32 train step, layers {cfg.layer_kinds()}: gate leaves' gradient "
          f"gaps " + ", ".join(f"{p} {g:.3e}" for p, g in per.items()
                               if p.rsplit("/", 1)[-1] in ("gate_x", "gate_m"))
          + f" [{card}]")


if __name__ == "__main__":
    main()
