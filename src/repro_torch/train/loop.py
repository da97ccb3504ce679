"""Training loop: data + step + checkpointing + fault handling (the port of
``repro.train.loop``).

The loop is host-driven and restartable: all state lives in (params,
opt_state, step); the data pipeline is deterministic given the step
counter; ``run()`` resumes from the newest checkpoint if one exists, so a
kill at any point loses at most ``checkpoint_every`` steps.  Checkpoints
are written in the reference's layout and format
(``models.convert.to_reference_layout``, ``checkpoint.manager``), so
either package's trainer resumes from the other's directory.  A resumed
run equals an uninterrupted one bit for bit, on the card too, with no
global setting: the hand-written backward kernels (K3, K4, K5) use no
float atomics, and ``chip_smoke.py`` phase 7e holds the full-width
qwen2-0.5b trainer to it without ``torch.use_deterministic_algorithms`` or
``CUBLAS_WORKSPACE_CONFIG``.

The step is donated (``make_train_step(donate=True)``), as the reference
jits it with ``donate_argnums=(0, 1)``: the parameters and the optimizer
state are updated in place, so only one copy of them is ever live.  A
checkpoint is staged to the host before ``save`` returns, so a later step
cannot change it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from .._tree import tree_map
from ..checkpoint.manager import CheckpointManager
from ..distributed.fault import StragglerMonitor
from ..models.convert import (opt_state_from_jax, params_from_jax,
                              to_reference_layout)
from ..models.model import Model
from .optimizer import AdamWConfig, init_opt_state
from .train_step import make_train_step


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10


class Trainer:
    def __init__(self, model: Model, data: Iterator[dict[str, np.ndarray]],
                 loop_cfg: LoopConfig, opt_cfg: Optional[AdamWConfig] = None,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.data = data
        self.cfg = loop_cfg
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=loop_cfg.total_steps)
        self.log = log_fn
        self.step_fn = make_train_step(model, self.opt_cfg, donate=True)
        self.ckpt = (CheckpointManager(loop_cfg.checkpoint_dir,
                                       keep=loop_cfg.keep_checkpoints)
                     if loop_cfg.checkpoint_dir else None)
        self.monitor = StragglerMonitor(num_domains=1)

    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.model.device).manual_seed(seed)
        params = self.model.init_params(gen)
        opt_state = init_opt_state(params)
        return params, opt_state

    # checkpoints hold {"params", "opt"} in the reference's tree
    def _saved(self, params, opt_state) -> dict[str, Any]:
        cfg = self.model.cfg
        return {"params": to_reference_layout(params, cfg),
                "opt": {**{k: to_reference_layout(opt_state[k], cfg)
                           for k in ("master", "m", "v")},
                        "step": opt_state["step"]}}

    def _restore_latest(self, params, opt_state):
        meta = tree_map(lambda t: t.to("meta"), {"params": params, "opt": opt_state})
        latest, restored = self.ckpt.restore_latest(
            self._saved(meta["params"], meta["opt"]))
        if latest is None:
            return None, params, opt_state
        cfg, dev = self.model.cfg, self.model.device
        return (latest, params_from_jax(restored["params"], cfg, dev),
                opt_state_from_jax(restored["opt"], cfg, dev))

    def run(self, seed: int = 0) -> dict[str, Any]:
        params, opt_state = self.init_state(seed)
        start = 0
        if self.ckpt is not None:
            latest, params, opt_state = self._restore_latest(params, opt_state)
            if latest is not None:
                start = latest
                self.log(f"[resume] restored checkpoint at step {latest}")

        # deterministic data replay: skip batches consumed before the crash
        it = iter(self.data)
        for _ in range(start):
            next(it)

        dev = self.model.device
        losses = []
        for step in range(start, self.cfg.total_steps):
            batch = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in next(it).items()}
            t0 = time.time()
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            self.monitor.update([time.time() - t0])
            if (step + 1) % self.cfg.log_every == 0:
                self.log(f"[step {step+1:5d}] loss={loss:.4f} "
                         f"gnorm={float(metrics['grad_norm']):.3f} "
                         f"lr={float(metrics['lr']):.2e} "
                         f"({time.time()-t0:.2f}s/step)")
            if self.ckpt is not None and (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, self._saved(params, opt_state))
        if self.ckpt is not None:
            self.ckpt.save(self.cfg.total_steps,
                           self._saved(params, opt_state), blocking=True)
        return {"params": params, "opt_state": opt_state, "losses": losses}
