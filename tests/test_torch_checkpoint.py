"""The port's checkpoint manager (``repro_torch.checkpoint.manager``) and
the trainer's resume, held against the JAX package on the CPU.

The reference's own checkpoint tests, mirrored (round trip, retention,
async write then wait, a failed write surfaced, shape mismatch, empty
directory, an interrupted run that resumes identically), plus what the
port adds: bf16 leaves survive bit for bit as 16 raw bits (descr
``'<V2'``, ``"bfloat16"`` in the manifest, as the reference's ``np.save``
of an ``ml_dtypes`` array writes them), and a step directory written by
either package's trainer resumes the other's.  Cross-loading runs the
reduced qwen2-0.5b in f32 (the reference's ``restore`` cannot load a bf16
leaf: ``jnp.asarray`` refuses numpy's ``V2``, ROADMAP R6).  Tolerances of
the cross-loaded runs, which continue 2 steps on the other package's
arithmetic: losses within 1e-4, parameters within 2 lr x 2 steps (Adam
turns noise-level gradient differences into steps of up to +-lr), the
median element within 1e-5 of max(|value|, 2 lr x 2).
"""
import json
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.data.pipeline import make_batch_iterator as ref_batches
from repro.models.model import build_model as jax_build_model
from repro.train.loop import LoopConfig as RefLoopConfig
from repro.train.loop import Trainer as RefTrainer
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro_torch import _tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.data.pipeline import make_batch_iterator
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.models.model import build_model
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optimizer import AdamWConfig

ARCH = "qwen2-0.5b"
LR = 1e-3


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 8), generator=g),
                   "h": torch.randn((3, 5), generator=g).to(torch.bfloat16),
                   "stack": [torch.arange(6).reshape(2, 3).float()]},
        "opt": {"m": torch.zeros((8, 8)), "step": torch.tensor(7, dtype=torch.int32)},
    }


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


class TestRoundtrip:
    def test_save_restore_identical(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_write=False)
        state = _state()
        mgr.save(10, state)
        restored = mgr.restore(10, _tree.tree_map(torch.zeros_like, state))
        assert all(_equal(a, b) for a, b in zip(_tree.leaves(state), _tree.leaves(restored)))

    def test_bf16_on_disk_is_the_references_format(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_write=False)
        state = _state()
        mgr.save(3, state)
        d = tmp_path / "step_00000003"
        manifest = json.loads((d / "manifest.json").read_text())
        entry = manifest["arrays"]["params/h"]
        assert entry == {"file": "params__h.npy", "shape": [3, 5], "dtype": "bfloat16"}
        ref = RefManager(tmp_path / "ref", async_write=False)
        h = state["params"]["h"].view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        ref.save(3, {"params": {"h": h}})
        want = (tmp_path / "ref" / "step_00000003" / "params__h.npy").read_bytes()
        assert (d / "params__h.npy").read_bytes() == want
        assert b"'descr': '<V2'" in want
        ref_manifest = json.loads((tmp_path / "ref/step_00000003/manifest.json").read_text())
        assert ref_manifest["arrays"]["params/h"] == entry

    def test_keys_and_files_match_the_reference(self, tmp_path):
        state = {k: v for k, v in _state().items()}
        state["params"].pop("h")                       # the reference restores no bf16
        CheckpointManager(tmp_path / "port", async_write=False).save(1, state)
        RefManager(tmp_path / "ref", async_write=False).save(
            1, _tree.tree_map(lambda t: t.numpy(), state))
        mp, mr = (json.loads((tmp_path / w / "step_00000001/manifest.json").read_text())
                  for w in ("port", "ref"))
        assert mp["arrays"] == mr["arrays"]
        for entry in mp["arrays"].values():
            a, b = (np.load(tmp_path / w / "step_00000001" / entry["file"])
                    for w in ("port", "ref"))
            np.testing.assert_array_equal(a, b)
        # and each manager reads the other's directory
        like = _tree.tree_map(torch.zeros_like, state)
        got = CheckpointManager(tmp_path / "ref").restore(1, like)
        assert all(_equal(a, b) for a, b in zip(_tree.leaves(state), _tree.leaves(got)))
        got = RefManager(tmp_path / "port").restore(
            1, jax.tree.map(lambda t: jnp.zeros(t.shape, t.numpy().dtype), state,
                            is_leaf=lambda x: isinstance(x, torch.Tensor)))
        for a, b in zip(_tree.leaves(state), jax.tree.leaves(got)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_latest_and_retention(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
        for s in (1, 2, 3, 4):
            mgr.save(s, _state())
        assert mgr.all_steps() == [3, 4]
        assert mgr.latest_step() == 4

    def test_async_write_then_wait(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_write=True)
        mgr.save(5, _state())
        mgr.wait()
        assert mgr.latest_step() == 5

    def test_failed_async_write_raises_on_wait(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_write=True)
        (tmp_path / "step_00000006.tmp").write_text("a file where a directory goes")
        mgr.save(6, _state())
        with pytest.raises(RuntimeError, match="async checkpoint write failed"):
            mgr.wait()

    def test_shape_mismatch_rejected(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_write=False)
        mgr.save(1, {"w": torch.zeros((4, 4))})
        with pytest.raises(ValueError):
            mgr.restore(1, {"w": torch.zeros((2, 2))})

    def test_restore_latest_empty_dir(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        step, state = mgr.restore_latest({"w": torch.zeros(3)})
        assert step is None

    def test_restore_places_leaves(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_write=False)
        mgr.save(1, {"w": torch.ones(3)})
        like = {"w": torch.empty(3, device="meta")}
        assert mgr.restore(1, like)["w"].device.type == "cpu"
        got = mgr.restore(1, like, shardings={"w": torch.device("cpu")})
        assert torch.equal(got["w"], torch.ones(3))


def _cfgs():
    return jax_reduce_config(jax_get_config(ARCH)), reduce_config(get_config(ARCH))


def _port_trainer(steps, ckpt=None, every=100):
    cfg = _cfgs()[1]
    return Trainer(build_model(cfg, max_pos=64, device="cpu"),
                   make_batch_iterator(cfg.vocab_size, 16, 4, seed=3),
                   LoopConfig(total_steps=steps, checkpoint_every=every,
                              checkpoint_dir=ckpt, log_every=100),
                   AdamWConfig(lr=LR, warmup_steps=2, total_steps=12), log_fn=lambda s: None)


def _ref_trainer(steps, ckpt=None, every=100):
    jcfg = _cfgs()[0]
    return RefTrainer(jax_build_model(jcfg, max_pos=64),
                      ref_batches(jcfg.vocab_size, 16, 4, seed=3),
                      RefLoopConfig(total_steps=steps, checkpoint_every=every,
                                    checkpoint_dir=ckpt, log_every=100),
                      RefAdamW(lr=LR, warmup_steps=2, total_steps=12), log_fn=lambda s: None)


class TestCrashResume:
    def test_interrupted_run_resumes_identically(self, tmp_path):
        """Train 12 steps straight vs train 6 + 'crash' + resume 6: the
        final params and optimizer state must match bit for bit."""
        ref = _port_trainer(12).run(seed=1)
        d1 = str(tmp_path / "ck")
        _port_trainer(6, d1, every=6).run(seed=1)
        resumed = _port_trainer(12, d1, every=6).run(seed=1)
        assert resumed["losses"] == ref["losses"][6:]
        for a, b in zip(_tree.leaves({"p": ref["params"], "o": ref["opt_state"]}),
                        _tree.leaves({"p": resumed["params"], "o": resumed["opt_state"]})):
            assert _equal(a, b)


def _close(got_params, got_losses, want_params, want_losses, steps=2):
    np.testing.assert_allclose(got_losses, want_losses, rtol=0, atol=1e-4)
    rel = []
    for a, b in zip(_tree.leaves(got_params), _tree.leaves(want_params)):
        err = (a - b).abs()
        assert float(err.max()) <= 2 * LR * steps
        rel.append((err / torch.clamp(b.abs(), min=2 * LR * steps)).flatten())
    assert float(torch.cat(rel).median()) <= 1e-5


class TestCrossLoading:
    """A step directory of either package resumes the other's trainer,
    which continues 2 steps like the writer's own uninterrupted run."""

    def test_reference_checkpoint_resumes_the_port(self, tmp_path):
        jcfg, cfg = _cfgs()
        straight = _ref_trainer(4).run(seed=1)
        _ref_trainer(2, str(tmp_path / "ref"), every=2).run(seed=1)
        shutil.copytree(tmp_path / "ref" / "step_00000002", tmp_path / "port" / "step_00000002")
        got = _port_trainer(4, str(tmp_path / "port")).run(seed=5)
        want = params_from_jax(jax.tree.map(np.asarray, straight["params"]), cfg, "cpu")
        _close(got["params"], got["losses"], want, straight["losses"][2:])
        want_opt = opt_state_from_jax(jax.tree.map(np.asarray, straight["opt_state"]), cfg,
                                      "cpu")
        assert int(got["opt_state"]["step"]) == int(want_opt["step"]) == 4

    def test_port_checkpoint_resumes_the_reference(self, tmp_path):
        jcfg, cfg = _cfgs()
        straight = _port_trainer(4).run(seed=1)
        _port_trainer(2, str(tmp_path / "port"), every=2).run(seed=1)
        shutil.copytree(tmp_path / "port" / "step_00000002", tmp_path / "ref" / "step_00000002")
        got = _ref_trainer(4, str(tmp_path / "ref")).run(seed=5)
        got_params = params_from_jax(jax.tree.map(np.asarray, got["params"]), cfg, "cpu")
        _close(got_params, got["losses"], straight["params"], straight["losses"][2:])
        assert int(got["opt_state"]["step"]) == 4
