"""The port's train step for every configuration, its checkpoints for every
family, and the plain backward recurrences of K4 and K5, held against the
JAX package on the CPU.

* One train step of each of the ten reduced configurations
  (``reduce_config``, f32, ``microbatches=1``) with the reference's own
  initial parameters carried across by ``params_from_jax`` (the VLM's
  cross-attention gates set non-zero in both trees, since tanh(0) silences
  the cross path), the reference's synthetic corpus (seed 3, 2 x 32
  tokens; whisper's frames and the VLM's image tokens from numpy seed 5),
  through the port's ``make_train_step`` (the plain path, as on every CPU
  tensor) and the reference's under ``jax.jit``.  The gradient is read
  from the step's own first moment: after one step m = (1 - b1) clip(g) in
  both packages.  Limits: the loss within 1e-5 relative; each leaf's m
  within 1e-5 of that leaf's largest |m|, with two measured exceptions:

  - rwkv6-3b: the time-mix rounds its f32 projections r, k, v to bf16 in
    both packages (``tests/test_torch_rwkv.py``), and the two frameworks
    sum those matmuls in other orders, so now and then a value on a
    rounding boundary lands one bf16 ulp apart; through the backward that
    moves every leaf's gradient, by up to 2.3e-3 of its largest |m| here
    (the loss by 3.8e-7).  The limit is 1e-2; dropping the bonus u or the
    token shift's carried x in the port moves the gradients by far more
    (``TestLimitsCatchFaults``);
  - llama-3.2-vision-90b's ``gate_m``: each layer's gradient is a sum of
    2 x 32 x 64 products that cancel to 6.4e-5, and both packages' f32
    sums lie 3.0e-5 and 5.6e-5 of that from a float64 evaluation of the
    port; the two are 2.6e-5 apart.  The limit for the gates is 1e-4.

* The checkpoint layout of each family (dense: gemma3-1b's local layers;
  moe, hybrid, ssm, encdec and vlm), in f32 (ROADMAP R6): a step directory
  the reference's manager writes from random parameters and optimizer
  moments restores into the port's ``Trainer`` bit for bit, and one the
  port's ``Trainer`` writes restores into the reference's manager bit for
  bit.  (qwen2-0.5b's whole trainer cross-load is in
  ``tests/test_torch_checkpoint.py``.)

* ``wkv6_bwd_ref`` and ``rglru_scan_bwd_ref`` against ``jax.vjp`` of the
  reference's ``wkv6_ref`` / ``rglru_scan_ref`` (numpy inputs from a seed,
  s0 / h0 given and absent, decays near 0 and near 1): each gradient within
  1e-5 of its largest |ref|; and against torch autograd through the port's
  refs: rglru bit for bit, wkv6 within 1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.pipeline as ref_pipeline
from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.configs import reduce_config as jax_reduce_config
from repro.kernels.rglru.ref import rglru_scan_ref as jax_rglru_ref
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models.model import build_model as jax_build_model
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro_torch import _tree
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels.rglru.ref import rglru_scan_bwd_ref, rglru_scan_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref, wkv6_ref
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.models.model import build_model
from repro_torch.train import optimizer, train_step
from repro_torch.train.loop import LoopConfig, Trainer

ARCHS = list_archs()
SEQ, BATCH, SEED = 32, 2, 3
LR = 1e-3
LOSS_REL, GRAD_REL = 1e-5, 1e-5
# the measured exceptions of the module docstring: (arch, leaf name or None
# for every leaf) -> limit
GRAD_EXCEPTIONS = {("rwkv6-3b", None): 1e-2,
                   ("llama-3.2-vision-90b", "gate_m"): 1e-4,
                   ("llama-3.2-vision-90b", "gate_x"): 1e-4}
FAMILY_ARCHS = {"dense": "gemma3-1b", "moe": "qwen3-moe-30b-a3b",
                "hybrid": "recurrentgemma-9b", "ssm": "rwkv6-3b",
                "encdec": "whisper-base", "vlm": "llama-3.2-vision-90b"}


def _gates_on(jp):
    for group in jp["stack"]["groups"]:
        if "gate_x" in group:
            group["gate_x"] = group["gate_x"] + 0.5
            group["gate_m"] = group["gate_m"] - 0.7
    return jp


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(arch)), microbatches=1)
    cfg = dataclasses.replace(reduce_config(get_config(arch)), microbatches=1)
    jm = jax_build_model(jcfg, max_pos=64)
    pm = build_model(cfg, max_pos=64, device="cpu")
    jp = _gates_on(jm.init_params(jax.random.key(0)))
    return cfg, jm, jp, pm


def _batch(cfg):
    b = next(ref_pipeline.make_batch_iterator(cfg.vocab_size, SEQ, BATCH, seed=SEED))
    rng = np.random.default_rng(5)
    if cfg.encoder is not None:
        b["frames"] = (rng.standard_normal(
            (BATCH, cfg.encoder.num_frames, cfg.encoder.d_model)) * 0.1).astype(np.float32)
    if cfg.vision is not None:
        b["vision"] = (rng.standard_normal(
            (BATCH, cfg.vision.num_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return b


def _opt_cfgs():
    kw = dict(lr=LR, warmup_steps=2, total_steps=10)
    return ref_opt.AdamWConfig(**kw), optimizer.AdamWConfig(**kw)


def _port_step(arch, pp, batch):
    cfg, _, _, pm = _models(arch)
    _, opt = _opt_cfgs()
    step = train_step.make_train_step(pm, opt)
    return step(pp, optimizer.init_opt_state(pp),
                {k: torch.as_tensor(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def _steps(arch):
    """One step of each package's train step from the same params and
    batch: (loss, grad norm, first moment m in the port's layout, paths)
    for (reference, port)."""
    cfg, jm, jp, pm = _models(arch)
    jopt, _ = _opt_cfgs()
    batch = _batch(cfg)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jstep = jax.jit(ref_step.make_train_step(jm, jopt))
    _, jo, jmet = jstep(jp, ref_opt.init_opt_state(jp),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    _, po, pmet = _port_step(arch, pp, batch)
    want_m = _tree.leaves(params_from_jax(jax.tree.map(np.asarray, jo["m"]), cfg, "cpu"))
    paths = [p for p, _ in _tree.flatten_with_path(pp)]
    return ((float(jmet["loss"]), float(jmet["grad_norm"]), want_m),
            (float(pmet["loss"]), float(pmet["grad_norm"]), _tree.leaves(po["m"])), paths)


def _limit(arch, path):
    leaf = path.rsplit("/", 1)[-1]
    return GRAD_EXCEPTIONS.get((arch, leaf), GRAD_EXCEPTIONS.get((arch, None), GRAD_REL))


def _gaps(got, want):
    return [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]


@pytest.mark.parametrize("arch", ARCHS)
class TestTrainStepEveryArch:
    def test_loss(self, arch):
        (want, _, _), (got, _, _), _ = _steps(arch)
        assert abs(got - want) <= LOSS_REL * abs(want)

    def test_grad_norm(self, arch):
        (_, want, _), (_, got, _), _ = _steps(arch)
        assert abs(got - want) <= _limit(arch, "grad_norm") * want

    def test_gradient_per_leaf(self, arch):
        (_, _, want), (_, _, got), paths = _steps(arch)
        assert len(got) == len(want)
        bad = {p: gap for p, gap in zip(paths, _gaps(got, want)) if gap > _limit(arch, p)}
        assert bad == {}

    def test_every_leaf_gets_a_gradient(self, arch):
        """The step reaches every leaf (the VLM's gates are set non-zero);
        the reference's zero-gradient leaves are zero in the port too."""
        (_, _, want), (_, _, got), paths = _steps(arch)
        zero = [p for p, g, w in zip(paths, got, want)
                if (float(g.abs().max()) == 0) != (float(w.abs().max()) == 0)]
        assert zero == []


class TestLimitsCatchFaults:
    """rwkv6-3b's looser gradient limit still sees a fault in its time-mix."""

    @pytest.mark.parametrize("fault", ["u dropped", "state not carried"])
    def test_rwkv_fault_exceeds_the_limit(self, monkeypatch, fault):
        arch = "rwkv6-3b"
        cfg, _, jp, _ = _models(arch)
        (_, _, want), _, paths = _steps(arch)
        real = wkv_ops.wkv6

        def faulty(r, k, v, w, u, use_kernel=True, *, s0=None):
            if fault == "u dropped":
                return real(r, k, v, w, u * 0, use_kernel, s0=s0)
            b, t, h, hd = r.shape      # every step from a zero state
            o = torch.cat([real(r[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1],
                                w[:, i:i + 1], u, use_kernel)[0] for i in range(t)], 1)
            return o, torch.zeros((b, h, hd, hd))

        import repro_torch.models.rwkv as rwkv_model
        monkeypatch.setattr(rwkv_model, "wkv6", faulty)
        pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
        _, po, _ = _port_step(arch, pp, _batch(cfg))
        assert max(_gaps(_tree.leaves(po["m"]), want)) > 10 * _limit(arch, "")


# -- checkpoints: each family's layout, both ways ---------------------------

def _random_opt(jp, seed):
    rng = np.random.default_rng(seed)
    jo = ref_opt.init_opt_state(jp)
    rand = lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32))  # noqa: E731
    return {"master": jax.tree.map(rand, jp), "m": jax.tree.map(rand, jp),
            "v": jax.tree.map(lambda p: jnp.abs(rand(p)), jp), "step": jo["step"] + 3}


def _trainer(arch, ckpt):
    cfg, _, _, pm = _models(arch)
    return Trainer(pm, iter(()), LoopConfig(total_steps=0, checkpoint_dir=str(ckpt)),
                   optimizer.AdamWConfig(), log_fn=lambda s: None)


def _equal_trees(a, b):
    la, lb = _tree.leaves(a), _tree.leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
class TestCheckpointEveryFamily:
    def test_reference_checkpoint_restores_into_the_port(self, family, tmp_path):
        arch = FAMILY_ARCHS[family]
        cfg, _, jp, _ = _models(arch)
        jo = _random_opt(jp, 1)
        RefManager(str(tmp_path), async_write=False).save(3, {"params": jp, "opt": jo})
        trainer = _trainer(arch, tmp_path)
        params, opt = trainer.init_state(seed=1)
        latest, params, opt = trainer._restore_latest(params, opt)
        assert latest == 3
        assert _equal_trees(params, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu"))
        assert _equal_trees(opt, opt_state_from_jax(jax.tree.map(np.asarray, jo), cfg, "cpu"))

    def test_port_checkpoint_restores_into_the_reference(self, family, tmp_path):
        arch = FAMILY_ARCHS[family]
        cfg, _, jp, _ = _models(arch)
        trainer = _trainer(arch, tmp_path)
        params, _ = trainer.init_state(seed=2)
        opt = opt_state_from_jax(jax.tree.map(np.asarray, _random_opt(jp, 2)), cfg, "cpu")
        trainer.ckpt.save(5, trainer._saved(params, opt), blocking=True)
        latest, restored = RefManager(str(tmp_path)).restore_latest(
            {"params": jp, "opt": ref_opt.init_opt_state(jp)})
        assert latest == 5
        back = params_from_jax(jax.tree.map(np.asarray, restored["params"]), cfg, "cpu")
        assert _equal_trees(back, params)
        back_opt = opt_state_from_jax(jax.tree.map(np.asarray, restored["opt"]), cfg, "cpu")
        assert _equal_trees(back_opt, opt)


# -- the plain backward recurrences -----------------------------------------

def _wkv_inputs(b, t, h, hd, decay, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)  # noqa: E731
    w = np.exp(-np.exp(decay + f(b, t, h, hd, scale=0.5))).astype(np.float32)
    return (f(b, t, h, hd), f(b, t, h, hd, scale=0.3), f(b, t, h, hd, scale=0.3), w,
            f(h, hd, scale=0.3), f(b, h, hd, hd, scale=0.3), f(b, t, h, hd), f(b, h, hd, hd))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() /
                 max(np.abs(want).max(), 1e-30))


class TestBackwardRefs:
    @pytest.mark.parametrize("with_s0", [False, True])
    @pytest.mark.parametrize("decay", [-8.0, 0.0, 4.0])   # w near 1, mid, near 0
    def test_wkv6_bwd_ref_against_jax_vjp(self, with_s0, decay):
        r, k, v, w, u, s0, do, dst = _wkv_inputs(2, 9, 2, 8, decay)
        args = [r, k, v, w, u] + ([s0] if with_s0 else [])
        _, vjp = jax.vjp(jax_wkv6_ref, *(jnp.asarray(x) for x in args))
        want = vjp((jnp.asarray(do), jnp.asarray(dst)))
        got = wkv6_bwd_ref(*(torch.from_numpy(x) for x in (r, k, v, w, u)),
                           torch.from_numpy(s0) if with_s0 else None,
                           torch.from_numpy(do), torch.from_numpy(dst))
        for g, x in zip(got, want):
            assert _rel(g.numpy(), x) <= 1e-5

    @pytest.mark.parametrize("with_s0", [False, True])
    def test_wkv6_bwd_ref_against_torch_autograd(self, with_s0):
        r, k, v, w, u, s0, do, dst = (torch.from_numpy(x) for x in _wkv_inputs(1, 12, 3, 16, 0.0))
        leaves = [x.requires_grad_(True) for x in (r, k, v, w, u)] + \
            ([s0.requires_grad_(True)] if with_s0 else [])
        o, st = wkv6_ref(*leaves[:5], s0=leaves[5] if with_s0 else None)
        want = torch.autograd.grad((o, st), leaves, (do, dst))
        got = wkv6_bwd_ref(*(x.detach() for x in (r, k, v, w, u)),
                           s0.detach() if with_s0 else None, do, dst)
        for g, x in zip(got, want):
            assert _rel(g.numpy(), x.numpy()) <= 1e-6

    def test_wkv6_bwd_ref_without_a_final_state_gradient(self):
        r, k, v, w, u, s0, do, _ = (torch.from_numpy(x) for x in _wkv_inputs(1, 5, 1, 8, 0.0))
        leaves = [x.requires_grad_(True) for x in (r, k, v, w, u)]
        o, _ = wkv6_ref(*leaves)
        want = torch.autograd.grad(o, leaves, do)
        got = wkv6_bwd_ref(*(x.detach() for x in leaves), None, do, None)
        for g, x in zip(got, want):
            assert _rel(g.numpy(), x.numpy()) <= 1e-6

    @pytest.mark.parametrize("with_h0", [False, True])
    @pytest.mark.parametrize("low,high", [(1e-6, 1e-3), (0.0, 1.0), (0.999, 1.0)])
    def test_rglru_scan_bwd_ref_against_jax_vjp_and_autograd(self, with_h0, low, high):
        rng = np.random.default_rng(4)
        a = rng.uniform(low, high, (2, 11, 6)).astype(np.float32)
        b, dh = (rng.standard_normal((2, 11, 6)).astype(np.float32) for _ in range(2))
        h0 = rng.standard_normal((2, 6)).astype(np.float32) if with_h0 else None
        args = [a, b] + ([h0] if with_h0 else [])
        _, vjp = jax.vjp(jax_rglru_ref, *(jnp.asarray(x) for x in args))
        want = vjp(jnp.asarray(dh))
        ta, tb, tdh = (torch.from_numpy(x) for x in (a, b, dh))
        th0 = torch.from_numpy(h0) if with_h0 else None
        got = rglru_scan_bwd_ref(ta, rglru_scan_ref(ta, tb, th0), tdh, th0)
        assert (got[2] is None) == (not with_h0)
        for g, x in zip(got, want):
            assert _rel(g.numpy(), x) <= 1e-5
        leaves = [x.clone().requires_grad_(True) for x in (ta, tb)] + \
            ([th0.clone().requires_grad_(True)] if with_h0 else [])
        auto = torch.autograd.grad(rglru_scan_ref(*leaves[:2], leaves[2] if with_h0 else None),
                                   leaves, tdh)
        for g, x in zip(got, auto):
            torch.testing.assert_close(g, x, rtol=0, atol=0)
