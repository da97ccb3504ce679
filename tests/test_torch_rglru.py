"""The port's RG-LRU path (``repro_torch.kernels.rglru`` and
``repro_torch.models.rglru``) and the reduced recurrentgemma-9b held against
the JAX package on the CPU.

Inputs come from numpy seeds and the same arrays go to both sides.  The
model tests use the reduced recurrentgemma-9b (``reduce_config``: 4 layers
``rglru, rglru, local, rglru``, d 64, 4 query heads over 1 kv head of 16,
window 16, f32) with the reference's own initialised parameters carried
across by ``params_from_jax``.  The reference initialises ``b_a``, ``b_i``
and ``conv_b`` to zero, which would leave the gate and conv biases
untested, so the tree that feeds both sides has them overwritten with
random values first.

Tolerances: 1e-5 for the scan against the reference's oracle, its Pallas
kernel in interpret mode, its associative-scan fallback and the model's
associative and chunked scans (the tests' own limit for the kernel: the
associative scan multiplies the decays in another order); 1e-6 for the
conv and the softplus (the same f32 ops in the same order); 1e-5 for the
block-diagonal matmul and the recurrent block (f32 matmul sums in another
order); 1e-4 for logits after the whole stack.  The tests marked ``cuda``
hold K5 against ``rglru_scan_ref`` on the card and skip without one: bit
for bit (each step is one rounded multiply and one rounded add in both).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.kernels.rglru import ops as jax_ops
from repro.kernels.rglru import ref as jax_ref
from repro.kernels.rglru.kernel import rglru_scan_pallas
from repro.models import rglru as jax_rglru
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.kernels.rglru import kernel as rglru_kernel
from repro_torch.kernels.rglru import ops, ref
from repro_torch.kernels.rglru.kernel import rglru_scan_cuda
from repro_torch.models import rglru
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

ARCH = "recurrentgemma-9b"
# tests/test_kernels.py's RG-LRU shapes: b, t, w, chunk
CASES = [(2, 128, 64, 32), (1, 256, 128, 128), (3, 64, 32, 64)]
# recurrentgemma-9b's width on the main path: prefill 128 and 1024, 891 (the
# serving drain's first prompt, ragged in the kernel's 16-step runs) and
# decode from a carried state
MODEL_CASES = [(128, False), (1024, False), (891, False), (1, True)]
# the leaves the reference initialises to zero, and the scale of the random
# values that replace them in the parity tests
PERTURB = {"b_a": 0.5, "b_i": 0.5, "conv_b": 0.1}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _scan_inputs(b, t, w, seed=0):
    """a, b as in tests/test_kernels.py's TestRGLRU."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 0.999, (b, t, w)).astype(np.float32),
            (rng.standard_normal((b, t, w)) * 0.1).astype(np.float32))


def _h0(b, w, seed=1):
    return (np.random.default_rng(seed).standard_normal((b, w)) * 0.5).astype(np.float32)


def _perturbed(tree, seed=0):
    """The reference's parameter tree (numpy leaves) with the zero RG-LRU
    biases replaced by random values (``PERTURB``)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (walk(v) if isinstance(v, (dict, list)) else
                        _noisy(k, v)) for k, v in node.items()}
        return [walk(v) for v in node]

    def _noisy(name, a):
        a = np.asarray(a)
        if name not in PERTURB:
            return a
        noise = rng.standard_normal(a.shape) * PERTURB[name]
        return (a.astype(np.float32) + noise).astype(a.dtype)

    return walk(tree)


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX model, JAX params, port model, port params), reduced, with
    the zero RG-LRU biases perturbed on both sides."""
    cfg = configs.reduce_config(configs.get_config(ARCH))
    jm = jax_build_model(jax_reduce_config(jax_get_config(ARCH)), max_pos=96)
    tree = _perturbed(jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))))
    jp = jax.tree.map(jnp.asarray, tree)
    pm = build_model(cfg, max_pos=96, device="cpu")
    return cfg, jm, jp, pm, params_from_jax(tree, cfg, "cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape)


def _jax_layer(jp, cfg, layer):
    """Layer ``layer``'s parameters (or cache) from the reference's stacked
    ``{"groups", "remainder"}`` tree."""
    n = len(cfg.pattern)
    reps = cfg.num_layers // n
    if layer < reps * n:
        return jax.tree.map(lambda a: a[layer // n], jp["groups"][layer % n])
    return jp["remainder"][layer - reps * n]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K5 has no CPU mode)")
    return torch.device("cuda")


class TestScan:
    """The recurrence against ``repro.kernels.rglru`` and the reference
    model's scans (atol 1e-5)."""

    @pytest.mark.parametrize("b,t,w,chunk", CASES)
    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_matches_oracle_pallas_and_ops(self, b, t, w, chunk, use_kernel):
        a, bb = _scan_inputs(b, t, w)
        ja, jb = jnp.asarray(a), jnp.asarray(bb)
        got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb),
                             use_kernel=use_kernel)
        assert got.dtype == torch.float32 and got.shape == (b, t, w)
        # ops.rglru_scan takes the Pallas kernel when T % 128 == 0, else its
        # associative-scan fallback: (3, 64, 32) reaches the fallback
        for want in (jax_ref.rglru_scan_ref(ja, jb),
                     rglru_scan_pallas(ja, jb, chunk=chunk, interpret=True),
                     jax_ops.rglru_scan(ja, jb)):
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    # 37 and 256 take the model's associative scan (T <= 256 or ragged),
    # 512 its chunked lax.scan (chunks of 256)
    @pytest.mark.parametrize("t", [37, 256, 512])
    @pytest.mark.parametrize("with_h0", [False, True])
    def test_matches_the_models_scans(self, t, with_h0):
        a, bb = _scan_inputs(2, t, 48, seed=t)
        h0 = _h0(2, 48) if with_h0 else None
        want = jax_rglru._rglru_scan(jnp.asarray(a), jnp.asarray(bb),
                                     None if h0 is None else jnp.asarray(h0))
        got = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bb),
                                 None if h0 is None else torch.from_numpy(h0))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("t", [1, 19])
    def test_carried_state_matches_oracle(self, t):
        a, bb = _scan_inputs(3, t, 40, seed=2)
        h0 = _h0(3, 40)
        want = jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0))
        got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb),
                             h0=torch.from_numpy(h0))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    def test_state_continuity_between_calls(self):
        """One 2T call equals two T calls with the state carried through
        ``h0``, on both entries of the port, bit for bit (the same steps)."""
        a, bb = map(torch.from_numpy, _scan_inputs(2, 128, 32, seed=3))
        full = ref.rglru_scan_ref(a, bb)
        h1 = rglru_scan_cuda(a[:, :64], bb[:, :64], chunk=32)
        h2 = ops.rglru_scan(a[:, 64:], bb[:, 64:], h0=h1[:, -1])
        torch.testing.assert_close(torch.cat([h1, h2], 1), full, rtol=0, atol=0)

    @pytest.mark.parametrize("b,t,w,chunk", CASES)
    def test_kernel_wrapper_on_cpu_is_the_oracle(self, b, t, w, chunk):
        a, bb = map(torch.from_numpy, _scan_inputs(b, t, w, seed=1))
        before = rglru_scan_cuda.launches
        got = rglru_scan_cuda(a, bb, chunk=chunk)
        assert rglru_scan_cuda.launches == before       # the plain version ran
        torch.testing.assert_close(got, ref.rglru_scan_ref(a, bb), rtol=0, atol=0)

    def test_chunk_contract(self):
        a, bb = map(torch.from_numpy, _scan_inputs(1, 48, 8))
        with pytest.raises(ValueError, match="not divisible"):
            rglru_scan_cuda(a, bb, chunk=32)

    def test_reference_positional_call_takes_the_plain_path(self, monkeypatch):
        """``rglru_scan(a, b, False)``, the reference's positional
        ``use_pallas=False``, takes the plain path and equals the
        reference's own call (its associative scan)."""
        a, bb = _scan_inputs(2, 40, 24, seed=5)
        want = jax_ops.rglru_scan(jnp.asarray(a), jnp.asarray(bb), False)

        def refuse(*args, **kw):
            raise AssertionError("the kernel wrapper was called")

        monkeypatch.setattr(ops, "rglru_scan_cuda", refuse)
        got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb), False)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    def test_a_fourth_positional_argument_raises(self):
        a, bb = map(torch.from_numpy, _scan_inputs(1, 4, 8))
        with pytest.raises(TypeError):
            ops.rglru_scan(a, bb, True, torch.zeros(1, 8))

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_h0_by_keyword_carries_the_state(self, use_kernel):
        a, bb = _scan_inputs(2, 13, 24, seed=6)
        h0 = _h0(2, 24, seed=7)
        want = jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0))
        got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb), use_kernel,
                             h0=torch.from_numpy(h0))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    def test_rejects_mismatched_shapes(self):
        a, bb = map(torch.from_numpy, _scan_inputs(2, 8, 16))
        with pytest.raises(ValueError, match="b is"):
            ops.rglru_scan(a, bb[:, :4])
        with pytest.raises(ValueError, match="h0 is"):
            ops.rglru_scan(a, bb, h0=torch.zeros(2, 8))
        with pytest.raises(ValueError, match=r"\(B, T, W\)"):
            ops.rglru_scan(a[0], bb[0])


class TestBlocks:
    """The recurrent block's parts against ``repro.models.rglru``."""

    @staticmethod
    def _layer(pair, layer=0):
        cfg, _, jp, _, pp = pair
        return cfg, _jax_layer(jp["stack"], cfg, layer)["rec"], pp["stack"][layer]["rec"]

    @pytest.mark.parametrize("t", [1, 2, 9])
    @pytest.mark.parametrize("with_state", [False, True])
    def test_causal_conv(self, pair, t, with_state):
        cfg, jl, pl = self._layer(pair)
        rng = np.random.default_rng(t)
        x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
        st = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32) \
            if with_state else None
        want_y, want_s = jax_rglru._causal_conv(
            jnp.asarray(x), jl["conv_w"], jl["conv_b"],
            None if st is None else jnp.asarray(st))
        got_y, got_s = rglru._causal_conv(_t(x), pl["conv_w"], pl["conv_b"],
                                          None if st is None else _t(st))
        np.testing.assert_allclose(got_y.numpy(), _np(want_y), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got_s.numpy(), _np(want_s))

    def test_block_diag_matmul(self, pair):
        cfg, jl, pl = self._layer(pair)
        u = np.random.default_rng(7).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
        want = jax_rglru._block_diag_matmul(jnp.asarray(u), jl["w_a"])
        got = rglru._block_diag_matmul(_t(u), pl["w_a"])
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("w", [8, 24, 64, 100, 4096, 4098])
    def test_gate_blocks(self, w):
        assert rglru._gate_blocks(w) == jax_rglru._gate_blocks(w)

    def test_softplus_is_the_references(self):
        x = np.concatenate([np.linspace(-30, 30, 241),
                            [-4.3, 19.9, 20.0, 20.1, 88.0]]).astype(np.float32)
        np.testing.assert_allclose(rglru._softplus(_t(x)).numpy(),
                                   _np(jax.nn.softplus(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)

    # T = 1 with a cache is the reference's inline decode update; 37 is a
    # prefill (from zero, or from a carried state and conv history)
    @pytest.mark.parametrize("t,with_cache", [(1, True), (37, False), (37, True)])
    def test_rglru_block(self, pair, t, with_cache):
        cfg, jl, pl = self._layer(pair, layer=1)
        rng = np.random.default_rng(10 + t)
        x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
        c = {"h": rng.standard_normal((2, cfg.d_model)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)} \
            if with_cache else None
        want, wc = jax_rglru.rglru_block(
            jl, jnp.asarray(x), cfg,
            cache=None if c is None else {k: jnp.asarray(v) for k, v in c.items()})
        got, gc = rglru.rglru_block(
            pl, _t(x), cfg, cache=None if c is None else {k: _t(v) for k, v in c.items()})
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
        if c is None:
            assert gc is None and wc is None
        else:
            np.testing.assert_allclose(gc["h"].numpy(), _np(wc["h"]), rtol=0, atol=1e-5)
            np.testing.assert_array_equal(gc["conv"].numpy(), _np(wc["conv"]))

    def test_prefill_then_decode_equals_one_pass(self, pair):
        """The block over 12 tokens equals 8 tokens then 4 decode steps with
        the state and the conv history carried in the cache."""
        cfg, _, pl = self._layer(pair, layer=3)
        x = _t(np.random.default_rng(11).standard_normal((1, 12, cfg.d_model)))
        zero = {"h": torch.zeros(1, cfg.d_model), "conv": torch.zeros(1, 3, cfg.d_model)}
        full, _ = rglru.rglru_block(pl, x, cfg, cache=zero)
        y, c = rglru.rglru_block(pl, x[:, :8], cfg, cache=zero)
        outs = [y]
        for i in range(8, 12):
            y, c = rglru.rglru_block(pl, x[:, i:i + 1], cfg, cache=c)
            outs.append(y)
        torch.testing.assert_close(torch.cat(outs, 1), full, rtol=0, atol=1e-6)

    def test_init_matches_reference_layout(self, pair):
        cfg, _, jp, _, _ = pair
        jl = jax_build_model(jax_reduce_config(jax_get_config(ARCH))).init_params(
            jax.random.key(0))["stack"]["groups"][0]["rec"]
        mine = rglru.rglru_init(torch.Generator().manual_seed(0), cfg)
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape[1:]) for k, v in jl.items()}
        for name in ("conv_b", "b_a", "b_i"):
            assert not mine[name].any()
        np.testing.assert_allclose(mine["lam"].numpy(), _np(jl["lam"][0]),
                                   rtol=1e-5, atol=1e-6)
        assert float(mine["conv_w"].abs().max()) <= 0.3 + 1e-6


class TestModel:
    """The reduced recurrentgemma-9b's logits against the reference (atol
    1e-4), prompts longer than the 16-slot ring of its local layer."""

    def test_forward(self, pair):
        cfg, jm, jp, pm, pp = pair
        assert cfg.layer_kinds() == ["rglru", "rglru", "local", "rglru"]
        toks = _tokens(cfg, (2, 29))
        want, _, _ = jm.forward(jp, jnp.asarray(toks))
        got, none, aux = pm.forward(pp, torch.from_numpy(toks))
        assert got.shape == (2, 29, cfg.vocab_padded()) and none is None and aux == 0
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)

    # (prompt, end): a one-token prompt (the reference's decode branch at
    # prefill), and prompts shorter and longer than the ring, decoded past
    # the point where the ring wraps
    @pytest.mark.parametrize("t,end", [(1, 4), (9, 19), (21, 25)])
    def test_prefill_and_decode_steps(self, pair, t, end):
        """Prefill, then decode; the caches (state, conv history, ring) too."""
        cfg, jm, jp, pm, pp = pair
        toks = _tokens(cfg, (1, end), seed=t)
        jc, pc = jm.init_cache(1, 64), pm.init_cache(1, 64)
        want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :t])}, jc)
        got, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :t])}, pc)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)
        for pos in range(t, toks.shape[1]):
            step = toks[:, pos:pos + 1]
            want, jc = jm.decode_step(jp, jnp.asarray(step), pos, jc)
            got, pc = pm.decode_step(pp, torch.from_numpy(step), pos, pc)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)
        for layer in range(cfg.num_layers):
            jl = _jax_layer(jc, cfg, layer)
            assert set(pc[layer]) == set(jl)
            for name, val in pc[layer].items():
                np.testing.assert_allclose(val.numpy(), _np(jl[name]), rtol=0, atol=1e-5)

    def test_prefill_then_decode_equals_forward(self, pair):
        """``tests/test_models_smoke.py``'s check, on the port, through a
        wrapped ring."""
        cfg, _, _, pm, pp = pair
        toks = torch.from_numpy(_tokens(cfg, (2, 40), seed=2))
        full, _, _ = pm.forward(pp, toks)
        caches = pm.init_cache(2, 48)
        logits, caches = pm.prefill(pp, {"tokens": toks[:, :20]}, caches)
        torch.testing.assert_close(logits[:, -1], full[:, 19], rtol=0, atol=1e-5)
        for pos in range(20, 40):
            logits, caches = pm.decode_step(pp, toks[:, pos:pos + 1], pos, caches)
            torch.testing.assert_close(logits[:, 0], full[:, pos], rtol=0, atol=1e-5)

    def test_loss_fn(self, pair):
        cfg, jm, jp, pm, pp = pair
        toks, labels = _tokens(cfg, (2, 9), 3), _tokens(cfg, (2, 9), 4)
        want, _ = jm.loss_fn(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        got, _ = pm.loss_fn(pp, {"tokens": torch.from_numpy(toks),
                                 "labels": torch.from_numpy(labels)})
        np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)

    def test_scan_goes_through_the_one_switch(self, pair, monkeypatch):
        """Every prefill and decode step of every rglru layer reaches
        ``ops.rglru_scan``, and ``use_kernel=False`` asks it for the plain
        version."""
        cfg, _, _, _, pp = pair
        seen = []

        def spy(a, b, use_kernel=True, *, h0=None):
            seen.append((a.shape[1], h0 is not None, use_kernel))
            return ops.rglru_scan(a, b, use_kernel, h0=h0)

        monkeypatch.setattr(rglru, "rglru_scan", spy)
        pm = build_model(cfg, device="cpu", use_kernel=False)
        caches = pm.init_cache(1, 32)
        _, caches = pm.prefill(pp, {"tokens": torch.arange(6)[None]}, caches)
        pm.decode_step(pp, torch.tensor([[3]]), 6, caches)
        assert seen == [(6, True, False)] * 3 + [(1, True, False)] * 3

    def test_init_params_and_cache_match_reference_layout(self, pair):
        cfg, jm, _, pm, pp = pair
        mine = pm.init_params(torch.Generator().manual_seed(0))
        shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
        assert shapes(mine) == shapes(pp)
        jc = jm.init_cache(2, 24)
        for layer, got in enumerate(pm.init_cache(2, 24)):
            want = _jax_layer(jc, cfg, layer)
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in got.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}

    def test_bf16_leaves_cross_exactly(self):
        jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(ARCH)),
                                   dtype="bfloat16")
        cfg = dataclasses.replace(configs.reduce_config(configs.get_config(ARCH)),
                                  dtype="bfloat16")
        jp = jax_build_model(jcfg).init_params(jax.random.key(1))
        pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
        for layer in range(cfg.num_layers):
            jl = _jax_layer(jp["stack"], cfg, layer)
            if "rec" not in jl:
                continue
            for name, leaf in jl["rec"].items():
                got = pp["stack"][layer]["rec"][name]
                assert got.dtype == (torch.float32 if name == "lam" else torch.bfloat16)
                np.testing.assert_array_equal(got.float().numpy(), _np(leaf))

    def test_bf16_model_rounds_the_state(self):
        cfg = dataclasses.replace(configs.reduce_config(configs.get_config(ARCH)),
                                  dtype="bfloat16")
        pm = build_model(cfg, device="cpu")
        pp = pm.init_params(torch.Generator().manual_seed(0))
        caches = pm.init_cache(1, 8)
        logits, caches = pm.prefill(pp, {"tokens": torch.arange(5)[None]}, caches)
        logits, caches = pm.decode_step(pp, torch.tensor([[7]]), 5, caches)
        assert logits.dtype == torch.bfloat16 and bool(logits.isfinite().all())
        assert caches[0]["h"].dtype == caches[0]["conv"].dtype == torch.bfloat16
        assert pp["stack"][0]["rec"]["lam"].dtype == torch.float32
        assert caches[2]["k"].shape[1] == 8     # the ring: min(window 16, max_seq 8)


@pytest.mark.cuda
class TestKernelOnCard:
    """K5 against its plain version on the card, bit for bit."""

    @pytest.mark.parametrize("b,t,w,chunk", CASES)
    def test_f32(self, cuda, b, t, w, chunk):
        a, bb = (torch.from_numpy(x).to(cuda) for x in _scan_inputs(b, t, w))
        before = rglru_scan_cuda.launches
        got = rglru_scan_cuda(a, bb, chunk=chunk)
        torch.cuda.synchronize()
        assert rglru_scan_cuda.launches == before + 1
        torch.testing.assert_close(got, ref.rglru_scan_ref(a, bb), rtol=0, atol=0)

    @pytest.mark.parametrize("t,carried", MODEL_CASES)
    def test_model_shapes(self, cuda, t, carried):
        a, bb = (torch.from_numpy(x).to(cuda) for x in _scan_inputs(1, t, 4096, seed=t))
        h0 = torch.from_numpy(_h0(1, 4096)).to(cuda) if carried else None
        torch.testing.assert_close(ops.rglru_scan(a, bb, h0=h0),
                                   ref.rglru_scan_ref(a, bb, h0), rtol=0, atol=0)

    def test_state_continuity(self, cuda):
        a, bb = (torch.from_numpy(x).to(cuda) for x in _scan_inputs(2, 100, 200, seed=4))
        h1 = ops.rglru_scan(a[:, :37].contiguous(), bb[:, :37].contiguous())
        h2 = ops.rglru_scan(a[:, 37:].contiguous(), bb[:, 37:].contiguous(),
                            h0=h1[:, -1].contiguous())
        torch.testing.assert_close(torch.cat([h1, h2], 1), ref.rglru_scan_ref(a, bb),
                                   rtol=0, atol=0)

    def test_rejects_a_strided_or_bf16_input(self, cuda):
        a, bb = (torch.from_numpy(x).to(cuda) for x in _scan_inputs(1, 8, 64))
        with pytest.raises(ValueError, match="contiguous"):
            ops.rglru_scan(a[:, :, ::2], bb[:, :, ::2])
        with pytest.raises(TypeError, match="float32"):
            ops.rglru_scan(a.bfloat16(), bb.bfloat16())

    # widths either side of a 32-channel strip and not a multiple of 4 (the
    # 4-byte copies), a multiple of 4 with a partial strip (16-byte copies);
    # lengths either side of a stage and past the ring's wrap
    @pytest.mark.parametrize("w", [31, 33, 100, 4095, 4097])
    @pytest.mark.parametrize("stages,extra", [(1, -1), (1, 0), (1, 1), (6, 1)])
    def test_strip_and_stage_edges(self, cuda, w, stages, extra):
        t = stages * rglru_kernel.stage_steps() + extra
        a, bb = (torch.from_numpy(x).to(cuda) for x in _scan_inputs(3, t, w, seed=w + t))
        h0 = torch.from_numpy(_h0(3, w)).to(cuda)
        for h in (None, h0):
            torch.testing.assert_close(ops.rglru_scan(a, bb, h0=h),
                                       ref.rglru_scan_ref(a, bb, h), rtol=0, atol=0)
