"""The port's RWKV-6 path (``repro_torch.kernels.rwkv6`` and
``repro_torch.models.rwkv``) held against the JAX package on the CPU.

Inputs come from numpy seeds and the same arrays go to both sides.  The
model tests use the reduced rwkv6-3b (``reduce_config``: 2 layers, d 64,
one head of 64, f32) with the reference's own initialised parameters
carried across by ``params_from_jax``.  The reference initialises
``mix_lora_b``, ``decay_lora_b`` and ``gn_bias`` to zero (and ``decay_base``
to a constant), which would leave the data-dependent lerp and decay paths
and the group norm's bias untested, so the parameter tree that feeds both
sides has those leaves overwritten with random values first.

Tolerances: atol 1e-4 for the WKV recurrence against the reference's
oracle and its Pallas kernel in interpret mode (its own test's limit: f32
sums over hd in another order, carried through the state), for the
channel-mix and for the logits of the whole stack.  The time-mix rounds its
f32 projections r, k, v to bf16; the two frameworks sum those matmuls in
other orders, so now and then (about once in 5000 values here) a value on a
rounding boundary lands one bf16 ulp apart, which moves that token's
outputs, and through the state later ones, by up to 2e-4 of the largest
|output|.  So the time-mix (output and state) is held per row: the median
row's largest error within 1e-4 (it reads 2e-5 at most) and every element
within 1e-3 of the largest |value| (dropping the bf16 rounding moves the
median row by 2.6e-3 and the worst element by 2e-3 of the largest, and a
wrong variance, lerp order or bonus far more).  The port's prefill then
decode against its own full forward at ``tests/test_models_smoke.py``'s
2e-4 + 1e-3 |ref|.  The tests marked ``cuda`` hold K4 against
``wkv6_ref`` on the card and skip without one: per element, 1e-5 of the
shape's largest |ref| (both sum the same f32 products from the same
bf16-rounded r, k, v, in other orders).  ``_chunked_wkv6`` emulates K4's
three phases (local chunks from zero, the carry, the correction) in plain
PyTorch, off the main path, and is held to the same 1e-5 of the largest
|ref| against both packages' ``wkv6_ref`` at the chunk boundaries.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.kernels.rwkv6 import kernel as jax_kernel
from repro.kernels.rwkv6 import ops as jax_ops
from repro.kernels.rwkv6 import ref as jax_ref
from repro.models import rwkv as jax_rwkv
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from repro_torch.kernels.rwkv6 import ops, ref
from repro_torch.kernels.rwkv6.kernel import wkv6_cuda
from repro_torch.models import rwkv
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

ARCH = "rwkv6-3b"
# tests/test_kernels.py's WKV6 shapes: b, t, h, hd, chunk
CASES = [(2, 64, 2, 16, 32), (1, 128, 4, 32, 64), (2, 32, 1, 8, 32)]
# rwkv6-3b's heads on the main path: prefill 128 and 1024, 891 (the
# serving drain's first prompt, ragged in the kernel's 32-step runs) and
# decode from a carried state
MODEL_CASES = [(128, False), (1024, False), (891, False), (1, True)]
# K4's time chunk, and lengths on either side of its boundaries: one launch
# (1, C - 1, C) and three (C + 1, several chunks with a ragged last one)
CHUNK = wkv_kernel.TIME_CHUNK
CHUNK_LENGTHS = [1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 5]
# K4's limit per element of o and sT: this share of the shape's largest |ref|
K4_REL = 1e-5
# the leaves the reference initialises to a constant, and the scale of the
# random values that replace them in the parity tests
PERTURB = {"mix_lora_b": 0.5, "decay_lora_b": 0.5, "gn_bias": 0.1,
           "decay_base": 1.0}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _wkv_inputs(b, t, h, hd, seed=0):
    """r, k, v, w, u as in tests/test_kernels.py's TestWKV6."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((b, t, h, hd)).astype(f32),
            (rng.standard_normal((b, t, h, hd)) * 0.3).astype(f32),
            (rng.standard_normal((b, t, h, hd)) * 0.3).astype(f32),
            rng.uniform(0.8, 0.999, (b, t, h, hd)).astype(f32),
            (rng.standard_normal((h, hd)) * 0.3).astype(f32))


def _state(b, h, hd, seed=1):
    return (np.random.default_rng(seed).standard_normal((b, h, hd, hd)) * 0.5
            ).astype(np.float32)


def _extreme_decays(w):
    """``w`` with decays planted in whole rows of every head: 1e-30 every
    7th step in rows 1 mod 8 (two in a chunk underflow its product to 0),
    exactly 0 every 11th step in rows 2 mod 8, and 1.0 throughout rows 3
    mod 8."""
    w = w.copy()
    steps = np.arange(w.shape[1])
    w[:, steps % 7 == 2, :, 1::8] = 1e-30
    w[:, steps % 11 == 3, :, 2::8] = 0.0
    w[..., 3::8] = 1.0
    return w


def _chunked_wkv6(r, k, v, w, u, s0=None, chunk=CHUNK):
    """K4's decomposition in plain PyTorch: (o, sT).  Up to ``chunk`` steps,
    one pass from ``s0``.  Longer: (1) each chunk from a zero state gives
    local outputs, its local end state and its decay product; (2) the
    carry S_{c+1} = diag(Δ_c) S_c + Ŝ_c from ``s0``; (3) each chunk's
    outputs gain S_cᵀ (r_t ⊙ D_t), D_t the decays since the chunk began.
    Each pass sums as K4 does: o = Sᵀ r + v Σ_i r_i u_i k_i."""
    r, k, v = (x.float() for x in (r, k, v))
    b, t, h, hd = r.shape
    ruk = (r * u * k).sum(-1)

    def walk(lo, hi, s):
        outs = []
        for i in range(lo, hi):
            outs.append(torch.einsum("bhij,bhi->bhj", s, r[:, i])
                        + v[:, i] * ruk[:, i, :, None])
            s = w[:, i, :, :, None] * s + k[:, i, :, :, None] * v[:, i, :, None, :]
        return torch.stack(outs, 1), s

    zero = torch.zeros((b, h, hd, hd))
    s = zero if s0 is None else s0.float()
    if t <= chunk:
        return walk(0, t, s)
    bounds = [(lo, min(t, lo + chunk)) for lo in range(0, t, chunk)]
    o = torch.empty((b, t, h, hd))
    local = []
    for lo, hi in bounds:
        o[:, lo:hi], s_end = walk(lo, hi, zero)
        delta = torch.ones((b, h, hd))
        for i in range(lo, hi):
            delta = delta * w[:, i]
        local.append((s_end, delta))
    carried = []
    for s_end, delta in local:
        carried.append(s)
        s = delta[..., None] * s + s_end
    for (lo, hi), s_c in zip(bounds, carried):
        d = torch.ones((b, h, hd))
        for i in range(lo, hi):
            o[:, i] += torch.einsum("bhij,bhi->bhj", s_c, r[:, i] * d)
            d = d * w[:, i]
    return o, s


def _assert_within_k4_limit(got, want):
    """Per element of o and sT: |got - want| <= K4_REL x the largest |want|."""
    for g, r in zip(got, want):
        g, r = _np(g), _np(r)
        assert np.abs(g - r).max() <= K4_REL * np.abs(r).max(), \
            (np.abs(g - r).max(), np.abs(r).max())


def _perturbed(tree, seed=0):
    """The reference's parameter tree (numpy leaves) with the constant RWKV
    leaves replaced by random values (``PERTURB``)."""
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
    the constant RWKV leaves perturbed on both sides."""
    cfg = configs.reduce_config(configs.get_config(ARCH))
    jm = jax_build_model(jax_reduce_config(jax_get_config(ARCH)), max_pos=96)
    tree = _perturbed(jax.tree.map(np.asarray, jm.init_params(jax.random.key(0))))
    jp = jax.tree.map(jnp.asarray, tree)
    pm = build_model(cfg, max_pos=96, device="cpu")
    return cfg, jm, jp, pm, params_from_jax(tree, cfg, "cpu")


def _assert_close_per_row(got, want, atol=1e-4, flip_rtol=1e-3):
    """The time-mix's limit (module docstring): the median row (all but the
    last axis) within ``atol``, every element within ``flip_rtol`` of the
    largest |want|."""
    want = _np(want)
    err = np.abs(got - want).reshape(-1, got.shape[-1]).max(-1)
    assert np.median(err) <= atol, np.median(err)
    assert err.max() <= flip_rtol * np.abs(want).max(), err.max()


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4 has no CPU mode)")
    return torch.device("cuda")


class TestWKV6:
    """The recurrence against ``repro.kernels.rwkv6`` (atol 1e-4)."""

    @pytest.mark.parametrize("b,t,h,hd,chunk", CASES)
    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_matches_oracle_and_pallas(self, b, t, h, hd, chunk, use_kernel):
        args = _wkv_inputs(b, t, h, hd)
        jargs = [jnp.asarray(a) for a in args]
        o_ref, s_ref = jax_ref.wkv6_ref(*jargs)
        o_pal, s_pal = jax_kernel.wkv6_pallas(*jargs, chunk=chunk, interpret=True)
        o, s = ops.wkv6(*map(torch.from_numpy, args), use_kernel=use_kernel)
        assert o.dtype == s.dtype == torch.float32
        assert o.shape == (b, t, h, hd) and s.shape == (b, h, hd, hd)
        for want_o, want_s in ((o_ref, s_ref), (o_pal, s_pal)):
            np.testing.assert_allclose(o.numpy(), _np(want_o), rtol=0, atol=1e-4)
            np.testing.assert_allclose(s.numpy(), _np(want_s), rtol=0, atol=1e-4)

    @pytest.mark.parametrize("b,t,h,hd,chunk", CASES)
    def test_kernel_wrapper_on_cpu_is_the_oracle(self, b, t, h, hd, chunk):
        args = _wkv_inputs(b, t, h, hd, seed=1)
        want = jax_ops.wkv6(*map(jnp.asarray, args), chunk=chunk)
        before = wkv6_cuda.launches
        o, s = wkv6_cuda(*map(torch.from_numpy, args), chunk=chunk)
        assert wkv6_cuda.launches == before       # the plain version ran
        np.testing.assert_allclose(o.numpy(), _np(want[0]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(s.numpy(), _np(want[1]), rtol=0, atol=1e-4)

    def test_state_continuity_between_chunks(self):
        """One 2T call equals two T calls with the state carried through
        ``s0`` (``tests/test_kernels.py``'s continuity case), on both
        entries of the port, against the reference's Pallas kernel."""
        r, k, v, w, u = _wkv_inputs(1, 128, 2, 16, seed=2)
        o_full, s_full = jax_kernel.wkv6_pallas(
            *map(jnp.asarray, (r, k, v, w, u)), chunk=32, interpret=True)
        x = [torch.from_numpy(a) for a in (r, k, v, w)]
        uu = torch.from_numpy(u)
        o1, s1 = wkv6_cuda(*(a[:, :64] for a in x), uu, chunk=32)
        o2, s2 = ops.wkv6(*(a[:, 64:] for a in x), uu, s0=s1)
        np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), _np(o_full),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(s2.numpy(), _np(s_full), rtol=0, atol=1e-4)

    @pytest.mark.parametrize("t", [1, 37])
    def test_carried_state_matches_oracle(self, t):
        r, k, v, w, u = _wkv_inputs(2, t, 3, 16, seed=3)
        s0 = _state(2, 3, 16)
        want_o, want_s = jax_ref.wkv6_ref(*map(jnp.asarray, (r, k, v, w, u)),
                                          s0=jnp.asarray(s0))
        got_o, got_s = ops.wkv6(*map(torch.from_numpy, (r, k, v, w, u)),
                                s0=torch.from_numpy(s0))
        np.testing.assert_allclose(got_o.numpy(), _np(want_o), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got_s.numpy(), _np(want_s), rtol=0, atol=1e-4)

    def test_matches_the_models_chunked_scan(self):
        """``wkv6_ref`` is the port's one plain recurrence: it equals the
        reference model's ``_wkv_chunk_scan`` on its chunked branch (T = 256,
        chunks of 128), from a carried state, with bf16 r, k, v."""
        r, k, v, w, u = _wkv_inputs(1, 256, 1, 64, seed=4)
        s0 = _state(1, 1, 64, seed=5)
        bf = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)]
        want_o, want_s = jax_rwkv._wkv_chunk_scan(*bf, jnp.asarray(w), jnp.asarray(u),
                                                  jnp.asarray(s0))
        got_o, got_s = ref.wkv6_ref(*(torch.from_numpy(a).bfloat16() for a in (r, k, v)),
                                    torch.from_numpy(w), torch.from_numpy(u),
                                    torch.from_numpy(s0))
        np.testing.assert_allclose(got_o.numpy(), _np(want_o), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got_s.numpy(), _np(want_s), rtol=0, atol=1e-4)

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_final_state_written_in_place(self, use_kernel):
        r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(1, 9, 2, 8, seed=6))
        s0 = torch.from_numpy(_state(1, 2, 8))
        want_o, want_s = ref.wkv6_ref(r, k, v, w, u, s0.clone())
        o, s = ops.wkv6(r, k, v, w, u, use_kernel, s0=s0)
        assert s is s0
        torch.testing.assert_close(o, want_o, rtol=0, atol=0)
        torch.testing.assert_close(s0, want_s, rtol=0, atol=0)

    def test_chunk_contract(self):
        args = map(torch.from_numpy, _wkv_inputs(1, 48, 1, 8))
        with pytest.raises(ValueError, match="not divisible"):
            wkv6_cuda(*args, chunk=32)

    def test_rejects_mismatched_shapes(self):
        r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(1, 8, 2, 8))
        with pytest.raises(ValueError, match="u is"):
            ops.wkv6(r, k, v, w, u[:1])
        with pytest.raises(ValueError, match="s0 is"):
            ops.wkv6(r, k, v, w, u, s0=torch.zeros(1, 2, 8, 4))
        with pytest.raises(TypeError, match="share"):
            ops.wkv6(r, k.double(), v, w, u)


    def test_reference_positional_call_takes_the_plain_path(self, monkeypatch):
        """``wkv6(r, k, v, w, u, False)``, the reference's positional
        ``use_pallas=False``, takes the plain path and equals the
        reference's own call."""
        args = _wkv_inputs(2, 21, 3, 16, seed=7)
        want_o, want_s = jax_ops.wkv6(*map(jnp.asarray, args), False)

        def refuse(*a, **kw):
            raise AssertionError("the kernel wrapper was called")

        monkeypatch.setattr(ops, "wkv6_cuda", refuse)
        o, s = ops.wkv6(*map(torch.from_numpy, args), False)
        np.testing.assert_allclose(o.numpy(), _np(want_o), rtol=0, atol=1e-4)
        np.testing.assert_allclose(s.numpy(), _np(want_s), rtol=0, atol=1e-4)

    def test_a_seventh_positional_argument_raises(self):
        r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(1, 4, 1, 8))
        with pytest.raises(TypeError):
            ops.wkv6(r, k, v, w, u, True, torch.zeros(1, 1, 8, 8))

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_s0_by_keyword_carries_the_state(self, use_kernel):
        r, k, v, w, u = _wkv_inputs(1, 11, 2, 8, seed=8)
        s0 = _state(1, 2, 8, seed=9)
        want_o, want_s = jax_ref.wkv6_ref(*map(jnp.asarray, (r, k, v, w, u)),
                                          s0=jnp.asarray(s0))
        o, s = ops.wkv6(*map(torch.from_numpy, (r, k, v, w, u)), use_kernel,
                        s0=torch.from_numpy(s0))
        np.testing.assert_allclose(o.numpy(), _np(want_o), rtol=0, atol=1e-4)
        np.testing.assert_allclose(s.numpy(), _np(want_s), rtol=0, atol=1e-4)

    @pytest.mark.parametrize("hd", [8, 16, 32, 64])
    @pytest.mark.parametrize("t", CHUNK_LENGTHS)
    @pytest.mark.parametrize("with_s0", [False, True])
    def test_chunked_decomposition(self, hd, t, with_s0):
        """K4's three phases, emulated, against both packages' ``wkv6_ref``
        within 1e-5 of the largest |ref|, with decays of 0, 1e-30 and 1."""
        r, k, v, w, u = _wkv_inputs(1, t, 2, hd, seed=hd + t)
        w = _extreme_decays(w)
        s0 = _state(1, 2, hd) if with_s0 else None
        x = [torch.from_numpy(a) for a in (r, k, v, w, u)]
        s0_t = None if s0 is None else torch.from_numpy(s0)
        got = _chunked_wkv6(*x, s0_t)
        _assert_within_k4_limit(got, ref.wkv6_ref(*x, s0=s0_t))
        _assert_within_k4_limit(got, jax_ref.wkv6_ref(
            *map(jnp.asarray, (r, k, v, w, u)), s0=None if s0 is None else jnp.asarray(s0)))


class TestBlocks:
    """``rwkv_time_mix`` and ``rwkv_channel_mix`` against
    ``repro.models.rwkv`` with the constant leaves perturbed (atol 1e-4)."""

    @staticmethod
    def _layer(pair, layer=0):
        cfg, _, jp, _, pp = pair
        jl = jax.tree.map(lambda a: a[layer], jp["stack"]["groups"][0]["tmix"])
        return cfg, jl, pp["stack"][layer]["tmix"]

    @staticmethod
    def _cache(cfg, seed):
        rng = np.random.default_rng(seed)
        h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        return {"s": _state(2, h, hd, seed),
                "x_tm": rng.standard_normal((2, cfg.d_model)).astype(np.float32),
                "x_cm": rng.standard_normal((2, cfg.d_model)).astype(np.float32)}

    # T = 1 with a cache takes the reference's decode branch; 256 its
    # chunked prefill; 37 is ragged in both the reference's and K4's chunks
    @pytest.mark.parametrize("t", [1, 37, 256])
    @pytest.mark.parametrize("with_cache", [False, True])
    def test_time_mix(self, pair, t, with_cache):
        cfg, jl, pl = self._layer(pair)
        x = np.random.default_rng(t).standard_normal((2, t, cfg.d_model)).astype(np.float32)
        c = self._cache(cfg, t) if with_cache else None
        want, wc = jax_rwkv.rwkv_time_mix(
            jl, jnp.asarray(x), cfg,
            cache=None if c is None else {"s": jnp.asarray(c["s"]),
                                          "x_tm": jnp.asarray(c["x_tm"])})
        got, gc = rwkv.rwkv_time_mix(
            pl, _t(x), cfg,
            cache=None if c is None else {"s": _t(c["s"]), "x_tm": _t(c["x_tm"])})
        _assert_close_per_row(got.numpy(), want)
        if c is None:
            assert gc is None and wc is None
        else:
            assert gc["s"].dtype == torch.float32
            _assert_close_per_row(gc["s"].numpy(), wc["s"])
            np.testing.assert_array_equal(gc["x_tm"].numpy(), x[:, -1])

    @pytest.mark.parametrize("t", [1, 37])
    @pytest.mark.parametrize("with_cache", [False, True])
    def test_channel_mix(self, pair, t, with_cache):
        cfg, jl, pl = self._layer(pair, layer=1)
        x = np.random.default_rng(t + 1).standard_normal((2, t, cfg.d_model)).astype(np.float32)
        c = self._cache(cfg, t) if with_cache else None
        want, wc = jax_rwkv.rwkv_channel_mix(
            jl, jnp.asarray(x), cfg,
            cache=None if c is None else {"x_cm": jnp.asarray(c["x_cm"])})
        got, gc = rwkv.rwkv_channel_mix(
            pl, _t(x), cfg, cache=None if c is None else {"x_cm": _t(c["x_cm"])})
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)
        if c is not None:
            np.testing.assert_array_equal(gc["x_cm"].numpy(), _np(wc["x_cm"]))

    def test_token_shift(self):
        x = np.random.default_rng(0).standard_normal((2, 5, 4)).astype(np.float32)
        prev = x[:, 0] * 2
        for p in (None, prev):
            want = jax_rwkv._token_shift(jnp.asarray(x), None if p is None else jnp.asarray(p))
            got = rwkv._token_shift(_t(x), None if p is None else _t(p))
            np.testing.assert_array_equal(got.numpy(), _np(want))

    def test_rounds_rkv_to_bf16_in_an_f32_model(self, pair, monkeypatch):
        """The reference streams r, k, v in bf16 even when the model is f32;
        the port hands the recurrence the same rounded values."""
        cfg, _, pl = self._layer(pair)
        seen = {}

        def spy(r, k, v, w, u, use_kernel=True, *, s0=None):
            seen.update(r=r.dtype, k=k.dtype, v=v.dtype, w=w.dtype, u=u.dtype)
            return ops.wkv6(r, k, v, w, u, use_kernel, s0=s0)

        monkeypatch.setattr(rwkv, "wkv6", spy)
        rwkv.rwkv_time_mix(pl, torch.zeros(1, 3, cfg.d_model), cfg)
        assert seen == {"r": torch.bfloat16, "k": torch.bfloat16, "v": torch.bfloat16,
                        "w": torch.float32, "u": torch.float32}

    def test_init_matches_reference_layout(self, pair):
        cfg, jl, _ = self._layer(pair)
        mine = rwkv.rwkv_init(torch.Generator().manual_seed(0), cfg)
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in jl.items()}
        for name in ("mix_lora_b", "decay_lora_b", "gn_bias"):
            assert not mine[name].any()
        assert bool((mine["decay_base"] == -6).all() and (mine["gn_scale"] == 1).all())
        for name in ("mix_base", "u", "cmix_k", "cmix_r"):
            assert 0 <= float(mine[name].min()) and float(mine[name].max()) < 0.5


class TestModel:
    """The reduced rwkv6-3b's logits against the reference (atol 1e-4)."""

    def test_forward(self, pair):
        cfg, jm, jp, pm, pp = pair
        toks = _tokens(cfg, (2, 13))
        want, _, _ = jm.forward(jp, jnp.asarray(toks))
        got, none, aux = pm.forward(pp, torch.from_numpy(toks))
        assert got.shape == (2, 13, cfg.vocab_padded()) and none is None and aux == 0
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)

    def test_prefill_and_decode_steps(self, pair):
        """Prefill of a one-token prompt takes the reference's decode branch."""
        cfg, jm, jp, pm, pp = pair
        toks = _tokens(cfg, (1, 9), seed=1)
        for t in (1, 5):
            jc, pc = jm.init_cache(1, 16), pm.init_cache(1, 16)
            want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :t])}, jc)
            got, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :t])}, pc)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)
            for pos in range(t, toks.shape[1]):
                step = toks[:, pos:pos + 1]
                want, jc = jm.decode_step(jp, jnp.asarray(step), pos, jc)
                got, pc = pm.decode_step(pp, torch.from_numpy(step), pos, pc)
                np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)

    def test_prefill_then_decode_equals_forward(self, pair):
        """``tests/test_models_smoke.py``'s check, on the port."""
        cfg, _, _, pm, pp = pair
        toks = torch.from_numpy(_tokens(cfg, (2, 24), seed=2))
        full, _, _ = pm.forward(pp, toks)
        caches = pm.init_cache(2, 40)
        logits, caches = pm.prefill(pp, {"tokens": toks[:, :16]}, caches)
        torch.testing.assert_close(logits[:, -1], full[:, 15], atol=2e-4, rtol=1e-3)
        for pos in range(16, 24):
            logits, caches = pm.decode_step(pp, toks[:, pos:pos + 1], pos, caches)
            torch.testing.assert_close(logits[:, 0], full[:, pos], atol=2e-4, rtol=1e-3)

    def test_loss_fn(self, pair):
        cfg, jm, jp, pm, pp = pair
        toks, labels = _tokens(cfg, (2, 9), 3), _tokens(cfg, (2, 9), 4)
        want, _ = jm.loss_fn(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        got, _ = pm.loss_fn(pp, {"tokens": torch.from_numpy(toks),
                                 "labels": torch.from_numpy(labels)})
        np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)

    def test_cache_writes_the_state_in_place(self, pair):
        cfg, _, _, pm, pp = pair
        caches = pm.init_cache(1, 8)
        s = [c["s"] for c in caches]
        _, new = pm.prefill(pp, {"tokens": torch.from_numpy(_tokens(cfg, (1, 4)))}, caches)
        assert all(c["s"] is before for c, before in zip(new, s))
        assert all(bool(c["s"].any()) for c in new)

    def test_init_params_and_cache_match_reference_layout(self, pair):
        cfg, jm, _, pm, pp = pair
        mine = pm.init_params(torch.Generator().manual_seed(0))
        shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
        assert shapes(mine) == shapes(pp)
        jc = jm.init_cache(2, 24)["groups"][0]
        for layer in pm.init_cache(2, 24):
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in layer.items()} == \
                {k: (tuple(v.shape[1:]), str(v.dtype)) for k, v in jc.items()}

    def test_bf16_leaves_cross_exactly(self):
        jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(ARCH)),
                                   dtype="bfloat16")
        cfg = dataclasses.replace(configs.reduce_config(configs.get_config(ARCH)),
                                  dtype="bfloat16")
        jp = jax_build_model(jcfg).init_params(jax.random.key(1))
        pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
        jt = jp["stack"]["groups"][0]["tmix"]
        for layer in range(cfg.num_layers):
            for name, leaf in jt.items():
                got = pp["stack"][layer]["tmix"][name]
                assert got.dtype == torch.bfloat16, name
                np.testing.assert_array_equal(got.float().numpy(), _np(leaf[layer]))

    def test_bf16_model_keeps_an_f32_state(self):
        cfg = dataclasses.replace(configs.reduce_config(configs.get_config(ARCH)),
                                  dtype="bfloat16")
        pm = build_model(cfg, device="cpu")
        pp = pm.init_params(torch.Generator().manual_seed(0))
        caches = pm.init_cache(1, 8)
        logits, caches = pm.prefill(pp, {"tokens": torch.arange(5)[None]}, caches)
        logits, caches = pm.decode_step(pp, torch.tensor([[7]]), 5, caches)
        assert logits.dtype == torch.bfloat16 and bool(logits.isfinite().all())
        assert caches[0]["s"].dtype == torch.float32
        assert caches[0]["x_tm"].dtype == torch.bfloat16


@pytest.mark.cuda
class TestKernelOnCard:
    """K4 against its plain version on the card, per element within 1e-5
    of the shape's largest |ref|."""

    @staticmethod
    def _close(got, want):
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * float(r.abs().max()))

    @pytest.mark.parametrize("b,t,h,hd,chunk", CASES)
    def test_f32(self, cuda, b, t, h, hd, chunk):
        args = [torch.from_numpy(a).to(cuda) for a in _wkv_inputs(b, t, h, hd)]
        before = wkv6_cuda.launches
        got = wkv6_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert wkv6_cuda.launches == before + 1
        self._close(got, ref.wkv6_ref(*args))

    def test_state_continuity(self, cuda):
        x = [torch.from_numpy(a).to(cuda) for a in _wkv_inputs(1, 128, 2, 16, seed=2)]
        o1, s1 = wkv6_cuda(*(a[:, :64].contiguous() for a in x[:4]), x[4])
        o2, s2 = wkv6_cuda(*(a[:, 64:].contiguous() for a in x[:4]), x[4], s0=s1)
        self._close((torch.cat([o1, o2], 1), s2), ref.wkv6_ref(*x))

    @pytest.mark.parametrize("t,carried", MODEL_CASES)
    def test_model_shapes_bf16(self, cuda, t, carried):
        r, k, v, w, u = (torch.from_numpy(a).to(cuda)
                         for a in _wkv_inputs(1, t, 40, 64, seed=t))
        r, k, v = r.bfloat16(), k.bfloat16(), v.bfloat16()
        s0 = torch.from_numpy(_state(1, 40, 64)).to(cuda) if carried else None
        want = ref.wkv6_ref(r, k, v, w, u, s0)
        got = ops.wkv6(r, k, v, w, u, s0=s0)
        self._close(got, want)

    def test_rejects_a_strided_input(self, cuda):
        r, k, v, w, u = (torch.from_numpy(a).to(cuda) for a in _wkv_inputs(1, 8, 2, 16))
        with pytest.raises(ValueError, match="contiguous"):
            wkv6_cuda(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u,
                      chunk=8)

    def test_rejects_a_misaligned_input(self, cuda):
        r, k, v, w, u = (torch.from_numpy(a).to(cuda) for a in _wkv_inputs(1, 8, 2, 16))
        r_off = torch.empty(r.numel() + 1, device=cuda)[1:].view(r.shape).copy_(r)
        with pytest.raises(ValueError, match="16 bytes"):
            wkv6_cuda(r_off, k, v, w, u, chunk=8)

    @pytest.mark.parametrize("hd", [8, 16, 32, 64])
    @pytest.mark.parametrize("t", CHUNK_LENGTHS)
    @pytest.mark.parametrize("with_s0", [False, True])
    def test_chunk_boundaries(self, cuda, hd, t, with_s0):
        r, k, v, w, u = _wkv_inputs(2, t, 3, hd, seed=hd + t)
        x = [torch.from_numpy(a).to(cuda) for a in (r, k, v, _extreme_decays(w), u)]
        s0 = torch.from_numpy(_state(2, 3, hd)).to(cuda) if with_s0 else None
        want = ref.wkv6_ref(*x, s0=s0)
        got = wkv6_cuda(*x, chunk=t, s0=None if s0 is None else s0.clone())
        self._close(got, want)

    @pytest.mark.parametrize("hd", [8, 16, 32])
    @pytest.mark.parametrize("t", [CHUNK - 1, CHUNK + 1, 3 * CHUNK + 5])
    def test_chunk_boundaries_bf16(self, cuda, hd, t):
        """bf16 r, k, v below hd 64, in one launch and in three, from a
        carried state."""
        r, k, v, w, u = (torch.from_numpy(a).to(cuda)
                         for a in _wkv_inputs(2, t, 3, hd, seed=hd + t))
        r, k, v = r.bfloat16(), k.bfloat16(), v.bfloat16()
        s0 = torch.from_numpy(_state(2, 3, hd)).to(cuda)
        want = ref.wkv6_ref(r, k, v, w, u, s0=s0)
        self._close(wkv6_cuda(r, k, v, w, u, chunk=t, s0=s0.clone()), want)

    @pytest.mark.parametrize("t", [CHUNK, 3 * CHUNK + 5])
    def test_s0_aliases_the_output_state(self, cuda, t):
        """The final state is written over ``s0`` itself, in one launch and
        in three."""
        x = [torch.from_numpy(a).to(cuda) for a in _wkv_inputs(1, t, 2, 64, seed=t)]
        s0 = torch.from_numpy(_state(1, 2, 64)).to(cuda)
        want = ref.wkv6_ref(*x, s0=s0)
        s = s0.clone()
        o, st = wkv6_cuda(*x, chunk=t, s0=s)
        assert st is s
        self._close((o, s), want)

    @pytest.mark.parametrize("t,kernels", [(1, 1), (CHUNK, 1), (CHUNK + 1, 3)])
    def test_device_launches(self, cuda, t, kernels):
        """A call of at most TIME_CHUNK steps is one kernel on the card (a
        longer one three), counted from the profiler's device records."""
        from torch.profiler import ProfilerActivity, profile
        x = [torch.from_numpy(a).to(cuda) for a in _wkv_inputs(1, t, 40, 64, seed=t)]
        s0 = torch.from_numpy(_state(1, 40, 64)).to(cuda)
        wkv6_cuda(*x, chunk=t, s0=s0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wkv6_cuda(*x, chunk=t, s0=s0)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
        assert len(names) == kernels and all("wkv6" in n for n in names), names


def test_sweep_needs_a_card(capsys):
    """K4's time-chunk sweep times the kernel, so on the CPU it only says it
    needs a card."""
    from repro_torch.kernels.rwkv6 import sweep
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert sweep.main() == 1
    assert "CUDA card" in capsys.readouterr().err


def test_sweep_times_the_smokes_drain_prompts():
    """The sweep's per-drain saving is taken at the prompt lengths that
    ``chip_smoke.py`` serves."""
    import importlib.util
    import pathlib
    from repro_torch.kernels.rwkv6 import sweep
    from repro_torch.serving.engine import Request
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    prompts = [len(r.tokens) for r in smoke.requests(configs.get_config(smoke.RWKV), Request)]
    assert tuple(prompts) == sweep.DRAIN_PROMPTS
