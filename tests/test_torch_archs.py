"""The port's other architectures held against the JAX package on the CPU:
the long plain prefill (``chunked_attention``, ``banded_attention``),
cross-attention, MLA, and the five configurations they build
(qwen3-moe-30b-a3b and phi3.5-moe-42b-a6.6b: MoE; minicpm3-4b: MLA;
whisper-base: the encoder and the "cross" kind; llama-3.2-vision-90b:
vision tokens through "cross" layers).

Reduced configs (``reduce_config``, f32) with the reference's own
initialised parameters carried across by ``params_from_jax``; inputs,
frames and image tokens from numpy seeds.  The VLM's cross-attention gates
are initialised to zero (tanh(0) silences the cross path), so every test
that covers its "cross" layers sets them non-zero in both trees first.
Tolerances: 1e-5 for one attention block; 1e-4 on logits of a plain long
prefill; atol 2e-4 and rtol 1e-3 on the new configs' logits and aux loss,
as ``tests/test_models_smoke.py`` holds prefill and decode.  The tests
marked ``cuda`` hold K3 against ``mha_ref`` at the new shapes on the card
and skip without one.
"""
import contextlib
import dataclasses
import functools
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs import reduce_config as jax_reduce_config
from repro.launch import serve as jax_serve
from repro.models import attention as jax_attn
from repro.models import mla as jax_mla
from repro.models.model import build_model as jax_build_model
from repro.serving import engine as jax_engine
from repro_torch import configs
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.launch import serve
from repro_torch.models import attention, mla
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.serving.engine import POLICIES, Request, ServingEngine

NEW_ARCHS = ["llama-3.2-vision-90b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
             "qwen3-moe-30b-a3b", "whisper-base"]
ARCH_TOL = dict(atol=2e-4, rtol=1e-3)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _gates_on(jp):
    """The VLM's cross gates set non-zero (tanh(0) = 0 silences them)."""
    for group in jp["stack"]["groups"]:
        if "gate_x" in group:
            group["gate_x"] = group["gate_x"] + 0.5
            group["gate_m"] = group["gate_m"] - 0.7
    return jp


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(cfg, JAX model, JAX params, port model, port params), reduced; the
    VLM's gates non-zero."""
    cfg = configs.reduce_config(configs.get_config(arch))
    jm = jax_build_model(jax_reduce_config(jax_get_config(arch)), max_pos=64)
    jp = _gates_on(jm.init_params(jax.random.key(0)))
    pm = build_model(cfg, max_pos=64, device="cpu")
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jm, jp, pm, pp


def _extras(cfg, b, seed=3):
    """Frames (whisper) or image tokens (VLM), as (JAX, port) dicts."""
    rng = np.random.default_rng(seed)
    jx, px = {}, {}
    if cfg.encoder is not None:
        a = (rng.standard_normal((b, cfg.encoder.num_frames, cfg.encoder.d_model))
             * 0.1).astype(np.float32)
        jx["frames"], px["frames"] = jnp.asarray(a), torch.from_numpy(a)
    if cfg.vision is not None:
        a = (rng.standard_normal((b, cfg.vision.num_image_tokens, cfg.d_model))
             * 0.1).astype(np.float32)
        jx["vision"], px["vision"] = jnp.asarray(a), torch.from_numpy(a)
    return jx, px


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape)


# ---------------------------------------------------------------------------
# the plain long prefill (B8's rest)
# ---------------------------------------------------------------------------

class TestLongPrefill:
    """``chunked_attention`` and ``banded_attention`` against the
    reference's, for the "full" kind (window 0) and the "local" kind
    (window 16), and a whole plain prefill past 2048 tokens (1e-4)."""

    @staticmethod
    def _qkv(t, hv=16, seed=0):
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((1, t, 4, 16)).astype(np.float32),
                rng.standard_normal((1, t, 2, 16)).astype(np.float32),
                rng.standard_normal((1, t, 2, hv)).astype(np.float32))

    @pytest.mark.parametrize("t", [2049, 4096])
    @pytest.mark.parametrize("window", [0, 16])
    def test_chunked_attention(self, t, window):
        q, k, v = self._qkv(t)
        want = jax_attn.chunked_attention(*map(jnp.asarray, (q, k, v)), 0, window)
        got = attention.chunked_attention(*map(torch.from_numpy, (q, k, v)), 0, window)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("t", [2049, 4096])
    @pytest.mark.parametrize("window", [16, 512])
    def test_banded_attention(self, t, window):
        q, k, v = self._qkv(t, seed=1)
        want = jax_attn.banded_attention(*map(jnp.asarray, (q, k, v)), 0, window)
        got = attention.banded_attention(*map(torch.from_numpy, (q, k, v)), 0, window)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    def test_chunked_values_narrower_than_keys(self):
        """MLA's long path: hv 8 < hd 16, at a query offset."""
        q, k, v = self._qkv(2100, hv=8, seed=2)
        want = jax_attn.chunked_attention(*map(jnp.asarray, (q, k, v)), 5)
        got = attention.chunked_attention(*map(torch.from_numpy, (q, k, v)), 5)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("arch,t", [("qwen2-0.5b", 2049), ("gemma3-1b", 2049)])
    def test_plain_prefill_through_the_model(self, arch, t):
        """qwen2's "full" layers go to chunked_attention, gemma3's "local"
        ones (window 16 <= T/2) to banded_attention."""
        cfg, jm, jp, pm, pp = _models(arch)
        toks = _tokens(cfg, (1, t), seed=1)
        want, _, _ = jm.forward(jp, jnp.asarray(toks), last_only=True)
        got, _, _ = pm.forward(pp, torch.from_numpy(toks), last_only=True)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)

    def test_plain_cached_prefill_then_decode(self):
        """A cached prefill of 2049 tokens, then a decode step, as the
        reference's."""
        cfg, jm, jp, pm, pp = _models("qwen2-0.5b")
        toks = _tokens(cfg, (1, 2050), seed=2)
        jc, pc = jm.init_cache(1, 2056), pm.init_cache(1, 2056)
        want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :2049])}, jc)
        got, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :2049])}, pc)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)
        want, _ = jm.decode_step(jp, jnp.asarray(toks[:, 2049:]), 2049, jc)
        got, _ = pm.decode_step(pp, torch.from_numpy(toks[:, 2049:]), 2049, pc)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# cross-attention and MLA, one block at a time
# ---------------------------------------------------------------------------

class TestCrossAttention:
    """One cross-attention block (the VLM's ``xattn``) against the
    reference's (1e-5): prefill from ``cross_x`` into the cache, decode
    from the cached ``xk``/``xv``, and without a cache."""

    def test_prefill_then_decode(self):
        cfg, jm, jp, pm, pp = _models("llama-3.2-vision-90b")
        jx = jax.tree.map(lambda a: a[0], jp["stack"]["groups"][4]["xattn"])
        px = pp["stack"][4]["xattn"]
        rng = np.random.default_rng(7)
        n = cfg.vision.num_image_tokens
        x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
        img = rng.standard_normal((2, n, cfg.d_model)).astype(np.float32)
        kvd = (2, n, cfg.num_kv_heads, cfg.head_dim)
        jc = {"xk": jnp.zeros(kvd), "xv": jnp.zeros(kvd)}
        pc = {"xk": torch.zeros(kvd), "xv": torch.zeros(kvd)}
        want, jc = jax_attn.attention_block(jx, jnp.asarray(x[:, :5]), cfg, kind="full",
                                            cross_x=jnp.asarray(img), cache=jc)
        got, pc = attention.attention_block(px, _t(x[:, :5]), cfg, kind="full",
                                            cross_x=_t(img), cache=pc)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
        for name in ("xk", "xv"):
            np.testing.assert_allclose(pc[name].numpy(), _np(jc[name]), rtol=0, atol=1e-5)
        want, _ = jax_attn.attention_block(jx, jnp.asarray(x[:, 5:]), cfg, kind="full",
                                           pos_offset=5, cache=jc)
        got, pc2 = attention.attention_block(px, _t(x[:, 5:]), cfg, kind="full",
                                             pos_offset=5, cache=pc)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
        assert pc2["xk"] is pc["xk"]

    def test_without_cache(self):
        cfg, jm, jp, pm, pp = _models("whisper-base")
        jx = jax.tree.map(lambda a: a[0], jp["stack"]["groups"][0]["xattn"])
        rng = np.random.default_rng(8)
        x = rng.standard_normal((1, 7, cfg.d_model)).astype(np.float32)
        enc = rng.standard_normal((1, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
        want, none_j = jax_attn.attention_block(jx, jnp.asarray(x), cfg, kind="full",
                                                cross_x=jnp.asarray(enc))
        got, none = attention.attention_block(pp["stack"][0]["xattn"], _t(x), cfg,
                                              kind="full", cross_x=_t(enc))
        assert none is None and none_j is None
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


class TestMLA:
    """MiniCPM3's three attention forms against the reference's (1e-5):
    expanded (prefill up to 2048 tokens, with and without a cache),
    absorbed (decode, and a cached prefill past 2048 tokens) and expanded
    K/V through ``chunked_attention`` (an uncached prefill past 2048)."""

    @pytest.fixture(scope="class")
    def layer(self):
        cfg, jm, jp, pm, pp = _models("minicpm3-4b")
        return cfg, jax.tree.map(lambda a: a[0], jp["stack"]["groups"][0]["attn"]), \
            pp["stack"][0]["attn"]

    @staticmethod
    def _cache(cfg, s):
        m = cfg.mla
        shapes = {"ckv": (1, s, m.kv_lora_rank), "kr": (1, s, m.qk_rope_head_dim)}
        return ({k: jnp.zeros(v) for k, v in shapes.items()},
                {k: torch.zeros(v) for k, v in shapes.items()})

    def _check(self, layer, x, s=None, pos=0, caches=None):
        cfg, jp, pp = layer
        jc, pc = caches if caches is not None else \
            (self._cache(cfg, s) if s else (None, None))
        want, jc = jax_mla.mla_block(jp, jnp.asarray(x), cfg, pos_offset=pos, cache=jc)
        got, pc = mla.mla_block(pp, _t(x), cfg, pos_offset=pos, cache=pc)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
        if jc is not None:
            for name in ("ckv", "kr"):
                np.testing.assert_allclose(pc[name].numpy(), _np(jc[name]), rtol=0, atol=1e-5)
        return jc, pc

    def _x(self, layer, t, seed=0):
        return np.random.default_rng(seed).standard_normal(
            (1, t, layer[0].d_model)).astype(np.float32)

    def test_expanded_without_cache(self, layer):
        self._check(layer, self._x(layer, 9))

    def test_expanded_prefill_then_absorbed_decode(self, layer):
        x = self._x(layer, 12, seed=1)
        caches = self._check(layer, x[:, :9], s=16)
        for pos in range(9, 12):
            caches = self._check(layer, x[:, pos:pos + 1], pos=pos, caches=caches)

    def test_absorbed_cached_prefill_past_2048(self, layer):
        x = self._x(layer, 2050, seed=2)
        caches = self._check(layer, x[:, :2049], s=2056)
        self._check(layer, x[:, 2049:], pos=2049, caches=caches)

    def test_expanded_chunked_uncached_past_2048(self, layer):
        self._check(layer, self._x(layer, 2049, seed=3))


# ---------------------------------------------------------------------------
# the five new configurations, whole
# ---------------------------------------------------------------------------

class TestNewArchitectures:
    """Each new reduced config against the reference: logits and aux of a
    forward (whisper with frames, the VLM with image tokens), prefill then
    decode against the full forward, ``loss_fn``, and the cache layout."""

    @pytest.mark.parametrize("arch", NEW_ARCHS)
    def test_forward(self, arch):
        cfg, jm, jp, pm, pp = _models(arch)
        toks = _tokens(cfg, (2, 16))
        jx, px = _extras(cfg, 2)
        want, _, waux = jm.forward(jp, jnp.asarray(toks), extras=jx)
        got, none, gaux = pm.forward(pp, torch.from_numpy(toks), extras=px)
        assert got.shape == (2, 16, cfg.vocab_padded()) and none is None
        np.testing.assert_allclose(got.numpy(), _np(want), **ARCH_TOL)
        np.testing.assert_allclose(float(gaux), float(waux), **ARCH_TOL)
        assert (float(gaux) > 0) == (cfg.moe is not None)

    @pytest.mark.parametrize("arch", NEW_ARCHS)
    def test_prefill_then_decode_equals_forward(self, arch):
        """As ``tests/test_models_smoke.py::test_decode_matches_full_forward``
        on the port (8 decode steps); the prefill and the first decode step
        also against the reference's."""
        cfg, jm, jp, pm, pp = _models(arch)
        b, t = 2, 24
        toks = _tokens(cfg, (b, t), seed=2)
        jx, px = _extras(cfg, b)
        full, _, _ = pm.forward(pp, torch.from_numpy(toks), extras=px)
        tp = t - 8
        jc, pc = jm.init_cache(b, 40), pm.init_cache(b, 40)
        want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :tp]), **jx}, jc)
        got, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :tp]), **px}, pc)
        np.testing.assert_allclose(got[:, -1].numpy(), full[:, tp - 1].numpy(), **ARCH_TOL)
        np.testing.assert_allclose(got.numpy(), _np(want), **ARCH_TOL)
        want, _ = jm.decode_step(jp, jnp.asarray(toks[:, tp:tp + 1]), tp, jc)
        for step in range(tp, t):
            got, pc = pm.decode_step(pp, torch.from_numpy(toks[:, step:step + 1]), step, pc)
            np.testing.assert_allclose(got[:, 0].numpy(), full[:, step].numpy(), **ARCH_TOL)
            if step == tp:
                np.testing.assert_allclose(got.numpy(), _np(want), **ARCH_TOL)

    @pytest.mark.parametrize("arch", NEW_ARCHS)
    def test_loss_fn(self, arch):
        cfg, jm, jp, pm, pp = _models(arch)
        toks, labels = _tokens(cfg, (2, 9), 3), _tokens(cfg, (2, 9), 4)
        jx, px = _extras(cfg, 2, seed=5)
        want, wm = jm.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels), **jx})
        got, gm = pm.loss_fn(pp, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels), **px})
        np.testing.assert_allclose(float(got), float(want), **ARCH_TOL)
        np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), **ARCH_TOL)
        np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]), **ARCH_TOL)

    @pytest.mark.parametrize("arch", NEW_ARCHS)
    def test_init_cache_layout(self, arch):
        """Layer i's cache has the shapes of its pattern position's stacked
        spec in ``stack_cache_specs``, less the repeat axis."""
        cfg, jm, _, pm, _ = _models(arch)
        caches = pm.init_cache(2, 24)
        specs = jm.init_cache(2, 24)
        reps = cfg.num_layers // len(cfg.pattern)
        want = [{k: tuple(v.shape[1:]) for k, v in specs["groups"][i % len(cfg.pattern)].items()}
                for i in range(reps * len(cfg.pattern))]
        want += [{k: tuple(v.shape) for k, v in rem.items()} for rem in specs["remainder"]]
        assert [{k: tuple(v.shape) for k, v in c.items()} for c in caches] == want

    @pytest.mark.parametrize("arch", NEW_ARCHS)
    def test_init_params_matches_reference_layout(self, arch):
        cfg, _, _, pm, pp = _models(arch)
        mine = pm.init_params(torch.Generator().manual_seed(0))
        shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
        assert shapes(mine) == shapes(pp)


class TestWhisperAndVision:
    def test_encoder(self):
        """The encoder alone: no causal mask, sinusoidal positions, no rope."""
        cfg, jm, jp, pm, pp = _models("whisper-base")
        jx, px = _extras(cfg, 2, seed=9)
        want = jm._encode(jp, jx["frames"])
        got = pm._encode(pp, px["frames"])
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
    def test_prefill_without_extras_attends_zero_caches(self, arch):
        """As the engines prefill (``{"tokens": ...}`` only): the cross
        layers read the zeroed ``xk``/``xv``, in both packages."""
        cfg, jm, jp, pm, pp = _models(arch)
        toks = _tokens(cfg, (1, 10), seed=6)
        want, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(1, 16))
        got, _ = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, pm.init_cache(1, 16))
        np.testing.assert_allclose(got.numpy(), _np(want), **ARCH_TOL)

    def test_vlm_gates_silence_the_cross_path_at_init(self):
        """With the gates at their initial zero the image tokens change
        nothing; set non-zero, they do."""
        cfg, _, _, pm, pp = _models("llama-3.2-vision-90b")
        toks = torch.from_numpy(_tokens(cfg, (1, 8), seed=7))
        _, px = _extras(cfg, 1)
        shut = {**pp, "stack": [{k: (torch.zeros_like(v) if k.startswith("gate_") else v)
                                 for k, v in layer.items()} for layer in pp["stack"]]}
        base, _, _ = pm.forward(shut, toks)
        torch.testing.assert_close(pm.forward(shut, toks, extras=px)[0], base)
        assert not torch.allclose(pm.forward(pp, toks, extras=px)[0], base)


# ---------------------------------------------------------------------------
# serving and the driver
# ---------------------------------------------------------------------------

def _requests(cls, cfg, n=6, replicas=2, seed=0, max_new=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size, size=int(rng.integers(6, 9)))
        home = int(rng.integers(0, replicas)) if rng.random() < 0.7 else -1
        out.append(cls(uid=i, tokens=toks, max_new=max_new, home_replica=home))
    return out


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained()
    return {r.uid: list(r.out_tokens) for r in done}, engine.stats


@pytest.mark.parametrize("policy", POLICIES)
def test_serving_engine_on_qwen3_moe(policy):
    """The JAX engine's tokens and ``ServeStats`` from the port's engine on
    the reduced qwen3-moe-30b-a3b."""
    cfg, jm, jp, pm, pp = _models("qwen3-moe-30b-a3b")
    kw = dict(num_replicas=2, max_seq=32, policy=policy)
    want, wstats = _serve(jax_engine.ServingEngine(jm, jp, **kw),
                          _requests(jax_engine.Request, cfg))
    got, gstats = _serve(ServingEngine(pm, pp, device="cpu", **kw),
                         _requests(Request, cfg))
    assert got == want
    assert dataclasses.asdict(gstats) == dataclasses.asdict(wstats)


@pytest.mark.parametrize("arch", sorted(set(jax_list_archs()) -
                                        {"qwen2-0.5b", "rwkv6-3b", "recurrentgemma-9b"}))
def test_driver_prints_the_reference_stats(monkeypatch, arch):
    """``--arch`` takes every configuration: the router's statistics line
    equals the reference driver's (``tests/test_torch_serving.py`` covers
    the other three)."""
    args = ["--arch", arch, "--requests", "4", "--replicas", "2",
            "--policy", "round_robin"]
    out = {}
    for name, run in (("jax", jax_serve.main),
                      ("port", lambda: serve.main(args + ["--device", "cpu"]))):
        monkeypatch.setattr(sys, "argv", ["serve"] + args)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        out[name] = buf.getvalue().splitlines()
    assert out["port"][-1] == out["jax"][-1]
    assert out["port"][-1].startswith("policy=round_robin served=4 ")
    assert len(out["port"]) == len(out["jax"])


# ---------------------------------------------------------------------------
# K3 at the new shapes, on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no interpret mode")
    return torch.device("cuda")


# (Hq, Hkv, hd, Tq, Tk, q_offset, causal): qwen3-moe's prefill and decode,
# whisper's encoder and cross-attention, the VLM's cross-attention
K3_NEW_SHAPES = [(32, 4, 128, 128, 128, 0, True), (32, 4, 128, 1024, 1024, 0, True),
                 (32, 4, 128, 1, 2048, 517, True), (32, 4, 128, 1, 2048, 2047, True),
                 (8, 8, 64, 1536, 1536, 0, False), (8, 8, 64, 128, 1536, 0, False),
                 (8, 8, 64, 1, 1536, 0, False), (64, 8, 128, 128, 1600, 0, False),
                 (64, 8, 128, 1, 1600, 0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hq,hkv,hd,tq,tk,qo,causal", K3_NEW_SHAPES)
def test_k3_at_the_new_shapes(cuda, dtype, hq, hkv, hd, tq, tk, qo, causal):
    """K3 against ``mha_ref`` per element, as the model passes it: (B, T,
    H, hd) projections as (B, H, T, hd) views.  Limits: 3e-5 in f32, 3e-5 +
    2^-7 |ref| in bf16 (``chip_smoke.py``'s K3_F32_TOL, K3_BF16_TOL)."""
    rng = np.random.default_rng(hq + tq + tk)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((1, tq, hq, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, tk, hkv, hd)).astype(np.float32))
            for _ in range(2))
    q, k, v = (x.to(cuda, dt).transpose(1, 2) for x in (q, k, v))
    got = flash_attention(q, k, v, causal=causal, q_offset=qo, bq=tq, bk=tk)
    want = mha_ref(q, k, v, causal=causal, q_offset=qo).float()
    rtol = 2.0 ** -7 if dt == torch.bfloat16 else 0.0
    assert ((got.float() - want).abs() <= 3e-5 + rtol * want.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_archs_kernel_path_on_the_card(cuda, arch):
    """The reduced config on the card, f32: K3 carries every attention call
    but MLA's, and the logits equal the plain path's (1e-4)."""
    cfg, _, _, _, pp = _models(arch)
    params = jax.tree.map(lambda a: a.to(cuda), pp)
    toks = torch.from_numpy(_tokens(cfg, (1, 24), seed=8)).to(cuda)
    _, px = _extras(cfg, 1)
    px = {k: v.to(cuda) for k, v in px.items()}
    outs = []
    for use_kernel in (True, False):
        m = build_model(cfg, max_pos=64, device=cuda, use_kernel=use_kernel)
        flash_attention.launches = 0
        outs.append(m.forward(params, toks, extras=px)[0])
        assert (flash_attention.launches > 0) == (use_kernel and cfg.mla is None)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-4)
