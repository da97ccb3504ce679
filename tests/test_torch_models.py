"""The port's model stack (``repro_torch.models``) held against the JAX
package on the CPU.

Inputs come from a numpy seed and go to both sides.  The model tests use
the reduced qwen2-0.5b and gemma3-1b (``reduce_config``, f32; gemma3-1b
has five "local" layers with a 16-slot ring, a "full" one and a local
remainder, head dim 16, and gemma's embedding scale) with the reference's
own initialised parameters carried across by ``params_from_jax``, since
torch cannot reproduce ``jax.random`` draws.  Tolerances: 1e-6 for the
elementwise building blocks (the same f32 ops in the same order); 1e-5 for
one attention block or MLP (f32 matmul sums in another order); 1e-4 for
logits after the whole stack (the same, over every layer).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs import reduce_config as jax_reduce_config
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import mlp as jax_mlp
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.models import attention, common, mlp
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

ARCH = "qwen2-0.5b"


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX model, JAX params, port model, port params), reduced."""
    cfg = configs.reduce_config(configs.get_config(ARCH))
    jcfg = jax_reduce_config(jax_get_config(ARCH))
    jm = jax_build_model(jcfg, max_pos=96)
    jp = jm.init_params(jax.random.key(0))
    pm = build_model(cfg, max_pos=96, device="cpu")
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jm, jp, pm, pp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape)


class TestConfigs:
    def test_same_registry_and_values(self):
        assert configs.list_archs() == jax_list_archs()
        for name in configs.list_archs():
            mine, theirs = configs.get_config(name), jax_get_config(name)
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
            assert dataclasses.asdict(configs.reduce_config(mine)) == \
                dataclasses.asdict(jax_reduce_config(theirs))
            assert mine.num_params() == theirs.num_params()


class TestCommon:
    """The building blocks against ``repro.models.common`` (atol 1e-6)."""

    x = np.random.default_rng(0).standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = np.random.default_rng(1).standard_normal(16).astype(np.float32) * 0.1

    def test_rms_norm(self):
        want = jax_common.rms_norm({"scale": jnp.asarray(self.scale)}, jnp.asarray(self.x))
        got = common.rms_norm({"scale": _t(self.scale)}, _t(self.x))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)

    def test_rms_norm_bf16_applies_in_input_dtype(self):
        x = jnp.asarray(self.x, jnp.bfloat16)
        want = jax_common.rms_norm({"scale": jnp.asarray(self.scale, jnp.bfloat16)}, x)
        got = common.rms_norm({"scale": _t(self.scale).bfloat16()}, _t(self.x).bfloat16())
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=0, atol=1e-6)

    def test_layer_norm(self):
        bias = self.scale[::-1].copy()
        p = {"scale": self.scale + 1, "bias": bias}
        want = jax_common.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(self.x))
        got = common.layer_norm({k: _t(v) for k, v in p.items()}, _t(self.x))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)

    @pytest.mark.parametrize("hd,theta", [(16, 1e4), (64, 1e6)])
    def test_rope_freqs(self, hd, theta):
        np.testing.assert_allclose(common.rope_freqs(hd, theta).numpy(),
                                   _np(jax_common.rope_freqs(hd, theta)),
                                   rtol=1e-6, atol=0)

    @pytest.mark.parametrize("theta", [1e4, 1e6])
    def test_apply_rope(self, theta):
        pos = np.arange(3, 8)[None].repeat(2, 0)
        want = jax_common.apply_rope(jnp.asarray(self.x), jnp.asarray(pos), theta)
        got = common.apply_rope(_t(self.x), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)

    def test_sinusoidal_positions(self):
        np.testing.assert_allclose(common.sinusoidal_positions(12, 16).numpy(),
                                   _np(jax_common.sinusoidal_positions(12, 16)),
                                   rtol=0, atol=1e-6)

    @pytest.mark.parametrize("name", ["silu", "gelu", "gelu_exact", "relu2"])
    def test_act_fn(self, name):
        want = jax_common.act_fn(name)(jnp.asarray(self.x))
        got = common.act_fn(name)(_t(self.x))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)

    def test_matmul_lowp(self):
        a, b = self.x[0, :, 0], self.x[1, :, 1].T
        np.testing.assert_allclose(common.matmul_lowp(_t(a), _t(b)).numpy(),
                                   _np(jax_common.matmul_lowp(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=0, atol=1e-6)

    @pytest.mark.parametrize("masked", [False, True])
    def test_cross_entropy(self, masked):
        rng = np.random.default_rng(2)
        logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
        labels = rng.integers(0, 11, size=(2, 5))
        mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
        want = jax_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                        None if mask is None else jnp.asarray(mask))
        got = common.cross_entropy(_t(logits), torch.from_numpy(labels),
                                   None if mask is None else _t(mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-6)

    def test_dense_init_is_truncated_fan_in(self):
        w = common.dense_init(torch.Generator().manual_seed(0), 400, 300)
        assert w.shape == (400, 300) and w.dtype == torch.float32
        assert float(w.abs().max()) <= 3 / 20 + 1e-6
        assert abs(float(w.std()) - 0.9866 / 20) < 1e-3   # N(0, 1) cut at ±3 has std 0.9866


class TestBlocks:
    """One MLP and one attention block against the reference (atol 1e-5)."""

    @pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
    def test_mlp(self, gated, act):
        jp = jax_mlp.mlp_init(jax.random.key(3), 16, 24, gated=gated)
        x = np.random.default_rng(3).standard_normal((2, 5, 16)).astype(np.float32)
        want = jax_mlp.mlp(jp, jnp.asarray(x), act)
        got = mlp.mlp({k: _t(v) for k, v in jp.items()}, _t(x), act)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    def test_attention_prefill_then_decode(self, pair):
        cfg, jm, jp, pm, pp = pair
        jattn = jax.tree.map(lambda a: a[0], jp["stack"]["groups"][0]["attn"])
        pattn = pp["stack"][0]["attn"]
        rng = np.random.default_rng(4)
        t, s = 9, 32
        x = rng.standard_normal((1, t + 1, cfg.d_model)).astype(np.float32)
        kvd = (1, s, cfg.num_kv_heads, cfg.head_dim)
        jcache = {"k": jnp.zeros(kvd), "v": jnp.zeros(kvd)}
        pcache = {"k": torch.zeros(kvd), "v": torch.zeros(kvd)}

        want, jcache = jax_attn.attention_block(jattn, jnp.asarray(x[:, :t]), cfg,
                                                kind="full", cache=jcache)
        got, pcache = attention.attention_block(pattn, _t(x[:, :t]), cfg,
                                                kind="full", cache=pcache)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(pcache[name].numpy(), _np(jcache[name]),
                                       rtol=0, atol=1e-5)

        want, jcache = jax_attn.attention_block(jattn, jnp.asarray(x[:, t:]), cfg,
                                                kind="full", pos_offset=t,
                                                cache=jcache)
        got, pcache = attention.attention_block(pattn, _t(x[:, t:]), cfg,
                                                kind="full", pos_offset=t,
                                                cache=pcache)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(pcache[name].numpy(), _np(jcache[name]),
                                       rtol=0, atol=1e-5)

    @pytest.mark.parametrize("causal", [True, False])
    def test_attention_without_cache(self, pair, causal):
        cfg, jm, jp, pm, pp = pair
        jattn = jax.tree.map(lambda a: a[0], jp["stack"]["groups"][0]["attn"])
        x = np.random.default_rng(5).standard_normal((2, 7, cfg.d_model)).astype(np.float32)
        want, _ = jax_attn.attention_block(jattn, jnp.asarray(x), cfg, kind="full",
                                           pos_offset=3, causal=causal)
        got, none = attention.attention_block(pp["stack"][0]["attn"], _t(x), cfg,
                                              kind="full", pos_offset=3, causal=causal)
        assert none is None
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)

    def test_plain_helpers(self):
        """_causal_mask and decode_attention, alone, against the reference."""
        np.testing.assert_array_equal(attention._causal_mask(5, 9, 4, 3).numpy(),
                                      _np(jax_attn._causal_mask(5, 9, 4, 3)))
        rng = np.random.default_rng(6)
        q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
        k, v = rng.standard_normal((2, 2, 12, 2, 16)).astype(np.float32)
        for ring, length in ((False, 7), (True, 30)):
            want = jax_attn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), length, ring=ring)
            got = attention.decode_attention(_t(q), _t(k), _t(v), length, ring=ring)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)

    @pytest.mark.parametrize("kind", ["cross"])
    def test_unported_kinds_raise(self, pair, kind):
        """Every kind is ported now (name and case kept from before): without
        ``cross_x`` or a cross cache, a "cross" kind attends to itself as
        "full" does, and equals the reference's block (1e-5)."""
        cfg, jm, jp, pm, pp = pair
        jattn = jax.tree.map(lambda a: a[0], jp["stack"]["groups"][0]["attn"])
        x = np.random.default_rng(9).standard_normal((1, 6, cfg.d_model)).astype(np.float32)
        want, _ = jax_attn.attention_block(jattn, jnp.asarray(x), cfg, kind=kind)
        got, none = attention.attention_block(pp["stack"][0]["attn"], _t(x), cfg, kind=kind)
        assert none is None
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


class TestModel:
    """Logits of the whole stack against the reference (atol 1e-4)."""

    def test_forward(self, pair):
        cfg, jm, jp, pm, pp = pair
        toks = _tokens(cfg, (2, 13))
        want, _, _ = jm.forward(jp, jnp.asarray(toks))
        got, none, aux = pm.forward(pp, torch.from_numpy(toks))
        assert got.shape == (2, 13, cfg.vocab_padded()) and none is None and aux == 0
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)

    def test_prefill_and_decode_steps(self, pair):
        cfg, jm, jp, pm, pp = pair
        toks = _tokens(cfg, (1, 15), seed=1)
        t = 11
        jc, pc = jm.init_cache(1, 32), pm.init_cache(1, 32)
        want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :t])}, jc)
        got, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :t])}, pc)
        assert got.shape == (1, 1, cfg.vocab_padded())
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)
        for pos in range(t, toks.shape[1]):
            step = toks[:, pos:pos + 1]
            want, jc = jm.decode_step(jp, jnp.asarray(step), pos, jc)
            got, pc = pm.decode_step(pp, torch.from_numpy(step), pos, pc)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)

    def test_prefill_then_decode_equals_forward(self, pair):
        cfg, _, _, pm, pp = pair
        toks = torch.from_numpy(_tokens(cfg, (1, 12), seed=2))
        full, _, _ = pm.forward(pp, toks)
        caches = pm.init_cache(1, 16)
        logits, caches = pm.prefill(pp, {"tokens": toks[:, :8]}, caches)
        torch.testing.assert_close(logits[:, 0], full[:, 7], rtol=0, atol=1e-5)
        for pos in range(8, 12):
            logits, caches = pm.decode_step(pp, toks[:, pos:pos + 1], pos, caches)
            torch.testing.assert_close(logits[:, 0], full[:, pos], rtol=0, atol=1e-5)

    def test_loss_fn(self, pair):
        cfg, jm, jp, pm, pp = pair
        toks, labels = _tokens(cfg, (2, 9), 3), _tokens(cfg, (2, 9), 4)
        want, wm = jm.loss_fn(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        got, gm = pm.loss_fn(pp, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
        np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)
        np.testing.assert_allclose(gm["ce"].item(), float(wm["ce"]), rtol=0, atol=1e-5)

    def test_init_params_matches_reference_layout(self, pair):
        cfg, _, _, pm, pp = pair
        mine = pm.init_params(torch.Generator().manual_seed(0))
        shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
        assert shapes(mine) == shapes(pp)
        assert all(a.dtype == torch.float32 for a in jax.tree.leaves(mine))

    def test_init_cache_layout(self, pair):
        cfg, jm, _, pm, _ = pair
        caches = pm.init_cache(2, 24)
        assert len(caches) == cfg.num_layers
        jc = jm.init_cache(2, 24)["groups"][0]
        for layer in caches:
            assert {k: tuple(v.shape) for k, v in layer.items()} == \
                {k: tuple(v.shape[1:]) for k, v in jc.items()}

    def test_needs_a_card_unless_asked_for_cpu(self, pair):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(pair[0])


# every registered architecture but the dense ones (qwen2, gemma3-1b),
# rwkv6-3b (tests/test_torch_rwkv.py) and recurrentgemma-9b
# (tests/test_torch_rglru.py): the ones ported last (tests/test_torch_archs.py)
UNPORTED = ["llama-3.2-vision-90b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
            "qwen3-moe-30b-a3b", "whisper-base"]
GEMMA = "gemma3-1b"


@pytest.fixture(scope="module")
def gemma():
    """(cfg, JAX model, JAX params, port model, port params): the reduced
    gemma3-1b."""
    cfg = configs.reduce_config(configs.get_config(GEMMA))
    jm = jax_build_model(jax_reduce_config(jax_get_config(GEMMA)), max_pos=96)
    jp = jm.init_params(jax.random.key(0))
    pm = build_model(cfg, max_pos=96, device="cpu")
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jm, jp, pm, pp


class TestGemma3:
    """The reduced gemma3-1b, built from the "local" kind, its ring cache
    and the embedding scale, against the reference (logits atol 1e-4)."""

    def test_forward(self, gemma):
        cfg, jm, jp, pm, pp = gemma
        assert cfg.layer_kinds() == ["local"] * 5 + ["full", "local"]
        toks = _tokens(cfg, (2, 29))
        want, _, _ = jm.forward(jp, jnp.asarray(toks))
        got, _, _ = pm.forward(pp, torch.from_numpy(toks))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)

    # prompts shorter and longer than the 16-slot ring, decoded until it wraps
    @pytest.mark.parametrize("t,end", [(9, 19), (21, 25)])
    def test_prefill_and_decode_steps(self, gemma, t, end):
        cfg, jm, jp, pm, pp = gemma
        toks = _tokens(cfg, (1, end), seed=t)
        jc, pc = jm.init_cache(1, 48), pm.init_cache(1, 48)
        assert [tuple(c["k"].shape)[1] for c in pc] == [16] * 5 + [48, 16]
        want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :t])}, jc)
        got, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :t])}, pc)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)
        for pos in range(t, end):
            step = toks[:, pos:pos + 1]
            want, jc = jm.decode_step(jp, jnp.asarray(step), pos, jc)
            got, pc = pm.decode_step(pp, torch.from_numpy(step), pos, pc)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)

    def test_prefill_then_decode_equals_forward(self, gemma):
        cfg, _, _, pm, pp = gemma
        toks = torch.from_numpy(_tokens(cfg, (1, 40), seed=2))
        full, _, _ = pm.forward(pp, toks)
        caches = pm.init_cache(1, 48)
        logits, caches = pm.prefill(pp, {"tokens": toks[:, :20]}, caches)
        torch.testing.assert_close(logits[:, 0], full[:, 19], rtol=0, atol=1e-5)
        for pos in range(20, 40):
            logits, caches = pm.decode_step(pp, toks[:, pos:pos + 1], pos, caches)
            torch.testing.assert_close(logits[:, 0], full[:, pos], rtol=0, atol=1e-5)

    # f32 at the reduced width (8.0), and bf16 at gemma3-1b's own 1152,
    # whose sqrt (33.94) rounds to 34.0 before it multiplies, as in the
    # reference; qwen2 has no scale
    @pytest.mark.parametrize("arch,d,dtype", [
        (GEMMA, 64, "float32"), (GEMMA, 1152, "bfloat16"),
        ("recurrentgemma-9b", 4096, "bfloat16"), (ARCH, 64, "float32")])
    def test_embedding_scale(self, monkeypatch, arch, d, dtype):
        from repro.models import model as jax_model_mod
        from repro_torch.models import model as model_mod
        base = configs.get_config(arch)      # one repeat of the pattern
        jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(arch)), d_model=d,
                                   dtype=dtype, num_layers=len(base.pattern))
        cfg = dataclasses.replace(configs.reduce_config(base), d_model=d,
                                  dtype=dtype, num_layers=len(base.pattern))
        jm = jax_build_model(jcfg)
        jp = jm.init_params(jax.random.key(2))
        pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
        seen = {}

        def spy(name):
            def stack(params, x, cfg, **kw):
                seen[name] = np.asarray(x.float() if name == "port" else
                                        x.astype(jnp.float32))
                return x, None, 0.0
            return stack

        monkeypatch.setattr(jax_model_mod, "apply_stack", spy("jax"))
        monkeypatch.setattr(model_mod, "apply_stack", spy("port"))
        toks = _tokens(cfg, (1, 7))
        jm.forward(jp, jnp.asarray(toks))
        build_model(cfg, device="cpu").forward(pp, torch.from_numpy(toks))
        np.testing.assert_array_equal(seen["port"], seen["jax"])
        scaled = arch != ARCH
        raw = pp["tok"][torch.from_numpy(toks)].float().numpy()
        assert scaled == bool(np.any(seen["port"] != raw))


class TestConverter:
    def test_bf16_leaves_cross_exactly(self):
        jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(ARCH)),
                                   dtype="bfloat16")
        cfg = dataclasses.replace(configs.reduce_config(configs.get_config(ARCH)),
                                  dtype="bfloat16")
        jp = jax_build_model(jcfg).init_params(jax.random.key(1))
        pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
        assert pp["tok"].dtype == torch.bfloat16
        np.testing.assert_array_equal(pp["tok"].float().numpy(), _np(jp["tok"]))
        wq = jp["stack"]["groups"][0]["attn"]["wq"]
        for layer in range(cfg.num_layers):
            np.testing.assert_array_equal(pp["stack"][layer]["attn"]["wq"].float().numpy(),
                                          _np(wq[layer]))

    def test_layer_order(self, pair):
        cfg, _, jp, _, pp = pair
        assert len(pp["stack"]) == cfg.num_layers
        for layer in range(cfg.num_layers):
            np.testing.assert_array_equal(
                pp["stack"][layer]["mlp"]["w_down"].numpy(),
                _np(jp["stack"]["groups"][0]["mlp"]["w_down"][layer]))

    @pytest.mark.parametrize("arch", UNPORTED)
    def test_unported_architectures_raise(self, arch):
        """Every architecture is ported now (name and cases kept from
        before): the reference's parameters cross over leaf for leaf, the
        port's model builds, and its logits equal the reference's (atol
        2e-4, rtol 1e-3); a stack of the wrong depth is refused."""
        cfg = configs.reduce_config(configs.get_config(arch))
        jm = jax_build_model(jax_reduce_config(jax_get_config(arch)), max_pos=32)
        jp = jm.init_params(jax.random.key(2))
        pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
        for want, got in zip(jax.tree.leaves(jp["stack"]["groups"][0]),
                             jax.tree.leaves(pp["stack"][0])):
            np.testing.assert_array_equal(got.numpy(), _np(want[0]))
        toks = _tokens(cfg, (1, 5), seed=5)
        want, _, _ = jm.forward(jp, jnp.asarray(toks))
        got, _, _ = build_model(cfg, max_pos=32, device="cpu").forward(
            pp, torch.from_numpy(toks))
        np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-4, rtol=1e-3)
        with pytest.raises(ValueError, match="groups"):
            params_from_jax({"stack": {"groups": [], "remainder": []}}, cfg, "cpu")
