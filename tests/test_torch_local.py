"""The "local" (sliding-window) attention kind of the port
(``repro_torch.models.attention``) and its ring-buffer cache, held against
the JAX package on the CPU, and K3 on such a ring on the card.

The layer is the local layer (layer 2) of the reduced recurrentgemma-9b
(4 query heads over 1 kv head of 16, window 16, f32) with the reference's
own parameters carried across by ``params_from_jax``; inputs come from
numpy seeds.  A cache of ``max_seq`` 64 gives a ring of
``min(16, 64) = 16`` slots: position p lives in slot p % 16.  Tolerances:
1e-5 for the block's output and for the cache's k and v (f32 matmul sums
in another order), 1e-6 for ``decode_attention`` alone.  The tests marked
``cuda`` run K3 on the card and skip without one; they hold it within
3e-5 in f32, ``tests/test_torch_flash.py``'s f32 limit (the online softmax
reassociates the sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import attention as jax_attn
from repro.models import transformer as jax_transformer
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.models import attention, transformer
from repro_torch.models.convert import params_from_jax

ARCH = "recurrentgemma-9b"
LOCAL = 2          # the reduced config's local layer
MAX_SEQ = 64


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def layer():
    """(cfg, the reference's local attention params, the port's)."""
    cfg = configs.reduce_config(configs.get_config(ARCH))
    jp = jax_build_model(jax_reduce_config(jax_get_config(ARCH))).init_params(
        jax.random.key(0))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jattn = jax.tree.map(lambda a: a[0], jp["stack"]["groups"][LOCAL]["attn"])
    return cfg, jattn, pp["stack"][LOCAL]["attn"]


def _caches(cfg, b=1):
    spec = transformer.block_cache_spec(cfg, "local", b, MAX_SEQ, torch.float32)
    pcache = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in spec.items()}
    jcache = {k: jnp.zeros(v.shape, v.dtype) for k, v in
              jax_transformer.block_cache_spec(cfg, "local", b, MAX_SEQ,
                                               jnp.float32).items()}
    return jcache, pcache


def _close_caches(pcache, jcache):
    for name in ("k", "v"):
        np.testing.assert_allclose(pcache[name].numpy(), _np(jcache[name]),
                                   rtol=0, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3 has no CPU mode)")
    return torch.device("cuda")


def _ring(s, pos, hq=4, hd=32, seed=0):
    """q at position ``pos`` and a ring of ``s`` slots holding positions
    max(0, pos - s + 1) .. pos at slot p % s (others zero), as (B, H, T, hd)
    tensors; also the same keys in position order."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((1, hq, 1, hd)).astype(np.float32))
    n = min(pos + 1, s)
    kpos, vpos = (torch.from_numpy(rng.standard_normal((1, 1, n, hd)).astype(np.float32))
                  for _ in range(2))
    slots = torch.arange(pos - n + 1, pos + 1) % s
    k_ring, v_ring = torch.zeros(1, 1, s, hd), torch.zeros(1, 1, s, hd)
    k_ring[:, :, slots], v_ring[:, :, slots] = kpos, vpos
    return q, k_ring, v_ring, kpos, vpos


class TestRingCache:
    @pytest.mark.parametrize("max_seq,slots", [(64, 16), (16, 16), (8, 8)])
    def test_cache_is_a_ring_of_at_most_the_window(self, layer, max_seq, slots):
        cfg = layer[0]
        got = transformer.block_cache_spec(cfg, "local", 2, max_seq, torch.float32)
        want = jax_transformer.block_cache_spec(cfg, "local", 2, max_seq, jnp.float32)
        assert got["k"][0] == got["v"][0] == tuple(want["k"].shape) == \
            (2, slots, cfg.num_kv_heads, cfg.head_dim)
        full = transformer.block_cache_spec(cfg, "full", 2, max_seq, torch.float32)
        assert full["k"][0][1] == max_seq

    # a prompt shorter than, as long as and longer than the 16-slot ring,
    # from position 0 and from a later position
    @pytest.mark.parametrize("tq", [9, 16, 23])
    @pytest.mark.parametrize("pos_offset", [0, 5])
    def test_prefill_write(self, layer, tq, pos_offset):
        cfg, jattn, pattn = layer
        x = np.random.default_rng(tq + pos_offset).standard_normal(
            (2, tq, cfg.d_model)).astype(np.float32)
        jcache, pcache = _caches(cfg, b=2)
        # a stale ring: the prefill must leave only its own positions
        pcache = {k: v + 1.0 for k, v in pcache.items()}
        jcache = {k: v + 1.0 for k, v in jcache.items()}
        want, jcache = jax_attn.attention_block(jattn, jnp.asarray(x), cfg, kind="local",
                                                pos_offset=pos_offset, cache=jcache)
        got, pcache2 = attention.attention_block(pattn, _t(x), cfg, kind="local",
                                                 pos_offset=pos_offset, cache=pcache)
        assert pcache2["k"] is pcache["k"]             # written in place (P7)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
        _close_caches(pcache2, jcache)
        written = (np.arange(16) < tq) if tq < 16 else np.ones(16, bool)
        shifted = np.roll(written, pos_offset + tq - min(tq, 16))
        assert not pcache2["k"][:, ~shifted].any()

    def test_decode_through_a_wrapped_ring(self, layer):
        """Prefill 11 tokens, then decode 30 steps: the ring wraps twice."""
        cfg, jattn, pattn = layer
        rng = np.random.default_rng(3)
        x = rng.standard_normal((1, 41, cfg.d_model)).astype(np.float32)
        jcache, pcache = _caches(cfg)
        want, jcache = jax_attn.attention_block(jattn, jnp.asarray(x[:, :11]), cfg,
                                                kind="local", cache=jcache)
        got, pcache = attention.attention_block(pattn, _t(x[:, :11]), cfg,
                                                kind="local", cache=pcache)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
        for pos in range(11, 41):
            want, jcache = jax_attn.attention_block(
                jattn, jnp.asarray(x[:, pos:pos + 1]), cfg, kind="local",
                pos_offset=pos, cache=jcache)
            got, pcache = attention.attention_block(
                pattn, _t(x[:, pos:pos + 1]), cfg, kind="local", pos_offset=pos,
                cache=pcache)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)
        _close_caches(pcache, jcache)

    def test_decode_equals_windowed_prefill(self, layer):
        """Token by token through the ring equals one windowed prefill."""
        cfg, _, pattn = layer
        x = _t(np.random.default_rng(4).standard_normal((1, 37, cfg.d_model)))
        full, _ = attention.attention_block(pattn, x, cfg, kind="local")
        _, cache = _caches(cfg)
        outs = []
        for pos in range(37):
            y, cache = attention.attention_block(pattn, x[:, pos:pos + 1], cfg,
                                                 kind="local", pos_offset=pos,
                                                 cache=cache)
            outs.append(y)
        torch.testing.assert_close(torch.cat(outs, 1), full, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("cache_len", [5, 16, 17, 40])
    def test_decode_attention_ring_mask(self, cache_len):
        rng = np.random.default_rng(cache_len)
        q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
        k, v = rng.standard_normal((2, 2, 16, 1, 16)).astype(np.float32)
        want = jax_attn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         cache_len, ring=True, window=16)
        got = attention.decode_attention(_t(q), _t(k), _t(v), cache_len, ring=True,
                                         window=16)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)

    @pytest.mark.parametrize("pos", [7, 31, 70])
    def test_ring_decode_arguments_on_the_plain_version(self, pos):
        """K3's arguments for a ring decode, on its plain version: causal at
        q_offset = pos with no window equals attention over the positions in
        order; with the window it does not once the ring has wrapped."""
        s = 32
        q, k_ring, v_ring, kpos, vpos = _ring(s, pos)
        got = flash_attention(q, k_ring, v_ring, causal=True, q_offset=pos, bq=1, bk=s)
        want = flash_attention(q, kpos, vpos, causal=False, bq=1, bk=kpos.shape[2])
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        windowed = flash_attention(q, k_ring, v_ring, causal=True, q_offset=pos,
                                   window=s, bq=1, bk=s)
        assert (pos < s) == bool(torch.allclose(windowed, want, rtol=0, atol=1e-6))


@pytest.mark.cuda
class TestRingOnCard:
    """K3 on a ring cache, and the model's local layer through it."""

    @pytest.mark.parametrize("pos", [0, 517, 2047, 2100, 4095])
    def test_ring_decode_needs_window_zero(self, cuda, pos):
        s, hq, hd = 2048, 16, 256
        q, k_ring, v_ring, kpos, vpos = (x.to(cuda) for x in _ring(s, pos, hq, hd))
        want = attention.decode_attention(
            q.transpose(1, 2), k_ring.transpose(1, 2), v_ring.transpose(1, 2),
            pos + 1, ring=True, window=s).reshape(1, 1, hq, hd).transpose(1, 2)
        got = flash_attention(q, k_ring, v_ring, causal=True, q_offset=pos, bq=1, bk=s)
        torch.testing.assert_close(got, want, rtol=0, atol=3e-5)
        if pos >= s:
            windowed = flash_attention(q, k_ring, v_ring, causal=True, q_offset=pos,
                                       window=s, bq=1, bk=s)
            assert not torch.allclose(windowed, want, rtol=0, atol=3e-5)

    def test_model_decode_passes_no_window(self, cuda, layer, monkeypatch):
        cfg, _, pattn = layer
        pattn = {k: v.to(cuda) for k, v in pattn.items()}
        seen = []

        def spy(*args, **kw):
            seen.append((kw["window"], kw["q_offset"], kw["causal"]))
            return flash_attention(*args, **kw)

        monkeypatch.setattr(attention, "flash_attention", spy)
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (1, 21, cfg.d_model)).astype(np.float32)).to(cuda)
        outs = {}
        for use_kernel in (True, False):
            cache = {k: torch.zeros(shape, dtype=dt, device=cuda) for k, (shape, dt) in
                     transformer.block_cache_spec(cfg, "local", 1, MAX_SEQ,
                                                  torch.float32).items()}
            _, cache = attention.attention_block(pattn, x[:, :18], cfg, kind="local",
                                                 cache=cache, use_kernel=use_kernel)
            ys = []
            for pos in range(18, 21):
                y, cache = attention.attention_block(
                    pattn, x[:, pos:pos + 1], cfg, kind="local", pos_offset=pos,
                    cache=cache, use_kernel=use_kernel)
                ys.append(y)
            outs[use_kernel] = torch.cat(ys, 1)
        assert seen == [(16, 0, True), (0, 18, True), (0, 19, True), (0, 20, True)]
        torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=3e-5)
