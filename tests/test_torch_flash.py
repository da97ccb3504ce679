"""The port's flash attention (``repro_torch.kernels.flash_attention``) held
against the JAX package.

Inputs come from a numpy seed and the same arrays go to both sides.  On the
CPU the port's wrapper runs its plain version (``mha_ref``); it is held
against the reference's Pallas kernel in interpret mode at the shapes of
``tests/test_kernels.py``.  Tolerances: atol 3e-5 in f32 (the reference's
own limit for the kernel: the online softmax reassociates the sums), 3e-2
in bf16 against the Pallas kernel (which rounds its inputs and output at
other points).  The tests marked ``cuda`` hold K3 against ``mha_ref`` on
the card and skip without one: per element, 3e-5 in f32 and
3e-5 + 2^-7 |ref| in bf16 (both compute in f32 from the same bf16 values
and round once to bf16, so they may land one bf16 ulp apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jax_kernel
from repro.kernels.flash_attention import ref as jax_ref
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.flash_attention.kernel import flash_attention

# tests/test_kernels.py's shapes: b, hq, hkv, tq, tk, hd, causal, window, bq, bk
CASES = [
    (2, 4, 2, 128, 128, 32, True, 0, 64, 64),
    (1, 8, 1, 256, 256, 64, True, 0, 128, 128),     # MQA
    (2, 4, 4, 128, 128, 16, False, 0, 64, 32),      # bidirectional
    (1, 4, 2, 256, 256, 32, True, 96, 64, 64),      # sliding window
    (1, 2, 2, 64, 192, 32, True, 0, 32, 64),        # Tk > Tq (offset)
]
# qwen2-0.5b's attention on the main path: prefill (Tq = Tk) and decode
# (one query against a 2048-slot cache at position q_offset).  891 is the
# serving drain's first prompt and 161 is 1 mod 32: ragged in the kernel's
# 32-key tile and its 4-position query block
MODEL_CASES = [(128, 128, 0), (1024, 1024, 0), (161, 161, 0), (891, 891, 0),
               (1, 2048, 0), (1, 2048, 517), (1, 2048, 2047)]
BF16_ON_CARD = dict(rtol=2.0 ** -7, atol=3e-5)


def _qkv(b, hq, hkv, tq, tk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, tq, hd)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, hd)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, hd)).astype(np.float32))


def _jax_flash(q, k, v, **kw):
    return np.asarray(jax_kernel.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **kw))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3 has no CPU mode)")
    return torch.device("cuda")


class TestAgainstReference:
    @pytest.mark.parametrize("b,hq,hkv,tq,tk,hd,causal,win,bq,bk", CASES)
    def test_flash_attention(self, b, hq, hkv, tq, tk, hd, causal, win, bq, bk):
        q, k, v = _qkv(b, hq, hkv, tq, tk, hd)
        kw = dict(causal=causal, window=win, q_offset=tk - tq)
        want = _jax_flash(q, k, v, bq=bq, bk=bk, **kw)
        got = flash_attention(*map(torch.from_numpy, (q, k, v)), bq=bq, bk=bk, **kw)
        assert got.dtype == torch.float32 and got.shape == (b, hq, tq, hd)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)

    @pytest.mark.parametrize("b,hq,hkv,tq,tk,hd,causal,win,bq,bk", CASES)
    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_fused_attention(self, b, hq, hkv, tq, tk, hd, causal, win, bq, bk,
                             use_kernel):
        q, k, v = _qkv(b, hq, hkv, tq, tk, hd, seed=1)
        kw = dict(causal=causal, window=win, q_offset=tk - tq)
        want = np.asarray(jax_ref.mha_ref(*map(jnp.asarray, (q, k, v)), **kw))
        if use_kernel and (tq % 256 or tk % 256):
            # the reference's default 256-blocks must divide, on both sides
            with pytest.raises(ValueError):
                jax_kernel.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
            with pytest.raises(ValueError):
                ops.fused_attention(*map(torch.from_numpy, (q, k, v)),
                                    use_kernel=True, **kw)
            return
        got = ops.fused_attention(*map(torch.from_numpy, (q, k, v)),
                                  use_kernel=use_kernel, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)

    def test_bf16(self):
        q, k, v = _qkv(1, 2, 2, 128, 128, 32, seed=2)
        want = np.asarray(jax_kernel.flash_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), bq=64, bk=64,
            interpret=True), np.float32)
        got = flash_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                              bq=64, bk=64)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=3e-2)

    @pytest.mark.parametrize("tq,tk,qo", MODEL_CASES)
    def test_model_shapes(self, tq, tk, qo):
        """qwen2-0.5b's heads (14 q over 2 kv, hd 64), as strided views of
        (B, T, H, hd) tensors, the way the model hands them over."""
        q, k, v = _qkv(1, 14, 2, tq, tk, 64, seed=3)
        want = np.asarray(jax_ref.mha_ref(*map(jnp.asarray, (q, k, v)), q_offset=qo))
        views = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
                 .transpose(1, 2) for x in (q, k, v)]
        got = flash_attention(*views, q_offset=qo, bq=tq, bk=tk)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)

    def test_rejects_indivisible_like_reference(self):
        q, k, v = _qkv(1, 2, 2, 96, 96, 16)
        with pytest.raises(ValueError) as want:
            jax_kernel.flash_attention(*map(jnp.asarray, (q, k, v)), bq=64, bk=64)
        with pytest.raises(ValueError) as got:
            flash_attention(*map(torch.from_numpy, (q, k, v)), bq=64, bk=64)
        assert str(got.value) == str(want.value)


class TestWrapperChecks:
    def test_rejects_mixed_dtypes(self):
        q = torch.zeros(1, 2, 4, 16)
        with pytest.raises(TypeError):
            flash_attention(q, q.bfloat16(), q, bq=4, bk=4)

    def test_rejects_other_dtypes(self):
        q = torch.zeros(1, 2, 4, 16, dtype=torch.float16)
        with pytest.raises(TypeError):
            flash_attention(q, q, q, bq=4, bk=4)

    @pytest.mark.parametrize("kshape", [
        (1, 3, 4, 16),      # 4 query heads do not split over 3 kv heads
        (1, 2, 4, 8),       # another head dim
        (2, 2, 4, 16),      # another batch
    ])
    def test_rejects_bad_kv_shapes(self, kshape):
        q = torch.zeros(1, 4, 4, 16)
        with pytest.raises(ValueError):
            flash_attention(q, torch.zeros(kshape), torch.zeros(kshape), bq=4, bk=4)

    def test_rejects_three_dims(self):
        with pytest.raises(ValueError):
            flash_attention(torch.zeros(2, 4, 16), torch.zeros(2, 4, 16),
                            torch.zeros(2, 4, 16), bq=4, bk=4)

    def test_cpu_takes_the_plain_version_and_counts_nothing(self):
        q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 32, 32, 16))
        before = flash_attention.launches
        got = flash_attention(q, k, v, bq=32, bk=32)
        assert flash_attention.launches == before
        torch.testing.assert_close(got, ref.mha_ref(q, k, v), rtol=0, atol=0)


@pytest.mark.cuda
class TestKernelOnCard:
    """K3 against its plain version on the card (limits as above)."""

    @pytest.mark.parametrize("b,hq,hkv,tq,tk,hd,causal,win,bq,bk", CASES)
    def test_f32(self, cuda, b, hq, hkv, tq, tk, hd, causal, win, bq, bk):
        q, k, v = (torch.from_numpy(x).to(cuda) for x in _qkv(b, hq, hkv, tq, tk, hd))
        kw = dict(causal=causal, window=win, q_offset=tk - tq)
        before = flash_attention.launches
        got = flash_attention(q, k, v, bq=bq, bk=bk, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        torch.testing.assert_close(got, ref.mha_ref(q, k, v, **kw), rtol=0, atol=3e-5)

    def test_bf16(self, cuda):
        q, k, v = (torch.from_numpy(x).to(cuda).bfloat16()
                   for x in _qkv(1, 2, 2, 128, 128, 32, seed=2))
        got = flash_attention(q, k, v, bq=64, bk=64)
        torch.testing.assert_close(got.float(), ref.mha_ref(q, k, v).float(),
                                   **BF16_ON_CARD)

    @pytest.mark.parametrize("tq,tk,qo", MODEL_CASES)
    def test_model_shapes_bf16(self, cuda, tq, tk, qo):
        q, k, v = (torch.from_numpy(x).to(cuda).bfloat16().transpose(1, 2)
                   .contiguous().transpose(1, 2) for x in _qkv(1, 14, 2, tq, tk, 64))
        got = flash_attention(q, k, v, q_offset=qo, bq=tq, bk=tk)
        want = ref.mha_ref(q, k, v, q_offset=qo)
        torch.testing.assert_close(got.float(), want.float(), **BF16_ON_CARD)

    def test_rejects_a_strided_head_dim(self, cuda):
        q = torch.zeros(1, 2, 4, 32, device=cuda)[..., ::2]
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention(q, q, q, bq=4, bk=4)
