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

The bf16 kernel's own logic is also held on the CPU: its split plan (each
row tile's visible keys cut into chunks, each walked by one block), the
merge of the chunks' (m, l, acc) partials in f32, and the hi/lo split of
the softmax weights P before P.V, emulated in plain torch.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jax_kernel
from repro.kernels.flash_attention import ref as jax_ref
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.kernels.flash_attention.kernel import (flash_attention, key_range,
                                                        rows_aligned, split_plan)

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
# recurrentgemma-9b's local attention (16 q over 1 kv head of 256): prefill
# with its 2048 window, and decode over the 2048-slot ring (no window)
GRIFFIN_CASES = [(128, 128, 0, 2048), (891, 891, 0, 2048), (1024, 1024, 0, 2048),
                 (1, 2048, 0, 0), (1, 2048, 517, 0), (1, 2048, 2047, 0)]
# decode on either side of a split boundary (64-key tiles; 63 is one whole
# tile, 64 one key into the second), and a windowed decode whose range starts
# mid-tile
SPLIT_DECODE = [(1, 2048, qo, 0) for qo in (63, 64, 127, 128, 1023, 1024)] + [
    (1, 2048, 2047, 100)]
# (hq, hkv, hd) of qwen2-0.5b and recurrentgemma-9b's local layers
QWEN_HEADS, GRIFFIN_HEADS = (14, 2, 64), (16, 1, 256)
# prefill one past the bf16 row tile and key tile: 577 = 9 * 64 + 1 (qwen2,
# 9 positions per block) and 129 = 4 * 32 + 1 (hd 256: 4 positions, 32 keys):
# (heads, T, window)
ONE_PAST = [(QWEN_HEADS, 577, 0), (GRIFFIN_HEADS, 129, 2048)]
BF16_ON_CARD = dict(rtol=2.0 ** -7, atol=3e-5)
# blocks a card holds at once, as split_plan is told: an H100's 132 SMs at 2
# blocks each (the wrapper asks the card for its own number)
SLOTS = 2 * 132


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

    @staticmethod
    def _model_bf16(cuda, heads, tq, tk, seed=3):
        hq, hkv, hd = heads
        return [torch.from_numpy(x).to(cuda).bfloat16().transpose(1, 2).contiguous()
                .transpose(1, 2) for x in _qkv(1, hq, hkv, tq, tk, hd, seed=seed)]

    def _check_bf16(self, cuda, heads, tq, tk, qo, win):
        q, k, v = self._model_bf16(cuda, heads, tq, tk)
        before = flash_attention.launches
        got = flash_attention(q, k, v, q_offset=qo, window=win, bq=tq, bk=tk)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = ref.mha_ref(q, k, v, q_offset=qo, window=win)
        torch.testing.assert_close(got.float(), want.float(), **BF16_ON_CARD)

    @pytest.mark.parametrize("tq,tk,qo,win", GRIFFIN_CASES)
    def test_griffin_shapes_bf16(self, cuda, tq, tk, qo, win):
        self._check_bf16(cuda, GRIFFIN_HEADS, tq, tk, qo, win)

    @pytest.mark.parametrize("heads", [QWEN_HEADS, GRIFFIN_HEADS])
    @pytest.mark.parametrize("tq,tk,qo,win", SPLIT_DECODE)
    def test_split_boundaries_bf16(self, cuda, heads, tq, tk, qo, win):
        self._check_bf16(cuda, heads, tq, tk, qo, win)

    @pytest.mark.parametrize("heads,t,win", ONE_PAST)
    def test_one_past_the_tiles_bf16(self, cuda, heads, t, win):
        self._check_bf16(cuda, heads, t, t, 0, win)

    def test_rows_that_miss_a_chunk_bf16(self, cuda):
        """A split prefill in which some rows see none of a chunk's keys."""
        assert _rows_missing_a_chunk(QWEN_HEADS, 513)
        self._check_bf16(cuda, QWEN_HEADS, 513, 513, 0, 0)

    @pytest.mark.parametrize("heads,tq,qo", [(QWEN_HEADS, 1, 2047), (GRIFFIN_HEADS, 1, 2047),
                                             (QWEN_HEADS, 1024, 0), (GRIFFIN_HEADS, 1024, 0)])
    def test_repeat_calls_bit_identical(self, cuda, heads, tq, qo):
        """The split's merge order is fixed, so the same call gives the same
        bits every time (the engine's identical-tokens check rests on it)."""
        tk = 2048 if tq == 1 else tq
        q, k, v = self._model_bf16(cuda, heads, tq, tk)
        first = flash_attention(q, k, v, q_offset=qo, bq=tq, bk=tk)
        for _ in range(3):
            assert torch.equal(flash_attention(q, k, v, q_offset=qo, bq=tq, bk=tk), first)

    def test_each_stream_has_its_own_tickets_bf16(self, cuda):
        """A split call on a second stream takes its own ticket array, so it
        never shares a ticket with a launch on the first; both give the same
        bits."""
        q, k, v = self._model_bf16(cuda, QWEN_HEADS, 1, 2048)
        first = flash_attention(q, k, v, q_offset=2047, bq=1, bk=2048)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            second = flash_attention(q, k, v, q_offset=2047, bq=1, bk=2048)
        torch.cuda.synchronize()
        keys = {key for key in kernel._TICKETS if key[0] == q.device}
        assert {torch.cuda.current_stream().cuda_stream, side.cuda_stream} <= {s for _, s in keys}
        assert torch.equal(first, second)

    def test_rejects_unaligned_rows_bf16(self, cuda):
        base = torch.zeros(4096, dtype=torch.bfloat16, device=cuda)
        q = base[1:2049].view(1, 2, 16, 64)
        with pytest.raises(ValueError, match="16"):
            flash_attention(q, q, q, bq=16, bk=16)


# -- the bf16 kernel's plan and arithmetic, in plain torch on the CPU --------

# b, hq, hkv, tq, tk, hd, causal, window, q_offset: the plan's cases
PLAN_CASES = [
    (1, 14, 2, 128, 128, 64, True, 0, 0),            # causal prefill
    (1, 14, 2, 161, 161, 64, True, 0, 0),
    (1, 14, 2, 1024, 1024, 64, True, 0, 0),
    (1, 4, 2, 256, 256, 32, True, 96, 0),            # windowed
    (1, 16, 1, 128, 128, 256, True, 100, 0),
    (2, 4, 4, 128, 128, 16, False, 0, 0),            # bidirectional
    (1, 2, 2, 64, 192, 32, True, 0, 128),            # q_offset
    (1, 14, 2, 1, 2048, 64, True, 0, 0),             # decode
    (1, 14, 2, 1, 2048, 64, True, 0, 517),
    (1, 16, 1, 1, 2048, 256, True, 0, 2047),
    (1, 16, 1, 1, 2048, 256, True, 100, 2047),       # windowed decode
    (1, 16, 1, 1, 2048, 256, True, 0, 4095),         # ring decode past the ring's end
]


def _chunk_bounds(plan, rt, tq, tk, *, causal=True, window=0, q_offset=0):
    """The key ranges [lo, hi) that row tile ``rt``'s blocks walk, in order:
    ``tiles_per_chunk`` whole tiles each, as many as its own range needs (a
    row tile with no visible key has one empty chunk; blocks past them exit
    at once).  Mirrors flash_attention_kernel's own arithmetic:
    ``csrc/flash_attention.cu:254-262`` (key_range, ntiles, nsplit, tile_lo
    and n)."""
    t0 = rt * plan.qt
    k_begin, k_end = key_range(t0, min(tq, t0 + plan.qt), tk, causal=causal,
                               window=window, q_offset=q_offset)
    n = -(-(k_end - k_begin) // plan.bk) if k_end > k_begin else 0
    if n == 0:
        return [(k_end, k_end)]
    per = plan.tiles_per_chunk
    return [(k_begin + lo * plan.bk, min(k_end, k_begin + (lo + per) * plan.bk))
            for lo in range(0, n, per)]


def _rows(plan, rt, tq, group, kvh):
    """The (position, head) rows of row tile ``rt`` that hold queries, in the
    kernel's group-major order."""
    t0 = rt * plan.qt
    return [(t, kvh * group + h) for t in range(t0, min(tq, t0 + plan.qt))
            for h in range(group)]


def _partial(q, k, v, qpos, lo, hi, k_end, *, causal, window):
    """One block's (m, l, acc) in f32: rows ``q`` (R, hd) at query positions
    ``qpos`` over keys [lo, hi), as the kernel keeps them (m = -inf and
    l = 0 for a row that sees none of them)."""
    key = torch.arange(lo, hi)
    ok = (key < k_end)[None].expand(len(qpos), -1)
    if causal:
        ok = ok & (key[None] <= qpos[:, None])
        if window > 0:
            ok = ok & (key[None] > qpos[:, None] - window)
    s = torch.where(ok, (q @ k[lo:hi].T) * q.shape[-1] ** -0.5, -torch.inf)
    m = s.amax(-1) if hi > lo else torch.full((len(qpos),), -torch.inf)
    p = torch.exp(s - torch.where(m == -torch.inf, 0.0, m)[:, None])
    return m, p.sum(-1), p @ v[lo:hi]


def _merge(parts):
    """The kernel's merge of (m, l, acc) partials, in fixed order; a part
    with m = -inf weighs 0 (no -inf - -inf is formed)."""
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    ref_m = torch.where(big == -torch.inf, 0.0, big)
    num, den = 0.0, 0.0
    for m, l, acc in parts:
        w = torch.where(m == -torch.inf, 0.0, torch.exp(m - ref_m))
        num, den = num + w[:, None] * acc, den + w * l
    return num / den.clamp_min(1e-37)[:, None]


def _split_attention(q, k, v, *, causal, window, q_offset, plan):
    """(B, Hq, Tq, hd) f32: every row tile's chunks of ``plan`` computed as
    separate partials and merged, as the split kernel does."""
    b, hq, tq, _ = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    out = torch.full_like(q, torch.nan)
    for bi in range(b):
        for kvh in range(hkv):
            for rt in range(plan.row_tiles):
                rows = _rows(plan, rt, tq, group, kvh)
                qr = torch.stack([q[bi, h, t] for t, h in rows])
                qpos = torch.tensor([q_offset + t for t, _ in rows])
                t0 = rt * plan.qt
                _, k_end = key_range(t0, min(tq, t0 + plan.qt), tk, causal=causal,
                                     window=window, q_offset=q_offset)
                parts = [_partial(qr, k[bi, kvh], v[bi, kvh], qpos, lo, hi, k_end,
                                  causal=causal, window=window)
                         for lo, hi in _chunk_bounds(plan, rt, tq, tk, causal=causal,
                                                     window=window, q_offset=q_offset)]
                o = _merge(parts)
                for i, (t, h) in enumerate(rows):
                    out[bi, h, t] = o[i]
    return out


def _tiled_bf16(q, k, v, *, bk, window=0, split_p=True):
    """The bf16 kernel's arithmetic over all rows at once: causal online
    softmax over ``bk``-key tiles in f32, and P.V as P_hi.V + P_lo.V with
    P_hi = bf16(P), P_lo = bf16(P - P_hi) (``split_p=False``: P rounded to
    bf16 once).  The result rounded once to bf16."""
    b, hq, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, tq, hd)
    kf, vf = k.float(), v.float()
    m = torch.full(qg.shape[:-1], -torch.inf)
    l = torch.zeros(qg.shape[:-1])
    acc = torch.zeros(qg.shape)
    qi = torch.arange(tq)[:, None]
    for k0 in range(0, tk, bk):
        ki = torch.arange(k0, min(tk, k0 + bk))[None]
        ok = ki <= qi
        if window > 0:
            ok &= ki > qi - window
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf[:, :, k0:k0 + bk]) * hd ** -0.5
        s = torch.where(ok, s, -torch.inf)
        new = torch.maximum(m, s.amax(-1))
        use = torch.where(new == -torch.inf, 0.0, new)
        alpha = torch.exp(m - use)
        p = torch.exp(s - use[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float() if split_p else torch.zeros_like(p)
        vt = vf[:, :, None, k0:k0 + bk]
        acc = acc * alpha[..., None] + hi @ vt + lo @ vt
        m = new
    return (acc / l.clamp_min(1e-37)[..., None]).reshape(b, hq, tq, hd).bfloat16()


def _rows_missing_a_chunk(heads, t):
    """(row tile, chunk) pairs of a causal prefill of length ``t`` where some
    of the row tile's positions precede every key of the chunk."""
    hq, hkv, hd = heads
    plan = split_plan(1, hq, hkv, t, t, hd, slots=SLOTS)
    return [(rt, c) for rt in range(plan.row_tiles)
            for c in _chunk_bounds(plan, rt, t, t) if c[0] > rt * plan.qt]


def _limit_share(got, want, tol):
    want = want.float()
    return float(((got.float() - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


class TestSplitPlan:
    """The plan that cuts each row tile's visible key range into chunks."""

    @pytest.mark.parametrize("slots", [264, 396, 10 ** 6])
    @pytest.mark.parametrize("b,hq,hkv,tq,tk,hd,causal,win,qo", PLAN_CASES)
    def test_chunks_cover_each_row_tiles_keys_once(self, b, hq, hkv, tq, tk, hd,
                                                   causal, win, qo, slots):
        kw = dict(causal=causal, window=win, q_offset=qo)
        plan = split_plan(b, hq, hkv, tq, tk, hd, slots=slots, **kw)
        group = hq // hkv
        assert plan.qt * group <= plan.rows and plan.row_tiles * plan.qt >= tq
        assert 1 <= plan.splits <= 64
        base = plan.row_tiles * hkv * b
        if base >= slots:
            assert plan.splits == 1
        # every key a row of the tile sees (mha_ref's mask) lies in its range
        qi = qo + torch.arange(tq)[:, None]
        ki = torch.arange(tk)[None]
        seen = (ki <= qi) & ((ki > qi - win) if win > 0 else True) if causal else \
            torch.ones(tq, tk, dtype=torch.bool)
        blocks = 0
        for rt in range(plan.row_tiles):
            t0 = rt * plan.qt
            k_begin, k_end = key_range(t0, min(tq, t0 + plan.qt), tk, **kw)
            keys = seen[t0:t0 + plan.qt].any(0).nonzero().flatten().tolist()
            assert all(k_begin <= key < k_end for key in keys)
            chunks = _chunk_bounds(plan, rt, tq, tk, **kw)
            assert 1 <= len(chunks) <= plan.splits
            blocks += len(chunks)
            if k_end <= k_begin:                             # no visible key: one empty chunk
                assert chunks == [(k_end, k_end)]
                continue
            at = k_begin
            for lo, hi in chunks:
                assert lo == at < hi <= k_end                # in order, none past k_end
                assert lo >= k_begin                         # none before the window
                assert (lo - k_begin) % plan.bk == 0         # whole tiles
                at = hi
            assert at == k_end                               # every visible key, once
        assert plan.splits == 1 or blocks * hkv * b <= slots  # one wave on the card

    def test_model_plans(self):
        """Decode at 2047 runs on 8 chunks of 4 tiles per kv head, where one
        block per kv head walked every key before; at position 0 nothing is
        split.  Prefill 1024 at qwen2's heads splits its longest row tiles
        in two where the card holds 3 blocks per SM, and stays whole where
        that would take a second wave; prefill 128 stays whole (its merge
        would cost more than the keys it spreads)."""
        for heads in (QWEN_HEADS, GRIFFIN_HEADS):
            plan = split_plan(1, heads[0], heads[1], 1, 2048, heads[2], slots=SLOTS,
                              q_offset=2047)
            assert (plan.rows, plan.qt, plan.splits, plan.tiles_per_chunk) == (16, 1, 8, 4)
            assert split_plan(1, heads[0], heads[1], 1, 2048, heads[2],
                              slots=SLOTS).splits == 1
        big = split_plan(1, 14, 2, 1024, 1024, 64, slots=396)
        assert (big.rows, big.qt, big.row_tiles, big.splits, big.tiles_per_chunk) == \
            (64, 9, 114, 2, 8)
        assert split_plan(1, 14, 2, 1024, 1024, 64, slots=SLOTS).splits == 1
        assert split_plan(1, 14, 2, 128, 128, 64, slots=SLOTS).splits == 1
        assert split_plan(1, 16, 1, 128, 128, 256, slots=SLOTS, window=2048).splits == 1
        assert split_plan(4, 14, 2, 1024, 1024, 64, slots=396).splits == 1   # the grid fills it

    def test_some_rows_miss_a_chunk(self):
        """Prefill 513 at qwen2's heads (two chunks, the second from key
        320): the row tile of positions 315-323 sees keys 320-323 only from
        its second chunk, so its rows at 315-319 see none of them (m = -inf
        in that partial)."""
        assert _rows_missing_a_chunk(QWEN_HEADS, 513)

    def test_rows_aligned(self):
        x = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
        assert rows_aligned(x.transpose(1, 2))                  # the model's views
        assert not rows_aligned(torch.zeros(4096, dtype=torch.bfloat16)[1:2049].view(1, 2, 16, 64))
        assert not rows_aligned(torch.zeros(1, 2, 16, 68, dtype=torch.bfloat16)[..., :64])
        assert rows_aligned(torch.zeros(1, 2, 1, 64, dtype=torch.bfloat16)[:, :, :1])


def _one_tile_chunks(plan):
    """``plan`` with every tile its own chunk: the most partials to merge,
    and under a causal mask rows that see none of a chunk's keys."""
    return dataclasses.replace(plan, splits=64, tiles_per_chunk=1)


class TestSplitMerge:
    """Partials of every chunk, computed apart and merged as the kernel does,
    equal the plain version."""

    @pytest.mark.parametrize("b,hq,hkv,tq,tk,hd,causal,win,bq,bk", CASES)
    def test_cases(self, b, hq, hkv, tq, tk, hd, causal, win, bq, bk):
        q, k, v = _qkv(b, hq, hkv, tq, tk, hd, seed=4)
        kw = dict(causal=causal, window=win, q_offset=tk - tq)
        plan = _one_tile_chunks(split_plan(b, hq, hkv, tq, tk, hd, slots=SLOTS, **kw))
        got = _split_attention(*map(torch.from_numpy, (q, k, v)), plan=plan, **kw)
        assert not got.isnan().any()
        want = jax_ref.mha_ref(*map(jnp.asarray, (q, k, v)), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-5)
        torch.testing.assert_close(got, ref.mha_ref(*map(torch.from_numpy, (q, k, v)), **kw),
                                   rtol=0, atol=3e-5)

    @pytest.mark.parametrize("tq,tk,qo", MODEL_CASES)
    def test_model_shapes(self, tq, tk, qo):
        q, k, v = _qkv(1, 14, 2, tq, tk, 64, seed=5)
        plan = _one_tile_chunks(split_plan(1, 14, 2, tq, tk, 64, slots=SLOTS,
                                                  q_offset=qo))
        got = _split_attention(*map(torch.from_numpy, (q, k, v)), causal=True, window=0,
                               q_offset=qo, plan=plan)
        assert not got.isnan().any()
        want = jax_ref.mha_ref(*map(jnp.asarray, (q, k, v)), q_offset=qo)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-5)

    def test_an_all_masked_chunk_weighs_nothing(self):
        """A chunk whose keys no row sees (m = -inf, l = 0) leaves the merge
        finite and unchanged."""
        q, k, v = (torch.from_numpy(x)[0, 0] for x in _qkv(1, 1, 1, 4, 64, 16, seed=6))
        qpos = torch.arange(4)
        seen = _partial(q, k, v, qpos, 0, 32, 64, causal=True, window=0)
        masked = _partial(q, k, v, qpos, 32, 64, 64, causal=True, window=0)
        assert bool((masked[0] == -torch.inf).all()) and not masked[1].any()
        got = _merge([seen, masked])
        assert got.isfinite().all()
        torch.testing.assert_close(got, _merge([seen]), rtol=0, atol=0)
        assert not _merge([masked, masked]).any()      # no visible key at all: 0


class TestSplitSoftmaxWeights:
    """Why the bf16 kernel splits P into hi + lo before P.V: at prefill 1024
    the split stays within the card's per-element limit of mha_ref and P
    rounded once to bf16 does not."""

    @pytest.mark.parametrize("heads,window", [(QWEN_HEADS, 0), (GRIFFIN_HEADS, 2048)])
    def test_hi_lo_within_the_limit(self, heads, window):
        hq, hkv, hd = heads
        q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(1, hq, hkv, 1024, 1024, hd))
        bk = split_plan(1, hq, hkv, 1024, 1024, hd, slots=SLOTS, window=window).bk
        got = _tiled_bf16(q, k, v, bk=bk, window=window)
        want = ref.mha_ref(q, k, v, window=window)
        torch.testing.assert_close(got.float(), want.float(), **BF16_ON_CARD)

    @pytest.mark.parametrize("heads,window", [(QWEN_HEADS, 0), (GRIFFIN_HEADS, 2048)])
    def test_p_rounded_once_breaks_the_limit(self, heads, window):
        hq, hkv, hd = heads
        q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(1, hq, hkv, 1024, 1024, hd))
        got = _tiled_bf16(q, k, v, bk=64, window=window, split_p=False)
        assert _limit_share(got, ref.mha_ref(q, k, v, window=window), BF16_ON_CARD) > 4


def test_sweep_needs_a_card(capsys):
    """The chunk-size sweep times the kernel, so on the CPU it only says it
    needs a card."""
    from repro_torch.kernels.flash_attention import sweep
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert sweep.main() == 1
    assert "CUDA card" in capsys.readouterr().err
