"""The algebra of K4's backward kernel, on the CPU.

``wkv6_bwd_chunked_ref`` computes the gradient of the WKV recurrence the
way ``csrc/wkv6_bwd.cu`` does: time cut into chunks, each chunk's
carried-in state and end gradient found by products alone (never by
dividing by w), then each chunk walked on its own.  It is held here against
the plain reverse recurrence ``wkv6_bwd_ref`` and against ``jax.vjp`` of
the JAX package's ``wkv6_ref``, on the same numpy inputs, within 1e-5 of
each gradient's largest |ref| in f32; a planted fault (the reverse carry
dropped) must land above that limit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels.rwkv6.ref import (wkv6_bwd_chunk_walks, wkv6_bwd_chunked_ref,
                                           wkv6_bwd_ref, wkv6_chunk_grad_ends,
                                           wkv6_chunk_states, wkv6_ref)

REL = 1e-5
CHUNKS = (4, 16)
# w = exp(-exp(decay + noise)): near 1, mid, near 0 (about 1e-30 and below)
DECAYS = {"near 1": -8.0, "mid": 0.0, "near 0": 4.25}


def _lengths(chunk):
    return (1, chunk - 1, chunk, chunk + 1, 3 * chunk + 5)


def _inputs(t, decay, b=2, h=2, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)  # noqa: E731
    w = np.exp(-np.exp(decay + f(b, t, h, hd, scale=0.5))).astype(np.float32)
    return dict(r=f(b, t, h, hd), k=f(b, t, h, hd, scale=0.3), v=f(b, t, h, hd, scale=0.3),
                w=w, u=f(h, hd, scale=0.3), s0=f(b, h, hd, hd, scale=0.3), do=f(b, t, h, hd),
                dsT=f(b, h, hd, hd))


def _torch(x, with_s0, with_dsT):
    t = {name: torch.from_numpy(a) for name, a in x.items()}
    return (t["r"], t["k"], t["v"], t["w"], t["u"], t["s0"] if with_s0 else None, t["do"],
            t["dsT"] if with_dsT else None)


def _share(got, want) -> float:
    """The largest |got - want| over REL times the largest |want|, over
    the gradients."""
    worst = 0.0
    for g, x in zip(got, want):
        x = np.asarray(x, np.float32)
        err = float(np.abs(np.asarray(g, np.float32) - x).max())
        worst = max(worst, err / (REL * max(float(np.abs(x).max()), 1e-30)))
    return worst


@pytest.mark.parametrize("with_dsT", [False, True])
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("t_case", range(5))
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_against_the_reverse_recurrence(chunk, t_case, decay, with_s0, with_dsT):
    t = _lengths(chunk)[t_case]
    args = _torch(_inputs(t, DECAYS[decay]), with_s0, with_dsT)
    got = wkv6_bwd_chunked_ref(*args, chunk)
    want = wkv6_bwd_ref(*args)
    for g, x in zip(got, want):
        assert g.shape == x.shape and g.dtype == x.dtype
    assert _share([g.numpy() for g in got], [x.numpy() for x in want]) <= 1.0


@pytest.mark.parametrize("with_dsT", [False, True])
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_against_jax_vjp(chunk, decay, with_s0, with_dsT):
    t = 3 * chunk + 5
    x = _inputs(t, DECAYS[decay], seed=1)
    names = ["r", "k", "v", "w", "u"] + (["s0"] if with_s0 else [])
    _, vjp = jax.vjp(jax_wkv6_ref, *(jnp.asarray(x[n]) for n in names))
    b, _, h, hd = x["r"].shape
    dst = x["dsT"] if with_dsT else np.zeros((b, h, hd, hd), np.float32)
    want = vjp((jnp.asarray(x["do"]), jnp.asarray(dst)))
    got = wkv6_bwd_chunked_ref(*_torch(x, with_s0, with_dsT), chunk)
    assert _share([g.numpy() for g in got[:len(want)]], want) <= 1.0


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunk_states_are_the_forward_states(chunk):
    t = 3 * chunk + 5
    nc = -(-t // chunk)
    r, k, v, w, u, s0, _, _ = _torch(_inputs(t, DECAYS["mid"], seed=2), True, True)
    states, delta = wkv6_chunk_states(k, v, w, s0, chunk)
    assert states.shape == (2, nc, 2, 8, 8) and delta.shape == (2, nc, 2, 8)
    for c in range(nc):
        want = s0 if c == 0 else wkv6_ref(r[:, :c * chunk], k[:, :c * chunk], v[:, :c * chunk],
                                          w[:, :c * chunk], u, s0=s0)[1]
        assert _share([states[:, c].numpy()], [want.numpy()]) <= 1.0


@pytest.mark.parametrize("chunk", CHUNKS)
def test_dropping_the_reverse_carry_lands_above_the_limit(chunk):
    """The planted fault: G^end_c = 0 for every chunk but the last, as if
    no gradient were carried back across chunk boundaries."""
    x = _inputs(3 * chunk + 5, DECAYS["mid"], seed=3)
    r, k, v, w, u, s0, do, dsT = _torch(x, True, True)
    want = wkv6_bwd_ref(r, k, v, w, u, s0, do, dsT)
    states, delta = wkv6_chunk_states(k, v, w, s0, chunk)
    ends = wkv6_chunk_grad_ends(r, w, do, dsT, delta, chunk)
    good = wkv6_bwd_chunk_walks(r, k, v, w, u, do, states, ends, chunk)
    ends[:, :-1] = 0.0
    bad = wkv6_bwd_chunk_walks(r, k, v, w, u, do, states, ends, chunk)
    assert _share([g.numpy() for g in good], [x.numpy() for x in want]) <= 1.0
    assert _share([g.numpy() for g in bad], [x.numpy() for x in want]) > 1.0
