"""Attention: GQA (optional bias / sliding window / cross), prefill and decode.

The port of ``repro.models.attention``: the "full" and "local"
(sliding-window) kinds of self-attention and the cross-attention of
whisper's decoder and the VLM's "cross" layers.  Two execution paths, one
semantics:

  * the plain versions, line for line with the reference:
    ``direct_attention`` (materialised scores, prefill of at most 2048
    tokens and every cross-attention prefill), ``decode_attention`` (one
    query against the cache), and past 2048 tokens ``banded_attention``
    (a "local" layer whose window is at most half the prompt: each query
    chunk against its own and the previous key chunk) or
    ``chunked_attention`` (loops over query and key chunks with an online
    softmax in f32; also MLA's long path, whose values may be narrower than
    its keys).  They run on the CPU and, when asked for with
    ``use_kernel=False``, on the card;
  * K3, the hand-written Hopper flash attention kernel
    (``repro_torch.kernels.flash_attention``), which carries prefill at any
    length, decode and cross-attention on a CUDA tensor.  For a non-ring
    cache the reference's decode mask ``slot < pos + 1`` is K3's causal
    mask at ``q_offset = pos``, and the kernel reads only slots 0..pos.  A
    "local" layer's prefill passes its window to K3.  Cross-attention is
    K3 with ``causal=False`` over all of the cached keys, at any Tq.

A "local" layer's cache is a ring of ``min(attn_window, max_seq)`` slots:
position p lives in slot ``p % S``.  Decode writes its slot in place;
prefill keeps the prompt's last ``min(T, S)`` positions at their slots and
zeroes the rest, as the reference's rolled write leaves them.  A "cross"
layer's prefill projects K/V from ``cross_x`` (no rope, no causal mask)
and caches them as ``xk``/``xv``; its decode reads them.

The reference's ``seq_parallel_attention`` returns ``None`` without mesh
rules, and the port has no mesh yet (ROADMAP E3), so a long prefill goes
straight to the banded or chunked form.  The reference's ``shard``
constraints are no-ops without mesh rules and are dropped.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.kernel import flash_attention
from .common import Params, apply_rope, dense_init, matmul_lowp

NEG_INF = -2.0e38
DIRECT_MAX_T = 2048     # longest prefill the reference gives direct_attention


def attn_init(gen: torch.Generator, cfg: ModelConfig, d_model: Optional[int] = None,
              num_heads: Optional[int] = None, num_kv: Optional[int] = None,
              dtype: torch.dtype = torch.float32) -> Params:
    d = d_model or cfg.d_model
    h = num_heads or cfg.num_heads
    kv = num_kv or cfg.num_kv_heads
    hd = cfg.head_dim
    p: Params = {
        "wq": dense_init(gen, d, h * hd, dtype),
        "wk": dense_init(gen, d, kv * hd, dtype),
        "wv": dense_init(gen, d, kv * hd, dtype),
        "wo": dense_init(gen, h * hd, d, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(p: Params, x: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig,
                 num_heads: int, num_kv: int):
    hd = cfg.head_dim
    q = x @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    b, t = x.shape[:2]
    tk = xkv.shape[1]
    q = q.reshape(b, t, num_heads, hd)
    k = k.reshape(b, tk, num_kv, hd)
    v = v.reshape(b, tk, num_kv, hd)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,Tq,KV,G,hd) x k (B,Tk,KV,hd) -> (B,KV,G,Tq,Tk)."""
    return torch.einsum("bqkgh,bskh->bkgqs", q, k)


def _gqa_out(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w (B,KV,G,Tq,Tk) x v (B,Tk,KV,hd) -> (B,Tq,KV,G,hd)."""
    return torch.einsum("bkgqs,bskh->bqkgh", w, v)


def _causal_mask(tq: int, tk: int, q_offset: int, window: int = 0,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """(tq, tk) additive mask. q position = q_offset + row index."""
    qi = q_offset + torch.arange(tq, device=device)[:, None]
    ki = torch.arange(tk, device=device)[None, :]
    ok = ki <= qi
    if window > 0:
        ok &= ki > qi - window
    return torch.where(ok, 0.0, NEG_INF).float()


def direct_attention(q, k, v, mask) -> torch.Tensor:
    """q (B,Tq,H,hd), k/v (B,Tk,KV,hd), mask (Tq,Tk) or (B,1,1,Tq,Tk)."""
    b, tq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, tq, kvh, g, hd) * (hd ** -0.5)
    s = _gqa_scores(qg, k).float()
    s = s + (mask if mask.dim() > 2 else mask[None, None, None])
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = _gqa_out(w, v)
    return o.reshape(b, tq, h * hd)


def chunked_attention(q, k, v, q_offset: int, window: int = 0,
                      q_chunk: int = 512, k_chunk: int = 1024) -> torch.Tensor:
    """Flash-style causal attention, a loop over query chunks and, inside
    it, over key chunks with an online softmax in f32.

    Memory is O(q_chunk * k_chunk) per head instead of O(Tq * Tk).  v may
    have a different head dim than q/k (MLA).  The reference pads q and k
    to whole chunks; here the last chunks are short instead, which changes
    nothing: padded queries are cut from its result and padded keys are
    masked.  As there, a row whose first key chunks are all masked (a
    window) gathers weight 1 per masked key until its first visible key
    arrives, whose ``alpha = exp(NEG_INF - m)`` is exactly 0.
    """
    b, tq, h, hd = q.shape
    tk, kvh, hv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    scale = hd ** -0.5
    out = q.new_empty((b, tq, h * hv))
    for i0 in range(0, tq, q_chunk):
        qi = q[:, i0:i0 + q_chunk]
        qc = qi.shape[1]
        qi = qi.reshape(b, qc, kvh, g, hd) * scale
        q_pos = q_offset + i0 + torch.arange(qc, device=q.device)
        m = torch.full((b, kvh, g, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, qc, hv), dtype=torch.float32, device=q.device)
        for j0 in range(0, tk, k_chunk):
            ki, vi = k[:, j0:j0 + k_chunk], v[:, j0:j0 + k_chunk]
            k_pos = j0 + torch.arange(ki.shape[1], device=q.device)
            s = _gqa_scores(qi, ki).float()
            ok = k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                ok &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(q.dtype), vi).float()
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-37)
        out[:, i0:i0 + qc] = o.permute(0, 3, 1, 2, 4).reshape(b, qc, h * hv).to(q.dtype)
    return out


def banded_attention(q, k, v, q_offset: int, window: int) -> torch.Tensor:
    """Sliding-window causal self-attention computed as a band: each query
    chunk attends to its own and the previous key chunk only (chunk >=
    window), so compute is O(T * window) instead of O(T^2).

    k and v hold the same positions as q (``q_offset``..).  The reference
    pads to whole chunks and gives chunk 0 a zero previous chunk; both are
    masked there (k_pos >= q_offset, causality), so here they are simply
    absent."""
    b, tq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    chunk = max(512, window)
    scale = hd ** -0.5
    out = q.new_empty((b, tq, h * hd))
    for i0 in range(0, tq, chunk):
        qi = q[:, i0:i0 + chunk]
        qc = qi.shape[1]
        j0 = max(0, i0 - chunk)
        kk, vv = k[:, j0:i0 + qc], v[:, j0:i0 + qc]
        q_pos = q_offset + i0 + torch.arange(qc, device=q.device)
        k_pos = q_offset + j0 + torch.arange(kk.shape[1], device=q.device)
        s = _gqa_scores(qi.reshape(b, qc, kvh, g, hd) * scale, kk).float()
        ok = (k_pos[None, :] <= q_pos[:, None]) & \
            (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(ok, s, NEG_INF)
        w = torch.softmax(s, dim=-1).to(q.dtype)
        out[:, i0:i0 + qc] = _gqa_out(w, vv).reshape(b, qc, h * hd)
    return out


def decode_attention(q, k_cache, v_cache, cache_len, ring: bool = False,
                     window: int = 0) -> torch.Tensor:
    """One-token decode: q (B,1,H,hd) vs cache (B,S,KV,hd).

    ``cache_len`` = number of tokens already written (including the one for
    this step).  For ring buffers every slot < window is valid once the ring
    has wrapped.
    """
    b, _, h, hd = q.shape
    s = k_cache.shape[1]
    kvh = k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd) * (hd ** -0.5)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache).float()
    slot = torch.arange(s, device=q.device)[None, None, None, None, :]
    if ring:
        valid = slot < min(cache_len, s)
    else:
        valid = slot < cache_len
    logits = torch.where(valid, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v_cache)
    return o.reshape(b, 1, h * hd)


def _kernel_attention(q, k, v, *, causal: bool, q_offset: int,
                      window: int = 0) -> torch.Tensor:
    """K3 on (B, T, H, hd) tensors: the kernel takes their transposed views
    as they lie, and its (B, Hq, Tq, hd) result lies in (B, Tq, Hq, hd)
    memory, so neither side copies.  The block sizes only have to divide."""
    b, tq, h, hd = q.shape
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, window=window, q_offset=q_offset,
                          bq=tq, bk=k.shape[1])
    return out.transpose(1, 2).reshape(b, tq, h * hd)


def _ring_write(buf: torch.Tensor, x: torch.Tensor, pos_offset: int) -> None:
    """Prefill into a ring cache, in place: the last ``min(T, S)`` of
    ``x``'s positions (``pos_offset``..) at slot ``p % S``, every other
    slot zero (what the reference's ``zeros_like(...).at[:take].set``
    then ``roll`` returns)."""
    tq, s = x.shape[1], buf.shape[1]
    take = min(tq, s)
    p0 = pos_offset + tq - take
    slots = torch.arange(p0, p0 + take, device=buf.device) % s
    buf.zero_()
    buf[:, slots] = x[:, tq - take:].to(buf.dtype)


def attention_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    kind: str, pos_offset: int = 0, theta: Optional[float] = None,
                    cache: Optional[Params] = None,
                    cross_x: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    num_heads: Optional[int] = None,
                    num_kv: Optional[int] = None,
                    use_kernel: bool = True):
    """Full attention sub-block: project → rope → attend → out-project.

    Returns (out, new_cache).  ``cache=None`` means train/prefill without
    cache retention; a dict cache triggers the decode path when Tq == 1.
    On a CUDA tensor, with ``use_kernel`` (the default), attention runs in
    K3; otherwise in the plain versions.  kind: "full" | "local" (any other
    kind attends as "full", as in the reference); cross-attention passes
    ``cross_x`` (no rope, not causal), or a cache holding ``xk``/``xv``.
    """
    h = num_heads or cfg.num_heads
    kv = num_kv or cfg.num_kv_heads
    hd = cfg.head_dim
    window = cfg.attn_window if kind == "local" else 0
    theta = cfg.rope_theta if theta is None else theta
    kernel = use_kernel and x.device.type == "cuda"

    if cross_x is not None or (cache is not None and "xk" in cache):
        if cross_x is None:
            # decode: cross K/V were cached at prefill
            k, v = cache["xk"], cache["xv"]
            q = x @ p["wq"]
            if "bq" in p:
                q = q + p["bq"]
            q = q.reshape(x.shape[0], x.shape[1], h, hd)
            new_cache = {"xk": k, "xv": v}
        else:
            q, k, v = _project_qkv(p, x, cross_x, cfg, h, kv)
            new_cache = None
            if cache is not None:
                if "xk" in cache and cache["xk"].shape == k.shape:
                    # in place, as every cache write of the port (P7)
                    cache["xk"].copy_(k)
                    cache["xv"].copy_(v)
                    k, v = cache["xk"], cache["xv"]
                new_cache = {"xk": k, "xv": v}
        tq = q.shape[1]
        if kernel:
            out = _kernel_attention(q, k, v, causal=False, q_offset=0)
        elif tq == 1:
            out = decode_attention(q, k, v, k.shape[1])
        else:
            mask = torch.zeros((tq, k.shape[1]), dtype=torch.float32, device=x.device)
            out = direct_attention(q, k, v, mask)
        return matmul_lowp(out, p["wo"]), new_cache

    q, k, v = _project_qkv(p, x, x, cfg, h, kv)
    b, tq = q.shape[:2]
    positions = pos_offset + torch.arange(tq, device=x.device)
    if theta:
        q = apply_rope(q, positions.expand(b, tq), theta)
        k = apply_rope(k, positions.expand(b, tq), theta)

    ring = False
    if cache is not None:
        s_cache = cache["k"].shape[1]
        ring = window > 0 and s_cache <= window

    if cache is not None and tq == 1:
        # decode: write this step's k/v into the cache (slot pos, or pos % S
        # in a ring) in place (the reference's dynamic_update_slice returns
        # a new array; the caller owns the cache either way), then attend
        k_cache, v_cache = cache["k"], cache["v"]
        slot = pos_offset % s_cache if ring else pos_offset
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
        if kernel:
            # K3 over the whole cache with the causal mask at q_offset = pos
            # and NO window: it sees slots <= pos, which is every slot once
            # a ring is full, and exactly the reference's mask
            # slot < min(pos + 1, S).  Ring slots are not in position order
            # (slot s holds position p with p % S = s), so K3's window, which
            # compares slot indices with positions, would drop valid slots;
            # softmax does not care about the order of the keys it sums
            out = _kernel_attention(q, k_cache, v_cache, causal=True,
                                    q_offset=pos_offset)
        else:
            out = decode_attention(q, k_cache, v_cache, pos_offset + 1,
                                   ring=ring, window=window)
        return out @ p["wo"], {"k": k_cache, "v": v_cache}

    # train / prefill
    if kernel:
        out = _kernel_attention(q, k, v, causal=causal, q_offset=pos_offset,
                                window=window)
    elif tq <= DIRECT_MAX_T:
        mask = _causal_mask(tq, tq, pos_offset, window, device=x.device) if causal \
            else torch.zeros((tq, tq), dtype=torch.float32, device=x.device)
        out = direct_attention(q, k, v, mask)
    elif 0 < window <= tq // 2:
        # causal or not, as in the reference (its seq_parallel_attention,
        # tried first for a causal prefill, returns None without mesh rules)
        out = banded_attention(q, k, v, pos_offset, window)
    else:
        out = chunked_attention(q, k, v, pos_offset, window)

    new_cache = None
    if cache is not None:
        # prefill, in place: a ring keeps the last S positions at their
        # slots; otherwise the prompt's k/v go into slots pos_offset..
        for name, val in (("k", k), ("v", v)):
            if ring:
                _ring_write(cache[name], val, pos_offset)
            else:
                cache[name][:, pos_offset:pos_offset + tq] = val.to(cache[name].dtype)
        new_cache = {"k": cache["k"], "v": cache["v"]}
    return matmul_lowp(out, p["wo"]), new_cache
