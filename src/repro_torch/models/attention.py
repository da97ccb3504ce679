"""Attention: GQA with optional QKV bias, prefill and decode.

The port of ``repro.models.attention`` for the "full" and "local"
(sliding-window) kinds of self-attention.  Two execution paths, one
semantics:

  * the plain versions, ``direct_attention`` (materialised scores, prefill)
    and ``decode_attention`` (one query against the cache), line for line
    with the reference; they run on the CPU and, when asked for with
    ``use_kernel=False``, on the card;
  * K3, the hand-written Hopper flash attention kernel
    (``repro_torch.kernels.flash_attention``), which carries both prefill
    and decode on a CUDA tensor.  For a non-ring cache the reference's
    decode mask ``slot < pos + 1`` is K3's causal mask at
    ``q_offset = pos``, and the kernel reads only slots 0..pos.  A "local"
    layer's prefill passes its window to K3.

A "local" layer's cache is a ring of ``min(attn_window, max_seq)`` slots:
position p lives in slot ``p % S``.  Decode writes its slot in place;
prefill keeps the prompt's last ``min(T, S)`` positions at their slots and
zeroes the rest, as the reference's rolled write leaves them.

The reference switches prefill longer than 2048 tokens to
``chunked_attention``, ``banded_attention`` or ``seq_parallel_attention``;
the port has no plain version of those yet (ROADMAP B8, E3), so a longer
prefill needs the kernel path.  Cross-attention is not ported yet (ROADMAP
B8).
The reference's ``shard`` constraints are no-ops without mesh rules and
are dropped.
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
    K3; otherwise in the plain versions.  kind: "full" | "local".
    """
    if kind not in ("full", "local"):
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported yet: ROADMAP B8")
    if cross_x is not None or (cache is not None and "xk" in cache):
        raise NotImplementedError("cross-attention is not ported yet: ROADMAP B8")
    h = num_heads or cfg.num_heads
    kv = num_kv or cfg.num_kv_heads
    window = cfg.attn_window if kind == "local" else 0
    theta = cfg.rope_theta if theta is None else theta
    kernel = use_kernel and x.device.type == "cuda"

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
    else:
        raise NotImplementedError(
            f"a plain prefill of {tq} > {DIRECT_MAX_T} tokens needs "
            "chunked_attention, not ported yet (ROADMAP B8); run it on the "
            "card through K3")

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
