"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

The port of ``repro.models.mla``.  Queries come from a low-rank down/up
projection; keys/values from a shared compressed latent ``c_kv``
(kv_lora_rank) plus a single shared rotary key.  The decode cache stores
only (c_kv, k_rope): (kv_lora + rope_dim) values per token instead of
2 * H * hd.

Three forms, as in the reference:

  * expanded, for a prefill of at most 2048 tokens (and any uncached
    prefill that short): per-head K/V from the latent, materialised scores;
  * absorbed, for decode and for a cached prefill over 2048 tokens: W_uk
    folded into the query and W_uv out of the value sum, so scores and the
    output accumulate against the (B, S, r) latent;
  * expanded K/V through ``attention.chunked_attention``, for an uncached
    prefill over 2048 tokens.

MLA runs its plain path on every device, the card included: its head
widths (qk 96 = 64 + 32, v 64 at minicpm3-4b) are not K3's (equal q/k/v
head dims from 16/32/64/128/256), and the reference calls no Pallas kernel
here either.  Under mesh rules that shard the query sequence (``seq_q``),
the long uncached prefill first tries ``attention.seq_parallel_attention``
(its plain piece), and ``_absorbed_chunked`` runs each rank's query shard
at its own offset when the shards are multiples of 512, as the
reference's ``shard_map`` branches do; otherwise, and always without
rules, both run their local forms.  The reference's ``shard`` constraints
are at its sites.  The cache is written in place (P7).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import current_rules, on_local_shards, shard
from .attention import NEG_INF, _causal_mask, chunked_attention, seq_parallel_attention
from .common import Params, apply_rope, dense_init, draw_device, rms_norm, rms_norm_init


def mla_init(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype = torch.float32) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": dense_init(gen, d, m.q_lora_rank, dtype),
        "q_norm": rms_norm_init(m.q_lora_rank, dtype, draw_device(gen)),
        "w_uq": dense_init(gen, m.q_lora_rank, h * qk, dtype),
        "w_dkv": dense_init(gen, d, m.kv_lora_rank, dtype),
        "kv_norm": rms_norm_init(m.kv_lora_rank, dtype, draw_device(gen)),
        "w_uk": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_head_dim, dtype),
        "w_uv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, dtype),
        "w_kr": dense_init(gen, d, m.qk_rope_head_dim, dtype),
        "wo": dense_init(gen, h * m.v_head_dim, d, dtype),
    }


def _absorbed_chunked_local(q_lat, q_rope, ckv, kr, q_offset: int, scale: float,
                            q_chunk: int = 512, k_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax causal attention in latent space: scores against the
    (B,S,r) ``ckv`` and (B,S,dr) ``kr``, output accumulated as (B,T,H,r).
    The reference pads to whole chunks; short last chunks give the same
    rows (padded queries are cut, padded keys masked)."""
    b, t, h, r = q_lat.shape
    s = ckv.shape[1]
    out = q_lat.new_empty((b, t, h, r))
    for i0 in range(0, t, q_chunk):
        ql, qrl = q_lat[:, i0:i0 + q_chunk], q_rope[:, i0:i0 + q_chunk]
        qc = ql.shape[1]
        q_pos = q_offset + i0 + torch.arange(qc, device=ql.device)
        mm = torch.full((b, h, qc), NEG_INF, dtype=torch.float32, device=ql.device)
        ll = torch.zeros((b, h, qc), dtype=torch.float32, device=ql.device)
        acc = torch.zeros((b, h, qc, r), dtype=torch.float32, device=ql.device)
        for j0 in range(0, s, k_chunk):
            cc, kk = ckv[:, j0:j0 + k_chunk], kr[:, j0:j0 + k_chunk]
            k_pos = j0 + torch.arange(cc.shape[1], device=ql.device)
            sc = (torch.einsum("bqhr,bsr->bhqs", ql, cc)
                  + torch.einsum("bqhd,bsd->bhqs", qrl, kk)).float() * scale
            sc = torch.where(k_pos[None, :] <= q_pos[:, None], sc, NEG_INF)
            m_new = torch.maximum(mm, sc.amax(dim=-1))
            pw = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(mm - m_new)
            ll = ll * alpha + pw.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqs,bsr->bhqr", pw.to(ql.dtype), cc).float()
            mm = m_new
        o = acc / torch.clamp(ll[..., None], min=1e-37)
        out[:, i0:i0 + qc] = o.transpose(1, 2).to(ql.dtype)
    return out


def _absorbed_chunked(q_lat, q_rope, ckv, kr, q_offset: int, scale: float) -> torch.Tensor:
    """Sequence-parallel wrapper: each rank's query shard at its own offset
    against the whole latent, when the rules shard the query sequence over
    n > 1 ranks in pieces that are multiples of 512; else the local form."""
    rules = current_rules()
    axis = rules.rules.get("seq_q") if rules is not None else None
    t = q_lat.shape[1]
    if isinstance(axis, str):
        n = rules.axis_size(axis)
        if n > 1 and t % n == 0 and (t // n) % 512 == 0:
            def local(ql, qr, c, k):
                off = q_offset + rules.coordinate(axis) * ql.shape[1]
                return _absorbed_chunked_local(ql, qr, c, k, off, scale)
            return on_local_shards(local, [(q_lat, ("batch", "seq_q", None, None)),
                                           (q_rope, ("batch", "seq_q", None, None)),
                                           (ckv, ("batch", None, None)),
                                           (kr, ("batch", None, None))],
                                   ("batch", "seq_q", None, None), rules)
    return _absorbed_chunked_local(q_lat, q_rope, ckv, kr, q_offset, scale)


def mla_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              pos_offset: int = 0, cache: Optional[Params] = None):
    """Returns (out, new_cache). Cache = {"ckv": (B,S,r), "kr": (B,S,dr)}."""
    m = cfg.mla
    h = cfg.num_heads
    b, t, _ = x.shape

    q = rms_norm(p["q_norm"], x @ p["w_dq"]) @ p["w_uq"]
    q = q.reshape(b, t, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)

    ckv_new = rms_norm(p["kv_norm"], x @ p["w_dkv"])          # (B,T,r)
    kr_new = x @ p["w_kr"]                                     # (B,T,dr)

    positions = (pos_offset + torch.arange(t, device=x.device)).expand(b, t)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kr_new = apply_rope(kr_new[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    new_cache = None
    if cache is not None:
        # in place (P7): slots pos_offset.. of the latent cache
        cache["ckv"][:, pos_offset:pos_offset + t] = ckv_new.to(cache["ckv"].dtype)
        cache["kr"][:, pos_offset:pos_offset + t] = kr_new.to(cache["kr"].dtype)
        ckv = shard(cache["ckv"], "batch", "kv_seq", None)
        kr = shard(cache["kr"], "batch", "kv_seq", None)
        new_cache = {"ckv": ckv, "kr": kr}
        s = ckv.shape[1]
    else:
        ckv, kr = ckv_new, kr_new
        s = t

    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5

    if t > 2048 and cache is None:
        # long uncached prefill: expanded K/V through chunked_attention
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat(
            [(ckv @ p["w_uk"]).reshape(b, s, h, m.qk_nope_head_dim),
             kr[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)], dim=-1)
        v_full = (ckv @ p["w_uv"]).reshape(b, s, h, m.v_head_dim)
        # K3 takes no qk 96 / v 64 heads: the plain shard piece
        o = seq_parallel_attention(q_full, k_full, v_full, pos_offset=pos_offset,
                                   window=0, rules=current_rules(), use_kernel=False)
        if o is None:
            q_full = shard(q_full, "batch", "seq_q", None, None)
            o = chunked_attention(q_full, k_full, v_full, pos_offset)
        return o @ p["wo"], new_cache

    if cache is not None and (t > 2048 or t == 1):
        # absorbed: scores and output against the latent itself
        w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
        w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
        q_lat = torch.einsum("bthd,rhd->bthr", q_nope, w_uk)
        if t == 1:
            logits = (torch.einsum("bthr,bsr->bhts", q_lat, ckv)
                      + torch.einsum("bthd,bsd->bhts", q_rope, kr)).float() * scale
            valid = torch.arange(s, device=x.device)[None, None, None, :] < (pos_offset + 1)
            logits = torch.where(valid, logits, NEG_INF)
            w = torch.softmax(logits, dim=-1).to(x.dtype)
            o_lat = torch.einsum("bhts,bsr->bthr", w, ckv)
        else:
            q_lat = shard(q_lat, "batch", "seq_q", None, None)
            q_rope_s = shard(q_rope, "batch", "seq_q", None, None)
            o_lat = _absorbed_chunked(q_lat, q_rope_s, ckv, kr, pos_offset, scale)
        o = torch.einsum("bthr,rhv->bthv", o_lat, w_uv)
        # DTensor may split the heads over the model dim here, unevenly
        # (minicpm3-4b: 40 over 16), and cannot flatten such a dim
        o = shard(o, "batch", None, "heads", None)
        return o.reshape(b, t, h * m.v_head_dim) @ p["wo"], new_cache

    # expanded form for short sequences
    k_nope = (ckv @ p["w_uk"]).reshape(b, s, h, m.qk_nope_head_dim)
    v = (ckv @ p["w_uv"]).reshape(b, s, h, m.v_head_dim)
    logits = (torch.einsum("bthd,bshd->bhts", q_nope, k_nope)
              + torch.einsum("bthd,bsd->bhts", q_rope, kr)).float()
    logits = logits * scale

    if cache is not None and t == 1:
        valid = torch.arange(s, device=x.device)[None, None, None, :] < (pos_offset + 1)
        logits = torch.where(valid, logits, NEG_INF)
    else:
        logits = logits + _causal_mask(t, s, pos_offset, device=x.device)[None, None]

    w = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhts,bshd->bthd", w, v).reshape(b, t, h * m.v_head_dim)
    return o @ p["wo"], new_cache
