"""Plain PyTorch version of the RWKV-6 WKV recurrence (per head):

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    o_t = (S_{t-1} + diag(u) k_t v_tᵀ)ᵀ r_t

The port of ``repro.kernels.rwkv6.ref``, step by step.  The model's plain
path uses it for prefill of any length and for the one-token decode step
alike (the reference's chunked ``lax.scan`` and its inline decode update
compute this same loop).  ``wkv6_bwd_ref`` is its gradient written out
as a reverse recurrence, the plain version of K4's backward;
``wkv6_bwd_chunked_ref`` computes the same gradient by the backward
kernel's algebra (time chunks, two carries, a walk per chunk), for tests.
"""
from __future__ import annotations

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None = None):
    """r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd).
    Returns (o (B, T, H, hd) f32, sT (B, H, hd, hd) f32)."""
    b, t, h, hd = r.shape
    s = s0.float() if s0 is not None else \
        torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    uf = u.float()[None, :, :, None]
    outs = []
    for i in range(t):
        rt, kt, vt, wt = (x[:, i].float() for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        s_eff = s + uf * kv
        outs.append(torch.einsum("bhij,bhi->bhj", s_eff, rt))
        s = wt[..., :, None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, s0: torch.Tensor | None, do: torch.Tensor,
                 dsT: torch.Tensor | None):
    """The gradient of ``wkv6_ref`` as an explicit reverse recurrence.

    ``do`` is the gradient of o (B, T, H, hd) and ``dsT`` that of the final
    state (None: zero).  Per head, with dS_t the gradient of S_t and dS_T =
    dsT, walking t down:

        dr_t = (S_{t-1} + diag(u) k_t v_tᵀ) do_t
        dk_t = u ⊙ r_t (v_t·do_t) + dS_t v_t
        dv_t = (Σ_i r_i u_i k_i) do_t + dS_tᵀ k_t
        dw_t = rowsum(dS_t ⊙ S_{t-1})
        du   = Σ_{b,t} r_t ⊙ k_t (v_t·do_t)
        dS_{t-1} = diag(w_t) dS_t + r_t do_tᵀ,   ds0 = dS_0 (before step 0)

    The states S_{t-1} come from a forward walk (kept in a list), never by
    dividing by w.  Returns (dr, dk, dv, dw, du, ds0): each in its input's
    dtype (f32 math, as autograd through ``wkv6_ref``'s ``.float()``),
    ds0 f32."""
    b, t, h, hd = r.shape
    s = s0.float() if s0 is not None else \
        torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    uf = u.float()
    steps = [tuple(x[:, i].float() for x in (r, k, v, w, do)) for i in range(t)]
    states = []
    for _, kt, vt, wt, _ in steps:
        states.append(s)
        s = wt[..., :, None] * s + kt[..., :, None] * vt[..., None, :]
    g = dsT.float() if dsT is not None else torch.zeros_like(s)
    grads = [torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((h, hd), dtype=torch.float32, device=r.device)
    for i in range(t - 1, -1, -1):
        rt, kt, vt, wt, dot = steps[i]
        sp = states[i]
        vdo = (vt * dot).sum(-1, keepdim=True)
        dr[:, i] = torch.einsum("bhij,bhj->bhi", sp, dot) + uf * kt * vdo
        dk[:, i] = uf * rt * vdo + torch.einsum("bhij,bhj->bhi", g, vt)
        dv[:, i] = (rt * uf * kt).sum(-1, keepdim=True) * dot + \
            torch.einsum("bhij,bhi->bhj", g, kt)
        dw[:, i] = (g * sp).sum(-1)
        du += (rt * kt * vdo).sum(0)
        g = wt[..., :, None] * g + rt[..., :, None] * dot[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), g)


def wkv6_chunk_states(k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                      s0: torch.Tensor | None, chunk: int):
    """The state carried into each time chunk of ``chunk`` steps, by
    products alone: each chunk's local end state Ŝ_c (its steps from a zero
    state) and decay product Δ_c = Π w over its steps, then S_0 = s0 (or
    zero) and S_{c+1} = diag(Δ_c) S_c + Ŝ_c.  Returns (S (B, nc, H, hd, hd),
    Δ (B, nc, H, hd)), both f32."""
    b, t, h, hd = k.shape
    nc = -(-t // chunk)
    local = torch.zeros((b, nc, h, hd, hd), dtype=torch.float32, device=k.device)
    delta = torch.ones((b, nc, h, hd), dtype=torch.float32, device=k.device)
    for c in range(nc):
        for i in range(c * chunk, min(t, (c + 1) * chunk)):
            kt, vt, wt = (x[:, i].float() for x in (k, v, w))
            local[:, c] = wt[..., :, None] * local[:, c] + kt[..., :, None] * vt[..., None, :]
            delta[:, c] = delta[:, c] * wt
    states = torch.empty_like(local)
    s = s0.float() if s0 is not None else torch.zeros_like(local[:, 0])
    for c in range(nc):
        states[:, c] = s
        s = delta[:, c, ..., None] * s + local[:, c]
    return states, delta


def wkv6_chunk_grad_ends(r: torch.Tensor, w: torch.Tensor, do: torch.Tensor,
                         dsT: torch.Tensor | None, delta: torch.Tensor, chunk: int):
    """The gradient of the state at each chunk's last step, by products
    alone: each chunk's local gradient Ĝ_c (its steps walked back from
    zero, G ← diag(w_t) G + r_t do_tᵀ), then G^end_{nc-1} = dsT (or zero)
    and G^end_{c-1} = diag(Δ_c) G^end_c + Ĝ_c.  Returns G^end (B, nc, H,
    hd, hd) f32."""
    b, t, h, hd = r.shape
    nc = delta.shape[1]
    local = torch.zeros((b, nc, h, hd, hd), dtype=torch.float32, device=r.device)
    for c in range(nc):
        for i in range(min(t, (c + 1) * chunk) - 1, c * chunk - 1, -1):
            rt, wt, dot = (x[:, i].float() for x in (r, w, do))
            local[:, c] = wt[..., :, None] * local[:, c] + rt[..., :, None] * dot[..., None, :]
    ends = torch.empty_like(local)
    g = dsT.float() if dsT is not None else torch.zeros_like(local[:, 0])
    for c in range(nc - 1, -1, -1):
        ends[:, c] = g
        g = delta[:, c, ..., None] * g + local[:, c]
    return ends


def wkv6_bwd_chunk_walks(r, k, v, w, u, do, states, ends, chunk: int):
    """Each chunk's gradient walk, from its carried-in state S_c and its
    end gradient G^end_c (``wkv6_bwd_ref`` over the chunk's steps), joined:
    (dr, dk, dv, dw, du, ds0), du summed over the chunks in order and ds0
    the first chunk's."""
    t = r.shape[1]
    parts, du, ds0 = [], None, None
    for c in range(states.shape[1]):
        sl = slice(c * chunk, min(t, (c + 1) * chunk))
        dr, dk, dv, dw, duc, g = wkv6_bwd_ref(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u,
                                              states[:, c], do[:, sl], ends[:, c])
        parts.append((dr, dk, dv, dw))
        du = duc if du is None else du + duc
        ds0 = g if c == 0 else ds0
    return (*(torch.cat(x, dim=1) for x in zip(*parts)), du, ds0)


def wkv6_bwd_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor | None,
                         do: torch.Tensor, dsT: torch.Tensor | None, chunk: int):
    """``wkv6_bwd_ref``'s gradient by the backward kernel's algebra, in
    plain PyTorch (used only by tests): time cut into chunks of ``chunk``
    steps, every chunk's carried-in state (``wkv6_chunk_states``) and end
    gradient (``wkv6_chunk_grad_ends``) found by products alone, never by
    dividing by w, then each chunk walked on its own
    (``wkv6_bwd_chunk_walks``).  Returns what ``wkv6_bwd_ref`` returns."""
    states, delta = wkv6_chunk_states(k, v, w, s0, chunk)
    ends = wkv6_chunk_grad_ends(r, w, do, dsT, delta, chunk)
    return wkv6_bwd_chunk_walks(r, k, v, w, u, do, states, ends, chunk)
