"""Plain PyTorch versions of the port's kernels.

They are what the kernels compute, written with tensor operations: the
CPU path runs them, the tests hold them against the reference, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import GLOBAL_WINDOW


def mlstm_chunk_step(q, k, v, li, lf, state):
    """One chunk of the chunkwise-parallel mLSTM (the reference's
    ``models/ssm.py::_mlstm_chunk``).

    q/k/v: (B, H, L, dh) f32; li/lf: (B, H, L) log input-gate preactivation
    and log-sigmoid forget gate; state: (C (B,H,dh,dh), n (B,H,dh), m (B,H)),
    m may be -inf.  Returns (h (B,H,L,dh), new state).
    """
    C_in, n_in, m_in = state
    L, dh = q.shape[-2], q.shape[-1]
    b = torch.cumsum(lf, dim=-1)                          # (B,H,L) inclusive
    # intra-chunk log scores: g[t,s] = b_t - b_s + li_s  for s <= t
    g = b[..., :, None] - b[..., None, :] + li[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    g = g.masked_fill(~tri, float("-inf"))
    m_intra = g.amax(dim=-1)                              # (B,H,L)
    m_t = torch.maximum(m_in[..., None] + b, m_intra)     # (B,H,L)
    s = torch.exp(g - m_t[..., None])                     # (B,H,L,L)
    scale = dh ** -0.5
    w = (q @ k.transpose(-1, -2)) * scale * s
    inter = torch.exp(m_in[..., None] + b - m_t)          # (B,H,L)
    qi = q * inter[..., None] * scale
    num = w @ v + qi @ C_in
    den = w.sum(dim=-1) + (qi @ n_in[..., None])[..., 0]
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # state update
    bL = b[..., -1]                                       # (B,H)
    dec = bL[..., None] - b + li                          # (B,H,L)
    m_out = torch.maximum(m_in + bL, dec.amax(dim=-1))
    carry = torch.exp(m_in + bL - m_out)
    kv = k * torch.exp(dec - m_out[..., None])[..., None]  # (B,H,L,dh)
    C_out = C_in * carry[..., None, None] + kv.transpose(-1, -2) @ v
    n_out = n_in * carry[..., None] + kv.sum(dim=-2)
    return h, (C_out, n_out, m_out)


def chunk_len(S: int, chunk: int) -> int:
    """The chunk length both versions use: min(chunk, S), or S when S is
    not a multiple of it."""
    L = min(chunk, S)
    return S if S % L else L


def mlstm_chunk_ref(q, k, v, li, lf, state, chunk: int = 256):
    """The chunk loop of the reference's ``mlstm_forward`` (a ``lax.scan``
    over ``_mlstm_chunk``), with the carried state as input.

    q/k/v: (B, H, S, dh); li/lf: (B, H, S).  Returns (h (B,H,S,dh) f32,
    final (C, n, m))."""
    S = q.shape[2]
    L = chunk_len(S, chunk)
    hs = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        h, state = mlstm_chunk_step(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                    li[:, :, sl], lf[:, :, sl], state)
        hs.append(h)
    return torch.cat(hs, dim=2), state


def mlstm_chunk_states(k, v, li, lf, state, chunk: int = 256):
    """The states entering each chunk of ``mlstm_chunk_ref`` and the final
    one: what the CUDA kernel's chunk-parallel layout computes in its first
    phase, before each chunk's outputs are computed from its entering state
    alone.  Nothing on the serving path calls it; the tests do.

    k/v: (B, H, S, dh); li/lf: (B, H, S).  Returns ((C (B,H,nc,dh,dh),
    n (B,H,nc,dh), m (B,H,nc)) entering chunks 0 .. nc-1, the final
    (C, n, m)), nc = S / chunk_len(S, chunk)."""
    S = k.shape[2]
    L = chunk_len(S, chunk)
    C, n, m = state
    Cs, ns, ms = [], [], []
    for c0 in range(0, S, L):
        Cs.append(C)
        ns.append(n)
        ms.append(m)
        kc, vc = k[:, :, c0:c0 + L], v[:, :, c0:c0 + L]
        b = torch.cumsum(lf[:, :, c0:c0 + L], dim=-1)
        bL = b[..., -1]
        dec = bL[..., None] - b + li[:, :, c0:c0 + L]
        m_out = torch.maximum(m + bL, dec.amax(dim=-1))
        carry = torch.exp(m + bL - m_out)
        kv = kc * torch.exp(dec - m_out[..., None])[..., None]
        C = C * carry[..., None, None] + kv.transpose(-1, -2) @ vc
        n = n * carry[..., None] + kv.sum(dim=-2)
        m = m_out
    entering = (torch.stack(Cs, dim=2), torch.stack(ns, dim=2),
                torch.stack(ms, dim=2))
    return entering, (C, n, m)


def _attn_chunk(q, k, v, q_pos, k_pos, *, window: int, causal: bool,
                scale: float):
    """Exact attention for one query chunk (the reference's
    ``models/layers.py::_attn_chunk``): f32 logits, masked logits -1e30,
    f32 softmax, probabilities cast to v's dtype for the product with v."""
    B, Tq, Hq, dh = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Tq, Hkv, g, dh)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k.float()) * scale
    valid = (k_pos >= 0)[:, None, :]                              # (B,1,Tk)
    if causal:
        rel = q_pos[:, :, None] - k_pos[:, None, :]               # (B,Tq,Tk)
        mask = valid & (rel >= 0) & (rel < window)
    else:
        mask = valid.expand(B, Tq, k.shape[1])
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Tq, Hq, dh)


def attention_ref(q, k, v, q_pos, k_pos, *, window: int = GLOBAL_WINDOW,
                  causal: bool = True, q_chunk: int = 0):
    """Masked GQA attention over explicit positions (the reference's
    ``models/layers.py::attention``).

    q: (B, Tq, Hq, dh); k/v: (B, Tk, Hkv, dh) with Hq % Hkv == 0;
    q_pos: (B, Tq), k_pos: (B, Tk) int, -1 marking an empty slot.  A key
    is live for a query when k_pos >= 0 and, if ``causal``,
    0 <= q_pos - k_pos < window (GLOBAL_WINDOW: unbounded).  ``q_chunk``
    splits the queries into chunks when it divides Tq (same result,
    O(q_chunk * Tk) logits).  Returns (B, Tq, Hq, dh) in v's dtype."""
    B, Tq, Hq, dh = q.shape
    scale = dh ** -0.5
    kw = dict(window=window, causal=causal, scale=scale)
    if q_chunk and Tq > q_chunk and Tq % q_chunk == 0:
        return torch.cat([
            _attn_chunk(q[:, c0:c0 + q_chunk], k, v,
                        q_pos[:, c0:c0 + q_chunk], k_pos, **kw)
            for c0 in range(0, Tq, q_chunk)], dim=1)
    return _attn_chunk(q, k, v, q_pos, k_pos, **kw)
