"""Self-attention and dense-FFN blocks for serving.

``self_attention`` runs in one of two modes, as the reference's does:

* ``chunk``: attend over [cache ++ chunk], then write the chunk into the
  cache ("attend-then-update": never overwrites keys the chunk still
  needs);
* ``decode``: write the token first, then attend over the cache only
  ("update-then-attend": no copy of the cache per token; safe because the
  overwritten ring slot is exactly one window old).

A paged entry carries a block table in ``kv['btab']`` and its k/v are the
shared physical pool (num_blocks, bs, H, dh): reads go through
``paged_gather`` and writes through ``paged_scatter``.  Cache writes update
the entry in place.  The reference's ``train`` mode, MoE FFN,
cross-attention and Hymba blocks are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import cache as cache_lib
from repro_torch.models.layers import (attention, dense_init, rmsnorm,
                                       rmsnorm_init, rope, swiglu,
                                       swiglu_init)

Tensor = torch.Tensor


def attn_init(gen: torch.Generator, d_model: int, heads: int, kv_heads: int,
              dh: int, dtype=torch.bfloat16) -> Dict[str, object]:
    return {
        "norm": rmsnorm_init(d_model, dtype, gen.device),
        "wq": dense_init(gen, (d_model, heads * dh), dtype),
        "wk": dense_init(gen, (d_model, kv_heads * dh), dtype),
        "wv": dense_init(gen, (d_model, kv_heads * dh), dtype),
        "wo": dense_init(gen, (heads * dh, d_model), dtype),
    }


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.bfloat16) -> Dict[str, object]:
    """The dense SwiGLU FFN with its pre-norm."""
    return {"fnorm": rmsnorm_init(d_model, dtype, gen.device),
            "ffn": swiglu_init(gen, d_model, d_ff, dtype)}


def _qkv(p, xq: Tensor, xkv: Tensor, heads: int, kv_heads: int, dh: int):
    B, C, _ = xq.shape
    N = xkv.shape[1]
    q = (xq @ p["wq"]).reshape(B, C, heads, dh)
    k = (xkv @ p["wk"]).reshape(B, N, kv_heads, dh)
    v = (xkv @ p["wv"]).reshape(B, N, kv_heads, dh)
    return q, k, v


def self_attention(p, x: Tensor, pos: Tensor, kv: dict, j: int, *,
                   heads: int, kv_heads: int, dh: int, window: int,
                   theta: float, mode: str, q_chunk: int = 0) -> Tensor:
    """x: (B, C, D); pos: (B, C) positions of the tokens (-1 = padding).
    ``kv`` is the cache entry: ``k``/``v`` with this layer at index ``j``
    of their first axis, and the entry's ``pos`` (B, L) as it stood before
    this dispatch (plus ``btab`` when paged).  Writes this layer's k/v in
    place and returns the attention output projected by ``wo``."""
    xn = rmsnorm(p["norm"], x)
    q, k, v = _qkv(p, xn, xn, heads, kv_heads, dh)
    q = rope(q, pos, theta)
    k = rope(k, pos, theta)
    paged = "btab" in kv
    kbuf, vbuf = kv["k"][j], kv["v"][j]
    if mode == "chunk":
        old_k = cache_lib.paged_gather(kbuf, kv["btab"]) if paged else kbuf
        old_v = cache_lib.paged_gather(vbuf, kv["btab"]) if paged else vbuf
        keys = torch.cat([old_k, k], dim=1)
        vals = torch.cat([old_v, v], dim=1)
        k_pos = torch.cat([kv["pos"], pos], dim=1)
        out = attention(q, keys, vals, pos, k_pos, window=window,
                        causal=True, q_chunk=q_chunk)
        if paged:
            cache_lib.paged_scatter(kbuf, kv["btab"], k, pos)
            cache_lib.paged_scatter(vbuf, kv["btab"], v, pos)
        else:
            cache_lib.scatter_ring(kbuf, k, pos)
            cache_lib.scatter_ring(vbuf, v, pos)
    elif mode == "decode":
        pos2 = cache_lib.scatter_ring(kv["pos"].clone(), pos, pos)
        if paged:
            cache_lib.paged_scatter(kbuf, kv["btab"], k, pos)
            cache_lib.paged_scatter(vbuf, kv["btab"], v, pos)
            gk = cache_lib.paged_gather(kbuf, kv["btab"])
            gv = cache_lib.paged_gather(vbuf, kv["btab"])
        else:
            gk = cache_lib.scatter_ring(kbuf, k, pos)
            gv = cache_lib.scatter_ring(vbuf, v, pos)
        out = attention(q, gk, gv, pos, pos2, window=window, causal=True)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    B, C = x.shape[:2]
    out = out.reshape(B, C, heads * dh)
    # a bf16 cache under f32 weights gives a bf16 output: promote it, as
    # the reference's mixed-type product does
    return out.to(torch.promote_types(out.dtype, p["wo"].dtype)) @ p["wo"]


def apply_ffn(p, x: Tensor) -> Tensor:
    """Dense SwiGLU FFN with its residual."""
    return x + swiglu(p["ffn"], rmsnorm(p["fnorm"], x))
