"""Recurrent blocks of xLSTM: mLSTM (chunkwise-parallel) and sLSTM.

The mLSTM chunk loop goes through ``kernels.ops.mlstm_chunk``: the CUDA
kernel on the card, the plain chunk loop on the CPU.  Both compute what
the reference's ``lax.scan`` over ``_mlstm_chunk`` computes.  sLSTM has
no parallel form (xLSTM paper §2.3) and no TPU kernel: it is a loop over
time steps here, as ``lax.scan`` is in the reference.  The reference's
selective SSM (Hymba) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init

Tensor = torch.Tensor
_GATES = ("z", "i", "f", "o")


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_init(gen: torch.Generator, d_model: int, heads: int, dh: int,
               dtype=torch.bfloat16) -> Dict[str, object]:
    q_dim = heads * dh
    dev = gen.device
    return {
        "norm": rmsnorm_init(d_model, dtype, dev),
        "wq": dense_init(gen, (d_model, q_dim), dtype),
        "wk": dense_init(gen, (d_model, q_dim), dtype),
        "wv": dense_init(gen, (d_model, q_dim), dtype),
        "wi": dense_init(gen, (d_model, heads), torch.float32),
        "wf": dense_init(gen, (d_model, heads), torch.float32),
        "wg": dense_init(gen, (d_model, q_dim), dtype),
        "wo": dense_init(gen, (q_dim, d_model), dtype),
        "onorm": rmsnorm_init(q_dim, dtype, dev),
    }


def mlstm_zero_state(B: int, heads: int, dh: int, device) -> tuple:
    return (torch.zeros((B, heads, dh, dh), device=device),
            torch.zeros((B, heads, dh), device=device),
            torch.full((B, heads), float("-inf"), device=device))


def mlstm_forward(params, x: Tensor, state: Optional[tuple], *, heads: int,
                  dh: int, chunk: int = 256, compute_dtype=torch.float32
                  ) -> Tuple[Tensor, tuple]:
    """Full mLSTM block.  x: (B, S, D); state: (C, n, m) or None (=> zeros,
    m = -inf).  Returns (residual output (B, S, D), new state)."""
    B, S, D = x.shape
    xn = rmsnorm(params["norm"], x)

    def heads_first(w):
        y = (xn @ w).view(B, S, heads, dh).transpose(1, 2)
        return y.to(compute_dtype).contiguous()

    q, k, v = heads_first(params["wq"]), heads_first(params["wk"]), \
        heads_first(params["wv"])
    xf = xn.float()
    li = (xf @ params["wi"]).transpose(1, 2).contiguous()           # (B,H,S)
    lf = F.logsigmoid(xf @ params["wf"]).transpose(1, 2).contiguous()
    if state is None:
        state = mlstm_zero_state(B, heads, dh, x.device)
    h, state = ops.mlstm_chunk(q, k, v, li, lf, state, chunk=chunk)
    h = h.transpose(1, 2).reshape(B, S, heads * dh).to(x.dtype)
    h = rmsnorm(params["onorm"], h)
    gate = torch.sigmoid((xn @ params["wg"]).float())
    y = (h.float() * gate).to(x.dtype) @ params["wo"]
    return x + y, state


def mlstm_sequential(params, x, state, *, heads, dh):
    """Step-by-step oracle for tests (identical math, L=1 chunks)."""
    return mlstm_forward(params, x, state, heads=heads, dh=dh, chunk=1)


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_init(gen: torch.Generator, d_model: int, heads: int, dh: int,
               dtype=torch.bfloat16) -> Dict[str, object]:
    q_dim = heads * dh
    p: Dict[str, object] = {"norm": rmsnorm_init(d_model, dtype, gen.device)}
    for g in _GATES:
        p[f"w{g}"] = dense_init(gen, (d_model, q_dim), torch.float32)
    for g in _GATES:
        p[f"r{g}"] = dense_init(gen, (heads, dh, dh), torch.float32,
                                scale=dh ** -0.5)
    p["wo_out"] = dense_init(gen, (q_dim, d_model), dtype)
    p["onorm"] = rmsnorm_init(q_dim, dtype, gen.device)
    return p


def slstm_zero_state(B: int, heads: int, dh: int, device) -> tuple:
    z = torch.zeros((B, heads, dh), device=device)
    return (z, z.clone(), z.clone(),
            torch.full((B, heads, dh), float("-inf"), device=device))


def slstm_forward(params, x: Tensor, state: Optional[tuple], *, heads: int,
                  dh: int, compute_dtype=torch.float32
                  ) -> Tuple[Tensor, tuple]:
    """sLSTM block: exponential-gated LSTM with per-head recurrent mixing,
    one time step at a time.  x: (B, S, D); state (c, n, h, m) each
    (B, H, dh) or None.  Returns (residual output, new state)."""
    B, S, D = x.shape
    xn = rmsnorm(params["norm"], x).float()
    # input projections of all four gates at once: (S, H, B, 4*dh)
    w_all = torch.cat([params[f"w{g}"] for g in _GATES], dim=1)
    pre = (xn @ w_all).view(B, S, 4, heads, dh).permute(1, 3, 0, 2, 4) \
        .reshape(S, heads, B, 4 * dh)
    # recurrent weights of the four gates side by side: (H, dh, 4*dh)
    rec_w = torch.cat([params[f"r{g}"] for g in _GATES], dim=2) \
        .to(compute_dtype)
    if state is None:
        state = slstm_zero_state(B, heads, dh, x.device)
    c, n, h, m = (t.transpose(0, 1) for t in state)         # (H, B, dh)
    hs = torch.empty((S, heads, B, dh), device=x.device)
    for t in range(S):
        rec = torch.bmm(h.to(compute_dtype), rec_w).float()  # (H, B, 4*dh)
        a = pre[t] + rec
        zx, ix, fx, ox = a.split(dh, dim=-1)
        z = torch.tanh(zx)
        li = ix                                            # log input gate
        lf = F.logsigmoid(fx)                              # log forget gate
        o = torch.sigmoid(ox)
        m2 = torch.maximum(lf + m, li)
        ig = torch.exp(li - m2)
        fg = torch.exp(lf + m - m2)
        c = fg * c + ig * z
        n = fg * n + ig
        h = o * c / torch.clamp(n, min=1e-6)
        m = m2
        hs[t] = h
    new_state = tuple(s.transpose(0, 1) for s in (c, n, h, m))
    y = hs.permute(2, 0, 1, 3).reshape(B, S, heads * dh).to(x.dtype)
    y = rmsnorm(params["onorm"], y)
    return x + y @ params["wo_out"], new_state
