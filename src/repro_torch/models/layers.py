"""Shared layers: initialisers, RMSNorm, RoPE, attention, SwiGLU and the
output projection.

Parameters are plain dicts of tensors with the reference's leaf names
(``scale``, ``wq`` ...), so converted reference weights drop straight in.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GLOBAL_WINDOW
from repro_torch.kernels import ops

DEFAULT_DTYPE = torch.bfloat16


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype=DEFAULT_DTYPE, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal init with std ``scale`` or fan_in^-0.5, drawn in f32 on the
    generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def rmsnorm_init(d: int, dtype=DEFAULT_DTYPE, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Apply RoPE.  x: (B, T, H, dh); positions: (B, T) int."""
    dh = x.shape[-1]
    half = dh // 2
    freq_exp = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv_freq = torch.pow(theta, -freq_exp)                        # (half,)
    ang = positions.float()[..., None] * inv_freq                  # (B,T,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(q, k, v, q_pos, k_pos, *, window: int = GLOBAL_WINDOW,
              causal: bool = True, q_chunk: int = 0) -> torch.Tensor:
    """Exact masked attention over explicit positions (-1 = empty slot).
    The model's only attention: ``kernels.ops.attention`` sends a CUDA
    tensor to the flash-attention kernel and a CPU tensor to the plain
    version, which splits the queries into ``q_chunk`` chunks."""
    return ops.attention(q, k, v, q_pos, k_pos, window=window,
                         causal=causal, q_chunk=q_chunk)


def swiglu_init(gen: torch.Generator, d: int, f: int, dtype=DEFAULT_DTYPE
                ) -> dict:
    return {"w1": dense_init(gen, (d, f), dtype),
            "w3": dense_init(gen, (d, f), dtype),
            "w2": dense_init(gen, (f, d), dtype)}


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]


def logits_for(h: torch.Tensor, unemb: torch.Tensor) -> torch.Tensor:
    return (h @ unemb).float()
