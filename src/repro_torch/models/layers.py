"""Shared layers: initialisers, RMSNorm and the output projection.

Parameters are plain dicts of tensors with the reference's leaf names
(``scale``, ``wq`` ...), so converted reference weights drop straight in.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

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


def logits_for(h: torch.Tensor, unemb: torch.Tensor) -> torch.Tensor:
    return (h @ unemb).float()
