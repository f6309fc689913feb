"""Recurrent-state cache entries (xLSTM).

An entry serves one stack of ``count`` identical layers, with the layer
index first and the batch (slot) second, as in the reference.  The
attention KV rings and the paged pool are not ported yet.
"""
from __future__ import annotations

import torch


def mlstm_entry(count, batch, heads, dh, dtype=torch.float32, device=None):
    return {
        "C": torch.zeros((count, batch, heads, dh, dh), dtype=dtype,
                         device=device),
        "n": torch.zeros((count, batch, heads, dh), dtype=dtype,
                         device=device),
        "m": torch.full((count, batch, heads), float("-inf"), dtype=dtype,
                        device=device),
    }


def slstm_entry(count, batch, heads, dh, dtype=torch.float32, device=None):
    shape = (count, batch, heads, dh)
    return {
        "c": torch.zeros(shape, dtype=dtype, device=device),
        "n": torch.zeros(shape, dtype=dtype, device=device),
        "h": torch.zeros(shape, dtype=dtype, device=device),
        "m": torch.full(shape, float("-inf"), dtype=dtype, device=device),
    }
