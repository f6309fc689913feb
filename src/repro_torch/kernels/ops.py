"""Kernel dispatch by tensor device: a CUDA tensor goes to the hand-written
kernel (which raises if it cannot run), a CPU tensor to the plain version,
any other device raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import KERNEL as FLASH_ATTENTION
from repro_torch.kernels.mlstm_chunk import KERNEL as MLSTM_CHUNK


def mlstm_chunk(q, k, v, li, lf, state, chunk: int = 256):
    """Chunkwise mLSTM over (B, H, S, dh) with carried (C, n, m) state."""
    if q.is_cuda:
        return MLSTM_CHUNK(q, k, v, li, lf, state, chunk=chunk)
    if q.device.type != "cpu":
        raise ValueError(f"mlstm_chunk: no path for device {q.device}")
    return ref.mlstm_chunk_ref(q, k, v, li, lf, state, chunk=chunk)


def attention(q, k, v, q_pos, k_pos, *, window: int = ref.GLOBAL_WINDOW,
              causal: bool = True, q_chunk: int = 0):
    """Masked GQA attention over explicit positions (see
    ``ref.attention_ref``).  ``q_chunk`` bounds the plain version's logits
    buffer; the kernel tiles the queries itself."""
    if q.is_cuda:
        # the kernel takes one dtype: an f32 query over a bf16 cache (f32
        # weights) is attended in f32, exactly upcast, and its output is
        # given v's dtype, as the plain version gives it
        dt = torch.promote_types(q.dtype, k.dtype)
        out = FLASH_ATTENTION(q.to(dt), k.to(dt), v.to(dt), q_pos, k_pos,
                              window=window, causal=causal)
        return out.to(v.dtype)
    if q.device.type != "cpu":
        raise ValueError(f"attention: no path for device {q.device}")
    return ref.attention_ref(q, k, v, q_pos, k_pos, window=window,
                             causal=causal, q_chunk=q_chunk)
