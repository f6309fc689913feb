"""Kernel dispatch by tensor device: a CUDA tensor goes to the hand-written
kernel (which raises if it cannot run), a CPU tensor to the plain version."""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.mlstm_chunk import KERNEL as MLSTM_CHUNK


def mlstm_chunk(q, k, v, li, lf, state, chunk: int = 256):
    """Chunkwise mLSTM over (B, H, S, dh) with carried (C, n, m) state."""
    if q.is_cuda:
        return MLSTM_CHUNK(q, k, v, li, lf, state, chunk=chunk)
    if q.device.type != "cpu":
        raise ValueError(f"mlstm_chunk: no path for device {q.device}")
    return ref.mlstm_chunk_ref(q, k, v, li, lf, state, chunk=chunk)
