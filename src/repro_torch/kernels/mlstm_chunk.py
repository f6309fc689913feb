"""Chunkwise-parallel mLSTM forward as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/mlstm_chunk.py::mlstm_chunk``
and adds the carried (C, n, m) state input that serving needs.  The source
is ``csrc/mlstm_chunk.cu``; its header states the layout and the bound.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use (``build.build_library``) and called
through ``ctypes``.

The plain version of the same function is ``ref.mlstm_chunk_ref``.
``ops.mlstm_chunk`` sends CPU tensors there; this wrapper takes CUDA
tensors only and raises on anything it cannot launch.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels.build import CSRC, build_library
from repro_torch.kernels.ref import chunk_len

SOURCE = CSRC / "mlstm_chunk.cu"


class MlstmChunkKernel:
    """Callable wrapper around the CUDA kernel.

    ``launches`` counts the kernel launches this wrapper made, and
    ``by_shape`` splits them by (batch, sequence length) of the call."""

    def __init__(self):
        self.launches = 0
        self.by_shape: collections.Counter = collections.Counter()
        self.build_log = ""
        self._lib = None

    def reset_counts(self) -> None:
        self.launches = 0
        self.by_shape.clear()

    def load(self):
        if self._lib is None:
            path, self.build_log = build_library(SOURCE)
            lib = ctypes.CDLL(str(path))
            lib.mlstm_chunk_fwd.argtypes = (
                [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_void_p])
            lib.mlstm_chunk_fwd.restype = ctypes.c_int
            lib.mlstm_chunk_smem_bytes.argtypes = [ctypes.c_int]
            lib.mlstm_chunk_smem_bytes.restype = ctypes.c_size_t
            self._lib = lib
        return self._lib

    def __call__(self, q, k, v, li, lf, state, chunk: int = 256):
        """q/k/v: (B, H, S, dh) f32; li/lf: (B, H, S) f32; state (C, n, m):
        (B,H,dh,dh), (B,H,dh), (B,H) f32.  Returns (h (B,H,S,dh),
        (C, n, m)) after the last chunk."""
        C, n, m = state
        if q.dim() != 4:
            raise ValueError(f"mlstm_chunk: q must be (B, H, S, dh), got "
                             f"{tuple(q.shape)}")
        B, H, S, dh = q.shape
        want = {"q": (q, (B, H, S, dh)), "k": (k, (B, H, S, dh)),
                "v": (v, (B, H, S, dh)), "li": (li, (B, H, S)),
                "lf": (lf, (B, H, S)), "C": (C, (B, H, dh, dh)),
                "n": (n, (B, H, dh)), "m": (m, (B, H))}
        for name, (t, shape) in want.items():
            if not t.is_cuda or t.device != q.device:
                raise ValueError(f"mlstm_chunk: {name} must be on {q.device} "
                                 f"(a CUDA device), got {t.device}")
            if t.dtype != torch.float32:
                raise TypeError(f"mlstm_chunk: {name} must be float32, got "
                                f"{t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"mlstm_chunk: {name} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            if not t.is_contiguous():
                raise ValueError(f"mlstm_chunk: {name} must be contiguous")
        if S < 1 or B * H > 65535:
            raise ValueError(f"mlstm_chunk: unsupported S={S}, B*H={B * H}")
        lib = self.load()
        L = chunk_len(S, chunk)
        # chunk-local cumulative log forget gate, as the Pallas wrapper does
        bc = torch.cumsum(lf.view(B, H, S // L, L), dim=-1).view(B, H, S)
        h = torch.empty_like(q)
        C_out, n_out, m_out = (torch.empty_like(C), torch.empty_like(n),
                               torch.empty_like(m))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.mlstm_chunk_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bc.data_ptr(),
                li.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
                h.data_ptr(), C_out.data_ptr(), n_out.data_ptr(),
                m_out.data_ptr(), B * H, S, L, dh, dh ** -0.5, stream)
        if err != 0:
            raise RuntimeError(
                f"mlstm_chunk: kernel launch failed with CUDA error {err} "
                f"(dh={dh} asks {lib.mlstm_chunk_smem_bytes(dh)} bytes of "
                f"shared memory)")
        self.launches += 1
        self.by_shape[(B, S)] += 1
        return h, (C_out, n_out, m_out)


KERNEL = MlstmChunkKernel()
