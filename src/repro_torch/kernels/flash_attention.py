"""Flash attention over explicit positions as a hand-written CUDA kernel for
Hopper.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` and takes what
serving needs beside it: query and key positions (-1 = empty slot), any
query and key length, and the block skip expressed in positions.  The
source is ``csrc/flash_attention.cu``; its header states the layout and
the bound.  It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (``build.build_library``)
and called through ``ctypes``.

The plain version of the same function is ``ref.attention_ref``.
``ops.attention`` sends CPU tensors there; this wrapper takes CUDA tensors
only and raises on anything it cannot launch.  Rows with q_pos < 0 are
padding: the kernel writes zeros there, where the plain version averages
the values; no caller reads them.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels.build import CSRC, build_library

SOURCE = CSRC / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)     # the instantiations in the source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class FlashAttentionKernel:
    """Callable wrapper around the CUDA kernel.

    ``launches`` counts the kernel launches this wrapper made, and
    ``by_shape`` splits them by (batch, query length, key length)."""

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
            lib.flash_attention_fwd.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                + [ctypes.c_float, ctypes.c_void_p])
            lib.flash_attention_fwd.restype = ctypes.c_int
            lib.flash_attention_workspace_bytes.argtypes = [ctypes.c_int] * 6
            lib.flash_attention_workspace_bytes.restype = ctypes.c_size_t
            lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int]
            lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
            self._lib = lib
        return self._lib

    def __call__(self, q, k, v, q_pos, k_pos, *, window: int,
                 causal: bool = True):
        """q: (B, Tq, Hq, dh); k/v: (B, Tk, Hkv, dh), all f32 or all bf16;
        q_pos (B, Tq), k_pos (B, Tk) int32.  Returns (B, Tq, Hq, dh) in
        q's dtype."""
        if q.dim() != 4 or k.dim() != 4:
            raise ValueError(f"flash_attention: q and k must be 4-d, got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}")
        B, Tq, Hq, dh = q.shape
        Tk, Hkv = k.shape[1], k.shape[2]
        want = {"q": (q, (B, Tq, Hq, dh), q.dtype),
                "k": (k, (B, Tk, Hkv, dh), q.dtype),
                "v": (v, (B, Tk, Hkv, dh), q.dtype),
                "q_pos": (q_pos, (B, Tq), torch.int32),
                "k_pos": (k_pos, (B, Tk), torch.int32)}
        for name, (t, shape, dtype) in want.items():
            if not t.is_cuda or t.device != q.device:
                raise ValueError(f"flash_attention: {name} must be on "
                                 f"{q.device} (a CUDA device), got {t.device}")
            if t.dtype != dtype:
                raise TypeError(f"flash_attention: {name} must be {dtype}, "
                                f"got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"flash_attention: {name} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            if not t.is_contiguous():
                raise ValueError(f"flash_attention: {name} must be "
                                 f"contiguous")
        if q.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: q must be float32 or "
                            f"bfloat16, got {q.dtype}")
        if dh not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head_dim {dh} not in "
                             f"{HEAD_DIMS}")
        if Hkv < 1 or Hq % Hkv or Hq > 65535 or B > 65535 or Tq < 1:
            raise ValueError(f"flash_attention: unsupported B={B}, Tq={Tq}, "
                             f"Hq={Hq}, Hkv={Hkv}")
        if not 1 <= window < 2 ** 31:
            raise ValueError(f"flash_attention: window {window} out of range")
        lib = self.load()
        out = torch.empty_like(q)
        # the decode layout's per-split (m, l, acc); empty for the others
        ws = lib.flash_attention_workspace_bytes(B, Tq, Tk, Hq, Hkv, dh)
        part = torch.empty((ws // 4,), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                k_pos.data_ptr(), out.data_ptr(), part.data_ptr(), B, Tq, Tk,
                Hq, Hkv, dh,
                _DTYPES[q.dtype], int(window), int(bool(causal)),
                dh ** -0.5, stream)
        if err != 0:
            raise RuntimeError(
                f"flash_attention: kernel launch failed with CUDA error "
                f"{err} (dh={dh} asks {lib.flash_attention_smem_bytes(dh)} "
                f"bytes of shared memory)")
        self.launches += 1
        self.by_shape[(B, Tq, Tk)] += 1
        return out


KERNEL = FlashAttentionKernel()
