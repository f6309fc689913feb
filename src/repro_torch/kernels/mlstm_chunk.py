"""Chunkwise-parallel mLSTM forward as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/mlstm_chunk.py::mlstm_chunk``
and adds the carried (C, n, m) state input that serving needs.  The source
is ``csrc/mlstm_chunk.cu``; its header states the layout and the bound.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use (``build.build_library``) and called
through ``ctypes``.  A call of one step (S = 1) takes the one-step layout,
a longer one the chunk-parallel layout (states, then outputs); the
library's ``mlstm_chunk_layout`` says which, and ``last_layout`` and
``by_layout`` record it.

The plain version of the same function is ``ref.mlstm_chunk_ref``.
``ops.mlstm_chunk`` sends CPU tensors there; this wrapper takes CUDA
tensors only and raises on anything it cannot launch.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels.build import CSRC, build_library
from repro_torch.kernels.common import check_tensors, on_device
from repro_torch.kernels.ref import chunk_len

SOURCE = CSRC / "mlstm_chunk.cu"
LAYOUTS = {1: "one_step", 2: "chunk_parallel"}   # mlstm_chunk_layout's codes
MAX_HEAD_DIM = 256


class MlstmChunkKernel:
    """Callable wrapper around the CUDA kernel.

    ``launches`` counts the kernel launches this wrapper made (one for each
    call, whatever number of kernels its layout runs), ``by_shape`` splits
    them by (batch, sequence length) of the call and ``by_layout`` by
    layout; ``last_layout`` is the layout of the last call."""

    def __init__(self):
        self.launches = 0
        self.by_shape: collections.Counter = collections.Counter()
        self.by_layout: collections.Counter = collections.Counter()
        self.last_layout = ""
        self.build_log = ""
        self._lib = None
        self._plans = {}     # sizes and chunk -> (L, layout, workspace bytes)

    def reset_counts(self) -> None:
        self.launches = 0
        self.by_shape.clear()
        self.by_layout.clear()

    def load(self):
        if self._lib is None:
            path, self.build_log = build_library(SOURCE)
            lib = ctypes.CDLL(str(path))
            lib.mlstm_chunk_fwd.argtypes = (
                [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_void_p])
            lib.mlstm_chunk_fwd.restype = ctypes.c_int
            lib.mlstm_chunk_smem_bytes.argtypes = []
            lib.mlstm_chunk_smem_bytes.restype = ctypes.c_size_t
            lib.mlstm_chunk_workspace_bytes.argtypes = [ctypes.c_int] * 4
            lib.mlstm_chunk_workspace_bytes.restype = ctypes.c_size_t
            lib.mlstm_chunk_layout.argtypes = [ctypes.c_int]
            lib.mlstm_chunk_layout.restype = ctypes.c_int
            lib.mlstm_chunk_init.restype = ctypes.c_int
            err = lib.mlstm_chunk_init()
            if err != 0:
                raise RuntimeError(f"mlstm_chunk: setting the shared-memory "
                                   f"limit failed with CUDA error {err}")
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
        f32, dev = torch.float32, q.device
        check_tensors("mlstm_chunk", dev, (
            ("q", q, (B, H, S, dh), f32), ("k", k, (B, H, S, dh), f32),
            ("v", v, (B, H, S, dh), f32), ("li", li, (B, H, S), f32),
            ("lf", lf, (B, H, S), f32), ("C", C, (B, H, dh, dh), f32),
            ("n", n, (B, H, dh), f32), ("m", m, (B, H), f32)))
        if S < 1 or B * H > 65535:
            raise ValueError(f"mlstm_chunk: unsupported S={S}, B*H={B * H}")
        if dh % 4 or not 4 <= dh <= MAX_HEAD_DIM:
            raise ValueError(f"mlstm_chunk: head_dim {dh} must be a multiple "
                             f"of 4 in [4, {MAX_HEAD_DIM}]")
        lib = self.load()
        key = (B * H, S, dh, chunk)
        plan = self._plans.get(key)
        if plan is None:       # chunk length, layout, workspace bytes
            L = chunk_len(S, chunk)
            plan = self._plans[key] = (
                L, LAYOUTS[lib.mlstm_chunk_layout(S)],
                lib.mlstm_chunk_workspace_bytes(B * H, S, L, dh))
        L, layout, ws_bytes = plan
        # chunk-local cumulative log forget gate, as the Pallas wrapper does;
        # over chunks of one step it is lf itself
        bc = lf if L == 1 else torch.cumsum(
            lf.view(B, H, S // L, L), dim=-1).view(B, H, S)
        h = torch.empty_like(q)
        C_out, n_out, m_out = (torch.empty_like(C), torch.empty_like(n),
                               torch.empty_like(m))
        # the states entering chunks 1.. (chunk-parallel layout)
        ws = (torch.empty((ws_bytes // 4,), dtype=f32, device=dev)
              if ws_bytes else None)
        ctx, stream = on_device(dev)
        with ctx:
            err = lib.mlstm_chunk_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bc.data_ptr(),
                li.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
                h.data_ptr(), C_out.data_ptr(), n_out.data_ptr(),
                m_out.data_ptr(), None if ws is None else ws.data_ptr(),
                B * H, S, L, dh, dh ** -0.5, stream)
        if err != 0:
            raise RuntimeError(
                f"mlstm_chunk: kernel launch failed with CUDA error {err} "
                f"(dh={dh}; the outputs kernel asks "
                f"{lib.mlstm_chunk_smem_bytes()} bytes of shared memory)")
        self.last_layout = layout
        self.launches += 1
        self.by_shape[(B, S)] += 1
        self.by_layout[layout] += 1
        return h, (C_out, n_out, m_out)

KERNEL = MlstmChunkKernel()
