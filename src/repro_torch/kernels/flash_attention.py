"""Flash attention over explicit positions as a hand-written CUDA kernel for
Hopper.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` and takes what
serving needs beside it: query and key positions (-1 = empty slot), any
query and key length, and the block skip expressed in positions.  The
source is ``csrc/flash_attention.cu``; its header states the layout and
the bound.  It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use (``build.build_library``)
and called through ``ctypes``.  Which of its three layouts a call takes
(``decode`` for Tq = 1, ``wgmma`` for bf16 at dh 64, 128 or 256, else
``fma``) is the library's ``flash_attention_layout``; ``last_layout`` and
``by_layout`` record it.

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
from repro_torch.kernels.common import check_tensors, on_device

SOURCE = CSRC / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)     # the instantiations in the source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAYOUTS = {1: "fma", 2: "wgmma", 3: "decode"}  # flash_attention_layout's codes


class FlashAttentionKernel:
    """Callable wrapper around the CUDA kernel.

    ``launches`` counts the kernel launches this wrapper made (one for each
    call), ``by_shape`` splits them by (batch, query length, key length)
    and ``by_layout`` by layout; ``last_layout`` is the last call's."""

    def __init__(self):
        self.launches = 0
        self.by_shape: collections.Counter = collections.Counter()
        self.by_layout: collections.Counter = collections.Counter()
        self.last_layout = ""
        self.build_log = ""
        self._lib = None
        self._plans = {}     # inputs' sizes -> (layout, workspace bytes)

    def reset_counts(self) -> None:
        self.launches = 0
        self.by_shape.clear()
        self.by_layout.clear()

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
            lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
            lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
            lib.flash_attention_layout.argtypes = [ctypes.c_int] * 5
            lib.flash_attention_layout.restype = ctypes.c_int
            lib.flash_attention_init.restype = ctypes.c_int
            err = lib.flash_attention_init()
            if err != 0:
                raise RuntimeError(f"flash_attention: initialising the "
                                   f"kernels failed with CUDA error {err}")
            self._lib = lib
        return self._lib

    def layout(self, dtype, dh: int, Tq: int, Hq: int, Hkv: int) -> str:
        """The layout a call of these inputs takes."""
        return LAYOUTS[self.load().flash_attention_layout(
            _DTYPES[dtype], dh, Tq, Hq, Hkv)]

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
        dev = q.device
        check_tensors("flash_attention", dev, (
            ("q", q, (B, Tq, Hq, dh), q.dtype),
            ("k", k, (B, Tk, Hkv, dh), q.dtype),
            ("v", v, (B, Tk, Hkv, dh), q.dtype),
            ("q_pos", q_pos, (B, Tq), torch.int32),
            ("k_pos", k_pos, (B, Tk), torch.int32)))
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
        code = _DTYPES[q.dtype]
        key = (code, B, Tq, Tk, Hq, Hkv, dh)
        plan = self._plans.get(key)
        if plan is None:       # the layout, and the decode layout's scratch
            plan = self._plans[key] = (
                LAYOUTS[lib.flash_attention_layout(code, dh, Tq, Hq, Hkv)],
                lib.flash_attention_workspace_bytes(B, Tq, Tk, Hq, Hkv, dh))
        layout, ws = plan
        out = torch.empty_like(q)
        # the decode layout's per-split (m, l, acc)
        part = (torch.empty((ws // 4,), dtype=torch.float32, device=dev)
                if ws else None)
        ctx, stream = on_device(dev)
        with ctx:
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                k_pos.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(), B, Tq, Tk, Hq,
                Hkv, dh, code, int(window), int(bool(causal)), dh ** -0.5,
                stream)
        if err != 0:
            smem = lib.flash_attention_smem_bytes(code, dh, Tq, Hq, Hkv)
            raise RuntimeError(
                f"flash_attention: kernel launch failed with CUDA error "
                f"{err} (the {layout} layout at dh={dh} asks {smem} bytes "
                f"of shared memory)")
        self.last_layout = layout
        self.launches += 1
        self.by_shape[(B, Tq, Tk)] += 1
        self.by_layout[layout] += 1
        return out

KERNEL = FlashAttentionKernel()
