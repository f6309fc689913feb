"""What both kernel wrappers do around a launch: check the tensors they are
given and find the stream to launch on, at little host cost (a one-token
decode step launches in a few microseconds of device time, so the
wrapper's Python is most of a call)."""
from __future__ import annotations

import contextlib

import torch


def _reject(kernel: str, name: str, t, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{kernel}: {name} must be on {device} (a CUDA "
                         f"device), got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


def check_tensors(kernel: str, device, specs) -> None:
    """Raise unless every (name, tensor, shape, dtype) of ``specs`` lies on
    ``device``, a CUDA device, with that shape and dtype, contiguous and
    16-byte aligned."""
    if device.type != "cuda":
        raise ValueError(f"{kernel}: inputs must be on a CUDA device, got "
                         f"{device}")
    index = device.index
    for name, t, shape, dtype in specs:
        if (t.get_device() != index or t.dtype != dtype or t.shape != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            _reject(kernel, name, t, shape, dtype, device)


def on_device(device):
    """A context in which ``device`` (with an index, as a tensor's device
    has) is the current CUDA device, a no-op when it already is, and the
    raw handle of its current stream."""
    index = device.index
    if index == torch.cuda.current_device():
        ctx = contextlib.nullcontext()
    else:
        ctx = torch.cuda.device(device)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return ctx, raw(index)
    return ctx, torch.cuda.current_stream(device).cuda_stream
