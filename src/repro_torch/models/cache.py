"""Cache entries: attention KV rings, paged KV entries, recurrent states.

An entry serves one stack of ``count`` identical layers, with the layer
index first and the batch (slot) second, as in the reference.  KV entries
come in two layouts:

* **ring**: a per-slot buffer of ``cache_len_for(window, max_len)`` slots;
  position p lives at slot ``p % W``;
* **paged**: a physical pool of ``num_blocks`` blocks of ``block_size``
  tokens shared by all slots, plus a per-slot block table ``btab``
  (B, max_blocks) mapping logical block -> physical block (-1 =
  unleased).  Used for the entries whose dense form reserves the full
  ``max_len``.

``pos`` (B, L) holds each slot's token positions (-1 = empty), so
attention masks always come from true positions.  ``pos`` and ``btab``
belong to the entry, not to a layer: every layer of the entry reads the
same ones, and the model updates ``pos`` once per dispatch.

Writes are masked per-token scatters: tokens with ``q_pos < 0``, and, for
paged entries, tokens whose logical block is unleased, are dropped, so a
serving batch can mix prefill chunks, decode tokens and idle slots.  Unlike
the reference, which returns new arrays, the writes here update the buffer
in place (a full-width pool is tens of MB per layer).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import GLOBAL_WINDOW

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PageSpec:
    """Paged-pool geometry: ``num_blocks`` physical blocks of
    ``block_size`` tokens shared by all slots of an entry."""

    block_size: int
    num_blocks: int


def logical_blocks(max_len: int, block_size: int) -> int:
    """Block-table width of a paged entry: ceil(max_len / block_size)."""
    return -(-max_len // block_size)


def kv_entry(count, batch, cache_len, kv_heads, head_dim,
             dtype=torch.bfloat16, device=None) -> Dict[str, Tensor]:
    shape = (count, batch, cache_len, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                              device=device)}


def paged_kv_entry(count, num_blocks, block_size, batch, max_len, kv_heads,
                   head_dim, dtype=torch.bfloat16, device=None
                   ) -> Dict[str, Tensor]:
    """A paged KV entry: shared physical pool + per-slot block table."""
    M = logical_blocks(max_len, block_size)
    shape = (count, num_blocks, block_size, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, M * block_size), -1, dtype=torch.int32,
                              device=device),
            "btab": torch.full((batch, M), -1, dtype=torch.int32,
                               device=device)}


def cache_len_for(window: int, max_len: int) -> int:
    if window >= GLOBAL_WINDOW or window <= 0:
        return max_len
    return min(window, max_len)


# --- rings -----------------------------------------------------------------

def ring_indices(q_pos: Tensor, W: int) -> Tensor:
    """Per-token ring write index for chunk positions ``q_pos`` (B, C):
    ``p % W`` for tokens that survive (valid and within the chunk's last
    ``W`` positions; older ones would be overwritten by the same chunk),
    ``W`` (out of range => dropped) otherwise."""
    valid = q_pos >= 0
    last = torch.where(valid, q_pos, -1).amax(dim=1, keepdim=True)
    keep = valid & (q_pos > last - W)
    return torch.where(keep, q_pos % W, W)


def _masked_put(flat: Tensor, tgt: Tensor, keep: Tensor, new: Tensor
                ) -> None:
    """``flat[tgt] = new`` for the tokens where ``keep``, in place.

    flat: (R, ...); tgt, keep: (B, C); new: (B, C, ...).  Kept targets are
    distinct.  A dropped token rewrites the first kept token's row with
    that token's own value (or row 0 with its current value when nothing
    is kept), so the write needs no host round trip to count the kept
    tokens and its result does not depend on the order of the writes."""
    keep = keep.reshape(-1)
    tgt = tgt.reshape(-1).long()
    vals = new.reshape((-1,) + tuple(flat.shape[1:])).to(flat.dtype)
    # (1,)-shaped indices: indexing with a 0-d tensor would read it back
    first = torch.argmax(keep.int()).view(1)  # 0 when nothing is kept
    some = keep.any()
    fb_tgt = torch.where(some, tgt.index_select(0, first), 0)
    fb_val = torch.where(some, vals.index_select(0, first), flat[:1])
    shape = (-1,) + (1,) * (vals.dim() - 1)
    flat[torch.where(keep, tgt, fb_tgt)] = torch.where(
        keep.view(shape), vals, fb_val)


def scatter_ring(buf: Tensor, new: Tensor, q_pos: Tensor) -> Tensor:
    """Masked per-token scatter of ``new`` (B, C, ...) into ring ``buf``
    (B, W, ...), in place: the token at position p lands at slot ``p % W``;
    tokens with ``q_pos < 0`` are dropped.  Returns ``buf``."""
    B, W = buf.shape[:2]
    idx = ring_indices(q_pos, W)
    rows = torch.arange(B, device=buf.device)[:, None] * W
    _masked_put(buf.view((B * W,) + tuple(buf.shape[2:])), rows + idx,
                idx < W, new)
    return buf


# --- paged entries -------------------------------------------------------------

def paged_gather(buf: Tensor, btab: Tensor) -> Tensor:
    """Materialise the logical per-slot view of a paged pool.

    buf: (num_blocks, bs, H, dh), one layer's physical pool; btab: (B, M).
    Returns (B, M * bs, H, dh) where logical position p of slot b lives at
    index p; unleased blocks read as zeros (their ``pos`` is -1, so
    attention masks them out)."""
    N, bs = buf.shape[:2]
    flat = buf.reshape((N * bs,) + tuple(buf.shape[2:]))
    leased = btab >= 0
    base = torch.where(leased, btab, 0).long() * bs
    idx = (base[:, :, None] + torch.arange(bs, device=buf.device)
           ).reshape(btab.shape[0], -1)
    out = flat[idx]
    keep = leased.repeat_interleave(bs, dim=1)
    return out.masked_fill_(~keep[:, :, None, None], 0)


def paged_scatter(buf: Tensor, btab: Tensor, new: Tensor, q_pos: Tensor
                  ) -> Tensor:
    """Write chunk tokens into the physical pool through the block table,
    in place.

    buf: (num_blocks, bs, H, dh); btab: (B, M); new: (B, C, H, dh); q_pos:
    (B, C) logical positions (-1 = padding).  Tokens whose position is
    invalid or whose logical block is unleased are dropped: they can never
    land in another slot's blocks.  Returns ``buf``."""
    N, bs = buf.shape[:2]
    valid = q_pos >= 0
    lb = torch.where(valid, q_pos // bs, 0).long()
    blk = torch.gather(btab, 1, lb)                             # (B, C)
    _masked_put(buf.view((N * bs,) + tuple(buf.shape[2:])),
                blk.long() * bs + q_pos % bs, valid & (blk >= 0), new)
    return buf


# --- recurrent-state entries (xLSTM) ---------------------------------------

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
