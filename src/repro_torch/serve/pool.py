"""Host-side block pool for the paged KV cache.

A copy of the reference's pool (the port keeps its own).  The device side
(``repro_torch.models.cache``) stores paged entries as a
shared physical pool of fixed-size blocks plus a per-slot block table;
this module owns the *allocation policy* for that table.  One
``BlockPool`` serves every paged entry of an engine cache: entries
allocate in lockstep (a slot's logical block i maps to the same
physical block index in each entry's pool), so a single host table is
uploaded to all of them whenever it changes.

Two-level accounting keeps leasing deadlock-free:

* ``reserve(slot, tokens)`` — at admission, *commit* the worst-case
  block count for the request (prompt + max_new tokens).  Admission is
  refused (``can_reserve`` False) unless every active slot could still
  grow to its commitment, so ``ensure`` can never fail mid-flight.
* ``ensure(slot, length)`` — before each dispatch, *lease* just enough
  physical blocks to cover ``length`` tokens.  This is what actually
  consumes pool blocks: ``high_water`` tracks the peak leased count,
  which is the engine's true memory footprint (proportional to live
  tokens, not to ``slots * max_len`` as with dense rings).
"""
from __future__ import annotations

from typing import List

import numpy as np


class PoolExhausted(RuntimeError):
    """A lease was requested beyond the slot's admission commitment."""


class BlockPool:
    def __init__(self, num_blocks: int, block_size: int, slots: int,
                 max_len: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.slots = slots
        self.max_blocks_per_slot = -(-max_len // block_size)
        #: per-slot logical -> physical block map; -1 = unleased.  The
        #: engine uploads this to every paged cache entry when ``dirty``.
        self.table = np.full((slots, self.max_blocks_per_slot), -1, np.int32)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._leased = np.zeros((slots,), np.int32)
        self._commit = np.zeros((slots,), np.int32)
        self._committed = 0
        self.high_water = 0
        self.dirty = False

    # ------------------------------------------------------------- queries
    def blocks_for(self, tokens: int) -> int:
        return -(-max(tokens, 0) // self.block_size)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def committed(self) -> int:
        return self._committed

    def can_reserve(self, tokens: int) -> bool:
        """Could a request needing ``tokens`` cache lines be admitted now
        without risking mid-flight exhaustion?"""
        need = min(self.blocks_for(tokens), self.max_blocks_per_slot)
        return self._committed + need <= self.num_blocks

    # ------------------------------------------------------------ mutation
    def reserve(self, slot: int, tokens: int) -> None:
        """Commit slot's worst case (called once, at admission)."""
        if self._commit[slot]:
            raise ValueError(f"slot {slot} already reserved")
        need = min(self.blocks_for(tokens), self.max_blocks_per_slot)
        if self._committed + need > self.num_blocks:
            raise PoolExhausted(
                f"cannot commit {need} blocks: {self._committed}/"
                f"{self.num_blocks} already committed")
        self._commit[slot] = need
        self._committed += need

    def ensure(self, slot: int, length: int) -> None:
        """Lease blocks so slot can hold ``length`` tokens."""
        need = self.blocks_for(length)
        if need > self._commit[slot]:
            raise PoolExhausted(
                f"slot {slot} needs {need} blocks but committed only "
                f"{int(self._commit[slot])} at admission")
        while self._leased[slot] < need:
            blk = self._free.pop()      # cannot fail: leases <= commits
            self.table[slot, self._leased[slot]] = blk
            self._leased[slot] += 1
            self.dirty = True
        self.high_water = max(self.high_water, self.used_blocks)

    def release(self, slot: int) -> None:
        """Return slot's blocks to the pool and drop its commitment."""
        for i in range(int(self._leased[slot])):
            self._free.append(int(self.table[slot, i]))
        if self._leased[slot]:
            self.dirty = True
        self.table[slot, :] = -1
        self._leased[slot] = 0
        self._committed -= int(self._commit[slot])
        self._commit[slot] = 0
