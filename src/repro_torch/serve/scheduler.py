"""Continuous-batching scheduler: tick planning and admission.

A copy of the reference scheduler's host-side bookkeeping (the port keeps
its own).  A tick is one dispatch over the whole slot batch in which each
row carries a prefill chunk, one decode token, or nothing (idle rows have
``lengths == 0``).  Two tick policies:

* ``conservative`` (default): prefill chunks and decode tokens never share
  a dispatch.  Chunk ticks run at the fixed width ``chunk`` while decode
  rows idle; decode ticks are width 1.  Every slot sees the computation
  it would see alone in the batch, so greedy output is the same solo and
  batched.
* ``mixed``: decode rows join chunk ticks as single-token rows whose token
  the engine takes from its device next-token buffer.

In the engine's legacy mode a prompt is prefilled at admission (``fed`` is
the prompt), so only decode ticks are planned.

``fed`` counts tokens written into the cache, ``sampled`` generated tokens
whose sampling was dispatched, ``recorded`` generated tokens the host has
seen; ``epoch`` guards slot reuse against a tick planned before a release.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SlotState:
    rid: int
    prompt: np.ndarray
    cap: int                       # generated-token budget (>= 1)
    temperature: float
    eos_id: Optional[int]
    epoch: int
    fed: int = 0                   # tokens written into the cache
    sampled: int = 0               # generated tokens dispatched
    recorded: int = 0              # generated tokens seen by the host
    done: bool = False             # no further ticks (EOS or cap)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefilling(self) -> bool:
        return self.fed < self.prompt_len

    @property
    def decode_ready(self) -> bool:
        return (not self.done and not self.prefilling
                and self.sampled < self.cap)


@dataclasses.dataclass
class TickPlan:
    """One dispatch: (B, width) token rows + which rows sample."""

    kind: str                       # "chunk" | "decode"
    width: int
    tokens: np.ndarray              # (B, width) int32 host tokens
    use_next: np.ndarray            # (B,) bool: the row's first token comes
                                    # from the device next-token buffer
    starts: np.ndarray              # (B,) int32
    lengths: np.ndarray             # (B,) int32 (0 = idle row)
    samples: List[Tuple[int, int, int]]  # (slot, epoch, gen_index)


class Scheduler:
    def __init__(self, slots: int, chunk: int, policy: str = "conservative"):
        if policy not in ("conservative", "mixed"):
            raise ValueError(f"unknown tick policy {policy!r}")
        self.n_slots = slots
        self.chunk = max(int(chunk), 1)
        self.policy = policy
        self.states: List[Optional[SlotState]] = [None] * slots
        self._epoch = 0

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.states) if s is None]

    def active(self) -> List[Tuple[int, SlotState]]:
        return [(i, s) for i, s in enumerate(self.states) if s is not None]

    def assign(self, slot: int, rid: int, prompt: np.ndarray, cap: int,
               temperature: float, eos_id: Optional[int]) -> SlotState:
        if self.states[slot] is not None:
            raise ValueError(f"slot {slot} is busy")
        self._epoch += 1
        st = SlotState(rid=rid, prompt=prompt.astype(np.int32), cap=cap,
                       temperature=temperature, eos_id=eos_id,
                       epoch=self._epoch)
        self.states[slot] = st
        return st

    def release(self, slot: int) -> None:
        self.states[slot] = None

    def has_work(self) -> bool:
        return any(s is not None and (s.prefilling or s.decode_ready)
                   for s in self.states)

    def plan(self) -> Optional[TickPlan]:
        """Plan the next tick, advancing ``fed``/``sampled`` as if it were
        already dispatched (the engine dispatches it next)."""
        B = self.n_slots
        prefill = [(i, s) for i, s in self.active() if s.prefilling]
        decode = [(i, s) for i, s in self.active() if s.decode_ready]
        if not prefill and not decode:
            return None
        C = self.chunk if prefill else 1
        tokens = np.zeros((B, C), np.int32)
        starts = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        use_next = np.zeros((B,), bool)
        samples: List[Tuple[int, int, int]] = []
        for i, s in prefill:
            n = min(C, s.prompt_len - s.fed)
            tokens[i, :n] = s.prompt[s.fed:s.fed + n]
            starts[i] = s.fed
            lengths[i] = n
            s.fed += n
            if not s.prefilling:            # this chunk samples token 0
                samples.append((i, s.epoch, 0))
                s.sampled = 1
        if not prefill or self.policy == "mixed":
            for i, s in decode:
                starts[i] = s.fed
                lengths[i] = 1
                use_next[i] = True
                samples.append((i, s.epoch, s.sampled))
                s.fed += 1
                s.sampled += 1
        return TickPlan("chunk" if prefill else "decode", C, tokens,
                        use_next, starts, lengths, samples)


def agree_admission_count(n: int) -> int:
    """Fleet-wide admission agreement: the minimum of every rank's
    proposal.  The port serves on one rank, where it is the identity; the
    multi-rank round waits for the port's Communicator (ROADMAP.md queue A,
    item 4)."""
    return n
