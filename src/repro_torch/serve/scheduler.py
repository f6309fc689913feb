"""Continuous-batching scheduler: decode-tick planning and admission.

A copy of the reference scheduler's host-side bookkeeping (the port keeps
its own), cut to what the legacy cache mode uses: the engine prefills each
prompt at admission, so every tick is one decode token for each slot that
still generates, and idle rows have ``lengths == 0``.  The reference's
chunk ticks and their policies wait for the paged/dense modes (ROADMAP.md).

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
    def decode_ready(self) -> bool:
        return (not self.done and self.fed >= self.prompt_len
                and self.sampled < self.cap)


@dataclasses.dataclass
class TickPlan:
    """One decode dispatch over every slot; each sampling row reads its
    input token from the engine's device next-token buffer."""

    starts: np.ndarray              # (B,) int32
    lengths: np.ndarray             # (B,) int32 (0 = idle row, else 1)
    samples: List[Tuple[int, int, int]]  # (slot, epoch, gen_index)


class Scheduler:
    def __init__(self, slots: int):
        self.n_slots = slots
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

    def plan(self) -> Optional[TickPlan]:
        """Plan the next decode tick, advancing ``fed``/``sampled`` as if
        it were already dispatched (the engine dispatches it next)."""
        decode = [(i, s) for i, s in self.active() if s.decode_ready]
        if not decode:
            return None
        starts = np.zeros((self.n_slots,), np.int32)
        lengths = np.zeros((self.n_slots,), np.int32)
        samples: List[Tuple[int, int, int]] = []
        for i, s in decode:
            starts[i] = s.fed
            lengths[i] = 1
            samples.append((i, s.epoch, s.sampled))
            s.fed += 1
            s.sampled += 1
        return TickPlan(starts, lengths, samples)


def agree_admission_count(n: int) -> int:
    """Fleet-wide admission agreement: the minimum of every rank's
    proposal.  The port serves on one rank, where it is the identity; the
    multi-rank round waits for the port's Communicator (ROADMAP.md queue A,
    item 4)."""
    return n
