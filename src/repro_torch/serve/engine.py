"""Serving engine: continuous batching over a KV cache or recurrent slots.

The port of the reference engine (see its ``serve/README.md``).  Requests
are admitted into free slots between ticks; each tick is one dispatch
(``Model.serve_step`` then batched sampling) planned by
:class:`~repro_torch.serve.scheduler.Scheduler`, and the loop dispatches
tick t+1 before it reads tick t's sampled tokens back, so host bookkeeping
overlaps the device.  Decode rows read their input token from a
device-resident next-token buffer.

Cache modes:

* ``paged``: batched prefill in chunk ticks, with the full-length KV
  entries in a pool of fixed-size blocks that slots lease on demand
  (:class:`~repro_torch.serve.pool.BlockPool`); windowed entries stay
  rings.  The default for attention-only architectures.
* ``dense``: the same batched path over rings only (the equivalence
  reference for ``paged``).
* ``legacy``: each admitted request is prefilled alone at batch 1 (chunks
  of ``prefill_chunk`` tokens, then single tokens) and copied into its
  slot; decode ticks run every slot at once.  The only mode for recurrent
  architectures, where padded rows in a shared dispatch would advance a
  slot's state.

Load and drain barriers are no-ops on one rank.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import cache as cache_lib
from repro_torch.models.model import Model
from repro_torch.serve.pool import BlockPool
from repro_torch.serve.scheduler import (Scheduler, TickPlan,
                                         agree_admission_count)

_LOAD_MSG = "Engine.load() must be called before admission"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_id: Optional[int] = None  # stop token (detected one tick late)
    out_tokens: Optional[List[int]] = None


class ServeResult(dict):
    """``{rid: [tokens]}`` for completed requests, plus ``truncated`` (True
    when ``max_steps`` hit before the queue drained), ``unfinished``
    (``{rid: partial tokens}``) and ``metrics`` (``{rid: {arrival_s,
    ttft_s, done_s, tokens}}``, host-observed)."""

    def __init__(self, done, truncated: bool, unfinished, metrics):
        super().__init__(done)
        self.truncated = truncated
        self.unfinished = dict(unfinished)
        self.metrics = dict(metrics)


def _supports_batched(cfg: ArchConfig) -> bool:
    """Archs whose padded rows are inert in a shared prefill dispatch."""
    return not cfg.xlstm_pattern and cfg.family == "dense"


class Engine:
    def __init__(self, cfg: ArchConfig, slots: int, max_len: int,
                 seed: int = 0, cache_mode: str = "auto",
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 policy: str = "conservative", device="cuda"):
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.device = self.model.device
        batched_ok = _supports_batched(cfg)
        if cache_mode == "auto":
            cache_mode = "paged" if batched_ok else "legacy"
        if cache_mode in ("paged", "dense") and not batched_ok:
            raise ValueError(
                f"cache_mode={cache_mode!r} needs the batched prefill "
                f"path, unavailable for arch {cfg.name!r} (recurrent/"
                f"MoE/enc-dec); use cache_mode='legacy'")
        if cache_mode not in ("paged", "dense", "legacy"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        self.cache_mode = cache_mode
        self.slots = slots
        self.max_len = max_len
        self.block_size = block_size
        m_blocks = cache_lib.logical_blocks(max_len, block_size)
        self.num_blocks = slots * m_blocks if num_blocks is None \
            else num_blocks
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.sched = Scheduler(slots, cfg.prefill_chunk, policy)
        self.pool: Optional[BlockPool] = None
        self.params = None
        self.cache = None
        self.next_buf = None
        self.temps = np.zeros((slots,), np.float32)
        self.requests: Dict[int, Request] = {}
        self._done: Dict[int, List[int]] = {}
        self._metrics: Dict[int, dict] = {}
        self._arrival: Dict[int, float] = {}
        self._reset_mask = np.zeros((slots,), bool)
        self._t0 = 0.0

    # ------------------------------------------------------------------ load
    def load(self, params) -> None:
        self.params = params
        if self.cache_mode == "paged":
            spec = cache_lib.PageSpec(self.block_size, self.num_blocks)
            self.cache = self.model.init_cache(self.slots, self.max_len,
                                               paged=spec)
            self.pool = BlockPool(self.num_blocks, self.block_size,
                                  self.slots, self.max_len)
        else:
            self.cache = self.model.init_cache(self.slots, self.max_len)
            self.pool = None
        self.next_buf = torch.zeros((self.slots,), dtype=torch.long,
                                    device=self.device)

    # --------------------------------------------------------------- helpers
    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _sample(self, lg: torch.Tensor, temps: np.ndarray) -> torch.Tensor:
        """Greedy where the row's temperature is 0, else a draw from the
        seeded generator.  lg: (B, V) f32; temps: (B,) on the host."""
        greedy = lg.argmax(dim=-1)
        if not (temps > 0).any():
            return greedy
        t = self._tensor(temps, torch.float32)
        probs = torch.softmax(lg / t.clamp(min=1e-6)[:, None], dim=-1)
        drawn = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        return torch.where(t > 0, drawn, greedy)

    # ------------------------------------------------------------ admission
    def _cap_for(self, req: Request) -> int:
        p = int(len(req.prompt))
        if p == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if p + 1 > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {p} does not fit "
                f"max_len {self.max_len} (need prompt + 1)")
        return min(req.max_new_tokens, self.max_len - p)

    def _worst_blocks(self, req: Request) -> int:
        """Pool blocks the request may lease: its prompt and its budget."""
        return min(self.pool.blocks_for(len(req.prompt) + self._cap_for(req)),
                   self.pool.max_blocks_per_slot)

    def _admittable(self, reqs: List[Request]) -> int:
        """How many of ``reqs`` (in order) can be admitted now: free slots,
        and, in paged mode, pool blocks for each one's worst case."""
        free = len(self.sched.free_slots())
        n, extra = 0, 0
        for req in reqs[:free]:
            if self.pool is not None:
                worst = self._worst_blocks(req)
                if self.pool.committed + extra + worst > self.pool.num_blocks:
                    break
                extra += worst
            n += 1
        return n

    def admit(self, req: Request, arrival_s: float = 0.0) -> bool:
        """Admit one request into a free slot; False when full."""
        if self.params is None:
            raise RuntimeError(_LOAD_MSG)
        if self._admittable([req]) < 1:
            return False
        self._admit_one(req, arrival_s)
        return True

    def _admit_one(self, req: Request, arrival_s: float) -> None:
        slot = self.sched.free_slots()[0]
        cap = self._cap_for(req)
        req.out_tokens = []
        self.requests[req.rid] = req
        self._arrival[req.rid] = arrival_s
        if cap <= 0:                      # nothing to generate
            self._finalize(req.rid, arrival_s)
            return
        st = self.sched.assign(slot, req.rid, np.asarray(req.prompt),
                               cap, req.temperature, req.eos_id)
        self.temps[slot] = req.temperature
        if self.pool is not None:
            self.pool.reserve(slot, st.prompt_len + cap)
        if self.cache_mode == "legacy":
            self._legacy_prefill(slot, st)

    def _legacy_prefill(self, slot: int, st) -> None:
        """Isolated batch=1 chunked prefill, copied into the slot."""
        prompt = st.prompt
        chunk = self.cfg.prefill_chunk
        cache1 = self.model.init_cache(1, self.max_len)
        pos, logits = 0, None
        while pos < len(prompt):
            n = chunk if len(prompt) - pos >= chunk else 1
            tok = self._tensor(prompt[pos:pos + n][None])
            logits, cache1 = self.model.extend(
                self.params, tok, self._tensor([pos], torch.int32), cache1)
            pos += n
        for name, ent in self.cache.items():
            for key, val in ent.items():
                one = cache1[name][key]
                if key == "pos":              # batch first
                    val[slot].copy_(one[0])
                else:                         # layer first, then batch
                    val[:, slot].copy_(one[:, 0])
        # the copy above replaced the whole slot: a reset still pending
        # from the slot's previous request must not wipe it
        self._reset_mask[slot] = False
        tok0 = self._sample(logits[:, -1],
                            np.asarray([st.temperature], np.float32))
        self.next_buf[slot] = tok0[0]
        st.fed = st.prompt_len
        st.sampled = 1
        self._record(slot, st.epoch, 0, int(tok0[0]), self._now())

    def _admit_arrived(self, queue: List[Tuple[float, Request]],
                       now: float) -> None:
        arrived = [r for (t, r) in queue if t <= now]
        if not arrived:
            return
        n = agree_admission_count(self._admittable(arrived))
        for req in arrived[:n]:
            idx = next(i for i, (_, r) in enumerate(queue) if r is req)
            arr, _ = queue.pop(idx)
            self._admit_one(req, arr)

    # ----------------------------------------------------------------- ticks
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _pre_dispatch(self, plan: TickPlan) -> None:
        """Reset released slots; in paged mode lease the blocks this tick
        writes and upload the block table to every paged entry when it
        changed."""
        if self._reset_mask.any():
            self.model.reset_cache_slots(
                self.cache, self._tensor(self._reset_mask, torch.bool))
            self._reset_mask[:] = False
        if self.pool is not None:
            for i in range(self.slots):
                if plan.lengths[i] > 0:
                    self.pool.ensure(i, int(plan.starts[i])
                                     + int(plan.lengths[i]))
            if self.pool.dirty:
                bt = self._tensor(self.pool.table, torch.int32)
                for ent in self.cache.values():
                    if "btab" in ent:
                        ent["btab"].copy_(bt)
                self.pool.dirty = False

    def _dispatch(self, plan: TickPlan) -> torch.Tensor:
        """One tick: serve_step over the plan's rows, then sampling.  Rows
        with ``use_next`` take their first token from the next-token
        buffer; idle rows (length 0) touch nothing."""
        self._pre_dispatch(plan)
        lengths = self._tensor(plan.lengths, torch.int32)
        tok = self._tensor(plan.tokens)
        use_next = self._tensor(plan.use_next, torch.bool)
        tok[:, 0] = torch.where(use_next, self.next_buf, tok[:, 0])
        logits, self.cache = self.model.serve_step(
            self.params, tok, self._tensor(plan.starts, torch.int32),
            lengths, self.cache)
        nxt = self._sample(logits[:, -1], self.temps)
        self.next_buf = torch.where(lengths > 0, nxt, self.next_buf)
        return nxt

    def _finish(self, plan: TickPlan, nxt: torch.Tensor) -> Dict[int, int]:
        """Host bookkeeping for a completed tick (waits for the device)."""
        toks = nxt.cpu().numpy()
        now = self._now()
        out: Dict[int, int] = {}
        for slot, epoch, gidx in plan.samples:
            st = self.sched.states[slot]
            if st is None or st.epoch != epoch:
                continue              # slot released mid-flight (EOS)
            tok = int(toks[slot])
            out[st.rid] = tok
            self._record(slot, epoch, gidx, tok, now)
        return out

    def _record(self, slot: int, epoch: int, gidx: int, tok: int,
                now: float) -> None:
        st = self.sched.states[slot]
        req = self.requests[st.rid]
        req.out_tokens.append(tok)
        st.recorded = gidx + 1
        if gidx == 0:
            self._metrics[st.rid] = {
                "arrival_s": self._arrival[st.rid],
                "ttft_s": now - self._arrival[st.rid]}
        hit_eos = st.eos_id is not None and tok == st.eos_id
        if hit_eos:
            st.done = True
        if hit_eos or st.recorded >= st.cap:
            self._release(slot)
            self._finalize(st.rid, now)

    def _release(self, slot: int) -> None:
        if self.pool is not None:
            self.pool.release(slot)
        self._reset_mask[slot] = True
        self.temps[slot] = 0.0
        self.sched.release(slot)

    def _finalize(self, rid: int, now: float) -> None:
        req = self.requests.pop(rid)
        self._done[rid] = req.out_tokens
        m = self._metrics.setdefault(
            rid, {"arrival_s": self._arrival[rid], "ttft_s": None})
        m["done_s"] = now
        m["tokens"] = len(req.out_tokens)
        self._arrival.pop(rid, None)

    def step(self) -> Dict[int, int]:
        """Plan, dispatch and finish one tick synchronously; returns
        ``{rid: sampled token}`` for the rows that sampled this tick."""
        if self.params is None:
            raise RuntimeError(_LOAD_MSG)
        plan = self.sched.plan()
        if plan is None:
            return {}
        return self._finish(plan, self._dispatch(plan))

    # ------------------------------------------------------------ run loops
    def run_to_completion(self, reqs: List[Request],
                          max_steps: int = 10_000) -> ServeResult:
        """Serve ``reqs`` (all available immediately) to completion."""
        return self.run_trace(reqs, [0.0] * len(reqs), max_steps=max_steps)

    def run_trace(self, reqs: List[Request], arrivals_s: List[float],
                  max_steps: int = 10_000) -> ServeResult:
        """Serve a timed trace: request i becomes admittable once
        ``arrivals_s[i]`` seconds have elapsed.  Tick t+1 is dispatched
        before tick t's tokens are read back."""
        if self.params is None:
            raise RuntimeError(_LOAD_MSG)
        if len(reqs) != len(arrivals_s):
            raise ValueError("one arrival time per request")
        if self.pool is not None:
            for r in reqs:   # reject never-admittable requests up front
                worst = self._worst_blocks(r)
                if worst > self.pool.num_blocks:
                    raise ValueError(
                        f"request {r.rid} needs {worst} blocks but the "
                        f"pool holds {self.pool.num_blocks}")
        self._t0 = time.perf_counter()
        self._done, self._metrics = {}, {}
        queue = sorted(zip(arrivals_s, reqs), key=lambda p: p[0])
        inflight = None
        steps = 0
        while steps < max_steps:
            self._admit_arrived(queue, self._now())
            plan = self.sched.plan()
            if plan is None:
                if inflight is not None:
                    self._finish(*inflight)     # may free slots
                    inflight = None
                    continue
                if queue:
                    wait = queue[0][0] - self._now()
                    if wait > 0:
                        time.sleep(min(wait, 1e-3))
                    continue
                break
            nxt = self._dispatch(plan)
            steps += 1
            if inflight is not None:
                self._finish(*inflight)
            inflight = (plan, nxt)
        if inflight is not None:
            self._finish(*inflight)
        unfinished = {st.rid: list(self.requests[st.rid].out_tokens)
                      for _, st in self.sched.active()}
        unfinished.update({r.rid: [] for _, r in queue})
        truncated = bool(unfinished) and steps >= max_steps
        return ServeResult(self._done, truncated, unfinished,
                           self._metrics)
