"""The port's model, for serving: the xLSTM and the dense-attention families.

As in the reference, a stack is a sequence of *groups*, each ``count``
repetitions of a superblock of sub-blocks (Gemma-3: ``gsuper`` x5 of 5
local + 1 global attention layers, then ``gtail`` x4 local; xLSTM:
``xlstm`` x12 of mLSTM + sLSTM).  Parameters are a plain dict: ``emb``
(V, D), ``final_norm``, ``unemb`` (D, V; absent when the embeddings are
tied) and ``layers``, a list of per-layer dicts in stack order.

The cache mirrors the reference's: entry ``<group>_<i>`` serves sub-block
i of a group, its tensors stacked over the group's ``count`` layers on the
first axis.  An attention entry's ``pos`` (and ``btab`` when paged) is
(B, ·) and shared by the entry's layers, as the reference threads its
group-level ``pos`` around the scan: every layer of a dispatch reads the
entry's positions as they were before it, and ``pos`` is written once
after the last layer.

Unlike the reference, which returns new arrays, ``extend``, ``serve_step``
and ``reset_cache_slots`` update the cache in place (a full-width KV pool
is tens of MB per layer) and return it.  The other architecture families
are not ported yet (ROADMAP.md, queue A, item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import (ATTN, GLOBAL_WINDOW, MLSTM, SLSTM,
                                      ArchConfig)
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models import cache as cache_lib
from repro_torch.models.layers import (dense_init, logits_for, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.ssm import (mlstm_forward, mlstm_init, slstm_forward,
                                    slstm_init)

Tensor = torch.Tensor
_STATE_KEYS = {MLSTM: ("C", "n", "m"), SLSTM: ("c", "n", "h", "m")}


@dataclasses.dataclass(frozen=True)
class SubBlockDef:
    kind: str                     # attn | mlstm | slstm
    window: int = GLOBAL_WINDOW
    theta: float = 10_000.0


@dataclasses.dataclass(frozen=True)
class GroupDef:
    name: str
    count: int
    subs: Tuple[SubBlockDef, ...]


def build_groups(cfg: ArchConfig) -> List[GroupDef]:
    """The reference's decoder groups for the families the port runs."""
    if cfg.xlstm_pattern:
        pat = tuple(SubBlockDef(k) for k in cfg.xlstm_pattern)
        return [GroupDef("xlstm", cfg.num_layers // len(pat), pat)]
    if cfg.family != "dense":
        raise NotImplementedError(
            f"arch {cfg.name!r} (family {cfg.family!r}): the port runs the "
            f"xLSTM and dense families only so far; the others wait for "
            f"ROADMAP.md queue A, item 9 (configs and models)")
    w = cfg.sliding_window or GLOBAL_WINDOW
    if cfg.global_every:
        n_super, rem = divmod(cfg.num_layers, cfg.global_every)
        local = SubBlockDef(ATTN, window=w, theta=cfg.rope_theta)
        glob = SubBlockDef(ATTN, window=GLOBAL_WINDOW,
                           theta=cfg.rope_theta_global or cfg.rope_theta)
        groups = [GroupDef("gsuper", n_super,
                           (local,) * (cfg.global_every - 1) + (glob,))]
        if rem:
            groups.append(GroupDef("gtail", rem, (local,)))
        return groups
    return [GroupDef("dec", cfg.num_layers,
                     (SubBlockDef(ATTN, window=w, theta=cfg.rope_theta),))]


class Model:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        self.cfg = cfg
        self.groups = build_groups(cfg)
        self.device = resolve_device(device)
        # (cache entry, index in the entry, sub-block) of every layer
        self.layers = [(f"{g.name}_{si}", j, s) for g in self.groups
                       for j in range(g.count) for si, s in enumerate(g.subs)]
        self.compute_dtype = torch.bfloat16 if cfg.mlstm_dtype == "bf16" \
            else torch.float32

    # --- init ---------------------------------------------------------------
    def _init_sub(self, gen, s: SubBlockDef):
        cfg = self.cfg
        if s.kind == MLSTM:
            return mlstm_init(gen, cfg.d_model, cfg.num_heads, cfg.head_dim)
        if s.kind == SLSTM:
            return slstm_init(gen, cfg.d_model, cfg.num_heads, cfg.head_dim)
        p = blocks.attn_init(gen, cfg.d_model, cfg.num_heads,
                             cfg.num_kv_heads, cfg.head_dim)
        p.update(blocks.ffn_init(gen, cfg.d_model, cfg.d_ff))
        return p

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters made on the model's device from ``seed``."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params: Dict[str, Any] = {
            "emb": dense_init(gen, (cfg.vocab_size, cfg.d_model)),
            "final_norm": rmsnorm_init(cfg.d_model, device=self.device),
        }
        if not cfg.tie_embeddings:
            params["unemb"] = dense_init(gen, (cfg.d_model, cfg.vocab_size))
        params["layers"] = [self._init_sub(gen, s) for _, _, s in self.layers]
        return params

    def init_cache(self, batch: int, max_len: int = 0,
                   paged: Optional[cache_lib.PageSpec] = None
                   ) -> Dict[str, dict]:
        """Empty cache entries: recurrent states at zero (m = -inf), KV
        rings of ``cache_len_for(window, max_len)`` slots with every
        position -1.  With ``paged``, the entries whose ring would reserve
        the full ``max_len`` become paged pools instead."""
        cfg = self.cfg
        dims = (cfg.num_heads, cfg.head_dim)
        out = {}
        for g in self.groups:
            for si, s in enumerate(g.subs):
                name = f"{g.name}_{si}"
                if s.kind == MLSTM:
                    out[name] = cache_lib.mlstm_entry(
                        g.count, batch, *dims, device=self.device)
                    continue
                if s.kind == SLSTM:
                    out[name] = cache_lib.slstm_entry(
                        g.count, batch, *dims, device=self.device)
                    continue
                if max_len <= 0:
                    raise ValueError("an attention cache needs max_len > 0")
                wl = cache_lib.cache_len_for(s.window, max_len)
                kv = (cfg.num_kv_heads, cfg.head_dim)
                if paged is not None and wl >= max_len:
                    out[name] = cache_lib.paged_kv_entry(
                        g.count, paged.num_blocks, paged.block_size, batch,
                        max_len, *kv, device=self.device)
                else:
                    out[name] = cache_lib.kv_entry(g.count, batch, wl, *kv,
                                                   device=self.device)
        return out

    # --- forward --------------------------------------------------------------
    def _unemb(self, params) -> Tensor:
        return params["emb"].T if self.cfg.tie_embeddings else params["unemb"]

    def _backbone(self, params, h: Tensor, pos: Tensor, cache) -> Tensor:
        """Run every layer over h (B, C, D) at positions pos (B, C), -1 =
        padding, updating the cache in place."""
        cfg = self.cfg
        mode = "decode" if h.shape[1] == 1 else "chunk"
        for p, (name, j, s) in zip(params["layers"], self.layers):
            ent = cache[name]
            if s.kind == ATTN:
                h = h + blocks.self_attention(
                    p, h, pos, ent, j, heads=cfg.num_heads,
                    kv_heads=cfg.num_kv_heads, dh=cfg.head_dim,
                    window=s.window, theta=s.theta, mode=mode,
                    q_chunk=cfg.attn_q_chunk)
                h = blocks.apply_ffn(p, h)
                continue
            keys = _STATE_KEYS[s.kind]
            st = tuple(ent[key][j] for key in keys)
            fwd = mlstm_forward if s.kind == MLSTM else slstm_forward
            kw = dict(chunk=cfg.mlstm_chunk) if s.kind == MLSTM else {}
            h, st2 = fwd(p, h, st, heads=cfg.num_heads, dh=cfg.head_dim,
                         compute_dtype=self.compute_dtype, **kw)
            for key, val in zip(keys, st2):
                ent[key][j].copy_(val)
        for ent in cache.values():          # entry-level positions, once
            if "pos" in ent:
                cache_lib.scatter_ring(ent["pos"], pos, pos)
        return rmsnorm(params["final_norm"], h)

    @torch.no_grad()
    def extend(self, params, tokens: Tensor, positions: Tensor, cache
               ) -> Tuple[Tensor, dict]:
        """Process a chunk.  tokens: (B, C); positions: (B,) start positions.
        Returns (last-position logits (B, 1, V) f32, the cache updated in
        place)."""
        C = tokens.shape[1]
        pos = positions.to(torch.int32)[:, None] + torch.arange(
            C, dtype=torch.int32, device=tokens.device)[None]
        h = self._backbone(params, params["emb"][tokens], pos, cache)
        return logits_for(h[:, -1:], self._unemb(params)), cache

    def prefill(self, params, tokens: Tensor, max_len: int = 0):
        """Chunked prefill over the full prompt (chunk = prefill_chunk, or
        the whole prompt when its length is not a multiple).  ``max_len``
        sizes attention caches (default: the prompt length).  Returns
        (last logits, filled cache)."""
        B, S = tokens.shape
        chunk = min(self.cfg.prefill_chunk, S)
        if S % chunk:
            chunk = S
        cache = self.init_cache(B, max(max_len, S))
        logits = None
        for c0 in range(0, S, chunk):
            start = torch.full((B,), c0, dtype=torch.int32, device=self.device)
            logits, cache = self.extend(params, tokens[:, c0:c0 + chunk],
                                        start, cache)
        return logits, cache

    def decode_step(self, params, tokens, positions, cache):
        return self.extend(params, tokens, positions, cache)

    @torch.no_grad()
    def serve_step(self, params, tokens: Tensor, starts: Tensor,
                   lengths: Tensor, cache) -> Tuple[Tensor, dict]:
        """One serving dispatch over a ragged (B, C) batch: row b carries
        ``lengths[b]`` tokens from position ``starts[b]`` (0 = idle row).
        Positions past ``lengths`` are -1, so in attention layers their
        tokens neither attend nor reach the cache.  Recurrent layers have
        no positions to mask: the engine's legacy mode only sends chunks
        of one request at batch 1, and single tokens to all slots.
        Returns (logits (B, 1, V) at each row's last valid token, cache);
        idle rows' logits are garbage."""
        C = tokens.shape[1]
        off = torch.arange(C, dtype=torch.int32, device=tokens.device)[None]
        pos = torch.where(off < lengths[:, None],
                          starts.to(torch.int32)[:, None] + off, -1)
        h = self._backbone(params, params["emb"][tokens], pos, cache)
        last = (lengths.long() - 1).clamp(0, C - 1)
        hl = h[torch.arange(h.shape[0], device=h.device), last][:, None]
        return logits_for(hl, self._unemb(params)), cache

    @torch.no_grad()
    def reset_cache_slots(self, cache, mask: Tensor):
        """Clear the slots where ``mask`` (B,) is True, in place, so they can
        be reused: ``pos``/``btab`` to -1; paged pools untouched (their
        blocks go back through the host-side pool and are overwritten on
        the next lease); 'm' stabilisers to -inf; everything else to 0.
        Batch is axis 0 for pos/btab and axis 1 for the rest."""
        for ent in cache.values():
            paged = "btab" in ent
            for key, val in ent.items():
                if key in ("pos", "btab"):
                    val.masked_fill_(mask[:, None], -1)
                elif not (paged and key in ("k", "v")):
                    m = mask.view((1, -1) + (1,) * (val.dim() - 2))
                    val.masked_fill_(m, float("-inf") if key == "m" else 0.0)
        return cache
