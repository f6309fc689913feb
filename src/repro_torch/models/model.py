"""The port's model: the xLSTM family, for serving.

Parameters are a plain dict: ``emb`` (V, D), ``final_norm``, ``unemb``
(D, V) and ``layers``, a list of per-layer dicts in stack order (mLSTM and
sLSTM alternating as ``cfg.xlstm_pattern`` says).  The cache mirrors the
reference's: entry ``xlstm_<i>`` holds the states of pattern position i,
stacked over the ``count`` repetitions of the pattern.

Unlike the reference, which returns new arrays, ``extend`` and
``reset_cache_slots`` update the cache in place (the full-width carry is
2 MB per mLSTM layer and slot) and return it.  Other architecture families
are not ported yet (ROADMAP.md, queue A, item 9).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import MLSTM, SLSTM, ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import cache as cache_lib
from repro_torch.models.layers import (dense_init, logits_for, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.ssm import (mlstm_forward, mlstm_init, slstm_forward,
                                    slstm_init)

Tensor = torch.Tensor
_STATE_KEYS = {MLSTM: ("C", "n", "m"), SLSTM: ("c", "n", "h", "m")}


class Model:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        if not cfg.xlstm_pattern:
            raise NotImplementedError(
                f"arch {cfg.name!r} (family {cfg.family!r}): the port runs "
                f"the xLSTM family only so far; the others wait for "
                f"ROADMAP.md queue A, item 9 (configs and models)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pattern = tuple(cfg.xlstm_pattern)
        self.count = cfg.num_layers // len(self.pattern)
        self.compute_dtype = torch.bfloat16 if cfg.mlstm_dtype == "bf16" \
            else torch.float32

    # --- init ---------------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters made on the model's device from ``seed``."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params: Dict[str, Any] = {
            "emb": dense_init(gen, (cfg.vocab_size, cfg.d_model)),
            "final_norm": rmsnorm_init(cfg.d_model, device=self.device),
            "unemb": dense_init(gen, (cfg.d_model, cfg.vocab_size)),
        }
        init_fn = {MLSTM: mlstm_init, SLSTM: slstm_init}
        params["layers"] = [
            init_fn[kind](gen, cfg.d_model, cfg.num_heads, cfg.head_dim)
            for kind in self.pattern * self.count]
        return params

    def init_cache(self, batch: int) -> Dict[str, dict]:
        """Zero recurrent states (m = -inf); their size does not depend on
        the sequence length."""
        cfg = self.cfg
        entry = {MLSTM: cache_lib.mlstm_entry, SLSTM: cache_lib.slstm_entry}
        return {f"xlstm_{si}": entry[kind](self.count, batch, cfg.num_heads,
                                           cfg.head_dim, device=self.device)
                for si, kind in enumerate(self.pattern)}

    # --- forward --------------------------------------------------------------
    def _backbone(self, params, h: Tensor, cache) -> Tensor:
        cfg = self.cfg
        P = len(self.pattern)
        for i, p in enumerate(params["layers"]):
            j, si = divmod(i, P)
            kind = self.pattern[si]
            ent = cache[f"xlstm_{si}"]
            keys = _STATE_KEYS[kind]
            st = tuple(ent[key][j] for key in keys)
            if kind == MLSTM:
                h, st2 = mlstm_forward(p, h, st, heads=cfg.num_heads,
                                       dh=cfg.head_dim, chunk=cfg.mlstm_chunk,
                                       compute_dtype=self.compute_dtype)
            else:
                h, st2 = slstm_forward(p, h, st, heads=cfg.num_heads,
                                       dh=cfg.head_dim,
                                       compute_dtype=self.compute_dtype)
            for key, val in zip(keys, st2):
                ent[key][j].copy_(val)
        return rmsnorm(params["final_norm"], h)

    @torch.no_grad()
    def extend(self, params, tokens: Tensor, positions: Tensor, cache
               ) -> Tuple[Tensor, dict]:
        """Process a chunk.  tokens: (B, C); positions: (B,) start positions
        (recurrent layers do not read them).  Returns (last-position logits
        (B, 1, V) f32, the cache updated in place)."""
        h = self._backbone(params, params["emb"][tokens], cache)
        return logits_for(h[:, -1:], params["unemb"]), cache

    def prefill(self, params, tokens: Tensor):
        """Chunked prefill over the full prompt (chunk = prefill_chunk, or
        the whole prompt when its length is not a multiple).  Returns (last
        logits, filled cache)."""
        B, S = tokens.shape
        chunk = min(self.cfg.prefill_chunk, S)
        if S % chunk:
            chunk = S
        cache = self.init_cache(B)
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
        """One serving dispatch over a (B, C) batch.  Returns (logits
        (B, 1, V) at each slot's last valid token, cache).  Recurrent state
        has no positions to mask, so rows past ``lengths`` still advance
        their slot's state: the engine's legacy mode only sends chunks of
        one request at batch 1, and single tokens to all slots."""
        C = tokens.shape[1]
        h = self._backbone(params, params["emb"][tokens], cache)
        last = (lengths.long() - 1).clamp(0, C - 1)
        hl = h[torch.arange(h.shape[0], device=h.device), last][:, None]
        return logits_for(hl, params["unemb"]), cache

    @torch.no_grad()
    def reset_cache_slots(self, cache, mask: Tensor):
        """Clear the states of the slots where ``mask`` (B,) is True, in
        place: 'm' stabilisers to -inf, everything else to 0."""
        for ent in cache.values():
            for key, val in ent.items():
                val[:, mask] = float("-inf") if key == "m" else 0.0
        return cache
