"""Architecture configuration for the PyTorch port.

The reference's ``ArchConfig`` cut to the fields the port's xLSTM and
dense-attention paths read, with its registry and ``reduced`` (the port
keeps its own copy and imports nothing of the JAX package).  The other
families' fields come with the slices that port them (ROADMAP.md); the
dry-run input shapes and ``input_specs`` are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

# Layer-kind tags used by the stack builder -----------------------------------
ATTN = "attn"          # self attention (window controlled per layer)
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block
GLOBAL_WINDOW = 1 << 30  # sentinel: "no window" (full attention)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture; the fields keep the reference config's names."""

    name: str
    family: str                    # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- attention pattern -------------------------------------------------
    sliding_window: int = 0        # 0 => full attention everywhere
    # every `global_every`-th layer (1-indexed) is full/global; others local
    global_every: int = 0          # 0 => homogeneous
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # gemma3: another theta on global layers

    xlstm_pattern: Tuple[str, ...] = ()
    prefill_chunk: int = 4_096     # chunked-prefill granularity
    tie_embeddings: bool = False
    attn_q_chunk: int = 512        # 0 => no query chunking (plain path)
    mlstm_dtype: str = "f32"       # f32 | bf16 (xLSTM q/k/v and recurrences)
    mlstm_chunk: int = 256         # chunkwise-mLSTM chunk length
    source: str = ""

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer attention window (GLOBAL_WINDOW => full)."""
        out = []
        for i in range(self.num_layers):
            if self.sliding_window <= 0:
                out.append(GLOBAL_WINDOW)
            elif self.global_every and (i + 1) % self.global_every == 0:
                out.append(GLOBAL_WINDOW)
            else:
                out.append(self.sliding_window)
        return tuple(out)

    def layer_thetas(self) -> Tuple[float, ...]:
        out = []
        windows = self.layer_windows()
        for i in range(self.num_layers):
            if self.rope_theta_global and windows[i] == GLOBAL_WINDOW:
                out.append(self.rope_theta_global)
            else:
                out.append(self.rope_theta)
        return tuple(out)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _load_all() -> None:
    # the port carries the configs of the architectures it runs so far
    from repro_torch.configs import gemma3_4b, xlstm_350m  # noqa: F401


def reduced(cfg: ArchConfig, **overrides: Any) -> ArchConfig:
    """A tiny same-family config for CPU tests (the reference's rules for
    the fields the port has)."""
    base = dict(
        num_layers=max(2, min(4, cfg.num_layers)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) or 2,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window
        else 0,
        prefill_chunk=8,
    )
    if cfg.xlstm_pattern:
        base["num_layers"] = 2 * len(cfg.xlstm_pattern)
        base["d_ff"] = 0
    if cfg.global_every:
        base["global_every"] = min(cfg.global_every, 2)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
