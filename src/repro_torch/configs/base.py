"""Architecture configuration for the PyTorch port.

The reference's ``ArchConfig`` cut to the fields the port's xLSTM path
reads, with its registry and ``reduced`` (the port keeps its own copy and
imports nothing of the JAX package).  The other families' fields come with
the slices that port them (ROADMAP.md); the dry-run input shapes and
``input_specs`` are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

# Layer-kind tags of the xLSTM stack -----------------------------------------
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture; the fields keep the reference config's names."""

    name: str
    family: str                    # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    vocab_size: int
    head_dim: int = 128
    xlstm_pattern: Tuple[str, ...] = ()
    prefill_chunk: int = 4_096     # chunked-prefill granularity
    mlstm_dtype: str = "f32"       # f32 | bf16 (xLSTM q/k/v and recurrences)
    mlstm_chunk: int = 256         # chunkwise-mLSTM chunk length
    source: str = ""


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
    from repro_torch.configs import xlstm_350m  # noqa: F401


def reduced(cfg: ArchConfig, **overrides: Any) -> ArchConfig:
    """A tiny same-family config for CPU tests (the reference's rules for
    the fields the port has)."""
    base = dict(
        num_layers=max(2, min(4, cfg.num_layers)),
        d_model=64,
        num_heads=4,
        head_dim=16,
        vocab_size=256,
        prefill_chunk=8,
    )
    if cfg.xlstm_pattern:
        base["num_layers"] = 2 * len(cfg.xlstm_pattern)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
