"""Gemma-3-4B: 34 layers, 5 local : 1 global attention, head_dim 256.

[hf:google/gemma-3-1b-pt; unverified].  Local layers use a 1024-token
sliding window with rope_theta 10k; every 6th layer is global with
rope_theta 1M.  The widths are the reference config's.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    sliding_window=1024,
    global_every=6,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
))
