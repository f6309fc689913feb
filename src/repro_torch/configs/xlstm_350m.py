"""xLSTM-350M: 24 blocks alternating mLSTM/sLSTM, d_ff=0 (no separate FFN).

[arXiv:2405.04517; unverified].  The widths are the reference config's.
"""
from repro_torch.configs.base import MLSTM, SLSTM, ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    head_dim=256,
    vocab_size=50304,
    xlstm_pattern=(MLSTM, SLSTM),
    prefill_chunk=4096,
    source="arXiv:2405.04517; unverified",
))
