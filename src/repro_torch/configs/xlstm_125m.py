"""xLSTM-125M — sLSTM + mLSTM blocks, attention-free. [arXiv:2405.04517].

12L d_model=768 4H d_ff=0 vocab=50304. Blocks carry their own projections;
no separate FFN (d_ff=0). H²EAL is inapplicable: the recurrent blocks hold
constant-size state instead of a KV cache, so there is nothing to page or
sparsify; decode is constant-state.
"""
from repro_torch.configs.base import (
    ArchConfig, H2ealConfig, MIXER_MLSTM, MIXER_SLSTM, register,
)

# xLSTM[7:1]-style: mostly mLSTM with periodic sLSTM
_PATTERN = (MIXER_MLSTM, MIXER_MLSTM, MIXER_SLSTM) * 4

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    mixer_pattern=_PATTERN,
    h2eal=H2ealConfig(enabled=False),  # attention-free: technique inapplicable
    source="arXiv:2405.04517; unverified",
))
