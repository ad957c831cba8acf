"""Zamba2-2.7B — Mamba2 backbone with shared attention blocks.

[arXiv:2411.15242; hf]. 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64. The hybrid is a repeating pattern of five Mamba2 blocks
followed by one (attention + FFN) block; Mamba2 layers carry no FFN (the
Mamba2 block has its own in/out projections). Attention layers take
head_dim 80 (2560 / 32).
"""
from repro_torch.configs.base import (
    ArchConfig, MIXER_ATTENTION, MIXER_MAMBA2, SSMConfig, register,
)

_PATTERN = (MIXER_MAMBA2,) * 5 + (MIXER_ATTENTION,)

CONFIG = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    mixer_pattern=_PATTERN,
    ffn_every_layer=False,
    ssm=SSMConfig(state_dim=64, conv_dim=4, expand=2, head_dim=64, chunk=64),
    source="arXiv:2411.15242; hf",
))
