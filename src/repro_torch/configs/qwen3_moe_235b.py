"""Qwen3-MoE-235B-A22B — 128 experts, top-8, GQA kv=4.

[hf:Qwen/Qwen3-30B-A3B; hf]. 94L d_model=4096 64H (GQA kv=4) per-expert
d_ff=1536 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=8),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
