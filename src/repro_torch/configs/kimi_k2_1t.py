"""Kimi-K2-1T-A32B — trillion-param MoE, 384 experts top-8 + 1 shared.

[arXiv:2501.kimi2; unverified, paper-table]. 61L d_model=7168 64H (GQA kv=8)
per-expert d_ff=2048 vocab=163840.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=128,
    moe=MoEConfig(num_experts=384, top_k=8, shared_expert_ff=2048),
    source="arXiv:2501.kimi2; unverified",
))
