"""The paper's evaluation models (§V-A.2): LLaMA2-7B, LLaMA3-8B, Mistral-7B."""
from repro_torch.configs.base import ArchConfig, register

LLAMA2_7B = register(ArchConfig(
    name="llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1e4,
    source="arXiv:2307.09288",
))

LLAMA3_8B = register(ArchConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5e5,
    source="llama3",
))

MISTRAL_7B = register(ArchConfig(
    name="mistral-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1e4,
    source="mistral",
))
