"""SmolLM-360M: llama-arch small dense GQA (tied embeddings)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
))
