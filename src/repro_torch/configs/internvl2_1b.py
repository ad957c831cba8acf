"""InternVL2-1B: InternViT frontend (a stub) + InternLM2 LM backbone.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The ViT frontend is
a stub: the model takes precomputed patch embeddings, not token ids.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    rope_theta=1e6,
    embed_frontend_stub=True,
    frontend_dim=896,
    source="arXiv:2404.16821; hf",
))
