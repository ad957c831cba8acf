"""MusicGen-Large: decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048 (EnCodec codebook).
The EnCodec frontend is a stub: the model takes precomputed frame
embeddings, not token ids.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    embed_frontend_stub=True,
    frontend_dim=2048,
    source="arXiv:2306.05284; hf",
))
