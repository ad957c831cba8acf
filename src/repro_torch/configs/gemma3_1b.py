"""Gemma3-1B — dense, 5:1 local:global attention, 128k-capable.

[hf:google/gemma-3-1b-pt; unverified]. 26L d_model=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144. Local layers use a 512-token sliding window; every
6th layer is global. Global layers get H²EAL; local layers keep a full
cache and attend its last 512 positions (they are already static-sparse).
"""
from repro_torch.configs.base import ATTN_LOCAL_GLOBAL, ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    tie_embeddings=True,
    attn_pattern=ATTN_LOCAL_GLOBAL,
    local_window=512,
    local_global_ratio=5,
    rope_theta=1e6,
    source="hf:google/gemma-3-1b-pt; unverified",
))
