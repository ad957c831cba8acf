"""Head identification (paper §IV-A.1, after DuoAttention; counterpart of
``repro/core/gating.py``).

During identification training every head's output is a convex mix of
full and streaming attention gated by a trainable α ∈ [0, 1], the only
trainable parameter; an L1 penalty pushes α toward 0, and heads whose α
stays high are retrieval heads:

    Attn_{i,j} = α_{i,j} · Full_Attn + (1 − α_{i,j}) · Streaming_Attn

The gradients follow JAX's conventions at the kinks: ``clip_alpha`` splits
the gradient in halves at a bound (``jnp.clip`` is a max and a min, whose
gradients split ties), and ``gating_loss``'s |α| has gradient 1 at 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def init_alpha(num_layers: int, n_kv: int, device="cpu") -> torch.Tensor:
    """α initialised to 1 (paper: 'At beginning, α's are initialized to 1')."""
    return torch.ones((num_layers, n_kv), dtype=torch.float32, device=device)


def clip_alpha(alpha: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=alpha.dtype, device=alpha.device)
    return torch.minimum(torch.maximum(alpha, zero), zero + 1.0)


def gated_attention(q, k, v, alpha_layer, *, sink: int, local: int):
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D); alpha_layer: (Hkv,). The α-gated
    mix of full causal and streaming (window ``local`` + ``sink``) attention,
    each kv head's α broadcast over its GQA group. Both are
    ``ops.flash_attention`` calls. The mix promotes to α's f32, as the
    reference's does."""
    group = q.shape[2] // k.shape[2]
    full = kops.flash_attention(q, k, v, causal=True)
    stream = kops.flash_attention(q, k, v, causal=True, window=local, sink=sink)
    a = clip_alpha(alpha_layer).repeat_interleave(group)[None, None, :, None]
    return a * full + (1.0 - a) * stream


def gating_loss(task_loss, alpha, lam: float = 0.05):
    """task_loss + λ·‖α‖₁ (drives unneeded heads toward streaming)."""
    return task_loss + lam * torch.where(alpha >= 0, alpha, -alpha).sum()


def classify_heads(alpha: torch.Tensor, static_sparsity: float) -> torch.Tensor:
    """Per layer, the kv heads by descending α, retrieval heads first: (L,
    Hkv) int32 permutations. The sort is stable, as ``jnp.argsort``, so
    ties (α often sits at a clip bound) keep the lower head first. How many
    of a layer's heads are retrieval heads is fixed by ``static_sparsity``
    (``AttnSpec``); the α ranking decides which."""
    del static_sparsity  # the count comes from the config, as in the reference
    return torch.argsort(-alpha, dim=1, stable=True).to(torch.int32)


def plan_from_perms(perms: torch.Tensor):
    """``classify_heads``' (L, Hkv) permutations -> the port's plan: one
    permutation a layer (``models/transformer.py::default_plan``'s form),
    ``None`` where a layer's is the identity."""
    ident = torch.arange(perms.shape[1], dtype=perms.dtype, device=perms.device)
    return [None if torch.equal(p, ident) else p.clone() for p in perms]
