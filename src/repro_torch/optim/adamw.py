"""AdamW with decoupled weight decay and global-norm clipping over the
port's parameter trees (counterpart of ``repro/optim/adamw.py``).

μ and ν are f32 whatever a leaf's dtype; the update is computed in f32
and cast back to the leaf's dtype. Functions return new trees and leave
their inputs as they were, as the reference's do.

On a mesh (the sharded train step) every tree holds the rank's blocks,
placed by ``specs``: the update is elementwise, so it runs on the blocks
as they are, and only the clip's global norm, the norm of the logical
(whole) gradient, sums across ranks (``global_norm``)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.tree import leaves, tree_map, unzip


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_state(params):
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    dev = leaves(params)[0].device
    return {"mu": zeros, "nu": tree_map(torch.zeros_like, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """The norm of the whole tree. With ``mesh`` and ``specs`` (a tree of
    blocks placed by ``specs``): each block's sum of squares, summed over the
    axes that cut its leaf, so a leaf whole on a rank counts once; the
    leaves cut alike are summed first, then those sums in a fixed order of
    their axes, the same value on every rank."""
    if mesh is None:
        return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime.sharding import _cut_axes, spec_leaves

    groups: dict = {}
    for x, s in zip(leaves(tree), spec_leaves(tree, specs)):
        groups.setdefault(_cut_axes(s, mesh), []).append(x.float().square().sum())
    total = 0
    for axes in sorted(groups):
        part = sum(groups[axes])
        total = total + coll.sum_tiles(part, mesh, axes)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, mesh=None, specs=None):
    norm = global_norm(grads, mesh, specs)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def apply_updates(params, grads, state, cfg: AdamWConfig, lr_scale=1.0, mesh=None,
                  specs=None):
    """Returns (new_params, new_state, grad_norm). ``lr_scale`` is a float
    or a 0-d f32 tensor (``cosine_schedule``). With ``mesh`` the trees are
    the rank's blocks placed by ``specs`` (``global_norm``)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, mesh, specs)
    count = state["count"] + 1
    c = count.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=c.device), c)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=c.device), c)
    lr = cfg.lr * lr_scale

    def upd(p, g, mu, nu):
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g.square()
        step = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), mu, nu

    new_p, mu, nu = unzip(tree_map(upd, params, grads, state["mu"], state["nu"]), 3)
    return new_p, {"mu": mu, "nu": nu, "count": count}, gnorm


def cosine_schedule(step, *, base_lr_scale=1.0, warmup: int = 100,
                    total: int = 10_000, min_frac: float = 0.1) -> torch.Tensor:
    """Multiplier for cfg.lr, a 0-d f32 tensor; ``step`` an int or tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr_scale * warm * cos
