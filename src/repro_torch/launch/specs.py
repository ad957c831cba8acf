"""Meta-device stand-ins for every model input and state: shapes and
dtypes, no memory (counterpart of ``repro/launch/specs.py``).

  train:   {"tokens": (B, S), "labels": (B, S)}   (embeddings for stub archs)
  prefill: batch (B, S) (or embeddings (B, S, frontend_dim))
  decode:  token (B,) (or (B, frontend_dim))

The parameters are ``init_params`` on the meta device, and the serve state
is ``empty_serve_state`` there: the caches a prefill fills (prefill itself
is not traced, since the kernels' custom ops have no meta kernel).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig

META = torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def train_specs(cfg: ArchConfig, shape: ShapeConfig, dtype=torch.bfloat16):
    b, s = shape.global_batch, shape.seq_len
    if cfg.embed_frontend_stub:
        tokens = _meta((b, s, cfg.frontend_dim), dtype)
    else:
        tokens = _meta((b, s), torch.int32)
    return {"tokens": tokens, "labels": _meta((b, s), torch.int32)}


def prefill_specs(cfg: ArchConfig, shape: ShapeConfig, dtype=torch.bfloat16):
    b, s = shape.global_batch, shape.seq_len
    if cfg.embed_frontend_stub:
        return _meta((b, s, cfg.frontend_dim), dtype)
    return _meta((b, s), torch.int32)


def decode_token_specs(cfg: ArchConfig, shape: ShapeConfig, dtype=torch.bfloat16):
    b = shape.global_batch
    if cfg.embed_frontend_stub:
        return _meta((b, cfg.frontend_dim), dtype)
    return _meta((b,), torch.int32)


def param_specs(cfg: ArchConfig, dtype=torch.bfloat16):
    from repro_torch.models import model as M

    return M.init_params(cfg, generator=None, device=META, dtype=dtype)


def serve_state_specs(cfg: ArchConfig, batch: int, capacity: int,
                      dtype=torch.bfloat16):
    """The serve state of ``batch`` slots holding ``capacity`` tokens: the
    caches of every layer, as a prefill leaves them."""
    from repro_torch.models import model as M

    return M.empty_serve_state(cfg, batch, capacity=capacity, dtype=dtype,
                               device=META)


def tree_bytes(tree) -> int:
    """Sum of numel x itemsize over the tensors of a tree of dicts, lists,
    tuples and the caches' dataclasses (other leaves, such as a lockstep
    state's int ``length``, count nothing)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return 0
