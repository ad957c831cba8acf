"""Serving step builders (counterpart of ``repro/runtime/serve.py``).

The decode step comes in two variants, select and reuse: the serving
loop calls the select variant every ``share_window`` steps (fresh page
scoring and top-k) and the cheaper reuse variant in between. The
continuous-batching engine uses the ragged decode steps, the greedy
sampler and the chunked-prefill step.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import layouts as layoutlib
from repro_torch.models import model as M


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; no silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    capacity: int             # most context tokens the cache holds
    layout: str = "default"   # core/layouts name; only "default" is ported


def make_prefill(cfg: ArchConfig, scfg: ServeConfig):
    layout = layoutlib.get_layout(scfg.layout).name

    def prefill(params, batch):
        return M.prefill(cfg, params, batch, capacity=scfg.capacity,
                         layout=layout)
    return prefill


def make_decode_step(cfg: ArchConfig, scfg: ServeConfig, *, do_select: bool):
    layout = layoutlib.get_layout(scfg.layout).name

    def decode(params, state, token):
        return M.decode_step(cfg, params, state, token, do_select=do_select,
                             layout=layout)
    return decode


def make_ragged_decode_step(cfg: ArchConfig, scfg: ServeConfig, *,
                            do_select: bool):
    """Decode step of the continuous-batching engine: per-slot (B,) lengths
    in the state and an ``active`` mask; the select variant also takes
    ``need_select``, each slot's share-window phase."""
    layout = layoutlib.get_layout(scfg.layout).name
    if do_select:
        def decode(params, state, token, active, need_select):
            return M.decode_step(cfg, params, state, token, do_select=True,
                                 layout=layout, active=active,
                                 need_select=need_select)
    else:
        def decode(params, state, token, active):
            return M.decode_step(cfg, params, state, token, do_select=False,
                                 layout=layout, active=active)
    return decode


def make_sample_step(cfg: ArchConfig, scfg: ServeConfig):
    """The greedy lane of the engine's sampler: (logits (B, V)) -> tokens
    (B,) int32, the first maximal index (as ``argmax`` on both sides).
    Stochastic sampling is ROADMAP Queue 1 item 6."""
    del cfg, scfg  # greedy sampling depends on neither

    def sample(logits):
        return logits.argmax(dim=-1).to(torch.int32)
    return sample


def make_prefill_chunk_step(cfg: ArchConfig, scfg: ServeConfig, *, chunk: int):
    """Chunked-prefill half of the engine's mixed step: each prefilling
    slot's next prompt chunk (at most ``chunk`` tokens, a fixed shape) goes
    straight into its rows of the batched state."""
    layout = layoutlib.get_layout(scfg.layout).name

    def chunk_step(params, state, tokens, chunk_len, active):
        if tokens.shape[1] != chunk:
            raise ValueError(f"chunk of {tokens.shape[1]} tokens, expected {chunk}")
        return M.prefill_chunk(cfg, params, state, tokens, chunk_len=chunk_len,
                               active=active, layout=layout)
    return chunk_step
