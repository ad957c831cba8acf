"""Serving step builders (counterpart of ``repro/runtime/serve.py``).

The decode step comes in two variants, select and reuse: the serving
loop calls the select variant every ``share_window`` steps (fresh page
scoring and top-k) and the cheaper reuse variant in between.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.core import layouts as layoutlib
from repro_torch.models import model as M


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
