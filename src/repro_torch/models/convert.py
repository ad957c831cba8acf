"""Weight bridge: the JAX package's parameter tree -> the port's parameters.

The JAX tree arrives as nested dicts of numpy arrays (``np.asarray`` of
every leaf), so this module needs neither JAX nor ``ml_dtypes``: a bf16
array (``a.dtype.name == "bfloat16"``) is reinterpreted bit for bit
through a uint16 view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable and owned by torch
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def params_from_numpy(cfg: ArchConfig, tree, device):
    """JAX ``M.init_params`` tree (numpy leaves) -> the port's parameters.

    The scanned ``blocks/pos0`` leaves carry a leading layer axis; they
    are unstacked into one dict per layer (a dense stack has period 1 and
    no remainder layers).
    """
    T.check_ported(cfg)
    n_periods, _ = T.layer_layout(cfg)
    to_t = lambda a: tensor_from_numpy(a, device)
    stacked = tree["blocks"]["pos0"]
    layers = [_tree(stacked, lambda a, i=i: to_t(np.asarray(a)[i]))
              for i in range(n_periods)]
    params = {"embed": to_t(tree["embed"]), "layers": layers,
              "final_norm": to_t(tree["final_norm"])}
    if not cfg.tie_embeddings:
        params["lm_head"] = to_t(tree["lm_head"])
    return params
