"""Weight bridge: the JAX package's parameter tree -> the port's parameters.

The JAX tree arrives as nested dicts of numpy arrays (``np.asarray`` of
every leaf), so this module needs neither JAX nor ``ml_dtypes``: a bf16
array (``a.dtype.name == "bfloat16"``, or a ``ckpt.load_numpy`` leaf of
bf16 bits) is reinterpreted bit for bit through a 16-bit view
(``ckpt.checkpoint.to_tensor``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.ckpt.checkpoint import to_tensor
from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import transformer as T


tensor_from_numpy = to_tensor


def params_from_numpy(cfg: ArchConfig, tree, device):
    """JAX ``M.init_params`` tree (numpy leaves) -> the port's parameters.

    The JAX package stacks a period of P layers: ``blocks/pos{p}`` leaves
    carry a leading axis over the n_per periods, and the n_rem = L % P
    remainder layers sit unstacked under ``rem/rem{r}``. They become one
    flat list: ``blocks/pos{p}[per]`` is layer ``per·P + p`` and
    ``rem/rem{r}`` layer ``n_per·P + r`` (a dense stack has P = 1 and no
    remainder, so ``pos0[i]`` is layer i). Each leaf keeps its dtype: a
    recurrent layer's ``mamba`` or ``xl`` leaves come with its f32 ones
    (A_log, D, dt_bias; b_if; b) f32 in a bf16 model, and a layer without
    an FFN (zamba2's mamba2 layers) has no ``ln2`` or ``ffn`` leaves. A
    frontend-stub arch has no ``embed`` leaf on either side.
    """
    T.check_ported(cfg)
    n_per, n_rem = T.layer_layout(cfg)
    period = T.period_len(cfg)
    to_t = lambda a: tensor_from_numpy(a, device)
    layers = [None] * cfg.num_layers
    for pos in range(period if n_per else 0):
        stacked = tree["blocks"][f"pos{pos}"]
        for per in range(n_per):
            layers[per * period + pos] = tree_map(
                lambda a, per=per: to_t(np.asanyarray(a)[per]), stacked)
    for r in range(n_rem):
        layers[n_per * period + r] = tree_map(to_t, tree["rem"][f"rem{r}"])
    params = {} if cfg.embed_frontend_stub else {"embed": to_t(tree["embed"])}
    params.update(layers=layers, final_norm=to_t(tree["final_norm"]))
    if not cfg.tie_embeddings:
        params["lm_head"] = to_t(tree["lm_head"])
    return params
