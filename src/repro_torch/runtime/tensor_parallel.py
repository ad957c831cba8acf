"""Tensor-parallel and FSDP products over a ``launch/mesh.Mesh`` (the port's
own module; the reference gets them from GSPMD under ``jit_serve_steps`` and
``jit_train_step``'s shardings).

A ``TensorParallel`` is one rank's view of a parameter tree placed by
``runtime/sharding.param_shardings``: the mesh and the tree of placements.
Every product reads its weight's rule from that tree, never from a list of
names of its own:

  * a weight stored cut over 'data' (FSDP) is gathered where it is used
    (``collectives.fsdp_gather``; its gradient summed over 'data' back into
    the rank's block);
  * a **column** product (output dim over 'model'): the input enters by
    ``copy_to`` (its gradient summed over 'model'), each rank computes its
    block of the output columns, gathered or not as the caller asks;
  * a **row** product (input dim over 'model'): the rank's feature block of
    the input (``split``, unless the input already is that block), then one
    sum over 'model' (``reduce_from``);
  * the **embedding lookup** over a vocabulary cut: each rank looks up the
    ids in its rows, zero elsewhere, then a sum: exact, since each row has
    one owner;
  * the **logits** over a vocabulary cut: a column product whose columns
    are the rank's vocabulary block, gathered.

A leaf whose cut did not divide is whole (``_spec_for_param`` drops the
axis) and is used whole, its input unentered. An axis of one rank cuts
nothing, so on a one-rank mesh every product is the whole-weight product,
bit for bit. ``tp=None`` in the model's functions is the whole-weight path
itself, unchanged.

Attention cuts q, k and v by columns, which need not fall on head
boundaries (smollm-360m at 'model' = 2 gives ``wk`` 160 columns a rank, 2.5
heads), so ``models/transformer.py`` gathers their columns, runs the
attention on whole heads as the layout does, and splits its output for the
row-cut ``wo``. SwiGLU is Megatron's pair: ``w_gate`` / ``w_up`` column-cut,
``w_down`` row-cut, one sum and no gather.

The dense family only: MoE experts, mamba2 / xLSTM mixers and local:global
stacks on a mesh wait for ROADMAP Queue 1 item 9d (``check_config``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ATTN_LOCAL_GLOBAL, MIXER_ATTENTION
from repro_torch.models.layers import dense
from repro_torch.runtime import collectives as coll
from repro_torch.runtime.sharding import _axes

MODEL, DATA = "model", "data"


def check_config(cfg) -> None:
    """Raise for a config that the tensor-parallel paths do not serve or
    train: a frontend stub (the GSPMD layouts' refusal), and the MoE,
    recurrent and local:global families (item 9d)."""
    from repro_torch.core import layouts as layoutlib

    layoutlib.check_gspmd_config(cfg)
    why = []
    if cfg.moe.enabled:
        why.append("a MoE stack (the experts' rules: E over 'data' at serve, over "
                   "'model' in training)")
    if any(m != MIXER_ATTENTION for m in cfg.mixer_pattern):
        why.append(f"the recurrent mixers {sorted(set(cfg.mixer_pattern) - {MIXER_ATTENTION})} "
                   f"(the mamba2 / xLSTM TP rules)")
    if cfg.attn_pattern == ATTN_LOCAL_GLOBAL:
        why.append("a local:global stack")
    if why:
        raise NotImplementedError(
            f"{cfg.name} on a mesh: {'; '.join(why)} is not ported (ROADMAP Queue 1 "
            f"item 9d); the dense family runs on a mesh, this one with mesh=None")


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's view of a placed parameter (sub)tree: ``specs`` is the
    matching subtree of ``param_shardings``."""

    mesh: Any
    specs: Any

    def at(self, *keys) -> "TensorParallel":
        """The view of a subtree (``tp.at("layers", i)``)."""
        s = self.specs
        for k in keys:
            s = s[k]
        return TensorParallel(self.mesh, s)

    def model_dim(self, key: str):
        """The dim of leaf ``key`` cut over 'model' (None: whole over it)."""
        for d, entry in enumerate(self.specs[key]):
            if MODEL in _axes(entry) and self.mesh.shape[MODEL] > 1:
                return d
        return None

    def use(self, p, key: str):
        """Leaf ``key`` of the parameter dict ``p`` as a product uses it: its
        'data' cuts gathered (FSDP), and the dim still cut over 'model'."""
        w = p[key]
        for d, entry in enumerate(self.specs[key]):
            axes = _axes(entry)
            if DATA in axes:
                if len(axes) > 1:
                    raise ValueError(f"{key}: dim {d} is cut over {axes}; FSDP gathers "
                                     f"a dim cut over 'data' alone")
                w = coll.fsdp_gather(w, self.mesh, d)
        return w, self.model_dim(key)


def columns(tp, x, p, keys, biases=None, *, gather: bool):
    """``dense(x, p[k], p[b])`` for each weight key k (and bias key b, or
    None) of ``keys``: with ``gather`` the whole outputs, else each the
    rank's block of its output columns (whole where the weight is whole).
    Returns (outputs, whether the weights are cut over 'model')."""
    biases = biases or (None,) * len(keys)
    used = [tp.use(p, k) for k in keys]
    cut = {d for _, d in used}
    if cut - {None, 1}:
        raise ValueError(f"column products {keys} cut on dims {cut}; expected the "
                         f"output dim (1) over 'model'")
    # one entry for every cut product: their input gradients sum in one
    # all_reduce; a whole product takes x itself (its gradient is whole)
    xin = coll.copy_to(x, tp.mesh) if 1 in cut else x
    out = []
    for (w, d), b in zip(used, biases):
        bias = p.get(b) if b else None
        if bias is not None and (tp.model_dim(b) is not None) != (d is not None):
            raise ValueError(f"bias {b} and its weight are cut differently")
        y = dense(xin if d == 1 else x, w, bias)
        out.append(coll.gather_cols(y, tp.mesh, MODEL, -1) if gather and d == 1 else y)
    return out, 1 in cut


def row(tp, x, p, key: str, *, x_block: bool = False):
    """``dense(x, p[key])`` of a weight whose input dim may be cut over
    'model': the rank's feature block of ``x`` (``x`` already that block
    where ``x_block``), its partial product summed over 'model'."""
    w, d = tp.use(p, key)
    if d is None:
        if x_block:
            raise ValueError(f"{key} is whole but its input is a block")
        return dense(x, w)
    if d != 0:
        raise ValueError(f"row product {key} cut on dim {d}; expected its input dim 0")
    if not x_block:
        x = coll.split(x, tp.mesh, MODEL, -1)
    return coll.reduce_from(dense(x, w), tp.mesh)


def swiglu(tp, x, f):
    """The SwiGLU FFN ``f`` ({w_gate, w_up, w_down}): gate and up column-cut,
    down row-cut, one sum over 'model' and no gather."""
    (g, u), cut = columns(tp, x, f, ("w_gate", "w_up"), gather=False)
    return row(tp, F.silu(g) * u, f, "w_down", x_block=cut)


def embed(tp, params, ids):
    """The embedding lookup of token ids over a vocabulary cut: the rank's
    rows, zero for ids it does not own, summed over 'model'."""
    w, d = tp.use(params, "embed")
    ids = ids.long()
    if d is None:
        return w[ids]
    if d != 0:
        raise ValueError(f"embed cut on dim {d}; expected the vocabulary (0)")
    rows = w.shape[0]
    local = ids - tp.mesh.coord(MODEL) * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], w[local.clamp(0, rows - 1)], torch.zeros((), dtype=w.dtype,
                                                                            device=w.device))
    return coll.reduce_from(x, tp.mesh)


def logits(tp, params, x, tied: bool):
    """``x @ W`` over the vocabulary, W the tied embedding's transpose or
    ``lm_head``, in the promoted dtype of x and W (``models/model.unembed``):
    where the vocabulary is cut, the rank's block of columns, gathered."""
    key = "embed" if tied else "lm_head"
    w, d = tp.use(params, key)
    if tied:
        w, d = w.T, (None if d is None else 1 - d)
    dt = torch.promote_types(x.dtype, w.dtype)
    if d is None:
        return x.to(dt) @ w.to(dt)
    if d != 1:
        raise ValueError(f"{key} cut over 'model' on the model dim; expected the vocabulary")
    y = coll.copy_to(x, tp.mesh).to(dt) @ w.to(dt)
    return coll.gather_cols(y, tp.mesh, MODEL, -1)
