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

The recurrent mixers take the same route (``project``, ``whole_leaves``,
``out_row``): mamba2's ``w_z`` / ``w_x`` / ``w_B`` / ``w_C`` / ``w_dt`` and
xLSTM's ``w_qkv`` / ``w_if`` / ``w_o`` / ``['w']`` are column-cut, and a
column cut of a concatenated projection does not fall on its parts'
boundaries (``w_if`` is [i | f]: at 'model' = 2 one rank holds every i
gate, the other every f gate), so their outputs are gathered whole; the
small leaves cut over 'model' (the convs' channels, ``b_if``, the sLSTM's
recurrent ``['r']``) are gathered once a call, never inside a per-token
loop; the mixer runs whole (mamba2's gated RMSNorm spans the whole inner
dim) and ``out_proj`` is row-cut.

A MoE layer (``experts``) is expert parallel: the expert dim E of
``w_gate`` / ``w_up`` / ``w_down`` is cut over 'data' at serve (the
reference keeps kimi-k2's experts resident so) and over 'model' in
training, where their inner dims are FSDP over 'data' and gathered at use;
E is never gathered. Each rank fills and runs only its experts' rows of
the (E, cap, d) buffer, the serve rule's d over 'model' as a row product
(``w_gate`` / ``w_up``) and a column product (``w_down``), and the buffer's
outputs are gathered over E, so the combine runs in the unsharded order.
Routing and capacity need the whole token set: where the activations are
the rank's rows of the batch (``batch_cut``, the train step), the tokens
are gathered over 'data' first and the rank's rows taken back after.

"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense
from repro_torch.runtime import collectives as coll
from repro_torch.runtime.sharding import _axes

MODEL, DATA = "model", "data"


def check_config(cfg) -> None:
    """Raise for a config that the tensor-parallel paths do not serve or
    train: a frontend stub (the GSPMD layouts' refusal). Every other family
    runs on a mesh: dense, MoE, the recurrent mixers, local:global."""
    from repro_torch.core import layouts as layoutlib

    layoutlib.check_gspmd_config(cfg)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's view of a placed parameter (sub)tree: ``specs`` is the
    matching subtree of ``param_shardings``. ``batch_cut``: the activations
    are the rank's rows of the batch over 'data' (the sharded train step);
    False where every rank holds the whole batch (lockstep serving)."""

    mesh: Any
    specs: Any
    batch_cut: bool = False

    def at(self, *keys) -> "TensorParallel":
        """The view of a subtree (``tp.at("layers", i)``)."""
        s = self.specs
        for k in keys:
            s = s[k]
        return TensorParallel(self.mesh, s, self.batch_cut)

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

    def whole(self, p, key: str):
        """Leaf ``key`` whole on every rank: its 'data' cuts gathered (FSDP),
        its 'model' cut gathered (backward, the rank's block of a gradient
        that is the same on every 'model' rank)."""
        w, d = self.use(p, key)
        return w if d is None else coll.gather_cols(w, self.mesh, MODEL, d)


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


def project(tp, x, p, keys):
    """``[dense(x, p[k]) for k in keys]``, whole; over a mesh (``tp``) each
    a column product gathered."""
    if tp is None:
        return [dense(x, p[k]) for k in keys]
    return columns(tp, x, p, keys, gather=True)[0]


def whole_leaves(tp, p, keys):
    """``p`` with the leaves ``keys`` whole (``TensorParallel.whole``): the
    small leaves a mixer reads whole, gathered once a call."""
    return p if tp is None else dict(p, **{k: tp.whole(p, k) for k in keys})


def out_row(tp, y, p, key: str):
    """``dense(y, p[key])`` of a whole ``y``; over a mesh the row product."""
    return dense(y, p[key]) if tp is None else row(tp, y, p, key)


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


def gather_rows(tp, x):
    """The whole batch's rows of ``x`` (the rank's rows over 'data' where
    ``tp.batch_cut``; backward, the rank's rows of the gradient), and the
    function that takes the rank's rows back of a whole-batch result
    (backward, zero elsewhere): the whole token set routes as one."""
    if tp is None or not tp.batch_cut or tp.mesh.shape[DATA] == 1:
        return x, lambda y: y
    n = x.shape[0]
    first = tp.mesh.coord(DATA) * n
    return coll.gather_cols(x, tp.mesh, DATA, 0), lambda y: y.narrow(0, first, n)


def _expert_axis(tp, keys) -> Any:
    """The axis cutting the expert dim E of the leaves ``keys`` (one for
    all of them), or None."""
    axes = set()
    for k in keys:
        a = _axes(tp.specs[k][0])
        if len(a) > 1:
            raise ValueError(f"{k}: E cut over {a}; expected one axis")
        axes.add(a[0] if a and tp.mesh.shape[a[0]] > 1 else None)
    if len(axes) != 1:
        raise ValueError(f"the experts' leaves {keys} cut E over {axes}")
    return axes.pop()


def _expert_leaf(tp, p, key):
    """An expert leaf (E, d_in, d_out) as the product uses it: the rank's
    experts, its 'data' cuts of d_in / d_out gathered (FSDP), and the dim
    still cut over 'model' (1, 2 or None)."""
    w = p[key]
    model = None
    for d, entry in enumerate(tp.specs[key]):
        axes = _axes(entry)
        if d == 0 or not axes:
            continue
        if len(axes) > 1:
            raise ValueError(f"{key}: dim {d} is cut over {axes}")
        if axes[0] == DATA:
            w = coll.fsdp_gather(w, tp.mesh, d)
        elif tp.mesh.shape[axes[0]] > 1:
            model = d
    return w, model


def _expert_bmm(tp, x, p, key, dtype):
    """``bmm(x, W)`` over the rank's experts: W's input dim cut over 'model'
    as a row product (the rank's feature block of x, summed over 'model'),
    its output dim as a column product (gathered)."""
    w, d = _expert_leaf(tp, p, key)
    w = w.to(dtype)
    if d is None:
        return torch.bmm(x, w)
    if d == 1:
        return coll.reduce_from(torch.bmm(coll.split(x, tp.mesh, MODEL, -1), w), tp.mesh)
    return coll.gather_cols(torch.bmm(coll.copy_to(x, tp.mesh), w), tp.mesh, MODEL, -1)


def experts(tp, x, src, fill, p):
    """The experts' SwiGLU over the (E, cap, d) dispatch buffer of the
    tokens ``x`` (T, d): slot (e, c) holds row ``src[e, c]`` of x where
    ``fill[e, c]``, zeros elsewhere. Each rank builds and runs only its
    experts' rows of the buffer (E cut over 'data' at serve, over 'model'
    in training); the outputs are gathered over E: (E, cap, d), the same on
    every rank. The tokens enter by ``copy_to`` over the expert axis (their
    gradient summed over it: each rank's experts see their own entries)."""
    keys = ("w_gate", "w_up", "w_down")
    ax = _expert_axis(tp, keys)
    e, cap = src.shape
    if ax is not None:
        n = tp.mesh.shape[ax]
        lo = tp.mesh.coord(ax) * (e // n)
        src, fill = src[lo:lo + e // n], fill[lo:lo + e // n]
        x = coll.copy_to(x, tp.mesh, ax)
    buf = x.index_select(0, src.reshape(-1)).view(src.shape[0], cap, x.shape[-1])
    buf = torch.where(fill[..., None], buf, 0.0)
    g = _expert_bmm(tp, buf, p, "w_gate", x.dtype)
    u = _expert_bmm(tp, buf, p, "w_up", x.dtype)
    y = _expert_bmm(tp, F.silu(g) * u, p, "w_down", x.dtype)
    return y if ax is None else coll.gather_cols(y, tp.mesh, ax, 0)
