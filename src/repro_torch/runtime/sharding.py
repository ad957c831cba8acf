"""Sharding rules (counterpart of ``repro/runtime/sharding.py``).

The reference's rules, term for term, with a placement written as a tuple
of axis names, one entry per dimension (None: not sharded; a name or a
tuple of names: the dimension is cut over those mesh axes), where the
reference writes a ``PartitionSpec``. The mesh is anything with ``shape``
({axis: size}) and ``axis_names``: a ``launch/mesh.Mesh`` of ranks, or a
JAX mesh in the tests. A leaf's path is written as
``jax.tree_util.keystr`` writes it (``core/tree.py``), so the rules match
the same substrings as the reference's.

Serve-cache layouts: ``head`` shards kv heads over 'model' and the batch
over 'data'; ``coplace`` the page dimension over 'model'; ``interleave``
the pages over 'model' and, when the batch cannot take 'data', the
within-page tokens over 'data'. Each layout owns its paged-cache leaf
axes (``core/layouts.py``, ``cache_axes``); this module turns them into
placements, drops an axis that does not divide its dimension (``_div``:
the leaf is then replicated along it), and places the layout-independent
leaves (the streaming ring's heads over 'model' in every layout).

The engine's full caches (gemma3's window layers, every layer with
H²EAL off) take the reference's rule: rows over the batch axes, kv heads
over 'model' where they divide. A recurrent layer's state departs from
the reference's ``_cache_leaf_spec``, which also cuts its heads and
channels over 'model': the port's engine places it by
``recurrent_leaf_spec``, rows over the batch axes and whole over 'model',
because every mamba2 head reads the whole ``conv_B`` / ``conv_C`` output
of its token and the state is constant-size a slot, so cutting it saves
little and would gather inside every recurrent step. ``_cache_leaf_spec``
stays the reference's copy.

``local_block`` cuts a full leaf into this rank's tile, contiguous tiles
in axis order as a ``NamedSharding`` tiles; ``block_bounds`` gives the
tile's (start, stop) per dimension. ``place_params`` applies
``param_shardings`` to a parameter tree (each rank keeps its blocks, as
the reference's ``jit_serve_steps`` / ``jit_train_step`` place theirs), and
``gather_tree`` puts the whole leaves back together (checkpoints, tests).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import tree as treelib

# params whose (p, m, v) f32 optimizer footprint fits TP-only per device
# skip FSDP, as in the reference
FSDP_BYTES_THRESHOLD = 8e9


def batch_axes(mesh):
    """Axes for the global-batch dim: ('pod', 'data') when pod exists."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axes(a) -> tuple:
    return () if a is None else (a if isinstance(a, tuple) else (a,))


def _size(mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in _axes(axes)]))


def _div(n: int, mesh, axes) -> bool:
    if axes is None:
        return True
    return n % _size(mesh, axes) == 0


def _spec_for_param(path: str, shape, mesh, stacked: bool, mode: str = "train",
                    fsdp_on: bool = True) -> tuple:
    """Placement of a parameter leaf. train/opt: weights 2D, FSDP 'data' x
    TP 'model'; serve: TP-only over 'model', MoE experts 2D (E over 'data',
    d over 'model'). The port's engine keeps its parameters replicated, as
    the reference's does; lockstep ``generate(mesh=...)`` and the sharded
    train step cut them by these rules (``place_params``)."""
    inner = shape[1:] if stacked else shape
    fsdp = "data" if (mode in ("train", "opt") and fsdp_on) else None

    def build(*axes):
        axes = list(axes) + [None] * (len(inner) - len(axes))
        axes = [a if _div(inner[i], mesh, a) else None for i, a in enumerate(axes)]
        if stacked:
            axes = [None] + axes
        return tuple(axes)

    if "embed" in path:
        return build("model", None)
    if "lm_head" in path:
        return build(fsdp, "model")
    if "w_gate" in path or "w_up" in path:
        if len(inner) == 3:
            return (build("model", "data", None) if mode in ("train", "opt")
                    else build("data", "model", None))
        return build(fsdp, "model")
    if "w_down" in path:
        if len(inner) == 3:
            return (build("model", None, "data") if mode in ("train", "opt")
                    else build("data", None, "model"))
        return build("model", fsdp)
    if "router" in path:
        return build(fsdp, None)
    if any(k in path for k in ("wq", "wk", "wv", "w_qkv", "w_o", "w_if",
                               "in_proj", "['w']", "w_z", "w_x", "w_B",
                               "w_C", "w_dt")):
        return build(fsdp, "model")
    if any(k in path for k in ("wo", "out_proj")):
        return build("model", fsdp)
    if "conv_w" in path or "['conv_x']" in path or "['conv_B']" in path \
            or "['conv_C']" in path:
        return build(None, "model")
    if "['r']" in path:  # slstm recurrent (h, p, 4p)
        return build("model", None, None)
    if any(k in path for k in ("bq", "bk", "bv", "b_if")):
        return build("model")
    return build(*([None] * len(inner)))


def param_shardings(cfg, mesh, params, mode: str = "train"):
    """A tree shaped like ``params`` (nested dicts and lists whose leaves
    have ``shape``) of each leaf's placement. A leaf under ``['blocks']``
    is scan-stacked (the reference's layer-stacked trees)."""
    fsdp_on = True
    if mode in ("train", "opt") and cfg is not None:
        fsdp_on = cfg.param_count() * 12 / mesh.shape["model"] > FSDP_BYTES_THRESHOLD
    flat = [_spec_for_param(p, tuple(leaf.shape), mesh, "['blocks']" in p, mode,
                            fsdp_on)
            for p, leaf in treelib.leaves_with_paths(params)]
    return treelib.unflatten(params, flat)


def batch_sharding(mesh, batch_size: int) -> tuple:
    """Placement of (B, ...) input batches: B over (pod, data) if divisible."""
    ax = batch_axes(mesh)
    if batch_size % _size(mesh, ax) == 0:
        return (ax,)
    if "data" in mesh.axis_names and batch_size % mesh.shape["data"] == 0:
        return ("data",)
    return ()


def _cache_leaf_spec(path: str, shape, mesh, layout_obj, batch_ok: bool,
                     stacked: bool) -> tuple:
    inner = shape[1:] if stacked else shape
    nd = len(inner)
    b_ax = batch_axes(mesh) if batch_ok else None

    def build(*axes):
        axes = (list(axes) + [None] * nd)[:nd]
        axes = [b_ax if a == "batch" else a for a in axes]
        axes = [a if _div(inner[i], mesh, a) else None for i, a in enumerate(axes)]
        if stacked:
            axes = [None] + axes
        return tuple(axes)

    h_ax = "model"
    if "k_pages" in path or "v_pages" in path:      # (B, Hr, C, P, D)
        return build(*layout_obj.cache_axes("pages", batch_ok=batch_ok))
    if "tau_min" in path or "tau_max" in path:      # (B, Hr, C, D)
        return build(*layout_obj.cache_axes("tau", batch_ok=batch_ok))
    if "importance" in path or "page_start" in path:  # (B, Hr, C)
        return build(*layout_obj.cache_axes("meta", batch_ok=batch_ok))
    if "sel_idx" in path:                            # (B, Hr, K)
        return build(b_ax, None, None)
    if path.endswith(".k") or path.endswith(".v"):   # stream/full (B,H,T,D)
        return build(b_ax, h_ax, None, None)
    if "['ssm']" in path:                            # (B, H, N, P) state
        return build(b_ax, "model", None, None)
    if any(k in path for k in ("['conv']", "['conv_x']", "['conv_B']",
                               "['conv_C']")):                 # (B, K, C)
        return build(b_ax, None, "model")
    if "['C']" in path:                              # mlstm (B,H,P,P)
        return build(b_ax, "model", None, None)
    if path.endswith(".pos"):                        # stream ring (B, Hs, W)
        return build(b_ax, h_ax, None)
    if any(path.endswith(k) for k in ("['n']", "['m']", "['h']", "['c']")):
        return build(b_ax, "model")
    return build(*([None] * nd))


def recurrent_leaf_spec(shape, mesh, batch_ok: bool) -> tuple:
    """Placement of a recurrent state leaf (B, ...) on the port's GSPMD
    layouts: the rows over the batch axes where they divide, every other
    dimension whole (see the module docstring for the departure)."""
    b_ax = batch_axes(mesh) if batch_ok else None
    return ((b_ax if _div(shape[0], mesh, b_ax) else None),) + (None,) * (len(shape) - 1)


def resolve_state_layout(mesh, layout, batch_size):
    """(layout name, batch_ok): ``layout=None`` keeps the reference's
    pre-registry auto rule, interleave when the batch cannot fill (pod x
    data), head otherwise."""
    from repro_torch.core import layouts as layoutlib

    dp = _size(mesh, batch_axes(mesh))
    if layout is None:
        layout = (layoutlib.LAYOUT_INTERLEAVE
                  if (batch_size is not None and batch_size < dp)
                  else layoutlib.LAYOUT_HEAD)
    return layout, batch_size is None or batch_size % dp == 0


def _state_leaves(state, prefix=""):
    """(path, tensor) of a serve state as ``keystr`` writes the reference's:
    dicts and lists by key, the cache dataclasses (``PagedCache``,
    ``StreamCache``, ``FullCache``) by ``.field``; a recurrent state, a dict
    in the reference, by ``['field']``."""
    from repro_torch.core import cache as cachelib

    if isinstance(state, dict):
        out = []
        for k in sorted(state):
            out += _state_leaves(state[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(state, (list, tuple)):
        out = []
        for i, v in enumerate(state):
            out += _state_leaves(v, f"{prefix}[{i}]")
        return out
    if dataclasses.is_dataclass(state):
        attr = isinstance(state, (cachelib.PagedCache, cachelib.StreamCache,
                                  cachelib.FullCache))
        return [(f"{prefix}.{f.name}" if attr else f"{prefix}[{f.name!r}]",
                 getattr(state, f.name)) for f in dataclasses.fields(state)]
    return [(prefix, state)]


def leaf_shardings(mesh, leaves, *, layout: str | None = None,
                   batch_size: int | None = None) -> list:
    """The placement of each serve-state leaf of ``leaves``, [(path, shape)]
    with paths written as ``keystr`` writes the reference's: the lengths and
    scalars replicated, a leaf under ``['blocks']`` scan-stacked. ``layout``
    is resolved through the ``core/layouts`` registry (unknown names raise
    with the registered list); None keeps the reference's auto rule
    (``resolve_state_layout``)."""
    from repro_torch.core import layouts as layoutlib

    layout, batch_ok = resolve_state_layout(mesh, layout, batch_size)
    lay = layoutlib.get_layout(layout)
    out = []
    for path, shape in leaves:
        if "length" in path or len(shape) == 0:
            out.append(())
        else:
            out.append(_cache_leaf_spec(path, tuple(shape), mesh, lay, batch_ok,
                                        "['blocks']" in path))
    return out


def state_shardings(cfg, mesh, state, *, layout: str | None = None,
                    batch_size: int | None = None):
    """[(path, placement)] of every tensor of a serve state (the port's,
    whose ``length`` may be a Python int), in the order of
    ``_state_leaves``."""
    del cfg  # the reference's rules read the leaves' shapes alone
    leaves = [(p, tuple(getattr(x, "shape", ()))) for p, x in _state_leaves(state)]
    return list(zip([p for p, _ in leaves],
                    leaf_shardings(mesh, leaves, layout=layout,
                                   batch_size=batch_size)))


def block_bounds(shape, spec: tuple, mesh) -> Tuple[Tuple[int, int], ...]:
    """This rank's tile of a leaf of ``shape`` placed by ``spec``: (start,
    stop) per dimension. A dimension cut over axes (a1, a2, ...) splits into
    size(a1)·size(a2)·... contiguous tiles, the rank's tile index being its
    coordinates read with a1 most significant, as ``NamedSharding`` tiles."""
    out = []
    for i, n in enumerate(shape):
        axes = _axes(spec[i]) if i < len(spec) else ()
        k, idx = 1, 0
        for a in axes:
            k *= mesh.shape[a]
            idx = idx * mesh.shape[a] + mesh.coord(a)
        if n % k:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not divide "
                             f"over {axes}")
        out.append((idx * (n // k), (idx + 1) * (n // k)))
    return tuple(out)


def local_block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's tile of the full leaf ``x`` (a view)."""
    return x[tuple(slice(a, b) for a, b in block_bounds(x.shape, spec, mesh))]


def local_tree(tree, specs, mesh):
    """``local_block`` over a tree of tensors and the matching tree of
    placements."""
    return treelib.tree_map(lambda x, s: local_block(x, s, mesh), tree, specs)


def place_params(cfg, mesh, params, mode: str):
    """(the rank's blocks of ``params``, the spec tree): each leaf cut by
    ``param_shardings(cfg, mesh, params, mode)``, its block a tensor of its
    own (the whole leaves can be freed)."""
    specs = param_shardings(cfg, mesh, params, mode)
    blocks = treelib.tree_map(lambda x, s: local_block(x, s, mesh).contiguous().clone()
                              if _cut_axes(s, mesh) else x, params, specs)
    return blocks, specs


def spec_leaves(tree, specs) -> list:
    """The placements of ``leaves(tree)``, in that order (a placement is a
    tuple, which the tree functions would walk into)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [s for t, sp in zip(tree, specs) for s in spec_leaves(t, sp)]
    return [specs]


def _cut_axes(spec: tuple, mesh) -> tuple:
    """The axes of more than one rank that cut a leaf placed by ``spec``."""
    return tuple(a for entry in spec for a in _axes(entry) if mesh.shape[a] > 1)


def gather_tree(tree, specs, mesh):
    """The whole leaves of a tree of blocks placed by ``specs``, on every
    rank; a leaf that nothing cuts is returned as it is."""
    from repro_torch.runtime import collectives as coll

    def whole(x, spec):
        for dim, entry in enumerate(spec):
            for a in reversed(_axes(entry)):
                x = coll.gather(x, mesh, a, dim)
        return x
    return treelib.tree_map(whole, tree, specs)
