"""Serve-cache layouts (counterpart of ``repro/core/layouts.py``).

Every layout is an entry in a registry, resolved by name (placement is
data, not control flow); unknown names raise with the registered list.

  default        the single-program §IV-A algorithm, the token-exactness
                 oracle every other layout is held to;
  head           GSPMD baseline head parallelism: kv heads over 'model',
                 the batch over 'data' (paper Fig 3a);
  coplace        GSPMD memory-compute co-placement: the page dimension over
                 'model' in contiguous blocks (paper §IV-B);
  interleave     co-placement with interleaved storage: pages over 'model'
                 and, where the batch cannot take 'data', the within-page
                 tokens over 'data' (paper Fig 7b);
  coplace_shmap  co-placement with the pages striped: the JAX layout
                 stripes the physical pages round-robin over the mesh's
                 'model' axis and runs one shard_map program per device.
                 Without a mesh that axis is a stripe axis of one tensor,
                 of ``shards`` stripes, and decode is split-KV over the
                 stripes (``hybrid_attention.decode_attention_coplace``); on
                 a mesh each rank of 'model' holds its stripe, as each
                 device does in the reference (``CoplaceShmapRanks``).

The three GSPMD layouts run over the ranks of a ``launch/mesh.Mesh``, one
process a device. Their ``plan`` is the reference's (capacity rounded to
whole pages per 'model' rank for the layouts that shard pages, the mesh
validated, the balance shards), and ``cache_axes`` the reference's leaf
axes, which ``runtime/sharding.py`` turns into each rank's block.
``placed(mesh, batch, capacity)`` binds a GSPMD layout to one rank: that
object places every kind of layer (``place``: H²EAL paged and streaming
caches, full caches, recurrent states), allocates the rank's blocks and
runs the decode, chunk and speculative verify steps on them
(``hybrid_attention.decode_attention_placed`` and its siblings, the full
caches' ``full_decode_attention_placed`` / ``full_chunk_attention_placed``,
a recurrent layer on the rank's rows through ``rows``), gathering where
GSPMD would; a rank that holds every page or row runs the default's
kernels. Without a process group the mesh is the one-rank (1, 1) mesh of
the caller's device, the reference's default mesh over its one device.
``coplace_shmap`` given a mesh (``get_layout(name, shards, mesh)``) is
served the same way: ``coplace``'s plan and placement with the pages in
the striped physical order, so that rank r of 'model' holds stripe r.

Lockstep ``generate(mesh=...)`` (the reference's ``jit_serve_steps``)
serves a batch as the engine's batched state with every row active at
equal lengths: ``mesh_layout`` places each layout on the mesh, ``default``
too (``DefaultRanks``: the default's leaf axes, so the batch rows lie over
'data'), and the whole prefill cache is cut into each rank's block
(``PlacedLayout.cut``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import cache as cachelib
from repro_torch.core import hybrid_attention as hattn

LAYOUT_DEFAULT = "default"
LAYOUT_HEAD = "head"
LAYOUT_COPLACE = "coplace"
LAYOUT_INTERLEAVE = "interleave"
LAYOUT_COPLACE_SHMAP = "coplace_shmap"

# pre-registry spellings, resolved with a one-shot DeprecationWarning each
_ALIASES = {None: LAYOUT_DEFAULT, "auto": LAYOUT_DEFAULT}
_warned_aliases: set = set()

@dataclasses.dataclass(frozen=True)
class LayoutPlan:
    """What the serving engine needs to know before the first step.

    mesh                the resolved mesh of a GSPMD layout (None: no mesh).
    capacity_quantum    the cache capacity (tokens) rounds up to a multiple
                        of this (a whole number of pages per stripe or rank).
    shard_state         each rank holds only its block of the serve state.
    balance_shards      the shard count ``admission="balanced"`` scores page
                        loads against (1: FIFO).
    page_stripe_shards  the physical page striping factor (1: physical
                        page order is logical page order).
    """

    layout: str
    mesh: Any = None
    capacity_quantum: int = 1
    shard_state: bool = False
    balance_shards: int = 1
    page_stripe_shards: int = 1

    def round_capacity(self, tokens: int) -> int:
        q = max(int(self.capacity_quantum), 1)
        return -(-int(tokens) // q) * q


class DefaultLayout:
    """Single-program path: no striping, no mesh."""

    name = LAYOUT_DEFAULT
    shards = 1
    #: pages are distributed: balanced admission has an effect
    shards_pages = False
    #: a GSPMD placement over the ranks of a mesh
    gspmd = False

    def plan(self, cfg, mesh=None) -> LayoutPlan:
        del cfg  # the default plan depends on no configuration
        return LayoutPlan(layout=self.name, mesh=mesh)

    def cache_axes(self, kind: str, *, batch_ok: bool) -> Tuple:
        """Axis names of a paged-cache leaf ("batch" resolved by
        ``runtime/sharding``): kind "pages" (B,Hr,C,P,D), "tau" (B,Hr,C,D)
        or "meta" (B,Hr,C)."""
        nd = {"pages": 5, "tau": 4, "meta": 3}[kind]
        return ("batch",) + (None,) * (nd - 1)

    def empty_decode_state(self, spec, batch: int, capacity: int, *, dtype, device):
        """The empty (PagedCache, StreamCache) of ``batch`` slots."""
        return hattn.empty_decode_state(spec, batch, capacity, dtype=dtype,
                                        device=device)

    def full_decode(self, spec, cache, q, k_new, v_new, length, active=None):
        """Decode step of a full-cache layer -> (out (B, Hq, D), cache)."""
        return hattn.full_decode_attention(spec, q, k_new, v_new, cache, length, active)

    def full_chunk(self, spec, cache, q, k_new, v_new, start, chunk_len, active):
        """Chunk step of a full-cache layer -> (out (B, C, Hq, D), cache)."""
        return hattn.full_chunk_attention(spec, q, k_new, v_new, cache, start, chunk_len,
                                          active)

    def rows(self, spec, fn, *xs):
        """``fn(*xs)`` of a recurrent layer of ``spec`` over the batch rows
        this layout's state holds, its output of the whole batch: here every
        row. ``xs`` are (B, ...) tensors or None."""
        del spec
        return fn(*xs)

    def prefill(self, spec, k, v, length: int, capacity: int, perm=None) -> Dict:
        """Build the decode state {"paged", "stream"} from prefill K/V."""
        paged, stream = hattn.init_decode_state(spec, k, v, length, capacity,
                                                perm,
                                                interleave_shards=self.shards)
        return {"paged": paged, "stream": stream}

    def prefill_chunk(self, spec, state: Dict, q, k_new, v_new, start,
                      chunk_len, active, perm=None):
        """Chunked prefill: attend one prompt chunk per slot and append it
        into the slots' caches -> (out (B, C, Hq, D), state)."""
        out, paged, stream = hattn.chunk_prefill_attention(
            spec, q, k_new, v_new, state["paged"], state["stream"], start,
            chunk_len, active, perm=perm, phys_shards=self.shards)
        return out, {"paged": paged, "stream": stream}

    def decode(self, spec, state: Dict, q, k_new, v_new, length, *,
               do_select: bool, perm=None, active=None, need_select=None):
        """Decode step, lockstep (int ``length``) or ragged ((B,) lengths,
        ``active``, ``need_select``) -> (out (B, Hq, D), state)."""
        out, paged, stream = hattn.decode_attention(
            spec, q, k_new, v_new, state["paged"], state["stream"], length,
            do_select=do_select, perm=perm, active=active,
            need_select=need_select)
        return out, {"paged": paged, "stream": stream}

    # the co-placed decode turns a selected masked page into -1; the
    # default keeps it as fill. The verify chunk selects as the decode does
    minus_one_masked = False

    def verify_chunk(self, spec, state: Dict, q, k_new, v_new, start, *,
                     active=None, need_select=None, perm=None):
        """Attend k drafted tokens as k decode steps over the pre-append
        caches (no KV write; the selection and importance refresh only) ->
        (out (B, k, Hq, D), state). One body for every layout: its masks
        come from absolute positions and page starts, and the fixed page
        sections follow the layout's physical page order."""
        out, paged, stream = hattn.chunk_verify_attention(
            spec, q, k_new, v_new, state["paged"], state["stream"], start,
            active, need_select, perm=perm, phys_shards=self.shards,
            minus_one_masked=self.minus_one_masked)
        return out, {"paged": paged, "stream": stream}

    def verify_append(self, spec, state: Dict, k_new, v_new, start, accepted, *,
                      active=None, perm=None):
        """Commit the accepted prefix of a verified chunk (the chunk
        appends) -> state."""
        paged, stream = hattn.chunk_verify_append(
            spec, k_new, v_new, state["paged"], state["stream"], start, accepted,
            active, perm=perm, phys_shards=self.shards)
        return {"paged": paged, "stream": stream}

    def decode_window(self, body, carry, xs, *, length: int):
        """Run ``length`` reuse decode steps as one fused window, the
        counterpart of the reference's ``lax.scan``: ``body(carry, x) ->
        (carry, y)`` takes ``x``, the i-th slice of every tensor of ``xs``
        (a tensor, a tuple of tensors, or None), and the per-iteration
        ``y`` are stacked. Returns (carry, stacked ys). ``body``'s decode
        math routes through this layout's own hooks, so a plain loop is
        right for every layout; a layout overrides this only to change how
        the window iterates, never the step math."""
        ys = []
        for i in range(length):
            if xs is None:
                x = None
            elif isinstance(xs, torch.Tensor):
                x = xs[i]
            else:
                x = tuple(a[i] for a in xs)
            carry, y = body(carry, x)
            ys.append(y)
        return carry, torch.stack(ys)


class CoplaceShmapLayout(DefaultLayout):
    """Co-placement over ``shards`` page stripes: striped page order at
    prefill and on chunk appends, split-KV partial attention per stripe and
    a log-sum-exp combine in decode."""

    name = LAYOUT_COPLACE_SHMAP
    shards_pages = True
    minus_one_masked = True

    def __init__(self, shards: int = 1):
        self.shards = int(shards)

    def plan(self, cfg, mesh=None) -> LayoutPlan:
        # the stripes stand for the mesh's 'model' axis; a mesh of ranks
        # takes ``CoplaceShmapRanks`` (``get_layout(name, shards, mesh)``)
        if mesh is not None:
            raise ValueError("coplace_shmap over S stripes of one card takes no mesh: "
                             "get_layout('coplace_shmap', shards, mesh) places it on "
                             "the mesh's ranks")
        return LayoutPlan(layout=self.name,
                          capacity_quantum=cfg.h2eal.page_size * self.shards,
                          balance_shards=self.shards,
                          page_stripe_shards=self.shards)

    def cache_axes(self, kind: str, *, batch_ok: bool) -> Tuple:
        nd = {"pages": 5, "tau": 4, "meta": 3}[kind]
        return ("batch", None, "model") + (None,) * (nd - 3)

    def decode(self, spec, state: Dict, q, k_new, v_new, length, *,
               do_select: bool, perm=None, active=None, need_select=None):
        out, paged, stream = hattn.decode_attention_coplace(
            spec, q, k_new, v_new, state["paged"], state["stream"], length,
            do_select=do_select, shards=self.shards, perm=perm, active=active,
            need_select=need_select)
        return out, {"paged": paged, "stream": stream}


class _GspmdLayout(DefaultLayout):
    """Shared base of the GSPMD layouts: the decode math is the default
    body's; the layout lives in ``plan`` and ``cache_axes``, and a rank runs
    it on its blocks through ``placed``."""

    gspmd = True

    def _default_mesh(self, cfg):
        from repro_torch.launch.mesh import Mesh

        del cfg
        return Mesh()

    def _validate_mesh(self, mesh, axes=("model",)):
        missing = [a for a in axes if a not in mesh.axis_names]
        if missing:
            raise ValueError(
                f"layout {self.name!r} requires a mesh with axis(es) "
                f"{missing} (got {tuple(mesh.axis_names)})")
        return mesh

    def plan(self, cfg, mesh=None) -> LayoutPlan:
        mesh = self._validate_mesh(mesh if mesh is not None
                                   else self._default_mesh(cfg))
        nsh = int(mesh.shape["model"])
        quantum = (cfg.h2eal.page_size * nsh if self.shards_pages else 1)
        return LayoutPlan(layout=self.name, mesh=mesh,
                          capacity_quantum=quantum, shard_state=True,
                          balance_shards=nsh if self.shards_pages else 1)

    def placed(self, mesh, *, batch: int, capacity: int) -> "PlacedLayout":
        """This layout on one rank of ``mesh``, for a batched state of
        ``batch`` slots and ``capacity`` tokens."""
        return PlacedLayout(self, mesh, batch=batch, capacity=capacity)

    def page_stripes(self, mesh) -> int:
        """The stripes of the physical page order on ``mesh`` (1: logical)."""
        del mesh
        return 1


class DefaultRanks(_GspmdLayout):
    """The default layout placed on the ranks of a mesh, for lockstep
    ``generate(mesh=...)``: the default's leaf axes, the batch over 'data'
    where it divides (the reference's ``state_shardings`` under
    ``layout="default"``; its streaming ring and full caches cut their kv
    heads over 'model', as every layout's do). The engine serves ``default``
    unplaced, whatever mesh it is given."""

    name = LAYOUT_DEFAULT
    shards_pages = False

    def cache_axes(self, kind: str, *, batch_ok: bool) -> Tuple:
        return DefaultLayout.cache_axes(self, kind, batch_ok=batch_ok)


class HeadLayout(_GspmdLayout):
    """Baseline head parallelism (paper Fig 3a): kv heads over 'model', the
    batch over 'data'. No page distribution, so balanced admission is a
    no-op here."""

    name = LAYOUT_HEAD
    shards_pages = False

    def cache_axes(self, kind: str, *, batch_ok: bool) -> Tuple:
        nd = {"pages": 5, "tau": 4, "meta": 3}[kind]
        return ("batch", "model") + (None,) * (nd - 2)


class CoplaceLayout(_GspmdLayout):
    """Memory-compute co-placement (paper §IV-B): the page dimension over
    'model', so each rank holds whole pages of every head."""

    name = LAYOUT_COPLACE
    shards_pages = True

    def cache_axes(self, kind: str, *, batch_ok: bool) -> Tuple:
        nd = {"pages": 5, "tau": 4, "meta": 3}[kind]
        return ("batch", None, "model") + (None,) * (nd - 3)


class InterleaveLayout(CoplaceLayout):
    """Co-placement with interleaved storage (paper Fig 7b): pages over
    'model' and, where the batch cannot take 'data', the within-page tokens
    over 'data', so every page is striped across the data axis. τ, the page
    starts and the importance stay replicated, as in the reference."""

    name = LAYOUT_INTERLEAVE

    def plan(self, cfg, mesh=None) -> LayoutPlan:
        plan = super().plan(cfg, mesh)
        self._validate_mesh(plan.mesh, axes=("model", "data"))
        return plan

    def cache_axes(self, kind: str, *, batch_ok: bool) -> Tuple:
        if kind == "pages" and not batch_ok:
            return (None, None, "model", "data", None)
        if kind in ("tau", "meta"):
            return (None,) * {"tau": 4, "meta": 3}[kind]
        return super().cache_axes(kind, batch_ok=batch_ok)


class CoplaceShmapRanks(CoplaceLayout):
    """``coplace_shmap`` over the ranks of a mesh, the reference's layout: the
    plan and the placement of ``coplace`` (pages over 'model', the batch
    over 'data' where it divides), the physical pages striped round-robin
    over the M ranks of 'model' (``paging.interleave_slot``), so that the
    rank at 'model' coordinate r holds stripe r, the logical pages p with p
    % M == r; each rank appends, scores and attends its stripe, and the
    partials merge across ranks. ``shards`` must be 1 or M."""

    name = LAYOUT_COPLACE_SHMAP
    minus_one_masked = True

    def __init__(self, mesh, shards: int = 1):
        m = int(self._validate_mesh(mesh).shape["model"])
        if shards not in (1, m):
            raise ValueError(f"coplace_shmap on a mesh stripes its pages over the "
                             f"mesh's 'model' axis of {m} ranks: shards must be 1 "
                             f"or {m}, got {shards}")
        self.shards = m

    def plan(self, cfg, mesh=None) -> LayoutPlan:
        plan = super().plan(cfg, mesh)
        return dataclasses.replace(plan, page_stripe_shards=self.page_stripes(plan.mesh))

    def page_stripes(self, mesh) -> int:
        return int(mesh.shape["model"])


class PlacedLayout(DefaultLayout):
    """A GSPMD layout bound to one rank of ``mesh``: the rank's blocks of a
    batched state of ``batch`` slots and ``capacity`` tokens, and the
    decode, chunk and verify steps on them. Packed prefill builds the whole
    batch-1 state, replicated; ``pack_slot`` writes the rank's block of it."""

    gspmd = True

    def __init__(self, layout: _GspmdLayout, mesh, *, batch: int, capacity: int):
        self.layout = layout
        self.name = layout.name
        self.shards_pages = layout.shards_pages
        self.minus_one_masked = layout.minus_one_masked
        # the prefill stripes the pages as the placement orders them
        self.shards = layout.page_stripes(mesh)
        self.mesh = mesh
        self.batch = int(batch)
        self.capacity = int(capacity)
        self._places: Dict = {}

    def place(self, spec) -> cachelib.Placement:
        """The rank's block of every serve-cache leaf of a layer of ``spec``:
        an H²EAL ``AttnSpec`` (paged and streaming caches), a full-cache one
        (a window layer, or H²EAL off) or a recurrent layer's
        ``cache.RecurrentSpec``. One placement a kind of layer, kept."""
        if spec not in self._places:
            from repro_torch.runtime import sharding

            _, batch_ok = sharding.resolve_state_layout(self.mesh, self.name,
                                                        self.batch)
            recurrent = isinstance(spec, cachelib.RecurrentSpec)
            specs, shapes, bounds = {}, {}, {}
            for key, cache in _meta_cache(spec, self.batch, self.capacity).items():
                for f in dataclasses.fields(cache):
                    shape = tuple(getattr(cache, f.name).shape)
                    if recurrent:
                        s = sharding.recurrent_leaf_spec(shape, self.mesh, batch_ok)
                    else:
                        s = sharding._cache_leaf_spec(f"['{key}'].{f.name}", shape,
                                                      self.mesh, self.layout, batch_ok,
                                                      False)
                    specs[(key, f.name)] = s
                    shapes[(key, f.name)] = shape
                    bounds[(key, f.name)] = sharding.block_bounds(shape, s, self.mesh)
            place = cachelib.Placement(mesh=self.mesh, specs=specs, shapes=shapes,
                                       bounds=bounds,
                                       page=0 if recurrent else spec.h2.page_size,
                                       partials=False, stripes=self.shards,
                                       minus_one=self.minus_one_masked)
            if ("paged", "k_pages") in specs:
                split = any(place.cut("paged", "k_pages", d) for d in (2, 3))
                place = dataclasses.replace(place, partials=self.shards_pages and split)
            self._places[spec] = place
        return self._places[spec]

    def block(self, spec, whole: Dict, device) -> Dict:
        """The rank's block of the empty layer cache ``whole`` (a dict of
        cache containers of the whole batch, on the meta device) of a layer
        of ``spec``, allocated on ``device``."""
        place = self.place(spec)
        return {key: cachelib.block_of(c, key, place, device) for key, c in whole.items()}

    def empty_decode_state(self, spec, batch: int, capacity: int, *, dtype, device):
        if (batch, capacity) != (self.batch, self.capacity):
            raise ValueError(f"layout {self.name!r} was placed for {self.batch} slots "
                             f"of {self.capacity} tokens, not {batch} of {capacity}")
        paged, stream = hattn.empty_decode_state(spec, batch, capacity, dtype=dtype,
                                                 device="meta")
        got = self.block(spec, {"paged": paged, "stream": stream}, device)
        return got["paged"], got["stream"]

    def pack_slot(self, spec, big: Dict, small: Dict, slot: int) -> None:
        """Write the rank's block of the batch-1 prefill cache ``small`` into
        slot ``slot`` of the block ``big``, in place."""
        cachelib.pack_block_row(big, small, slot, self.place(spec))

    def reset_slot(self, spec, big: Dict, slot: int) -> None:
        cachelib.reset_block_row(big, slot, self.place(spec))

    def cut(self, spec, whole: Dict) -> Dict:
        """The rank's block of the whole layer cache ``whole`` of the placed
        batch (a lockstep prefill's), each field a tensor of its own."""
        place = self.place(spec)
        out = {}
        for key, c in whole.items():
            fields = {}
            for f in dataclasses.fields(c):
                t = getattr(c, f.name)
                if tuple(t.shape) != place.shapes[(key, f.name)]:
                    raise ValueError(f"{key}.{f.name} of shape {tuple(t.shape)}; layout "
                                     f"{self.name!r} was placed for "
                                     f"{place.shapes[(key, f.name)]}")
                fields[f.name] = cachelib._tile(t, place.bounds[(key, f.name)]).clone()
            out[key] = type(c)(**fields)
        return out

    def full_decode(self, spec, cache, q, k_new, v_new, length, active=None):
        return hattn.full_decode_attention_placed(spec, q, k_new, v_new, cache, length,
                                                  active, place=self.place(spec))

    def full_chunk(self, spec, cache, q, k_new, v_new, start, chunk_len, active):
        return hattn.full_chunk_attention_placed(spec, q, k_new, v_new, cache, start,
                                                 chunk_len, active,
                                                 place=self.place(spec))

    def rows(self, spec, fn, *xs):
        """``fn`` on the rank's rows of ``xs`` (the rows its block of the
        recurrent layer ``spec`` holds), its output gathered over the axes
        that cut them; a rank holding every row runs ``fn`` on the whole
        batch and gathers nothing."""
        place = self.place(spec)
        leaf = next(iter(place.bounds))
        b0, b1 = place.bounds[leaf][0]
        y = fn(*(None if x is None else x[b0:b1] for x in xs))
        return hattn._gather_dim(y, self.mesh, place.axes(*leaf, 0), 0)

    def prefill_chunk(self, spec, state: Dict, q, k_new, v_new, start,
                      chunk_len, active, perm=None):
        out, paged, stream = hattn.chunk_prefill_attention_placed(
            spec, q, k_new, v_new, state["paged"], state["stream"], start,
            chunk_len, active, place=self.place(spec), perm=perm)
        return out, {"paged": paged, "stream": stream}

    def decode(self, spec, state: Dict, q, k_new, v_new, length, *,
               do_select: bool, perm=None, active=None, need_select=None):
        out, paged, stream = hattn.decode_attention_placed(
            spec, q, k_new, v_new, state["paged"], state["stream"], length,
            do_select=do_select, place=self.place(spec), perm=perm, active=active,
            need_select=need_select)
        return out, {"paged": paged, "stream": stream}

    def verify_chunk(self, spec, state: Dict, q, k_new, v_new, start, *,
                     active=None, need_select=None, perm=None):
        out, paged, stream = hattn.chunk_verify_attention_placed(
            spec, q, k_new, v_new, state["paged"], state["stream"], start, active,
            need_select, place=self.place(spec), perm=perm)
        return out, {"paged": paged, "stream": stream}

    def verify_append(self, spec, state: Dict, k_new, v_new, start, accepted, *,
                      active=None, perm=None):
        paged, stream = hattn.chunk_verify_append_placed(
            spec, k_new, v_new, state["paged"], state["stream"], start, accepted,
            active, place=self.place(spec), perm=perm)
        return {"paged": paged, "stream": stream}

    def whole(self, spec, key: str, field: str, t, lead: int = 0):
        """The full leaf ``(key, field)`` from the rank's block ``t`` (after
        ``lead`` leading dims of its own, a stack of layers say), gathered
        over every axis that cuts it; no collective on an axis of one rank.
        The host reads the whole batch's selection so, the same on every
        rank."""
        place = self.place(spec)
        for dim in range(len(place.shapes[(key, field)])):
            t = hattn._gather_dim(t, self.mesh, place.axes(key, field, dim), dim + lead)
        return t


_REGISTRY: Dict[str, DefaultLayout] = {}


def register_layout(layout: DefaultLayout) -> DefaultLayout:
    """Register a layout instance under ``layout.name`` (last wins)."""
    _REGISTRY[layout.name] = layout
    return layout


def available_layouts() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _lookup(name) -> DefaultLayout:
    """Canonicalize (silently) and fetch; raise ValueError if unknown."""
    name = _ALIASES.get(name, name)
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown attention layout {name!r}; registered layouts: "
            f"{', '.join(available_layouts())}")
    return _REGISTRY[name]


def resolve_layout(name) -> str:
    """Canonicalize a layout name; raise ValueError if unknown. ``None`` and
    ``"auto"`` resolve to ``"default"`` with a DeprecationWarning once per
    process per spelling, as in the reference."""
    if name in _ALIASES:
        canonical = _ALIASES[name]
        if name not in _warned_aliases:
            _warned_aliases.add(name)
            warnings.warn(
                f"layout={name!r} is a deprecated alias for "
                f"{canonical!r} and will be removed; pass "
                f"{canonical!r} instead", DeprecationWarning,
                stacklevel=2)
    return _lookup(name).name


def get_layout(name, shards: int = 1, mesh=None) -> DefaultLayout:
    """The layout ``name`` (aliases canonicalize silently); ``shards`` is the
    stripe count of ``coplace_shmap`` (the size of the JAX mesh's 'model'
    axis) and must stay 1 for every other layout. ``coplace_shmap`` given a
    ``mesh`` is served over its ranks (``CoplaceShmapRanks``; ``shards`` 1
    or the size of 'model'); every other layout ignores ``mesh`` here: the
    GSPMD layouts take theirs in ``plan`` and ``placed``, and the engine
    serves ``default`` unplaced. Lockstep ``generate(mesh=...)`` places
    ``default`` on the mesh through ``mesh_layout``."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    lay = _lookup(name)
    if lay.name == LAYOUT_COPLACE_SHMAP:
        if mesh is not None:
            return CoplaceShmapRanks(mesh, shards)
        return CoplaceShmapLayout(shards)
    if shards != 1:
        raise ValueError("shards stripes the pages of the coplace_shmap layout "
                         "only")
    return lay


def mesh_layout(name, shards: int = 1, mesh=None) -> DefaultLayout:
    """``get_layout``'s layout, but ``default`` given a mesh placed on its
    ranks (``DefaultRanks``): the layout lockstep ``generate`` runs."""
    lay = get_layout(name, shards, mesh)
    if mesh is not None and lay.name == LAYOUT_DEFAULT:
        return DefaultRanks()
    return lay


def _meta_cache(spec, batch: int, capacity: int) -> Dict:
    """The empty cache of a layer of ``spec`` (see ``PlacedLayout.place``)
    for ``batch`` slots of ``capacity`` tokens, on the meta device."""
    if isinstance(spec, cachelib.RecurrentSpec):
        return spec.empty(batch, "meta")
    if spec.full_cache:
        return {"full": cachelib.make_full_cache(batch, spec.n_kv, capacity,
                                                 spec.head_dim, dtype=torch.float32,
                                                 device="meta")}
    return dict(zip(("paged", "stream"), hattn.empty_decode_state(
        spec, batch, capacity, dtype=torch.float32, device="meta")))


def check_gspmd_config(cfg) -> None:
    """Raise for a config the GSPMD layouts do not serve: a frontend-stub
    arch, with the refusal of the default layout's engine
    (``serving.engine.STUB_ENGINE_REFUSAL``). Every other family is served
    on them: dense, gemma3's local:global stack, the MoE family, the
    recurrent mixers, and H²EAL off."""
    if cfg.embed_frontend_stub:
        from repro_torch.models.model import STUB_ENGINE_REFUSAL

        raise ValueError(STUB_ENGINE_REFUSAL)


def dispatch_decode_window(layout, body, carry, xs, *, length: int):
    """Route a fused decode window (a loop over reuse-step bodies) to
    ``layout``'s ``decode_window`` hook."""
    return layout.decode_window(body, carry, xs, length=length)


def dispatch_verify_chunk(layout, spec, state: Dict, q, k_new, v_new, start, *,
                          active=None, need_select=None, perm=None):
    """Route one speculative verify pass to ``layout``'s verify_chunk hook."""
    return layout.verify_chunk(spec, state, q, k_new, v_new, start, active=active,
                               need_select=need_select, perm=perm)


def dispatch_verify_append(layout, spec, state: Dict, k_new, v_new, start,
                           accepted, *, active=None, perm=None):
    """Route the commit of a verified chunk's accepted prefix to
    ``layout``'s verify_append hook."""
    return layout.verify_append(spec, state, k_new, v_new, start, accepted,
                                active=active, perm=perm)


DEFAULT = register_layout(DefaultLayout())
register_layout(HeadLayout())
register_layout(CoplaceLayout())
register_layout(InterleaveLayout())
register_layout(CoplaceShmapLayout())
