"""KV-cache structures for H²EAL serving (counterpart of ``repro/core/cache.py``).

  FullCache    dense (B, H, S, D) baseline, used when H²EAL is disabled.
  PagedCache   retrieval heads: paged KV + per-page key min/max (τ)
               metadata + accumulated importance + page_start table.
  StreamCache  streaming heads: sink + local ring buffer.
  TieredPagedCache  the host side of tiered hot/cold page residency: which
               pages of each slot are on the card, and the far store of
               the spilled ones in host memory.
  Mamba2State, MLSTMState, SLSTMState  a recurrent layer's per-slot state
               (``models/ssm.py``, ``models/xlstm.py``): constant-size, no
               pages; a layer's cache is {"ssm": Mamba2State} or {"xl": ...}.

The single-token appends take ``length`` as a Python int (the lockstep
path: every row writes at one position) or as a (B,) tensor (the
continuous-batching path: each slot writes at its own position, and rows
whose ``active`` flag is False are written back unchanged). The chunk
appends feed a left-aligned chunk of prompt tokens per slot.

Unlike the JAX package, whose arrays are immutable, every append writes
into the cache tensors IN PLACE and returns the same cache object: one
decode step then moves a token's worth of bytes, not a copy of the cache.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core.paging import interleave_slot, logical_pages, page_counts
from repro_torch.runtime import collectives as coll


@dataclasses.dataclass
class FullCache:
    k: torch.Tensor  # (B, Hkv, S, D)
    v: torch.Tensor  # (B, Hkv, S, D)


@dataclasses.dataclass
class PagedCache:
    k_pages: torch.Tensor     # (B, Hr, C, P, D)
    v_pages: torch.Tensor     # (B, Hr, C, P, D)
    tau_min: torch.Tensor     # (B, Hr, C, D) f32, elementwise min of the page's keys
    tau_max: torch.Tensor     # (B, Hr, C, D) f32
    importance: torch.Tensor  # (B, Hr, C) f32 accumulated relevance
    page_start: torch.Tensor  # (B, Hr, C) int32 position of the first token; -1 empty
    sel_idx: torch.Tensor     # (B, Hr, K) int32 cached top-k selection


@dataclasses.dataclass
class StreamCache:
    k: torch.Tensor    # (B, Hs, W, D), W = sink + local_cap; the local part is a ring
    v: torch.Tensor    # (B, Hs, W, D)
    pos: torch.Tensor  # (B, Hs, W) int32 absolute position in each slot; -1 empty


def make_stream_cache(b, h_s, sink, local_cap, d, *, dtype, device):
    w = sink + local_cap
    z = lambda: torch.zeros((b, h_s, w, d), dtype=dtype, device=device)
    return StreamCache(k=z(), v=z(), pos=torch.full((b, h_s, w), -1,
                                                    dtype=torch.int32,
                                                    device=device))


@dataclasses.dataclass
class Mamba2State:
    ssm: torch.Tensor     # (B, H, N, P) f32 SSD state
    conv_x: torch.Tensor  # (B, K-1, inner) pre-conv inputs of the last K-1 positions
    conv_B: torch.Tensor  # (B, K-1, N)
    conv_C: torch.Tensor  # (B, K-1, N)


@dataclasses.dataclass
class MLSTMState:
    C: torch.Tensor  # (B, H, P, P) f32 matrix memory
    n: torch.Tensor  # (B, H, P) f32 normaliser
    m: torch.Tensor  # (B, H) f32 max-stabiliser; -inf before the first token


@dataclasses.dataclass
class SLSTMState:
    c: torch.Tensor  # (B, H, P) f32 cell
    n: torch.Tensor  # (B, H, P) f32 normaliser
    m: torch.Tensor  # (B, H, P) f32 max-stabiliser; -inf before the first token
    h: torch.Tensor  # (B, H, P) f32 hidden state (the recurrent gates' input)



def state_fields(st) -> dict:
    """A recurrent state container's tensors as the dict of the reference's
    keys, the same tensors (no copy)."""
    return {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}


def write_state(st, new: dict, keep=None) -> None:
    """Write the state ``new`` (a dict of ``st``'s fields) into ``st``'s
    tensors in place; with ``keep`` (B,) bool, only the rows where it holds,
    the others left as they are, bit for bit. A captured step writes its
    state so, into the buffers its graph reads."""
    for name, old in state_fields(st).items():
        val = new[name]
        if keep is not None:
            val = torch.where(keep.reshape((-1,) + (1,) * (old.dim() - 1)), val, old)
        old.copy_(val)


def empty_fill_value(field: str):
    """The empty-cache value of a cache field, the one a fresh cache holds:
    tau_min +inf, tau_max -inf, page_start and the ring's pos -1, the xLSTM
    max-stabiliser ``m`` -inf, every other field 0. The serving engine
    writes these into a slot's rows when it admits a request chunk by
    chunk, so that no key of a previous occupant passes a validity mask,
    the chunk appends' running τ min/max merge starts from the identity and
    a recurrent slot starts from a fresh state."""
    return {"tau_min": float("inf"), "tau_max": float("-inf"),
            "page_start": -1, "pos": -1, "m": float("-inf")}.get(field, 0)


def make_full_cache(b, h_kv, capacity, d, *, dtype, device):
    z = lambda: torch.zeros((b, h_kv, capacity, d), dtype=dtype, device=device)
    return FullCache(k=z(), v=z())


def make_paged_cache(b, h_r, num_pages, page, d, top_k, *, dtype, device):
    """An empty paged cache (every field at ``empty_fill_value``)."""
    zp = lambda: torch.zeros((b, h_r, num_pages, page, d), dtype=dtype,
                             device=device)
    full = lambda s, v, dt: torch.full(s, v, dtype=dt, device=device)
    f32, i32 = torch.float32, torch.int32
    return PagedCache(k_pages=zp(), v_pages=zp(),
                      tau_min=full((b, h_r, num_pages, d), float("inf"), f32),
                      tau_max=full((b, h_r, num_pages, d), float("-inf"), f32),
                      importance=full((b, h_r, num_pages), 0.0, f32),
                      page_start=full((b, h_r, num_pages), -1, i32),
                      sel_idx=full((b, h_r, top_k), 0, i32))


# ---------------------------------------------------------------------------
# Appends: one token for all heads of one layer, at position ``length``
# ---------------------------------------------------------------------------


def _active(active, b: int, device):
    return (torch.ones(b, dtype=torch.bool, device=device) if active is None
            else active.reshape(b))


def _rows(length, active, b: int, device):
    """(length (B,) int64, active (B,) bool) of the ragged path."""
    return length.reshape(-1).expand(b).long(), _active(active, b, device)


def full_cache_append(cache: FullCache, k_new, v_new, length,
                      active=None) -> FullCache:
    """k_new/v_new: (B, Hkv, D) written at slot ``length`` (in place)."""
    if not isinstance(length, torch.Tensor):
        cache.k[:, :, length] = k_new.to(cache.k.dtype)
        cache.v[:, :, length] = v_new.to(cache.v.dtype)
        return cache
    b, _, s, _ = cache.k.shape
    lb, act = _rows(length, active, b, cache.k.device)
    bi = torch.arange(b, device=lb.device)
    sl = lb.clamp(0, s - 1)
    a3 = act[:, None, None]
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        buf[bi, :, sl] = torch.where(a3, new.to(buf.dtype), buf[bi, :, sl])
    return cache


def stream_cache_append(cache: StreamCache, k_new, v_new, length, *,
                        sink: int, active=None) -> StreamCache:
    """Ring append (in place): positions below ``sink`` keep their own slot,
    later ones cycle over the local part."""
    local_cap = cache.k.shape[2] - sink
    if not isinstance(length, torch.Tensor):
        slot = length if length < sink else sink + (length - sink) % local_cap
        cache.k[:, :, slot] = k_new.to(cache.k.dtype)
        cache.v[:, :, slot] = v_new.to(cache.v.dtype)
        cache.pos[:, :, slot] = length
        return cache
    b = cache.k.shape[0]
    lb, act = _rows(length, active, b, cache.k.device)
    slot = torch.where(lb < sink, lb, sink + (lb - sink) % local_cap)
    bi = torch.arange(b, device=lb.device)
    a3 = act[:, None, None]
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        buf[bi, :, slot] = torch.where(a3, new.to(buf.dtype), buf[bi, :, slot])
    cache.pos[bi, :, slot] = torch.where(act[:, None], lb[:, None].int(),
                                         cache.pos[bi, :, slot])
    return cache


def paged_cache_append(cache: PagedCache, k_new, v_new, length, active=None,
                       *, phys_shards: int = 1) -> PagedCache:
    """Append one token at position ``length`` (logical page length // P),
    in place, updating the page's running τ min/max and its start.

    ``phys_shards`` > 1 is the ``coplace_shmap`` owner-stripe append: the
    token goes to the page's physical slot ``paging.interleave_slot``, which
    is what the reference's per-shard append writes on the one shard owning
    it (the others write nothing); the page start stays the logical one."""
    b, _, c, p = cache.k_pages.shape[:4]
    if not isinstance(length, torch.Tensor):
        page, off = divmod(length, p)
        if page >= c:
            raise ValueError(f"position {length} lies past the cache's {c} pages")
        slot = interleave_slot(page, c, phys_shards)
        cache.k_pages[:, :, slot, off] = k_new.to(cache.k_pages.dtype)
        cache.v_pages[:, :, slot, off] = v_new.to(cache.v_pages.dtype)
        kf = k_new.float()
        cache.tau_min[:, :, slot] = torch.minimum(cache.tau_min[:, :, slot], kf)
        cache.tau_max[:, :, slot] = torch.maximum(cache.tau_max[:, :, slot], kf)
        cache.page_start[:, :, slot] = page * p
        return cache
    lb, act = _rows(length, active, b, cache.k_pages.device)
    page = (lb // p).clamp(0, c - 1)
    slot = interleave_slot(page, c, phys_shards)
    off = lb % p
    bi = torch.arange(b, device=lb.device)
    a3 = act[:, None, None]
    for buf, new in ((cache.k_pages, k_new), (cache.v_pages, v_new)):
        buf[bi, :, slot, off] = torch.where(a3, new.to(buf.dtype),
                                            buf[bi, :, slot, off])
    kf = k_new.float()
    old_min, old_max = cache.tau_min[bi, :, slot], cache.tau_max[bi, :, slot]
    cache.tau_min[bi, :, slot] = torch.where(a3, torch.minimum(old_min, kf), old_min)
    cache.tau_max[bi, :, slot] = torch.where(a3, torch.maximum(old_max, kf), old_max)
    cache.page_start[bi, :, slot] = torch.where(
        act[:, None], (page * p)[:, None].int(), cache.page_start[bi, :, slot])
    return cache


# ---------------------------------------------------------------------------
# Chunk appends (chunked prefill): a left-aligned chunk per slot. Slot b
# appends its first chunk_len[b] tokens at positions start[b] ..
# start[b] + chunk_len[b] - 1; the rest of the chunk, and every slot whose
# ``active`` flag is False, append nothing.
#
# The writes are in place. Every chunk token of a row goes to its own
# location: position start + j taken modulo the buffer's length (valid
# positions lie inside the buffer, so they keep their true location, and a
# chunk no longer than the buffer never maps two tokens to one location).
# A masked token writes back the value it finds, so no masked write can
# race a valid one, which is what the JAX package's transient overflow
# page achieves there.
# ---------------------------------------------------------------------------


def _chunk_rows(start, chunk_len, active, b: int, cch: int, device):
    """(positions (B, C) int64, token valid (B, C) bool)."""
    j = torch.arange(cch, device=device)
    pos = start.reshape(b, 1).long() + j
    valid = (j < chunk_len.reshape(b, 1)) & _active(active, b, device)[:, None]
    return pos, valid


def _put_tokens(buf, loc, valid, new):
    """buf: (B, H, N, D); write new (B, C, H, D) at buf[b, :, loc[b, j]]
    for the valid tokens, in place."""
    bi = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[bi, :, loc] = torch.where(valid[:, :, None, None], new.to(buf.dtype),
                                  buf[bi, :, loc])


def paged_cache_append_chunk(cache: PagedCache, k_new, v_new, start,
                             chunk_len, *, active=None,
                             phys_shards: int = 1) -> PagedCache:
    """k_new/v_new: (B, C, Hr, D). Page τ min/max merge by scatter-min/max
    (a masked token adds the identity ±inf), exact for chunks that open,
    fill or straddle pages, PROVIDED the touched pages start from the
    empty values (the engine resets a slot's rows at admission).
    ``phys_shards`` > 1 writes each logical page into its striped physical
    slot (``paging.interleave_slot``, the ``coplace_shmap`` order); the page
    starts stay logical positions."""
    b, cch, h, d = k_new.shape
    cap, p = cache.k_pages.shape[2:4]
    pos, valid = _chunk_rows(start, chunk_len, active, b, cch, k_new.device)
    # (pos mod cap*P) -> (page mod cap, offset) -> striped slot is one-to-one
    slot = interleave_slot((pos // p) % cap, cap, phys_shards)
    loc = slot * p + pos % p
    _put_tokens(cache.k_pages.view(b, h, cap * p, d), loc, valid, k_new)
    _put_tokens(cache.v_pages.view(b, h, cap * p, d), loc, valid, v_new)
    idx = slot[:, None, :, None].expand(b, h, cch, d)
    kf = k_new.float().transpose(1, 2)                     # (B, H, C, D)
    vmask = valid[:, None, :, None]
    cache.tau_min.scatter_reduce_(2, idx, torch.where(vmask, kf, float("inf")),
                                  "amin")
    cache.tau_max.scatter_reduce_(2, idx, torch.where(vmask, kf, float("-inf")),
                                  "amax")
    # a page is opened iff a valid token falls in it: logical pages
    # start // P .. (start + chunk_len - 1) // P of an active slot with
    # chunk_len > 0; each physical slot holds logical page pg
    last = pos.gather(1, (chunk_len.reshape(b, 1).long() - 1).clamp(min=0))
    n_valid = valid.any(dim=1, keepdim=True)
    pg = logical_pages(cap, phys_shards, k_new.device)
    opened = n_valid & (pg >= pos[:, :1] // p) & (pg <= last // p)   # (B, cap)
    cache.page_start.copy_(torch.where(opened[:, None, :], (pg * p).int(),
                                       cache.page_start))
    return cache


def stream_cache_append_chunk(cache: StreamCache, k_new, v_new, start,
                              chunk_len, *, sink: int,
                              active=None) -> StreamCache:
    """k_new/v_new: (B, C, Hs, D). Equivalent to appending the chunk one
    token at a time with ``stream_cache_append``, in closed form: each ring
    slot keeps the LAST chunk position that maps to it, so a chunk longer
    than the ring is handled exactly."""
    b, cch, h, d = k_new.shape
    w = cache.k.shape[2]
    local_cap = w - sink
    dev = k_new.device
    start = start.reshape(b, 1).long()
    act = _active(active, b, dev)
    e = start + chunk_len.reshape(b, 1).long() - 1          # last position
    wi = torch.arange(w, device=dev)[None, :]
    p_ring = e - (e - sink - (wi - sink)) % local_cap
    p_tgt = torch.where(wi < sink, wi, p_ring)              # (B, W)
    written = (act[:, None] & (p_tgt >= start) & (p_tgt <= e)
               & ((wi < sink) | (p_tgt >= sink)))
    jidx = (p_tgt - start).clamp(0, cch - 1)
    gidx = jidx[:, None, :, None].expand(b, h, w, d)
    wr = written[:, None, :, None]
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        took = new.transpose(1, 2).gather(2, gidx).to(buf.dtype)
        buf.copy_(torch.where(wr, took, buf))
    cache.pos.copy_(torch.where(written[:, None, :], p_tgt[:, None, :].int(),
                                cache.pos))
    return cache


def full_cache_append_chunk(cache: FullCache, k_new, v_new, start, chunk_len,
                            active=None) -> FullCache:
    """k_new/v_new: (B, C, Hkv, D) appended at positions start ..
    start + chunk_len - 1 per slot (dense baseline cache)."""
    b, cch = k_new.shape[:2]
    pos, valid = _chunk_rows(start, chunk_len, active, b, cch, k_new.device)
    loc = pos % cache.k.shape[2]
    _put_tokens(cache.k, loc, valid, k_new)
    _put_tokens(cache.v, loc, valid, v_new)
    return cache


def pool_append(cache: PagedCache, k_new, v_new, length: int, *, page: int,
                sink: int, local: int) -> PagedCache:
    """Fixed-pool append with eviction (paper §IV-A.3, "memory
    consideration"), in place: the cache's C slots are a pool of pages in
    any order, found by their ``page_start``. The token at position
    ``length`` (a Python int: the lockstep path) goes to the slot whose page
    starts at ``length // page * page``; when it opens a new page, to a dead
    slot (page_start < 0) if there is one, else to the live page of lowest
    accumulated importance that is neither a sink page (start < ``sink``)
    nor in the local window (start at or after the local window's first
    page), the lower slot among equals. The opened page's τ and importance
    restart. k_new/v_new: (B, Hr, D); each (slot row, head) evicts on its
    own, as in the paper."""
    b, h = cache.page_start.shape[:2]
    pos0 = length // page * page
    off = length % page
    ps = cache.page_start
    is_open = ps == pos0                                       # (B, H, C)
    has_open = is_open.any(dim=-1)
    open_slot = is_open.to(torch.int8).argmax(dim=-1)          # the first
    dead = ps < 0
    local_lo = max(length + 1 - local, 0) // page * page
    protected = ((ps < sink) | (ps >= local_lo)) & ~dead
    evict_score = torch.where(dead, float("-inf"),
                              torch.where(protected, float("inf"), cache.importance))
    slot = torch.where(has_open, open_slot, evict_score.argmin(dim=-1))  # (B, H)
    fresh = ~has_open
    bi = torch.arange(b, device=ps.device)[:, None]
    hi = torch.arange(h, device=ps.device)[None, :]
    cache.k_pages[bi, hi, slot, off] = k_new.to(cache.k_pages.dtype)
    cache.v_pages[bi, hi, slot, off] = v_new.to(cache.v_pages.dtype)
    kf = k_new.float()
    f = fresh[..., None]
    cache.tau_min[bi, hi, slot] = torch.minimum(
        torch.where(f, float("inf"), cache.tau_min[bi, hi, slot]), kf)
    cache.tau_max[bi, hi, slot] = torch.maximum(
        torch.where(f, float("-inf"), cache.tau_max[bi, hi, slot]), kf)
    cache.importance[bi, hi, slot] = torch.where(fresh, 0.0,
                                                 cache.importance[bi, hi, slot])
    cache.page_start[bi, hi, slot] = pos0
    return cache


# ---------------------------------------------------------------------------
# Blocks of the GSPMD layouts (``head``, ``coplace``, ``interleave``) and of
# ``coplace_shmap`` on a mesh
#
# Under a GSPMD layout every rank holds only its block of each serve-cache
# leaf: the tile ``runtime/sharding.py`` cuts by the reference's placement
# rules (kv heads, pages or within-page tokens over 'model' / 'data', the
# batch over 'data'; a full cache's rows over the batch axes and kv heads
# over 'model'; a recurrent state's rows over the batch axes alone).
# ``coplace_shmap`` on a mesh places its pages as ``coplace`` does, in the
# striped physical page order (``paging.interleave_slot`` over the M ranks
# of 'model'), so that rank r's block of the page slots is stripe r: the
# logical pages p with p % M == r. A
# ``Placement`` records, for one kind of layer (an H²EAL attention layer,
# a full-cache layer, a recurrent mixer), each leaf's placement and this
# rank's tile of the full leaf. The appends below take the whole batch's
# new tokens (every rank computes them, the layer being replicated) and
# write only what falls in the rank's tile; every other element of the
# block is left bit for bit as it was.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecurrentSpec:
    """A recurrent layer's serve state, as the GSPMD layouts place it: its
    cache key ("ssm" or "xl"), its state container, and each field's name
    and shape a slot."""

    key: str
    state_cls: type
    fields: tuple  # ((name, shape without the batch dim), ...)

    def empty(self, batch: int, device) -> dict:
        """The layer's cache of ``batch`` slots, uninitialised (the meta
        device: shapes only)."""
        return {self.key: self.state_cls(**{n: torch.empty((batch,) + tuple(s),
                                                            device=device)
                                            for n, s in self.fields})}


@dataclasses.dataclass(frozen=True)
class Placement:
    """One kind of layer's serve cache on one rank of ``mesh``.

    specs     (cache key, field) -> the leaf's placement (a tuple of axis
              names per dimension, ``runtime/sharding``).
    shapes    (cache key, field) -> the full leaf's shape.
    bounds    (cache key, field) -> this rank's tile of the full leaf,
              (start, stop) per dimension.
    page      tokens a page (the full page; a token stripe holds fewer; 0
              for a layer without pages).
    partials  the retrieval heads attend by per-rank partials merged with
              ``combine_partials``: the layouts that shard pages, where more
              than one rank holds them (one rank holding every page takes
              the default's kernels, and its numbers).
    stripes   the physical page order is striped round-robin over this many
              stripes (``paging.interleave_slot``; 1: the logical order):
              ``coplace_shmap`` on a mesh, one stripe a rank of 'model'.
    minus_one a selected page whose score is masked becomes -1, as the
              co-placed decode selects (``coplace_shmap``).
    """

    mesh: object
    specs: dict
    shapes: dict
    bounds: dict
    page: int
    partials: bool
    stripes: int = 1
    minus_one: bool = False

    def axes(self, key: str, field: str, dim: int) -> tuple:
        """The mesh axes that cut dimension ``dim`` of a leaf, most
        significant first; () when the dimension is whole."""
        a = self.specs[(key, field)]
        a = a[dim] if dim < len(a) else None
        return () if a is None else (a if isinstance(a, tuple) else (a,))

    def cut(self, key: str, field: str, dim: int) -> tuple:
        """``axes`` of more than one rank: those that split the dimension."""
        return tuple(a for a in self.axes(key, field, dim) if self.mesh.shape[a] > 1)

    def block_pages(self, key: str, field: str):
        """(first, step): slot j of the rank's tile of a paged leaf's page
        dimension holds the logical page first + j·step (the tile lies in
        one stripe of the striped order)."""
        c0, c1 = self.bounds[(key, field)][2]
        per = self.shapes[(key, field)][2] // self.stripes
        if c0 // per != (c1 - 1) // per:
            raise ValueError(f"page slots [{c0}, {c1}) straddle the stripes of {per}")
        return (c0 % per) * self.stripes + c0 // per, self.stripes


def block_of(full, key: str, place: Placement, device):
    """The rank's block of the empty cache ``full`` (a ``PagedCache``,
    ``StreamCache``, ``FullCache`` or recurrent state, typically on the meta
    device): each field allocated at its tile's shape and filled with its
    empty value."""
    out = {}
    for f in dataclasses.fields(full):
        t = getattr(full, f.name)
        shape = tuple(b - a for a, b in place.bounds[(key, f.name)])
        out[f.name] = torch.full(shape, empty_fill_value(f.name), dtype=t.dtype,
                                 device=device)
    return type(full)(**out)


def _tile(t, bounds):
    return t[tuple(slice(a, b) for a, b in bounds)]


def pack_block_row(big: dict, small: dict, slot: int, place: Placement) -> None:
    """Write row 0 of the full batch-1 layer cache ``small`` into global slot
    ``slot`` of the rank's block ``big``, in place: the rank writes its tile
    of the row, or nothing where its block holds another batch row."""
    for key, cache in big.items():
        for f in dataclasses.fields(cache):
            (b0, b1), *rest = place.bounds[(key, f.name)]
            if b0 <= slot < b1:
                src = _tile(getattr(small[key], f.name)[0], rest)
                getattr(cache, f.name)[slot - b0].copy_(src)


def reset_block_row(big: dict, slot: int, place: Placement) -> None:
    """Clear global slot ``slot`` of the rank's block to the empty values."""
    for key, cache in big.items():
        for f in dataclasses.fields(cache):
            (b0, b1) = place.bounds[(key, f.name)][0]
            if b0 <= slot < b1:
                getattr(cache, f.name)[slot - b0].fill_(empty_fill_value(f.name))


def paged_block_append(cache: PagedCache, k_new, v_new, length, active,
                       place: Placement) -> PagedCache:
    """The decode append of one token a slot at positions ``length`` (B,),
    into the rank's block, in place: k_new/v_new (B, Hr, D) of the whole
    batch. K and V go to the rank that owns the token's page and, under
    token stripes, its offset in the page; τ min/max and the page start to
    the rank that owns the page in the metadata's tile (every rank, where
    the metadata is replicated). The page is clamped to the cache's last,
    as ``paged_cache_append`` clamps it; under ``place.stripes`` its owner
    is that of its striped physical slot."""
    p = place.page
    b = k_new.shape[0]
    lb, act = _rows(length, active, b, k_new.device)
    (b0, b1), (h0, h1), (c0, c1), (p0, p1), _ = place.bounds[("paged", "k_pages")]
    cap = place.shapes[("paged", "k_pages")][2]
    page = (lb // p).clamp(0, cap - 1)
    phys = interleave_slot(page, cap, place.stripes)
    off = lb % p
    own = act & (phys >= c0) & (phys < c1) & (off >= p0) & (off < p1)
    r = slice(b0, b1)
    bi = torch.arange(b1 - b0, device=k_new.device)
    slot = (phys[r] - c0).clamp(0, c1 - c0 - 1)
    loff = (off[r] - p0).clamp(0, p1 - p0 - 1)
    a3 = own[r][:, None, None]
    for buf, new in ((cache.k_pages, k_new), (cache.v_pages, v_new)):
        new = new[r, h0:h1].to(buf.dtype)
        buf[bi, :, slot, loff] = torch.where(a3, new, buf[bi, :, slot, loff])
    (t0, t1), (th0, th1), (tc0, tc1), _ = place.bounds[("paged", "tau_min")]
    r = slice(t0, t1)
    bi = torch.arange(t1 - t0, device=k_new.device)
    own_t = (act & (phys >= tc0) & (phys < tc1))[r]
    slot = (phys[r] - tc0).clamp(0, tc1 - tc0 - 1)
    a3 = own_t[:, None, None]
    kf = k_new[r, th0:th1].float()
    old_min, old_max = cache.tau_min[bi, :, slot], cache.tau_max[bi, :, slot]
    cache.tau_min[bi, :, slot] = torch.where(a3, torch.minimum(old_min, kf), old_min)
    cache.tau_max[bi, :, slot] = torch.where(a3, torch.maximum(old_max, kf), old_max)
    cache.page_start[bi, :, slot] = torch.where(
        own_t[:, None], (page[r] * p)[:, None].int(), cache.page_start[bi, :, slot])
    return cache


def paged_block_append_chunk(cache: PagedCache, k_new, v_new, start, chunk_len,
                             *, active, place: Placement) -> PagedCache:
    """The chunk append (``paged_cache_append_chunk``) into the rank's
    block, in place: k_new/v_new (B, C, Hr, D) of the whole batch. K and V
    are written through a window of the block's pages that the chunk can
    reach (its own token positions read back where they are valid and
    owned, the values in place elsewhere): the window's slots are distinct,
    so no two writes meet. τ min/max merge by scatter-min/max of the
    owned tokens (a masked token adds the identity), and the page starts
    of the opened pages in the metadata's tile are set. Under
    ``place.stripes`` the block's slots hold every stripes-th logical page
    (``Placement.block_pages``), so the window is the block's slots of the
    chunk's pages."""
    b, cch = k_new.shape[:2]
    p = place.page
    dev = k_new.device
    st = start.reshape(b).long()
    n = chunk_len.reshape(b).long()
    act = _active(active, b, dev)
    (b0, b1), (h0, h1), (c0, c1), (p0, p1), _ = place.bounds[("paged", "k_pages")]
    cap = place.shapes[("paged", "k_pages")][2]
    fp, step = place.block_pages("paged", "k_pages")
    cl, pl, bl = c1 - c0, p1 - p0, b1 - b0
    w = min(-(-cch // p) + 1, cl)
    r = slice(b0, b1)
    first = torch.div(st[r] // p - fp + step - 1, step, rounding_mode="floor")
    lp = first.clamp(0, cl - w)[:, None] + torch.arange(w, device=dev)   # (Bl, w)
    pos = ((fp + lp * step) * p + p0)[:, :, None] + torch.arange(pl, device=dev)
    j = pos - st[r][:, None, None]                                       # (Bl, w, Pl)
    ok = act[r][:, None, None] & (j >= 0) & (j < n[r][:, None, None])
    jc = j.clamp(0, cch - 1)
    bi = torch.arange(bl, device=dev)
    for buf, new in ((cache.k_pages, k_new), (cache.v_pages, v_new)):
        took = new[r][bi[:, None, None], jc][..., h0:h1, :]              # (Bl, w, Pl, Hl, D)
        took = took.permute(0, 1, 3, 2, 4).to(buf.dtype)                 # (Bl, w, Hl, Pl, D)
        old = buf[bi[:, None], :, lp]                                    # (Bl, w, Hl, Pl, D)
        buf[bi[:, None], :, lp] = torch.where(ok[:, :, None, :, None], took, old)
    (t0, t1), (th0, th1), (tc0, tc1), d = place.bounds[("paged", "tau_min")]
    r = slice(t0, t1)
    jj = torch.arange(cch, device=dev)
    pos_t = st[r][:, None] + jj                                          # (Bt, C)
    valid = (jj < n[r][:, None]) & act[r][:, None]
    phys = interleave_slot((pos_t // p).clamp(0, cap - 1), cap, place.stripes)
    own = valid & (phys >= tc0) & (phys < tc1)
    ht, dd = th1 - th0, d[1] - d[0]
    idx = (phys - tc0).clamp(0, tc1 - tc0 - 1)[:, None, :, None].expand(t1 - t0, ht,
                                                                        cch, dd)
    kf = k_new[r][:, :, th0:th1].float().transpose(1, 2)                 # (Bt, Ht, C, D)
    om = own[:, None, :, None]
    cache.tau_min.scatter_reduce_(2, idx, torch.where(om, kf, float("inf")), "amin")
    cache.tau_max.scatter_reduce_(2, idx, torch.where(om, kf, float("-inf")), "amax")
    last = pos_t.gather(1, (n[r][:, None] - 1).clamp(min=0))
    fp_t, step_t = place.block_pages("paged", "tau_min")
    pg = fp_t + torch.arange(tc1 - tc0, device=dev) * step_t
    opened = (valid.any(dim=1, keepdim=True) & (pg >= pos_t[:, :1] // p)
              & (pg <= last // p))
    cache.page_start.copy_(torch.where(opened[:, None, :], (pg * p).int(),
                                       cache.page_start))
    return cache


def move_block_rows(layers, places, src, dst) -> None:
    """Move global slot ``src``'s row of every cache leaf of ``layers`` (the
    rank's blocks of each layer, layer i placed by ``places[i]``: paged
    pages, full caches and recurrent states alike) to slot ``dst`` and
    clear ``src`` to the empty values, in place (``src``, ``dst`` (1,)
    int64 card tensors: fixed shapes, so that the step is captured once).
    A leaf whose batch rows are whole moves locally. Where rows are cut
    (over 'data'), the owner of ``src`` along that axis sends its row to
    the rest (``collectives.owner_select``, one collective for every cut
    leaf of every layer), the owner of ``dst`` writes it, and every other
    row of the block is written back as it was."""
    cut, axis, mesh = [], None, None
    for layer, place in zip(layers, places):
        for key, cache in layer.items():
            for f in dataclasses.fields(cache):
                t = getattr(cache, f.name)
                axes = place.cut(key, f.name, 0)
                if not axes:
                    t.index_copy_(0, dst, t.index_select(0, src))
                    t.index_fill_(0, src, empty_fill_value(f.name))
                    continue
                if len(axes) != 1 or axis not in (None, axes[0]):
                    raise NotImplementedError(f"batch rows cut over {axes}: a migration "
                                              f"moves rows over one mesh axis")
                axis, mesh = axes[0], place.mesh
                cut.append((t, f.name, place.bounds[(key, f.name)][0]))
    if not cut:
        return
    rows, locs = [], []
    for t, _, (b0, b1) in cut:
        s_l, d_l = (src - b0).clamp(0, b1 - b0 - 1), (dst - b0).clamp(0, b1 - b0 - 1)
        locs.append((s_l, d_l))
        rows.append(t.index_select(0, s_l).float().reshape(-1))
    bl = cut[0][2][1] - cut[0][2][0]
    moved = coll.owner_select(torch.cat(rows), mesh, axis, src // bl)
    off = 0
    for (t, name, (b0, b1)), (s_l, d_l) in zip(cut, locs):
        n = t[0].numel()
        row = moved[off:off + n].view((1,) + tuple(t.shape[1:])).to(t.dtype)
        off += n
        into = ((dst >= b0) & (dst < b1)).reshape((1,) * t.dim())
        t.index_copy_(0, d_l, torch.where(into, row, t.index_select(0, d_l)))
        out = ((src >= b0) & (src < b1)).reshape((1,) * t.dim())
        t.index_copy_(0, s_l, torch.where(out, torch.full_like(row, empty_fill_value(name)),
                                          t.index_select(0, s_l)))


# ---------------------------------------------------------------------------
# Tiered hot/cold page residency (two-tier KV cache)
#
# A paged cache's K/V page rows are the only state that moves between the
# tiers: selection scores, page validity and the appends read the metadata
# (tau_min/tau_max/importance/page_start), which stays on the card, so a
# spilled page stays selectable, and is selected exactly as in the
# all-resident cache, while its contents lie in the far store. The serving
# engine finds selected-but-cold pages from the select step's digest, fills
# them and replays the step: a miss is served late, never skipped.
#
# The batched ops take (M,) slot and page index tensors of the (slot, page)
# pairs that move, over every paged layer's k_pages and v_pages, and write
# the engine's static serve state in place with advanced indexing. Under a
# GSPMD layout the state is the rank's blocks and the indices are local to
# them: ``TieredPagedCache`` moves the pairs this rank owns, and every rank
# keeps the same residency and takes the same decisions.
# ---------------------------------------------------------------------------


def kv_page_tensors(state) -> list:
    """k_pages and v_pages of every paged layer of a batched serve state,
    layer by layer: the tensors a page's row lives in."""
    out = []
    for layer in state["layers"]:
        paged = layer.get("paged")
        if paged is not None:
            out += [paged.k_pages, paged.v_pages]
    return out


def gather_kv_rows_pairs(state, slots, pages) -> torch.Tensor:
    """(M, 2L, Hr, P, D): the K and V rows of M (slot, physical page)
    pairs, every paged layer's, in ``kv_page_tensors`` order."""
    return torch.stack([t[slots, :, pages] for t in kv_page_tensors(state)], dim=1)


def spill_kv_rows_pairs(state, slots, pages) -> None:
    """Zero the K and V rows of M (slot, page) pairs in place: zero is the
    empty-page value, so to the kernels a spilled page is an empty one; only
    the metadata, which stays, says otherwise."""
    for t in kv_page_tensors(state):
        t[slots, :, pages] = 0


def fill_kv_rows_pairs(state, slots, pages, rows) -> None:
    """Write ``rows`` ((M, 2L, Hr, P, D), as ``gather_kv_rows_pairs`` gives
    them) back into M (slot, page) pairs in place: the exact inverse of a
    spill."""
    for i, t in enumerate(kv_page_tensors(state)):
        t[slots, :, pages] = rows[:, i].to(t.dtype)


class TieredPagedCache:
    """Host side of the two-tier paged KV cache (the JAX package's
    ``TieredPagedCache``, with the transfers of the engine's batched tier
    ops).

    Per engine slot, ``resident`` says which PHYSICAL pages are on the card,
    and ``far`` holds each spilled page's rows, ``(slot, phys_page) ->
    (2L, Hr, P, D)`` in host memory (pinned on the card's host): the far
    bank of the paper's hybrid-bonding chip, whose traffic
    ``hbsim.tiered_serving_overhead`` prices.

    Residency policy (exact by construction):

    * **Pinned, never spilled:** the sink pages, every page at or above the
      local window's start ``first_local(ctx)`` (the local span, the page
      being appended to and the pages not written yet) and the pages
      currently selected. ``first_local`` only grows, so a page below it is
      complete and never appended to or back in the local window again: a
      spilled page is read again only through selection, which reads the
      metadata alone, so a cold read is always detected.
    * **Hot set:** the pinned pages and the ``hot_pages`` - |pinned| most
      important spill candidates (the accumulated importance). The budget
      is soft: pins may exceed it.
    * **Refresh:** after each selection the engine asks ``plan_refresh`` for
      the pages to prefetch (hot again but cold, filled one share window
      ahead of the next selection) and the pages to spill.

    ``stripe_shards`` > 1 is the ``coplace_shmap`` page striping
    (``paging.interleave_slot``): selection and importance are already
    physical there, so the bitmap and far store are kept in physical page
    space and only the sink and local pins go through the stripe mapping.

    ``block`` ((b0, b1), (c0, c1)): the state is one rank's block of a GSPMD
    layout, its slots [b0, b1) and pages [c0, c1) (each page's tokens or
    heads perhaps a stripe of them). The decisions and the residency are
    every rank's alike, taken from the whole batch's selection; the copies
    and the far store hold the rank's tiles of the pairs it owns (``far``
    maps another rank's pair to None), and ``h2d_bytes`` / ``d2h_bytes``
    count this rank's bytes.

    Transfers (``archive``, ``spill``, ``fill``) run on the card's copy
    stream after the work queued so far, ``non_blocking``, and the current
    stream waits for them (an event) before the next step reads the state.
    ``h2d_bytes`` and ``d2h_bytes`` count the bytes the copies moved; on the
    card each batch's copies are timed with CUDA events (``transfer_times``).
    """

    def __init__(self, *, n_slots: int, n_pages: int, hot_pages: int,
                 page_size: int, sink: int, local: int, device,
                 stripe_shards: int = 1, block=None):
        self.n_slots = int(n_slots)
        self.n_pages = int(n_pages)
        self.hot_pages = int(hot_pages)
        self.page_size = int(page_size)
        self.sink = int(sink)
        self.local = int(local)
        self.stripe = max(int(stripe_shards), 1)
        self.n_sink_pages, _ = page_counts(sink=sink, local=local, page=page_size)
        self.resident = np.ones((self.n_slots, self.n_pages), bool)
        self.far: dict = {}   # (slot, phys_page) -> (2L, Hr, P, D) host tensor
        self.block = block or ((0, self.n_slots), (0, self.n_pages))
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self._timed: list = []  # (direction, bytes, start event, end event)

    def reset_counters(self) -> None:
        """Zero the byte counts and timings (a measured phase starts)."""
        self.h2d_bytes = self.d2h_bytes = 0
        self._timed.clear()

    # -- page-space mapping -------------------------------------------
    def phys(self, logical: int) -> int:
        return int(interleave_slot(int(logical), self.n_pages, self.stripe))

    def first_local(self, ctx: int) -> int:
        return max(int(ctx) - self.local, 0) // self.page_size

    def data_pages(self, ctx: int) -> int:
        return -(-int(ctx) // self.page_size)

    # -- residency bookkeeping ----------------------------------------
    def reset_slot(self, slot: int) -> None:
        """The slot retired or took a new request, whose pack or reset
        rewrites every row: the whole slot is resident, its far rows go."""
        self.resident[slot] = True
        for key in [k for k in self.far if k[0] == slot]:
            del self.far[key]

    def owns(self, slot: int, page: int) -> bool:
        """The pair lies in this rank's block (always, without one)."""
        (b0, b1), (c0, c1) = self.block
        return b0 <= slot < b1 and c0 <= page < c1

    def _local(self, pairs) -> list:
        """(index in ``pairs``, local (slot, page)) of the pairs this rank owns."""
        (b0, _), (c0, _) = self.block
        return [(i, (s - b0, p - c0)) for i, (s, p) in enumerate(pairs) if self.owns(s, p)]

    def move_slot(self, src: int, dst: int, relay=None) -> None:
        """A migration moved the occupant of slot ``src`` to ``dst``: its
        residency and far rows follow it, and ``src`` is reset. Where slots
        of one page block lie on several ranks, ``relay(src, dst, rows)``
        takes the far rows of ``src``'s pages in this rank's page block
        (None where another rank holds ``src``) and returns them as the
        rank holding ``dst`` keeps them (None elsewhere)."""
        self.resident[dst] = self.resident[src]
        keys = sorted(k for k in self.far if k[0] == src)
        rows = {k: self.far.pop(k) for k in keys}
        if relay is not None:
            c0, c1 = self.block[1]
            mine = [k for k in keys if c0 <= k[1] < c1]
            rows.update(zip(mine, relay(src, dst, [rows[k] for k in mine])))
        for k in keys:
            self.far[(dst, k[1])] = rows[k]
        self.reset_slot(src)

    def missing(self, slot: int, pages) -> list:
        """The physical ``pages`` not on the card (a selection's cold
        misses)."""
        return [p for p in pages if not self.resident[slot, p]]

    # -- policy --------------------------------------------------------
    def spill_candidates(self, slot: int, ctx: int, selected) -> list:
        """Physical pages that may be spilled: the complete pages strictly
        between the sink and local sections, less ``selected``."""
        fl = self.first_local(ctx)
        return [self.phys(p) for p in range(self.n_sink_pages, fl)
                if self.phys(p) not in selected]

    def plan_refresh(self, slot: int, ctx: int, selected, hotness):
        """(to_fill, to_spill), physical page lists for one refresh.

        ``selected``: the slot's fresh physical selection (resident: misses
        were filled before this runs); ``hotness``: (n_pages,) accumulated
        importance in physical page space. The wanted set is the pins and
        the top-m candidates by hotness, m sized so that the resident data
        pages meet the ``hot_pages`` budget; ties go to the lower page."""
        fl = self.first_local(ctx)
        nd = self.data_pages(ctx)
        cand = self.spill_candidates(slot, ctx, selected)
        pinned_data = (min(self.n_sink_pages, nd) + max(nd - fl, 0)
                       + len(selected))
        m = max(self.hot_pages - pinned_data, 0)
        order = sorted(cand, key=lambda p: (-float(hotness[p]), p))
        want = set(order[:m])
        to_fill = [p for p in order[:m] if not self.resident[slot, p]]
        to_spill = [p for p in cand if p not in want and self.resident[slot, p]]
        return to_fill, to_spill

    # -- transfers -------------------------------------------------------
    @contextlib.contextmanager
    def _on_copy_stream(self):
        """On the card: run the body on the copy stream after the work
        queued on the current stream, and make the current stream wait for
        it (an event) before whatever it runs next."""
        if self._stream is None:
            yield
            return
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            yield
        cur.wait_stream(self._stream)

    def _index(self, pairs):
        """(slots, pages) int64 index tensors on the device; from pinned
        memory on the card, so that the copies do not wait."""
        a = torch.from_numpy(np.asarray(pairs, np.int64).reshape(-1, 2).T.copy())
        if self._cuda:
            a = a.pin_memory()
        a = a.to(self.device, non_blocking=True)
        return a[0], a[1]

    def _event(self):
        if not self._cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def _time(self, direction: str, nbytes: int, start) -> None:
        if start is not None:
            self._timed.append((direction, nbytes, start, self._event()))

    def archive(self, state, pairs) -> int:
        """Copy the rows of the ``pairs`` not archived yet into the far
        store (one batched gather on the card, then one copy to host).
        Complete pages never change on the card, so an archived copy stays
        exact across spill, fill and spill again. Returns the pages
        copied."""
        new = [k for k in pairs if k not in self.far]
        if not new:
            return 0
        for key in new:
            self.far[key] = None
        own = self._local(new)
        if not own:
            return len(new)
        with self._on_copy_stream():
            slots, pages = self._index([loc for _, loc in own])
            rows = gather_kv_rows_pairs(state, slots, pages)
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=self._cuda)
            t0 = self._event()
            host.copy_(rows, non_blocking=self._cuda)
            self._time("d2h", host.nbytes, t0)
        for j, (i, _) in enumerate(own):
            self.far[new[i]] = host[j]
        self.d2h_bytes += host.nbytes
        return len(new)

    def spill(self, state, pairs) -> None:
        """Zero the ``pairs``' rows on the card (after ``archive``)."""
        own = self._local(pairs)
        if own:
            with self._on_copy_stream():
                slots, pages = self._index([loc for _, loc in own])
                spill_kv_rows_pairs(state, slots, pages)
        for s, p in pairs:
            self.resident[s, p] = False

    def fill(self, state, pairs) -> None:
        """Copy the ``pairs``' far rows back onto the card, one batched
        write. Every filled page was spilled earlier, so its rows are in
        the far store."""
        for s, p in pairs:
            self.resident[s, p] = True
        own = self._local(pairs)
        if not own:
            return
        first = self.far[pairs[own[0][0]]]
        with self._on_copy_stream():
            rows = torch.empty((len(own),) + tuple(first.shape), dtype=first.dtype,
                               device=self.device)
            t0 = self._event()
            for j, (i, _) in enumerate(own):
                rows[j].copy_(self.far[pairs[i]], non_blocking=self._cuda)
            self._time("h2d", rows.nbytes, t0)
            slots, pages = self._index([loc for _, loc in own])
            fill_kv_rows_pairs(state, slots, pages, rows)
        self.h2d_bytes += rows.nbytes

    def transfer_times(self) -> dict:
        """{"h2d" / "d2h": (bytes, milliseconds)} of the timed copies so
        far, the card's time (CUDA events on the copy stream); empty on the
        CPU. Waits for the copies."""
        out = {}
        for direction, nbytes, t0, t1 in self._timed:
            t1.synchronize()
            b, ms = out.get(direction, (0, 0.0))
            out[direction] = (b + nbytes, ms + t0.elapsed_time(t1))
        return out


class DecodeStepSave:
    """What one decode step of a batched serve state writes, saved before
    the step so that it can be undone: the lengths; each paged layer's
    selection, importance and page starts whole; per slot, the physical
    page its next token lands in (its K and V rows and τ min/max) and the
    streaming ring's slot (K, V and position); each recurrent layer's
    state whole (a step advances all of it: ~59 MB a slot at zamba2-2.7b);
    and the ``extra`` tensors (the engine's token feed and generation
    indices). A few MB at llama3-8b, where a copy of the whole state would
    be GBs.

    The tiered select step saves before its pass; a replay after a cold
    miss restores first, so that it runs on the state the first pass read.
    The indices are taken from the lengths at ``save`` and kept for
    ``restore``. Fixed shapes: both are captured once on the card.

    ``place`` (the paged layers' ``Placement``): the state is one rank's
    block of a GSPMD layout. Each per-slot leaf then saves its block's rows
    at the local index of the slot's page (clamped into the block where
    another rank holds the page: the step writes nothing there, so the
    restore writes back what it found), and each recurrent layer the rows
    of its block, the slots the rank holds. A full cache (a window layer)
    is not saved: its append rewrites the same key at the same position
    when the step is replayed."""

    def __init__(self, state, extra, *, sink: int, phys_shards: int = 1, place=None):
        self.state = state
        self.extra = list(extra)
        self.sink = int(sink)
        self.phys_shards = int(phys_shards)
        b = state["length"].shape[0]
        dev = state["length"].device
        pages = next(layer["paged"].k_pages for layer in state["layers"]
                     if "paged" in layer)
        self._pages = (place.shapes[("paged", "k_pages")][2] if place is not None
                       else pages.shape[2])
        self._page_size = place.page if place is not None else pages.shape[3]
        whole = ((0, b), (0, self._pages))
        # (rows, pages) of each kind of per-slot leaf in the rank's block
        self._bounds = {"pages": whole, "tau": whole, "ring": whole}
        if place is not None:
            self._bounds = {kind: (place.bounds[leaf][0], place.bounds[leaf][2])
                            for kind, leaf in (("pages", ("paged", "k_pages")),
                                               ("tau", ("paged", "tau_min")),
                                               ("ring", ("stream", "k")))}
        self._bi = {k: torch.arange(r1 - r0, device=dev)
                    for k, ((r0, r1), _) in self._bounds.items()}
        self._idx = {k: torch.zeros(r1 - r0, dtype=torch.long, device=dev)
                     for k, ((r0, r1), _) in self._bounds.items()}
        self._bufs = [torch.empty_like(t) for t in self._whole()]
        self._rows = [torch.empty_like(t[self._bi[k], :, self._idx[k]])
                      for t, k in self._per_slot()]
        self.save()  # a restore before any step writes what the state holds

    def _whole(self):
        yield self.state["length"]
        for layer in self.state["layers"]:
            paged = layer.get("paged")
            if paged is not None:
                yield from (paged.sel_idx, paged.importance, paged.page_start)
            for key in ("ssm", "xl"):
                if key in layer:
                    yield from state_fields(layer[key]).values()
        yield from self.extra

    def _per_slot(self):
        for layer in self.state["layers"]:
            paged, stream = layer.get("paged"), layer.get("stream")
            if paged is not None:
                yield from ((paged.k_pages, "pages"), (paged.v_pages, "pages"),
                            (paged.tau_min, "tau"), (paged.tau_max, "tau"))
            if stream is not None:
                yield from ((stream.k, "ring"), (stream.v, "ring"), (stream.pos, "ring"))

    def _indices(self) -> None:
        length = self.state["length"].long()
        c = self._pages
        page = interleave_slot((length // self._page_size).clamp(0, c - 1), c,
                               self.phys_shards)
        for kind in ("pages", "tau"):
            (r0, r1), (c0, c1) = self._bounds[kind]
            self._idx[kind].copy_((page[r0:r1] - c0).clamp(0, c1 - c0 - 1))
        stream = next((layer["stream"] for layer in self.state["layers"]
                       if "stream" in layer), None)
        if stream is not None:
            (r0, r1), _ = self._bounds["ring"]
            local_cap = stream.k.shape[2] - self.sink
            lr = length[r0:r1]
            self._idx["ring"].copy_(torch.where(lr < self.sink, lr,
                                                self.sink + (lr - self.sink) % local_cap))

    def save(self) -> None:
        self._indices()
        for buf, t in zip(self._bufs, self._whole()):
            buf.copy_(t)
        for buf, (t, k) in zip(self._rows, self._per_slot()):
            buf.copy_(t[self._bi[k], :, self._idx[k]])

    def restore(self) -> None:
        for buf, (t, k) in zip(self._rows, self._per_slot()):
            t[self._bi[k], :, self._idx[k]] = buf
        for buf, t in zip(self._bufs, self._whole()):
            t.copy_(buf)


# ---------------------------------------------------------------------------
# Prefill constructors (build caches from full-sequence K/V)
# ---------------------------------------------------------------------------


def paged_cache_from_prefill(k, v, num_pages: int, page: int, top_k: int) -> PagedCache:
    """k/v: (B, S, Hr, D) with S % page == 0 -> PagedCache with S // page
    pages filled."""
    b, s, h, d = k.shape
    n_filled = s // page
    kp = k.permute(0, 2, 1, 3).reshape(b, h, n_filled, page, d)
    vp = v.permute(0, 2, 1, 3).reshape(b, h, n_filled, page, d)
    dev = k.device
    k_pages = torch.zeros((b, h, num_pages, page, d), dtype=k.dtype, device=dev)
    v_pages = torch.zeros_like(k_pages)
    k_pages[:, :, :n_filled] = kp
    v_pages[:, :, :n_filled] = vp
    kf = kp.float()
    tau_min = torch.full((b, h, num_pages, d), float("inf"), device=dev)
    tau_max = torch.full((b, h, num_pages, d), float("-inf"), device=dev)
    tau_min[:, :, :n_filled] = kf.amin(dim=3)
    tau_max[:, :, :n_filled] = kf.amax(dim=3)
    idx = torch.arange(num_pages, dtype=torch.int32, device=dev)
    start = torch.where(idx < n_filled, idx * page, -1).to(torch.int32)
    return PagedCache(
        k_pages=k_pages, v_pages=v_pages, tau_min=tau_min, tau_max=tau_max,
        importance=torch.zeros((b, h, num_pages), dtype=torch.float32, device=dev),
        page_start=start.expand(b, h, num_pages).contiguous(),
        sel_idx=torch.zeros((b, h, top_k), dtype=torch.int32, device=dev))


def stream_cache_from_prefill(k, v, *, sink: int, local_cap: int,
                              length: int) -> StreamCache:
    """k/v: (B, S, Hs, D); keep the sink and the last min(local_cap,
    S - sink) tokens, each in the slot a ring append would have used."""
    b, s, h, d = k.shape
    cache = make_stream_cache(b, h, sink, local_cap, d, dtype=k.dtype,
                              device=k.device)
    pos = torch.arange(s, device=k.device)
    keep = (pos < sink) | (pos >= max(sink, length - local_cap))
    pos = pos[keep]
    slot = torch.where(pos < sink, pos, sink + (pos - sink) % local_cap)
    cache.k[:, :, slot] = k.permute(0, 2, 1, 3)[:, :, pos]
    cache.v[:, :, slot] = v.permute(0, 2, 1, 3)[:, :, pos]
    cache.pos[:, :, slot] = pos.to(torch.int32)
    return cache
