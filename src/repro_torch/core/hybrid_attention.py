"""H²EAL hybrid static-dynamic sparse attention (paper §IV-A).

Counterpart of ``repro/core/hybrid_attention.py``: the lockstep path, the
ragged decode of the continuous-batching engine and its chunked prefill.
Per attention layer the KV heads are reordered by a permutation so the
first ``n_retrieval`` are retrieval heads and the rest streaming heads.
``perm=None`` is the identity and skips the reordering (and its index
kernels) altogether; that is what serving passes.

Prefill:  retrieval heads -> full causal flash attention;
          streaming heads -> sink+local flash attention.
Decode:   retrieval heads -> page score -> top-k -> paged attention over
          [sink pages | selected pages | local pages];
          streaming heads -> attention over the sink+local ring buffer.
Selection is recomputed every ``share_window`` steps (``do_select``).
Chunked prefill: a chunk of prompt tokens per slot attends the
          pre-append caches plus the chunk itself (retrieval heads full
          causal, streaming heads sink+local), then is appended.

The caches are updated in place (see ``repro_torch/core/cache.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import H2ealConfig
from repro_torch.core import cache as cachelib
from repro_torch.core import paging
from repro_torch.kernels import ops as kops


@dataclass(frozen=True)
class AttnSpec:
    """Static attention-layer spec."""

    n_q: int
    n_kv: int
    head_dim: int
    h2: H2ealConfig
    window: int = 0  # >0: plain sliding-window layer (not ported yet)

    @property
    def group(self) -> int:
        return self.n_q // self.n_kv

    @property
    def n_retrieval(self) -> int:
        if not self.h2.enabled or self.window > 0:
            return self.n_kv
        n_s = round(self.n_kv * self.h2.static_sparsity)
        return max(self.n_kv - n_s, 0)

    @property
    def n_streaming(self) -> int:
        return self.n_kv - self.n_retrieval


def _permute_kv(x, perm):
    """x permuted on its kv-head axis (axis 2 of (B,S,H,D), 1 of (B,H,D))."""
    if perm is None:
        return x
    return x.index_select(2 if x.dim() == 4 else 1, perm.long())


def _permute_q(q, perm, group: int):
    """q: (B, S, Hq, D) or (B, Hq, D): q heads permuted by kv group."""
    if perm is None:
        return q
    shape = q.shape
    axis = q.dim() - 2
    qg = q.reshape(*shape[:axis], shape[axis] // group, group, shape[-1])
    return qg.index_select(axis, perm.long()).reshape(shape)


def _inverse_perm(perm):
    if perm is None:
        return None
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                    device=perm.device)
    return inv


def _local_cap(h2: H2ealConfig) -> int:
    # ring capacity: local window + one page of slack so the boundary page
    # semantics match the paged side
    return h2.local + h2.page_size


def _check_ported(spec: AttnSpec) -> None:
    if spec.window > 0:
        raise NotImplementedError(
            "sliding-window attention layers are not ported yet "
            "(ROADMAP Queue 1 item 11)")


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill_attention(spec: AttnSpec, q, k, v, perm=None):
    """q: (B,S,Hq,D); k/v: (B,S,Hkv,D) -> (B,S,Hq,D)."""
    _check_ported(spec)
    h2 = spec.h2
    if not h2.enabled or spec.n_streaming == 0:
        return kops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True)
    g = spec.group
    nr = spec.n_retrieval
    qp = _permute_q(q, perm, g)
    kp = _permute_kv(k, perm)
    vp = _permute_kv(v, perm)
    outs = []
    if nr > 0:
        outs.append(kops.flash_attention(
            qp[:, :, : nr * g].contiguous(), kp[:, :, :nr].contiguous(),
            vp[:, :, :nr].contiguous(), causal=True))
    outs.append(kops.flash_attention(
        qp[:, :, nr * g:].contiguous(), kp[:, :, nr:].contiguous(),
        vp[:, :, nr:].contiguous(), causal=True, window=h2.local,
        sink=h2.sink))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return _permute_q(out, _inverse_perm(perm), g)


def init_decode_state(spec: AttnSpec, k, v, length: int, capacity: int,
                      perm=None):
    """Build (PagedCache, StreamCache) from prefill K/V.

    k/v: (B, S, Hkv, D) post-rope; length == S. capacity: the most
    context tokens the paged cache must hold.
    """
    _check_ported(spec)
    h2 = spec.h2
    kp = _permute_kv(k, perm)
    vp = _permute_kv(v, perm)
    nr = spec.n_retrieval
    p = h2.page_size
    num_pages = -(-capacity // p)
    s = k.shape[1]
    pad = (-s) % p
    kr, vr = kp[:, :, :nr], vp[:, :, :nr]
    if pad:  # pad the sequence to a page multiple for the paged constructor
        kr = torch.nn.functional.pad(kr, (0, 0, 0, 0, 0, pad))
        vr = torch.nn.functional.pad(vr, (0, 0, 0, 0, 0, pad))
    paged = cachelib.paged_cache_from_prefill(kr, vr, num_pages, p,
                                              h2.top_k_pages)
    if pad:  # recompute the metadata without the pad tokens of the last page
        offs = (torch.arange(num_pages * p, device=k.device) < s).reshape(
            num_pages, p)[None, None, :, :, None]
        kpp = paged.k_pages.float()
        paged.tau_min = torch.where(offs, kpp, float("inf")).amin(dim=3)
        paged.tau_max = torch.where(offs, kpp, float("-inf")).amax(dim=3)
    stream = cachelib.stream_cache_from_prefill(
        kp[:, :, nr:], vp[:, :, nr:], sink=h2.sink, local_cap=_local_cap(h2),
        length=length)
    return paged, stream


def empty_decode_state(spec: AttnSpec, batch: int, capacity: int, *, dtype,
                       device):
    """Empty (PagedCache, StreamCache) of ``batch`` slots, the batched
    state the serving engine starts from."""
    _check_ported(spec)
    h2 = spec.h2
    nr, d = spec.n_retrieval, spec.head_dim
    paged = cachelib.make_paged_cache(batch, nr, -(-capacity // h2.page_size),
                                      h2.page_size, d, h2.top_k_pages,
                                      dtype=dtype, device=device)
    stream = cachelib.make_stream_cache(batch, spec.n_streaming, h2.sink,
                                        _local_cap(h2), d, dtype=dtype,
                                        device=device)
    return paged, stream


def chunk_prefill_attention(spec: AttnSpec, q, k_new, v_new,
                            paged: cachelib.PagedCache,
                            stream: cachelib.StreamCache, start, chunk_len,
                            active=None, *, perm=None):
    """One chunked-prefill step. q: (B, C, Hq, D) roped at the chunk
    positions; k_new/v_new: (B, C, Hkv, D); start: (B,) int32 context before
    the chunk; chunk_len: (B,) valid tokens; active: (B,) bool, the slots
    prefilling. Returns (out (B, C, Hq, D), paged, stream).

    Each head kind attends BEFORE the chunk is appended: retrieval heads
    the pre-append paged cache plus the chunk (``chunk_attention_paged``,
    full causal, as a single-shot prefill); streaming heads the pre-append
    ring followed by the chunk's keys (``chunk_attention``, sink+local),
    since a chunk longer than the ring's slack overwrites ring slots that
    an early chunk query still attends. No page is selected and the
    selection state is left as it is. Rows past chunk_len and inactive
    slots append nothing; their outputs are finite values the caller
    ignores (an inactive slot attends only its own chunk, so the kernels
    skip its cache). Chunked and single-shot prefill sum in different
    orders, so they agree to float tolerance.
    """
    _check_ported(spec)
    h2 = spec.h2
    g = spec.group
    nr = spec.n_retrieval
    qp = _permute_q(q, perm, g)
    kp = _permute_kv(k_new, perm)
    vp = _permute_kv(v_new, perm)
    b, cch = q.shape[:2]
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=q.device)
    outs = []
    if nr > 0:
        k_r, v_r = kp[:, :, :nr].contiguous(), vp[:, :, :nr].contiguous()
        # a slot that takes no chunk attends no cached key: its rows are
        # ignored, and the kernel then skips its whole cache walk
        outs.append(kops.chunk_attention_paged(
            qp[:, :, : nr * g].contiguous(), paged.k_pages, paged.v_pages,
            paged.page_start, torch.where(active, start, 0), k_r, v_r))
        paged = cachelib.paged_cache_append_chunk(paged, k_r, v_r, start,
                                                  chunk_len, active=active)
    if spec.n_streaming > 0:
        ns = spec.n_streaming
        k_s, v_s = kp[:, :, nr:], vp[:, :, nr:]
        kr = torch.cat([stream.k, k_s.transpose(1, 2).to(stream.k.dtype)], dim=2)
        vr = torch.cat([stream.v, v_s.transpose(1, 2).to(stream.v.dtype)], dim=2)
        pos_q = paging.chunk_positions(start, cch)
        kpos = torch.cat([stream.pos, pos_q[:, None, :].expand(b, ns, cch)],
                         dim=2)
        valid_s = paging.chunk_stream_validity(kpos, pos_q, sink=h2.sink,
                                               local=h2.local)
        valid_s &= active[:, None, None, None]  # ignored rows: no key tile runs
        outs.append(kops.chunk_attention(qp[:, :, nr * g:].contiguous(), kr, vr,
                                         valid_s))
        stream = cachelib.stream_cache_append_chunk(
            stream, k_s, v_s, start, chunk_len, sink=h2.sink, active=active)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return _permute_q(out, _inverse_perm(perm), g), paged, stream


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_attention(spec: AttnSpec, q, k_new, v_new,
                     paged: cachelib.PagedCache, stream: cachelib.StreamCache,
                     length, *, do_select: bool, perm=None, active=None,
                     need_select=None):
    """One decode step. q: (B,Hq,D) roped at position ``length`` (the
    context before this token); k_new/v_new: (B,Hkv,D).

    ``length`` is an int on the lockstep path and a (B,) tensor on the
    continuous-batching path, which also passes ``active`` (B,) bool
    (inactive slots append nothing, so their caches stay as they are) and,
    on a select step, ``need_select`` (B,) bool: only those slots take the
    fresh selection and importance, the others keep their cached ones.
    Returns (out (B,Hq,D), paged, stream)."""
    _check_ported(spec)
    h2 = spec.h2
    g = spec.group
    nr = spec.n_retrieval
    qp = _permute_q(q, perm, g)
    kp = _permute_kv(k_new, perm)
    vp = _permute_kv(v_new, perm)
    q_r, q_s = qp[:, : nr * g].contiguous(), qp[:, nr * g:].contiguous()
    ctx = length + 1
    _, n_local = paging.page_counts(sink=h2.sink, local=h2.local,
                                    page=h2.page_size)
    if nr > 0 and not isinstance(ctx, torch.Tensor) and (
            paging.first_local_page(ctx, local=h2.local, page=h2.page_size)
            + n_local > paged.k_pages.shape[2]):
        raise ValueError(
            f"context {ctx} needs more pages than the cache's "
            f"{paged.k_pages.shape[2]}: serve with capacity >= context + "
            f"page_size")

    outs = []
    if nr > 0:
        paged = cachelib.paged_cache_append(paged, kp[:, :nr], vp[:, :nr],
                                            length, active)
        if do_select:
            scores = paging.score_pages(
                q_r, paged.tau_min, paged.tau_max, paged.page_start, ctx,
                sink=h2.sink, local=h2.local, page=h2.page_size)
            sel = paging.select_pages(scores, h2.top_k_pages)
            imp = paging.accumulate_importance(paged.importance, scores)
            if need_select is not None:
                ns = need_select[:, None, None]
                sel = torch.where(ns, sel, paged.sel_idx)
                imp = torch.where(ns, imp, paged.importance)
            paged.sel_idx, paged.importance = sel, imp
        slots = paging.attended_page_slots(
            paged.sel_idx, ctx, sink=h2.sink, local=h2.local,
            page=h2.page_size)
        gk, gv = paging.gather_pages(paged.k_pages, paged.v_pages, slots)
        valid = paging.token_validity(
            slots, paged.page_start, ctx, sink=h2.sink, local=h2.local,
            page=h2.page_size, top_k=h2.top_k_pages)
        outs.append(kops.paged_attention(q_r, gk, gv, valid))
    if spec.n_streaming > 0:
        stream = cachelib.stream_cache_append(stream, kp[:, nr:], vp[:, nr:],
                                              length, sink=h2.sink,
                                              active=active)
        # exact sink+local mask (the ring carries one page of slack)
        ctx_b = ctx[:, None, None] if isinstance(ctx, torch.Tensor) else ctx
        valid_s = (stream.pos >= 0) & (
            (stream.pos < h2.sink) | (stream.pos >= ctx_b - h2.local))
        outs.append(kops.paged_attention(q_s, stream.k, stream.v, valid_s))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return _permute_q(out, _inverse_perm(perm), g), paged, stream


def full_decode_attention(spec: AttnSpec, q, k_new, v_new,
                          cache: cachelib.FullCache, length, active=None):
    """Full-attention baseline decode step (H²EAL disabled); ``length`` an
    int or a (B,) tensor, as in ``decode_attention``."""
    _check_ported(spec)
    cache = cachelib.full_cache_append(cache, k_new, v_new, length, active)
    b, h, s, _ = cache.k.shape
    pos = torch.arange(s, device=q.device)
    lb = length[:, None, None] if isinstance(length, torch.Tensor) else length
    valid = (pos < lb + 1).expand(b, h, s).contiguous()
    return kops.paged_attention(q.contiguous(), cache.k, cache.v, valid), cache
