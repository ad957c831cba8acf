"""KV-cache structures for H²EAL serving (counterpart of ``repro/core/cache.py``).

  FullCache    dense (B, H, S, D) baseline, used when H²EAL is disabled.
  PagedCache   retrieval heads: paged KV + per-page key min/max (τ)
               metadata + accumulated importance + page_start table.
  StreamCache  streaming heads: sink + local ring buffer.

Only the lockstep (scalar ``length``) path is ported. Unlike the JAX
package, whose arrays are immutable, the appends here write into the
cache tensors IN PLACE and return the same cache object: one decode step
then moves a token's worth of bytes, not a copy of the cache.
"""
from __future__ import annotations

import dataclasses

import torch


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


# ---------------------------------------------------------------------------
# Appends: one token for all heads of one layer, at position ``length`` (int)
# ---------------------------------------------------------------------------


def full_cache_append(cache: FullCache, k_new, v_new, length: int) -> FullCache:
    """k_new/v_new: (B, Hkv, D) written at slot ``length`` (in place)."""
    cache.k[:, :, length] = k_new.to(cache.k.dtype)
    cache.v[:, :, length] = v_new.to(cache.v.dtype)
    return cache


def stream_cache_append(cache: StreamCache, k_new, v_new, length: int, *,
                        sink: int) -> StreamCache:
    """Ring append (in place): positions below ``sink`` keep their own slot,
    later ones cycle over the local part."""
    local_cap = cache.k.shape[2] - sink
    slot = length if length < sink else sink + (length - sink) % local_cap
    cache.k[:, :, slot] = k_new.to(cache.k.dtype)
    cache.v[:, :, slot] = v_new.to(cache.v.dtype)
    cache.pos[:, :, slot] = length
    return cache


def paged_cache_append(cache: PagedCache, k_new, v_new, length: int) -> PagedCache:
    """Append one token at position ``length`` (page = length // P), in
    place, updating the page's running τ min/max and its start."""
    p = cache.k_pages.shape[3]
    page, off = divmod(length, p)
    cache.k_pages[:, :, page, off] = k_new.to(cache.k_pages.dtype)
    cache.v_pages[:, :, page, off] = v_new.to(cache.v_pages.dtype)
    kf = k_new.float()
    cache.tau_min[:, :, page] = torch.minimum(cache.tau_min[:, :, page], kf)
    cache.tau_max[:, :, page] = torch.maximum(cache.tau_max[:, :, page], kf)
    cache.page_start[:, :, page] = page * p
    return cache


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
