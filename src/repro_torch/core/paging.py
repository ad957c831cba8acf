"""Page selection for retrieval heads (counterpart of ``repro/core/paging.py``).

Scores every page from its τ min/max metadata, keeps the top-k, and
builds the [sink pages | selected pages | local pages] buffer with a
validity mask. The page partition, for context length ctx:

  first_local = max(ctx - local, 0) // P
  sink section:     pages [0, n_sink), every in-context token
  local section:    pages [first_local, first_local + n_local), tokens valid
                    iff pos >= max(first_local, n_sink) * P
  selected section: top-k over pages in [n_sink, first_local)

The sections never overlap, and they cover every resident token when
top-k spans all selectable pages. ``ctx`` is a Python int: only the
lockstep path is ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

NEG_INF = -1e30


def page_counts(*, sink: int, local: int, page: int) -> tuple[int, int]:
    """(n_sink_pages, n_local_pages) always attended."""
    n_sink = -(-sink // page) if sink else 0
    n_local = -(-local // page) + 1 if local else 0  # +1 boundary page
    return n_sink, n_local


def first_local_page(ctx: int, *, local: int, page: int) -> int:
    return max(ctx - local, 0) // page


def score_pages(q, tau_min, tau_max, page_start, ctx: int, *, sink: int,
                local: int, page: int):
    """Scores (B, Hkv, C); sink, local and empty pages forced to NEG_INF."""
    scores = kops.page_score(q, tau_min, tau_max)
    n_sink, _ = page_counts(sink=sink, local=local, page=page)
    first_local = first_local_page(ctx, local=local, page=page)
    pidx = torch.where(page_start >= 0, page_start // page, -1)
    selectable = (page_start >= 0) & (pidx >= n_sink) & (pidx < first_local)
    return torch.where(selectable, scores, NEG_INF)


def select_pages(scores, top_k: int):
    """Top-k page slots per (B, Hkv): (B, Hkv, K) int32, padded with -1
    when fewer than ``top_k`` pages exist. Ties may break differently from
    ``lax.top_k``; the tied pages are the masked ones, which
    ``token_validity`` drops either way."""
    k_eff = min(top_k, scores.shape[-1])
    idx = torch.topk(scores, k_eff, dim=-1).indices.to(torch.int32)
    if k_eff < top_k:
        pad = torch.full(idx.shape[:-1] + (top_k - k_eff,), -1,
                         dtype=torch.int32, device=idx.device)
        idx = torch.cat([idx, pad], dim=-1)
    return idx


def attended_page_slots(sel_idx, ctx: int, *, sink: int, local: int, page: int):
    """[sink pages | selected pages | local pages] slot indices,
    (B, Hkv, n_sink + K + n_local) int32 (slot == page index == pos // P)."""
    b, h, _ = sel_idx.shape
    n_sink, n_local = page_counts(sink=sink, local=local, page=page)
    dev = sel_idx.device
    first_local = first_local_page(ctx, local=local, page=page)
    sink_pages = torch.arange(n_sink, dtype=torch.int32, device=dev)
    local_pages = first_local + torch.arange(n_local, dtype=torch.int32,
                                             device=dev)
    return torch.cat([sink_pages.expand(b, h, n_sink), sel_idx,
                      local_pages.expand(b, h, n_local)], dim=2)


def gather_pages(k_pages, v_pages, slots):
    """k/v_pages: (B, H, C, P, D); slots: (B, H, N) -> (B, H, N*P, D) each."""
    b, h, _, p, d = k_pages.shape
    n = slots.shape[2]
    sc = slots.clamp(min=0).long()
    bi = torch.arange(b, device=slots.device)[:, None, None]
    hi = torch.arange(h, device=slots.device)[None, :, None]
    return (k_pages[bi, hi, sc].reshape(b, h, n * p, d),
            v_pages[bi, hi, sc].reshape(b, h, n * p, d))


def token_validity(slots, page_start, ctx: int, *, sink: int, local: int,
                   page: int, top_k: int):
    """Validity mask (B, H, N*P) of the gathered token buffer, enforcing
    the section partition of the module docstring."""
    b, h, n = slots.shape
    n_sink, n_local = page_counts(sink=sink, local=local, page=page)
    dev = slots.device
    sentinel = (slots < 0)[..., None]
    start = torch.gather(page_start, 2, slots.clamp(min=0).long())
    pos = start[..., None] + torch.arange(page, dtype=torch.int32, device=dev)
    nonempty = (start >= 0)[..., None]
    in_ctx = pos < ctx
    sec = torch.cat([
        torch.zeros(n_sink, dtype=torch.int32, device=dev),
        torch.ones(top_k, dtype=torch.int32, device=dev),
        torch.full((n_local,), 2, dtype=torch.int32, device=dev),
    ])[None, None, :, None]
    first_local = first_local_page(ctx, local=local, page=page)
    pidx = torch.div(start, page, rounding_mode="floor")
    ok_local = ((pos >= max(first_local, n_sink) * page)
                & (pidx >= first_local)[..., None])
    ok_sel = ((pidx >= n_sink) & (pidx < first_local))[..., None]
    ok = torch.where(sec == 0, True, torch.where(sec == 2, ok_local, ok_sel))
    return (nonempty & in_ctx & ok & ~sentinel).reshape(b, h, n * page)


def accumulate_importance(importance, scores):
    """Add this step's scores; masked (NEG_INF) pages contribute 0."""
    return importance + torch.where(scores > NEG_INF / 2, scores, 0.0)
