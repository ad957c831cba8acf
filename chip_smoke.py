#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
then, each phase failing the run with a nonzero exit:

  1. prints the card's name and power limit (nvidia-smi);
  2. holds every kernel against its plain PyTorch version on the card, at
     the shapes the serving paths give it, in bf16 and f32 (the plain
     version runs on the inputs widened to f32), and times the
     kernel, the plain version and, where one PyTorch call computes the
     same function, that call;
  3. holds a reduced llama3-8b ``generate`` and a reduced chunked
     ``Engine`` run (with slot churn) on the card against the same runs on
     the CPU (plain versions, same weights);
  4. serves llama3-8b at full width and depth (bf16, seeded random
     weights) through lockstep ``generate``: 2 prompts of 8192 tokens, 32
     greedy tokens, hybrid sparse attention, with the kernels' launch
     counts checked exactly; then the same prompts with full attention,
     for token agreement;
  5. serves llama3-8b at full width and depth through the
     continuous-batching ``Engine``: 6 requests with ragged prompts
     (2048-8192 tokens) and generations (8-32 tokens) on 4 slots, chunked
     prefill of 512 tokens a step, launch counts checked exactly against
     the engine's step counts and every engine step run with CUDA's sync
     debug mode set to error (a step that reads from the card fails the
     run); then the same requests with prefill-then-pack admission;
  6. the ``coplace_shmap`` layout over 8 page stripes (split-KV decode):
     a reduced chunked engine with churn and balanced admission, card
     against CPU; one decode step of one llama3-8b layer from the 8192-token
     lockstep prefill, its retrieval-head outputs held against the default
     layout's (and the full logits' difference printed); then the full-width
     chunked engine of phase 5 with balanced admission, launch counts
     checked exactly and every step under sync debug mode "error".

Prints a ``{"kernels": [...]}`` line and, last, the device line. Exits
nonzero without a result when no CUDA device is available or the port's
sources are missing.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

# tolerances of kernel against plain version, elementwise:
# |kernel - plain| <= rtol * |plain| + atol. Each kernel computes in f32 and
# rounds only its output to the storage dtype, so it is held against the
# plain version run on the same inputs widened to f32. In f32 the two differ
# by summation order alone; in bf16 also by the output's rounding, at most
# half a bf16 step (2^-8 of the value), hence the relative term
TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -8, 1e-5)}
# page_score does its arithmetic in f32 on both sides whatever q's dtype,
# and its scores reach ~1e3: its error is scaled by the largest score
SCORE_RTOL = 1e-6
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12

ARCH = "llama3-8b"
BATCH, PROMPT, GEN = 2, 8192, 32
# the engine phase: 6 requests on 4 slots, prompts of 2048-8192 tokens and
# generations of 8-32 tokens, fed 512 prompt tokens an engine step
ENGINE_BATCH, ENGINE_CHUNK, N_REQUESTS = 4, 512, 6
ENGINE_PROMPTS, ENGINE_GENS = (2048, 8192), (8, 32)
# chunk-kernel phase: the context before the chunk of each of the 4 slots
CHUNK_STARTS = (0, 2048, 5120, 7680)
# coplace_shmap: page stripes, and the context of each of the 4 slots in the
# partial-kernel phase
SHARDS = 8
STRIPE_CTX = (8200, 7000, 5000, 3000)
FLUSH_BYTES = 256 << 20  # more than the 50 MB L2


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class Timer:
    """Median device time of a call, with the L2 flushed before each run."""

    def __init__(self, dev):
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def ms(self, fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def serve_capacity(cfg) -> int:
    """The serving CLI's rule: prompt + generated tokens + one page, so the
    local section's last page stays inside the cache at the final step."""
    return PROMPT + GEN + cfg.h2eal.page_size


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(byte_count: int, flops: float, dtype):
    tb = byte_count / PEAK_BYTES * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def widened(*ts):
    return [t.float() if t.is_floating_point() else t for t in ts]


def excess(out, want, dtype) -> float:
    """Largest |out - want| - (rtol |want| + atol): within tolerance at <= 0."""
    rtol, atol = TOL[dtype]
    want = want.float()
    return ((out.float() - want).abs() - rtol * want.abs() - atol).max().item()


def tol_text(dtype) -> str:
    rtol, atol = TOL[dtype]
    return f"{rtol:.4g}*|plain| + {atol:.0e}"


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_pairs(s: int, window: int, sink: int) -> int:
    """Attended (query, key) pairs of one head, causal, q_offset 0."""
    if window <= 0:
        return s * (s + 1) // 2
    total = 0
    for i in range(s):
        in_win = min(i + 1, window)
        total += in_win + max(0, min(sink, i + 1 - in_win))
    return total


def check_flash(ops, ref, timer, dev, cfg, dtype, gen):
    h2 = cfg.h2eal
    hkv = cfg.num_kv_heads
    nr = hkv - round(hkv * h2.static_sparsity)
    g = cfg.num_heads // hkv
    d = cfg.resolved_head_dim
    cases = []
    for label, heads, window, sink in (("retrieval", nr, 0, 0),
                                       ("streaming", hkv - nr, h2.local, h2.sink)):
        q = torch.randn(BATCH, PROMPT, heads * g, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(BATCH, PROMPT, heads, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(BATCH, PROMPT, heads, d, generator=gen, device=dev).to(dtype)
        run = lambda: ops.flash_attention(q, k, v, causal=True, window=window, sink=sink)
        plain = lambda: ref.flash_attention_ref(q, k, v, causal=True, window=window, sink=sink)
        out = run()
        want = ref.flash_attention_ref(*widened(q, k, v), causal=True, window=window,
                                       sink=sink)
        torch.cuda.synchronize()
        e, ex = err(out, want), excess(out, want, dtype)
        del want
        ms = timer.ms(run, 5)
        plain_ms = timer.ms(plain, 2)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            i = torch.arange(PROMPT, device=dev)[:, None]
            j = torch.arange(PROMPT, device=dev)[None, :]
            mask = (j <= i) & ((j > i - window) | (j < sink))
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True)
        lib_ms = timer.ms(lib, 5)
        flops = 4 * d * flash_pairs(PROMPT, window, sink) * BATCH * heads * g
        b_ms, b_by = bound(nbytes(q, k, v, out), flops, dtype)
        cases.append(dict(
            case=f"{label} B={BATCH} S={PROMPT} Hq={heads * g} Hkv={heads} D={d}",
            dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex,
            tol=tol_text(dtype), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by))
        del q, k, v, out
        torch.cuda.empty_cache()
    return cases


def make_tau(gen, dev, b, h, c, filled, d):
    keys = torch.randn(b, h, filled, 32, d, generator=gen, device=dev)
    tau_min = torch.full((b, h, c, d), math.inf, device=dev)
    tau_max = torch.full((b, h, c, d), -math.inf, device=dev)
    tau_min[:, :, :filled] = keys.amin(dim=3)
    tau_max[:, :, :filled] = keys.amax(dim=3)
    return tau_min, tau_max


def check_page_score(ops, ref, timer, dev, cfg, dtype, gen, capacity):
    h2 = cfg.h2eal
    hkv = cfg.num_kv_heads
    nr = hkv - round(hkv * h2.static_sparsity)
    g = cfg.num_heads // hkv
    d = cfg.resolved_head_dim
    c = -(-capacity // h2.page_size)
    filled = PROMPT // h2.page_size
    q = torch.randn(BATCH, nr * g, d, generator=gen, device=dev).to(dtype)
    tau_min, tau_max = make_tau(gen, dev, BATCH, nr, c, filled, d)
    run = lambda: ops.page_score(q, tau_min, tau_max)
    plain = lambda: ref.page_score_ref(q, tau_min, tau_max)
    out, want = run(), plain()
    torch.cuda.synchronize()
    if not torch.equal(out.isnan(), want.isnan()) or not torch.equal(
            out.isinf(), want.isinf()):
        fail("page_score: NaN/inf pattern differs from the plain version")
    fin = want.isfinite()
    e = err(out[fin], want[fin])
    ex = e - SCORE_RTOL * want[fin].abs().max().item()
    flops = 4 * d * g * c * BATCH * nr
    b_ms, b_by = bound(nbytes(q, tau_min, tau_max, out), flops, torch.float32)
    return [dict(
        case=f"select B={BATCH} Hr={nr} g={g} C={c} D={d}",
        dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex,
        tol=f"{SCORE_RTOL:.0e}*max|plain|", ms=timer.ms(run, 20), plain_ms=timer.ms(plain, 20),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)]


def check_paged(ops, ref, timer, dev, cfg, dtype, gen, capacity):
    from repro_torch.core.paging import page_counts

    h2 = cfg.h2eal
    hkv = cfg.num_kv_heads
    nr = hkv - round(hkv * h2.static_sparsity)
    g = cfg.num_heads // hkv
    d = cfg.resolved_head_dim
    n_sink, n_local = page_counts(sink=h2.sink, local=h2.local, page=h2.page_size)
    t_ret = (n_sink + h2.top_k_pages + n_local) * h2.page_size
    t_str = h2.sink + h2.local + h2.page_size
    cases = []
    for label, heads, t in (("retrieval", nr, t_ret), ("streaming", hkv - nr, t_str),
                            ("full-attention baseline", hkv, capacity)):
        q = torch.randn(BATCH, heads * g, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(BATCH, heads, t, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(BATCH, heads, t, d, generator=gen, device=dev).to(dtype)
        valid = torch.rand(BATCH, heads, t, generator=gen, device=dev) < 0.9
        valid[0, 0] = False  # one all-invalid row: its output must be 0
        run = lambda: ops.paged_attention(q, k, v, valid)
        plain = lambda: ref.paged_attention_ref(q, k, v, valid)
        out, want = run(), ref.paged_attention_ref(*widened(q, k, v), valid)
        torch.cuda.synchronize()
        if out[0, :g].abs().max().item() != 0.0:
            fail(f"paged_attention ({label}): an all-invalid row is not 0")
        e, ex = err(out, want), excess(out, want, dtype)
        mask = valid.repeat_interleave(g, dim=1)[:, :, None, :]
        lib_mask = mask.clone()
        lib_mask[0, :g] = True  # SDPA gives NaN for an all-masked row
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=lib_mask, enable_gqa=True)
        flops = 4 * d * g * int(valid.sum().item())
        b_ms, b_by = bound(nbytes(q, k, v, valid, out), flops, dtype)
        cases.append(dict(
            case=f"{label} B={BATCH} Hq={heads * g} Hkv={heads} T={t} D={d}",
            dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex,
            tol=tol_text(dtype), ms=timer.ms(run, 20), plain_ms=timer.ms(plain, 20),
            library_ms=timer.ms(lib, 20), bound_ms=b_ms, bound_by=b_by))
    return cases


def partial_excess(got, want) -> float:
    """Largest excess of the partial over the f32 tolerance. Its outputs are
    f32 whatever the operands' dtype (bf16 operands are exact in f32), so
    they differ from the plain version by summation order alone; l and o
    reach the attention output divided by l, so they are held in units of
    max(l, 1), m in units of max(|m|, 1)."""
    atol = TOL[torch.float32][1]
    (m, l, o), (wm, wl, wo) = got, want
    scale = wl.clamp(min=1.0)
    return max(((m - wm).abs() - atol * wm.abs().clamp(min=1.0)).max().item(),
               ((l - wl).abs() - atol * scale).max().item(),
               ((o - wo).abs() - atol * scale[..., None]).max().item())


def stripe_inputs(gen, dev, cfg, dtype):
    """The retrieval heads' decode inputs of the coplace_shmap path at its
    main shapes: 4 slots at contexts STRIPE_CTX in a cache of the engine
    capacity rounded to whole pages of SHARDS stripes (264 pages of 32),
    the striped page order, a random top-128 selection of each slot's
    selectable pages (-1 padded where fewer), the [sink | selected |
    local] slot list (138 slots, 4416 tokens) and its validity, split over
    the stripes as the decode body splits them."""
    from repro_torch.core import layouts, paging
    from repro_torch.core.hybrid_attention import stripe_slots

    h2 = cfg.h2eal
    nr, _, g, d = head_split(cfg)
    p, top_k = h2.page_size, h2.top_k_pages
    cap = layouts.get_layout("coplace_shmap", SHARDS).plan(cfg).round_capacity(
        engine_workload(cfg)[1])
    c = cap // p
    b = len(STRIPE_CTX)
    ctx = torch.tensor(STRIPE_CTX, device=dev)
    lop = paging.logical_pages(c, SHARDS, dev)                    # (C,)
    start = torch.where(lop[None] * p < ctx[:, None], lop[None] * p, -1)
    start = start[:, None, :].expand(b, nr, c).to(torch.int32).contiguous()
    rng = np.random.default_rng(3)
    sel = np.full((b, nr, top_k), -1, np.int64)
    for bi, n_ctx in enumerate(STRIPE_CTX):
        first_local = max(n_ctx - h2.local, 0) // p
        pages = np.arange(-(-h2.sink // p), first_local)
        for hi in range(nr):
            pick = rng.permutation(pages)[:top_k]
            sel[bi, hi, :len(pick)] = pick
    sel = torch.from_numpy(sel).to(dev)
    sel = torch.where(sel >= 0, paging.interleave_slot(sel, c, SHARDS), -1)
    slots = paging.coplace_attended_slots(sel, ctx, sink=h2.sink, local=h2.local,
                                          page=p, capacity=c, n_shards=SHARDS)
    valid = paging.token_validity(slots, start, ctx, sink=h2.sink, local=h2.local,
                                  page=p, top_k=top_k)
    slots_s, valid_s = stripe_slots(slots, valid, shards=SHARDS, capacity=c)
    q = torch.randn(b, nr * g, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(b, nr, c, p, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(b, nr, c, p, d, generator=gen, device=dev).to(dtype)
    return q, kp, vp, slots_s, valid_s


def check_partial(ops, ref, timer, dev, cfg, dtype, gen):
    """paged_attention_partial at the coplace_shmap path's shapes; then
    combine_partials on the partials it produced."""
    q, kp, vp, slots, valid = stripe_inputs(gen, dev, cfg, dtype)
    s, b, hr, n = slots.shape
    g, d, p = q.shape[1] // hr, q.shape[2], kp.shape[3]
    run = lambda: ops.paged_attention_partial(q, kp, vp, slots, valid)
    plain = lambda: ref.paged_attention_partial_pages_ref(q, kp, vp, slots, valid)
    got = run()
    want = ref.paged_attention_partial_pages_ref(*widened(q, kp, vp), slots, valid)
    torch.cuda.synchronize()
    e = max(err(a, w) for a, w in zip(got, want))
    ex = partial_excess(got, want)
    del want
    n_valid = int(valid.sum().item())
    outs = nbytes(*got)
    b_ms, b_by = bound(nbytes(q, slots, valid) + outs + 2 * n_valid * d * kp.element_size(),
                       4 * d * g * n_valid, dtype)
    tag = str(dtype).split(".")[-1]
    part = dict(
        case=f"S={s} B={b} Hq={hr * g} Hr={hr} N={n} P={p} T={n * p} D={d} "
             f"ctx={list(STRIPE_CTX)} valid={n_valid}",
        dtype=tag, max_abs_err=e, excess=ex,
        tol="1e-4*max(l,1) (f32 outputs; m: 1e-4*max(|m|,1))",
        ms=timer.ms(run, 20), plain_ms=timer.ms(plain, 5), library_ms=None,
        bound_ms=b_ms, bound_by=b_by)
    m, l, o = got
    run_c = lambda: ops.combine_partials(m, l, o)
    plain_c = lambda: ref.combine_partials_ref(m, l, o)
    out, want_c = run_c(), plain_c()
    torch.cuda.synchronize()
    rows = b * hr * g
    b_ms, b_by = bound(nbytes(m, l, o, out), s * rows * (2 * d + 4), torch.float32)
    comb = dict(
        case=f"N={s} B={b} Hq={hr * g} D={d} (f32 partials of the {tag} path)",
        dtype=tag, max_abs_err=err(out, want_c), excess=excess(out, want_c, torch.float32),
        tol=tol_text(torch.float32), ms=timer.ms(run_c, 50), plain_ms=timer.ms(plain_c, 50),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    return [part], [comb]


def engine_workload(cfg):
    """(requests, capacity) of the engine phase, from seeds. The longest
    prompt (8192) and generation (32) are pinned, so the capacity is
    8192 + 32 + one page and the cache holds 258 pages at llama3-8b's page
    of 32. scripts/torch_profile_serve.py profiles the same workload."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(ENGINE_PROMPTS[0], ENGINE_PROMPTS[1] + 1, N_REQUESTS)
    gens = rng.integers(ENGINE_GENS[0], ENGINE_GENS[1] + 1, N_REQUESTS)
    lens[0], gens[-1] = ENGINE_PROMPTS[1], ENGINE_GENS[1]
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new=int(m)) for i, (n, m) in enumerate(zip(lens, gens))]
    return reqs, int(lens.max() + gens.max() + cfg.h2eal.page_size)


def head_split(cfg):
    hkv = cfg.num_kv_heads
    nr = hkv - round(hkv * cfg.h2eal.static_sparsity)
    return nr, hkv - nr, cfg.num_heads // hkv, cfg.resolved_head_dim


def check_chunk(ops, ref, timer, dev, cfg, dtype, gen):
    """Streaming heads in chunked prefill: the pre-append ring of each slot
    (filled by the port's own chunk append) followed by the chunk's keys,
    with the sink+local mask of each query, as chunk_prefill_attention
    builds them."""
    from repro_torch.core import cache as cachelib
    from repro_torch.core import paging
    from repro_torch.core.hybrid_attention import _local_cap

    h2 = cfg.h2eal
    _, hs, g, d = head_split(cfg)
    b, cq = ENGINE_BATCH, ENGINE_CHUNK
    start = torch.tensor(CHUNK_STARTS, dtype=torch.int32, device=dev)
    ring = cachelib.make_stream_cache(b, hs, h2.sink, _local_cap(h2), d, dtype=dtype,
                                      device=dev)
    past = torch.randn(b, max(CHUNK_STARTS), hs, d, generator=gen, device=dev).to(dtype)
    cachelib.stream_cache_append_chunk(ring, past, past, torch.zeros_like(start), start,
                                       sink=h2.sink)
    del past
    kn = torch.randn(b, cq, hs, d, generator=gen, device=dev).to(dtype)
    vn = torch.randn(b, cq, hs, d, generator=gen, device=dev).to(dtype)
    k = torch.cat([ring.k, kn.transpose(1, 2)], dim=2).contiguous()
    v = torch.cat([ring.v, vn.transpose(1, 2)], dim=2).contiguous()
    pos_q = paging.chunk_positions(start, cq)
    kpos = torch.cat([ring.pos, pos_q[:, None, :].expand(b, hs, cq)], dim=2)
    valid = paging.chunk_stream_validity(kpos, pos_q, sink=h2.sink,
                                         local=h2.local).contiguous()
    valid[1, 0, 7] = False  # one all-invalid row: its output must be 0
    q = torch.randn(b, cq, hs * g, d, generator=gen, device=dev).to(dtype)
    run = lambda: ops.chunk_attention(q, k, v, valid)
    plain = lambda: ref.chunk_attention_ref(q, k, v, valid)
    out, want = run(), ref.chunk_attention_ref(*widened(q, k, v), valid)
    torch.cuda.synchronize()
    if out[1, 7, :g].abs().max().item() != 0.0:
        fail("chunk_attention: an all-invalid row is not 0")
    e, ex = err(out, want), excess(out, want, dtype)
    del want
    lib_mask = valid.repeat_interleave(g, dim=1)
    lib_mask[1, :g, 7] = True  # SDPA gives NaN for an all-masked row
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=lib_mask, enable_gqa=True)
    flops = 4 * d * g * int(valid.sum().item())
    b_ms, b_by = bound(nbytes(q, k, v, valid, out), flops, dtype)
    return [dict(
        case=f"streaming B={b} Cq={cq} Hq={hs * g} Hkv={hs} T={k.shape[2]} D={d} "
             f"starts={list(CHUNK_STARTS)}",
        dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex, tol=tol_text(dtype),
        ms=timer.ms(run, 10), plain_ms=timer.ms(plain, 3), library_ms=timer.ms(lib, 10),
        bound_ms=b_ms, bound_by=b_by)]


def check_chunk_paged(ops, ref, timer, dev, cfg, dtype, gen, capacity):
    """Retrieval heads in chunked prefill: the pre-append paged cache of
    each slot written up to its start, then the chunk, at the engine
    phase's shapes (258 pages of 32). Slot 0 starts at 0."""
    from repro_torch.core import paging

    h2 = cfg.h2eal
    nr, _, g, d = head_split(cfg)
    b, cq, p = ENGINE_BATCH, ENGINE_CHUNK, h2.page_size
    c = -(-capacity // p)
    start = torch.tensor(CHUNK_STARTS, dtype=torch.int32, device=dev)
    q = torch.randn(b, cq, nr * g, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(b, nr, c, p, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(b, nr, c, p, d, generator=gen, device=dev).to(dtype)
    first = torch.arange(c, device=dev) * p
    ps = torch.where(first[None] < start[:, None], first[None], -1).to(torch.int32)
    ps = ps[:, None, :].expand(b, nr, c).contiguous()
    kn = torch.randn(b, cq, nr, d, generator=gen, device=dev).to(dtype)
    vn = torch.randn(b, cq, nr, d, generator=gen, device=dev).to(dtype)
    run = lambda: ops.chunk_attention_paged(q, kp, vp, ps, start, kn, vn)
    plain = lambda: ref.chunk_attention_paged_ref(q, kp, vp, ps, start, kn, vn)
    out = run()
    want = ref.chunk_attention_paged_ref(*widened(q, kp, vp), ps, start,
                                         *widened(kn, vn))
    torch.cuda.synchronize()
    e, ex = err(out, want), excess(out, want, dtype)
    del want
    torch.cuda.empty_cache()
    # the library call: one SDPA over the materialised [pages | chunk] buffer
    kb = torch.cat([kp.reshape(b, nr, c * p, d), kn.transpose(1, 2)], dim=2)
    vb = torch.cat([vp.reshape(b, nr, c * p, d), vn.transpose(1, 2)], dim=2)
    key_pos, key_ok = paging.paged_key_positions(ps, p)
    cache_ok = key_ok & (key_pos < start[:, None, None])
    causal = torch.ones(cq, cq, dtype=torch.bool, device=dev).tril()
    mask = torch.cat([cache_ok[:, :, None, :].expand(b, nr, cq, c * p),
                      causal.expand(b, nr, cq, cq)], dim=-1)
    lib_mask = mask.repeat_interleave(g, dim=1)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kb, vb, attn_mask=lib_mask, enable_gqa=True)
    pairs = sum(cq * s + cq * (cq + 1) // 2 for s in CHUNK_STARTS) * nr * g
    elt = kp.element_size()
    cache_bytes = 2 * sum(CHUNK_STARTS) * nr * d * elt  # the K/V of valid keys
    b_ms, b_by = bound(nbytes(q, ps, start, kn, vn, out) + cache_bytes, 4 * d * pairs,
                       dtype)
    case = dict(
        case=f"retrieval B={b} Cq={cq} Hq={nr * g} Hr={nr} C={c} P={p} D={d} "
             f"starts={list(CHUNK_STARTS)}",
        dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex, tol=tol_text(dtype),
        ms=timer.ms(run, 10), plain_ms=timer.ms(plain, 2), library_ms=timer.ms(lib, 5),
        bound_ms=b_ms, bound_by=b_by)
    del kb, vb, mask, lib_mask
    torch.cuda.empty_cache()
    return [case]


# ---------------------------------------------------------------------------
# Phases 3 to 5: the serving path
# ---------------------------------------------------------------------------


def check_reduced_against_cpu(dev):
    """Reduced llama3-8b: card (kernels) against CPU (plain versions)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    cfg = reduced(get_arch(ARCH))
    gen = torch.Generator().manual_seed(1)
    params = M.init_params(cfg, generator=gen, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 45), generator=gen)
    params_dev = _to(params, dev)
    kw = dict(gen=12, capacity=45 + 12 + cfg.h2eal.page_size)
    toks_cpu, st_cpu = generate(cfg, params, prompts, device="cpu", **kw)
    toks_dev, st_dev = generate(cfg, params_dev, prompts, device=dev, **kw)
    e = err(st_dev["last_logits"].cpu(), st_cpu["last_logits"])
    log(f"reduced {cfg.name}: card vs CPU tokens equal="
        f"{torch.equal(toks_dev.cpu(), toks_cpu)} last-logit max err={e:.3e}")
    if not torch.equal(toks_dev.cpu(), toks_cpu) or e > 1e-3:
        fail("reduced generate on the card disagrees with the CPU run "
             "(tokens must match, logits within 1e-3)")


def check_reduced_engine_against_cpu(dev):
    """Reduced llama3-8b, chunked Engine with slot churn (5 requests on 2
    slots, chunks of 7): card (kernels) against CPU (plain versions)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    cfg = reduced(get_arch(ARCH))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new=m)
            for i, (n, m) in enumerate([(37, 9), (20, 4), (51, 6), (9, 7), (30, 5)])]
    kw = dict(max_batch=2, capacity=96, prompt_buckets=[64], prefill_chunk=7)
    cpu = Engine(cfg, params, device="cpu", **kw).run(reqs)
    card = Engine(cfg, _to(params, dev), device=dev, **kw).run(reqs)
    same = all(card[u].tokens == cpu[u].tokens for u in cpu) and sorted(card) == sorted(cpu)
    log(f"reduced {cfg.name} chunked engine: card vs CPU tokens equal={same} "
        f"({sum(len(c.tokens) for c in cpu.values())} tokens, 5 requests)")
    if not same:
        fail("the reduced chunked engine on the card disagrees with the CPU run")


def check_reduced_coplace_engine_against_cpu(dev):
    """Reduced llama3-8b, the coplace_shmap chunked Engine over 4 stripes with
    balanced admission and slot churn: card (kernels) against CPU (plain
    versions), token for token, with the same admission reorders."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    cfg = reduced(get_arch(ARCH))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(6), device="cpu")
    rng = np.random.default_rng(6)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new=m)
            for i, (n, m) in enumerate([(37, 9), (20, 4), (51, 6), (9, 7), (30, 5),
                                        (44, 3)])]
    kw = dict(max_batch=2, capacity=96, prompt_buckets=[64], prefill_chunk=7,
              layout="coplace_shmap", shards=4, admission="balanced")
    cpu_eng = Engine(cfg, params, device="cpu", **kw)
    cpu = cpu_eng.run(reqs)
    ops.reset_launches()
    card_eng = Engine(cfg, _to(params, dev), device=dev, **kw)
    card = card_eng.run(reqs)
    same = all(card[u].tokens == cpu[u].tokens for u in cpu) and sorted(card) == sorted(cpu)
    log(f"reduced {cfg.name} coplace_shmap S=4 balanced chunked engine: card vs CPU "
        f"tokens equal={same} ({sum(len(c.tokens) for c in cpu.values())} tokens, "
        f"{len(reqs)} requests), admission reorders card {card_eng.stats.admission_reorders}"
        f" / CPU {cpu_eng.stats.admission_reorders}, partial launches "
        f"{ops.LAUNCHES['paged_attention_partial']}")
    if not same or card_eng.stats.admission_reorders != cpu_eng.stats.admission_reorders:
        fail("the reduced coplace_shmap engine on the card disagrees with the CPU run")
    if ops.LAUNCHES["paged_attention_partial"] == 0 or ops.LAUNCHES["combine_partials"] == 0:
        fail("the reduced coplace_shmap engine did not launch the co-placed kernels")


def full_params(dev, cfg):
    from repro_torch.models import model as M

    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, generator=gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {n_params / 1e9:.2f}B params, init {time.perf_counter() - t0:.1f}s")
    return params


def serve_full(dev, cfg, params):
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate

    capacity = serve_capacity(cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                            device=dev)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    toks, stats = generate(cfg, params, prompts, gen=GEN, capacity=capacity, device=dev)
    launches = dict(ops.LAUNCHES)
    n_sel = -(-GEN // cfg.h2eal.share_window)
    expect = {"flash_attention": 2 * cfg.num_layers,
              "page_score": cfg.num_layers * n_sel,
              "paged_attention": 2 * cfg.num_layers * GEN,
              "chunk_attention": 0, "chunk_attention_paged": 0,
              "paged_attention_partial": 0, "combine_partials": 0}
    log(f"generate: sparse run launches {launches} (expected {expect})")
    if launches != expect:
        fail("the serving path did not launch the kernels as expected")
    logits = stats["last_logits"]
    if tuple(toks.shape) != (BATCH, GEN) or not bool(torch.isfinite(logits).all()):
        fail("sparse generate produced a wrong shape or non-finite logits")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail("sparse generate produced out-of-range tokens")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"generate B={BATCH} S={PROMPT} capacity {capacity}: sparse prefill "
        f"{stats['prefill_s']:.3f}s, decode {stats['decode_s']:.3f}s "
        f"({stats['tokens_per_s']:.1f} tok/s), peak memory {peak:.1f} GiB")

    toks_full, stats_full = generate(cfg, params, prompts, gen=GEN, capacity=capacity,
                                     h2eal=False, device=dev)
    if not bool(torch.isfinite(stats_full["last_logits"]).all()):
        fail("full-attention generate produced non-finite logits")
    agree = (toks == toks_full).float().mean().item()
    log(f"full attention: prefill {stats_full['prefill_s']:.3f}s, decode "
        f"{stats_full['decode_s']:.3f}s ({stats_full['tokens_per_s']:.1f} tok/s); "
        f"token agreement sparse vs full {agree:.3f}")
    log(f"sample tokens: {toks[0, :16].tolist()}")
    return launches


def check_coplace_layer(dev, cfg, params):
    """One decode step of one llama3-8b layer at full width from the 8192-token
    lockstep prefill (every slot has 247 selectable pages, more than top-k):
    the retrieval heads under coplace_shmap over SHARDS stripes (each stripe
    returns its 33 best pages, so the global top-128 is the default layout's
    selection) against the default layout, on the caches the two layouts'
    prefills built; then the whole model's decode-step logits of the two."""
    import copy

    from repro_torch.core import hybrid_attention as hattn
    from repro_torch.core import layouts, paging
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import apply_rope, rms_norm

    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                            device=dev)
    lay = {"default": layouts.get_layout("default"),
           "coplace_shmap": layouts.get_layout("coplace_shmap", SHARDS)}
    capacity = lay["coplace_shmap"].plan(cfg).round_capacity(serve_capacity(cfg))
    states, logits = {}, {}
    with torch.inference_mode():
        for name, layout in lay.items():
            lg, states[name] = M.prefill(cfg, params, prompts, capacity=capacity,
                                         layout=layout)
            logits[name] = lg
        tok = logits["default"].argmax(dim=-1).to(torch.int32)
        spec = T.attn_spec(cfg)
        p0 = params["layers"][0]
        h = rms_norm(M.embed_input(cfg, params, tok), p0["ln1"], cfg.norm_eps)
        q, k, v = T._qkv(cfg, p0, h)
        cos, sin = M._rope(cfg, torch.arange(PROMPT, PROMPT + 1, device=dev))
        q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k = apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
        outs, sels = {}, {}
        for name, layout in lay.items():
            cache = copy.deepcopy(states[name]["layers"][0])
            outs[name], cache = layout.decode(spec, cache, q, k, v, PROMPT,
                                              do_select=True)
            sels[name] = cache["paged"].sel_idx
        c = capacity // cfg.h2eal.page_size
        logical = paging.logical_pages(c, SHARDS, dev)[sels["coplace_shmap"].long()]
        same_sel = torch.equal(logical.sort(dim=-1).values,
                               sels["default"].long().sort(dim=-1).values)
        nq = spec.n_retrieval * spec.group
        a, b = outs["coplace_shmap"][:, :nq].float(), outs["default"][:, :nq].float()
        # each side rounds its f32 result to bf16 once: twice the kernel
        # tolerance's half step
        rtol, atol = TOL[torch.bfloat16]
        ex = ((a - b).abs() - 2 * (rtol * b.abs() + atol)).max().item()
        step = {}
        for name, layout in lay.items():
            step[name], _ = M.decode_step(cfg, params, states[name], tok,
                                          do_select=True, layout=layout)
    d_logits = err(step["coplace_shmap"], step["default"])
    log(f"coplace_shmap S={SHARDS} vs default, layer 0 of {cfg.name} at context "
        f"{PROMPT + 1} (capacity {capacity}): same selected pages={same_sel}, "
        f"retrieval-head output max err={err(a, b):.3e} excess={ex:.3e} "
        f"(tol 2*(2^-8*|default| + 1e-5)); whole-model decode-step logits max "
        f"diff {d_logits:.3e}, prefill logits max diff "
        f"{err(logits['coplace_shmap'], logits['default']):.3e}")
    if not same_sel or not ex <= 0.0:
        fail("coplace_shmap's retrieval heads disagree with the default layout's")
    if not all(bool(torch.isfinite(x).all()) for x in step.values()):
        fail("a decode step of the two layouts produced non-finite logits")
    del states
    torch.cuda.empty_cache()


def page_load_imbalance(eng, page_size) -> float:
    """Per-stripe page-load imbalance (max / mean) of the engine's occupied
    slots' resident pages, under SHARDS-way round-robin striping."""
    from repro_torch.sched import balance

    b = eng.batch
    ctx = [int(b.lengths[i]) for i in range(b.max_batch)
           if b.active[i] or b.ready[i] or b.prefilling[i]]
    return balance.load_imbalance(balance.device_page_loads(
        ctx, n_shards=SHARDS, page_size=page_size))


def serve_engine(dev, cfg, params):
    """The continuous-batching Engine at full width: chunked prefill, then
    prefill-then-pack on the same requests, then the chunked coplace_shmap
    engine over SHARDS stripes with balanced admission. Returns the launch
    counts of each run."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine

    reqs, capacity = engine_workload(cfg)
    lens = [len(r.prompt) for r in reqs]
    n_l = cfg.num_layers
    log(f"engine: {len(reqs)} requests on {ENGINE_BATCH} slots, prompts {lens}, "
        f"generations {[r.max_new for r in reqs]}, capacity {capacity}")
    out, launches = {}, {}
    coplace = dict(layout="coplace_shmap", shards=SHARDS, admission="balanced")
    for mode, chunk, kw in (("chunked", ENGINE_CHUNK, {}), ("packed", None, {}),
                            ("coplace", ENGINE_CHUNK, coplace)):
        eng = Engine(cfg, params, max_batch=ENGINE_BATCH, capacity=capacity,
                     prompt_buckets=sorted(set(lens)), prefill_chunk=chunk, device=dev,
                     **kw)
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        imb = []
        t0 = time.perf_counter()
        while eng.busy():
            if chunk:  # admission and step: neither may read from the card
                torch.cuda.set_sync_debug_mode("error")
            try:
                eng.poll()
            except RuntimeError as exc:  # a sync with the card raises here
                fail(f"engine ({mode}) step failed: {exc}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            imb.append(page_load_imbalance(eng, cfg.h2eal.page_size))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[mode] = got = dict(ops.LAUNCHES)
        eng.finalize()
        s = eng.stats
        split = mode == "coplace"  # retrieval heads: partial + combine
        expect = {"flash_attention": 0 if chunk else 2 * n_l * len(reqs),
                  "page_score": s.select_steps * n_l,
                  "paged_attention": (1 if split else 2) * s.decode_steps * n_l,
                  "chunk_attention": s.prefill_chunks * n_l,
                  "chunk_attention_paged": s.prefill_chunks * n_l,
                  "paged_attention_partial": s.decode_steps * n_l if split else 0,
                  "combine_partials": s.decode_steps * n_l if split else 0}
        log(f"engine ({mode}) launches {got} (expected {expect})")
        if got != expect:
            fail(f"the engine ({mode}) did not launch the kernels as expected")
        comps = eng.completions
        for r in reqs:
            t = comps[r.uid].tokens if r.uid in comps else []
            if len(t) != r.max_new or not all(0 <= x < cfg.vocab_size for x in t):
                fail(f"engine ({mode}): request {r.uid} gave {len(t)} tokens, "
                     f"expected {r.max_new} in range")
        peak = torch.cuda.max_memory_allocated() / 2**30
        first = {u: comps[u].first_token_step for u in sorted(comps)}
        log(f"engine ({mode}): {s.tokens_out} tokens in {wall:.3f}s = "
            f"{s.tokens_out / wall:.2f} tok/s; engine steps {s.engine_steps}, "
            f"prefill-chunk steps {s.prefill_chunks}, decode steps {s.decode_steps} "
            f"(select {s.select_steps} / reuse {s.reuse_steps}), mean occupancy "
            f"{s.occupancy:.3f}, first-token step per request {first}, peak memory "
            f"{peak:.1f} GiB; admission reorders {s.admission_reorders}, per-stripe "
            f"page-load imbalance over {SHARDS} stripes mean {np.mean(imb):.4f} max "
            f"{np.max(imb):.4f} (cache capacity {eng.cache_capacity})")
        out[mode] = {u: c.tokens for u, c in comps.items()}
        del eng
        torch.cuda.empty_cache()
    pairs = [(a, b) for u in out["chunked"] for a, b in zip(out["chunked"][u],
                                                            out["packed"][u])]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    log(f"engine: token agreement chunked vs packed {agree:.3f} (random weights: "
        f"near-flat logits, so a reassociated sum can flip a token)")
    pairs = [(a, b) for u in out["chunked"] for a, b in zip(out["chunked"][u],
                                                            out["coplace"][u])]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    log(f"engine: token agreement chunked default vs chunked coplace_shmap {agree:.3f}")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: nothing to run", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s -> {lib.name}")

    cfg = get_arch(ARCH)
    capacity = serve_capacity(cfg)
    engine_capacity = engine_workload(cfg)[1]
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"flash_attention": [], "page_score": [], "paged_attention": [],
               "chunk_attention": [], "chunk_attention_paged": [],
               "paged_attention_partial": [], "combine_partials": []}
    for dtype in (torch.bfloat16, torch.float32):
        results["flash_attention"] += check_flash(ops, ref, timer, dev, cfg, dtype, gen)
        results["page_score"] += check_page_score(ops, ref, timer, dev, cfg, dtype, gen,
                                                  capacity)
        results["paged_attention"] += check_paged(ops, ref, timer, dev, cfg, dtype, gen,
                                                  capacity)
        results["chunk_attention"] += check_chunk(ops, ref, timer, dev, cfg, dtype, gen)
        results["chunk_attention_paged"] += check_chunk_paged(
            ops, ref, timer, dev, cfg, dtype, gen, engine_capacity)
        part, comb = check_partial(ops, ref, timer, dev, cfg, dtype, gen)
        results["paged_attention_partial"] += part
        results["combine_partials"] += comb
        torch.cuda.empty_cache()
    bad = []
    for name, cases in results.items():
        for c in cases:
            lib_ms = "n/a" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
            log(f"{name} [{c['case']} {c['dtype']}] kernel_ms={c['ms']:.4f} "
                f"plain_ms={c['plain_ms']:.4f} library_ms={lib_ms} "
                f"bound_ms={c['bound_ms']:.4f} ({c['bound_by']}) "
                f"max_err={c['max_abs_err']:.3e} excess={c['excess']:.3e} "
                f"(tol {c['tol']})")
            if not c["excess"] <= 0.0:
                bad.append(f"{name} {c['case']} {c['dtype']}")
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    del timer
    torch.cuda.empty_cache()

    check_reduced_against_cpu(dev)
    check_reduced_engine_against_cpu(dev)
    check_reduced_coplace_engine_against_cpu(dev)
    params = full_params(dev, cfg)
    by_path = {"generate": serve_full(dev, cfg, params)}
    check_coplace_layer(dev, cfg, params)
    by_path.update({f"engine_{k}": v for k, v in serve_engine(dev, cfg, params).items()})
    # the main paths: sparse lockstep generate, the chunked engine and the
    # chunked coplace_shmap engine; every kernel of a path must have run in it
    main_paths = {"generate": ("flash_attention", "page_score", "paged_attention"),
                  "engine_chunked": ("page_score", "paged_attention", "chunk_attention",
                                     "chunk_attention_paged"),
                  "engine_coplace": ("page_score", "paged_attention", "chunk_attention",
                                     "chunk_attention_paged", "paged_attention_partial",
                                     "combine_partials")}
    for path, names in main_paths.items():
        idle = [n for n in names if by_path[path][n] == 0]
        if idle:
            fail(f"path {path} never launched {idle}")

    src = "src/repro_torch/kernels/csrc/"
    sources = {"flash_attention": src + "flash_attention.cu",
               "page_score": src + "page_score.cu",
               "paged_attention": src + "paged_attention.cu",
               "chunk_attention": src + "chunk_attention.cu",
               "chunk_attention_paged": src + "chunk_attention.cu",
               "paged_attention_partial": src + "paged_attention_partial.cu",
               "combine_partials": src + "combine_partials.cu"}
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:97",
                "page_score": "src/repro/kernels/page_score.py:46",
                "paged_attention": "src/repro/kernels/paged_attention.py:89",
                "chunk_attention": "src/repro/kernels/chunk_attention.py:107",
                "chunk_attention_paged": "src/repro/kernels/chunk_attention.py:213",
                "paged_attention_partial": "src/repro/kernels/paged_attention.py:89",
                "combine_partials": "src/repro/kernels/paged_attention.py:211"}
    kernels = []
    for name, cases in results.items():
        main_cases = [c for c in cases if c["dtype"] == "bfloat16"
                      and not c["case"].startswith("full-attention")]
        total = lambda key: sum(c[key] for c in main_cases)
        lib_vals = [c["library_ms"] for c in main_cases]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name],
            "launches": sum(by_path[p][name] for p in main_paths),
            "launches_by_path": {p: by_path[p][name] for p in by_path},
            "max_abs_err": max(c["max_abs_err"] for c in main_cases),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": max(main_cases, key=lambda c: c["bound_ms"])["bound_by"],
            "library_ms": None if None in lib_vals else sum(lib_vals),
            "cases": cases,
        })
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
