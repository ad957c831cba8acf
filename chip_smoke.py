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
     run); then the same requests with prefill-then-pack admission.

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
              "chunk_attention": 0, "chunk_attention_paged": 0}
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


def serve_engine(dev, cfg, params):
    """The continuous-batching Engine at full width: chunked prefill, then
    prefill-then-pack on the same requests. Returns the launch counts of
    each run."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine

    reqs, capacity = engine_workload(cfg)
    lens = [len(r.prompt) for r in reqs]
    n_l = cfg.num_layers
    log(f"engine: {len(reqs)} requests on {ENGINE_BATCH} slots, prompts {lens}, "
        f"generations {[r.max_new for r in reqs]}, capacity {capacity}")
    out, launches = {}, {}
    for mode, chunk in (("chunked", ENGINE_CHUNK), ("packed", None)):
        eng = Engine(cfg, params, max_batch=ENGINE_BATCH, capacity=capacity,
                     prompt_buckets=sorted(set(lens)), prefill_chunk=chunk, device=dev)
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
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
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[mode] = got = dict(ops.LAUNCHES)
        eng.finalize()
        s = eng.stats
        expect = {"flash_attention": 0 if chunk else 2 * n_l * len(reqs),
                  "page_score": s.select_steps * n_l,
                  "paged_attention": 2 * s.decode_steps * n_l,
                  "chunk_attention": s.prefill_chunks * n_l,
                  "chunk_attention_paged": s.prefill_chunks * n_l}
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
            f"{peak:.1f} GiB")
        out[mode] = {u: c.tokens for u, c in comps.items()}
        del eng
        torch.cuda.empty_cache()
    pairs = [(a, b) for u in out["chunked"] for a, b in zip(out["chunked"][u],
                                                            out["packed"][u])]
    agree = sum(a == b for a, b in pairs) / len(pairs)
    log(f"engine: token agreement chunked vs packed {agree:.3f} (random weights: "
        f"near-flat logits, so a reassociated sum can flip a token)")
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
               "chunk_attention": [], "chunk_attention_paged": []}
    for dtype in (torch.bfloat16, torch.float32):
        results["flash_attention"] += check_flash(ops, ref, timer, dev, cfg, dtype, gen)
        results["page_score"] += check_page_score(ops, ref, timer, dev, cfg, dtype, gen,
                                                  capacity)
        results["paged_attention"] += check_paged(ops, ref, timer, dev, cfg, dtype, gen,
                                                  capacity)
        results["chunk_attention"] += check_chunk(ops, ref, timer, dev, cfg, dtype, gen)
        results["chunk_attention_paged"] += check_chunk_paged(
            ops, ref, timer, dev, cfg, dtype, gen, engine_capacity)
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
    params = full_params(dev, cfg)
    by_path = {"generate": serve_full(dev, cfg, params)}
    by_path.update({f"engine_{k}": v for k, v in serve_engine(dev, cfg, params).items()})
    # the main paths: sparse lockstep generate and the chunked engine; every
    # kernel of a path must have run in it
    main_paths = {"generate": ("flash_attention", "page_score", "paged_attention"),
                  "engine_chunked": ("page_score", "paged_attention", "chunk_attention",
                                     "chunk_attention_paged")}
    for path, names in main_paths.items():
        idle = [n for n in names if by_path[path][n] == 0]
        if idle:
            fail(f"path {path} never launched {idle}")

    src = "src/repro_torch/kernels/csrc/"
    sources = {"flash_attention": src + "flash_attention.cu",
               "page_score": src + "page_score.cu",
               "paged_attention": src + "paged_attention.cu",
               "chunk_attention": src + "chunk_attention.cu",
               "chunk_attention_paged": src + "chunk_attention.cu"}
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:97",
                "page_score": "src/repro/kernels/page_score.py:46",
                "paged_attention": "src/repro/kernels/paged_attention.py:89",
                "chunk_attention": "src/repro/kernels/chunk_attention.py:107",
                "chunk_attention_paged": "src/repro/kernels/chunk_attention.py:213"}
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
