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
     same function, that call (device times: see ``Timer``); the retrieval
     heads' decode, which reads its pages in place, also beside the
     unfused path it replaced (the gather, then the contiguous kernel),
     and the co-placed decode beside ``paged_attention_pages`` on the same
     list;
  3. holds a reduced llama3-8b ``generate`` (f32; and bf16 at head_dim
     128, so the tensor-core flash kernel runs at the serving head size) and
     a reduced chunked ``Engine`` run (with slot churn; f32, and bf16 at
     head_dim 128 for the tensor-core chunk kernels) on the card against
     the same runs on the CPU (plain versions, same weights); and the bf16
     page scores and selection at the reduced top-k, card against CPU;
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
     run); then the same requests with prefill-then-pack admission; these
     engines run their steps eagerly (``eager=True``);
  6. the ``coplace_shmap`` layout over 8 page stripes (split-KV decode):
     a reduced chunked engine with churn and balanced admission, card
     against CPU; one decode step of one llama3-8b layer from the 8192-token
     lockstep prefill, its retrieval-head outputs held against the default
     layout's (and the full logits' difference printed); then the full-width
     chunked engine of phase 5 with balanced admission, launch counts
     checked exactly and every step under sync debug mode "error";
  7. compiled dispatch: a reduced llama3-8b chunked engine with the share
     window widened to 4 and fused decode windows (``decode_window=4``),
     f32 and bf16, its steps replayed as the CUDA graphs captured at
     construction, against the same engine run eagerly on the card (equal
     tokens and launches) and against the CPU (f32 token for token, bf16 up
     to a near-tie); then the full-width chunked default and coplace_shmap
     engines of phases 5 and 6 captured with ``decode_window=4``: launch
     counts exact (a replay adds its graph's launches), every poll under
     sync debug mode "error", captures made once at construction, tokens
     equal to the eager run of the same layout, and tokens/s, dispatches,
     decode steps a dispatch and graph replays logged;
  8. sampling and speculative decode: in phase 2 also the sampler on the
     card against the CPU (threefry bits equal, Gumbel within 2 ulp, tokens
     equal up to near-ties; its device time as a graph replay),
     chunk_attention at the verify step's shapes (k = 1, 4, 8 chunk queries
     over the retrieval heads' gathered pages and the streaming ring) and
     page_score's select mode at the verify call; then a reduced llama3-8b
     chunked speculative engine (k = 4), captured, against the CPU on both
     layouts, greedy and sampled; then the full-width chunked captured
     engine with speculative decode (k = 4) and three drafts (a replay of
     the non-speculative trace, n-gram, the streaming self-draft) and a
     sampled run against the non-speculative engine: tokens equal up to
     near-ties, launches exact, captures made once, and tokens/s, mean
     accepted length, dispatches and the device time of the verify step,
     the draft's steps and a decode step logged;
  9. tiered residency and live slot rebalancing on the full-width chunked
     captured engine of phase 7 (decode_window=4): with ``hot_pages=144``
     (258 pages a slot, about 138 of them pinned), one request's pages all
     forced cold at a selection boundary, the tokens must equal phase 7's
     captured all-resident engine's, demand fills equal the misses (> 0),
     prefetches and spills happen, the bytes the far-store copies moved
     equal the byte model's (``runtime/perfmodel.py``) of the counters, and
     the captures do not grow; the copies' GB/s over PCIe, tok/s beside the
     all-resident engine's and the hbsim model's projection of the traffic
     are logged. Then ``rebalance="retire"``: tokens equal to phase 7's
     (rebalance off), at least one migration, the imbalance lowered,
     ``migrate`` captured once, every poll under sync debug mode "error",
     and the hbsim model's price of the migrations logged;
 10. gemma3-1b's local:global stack (5 sliding-window layers of 512 for
     each global layer, head_dim 256, one kv head; phase 2 also holds every
     kernel at its head_dim-256 shapes, in bf16 and f32, beside SDPA) and
     the eviction pool: a reduced 8-layer gemma3-1b card against CPU (f32
     at head_dim 32, bf16 at head_dim 256; generate, and the chunked engine
     with churn captured with fused windows); gemma3-1b at full width and
     depth through lockstep ``generate`` (2 prompts of 16384 tokens) and
     through the engines of phases 5 to 7 (launch counts exact, captures
     made once, each captured engine's tokens equal to its eager run's);
     then ``decode_attention_pool`` at llama3-8b's and gemma3-1b's
     retrieval shapes, a full pool evicting as it decodes, its kernel path
     on the card against the plain path;
 11. the MoE family (GQA group 16; phase 2 also holds every kernel at
     qwen3-moe-235b's shapes, in bf16 and f32, beside SDPA): a reduced
     qwen3-moe with a group of 16 card against CPU (f32 token for token,
     bf16 within the band; dropless and at capacity factor 0.25, where
     experts overflow); qwen3-moe-235b-a22b at full width (128 experts,
     top-8, capacity factor 1.25) cut to 8 of its 94 layers through
     lockstep ``generate`` (2 prompts of 8192 tokens) and the chunked engine
     of phase 5 with fused windows, eager and captured (launch counts
     exact, captures made once, captured tokens equal to eager); then
     kimi-k2-1t-a32b at full width (384 experts and its shared expert) cut
     to 1 of its 61 layers through lockstep ``generate``;
 12. the recurrent mixers (phase 2 also holds every kernel at zamba2-2.7b's
     shapes, head_dim 80 and a GQA group of 1, in bf16 and f32, beside
     SDPA): the reduced hybrid (mamba2, mamba2, attention) card against CPU
     (f32 generate at head_dim 32 token for token, bf16 at head_dim 80
     within the band, the chunked engine captured with fused windows, the
     coplace_shmap engine over 2 stripes) and the reduced xlstm-125m (f32
     generate token for token); zamba2-2.7b at full width, 18 of its 54
     layers (15 mamba2, 3 attention), through lockstep ``generate`` and the
     chunked engine with fused windows, eager and captured (launch counts
     exact over its attention layers, captured tokens equal to eager);
     xlstm-125m at full width and depth through ``generate`` and a chunked
     engine eager and captured (no kernel launched; a captured chunk step's
     graph node count logged);
 13. training and head identification: (a) the attention backward
     (``csrc/flash_attention_bwd.cu``, bf16 ``csrc/flash_attention_bwd_sm90.cu``)
     against its plain version at every head_dim, GQA groups 1, 3, 4 and
     16, causal, window 256 + sink 4 and window 512, f32 and bf16, a ragged
     S (and, in f32, against autograd through the plain forward), with the
     forward's row log-sum-exp against its plain version and the forward's
     output bit for bit with and without it; then timed beside its bound,
     its plain version and SDPA's backward at smollm-360m's training shape
     and llama3-8b's head-identification shape (f32, the dtype both paths
     run, and bf16), each timed case also held to its plain version, and
     the f32 forward with its log-sum-exp timed at the same shapes; (b)
     reduced smollm-360m's ``make_train_step`` and the head-identification
     loop of ``examples/torch_head_identification.py`` card against CPU
     (α, each step's α gradient, and the α gradient at the identified
     state computed on both from the same inputs), and the identified plan
     served through ``prefill`` and ``decode_step``; (c) ``python -m repro_torch.launch.train`` (its
     ``main``) at smollm-360m's full width and depth, f32, B = 8, S = 2048,
     6 steps, then crashed after 3 and resumed: the final losses equal
     within 1e-6; (d) one head-identification step at llama3-8b's full width
     (bf16 weights, α trainable, S = 8192): a finite, non-zero α gradient.
     The serving paths of phases 4 to 12 and 14 must launch no backward
     kernel;
 14. the frontend-stub families, fed seeded embeddings (phase 2 also holds
     every serving kernel at internvl2-1b's shapes, GQA group 7 on the
     group-8 instantiations, and musicgen-large's, MHA, head_dim 64, in bf16
     and f32 beside SDPA; phase 13a the backward at internvl2-1b's training
     shape): (b) reduced internvl2-1b with 14 query heads over 2 and reduced
     musicgen-large through ``prefill`` and 8 ``decode_step``s, card against
     CPU (f32 at head_dim 32, bf16 at 64), and one ``make_train_step`` step
     of the reduced group-7 model, card against CPU; (c) both models at
     full width and depth, bf16: ``prefill`` on 2 x 8192 embeddings and 32
     decode steps, launch counts exact, every logit finite, then with H²EAL
     off and the logits' difference; (d) internvl2-1b's train step at full
     width and depth, f32, B = 4 x S = 2048, 4 steps, launch counts exact;
     (e) the dry run's (``launch/dryrun.py``) parameter, AdamW, serve-state
     and serving-input bytes equal to what the card holds, the peak memory
     beside its total;
 15. the GSPMD layouts ``head``, ``coplace`` and ``interleave`` on
     ``torch.distributed`` ranks: paged_attention_partial and combine_partials
     timed at the rank blocks' shapes; (a) an NCCL group of one rank,
     llama3-8b at full width cut to GSPMD_A_LAYERS, the default engine and each
     layout's, packed and chunked, captured, on 4 requests of 2048-8192
     tokens (16 new each, one sampled): launch counts exact (one rank
     holds every page, so every layout runs the default's kernels), tokens
     equal to the default engine's up to a near-tie, decode steps/s beside
     the default's; (b) two ranks spawned on cuda:0 over gloo (this script
     with ``--gspmd-rank``), llama3-8b cut to 4 layers, eager: ``head`` and
     ``coplace`` on (1, 2), ``interleave`` on (2, 1) at 3 slots (tokens
     striped within pages), packed and chunked; both ranks' tokens equal
     and equal to the one-rank default engine's up to a near-tie, one decode
     step's attention output within a bf16 step of the default's; and
     ``coplace`` with speculative decode (the n-gram draft) and with tiered
     residency (a request forced cold), ``head`` on (2, 1) with the batch
     on 'data' and retire-triggered rebalancing that moves a slot's row to
     the other rank: tokens and counters equal across ranks and to the
     one-rank default engine's with the same options; (c) in (a)'s NCCL
     group, each layout beside the default with speculative decode (k = 4,
     the n-gram draft chunked, the replay draft packed; one request
     sampled): tokens equal to the layout's non-speculative engine's and
     the default's up to a near-tie, the verify step's device time and the
     mean accepted length beside the default's; with tiered residency
     (phase 9's budget, one request forced cold): tokens equal to the
     all-resident engine's, tier counters equal to the default's, the far
     store's GB/s; ``coplace`` and ``interleave`` with retire-triggered
     rebalancing: tokens equal to rebalance off's, a migration counted;
     and chunk_attention at the verify's shapes on a rank's block timed
     against its plain version and SDPA; (b) also serves the other families
     on both ranks: zamba2-2.7b cut to one period on ``head`` (2, 1),
     rebalanced, its recurrent rows cut over 'data' and a migration moving
     a slot's row to the other rank; gemma3-1b cut to one period on
     ``coplace`` (1, 2), tiered, its global layer's pages cut (partials at
     head_dim 256); llama3-8b at the cut with H²EAL off on ``head`` (1, 2),
     its full caches' kv heads cut; each against the one-rank default
     engine with the same options; (d) in (a)'s NCCL group, the other
     families through the captured chunked engine of the default layout
     and of each GSPMD layout, one request sampled: zamba2-2.7b, xlstm-125m
     and gemma3-1b whole, qwen3-moe cut to 8 layers, llama3-8b with H²EAL
     off; tokens, counters and launch counts equal to the default's.
     ``coplace_shmap`` over ranks (rank r of 'model' holding page stripe
     r): paged_attention_partial and combine_partials timed at a rank's
     stripe block (2 and 4 stripes) beside their plain versions and the
     gather + SDPA of that block; in (a), its captured chunked engine on the
     NCCL rank beside the default's (one rank holds every stripe and runs
     the default's kernels: launches and counters equal, tokens up to a
     near-tie, the layout selecting a masked page as -1); in (b), on (1, 2)
     packed and chunked, speculative and tiered with a request forced
     cold, each held to the one-card engine over 2 stripes and to the
     one-rank default engine, and one decode step on each rank's striped
     block against the one-card body.
 16. the reference's tensor-parallel ``generate(mesh=...)`` and its sharded
     train step (ROADMAP item 9c): (a) in 15a's NCCL group of one rank,
     llama3-8b at 15a's cut, ``generate`` on the mesh for each
     of the five layouts, 2 prompts of 8192 tokens: launch counts and
     tokens equal to ``generate(mesh=None)`` (``coplace_shmap``'s up to a
     near-tie: it selects a masked page as -1); (b) two ranks spawned on
     cuda:0 over gloo (this script with ``--tp-rank``): ``generate`` at
     llama3-8b cut to TP_CUT layers, 2 prompts of 2048, on ``default`` and
     ``interleave`` (2, 1) and ``head`` / ``coplace`` / ``coplace_shmap``
     (1, 2), each rank's parameter bytes printed, tokens equal across
     ranks and to the one-rank run's up to a near-tie; the sharded step,
     f32, smollm-360m at full width and depth, B = 8 x S = 1024, 3 steps on
     (2, 1) and one on (1, 2), and llama3-8b cut to 2 layers (FSDP on by
     the reference's rule) on (2, 1), B = 2 x S = 2048, one step: loss and grad
     norm within TP_TRAIN_RTOL of the one-rank step's, each rank's
     parameter and AdamW bytes printed; the training CLI (reduced) over both ranks,
     crashed and resumed (its final loss equal to the uninterrupted run's),
     and crashed and resumed on one rank (within TP_TRAIN_RTOL); (c) on the
     same two ranks, the MoE, recurrent and local:global families (ROADMAP
     item 9d, TP_C_SERVE / TP_C_TRAIN): ``generate`` of qwen3-moe (all 128
     experts, 2 layers), zamba2 (one period), xlstm-125m and gemma3-1b
     whole on ``default`` and ``head``, (1, 2) and (2, 1), tokens equal
     across ranks and to the one-card run's up to a near-tie, a rank's
     parameter bytes its blocks'; their f32 sharded steps (qwen3-moe one
     layer of 32 experts on (1, 2), the others on (2, 1)) within
     TP_TRAIN_RTOL of the one-card step's.

Prints a ``{"kernels": [...]}`` line and, last, the device line. Exits
nonzero without a result when no CUDA device is available or the port's
sources are missing.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the trainer (phase 13c) runs under PyTorch's deterministic algorithms,
# whose cuBLAS workspace setting must be in place before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

# tolerances of kernel against plain version, elementwise:
# |kernel - plain| <= rtol * |plain| + atol. Each kernel computes in f32 and
# rounds only its output to the storage dtype, so it is held against the
# plain version run on the same inputs widened to f32. In f32 the two differ
# by summation order alone; in bf16 also by the output's rounding, at most
# half a bf16 step (2^-8 of the value), hence the relative term
TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -8, 1e-5)}
# the bf16 tensor-core kernels (flash_attention, chunk_attention,
# chunk_attention_paged) also round their unnormalised P (each p in [0, 1])
# to bf16 before P·V, which moves the output by at most 2^-8·Σ p|v| / l:
# they are held to 2^-8·(softmax(s)·|V|) on top, the plain version run on |v|
P_RTOL = 2.0 ** -8
# the bf16 reduced generate, card against CPU: every activation is rounded to
# bf16 (2^-8 of its value) on both sides, a dozen times along a two-layer
# path, and the sums are taken in other orders: logits agree within 2^-4 of
# the largest CPU logit, and a token may differ only where the CPU's top two
# logits lie within that band of each other (a near-tie)
BF16_LOGIT_BAND = 2.0 ** -4
# page_score does its arithmetic in f32 on both sides whatever q's dtype,
# and its scores reach ~1e3: its error is scaled by the largest score
SCORE_RTOL = 1e-6
# the bf16 reduced model's page scores, card against CPU: each side's q and
# page bounds went through its own bf16 roundings, and the card's scores
# have stayed within 4.0e-3 of the row's largest |score| of the CPU's in
# this check's runs on an H100; they are held within four times that
SEL_SCORE_BAND = 2.0 ** -6
NEG_INF_HALF = -5e29  # below it a page score is masked (NEG_INF)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
# f32 products of matrices at f32 accuracy on the tensor cores: 3xTF32,
# three TF32 products for one, a third of the 495 TFLOP/s TF32 rate (the
# backward's f32 route runs them; the f32 forward could)
PEAK_F32_MMA = 495e12 / 3
PEAK_BYTES = 3.35e12

ARCH = "llama3-8b"
BATCH, PROMPT, GEN = 2, 8192, 32
# the engine phase: 6 requests on 4 slots, prompts of 2048-8192 tokens and
# generations of 8-32 tokens, fed 512 prompt tokens an engine step
ENGINE_BATCH, ENGINE_CHUNK, N_REQUESTS = 4, 512, 6
# the captured engines' fused windows: the reuse steps between two selection
# boundaries (share window 4: three) as one dispatch
ENGINE_WINDOW = 4
ENGINE_PROMPTS, ENGINE_GENS = (2048, 8192), (8, 32)
# tiered residency: each slot's page budget on the card (a slot holds 258
# pages, ~138 of them pinned: 1 sink, 9 local, 128 selected), and the decode
# step from which one request's pages are all forced cold at its next
# selection boundary
TIER_HOT_PAGES, TIER_FORCE_AFTER = 144, 8
# chunk-kernel phase: the context before the chunk of each of the 4 slots
CHUNK_STARTS = (0, 2048, 5120, 7680)
# coplace_shmap: page stripes, and the context of each of the 4 slots in the
# co-placed decode's kernel phase
SHARDS = 8
STRIPE_CTX = (8200, 7000, 5000, 3000)
# speculative decode: the draft length, and the sampled setting of its runs
SPEC_K = 4
SPEC_SAMPLING = dict(temperature=0.8, top_p=0.95, seed=1)
# gemma3-1b (phases 2 and 10): its lockstep prompts, BATCH of them; the
# eviction pool's slots, the context it starts from full, and its decode
# steps (from 8190 they cross the page boundaries at 8192 and 8224)
G3_ARCH, G3_PROMPT = "gemma3-1b", 16384
POOL_PAGES, POOL_CTX, POOL_STEPS = 160, 8190, 72
# the MoE family (phases 2 and 11): qwen3-moe-235b at full width cut to
# MOE_LAYERS of 94 layers (~42 GB of bf16 weights), kimi-k2-1t to
# KIMI_LAYERS of 61 (~39 GB)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 8
KIMI_ARCH, KIMI_LAYERS = "kimi-k2-1t-a32b", 1
# the recurrent mixers (phases 2 and 12): zamba2-2.7b at full width (54
# layers: 45 mamba2, 9 attention at head_dim 80 with 32 kv heads, 16
# retrieval and 16 streaming, GQA group 1), phase 12b cut to Z_LAYERS (3 of
# its 9 periods: its eager engine took 28 s at full depth); xlstm-125m at
# full width and depth (12 mLSTM / sLSTM layers, no attention), its
# lockstep prompts, and its engine's chunk, workload and slots: a chunk step
# is a loop of X_CHUNK time steps of eager ops a layer, so the captured
# graphs hold that many (the prompts were 2048 and 256-640 tokens, 11.6 s
# of prefill and 20.5 s of eager engine on an H100 at 700 W)
X_ARCH, Z_ARCH = "xlstm-125m", "zamba2-2.7b"
Z_LAYERS = 18
X_PROMPT, X_CHUNK = 1024, 128
X_ENGINE = [(256, 12), (192, 9), (320, 16), (128, 10)]
# the frontend-stub families (phases 2, 13a and 14), fed seeded embeddings:
# internvl2-1b (24 layers, 14 query heads over 2 kv heads: GQA group 7,
# head_dim 64) and musicgen-large (48 layers, 32 MHA heads, head_dim 64);
# their reduced configs (internvl2-1b at its 14 over 2 heads) and decode
# steps for the card against CPU; internvl2-1b's full-width train step
STUB_ARCHS = ("internvl2-1b", "musicgen-large")
STUB_REDUCED = (("internvl2-1b", dict(num_heads=14, num_kv_heads=2)), ("musicgen-large", {}))
STUB_REDUCED_STEPS = 8
STUB_TRAIN_B, STUB_TRAIN_S, STUB_TRAIN_STEPS = 4, 2048, 4
# f32 logits, card against CPU, after the whole reduced stack (the ROADMAP's
# band for the port against the reference, EXPERIMENTS.md:250-266); f32
# parameters after one AdamW step: where a gradient is near zero its
# normalised step rests on the sums' last bits, so an element may move by up
# to 2·lr (tests/test_torch_train.py::test_train_step_matches_jax)
LOGIT_TOL, PARAM_TOL = 2e-4, 1e-5
FLUSH_BYTES = 256 << 20  # more than the 50 MB L2
HOLD_CYCLES = 2_000_000  # the Timer's hold of the card, ~1.1 ms at 1.755 GHz


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class Timer:
    """Median device time of a call, with the L2 flushed before each run.
    The card is held busy (``torch.cuda._sleep``, about a millisecond) while
    the host enqueues the call, so the time between the two events is the
    card's alone: without it, a call that is shorter than the host's time to
    enqueue it (a decode kernel of tens of microseconds behind its Python
    wrapper) would be timed as the host's enqueue."""

    def __init__(self, dev):
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def ms(self, fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(HOLD_CYCLES)
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


def bound(byte_count: int, flops: float, dtype, mma: bool = False):
    """The least time of the work: its bytes at the memory rate or its FLOP
    at the peak of its type, whichever is longer; ``mma``: the FLOP are
    products of matrices, which f32 can run on the tensor cores as 3xTF32."""
    tb = byte_count / PEAK_BYTES * 1e3
    peak = PEAK_F32_MMA if mma and dtype == torch.float32 else PEAK_FLOPS[dtype]
    tf = flops / peak * 1e3
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


def p_excess(out, want, p_term) -> float:
    """excess() of a bf16 tensor-core kernel, whose tolerance adds
    P_RTOL·(softmax(s)·|V|): ``p_term`` is the plain version run on |v|."""
    rtol, atol = TOL[torch.bfloat16]
    want = want.float()
    return ((out.float() - want).abs() - P_RTOL * p_term - rtol * want.abs()
            - atol).max().item()


P_TOL_TEXT = f"{P_RTOL:.4g}*(softmax(s)*|V|) + {tol_text(torch.bfloat16)}"


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


def check_flash(ops, ref, timer, dev, cfg, dtype, gen, prompt=PROMPT, heads_cases=None):
    """The prefill kernel at the lockstep path's shapes: B=BATCH prompts of
    ``prompt`` tokens; ``heads_cases`` (label, kv heads, window, sink), by
    default the H²EAL retrieval and streaming heads of ``cfg``."""
    h2 = cfg.h2eal
    hkv = cfg.num_kv_heads
    nr = hkv - round(hkv * h2.static_sparsity)
    g = cfg.num_heads // hkv
    d = cfg.resolved_head_dim
    if heads_cases is None:
        heads_cases = (("retrieval", nr, 0, 0), ("streaming", hkv - nr, h2.local, h2.sink))
    cases = []
    for label, heads, window, sink in heads_cases:
        q = torch.randn(BATCH, prompt, heads * g, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(BATCH, prompt, heads, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(BATCH, prompt, heads, d, generator=gen, device=dev).to(dtype)
        run = lambda: ops.flash_attention(q, k, v, causal=True, window=window, sink=sink)
        plain = lambda: ref.flash_attention_ref(q, k, v, causal=True, window=window, sink=sink)
        out = run()
        want = ref.flash_attention_ref(*widened(q, k, v), causal=True, window=window,
                                       sink=sink)
        torch.cuda.synchronize()
        e, ex = err(out, want), excess(out, want, dtype)
        tol = tol_text(dtype)
        if dtype == torch.bfloat16:
            del want
            torch.cuda.empty_cache()
            p_term = ref.flash_attention_ref(*widened(q, k, v.abs()), causal=True,
                                             window=window, sink=sink)
            want = ref.flash_attention_ref(*widened(q, k, v), causal=True, window=window,
                                           sink=sink)
            ex, tol = p_excess(out, want, p_term), P_TOL_TEXT
            del p_term
        del want
        torch.cuda.empty_cache()
        ms = timer.ms(run, 5)
        plain_ms = timer.ms(plain, 2)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            i = torch.arange(prompt, device=dev)[:, None]
            j = torch.arange(prompt, device=dev)[None, :]
            mask = (j <= i) & ((j > i - window) | (j < sink))
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True)
        lib_ms = timer.ms(lib, 5)
        flops = 4 * d * flash_pairs(prompt, window, sink) * BATCH * heads * g
        b_ms, b_by = bound(nbytes(q, k, v, out), flops, dtype)
        cases.append(dict(
            case=f"{label} B={BATCH} S={prompt} Hq={heads * g} Hkv={heads} D={d}"
                 + (f" window={window} sink={sink}" if window else ""),
            dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex,
            tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
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
    """page_score's scores mode at the lockstep path's shapes (every page,
    nothing masked), then its select mode, the whole select step of the
    main paths (``check_page_select``)."""
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
    scores = dict(
        case=f"scores mode B={BATCH} Hr={nr} g={g} C={c} D={d}",
        dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex,
        tol=f"{SCORE_RTOL:.0e}*max|plain|", ms=timer.ms(run, 20), plain_ms=timer.ms(plain, 20),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, main=False)
    del tau_min, tau_max
    return [scores] + [check_page_select(ops, ref, timer, dev, cfg, dtype, gen, path)
                       for path in ("lockstep", "engine", "coplace")]


def select_inputs(gen, dev, cfg, dtype, path):
    """A retrieval layer's select-step inputs at a main path's shapes:
    lockstep, B=2 slots at context PROMPT + 1 in 258 pages; engine, 4 slots
    at contexts STRIPE_CTX in 258 pages, one slot outside its share
    window's select step; coplace, the same in 264 pages striped over
    SHARDS stripes. τ of the written pages from 32 random keys each."""
    from repro_torch.core import layouts, paging

    h2 = cfg.h2eal
    nr, _, g, d = head_split(cfg)
    p, top_k = h2.page_size, h2.top_k_pages
    cap = serve_capacity(cfg) if path == "lockstep" else engine_workload(cfg)[1]
    shards = SHARDS if path == "coplace" else 1
    if shards > 1:
        cap = layouts.get_layout("coplace_shmap", shards).plan(cfg).round_capacity(cap)
    c = -(-cap // p)
    if path == "lockstep":
        b, ctx, ctx_rows, need = BATCH, PROMPT + 1, [PROMPT + 1] * BATCH, None
    else:
        b, ctx_rows = len(STRIPE_CTX), list(STRIPE_CTX)
        ctx = torch.tensor(ctx_rows, dtype=torch.int32, device=dev)
        need = torch.tensor([i != 1 for i in range(b)], device=dev)
    ctx_t = torch.tensor(ctx_rows, device=dev)
    filled = max(-(-n // p) for n in ctx_rows)
    tau_min, tau_max = make_tau(gen, dev, b, nr, c, filled, d)
    first = torch.arange(c, device=dev) * p
    start = torch.where(first[None] < ctx_t[:, None], first[None], -1)
    start = start[:, None, :].expand(b, nr, c).to(torch.int32)
    empty = (start < 0)[..., None]
    tau_min = torch.where(empty, math.inf, tau_min)
    tau_max = torch.where(empty, -math.inf, tau_max)
    if shards > 1:  # the striped physical order, as the coplace_shmap cache holds it
        lop = paging.logical_pages(c, shards, dev)
        tau_min, tau_max, start = (x.index_select(2, lop) for x in (tau_min, tau_max, start))
    q = torch.randn(b, nr * g, d, generator=gen, device=dev).to(dtype)
    sel_prev = torch.randint(0, c, (b, nr, top_k), generator=gen, device=dev,
                             dtype=torch.int32)
    imp_prev = torch.rand(b, nr, c, generator=gen, device=dev) * 100
    return (q, tau_min.contiguous(), tau_max.contiguous(), start.contiguous(), ctx,
            sel_prev, imp_prev, need), shards


def parent_select(ops, q, tau_min, tau_max, page_start, ctx, sel_prev, imp_prev,
                  need=None, *, sink, local, page, top_k, shards):
    """The select section as the parent commit's decode bodies ran it, op
    for op: ``ops.page_score``, the mask (``paging.score_pages``), the
    stable sort and gather (``select_pages``; under coplace_shmap, per
    stripe and then over the stripes' concatenation, -1 where masked), the
    padding, the importance and the share-window keep."""
    neg_inf = -1e30
    scores = ops.page_score(q, tau_min, tau_max)
    n_sink = -(-sink // page) if sink else 0
    if isinstance(ctx, torch.Tensor):
        first_local = (torch.clamp(ctx - local, min=0) // page)[:, None, None]
    else:
        first_local = max(ctx - local, 0) // page
    pidx = torch.where(page_start >= 0, page_start // page, -1)
    selectable = (page_start >= 0) & (pidx >= n_sink) & (pidx < first_local)
    scores = torch.where(selectable, scores, neg_inf)

    def top(x, k):
        order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
        return x.gather(-1, order), order

    def pad(idx):
        idx = idx.to(torch.int32)
        if idx.shape[-1] < top_k:
            idx = torch.cat([idx, idx.new_full(idx.shape[:-1] + (top_k - idx.shape[-1],),
                                               -1)], dim=-1)
        return idx

    b, hr, c = scores.shape
    if shards == 1:
        sel = pad(top(scores, min(top_k, c))[1])
        imp = imp_prev + torch.where(scores > neg_inf / 2, scores, 0.0)
    else:
        imp = imp_prev + torch.where(scores > neg_inf / 2, scores, 0.0)
        c_loc = c // shards
        k_eff = min(top_k, c_loc)
        v_loc, i_loc = top(scores.view(b, hr, shards, c_loc), k_eff)
        base = torch.arange(shards, device=scores.device)[:, None] * c_loc
        v_cat = v_loc.reshape(b, hr, shards * k_eff)
        i_cat = (i_loc + base).reshape(b, hr, shards * k_eff)
        sel_v, sel_pos = top(v_cat, min(top_k, shards * k_eff))
        sel = pad(torch.where(sel_v > NEG_INF_HALF, i_cat.gather(2, sel_pos), -1))
    if need is not None:
        ns = need[:, None, None]
        sel = torch.where(ns, sel, sel_prev)
        imp = torch.where(ns, imp, imp_prev)
    return sel, imp


def check_page_select(ops, ref, timer, dev, cfg, dtype, gen, path):
    """page_score's select mode, ``ops.page_select``: a retrieval layer's
    whole select step in one launch, at a main path's shapes
    (``select_inputs``). Fails unless its selection is the stable top-k of
    its own scores (read back as imp - 0 on the selectable pages, in the
    path's layout: coplace also against the two-stage per-stripe form),
    its scores lie within SCORE_RTOL of the plain version's, and the row
    outside its select step keeps its selection and importance bit for
    bit. Times the launch, the plain version, the parent's section
    (``parent_select``), the scores mode alone, and the yardstick: the
    scores mode, the mask, then ``torch.topk`` (another tie order)."""
    args, shards = select_inputs(gen, dev, cfg, dtype, path)
    q, tau_min, tau_max, start, ctx, sel_prev, imp_prev, need = args
    h2 = cfg.h2eal
    top_k = h2.top_k_pages
    kw = dict(sink=h2.sink, local=h2.local, page=h2.page_size, top_k=top_k)
    flag = dict(minus_one_masked=shards > 1)
    b, hr, c = start.shape
    g, d = q.shape[1] // hr, q.shape[2]
    tag = str(dtype).split(".")[-1]
    zeros = torch.zeros_like(imp_prev)
    sel0, imp0 = ops.page_select(q, tau_min, tau_max, start, ctx, sel_prev, zeros, **kw, **flag)
    run = lambda: ops.page_select(*args, **kw, **flag)
    sel1, imp1 = run()
    plain_sel, plain_imp = ref.page_select_ref(q.float(), *args[1:], **kw, **flag)
    torch.cuda.synchronize()
    ok = ref.selectable_pages(start, ctx, sink=h2.sink, local=h2.local, page=h2.page_size)
    own = torch.where(ok, imp0, ref.NEG_INF).cpu()
    if not torch.equal(sel0.cpu(), ref.select_top_k(own, top_k, **flag)) or (
            shards > 1 and not torch.equal(sel0.cpu(), ref.select_top_k(
                own, top_k, shards=shards, **flag))):
        fail(f"page_select ({path} {tag}): the selection is not the stable top-k of the "
             f"kernel's own scores")
    plain = torch.where(ok, ref.page_score_ref(*widened(q, tau_min, tau_max)), ref.NEG_INF)
    live = ok.cpu()
    e = err(own[live], plain.cpu()[live])
    ex = e - SCORE_RTOL * plain.cpu()[live].abs().max().item()
    rows = torch.ones(b, dtype=torch.bool) if need is None else need.cpu()
    if not (torch.equal(sel1.cpu()[~rows], sel_prev.cpu()[~rows])
            and torch.equal(imp1.cpu()[~rows], imp_prev.cpu()[~rows])
            and torch.equal(sel1.cpu()[rows], sel0.cpu()[rows])):
        fail(f"page_select ({path} {tag}): a row outside its select step changed, or the "
             f"selection moved with the importance")
    same = int((plain_sel == sel1).all(dim=-1).sum().item())
    ex = max(ex, ((imp1 - plain_imp).abs()[rows.to(dev)] - 2 * SCORE_RTOL
                  * plain.cpu()[live].abs().max().item() - 1e-6 * plain_imp.abs()[
                      rows.to(dev)]).max().item())

    def yardstick():
        m = ref.selectable_pages(start, ctx, sink=h2.sink, local=h2.local,
                                 page=h2.page_size)
        return torch.topk(torch.where(m, ops.page_score(q, tau_min, tau_max), ref.NEG_INF),
                          min(top_k, c))

    section = lambda: parent_select(ops, *args, **kw, shards=shards)
    if not torch.equal(section()[0], sel1):
        log(f"page_select ({path} {tag}): the parent's section selects otherwise in "
            f"some row (a near-tie of its scores and the kernel's)")
    # the bytes this run needs: τ of the scored pages; the rows that select
    # read their page starts, q and ctx; imp in and out; sel written, and
    # read where a row keeps its selection
    sel_rows = rows.to(dev)[:, None, None]
    scored = int((ok & sel_rows).sum().item())
    n_rows = int(rows.sum().item())
    byte_count = (2 * scored * d * 4 + n_rows * hr * (c * 4 + g * d * q.element_size())
                  + 2 * nbytes(imp_prev) + nbytes(sel1) + (b - n_rows) * hr * top_k * 4
                  + b * 4 * isinstance(ctx, torch.Tensor) + (0 if need is None else b))
    b_ms, b_by = bound(byte_count, 4 * d * g * scored, torch.float32)
    return dict(
        case=f"select ({path}) B={b} Hr={hr} g={g} C={c} D={d} K={top_k} "
             f"scored={scored} rows={n_rows}/{b}"
             + (f" S={shards} minus_one_masked" if shards > 1 else ""),
        dtype=tag, max_abs_err=e, excess=ex,
        tol=f"{SCORE_RTOL:.0e}*max|plain| (scores); selection exact on its own scores",
        ms=timer.ms(run, 20), plain_ms=timer.ms(lambda: ref.page_select_ref(
            *args, **kw, **flag), 20),
        library_ms=timer.ms(yardstick, 20),
        library="page_score + mask + torch.topk (another tie order)",
        section_ms=timer.ms(section, 20),
        scores_ms=timer.ms(lambda: ops.page_score(q, tau_min, tau_max), 20),
        plain_rows_equal=f"{same}/{b * hr}",
        bound_ms=b_ms, bound_by=b_by, main=path == "engine")


def retrieval_pages(gen, dev, cfg, dtype, capacity, draft=False, prompt=PROMPT):
    """The retrieval heads' decode inputs of the lockstep path at its main
    shapes: B=2 slots at context PROMPT + 1 in a cache of ``capacity``
    tokens (258 pages of 32), a random top-128 selection of each (slot, kv
    head)'s selectable pages, the [sink | selected | local] slot list (138
    slots, 4416 tokens) and its validity, as the decode body builds them.
    ``draft``: the streaming draft's selection, every selected slot -1."""
    from repro_torch.core import paging

    h2 = cfg.h2eal
    nr, _, g, d = head_split(cfg)
    p, top_k = h2.page_size, h2.top_k_pages
    c = -(-capacity // p)
    ctx = prompt + 1
    first = torch.arange(c, device=dev) * p
    start = torch.where(first < ctx, first, -1).to(torch.int32)
    start = start.expand(BATCH, nr, c).contiguous()
    n_sink = -(-h2.sink // p)
    first_local = paging.first_local_page(ctx, local=h2.local, page=p)
    pick = torch.rand(BATCH, nr, first_local - n_sink, generator=gen, device=dev)
    sel = (pick.argsort(dim=-1)[..., :top_k] + n_sink).to(torch.int32)
    if draft:
        sel = torch.full_like(sel, -1)
    slots = paging.attended_page_slots(sel, ctx, sink=h2.sink, local=h2.local, page=p)
    valid = paging.token_validity(slots, start, ctx, sink=h2.sink, local=h2.local,
                                  page=p, top_k=top_k)
    q = torch.randn(BATCH, nr * g, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(BATCH, nr, c, p, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(BATCH, nr, c, p, d, generator=gen, device=dev).to(dtype)
    return q, kp, vp, slots.contiguous(), valid.contiguous()


def check_paged_pages(ops, ref, timer, dev, cfg, dtype, gen, capacity, draft=False,
                      prompt=PROMPT):
    """paged_attention_pages (the retrieval heads' decode: the page gather
    fused) at the lockstep path's shapes; beside the kernel, the unfused
    path it replaced (the gather, then the contiguous kernel), the gather
    then SDPA, and SDPA alone on the gathered buffer. ``draft``: the
    streaming draft's reuse steps, every selected slot the -1 sentinel
    (sink and local pages only)."""
    q, kp, vp, slots, valid = retrieval_pages(gen, dev, cfg, dtype, capacity, draft, prompt)
    b, hr, n = slots.shape
    g, d, p = q.shape[1] // hr, q.shape[2], kp.shape[3]
    run = lambda: ops.paged_attention_pages(q, kp, vp, slots, valid)
    plain = lambda: ref.paged_attention_pages_ref(q, kp, vp, slots, valid)
    out = run()
    want = ref.paged_attention_pages_ref(*widened(q, kp, vp), slots, valid)
    torch.cuda.synchronize()
    e, ex = err(out, want), excess(out, want, dtype)
    gk, gv = ref.gather_pages(kp, vp, slots)
    mask = valid.repeat_interleave(g, dim=1)[:, :, None, :]
    sdpa = lambda k, v: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
    unfused = lambda: ops.paged_attention(q, *ref.gather_pages(kp, vp, slots), valid)
    n_valid = int(valid.sum().item())
    pages_read = int(valid.reshape(b, hr, n, p).any(dim=-1).sum().item())
    b_ms, b_by = bound(nbytes(q, slots, valid, out) + 2 * pages_read * p * d * kp.element_size(),
                       4 * d * g * n_valid, dtype)
    return dict(
        case=f"retrieval, pages read in place{', draft selection (-1)' if draft else ''} "
             f"B={b} Hq={hr * g} Hkv={hr} C={kp.shape[2]} P={p} N={n} T={n * p} D={d} "
             f"valid={n_valid}",
        dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex, tol=tol_text(dtype),
        ms=timer.ms(run, 20), plain_ms=timer.ms(plain, 20),
        library_ms=timer.ms(lambda: sdpa(gk, gv), 20),
        library="SDPA on the gathered buffer",
        unfused_ms=timer.ms(unfused, 20),
        gather_sdpa_ms=timer.ms(lambda: sdpa(*ref.gather_pages(kp, vp, slots)), 20),
        bound_ms=b_ms, bound_by=b_by, main=not draft)


def check_paged(ops, ref, timer, dev, cfg, dtype, gen, capacity):
    """paged_attention on a contiguous buffer: the retrieval heads' case as
    a gathered buffer (the main path reads their pages in place,
    ``check_paged_pages``), the streaming ring and the full-attention
    baseline; then the retrieval heads' case as the main path runs it."""
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
    for label, heads, t, main in (("retrieval", nr, t_ret, False),
                                  ("streaming", hkv - nr, t_str, True),
                                  ("full-attention baseline", hkv, capacity, False)):
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
            library_ms=timer.ms(lib, 20), bound_ms=b_ms, bound_by=b_by, main=main))
    return cases + [check_paged_pages(ops, ref, timer, dev, cfg, dtype, gen, capacity),
                    check_paged_pages(ops, ref, timer, dev, cfg, dtype, gen, capacity,
                                      draft=True)]


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


def stripe_inputs(gen, dev, cfg, dtype, shards=SHARDS):
    """The retrieval heads' decode inputs of the coplace_shmap path at its
    main shapes: 4 slots at contexts STRIPE_CTX in a cache of the engine
    capacity rounded to whole pages of ``shards`` stripes (264 pages of 32
    at SHARDS),
    the striped page order, a random top-128 selection of each slot's
    selectable pages (-1 padded where fewer), the unsplit [sink | selected
    | local] slot list (138 slots, 4416 tokens) and its validity, as the
    decode body hands them to ``ops.paged_attention_coplace``."""
    from repro_torch.core import layouts, paging

    h2 = cfg.h2eal
    nr, _, g, d = head_split(cfg)
    p, top_k = h2.page_size, h2.top_k_pages
    cap = layouts.get_layout("coplace_shmap", shards).plan(cfg).round_capacity(
        engine_workload(cfg)[1])
    c = cap // p
    b = len(STRIPE_CTX)
    ctx = torch.tensor(STRIPE_CTX, device=dev)
    lop = paging.logical_pages(c, shards, dev)                    # (C,)
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
    sel = torch.where(sel >= 0, paging.interleave_slot(sel, c, shards), -1)
    slots = paging.coplace_attended_slots(sel, ctx, sink=h2.sink, local=h2.local,
                                          page=p, capacity=c, n_shards=shards)
    valid = paging.token_validity(slots, start, ctx, sink=h2.sink, local=h2.local,
                                  page=p, top_k=top_k)
    q = torch.randn(b, nr * g, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(b, nr, c, p, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(b, nr, c, p, d, generator=gen, device=dev).to(dtype)
    return q, kp, vp, slots.contiguous(), valid.contiguous()


def busiest_units(ops, slots, valid, page, capacity) -> str:
    """The most 32-token units with a valid token that one block of the
    co-placed decode walks (the stripe's own), beside the most that one
    split of ``paged_attention_pages`` walks on the same list (contiguous
    ranges): the two grids' critical paths."""
    b, h, n = slots.shape
    t = n * page
    pad = -t % 32
    live = lambda keep: torch.nn.functional.pad(keep, (0, pad)).reshape(
        b, h, -1, 32).any(-1)                                     # (B, H, units)
    owner = torch.where(slots >= 0, slots // (capacity // SHARDS), -1)
    owner = owner.repeat_interleave(page, dim=-1)
    stripe = max(int(live(valid & (owner == s)).sum(-1).max()) for s in range(SHARDS))
    units = live(valid)
    n_split = ops.paged_splits(b, h, t)
    u = units.shape[-1]
    split = max(int(units[..., i * u // n_split:(i + 1) * u // n_split].sum(-1).max())
                for i in range(n_split))
    return f"stripe {stripe}, contiguous split {split} of {n_split}"


def check_partial(ops, ref, timer, dev, cfg, dtype, gen):
    """The co-placed decode at the coplace_shmap path's shapes: the main
    path's one launch, ``paged_attention_coplace`` on the unsplit list
    (beside it ``paged_attention_pages`` on the same list, which ignores
    the stripes, and the gather then SDPA); ``paged_attention_partial`` on
    the stripes' lists; then the standalone combine_partials on the
    partials it produced. Returns (partial cases, combine cases)."""
    q, kp, vp, slots, valid = stripe_inputs(gen, dev, cfg, dtype)
    b, hr, n = slots.shape
    g, d, p, c = q.shape[1] // hr, q.shape[2], kp.shape[3], kp.shape[2]
    tag = str(dtype).split(".")[-1]
    n_valid = int(valid.sum().item())
    kv_bytes = 2 * n_valid * d * kp.element_size()
    flops = 4 * d * g * n_valid
    shape = (f"B={b} Hq={hr * g} Hr={hr} N={n} P={p} T={n * p} D={d} "
             f"ctx={list(STRIPE_CTX)} valid={n_valid}")

    run = lambda: ops.paged_attention_coplace(q, kp, vp, slots, valid, SHARDS)
    plain = lambda: ref.paged_attention_coplace_ref(q, kp, vp, slots, valid, SHARDS)
    out = run()
    want = ref.paged_attention_coplace_ref(*widened(q, kp, vp), slots, valid, SHARDS)
    torch.cuda.synchronize()
    e, ex = err(out, want), excess(out, want, dtype)
    del want
    mask = valid.repeat_interleave(g, dim=1)[:, :, None, :]
    gather_sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], *ref.gather_pages(kp, vp, slots), attn_mask=mask, enable_gqa=True)
    b_ms, b_by = bound(nbytes(q, slots, valid, out) + kv_bytes, flops, dtype)
    coplace = dict(
        case=f"coplace, merged in the launch S={SHARDS} {shape}; the busiest block's "
             f"live units: {busiest_units(ops, slots, valid, p, c)}", dtype=tag,
        max_abs_err=e, excess=ex, tol=tol_text(dtype), ms=timer.ms(run, 20),
        plain_ms=timer.ms(plain, 5), library_ms=timer.ms(gather_sdpa, 20),
        library="gather_pages + SDPA on the unsplit list",
        pages_ms=timer.ms(lambda: ops.paged_attention_pages(q, kp, vp, slots, valid), 20),
        bound_ms=b_ms, bound_by=b_by, main=True)

    slots_s, valid_s = ref.stripe_slots(slots, valid, shards=SHARDS, capacity=c)
    run = lambda: ops.paged_attention_partial(q, kp, vp, slots_s, valid_s)
    plain = lambda: ref.paged_attention_partial_pages_ref(q, kp, vp, slots_s, valid_s)
    got = run()
    want = ref.paged_attention_partial_pages_ref(*widened(q, kp, vp), slots_s, valid_s)
    torch.cuda.synchronize()
    e = max(err(a, w) for a, w in zip(got, want))
    ex = partial_excess(got, want)
    del want
    b_ms, b_by = bound(nbytes(q, slots_s, valid_s, *got) + kv_bytes, flops, dtype)
    part = dict(
        case=f"partials S={SHARDS} {shape}", dtype=tag, max_abs_err=e, excess=ex,
        tol="1e-4*max(l,1) (f32 outputs; m: 1e-4*max(|m|,1))",
        ms=timer.ms(run, 20), plain_ms=timer.ms(plain, 5), library_ms=None,
        bound_ms=b_ms, bound_by=b_by, main=False)
    m, l, o = got
    run_c = lambda: ops.combine_partials(m, l, o)
    plain_c = lambda: ref.combine_partials_ref(m, l, o)
    out, want_c = run_c(), plain_c()
    torch.cuda.synchronize()
    rows = b * hr * g
    b_ms, b_by = bound(nbytes(m, l, o, out), SHARDS * rows * (2 * d + 4), torch.float32)
    comb = dict(
        case=f"N={SHARDS} B={b} Hq={hr * g} D={d} (f32 partials of the {tag} path)",
        dtype=tag, max_abs_err=err(out, want_c), excess=excess(out, want_c, torch.float32),
        tol=tol_text(torch.float32), ms=timer.ms(run_c, 50), plain_ms=timer.ms(plain_c, 50),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    return [coplace, part], [comb]


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
    e, ex, tol = err(out, want), excess(out, want, dtype), tol_text(dtype)
    if dtype == torch.bfloat16:
        p_term = ref.chunk_attention_ref(*widened(q, k, v.abs()), valid)
        ex, tol = p_excess(out, want, p_term), P_TOL_TEXT
        del p_term
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
        dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex, tol=tol,
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
    e, ex, tol = err(out, want), excess(out, want, dtype), tol_text(dtype)
    if dtype == torch.bfloat16:
        p_term = ref.chunk_attention_paged_ref(*widened(q, kp, vp.abs()), ps, start,
                                               *widened(kn, vn.abs()))
        ex, tol = p_excess(out, want, p_term), P_TOL_TEXT
        del p_term
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
        dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex, tol=tol,
        ms=timer.ms(run, 10), plain_ms=timer.ms(plain, 2), library_ms=timer.ms(lib, 5),
        bound_ms=b_ms, bound_by=b_by)
    del kb, vb, mask, lib_mask
    torch.cuda.empty_cache()
    return [case]


# ---------------------------------------------------------------------------
# Phases 3 to 5: the serving path
# ---------------------------------------------------------------------------


def check_reduced_against_cpu(dev, cfg=None, prompt_len=45):
    """A reduced model (llama3-8b unless ``cfg``), f32: card (kernels)
    against CPU (plain versions)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    cfg = cfg or reduced(get_arch(ARCH))
    gen = torch.Generator().manual_seed(1)
    params = M.init_params(cfg, generator=gen, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt_len), generator=gen)
    params_dev = _to(params, dev)
    kw = dict(gen=12, capacity=prompt_len + 12 + cfg.h2eal.page_size)
    toks_cpu, st_cpu = generate(cfg, params, prompts, device="cpu", **kw)
    toks_dev, st_dev = generate(cfg, params_dev, prompts, device=dev, **kw)
    e = err(st_dev["last_logits"].cpu(), st_cpu["last_logits"])
    log(f"reduced {cfg.name} (prompt {prompt_len}): card vs CPU tokens equal="
        f"{torch.equal(toks_dev.cpu(), toks_cpu)} last-logit max err={e:.3e}")
    if not torch.equal(toks_dev.cpu(), toks_cpu) or e > 1e-3:
        fail("reduced generate on the card disagrees with the CPU run "
             "(tokens must match, logits within 1e-3)")


def lockstep(cfg, params, prompts, gen, capacity, dev):
    """Greedy lockstep generation as ``launch.serve.generate`` runs it,
    keeping the logits of every step: (tokens (B, gen), [logits (B, V)]),
    the first logits being the prefill's."""
    from repro_torch.runtime import serve as serve_rt

    scfg = serve_rt.ServeConfig(capacity=capacity)
    steps = {True: serve_rt.make_decode_step(cfg, scfg, do_select=True),
             False: serve_rt.make_decode_step(cfg, scfg, do_select=False)}
    w = max(cfg.h2eal.share_window, 1)
    with torch.inference_mode():
        logits, state = serve_rt.make_prefill(cfg, scfg)(params, prompts.to(dev))
        outs, toks = [logits.float().cpu()], []
        for i in range(gen):
            toks.append(logits.argmax(dim=-1).to(torch.int32))
            if i == gen - 1:
                break
            logits, state = steps[i % w == 0](params, state, toks[-1])
            outs.append(logits.float().cpu())
    return torch.stack(toks, dim=1).cpu(), outs


def check_reduced_bf16_against_cpu(dev):
    """Reduced llama3-8b at the production head_dim of 128, in bf16, so the
    tensor-core flash kernel and the split-KV paged kernel run at their
    serving head size (``bf16_generate_against_cpu``); then its selection
    at the reduced top-k (``check_bf16_selection_against_cpu``)."""
    from repro_torch.configs import get_arch, reduced

    bf16_generate_against_cpu(dev, reduced(get_arch(ARCH), head_dim=128))
    check_bf16_selection_against_cpu(dev)


def bf16_generate_against_cpu(dev, cfg, prompt_len=300, gen_n=12):
    """A reduced model in bf16: card (kernels) against CPU (plain versions),
    prefill and every step's logits within BF16_LOGIT_BAND of the largest
    CPU logit while the tokens agree, and tokens equal except at a near-tie.

    The top-k is raised to cover every page of the context (40 pages of 8):
    at the reduced top-4 of 37 selectable pages, bf16 page scores near-tie
    and the two sides select different pages, a discrete jump of the decode
    logits (0.5 with the same tokens on the card) that says nothing of the
    kernels' arithmetic, as a token near-tie does not. The selection at the
    reduced top-k is held apart, outside its near-ties
    (``check_bf16_selection_against_cpu``)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    page = cfg.h2eal.page_size
    cfg = dataclasses.replace(cfg, h2eal=dataclasses.replace(
        cfg.h2eal, select_budget=-(-(prompt_len + gen_n) // page) * page))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu",
                           dtype=torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt_len),
                            generator=torch.Generator().manual_seed(3))
    capacity = prompt_len + gen_n + cfg.h2eal.page_size
    toks_cpu, lg_cpu = lockstep(cfg, params, prompts, gen_n, capacity, "cpu")
    ops.reset_launches()
    toks_dev, lg_dev = lockstep(cfg, _to(params, dev), prompts, gen_n, capacity, dev)
    launched = dict(ops.LAUNCHES)
    band = BF16_LOGIT_BAND * lg_cpu[0].abs().max().item()
    worst, ties, ok = 0.0, 0, True
    for b in range(prompts.shape[0]):
        for i in range(gen_n):
            worst = max(worst, err(lg_dev[i][b], lg_cpu[i][b]))
            if worst > band:
                ok = False
            if toks_dev[b, i] != toks_cpu[b, i]:
                top2 = lg_cpu[i][b].topk(2).values
                if (top2[0] - top2[1]).item() > band:
                    ok = False
                ties += 1
                break  # the two runs now continue from different tokens
    log(f"reduced {cfg.name} head_dim {cfg.resolved_head_dim} bf16 (prompt {prompt_len}, "
        f"{gen_n} tokens): "
        f"card vs CPU tokens equal={torch.equal(toks_dev, toks_cpu)} (near-tie "
        f"divergences {ties}), logits max err {worst:.3e} while tokens agree "
        f"(band {band:.3e} = 2^-4 * max|CPU logit|), prefill logits max err "
        f"{err(lg_dev[0], lg_cpu[0]):.3e}; launches flash {launched['flash_attention']} "
        f"paged {launched['paged_attention']}")
    if not ok:
        fail("the bf16 reduced generate on the card disagrees with the CPU run beyond "
             "the bf16 band")
    if (launched["flash_attention"] != layer_launches(cfg)["prefill"]
            or launched["paged_attention"] == 0):
        fail("the bf16 reduced generate did not launch the flash and paged kernels")


def check_bf16_selection_against_cpu(dev):
    """Reduced llama3-8b at head_dim 128 in bf16 with its own top-k (4 of
    ~34 selectable pages): one prefill of 64 prompts and one select decode
    step, on the card and on the CPU, fed the same token; every layer's
    select step (``ops.page_select``: the fused kernel on the card, its
    plain version on the CPU) is kept, one (layer, slot, kv head) row each.
    A step's page scores are its importance minus the previous (0 after
    the prefill) on the selectable pages.

      scores: the card's within SEL_SCORE_BAND of the row's largest |score|
        of the CPU's, on the same pages (masked pages alike);
      run against run: if every score of a row moved by at most e, the
        top-k can change only where the CPU's gap between the k-th and
        (k+1)-th score is at most 2e, a near-tie; every other row's
        selection must be the CPU's;
      same inputs: the kernel's selection on the CPU run's q and page
        bounds against the CPU's, near-ties within page_score's f32
        tolerance (SCORE_RTOL of the row's largest |score|) skipped.

    Fails on a score out of its band, on a different selection in a compared
    row, or when a comparison compared no row; prints how many rows each
    compared and skipped."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.runtime import serve as serve_rt

    prompt_len, n_slots = 300, 64
    cfg = reduced(get_arch(ARCH), head_dim=128)
    h2 = cfg.h2eal
    top_k = h2.top_k_pages
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(4), device="cpu",
                           dtype=torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (n_slots, prompt_len),
                            generator=torch.Generator().manual_seed(5))
    scfg = serve_rt.ServeConfig(capacity=prompt_len + 8 + h2.page_size)
    page_select = ops.page_select
    tok = None

    def run(where, weights):
        """[(page_select's arguments, scores, selection)] of each layer."""
        nonlocal tok
        rec = []

        def recording(*a, **kw):
            sel, imp = page_select(*a, **kw)
            q, tau_min, tau_max, start, ctx, sel_prev, imp_prev = a[:7]
            ok = ref.selectable_pages(start, ctx, sink=h2.sink, local=h2.local,
                                      page=h2.page_size)
            rec.append((a, kw, torch.where(ok, imp - imp_prev, ref.NEG_INF), sel))
            return sel, imp

        with torch.inference_mode():
            logits, state = serve_rt.make_prefill(cfg, scfg)(weights, prompts.to(where))
            if tok is None:
                tok = logits.argmax(dim=-1).to(torch.int32).cpu()
            ops.page_select = recording
            try:
                serve_rt.make_decode_step(cfg, scfg, do_select=True)(weights, state,
                                                                     tok.to(where))
            finally:
                ops.page_select = page_select
        return rec

    cpu = run("cpu", params)
    card = run(dev, _to(params, dev))
    if not len(cpu) == len(card) == cfg.num_layers:
        fail("the bf16 selection check did not see one selection a layer")
    counts = {"run against run": [0, 0], "same inputs": [0, 0]}
    worst = 0.0
    with torch.inference_mode():
        for (args, kw, sc, sel), (_, _, sc_card, sel_card) in zip(cpu, card):
            sc_card = sc_card.cpu()
            live = sc > NEG_INF_HALF
            if not torch.equal(live, sc_card > NEG_INF_HALF):
                fail("bf16 page scores: the card masks other pages than the CPU")
            top = torch.where(live, sc.abs(), 0.0).amax(dim=-1)
            moved = torch.where(live, (sc_card - sc).abs(), 0.0).amax(dim=-1)
            worst = max(worst, (moved / top).max().item())
            if (moved > SEL_SCORE_BAND * top).any():
                fail(f"bf16 page scores: the card's moved {worst:.3e} of the row's largest "
                     f"|score| from the CPU's, above the band {SEL_SCORE_BAND:.3e}")
            srt = sc.sort(dim=-1, descending=True).values
            gap = srt[..., top_k - 1] - srt[..., top_k]
            same = ops.page_select(*(x.to(dev) if isinstance(x, torch.Tensor) else x
                                     for x in args), **kw)[0]
            for name, got, band in (("run against run", sel_card, 2 * moved),
                                    ("same inputs", same, SCORE_RTOL * top)):
                got = got.cpu()
                for idx in zip(*torch.nonzero(gap > band, as_tuple=True)):
                    if sorted(got[idx].tolist()) != sorted(sel[idx].tolist()):
                        fail(f"bf16 page selection ({name}): card {sorted(got[idx].tolist())} "
                             f"vs CPU {sorted(sel[idx].tolist())} at (slot, kv head) {idx}, "
                             f"a gap {gap[idx].item():.3e} above the band "
                             f"{band[idx].item():.3e}")
                counts[name][0] += int((gap > band).sum().item())
                counts[name][1] += int((gap <= band).sum().item())
    log(f"reduced {cfg.name} head_dim 128 bf16 selection, top-{top_k} (prompt {prompt_len}, "
        f"{n_slots} slots, {cfg.num_layers} layers; the fused select step): page scores "
        f"card vs CPU run max diff {worst:.3e} of the row's max|score| (band "
        f"{SEL_SCORE_BAND:.3e}); rows (compared, skipped as near-ties): run against run "
        f"{tuple(counts['run against run'])} (band 2 * the row's largest score move), same "
        f"inputs {tuple(counts['same inputs'])} (band {SCORE_RTOL:.0e} * max|score|)")
    if any(n == 0 for n, _ in counts.values()):
        fail("the bf16 selection check compared no row in one of its comparisons")


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


def record_logits(eng):
    """Keep on the host the logits behind every token ``eng`` emits: the
    first token's by request uid, each decode step's by trace row."""
    firsts, steps = {}, []
    first_token, sample = eng._first_token, eng._sample

    def _first(slot, row):
        firsts[int(eng.batch.uid[slot])] = row.float().cpu()
        return first_token(slot, row)

    def _sample(logits, *lanes):
        steps.append(logits.float().cpu())  # a decode step's (first tokens go apart)
        return sample(logits, *lanes)

    eng._first_token, eng._sample = _first, _sample
    return firsts, steps


def check_reduced_bf16_engine_against_cpu(dev):
    """Reduced llama3-8b at head_dim 128 in bf16, chunked Engine with churn
    (5 requests on 2 slots, chunks of 48 that straddle the bf16 chunk
    kernels' q tiles of 32 positions and start inside their 128-key tiles):
    card (the tensor-core chunk kernels) against CPU (plain versions),
    tokens equal except at a near-tie, and every logit behind an agreeing
    token within BF16_LOGIT_BAND of the largest CPU first-token logit. The
    selection budget covers every page, so no page near-tie decides (see
    check_reduced_bf16_against_cpu)."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    capacity = 320
    cfg = reduced(get_arch(ARCH), head_dim=128)
    cfg = dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal,
                                                             select_budget=capacity))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(9), device="cpu",
                           dtype=torch.bfloat16)
    rng = np.random.default_rng(9)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new=m)
            for i, (n, m) in enumerate([(300, 9), (150, 6), (77, 12), (210, 5), (40, 8)])]
    kw = dict(max_batch=2, capacity=capacity, prompt_buckets=[64], prefill_chunk=48)
    cpu_eng = Engine(cfg, params, device="cpu", **kw)
    cpu_rec = record_logits(cpu_eng)
    cpu = cpu_eng.run(reqs)
    ops.reset_launches()
    # eager: the recorder sees each step's logits in Python
    card_eng = Engine(cfg, _to(params, dev), device=dev, eager=True, **kw)
    card_rec = record_logits(card_eng)
    card = card_eng.run(reqs)
    launched = dict(ops.LAUNCHES)

    def logits(rec, comp, i):
        firsts, steps = rec
        return firsts[comp.uid] if i == 0 else steps[comp._step_idx[i - 1]][comp._slot]

    band = BF16_LOGIT_BAND * max(x.abs().max().item() for x in cpu_rec[0].values())
    worst, ties, ok = 0.0, 0, sorted(card) == sorted(cpu)
    for u in cpu:
        a, b = cpu[u], card[u]
        ok = ok and len(a.tokens) == len(b.tokens) and a._step_idx == b._step_idx
        for i, (ta, tb) in enumerate(zip(a.tokens, b.tokens)):
            la = logits(cpu_rec, a, i)
            if ta != tb:
                top2 = la.topk(2).values
                ok = ok and (top2[0] - top2[1]).item() <= band
                ties += 1
                break  # the two runs now continue from different tokens
            worst = max(worst, err(logits(card_rec, b, i), la))
    n_chunks = card_eng.stats.prefill_chunks * cfg.num_layers
    log(f"reduced {cfg.name} head_dim 128 bf16 chunked engine (chunks of 48): card vs CPU "
        f"tokens equal={all(card[u].tokens == cpu[u].tokens for u in cpu)} (near-tie "
        f"divergences {ties}), logits max err {worst:.3e} while tokens agree (band "
        f"{band:.3e}); launches chunk {launched['chunk_attention']} chunk_paged "
        f"{launched['chunk_attention_paged']} (expected {n_chunks} each)")
    if not ok or worst > band:
        fail("the bf16 reduced chunked engine on the card disagrees with the CPU run "
             "beyond the bf16 band")
    if not launched["chunk_attention"] == launched["chunk_attention_paged"] == n_chunks > 0:
        fail("the bf16 reduced chunked engine did not launch the chunk kernels")


def check_reduced_coplace_engine_against_cpu(dev, cfg=None, shards=4):
    """Reduced llama3-8b (unless ``cfg``), the coplace_shmap chunked Engine
    over ``shards`` stripes with balanced admission and slot churn: card
    (kernels) against CPU (plain versions), token for token, with the same
    admission reorders."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    cfg = cfg or reduced(get_arch(ARCH))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(6), device="cpu")
    rng = np.random.default_rng(6)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new=m)
            for i, (n, m) in enumerate([(37, 9), (20, 4), (51, 6), (9, 7), (30, 5),
                                        (44, 3)])]
    kw = dict(max_batch=2, capacity=96, prompt_buckets=[64], prefill_chunk=7,
              layout="coplace_shmap", shards=shards, admission="balanced")
    cpu_eng = Engine(cfg, params, device="cpu", **kw)
    cpu = cpu_eng.run(reqs)
    card_eng = Engine(cfg, _to(params, dev), device=dev, **kw)  # captured
    ops.reset_launches()  # after the warm-up before the captures
    card = card_eng.run(reqs)
    same = all(card[u].tokens == cpu[u].tokens for u in cpu) and sorted(card) == sorted(cpu)
    log(f"reduced {cfg.name} coplace_shmap S={shards} balanced chunked engine: card vs CPU "
        f"tokens equal={same} ({sum(len(c.tokens) for c in cpu.values())} tokens, "
        f"{len(reqs)} requests), admission reorders card {card_eng.stats.admission_reorders}"
        f" / CPU {cpu_eng.stats.admission_reorders}, partial launches "
        f"{ops.LAUNCHES['paged_attention_partial']}")
    if not same or card_eng.stats.admission_reorders != cpu_eng.stats.admission_reorders:
        fail("the reduced coplace_shmap engine on the card disagrees with the CPU run")
    once = card_eng.stats.decode_steps * layer_launches(cfg, split=True)["partial"]
    if ops.LAUNCHES["paged_attention_partial"] != once or ops.LAUNCHES["combine_partials"] != 0:
        fail(f"the reduced coplace_shmap engine did not make its one co-placed launch a "
             f"layer a decode step ({once})")


def layer_launches(cfg, split=False):
    """Kernel launches of one pass over ``cfg``'s attention layers (a
    recurrent layer, mamba2 or xLSTM, launches none), by step kind: a
    prefill (flash), a decode step (paged; the co-placed launch where
    ``split``), a select step's page_select, a chunk step (chunk, chunk
    paged). A layer with a full cache (a sliding-window layer, or H²EAL
    off) makes one launch of each attention; an H²EAL layer one for its
    retrieval and one for its streaming heads, where it has them (a
    prefill with no streaming head is one flash launch)."""
    from repro_torch.models import transformer as T

    n = dict(prefill=0, decode=0, partial=0, select=0, chunk=0, chunk_paged=0)
    for i in cfg.attention_layers:
        spec = T.attn_spec(cfg, i % T.period_len(cfg))
        if spec.window > 0 or not spec.h2.enabled:
            n["prefill"] += 1
            n["decode"] += 1
            n["chunk"] += 1
            continue
        nr, ns = spec.n_retrieval > 0, spec.n_streaming > 0
        n["prefill"] += 1 + (nr and ns)
        n["decode"] += ns + (nr and not split)
        n["partial"] += nr and split
        n["select"] += nr
        n["chunk"] += ns
        n["chunk_paged"] += nr
    return n


def window_launches(s, cfg, fused_len, split):
    """The decode and chunk kernels' launches of an engine run, from its step
    counts: a fused window runs each of its ``fused_len`` iterations' kernels,
    past a slot's budget too (those iterations are no-ops on the state)."""
    per = layer_launches(cfg, split)
    decode = s.decode_steps - s.fused_steps + s.fused_windows * fused_len
    chunks = s.prefill_chunks - s.fused_chunks + s.fused_mixed_windows * fused_len
    return {"page_score": s.select_steps * per["select"],
            "paged_attention": decode * per["decode"],
            "chunk_attention": chunks * per["chunk"],
            "chunk_attention_paged": chunks * per["chunk_paged"],
            "paged_attention_partial": decode * per["partial"],
            "combine_partials": 0, "flash_attention_bwd": 0}


def serve_polled(eng, reqs, what, guard=True):
    """Serve ``reqs`` a poll at a time, each poll (admission and step) under
    CUDA sync debug mode "error" unless ``guard`` is false: neither may read
    from the card. Returns (launch counts of the run, wall seconds,
    per-stripe page-load imbalance after each poll)."""
    from repro_torch.kernels import ops

    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launches()
    imb = []
    t0 = time.perf_counter()
    while eng.busy():
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            eng.poll()
        except RuntimeError as exc:  # a sync with the card raises here
            fail(f"{what} step failed: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        imb.append(page_load_imbalance(eng, eng.cfg.h2eal.page_size))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    eng.finalize()
    return got, wall, imb


def first_divergence(got, want):
    """(uid, token index) of the first token where two runs' traces differ,
    or None."""
    for u in sorted(want):
        for i, (a, b) in enumerate(zip(got[u], want[u])):
            if a != b:
                return u, i
        if len(got[u]) != len(want[u]):
            return u, min(len(got[u]), len(want[u]))
    return None


def widen_share(cfg, **kw):
    """``cfg`` with the share window widened to 4 (and other H²EAL fields)."""
    import dataclasses

    return dataclasses.replace(cfg, h2eal=dataclasses.replace(
        cfg.h2eal, share_window=4, **kw))


def check_reduced_window_engines(dev, cases=None):
    """Reduced llama3-8b with the share window widened to 4, the chunked
    Engine with churn and fused windows (decode_window=4), captured (the
    default on the card) against the same engine run eagerly on the card:
    equal tokens and launches, captures made once at construction. Against
    the CPU: f32 token for token (the fused engine on the CPU), as the
    per-step reduced engine is held; bf16 at head_dim 128 tokens equal
    except at a near-tie under BF16_LOGIT_BAND, the CPU's logits from its
    per-step engine (the windows' first tokens and steps are not kept
    apart). ``cases``: dtype -> (cfg, seed, capacity, chunk, [(prompt,
    generated)]), by default these reduced llama3-8b engines."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    cases = cases or {
        torch.float32: (widen_share(reduced(get_arch(ARCH))), 5, 96, 7,
                        [(37, 9), (20, 4), (51, 6), (9, 7), (30, 5)]),
        torch.bfloat16: (widen_share(reduced(get_arch(ARCH), head_dim=128),
                                     select_budget=320),
                         9, 320, 48, [(300, 9), (150, 6), (77, 12), (210, 5), (40, 8)]),
    }
    for dtype, (cfg, seed, capacity, chunk, shape) in cases.items():
        params = M.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                               device="cpu", dtype=dtype)
        rng = np.random.default_rng(seed)
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                        max_new=m) for i, (n, m) in enumerate(shape)]
        kw = dict(max_batch=2, capacity=capacity, prompt_buckets=[64],
                  prefill_chunk=chunk)
        card_params = _to(params, dev)
        runs = {}
        for mode in ("eager", "graphs"):
            eng = Engine(cfg, card_params, device=dev, decode_window=4,
                         eager=mode == "eager", **kw)
            sizes = eng.jit_cache_sizes()
            got, _, _ = serve_polled(eng, reqs, f"reduced {dtype} window engine ({mode})")
            want = window_launches(eng.stats, cfg, eng._fused_len, False)
            want["flash_attention"] = 0
            if got != want or eng.jit_cache_sizes() != sizes:
                fail(f"reduced {dtype} window engine ({mode}): launches {got}, expected "
                     f"{want}; captures {sizes} -> {eng.jit_cache_sizes()}")
            runs[mode] = ({u: c.tokens for u, c in eng.completions.items()}, eng.stats,
                          sizes)
            del eng
        (eager, s_e, _), (graphs, s_g, sizes) = runs["eager"], runs["graphs"]
        if graphs != eager or set(sizes.values()) != {1} or not s_g.fused_windows:
            fail(f"reduced {dtype} window engine: captured tokens differ from the eager "
                 f"engine's at {first_divergence(graphs, eager)}, or captures {sizes}, "
                 f"or no fused window ran")
        if dtype == torch.float32:
            cpu = Engine(cfg, params, device="cpu", decode_window=4, **kw).run(reqs)
            cpu = {u: c.tokens for u, c in cpu.items()}
            at, note = first_divergence(graphs, cpu), "token for token"
            ok = at is None
        else:
            cpu_eng = Engine(cfg, params, device="cpu", **kw)
            firsts, steps = record_logits(cpu_eng)
            comps = cpu_eng.run(reqs)
            cpu = {u: c.tokens for u, c in comps.items()}
            at = first_divergence(graphs, cpu)
            band = BF16_LOGIT_BAND * max(x.abs().max().item() for x in firsts.values())
            ok, note = True, f"near-tie band {band:.3e}"
            for u in sorted(cpu):  # each request up to its first divergence
                d = first_divergence({u: graphs[u]}, {u: cpu[u]})
                if d is not None:
                    comp, i = comps[u], d[1]
                    row = firsts[u] if i == 0 else steps[comp._step_idx[i - 1]][comp._slot]
                    top2 = row.topk(2).values
                    ok = ok and (top2[0] - top2[1]).item() <= band
        log(f"reduced {cfg.name} {str(dtype)[6:]} share window 4, chunks of {chunk}, "
            f"decode_window 4: captured vs eager on the card tokens equal, captures "
            f"{sizes}, {s_g.fused_windows} fused windows ({s_g.fused_steps} steps, "
            f"{s_g.fused_mixed_windows} mixed), dispatches {s_g.dispatches} "
            f"({s_g.steps_per_dispatch:.2f} decode steps a dispatch); vs the CPU "
            f"({note}): first divergence {at}")
        if not ok:
            fail(f"the reduced {dtype} window engine on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# Sampling and speculative decode
# ---------------------------------------------------------------------------


def graph_ms(timer, fn, reps: int) -> float:
    """Device time of ``fn`` replayed as a CUDA graph, as a captured engine
    step runs it: eager, a call of many small kernels would be timed as the
    host's enqueue of them (longer than the Timer's hold)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return timer.ms(graph.replay, reps)


def sampler_near_tie(logits, key, temperature, top_p, gap) -> bool:
    """Whether a draw of ``sample_tokens`` from the (V,) f32 CPU row
    ``logits`` with ``key`` sits on a near-tie: the top two of ``filtered +
    gumbel`` within ``gap``, or a probability mass before the top-p boundary
    within 1e-6 of top_p (the card's and the CPU's softmax and cumulative
    sums round otherwise)."""
    from repro_torch.serving import sampling as S

    if temperature <= 0:
        top2 = logits.topk(2).values
        return (top2[0] - top2[1]).item() < gap
    logp = torch.log_softmax(logits.float() / temperature, dim=-1)
    sp, order = torch.sort(-logp.exp(), stable=True)
    sp = -sp
    cum = torch.cumsum(sp.double(), 0) - sp.double()
    if (cum - top_p).abs().min().item() < 1e-6:
        return True
    keep = torch.zeros_like(logp, dtype=torch.bool)
    keep[order] = cum < top_p
    z = torch.where(keep, logp + S.gumbel(key, logits.shape), -math.inf)
    top2 = z.topk(2).values
    return (top2[0] - top2[1]).item() < gap


def check_sampler(timer, dev, cfg):
    """The sampler on the card against the CPU at the engine's shapes (B=4
    slots, V=128256): threefry bits equal, Gumbel values within 2 ulp of
    max(|g|, 1), tokens equal except at a near-tie (top two of filtered +
    gumbel within 1e-5, or a mass at the top-p boundary within 1e-6); then
    the device time of the decode step's sampler and of the verify chunk's
    (k = 4)."""
    from repro_torch.serving import sampling as S

    b, v = ENGINE_BATCH, cfg.vocab_size
    base = torch.stack([S.request_key(seed, u) for seed, u in
                        ((0, 0), (1, 7), (2 ** 31 - 1, 3), (3, 65535))])
    bits = S.random_bits(base, (v,))
    if not torch.equal(S.random_bits(base.to(dev), (v,)).cpu(), bits):
        fail("sampler: the threefry bits on the card differ from the CPU's")
    g_cpu = S.gumbel(base, (v,))
    g_dev = S.gumbel(base.to(dev), (v,)).cpu()
    ulp = torch.from_numpy(np.spacing(np.maximum(g_cpu.abs().numpy(), 1.0)
                                      .astype(np.float32)))
    g_ulps = ((g_dev - g_cpu).abs() / ulp).max().item()
    if g_ulps > 2:
        fail(f"sampler: Gumbel values differ by {g_ulps:.1f} ulp on the card")
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn(b, v, generator=gen) * 3
    temp = torch.tensor([0.0, 0.8, 1.0, 0.6])
    topp = torch.tensor([1.0, 0.95, 0.9, 0.5])
    gen_idx = torch.tensor([0, 5, 17, 100], dtype=torch.int32)
    args = (logits, base, gen_idx, temp, topp)
    want = S.sample_tokens(*args)
    dev_args = [x.to(dev) for x in args]
    got = S.sample_tokens(*dev_args).cpu()
    keys = S.token_key(base, gen_idx)
    ties = 0
    for r in torch.nonzero(got != want).flatten().tolist():
        if not sampler_near_tie(logits[r], keys[r], temp[r].item(), topp[r].item(), 1e-5):
            fail(f"sampler: row {r} draws {got[r].item()} on the card, "
                 f"{want[r].item()} on the CPU, without a near-tie")
        ties += 1
    chunk = [torch.randn(b, 4, v, generator=gen, device="cpu").to(dev)] + dev_args[1:]
    step_ms = graph_ms(timer, lambda: S.sample_tokens(*dev_args), 10)
    chunk_ms = graph_ms(timer, lambda: S.sample_chunk(*chunk), 10)
    eager_ms = timer.ms(lambda: S.sample_tokens(*dev_args), 10)
    log(f"sampler B={b} V={v}: card vs CPU bits equal, Gumbel within {g_ulps:.1f} ulp, "
        f"tokens equal {int((got == want).sum())}/{b} (near-ties {ties}); device time "
        f"as a captured graph: sample_tokens {step_ms:.4f} ms, sample_chunk (k=4) "
        f"{chunk_ms:.4f} ms (eager sample_tokens {eager_ms:.4f} ms, the host's enqueue)")


def verify_attention_inputs(gen, dev, cfg, dtype, capacity, k):
    """The two ``chunk_attention`` calls of a verify step at the engine's
    shapes, built as ``chunk_verify_attention`` builds them: 4 slots at
    contexts STRIPE_CTX, k chunk queries each. Retrieval: the gathered
    [sink | selected | local] pages (the selection a random choice of
    selectable pages) followed by the chunk's keys under a causal triangle,
    T = 138 pages * 32 + k; streaming: the ring (its own chunk append of
    the past) followed by the chunk's keys, T = 292 + k. Returns {kind: (q,
    k, v, valid, gather)} with ``gather`` the retrieval buffer's build."""
    from repro_torch.core import cache as cachelib
    from repro_torch.core import paging
    from repro_torch.core.hybrid_attention import _local_cap
    from repro_torch.kernels import ref

    h2 = cfg.h2eal
    nr, hs, g, d = head_split(cfg)
    p, top_k = h2.page_size, h2.top_k_pages
    b = len(STRIPE_CTX)
    c = -(-capacity // p)
    start = torch.tensor(STRIPE_CTX, dtype=torch.int32, device=dev) - 1
    pos_q = paging.chunk_positions(start, k)
    kp = torch.randn(b, nr, c, p, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(b, nr, c, p, d, generator=gen, device=dev).to(dtype)
    first = torch.arange(c, device=dev) * p
    ps = torch.where(first[None] < start[:, None], first[None], -1).to(torch.int32)
    ps = ps[:, None, :].expand(b, nr, c).contiguous()
    ok = ref.selectable_pages(ps, start + 1, sink=h2.sink, local=h2.local, page=p)
    noise = torch.rand(b, nr, c, generator=gen, device=dev)
    sel = torch.where(ok, noise, -1.0).topk(top_k, dim=-1).indices.to(torch.int32)
    kn = torch.randn(b, k, nr + hs, d, generator=gen, device=dev).to(dtype)
    vn = torch.randn(b, k, nr + hs, d, generator=gen, device=dev).to(dtype)
    tail = torch.ones(k, k, dtype=torch.bool, device=dev).tril()

    def gather():
        slots = paging.verify_attended_slots(sel, start + 1, sink=h2.sink,
                                             local=h2.local, page=p, capacity=c)
        gk, gv = ref.gather_pages(kp, vp, slots)
        valid = paging.verify_token_validity(slots, ps, start, pos_q, sink=h2.sink,
                                             local=h2.local, page=p, top_k=top_k)
        kr = torch.cat([gk, kn[:, :, :nr].transpose(1, 2)], dim=2)
        vr = torch.cat([gv, vn[:, :, :nr].transpose(1, 2)], dim=2)
        return kr, vr, torch.cat([valid, tail.expand(b, nr, k, k)], dim=3)

    kr, vr, valid_r = gather()
    ring = cachelib.make_stream_cache(b, hs, h2.sink, _local_cap(h2), d, dtype=dtype,
                                      device=dev)
    past = torch.randn(b, int(start.max()), hs, d, generator=gen, device=dev).to(dtype)
    cachelib.stream_cache_append_chunk(ring, past, past, torch.zeros_like(start), start,
                                       sink=h2.sink)
    del past
    ks = torch.cat([ring.k, kn[:, :, nr:].transpose(1, 2)], dim=2)
    vs = torch.cat([ring.v, vn[:, :, nr:].transpose(1, 2)], dim=2)
    kpos = torch.cat([ring.pos, pos_q[:, None, :].expand(b, hs, k)], dim=2)
    valid_s = paging.chunk_stream_validity(kpos, pos_q, sink=h2.sink,
                                           local=h2.local).contiguous()
    q = torch.randn(b, k, (nr + hs) * g, d, generator=gen, device=dev).to(dtype)
    return {"retrieval": (q[:, :, :nr * g].contiguous(), kr, vr, valid_r, gather),
            "streaming": (q[:, :, nr * g:].contiguous(), ks, vs, valid_s, None)}


def check_chunk_verify(ops, ref, timer, dev, cfg, dtype, gen, capacity):
    """``chunk_attention`` at the verify step's shapes, Cq = k in {1, 4, 8}
    (a one-row chunk; q tiles of 16 chunk positions reaching past Cq; odd T,
    whose validity rows take the byte reads): the retrieval heads' gathered
    buffer and the streaming heads' ring, each against its plain version;
    timed with its bound and SDPA on the same inputs, and the retrieval
    heads' gather + kernel as the verify step runs them."""
    out_cases = []
    g = head_split(cfg)[2]
    for k in (1, 4, 8):
        for kind, (q, kb, vb, valid, gather) in verify_attention_inputs(
                gen, dev, cfg, dtype, capacity, k).items():
            run = lambda: ops.chunk_attention(q, kb, vb, valid)
            out = run()
            want = ref.chunk_attention_ref(*widened(q, kb, vb), valid)
            torch.cuda.synchronize()
            e, ex, tol = err(out, want), excess(out, want, dtype), tol_text(dtype)
            if dtype == torch.bfloat16:
                p_term = ref.chunk_attention_ref(*widened(q, kb, vb.abs()), valid)
                ex, tol = p_excess(out, want, p_term), P_TOL_TEXT
            lib_mask = valid.repeat_interleave(g, dim=1)
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), kb, vb, attn_mask=lib_mask, enable_gqa=True)
            # the bytes this run needs: q, the K/V rows of valid keys, the
            # mask, the output
            keys = int(valid.any(dim=2).sum().item())
            byte_count = (nbytes(q, valid, out)
                          + 2 * keys * kb.shape[-1] * kb.element_size())
            b_ms, b_by = bound(byte_count, 4 * kb.shape[-1] * g * int(valid.sum().item()),
                               dtype)
            case = dict(
                case=f"verify {kind} k={k} B={q.shape[0]} Hq={q.shape[2]} "
                     f"Hkv={kb.shape[1]} T={kb.shape[2]} D={q.shape[3]}",
                dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex, tol=tol,
                ms=timer.ms(run, 10), plain_ms=timer.ms(
                    lambda: ref.chunk_attention_ref(q, kb, vb, valid), 3),
                library_ms=timer.ms(lib, 10), bound_ms=b_ms, bound_by=b_by, main=False)
            if gather is not None:  # its eager ops replayed as a graph, as in a step
                case["unfused_ms"] = graph_ms(
                    timer, lambda: ops.chunk_attention(q, *gather()), 10)
            out_cases.append(case)
            torch.cuda.empty_cache()
    return out_cases


def spec_launches(s, n_l, k, streaming):
    """The kernels' launches of a speculative engine run from its step
    counts: a verify step scores pages once (one page_select, need-gated)
    and runs two chunk_attention a layer; a streaming draft k-1 reuse decode
    steps; a prefill chunk one chunk_attention and one chunk_attention_paged
    a layer."""
    draft = (k - 1) * s.spec_steps if streaming else 0
    return {"flash_attention": 0, "page_score": s.spec_steps * n_l,
            "paged_attention": 2 * draft * n_l,
            "chunk_attention": (2 * s.spec_steps + s.prefill_chunks) * n_l,
            "chunk_attention_paged": s.prefill_chunks * n_l,
            "paged_attention_partial": 0,
            "combine_partials": 0, "flash_attention_bwd": 0}


# lockstep replays already made: (params, config, capacity, prompt, tokens)
# -> logit rows. Phase 15 holds several layouts' traces to one reference,
# whose near-ties would otherwise be replayed once a layout
_LOCKSTEP: dict = {}


def lockstep_logits(cfg, params, prompt, tokens, capacity, dev):
    """The logits behind each of ``tokens`` for one request, replayed alone
    through the lockstep steps fed ``tokens`` (the prefill's first, then a
    decode step a token): a slot's trace depends on its own request alone.
    A replay of the same request and tokens is made once."""
    key = (id(params), cfg, capacity, tuple(int(t) for t in prompt),
           tuple(int(t) for t in tokens))
    if key not in _LOCKSTEP:
        _LOCKSTEP[key] = _lockstep_logits(cfg, params, prompt, tokens, capacity, dev)
    return _LOCKSTEP[key]


def _lockstep_logits(cfg, params, prompt, tokens, capacity, dev):
    from repro_torch.runtime import serve as serve_rt

    scfg = serve_rt.ServeConfig(capacity=capacity)
    prefill = serve_rt.make_prefill(cfg, scfg)
    steps = [serve_rt.make_decode_step(cfg, scfg, do_select=sel) for sel in (False, True)]
    w = max(cfg.h2eal.share_window, 1)
    with torch.inference_mode():
        logits, state = prefill(params, torch.as_tensor(prompt, device=dev)[None].long())
        rows = [logits[0].float().cpu()]
        for i, t in enumerate(tokens[:-1]):
            tok = torch.full((1,), int(t), dtype=torch.int32, device=dev)
            logits, state = steps[i % w == 0](params, state, tok)
            rows.append(logits[0].float().cpu())
    return rows


def check_ties(cfg, params, reqs, got, want, sampling, capacity, dev, band, what,
               relative=False):
    """``got`` against ``want`` token for token, except at each request's
    first divergence where the logits behind ``want`` (a lockstep replay)
    hold a near-tie within ``band`` (times the row's largest |logit| if
    ``relative``; divided by the temperature when sampling). Returns the
    number of such divergences."""
    from repro_torch.serving import sampling as S

    prompts = {r.uid: r.prompt for r in reqs}
    ties = 0
    for u in sorted(want):
        d = first_divergence({u: got[u]}, {u: want[u]})
        if d is None:
            continue
        i = d[1]
        if len(got[u]) != len(want[u]) or i >= len(want[u]):
            fail(f"{what}: request {u} gave {len(got[u])} tokens, expected {len(want[u])}")
        row = lockstep_logits(cfg, params, prompts[u], want[u], capacity, dev)[i]
        t = sampling.get("temperature", 0.0)
        key = S.token_key(S.request_key(sampling.get("seed", 0), u), i)
        scale = band * row.abs().max().item() if relative else band
        band_u = scale / t if t > 0 else scale
        if not sampler_near_tie(row, key, t, sampling.get("top_p", 1.0), band_u):
            fail(f"{what}: request {u} token {i} differs ({got[u][i]} vs {want[u][i]}) "
                 f"without a near-tie")
        top2 = row.topk(2).values
        log(f"{what}: request {u} first differs at token {i}, a near-tie (top-2 logit gap "
            f"{(top2[0] - top2[1]).item():.3e}, band {band_u:.3e})")
        ties += 1
    return ties


def check_reduced_spec_engines(dev):
    """Reduced llama3-8b (f32), the chunked Engine with churn and
    speculative decode (k = 4, the n-gram draft), captured on the card,
    against the same engine on the CPU, on both layouts (coplace_shmap over
    4 stripes, balanced admission), greedy and sampled (temperature 0.8,
    top_p 0.95, seed 1): tokens equal except at a first divergence whose
    logits hold a near-tie within 2e-4 (EXPERIMENTS.md's band; over the
    temperature when sampling); captures made once at construction."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    cfg = reduced(get_arch(ARCH))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(15), device="cpu")
    card_params = _to(params, dev)
    rng = np.random.default_rng(15)
    shape = [(37, 9), (20, 4), (51, 6), (9, 7), (30, 5)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n, _ in shape]
    kw = dict(max_batch=2, capacity=96, prompt_buckets=[64], prefill_chunk=7,
              spec_tokens=SPEC_K)
    for layout in ("default", "coplace_shmap"):
        lkw = dict(kw, layout=layout, shards=4, admission="balanced") \
            if layout != "default" else kw
        for sampling in ({}, SPEC_SAMPLING):
            reqs = [Request(uid=i, prompt=p, max_new=m, **sampling)
                    for i, (p, (_, m)) in enumerate(zip(prompts, shape))]
            cpu = Engine(cfg, params, device="cpu", **lkw).run(reqs)
            eng = Engine(cfg, card_params, device=dev, **lkw)
            sizes = eng.jit_cache_sizes()
            card = eng.run(reqs)
            got = {u: c.tokens for u, c in card.items()}
            want = {u: c.tokens for u, c in cpu.items()}
            what = f"reduced spec engine ({layout}, {sampling or 'greedy'})"
            if set(sizes.values()) != {1} or eng.jit_cache_sizes() != sizes:
                fail(f"{what}: captures {sizes} -> {eng.jit_cache_sizes()}")
            ties = check_ties(cfg, params, reqs, got, want, sampling, lkw["capacity"] + 8,
                              "cpu", 2e-4, what)
            log(f"{what}: card vs CPU tokens equal {got == want} (near-tie divergences "
                f"{ties}), verify steps {eng.stats.spec_steps}, mean accepted length "
                f"{eng.stats.mean_accepted_len:.3f}, captures {sizes}")
            del eng


class ReplayTimes:
    """Device time of every replay of a StepGraphs' steps, by CUDA events
    recorded around each replay (read once the run has synchronised)."""

    def __init__(self, step_graphs):
        self.events = {}
        run = step_graphs.run

        def timed(name):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = run(name)
            b.record()
            self.events.setdefault(name, []).append((a, b))
            return out
        step_graphs.run = timed

    def median_ms(self):
        return {n: float(np.median([a.elapsed_time(b) for a, b in ev]))
                for n, ev in self.events.items()}


def serve_spec_engines(dev, cfg, params, greedy):
    """The chunked, captured Engine at full width with speculative decode (k
    = SPEC_K) on the engine workload, three drafts: ReplayDraft of the
    non-speculative captured run's trace ``greedy`` (all-accept up to the
    share-window clamps), NgramDraft, and StreamingDraft; then sampled
    (temperature 0.8, top_p 0.95, seed 1), speculative (n-gram) against the
    per-step captured engine. Tokens equal the non-speculative engine's,
    except at a first divergence whose logits hold a near-tie within
    BF16_LOGIT_BAND of the row's largest logit (bf16 at full width: the
    verify chunk attends through chunk_attention, the decode step through
    paged_attention); the sampled trace differs from the greedy one;
    launches exact and captures made once at construction. Logs tokens/s,
    mean accepted length, dispatches and the median device time of the
    verify step, the draft's two steps and a decode step. The verify step
    reads the accepted counts back once, so these polls run without the
    sync guard. Returns the launch counts of each run."""
    import dataclasses

    from repro_torch.serving.draft import ReplayDraft
    from repro_torch.serving.engine import Engine

    reqs, capacity = engine_workload(cfg)
    lens = sorted(set(len(r.prompt) for r in reqs))
    sampled = [dataclasses.replace(r, **SPEC_SAMPLING) for r in reqs]
    base = dict(max_batch=ENGINE_BATCH, capacity=capacity, prompt_buckets=lens,
                prefill_chunk=ENGINE_CHUNK, device=dev)
    n_l = cfg.num_layers
    launches, traces, rates = {}, {}, {}
    runs = (("replay", dict(spec_tokens=SPEC_K, draft=ReplayDraft(greedy)), reqs),
            ("ngram", dict(spec_tokens=SPEC_K, draft="ngram"), reqs),
            ("streaming", dict(spec_tokens=SPEC_K, draft="streaming"), reqs),
            ("sampled", dict(spec_tokens=SPEC_K, draft="ngram"), sampled),
            ("sampled_nonspec", dict(), sampled))
    for name, kw, rs in runs:
        t0 = time.perf_counter()
        eng = Engine(cfg, params, **base, **kw)
        t_build = time.perf_counter() - t0
        sizes = eng.jit_cache_sizes()
        times = ReplayTimes(eng._graphs)
        draft_times = ReplayTimes(eng.draft._graphs) if name == "streaming" else None
        got, wall, _ = serve_polled(eng, rs, f"engine (spec {name})", guard=False)
        s = eng.stats
        expect = (spec_launches(s, n_l, SPEC_K, name == "streaming") if kw
                  else dict(window_launches(s, cfg, 0, False), flash_attention=0))
        if got != expect:
            fail(f"engine (spec {name}): launches {got}, expected {expect}")
        if eng.jit_cache_sizes() != sizes or set(sizes.values()) != {1}:
            fail(f"engine (spec {name}): captures {sizes} -> {eng.jit_cache_sizes()}")
        traces[name] = {u: c.tokens for u, c in eng.completions.items()}
        for r in rs:
            if len(traces[name].get(r.uid, [])) != r.max_new:
                fail(f"engine (spec {name}): request {r.uid} gave the wrong token count")
        med = times.median_ms()
        if draft_times is not None:
            med.update({f"draft_{n}": t for n, t in draft_times.median_ms().items()})
        rates[name] = s.tokens_out / wall
        launches["engine_sampled_graphs" if name == "sampled_nonspec"
                 else f"engine_spec_{name}"] = got
        log(f"engine (spec {name}): {s.tokens_out} tokens in {wall:.3f}s = "
            f"{rates[name]:.2f} tok/s ({s.decode_steps / wall:.2f} decode steps/s); verify steps "
            f"{s.spec_steps}, mean accepted length {s.mean_accepted_len:.3f} "
            f"(drafted {s.spec_drafted}, accepted {s.spec_accepted}), dispatches "
            f"{s.dispatches}, median device ms per replay "
            f"{ {n: round(t, 4) for n, t in med.items()} }, captures {sizes}, "
            f"construction {t_build:.2f}s")
        del eng, times, draft_times
        torch.cuda.empty_cache()
    ties = {name: check_ties(cfg, params, reqs, traces[name], greedy, {}, capacity, dev,
                             BF16_LOGIT_BAND, f"engine (spec {name})", relative=True)
            for name in ("replay", "ngram", "streaming")}
    ties["sampled"] = check_ties(cfg, params, sampled, traces["sampled"],
                                 traces["sampled_nonspec"], SPEC_SAMPLING, capacity, dev,
                                 BF16_LOGIT_BAND, "engine (spec sampled)", relative=True)
    if traces["sampled_nonspec"] == greedy:
        fail("engine (spec sampled): the sampled trace equals the greedy one")
    log(f"engine (spec): near-tie divergences against the non-speculative captured "
        f"engine {ties}; tok/s {({n: round(r, 2) for n, r in rates.items()})}")
    return launches


def full_params(dev, cfg):
    from repro_torch.models import model as M

    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, generator=gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {n_params / 1e9:.2f}B params, init {time.perf_counter() - t0:.1f}s")
    return params


def serve_full(dev, cfg, params, prompt=PROMPT):
    """Lockstep ``generate`` at full width: BATCH prompts of ``prompt``
    tokens, GEN greedy tokens, hybrid sparse attention with the launch
    counts checked exactly, then full attention for token agreement."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate

    capacity = prompt + GEN + cfg.h2eal.page_size
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, prompt), generator=gen,
                            device=dev)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    toks, stats = generate(cfg, params, prompts, gen=GEN, capacity=capacity, device=dev)
    launches = dict(ops.LAUNCHES)
    n_sel = -(-GEN // cfg.h2eal.share_window)
    per = layer_launches(cfg)
    expect = {"flash_attention": per["prefill"], "page_score": per["select"] * n_sel,
              "paged_attention": per["decode"] * GEN,
              "chunk_attention": 0, "chunk_attention_paged": 0,
              "paged_attention_partial": 0, "combine_partials": 0,
              "flash_attention_bwd": 0}
    log(f"generate ({cfg.name}): sparse run launches {launches} (expected {expect})")
    if launches != expect:
        fail("the serving path did not launch the kernels as expected")
    logits = stats["last_logits"]
    if tuple(toks.shape) != (BATCH, GEN) or not bool(torch.isfinite(logits).all()):
        fail("sparse generate produced a wrong shape or non-finite logits")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail("sparse generate produced out-of-range tokens")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"generate ({cfg.name}) B={BATCH} S={prompt} capacity {capacity}: sparse prefill "
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


def serve_engine(dev, cfg, params, label="", modes=None):
    """The continuous-batching Engine at full width, run eagerly: chunked
    prefill, then prefill-then-pack on the same requests, then the chunked
    coplace_shmap engine over SHARDS stripes with balanced admission; then
    the chunked default and coplace_shmap engines with their steps replayed
    as the CUDA graphs captured at construction and fused decode windows
    (decode_window=4). Returns the launch counts of each run, and the
    tokens and tok/s of the captured default engine. Each captured
    engine's tokens must equal its eager run's (the same kernels on the same
    inputs). ``label`` tags the log lines (another model than phase 5's);
    ``modes`` runs those engines instead, among them ``chunked_windows``,
    the chunked engine with fused windows run eagerly."""
    from repro_torch.serving.engine import Engine

    reqs, capacity = engine_workload(cfg)
    lens = [len(r.prompt) for r in reqs]
    log(f"engine{label}: {len(reqs)} requests on {ENGINE_BATCH} slots, prompts {lens}, "
        f"generations {[r.max_new for r in reqs]}, capacity {capacity}")
    out, launches, rates = {}, {}, {}
    coplace = dict(layout="coplace_shmap", shards=SHARDS, admission="balanced")
    graphs = dict(decode_window=ENGINE_WINDOW, eager=False)
    modes = modes or ("chunked", "packed", "coplace", "chunked_graphs", "coplace_graphs")
    for mode, chunk, kw in (
            ("chunked", ENGINE_CHUNK, dict(eager=True)),
            ("packed", None, dict(eager=True)),
            ("coplace", ENGINE_CHUNK, dict(coplace, eager=True)),
            ("chunked_windows", ENGINE_CHUNK, dict(graphs, eager=True)),
            ("chunked_graphs", ENGINE_CHUNK, graphs),
            ("coplace_graphs", ENGINE_CHUNK, dict(coplace, **graphs))):
        if mode not in modes:
            continue
        t0 = time.perf_counter()
        eng = Engine(cfg, params, max_batch=ENGINE_BATCH, capacity=capacity,
                     prompt_buckets=sorted(set(lens)), prefill_chunk=chunk, device=dev,
                     **kw)
        t_build = time.perf_counter() - t0
        sizes = eng.jit_cache_sizes()
        torch.cuda.reset_peak_memory_stats()
        # chunked: admission and step, neither may read from the card
        got, wall, imb = serve_polled(eng, reqs, f"engine{label} ({mode})",
                                      guard=bool(chunk))
        launches[mode] = got
        s = eng.stats
        split = "coplace" in mode  # retrieval heads: one launch, merged in it
        expect = dict(window_launches(s, cfg, eng._fused_len, split),
                      flash_attention=0 if chunk else
                      layer_launches(cfg)["prefill"] * len(reqs))
        log(f"engine{label} ({mode}) launches {got} (expected {expect})")
        if got != expect:
            fail(f"the engine{label} ({mode}) did not launch the kernels as expected")
        if eng.jit_cache_sizes() != sizes:
            fail(f"the engine{label} ({mode}) captured again while serving: {sizes} -> "
                 f"{eng.jit_cache_sizes()}")
        comps = eng.completions
        for r in reqs:
            t = comps[r.uid].tokens if r.uid in comps else []
            if len(t) != r.max_new or not all(0 <= x < cfg.vocab_size for x in t):
                fail(f"engine{label} ({mode}): request {r.uid} gave {len(t)} tokens, "
                     f"expected {r.max_new} in range")
        peak = torch.cuda.max_memory_allocated() / 2**30
        first = {u: comps[u].first_token_step for u in sorted(comps)}
        log(f"engine{label} ({mode}): {s.tokens_out} tokens in {wall:.3f}s = "
            f"{s.tokens_out / wall:.2f} tok/s; engine steps {s.engine_steps}, "
            f"prefill-chunk steps {s.prefill_chunks}, decode steps {s.decode_steps} "
            f"(select {s.select_steps} / reuse {s.reuse_steps}), mean occupancy "
            f"{s.occupancy:.3f}, first-token step per request {first}, peak memory "
            f"{peak:.1f} GiB; admission reorders {s.admission_reorders}, per-stripe "
            f"page-load imbalance over {SHARDS} stripes mean {np.mean(imb):.4f} max "
            f"{np.max(imb):.4f} (cache capacity {eng.cache_capacity})")
        log(f"engine{label} ({mode}) dispatch: {s.dispatches} dispatches, "
            f"{s.steps_per_dispatch:.3f} decode steps a dispatch, {s.fused_windows} "
            f"fused windows ({s.fused_steps} steps, {s.fused_mixed_windows} mixed), graph "
            f"replays {eng.graph_replays()}, captures before/after the run {sizes} / "
            f"{eng.jit_cache_sizes()}, construction {t_build:.2f}s")
        out[mode] = {u: c.tokens for u, c in comps.items()}
        rates[mode] = s.tokens_out / wall
        del eng
        torch.cuda.empty_cache()
    for a, b, what in (("chunked", "packed", " (random weights: near-flat logits, so "
                        "a reassociated sum can flip a token)"),
                       ("chunked", "coplace", ""),
                       ("chunked_graphs", "chunked", " (same kernels, captured and fused "
                        "against eager and per-step)"),
                       ("chunked_graphs", "chunked_windows", " (same kernels and fused "
                        "windows, captured against eager)"),
                       ("coplace_graphs", "coplace", "")):
        if a not in out or b not in out:
            continue
        pairs = [(x, y) for u in out[a] for x, y in zip(out[a][u], out[b][u])]
        agree = sum(x == y for x, y in pairs) / len(pairs)
        log(f"engine{label}: token agreement {a} vs {b} {agree:.3f}{what}")
        if a.endswith("_graphs") and out[a] != out[b]:
            fail(f"engine{label} ({a}): tokens differ from the eager run's at "
                 f"{first_divergence(out[a], out[b])}")
    return launches, out["chunked_graphs"], rates["chunked_graphs"]


def tiered_launches(s, cfg, fused_len, replays):
    """The launches of a tiered run: a plain run's, and each replay of a
    select step launches that step's kernels again."""
    per = layer_launches(cfg)
    out = dict(window_launches(s, cfg, fused_len, False), flash_attention=0)
    out["page_score"] += replays * per["select"]
    out["paged_attention"] += replays * per["decode"]
    return out


def serve_tiered_and_rebalanced(dev, cfg, params, want, base_rate, card):
    """Phase 9: the captured chunked engine of phase 7 with tiered residency
    (one request forced cold), then with retire-triggered rebalancing, each
    held to phase 7's tokens ``want``. Returns the launch counts of each."""
    from repro_torch import hbsim
    from repro_torch.kernels import ops
    from repro_torch.runtime import perfmodel
    from repro_torch.serving.engine import Engine

    reqs, capacity = engine_workload(cfg)
    kw = dict(max_batch=ENGINE_BATCH, capacity=capacity,
              prompt_buckets=sorted({len(r.prompt) for r in reqs}),
              prefill_chunk=ENGINE_CHUNK, decode_window=ENGINE_WINDOW, device=dev)
    launches = {}

    # tiered: polled without the sync guard, since each select step reads
    # its digest back (one read a select step, as the JAX engine)
    eng = Engine(cfg, params, hot_pages=TIER_HOT_PAGES, **kw)
    sizes = eng.jit_cache_sizes()
    # the pages a select step pins: the union of its 32 layers x 4 heads'
    # selections, per slot that selected
    unions, digest = [], eng._tier_digest

    def counted(*args):
        sel_by, hot_by = digest(*args)
        unions.extend(len(v) for v in sel_by.values())
        return sel_by, hot_by
    eng._tier_digest = counted
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launches()
    forced, w = None, eng.share_window
    t0 = time.perf_counter()
    while eng.busy():
        b = eng.batch
        if forced is None and eng.stats.decode_steps >= TIER_FORCE_AFTER:
            due = [i for i in range(b.max_batch) if b.active[i] and b.phase[i] % w == 0
                   and b.remaining[i] > w]
            if due:
                forced = (int(b.uid[due[0]]), eng.tier_force_spill(int(b.uid[due[0]])))
        eng.poll()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["tiered"] = got = dict(ops.LAUNCHES)
    eng.finalize()
    s, t = eng.stats, eng._tier
    replays = eng.graph_replays()["decode_select"] - s.select_steps
    expect = tiered_launches(s, cfg, eng._fused_len, replays)
    log(f"engine (tiered) launches {got} (expected {expect}; {replays} select-step "
        f"replays)")
    if got != expect:
        fail("the tiered engine did not launch the kernels as expected")
    tokens = {u: c.tokens for u, c in eng.completions.items()}
    bad = first_divergence(tokens, want)
    if bad is not None:
        fail(f"the tiered engine's tokens differ from the all-resident captured "
             f"engine's at (uid, index) {bad}")
    if forced is None or forced[1] == 0:
        fail(f"the tiered engine forced no page cold ({forced})")
    if not s.tier_misses == s.tier_fills > 0:
        fail(f"tier misses {s.tier_misses} and fills {s.tier_fills}: each miss must "
             f"be filled, and there must be one")
    if not s.tier_spills > 0:
        fail(f"the tiered engine spilled no page ({s.tier_spills})")
    if eng.jit_cache_sizes() != sizes:
        fail(f"the tiered engine captured again while serving: {sizes} -> "
             f"{eng.jit_cache_sizes()}")
    page = perfmodel.tier_page_bytes(cfg)
    model = perfmodel.tier_traffic_bytes(cfg, fills=s.tier_fills, spills=s.tier_spills,
                                         prefetch=s.tier_prefetch)
    # a page's first spill copies it to host; later spills reuse that copy
    moved_model = model["demand_fills"] + model["prefetch"] + s.tier_archived * page
    if t.h2d_bytes != model["demand_fills"] + model["prefetch"] or \
            t.d2h_bytes != s.tier_archived * page:
        fail(f"the far store moved {t.h2d_bytes} B to the card and {t.d2h_bytes} B to "
             f"host; the byte model of the counters says "
             f"{model['demand_fills'] + model['prefetch']} and "
             f"{s.tier_archived * page}")
    times = t.transfer_times()
    rate = {d: b / (ms * 1e-3) / 1e9 for d, (b, ms) in times.items()}
    log(f"engine (tiered, hot_pages={TIER_HOT_PAGES}, uid {forced[0]} forced cold: "
        f"{forced[1]} pages) on {card}: {s.tokens_out} tokens in {wall:.3f}s = "
        f"{s.tokens_out / wall:.2f} tok/s (all-resident captured engine "
        f"{base_rate:.2f}); tokens equal the all-resident engine's; hits "
        f"{s.tier_hits} misses {s.tier_misses} (hit rate {s.tier_hit_rate:.4f}) fills "
        f"{s.tier_fills} prefetches {s.tier_prefetch} spills {s.tier_spills} (first "
        f"spills copied {s.tier_archived}); batches fill {s.tier_fill_batches} "
        f"(mean {s.tier_fill_batch_mean:.1f} pages) spill {s.tier_spill_batches} "
        f"(mean {s.tier_spill_batch_mean:.1f}) gather {s.tier_gather_batches}, "
        f"largest {s.tier_batch_pages_max}; pages a select step pins (the union of "
        f"its layers' and heads' selections, a slot) mean {np.mean(unions):.1f} min "
        f"{min(unions)} max {max(unions)} over {len(unions)}; captures "
        f"{eng.jit_cache_sizes()}")
    log(f"engine (tiered) far-store copies on {card}: to the card "
        f"{t.h2d_bytes} B, to host {t.d2h_bytes} B (byte model of the counters: "
        f"{moved_model} B moved; {model['total']:.0f} B with every spill counted); "
        + ", ".join(f"{d} {b} B in {ms:.3f} ms = {rate[d]:.2f} GB/s"
                    for d, (b, ms) in sorted(times.items())))
    steps = s.decode_steps
    proj = hbsim.tiered_serving_overhead(cfg, fills=s.tier_fills, spills=s.tier_spills,
                                         prefetch=s.tier_prefetch, decode_steps=steps)
    log(f"engine (tiered): hbsim MODEL projection for the paper's HB accelerator "
        f"(not measured on any device): far-bank bytes {proj['far_bytes']:.0f}, "
        f"blocking {proj['blocking_s'] * 1e3:.3f} ms "
        f"({proj['blocking_s_per_step'] * 1e6:.2f} us a decode step over {steps}), "
        f"overlapped {proj['overlapped_s'] * 1e3:.3f} ms, energy "
        f"{proj['energy_j'] * 1e3:.3f} mJ")
    del eng
    torch.cuda.empty_cache()

    # rebalanced: at the default two banks of two slots the retirements of
    # this workload (seeded, engine_workload) leave bank 1 lighter, and the
    # planner moves one slot (a CPU run of the same schedule: 1 migration)
    eng = Engine(cfg, params, rebalance="retire", **kw)
    sizes = eng.jit_cache_sizes()
    got, wall, _ = serve_polled(eng, reqs, "engine (rebalanced)")
    launches["rebalanced"] = got
    s = eng.stats
    expect = dict(window_launches(s, cfg, eng._fused_len, False), flash_attention=0)
    log(f"engine (rebalanced) launches {got} (expected {expect})")
    if got != expect:
        fail("the rebalanced engine did not launch the kernels as expected")
    tokens = {u: c.tokens for u, c in eng.completions.items()}
    bad = first_divergence(tokens, want)
    if bad is not None:
        fail(f"the rebalanced engine's tokens differ from rebalance='off' at "
             f"(uid, index) {bad}")
    if s.migrations <= 0:
        fail("the rebalanced engine migrated no slot")
    if not s.imbalance_post < s.imbalance_pre:
        fail(f"rebalancing did not lower the imbalance: {s.imbalance_pre} -> "
             f"{s.imbalance_post}")
    if sizes.get("migrate") != 1 or eng.jit_cache_sizes() != sizes:
        fail(f"migrate must be captured once, at construction: {sizes} -> "
             f"{eng.jit_cache_sizes()}")
    log(f"engine (rebalanced, retire, {eng.rebalance_banks} banks) on {card}: "
        f"{s.tokens_out} tokens in {wall:.3f}s = {s.tokens_out / wall:.2f} tok/s "
        f"(rebalance off {base_rate:.2f}); tokens equal rebalance off's; checks "
        f"{s.rebalance_checks} applied {s.rebalances} skipped {s.rebalance_skipped} "
        f"migrations {s.migrations} ({s.migrated_tokens} tokens), cost imbalance "
        f"{s.imbalance_pre:.4f} -> {s.imbalance_post:.4f}; captures {sizes}")
    proj = hbsim.rebalance_overhead(cfg, migrations=s.migrations,
                                    migrated_tokens=s.migrated_tokens,
                                    decode_steps=s.decode_steps)
    log(f"engine (rebalanced): hbsim MODEL projection for the paper's HB "
        f"accelerator (not measured on any device): migration bytes "
        f"{proj['migration_bytes']:.0f}, NoC transfer {proj['transfer_s'] * 1e3:.3f} ms "
        f"({proj['transfer_s_per_step'] * 1e6:.2f} us a decode step), energy "
        f"{proj['energy_j'] * 1e3:.3f} mJ")
    del eng
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# gemma3-1b: head_dim 256 in phase 2, and phase 10
# ---------------------------------------------------------------------------


def check_window_decode(ops, ref, timer, dev, cfg, dtype, gen, prompt, batch=BATCH,
                        what="window layer"):
    """paged_attention as a sliding-window layer's decode step runs it
    (``full_decode_attention``): ``batch`` slots at context prompt + 1, each
    kv head over its whole full cache (prompt + GEN + one page), the last
    ``local_window`` positions valid (every position up to the context
    where the config has no window: a layer with H²EAL off)."""
    hkv, d, w = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.local_window
    g = cfg.num_heads // hkv
    t, ctx = prompt + GEN + cfg.h2eal.page_size, prompt + 1
    q = torch.randn(batch, hkv * g, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(batch, hkv, t, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(batch, hkv, t, d, generator=gen, device=dev).to(dtype)
    pos = torch.arange(t, device=dev)
    valid = ((pos < ctx) & ((pos > ctx - 1 - w) if w else True)).expand(
        batch, hkv, t).contiguous()
    run = lambda: ops.paged_attention(q, k, v, valid)
    plain = lambda: ref.paged_attention_ref(q, k, v, valid)
    out, want = run(), ref.paged_attention_ref(*widened(q, k, v), valid)
    torch.cuda.synchronize()
    e, ex = err(out, want), excess(out, want, dtype)
    mask = valid.repeat_interleave(g, dim=1)[:, :, None, :]
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
    n_valid = int(valid.sum().item())
    b_ms, b_by = bound(nbytes(q, valid, out) + 2 * n_valid * d * k.element_size(),
                       4 * d * g * n_valid, dtype)
    return dict(
        case=f"{what} decode over its full cache B={batch} Hq={hkv * g} Hkv={hkv} "
             f"T={t} D={d} window={w or 'none'}",
        dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex, tol=tol_text(dtype),
        ms=timer.ms(run, 20), plain_ms=timer.ms(plain, 20), library_ms=timer.ms(lib, 20),
        bound_ms=b_ms, bound_by=b_by)


def check_window_chunk(ops, ref, timer, dev, cfg, dtype, gen, capacity,
                       starts=CHUNK_STARTS, what="window layer"):
    """chunk_attention as a sliding-window layer's chunk step runs it (the
    full-cache branch of ``block_prefill_chunk``, ``full_chunk_attention``):
    the slots' chunks of ENGINE_CHUNK tokens at ``starts``, already
    appended, over the whole full cache of ``capacity`` keys, each query's
    window valid (every earlier key where the config has no window)."""
    from repro_torch.core import paging

    hkv, d, w = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.local_window
    g = cfg.num_heads // hkv
    b, cq = len(starts), ENGINE_CHUNK
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    q = torch.randn(b, cq, hkv * g, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, hkv, capacity, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, hkv, capacity, d, generator=gen, device=dev).to(dtype)
    pos_q = paging.chunk_positions(start, cq)[:, None, :, None]
    key_pos = torch.arange(capacity, device=dev)
    valid = ((key_pos <= pos_q) & ((key_pos > pos_q - w) if w else True)).expand(
        b, hkv, cq, capacity).contiguous()
    run = lambda: ops.chunk_attention(q, k, v, valid)
    plain = lambda: ref.chunk_attention_ref(q, k, v, valid)
    out, want = run(), ref.chunk_attention_ref(*widened(q, k, v), valid)
    torch.cuda.synchronize()
    e, ex, tol = err(out, want), excess(out, want, dtype), tol_text(dtype)
    if dtype == torch.bfloat16:
        p_term = ref.chunk_attention_ref(*widened(q, k, v.abs()), valid)
        ex, tol = p_excess(out, want, p_term), P_TOL_TEXT
        del p_term
    del want
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=valid.repeat_interleave(g, dim=1),
        enable_gqa=True)
    n_valid = int(valid.sum().item())
    touched = sum(min(st, w - 1 if w else st) + cq for st in starts)  # keys a query attends
    b_ms, b_by = bound(nbytes(q, valid, out) + 2 * touched * hkv * d * k.element_size(),
                       4 * d * g * n_valid, dtype)
    return dict(
        case=f"{what} chunk over its full cache B={b} Cq={cq} Hq={hkv * g} "
             f"Hkv={hkv} T={capacity} D={d} window={w or 'none'} starts={list(starts)}",
        dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex, tol=tol,
        ms=timer.ms(run, 10), plain_ms=timer.ms(plain, 3), library_ms=timer.ms(lib, 10),
        bound_ms=b_ms, bound_by=b_by)


def check_head_dim_256(ops, ref, timer, dev, dtype, gen):
    """Phase 2 at gemma3-1b's shapes (head_dim 256; one kv head, group 4; a
    global layer's H²EAL retrieval head has no streaming partner): flash
    over B=BATCH prompts of G3_PROMPT, global and window 512 (no sink);
    the select step at the engine's shape; a window layer's decode over its
    full cache and a global layer's retrieval pages read in place (lockstep);
    a window layer's chunk over its full cache and a global layer's chunk
    over its pages (the engine's chunk phase). Cases are tagged with the
    model and are not part of the main totals."""
    from repro_torch.configs import get_arch

    cfg = get_arch(G3_ARCH)
    hkv = cfg.num_kv_heads
    lock_cap = G3_PROMPT + GEN + cfg.h2eal.page_size
    eng_cap = engine_workload(cfg)[1]
    res = {
        "flash_attention": check_flash(
            ops, ref, timer, dev, cfg, dtype, gen, prompt=G3_PROMPT,
            heads_cases=(("global layer", hkv, 0, 0),
                         ("window layer", hkv, cfg.local_window, 0))),
        "page_score": [check_page_select(ops, ref, timer, dev, cfg, dtype, gen, "engine")],
        "paged_attention": [
            check_window_decode(ops, ref, timer, dev, cfg, dtype, gen, G3_PROMPT),
            check_paged_pages(ops, ref, timer, dev, cfg, dtype, gen, lock_cap,
                              prompt=G3_PROMPT)],
        "chunk_attention": [check_window_chunk(ops, ref, timer, dev, cfg, dtype, gen,
                                               eng_cap)],
        "chunk_attention_paged": check_chunk_paged(ops, ref, timer, dev, cfg, dtype, gen,
                                                   eng_cap),
    }
    for cases in res.values():
        for c in cases:
            c.update(case=f"{cfg.name} {c['case']}", main=False, arch=cfg.name)
    torch.cuda.empty_cache()
    return res


def check_reduced_gemma3_against_cpu(dev):
    """Phase 10a: reduced gemma3-1b with 8 layers (one period of 5 window
    layers and a global one, then 2 window layers), card against CPU: f32
    generate (head_dim 32, prompts longer than the window of 64) token for
    token; bf16 generate at head_dim 256 (the D = 256 kernels) within the
    bf16 band; the chunked engine with churn, captured with fused windows
    (decode_window=4), against its eager run and the CPU, f32 and bf16."""
    from repro_torch.configs import get_arch, reduced

    g3 = get_arch(G3_ARCH)
    f32_cfg = reduced(g3, num_layers=8)
    bf16_cfg = reduced(g3, num_layers=8, head_dim=256)
    check_reduced_against_cpu(dev, f32_cfg, prompt_len=100)
    bf16_generate_against_cpu(dev, bf16_cfg)
    check_reduced_window_engines(dev, {
        torch.float32: (widen_share(f32_cfg), 5, 144, 7,
                        [(90, 9), (40, 4), (120, 6), (20, 7), (70, 5)]),
        torch.bfloat16: (widen_share(bf16_cfg, select_budget=320), 9, 320, 48,
                         [(300, 9), (150, 6), (77, 12), (210, 5), (40, 8)]),
    })


def serve_gemma3(dev):
    """Phase 10b: gemma3-1b at full width and depth (26 layers, bf16, seeded
    random weights, H²EAL defaults): lockstep ``generate`` over BATCH prompts
    of G3_PROMPT tokens, then the engines of phases 5 to 7 on the same
    workload (eager, packed, coplace_shmap, captured with decode_window=4),
    launch counts exact, each captured engine's tokens equal to its eager
    run's. Returns the launch counts of each path."""
    from repro_torch.configs import get_arch

    cfg = get_arch(G3_ARCH)
    params = full_params(dev, cfg)
    by_path = {"gemma3_generate": serve_full(dev, cfg, params, prompt=G3_PROMPT)}
    launches, _, _ = serve_engine(dev, cfg, params, label=f" {cfg.name}")
    by_path.update({f"gemma3_engine_{k}": v for k, v in launches.items()})
    del params
    torch.cuda.empty_cache()
    return by_path


def pool_state(gen, dev, spec, b):
    """A full eviction pool of POOL_PAGES slots for a context of POOL_CTX
    tokens, its pages in shuffled slots: the sink pages, the local window's
    pages and a random choice of the pages between; K/V random bf16, τ
    from each page's written rows, importance random."""
    from repro_torch.core import cache as cachelib
    from repro_torch.core import paging

    h2, hr, d = spec.h2, spec.n_retrieval, spec.head_dim
    p = h2.page_size
    n_sink, _ = paging.page_counts(sink=h2.sink, local=h2.local, page=h2.page_size)
    n_ctx = -(-POOL_CTX // p)
    lo = max(POOL_CTX - h2.local - p, 0) // p  # the local window, a page to spare
    pool = cachelib.make_paged_cache(b, hr, POOL_PAGES, p, d, h2.top_k_pages,
                                     dtype=torch.bfloat16, device=dev)
    pool.k_pages.copy_(torch.randn(pool.k_pages.shape, generator=gen, device=dev))
    pool.v_pages.copy_(torch.randn(pool.v_pages.shape, generator=gen, device=dev))
    n_mid = POOL_PAGES - n_sink - (n_ctx - lo)
    for bi in range(b):
        for hi in range(hr):
            mid = n_sink + torch.randperm(lo - n_sink, generator=gen, device=dev)[:n_mid]
            pages = torch.cat([torch.arange(n_sink, device=dev), mid,
                               torch.arange(lo, n_ctx, device=dev)])
            slots = torch.randperm(POOL_PAGES, generator=gen, device=dev)
            pool.page_start[bi, hi, slots] = (pages * p).to(torch.int32)
    rows = pool.page_start[..., None] + torch.arange(p, device=dev) < POOL_CTX
    kf = pool.k_pages.float()
    pool.tau_min.copy_(torch.where(rows[..., None], kf, math.inf).amin(dim=3))
    pool.tau_max.copy_(torch.where(rows[..., None], kf, -math.inf).amax(dim=3))
    pool.importance.copy_(torch.rand(pool.importance.shape, generator=gen, device=dev) * 100)
    return pool


def check_pool_on_card(dev):
    """Phase 10c: the eviction pool (``decode_attention_pool``, lockstep) at
    llama3-8b's retrieval shape (B=2, Hr=4, g=4, D=128) and gemma3-1b's
    (Hr=1, g=4, D=256), H²EAL defaults: a full pool of POOL_PAGES pages
    (5120 tokens) for a context of POOL_CTX, then POOL_STEPS decode steps
    (select every share window) that cross two page boundaries, each
    evicting. The kernel path (the state on the card) against the plain
    path (the same function on the state widened to f32 on the CPU, fed the
    same bf16 values): page starts and selections equal (a differing
    selection must be a near-tie of the plain scores, after which the card
    takes the CPU's state), importance within 1e-5 of its largest, outputs
    within the bf16 kernel tolerance, the sink and local pages resident at
    every step. Returns the kernels' launches."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import cache as cachelib
    from repro_torch.core import hybrid_attention as hattn
    from repro_torch.core import paging
    from repro_torch.kernels import ops

    launched = {k: 0 for k in ops.LAUNCHES}
    gen = torch.Generator(device=dev).manual_seed(4)
    for arch, hr, g, d in (("llama3-8b", 4, 4, 128), (G3_ARCH, 1, 4, 256)):
        h2 = get_arch(arch).h2eal
        p = h2.page_size
        # every kv head a retrieval head, as in the reference's pool tests
        h2 = dataclasses.replace(h2, static_sparsity=0.0, kv_budget=POOL_PAGES * p)
        spec = hattn.AttnSpec(n_q=hr * g, n_kv=hr, head_dim=d, h2=h2)
        b = BATCH
        card = pool_state(gen, dev, spec, b)
        plain = cachelib.PagedCache(**{f.name: getattr(card, f.name).cpu().clone()
                                       for f in dataclasses.fields(card)})
        plain.k_pages, plain.v_pages = plain.k_pages.float(), plain.v_pages.float()
        ring = lambda where: cachelib.make_stream_cache(b, 0, h2.sink, h2.local + p, d,
                                                        dtype=torch.bfloat16, device=where)
        s_card, s_cpu = ring(dev), ring("cpu")
        worst, ties, evictions, resyncs = -math.inf, 0, 0, 0
        ops.reset_launches()
        t0 = time.perf_counter()
        for i in range(POOL_STEPS):
            length = POOL_CTX + i
            do_select = i % h2.share_window == 0
            q, k, v = (torch.randn(b, n, d, generator=gen, device=dev).to(torch.bfloat16)
                       for n in (hr * g, hr, hr))
            before = card.page_start.clone().cpu()  # the step writes the pool in place
            out, card, s_card = hattn.decode_attention_pool(
                spec, q, k, v, card, s_card, length, do_select=do_select)
            want, plain, s_cpu = hattn.decode_attention_pool(
                spec, *(x.float().cpu() for x in (q, k, v)), plain, s_cpu, length,
                do_select=do_select)
            after = card.page_start.cpu()
            opened = ~(before == length // p * p).any(dim=-1)
            evictions += int((opened & (before >= 0).all(dim=-1)).any().item())
            worst = max(worst, excess(out.cpu(), want, torch.bfloat16))
            imp_tol = 1e-5 * plain.importance.abs().max().item()
            same = (torch.equal(after, plain.page_start)
                    and torch.equal(card.sel_idx.cpu(), plain.sel_idx)
                    and (card.importance.cpu() - plain.importance).abs().max().item()
                    <= imp_tol)
            if not same:
                # a near-tie of the plain scores at the k-th page, or a failure
                ctx = length + 1
                scores = paging.score_pages(q.float().cpu(), plain.tau_min, plain.tau_max,
                                            plain.page_start, ctx, sink=h2.sink,
                                            local=h2.local, page=p)
                top = scores.sort(dim=-1, descending=True).values
                kk = min(h2.top_k_pages, top.shape[-1] - 1)
                gap = (top[..., kk - 1] - top[..., kk]).abs().min().item()
                if not do_select or gap > 2 * SCORE_RTOL * top.abs().max().item():
                    fail(f"pool ({arch}) step {i}: the card's pool state differs from the "
                         f"plain path's beyond a near-tie (gap {gap:.3e})")
                ties += 1
                for f in dataclasses.fields(card):
                    getattr(card, f.name).copy_(getattr(plain, f.name))
                resyncs += 1
            ctx = length + 1
            first_local = max(ctx - h2.local, 0) // p
            need = set(range(0, -(-h2.sink // p) * p, p)) | set(range(first_local * p, ctx, p))
            for row in after.reshape(-1, POOL_PAGES):
                if not need <= set(row.tolist()):
                    fail(f"pool ({arch}) step {i}: a sink or local page is not resident")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name, n in ops.LAUNCHES.items():
            launched[name] += n
        n_sel = -(-POOL_STEPS // h2.share_window)
        want_l = {"page_score": n_sel, "paged_attention": POOL_STEPS}
        got_l = {k: ops.LAUNCHES[k] for k in want_l}
        log(f"pool ({arch} shape B={b} Hr={hr} g={g} D={d}, {POOL_PAGES} slots = "
            f"{POOL_PAGES * p} tokens for contexts {POOL_CTX}..{POOL_CTX + POOL_STEPS}, "
            f"top-k {h2.top_k_pages}): {POOL_STEPS} steps, {evictions} steps evicting, "
            f"output excess {worst:.3e} (tol {tol_text(torch.bfloat16)}), near-tie "
            f"selections {ties} (card resynced {resyncs}), launches {got_l} (expected "
            f"{want_l}), {wall:.2f}s with the CPU's plain path")
        if not worst <= 0.0:
            fail(f"pool ({arch}): outputs differ from the plain path beyond tolerance")
        if evictions < 2:
            fail(f"pool ({arch}): fewer than two steps evicted a page")
        if got_l != want_l:
            fail(f"pool ({arch}): launches {got_l}, expected {want_l}")
        del card, plain
    return launched


# ---------------------------------------------------------------------------
# the MoE family: GQA group 16 in phase 2, and phase 11
# ---------------------------------------------------------------------------


def moe_arch(name: str, layers: int):
    """A registered MoE config at full width, cut to ``layers`` layers."""
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(name), num_layers=layers)


def check_arch_shapes(ops, ref, timer, dev, cfg, dtype, gen):
    """Phase 2 at a registered model's shapes (qwen3-moe-235b: 64 query
    heads over 4 kv heads, a GQA group of 16, head_dim 128; zamba2-2.7b: 32
    over 32, a group of 1, head_dim 80): flash over B=BATCH prompts of
    PROMPT (both head kinds); the select step at the lockstep and engine
    shapes; the streaming ring's decode and the retrieval pages read in
    place (with the gathered buffer, the full-attention baseline and the
    draft selection beside them); the chunk kernels at the engine's chunk
    phase; the co-placed decode, the stripes' partials and the standalone
    merge of those partials. Cases are tagged with the model and are not
    part of the main totals."""
    lock_cap = serve_capacity(cfg)
    eng_cap = engine_workload(cfg)[1]
    part, comb = check_partial(ops, ref, timer, dev, cfg, dtype, gen)
    res = {
        "flash_attention": check_flash(ops, ref, timer, dev, cfg, dtype, gen),
        "page_score": [check_page_select(ops, ref, timer, dev, cfg, dtype, gen, path)
                       for path in ("lockstep", "engine")],
        "paged_attention": check_paged(ops, ref, timer, dev, cfg, dtype, gen, lock_cap),
        "chunk_attention": check_chunk(ops, ref, timer, dev, cfg, dtype, gen),
        "chunk_attention_paged": check_chunk_paged(ops, ref, timer, dev, cfg, dtype, gen,
                                                   eng_cap),
        "paged_attention_partial": part,
        "combine_partials": comb,
    }
    for cases in res.values():
        for c in cases:
            c.update(case=f"{cfg.name} {c['case']}", main=False, arch=cfg.name)
    torch.cuda.empty_cache()
    return res


def check_reduced_moe_against_cpu(dev):
    """Phase 11a: qwen3-moe reduced with 32 query heads over 2 kv heads (GQA
    group 16; 4 experts, top-2), card against CPU: f32 generate at head_dim
    32, dropless and at capacity factor 0.25 (experts overflow in the
    prefill), token for token; bf16 generate at head_dim 128 (the group-16
    D = 128 kernels), dropless and at 0.25, within the bf16 band."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced

    def factor(cfg, f):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=f))

    base = reduced(get_arch(MOE_ARCH), num_heads=32, num_kv_heads=2)
    for f in (0.0, 0.25):
        check_reduced_against_cpu(dev, factor(base, f), prompt_len=45)
        bf16_generate_against_cpu(dev, factor(dataclasses.replace(base, head_dim=128), f))


def serve_moe(dev):
    """Phase 11b: qwen3-moe-235b-a22b at full width (all 128 experts, top-8,
    capacity factor 1.25) cut to MOE_LAYERS of its 94 layers, bf16, seeded
    random weights: lockstep ``generate`` (sparse, then full attention), then
    the chunked engine of phase 5 with fused windows (decode_window=4),
    eager and captured, launch counts exact, captured tokens equal to
    eager (a capacity-bound MoE routes the rows of the slots that are not
    prefilling, which a fused window computes otherwise than the per-step
    mixed step: the reference's fused engine departs from its per-step one
    there, and the port mirrors both, tests/test_torch_moe.py);
    then kimi-k2-1t-a32b at full width (384 experts and its shared expert)
    cut to KIMI_LAYERS of 61 through lockstep ``generate``. Returns the
    launch counts of each path."""
    cfg = moe_arch(MOE_ARCH, MOE_LAYERS)
    log(f"{cfg.name}: full width, {cfg.num_layers} of 94 layers (seeded random weights)")
    params = full_params(dev, cfg)
    by_path = {"moe_generate": serve_full(dev, cfg, params)}
    launches, _, _ = serve_engine(dev, cfg, params, label=f" {cfg.name}",
                                  modes=("chunked_windows", "chunked_graphs"))
    by_path.update({f"moe_engine_{k}": v for k, v in launches.items()})
    del params
    torch.cuda.empty_cache()
    kimi = moe_arch(KIMI_ARCH, KIMI_LAYERS)
    log(f"{kimi.name}: full width, {kimi.num_layers} of 61 layers (seeded random weights)")
    params = full_params(dev, kimi)
    by_path["kimi_generate"] = serve_full(dev, kimi, params)
    del params
    torch.cuda.empty_cache()
    return by_path


def hybrid_cfg(**kw):
    """The reference's own hybrid test config: reduced zamba2 with the
    pattern mamba2, mamba2, attention."""
    from repro_torch.configs import get_arch, reduced

    return reduced(get_arch(Z_ARCH), mixer_pattern=("mamba2", "mamba2", "attention"),
                   num_layers=3, **kw)


def check_reduced_recurrent_against_cpu(dev):
    """Phase 12a, card against CPU: the reduced hybrid (mamba2, mamba2,
    attention) f32 generate at head_dim 32 token for token; bf16 generate at
    head_dim 80 (the D = 80 kernels) within the bf16 band; its chunked
    engine with churn, captured with fused windows, against its eager run
    and the CPU (f32 at head_dim 32, bf16 at 80); its coplace_shmap engine
    over 2 stripes; then the reduced xlstm-125m (mlstm, mlstm, slstm, mlstm)
    f32 generate token for token."""
    from repro_torch.configs import get_arch, reduced

    check_reduced_against_cpu(dev, hybrid_cfg(), prompt_len=45)
    bf16_generate_against_cpu(dev, hybrid_cfg(head_dim=80))
    check_reduced_window_engines(dev, {
        torch.float32: (widen_share(hybrid_cfg()), 5, 96, 7,
                        [(37, 9), (20, 4), (51, 6), (9, 7), (30, 5)]),
        torch.bfloat16: (widen_share(hybrid_cfg(head_dim=80), select_budget=320),
                         9, 320, 48, [(300, 9), (150, 6), (77, 12), (210, 5), (40, 8)]),
    })
    check_reduced_coplace_engine_against_cpu(dev, hybrid_cfg(), shards=2)
    check_reduced_against_cpu(dev, reduced(get_arch(X_ARCH)), prompt_len=45)


def serve_zamba2(dev):
    """Phase 12b: zamba2-2.7b at full width cut to Z_LAYERS (bf16, seeded
    random weights, H²EAL defaults on its attention layers): lockstep
    ``generate`` over BATCH prompts of PROMPT tokens (sparse, then full
    attention), then the chunked engine of phase 5 with fused windows
    (decode_window=4), eager and captured: launch counts exact over the
    attention layers, captures made once, captured tokens equal to eager,
    every poll under sync debug mode "error". Returns the launch counts of
    each path."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(Z_ARCH), num_layers=Z_LAYERS)
    log(f"{cfg.name}: full width, {cfg.num_layers} of 54 layers "
        f"({len(cfg.attention_layers)} attention, head_dim {cfg.resolved_head_dim})")
    params = full_params(dev, cfg)
    by_path = {"zamba2_generate": serve_full(dev, cfg, params)}
    launches, _, _ = serve_engine(dev, cfg, params, label=f" {cfg.name}",
                                  modes=("chunked_windows", "chunked_graphs"))
    by_path.update({f"zamba2_engine_{k}": v for k, v in launches.items()})
    del params
    torch.cuda.empty_cache()
    return by_path


def graph_nodes(fn) -> int:
    """Nodes of ``fn`` captured as one CUDA graph (after a warm-up), through
    the driver's cuGraphGetNodes on the graph kept before instantiation."""
    import ctypes

    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        fail(f"cuGraphGetNodes failed: {rc}")
    del graph
    return int(n.value)


def serve_xlstm(dev):
    """Phase 12c: xlstm-125m at full width and depth (bf16, seeded random
    weights; attention-free, so H²EAL is off and no attention kernel runs):
    lockstep ``generate`` over BATCH prompts of X_PROMPT tokens, GEN greedy
    tokens; then the chunked engine (chunks of X_CHUNK tokens, fused
    windows) eager and captured on X_ENGINE, captured tokens equal to eager,
    every poll under sync debug mode "error", no kernel launched anywhere;
    the node count of one captured chunk step is logged."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    cfg = get_arch(X_ARCH)
    params = full_params(dev, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, X_PROMPT), generator=gen, device=dev)
    ops.reset_launches()
    toks, stats = generate(cfg, params, prompts, gen=GEN,
                           capacity=X_PROMPT + GEN + cfg.h2eal.page_size, device=dev)
    if tuple(toks.shape) != (BATCH, GEN) or not bool(torch.isfinite(stats["last_logits"]).all()):
        fail("xlstm generate produced a wrong shape or non-finite logits")
    log(f"generate ({cfg.name}) B={BATCH} S={X_PROMPT}: prefill {stats['prefill_s']:.3f}s, "
        f"decode {stats['decode_s']:.3f}s ({stats['tokens_per_s']:.1f} tok/s); launches "
        f"{dict(ops.LAUNCHES)}")
    if any(ops.LAUNCHES.values()):
        fail("xlstm generate launched an attention kernel")
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new=m) for i, (n, m) in enumerate(X_ENGINE)]
    capacity = max(n for n, _ in X_ENGINE) + max(m for _, m in X_ENGINE) + 32
    kw = dict(max_batch=2, capacity=capacity, prompt_buckets=[64], prefill_chunk=X_CHUNK,
              decode_window=ENGINE_WINDOW, device=dev)
    runs = {}
    for mode in ("eager", "graphs"):
        t0 = time.perf_counter()
        eng = Engine(cfg, params, eager=mode == "eager", **kw)
        t_build = time.perf_counter() - t0
        sizes = eng.jit_cache_sizes()
        got, wall, _ = serve_polled(eng, reqs, f"engine {cfg.name} ({mode})")
        s = eng.stats
        log(f"engine {cfg.name} ({mode}): {s.tokens_out} tokens in {wall:.3f}s = "
            f"{s.tokens_out / wall:.2f} tok/s; engine steps {s.engine_steps}, prefill-chunk "
            f"steps {s.prefill_chunks}, decode steps {s.decode_steps}, {s.fused_windows} "
            f"fused windows, captures {sizes}, construction {t_build:.2f}s; launches {got}")
        if any(got.values()) or eng.jit_cache_sizes() != sizes:
            fail(f"engine {cfg.name} ({mode}) launched an attention kernel or captured "
                 f"again: {got}, {sizes} -> {eng.jit_cache_sizes()}")
        runs[mode] = {u: c.tokens for u, c in eng.completions.items()}
        del eng
        torch.cuda.empty_cache()
    if runs["graphs"] != runs["eager"] or any(
            len(runs["graphs"][r.uid]) != r.max_new for r in reqs):
        fail(f"engine {cfg.name}: captured tokens differ from the eager run's at "
             f"{first_divergence(runs['graphs'], runs['eager'])}")
    state = M.empty_serve_state(cfg, 2, capacity=capacity, dtype=torch.bfloat16, device=dev)
    ctoks = torch.zeros((2, X_CHUNK), dtype=torch.int32, device=dev)
    clens = torch.zeros(2, dtype=torch.int32, device=dev)
    nodes = graph_nodes(lambda: M.prefill_chunk(cfg, params, state, ctoks, chunk_len=clens,
                                                active=clens > 0))
    log(f"engine {cfg.name}: captured tokens equal to eager; one chunk step of "
        f"{X_CHUNK} tokens captured is {nodes} graph nodes ({cfg.num_layers} layers)")
    del params, state
    torch.cuda.empty_cache()


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
# Phase 13: training and head identification
# ---------------------------------------------------------------------------


# the backward kernel against its plain version: in f32 the two differ by
# summation order, scaled by a tensor's largest value (dq and dk are sums of
# signed terms that cancel); in bf16 also by the output's one rounding, at
# most half a bf16 step (csrc/flash_attention_bwd.cu derives it)
BWD_MAX_RTOL, BWD_ATOL, BWD_BF16_RTOL = 1e-4, 1e-5, 2.0 ** -8
# the check's masks: causal, llama3-8b's streaming heads (window 256, sink 4),
# gemma3-1b's window layers (512, no sink); a ragged S past both windows
BWD_MASKS = (("causal", 0, 0), ("window+sink", 256, 4), ("window", 512, 0))
BWD_GROUPS = (1, 3, 4, 16)  # 3: smollm-360m's 15 over 5
BWD_S = 601
# the trainer (13c): smollm-360m at full width and depth, f32
TRAIN_ARCH, TRAIN_B, TRAIN_S = "smollm-360m", 8, 2048
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_CRASH_AT = 6, 2, 3
# head identification at llama3-8b (13d): one step at B = 1, S = 8192
HEADID_S = 8192
# 13b's identification loop, card against CPU. Step 0's α gradient, and the
# α gradient at the CPU's identified weights and α computed on both, see the
# same inputs and differ by summation order alone: within BWD_MAX_RTOL of
# the largest |gradient|. The later steps see weights that AdamW moved
# apart: where a weight's gradient is near zero, its normalised step rests
# on the sums' last bits and may differ by up to 2·lr
# (tests/test_torch_train.py::test_train_step_matches_jax), which moves the
# α gradient by more. With the α gradients within HEADID_STEP_GRAD_RTOL,
# AdamW (lr 2e-2) moves α by about 2e-2 · 1e-3 a step more at most: α within
# HEADID_ALPHA_TOL after three steps, and at most half of it past 1e-5. A
# missing or wrong α update moves α by about lr a step
HEADID_STEP_GRAD_RTOL, HEADID_ALPHA_TOL = 1e-3, 1e-4


def bwd_excess(got, want, dtype) -> float:
    """Largest |kernel - plain| - bound over a gradient tensor: within at <= 0."""
    want = want.float()
    lim = BWD_MAX_RTOL * want.abs().max() + BWD_ATOL
    if dtype == torch.bfloat16:
        lim = lim + BWD_BF16_RTOL * want.abs()
    return ((got.float() - want).abs() - lim).max().item()


BWD_TOL_TEXT = {torch.float32: f"{BWD_MAX_RTOL:g}*max|plain| + {BWD_ATOL:g}",
                torch.bfloat16: f"{BWD_BF16_RTOL:.4g}*|plain| + {BWD_MAX_RTOL:g}*max|plain|"
                                f" + {BWD_ATOL:g}"}


# the forward's row log-sum-exp against ref.flash_attention_lse_ref: f32
# scores summed in another order (and, in bf16, exact products), exp2 within
# 2^-22: |L - plain| <= LSE_TOL·(1 + |plain|)
LSE_TOL = 1e-5


def bwd_inputs(ops, gen, dev, dtype, b, s, hq, hkv, d, mask):
    """q, k, v, the forward's output o and row log-sum-exp L (one launch, as
    the autograd forward makes it), and dO."""
    q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(dtype)
    do = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype)
    with torch.no_grad():
        o, lse = ops.flash_attention_lse(q, k, v, **mask)
    return q, k, v, o, do, lse


def lse_excess(got, want) -> float:
    """Largest |L - plain| - LSE_TOL·(1 + |plain|) over the rows with an
    allowed key, inf where the rows without one (-inf) differ."""
    if not torch.equal(got.isinf(), want.isinf()):
        return math.inf
    fin = want.isfinite()
    return ((got[fin] - want[fin]).abs() - LSE_TOL * (1 + want[fin].abs())).max().item()


def check_bwd_cases(ops, ref, dev, gen):
    """Phase 13a: the backward kernels against ref.flash_attention_bwd_ref on
    the card at every head_dim x GQA group x mask x dtype (B = 1, a ragged S,
    one kv head), and, in f32, against torch.autograd.grad through
    ref.flash_attention_ref; the forward's L against
    ref.flash_attention_lse_ref, and its output bit for bit the serving
    forward's (no L pointer). Returns the number of cases."""
    bad, n, worst = [], 0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_lse = {torch.float32: -math.inf, torch.bfloat16: -math.inf}
    for dtype in (torch.float32, torch.bfloat16):
        for d in ops._HEAD_DIMS:
            for g in BWD_GROUPS:
                for label, window, sink in BWD_MASKS:
                    mask = dict(causal=True, window=window, sink=sink)
                    tag = f"D={d} G={g} {label} {str(dtype).split('.')[-1]}"
                    q, k, v, o, do, lse = bwd_inputs(ops, gen, dev, dtype, 1, BWD_S, g, 1,
                                                     d, mask)
                    with torch.no_grad():
                        if not torch.equal(o, ops.flash_attention(q, k, v, **mask)):
                            bad.append(f"forward output differs with the L pointer {tag}")
                    ex_lse = lse_excess(lse, ref.flash_attention_lse_ref(*widened(q, k),
                                                                         **mask))
                    worst_lse[dtype] = max(worst_lse[dtype], ex_lse)
                    if not ex_lse <= 0.0:
                        bad.append(f"L {tag} excess {ex_lse:.3e}")
                    got = ops.flash_attention_bwd(q, k, v, o, do, lse, **mask)
                    want = ref.flash_attention_bwd_ref(*widened(q, k, v, o, do), **mask)
                    checks = [(got, want)]
                    if dtype == torch.float32:
                        leaves_ = [t.clone().requires_grad_(True) for t in (q, k, v)]
                        out = ref.flash_attention_ref(*leaves_, **mask)
                        checks.append((got, torch.autograd.grad(out, leaves_, do)))
                    torch.cuda.synchronize()
                    for gots, wants in checks:
                        for name, a, w in zip("qkv", gots, wants):
                            ex = bwd_excess(a, w, dtype)
                            worst[dtype] = max(worst[dtype], err(a, w))
                            if not ex <= 0.0:
                                bad.append(f"d{name} {tag} excess {ex:.3e}")
                    n += 1
    for dtype, e in worst.items():
        log(f"flash_attention_bwd check: {n // 2} cases in {str(dtype).split('.')[-1]} "
            f"(head_dim {list(ops._HEAD_DIMS)}, GQA {list(BWD_GROUPS)}, "
            f"{[m[0] for m in BWD_MASKS]}, S={BWD_S}), max err {e:.3e} "
            f"(tol {BWD_TOL_TEXT[dtype]}); forward L excess {worst_lse[dtype]:.3e} "
            f"(tol {LSE_TOL:g}*(1 + |plain|)), forward output equal with and without L")
    if bad:
        fail(f"flash_attention_bwd disagrees with its plain version: {bad[:8]}")
    return n


def sdpa_mask(s, window, sink, dev):
    """SDPA's arguments for the causal mask, or the window + sink mask as a
    bool matrix."""
    if not window:
        return dict(is_causal=True)
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(s, device=dev)[None, :]
    return dict(attn_mask=(j <= i) & ((j > i - window) | (j < sink)))


def time_fwd32(ops, ref, timer, dev, label, q, k, v, mask):
    """The f32 forward as the training paths launch it (the output and each
    row's L, ``ops.flash_attention_lse``), checked against its plain versions
    and timed beside them and SDPA's f32 forward."""
    b, s, hq, d = q.shape
    window, sink = mask["window"], mask["sink"]
    run = lambda: ops.flash_attention_lse(q, k, v, **mask)
    with torch.no_grad():
        out, lse = run()
        want = ref.flash_attention_ref(q, k, v, **mask)
        torch.cuda.synchronize()
        e, ex = err(out, want), excess(out, want, torch.float32)
        del want
        ex = max(ex, lse_excess(lse, ref.flash_attention_lse_ref(q, k, **mask)))
        torch.cuda.empty_cache()
        case = (f"{label} forward with L (flash_attention.cu) B={b} S={s} Hq={hq} "
                f"Hkv={k.shape[2]} D={d} causal"
                + (f" window={window} sink={sink}" if window else ""))
        if not ex <= 0.0:
            fail(f"flash_attention (f32, with L) disagrees with its plain version at {case}: "
                 f"excess {ex:.3e}")
        ms = timer.ms(run, 5)
        plain_ms = timer.ms(lambda: ref.flash_attention_ref(q, k, v, **mask), 2)
        torch.cuda.empty_cache()
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        attn = sdpa_mask(s, window, sink, dev)
        lib_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, enable_gqa=True, **attn), 5)
    flops = 4 * d * flash_pairs(s, window, sink) * b * hq
    b_ms, b_by = bound(nbytes(q, k, v, out, lse), flops, torch.float32, mma=True)
    log(f"flash_attention [{case} float32] kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) max_err={e:.3e} "
        f"excess={ex:.3e} (tol {tol_text(torch.float32)}, L {LSE_TOL:g}*(1 + |plain|))")
    return dict(case=case, dtype="float32", max_abs_err=e, excess=ex,
                tol=tol_text(torch.float32), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, main=False)


def time_bwd(ops, ref, timer, dev, gen):
    """Phase 13a's times: the backward kernels, their plain version and
    SDPA's backward through autograd (a bool mask for the window case) at
    smollm-360m's training shape and llama3-8b's head-identification shape
    (causal, and window 256 + sink 4: the gated mix's two calls), each in
    f32, the dtype both paths run (``main``), and in bf16. Each case is
    also held to its plain version, at these shapes' batch and kv-head
    offsets. In f32 the forward that the paths run before it (with L) is
    timed too (``time_fwd32``). Then the same at internvl2-1b's training
    shape (GQA group 7), tagged and not in the main totals. Returns (the
    backward's cases, the f32 forward's cases)."""
    shapes = [(f"{TRAIN_ARCH} training", TRAIN_B, TRAIN_S, 15, 5, 64, (0, 0), dt)
              for dt in (torch.float32, torch.bfloat16)]
    shapes += [(f"{ARCH} head identification", 1, HEADID_S, 32, 8, 128, ws, dt)
               for dt in (torch.float32, torch.bfloat16) for ws in ((0, 0), (256, 4))]
    shapes += [(f"{STUB_ARCHS[0]} training", STUB_TRAIN_B, STUB_TRAIN_S, 14, 2, 64, (0, 0),
                dt) for dt in (torch.float32, torch.bfloat16)]
    cases, fwd_cases = [], []
    for label, b, s, hq, hkv, d, (window, sink), dtype in shapes:
        mask = dict(causal=True, window=window, sink=sink)
        q, k, v, o, do, lse = bwd_inputs(ops, gen, dev, dtype, b, s, hq, hkv, d, mask)
        if dtype == torch.float32:
            fwd_cases.append(time_fwd32(ops, ref, timer, dev, label, q, k, v, mask))
        run = lambda: ops.flash_attention_bwd(q, k, v, o, do, lse, **mask)
        got = run()
        want = ref.flash_attention_bwd_ref(*widened(q, k, v, o, do), **mask)
        torch.cuda.synchronize()
        ex = max(bwd_excess(a, w, dtype) for a, w in zip(got, want))
        e = max(err(a, w) for a, w in zip(got, want))
        del got, want
        torch.cuda.empty_cache()
        case = (f"{label} B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal"
                + (f" window={window} sink={sink}" if window else ""))
        if not ex <= 0.0:
            fail(f"flash_attention_bwd disagrees with its plain version at {case} "
                 f"{str(dtype).split('.')[-1]}: excess {ex:.3e}")
        ms = timer.ms(run, 5)
        plain_ms = timer.ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, **mask), 2)
        torch.cuda.empty_cache()
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, enable_gqa=True, **sdpa_mask(s, window, sink, dev))
        doh = do.transpose(1, 2)
        lib = lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)
        lib_ms = timer.ms(lib, 5)
        del out, qh, kh, vh
        # the function's work: S, dP, dq, dk, dv, five D-long products a
        # pair (2.5x the forward's two); the kernels' own recompute of S and
        # dP in the dq launch, and in bf16 the split operands' second
        # products, are their choice, not the function's, and are not counted
        flops = 10 * d * flash_pairs(s, window, sink) * b * hq
        b_ms, b_by = bound(nbytes(q, k, v, o, do, lse) + nbytes(q, k, v), flops, dtype,
                           mma=True)
        cases.append(dict(
            case=case, dtype=str(dtype).split(".")[-1], max_abs_err=e, excess=ex,
            tol=BWD_TOL_TEXT[dtype], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by,
            main=dtype == torch.float32 and not label.startswith(STUB_ARCHS[0])))
        log(f"flash_attention_bwd [{case} {cases[-1]['dtype']}] kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"max_err={e:.3e} excess={ex:.3e} (tol {BWD_TOL_TEXT[dtype]})")
        del q, k, v, o, do, lse
        torch.cuda.empty_cache()
    return cases, fwd_cases


def train_steps(cfg, params, batches, dev):
    """``make_train_step`` (remat) over ``batches`` from ``params``: the
    [(loss, grad norm)] of each step."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import train as train_rt

    step_fn = train_rt.make_train_step(cfg, train_rt.TrainConfig(lr=1e-3, warmup=1,
                                                                 total_steps=10))
    params = _to(params, dev)
    opt = adamw.init_state(params)
    out = []
    for i, batch in enumerate(batches):
        params, opt, m = step_fn(params, opt, {k: v.to(dev) for k, v in batch.items()}, i)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out


def check_training_against_cpu(dev):
    """Phase 13b, f32, card (kernels) against CPU (plain versions), same
    weights: three make_train_step steps of reduced smollm-360m on the same
    lm_batch steps (losses and grad norms within 1e-5 relative); three steps
    of examples/torch_head_identification.py's loop on its model widened to
    4 kv heads (losses within 1e-5 relative, α and the α gradients within
    the bounds stated at HEADID_STEP_GRAD_RTOL, classify_heads equal); then
    the identified plan, a non-identity permutation, served through prefill
    and 8 decode_steps (tokens equal, last logits within 1e-3)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import gating
    from repro_torch.data import lm_batch, niah_batch
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_head_identification as head_id

    cfg = reduced(get_arch(TRAIN_ARCH))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    batches = [lm_batch(i, batch=4, seq=64, vocab=cfg.vocab_size) for i in range(3)]
    ops.reset_launches()
    card = train_steps(cfg, params, batches, dev)
    launched = dict(ops.LAUNCHES)
    cpu = train_steps(cfg, params, batches, "cpu")
    worst = max(abs(a - b) / abs(b) for c, p in zip(card, cpu) for a, b in zip(c, p))
    log(f"train steps {cfg.name} (B=4 S=64, remat): card (loss, grad norm) {card} "
        f"CPU {cpu}, max rel diff {worst:.3e}; launches fwd "
        f"{launched['flash_attention']} bwd {launched['flash_attention_bwd']}")
    per = 3 * cfg.num_layers
    if not worst <= 1e-5 or launched["flash_attention"] != 2 * per \
            or launched["flash_attention_bwd"] != per:
        fail("the reduced training steps on the card disagree with the CPU or did not "
             "launch the kernels (2 forward and 1 backward a layer and step)")

    hcfg = dataclasses.replace(head_id.config(), num_heads=8, num_kv_heads=4)
    hparams = M.init_params(hcfg, generator=torch.Generator().manual_seed(5), device="cpu")
    runs = {}
    for where in (dev, "cpu"):
        runs[str(where)] = head_id.identify(hcfg, _to(hparams, where), steps=3,
                                            device=where, log_every=100)
    (_, a_card, t_card), (p_cpu, a_cpu, t_cpu) = runs[str(dev)], runs["cpu"]
    perm_card = gating.classify_heads(a_card, hcfg.h2eal.static_sparsity).cpu()
    perm_cpu = gating.classify_heads(a_cpu, hcfg.h2eal.static_sparsity)

    def alpha_grad(where):
        """The α gradient at the CPU's identified weights and α, on the
        loop's next batch."""
        batch = niah_batch(3, batch=16, seq=64, vocab=hcfg.vocab_size, depth_frac=0.4)
        a = a_cpu.to(where).requires_grad_(True)
        loss, _ = head_id.loss_fn(hcfg, _to(p_cpu, where), a, batch["tokens"].to(where),
                                  batch["answer"].to(where))
        return torch.autograd.grad(loss, [a])[0].cpu()

    rel = lambda got, want: err(got, want) / want.abs().max().item()
    g_steps = [rel(c[2], p[2]) for c, p in zip(t_card, t_cpu)]
    g_fixed = {str(w): alpha_grad(w) for w in (dev, "cpu")}
    g_fixed_err = rel(g_fixed[str(dev)], g_fixed["cpu"])
    diff = (a_card.cpu() - a_cpu).abs()
    loose = int((diff > 1e-5).sum())
    loss_err = max(abs(a[i] - b[i]) / abs(b[i]) for a, b in zip(t_card, t_cpu)
                   for i in (0, 1))
    log(f"head identification ({hcfg.num_layers} layers x {hcfg.num_kv_heads} kv heads, 3 "
        f"steps): losses card vs CPU max rel diff {loss_err:.3e}; alpha gradient max err "
        f"over max|grad| by step {[f'{x:.3e}' for x in g_steps]} (norms card "
        f"{[round(t[2].norm().item(), 6) for t in t_card]} CPU "
        f"{[round(t[2].norm().item(), 6) for t in t_cpu]}), at the identified state "
        f"{g_fixed_err:.3e}; alpha max err {diff.max().item():.3e}, {loose} of "
        f"{diff.numel()} past 1e-5; perms {perm_cpu.tolist()} "
        f"equal={torch.equal(perm_card, perm_cpu)}")
    if not (loss_err <= 1e-5 and g_steps[0] <= BWD_MAX_RTOL and g_fixed_err <= BWD_MAX_RTOL
            and max(g_steps[1:]) <= HEADID_STEP_GRAD_RTOL
            and diff.max().item() <= HEADID_ALPHA_TOL and loose <= diff.numel() // 2
            and g_fixed["cpu"].abs().min().item() > 0 and torch.equal(perm_card, perm_cpu)):
        fail("head identification on the card disagrees with the CPU")
    plan_cpu = gating.plan_from_perms(perm_cpu)
    if all(p is None for p in plan_cpu):
        fail("the identified plan is the identity: the check would not exercise it")
    plan_dev = [None if p is None else p.to(dev) for p in plan_cpu]
    prompts = torch.randint(0, hcfg.vocab_size, (2, 45), generator=torch.Generator().manual_seed(6))
    cap = 45 + 8 + hcfg.h2eal.page_size
    w = max(hcfg.h2eal.share_window, 1)
    toks, last = {}, {}
    for where, plan in ((dev, plan_dev), ("cpu", plan_cpu)):
        with torch.inference_mode():
            params_ = _to(p_cpu, where)  # both sides serve the CPU's identified weights
            logits, state = M.prefill(hcfg, params_, prompts.to(where), capacity=cap,
                                      plan=plan)
            out = []
            for i in range(8):
                tok = logits.argmax(dim=-1).to(torch.int32)
                out.append(tok)
                logits, state = M.decode_step(hcfg, params_, state, tok, plan=plan,
                                              do_select=i % w == 0)
        toks[str(where)] = torch.stack(out, 1).cpu()
        last[str(where)] = logits.float().cpu()
    e = err(last[str(dev)], last["cpu"])
    same = torch.equal(toks[str(dev)], toks["cpu"])
    log(f"identified plan {[None if p is None else p.tolist() for p in plan_cpu]} served "
        f"(prefill 45 + 8 decode steps): card vs CPU tokens equal={same}, last-logit max "
        f"err {e:.3e}")
    if not same or e > 1e-3:
        fail("the identified plan serves differently on the card and the CPU")


def train_full_width(dev):
    """Phase 13c: ``python -m repro_torch.launch.train`` (its ``main``) at
    smollm-360m's full width and depth, f32, B = 8, S = 2048, remat, 6 steps
    with a checkpoint every 2; then again with a crash after 3 steps, and a
    resume from the last checkpoint: the final losses must agree within
    1e-6. Returns the uninterrupted run's launch counts."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    cfg = get_arch(TRAIN_ARCH)
    common = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_B),
              "--seq", str(TRAIN_S), "--ckpt-every", str(TRAIN_CKPT_EVERY),
              "--log-every", "1"]
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss_ref = train_cli.main(common + ["--ckpt-dir", os.path.join(tmp, "a")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        try:
            train_cli.main(common + ["--ckpt-dir", os.path.join(tmp, "b"),
                                     "--crash-at", str(TRAIN_CRASH_AT)])
            fail("the trainer did not crash at --crash-at")
        except RuntimeError as exc:
            log(f"trainer: {exc}")
        loss_res = train_cli.main(common + ["--ckpt-dir", os.path.join(tmp, "b")])
    want = dict(flash_attention=2 * cfg.num_layers * TRAIN_STEPS,
                flash_attention_bwd=cfg.num_layers * TRAIN_STEPS)
    got = {k: launches[k] for k in want}
    log(f"trainer {cfg.name} full width ({cfg.num_layers} layers, d_model {cfg.d_model}), "
        f"f32, B={TRAIN_B} S={TRAIN_S}, remat: {TRAIN_STEPS} steps in {wall:.1f}s "
        f"(checkpoints included), peak memory {peak:.2f} GiB, launches {got} (expected "
        f"{want}); final loss {loss_ref!r}, after crash at {TRAIN_CRASH_AT} and resume "
        f"{loss_res!r}, diff {abs(loss_ref - loss_res):.3e}")
    if got != want:
        fail("the trainer did not launch the forward and backward kernels as expected")
    if not math.isfinite(loss_ref) or abs(loss_ref - loss_res) > 1e-6:
        fail("the resumed training run does not reproduce the uninterrupted one")
    return launches


def head_id_full_width(dev):
    """Phase 13d: one head-identification step at llama3-8b's full width and
    depth: bf16 random weights without grad, α (32 x 8, f32) the only
    trainable leaf, the gated lm_loss + λ‖α‖₁ at B = 1, S = 8192 with remat,
    its backward, and one AdamW step on α. (The gated mix promotes to α's
    f32, as the reference's does, so the layers after the first run in f32.)
    Returns the launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.core import gating
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cfg = get_arch(ARCH)
    params = full_params(dev, cfg)
    batch = {k: v.to(dev) for k, v in lm_batch(0, batch=1, seq=HEADID_S,
                                                vocab=cfg.vocab_size).items()}
    alpha = gating.init_alpha(cfg.num_layers, cfg.num_kv_heads, device=dev)
    opt = adamw.init_state(alpha)
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = alpha.detach().requires_grad_(True)
    task = M.lm_loss(cfg, params, batch["tokens"], batch["labels"], alpha=a, remat=True)
    loss = gating.gating_loss(task, a, 2e-3)
    (grad,) = torch.autograd.grad(loss, [a])
    alpha, opt, _ = adamw.apply_updates(alpha, grad, opt,
                                        adamw.AdamWConfig(lr=2e-2, weight_decay=0.0))
    alpha = gating.clip_alpha(alpha)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gnorm = grad.norm().item()
    # layer 0's q, k and v depend on no trainable leaf, so its attention
    # makes no autograd node: its α gradient is full - stream
    want = dict(flash_attention=4 * cfg.num_layers,
                flash_attention_bwd=2 * (cfg.num_layers - 1))
    got = {k: launches[k] for k in want}
    log(f"head identification {cfg.name} full width (bf16 weights, alpha f32 "
        f"{tuple(alpha.shape)}), B=1 S={HEADID_S}, remat: step {wall:.2f}s, peak memory "
        f"{peak:.2f} GiB, task loss {task.item():.4f}, alpha grad norm {gnorm:.4e}, "
        f"alpha after the step in [{alpha.min().item():.4f}, {alpha.max().item():.4f}], "
        f"launches {got} (expected {want})")
    if not (math.isfinite(gnorm) and gnorm > 0):
        fail("the head-identification alpha gradient is not finite and non-zero")
    if got != want:
        fail("head identification did not launch the forward and backward kernels as "
             "expected")
    del params
    torch.cuda.empty_cache()
    return launches


def phase13(ops, ref, dev):
    """Phase 13: (a) the backward kernels' check and times, (b) training and
    head identification card against CPU, (c) the full-width trainer with
    crash and resume, (d) llama3-8b's head-identification step. Returns
    (the backward's kernel-line cases, the f32 forward's cases at the
    training shapes, launch counts by path)."""
    t13 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)
    check_bwd_cases(ops, ref, dev, gen)
    timer = Timer(dev)
    cases, fwd_cases = time_bwd(ops, ref, timer, dev, gen)
    del timer
    torch.cuda.empty_cache()
    check_training_against_cpu(dev)
    by_path = {"train": train_full_width(dev), "head_id": head_id_full_width(dev)}
    log(f"phase 13 (training and head identification) {time.perf_counter() - t13:.1f}s")
    return cases, fwd_cases, by_path


# ---------------------------------------------------------------------------
# Phase 14: the frontend-stub families, and the dry run against the card
# ---------------------------------------------------------------------------


def stub_embeds(gen, dev, dtype, *shape):
    """Seeded precomputed embeddings, the stub archs' inputs."""
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


def check_stub_shapes(ops, ref, timer, dev, cfg, dtype, gen):
    """Phase 2 at a frontend-stub model's serving shapes (internvl2-1b: 14
    query heads over 2 kv heads, GQA group 7 on the group-8 instantiations;
    musicgen-large: 32 over 32, a group of 1; head_dim 64): flash over
    B=BATCH prompts of PROMPT (both head kinds), the select step at the
    lockstep and engine shapes, the streaming ring's decode and the
    retrieval pages read in place (with the gathered buffer, the
    full-attention baseline and the draft selection beside them). The
    stubs serve through prefill and decode_step only (no chunked prefill:
    the reference refuses it), so the chunk kernels are not at their
    shapes. Cases are tagged with the model, not in the main totals."""
    res = {
        "flash_attention": check_flash(ops, ref, timer, dev, cfg, dtype, gen),
        "page_score": [check_page_select(ops, ref, timer, dev, cfg, dtype, gen, path)
                       for path in ("lockstep", "engine")],
        "paged_attention": check_paged(ops, ref, timer, dev, cfg, dtype, gen,
                                       serve_capacity(cfg)),
    }
    for cases in res.values():
        for c in cases:
            c.update(case=f"{cfg.name} {c['case']}", main=False, arch=cfg.name)
    torch.cuda.empty_cache()
    return res


def stub_steps(cfg, params, x, xs, capacity, dev):
    """prefill on the embeddings x (B, S, d), then a decode step fed each of
    xs (B, d), select steps every share window; the logits of each (the
    prefill's first) on the CPU in f32."""
    from repro_torch.runtime import serve as serve_rt

    scfg = serve_rt.ServeConfig(capacity=capacity)
    steps = {s: serve_rt.make_decode_step(cfg, scfg, do_select=s) for s in (True, False)}
    w = max(cfg.h2eal.share_window, 1)
    with torch.inference_mode():
        logits, state = serve_rt.make_prefill(cfg, scfg)(params, x.to(dev))
        out = [logits.float().cpu()]
        for i, xi in enumerate(xs):
            logits, state = steps[i % w == 0](params, state, xi.to(dev))
            out.append(logits.float().cpu())
    return out


def check_reduced_stubs_against_cpu(dev):
    """Phase 14b, card (kernels) against CPU (plain versions), same weights
    and seeded embeddings: reduced internvl2-1b with 14 query heads over 2
    (group 7) and reduced musicgen-large (MHA) through prefill and
    STUB_REDUCED_STEPS decode steps (select and reuse), f32 at head_dim 32
    (every logit within LOGIT_TOL) and bf16 at head_dim 64 (within
    BF16_LOGIT_BAND of the largest CPU logit; the top-k covers every page,
    as in bf16_generate_against_cpu, so that no bf16 near-tie of page scores
    moves the selection); then one make_train_step step of the reduced
    group-7 model, f32: loss and grad norm within 1e-5 relative, the
    parameters within PARAM_TOL but for AdamW's sign flips of near-zero
    gradients (each within 2·lr, at most a thousandth of the elements)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.tree import leaves
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import train as train_rt

    n = STUB_REDUCED_STEPS
    for name, kw in STUB_REDUCED:
        for dtype, hd, s in ((torch.float32, 32, 45), (torch.bfloat16, 64, 300)):
            cfg = reduced(get_arch(name), head_dim=hd, **kw)
            page = cfg.h2eal.page_size
            if dtype == torch.bfloat16:
                cfg = dataclasses.replace(cfg, h2eal=dataclasses.replace(
                    cfg.h2eal, select_budget=-(-(s + n) // page) * page))
            gen = torch.Generator().manual_seed(14)
            params = M.init_params(cfg, generator=gen, device="cpu", dtype=dtype)
            x = stub_embeds(gen, "cpu", dtype, 2, s, cfg.d_model)
            xs = [stub_embeds(gen, "cpu", dtype, 2, cfg.d_model) for _ in range(n)]
            cap = s + n + page
            cpu = stub_steps(cfg, params, x, xs, cap, "cpu")
            ops.reset_launches()
            card = stub_steps(cfg, _to(params, dev), x, xs, cap, dev)
            launched = dict(ops.LAUNCHES)
            worst = max(err(a, b) for a, b in zip(card, cpu))
            band = (LOGIT_TOL if dtype == torch.float32
                    else BF16_LOGIT_BAND * max(c.abs().max().item() for c in cpu))
            per = layer_launches(cfg)
            want = {"flash_attention": per["prefill"], "paged_attention": per["decode"] * n,
                    "page_score": per["select"] * -(-n // max(cfg.h2eal.share_window, 1))}
            got = {k: launched[k] for k in want}
            log(f"reduced {cfg.name} Hq={cfg.num_heads} Hkv={cfg.num_kv_heads} head_dim {hd} "
                f"{str(dtype).split('.')[-1]} (prefill {s} embeddings + {n} decode steps): "
                f"card vs CPU logits max err {worst:.3e} (band {band:.3e}); launches {got} "
                f"(expected {want})")
            if not worst <= band or got != want:
                fail(f"the reduced {cfg.name} on the card disagrees with the CPU run or did "
                     f"not launch the kernels as expected")

    cfg = reduced(get_arch(STUB_REDUCED[0][0]), **STUB_REDUCED[0][1])
    gen = torch.Generator().manual_seed(15)
    params = M.init_params(cfg, generator=gen, device="cpu")
    batch = {"tokens": stub_embeds(gen, "cpu", torch.float32, 4, 64, cfg.d_model),
             "labels": lm_batch(0, batch=4, seq=64, vocab=cfg.vocab_size)["labels"]}
    lr = 1e-3
    step_fn = train_rt.make_train_step(cfg, train_rt.TrainConfig(lr=lr, warmup=1,
                                                                 total_steps=10))
    out = {}
    ops.reset_launches()
    for where in (dev, "cpu"):
        p = _to(params, where)
        p, _, m = step_fn(p, adamw.init_state(p), {k: v.to(where) for k, v in batch.items()},
                          0)
        out[str(where)] = (_to(p, "cpu"), m["loss"].item(), m["grad_norm"].item())
    launched = dict(ops.LAUNCHES)
    (p_card, l_card, g_card), (p_cpu, l_cpu, g_cpu) = out[str(dev)], out["cpu"]
    flips, worst, n_el = 0, 0.0, 0
    for a, b in zip(leaves(p_card), leaves(p_cpu)):
        off = (a - b).abs()
        flips += int((off > PARAM_TOL).sum())
        worst = max(worst, off.max().item())
        n_el += off.numel()
    rel = max(abs(l_card - l_cpu) / abs(l_cpu), abs(g_card - g_cpu) / abs(g_cpu))
    log(f"train step reduced {cfg.name} (group {cfg.num_heads // cfg.num_kv_heads}, "
        f"B=4 S=64 embeddings, remat): loss card {l_card!r} CPU {l_cpu!r}, grad norm card "
        f"{g_card!r} CPU {g_cpu!r}, max rel diff {rel:.3e}; parameters max diff {worst:.3e}, "
        f"{flips} of {n_el} past {PARAM_TOL:g}; launches fwd {launched['flash_attention']} "
        f"bwd {launched['flash_attention_bwd']}")
    if not (rel <= 1e-5 and worst <= 2 * lr and flips <= n_el // 1000):
        fail("the reduced frontend-stub train step on the card disagrees with the CPU")
    if (launched["flash_attention"] != 2 * cfg.num_layers
            or launched["flash_attention_bwd"] != cfg.num_layers):
        fail("the reduced frontend-stub train step did not launch the kernels as expected")


def serve_stub(dev, name, card):
    """Phase 14c and e: ``name`` at full width and depth, bf16, seeded random
    weights and seeded bf16 embeddings: prefill on BATCH x PROMPT, then GEN
    decode steps (select every share window), H²EAL defaults; launch counts
    exact, every logit finite; the bytes the card holds for the parameters,
    the embeddings and the serve state after prefill equal to the dry run's
    (``launch/dryrun.memory_bytes``); then the same run with H²EAL off and the
    logits' difference. Returns the sparse run's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, specs
    from repro_torch.runtime import serve as serve_rt

    cfg = get_arch(name)
    params = full_params(dev, cfg)
    capacity = serve_capacity(cfg)
    gen = torch.Generator(device=dev).manual_seed(14)
    x = stub_embeds(gen, dev, torch.bfloat16, BATCH, PROMPT, cfg.d_model)
    xs = stub_embeds(gen, dev, torch.bfloat16, GEN, BATCH, cfg.d_model)
    w = max(cfg.h2eal.share_window, 1)
    runs = {}
    for h2 in (True, False):
        rcfg = cfg if h2 else dataclasses.replace(
            cfg, h2eal=dataclasses.replace(cfg.h2eal, enabled=False))
        scfg = serve_rt.ServeConfig(capacity=capacity)
        prefill = serve_rt.make_prefill(rcfg, scfg)
        steps = {s: serve_rt.make_decode_step(rcfg, scfg, do_select=s) for s in (True, False)}
        ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, state = prefill(params, x)
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            finite = torch.isfinite(logits).all()
            state_bytes = specs.tree_bytes(state["layers"])
            outs = [logits]
            t0 = time.perf_counter()
            for i in range(GEN):
                logits, state = steps[i % w == 0](params, state, xs[i])
                finite &= torch.isfinite(logits).all()
                outs.append(logits)
            torch.cuda.synchronize()
            t_decode = time.perf_counter() - t0
        runs[h2] = dict(launches=dict(ops.LAUNCHES), logits=torch.stack(outs).float(),
                        finite=bool(finite), prefill_s=t_prefill, decode_s=t_decode,
                        state_bytes=state_bytes,
                        peak=torch.cuda.max_memory_allocated())
        del state, outs, logits
        torch.cuda.empty_cache()
    sparse = runs[True]
    per = layer_launches(cfg)
    expect = {"flash_attention": per["prefill"],
              "page_score": per["select"] * -(-GEN // w),
              "paged_attention": per["decode"] * GEN,
              "chunk_attention": 0, "chunk_attention_paged": 0,
              "paged_attention_partial": 0, "combine_partials": 0,
              "flash_attention_bwd": 0}
    dry = dryrun.memory_bytes(cfg, ShapeConfig("stub_prefill", PROMPT, BATCH, "prefill"),
                              capacity)
    held = specs.tree_bytes(params)
    diff = (sparse["logits"] - runs[False]["logits"]).abs()
    log(f"{cfg.name} full width and depth ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} q heads over {cfg.num_kv_heads} kv heads, head_dim "
        f"{cfg.resolved_head_dim}), bf16 embeddings B={BATCH} S={PROMPT} + {GEN} decode "
        f"steps, capacity {capacity}: sparse prefill {sparse['prefill_s']:.3f}s, decode "
        f"{sparse['decode_s']:.3f}s ({GEN / sparse['decode_s']:.2f} steps/s), all logits "
        f"finite={sparse['finite']}; launches {sparse['launches']} (expected {expect}); "
        f"full attention prefill {runs[False]['prefill_s']:.3f}s, decode "
        f"{runs[False]['decode_s']:.3f}s, finite={runs[False]['finite']}; logits sparse vs "
        f"full max abs diff {diff.max().item():.4e} (prefill {diff[0].max().item():.4e}), "
        f"argmax agreement {(sparse['logits'].argmax(-1) == runs[False]['logits'].argmax(-1)).float().mean().item():.3f}")
    log(f"dry run {cfg.name} on one {card}: params {dry['params']} B (card holds {held}), "
        f"serve state {dry['serve_state']} B (card holds {sparse['state_bytes']} after "
        f"prefill), inputs {dry['inputs']} B (card holds {specs.tree_bytes(x)}), resident "
        f"{dry['resident'] / 2**30:.3f} GiB; peak memory allocated "
        f"{sparse['peak'] / 2**30:.3f} GiB (H2EAL off {runs[False]['peak'] / 2**30:.3f} GiB)")
    if sparse["launches"] != expect:
        fail(f"{cfg.name}: the serving path did not launch the kernels as expected")
    if not (sparse["finite"] and runs[False]["finite"]):
        fail(f"{cfg.name}: non-finite logits")
    if (dry["params"] != held or dry["serve_state"] != sparse["state_bytes"]
            or dry["inputs"] != specs.tree_bytes(x)):
        fail(f"{cfg.name}: the dry run's bytes differ from the card's")
    del params
    torch.cuda.empty_cache()
    return sparse["launches"]


def train_stub(dev, card):
    """Phase 14d and e: internvl2-1b's make_train_step at full width and
    depth, f32, remat, B x S = STUB_TRAIN_B x STUB_TRAIN_S seeded
    embeddings, labels from lm_batch, STUB_TRAIN_STEPS steps: finite losses,
    the forward and backward launches exact, step seconds and peak memory;
    the parameter and AdamW bytes equal to the dry run's. Returns the launch
    counts."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import train as train_rt

    cfg = get_arch(STUB_ARCHS[0])
    gen = torch.Generator(device=dev).manual_seed(16)
    params = M.init_params(cfg, generator=gen, device=dev)
    opt = adamw.init_state(params)
    step_fn = train_rt.make_train_step(cfg, train_rt.TrainConfig(remat=True))
    dry = dryrun.memory_bytes(cfg, ShapeConfig("stub_train", STUB_TRAIN_S, STUB_TRAIN_B,
                                               "train"))
    held = {"params": specs.tree_bytes(params),
            "optimizer": specs.tree_bytes({"mu": opt["mu"], "nu": opt["nu"]})}
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for step in range(STUB_TRAIN_STEPS):
        batch = {"tokens": stub_embeds(gen, dev, torch.float32, STUB_TRAIN_B, STUB_TRAIN_S,
                                       cfg.d_model),
                 "labels": lm_batch(step, batch=STUB_TRAIN_B, seq=STUB_TRAIN_S,
                                    vocab=cfg.vocab_size)["labels"].to(dev)}
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, step)
        losses.append(m["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = dict(flash_attention=2 * cfg.num_layers * STUB_TRAIN_STEPS,
                flash_attention_bwd=cfg.num_layers * STUB_TRAIN_STEPS)
    got = {k: launches[k] for k in want}
    log(f"train {cfg.name} full width and depth ({cfg.num_layers} layers, group "
        f"{cfg.num_heads // cfg.num_kv_heads}), f32, B={STUB_TRAIN_B} S={STUB_TRAIN_S} "
        f"embeddings, remat: losses {losses}, step seconds {[round(t, 3) for t in times]}, "
        f"peak memory allocated {peak / 2**30:.3f} GiB; launches {got} (expected {want})")
    log(f"dry run {cfg.name} training on one {card}: params {dry['params']} B (card holds "
        f"{held['params']}), AdamW m and v {dry['optimizer']} B (card holds "
        f"{held['optimizer']}), resident with gradients {dry['resident'] / 2**30:.3f} GiB "
        f"beside the peak {peak / 2**30:.3f} GiB (activations are not in the dry run)")
    if not all(math.isfinite(v) for v in losses):
        fail("the frontend-stub training losses are not finite")
    if got != want:
        fail("the frontend-stub train step did not launch the kernels as expected")
    if dry["params"] != held["params"] or dry["optimizer"] != held["optimizer"]:
        fail("the dry run's training bytes differ from the card's")
    del params, opt
    torch.cuda.empty_cache()
    return launches


def phase14(dev, card):
    """Phase 14: the frontend-stub families (phase 2 held their kernels at
    their shapes, phase 13a the backward at internvl2-1b's training shape):
    (b) reduced card against CPU, (c) both models at full width and depth
    through prefill and decode fed embeddings, (d) internvl2-1b's train step
    at full width, (e) the dry run's bytes against the card's. Returns the
    launch counts by path."""
    t14 = time.perf_counter()
    check_reduced_stubs_against_cpu(dev)
    by_path = {f"stub_{name}_serve": serve_stub(dev, name, card) for name in STUB_ARCHS}
    by_path[f"stub_{STUB_ARCHS[0]}_train"] = train_stub(dev, card)
    log(f"phase 14 (the frontend-stub families, the dry run) "
        f"{time.perf_counter() - t14:.1f}s")
    return by_path


# ---------------------------------------------------------------------------
# phase 15: the GSPMD layouts (head, coplace, interleave) on torch.distributed
# ranks: (a) one NCCL rank, llama3-8b at full width cut to GSPMD_A_LAYERS,
# captured steps;
# (b) two ranks that share cuda:0 over gloo, llama3-8b at full width cut to
# GSPMD_CUT layers, eager steps
# ---------------------------------------------------------------------------

GSPMD_LAYOUTS = ("head", "coplace", "interleave")
# 15a: 4 ragged requests, prompts of 2048-8192 tokens, 16 new tokens each, on
# 4 slots, fed ENGINE_CHUNK prompt tokens a step (share window 4: llama3-8b's)
GSPMD_A = dict(prompts=(2048, 8192), n=4, new=16, seed=5)
# 15a, 15c and 16a's depth: 16 of llama3-8b's 32 layers (at 32, 15c took
# 90.0-93.6 s and the whole smoke 1057-1104 s of its 1200 on two H100s)
GSPMD_A_LAYERS = 16
# 15b: the cut, and 3 requests of 1024-2048 tokens, 8 new tokens each; head
# and coplace on the (1, 2) mesh at 2 slots, interleave on (2, 1) at 3 slots,
# where the batch cannot take 'data' and the tokens stripe within pages. The
# cut was 8 layers until phase 16 took its share of the smoke's time limit
GSPMD_CUT = 4
GSPMD_B = dict(prompts=(1024, 2048), n=3, new=8, seed=6)
GSPMD_B_CASES = (("head", 2, 2), ("coplace", 2, 2), ("interleave", 1, 3),
                 ("coplace_shmap", 2, 2))
# a decode step's attention output of a GSPMD layout against the default
# layout's on the same state: both round their f32 result to bf16 once, from
# sums taken in other orders, so they may sit a bf16 step apart
GSPMD_STEP_RTOL, GSPMD_STEP_ATOL = 2.0 ** -7, 1e-5
# 15b's rebalanced case: head on (2, 1) at 4 slots, the batch over 'data';
# a CPU run of this seeded schedule at the cut moves slot 2 (rank 1) to slot
# 0 (rank 0). 15b's tiered case: each slot's page budget (a slot's 66
# pages are all pinned, so only the forced request spills)
GSPMD_B_REBALANCE = dict(prompts=(1024, 2048), n=4, new=8, seed=6)
GSPMD_B_HOT_PAGES = 48
# ... on GSPMD_B's prompts with 16 new tokens each, so that a decoding slot
# reaches a selection boundary with more than a share window to go
GSPMD_B_TIERED = dict(GSPMD_B, new=16)
# 15b's further cases: (name, layout, 'model' ranks, slots, engine options,
# workload); chunked, eager, the tiered request forced cold at its first
# selection boundary after GSPMD_B_FORCE_AFTER decode steps
GSPMD_B_FORCE_AFTER = 1
GSPMD_B_EXTRA = (("spec", "coplace", 2, 2, dict(spec_tokens=SPEC_K, draft="ngram"), GSPMD_B),
                 ("tiered", "coplace", 2, 2, dict(hot_pages=GSPMD_B_HOT_PAGES), GSPMD_B_TIERED),
                 ("rebalanced", "head", 1, 4, dict(rebalance="retire"), GSPMD_B_REBALANCE),
                 ("spec_shmap", "coplace_shmap", 2, 2,
                  dict(spec_tokens=SPEC_K, draft="ngram"), GSPMD_B),
                 ("tiered_shmap", "coplace_shmap", 2, 2, dict(hot_pages=GSPMD_B_HOT_PAGES),
                  GSPMD_B_TIERED))
# 15b's other families, on both ranks, chunked and eager (name, arch, layers,
# H²EAL on, layout, 'model' ranks, slots, options, workload): zamba2 cut to
# one period of its pattern (5 mamba2 layers, an attention layer) on head
# (2, 1), its recurrent rows cut over 'data', rebalanced (a CPU run of this
# schedule at the cut moves slot 2, rank 1, to slot 0, rank 0); gemma3-1b cut
# to one period (5 window layers, a global one) on coplace (1, 2), the
# global layer's pages cut (partials at head_dim 256), tiered with a request
# forced cold; llama3-8b at GSPMD_CUT with H²EAL off on head (1, 2), its full
# caches' kv heads cut
GSPMD_B_FAMILIES = (
    ("zamba2_rebalanced", Z_ARCH, 6, True, "head", 1, 4, dict(rebalance="retire"),
     GSPMD_B_REBALANCE),
    ("gemma3_tiered", G3_ARCH, 6, True, "coplace", 2, 2, dict(hot_pages=GSPMD_B_HOT_PAGES),
     GSPMD_B_TIERED),
    ("h2eal_off", ARCH, GSPMD_CUT, False, "head", 2, 2, {}, GSPMD_B))
# 15d: the other families in 15a's NCCL group of one rank, each served by the
# captured chunked engine of the default layout and of each GSPMD layout:
# (label, arch, layers (0: whole), H²EAL on, slots, chunk, workload); xlstm's
# chunk step is a loop of time steps, so it takes X_CHUNK tokens a step
GSPMD_D = dict(prompts=(512, 1024), n=3, new=8, seed=7)
GSPMD_D_MODELS = (("zamba2", Z_ARCH, 0, True, 2, ENGINE_CHUNK, GSPMD_D),
                  ("xlstm", X_ARCH, 0, True, 2, X_CHUNK, dict(GSPMD_D, prompts=(256, 512))),
                  ("gemma3", G3_ARCH, 0, True, 2, ENGINE_CHUNK, GSPMD_D),
                  ("moe", MOE_ARCH, MOE_LAYERS, True, 2, ENGINE_CHUNK, GSPMD_D),
                  ("h2eal_off", ARCH, 0, False, 2, ENGINE_CHUNK, GSPMD_D))
GSPMD_TIMEOUT = 600
SMOKE_DIR = os.path.join(ROOT, ".smoke")


def family_config(arch: str, layers: int, h2eal: bool):
    """A registered config at full width, cut to ``layers`` layers (0: its
    whole depth), H²EAL on or off."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if not h2eal:
        cfg = dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal, enabled=False))
    return cfg


def gspmd_workload(cfg, prompts, n, new, seed, sampled=False):
    """(requests, capacity): ``n`` seeded prompts of ``prompts`` tokens (the
    first the longest), ``new`` tokens each; with ``sampled`` the last
    request samples (SPEC_SAMPLING), the others are greedy."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    lens = rng.integers(prompts[0], prompts[1] + 1, n)
    lens[0] = prompts[1]
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(m)).astype(np.int32),
                    max_new=new) for i, m in enumerate(lens)]
    if sampled:
        reqs[-1] = dataclasses.replace(reqs[-1], **SPEC_SAMPLING)
    return reqs, int(lens.max() + new + cfg.h2eal.page_size)


def check_ties_split(cfg, params, reqs, got, want, capacity, dev, what):
    """``check_ties`` of the greedy requests and, with their sampling, of
    the sampled ones (SPEC_SAMPLING). Returns the near-tie divergences."""
    ties = 0
    for sampled in (False, True):
        part = [r for r in reqs if (r.temperature > 0) == sampled]
        uids = {r.uid for r in part}
        if part:
            ties += check_ties(cfg, params, part, {u: got[u] for u in uids},
                               {u: want[u] for u in uids},
                               SPEC_SAMPLING if sampled else {}, capacity, dev,
                               BF16_LOGIT_BAND, what, relative=True)
    return ties


def serve_forced(eng, reqs, after=None):
    """Serve ``reqs`` a poll at a time, unguarded (a tiered select step
    reads its digest, a verify step its accepted counts), forcing every
    spillable page of the first decoding slot cold at a selection boundary
    once ``after`` decode steps have run (``Engine.tier_force_spill``; no
    force where ``after`` is None). Returns (launch counts, wall seconds,
    (uid, pages forced) or None)."""
    from repro_torch.kernels import ops

    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launches()
    forced, w = None, eng.share_window
    t0 = time.perf_counter()
    while eng.busy():
        b = eng.batch
        if forced is None and after is not None and eng.stats.decode_steps >= after:
            due = [i for i in range(b.max_batch) if b.active[i] and b.phase[i] % w == 0
                   and b.remaining[i] > w]
            if due:
                forced = (int(b.uid[due[0]]), eng.tier_force_spill(int(b.uid[due[0]])))
        eng.poll()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    eng.finalize()
    return got, wall, forced


SPEC_COUNTERS = ("spec_steps", "spec_slot_steps", "spec_drafted", "spec_accepted")
TIER_COUNTERS = ("tier_hits", "tier_misses", "tier_spills", "tier_fills", "tier_prefetch",
                 "tier_fill_batches", "tier_spill_batches", "tier_gather_batches",
                 "tier_batch_pages_max", "tier_archived")
REBALANCE_COUNTERS = ("rebalance_checks", "rebalances", "rebalance_skipped", "migrations",
                      "migrated_tokens")


def counters(stats, names):
    return {n: getattr(stats, n) for n in names}


def attends_by_partials(eng) -> bool:
    """The engine's retrieval decode runs per-rank partials merged by
    ``combine_partials``: a layout that shards pages over more than one
    rank (one rank holding every page runs the default's kernels)."""
    return eng._place is not None and eng._place.partials


def gspmd_tiered_launches(s, cfg, split, replays):
    """A GSPMD layout's (or the default's) chunked run with tiering: its
    plain run's launches, and each replay of a select step launches that
    step's kernels again; ``split`` as ``attends_by_partials``."""
    per = layer_launches(cfg, split)
    out = gspmd_launches(s, cfg, split, 0)
    out["page_score"] += replays * per["select"]
    out["paged_attention"] += replays * per["decode"]
    out["paged_attention_partial"] += replays * per["partial"]
    out["combine_partials"] += replays * per["partial"]
    return out


def gspmd_launches(s, cfg, split, n_prefills):
    """The launches of a GSPMD-layout engine run from its step counts: the
    default engine's, where ``split`` (``attends_by_partials``) the
    retrieval heads attend by ``paged_attention_partial`` and
    ``combine_partials`` (one each a layer a decode step) in place of
    ``paged_attention``."""
    exp = window_launches(s, cfg, 0, split)
    exp["combine_partials"] = exp["paged_attention_partial"]
    exp["flash_attention"] = layer_launches(cfg)["prefill"] * n_prefills
    return exp


def gspmd_step_check(cfg, layout, mesh, b, capacity, dev):
    """One decode select step of one layer at ``cfg``'s full width on this
    rank's blocks of a seeded bf16 state (slots prefilled to 1500, 900, 2000
    tokens), beside the default layout's step on the whole state (under
    ``coplace_shmap``, the one-card body over the mesh's stripes on the
    whole state striped alike): (largest |diff|, excess over the band,
    attended tokens)."""
    from repro_torch.core import layouts
    from repro_torch.models import transformer as T
    from repro_torch.runtime import sharding

    spec = T.attn_spec(cfg)
    placed = layouts.get_layout(layout, mesh=mesh).placed(mesh, batch=b, capacity=capacity)
    place = placed.place(spec)
    one = (layouts.get_layout(layout, placed.shards) if layout == "coplace_shmap"
           else layouts.DEFAULT)
    gen = torch.Generator(device=dev).manual_seed(21)
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(torch.bfloat16)
    hkv, hq, d = spec.n_kv, spec.n_q, spec.head_dim
    lengths = [1500, 900, 2000][:b]
    paged, stream = layouts.DEFAULT.empty_decode_state(spec, b, capacity,
                                                       dtype=torch.bfloat16, device=dev)
    full = {"paged": paged, "stream": stream}
    for i, n in enumerate(lengths):
        small = one.prefill(spec, rnd(1, n, hkv, d), rnd(1, n, hkv, d), n, capacity)
        for key, c in full.items():
            for f in dataclasses.fields(c):
                getattr(c, f.name)[i].copy_(getattr(small[key], f.name)[0])
    block = {key: type(c)(**{f.name: sharding.local_block(
        getattr(c, f.name), place.specs[(key, f.name)], mesh).clone()
        for f in dataclasses.fields(c)}) for key, c in full.items()}
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    q, k, v = rnd(b, hq, d), rnd(b, hkv, d), rnd(b, hkv, d)
    want, _ = one.decode(spec, full, q, k, v, length, do_select=True, active=active,
                         need_select=active)
    got, _ = placed.decode(spec, block, q, k, v, length, do_select=True, active=active,
                           need_select=active)
    torch.cuda.synchronize()
    w = want.float()
    over = ((got.float() - w).abs() - GSPMD_STEP_RTOL * w.abs() - GSPMD_STEP_ATOL).max().item()
    return (got.float() - w).abs().max().item(), over, sum(lengths) + b


def gspmd_rank(rank: int, store: str, out: str) -> int:
    """One of phase 15b's two ranks (``chip_smoke.py --gspmd-rank R STORE
    OUT``): gloo on cuda:0, both meshes made, every case of GSPMD_B_CASES
    served chunked and packed through the eager engine, the decode step
    check, the launch counts; its results written to OUT.R. A failure raises
    and exits non-zero."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    meshlib.init_distributed("gloo", store_path=store, rank=rank, world_size=2)
    meshes = {m: meshlib.make_local_mesh(model=m) for m in (2, 1)}
    # which collectives gloo takes on card tensors (the port gathers with
    # all_reduce alone; this is a report)
    probe = {}
    x = torch.ones(4, device=dev)
    for name, call in (("all_reduce", lambda: dist.all_reduce(x.clone())),
                       ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
                       ("all_gather", lambda: dist.all_gather([x.clone() for _ in range(2)],
                                                              x)),
                       ("all_gather_into_tensor",
                        lambda: dist.all_gather_into_tensor(torch.empty(8, device=dev), x))):
        try:
            call()
            torch.cuda.synchronize()
            probe[name] = "yes"
        except (RuntimeError, ValueError) as exc:
            probe[name] = f"no ({str(exc).splitlines()[0][:80]})"
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=GSPMD_CUT)
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev, dtype=torch.bfloat16)
    reqs, capacity = gspmd_workload(cfg, **GSPMD_B)
    buckets = sorted({len(r.prompt) for r in reqs})
    res = {"probe": probe, "cases": {}}
    for layout, model, max_batch in GSPMD_B_CASES:
        mesh = meshes[model]
        for mode, chunk in (("chunked", ENGINE_CHUNK), ("packed", None)):
            eng = Engine(cfg, params, max_batch=max_batch, capacity=capacity,
                         prompt_buckets=buckets, prefill_chunk=chunk, layout=layout,
                         mesh=mesh, device=dev, eager=True)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            comps = eng.run(reqs)
            wall = time.perf_counter() - t0
            s = eng.stats
            res["cases"][f"{layout}_{mode}"] = dict(
                mesh=mesh.shape, coords=list(mesh.coords), max_batch=max_batch,
                tokens={str(u): c.tokens for u, c in comps.items()},
                launches=dict(ops.LAUNCHES),
                expect=gspmd_launches(s, cfg, attends_by_partials(eng),
                                      0 if chunk else len(reqs)),
                wall=wall, decode_steps=s.decode_steps, tokens_out=s.tokens_out,
                cache_capacity=eng.cache_capacity,
                block=list(eng.batch.serve["layers"][0]["paged"].k_pages.shape))
            del eng
            torch.cuda.empty_cache()
        err_, over, n_tok = gspmd_step_check(cfg, layout, mesh, max_batch,
                                             res["cases"][f"{layout}_chunked"]["cache_capacity"],
                                             dev)
        res["cases"][f"{layout}_step"] = dict(err=err_, excess=over, tokens=n_tok)
    for name, layout, model, max_batch, kw, workload in GSPMD_B_EXTRA:
        res["cases"][name] = gspmd_extra_case(cfg, params, dev, name, layout,
                                              meshes[model], max_batch, kw, workload)
    del params
    for name, arch, layers, h2, layout, model, max_batch, kw, workload in GSPMD_B_FAMILIES:
        f_cfg = family_config(arch, layers, h2)
        f_params = M.init_params(f_cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                 device=dev, dtype=torch.bfloat16)
        res["cases"][name] = gspmd_extra_case(f_cfg, f_params, dev, name, layout,
                                              meshes[model], max_batch, kw, workload)
        del f_params
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    return 0


def gspmd_extra_case(cfg, params, dev, name, layout, mesh, max_batch, kw, workload,
                     shards=1):
    """One of GSPMD_B_EXTRA's engines (or, with ``mesh`` None, the one-rank
    default engine of its options, or with ``shards`` > 1 the one-card
    ``coplace_shmap`` engine over that many stripes), chunked and eager, its
    tiered request forced cold: tokens, counters, the migrations' (src,
    dst), the pages forced, the launch counts and the wall time."""
    from repro_torch.serving.engine import Engine

    reqs, capacity = gspmd_workload(cfg, **workload)
    one_card = mesh is None and shards > 1
    eng = Engine(cfg, params, max_batch=max_batch, capacity=capacity,
                 prompt_buckets=sorted({len(r.prompt) for r in reqs}),
                 prefill_chunk=ENGINE_CHUNK,
                 layout=layout if mesh is not None or one_card else "default",
                 shards=shards, mesh=mesh, device=dev, eager=True, **kw)
    moves, migrate, calls, run = [], eng._migrate_slot, {}, eng._graphs.run

    def logged(src, dst):
        moves.append([src, dst])
        migrate(src, dst)

    def counted(step):
        calls[step] = calls.get(step, 0) + 1
        return run(step)
    eng._migrate_slot, eng._graphs.run = logged, counted
    got, wall, forced = serve_forced(eng, reqs, GSPMD_B_FORCE_AFTER if eng.hot_pages else None)
    s = eng.stats
    if eng.spec_tokens:
        expect = spec_launches(s, cfg.num_layers, SPEC_K, False)
    else:
        expect = gspmd_tiered_launches(s, cfg, attends_by_partials(eng) or one_card,
                                       calls.get("decode_select", 0) - s.select_steps)
        if one_card:  # the co-placed launch merges its stripes itself
            expect["combine_partials"] = 0
    out = dict(tokens={str(u): c.tokens for u, c in eng.completions.items()},
               block=block_shapes(eng.batch.serve),
               counters=counters(s, SPEC_COUNTERS + TIER_COUNTERS + REBALANCE_COUNTERS),
               mean_accepted_len=s.mean_accepted_len, moves=moves, forced=forced,
               launches=got, expect=expect, wall=wall, decode_steps=s.decode_steps,
               far=None if eng._tier is None else [eng._tier.h2d_bytes, eng._tier.d2h_bytes])
    del eng
    torch.cuda.empty_cache()
    return out


def block_shapes(serve) -> dict:
    """The rank's block shape of each kind of cache leaf of a serve state:
    {"paged": ..., "full": ..., "ssm": ..., "xl": ...} of its first layer of
    that kind (k_pages, k, ssm, C or c)."""
    out = {}
    for layer in serve["layers"]:
        for key, c in layer.items():
            if key not in out and key != "stream":
                out[key] = list(getattr(c, dataclasses.fields(c)[0].name).shape)
    return out


def time_gspmd_kernels(ops, ref, timer, dev, cfg, tag=""):
    """paged_attention_partial and combine_partials at phase 15's shapes, bf16:
    the decode step of the layouts that shard pages, 4 slots at contexts
    STRIPE_CTX of the 15a capacity (a top-128 selection of each slot's
    selectable pages, the [sink | selected | local] list), on one rank's
    block: the whole cache (a rank holding every page, which 15a serves
    with the default's kernels instead) and the first half of its pages
    (15b's rank 0 of the 'model' axis of 2), merged over N = 1 and N = 2
    partials. Returns (partial cases, combine cases), not in the kernel
    totals (``main`` False)."""
    from repro_torch.core import paging

    h2 = cfg.h2eal
    nr, _, g, d = head_split(cfg)
    p, top_k = h2.page_size, h2.top_k_pages
    cap = gspmd_workload(cfg, **GSPMD_A)[1]
    c = -(-cap // p)
    c += c % 2
    b = len(STRIPE_CTX)
    ctx = torch.tensor(STRIPE_CTX, device=dev)
    pg = torch.arange(c, device=dev)
    start = torch.where(pg[None] * p < ctx[:, None], pg[None] * p, -1)
    start = start[:, None, :].expand(b, nr, c).to(torch.int32).contiguous()
    rng = np.random.default_rng(4)
    sel = np.full((b, nr, top_k), -1, np.int64)
    for bi, n_ctx in enumerate(STRIPE_CTX):
        pages = np.arange(-(-h2.sink // p), max(n_ctx - h2.local, 0) // p)
        for hi in range(nr):
            pick = rng.permutation(pages)[:top_k]
            sel[bi, hi, :len(pick)] = pick
    slots = paging.attended_page_slots(torch.from_numpy(sel).to(dev).to(torch.int32), ctx,
                                       sink=h2.sink, local=h2.local, page=p)
    valid = paging.token_validity(slots, start, ctx, sink=h2.sink, local=h2.local, page=p,
                                  top_k=top_k)
    gen = torch.Generator(device=dev).manual_seed(22)
    q = torch.randn(b, nr * g, d, generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randn(b, nr, c, p, d, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(b, nr, c, p, d, generator=gen, device=dev).to(torch.bfloat16)
    parts, combs = [], []
    for n_ranks in (1, 2):
        c_l = c // n_ranks
        local = paging.block_slots(slots, 0, c_l)
        n = local.shape[2]
        v_l = (valid.reshape(b, nr, n, p) & (local >= 0)[..., None]).reshape(1, b, nr, -1)
        k_l, vv_l = kp[:, :, :c_l].contiguous(), vp[:, :, :c_l].contiguous()
        args = (q, k_l, vv_l, local[None].contiguous(), v_l.contiguous())
        run = lambda: ops.paged_attention_partial(*args)
        plain = lambda: ref.paged_attention_partial_pages_ref(*args)
        got = run()
        want = ref.paged_attention_partial_pages_ref(*widened(q, k_l, vv_l), *args[3:])
        torch.cuda.synchronize()
        n_valid = int(v_l.sum().item())
        b_ms, b_by = bound(nbytes(q, *args[3:], *got) + 2 * n_valid * d * 2,
                           4 * d * g * n_valid, torch.bfloat16)
        what = "every page on one rank" if n_ranks == 1 else "15b rank 0 of model 2"
        parts.append(dict(
            case=f"{tag}gspmd block ({what}) B={b} Hq={nr * g} Hr={nr} C={c_l} of {c} N={n} "
                 f"P={p} D={d} ctx={list(STRIPE_CTX)} valid={n_valid}", dtype="bfloat16",
            max_abs_err=max(err(a, w) for a, w in zip(got, want)),
            excess=partial_excess(got, want),
            tol="1e-4*max(l,1) (f32 outputs; m: 1e-4*max(|m|,1))", ms=timer.ms(run, 20),
            plain_ms=timer.ms(plain, 5), library_ms=None, bound_ms=b_ms, bound_by=b_by,
            main=False))
        m, l, o = (torch.cat([x] * n_ranks) for x in got)
        run_c = lambda: ops.combine_partials(m, l, o)
        plain_c = lambda: ref.combine_partials_ref(m, l, o)
        out, want_c = run_c(), plain_c()
        torch.cuda.synchronize()
        rows = b * nr * g
        b_ms, b_by = bound(nbytes(m, l, o, out), n_ranks * rows * (2 * d + 4), torch.float32)
        combs.append(dict(
            case=f"{tag}gspmd N={n_ranks} ({what}) B={b} Hq={nr * g} D={d}", dtype="bfloat16",
            max_abs_err=err(out, want_c), excess=excess(out, want_c, torch.float32),
            tol=tol_text(torch.float32), ms=timer.ms(run_c, 50),
            plain_ms=timer.ms(plain_c, 50), library_ms=None, bound_ms=b_ms, bound_by=b_by,
            main=False))
    return parts, combs


def time_shmap_kernels(ops, ref, timer, dev, cfg):
    """paged_attention_partial and combine_partials at a ``coplace_shmap``
    rank's stripe block, bf16: the decode step of 4 slots at contexts
    STRIPE_CTX (phase 6's striped inputs, ``stripe_inputs``) on rank 0 of a
    'model' axis of 2 and of 4, which holds the physical slots of stripe 0
    (the logical pages p % M == 0) and attends their part of the [sink |
    selected | local] list; the partials of the M ranks merged. Each held to
    its plain version and timed beside it, its bound, and the partial's
    yardstick the gather of the rank's pages then SDPA on them. Returns
    (partial cases, combine cases), not in the kernel totals."""
    from repro_torch.core import paging

    gen = torch.Generator(device=dev).manual_seed(25)
    parts, combs = [], []
    for m in (2, 4):
        q, kp, vp, slots, valid = stripe_inputs(gen, dev, cfg, torch.bfloat16, shards=m)
        b, hr, n = slots.shape
        g, d, p, c = q.shape[1] // hr, q.shape[2], kp.shape[3], kp.shape[2]
        c_l = c // m
        local = paging.block_slots(slots, 0, c_l)
        v_l = (valid.reshape(b, hr, n, p) & (local >= 0)[..., None]).reshape(1, b, hr, -1)
        k_l, vv_l = kp[:, :, :c_l].contiguous(), vp[:, :, :c_l].contiguous()
        args = (q, k_l, vv_l, local[None].contiguous(), v_l.contiguous())
        run = lambda: ops.paged_attention_partial(*args)
        plain = lambda: ref.paged_attention_partial_pages_ref(*args)
        got = run()
        want = ref.paged_attention_partial_pages_ref(*widened(q, k_l, vv_l), *args[3:])
        torch.cuda.synchronize()
        n_valid = int(v_l.sum().item())
        mask = v_l[0].repeat_interleave(g, dim=1)[:, :, None, :]
        gather_sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], *ref.gather_pages(k_l, vv_l, local), attn_mask=mask,
            enable_gqa=True)
        b_ms, b_by = bound(nbytes(q, *args[3:], *got) + 2 * n_valid * d * 2,
                           4 * d * g * n_valid, torch.bfloat16)
        what = f"coplace_shmap rank 0 of model {m}, stripe 0"
        parts.append(dict(
            case=f"{what} B={b} Hq={hr * g} Hr={hr} C={c_l} of {c} N={n} P={p} D={d} "
                 f"ctx={list(STRIPE_CTX)} valid={n_valid}", dtype="bfloat16",
            max_abs_err=max(err(a, w) for a, w in zip(got, want)),
            excess=partial_excess(got, want),
            tol="1e-4*max(l,1) (f32 outputs; m: 1e-4*max(|m|,1))", ms=timer.ms(run, 20),
            plain_ms=timer.ms(plain, 5), library_ms=timer.ms(gather_sdpa, 20),
            library="gather_pages + SDPA on the rank's stripe", bound_ms=b_ms,
            bound_by=b_by, main=False))
        mm, ll, oo = (torch.cat([x] * m) for x in got)
        run_c = lambda: ops.combine_partials(mm, ll, oo)
        plain_c = lambda: ref.combine_partials_ref(mm, ll, oo)
        out, want_c = run_c(), plain_c()
        torch.cuda.synchronize()
        rows = b * hr * g
        b_ms, b_by = bound(nbytes(mm, ll, oo, out), m * rows * (2 * d + 4), torch.float32)
        combs.append(dict(
            case=f"{what}: N={m} B={b} Hq={hr * g} D={d}", dtype="bfloat16",
            max_abs_err=err(out, want_c), excess=excess(out, want_c, torch.float32),
            tol=tol_text(torch.float32), ms=timer.ms(run_c, 50),
            plain_ms=timer.ms(plain_c, 50), library_ms=None, bound_ms=b_ms, bound_by=b_by,
            main=False))
        del q, kp, vp, k_l, vv_l, got, want
        torch.cuda.empty_cache()
    return parts, combs


def time_family_blocks(ops, ref, timer, dev):
    """The kernels of the other families on a rank's blocks, bf16, each held
    to its plain version and timed beside it, its bound and the PyTorch
    call: paged_attention and chunk_attention on a full-cache block (a
    gemma3-1b window layer at head_dim 256 on a 'data' rank of 2: one slot,
    its one kv head whole; llama3-8b with H²EAL off on a ``head`` rank of a
    'model' axis of 2: half its kv heads); paged_attention_partial and
    combine_partials where a layout cuts the pages, at zamba2-2.7b's
    attention layers (head_dim 80, 16 retrieval heads, GQA group 1) and
    gemma3-1b's global layer (head_dim 256, one retrieval head, group 4).
    Returns {kernel: cases}, not in the kernel totals."""
    out = {"paged_attention": [], "chunk_attention": [], "paged_attention_partial": [],
           "combine_partials": []}
    gen = torch.Generator(device=dev).manual_seed(24)
    g3 = family_config(G3_ARCH, 0, True)
    half = family_config(ARCH, 0, False)
    half = dataclasses.replace(half, num_kv_heads=half.num_kv_heads // 2,
                               num_heads=half.num_heads // 2)
    # (config, decode slots, chunk starts, what): a 'data' rank of 2 holds
    # half the slots, a head rank of 2 every slot and half the kv heads
    for cfg, batch, starts, what in (
            (g3, BATCH // 2, CHUNK_STARTS[ENGINE_BATCH // 2:],
             "gemma3-1b window layer, a 'data' rank of 2,"),
            (half, BATCH, CHUNK_STARTS, "llama3-8b H2EAL off, a head rank of model 2,")):
        cap = gspmd_workload(cfg, **GSPMD_A)[1]
        out["paged_attention"].append(dict(check_window_decode(
            ops, ref, timer, dev, cfg, torch.bfloat16, gen, PROMPT, batch=batch, what=what),
            main=False))
        out["chunk_attention"].append(dict(check_window_chunk(
            ops, ref, timer, dev, cfg, torch.bfloat16, gen, cap, starts=starts, what=what),
            main=False))
        torch.cuda.empty_cache()
    for arch in (Z_ARCH, G3_ARCH):
        parts, combs = time_gspmd_kernels(ops, ref, timer, dev, family_config(arch, 0, True),
                                          tag=f"{arch} ")
        out["paged_attention_partial"] += parts
        out["combine_partials"] += combs
        torch.cuda.empty_cache()
    return out


def phase15a(dev, cfg, params, mesh):
    """15a: an NCCL group of one rank on the card (``mesh``), llama3-8b at
    full width cut to GSPMD_A_LAYERS (``params``), captured steps: the
    default engine and each GSPMD layout's, packed and chunked, on
    GSPMD_A's workload (its last request sampled); launch counts exact, no
    capture after construction, no
    read from the card in a chunked step, tokens equal to the default
    engine's (one rank holds every page, and runs the default's kernels).
    Returns (launch counts by path, the traces by (layout, mode))."""
    from repro_torch.serving.engine import Engine

    reqs, capacity = gspmd_workload(cfg, **GSPMD_A, sampled=True)
    buckets = sorted({len(r.prompt) for r in reqs})
    log(f"15a: an NCCL group of one rank (backend {mesh.backend}, mesh {mesh.shape}); "
        f"{len(reqs)} requests on {ENGINE_BATCH} slots, prompts {buckets}, "
        f"{GSPMD_A['new']} new tokens each (uid {reqs[-1].uid} sampled: "
        f"{SPEC_SAMPLING}), capacity {capacity}, captured steps")
    by_path, traces, rates, steps = {}, {}, {}, {}
    for mode, chunk in (("chunked", ENGINE_CHUNK), ("packed", None)):
        for layout in ("default",) + GSPMD_LAYOUTS:
            t0 = time.perf_counter()
            eng = Engine(cfg, params, max_batch=ENGINE_BATCH, capacity=capacity,
                         prompt_buckets=buckets, prefill_chunk=chunk, layout=layout,
                         mesh=None if layout == "default" else mesh, device=dev)
            t_build = time.perf_counter() - t0
            sizes = eng.jit_cache_sizes()
            what = f"15a engine {layout} ({mode})"
            got, wall, _ = serve_polled(eng, reqs, what, guard=bool(chunk))
            s = eng.stats
            # one rank holds every page: each layout runs the default's kernels
            expect = gspmd_launches(s, cfg, attends_by_partials(eng),
                                    0 if chunk else len(reqs))
            if set(sizes.values()) != {1} or eng.jit_cache_sizes() != sizes:
                fail(f"{what}: captures {sizes} -> {eng.jit_cache_sizes()}")
            if got != expect:
                fail(f"{what} did not launch the kernels as expected: {got} vs {expect}")
            traces[(layout, mode)] = {u: c.tokens for u, c in eng.completions.items()}
            rates[(layout, mode)] = s.decode_steps / wall
            if layout == "default":
                steps = dict(launches=got, counts=step_counts(s), rate=rates[(layout, mode)])
            by_path[f"gspmd_{layout}_{mode}" if layout != "default"
                    else f"gspmd_default_{mode}"] = got
            blk = eng.batch.serve["layers"][0]["paged"].k_pages.shape
            log(f"{what}: {s.tokens_out} tokens, {s.decode_steps} decode steps in "
                f"{wall:.3f}s = {s.decode_steps / wall:.2f} decode steps/s "
                f"({s.tokens_out / wall:.2f} tok/s; default {rates[('default', mode)]:.2f} "
                f"decode steps/s); block {tuple(blk)}, construction {t_build:.2f}s, "
                f"captures {sizes}; launches partial {got['paged_attention_partial']} "
                f"combine {got['combine_partials']}")
            del eng
            torch.cuda.empty_cache()
        # one rank holds every page: each layout runs the default's kernels
        # on the same inputs, so its tokens are the default's exactly
        for layout in GSPMD_LAYOUTS:
            bad = first_divergence(traces[(layout, mode)], traces[("default", mode)])
            if bad is not None:
                fail(f"15a engine {layout} ({mode}): one rank runs the default's kernels "
                     f"on the same inputs, yet its tokens differ at (uid, index) {bad}")
            log(f"15a engine {layout} ({mode}): tokens equal to the default engine's")
        if chunk:
            by_path.update(phase15a_shmap(dev, cfg, params, mesh, reqs, capacity,
                                          traces, steps))
    return by_path, traces


def phase15a_shmap(dev, cfg, params, mesh, reqs, capacity, traces, steps):
    """15a's ``coplace_shmap`` engine over the NCCL rank, captured, chunked:
    one rank holds every stripe and runs the default's kernels, so its
    launch counts and step counts equal the default engine's; it selects a
    masked page as -1 where the default keeps it as fill (the reference's
    co-placed rule), so its tokens are held to the default's up to a
    near-tie. Returns its launch counts by path."""
    from repro_torch.serving.engine import Engine

    what = "15a engine coplace_shmap (chunked)"
    eng = Engine(cfg, params, max_batch=ENGINE_BATCH, capacity=capacity,
                 prompt_buckets=sorted({len(r.prompt) for r in reqs}),
                 prefill_chunk=ENGINE_CHUNK, layout="coplace_shmap", mesh=mesh, device=dev)
    sizes = eng.jit_cache_sizes()
    got, wall, _ = serve_polled(eng, reqs, what)
    s = eng.stats
    toks = {u: c.tokens for u, c in eng.completions.items()}
    if set(sizes.values()) != {1} or eng.jit_cache_sizes() != sizes:
        fail(f"{what}: captures {sizes} -> {eng.jit_cache_sizes()}")
    if eng._placed is None or eng._place.partials or eng.plan.page_stripe_shards != 1:
        fail(f"{what}: not placed on the one-rank mesh as one stripe")
    if got != steps["launches"] or step_counts(s) != steps["counts"]:
        fail(f"{what}: launches {got} or step counts {step_counts(s)} differ from the "
             f"default engine's {steps['launches']}, {steps['counts']}")
    ties = check_ties_split(cfg, params, reqs, toks, traces[("default", "chunked")],
                            capacity, dev, what)
    log(f"{what}: {s.tokens_out} tokens, {s.decode_steps} decode steps in {wall:.3f}s = "
        f"{s.decode_steps / wall:.2f} decode steps/s (default {steps['rate']:.2f}); "
        f"captures {sizes}; launches and step counts equal to the default's; tokens "
        f"equal to the default's {toks == traces[('default', 'chunked')]} (near-tie "
        f"divergences {ties})")
    del eng
    torch.cuda.empty_cache()
    return {"gspmd_coplace_shmap_chunked": got}


def step_counts(s) -> dict:
    """An engine run's step and token counts and its option counters."""
    return dict(counters(s, SPEC_COUNTERS + TIER_COUNTERS + REBALANCE_COUNTERS),
                decode_steps=s.decode_steps, select_steps=s.select_steps,
                reuse_steps=s.reuse_steps, prefill_chunks=s.prefill_chunks,
                tokens_out=s.tokens_out)


def check_verify_blocks(ops, ref, timer, dev, cfg):
    """chunk_attention at the speculative verify's shapes on a rank's block
    (bf16, k = SPEC_K, 4 slots at contexts STRIPE_CTX of the 15a capacity):
    the whole buffer, as 15c's one rank attends it and as every rank of a
    layout that shards pages attends it once the owners' tiles are summed;
    and ``head``'s rank of a 'model' axis of 2, half the kv heads. Each held
    to its plain version with the bf16 bound of phase 2, timed beside it,
    SDPA and its bound. Returns the cases, not in the kernel totals."""
    gen = torch.Generator(device=dev).manual_seed(23)
    cap = gspmd_workload(cfg, **GSPMD_A)[1]
    g = head_split(cfg)[2]
    cases = []
    for kind, (q, kb, vb, valid, _) in verify_attention_inputs(
            gen, dev, cfg, torch.bfloat16, cap, SPEC_K).items():
        for what, n_h in (("one rank / a page-sharding rank, summed buffer", kb.shape[1]),
                          ("head rank of model 2", kb.shape[1] // 2)):
            qh, kh, vh = (q[:, :, :n_h * g].contiguous(), kb[:, :n_h].contiguous(),
                          vb[:, :n_h].contiguous())
            vd = valid[:, :n_h].contiguous()
            run = lambda: ops.chunk_attention(qh, kh, vh, vd)
            out = run()
            want = ref.chunk_attention_ref(*widened(qh, kh, vh), vd)
            p_term = ref.chunk_attention_ref(*widened(qh, kh, vh.abs()), vd)
            torch.cuda.synchronize()
            lib_mask = vd.repeat_interleave(g, dim=1)
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                qh.transpose(1, 2), kh, vh, attn_mask=lib_mask, enable_gqa=True)
            keys = int(vd.any(dim=2).sum().item())
            b_ms, b_by = bound(nbytes(qh, vd, out) + 2 * keys * kh.shape[-1] * 2,
                               4 * kh.shape[-1] * g * int(vd.sum().item()), torch.bfloat16)
            cases.append(dict(
                case=f"verify on a rank's block ({what}) {kind} k={SPEC_K} B={qh.shape[0]} "
                     f"Hq={qh.shape[2]} Hkv={kh.shape[1]} T={kh.shape[2]} D={qh.shape[3]}",
                dtype="bfloat16", max_abs_err=err(out, want),
                excess=p_excess(out, want, p_term), tol=P_TOL_TEXT, ms=timer.ms(run, 10),
                plain_ms=timer.ms(lambda: ref.chunk_attention_ref(qh, kh, vh, vd), 3),
                library_ms=timer.ms(lib, 10), bound_ms=b_ms, bound_by=b_by, main=False))
        del q, kb, vb, valid
        torch.cuda.empty_cache()
    return cases


def phase15c(dev, cfg, params, mesh, traces, card):
    """15c: in 15a's NCCL group of one rank, llama3-8b at full width and
    depth, captured: each GSPMD layout beside the default with speculative
    decode (k = SPEC_K; the n-gram draft chunked, the replay draft of the
    layout's own 15a trace packed), with tiered residency (TIER_HOT_PAGES,
    the first decoding request forced cold at a selection boundary after
    TIER_FORCE_AFTER decode steps) and, on ``coplace`` and ``interleave``,
    with retire-triggered rebalancing; GSPMD_A's workload, one request
    sampled. Tokens are held to 15a's ``traces`` of the same layout and to
    the default engine's; launch counts exact. Returns launch counts by
    path."""
    from repro_torch.core import cache as cachelib
    from repro_torch.serving.draft import ReplayDraft
    from repro_torch.serving.engine import Engine

    reqs, capacity = gspmd_workload(cfg, **GSPMD_A, sampled=True)
    base = dict(max_batch=ENGINE_BATCH, capacity=capacity,
                prompt_buckets=sorted({len(r.prompt) for r in reqs}), device=dev)
    n_l = cfg.num_layers
    by_path, spec, tier = {}, {}, {}
    mesh_of = lambda layout: None if layout == "default" else mesh

    def build(layout, what, **kw):
        eng = Engine(cfg, params, layout=layout, mesh=mesh_of(layout), **base, **kw)
        sizes = eng.jit_cache_sizes()
        if set(sizes.values()) != {1}:
            fail(f"{what}: captures {sizes}")
        return eng, sizes

    def held(eng, sizes, got, expect, what):
        if got != expect:
            fail(f"{what} did not launch the kernels as expected: {got} vs {expect}")
        if eng.jit_cache_sizes() != sizes:
            fail(f"{what} captured again while serving: {sizes} -> {eng.jit_cache_sizes()}")
        return {u: c.tokens for u, c in eng.completions.items()}

    # speculative decode
    for layout in ("default",) + GSPMD_LAYOUTS:
        for draft, mode, chunk in (("ngram", "chunked", ENGINE_CHUNK), ("replay", "packed", None)):
            what = f"15c engine {layout} (spec {draft}, {mode})"
            eng, sizes = build(layout, what, prefill_chunk=chunk, spec_tokens=SPEC_K,
                               draft=draft if draft == "ngram" else
                               ReplayDraft(traces[(layout, mode)]))
            times = ReplayTimes(eng._graphs)
            got, wall, _ = serve_forced(eng, reqs)
            s = eng.stats
            expect = dict(spec_launches(s, n_l, SPEC_K, False),
                          flash_attention=0 if chunk else
                          layer_launches(cfg)["prefill"] * len(reqs))
            toks = held(eng, sizes, got, expect, what)
            own = check_ties_split(cfg, params, reqs, toks, traces[(layout, mode)], capacity,
                                   dev, what + " against its non-speculative engine")
            ms = times.median_ms()["verify"]
            spec[(layout, draft)] = (toks, ms, s.mean_accepted_len)
            d_toks, d_ms, d_acc = spec[("default", draft)]
            # one rank: the default's kernels on the same inputs (the verify
            # attends through chunk_attention, the decode through
            # paged_attention, so against the non-speculative engine only up
            # to a near-tie, as in phase 8)
            if toks != d_toks or s.mean_accepted_len != d_acc:
                fail(f"{what}: tokens or acceptance differ from the default layout's "
                     f"speculative engine's ({first_divergence(toks, d_toks)}, "
                     f"{s.mean_accepted_len} vs {d_acc})")
            by_path[f"gspmd_spec_{layout}_{draft}"] = got
            log(f"{what} on {card}: {s.tokens_out} tokens in {wall:.3f}s = "
                f"{s.tokens_out / wall:.2f} tok/s; verify steps {s.spec_steps}, median "
                f"device ms a verify step {ms:.4f} (default {d_ms:.4f}), mean accepted "
                f"length {s.mean_accepted_len:.3f} (default {d_acc:.3f}); tokens equal the "
                f"layout's non-speculative engine's {toks == traces[(layout, mode)]} "
                f"(near-tie divergences {own}), equal to the default's")
            del eng, times
            torch.cuda.empty_cache()

    # tiered residency
    for layout in ("default",) + GSPMD_LAYOUTS:
        what = f"15c engine {layout} (tiered, hot_pages={TIER_HOT_PAGES})"
        eng, sizes = build(layout, what, prefill_chunk=ENGINE_CHUNK, hot_pages=TIER_HOT_PAGES)
        calls, run = {}, eng._graphs.run

        def counted(step, run=run, calls=calls):
            calls[step] = calls.get(step, 0) + 1
            return run(step)
        eng._graphs.run = counted
        got, wall, forced = serve_forced(eng, reqs, TIER_FORCE_AFTER)
        s, t = eng.stats, eng._tier
        # a page's K and V rows in every layer: one rank's block is the whole cache
        page = sum(x[0, :, 0].nbytes for x in cachelib.kv_page_tensors(eng.batch.serve))
        expect = gspmd_tiered_launches(s, cfg, attends_by_partials(eng),
                                       calls["decode_select"] - s.select_steps)
        toks = held(eng, sizes, got, expect, what)
        if toks != traces[(layout, "chunked")]:
            fail(f"{what}: tokens differ from the all-resident engine's at "
                 f"{first_divergence(toks, traces[(layout, 'chunked')])}")
        if forced is None or forced[1] == 0 or not s.tier_misses == s.tier_fills > 0:
            fail(f"{what}: forced {forced}, misses {s.tier_misses}, fills {s.tier_fills}: "
                 f"the forced request must miss and be filled")
        c = counters(s, TIER_COUNTERS)
        tier[layout] = c
        if c != tier["default"]:
            fail(f"{what}: tier counters {c} differ from the default layout's "
                 f"{tier['default']}")
        if (t.h2d_bytes, t.d2h_bytes) != ((s.tier_fills + s.tier_prefetch) * page,
                                          s.tier_archived * page):
            fail(f"{what}: the far store moved {t.h2d_bytes} / {t.d2h_bytes} B, the "
                 f"counters say {(s.tier_fills + s.tier_prefetch) * page} / "
                 f"{s.tier_archived * page}")
        rate = {d: (b, ms, b / (ms * 1e-3) / 1e9) for d, (b, ms) in t.transfer_times().items()}
        by_path[f"gspmd_tiered_{layout}"] = got
        log(f"{what} on {card}: {s.tokens_out} tokens in {wall:.3f}s; tokens equal the "
            f"all-resident engine's; uid {forced[0]} forced cold ({forced[1]} pages); tier "
            f"counters {c} (equal to the default layout's); far store "
            + ", ".join(f"{d} {b} B in {ms:.3f} ms = {r:.2f} GB/s"
                        for d, (b, ms, r) in sorted(rate.items())))
        del eng
        torch.cuda.empty_cache()

    # rebalancing: a CPU run of this schedule moves slot 3 to slot 0
    for layout in ("coplace", "interleave"):
        what = f"15c engine {layout} (rebalanced, retire)"
        eng, sizes = build(layout, what, prefill_chunk=ENGINE_CHUNK, rebalance="retire")
        got, wall, _ = serve_polled(eng, reqs, what)
        s = eng.stats
        toks = held(eng, sizes, got, gspmd_launches(s, cfg, attends_by_partials(eng), 0),
                    what)
        if toks != traces[(layout, "chunked")]:
            fail(f"{what}: tokens differ from rebalance off's at "
                 f"{first_divergence(toks, traces[(layout, 'chunked')])}")
        if s.migrations < 1 or sizes.get("migrate") != 1:
            fail(f"{what}: migrations {s.migrations}, captures {sizes}")
        by_path[f"gspmd_rebalanced_{layout}"] = got
        log(f"{what} on {card}: {s.tokens_out} tokens in {wall:.3f}s; tokens equal "
            f"rebalance off's; checks {s.rebalance_checks} applied {s.rebalances} "
            f"migrations {s.migrations} ({s.migrated_tokens} tokens), {eng.rebalance_banks} "
            f"banks; migrate captured once")
        del eng
        torch.cuda.empty_cache()
    return by_path


def phase15b(dev, card):
    """15b: two ranks that share cuda:0 over gloo (spawned, each ``chip_smoke.py
    --gspmd-rank``), llama3-8b at full width cut to GSPMD_CUT layers, eager
    steps: head, coplace and coplace_shmap on (1, 2), interleave on (2, 1) at
    3 slots; both ranks' tokens equal to each other's and to the one-rank
    default engine's at the same cut (up to a near-tie; coplace_shmap's
    first to the one-card engine over 2 stripes), the launch counts exact
    on each rank, one decode step's attention output within a bf16 step of
    the default's (coplace_shmap's: the one-card body's). Returns the launch
    counts by path (rank 0's)."""
    from repro_torch.configs import get_arch
    from repro_torch.serving.engine import Engine

    log("15b: two ranks share cuda:0; their collectives go through gloo (host copies). "
        "NCCL at two or more ranks, one a card, waits for a four-card check")
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=GSPMD_CUT)
    params = full_params(dev, cfg)
    reqs, capacity = gspmd_workload(cfg, **GSPMD_B)
    buckets = sorted({len(r.prompt) for r in reqs})
    want, want_shmap = {}, {}
    for mode, chunk in (("chunked", ENGINE_CHUNK), ("packed", None)):
        for layout, shards, into in (("default", 1, want), ("coplace_shmap", 2, want_shmap)):
            eng = Engine(cfg, params, max_batch=2, capacity=capacity,
                         prompt_buckets=buckets, prefill_chunk=chunk, layout=layout,
                         shards=shards, device=dev, eager=True)
            t0 = time.perf_counter()
            into[mode] = {str(u): c.tokens for u, c in eng.run(reqs).items()}
            log(f"15b {layout} engine at the cut ({mode}, one card, {shards} stripes): "
                f"{eng.stats.decode_steps} decode steps in {time.perf_counter() - t0:.3f}s")
            del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    os.makedirs(SMOKE_DIR, exist_ok=True)
    store, out = os.path.join(SMOKE_DIR, "gloo2.store"), os.path.join(SMOKE_DIR, "gloo2")
    for path in [store] + [f"{out}.{r}" for r in range(2)]:
        if os.path.exists(path):
            os.remove(path)
    log(f"15b: card memory before the spawn {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gspmd-rank",
                               str(r), store, out], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=GSPMD_TIMEOUT)[0].decode(errors="replace"))
    finally:
        for pr in procs:  # a rank still running when another failed
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, pr in enumerate(procs):
        if pr.returncode != 0:
            fail(f"15b rank {r} exited {pr.returncode}:\n{logs[r][-4000:]}")
    res = []
    for r in range(2):
        with open(f"{out}.{r}") as f:
            res.append(json.load(f))
    log(f"15b: two ranks in {time.perf_counter() - t0:.1f}s; gloo on card tensors takes "
        f"{res[0]['probe']}")
    by_path = {}
    for layout, model, max_batch in GSPMD_B_CASES:
        for mode in ("chunked", "packed"):
            key = f"{layout}_{mode}"
            a, b = res[0]["cases"][key], res[1]["cases"][key]
            what = f"15b engine {layout} ({mode})"
            for r, c in enumerate((a, b)):
                if c["launches"] != c["expect"]:
                    fail(f"{what} rank {r} did not launch the kernels as expected: "
                         f"{c['launches']} vs {c['expect']}")
            if a["tokens"] != b["tokens"]:
                fail(f"{what}: the two ranks' tokens differ")
            got = {int(u): t for u, t in a["tokens"].items()}
            if layout == "coplace_shmap":  # the one-card engine over 2 stripes first
                shmap_ties = check_ties(cfg, params, reqs, got,
                                        {int(u): t for u, t in want_shmap[mode].items()}, {},
                                        capacity, dev, BF16_LOGIT_BAND,
                                        f"{what} against the one-card engine", relative=True)
                log(f"{what}: tokens equal to the one-card engine's over 2 stripes "
                    f"{a['tokens'] == want_shmap[mode]} (near-tie divergences {shmap_ties})")
            ties = check_ties(cfg, params, reqs, got,
                              {int(u): t for u, t in want[mode].items()}, {}, capacity, dev,
                              BF16_LOGIT_BAND, what, relative=True)
            log(f"{what} on mesh {a['mesh']} ({max_batch} slots, rank blocks "
                f"{a['block']} of the paged cache): tokens equal across ranks, equal to "
                f"the default engine's {a['tokens'] == want[mode]} (near-tie divergences "
                f"{ties}); {a['decode_steps']} decode steps in {a['wall']:.3f}s = "
                f"{a['decode_steps'] / a['wall']:.2f} decode steps/s; launches rank 0 "
                f"{a['launches']}")
            by_path[f"gspmd2_{layout}_{mode}"] = a["launches"]
        st = [res[r]["cases"][f"{layout}_step"] for r in range(2)]
        log(f"15b decode step {layout}: attention output against the default layout's, "
            f"max |diff| {max(x['err'] for x in st):.3e}, excess over "
            f"{GSPMD_STEP_RTOL:g}*|ref|+{GSPMD_STEP_ATOL:g} "
            f"{max(x['excess'] for x in st):.3e} ({st[0]['tokens']} context tokens)")
        if max(x["excess"] for x in st) > 0:
            fail(f"15b decode step {layout}: the attention output leaves the band")
    by_path.update(check_gspmd_extra(cfg, params, dev, res))
    del params
    torch.cuda.empty_cache()
    by_path.update(check_gspmd_families(dev, res))
    return by_path


def phase15d(dev, mesh, card):
    """15d: in 15a's NCCL group of one rank, the other families served by the
    captured chunked engine of the default layout and of each GSPMD layout
    (GSPMD_D_MODELS: zamba2-2.7b, xlstm-125m and gemma3-1b whole, qwen3-moe
    cut to MOE_LAYERS, llama3-8b with H²EAL off), one request sampled: no
    capture after construction; one rank holds every page and row and runs
    the default's kernels on the same inputs, so each layout's tokens, its
    counters and its launch counts equal the default's exactly. Returns the
    launch counts by path."""
    from repro_torch.serving.engine import Engine

    by_path = {}
    for label, arch, layers, h2, max_batch, chunk, workload in GSPMD_D_MODELS:
        t0 = time.perf_counter()
        cfg = family_config(arch, layers, h2)
        params = full_params(dev, cfg)
        reqs, capacity = gspmd_workload(cfg, **workload, sampled=True)
        runs, rates = {}, {}
        for layout in ("default",) + GSPMD_LAYOUTS:
            what = f"15d engine {cfg.name}{'' if h2 else ' (H2EAL off)'} {layout} (chunked)"
            eng = Engine(cfg, params, max_batch=max_batch, capacity=capacity,
                         prompt_buckets=sorted({len(r.prompt) for r in reqs}),
                         prefill_chunk=chunk, layout=layout,
                         mesh=None if layout == "default" else mesh, device=dev)
            sizes = eng.jit_cache_sizes()
            got, wall, _ = serve_polled(eng, reqs, what)
            s = eng.stats
            if set(sizes.values()) != {1} or eng.jit_cache_sizes() != sizes:
                fail(f"{what}: captures {sizes} -> {eng.jit_cache_sizes()}")
            runs[layout] = ({u: c.tokens for u, c in eng.completions.items()},
                            counters(s, TIER_COUNTERS + REBALANCE_COUNTERS), got)
            toks, cnt, launched = runs[layout]
            d_toks, d_cnt, d_launched = runs["default"]
            if (toks, cnt, launched) != (d_toks, d_cnt, d_launched):
                fail(f"{what}: one rank runs the default's kernels on the same inputs, yet "
                     f"tokens ({first_divergence(toks, d_toks)}), counters ({cnt} vs "
                     f"{d_cnt}) or launches ({launched} vs {d_launched}) differ")
            by_path[f"gspmd_{label}_{layout}"] = got
            rates[layout] = s.decode_steps / wall
            log(f"{what} on {card}: {s.tokens_out} tokens, {s.decode_steps} decode steps in "
                f"{wall:.3f}s = {rates[layout]:.2f} decode steps/s (default "
                f"{rates['default']:.2f}); rank blocks {block_shapes(eng.batch.serve)}; "
                f"captures {sizes}; launches {got}; tokens, counters and launches equal to "
                f"the default's")
            del eng
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
        log(f"15d {label}: {time.perf_counter() - t0:.1f}s")
    return by_path


def check_gspmd_extra(cfg, params, dev, res):
    """15b's further cases (GSPMD_B_EXTRA) of both ranks' results ``res``
    against each other and the one-rank default engine with the same
    options, run here (``check_gspmd_case``). Returns rank 0's launch counts
    by path."""
    return {f"gspmd2_{name}_{layout}": check_gspmd_case(
        cfg, params, dev, res, name, layout, model, max_batch, kw, workload)
        for name, layout, model, max_batch, kw, workload in GSPMD_B_EXTRA}


def check_gspmd_families(dev, res):
    """15b's other families (GSPMD_B_FAMILIES), each held as
    ``check_gspmd_case`` holds a further case, on its own config and seeded
    weights. Returns rank 0's launch counts by path."""
    by_path = {}
    for name, arch, layers, h2, layout, model, max_batch, kw, workload in GSPMD_B_FAMILIES:
        cfg = family_config(arch, layers, h2)
        params = full_params(dev, cfg)
        by_path[f"gspmd2_{name}_{layout}"] = check_gspmd_case(
            cfg, params, dev, res, name, layout, model, max_batch, kw, workload)
        del params
        torch.cuda.empty_cache()
    return by_path


def check_gspmd_case(cfg, params, dev, res, name, layout, model, max_batch, kw, workload):
    """One 15b case of both ranks' results ``res`` against each other and the
    one-rank default engine with the same options, run here: launch counts
    exact, tokens and counters equal across ranks, tokens equal to the
    default's up to a near-tie and counters equal to its (where the tokens
    are), a forced request missed and filled, a migration that crossed
    ranks. Returns rank 0's launch counts."""
    one = gspmd_extra_case(cfg, params, dev, name, layout, None, max_batch, kw, workload)
    a, b = res[0]["cases"][name], res[1]["cases"][name]
    what = (f"15b engine {cfg.name} {layout} ({name}, mesh (data, model) = "
            f"{(2 // model, model)})")
    held = [("one-rank default", one)]
    if layout == "coplace_shmap":
        # the one-card engine over as many stripes: the same select rule
        held.insert(0, ("one-card engine over 2 stripes", gspmd_extra_case(
            cfg, params, dev, name, layout, None, max_batch, kw, workload, shards=model)))
    for r, c in [("rank 0", a), ("rank 1", b)] + held:
        if c["launches"] != c["expect"]:
            fail(f"{what} {r} did not launch the kernels as expected: {c['launches']} "
                 f"vs {c['expect']}")
    if a["tokens"] != b["tokens"] or a["counters"] != b["counters"]:
        fail(f"{what}: the two ranks' tokens or counters differ")
    w_reqs, w_cap = gspmd_workload(cfg, **workload)
    ties = {label: check_ties(cfg, params, w_reqs,
                              {int(u): t for u, t in a["tokens"].items()},
                              {int(u): t for u, t in c["tokens"].items()}, {}, w_cap, dev,
                              BF16_LOGIT_BAND, f"{what} against the {label}", relative=True)
            for label, c in held}
    # the counters are held to the engine of the same select rule (the
    # default's tier hits count the masked pages it keeps as fill, which
    # coplace_shmap selects as -1)
    label, one = held[0]
    if not ties[label] and a["counters"] != one["counters"]:
        fail(f"{what}: counters {a['counters']} differ from the {label}'s "
             f"{one['counters']}")
    if "tiered" in name and not (a["forced"] and a["forced"][1] > 0
                                 and a["counters"]["tier_misses"]
                                 == a["counters"]["tier_fills"] > 0):
        fail(f"{what}: forced {a['forced']}, counters {a['counters']}: the forced "
             f"request must miss and be filled")
    if "tiered" in name and [x + y for x, y in zip(a["far"], b["far"])] != one["far"]:
        fail(f"{what}: the ranks' far stores moved {a['far']} + {b['far']} B, the "
             f"one-rank engine {one['far']}: each page's rows lie on one rank")
    rows = max_batch // (2 // model)
    if "rebalanced" in name and not any(s_ // rows != d_ // rows for s_, d_ in a["moves"]):
        fail(f"{what}: no migration moved a slot's row to the other rank ({a['moves']})")
    if "spec" in name and not a["counters"]["spec_steps"] > 0:
        fail(f"{what}: no verify step ran")
    log(f"{what}: tokens and counters equal across ranks; equal to the {label}'s "
        f"{a['tokens'] == one['tokens']} (near-tie divergences {ties}), counters "
        f"equal {a['counters'] == one['counters']} (the one-rank default's "
        f"{a['counters'] == held[-1][1]['counters']}) "
        f"{ {k: v for k, v in a['counters'].items() if v} }; mean accepted length "
        f"{a['mean_accepted_len']:.3f} ({label} {one['mean_accepted_len']:.3f}); "
        f"migrations {a['moves']}; forced cold {a['forced']}; far-store bytes rank 0 "
        f"{a['far']} rank 1 {b['far']} ({label} {one['far']}); rank blocks {a['block']} "
        f"({label} {one['block']}); {a['decode_steps']} decode steps in {a['wall']:.3f}s "
        f"({label} {one['wall']:.3f}s); launches rank 0 {a['launches']}")
    return a["launches"]


def phase15(ops, ref, dev, card):
    """Phase 15: the GSPMD layouts. Returns (launches by path, partial cases,
    combine cases, verify cases)."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as meshlib

    t15 = time.perf_counter()
    cfg = get_arch(ARCH)
    timer = Timer(dev)
    parts, combs = time_gspmd_kernels(ops, ref, timer, dev, cfg)
    s_parts, s_combs = time_shmap_kernels(ops, ref, timer, dev, cfg)
    parts, combs = parts + s_parts, combs + s_combs
    verify = check_verify_blocks(ops, ref, timer, dev, cfg)
    family = time_family_blocks(ops, ref, timer, dev)
    del timer
    for c in parts + combs + verify + [c for cases in family.values() for c in cases]:
        log(f"phase 15 kernel [{c['case']}] kernel_ms={c['ms']:.4f} "
            f"plain_ms={c['plain_ms']:.4f} bound_ms={c['bound_ms']:.4f} ({c['bound_by']}) "
            + (f"library_ms={c['library_ms']:.4f} " if c["library_ms"] is not None else "")
            + f"max_err={c['max_abs_err']:.3e} excess={c['excess']:.3e} (tol {c['tol']})")
        if not c["excess"] <= 0.0:
            fail(f"phase 15 kernel case disagrees with its plain version: {c['case']}")
    cfg = dataclasses.replace(cfg, num_layers=GSPMD_A_LAYERS)
    params = full_params(dev, cfg)
    os.makedirs(SMOKE_DIR, exist_ok=True)
    store = os.path.join(SMOKE_DIR, "nccl1.store")
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(dev)
    meshlib.init_distributed("nccl", store_path=store, rank=0, world_size=1)
    mesh = meshlib.make_local_mesh()
    by_path, traces = phase15a(dev, cfg, params, mesh)
    t15c = time.perf_counter()
    by_path.update(phase15c(dev, cfg, params, mesh, traces, card))
    log(f"15c (speculative, tiered, rebalanced on the GSPMD layouts) "
        f"{time.perf_counter() - t15c:.1f}s")
    t16a = time.perf_counter()
    by_path.update(phase16a(dev, cfg, params, mesh))
    log(f"16a (tensor-parallel generate on one NCCL rank) {time.perf_counter() - t16a:.1f}s")
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t15d = time.perf_counter()
    by_path.update(phase15d(dev, mesh, card))
    log(f"15d (the other families on the GSPMD layouts) {time.perf_counter() - t15d:.1f}s")
    dist.destroy_process_group()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    by_path.update(phase15b(dev, card))
    log(f"phase 15 (the GSPMD layouts on torch.distributed ranks) "
        f"{time.perf_counter() - t15:.1f}s")
    return by_path, parts, combs, verify, family


# ---------------------------------------------------------------------------
# Phase 16: the reference's tensor-parallel generate(mesh=...) and its sharded
# train step on torch.distributed ranks (ROADMAP item 9c)
# ---------------------------------------------------------------------------

TP_LAYOUTS = ("default", "head", "coplace", "interleave", "coplace_shmap")
# 16a: BATCH prompts of TP_A_PROMPT tokens, TP_GEN tokens, at full depth
TP_A_PROMPT, TP_GEN = 8192, 16
# 16b: llama3-8b cut to TP_CUT layers (8 took 15-26 s over gloo on an H100),
# BATCH prompts of TP_B_PROMPT; each layout on a (data, model) mesh of the
# two ranks: the batch over 'data' on (2, 1), the weights over 'model' on
# (1, 2)
TP_CUT, TP_B_PROMPT = 4, 2048
TP_B_GENERATE = (("default", 1), ("head", 2), ("coplace", 2), ("coplace_shmap", 2),
                 ("interleave", 1))
# the sharded step, f32: (label, arch, layers (0: whole depth), B, S, {the
# 'model' size of a mesh: its steps}); the one-card reference takes the most
# steps. (1, 2) over gloo took 22-30 s a step at smollm-360m's B = 8 x S =
# 2048 (the layers' gathers and sums and the logits' gather pass through the
# host: ~24 GB a step), so it takes one step at S = 1024 (two took 14.9-17.7
# s each), and (2, 1) 3 at 1024 (18-25 s at 2048; its third step shows the
# second's AdamW update, which a step after the lr-0 warm-up step alone
# would not). smollm-360m's rule keeps FSDP off,
# llama3-8b's turns it on (12 bytes a parameter over 8e9). llama3-8b at 2
# layers (1.49e9 params): the two ranks share one card, and at 4 layers
# each rank's functional AdamW step (old and new parameters and moments,
# the gradient: 2.1 GB of embedding whole on each, its rule cuts the
# vocabulary over 'model' only) took 31 GiB a rank, 77.3 GiB of the card
# with this process's, and ran out of memory; one step (its second, the
# first after warm-up, checked no update and took 10-15 s)
TP_TRAIN = (("smollm", "smollm-360m", 0, 8, 1024, {1: 3}),
            ("smollm_tp", "smollm-360m", 0, 8, 1024, {2: 1}),
            ("llama", "llama3-8b", 2, 2, 2048, {1: 1}))
# loss and grad norm of the sharded step against the one-rank step: f32
# sums in other orders (a row product's partials, the 'data' halves of the
# gradient) through every layer and its backward
TP_TRAIN_RTOL = 1e-4
# the training CLI over the two ranks: 4 steps, a checkpoint every 2, a
# crash after 3 (resumed from the checkpoint of step 1); reduced smollm-360m
# (the crash, the whole checkpoints and the restores are what it checks: at
# full width its gradient sum over gloo took 44 s of the smoke)
TP_CLI = ["--arch", "smollm-360m", "--reduced", "--steps", "4", "--batch", "4", "--seq",
          "512", "--ckpt-every", "2", "--log-every", "1"]
TP_CLI_CRASH = 3
TP_TIMEOUT = 900
# 16c (ROADMAP item 9d): the MoE, recurrent and local:global families on the
# same two ranks, ``generate`` on each TP_C_LAYOUTS layout on (1, 2) and (2,
# 1): (label, arch, layers (0: all), prompt). qwen3-moe at full width, all
# 128 experts (4.83 GB a layer in bf16; (2, 1) puts 64 on a rank), cut to 2
# of 94 layers; zamba2 to one period (5 mamba2 layers and its attention
# layer) of 9; xlstm-125m and gemma3-1b whole (xlstm's prompt is shorter:
# its recurrences are per-token loops on the host)
TP_C_LAYOUTS = ("default", "head")
TP_C_SERVE = (("qwen3_moe", "qwen3-moe-235b-a22b", 2, 1024),
              ("zamba2", "zamba2-2.7b", 6, 1024),
              ("xlstm", "xlstm-125m", 0, 256),
              ("gemma3", "gemma3-1b", 0, 1024))
# 16c's new tokens: the (1, 2) meshes step each layer's gathers through the
# host (2.7-11.2 decode steps/s on an H100 at 700 W)
TP_C_GEN = 8
# the sharded step, f32, at full width with the fewest layers that fit:
# (label, arch, layers, experts (0: all), B, S, {the 'model' size of a mesh:
# steps}). qwen3-moe's one layer with 128 experts holds 3.8e9 parameters:
# its f32 parameters, gradient and AdamW moments alone are ~60 GB, and the
# functional AdamW step holds the old and the new of each, so the experts
# are cut to 32 (top-8, d_model and the expert d_ff kept); even so a (2, 1)
# rank holds the 2.5 GB embedding whole (its rule cuts the vocabulary over
# 'model' only) and would peak near 41 GB, two of them beyond the card, so
# it trains on (1, 2), its experts over 'model' (31.0 GiB a rank, the one-card
# step 62.9 GiB, on an H100). xlstm-125m at S = 64: its recurrences are
# per-token loops (11-25 s a step at 256, 11-14 s at 128)
TP_C_TRAIN = (("qwen3_moe", "qwen3-moe-235b-a22b", 1, 32, 2, 1024, {2: 1}),
              ("zamba2", "zamba2-2.7b", 6, 0, 2, 2048, {1: 1}),
              ("xlstm", "xlstm-125m", 0, 0, 2, 64, {1: 1}),
              ("gemma3", "gemma3-1b", 6, 0, 2, 1024, {1: 1}))
# one step each: the first step (lr 0 under the one-step warm-up) gives the
# loss and the gradient's norm, the quantities compared; a second step took
# 2.5-13.0 s more on the ranks. The families whose one-card step runs a
# 'data' rank's rows at a time (microbatches = the 'data' ranks):
# xlstm-125m's first step, at random init, put the whole batch's grad norm
# 7.4e-4 (relative) from the two ranks' at S = 256 on an H100 while the
# loss agreed to 1e-8: its exponential gates amplify the rounding of a
# product over another row count. The split step computes the ranks'
# products, so it is the one held to TP_TRAIN_RTOL
TP_C_SPLIT = ("xlstm",)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _release(dev) -> None:
    """Free what a finished run left: its cyclic garbage (a remat step's
    graph can hold its activations), then the allocator's cache."""
    import gc

    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def tp_requests(prompts, new):
    """Requests of the lockstep prompts, for ``check_ties``."""
    from repro_torch.serving.engine import Request

    return [Request(uid=b, prompt=prompts[b].cpu().numpy(), max_new=new)
            for b in range(prompts.shape[0])]


def tp_prompts(cfg, prompt, dev):
    gen = torch.Generator(device=dev).manual_seed(16)
    return torch.randint(0, cfg.vocab_size, (BATCH, prompt), generator=gen, device=dev)


def phase16a(dev, cfg, params, mesh):
    """16a: in 15a's NCCL group of one rank, ``generate(mesh=...)`` of each
    layout against ``generate(mesh=None)`` at 15a's cut. Returns the launch
    counts by path."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate

    capacity = TP_A_PROMPT + TP_GEN + cfg.h2eal.page_size
    prompts = tp_prompts(cfg, TP_A_PROMPT, dev)
    reqs = tp_requests(prompts, TP_GEN)
    ops.reset_launches()
    want, ws = generate(cfg, params, prompts, gen=TP_GEN, capacity=capacity, device=dev)
    want_l = dict(ops.LAUNCHES)
    log(f"16a generate(mesh=None) {cfg.name} B={BATCH} S={TP_A_PROMPT}: prefill "
        f"{ws['prefill_s']:.3f}s, decode {ws['decode_s']:.3f}s, launches {want_l}")
    by_path = {}
    for layout in TP_LAYOUTS:
        ops.reset_launches()
        got, gs = generate(cfg, params, prompts, gen=TP_GEN, capacity=capacity,
                           layout=layout, mesh=mesh, device=dev)
        launches = dict(ops.LAUNCHES)
        what = f"16a generate(mesh=(1, 1)) {layout}"
        if launches != want_l:
            fail(f"{what} launched {launches}, generate(mesh=None) {want_l}")
        same = torch.equal(got, want)
        if layout != "coplace_shmap" and not same:
            fail(f"{what}: tokens differ from generate(mesh=None) on one rank")
        ties = check_ties(cfg, params, reqs, {b: got[b].tolist() for b in range(BATCH)},
                          {b: want[b].tolist() for b in range(BATCH)}, {}, capacity, dev,
                          BF16_LOGIT_BAND, what, relative=True)
        err_ = (gs["last_logits"].float() - ws["last_logits"].float()).abs().max().item()
        log(f"{what}: launches equal, tokens equal {same} (near-tie divergences {ties}), "
            f"last logits max |diff| {err_:.3e}; prefill {gs['prefill_s']:.3f}s, decode "
            f"{gs['decode_s']:.3f}s ({TP_GEN / gs['decode_s']:.2f} decode steps/s against "
            f"{TP_GEN / ws['decode_s']:.2f}); parameter bytes {gs['param_bytes']}")
        by_path[f"tp_{layout}"] = launches
    return by_path


def tp_train_config(arch: str, layers: int, experts: int = 0):
    """A registered config at full width, cut to ``layers`` layers (0: all)
    and a MoE's experts to ``experts`` (0: all)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
    return cfg


def tp_train_run(cfg, mesh, batch: int, seq: int, steps: int, dev,
                 microbatches: int = 1) -> dict:
    """``steps`` f32 train steps from the seeded weights on the global
    batches of ``lm_batch``: the sharded step on the rank's blocks over
    ``mesh``, or ``make_train_step`` on one card (``mesh`` None). Returns
    each step's loss and grad norm, step times, launch counts, the rank's
    parameter and AdamW bytes and the peak memory."""
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding
    from repro_torch.runtime import train as train_rt

    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tcfg = train_rt.TrainConfig(warmup=1, total_steps=10, microbatches=microbatches)
    if mesh is None:
        step = train_rt.make_train_step(cfg, tcfg)
    else:
        step = train_rt.jit_train_step(cfg, tcfg, mesh, params, None, batch)
        params, _ = sharding.place_params(cfg, mesh, params, "train")
    # the dense family's optimizer placement is the parameters' (mode "opt")
    opt = adamw.init_state(params)
    _sync(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = {"metrics": [], "step_s": []}
    for i in range(steps):
        b = {k: v.to(dev) for k, v in lm_batch(i, batch=batch, seq=seq,
                                                 vocab=cfg.vocab_size).items()}
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b, i)
        _sync(dev)
        out["step_s"].append(time.perf_counter() - t0)
        out["metrics"].append([float(m["loss"]), float(m["grad_norm"])])
    out["launches"] = dict(ops.LAUNCHES)
    out["param_bytes"] = sum(t.numel() * t.element_size() for t in _leaves(params))
    out["opt_bytes"] = sum(t.numel() * t.element_size()
                           for t in _leaves({"mu": opt["mu"], "nu": opt["nu"]}))
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if torch.device(dev).type == "cuda" else 0.0)
    return out


def tp_cli_runs(ckpt_dir: str) -> dict:
    """The training CLI on this process's group: uninterrupted, and twice
    crashed after TP_CLI_CRASH steps, one of them resumed here (the other
    is resumed on one rank by the caller). Returns the final losses and the
    uninterrupted run's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    ops.reset_launches()
    out = {"full": train_cli.main(TP_CLI + ["--ckpt-dir", os.path.join(ckpt_dir, "full")])}
    out["launches"] = dict(ops.LAUNCHES)
    for name in ("resumed", "elastic"):
        try:
            train_cli.main(TP_CLI + ["--ckpt-dir", os.path.join(ckpt_dir, name),
                                     "--crash-at", str(TP_CLI_CRASH)])
            fail("the training CLI did not crash at --crash-at")
        except RuntimeError as exc:
            if "injected crash" not in str(exc):
                raise
    out["resumed"] = train_cli.main(TP_CLI + ["--ckpt-dir", os.path.join(ckpt_dir,
                                                                         "resumed")])
    return out


def tp_rank(rank: int, store: str, out: str, dev=None) -> int:
    """One of 16b's two ranks (``chip_smoke.py --tp-rank R STORE OUT``):
    gloo on cuda:0, both meshes made; ``generate`` of each TP_B_GENERATE
    case, the sharded steps of TP_TRAIN and the training CLI; its results
    written to OUT.R. A failure raises and exits non-zero."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    dev = torch.device("cuda", 0) if dev is None else torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    meshlib.init_distributed("gloo", store_path=store, rank=rank, world_size=2)
    meshes = {m: meshlib.make_local_mesh(model=m) for m in (2, 1)}
    res = {"generate": {}, "train": {}, "seconds": {}}
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=TP_CUT)
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev, dtype=torch.bfloat16)
    whole = sum(t.numel() * t.element_size() for t in _leaves(params))
    prompts = tp_prompts(cfg, TP_B_PROMPT, dev)
    capacity = TP_B_PROMPT + TP_GEN + cfg.h2eal.page_size
    for layout, model in TP_B_GENERATE:
        ops.reset_launches()
        toks, st = generate(cfg, params, prompts, gen=TP_GEN, capacity=capacity,
                            layout=layout, mesh=meshes[model], device=dev)
        res["generate"][layout] = dict(
            mesh=meshes[model].shape, tokens=toks.tolist(), launches=dict(ops.LAUNCHES),
            param_bytes=st["param_bytes"], whole_bytes=whole, prefill_s=st["prefill_s"],
            decode_s=st["decode_s"],
            logits_finite=bool(torch.isfinite(st["last_logits"]).all()))
    del params
    _release(dev)
    res["seconds"]["generate"] = time.perf_counter() - t0
    for label, arch, layers, b, s, steps in TP_TRAIN:
        t_cfg = tp_train_config(arch, layers)
        for model, n in steps.items():
            t0 = time.perf_counter()
            res["train"][f"{label}_{model}"] = dict(
                tp_train_run(t_cfg, meshes[model], b, s, n, dev),
                mesh=meshes[model].shape)
            res["seconds"][f"train {label} {model}"] = time.perf_counter() - t0
            _release(dev)
    t0 = time.perf_counter()
    res["cli"] = tp_cli_runs(os.path.join(SMOKE_DIR, "tp_cli"))
    res["seconds"]["cli"] = time.perf_counter() - t0
    res["c"] = tp_c_rank(meshes, dev, res["seconds"])
    dist.destroy_process_group()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    return 0


def tp_c_rank(meshes, dev, seconds) -> dict:
    """16c on one of the two ranks: ``generate`` of each TP_C_SERVE family on
    each TP_C_LAYOUTS layout and mesh, then the sharded steps of
    TP_C_TRAIN."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    out = {"generate": {}, "train": {}}
    for label, arch, layers, prompt in TP_C_SERVE:
        t0 = time.perf_counter()
        cfg = tp_train_config(arch, layers)
        params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                               device=dev, dtype=torch.bfloat16)
        whole = sum(t.numel() * t.element_size() for t in _leaves(params))
        prompts = tp_prompts(cfg, prompt, dev)
        for model in (2, 1):
            for layout in TP_C_LAYOUTS:
                ops.reset_launches()
                toks, st = generate(cfg, params, prompts, gen=TP_C_GEN,
                                    capacity=prompt + TP_C_GEN + cfg.h2eal.page_size,
                                    layout=layout, mesh=meshes[model], device=dev)
                out["generate"][f"{label}_{layout}_{model}"] = dict(
                    mesh=meshes[model].shape, tokens=toks.tolist(),
                    launches=dict(ops.LAUNCHES), param_bytes=st["param_bytes"],
                    whole_bytes=whole, prefill_s=st["prefill_s"], decode_s=st["decode_s"],
                    logits_finite=bool(torch.isfinite(st["last_logits"]).all()))
                _release(dev)
        del params
        _release(dev)
        seconds[f"16c generate {label}"] = time.perf_counter() - t0
    for label, arch, layers, experts, b, s, steps in TP_C_TRAIN:
        cfg = tp_train_config(arch, layers, experts)
        for model, n in steps.items():
            t0 = time.perf_counter()
            out["train"][f"{label}_{model}"] = dict(
                tp_train_run(cfg, meshes[model], b, s, n, dev), mesh=meshes[model].shape)
            seconds[f"16c train {label} {model}"] = time.perf_counter() - t0
            _release(dev)
    return out


def phase16c_refs(dev) -> dict:
    """16c's one-card references, before the spawn: ``generate(mesh=None)``
    of each TP_C_SERVE family (its tokens and decode time) and the one-card
    train steps of TP_C_TRAIN."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    refs = {"generate": {}, "train": {}}
    for label, arch, layers, prompt in TP_C_SERVE:
        cfg = tp_train_config(arch, layers)
        params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                               device=dev, dtype=torch.bfloat16)
        prompts = tp_prompts(cfg, prompt, dev)
        want, ws = generate(cfg, params, prompts, gen=TP_C_GEN,
                            capacity=prompt + TP_C_GEN + cfg.h2eal.page_size, device=dev)
        refs["generate"][label] = dict(tokens=want.tolist(), prefill_s=ws["prefill_s"],
                                       decode_s=ws["decode_s"])
        log(f"16c generate(mesh=None) {cfg.name} at {cfg.num_layers} layers, B={BATCH} "
            f"S={prompt}: prefill {ws['prefill_s']:.3f}s, decode {ws['decode_s']:.3f}s "
            f"({TP_C_GEN / ws['decode_s']:.2f} decode steps/s)")
        del params
        _release(dev)
    for label, arch, layers, experts, b, s, steps in TP_C_TRAIN:
        cfg = tp_train_config(arch, layers, experts)
        # a split family's step a 'data' rank's rows at a time (2 ranks)
        mb = 2 // next(iter(steps)) if label in TP_C_SPLIT else 1
        r = refs["train"][label] = tp_train_run(cfg, None, b, s, max(steps.values()), dev,
                                                microbatches=mb)
        log(f"16c one-card train step {label} ({arch}, {cfg.num_layers} layers"
            f"{f', {experts} experts' if experts else ''}, B={b} S={s}"
            f"{f', {mb} microbatches' if mb > 1 else ''}): losses "
            f"{[m[0] for m in r['metrics']]}, grad norms {[m[1] for m in r['metrics']]}, "
            f"step s {[round(x, 3) for x in r['step_s']]}, parameter bytes "
            f"{r['param_bytes']}, AdamW bytes {r['opt_bytes']}, peak {r['peak_gib']:.2f} GiB")
        _release(dev)
    return refs


def phase16c_check(dev, card, res, refs):
    """16c's checks on the two ranks' results: ``generate``'s tokens equal
    across the ranks and to the one-card run's up to a near-tie (the
    parameters made again only to replay a divergence), a rank's parameter
    bytes its blocks'; the sharded steps within TP_TRAIN_RTOL of the
    one-card step. Returns (serving, training) launch counts by path."""
    from repro_torch.core.tree import leaves
    from repro_torch.models import model as M
    from repro_torch.runtime import sharding

    serving, training = {}, {}
    for label, arch, layers, prompt in TP_C_SERVE:
        cfg = tp_train_config(arch, layers)
        want = refs["generate"][label]
        params = None
        shapes = M.init_params(cfg, generator=None, device="meta", dtype=torch.bfloat16)
        for model in (2, 1):
            for layout in TP_C_LAYOUTS:
                key = f"{label}_{layout}_{model}"
                a, b = (res[r]["c"]["generate"][key] for r in range(2))
                what = f"16c generate {cfg.name} {layout} on {a['mesh']}"
                if a["tokens"] != b["tokens"] or not (a["logits_finite"] and b["logits_finite"]):
                    fail(f"{what}: the ranks' tokens differ or a logit is not finite")
                ties = 0
                if a["tokens"] != want["tokens"]:
                    if params is None:
                        params = M.init_params(
                            cfg, generator=torch.Generator(device=dev).manual_seed(0),
                            device=dev, dtype=torch.bfloat16)
                    prompts = tp_prompts(cfg, prompt, dev)
                    ties = check_ties(cfg, params, tp_requests(prompts, TP_C_GEN),
                                      dict(enumerate(a["tokens"])),
                                      dict(enumerate(want["tokens"])), {},
                                      prompt + TP_C_GEN + cfg.h2eal.page_size, dev,
                                      BF16_LOGIT_BAND, what, relative=True)
                for r, g in enumerate((a, b)):
                    mesh = sharding_mesh(g["mesh"], r)
                    specs = sharding.spec_leaves(shapes, sharding.param_shardings(
                        cfg, mesh, shapes, "serve"))
                    blocks = sum(x.element_size() * math.prod(
                        hi - lo for lo, hi in sharding.block_bounds(x.shape, sp, mesh))
                        for x, sp in zip(leaves(shapes), specs))
                    if g["param_bytes"] != blocks:
                        fail(f"{what}: rank {r} holds {g['param_bytes']} parameter bytes, "
                             f"its blocks {blocks}")
                log(f"{what} ({card}): tokens equal across ranks, equal to one card's "
                    f"{a['tokens'] == want['tokens']} (near-tie divergences {ties}); "
                    f"parameter bytes rank 0 {a['param_bytes']}, rank 1 {b['param_bytes']} "
                    f"of {a['whole_bytes']} whole; prefill {a['prefill_s']:.3f}s, decode "
                    f"{a['decode_s']:.3f}s ({TP_C_GEN / a['decode_s']:.2f} decode steps/s "
                    f"against one card's {TP_C_GEN / want['decode_s']:.2f}); launches rank 0 "
                    f"{a['launches']}")
                serving[f"tp2c_{key}"] = a["launches"]
        del params
        _release(dev)
    def rel_diff(got, want):
        return max(abs(g - w) / abs(w) for gm, wm in zip(got, want) for g, w in zip(gm, wm))

    for label, arch, layers, experts, b, s, steps in TP_C_TRAIN:
        for model in steps:
            key = f"{label}_{model}"
            got = [res[r]["c"]["train"][key] for r in range(2)]
            what = f"16c sharded train step {label} on {got[0]['mesh']}"
            if got[0]["metrics"] != got[1]["metrics"]:
                fail(f"{what}: the ranks' metrics differ")
            ref = refs["train"][label]
            if not all(math.isfinite(x) for m in got[0]["metrics"] + ref["metrics"] for x in m):
                fail(f"{what}: a loss or grad norm is not finite")
            rel = rel_diff(got[0]["metrics"], ref["metrics"])
            against = ("one card a 'data' rank's rows at a time" if label in TP_C_SPLIT
                       else "one card")
            log(f"{what} ({card}): losses {[m[0] for m in got[0]['metrics']]}, grad norms "
                f"{[m[1] for m in got[0]['metrics']]}, largest relative difference from "
                f"{against} {rel:.3e} (tol {TP_TRAIN_RTOL:g}); step s rank 0 "
                f"{[round(x, 3) for x in got[0]['step_s']]} (one card "
                f"{[round(x, 3) for x in ref['step_s']]}); parameter bytes "
                f"{[g['param_bytes'] for g in got]}, AdamW bytes "
                f"{[g['opt_bytes'] for g in got]} (one card {ref['param_bytes']}, "
                f"{ref['opt_bytes']}); peak GiB {[round(g['peak_gib'], 2) for g in got]}")
            if not rel <= TP_TRAIN_RTOL:
                fail(f"{what}: loss or grad norm leaves the band of the one-card step")
            training[f"tp2c_train_{key}"] = got[0]["launches"]
    return serving, training


def sharding_mesh(shape: dict, rank: int):
    """The ``launch/mesh.Mesh`` of rank ``rank`` of a two-rank mesh of
    ``shape`` ({axis: size}), without a process group (placements only)."""
    from repro_torch.launch import mesh as meshlib

    sizes = (shape["data"], shape["model"])
    coords = (rank // sizes[1], rank % sizes[1])
    return meshlib.Mesh(sizes=sizes, coords=coords)


def phase16b(dev, card):
    """16b: the one-rank references (``generate`` at TP_CUT layers, the
    one-card train steps), then two ranks spawned on cuda:0 over gloo
    (``tp_rank``), then the CLI's second crashed run resumed on one rank.
    Returns (serving launch counts by path, training launch counts by
    path)."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    t16 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=TP_CUT)
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev, dtype=torch.bfloat16)
    prompts = tp_prompts(cfg, TP_B_PROMPT, dev)
    capacity = TP_B_PROMPT + TP_GEN + cfg.h2eal.page_size
    want, ws = generate(cfg, params, prompts, gen=TP_GEN, capacity=capacity, device=dev)
    log(f"16b generate(mesh=None) at {TP_CUT} layers, B={BATCH} S={TP_B_PROMPT}: prefill "
        f"{ws['prefill_s']:.3f}s, decode {ws['decode_s']:.3f}s")
    del params  # made again for the near-tie replays: the ranks need the card
    _release(dev)
    refs = {}
    for label, arch, layers, b, s, steps in TP_TRAIN:
        refs[label] = tp_train_run(tp_train_config(arch, layers), None, b, s,
                                   max(steps.values()), dev)
        r = refs[label]
        log(f"16b one-card train step {label} ({arch}, {layers or 'all'} layers, B={b} "
            f"S={s}): losses {[m[0] for m in r['metrics']]}, grad norms "
            f"{[m[1] for m in r['metrics']]}, step s {[round(x, 3) for x in r['step_s']]}, "
            f"parameter bytes {r['param_bytes']}, AdamW bytes {r['opt_bytes']}, peak "
            f"{r['peak_gib']:.2f} GiB")
        _release(dev)
    t16c = time.perf_counter()
    c_refs = phase16c_refs(dev)
    log(f"16c one-card references {time.perf_counter() - t16c:.1f}s")
    os.makedirs(SMOKE_DIR, exist_ok=True)
    store, out = os.path.join(SMOKE_DIR, "tp2.store"), os.path.join(SMOKE_DIR, "tp2")
    shutil.rmtree(os.path.join(SMOKE_DIR, "tp_cli"), ignore_errors=True)
    for path in [store] + [f"{out}.{r}" for r in range(2)]:
        if os.path.exists(path):
            os.remove(path)
    torch.cuda.synchronize()
    _release(dev)
    log(f"16b: card memory before the spawn {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank",
                               str(r), store, out], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env) for r in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=TP_TIMEOUT)[0].decode(errors="replace"))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, pr in enumerate(procs):
        if pr.returncode != 0:
            fail(f"16b rank {r} exited {pr.returncode}:\n{logs[r][-4000:]}")
    res = []
    for r in range(2):
        with open(f"{out}.{r}") as f:
            res.append(json.load(f))
    log(f"16b: two ranks in {time.perf_counter() - t0:.1f}s; rank 0's sections "
        f"{ {k: round(v, 1) for k, v in res[0]['seconds'].items()} }")
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev, dtype=torch.bfloat16)
    reqs = tp_requests(prompts, TP_GEN)
    serving, training = {}, {}
    for layout, model in TP_B_GENERATE:
        a, b = (res[r]["generate"][layout] for r in range(2))
        what = f"16b generate {layout} on {a['mesh']}"
        if a["tokens"] != b["tokens"] or not (a["logits_finite"] and b["logits_finite"]):
            fail(f"{what}: the ranks' tokens differ or a logit is not finite")
        ties = check_ties(cfg, params, reqs, dict(enumerate(a["tokens"])),
                          dict(enumerate(want.tolist())), {}, capacity, dev,
                          BF16_LOGIT_BAND, what, relative=True)
        log(f"{what}: tokens equal across ranks, equal to one rank's "
            f"{a['tokens'] == want.tolist()} (near-tie divergences {ties}); parameter bytes "
            f"rank 0 {a['param_bytes']}, rank 1 {b['param_bytes']} of {a['whole_bytes']} "
            f"whole; prefill {a['prefill_s']:.3f}s, decode {a['decode_s']:.3f}s "
            f"({TP_GEN / a['decode_s']:.2f} decode steps/s); launches rank 0 {a['launches']}")
        serving[f"tp2_{layout}"] = a["launches"]
    del params
    torch.cuda.empty_cache()
    for label, arch, layers, b, s, steps in TP_TRAIN:
        want_m = refs[label]["metrics"]
        for model in steps:
            key = f"{label}_{model}"
            got = [res[r]["train"][key] for r in range(2)]
            what = f"16b sharded train step {label} on {got[0]['mesh']}"
            if got[0]["metrics"] != got[1]["metrics"]:
                fail(f"{what}: the ranks' metrics differ")
            rel = max(abs(g - w) / abs(w) for gm, wm in zip(got[0]["metrics"], want_m)
                      for g, w in zip(gm, wm))
            log(f"{what}: losses {[m[0] for m in got[0]['metrics']]}, grad norms "
                f"{[m[1] for m in got[0]['metrics']]}, largest relative difference from "
                f"one card {rel:.3e} (tol {TP_TRAIN_RTOL:g}); step s rank 0 "
                f"{[round(x, 3) for x in got[0]['step_s']]}; parameter bytes "
                f"{[g['param_bytes'] for g in got]}, AdamW bytes "
                f"{[g['opt_bytes'] for g in got]} (one card {refs[label]['param_bytes']}, "
                f"{refs[label]['opt_bytes']}); peak GiB {[round(g['peak_gib'], 2) for g in got]}")
            if not rel <= TP_TRAIN_RTOL:
                fail(f"{what}: loss or grad norm leaves the band of the one-card step")
            training[f"tp2_train_{key}"] = got[0]["launches"]
    cli = [res[r]["cli"] for r in range(2)]
    if cli[0]["full"] != cli[1]["full"] or cli[0]["resumed"] != cli[1]["resumed"]:
        fail("16b training CLI: the ranks' losses differ")
    elastic = train_cli.main(TP_CLI + ["--ckpt-dir", os.path.join(SMOKE_DIR, "tp_cli",
                                                                  "elastic")])
    rel = abs(elastic - cli[0]["full"]) / abs(cli[0]["full"])
    log(f"16b training CLI on (2, 1): final loss {cli[0]['full']!r}, crashed after "
        f"{TP_CLI_CRASH} and resumed {cli[0]['resumed']!r}, crashed and resumed on one card "
        f"{elastic!r} (relative difference {rel:.3e})")
    if cli[0]["resumed"] != cli[0]["full"] or not rel <= TP_TRAIN_RTOL:
        fail("16b training CLI: a resumed run does not repeat the uninterrupted one")
    training["tp2_train_cli"] = cli[0]["launches"]
    c_serving, c_training = phase16c_check(dev, card, res, c_refs)
    serving.update(c_serving)
    training.update(c_training)
    log(f"phase 16b and 16c {time.perf_counter() - t16:.1f}s")
    return serving, training


def card_name_and_limit() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


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

    card = card_name_and_limit()
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
    t2 = time.perf_counter()
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
        results["chunk_attention"] += check_chunk_verify(ops, ref, timer, dev, cfg, dtype,
                                                         gen, engine_capacity)
        results["chunk_attention_paged"] += check_chunk_paged(
            ops, ref, timer, dev, cfg, dtype, gen, engine_capacity)
        part, comb = check_partial(ops, ref, timer, dev, cfg, dtype, gen)
        results["paged_attention_partial"] += part
        results["combine_partials"] += comb
        torch.cuda.empty_cache()
        for name, cases in check_head_dim_256(ops, ref, timer, dev, dtype, gen).items():
            results[name] += cases
        for arch in (moe_arch(MOE_ARCH, MOE_LAYERS), get_arch(Z_ARCH)):
            for name, cases in check_arch_shapes(ops, ref, timer, dev, arch, dtype,
                                                 gen).items():
                results[name] += cases
        for arch in STUB_ARCHS:
            for name, cases in check_stub_shapes(ops, ref, timer, dev, get_arch(arch), dtype,
                                                 gen).items():
                results[name] += cases
    results["page_score"].append(check_page_select(ops, ref, timer, dev, cfg,
                                                   torch.bfloat16, gen, "verify"))
    check_sampler(timer, dev, cfg)
    bad = []
    for name, cases in results.items():
        for c in cases:
            lib_ms = "n/a" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
            lib_ms += "".join(f" {k}={c[k]:.4f}"
                              for k in ("unfused_ms", "gather_sdpa_ms", "pages_ms",
                                        "section_ms", "scores_ms") if k in c)
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
    log(f"phase 2 (every kernel against its plain version) {time.perf_counter() - t2:.1f}s")

    t3 = time.perf_counter()
    check_reduced_against_cpu(dev)
    check_reduced_bf16_against_cpu(dev)
    check_reduced_engine_against_cpu(dev)
    check_reduced_bf16_engine_against_cpu(dev)
    check_reduced_coplace_engine_against_cpu(dev)
    check_reduced_window_engines(dev)
    check_reduced_spec_engines(dev)
    log(f"reduced models card against CPU {time.perf_counter() - t3:.1f}s")
    t4 = time.perf_counter()
    params = full_params(dev, cfg)
    by_path = {"generate": serve_full(dev, cfg, params)}
    check_coplace_layer(dev, cfg, params)
    launches, greedy, captured_rate = serve_engine(dev, cfg, params)
    log(f"llama3-8b generate and engines {time.perf_counter() - t4:.1f}s")
    t8 = time.perf_counter()
    by_path.update({f"engine_{k}": v for k, v in launches.items()})
    by_path.update(serve_spec_engines(dev, cfg, params, greedy))
    log(f"phase 8 (speculative engines) {time.perf_counter() - t8:.1f}s")
    t9 = time.perf_counter()
    by_path.update({f"engine_{k}": v for k, v in serve_tiered_and_rebalanced(
        dev, cfg, params, greedy, captured_rate, card).items()})
    log(f"phase 9 (tiered and rebalanced) {time.perf_counter() - t9:.1f}s")
    del params
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    check_reduced_gemma3_against_cpu(dev)
    by_path.update(serve_gemma3(dev))
    by_path["pool"] = check_pool_on_card(dev)
    log(f"phase 10 (gemma3-1b, the eviction pool) {time.perf_counter() - t10:.1f}s")
    t11 = time.perf_counter()
    check_reduced_moe_against_cpu(dev)
    by_path.update(serve_moe(dev))
    log(f"phase 11 (the MoE family) {time.perf_counter() - t11:.1f}s")
    t12 = time.perf_counter()
    check_reduced_recurrent_against_cpu(dev)
    by_path.update(serve_zamba2(dev))
    serve_xlstm(dev)
    log(f"phase 12 (the recurrent mixers) {time.perf_counter() - t12:.1f}s")
    results["flash_attention_bwd"], fwd32, train_paths = phase13(ops, ref, dev)
    results["flash_attention"] += fwd32  # f32, not the serving path's bf16: not in its totals
    stub_paths = phase14(dev, card)
    t15 = time.perf_counter()
    train_paths.update({p: n for p, n in stub_paths.items() if p.endswith("_train")})
    by_path.update({p: n for p, n in stub_paths.items() if not p.endswith("_train")})
    gspmd_paths, gspmd_parts, gspmd_combs, gspmd_verify, gspmd_family = phase15(
        ops, ref, dev, card)
    by_path.update(gspmd_paths)
    results["paged_attention_partial"] += gspmd_parts
    results["combine_partials"] += gspmd_combs
    results["chunk_attention"] += gspmd_verify
    for name, cases in gspmd_family.items():
        results[name] += cases
    log(f"phase 15 and 16a {time.perf_counter() - t15:.1f}s")
    tp_serving, tp_training = phase16b(dev, card)
    by_path.update(tp_serving)
    train_paths.update(tp_training)
    serving_paths = list(by_path)
    by_path.update(train_paths)
    # the main paths: sparse lockstep generate, the chunked engine and the
    # chunked coplace_shmap engine, each eager and captured with fused
    # windows, for llama3-8b and gemma3-1b, and the eviction pool; the MoE
    # family's and zamba2's generate and chunked engines; the frontend stubs'
    # prefill and decode steps and internvl2-1b's train step; every kernel of
    # a path must have run in it (xlstm-125m's paths run none)
    engine = ("page_score", "paged_attention", "chunk_attention", "chunk_attention_paged")
    coplaced = engine + ("paged_attention_partial",)
    main_paths = {"generate": ("flash_attention", "page_score", "paged_attention"),
                  "engine_chunked": engine, "engine_coplace": coplaced,
                  "engine_chunked_graphs": engine, "engine_coplace_graphs": coplaced,
                  "engine_spec_replay": engine[:1] + engine[2:],
                  "engine_spec_ngram": engine[:1] + engine[2:],
                  "engine_spec_streaming": engine,
                  "engine_spec_sampled": engine[:1] + engine[2:],
                  "engine_sampled_graphs": engine,
                  "engine_tiered": engine, "engine_rebalanced": engine,
                  "gemma3_generate": ("flash_attention", "page_score", "paged_attention"),
                  "gemma3_engine_chunked": engine, "gemma3_engine_coplace": coplaced,
                  "gemma3_engine_chunked_graphs": engine,
                  "gemma3_engine_coplace_graphs": coplaced,
                  "pool": ("page_score", "paged_attention"),
                  "moe_generate": ("flash_attention", "page_score", "paged_attention"),
                  "moe_engine_chunked_windows": engine,
                  "moe_engine_chunked_graphs": engine,
                  "kimi_generate": ("flash_attention", "page_score", "paged_attention"),
                  "zamba2_generate": ("flash_attention", "page_score", "paged_attention"),
                  "zamba2_engine_chunked_windows": engine,
                  "zamba2_engine_chunked_graphs": engine,
                  "train": ("flash_attention", "flash_attention_bwd"),
                  "head_id": ("flash_attention", "flash_attention_bwd")}
    for name in STUB_ARCHS:  # phase 14: prefill and decode fed embeddings
        main_paths[f"stub_{name}_serve"] = ("flash_attention", "page_score", "paged_attention")
    main_paths[f"stub_{STUB_ARCHS[0]}_train"] = ("flash_attention", "flash_attention_bwd")
    # phase 15: each GSPMD layout's engine, packed and chunked, on one NCCL rank
    # (gspmd_), where one rank holds every page and runs the default's
    # kernels, and on two gloo ranks (gspmd2_, rank 0's counts), where the
    # layouts that shard pages attend by partials merged with combine_partials
    whole = ("page_score", "paged_attention")
    split = ("page_score", "paged_attention_partial", "combine_partials")
    for prefix, layouts_ in (("gspmd", ("default",) + GSPMD_LAYOUTS),
                             ("gspmd2", GSPMD_LAYOUTS + ("coplace_shmap",))):
        for layout in layouts_:
            base = split if prefix == "gspmd2" and layout != "head" else whole
            main_paths[f"{prefix}_{layout}_chunked"] = base + ("chunk_attention",
                                                               "chunk_attention_paged")
            main_paths[f"{prefix}_{layout}_packed"] = base + ("flash_attention",)
    # 15c on the NCCL rank: speculative (a verify step scores pages once and
    # runs chunk_attention twice a layer), tiered and rebalanced; 15b's
    # further cases on the two gloo ranks (rank 0's counts)
    for layout in ("default",) + GSPMD_LAYOUTS:
        main_paths[f"gspmd_spec_{layout}_ngram"] = ("page_score", "chunk_attention",
                                                    "chunk_attention_paged")
        main_paths[f"gspmd_spec_{layout}_replay"] = ("page_score", "chunk_attention",
                                                     "flash_attention")
        main_paths[f"gspmd_tiered_{layout}"] = main_paths["gspmd_default_chunked"]
        if layout in ("coplace", "interleave"):
            main_paths[f"gspmd_rebalanced_{layout}"] = main_paths["gspmd_default_chunked"]
    main_paths["gspmd2_spec_coplace"] = main_paths["gspmd_spec_coplace_ngram"]
    main_paths["gspmd2_tiered_coplace"] = main_paths["gspmd2_coplace_chunked"]
    main_paths["gspmd2_rebalanced_head"] = main_paths["gspmd2_head_chunked"]
    # coplace_shmap: 15a's NCCL rank holds every stripe (the default's
    # kernels); 15b's two gloo ranks a stripe each (partials merged)
    main_paths["gspmd_coplace_shmap_chunked"] = main_paths["gspmd_default_chunked"]
    main_paths["gspmd2_spec_shmap_coplace_shmap"] = main_paths["gspmd_spec_coplace_ngram"]
    main_paths["gspmd2_tiered_shmap_coplace_shmap"] = main_paths[
        "gspmd2_coplace_shmap_chunked"]
    # 15d on the NCCL rank: the other families' chunked engines (xlstm-125m's
    # run no kernel); 15b's other families on the two gloo ranks: zamba2's
    # attention layers on head, gemma3's global pages cut (partials) and its
    # window layers whole, H²EAL off's full caches cut over kv heads
    full_only = ("paged_attention", "chunk_attention")
    for label, *_ in GSPMD_D_MODELS:
        for layout in ("default",) + GSPMD_LAYOUTS:
            if label != "xlstm":
                main_paths[f"gspmd_{label}_{layout}"] = (
                    full_only if label == "h2eal_off" else engine)
    main_paths["gspmd2_zamba2_rebalanced_head"] = engine
    main_paths["gspmd2_gemma3_tiered_coplace"] = engine + ("paged_attention_partial",
                                                           "combine_partials")
    main_paths["gspmd2_h2eal_off_head"] = full_only
    # phase 16: generate(mesh=...) on one NCCL rank (tp_, the default's
    # kernels) and on two gloo ranks (tp2_, rank 0's counts: coplace and
    # coplace_shmap on (1, 2) attend by partials); the sharded step and the
    # training CLI over the two ranks
    for layout in TP_LAYOUTS:
        main_paths[f"tp_{layout}"] = main_paths["generate"]
    for layout, model in TP_B_GENERATE:
        main_paths[f"tp2_{layout}"] = main_paths["generate"] + (
            ("paged_attention_partial", "combine_partials")
            if model > 1 and layout in ("coplace", "coplace_shmap") else ())
    # 16c: rank 0's counts; xlstm-125m's paths run no kernel
    for label, *_ in TP_C_SERVE:
        for model in (2, 1):
            for layout in TP_C_LAYOUTS:
                if label != "xlstm":
                    main_paths[f"tp2c_{label}_{layout}_{model}"] = main_paths["generate"]
    for path in tp_training:
        if not path.startswith("tp2c_train_xlstm"):
            main_paths[path] = main_paths["train"]
    for path, names in main_paths.items():
        idle = [n for n in names if by_path[path][n] == 0]
        if idle:
            fail(f"path {path} never launched {idle}")
    backward = [p for p in serving_paths if by_path[p]["flash_attention_bwd"]]
    if backward:
        fail(f"serving paths {backward} launched the attention backward")

    src = "src/repro_torch/kernels/csrc/"
    # flash_attention and the chunk kernels: the main path's bf16 kernels
    # (f32 operands take the FMA kernels of flash_attention.cu and
    # chunk_attention.cu)
    sources = {"flash_attention": src + "flash_attention_sm90.cu",
               "page_score": src + "page_score.cu",
               "paged_attention": src + "paged_attention.cu",
               "chunk_attention": src + "chunk_attention_sm90.cu",
               "chunk_attention_paged": src + "chunk_attention_sm90.cu",
               "paged_attention_partial": src + "paged_attention.cu",
               "combine_partials": src + "combine_partials.cu",
               "flash_attention_bwd": src + "flash_attention_bwd.cu"}
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:97",
                "page_score": "src/repro/kernels/page_score.py:46",
                "paged_attention": "src/repro/kernels/paged_attention.py:89",
                "chunk_attention": "src/repro/kernels/chunk_attention.py:107",
                "chunk_attention_paged": "src/repro/kernels/chunk_attention.py:213",
                "paged_attention_partial": "src/repro/kernels/paged_attention.py:89",
                "combine_partials": "src/repro/kernels/paged_attention.py:211",
                # no Pallas backward: the JAX package differentiates the plain
                # body of the function whose forward is flash_attention.py:97
                "flash_attention_bwd": "src/repro/kernels/ref.py:40"}
    kernels = []
    # the serving paths run bf16; training and head identification run the
    # backward in f32 (the gated mix promotes to α's f32)
    path_dtype = {"flash_attention_bwd": "float32"}
    for name, cases in results.items():
        main_cases = [c for c in cases if c["dtype"] == path_dtype.get(name, "bfloat16")
                      and c.get("main", True)]
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
        if all("section_ms" in c for c in main_cases):  # page_score: the parent's section
            kernels[-1]["yardstick_ms"] = total("section_ms")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--gspmd-rank":  # a phase 15b rank
        sys.exit(gspmd_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--tp-rank":  # a phase 16b rank
        sys.exit(tp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
