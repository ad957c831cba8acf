#!/usr/bin/env python3
"""Device times of the port's decode, select and prefill kernels beside
their yardsticks, for this checkout or another one's, on one CUDA card.

Runs chip_smoke.py's own kernel cases, with its Timer (the L2 flushed, the
card held busy while the host enqueues the call; median of several runs):
``check_paged`` (paged_attention on the retrieval heads' gathered buffer,
the streaming ring and the full-attention baseline; then the retrieval
heads' decode with its pages read in place, beside the gather followed by
the contiguous kernel and by SDPA), ``check_partial`` (the co-placed
decode over 8 page stripes, beside ``paged_attention_pages`` on the same
list and the gather followed by SDPA; the stripes' partials; the
standalone combine), ``check_flash`` (the retrieval and streaming
prefill cases) and ``check_page_score`` (page_score's scores mode, and
its select mode, a retrieval layer's whole select step, at the lockstep,
engine and coplace shapes, beside the parent's section of eager ops),
all in bf16 at the main path's shapes. Each case is checked against its
plain version as chip_smoke.py checks it. First it times the Timer's
floor, a 4-byte memset. ``--select`` times page_score's cases alone;
``--select-blocks N`` scores a row with a cluster of N blocks instead of
``ops._SELECT_BLOCKS``. ``--bwd`` times flash attention's backward instead:
``time_bwd``'s cases (smollm-360m's training shape and llama3-8b's
head-identification shapes, f32 and bf16, beside their plain version and
SDPA's backward; in f32 also the forward with its row log-sum-exp), then
the bf16 serving forward (``check_flash``) at llama3-8b, gemma3-1b and
zamba2-2.7b, whose kernels the backward's slice touched; it needs a
checkout whose forward saves the log-sum-exp (``ops.flash_attention_lse``).

``--src`` names the ``src`` directory of the checkout whose kernels and
plain versions are timed (default: this checkout's); its kernels are built
into that checkout's ``src/repro_torch/kernels/build/``. A checkout whose
retrieval decode still gathers its pages first (no
``ops.paged_attention_pages``) is timed on that path: its
``paging.gather_pages``, then its ``paged_attention``. A checkout whose
co-placed decode is still the partial kernel, the combine kernel and a
cast (no ``ops.paged_attention_coplace``) is timed on that path, its
stripes' lists (``stripe_slots``) made inside the timed call as its decode
body made them. A checkout whose select step is still the scores kernel
and eager ops (no ``ops.page_select``) is timed on that section
(``chip_smoke.parent_select`` with its ``page_score``), checked with this
checkout's plain versions. Two checkouts are compared in one call on one
card by running the script once for each:

    python scripts/torch_time_kernels.py [--src DIR] [--tag NAME] [--select]
        [--select-blocks N] [--bwd]

Prints the card's name and power limit, then one JSON object a case.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def unfused(ops, ref):
    """ops and ref of a checkout without the fused page gather, with
    ``paged_attention_pages`` and ``gather_pages`` as that checkout's
    retrieval decode ran them."""
    from repro_torch.core import paging

    def pages(q, kp, vp, slots, valid, attend):
        return attend(q, *paging.gather_pages(kp, vp, slots), valid)

    ops_ns = types.SimpleNamespace(**vars(ops))
    ops_ns.paged_attention_pages = lambda *a: pages(*a, ops.paged_attention)
    ref_ns = types.SimpleNamespace(**vars(ref))
    ref_ns.paged_attention_pages_ref = lambda *a: pages(*a, ref.paged_attention_ref)
    ref_ns.gather_pages = paging.gather_pages
    return ops_ns, ref_ns


def partial_then_combine(ops, ref):
    """ops and ref of a checkout without the fused co-placed decode, with
    ``paged_attention_coplace`` as that checkout's decode body ran it: its
    ``stripe_slots``, the partial, the combine, the cast to q's dtype."""
    from repro_torch.core.hybrid_attention import stripe_slots

    def coplace(q, kp, vp, slots, valid, shards, partial, combine):
        s_slots, s_valid = stripe_slots(slots, valid, shards=shards, capacity=kp.shape[2])
        return combine(*partial(q, kp, vp, s_slots, s_valid)).to(q.dtype)

    ops_ns = types.SimpleNamespace(**vars(ops))
    ops_ns.paged_attention_coplace = lambda *a: coplace(
        *a, ops.paged_attention_partial, ops.combine_partials)
    ref_ns = types.SimpleNamespace(**vars(ref))
    ref_ns.paged_attention_coplace_ref = lambda *a: coplace(
        *a, ref.paged_attention_partial_pages_ref, ref.combine_partials_ref)
    ref_ns.stripe_slots = stripe_slots
    return ops_ns, ref_ns


def eager_select(ops, ref):
    """ops and ref of a checkout without the fused select step, with
    ``page_select`` as that checkout's decode bodies ran it (the coplace
    shape's two stages over chip_smoke's SHARDS stripes) and this
    checkout's plain versions of it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ref_of_this_checkout", os.path.join(ROOT, "src/repro_torch/kernels/ref.py"))
    this_ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(this_ref)

    def page_select(*a, minus_one_masked=False, **kw):
        return cs.parent_select(ops, *a, **kw, shards=cs.SHARDS if minus_one_masked else 1)

    ops_ns = types.SimpleNamespace(**vars(ops))
    ops_ns.page_select = page_select
    ref_ns = types.SimpleNamespace(**vars(ref))
    for name in ("selectable_pages", "select_top_k", "page_select_ref", "NEG_INF"):
        setattr(ref_ns, name, getattr(this_ref, name))
    return ops_ns, ref_ns


def bwd_cases(ops, ref, timer, dev, gen):
    """--bwd: the backward's cases and the f32 forward's, then the bf16
    serving forward's rows."""
    from repro_torch.configs import get_arch

    bwd, fwd = cs.time_bwd(ops, ref, timer, dev, gen)
    cases = bwd + fwd
    for arch in (cs.ARCH, cs.Z_ARCH, cs.G3_ARCH):
        cfg = get_arch(arch)
        h = cfg.num_kv_heads
        kw = {} if arch != cs.G3_ARCH else dict(prompt=cs.G3_PROMPT, heads_cases=(
            ("global layer", h, 0, 0), ("window layer", h, cfg.local_window, 0)))
        cases += [dict(c, case=f"{arch} {c['case']}") for c in
                  cs.check_flash(ops, ref, timer, dev, cfg, torch.bfloat16, gen, **kw)]
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--select", action="store_true", help="page_score's cases alone")
    ap.add_argument("--select-blocks", type=int, default=None,
                    help="blocks of a select row's cluster (1 to 8)")
    ap.add_argument("--bwd", action="store_true",
                    help="flash attention's backward and the serving forward alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    src = os.path.abspath(args.src)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.join(ROOT, "src")]
    sys.path.insert(0, src)
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref

    if not hasattr(ops, "paged_attention_pages"):
        ops, ref = unfused(ops, ref)
    if not hasattr(ops, "paged_attention_coplace"):
        ops, ref = partial_then_combine(ops, ref)
    if not hasattr(ops, "page_select"):
        ops, ref = eager_select(ops, ref)
    elif args.select_blocks is not None:
        ops._SELECT_BLOCKS = args.select_blocks
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    cfg = get_arch(cs.ARCH)
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    floor = torch.zeros(1, dtype=torch.int32, device=dev)
    print(json.dumps({"tag": args.tag, "case": "timer floor: a 4-byte memset",
                      "ms": timer.ms(floor.zero_, 20)}), flush=True)
    if args.bwd:
        cases = bwd_cases(ops, ref, timer, dev, gen)
    else:
        cases = cs.check_page_score(ops, ref, timer, dev, cfg, torch.bfloat16, gen,
                                    cs.serve_capacity(cfg))
    if not args.select and not args.bwd:
        cases += cs.check_paged(ops, ref, timer, dev, cfg, torch.bfloat16, gen,
                                cs.serve_capacity(cfg))
        for part in cs.check_partial(ops, ref, timer, dev, cfg, torch.bfloat16, gen):
            cases += part
        cases += cs.check_flash(ops, ref, timer, dev, cfg, torch.bfloat16, gen)
    for case in cases:
        print(json.dumps({"tag": args.tag, **case}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
