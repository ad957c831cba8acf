"""Serving entry points (counterpart of ``repro/launch/serve.py``).

``--workload uniform`` (``generate``): one fixed batch, every request
sharing one prompt length and one generation length. ``--workload
ragged`` (``run_ragged``): seeded requests of ragged prompt and generation
lengths through the continuous-batching engine (``serving/engine.py``),
packed admission or, with ``--prefill-chunk N``, chunked prefill. Page
selection runs every ``share_window`` decode steps (the select step),
cheaper reuse steps in between. Greedy sampling. ``--layout coplace_shmap
--shards S`` serves the co-placed layout over S page stripes (split-KV
decode); with ``--admission balanced`` the engine admits and feeds prompts
by per-stripe page load, and ``--report-balance`` prints those loads.

It runs on the card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --batch 2 --prompt-len 8192 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --reduced --prompt-len 96 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --reduced --workload ragged --requests 5 --max-batch 2 \\
      --prompt-buckets 16,24 --prefill-chunk 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --reduced --workload ragged --requests 5 --max-batch 2 \\
      --prompt-buckets 16,24 --layout coplace_shmap --shards 4 \\
      --admission balanced --report-balance --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import layouts as layoutlib
from repro_torch.models import model as M
from repro_torch.runtime import serve as serve_rt
from repro_torch.runtime.serve import resolve_device
from repro_torch.sched import balance
from repro_torch.serving.engine import Engine, Request


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params, prompts, *, gen: int, capacity: int,
             layout: str = "default", shards: int = 1, h2eal: bool = True,
             greedy: bool = True, device=None):
    """Lockstep generation. prompts: (B, S) int tokens. ``layout`` and
    ``shards`` as in ``Engine``; the cache holds the layout plan's rounding
    of ``capacity``. Returns (tokens (B, gen) int32 tensor, stats dict)."""
    dev = resolve_device(device)
    if not greedy:
        raise NotImplementedError("sampling is not ported yet (ROADMAP "
                                  "Queue 1 item 6)")
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params lie on {params['embed'].device}, generate "
                         f"runs on {dev}")
    if not h2eal:
        cfg = dataclasses.replace(
            cfg, h2eal=dataclasses.replace(cfg.h2eal, enabled=False))
    plan = layoutlib.get_layout(layout, shards).plan(cfg)
    scfg = serve_rt.ServeConfig(capacity=plan.round_capacity(capacity),
                                layout=layout, shards=shards)
    prefill = serve_rt.make_prefill(cfg, scfg)
    dec_sel = serve_rt.make_decode_step(cfg, scfg, do_select=True)
    dec_reuse = serve_rt.make_decode_step(cfg, scfg, do_select=False)
    prompts = torch.as_tensor(prompts, device=dev)
    b = prompts.shape[0]

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, state = prefill(params, prompts)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        w = max(cfg.h2eal.share_window, 1)
        outs = []
        tok = logits.argmax(dim=-1).to(torch.int32)
        t0 = time.perf_counter()
        for i in range(gen):
            outs.append(tok)
            fn = dec_sel if i % w == 0 else dec_reuse
            logits, state = fn(params, state, tok)
            tok = logits.argmax(dim=-1).to(torch.int32)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    stats = {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tokens_per_s": b * gen / t_decode if t_decode > 0 else float("inf"),
        "last_logits": logits,
    }
    return torch.stack(outs, dim=1), stats


def make_ragged_requests(cfg, *, n: int, prompt_buckets, gen_min: int,
                         gen_max: int, seed: int = 0):
    """Seeded ragged workload: bucketed prompt lengths, variable generation
    lengths (the JAX package's generator, draw for draw)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        s = int(rng.choice(prompt_buckets))
        g = int(rng.integers(gen_min, gen_max + 1))
        prompt = rng.integers(0, cfg.vocab_size, size=(s,)).astype(np.int32)
        reqs.append(Request(uid=uid, prompt=prompt, max_new=g))
    return reqs


def run_ragged(cfg, params, requests, *, max_batch: int, capacity: int,
               prompt_buckets, report_balance: bool = False,
               layout: str = "default", shards: int = 1,
               admission: str = "fifo", prefill_chunk=None, device=None):
    """Serve ``requests`` with the continuous-batching engine (packed
    admission, or chunked with ``prefill_chunk=N``; ``layout``, ``shards``
    and ``admission`` as in ``Engine``). Returns (completions, stats
    dict)."""
    if admission == "balanced" and layout != layoutlib.LAYOUT_COPLACE_SHMAP:
        raise ValueError(
            "--admission balanced scores per-stripe page loads and only has "
            "an effect for a layout that stripes pages (--layout coplace_shmap)")
    eng = Engine(cfg, params, max_batch=max_batch, capacity=capacity,
                 prompt_buckets=prompt_buckets, layout=layout, shards=shards,
                 admission=admission, prefill_chunk=prefill_chunk,
                 device=device)
    completions = eng.run(requests)
    s = eng.stats
    stats = {
        "wall_s": s.wall_s,
        "tokens_per_s": s.tokens_per_s,
        "decode_steps": s.decode_steps,
        "engine_steps": s.engine_steps,
        "select_steps": s.select_steps,
        "reuse_steps": s.reuse_steps,
        "admissions": s.admissions,
        "prefill_chunks": s.prefill_chunks,
        "occupancy": s.occupancy,
        "tokens_out": s.tokens_out,
        "admission_reorders": s.admission_reorders,
    }
    if report_balance:
        stats["balance"] = _balance_report(cfg, eng)
    return completions, stats


def _balance_report(cfg, eng):
    """Per-stripe page loads of the engine's last batch (the contexts its
    slots hold at the end of the run) under round-robin page striping:
    over the layout's stripes, or 4 where pages are not striped."""
    ctx = [int(c) for c in eng.batch.lengths if c > 0]
    s = eng.stats
    base = {"admissions": s.admissions, "prefill_chunks": s.prefill_chunks}
    if not ctx:
        return base
    n_sh = (eng.plan.page_stripe_shards
            if eng.layout == layoutlib.LAYOUT_COPLACE_SHMAP else 4)
    pages = balance.device_page_loads(ctx, n_shards=n_sh,
                                      page_size=cfg.h2eal.page_size)
    return dict(base, page_loads=pages,
                page_load_imbalance=balance.load_imbalance(pages))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--workload", choices=["uniform", "ragged"],
                    default="uniform")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--h2eal", choices=["on", "off"], default="on")
    ap.add_argument("--seed", type=int, default=0)
    # ragged-workload knobs
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-buckets", default="32,64",
                    help="comma-separated allowed prompt lengths")
    ap.add_argument("--gen-min", type=int, default=4)
    ap.add_argument("--gen-max", type=int, default=24)
    ap.add_argument("--capacity", type=int, default=0,
                    help="cache capacity in tokens (0 = longest prompt + "
                         "gen-max + one page)")
    ap.add_argument("--report-balance", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: at most N prompt tokens per "
                         "engine step, beside the decode of the other slots "
                         "(0 = prefill-then-pack admission)")
    ap.add_argument("--layout", choices=[layoutlib.LAYOUT_DEFAULT,
                                         layoutlib.LAYOUT_COPLACE_SHMAP],
                    default=layoutlib.LAYOUT_DEFAULT,
                    help="serve-cache layout: coplace_shmap = co-placement "
                         "over --shards page stripes, split-KV decode")
    ap.add_argument("--shards", type=int, default=1,
                    help="page stripes of coplace_shmap (the size of the JAX "
                         "mesh's 'model' axis)")
    ap.add_argument("--admission", choices=["fifo", "balanced"], default="fifo",
                    help="ragged admission order (balanced = per-stripe "
                         "page-load aware, sched/balance.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions of the kernels)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.h2eal == "off":
        cfg = dataclasses.replace(
            cfg, h2eal=dataclasses.replace(cfg.h2eal, enabled=False))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = M.init_params(cfg, generator=gen, device=dev, dtype=dtype)

    if args.workload == "ragged":
        buckets = [int(x) for x in args.prompt_buckets.split(",")]
        capacity = args.capacity or (max(buckets) + args.gen_max
                                     + cfg.h2eal.page_size)
        reqs = make_ragged_requests(cfg, n=args.requests, prompt_buckets=buckets,
                                    gen_min=args.gen_min, gen_max=args.gen_max,
                                    seed=args.seed)
        completions, stats = run_ragged(
            cfg, params, reqs, max_batch=args.max_batch, capacity=capacity,
            prompt_buckets=buckets, report_balance=args.report_balance,
            layout=args.layout, shards=args.shards, admission=args.admission,
            prefill_chunk=args.prefill_chunk or None, device=dev)
        print(f"[serve] arch={cfg.name} workload=ragged device={dev} "
              f"layout={args.layout} shards={args.shards} "
              f"admission={args.admission} "
              f"prefill_chunk={args.prefill_chunk or 'packed'} "
              f"requests={len(completions)} steps={stats['decode_steps']} "
              f"occupancy={stats['occupancy']:.2f} "
              f"({stats['tokens_per_s']:.1f} tok/s)")
        print(f"[serve] select/reuse steps: {stats['select_steps']}/"
              f"{stats['reuse_steps']}; admissions/chunks: "
              f"{stats['admissions']}/{stats['prefill_chunks']}; admission "
              f"reorders: {stats['admission_reorders']}")
        if "page_loads" in stats.get("balance", {}):
            bal = stats["balance"]
            print(f"[serve] per-stripe page loads {bal['page_loads']} "
                  f"(imbalance {bal['page_load_imbalance']:.2f})")
        if completions:
            some = completions[min(completions)]
            print(f"[serve] sample tokens (uid {some.uid}): {some.tokens[:16]}")
        return stats

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    toks, stats = generate(
        cfg, params, prompts, gen=args.gen,
        capacity=args.prompt_len + args.gen + cfg.h2eal.page_size,
        layout=args.layout, shards=args.shards, device=dev)
    print(f"[serve] arch={cfg.name} b={args.batch} device={dev} "
          f"prefill={stats['prefill_s']:.2f}s "
          f"decode={stats['decode_s']:.2f}s "
          f"({stats['tokens_per_s']:.1f} tok/s)")
    print(f"[serve] sample tokens: {toks[0, :16].tolist()}")
    return stats


if __name__ == "__main__":
    main()
