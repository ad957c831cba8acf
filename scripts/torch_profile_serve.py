#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving paths.

Runs llama3-8b (bf16, seeded random weights) on one CUDA card under
``torch.profiler`` and prints, for each window, the wall time, the
device's busy time and idle share, the number of kernels launched, and the
kernels that take the most device time:

  * lockstep ``generate`` (default): one prefill and a few decode steps,
    hybrid sparse and full attention;
  * ``--engine``: the continuous-batching engine with chunked prefill on
    chip_smoke.py's engine workload (6 ragged requests on 4 slots, chunks
    of 512), a window of mixed steps (a prompt chunk beside decoding
    slots) and a window of decode-only steps; ``--layout coplace_shmap
    --shards S`` serves it co-placed over S page stripes (split-KV decode,
    FIFO admission, so the windows hold the same steps).

    PYTHONPATH=src python scripts/torch_profile_serve.py [--engine]
    PYTHONPATH=src python scripts/torch_profile_serve.py --engine \\
        --layout coplace_shmap --shards 8
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.models import model as M
from repro_torch.runtime import serve as serve_rt

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ARCH = "llama3-8b"
BATCH, PROMPT, STEPS = 2, 8192, 8  # chip_smoke.py's serving shapes


def device_kernels(prof):
    """(name, µs) of every kernel the card ran inside the profile."""
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def report(label, prof, wall_s, steps=1, top=8):
    kern = device_kernels(prof)
    busy_ms = sum(us for _, us in kern) / 1e3
    wall_ms = wall_s * 1e3
    print(f"[{label}] wall {wall_ms / steps:.3f} ms/step, device busy "
          f"{busy_ms / steps:.3f} ms/step, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, kernels {len(kern) / steps:.0f}/step")
    by_name = defaultdict(lambda: [0.0, 0])
    for name, us in kern:
        by_name[name][0] += us
        by_name[name][1] += 1
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {us / 1e3 / steps:9.3f} ms/step {n / steps:7.1f}/step  {name[:90]}")


def run(cfg, params, prompts, capacity, steps, label):
    scfg = serve_rt.ServeConfig(capacity=capacity)
    prefill = serve_rt.make_prefill(cfg, scfg)
    dec = [serve_rt.make_decode_step(cfg, scfg, do_select=s) for s in (False, True)]
    w = cfg.h2eal.share_window
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        prefill(params, prompts[:, :256])  # warm-up: library loads, cuBLAS
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, state = prefill(params, prompts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"{label} prefill", prof, wall)
        tok = logits.argmax(-1).to(torch.int32)
        for i in range(w):  # warm-up steps, one share window
            logits, state = dec[i % w == 0](params, state, tok)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, state = dec[i % w == 0](params, state, tok)
                tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"{label} decode", prof, wall, steps=steps)


def engine_windows(cfg, params, windows, layout="default", shards=1):
    """The chunked engine on chip_smoke.py's engine workload, profiled over
    each (label, first engine step, steps) window, then one unprofiled run
    of the whole workload."""
    from chip_smoke import ENGINE_BATCH, ENGINE_CHUNK, engine_workload
    from repro_torch.serving.engine import Engine

    reqs, capacity = engine_workload(cfg)
    make = lambda params: Engine(
        cfg, params, max_batch=ENGINE_BATCH, capacity=capacity,
        prompt_buckets=sorted({len(r.prompt) for r in reqs}),
        prefill_chunk=ENGINE_CHUNK, layout=layout, shards=shards)
    eng = make(params)
    for r in reqs:
        eng.submit(r)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        for label, first, n in windows:
            while eng.busy() and eng.stats.engine_steps < first:
                eng.poll()
            torch.cuda.synchronize()
            s0 = dataclasses.replace(eng.stats)
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                while eng.busy() and eng.stats.engine_steps < first + n:
                    eng.poll()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            s1 = eng.stats
            done = s1.engine_steps - s0.engine_steps
            print(f"[engine {label}] engine steps {s0.engine_steps}..{s1.engine_steps}: "
                  f"{s1.prefill_chunks - s0.prefill_chunks} chunk, "
                  f"{s1.decode_steps - s0.decode_steps} decode "
                  f"({s1.select_steps - s0.select_steps} select)")
            report(f"engine {label}", prof, wall, steps=max(done, 1), top=10)
        eng = make(params)
        comps = eng.run(reqs)
        s = eng.stats
        print(f"[engine run] {s.tokens_out} tokens in {s.wall_s:.3f}s = "
              f"{s.tokens_per_s:.2f} tok/s, {s.engine_steps} engine steps "
              f"({s.prefill_chunks} chunk, {s.decode_steps} decode); tokens of "
              f"uid 0: {comps[0].tokens}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", action="store_true",
                    help="profile the chunked continuous-batching engine instead")
    ap.add_argument("--layout", choices=["default", "coplace_shmap"], default="default",
                    help="the engine's serve-cache layout")
    ap.add_argument("--shards", type=int, default=1,
                    help="coplace_shmap's page stripes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = get_arch(ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, generator=gen, device=dev, dtype=torch.bfloat16)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip() or torch.cuda.get_device_name(0)
    if args.engine:
        print(f"{card}; {cfg.name} layers={cfg.num_layers} chunked engine, layout "
              f"{args.layout} shards={args.shards}")
        # steps 20-27: slot 0 decodes while slot 1's prompt is fed; from
        # step 62 every prompt is in and the slots only decode
        engine_windows(cfg, params, [("mixed", 20, 8), ("decode-only", 62, 8)],
                       layout=args.layout, shards=args.shards)
        return
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    capacity = PROMPT + 2 * STEPS + 2 * cfg.h2eal.share_window + cfg.h2eal.page_size
    print(f"{card}; {cfg.name} layers={cfg.num_layers} B={BATCH} S={PROMPT}")
    run(cfg, params, prompts, capacity, STEPS, "sparse")
    full = dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal, enabled=False))
    run(full, params, prompts, capacity, STEPS, "full")


if __name__ == "__main__":
    main()
