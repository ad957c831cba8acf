#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's lockstep serving path.

Runs llama3-8b (bf16, seeded random weights) on one CUDA card: one prefill
and a few decode steps, hybrid sparse and full attention, under
``torch.profiler``. For each it prints the wall time, the device's busy
time and idle share, the number of kernels launched, and the kernels that
take the most device time.

    PYTHONPATH=src python scripts/torch_profile_serve.py
"""
from __future__ import annotations

import dataclasses
import subprocess
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.models import model as M
from repro_torch.runtime import serve as serve_rt

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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = get_arch(ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, generator=gen, device=dev, dtype=torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    capacity = PROMPT + 2 * STEPS + 2 * cfg.h2eal.share_window + cfg.h2eal.page_size
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"{smi.stdout.strip() or torch.cuda.get_device_name(0)}; {cfg.name} "
          f"layers={cfg.num_layers} B={BATCH} S={PROMPT}")
    run(cfg, params, prompts, capacity, STEPS, "sparse")
    full = dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal, enabled=False))
    run(full, params, prompts, capacity, STEPS, "full")


if __name__ == "__main__":
    main()
