"""Lockstep serving entry point (counterpart of ``repro/launch/serve.py``).

One fixed batch: every request shares one prompt length and one
generation length. Page selection runs every ``share_window`` steps (the
select step), cheaper reuse steps in between. Greedy sampling.

It runs on the card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --batch 2 --prompt-len 8192 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --reduced --prompt-len 96 --gen 16 --device cpu

The continuous-batching engine is not ported yet (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models import model as M
from repro_torch.runtime import serve as serve_rt


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; no silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params, prompts, *, gen: int, capacity: int,
             layout: str = "default", h2eal: bool = True, greedy: bool = True,
             device=None):
    """Lockstep generation. prompts: (B, S) int tokens.
    Returns (tokens (B, gen) int32 tensor, stats dict)."""
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
    scfg = serve_rt.ServeConfig(capacity=capacity, layout=layout)
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--h2eal", choices=["on", "off"], default="on")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions of the kernels)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = M.init_params(cfg, generator=gen, device=dev, dtype=dtype)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    toks, stats = generate(
        cfg, params, prompts, gen=args.gen,
        capacity=args.prompt_len + args.gen + cfg.h2eal.page_size,
        h2eal=args.h2eal == "on", device=dev)
    print(f"[serve] arch={cfg.name} b={args.batch} device={dev} "
          f"prefill={stats['prefill_s']:.2f}s "
          f"decode={stats['decode_s']:.2f}s "
          f"({stats['tokens_per_s']:.1f} tok/s)")
    print(f"[serve] sample tokens: {toks[0, :16].tolist()}")
    return stats


if __name__ == "__main__":
    main()
