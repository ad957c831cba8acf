"""Long-context serving on the PyTorch port: H²EAL against full attention on
a reduced model, then the hbsim projection of LLaMA2-7B decode on the
paper's hybrid-bonding edge accelerator (the counterpart of
examples/serve_longcontext.py).

    PYTHONPATH=src python examples/torch_serve_longcontext.py
    PYTHONPATH=src python examples/torch_serve_longcontext.py --device cpu

It runs on the CUDA card unless ``--device`` names another device; the
tok/s it prints are that device's. The projection lines are the hbsim
cycle model's output for the paper's chip, not a measurement.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import H2ealConfig
from repro_torch.hbsim import attention_decode, e2e_decode
from repro_torch.launch.serve import generate
from repro_torch.models import model as M
from repro_torch.runtime.serve import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced(get_arch("smollm-360m"))
    cfg = dataclasses.replace(cfg, h2eal=H2ealConfig(
        sink=4, local=64, page_size=16, select_budget=256, share_window=4))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, generator=gen, device=dev, dtype=torch.float32)
    ctx = 1024
    prompts = torch.randint(0, cfg.vocab_size, (2, ctx), generator=gen, device=dev)

    print(f"== reduced model on {dev}, context {ctx}, decode 32 tokens ==")
    toks_h, st_h = generate(cfg, params, prompts, gen=32, capacity=ctx + 64,
                            device=dev)
    toks_f, st_f = generate(cfg, params, prompts, gen=32, capacity=ctx + 64,
                            h2eal=False, device=dev)
    print(f"  H²EAL : {st_h['decode_s']:.2f}s decode ({st_h['tokens_per_s']:.1f} tok/s)")
    print(f"  full  : {st_f['decode_s']:.2f}s decode ({st_f['tokens_per_s']:.1f} tok/s)")
    agree = (toks_h == toks_f).float().mean().item()
    print(f"  token agreement: {agree:.2f} (untrained weights)")

    print("\n== hbsim MODEL projection (not measured): LLaMA2-7B decode on the "
          "paper's HB edge chip ==")
    full_cfg = get_arch("llama2-7b")
    for seq in (65536, 262144):
        f = e2e_decode(full_cfg, seq, "full")
        h = e2e_decode(full_cfg, seq, "h2eal")
        att_f = attention_decode(full_cfg, seq, "full")
        att_h = attention_decode(full_cfg, seq, "h2eal")
        print(f"  ctx {seq // 1024:4d}k: full {f['tokens_per_s']:6.1f} tok/s -> "
              f"H²EAL {h['tokens_per_s']:6.1f} tok/s  (attention speedup "
              f"{att_f['latency_s'] / att_h['latency_s']:.1f}x)")


if __name__ == "__main__":
    main()
