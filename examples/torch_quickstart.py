"""Quickstart on the PyTorch port: train a small model on synthetic data,
then serve it with H²EAL hybrid sparse attention (the counterpart of
examples/quickstart.py).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

It runs on the CUDA card unless ``--device`` names another device: there
the attention and its gradient are the port's kernels.
"""
import argparse

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.data import lm_batch
from repro_torch.launch.serve import generate
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import train as train_rt
from repro_torch.runtime.serve import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced(get_arch("smollm-360m"))
    print(f"arch: {cfg.name} ({cfg.num_layers}L d={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads}) on {dev}")

    # --- train ---------------------------------------------------------
    tcfg = train_rt.TrainConfig(remat=False, lr=1e-3, total_steps=60)
    step_fn = train_rt.make_train_step(cfg, tcfg)
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    opt = adamw.init_state(params)
    for step in range(60):
        batch = {k: v.to(dev) for k, v in
                 lm_batch(step, batch=8, seq=96, vocab=cfg.vocab_size).items()}
        params, opt, m = step_fn(params, opt, batch, step)
        if step % 20 == 0 or step == 59:
            print(f"  step {step:3d}  loss {float(m['loss']):.4f}")

    # --- serve with hybrid sparse attention ----------------------------
    prompts = lm_batch(999, batch=2, seq=96, vocab=cfg.vocab_size)["tokens"]
    toks, stats = generate(cfg, params, prompts, gen=16, capacity=160, device=dev)
    print(f"serve (H²EAL): {stats['tokens_per_s']:.1f} tok/s")
    toks_full, _ = generate(cfg, params, prompts, gen=16, capacity=160, h2eal=False,
                            device=dev)
    agree = (toks == toks_full).float().mean()
    print(f"token agreement sparse vs full on a trained model: {float(agree):.2f}")
    print(f"generated: {toks[0].tolist()}")


if __name__ == "__main__":
    main()
