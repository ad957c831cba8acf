"""Head identification via gating on the PyTorch port (paper §IV-A.1,
DuoAttention-style; the counterpart of examples/head_identification.py).

A tiny model is trained on a retrieval task (needle-in-a-haystack copy)
with the α-gated attention mix:

    Attn = α · Full + (1-α) · Streaming,   loss = task + λ‖α‖₁

Heads that the task needs for long-range retrieval keep α high; the rest
collapse to streaming. The per-layer permutation (retrieval heads first)
is the plan the serving stack consumes (``gating.plan_from_perms``).

    PYTHONPATH=src python examples/torch_head_identification.py
    PYTHONPATH=src python examples/torch_head_identification.py --device cpu

It runs on the CUDA card unless ``--device`` names another device. The
model is the reference example's but for head_dim 32 (it has 16): 32 is
the smallest head_dim the card's attention kernels take.
"""
import argparse

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import gating
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.data import niah_batch
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.serve import resolve_device

LAM = 2e-3


def config():
    return reduced(get_arch("smollm-360m"), num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=2, d_ff=128, vocab_size=128, head_dim=32)


def loss_fn(cfg, params, alpha, tokens, answer):
    """(task + λ‖α‖₁, task): the answer's cross-entropy at the last position
    of the α-gated forward."""
    logits = M.forward(cfg, params, tokens, alpha=alpha, remat=False)
    logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
    task = -logp.gather(-1, answer.long()[:, None]).mean()
    return gating.gating_loss(task, alpha, LAM), task


def identify(cfg, params, *, steps: int, device, log_every: int = 30):
    """``steps`` AdamW steps on the weights and α from α = 1 over
    ``niah_batch`` steps 0, 1, ...; returns (params, α, [(loss, task, α
    gradient on the CPU)] a step)."""
    alpha = gating.init_alpha(cfg.num_layers, cfg.num_kv_heads, device=device)
    opt_p, opt_a = adamw.init_state(params), adamw.init_state(alpha)
    pcfg = adamw.AdamWConfig(lr=2e-3, weight_decay=0.0)
    acfg = adamw.AdamWConfig(lr=2e-2, weight_decay=0.0)
    trace = []
    for step in range(steps):
        batch = niah_batch(step, batch=16, seq=64, vocab=cfg.vocab_size, depth_frac=0.4)
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        a = alpha.detach().requires_grad_(True)
        loss, task = loss_fn(cfg, live, a, batch["tokens"].to(device),
                             batch["answer"].to(device))
        grads = torch.autograd.grad(loss, leaves(live) + [a])
        params, opt_p, _ = adamw.apply_updates(params, unflatten(params, grads[:-1]),
                                               opt_p, pcfg)
        alpha, opt_a, _ = adamw.apply_updates(alpha, grads[-1], opt_a, acfg)
        alpha = gating.clip_alpha(alpha)
        trace.append((loss.detach().item(), task.detach().item(), grads[-1].cpu()))
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:3d}  task {trace[-1][1]:.3f}  "
                  f"alpha {[[round(x, 2) for x in row] for row in alpha.tolist()]}")
    return params, alpha, trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config()
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    _, alpha, _ = identify(cfg, params, steps=150, device=dev)

    perms = gating.classify_heads(alpha, cfg.h2eal.static_sparsity)
    print("\nper-layer kv-head order (retrieval first):")
    for layer in range(cfg.num_layers):
        print(f"  layer {layer}: {perms[layer].tolist()}  "
              f"(α = {[round(x, 2) for x in alpha[layer].tolist()]})")
    n_r = cfg.num_kv_heads - round(cfg.num_kv_heads * cfg.h2eal.static_sparsity)
    ranked = torch.sort(alpha, dim=1).values
    print(f"\nmean α of retained retrieval heads: {float(ranked[:, -n_r:].mean()):.2f}; "
          f"of streaming heads: {float(ranked[:, :-n_r].mean()):.2f}")


if __name__ == "__main__":
    main()
