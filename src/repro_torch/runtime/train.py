"""The training step (counterpart of ``repro/runtime/train.py``'s
``make_train_step``; its mesh half, ``jit_train_step``, has no meaning on
one card and waits with the GSPMD layouts, ROADMAP Queue 1 item 14).

One step: microbatched gradient accumulation (f32 accumulators, bf16
under ``grad_dtype="bf16"``, as the reference's scan), remat of each layer
period, the bf16 round trip of the gradients, the cosine schedule and
AdamW. The loss and its gradients run through ``ops.flash_attention``: on
the card its forward kernels and the backward kernel of
``csrc/flash_attention_bwd.cu``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.models import model as M
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    grad_dtype: str = "f32"       # "f32" | "bf16"
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000


def value_and_grad(loss_fn, params, *args):
    """(loss, gradient tree of ``params``) of ``loss_fn(params, *args)``,
    the loss detached."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = loss_fn(live, *args)
    grads = torch.autograd.grad(loss, leaves(live))
    return loss.detach(), unflatten(params, grads)


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics {loss, grad_norm, lr_scale}); the inputs are left as
    they were. ``batch["tokens"]`` is (B, S) token ids, or a frontend stub's
    (B, S, d_model) embeddings; ``batch["labels"]`` (B, S) int either way."""
    ocfg = adamw.AdamWConfig(lr=tcfg.lr)
    gdtype = torch.bfloat16 if tcfg.grad_dtype == "bf16" else torch.float32

    def loss_fn(params, tokens, labels):
        return M.lm_loss(cfg, params, tokens, labels, remat=tcfg.remat)

    def train_step(params, opt_state, batch, step):
        tokens, labels = batch["tokens"], batch["labels"]
        mb = tcfg.microbatches
        if mb > 1:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=gdtype, device=p.device),
                           params)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for t, l in zip(tokens.chunk(mb), labels.chunk(mb)):
                lv, g = value_and_grad(loss_fn, params, t, l)
                acc = tree_map(lambda a, x: a + x.to(gdtype), acc, g)
                loss = loss + lv
            grads = tree_map(lambda g: g.float() / mb, acc)
            loss = loss / mb
        else:
            loss, grads = value_and_grad(loss_fn, params, tokens, labels)
            grads = tree_map(lambda g: g.to(gdtype).float(), grads)
        lr_scale = adamw.cosine_schedule(step, warmup=tcfg.warmup,
                                         total=tcfg.total_steps).to(loss.device)
        params, opt_state, gnorm = adamw.apply_updates(params, grads, opt_state, ocfg,
                                                       lr_scale=lr_scale)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr_scale": lr_scale}

    return train_step
