"""The training step (counterpart of ``repro/runtime/train.py``):
``make_train_step`` on whole parameters, and ``jit_train_step``, its mesh
half (ROADMAP Queue 1 item 9c), on the rank's blocks of them over the
ranks of a ``launch/mesh.Mesh``.

One step: microbatched gradient accumulation (f32 accumulators, bf16
under ``grad_dtype="bf16"``, as the reference's scan), remat of each layer
period, the bf16 round trip of the gradients, the cosine schedule and
AdamW. The loss and its gradients run through ``ops.flash_attention``: on
the card its forward kernels and the backward kernel of
``csrc/flash_attention_bwd.cu``.

On a mesh (``jit_train_step``) the parameters are cut by
``param_shardings(mode="train")``: FSDP over 'data' (where the
reference's rule turns it on) x TP over 'model'
(``runtime/tensor_parallel.py``); μ and ν by ``mode="opt"``; the batch
rows over 'data'. The reference reshapes the global batch into (mb, B/mb),
so microbatch i is global rows [i·B/mb, (i+1)·B/mb) and each rank takes
its block of each. A microbatch's loss is its rows' summed cross-entropy
over the microbatch's global label count, so the ranks' losses sum to the
reference's mean; each microbatch's gradient is summed over 'data' before
it is accumulated (the reference's "per-microbatch psum"), so
``grad_dtype="bf16"`` rounds what the reference rounds: an all_reduce for a
leaf not stored cut over 'data', the FSDP gather's backward for one that
is (it sums already: nothing is summed twice). A leaf whole over 'model'
receives the same gradient on every 'model' rank (``copy_to`` sums each
cut product's input gradient), so the ranks stay equal. On a one-rank
mesh every collective is skipped and the step is ``make_train_step``'s,
bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import collectives as coll
from repro_torch.runtime import sharding
from repro_torch.runtime import tensor_parallel as tplib


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


def train_shardings(cfg: ArchConfig, mesh, params):
    """The placements of the sharded step's state, as ``jit_train_step``'s
    in_shardings: {"params": mode "train", "opt": {"mu", "nu": mode "opt",
    "count": replicated}}."""
    pso = sharding.param_shardings(cfg, mesh, params, mode="opt")
    return {"params": sharding.param_shardings(cfg, mesh, params, mode="train"),
            "opt": {"mu": pso, "nu": pso, "count": ()}}


def place_train_state(cfg: ArchConfig, mesh, params, opt_state):
    """The rank's blocks of whole ``params`` and ``opt_state`` (a fresh
    ``adamw.init_state`` or a restored checkpoint's), by
    ``train_shardings``."""
    p, _ = sharding.place_params(cfg, mesh, params, "train")
    mu, _ = sharding.place_params(cfg, mesh, opt_state["mu"], "opt")
    nu, _ = sharding.place_params(cfg, mesh, opt_state["nu"], "opt")
    return p, {"mu": mu, "nu": nu, "count": opt_state["count"]}


def gather_train_state(cfg: ArchConfig, mesh, params_whole_shapes, params, opt_state):
    """The whole (logical) ``params`` and ``opt_state`` from the rank's
    blocks, on every rank (a checkpoint holds these, as the reference's
    does); ``params_whole_shapes`` is any tree of the whole leaves' shapes
    (the placements are read from it)."""
    specs = train_shardings(cfg, mesh, params_whole_shapes)
    return (sharding.gather_tree(params, specs["params"], mesh),
            {"mu": sharding.gather_tree(opt_state["mu"], specs["opt"]["mu"], mesh),
             "nu": sharding.gather_tree(opt_state["nu"], specs["opt"]["nu"], mesh),
             "count": opt_state["count"]})


def jit_train_step(cfg: ArchConfig, tcfg: TrainConfig, mesh, params, opt_state=None,
                   batch_size: int = 0):
    """The counterpart of the reference's ``jit_train_step``: returns
    train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics) on the rank's blocks (``place_train_state``) of the state, the
    batch the global one ((B, S) tokens and labels, every rank the same; B
    = ``batch_size``), the metrics the whole step's, the same on every rank.
    ``params`` gives the whole leaves' shapes (the placements are read from
    it); ``opt_state`` is not read. Every family but the frontend stubs
    (``tensor_parallel.check_config``); ``batch_size`` must divide by
    microbatches x 'data'. The activations are each rank's rows of the
    batch (``TensorParallel.batch_cut``): a MoE layer gathers its tokens over
    'data' to route them as one set."""
    del opt_state
    tplib.check_config(cfg)
    specs = train_shardings(cfg, mesh, params)
    if specs["opt"]["mu"] != specs["params"]:
        raise ValueError("the optimizer state and the parameters are placed apart")
    pspecs = specs["params"]
    tp = tplib.TensorParallel(mesh, pspecs, batch_cut=True)
    n_data, mb = mesh.shape["data"], tcfg.microbatches
    if batch_size % (mb * n_data):
        raise ValueError(f"batch {batch_size} does not divide into {mb} microbatches "
                         f"x {n_data} 'data' ranks")
    rows = batch_size // mb // n_data
    first = mesh.coord("data") * rows
    # the leaves the FSDP gather's backward sums over 'data' already
    summed = ["data" in sharding._cut_axes(s, mesh)
              for s in sharding.spec_leaves(params, pspecs)]
    ocfg = adamw.AdamWConfig(lr=tcfg.lr)
    gdtype = torch.bfloat16 if tcfg.grad_dtype == "bf16" else torch.float32

    def loss_fn(params, tokens, labels, count):
        return M.lm_loss(cfg, params, tokens, labels, remat=tcfg.remat, tp=tp,
                         count=count)

    def micro(params, tokens, labels):
        """One microbatch's (loss, gradient), its global rows in: the
        rank's rows through the model, both summed over 'data'."""
        count = torch.clamp((labels >= 0).sum(), min=1)
        loss, g = value_and_grad(loss_fn, params, tokens[first:first + rows],
                                 labels[first:first + rows], count)
        flat = [x if done else coll.sum_tiles(x, mesh, ("data",))
                for x, done in zip(leaves(g), summed)]
        return coll.sum_tiles(loss, mesh, ("data",)), unflatten(params, flat)

    def train_step(params, opt_state, batch, step):
        tokens, labels = batch["tokens"], batch["labels"]
        if tokens.shape[0] != batch_size:
            raise ValueError(f"batch of {tokens.shape[0]} rows, the step was made for "
                             f"{batch_size}")
        if mb > 1:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=gdtype, device=p.device),
                           params)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for t, l in zip(tokens.chunk(mb), labels.chunk(mb)):
                lv, g = micro(params, t, l)
                acc = tree_map(lambda a, x: a + x.to(gdtype), acc, g)
                loss = loss + lv
            grads = tree_map(lambda g: g.float() / mb, acc)
            loss = loss / mb
        else:
            loss, grads = micro(params, tokens, labels)
            grads = tree_map(lambda g: g.to(gdtype).float(), grads)
        lr_scale = adamw.cosine_schedule(step, warmup=tcfg.warmup,
                                         total=tcfg.total_steps).to(loss.device)
        params, opt_state, gnorm = adamw.apply_updates(params, grads, opt_state, ocfg,
                                                       lr_scale=lr_scale, mesh=mesh,
                                                       specs=pspecs)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr_scale": lr_scale}

    return train_step
