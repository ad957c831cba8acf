"""Training driver with fault tolerance (counterpart of
``repro/launch/train.py``).

  * resumes from the latest checkpoint (step-atomic; the data stream is a
    function of the step, so a restarted run sees the batches it would
    have seen);
  * a per-step watchdog: a step slower than ``--watchdog`` seconds is
    reported and counted as a straggler;
  * ``--crash-at N`` raises after N steps (the resume-exactness check);
  * over ranks: under ``torchrun`` (or in a process that has joined a
    process group already) every step is ``runtime/train.jit_train_step``
    on the reference CLI's mesh, every rank on 'data' (world, 1): NCCL on
    cards, gloo with ``--device cpu``. Each rank draws the global batch and
    takes its rows; rank 0 logs. A checkpoint holds the whole (logical)
    tree, gathered, written by rank 0, and a restore cuts it onto whatever
    mesh runs, one rank too: the reference's elastic restore. Without a
    group it is one device, as it always was (a one-rank mesh equals no
    mesh). Every family but the frontend stubs trains so (a MoE layer
    gathers its tokens over 'data' before its router).
    Tensor-parallel training ('model' > 1) is reached through the Python
    API, as in the reference, whose CLI has no such flag.

Runs on the card unless ``--device cpu``. On the card the attention and
its gradient are the port's kernels, and PyTorch's deterministic
algorithms are on for the run, so that a resumed run repeats the
uninterrupted one's losses: an op without a deterministic implementation
raises. They need cuBLAS's workspace setting ``CUBLAS_WORKSPACE_CONFIG``
before CUDA starts: importing this module sets it (unless set), so a
program that starts CUDA before it imports this module sets it itself.

    python -m repro_torch.launch.train --arch smollm-360m --steps 6 \\
        --batch 8 --seq 2048 --ckpt-dir ckpt --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --steps 30 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch smollm-360m --reduced --steps 4 --batch 4 --seq 32 --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch import ckpt
from repro_torch.configs import get_arch, reduced
from repro_torch.core.tree import tree_map
from repro_torch.data import lm_batch
from repro_torch.launch import mesh as meshlib
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import train as train_rt
from repro_torch.runtime.serve import resolve_device

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--watchdog", type=float, default=120.0,
                    help="straggler threshold (s/step)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="raise after N steps (fault-tolerance test)")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    joined = "RANK" in os.environ and not dist.is_initialized()  # under torchrun
    if joined:
        if args.device is None:
            args.device = str(meshlib.local_device())
        meshlib.init_distributed("nccl" if torch.device(args.device).type == "cuda"
                                 else "gloo")
    try:
        return _main(args)
    finally:
        if joined and dist.get_backend() == "gloo":
            dist.destroy_process_group()


def _main(args):
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.embed_frontend_stub:
        # the reference's CLI feeds these archs lm_batch token ids where
        # embeddings are due and fails in its first forward (ROADMAP Queue 3)
        raise ValueError(
            f"{cfg.name} takes precomputed embeddings: this CLI's data stream "
            f"is lm_batch token ids, as the reference's; train the arch through "
            f"runtime.train.make_train_step with embedding batches")
    tcfg = train_rt.TrainConfig(microbatches=args.microbatches, remat=True,
                                lr=args.lr, total_steps=args.steps)
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
    if dev.type == "cuda":
        torch.use_deterministic_algorithms(True)
    try:
        return _train(args, cfg, tcfg, dev)
    finally:
        torch.use_deterministic_algorithms(deterministic[0], warn_only=deterministic[1])


def _train(args, cfg, tcfg, dev):
    mesh = meshlib.make_local_mesh() if dist.is_initialized() else None
    chief = mesh is None or dist.get_rank() == 0
    say = print if chief else (lambda *a, **k: None)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, generator=gen, device=dev)
    opt_state = adamw.init_state(params)
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        restored, meta = ckpt.restore(args.ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        start_step = int(meta["step"]) + 1
        shape = tuple(mesh.sizes) if mesh is not None else (1, 1)
        say(f"[train] resumed from step {meta['step']} (elastic mesh {shape})")

    if mesh is None:
        step_fn = train_rt.make_train_step(cfg, tcfg)
    else:
        shapes = tree_map(lambda t: torch.empty(t.shape, device="meta"), params)
        step_fn = train_rt.jit_train_step(cfg, tcfg, mesh, shapes, None, args.batch)
        params, opt_state = train_rt.place_train_state(cfg, mesh, params, opt_state)
    stragglers = 0
    loss = float("nan")
    for step in range(start_step, args.steps):
        t0 = time.time()
        batch = {k: v.to(dev) for k, v in lm_batch(
            step, batch=args.batch, seq=args.seq, vocab=cfg.vocab_size,
            seed=args.seed).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if dt > args.watchdog:
            stragglers += 1
            say(f"[train] WARNING step {step} straggled: {dt:.1f}s")
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"[train] step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            whole = ((params, opt_state) if mesh is None else
                     train_rt.gather_train_state(cfg, mesh, shapes, params, opt_state))
            if chief:
                ckpt.save(args.ckpt_dir, {"params": whole[0], "opt": whole[1]}, step=step,
                          metadata={"step": step, "seed": args.seed})
                ckpt.prune_old(args.ckpt_dir, keep=2)
            del whole
        if args.crash_at is not None and step + 1 >= args.crash_at:
            raise RuntimeError(f"injected crash at step {step}")
    say(f"[train] done: {args.steps} steps, {stragglers} stragglers, "
        f"final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
