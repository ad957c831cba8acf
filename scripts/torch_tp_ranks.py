#!/usr/bin/env python3
"""Tensor-parallel ``generate(mesh=...)`` and the sharded train step over NCCL
ranks, one a card (ROADMAP items 9c, 9d): llama3-8b's weights cut by the
reference's ``param_shardings``; with ``--families``, the MoE, recurrent
and local:global families instead.

Each process of ``torchrun`` is one rank on its own card.

  * generate: llama3-8b whole, bf16 seeded weights, ``chip_smoke.py``'s
    BATCH prompts of TP_A_PROMPT tokens, TP_GEN new: every rank first runs
    ``generate(mesh=None)`` alone, then ``generate`` on (data, model) =
    (1, 4) for each of the five layouts (the weights over 'model', a
    quarter of each cut leaf a card). Rank 0 checks that every rank's tokens
    are the same and equal one rank's up to a near-tie (``chip_smoke.py``'s
    rule), and prints decode steps/s beside one rank's and the rank's
    parameter bytes.
  * train: llama3-8b f32 on (2, 2), FSDP over 'data' (the reference's rule
    turns it on) x TP over 'model', B = 4 x S = 2048, 2 steps: the step
    seconds, the peak memory a card and a rank's parameter and AdamW bytes,
    each step's loss and grad norm (no card holds the whole model's AdamW
    step, so nothing is compared). First at PROBE_LAYERS depths, whose
    peaks project the full depth's (linear in the layers); the full depth
    runs if the projection leaves HEADROOM_GIB of the card free, else the
    deepest multiple of 4 layers that does, and the projection is printed.

With ``--families``, ``chip_smoke.py``'s phase 16c families at its sizes
(TP_C_SERVE: qwen3-moe at 2 layers with all 128 experts, zamba2 at one
period, xlstm-125m and gemma3-1b whole): ``generate`` of each on (4, 1),
the experts' dim E over the four 'data' ranks (32 experts a card), and on
(1, 4), beside ``generate(mesh=None)``, with the same checks and figures;
then the sharded steps of TP_C_TRAIN's families on (2, 2), each step's loss
and grad norm beside the one-rank step's (rank 0 runs it after the mesh's,
its card alone), within ``chip_smoke.TP_TRAIN_RTOL``.

Every rank then releases what it holds and calls ``destroy_process_group``
on a thread, waiting a bounded time (``torch_gspmd_ranks.probe_teardown``),
and exits through ``os._exit``.

    torchrun --standalone --nproc-per-node 4 scripts/torch_tp_ranks.py
    torchrun --standalone --nproc-per-node 4 scripts/torch_tp_ranks.py --families
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from torch_gspmd_ranks import probe_teardown  # noqa: E402

TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 2
PROBE_LAYERS = (4, 8)
HEADROOM_GIB = 4.0


def generate_cases(dev, mesh, card) -> tuple:
    """Each layout's ``generate`` on ``mesh`` beside ``generate(mesh=None)``:
    (results by layout, failures), rank 0's checks."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate

    cfg = get_arch(cs.ARCH)
    params = cs.full_params(dev, cfg)
    capacity = cs.TP_A_PROMPT + cs.TP_GEN + cfg.h2eal.page_size
    prompts = cs.tp_prompts(cfg, cs.TP_A_PROMPT, dev)
    want, ws = generate(cfg, params, prompts, gen=cs.TP_GEN, capacity=capacity, device=dev)
    out, bad = {}, []
    for layout in cs.TP_LAYOUTS:
        got, gs = generate(cfg, params, prompts, gen=cs.TP_GEN, capacity=capacity,
                           layout=layout, mesh=mesh, device=dev)
        toks = [torch.zeros_like(got) for _ in range(dist.get_world_size())]
        dist.all_gather(toks, got)
        out[layout] = dict(tokens=got.tolist(), same_across=all(torch.equal(t, got)
                                                                for t in toks),
                           param_bytes=gs["param_bytes"], prefill_s=gs["prefill_s"],
                           decode_s=gs["decode_s"], one_prefill_s=ws["prefill_s"],
                           one_decode_s=ws["decode_s"], one_param_bytes=ws["param_bytes"])
        if dist.get_rank() == 0:
            what = f"generate {layout} on {mesh.shape}"
            if not out[layout]["same_across"]:
                bad.append(f"{what}: the ranks' tokens differ")
            ties = cs.check_ties(cfg, params, cs.tp_requests(prompts, cs.TP_GEN),
                                 dict(enumerate(got.tolist())),
                                 dict(enumerate(want.tolist())), {}, capacity, dev,
                                 cs.BF16_LOGIT_BAND, what, relative=True)
            r = out[layout]
            cs.log(f"{what} on {card}: tokens equal across ranks {r['same_across']}, equal "
                   f"to one rank's {got.tolist() == want.tolist()} (near-tie divergences "
                   f"{ties}); prefill {r['prefill_s']:.3f}s (one rank "
                   f"{r['one_prefill_s']:.3f}s), {cs.TP_GEN / r['decode_s']:.2f} decode "
                   f"steps/s (one rank {cs.TP_GEN / r['one_decode_s']:.2f}); parameter "
                   f"bytes a rank {r['param_bytes']} of {r['one_param_bytes']}")
    del params
    cs._release(dev)
    return out, bad


def family_generate(dev, meshes, card) -> tuple:
    """``generate`` of each TP_C_SERVE family on each mesh of ``meshes``
    beside ``generate(mesh=None)``: (results, failures), rank 0's checks."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    out, bad = {}, []
    for label, arch, layers, prompt in cs.TP_C_SERVE:
        cfg = cs.tp_train_config(arch, layers)
        params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                               device=dev, dtype=torch.bfloat16)
        capacity = prompt + cs.TP_GEN + cfg.h2eal.page_size
        prompts = cs.tp_prompts(cfg, prompt, dev)
        want, ws = generate(cfg, params, prompts, gen=cs.TP_GEN, capacity=capacity,
                            device=dev)
        for mesh in meshes:
            got, gs = generate(cfg, params, prompts, gen=cs.TP_GEN, capacity=capacity,
                               mesh=mesh, device=dev)
            toks = [torch.zeros_like(got) for _ in range(dist.get_world_size())]
            dist.all_gather(toks, got)
            what = f"generate {cfg.name} at {cfg.num_layers} layers on {mesh.shape}"
            r = out[f"{label} {tuple(mesh.sizes)}"] = dict(
                same_across=all(torch.equal(t, got) for t in toks),
                param_bytes=gs["param_bytes"], one_param_bytes=ws["param_bytes"],
                prefill_s=gs["prefill_s"], decode_s=gs["decode_s"],
                one_prefill_s=ws["prefill_s"], one_decode_s=ws["decode_s"])
            if dist.get_rank() == 0:
                if not r["same_across"]:
                    bad.append(f"{what}: the ranks' tokens differ")
                ties = cs.check_ties(cfg, params, cs.tp_requests(prompts, cs.TP_GEN),
                                     dict(enumerate(got.tolist())),
                                     dict(enumerate(want.tolist())), {}, capacity, dev,
                                     cs.BF16_LOGIT_BAND, what, relative=True)
                cs.log(f"{what} on {card}: tokens equal across ranks {r['same_across']}, "
                       f"equal to one rank's {got.tolist() == want.tolist()} (near-tie "
                       f"divergences {ties}); prefill {r['prefill_s']:.3f}s (one rank "
                       f"{r['one_prefill_s']:.3f}s), {cs.TP_GEN / r['decode_s']:.2f} decode "
                       f"steps/s (one rank {cs.TP_GEN / r['one_decode_s']:.2f}); parameter "
                       f"bytes a rank {r['param_bytes']} of {r['one_param_bytes']}")
            cs._release(dev)
        del params
        cs._release(dev)
    return out, bad


def family_train(dev, mesh, card) -> tuple:
    """The sharded steps of TP_C_TRAIN's families on ``mesh``, then rank 0's
    one-rank step (the others wait): (results, failures)."""
    out, bad = {}, []
    for label, arch, layers, experts, b, s, steps in cs.TP_C_TRAIN:
        cfg = cs.tp_train_config(arch, layers, experts)
        n = max(steps.values())
        r = cs.tp_train_run(cfg, mesh, b, s, n, dev)
        peak = torch.tensor([r["peak_gib"]], device=dev)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        cs._release(dev)
        if dist.get_rank() == 0:
            one = cs.tp_train_run(cfg, None, b, s, n, dev)
            cs._release(dev)
            rel = max(abs(g - w) / abs(w) for gm, wm in zip(r["metrics"], one["metrics"])
                      for g, w in zip(gm, wm))
            out[label] = dict(r, peak_max_gib=float(peak), one=one, rel=rel)
            cs.log(f"train {label} ({arch}, {cfg.num_layers} layers"
                   f"{f', {experts} experts' if experts else ''}) on {mesh.shape}, f32, "
                   f"B={b} S={s} on {card}: losses {[m[0] for m in r['metrics']]}, grad "
                   f"norms {[m[1] for m in r['metrics']]}, largest relative difference "
                   f"from one rank {rel:.3e}; step s {[round(x, 3) for x in r['step_s']]} "
                   f"(one rank {[round(x, 3) for x in one['step_s']]}); peak "
                   f"{float(peak):.2f} GiB a card (one rank {one['peak_gib']:.2f}); "
                   f"parameter bytes a rank {r['param_bytes']} of {one['param_bytes']}, "
                   f"AdamW {r['opt_bytes']} of {one['opt_bytes']}")
            if not rel <= cs.TP_TRAIN_RTOL:
                bad.append(f"train {label}: leaves the band of the one-rank step")
        dist.barrier()
    return out, bad


def train_case(dev, mesh, layers: int) -> dict:
    """``cs.tp_train_run`` of llama3-8b at ``layers`` on ``mesh``, with the
    largest peak memory over the ranks."""
    cfg = dataclasses.replace(cs.tp_train_config(cs.ARCH, 0), num_layers=layers)
    cs._release(dev)
    t0 = time.perf_counter()
    r = cs.tp_train_run(cfg, mesh, TRAIN_B, TRAIN_S, TRAIN_STEPS, dev)
    peak = torch.tensor([r["peak_gib"]], device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    r.update(layers=layers, peak_max_gib=float(peak), wall=time.perf_counter() - t0)
    cs._release(dev)
    return r


def main() -> int:
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as meshlib

    dev = meshlib.local_device()
    torch.cuda.set_device(dev)
    meshlib.init_distributed("nccl")
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != 4:
        raise SystemExit(f"run under torchrun with 4 ranks, one a card (got {world})")
    card = cs.card_name_and_limit()
    if rank == 0:
        print(card, flush=True)
        t0 = time.perf_counter()
        _build.build()
        cs.log(f"kernels built in {time.perf_counter() - t0:.1f}s")
    dist.barrier()
    meshes = {m: meshlib.make_local_mesh(model=m) for m in (4, 2, 1)}
    if "--families" in sys.argv[1:]:
        t0 = time.perf_counter()
        gen, bad = family_generate(dev, (meshes[1], meshes[4]), card)
        train, bad_t = family_train(dev, meshes[2], card)
        bad += bad_t
        if rank == 0:
            cs.log(f"families {time.perf_counter() - t0:.1f}s")
            print(json.dumps({"card": card, "generate": gen, "train": train,
                              "failures": bad}), flush=True)
            for b in bad:
                cs.log(f"FAIL: {b}")
        return finish(rank, dev, bad)
    t0 = time.perf_counter()
    gen, bad = generate_cases(dev, meshes[4], card)
    if rank == 0:
        cs.log(f"generate cases {time.perf_counter() - t0:.1f}s")
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    probes = [train_case(dev, meshes[2], n) for n in PROBE_LAYERS]
    (l0, p0), (l1, p1) = ((p["layers"], p["peak_max_gib"]) for p in probes)
    per_layer = (p1 - p0) / (l1 - l0)
    full = cs.tp_train_config(cs.ARCH, 0).num_layers

    def projected(n):
        return p1 + per_layer * (n - l1)
    layers = full
    while layers > l1 and projected(layers) > total - HEADROOM_GIB:
        layers -= 4
    runs = probes + ([train_case(dev, meshes[2], layers)] if layers > l1 else [])
    if rank == 0:
        cs.log(f"train: the card holds {total:.1f} GiB; peak {p0:.2f} GiB at {l0} layers, "
               f"{p1:.2f} at {l1}: {per_layer:.3f} GiB a layer, {projected(full):.1f} GiB "
               f"projected at {full} layers; ran {layers}")
        for r in runs:
            cs.log(f"train llama3-8b on {meshes[2].shape} at {r['layers']} layers, f32, "
                   f"B={TRAIN_B} S={TRAIN_S} on {card}: losses "
                   f"{[m[0] for m in r['metrics']]}, grad norms "
                   f"{[m[1] for m in r['metrics']]}, step s "
                   f"{[round(x, 3) for x in r['step_s']]}, peak {r['peak_max_gib']:.2f} GiB "
                   f"a card (largest of the ranks), parameter bytes a rank "
                   f"{r['param_bytes']}, AdamW bytes {r['opt_bytes']}")
        print(json.dumps({"card": card, "generate": gen, "train": runs,
                          "projected_full_gib": projected(full), "failures": bad}),
              flush=True)
        for b in bad:
            cs.log(f"FAIL: {b}")
    return finish(rank, dev, bad)


def finish(rank: int, dev, bad) -> int:
    """Rank 0's failures to every rank, then the bounded teardown: the exit
    code."""
    flag = torch.tensor([len(bad)], device=dev)
    dist.broadcast(flag, 0)
    code = 1 if int(flag.item()) else 0
    cs.log(f"rank {rank}: done, exit {code}")
    probe_teardown(rank)
    return code


if __name__ == "__main__":
    # exit through os._exit whatever the teardown probe found (ROADMAP Queue 3)
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
