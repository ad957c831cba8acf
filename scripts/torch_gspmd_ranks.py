#!/usr/bin/env python3
"""The GSPMD layouts over NCCL ranks, one a card: llama3-8b served by every
rank's engine with captured steps, held to the one-rank default engine.

Each process of ``torchrun`` is one rank on its own card. Every rank first
runs the default engine of each case's options alone (no collective), then
the case's GSPMD engine on its mesh (captured steps, the collectives
inside the graphs), on ``chip_smoke.py``'s phase 15a workload (4 requests
of 2048-8192 prompt tokens, 16 new each, the last sampled), fed 512
prompt tokens an engine step:

  * ``coplace`` over (data, model) = (1, 4): plain, speculative (k = 4,
    the n-gram draft) and tiered (phase 9's page budget, the first decoding
    request forced cold);
  * ``interleave`` over (2, 2) on 4 slots: the batch over 'data', the
    pages over 'model';
  * ``head`` over (4, 1) on 4 slots, one slot a rank, with
    retire-triggered rebalancing: the migration moves a slot's row to
    another rank;
  * ``coplace_shmap`` over (1, 4), rank r of 'model' holding page stripe r:
    plain, speculative (k = 4, the n-gram draft) and tiered (a request
    forced cold); and over (2, 2) on 4 slots, rebalanced (the batch over
    'data', a stripe a rank of 'model'). Each is also held to the one-card
    ``coplace_shmap`` engine over as many stripes as 'model' has ranks,
    which every rank runs alone first (the same select rule: a masked
    selected page -1, where the default keeps it as fill).

Then the other families, whole (``--layers`` cuts llama3-8b alone), on 4
requests of 1024-2048 prompt tokens (16 new each, the last sampled):

  * zamba2-2.7b on ``head`` over (4, 1) on 4 slots, rebalanced: the
    recurrent states' rows over 'data', one slot a rank (a CPU run of this
    schedule with zamba2's cost model moves slot 3 to slot 0);
  * gemma3-1b on ``coplace`` over (1, 4): its global layers' pages over
    'model' (partials at head_dim 256), its window layers' full caches
    whole on every rank (one kv head).

Rank 0 checks that every rank's tokens and counters are the same, that the
tokens equal the default engine's up to a near-tie (``chip_smoke.py``'s
rule: the layouts that shard pages sum the attention in another order),
the counters equal the default's where the tokens do (``coplace_shmap``'s
tokens also the one-card engine's, its counters that one's alone), and
that each case
did what it is there for (verify steps, a forced miss filled, a migration
across ranks; a family case's migrations are reported); it prints the
card's name and power limit (``nvidia-smi``), a line a case (decode
steps/s beside the default's and the one-card engine's, the verify step's
median device ms, far-store bytes) and a JSON line of the results, and
exits non-zero on a failure.

Every rank then releases what it holds, synchronises, and calls
``destroy_process_group`` on a thread of its own, waiting for it at most
TEARDOWN_S seconds; it reports whether the call returned, and exits
through ``os._exit`` either way (the process hung in that teardown once,
ROADMAP Queue 3).

    torchrun --standalone --nproc-per-node 4 scripts/torch_gspmd_ranks.py [--layers N]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import threading
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

# (name, layout, 'model' ranks, slots, engine options)
CASES = (("coplace_plain", "coplace", 4, cs.ENGINE_BATCH, {}),
         ("coplace_spec", "coplace", 4, cs.ENGINE_BATCH,
          dict(spec_tokens=cs.SPEC_K, draft="ngram")),
         ("coplace_tiered", "coplace", 4, cs.ENGINE_BATCH,
          dict(hot_pages=cs.TIER_HOT_PAGES)),
         ("interleave_plain", "interleave", 2, cs.ENGINE_BATCH, {}),
         ("head_rebalanced", "head", 1, cs.ENGINE_BATCH, dict(rebalance="retire")),
         ("shmap_plain", "coplace_shmap", 4, cs.ENGINE_BATCH, {}),
         ("shmap_spec", "coplace_shmap", 4, cs.ENGINE_BATCH,
          dict(spec_tokens=cs.SPEC_K, draft="ngram")),
         ("shmap_tiered", "coplace_shmap", 4, cs.ENGINE_BATCH,
          dict(hot_pages=cs.TIER_HOT_PAGES)),
         ("shmap_rebalanced", "coplace_shmap", 2, cs.ENGINE_BATCH,
          dict(rebalance="retire")))
# the other families, whole: (name, arch, layout, 'model' ranks, slots,
# options), on FAMILY_WORKLOAD
FAMILY_CASES = (("zamba2_head_rebalanced", cs.Z_ARCH, "head", 1, cs.ENGINE_BATCH,
                 dict(rebalance="retire")),
                ("gemma3_coplace", cs.G3_ARCH, "coplace", 4, cs.ENGINE_BATCH, {}))
FAMILY_WORKLOAD = dict(prompts=(1024, 2048), n=4, new=16, seed=5)
TEARDOWN_S = 60


def serve(cfg, params, dev, reqs, capacity, layout, mesh, max_batch, kw, shards=1):
    """One engine of ``kw`` (the default layout where ``mesh`` is None, or
    with ``shards`` > 1 the one-card ``coplace_shmap`` engine over that many
    stripes), its tiered request forced cold: tokens, counters, moves,
    timings."""
    from repro_torch.serving.engine import Engine

    t0 = time.perf_counter()
    eng = Engine(cfg, params, max_batch=max_batch, capacity=capacity,
                 prompt_buckets=sorted({len(r.prompt) for r in reqs}),
                 prefill_chunk=cs.ENGINE_CHUNK,
                 layout=layout if mesh or shards > 1 else "default", shards=shards,
                 mesh=mesh, device=dev, **kw)
    t_build = time.perf_counter() - t0
    sizes = eng.jit_cache_sizes()
    times = cs.ReplayTimes(eng._graphs)
    moves, migrate = [], eng._migrate_slot

    def logged(src, dst):
        moves.append([src, dst])
        migrate(src, dst)
    eng._migrate_slot = logged
    _, wall, forced = cs.serve_forced(eng, reqs, cs.TIER_FORCE_AFTER if eng.hot_pages
                                      else None)
    s = eng.stats
    out = dict(tokens={str(u): c.tokens for u, c in eng.completions.items()},
               counters=cs.counters(s, cs.SPEC_COUNTERS + cs.TIER_COUNTERS
                                    + cs.REBALANCE_COUNTERS),
               moves=moves, forced=forced, wall=wall, build=t_build,
               decode_steps=s.decode_steps, captures=[sizes, eng.jit_cache_sizes()],
               verify_ms=times.median_ms().get("verify"),
               far=None if eng._tier is None else [eng._tier.h2d_bytes,
                                                   eng._tier.d2h_bytes])
    del eng, times
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut llama3-8b to N layers (0: full depth)")
    args = ap.parse_args()
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as meshlib

    dev = meshlib.local_device()
    torch.cuda.set_device(dev)
    meshlib.init_distributed("nccl")
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != 4:
        raise SystemExit(f"run under torchrun with 4 ranks, one a card (got {world})")
    if rank == 0:
        t0 = time.perf_counter()
        _build.build()
        cs.log(f"kernels built in {time.perf_counter() - t0:.1f}s")
    dist.barrier()
    meshes = {m: meshlib.make_local_mesh(model=m) for m in (4, 2, 1)}
    cfg = get_arch(cs.ARCH)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = cs.full_params(dev, cfg)
    reqs, capacity = cs.gspmd_workload(cfg, **cs.GSPMD_A, sampled=True)
    res, stripes = {}, {}
    for name, layout, model, max_batch, kw in CASES:
        one = serve(cfg, params, dev, reqs, capacity, layout, None, max_batch, kw)
        if layout == "coplace_shmap" and model > 1:
            stripes[name] = serve(cfg, params, dev, reqs, capacity, layout, None,
                                  max_batch, kw, shards=model)
        got = serve(cfg, params, dev, reqs, capacity, layout, meshes[model], max_batch, kw)
        res[name] = (one, got)
    fam = {}  # name -> (cfg, params, reqs, capacity), for the near-tie check
    for name, arch, layout, model, max_batch, kw in FAMILY_CASES:
        f_cfg = get_arch(arch)
        f_params = cs.full_params(dev, f_cfg)
        f_reqs, f_cap = cs.gspmd_workload(f_cfg, **FAMILY_WORKLOAD, sampled=True)
        one = serve(f_cfg, f_params, dev, f_reqs, f_cap, layout, None, max_batch, kw)
        got = serve(f_cfg, f_params, dev, f_reqs, f_cap, layout, meshes[model], max_batch, kw)
        res[name] = (one, got)
        fam[name] = (f_cfg, f_params, f_reqs, f_cap)
    every = [None] * world
    dist.all_gather_object(every, res)
    bad = []
    if rank == 0:
        card = cs.card_name_and_limit()
        print(card, flush=True)
        for name, layout, model, max_batch, kw in CASES + tuple(
                (n, lay, m, b, kw) for n, _, lay, m, b, kw in FAMILY_CASES):
            c_cfg, c_params, c_reqs, c_cap = fam.get(name, (cfg, params, reqs, capacity))
            one, got = every[0][name]
            what = f"{name} on (data, model) = {(world // model, model)}, {world} NCCL ranks"
            if any(r[name][1]["tokens"] != got["tokens"]
                   or r[name][1]["counters"] != got["counters"] for r in every[1:]):
                bad.append(f"{what}: the ranks' tokens or counters differ")
            before, after = got["captures"]
            if set(before.values()) != {1} or after != before:
                bad.append(f"{what}: captures {before} -> {after}")
            ties = cs.check_ties_split(c_cfg, c_params, c_reqs,
                                       {int(u): t for u, t in got["tokens"].items()},
                                       {int(u): t for u, t in one["tokens"].items()},
                                       c_cap, dev, what)
            same = got["tokens"] == one["tokens"]
            st = stripes.get(name)
            # coplace_shmap's counters are held to the one-card engine's (the
            # default's tier hits count the masked pages it keeps as fill)
            if st is None and same and got["counters"] != one["counters"]:
                bad.append(f"{what}: counters {got['counters']} differ from the default's "
                           f"{one['counters']}")
            if st is not None:
                st_ties = cs.check_ties_split(c_cfg, c_params, c_reqs,
                                              {int(u): t for u, t in got["tokens"].items()},
                                              {int(u): t for u, t in st["tokens"].items()},
                                              c_cap, dev, f"{what} against the one-card "
                                              f"engine")
                if not st_ties and got["counters"] != st["counters"]:
                    bad.append(f"{what}: counters {got['counters']} differ from the "
                               f"one-card engine's {st['counters']}")
                cs.log(f"{what}: tokens equal to the one-card engine's over {model} "
                       f"stripes {got['tokens'] == st['tokens']} (near-tie divergences "
                       f"{st_ties}); its {st['decode_steps'] / st['wall']:.2f} decode "
                       f"steps/s, verify median ms {st['verify_ms']}, far-store bytes "
                       f"{st['far']}")
            c = got["counters"]
            if "spec" in name and not c["spec_steps"] > 0:
                bad.append(f"{what}: no verify step ran")
            if "tiered" in name and not (got["forced"] and c["tier_misses"]
                                         == c["tier_fills"] > 0):
                bad.append(f"{what}: forced {got['forced']}, counters {c}")
            rows = max_batch // (world // model)
            if "rebalanced" in name and not any(s // rows != d // rows
                                                for s, d in got["moves"]):
                bad.append(f"{what}: no migration crossed ranks ({got['moves']})")
            far = [r[name][1]["far"] for r in every]
            cs.log(f"{what} on {card}: tokens equal across ranks, equal to the one-rank "
                   f"default engine's {same} (near-tie divergences {ties}); counters "
                   f"{ {k: v for k, v in c.items() if v} } (default's equal "
                   f"{c == one['counters']}); {got['decode_steps']} decode steps in "
                   f"{got['wall']:.3f}s = {got['decode_steps'] / got['wall']:.2f} decode "
                   f"steps/s (default {one['decode_steps'] / one['wall']:.2f}); verify "
                   f"median ms {got['verify_ms']} (default {one['verify_ms']}); "
                   f"construction {got['build']:.2f}s (default {one['build']:.2f}s); "
                   f"moves {got['moves']}; forced {got['forced']}; far-store bytes by rank "
                   f"{far} (default {one['far']}); captures {before}")
        print(json.dumps({"card": card,
                          "gspmd_ranks": {n: {"one": o, "ranks": g,
                                              "one_card": stripes.get(n)}
                                          for n, (o, g) in every[0].items()},
                          "failures": bad}), flush=True)
        for b in bad:
            cs.log(f"FAIL: {b}")
    flag = torch.tensor([len(bad)], device=dev)
    dist.broadcast(flag, 0)
    code = 1 if int(flag.item()) else 0
    cs.log(f"rank {rank}: done, exit {code}")
    del res, every, fam, params, stripes
    probe_teardown(rank)
    return code


def probe_teardown(rank: int) -> None:
    """Release the engines' graphs and buffers, wait for the card, then call
    ``destroy_process_group`` on a thread, waiting at most TEARDOWN_S
    seconds; log whether it returned."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    done = threading.Event()

    def destroy():
        dist.destroy_process_group()
        done.set()
    t0 = time.perf_counter()
    threading.Thread(target=destroy, daemon=True).start()
    if done.wait(TEARDOWN_S):
        cs.log(f"rank {rank}: destroy_process_group returned in "
               f"{time.perf_counter() - t0:.2f}s")
    else:
        cs.log(f"rank {rank}: destroy_process_group had not returned after {TEARDOWN_S}s")


if __name__ == "__main__":
    # the process exits through os._exit whatever the teardown probe found:
    # on four H100s every rank once printed its results and then hung in the
    # teardown (the final broadcast, or destroying the NCCL communicators
    # that the captured graphs had used) until the command's time limit
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
