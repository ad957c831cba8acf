"""Serving entry points (counterpart of ``repro/launch/serve.py``).

``--workload uniform`` (``generate``): one fixed batch, every request
sharing one prompt length and one generation length. ``--workload
ragged`` (``run_ragged``): seeded requests of ragged prompt and generation
lengths through the continuous-batching engine (``serving/engine.py``),
packed admission or, with ``--prefill-chunk N``, chunked prefill. Page
selection runs every ``share_window`` decode steps (the select step),
cheaper reuse steps in between. Greedy sampling. ``--layout coplace_shmap
--shards S`` serves the co-placed layout over S page stripes (split-KV
decode); with ``--admission balanced`` the engine admits and feeds prompts
by per-stripe page load. ``--rebalance retire|interval`` arms live slot
migration (``sched/rebalance.py``). ``--report-balance`` scores the last
batch: the paper's bank-grid tiling, naive against co-placed (§IV-B), the
per-stripe page loads, the whole-slot LPT placement and the rebalancer's
cost-model bank loads.

It runs on the card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --batch 2 --prompt-len 8192 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --reduced --prompt-len 96 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --reduced --workload ragged --requests 5 --max-batch 2 \\
      --prompt-buckets 16,24 --prefill-chunk 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --reduced --workload ragged --requests 5 --max-batch 2 \\
      --prompt-buckets 16,24 --layout coplace_shmap --shards 4 \\
      --admission balanced --report-balance --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --reduced --workload ragged --requests 5 --max-batch 2 \\
      --prompt-buckets 16,24 --prefill-chunk 8 --decode-window 4 \\
      --share-window 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --reduced --workload ragged --requests 8 --max-batch 4 \\
      --prompt-buckets 8,16,24 --rebalance retire --report-balance --device cpu

Every registered arch serves both ways, the recurrent ones too (mamba2 and
attention layers: ``--arch zamba2-2.7b``; mLSTM and sLSTM layers, no
attention: ``--arch xlstm-125m``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --batch 2 --prompt-len 8192 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
      --reduced --workload ragged --requests 5 --max-batch 2 \\
      --prompt-buckets 16,24 --prefill-chunk 8 --device cpu

The GSPMD layouts ``head``, ``coplace`` and ``interleave`` serve the
ragged workload over the ranks of ``torchrun``, one process a device
(NCCL on cards, gloo on the CPU), ``--mesh-model M`` of them on the mesh's
'model' axis and the rest on 'data'; every rank serves the same requests,
rank 0 prints. Every family the default layout serves is served there:
the dense family (``--h2eal off`` too), gemma3's local:global stack, the
MoE family and the recurrent mixers (zamba2, xLSTM), each layer's cache
placed by its kind. ``--rebalance`` migrates slots there too: where the
batch lies over 'data', a move takes a slot's row (pages, full caches,
recurrent states) to another rank. ``--layers N`` cuts the model's depth.
On NCCL the program ends without tearing its communicators down
(``_leave_group``). ``--layout coplace_shmap`` under torchrun (or with
``--mesh-model``) is served the same way, rank r of 'model' holding page
stripe r (``--shards`` then 1 or M); without either it stripes one card's
pages. Without torchrun the GSPMD layouts run on one rank:

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch llama3-8b \
      --workload ragged --requests 8 --max-batch 4 --prompt-buckets 2048,8192 \
      --prefill-chunk 512 --layout coplace --mesh-model 4
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch llama3-8b \
      --workload ragged --requests 8 --max-batch 4 --prompt-buckets 2048,8192 \
      --prefill-chunk 512 --layout coplace_shmap --mesh-model 4 \
      --admission balanced
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch llama3-8b --reduced --workload ragged --requests 8 --max-batch 4 \
      --prompt-buckets 8,16,24 --layout head --rebalance retire --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --reduced --workload ragged --requests 5 --max-batch 2 \
      --prompt-buckets 16,24 --layout interleave --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch zamba2-2.7b --reduced --workload ragged --requests 8 --max-batch 4 \
      --prompt-buckets 8,16,24 --prefill-chunk 8 --layout head --rebalance retire \
      --device cpu

The frontend-stub archs (internvl2-1b, musicgen-large) take precomputed
embeddings, not token ids: ``generate``, the engine and this CLI refuse
them, where the reference's feed token ids and fail. They serve through
``models.model.prefill`` and ``decode_step`` fed embeddings.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import layouts as layoutlib
from repro_torch.launch import mesh as meshlib
from repro_torch.models import model as M
from repro_torch.core.tree import leaves as tree_leaves
from repro_torch.runtime import serve as serve_rt
from repro_torch.runtime import sharding
from repro_torch.runtime import tensor_parallel as tplib
from repro_torch.runtime.serve import resolve_device
from repro_torch.sched import balance, grid_coords, map_slots, solve_tiling
from repro_torch.serving.engine import STUB_ENGINE_REFUSAL, Engine, Request


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params, prompts, *, gen: int, capacity: int,
             layout: str = "default", shards: int = 1, mesh=None, h2eal: bool = True,
             greedy: bool = True, device=None):
    """Lockstep generation. prompts: (B, S) int tokens. ``layout`` and
    ``shards`` as in ``Engine``; the cache holds the layout plan's rounding
    of ``capacity``. Returns (tokens (B, gen) int32 tensor, stats dict).

    With ``mesh`` (a ``launch/mesh.Mesh``; every rank calls this with the
    same whole ``params`` and prompts) it is the reference's tensor-parallel
    ``generate(mesh=...)``, its ``jit_serve_steps``: each rank keeps its
    blocks of the parameters by ``param_shardings(mode="serve")`` (TP over
    'model', the embedding over the vocabulary) and of the serve state by
    the layout (``default``, ``head``, ``coplace``, ``interleave`` or
    ``coplace_shmap``, the batch over 'data' where it divides); every rank
    returns the same tokens. A GSPMD layout without a mesh runs on the
    one-rank mesh, as the engine's does. Every family runs so: dense, MoE
    (the experts' dim E over 'data', never gathered), the recurrent mixers
    (their states' rows over 'data') and local:global (the window layers'
    full caches placed by their rule). ``stats["param_bytes"]`` is the
    rank's parameter bytes.

    Every token is the argmax, whatever ``greedy`` says: the flag is
    accepted and ignored, as the JAX package's ``generate`` does. Sampling
    (temperature, top-p, per-request seeds) is the engine's ``Request``.
    A frontend-stub arch is refused (``serving.engine.STUB_ENGINE_REFUSAL``):
    argmax ids cannot feed a model that takes embeddings."""
    del greedy  # lockstep generation is greedy, as in the JAX package
    if cfg.embed_frontend_stub:
        raise ValueError(STUB_ENGINE_REFUSAL)
    if mesh is None and layoutlib.get_layout(layout, shards).gspmd:
        mesh = meshlib.Mesh()  # a GSPMD layout's default: the one-rank mesh
    if mesh is not None:
        tplib.check_config(cfg)
    dev = resolve_device(device)
    if params["final_norm"].device.type != dev.type:
        raise ValueError(f"params lie on {params['final_norm'].device}, generate "
                         f"runs on {dev}")
    if not h2eal:
        cfg = dataclasses.replace(
            cfg, h2eal=dataclasses.replace(cfg.h2eal, enabled=False))
    prompts = torch.as_tensor(prompts, device=dev)
    b = prompts.shape[0]
    plan = layoutlib.mesh_layout(layout, shards, mesh).plan(cfg, mesh)
    scfg = serve_rt.ServeConfig(capacity=plan.round_capacity(capacity),
                                layout=layout, shards=shards, mesh=mesh, max_batch=b)
    tp = None
    if mesh is not None:
        params, specs = sharding.place_params(cfg, mesh, params, "serve")
        tp = tplib.TensorParallel(mesh, specs)
        prefill = serve_rt.make_lockstep_prefill(cfg, scfg, tp)
    else:
        prefill = serve_rt.make_prefill(cfg, scfg)
    dec_sel = serve_rt.make_decode_step(cfg, scfg, do_select=True, tp=tp)
    dec_reuse = serve_rt.make_decode_step(cfg, scfg, do_select=False, tp=tp)

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
        "param_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(params)),
    }
    return torch.stack(outs, dim=1), stats


def make_ragged_requests(cfg, *, n: int, prompt_buckets, gen_min: int,
                         gen_max: int, seed: int = 0):
    """Seeded ragged workload: bucketed prompt lengths, variable generation
    lengths (the JAX package's generator, draw for draw)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        s = int(rng.choice(prompt_buckets))
        g = int(rng.integers(gen_min, gen_max + 1))
        prompt = rng.integers(0, cfg.vocab_size, size=(s,)).astype(np.int32)
        reqs.append(Request(uid=uid, prompt=prompt, max_new=g))
    return reqs


def run_ragged(cfg, params, requests, *, max_batch: int, capacity: int,
               prompt_buckets, report_balance: bool = False,
               layout: str = "default", shards: int = 1, mesh=None,
               admission: str = "fifo", prefill_chunk=None, decode_window=None,
               rebalance: str = "off", device=None):
    """Serve ``requests`` with the continuous-batching engine (packed
    admission, or chunked with ``prefill_chunk=N``; ``layout``, ``shards``,
    ``mesh``, ``admission``, ``decode_window`` and ``rebalance`` as in
    ``Engine``). Returns (completions, stats dict)."""
    if admission == "balanced" and \
            not layoutlib.get_layout(layout, shards).shards_pages:
        raise ValueError(
            "--admission balanced scores per-device page load and only has "
            "an effect for layouts that shard pages (e.g. --layout "
            "coplace_shmap or interleave)")
    eng = Engine(cfg, params, max_batch=max_batch, capacity=capacity,
                 prompt_buckets=prompt_buckets, layout=layout, shards=shards,
                 mesh=mesh, admission=admission, prefill_chunk=prefill_chunk,
                 decode_window=decode_window, rebalance=rebalance, device=device)
    completions = eng.run(requests)
    s = eng.stats
    stats = {
        "wall_s": s.wall_s,
        "tokens_per_s": s.tokens_per_s,
        "decode_steps": s.decode_steps,
        "engine_steps": s.engine_steps,
        "select_steps": s.select_steps,
        "reuse_steps": s.reuse_steps,
        "admissions": s.admissions,
        "prefill_chunks": s.prefill_chunks,
        "occupancy": s.occupancy,
        "tokens_out": s.tokens_out,
        "admission_reorders": s.admission_reorders,
        "dispatches": s.dispatches,
        "steps_per_dispatch": s.steps_per_dispatch,
        "jit_cache": eng.jit_cache_sizes(),
        "graph_replays": eng.graph_replays(),
    }
    if decode_window:
        stats["fused"] = {"decode_window": decode_window,
                          "fused_windows": s.fused_windows,
                          "fused_steps": s.fused_steps}
    if rebalance != "off":
        stats["rebalance"] = {
            "trigger": rebalance,
            "checks": s.rebalance_checks,
            "rebalances": s.rebalances,
            "skipped": s.rebalance_skipped,
            "migrations": s.migrations,
            "migrated_tokens": s.migrated_tokens,
            "imbalance_pre": s.imbalance_pre,
            "imbalance_post": s.imbalance_post,
        }
    if report_balance:
        stats["balance"] = _balance_report(cfg, eng)
    return completions, stats


def _balance_report(cfg, eng):
    """Score the engine's last batch (the contexts its slots hold at the end
    of the run): the paper's tiling and co-placed load split on a 4x4 bank
    grid against one head a bank; the per-stripe page loads under
    round-robin striping (over the layout's stripes, or 4 where pages are
    not striped) and the whole-slot LPT placement over as many banks; and
    the rebalancer's own per-bank cost-model loads (``Engine.
    compute_loads``) with its migration counters."""
    ctx = [int(c) for c in eng.batch.lengths if c > 0]
    s = eng.stats
    base = {"admissions": s.admissions, "prefill_chunks": s.prefill_chunks}
    loads = eng.compute_loads()
    if loads:
        base["cost_loads"] = [round(x, 1) for x in loads]
        base["cost_imbalance"] = balance.load_imbalance(loads)
    if eng.rebalance != "off":
        base.update(migrations=s.migrations, rebalances=s.rebalances,
                    imbalance_pre=s.imbalance_pre, imbalance_post=s.imbalance_post)
    if not ctx:
        return base
    h2 = cfg.h2eal
    coords = grid_coords(4, 4)[: cfg.num_kv_heads]
    n_r = max(cfg.num_kv_heads - round(cfg.num_kv_heads * h2.static_sparsity), 0)
    retr, stream = coords[:n_r], coords[n_r:]
    tiles, _ = solve_tiling(retr, stream)
    kinds = {c: ("retrieval" if c in retr else "streaming") for c in coords}
    naive = balance.ragged_loads(tiles, kinds, h2, ctx, balanced=False)
    coplaced = balance.ragged_loads(tiles, kinds, h2, ctx, balanced=True)
    n_sh = (eng.plan.page_stripe_shards
            if eng.layout == layoutlib.LAYOUT_COPLACE_SHMAP else 4)
    pages = balance.device_page_loads(ctx, n_shards=n_sh, page_size=h2.page_size)
    lpt = map_slots([balance.slot_head_load("retrieval", h2, c) for c in ctx], n_sh)
    return dict(base, page_loads=pages,
                page_load_imbalance=balance.load_imbalance(pages),
                imbalance_naive=balance.imbalance(naive),
                imbalance_coplaced=balance.imbalance(coplaced),
                slot_lpt_imbalance=lpt.imbalance)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers (0: its whole depth)")
    ap.add_argument("--workload", choices=["uniform", "ragged"],
                    default="uniform")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--h2eal", choices=["on", "off"], default="on")
    ap.add_argument("--seed", type=int, default=0)
    # ragged-workload knobs
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-buckets", default="32,64",
                    help="comma-separated allowed prompt lengths")
    ap.add_argument("--gen-min", type=int, default=4)
    ap.add_argument("--gen-max", type=int, default=24)
    ap.add_argument("--capacity", type=int, default=0,
                    help="cache capacity in tokens (0 = longest prompt + "
                         "gen-max + one page)")
    ap.add_argument("--report-balance", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: at most N prompt tokens per "
                         "engine step, beside the decode of the other slots "
                         "(0 = prefill-then-pack admission)")
    ap.add_argument("--layout", choices=list(layoutlib.available_layouts()),
                    default=layoutlib.LAYOUT_DEFAULT,
                    help="serve-cache layout: coplace_shmap = co-placement "
                         "over --shards page stripes, split-KV decode (over "
                         "the ranks of torchrun or --mesh-model: a stripe a "
                         "rank); head, coplace, interleave = GSPMD placements "
                         "over the ranks of torchrun (one rank without it)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="ranks on the mesh's 'model' axis (the rest on "
                         "'data'); GSPMD layouts and coplace_shmap only")
    ap.add_argument("--shards", type=int, default=1,
                    help="page stripes of coplace_shmap (the size of the JAX "
                         "mesh's 'model' axis)")
    ap.add_argument("--admission", choices=["fifo", "balanced"], default="fifo",
                    help="ragged admission order (balanced = per-stripe "
                         "page-load aware, sched/balance.py)")
    ap.add_argument("--rebalance", choices=["off", "retire", "interval"],
                    default="off",
                    help="live slot migration (sched/rebalance.py): retire = "
                         "plan when a retirement frees a slot, interval = "
                         "every 16 engine steps; tokens are unchanged")
    ap.add_argument("--decode-window", type=int, default=0,
                    help="fuse up to N reuse steps between selection "
                         "boundaries into one dispatch with retirement on "
                         "the card (0 = per-step dispatch)")
    ap.add_argument("--share-window", type=int, default=0,
                    help="override the config's share_window (the selection "
                         "cadence); the reduced configs pin it to 2, which "
                         "leaves one reuse step a window")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions of the kernels)")
    args = ap.parse_args(argv)

    shmap = args.layout == layoutlib.LAYOUT_COPLACE_SHMAP
    if args.mesh_model != 1 and not (shmap or
                                     layoutlib.get_layout(args.layout, args.shards).gspmd):
        raise ValueError("--mesh-model places a GSPMD layout (head, coplace, "
                         "interleave) or coplace_shmap over ranks")
    joined = "RANK" in os.environ  # under torchrun: one rank a device
    if joined:
        if args.device is None:
            args.device = str(meshlib.local_device())
        backend = "nccl" if torch.device(args.device).type == "cuda" else "gloo"
        meshlib.init_distributed(backend)
    try:
        mesh = None
        # coplace_shmap stripes one card's pages unless run over ranks
        # (torchrun, or --mesh-model)
        if layoutlib.get_layout(args.layout, args.shards).gspmd or (
                shmap and (joined or args.mesh_model != 1)):
            mesh = meshlib.make_local_mesh(model=args.mesh_model)
        return _serve(args, mesh)
    finally:
        if joined:
            _leave_group()


def _leave_group() -> None:
    """Leave a torchrun rank's process group. A gloo group is destroyed. An
    NCCL group is left to the process's exit, after the card's work is done:
    run as a program, the CLI then ends through ``os._exit`` without tearing
    the communicators down, the exit path of ``scripts/torch_gspmd_ranks.py``,
    whose four NCCL ranks hung in the teardown once their captured steps had
    run (ROADMAP Queue 3)."""
    if torch.distributed.get_backend() == "nccl":
        torch.cuda.synchronize()
        return
    torch.distributed.destroy_process_group()


def _serve(args, mesh):
    """The CLI's run on this rank. Every rank serves the same requests and
    gets the same tokens; rank 0 prints them."""
    quiet = torch.distributed.is_initialized() and torch.distributed.get_rank() > 0
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if cfg.embed_frontend_stub:
        raise ValueError(STUB_ENGINE_REFUSAL)
    if args.h2eal == "off":
        cfg = dataclasses.replace(
            cfg, h2eal=dataclasses.replace(cfg.h2eal, enabled=False))
    if args.share_window:
        cfg = dataclasses.replace(
            cfg, h2eal=dataclasses.replace(cfg.h2eal,
                                           share_window=args.share_window))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = M.init_params(cfg, generator=gen, device=dev, dtype=dtype)

    if args.workload == "ragged":
        buckets = [int(x) for x in args.prompt_buckets.split(",")]
        capacity = args.capacity or (max(buckets) + args.gen_max
                                     + cfg.h2eal.page_size)
        reqs = make_ragged_requests(cfg, n=args.requests, prompt_buckets=buckets,
                                    gen_min=args.gen_min, gen_max=args.gen_max,
                                    seed=args.seed)
        completions, stats = run_ragged(
            cfg, params, reqs, max_batch=args.max_batch, capacity=capacity,
            prompt_buckets=buckets, report_balance=args.report_balance,
            layout=args.layout, shards=args.shards, mesh=mesh,
            admission=args.admission, prefill_chunk=args.prefill_chunk or None,
            decode_window=args.decode_window or None, rebalance=args.rebalance,
            device=dev)
        if quiet:
            return stats
        mesh_txt = f" mesh={mesh.shape}" if mesh is not None else ""
        print(f"[serve] arch={cfg.name} workload=ragged device={dev} "
              f"layout={args.layout} shards={args.shards}{mesh_txt} "
              f"admission={args.admission} rebalance={args.rebalance} "
              f"prefill_chunk={args.prefill_chunk or 'packed'} "
              f"requests={len(completions)} steps={stats['decode_steps']} "
              f"occupancy={stats['occupancy']:.2f} "
              f"({stats['tokens_per_s']:.1f} tok/s)")
        print(f"[serve] select/reuse steps: {stats['select_steps']}/"
              f"{stats['reuse_steps']}; admissions/chunks: "
              f"{stats['admissions']}/{stats['prefill_chunks']}; admission "
              f"reorders: {stats['admission_reorders']}; dispatches "
              f"{stats['dispatches']} ({stats['steps_per_dispatch']:.2f} decode "
              f"steps a dispatch)")
        print(f"[serve] graph captures: {stats['jit_cache']}; replays: "
              f"{stats['graph_replays']}")
        if "fused" in stats:
            fu = stats["fused"]
            print(f"[serve] fused decode windows: w={fu['decode_window']} "
                  f"windows={fu['fused_windows']} fused_steps={fu['fused_steps']}")
        if "rebalance" in stats:
            r = stats["rebalance"]
            print(f"[serve] rebalance trigger={r['trigger']} checks={r['checks']} "
                  f"applied={r['rebalances']} skipped={r['skipped']} "
                  f"migrations={r['migrations']} imbalance "
                  f"{r['imbalance_pre']:.3f} -> {r['imbalance_post']:.3f}")
        bal = stats.get("balance", {})
        if "page_loads" in bal:
            print(f"[serve] per-stripe page loads {bal['page_loads']} "
                  f"(imbalance {bal['page_load_imbalance']:.2f}); bank "
                  f"imbalance naive={bal['imbalance_naive']:.2f} "
                  f"coplaced={bal['imbalance_coplaced']:.2f} "
                  f"slot_lpt={bal['slot_lpt_imbalance']:.2f}")
        if "cost_loads" in bal:
            print(f"[serve] cost-model bank loads {bal['cost_loads']} "
                  f"(imbalance {bal['cost_imbalance']:.2f})")
        if completions:
            some = completions[min(completions)]
            print(f"[serve] sample tokens (uid {some.uid}): {some.tokens[:16]}")
        return stats

    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    toks, stats = generate(
        cfg, params, prompts, gen=args.gen,
        capacity=args.prompt_len + args.gen + cfg.h2eal.page_size,
        layout=args.layout, shards=args.shards, mesh=mesh, device=dev)
    print(f"[serve] arch={cfg.name} b={args.batch} device={dev} "
          f"prefill={stats['prefill_s']:.2f}s "
          f"decode={stats['decode_s']:.2f}s "
          f"({stats['tokens_per_s']:.1f} tok/s)")
    print(f"[serve] sample tokens: {toks[0, :16].tolist()}")
    return stats


if __name__ == "__main__":
    try:
        main()
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    except BaseException:
        traceback.print_exc()
        code = 1
    if torch.distributed.is_initialized():  # an NCCL group left to the exit
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    sys.exit(code)
