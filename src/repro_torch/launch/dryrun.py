"""Dry run on one H100: every (arch x shape) cell's memory and roofline
terms from meta-device shapes, nothing allocated (the one-card counterpart
of ``repro/launch/dryrun.py``, which lowers and compiles each cell for a
TPU mesh; one card has no mesh, lowering or collectives).

For each cell at ``MeshModel(chips=1, data=1, model=1)`` it prints the
parameter bytes (bf16 serving, f32 training), AdamW's m and v and the f32
gradients (training), the serve state at ``seq_len + 64`` tokens rounded to
whole pages (prefill and decode; ``_round_capacity``), the step's inputs,
whether those resident bytes fit the card's memory (``resident_fits``:
activations are not counted, so a cell that fits may still not run), the
byte model's ``total`` (``runtime/perfmodel.py``) over the card's memory
rate, and the model FLOP (6ND training, 2ND inference) over its bf16 peak.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internvl2-1b \\
        --shape decode_32k --out dryrun.json
"""
from __future__ import annotations

import argparse
import functools
import json
import os

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import specs as S
from repro_torch.runtime import perfmodel

# the card: NVIDIA H100 80GB HBM3 (nvidia-smi's name; SXM5, power limit
# 700.00 W), from its data sheet: memory, the HBM3 rate, the dense bf16
# tensor-core peak
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
HBM_BYTES = 80e9
HBM_BW = 3.35e12
PEAK_FLOPS = 989e12
ONE_CARD = perfmodel.MeshModel(chips=1, data=1, model=1)


def _round_capacity(cfg: ArchConfig, capacity: int) -> int:
    """Capacity rounded up to whole pages."""
    p = max(cfg.h2eal.page_size, 1)
    return -(-capacity // p) * p


@functools.lru_cache(maxsize=None)
def _param_bytes(cfg: ArchConfig, train: bool) -> dict:
    from repro_torch.optim import adamw

    params = S.param_specs(cfg, dtype=torch.float32 if train else torch.bfloat16)
    out = {"params": S.tree_bytes(params)}
    if train:
        opt = adamw.init_state(params)
        out["grads"] = out["params"]
        out["optimizer"] = S.tree_bytes({"mu": opt["mu"], "nu": opt["nu"]})
    return out


def memory_bytes(cfg: ArchConfig, shape: ShapeConfig, capacity: int = 0) -> dict:
    """The bytes a step of ``shape`` keeps resident on the card: parameters
    (bf16 serving, f32 training) and the step's inputs (``launch/specs.py``:
    token ids, or a frontend stub's bf16 embeddings); training adds the f32
    gradients and AdamW's m and v; serving adds the serve state of
    ``shape.global_batch`` slots of ``capacity`` tokens (bf16). Counted from
    meta tensors; activations are not counted."""
    train = shape.kind == "train"
    out = dict(_param_bytes(cfg, train))
    if train:
        out["inputs"] = S.tree_bytes(S.train_specs(cfg, shape))
    else:
        out["serve_state"] = S.tree_bytes(
            S.serve_state_specs(cfg, shape.global_batch, capacity)["layers"])
        feed = S.prefill_specs if shape.kind == "prefill" else S.decode_token_specs
        out["inputs"] = S.tree_bytes(feed(cfg, shape))
    out["resident"] = sum(out.values())
    return out


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6ND for a training step, 2ND for a prefill or a decode step (N the
    active parameters, D the step's tokens), as the reference counts."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6 * n * shape.global_batch * shape.seq_len
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)
    return 2 * n * tokens


def dry_cell(arch: str, shape_name: str) -> dict:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    capacity = 0 if shape.kind == "train" else _round_capacity(cfg, shape.seq_len + 64)
    mem = memory_bytes(cfg, shape, capacity)
    # on one card every layout's terms are the same; "head" is the unsplit one
    terms = perfmodel.cell_bytes(cfg, shape, ONE_CARD, layout="head")
    flops = model_flops(cfg, shape)
    memory_s, compute_s = terms["total"] / HBM_BW, flops / PEAK_FLOPS
    return {
        "arch": arch, "shape": shape_name, "kind": shape.kind, "card": CARD,
        "capacity": capacity or None, "memory": mem,
        "resident_fits": mem["resident"] <= HBM_BYTES,
        "bytes_breakdown": {k: float(v) for k, v in terms.items()},
        "model_flops": float(flops),
        "roofline": {"memory_s": memory_s, "compute_s": compute_s,
                     "dominant": "memory" if memory_s >= compute_s else "compute"},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(ASSIGNED) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    results = []
    for arch in archs:
        for shape in shapes:
            r = dry_cell(arch, shape)
            mem, rl = r["memory"], r["roofline"]
            extra = (f"grads={mem['grads'] / 1e9:.3f}GB optimizer="
                     f"{mem['optimizer'] / 1e9:.3f}GB" if "grads" in mem else
                     f"serve_state={mem['serve_state'] / 1e9:.3f}GB "
                     f"(capacity {r['capacity']})")
            print(f"[dry] {arch} x {shape} on one {CARD}: params="
                  f"{mem['params'] / 1e9:.3f}GB {extra} inputs="
                  f"{mem['inputs'] / 1e9:.3f}GB resident="
                  f"{mem['resident'] / 1e9:.3f}GB resident_fits={r['resident_fits']} bytes_model="
                  f"{r['bytes_breakdown']['total'] / 1e9:.3f}GB memory={rl['memory_s']:.3e}s "
                  f"compute={rl['compute_s']:.3e}s dominant={rl['dominant']}", flush=True)
            results.append(r)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    print(f"{len(results)} cells, {sum(r['resident_fits'] for r in results)} whose "
          "resident bytes fit one card (activations not counted)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
