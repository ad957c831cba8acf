"""Mixture-of-Experts FFN with sort-based capacity dispatch (counterpart of
``repro/models/moe.py``).

Tokens are replicated top_k times, sorted by expert id, given a slot
within their expert by a running count, and placed in an (E, capacity, d)
buffer; the expert products are dense batched matmuls over E, and the
results return to their tokens weighted by the router. Entries beyond an
expert's capacity are dropped (Switch-style, capacity factor 1.25).

Every step is written so that it gives the same bits on every run and can
be captured in a CUDA graph: no scatter with repeated indices, no count
read back to the host (the expert counts are a fixed-length scatter-add
over E, not ``bincount``), no boolean indexing. Three rules of the
reference are kept on purpose:

  * ``lax.top_k`` takes the lower expert id first among equal
    probabilities: here a stable sort;
  * the reference writes dropped entries as zero rows into slot
    capacity-1 of their expert, and its last write wins: the kept entry in
    that slot of an overflowing expert is overwritten and returns 0. The
    buffer is built by a gather that writes that rule out;
  * capacity follows from every token of the call (padded and idle rows
    too), so callers pass the same token set the JAX blocks pass.

Over a mesh (``tp``, ``runtime/tensor_parallel.py``) the experts are cut
over their dim E and each rank fills and runs its experts' rows of the
buffer (``tensor_parallel.experts``); the buffer's outputs are gathered
over E before the return path, so the K-sum runs in the unsharded order.
Where the activations are the rank's rows (the train step), the tokens are
gathered over 'data' before the router, so that capacity and the chunking
are decided over the whole token set as the reference's unsharded function
decides them, and the rank's rows are taken back after.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense, init_dense, swiglu
from repro_torch.runtime import tensor_parallel as tplib

CAPACITY_FACTOR = 1.25
# prefill at 32k x 32 pushes 1M tokens through the router at once; the
# dispatch buffers are chunked over tokens to bound the live set
MOE_CHUNK_TOKENS = 65536
# experts drawn a slice at a time: one f32 draw of kimi-k2's (384, 7168,
# 2048) expert tensor would be a 22.5 GB temporary
_INIT_EXPERTS = 16


def _init_experts(gen, e: int, d_in: int, d_out: int, *, dtype, device):
    w = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
    if w.is_meta:  # shapes only (launch/specs.py): the meta draws take seconds
        return w
    for i in range(0, e, _INIT_EXPERTS):
        n = min(_INIT_EXPERTS, e - i)
        x = torch.randn((n, d_in, d_out), generator=gen, dtype=torch.float32,
                        device=device)
        w[i:i + n] = (x * (1.0 / math.sqrt(d_in))).to(dtype)
    return w


def init_moe(gen: torch.Generator, cfg: ArchConfig, *, dtype, device):
    """Random-init one layer's MoE parameters from ``gen``: the JAX init's
    shapes and scales; the router in f32 at scale 0.02 whatever ``dtype``."""
    m = cfg.moe
    d, f, e = cfg.d_model, cfg.d_ff, m.num_experts
    p = {
        "router": init_dense(gen, d, e, dtype=torch.float32, device=device,
                             scale=0.02),
        "w_gate": _init_experts(gen, e, d, f, dtype=dtype, device=device),
        "w_up": _init_experts(gen, e, d, f, dtype=dtype, device=device),
        "w_down": _init_experts(gen, e, f, d, dtype=dtype, device=device),
    }
    if m.shared_expert_ff:
        sf = m.shared_expert_ff
        p["shared"] = {
            "w_gate": init_dense(gen, d, sf, dtype=dtype, device=device),
            "w_up": init_dense(gen, d, sf, dtype=dtype, device=device),
            "w_down": init_dense(gen, sf, d, dtype=dtype, device=device),
        }
    return p


def _capacity(tokens: int, num_experts: int, top_k: int, factor: float) -> int:
    if factor <= 0:  # dropless (smoke configs / exactness tests)
        return tokens * top_k
    cap = int(tokens * top_k * factor / num_experts) + 1
    return max(8, -(-cap // 8) * 8)  # 8-aligned


def _route(cfg: ArchConfig, params, xf, tp=None):
    """Router probabilities (T, E) f32 and the top-k (weights, ids), the
    lower id first among equal probabilities, as ``lax.top_k``. The router
    is whole on every rank of a mesh (FSDP-gathered in training)."""
    router = params["router"] if tp is None else tp.whole(params, "router")
    probs = torch.softmax(dense(xf.float(), router), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    return probs, w[:, :k], ids[:, :k]


def moe_ffn(cfg: ArchConfig, params, x, tp=None):
    """x: (B, S, d) or (B, d) -> same shape. Above MOE_CHUNK_TOKENS tokens
    (and a multiple of it) the tokens go through in chunks of that size,
    each with its own capacity, as the reference's scan does. ``tp``: the
    layer's ``moe`` view over a mesh (None: whole weights)."""
    rows, mine = tplib.gather_rows(tp, x)
    d = x.shape[-1]
    t = math.prod(rows.shape[:-1])
    xf = rows.reshape(t, d)
    if t > MOE_CHUNK_TOKENS and t % MOE_CHUNK_TOKENS == 0:
        out = torch.cat([_moe_ffn_flat(cfg, params, xc, tp)
                         for xc in xf.split(MOE_CHUNK_TOKENS)])
    else:
        out = _moe_ffn_flat(cfg, params, xf, tp)
    return mine(out.reshape(rows.shape))


def _moe_ffn_flat(cfg: ArchConfig, params, xf, tp=None):
    """xf: (T, d) -> (T, d)."""
    m = cfg.moe
    t, d = xf.shape
    e, k = m.num_experts, m.top_k
    dev, dtype = xf.device, xf.dtype

    _, w, ids = _route(cfg, params, xf, tp)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # each token's choices by ascending expert id, the order in which the
    # reference's scatter-add sums them; a token takes an expert once, so
    # the slots below do not depend on this order
    ids, perm = ids.sort(dim=-1)
    w = w.gather(-1, perm)

    cap = _capacity(t, e, k, m.capacity_factor)
    flat = ids.reshape(-1)                                          # (T*K,)
    order = torch.argsort(flat, stable=True)
    sorted_ids = flat[order]
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, sorted_ids, torch.ones_like(sorted_ids))
    starts = counts.cumsum(0) - counts                              # (E,)
    src_tok = order // k                                            # (T*K,)

    # the (E, cap, d) buffer by a gather: slot c of expert e holds sorted
    # entry starts[e] + c while c < counts[e]; slot cap-1 of an expert with
    # more than cap entries holds zeros (the reference's last write there
    # is a dropped entry's zero row)
    c_idx = torch.arange(cap, device=dev)
    n = counts[:, None]
    fill = (c_idx < n) & ((c_idx < cap - 1) | (n <= cap))          # (E, cap)
    pos = (starts[:, None] + c_idx).clamp(max=t * k - 1)
    if tp is not None:
        y_buf = tplib.experts(tp, xf, src_tok[pos], fill, params)
    else:
        buf = xf.index_select(0, src_tok[pos].reshape(-1)).view(e, cap, d)
        buf = torch.where(fill[..., None], buf, 0.0)
        g = torch.bmm(buf, params["w_gate"].to(dtype))
        u = torch.bmm(buf, params["w_up"].to(dtype))
        y_buf = torch.bmm(F.silu(g) * u, params["w_down"].to(dtype))   # (E, cap, d)

    slots = torch.arange(t * k, device=dev) - starts[sorted_ids]
    y_sorted = y_buf.view(e * cap, d).index_select(
        0, sorted_ids * cap + slots.clamp(max=cap - 1))
    y_sorted = torch.where((slots < cap)[:, None], y_sorted, 0.0)
    # back to each token's K choices through the inverse permutation, then
    # summed over K in a fixed order (no atomics)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=dev))
    y = y_sorted.index_select(0, inv).view(t, k, d)
    wk = w.to(dtype)
    out = y[:, 0] * wk[:, 0, None]
    for j in range(1, k):
        out = out + y[:, j] * wk[:, j, None]

    if "shared" in params:
        sp = params["shared"]
        if tp is None:
            out = out + swiglu(xf, sp["w_gate"], sp["w_up"], sp["w_down"])
        else:
            out = out + tplib.swiglu(tp.at("shared"), xf, sp)
    return out


def aux_load_balance_loss(cfg: ArchConfig, x, params):
    """Switch-style auxiliary loss E · Σ_e f_e · p_e of x (B, S, d)."""
    b, s, d = x.shape
    probs, _, ids = _route(cfg, params, x.reshape(b * s, d))
    f = F.one_hot(ids[:, 0], cfg.moe.num_experts).float().mean(0)
    return cfg.moe.num_experts * torch.sum(f * probs.mean(0))
