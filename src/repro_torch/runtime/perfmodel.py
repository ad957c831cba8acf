"""The analytical byte model (counterpart of ``repro/runtime/perfmodel.py``).

Two halves, both the reference's terms and arithmetic:

* the mesh half: a step's bytes per device (``decode_bytes``,
  ``prefill_bytes``, ``train_bytes``, ``cell_bytes``) for a device mesh
  (``MeshModel``), counted from the step's semantics, shapes and dtypes.
  On one H100 the mesh is ``MeshModel(chips=1, data=1, model=1)``: the
  dry run (``launch/dryrun.py``) reads its ``total`` against the card's
  memory rate;
* the serving half: the wire bytes of tiered page residency and of live
  slot migration, counted from the engine's counters. The hbsim cycle
  model (``hbsim/sim.py``) prices them on the paper's hybrid-bonding
  accelerator.

Bytes are those of the bf16 wire format, with the page metadata in f32
where the implementation keeps f32.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeConfig

BF16 = 2
F32 = 4


@dataclass(frozen=True)
class MeshModel:
    chips: int
    data: int          # data-axis size (x pod)
    model: int         # model-axis size


def _dp_shard(n: int, ways: int) -> float:
    """Per-device share of dim n sharded `ways`-way (1 if not divisible)."""
    return n / ways if n % ways == 0 else n


def _head_shard(h: int, ways: int) -> float:
    return h / ways if h % ways == 0 else h


def decode_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh: MeshModel,
                 *, layout: str, do_select: bool = True) -> dict:
    """One decode step (a select step unless ``do_select=False``), per
    device: the active weights read once, the retrieval heads'
    [sink | top-k | local] pages, the τ scan on a select step, the
    streaming ring and the appends (the whole cache under full attention;
    a recurrent state for an attention-free stack)."""
    h2 = cfg.h2eal
    b = shape.global_batch
    s = shape.seq_len
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hkv = cfg.num_kv_heads
    n_attn = len(cfg.attention_layers)

    w_bytes = cfg.active_param_count() * BF16 / mesh.chips
    b_dev = _dp_shard(b, mesh.data)
    terms = {"weights": w_bytes}

    if not cfg.has_attention:
        # SSM / xLSTM: recurrent state read + write (approximate state dim)
        state = b_dev * cfg.num_layers * d * 64 * F32 * 2
        terms["state"] = state
        terms["total"] = w_bytes + state
        return terms

    if not h2.enabled:
        # full-attention baseline: the whole KV cache every step
        kv = (b_dev * _head_shard(hkv, mesh.model) * s * hd * BF16 * 2
              * n_attn)
        terms["kv_full"] = kv
        terms["total"] = w_bytes + kv
        return terms

    nr = hkv - round(hkv * h2.static_sparsity)
    ns = hkv - nr
    p = h2.page_size
    n_sink = -(-h2.sink // p)
    n_local = -(-h2.local // p) + 1
    n_pages_att = n_sink + h2.top_k_pages + n_local
    c_pages = -(-s // p)

    if layout == "head":
        hr_dev = _head_shard(nr, mesh.model)
        page_frac = 1.0
        b_kv = b_dev
    else:
        # coplace / interleave: each device holds 1/model (x 1/data under
        # interleave) of every head's pages and attends what it stores
        hr_dev = nr
        ways = mesh.model * (mesh.data if layout == "interleave" else 1)
        page_frac = 1.0 / min(ways, n_pages_att * p)  # not below one token
        b_kv = b if layout == "interleave" else b_dev

    kv_sel = (b_kv * hr_dev * n_pages_att * p * hd * BF16 * 2 * page_frac
              * n_attn)
    meta = (b_kv * hr_dev * c_pages * hd * F32 * 2 * page_frac * n_attn
            if do_select else 0.0)
    hs_dev = _head_shard(ns, mesh.model)
    kv_stream = (b_dev * hs_dev * (h2.sink + h2.local + p) * hd * BF16 * 2
                 * n_attn)
    appends = b_dev * hkv * hd * BF16 * 2 * n_attn

    terms.update({"kv_selected": kv_sel, "metadata": meta,
                  "kv_stream": kv_stream, "appends": appends})
    terms["total"] = sum(terms.values())
    return terms


def prefill_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh: MeshModel,
                  *, q_chunk: int = 1024) -> dict:
    """A prefill step, per device: the weights, ~8 d-vectors a token and
    layer of activations, the retrieval heads' K/V re-read once a q-chunk,
    the streaming heads' window span a chunk, and the cache writes."""
    h2 = cfg.h2eal
    b = shape.global_batch
    s = shape.seq_len
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hkv = cfg.num_kv_heads
    n_attn = len(cfg.attention_layers)

    w_bytes = cfg.active_param_count() * BF16 / mesh.chips
    b_dev = _dp_shard(b, mesh.data)
    tokens_dev = b_dev * s
    act = tokens_dev * d * BF16 * 8 * cfg.num_layers
    nr = hkv - round(hkv * h2.static_sparsity) if h2.enabled else hkv
    ns = hkv - nr
    n_chunks = max(1, s // q_chunk)
    kv_full = (b_dev * _head_shard(nr, mesh.model) * s * hd * BF16 * 2
               * n_chunks * n_attn)
    kv_win = (b_dev * _head_shard(ns, mesh.model)
              * (q_chunk + h2.local + h2.sink) * hd * BF16 * 2
              * n_chunks * n_attn)
    cache_w = (b_dev * hkv * s * hd * BF16 * 2 * n_attn
               / (mesh.model if hkv % mesh.model == 0 else 1))

    terms = {"weights": w_bytes, "activations": act, "kv_full": kv_full,
             "kv_window": kv_win, "cache_write": cache_w}
    terms["total"] = sum(terms.values())
    return terms


def train_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh: MeshModel,
                *, q_chunk: int = 1024) -> dict:
    """A training step, per device: the forward, its remat re-forward and
    the backward (~2x the forward's traffic), and the optimizer's f32
    parameters, m, v and gradients each read and written."""
    fwd = prefill_bytes(cfg, shape, mesh, q_chunk=q_chunk)
    p_dev = cfg.param_count() / mesh.chips
    opt = p_dev * F32 * (2 + 2 + 2 + 2)
    compute_traffic = fwd["total"] * 4
    terms = {"fwd_bwd_remat": compute_traffic, "optimizer": opt}
    terms["total"] = compute_traffic + opt
    return terms


def cell_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh: MeshModel,
               *, layout: str = "head") -> dict:
    """The bytes of one step of ``shape``'s kind."""
    if shape.kind == "train":
        return train_bytes(cfg, shape, mesh)
    if shape.kind == "prefill":
        return prefill_bytes(cfg, shape, mesh)
    return decode_bytes(cfg, shape, mesh, layout=layout)


def _head_split(cfg: ArchConfig):
    """(retrieval KV heads, streaming KV heads, attention layers)."""
    h2 = cfg.h2eal
    hkv = cfg.num_kv_heads
    nr = hkv - round(hkv * h2.static_sparsity) if h2.enabled else hkv
    return nr, hkv - nr, len(cfg.attention_layers) or cfg.num_layers


def tier_page_bytes(cfg: ArchConfig) -> float:
    """Wire bytes of ONE logical KV page crossing the hot/cold residency
    boundary (a ``core/cache.TieredPagedCache`` spill or fill): the K and V
    rows of every retrieval head in every attention layer. Streaming heads
    keep a ring, not pages, and the page metadata (τ, importance,
    page_start) never moves: selection must stay complete on the device
    for a cold miss to be detectable."""
    nr, _, n_attn = _head_split(cfg)
    return float(2 * cfg.h2eal.page_size * cfg.resolved_head_dim * BF16
                 * nr * n_attn)


def tier_traffic_bytes(cfg: ArchConfig, *, fills: int, spills: int,
                       prefetch: int) -> dict:
    """Far-store traffic of a tiered serving run from the engine's page
    counters (``EngineStats.tier_fills/spills/prefetch``). ``blocking`` is
    the demand fills alone: a cold SELECTED page holds its select step
    until the fill lands, while prefetch and spill traffic overlaps decode
    (scheduled one share window ahead of the refresh that needs it)."""
    page = tier_page_bytes(cfg)
    terms = {
        "demand_fills": fills * page,
        "prefetch": prefetch * page,
        "spills": spills * page,
    }
    terms["blocking"] = terms["demand_fills"]
    terms["total"] = (terms["demand_fills"] + terms["prefetch"]
                      + terms["spills"])
    return terms


def migration_slot_bytes(cfg: ArchConfig, *, ctx: int) -> float:
    """Wire bytes of moving ONE slot's cache row between slot indices
    (``serving.Engine._migrate_slot``, planned by ``sched/rebalance.py``):
    K and V of the slot's live retrieval-head pages, the streaming heads'
    sink + local ring and the per-page f32 τ min/max, over the attention
    layers."""
    h2 = cfg.h2eal
    nr, ns, n_attn = _head_split(cfg)
    hd = cfg.resolved_head_dim
    pages = -(-int(ctx) // h2.page_size) if ctx > 0 else 0
    paged_kv = 2 * pages * h2.page_size * hd * BF16 * nr
    ring_kv = 2 * min(int(ctx), h2.sink + h2.local) * hd * BF16 * ns
    meta = 2 * pages * hd * F32 * nr
    return float((paged_kv + ring_kv + meta) * n_attn)


def migration_traffic_bytes(cfg: ArchConfig, *, migrations: int,
                            migrated_tokens: int) -> float:
    """Migration traffic of a serving run from the engine's counters
    (``EngineStats.migrations`` / ``migrated_tokens``): each move priced at
    the mean migrated context. Migration runs between engine steps, so it
    costs link occupancy and energy, not a stall."""
    if migrations <= 0:
        return 0.0
    mean_ctx = migrated_tokens / migrations
    return migrations * migration_slot_bytes(cfg, ctx=int(round(mean_ctx)))
