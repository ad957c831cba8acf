"""The serving byte model (counterpart of the serving half of
``repro/runtime/perfmodel.py``): the wire bytes of tiered page residency
and of live slot migration, counted from the engine's counters. The hbsim
cycle model (``hbsim/sim.py``) prices them on the paper's hybrid-bonding
accelerator. Bytes are those of the bf16 wire format, with the page
metadata in f32 where the implementation keeps f32.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

BF16 = 2
F32 = 4


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
