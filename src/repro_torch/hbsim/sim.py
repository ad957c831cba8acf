"""Cycle/energy model of the H²EAL hybrid-bonding accelerator (Table II;
counterpart of ``repro/hbsim/sim.py``).

Every number it returns is the MODEL's projection for the paper's edge
accelerator, not a measurement of any device this port runs on; print it
labelled so.

Hardware model (from the paper's Table II, [11][12][36]):
  * logic die: 16 banks in a 4x4 NoC; each bank a DCIM GEMM engine of
    16 macros x 900 GOPS @ int8 = 14.4 TOPS/bank; 24 TOPS/W.
  * memory: 4 stacked DRAM dies; per logic bank, each die contributes
    256 bits / 4 macros / cycle @ 400 MHz = 51.2 GB/s, so a bank sees
    4 x 51.2 = 204.8 GB/s and the chip 3.28 TB/s aggregate.
    Access energy 0.88 pJ/bit.
  * NoC: 256-bit 2-D mesh @ 400 MHz = 12.8 GB/s/link; hop energy assumed
    0.8 pJ/B (not in Table II; typical 22nm mesh — documented assumption).
  * quantization: W8A8KV8 (paper §V-A.2) — 1 byte/element everywhere.

The reference's own validation of the model against the paper's Table III
and Fig 9 is in its ``benchmarks/`` and ``EXPERIMENTS.md``; the port's copy
returns the reference's numbers (tests/test_torch_hbsim.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.configs.base import ArchConfig, H2ealConfig
from repro_torch.runtime import perfmodel
from repro_torch.sched import mapping as MP
from repro_torch.sched import tiling as TL


@dataclass(frozen=True)
class HBConfig:
    banks: int = 16
    grid: Tuple[int, int] = (4, 4)
    bank_tops: float = 14.4e12          # int8 ops/s per bank (16 x 900G)
    tops_per_watt: float = 24e12        # compute energy
    bank_mem_bw: float = 4 * 51.2e9     # 4 stacked dies per bank
    mem_energy_per_byte: float = 0.88e-12 * 8
    noc_link_bw: float = 12.8e9
    noc_energy_per_byte_hop: float = 0.8e-12
    sram_per_bank: int = 8 * 128 * 1024

    @property
    def chip_mem_bw(self) -> float:
        return self.banks * self.bank_mem_bw


MODES = ("full", "sparse_unbalanced", "h2eal")


@dataclass
class Cost:
    mem_bytes: float = 0.0
    ops: float = 0.0
    noc_bytes_hops: float = 0.0

    def __iadd__(self, o: "Cost"):
        self.mem_bytes += o.mem_bytes
        self.ops += o.ops
        self.noc_bytes_hops += o.noc_bytes_hops
        return self


def _head_decode_cost(kind: str, cfg: ArchConfig, h2: H2ealConfig,
                      seq: int, mode: str) -> Cost:
    """Per-KV-head, per-layer cost of one decode step (int8)."""
    d = cfg.resolved_head_dim
    g = cfg.num_heads // cfg.num_kv_heads
    if mode == "full" or not h2.enabled:
        tokens = seq
        meta_bytes = 0.0
    elif kind == "streaming":
        tokens = h2.sink + h2.local
        meta_bytes = 0.0
    else:  # retrieval head with page selection
        tokens = h2.sink + h2.local + h2.select_budget
        n_pages = seq / h2.page_size
        # tau_min + tau_max per page, amortized over the shared window
        meta_bytes = 2 * n_pages * d / max(h2.share_window, 1)
    kv_bytes = 2 * tokens * d            # K + V, int8
    # QK^T + PV for the whole GQA group (2 ops per MAC)
    ops = 2 * 2 * tokens * d * g
    if meta_bytes:
        ops += 2 * 2 * (seq / h2.page_size) * d / max(h2.share_window, 1)
    return Cost(mem_bytes=kv_bytes + meta_bytes, ops=ops)


def attention_decode(cfg: ArchConfig, seq: int, mode: str,
                     hb: HBConfig = HBConfig(),
                     h2: H2ealConfig | None = None) -> Dict:
    """One decode step of ALL attention layers. Returns latency (s),
    energy (J) and per-bank load breakdown for the balance ablation."""
    h2 = h2 or cfg.h2eal
    n_kv = cfg.num_kv_heads
    n_layers = len(cfg.attention_layers) or cfg.num_layers
    plan = MP.map_heads(n_kv, hb.banks)

    # head kinds: gating assigns types per head with no layout structure —
    # spread retrieval heads round-robin over the natural head order (the
    # arbitrary placement the load balancer must then fix; grouping them
    # here would accidentally balance the "unbalanced" baseline)
    n_s = round(n_kv * h2.static_sparsity) if mode != "full" else 0
    n_r = n_kv - n_s
    kinds = ["streaming"] * n_kv
    for i in range(n_r):
        kinds[(i * n_kv) // max(n_r, 1)] = "retrieval"

    total_latency = 0.0
    total_energy = 0.0
    bank_times_first_stage: List[float] = []

    for stage in plan.stages:
        # banks per head in this stage (tensor parallelism within group)
        bph = stage.banks_per_head
        head_costs = [_head_decode_cost(kinds[h], cfg, h2, seq, mode)
                      for h in stage.heads]
        # place heads on banks: one head -> bph banks
        if mode == "h2eal":
            # tile retrieval with streaming heads; within a tile the KV
            # work is split evenly (co-placement + interleaving)
            coords = TL.grid_coords(*hb.grid)[: len(stage.heads) * bph]
            head_of_bank = {}
            for i, hd in enumerate(stage.heads):
                for j in range(bph):
                    head_of_bank[coords[i * bph + j]] = hd
            retr = [c for c, hd in head_of_bank.items()
                    if kinds[hd] == "retrieval"]
            stre = [c for c, hd in head_of_bank.items()
                    if kinds[hd] == "streaming"]
            tiles, _ = TL.solve_tiling(retr, stre)
            bank_time = []
            for t in tiles:
                tot = Cost()
                for c in t.members:
                    hc = head_costs[stage.heads.index(head_of_bank[c])]
                    tot += Cost(hc.mem_bytes / bph, hc.ops / bph, 0)
                share_mem = tot.mem_bytes / len(t.members)
                share_ops = tot.ops / len(t.members)
                # cross-bank softmax combine: (m, l, o) ≈ (2 + head_dim)
                # values per head per member, over max_dist hops
                noc = (len(t.members) * (2 + cfg.resolved_head_dim)
                       * max(t.max_dist, 1))
                tme = max(share_mem / hb.bank_mem_bw,
                          share_ops / hb.bank_tops) + noc / hb.noc_link_bw
                bank_time.extend([tme] * len(t.members))
                total_energy += (tot.mem_bytes * len(t.members) / bph * 0
                                 + noc * hb.noc_energy_per_byte_hop)
            stage_latency = max(bank_time)
        else:
            # one head per bank-group; no sharing: slowest head gates all
            per_head_time = [
                max(hc.mem_bytes / bph / hb.bank_mem_bw,
                    hc.ops / bph / hb.bank_tops)
                for hc in head_costs]
            bank_time = [t for t in per_head_time for _ in range(bph)]
            stage_latency = max(per_head_time)
        bank_times_first_stage = bank_times_first_stage or bank_time
        total_latency += stage_latency
        for hc in head_costs:
            total_energy += (hc.mem_bytes * hb.mem_energy_per_byte
                             + hc.ops / hb.tops_per_watt)

    total_latency *= n_layers
    total_energy *= n_layers
    return {
        "latency_s": total_latency,
        "energy_j": total_energy,
        "bank_times": bank_times_first_stage,
        "stages": plan.num_stages,
    }


def far_bank_transfer(nbytes: float, hb: HBConfig = HBConfig(),
                      *, hops: float | None = None) -> Dict:
    """Cost of moving ``nbytes`` between a bank's near tier (its stacked
    DRAM dies) and the far bank over the NoC — the hardware behind the
    serving engine's hot/cold page residency (spills, demand fills and
    prefetches; byte counts from runtime.perfmodel.tier_traffic_bytes).

    Latency is NoC-link bound (12.8 GB/s/link << 204.8 GB/s near-memory
    bandwidth); energy pays both memory endpoints (read source + write
    destination) plus the per-hop NoC energy. ``hops`` defaults to the
    mean Manhattan distance of the mesh grid — a documented assumption,
    like the hop energy itself."""
    if hops is None:
        gx, gy = hb.grid
        hops = (gx + gy) / 2.0
    latency = nbytes / hb.noc_link_bw
    energy = nbytes * (2 * hb.mem_energy_per_byte
                       + hops * hb.noc_energy_per_byte_hop)
    return {"latency_s": latency, "energy_j": energy, "hops": hops}


def tiered_serving_overhead(cfg: ArchConfig, *, fills: int, spills: int,
                            prefetch: int, decode_steps: int,
                            hb: HBConfig = HBConfig()) -> Dict:
    """Modeled far-bank overhead of a tiered serving run: converts the
    engine's page counters into blocking (demand-fill) and overlapped
    (prefetch + spill) transfer time and total energy, amortized per
    decode step. The blocking share is the model's prediction of what
    tiering costs when the prefetcher misses; the overlapped share rides
    under decode and costs only energy."""
    traffic = perfmodel.tier_traffic_bytes(
        cfg, fills=fills, spills=spills, prefetch=prefetch)
    blocking = far_bank_transfer(traffic["blocking"], hb)
    overlapped = far_bank_transfer(traffic["total"] - traffic["blocking"],
                                   hb)
    steps = max(int(decode_steps), 1)
    return {
        "far_bytes": traffic["total"],
        "blocking_s": blocking["latency_s"],
        "overlapped_s": overlapped["latency_s"],
        "energy_j": blocking["energy_j"] + overlapped["energy_j"],
        "blocking_s_per_step": blocking["latency_s"] / steps,
    }


def rebalance_overhead(cfg: ArchConfig, *, migrations: int,
                       migrated_tokens: int, decode_steps: int,
                       hb: HBConfig = HBConfig()) -> Dict:
    """Modeled NoC cost of a rebalanced serving run: converts the
    engine's migration counters (EngineStats.migrations /
    migrated_tokens; byte model runtime.perfmodel.migration_traffic_bytes)
    into transfer time and energy, amortized per decode step. Migration
    runs between engine steps — never inside one — so the time is
    overlap-able link occupancy, not a decode stall; the cycle model
    prices what each migration costs against the per-bank imbalance it
    removes (EngineStats.imbalance_pre/post)."""
    nbytes = perfmodel.migration_traffic_bytes(
        cfg, migrations=migrations, migrated_tokens=migrated_tokens)
    xfer = far_bank_transfer(nbytes, hb)
    steps = max(int(decode_steps), 1)
    return {
        "migration_bytes": nbytes,
        "transfer_s": xfer["latency_s"],
        "energy_j": xfer["energy_j"],
        "transfer_s_per_step": xfer["latency_s"] / steps,
    }


def gemm_decode(cfg: ArchConfig, hb: HBConfig = HBConfig()) -> Dict:
    """Non-attention (GEMM) cost of one decode token: weights are read
    once from the memory dies (batch=1 edge decode), compute on DCIM."""
    n = cfg.active_param_count()
    w_bytes = float(n)  # int8
    ops = 2.0 * n
    lat = max(w_bytes / hb.chip_mem_bw, ops / (hb.bank_tops * hb.banks))
    energy = w_bytes * hb.mem_energy_per_byte + ops / hb.tops_per_watt
    return {"latency_s": lat, "energy_j": energy}


def e2e_decode(cfg: ArchConfig, seq: int, mode: str,
               hb: HBConfig = HBConfig(),
               h2: H2ealConfig | None = None) -> Dict:
    att = attention_decode(cfg, seq, mode, hb, h2)
    gem = gemm_decode(cfg, hb)
    lat = att["latency_s"] + gem["latency_s"]
    en = att["energy_j"] + gem["energy_j"]
    return {
        "latency_s": lat,
        "tokens_per_s": 1.0 / lat,
        "tokens_per_j": 1.0 / en,
        "attention_s": att["latency_s"],
        "gemm_s": gem["latency_s"],
    }
