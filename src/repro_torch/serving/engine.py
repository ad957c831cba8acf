"""Slot-based continuous batching (counterpart of ``repro/serving/engine.py``).

The engine serves requests with ragged prompt and generation lengths from
a fixed batch of ``max_batch`` slots:

  * ``BatchState`` holds the batched serve state (per-slot caches and a
    (B,) ``length`` tensor on the card) and numpy mirrors of what the host
    loop needs: which slots decode (``active``), which take prompt chunks
    (``prefilling``), which wait for the shared refresh boundary
    (``ready``), each slot's length, share-window phase, budget and prompt
    tokens still to feed.
  * Admission, FIFO or balanced. **Chunked** (``prefill_chunk=N``): a
    request enters a free slot at once as PREFILLING; its cache rows are
    reset to the empty values and every engine step feeds at most N prompt
    tokens (split page-granular over the prefilling slots,
    ``sched/balance.py``) straight into the slots' rows, beside the ragged
    decode of the other slots. **Prefill-then-pack** (``prefill_chunk=None``):
    a batch-1 prefill of the whole prompt is written into a free slot's
    rows. **Balanced** (``admission="balanced"``, paper §IV-C): among the
    first ``admit_lookahead`` queued requests, the one that leaves the
    per-stripe page loads flattest is admitted, and the chunk budget goes
    to the slot whose next page lands on the least-loaded stripe.
  * Retirement (budget spent, or the slot's length at ``capacity``) clears
    ``active``; the slot's rows stay as they are until the next admission
    rewrites them.
  * Page selection refreshes on each slot's own share window
    (``phase % w == 0``, so a slot selects on its first decode step), and
    the select step applies the fresh selection only to the slots due
    (``need_select``). A READY slot starts decoding when every decoding
    slot sits at its refresh boundary, so all active phases stay aligned
    and the select variant runs on about 1/w of the steps.
  * ``step()`` reads nothing back from the card: the host decides from its
    mirrors, copies the small masks and token blocks to the card, and
    keeps each step's (B,) sampled tokens on the card. ``finalize()`` reads
    them once, at the end of ``run()``.
  * Compiled dispatch (``runtime/graphs.py``): the select, reuse, chunk
    and verify steps (the sample and the token feed's update folded into
    the decode steps) and the fused windows have fixed shapes
    (``max_batch``, ``prefill_chunk``, ``spec_tokens``, the window length),
    so on the card each is captured once as a CUDA graph at construction
    and replayed; ``jit_cache_sizes`` counts the captures, which never grow
    after construction. Packed prefill (one shape a prompt bucket),
    packing, slot resets and the first token stay eager. ``eager=True``
    runs every step eagerly. The graphs read the parameters and serve
    state bound at construction, so both refuse reassignment from then on.
  * Sampling (``serving/sampling.py``): per-request temperature, top-p
    and seed. Each slot's lanes (base key, temperature, top-p) are static
    inputs of every captured step, written at admission; its generation
    index lives on the card and the steps advance it. A token's key depends
    on (seed, uid, generation index) alone, so traces do not depend on slot
    churn, admission order or speculation.
  * Speculative decode (``spec_tokens=k``): each decode step drafts k-1
    tokens a slot (``serving/draft.py``), verifies all k in one chunked
    forward and emits the accepted prefix, at least one token; the coupled
    sampler makes the trace that of ``spec_tokens=None``, greedy or not.
    Acceptance stops at the slot's next selection boundary, its budget and
    the capacity. The host reads the accepted counts and targets once a
    verify step, as the JAX engine does.
  * Fused decode windows (``decode_window=w``): strictly between two
    selection boundaries every decoding slot takes reuse steps only, so the
    stretch to the next boundary (at most w and share_window - 1 steps)
    runs as ONE dispatch with retirement on the card
    (``sched/windows.window_budgets``); a prefilling slot's chunks for the
    stretch are planned on the host and fed inside the window. Tokens are
    those of the per-step engine.
  * Tiered residency (``hot_pages=N``, ``core/cache.TieredPagedCache``):
    each slot keeps about N pages on the card and spills the others to the
    far store in host memory. Selection reads only the pages' metadata,
    which stays on the card, so a select step selects as the all-resident
    engine does. Its digest (the selection and the page importance, one
    read a select step) shows the cold pages it selected; the engine then
    restores what the step wrote (``core/cache.DecodeStepSave``), fills
    those pages and replays the step: a miss is served late, never skipped.
    After each selection the hottest cold pages are prefetched one share
    window ahead and the pages outside the hot set spilled. Reuse steps read
    pinned pages only, so a fused window never misses.
  * Live slot rebalancing (``rebalance="retire"`` or ``"interval"``): at a
    retirement or every ``rebalance_interval`` engine steps the host scores
    each slot's next-step compute (``sched/cost.py``) and moves slots into
    free indices of underloaded banks (``sched/rebalance.py``) when that
    flattens the banks by at least ``rebalance_min_gain``, at most once per
    ``rebalance_cooldown`` steps. A move copies every row of the slot, the
    token feed and the sampling lanes (one captured step) and re-keys the
    host mirrors, so tokens are unchanged.

Every layout of the reference's registry is ported (``core/layouts.py``:
the layout's plan rounds the cache capacity to whole pages per stripe or
rank): ``default``, ``coplace_shmap``, and the GSPMD layouts ``head``,
``coplace`` and ``interleave``, where each rank of a ``launch/mesh.Mesh``
runs this engine on its block of the serve state; so too ``coplace_shmap``
given a mesh, each rank of 'model' holding one page stripe. FIFO and balanced
admission, sampling, speculative decode, fused windows, tiered residency
and rebalancing are ported, on every layout. On a GSPMD layout every rank
takes the same host decisions: the tiered select step's digest is the
whole batch's selection, gathered; the tier moves the pages of the rank's
block, and a migration moves a slot's row between ranks where the batch is
cut over 'data'.
The engine runs on the card unless ``device`` names the CPU, where it runs
the kernels' plain versions, eagerly.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ATTN_LOCAL_GLOBAL, MIXER_ATTENTION, ArchConfig
from repro_torch.core import cache as cachelib
from repro_torch.core import layouts as layoutlib
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.runtime import collectives as coll
from repro_torch.runtime import graphs
from repro_torch.runtime import serve as serve_rt
from repro_torch.sched import balance
from repro_torch.sched.cost import CostModel, SlotView, device_compute_loads
from repro_torch.sched.rebalance import plan_rebalance
from repro_torch.sched.windows import window_budgets
from repro_torch.serving import draft as draftlib
from repro_torch.serving import sampling as samplib


def _check_spec(cfg: ArchConfig, k: int, hot_pages) -> None:
    """The JAX engine's gates of ``spec_tokens``: the verify chunk runs the
    attention decode body only, and its tail must fit inside every later
    query's local window (k <= h2eal.local)."""
    if cfg.mixer_pattern and any(m != MIXER_ATTENTION for m in cfg.mixer_pattern):
        raise ValueError("spec_tokens requires all-attention mixers; "
                         f"mixer_pattern={cfg.mixer_pattern}")
    if cfg.attn_pattern == ATTN_LOCAL_GLOBAL:
        raise ValueError("spec_tokens requires the full attention pattern "
                         "(local_global windows have no verify-chunk path)")
    if not cfg.h2eal.enabled:
        raise ValueError("spec_tokens requires h2eal.enabled")
    if cfg.embed_frontend_stub:
        raise ValueError("spec_tokens feeds token chunks through the embedding; "
                         "frontend-stub archs are unsupported")
    if hot_pages:
        raise ValueError("spec_tokens is incompatible with tiered residency")
    if not 1 <= k <= cfg.h2eal.local:
        raise ValueError(f"spec_tokens={k} must be in "
                         f"[1, h2eal.local={cfg.h2eal.local}]")


# the refusal of a frontend-stub arch's requests (``models/model.py``)
STUB_ENGINE_REFUSAL = M.STUB_ENGINE_REFUSAL


@dataclasses.dataclass
class Request:
    """One generation request. Under packed admission the prompt length
    must be one of the engine's prompt buckets; chunked admission takes any
    length in [1, capacity). The sampling policy (``serving/sampling.py``)
    defaults to greedy argmax; the key stream belongs to (seed, uid), never
    to the slot."""

    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0


@dataclasses.dataclass
class Completion:
    uid: int
    prompt_len: int
    tokens: List[int]             # filled by Engine.finalize()
    admitted_step: int            # EngineStats.decode_steps at admission
    finished_step: int = -1
    first_token_step: int = -1    # EngineStats.engine_steps at the first token
    admitted_engine_step: int = -1
    _first_tok: object = None     # 0-d tensor on the device until finalize()
    _slot: int = -1
    _seq: int = -1                # admission order (FIFO chunk order)
    _step_idx: List[int] = dataclasses.field(default_factory=list)  # trace rows
    # the slot each trace row was emitted in: a migration moves the request
    # to another slot, and its earlier rows stay where they were written
    _slot_idx: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EngineStats:
    decode_steps: int = 0
    select_steps: int = 0
    reuse_steps: int = 0
    engine_steps: int = 0         # logical steps that did any work (a fused
                                  # window counts each of its steps)
    admissions: int = 0
    admission_reorders: int = 0   # balanced admission: non-FIFO picks
    prefill_chunks: int = 0       # chunked-prefill steps (chunks fed inside
                                  # fused windows count too)
    tokens_out: int = 0
    occupancy_sum: float = 0.0    # sum over decode steps of the live-slot share
    wall_s: float = 0.0           # set by run()
    # dispatch accounting, as the JAX engine's: every step the engine
    # issues (a graph replay or an eager call: select, reuse, chunk, fused
    # window; packed prefill, pack, reset and first token) is a dispatch.
    # The decode steps fold their sample in, so a per-step decode step is
    # one dispatch; a fused window is one for up to w-1 steps, and a verify
    # step is one (the draft provider's own steps are not counted, as in
    # the JAX engine)
    dispatches: int = 0
    fused_windows: int = 0        # fused-window dispatches
    fused_steps: int = 0          # decode steps taken inside them
    # the port's own: mixed-variant windows (a subset of fused_windows) and
    # the prefill chunks fed inside them, so that launches can be counted
    fused_mixed_windows: int = 0
    fused_chunks: int = 0
    # speculative decode (spec_tokens=k)
    spec_steps: int = 0           # verify dispatches
    spec_slot_steps: int = 0      # per-slot verify events
    spec_drafted: int = 0         # draft tokens proposed (k-1 an event)
    spec_accepted: int = 0        # tokens emitted by verify steps (>= 1 an event)
    # tiered residency (hot_pages=N); every count is of PAGES
    tier_hits: int = 0            # selected pages found on the card
    tier_misses: int = 0          # selected pages cold: filled and replayed
    tier_spills: int = 0          # pages moved to the far store
    tier_fills: int = 0           # demand fills (a miss's repair)
    tier_prefetch: int = 0        # fills one share window ahead
    tier_fill_batches: int = 0    # batched fills (demand and prefetch)
    tier_spill_batches: int = 0   # batched spills
    tier_gather_batches: int = 0  # batched copies of first spills to the far store
    tier_batch_pages_max: int = 0  # the largest batched transfer
    tier_archived: int = 0        # the port's own: pages copied to the far
                                  # store (a page's first spill; later spills
                                  # reuse its copy)
    # live slot rebalancing (rebalance="retire" / "interval")
    rebalance_checks: int = 0     # planner runs (after the cooldown)
    rebalances: int = 0           # plans applied (>= 1 migration each)
    rebalance_skipped: int = 0    # triggers refused (cooldown or hysteresis)
    migrations: int = 0           # slot moves
    migrated_tokens: int = 0      # context tokens moved (the byte model's input)
    imbalance_pre_sum: float = 0.0   # cost imbalance at each check
    imbalance_post_sum: float = 0.0  # ... after the plan applied there, if any

    @property
    def occupancy(self) -> float:
        return self.occupancy_sum / max(self.decode_steps, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def steps_per_s(self) -> float:
        """Decode-step rate: ``tokens_per_s`` per slot without speculation;
        under ``spec_tokens=k`` a verify step emits up to k tokens a slot,
        so the two rates part."""
        return self.decode_steps / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def engine_steps_per_s(self) -> float:
        """Logical engine-step rate; ``steps_per_dispatch`` is the fusion
        factor."""
        return self.engine_steps / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_accepted_len(self) -> float:
        """Mean tokens emitted a per-slot verify event (1.0: every draft
        rejected; k: every draft accepted)."""
        return (self.spec_accepted / self.spec_slot_steps
                if self.spec_slot_steps else 0.0)

    @property
    def steps_per_dispatch(self) -> float:
        """Decode steps per dispatch: the dispatch reduction of fused
        windows, observable without a profiler."""
        return self.decode_steps / self.dispatches if self.dispatches else 0.0

    @property
    def tier_hit_rate(self) -> float:
        seen = self.tier_hits + self.tier_misses
        return self.tier_hits / seen if seen else 1.0

    @property
    def tier_fill_batch_mean(self) -> float:
        """Mean pages a batched fill (demand and prefetch)."""
        return ((self.tier_fills + self.tier_prefetch) / self.tier_fill_batches
                if self.tier_fill_batches else 0.0)

    @property
    def tier_spill_batch_mean(self) -> float:
        """Mean pages a batched spill."""
        return (self.tier_spills / self.tier_spill_batches
                if self.tier_spill_batches else 0.0)

    @property
    def imbalance_pre(self) -> float:
        """Mean max/mean bank-compute imbalance at the rebalance checks (1.0
        when none ran)."""
        return (self.imbalance_pre_sum / self.rebalance_checks
                if self.rebalance_checks else 1.0)

    @property
    def imbalance_post(self) -> float:
        """The same checks after the plan applied there (the pre value where
        a check moved nothing)."""
        return (self.imbalance_post_sum / self.rebalance_checks
                if self.rebalance_checks else 1.0)


@dataclasses.dataclass
class BatchState:
    """The batched serve state and its host mirrors. A slot is in one of
    four phases: FREE, PREFILLING (``prefilling``; ``lengths`` counts the
    prompt tokens fed so far), READY (prompt done and first token emitted,
    waiting for the shared refresh boundary) or DECODING (``active``)."""

    serve: dict                 # model serve state, length: (B,) int32 tensor
    active: np.ndarray          # (B,) bool
    prefilling: np.ndarray      # (B,) bool
    ready: np.ndarray           # (B,) bool
    lengths: np.ndarray         # (B,) int64, mirror of serve["length"]
    phase: np.ndarray           # (B,) int64, decode steps since admission
    uid: np.ndarray             # (B,) int64, -1 when free
    remaining: np.ndarray       # (B,) int64, generation budget left
    prompt_left: np.ndarray     # (B,) int64, prompt tokens not yet fed

    def __setattr__(self, name, value):
        if name == "serve" and getattr(self, "_sealed", False):
            raise AttributeError(
                "the engine's captured steps read the serve state bound at "
                "construction: write into its tensors, do not replace it")
        object.__setattr__(self, name, value)

    def seal(self) -> None:
        """From now on ``serve`` refuses reassignment."""
        object.__setattr__(self, "_sealed", True)

    @property
    def max_batch(self) -> int:
        return self.active.shape[0]

    def free_slots(self) -> List[int]:
        return [i for i in range(self.max_batch)
                if not (self.active[i] or self.prefilling[i] or self.ready[i])]


def _cache_fields(layer_cache: dict):
    """(field name, tensor) of every tensor of one block's serve cache."""
    for c in layer_cache.values():
        for f in dataclasses.fields(c):
            yield f.name, getattr(c, f.name)


def _pack_slot(big: dict, small: dict, slot: int) -> None:
    """Write the batch-1 serve state ``small`` (of ``M.prefill``) into slot
    ``slot`` of the batched state ``big``, in place."""
    # fill_, not item assignment: assigning a Python number to a 0-d
    # element of a card tensor copies it from the host and waits
    big["length"][slot].fill_(small["length"])
    for lb, ls in zip(big["layers"], small["layers"]):
        for (_, tb), (_, ts) in zip(_cache_fields(lb), _cache_fields(ls)):
            tb[slot].copy_(ts[0])


def _migrate_rows(big: dict, extra, src: torch.Tensor, dst: torch.Tensor,
                  places=None) -> None:
    """Copy row ``src`` of every tensor of the batched state and of ``extra``
    to row ``dst``, then clear ``src`` to the empty values (index tensors of
    one element, so that the step has fixed shapes and is captured once).
    ``places`` (a ``cache.Placement`` a layer): the layers' caches are a
    rank's blocks, moved by ``cache.move_block_rows``."""
    rows = [("length", big["length"])]
    if places is None:
        for layer in big["layers"]:
            rows += list(_cache_fields(layer))
    else:
        cachelib.move_block_rows(big["layers"], places, src, dst)
    rows += [("", t) for t in extra]
    for name, t in rows:
        t.index_copy_(0, dst, t.index_select(0, src))
        t.index_fill_(0, src, cachelib.empty_fill_value(name))


def _selection_digest(big: dict, whole=None) -> torch.Tensor:
    """(L, B, Hr, K + C) int32: each paged layer's selection and, bit for
    bit, its page importance, so that the host reads both at once.
    ``whole(field, stacked)`` gathers a rank's blocks of a field, the
    layers stacked, into the whole batch's (a GSPMD layout)."""
    whole = whole or (lambda field, t: t)
    paged = [layer["paged"] for layer in big["layers"] if "paged" in layer]
    sel = whole("sel_idx", torch.stack([c.sel_idx for c in paged]))
    imp = whole("importance", torch.stack([c.importance for c in paged]))
    return torch.cat([sel, imp.view(torch.int32)], dim=-1)


def _reset_slot(big: dict, slot: int) -> None:
    """Clear slot ``slot`` of the batched state to the empty-cache values
    (``cache.empty_fill_value``) and length 0, in place: chunked admission
    starts from this row, so no key of a previous occupant passes a
    validity mask and the chunk appends' τ min/max merge is exact."""
    big["length"][slot].fill_(0)
    for layer in big["layers"]:
        for name, t in _cache_fields(layer):
            t[slot].fill_(cachelib.empty_fill_value(name))


class Engine:
    """Continuous-batching engine; see the module docstring.

    cfg, params     model config and parameters (on ``device``).
    max_batch       number of slots.
    capacity        the most context tokens a slot may reach; the cache
                    holds the layout plan's rounding of it.
    prompt_buckets  prompt lengths packed admission takes.
    layout          serve-cache layout, a ``core/layouts`` registry name:
                    "default", "coplace_shmap", or a GSPMD layout ("head",
                    "coplace", "interleave") over the ranks of ``mesh``.
    shards          coplace_shmap's page stripes on one card (the size of the
                    JAX mesh's 'model' axis; 1 as on one JAX device); on a
                    mesh 1 or the size of its 'model' axis.
    mesh            a GSPMD layout's ``launch/mesh.Mesh`` (default: the
                    one-rank mesh); given with coplace_shmap, that layout is
                    served over the mesh's ranks, rank r of 'model' holding
                    page stripe r (without one, its stripes lie on one
                    card). Every rank builds the same engine with the
                    same parameters and requests and takes the same host
                    decisions; it holds only its block of the serve state, and
                    every rank's steps give the same tokens. Every family the
                    default layout serves is served there, with the default's
                    options and its refusals; a frontend-stub arch raises the
                    default's ``STUB_ENGINE_REFUSAL`` at construction. The
                    steps of a gloo mesh run eagerly, and a gloo mesh on
                    the card refuses capture unless ``eager=True``.
    admission       "fifo" or "balanced": scores the first
                    ``admit_lookahead`` queued requests by the per-stripe
                    page-load imbalance they would leave
                    (``sched/balance.admission_score``) and admits the best,
                    FIFO on ties; it also steers the chunk budget.
    balance_shards  the stripe count balanced admission scores against;
                    default the layout plan's (1: FIFO).
    prefill_chunk   None: prefill-then-pack admission. N: chunked
                    admission, at most N prompt tokens per engine step.
    decode_window   None or 1: per-step dispatch. w > 1: the reuse steps up
                    to the next selection boundary, at most
                    min(w, share_window - 1) of them, run as one fused
                    window; with chunked admission the prefilling slots'
                    chunks for the stretch are fed inside it. Tokens equal
                    the per-step engine's.
    spec_tokens     draft length k: speculative decode. Each decode step
                    drafts k-1 tokens a slot, verifies all k in one chunked
                    forward (the verify step, captured) and emits the
                    accepted prefix; traces equal those of spec_tokens=None,
                    greedy and sampled. Needs a dense attention stack with
                    H²EAL on, no tiering, no fused windows, and 1 <= k <=
                    h2eal.local (the chunk must fit the local window).
    draft           a ``serving/draft.DraftProvider`` or a builtin's name,
                    "ngram" (host prompt lookup, the default) or "streaming"
                    (the model's streaming heads draft); used with
                    ``spec_tokens`` only.
    hot_pages       per-slot budget of pages on the card: tiered residency
                    (None: every page resident). Cold pages spill to the far
                    store in host memory; tokens equal the all-resident
                    engine's. Counted in ``EngineStats.tier_*``.
    rebalance       "off", "retire" (plan when a slot retires) or "interval"
                    (every ``rebalance_interval`` engine steps): live slot
                    migration to flatten the per-bank compute of
                    ``sched/cost.py`` over ``rebalance_banks`` contiguous
                    blocks of slot indices (default: the layout's stripes,
                    else one bank per two slots, at most 4), applied when it
                    gains at least ``rebalance_min_gain`` and at most once
                    per ``rebalance_cooldown`` engine steps. Tokens equal
                    those of rebalance="off".
    device          the card unless the caller names the CPU.
    eager           run the steps eagerly on the card instead of replaying
                    the CUDA graphs captured at construction (the CPU always
                    runs them eagerly).

    The captured steps read the parameters and the serve state bound at
    construction, so from the end of construction ``params`` and
    ``batch.serve`` refuse reassignment, on every device (the eager CPU
    engine would not mix weights, but one rule holds everywhere); write
    into their tensors instead.
    """

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int,
                 capacity: int, prompt_buckets: Sequence[int],
                 layout: str = "default", shards: int = 1, mesh=None,
                 admission: str = "fifo", admit_lookahead: int = 4,
                 balance_shards: Optional[int] = None,
                 prefill_chunk: Optional[int] = None, device=None,
                 hot_pages: Optional[int] = None,
                 spec_tokens: Optional[int] = None, draft="ngram",
                 rebalance: str = "off", rebalance_interval: int = 16,
                 rebalance_min_gain: float = 0.02, rebalance_cooldown: int = 8,
                 rebalance_banks: Optional[int] = None,
                 decode_window: Optional[int] = None, eager: bool = False):
        lay = layoutlib.get_layout(layout, shards, mesh)
        self.spec_tokens = int(spec_tokens) if spec_tokens else None
        self.draft = None
        if self.spec_tokens is not None:
            _check_spec(cfg, self.spec_tokens, hot_pages)
            self.draft = draftlib.resolve_draft(draft)
        self.hot_pages = int(hot_pages) if hot_pages else None
        if rebalance not in ("off", "retire", "interval"):
            raise ValueError(f"rebalance={rebalance!r}: valid triggers are "
                             "'off', 'retire', 'interval'")
        self.rebalance = rebalance
        self.rebalance_interval = max(int(rebalance_interval), 1)
        self.rebalance_min_gain = float(rebalance_min_gain)
        self.rebalance_cooldown = max(int(rebalance_cooldown), 0)
        self.decode_window = 1 if decode_window is None else int(decode_window)
        if self.decode_window < 1:
            raise ValueError(f"decode_window={decode_window} must be >= 1 "
                             f"(1 == per-step dispatch)")
        if self.decode_window > 1 and self.spec_tokens is not None:
            # verify steps move each slot's phase by a variable accepted
            # count, which a fixed-budget window cannot encode
            raise ValueError(
                "decode_window > 1 is incompatible with spec_tokens (verify "
                "steps advance phases by variable accepted counts); pass "
                "decode_window=None for per-step dispatch")
        if admission not in ("fifo", "balanced"):
            raise ValueError(f"unknown admission {admission!r}")
        self.layout, self.shards, self.plan = lay.name, lay.shards, lay.plan(cfg, mesh)
        self.mesh = self.plan.mesh if lay.gspmd else None
        self.admission = admission
        self.admit_lookahead = max(int(admit_lookahead), 1)
        self.balance_shards = balance_shards
        if rebalance_banks is not None:
            self.rebalance_banks = min(max(int(rebalance_banks), 1), int(max_batch))
        else:
            # one bank per TWO slot indices: LPT can pair a heavy slot with
            # a light one only inside a block of two or more
            nb = (self.plan.balance_shards if self.plan.balance_shards > 1
                  else max(min(int(max_batch) // 2, 4), 1))
            self.rebalance_banks = min(nb, int(max_batch))
        self._cost_model = None
        if self.rebalance != "off":
            self._cost_model = CostModel.from_config(
                cfg, hot_cap=self.hot_pages, spec_tokens=self.spec_tokens or 0,
                chunk_budget=int(prefill_chunk) if prefill_chunk else 0)
        self._rebalance_due = False
        self._last_rebalance_step = -(1 << 30)
        self._prev_engine_steps = 0
        self.cfg = cfg
        self.params = params
        self.device = serve_rt.resolve_device(device)
        if params["final_norm"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['final_norm'].device}, the "
                             f"engine runs on {self.device}")
        self.capacity = int(capacity)
        # a whole number of pages per stripe; retirement stays at `capacity`
        self.cache_capacity = self.plan.round_capacity(self.capacity)
        self.prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
        if not self.prompt_buckets or self.prompt_buckets[-1] >= self.capacity:
            raise ValueError(f"prompt buckets {self.prompt_buckets} must be "
                             f"non-empty and below capacity {self.capacity}")
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk is not None and cfg.embed_frontend_stub:
            raise ValueError(M.STUB_CHUNK_REFUSAL)
        if self.prefill_chunk is not None and self.prefill_chunk > self.capacity:
            raise ValueError(f"prefill_chunk {self.prefill_chunk} exceeds "
                             f"capacity {self.capacity}")
        self.share_window = max(cfg.h2eal.share_window, 1)
        # a window holds the reuse steps between two selection boundaries
        self._fused_len = (min(self.decode_window, self.share_window - 1)
                           if self.decode_window > 1 and self.share_window > 1
                           else 0)
        scfg = serve_rt.ServeConfig(capacity=self.cache_capacity,
                                    layout=self.layout, shards=self.shards,
                                    mesh=self.mesh, max_batch=int(max_batch))
        self.serve_config = scfg
        if lay.gspmd:
            # after every option's own gate, so that an option refused for a
            # family raises the default layout's error; a frontend-stub arch
            # raises its refusal here, and nothing falls back to another layout
            layoutlib.check_gspmd_config(cfg)
        # a GSPMD layout placed on this rank: the batched state is its blocks
        self._placed = serve_rt.serve_layout(scfg) if lay.gspmd else None
        self._prefill = serve_rt.make_prefill(cfg, scfg)
        self._dec_sel = serve_rt.make_ragged_decode_step(cfg, scfg, do_select=True)
        self._dec_reuse = serve_rt.make_ragged_decode_step(cfg, scfg,
                                                           do_select=False)
        self._sample = serve_rt.make_sample_step(cfg, scfg)
        if self.prefill_chunk is not None:
            self._chunk = serve_rt.make_prefill_chunk_step(
                cfg, scfg, chunk=self.prefill_chunk)
        if self._fused_len:
            self._fused = serve_rt.make_fused_window_step(
                cfg, scfg, window=self._fused_len)
            if self.prefill_chunk is not None:
                self._fused_mix = serve_rt.make_fused_window_step(
                    cfg, scfg, window=self._fused_len, chunk=self.prefill_chunk)
        if self.spec_tokens is not None:
            self._verify = serve_rt.make_verify_step(cfg, scfg, k=self.spec_tokens)
            self._spec_history: Dict[int, List[int]] = {}
            self._spec_emitted = np.zeros(int(max_batch), np.int64)
        b = int(max_batch)
        self.batch = BatchState(
            serve=M.empty_serve_state(cfg, b, capacity=self.cache_capacity,
                                      dtype=params["final_norm"].dtype,
                                      device=self.device,
                                      layout=self._placed or layoutlib.DEFAULT),
            active=np.zeros(b, bool), prefilling=np.zeros(b, bool),
            ready=np.zeros(b, bool), lengths=np.zeros(b, np.int64),
            phase=np.zeros(b, np.int64), uid=np.full(b, -1, np.int64),
            remaining=np.zeros(b, np.int64), prompt_left=np.zeros(b, np.int64))
        # a GSPMD layout: each layer's placement, one a kind of layer (H²EAL
        # pages and ring, a full cache, a recurrent state), and the paged
        # layers' (the tier, the digest and the decode-step save read it)
        self._specs = [T.layer_spec(cfg, pos) for pos in M.layer_positions(cfg)]
        self._paged_spec = next((sp for sp in self._specs
                                 if not isinstance(sp, cachelib.RecurrentSpec)
                                 and not sp.full_cache), None)
        self._places = self._place = None
        if self._placed is not None:
            self._places = [self._placed.place(sp) for sp in self._specs]
            if self._paged_spec is not None:
                self._place = self._placed.place(self._paged_spec)
        # the token feed: each slot's next input token, and the generation
        # index of that slot's next sample, both updated in place
        self._tok = torch.zeros(b, dtype=torch.int32, device=self.device)
        self._gen = torch.zeros(b, dtype=torch.int32, device=self.device)
        # host mirrors of the sampling lanes, copied into the steps' inputs
        self._samp_base = np.zeros((b, 2), np.int64)
        self._samp_temp = np.zeros(b, np.float32)
        self._samp_topp = np.ones(b, np.float32)
        self._trace: List[torch.Tensor] = []     # (rows, B) token blocks
        self._trace_rows = 0
        self.trace_engine_steps: List[int] = []  # engine step of each trace row
        self._prompts: Dict[int, np.ndarray] = {}
        self._admit_seq = 0
        self._queue: deque[Request] = deque()
        self._live: Dict[int, Completion] = {}       # slot -> in flight
        self.completions: Dict[int, Completion] = {}  # uid -> finished
        self.stats = EngineStats()
        self._tier = None
        self._tier_plan = None        # pending (need, selection, hotness) refresh
        if self.hot_pages is not None:
            self._init_tier()
        self._graphs = graphs.StepGraphs(self.device, eager=eager, mesh=self.mesh)
        if self._takes_requests():
            self._add_steps(b)
        if self.draft is not None:
            self.draft.bind(self)
        self.batch.seal()
        self._sealed = True

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value):
        if getattr(self, "_sealed", False):
            raise AttributeError(
                "the engine's captured steps read the parameters bound at "
                "construction: build a new Engine for other weights")
        self._params = value

    def _add_steps(self, b: int):
        """The fixed-shape steps over static input buffers, captured on the
        card (``runtime/graphs.py``). Each reads the serve state, the token
        feed, the generation indices and the sampling lanes, and writes the
        first three in place."""
        g, serve, tok, gen = self._graphs, self.batch.serve, self._tok, self._gen
        # the steps look the engine up through a proxy, so that they do not
        # keep it (and its cache) alive in a reference cycle
        me = weakref.proxy(self)
        act = self._act = g.input("act", (b,), torch.bool)
        lanes = (g.input("base", (b, 2), torch.int64),
                 g.input("temp", (b,), torch.float32),
                 g.input("topp", (b,), torch.float32))
        self._lanes = lanes
        g.set(topp=self._samp_topp)

        def decode(step, *extra):
            before = graphs.snapshot(serve)
            logits, new = step(me.params, serve, tok, act, *extra)
            graphs.commit(before, new)
            base, temp, topp = lanes
            t, gen_new = me._sample(logits, base, gen, temp, topp, act)
            # inactive lanes keep their feed: a slot that finished
            # prefilling this step already holds its first token there
            tok.copy_(torch.where(act, t, tok))
            gen.copy_(gen_new)

        need = g.input("need", (b,), torch.bool)
        if self._tier is None:
            g.add("decode_select", lambda: decode(me._dec_sel, need))
        else:
            # the tiered select step saves what it writes, then returns its
            # digest; a replay after a cold miss restores first
            save = cachelib.DecodeStepSave(serve, (tok, gen), sink=self.cfg.h2eal.sink,
                                           phys_shards=self.plan.page_stripe_shards,
                                           place=self._place)

            def select():
                save.save()
                decode(me._dec_sel, need)
                return me._digest()
            g.add("decode_select", select)
            g.add("tier_restore", save.restore)
        g.add("decode_reuse", lambda: decode(me._dec_reuse))
        if self.rebalance != "off":
            src = g.input("mig_src", (1,), torch.int64)
            dst = g.input("mig_dst", (1,), torch.int64)
            g.add("migrate", lambda: _migrate_rows(serve, (tok, gen), src, dst,
                                                   me._places))
        c, w = self.prefill_chunk, self._fused_len
        if c is not None:
            ctoks = g.input("ctoks", (b, c), torch.int32)
            clens = g.input("clens", (b,), torch.int32)

            def chunk():
                before = graphs.snapshot(serve)
                logits, new = me._chunk(me.params, serve, ctoks, clens, clens > 0)
                graphs.commit(before, new)
                return logits
            g.add("prefill_chunk", chunk)
        if w:
            budgets = g.input("budgets", (b,), torch.int32)

            def window(step, *extra):
                before = graphs.snapshot(serve)
                trace, new, tok_new, gen_new = step(me.params, serve, tok, act, gen,
                                                    budgets, *lanes, *extra)
                graphs.commit(before, new)
                tok.copy_(tok_new)
                gen.copy_(gen_new)
                return trace
            g.add("fused_window", lambda: window(me._fused))
            if c is not None:
                wx = (g.input("wtoks", (w, b, c), torch.int32),
                      g.input("wclens", (w, b), torch.int32),
                      g.input("wfinish", (w, b), torch.bool))
                g.add("fused_window_mixed", lambda: window(me._fused_mix, *wx))
        if self.spec_tokens is not None:
            k = self.spec_tokens
            # the draft: written by the host, or on the card by the
            # streaming draft's own step
            self._draft_buf = torch.zeros((b, k - 1), dtype=torch.int32,
                                          device=self.device)
            max_emit = g.input("max_emit", (b,), torch.int32)

            def verify():
                before = graphs.snapshot(serve)
                tokens = torch.cat([tok[:, None], me._draft_buf], dim=1)
                targets, n, nxt, gen_new, new = me._verify(
                    me.params, serve, tokens, act, need, lanes[0], gen, lanes[1],
                    lanes[2], max_emit)
                graphs.commit(before, new)
                tok.copy_(torch.where(act, nxt, tok))
                gen.copy_(gen_new)
                # one block for the host's one read: the targets, then n
                return torch.cat([targets, n[:, None]], dim=1)
            g.add("verify", verify)

    # ------------------------------------------------------------------

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """A host mirror's copy on the engine's device. non_blocking: a
        blocking copy from host memory would wait for the card's queue."""
        return torch.from_numpy(np.array(a, copy=True)).to(self.device,
                                                          non_blocking=True)

    def _pack(self, small: dict, slot: int) -> None:
        """Write the batch-1 prefill state into slot ``slot``: the whole row,
        or under a GSPMD layout the rank's block of it."""
        if self._placed is None:
            return _pack_slot(self.batch.serve, small, slot)
        big = self.batch.serve
        big["length"][slot].fill_(small["length"])
        for spec, lb, ls in zip(self._specs, big["layers"], small["layers"]):
            self._placed.pack_slot(spec, lb, ls, slot)

    def _reset(self, slot: int) -> None:
        """Clear slot ``slot`` to the empty values (the rank's block of it)."""
        if self._placed is None:
            return _reset_slot(self.batch.serve, slot)
        big = self.batch.serve
        big["length"][slot].fill_(0)
        for spec, lb in zip(self._specs, big["layers"]):
            self._placed.reset_slot(spec, lb, slot)

    def _takes_requests(self, *, refuse: bool = False) -> bool:
        """False for a frontend-stub arch, whose engine takes no request
        (``STUB_ENGINE_REFUSAL``, raised instead when ``refuse``)."""
        if self.cfg.embed_frontend_stub and refuse:
            raise ValueError(STUB_ENGINE_REFUSAL)
        return not self.cfg.embed_frontend_stub

    def submit(self, req: Request):
        self._takes_requests(refuse=True)
        if self.prefill_chunk is None:
            if len(req.prompt) not in self.prompt_buckets:
                raise ValueError(f"prompt length {len(req.prompt)} not in "
                                 f"buckets {self.prompt_buckets}; pad upstream")
        elif not 1 <= len(req.prompt) < self.capacity:
            raise ValueError(f"prompt length {len(req.prompt)} must be in "
                             f"[1, capacity={self.capacity})")
        if req.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {req.max_new} (every "
                             f"admitted request emits at least the prefill token)")
        samplib.SamplingParams(temperature=req.temperature, top_p=req.top_p,
                               seed=req.seed).validate()
        self._queue.append(req)

    def _set_sampling(self, req: Request, slot: int):
        """Install the request's sampling lanes in slot ``slot``: its base
        key depends on (seed, uid) alone, never on the slot. The lanes reach
        the card by the steps' input copies; the generation index is reset
        on the card."""
        self._samp_base[slot] = samplib.request_key(req.seed, req.uid).numpy()
        self._samp_temp[slot] = req.temperature
        self._samp_topp[slot] = req.top_p
        self._graphs.set(base=self._samp_base, temp=self._samp_temp,
                         topp=self._samp_topp)
        self._gen[slot].fill_(0)
        if self.spec_tokens is not None and self.draft.needs_host_tokens:
            self._spec_history[slot] = [int(t) for t in np.asarray(req.prompt)]

    def _first_token(self, slot: int, logits_row) -> torch.Tensor:
        """The request's first token (generation index 0), sampled from its
        prefill logits row with the slot's lanes and written into the slot's
        lane of the token feed; the slot's generation index becomes 1."""
        base, temp, topp = (x[slot:slot + 1] for x in self._lanes)
        gen0 = torch.zeros(1, dtype=torch.int32, device=self.device)
        first = samplib.sample_tokens(logits_row[None], base, gen0, temp, topp)[0]
        self._tok[slot].copy_(first)
        self._gen[slot].fill_(1)
        self.stats.dispatches += 1
        if self.spec_tokens is not None:
            self._spec_emitted[slot] = 1
            if self.draft.needs_host_tokens:
                # the host history needs the token: a read, as in the JAX engine
                self._spec_history[slot].append(int(first))
        return first

    def _new_completion(self, req: Request, slot: int) -> Completion:
        comp = Completion(uid=req.uid, prompt_len=len(req.prompt), tokens=[],
                          admitted_step=self.stats.decode_steps,
                          admitted_engine_step=self.stats.engine_steps)
        comp._slot = slot
        comp._seq = self._admit_seq
        self._admit_seq += 1
        self._live[slot] = comp
        self.stats.admissions += 1
        return comp

    def _admit_one(self, req: Request, slot: int):
        """Packed admission: batch-1 prefill written into the slot, whose
        first token is emitted now; the slot enters READY."""
        prompt = self._to_dev(np.asarray(req.prompt, np.int64)[None])
        self._set_sampling(req, slot)
        logits, small = self._prefill(self.params, prompt)
        self._pack(small, slot)
        self.stats.dispatches += 2  # prefill + pack
        first = self._first_token(slot, logits[0])
        if self._tier is not None:
            self._tier.reset_slot(slot)  # the pack rewrote every row
        b = self.batch
        b.ready[slot] = True
        b.lengths[slot] = len(req.prompt)
        b.phase[slot] = 0
        b.uid[slot] = req.uid
        comp = self._new_completion(req, slot)
        comp._first_tok = first
        # its device work completes with the next step's
        comp.first_token_step = self.stats.engine_steps + 1
        self.stats.tokens_out += 1
        b.remaining[slot] = req.max_new - 1
        if b.remaining[slot] <= 0 or b.lengths[slot] >= self.capacity:
            self._retire(slot)

    def _admit_one_chunked(self, req: Request, slot: int):
        """Chunked admission: the slot's rows are reset and it enters
        PREFILLING; later steps feed its prompt chunk by chunk."""
        b = self.batch
        self._set_sampling(req, slot)
        self._reset(slot)
        self.stats.dispatches += 1
        if self._tier is not None:
            self._tier.reset_slot(slot)  # the reset cleared every row
        b.prefilling[slot] = True
        b.lengths[slot] = 0
        b.phase[slot] = 0
        b.uid[slot] = req.uid
        b.remaining[slot] = req.max_new
        b.prompt_left[slot] = len(req.prompt)
        self._prompts[slot] = np.asarray(req.prompt, np.int32)
        self._new_completion(req, slot)

    def _finish_prefill(self, slot: int, chunk_logits):
        """The last chunk of the slot's prompt just ran: emit its first token
        and move it to READY."""
        b = self.batch
        b.prefilling[slot] = False
        first = self._first_token(slot, chunk_logits[slot])
        b.ready[slot] = True
        b.phase[slot] = 0
        comp = self._live[slot]
        comp._first_tok = first
        comp.first_token_step = self.stats.engine_steps
        self._prompts.pop(slot, None)
        self.stats.tokens_out += 1
        b.remaining[slot] -= 1
        if b.remaining[slot] <= 0 or b.lengths[slot] >= self.capacity:
            self._retire(slot)

    def _finish_prefill_fused(self, slot: int, trace_blk, j: int,
                              engine_step: int):
        """Iteration ``j`` of a fused window fed the slot's last prompt
        tokens and took its first token from the chunk logits, in the
        window; the decode half never writes a non-active lane, so trace
        row ``j`` still holds it. The host side of ``_finish_prefill``."""
        b = self.batch
        b.prefilling[slot] = False
        b.ready[slot] = True
        b.phase[slot] = 0
        comp = self._live[slot]
        comp._first_tok = trace_blk[j, slot]
        comp.first_token_step = engine_step
        self._prompts.pop(slot, None)
        self.stats.tokens_out += 1
        b.remaining[slot] -= 1
        if b.remaining[slot] <= 0 or b.lengths[slot] >= self.capacity:
            self._retire(slot)

    def _retire(self, slot: int):
        b = self.batch
        b.active[slot] = False
        b.ready[slot] = False
        b.uid[slot] = -1
        b.remaining[slot] = 0
        if self._tier is not None:
            self._tier.reset_slot(slot)  # the next occupant rewrites the rows
        if self.spec_tokens is not None:
            self._spec_history.pop(slot, None)
        comp = self._live.pop(slot)
        comp.finished_step = self.stats.decode_steps
        self.completions[comp.uid] = comp
        if self.rebalance == "retire":
            # plan at the END of this step: a retirement can come mid-step,
            # with a tier refresh still to run
            self._rebalance_due = True

    def _pick_request(self) -> Request:
        """The next request to admit: FIFO, or under balanced admission the
        one of the first ``admit_lookahead`` queued whose admission leaves
        the per-stripe page loads flattest (FIFO on ties). Live slots count
        at the page span they will reach (fed + prompt still to come);
        PREFILLING slots also as (fed, left) pairs, so the score sees the
        chunk compute in flight. Under tiered residency a slot counts its
        hot set (``hot_cap``). Host mirrors only."""
        n_shards = self.balance_shards or self.plan.balance_shards
        if (self.admission != "balanced" or n_shards <= 1
                or len(self._queue) <= 1):
            return self._queue.popleft()
        b = self.batch
        live, pre_done, pre_left = [], [], []
        for i in range(b.max_batch):
            if b.prefilling[i]:
                pre_done.append(int(b.lengths[i]))
                pre_left.append(int(b.prompt_left[i]))
            elif b.active[i] or b.ready[i]:
                live.append(int(b.lengths[i]) + int(b.prompt_left[i]))
        best_i, best_s = 0, None
        for i in range(min(self.admit_lookahead, len(self._queue))):
            score = balance.admission_score(
                live, len(self._queue[i].prompt), n_shards=n_shards,
                page_size=self.cfg.h2eal.page_size, hot_cap=self.hot_pages,
                prefill_done=pre_done,
                prefill_left=pre_left, chunk_budget=self.prefill_chunk,
                spec_tokens=self.spec_tokens)
            if best_s is None or score < best_s - 1e-12:
                best_i, best_s = i, score
        if best_i == 0:
            return self._queue.popleft()
        self.stats.admission_reorders += 1
        req = self._queue[best_i]
        del self._queue[best_i]
        return req

    def _admit(self):
        admit = (self._admit_one if self.prefill_chunk is None
                 else self._admit_one_chunked)
        for slot in self.batch.free_slots():
            if not self._queue:
                break
            admit(self._pick_request(), slot)

    def _chunk_shards(self) -> int:
        """The stripe count the chunk allocator scores against (a FIFO
        split under anything but balanced admission)."""
        n = (self.balance_shards or self.plan.balance_shards
             if self.admission == "balanced" else 1)
        return max(n, 1)

    def _schedule_chunks(self):
        """This step's chunks: (tokens (B, C) int32, chunk_len (B,) int32),
        or None when no slot is prefilling."""
        plan = self._plan_window_chunks(1)
        return None if plan is None else (plan[0][0], plan[1][0])

    def _plan_window_chunks(self, n_iters: int):
        """The chunk scheduler run for ``n_iters`` steps on copies of the
        host mirrors: (tokens (L, B, C) int32, chunk_len (L, B) int32,
        finish (L, B) bool, the rows whose prompt completes), or None when
        no slot is prefilling. The allocator (``sched/balance``) is a
        function of (lengths, prompt_left) of the prefilling slots, so this
        gives the blocks the per-step loop would feed, save that no
        admission joins inside a fused window (a slot's tokens do not
        depend on when it is admitted)."""
        b = self.batch
        slots = [i for i in range(b.max_batch) if b.prefilling[i]]
        if not slots:
            return None
        slots.sort(key=lambda i: self._live[i]._seq)
        chunk = self.prefill_chunk
        lengths = {i: int(b.lengths[i]) for i in slots}
        left = {i: int(b.prompt_left[i]) for i in slots}
        tokens = np.zeros((n_iters, b.max_batch, chunk), np.int32)
        clens = np.zeros((n_iters, b.max_batch), np.int32)
        finish = np.zeros((n_iters, b.max_batch), bool)
        for j in range(n_iters):
            live = [i for i in slots if left[i] > 0]
            if not live:
                break
            alloc = balance.chunk_allocation(
                [lengths[i] for i in live], [left[i] for i in live], chunk,
                n_shards=self._chunk_shards(), page_size=self.cfg.h2eal.page_size)
            for i, n in zip(live, alloc):
                if n > 0:
                    fed = lengths[i]
                    tokens[j, i, :n] = self._prompts[i][fed:fed + n]
                    clens[j, i] = n
                    lengths[i] += n
                    left[i] -= n
                    finish[j, i] = left[i] == 0
        return tokens, clens, finish

    def _promote_ready(self):
        """READY slots start decoding only when every decoding slot sits at
        its refresh boundary (or none decodes), so all active phases share
        one residue mod the share window. A slot's own schedule depends on
        its own phase alone, so this delays its start by at most w-1 steps
        and changes none of its tokens. Under speculation verify steps move
        the phases by variable counts, so they never realign: READY slots
        start at once (their tokens are the same either way)."""
        b = self.batch
        if not b.ready.any():
            return
        act = b.active
        if (self.spec_tokens is None and act.any()
                and (b.phase[act] % self.share_window).any()):
            return
        b.active |= b.ready
        b.ready[:] = False

    def step(self):
        """One engine step: a prompt chunk for the prefilling slots and one
        ragged decode step for the decoding ones; or, with fused windows,
        strictly between two selection boundaries, every step up to the
        next boundary as one window. A slot whose prompt completes emits its
        first token and starts decoding at a later step. Reads nothing
        back from the card."""
        b = self.batch
        self._promote_ready()
        self._prev_engine_steps = self.stats.engine_steps
        if (self._fused_len and b.active.any()
                and not (b.active & (b.phase % self.share_window == 0)).any()):
            self._window_once(b.active.copy())
            if self._cost_model is not None:
                self._maybe_rebalance()
            return
        chunk_work = (self._schedule_chunks()
                      if self.prefill_chunk is not None else None)
        active = b.active.copy()
        if chunk_work is None and not active.any():
            return
        self.stats.engine_steps += 1
        if chunk_work is not None:
            toks, clens = chunk_work
            self._graphs.set(ctoks=toks, clens=clens)
            logits_c = self._graphs.run("prefill_chunk")
            self.stats.dispatches += 1
            self.stats.prefill_chunks += 1
            for slot in np.nonzero(clens)[0]:
                slot = int(slot)
                b.lengths[slot] += int(clens[slot])
                b.prompt_left[slot] -= int(clens[slot])
                if b.prompt_left[slot] == 0:
                    self._finish_prefill(slot, logits_c)
        if active.any():
            self._decode_once(active)
        if self._cost_model is not None:
            self._maybe_rebalance()

    def _add_trace(self, rows: torch.Tensor) -> int:
        """Keep a (n, B) block of sampled tokens; returns its first row."""
        row0 = self._trace_rows
        self._trace.append(rows)
        self._trace_rows += rows.shape[0]
        return row0

    def _decode_once(self, active: np.ndarray):
        """The decode half of a step, over the ``active`` mask captured
        before this step's chunk (a slot that finished prefilling in it
        starts later)."""
        if self.spec_tokens is not None:
            return self._verify_once(active)
        b = self.batch
        need = active & (b.phase % self.share_window == 0)
        self._graphs.set(act=active)
        if need.any():
            self._graphs.set(need=need)
            if self._tier is not None:
                self._tier_select(need)
            else:
                self._graphs.run("decode_select")
                self.stats.dispatches += 1
            self.stats.select_steps += 1
        else:
            self._graphs.run("decode_reuse")
            self.stats.dispatches += 1
            self.stats.reuse_steps += 1
        row = self._add_trace(self._tok[None].clone())
        self.trace_engine_steps.append(self.stats.engine_steps)
        self.stats.decode_steps += 1
        self.stats.occupancy_sum += float(active.mean())
        for slot in np.nonzero(active)[0]:
            slot = int(slot)
            b.lengths[slot] += 1
            b.phase[slot] += 1
            self._live[slot]._step_idx.append(row)
            self._live[slot]._slot_idx.append(slot)
            self.stats.tokens_out += 1
            b.remaining[slot] -= 1
            if b.remaining[slot] <= 0 or b.lengths[slot] >= self.capacity:
                self._retire(slot)
        if self._tier_plan is not None:
            # prefetch and spill for the NEXT share window, one window ahead
            # of the selection that will read the pages
            self._tier_refresh()

    def _window_once(self, active: np.ndarray):
        """One fused window: every reuse step from here to the next
        selection boundary (at most ``_fused_len``) as one dispatch, the
        sample and the budget-driven retirement inside it
        (``runtime/serve.make_fused_window_step``), and the prefilling
        slots' chunks of the stretch fed in it. The host applies the
        window's bookkeeping from the budget vector alone: a slot emits
        exactly ``budgets[i]`` tokens, so nothing is read back."""
        b = self.batch
        # reuse steps read pinned pages only (the spill candidates exclude
        # the selection, sink and local sections), so a window never misses,
        # and the selection step that opened it consumed its refresh plan
        assert self._tier_plan is None, "a tier refresh plan crossed a window"
        w = self.share_window
        residue = int(b.phase[np.nonzero(active)[0][0]] % w)
        _, budgets = window_budgets(active, b.remaining, b.lengths,
                                    capacity=self.capacity, phase_residue=residue,
                                    share_window=w, window=self._fused_len)
        plan = (self._plan_window_chunks(self._fused_len)
                if self.prefill_chunk is not None else None)
        self._graphs.set(act=active, budgets=budgets)
        if plan is None:
            out = self._graphs.run("fused_window")
        else:
            toks, clens, finish = plan
            self._graphs.set(wtoks=toks, wclens=clens, wfinish=finish)
            out = self._graphs.run("fused_window_mixed")
            self.stats.fused_mixed_windows += 1
        trace_blk = out.clone()
        self.stats.dispatches += 1
        self.stats.fused_windows += 1
        e0 = self.stats.engine_steps
        max_e = int(budgets[active].max())
        chunk_iters = int((plan[1].sum(axis=1) > 0).sum()) if plan is not None else 0
        # the window took as many logical steps as its longer half (the
        # per-step loop runs the two halves side by side)
        self.stats.engine_steps += max(max_e, chunk_iters)
        self.stats.fused_steps += max_e
        self.stats.decode_steps += max_e
        self.stats.reuse_steps += max_e
        self.stats.prefill_chunks += chunk_iters
        self.stats.fused_chunks += chunk_iters
        row0 = self._add_trace(trace_blk[:max_e])
        for j in range(max_e):
            self.trace_engine_steps.append(e0 + 1 + j)
            self.stats.occupancy_sum += float((budgets > j).sum()) / b.max_batch
        # chunk bookkeeping first (the two halves touch disjoint slots): a
        # slot whose prompt completed in the window turns READY where the
        # per-step mixed step would have turned it
        if plan is not None:
            for j in range(self._fused_len):
                for slot in np.nonzero(clens[j])[0]:
                    slot = int(slot)
                    b.lengths[slot] += int(clens[j, slot])
                    b.prompt_left[slot] -= int(clens[j, slot])
                    if finish[j, slot]:
                        self._finish_prefill_fused(slot, trace_blk, j, e0 + 1 + j)
        for slot in np.nonzero(active)[0]:
            slot = int(slot)
            emitted = int(budgets[slot])
            self._live[slot]._step_idx.extend(range(row0, row0 + emitted))
            self._live[slot]._slot_idx.extend([slot] * emitted)
            b.lengths[slot] += emitted
            # a survivor's budget is the window's useful length, so the live
            # phases stay aligned at the next boundary
            b.phase[slot] += emitted
            b.remaining[slot] -= emitted
            self.stats.tokens_out += emitted
            if b.remaining[slot] <= 0 or b.lengths[slot] >= self.capacity:
                self._retire(slot)

    def _verify_once(self, active: np.ndarray):
        """The speculative decode half of a step: draft k-1 tokens for each
        active slot, verify all k in one chunked forward (the captured
        ``verify`` step) and emit each slot's accepted prefix, at least one
        token. Only accepted prefixes are appended (attend-before-append),
        so nothing is rolled back. ``max_emit`` stops acceptance at the
        slot's next selection boundary, its budget and the capacity, so the
        selection cadence stays a function of the slot's own phase."""
        b = self.batch
        k, w = self.spec_tokens, self.share_window
        need = active & (b.phase % w == 0)
        drafted = self.draft.draft(self, active, k)
        if isinstance(drafted, np.ndarray):
            self._draft_buf.copy_(torch.from_numpy(
                np.ascontiguousarray(drafted, np.int32)), non_blocking=True)
        elif drafted is not None and drafted is not self._draft_buf:
            self._draft_buf.copy_(drafted)
        max_emit = np.ones(b.max_batch, np.int32)
        for slot in np.nonzero(active)[0]:
            r = int(b.phase[slot]) % w
            max_emit[slot] = max(1, min(k, w - r, int(b.remaining[slot]),
                                        self.capacity - int(b.lengths[slot])))
        self._graphs.set(act=active, need=need, max_emit=max_emit)
        out = self._graphs.run("verify")
        self.stats.dispatches += 1
        if need.any():
            self.stats.select_steps += 1
        else:
            self.stats.reuse_steps += 1
        # k trace rows a verify step (the targets); a slot that accepted n
        # owns the first n
        row0 = self._add_trace(out[:, :k].t().clone())
        self.trace_engine_steps.extend([self.stats.engine_steps] * k)
        self.stats.decode_steps += 1
        self.stats.spec_steps += 1
        self.stats.occupancy_sum += float(active.mean())
        # the one read from the card speculation adds: the accepted counts,
        # and the targets for a draft that keeps a host history
        host = out.cpu().numpy()
        for slot in np.nonzero(active)[0]:
            slot = int(slot)
            n = int(host[slot, k])
            self._live[slot]._step_idx.extend(range(row0, row0 + n))
            self._live[slot]._slot_idx.extend([slot] * n)
            b.lengths[slot] += n
            b.phase[slot] += n
            b.remaining[slot] -= n
            self._spec_emitted[slot] += n
            self.stats.tokens_out += n
            self.stats.spec_slot_steps += 1
            self.stats.spec_drafted += k - 1
            self.stats.spec_accepted += n
            if self.draft.needs_host_tokens:
                self._spec_history[slot].extend(int(t) for t in host[slot, :n])
            if b.remaining[slot] <= 0 or b.lengths[slot] >= self.capacity:
                self._retire(slot)

    # ------------------------------------------------------------------
    # tiered residency (core/cache.TieredPagedCache)
    # ------------------------------------------------------------------

    def _digest(self) -> torch.Tensor:
        """The select step's digest (``_selection_digest``) of the whole
        batch: under a GSPMD layout gathered from the ranks' blocks, so that
        every rank reads the same selection and takes the same decisions,
        and no rank spills a page that another rank's heads selected."""
        if self._placed is None:
            return _selection_digest(self.batch.serve)
        return _selection_digest(self.batch.serve, lambda field, t: self._placed.whole(
            self._paged_spec, "paged", field, t, lead=1))

    def _relay_far(self, src: int, dst: int, rows) -> list:
        """``TieredPagedCache.move_slot``'s relay where the batch rows are cut
        over 'data': the far rows of ``src``'s pages in this rank's page
        block, sent by the rank holding ``src`` (``collectives.owner_select``)
        and kept in pinned host memory by the rank holding ``dst``."""
        if not rows:
            return []
        place = self._place
        (b0, b1) = place.bounds[("paged", "k_pages")][0]
        (axis,) = place.cut("paged", "k_pages", 0)
        tiles = cachelib.kv_page_tensors(self.batch.serve)
        shape = (len(tiles),) + tuple(tiles[0][0, :, 0].shape)
        x = torch.stack([torch.zeros(shape, dtype=tiles[0].dtype) if r is None else r
                         for r in rows]).to(self.device)
        owner = torch.full((1,), src // (b1 - b0), dtype=torch.int64, device=self.device)
        got = coll.owner_select(x, self.mesh, axis, owner)
        if not b0 <= dst < b1:
            return [None] * len(rows)
        host = torch.empty(got.shape, dtype=got.dtype, pin_memory=self.device.type == "cuda")
        host.copy_(got)
        return list(host.unbind(0))

    def _init_tier(self):
        pages = cachelib.kv_page_tensors(self.batch.serve)
        if not pages:
            raise ValueError("hot_pages tiering requires a paged retrieval-head "
                             "cache; this config's serve state has none")
        # the whole cache's pages (a GSPMD layout's block holds a part of them)
        n_pages = -(-self.cache_capacity // self.cfg.h2eal.page_size)
        if not 1 <= self.hot_pages <= n_pages:
            raise ValueError(
                f"hot_pages={self.hot_pages} must be in [1, {n_pages}] (cache "
                f"capacity {self.cache_capacity} holds {n_pages} pages of "
                f"{self.cfg.h2eal.page_size})")
        h2 = self.cfg.h2eal
        self._tier = cachelib.TieredPagedCache(
            n_slots=self.batch.max_batch, n_pages=n_pages, hot_pages=self.hot_pages,
            page_size=h2.page_size, sink=h2.sink, local=h2.local,
            stripe_shards=self.plan.page_stripe_shards, device=self.device,
            block=None if self._place is None else tuple(
                self._place.bounds[("paged", "k_pages")][i] for i in (0, 2)))

    def _tier_digest(self, digest: torch.Tensor, need: np.ndarray):
        """The selected physical pages and the (n_pages,) importance summed
        over layers and heads, of each slot that selected: from the select
        step's digest, read once."""
        t = self._tier
        d = digest.cpu().numpy()
        k = d.shape[-1] - t.n_pages
        sel, imp = d[..., :k], np.ascontiguousarray(d[..., k:]).view(np.float32)
        sel_by, hot_by = {}, {}
        for slot in np.nonzero(need)[0]:
            slot = int(slot)
            sel_by[slot] = {int(x) for x in sel[:, slot].ravel() if 0 <= x < t.n_pages}
            hot_by[slot] = np.asarray(imp[:, slot], np.float64).reshape(
                -1, t.n_pages).sum(axis=0)
        return sel_by, hot_by

    def _tier_fill_work(self, work, *, prefetch: bool):
        """Fill every (slot, pages) entry of ``work`` from the far store in
        one batched transfer: a miss's demand fill, or a prefetch."""
        pairs = [(int(s), int(p)) for s, pg in work for p in pg]
        self._tier.fill(self.batch.serve, pairs)
        st = self.stats
        st.dispatches += 1
        st.tier_fill_batches += 1
        st.tier_batch_pages_max = max(st.tier_batch_pages_max, len(pairs))
        if prefetch:
            st.tier_prefetch += len(pairs)
        else:
            st.tier_fills += len(pairs)

    def _tier_spill_work(self, work):
        """Spill every (slot, pages) entry of ``work``: the pages spilled for
        the first time are copied to the far store in one batched gather,
        then all are zeroed on the card in one batched write."""
        pairs = [(int(s), int(p)) for s, pg in work for p in pg]
        st = self.stats
        archived = self._tier.archive(self.batch.serve, pairs)
        if archived:
            st.dispatches += 1
            st.tier_gather_batches += 1
            st.tier_archived += archived
        self._tier.spill(self.batch.serve, pairs)
        st.dispatches += 1
        st.tier_spill_batches += 1
        st.tier_batch_pages_max = max(st.tier_batch_pages_max, len(pairs))
        st.tier_spills += len(pairs)

    def _tier_select(self, need: np.ndarray):
        """The tiered select step: run it, read its digest, and if a slot
        selected a cold page, undo what the step wrote, fill the pages and
        run it again on the state the first pass read (the JAX engine
        replays on its preserved input state). One replay, as in the JAX
        engine; the refresh plan is the first pass's."""
        digest = self._graphs.run("decode_select")
        self.stats.dispatches += 1
        sel_by, hot_by = self._tier_digest(digest, need)
        miss_work = []
        for slot in np.nonzero(need)[0]:
            slot = int(slot)
            missing = self._tier.missing(slot, sel_by[slot])
            self.stats.tier_hits += len(sel_by[slot]) - len(missing)
            self.stats.tier_misses += len(missing)
            if missing:
                miss_work.append((slot, missing))
        if miss_work:
            self._graphs.run("tier_restore")
            self._tier_fill_work(miss_work, prefetch=False)
            self._graphs.run("decode_select")
            self.stats.dispatches += 1  # the restore and the replay
        self._tier_plan = (need.copy(), sel_by, hot_by)

    def _tier_refresh(self):
        """After the select step: prefetch the hottest cold pages of the
        slots that selected (one share window ahead of their next
        selection) and spill the resident ones that left the hot set, each
        direction one batched transfer over every slot."""
        need, sel_by, hot_by = self._tier_plan
        self._tier_plan = None
        b = self.batch
        fill_work, spill_work = [], []
        for slot in np.nonzero(need)[0]:
            slot = int(slot)
            if not b.active[slot]:  # retired this step
                continue
            to_fill, to_spill = self._tier.plan_refresh(
                slot, int(b.lengths[slot]), sel_by[slot], hot_by[slot])
            if to_fill:
                fill_work.append((slot, to_fill))
            if to_spill:
                spill_work.append((slot, to_spill))
        if fill_work:
            self._tier_fill_work(fill_work, prefetch=True)
        if spill_work:
            self._tier_spill_work(spill_work)

    def tier_force_spill(self, uid: int) -> int:
        """Test hook: spill EVERY complete non-sink page of ``uid``'s slot,
        the selected ones too, so that its next selection must miss. Legal
        only when that selection is the slot's next decode step (``phase %
        share_window == 0``): reuse steps read the current selection, which
        must never be cold. Returns the pages spilled."""
        if self._tier is None:
            raise ValueError("tier_force_spill requires Engine(hot_pages=N)")
        slots = [s for s, c in self._live.items() if c.uid == uid]
        if not slots:
            raise ValueError(f"uid {uid} is not live")
        slot = slots[0]
        b = self.batch
        if not b.active[slot]:
            raise ValueError(f"uid {uid} is not decoding yet")
        if b.phase[slot] % self.share_window != 0:
            raise ValueError("tier_force_spill is only legal at a selection "
                             f"boundary (slot phase {int(b.phase[slot])} % "
                             f"{self.share_window} != 0)")
        t = self._tier
        pages = [p for p in t.spill_candidates(slot, int(b.lengths[slot]), set())
                 if t.resident[slot, p]]
        if pages:
            self._tier_spill_work([(slot, pages)])
        return len(pages)

    # ------------------------------------------------------------------
    # live slot rebalancing (sched/cost.py, sched/rebalance.py)
    # ------------------------------------------------------------------

    def _slot_views(self) -> List[SlotView]:
        """The cost model's view of every occupied slot (host mirrors)."""
        b = self.batch
        views = []
        for i in range(b.max_batch):
            if b.prefilling[i]:
                phase = "prefill"
            elif b.ready[i]:
                phase = "ready"
            elif b.active[i]:
                phase = "decode"
            else:
                continue
            views.append(SlotView(slot=i, uid=int(b.uid[i]), ctx=int(b.lengths[i]),
                                  prompt_left=int(b.prompt_left[i]), phase=phase))
        return views

    def compute_loads(self) -> List[float]:
        """Per-bank next-step compute of the live slots under the cost model
        (``rebalance_banks`` contiguous blocks of slot indices), on any
        engine: the balance report reads it with rebalancing off too."""
        cm = self._cost_model or CostModel.from_config(
            self.cfg, hot_cap=self.hot_pages, spec_tokens=self.spec_tokens or 0,
            chunk_budget=self.prefill_chunk or 0)
        stripes = self.plan.page_stripe_shards
        costs = cm.slot_costs(self._slot_views(), n_shards=stripes)
        return device_compute_loads(costs, n_banks=self.rebalance_banks,
                                    max_batch=self.batch.max_batch,
                                    page_stripe_shards=stripes)

    def _maybe_rebalance(self):
        """End-of-step check, when due (a retirement this step, or the step
        crossed a multiple of the interval: a fused window moves several
        steps at once) and outside the cooldown: plan migrations and apply
        them if the plan clears the hysteresis."""
        due = self._rebalance_due
        if (self.rebalance == "interval"
                and self.stats.engine_steps // self.rebalance_interval
                > self._prev_engine_steps // self.rebalance_interval):
            due = True
        if not due:
            return
        self._rebalance_due = False
        if self.stats.engine_steps - self._last_rebalance_step < self.rebalance_cooldown:
            self.stats.rebalance_skipped += 1
            return
        views = self._slot_views()
        if len(views) < 2:
            return
        b = self.batch
        stripes = self.plan.page_stripe_shards
        costs = self._cost_model.slot_costs(views, n_shards=stripes)
        plan = plan_rebalance(costs, b.free_slots(), n_banks=self.rebalance_banks,
                              max_batch=b.max_batch, page_stripe_shards=stripes,
                              min_gain=self.rebalance_min_gain)
        st = self.stats
        st.rebalance_checks += 1
        st.imbalance_pre_sum += plan.imbalance_before
        st.imbalance_post_sum += plan.imbalance_after
        if not plan.moves:
            st.rebalance_skipped += 1
            return
        for mv in plan.moves:
            self._migrate_slot(mv.src, mv.dst)
        self._last_rebalance_step = st.engine_steps
        st.rebalances += 1

    def _migrate_slot(self, src: int, dst: int):
        """Move the occupant of slot ``src`` to the FREE slot ``dst``: one
        step copies every row of the serve state, the token feed and the
        generation index and clears ``src`` to the empty values; the host
        mirrors, the sampling lanes (static inputs, so through ``set``), the
        tier's residency and far rows and the completion follow. Keys
        belong to (seed, uid), so tokens are unchanged."""
        b = self.batch
        if src == dst or b.uid[src] == -1 or b.uid[dst] != -1:
            raise ValueError(f"cannot migrate slot {src} to slot {dst}")
        self._graphs.set(mig_src=np.array([src]), mig_dst=np.array([dst]))
        self._graphs.run("migrate")
        self.stats.dispatches += 1
        for arr, clear in ((b.active, False), (b.prefilling, False),
                           (b.ready, False), (b.lengths, 0), (b.phase, 0),
                           (b.uid, -1), (b.remaining, 0), (b.prompt_left, 0),
                           (self._samp_base, 0), (self._samp_temp, 0.0),
                           (self._samp_topp, 1.0)):
            arr[dst] = arr[src]
            arr[src] = clear
        self._graphs.set(base=self._samp_base, temp=self._samp_temp,
                         topp=self._samp_topp)
        if src in self._prompts:
            self._prompts[dst] = self._prompts.pop(src)
        if self.spec_tokens is not None:
            if src in self._spec_history:
                self._spec_history[dst] = self._spec_history.pop(src)
            self._spec_emitted[dst] = self._spec_emitted[src]
            self._spec_emitted[src] = 0
        if self._tier is not None:
            cut = self._place is not None and self._place.cut("paged", "k_pages", 0)
            self._tier.move_slot(src, dst, relay=self._relay_far if cut else None)
        comp = self._live.pop(src)
        comp._slot = dst
        self._live[dst] = comp
        self.stats.migrations += 1
        self.stats.migrated_tokens += int(b.lengths[dst])

    def finalize(self):
        """Read the tokens off the card into the completions: the only
        device-to-host read of the serving loop. Idempotent."""
        pending = [c for c in list(self.completions.values())
                   + list(self._live.values())
                   if not c.tokens and c._first_tok is not None]
        if not pending:
            return
        trace = (torch.cat(self._trace).cpu().numpy() if self._trace
                 else np.zeros((0, self.batch.max_batch), np.int32))
        firsts = torch.stack([c._first_tok for c in pending]).cpu().numpy()
        for comp, first in zip(pending, firsts):
            comp.tokens = [int(first)] + [int(trace[t, s]) for t, s in
                                          zip(comp._step_idx, comp._slot_idx)]

    def busy(self) -> bool:
        """True while requests are queued, prefilling, ready or decoding."""
        b = self.batch
        return (bool(self._queue) or bool(b.active.any())
                or bool(b.prefilling.any()) or bool(b.ready.any()))

    def poll(self) -> bool:
        """Admit whatever fits, then run one engine step. Returns True if
        the step dispatched any work."""
        before = self.stats.engine_steps
        self._admit()
        self.step()
        return self.stats.engine_steps > before

    def token_engine_steps(self, comp: Completion) -> List[int]:
        """Engine step at which each of ``comp``'s tokens after the first
        was emitted."""
        return [self.trace_engine_steps[r] for r in comp._step_idx]

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> Dict[int, Completion]:
        """Serve until nothing is queued or in flight. Returns a snapshot
        of the completions (a later run never mutates it)."""
        self._takes_requests(refuse=True)
        for r in requests or ():
            self.submit(r)
        t0 = time.perf_counter()
        while self.busy():
            self.poll()
        self.sync()
        self.stats.wall_s += time.perf_counter() - t0
        self.finalize()
        return dict(self.completions)

    def sync(self):
        """Block until the card has run every dispatched step (a latency
        harness calls this per step; the serving loop never does)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def reset_metrics(self):
        """Zero the stats, completions and trace between a warm-up and a
        measured phase; only while idle (nothing queued or in flight)."""
        if self._queue or self._live:
            raise RuntimeError("reset_metrics() requires an idle engine")
        self.finalize()
        self._trace.clear()
        self._trace_rows = 0
        self.trace_engine_steps.clear()
        self.completions = {}
        self.stats = EngineStats()
        self._prev_engine_steps = 0
        # the cooldown counts engine steps, which restart from 0
        self._last_rebalance_step = -(1 << 30)
        self._rebalance_due = False
        if self._tier is not None:
            self._tier.reset_counters()

    def context_lengths(self) -> np.ndarray:
        """Per-slot context lengths of the decoding slots."""
        return self.batch.lengths[self.batch.active].copy()

    def jit_cache_sizes(self) -> Dict[str, int]:
        """Captures of each fixed-shape step (the counterpart of the JAX
        engine's compiled entries), the draft provider's prefixed
        ``draft_``: one each on the card, made at construction, never more;
        0 where the steps run eagerly."""
        sizes = dict(self._graphs.captures)
        if self.draft is not None:
            for name, n in self.draft.jit_cache_sizes().items():
                sizes[f"draft_{name}"] = n
        return sizes

    def graph_replays(self) -> Dict[str, int]:
        """Replays of each captured step so far."""
        return dict(self._graphs.replays)
