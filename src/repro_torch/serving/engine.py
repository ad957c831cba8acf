"""Slot-based continuous batching (counterpart of ``repro/serving/engine.py``).

The engine serves requests with ragged prompt and generation lengths from
a fixed batch of ``max_batch`` slots:

  * ``BatchState`` holds the batched serve state (per-slot caches and a
    (B,) ``length`` tensor on the card) and numpy mirrors of what the host
    loop needs: which slots decode (``active``), which take prompt chunks
    (``prefilling``), which wait for the shared refresh boundary
    (``ready``), each slot's length, share-window phase, budget and prompt
    tokens still to feed.
  * Admission, FIFO. **Chunked** (``prefill_chunk=N``): a request enters a
    free slot at once as PREFILLING; its cache rows are reset to the empty
    values and every engine step feeds at most N prompt tokens (split
    page-granular over the prefilling slots, ``sched/balance.py``) straight
    into the slots' rows, beside the ragged decode of the other slots.
    **Prefill-then-pack** (``prefill_chunk=None``): a batch-1 prefill of
    the whole prompt is written into a free slot's rows.
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

Only the ``default`` layout, FIFO admission and greedy sampling are
ported; every other option of the JAX engine raises and names its ROADMAP
item. The engine runs on the card unless ``device`` names the CPU, where
it runs the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cache as cachelib
from repro_torch.core import layouts as layoutlib
from repro_torch.models import model as M
from repro_torch.runtime import serve as serve_rt
from repro_torch.sched import balance


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclasses.dataclass
class Request:
    """One generation request. Under packed admission the prompt length
    must be one of the engine's prompt buckets; chunked admission takes any
    length in [1, capacity). Only greedy decoding (temperature 0) is
    ported; top-p and per-request seeds come with sampling."""

    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    temperature: float = 0.0


@dataclasses.dataclass
class Completion:
    uid: int
    prompt_len: int
    tokens: List[int]             # filled by Engine.finalize()
    admitted_step: int            # EngineStats.decode_steps at admission
    finished_step: int = -1
    first_token_step: int = -1    # EngineStats.engine_steps at the first token
    admitted_engine_step: int = -1
    _first_tok: object = None     # 0-d tensor on the card until finalize()
    _slot: int = -1
    _seq: int = -1                # admission order (FIFO chunk order)
    _step_idx: List[int] = dataclasses.field(default_factory=list)  # trace rows


@dataclasses.dataclass
class EngineStats:
    decode_steps: int = 0
    select_steps: int = 0
    reuse_steps: int = 0
    engine_steps: int = 0         # steps that dispatched any work
    admissions: int = 0
    prefill_chunks: int = 0       # chunked-prefill steps
    tokens_out: int = 0
    occupancy_sum: float = 0.0    # sum over decode steps of the live-slot share
    wall_s: float = 0.0           # set by run()

    @property
    def occupancy(self) -> float:
        return self.occupancy_sum / max(self.decode_steps, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s > 0 else 0.0


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
    capacity        the most context tokens a slot may reach (cache size).
    prompt_buckets  prompt lengths packed admission takes.
    layout          serve-cache layout; only "default" is ported.
    admission       "fifo"; "balanced" is not ported.
    prefill_chunk   None: prefill-then-pack admission. N: chunked
                    admission, at most N prompt tokens per engine step.
    device          the card unless the caller names the CPU.

    The JAX engine's ``hot_pages``, ``spec_tokens``, ``rebalance`` and
    ``decode_window`` raise NotImplementedError when given.
    """

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int,
                 capacity: int, prompt_buckets: Sequence[int],
                 layout: str = "default", admission: str = "fifo",
                 prefill_chunk: Optional[int] = None, device=None,
                 hot_pages: Optional[int] = None,
                 spec_tokens: Optional[int] = None, rebalance: str = "off",
                 decode_window: Optional[int] = None):
        if hot_pages:
            raise _not_ported("tiered KV residency (hot_pages)", "Queue 1 item 8")
        if spec_tokens:
            raise _not_ported("speculative decode (spec_tokens)",
                              "Queue 1 item 6")
        if rebalance != "off":
            raise _not_ported("live slot rebalancing (rebalance)",
                              "Queue 1 item 8")
        if decode_window is not None and decode_window != 1:
            raise _not_ported("fused decode windows (decode_window)",
                              "Queue 1 item 7")
        if admission == "balanced":
            raise _not_ported("balanced admission", "Queue 1 item 9")
        if admission != "fifo":
            raise ValueError(f"unknown admission {admission!r}")
        self.layout = layoutlib.get_layout(layout).name  # raises off "default"
        self.cfg = cfg
        self.params = params
        self.device = serve_rt.resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.capacity = int(capacity)
        self.prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
        if not self.prompt_buckets or self.prompt_buckets[-1] >= self.capacity:
            raise ValueError(f"prompt buckets {self.prompt_buckets} must be "
                             f"non-empty and below capacity {self.capacity}")
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk is not None and self.prefill_chunk > self.capacity:
            raise ValueError(f"prefill_chunk {self.prefill_chunk} exceeds "
                             f"capacity {self.capacity}")
        self.share_window = max(cfg.h2eal.share_window, 1)
        scfg = serve_rt.ServeConfig(capacity=self.capacity, layout=self.layout)
        self._prefill = serve_rt.make_prefill(cfg, scfg)
        self._dec_sel = serve_rt.make_ragged_decode_step(cfg, scfg, do_select=True)
        self._dec_reuse = serve_rt.make_ragged_decode_step(cfg, scfg,
                                                           do_select=False)
        self._sample = serve_rt.make_sample_step(cfg, scfg)
        if self.prefill_chunk is not None:
            self._chunk = serve_rt.make_prefill_chunk_step(
                cfg, scfg, chunk=self.prefill_chunk)
        b = int(max_batch)
        self.batch = BatchState(
            serve=M.empty_serve_state(cfg, b, capacity=self.capacity,
                                      dtype=params["embed"].dtype,
                                      device=self.device),
            active=np.zeros(b, bool), prefilling=np.zeros(b, bool),
            ready=np.zeros(b, bool), lengths=np.zeros(b, np.int64),
            phase=np.zeros(b, np.int64), uid=np.full(b, -1, np.int64),
            remaining=np.zeros(b, np.int64), prompt_left=np.zeros(b, np.int64))
        self._tok = torch.zeros(b, dtype=torch.int32, device=self.device)
        self._act_dev = torch.zeros(b, dtype=torch.bool, device=self.device)
        self._act_mirror = np.zeros(b, bool)
        self._trace: List[torch.Tensor] = []     # one (B,) token row a decode step
        self.trace_engine_steps: List[int] = []  # engine step of each trace row
        self._prompts: Dict[int, np.ndarray] = {}
        self._admit_seq = 0
        self._queue: deque[Request] = deque()
        self._live: Dict[int, Completion] = {}       # slot -> in flight
        self.completions: Dict[int, Completion] = {}  # uid -> finished
        self.stats = EngineStats()

    # ------------------------------------------------------------------

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """A host mirror's copy on the engine's device. non_blocking: a
        blocking copy from host memory would wait for the card's queue."""
        return torch.from_numpy(np.array(a, copy=True)).to(self.device,
                                                          non_blocking=True)

    def submit(self, req: Request):
        if req.temperature > 0.0:
            raise _not_ported("sampling at temperature > 0", "Queue 1 item 6")
        if req.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {req.temperature}")
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
        self._queue.append(req)

    def _first_token(self, slot: int, logits_row) -> torch.Tensor:
        """Greedy first token of a slot from its prefill logits row, also
        written into the slot's lane of the token feed."""
        first = self._sample(logits_row[None])[0]
        tok = self._tok.clone()  # trace rows alias earlier feeds
        tok[slot] = first
        self._tok = tok
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
        logits, small = self._prefill(self.params, prompt)
        _pack_slot(self.batch.serve, small, slot)
        first = self._first_token(slot, logits[0])
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
        _reset_slot(b.serve, slot)
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

    def _retire(self, slot: int):
        b = self.batch
        b.active[slot] = False
        b.ready[slot] = False
        b.uid[slot] = -1
        b.remaining[slot] = 0
        comp = self._live.pop(slot)
        comp.finished_step = self.stats.decode_steps
        self.completions[comp.uid] = comp

    def _admit(self):
        admit = (self._admit_one if self.prefill_chunk is None
                 else self._admit_one_chunked)
        for slot in self.batch.free_slots():
            if not self._queue:
                break
            admit(self._queue.popleft(), slot)

    def _schedule_chunks(self):
        """This step's chunks: (tokens (B, C) int32, chunk_len (B,) int32),
        or None when no slot is prefilling."""
        b = self.batch
        slots = [i for i in range(b.max_batch) if b.prefilling[i]]
        if not slots:
            return None
        slots.sort(key=lambda i: self._live[i]._seq)
        alloc = balance.chunk_allocation(
            [int(b.lengths[i]) for i in slots],
            [int(b.prompt_left[i]) for i in slots], self.prefill_chunk,
            page_size=self.cfg.h2eal.page_size)
        tokens = np.zeros((b.max_batch, self.prefill_chunk), np.int32)
        clens = np.zeros((b.max_batch,), np.int32)
        for i, n in zip(slots, alloc):
            if n > 0:
                fed = int(b.lengths[i])
                tokens[i, :n] = self._prompts[i][fed:fed + n]
                clens[i] = n
        return tokens, clens

    def _promote_ready(self):
        """READY slots start decoding only when every decoding slot sits at
        its refresh boundary (or none decodes), so all active phases share
        one residue mod the share window. A slot's own schedule depends on
        its own phase alone, so this delays its start by at most w-1 steps
        and changes none of its tokens."""
        b = self.batch
        if not b.ready.any():
            return
        act = b.active
        if act.any() and (b.phase[act] % self.share_window).any():
            return
        b.active |= b.ready
        b.ready[:] = False

    def step(self):
        """One engine step: a prompt chunk for the prefilling slots and one
        ragged decode step for the decoding ones. A slot whose prompt
        completes emits its first token and starts decoding at a later
        step. Reads nothing back from the card."""
        b = self.batch
        self._promote_ready()
        chunk_work = (self._schedule_chunks()
                      if self.prefill_chunk is not None else None)
        active = b.active.copy()
        if chunk_work is None and not active.any():
            return
        self.stats.engine_steps += 1
        if chunk_work is not None:
            toks, clens = chunk_work
            logits_c, b.serve = self._chunk(
                self.params, b.serve, self._to_dev(toks), self._to_dev(clens),
                self._to_dev(clens > 0))
            self.stats.prefill_chunks += 1
            for slot in np.nonzero(clens)[0]:
                slot = int(slot)
                b.lengths[slot] += int(clens[slot])
                b.prompt_left[slot] -= int(clens[slot])
                if b.prompt_left[slot] == 0:
                    self._finish_prefill(slot, logits_c)
        if active.any():
            self._decode_once(active)

    def _decode_once(self, active: np.ndarray):
        """The decode half of a step, over the ``active`` mask captured
        before this step's chunk (a slot that finished prefilling in it
        starts later)."""
        b = self.batch
        row = len(self._trace)
        need = active & (b.phase % self.share_window == 0)
        if not np.array_equal(self._act_mirror, active):
            self._act_dev = self._to_dev(active)
            self._act_mirror = active.copy()
        if need.any():
            logits, b.serve = self._dec_sel(self.params, b.serve, self._tok,
                                            self._act_dev, self._to_dev(need))
            self.stats.select_steps += 1
        else:
            logits, b.serve = self._dec_reuse(self.params, b.serve, self._tok,
                                              self._act_dev)
            self.stats.reuse_steps += 1
        # inactive lanes keep their feed: a slot that finished prefilling
        # this step already holds its first token there
        self._tok = torch.where(self._act_dev, self._sample(logits), self._tok)
        self._trace.append(self._tok)
        self.trace_engine_steps.append(self.stats.engine_steps)
        self.stats.decode_steps += 1
        self.stats.occupancy_sum += float(active.mean())
        for slot in np.nonzero(active)[0]:
            slot = int(slot)
            b.lengths[slot] += 1
            b.phase[slot] += 1
            self._live[slot]._step_idx.append(row)
            self.stats.tokens_out += 1
            b.remaining[slot] -= 1
            if b.remaining[slot] <= 0 or b.lengths[slot] >= self.capacity:
                self._retire(slot)

    def finalize(self):
        """Read the tokens off the card into the completions: the only
        device-to-host read of the serving loop. Idempotent."""
        pending = [c for c in list(self.completions.values())
                   + list(self._live.values())
                   if not c.tokens and c._first_tok is not None]
        if not pending:
            return
        trace = (torch.stack(self._trace).cpu().numpy() if self._trace
                 else np.zeros((0, self.batch.max_batch), np.int32))
        firsts = torch.stack([c._first_tok for c in pending]).cpu().numpy()
        for comp, first in zip(pending, firsts):
            comp.tokens = [int(first)] + [int(trace[t, comp._slot])
                                          for t in comp._step_idx]

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
        for r in requests or ():
            self.submit(r)
        t0 = time.perf_counter()
        while self.busy():
            self.poll()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.wall_s += time.perf_counter() - t0
        self.finalize()
        return dict(self.completions)
