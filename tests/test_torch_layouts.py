"""PyTorch port, the GSPMD layouts ``head``, ``coplace`` and ``interleave``
served over ``torch.distributed`` ranks, against the JAX package on the CPU.

S = 1: in this process, a gloo group of one rank (a ``FileStore`` under the
test's temporary directory, destroyed after the module), each layout's
engine, packed and chunked, greedy and one sampled request, against the
JAX engine of the same layout on its one-device mesh, token for token; and
each layout's engine with speculative decode (``spec_tokens=4``, packed and
chunked) and with tiered residency (``hot_pages=4``), the reference's own
conformance cases, and with retire-triggered rebalancing on 4 slots,
against the JAX engine of the layout with the same options: tokens,
``spec_steps``, the mean accepted length and every tier and rebalance
counter. Those JAX engines compile in three subprocesses of their own
(one a layout, ``jax_layout_runs``) while this process runs the first
cases; every JAX subprocess of the module shares one compilation cache
(``jax_cache_env``), so a program two engines compile is compiled once. Also at S = 1 (the default one-rank
mesh): the llama config with H²EAL off (full caches on every layer) and
kimi-k2's MoE with its shared expert on each layout, packed and chunked,
against the port's default engine exactly and the JAX default engine;
zamba2, xLSTM, gemma3 and qwen3-moe are held so in their own files.

S = 2 and 4: ranks spawned as processes (``tests/_torch_mesh_worker.py``,
which imports no JAX): one spawn of 4 processes runs every mesh in turn,
each as its own process group of the ranks it needs, with every case of
the mesh inside it, in the background while this process runs the S = 1
cases; the JAX default-layout engines they are held to compile meanwhile
in two subprocesses of their own (``jax_default_traces``). Meshes
(data, model): (1, 2) for ``head`` and ``coplace``, (1, 4) for
``coplace``, (2, 2) for ``interleave`` at ``max_batch`` 3 (the batch
cannot take 'data', so the tokens stripe within pages), and there the
layer steps of ``head`` and ``coplace`` at 2 slots (the batch over
'data'); (2, 1) for xLSTM. The other families: zamba2's (mamba2, mamba2,
attention) hybrid on ``head`` (2, 2) chunked and rebalanced (a slot's
recurrent rows migrate across 'data'), gemma3's local:global stack on
``coplace`` (1, 2) chunked and tiered (its global layer's pages cut, its
window layers' one kv head whole), qwen3-moe on ``interleave`` (2, 2)
packed, the llama config with H²EAL off on ``head`` (1, 2) chunked (its
full caches' kv heads cut), xLSTM on ``head`` (2, 1) chunked. The config is
``reduced(get_arch("llama3-8b"), num_heads=8, num_kv_heads=4)``, whose 2
retrieval and 2 streaming kv heads divide 'model' at 2, and plain reduced
smollm, whose single kv head of each kind does not: the reference's
``_div`` rule replicates them. The engine cases are served packed and
chunked, speculative (the n-gram draft, and the streaming draft whose
shadow is the rank's block), tiered on the llama config narrowed so that
pages spill (local 8, select budget 16: ``LLAMA_NARROW``), and rebalanced
on 4 slots: on (1, 2) the rows move within each rank's block, on (2, 2) the
batch is cut over 'data' and a migration moves a slot's row to another
rank (with tiering too, whose far rows follow it). Every rank's tokens must equal each other's and the JAX
default-layout engine's on the same workload and weights, up to a JAX
near-tie (the rule of tests/test_torch_engine.py: the co-placed layouts
reassociate the attention sum, as ``coplace_shmap`` does); every rank's
counters must equal each other's and the port's default engine's with the
same options. Each mesh also holds one layer's select, reuse, chunk,
verify and commit steps on the ranks' blocks against the port's default
body on the whole state: outputs within 2e-5, every cache field of each
block equal to its tile of the default's state (the importance within
1e-6 of its magnitude: where the pages are cut its scores are summed in
another order); so too a full-cache layer's decode and chunk steps and a
recurrent block's chunk resume and decode step (``LAYER_STEPS``).

``coplace_shmap`` over ranks, rank r of 'model' holding page stripe r
(``SHMAP_MESHES``, in the same spawn): on (1, 2) packed, chunked,
balanced, speculative (n-gram and streaming), fused windows, tiered with a
request forced cold, and zamba2 (rebalanced), gemma3 (tiered), qwen3-moe
and H²EAL off; on (1, 4) packed, chunked, speculative, tiered forced cold;
on (2, 2) packed, chunked, and rebalanced + tiered on 4 slots, a slot with
far rows moving to the other 'data' rank. Every rank's tokens and counters
equal; tokens held to the port's one-card engine over M stripes and, for
the llama configs, to the JAX coplace_shmap engine on 2 devices (one
subprocess with 2 fake devices, ``jax_shmap``: the layout's tokens do not
depend on M but for near-ties), each up to a JAX near-tie; counters to the
one-card engine's. The layout selects a masked page as -1 where the
default keeps it as fill, so its tokens are held to the default's only
where the one-card engine's equal it. One layer's steps on each rank's
striped block are held to the one-card body over M stripes.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core import layouts as tlayouts
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import graphs
from repro_torch.serving.engine import STUB_ENGINE_REFUSAL, Engine, Request
from test_torch_engine import CAP, Model
import _torch_mesh_worker as W
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

TESTS = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(TESTS, "_torch_mesh_worker.py")
GSPMD = ("head", "coplace", "interleave")
LLAMA = ("llama3-8b", (("num_heads", 8), ("num_kv_heads", 4)))
# the llama config with a small local window and select budget, so that
# tiered residency spills (tests/test_torch_tiered.py's narrowing)
LLAMA_NARROW = LLAMA + ((("local", 8), ("select_budget", 16)),)
SMOLLM = ("smollm-360m", ())
# the other families on the GSPMD layouts: the recurrent hybrid of
# tests/test_layouts.py (mamba2, mamba2, attention), xLSTM, gemma3's
# local:global stack (8 layers: 5 window layers of 64, a global one, 2
# window layers) narrowed so that its global layer's pages spill, the MoE
# family (kimi-k2's shared expert too), and the llama config with H²EAL off
ZAMBA = ("zamba2-2.7b", (("mixer_pattern", ("mamba2", "mamba2", "attention")),
                         ("num_layers", 3)))
XLSTM = ("xlstm-125m", ())
GEMMA3_NARROW = ("gemma3-1b", (("num_layers", 8),), (("local", 8), ("select_budget", 16)))
QWEN = ("qwen3-moe-235b-a22b", ())
KIMI = ("kimi-k2-1t-a32b", ())
LLAMA_OFF = LLAMA + ((("enabled", False),),)
TOL, IMP_TOL = 2e-5, 1e-6
ENGINE = dict(capacity=CAP, prompt_buckets=[16, 24])
BUCKETS = [8, 16, 24]
# each workload's prompt buckets (``_requests``)
WORKLOADS = {"mixed": [16, 24], "deep": [40], "churn": BUCKETS, "long_short": [8, 40],
             "long_short_far": [8, 40]}
# engine modes: the options of each and its workload
MODES = {
    "packed": ({}, "mixed"),
    "chunked": (dict(prefill_chunk=5), "mixed"),
    "spec": (dict(spec_tokens=4), "mixed"),
    "spec_streaming": (dict(spec_tokens=4, draft="streaming", prefill_chunk=5), "mixed"),
    "tiered": (dict(hot_pages=4), "deep"),
    "rebalanced": (dict(rebalance="retire", max_batch=4), "churn"),
    "rebalanced_chunked": (dict(rebalance="retire", max_batch=4, prefill_chunk=5), "churn"),
    "tiered_chunked": (dict(hot_pages=4, prefill_chunk=5), "deep"),
    "rebalanced_tiered": (dict(rebalance="retire", hot_pages=4, max_batch=4), "long_short"),
    "balanced": (dict(admission="balanced", prefill_chunk=5), "mixed"),
    "window": (dict(decode_window=4, prefill_chunk=5), "mixed"),
    "tiered_forced": (dict(hot_pages=4), "deep"),
    "rebalanced_tiered_far": (dict(rebalance="retire", hot_pages=4, max_batch=4),
                              "long_short_far"),
}
# the modes whose first decoding request with more than a share window to go
# is forced cold at a selection boundary once this many decode steps have run
# (``_torch_mesh_worker.serve``)
FORCE_AFTER = {"tiered_forced": 2}
# (data, model) meshes of the spawned runs and their cases: (layout, arch,
# max_batch, engine modes); every llama case also checks one layer's steps,
# the H²EAL-off one a full-cache layer's, gemma3's a window layer's, and
# the recurrent ones a recurrent block's
MESHES = {
    (1, 2): [("head", LLAMA, 2, ("packed", "chunked", "spec", "rebalanced")),
             ("coplace", LLAMA, 2, ("packed", "chunked", "spec_streaming",
                                    "rebalanced")),
             ("head", SMOLLM, 2, ("chunked",)),
             ("coplace", LLAMA_NARROW, 2, ("tiered",)),
             ("coplace", GEMMA3_NARROW, 2, ("tiered_chunked",)),
             ("head", LLAMA_OFF, 2, ("chunked",))],
    (1, 4): [("coplace", LLAMA, 2, ("packed", "chunked", "spec")),
             ("coplace", LLAMA_NARROW, 2, ("tiered",))],
    (2, 1): [("head", XLSTM, 2, ("chunked",))],
    (2, 2): [("interleave", LLAMA, 3, ("packed", "chunked", "spec_streaming",
                                        "rebalanced")),
             ("interleave", LLAMA_NARROW, 3, ("tiered",)),
             ("head", LLAMA, 2, ()), ("coplace", LLAMA, 2, ("rebalanced",)),
             ("head", LLAMA_NARROW, 2, ("rebalanced_tiered",)),
             ("head", ZAMBA, 4, ("rebalanced_chunked",)),
             ("interleave", QWEN, 3, ("packed",)),
             ("head", LLAMA_OFF, 2, ())],
}
# coplace_shmap over ranks (the module docstring's last paragraph): its
# cases on the same meshes, in the same spawn
SHMAP = "coplace_shmap"
SHMAP_MESHES = {
    (1, 2): [(SHMAP, LLAMA, 2, ("packed", "chunked", "balanced", "spec", "spec_streaming",
                                "window")),
             (SHMAP, LLAMA_NARROW, 2, ("tiered_forced",)),
             (SHMAP, ZAMBA, 4, ("rebalanced_chunked",)),
             (SHMAP, GEMMA3_NARROW, 2, ("tiered_chunked",)),
             (SHMAP, QWEN, 2, ("packed",)),
             (SHMAP, LLAMA_OFF, 2, ("chunked",))],
    (1, 4): [(SHMAP, LLAMA, 2, ("packed", "chunked", "spec")),
             (SHMAP, LLAMA_NARROW, 2, ("tiered_forced",))],
    (2, 2): [(SHMAP, LLAMA, 2, ("packed", "chunked")),
             (SHMAP, LLAMA_NARROW, 4, ("rebalanced_tiered_far",))],
}
for _mesh, _cases in SHMAP_MESHES.items():
    MESHES[_mesh] = MESHES[_mesh] + _cases
# the layer of another kind each such case checks on the rank's blocks:
# (step kind, period position)
# (step kind, period positions)
LAYER_STEPS = {LLAMA_OFF: ("full_steps", (0,)), GEMMA3_NARROW: ("full_steps", (0,)),
               ZAMBA: ("recurrent_steps", (0,)), XLSTM: ("recurrent_steps", (0, 1))}
# the S = 1 cases against the JAX engine of each layout with the same
# options: (options, workload); the mixed one with its sampled request
ONE_RANK_RUNS = {"spec_packed": (dict(spec_tokens=4), "mixed"),
                 "spec_chunked": (dict(spec_tokens=4, prefill_chunk=5), "mixed"),
                 "tiered": (dict(hot_pages=4), "mixed"),
                 "rebalanced": (dict(rebalance="retire", max_batch=4,
                                     prompt_buckets=BUCKETS), "churn")}
# the counters held equal: speculation's and every tier and rebalance counter
SPEC_STATS = ("spec_steps", "spec_slot_steps", "spec_drafted", "spec_accepted")
TIER_STATS = ("tier_hits", "tier_misses", "tier_spills", "tier_fills", "tier_prefetch",
              "tier_fill_batches", "tier_spill_batches", "tier_gather_batches",
              "tier_batch_pages_max")
REBALANCE_STATS = ("rebalance_checks", "rebalances", "rebalance_skipped", "migrations",
                   "migrated_tokens")


class Arch(Model):
    """``test_torch_engine.Model`` of a reduced config with overrides (and
    H²EAL overrides ``h2``)."""

    def __init__(self, name, overrides, h2=()):
        self.jcfg = jconfigs.reduced(jconfigs.get_arch(name), **dict(overrides))
        self.tcfg = tconfigs.reduced(tconfigs.get_arch(name), **dict(overrides))
        if h2:
            self.jcfg, self.tcfg = (dataclasses.replace(c, h2eal=dataclasses.replace(
                c.h2eal, **dict(h2))) for c in (self.jcfg, self.tcfg))
        self.jparams = JM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.numpy_params = jax.tree.map(np.asarray, self.jparams)
        self.tparams = params_from_numpy(self.tcfg, self.numpy_params, "cpu")
        self._engines = {}
        self._steps = {}

    def jax_engine_run(self, requests, *, layout="default", prefill_chunk=None, **kw):
        """(tokens, stats) of a JAX engine of ``layout`` (its default
        one-device mesh), built once per (layout, options)."""
        kw = dict(dict(max_batch=2, prefill_chunk=prefill_chunk, **ENGINE), **kw)
        key = (layout, tuple(sorted((k, str(v)) for k, v in kw.items())))
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = JEngine(self.jcfg, self.jparams, layout=layout, **kw)
        eng.reset_metrics()
        comps = eng.run([JRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                                  temperature=r.temperature, top_p=r.top_p,
                                  seed=r.seed) for r in requests])
        return {u: c.tokens for u, c in comps.items()}, _counters(eng.stats)


def _counters(stats) -> dict:
    """The counters the engines are held to, and the mean accepted length."""
    out = {f: getattr(stats, f) for f in SPEC_STATS + TIER_STATS + REBALANCE_STATS}
    out["mean_accepted_len"] = stats.mean_accepted_len
    return out


def _workload(cfg, sampled=False):
    """The mixed workload of tests/test_serving.py (5 greedy requests,
    prompts of 16 and 24, budgets 3..11), and with ``sampled`` one request
    at temperature 0.8, top-p 0.9."""
    rng = np.random.default_rng(2)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=([16, 24][i % 2],)).astype(np.int32),
                    max_new=3 + 2 * i) for i in range(5)]
    if sampled:
        reqs.append(Request(uid=5, prompt=rng.integers(0, cfg.vocab_size, size=(16,))
                            .astype(np.int32), max_new=6, temperature=0.8, top_p=0.9,
                            seed=3))
    return reqs


def _requests(cfg, workload):
    """A mode's greedy workload: "mixed" (``_workload``); "deep", 3 prompts
    of 40 tokens whose contexts reach 54, so that the narrowed config spills
    pages; "churn", tests/test_torch_rebalance.py's ragged prompts and
    budgets, so that retirements leave the slots skewed; "long_short",
    prompts of 40 tokens with 14-21 new ones among prompts of 8 with 2-5,
    whose seed has the narrowed config spill pages of a slot that a
    migration then moves to another rank; "long_short_far", the same draws
    at the seed under which ``coplace_shmap``'s migration on 4 slots moves a
    slot with far rows to the other half of the batch."""
    if workload == "mixed":
        return _workload(cfg)
    rng = np.random.default_rng({"deep": 1, "churn": 0, "long_short": 5,
                                 "long_short_far": 11}[workload])
    if workload == "deep":
        return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=(40,))
                        .astype(np.int32), max_new=6 + 4 * i) for i in range(3)]
    reqs = []
    for uid in range(10):
        if workload == "churn":
            s, g = int(rng.choice(BUCKETS)), int(rng.integers(3, 20))
        else:
            s = int(rng.choice([8, 40]))
            g = int(rng.integers(14, 22)) if s == 40 else int(rng.integers(2, 6))
        reqs.append(Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, size=(s,))
                            .astype(np.int32), max_new=g))
    return reqs


def _reference(arch, mode):
    """The JAX default-layout run a mode's tokens are held to: (arch,
    workload, its prefill mode); speculation, tiering and rebalancing emit
    the plain engine's tokens."""
    kw, workload = MODES[mode]
    return arch, workload, "chunked" if kw.get("prefill_chunk") else "packed"


def _engine_kw(mode, max_batch):
    """A mode's engine options at ``max_batch`` slots (a mode may set its own)."""
    kw, workload = MODES[mode]
    return dict(dict(max_batch=max_batch, capacity=CAP, prompt_buckets=WORKLOADS[workload]),
                **kw)


# the archs whose coplace_shmap cases are held to the JAX coplace_shmap
# engine on 2 devices (``jax_shmap_traces``); the other families' to the
# JAX default engine where the layout's select rule leaves the tokens
SHMAP_ARCHS = (LLAMA, LLAMA_NARROW)
# the families whose one-rank GSPMD engines this file holds (zamba2, xLSTM,
# gemma3 and qwen3-moe in their own files, against the JAX engines there):
# (arch, its JAX default-layout reference)
ONE_RANK_FAMILIES = {"h2eal_off": (LLAMA_OFF, (LLAMA_OFF, "mixed", "chunked")),
                     "kimi": (KIMI, (KIMI, "mixed", "packed"))}
# the JAX default-layout engines the spawned ranks and those families are
# held to
JAX_DEFAULT = sorted({_reference(arch, mode) for cases in MESHES.values()
                      for layout, arch, _, modes in cases for mode in modes
                      if layout != SHMAP or arch not in SHMAP_ARCHS}
                     | {ref for _, ref in ONE_RANK_FAMILIES.values()}, key=str)
JAX_SUBPROCESS = """
import pickle, sys
sys.path.insert(0, {tests!r})
import test_torch_layouts as L
with open(sys.argv[1], "wb") as f:
    pickle.dump(L.{func}(*sys.argv[2:]), f)
"""


# JAX_DEFAULT in two parts of whole archs (each arch's weights made once),
# each computed by a subprocess of its own: the older archs' engines, and
# the other families'
JAX_DEFAULT_PARTS = ([r for r in JAX_DEFAULT if r[0] in (LLAMA, LLAMA_NARROW, SMOLLM)],
                     [r for r in JAX_DEFAULT if r[0] not in (LLAMA, LLAMA_NARROW, SMOLLM)])


def jax_default_traces(part):
    """{(arch, workload, prefill mode): tokens} of the JAX default-layout
    engines of JAX_DEFAULT_PARTS[part]."""
    archs, out = {}, {}
    for arch, workload, mode in JAX_DEFAULT_PARTS[int(part)]:
        a = archs.get(arch) or archs.setdefault(arch, Arch(*arch))
        out[(arch, workload, mode)] = a.jax_engine_run(
            _requests(a.tcfg, workload), prompt_buckets=WORKLOADS[workload],
            **MODES[mode][0])[0]
    return out


# the JAX coplace_shmap engines on 2 devices (a (1, 2) mesh): the runs the
# coplace_shmap cases of SHMAP_ARCHS are held to
JAX_SHMAP = sorted({_reference(arch, mode) for cases in SHMAP_MESHES.values()
                    for _, arch, _, modes in cases for mode in modes
                    if arch in SHMAP_ARCHS}, key=str)


def jax_shmap_traces():
    """{(arch, workload, prefill mode): tokens} of the JAX coplace_shmap
    engines of JAX_SHMAP, on this process's devices (the layout's default
    mesh, (1, devices))."""
    assert len(jax.devices()) == 2, jax.devices()
    archs, out = {}, {}
    for arch, workload, mode in JAX_SHMAP:
        a = archs.get(arch) or archs.setdefault(arch, Arch(*arch))
        out[(arch, workload, mode)] = a.jax_engine_run(
            _requests(a.tcfg, workload), layout=SHMAP, prompt_buckets=WORKLOADS[workload],
            **MODES[mode][0])[0]
    return out


def _one_rank_requests(cfg, workload):
    return _workload(cfg, sampled=True) if workload == "mixed" else _requests(cfg, workload)


def jax_layout_runs(layout):
    """{run: (tokens, counters)} of the JAX engine of ``layout``, packed and
    chunked, and with each option set of ONE_RANK_RUNS, smollm on its
    workload."""
    a = Arch(*SMOLLM)
    runs = dict({mode: (dict(prefill_chunk=MODES[mode][0].get("prefill_chunk")), "mixed")
                 for mode in ("packed", "chunked")}, **ONE_RANK_RUNS)
    return {run: a.jax_engine_run(_one_rank_requests(a.tcfg, workload), layout=layout,
                                  **kw)
            for run, (kw, workload) in runs.items()}


def _req_dict(r):
    return dict(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                temperature=r.temperature, top_p=r.top_p, seed=r.seed)


@pytest.fixture(scope="module")
def archs():
    used = {arch for cases in MESHES.values() for _, arch, _, _ in cases}
    return {arch: Arch(*arch) for arch in sorted(used | {SMOLLM, KIMI}, key=str)}


def _job(archs, tmp):
    """Every mesh of MESHES with its engine cases and step checks."""
    meshes = {}
    for (data, model), cases in MESHES.items():
        world = data * model
        job = {"world": world, "model": model, "cases": {},
               "store": os.path.join(tmp, f"store_{data}x{model}")}
        for layout, arch, max_batch, modes in cases:
            a = archs[arch]
            for mode in modes:
                job["cases"][(layout, arch, mode)] = {
                    "kind": "engine", "arch": arch[0], "overrides": dict(arch[1]),
                    "h2": dict(arch[2]) if len(arch) > 2 else {},
                    "params": a.numpy_params, "layout": layout,
                    "engine": _engine_kw(mode, max_batch),
                    "requests": [_req_dict(r) for r in _requests(a.tcfg, MODES[mode][1])],
                    "force_after": FORCE_AFTER.get(mode)}
            if arch in LAYER_STEPS and layout != SHMAP:
                kind, positions = LAYER_STEPS[arch]
                for pos in positions:
                    job["cases"][(layout, "steps", max_batch, arch[0], pos)] = {
                        "kind": kind, "arch": arch[0], "overrides": dict(arch[1]),
                        "h2": dict(arch[2]) if len(arch) > 2 else {}, "layout": layout,
                        "pos": pos, "batch": max_batch, "capacity": CAP, "chunk": 5,
                        "seed": 7, "lengths": [40, 9, 57, 20][:max_batch],
                        "active": [True, False, True, True][:max_batch],
                        "chunk_len": [5, 3, 0, 2][:max_batch]}
            if arch == LLAMA:
                b = max_batch
                job["cases"][(layout, "steps", b)] = {
                    "kind": "steps", "arch": arch[0], "overrides": dict(arch[1]),
                    "layout": layout, "batch": b, "capacity": CAP, "chunk": 5,
                    "seed": 7, "lengths": [40, 9, 57][:b] if b == 3 else [40, 57],
                    "active": [True, False, True][:b] if b == 3 else [True, True],
                    "need": [True, True, False] if b == 3 else [True, False],
                    "chunk_len": [5, 3, 0] if b == 3 else [5, 0]}
        meshes[(data, model)] = job
    return {"ranks": max(m["world"] for m in meshes.values()), "meshes": meshes}


def _run_job(job, path):
    """Start the job's processes, wait, and return {mesh: [each rank's
    results]}."""
    with open(path, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(job["ranks"])]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"process {r} failed:\n{logs[r][-3000:]}"
    out = {}
    for r in range(job["ranks"]):
        with open(f"{path}.{r}", "rb") as f:
            for mesh, res in pickle.load(f).items():
                out.setdefault(mesh, []).append(res)
    return out


@pytest.fixture(scope="module")
def spawned(archs, tmp_path_factory):
    """Every mesh's ranks, in a background thread started before the JAX
    references are built; ``result(mesh)`` waits."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    job = _job(archs, tmp)
    results, errors = {}, []

    def run():
        try:
            results.update(_run_job(job, os.path.join(tmp, "job")))
        except BaseException as e:  # re-raised in the test that reads it
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def result(mesh):
        t.join()
        if errors:
            raise errors[0]
        return results[mesh]
    return result


def jax_cache_env(cache) -> dict:
    """The environment of a JAX subprocess whose compiled programs go to the
    compilation cache ``cache`` (a directory the module's subprocesses
    share), every program kept: an engine of another layout or mode that
    compiles the same program reads it from there."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(TESTS), "src"), os.environ.get("PYTHONPATH", "")]),
        JAX_COMPILATION_CACHE_DIR=str(cache), JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1")


def _jax_subprocess(tmp, func, *args, devices=1):
    """``func(*args)`` of this module run by a JAX subprocess of ``devices``
    CPU devices, started now, with the module's compilation cache
    (``jax_cache_env``); the returned ``result()`` waits and reads its
    pickle; ``stop()`` ends it if it still runs."""
    env = jax_cache_env(tmp.parent / "jax_cache_layouts")
    if devices > 1:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    with open(tmp / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c",
                                 JAX_SUBPROCESS.format(tests=TESTS, func=func),
                                 str(tmp / "out.pkl"), *args],
                                stdout=subprocess.DEVNULL, stderr=err, env=env)
    done = []

    def result():
        if not done:
            proc.wait(timeout=600)
            assert proc.returncode == 0, (tmp / "stderr.txt").read_text()[-4000:]
            with open(tmp / "out.pkl", "rb") as f:
                done.append(pickle.load(f))
        return done[0]

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return result, stop


@pytest.fixture(scope="module")
def jax_default(tmp_path_factory):
    """JAX_DEFAULT's engines in two subprocesses (JAX_DEFAULT_PARTS),
    started with the module's first test, so that they compile while this
    process runs the S = 1 cases; ``result()`` waits and reads them."""
    parts = [_jax_subprocess(tmp_path_factory.mktemp(f"jax_default{i}"),
                             "jax_default_traces", str(i))
             for i in range(len(JAX_DEFAULT_PARTS))]

    def result():
        out = {}
        for read, _ in parts:
            out.update(read())
        return out
    yield result
    for _, stop in parts:
        stop()


@pytest.fixture(scope="module")
def jax_shmap(tmp_path_factory):
    """``jax_shmap_traces`` in a subprocess of 2 CPU devices, started with the
    module's first test; ``result()`` waits and reads it."""
    read, stop = _jax_subprocess(tmp_path_factory.mktemp("jax_shmap"), "jax_shmap_traces",
                                 devices=2)
    yield read
    stop()


@pytest.fixture(scope="module")
def jax_layout(tmp_path_factory):
    """``jax_layout_runs`` of each GSPMD layout, one subprocess a layout,
    started with the module's first test; ``result(layout)`` waits."""
    runs = {layout: _jax_subprocess(tmp_path_factory.mktemp(f"jax_{layout}"),
                                    "jax_layout_runs", layout) for layout in GSPMD}
    yield lambda layout: runs[layout][0]()
    for _, stop in runs.values():
        stop()


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo process group of this process alone, and its (1, 1) mesh."""
    store = str(tmp_path_factory.mktemp("gloo1") / "store")
    tmesh.init_distributed("gloo", store_path=store, rank=0, world_size=1)
    try:
        yield tmesh.make_local_mesh()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# S = 1: the engines against the JAX engine of the same layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["packed", "chunked"])
@pytest.mark.parametrize("layout", GSPMD)
def test_one_rank_engine_matches_jax_layout(archs, spawned, jax_default, jax_layout,
                                            jax_shmap, one_rank, layout, mode):
    """smollm at S = 1 through each GSPMD layout's engine, the greedy
    workload and a sampled request, against the JAX engine of the layout
    (built in its layout's subprocess): token for token (a greedy token up
    to a JAX near-tie)."""
    m = archs[SMOLLM]
    assert one_rank.shape == {"data": 1, "model": 1} and one_rank.backend == "gloo"
    reqs = _workload(m.tcfg, sampled=True)
    chunk = MODES[mode][0].get("prefill_chunk")
    eng = Engine(m.tcfg, m.tparams, max_batch=2, layout=layout, mesh=one_rank,
                 prefill_chunk=chunk, device="cpu", **ENGINE)
    assert eng.plan.shard_state and eng.plan.mesh is one_rank
    got = {u: c.tokens for u, c in eng.run(reqs).items()}
    want, _ = jax_layout(layout)[mode]
    assert got[5] == want[5]
    m.assert_same({u: t for u, t in got.items() if u != 5},
                  {u: t for u, t in want.items() if u != 5}, reqs[:5])


@pytest.mark.parametrize("run", list(ONE_RANK_RUNS))
@pytest.mark.parametrize("layout", GSPMD)
def test_one_rank_features_match_jax_layout(archs, jax_layout, one_rank, layout, run):
    """smollm at S = 1 through each GSPMD layout's engine with speculative
    decode (k = 4, the n-gram draft, packed and chunked) and with tiered
    residency (4 pages), the greedy workload and a sampled request, and
    with retire-triggered rebalancing on 4 slots and a churning workload,
    against the JAX engine of the layout with the same options: tokens (a
    greedy token up to a JAX near-tie), spec_steps, the mean accepted
    length and every tier and rebalance counter equal."""
    m = archs[SMOLLM]
    kw, workload = ONE_RANK_RUNS[run]
    reqs = _one_rank_requests(m.tcfg, workload)
    eng = Engine(m.tcfg, m.tparams, layout=layout, mesh=one_rank, device="cpu",
                 **dict(dict(max_batch=2, **ENGINE), **kw))
    got = {u: c.tokens for u, c in eng.run(reqs).items()}
    want, stats = jax_layout(layout)[run]
    sampled = {r.uid for r in reqs if r.temperature > 0}
    assert all(got[u] == want[u] for u in sampled)
    m.assert_same({u: t for u, t in got.items() if u not in sampled},
                  {u: t for u, t in want.items() if u not in sampled},
                  [r for r in reqs if r.uid not in sampled])
    assert _counters(eng.stats) == stats
    s = eng.stats
    assert {"spec_packed": s.spec_steps, "spec_chunked": s.spec_steps,
            "tiered": s.tier_hits, "rebalanced": s.rebalance_checks}[run] > 0


def test_one_rank_fused_windows_and_balanced_admission(archs):
    """Fused decode windows (share window 4) and balanced admission on the
    GSPMD layouts at S = 1, without a process group (the default one-rank
    mesh): the tokens equal the port's default engine's."""
    m = archs[LLAMA]
    cfg = dataclasses.replace(m.tcfg, h2eal=dataclasses.replace(m.tcfg.h2eal,
                                                                share_window=4))
    reqs = _workload(cfg)
    kw = dict(max_batch=2, prefill_chunk=5, decode_window=4, device="cpu", **ENGINE)
    want = {u: c.tokens for u, c in Engine(cfg, m.tparams, **kw).run(reqs).items()}
    for layout in GSPMD:
        eng = Engine(cfg, m.tparams, layout=layout, admission="balanced", **kw)
        got = {u: c.tokens for u, c in eng.run(reqs).items()}
        assert eng.stats.fused_windows > 0 and got == want, layout


# ---------------------------------------------------------------------------
# S = 2 and 4: spawned ranks
# ---------------------------------------------------------------------------


def _held(stats) -> dict:
    return {f: stats[f] for f in SPEC_STATS + TIER_STATS + REBALANCE_STATS}


@pytest.mark.parametrize("mesh", list(MESHES), ids=lambda m: f"{m[0]}x{m[1]}")
def test_ranks_match_each_other_and_jax(archs, spawned, jax_default, mesh):
    """Every engine case on every rank of the mesh: the ranks' tokens and
    counters equal, the tokens equal to the JAX default-layout engine's (up
    to a JAX near-tie), the counters to the port's default engine's with the
    same options, and no step captured anew after construction. The
    rebalanced cases migrate a slot's row to another rank, the tiered ones
    spill and fill."""
    ranks = spawned(mesh)
    assert [r["mesh"][0] for r in ranks] == [mesh] * len(ranks)
    for name, case in ranks[0]["results"].items():
        if name[1] == "steps" or name[0] == SHMAP:
            continue
        layout, arch, mode = name
        for r in ranks[1:]:
            assert r["results"][name]["tokens"] == case["tokens"], name
            assert _held(r["results"][name]["stats"]) == _held(case["stats"]), name
        before, after = case["captures"]
        assert before == after
        a = archs[arch]
        reqs = _requests(a.tcfg, MODES[mode][1])
        a.assert_same(case["tokens"], jax_default()[_reference(arch, mode)], reqs)
        if mode in ("packed", "chunked"):
            continue
        max_batch = next(b for lay, ar, b, modes in MESHES[mesh]
                         if (lay, ar) == (layout, arch) and mode in modes)
        kw = _engine_kw(mode, max_batch)
        default = Engine(a.tcfg, a.tparams, device="cpu", **kw)
        default.run(reqs)
        assert _held(case["stats"]) == _held(dataclasses.asdict(default.stats)), name
        s = case["stats"]
        if "spec" in mode:
            assert s["spec_steps"] > 0, name
        if "tiered" in mode:
            assert s["tier_spills"] > 0 and s["tier_fills"] > 0, name
        if "rebalanced" in mode:
            # where the batch lies over 'data', a move to another rank,
            # which carries far rows where tiered
            rows = kw["max_batch"] // mesh[0]
            assert any(mesh[0] == 1 or src // rows != dst // rows
                       and (far > 0 or "tiered" not in mode)
                       for src, dst, far in case["moves"]), name


@pytest.mark.parametrize("mesh", list(MESHES), ids=lambda m: f"{m[0]}x{m[1]}")
def test_rank_blocks_match_the_default_body(spawned, mesh):
    """One layer's select, reuse, chunk, speculative verify and commit steps
    on every rank's blocks against the default body on the whole state:
    outputs within 2e-5 and each block equal to its tile of the default's
    state. So too a full-cache layer's decode and chunk steps (H²EAL off,
    gemma3's window layer), the kv heads and rows cut; and a recurrent
    block's chunk resume and decode step on the rank's rows: its outputs
    within 2e-5, its state rows equal bit for bit to the default body's
    stepping the rank's rows alone, and within a bound derived from f32
    rounding of the whole batch's (``_torch_mesh_worker._rows_bound``): a
    projection over the rank's rows may round otherwise than over the whole
    batch, on one CPU and not on another (one 8-core machine put a rank's
    mamba2 state 2.98e-08 from the whole batch's after a decode step). The
    pages, rings and full caches are copies of their inputs, so those hold
    exactly."""
    for r in spawned(mesh):
        for name, res in r["results"].items():
            if name[1] != "steps" or name[0] == SHMAP:
                continue
            for step in res["steps"] + [res[k] for k in ("chunk", "verify", "commit")
                                        if k in res]:
                assert step["out"] <= TOL, (name, step)
                bound = step.get("state_bound", {})
                for field, diff in step["state"].items():
                    tol = IMP_TOL if field.endswith("importance") else bound.get(field, 0.0)
                    assert diff <= tol, (name, field, diff, tol)
                for field, diff in step.get("state_rows", {}).items():
                    assert diff == 0.0, (name, field, diff)
                assert ("state_rows" in step) == (name[-2] in ("zamba2-2.7b", "xlstm-125m")
                                                  and len(name) == 5), name


def _serve(a, reqs, *, force_after=None, **kw):
    """(tokens, held counters, the request forced cold) of a port engine on
    the CPU, served as the ranks serve (``_torch_mesh_worker.serve``)."""
    eng = Engine(a.tcfg, a.tparams, device="cpu", **kw)
    comps, forced = W.serve(eng, reqs, force_after)
    return {u: c.tokens for u, c in comps.items()}, _held(dataclasses.asdict(eng.stats)), \
        forced


def _same(a, got, want, reqs, what):
    """``Model.assert_same`` naming the comparison that failed."""
    try:
        a.assert_same(got, want, reqs)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None


@pytest.mark.parametrize("mesh", list(SHMAP_MESHES), ids=lambda m: f"{m[0]}x{m[1]}")
def test_coplace_shmap_ranks_match_jax_and_one_card(archs, spawned, jax_default, jax_shmap,
                                                    mesh):
    """``coplace_shmap`` over the ranks of each mesh, rank r of 'model'
    holding page stripe r, in every engine mode of SHMAP_MESHES: the ranks'
    tokens and counters equal, no step captured anew; the tokens equal the
    port's one-card engine over as many stripes as 'model' has ranks and,
    for the llama configs, the JAX coplace_shmap engine on 2 devices, each
    up to a JAX near-tie; the other families' tokens equal the JAX default
    engine's wherever the one-card engine's equal the port's default
    engine's (the layout selects a masked page as -1, the default keeps it
    as fill: zamba2's uid 3 parts there, a logit gap of 0.049). The
    counters equal the one-card engine's. The tiered case
    forces a request cold, which misses and is filled; the rebalanced one on
    (2, 2) moves a slot with far rows to the other 'data' rank."""
    ranks = spawned(mesh)
    m = mesh[1]
    for name, case in ranks[0]["results"].items():
        if name[0] != SHMAP or name[1] == "steps":
            continue
        _, arch, mode = name
        for r in ranks[1:]:
            assert r["results"][name]["tokens"] == case["tokens"], name
            assert _held(r["results"][name]["stats"]) == _held(case["stats"]), name
            assert r["results"][name]["forced"] == case["forced"], name
        before, after = case["captures"]
        assert before == after
        a = archs[arch]
        reqs = _requests(a.tcfg, MODES[mode][1])
        kw = _engine_kw(mode, next(b for lay, ar, b, modes in SHMAP_MESHES[mesh]
                                   if ar == arch and mode in modes))
        toks, held, forced = _serve(a, reqs, layout=SHMAP, shards=m,
                                    force_after=FORCE_AFTER.get(mode), **kw)
        _same(a, case["tokens"], toks, reqs, (name, "one card"))
        assert _held(case["stats"]) == held and case["forced"] == forced, name
        if arch in SHMAP_ARCHS:
            _same(a, case["tokens"], jax_shmap()[_reference(arch, mode)], reqs,
                  (name, "JAX coplace_shmap"))
        elif toks == _serve(a, reqs, **kw)[0]:
            # where the layout's select rule leaves the default's tokens as
            # they are, the JAX default engine's too
            _same(a, case["tokens"], jax_default()[_reference(arch, mode)], reqs,
                  (name, "JAX default"))
        s = case["stats"]
        if "spec" in mode:
            assert s["spec_steps"] > 0, name
        if mode == "window":
            assert s["fused_windows"] > 0, name
        if mode == "tiered_forced":
            assert forced[1] > 0 and s["tier_misses"] == s["tier_fills"] > 0, name
        if mode == "rebalanced_tiered_far":
            rows = kw["max_batch"] // mesh[0]
            assert any(src // rows != dst // rows and far > 0
                       for src, dst, far in case["moves"]), (name, case["moves"])


@pytest.mark.parametrize("mesh", list(SHMAP_MESHES), ids=lambda m: f"{m[0]}x{m[1]}")
def test_coplace_shmap_rank_blocks_match_the_one_card_body(spawned, mesh):
    """One layer's select, reuse, chunk, speculative verify and commit steps
    of ``coplace_shmap`` on every rank's striped block against the one-card
    body over as many stripes as 'model' has ranks, on the whole state
    striped alike: outputs within 2e-5; the selection and every block field
    equal to the one-card state's tiles, the importance within 1e-6 of its
    magnitude (each rank scores its stripe's pages)."""
    seen = 0
    for r in spawned(mesh):
        for name, res in r["results"].items():
            if name[0] != SHMAP or name[1] != "steps":
                continue
            seen += 1
            for step in res["steps"] + [res[k] for k in ("chunk", "verify", "commit")]:
                assert step["out"] <= TOL, (name, step)
                for field, diff in step["state"].items():
                    tol = IMP_TOL if field.endswith("importance") else 0.0
                    assert diff <= tol, (name, field, diff)
    assert seen == mesh[0] * mesh[1]


_DEFAULT_RUNS = {}


@pytest.mark.parametrize("mode", ["packed", "chunked"])
@pytest.mark.parametrize("layout", GSPMD)
@pytest.mark.parametrize("family", list(ONE_RANK_FAMILIES))
def test_one_rank_family_matches_jax_and_default(archs, jax_default, family, layout, mode):
    """The llama config with H²EAL off (full caches on every layer) and
    kimi-k2's MoE with its shared expert at S = 1 (the default one-rank
    mesh) through each GSPMD layout's engine, packed and chunked: the
    tokens equal the port's default engine's exactly, and the JAX default
    engine's (the reference holds every layout to it on one device)."""
    arch, ref = ONE_RANK_FAMILIES[family]
    a = archs[arch]
    reqs = _workload(a.tcfg)
    kw = dict(max_batch=2, prefill_chunk=MODES[mode][0].get("prefill_chunk"), device="cpu",
              **ENGINE)
    run = lambda layout: {u: c.tokens for u, c in Engine(
        a.tcfg, a.tparams, layout=layout, **kw).run(reqs).items()}
    if (family, mode) not in _DEFAULT_RUNS:
        _DEFAULT_RUNS[(family, mode)] = run("default")
    got = run(layout)
    assert got == _DEFAULT_RUNS[(family, mode)]
    assert got == jax_default()[ref]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


# each engine feature with the family the GSPMD layouts still refuse: the
# frontend stubs, as the default layout's engine refuses their requests
REFUSED_WITH = {"spec_tokens": "internvl2-1b", "hot_pages": "musicgen-large",
                "rebalance": "internvl2-1b"}


def _error(fn):
    """The message of the ValueError ``fn()`` raises, None if it raises none."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kw,what", [
    (dict(spec_tokens=2), "spec_tokens"), (dict(hot_pages=4), "hot_pages"),
    (dict(rebalance="retire"), "rebalance"),
])
def test_gspmd_engine_refusals(archs, kw, what):
    """Speculative decode, tiered residency and rebalancing build on a GSPMD
    layout, placed on this rank; with a frontend-stub arch the engine raises
    what the default layout's engine raises for the option, or else the
    default's refusal of the stub's requests (``STUB_ENGINE_REFUSAL``), and
    none falls back to another layout."""
    m = archs[SMOLLM]
    eng = Engine(m.tcfg, m.tparams, max_batch=2, layout="coplace", device="cpu",
                 **ENGINE, **kw)
    assert eng.layout == "coplace" and eng._placed is not None
    assert getattr(eng, what) == kw[what]
    cfg = tconfigs.reduced(tconfigs.get_arch(REFUSED_WITH[what]))
    build = lambda layout: Engine(cfg, {"final_norm": torch.zeros(cfg.d_model)},
                                  max_batch=2, layout=layout, device="cpu", **ENGINE, **kw)
    want = _error(lambda: build("default")) or STUB_ENGINE_REFUSAL
    with pytest.raises(ValueError) as got:
        build("coplace")
    assert str(got.value) == want


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-moe-235b-a22b", "zamba2-2.7b",
                                  "internvl2-1b"])
def test_gspmd_refuses_other_families(arch):
    """The frontend stubs raise the default layout's refusal of their
    requests on a GSPMD layout; gemma3's local:global stack, the MoE family
    and the recurrent hybrid build on ``head`` and serve a request as the
    default layout's engine does."""
    cfg = tconfigs.reduced(tconfigs.get_arch(arch))
    if cfg.embed_frontend_stub:
        with pytest.raises(ValueError, match="frontend-stub"):
            Engine(cfg, {"final_norm": torch.zeros(cfg.d_model)}, max_batch=2,
                   layout="head", device="cpu", **ENGINE)
        return
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    req = _workload(cfg)[:1]
    got = [Engine(cfg, params, max_batch=2, layout=layout, device="cpu", **ENGINE)
           .run(req)[0].tokens for layout in ("head", "default")]
    assert got[0] == got[1] and len(got[0]) == req[0].max_new


def test_gspmd_capture_lockstep_and_cli_refusals(archs, one_rank):
    """A gloo mesh refuses CUDA-graph capture unless eager; lockstep
    ``generate`` on a GSPMD layout without a mesh runs on the one-rank mesh
    (item 9c, ``tests/test_torch_tensor_parallel.py``), its tokens the
    default's; the CLI refuses balanced admission for ``head``, which
    shards no pages, and a ``--mesh-model`` without a GSPMD layout."""
    with pytest.raises(ValueError, match="eager=True"):
        graphs.StepGraphs("cuda", mesh=one_rank)
    assert not graphs.StepGraphs("cuda", eager=True, mesh=one_rank).capture
    m = archs[SMOLLM]
    got, want = (tlaunch.generate(m.tcfg, m.tparams, torch.zeros((1, 8), dtype=torch.long),
                                  gen=2, capacity=32, layout=layout, device="cpu")[0]
                 for layout in ("coplace", "default"))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="shard pages"):
        tlaunch.run_ragged(m.tcfg, m.tparams, [], max_batch=2, layout="head",
                           admission="balanced", device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="GSPMD"):
        tlaunch.main(["--reduced", "--mesh-model", "2", "--device", "cpu"])


def test_coplace_shmap_mesh_refusals_and_cli(archs, one_rank, capsys):
    """``coplace_shmap`` on a mesh: ``shards`` other than 1 or the size of
    'model' raises naming both; a frontend-stub arch raises the default's
    refusal of its requests; lockstep ``generate`` on a mesh (item 9c) runs,
    on the one-rank mesh equal to the one-card layout (tokens, and logits
    within 2e-5: the one-card layout merges split-KV partials); without a mesh the
    layout stays on one card. The CLI takes ``--mesh-model`` for it
    (without torchrun, the one-rank mesh)."""
    two = tmesh.Mesh(sizes=(1, 2), coords=(0, 1))
    for shards in (3, 4):
        with pytest.raises(ValueError, match=f"1 or 2, got {shards}"):
            tlayouts.get_layout(SHMAP, shards, mesh=two)
    lay = tlayouts.get_layout(SHMAP, 2, mesh=two)
    assert lay.gspmd and lay.shards == 2 and tlayouts.get_layout(SHMAP, 1, mesh=two).shards == 2
    assert not tlayouts.get_layout(SHMAP, 2).gspmd
    m = archs[SMOLLM]
    with pytest.raises(ValueError, match="1 or 1, got 2"):
        Engine(m.tcfg, m.tparams, max_batch=2, layout=SHMAP, shards=2, mesh=one_rank,
               device="cpu", **ENGINE)
    cfg = tconfigs.reduced(tconfigs.get_arch("internvl2-1b"))
    with pytest.raises(ValueError) as got:
        Engine(cfg, {"final_norm": torch.zeros(cfg.d_model)}, max_batch=2, layout=SHMAP,
               mesh=one_rank, device="cpu", **ENGINE)
    assert str(got.value) == STUB_ENGINE_REFUSAL
    got, want = (tlaunch.generate(m.tcfg, m.tparams, torch.zeros((1, 8), dtype=torch.long),
                                  gen=2, capacity=32, layout=SHMAP, mesh=mesh, device="cpu")
                 for mesh in (one_rank, None))
    # the one-card layout attends by split-KV partials: sums in another order
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1]["last_logits"], want[1]["last_logits"], atol=2e-5,
                               rtol=0)
    stats = tlaunch.main(["--arch", "llama3-8b", "--reduced", "--workload", "ragged",
                          "--requests", "3", "--max-batch", "2", "--prompt-buckets", "16,24",
                          "--prefill-chunk", "8", "--layout", SHMAP, "--mesh-model", "2",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "layout=coplace_shmap" in out and "mesh={'data': 1, 'model': 1}" in out
    assert stats["tokens_out"] > 0


def test_gspmd_cli_serves_on_one_rank(capsys):
    """The CLI serves a GSPMD layout on one rank without torchrun."""
    stats = tlaunch.main(["--arch", "llama3-8b", "--reduced", "--workload", "ragged",
                          "--requests", "3", "--max-batch", "2", "--prompt-buckets",
                          "16,24", "--prefill-chunk", "8", "--layout", "interleave",
                          "--admission", "balanced", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "layout=interleave" in out and "mesh={'data': 1, 'model': 1}" in out
    assert stats["tokens_out"] > 0
