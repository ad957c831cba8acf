"""PyTorch port, the ``coplace_shmap`` layout: page stripes, split-KV decode
and balanced admission against the JAX package (``impl="ref"``) on the CPU.

The port's stripe count S stands for the size of the JAX mesh's 'model'
axis, so each port run at S stripes is held against the JAX layout on S
devices: S=1 in subprocesses of one device (a 1x1 mesh) and S=4 in ones
with four fake host devices, three at each count (the decode steps, the
lockstep serving steps, the engines: ``REF_PARTS``), each computing its
part of the references once per module (``jax_reference``) and handing it
over as files. All start when the module does, so they compute side by
side while its other tests run. The JAX
side's own inputs come from ``_inputs``, made from numpy with fixed seeds
on both sides; a JAX engine serves the FIFO and the balanced run of one
configuration (admission is the host's pick alone).

Tolerances (EXPERIMENTS.md:250-266): partials and attention outputs 2e-5,
caches 1e-4 where a sum is reassociated, logits 2e-4, integer state
(selections, page starts) equal; greedy tokens identical except from a
step where the JAX logits hold a near-tie (top-2 gap below 1e-3), the rule
of tests/test_torch_engine.py. Near-ties are expected: the co-placed body
reassociates the attention sums (the partial casts the unnormalised p to
v's dtype and divides at the end), so on random weights a flat pair of
logits can flip against the default layout, and against JAX.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro import configs as jconfigs
from repro.configs.base import H2ealConfig as JH2
from repro.core import cache as jcache
from repro.core import hybrid_attention as jhattn
from repro.core import paging as jpaging
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.runtime import serve as jserve
from repro.runtime.compat import make_mesh
from repro.sched import balance as jbalance
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.configs.base import H2ealConfig as TH2
from repro_torch.core import cache as tcache
from repro_torch.core import hybrid_attention as thattn
from repro_torch.core import layouts as tlayouts
from repro_torch.core import paging as tpaging
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tlaunch
from repro_torch.sched import balance as tbalance
from repro_torch.serving.engine import Engine, Request
from test_torch_engine import TIE_GAP, Model
from test_torch_layouts import jax_cache_env
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
TOL = 2e-5
CACHE_TOL = 1e-4
LOGIT_TOL = 2e-4
H2 = dict(sink=2, local=16, page_size=8, select_budget=32, share_window=2)
# (capacity, select_budget) of the decode-step cases: "roomy" selects 4 of
# 8 pages; "padded" 8 of 4 pages, so at S=4 each stripe keeps 1 page and
# the selection is padded with -1 to k. Both reach the capacity boundary.
DECODE_CASES = {"roomy": (64, 32), "padded": (32, 64)}
DECODE_STEPS = 7
ENGINE_CAP, LOCKSTEP_PROMPT, LOCKSTEP_GEN = 64, 56, 8
# lockstep capacities: prompt + gen + one page rounded to whole pages of 4
# stripes, and exactly prompt + gen (the last local page is clipped)
LOCKSTEP_CAPS = {"roomy": 96, "boundary": 64}
ENGINE_MODES = {"packed": dict(), "chunked": dict(prefill_chunk=8),
                "balanced_packed": dict(admission="balanced"),
                "balanced_chunked": dict(admission="balanced", prefill_chunk=8)}
SHARDS = [1, pytest.param(4, marks=pytest.mark.slow)]


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol, rtol=0)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _specs(**h2):
    kw = dict(H2, **h2)
    return (jhattn.AttnSpec(n_q=8, n_kv=4, head_dim=16, h2=JH2(**kw)),
            thattn.AttnSpec(n_q=8, n_kv=4, head_dim=16, h2=TH2(**kw)))


def _paged_leaves(p):
    return {f: np.asarray(getattr(p, f)) for f in
            ("k_pages", "v_pages", "tau_min", "tau_max", "importance",
             "page_start", "sel_idx")}


def _same_paged(t, want: dict):
    for f in ("k_pages", "v_pages", "tau_min", "tau_max", "importance"):
        _close(getattr(t, f), want[f], CACHE_TOL)
    _eq(t.page_start, want["page_start"])
    _eq(t.sel_idx, want["sel_idx"])


# ---------------------------------------------------------------------------
# the JAX reference, on S = this process's device count
# ---------------------------------------------------------------------------


def _inputs():
    """Every input of the decode-step, lockstep and engine references."""
    rng = np.random.default_rng(14)
    inp = {}
    for case, (cap, _) in DECODE_CASES.items():
        # lockstep: 2 slots whose last step reaches the capacity
        s = cap - DECODE_STEPS
        inp[f"{case}_lockstep_kv"] = _np(rng, 2, 2, s, 4, 16)
        inp[f"{case}_lockstep_qkv"] = _np(rng, DECODE_STEPS, 2, 16, 16)
        # ragged: 3 slots built from cap - 2 tokens holding fewer; slot 1
        # retired; slot 2 runs past the capacity (its page is clamped)
        inp[f"{case}_ragged_kv"] = _np(rng, 2, 3, cap - 2, 4, 16)
        inp[f"{case}_ragged_qkv"] = _np(rng, DECODE_STEPS, 3, 16, 16)
    cfg = jconfigs.reduced(jconfigs.get_arch("smollm-360m"))
    inp["lockstep_prompts"] = rng.integers(
        0, cfg.vocab_size, (2, LOCKSTEP_PROMPT)).astype(np.int32)
    return inp


def _ragged_plan(case):
    cap = DECODE_CASES[case][0]
    length = np.asarray([cap // 2 + 1, cap // 4, cap - 4], np.int32)
    active = np.asarray([True, False, True])
    # need_select on select steps: slot 0 every other one, slot 2 always
    need = [active & np.asarray([i % 4 == 0, True, True]) for i in range(DECODE_STEPS)]
    return length, active, need


def _engine_requests(cfg):
    """The mixed workload of tests/test_serving.py: 5 requests, prompts of
    16 and 24 tokens, budgets 3, 5, ..., 11."""
    rng = np.random.default_rng(2)
    return [(i, rng.integers(0, cfg.vocab_size, size=([16, 24][i % 2],)).astype(np.int32),
             3 + 2 * i) for i in range(5)]


# the references in parts, each computed by a subprocess of its own (a part
# a subprocess, at each device count), so that they compute side by side
REF_PARTS = ("steps", "lockstep", "engines")


def jax_reference(part):
    """(arrays, meta) of the JAX references of ``part`` of this file, on a
    (1, S) mesh of this process's S devices: "steps", decode steps of
    ``decode_attention_coplace`` (lockstep and ragged); "lockstep", lockstep
    serving steps; "engines", the coplace_shmap engine in each admission
    mode, and on one device the default-layout engine with balanced
    admission over 4 balance shards."""
    shards = len(jax.devices())
    mesh = make_mesh((1, shards), ("data", "model"))
    inp = _inputs()
    arrays, meta = {}, {"shards": shards}
    if part == "steps":
        _reference_steps(mesh, shards, inp, arrays)
    cfg = jconfigs.reduced(jconfigs.get_arch("smollm-360m"))
    if part == "lockstep":
        _reference_lockstep(mesh, cfg, inp, arrays)
    if part == "engines":
        _reference_engines(shards, cfg, meta)
    return arrays, meta


def _reference_steps(mesh, shards, inp, arrays):
    for case, (cap, budget) in DECODE_CASES.items():
        jspec, _ = _specs(select_budget=budget)
        steps = [jax.jit(functools.partial(jhattn.decode_attention_coplace, jspec,
                                           do_select=sel)) for sel in (False, True)]
        for kind in ("lockstep", "ragged"):
            key = f"{case}_{kind}"
            kv = inp[f"{key}_kv"]
            paged, stream = jhattn.init_decode_state(
                jspec, jnp.asarray(kv[0]), jnp.asarray(kv[1]), kv.shape[2], cap,
                interleave_shards=shards)
            if kind == "ragged":
                length, active, need = _ragged_plan(case)
            else:
                length = kv.shape[2]
            qkv = inp[f"{key}_qkv"]
            with mesh:
                for i in range(DECODE_STEPS):
                    sel = i % 2 == 0
                    q, kn, vn = (jnp.asarray(x) for x in
                                 (qkv[i, :, :8], qkv[i, :, 8:12], qkv[i, :, 12:]))
                    kw = {}
                    if kind == "ragged":
                        kw = dict(active=jnp.asarray(active))
                        if sel:
                            kw["need_select"] = jnp.asarray(need[i])
                        ln = jnp.asarray(length)
                    else:
                        ln = jnp.int32(length + i)
                    out, paged, stream = steps[sel](q, kn, vn, paged, stream, ln, **kw)
                    arrays[f"{key}_{i}_out"] = np.asarray(out)
                    arrays[f"{key}_{i}_sel"] = np.asarray(paged.sel_idx)
                    if kind == "ragged":
                        length = np.where(active, length + 1, length).astype(np.int32)
            for f, a in _paged_leaves(paged).items():
                arrays[f"{key}_paged_{f}"] = a
            for f in ("k", "v", "pos"):
                arrays[f"{key}_stream_{f}"] = np.asarray(getattr(stream, f))


def _reference_lockstep(mesh, cfg, inp, arrays):
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    w = cfg.h2eal.share_window
    for name, cap in LOCKSTEP_CAPS.items():
        scfg = jserve.ServeConfig(capacity=cap, layout="coplace_shmap", impl="ref")
        with mesh:
            prefill = jax.jit(jserve.make_prefill(cfg, scfg))
            steps = [jax.jit(jserve.make_decode_step(cfg, scfg, do_select=s))
                     for s in (False, True)]
            logits, state = prefill(params, jnp.asarray(inp["lockstep_prompts"]))
            toks, all_logits = [], []
            for i in range(LOCKSTEP_GEN):
                tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                toks.append(np.asarray(tok))
                all_logits.append(np.asarray(logits))
                logits, state = steps[i % w == 0](params, state, tok)
        arrays[f"lockstep_{name}_tokens"] = np.stack(toks, axis=1)
        arrays[f"lockstep_{name}_logits"] = np.stack(all_logits)
        arrays[f"lockstep_{name}_last"] = np.asarray(logits)


def _reference_engines(shards, cfg, meta):
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    reqs = [JRequest(uid=u, prompt=p, max_new=m) for u, p, m in _engine_requests(cfg)]
    runs = {f"coplace_{mode}": dict(kw, layout="coplace_shmap")
            for mode, kw in ENGINE_MODES.items()}
    if shards == 1:
        runs.update({f"default4_{mode}": dict(kw, balance_shards=4)
                     for mode, kw in ENGINE_MODES.items() if "balanced" in mode})
    # one engine a compiled configuration: the admission policy is the
    # host's pick alone (``Engine.admission``, read at each admission), so a
    # FIFO run and a balanced one share their compiled steps
    engines = {}
    for name, kw in runs.items():
        kw = dict(kw)
        admission = kw.pop("admission", "fifo")
        key = tuple(sorted(kw.items()))
        eng = engines.get(key)
        if eng is None:
            eng = engines[key] = JEngine(cfg, params, max_batch=2, capacity=ENGINE_CAP,
                                         prompt_buckets=[16, 24], **kw)
        eng.reset_metrics()
        eng.admission = admission
        comps = eng.run(reqs)
        meta[name] = _engine_record(eng, comps)


def _engine_record(eng, comps):
    s = eng.stats
    return {"tokens": {str(u): list(map(int, c.tokens)) for u, c in comps.items()},
            "admitted": {str(u): c.admitted_engine_step for u, c in comps.items()},
            "first": {str(u): c.first_token_step for u, c in comps.items()},
            "stats": [s.decode_steps, s.engine_steps, s.select_steps, s.reuse_steps,
                      s.prefill_chunks, s.admission_reorders]}


SUBPROCESS = """
import json, os, sys
shards = int(sys.argv[2])
if shards > 1:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={{shards}}"
sys.path.insert(0, {tests!r})
import numpy as np
import test_torch_coplace as T
arrays, meta = T.jax_reference(sys.argv[3])
assert meta["shards"] == shards, meta["shards"]
np.savez(os.path.join(sys.argv[1], "ref.npz"), **arrays)
with open(os.path.join(sys.argv[1], "ref.json"), "w") as f:
    json.dump(meta, f)
"""


def _wants_ref(session, shards: int) -> bool:
    """Whether a selected test of this module reads the reference at
    ``shards`` devices."""
    for item in session.items:
        if item.module.__name__ != __name__:
            continue
        spec = getattr(item, "callspec", None)
        if spec is not None and spec.params.get("shards") == shards:
            return True
        if shards == 1 and "ref1" in getattr(item, "fixturenames", ()):
            return True
    return False


@pytest.fixture(scope="module", autouse=True)
def ref_runs(request, tmp_path_factory):
    """The JAX references' subprocesses, S = 1 and S = 4, one a part of
    REF_PARTS, started when the module starts (each device count only if a
    selected test reads it), so they compute while this module's other
    tests run; ``ref1`` / ``ref4`` read what they wrote."""
    env = jax_cache_env(tmp_path_factory.getbasetemp() / "jax_cache_coplace")
    runs = {}
    for shards in (1, 4):
        if not _wants_ref(request.session, shards):
            continue
        runs[shards] = []
        for part in REF_PARTS:
            out = tmp_path_factory.mktemp(f"coplace_shmap_{shards}dev_{part}")
            with open(out / "stderr.txt", "w") as err:
                proc = subprocess.Popen([sys.executable, "-c",
                                         SUBPROCESS.format(tests=TESTS), str(out),
                                         str(shards), part], stdout=subprocess.DEVNULL,
                                        stderr=err, env=env, cwd=REPO)
            runs[shards].append((proc, out))
    yield runs
    for proc, _ in (r for parts in runs.values() for r in parts):
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _read_ref(runs, shards):
    arrays, meta = {}, {}
    for proc, out in runs[shards]:
        proc.wait(timeout=600)
        assert proc.returncode == 0, (out / "stderr.txt").read_text()[-4000:]
        with open(out / "ref.json") as f:
            meta.update(json.load(f))
        arrays.update(np.load(out / "ref.npz"))
    return arrays, meta


@pytest.fixture(scope="module")
def ref1(ref_runs):
    return _read_ref(ref_runs, 1)


@pytest.fixture(scope="module")
def ref4(ref_runs):
    return _read_ref(ref_runs, 4)


@pytest.fixture(scope="module")
def smollm():
    return Model("smollm-360m")


def _ref(request, shards):
    return request.getfixturevalue(f"ref{shards}")


# ---------------------------------------------------------------------------
# the plain versions of the two kernels
# ---------------------------------------------------------------------------


def _partial_inputs(rng, b, h, g, t, d):
    q, k, v = _np(rng, b, h * g, d), _np(rng, b, h, t, d), _np(rng, b, h, t, d)
    valid = rng.random((b, h, t)) < 0.6
    valid[1, 0] = False  # a row with no valid token
    return q, k, v, valid


@pytest.mark.parametrize("group", [1, 2, 4])
def test_partial_plain_matches_jax(group):
    rng = np.random.default_rng(group)
    q, k, v, valid = _partial_inputs(rng, 2, 3, group, 37, 16)
    want = jref.paged_attention_partial_ref(*(jnp.asarray(x) for x in (q, k, v, valid)))
    got = tref.paged_attention_partial_ref(_t(q), _t(k), _t(v), _t(valid))
    for a, b_ in zip(got, want):
        assert a.dtype == torch.float32
        _close(a, b_)
    m, l, o = got
    assert bool((m[1, :group] == -1e30).all())
    assert l[1, :group].abs().max().item() == 0.0 and o[1, :group].abs().max() == 0.0


def test_merge_and_combine_plain_match_jax():
    """Stacked partials with an empty stripe of one row and a row empty on
    every stripe (combined to 0, not NaN)."""
    rng = np.random.default_rng(3)
    n, b, hq, d = 4, 2, 6, 16
    m = _np(rng, n, b, hq) * 3
    l = np.abs(_np(rng, n, b, hq)) * 20
    o = _np(rng, n, b, hq, d) * 5
    m[2, 0, 1], l[2, 0, 1], o[2, 0, 1] = -1e30, 0.0, 0.0
    m[:, 1, 4], l[:, 1, 4], o[:, 1, 4] = -1e30, 0.0, 0.0
    for axis in (0, 1):
        mj, lj, oj = (np.moveaxis(x, 0, axis) for x in (m, l, o))
        jm = jref.merge_partials_ref(*(jnp.asarray(x) for x in (mj, lj, oj)), axis=axis)
        tm = tref.merge_partials_ref(_t(mj), _t(lj), _t(oj), axis=axis)
        for a, b_ in zip(tm, jm):
            _close(a, b_, 1e-4)
        jc = jref.combine_partials_ref(*(jnp.asarray(x) for x in (mj, lj, oj)), axis=axis)
        _close(tref.combine_partials_ref(_t(mj), _t(lj), _t(oj), axis=axis), jc)
    out = ops.combine_partials(_t(m), _t(l), _t(o))
    assert out[1, 4].abs().max().item() == 0.0 and bool(torch.isfinite(out).all())


@settings(max_examples=25, deadline=None)
@given(n=st.integers(min_value=2, max_value=6), seed=st.integers(0, 10_000))
def test_merge_is_associative_and_permutation_invariant(n, seed):
    """Merging stripes in any grouping or order gives one partial; the
    identity (NEG_INF, 0, 0) drops out."""
    rng = np.random.default_rng(seed)
    q, k, v, valid = _partial_inputs(rng, 2, 2, 2, 8 * n, 8)
    parts = [tref.paged_attention_partial_ref(
        _t(q), _t(k[:, :, 8 * i:8 * i + 8]), _t(v[:, :, 8 * i:8 * i + 8]),
        _t(valid[:, :, 8 * i:8 * i + 8])) for i in range(n)]
    stack = [torch.stack(x) for x in zip(*parts)]
    whole = tref.merge_partials_ref(*stack)
    split = n // 2
    left = tref.merge_partials_ref(*(s[:split] for s in stack))
    right = tref.merge_partials_ref(*(s[split:] for s in stack))
    nested = tref.merge_partials_ref(*(torch.stack(x) for x in zip(left, right)))
    perm = torch.from_numpy(rng.permutation(n))
    shuffled = tref.merge_partials_ref(*(s[perm] for s in stack))
    ident = (torch.full_like(stack[0][:1], -1e30), torch.zeros_like(stack[1][:1]),
             torch.zeros_like(stack[2][:1]))
    padded = tref.merge_partials_ref(*(torch.cat([s, e]) for s, e in zip(stack, ident)))
    for other in (nested, shuffled, padded):
        for a, b_ in zip(other, whole):
            _close(a, b_, 1e-4)
    # and the combine of the stripes is attention over their union
    full = tref.paged_attention_ref(_t(q), _t(k), _t(v), _t(valid))
    _close(tref.combine_partials_ref(*stack), full)


def test_partial_of_stripe_slots_is_the_partial_of_each_gathered_buffer():
    """The wrapper's plain route (the kernel's contract): each stripe's
    (m, l, o) is JAX's partial over the gathered [slot pages] buffer, with
    the non-owned slots masked; stripes that own nothing give the identity."""
    rng = np.random.default_rng(11)
    s, b, h, g, c, p, n, d = 4, 2, 2, 2, 12, 8, 7, 16
    q = _np(rng, b, h * g, d)
    kp, vp = _np(rng, b, h, c, p, d), _np(rng, b, h, c, p, d)
    slots = rng.integers(0, c, (b, h, n))
    mine = slots[None] // (c // s) == np.arange(s)[:, None, None, None]
    slots_s = np.where(mine, slots[None], -1).astype(np.int32)
    slots_s[3] = -1  # a stripe that owns nothing
    valid = (rng.random((s, b, h, n, p)) < 0.7) & (slots_s >= 0)[..., None]
    valid = valid.reshape(s, b, h, n * p)
    got = ops.paged_attention_partial(_t(q), _t(kp), _t(vp), _t(slots_s), _t(valid))
    for si in range(s):
        gk, gv = jpaging.gather_pages(jnp.asarray(kp), jnp.asarray(vp),
                                      jnp.asarray(slots_s[si]))
        want = jref.paged_attention_partial_ref(jnp.asarray(q), gk, gv,
                                                jnp.asarray(valid[si]))
        for a, b_ in zip(got, want):
            _close(a[si], b_)
    assert bool((got[0][3] == -1e30).all()) and got[1][3].abs().max() == 0.0


# ---------------------------------------------------------------------------
# page stripes: slots, prefill layout, appends
# ---------------------------------------------------------------------------


def test_interleave_slot_and_coplace_attended_slots_match_jax():
    for cap, nsh in ((8, 1), (8, 4), (12, 3), (264, 8)):
        pages = np.arange(cap)
        _eq(tpaging.interleave_slot(_t(pages), cap, nsh),
            jpaging.interleave_slot(jnp.asarray(pages), cap, nsh))
        assert tpaging.interleave_slot(5, cap, nsh) == int(
            jpaging.interleave_slot(5, cap, nsh))
        phys = tpaging.interleave_slot(tpaging.logical_pages(cap, nsh, "cpu"), cap, nsh)
        _eq(phys, np.arange(cap))
    rng = np.random.default_rng(4)
    kw = dict(sink=2, local=16, page=8)
    for cap, nsh in ((8, 1), (8, 4), (12, 2)):
        sel = rng.integers(-1, cap, (3, 2, 4)).astype(np.int32)
        for ctx in (9, 40, cap * 8, np.asarray([5, cap * 8 - 3, cap * 8])):
            jc = ctx if np.isscalar(ctx) else jnp.asarray(ctx)
            tc = ctx if np.isscalar(ctx) else _t(ctx)
            want = jpaging.coplace_attended_slots(jnp.asarray(sel), jc, capacity=cap,
                                                  n_shards=nsh, **kw)
            got = tpaging.coplace_attended_slots(_t(sel), tc, capacity=cap,
                                                 n_shards=nsh, **kw)
            assert got.dtype == torch.int32
            _eq(got, want)


@pytest.mark.parametrize("s", [40, 45])  # a page multiple, and not
def test_striped_init_decode_state_matches_jax(s):
    rng = np.random.default_rng(s)
    jspec, tspec = _specs()
    k, v = _np(rng, 2, s, 4, 16), _np(rng, 2, s, 4, 16)
    perm = rng.permutation(4).astype(np.int32)
    jp, js = jhattn.init_decode_state(jspec, jnp.asarray(k), jnp.asarray(v), s, 64,
                                      jnp.asarray(perm), interleave_shards=4)
    tp, ts = thattn.init_decode_state(tspec, _t(k), _t(v), s, 64, _t(perm),
                                      interleave_shards=4)
    _same_paged(tp, _paged_leaves(jp))
    _close(ts.k, js.k)
    _eq(ts.pos, js.pos)
    with pytest.raises(ValueError, match="stripes"):
        thattn.init_decode_state(tspec, _t(k), _t(v), s, 48, interleave_shards=4)


def _jax_owner_append(jp, kn, vn, length, nsh, active=None):
    """JAX's per-shard append, looped over the shards of the page dim."""
    c_loc = jp.k_pages.shape[2] // nsh
    leaves = [jp.k_pages, jp.v_pages, jp.tau_min, jp.tau_max, jp.page_start]
    parts = []
    for i in range(nsh):
        loc = [a[:, :, i * c_loc:(i + 1) * c_loc] for a in leaves]
        parts.append(jcache.sharded_paged_append(
            *loc, jnp.asarray(kn), jnp.asarray(vn), length, page=8, shard_idx=i,
            n_shards=nsh, active=active))
    new = [jnp.concatenate(x, axis=2) for x in zip(*parts)]
    return jcache.PagedCache(k_pages=new[0], v_pages=new[1], tau_min=new[2],
                             tau_max=new[3], importance=jp.importance,
                             page_start=new[4], sel_idx=jp.sel_idx)


# jitted for the (B,) lengths: one compile of the loop over the shards,
# where eager dispatch compiles each operation (the lockstep int length
# stays eager: a static one would compile a step)
_jax_owner_append_ragged = jax.jit(_jax_owner_append, static_argnums=(4,))


@pytest.mark.parametrize("ragged", [False, True])
def test_owner_stripe_append_matches_jax(ragged):
    """The port writes each token at its page's striped slot of one tensor;
    JAX writes it on the one shard that owns the page. Ragged: a retired
    slot writes nothing, and a position past the cache is clamped to the
    last page as JAX clamps it."""
    rng = np.random.default_rng(6)
    jspec, tspec = _specs()
    s, cap, nsh = 21, 64, 4
    k = _np(rng, 3, s, 4, 16)
    jp, _ = jhattn.init_decode_state(jspec, jnp.asarray(k), jnp.asarray(k), s, cap,
                                     interleave_shards=nsh)
    tp, _ = thattn.init_decode_state(tspec, _t(k), _t(k), s, cap, interleave_shards=nsh)
    lengths = np.asarray([21, 9, cap + 3], np.int32)
    active = np.asarray([True, False, True])
    for step in range(12):
        kn, vn = _np(rng, 3, 2, 16), _np(rng, 3, 2, 16)
        if ragged:
            jp = _jax_owner_append_ragged(jp, kn, vn, jnp.asarray(lengths), nsh,
                                          jnp.asarray(active))
            tp = tcache.paged_cache_append(tp, _t(kn), _t(vn), _t(lengths), _t(active),
                                           phys_shards=nsh)
            lengths = np.where(active, lengths + 1, lengths).astype(np.int32)
        else:
            jp = _jax_owner_append(jp, kn, vn, s + step, nsh)
            tp = tcache.paged_cache_append(tp, _t(kn), _t(vn), s + step, phys_shards=nsh)
    _same_paged(tp, _paged_leaves(jp))
    if not ragged:
        with pytest.raises(ValueError, match="past the cache"):
            tcache.paged_cache_append(tp, _t(kn), _t(vn), cap, phys_shards=nsh)


@pytest.mark.parametrize("chunk", [3, 8, 29])
def test_striped_chunk_append_matches_jax(chunk):
    """Chunks that open, fill and straddle pages into striped slots, one
    slot idle, from the empty values."""
    rng = np.random.default_rng(chunk)
    b, h, c, p, d, nsh = 3, 2, 8, 8, 16, 4
    jp = jcache.PagedCache(
        k_pages=jnp.zeros((b, h, c, p, d)), v_pages=jnp.zeros((b, h, c, p, d)),
        tau_min=jnp.full((b, h, c, d), jnp.inf), tau_max=jnp.full((b, h, c, d), -jnp.inf),
        importance=jnp.zeros((b, h, c)), page_start=jnp.full((b, h, c), -1, jnp.int32),
        sel_idx=jnp.zeros((b, h, 4), jnp.int32))
    tp = tcache.make_paged_cache(b, h, c, p, d, 4, dtype=torch.float32, device="cpu")
    start = np.zeros(b, np.int32)
    active = np.asarray([True, True, False])
    for _ in range(3):
        clen = np.clip(rng.integers(1, chunk + 1, b), 0, c * p - start).astype(np.int32)
        kn, vn = _np(rng, b, chunk, h, d), _np(rng, b, chunk, h, d)
        jp = jcache.paged_cache_append_chunk(
            jp, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(start), jnp.asarray(clen),
            active=jnp.asarray(active), phys_shards=nsh)
        tp = tcache.paged_cache_append_chunk(tp, _t(kn), _t(vn), _t(start), _t(clen),
                                             active=_t(active), phys_shards=nsh)
        start = np.where(active, start + clen, start).astype(np.int32)
    _same_paged(tp, _paged_leaves(jp))


# ---------------------------------------------------------------------------
# co-placed decode steps, lockstep and ragged, at S = 1 and 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("kind", ["lockstep", "ragged"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_coplace_decode_steps_match_jax(request, shards, kind, case):
    """Select and reuse steps of ``decode_attention_coplace``: outputs of the
    live slots after every step, the selection (physical slot ids, -1
    sentinels) after every step and the caches at the end. Lockstep
    reaches the capacity, where the clipped local pages repeat the last
    page; ragged mixes need_select, a retired slot and a clamped page."""
    arrays, _ = _ref(request, shards)
    cap, budget = DECODE_CASES[case]
    _, tspec = _specs(select_budget=budget)
    inp = _inputs()
    key = f"{case}_{kind}"
    kv, qkv = inp[f"{key}_kv"], inp[f"{key}_qkv"]
    paged, stream = thattn.init_decode_state(tspec, _t(kv[0]), _t(kv[1]), kv.shape[2],
                                             cap, interleave_shards=shards)
    if kind == "ragged":
        length, active, need = _ragged_plan(case)
    else:
        length, active = kv.shape[2], np.ones(2, bool)
    for i in range(DECODE_STEPS):
        sel = i % 2 == 0
        q, kn, vn = (_t(x) for x in (qkv[i, :, :8], qkv[i, :, 8:12], qkv[i, :, 12:]))
        if kind == "ragged":
            kw = dict(active=_t(active), need_select=_t(need[i]) if sel else None)
            out, paged, stream = thattn.decode_attention_coplace(
                tspec, q, kn, vn, paged, stream, _t(length), do_select=sel,
                shards=shards, **kw)
            length = np.where(active, length + 1, length).astype(np.int32)
        else:
            out, paged, stream = thattn.decode_attention_coplace(
                tspec, q, kn, vn, paged, stream, length + i, do_select=sel,
                shards=shards)
        want = arrays[f"{key}_{i}_out"]
        for bi in np.nonzero(active)[0]:
            _close(out[bi], want[bi])
        _eq(paged.sel_idx, arrays[f"{key}_{i}_sel"])
    _same_paged(paged, {f: arrays[f"{key}_paged_{f}"] for f in
                        ("k_pages", "v_pages", "tau_min", "tau_max", "importance",
                         "page_start", "sel_idx")})
    _close(stream.k, arrays[f"{key}_stream_k"])
    _eq(stream.pos, arrays[f"{key}_stream_pos"])


# ---------------------------------------------------------------------------
# serving: lockstep generate and the engine, at S = 1 and 4
# ---------------------------------------------------------------------------


def _first_diff_is_a_tie(got, want, logits):
    """Lockstep tokens (B, n) equal, or equal up to their first difference,
    where the JAX logits of that step hold a near-tie."""
    for bi in range(want.shape[0]):
        diff = np.nonzero(got[bi] != want[bi])[0]
        if diff.size:
            top2 = np.sort(logits[diff[0], bi])[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (bi, got[bi], want[bi])
    return not (got != want).any()


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("cap", list(LOCKSTEP_CAPS))
def test_coplace_generate_matches_jax(request, smollm, shards, cap):
    arrays, _ = _ref(request, shards)
    prompts = _t(_inputs()["lockstep_prompts"])
    toks, stats = tlaunch.generate(smollm.tcfg, smollm.tparams, prompts,
                                   gen=LOCKSTEP_GEN, capacity=LOCKSTEP_CAPS[cap],
                                   layout="coplace_shmap", shards=shards,
                                   device="cpu")
    same = _first_diff_is_a_tie(toks.numpy(), arrays[f"lockstep_{cap}_tokens"],
                                arrays[f"lockstep_{cap}_logits"])
    if same:
        _close(stats["last_logits"], arrays[f"lockstep_{cap}_last"], LOGIT_TOL)


def _port_requests(cfg):
    return [Request(uid=u, prompt=p, max_new=m) for u, p, m in _engine_requests(cfg)]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_coplace_engine_matches_jax(request, smollm, shards, mode):
    """The coplace_shmap engine, packed and chunked, FIFO and balanced: the
    JAX engine's tokens, and its admission and chunk schedule (each
    request's admission and first-token engine steps, the step counts and
    the admission reorders)."""
    _, meta = _ref(request, shards)
    want = meta[f"coplace_{mode}"]
    reqs = _port_requests(smollm.tcfg)
    eng = smollm.port(capacity=ENGINE_CAP, layout="coplace_shmap", shards=shards,
                      **ENGINE_MODES[mode])
    comps = eng.run(reqs)
    smollm.assert_same({u: c.tokens for u, c in comps.items()},
                       {int(u): t for u, t in want["tokens"].items()}, reqs)
    assert {str(u): c.admitted_engine_step for u, c in comps.items()} == want["admitted"]
    assert {str(u): c.first_token_step for u, c in comps.items()} == want["first"]
    s = eng.stats
    assert [s.decode_steps, s.engine_steps, s.select_steps, s.reuse_steps,
            s.prefill_chunks, s.admission_reorders] == want["stats"]
    assert eng.cache_capacity == ENGINE_CAP


@pytest.mark.parametrize("mode", ["packed", "chunked"])
def test_one_rank_mesh_engine_matches_one_card_default_and_jax(ref1, smollm, mode):
    """coplace_shmap on a mesh of one rank (``Engine(mesh=...)``, the
    one-rank (1, 1) mesh): the rank holds every page and runs the default's
    kernels (no partials) with the layout's select, a masked selected page
    -1 as the reference's co-placed body makes it on any device count. Its
    tokens equal the one-card engine's of one stripe exactly and the JAX
    coplace_shmap engine's on one device up to a JAX near-tie (the rule of
    the S = 1 case above); its stats equal the port's default engine's,
    its step counts and admission schedule JAX's. Its tokens are not the
    default engine's: the default keeps a masked selected page as fill,
    which the local window's move makes attended at a later reuse step; on
    this workload uid 3 parts there (token 8, a logit gap of 0.048)."""
    want = ref1[1][f"coplace_{mode}"]
    reqs = _port_requests(smollm.tcfg)
    eng = smollm.port(capacity=ENGINE_CAP, layout="coplace_shmap", mesh=tmesh.Mesh(),
                      **ENGINE_MODES[mode])
    assert eng._placed is not None and eng.mesh.shape == {"data": 1, "model": 1}
    assert not eng._place.partials and eng._place.minus_one
    comps = eng.run(reqs)
    one = smollm.port(capacity=ENGINE_CAP, layout="coplace_shmap", **ENGINE_MODES[mode])
    d = smollm.port(capacity=ENGINE_CAP, **ENGINE_MODES[mode])
    d.run(reqs)
    got = {u: c.tokens for u, c in comps.items()}
    assert got == {u: c.tokens for u, c in one.run(reqs).items()}
    smollm.assert_same(got, {int(u): t for u, t in want["tokens"].items()}, reqs)
    s = eng.stats
    assert {k: v for k, v in dataclasses.asdict(s).items() if k != "wall_s"} == \
        {k: v for k, v in dataclasses.asdict(d.stats).items() if k != "wall_s"}
    assert [s.decode_steps, s.engine_steps, s.select_steps, s.reuse_steps,
            s.prefill_chunks, s.admission_reorders] == want["stats"]
    assert {str(u): c.admitted_engine_step for u, c in comps.items()} == want["admitted"]


@pytest.mark.parametrize("mode", ["balanced_packed", "balanced_chunked"])
def test_balanced_admission_matches_jax(ref1, smollm, mode):
    """Balanced admission on the default layout scored over 4 balance
    shards (no stripes needed): JAX's admission order, reorders, chunk
    grants (hence step counts and first-token steps) and tokens."""
    want = ref1[1][f"default4_{mode}"]
    reqs = _port_requests(smollm.tcfg)
    eng = smollm.port(capacity=ENGINE_CAP, balance_shards=4, **ENGINE_MODES[mode])
    comps = eng.run(reqs)
    smollm.assert_same({u: c.tokens for u, c in comps.items()},
                       {int(u): t for u, t in want["tokens"].items()}, reqs)
    assert {str(u): c.admitted_engine_step for u, c in comps.items()} == want["admitted"]
    assert {str(u): c.first_token_step for u, c in comps.items()} == want["first"]
    s = eng.stats
    assert [s.decode_steps, s.engine_steps, s.select_steps, s.reuse_steps,
            s.prefill_chunks, s.admission_reorders] == want["stats"]
    assert s.admission_reorders > 0


def test_balance_helpers_match_jax():
    """The host scoring functions on random ragged batches, 1 to 8 stripes."""
    rng = np.random.default_rng(8)
    for _ in range(200):
        nsh, page = int(rng.integers(1, 9)), int(rng.choice([4, 8, 32]))
        ctx = rng.integers(0, 300, int(rng.integers(0, 5))).tolist()
        assert tbalance.device_page_loads(ctx, n_shards=nsh, page_size=page) == \
            jbalance.device_page_loads(ctx, n_shards=nsh, page_size=page)
        assert tbalance.load_imbalance(ctx) == jbalance.load_imbalance(ctx)
        n = int(rng.integers(1, 5))
        done, left = rng.integers(0, 90, n).tolist(), rng.integers(0, 60, n).tolist()
        budget = int(rng.integers(1, 70))
        assert tbalance.chunk_allocation(done, left, budget, n_shards=nsh,
                                         page_size=page) == \
            jbalance.chunk_allocation(done, left, budget, n_shards=nsh, page_size=page)
        cand = int(rng.integers(1, 200))
        for chunk in (None, budget):
            assert tbalance.admission_score(
                ctx, cand, n_shards=nsh, page_size=page, prefill_done=done,
                prefill_left=left, chunk_budget=chunk) == jbalance.admission_score(
                ctx, cand, n_shards=nsh, page_size=page, prefill_done=done,
                prefill_left=left, chunk_budget=chunk)
    assert tbalance.slot_pages(0, 8) == 0 and tbalance.slot_pages(17, 8) == 3


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_coplace_layout_plan_and_validation():
    cfg = tconfigs.reduced(tconfigs.get_arch("llama3-8b"))
    plan = tlayouts.get_layout("coplace_shmap", 8).plan(cfg)
    p = cfg.h2eal.page_size
    assert (plan.capacity_quantum, plan.balance_shards, plan.page_stripe_shards) == (
        8 * p, 8, 8)
    assert plan.round_capacity(8 * p * 3 + 1) == 8 * p * 4
    assert tlayouts.get_layout("coplace_shmap").plan(cfg).round_capacity(61) == 64
    assert tlayouts.get_layout("default").plan(cfg).round_capacity(61) == 61
    full = tconfigs.get_arch("llama3-8b")
    assert tlayouts.get_layout("coplace_shmap", 8).plan(full).round_capacity(8256) == 8448
    with pytest.raises(ValueError, match="coplace_shmap"):
        tlayouts.get_layout("default", 4)
    with pytest.raises(ValueError, match="shards"):
        tlayouts.get_layout("coplace_shmap", 0)


def test_coplace_ragged_cli_runs_on_the_cpu(capsys):
    stats = tlaunch.main([
        "--arch", "llama3-8b", "--reduced", "--workload", "ragged", "--requests", "5",
        "--max-batch", "2", "--prompt-buckets", "16,24", "--gen-min", "2",
        "--gen-max", "6", "--prefill-chunk", "8", "--layout", "coplace_shmap",
        "--shards", "4", "--admission", "balanced", "--report-balance",
        "--device", "cpu"])
    assert stats["admissions"] == 5 and stats["decode_steps"] > 0
    assert len(stats["balance"]["page_loads"]) == 4
    out = capsys.readouterr().out
    assert "layout=coplace_shmap" in out and "per-stripe page loads" in out
    with pytest.raises(ValueError, match="balanced"):
        tlaunch.main(["--arch", "llama3-8b", "--reduced", "--workload", "ragged",
                      "--admission", "balanced", "--device", "cpu"])


def test_coplace_counts_no_launch_on_the_cpu(smollm):
    ops.reset_launches()
    smollm.port(layout="coplace_shmap", shards=4, prefill_chunk=5).run(
        _port_requests(smollm.tcfg)[:3])
    assert set(ops.LAUNCHES.values()) == {0}
