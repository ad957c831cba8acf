"""PyTorch port, fused decode windows and the engine's compiled dispatch, on
the CPU.

``Engine(decode_window=w)`` runs the reuse steps between two selection
boundaries as one dispatch (``runtime/serve.make_fused_window_step``) with
retirement on the device; on the card each fixed-shape step is a captured
CUDA graph (``runtime/graphs.py``), here every step runs eagerly on the same
static buffers. Held here:

  * ``sched/windows.window_budgets`` against the JAX package's, on random
    masks, budgets, lengths and residues, errors included;
  * the fused engine's greedy token traces, packed and chunked, with ragged
    budgets that retire slots inside a window, against the JAX per-step
    engine's (the oracle the JAX fused window is held to in
    tests/test_fused_window.py) and the port's per-step engine's, exactly;
    the reduced config pins share_window=2, so it is widened to W=4;
  * the co-placed layout over 2 page stripes, fused against per-step;
  * the dispatch counters, the validation, the state discipline the
    captured steps rely on (a step with every lane inactive leaves the
    state as it was, bit for bit; a step writes the caches in place), and
    the JAX engine's introspection surface.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.models import model as JM
from repro.sched import window_budgets as jax_window_budgets
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tlaunch
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import graphs
from repro_torch.serving.engine import Engine, Request
from repro_torch.sched.windows import window_budgets
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

CAP = 64
W = 4  # widened share window (the reduced configs pin 2)


def _widen(cfg):
    return dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal,
                                                              share_window=W))


def _workload(cfg, *, seed=2, n=4):
    """tests/test_fused_window.py's workload: bucketed prompts, ragged
    budgets 3 + 2i that straddle window boundaries."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=([16, 24][i % 2],)).astype(np.int32),
                    max_new=3 + 2 * i)
            for i in range(n)]


def _tokens(comps):
    return {u: c.tokens for u, c in comps.items()}


@pytest.fixture(scope="module")
def model():
    jcfg = _widen(jconfigs.reduced(jconfigs.get_arch("smollm-360m")))
    tcfg = _widen(tconfigs.reduced(tconfigs.get_arch("smollm-360m")))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def perstep(model):
    """(JAX per-step traces, port per-step engine) for each chunk mode."""
    jcfg, jparams, tcfg, tparams = model
    out = {}
    for chunk in (None, 8):
        reqs = _workload(tcfg)
        jeng = JEngine(jcfg, jparams, max_batch=2, capacity=CAP,
                       prompt_buckets=[16, 24], prefill_chunk=chunk)
        jtok = _tokens(jeng.run([JRequest(uid=r.uid, prompt=r.prompt,
                                          max_new=r.max_new) for r in reqs]))
        eng = _port(tparams, tcfg, prefill_chunk=chunk)
        eng.run(reqs)
        out[chunk] = (jtok, eng)
    return out


def _port(params, cfg, **kw):
    kw = dict(dict(max_batch=2, capacity=CAP, prompt_buckets=[16, 24],
                   device="cpu"), **kw)
    return Engine(cfg, params, **kw)


@settings(deadline=None, max_examples=60)
@given(b=st.integers(1, 6), seed=st.integers(0, 2**31 - 1),
       share_window=st.integers(1, 8), residue=st.integers(0, 8),
       window=st.integers(0, 8), capacity=st.integers(1, 40))
def test_window_budgets_matches_jax(b, seed, share_window, residue, window,
                                    capacity):
    rng = np.random.default_rng(seed)
    active = rng.random(b) < 0.6
    remaining = rng.integers(0, 12, b)
    lengths = rng.integers(0, capacity + 1, b)
    kw = dict(capacity=capacity, phase_residue=residue,
              share_window=share_window, window=window)
    results = []
    for fn in (window_budgets, jax_window_budgets):
        try:
            n, budgets = fn(active, remaining, lengths, **kw)
            results.append((n, budgets.dtype, budgets.tolist()))
        except ValueError as e:
            results.append(("ValueError", str(e)))
    assert results[0] == results[1]


@pytest.mark.parametrize("chunk", [None, 8], ids=["packed", "chunked"])
@pytest.mark.parametrize("dw", [W, 2 * W])
def test_fused_matches_jax_and_perstep(model, perstep, dw, chunk):
    """Fused windows (W = one window a share cadence, 2W = clamped to the
    share_window - 1 steps the cadence allows) with slots retiring inside
    windows give the JAX per-step engine's tokens and the port's per-step
    engine's, exactly, in fewer dispatches and the same decode steps."""
    _, _, tcfg, tparams = model
    jtok, base = perstep[chunk]
    eng = _port(tparams, tcfg, prefill_chunk=chunk, decode_window=dw)
    got = _tokens(eng.run(_workload(tcfg)))
    assert got == jtok
    assert got == _tokens(base.completions)
    s, s0 = eng.stats, base.stats
    assert s.fused_windows > 0 and s.fused_steps >= s.fused_windows
    assert s.reuse_steps >= s.fused_steps
    assert s.decode_steps == s0.decode_steps and s.tokens_out == s0.tokens_out
    assert s.dispatches < s0.dispatches
    assert s.steps_per_dispatch > s0.steps_per_dispatch
    assert (s.fused_mixed_windows > 0) == (chunk is not None)
    assert s0.fused_windows == 0 and s0.dispatches > 0
    want = {"decode_select": 0, "decode_reuse": 0, "fused_window": 0}
    if chunk:
        want.update(prefill_chunk=0, fused_window_mixed=0)
    assert eng.jit_cache_sizes() == want  # the CPU runs its steps eagerly


def test_fused_coplace_matches_perstep(model):
    """The co-placed layout over 2 page stripes with balanced admission:
    the fused engine gives its per-step engine's tokens."""
    _, _, tcfg, tparams = model
    kw = dict(prefill_chunk=8, layout="coplace_shmap", shards=2,
              admission="balanced")
    reqs = _workload(tcfg, n=5)
    base = _port(tparams, tcfg, **kw)
    want = _tokens(base.run(reqs))
    eng = _port(tparams, tcfg, decode_window=W, **kw)
    assert _tokens(eng.run(reqs)) == want
    assert eng.stats.fused_windows > 0
    assert eng.stats.dispatches < base.stats.dispatches


def test_decode_window_validation(model):
    _, _, tcfg, tparams = model
    with pytest.raises(ValueError, match="decode_window"):
        _port(tparams, tcfg, decode_window=0)
    eng = _port(tparams, tcfg, decode_window=1)
    eng.run(_workload(tcfg, n=2))
    assert eng.stats.fused_windows == 0
    assert "fused_window" not in eng.jit_cache_sizes()


def _state_tensors(eng):
    return [t.clone() for _, _, t in graphs.snapshot(eng.batch.serve)] + [
        eng._tok.clone()]


@pytest.mark.parametrize("layout", ["default", "coplace_shmap"])
def test_steps_with_no_lane_active_leave_the_state(model, layout):
    """What the warm-up before a capture relies on, and what an iteration
    past a window's useful length is: every step run with its inputs at
    zero (no lane active, no chunk, no budget) leaves the serve state and
    the token feed bit for bit as they were, mid-run."""
    _, _, tcfg, tparams = model
    eng = _port(tparams, tcfg, prefill_chunk=8, decode_window=W, layout=layout,
                shards=2 if layout == "coplace_shmap" else 1)
    for r in _workload(tcfg):
        eng.submit(r)
    for _ in range(6):
        eng.poll()
    before = _state_tensors(eng)
    g = eng._graphs
    zeros = {name: np.zeros(tuple(buf.shape)) for name, (buf, _) in g._inputs.items()}
    g.set(**zeros)
    for name in eng.jit_cache_sizes():
        g.run(name)
        after = _state_tensors(eng)
        assert all(torch.equal(a, b) for a, b in zip(before, after)), name


def test_commit_writes_into_the_static_buffers(model):
    """A step's rebound fields land in the buffers the state held; a
    replaced cache field (one that should have been written in place)
    raises instead of being copied whole."""
    _, _, tcfg, tparams = model
    eng = _port(tparams, tcfg)
    serve = eng.batch.serve
    length, paged = serve["length"], serve["layers"][0]["paged"]
    sel = paged.sel_idx
    before = graphs.snapshot(serve)
    paged.sel_idx = sel + 3
    new = {"length": length + 1, "layers": serve["layers"]}
    assert sorted(graphs.commit(before, new)) == ["length", "sel_idx"]
    assert paged.sel_idx is sel and serve["length"] is length
    assert (sel == 3).all() and (length == 1).all()
    before = graphs.snapshot(serve)
    paged.k_pages = paged.k_pages.clone()
    with pytest.raises(RuntimeError, match="in place"):
        graphs.commit(before, serve)


def test_metrics_surface(model):
    """reset_metrics, sync, context_lengths and jit_cache_sizes, as the JAX
    engine has them; steps_per_s and engine_steps_per_s from the wall."""
    _, _, tcfg, tparams = model
    eng = _port(tparams, tcfg, prefill_chunk=8, decode_window=W)
    reqs = _workload(tcfg)
    eng.submit(reqs[0])
    eng.poll()
    with pytest.raises(RuntimeError, match="idle"):
        eng.reset_metrics()
    while not eng.batch.active.any():
        eng.poll()
    assert eng.context_lengths().tolist() == [int(eng.batch.lengths[0])]
    sizes = eng.jit_cache_sizes()
    first = eng.run(reqs[1:])
    eng.sync()
    s = eng.stats
    assert s.steps_per_s > 0 and s.engine_steps_per_s > 0
    assert s.engine_steps_per_s >= s.steps_per_s
    assert eng.jit_cache_sizes() == sizes
    eng.reset_metrics()
    assert eng.stats == type(s)() and not eng.completions
    assert len(first[0].tokens) == reqs[0].max_new  # the snapshot stays
    again = eng.run(reqs)
    assert _tokens(again) == _tokens(first)


def test_cli_decode_window_on_the_cpu(capsys):
    stats = tlaunch.main([
        "--arch", "smollm-360m", "--reduced", "--workload", "ragged",
        "--requests", "4", "--max-batch", "2", "--prompt-buckets", "16,24",
        "--gen-min", "4", "--gen-max", "9", "--prefill-chunk", "8",
        "--decode-window", "4", "--share-window", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert stats["fused"]["fused_windows"] > 0 and stats["dispatches"] > 0
    assert "fused decode windows" in out and "graph captures" in out


def test_engine_frees_its_state_without_the_collector(model):
    """The steps reach the engine through a weak proxy: dropping the engine
    frees its serve state at once, with no reference cycle for the garbage
    collector to find (on the card, gigabytes of cache)."""
    import gc
    import weakref

    _, _, tcfg, tparams = model
    eng = _port(tparams, tcfg, prefill_chunk=8, decode_window=W)
    eng.run(_workload(tcfg, n=2))
    length = weakref.ref(eng.batch.serve["length"])
    gc.disable()
    try:
        del eng
        assert length() is None
    finally:
        gc.enable()
