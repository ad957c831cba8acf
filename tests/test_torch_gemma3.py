"""PyTorch port, gemma3-1b's local:global stack against the JAX package
(``impl="ref"``) on the CPU, at ``reduced(get_arch("gemma3-1b"),
num_layers=8)``: one period of 5 sliding-window layers (window 64 at this
size) and a global layer, then 2 remainder window layers, one kv head (a
global layer has one retrieval head and no streaming head), head_dim 32.
Prompts run past the window, so window layers drop keys.

Weights are JAX's ``M.init_params``, bridged through numpy. Tolerances
(EXPERIMENTS.md:250-266): logits 2e-4 (f32, after the whole stack); greedy
tokens identical, engines token for token. Each JAX program is compiled
once per module (the serving steps per capacity, each engine per mode),
and the engines run with the share window widened to 4, so that the fused
decode windows are held against the JAX per-step chunked engine, which
the JAX fused engine equals (tests/test_fused_window.py) as the port's
does (tests/test_torch_window.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.runtime import serve as jserve
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine, Request
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

LOGIT_TOL = 2e-4
# one prompt bucket past the window of 64 (a JAX program a bucket)
CAP, BUCKETS = 128, [72]
PROMPT, GEN = 100, 10
ENGINE_H2 = dict(share_window=4)


def _h2(cfg, **kw):
    return dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal, **kw))


class Model:
    """gemma3-1b reduced to 8 layers on both sides, on the same weights; the
    JAX engines are built once per mode and kept."""

    def __init__(self, **overrides):
        kw = dict(num_layers=8, **overrides)
        self.jcfg = jconfigs.reduced(jconfigs.get_arch("gemma3-1b"), **kw)
        self.tcfg = tconfigs.reduced(tconfigs.get_arch("gemma3-1b"), **kw)
        self.jparams = JM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.tparams = params_from_numpy(self.tcfg, self.tree, "cpu")
        self._runs = {}
        self._steps = {}

    def jax_steps(self, cfg, capacity):
        """JAX's jitted prefill and (reuse, select) decode steps of ``cfg``."""
        key = (cfg.h2eal.enabled, capacity)
        if key not in self._steps:
            scfg = jserve.ServeConfig(capacity=capacity, impl="ref")
            self._steps[key] = (jax.jit(jserve.make_prefill(cfg, scfg)),
                                [jax.jit(jserve.make_decode_step(cfg, scfg, do_select=s))
                                 for s in (False, True)])
        return self._steps[key]

    def jax_run(self, reqs, *, h2=None, **kw):
        key = (tuple(sorted((h2 or {}).items())), tuple(sorted(kw.items())))
        if key not in self._runs:
            cfg = _h2(self.jcfg, **h2) if h2 else self.jcfg
            eng = JEngine(cfg, self.jparams, **dict(dict(
                max_batch=2, capacity=CAP, prompt_buckets=BUCKETS), **kw))
            comps = eng.run([JRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new)
                             for r in reqs])
            self._runs[key] = ({u: c.tokens for u, c in comps.items()}, eng.stats)
        return self._runs[key]

    def port(self, *, h2=None, **kw):
        cfg = _h2(self.tcfg, **h2) if h2 else self.tcfg
        return Engine(cfg, self.tparams, **dict(dict(
            max_batch=2, capacity=CAP, prompt_buckets=BUCKETS, device="cpu"), **kw))


@pytest.fixture(scope="module")
def g3():
    return Model()


def _workload(cfg, n=5):
    """Prompts of 72 tokens (past the window of 64), budgets 3, 5, ...; 5
    requests on 2 slots, so slots churn."""
    rng = np.random.default_rng(2)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=(BUCKETS[0],)
                                               ).astype(np.int32),
                    max_new=3 + 2 * i) for i in range(n)]


def _tokens(comps):
    return {u: c.tokens for u, c in comps.items()}


def _prompts(cfg, seed=7):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (2, PROMPT)).astype(np.int32)


def test_reduced_stack_is_local_global(g3):
    """8 layers: positions 0-4 window, 5 global, then 2 remainder window
    layers; window layers keep a full cache, the global one H²EAL's."""
    cfg = g3.tcfg
    assert (TT.period_len(cfg), TT.layer_layout(cfg)) == (6, (1, 2))
    spans = [TT.attn_spec(cfg, i % 6) for i in range(8)]
    assert [s.window for s in spans] == [64] * 5 + [0] + [64] * 2
    g = spans[5]
    assert (g.n_retrieval, g.n_streaming, g.group, g.head_dim) == (1, 0, 4, 32)
    state = TM.empty_serve_state(cfg, 2, capacity=CAP, dtype=torch.float32, device="cpu")
    assert [sorted(c) for c in state["layers"]] == (
        [["full"]] * 5 + [["paged", "stream"]] + [["full"]] * 2)
    assert state["layers"][5]["stream"].k.shape[1] == 0


def test_bridge_maps_period_stacking_leaf_by_leaf(g3):
    """blocks/pos{p}[per] is port layer per·6 + p and rem/rem{r} layer 6 + r,
    every leaf equal."""
    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        else:
            yield prefix, tree

    layers = g3.tparams["layers"]
    assert len(layers) == 8
    want = {}
    for pos in range(6):
        for path, a in leaves(g3.tree["blocks"][f"pos{pos}"]):
            want.setdefault(pos, {})[path] = a[0]
    for r in range(2):
        want[6 + r] = dict(leaves(g3.tree["rem"][f"rem{r}"]))
    for i, layer in enumerate(layers):
        got = {p: t.numpy() for p, t in leaves(layer)}
        assert sorted(got) == sorted(want[i]), i
        for path in got:
            np.testing.assert_array_equal(got[path], want[i][path], err_msg=f"{i}{path}")


@pytest.mark.parametrize("h2eal", [True, False], ids=["sparse", "full"])
def test_prefill_and_decode_logits_match_jax(g3, h2eal):
    """Prefill logits and 4 decode steps (select and reuse) equal JAX's
    ``prefill`` / ``decode_step`` to 2e-4, with H²EAL on and off."""
    jcfg, tcfg = g3.jcfg, g3.tcfg
    if not h2eal:
        jcfg, tcfg = _h2(jcfg, enabled=False), _h2(tcfg, enabled=False)
    prompts = _prompts(jcfg)
    cap = PROMPT + GEN + jcfg.h2eal.page_size
    prefill, jsteps = g3.jax_steps(jcfg, cap)
    jl, jst = prefill(g3.jparams, jnp.asarray(prompts))
    tl, tst = TM.prefill(tcfg, g3.tparams, torch.from_numpy(prompts), capacity=cap)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    for i in range(4):
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        jl, jst = jsteps[i % 2 == 0](g3.jparams, jst, jnp.asarray(tok))
        tl, tst = TM.decode_step(tcfg, g3.tparams, tst, torch.from_numpy(tok),
                                 do_select=i % 2 == 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"decode step {i}")


def test_lockstep_greedy_tokens_equal_jax(g3):
    """The port's ``generate`` against the loop of JAX ``generate`` (its
    jitted prefill, select and reuse steps, greedy argmax)."""
    prompts = _prompts(g3.jcfg, seed=3)
    cap = PROMPT + GEN + g3.jcfg.h2eal.page_size
    prefill, steps = g3.jax_steps(g3.jcfg, cap)
    logits, state = prefill(g3.jparams, jnp.asarray(prompts))
    jtoks, w = [], g3.jcfg.h2eal.share_window
    for i in range(GEN):
        jtoks.append(np.argmax(np.asarray(logits), axis=-1).astype(np.int32))
        logits, state = steps[i % w == 0](g3.jparams, state, jnp.asarray(jtoks[-1]))
    ttoks, stats = tlaunch.generate(g3.tcfg, g3.tparams, torch.from_numpy(prompts),
                                    gen=GEN, capacity=cap, device="cpu")
    np.testing.assert_array_equal(ttoks.numpy(), np.stack(jtoks, axis=1))
    assert torch.isfinite(stats["last_logits"]).all()


# the co-placed layout chunked, its main path; at S = 1 its packed
# admission builds the default layout's caches (one stripe)
ENGINE_MODES = {
    "packed": dict(),
    "chunked": dict(prefill_chunk=16),
    "coplace_chunked": dict(layout="coplace_shmap", prefill_chunk=16),
}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_matches_jax(g3, mode):
    """Packed and chunked admission with slot churn, on both layouts (the
    co-placed one at S = 1, JAX's on this process's one device): the JAX
    engine's tokens and step counts."""
    kw = ENGINE_MODES[mode]
    reqs = _workload(g3.tcfg)
    want, js = g3.jax_run(reqs, h2=ENGINE_H2, **kw)
    eng = g3.port(h2=ENGINE_H2, **kw)
    assert _tokens(eng.run(reqs)) == want
    s = eng.stats
    assert (s.decode_steps, s.select_steps, s.prefill_chunks) == (
        js.decode_steps, js.select_steps, js.prefill_chunks)


_GSPMD_DEFAULT = {}


@pytest.mark.parametrize("mode", ["packed", "chunked"])
@pytest.mark.parametrize("layout", ["head", "coplace", "interleave"])
def test_gspmd_layouts_match_jax_and_default(g3, layout, mode):
    """The GSPMD layouts at one rank (the default one-rank mesh): the window
    layers' full caches and the global layer's pages placed as the
    reference places them, packed and chunked, on the first 3 requests of
    the workload: the port's default engine's tokens exactly, and the JAX
    engine's of the same mode."""
    reqs = _workload(g3.tcfg)
    want, _ = g3.jax_run(reqs, h2=ENGINE_H2, **ENGINE_MODES[mode])
    if mode not in _GSPMD_DEFAULT:
        _GSPMD_DEFAULT[mode] = _tokens(g3.port(h2=ENGINE_H2, **ENGINE_MODES[mode])
                                       .run(reqs[:3]))
    got = _tokens(g3.port(h2=ENGINE_H2, layout=layout, **ENGINE_MODES[mode]).run(reqs[:3]))
    assert got == _GSPMD_DEFAULT[mode] == {u: want[u] for u in got}


def test_fused_decode_windows_match_jax(g3):
    """decode_window=4, chunked: the JAX per-step chunked engine's tokens
    and decode steps, a fused window running the reuse steps between two
    selection boundaries."""
    reqs = _workload(g3.tcfg)
    want, js = g3.jax_run(reqs, h2=ENGINE_H2, **ENGINE_MODES["chunked"])
    eng = g3.port(h2=ENGINE_H2, decode_window=4, **ENGINE_MODES["chunked"])
    assert _tokens(eng.run(reqs)) == want
    assert eng.stats.decode_steps == js.decode_steps
    assert eng.stats.fused_windows > 0


TIER = ("tier_hits", "tier_misses", "tier_spills", "tier_fills", "tier_prefetch",
        "tier_fill_batches", "tier_spill_batches", "tier_gather_batches")
REBALANCE = ("rebalance_checks", "rebalances", "rebalance_skipped", "migrations",
             "migrated_tokens")


def test_hot_pages_and_rebalance_match_jax(g3):
    """Tiered residency (the global layer's pages; window layers keep full
    caches on the card) and retire-triggered rebalancing, on 4 slots with
    churn: the JAX engine's tokens and counters."""
    rng = np.random.default_rng(0)
    reqs = [Request(uid=u, prompt=rng.integers(0, g3.tcfg.vocab_size, size=(
        BUCKETS[0],)).astype(np.int32), max_new=int(rng.integers(3, 14)))
        for u in range(8)]
    kw = dict(max_batch=4, hot_pages=8, rebalance="retire")
    want, js = g3.jax_run(reqs, **kw)
    eng = g3.port(**kw)
    assert _tokens(eng.run(reqs)) == want
    ts = eng.stats
    assert {f: getattr(ts, f) for f in TIER + REBALANCE} == {
        f: getattr(js, f) for f in TIER + REBALANCE}
    assert ts.tier_misses > 0 and ts.migrations > 0


def test_two_kv_heads_window_and_streaming_heads_together():
    """A variant with two kv heads: global layers then have a retrieval and
    a streaming head beside the window layers. Prefill and 3 select decode
    steps: logits to 2e-4 against JAX's, every cache kind written."""
    m = Model(num_kv_heads=2)
    spec = TT.attn_spec(m.tcfg, 5)
    assert (spec.n_retrieval, spec.n_streaming) == (1, 1)
    prompts = _prompts(m.jcfg, seed=5)
    cap = PROMPT + GEN + m.jcfg.h2eal.page_size
    prefill, steps = m.jax_steps(m.jcfg, cap)
    jl, jst = prefill(m.jparams, jnp.asarray(prompts))
    tl, tst = TM.prefill(m.tcfg, m.tparams, torch.from_numpy(prompts), capacity=cap)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    for _ in range(3):
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        jl, jst = steps[True](m.jparams, jst, jnp.asarray(tok))
        tl, tst = TM.decode_step(m.tcfg, m.tparams, tst, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    g = tst["layers"][5]
    assert g["stream"].k.shape[1] == 1 and (g["stream"].pos >= 0).any()
    assert (g["paged"].page_start >= 0).any()


def test_spec_tokens_and_verify_refuse_local_global(g3):
    """Speculative decode raises for a local_global stack, as the JAX
    engine does (its window layers have no verify chunk)."""
    msg = "full attention pattern"
    with pytest.raises(ValueError, match=msg):
        JEngine(g3.jcfg, g3.jparams, max_batch=2, capacity=CAP, prompt_buckets=BUCKETS,
                spec_tokens=2)
    with pytest.raises(ValueError, match=msg):
        g3.port(spec_tokens=2)
    state = TM.empty_serve_state(g3.tcfg, 2, capacity=CAP, dtype=torch.float32,
                                 device="cpu")
    with pytest.raises(ValueError, match=msg):
        TM.verify_forward(g3.tcfg, g3.tparams, state, torch.zeros(2, 2, dtype=torch.int32),
                          active=torch.ones(2, dtype=torch.bool),
                          need_select=torch.ones(2, dtype=torch.bool))
