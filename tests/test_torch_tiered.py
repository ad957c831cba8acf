"""PyTorch port, tiered hot/cold KV page residency: ``Engine(hot_pages=N)``
on the CPU against the JAX engine's ``Engine(hot_pages=N, impl="ref")`` on
the same requests and weights (the workload of tests/test_tiered.py).

Tokens per uid and every tier counter must be EQUAL: the port's selection
digest, refresh plan and far store make the JAX engine's decisions, and its
select step, undone and replayed after a cold miss, serves the JAX replay's
tokens. The JAX engines are built once per module.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core.cache import kv_page_tensors
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine, Request, _selection_digest
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

CAP = 128          # 16 pages of 8
COUNTERS = ("tier_hits", "tier_misses", "tier_spills", "tier_fills",
            "tier_prefetch", "tier_fill_batches", "tier_spill_batches",
            "tier_gather_batches", "tier_batch_pages_max")


def _narrow(cfg):
    """test_tiered.py's config: a small local window and select budget, so
    that most pages may be spilled."""
    return dataclasses.replace(cfg, h2eal=dataclasses.replace(
        cfg.h2eal, local=8, select_budget=16))


class Model:
    def __init__(self):
        self.jcfg = _narrow(jconfigs.reduced(jconfigs.get_arch("smollm-360m")))
        self.tcfg = _narrow(tconfigs.reduced(tconfigs.get_arch("smollm-360m")))
        self.jparams = JM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.tparams = params_from_numpy(
            self.tcfg, jax.tree.map(np.asarray, self.jparams), "cpu")
        self._runs = {}

    def jax_run(self, **kw):
        """(tokens per uid, stats, selected pages still cold after each
        replay) of the JAX engine on workload 0."""
        key = tuple(sorted(kw.items()))
        if key not in self._runs:
            eng = JEngine(self.jcfg, self.jparams, max_batch=2, capacity=CAP,
                          prompt_buckets=[64], **kw)
            cold = _cold_after_replay(eng, lambda out, need: eng._tier_digest(out[1], need))
            comps = eng.run(_workload(JRequest, self.jcfg, 0))
            self._runs[key] = ({u: c.tokens for u, c in comps.items()}, eng.stats, cold)
        return self._runs[key]

    def port(self, **kw):
        kw = dict(dict(max_batch=2, capacity=CAP, prompt_buckets=[64],
                       device="cpu"), **kw)
        return Engine(self.tcfg, self.tparams, **kw)


@pytest.fixture(scope="module")
def model():
    return Model()


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)


def _workload(req, cfg, seed):
    """Three requests over two slots, deep enough to spill (8+ data pages)."""
    return [req(uid=i, prompt=_prompt(cfg, 64, 100 * seed + i), max_new=6 + 4 * i)
            for i in range(3)]


def _tokens(comps):
    return {u: c.tokens for u, c in comps.items()}


def _assert_counters(ts, js):
    assert {f: getattr(ts, f) for f in COUNTERS} == {f: getattr(js, f) for f in COUNTERS}
    assert ts.tier_hit_rate == js.tier_hit_rate
    assert ts.tier_fill_batch_mean == js.tier_fill_batch_mean
    assert ts.tier_spill_batch_mean == js.tier_spill_batch_mean


@pytest.mark.parametrize("hot_pages,chunk", [(6, None), (8, 8)],
                         ids=["6-packed", "8-chunk8"])
def test_tiered_engine_matches_jax(model, hot_pages, chunk):
    """Equal tokens and tier counters at two budgets (6: misses and spills;
    8: also a prefetch), packed and chunked (the JAX tiered engine's tokens
    are its all-resident engine's, tests/test_tiered.py); a second workload
    adds no capture.

    A replay can itself select a cold page (layer l's query depends on
    layers < l, which read the filled pages), and the JAX engine replays
    once: at budget 6 one selected page is still cold after a replay, on
    both sides alike (ROADMAP Queue 3)."""
    want, jstats, jcold = model.jax_run(hot_pages=hot_pages, prefill_chunk=chunk)
    eng = model.port(hot_pages=hot_pages, prefill_chunk=chunk)
    cold = _cold_after_replay(
        eng, lambda out, need: eng._tier_digest(_selection_digest(eng.batch.serve), need))
    got = eng.run(_workload(Request, model.tcfg, 0))
    assert cold == jcold
    assert sum(cold) == (1 if hot_pages == 6 else 0)
    assert _tokens(got) == want
    _assert_counters(eng.stats, jstats)
    s = eng.stats
    assert s.tier_misses == s.tier_fills > 0 and s.tier_spills > 0
    if hot_pages == 8:
        assert s.tier_prefetch > 0
    # the far store moved exactly the pages the counters say
    page = sum(t[0, :, 0].nbytes for t in kv_page_tensors(eng.batch.serve))
    assert eng._tier.h2d_bytes == (s.tier_fills + s.tier_prefetch) * page
    assert eng._tier.d2h_bytes == s.tier_archived * page
    assert s.tier_archived <= s.tier_spills
    sizes = eng.jit_cache_sizes()
    assert "tier_restore" in sizes
    if (hot_pages, chunk) == (6, None):
        eng.reset_metrics()
        eng.run(_workload(Request, model.tcfg, 1))
        assert eng.jit_cache_sizes() == sizes


def test_tiered_coplace_shmap_matches_jax(model):
    """The co-placed layout (one stripe, as on one JAX device) under a
    tight budget: the tier's pages are physical, the stripe mapping the
    identity."""
    want, jstats, _ = model.jax_run(hot_pages=6, layout="coplace_shmap")
    eng = model.port(hot_pages=6, layout="coplace_shmap")
    assert _tokens(eng.run(_workload(Request, model.tcfg, 0))) == want
    _assert_counters(eng.stats, jstats)
    assert eng.stats.tier_misses > 0


def test_tiered_coplace_four_stripes_matches_all_resident(model):
    """The co-placed layout over 4 stripes (the JAX side needs 4 devices):
    the tier keeps physical pages and maps its sink and local pins through
    the stripe order; tokens equal the port's all-resident co-placed
    engine's, with misses, spills and a prefetch."""
    kw = dict(layout="coplace_shmap", shards=4, prefill_chunk=8)
    want = _tokens(model.port(**kw).run(_workload(Request, model.tcfg, 0)))
    eng = model.port(hot_pages=8, **kw)
    assert _tokens(eng.run(_workload(Request, model.tcfg, 0))) == want
    s = eng.stats
    assert s.tier_misses == s.tier_fills > 0 and s.tier_spills > 0 and s.tier_prefetch > 0


def test_tiered_and_rebalanced_matches_jax(model):
    """Tiering and live migration together, chunked, on four slots: a move
    carries the slot's residency and far rows with it. JAX's tokens, tier
    counters and migrations."""
    rng = np.random.default_rng(3)
    spec = [(int(rng.choice([24, 48, 64])), 50 + i, int(rng.integers(4, 20)))
            for i in range(8)]
    kw = dict(max_batch=4, capacity=CAP, prompt_buckets=[24, 48, 64], hot_pages=6,
              rebalance="retire", prefill_chunk=8)
    je = JEngine(model.jcfg, model.jparams, **kw)
    want = _tokens(je.run([JRequest(uid=i, prompt=_prompt(model.jcfg, n, s), max_new=g)
                           for i, (n, s, g) in enumerate(spec)]))
    eng = model.port(**kw)
    got = eng.run([Request(uid=i, prompt=_prompt(model.tcfg, n, s), max_new=g)
                   for i, (n, s, g) in enumerate(spec)])
    assert _tokens(got) == want
    _assert_counters(eng.stats, je.stats)
    assert eng.stats.migrations == je.stats.migrations > 0
    assert eng.stats.tier_spills > 0


def _cold_after_replay(eng, digest_of):
    """Wrap ``eng._tier_select`` to count, after each replay, the selected
    pages still cold (a layer >= 1 may select a page the first pass did
    not); ``digest_of(result)`` reads the replayed selection."""
    counts = []
    orig = eng._tier_select

    def wrapped(need, *args):
        misses = eng.stats.tier_misses
        out = orig(need, *args)
        if eng.stats.tier_misses > misses:
            sel, _ = digest_of(out, need)
            counts.append(sum(len(eng._tier.missing(s, sel[s])) for s in sel))
        return out
    eng._tier_select = wrapped
    return counts


def _force_and_run(eng, force):
    """Serve one request, forcing every spillable page cold at the first
    selection boundary from the fifth step on."""
    eng._admit()
    forced = steps = 0
    while eng.busy():
        b = eng.batch
        if not forced and steps >= 4 and b.active[0] and b.phase[0] % eng.share_window == 0:
            forced = force(eng)
        eng.step()
        steps += 1
    eng.finalize()
    return forced


def test_forced_cold_miss_served_late_as_jax(model):
    """The chaos hook of tests/test_tiered.py: every spillable page of the
    slot, the selected ones too, goes cold right before its selection. The
    port misses, fills and replays, and gives JAX's tokens and counters, so
    the restore of what the first pass wrote is complete. Selected pages
    still cold after the replay are counted on both sides and are equal."""
    m = model
    req = dict(uid=0, max_new=14)
    je = JEngine(m.jcfg, m.jparams, max_batch=1, capacity=CAP, prompt_buckets=[64],
                 hot_pages=12)
    je.submit(JRequest(prompt=_prompt(m.jcfg, 64, 7), **req))
    jcold = _cold_after_replay(je, lambda out, need: je._tier_digest(out[1], need))
    jforced = _force_and_run(je, lambda e: e.tier_force_spill(0))

    te = m.port(max_batch=1, hot_pages=12)
    te.submit(Request(prompt=_prompt(m.tcfg, 64, 7), **req))
    tcold = _cold_after_replay(
        te, lambda out, need: te._tier_digest(_selection_digest(te.batch.serve), need))
    tforced = _force_and_run(te, lambda e: e.tier_force_spill(0))

    assert tforced == jforced > 0
    assert te.completions[0].tokens == je.completions[0].tokens
    _assert_counters(te.stats, je.stats)
    s = te.stats
    assert s.tier_misses > 0 and s.tier_fills == s.tier_misses
    assert s.tier_prefetch > 0 and s.tier_hit_rate < 1.0
    assert tcold == jcold and len(tcold) > 0


def test_tiered_validation(model):
    """tests/test_tiered.py::test_tiered_validation on the port: the budget
    out of range raises ValueError at construction; hot_pages None builds
    no tier; the force hook needs one; speculation refuses tiering."""
    m = model
    for bad in (99, -3):
        with pytest.raises(ValueError, match="hot_pages"):
            m.port(max_batch=1, hot_pages=bad)
    eng = m.port(max_batch=1, hot_pages=None)
    assert eng._tier is None
    assert "tier_restore" not in eng.jit_cache_sizes()
    with pytest.raises(ValueError, match="hot_pages"):
        eng.tier_force_spill(0)
    with pytest.raises(ValueError, match="tiered residency"):
        m.port(max_batch=1, hot_pages=4, spec_tokens=2)
