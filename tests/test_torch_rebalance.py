"""PyTorch port, live slot rebalancing: ``Engine(rebalance=...)`` on the CPU
against the JAX engine's on tests/test_rebalance.py's churn workload, on
the same weights.

Tokens per uid and the rebalance counters (checks, plans applied, skips,
migrations, migrated tokens) must be EQUAL, and the mean imbalance before
and after the checks equal to 1e-12: the port scores the same slots with
the same cost model and plans the same moves. The JAX engines are built
once per module.
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
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine, Request
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

CAP = 64
BUCKETS = [8, 16, 24]
COUNTERS = ("rebalance_checks", "rebalances", "rebalance_skipped", "migrations",
            "migrated_tokens")


class Model:
    def __init__(self, share_window=None):
        self.jcfg = jconfigs.reduced(jconfigs.get_arch("smollm-360m"))
        self.tcfg = tconfigs.reduced(tconfigs.get_arch("smollm-360m"))
        if share_window:
            self.jcfg, self.tcfg = (dataclasses.replace(c, h2eal=dataclasses.replace(
                c.h2eal, share_window=share_window)) for c in (self.jcfg, self.tcfg))
        self.jparams = JM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.tparams = params_from_numpy(
            self.tcfg, jax.tree.map(np.asarray, self.jparams), "cpu")

    def jax_engine(self, **kw):
        return JEngine(self.jcfg, self.jparams, max_batch=4, capacity=CAP,
                       prompt_buckets=BUCKETS, **kw)

    def port(self, **kw):
        return Engine(self.tcfg, self.tparams, max_batch=4, capacity=CAP,
                      prompt_buckets=BUCKETS, device="cpu", **kw)


@pytest.fixture(scope="module")
def model():
    return Model()


def _churn(req, cfg, *, n=12, seed=0):
    """tests/test_rebalance.py's workload: ragged prompts and budgets, so
    that retirements leave the batch skewed."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        s = int(rng.choice(BUCKETS))
        g = int(rng.integers(3, 20))
        prompt = rng.integers(0, cfg.vocab_size, size=(s,)).astype(np.int32)
        reqs.append(req(uid=uid, prompt=prompt, max_new=g))
    return reqs


def _tokens(comps):
    return {u: c.tokens for u, c in comps.items()}


def _match(m, **kw):
    """Run the port and the JAX engine with ``kw`` on the churn workload and
    hold tokens and counters equal; returns the port's engine."""
    je = m.jax_engine(**kw)
    want = _tokens(je.run(_churn(JRequest, m.jcfg)))
    eng = m.port(**kw)
    assert _tokens(eng.run(_churn(Request, m.tcfg))) == want
    ts, js = eng.stats, je.stats
    assert {f: getattr(ts, f) for f in COUNTERS} == {f: getattr(js, f) for f in COUNTERS}
    assert ts.imbalance_pre == pytest.approx(js.imbalance_pre, abs=1e-12)
    assert ts.imbalance_post == pytest.approx(js.imbalance_post, abs=1e-12)
    assert ts.migrations > 0 and ts.rebalances > 0
    assert ts.imbalance_post < ts.imbalance_pre
    return eng


CASES = {
    "retire-packed": dict(rebalance="retire"),
    "retire-chunk8": dict(rebalance="retire", prefill_chunk=8),
    "interval-packed": dict(rebalance="interval", rebalance_interval=4,
                            rebalance_cooldown=2),
    # interval and chunked: with fused windows, below
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rebalance_matches_jax(model, case):
    """Both triggers, packed, and retire chunked: JAX's tokens and counters;
    a second, differently shaped workload adds no capture."""
    eng = _match(model, **CASES[case])
    sizes = eng.jit_cache_sizes()
    assert "migrate" in sizes
    if case == "retire-packed":
        eng.reset_metrics()
        eng.run(_churn(Request, model.tcfg, seed=5))
        assert eng.jit_cache_sizes() == sizes


def test_rebalance_interval_fused_windows_match_jax():
    """The interval trigger, chunked, under decode_window=4 (share window
    widened to 4): a fused window moves several engine steps at once, and a
    check runs where the steps CROSS a multiple of the interval, as in the
    JAX engine."""
    m = Model(share_window=4)
    eng = _match(m, rebalance="interval", rebalance_interval=4,
                 rebalance_cooldown=2, decode_window=4, prefill_chunk=8)
    assert eng.stats.fused_windows > 0


def test_rebalance_spec_matches_off(model):
    """Speculative decode (k = 4) with retire-triggered migration gives the
    tokens of the port's own rebalance="off" engine."""
    off = model.port(spec_tokens=4).run(_churn(Request, model.tcfg, n=8))
    eng = model.port(spec_tokens=4, rebalance="retire")
    assert _tokens(eng.run(_churn(Request, model.tcfg, n=8))) == _tokens(off)
    assert eng.stats.migrations > 0


def test_compute_loads_on_a_plain_engine_match_jax(model):
    """``compute_loads`` with rebalancing off (the balance report's view):
    one zero load a bank before admission, then JAX's loads mid-run."""
    je, te = model.jax_engine(), model.port()
    assert te.compute_loads() == je.compute_loads() == [0.0] * te.rebalance_banks
    for r in _churn(JRequest, model.jcfg)[:6]:
        je.submit(r)
    for r in _churn(Request, model.tcfg)[:6]:
        te.submit(r)
    for _ in range(5):
        je.poll()
        te.poll()
        assert te.compute_loads() == je.compute_loads()
    assert any(x > 0 for x in te.compute_loads())


def test_rebalance_invalid_trigger_rejected(model):
    with pytest.raises(ValueError, match="valid triggers"):
        model.port(rebalance="bogus")


def test_cli_rebalance_and_balance_report_match_jax(model):
    """``run_ragged(rebalance="retire", report_balance=True)``: the
    ``rebalance`` block and the balance report (bank-grid tiling, page
    loads, slot LPT and cost-model views) equal the JAX CLI's."""
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as tlaunch

    kw = dict(max_batch=4, capacity=CAP, prompt_buckets=BUCKETS,
              report_balance=True, rebalance="retire")
    _, js = jlaunch.run_ragged(model.jcfg, model.jparams,
                               _churn(JRequest, model.jcfg, n=7), **kw)
    _, ts = tlaunch.run_ragged(model.tcfg, model.tparams,
                               _churn(Request, model.tcfg, n=7), device="cpu", **kw)
    assert ts["rebalance"] == js["rebalance"]
    tb, jb = ts["balance"], js["balance"]
    for key in ("admissions", "prefill_chunks", "cost_loads", "cost_imbalance",
                "migrations", "rebalances", "imbalance_pre", "imbalance_post",
                "imbalance_naive", "imbalance_coplaced", "page_load_imbalance",
                "slot_lpt_imbalance"):
        assert tb.get(key) == jb.get(key), key
