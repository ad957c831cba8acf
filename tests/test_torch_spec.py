"""PyTorch port, speculative decode: ``verify_forward`` / ``verify_commit``
against the JAX package's (``impl="ref"``) on one state, and the
continuous-batching engine with ``spec_tokens`` against the JAX engine, on
the reduced smollm-360m, on the CPU.

Tolerance: logits within 2e-4 after the layer stack, cache values within
2e-5, integer state equal. Traces token for token, greedy and sampled
(temperature 0.8, top_p 0.9, seed 3), on the churny workload of
tests/test_sampling.py (5 requests through 2 slots). Where a token differs,
the JAX logits at the first difference must hold a near-tie: greedy, a
top-2 gap below 1e-3; sampled, a top-2 gap of ``filtered + gumbel`` below
1e-3 / temperature (the logits' band moved through the sampler).

The port's speculative trace must also equal its own non-speculative one,
exactly. On ``coplace_shmap`` the port is held to the JAX non-speculative
engine: the JAX verify step selects with the default layout's fill pages
where the co-placed decode selects -1, so the JAX speculative co-placed
trace departs from its own non-speculative one (ROADMAP Queue 3); the
port's verify selects as its decode does.

The JAX engines are built once per module and reused (``reset_metrics``).
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
from repro.sched import balance as jbalance
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import draft as jdraft
from repro.serving import sampling as jsamp
from repro.serving.engine import _reset_slot as j_reset_slot
from repro_torch import configs as tconfigs
from repro_torch.core import layouts as tlayouts
from repro_torch.kernels import ref as tref
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import graphs
from repro_torch.sched import balance as tbalance
from repro_torch.serving import draft as tdraft
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.engine import _reset_slot as t_reset_slot
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

CAP = 64
LOGIT_TOL = 2e-4
CACHE_TOL = 2e-5
TIE_GAP = 1e-3
STOCH = dict(temperature=0.8, top_p=0.9, seed=3)


class Model:
    def __init__(self, name):
        self.jcfg = jconfigs.reduced(jconfigs.get_arch(name))
        self.tcfg = tconfigs.reduced(tconfigs.get_arch(name))
        self.jparams = JM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.tparams = params_from_numpy(
            self.tcfg, jax.tree.map(np.asarray, self.jparams), "cpu")
        self._engines = {}
        self._steps = None

    def requests(self, R, **kw):
        """The churny workload: ragged budgets through 2 slots."""
        return [R(uid=i, prompt=np.random.default_rng(7 + i).integers(
                      0, self.jcfg.vocab_size, size=([16, 24][i % 2],)).astype(np.int32),
                  max_new=3 + 2 * i, **kw) for i in range(5)]

    def jax_run(self, sampling, **kw):
        key = tuple(sorted(kw.items()))
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = JEngine(self.jcfg, self.jparams, max_batch=2,
                                               capacity=CAP, prompt_buckets=[16, 24],
                                               **kw)
        eng.reset_metrics()
        return {u: c.tokens for u, c in eng.run(self.requests(JRequest,
                                                              **sampling)).items()}

    def port(self, cfg=None, **kw):
        return Engine(cfg or self.tcfg, self.tparams, max_batch=2, capacity=CAP,
                      prompt_buckets=[16, 24], device="cpu", **kw)

    def port_run(self, sampling, cfg=None, **kw):
        eng = self.port(cfg, **kw)
        comps = eng.run(self.requests(Request, **sampling))
        return {u: c.tokens for u, c in comps.items()}, eng

    def _jax_logits(self, prompt, tokens):
        """The lockstep JAX logits that chose each of ``tokens`` (the
        prefill's, then one decode step per token fed)."""
        if self._steps is None:
            scfg = jserve.ServeConfig(capacity=CAP, impl="ref")
            self._steps = (jax.jit(jserve.make_prefill(self.jcfg, scfg)),
                           [jax.jit(jserve.make_decode_step(self.jcfg, scfg,
                                                            do_select=s))
                            for s in (False, True)])
        prefill, steps = self._steps
        logits, state = prefill(self.jparams, jnp.asarray(prompt)[None])
        out = [np.asarray(logits[0])]
        w = self.jcfg.h2eal.share_window
        for i, t in enumerate(tokens[:-1]):
            logits, state = steps[i % w == 0](self.jparams, state,
                                              jnp.asarray([t], jnp.int32))
            out.append(np.asarray(logits[0]))
        return out

    def assert_same(self, got, want, sampling):
        assert sorted(got) == sorted(want)
        prompts = {r.uid: r.prompt for r in self.requests(Request)}
        for uid in sorted(want):
            g, w = list(got[uid]), list(want[uid])
            assert len(g) == len(w), (uid, g, w)
            diff = [i for i, (a, b) in enumerate(zip(g, w)) if a != b]
            if not diff:
                continue
            i = diff[0]
            row = self._jax_logits(prompts[uid], w)[i]
            t = sampling.get("temperature", 0.0)
            if t > 0:
                key = jsamp.token_key(jsamp.request_key(sampling["seed"], uid), i)
                logp = np.asarray(jax.nn.log_softmax(jnp.asarray(row) / t))
                order = np.argsort(-np.exp(logp), kind="stable")
                cum = np.cumsum(np.exp(logp)[order]) - np.exp(logp)[order]
                keep = np.zeros_like(logp, bool)
                keep[order] = cum < sampling["top_p"]
                row = np.where(keep, logp + np.asarray(
                    jax.random.gumbel(key, row.shape)), -np.inf)
            top2 = np.sort(row)[-2:]
            band = TIE_GAP / t if t > 0 else TIE_GAP
            assert top2[1] - top2[0] < band, (
                f"uid {uid} token {i} differs without a near-tie: {g} vs {w}")


@pytest.fixture(scope="module")
def m():
    return Model("smollm-360m")


# ---------------------------------------------------------------------------
# verify_forward and verify_commit on one state
# ---------------------------------------------------------------------------


def _jax_empty_state(cfg, params, b):
    scfg = jserve.ServeConfig(capacity=CAP)
    probe = jax.ShapeDtypeStruct((b, 8), jnp.int32)
    shapes = jax.eval_shape(jserve.make_prefill(cfg, scfg), params, probe)[1]
    state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    state["length"] = jnp.zeros((b,), jnp.int32)
    return state


def _pair_states(m):
    """The same two-slot state on both sides: prompts of 21 and 38 tokens
    fed by chunked prefill (an idle slot on the last chunk)."""
    jstate = _jax_empty_state(m.jcfg, m.jparams, 2)
    tstate = TM.empty_serve_state(m.tcfg, 2, capacity=CAP, dtype=torch.float32,
                                  device="cpu")
    for i in range(2):
        jstate = j_reset_slot(jstate, jnp.int32(i))
        t_reset_slot(tstate, i)
    jstep = jax.jit(jserve.make_prefill_chunk_step(
        m.jcfg, jserve.ServeConfig(capacity=CAP), chunk=16))
    rng = np.random.default_rng(5)
    for clen in ([16, 16], [5, 16], [0, 6]):
        toks = rng.integers(0, m.jcfg.vocab_size, (2, 16)).astype(np.int32)
        clen = np.asarray(clen, np.int32)
        _, jstate = jstep(m.jparams, jstate, jnp.asarray(toks), jnp.asarray(clen),
                          jnp.asarray(clen > 0))
        _, tstate = TM.prefill_chunk(m.tcfg, m.tparams, tstate, torch.from_numpy(toks),
                                     chunk_len=torch.from_numpy(clen),
                                     active=torch.from_numpy(clen > 0))
    return jstate, tstate


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol, rtol=0)


def _jax_caches(jstate, layer):
    """Layer ``layer``'s (paged, stream) caches of a JAX serve state, as
    dicts of numpy arrays."""
    c = jax.tree.map(lambda x: np.asarray(x)[layer], jstate["blocks"]["pos0"])
    return tuple(dataclasses.asdict(c[k]) if dataclasses.is_dataclass(c[k])
                 else c[k] for k in ("paged", "stream"))


@pytest.mark.parametrize("layout", ["default", "coplace_shmap"])
def test_verify_forward_and_commit_match_jax(m, layout):
    """k = 4 drafted tokens on two slots (one due a selection refresh):
    logits of every chunk position, the refreshed selection and importance,
    and after committing 3 and 1 tokens the caches and lengths, against
    JAX's on the same state. ``coplace_shmap`` at one stripe against JAX on
    one device; its selection turns masked pages into -1 where JAX's verify
    keeps them as fill, so JAX's masked entries are compared as -1."""
    jstate, tstate = _pair_states(m)
    k = 4
    tokens = np.random.default_rng(6).integers(0, m.jcfg.vocab_size,
                                               (2, k)).astype(np.int32)
    active, need = np.array([True, True]), np.array([True, False])
    accepted = np.array([3, 1], np.int32)
    jl, jst, jstash = JM.verify_forward(
        m.jcfg, m.jparams, jstate, jnp.asarray(tokens), active=jnp.asarray(active),
        need_select=jnp.asarray(need), impl="ref", layout=layout)
    jnew = JM.verify_commit(m.jcfg, jst, jstash, accepted=jnp.asarray(accepted),
                            active=jnp.asarray(active), impl="ref", layout=layout)
    lay = tlayouts.get_layout(layout, 1)
    tl, tst, tstash = TM.verify_forward(
        m.tcfg, m.tparams, tstate, torch.from_numpy(tokens),
        active=torch.from_numpy(active), need_select=torch.from_numpy(need), layout=lay)
    _close(tl, np.asarray(jl), LOGIT_TOL)
    h2 = m.tcfg.h2eal
    ctx1 = torch.from_numpy(np.asarray(jstate["length"]) + 1)
    for i, c in enumerate(tst["layers"]):
        jp, _ = _jax_caches(jst, i)
        want_sel = jp["sel_idx"].copy()
        if layout == "coplace_shmap":
            ok = tref.selectable_pages(torch.from_numpy(jp["page_start"]), ctx1,
                                       sink=h2.sink, local=h2.local, page=h2.page_size)
            sel_ok = torch.gather(ok, 2, torch.from_numpy(want_sel).long().clamp(min=0))
            fresh = need[:, None, None] & ~sel_ok.numpy()
            want_sel = np.where(fresh, -1, want_sel)
        np.testing.assert_array_equal(c["paged"].sel_idx.numpy(), want_sel)
        _close(c["paged"].importance, jp["importance"], LOGIT_TOL)
    tnew = TM.verify_commit(m.tcfg, tst, tstash, accepted=torch.from_numpy(accepted),
                            active=torch.from_numpy(active), layout=lay)
    np.testing.assert_array_equal(tnew["length"].numpy(), np.asarray(jnew["length"]))
    for i, c in enumerate(tnew["layers"]):
        jp, js = _jax_caches(jnew, i)
        for f in ("k_pages", "v_pages", "tau_min", "tau_max"):
            _close(getattr(c["paged"], f), jp[f], CACHE_TOL)
        np.testing.assert_array_equal(c["paged"].page_start.numpy(), jp["page_start"])
        for f in ("k", "v"):
            _close(getattr(c["stream"], f), js[f], CACHE_TOL)
        np.testing.assert_array_equal(c["stream"].pos.numpy(), js["pos"])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefill_chunk", [None, 8])
@pytest.mark.parametrize("k", [1, 4])
def test_spec_engine_matches_jax(m, k, prefill_chunk):
    """Greedy and sampled traces of ``spec_tokens=k`` against the JAX
    speculative engine's, and equal to the port's non-speculative ones; the
    verify step is one capture and captures do not grow."""
    kw = dict(spec_tokens=k, prefill_chunk=prefill_chunk)
    for sampling in ({}, STOCH):
        got, eng = m.port_run(sampling, **kw)
        m.assert_same(got, m.jax_run(sampling, **kw), sampling)
        base, _ = m.port_run(sampling, prefill_chunk=prefill_chunk)
        assert got == base
        assert eng.stats.spec_steps > 0
        assert set(eng.jit_cache_sizes()) >= {"verify", "decode_select"}
    greedy, _ = m.port_run({}, **kw)
    assert greedy != m.port_run(STOCH, **kw)[0]  # the sampled lane is live


def test_spec_coplace_engine_matches_jax(m):
    """``coplace_shmap`` at one stripe, k = 4, chunked, greedy and sampled:
    the port's speculative traces equal its non-speculative ones and the JAX
    co-placed engine's."""
    kw = dict(layout="coplace_shmap", prefill_chunk=8)
    for sampling in ({}, STOCH):
        got, _ = m.port_run(sampling, spec_tokens=4, **kw)
        base, _ = m.port_run(sampling, **kw)
        assert got == base
        m.assert_same(got, m.jax_run(sampling, **kw), sampling)


def test_all_reject_is_one_token_a_step(m):
    """ConstantDraft(-1): every draft rejects, each verify step emits one
    target: the non-speculative trace, accepted length 1."""
    base, _ = m.port_run({})
    got, eng = m.port_run({}, spec_tokens=4, draft=tdraft.ConstantDraft(-1))
    assert got == base
    s = eng.stats
    assert s.spec_slot_steps > 0 and s.spec_accepted == s.spec_slot_steps
    assert s.mean_accepted_len == 1.0
    assert s.spec_drafted == 3 * s.spec_slot_steps


@pytest.mark.parametrize("k", [2, 4])
def test_all_accept_emits_k_a_step(m, k):
    """ReplayDraft of the non-speculative trace with the share window at k:
    every draft matches and no clamp binds, so each verify event emits k
    tokens; tokens and steps share one wall clock, so tokens_per_s over
    steps_per_s is the tokens a decode step."""
    cfg = dataclasses.replace(m.tcfg, h2eal=dataclasses.replace(m.tcfg.h2eal,
                                                                share_window=k))
    req = Request(uid=0, prompt=m.requests(Request)[0].prompt, max_new=1 + 3 * k)
    base = m.port(cfg).run([dataclasses.replace(req)])[0].tokens
    eng = m.port(cfg, spec_tokens=k, draft=tdraft.ReplayDraft({0: base}))
    assert eng.run([dataclasses.replace(req)])[0].tokens == base
    s = eng.stats
    assert (s.spec_slot_steps, s.spec_accepted) == (3, 3 * k)
    assert s.mean_accepted_len == k and s.tokens_out == 1 + 3 * k
    assert s.wall_s > 0
    assert s.tokens_per_s / s.steps_per_s == pytest.approx(s.tokens_out / s.decode_steps)
    assert s.tokens_out / s.decode_steps > 1.0


def _state(eng):
    return [t.clone() for _, _, t in graphs.snapshot(eng.batch.serve)]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("layout", ["default", "coplace_shmap"])
def test_streaming_draft_is_lossless_and_leaves_the_state(m, layout):
    """The streaming self-draft (retrieval selection -1: sink and local pages
    only) gives the non-speculative trace, and a draft leaves the real serve
    state bit for bit; its two steps are the engine's ``draft_mask`` and
    ``draft_decode``."""
    kw = dict(layout=layout, prefill_chunk=8)
    base, _ = m.port_run({}, **kw)
    got, eng = m.port_run({}, spec_tokens=3, draft="streaming", **kw)
    assert got == base
    assert eng.stats.mean_accepted_len > 1.0
    assert {"draft_mask", "draft_decode"} <= set(eng.jit_cache_sizes())
    eng = m.port(spec_tokens=3, draft="streaming", **kw)
    for r in m.requests(Request)[:2]:
        eng.submit(r)
    for _ in range(4):
        eng.poll()
    before = _state(eng)
    drafted = eng.draft.draft(eng, eng.batch.active.copy(), 3)
    assert drafted.shape == (2, 2)
    assert _same(_state(eng), before)
    with pytest.raises(ValueError, match="one engine"):
        eng.draft.bind(eng)


def test_verify_and_draft_with_no_lane_active_leave_the_state(m):
    """The capture's warm-up runs every step with every input zero: the
    verify step and the streaming draft must then be no-ops on the state,
    the token feed and the generation indices."""
    eng = m.port(spec_tokens=4, draft="streaming", prefill_chunk=8)
    for r in m.requests(Request)[:2]:
        eng.submit(r)
    for _ in range(5):
        eng.poll()
    feeds = (eng._tok.clone(), eng._gen.clone())
    before = _state(eng)
    eng._graphs.set(act=np.zeros(2, bool), need=np.zeros(2, bool),
                    max_emit=np.zeros(2, np.int32))
    eng.draft.draft(eng, np.zeros(2, bool), 4)
    eng._graphs.run("verify")
    assert _same(_state(eng), before)
    assert torch.equal(eng._tok, feeds[0]) and torch.equal(eng._gen, feeds[1])


def test_spec_gates_raise_as_jax(m):
    """The JAX engine's ``spec_tokens`` gates and ``resolve_draft``, on both
    sides."""
    kw = dict(max_batch=1, capacity=CAP, prompt_buckets=[16])
    for lib in (jdraft, tdraft):
        assert isinstance(lib.resolve_draft("ngram"), lib.NgramDraft)
        assert isinstance(lib.resolve_draft("streaming"), lib.StreamingDraft)
        with pytest.raises(ValueError, match="unknown draft"):
            lib.resolve_draft("bogus")
    cases = [
        (dict(spec_tokens=m.jcfg.h2eal.local + 1), {}, "h2eal.local"),
        (dict(spec_tokens=2, hot_pages=4), {}, "tiered"),
        (dict(spec_tokens=2, decode_window=4), {}, "decode_window > 1"),
        (dict(spec_tokens=2), dict(mixer_pattern=("mamba2", "attention")),
         "all-attention"),
        (dict(spec_tokens=2), dict(h2eal_off=True), "h2eal.enabled"),
    ]
    for ekw, ckw, what in cases:
        for cfg, params, E, extra in ((m.jcfg, m.jparams, JEngine, {}),
                                      (m.tcfg, m.tparams, Engine, dict(device="cpu"))):
            if ckw.get("h2eal_off"):
                cfg = dataclasses.replace(cfg, h2eal=dataclasses.replace(
                    cfg.h2eal, enabled=False))
            elif ckw:
                cfg = dataclasses.replace(cfg, **ckw)
            with pytest.raises(ValueError, match=what):
                E(cfg, params, **kw, **ekw, **extra)


def test_ngram_lookup_matches_jax():
    rng = np.random.default_rng(0)
    jd, td = jdraft.NgramDraft(max_n=3), tdraft.NgramDraft(max_n=3)
    assert td._lookup([5, 1, 2, 3, 9, 1, 2, 3], 2) == [9, 1]
    assert td._lookup([4, 7, 8], 3) == [8, 8, 8]
    for _ in range(50):
        hist = list(rng.integers(0, 6, size=rng.integers(1, 20)))
        m_ = int(rng.integers(1, 6))
        assert td._lookup(hist, m_) == jd._lookup(hist, m_)


def test_spec_admission_score_matches_jax():
    """Under spec_tokens=k every context is scored at ctx + k - 1: a slot
    just below a page boundary opens its next page within the chunk."""
    kw = dict(n_shards=2, page_size=8)
    for spec in (None, 1, 4, 8):
        for live, cand in (([8], 8), ([7, 15], 9), ([0, 3, 30], 17)):
            assert tbalance.admission_score(live, cand, spec_tokens=spec, **kw) == \
                jbalance.admission_score(live, cand, spec_tokens=spec, **kw)
    assert tbalance.admission_score([8], 8, spec_tokens=8, **kw) != \
        tbalance.admission_score([8], 8, **kw)
