"""PyTorch port, continuous-batching engine: token traces against the JAX
``Engine(layout="default", impl="ref")`` on the workloads of
tests/test_serving.py, on the same weights, on the CPU.

Tokens must be identical, except from a step where the JAX logits hold a
near-tie (top-2 gap below 1e-3): the two sides sum in different orders,
and on random weights the logits are nearly flat. A slot's trace depends
on its own request alone (the engine's churn invariance), so the JAX
logits of a request are replayed with the lockstep JAX steps, which the
JAX engine matches bit for bit (test_serving.py).

The JAX engines are built once per module and reused across workloads
(``reset_metrics``); their compiles dominate this file's time.
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
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine, Request

CAP = 64
TIE_GAP = 1e-3


class Model:
    """One architecture on both sides: configs, weights, the shared JAX
    engines and the lockstep JAX steps (per capacity) for replays."""

    def __init__(self, name):
        self.jcfg = jconfigs.reduced(jconfigs.get_arch(name))
        self.tcfg = tconfigs.reduced(tconfigs.get_arch(name))
        self.jparams = JM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.tparams = params_from_numpy(
            self.tcfg, jax.tree.map(np.asarray, self.jparams), "cpu")
        self._engines = {}
        self._steps = {}

    def jax_run(self, requests, prefill_chunk=None):
        """Completions and stats of the shared JAX engine (max_batch 2,
        capacity CAP, buckets 16 and 24) for ``requests``."""
        eng = self._engines.get(prefill_chunk)
        if eng is None:
            eng = self._engines[prefill_chunk] = JEngine(
                self.jcfg, self.jparams, max_batch=2, capacity=CAP,
                prompt_buckets=[16, 24], prefill_chunk=prefill_chunk)
        eng.reset_metrics()
        comps = eng.run([JRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new)
                         for r in requests])
        return {u: c.tokens for u, c in comps.items()}, dataclasses.replace(eng.stats)

    def port(self, **kw):
        kw = dict(dict(max_batch=2, capacity=CAP, prompt_buckets=[16, 24],
                       device="cpu"), **kw)
        return Engine(self.tcfg, self.tparams, **kw)

    def jax_replay(self, prompt, n, tokens=None, capacity=CAP):
        """(tokens, logits) of ``n`` tokens for ``prompt`` through the
        lockstep JAX steps at ``capacity``: logits[i] chose tokens[i] (the
        prefill's, then one decode step per token fed). ``tokens`` forces
        the tokens fed; greedy without it."""
        if capacity not in self._steps:
            scfg = jserve.ServeConfig(capacity=capacity, impl="ref")
            self._steps[capacity] = (
                jax.jit(jserve.make_prefill(self.jcfg, scfg)),
                [jax.jit(jserve.make_decode_step(self.jcfg, scfg, do_select=s))
                 for s in (False, True)])
        prefill, steps = self._steps[capacity]
        logits, state = prefill(self.jparams, jnp.asarray(prompt)[None])
        out = [np.asarray(logits[0])]
        toks = []
        w = self.jcfg.h2eal.share_window
        for i in range(n):
            toks.append(int(tokens[i]) if tokens is not None else int(np.argmax(out[-1])))
            if i == n - 1:
                break
            logits, state = steps[i % w == 0](self.jparams, state,
                                              jnp.asarray([toks[-1]], jnp.int32))
            out.append(np.asarray(logits[0]))
        return toks, out

    def assert_same(self, got, want, requests):
        """Traces equal per uid, or equal up to a JAX near-tie."""
        assert sorted(got) == sorted(want)
        prompts = {r.uid: r.prompt for r in requests}
        for uid in sorted(want):
            g, w = list(got[uid]), list(want[uid])
            assert len(g) == len(w), (uid, g, w)
            diff = [i for i, (a, b) in enumerate(zip(g, w)) if a != b]
            if diff:
                logits = self.jax_replay(prompts[uid], len(w), w)[1]
                top2 = np.sort(logits[diff[0]])[-2:]
                assert top2[1] - top2[0] < TIE_GAP, (
                    f"uid {uid} token {diff[0]} differs without a near-tie: "
                    f"{g} vs {w}")


@pytest.fixture(scope="module")
def smollm():
    return Model("smollm-360m")


@pytest.fixture(scope="module")
def llama():
    return Model("llama3-8b")


def _prompt(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)


def _mixed_workload(cfg, *, seed=2, n=5):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=([16, 24][i % 2],)).astype(np.int32),
                    max_new=3 + 2 * i)
            for i in range(n)]


def _tokens(comps):
    return {u: c.tokens for u, c in comps.items()}


def test_admission_retirement_lifecycle(smollm):
    """5 requests through 2 slots: budgets honoured, slots recycled, the
    same tokens as the JAX engine."""
    m = smollm
    reqs = [Request(uid=i, prompt=_prompt(m.tcfg, 16, i), max_new=2 + i)
            for i in range(5)]
    eng = m.port(prompt_buckets=[16])
    comps = eng.run(reqs)
    assert sorted(comps) == [0, 1, 2, 3, 4]
    for i, c in comps.items():
        assert len(c.tokens) == 2 + i
        assert c.finished_step >= c.admitted_step
    assert not eng.batch.active.any() and (eng.batch.uid == -1).all()
    assert eng.stats.admissions == 5 and eng.stats.prefill_chunks == 0
    want, _ = m.jax_run(reqs)
    m.assert_same(_tokens(comps), want, reqs)


def test_engine_matches_lockstep_single(smollm):
    """A single request decodes as the port's lockstep ``generate`` does,
    and as the JAX engine."""
    m = smollm
    prompt, gen = _prompt(m.tcfg, 24, 42), 10
    toks, _ = tlaunch.generate(m.tcfg, m.tparams, torch.from_numpy(prompt)[None],
                               gen=gen, capacity=CAP, device="cpu")
    req = Request(uid=0, prompt=prompt, max_new=gen)
    comps = m.port(max_batch=3).run([req])
    assert comps[0].tokens == toks[0].tolist()
    want, _ = m.jax_run([req])
    m.assert_same(_tokens(comps), want, [req])


def test_active_slot_invariant_to_churn(smollm):
    """Slot A's tokens are unchanged when B and C join and leave mid-flight."""
    m = smollm
    req = Request(uid=0, prompt=_prompt(m.tcfg, 24, 42), max_new=10)
    solo = m.port(max_batch=3).run([req])[0].tokens
    eng = m.port(max_batch=3)
    eng.submit(req)
    steps = 0
    while eng._queue or eng.batch.active.any():
        eng.poll()
        steps += 1
        if steps == 2:
            eng.submit(Request(uid=1, prompt=_prompt(m.tcfg, 16, 7), max_new=3))
        if steps == 5:
            eng.submit(Request(uid=2, prompt=_prompt(m.tcfg, 24, 8), max_new=4))
    eng.finalize()
    assert eng.completions[0].tokens == solo
    assert len(eng.completions[1].tokens) == 3
    assert len(eng.completions[2].tokens) == 4
    want, _ = m.jax_run([req])
    m.assert_same({0: solo}, want, [req])


def test_capacity_truncation(smollm):
    """A budget past capacity retires the slot at the cache boundary: the
    prefill token plus one decode per writable position [s, CAP).

    At the last of those steps the local section of the retrieval heads
    reaches one page past the cache. JAX's gather fills that page with NaN,
    so its logits there are NaN and its last token is 0; the port clamps
    the page and masks it (it holds no position below the capacity), and
    its last token is the one the JAX steps give with a cache one page
    larger."""
    m = smollm
    s = 16
    req = Request(uid=0, prompt=_prompt(m.tcfg, s, 3), max_new=10_000)
    eng = m.port(max_batch=1, prompt_buckets=[s])
    comps = eng.run([req])
    got = comps[0].tokens
    assert len(got) == CAP - s + 1 and eng.batch.lengths[0] == CAP
    want, _ = m.jax_run([req])
    assert not np.isfinite(m.jax_replay(req.prompt, len(want[0]), want[0])[1][-1]).all()
    m.assert_same({0: got[:-1]}, {0: want[0][:-1]}, [req])
    roomy, _ = m.jax_replay(req.prompt, CAP - s + 1,
                            capacity=CAP + m.jcfg.h2eal.page_size)
    m.assert_same({0: got}, {0: roomy}, [req])
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(Request(uid=1, prompt=_prompt(m.tcfg, s, 4), max_new=0))


def test_select_dispatch_rate_matches_jax(smollm):
    """READY slots join at a shared refresh boundary, so the select variant
    runs on about 1/w of the decode steps: the port takes exactly the JAX
    engine's select, reuse and decode steps on the same workload."""
    m = smollm
    w = m.tcfg.h2eal.share_window
    reqs = [Request(uid=i, prompt=_prompt(m.tcfg, [16, 24][i % 2], i), max_new=12)
            for i in range(4)]
    eng = m.port()
    comps = eng.run(reqs)
    s = eng.stats
    assert s.select_steps + s.reuse_steps == s.decode_steps
    assert s.select_steps <= s.decode_steps // w + s.admissions + 1
    want, js = m.jax_run(reqs)
    assert (s.select_steps, s.reuse_steps, s.decode_steps, s.engine_steps) == (
        js.select_steps, js.reuse_steps, js.decode_steps, js.engine_steps)
    m.assert_same(_tokens(comps), want, reqs)


@pytest.mark.parametrize("arch", ["smollm", "llama"])
def test_chunked_prefill_matches_packed_with_churn(arch, request):
    """Chunked admission gives the packed traces at any chunk size, with
    slot churn; both equal the JAX engine's, and the chunked engine takes
    the JAX chunked engine's steps."""
    m = request.getfixturevalue(arch)
    reqs = _mixed_workload(m.tcfg)
    want, _ = m.jax_run(reqs)
    packed = m.port().run(reqs)
    m.assert_same(_tokens(packed), want, reqs)
    for chunk in (3, 8, 64):
        eng = m.port(prefill_chunk=chunk)
        got = eng.run(reqs)
        m.assert_same(_tokens(got), want, reqs)
        assert eng.stats.admissions == len(reqs) and eng.stats.prefill_chunks > 0
        if chunk == 8:
            want8, js = m.jax_run(reqs, prefill_chunk=8)
            m.assert_same(_tokens(got), want8, reqs)
            assert (eng.stats.prefill_chunks, eng.stats.engine_steps,
                    eng.stats.decode_steps) == (js.prefill_chunks, js.engine_steps,
                                                js.decode_steps)


def test_chunked_decode_continues_during_long_prefill(smollm):
    """While a long prompt is fed chunk by chunk, a decoding slot emits one
    token every engine step; packed admission is atomic."""
    m = smollm
    reqs = [Request(uid=0, prompt=_prompt(m.tcfg, 16, 1), max_new=30),
            Request(uid=1, prompt=_prompt(m.tcfg, 24, 2), max_new=3)]

    def serve(prefill_chunk):
        eng = m.port(prefill_chunk=prefill_chunk)
        eng.submit(reqs[0])
        steps = 0
        while eng.busy():
            if steps == 2:
                eng.submit(reqs[1])
            eng.poll()
            steps += 1
        eng.finalize()
        long_c, other = eng.completions[1], eng.completions[0]
        during = sum(1 for es in eng.token_engine_steps(other)
                     if long_c.admitted_engine_step < es < long_c.first_token_step)
        return eng, during

    eng_c, during_c = serve(6)
    eng_p, during_p = serve(None)
    assert during_c >= 2 and during_p == 0
    assert eng_c.stats.prefill_chunks >= 4
    assert _tokens(eng_c.completions) == _tokens(eng_p.completions)
    want, _ = m.jax_run(reqs)
    m.assert_same(_tokens(eng_c.completions), want, reqs)


def test_chunked_prefill_validation(smollm):
    """Chunked mode refuses a prompt that leaves no room to decode, and
    takes a length outside the buckets."""
    m = smollm
    eng = m.port(max_batch=1, prompt_buckets=[16], prefill_chunk=4)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(Request(uid=0, prompt=_prompt(m.tcfg, CAP, 0), max_new=1))
    req = Request(uid=1, prompt=_prompt(m.tcfg, 13, 1), max_new=2)
    comps = eng.run([req])
    assert len(comps[1].tokens) == 2
    assert eng.stats.prefill_chunks == 4  # ceil(13 / 4)
    want, _ = m.jax_run([req], prefill_chunk=8)
    m.assert_same(_tokens(comps), want, [req])
    packed = m.port(max_batch=1, prompt_buckets=[16])
    with pytest.raises(ValueError, match="buckets"):
        packed.submit(req)


@pytest.mark.parametrize("kw,what", [
    (dict(hot_pages=4), "hot_pages"), (dict(spec_tokens=2), "spec_tokens"),
    (dict(rebalance="retire"), "rebalance"), (dict(decode_window=2), "decode_window"),
    (dict(layout="head"), "layout"), (dict(layout="interleave"), "layout"),
])
def test_unsupported_engine_options_raise(smollm, kw, what):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        smollm.port(**kw)


def test_sampling_and_the_card_default_raise(smollm):
    eng = smollm.port()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.submit(Request(uid=0, prompt=_prompt(smollm.tcfg, 16, 0), max_new=2,
                           temperature=0.7))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            smollm.port(device=None)


def test_engine_counts_no_launch_on_the_cpu(llama):
    ops.reset_launches()
    llama.port(prefill_chunk=5).run(_mixed_workload(llama.tcfg, n=3))
    assert set(ops.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("chunk", ["0", "8"])
def test_ragged_cli_runs_on_the_cpu(chunk, capsys):
    stats = tlaunch.main([
        "--arch", "llama3-8b", "--reduced", "--workload", "ragged", "--requests", "4",
        "--max-batch", "2", "--prompt-buckets", "16,24", "--gen-min", "2",
        "--gen-max", "6", "--prefill-chunk", chunk, "--device", "cpu"])
    assert stats["decode_steps"] > 0 and 0.0 < stats["occupancy"] <= 1.0
    assert stats["admissions"] == 4
    assert (stats["prefill_chunks"] > 0) == (chunk != "0")
    assert "workload=ragged" in capsys.readouterr().out
