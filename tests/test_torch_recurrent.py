"""PyTorch port, the recurrent mixers against the JAX package (``impl="ref"``)
on the CPU: mamba2 (``models/ssm.py``) and xLSTM's mLSTM and sLSTM
(``models/xlstm.py``) function by function, then the reduced zamba2 hybrid
(the reference's own hybrid test config: mamba2, mamba2, attention; at
head_dim 80, zamba2's) and the reduced xlstm-125m (mlstm, mlstm, slstm,
mlstm) through the lockstep steps and the engines.

Weights are made with numpy from a seed in the layout of JAX's
``M.init_params`` (its shapes, dtypes and scales; its constant leaves:
A_log 0, D 1, b_if (0, 3), norms 0), with no JAX init to compile, and
bridged to the port. Tolerances
(EXPERIMENTS.md:250-266): the functions 1e-5 (f32); logits 2e-4 (f32,
after the whole stack); engines token for token. A slot without tokens in
a chunk (an inactive slot, or the tail past its chunk length) keeps its
state bit for bit. Each JAX program is built once per module: one JAX
engine run a config, to which every engine mode of the port is held (the
reference's own tests hold its packed, chunked and tiered traces equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro.runtime import serve as jserve
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core import cache as cachelib
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.serving.engine import Engine, Request, _reset_slot
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

FN_TOL = 1e-5
LOGIT_TOL = 2e-4
ZAMBA, XLSTM = "zamba2-2.7b", "xlstm-125m"
HYBRID = dict(mixer_pattern=("mamba2", "mamba2", "attention"), num_layers=3)
# a small local window and select budget, so that the tiered engine spills
NARROW = dict(local=8, select_budget=16)
CAP, BUCKETS = 64, [16, 40]
TIER_COUNTERS = ("tier_hits", "tier_misses", "tier_spills", "tier_fills",
                 "tier_prefetch", "tier_fill_batches", "tier_spill_batches",
                 "tier_gather_batches", "tier_batch_pages_max")


# leaves the reference initialises to constants, by name
_CONST = {"A_log": 0.0, "D": 1.0, "dt_bias": 0.0, "b": 0.0, "conv_bx": 0.0, "conv_bB": 0.0,
          "conv_bC": 0.0, "norm_w": 0.0, "ln1": 0.0, "ln2": 0.0, "final_norm": 0.0}


def numpy_params(jcfg, seed: int = 0, dtype=jnp.float32):
    """A parameter tree of ``JM.init_params(jcfg, key, dtype)``'s structure,
    shapes and dtypes (``jax.eval_shape``: traced, not compiled), filled
    from a numpy seed at the init's scales: dense weights normal / sqrt(fan
    in), convs 0.1, sLSTM's r 1 / sqrt(P), embeddings 0.02 (and w_if, as
    the init's 0.02), the constant leaves as the init sets them."""
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0), dtype))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in _CONST:
            a = np.full(sd.shape, _CONST[name], np.float32)
        elif name == "b_if":
            h = sd.shape[-1] // 2
            a = np.broadcast_to(np.r_[np.zeros(h), 3.0 * np.ones(h)], sd.shape)
        else:
            scale = {"embed": 0.02, "w_if": 0.02, "conv_x": 0.1, "conv_B": 0.1,
                     "conv_C": 0.1}.get(name, 1.0 / np.sqrt(sd.shape[-2]))
            a = rng.standard_normal(sd.shape) * scale
        return jnp.asarray(np.asarray(a, np.float32).astype(sd.dtype))  # cast in numpy

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _both(name, **overrides):
    return (jconfigs.reduced(jconfigs.get_arch(name), **overrides),
            tconfigs.reduced(tconfigs.get_arch(name), **overrides))


def _narrow(cfg):
    return dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal, **NARROW))


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _close(got, want, tol=FN_TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=0,
                               err_msg=msg)


def _state_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k], msg=k)


def _workload(cfg, cls):
    """5 requests of bucketed prompts (16 or 40 tokens) and budgets of 3-8
    tokens: on 2 or 4 slots, slots churn."""
    rng = np.random.default_rng(2)
    return [cls(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=(int(rng.choice(BUCKETS)),)
                                           ).astype(np.int32),
                max_new=int(rng.integers(3, 9))) for i in range(5)]


class Model:
    """A reduced config on both sides, on the same weights; the JAX engine
    runs once (``ENGINE``) and is kept."""

    def __init__(self, name, engine, **overrides):
        self.jcfg, self.tcfg = _both(name, **overrides)
        if self.tcfg.h2eal.enabled:
            self.jcfg, self.tcfg = _narrow(self.jcfg), _narrow(self.tcfg)
        self.jparams = numpy_params(self.jcfg)
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.tparams = params_from_numpy(self.tcfg, self.tree, "cpu")
        self.engine_kw = engine
        self._run = None

    def jax_run(self):
        """(tokens per uid, stats) of the JAX engine on ``_workload``."""
        if self._run is None:
            eng = JEngine(self.jcfg, self.jparams, capacity=CAP, prompt_buckets=BUCKETS,
                          **self.engine_kw)
            comps = eng.run(_workload(self.jcfg, JRequest))
            self._run = ({u: c.tokens for u, c in comps.items()}, eng.stats)
        return self._run

    def port_run(self, n=None, **kw):
        """The port's engine on ``_workload`` (its first ``n`` requests: a
        request's tokens do not depend on the others)."""
        eng = Engine(self.tcfg, self.tparams, capacity=CAP, prompt_buckets=BUCKETS,
                     device="cpu", **kw)
        comps = eng.run(_workload(self.tcfg, Request)[:n])
        return {u: c.tokens for u, c in comps.items()}, eng


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: at these sizes more only contend with the other
    test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hybrid():
    # at head_dim 80, zamba2's, so that the plain attention bodies run its
    # width. The JAX engine: chunked, tiered and rebalanced on 4 slots
    # (fused windows would double its compile time; the port's run with
    # them is held to its tokens, which windows leave as they are in both
    # packages)
    m = Model(ZAMBA, dict(max_batch=4, prefill_chunk=8, hot_pages=3, rebalance="retire"),
              head_dim=80, **HYBRID)
    assert m.tcfg.resolved_head_dim == 80
    return m


@pytest.fixture(scope="module")
def xl():
    return Model(XLSTM, dict(max_batch=2, prefill_chunk=8))


_JITS = {}


def _j(fn):
    """``fn`` jitted with the config static, once per module."""
    if fn not in _JITS:
        _JITS[fn] = jax.jit(fn, static_argnums=0)
    return _JITS[fn]


def _x(cfg, *shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,)).astype(
        np.float32)


def _ragged():
    """chunk lengths (3 slots, chunks of 8): a full chunk, a ragged tail, and
    an inactive slot with tokens it must not take."""
    return np.array([8, 5, 6], np.int32), np.array([True, True, False])


# ---------------------------------------------------------------------------
# mamba2
# ---------------------------------------------------------------------------


def _mamba(model):
    p = model.tree["blocks"]["pos0"]["mamba"]
    jp = {k: jnp.asarray(v[0]) for k, v in p.items()}
    return jp, {k: _t(v[0]) for k, v in p.items()}


def test_mamba2_matches_jax(hybrid):
    """150 tokens: two whole SSD chunks of 64 and a padded third, so the
    chunk-to-chunk carry runs, and the final state (SSD and conv history);
    from it a decode step, then one chunk of 8 with ragged lengths and an
    inactive slot, whose state (its conv history gathered at eff = 0) stays
    bit for bit. (Each further unrolled step would add about a second to
    the JAX program's compile.)"""
    cfg_j, cfg_t = hybrid.jcfg, hybrid.tcfg
    jp, tp = _mamba(hybrid)
    x0 = _x(cfg_j, 3, 150)
    steps = _x(cfg_j, 3, 1, seed=1).transpose(1, 0, 2)
    lens, active = _ragged()
    x = _x(cfg_j, 3, 8, seed=2)

    def jax_side(cfg, p, x0, steps, x, lens, active):  # one program for every call
        out = [jssm.mamba2_forward(cfg, p, x0)]
        st = jssm.mamba2_final_state(cfg, p, x0)
        out.append(st)
        for xs in steps:
            y, st = jssm.mamba2_step(cfg, p, st, xs)
            out += [y, st]
        return out + list(jssm.mamba2_prefill_chunk(cfg, p, st, x, chunk_len=lens,
                                                    active=active))

    want = iter(_j(jax_side)(cfg_j, jp, *map(jnp.asarray, (x0, steps, x, lens, active))))
    _close(tssm.mamba2_forward(cfg_t, tp, _t(x0)), next(want))
    tst = tssm.mamba2_final_state(cfg_t, tp, _t(x0))
    _state_close(tst, next(want))
    for i, xs in enumerate(steps):
        ty, tst = tssm.mamba2_step(cfg_t, tp, tst, _t(xs))
        _close(ty, next(want), msg=f"step {i}")
        _state_close(tst, next(want))
    jy, jst2 = next(want), next(want)
    ty, tst2 = tssm.mamba2_prefill_chunk(cfg_t, tp, tst, _t(x), chunk_len=torch.from_numpy(lens),
                                         active=torch.from_numpy(active))
    for b in range(2):  # rows past a slot's chunk length are not compared
        _close(ty[b, :lens[b]], np.asarray(jy)[b, :lens[b]], msg=f"slot {b}")
    _state_close(tst2, jst2)
    for k in tst:
        assert torch.equal(tst2[k][2], tst[k][2]), k


def test_mamba2_gradient_finite_where_the_masked_decay_overflows():
    """One SSD chunk of 256 tokens (zamba2-2.7b's own chunk is 256): above
    the diagonal the log decay G_i - G_j reaches past f32's exp range, and
    the reference's ``where(causal, exp(logw), 0)`` passes 0 * inf = NaN
    to dt's leaves in the backward (ROADMAP Queue 3); the port masks the
    exponent first. The forward equals the reference's within 1e-5 and
    every gradient leaf of the port is finite, the reference's NaN on
    ``w_dt``, ``A_log`` and ``dt_bias`` and within 1e-4 relative of the
    port's on every other leaf."""
    jcfg = jconfigs.reduced(jconfigs.get_arch("zamba2-2.7b"))
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=256))
    tcfg = tconfigs.reduced(tconfigs.get_arch("zamba2-2.7b"))
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk=256))
    jp = jssm.init_mamba2(jax.random.PRNGKey(0), jcfg)
    tp = {k: _t(v).requires_grad_(True) for k, v in jp.items()}
    x = _x(jcfg, 1, 256, seed=4)
    loss = lambda y: (y ** 2).sum()
    jg = jax.grad(lambda p: loss(jssm.mamba2_forward(jcfg, p, jnp.asarray(x))))(jp)
    ty = tssm.mamba2_forward(tcfg, tp, _t(x))
    _close(ty, jssm.mamba2_forward(jcfg, jp, jnp.asarray(x)))
    loss(ty).backward()
    nan = {k for k, v in jg.items() if bool(jnp.isnan(v).any())}
    assert nan == {"w_dt", "A_log", "dt_bias"}
    for k, v in tp.items():
        assert bool(torch.isfinite(v.grad).all()), k
        if k not in nan:
            np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                       atol=1e-4 * float(np.abs(np.asarray(jg[k])).max()),
                                       err_msg=k)


# ---------------------------------------------------------------------------
# mLSTM and sLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_forward_step_and_prefill_chunk_match_jax(xl, kind):
    """forward (8 tokens from m = -inf) against the reference's chunk from a
    fresh state with every step taken, two decode steps from its final
    state, then a ragged chunk with an inactive slot, whose state stays bit
    for bit (the masked steps pick the old leaves)."""
    cfg_j, cfg_t = xl.jcfg, xl.tcfg
    pos = 0 if kind == "mlstm" else 2
    assert cfg_t.mixer_pattern[pos] == kind
    p = xl.tree["blocks"][f"pos{pos}"]["xl"]
    jp = {k: jnp.asarray(v[0]) for k, v in p.items()}
    tp = {k: _t(v[0]) for k, v in p.items()}
    tfwd = {"mlstm": txl.mlstm_forward, "slstm": txl.slstm_forward}[kind]
    jstep, tstep = {"mlstm": (jxl.mlstm_step, txl.mlstm_step),
                    "slstm": (jxl.slstm_step, txl.slstm_step)}[kind]
    jchunk, tchunk = {"mlstm": (jxl.mlstm_prefill_chunk, txl.mlstm_prefill_chunk),
                      "slstm": (jxl.slstm_prefill_chunk, txl.slstm_prefill_chunk)}[kind]
    jinit = {"mlstm": jxl.init_mlstm_state, "slstm": jxl.init_slstm_state}[kind]
    x0 = _x(cfg_j, 3, 8)
    full = np.full(3, 8, np.int32)
    steps = _x(cfg_j, 3, 2, seed=1).transpose(1, 0, 2)
    lens, active = _ragged()
    x = _x(cfg_j, 3, 8, seed=2)

    def jax_side(cfg, p, x0, steps, x, lens, active):  # one program for every call
        # a chunk of 8 from a fresh state, every slot full: the reference's
        # packed forward (its masked scan takes every step), its final state
        y, st = jchunk(cfg, p, jinit(cfg, 3), x0, chunk_len=jnp.full(3, 8, jnp.int32),
                       active=jnp.ones(3, bool))
        out = [y, st]
        for xs in steps:
            y, st = jstep(cfg, p, st, xs)
            out += [y, st]
        return out + list(jchunk(cfg, p, st, x, chunk_len=lens, active=active))

    want = iter(jax.jit(jax_side, static_argnums=0)(
        cfg_j, jp, *map(jnp.asarray, (x0, steps, x, lens, active))))
    jy, jst = next(want), next(want)
    _close(tfwd(cfg_t, tp, _t(x0)), jy)
    fresh = (txl.init_mlstm_state if kind == "mlstm" else txl.init_slstm_state)(
        cfg_t, 3, device="cpu")
    ty, tst = tchunk(cfg_t, tp, fresh, _t(x0), chunk_len=torch.from_numpy(full))
    _close(ty, jy)
    _state_close(tst, jst)
    for i, xs in enumerate(steps):
        ty, tst = tstep(cfg_t, tp, tst, _t(xs))
        _close(ty, next(want), msg=f"step {i}")
        _state_close(tst, next(want))
    jy, jst2 = next(want), next(want)
    ty, tst2 = tchunk(cfg_t, tp, tst, _t(x), chunk_len=torch.from_numpy(lens),
                      active=torch.from_numpy(active))
    for b in range(2):
        _close(ty[b, :lens[b]], np.asarray(jy)[b, :lens[b]], msg=f"slot {b}")
    _state_close(tst2, jst2)
    for k in tst:
        assert torch.equal(tst2[k][2], tst[k][2]), k


# ---------------------------------------------------------------------------
# The serve state
# ---------------------------------------------------------------------------


def test_reset_slot_leaves_m_at_minus_inf(xl):
    """Chunked admission's reset writes each field's empty value: the xLSTM
    stabiliser m -inf (the reference's rule), the other leaves 0, and the
    other slots' rows are untouched."""
    state = TM.empty_serve_state(xl.tcfg, 2, capacity=CAP, dtype=torch.float32, device="cpu")
    for layer in state["layers"]:
        for name, t in cachelib.state_fields(layer["xl"]).items():
            t.fill_(3.0)
    _reset_slot(state, 1)
    for layer in state["layers"]:
        st = cachelib.state_fields(layer["xl"])
        assert sorted(st) in (["C", "m", "n"], ["c", "h", "m", "n"])
        for name, t in st.items():
            assert bool((t[1] == (float("-inf") if name == "m" else 0.0)).all()), name
            assert bool((t[0] == 3.0).all()), name
    assert cachelib.empty_fill_value("m") == float("-inf")


def test_decode_step_save_restores_the_recurrent_state(hybrid):
    """A tiered select step is undone before its replay: ``DecodeStepSave``
    keeps each recurrent layer's state whole, so save, a decode step and
    restore leave the state bit for bit."""
    cfg, p = hybrid.tcfg, hybrid.tparams
    state = TM.empty_serve_state(cfg, 2, capacity=CAP, dtype=torch.float32, device="cpu")
    state["length"].fill_(3)
    save = cachelib.DecodeStepSave(state, (), sink=cfg.h2eal.sink)
    before = [t.clone() for layer in state["layers"] if "ssm" in layer
              for t in cachelib.state_fields(layer["ssm"]).values()]
    act = torch.tensor([True, True])
    TM.decode_step(cfg, p, state, torch.tensor([5, 9]), do_select=True, active=act,
                   need_select=act)
    after = [t for layer in state["layers"] if "ssm" in layer
             for t in cachelib.state_fields(layer["ssm"]).values()]
    assert not all(torch.equal(a, b) for a, b in zip(after, before))
    save.restore()
    assert all(torch.equal(a, b) for a, b in zip(after, before))


@pytest.mark.parametrize("name", [ZAMBA, XLSTM])
def test_bridge_round_trip_keeps_the_f32_leaves(name):
    """A bf16 JAX model: every leaf of ``blocks/pos{p}[per]`` is port layer
    per·P + p, bit for bit, in its dtype; A_log, D, dt_bias (mamba2), b_if
    (mLSTM) and b (sLSTM) stay f32, as in the port's own init."""
    jcfg, tcfg = _both(name, **(HYBRID if name == ZAMBA else {}))
    tree = jax.tree.map(np.asarray, numpy_params(jcfg, 3, dtype=jnp.bfloat16))
    layers = params_from_numpy(tcfg, tree, "cpu")["layers"]
    period = len(tcfg.mixer_pattern)
    f32 = {"A_log", "D", "dt_bias", "b_if", "b"}

    def walk(a, t):
        if isinstance(a, dict):
            assert sorted(a) == sorted(t)
            for k in a:
                walk(a[k], t[k])
            return
        assert str(t.dtype).endswith(str(a.dtype))
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))

    for i, layer in enumerate(layers):
        stacked = tree["blocks"][f"pos{i % period}"]
        walk({k: jax.tree.map(lambda v: v[i // period], stacked[k]) for k in stacked}, layer)
        mixer = layer.get("mamba", layer.get("xl"))
        if mixer is not None:
            for k, v in mixer.items():
                assert v.dtype == (torch.float32 if k in f32 else torch.bfloat16), k
    own = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.bfloat16)["layers"]
    for layer, ours in zip(layers, own):
        assert sorted(layer) == sorted(ours)
        for k in ("mamba", "xl"):
            if k in layer:
                assert {n: v.dtype for n, v in layer[k].items()} == \
                    {n: v.dtype for n, v in ours[k].items()}
    # reduced() gives the xLSTM layers a d_ff, so FFNs; zamba2's mamba2 layers none
    assert [("ln2" in layer) for layer in layers] == [
        tcfg.layer_has_ffn(i) for i in range(tcfg.num_layers)]


@pytest.mark.parametrize("name", [ZAMBA, XLSTM])
def test_spec_tokens_raises_as_jax(hybrid, xl, name):
    """Speculative decode needs all-attention mixers: both engines raise the
    same ValueError, and ``verify_forward`` refuses the stack too."""
    m = hybrid if name == ZAMBA else xl
    with pytest.raises(ValueError, match="all-attention mixers") as jerr:
        JEngine(m.jcfg, m.jparams, max_batch=2, capacity=CAP, prompt_buckets=BUCKETS,
                spec_tokens=2)
    with pytest.raises(ValueError, match="all-attention mixers") as terr:
        Engine(m.tcfg, m.tparams, max_batch=2, capacity=CAP, prompt_buckets=BUCKETS,
               spec_tokens=2, device="cpu")
    assert str(terr.value) == str(jerr.value)
    state = TM.empty_serve_state(m.tcfg, 1, capacity=CAP, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="all-attention mixers"):
        TM.verify_forward(m.tcfg, m.tparams, state, torch.zeros((1, 2), dtype=torch.int32),
                          active=torch.ones(1, dtype=torch.bool),
                          need_select=torch.ones(1, dtype=torch.bool))


# ---------------------------------------------------------------------------
# Lockstep and the engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["hybrid", "xlstm"])
def test_lockstep_logits_match_jax(hybrid, xl, case):
    """Prefill logits (2 prompts of 40) and two select decode steps equal
    JAX's to 2e-4 (the reuse steps run in the engines); the hybrid at
    head_dim 80, zamba2's."""
    m = hybrid if case == "hybrid" else xl
    jcfg, tcfg, jparams, tparams = m.jcfg, m.tcfg, m.jparams, m.tparams
    prompts = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    cap = 40 + 2 + jcfg.h2eal.page_size
    scfg = jserve.ServeConfig(capacity=cap, impl="ref")
    jl, jst = jax.jit(jserve.make_prefill(jcfg, scfg))(jparams, jnp.asarray(prompts))
    tl, tst = TM.prefill(tcfg, tparams, torch.from_numpy(prompts), capacity=cap)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    # a select step (without attention a select step is a reuse step)
    selects = (True, True)
    steps = {s: jax.jit(jserve.make_decode_step(jcfg, scfg, do_select=s)) for s in set(selects)}
    for i, sel in enumerate(selects):
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        jl, jst = steps[sel](jparams, jst, jnp.asarray(tok))
        tl, tst = TM.decode_step(tcfg, tparams, tst, torch.from_numpy(tok), do_select=sel)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"decode step {i}")


# chunks of one token take a step a token: 3 requests (on 2 slots) of the 5
ENGINE_CASES = {
    "hybrid-packed": (ZAMBA, dict(max_batch=2)),
    "hybrid-tiered-rebalanced-windows": (ZAMBA, dict(max_batch=4, prefill_chunk=8, hot_pages=3,
                                                     rebalance="retire", decode_window=4)),
    "hybrid-chunk1-coplace": (ZAMBA, dict(max_batch=2, prefill_chunk=1, n=3,
                                          layout="coplace_shmap", shards=2)),
    "xlstm-packed": (XLSTM, dict(max_batch=2)),
    "xlstm-chunk1": (XLSTM, dict(max_batch=2, prefill_chunk=1, n=3)),
    "xlstm-chunk8-windows": (XLSTM, dict(max_batch=2, prefill_chunk=8, decode_window=4)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_jax(hybrid, xl, case):
    """Packed admission, chunks of 1 (the hybrid under coplace_shmap over 2
    stripes) and of 8 with fused windows (the hybrid tiered and rebalanced
    too): the JAX engine's tokens, with slot churn."""
    name, kw = ENGINE_CASES[case]
    m = hybrid if name == ZAMBA else xl
    want, _ = m.jax_run()
    got, eng = m.port_run(**kw)
    assert got == {u: want[u] for u in got}
    assert eng.stats.prefill_chunks > 0 or "prefill_chunk" not in kw


_GSPMD_DEFAULT = {}


@pytest.mark.parametrize("mode", ["packed", "chunked"])
@pytest.mark.parametrize("layout", ["head", "coplace", "interleave"])
@pytest.mark.parametrize("name", [ZAMBA, XLSTM])
def test_gspmd_layouts_match_jax_and_default(hybrid, xl, name, layout, mode):
    """The GSPMD layouts at one rank (the default one-rank mesh): the
    recurrent states placed by rows, the hybrid's attention layer by the
    layout, packed and chunks of 8, on 3 requests on 2 slots: the port's
    default engine's tokens exactly, and the JAX engine's (a request's
    tokens depend neither on the others nor on the admission mode)."""
    m = hybrid if name == ZAMBA else xl
    want, _ = m.jax_run()
    kw = dict(max_batch=2, n=3, prefill_chunk=8 if mode == "chunked" else None)
    if (name, mode) not in _GSPMD_DEFAULT:
        _GSPMD_DEFAULT[(name, mode)] = m.port_run(**kw)[0]
    got, _ = m.port_run(layout=layout, **kw)
    assert got == _GSPMD_DEFAULT[(name, mode)] == {u: want[u] for u in got}


def test_tiered_and_rebalanced_hybrid_matches_jax(hybrid):
    """Tiered residency (3 hot pages a slot) and live migration on
    retirement, chunks of 8, on four slots: JAX's tokens, every tier counter
    and the migrations. A cold miss restores the select step's writes, the
    mamba2 states whole among them, and replays it."""
    want, js = hybrid.jax_run()
    got, eng = hybrid.port_run(**hybrid.engine_kw)
    assert got == want
    for c in TIER_COUNTERS:
        assert getattr(eng.stats, c) == getattr(js, c), c
    assert eng.stats.tier_misses > 0 and eng.stats.tier_spills > 0
    assert eng.stats.migrations == js.migrations > 0
