"""PyTorch port, the MoE family against the JAX package (``impl="ref"``) on
the CPU: ``models/moe.py`` alone, then qwen3-moe-235b-a22b reduced with 32
query heads over 2 kv heads (a GQA group of 16, qwen3-moe's own; head_dim
32, 4 experts, top-2) through the lockstep steps and the engines, and
kimi-k2's shared expert.

Weights are JAX's ``init_moe`` / ``M.init_params``, bridged through numpy.
Tolerances (EXPERIMENTS.md:250-266): ``moe_ffn`` 1e-5 (f32); logits 2e-4
(f32, after the whole stack); engines token for token. The reduced
configs are dropless (capacity factor 0), where capacity decides nothing,
so the cases that must drop set the factor themselves: the reference's
rule for an overflowing expert (its last write into slot capacity-1 is a
dropped entry's zero row) and the token set each step routes (padded and
idle rows count toward capacity) only show there. Each JAX program is
compiled once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.runtime import serve as jserve
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.serving.engine import Engine, Request
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

MOE_TOL = 1e-5
LOGIT_TOL = 2e-4
QWEN = "qwen3-moe-235b-a22b"
KIMI = "kimi-k2-1t-a32b"
GROUP16 = dict(num_heads=32, num_kv_heads=2)
CAP, BUCKETS = 64, [40]
ENGINE_H2 = dict(share_window=4)


def _moe(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def _h2(cfg, **kw):
    return dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal, **kw))


def _both(name, factor=None, **overrides):
    j = jconfigs.reduced(jconfigs.get_arch(name), **overrides)
    t = tconfigs.reduced(tconfigs.get_arch(name), **overrides)
    return (j, t) if factor is None else (_moe(j, factor), _moe(t, factor))


def _layer_params(jcfg, seed=0):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, p)
    return p, {k: (tensor_from_numpy(v, "cpu") if not isinstance(v, dict) else
                   {kk: tensor_from_numpy(vv, "cpu") for kk, vv in v.items()})
               for k, v in tree.items()}


def _jax_moe(jcfg, jp, x):
    return np.asarray(jax.jit(lambda p, x: jmoe.moe_ffn(jcfg, p, x))(jp, jnp.asarray(x)))


def _np_moe(cfg, p, x, last_write_wins):
    """The reference's dispatch in float64 numpy, entry by entry: with
    ``last_write_wins`` the dropped entries' zero rows land in slot cap-1
    after the kept one, as the reference's scatter leaves them; without,
    slot cap-1 keeps its entry. Returns (out, per-expert counts, cap)."""
    m = cfg.moe
    t, d = x.shape
    e, k = m.num_experts, m.top_k
    logits = x.astype(np.float64) @ np.asarray(p["router"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    w = np.take_along_axis(probs, ids, -1)
    w /= w.sum(-1, keepdims=True)
    cap = jmoe._capacity(t, e, k, m.capacity_factor)
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=e)
    starts = np.cumsum(counts) - counts
    sorted_ids = flat[order]
    slots = np.arange(t * k) - starts[sorted_ids]
    buf = np.zeros((e, cap, d))
    for i in range(t * k):
        if slots[i] < cap:
            buf[sorted_ids[i], slots[i]] = x[order[i] // k]
        elif last_write_wins:
            buf[sorted_ids[i], cap - 1] = 0.0
    wg, wu, wd = (np.asarray(p[n], np.float64) for n in ("w_gate", "w_up", "w_down"))
    g = np.einsum("ecd,edf->ecf", buf, wg)
    a = g / (1.0 + np.exp(-g)) * np.einsum("ecd,edf->ecf", buf, wu)
    y_buf = np.einsum("ecf,efd->ecd", a, wd)
    out = np.zeros((t, d))
    for i in range(t * k):
        if slots[i] < cap:
            out[order[i] // k] += w.reshape(-1)[order[i]] * y_buf[sorted_ids[i], slots[i]]
    return out, counts, cap


def test_moe_ffn_dropless_and_all_tie_row():
    """Dropless (the reduced config), (B, S, d) and (B, d) inputs, a row of
    zeros among them: its router logits are all 0, every expert ties, and
    the top-k takes the lowest ids as ``lax.top_k`` does."""
    jcfg, tcfg = _both(QWEN, **GROUP16)
    jp, tp = _layer_params(jcfg)
    x = np.random.default_rng(0).standard_normal((2, 24, 128)).astype(np.float32)
    x[1, 5] = 0.0
    np.testing.assert_allclose(tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x)).numpy(),
                               _jax_moe(jcfg, jp, x), atol=MOE_TOL, rtol=0)
    x1 = x[:, 5]  # the decode shape (B, d)
    np.testing.assert_allclose(tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x1)).numpy(),
                               _jax_moe(jcfg, jp, x1), atol=MOE_TOL, rtol=0)
    probs, _, ids = tmoe._route(tcfg, tp, torch.zeros(1, 128))
    assert torch.all(probs == probs[0, 0])
    assert ids[0].tolist() == list(range(tcfg.moe.top_k))


def test_moe_ffn_overflow_drops_slot_cap_minus_one_as_the_reference():
    """Capacity factor 0.25 at 64 tokens (cap 16 for 128 entries over 4
    experts): experts overflow, and the reference's zero row overwrites the
    kept entry in slot cap-1 of each overflowing expert. The reference
    follows that rule (against a float64 model with and without it), and
    the port equals the reference."""
    jcfg, tcfg = _both(QWEN, 0.25, **GROUP16)
    jp, tp = _layer_params(jcfg, seed=3)
    x = np.random.default_rng(3).standard_normal((64, 128)).astype(np.float32)
    want = _jax_moe(jcfg, jp, x)
    tree = jax.tree.map(np.asarray, jp)
    with_rule, counts, cap = _np_moe(jcfg, tree, x, last_write_wins=True)
    without, _, _ = _np_moe(jcfg, tree, x, last_write_wins=False)
    assert cap == 16 and counts.max() > cap
    np.testing.assert_allclose(want, with_rule, atol=MOE_TOL, rtol=0)
    assert np.abs(want - without).max() > 1e-2  # the rule decides the result
    got = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=MOE_TOL, rtol=0)


# f32's unit roundoff; gamma(n) bounds the relative error of an f32 sum of n
# products in any order (Higham, Accuracy and Stability, Lemma 3.1)
U32 = 2.0 ** -24


def _gamma(n: int) -> float:
    return n * U32 / (1 - n * U32)


def _np_moe_bound(cfg, p, x):
    """The reference's dispatch in float64 (slot cap-1 of an overflowing
    expert a zero row, as ``_np_moe`` with ``last_write_wins``) and, per
    output element, a bound on how far an f32 evaluation in any summation
    order may lie from it, to first order in U32:

      * g = b·W_gate, v = b·W_up over d: |dg| <= gamma(d) (|b|·|W_gate|),
        likewise dv;
      * h = silu(g)·v, |silu'| <= 1.1, silu and the product rounded within
        5 U32: |dh| <= 1.1 |dg| |v| + |silu(g)| |dv| + 5 U32 |h|;
      * y = h·W_down over d_ff: |dy| <= gamma(d_ff) (|h|·|W_down|) + |dh|·|W_down|;
      * the router: logits over d off by at most dl = gamma(d) max(|x|·|R|),
        so a softmax probability and its top-k renormalised weight w are off
        by at most (4 dl + (2E + K + 8) U32) |w|;
      * out = sum over the K kept entries of w·y: |dout| <= sum (|w| |dy| +
        |dw| |y|) + gamma(K) sum |w y|.

    Returns (out, bound), both (T, d). Rows whose every entry dropped are 0
    on both sides, with bound 0."""
    m = cfg.moe
    t, d = x.shape
    e, k = m.num_experts, m.top_k
    x64 = x.astype(np.float64)
    r = np.asarray(p["router"], np.float64)
    logits = x64 @ r
    dl = _gamma(d) * (np.abs(x64) @ np.abs(r)).max(-1)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    w = np.take_along_axis(probs, ids, -1)
    w /= w.sum(-1, keepdims=True)
    rel_w = 4 * dl + (2 * e + k + 8) * U32
    cap = jmoe._capacity(t, e, k, m.capacity_factor)
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=e)
    sorted_ids = flat[order]
    slots = np.arange(t * k) - (np.cumsum(counts) - counts)[sorted_ids]
    tok, wflat = order // k, w.reshape(-1)[order]
    keep = (slots < cap) & ~((slots == cap - 1) & (counts[sorted_ids] > cap))
    out, err, mag = np.zeros((t, d)), np.zeros((t, d)), np.zeros((t, d))
    f = p["w_gate"].shape[-1]
    for ex in range(e):
        sel = np.nonzero(keep & (sorted_ids == ex))[0]
        b = x64[tok[sel]]
        wg, wu, wd = (np.asarray(p[n][ex], np.float64) for n in ("w_gate", "w_up", "w_down"))
        g, v = b @ wg, b @ wu
        sg = g / (1 + np.exp(-g))
        h = sg * v
        dh = (1.1 * _gamma(d) * (np.abs(b) @ np.abs(wg)) * np.abs(v)
              + np.abs(sg) * _gamma(d) * (np.abs(b) @ np.abs(wu)) + 5 * U32 * np.abs(h))
        y = h @ wd
        dy = _gamma(f) * (np.abs(h) @ np.abs(wd)) + dh @ np.abs(wd)
        ww = wflat[sel][:, None]
        np.add.at(out, tok[sel], ww * y)
        np.add.at(err, tok[sel], ww * dy + rel_w[tok[sel]][:, None] * ww * np.abs(y))
        np.add.at(mag, tok[sel], ww * np.abs(y))
    return out, err + _gamma(k) * mag


def test_moe_ffn_chunks_decide_capacity():
    """131072 tokens at factor 1.25: two chunks of MOE_CHUNK_TOKENS, each
    with its own capacity (40968). The first half of the tokens leans to
    expert 0 and the second to expert 1, so each chunk's favourite
    overflows its chunk's capacity, which one pass over all the tokens
    (capacity 81928) would not: the port equals the reference, and differs
    from the unchunked pass.

    "Equals" is held to f32 rounding, not to a fixed 1e-5: both packages
    and a float64 model of the chunked dispatch (``_np_moe_bound``) are
    compared element by element. Each package lies within the derived bound
    of the float64 model, so the two within twice it (each package's
    products may sum in another order on another CPU: on one 8-core
    machine JAX's output lay 1.37e-5 from float64 at a value of 9.38, the
    port's 8.9e-6). The unchunked pass drops other entries: millions of
    elements lie further from the port than twice the bound."""
    jcfg, tcfg = _both(QWEN, 1.25, **GROUP16)
    jp, tp = _layer_params(jcfg, seed=5)
    t, half = 2 * tmoe.MOE_CHUNK_TOKENS, tmoe.MOE_CHUNK_TOKENS
    router = np.asarray(jp["router"])
    lean = router[:, :2] / np.linalg.norm(router[:, :2], axis=0)
    x = np.random.default_rng(5).standard_normal((t, 128)).astype(np.float32)
    x[:half] += 20 * lean[:, 0]
    x[half:] += 20 * lean[:, 1]
    want = _jax_moe(jcfg, jp, x)
    got = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x)).numpy()
    tree = jax.tree.map(np.asarray, jp)
    chunks = [_np_moe_bound(jcfg, tree, xc) for xc in (x[:half], x[half:])]
    exact = np.concatenate([c[0] for c in chunks])
    bound = np.concatenate([c[1] for c in chunks])
    for name, side in (("jax", want), ("port", got)):
        off = np.abs(side - exact) > bound
        assert not off.any(), (name, int(off.sum()))
    assert not (np.abs(got - want) > 2 * bound).any()
    assert tmoe._capacity(half, 4, 2, 1.25) == 40968
    whole = tmoe._moe_ffn_flat(tcfg, tp, torch.from_numpy(x)).numpy()
    assert (np.abs(whole - got) > 2 * bound).sum() > 1_000_000


def test_kimi_shared_expert_matches_jax():
    """kimi-k2's shared expert (a SwiGLU over every token beside the
    routed ones), at factor 1.25 with drops: equal to the reference."""
    jcfg, tcfg = _both(KIMI, 1.25)
    assert tcfg.moe.shared_expert_ff == 64
    jp, tp = _layer_params(jcfg, seed=7)
    assert set(tp["shared"]) == {"w_gate", "w_up", "w_down"}
    x = np.random.default_rng(7).standard_normal((3, 20, 128)).astype(np.float32)
    np.testing.assert_allclose(tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x)).numpy(),
                               _jax_moe(jcfg, jp, x), atol=MOE_TOL, rtol=0)


def test_aux_load_balance_loss_matches_jax():
    jcfg, tcfg = _both(QWEN, **GROUP16)
    jp, tp = _layer_params(jcfg, seed=9)
    x = np.random.default_rng(9).standard_normal((2, 30, 128)).astype(np.float32)
    want = float(jmoe.aux_load_balance_loss(jcfg, jnp.asarray(x), jp))
    got = tmoe.aux_load_balance_loss(tcfg, torch.from_numpy(x), tp).item()
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("name", [QWEN, KIMI])
def test_init_params_moe_leaves(name):
    """The port's own init: an MoE layer holds ``moe`` (no ``ffn``), the
    JAX shapes, the router in f32 in a bf16 model, kimi's shared expert."""
    cfg = tconfigs.reduced(tconfigs.get_arch(name))
    p = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.bfloat16)
    m = p["layers"][0]["moe"]
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    assert "ffn" not in p["layers"][0]
    assert m["router"].dtype == torch.float32 and m["router"].shape == (d, e)
    assert (m["w_gate"].shape, m["w_up"].shape, m["w_down"].shape) == (
        (e, d, f), (e, d, f), (e, f, d))
    assert m["w_gate"].dtype == torch.bfloat16
    assert ("shared" in m) == (name == KIMI)


class Model:
    """qwen3-moe reduced with a GQA group of 16 on both sides, on the same
    weights; the JAX programs are built once per config and kept."""

    def __init__(self):
        self.jcfg, self.tcfg = _both(QWEN, **GROUP16)
        self.jparams = JM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.tparams = params_from_numpy(self.tcfg, self.tree, "cpu")
        self._runs = {}

    def cfgs(self, factor=None, **h2):
        j, t = self.jcfg, self.tcfg
        if factor is not None:
            j, t = _moe(j, factor), _moe(t, factor)
        if h2:
            j, t = _h2(j, **h2), _h2(t, **h2)
        return j, t

    def jax_run(self, reqs, factor=None, **kw):
        key = (factor, tuple(sorted(kw.items())),
               tuple((r.uid, len(r.prompt), r.max_new) for r in reqs))
        if key not in self._runs:
            jcfg, _ = self.cfgs(factor, **ENGINE_H2)
            eng = JEngine(jcfg, self.jparams, **dict(dict(
                max_batch=2, capacity=CAP, prompt_buckets=BUCKETS), **kw))
            comps = eng.run([JRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new)
                             for r in reqs])
            self._runs[key] = ({u: c.tokens for u, c in comps.items()}, eng.stats)
        return self._runs[key]

    def port(self, factor=None, **kw):
        _, tcfg = self.cfgs(factor, **ENGINE_H2)
        return Engine(tcfg, self.tparams, **dict(dict(
            max_batch=2, capacity=CAP, prompt_buckets=BUCKETS, device="cpu"), **kw))


@pytest.fixture(scope="module")
def qwen():
    return Model()


def test_bridge_carries_kimi_shared_expert():
    """kimi-k2's shared expert crosses the bridge with the routed ones."""
    jcfg, tcfg = _both(KIMI)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(2)))
    layers = params_from_numpy(tcfg, tree, "cpu")["layers"]
    stacked = tree["blocks"]["pos0"]["moe"]["shared"]
    for i, layer in enumerate(layers):
        for name, t in layer["moe"]["shared"].items():
            np.testing.assert_array_equal(t.numpy(), stacked[name][i])


def test_reduced_config_has_group_16(qwen):
    cfg = qwen.tcfg
    assert cfg.num_heads // cfg.num_kv_heads == 16 and cfg.resolved_head_dim == 32
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor) == (4, 2, 0.0)


def test_bridge_round_trip(qwen):
    """Every MoE leaf of ``blocks/pos0[i]`` is port layer i, bit for bit, in
    its dtype (the router f32); nothing is left over."""
    layers = qwen.tparams["layers"]
    assert len(layers) == qwen.tcfg.num_layers == 2
    stacked = qwen.tree["blocks"]["pos0"]
    for i, layer in enumerate(layers):
        assert sorted(layer) == sorted(stacked)
        assert sorted(layer["moe"]) == ["router", "w_down", "w_gate", "w_up"]
        for name, t in layer["moe"].items():
            a = stacked["moe"][name][i]
            assert str(t.dtype).endswith(str(a.dtype))
            np.testing.assert_array_equal(t.numpy(), a)
    assert layers[0]["moe"]["w_gate"].shape == (4, 128, 256)


def test_prefill_and_decode_logits_match_jax(qwen):
    """At capacity factor 0.25: prefill logits (2 prompts of 40: 80 tokens,
    which overflow their experts) and 4 decode steps (select and reuse)
    equal JAX's to 2e-4."""
    jcfg, tcfg = qwen.cfgs(0.25)
    prompts = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    cap = 40 + 4 + jcfg.h2eal.page_size
    scfg = jserve.ServeConfig(capacity=cap, impl="ref")
    jl, jst = jax.jit(jserve.make_prefill(jcfg, scfg))(qwen.jparams, jnp.asarray(prompts))
    tl, tst = TM.prefill(tcfg, qwen.tparams, torch.from_numpy(prompts), capacity=cap)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    steps = [jax.jit(jserve.make_decode_step(jcfg, scfg, do_select=s)) for s in (False, True)]
    for i in range(4):
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        jl, jst = steps[i % 2 == 0](qwen.jparams, jst, jnp.asarray(tok))
        tl, tst = TM.decode_step(tcfg, qwen.tparams, tst, torch.from_numpy(tok),
                                 do_select=i % 2 == 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"decode step {i}")


def _packed_workload(cfg):
    """Prompts of BUCKETS[0] tokens (the packed admission's one bucket),
    budgets 3, 5, ...; 5 requests on 2 slots, so slots churn."""
    rng = np.random.default_rng(2)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=(BUCKETS[0],)
                                               ).astype(np.int32), max_new=3 + 2 * i)
            for i in range(5)]


def _chunked_workload(cfg):
    """Prompts of 10-39 tokens, budgets 3-13; 6 requests on 4 slots."""
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=(
        int(rng.integers(10, 40)),)).astype(np.int32), max_new=int(rng.integers(3, 14)))
        for i in range(6)]


CHUNKED = dict(max_batch=4, prefill_chunk=16)


def _tokens(eng, reqs):
    return {u: c.tokens for u, c in eng.run(reqs).items()}


def test_packed_engine_matches_jax(qwen):
    """Prefill-then-pack with slot churn, dropless: the JAX engine's tokens
    and step counts."""
    reqs = _packed_workload(qwen.tcfg)
    want, js = qwen.jax_run(reqs)
    eng = qwen.port()
    assert _tokens(eng, reqs) == want
    s = eng.stats
    assert (s.decode_steps, s.select_steps) == (js.decode_steps, js.select_steps)


def test_chunked_engine_with_fused_windows_matches_jax_at_capacity(qwen):
    """Chunked prefill on 4 slots at capacity factor 0.25, with fused
    windows (decode_window=4, the card's captured dispatch; on the CPU it
    runs eagerly): a chunk step's 4 slots x 16 rows (the rows of slots that
    take no chunk, and padded rows, too) overflow their capacity of 16, so
    the rows routed decide the tokens. The JAX fused engine's tokens and
    decode steps. A fused window computes the chunk rows of the slots that
    are not prefilling otherwise than the per-step mixed step does (and
    runs its chunk half on iterations with no prefill), so at capacity the
    per-step engine's tokens differ, the port's as the reference's."""
    reqs = _chunked_workload(qwen.tcfg)
    want, js = qwen.jax_run(reqs, 0.25, decode_window=4, **CHUNKED)
    eng = qwen.port(0.25, decode_window=4, **CHUNKED)
    assert _tokens(eng, reqs) == want
    assert eng.stats.decode_steps == js.decode_steps and eng.stats.fused_windows > 0
    assert _tokens(qwen.port(0.25, **CHUNKED), reqs) != want


_GSPMD_DEFAULT = {}


@pytest.mark.parametrize("mode", ["packed", "chunked"])
@pytest.mark.parametrize("layout", ["head", "coplace", "interleave"])
def test_gspmd_layouts_match_jax_and_default(qwen, layout, mode):
    """The GSPMD layouts at one rank (the default one-rank mesh), packed and
    chunked (chunks of 16), dropless, on 3 requests of the packed workload:
    the port's default engine's tokens exactly, and the JAX packed engine's
    (a request's tokens depend neither on the others nor on the admission
    mode, in the reference as here)."""
    reqs = _packed_workload(qwen.tcfg)
    want, _ = qwen.jax_run(reqs)
    kw = {} if mode == "packed" else dict(prefill_chunk=16)
    if mode not in _GSPMD_DEFAULT:
        _GSPMD_DEFAULT[mode] = _tokens(qwen.port(**kw), reqs[:3])
    got = _tokens(qwen.port(layout=layout, **kw), reqs[:3])
    assert got == _GSPMD_DEFAULT[mode] == {u: want[u] for u in got}
