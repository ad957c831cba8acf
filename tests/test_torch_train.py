"""Training in the PyTorch port against the JAX reference on the CPU.

AdamW, gradient compression, the seekable data stream, checkpoints, the
plain attention backward, ``lm_loss`` with every leaf's gradient for each
family the port trains, and ``make_train_step``, each held to the JAX
package (``impl="ref"``) on the same inputs; then the port's own
crash-and-resume exactness through its training CLI (the reference's
``test_crash_resume_exactness`` fails on its mesh, ROADMAP Queue 3).
Each JAX program is compiled once a module; weights are numpy draws in
JAX's init layout (``test_torch_recurrent.numpy_params``).
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro import configs as jconfigs
from repro.data import lm_batch as jlm_batch
from repro.data import niah_batch as jniah_batch
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.runtime import train as jtrain
from repro_torch import ckpt
from repro_torch import configs as tconfigs
from repro_torch.core.tree import leaves, leaves_with_paths
from repro_torch.data import lm_batch, niah_batch
from repro_torch.kernels import ops as tops, ref as tref
from repro_torch.launch import train as train_cli
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw, grad_compress
from repro_torch.runtime import train as ttrain
from test_torch_recurrent import numpy_params
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
            vocab_size=256, head_dim=16)  # tests/test_system.py's tiny config
OPT_TOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
PARAM_TOL = 1e-5


def _both(name, **overrides):
    return (jconfigs.reduced(jconfigs.get_arch(name), **overrides),
            tconfigs.reduced(tconfigs.get_arch(name), **overrides))


def _capacity(cfgs, factor):
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=factor))
                 for c in cfgs)


# one tiny config per family the port trains
FAMILIES = {
    "dense": lambda: _both("smollm-360m", **TINY),
    "gemma3_window": lambda: _both("gemma3-1b", local_window=8),
    "moe_cf025": lambda: _capacity(_both("qwen3-moe-235b-a22b"), 0.25),
    "zamba2": lambda: _both("zamba2-2.7b", mixer_pattern=("mamba2", "mamba2", "attention"),
                            num_layers=3),
    "xlstm": lambda: _both("xlstm-125m"),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tokens(vocab, b=2, s=16, seed=0):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    lab[:, -1] = -100
    return tok, lab


# ---------------------------------------------------------------------------
# AdamW and gradient compression
# ---------------------------------------------------------------------------


def _trees(seed):
    """A parameter-shaped numpy tree (dicts and a list, f32 and bf16-free) and
    three gradient trees of its structure."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (7, 5), "layers": [{"w": (5, 3), "b": (3,)}, {"w": (3, 5)}],
              "final_norm": (5,)}

    def draw(scale):
        return jax.tree.map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
                            shapes, is_leaf=lambda x: isinstance(x, tuple))
    return draw(1.0), [draw(3.0) for _ in range(3)]


def _close_tree(port_tree, jax_tree, tol, what):
    for (path, got), want in zip(leaves_with_paths(port_tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=0, err_msg=f"{what} {path}")


# the JAX optimizer and compression, jitted: one compile a shape of the
# whole function, where eager dispatch compiles each of its operations a shape
j_apply = jax.jit(jadamw.apply_updates, static_argnums=(3,))
j_clip = jax.jit(jadamw.clip_by_global_norm, static_argnums=(1,))
j_schedule = jax.jit(jadamw.cosine_schedule, static_argnames=("warmup", "total"))
j_to_bf16 = jax.jit(jgc.to_bf16)
j_quantize = jax.jit(jgc.quantize_int8)
j_init_feedback = jax.jit(jgc.init_error_feedback)
j_feedback = jax.jit(jgc.compress_with_feedback)
j_dequantize = jax.jit(jgc.dequantize_int8)


def test_adamw_matches_jax():
    """apply_updates over 3 steps (the gradients' norm far above the clip),
    global_norm, clip_by_global_norm and cosine_schedule, to 1e-6."""
    p_np, grads = _trees(0)
    cfg_j, cfg_t = jadamw.AdamWConfig(lr=1e-2), adamw.AdamWConfig(lr=1e-2)
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = jax.tree.map(_t, p_np)
    sj, st = jadamw.init_state(pj), adamw.init_state(pt)
    assert st["mu"]["layers"][0]["w"].dtype == torch.float32
    for i, g in enumerate(grads):
        scale = float(j_schedule(jnp.int32(i + 3), warmup=2, total=10))
        scale_t = adamw.cosine_schedule(i + 3, warmup=2, total=10)
        np.testing.assert_allclose(scale_t.item(), scale, rtol=0, atol=OPT_TOL)
        pj, sj, nj = j_apply(pj, jax.tree.map(jnp.asarray, g), sj, cfg_j,
                             lr_scale=jnp.float32(scale))
        pt, st, nt = adamw.apply_updates(pt, jax.tree.map(_t, g), st, cfg_t,
                                         lr_scale=scale_t)
        assert float(nj) > cfg_j.clip_norm  # the clip acts
        np.testing.assert_allclose(nt.item(), float(nj), rtol=OPT_TOL)
        _close_tree(pt, pj, OPT_TOL, f"params after step {i}")
        _close_tree(st["mu"], sj["mu"], OPT_TOL, "mu")
        _close_tree(st["nu"], sj["nu"], OPT_TOL, "nu")
    assert int(st["count"]) == int(sj["count"]) == 3
    clipped_t, n_t = adamw.clip_by_global_norm(jax.tree.map(_t, grads[0]), 0.5)
    clipped_j, n_j = j_clip(jax.tree.map(jnp.asarray, grads[0]), 0.5)
    np.testing.assert_allclose(n_t.item(), float(n_j), rtol=OPT_TOL)
    _close_tree(clipped_t, clipped_j, OPT_TOL, "clipped")
    np.testing.assert_allclose(adamw.global_norm(clipped_t).item(), 0.5, rtol=OPT_TOL)
    for s in (0, 1, 5, 60, 100, 150):
        np.testing.assert_allclose(
            adamw.cosine_schedule(s, warmup=10, total=100).item(),
            float(j_schedule(jnp.int32(s), warmup=10, total=100)),
            rtol=0, atol=OPT_TOL)


def test_grad_compress_matches_jax():
    """to_bf16, int8 quantization (ties to even) and two rounds of error
    feedback, against JAX's, to 1e-6 (the int8 codes equal)."""
    _, grads = _trees(1)
    g = grads[0]
    bf_t = grad_compress.to_bf16(jax.tree.map(_t, g))
    bf_j = j_to_bf16(jax.tree.map(jnp.asarray, g))
    _close_tree(bf_t, jax.tree.map(lambda x: x.astype(jnp.float32), bf_j), 0.0, "bf16")
    half = np.array([0.5, 1.5, -2.5, 127.0], np.float32)  # scale 1: rounds to even
    qt, _ = grad_compress.quantize_int8(_t(half))
    qj, _ = j_quantize(jnp.asarray(half))
    assert qt.tolist() == np.asarray(qj).tolist() == [0, 2, -2, 127]
    et = grad_compress.init_error_feedback(jax.tree.map(_t, g))
    ej = j_init_feedback(jax.tree.map(jnp.asarray, g))
    for gr in grads[:2]:
        q_t, et = grad_compress.compress_with_feedback(jax.tree.map(_t, gr), et)
        q_j, ej = j_feedback(jax.tree.map(jnp.asarray, gr), ej)
        flat_j = jax.tree.leaves(q_j, is_leaf=lambda x: isinstance(x, tuple))
        flat_t = jax.tree.leaves(q_t, is_leaf=lambda x: isinstance(x, tuple))
        assert len(flat_t) == len(flat_j) == 5
        for (code, scale), (code_j, scale_j) in zip(flat_t, flat_j):
            assert code.dtype == torch.int8
            np.testing.assert_array_equal(code.numpy(), np.asarray(code_j))
            np.testing.assert_allclose(scale.item(), float(scale_j), rtol=OPT_TOL)
        _close_tree(et, ej, OPT_TOL, "error feedback")
        deq = grad_compress.dequantize_int8(*q_t["embed"])
        np.testing.assert_allclose(deq.numpy(), np.asarray(j_dequantize(*q_j["embed"])),
                                   atol=OPT_TOL)


# ---------------------------------------------------------------------------
# The data stream
# ---------------------------------------------------------------------------


def _zipf_boundary(step, *, batch, seq, seed):
    """Positions where lm_batch's f32 zipf value exp(-log(u)·0.35) - 1 lies
    within an ulp of an integer (where torch's and XLA's last bits of exp
    and log may pick different tokens), with JAX's own u."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    k1 = jax.random.split(key, 3)[0]
    u = jax.random.uniform(k1, (batch, seq), minval=1e-6, maxval=1.0)
    base = np.asarray(jnp.exp(-jnp.log(u) * 0.35) - 1.0)
    return np.abs(base - np.round(base)) <= np.spacing(np.abs(base).astype(np.float32))


def test_lm_and_niah_batches_match_jax():
    """lm_batch and niah_batch over a (seed, step) grid, bit for bit with
    JAX's; zipf boundary positions (see ``_zipf_boundary``) are counted, and
    only they may differ (ROADMAP Queue 3 records the count)."""
    b, s, vocab = 4, 64, 49152
    boundary = differ = total = 0
    for seed in (0, 3):
        for step in (0, 1, 17, 4099):
            want = jlm_batch(jnp.int32(step), batch=b, seq=s, vocab=vocab, seed=seed)
            got = lm_batch(step, batch=b, seq=s, vocab=vocab, seed=seed)
            edge = _zipf_boundary(step, batch=b, seq=s, seed=seed)
            diff = got["tokens"].numpy() != np.asarray(want["tokens"])
            assert not (diff & ~edge).any(), (seed, step)
            boundary += int(edge.sum())
            differ += int(diff.sum())
            total += diff.size
            lab_ok = got["labels"].numpy() == np.asarray(want["labels"])
            assert lab_ok[:, :-1][~np.roll(diff, -1, axis=1)[:, :-1]].all()
            assert (got["labels"][:, -1] == -100).all()
            for depth in (0.0, 0.4, 1.0):
                wn = jniah_batch(jnp.int32(step), batch=b, seq=s, vocab=512, seed=seed,
                                 depth_frac=depth)
                gn = niah_batch(step, batch=b, seq=s, vocab=512, seed=seed, depth_frac=depth)
                np.testing.assert_array_equal(gn["tokens"].numpy(), np.asarray(wn["tokens"]))
                np.testing.assert_array_equal(gn["answer"].numpy(), np.asarray(wn["answer"]))
                assert gn["needle_pos"] == wn["needle_pos"]
    print(f"lm_batch: {total} tokens, {boundary} zipf boundary positions, "
          f"{differ} tokens differ from JAX's")


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.tensor([[1.5, -2.0], [3.25, 0.0]], dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)},
            "layers": [{"w": torch.ones(2)}, {"w": torch.zeros(3)}]}
    d = str(tmp_path / "ck")
    ckpt.save(d, tree, step=3, metadata={"step": 3, "note": "x"})
    restored, meta = ckpt.restore(d, tree)
    assert meta["note"] == "x"
    for (path, want), got in zip(leaves_with_paths(tree), leaves(restored)):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    with open(os.path.join(d, "step_0000000003", "manifest.json")) as f:
        paths = [e["path"] for e in json.load(f)["leaves"]]
    assert paths == ["['a']", "['b']['c']", "['b']['d']", "['layers'][0]['w']",
                     "['layers'][1]['w']"]
    loaded, _ = ckpt.load_numpy(d)
    assert isinstance(loaded["b"]["c"], ckpt.checkpoint.BF16Bits)
    assert isinstance(loaded["layers"], list) and loaded["layers"][1]["w"].shape == (3,)


def test_checkpoint_atomicity_and_prune(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        ckpt.save(d, tree, step=s, metadata={"step": s})
    assert ckpt.latest_step(d) == 4
    ckpt.prune_old(d, keep=2)
    steps = sorted(int(x.split("_")[1]) for x in os.listdir(d) if x.startswith("step_"))
    assert steps == [3, 4]
    # a stale tmp dir never shadows a committed checkpoint
    os.makedirs(os.path.join(d, "tmp.99"), exist_ok=True)
    assert ckpt.latest_step(d) == 4
    _, meta = ckpt.restore(d, tree)
    assert meta["step"] == 4


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_jax_checkpoint_reads_into_port(tmp_path, dtype):
    """A checkpoint that the JAX package's ckpt.save wrote (params and AdamW
    state), read by load_numpy and carried across with params_from_numpy,
    equals the port's converted params bit for bit."""
    jcfg, tcfg = _both("gemma3-1b", num_layers=7, local_window=8)  # a period + remainder
    params = numpy_params(jcfg, dtype=dtype)
    d = str(tmp_path / "jax")
    jckpt.save(d, {"params": params, "opt": jadamw.init_state(params)}, step=5,
               metadata={"step": 5})
    tree, meta = ckpt.load_numpy(d)
    assert meta["step"] == 5 and int(tree["opt"]["count"]) == 0
    got = params_from_numpy(tcfg, tree["params"], "cpu")
    want = params_from_numpy(tcfg, _np_tree(params), "cpu")
    for (path, g), w in zip(leaves_with_paths(got), leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), path


# ---------------------------------------------------------------------------
# The attention backward and lm_loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(hq=2, hkv=2, causal=True, window=0, sink=0),           # causal, GQA 1
    dict(hq=4, hkv=2, causal=True, window=0, sink=0),           # causal, GQA 2
    dict(hq=4, hkv=2, causal=True, window=8, sink=3),           # window + sink
    dict(hq=2, hkv=2, causal=True, window=5, sink=0, q_offset=4),  # window, offset
    dict(hq=6, hkv=2, causal=True, window=6, sink=2, q_offset=3),  # GQA 3, all of it
], ids=["causal-g1", "causal-g2", "window-sink-g2", "window-offset-g1",
        "window-sink-offset-g3"])
def test_flash_attention_bwd_ref_matches_autograd_and_jax(case):
    """ref.flash_attention_bwd_ref against torch.autograd through
    flash_attention_ref and against jax's vjp of the reference's
    flash_attention_ref, to 1e-5; it computes its own softmax, so the
    forward's L that ops.flash_attention_bwd takes beside o (from
    ops.flash_attention_lse) changes nothing on the CPU."""
    case = dict(case)
    hq, hkv = case.pop("hq"), case.pop("hkv")
    rng = np.random.default_rng(7)
    b, s, d = 2, 29, 16
    q, do = (rng.standard_normal((b, s, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tref.flash_attention_ref(tq, tk, tv, **case)
    auto = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    got = tref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), out.detach(),
                                       _t(do), **case)
    # jitted: one compile of the whole vjp, where eager dispatch compiles
    # each of its operations
    want = jax.jit(lambda a, b_, c, g: jax.vjp(
        lambda x, y, z: jref.flash_attention_ref(x, y, z, **case), a, b_, c)[1](g))(
            q, k, v, jnp.asarray(do))
    for name, g, a, w in zip("qkv", got, auto, want):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)
    o, lse = tops.flash_attention_lse(tq.detach(), tk.detach(), tv.detach(), **case)
    assert torch.equal(o, out.detach())
    for g, w in zip(tops.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), o,
                                             _t(do), lse, **case), got):
        assert torch.equal(g, w)


_JAX_LOSS: dict = {}


def _jax_loss_and_grads(family):
    """JAX's jit(value_and_grad(lm_loss)) at the family's tiny config with
    remat (the reference's default), once a module."""
    if family not in _JAX_LOSS:
        jcfg, tcfg = FAMILIES[family]()
        params = numpy_params(jcfg)
        tok, lab = _tokens(jcfg.vocab_size)
        fn = jax.jit(jax.value_and_grad(
            lambda p, t, l: JM.lm_loss(jcfg, p, t, l, remat=True)))
        loss, grads = fn(params, tok, lab)
        _JAX_LOSS[family] = (tcfg, _np_tree(params), tok, lab, float(loss), _np_tree(grads))
    return _JAX_LOSS[family]


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_lm_loss_and_every_gradient_match_jax(family, remat):
    """The port's lm_loss and the gradient of every parameter leaf against
    JAX's value_and_grad (its remat on; the port's on and off: recomputing a
    period changes no value), carried across with params_from_numpy: loss to
    1e-5 relative, gradients to 2e-5 + 1e-4 relative."""
    tcfg, params_np, tok, lab, loss_j, grads_np = _jax_loss_and_grads(family)
    params = params_from_numpy(tcfg, params_np, "cpu")
    live = [x.requires_grad_(True) for x in leaves(params)]
    loss = TM.lm_loss(tcfg, params, _t(tok), _t(lab), remat=remat)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(loss.item(), loss_j, rtol=LOSS_RTOL)
    want = params_from_numpy(tcfg, grads_np, "cpu")
    for (path, w), g in zip(leaves_with_paths(want), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{family} {path}")


# ---------------------------------------------------------------------------
# make_train_step, and the CLI's crash-and-resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mb,grad_dtype", [(1, "f32"), (1, "bf16"), (2, "bf16")])
def test_train_step_matches_jax(mb, grad_dtype):
    """Three make_train_step steps against JAX's jitted one (microbatched
    accumulation, the bf16 round trip / bf16 accumulators, the schedule,
    AdamW) on the tiny dense config and batches JAX made: each step's loss
    and grad norm to 1e-5 relative, the parameters to 1e-5. Where AdamW's
    normalised step turns a near-zero gradient's sign into a ±lr move, an
    element may move by up to 2·lr·steps: those elements are counted."""
    jcfg, tcfg = _both("smollm-360m", **TINY)
    kw = dict(microbatches=mb, remat=True, grad_dtype=grad_dtype, lr=1e-2, warmup=2,
              total_steps=10)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.TrainConfig(**kw)))
    tstep = ttrain.make_train_step(tcfg, ttrain.TrainConfig(**kw))
    pj = numpy_params(jcfg)
    pt = params_from_numpy(tcfg, _np_tree(pj), "cpu")
    oj, ot = jadamw.init_state(pj), adamw.init_state(pt)
    steps = 3
    for step in range(steps):
        batch = jlm_batch(jnp.int32(step), batch=4, seq=16, vocab=jcfg.vocab_size)
        pj, oj, mj = jstep(pj, oj, batch, jnp.int32(step))
        pt, ot, mt = tstep(pt, ot, {k: _t(v) for k, v in batch.items()}, step)
        for key in ("loss", "grad_norm", "lr_scale"):
            np.testing.assert_allclose(mt[key].item(), float(mj[key]), rtol=LOSS_RTOL,
                                       err_msg=f"step {step} {key}")
    flips = 0
    bound = 2 * kw["lr"] * steps
    for (path, got), want in zip(leaves_with_paths(pt),
                                 leaves(params_from_numpy(tcfg, _np_tree(pj), "cpu"))):
        off = (got - want).abs()
        flips += int((off > PARAM_TOL).sum())
        assert off.max().item() <= bound, path
    n = sum(x.numel() for x in leaves(pt))
    print(f"train step mb={mb} {grad_dtype}: {flips} of {n} parameters past {PARAM_TOL} "
          f"(sign flips of a near-zero gradient, each within 2*lr*steps = {bound})")
    assert flips <= n // 1000


def test_crash_resume_exactness_on_cpu(tmp_path):
    """The port's CLI: a crashed-and-resumed run reproduces the
    uninterrupted run's final loss (checkpoint + seekable data)."""
    common = ["--arch", "smollm-360m", "--reduced", "--steps", "4", "--batch", "2",
              "--seq", "32", "--ckpt-every", "2", "--log-every", "100", "--device", "cpu"]
    loss_ref = train_cli.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="injected crash"):
        train_cli.main(common + ["--ckpt-dir", str(tmp_path / "b"), "--crash-at", "3"])
    assert ckpt.latest_step(str(tmp_path / "b")) == 1
    loss_resumed = train_cli.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert loss_ref == pytest.approx(loss_resumed, abs=1e-6)
