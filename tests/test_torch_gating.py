"""Head identification in the PyTorch port against the JAX reference on
the CPU: the α-gated attention, the α gradient of the gated forward, the
identification loop of ``examples/head_identification.py``, and
``classify_heads`` with ties; then the identified plan served through the
port's prefill and decode steps against JAX's with the same permutations.
The JAX programs are compiled once a module."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import gating as jgating
from repro.data import niah_batch as jniah_batch
from repro.kernels.ref import flash_attention_ref as jflash_ref
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.core import gating
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map, unflatten
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from test_torch_recurrent import numpy_params
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

# examples/head_identification.py's config and loss weight
HEAD_ID = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
               vocab_size=128, head_dim=16)
LAM = 2e-3
FN_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4


def _cfgs():
    return (jconfigs.reduced(jconfigs.get_arch("smollm-360m"), **HEAD_ID),
            tconfigs.reduced(tconfigs.get_arch("smollm-360m"), **HEAD_ID))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_gated_attention_matches_jax():
    """α = 1 gives a kv head's group full attention and α = 0 streaming
    attention (the reference's tests/test_models.py split), and an interior
    α the mix, each equal to JAX's gated_attention within 1e-5."""
    rng = np.random.default_rng(0)
    b, s, hq, hkv, d = 1, 64, 4, 2, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))
    full = np.asarray(jflash_ref(q, k, v, causal=True))
    stream = np.asarray(jflash_ref(q, k, v, causal=True, window=8, sink=2))
    g = hq // hkv
    for alpha in ([1.0, 0.0], [0.3, 1.7]):
        got = gating.gated_attention(_t(q), _t(k), _t(v), torch.tensor(alpha), sink=2,
                                     local=8).numpy()
        want = np.asarray(jgating.gated_attention(q, k, v, jnp.asarray(alpha), sink=2,
                                                  local=8))
        np.testing.assert_allclose(got, want, atol=FN_TOL, rtol=0)
    np.testing.assert_allclose(got[:, :, g:], full[:, :, g:], atol=FN_TOL)  # 1.7 clips to 1
    split = gating.gated_attention(_t(q), _t(k), _t(v), torch.tensor([1.0, 0.0]), sink=2,
                                   local=8).numpy()
    np.testing.assert_allclose(split[:, :, :g], full[:, :, :g], atol=FN_TOL)
    np.testing.assert_allclose(split[:, :, g:], stream[:, :, g:], atol=FN_TOL)


def test_classify_heads_with_ties_matches_jax():
    """Stable descending order, ties (α at its clip bounds 0 and 1, and an
    interior tie) keeping the lower head first, as jnp.argsort; the plan
    holds a layer's permutation, None for the identity."""
    alpha = np.array([[0.1, 0.9, 0.9, 0.0],
                      [1.0, 1.0, 0.0, 0.0],
                      [0.0, 0.5, 1.0, 0.5],
                      [0.2, 0.4, 0.6, 0.8],
                      [0.8, 0.6, 0.4, 0.2]], np.float32)
    got = gating.classify_heads(_t(alpha), 0.5)
    want = np.asarray(jgating.classify_heads(jnp.asarray(alpha), 0.5))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    plan = gating.plan_from_perms(got)
    assert plan[1] is None and plan[4] is None
    assert plan[0].tolist() == [1, 2, 0, 3] and plan[3].tolist() == [3, 2, 1, 0]
    assert float(gating.gating_loss(torch.tensor(1.0), torch.tensor(alpha), 0.5)) == \
        pytest.approx(float(jgating.gating_loss(1.0, jnp.asarray(alpha), 0.5)))


_JAX: dict = {}


def _jax_loop(steps: int):
    """The identification loop of examples/head_identification.py in JAX,
    ``steps`` steps from α = 1 and numpy weights: the numpy weights, per step
    the (loss, task, grads, α) before the update and the batch, and the
    final α."""
    if "loop" not in _JAX:
        jcfg, _ = _cfgs()
        params = numpy_params(jcfg, seed=3)
        alpha = jgating.init_alpha(jcfg.num_layers, jcfg.num_kv_heads)

        def loss_fn(params, alpha, tokens, answer):
            logits = JM.forward(jcfg, params, tokens, alpha=alpha, remat=False)
            logp = jax.nn.log_softmax(logits[:, -1].astype(jnp.float32))
            task = -jnp.take_along_axis(logp, answer[:, None], axis=-1).mean()
            return jgating.gating_loss(task, alpha, LAM), task

        grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
        opt_p, opt_a = jadamw.init_state(params), jadamw.init_state(alpha)
        pcfg = jadamw.AdamWConfig(lr=2e-3, weight_decay=0.0)
        acfg = jadamw.AdamWConfig(lr=2e-2, weight_decay=0.0)
        update_p = jax.jit(lambda p, g, o: jadamw.apply_updates(p, g, o, pcfg))
        update_a = jax.jit(lambda a, g, o: jadamw.apply_updates(a, g, o, acfg))
        p0 = jax.tree.map(np.asarray, params)
        trace, batches = [], []
        for step in range(steps):
            batch = jniah_batch(jnp.int32(step), batch=8, seq=32, vocab=jcfg.vocab_size,
                                depth_frac=0.4)
            (loss, task), (gp, ga) = grad_fn(params, alpha, batch["tokens"], batch["answer"])
            trace.append((float(loss), float(task), jax.tree.map(np.asarray, gp),
                          np.asarray(ga), np.asarray(alpha)))
            batches.append({k: np.asarray(v) for k, v in batch.items()})
            params, opt_p, _ = update_p(params, gp, opt_p)
            alpha, opt_a, _ = update_a(alpha, ga, opt_a)
            alpha = jgating.clip_alpha(alpha)
        _JAX["loop"] = (p0, trace, batches, np.asarray(alpha))
    return _JAX["loop"]


def _port_loss(cfg, params, alpha, tokens, answer):
    logits = TM.forward(cfg, params, tokens, alpha=alpha, remat=False)
    logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
    task = -logp.gather(-1, answer.long()[:, None]).mean()
    return gating.gating_loss(task, alpha, LAM), task


def test_head_identification_loop_matches_jax():
    """Three steps of the identification loop: each step's loss, task loss,
    every weight gradient and the α gradient of the gated forward against
    jax's value_and_grad (α starts at its clip bound 1, where both split the
    gradient in halves), then AdamW on both; α within 1e-5, and
    classify_heads' permutations equal."""
    _, cfg = _cfgs()
    p0, trace, batches, alpha_j = _jax_loop(3)
    params = params_from_numpy(cfg, p0, "cpu")
    alpha = gating.init_alpha(cfg.num_layers, cfg.num_kv_heads)
    opt_p, opt_a = adamw.init_state(params), adamw.init_state(alpha)
    pcfg = adamw.AdamWConfig(lr=2e-3, weight_decay=0.0)
    acfg = adamw.AdamWConfig(lr=2e-2, weight_decay=0.0)
    for step, (loss_j, task_j, gp_j, ga_j, a_j) in enumerate(trace):
        np.testing.assert_allclose(alpha.numpy(), a_j, atol=FN_TOL, err_msg=f"step {step}")
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        a = alpha.detach().requires_grad_(True)
        batch = batches[step]
        loss, task = _port_loss(cfg, live, a, _t(batch["tokens"]), _t(batch["answer"]))
        grads = torch.autograd.grad(loss, leaves(live) + [a])
        np.testing.assert_allclose(loss.item(), loss_j, rtol=FN_TOL)
        np.testing.assert_allclose(task.item(), task_j, rtol=FN_TOL)
        np.testing.assert_allclose(grads[-1].numpy(), ga_j, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"alpha grad, step {step}")
        assert (grads[-1] != 0).all()
        want = params_from_numpy(cfg, gp_j, "cpu")
        for (path, w), g in zip(leaves_with_paths(want), grads[:-1]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"step {step} {path}")
        params, opt_p, _ = adamw.apply_updates(params, unflatten(params, grads[:-1]), opt_p,
                                               pcfg)
        alpha, opt_a, _ = adamw.apply_updates(alpha, grads[-1], opt_a, acfg)
        alpha = gating.clip_alpha(alpha)
    np.testing.assert_allclose(alpha.numpy(), alpha_j, atol=FN_TOL)
    perms = gating.classify_heads(alpha, cfg.h2eal.static_sparsity)
    np.testing.assert_array_equal(
        perms.numpy(), np.asarray(jgating.classify_heads(jnp.asarray(alpha_j),
                                                         cfg.h2eal.static_sparsity)))


def test_identified_plan_serves_like_jax():
    """A non-identity plan from classify_heads (α set so that each layer's
    order swaps its two kv heads) through the port's prefill and 8 decode
    steps (selection every share window) against JAX's M.prefill and
    M.decode_step with the same permutations: logits within 2e-4, and the
    port's output moved by the plan (its logits differ from the identity
    plan's)."""
    jcfg, cfg = _cfgs()
    p0, *_ = _jax_loop(3)
    alpha = np.array([[0.2, 0.9], [0.0, 1.0]], np.float32)
    perms = gating.classify_heads(_t(alpha), cfg.h2eal.static_sparsity)
    plan = gating.plan_from_perms(perms)
    assert all(p is not None for p in plan)
    jperm = jnp.asarray(perms.numpy())
    jplan = {"blocks": {"pos0": {"perm": jperm}}, "rem": {}}
    params = params_from_numpy(cfg, p0, "cpu")
    jparams = jax.tree.map(jnp.asarray, p0)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    cap = 40 + 8 + cfg.h2eal.page_size
    jl, jst = jax.jit(lambda p, t: JM.prefill(jcfg, p, t, capacity=cap, plan=jplan))(
        jparams, tokens)
    with torch.inference_mode():
        tl, tst = TM.prefill(cfg, params, _t(tokens), capacity=cap, plan=plan)
        base, _ = TM.prefill(cfg, params, _t(tokens), capacity=cap)
    assert (tl - base).abs().max() > 1e-3
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=0)
    w = max(cfg.h2eal.share_window, 1)
    jdec = {sel: jax.jit(lambda p, s, t, sel=sel: JM.decode_step(jcfg, p, s, t, plan=jplan,
                                                                do_select=sel))
            for sel in (True, False)}
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for i in range(8):
        jl, jst = jdec[i % w == 0](jparams, jst, jnp.asarray(tok))
        with torch.inference_mode():
            tl, tst = TM.decode_step(cfg, params, tst, _t(tok), plan=plan,
                                     do_select=i % w == 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=0,
                                   err_msg=f"decode step {i}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
