"""PyTorch port, the reference's tensor-parallel ``generate(mesh=...)`` and its
sharded train step for the MoE, recurrent and local:global families over
``torch.distributed`` ranks, against the JAX package on the CPU.

As in ``tests/test_torch_tensor_parallel.py`` (the dense family), the
reference's mesh paths are ``jax.jit`` of its unsharded functions with
shardings and nothing else, so JAX's unsharded ``make_prefill`` /
``make_decode_step`` / ``make_train_step`` are the oracle, up to the
reordering of sums a cut brings. The ranks are processes of
``tests/_torch_tp_worker.py`` (no JAX): one spawn of 4 runs the meshes
(data, model) (1, 2), (2, 1) and (2, 2) in turn while this process builds
the JAX references (once a module).

The families, reduced: qwen3-moe with 32 query heads over 2 kv heads (its
GQA group of 16) at capacity factor 1.25, the embedding and every router
leaning to expert 0 so that entries drop at prefill and in the train
step's microbatch; kimi-k2 (its shared expert, a 2-D SwiGLU beside the
routed ones) at 1.25; zamba2's hybrid period (mamba2, mamba2, attention);
xlstm-125m (mLSTM and sLSTM); gemma3-1b at 8 layers (window layers of 64
and a global layer, one kv head) on prompts longer than the window.

  * ``generate(mesh=...)`` on ``default``, ``head`` and ``coplace``: the
    ranks' tokens equal each other's and JAX's up to a near-tie, the last
    logits within 2e-4 where no token parted; each rank holds exactly its
    blocks of the parameters (``param_shardings(mode="serve")``), and a MoE
    rank holds less than the whole on any mesh of more than one rank (its
    experts' dim E over 'data', never gathered).
  * the sharded step, 2 steps, against JAX's ``make_train_step``, within
    ``test_torch_train.py``'s tolerances.

In this process: routing only a rank's rows would decide capacity, and so
the drops, otherwise than the reference does over the whole token set; a
cut that does not divide leaves the leaf whole, used whole.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import lm_batch as jlm_batch
from repro.optim import adamw as jadamw
from repro.runtime import serve as jserve
from repro.runtime import train as jtrain
from repro_torch import configs as tconfigs
from repro_torch.core import layouts as layoutlib
from repro_torch.core.tree import leaves
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import sharding as tsharding
from repro_torch.runtime import tensor_parallel as tplib
from test_torch_recurrent import numpy_params
from test_torch_tensor_parallel import _assert_near_tie, _rank_bytes, _run_job
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

MESHES = ((1, 2), (2, 1), (2, 2))
LAYOUTS = ("default", "head", "coplace")
QWEN, KIMI, ZAMBA, XLSTM, GEMMA3 = "qwen3_moe", "kimi_k2", "zamba2", "xlstm", "gemma3"
# name -> (arch, overrides, MoE capacity factor or None, prompt length)
FAMILIES = {
    QWEN: ("qwen3-moe-235b-a22b", (("num_heads", 32), ("num_kv_heads", 2)), 1.25, 40),
    KIMI: ("kimi-k2-1t-a32b", (), 1.25, 40),
    ZAMBA: ("zamba2-2.7b", (("mixer_pattern", ("mamba2", "mamba2", "attention")),
                            ("num_layers", 3)), None, 40),
    XLSTM: ("xlstm-125m", (), None, 40),
    GEMMA3: ("gemma3-1b", (("num_layers", 8),), None, 72),
}
GEN, TIE_GAP, LOGIT_TOL = 6, 1e-3, 2e-4
# tests/test_torch_train.py's loss and parameter tolerances
BATCH, SEQ, STEPS = 4, 16, 2
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-5
TRAIN_KW = dict(microbatches=1, remat=True, grad_dtype="f32", lr=1e-2, warmup=2,
                total_steps=10)
# qwen3-moe's lean: the embedding moved along u, every router's expert-0
# column too, so that expert 0 overflows its capacity
LEAN_EMBED, LEAN_ROUTER = 0.2, 3.0


def _configs(name):
    arch, over, factor, _ = FAMILIES[name]
    j = jconfigs.reduced(jconfigs.get_arch(arch), **dict(over))
    t = tconfigs.reduced(tconfigs.get_arch(arch), **dict(over))
    if factor is not None:
        j = dataclasses.replace(j, moe=dataclasses.replace(j.moe, capacity_factor=factor))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, capacity_factor=factor))
    return j, t


def _capacity(name):
    return 64 if FAMILIES[name][3] + GEN <= 64 else 96


def _lean(tree, d):
    u = np.random.default_rng(11).standard_normal(d)
    u /= np.linalg.norm(u)

    def move(path, a):
        key = jax.tree_util.keystr(path)
        if key == "['embed']":
            return (a + LEAN_EMBED * u).astype(a.dtype)
        if "router" in key:
            a = a.copy()
            a[..., :, 0] += LEAN_ROUTER * u
        return a
    return jax.tree_util.tree_map_with_path(move, tree)


def _params(name):
    jcfg = _configs(name)[0]
    tree = jax.tree.map(np.asarray, numpy_params(jcfg))
    return _lean(tree, jcfg.d_model) if name == QWEN else tree


def _prompts(name):
    return np.random.default_rng(3).integers(0, 512, (2, FAMILIES[name][3])).astype(np.int32)


def _job(tmp):
    params = {name: _params(name) for name in FAMILIES}
    meshes = {}
    for data, model in MESHES:
        cases = {}
        for name, (arch, over, factor, _) in FAMILIES.items():
            base = dict(arch=arch, overrides=dict(over), factor=factor, params=params[name])
            for layout in LAYOUTS:
                cases[("generate", name, layout)] = dict(
                    base, kind="generate", prompts=_prompts(name), gen=GEN,
                    capacity=_capacity(name), layout=layout)
            cases[("train", name)] = dict(base, kind="train", kw=TRAIN_KW, fsdp=False,
                                          steps=STEPS, batch=BATCH, seq=SEQ)
        meshes[(data, model)] = {"world": data * model, "model": model, "cases": cases,
                                 "store": os.path.join(tmp, f"store_{data}x{model}")}
    return {"meshes": meshes}, params


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every mesh's ranks in a background thread, started before the JAX
    references are built; ``result(mesh)`` waits."""
    import threading

    tmp = str(tmp_path_factory.mktemp("tpf"))
    job, params = _job(tmp)
    results, errors = {}, []

    def run():
        try:
            results.update(_run_job(job, os.path.join(tmp, "job")))
        except BaseException as e:  # re-raised in the test that reads it
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def result(mesh):
        t.join()
        if errors:
            raise errors[0]
        return results[mesh]
    return {"result": result, "params": params}


@pytest.fixture(scope="module")
def refs(spawned):
    """JAX's lockstep generate and unsharded train steps of each family,
    built once the ranks run."""
    for name in FAMILIES:
        jax_generate(name, spawned["params"][name])
        jax_train(name, spawned["params"][name])
    return spawned


_JAX_GEN: dict = {}
_JAX_TRAIN: dict = {}


def jax_generate(name, params):
    """(tokens (B, GEN), logits (GEN + 1, B, V)) of JAX's lockstep
    generate(mesh=None), the default layout's body every layout is held
    to."""
    if name not in _JAX_GEN:
        jcfg = _configs(name)[0]
        scfg = jserve.ServeConfig(capacity=_capacity(name), layout="default", impl="ref")
        prefill = jax.jit(jserve.make_prefill(jcfg, scfg))
        steps = [jax.jit(jserve.make_decode_step(jcfg, scfg, do_select=s))
                 for s in (False, True)]
        logits, state = prefill(params, _prompts(name))
        rows, toks = [np.asarray(logits)], []
        for i in range(GEN):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            logits, state = steps[i % jcfg.h2eal.share_window == 0](params, state, tok)
            rows.append(np.asarray(logits))
        _JAX_GEN[name] = (np.stack(toks, 1), np.stack(rows))
    return _JAX_GEN[name]


def jax_train(name, params):
    """[metrics] of STEPS of JAX's jitted unsharded make_train_step, and its
    final parameters."""
    if name not in _JAX_TRAIN:
        jcfg = _configs(name)[0]
        step = jax.jit(jtrain.make_train_step(jcfg, jtrain.TrainConfig(**TRAIN_KW)))
        p = jax.tree.map(jnp.asarray, params)
        o = jadamw.init_state(p)
        metrics = []
        for i in range(STEPS):
            batch = jlm_batch(jnp.int32(i), batch=BATCH, seq=SEQ, vocab=jcfg.vocab_size)
            p, o, m = step(p, o, batch, jnp.int32(i))
            metrics.append({k: float(v) for k, v in m.items()})
        _JAX_TRAIN[name] = (metrics, jax.tree.map(np.asarray, p))
    return _JAX_TRAIN[name]


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_generate_family_on_a_mesh_matches_jax(refs, mesh, layout, name):
    """The ranks' tokens equal each other's and JAX's generate(mesh=None) up
    to a near-tie, the last logits within 2e-4 where no token parted; each
    rank holds its blocks of the parameters by ``param_shardings(mode=
    "serve")`` and no more: less than the whole where 'model' has ranks,
    and for a MoE on any mesh of more than one rank."""
    ranks = refs["result"](mesh)
    got = [r["results"][("generate", name, layout)] for r in ranks]
    for g in got[1:]:
        assert np.array_equal(g["tokens"], got[0]["tokens"])
    want, logits = jax_generate(name, refs["params"][name])
    if _assert_near_tie(got[0]["tokens"], want, logits, f"{name} {layout} {mesh}"):
        np.testing.assert_allclose(got[0]["last_logits"], logits[-1], atol=LOGIT_TOL,
                                   rtol=0)
    tcfg = _configs(name)[1]
    params = refs["params"][name]
    whole = 4 * sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    tparams = params_from_numpy(tcfg, params, "meta")
    for r, g in zip(ranks, got):
        assert g["param_bytes"] == _rank_bytes(tcfg, tparams, *r["mesh"], "serve")
        assert (g["param_bytes"] < whole) == (mesh[1] > 1 or tcfg.moe.enabled)


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_train_step_family_matches_jax(refs, mesh, name):
    """Two sharded steps against JAX's unsharded make_train_step: each step's
    loss, grad norm and lr scale to 1e-5 relative, the parameters to 1e-5
    (elements that AdamW's normalised step moved by ±lr on a near-zero
    gradient's sign counted, each within 2·lr·steps, at most one in a
    thousand); every rank reports the same metrics and whole parameters.
    A MoE's experts are stored cut: E over 'model', their inner dims over
    'data'."""
    ranks = [r["results"][("train", name)] for r in refs["result"](mesh)]
    want_m, want_p = jax_train(name, refs["params"][name])
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        assert all(np.array_equal(a, b) for a, b in zip(r["params"], ranks[0]["params"]))
    for i, (got, want) in enumerate(zip(ranks[0]["metrics"], want_m)):
        for key in ("loss", "grad_norm", "lr_scale"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    tcfg = _configs(name)[1]
    want = leaves(params_from_numpy(tcfg, want_p, "cpu"))
    flips, n, bound = 0, 0, 2 * TRAIN_KW["lr"] * STEPS
    for got, w in zip(ranks[0]["params"], want):
        off = np.abs(got - w.numpy())
        flips += int((off > PARAM_TOL).sum())
        n += off.size
        assert off.max() <= bound
    assert flips <= n // 1000, (flips, n)
    if tcfg.moe.enabled:
        specs = [s for s in ranks[0]["specs"] if len(s) == 3]
        assert specs and all(s[0] == "model" and "data" in s[1:] for s in specs)


def test_per_rank_routing_drops_otherwise_than_the_whole_token_set():
    """qwen3-moe's layer at factor 1.25 over a train step's microbatch of 4 x
    16 tokens leaning to expert 0: over the whole set the capacity is 48,
    over one 'data' rank's 2 rows 24, and expert 0 overflows both, so
    routing a rank's rows alone drops other entries than the reference's
    unsharded function: the rows' outputs part by far more than rounding.
    The sharded step gathers the tokens over 'data' before its router
    (``tensor_parallel.gather_rows``) and equals JAX's
    (``test_sharded_train_step_family_matches_jax``)."""
    jcfg, tcfg = _configs(QWEN)
    tree = _params(QWEN)
    p = params_from_numpy(tcfg, tree, "cpu")["layers"][0]["moe"]
    router = np.asarray(tree["blocks"]["pos0"]["moe"]["router"][0])
    lean = router[:, 0] / np.linalg.norm(router[:, 0])
    x = np.random.default_rng(5).standard_normal((BATCH, SEQ, tcfg.d_model))
    x = torch.from_numpy((x + 3 * lean).astype(np.float32))
    ids = tmoe._route(tcfg, p, x.reshape(-1, tcfg.d_model))[2]
    counts = torch.bincount(ids.reshape(-1), minlength=tcfg.moe.num_experts)
    whole_cap, rank_cap = (tmoe._capacity(n, tcfg.moe.num_experts, tcfg.moe.top_k, 1.25)
                           for n in (BATCH * SEQ, BATCH * SEQ // 2))
    assert (whole_cap, rank_cap) == (48, 24)
    assert counts[0] > whole_cap
    whole = tmoe.moe_ffn(tcfg, p, x)
    rows = tmoe.moe_ffn(tcfg, p, x[:BATCH // 2])
    assert (rows - whole[:BATCH // 2]).abs().max() > 1e-1


def test_a_cut_that_does_not_divide_is_used_whole():
    """At 'data' 3 the serve rule's E = 4 over 'data' does not divide and at
    'model' 3 neither do d = 128 nor d_ff = 256: the leaves are whole on
    every rank, and the mesh's MoE layer computes what no mesh does, bit
    for bit, sending nothing. gemma3's window layer has one kv head, which
    'model' = 2 cannot cut: its full cache is placed whole over 'model'
    (rows over 'data'), as the spawned gemma3 cases run it."""
    _, tcfg = _configs(KIMI)
    p = TT.init_params(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 20, tcfg.d_model, generator=torch.Generator().manual_seed(1))
    want = tmoe.moe_ffn(tcfg, p["layers"][0]["moe"], x)
    for sizes in ((3, 1), (1, 3)):
        mesh = tmesh.Mesh(sizes=sizes, coords=(0, 0))
        specs = tsharding.param_shardings(tcfg, mesh, p, "serve")
        moe = specs["layers"][0]["moe"]
        assert not any(tsharding._cut_axes(moe[k], mesh) for k in ("w_gate", "w_up", "w_down"))
        tp = tplib.TensorParallel(mesh, specs).at("layers", 0, "moe")
        assert torch.equal(tmoe.moe_ffn(tcfg, p["layers"][0]["moe"], x, tp), want)
    _, gcfg = _configs(GEMMA3)
    spec = TT.attn_spec(gcfg, 0)
    assert spec.window > 0 and spec.n_kv == 1
    for sizes, coords in (((1, 2), (0, 1)), ((2, 2), (1, 1))):
        mesh = tmesh.Mesh(sizes=sizes, coords=coords)
        place = layoutlib.get_layout("head").placed(mesh, batch=2, capacity=96).place(spec)
        assert place.specs[("full", "k")][1] is None

