"""PyTorch port, the reference's tensor-parallel ``generate(mesh=...)`` and its
sharded train step (``jit_serve_steps``, ``jit_train_step``) over
``torch.distributed`` ranks, against the JAX package on the CPU.

The reference's mesh paths raise ``ShardingTypeError`` on this jax, but they
are ``jax.jit`` of its unsharded functions with in/out shardings and
nothing else: a placement changes where values live, not what they are. So
the reference's unsharded ``make_prefill`` / ``make_decode_step`` /
``make_train_step`` are the oracle, up to the reordering of sums a cut
brings.

Ranks are processes (``tests/_torch_tp_worker.py``, which imports no JAX):
one spawn of 4 runs the meshes (data, model) (1, 2), (2, 1) and (2, 2) in
turn, in the background while this process builds the JAX references (once
a module). The cases:

  * ``generate(mesh=...)`` for each of the five layouts on each mesh, on
    reduced smollm-360m and on it with one kv head, whose ``wk`` / ``wv``
    column cut falls inside the head at 'model' = 2 (16 of its 32 columns a
    rank); ``interleave`` with one prompt, so that where 'data' has two
    ranks the batch cannot take it and the tokens stripe within pages. The
    ranks' tokens equal each other's and JAX's ``generate(mesh=None)`` up to
    a near-tie, the last logits within 2e-4 of JAX's where no token
    parted; each rank holds exactly its blocks of the parameters. H²EAL off
    once, on ``head`` (2, 2). ``coplace_shmap`` selects a masked page as -1
    (the reference's co-placed body), where JAX's lockstep steps, run
    without an ambient mesh, fall back to the default body (ROADMAP Queue
    3): its last logits are held to the port's one-card layout over as many
    page stripes as 'model' has ranks, its tokens to both.
  * the sharded step, 2 steps, on the three meshes, on the tiny dense
    config of ``tests/test_torch_train.py`` with one kv head: loss and grad
    norm to 1e-5 relative and the parameters to 1e-5 of JAX's unsharded
    ``make_train_step``, AdamW's ±lr moves of near-zero gradients counted
    as there; microbatches of 2 with bf16 gradients; FSDP forced on (the
    port's ``FSDP_BYTES_THRESHOLD`` set to 0 inside the worker only); the
    leaves 'model' does not cut bit-equal across the ranks.
  * the training CLI over 2 gloo ranks: a crashed and resumed run repeats
    the uninterrupted run's loss exactly; one crashed twice and resumed on
    one rank (the elastic restore) within 1e-5 relative.

In this process: a one-rank mesh computes what no mesh does, bit for bit,
for the dense family and for the MoE, recurrent and local:global stacks;
the frontend stub's refusal; a batch that does not divide into
microbatches x 'data'.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.data import lm_batch as jlm_batch
from repro.optim import adamw as jadamw
from repro.runtime import serve as jserve
from repro.runtime import train as jtrain
from repro_torch import configs as tconfigs
from repro_torch.core.tree import leaves, leaves_with_paths
from repro_torch.data import lm_batch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as train_cli
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as tsharding
from repro_torch.runtime import train as ttrain
from repro_torch.serving.engine import STUB_ENGINE_REFUSAL
from test_torch_recurrent import numpy_params
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

TESTS = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(TESTS, "_torch_tp_worker.py")
MESHES = ((1, 2), (2, 1), (2, 2))
LAYOUTS = ("default", "head", "coplace", "interleave", "coplace_shmap")
# reduced smollm, and with one kv head: wk / wv cut inside the head at 'model' 2
ARCHS = {"smollm": ("smollm-360m", ()), "smollm_kv1": ("smollm-360m", (("num_kv_heads", 1),))}
PROMPT, GEN, CAP = 40, 8, 64
TIE_GAP, LOGIT_TOL = 1e-3, 2e-4
# tests/test_torch_train.py's tiny config with one kv head (GQA 4; wk's 16
# columns cut inside the head at 'model' 2), its batches and tolerances
TINY = (("num_layers", 2), ("d_model", 64), ("num_heads", 4), ("num_kv_heads", 1),
        ("d_ff", 128), ("vocab_size", 256), ("head_dim", 16))
BATCH, SEQ, STEPS = 4, 16, 2
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-5
TRAIN_KW = {"f32": dict(microbatches=1, remat=True, grad_dtype="f32", lr=1e-2, warmup=2,
                        total_steps=10),
            "mb2_bf16": dict(microbatches=2, remat=True, grad_dtype="bf16", lr=1e-2,
                             warmup=2, total_steps=10)}
# (mesh) -> [(case name, TRAIN_KW key, FSDP forced)]
TRAIN_CASES = {(1, 2): [("f32", "f32", False)],
               (2, 1): [("f32", "f32", False), ("fsdp", "f32", True)],
               (2, 2): [("f32", "f32", False), ("mb2_bf16", "mb2_bf16", False),
                        ("fsdp", "f32", True)]}
CLI = ["--arch", "smollm-360m", "--reduced", "--steps", "6", "--batch", "4", "--seq", "32",
       "--ckpt-every", "2", "--log-every", "100", "--device", "cpu"]
CLI_CRASH = (3, 5)


def _configs(arch):
    name, over = ARCHS[arch] if isinstance(arch, str) else arch
    return (jconfigs.reduced(jconfigs.get_arch(name), **dict(over)),
            tconfigs.reduced(tconfigs.get_arch(name), **dict(over)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _prompts(layout):
    p = np.random.default_rng(3).integers(0, 512, (2, PROMPT)).astype(np.int32)
    return p[:1] if layout == "interleave" else p


def _generate_cases(params):
    cases = {}
    for arch in ARCHS:
        for layout in LAYOUTS:
            cases[("generate", arch, layout)] = dict(
                kind="generate", arch=ARCHS[arch][0], overrides=dict(ARCHS[arch][1]),
                params=params[arch], prompts=_prompts(layout), gen=GEN, capacity=CAP,
                layout=layout)
    return cases


def _job(tmp):
    params = {arch: _np_tree(numpy_params(_configs(arch)[0])) for arch in ARCHS}
    tiny = _np_tree(numpy_params(_configs(("smollm-360m", TINY))[0]))
    meshes = {}
    for data, model in MESHES:
        cases = _generate_cases(params)
        for name, kw, fsdp in TRAIN_CASES[(data, model)]:
            cases[("train", name)] = dict(kind="train", arch="smollm-360m",
                                          overrides=dict(TINY), params=tiny,
                                          kw=TRAIN_KW[kw], fsdp=fsdp, steps=STEPS,
                                          batch=BATCH, seq=SEQ)
        if (data, model) == (2, 2):
            cases[("generate", "smollm", "head_h2eal_off")] = dict(
                cases[("generate", "smollm", "head")], h2eal=False)
        if (data, model) == (2, 1):
            cases[("cli",)] = dict(kind="cli", argv=CLI, crash=CLI_CRASH,
                                   dirs={k: os.path.join(tmp, f"cli_{k}")
                                         for k in ("full", "resumed", "elastic")})
        meshes[(data, model)] = {"world": data * model, "model": model, "cases": cases,
                                 "store": os.path.join(tmp, f"store_{data}x{model}")}
    return {"meshes": meshes}, params, tiny


def _run_job(job, path):
    """Start the job's processes, wait, and return {mesh: [each rank's
    results]}."""
    with open(path, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    ranks = max(m["world"] for m in job["meshes"].values())
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(ranks)]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"process {r} failed:\n{logs[r][-3000:]}"
    out = {}
    for r in range(ranks):
        with open(f"{path}.{r}", "rb") as f:
            for mesh, res in pickle.load(f).items():
                out.setdefault(mesh, []).append(res)
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every mesh's ranks, in a background thread started before the JAX
    references are built; ``result(mesh)`` waits. Also the job's numpy
    parameters and the CLI's checkpoint directories."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    job, params, tiny = _job(tmp)
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
    return {"result": result, "params": params, "tiny": tiny,
            "cli_dirs": job["meshes"][(2, 1)]["cases"][("cli",)]["dirs"]}


@pytest.fixture(scope="module")
def refs(spawned):
    """Every JAX reference of the module, built in this process once the
    ranks run (``spawned`` starts them): JAX's lockstep generate of each
    config and H²EAL off, and its unsharded train steps."""
    for arch in ARCHS:
        jax_generate(arch, "default", spawned["params"][arch])
    jax_generate("smollm", "head", spawned["params"]["smollm"], h2eal=False)
    for kw in TRAIN_KW:
        jax_train(kw, spawned["tiny"])
    return spawned


_JAX_GEN: dict = {}


def jax_generate(arch, layout, params, h2eal=True):
    """(tokens (B, GEN), logits (GEN + 1, B, V)) of JAX's lockstep
    generate(mesh=None) on the prompts of ``layout`` (``interleave``'s one
    prompt is row 0 of the others'), once a module. Every layout is held to
    the default's: the reference's lockstep ``coplace_shmap`` without an
    ambient mesh is the default body."""
    ref = "default"
    key = (arch, ref, h2eal)
    if key not in _JAX_GEN:
        jcfg = _configs(arch)[0]
        if not h2eal:
            import dataclasses
            jcfg = dataclasses.replace(jcfg, h2eal=dataclasses.replace(jcfg.h2eal,
                                                                      enabled=False))
        scfg = jserve.ServeConfig(capacity=CAP, layout=ref, impl="ref")
        prefill = jax.jit(jserve.make_prefill(jcfg, scfg))
        steps = [jax.jit(jserve.make_decode_step(jcfg, scfg, do_select=s))
                 for s in (False, True)]
        logits, state = prefill(params, _prompts("default"))
        rows, toks = [np.asarray(logits)], []
        for i in range(GEN):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            logits, state = steps[i % jcfg.h2eal.share_window == 0](params, state, tok)
            rows.append(np.asarray(logits))
        _JAX_GEN[key] = (np.stack(toks, 1), np.stack(rows))
    toks, logits = _JAX_GEN[key]
    b = _prompts(layout).shape[0]
    return toks[:b], logits[:, :b]


def _assert_near_tie(got, want, logits, what):
    """Each row's tokens equal, or parting first where JAX's top two logits
    lie within TIE_GAP. Returns whether every token is equal."""
    for b in range(want.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:
            top2 = np.sort(logits[diff[0], b])[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (
                f"{what} row {b} token {diff[0]} differs without a near-tie: "
                f"{got[b]} vs {want[b]}")
    return bool((got == want).all())


def _rank_bytes(tcfg, params, sizes, coords, mode):
    """The bytes of one rank's blocks of ``params`` placed by
    ``param_shardings(mode)`` on a mesh of ``sizes`` at ``coords``."""
    mesh = tmesh.Mesh(sizes=sizes, coords=coords)
    specs = tsharding.spec_leaves(params, tsharding.param_shardings(tcfg, mesh, params,
                                                                     mode))
    return sum(4 * int(np.prod([b - a for a, b in tsharding.block_bounds(x.shape, s, mesh)]))
               for x, s in zip(leaves(params), specs))


# ---------------------------------------------------------------------------
# generate(mesh=...)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_generate_on_a_mesh_matches_jax(refs, mesh, layout, arch):
    """Every rank's tokens equal each other's and JAX's generate(mesh=None)
    up to a near-tie, the last logits within 2e-4 where no token parted, and
    each rank holds its blocks of the parameters by
    ``param_shardings(mode="serve")``, no more."""
    ranks = refs["result"](mesh)
    got = [r["results"][("generate", arch, layout)] for r in ranks]
    for g in got[1:]:
        assert np.array_equal(g["tokens"], got[0]["tokens"])
    params = refs["params"][arch]
    want, logits = jax_generate(arch, layout, params)
    same = _assert_near_tie(got[0]["tokens"], want, logits, f"{layout} {mesh} {arch}")
    if layout == "coplace_shmap":
        toks, last = got[0]["one_card"]
        _assert_near_tie(got[0]["tokens"], toks, logits, f"{layout} against one card")
        if np.array_equal(got[0]["tokens"], toks):
            np.testing.assert_allclose(got[0]["last_logits"], last, atol=LOGIT_TOL, rtol=0)
    elif same:
        np.testing.assert_allclose(got[0]["last_logits"], logits[-1], atol=LOGIT_TOL,
                                   rtol=0)
    tcfg = _configs(arch)[1]
    whole = 4 * sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    tparams = params_from_numpy(tcfg, params, "meta")
    for r, g in zip(ranks, got):
        assert g["param_bytes"] == _rank_bytes(tcfg, tparams, *r["mesh"], "serve")
        assert (g["param_bytes"] < whole) == (mesh[1] > 1)


def test_generate_h2eal_off_on_a_mesh_matches_jax(refs):
    """H²EAL off (full caches on every layer, their rows over 'data' and kv
    heads over 'model') on ``head`` (2, 2): as above."""
    got = [r["results"][("generate", "smollm", "head_h2eal_off")]
           for r in refs["result"]((2, 2))]
    assert all(np.array_equal(g["tokens"], got[0]["tokens"]) for g in got)
    want, logits = jax_generate("smollm", "head", refs["params"]["smollm"], h2eal=False)
    if _assert_near_tie(got[0]["tokens"], want, logits, "head h2eal off"):
        np.testing.assert_allclose(got[0]["last_logits"], logits[-1], atol=LOGIT_TOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

_JAX_TRAIN: dict = {}


def jax_train(kw_name, params):
    """[(loss, grad_norm, lr_scale)] of STEPS of JAX's jitted unsharded
    make_train_step, and its final parameters, once a module."""
    if kw_name not in _JAX_TRAIN:
        jcfg = _configs(("smollm-360m", TINY))[0]
        step = jax.jit(jtrain.make_train_step(jcfg, jtrain.TrainConfig(**TRAIN_KW[kw_name])))
        p = jax.tree.map(jnp.asarray, params)
        o = jadamw.init_state(p)
        metrics = []
        for i in range(STEPS):
            batch = jlm_batch(jnp.int32(i), batch=BATCH, seq=SEQ, vocab=jcfg.vocab_size)
            p, o, m = step(p, o, batch, jnp.int32(i))
            metrics.append({k: float(v) for k, v in m.items()})
        _JAX_TRAIN[kw_name] = (metrics, _np_tree(p))
    return _JAX_TRAIN[kw_name]


@pytest.mark.parametrize("mesh,case,kw,fsdp",
                         [(m, c, k, f) for m, cs in TRAIN_CASES.items() for c, k, f in cs],
                         ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v))
def test_sharded_train_step_matches_jax(refs, mesh, case, kw, fsdp):
    """Two sharded steps against JAX's unsharded make_train_step: each step's
    loss, grad norm and lr scale to 1e-5 relative, the parameters to 1e-5
    (elements that AdamW's normalised step moved by ±lr on a near-zero
    gradient's sign counted, each within 2·lr·steps, at most one in a
    thousand). Every rank reports the same metrics and whole parameters;
    the leaves 'model' does not cut are bit-equal across the ranks; with
    FSDP forced, the weights are stored cut over 'data'."""
    spawned_ranks = refs["result"](mesh)
    ranks = [r["results"][("train", case)] for r in spawned_ranks]
    want_m, want_p = jax_train(kw, refs["tiny"])
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        assert all(np.array_equal(a, b) for a, b in zip(r["params"], ranks[0]["params"]))
        assert r["own"].keys() == ranks[0]["own"].keys()
    # a leaf 'model' does not cut: the same block on the ranks of a 'model'
    # group (one 'data' coordinate), on every rank where 'data' does not cut it
    data = [sr["mesh"][1][0] for sr in spawned_ranks]
    for r, d in zip(ranks, data):
        for path, (x, data_cut) in r["own"].items():
            peers = [q for q, e in zip(ranks, data) if e == d or not data_cut]
            assert all(np.array_equal(q["own"][path][0], x) for q in peers), path
    for i, (got, want) in enumerate(zip(ranks[0]["metrics"], want_m)):
        for key in ("loss", "grad_norm", "lr_scale"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    tcfg = _configs(("smollm-360m", TINY))[1]
    want = leaves(params_from_numpy(tcfg, want_p, "cpu"))
    flips, n, bound = 0, 0, 2 * TRAIN_KW[kw]["lr"] * STEPS
    for got, w in zip(ranks[0]["params"], want):
        off = np.abs(got - w.numpy())
        flips += int((off > PARAM_TOL).sum())
        n += off.size
        assert off.max() <= bound
    assert flips <= n // 1000, (flips, n)
    sizes = dict(zip(("data", "model"), mesh))
    cut = {a for s in ranks[0]["specs"] for e in s if e
           for a in (e if isinstance(e, tuple) else (e,)) if sizes[a] > 1}
    assert ("data" in cut) == fsdp and ("model" in cut) == (mesh[1] > 1)


def test_train_cli_crash_resume_and_elastic_resume(spawned):
    """The training CLI over 2 gloo ranks, the reference CLI's mesh (2, 1): a
    run crashed at step 3 and resumed repeats the uninterrupted run's final
    loss exactly; one crashed at 3, resumed, crashed at 5 and resumed on one
    rank (no process group: the whole checkpoint cut onto one device) within
    1e-5 relative."""
    got = [r["results"][("cli",)] for r in spawned["result"]((2, 1))]
    assert got[0] == got[1]
    assert got[0]["resumed"] == got[0]["full"]
    d = spawned["cli_dirs"]["elastic"]
    assert train_cli.ckpt.latest_step(d) == 3
    loss = train_cli.main(CLI + ["--ckpt-dir", d])
    assert loss == pytest.approx(got[0]["full"], rel=LOSS_RTOL)


# ---------------------------------------------------------------------------
# one rank, refusals
# ---------------------------------------------------------------------------


def _one_rank(fn):
    """``fn(mesh)`` in a gloo process group of this process alone."""
    with tempfile.TemporaryDirectory() as tmp:
        tmesh.init_distributed("gloo", store_path=os.path.join(tmp, "store"), rank=0,
                               world_size=1)
        try:
            return fn(tmesh.make_local_mesh())
        finally:
            dist.destroy_process_group()


def test_one_rank_mesh_equals_no_mesh(spawned):
    """On a one-rank mesh generate (each layout) and the sharded step compute
    what they do without a mesh, bit for bit: nothing is cut and no
    collective is sent."""
    jcfg, tcfg = _configs("smollm_kv1")
    params = params_from_numpy(tcfg, spawned["params"]["smollm_kv1"], "cpu")
    prompts = torch.as_tensor(_prompts("default"))
    want, ws = tlaunch.generate(tcfg, params, prompts, gen=GEN, capacity=CAP, device="cpu")
    tiny = params_from_numpy(_configs(("smollm-360m", TINY))[1], spawned["tiny"], "cpu")

    def run(mesh):
        for layout in LAYOUTS:
            got, gs = tlaunch.generate(tcfg, params, prompts, gen=GEN, capacity=CAP,
                                       layout=layout, mesh=mesh, device="cpu")
            if layout != "coplace_shmap":  # its select differs from the default's
                assert torch.equal(got, want) and torch.equal(gs["last_logits"],
                                                              ws["last_logits"]), layout
            assert gs["param_bytes"] == ws["param_bytes"]
        cfg = _configs(("smollm-360m", TINY))[1]
        for kw in TRAIN_KW.values():
            tc = ttrain.TrainConfig(**kw)
            a = ttrain.make_train_step(cfg, tc)
            b = ttrain.jit_train_step(cfg, tc, mesh, tiny, None, BATCH)
            pa, oa = tiny, adamw.init_state(tiny)
            pb, ob = ttrain.place_train_state(cfg, mesh, tiny, adamw.init_state(tiny))
            for i in range(STEPS):
                batch = lm_batch(i, batch=BATCH, seq=SEQ, vocab=cfg.vocab_size)
                pa, oa, ma = a(pa, oa, batch, i)
                pb, ob, mb = b(pb, ob, batch, i)
                assert all(torch.equal(ma[k], mb[k]) for k in ma)
                assert all(torch.equal(x, y) for x, y in zip(leaves(pa), leaves(pb)))
    _one_rank(run)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "zamba2-2.7b", "xlstm-125m",
                                  "gemma3-1b", "internvl2-1b"])
def test_mesh_refusals(arch):
    """On a mesh, generate and the sharded step refuse a frontend stub with
    the GSPMD layouts' refusal, nothing sent before the refusal. The MoE,
    recurrent and local:global stacks run on a mesh (ROADMAP item 9d): on a
    one-rank mesh generate (default and head) and two sharded steps compute
    what they do without a mesh, bit for bit (their meshes of 2 and 4 ranks:
    ``tests/test_torch_tp_families.py``)."""
    cfg = tconfigs.reduced(tconfigs.get_arch(arch))
    if cfg.embed_frontend_stub:
        mesh = tmesh.Mesh(sizes=(1, 2), coords=(0, 1))
        params = TM.init_params(cfg, generator=None, device="meta")
        with pytest.raises(ValueError, match=STUB_ENGINE_REFUSAL[:40]):
            tlaunch.generate(cfg, params, torch.zeros((2, 8), dtype=torch.long), gen=2,
                             capacity=32, layout="head", mesh=mesh, device="cpu")
        with pytest.raises(ValueError, match=STUB_ENGINE_REFUSAL[:40]):
            ttrain.jit_train_step(cfg, ttrain.TrainConfig(), mesh, params, None, 4)
        return
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.as_tensor(np.random.default_rng(3).integers(0, 512, (2, 24)))
    want, ws = tlaunch.generate(cfg, params, prompts, gen=4, capacity=32, device="cpu")
    tc = ttrain.TrainConfig(**TRAIN_KW["f32"])

    def run(mesh):
        for layout in ("default", "head"):
            got, gs = tlaunch.generate(cfg, params, prompts, gen=4, capacity=32,
                                       layout=layout, mesh=mesh, device="cpu")
            assert torch.equal(got, want) and torch.equal(gs["last_logits"],
                                                          ws["last_logits"]), layout
        a = ttrain.make_train_step(cfg, tc)
        b = ttrain.jit_train_step(cfg, tc, mesh, params, None, BATCH)
        pa, oa = params, adamw.init_state(params)
        pb, ob = ttrain.place_train_state(cfg, mesh, params, adamw.init_state(params))
        for i in range(STEPS):
            batch = lm_batch(i, batch=BATCH, seq=SEQ, vocab=cfg.vocab_size)
            pa, oa, ma = a(pa, oa, batch, i)
            pb, ob, mb = b(pb, ob, batch, i)
            assert all(torch.equal(ma[k], mb[k]) for k in ma)
            assert all(torch.equal(x, y) for x, y in zip(leaves(pa), leaves(pb)))
    _one_rank(run)


def test_batch_must_divide_microbatches_times_data():
    """``B % (microbatches · data)`` other than 0 raises."""
    cfg = _configs(("smollm-360m", TINY))[1]
    params = TM.init_params(cfg, generator=None, device="meta")
    mesh = tmesh.Mesh(sizes=(2, 1), coords=(0, 0))
    with pytest.raises(ValueError, match="does not divide"):
        ttrain.jit_train_step(cfg, ttrain.TrainConfig(microbatches=2), mesh, params, None, 6)
    ttrain.jit_train_step(cfg, ttrain.TrainConfig(microbatches=2), mesh, params, None, 8)
