"""PyTorch port, the GSPMD layouts ``head``, ``coplace`` and ``interleave``
served over ``torch.distributed`` ranks, against the JAX package on the CPU.

S = 1: in this process, a gloo group of one rank (a ``FileStore`` under the
test's temporary directory, destroyed after the module), each layout's
engine, packed and chunked, greedy and one sampled request, against the
JAX engine of the same layout on its one-device mesh, token for token.

S = 2 and 4: ranks spawned as processes (``tests/_torch_mesh_worker.py``,
which imports no JAX): one spawn of 4 processes runs every mesh in turn,
each as its own process group of the ranks it needs, with every case of
the mesh inside it, in the background while this process runs the S = 1
cases; the JAX default-layout engines they are held to compile meanwhile
in a subprocess of their own (``jax_default_traces``). Meshes
(data, model): (1, 2) for ``head`` and ``coplace``, (1, 4) for
``coplace``, (2, 2) for ``interleave`` at ``max_batch`` 3 (the batch
cannot take 'data', so the tokens stripe within pages), and there the
layer steps of ``head`` and ``coplace`` at 2 slots (the batch over
'data'). The config is
``reduced(get_arch("llama3-8b"), num_heads=8, num_kv_heads=4)``, whose 2
retrieval and 2 streaming kv heads divide 'model' at 2, and plain reduced
smollm, whose single kv head of each kind does not: the reference's
``_div`` rule replicates them. Every rank's tokens must equal each other's
and the JAX default-layout engine's on the same workload and weights, up
to a JAX near-tie (the rule of tests/test_torch_engine.py: the co-placed
layouts reassociate the attention sum, as ``coplace_shmap`` does). Each
mesh also holds one layer's select, reuse and chunk steps on the ranks'
blocks against the port's default body on the whole state: outputs within
2e-5, every cache field of each block equal to its tile of the default's
state (the importance within 1e-6 of its magnitude: where the pages are
cut its scores are summed in another order).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tlaunch
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import graphs
from repro_torch.serving.engine import Engine, Request
from test_torch_engine import CAP, Model
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

TESTS = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(TESTS, "_torch_mesh_worker.py")
GSPMD = ("head", "coplace", "interleave")
LLAMA = ("llama3-8b", (("num_heads", 8), ("num_kv_heads", 4)))
SMOLLM = ("smollm-360m", ())
TOL, IMP_TOL = 2e-5, 1e-6
ENGINE = dict(capacity=CAP, prompt_buckets=[16, 24])
# (data, model) meshes of the spawned runs and their cases: (layout, arch,
# max_batch, engine modes); every llama case also checks one layer's steps
MESHES = {
    (1, 2): [("head", LLAMA, 2, ("packed", "chunked")),
             ("coplace", LLAMA, 2, ("packed", "chunked")),
             ("head", SMOLLM, 2, ("chunked",))],
    (1, 4): [("coplace", LLAMA, 2, ("packed", "chunked"))],
    (2, 2): [("interleave", LLAMA, 3, ("packed", "chunked")),
             ("head", LLAMA, 2, ()), ("coplace", LLAMA, 2, ())],
}
MODES = {"packed": None, "chunked": 5}


class Arch(Model):
    """``test_torch_engine.Model`` of a reduced config with overrides."""

    def __init__(self, name, overrides):
        self.jcfg = jconfigs.reduced(jconfigs.get_arch(name), **dict(overrides))
        self.tcfg = tconfigs.reduced(tconfigs.get_arch(name), **dict(overrides))
        self.jparams = JM.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.numpy_params = jax.tree.map(np.asarray, self.jparams)
        self.tparams = params_from_numpy(self.tcfg, self.numpy_params, "cpu")
        self._engines = {}
        self._steps = {}

    def jax_engine_run(self, requests, *, layout="default", prefill_chunk=None):
        """Tokens of a JAX engine of ``layout`` (its default one-device mesh),
        built once per (layout, mode)."""
        key = (layout, prefill_chunk)
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = JEngine(self.jcfg, self.jparams, max_batch=2,
                                               layout=layout,
                                               prefill_chunk=prefill_chunk, **ENGINE)
        eng.reset_metrics()
        comps = eng.run([JRequest(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                                  temperature=r.temperature, top_p=r.top_p,
                                  seed=r.seed) for r in requests])
        return {u: c.tokens for u, c in comps.items()}


def _workload(cfg, sampled=False):
    """The mixed workload of tests/test_serving.py (5 greedy requests,
    prompts of 16 and 24, budgets 3..11), and with ``sampled`` one request
    at temperature 0.8, top-p 0.9."""
    rng = np.random.default_rng(2)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=([16, 24][i % 2],)).astype(np.int32),
                    max_new=3 + 2 * i) for i in range(5)]
    if sampled:
        reqs.append(Request(uid=5, prompt=rng.integers(0, cfg.vocab_size, size=(16,))
                            .astype(np.int32), max_new=6, temperature=0.8, top_p=0.9,
                            seed=3))
    return reqs


# the JAX default-layout engines the spawned ranks are held to: (arch, mode)
JAX_DEFAULT = [(LLAMA, "packed"), (LLAMA, "chunked"), (SMOLLM, "chunked")]
JAX_SUBPROCESS = """
import pickle, sys
sys.path.insert(0, {tests!r})
import test_torch_layouts as L
with open(sys.argv[1], "wb") as f:
    pickle.dump(L.jax_default_traces(), f)
"""


def jax_default_traces():
    """{(arch, mode): tokens} of the JAX default-layout engines of
    JAX_DEFAULT on the greedy workload."""
    archs, out = {}, {}
    for arch, mode in JAX_DEFAULT:
        a = archs.get(arch) or archs.setdefault(arch, Arch(*arch))
        out[(arch, mode)] = a.jax_engine_run(_workload(a.tcfg), prefill_chunk=MODES[mode])
    return out


def _req_dict(r):
    return dict(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                temperature=r.temperature, top_p=r.top_p, seed=r.seed)


@pytest.fixture(scope="module")
def archs():
    return {LLAMA: Arch(*LLAMA), SMOLLM: Arch(*SMOLLM)}


def _job(archs, tmp):
    """Every mesh of MESHES with its engine cases and step checks."""
    meshes = {}
    for (data, model), cases in MESHES.items():
        world = data * model
        job = {"world": world, "model": model, "cases": {},
               "store": os.path.join(tmp, f"store_{data}x{model}")}
        for layout, arch, max_batch, modes in cases:
            a = archs[arch]
            for mode in modes:
                chunk = MODES[mode]
                job["cases"][(layout, arch, mode)] = {
                    "kind": "engine", "arch": arch[0], "overrides": dict(arch[1]),
                    "params": a.numpy_params, "layout": layout,
                    "engine": dict(max_batch=max_batch, prefill_chunk=chunk, **ENGINE),
                    "requests": [_req_dict(r) for r in _workload(a.tcfg)]}
            if arch == LLAMA:
                b = max_batch
                job["cases"][(layout, "steps", b)] = {
                    "kind": "steps", "arch": arch[0], "overrides": dict(arch[1]),
                    "layout": layout, "batch": b, "capacity": CAP, "chunk": 5,
                    "seed": 7, "lengths": [40, 9, 57][:b] if b == 3 else [40, 57],
                    "active": [True, False, True][:b] if b == 3 else [True, True],
                    "need": [True, True, False] if b == 3 else [True, False],
                    "chunk_len": [5, 3, 0] if b == 3 else [5, 0]}
        meshes[(data, model)] = job
    return {"ranks": max(m["world"] for m in meshes.values()), "meshes": meshes}


def _run_job(job, path):
    """Start the job's processes, wait, and return {mesh: [each rank's
    results]}."""
    with open(path, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(job["ranks"])]
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"process {r} failed:\n{logs[r][-3000:]}"
    out = {}
    for r in range(job["ranks"]):
        with open(f"{path}.{r}", "rb") as f:
            for mesh, res in pickle.load(f).items():
                out.setdefault(mesh, []).append(res)
    return out


@pytest.fixture(scope="module")
def spawned(archs, tmp_path_factory):
    """Every mesh's ranks, in a background thread started before the JAX
    references are built; ``result(mesh)`` waits."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    job = _job(archs, tmp)
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
    return result


@pytest.fixture(scope="module")
def jax_default(tmp_path_factory):
    """JAX_DEFAULT's engines in a subprocess, started with the module's first
    test, so that they compile while this process runs the S = 1 cases;
    ``result()`` waits and reads them."""
    tmp = tmp_path_factory.mktemp("jax_default")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(TESTS), "src"), os.environ.get("PYTHONPATH", "")]))
    with open(tmp / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", JAX_SUBPROCESS.format(tests=TESTS),
                                 str(tmp / "traces.pkl")], stdout=subprocess.DEVNULL,
                                stderr=err, env=env)
    done = []

    def result():
        if not done:
            proc.wait(timeout=600)
            assert proc.returncode == 0, (tmp / "stderr.txt").read_text()[-4000:]
            with open(tmp / "traces.pkl", "rb") as f:
                done.append(pickle.load(f))
        return done[0]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo process group of this process alone, and its (1, 1) mesh."""
    store = str(tmp_path_factory.mktemp("gloo1") / "store")
    tmesh.init_distributed("gloo", store_path=store, rank=0, world_size=1)
    try:
        yield tmesh.make_local_mesh()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# S = 1: the engines against the JAX engine of the same layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", GSPMD)
def test_one_rank_engine_matches_jax_layout(archs, spawned, jax_default, one_rank, layout,
                                            mode):
    """smollm at S = 1 through each GSPMD layout's engine, the greedy
    workload and a sampled request, against the JAX engine of the layout:
    token for token (a greedy token up to a JAX near-tie)."""
    m = archs[SMOLLM]
    assert one_rank.shape == {"data": 1, "model": 1} and one_rank.backend == "gloo"
    reqs = _workload(m.tcfg, sampled=True)
    eng = Engine(m.tcfg, m.tparams, max_batch=2, layout=layout, mesh=one_rank,
                 prefill_chunk=MODES[mode], device="cpu", **ENGINE)
    assert eng.plan.shard_state and eng.plan.mesh is one_rank
    got = {u: c.tokens for u, c in eng.run(reqs).items()}
    want = m.jax_engine_run(reqs, layout=layout, prefill_chunk=MODES[mode])
    assert got[5] == want[5]
    m.assert_same({u: t for u, t in got.items() if u != 5},
                  {u: t for u, t in want.items() if u != 5}, reqs[:5])


def test_one_rank_fused_windows_and_balanced_admission(archs):
    """Fused decode windows (share window 4) and balanced admission on the
    GSPMD layouts at S = 1, without a process group (the default one-rank
    mesh): the tokens equal the port's default engine's."""
    m = archs[LLAMA]
    cfg = dataclasses.replace(m.tcfg, h2eal=dataclasses.replace(m.tcfg.h2eal,
                                                                share_window=4))
    reqs = _workload(cfg)
    kw = dict(max_batch=2, prefill_chunk=5, decode_window=4, device="cpu", **ENGINE)
    want = {u: c.tokens for u, c in Engine(cfg, m.tparams, **kw).run(reqs).items()}
    for layout in GSPMD:
        eng = Engine(cfg, m.tparams, layout=layout, admission="balanced", **kw)
        got = {u: c.tokens for u, c in eng.run(reqs).items()}
        assert eng.stats.fused_windows > 0 and got == want, layout


# ---------------------------------------------------------------------------
# S = 2 and 4: spawned ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES), ids=lambda m: f"{m[0]}x{m[1]}")
def test_ranks_match_each_other_and_jax(archs, spawned, jax_default, mesh):
    """Every engine case on every rank of the mesh: the ranks' tokens equal,
    equal to the JAX default-layout engine's (up to a JAX near-tie), and no
    step captured anew after construction."""
    ranks = spawned(mesh)
    assert [r["mesh"][0] for r in ranks] == [mesh] * len(ranks)
    for name, case in ranks[0]["results"].items():
        if name[1] == "steps":
            continue
        layout, arch, mode = name
        for r in ranks[1:]:
            assert r["results"][name]["tokens"] == case["tokens"], name
        before, after = case["captures"]
        assert before == after
        a = archs[arch]
        reqs = _workload(a.tcfg)
        a.assert_same(case["tokens"], jax_default()[(arch, mode)], reqs)


@pytest.mark.parametrize("mesh", list(MESHES), ids=lambda m: f"{m[0]}x{m[1]}")
def test_rank_blocks_match_the_default_body(spawned, mesh):
    """One layer's select, reuse and chunk steps on every rank's blocks
    against the default body on the whole state: outputs within 2e-5 and
    each block equal to its tile of the default's state."""
    for r in spawned(mesh):
        for name, res in r["results"].items():
            if name[1] != "steps":
                continue
            for step in res["steps"] + [res["chunk"]]:
                assert step["out"] <= TOL, (name, step)
                for field, diff in step["state"].items():
                    tol = IMP_TOL if field.endswith("importance") else 0.0
                    assert diff <= tol, (name, field, diff)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,what", [
    (dict(spec_tokens=2), "spec_tokens"), (dict(hot_pages=4), "hot_pages"),
    (dict(rebalance="retire"), "rebalance"),
])
def test_gspmd_engine_refusals(archs, kw, what):
    """What the GSPMD layouts do not serve yet raises and cites item 9b; none
    falls back to another layout."""
    m = archs[SMOLLM]
    with pytest.raises(NotImplementedError, match=f"{what}.*item 9b"):
        Engine(m.tcfg, m.tparams, max_batch=2, layout="coplace", device="cpu",
               **ENGINE, **kw)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-moe-235b-a22b", "zamba2-2.7b",
                                  "internvl2-1b"])
def test_gspmd_refuses_other_families(arch):
    cfg = tconfigs.reduced(tconfigs.get_arch(arch))
    with pytest.raises(NotImplementedError, match="item 9b"):
        Engine(cfg, {"final_norm": torch.zeros(cfg.d_model)}, max_batch=2,
               layout="head", device="cpu", **ENGINE)


def test_gspmd_capture_lockstep_and_cli_refusals(archs, one_rank):
    """A gloo mesh refuses CUDA-graph capture unless eager; lockstep
    ``generate`` on a GSPMD layout raises citing item 9c; the CLI refuses
    balanced admission for ``head``, which shards no pages, and a
    ``--mesh-model`` without a GSPMD layout."""
    with pytest.raises(ValueError, match="eager=True"):
        graphs.StepGraphs("cuda", mesh=one_rank)
    assert not graphs.StepGraphs("cuda", eager=True, mesh=one_rank).capture
    m = archs[SMOLLM]
    with pytest.raises(NotImplementedError, match="item 9c"):
        tlaunch.generate(m.tcfg, m.tparams, torch.zeros((1, 8), dtype=torch.long),
                         gen=2, capacity=32, layout="coplace", device="cpu")
    with pytest.raises(ValueError, match="shard pages"):
        tlaunch.run_ragged(m.tcfg, m.tparams, [], max_batch=2, layout="head",
                           admission="balanced", device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="GSPMD"):
        tlaunch.main(["--reduced", "--mesh-model", "2", "--device", "cpu"])


def test_gspmd_cli_serves_on_one_rank(capsys):
    """The CLI serves a GSPMD layout on one rank without torchrun."""
    stats = tlaunch.main(["--arch", "llama3-8b", "--reduced", "--workload", "ragged",
                          "--requests", "3", "--max-batch", "2", "--prompt-buckets",
                          "16,24", "--prefill-chunk", "8", "--layout", "interleave",
                          "--admission", "balanced", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "layout=interleave" in out and "mesh={'data': 1, 'model': 1}" in out
    assert stats["tokens_out"] > 0
