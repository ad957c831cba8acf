"""PyTorch port, serving: ``generate`` against the JAX package's
``generate(..., attn_impl="ref")`` on the same weights, and the port's
boundary rules (no JAX imports, configs copied field for field, the card
by default, the weight bridge).

Tolerance: last-position logits within 2e-4 at every step (f32, after the
whole layer stack); greedy tokens identical, unless the JAX logits of the
first differing step hold a near-tie (top-2 gap below 1e-3).
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.serve import generate as jax_generate
from repro.models import model as JM
from repro.runtime import serve as jserve
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import serve as tserve
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 2e-4
TIE_GAP = 1e-3
PROMPT, GEN = 41, 10


def _jax_setup(name, dtype=jnp.float32):
    cfg = jconfigs.reduced(jconfigs.get_arch(name))
    params = JM.init_params(cfg, jax.random.PRNGKey(0), dtype=dtype)
    return cfg, params


def _jax_greedy(cfg, params, prompts, gen, capacity):
    """The loop of JAX ``generate`` (its jitted select/reuse steps and greedy
    argmax), keeping each step's logits: (tokens (B, gen), [logits])."""
    scfg = jserve.ServeConfig(capacity=capacity, impl="ref")
    prefill = jax.jit(jserve.make_prefill(cfg, scfg))
    steps = [jax.jit(jserve.make_decode_step(cfg, scfg, do_select=s))
             for s in (False, True)]
    logits, state = prefill(params, prompts)
    toks, out = [], [np.asarray(logits)]
    w = cfg.h2eal.share_window
    for i in range(gen):
        toks.append(np.argmax(out[-1], axis=-1).astype(np.int32))
        logits, state = steps[i % w == 0](params, state, jnp.asarray(toks[-1]))
        out.append(np.asarray(logits))
    return np.stack(toks, axis=1), out


def _torch_forced(cfg, params, prompts, tokens, capacity):
    """The port's select/reuse steps fed the JAX tokens: [logits]."""
    scfg = tserve.ServeConfig(capacity=capacity)
    prefill = tserve.make_prefill(cfg, scfg)
    steps = [tserve.make_decode_step(cfg, scfg, do_select=s) for s in (False, True)]
    logits, state = prefill(params, torch.from_numpy(prompts))
    out = [logits.numpy()]
    w = cfg.h2eal.share_window
    for i in range(tokens.shape[1]):
        logits, state = steps[i % w == 0](params, state, torch.tensor(tokens[:, i]))
        out.append(logits.numpy())
    return out


def _disabled(cfg):
    return dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal, enabled=False))


@pytest.mark.parametrize("h2eal", [True, False], ids=["sparse", "full"])
@pytest.mark.parametrize("name", ["smollm-360m", "llama3-8b"])
def test_generate_matches_jax(name, h2eal):
    """Greedy tokens of the port's ``generate`` equal the JAX generate loop's;
    the logits of every step agree with the tokens fed to both sides."""
    jcfg, jparams = _jax_setup(name)
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    assert jcfg.tie_embeddings == (name == "smollm-360m")
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    capacity = PROMPT + GEN + jcfg.h2eal.page_size
    ttoks, _ = tlaunch.generate(tcfg, tparams, torch.from_numpy(prompts), gen=GEN,
                                capacity=capacity, h2eal=h2eal, device="cpu")
    assert ttoks.shape == (2, GEN) and ttoks.dtype == torch.int32
    if not h2eal:
        jcfg, tcfg = _disabled(jcfg), _disabled(tcfg)
    jtoks, jl = _jax_greedy(jcfg, jparams, jnp.asarray(prompts), GEN, capacity)
    if name == "llama3-8b" and h2eal:  # the loop is JAX generate's own
        ref_toks, _ = jax_generate(jcfg, jparams, jnp.asarray(prompts), gen=GEN,
                                   capacity=capacity, attn_impl="ref")
        np.testing.assert_array_equal(np.asarray(ref_toks), jtoks)
    tl = _torch_forced(tcfg, tparams, prompts, jtoks, capacity)
    for step, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"logits of step {step}")
    diff = np.argwhere(ttoks.numpy() != jtoks)
    if len(diff):
        row, step = diff[0]
        top2 = np.sort(jl[step][row])[-2:]
        assert top2[1] - top2[0] < TIE_GAP, (
            f"token {step} of row {row} differs without a near-tie")


def test_launch_counters_stay_zero_on_the_cpu():
    cfg = tconfigs.reduced(tconfigs.get_arch("llama3-8b"))
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    ops.reset_launches()
    toks, stats = tlaunch.generate(cfg, params, torch.zeros(1, 20, dtype=torch.int32),
                                   gen=3, capacity=40, device="cpu")
    assert set(ops.LAUNCHES.values()) == {0}
    assert torch.isfinite(stats["last_logits"]).all()


def test_generate_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = tconfigs.reduced(tconfigs.get_arch("smollm-360m"))
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.generate(cfg, params, torch.zeros(1, 8, dtype=torch.int32), gen=2,
                         capacity=24)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--reduced", "--prompt-len", "8", "--gen", "2"])


def test_generate_greedy_false_takes_the_argmax_as_jax():
    """``generate(greedy=False)`` is accepted and still takes the argmax, as
    the JAX package's ``generate`` does: the same call on both sides gives
    the same tokens (up to a near-tie), and the port's equal its greedy
    run."""
    jcfg, jparams = _jax_setup("llama3-8b")
    tcfg = tconfigs.reduced(tconfigs.get_arch("llama3-8b"))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                                (2, 24)).astype(np.int32)
    gen, capacity = 6, 24 + 6 + jcfg.h2eal.page_size
    jtoks, _ = jax_generate(jcfg, jparams, jnp.asarray(prompts), gen=gen,
                            capacity=capacity, greedy=False, attn_impl="ref")
    ttoks, _ = tlaunch.generate(tcfg, tparams, torch.from_numpy(prompts), gen=gen,
                                capacity=capacity, greedy=False, device="cpu")
    greedy, _ = tlaunch.generate(tcfg, tparams, torch.from_numpy(prompts), gen=gen,
                                 capacity=capacity, device="cpu")
    assert torch.equal(ttoks, greedy)
    jtoks = np.asarray(jtoks)
    diff = np.argwhere(ttoks.numpy() != jtoks)
    if len(diff):
        _, jl = _jax_greedy(jcfg, jparams, jnp.asarray(prompts), gen, capacity)
        row, step = diff[0]
        top2 = np.sort(jl[step][row])[-2:]
        assert top2[1] - top2[0] < TIE_GAP, f"token {step} of row {row} differs"


def test_cli_serves_on_the_cpu_when_asked(capsys):
    stats = tlaunch.main(["--arch", "llama3-8b", "--reduced", "--prompt-len", "24",
                          "--gen", "4", "--device", "cpu"])
    assert stats["tokens_per_s"] > 0
    assert "sample tokens" in capsys.readouterr().out


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("torch_*.py"))
             + sorted((ROOT / "examples").glob("torch_*.py"))
             + [ROOT / "tests" / "_torch_mesh_worker.py", ROOT / "tests" / "_torch_tp_worker.py"])
    assert len(files) > 15
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/serving/sampling.py",
            "src/repro_torch/serving/draft.py",
            "src/repro_torch/sched/tiling.py", "src/repro_torch/sched/mapping.py",
            "src/repro_torch/sched/cost.py", "src/repro_torch/sched/rebalance.py",
            "src/repro_torch/runtime/perfmodel.py", "src/repro_torch/hbsim/sim.py",
            "src/repro_torch/hbsim/__init__.py",
            "examples/torch_serve_longcontext.py",
            "src/repro_torch/optim/adamw.py", "src/repro_torch/optim/grad_compress.py",
            "src/repro_torch/data/pipeline.py", "src/repro_torch/ckpt/checkpoint.py",
            "src/repro_torch/core/gating.py", "src/repro_torch/core/tree.py",
            "src/repro_torch/runtime/train.py", "src/repro_torch/launch/train.py",
            "examples/torch_quickstart.py",
            "examples/torch_head_identification.py",
            "src/repro_torch/launch/mesh.py", "src/repro_torch/runtime/sharding.py",
            "src/repro_torch/runtime/collectives.py",
            "src/repro_torch/core/layouts.py", "src/repro_torch/core/cache.py",
            "src/repro_torch/core/hybrid_attention.py",
            "src/repro_torch/models/transformer.py", "src/repro_torch/models/model.py",
            "src/repro_torch/serving/engine.py", "src/repro_torch/launch/serve.py",
            "scripts/torch_gspmd_ranks.py", "chip_smoke.py",
            "tests/_torch_mesh_worker.py", "src/repro_torch/runtime/tensor_parallel.py",
            "scripts/torch_tp_ranks.py", "tests/_torch_tp_worker.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{f}: {mod}"


@pytest.mark.parametrize("name", sorted(tconfigs.REGISTRY))
def test_configs_equal_the_jax_ones_field_for_field(name):
    t, j = tconfigs.get_arch(name), jconfigs.get_arch(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tconfigs.reduced(t)) == dataclasses.asdict(jconfigs.reduced(j))
    assert t.h2eal.top_k_pages == j.h2eal.top_k_pages


def test_llama3_8b_serving_defaults():
    cfg = tconfigs.get_arch("llama3-8b")
    spec = TT.attn_spec(cfg)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == (
        32, 4096, 32, 8, 128, 14336, 128256)
    assert not cfg.tie_embeddings and cfg.rope_theta == 5e5
    assert (spec.n_retrieval, spec.n_streaming, spec.group) == (4, 4, 4)
    h2 = cfg.h2eal
    assert (h2.sink, h2.local, h2.page_size, h2.top_k_pages, h2.share_window) == (
        4, 256, 32, 128, 4)


def test_unported_families_raise():
    # the recurrent mixers (tests/test_torch_recurrent.py) and the frontend
    # stubs (tests/test_torch_frontend.py) are served; a mixer the
    # reference does not have is not
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch("smollm-360m")),
                              mixer_pattern=("retnet", "attention"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.check_ported(cfg)
    TT.check_ported(dataclasses.replace(cfg, mixer_pattern=("mamba2", "attention")))
    TT.check_ported(dataclasses.replace(cfg, mixer_pattern=(), embed_frontend_stub=True))


def test_bridge_round_trips_a_bf16_tree():
    jcfg, jparams = _jax_setup("llama3-8b", dtype=jnp.bfloat16)
    tcfg = tconfigs.reduced(tconfigs.get_arch("llama3-8b"))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = params_from_numpy(tcfg, tree, "cpu")

    def bits(x):
        return x.view(torch.int16).numpy()

    assert tparams["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(tparams["embed"]), tree["embed"].view(np.int16))
    np.testing.assert_array_equal(bits(tparams["lm_head"]), tree["lm_head"].view(np.int16))
    stacked = tree["blocks"]["pos0"]
    for i, layer in enumerate(tparams["layers"]):
        np.testing.assert_array_equal(bits(layer["wq"]), stacked["wq"][i].view(np.int16))
        np.testing.assert_array_equal(bits(layer["ffn"]["w_down"]),
                                      stacked["ffn"]["w_down"][i].view(np.int16))
    assert len(tparams["layers"]) == jcfg.num_layers
