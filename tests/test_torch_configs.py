"""PyTorch port, the configs it registers: the dense stacks internlm2-20b
and qwen2-72b (QKV bias) against the JAX package at their reduced sizes on
the CPU, and which families the port serves (the MoE family since its
slice: tests/test_torch_moe.py; the recurrent mixers since theirs:
tests/test_torch_recurrent.py; the frontend stubs since theirs:
tests/test_torch_frontend.py) and what it refuses (a mixer that is not the
reference's).

Every registered config equals the JAX config of the same name field for
field (``tests/test_torch_serve.py::test_configs_equal_the_jax_ones_field_for_field``,
parametrised over the port's registry). Tolerance: logits 2e-4 (f32, after
the whole stack).
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
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

LOGIT_TOL = 2e-4


@pytest.mark.parametrize("name", ["internlm2-20b", "qwen2-72b"])
def test_dense_config_prefill_and_decode_match_jax(name):
    """Prefill logits and 4 decode steps (select and reuse) of the reduced
    model equal JAX's to 2e-4; qwen2's QKV biases are bridged and applied."""
    jcfg = jconfigs.reduced(jconfigs.get_arch(name))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jparams)
    if jcfg.qkv_bias:  # the init's biases are zeros: make them count
        rng = np.random.default_rng(0)
        for leaf in ("bq", "bk", "bv"):
            a = tree["blocks"]["pos0"][leaf]
            tree["blocks"]["pos0"][leaf] = rng.standard_normal(a.shape).astype(a.dtype)
        jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tcfg, tree, "cpu")
    assert ("bq" in tparams["layers"][0]) == (name == "qwen2-72b")
    prompts = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    cap = 40 + 4 + jcfg.h2eal.page_size
    scfg = jserve.ServeConfig(capacity=cap, impl="ref")
    jl, jst = jax.jit(jserve.make_prefill(jcfg, scfg))(jparams, jnp.asarray(prompts))
    tl, tst = TM.prefill(tcfg, tparams, torch.from_numpy(prompts), capacity=cap)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    steps = [jax.jit(jserve.make_decode_step(jcfg, scfg, do_select=s)) for s in (False, True)]
    for i in range(4):
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        jl, jst = steps[i % 2 == 0](jparams, jst, jnp.asarray(tok))
        tl, tst = TM.decode_step(tcfg, tparams, tst, torch.from_numpy(tok),
                                 do_select=i % 2 == 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"decode step {i}")


@pytest.mark.parametrize("name", ["gemma3-1b", "internlm2-20b", "qwen2-72b",
                                  "smollm-360m", "llama3-8b", "qwen3-moe-235b-a22b",
                                  "kimi-k2-1t-a32b", "zamba2-2.7b", "xlstm-125m",
                                  "internvl2-1b", "musicgen-large"])
def test_served_families_pass_the_check(name):
    TT.check_ported(tconfigs.get_arch(name))
    TT.check_ported(tconfigs.reduced(tconfigs.get_arch(name)))


@pytest.mark.parametrize("change", [
    dict(embed_frontend_stub=True, mixer_pattern=("retnet", "attention")),
], ids=["frontend-stub"])
def test_unported_families_raise_citing_item_11(change):
    """Every family of the reference is served since the frontend stubs'
    slice (item 11): what is left to refuse is a mixer the reference does
    not have, here on a frontend-stub config (which alone passes)."""
    base = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch("smollm-360m")),
                               embed_frontend_stub=True)
    TT.check_ported(base)
    cfg = dataclasses.replace(base, **change)
    with pytest.raises(NotImplementedError, match="item 11"):
        TT.check_ported(cfg)
    with pytest.raises(NotImplementedError, match="item 11"):
        TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        TM.empty_serve_state(cfg, 1, capacity=32, dtype=torch.float32, device="cpu")
