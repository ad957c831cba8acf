"""PyTorch port, the frontend-stub families against the JAX package
(``impl="ref"``) on the CPU: internvl2-1b (reduced, and reduced with its 14
query heads over 2 kv heads, a GQA group of 7) and musicgen-large (reduced:
MHA). A stub arch takes precomputed embeddings where another takes token
ids, and has no ``embed`` leaf.

Both sides get the same numpy-seeded embeddings and weights (numpy draws
in JAX's init layout, bridged). Held: ``forward`` logits, ``lm_loss``, two
``make_train_step`` steps, ``prefill`` logits and serve state, and 8
``decode_step``s fed embeddings (select and reuse steps); f32 embeddings
over bf16 weights promoting the stack to f32 on both sides; the engine's
construction (packed admission) and its ``prefill_chunk`` and
``spec_tokens`` refusals on both sides; and where the reference's
``Engine.run`` and ``generate`` fail (they feed token ids where an
embedding is due, ROADMAP Queue 3), the port's clear refusal. Tolerances
(EXPERIMENTS.md:250-266): logits and caches 2e-4 (f32, after the whole
stack); losses 1e-5 relative; parameters after AdamW 1e-5, with
``test_torch_train.py``'s count of near-zero-gradient sign flips. Each JAX
program is built once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import lm_batch as jlm_batch
from repro.launch import serve as jlaunch
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.runtime import serve as jserve
from repro.runtime import train as jtrain
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core.tree import leaves, leaves_with_paths
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as ttrain_cli
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.runtime import train as ttrain
from repro_torch.serving.engine import Engine, Request
from test_torch_recurrent import numpy_params
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

LOGIT_TOL = 2e-4
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
B, S, STEPS = 2, 40, 8
CAP = S + STEPS + 8  # prompt + decode steps + one page of the reduced configs
CASES = {
    "internvl2-1b": ("internvl2-1b", {}),
    "internvl2-1b-g7": ("internvl2-1b", dict(num_heads=14, num_kv_heads=2)),
    "musicgen-large": ("musicgen-large", {}),
}
TRAIN = dict(remat=True, lr=1e-2, warmup=2, total_steps=10)


def _embeds(cfg, shape, seed):
    """Seeded embeddings of the model's width (the reduced configs keep the
    reference's frontend_dim, but the stack takes d_model-wide inputs)."""
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class Case:
    """One config's JAX runs, made once a module: forward, two train steps,
    prefill and the 8 decode steps."""

    def __init__(self, name):
        arch, kw = CASES[name]
        self.jcfg = jconfigs.reduced(jconfigs.get_arch(arch), **kw)
        self.tcfg = tconfigs.reduced(tconfigs.get_arch(arch), **kw)
        self.jparams = numpy_params(self.jcfg, seed=1)
        self.tree = _np(self.jparams)
        self.x = _embeds(self.jcfg, (B, S), 2)
        self.xdec = [_embeds(self.jcfg, (B,), 10 + i) for i in range(STEPS)]
        self.logits = np.asarray(jax.jit(lambda p, x: JM.forward(self.jcfg, p, x))(
            self.jparams, self.x))
        step = jax.jit(jtrain.make_train_step(self.jcfg, jtrain.TrainConfig(**TRAIN)))
        p, o = self.jparams, jadamw.init_state(self.jparams)
        self.batches, self.metrics = [], []
        for i in range(2):
            labels = np.array(jlm_batch(jnp.int32(i), batch=B, seq=S,
                                        vocab=self.jcfg.vocab_size)["labels"])
            batch = {"tokens": _embeds(self.jcfg, (B, S), 20 + i), "labels": labels}
            p, o, m = step(p, o, batch, jnp.int32(i))
            self.batches.append(batch)
            self.metrics.append({k: float(v) for k, v in m.items()})
        self.trained = _np(p)
        scfg = jserve.ServeConfig(capacity=CAP, impl="ref")
        lg, st = jax.jit(jserve.make_prefill(self.jcfg, scfg))(self.jparams, self.x)
        self.prefill = (np.asarray(lg), _np(st))
        steps = {s: jax.jit(jserve.make_decode_step(self.jcfg, scfg, do_select=s))
                 for s in (True, False)}
        self.decode = []
        for i, x in enumerate(self.xdec):
            lg, st = steps[i % 2 == 0](self.jparams, st, x)
            self.decode.append(np.asarray(lg))

    def tparams(self):
        return params_from_numpy(self.tcfg, self.tree, "cpu")


_CASES = {}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    if request.param not in _CASES:
        _CASES[request.param] = Case(request.param)
    return _CASES[request.param]


def _close(got, want, tol=LOGIT_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=tol, rtol=0, err_msg=msg)


def test_stub_params_have_no_embed_and_pass_the_check(case):
    """No ``embed`` leaf on either side, the bridge maps every other leaf,
    and the port's init makes the same set of leaves."""
    assert "embed" not in case.tree
    tp = case.tparams()
    assert "embed" not in tp and "lm_head" in tp
    TT.check_ported(case.tcfg)
    own = TM.init_params(case.tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert [p for p, _ in leaves_with_paths(own)] == [p for p, _ in leaves_with_paths(tp)]
    if case.tcfg.num_heads == 14:
        assert TT.attn_spec(case.tcfg).group == 7


def test_forward_and_lm_loss_match_jax(case):
    """Training forward logits (B, S, V) from (B, S, d) embeddings to 2e-4,
    and lm_loss (remat) against the loss JAX's train step reported at the
    initial weights to 1e-5 relative."""
    tp = case.tparams()
    _close(TM.forward(case.tcfg, tp, torch.from_numpy(case.x)).detach().numpy(),
           case.logits)
    b0 = case.batches[0]
    loss = TM.lm_loss(case.tcfg, tp, torch.from_numpy(b0["tokens"]),
                      torch.from_numpy(b0["labels"]))
    np.testing.assert_allclose(loss.item(), case.metrics[0]["loss"], rtol=LOSS_RTOL)


def test_train_steps_match_jax(case):
    """Two make_train_step steps on embedding batches (labels from
    lm_batch): loss, grad norm and lr scale each step to 1e-5 relative, the
    parameters to 1e-5 but for the sign flips AdamW makes of a near-zero
    gradient (each within 2·lr·steps, at most a thousandth of them)."""
    step = ttrain.make_train_step(case.tcfg, ttrain.TrainConfig(**TRAIN))
    p = case.tparams()
    o = adamw.init_state(p)
    for i, batch in enumerate(case.batches):
        p, o, m = step(p, o, {k: torch.from_numpy(v) for k, v in batch.items()}, i)
        for key in ("loss", "grad_norm", "lr_scale"):
            np.testing.assert_allclose(m[key].item(), case.metrics[i][key], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    flips, bound = 0, 2 * TRAIN["lr"] * len(case.batches)
    want = params_from_numpy(case.tcfg, case.trained, "cpu")
    for (path, got), w in zip(leaves_with_paths(p), leaves(want)):
        off = (got - w).abs()
        flips += int((off > PARAM_TOL).sum())
        assert off.max().item() <= bound, path
    assert flips <= sum(x.numel() for x in leaves(p)) // 1000


def test_prefill_state_and_decode_match_jax(case):
    """prefill on (B, S, d) embeddings: logits to 2e-4 and every cache field
    of every layer (pages, τ, page starts, the streaming ring) to 2e-4, the
    integer fields exactly; then 8 decode_steps fed (B, d) embeddings,
    select and reuse steps in turn, each step's logits to 2e-4."""
    tp = case.tparams()
    with torch.no_grad():
        lg, st = TM.prefill(case.tcfg, tp, torch.from_numpy(case.x), capacity=CAP)
        jl, jst = case.prefill
        _close(lg.numpy(), jl, msg="prefill logits")
        assert st["length"] == S and int(jst["length"]) == S
        for i, layer in enumerate(st["layers"]):
            for kind, cache in layer.items():
                want = jst["blocks"]["pos0"][kind]
                for field, t in dataclasses.asdict(cache).items():
                    w = np.asarray(getattr(want, field))[i]
                    msg = f"layer {i} {kind}.{field}"
                    if t.is_floating_point():
                        _close(t.numpy(), w, msg=msg)
                    else:
                        np.testing.assert_array_equal(t.numpy(), w, err_msg=msg)
        for i, x in enumerate(case.xdec):
            lg, st = TM.decode_step(case.tcfg, tp, st, torch.from_numpy(x),
                                    do_select=i % 2 == 0)
            _close(lg.numpy(), case.decode[i], msg=f"decode step {i}")


_PROMOTE = {}


def test_f32_embeddings_over_bf16_weights_promote_as_jax():
    """bf16 weights fed f32 embeddings: both sides promote the stack to
    f32 (no cast of the embeddings, as the reference), so the logits and
    the caches are f32 and agree to 2e-4, prefill and a select step."""
    if not _PROMOTE:
        jcfg = jconfigs.reduced(jconfigs.get_arch("internvl2-1b"), num_heads=14,
                                num_kv_heads=2)
        jparams = numpy_params(jcfg, seed=3, dtype=jnp.bfloat16)
        x = _embeds(jcfg, (B, S), 4)
        xs = [_embeds(jcfg, (B,), 5)]
        scfg = jserve.ServeConfig(capacity=CAP, impl="ref")
        lg, st = jax.jit(jserve.make_prefill(jcfg, scfg))(jparams, x)
        out = [(np.asarray(lg), str(lg.dtype), str(st["blocks"]["pos0"]["paged"].k_pages.dtype))]
        lg, st = jax.jit(jserve.make_decode_step(jcfg, scfg, do_select=True))(
            jparams, st, xs[0])
        out.append((np.asarray(lg), str(lg.dtype), None))
        _PROMOTE.update(tree=_np(jparams), x=x, xs=xs, out=out)
    tcfg = tconfigs.reduced(tconfigs.get_arch("internvl2-1b"), num_heads=14, num_kv_heads=2)
    tp = params_from_numpy(tcfg, _PROMOTE["tree"], "cpu")
    assert tp["lm_head"].dtype == torch.bfloat16
    out = _PROMOTE["out"]
    with torch.no_grad():
        lg, st = TM.prefill(tcfg, tp, torch.from_numpy(_PROMOTE["x"]), capacity=CAP)
        assert (str(lg.dtype), out[0][1]) == ("torch.float32", "float32")
        assert st["layers"][0]["paged"].k_pages.dtype == torch.float32
        assert out[0][2] == "float32"
        _close(lg.numpy(), out[0][0], msg="prefill logits")
        for i, xi in enumerate(_PROMOTE["xs"]):
            lg, st = TM.decode_step(tcfg, tp, st, torch.from_numpy(xi), do_select=i == 0)
            assert lg.dtype == torch.float32 and out[i + 1][1] == "float32"
            _close(lg.numpy(), out[i + 1][0], msg=f"decode step {i}")


def _engines(name):
    jcfg = jconfigs.reduced(jconfigs.get_arch(name))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    jparams = numpy_params(jcfg, seed=6)
    return jcfg, jparams, tcfg, params_from_numpy(tcfg, _np(jparams), "cpu")


@pytest.mark.parametrize("name", ["internvl2-1b", "musicgen-large"])
def test_engine_construction_and_refusals_match_jax(name):
    """Both engines construct with packed admission; both refuse
    ``prefill_chunk`` and ``spec_tokens`` with the reference's messages; the
    reference's ``prefill_chunk`` asserts and the port's raises with the
    same message."""
    jcfg, jparams, tcfg, tparams = _engines(name)
    kw = dict(max_batch=1, capacity=CAP, prompt_buckets=[16])
    JEngine(jcfg, jparams, **kw)
    eng = Engine(tcfg, tparams, device="cpu", **kw)
    assert eng.jit_cache_sizes() == {}
    for extra, match in ((dict(prefill_chunk=4), "frontend-stub"),
                         (dict(spec_tokens=2), "frontend-stub archs are unsupported")):
        with pytest.raises(ValueError, match=match):
            JEngine(jcfg, jparams, **kw, **extra)
        with pytest.raises(ValueError, match=match):
            Engine(tcfg, tparams, device="cpu", **kw, **extra)
    chunk = dict(chunk_len=np.full(1, 4, np.int32), active=np.ones(1, bool))
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(AssertionError, match="prefill-then-pack admission"):
        JM.prefill_chunk(jcfg, jparams, None, tokens, **chunk)
    with pytest.raises(ValueError, match="prefill-then-pack admission"):
        TM.prefill_chunk(tcfg, tparams, None, torch.from_numpy(tokens),
                         **{k: torch.from_numpy(v) for k, v in chunk.items()})


def test_port_refuses_where_the_reference_engine_and_generate_fail():
    """The reference's Engine.run feeds token ids where an embedding is due
    (its packed prefill the prompt's ids; its decode steps sampled ids) and
    fails in broadcasting, and its generate, fed embeddings, fails at the
    first decode step it feeds an argmax id; the port's submit, run,
    generate and serve CLI raise a ValueError naming that gap, and its
    training CLI refuses the lm_batch token ids the reference's CLI feeds
    such an arch."""
    jcfg, jparams, tcfg, tparams = _engines("internvl2-1b")
    kw = dict(max_batch=1, capacity=CAP, prompt_buckets=[16])
    prompt = np.arange(16, dtype=np.int32)
    with pytest.raises((TypeError, ValueError), match="broadcast"):
        JEngine(jcfg, jparams, **kw).run([JRequest(uid=0, prompt=prompt, max_new=2)])
    with pytest.raises(TypeError, match="broadcast"):
        jlaunch.generate(jcfg, jparams, jnp.asarray(_embeds(jcfg, (2, 16), 7)), gen=2,
                         capacity=CAP)
    eng = Engine(tcfg, tparams, device="cpu", **kw)
    with pytest.raises(ValueError, match="frontend-stub"):
        eng.submit(Request(uid=0, prompt=prompt, max_new=2))
    with pytest.raises(ValueError, match="frontend-stub"):
        eng.run()
    with pytest.raises(ValueError, match="frontend-stub"):
        tlaunch.generate(tcfg, tparams, torch.from_numpy(_embeds(tcfg, (1, 16), 7)), gen=2,
                         capacity=CAP, device="cpu")
    with pytest.raises(ValueError, match="frontend-stub"):
        tlaunch.main(["--arch", "internvl2-1b", "--reduced", "--device", "cpu"])
    with pytest.raises(ValueError, match="precomputed embeddings"):
        ttrain_cli.main(["--arch", "musicgen-large", "--reduced", "--steps", "1",
                         "--device", "cpu"])
