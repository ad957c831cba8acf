"""PyTorch port, the one-card dry run and the mesh half of the byte model
against the JAX package on the CPU.

``runtime/perfmodel.py``'s ``decode_bytes`` (select and reuse steps),
``prefill_bytes``, ``train_bytes`` and ``cell_bytes`` equal the
reference's term for term (pure Python on both sides: exact) for every
assigned arch x shape on one card and on the reference's two production
meshes, under each layout. The meta-device parameters (``launch/specs.py``)
have the reference's ``param_specs`` numel; the serve state on the meta
device has the bytes of a real prefill's caches; the dry run's CLI runs.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.runtime import perfmodel as jperf
from repro_torch import configs as tconfigs
from repro_torch.core.tree import leaves
from repro_torch.launch import dryrun
from repro_torch.launch import specs
from repro_torch.models import model as TM
from repro_torch.runtime import perfmodel as tperf
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

# (chips, data, model): one card, the reference's 16x16 and 2x16x16 meshes
MESHES = [(1, 1, 1), (256, 16, 16), (512, 32, 16)]
LAYOUTS = ["head", "coplace", "interleave"]


def test_registry_and_shapes_equal_the_reference():
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("mesh", MESHES, ids=["1x1x1", "256x16x16", "512x32x16"])
def test_byte_model_equals_the_reference(mesh):
    """Every term of every function, every assigned arch and shape, each
    layout, with H²EAL on and off (the full-attention decode term)."""
    tm, jm = tperf.MeshModel(*mesh), jperf.MeshModel(*mesh)
    n = 0
    for name in jconfigs.ASSIGNED:
        for h2 in (True, False):
            jcfg, tcfg = jconfigs.get_arch(name), tconfigs.get_arch(name)
            if not h2:
                jcfg = dataclasses.replace(jcfg, h2eal=dataclasses.replace(
                    jcfg.h2eal, enabled=False))
                tcfg = dataclasses.replace(tcfg, h2eal=dataclasses.replace(
                    tcfg.h2eal, enabled=False))
            for sname in jconfigs.SHAPES:
                js, ts = jconfigs.SHAPES[sname], tconfigs.SHAPES[sname]
                # the reference's train_bytes never reads its microbatches;
                # the port's has no such parameter
                pairs = [(tperf.prefill_bytes(tcfg, ts, tm), jperf.prefill_bytes(jcfg, js, jm)),
                         (tperf.train_bytes(tcfg, ts, tm),
                          jperf.train_bytes(jcfg, js, jm, microbatches=8))]
                for layout in LAYOUTS:
                    for sel in (True, False):
                        pairs.append((
                            tperf.decode_bytes(tcfg, ts, tm, layout=layout, do_select=sel),
                            jperf.decode_bytes(jcfg, js, jm, layout=layout, do_select=sel)))
                    pairs.append((tperf.cell_bytes(tcfg, ts, tm, layout=layout),
                                  jperf.cell_bytes(jcfg, js, jm, layout=layout)))
                for got, want in pairs:
                    assert got == want, (name, h2, sname)
                    n += 1
    assert n == len(jconfigs.ASSIGNED) * 2 * len(jconfigs.SHAPES) * (2 + 3 * len(LAYOUTS))


@pytest.mark.parametrize("name", ["internvl2-1b", "musicgen-large", "smollm-360m"])
def test_meta_params_match_the_reference_specs(name):
    """The meta parameters' numel equals the reference's ``param_specs``
    (``jax.eval_shape`` of its init), and ``param_count()``, the
    reference's approximate N, less the embedding a frontend stub lacks,
    plus the final norm it leaves out; every leaf is on the meta device in
    the asked dtype, and the bytes are numel x itemsize."""
    cfg = tconfigs.get_arch(name)
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jspecs.param_specs(jconfigs.get_arch(name))))
    params = specs.param_specs(cfg, dtype=torch.bfloat16)
    ts = leaves(params)
    assert all(t.is_meta and t.dtype == torch.bfloat16 for t in ts)
    numel = sum(t.numel() for t in ts)
    assert numel == want
    assert numel == (cfg.param_count() - cfg.embed_frontend_stub * cfg.vocab_size
                     * cfg.d_model + cfg.d_model)
    assert specs.tree_bytes(params) == 2 * numel
    mem = dryrun.memory_bytes(cfg, tconfigs.SHAPES["train_4k"])
    assert mem["params"] == mem["grads"] == 4 * numel and mem["optimizer"] == 8 * numel


def test_input_specs_follow_the_reference():
    """Token ids, or a frontend stub's embeddings of frontend_dim, for each
    kind; all on the meta device."""
    shape = tconfigs.SHAPES["train_4k"]
    for name in ("internvl2-1b", "smollm-360m"):
        cfg, jcfg = tconfigs.get_arch(name), jconfigs.get_arch(name)
        got = [specs.train_specs(cfg, shape)["tokens"], specs.train_specs(cfg, shape)["labels"],
               specs.prefill_specs(cfg, shape), specs.decode_token_specs(cfg, shape)]
        want = [jspecs.train_specs(jcfg, shape)["tokens"],
                jspecs.train_specs(jcfg, shape)["labels"],
                jspecs.prefill_specs(jcfg, shape), jspecs.decode_token_specs(jcfg, shape)]
        for g, w in zip(got, want):
            assert g.is_meta and tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("name,kw", [
    ("internvl2-1b", dict(num_heads=14, num_kv_heads=2)), ("musicgen-large", {}),
    ("gemma3-1b", dict(num_layers=8)), ("zamba2-2.7b", {}), ("xlstm-125m", {})])
def test_meta_serve_state_has_the_bytes_of_a_prefill(name, kw):
    """The meta serve state's bytes equal those of the caches a real
    prefill builds at the same batch and capacity (H²EAL pages and rings,
    window layers' full caches, recurrent states)."""
    cfg = tconfigs.reduced(tconfigs.get_arch(name), **kw)
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(2, 24, cfg.d_model, generator=gen) if cfg.embed_frontend_stub
         else torch.randint(0, cfg.vocab_size, (2, 24), generator=gen))
    cap = dryrun._round_capacity(cfg, 24 + 8)
    with torch.no_grad():
        _, state = TM.prefill(cfg, params, x, capacity=cap)
    meta = specs.serve_state_specs(cfg, 2, cap, dtype=torch.float32)
    assert specs.tree_bytes(meta["layers"]) == specs.tree_bytes(state["layers"]) > 0


def test_dryrun_cli_runs(tmp_path, capsys):
    """Every assigned arch x shape on one card: resident bytes, the fit,
    the byte model's total against its memory rate and the model FLOP
    against its bf16 peak, with the card named."""
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "all", "--shape", "all", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert f"on one {dryrun.CARD}" in text and "40 cells" in text
    import json
    cells = {(r["arch"], r["shape"]): r for r in json.loads(out.read_text())}
    r = cells[("internvl2-1b", "decode_32k")]
    cfg = tconfigs.get_arch("internvl2-1b")
    want = tperf.cell_bytes(cfg, tconfigs.SHAPES["decode_32k"], dryrun.ONE_CARD)["total"]
    assert r["bytes_breakdown"]["total"] == want
    assert r["roofline"]["memory_s"] == want / dryrun.HBM_BW
    assert r["capacity"] == 32832
    assert r["resident_fits"] == (r["memory"]["resident"] <= dryrun.HBM_BYTES)
    # the step's inputs: 128 bf16 embeddings of frontend_dim, a token id a row
    assert r["memory"]["inputs"] == 128 * cfg.frontend_dim * 2
    assert cells[("smollm-360m", "train_4k")]["memory"]["inputs"] == 2 * 256 * 4096 * 4
    assert not cells[("kimi-k2-1t-a32b", "train_4k")]["resident_fits"]
