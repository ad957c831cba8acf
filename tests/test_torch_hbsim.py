"""PyTorch port, the paper's cycle model and the serving byte model
(``repro_torch.hbsim``, ``repro_torch.runtime.perfmodel``) against the JAX
package's on the same inputs: the models, sequence lengths and modes of
benchmarks/fig9_attention.py and benchmarks/table3_e2e.py, and the tier
and migration counters the engine reports.

Pure Python with the same arithmetic in the same order: the results are
EQUAL, floats included. They are the hybrid-bonding model's projections,
not measurements of any device.
"""
import dataclasses

import pytest

from repro import hbsim as JH
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.runtime import perfmodel as JP
from repro_torch import hbsim as TH
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import reduced as treduced
from repro_torch.runtime import perfmodel as TP
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

PAPER_MODELS = ("llama2-7b", "llama3-8b", "mistral-7b")
# the MoE family: the GEMM term reads the active parameters (top-k experts)
MOE_MODELS = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b")
# the recurrent mixers: 9 attention layers of 54 (zamba2), none (xlstm)
RECURRENT_MODELS = ("zamba2-2.7b", "xlstm-125m")
FIG9_SEQS = (16384, 65536, 262144)
TABLE3_SEQS = (65536, 262144)


def _cfgs(name, **h2):
    t, j = tget_arch(name), jget_arch(name)
    if h2:
        t = dataclasses.replace(t, h2eal=dataclasses.replace(t.h2eal, **h2))
        j = dataclasses.replace(j, h2eal=dataclasses.replace(j.h2eal, **h2))
    return t, j


def test_hb_config_equal():
    t, j = TH.HBConfig(), JH.HBConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.chip_mem_bw == j.chip_mem_bw
    assert TH.MODES == JH.MODES


@pytest.mark.parametrize("share_window", [1, 4])
@pytest.mark.parametrize("name", PAPER_MODELS + MOE_MODELS + RECURRENT_MODELS)
def test_attention_decode_equal(name, share_window):
    """Fig 9's grid: every mode at every decode length, per-step selection
    (share_window 1) as the figure runs it, and 4 as Table III does."""
    t, j = _cfgs(name)
    th2 = dataclasses.replace(t.h2eal, share_window=share_window)
    jh2 = dataclasses.replace(j.h2eal, share_window=share_window)
    for seq in FIG9_SEQS:
        for mode in TH.MODES:
            assert TH.attention_decode(t, seq, mode, h2=th2) == \
                JH.attention_decode(j, seq, mode, h2=jh2)


@pytest.mark.parametrize("name", PAPER_MODELS + MOE_MODELS + RECURRENT_MODELS)
def test_e2e_and_gemm_decode_equal(name):
    """Table III's end-to-end decode, and the GEMM term alone."""
    t, j = _cfgs(name, share_window=4)
    assert TH.gemm_decode(t) == JH.gemm_decode(j)
    for seq in TABLE3_SEQS:
        for mode in ("full", "h2eal"):
            assert TH.e2e_decode(t, seq, mode) == JH.e2e_decode(j, seq, mode)
    # the config's own h2eal and a custom HB chip
    hb_t = TH.HBConfig(banks=8, grid=(2, 4))
    hb_j = JH.HBConfig(banks=8, grid=(2, 4))
    assert TH.e2e_decode(t, 65536, "h2eal", hb_t) == JH.e2e_decode(j, 65536, "h2eal", hb_j)


def test_far_bank_transfer_equal():
    for nbytes in (0, 1, 2 << 20, 1e12):
        for hops in (None, 1, 3.5):
            assert TH.far_bank_transfer(nbytes, hops=hops) == \
                JH.far_bank_transfer(nbytes, hops=hops)


@pytest.mark.parametrize("name", PAPER_MODELS + ("smollm-360m",) + MOE_MODELS
                         + RECURRENT_MODELS)
def test_byte_model_and_overheads_equal(name):
    """The serving byte model and the two overheads hbsim prices from the
    engine's counters."""
    t, j = tget_arch(name), jget_arch(name)
    if name == "smollm-360m":
        t, j = treduced(t), jreduced(j)
    assert TP.BF16 == JP.BF16 and TP.F32 == JP.F32
    assert TP.tier_page_bytes(t) == JP.tier_page_bytes(j)
    counters = [(0, 0, 0), (3, 10, 7), (250, 900, 31)]
    for fills, spills, prefetch in counters:
        kw = dict(fills=fills, spills=spills, prefetch=prefetch)
        assert TP.tier_traffic_bytes(t, **kw) == JP.tier_traffic_bytes(j, **kw)
        for steps in (0, 1, 66):
            assert TH.tiered_serving_overhead(t, decode_steps=steps, **kw) == \
                JH.tiered_serving_overhead(j, decode_steps=steps, **kw)
    for ctx in (0, 1, 33, 260, 8256):
        assert TP.migration_slot_bytes(t, ctx=ctx) == JP.migration_slot_bytes(j, ctx=ctx)
    for migrations, tokens in ((0, 0), (1, 100), (3, 1000), (7, 22222)):
        kw = dict(migrations=migrations, migrated_tokens=tokens)
        assert TP.migration_traffic_bytes(t, **kw) == JP.migration_traffic_bytes(j, **kw)
        assert TH.rebalance_overhead(t, decode_steps=50, **kw) == \
            JH.rebalance_overhead(j, decode_steps=50, **kw)


def test_llama3_8b_tier_page_is_2_mib():
    """2 (K, V) x 32 tokens x 128 x 2 B x 4 retrieval heads x 32 layers."""
    assert TP.tier_page_bytes(tget_arch("llama3-8b")) == 2 * 1024 * 1024
