"""The paper's hybrid-bonding cycle and energy model (counterpart of
``repro/hbsim/``); its outputs are the model's, not a device's."""
from repro_torch.hbsim.sim import (  # noqa: F401
    HBConfig,
    MODES,
    attention_decode,
    e2e_decode,
    far_bank_transfer,
    gemm_decode,
    rebalance_overhead,
    tiered_serving_overhead,
)
