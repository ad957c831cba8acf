"""Config registry of the port: importing it registers every ported arch."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    H2ealConfig,
    MoEConfig,
    REGISTRY,
    SSMConfig,
    get_arch,
    reduced,
    register,
)
# the assigned architectures whose families the port serves (the frontend
# stubs wait: ROADMAP Queue 1 item 11)
from repro_torch.configs import gemma3_1b  # noqa: F401
from repro_torch.configs import internlm2_20b  # noqa: F401
from repro_torch.configs import qwen2_72b  # noqa: F401
from repro_torch.configs import smollm_360m  # noqa: F401
from repro_torch.configs import qwen3_moe_235b  # noqa: F401
from repro_torch.configs import kimi_k2_1t  # noqa: F401
from repro_torch.configs import zamba2_2p7b  # noqa: F401
from repro_torch.configs import xlstm_125m  # noqa: F401
# the paper's own evaluation models
from repro_torch.configs import paper_models  # noqa: F401
