"""Config registry of the port: importing it registers every ported arch."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    H2ealConfig,
    MoEConfig,
    REGISTRY,
    SHAPES,
    SSMConfig,
    ShapeConfig,
    get_arch,
    reduced,
    register,
)
# the assigned architectures
from repro_torch.configs import internvl2_1b  # noqa: F401
from repro_torch.configs import zamba2_2p7b  # noqa: F401
from repro_torch.configs import gemma3_1b  # noqa: F401
from repro_torch.configs import internlm2_20b  # noqa: F401
from repro_torch.configs import qwen2_72b  # noqa: F401
from repro_torch.configs import smollm_360m  # noqa: F401
from repro_torch.configs import xlstm_125m  # noqa: F401
from repro_torch.configs import musicgen_large  # noqa: F401
from repro_torch.configs import qwen3_moe_235b  # noqa: F401
from repro_torch.configs import kimi_k2_1t  # noqa: F401
# the paper's own evaluation models
from repro_torch.configs import paper_models  # noqa: F401

ASSIGNED = (
    "internvl2-1b",
    "zamba2-2.7b",
    "gemma3-1b",
    "internlm2-20b",
    "qwen2-72b",
    "smollm-360m",
    "xlstm-125m",
    "musicgen-large",
    "qwen3-moe-235b-a22b",
    "kimi-k2-1t-a32b",
)
