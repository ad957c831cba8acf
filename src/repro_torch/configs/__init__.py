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
from repro_torch.configs import paper_models  # noqa: F401
from repro_torch.configs import smollm_360m  # noqa: F401
