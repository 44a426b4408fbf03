"""Importing this package populates the architecture registry: every
configuration of the JAX package (`get_arch` names them when asked for
an unknown one)."""
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      WirelessConfig, get_arch, list_archs)
from repro_torch.configs import chatglm3_6b  # noqa: F401
from repro_torch.configs import command_r_plus_104b  # noqa: F401
from repro_torch.configs import internvl2_76b  # noqa: F401
from repro_torch.configs import llama4_scout_17b_a16e  # noqa: F401
from repro_torch.configs import paper_tinylstm  # noqa: F401
from repro_torch.configs import qwen1_5_0_5b  # noqa: F401
from repro_torch.configs import qwen3_moe_235b_a22b  # noqa: F401
from repro_torch.configs import seamless_m4t_medium  # noqa: F401
from repro_torch.configs import stablelm_12b  # noqa: F401
from repro_torch.configs import xlstm_350m  # noqa: F401
from repro_torch.configs import zamba2_1_2b  # noqa: F401

# the architectures the JAX package's dry run covers by default
ASSIGNED = [
    "stablelm-12b", "command-r-plus-104b", "internvl2-76b", "zamba2-1.2b",
    "xlstm-350m", "qwen1.5-0.5b", "seamless-m4t-medium", "chatglm3-6b",
    "llama4-scout-17b-a16e", "qwen3-moe-235b-a22b",
]
