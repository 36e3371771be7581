"""Architecture configs the port serves (its own copy of ``repro.configs``)."""

from repro_torch.configs import phi4_mini_3_8b  # noqa: F401  (registers)
from repro_torch.configs.base import (  # noqa: F401
    ARCH_REGISTRY,
    SMOKE_REGISTRY,
    WEIGHT_FORMATS,
    MCBPOptions,
    ModelConfig,
    apply_bgpp_overrides,
    apply_spec_decode_overrides,
    apply_weight_format_override,
    get_config,
    register,
)
