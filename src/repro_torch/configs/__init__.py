"""Architecture configs (the port's own copy of ``repro.configs``): the ten
architectures the JAX package registers, under the same names.  The port
serves the dense ones (phi4-mini, gemma3-1b / 4b, deepseek-7b), the MoE
ones (mixtral-8x22b, llama4-scout-17b-a16e), the VLM paligemma-3b, the
ssm mamba2-1.3b, the hybrid jamba-1.5-large-398b and the enc_dec
whisper-medium (these three through ``make_serve_step`` only; the
transformer-only entry points refuse them, :func:`base.require_transformer`)."""

from repro_torch.configs import shapes  # noqa: F401
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
    require_served,
    require_transformer,
)

# imported for their registrations
from repro_torch.configs import (  # noqa: F401
    deepseek_7b,
    gemma3_1b,
    gemma3_4b,
    jamba_1_5_large_398b,
    llama4_scout_17b_a16e,
    mamba2_1_3b,
    mixtral_8x22b,
    paligemma_3b,
    phi4_mini_3_8b,
    whisper_medium,
)
