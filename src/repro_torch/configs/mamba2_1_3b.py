"""mamba2-1.3b [ssm]: 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  BGPP is inapplicable (no KV
cache); BRCR/BSTC apply to all projections.
[arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    """The published geometry (bf16)."""
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        ssm_state=128,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        norm="rms",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    """Reduced f32 variant for the CPU tests (same as the JAX package's)."""
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        num_layers=3,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=512,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=32,
        norm="rms",
        tie_embeddings=True,
        dtype="float32",
    )


register("mamba2-1.3b", full, smoke)
