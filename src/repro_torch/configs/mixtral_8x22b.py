"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768
MoE 8 experts top-2, SWA (window 4096).  [arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    """The published geometry (bf16)."""
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32_768,
        num_experts=8,
        experts_per_token=2,
        sliding_window=4096,
        rope_theta=1_000_000.0,
        activation="swiglu",
        norm="rms",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    """Reduced f32 variant for the CPU tests (same as the JAX package's)."""
    return ModelConfig(
        name="mixtral-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        num_experts=4,
        moe_capacity_factor=8.0,
        experts_per_token=2,
        sliding_window=16,
        rope_theta=1_000_000.0,
        activation="swiglu",
        norm="rms",
        tie_embeddings=False,
        dtype="float32",
    )


register("mixtral-8x22b", full, smoke)
