"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    """The published phi4-mini-3.8b geometry (bf16)."""
    return ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200_064,
        rope_theta=10_000.0,
        activation="swiglu",
        norm="rms",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    """Reduced f32 variant for the CPU tests (same as the JAX package's)."""
    return ModelConfig(
        name="phi4-mini-smoke",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        rope_theta=10_000.0,
        activation="swiglu",
        norm="rms",
        tie_embeddings=True,
        dtype="float32",
    )


register("phi4-mini-3.8b", full, smoke)
