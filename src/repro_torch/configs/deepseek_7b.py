"""deepseek-7b [dense]: 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400 — llama-arch. [arXiv:2401.02954; hf]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    """The published geometry (bf16)."""
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=102_400,
        rope_theta=10_000.0,
        activation="swiglu",
        norm="rms",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    """Reduced f32 variant for the CPU tests (same as the JAX package's)."""
    return ModelConfig(
        name="deepseek-7b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        rope_theta=10_000.0,
        activation="swiglu",
        norm="rms",
        tie_embeddings=False,
        dtype="float32",
    )


register("deepseek-7b", full, smoke)
