"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216
— SigLIP + gemma backbone.  The SigLIP frontend is a STUB per the brief:
input_specs() supplies 256 precomputed patch embeddings (d_vision=1152).
[arXiv:2407.07726; hf]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    """The published geometry (bf16)."""
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257_216,
        rope_theta=10_000.0,
        activation="geglu",
        embed_scale=True,
        norm="rms",
        tie_embeddings=True,
        vision_tokens=256,
        d_vision=1152,
    )


def smoke() -> ModelConfig:
    """Reduced f32 variant for the CPU tests (same as the JAX package's)."""
    return ModelConfig(
        name="paligemma-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        rope_theta=10_000.0,
        activation="geglu",
        embed_scale=True,
        norm="rms",
        tie_embeddings=True,
        vision_tokens=16,
        d_vision=32,
        dtype="float32",
    )


register("paligemma-3b", full, smoke)
