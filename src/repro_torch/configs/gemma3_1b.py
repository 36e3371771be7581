"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding attention, 128k (32k for the 1b) context.
[hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    """The published geometry (bf16)."""
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        num_layers=26,
        d_model=1152,
        num_heads=4,
        num_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab_size=262_144,
        sliding_window=512,
        global_every=6,
        rope_theta=1_000_000.0,
        rope_theta_local=10_000.0,
        activation="geglu",
        qk_norm=True,
        embed_scale=True,
        post_norms=True,
        norm="rms",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    """Reduced f32 variant for the CPU tests (same as the JAX package's)."""
    return ModelConfig(
        name="gemma3-1b-smoke",
        family="dense",
        num_layers=6,
        d_model=48,
        num_heads=2,
        num_kv_heads=1,
        head_dim=24,
        d_ff=96,
        vocab_size=512,
        sliding_window=16,
        global_every=6,
        rope_theta=1_000_000.0,
        rope_theta_local=10_000.0,
        activation="geglu",
        qk_norm=True,
        embed_scale=True,
        post_norms=True,
        norm="rms",
        tie_embeddings=True,
        dtype="float32",
    )


register("gemma3-1b", full, smoke)
