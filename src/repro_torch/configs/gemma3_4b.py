"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global sliding attention, 128k context.
[hf:google/gemma-3-4b-pt; unverified]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    """The published geometry (bf16)."""
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262_144,
        sliding_window=1024,
        global_every=6,  # 5 local : 1 global
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
        name="gemma3-4b-smoke",
        family="dense",
        num_layers=6,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
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


register("gemma3-4b", full, smoke)
