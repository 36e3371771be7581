"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert, chunked local attention
(8192) 3:1 local:global (iRoPE), early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    """The published geometry (bf16)."""
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        num_experts=16,
        experts_per_token=1,
        moe_shared_ff=8192,
        chunk_attention=8192,
        global_every=4,  # 3 chunked-local : 1 global
        rope_theta=500_000.0,
        activation="swiglu",
        norm="rms",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    """Reduced f32 variant for the CPU tests (same as the JAX package's)."""
    return ModelConfig(
        name="llama4-scout-smoke",
        family="moe",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        num_experts=4,
        moe_capacity_factor=8.0,
        experts_per_token=1,
        moe_shared_ff=128,
        chunk_attention=16,
        global_every=4,
        rope_theta=500_000.0,
        activation="swiglu",
        norm="rms",
        tie_embeddings=False,
        dtype="float32",
    )


register("llama4-scout-17b-a16e", full, smoke)
