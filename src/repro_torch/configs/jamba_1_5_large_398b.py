"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave (attention at
layer i where i % 8 == 4), MoE every other layer.  [arXiv:2403.19887; hf]

The port serves and trains it through ``models/hybrid.py``.  The whole model
(398 B parameters) does not fit one card unsharded, nor does one super-block
at 16 experts (45.1 B, 84.1 GiB in bf16); one card holds one super-block with
8 of the 16 experts.  The mamba mixer uses an SSD (mamba2) block — recorded
as an adaptation since Jamba ships Mamba-1 internals."""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    """The published geometry (bf16)."""
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65_536,
        num_experts=16,
        experts_per_token=2,
        moe_every=2,
        moe_offset=1,
        attn_every=8,
        attn_offset=4,
        ssm_state=128,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=128,
        rope_theta=10_000.0,
        activation="swiglu",
        norm="rms",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    """Reduced f32 variant for the CPU tests (same as the JAX package's)."""
    return ModelConfig(
        name="jamba-smoke",
        family="hybrid",
        num_layers=8,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        num_experts=4,
        moe_capacity_factor=8.0,
        experts_per_token=2,
        moe_every=2,
        moe_offset=1,
        attn_every=8,
        attn_offset=4,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=32,
        rope_theta=10_000.0,
        activation="swiglu",
        norm="rms",
        tie_embeddings=False,
        dtype="float32",
    )


register("jamba-1.5-large-398b", full, smoke)
