"""whisper-medium [audio]: 24L(enc)+24L(dec) d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865 — enc-dec; conv frontend is a STUB (input_specs()
supplies 1500 precomputed post-conv frame embeddings).  Decoder positions are
sinusoidal-extended beyond the checkpoint's 448 so decode_32k lowers
mechanically.  [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    """The published geometry (bf16)."""
    return ModelConfig(
        name="whisper-medium",
        family="enc_dec",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51_865,
        encoder_layers=24,
        encoder_seq=1500,
        d_audio=1024,
        activation="gelu",
        norm="ln",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    """Reduced f32 variant for the CPU tests (same as the JAX package's)."""
    return ModelConfig(
        name="whisper-smoke",
        family="enc_dec",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        encoder_layers=2,
        encoder_seq=32,
        d_audio=64,
        activation="gelu",
        norm="ln",
        tie_embeddings=True,
        dtype="float32",
    )


register("whisper-medium", full, smoke)
