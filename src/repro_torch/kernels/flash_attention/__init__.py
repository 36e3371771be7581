"""Tiled online-softmax GQA attention over the model layout (B, S, H, D)."""

from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention"]
