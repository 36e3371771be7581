"""Tiled online-softmax GQA attention over the model layout (B, S, H, D),
and its gradient."""

from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd

__all__ = ["flash_attention", "flash_attention_bwd"]
