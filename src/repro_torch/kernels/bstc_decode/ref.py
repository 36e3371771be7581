"""Plain PyTorch version of the BSTC plane decode (patterns, not rows).

Counterpart of :func:`repro.kernels.bstc_decode.ref.decode_patterns_ref`:
the CPU path of :func:`~repro_torch.kernels.bstc_decode.ops.
bstc_decode_patterns` and the on-card oracle of the CUDA kernel.
"""

from __future__ import annotations

import torch


def decode_patterns_ref(bitmap_bits: torch.Tensor, patterns: torch.Tensor) -> torch.Tensor:
    """Prefix-sum addressed gather: bitmap_bits (G, H) uint8 {0,1},
    patterns (G, cap) uint8 -> (G, H) uint8 column patterns."""
    pos = torch.cumsum(bitmap_bits.to(torch.int32), 1, dtype=torch.int64) - 1
    pos = pos.clamp(0, patterns.shape[1] - 1)
    vals = torch.gather(patterns, 1, pos)
    return torch.where(bitmap_bits != 0, vals, torch.zeros_like(vals)).to(torch.uint8)
