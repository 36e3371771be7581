"""Plain PyTorch version of the flash-attention kernel: the materialised
softmax attention.

Counterpart of :mod:`repro.kernels.flash_attention.ref`: the mask of
``mask_kind`` built whole, then :func:`repro_torch.core.attention.attend`
(f32 logits and softmax, output in ``q.dtype``).  The CPU path of
``flash_attention`` and the oracle the CUDA kernel is held against on the
card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import attention


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hk, D)
    v: torch.Tensor,  # (B, Sk, Hk, D)
    mask_kind: str = "causal",
    window: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked GQA attention -> ``(B, Sq, Hq, D)`` in ``q.dtype``."""
    mask = attention.make_mask(mask_kind, q.shape[1], k.shape[1], window, q_offset,
                               q.device)
    return attention.attend(q, k, v, mask=mask, scale=scale)
