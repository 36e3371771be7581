"""Plain PyTorch versions of one BGPP scoring round.

Counterpart of :func:`repro.kernels.bgpp_score.ref.bgpp_score_round_ref`.
:func:`bgpp_score_heads_ref` is what
:func:`~repro_torch.kernels.bgpp_score.ops.bgpp_score_heads` runs on CPU
tensors and the on-card oracle of the CUDA kernel.  Integer arithmetic
throughout (broadcast products summed in int32), so it runs unchanged on
either device and is exact.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitslice


def bgpp_score_round_ref(
    q: torch.Tensor,  # (D,) int32
    plane_bits: torch.Tensor,  # (S, D) {0,1} uint8 — magnitude plane p
    sign_bits: torch.Tensor,  # (S, D) {0,1} uint8
    alive: torch.Tensor,  # (S,) bool
) -> torch.Tensor:
    """(S,) int32 = (plane ⊙ sign) · q for alive keys, 0 otherwise."""
    signed = (1 - 2 * sign_bits.to(torch.int32)) * plane_bits.to(torch.int32)
    contrib = (signed * q.to(torch.int32)).sum(-1, dtype=torch.int32)
    return torch.where(alive, contrib, torch.zeros_like(contrib))


def bgpp_score_heads_ref(
    q: torch.Tensor,  # (B, Hq, D) int32
    plane_packed: torch.Tensor,  # (B, S, Hk, D//8) uint8
    sign_packed: torch.Tensor,  # (B, S, Hk, D//8) uint8
    alive: torch.Tensor,  # (B, Hq, S) bool
) -> torch.Tensor:
    """(B, Hq, S) int32: query head ``h`` scored against kv head
    ``h // (Hq // Hk)``'s packed plane, 0 for keys that are not alive."""
    B, Hq, D = q.shape
    Hk = plane_packed.shape[2]
    planes = bitslice.unpack_bits(plane_packed).to(torch.int32)
    signs = bitslice.unpack_bits(sign_packed).to(torch.int32)
    signed = ((1 - 2 * signs) * planes).permute(0, 2, 1, 3)  # (B, Hk, S, D)
    qg = q.to(torch.int32).reshape(B, Hk, Hq // Hk, 1, D)
    contrib = (signed[:, :, None] * qg).sum(-1, dtype=torch.int32).reshape(B, Hq, -1)
    return torch.where(alive, contrib, torch.zeros_like(contrib))
