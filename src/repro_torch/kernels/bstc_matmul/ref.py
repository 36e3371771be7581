"""Plain PyTorch version of the fused BSTC decode + matmul.

Counterpart of :func:`repro.kernels.bstc_matmul.ref.bstc_matmul_ref`.
:func:`bstc_matmul_plain` is what :func:`~repro_torch.kernels.bstc_matmul.
ops.bstc_matmul` runs on CPU tensors and the on-card oracle of the CUDA
kernel: it rebuilds the dense integer weight with the plain decode (never
the decode kernel) and takes one float32 product.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bitslice
from repro_torch.core.bstc import expand_patterns
from repro_torch.kernels.bstc_decode.ops import EncodedPlaneOperands
from repro_torch.kernels.bstc_decode.ref import decode_patterns_ref


def bstc_matmul_ref(w_q: torch.Tensor, x: torch.Tensor,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense f32 product of the losslessly reconstructed weight, scaled per
    output row after the sum: ``(w_q @ x) * scale[:, None]``."""
    y = w_q.float() @ x.float()
    if scale is not None:
        y = y * scale[:, None]
    return y


def _decode_plain(plane: EncodedPlaneOperands) -> torch.Tensor:
    return decode_patterns_ref(bitslice.unpack_bits(plane.bitmap), plane.patterns)


def reconstruct_dense_ref(ops, decode=_decode_plain) -> torch.Tensor:
    """The int32 (M, H) weight of ``BSTCMatmulOperands``: each coded plane
    through ``decode`` (an ``EncodedPlaneOperands`` -> (G, H) patterns; the
    plain decode by default), raw planes unpacked, ``<< p`` each, then the
    sign."""
    mag = torch.zeros((ops.M, ops.H), dtype=torch.int32, device=ops.sign_bits.device)
    for i, p in enumerate(ops.enc_planes):
        patt = decode(EncodedPlaneOperands(*ops.enc[3 * i:3 * i + 3], H=ops.H, m=ops.m))
        mag += expand_patterns(patt, ops.m).to(torch.int32) << p
    for i, p in enumerate(ops.raw_planes):
        mag += bitslice.unpack_bits(ops.raw[i]).to(torch.int32) << p
    sign = bitslice.unpack_bits(ops.sign_bits).to(torch.int32)
    return (1 - 2 * sign) * mag


def bstc_matmul_plain(ops, x: torch.Tensor, apply_scale: bool = False) -> torch.Tensor:
    """``w_q @ x`` (times the per-row scale with ``apply_scale``) -> f32 (M, N)."""
    return bstc_matmul_ref(reconstruct_dense_ref(ops), x,
                           ops.scale if apply_scale else None)
