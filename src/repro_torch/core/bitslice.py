"""Bit-slice (BS) decomposition utilities — the substrate of MCBP.

Counterpart of :mod:`repro.core.bitslice`, for the pieces the serving
slice uses.  Terminology follows the paper: an INT-quantized k-bit tensor
decomposes into k 1-bit *bit-slice* (plane) tensors in **sign-magnitude**
format.  Plane ``p`` holds bit ``p`` of the magnitude (plane 0 is the LSB);
the sign is carried separately.
"""

from __future__ import annotations

from typing import Tuple

import torch

# INT8 symmetric quantization range (clipped to [-127, 127] so magnitudes
# fit 7 bits)
WEIGHT_MAG_BITS = 7
INT8_MAX = 127


def to_sign_magnitude(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8/int32 tensor -> (sign, magnitude) uint8; sign is 1 where w < 0."""
    w = w.to(torch.int32)
    return (w < 0).to(torch.uint8), w.abs().to(torch.uint8)


def from_sign_magnitude(sign: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_sign_magnitude` -> int32."""
    mag = mag.to(torch.int32)
    return torch.where(sign.bool(), -mag, mag)


def bitplanes(mag: torch.Tensor, nbits: int = WEIGHT_MAG_BITS) -> torch.Tensor:
    """Magnitude tensor -> stacked {0,1} uint8 planes ``(nbits, *mag.shape)``;
    ``plane[p]`` is bit ``p`` of ``mag``."""
    mag = mag.to(torch.uint8)
    shifts = torch.arange(nbits, dtype=torch.uint8, device=mag.device)
    shifts = shifts.reshape((nbits,) + (1,) * mag.ndim)
    return (mag[None] >> shifts) & 1


def from_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bitplanes`: ``(nbits, ...)`` planes -> int32 magnitude."""
    nbits = planes.shape[0]
    w = 2 ** torch.arange(nbits, dtype=torch.int32, device=planes.device)
    w = w.reshape((nbits,) + (1,) * (planes.ndim - 1))
    return (planes.to(torch.int32) * w).sum(0, dtype=torch.int32)


def pack_bits(bits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a {0,1} uint8 tensor 8:1 into uint8 along ``axis`` (length a
    multiple of 8).  Bit ``i`` of an output byte is element ``8*j + i`` of
    the input (little-endian within the byte)."""
    axis = axis % bits.ndim
    n = bits.shape[axis]
    if n % 8:
        raise ValueError(f"pack_bits axis length {n} not a multiple of 8")
    moved = bits.movedim(axis, -1).to(torch.uint8)
    grouped = moved.reshape(moved.shape[:-1] + (n // 8, 8))
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    packed = (grouped << shifts).sum(-1, dtype=torch.int32).to(torch.uint8)
    return packed.movedim(-1, axis)


def unpack_bits(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_bits` (uint8 -> 8x {0,1} uint8 along ``axis``)."""
    axis = axis % packed.ndim
    moved = packed.movedim(axis, -1)
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (moved[..., None] >> shifts) & 1
    bits = bits.reshape(moved.shape[:-1] + (moved.shape[-1] * 8,))
    return bits.movedim(-1, axis)
