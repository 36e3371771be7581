"""Bit-slice (BS) decomposition utilities — the substrate of MCBP.

Counterpart of :mod:`repro.core.bitslice`.  Terminology follows the paper: an INT-quantized k-bit tensor
decomposes into k 1-bit *bit-slice* (plane) tensors in **sign-magnitude**
format.  Plane ``p`` holds bit ``p`` of the magnitude (plane 0 is the LSB);
the sign is carried separately.
"""

from __future__ import annotations

import dataclasses
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


def signed_plane_split(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split an integer tensor into disjoint non-negative int32 parts,
    ``w = pos - neg``: BRCR and BSTC treat the two {0,1}-plane tensors
    independently and subtract the results (the sign-decision unit)."""
    w = w.to(torch.int32)
    return w.clamp(min=0), (-w).clamp(min=0)


def _mean_f32(bits: torch.Tensor, dim=None) -> torch.Tensor:
    """float32 mean of a {0,1} tensor as the compiled reference takes it:
    the count times the float32 reciprocal of n (XLA turns a division by a
    constant into that product, which can differ from the quotient by an
    ulp).  The count is exact, as the reference's float32 sum of 0/1
    values is while it stays below 2**24."""
    ones = bits.to(torch.int64)
    ones = ones.sum() if dim is None else ones.sum(dim)
    n = bits.numel() if dim is None else bits.shape[dim]
    return ones.to(torch.float32) * _inv_f32(n, bits.device)


def _inv_f32(n: int, device) -> torch.Tensor:
    return torch.tensor(1.0 / n, dtype=torch.float32, device=device)


def bit_sparsity(planes: torch.Tensor) -> torch.Tensor:
    """Fraction of zero bits per plane, float32 ``(nbits,)``."""
    return 1.0 - _mean_f32(planes.reshape(planes.shape[0], -1), dim=1)


def value_sparsity(w: torch.Tensor) -> torch.Tensor:
    """Fraction of zero values, a float32 scalar."""
    return _mean_f32(w == 0)


def average_bit_sparsity(w_q: torch.Tensor, nbits: int = WEIGHT_MAG_BITS) -> torch.Tensor:
    """The paper's bs~: the mean bit sparsity over the magnitude planes
    (sign-magnitude format), float32."""
    _, mag = to_sign_magnitude(w_q)
    sp = bit_sparsity(bitplanes(mag, nbits))
    total = sp[0]
    for v in sp[1:]:  # in plane order, as the reference's reduction adds them
        total = total + v
    return total * _inv_f32(nbits, sp.device)


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


@dataclasses.dataclass(frozen=True)
class BitPlanarTensor:
    """A k-bit integer tensor stored as packed sign + magnitude bit planes.

    The storage format BGPP reads: its rounds fetch one magnitude plane at
    a time, MSB first.  ``mag_planes`` is ``(nbits, *shape[:-1],
    shape[-1]//8)`` uint8, ``sign`` the packed ``(*shape[:-1],
    shape[-1]//8)`` sign plane."""

    mag_planes: torch.Tensor
    sign: torch.Tensor
    nbits: int

    @property
    def plane_nbytes(self) -> int:
        return self.mag_planes[0].numel()

    @classmethod
    def from_int(cls, w: torch.Tensor, nbits: int = WEIGHT_MAG_BITS) -> "BitPlanarTensor":
        sign, mag = to_sign_magnitude(w)
        return cls(mag_planes=pack_bits(bitplanes(mag, nbits)), sign=pack_bits(sign),
                   nbits=nbits)

    def plane(self, p: int) -> torch.Tensor:
        """Unpacked {0,1} plane ``p`` (LSB = 0)."""
        return unpack_bits(self.mag_planes[p])

    def to_int(self) -> torch.Tensor:
        mag = from_bitplanes(unpack_bits(self.mag_planes))
        return from_sign_magnitude(unpack_bits(self.sign), mag)


def group_indices(planes: torch.Tensor, m: int) -> torch.Tensor:
    """Read m-row bit-plane groups as integer column patterns.

    planes ``(..., M, H)`` {0,1} with ``M % m == 0`` -> ``(..., M//m, H)``
    int32 in ``[0, 2**m)``: row ``j`` of a group contributes bit ``j``."""
    *lead, M, H = planes.shape
    if M % m:
        raise ValueError(f"rows {M} not divisible by group size {m}")
    g = planes.reshape(*lead, M // m, m, H).to(torch.int32)
    w = (2 ** torch.arange(m, dtype=torch.int32, device=planes.device)).reshape(m, 1)
    return (g * w).sum(-2, dtype=torch.int32)


def enumeration_matrix(m: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The paper's E: ``(m, 2**m)`` with ``E[j, c]`` = bit ``j`` of ``c``."""
    c = torch.arange(2 ** m, device=device)
    j = torch.arange(m, device=device)
    return ((c[None, :] >> j[:, None]) & 1).to(dtype)
