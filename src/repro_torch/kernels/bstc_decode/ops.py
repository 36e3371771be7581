"""Operand prep and public wrapper for the BSTC plane decode.

Counterpart of :mod:`repro.kernels.bstc_decode.ops`.  Routing is by the
tensors' device: CPU tensors take the plain version in :mod:`.ref`; CUDA
tensors launch the CUDA kernel or the call raises — there is no fallback.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import bitslice
from repro_torch.core.bstc import EncodedPlane
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.bstc_decode import kernel
from repro_torch.kernels.bstc_decode.ref import decode_patterns_ref
from repro_torch.kernels.paged_flash_decode.kernel import sm_count


class EncodedPlaneOperands(NamedTuple):
    """Device-ready coded plane: packed bitmap, padded patterns and the
    per-H-tile stream offsets (the segmented layout's start addresses)."""

    bitmap: torch.Tensor  # (G, H//8) uint8
    tile_offsets: torch.Tensor  # (G, H//tile_k) int32
    patterns: torch.Tensor  # (G, cap) uint8, cap a multiple of 8
    H: int
    m: int

    @property
    def compressed_bytes(self) -> int:
        return int(self.bitmap.numel() + math.ceil(self.patterns.numel() * self.m / 8))


def plane_operands(enc: EncodedPlane, tile_k: int) -> Tuple[torch.Tensor, ...]:
    """(packed bitmap, tile offsets, patterns padded to a multiple of 8) of
    one coded plane — the prep :func:`prepare_encoded_plane` and the
    ``bstc_matmul`` operand prep share.  A tile's offset is the exclusive
    count of set bits before it in its row."""
    G, H = enc.bitmap.shape
    if H % tile_k:
        raise ValueError(f"H={H} is not a multiple of tile_k={tile_k}")
    per_tile = enc.bitmap.reshape(G, H // tile_k, tile_k).sum(-1, dtype=torch.int64)
    offsets = (per_tile.cumsum(1) - per_tile).to(torch.int32)
    cap = max(int(enc.nnz.max()), 1) if G else 1
    cap = -(-cap // 8) * 8  # pad for clean byte math
    patterns = torch.zeros((G, cap), dtype=torch.uint8, device=enc.bitmap.device)
    patterns[:, :enc.patterns.shape[1]] = enc.patterns
    return bitslice.pack_bits(enc.bitmap), offsets, patterns


def prepare_encoded_plane(enc: EncodedPlane, tile_k: int = 512) -> EncodedPlaneOperands:
    """EncodedPlane -> kernel operands with per-tile stream offsets."""
    bitmap, offsets, patterns = plane_operands(enc, tile_k)
    return EncodedPlaneOperands(bitmap=bitmap, tile_offsets=offsets, patterns=patterns,
                                H=enc.bitmap.shape[1], m=enc.m)


def _validate(ops: EncodedPlaneOperands) -> None:
    G = ops.bitmap.shape[0]
    if ops.H % 8 or tuple(ops.bitmap.shape) != (G, ops.H // 8):
        raise ValueError(f"bstc_decode: bitmap {tuple(ops.bitmap.shape)} is not "
                         f"(G, H/8) for H={ops.H}")
    if ops.tile_offsets.ndim != 2 or ops.tile_offsets.shape[0] != G or ops.patterns.ndim != 2 \
            or ops.patterns.shape[0] != G or ops.patterns.shape[1] < 1:
        raise ValueError(
            f"bstc_decode: tile_offsets {tuple(ops.tile_offsets.shape)} and patterns "
            f"{tuple(ops.patterns.shape)} must be (G={G}, tiles) and (G, cap >= 1)")
    n_tiles = ops.tile_offsets.shape[1]
    if n_tiles < 1 or ops.H % n_tiles or (ops.H // n_tiles) % 8:
        raise ValueError(f"bstc_decode: {n_tiles} tiles do not cut H={ops.H} into "
                         f"whole bytes")
    if len({t.device for t in (ops.bitmap, ops.tile_offsets, ops.patterns)}) != 1:
        raise ValueError("bstc_decode: operands lie on different devices")


def _validate_cuda(ops: EncodedPlaneOperands) -> kernel.Plan:
    """What the CUDA kernel additionally requires of its operands, and its
    launch plan (which refuses a stream too long for shared memory)."""
    for name, t, dt in (("bitmap", ops.bitmap, torch.uint8),
                        ("tile_offsets", ops.tile_offsets, torch.int32),
                        ("patterns", ops.patterns, torch.uint8)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"bstc_decode: {name} must be contiguous {dt}")
    G, cap = ops.patterns.shape
    return kernel.plan(G, ops.H, ops.H // ops.tile_offsets.shape[1], cap,
                       sm_count(ops.bitmap.device), kernel.alignment(ops.patterns))


def bstc_decode_patterns(ops: EncodedPlaneOperands) -> torch.Tensor:
    """Decode to (G, H) uint8 group patterns (BRCR's input format).

    The H tile is pinned by the prepared per-tile stream offsets."""
    _validate(ops)
    dev = ops.bitmap.device
    if dev.type == "cpu":
        return decode_patterns_ref(bitslice.unpack_bits(ops.bitmap), ops.patterns)
    if dev.type != "cuda":
        raise ValueError(f"bstc_decode: no kernel for device {dev}")
    geo = _validate_cuda(ops)
    G = ops.bitmap.shape[0]
    out = torch.empty((G, ops.H), dtype=torch.uint8, device=dev)
    if G:
        kernel.launch(ops.bitmap, ops.tile_offsets, ops.patterns, out, ops.H, geo)
        LAUNCHES["bstc_decode"] += 1
    return out
