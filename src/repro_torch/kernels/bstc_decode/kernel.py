"""Launch the CUDA BSTC plane decode (``src/repro_torch/csrc/bstc_decode.cu``)
through ``ctypes``.  Callers pass validated CUDA tensors; :mod:`.ops` is
the public wrapper.

Geometry (:func:`plan`): one warp per (group row, segment of whole H
tiles), ``R`` rows a block whose pattern streams the block copies into
shared memory; a lane takes 16 bitmap bytes (128 columns) a pass, so a warp
covers :data:`STRIDE` columns a pass and loops over longer segments.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

STRIDE = 4096  # columns a warp decodes a pass: 32 lanes x 16 bitmap bytes x 8
MAX_WARPS = 16  # warps a block (kMaxWarps in the source)
ROWS_A_BLOCK = (8, 4, 2)  # tried in this order; 1 where none fills the card


class Plan(NamedTuple):
    """One launch's geometry: ``R`` rows a block, ``WR`` warps a row,
    ``tps`` tiles a segment, ``NS`` segments a row, ``cap_s`` shared bytes
    of a row's stream (``cap`` rounded up to 16, plus 16 bytes that the
    word loads past the last pattern may touch), ``copy`` bytes a stream
    copy (16, 8 or 4 by ``cp.async``, else 1), ``blocks`` and ``smem``
    bytes of shared memory a block."""

    R: int
    WR: int
    tps: int
    NS: int
    cap_s: int
    copy: int
    blocks: int
    smem: int

    @property
    def threads(self) -> int:
        return 32 * self.R * self.WR


@functools.lru_cache(maxsize=None)
def plan(G: int, H: int, tile_k: int, cap: int, sms: int, align: int = 16) -> Plan:
    """The launch geometry of one shape.  A segment is as many whole tiles
    as fit one pass (one tile where a tile is longer than a pass); ``WR``
    warps share a row's segments (at most :data:`MAX_WARPS`).  ``R`` is the
    most rows a block (8, 4, 2) whose grid still has a block for every one
    of ``sms`` SMs, whose warps fit a block and whose streams fit its
    shared memory, else 1: G 768 gets 4 rows a block (192 blocks), G 2048
    gets 8 (256).  ``align`` is the largest power of two (up to 16) that
    the patterns' base address is a multiple of; the copy width is the
    largest of 16, 8, 4 dividing it and ``cap``.  Raises where one row's
    stream does not fit a block's shared memory, naming the cap."""
    n_tiles = H // tile_k
    tps = min(max(1, STRIDE // tile_k), n_tiles)
    NS = -(-n_tiles // tps)
    WR = min(NS, MAX_WARPS)
    cap_s = -(-cap // 16) * 16 + 16
    if cap_s > build.MAX_SMEM:
        raise ValueError(
            f"bstc_decode: a pattern stream of cap={cap} bytes a row needs {cap_s} B of "
            f"shared memory, over the block's {build.MAX_SMEM}; the cap is "
            f"cap={build.MAX_SMEM}")
    R = 1
    for r in ROWS_A_BLOCK:
        if -(-G // r) >= sms and r * WR <= MAX_WARPS and r * cap_s <= build.MAX_SMEM:
            R = r
            break
    copy = next(c for c in (16, 8, 4, 1) if cap % c == 0 and align % c == 0)
    return Plan(R, WR, tps, NS, cap_s, copy, -(-G // R), R * cap_s)


def alignment(t: torch.Tensor) -> int:
    """The largest power of two up to 16 that ``t``'s base address is a
    multiple of."""
    p = t.data_ptr()
    return next(a for a in (16, 8, 4, 2, 1) if p % a == 0)


def wide_rows(bitmap: torch.Tensor, out: torch.Tensor, H: int, tile_k: int) -> bool:
    """Whether every lane's 16 bitmap bytes and 16 output columns are one
    aligned 16-byte load and store: H and the tile multiples of 128
    columns, both base addresses 16-byte aligned."""
    return (H % 128 == 0 and tile_k % 128 == 0 and alignment(bitmap) == 16
            and alignment(out) == 16)


def launch(bitmap, tile_offsets, patterns, out, H: int, geometry: Plan) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    G, cap = patterns.shape
    tile_k = H // tile_offsets.shape[1]
    R, WR, tps, NS, cap_s, copy, blocks, smem = geometry
    stream = torch.cuda.current_stream(bitmap.device).cuda_stream
    err = lib.bstc_decode_launch(bitmap.data_ptr(), tile_offsets.data_ptr(),
                                 patterns.data_ptr(), out.data_ptr(), G, H, tile_k, cap,
                                 R, WR, tps, NS, cap_s, copy,
                                 int(wide_rows(bitmap, out, H, tile_k)), blocks, smem, stream)
    build.check(err, "bstc_decode")
