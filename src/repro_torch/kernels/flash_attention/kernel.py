"""Launch the CUDA flash-attention kernel
(``src/repro_torch/csrc/flash_attention.cu``) through ``ctypes``.

Two bodies, each with the geometry :func:`plan` gives.  bf16 operands run
on the tensor cores: a 128-thread block per (32-row query tile, batch x
query head), 2 row groups of 16 rows x 2 key halves (32 of every 64-key
tile), one warp each; grid ``(B * Hq, query tiles)``, tiles issued heaviest
first.  f32 operands run the CUDA-core body: a 128-thread block per
(64-row query tile, batch x query head).  Both read q/k/v through their
batch, sequence and head strides (unit stride along D) and write a
contiguous ``(B, Sq, Hq, D)`` out.  Callers pass validated CUDA tensors;
:mod:`.ops` is the public wrapper.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MASK_CODES = {"full": 0, "causal": 1, "sliding": 2, "chunked": 3}
TILE_K = 64  # kBK: keys a tile, both bodies
F32_BQ = 64  # kBQ: the f32 body's query rows a block
MMA_BQ = 32  # kMmaBQ: the bf16 body's query rows a block


class Plan(NamedTuple):
    """One launch's geometry: ``BQ`` query rows of one (batch, query head)
    a block of ``threads`` threads, ``smem`` bytes of dynamic shared
    memory, and the launch grid."""

    BQ: int
    threads: int
    smem: int
    grid: tuple


def smem_bytes(dtype: torch.dtype, D: int) -> int:
    """Dynamic shared memory of one block (the source's carve-up).  bf16:
    the Q tile and two stages of 64-key K and V tiles, 2 bytes an element.
    f32: the padded Q and K tiles, the V tile and the padded P tile, 4
    bytes an element."""
    if dtype == torch.float32:
        return 4 * (F32_BQ * (D + 1) + TILE_K * (D + 1) + TILE_K * D
                    + F32_BQ * (TILE_K + 1))
    return 2 * D * (MMA_BQ + 2 * 2 * TILE_K)


@functools.lru_cache(maxsize=None)
def plan(dtype: torch.dtype, B: int, Sq: int, Hq: int, D: int) -> Plan:
    """The launch geometry of one shape.  bf16: 32 query rows a block, in
    2 row groups of 16 x 2 key halves, one warp each (128 threads); grid
    ``(B * Hq, query tiles)``, so a head's tiles are issued heaviest first
    across all heads (B 1, Hq 24: 168 blocks at S 201, 384 at S 512; three
    fit an SM).  f32: the CUDA-core body's 64 rows, 128 threads, grid
    ``(query tiles, B * Hq)``."""
    if dtype == torch.float32:
        return Plan(F32_BQ, 128, smem_bytes(dtype, D), (-(-Sq // F32_BQ), B * Hq))
    return Plan(MMA_BQ, 4 * MMA_BQ, smem_bytes(dtype, D), (B * Hq, -(-Sq // MMA_BQ)))


def launch(q, k, v, out, geometry: Plan, mask_kind: str, window: int, q_offset: int,
           scale: float) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, Hq, Hk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        _DTYPE[q.dtype], MASK_CODES[mask_kind], int(window), int(q_offset), float(scale),
        geometry.BQ, geometry.smem, stream,
    )
    build.check(err, "flash_attention")
