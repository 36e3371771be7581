"""Launch the CUDA flash-attention kernel
(``src/repro_torch/csrc/flash_attention.cu``) through ``ctypes``.

Two bodies, each with the geometry :func:`plan` gives.  bf16 operands run
on the tensor cores: a 128-thread block per (32-row query tile, batch x
query head), 2 row groups of 16 rows x 2 key halves (32 of every 64-key
tile), one warp each; grid ``(B * Hq, query tiles)``, tiles issued heaviest
first.  f32 operands run the CUDA-core body: a 128-thread block per
(64-row query tile, batch x query head).  Both read q/k/v through their
batch, sequence and head strides (unit stride along D) and write a
contiguous ``(B, Sq, Hq, D)`` out, and, when asked, each row's log-sum-exp
``(B, Hq, Sq)`` f32.

The backward (``src/repro_torch/csrc/flash_attention_bwd.cu``) has the
geometry :func:`bwd_plan` gives: 256-thread blocks over tiles of
:func:`bwd_tile` rows, one grid over (key tiles, batch x kv head) for dk
and dv and one over (query tiles, batch x query head) for dq, after a
delta pass.  Callers pass validated CUDA tensors; :mod:`.ops` is the
public wrapper.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MASK_CODES = {"full": 0, "causal": 1, "sliding": 2, "chunked": 3, "prefix_causal": 4}
TILE_K = 64  # kBK: keys a tile, both bodies
F32_BQ = 64  # kBQ: the f32 body's query rows a block
MMA_BQ = 32  # kMmaBQ: the bf16 body's query rows a block
HEAD_DIMS = (16, 32, 64, 128, 256)  # the source's compiled widths DP


class Plan(NamedTuple):
    """One launch's geometry: ``BQ`` query rows of one (batch, query head)
    a block of ``threads`` threads, ``smem`` bytes of dynamic shared
    memory, and the launch grid."""

    BQ: int
    threads: int
    smem: int
    grid: tuple


def padded_dim(D: int) -> int:
    """The compiled width a head width ``D`` runs at: the least of
    :data:`HEAD_DIMS` that holds it (the kernel reads q, k and v past ``D``
    as zero and drops the output past it).  Raises past the widest."""
    for DP in HEAD_DIMS:
        if D <= DP:
            return DP
    raise ValueError(f"flash_attention: head_dim {D} is over the kernel's widest compiled "
                     f"width {HEAD_DIMS[-1]} (compiled widths {HEAD_DIMS})")


def smem_bytes(dtype: torch.dtype, D: int) -> int:
    """Dynamic shared memory of one block (the source's carve-up) at the
    compiled width of ``D``.  bf16: the Q tile and two stages of 64-key K
    and V tiles, 2 bytes an element (147,456 B at 256: one block an SM).
    f32: the padded Q and K tiles, the V tile and the padded P tile, 4
    bytes an element (213,760 B at 256, under the block's 232,448)."""
    D = padded_dim(D)
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


def wide_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether every row of q, k and v starts on a 16-byte boundary (base
    pointers and batch / sequence / head strides): the bf16 body then
    stages them by 16-byte ``cp.async``, else element by element."""
    return all(t.data_ptr() % 16 == 0 and all((s * t.element_size()) % 16 == 0
                                              for s in t.stride()[:3]) for t in (q, k, v))


def launch(q, k, v, out, geometry: Plan, mask_kind: str, window: int, q_offset: int,
           scale: float, lse=None) -> None:
    """Enqueue one launch on the current stream; raise if it was refused.
    ``lse``: None, or a ``(B, Hq, Sq)`` f32 tensor that takes each row's
    log-sum-exp (``out`` is the same either way)."""
    lib = build.load()
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, Sk, Hq, Hk, D, padded_dim(D), int(wide_rows(q, k, v)),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        _DTYPE[q.dtype], MASK_CODES[mask_kind], int(window), int(q_offset), float(scale),
        geometry.BQ, geometry.smem, stream,
    )
    build.check(err, "flash_attention")


BWD_THREADS = 256  # the backward's blocks: 16 row groups x 16 column lanes


class BwdPlan(NamedTuple):
    """The backward's geometry: ``tile`` rows a tile (keys of a dk/dv
    block, queries of a dq block), ``threads`` a block, the two blocks'
    dynamic shared memory, and the two grids."""

    tile: int
    threads: int
    smem_kv: int
    smem_q: int
    grid_kv: tuple
    grid_q: tuple


def bwd_tile(D: int) -> int:
    """Rows a backward tile: 64, or 32 at the compiled width 256."""
    return 32 if padded_dim(D) > 128 else 64


def bwd_smem_bytes(D: int) -> Tuple[int, int]:
    """Dynamic shared memory of the dk/dv block and of the dq block (the
    source's carve-up, f32 whatever the operands' dtype): four ``(T, DP +
    1)`` row tiles each, the P and dS tiles ``(T, T + 1)`` (dq: dS only)
    and lse and delta (T each).  165,888 and 149,248 B at D 128; 140,288
    and 136,064 B at D 256."""
    DP, T = padded_dim(D), bwd_tile(D)
    rows = 4 * T * (DP + 1) + 2 * T
    return 4 * (rows + 2 * T * (T + 1)), 4 * (rows + T * (T + 1))


@functools.lru_cache(maxsize=None)
def bwd_plan(B: int, Sq: int, Sk: int, Hq: int, Hk: int, D: int) -> BwdPlan:
    """The backward's launch geometry of one shape (the same for f32 and
    bf16 operands: it computes in f32)."""
    T = bwd_tile(D)
    kv, q = bwd_smem_bytes(D)
    return BwdPlan(T, BWD_THREADS, kv, q, (-(-Sk // T), B * Hk), (-(-Sq // T), B * Hq))


def launch_bwd(q, k, v, o, dout, lse, delta, dq, dk, dv, geometry: BwdPlan, mask_kind: str,
               window: int, q_offset: int, scale: float) -> None:
    """Enqueue the backward's three launches (delta, dk / dv, dq) on the
    current stream; raise if one was refused.  ``delta`` is a ``(B, Hq,
    Sq)`` f32 workspace; dq, dk and dv are written whole."""
    lib = build.load()
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, Sk, Hq, Hk, D, padded_dim(D),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *dout.stride()[:3],
        _DTYPE[q.dtype], MASK_CODES[mask_kind], int(window), int(q_offset), float(scale),
        geometry.tile, geometry.smem_kv, geometry.smem_q, stream,
    )
    build.check(err, "flash_attention_bwd")
