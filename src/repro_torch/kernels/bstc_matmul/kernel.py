"""Launch the CUDA fused BSTC decode + matmul
(``src/repro_torch/csrc/bstc_matmul.cu``) through ``ctypes``.

Callers pass validated CUDA tensors; :mod:`.ops` is the public wrapper.
x and out go by their element strides, so transposed views need no copy.
Geometry (:func:`plan`, from static shapes): a work item is one (group row,
H tile); the grid is ``(G / R, C, N / NB)`` with thread-block clusters of
``C`` blocks along y, cluster rank ``c`` owning the tiles ``[c*T, (c+1)*T)``
and each of a block's ``R`` warps one group row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

GROUP = 4  # kGroup: the BSTC group m the kernel is built for
MAX_WARPS = 8  # kMaxWarps: R at most, group rows a block
MAX_CLUSTER = 8  # kMaxCluster: the portable cluster size
MAX_SHIFT = 6  # kMagPlanes - 1: the highest magnitude plane (|w| <= 127 packs in a byte)
MAX_PLANES = MAX_SHIFT + 1  # coded + raw magnitude planes
STEP_BYTES = 64  # kStepBytes: bytes of a row a warp decodes a step (512 columns)
STEP_COLS = 8 * STEP_BYTES
WINDOW = 544  # kWindow: a coded plane's staged segment, 512 slots in 16-byte chunks
META = 160  # kMeta: a stage's window table
ROW_TABLE = 8 * (GROUP * 9 + 8)  # kRowTable: a warp's staged-row pointers
MAX_STAGES = 4  # kMaxStages: copy buffers a warp, steps in flight
SM_SMEM = 228 * 1024  # shared memory of one SM; a block also reserves 1 KB
BLOCKS_PER_SM = 2  # __launch_bounds__ in the source: two 256-thread blocks an SM
MAX_COL_BLOCKS = 65535  # grid.z


class Plan(NamedTuple):
    """One launch's geometry: ``R`` warps (group rows) a block of
    ``threads``; ``C`` blocks a cluster, each owning ``T`` H tiles, walked
    in ``chunks`` steps of 512 columns each; ``NB`` columns of x a block;
    ``stages`` copy buffers (``stages - 1`` steps in flight ahead of the
    one decoded; 2 where a tile takes several steps);
    ``smem`` bytes of dynamic shared memory; the operand rows' copy width
    ``width`` (16, 8, 4 or 1 bytes) and x's (16: cp.async of an aligned
    unit-stride f32 view, 0: element copies); the launch grid."""

    R: int
    C: int
    T: int
    NB: int
    threads: int
    chunks: int
    stages: int
    smem: int
    width: int
    x_width: int
    grid: tuple


def stage_bytes(n_enc: int, n_raw: int) -> int:
    """One warp's copy buffer for one step (the source's carve-up): the
    window table, 4 sign rows, 4 rows a raw plane, a bitmap row and a
    pattern segment a coded plane."""
    return META + STEP_BYTES * (GROUP + GROUP * n_raw + n_enc) + WINDOW * n_enc


def smem_bytes(R: int, NB: int, stages: int, n_enc: int, n_raw: int) -> int:
    """A block's dynamic shared memory: ``stages`` x tiles of ``NB`` f32
    columns of 512, the ``(4R, NB)`` f32 partials, and each warp's row
    table and ``stages`` copy buffers."""
    return (4 * stages * NB * STEP_COLS + 4 * GROUP * R * NB
            + R * (ROW_TABLE + stages * stage_bytes(n_enc, n_raw)))


def copy_width(H: int, tile_k: int) -> int:
    """The widest copy (16, 8, 4 or 1 bytes) every operand row segment of a
    step starts on: it divides a row's ``H/8`` bytes and a tile's
    ``tile_k/8`` (the arrays themselves start 16-byte aligned)."""
    hb, tb = H // 8, tile_k // 8
    for w in (16, 8, 4):
        if hb % w == 0 and tb % w == 0:
            return w
    return 1


def grid_cost(blocks: int, T: int, n_sms: int) -> int:
    """A launch's time in block-steps: its waves of ``BLOCKS_PER_SM *
    n_sms`` resident blocks, each ``T`` steps plus one for a block's fill
    and drain.  It charges a partial last wave in full: 288 blocks on 132
    SMs (1.09 waves) take two."""
    return -(-blocks // (BLOCKS_PER_SM * n_sms)) * (T + 1)


@functools.lru_cache(maxsize=None)
def plan(M: int, H: int, N: int, tile_k: int, m: int, n_sms: int, n_enc: int, n_raw: int,
         x_vec: bool = False) -> Plan:
    """The launch geometry of one shape.

    ``R`` starts at 8 and halves while even the widest cluster leaves fewer
    blocks than ``n_sms``.  ``C`` (at most 8, at most one per tile, ``T =
    ceil(n_tiles / C)`` tiles a block, ``C`` recomputed from ``T`` so every
    rank owns a tile) minimises :func:`grid_cost`, the smaller ``C`` on a
    tie.  At 132 SMs, N 4 and tile_k 512: wq/wo C 2, T 3 (192 blocks);
    wk/wv C 6, T 1 (192); gate/up C 1, T 6 (256); down C 2, T 8 (192);
    lm_head C 1, T 6 (6252) -- at each the cluster size with the least
    device time on an H100 (PERF.md §6).  A block's steps run through
    a ring of up to 4 copy buffers a warp, as deep as two blocks an SM leave
    room for.  ``NB`` is the smallest of 1,
    2, 4, 8 that holds N.  ``x_vec``: x is an f32 view with unit stride
    along H whose columns start 16-byte aligned.  Raises for what the
    kernel does not take."""
    if m != GROUP:
        raise ValueError(f"bstc_matmul: the CUDA kernel decodes groups of m={GROUP}, got m={m}")
    if n_enc < 0 or n_raw < 0 or n_enc + n_raw > MAX_PLANES:
        raise ValueError(f"bstc_matmul: {n_enc} coded + {n_raw} raw planes; at most "
                         f"{MAX_PLANES} magnitude planes")
    if tile_k < 8 or tile_k % 8 or H % tile_k:
        raise ValueError(f"bstc_matmul: tile_k={tile_k} must be a multiple of 8 dividing "
                         f"H={H}")
    if M < GROUP or M % GROUP:
        raise ValueError(f"bstc_matmul: M={M} must be a positive multiple of {GROUP}")
    if N < 1 or N > MAX_COL_BLOCKS * 8:
        raise ValueError(f"bstc_matmul: N={N} columns; the grid takes 1 to "
                         f"{MAX_COL_BLOCKS * 8}")
    G, n_tiles, tb = M // GROUP, H // tile_k, tile_k // 8
    NB = next(nb for nb in (1, 2, 4, 8) if N <= nb or nb == 8)
    gz = -(-N // NB)
    blocks = lambda R, C: -(-G // R) * C * gz
    R = MAX_WARPS
    while R > 1 and blocks(R, min(MAX_CLUSTER, n_tiles)) < n_sms:
        R //= 2
    _, C, T = min((grid_cost(blocks(R, -(-n_tiles // t)), t, n_sms), -(-n_tiles // t), t)
                  for t in {-(-n_tiles // c) for c in range(1, min(MAX_CLUSTER, n_tiles) + 1)})
    chunks = -(-tb // STEP_BYTES)
    steps = T * chunks
    stages = 1 if steps == 1 else 2 if chunks > 1 else min(steps, MAX_STAGES)
    while stages > 2 and BLOCKS_PER_SM * (smem_bytes(R, NB, stages, n_enc, n_raw) + 1024) \
            > SM_SMEM:
        stages -= 1
    smem = smem_bytes(R, NB, stages, n_enc, n_raw)
    if smem > build.MAX_SMEM:  # never: ~109 KB at most (R 8, NB 8, 2 stages, 7 coded planes)
        raise ValueError(f"bstc_matmul: {smem} B of shared memory a block, over "
                         f"{build.MAX_SMEM}")
    x_width = 16 if x_vec and tb % 2 == 0 else 0
    return Plan(R, C, T, NB, 32 * R, chunks, stages, smem, copy_width(H, tile_k), x_width,
                (-(-G // R), C, gz))


def x_vectorizable(x: torch.Tensor) -> bool:
    """Whether x (H, N) can be staged by 16-byte copies: f32, unit stride
    along H, each column's start 16-byte aligned."""
    return (x.dtype == torch.float32 and x.stride(0) == 1
            and (x.shape[1] == 1 or x.stride(1) % 4 == 0) and x.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=None)
def plan_array(p: Plan) -> ctypes.Array:
    """The plan as the C entry point reads it: ``[R, C, T, NB, chunks,
    stages, smem, width, x_width]``."""
    vals = [p.R, p.C, p.T, p.NB, p.chunks, p.stages, p.smem, p.width, p.x_width]
    return (ctypes.c_int * len(vals))(*vals)


def descriptor(ops) -> ctypes.Array:
    """The plane table the C entry point reads: ``[n_enc, n_raw, (bitmap,
    offsets, patterns, cap, p) per coded plane, (plane, p) per raw plane]``."""
    desc = [len(ops.enc_planes), len(ops.raw_planes)]
    for i, p in enumerate(ops.enc_planes):
        bitmap, offsets, patterns = ops.enc[3 * i:3 * i + 3]
        desc += [bitmap.data_ptr(), offsets.data_ptr(), patterns.data_ptr(),
                 patterns.shape[1], p]
    for raw, p in zip(ops.raw, ops.raw_planes):
        desc += [raw.data_ptr(), p]
    return (ctypes.c_longlong * len(desc))(*desc)


def launch(desc, ops, x, scale, out, geometry: Plan) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    H, N = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.bstc_matmul_launch(
        desc, ops.sign_bits.data_ptr(), x.data_ptr(), X_DTYPES[x.dtype], *x.stride(),
        None if scale is None else scale.data_ptr(), out.data_ptr(), *out.stride(),
        ops.M, H, N, ops.tile_k, plan_array(geometry), stream)
    build.check(err, "bstc_matmul")
