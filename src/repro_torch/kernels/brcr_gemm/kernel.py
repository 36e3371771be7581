"""Launch the CUDA BRCR GEMM (``src/repro_torch/csrc/brcr_gemm.cu``)
through ``ctypes``.

Geometry (:func:`plan`, from static shapes): a block of 4 warps owns
``GB`` groups (8 row tiles of 16 MAV bins: 8 groups at m = 4, 32 at
m = 2) and ``NB`` columns of x (8, 16 or 32); thread-block clusters of
``C`` blocks along y split the ``TILE_K``-column tiles of H, rank ``c``
owning ``[c*T, (c+1)*T)``.  The grid is ``(N / NB, C, G / GB)``.  x is read
at its element strides; out is a contiguous (M, N) float32 tensor.  Callers
pass validated CUDA tensors; :mod:`.ops` is the public wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TERMS = {torch.float32: 3, torch.bfloat16: 1}  # bf16 terms of x: hi + mid + lo, or x itself

GROUPS = (2, 4)  # the group sizes m the kernel is built for
WARPS = 4  # kWarps: warps a block
ROW_TILES = 2  # kRT: 16-row MAV tiles a warp
TILE_K = {4: 128, 2: 64}  # kTK: H columns a tile, by m
PAD = 16  # kPad: bytes (patterns) and bf16 (x) past each staged row
MAX_CLUSTER = 8  # kMaxCluster: the portable cluster size
MAX_PLANES = 16  # kMaxPlanes: signed planes (2 x at most 8 magnitude bits)
SM_SMEM = 228 * 1024  # shared memory of one SM; a block also reserves 1 KB
MAX_ROW_BLOCKS = 65535  # grid.z
MAX_COL_BLOCKS = 2 ** 31 - 1  # grid.x


def blocks_per_sm(NT: int, terms: int) -> int:
    """The source's ``__launch_bounds__`` minimum: 3 blocks an SM for the
    widest f32 instance (its accumulators and x terms need up to 168
    registers), 4 for the rest (128)."""
    return 3 if NT == 4 and terms == 3 else 4


def groups_per_block(m: int) -> int:
    """``kGB``: 8 row tiles of 16 bins, 16 / 2^m groups each."""
    return WARPS * ROW_TILES * (16 >> m)


def smem_bytes(m: int, P: int, NT: int, terms: int) -> int:
    """A block's dynamic shared memory (the source's ``Shape::smem``): two
    pattern stages of P planes x GB padded rows, the x tile as ``terms``
    bf16 planes of ``8 NT`` padded columns, the (GB m, 8 NT) f32 E @ Z part,
    and the plane weights."""
    row = TILE_K[m] + PAD
    gb = groups_per_block(m)
    return 2 * P * gb * row + 2 * terms * 8 * NT * row + 4 * gb * m * 8 * NT + 4 * MAX_PLANES


def copy_width(H: int, align: int) -> int:
    """The widest pattern copy (16, 8, 4 or 1 bytes) that divides a row's H
    bytes and the operand's base alignment, so every copy lies wholly in a
    row or wholly past its end."""
    for w in (16, 8, 4):
        if H % w == 0 and align % w == 0:
            return w
    return 1


def grid_cost(blocks: int, T: int, resident: int) -> int:
    """A launch's time in tile-steps: its waves of ``resident`` blocks (all
    SMs), each ``T`` tiles plus one for a block's fill and its E @ Z and
    cluster sum.  A partial last wave costs a whole one."""
    return -(-blocks // resident) * (T + 1)


class Plan(NamedTuple):
    """One launch's geometry: ``NT`` n-tiles of 8 columns (``NB`` columns
    of x a block), ``terms`` bf16 terms of x, ``K`` H columns a tile
    (``n_tiles`` of them), ``C`` blocks a cluster each owning ``T`` tiles,
    ``GB`` groups a block of ``threads``, the pattern copy ``width``,
    ``smem`` bytes of dynamic shared memory, ``resident`` blocks on the
    card at once, and the launch grid."""

    NT: int
    NB: int
    terms: int
    K: int
    n_tiles: int
    C: int
    T: int
    GB: int
    threads: int
    width: int
    smem: int
    resident: int
    grid: tuple


@functools.lru_cache(maxsize=None)
def plan(M: int, H: int, N: int, m: int, P: int, n_sms: int, terms: int,
         align: int = 16) -> Plan:
    """The launch geometry of one shape.

    ``NT`` is the fewest n-tiles that hold N, at most 4 (``NB`` 32: N 128 is
    four column blocks).  ``C`` (at most 8, at most one a tile; ``T =
    ceil(n_tiles / C)`` tiles a rank and ``C`` recomputed from ``T`` so
    every rank owns a tile) minimises :func:`grid_cost` over the blocks the
    card holds at once, the smaller ``C`` on a tie.  At 132 SMs and f32 x:
    8192 x 3072 at N 16 takes 256 row blocks x C 2 (T 12; 528 resident);
    3072 x 3072 and 3072 x 8192 at N 4 take C 5, 1024 x 3072 C 8.
    ``align``: the pattern operand's base alignment in bytes.  Raises for
    what the kernel does not take."""
    if m not in GROUPS:
        raise ValueError(f"brcr_gemm: the CUDA kernel takes m in {GROUPS}, got {m}")
    if M < m or M % m:
        raise ValueError(f"brcr_gemm: M={M} must be a positive multiple of m={m}")
    if H < 1 or N < 1:
        raise ValueError(f"brcr_gemm: H={H}, N={N}: the kernel needs at least one of each")
    if not 1 <= P <= MAX_PLANES:
        raise ValueError(f"brcr_gemm: {P} planes; the kernel takes 1 to {MAX_PLANES}")
    if terms not in (1, 3):
        raise ValueError(f"brcr_gemm: {terms} terms of x; the kernel takes 1 (bf16) or 3 (f32)")
    G, K, GB = M // m, TILE_K[m], groups_per_block(m)
    NT = 1 if N <= 8 else 2 if N <= 16 else 4
    NB = 8 * NT
    gx, rows = -(-N // NB), -(-G // GB)
    if rows > MAX_ROW_BLOCKS or gx > MAX_COL_BLOCKS:
        raise ValueError(f"brcr_gemm: ({M}, {N}) needs a grid of {rows} row blocks x {gx} "
                         f"column blocks, over ({MAX_ROW_BLOCKS}, {MAX_COL_BLOCKS})")
    smem = smem_bytes(m, P, NT, terms)
    if smem > build.MAX_SMEM:  # never: ~95 KB at most (m 2, P 16, NT 4, f32)
        raise ValueError(f"brcr_gemm: {smem} B of shared memory a block, over "
                         f"{build.MAX_SMEM}")
    resident = n_sms * min(blocks_per_sm(NT, terms), SM_SMEM // (smem + 1024))
    n_tiles = -(-H // K)
    _, C, T = min((grid_cost(gx * rows * -(-n_tiles // t), t, resident), -(-n_tiles // t), t)
                  for t in {-(-n_tiles // c) for c in range(1, min(MAX_CLUSTER, n_tiles) + 1)})
    return Plan(NT, NB, terms, K, n_tiles, C, T, GB, 32 * WARPS, copy_width(H, align), smem,
                resident, (gx, C, rows))


@functools.lru_cache(maxsize=None)
def plan_array(p: Plan) -> ctypes.Array:
    """The plan as the C entry point reads it: ``[NT, terms, K, C, T,
    width, smem, grid x, grid y, grid z]``."""
    vals = [p.NT, p.terms, p.K, p.C, p.T, p.width, p.smem, *p.grid]
    return (ctypes.c_int * len(vals))(*vals)


def launch(ops, x, out, geometry: Plan) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    P, G, H = ops.group_idx.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.brcr_gemm_launch(
        ops.group_idx.data_ptr(), ops.plane_weights.data_ptr(), x.data_ptr(),
        X_DTYPES[x.dtype], *x.stride(), out.data_ptr(), *out.stride(),
        P, G, H, x.shape[1], ops.m, plan_array(geometry), stream)
    build.check(err, "brcr_gemm")
