"""Launch the CUDA BGPP round-scoring kernel
(``src/repro_torch/csrc/bgpp_score.cu``) through ``ctypes``.

Grid: one 128-thread block per (slot, key tile, kv head), the kv heads of
a tile adjacent; the block scores the ``g`` query rows of its kv head
(query row ``r`` is head ``r % Hq`` of batch ``r // Hq``) against the
tile's plane and sign rows, read through the planes' batch, token and head
strides (unit stride along the packed D).  :func:`plan` gives the lanes a
key, the tile and the shared memory from static shapes.  Callers pass
validated CUDA tensors; :mod:`.ops` is the public wrapper.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

THREADS = 128  # kThreads in the source
PLANES = 32  # kPlanes: bit planes of |q| as a 32-bit unsigned
MAX_LPK = 4  # lanes that share one key's words
MAX_PASSES = 8  # passes of the block over its tile
BLOCKS_AN_SM = 4  # the smallest grid :func:`plan` keeps, in blocks an SM


class Plan(NamedTuple):
    """One launch's geometry: ``WP`` 32-bit words of a staged row (a power
    of two), ``LPK`` lanes a key, ``TS`` keys a tile (``THREADS // LPK``
    keys a pass, ``TS // (THREADS // LPK)`` passes), ``tiles`` tiles a
    slot, ``blocks`` blocks and ``smem`` bytes of shared memory a block."""

    WP: int
    LPK: int
    TS: int
    tiles: int
    blocks: int
    smem: int


def smem_bytes(g: int, WP: int, TS: int) -> int:
    """Dynamic shared memory of one block (the source's carve-up): the
    tile's plane and sign rows, the ``(g, TS)`` alive bytes and int32
    scores, per row its sign mask, 32 magnitude planes and their shifts
    and the planes used, and the rows-alive mask."""
    return (4 * (2 * TS * WP) + g * TS + 4 * g * TS
            + 4 * (g * WP + g * PLANES * WP + g * PLANES + g + 1))


@functools.lru_cache(maxsize=None)
def plan(B: int, Hk: int, g: int, S: int, D: int, sms: int) -> Plan:
    """The launch geometry of one shape.  A row's ``ceil(D / 32)`` words
    are staged as ``WP`` (the next power of two), ``LPK = min(WP, 4)``
    lanes share a key, so a pass covers ``THREADS // LPK`` keys.  The tile
    is the most passes (at most ``MAX_PASSES``) whose grid still has
    ``BLOCKS_AN_SM`` blocks an SM, else one pass: at D 128 the one-query
    walkthrough (S 4096) gets 128 blocks of 32 keys, the decode geometry
    (B 4, Hk 8, S 1024) 1024 blocks of 32 and S 32768 4096 blocks of 256.
    Fewer passes where the tile's shared memory does not fit; raises
    where one pass does not, with the cap on ``g``."""
    WP = 1 << max(0, -(-D // 32) - 1).bit_length()
    LPK = min(WP, MAX_LPK)
    kpp = THREADS // LPK
    passes = MAX_PASSES
    while passes > 1 and B * Hk * -(-S // (kpp * passes)) < BLOCKS_AN_SM * sms:
        passes //= 2
    while passes > 1 and smem_bytes(g, WP, kpp * passes) > build.MAX_SMEM:
        passes //= 2
    TS = kpp * passes
    smem = smem_bytes(g, WP, TS)
    if smem > build.MAX_SMEM:
        fixed, per_row = smem_bytes(0, WP, TS), smem_bytes(1, WP, TS) - smem_bytes(0, WP, TS)
        raise ValueError(
            f"bgpp_score: g={g} query rows a kv head at D={D} need {smem} B of shared "
            f"memory a block, over the block's {build.MAX_SMEM}; the cap at D={D} is "
            f"g={(build.MAX_SMEM - fixed) // per_row}")
    tiles = -(-S // TS)
    return Plan(WP, LPK, TS, tiles, B * tiles * Hk, smem)


def wide_rows(plane: torch.Tensor, sign: torch.Tensor) -> bool:
    """Whether every packed row of both operands starts on a 16-byte
    boundary and is whole 16-byte chunks: the kernel then stages rows by
    16-byte ``cp.async`` copies, else byte by byte."""
    Dp = plane.shape[3]
    return Dp % 16 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % 16 == 0 for s in t.stride()[:3])
        for t in (plane, sign))


def launch(q, plane, sign, alive, out, geometry: Plan) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    B, Hq, D = q.shape
    S, Hk = plane.shape[1], plane.shape[2]
    WP, LPK, TS, _, _, smem = geometry
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.bgpp_score_launch(
        q.data_ptr(), plane.data_ptr(), sign.data_ptr(), alive.data_ptr(), out.data_ptr(),
        B, S, D, Hq, Hk, WP, LPK, TS, smem, int(wide_rows(plane, sign)),
        *plane.stride()[:3], *sign.stride()[:3], stream)
    build.check(err, "bgpp_score")
