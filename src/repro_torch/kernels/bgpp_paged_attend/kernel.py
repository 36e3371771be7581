"""Launch the CUDA fused BGPP decode kernel
(``src/repro_torch/csrc/bgpp_paged_attend.cu``) through ``ctypes``.

Callers pass validated CUDA tensors; :mod:`.ops` is the public wrapper.
Grid: one thread-block cluster of ``C`` 256-thread blocks per (slot,
kv-head) cell.  :func:`plan` chooses ``C`` from static shapes, once per
shape, and splits every list of the pipeline over the cluster by rank:
block ``c`` owns the round-0 lanes ``[c * L, (c + 1) * L)`` and, in the
list of round ``r`` (its survivors in selection order), the ranks
``[c * caps[r], (c + 1) * caps[r])``.

Shared memory a block (:func:`smem_bytes`, the source's carve-up): a
header (the query's int8 codes and bit masks, the softmax statistics, the
plan; :func:`header_bytes`), the sort keys of the block's largest list (a
power of two, at least one a thread), a stage for the other blocks' sorted
keys, two lists of ``L`` entries (lane and ``g`` partial scores in whole
16-byte words; the rounds alternate between them) and the warps' ``(g,
DP)`` PV partials at the compiled width.  Where the two lists do not fit
beside the rest even at ``MAX_CLUSTER`` blocks, the plan puts them in a
global workspace (:func:`workspace_ints`; ``Plan.workspace``), which the
wrapper allocates on q's device.  One cluster then takes the block
sort's ``MAX_CLUSTER * MAX_LIST`` = 32768 lanes at every g <= 8 and D <=
256 (:func:`cluster_lanes`), the reference's decode_32k context.

Past one cluster the plan is the body whose selection spans blocks
(``csrc/bgpp_paged_attend_long.cu``; ``Plan.spans``): a sequence of
launches over ``B * Hk`` cells of ``C`` tiles of ``LONG_TILE`` entries a
cell, each round's list ranked by a global radix sort, everything in the
workspace.  Its cap (:func:`max_lanes`) is the reference's largest assigned
context, long_500k's 524,288 lanes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

THREADS = 256  # kThreads in the source
WARPS = THREADS // 32
STAGE = 2048  # kStage: the other blocks' sort keys staged at once
MAX_CLUSTER = 8  # the portable cluster size
MAX_SLOTS = 16  # kMaxSlots: keys a thread holds in the block sort
MAX_LIST = MAX_SLOTS * THREADS  # the most entries a block's list may hold
HEAD_DIMS = (16, 32, 64, 128, 256)  # the source's compiled widths DP
LONG_TILE = 4096  # kTile in bgpp_paged_attend_long.cu: entries a block in every sweep
LONG_MAX_LANES = 524_288  # the reference's long_500k context (configs/shapes.py)


class Plan(NamedTuple):
    """One launch's geometry: ``C`` blocks a (slot, kv-head) cluster, ``L``
    round-0 lanes a block, ``caps[r]`` ranks a block owns in the list of
    round ``r`` (``r = rounds``: the final ``k_max`` survivors), ``smem``
    bytes of shared memory a block and whether the lists lie in a global
    workspace (``workspace``) instead of shared memory.  With ``spans`` the
    selection spans blocks: ``C`` tiles of ``L = LONG_TILE`` entries cover
    a cell's round-0 list, ``caps[r]`` tiles the list of round ``r``, and
    the blocks are no cluster (``smem`` 0: static shared memory only)."""

    C: int
    L: int
    caps: Tuple[int, ...]
    smem: int
    workspace: bool = False
    spans: bool = False


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def padded_dim(D: int) -> int:
    """The compiled width a head width ``D`` (a multiple of 8) runs at: the
    least of :data:`HEAD_DIMS` that holds it.  Raises past the widest."""
    for DP in HEAD_DIMS:
        if D <= DP:
            return DP
    raise ValueError(f"bgpp_paged_attend: head_dim D={D} is over the widest compiled "
                     f"width {HEAD_DIMS[-1]}")


def long_dim(D: int) -> int:
    """The compiled width the spanning body runs a head width ``D`` at: 128
    up to 128, else 256 (its only two; the true D goes in at run time)."""
    return 128 if D <= 128 else 256


def header_bytes(D: int) -> int:
    """The source's ``Header<DP>``: the query's int8 codes ``(8, max(DP,
    128))``, its bit masks ``(8, 8, max(4, DP / 32))`` words and 136 words
    of statistics and plan: 2592 bytes up to DP 128, 4640 at DP 256."""
    DP = padded_dim(D)
    return 8 * max(DP, 128) + 8 * 8 * max(4, DP // 32) * 4 + 544


def entry_ints(g: int) -> int:
    """Ints of a list entry: the lane and ``g`` partial scores, padded to
    whole 16-byte words."""
    return -(-(1 + g) // 4) * 4


def smem_bytes(g: int, D: int, L: int, workspace: bool = False) -> int:
    """Dynamic shared memory of one block owning ``L`` round-0 lanes: the
    header, ``max(THREADS, pow2(L))`` 8-byte sort keys and ``STAGE`` staged
    ones, two lists of ``L`` entries of :func:`entry_ints` ints (not with
    ``workspace``: they lie in global memory) and the warps' ``(g, DP)``
    int PV partials at the compiled width."""
    lists = 0 if workspace else 2 * 4 * entry_ints(g) * L
    return (header_bytes(D) + 8 * (max(THREADS, _pow2(L)) + STAGE)
            + lists + 4 * WARPS * g * padded_dim(D))


def cluster_lanes(g: int, D: int) -> int:
    """The most lanes one cluster takes at group ``g`` and head dim ``D``:
    ``MAX_CLUSTER`` blocks, each with the most lanes the block sort takes
    (``MAX_LIST``) and, beside its lists in the workspace, shared memory
    takes: 32768 at every g <= 8 and D <= 256."""
    L = MAX_LIST
    while L > 0 and smem_bytes(g, D, L, workspace=True) > build.MAX_SMEM:
        L -= 1
    return MAX_CLUSTER * L


def max_lanes(g: int, D: int) -> int:
    """The most lanes a slot may have at group ``g`` and head dim ``D``:
    past :func:`cluster_lanes` the selection spans blocks, up to
    ``LONG_MAX_LANES`` (524,288) at every g <= 8 and D <= 256."""
    return max(cluster_lanes(g, D), LONG_MAX_LANES)


def workspace_ints(B: int, Hk: int, g: int, p: Plan) -> int:
    """Ints of the global workspace a launch of plan ``p`` needs, or 0 when
    the lists fit in shared memory.  Single cluster: two lists of ``L``
    entries for each of its ``B * Hk * C`` blocks (64 MiB at llama4-scout's
    B 4, Hk 8, g 5 over 32768 lanes).  Spanning blocks, per cell over the
    ``W = C * L`` padded lanes and ``K = caps[-1] * L`` padded survivors
    (``Ws`` in the source): two key buffers (8 B a lane), two lists (lane
    and ``g`` partials), the PV sums (``(g, 256)`` int64), the tile
    histograms (256 a tile), 32 pass flags, three statistics a final tile
    and ``g`` row, and the survivors' pool rows, v_scales and ``g``
    logits: 64 + 8 g B a lane, 35.4 MiB a cell at S 524,288, g 5."""
    if not p.workspace:
        return 0
    if not p.spans:
        return B * Hk * p.C * 2 * p.L * entry_ints(g)
    W, F = p.C * p.L, p.caps[-1]
    K = F * p.L
    return B * Hk * (W * (6 + 2 * g) + 2 * g * HEAD_DIMS[-1] + p.C * 256 + 32
                     + F * 3 * g + K * (2 + g))


def list_widths(S: int, k_max: int, survivors: Tuple[int, ...]) -> Tuple[int, ...]:
    """Width of the list of each round: ``S`` lanes at round 0, then
    ``survivors[r]``, and ``k_max`` final survivors."""
    return (S,) + tuple(survivors[1:]) + (k_max,)


@functools.lru_cache(maxsize=None)
def plan(B: int, Hk: int, g: int, D: int, S: int, k_max: int,
         survivors: Tuple[int, ...], sms: int) -> Plan:
    """Cluster size and each block's share of every list, for one shape.

    ``C`` starts as the largest power of two (at most ``MAX_CLUSTER``, and
    at most one lane a block) whose ``B * Hk * C`` blocks still fit one
    block an SM, so the cells fill the card in one wave (decode geometry
    B 4, Hk 8 on 132 SMs: C 4, 128 blocks); it is then doubled until one
    block's lanes fit the sort and shared memory.  Where at ``MAX_CLUSTER``
    they fit the sort but their lists do not fit shared memory, the lists
    go to the workspace (``workspace``: S 32768 at g >= 4, or at g 3 and
    D 256).  ``D`` is the true head width; shared memory is that of its
    compiled width.  Past :func:`cluster_lanes` the selection spans blocks
    (``spans``): ``ceil(S / LONG_TILE)`` tiles a cell (128 at S 524,288).
    Raises past :func:`max_lanes`, with the cap."""
    if S > cluster_lanes(g, D):
        if S > LONG_MAX_LANES:
            raise ValueError(
                f"bgpp_paged_attend: S={S} lanes are past the spanning body's reach; "
                f"the cap at g={g}, D={D} is {max_lanes(g, D)} lanes (the reference's "
                f"long_500k context)")
        tiles = tuple(-(-w // LONG_TILE) for w in list_widths(S, k_max, survivors))
        return Plan(tiles[0], LONG_TILE, tiles, 0, workspace=True, spans=True)
    C = 1
    while C < MAX_CLUSTER and 2 * C <= S and B * Hk * 2 * C <= sms:
        C *= 2
    while True:
        L = -(-S // C)
        smem = smem_bytes(g, D, L)
        caps = tuple(-(-w // C) for w in list_widths(S, k_max, survivors))
        if L <= MAX_LIST and smem <= build.MAX_SMEM:
            return Plan(C, L, caps, smem)
        if C == MAX_CLUSTER and L <= MAX_LIST:
            ws_smem = smem_bytes(g, D, L, workspace=True)
            if ws_smem <= build.MAX_SMEM:
                return Plan(C, L, caps, ws_smem, workspace=True)
        C *= 2


def wide_rows(k_planes: torch.Tensor, k_sign: torch.Tensor, v: torch.Tensor,
              DP: int = 0) -> int:
    """The kernel's load widths at compiled width ``DP`` (default the
    single-cluster body's, :func:`padded_dim`): bit 0 when every packed
    plane and sign row is ``DP / 8`` bytes on a boundary of that many (16
    at most; D is then DP), bit 1 when every V row starts on an 8-byte
    boundary.  Rows without them load byte by byte."""
    D = 8 * k_planes.shape[-1]
    DP = DP or padded_dim(D)
    a = min(16, DP // 8)
    planes = D == DP and all(
        t.data_ptr() % a == 0 and all(s % a == 0 for s in t.stride()[:-1])
        for t in (k_planes, k_sign))
    rows = v.data_ptr() % 8 == 0 and all(s % 8 == 0 for s in v.stride()[:2])
    return int(planes) | 2 * int(rows)


def launch(q, k_planes, k_sign, k_scale, v, v_scale, phys, pos, out,
           out_idx, ws, *, k_max: int, survivors: Tuple[int, ...], query_bits: int,
           geometry: Plan) -> None:
    """Enqueue one launch on the current stream; raise if it was refused.
    ``ws`` is the plan's workspace (:func:`workspace_ints` int32), or None."""
    lib = build.load()
    B, Hk, g, D = q.shape
    S = phys.shape[1]
    C, _, caps, smem, _, spans = geometry
    widths = list_widths(S, k_max, survivors)
    # host arrays, alive past the call
    w_arr = (ctypes.c_int * len(widths))(*widths)
    c_arr = (ctypes.c_int * len(caps))(*caps)
    operands = (q.data_ptr(), k_planes.data_ptr(), k_sign.data_ptr(), k_scale.data_ptr(),
                v.data_ptr(), v_scale.data_ptr(), phys.data_ptr(), pos.data_ptr(),
                out.data_ptr(), None if out_idx is None else out_idx.data_ptr())
    DP = long_dim(D) if spans else padded_dim(D)
    shape = (B, Hk, g, D, DP, S, k_planes.shape[0], len(survivors), w_arr)
    strides = (k_planes.stride(0), k_planes.stride(1), k_planes.stride(2), v.stride(0),
               v.stride(1), k_scale.stride(0), k_scale.stride(1))
    tail = (wide_rows(k_planes, k_sign, v, DP), D ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if spans:
        err = lib.bgpp_paged_attend_long_launch(*operands, ws.data_ptr(), ws.numel(), *shape,
                                                query_bits, *strides, *tail)
    else:
        err = lib.bgpp_paged_attend_launch(*operands, None if ws is None else ws.data_ptr(),
                                           *shape, c_arr, C, smem, query_bits, *strides, *tail)
    build.check(err, "bgpp_paged_attend")
