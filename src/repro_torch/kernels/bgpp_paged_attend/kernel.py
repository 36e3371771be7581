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
DP)`` PV partials at the compiled width.  The context cap
(:func:`max_lanes`) is ``MAX_CLUSTER * L`` for the largest ``L`` that fits
both that and the block sort's ``MAX_SLOTS`` keys a thread: S 32768 at g
<= 3 and D 128, and at g <= 2 and D 256.
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


class Plan(NamedTuple):
    """One launch's geometry: ``C`` blocks a (slot, kv-head) cluster, ``L``
    round-0 lanes a block, ``caps[r]`` ranks a block owns in the list of
    round ``r`` (``r = rounds``: the final ``k_max`` survivors) and
    ``smem`` bytes of shared memory a block."""

    C: int
    L: int
    caps: Tuple[int, ...]
    smem: int


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


def smem_bytes(g: int, D: int, L: int) -> int:
    """Dynamic shared memory of one block owning ``L`` round-0 lanes: the
    header, ``max(THREADS, pow2(L))`` 8-byte sort keys and ``STAGE`` staged
    ones, two lists of ``L`` entries of :func:`entry_ints` ints and the
    warps' ``(g, DP)`` int PV partials at the compiled width."""
    return (header_bytes(D) + 8 * (max(THREADS, _pow2(L)) + STAGE)
            + 2 * 4 * entry_ints(g) * L + 4 * WARPS * g * padded_dim(D))


def max_lanes(g: int, D: int) -> int:
    """The most lanes a slot may have at group ``g`` and head dim ``D``:
    ``MAX_CLUSTER`` blocks, each with the most lanes that both the block
    sort (``MAX_LIST``) and shared memory take."""
    L = MAX_LIST
    while L > 0 and smem_bytes(g, D, L) > build.MAX_SMEM:
        L -= 1
    return MAX_CLUSTER * L


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
    block's lanes fit the sort and shared memory.  ``D`` is the true head
    width; shared memory is that of its compiled width.  Raises when no
    ``C`` fits, with the cap."""
    C = 1
    while C < MAX_CLUSTER and 2 * C <= S and B * Hk * 2 * C <= sms:
        C *= 2
    while True:
        L = -(-S // C)
        smem = smem_bytes(g, D, L)
        if L <= MAX_LIST and smem <= build.MAX_SMEM:
            caps = tuple(-(-w // C) for w in list_widths(S, k_max, survivors))
            return Plan(C, L, caps, smem)
        if C == MAX_CLUSTER:
            raise ValueError(
                f"bgpp_paged_attend: S={S} lanes need {L} lanes and {smem} B of "
                f"shared memory in each of {C} blocks, over the block sort's "
                f"{MAX_LIST} or the block's {build.MAX_SMEM} B; the cap at g={g}, "
                f"D={D} is {max_lanes(g, D)} lanes"
            )
        C *= 2


def wide_rows(k_planes: torch.Tensor, k_sign: torch.Tensor, v: torch.Tensor) -> int:
    """The kernel's load widths: bit 0 when every packed plane and sign
    row is the compiled width's ``DP / 8`` bytes on a boundary of that
    many (16 at most; D is then a compiled width), bit 1 when every V row
    starts on an 8-byte boundary.  Rows without them load byte by byte."""
    D = 8 * k_planes.shape[-1]
    a = min(16, padded_dim(D) // 8)
    planes = D == padded_dim(D) and all(
        t.data_ptr() % a == 0 and all(s % a == 0 for s in t.stride()[:-1])
        for t in (k_planes, k_sign))
    rows = v.data_ptr() % 8 == 0 and all(s % 8 == 0 for s in v.stride()[:2])
    return int(planes) | 2 * int(rows)


def launch(q, k_planes, k_sign, k_scale, v, v_scale, phys, pos, out,
           out_idx, *, k_max: int, survivors: Tuple[int, ...], query_bits: int,
           geometry: Plan) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    B, Hk, g, D = q.shape
    S = phys.shape[1]
    C, _, caps, smem = geometry
    widths = list_widths(S, k_max, survivors)
    # host arrays, alive past the call
    w_arr = (ctypes.c_int * len(widths))(*widths)
    c_arr = (ctypes.c_int * len(caps))(*caps)
    err = lib.bgpp_paged_attend_launch(
        q.data_ptr(), k_planes.data_ptr(), k_sign.data_ptr(), k_scale.data_ptr(),
        v.data_ptr(), v_scale.data_ptr(), phys.data_ptr(), pos.data_ptr(),
        out.data_ptr(), None if out_idx is None else out_idx.data_ptr(),
        B, Hk, g, D, padded_dim(D), S, k_planes.shape[0], len(survivors), w_arr, c_arr, C,
        smem, query_bits, k_planes.stride(0), k_planes.stride(1), k_planes.stride(2),
        v.stride(0), v.stride(1), k_scale.stride(0), k_scale.stride(1),
        wide_rows(k_planes, k_sign, v), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "bgpp_paged_attend")
