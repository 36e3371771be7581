"""Launch the CUDA paged flash decode kernels
(``src/repro_torch/csrc/paged_flash_decode.cu``) through ``ctypes``.

Two ``__global__`` bodies: the dense one (bf16 or f32 K/V) and the int8
A2/A3 one; and their pass versions (``csrc/paged_flash_decode_long.cu``)
for slots longer than one block's shared memory holds at ``MAX_CLUSTER``
blocks, where a block walks its lanes in passes.  Callers pass validated
CUDA tensors; :mod:`.ops` is the public wrapper.  Grid: one thread-block
cluster of ``C`` 256-thread blocks per (slot, kv-head) cell; :func:`plan`
chooses ``C``, each block's lanes and the passes from static shapes, once
per shape.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

_KV_DTYPE = {torch.bfloat16: 0, torch.float32: 1}

THREADS = 256  # kThreads in the source
WARPS = THREADS // 32
HEADER = 128  # kHeader: the shared-memory header, in floats
MAX_CLUSTER = 8  # the portable cluster size
HEAD_DIMS = (16, 32, 64, 128, 256)  # the source's compiled widths DP

_SMS: Dict[int, int] = {}


# an int8 block's PV sums stay in int32: its lanes times 127 * 127 below 2^31
INT8_BLOCK_LANES = (2 ** 31 - 1) // (127 * 127)


class Plan(NamedTuple):
    """One launch's geometry: ``C`` blocks a (slot, kv-head) cluster, each
    owning ``L`` lanes (whole pages) and ``smem`` bytes of shared memory;
    with ``pass_lanes`` > 0 the pass bodies run, each block walking its
    lanes in ``passes`` passes of ``pass_lanes`` lanes (whole pages)."""

    C: int
    L: int
    smem: int
    passes: int = 1
    pass_lanes: int = 0


def padded_dim(D: int) -> int:
    """The compiled width a head width ``D`` runs at: the least of
    :data:`HEAD_DIMS` that holds it (the kernel reads q, K and V past ``D``
    as zero and drops the output past it).  Raises past the widest."""
    for DP in HEAD_DIMS:
        if D <= DP:
            return DP
    raise ValueError(f"paged_flash_decode: head_dim D={D} is over the widest compiled "
                     f"width {HEAD_DIMS[-1]}")


def page_divider(page_size: int) -> Tuple[int, int]:
    """``(magic, shift)`` with ``s // page_size == (umulhi(s, magic) + s)
    >> shift`` for every ``0 <= s < 2**31`` (the source's ``PageDiv``):
    ``shift = ceil(log2(P))`` and ``magic = 2^32 (2^shift - P) // P + 1``
    (Granlund and Montgomery's round-up method; a power of two gives
    ``magic`` 1, a plain shift)."""
    if page_size < 1:
        raise ValueError(f"paged_flash_decode: page_size={page_size} must be >= 1")
    shift = (page_size - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - page_size)) // page_size + 1, shift


def smem_bytes(g: int, D: int, lanes: int, page_size: int) -> int:
    """Dynamic shared memory of one block owning ``lanes`` lanes: the
    header, the warps' ``(g, DP)`` PV partials at the compiled width, the
    ``(g, lanes)`` scores and the block's page bases, 4 bytes each (the
    source's carve-up)."""
    return 4 * (HEADER + WARPS * g * padded_dim(D) + g * lanes + lanes // page_size)


def pass_pages(g: int, D: int, page_size: int) -> int:
    """Whole pages whose ``(g, lanes)`` scores and page bases one block's
    shared memory holds beside the header and the PV partials."""
    return max(0, (build.MAX_SMEM // 4 - HEADER - WARPS * g * padded_dim(D))
               // (g * page_size + 1))


def single_pass_lanes(g: int, D: int, page_size: int) -> int:
    """The most lanes the single-pass bodies take: ``MAX_CLUSTER`` blocks,
    each with as many whole pages as its shared memory holds (83,456 at
    g 5, D 128, page 16; 208,896 at g 2, D 256)."""
    return MAX_CLUSTER * pass_pages(g, D, page_size) * page_size


def max_lanes(g: int, D: int, page_size: int, int8: bool = False) -> int:
    """The most lanes a slot may have, passes included: lane indices stay
    below 2^31 (whole pages), and an int8 block's lanes below
    :data:`INT8_BLOCK_LANES` (``MAX_CLUSTER`` blocks: 1,065,088 at page
    16).  0 where one page does not fit a block's shared memory."""
    if pass_pages(g, D, page_size) == 0:
        return 0
    if int8:
        return MAX_CLUSTER * (INT8_BLOCK_LANES // page_size) * page_size
    return (2 ** 31 - 1) // page_size * page_size


@functools.lru_cache(maxsize=None)
def plan(B: int, Hk: int, g: int, D: int, pages_per_slot: int, page_size: int,
         sms: int, int8: bool = False) -> Plan:
    """Cluster size and lanes per block for one shape.

    ``C`` starts as the largest power of two (at most ``MAX_CLUSTER``, and
    at most one page a block) whose ``B * Hk * C`` blocks still fit one
    block an SM, so the cells fill the card in one wave (decode geometry
    B 4, Hk 8 on 132 SMs: C 4, 128 blocks); it is then doubled until one
    block's lanes fit in shared memory.  Block ``c`` owns the lanes
    ``[c * L, (c + 1) * L)``, whole pages of any size.  ``D`` is the true
    head width; shared memory is that of its compiled width.

    Where no ``C`` fits the single-pass bodies (past
    :func:`single_pass_lanes`), or where an ``int8`` slot's PV sums could
    pass int32 over the cluster (``S * 127^2 >= 2^31``), the pass bodies
    run at the largest ``C``: a block's lanes in the fewest passes of whole
    pages that shared memory holds, split evenly (gemma3-4b's g 2, D 256 at
    524,288 lanes, page 16: C 8, 65,536 lanes a block in 3 passes of
    21,856).  Raises past :func:`max_lanes`, with the cap."""
    C = 1
    while C < MAX_CLUSTER and 2 * C <= pages_per_slot and B * Hk * 2 * C <= sms:
        C *= 2
    S = pages_per_slot * page_size
    wide_sum = int8 and S * 127 * 127 >= 2 ** 31  # one int32 sum over the cluster overflows
    while True:
        L = -(-pages_per_slot // C) * page_size
        smem = smem_bytes(g, D, L, page_size)
        if smem <= build.MAX_SMEM and not wide_sum:
            return Plan(C, L, smem)
        if C == MAX_CLUSTER or 2 * C > pages_per_slot:
            break
        C *= 2
    cap = max_lanes(g, D, page_size, int8)
    if S > cap or (int8 and L > INT8_BLOCK_LANES):
        raise ValueError(
            f"paged_flash_decode: S={S} lanes are over the cap at g={g}, D={D}, "
            f"page_size={page_size}{', int8' if int8 else ''}: {cap} lanes"
        )
    block_pages = L // page_size
    passes = -(-block_pages // pass_pages(g, D, page_size))
    PL = -(-block_pages // passes) * page_size
    return Plan(C, L, smem_bytes(g, D, PL, page_size), passes, PL)


def sm_count(device: torch.device) -> int:
    """The device's SM count, read once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def wide_rows(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether every pool row of ``k`` and ``v`` starts on a 16-byte
    boundary (base pointers and token / head strides): the kernel then
    loads whole 16-byte chunks, else element by element."""
    return all(t.data_ptr() % 16 == 0 and all((s * t.element_size()) % 16 == 0
                                              for s in t.stride()[:2]) for t in (k, v))


def launch(q, k, v, page_ids, pos, out, page_size: int, geometry: Plan,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    B, Hk, g, D = q.shape
    pp = page_ids.shape[1]
    C, L, smem, _, PL = geometry
    magic, shift = page_divider(page_size)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tok_stride, head_stride = k.stride(0), k.stride(1)
    scale = D ** -0.5
    wide = int(wide_rows(k, v))
    if PL:  # the pass bodies
        body = 2 if k_scale is not None else _KV_DTYPE[k.dtype]
        sc_strides = (k_scale.stride(0), k_scale.stride(1)) if k_scale is not None else (0, 0)
        err = lib.paged_flash_decode_pass_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(), page_ids.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, Hk, g, D, padded_dim(D), pp, page_size,
            magic, shift, C, L, PL, smem, tok_stride, head_stride, *sc_strides, wide, body,
            scale, stream,
        )
        build.check(err, "paged_flash_decode (passes)")
        return
    shape = (B, Hk, g, D, padded_dim(D), pp, page_size, magic, shift, C, L, smem)
    if k_scale is None:
        err = lib.paged_flash_decode_dense_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), page_ids.data_ptr(),
            pos.data_ptr(), out.data_ptr(), *shape, tok_stride, head_stride, wide,
            _KV_DTYPE[k.dtype], scale, stream,
        )
        build.check(err, "paged_flash_decode (dense)")
    else:
        err = lib.paged_flash_decode_int8_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), page_ids.data_ptr(), pos.data_ptr(),
            out.data_ptr(), *shape, tok_stride, head_stride, k_scale.stride(0),
            k_scale.stride(1), wide, scale, stream,
        )
        build.check(err, "paged_flash_decode (int8)")
