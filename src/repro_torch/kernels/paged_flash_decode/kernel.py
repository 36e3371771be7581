"""Launch the CUDA paged flash decode kernels
(``src/repro_torch/csrc/paged_flash_decode.cu``) through ``ctypes``.

Two ``__global__`` bodies: the dense one (bf16 or f32 K/V) and the int8
A2/A3 one.  Callers pass validated CUDA tensors; :mod:`.ops` is the public
wrapper.  Grid: one thread-block cluster of ``C`` 256-thread blocks per
(slot, kv-head) cell; :func:`plan` chooses ``C`` and each block's lanes
from static shapes, once per shape.
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


class Plan(NamedTuple):
    """One launch's geometry: ``C`` blocks a (slot, kv-head) cluster, each
    owning ``L`` lanes (whole pages) and ``smem`` bytes of shared memory."""

    C: int
    L: int
    smem: int


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


def max_lanes(g: int, D: int, page_size: int) -> int:
    """The most lanes a slot may have: ``MAX_CLUSTER`` blocks, each with as
    many whole pages as its shared memory holds."""
    pages = ((build.MAX_SMEM // 4 - HEADER - WARPS * g * padded_dim(D))
             // (g * page_size + 1))
    return MAX_CLUSTER * max(0, pages) * page_size


@functools.lru_cache(maxsize=None)
def plan(B: int, Hk: int, g: int, D: int, pages_per_slot: int, page_size: int,
         sms: int) -> Plan:
    """Cluster size and lanes per block for one shape.

    ``C`` starts as the largest power of two (at most ``MAX_CLUSTER``, and
    at most one page a block) whose ``B * Hk * C`` blocks still fit one
    block an SM, so the cells fill the card in one wave (decode geometry
    B 4, Hk 8 on 132 SMs: C 4, 128 blocks); it is then doubled until one
    block's lanes fit in shared memory.  Block ``c`` owns the lanes
    ``[c * L, (c + 1) * L)``, whole pages of any size.  ``D`` is the true
    head width; shared memory is that of its compiled width.  Raises when
    no ``C`` fits, with the cap."""
    C = 1
    while C < MAX_CLUSTER and 2 * C <= pages_per_slot and B * Hk * 2 * C <= sms:
        C *= 2
    while True:
        L = -(-pages_per_slot // C) * page_size
        smem = smem_bytes(g, D, L, page_size)
        if smem <= build.MAX_SMEM:
            return Plan(C, L, smem)
        if C == MAX_CLUSTER or 2 * C > pages_per_slot:
            raise ValueError(
                f"paged_flash_decode: S={pages_per_slot * page_size} lanes need "
                f"{smem} B of shared memory in each of {C} blocks, over the "
                f"block's {build.MAX_SMEM}; the cap at g={g}, D={D}, "
                f"page_size={page_size} is {max_lanes(g, D, page_size)} lanes"
            )
        C *= 2


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
    C, L, smem = geometry
    magic, shift = page_divider(page_size)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tok_stride, head_stride = k.stride(0), k.stride(1)
    scale = D ** -0.5
    shape = (B, Hk, g, D, padded_dim(D), pp, page_size, magic, shift, C, L, smem)
    wide = int(wide_rows(k, v))
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
