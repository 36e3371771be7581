"""Operand prep and public wrapper of the BRCR GEMM.

Counterpart of :mod:`repro.kernels.brcr_gemm.ops`.  Routing is by the
tensors' device: CPU tensors take the plain version in :mod:`.ref`; CUDA
tensors launch the CUDA kernel or the call raises — there is no fallback.
The launch geometry comes from :func:`.kernel.plan` (column blocks and the
cluster that splits H, from the shape and the card's SM count); the kernel
skips all-zero pattern steps itself (no host-side tile map) and masks
ragged edges, so the reference's tile arguments and its N padding have no
counterpart: M need only be a multiple of m, and N, H may be any size.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bitslice
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.brcr_gemm import kernel
from repro_torch.kernels.brcr_gemm.ref import brcr_gemm_ref
from repro_torch.kernels.paged_flash_decode.kernel import sm_count


class BRCROperands(NamedTuple):
    """Prepared kernel operands of one int8 weight (M, H).

    group_idx:     (P, M//m, H) uint8 — signed-plane column patterns
                   (P = 2*nbits: positive planes LSB→MSB, then negative).
    plane_weights: (P,) f32 = [+1, +2, ..., +2^(k-1), -1, ..., -2^(k-1)].
    """

    group_idx: torch.Tensor
    plane_weights: torch.Tensor
    m: int
    nbits: int
    M: int
    H: int


def prepare_brcr_operands(w_q: torch.Tensor, m: int = 4,
                          nbits: int = bitslice.WEIGHT_MAG_BITS) -> BRCROperands:
    """int8 (M, H) weight -> signed bit-plane group patterns, in one
    vectorised pass on the weight's device.

    Bit-exact with the reference's numpy loop: pattern bit ``j`` of group
    ``g`` in plane ``p`` is bit ``p`` of row ``g*m + j`` of the positive
    (then the negative) part.  Computed in uint8, which holds every value
    on the way (parts <= 128, patterns < 2**m <= 256)."""
    M, H = w_q.shape
    if M % m:
        raise ValueError(f"M={M} not divisible by group size m={m}")
    if not 1 <= m <= 8:
        raise ValueError(f"group size m={m} must be 1..8 (patterns are bytes)")
    dev = w_q.device
    parts = torch.stack(bitslice.signed_plane_split(w_q)).to(torch.uint8)  # (2, M, H)
    parts = parts.reshape(2, 1, M // m, m, H)
    shifts = torch.arange(nbits, dtype=torch.uint8, device=dev).reshape(1, nbits, 1, 1, 1)
    rows = torch.arange(m, dtype=torch.uint8, device=dev).reshape(1, 1, 1, m, 1)
    bits = ((parts >> shifts) & 1) << rows  # (2, nbits, G, m, H)
    idx = bits.sum(3, dtype=torch.uint8).reshape(2 * nbits, M // m, H)
    pw = 2.0 ** torch.arange(nbits, dtype=torch.float32, device=dev)
    return BRCROperands(group_idx=idx, plane_weights=torch.cat([pw, -pw]), m=m,
                        nbits=nbits, M=M, H=H)


def tile_nonzero_map(group_idx: torch.Tensor, m: int, tile_m: int,
                     tile_k: int) -> torch.Tensor:
    """(P, M//TM, H//TK) int32: 1 where the tile has any non-zero pattern
    (the reference's host-side map; the CUDA kernel tests its tiles itself)."""
    P, G, H = group_idx.shape
    tg = tile_m // m
    t = group_idx.reshape(P, G // tg, tg, H // tile_k, tile_k)
    return (t.amax(dim=(2, 4)) != 0).to(torch.int32)


def _validate(ops: BRCROperands, x: torch.Tensor) -> None:
    P, G, H = ops.group_idx.shape
    if x.ndim != 2 or x.shape[0] != ops.H:
        raise ValueError(f"brcr_gemm: x must be (H={ops.H}, N), got {tuple(x.shape)}")
    if (H, G * ops.m, P) != (ops.H, ops.M, ops.plane_weights.shape[0]):
        raise ValueError(f"brcr_gemm: group_idx {tuple(ops.group_idx.shape)} and "
                         f"{P} plane weights do not describe an ({ops.M}, {ops.H}) weight")
    if len({x.device, ops.group_idx.device, ops.plane_weights.device}) != 1:
        raise ValueError("brcr_gemm: x and the operands lie on different devices")


def _validate_cuda(ops: BRCROperands, x: torch.Tensor) -> kernel.Plan:
    """What the CUDA kernel additionally requires of its operands; returns
    the launch's :func:`kernel.plan`.  The plane weights are the format's
    signed powers of two, which the kernel folds into its bf16 one-hot
    operand (a weight bf16 does not hold turns the output into NaN)."""
    if x.dtype not in kernel.X_DTYPES:
        raise ValueError(f"brcr_gemm: x must be float32 or bfloat16, got {x.dtype}")
    if ops.group_idx.dtype != torch.uint8 or not ops.group_idx.is_contiguous() \
            or ops.plane_weights.dtype != torch.float32 \
            or not ops.plane_weights.is_contiguous():
        raise ValueError("brcr_gemm: group_idx must be contiguous uint8 and plane_weights "
                         "contiguous float32")
    P, _, H = ops.group_idx.shape
    ptr = ops.group_idx.data_ptr()
    return kernel.plan(ops.M, H, x.shape[1], ops.m, P, sm_count(x.device),
                       kernel.TERMS[x.dtype], min(16, ptr & -ptr) if ptr else 16)


def brcr_gemm(ops: BRCROperands, x: torch.Tensor) -> torch.Tensor:
    """``w_q @ x`` from prepared BRCR operands: x (H, N) -> f32 (M, N).

    On the card x is float32 or bfloat16, read at its strides."""
    _validate(ops, x)
    if x.device.type == "cpu":
        return brcr_gemm_ref(ops.group_idx, ops.plane_weights, x, ops.m)
    if x.device.type != "cuda":
        raise ValueError(f"brcr_gemm: no kernel for device {x.device}")
    shape = (ops.M, x.shape[1])
    if not (ops.M and x.shape[1] and ops.H and ops.plane_weights.shape[0]):
        return torch.zeros(shape, dtype=torch.float32, device=x.device)  # no launch
    geometry = _validate_cuda(ops, x)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    kernel.launch(ops, x, out, geometry)
    LAUNCHES["brcr_gemm"] += 1
    return out
