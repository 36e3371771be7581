"""Operand prep and public wrapper for the fused BSTC decode + matmul.

Counterpart of :mod:`repro.kernels.bstc_matmul.ops`.  Routing is by the
tensors' device: CPU tensors take the plain version in :mod:`.ref`; CUDA
tensors launch the CUDA kernel or the call raises — there is no fallback.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import bstc
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.bstc_decode.ops import bstc_decode_patterns, plane_operands
from repro_torch.kernels.bstc_matmul import kernel
from repro_torch.kernels.bstc_matmul.ref import bstc_matmul_plain, reconstruct_dense_ref
from repro_torch.kernels.paged_flash_decode.kernel import sm_count

MAX_KERNEL_COLS = kernel.MAX_COL_BLOCKS * 8  # grid.z blocks of up to 8 columns of x


@dataclasses.dataclass(eq=False)
class BSTCMatmulOperands:
    """Per-plane coded arrays of one (M, H) int8 weight; each coded plane
    keeps its own pattern capacity.  ``enc`` is a flat tuple
    ``[bitmap_p, offsets_p, patterns_p]*`` over ``enc_planes``."""

    enc: Tuple[torch.Tensor, ...]
    raw: Tuple[torch.Tensor, ...]  # (M, H//8) uint8 per raw plane
    sign_bits: torch.Tensor  # (M, H//8) uint8
    scale: Optional[torch.Tensor]  # (M,) f32 or None
    enc_planes: Tuple[int, ...]
    raw_planes: Tuple[int, ...]
    m: int
    M: int
    H: int
    # rows of the whole matrix a mesh rank's column shard was cut from (0:
    # this matrix is whole): the launch plans at it, so the H split, and
    # with it each row's order of sums, is the whole matrix's
    plan_rows: int = 0
    # the kernel's plane table, built once at the first CUDA launch
    _desc: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        """Checked once, where the operands are built: the coding grid, the
        plane lists and one device for every array."""
        if self.M % self.m or self.H % 8:
            raise ValueError(f"bstc_matmul: M={self.M} must be a multiple of m={self.m} and "
                             f"H={self.H} of 8")
        if len(self.enc) != 3 * len(self.enc_planes) or len(self.raw) != len(self.raw_planes):
            raise ValueError("bstc_matmul: operand lists do not match the plane lists")
        tensors = [*self.enc, *self.raw, self.sign_bits]
        if len({t.device for t in tensors + ([] if self.scale is None else [self.scale])}) != 1:
            raise ValueError("bstc_matmul: operands lie on different devices")

    @property
    def tile_k(self) -> int:
        """Columns per H tile (the offsets' granularity); H without coded planes."""
        return self.H // self.enc[1].shape[1] if self.enc_planes else self.H

    @property
    def hbm_bytes(self) -> int:
        """Bytes of the coded representation at ``m`` bits a pattern (the
        reference's measure)."""
        b = self.sign_bits.numel() + sum(r.numel() for r in self.raw)
        for e in range(len(self.enc_planes)):
            bitmap, _, patterns = self.enc[3 * e:3 * e + 3]
            b += bitmap.numel() + int(math.ceil(patterns.numel() * self.m / 8))
        return int(b)

    @property
    def stored_bytes(self) -> int:
        """Bytes the arrays occupy (a byte a pattern, offsets, scale): what
        the kernel reads."""
        b = sum(t.numel() * t.element_size() for t in (*self.enc, *self.raw, self.sign_bits))
        return int(b + (0 if self.scale is None else self.scale.numel() * 4))

    @property
    def dense_bytes(self) -> int:
        return self.M * self.H  # int8 weight


def operands_from_encoded(bw: bstc.BSTCWeight, tile_k: int,
                          scale: Optional[torch.Tensor] = None,
                          plan_rows: int = 0) -> BSTCMatmulOperands:
    """An encoded weight -> kernel operands with ``tile_k``-column tiles
    (``plan_rows``: see :class:`BSTCMatmulOperands`)."""
    M, H = bw.shape
    if H % tile_k:
        raise ValueError(f"H={H} is not a multiple of tile_k={tile_k}")
    enc_planes = tuple(p for p in range(bw.nbits) if bw.encoded[p] is not None)
    raw_planes = tuple(p for p in range(bw.nbits) if bw.encoded[p] is None)
    enc = []
    for p in enc_planes:
        enc += plane_operands(bw.encoded[p], tile_k)
    return BSTCMatmulOperands(
        enc=tuple(enc), raw=tuple(bw.raw_planes[p] for p in raw_planes),
        sign_bits=bw.sign, scale=None if scale is None else scale.to(torch.float32),
        enc_planes=enc_planes, raw_planes=raw_planes, m=bw.m, M=M, H=H, plan_rows=plan_rows)


def prepare_bstc_matmul_operands(
    w_q: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    m: int = 4,
    nbits: int = 7,
    tile_k: int = 512,
    threshold: float = bstc.DEFAULT_SPARSITY_THRESHOLD,
) -> BSTCMatmulOperands:
    """int8 (M, H) weight -> BSTC-coded kernel operands, on its device."""
    bw = bstc.encode_weight(
        w_q, torch.zeros(w_q.shape[0]) if scale is None else scale,
        m=m, nbits=nbits, threshold=threshold)
    return operands_from_encoded(bw, tile_k, None if scale is None else bw.scale)


def reconstruct_dense_weight(ops: BSTCMatmulOperands) -> torch.Tensor:
    """Losslessly rebuild the int32 (M, H) weight from the operands, each
    coded plane through :func:`bstc_decode_patterns` (the decode kernel on
    CUDA tensors, its plain version on CPU ones)."""
    return reconstruct_dense_ref(ops, decode=bstc_decode_patterns)


def _validate(ops: BSTCMatmulOperands, x: torch.Tensor) -> None:
    """x against the operands (the operands themselves were checked when
    they were built)."""
    if x.ndim != 2 or x.shape[0] != ops.H:
        raise ValueError(f"bstc_matmul: x must be (H={ops.H}, N), got {tuple(x.shape)}")
    if x.device != ops.sign_bits.device:
        raise ValueError(f"bstc_matmul: x lies on {x.device}, the operands on "
                         f"{ops.sign_bits.device}")


def _validate_cuda(ops: BSTCMatmulOperands, x: torch.Tensor) -> Optional[kernel.Plan]:
    """What the CUDA kernel additionally requires, and its launch plan: of
    x at every call, of the operands once, at their first launch (which
    caches the plane table).  The plan refuses a group m other than 4, more
    than 7 magnitude planes and a tile_k that does not cut H into whole
    bytes."""
    if x.dtype not in kernel.X_DTYPES:
        raise ValueError(f"bstc_matmul: x must be float32 or bfloat16, got {x.dtype}")
    if x.shape[1] > MAX_KERNEL_COLS:
        raise ValueError(f"bstc_matmul: N={x.shape[1]} columns exceed the grid")
    geo = None  # nothing to launch for an empty output
    if ops.M and x.shape[1]:
        geo = kernel.plan(ops.plan_rows or ops.M, ops.H, x.shape[1], ops.tile_k, ops.m,
                          sm_count(x.device),
                          len(ops.enc_planes), len(ops.raw_planes), kernel.x_vectorizable(x))
    if ops._desc is not None:
        return geo
    if max(ops.enc_planes + ops.raw_planes, default=0) > kernel.MAX_SHIFT:
        raise ValueError(f"bstc_matmul: magnitude planes above {kernel.MAX_SHIFT} "
                         f"(|w| > 127) do not pack in the kernel's bytes")
    hb = ops.H // 8
    G = ops.M // ops.m
    tile_k = ops.tile_k
    for i in range(len(ops.enc_planes)):
        bitmap, offsets, patterns = ops.enc[3 * i:3 * i + 3]
        if tuple(bitmap.shape) != (G, hb) or tuple(offsets.shape) != (G, ops.H // tile_k) \
                or patterns.ndim != 2 or patterns.shape[0] != G or patterns.shape[1] < 1:
            raise ValueError(f"bstc_matmul: coded plane {ops.enc_planes[i]} has shapes "
                             f"{tuple(bitmap.shape)}/{tuple(offsets.shape)}/"
                             f"{tuple(patterns.shape)}, want ({G}, {hb}) / "
                             f"({G}, {ops.H // tile_k}) / ({G}, cap)")
        for t, dt in ((bitmap, torch.uint8), (offsets, torch.int32), (patterns, torch.uint8)):
            if t.dtype != dt or not t.is_contiguous():
                raise ValueError(f"bstc_matmul: coded plane arrays must be contiguous {dt}")
    for t in (*ops.raw, ops.sign_bits):
        if tuple(t.shape) != (ops.M, hb) or t.dtype != torch.uint8 or not t.is_contiguous():
            raise ValueError(f"bstc_matmul: raw and sign planes must be contiguous uint8 "
                             f"({ops.M}, {hb}), got {tuple(t.shape)} {t.dtype}")
    if any(t.data_ptr() % 16 for t in (*ops.enc, *ops.raw, ops.sign_bits)):
        raise ValueError("bstc_matmul: the plane arrays must start 16-byte aligned")
    if ops.scale is not None and (tuple(ops.scale.shape) != (ops.M,)
                                  or ops.scale.dtype != torch.float32
                                  or not ops.scale.is_contiguous()):
        raise ValueError(f"bstc_matmul: scale must be contiguous float32 ({ops.M},)")
    ops._desc = kernel.descriptor(ops)
    return geo


def bstc_matmul(ops: BSTCMatmulOperands, x: torch.Tensor, *,
                apply_scale: bool = False) -> torch.Tensor:
    """``w_q @ x`` (times the per-row scale with ``apply_scale``) from the
    coded weight: x (H, N) f32/bf16 -> f32 (M, N).

    The kernel reads x at any strides.  Its output follows x's layout: for
    x = ``a.T`` of row-major ``(N, H)`` activations, the result is the
    transpose of a row-major ``(N, M)`` tensor, so ``bstc_matmul(ops,
    a.T).T`` is contiguous and neither side is copied."""
    _validate(ops, x)
    if x.device.type == "cpu":
        return bstc_matmul_plain(ops, x, apply_scale)
    if x.device.type != "cuda":
        raise ValueError(f"bstc_matmul: no kernel for device {x.device}")
    geo = _validate_cuda(ops, x)
    N = x.shape[1]
    if x.stride(0) == 1:
        out = torch.empty((N, ops.M), dtype=torch.float32, device=x.device).T
    else:
        out = torch.empty((ops.M, N), dtype=torch.float32, device=x.device)
    if geo is not None:
        kernel.launch(ops._desc, ops, x, ops.scale if apply_scale else None, out, geo)
        LAUNCHES["bstc_matmul"] += 1
    return out
