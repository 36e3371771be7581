"""BRCR GEMM: ``w_q @ x`` through the bit-slice repetitiveness factorization."""

from repro_torch.kernels.brcr_gemm.ops import (
    BRCROperands,
    brcr_gemm,
    prepare_brcr_operands,
    tile_nonzero_map,
)

__all__ = ["BRCROperands", "brcr_gemm", "prepare_brcr_operands", "tile_nonzero_map"]
