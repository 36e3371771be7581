"""Fused BSTC decode + matmul from two-state-coded int8 weight planes."""

from repro_torch.kernels.bstc_matmul.ops import (  # noqa: F401
    BSTCMatmulOperands,
    bstc_matmul,
    prepare_bstc_matmul_operands,
    reconstruct_dense_weight,
)
