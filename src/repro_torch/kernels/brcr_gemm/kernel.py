"""Launch the CUDA BRCR GEMM (``src/repro_torch/csrc/brcr_gemm.cu``)
through ``ctypes``.

Grid: one block per (32 group rows, up to 8 columns of x); the block loops
over every signed plane and every 256-column tile of H itself, so it owns
its output tile and no sum crosses blocks.  x is read at its element
strides; out is a contiguous (M, N) float32 tensor.  Callers pass
validated CUDA tensors; :mod:`.ops` is the public wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch(ops, x, out) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    P, G, H = ops.group_idx.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.brcr_gemm_launch(
        ops.group_idx.data_ptr(), ops.plane_weights.data_ptr(), x.data_ptr(),
        X_DTYPES[x.dtype], *x.stride(), out.data_ptr(), *out.stride(),
        P, G, H, x.shape[1], ops.m, stream)
    build.check(err, "brcr_gemm")
