"""Launch the CUDA fused BSTC decode + matmul
(``src/repro_torch/csrc/bstc_matmul.cu``) through ``ctypes``.

Callers pass validated CUDA tensors; :mod:`.ops` is the public wrapper.
x and out go by their element strides, so transposed views need no copy.
Grid: one 128-thread block per (4 group rows, up to 8 columns of x).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def descriptor(ops) -> ctypes.Array:
    """The plane table the C entry point reads: ``[n_enc, n_raw, (bitmap,
    offsets, patterns, cap, p) per coded plane, (plane, p) per raw plane]``."""
    desc = [len(ops.enc_planes), len(ops.raw_planes)]
    for i, p in enumerate(ops.enc_planes):
        bitmap, offsets, patterns = ops.enc[3 * i:3 * i + 3]
        desc += [bitmap.data_ptr(), offsets.data_ptr(), patterns.data_ptr(),
                 patterns.shape[1], p]
    for raw, p in zip(ops.raw, ops.raw_planes):
        desc += [raw.data_ptr(), p]
    return (ctypes.c_longlong * len(desc))(*desc)


def launch(desc, ops, x, scale, out) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    H, N = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.bstc_matmul_launch(
        desc, ops.sign_bits.data_ptr(), x.data_ptr(), X_DTYPES[x.dtype], *x.stride(),
        None if scale is None else scale.data_ptr(), out.data_ptr(), *out.stride(),
        ops.M, H, N, ops.tile_k, stream)
    build.check(err, "bstc_matmul")
