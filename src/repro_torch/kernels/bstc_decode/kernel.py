"""Launch the CUDA BSTC plane decode (``src/repro_torch/csrc/bstc_decode.cu``)
through ``ctypes``.  Callers pass validated CUDA tensors; :mod:`.ops` is
the public wrapper.  Grid: one 256-thread block per (8 group rows, H tile).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def launch(bitmap, tile_offsets, patterns, out, H: int) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    G, cap = patterns.shape
    tile_k = H // tile_offsets.shape[1]
    stream = torch.cuda.current_stream(bitmap.device).cuda_stream
    err = lib.bstc_decode_launch(bitmap.data_ptr(), tile_offsets.data_ptr(),
                                 patterns.data_ptr(), out.data_ptr(), G, H, tile_k, cap,
                                 stream)
    build.check(err, "bstc_decode")
