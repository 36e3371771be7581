"""Launch the CUDA flash-attention kernel
(``src/repro_torch/csrc/flash_attention.cu``) through ``ctypes``.

Grid: one 128-thread block per (64-row query tile, batch x query head).
The kernel reads q/k/v through their batch, sequence and head strides
(unit stride along D) and writes a contiguous ``(B, Sq, Hq, D)`` out.
Callers pass validated CUDA tensors; :mod:`.ops` is the public wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MASK_CODES = {"full": 0, "causal": 1, "sliding": 2, "chunked": 3}


def launch(q, k, v, out, mask_kind: str, window: int, q_offset: int, scale: float) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, Hq, Hk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        _DTYPE[q.dtype], MASK_CODES[mask_kind], int(window), int(q_offset), float(scale),
        stream,
    )
    build.check(err, "flash_attention")
