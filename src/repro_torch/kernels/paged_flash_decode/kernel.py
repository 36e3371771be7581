"""Launch the CUDA paged flash decode kernels
(``src/repro_torch/csrc/paged_flash_decode.cu``) through ``ctypes``.

Two ``__global__`` bodies: the dense one (bf16 or f32 K/V) and the int8
A2/A3 one.  Callers pass validated CUDA tensors; :mod:`.ops` is the public
wrapper.  Grid: one 128-thread block per (slot, kv-head).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

_KV_DTYPE = {torch.bfloat16: 0, torch.float32: 1}


def smem_bytes(g: int, D: int, pages_per_slot: int, page_size: int) -> int:
    """Dynamic shared memory one block needs (the kernel's own formula)."""
    return int(build.load().paged_flash_decode_smem_bytes(g, D, pages_per_slot, page_size))


def launch(q, k, v, page_ids, pos, out, page_size: int,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    B, Hk, g, D = q.shape
    pp = page_ids.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tok_stride, head_stride = k.stride(0), k.stride(1)
    scale = D ** -0.5
    if k_scale is None:
        err = lib.paged_flash_decode_dense_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), page_ids.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, Hk, g, D, pp, page_size,
            tok_stride, head_stride, _KV_DTYPE[k.dtype], scale, stream,
        )
        build.check(err, "paged_flash_decode (dense)")
    else:
        err = lib.paged_flash_decode_int8_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), page_ids.data_ptr(), pos.data_ptr(),
            out.data_ptr(), B, Hk, g, D, pp, page_size, tok_stride, head_stride,
            k_scale.stride(0), k_scale.stride(1), scale, stream,
        )
        build.check(err, "paged_flash_decode (int8)")
