"""Launch the CUDA fused BGPP decode kernel
(``src/repro_torch/csrc/bgpp_paged_attend.cu``) through ``ctypes``.

Callers pass validated CUDA tensors; :mod:`.ops` is the public wrapper.
Grid: one 256-thread block per (slot, kv-head).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build



def smem_bytes(g: int, D: int, S: int, k_max: int) -> int:
    """Dynamic shared memory one block needs (the kernel's own formula)."""
    return int(build.load().bgpp_paged_attend_smem_bytes(g, D, S, k_max))


def launch(q, k_planes, k_sign, k_scale, v, v_scale, phys, pos, out,
           out_idx: Optional[torch.Tensor], *, k_max: int,
           survivors: Tuple[int, ...], query_bits: int) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    B, Hk, g, D = q.shape
    S = phys.shape[1]
    surv = (ctypes.c_int * len(survivors))(*survivors)  # lives past the call
    err = lib.bgpp_paged_attend_launch(
        q.data_ptr(), k_planes.data_ptr(), k_sign.data_ptr(), k_scale.data_ptr(),
        v.data_ptr(), v_scale.data_ptr(), phys.data_ptr(), pos.data_ptr(),
        out.data_ptr(), None if out_idx is None else out_idx.data_ptr(),
        B, Hk, g, D, S, k_planes.shape[0], len(survivors), surv, k_max,
        query_bits, k_planes.stride(0), k_planes.stride(1), k_planes.stride(2),
        v.stride(0), v.stride(1), k_scale.stride(0), k_scale.stride(1),
        D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "bgpp_paged_attend")
