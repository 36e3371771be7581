"""Public wrapper of the flash-attention kernel, in the model layout.

Counterpart of :mod:`repro.kernels.flash_attention.ops`.  Routing is by the
tensors' device: CPU tensors take the plain version in :mod:`.ref`; CUDA
tensors launch the CUDA kernel or the call raises — there is no fallback.
The launch geometry comes from :func:`.kernel.plan` (query rows a block,
threads and shared memory from the dtype and shape; key tiles of 64), so
the reference's ``tile_q`` / ``tile_k`` arguments have no counterpart.  q/k/v
are read at their strides and the output is written in ``(B, Sq, Hq, D)``
directly: no transpose copies on either side.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = kernel.HEAD_DIMS  # the kernel's compiled head widths
DTYPES = (torch.float32, torch.bfloat16)


def _validate(q, k, v, mask_kind, q_offset):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: want q (B, Sq, Hq, D) and k, v (B, Sk, Hk, D); got "
            f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Sq < 1 or k.shape[1] < 1:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            f"(same B and D, at least one query and one key)")
    if Hq % k.shape[2]:
        raise ValueError(
            f"flash_attention: Hq={Hq} query heads are not a multiple of "
            f"Hk={k.shape[2]} kv heads (GQA needs an integral group)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q/k/v must share one dtype of {DTYPES}; got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if mask_kind not in kernel.MASK_CODES:
        raise ValueError(
            f"flash_attention: mask_kind {mask_kind!r} is not one of "
            f"{tuple(kernel.MASK_CODES)}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} must be >= 0")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: operands lie on different devices")


def _validate_cuda(q, k, v) -> kernel.Plan:
    """What the CUDA kernel additionally requires of its operands; returns
    the launch's :func:`kernel.plan`.  Every head width up to 256 runs, at
    its compiled width (:func:`kernel.padded_dim`; the plain version takes
    any), and rows at any alignment (the bf16 body stages unaligned rows
    element by element, :func:`kernel.wide_rows`)."""
    kernel.padded_dim(q.shape[3])  # raises past the widest compiled width
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous along D")
    return kernel.plan(q.dtype, *q.shape)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hk, D)
    v: torch.Tensor,  # (B, Sk, Hk, D)
    *,
    mask_kind: str = "causal",
    window: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked GQA attention with an f32 online softmax -> ``(B, Sq, Hq, D)``
    in ``q.dtype``.

    Query row ``i`` sits at position ``i + q_offset``; key ``j`` at ``j``.
    ``mask_kind`` is causal, sliding (window ``window``), chunked (chunk
    ``window``), prefix_causal (the VLM's: full attention inside the first
    ``window`` positions, causal after) or full; sliding, chunked and
    prefix_causal with ``window <= 0`` are causal, as ``make_mask`` has
    it."""
    _validate(q, k, v, mask_kind, q_offset)
    if mask_kind in ("sliding", "chunked", "prefix_causal") and window <= 0:
        mask_kind, window = "causal", 0
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, mask_kind=mask_kind, window=window,
                                   q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    geometry = _validate_cuda(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernel.launch(q, k, v, out, geometry, mask_kind, window, q_offset, scale)
    LAUNCHES["flash_attention"] += 1
    return out
