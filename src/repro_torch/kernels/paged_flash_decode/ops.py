"""Public wrapper for the paged flash decode family.

Counterpart of :mod:`repro.kernels.paged_flash_decode.ops`.  Routing is by
the tensors' device: CPU tensors take the plain version in :mod:`.ref`;
CUDA tensors launch the CUDA kernel or the call raises — there is no
fallback.  Shape, dtype, stride and context-length mistakes raise here,
at the call boundary.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.paged_flash_decode import kernel
from repro_torch.kernels.paged_flash_decode.ref import paged_flash_decode_ref


def _validate(q, k, v, page_ids, pos, page_size, k_scale, v_scale):
    if q.ndim != 4:
        raise ValueError(
            f"paged_flash_decode: q must be grouped (B, Hk, g, D), got shape "
            f"{tuple(q.shape)} — reshape (B, Hq, D) queries with "
            f"g = num_heads // num_kv_heads first"
        )
    B, Hk, g, D = q.shape
    if k.ndim != 3 or k.shape != v.shape or k.stride() != v.stride():
        raise ValueError(
            f"paged_flash_decode: pools must be token-major (n_tok, Hk, D) "
            f"with equal strides; got k {tuple(k.shape)}/{k.stride()} vs "
            f"v {tuple(v.shape)}/{v.stride()}"
        )
    n_tok = k.shape[0]
    if k.shape[1:] != (Hk, D):
        raise ValueError(
            f"paged_flash_decode: pool heads/head_dim {tuple(k.shape[1:])} do "
            f"not match q's (Hk={Hk}, D={D})"
        )
    if page_size < 1 or n_tok % page_size:
        raise ValueError(
            f"paged_flash_decode: pool of {n_tok} token rows is not a whole "
            f"number of pages of page_size={page_size}"
        )
    if page_ids.ndim != 2 or page_ids.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError(
            f"paged_flash_decode: page_ids must be (B={B}, pages_per_slot) and "
            f"pos (B,); got {tuple(page_ids.shape)} / {tuple(pos.shape)}"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError(
            "paged_flash_decode: int8 pools need BOTH k_scale and v_scale "
            "(n_tok, Hk) — got exactly one"
        )
    if k_scale is not None and (tuple(k_scale.shape) != (n_tok, Hk)
                                or k_scale.shape != v_scale.shape
                                or k_scale.stride() != v_scale.stride()):
        raise ValueError(
            f"paged_flash_decode: scales must both be (n_tok={n_tok}, Hk={Hk}) "
            f"with equal strides; got {tuple(k_scale.shape)} / "
            f"{tuple(v_scale.shape)}"
        )
    tensors = [q, k, v, page_ids, pos] + ([k_scale, v_scale] if k_scale is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_flash_decode: operands lie on different devices")


def _validate_cuda(q, k, v, page_ids, pos, page_size, k_scale, v_scale,
                   whole=None) -> kernel.Plan:
    """What the CUDA kernel additionally requires of its operands; returns
    the launch's :func:`kernel.plan`.  Every D up to 256 runs (at its
    compiled width, :func:`kernel.padded_dim`), every page size >= 1, and
    pool rows at any alignment (16-byte loads where they allow), past one
    block's shared memory in passes; the refusals are g > 8, D > 256 and
    the context cap (:func:`kernel.max_lanes`: lanes below 2^31, int8
    1,065,088 at page 16, where a block's int32 PV sums would overflow)."""
    B, Hk, g, D = q.shape
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError("paged_flash_decode: q must be contiguous float32")
    if g > 8:
        raise ValueError(f"paged_flash_decode: GQA group g={g} > 8 is not supported")
    want = (torch.bfloat16, torch.float32) if k_scale is None else (torch.int8,)
    if k.dtype not in want or v.dtype != k.dtype:
        raise ValueError(
            f"paged_flash_decode: pools must be {want}; got {k.dtype}/{v.dtype}"
        )
    if k.stride(2) != 1:
        raise ValueError("paged_flash_decode: pool rows must be contiguous in D")
    kernel.padded_dim(D)  # raises past the widest compiled width
    if k_scale is not None and k_scale.dtype != torch.float32:
        raise ValueError("paged_flash_decode: scales must be float32")
    for name, t in (("page_ids", page_ids), ("pos", pos)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"paged_flash_decode: {name} must be contiguous int32")
    Bp, Hkp = (B, Hk) if whole is None else whole
    return kernel.plan(Bp, Hkp, g, D, page_ids.shape[1], page_size,
                       kernel.sm_count(q.device), int8=k_scale is not None)


def paged_flash_decode(
    q: torch.Tensor,  # (B, Hk, g, D) f32 grouped decode query
    k: torch.Tensor,  # (n_tok, Hk, D) token-major pool (any token/head strides)
    v: torch.Tensor,  # (n_tok, Hk, D)
    page_ids: torch.Tensor,  # (B, pages_per_slot) int32, -1 = unmapped
    pos: torch.Tensor,  # (B,) int32 last valid logical position per slot
    *,
    page_size: int,
    k_scale: Optional[torch.Tensor] = None,  # (n_tok, Hk) f32
    v_scale: Optional[torch.Tensor] = None,
    whole: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Page-table-aware single-token decode attend -> f32 ``(B, Hk, g, D)``.

    bf16/f32 pools run the dense attend; passing ``k_scale``/``v_scale``
    selects the int8 A2/A3 body.  The page ids must address rows inside
    the pool (the kernel trusts them, as the reference's gather does).

    ``whole`` is ``(B, Hk)`` of the unsharded launch a mesh rank's slice
    belongs to: the plan takes its cluster split from it, so each (slot,
    kv-head) cell merges its softmax over the same blocks as in the whole
    launch and the rank's output is that slice of it bit for bit.  None:
    the launch's own shape."""
    _validate(q, k, v, page_ids, pos, page_size, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, k, v, page_ids, pos, page_size=page_size,
                                      k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: no kernel for device {q.device}")
    geometry = _validate_cuda(q, k, v, page_ids, pos, page_size, k_scale, v_scale, whole)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    kernel.launch(q, k, v, page_ids, pos, out, page_size, geometry, k_scale, v_scale)
    LAUNCHES["paged_flash_decode_bf16" if k_scale is None else "paged_flash_decode_int8"] += 1
    return out
