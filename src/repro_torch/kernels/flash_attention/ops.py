"""Public wrapper of the flash-attention kernel and its backward, in the
model layout.

Counterpart of :mod:`repro.kernels.flash_attention.ops`.  Routing is by the
tensors' device: CPU tensors take the plain versions in :mod:`.ref`; CUDA
tensors launch the CUDA kernels or the call raises — there is no fallback.
The launch geometry comes from :func:`.kernel.plan` (query rows a block,
threads and shared memory from the dtype and shape; key tiles of 64), so
the reference's ``tile_q`` / ``tile_k`` arguments have no counterpart.  q/k/v
are read at their strides and the output is written in ``(B, Sq, Hq, D)``
directly: no transpose copies on either side.

Gradient.  The reference's Pallas kernel has no VJP (it trains through its
jnp scan); the port's forward launches this kernel, so it carries its own:
when gradient mode is on and q, k or v requires a gradient,
:func:`flash_attention` runs as a ``torch.autograd.Function`` whose forward
also asks the kernel for each row's log-sum-exp and saves q, k, v, out and
it, and whose backward is :func:`flash_attention_bwd` (the
``flash_attention_bwd.cu`` kernel on CUDA tensors, its plain version on CPU
ones).  Otherwise the call is the plain forward launch, the same bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

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


def _mask_args(q, mask_kind, window, scale):
    """Sliding, chunked and prefix_causal with ``window <= 0`` are causal,
    as ``make_mask`` has it; the scale defaults to ``D ** -0.5``."""
    if mask_kind in ("sliding", "chunked", "prefix_causal") and window <= 0:
        mask_kind, window = "causal", 0
    return mask_kind, window, q.shape[-1] ** -0.5 if scale is None else float(scale)


def _forward(q, k, v, mask_kind, window, q_offset, scale, want_lse):
    """One forward on validated operands -> ``out`` or ``(out, lse)``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, mask_kind=mask_kind, window=window,
                                   q_offset=q_offset, scale=scale, return_lse=want_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    geometry = _validate_cuda(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = None
    if want_lse:
        B, Sq, Hq, _ = q.shape
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    kernel.launch(q, k, v, out, geometry, mask_kind, window, q_offset, scale, lse=lse)
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if want_lse else out


class _FlashAttention(torch.autograd.Function):
    """The forward with its log-sum-exp saved; the backward through
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, mask_kind, window, q_offset, scale):
        out, lse = _forward(q, k, v, mask_kind, window, q_offset, scale, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (mask_kind, window, q_offset, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, *ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hk, D)
    v: torch.Tensor,  # (B, Sk, Hk, D)
    *,
    mask_kind: str = "causal",
    window: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
):
    """Masked GQA attention with an f32 online softmax -> ``(B, Sq, Hq, D)``
    in ``q.dtype``.

    Query row ``i`` sits at position ``i + q_offset``; key ``j`` at ``j``.
    ``mask_kind`` is causal, sliding (window ``window``), chunked (chunk
    ``window``), prefix_causal (the VLM's: full attention inside the first
    ``window`` positions, causal after) or full; sliding, chunked and
    prefix_causal with ``window <= 0`` are causal, as ``make_mask`` has
    it.  Differentiable in q, k and v (see the module docstring); a query
    row that sees no key is outside the gradient's contract."""
    _validate(q, k, v, mask_kind, q_offset)
    mask_kind, window, scale = _mask_args(q, mask_kind, window, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, mask_kind, window, q_offset, scale)
    return _forward(q, k, v, mask_kind, window, q_offset, scale, want_lse=False)


def flash_attention_bwd(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hk, D)
    v: torch.Tensor,  # (B, Sk, Hk, D)
    o: torch.Tensor,  # (B, Sq, Hq, D) the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq) f32 the forward's row log-sum-exp
    dout: torch.Tensor,  # (B, Sq, Hq, D)
    mask_kind: str = "causal",
    window: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
):
    """The gradient of :func:`flash_attention` -> ``(dq, dk, dv)`` in the
    operands' dtype, accumulated in f32: the ``flash_attention_bwd`` kernel
    on CUDA tensors (three launches on the stream, counted as one), its
    plain version on CPU ones."""
    _validate(q, k, v, mask_kind, q_offset)
    mask_kind, window, scale = _mask_args(q, mask_kind, window, scale)
    if o.shape != q.shape or dout.shape != q.shape or lse.shape != (q.shape[0], q.shape[2],
                                                                      q.shape[1]):
        raise ValueError(
            f"flash_attention_bwd: want o and dout {tuple(q.shape)} and lse "
            f"{(q.shape[0], q.shape[2], q.shape[1])}; got {tuple(o.shape)} / "
            f"{tuple(dout.shape)} / {tuple(lse.shape)}")
    dout = dout.to(q.dtype)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, dout, mask_kind=mask_kind,
                                       window=window, q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    _validate_cuda(q, k, v)
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    if o.stride(3) != 1:
        raise ValueError("flash_attention_bwd: o must be contiguous along D")
    lse = lse.float().contiguous()
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    geometry = kernel.bwd_plan(q.dtype, B, Sq, Sk, Hq, Hk, D)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    kernel.launch_bwd(q, k, v, o, dout, lse, delta, dq, dk, dv, geometry, mask_kind, window,
                      q_offset, scale)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
