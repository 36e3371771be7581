"""Attention primitives of the whole-sequence forward.

Counterpart of :mod:`repro.core.attention`, cut to what the dense forward
runs: the mask builders (causal, sliding-window, chunked-local, full and
the VLM prefix-causal mask), the materialised GQA ``attend`` and
``blocked_attend``, the forward's attention.  The engine has its own
decode attends, so ``decode_attend`` / ``gather_attend`` are not ported.

Softmaxes run in float32 whatever the input dtype; outputs come back in
``q.dtype``.

``blocked_attend`` routes to :mod:`repro_torch.kernels.flash_attention`:
CPU tensors take its plain version (mask + ``attend``), CUDA tensors
launch the hand-written kernel.  The reference's ``blocked_attend`` is an
online-softmax scan in jnp that never launches its Pallas kernel; the
port's launches its kernel on the card (same function, other summation
order).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as _flash

NEG_INF = -1e30  # avoids NaN from (-inf) - (-inf) in fully masked rows


def _grid(s_q: int, s_k: int, offset: int, device):
    qi = torch.arange(s_q, device=device)[:, None] + offset
    kj = torch.arange(s_k, device=device)[None, :]
    return qi, kj


def causal_mask(s_q: int, s_k: int, offset: int = 0, device=None) -> torch.Tensor:
    """(s_q, s_k) bool; query i attends keys j <= i + offset."""
    qi, kj = _grid(s_q, s_k, offset, device)
    return kj <= qi


def sliding_window_mask(s_q: int, s_k: int, window: int, offset: int = 0,
                        device=None) -> torch.Tensor:
    """Causal and (i + offset - j < window)."""
    qi, kj = _grid(s_q, s_k, offset, device)
    return (kj <= qi) & (qi - kj < window)


def chunked_mask(s_q: int, s_k: int, chunk: int, offset: int = 0,
                 device=None) -> torch.Tensor:
    """Causal within aligned chunks of ``chunk`` positions."""
    qi, kj = _grid(s_q, s_k, offset, device)
    return (kj <= qi) & (qi // chunk == kj // chunk)


def prefix_causal_mask(s_q: int, s_k: int, prefix: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    """VLM mask: full attention within the (image) prefix, causal after."""
    qi, kj = _grid(s_q, s_k, offset, device)
    return (kj <= qi) | ((qi < prefix) & (kj < prefix))


def make_mask(kind: str, s_q: int, s_k: int, window: int = 0, offset: int = 0,
              device=None) -> torch.Tensor:
    """The (s_q, s_k) mask of ``kind``; sliding/chunked with window <= 0
    are causal."""
    if kind == "causal" or (kind in ("sliding", "chunked") and window <= 0):
        return causal_mask(s_q, s_k, offset, device)
    if kind == "sliding":
        return sliding_window_mask(s_q, s_k, window, offset, device)
    if kind == "chunked":
        return chunked_mask(s_q, s_k, window, offset, device)
    if kind == "full":
        return torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    raise ValueError(f"unknown mask kind {kind!r}")


def attend(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hk, D)
    v: torch.Tensor,  # (B, Sk, Hk, D)
    mask: Optional[torch.Tensor] = None,  # broadcastable to (B, Hq, Sq, Sk)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA dot-product attention with an f32 softmax -> ``(B, Sq, Hq, D)``
    in ``q.dtype``."""
    B, Sq, Hq, D = q.shape
    Hk = k.shape[2]
    group = Hq // Hk
    scale = (D ** -0.5) if scale is None else scale
    qg = q.reshape(B, Sq, Hk, group, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[None, None, None]
        elif mask.ndim == 3:  # (B, Sq, Sk)
            mask = mask[:, None, None]
        elif mask.ndim == 4:  # (B, Hq, Sq, Sk) -> (B, Hk, group, Sq, Sk)
            mask = mask.reshape(B, Hk, group, Sq, -1)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def blocked_attend(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hk, D)
    v: torch.Tensor,  # (B, Sk, Hk, D)
    *,
    mask_kind: str = "causal",
    window: int = 0,  # window / chunk size / prefix length; 0 = causal
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The forward's attention -> ``(B, Sq, Hq, D)`` in ``q.dtype``: the
    ``flash_attention`` kernel on CUDA tensors, its plain version on CPU
    ones.  ``prefix_causal`` (the VLM family) has no kernel yet: it takes
    the plain path on the CPU and raises on the card."""
    if mask_kind == "prefix_causal":
        if q.device.type != "cpu":
            raise NotImplementedError(
                "blocked_attend: prefix_causal has no kernel; the VLM family "
                "is a later slice of the port")
        mask = prefix_causal_mask(q.shape[1], k.shape[1], window, q_offset, q.device)
        return attend(q, k, v, mask=mask, scale=scale)
    return _flash.flash_attention(q, k, v, mask_kind=mask_kind, window=window,
                                  q_offset=q_offset, scale=scale)
