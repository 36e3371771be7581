"""Attention primitives: the whole-sequence forward's and the paper layer's.

Counterpart of :mod:`repro.core.attention`: the mask builders (causal,
sliding-window, chunked-local, full and the VLM prefix-causal mask), the
materialised GQA ``attend``, ``blocked_attend`` (the forward's attention)
and the paper layer's decode attends: ``decode_attend`` over a (possibly
BGPP-sparsified) cache and ``gather_attend``, the formal-compute stage on
a static-size gathered key set.  The serving engine has its own attends.

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
    """The (s_q, s_k) mask of ``kind``; sliding / chunked / prefix_causal
    with window <= 0 are causal.  The reference's ``make_mask`` has no
    prefix_causal (its ``blocked_attend`` builds that mask itself); here
    it serves the flash kernel's plain version."""
    if kind == "causal" or (kind in ("sliding", "chunked", "prefix_causal") and window <= 0):
        return causal_mask(s_q, s_k, offset, device)
    if kind == "sliding":
        return sliding_window_mask(s_q, s_k, window, offset, device)
    if kind == "chunked":
        return chunked_mask(s_q, s_k, window, offset, device)
    if kind == "prefix_causal":
        return prefix_causal_mask(s_q, s_k, window, offset, device)
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
    ones, for every mask kind: causal, sliding, chunked, full and the VLM's
    prefix_causal (``window`` the prefix length)."""
    return _flash.flash_attention(q, k, v, mask_kind=mask_kind, window=window,
                                  q_offset=q_offset, scale=scale)


def decode_attend(
    q: torch.Tensor,  # (B, Hq, D) single-step query
    k_cache: torch.Tensor,  # (B, S, Hk, D)
    v_cache: torch.Tensor,  # (B, S, Hk, D)
    valid: torch.Tensor,  # (B, S) bool — filled cache slots (∧ predicted set)
    scale: Optional[float] = None,
    head_mask: Optional[torch.Tensor] = None,  # (B, Hk, S), e.g. BGPP alive sets
) -> torch.Tensor:
    """One-token decode attention over a (possibly sparsified) KV cache.

    The reference's ``logit_softcap`` is not ported: no path passes it."""
    out = attend(q[:, None], k_cache, v_cache, mask=_decode_mask(valid, head_mask, q.shape[1]),
                 scale=scale)
    return out[:, 0]


def _decode_mask(valid: torch.Tensor, head_mask: Optional[torch.Tensor],
                 hq: int) -> torch.Tensor:
    """The decode step's mask: ``(B, 1, S)`` from ``valid`` alone, else
    ``(B, Hq, 1, S)`` with each query head taking its kv head's set.

    Without a head mask the reference returns ``(B, 1, 1, S)``, which its
    ``attend`` reshapes as a per-head mask and refuses for Hq > 1; the
    ``(B, Sq=1, S)`` form here broadcasts over every head instead."""
    if head_mask is None:
        return valid[:, None, :]
    group = hq // head_mask.shape[1]
    m = (head_mask & valid[:, None, :]).repeat_interleave(group, dim=1)  # (B, Hq, S)
    return m[:, :, None, :]


def gather_attend(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, S, Hk, D)
    v_cache: torch.Tensor,  # (B, S, Hk, D)
    idx: torch.Tensor,  # (B, Hk, kmax) predicted key indices
    idx_valid: torch.Tensor,  # (B, Hk, kmax)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Formal-compute stage on a static-size gathered key set (paper Fig. 3):
    only ``kmax`` K/V rows per kv head are touched."""
    B, Hq, D = q.shape
    Hk = k_cache.shape[2]
    scale = (D ** -0.5) if scale is None else scale
    bidx = torch.arange(B, device=q.device)[:, None, None]
    hidx = torch.arange(Hk, device=q.device)[None, :, None]
    kg = k_cache[bidx, idx, hidx]  # (B, Hk, kmax, D)
    vg = v_cache[bidx, idx, hidx]
    qg = q.reshape(B, Hk, Hq // Hk, D).float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, kg.float()) * scale
    logits = torch.where(idx_valid[:, :, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, vg.float())
    return out.reshape(B, Hq, D).to(q.dtype)
