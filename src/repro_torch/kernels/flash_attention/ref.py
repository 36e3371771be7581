"""Plain PyTorch version of the flash-attention kernel and of its backward:
the materialised softmax attention and its materialised gradient.

Counterpart of :mod:`repro.kernels.flash_attention.ref`: the mask of
``mask_kind`` built whole, then :func:`repro_torch.core.attention.attend`
(f32 logits and softmax, output in ``q.dtype``); with ``return_lse`` also
each row's ``torch.logsumexp`` of the scaled logits, masked entries at
``NEG_INF``.  :func:`flash_attention_bwd_ref` is the backward's: P
recomputed from the log-sum-exp, the group of query heads summed into each
kv head's dk and dv.  The CPU path of ``flash_attention`` and of its
gradient, and the oracles the CUDA kernels are held against on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import attention


def _logits(q, k, mask, scale):
    """The scaled, masked f32 logits ``(B, Hk, g, Sq, Sk)``."""
    B, Sq, Hq, D = q.shape
    Hk = k.shape[2]
    qg = q.reshape(B, Sq, Hk, Hq // Hk, D).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    return torch.where(mask, logits, attention.NEG_INF)


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hk, D)
    v: torch.Tensor,  # (B, Sk, Hk, D)
    mask_kind: str = "causal",
    window: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Masked GQA attention -> ``(B, Sq, Hq, D)`` in ``q.dtype``; with
    ``return_lse`` also the ``(B, Hq, Sq)`` f32 row log-sum-exp."""
    mask = attention.make_mask(mask_kind, q.shape[1], k.shape[1], window, q_offset,
                               q.device)
    out = attention.attend(q, k, v, mask=mask, scale=scale)
    if not return_lse:
        return out
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    B, Sq, Hq, _ = q.shape
    lse = torch.logsumexp(_logits(q, k, mask, scale), dim=-1)  # (B, Hk, g, Sq)
    return out, lse.reshape(B, Hq, Sq)


def flash_attention_bwd_ref(
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
    """The gradient of :func:`flash_attention_ref` -> ``(dq, dk, dv)`` in
    the operands' dtype, all in f32 from the materialised ``P = exp(s -
    lse)`` (0 on masked pairs) and ``delta = rowsum(dout * o)``: ``dv =
    P^T dout``, ``dS = P (dout v^T - delta)``, ``dq = scale dS k``, ``dk =
    scale dS^T q``, dk and dv summed over each kv head's group."""
    B, Sq, Hq, D = q.shape
    Hk = k.shape[2]
    g = Hq // Hk
    scale = D ** -0.5 if scale is None else scale
    mask = attention.make_mask(mask_kind, Sq, k.shape[1], window, q_offset, q.device)
    s = _logits(q, k, mask, scale)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, Hk, g, Sq, 1)), 0.0)
    dog = dout.reshape(B, Sq, Hk, g, D).float()
    qg = q.reshape(B, Sq, Hk, g, D).float()
    delta = (dout.float() * o.float()).sum(-1).reshape(B, Sq, Hk, g).permute(0, 2, 3, 1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
