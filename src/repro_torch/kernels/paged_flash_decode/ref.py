"""Plain PyTorch version of the page-table-aware flash decode kernel.

Counterpart of :mod:`repro.kernels.paged_flash_decode.ref`.  It operates
on the raw paged operands — token-major pools ``(n_tok, Hk, ...)`` (any
strides) plus a ``(B, pages_per_slot)`` page table — and reproduces the
engine's decode attend op for op over the gathered heads-major view.

``dense_attend`` / ``int8_attend`` are the engine's attend arithmetic on
heads-major operands with a query axis ``Q``; the serving engine's
``_cache_attend`` and the BGPP plain version reuse them, so one copy of the
A2/A3 sequence exists in the port.

Integer dot products run as float32 matmuls of the integer values: exact
while ``D * 127**2 < 2**24`` (D = 128 gives 2.06 M), and what the
reference's int32 / f32 accumulations give.  CPU ``int8 @ int8`` would
return int8 and wrap, and CUDA has no integer matmul.  TF32 must be off
(the package sets ``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # repro.core.attention.NEG_INF


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` expansion over the last axis: max-shift, exp,
    divide by the sum."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def quantize_rows(x: torch.Tensor):
    """Per-row absmax/127 int8 codes of a float32 tensor -> ``(codes as
    float32, scale (..., 1))``; ``round`` is half to even, like ``jnp.round``."""
    scale = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127), scale


def _cell_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (B, Hk, g, Q, X) x b (B, Hk, X, Y) -> (B, Hk, g, Q, Y)``, each
    (slot, kv-head) cell's product on its own on the CPU: a batched GEMM
    there sums a cell in an order that moves with the number of cells
    beside it, so a mesh rank's slots or heads would not give the bits of
    the whole batch.  On the card one batched product."""
    if a.device.type != "cpu" or a.shape[0] * a.shape[1] == 0:
        return torch.einsum("bhgqx,bhxy->bhgqy", a, b)
    B, H, g, Q, X = a.shape
    cells = [a[i, j].reshape(g * Q, X) @ b[i, j] for i in range(B) for j in range(H)]
    return torch.stack(cells).reshape(B, H, g, Q, b.shape[-1])


def dense_attend(qg, k, v, mask) -> torch.Tensor:
    """bf16/f32 attend: qg ``(B, Hk, g, Q, D)`` f32, k/v ``(B, Hk, S, D)``,
    mask broadcastable to ``(B, Hk, g, Q, S)`` -> f32 ``(B, Hk, g, Q, D)``.
    Each (slot, kv-head) cell's sums do not depend on the cells beside it
    (:func:`_cell_products`)."""
    scale = qg.shape[-1] ** -0.5
    logits = _cell_products(qg, k.float().transpose(-1, -2)) * scale
    probs = softmax(torch.where(mask, logits, NEG_INF))
    return _cell_products(probs, v.float())


def int8_weights(qg, k, k_scale, v_scale, mask) -> torch.Tensor:
    """A2 (8-bit QK^T), softmax, and the A3 operand before it is
    quantised: ``probs * v_scale`` ``(B, Hk, g, Q, S)``; shapes as
    :func:`int8_attend`."""
    scale = qg.shape[-1] ** -0.5
    q_q, q_scale = quantize_rows(qg)
    logits_i = torch.einsum("bhgqd,bhsd->bhgqs", q_q, k.float())
    logits = logits_i * q_scale * k_scale[:, :, None, None, :] * scale
    probs = softmax(torch.where(mask, logits, NEG_INF))
    return probs * v_scale[:, :, None, None, :]


def int8_code_step(qg, k, k_scale, v_scale, mask) -> torch.Tensor:
    """``max_j probs_j * v_scale_j`` per ``(b, h, g, q)`` row: the most one
    probability code flipped by 1 moves that row of :func:`int8_attend`
    (a code is worth ``w_scale = max_j w_j / 127`` and ``|v| <= 127``)."""
    return int8_weights(qg, k, k_scale, v_scale, mask).amax(-1)


def int8_attend(qg, k, k_scale, v, v_scale, mask) -> torch.Tensor:
    """The engine's A2 (8-bit QK^T) + A3 (8-bit PV) attend: k/v int8
    ``(B, Hk, S, D)``, scales ``(B, Hk, S)``; shapes as :func:`dense_attend`."""
    w = int8_weights(qg, k, k_scale, v_scale, mask)
    w_scale = torch.clamp(w.amax(-1, keepdim=True), min=1e-20) / 127.0
    w_q = torch.clamp(torch.round(w / w_scale), 0, 127)
    return torch.einsum("bhgqs,bhsd->bhgqd", w_q, v.float()) * w_scale


def gather_phys(page_ids: torch.Tensor, page_size: int, seq_len: int) -> torch.Tensor:
    """Logical->physical gather map: ``(B, pp)`` page ids -> ``(B, S)`` pool
    rows (unmapped ``-1`` pages clamp to row 0; callers mask by position)."""
    s = torch.arange(seq_len, device=page_ids.device)
    pid = page_ids[:, s // page_size]
    return torch.where(pid >= 0, pid * page_size + (s % page_size)[None], 0)


def paged_flash_decode_ref(
    q: torch.Tensor,  # (B, Hk, g, D) f32 grouped decode query
    k: torch.Tensor,  # (n_tok, Hk, D) bf16/f32, or int8 with k_scale
    v: torch.Tensor,  # (n_tok, Hk, D)
    page_ids: torch.Tensor,  # (B, pages_per_slot) int32, -1 = unmapped
    pos: torch.Tensor,  # (B,) int32 — keys at logical s <= pos[b] are valid
    *,
    page_size: int,
    k_scale: Optional[torch.Tensor] = None,  # (n_tok, Hk) f32 (int8 format)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token paged attend -> f32 ``(B, Hk, g, D)`` over the
    ``pages_per_slot * page_size`` lanes a table row addresses, lanes past
    ``pos[b]`` masked to ``NEG_INF`` exactly like the engine."""
    S = page_ids.shape[1] * page_size
    phys = gather_phys(page_ids.long(), page_size, S)
    view = lambda pool: pool[phys].movedim(2, 1)  # -> (B, Hk, S, ...)
    qg = q[:, :, :, None, :].float()  # (B, Hk, g, Q=1, D)
    valid = torch.arange(S, device=q.device)[None, :] <= pos[:, None].long()
    mask = valid[:, None, None, None, :]  # (B, 1, 1, Q=1, S)
    if k_scale is None:
        out = dense_attend(qg, view(k), view(v), mask)
    else:
        out = int8_attend(qg, view(k), view(k_scale), view(v), view(v_scale), mask)
    return out[:, :, :, 0]
