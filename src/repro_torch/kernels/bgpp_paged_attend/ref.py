"""Plain PyTorch version of the fused two-phase BGPP paged decode.

Counterpart of :mod:`repro.kernels.bgpp_paged_attend.ref`: the serving
engine's pipeline on raw pool operands — quantise + MSB-truncate the query,
progressive MSB-first plane scoring with early termination, the compacted
survivor gather, and the exact int8 A2/A3 attend.  The serving engine's
``_bgpp_*`` attends are built from these pieces.

Top-k keeps ``lax.top_k``'s order: descending score, lowest index first
among ties (bit-plane scores tie often).  ``torch.topk`` promises no tie
order, so selection is a stable descending sort.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core import bgpp as bgpp_mod, bitslice
from repro_torch.kernels.paged_flash_decode.ref import NEG_INF, int8_attend

NBITS = bitslice.WEIGHT_MAG_BITS  # 7 magnitude planes + sign


def topk_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, in
    ``lax.top_k`` order (descending, lowest index first among ties)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def quant_query(q: torch.Tensor) -> torch.Tensor:
    """(..., D) raw query -> quantized + 4-bit-MSB-truncated f32 (engine
    ``_bgpp_quant_query`` on the grouped layout)."""
    qg = q.float()
    dq = torch.clamp(qg.abs().amax(-1, keepdim=True), min=1e-8) / 127.0
    q_int = torch.clamp(torch.round(qg / dq), -127, 127).to(torch.int32)
    q_int = bgpp_mod._truncate_query(q_int, NBITS, bgpp_mod.DEFAULT_QUERY_BITS)
    return q_int.float()


def rows_per_head(pool: torch.Tensor, rows: torch.Tensor, planar: bool) -> torch.Tensor:
    """Per-(slot, head) compacted pool gather: pool ``(n_tok, Hk, ...)``
    (planar: a leading NBITS axis), rows ``(B, Hk, k)`` physical rows ->
    ``(B, Hk, k, ...)`` (planar: leading NBITS); head ``h`` fetches only its
    own slice of each row."""
    heads = torch.arange(rows.shape[1], device=rows.device)[None, :, None]
    return pool[:, rows, heads] if planar else pool[rows, heads]


def rows_at(phys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Translate per-head logical indices ``(B, Hk, k)`` through the gather
    map ``(B, S)`` -> ``(B, Hk, k)`` physical pool rows."""
    B, Hk, k = idx.shape
    return torch.gather(phys, 1, idx.reshape(B, Hk * k)).reshape(B, Hk, k)


def _plane_scores(plane_packed, sign_packed, qf):
    """signed plane contribution: packed ``(B, Hk, S', D/8)`` -> ``(B, Hk, g, S')``."""
    plane = bitslice.unpack_bits(plane_packed).float()
    signed = torch.where(bitslice.unpack_bits(sign_packed).bool(), -1.0, 1.0) * plane
    return torch.einsum("bhgd,bhsd->bhgs", qf, signed)


def progressive_topk(qf, plane0, sign_full, plane_at: Callable, valid,
                     rounds: int, k_max: int, survivors: Tuple[int, ...]):
    """Engine ``_bgpp_topk_indices`` with the plan passed in.

    qf ``(B, Hk, g, D)`` quantized query; plane0 / sign_full ``(B, Hk, S,
    D/8)`` packed MSB and sign planes of every lane; ``plane_at(p, idx)``
    packed plane ``p`` at logical indices ``(B, Hk, k)``; valid ``(B, S)``.
    Returns ``(idx (B, Hk, k_max) logical lanes, idx_valid)``.
    """
    B, Hk = qf.shape[:2]
    S = valid.shape[1]
    valid_h = valid[:, None, :].expand(B, Hk, S)
    partial = _plane_scores(plane0, sign_full, qf) * float(2 ** (NBITS - 1))
    score = torch.where(valid[:, None, :], partial.amax(2), NEG_INF)
    cur_idx = None  # None = all S lanes
    for r in range(1, rounds):
        li = topk_indices(score, survivors[r])
        cur_idx = li if cur_idx is None else torch.gather(cur_idx, 2, li)
        partial = torch.gather(
            partial, 3, li[:, :, None, :].expand(-1, -1, partial.shape[2], -1))
        p_r = NBITS - 1 - r
        sign_g = torch.gather(
            sign_full, 2, cur_idx[..., None].expand(-1, -1, -1, sign_full.shape[-1]))
        partial = partial + _plane_scores(plane_at(p_r, cur_idx), sign_g, qf) * float(2**p_r)
        score = torch.where(torch.gather(valid_h, 2, cur_idx), partial.amax(2), NEG_INF)
    li = topk_indices(score, k_max)
    idx = li if cur_idx is None else torch.gather(cur_idx, 2, li)
    return idx, torch.gather(valid_h, 2, idx)


def formal_attend(q, k_planes, k_sign, k_scale, v, v_scale, idx_valid):
    """Phase 2: exact int8 attend (A2/A3) over the compacted survivors.

    q ``(B, Hk, g, D)`` raw grouped query; k_planes ``(NBITS, B, Hk, k,
    D/8)``; k_sign ``(B, Hk, k, D/8)``; k_scale / v_scale ``(B, Hk, k)``; v
    ``(B, Hk, k, D)`` int8; idx_valid masks survivors top-k filled from
    invalid lanes (NEG_INF logits zero their mass exactly)."""
    k_q = bitslice.from_sign_magnitude(
        bitslice.unpack_bits(k_sign),
        bitslice.from_bitplanes(bitslice.unpack_bits(k_planes)),
    )
    out = int8_attend(q[:, :, :, None, :].float(), k_q, k_scale, v, v_scale,
                      idx_valid[:, :, None, None, :])
    return out[:, :, :, 0]


def bgpp_paged_attend_ref(
    q: torch.Tensor,  # (B, Hk, g, D) f32 RAW grouped decode query
    k_planes: torch.Tensor,  # (NBITS, n_tok, Hk, D/8) uint8 packed planes
    k_sign: torch.Tensor,  # (n_tok, Hk, D/8) uint8 packed sign plane
    k_scale: torch.Tensor,  # (n_tok, Hk) f32
    v: torch.Tensor,  # (n_tok, Hk, D) int8
    v_scale: torch.Tensor,  # (n_tok, Hk) f32
    phys: torch.Tensor,  # (B, S) int32 logical->pool row gather map
    pos: torch.Tensor,  # (B,) int32 — keys at logical s <= pos[b] are valid
    *,
    rounds: int,
    k_max: int,
    survivors: Tuple[int, ...],
    return_indices: bool = False,
):
    """Fused two-phase BGPP decode -> f32 ``(B, Hk, g, D)`` (and, with
    ``return_indices``, the ``(B, Hk, k_max)`` int32 survivor lanes in
    selection order)."""
    phys = phys.long()
    S = phys.shape[1]
    valid = torch.arange(S, device=q.device)[None, :] <= pos[:, None].long()
    heads_major = lambda a: a[phys].movedim(2, 1)  # (B, S, Hk, ..) -> (B, Hk, S, ..)
    idx, idx_valid = progressive_topk(
        quant_query(q), heads_major(k_planes[NBITS - 1]), heads_major(k_sign),
        lambda p, i: rows_per_head(k_planes[p], rows_at(phys, i), False),
        valid, rounds, k_max, survivors,
    )
    rows = rows_at(phys, idx)
    out = formal_attend(
        q, rows_per_head(k_planes, rows, True), rows_per_head(k_sign, rows, False),
        rows_per_head(k_scale, rows, False), rows_per_head(v, rows, False),
        rows_per_head(v_scale, rows, False), idx_valid,
    )
    return (out, idx.to(torch.int32)) if return_indices else out
