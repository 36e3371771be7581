"""Value-level top-k attention-sparsity prediction — the paper's baseline
(§2.2, Fig. 3): pre-compute with 4-bit MSB keys, top-k sort, formal
compute.

Counterpart of :mod:`repro.core.topk`.  ``jax.lax.top_k`` puts equal
values in index order, lower index first; ``torch.topk`` promises no order,
so :func:`top_k` takes a stable descending sort instead (``-inf`` lanes
included).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.quantization import int_matmul


class ValueTopKStats(NamedTuple):
    predict_bytes: torch.Tensor  # float32
    predict_ops: torch.Tensor  # int32


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries along the last axis and their indices, as
    ``jax.lax.top_k`` orders them: descending, ties by lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def quantize_msb(x: torch.Tensor, bits: int = 4, nbits: int = 8) -> torch.Tensor:
    """Keep the top ``bits`` of an int8-range tensor (drop low bits) -> int32."""
    shift = nbits - 1 - bits  # int8: 7 magnitude bits
    x = x.to(torch.int32)
    if shift <= 0:
        return x
    return torch.sign(x) * ((x.abs() >> shift) << shift)


def value_topk_predict(
    q: torch.Tensor,  # (D,) int
    k: torch.Tensor,  # (S, D) int8 keys
    k_keep: int,
    estimate_bits: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, ValueTopKStats]:
    """Estimate scores from ``estimate_bits``-MSB keys, select the top-k.

    Traffic model: the estimate fetches all S keys at ``estimate_bits``
    wide.  Returns (indices (k_keep,), est scores (S,) float32, stats)."""
    S, D = k.shape
    k_est = quantize_msb(k, estimate_bits)
    est = int_matmul(k_est, q.to(torch.int32)[:, None])[:, 0].to(torch.float32)
    _, idx = top_k(est, k_keep)
    stats = ValueTopKStats(
        predict_bytes=torch.tensor(S * D * estimate_bits / 8.0, dtype=torch.float32,
                                   device=k.device),
        predict_ops=torch.tensor(S * D, dtype=torch.int32, device=k.device),
    )
    return idx, est, stats


def topk_mask(est: torch.Tensor, k_keep: int) -> torch.Tensor:
    """Boolean mask keeping the k largest entries along the last axis."""
    k_keep = min(k_keep, est.shape[-1])
    kth = torch.sort(est, dim=-1).values[..., -k_keep]
    return est >= kth[..., None]
