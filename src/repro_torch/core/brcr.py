"""BRCR — BS-Repetitiveness-enabled Computation Reduction (paper §3.1).

Counterpart of :mod:`repro.core.brcr`.  Factorizes each m-row group of
each weight bit plane as ``W_g @ X = E @ (I @ X)``:

* ``I @ X`` (*merging*): every column of the group matrix is an m-bit
  pattern; columns sharing a pattern c have their activations accumulated
  into entry c of the Merged Activation Vector (MAV) ``Z`` (length 2**m).
  At most ``H × (1 - bs)`` adds; pattern-0 columns are free.
* ``E @ Z`` (*reconstruction*): the enumeration matrix E (m × 2**m,
  ``E[j,c] = bit j of c``) rebuilds the m row results — at most
  ``m × 2**(m-1)`` adds, amortized across the whole H dimension.

Signs are handled by the disjoint split ``W = W⁺ − W⁻``
(``bitslice.signed_plane_split``).

On every device :func:`brcr_matmul` prepares the signed-plane patterns
and calls the ``brcr_gemm`` wrapper once, which routes by the tensors'
device: a launch of the CUDA kernel on the card, the plain version on the
CPU.  The reference's ``brcr_matmul`` is pure jnp and never launches its
Pallas kernel.  :func:`merged_activation_vector` and :func:`reconstruct`
are the two steps on their own; the MAV is taken over group chunks, so
its one-hot stays under ``kernels.brcr_gemm.ref.ONEHOT_BYTES`` at any
width.  The cost model (:func:`brcr_cost`) counts on the weight's device
in a few vectorised passes where the reference loops over groups with
``np.bincount``; the counts are equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import bitslice
from repro_torch.kernels.brcr_gemm.ops import brcr_gemm, prepare_brcr_operands
from repro_torch.kernels.brcr_gemm.ref import group_chunk

DEFAULT_GROUP_SIZE = 4  # paper §5.2: m=4 balances CPR and CR
DEFAULT_NBITS = bitslice.WEIGHT_MAG_BITS


def merged_activation_vector(group_idx: torch.Tensor, x: torch.Tensor, m: int) -> torch.Tensor:
    """The I @ X step: scatter-accumulate activations by column pattern.

    group_idx: (G, H) int patterns in [0, 2**m);  x: (H, N).
    Returns Z: (G, 2**m, N) in x's dtype, ``Z[g, c] = Σ_{h: idx[g,h]=c} x[h]``."""
    G, H = group_idx.shape
    bins = torch.arange(2 ** m, device=group_idx.device)
    step = group_chunk(H, m)
    return torch.cat([torch.einsum("ghc,hn->gcn",
                                   (group_idx[g0:g0 + step, :, None] == bins).to(x.dtype), x)
                      for g0 in range(0, G, step)])


def reconstruct(z: torch.Tensor, m: int) -> torch.Tensor:
    """The E @ Z step: (G, 2**m, N) -> (G, m, N)."""
    e = bitslice.enumeration_matrix(m, dtype=z.dtype, device=z.device)
    return torch.einsum("jc,gcn->gjn", e, z)


def brcr_matmul(
    w_q: torch.Tensor,
    x: torch.Tensor,
    m: int = DEFAULT_GROUP_SIZE,
    nbits: int = DEFAULT_NBITS,
) -> torch.Tensor:
    """``w_q @ x`` computed through the BRCR factorization.

    w_q: (M, H) int8 (|w| < 2**nbits); x: (H, N) int or float.  Integer x
    gives int32 (rounded from float32: equal to the dense product while a
    row's Σ|w·x| stays below 2**24); float x gives float32 (the same
    product up to summation order).  One ``brcr_gemm`` call (x as float32,
    or bfloat16 as given)."""
    integer = not x.is_floating_point()
    xk = x if x.dtype in (torch.float32, torch.bfloat16) else x.to(torch.float32)
    y = brcr_gemm(prepare_brcr_operands(w_q, m, nbits), xk)
    return torch.round(y).to(torch.int32) if integer else y


# ---------------------------------------------------------------------------
# Cost model (paper §3.1 closed forms + measured counts from actual planes).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BRCRCost:
    """Operation counts for one (M, H) x (H, N) GEMM, per the paper's metric
    (additions; value-level INT8 MACs for the dense baseline)."""

    adds_merge: int  # measured: nonzero columns across groups/planes (x N)
    adds_reconstruct: int  # measured: E@Z adds over non-empty bins (x N)
    adds_total: int
    adds_bsc_baseline: int  # sparsity-aware bit-serial: k*H*m*(1-bs) per group
    macs_dense: int  # dense value-level INT8
    adds_value_sparse: int  # value-sparsity scheme: H*m*k*(1-vs)
    bit_sparsity: float
    value_sparsity: float
    reduction_vs_bsc: float
    reduction_vs_dense: float


def brcr_cost(
    w_q: torch.Tensor,
    n_cols: int = 1,
    m: int = DEFAULT_GROUP_SIZE,
    nbits: int = DEFAULT_NBITS,
) -> BRCRCost:
    """Measured op counts of BRCR on an actual weight matrix.

    Counting convention (paper Fig. 4/7): merging charges one ADD per
    nonzero column pattern; reconstruction charges ``popcount(E row ∩
    non-empty bins)`` adds per group row (``hits - 1`` adds plus one
    for a non-empty row); everything scales linearly with N.  Per signed
    plane, the non-empty bins of every group come from one scatter."""
    M, H = w_q.shape
    dev = w_q.device
    idx = prepare_brcr_operands(w_q, m, nbits).group_idx  # (2*nbits, G, H)
    e = bitslice.enumeration_matrix(m, torch.bool, dev)  # (m, 2**m)
    merge = torch.zeros((), dtype=torch.int64, device=dev)
    recon = torch.zeros((), dtype=torch.int64, device=dev)
    for patt in idx:
        merge += (patt != 0).sum()
        bins = torch.zeros((M // m, 2 ** m), dtype=torch.bool, device=dev)
        bins.scatter_(1, patt.to(torch.int64), True)
        bins[:, 0] = False  # pattern 0 is never merged
        hits = (bins[:, None, :] & e[None]).sum(-1)  # (G, m)
        recon += ((hits - 1).clamp(min=0) + (hits > 0)).sum()
    mag = w_q.to(torch.int32).abs()
    ones = sum(((mag >> p) & 1).sum() for p in range(nbits))
    zeros = (w_q == 0).sum()
    adds_merge, adds_recon, ones, zeros = (
        int(v) for v in torch.stack([merge, recon, ones.to(torch.int64),
                                     zeros.to(torch.int64)]).tolist())
    # sparsities as the reference's numpy means give them: exact count / n
    bs_sm = 1.0 - ones / (nbits * M * H)
    vs = zeros / (M * H)
    adds_bsc = int(round(nbits * H * m * (1.0 - bs_sm))) * (M // m)
    macs_dense = M * H
    adds_value = int(round(M * H * (1.0 - vs)))
    total = adds_merge + adds_recon
    return BRCRCost(
        adds_merge=adds_merge * n_cols,
        adds_reconstruct=adds_recon * n_cols,
        adds_total=total * n_cols,
        adds_bsc_baseline=adds_bsc * n_cols,
        macs_dense=macs_dense * n_cols,
        adds_value_sparse=adds_value * n_cols,
        bit_sparsity=float(bs_sm),
        value_sparsity=vs,
        reduction_vs_bsc=1.0 - total / max(adds_bsc, 1),
        reduction_vs_dense=1.0 - total / max(macs_dense, 1),
    )


def brcr_cost_closed_form(H: int, m: int, nbits: int, bit_sparsity: float) -> Dict[str, float]:
    """Paper's closed form for an H×H GEMV: kH²/m·(1−bs) + kH·2^(m−1)."""
    merge = nbits * H * H / m * (1.0 - bit_sparsity)
    recon = nbits * H * (2 ** (m - 1))
    return {
        "adds_merge": merge,
        "adds_reconstruct": recon,
        "adds_total": merge + recon,
        "adds_bsc_baseline": nbits * H * H * (1.0 - bit_sparsity),
        "macs_dense": float(H * H),
    }


def optimal_group_size(H: int, nbits: int, bit_sparsity: float, m_range=range(1, 9)) -> int:
    """DSE over m (paper Fig. 18): argmin of the closed-form total adds."""
    costs = {m: brcr_cost_closed_form(H, m, nbits, bit_sparsity)["adds_total"]
             for m in m_range}
    return min(costs, key=costs.get)
