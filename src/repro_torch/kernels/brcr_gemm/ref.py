"""Plain PyTorch version of the BRCR GEMM.

Counterpart of :mod:`repro.kernels.brcr_gemm.ref`.  Computes ``w_q @ x``
through the factorization the kernel uses: per signed bit plane, group
patterns -> one-hot MAV -> enumeration-matrix reconstruction ->
shift-weighted accumulation.  Equal to the dense product for integer x
while a row's ``Σ|w·x|`` stays below 2**24 (every partial sum is then an
exact float32 integer), and to an f32 matmul up to summation order for
float x.

The reference materialises a ``(P, G, H, 2**m)`` float32 one-hot (5.6 GB
for an 8192 x 3072 weight); this version walks the planes, and the groups
in chunks of at most :data:`ONEHOT_BYTES`, accumulating each plane's
result in order.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitslice

ONEHOT_BYTES = 1 << 28  # the float32 one-hot of one chunk of groups


def group_chunk(H: int, m: int) -> int:
    """Groups a chunk holds so its (groups, H, 2**m) f32 one-hot fits
    :data:`ONEHOT_BYTES`."""
    return max(1, ONEHOT_BYTES // (4 * max(H, 1) * 2 ** m))


def brcr_gemm_ref(
    group_idx: torch.Tensor,  # (P, G, H) uint8 patterns per signed plane
    plane_weights: torch.Tensor,  # (P,) f32 = ±2^p
    x: torch.Tensor,  # (H, N)
    m: int,
) -> torch.Tensor:
    """Returns (G*m, N) float32."""
    P, G, H = group_idx.shape
    N = x.shape[1]
    xf = x.to(torch.float32)
    e = bitslice.enumeration_matrix(m, torch.float32, xf.device)  # (m, 2^m)
    bins = torch.arange(2 ** m, dtype=group_idx.dtype, device=group_idx.device)
    out = torch.zeros((G, m, N), dtype=torch.float32, device=xf.device)
    step = group_chunk(H, m)
    for p in range(P):
        for g0 in range(0, G, step):
            onehot = (group_idx[p, g0:g0 + step, :, None] == bins).to(torch.float32)
            z = torch.einsum("ghc,hn->gcn", onehot, xf)  # the MAV of the chunk
            y = torch.einsum("jc,gcn->gjn", e, z)
            out[g0:g0 + step] += y * plane_weights[p]
    return out.reshape(G * m, N)


def dense_ref(w_q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The ultimate oracle: the plain dense product in float32."""
    return w_q.to(torch.float32) @ x.to(torch.float32)
