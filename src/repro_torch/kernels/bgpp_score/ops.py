"""Public wrappers of one BGPP scoring round over bit-planar packed keys.

Counterpart of :mod:`repro.kernels.bgpp_score.ops`.  Routing is by the
tensors' device: CPU tensors take the plain version in :mod:`.ref`; CUDA
tensors launch the CUDA kernel or the call raises — there is no fallback.
The kernel's key tile comes from :func:`.kernel.plan`, so the reference's
``tile_s`` has no counterpart, and it takes any S (the reference pads S
to its tile) and any number of query rows.

:func:`bgpp_score_round` has the reference's signature (one query, one
key set).  :func:`bgpp_score_heads` scores every query head of a decode
batch in one launch: query head ``h`` reads kv head ``h // g``'s plane in
place, so the g heads of a group share one copy of the planes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.bgpp_score import kernel
from repro_torch.kernels.bgpp_score.ref import bgpp_score_heads_ref
from repro_torch.kernels.paged_flash_decode.kernel import sm_count

def _validate(q, plane_packed, sign_packed, alive) -> None:
    if q.ndim != 3 or plane_packed.ndim != 4 or sign_packed.shape != plane_packed.shape:
        raise ValueError(
            f"bgpp_score: want q (B, Hq, D) and plane/sign (B, S, Hk, D//8); got "
            f"{tuple(q.shape)} / {tuple(plane_packed.shape)} / {tuple(sign_packed.shape)}")
    B, Hq, D = q.shape
    _, S, Hk, Dp = plane_packed.shape
    if plane_packed.shape[0] != B or D != 8 * Dp or Hq % Hk:
        raise ValueError(
            f"bgpp_score: planes {tuple(plane_packed.shape)} do not match q "
            f"{tuple(q.shape)} (same B, D = 8 * packed width, Hq a multiple of Hk)")
    if tuple(alive.shape) != (B, Hq, S) or alive.dtype != torch.bool:
        raise ValueError(f"bgpp_score: alive must be bool {(B, Hq, S)}, got "
                         f"{alive.dtype} {tuple(alive.shape)}")
    if q.dtype != torch.int32 or plane_packed.dtype != torch.uint8 \
            or sign_packed.dtype != torch.uint8:
        raise ValueError("bgpp_score: q must be int32 and the planes uint8")
    if len({q.device, plane_packed.device, sign_packed.device, alive.device}) != 1:
        raise ValueError("bgpp_score: operands lie on different devices")


def bgpp_score_heads(
    q: torch.Tensor,  # (B, Hq, D) int32, already MSB-truncated
    plane_packed: torch.Tensor,  # (B, S, Hk, D//8) uint8 — magnitude plane p
    sign_packed: torch.Tensor,  # (B, S, Hk, D//8) uint8
    alive: torch.Tensor,  # (B, Hq, S) bool
) -> torch.Tensor:
    """(B, Hq, S) int32 masked plane scores (without the 2^p weighting):
    ``Σ_d q[b, h, d] · (1 − 2·sign) · bit`` of kv head ``h // g`` for alive
    keys, 0 for the others."""
    _validate(q, plane_packed, sign_packed, alive)
    if q.device.type == "cpu":
        return bgpp_score_heads_ref(q, plane_packed, sign_packed, alive)
    if q.device.type != "cuda":
        raise ValueError(f"bgpp_score: no kernel for device {q.device}")
    if plane_packed.stride(3) != 1 or sign_packed.stride(3) != 1:
        raise ValueError("bgpp_score: the packed planes need unit stride along D")
    q, alive = q.contiguous(), alive.contiguous()
    out = torch.empty(alive.shape, dtype=torch.int32, device=q.device)
    if out.numel():
        B, Hq, D = q.shape
        S, Hk = plane_packed.shape[1:3]
        geometry = kernel.plan(B, Hk, Hq // Hk, S, D, sm_count(q.device))
        kernel.launch(q, plane_packed, sign_packed, alive, out, geometry)
        LAUNCHES["bgpp_score"] += 1
    return out


def bgpp_score_round(
    q: torch.Tensor,  # (D,) int32
    plane_packed: torch.Tensor,  # (S, D//8) uint8
    sign_packed: torch.Tensor,  # (S, D//8) uint8
    alive: torch.Tensor,  # (S,) bool
) -> torch.Tensor:
    """(S,) int32 masked plane scores of one query (the reference's call)."""
    return bgpp_score_heads(q.to(torch.int32)[None, None], plane_packed[None, :, None],
                            sign_packed[None, :, None], alive.to(torch.bool)[None, None])[0, 0]
