"""Public wrapper for the fused BGPP paged decode.

Counterpart of :mod:`repro.kernels.bgpp_paged_attend.ops`.  Routing is by
the tensors' device: CPU tensors take the plain version in :mod:`.ref`;
CUDA tensors launch the CUDA kernel or the call raises — there is no
fallback.  GQA, plan, shape and context-length mistakes raise here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.bgpp import DEFAULT_QUERY_BITS
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.bgpp_paged_attend import kernel
from repro_torch.kernels.bgpp_paged_attend.ref import NBITS, bgpp_paged_attend_ref
from repro_torch.kernels.paged_flash_decode.kernel import sm_count


def _validate(q, k_planes, k_sign, k_scale, v, v_scale, phys, pos,
              rounds, k_max, survivors):
    if q.ndim != 4:
        raise ValueError(
            f"bgpp_paged_attend: q must be grouped (B, Hk, g, D), got shape "
            f"{tuple(q.shape)}"
        )
    B, Hk, g, D = q.shape
    if D % 8:
        raise ValueError(
            f"bgpp_paged_attend: head_dim={D} is not a multiple of 8 — "
            f"packed bit planes need whole bytes per row"
        )
    if k_planes.ndim != 4 or k_planes.shape[0] != NBITS:
        raise ValueError(
            f"bgpp_paged_attend: k_planes must be (NBITS={NBITS}, n_tok, Hk, "
            f"D/8); got {tuple(k_planes.shape)}"
        )
    _, n_tok, hk_p, Dp = k_planes.shape
    if hk_p != Hk or Dp != D // 8:
        raise ValueError(
            f"bgpp_paged_attend: planes (Hk={hk_p}, D/8={Dp}) do not match "
            f"q's (Hk={Hk}, D/8={D // 8})"
        )
    if tuple(k_sign.shape) != (n_tok, Hk, Dp) or k_sign.stride() != k_planes.stride()[1:]:
        raise ValueError(
            f"bgpp_paged_attend: k_sign must be (n_tok, Hk, D/8) = "
            f"({n_tok}, {Hk}, {Dp}) with the planes' token/head strides; got "
            f"{tuple(k_sign.shape)}/{k_sign.stride()}"
        )
    if (tuple(k_scale.shape) != (n_tok, Hk) or k_scale.shape != v_scale.shape
            or k_scale.stride() != v_scale.stride()):
        raise ValueError(
            f"bgpp_paged_attend: scales must both be (n_tok={n_tok}, Hk={Hk}) "
            f"with equal strides; got {tuple(k_scale.shape)} / "
            f"{tuple(v_scale.shape)}"
        )
    if tuple(v.shape) != (n_tok, Hk, D):
        raise ValueError(
            f"bgpp_paged_attend: v must be (n_tok, Hk, D); got {tuple(v.shape)}"
        )
    if phys.ndim != 2 or phys.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError(
            f"bgpp_paged_attend: phys must be (B={B}, S) and pos (B,); got "
            f"{tuple(phys.shape)} / {tuple(pos.shape)}"
        )
    S = phys.shape[1]
    if len(survivors) != rounds or not 1 <= rounds <= NBITS:
        raise ValueError(
            f"bgpp_paged_attend: plan has rounds={rounds} but survivor widths "
            f"{survivors} — pass kv_cache.bgpp_decode_plan's tuple unmodified"
        )
    if survivors[0] != S or any(a < b for a, b in zip(survivors, survivors[1:])):
        raise ValueError(
            f"bgpp_paged_attend: survivors {survivors} must start at S={S} and "
            f"be non-increasing"
        )
    if not (1 <= k_max <= survivors[-1]):
        raise ValueError(
            f"bgpp_paged_attend: k_max={k_max} must satisfy 1 <= k_max <= "
            f"survivors[-1]={survivors[-1]}"
        )
    tensors = [q, k_planes, k_sign, k_scale, v, v_scale, phys, pos]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("bgpp_paged_attend: operands lie on different devices")


def _validate_cuda(q, k_planes, k_sign, k_scale, v, v_scale, phys, pos, k_max,
                   survivors, whole=None) -> kernel.Plan:
    """What the CUDA kernel additionally requires of its operands; returns
    the launch's :func:`kernel.plan` (which raises past the context cap,
    524,288 lanes; past one cluster's 32768 it plans the body whose
    selection spans blocks, and the workspace below holds its lists).
    Every D (a multiple of 8) up to 256 runs, at its compiled width
    (:func:`kernel.padded_dim`), and rows at any alignment (vector loads
    where they allow, :func:`kernel.wide_rows`); the refusals are g > 8,
    D > 256 and the context cap."""
    B, Hk, g, D = q.shape
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError("bgpp_paged_attend: q must be contiguous float32")
    if g > 8:
        raise ValueError(f"bgpp_paged_attend: GQA group g={g} > 8 is not supported")
    kernel.padded_dim(D)  # raises past the widest compiled width
    if (k_planes.dtype, k_sign.dtype, v.dtype) != (torch.uint8, torch.uint8, torch.int8):
        raise ValueError("bgpp_paged_attend: planes/sign must be uint8 and v int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("bgpp_paged_attend: scales must be float32")
    if k_planes.stride(3) != 1 or v.stride(2) != 1:
        raise ValueError("bgpp_paged_attend: plane and V rows must be contiguous")
    for name, t in (("phys", phys), ("pos", pos)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"bgpp_paged_attend: {name} must be contiguous int32")
    Bp, Hkp = (B, Hk) if whole is None else whole
    return kernel.plan(Bp, Hkp, g, D, phys.shape[1], k_max, survivors,
                       sm_count(q.device))


def bgpp_paged_attend(
    q: torch.Tensor,  # (B, Hk, g, D) f32 RAW grouped decode query
    k_planes: torch.Tensor,  # (NBITS, n_tok, Hk, D/8) uint8 packed planes
    k_sign: torch.Tensor,  # (n_tok, Hk, D/8) uint8 packed sign plane
    k_scale: torch.Tensor,  # (n_tok, Hk) f32
    v: torch.Tensor,  # (n_tok, Hk, D) int8
    v_scale: torch.Tensor,  # (n_tok, Hk) f32
    phys: torch.Tensor,  # (B, S) int32 logical -> pool row map
    pos: torch.Tensor,  # (B,) int32 last valid logical position per slot
    *,
    rounds: int,
    k_max: int,
    survivors: Tuple[int, ...],
    return_indices: bool = False,
    whole: Optional[Tuple[int, int]] = None,
):
    """Fused two-phase BGPP paged decode -> f32 ``(B, Hk, g, D)``.

    ``(rounds, k_max, survivors)`` is the plan from
    :func:`repro_torch.serving.kv_cache.bgpp_decode_plan`.  With
    ``return_indices`` the ``(B, Hk, k_max)`` int32 survivor lanes come back
    too, in selection order (the kernel/plain comparison uses them).
    ``whole`` is ``(B, Hk)`` of the unsharded launch a mesh rank's slice
    belongs to: the plan takes its cluster split from it, so the rank's
    output is that slice of the whole launch bit for bit."""
    survivors = tuple(int(s) for s in survivors)
    _validate(q, k_planes, k_sign, k_scale, v, v_scale, phys, pos,
              rounds, k_max, survivors)
    if q.device.type == "cpu":
        return bgpp_paged_attend_ref(
            q, k_planes, k_sign, k_scale, v, v_scale, phys, pos, rounds=rounds,
            k_max=k_max, survivors=survivors, return_indices=return_indices,
        )
    if q.device.type != "cuda":
        raise ValueError(f"bgpp_paged_attend: no kernel for device {q.device}")
    geometry = _validate_cuda(q, k_planes, k_sign, k_scale, v, v_scale, phys, pos,
                              k_max, survivors, whole)
    B, Hk = q.shape[:2]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    idx = (torch.empty((B, Hk, k_max), dtype=torch.int32, device=q.device)
           if return_indices else None)
    # the lists' workspace where they do not fit in shared memory (never read
    # before the kernel writes it)
    ws = (torch.empty(kernel.workspace_ints(B, Hk, q.shape[2], geometry), dtype=torch.int32,
                      device=q.device) if geometry.workspace else None)
    kernel.launch(q, k_planes, k_sign, k_scale, v, v_scale, phys, pos, out, idx, ws,
                  k_max=k_max, survivors=survivors, query_bits=DEFAULT_QUERY_BITS,
                  geometry=geometry)
    LAUNCHES["bgpp_paged_attend"] += 1
    return (out, idx) if return_indices else out
