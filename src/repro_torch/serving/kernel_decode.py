"""Route the engine's global-layer decode attend onto the kernel families.

Counterpart of :mod:`repro.serving.kernel_decode`.  Its ``shard_map``
has no counterpart: under a mesh each rank calls these on its own (slot,
kv-head) shard with no collective, and hands down the whole launch's
``(B, Hk)`` so the kernels plan the cluster split of the unsharded launch
and each rank's output is its slice of that launch bit for bit.

* ``paged_flash_decode`` — bf16 / int8 dense attend.  The paged layout
  passes its token-major pools and page table straight into the kernel.
* ``bgpp_paged_attend`` — the fused two-phase BGPP decode.

The route is decided by the tensors' device, not by a mode knob: CUDA
tensors launch the CUDA kernels (or the call raises), CPU tensors run the
kernels' plain versions.

The slot layout's heads-major stacks ``(B, Hk, S, ...)`` feed the same
kernels without a copy: :func:`_pool_views` re-strides each layer as a
token-major "pool" whose row ``b*Hk*S + s`` is slot ``b``'s position ``s``
(token stride = one row, head stride = S rows), addressed through an
identity page table / phys map.  (In XLA the reference's transpose +
reshape was free; in PyTorch it would copy the layer's whole stack every
step.)
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.bgpp_paged_attend import bgpp_paged_attend
from repro_torch.kernels.paged_flash_decode import paged_flash_decode
from repro_torch.serving import kv_cache as kvc

Tree = Dict[str, Any]


def validate(cfg, layout) -> None:
    """Raise actionable errors for configs the kernels cannot serve."""
    if cfg.num_heads % cfg.num_kv_heads:
        raise ValueError(
            f"decode_attend: num_heads={cfg.num_heads} is not a multiple of "
            f"num_kv_heads={cfg.num_kv_heads} — the GQA group size must be "
            f"integral for the grouped (B, Hk, g, Dh) kernel query layout"
        )
    if layout.kv_format == "bgpp":
        if cfg.head_dim % 8:
            raise ValueError(
                f"decode_attend: head_dim={cfg.head_dim} is not a multiple of 8"
                f" — bgpp packs bit planes bytewise"
            )
        rounds, k_max, survivors = kvc.bgpp_decode_plan(layout.max_seq, cfg)
        if survivors[0] != layout.max_seq or k_max > layout.max_seq:
            raise ValueError(
                f"decode_attend: bgpp plan (rounds={rounds}, k_max={k_max}, "
                f"survivors={survivors}) is inconsistent with "
                f"max_seq={layout.max_seq}"
            )


def _slot_page_size(max_seq: int) -> int:
    """Largest of 8/4/2/1 dividing ``max_seq`` — the identity page table's
    page size for slot stacks."""
    return next(p for p in (8, 4, 2, 1) if max_seq % p == 0)


def _rows_view(a: torch.Tensor, planar: bool) -> torch.Tensor:
    """Heads-major ``(B, Hk, S, ...)`` (planar: leading NBITS) -> token-major
    ``((B-1)*Hk*S + S, Hk, ...)`` view sharing storage: row ``b*Hk*S + s``
    is ``a[b, :, s]``."""
    lead = 1 if planar else 0
    B, Hk, S = a.shape[lead:lead + 3]
    st = a.stride()
    if st[lead] != Hk * st[lead + 1] or st[lead + 1] != S * st[lead + 2]:
        raise ValueError("decode_attend: slot stacks must be contiguous per layer")
    rows = (B - 1) * Hk * S + S
    size = a.shape[:lead] + (rows, Hk) + a.shape[lead + 3:]
    stride = st[:lead] + (st[lead + 2], st[lead + 1]) + st[lead + 3:]
    return a.as_strided(size, stride)


def _pool_views(store: Tree, gi: int, fmt: str, slot_layout: bool) -> Tree:
    """Layer ``gi``'s token-major pool leaves (paged: the pool itself;
    slot: :func:`_rows_view` re-strides of the heads-major stacks)."""
    names = {"bf16": ("k", "v"), "int8": ("k", "v", "k_scale", "v_scale"),
             "bgpp": ("k_planes", "k_sign", "k_scale", "v", "v_scale")}[fmt]
    if not slot_layout:
        return {n: store[n][gi] for n in names}
    return {n: _rows_view(store[n][gi], n == "k_planes") for n in names}


def _attend_local(q1, pool: Tree, pos, table, cfg, layout, whole=None):
    """Run the kernel family -> f32 ``(B, Hq, Dh)``.  ``table`` is the page
    table (dense formats) or the phys map (bgpp); ``None`` (slot layout)
    builds the identity map over :func:`_rows_view`'s rows."""
    B, Hq, Dh = q1.shape
    g = cfg.num_heads // cfg.num_kv_heads
    Hk = Hq // g
    qg = q1.reshape(B, Hk, g, Dh).float().contiguous()
    S = layout.max_seq
    dev = q1.device
    b = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    if layout.kv_format == "bgpp":
        if table is None:  # slot: row b*Hk*S + s
            table = b * (Hk * S) + torch.arange(S, dtype=torch.int32, device=dev)[None]
        rounds, k_max, survivors = kvc.bgpp_decode_plan(S, cfg)
        out = bgpp_paged_attend(
            qg, pool["k_planes"], pool["k_sign"], pool["k_scale"], pool["v"],
            pool["v_scale"], table, pos, rounds=rounds, k_max=k_max,
            survivors=survivors, whole=whole,
        )
    else:
        if table is None:  # slot: page j of slot b is rows b*Hk*S + j*P ...
            page_size = _slot_page_size(S)
            pp = S // page_size
            table = b * (Hk * pp) + torch.arange(pp, dtype=torch.int32, device=dev)[None]
        else:
            page_size = layout.page_size
        scales = ({} if layout.kv_format == "bf16"
                  else {"k_scale": pool["k_scale"], "v_scale": pool["v_scale"]})
        out = paged_flash_decode(qg, pool["k"], pool["v"], table, pos,
                                 page_size=page_size, whole=whole, **scales)
    return out.reshape(B, Hq, Dh)


def decode_attend(q1, store: Tree, gi: int, pos, cfg, layout, phys=None,
                  page_table=None, whole=None):
    """Kernel-backed global-layer decode attend.

    q1 ``(B, Hq, Dh)``; ``store`` is ``cache["global"]``; ``pos`` the
    per-slot positions ``(B,)``.  Paged layouts pass ``phys`` (bgpp) and
    ``page_table`` (dense formats); the slot layout passes neither.
    ``whole``: the unsharded launch's ``(B, Hk)`` on a mesh rank.
    Returns f32 ``(B, Hq, Dh)`` matching the engine's attend."""
    fmt = layout.kv_format
    slot = layout.layout != "paged"
    table = None
    if not slot:
        table = (phys if fmt == "bgpp" else page_table).to(torch.int32).contiguous()
    pool = _pool_views(store, gi, fmt, slot)
    return _attend_local(q1, pool, pos.to(torch.int32).contiguous(), table, cfg, layout,
                         whole)
