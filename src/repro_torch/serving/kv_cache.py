"""KV-cache containers for the serving engine (PyTorch).

Counterpart of :mod:`repro.serving.kv_cache` for transformer attention
stacks (the dense, MoE and VLM families), the mamba state of the ssm
family and of the hybrid's mamba layers (beside its global attention
layers' store): ``mamba`` ``{"h": (L_mamba, B, H, P, N) f32, "conv":
(L_mamba, B, K - 1, d_in + 2 N)}``, slot-major in both layouts, the same
bytes at any ``max_seq`` (mamba2-1.3b: 101.9 MB a slot), and whisper's cross-attention
memory: ``cross_k`` / ``cross_v`` ``(L, B, Hk, encoder_seq, Dh)`` in the
model dtype whatever the KV format, slot-major in both layouts, filled by
the caller from the encoder (whisper-medium: 147.5 MB a slot).  A whisper
decoder's self-attention layers are global layers like any other.  Mixed
local/global stacks (gemma3's 5:1 sliding-window layers, llama4-scout's
3:1 chunked-local ones) keep two
stores: the global layers hold the whole sequence, the local layers a ring
of ``local_window`` lanes a slot (lane ``pos % window``; the window is
the sliding window or the attention chunk, at most ``max_seq``) with each
lane's absolute position in ``abs_pos`` (-1 = empty).  A stack of rings
only (mixtral) has no global store, no page table and no page pool; its
global ``kv_read`` term is 0.  Three storage formats:

  bf16 — dense baseline (the model dtype).
  int8 — per-token/head symmetric INT8 K and V (+ f32 scales).
  bgpp — K magnitudes as packed bit-planes (+ sign plane, + scale) so the
         BGPP predictor fetches one plane per round; V stays int8.

Two physical layouts for the global stacks (``CacheLayout.layout``):

  slot  — heads-major ``(L, B, Hk, S, ...)`` rows, one per batch slot.
  paged — token-major pools ``(L, num_pages * page_size, Hk, ...)`` with no
          batch dim, addressed through a ``(B, S_max // page_size)`` page
          table (``-1`` = unmapped).  Reads gather the slot's logical row
          back into the slot layout's heads-major view, so attention sees
          bit-identical values.

The local rings are slot-major ``(L_local, B, Hk, W, ...)`` in both
layouts, int8 for the int8 and bgpp formats (BGPP targets the long global
rows) and the model dtype for bf16.

Writes update the cache IN PLACE (JAX's arrays were immutable and every
write returned a new tree; the port mutates the tensors and returns the
same store for call-site parity).  The reference relies on JAX dropping
out-of-range scatters (padded chunk lanes at :data:`OOB_INDEX`, unmapped
pages); ``index_put_`` has no such mode, so writes mask those lanes
explicitly — without a host sync: a dropped lane repeats the first kept
lane's write (same target, same value), and when no lane is kept every lane
rewrites one row with its own old contents.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import require_served
from repro_torch.core import bitslice
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.bgpp_paged_attend import ref as _bgpp_ref
from repro_torch.models import mamba2
from repro_torch.models.layers import _dtype

Tree = Dict[str, Any]

NBITS = bitslice.WEIGHT_MAG_BITS  # 7 magnitude planes + sign

# write target of padded / out-of-range lanes (never a real row)
OOB_INDEX = 1 << 30

@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """Static description of one model's decode cache."""

    arch: str
    family: str
    batch: int
    max_seq: int
    kv_format: str  # bf16 | int8 | bgpp
    global_layers: Tuple[int, ...] = ()
    local_layers: Tuple[int, ...] = ()  # ring-buffered sliding / chunked layers
    local_window: int = 0  # ring lanes a slot (the window, at most max_seq)
    mamba_layers: Tuple[int, ...] = ()  # layers of a mamba mixer (no KV)
    has_cross: bool = False  # whisper's encoder memory (cross_k / cross_v)
    layout: str = "slot"  # slot | paged (global stores only)
    page_size: int = 0  # tokens per page (paged layout)
    num_pages: int = 0  # physical pages in each layer's pool (paged layout)

    @property
    def pages_per_slot(self) -> int:
        """Logical pages needed to map one slot's full ``max_seq`` row."""
        return -(-self.max_seq // self.page_size) if self.page_size else 0


def layout_for(cfg, batch: int, max_seq: int, kv_format: str = "int8",
               layout: str = "slot", page_size: int = 8,
               num_pages: Optional[int] = None) -> CacheLayout:
    """Derive a :class:`CacheLayout` from a model config: each layer is a
    mamba layer (its state), a global layer (full-sequence store) or a
    local one (a ring of its sliding or chunked window); ``layout="paged"``
    sizes the shared pool of the global store (default capacity = the
    dense allocation; with no global layer nothing is allocated)."""
    require_served(cfg, "layout_for")
    glob, loc, mamba, window = [], [], [], 0
    for i in range(cfg.num_layers):
        if not cfg.layer_is_attention(i):
            mamba.append(i)
            continue
        kind, w = cfg.layer_attn_window(i)
        if kind in ("sliding", "chunked") and w > 0:
            loc.append(i)
            window = w
        else:
            glob.append(i)
    if kv_format not in ("bf16", "int8", "bgpp"):
        raise ValueError(f"layout_for: unknown kv_format {kv_format!r}")
    if layout == "paged":
        if page_size < 1:
            raise ValueError("layout_for: paged layout needs page_size >= 1")
        pages_per_slot = -(-max_seq // page_size)
        num_pages = batch * pages_per_slot if num_pages is None else num_pages
    elif layout == "slot":
        page_size, num_pages = 0, 0
    else:
        raise ValueError(f"layout_for: unknown layout {layout!r}")
    return CacheLayout(
        arch=cfg.name, family=cfg.family, batch=batch, max_seq=max_seq,
        kv_format=kv_format, global_layers=tuple(glob), local_layers=tuple(loc),
        local_window=min(window, max_seq) if window else 0, mamba_layers=tuple(mamba),
        has_cross=cfg.family == "enc_dec", layout=layout, page_size=page_size,
        num_pages=num_pages,
    )


# --------------------------------------------------------------------------
# allocation
# --------------------------------------------------------------------------


def _kv_leaves(lead: Tuple[int, ...], Hk, Dh, fmt, dtype, device) -> Tree:
    """Zero leaves of one store; ``lead`` is ``(L, B, Hk, S)`` (slot,
    heads-major) or ``(L, n_tok, Hk)`` (paged, token-major)."""
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    if fmt == "bf16":
        return {"k": z(lead + (Dh,), dtype), "v": z(lead + (Dh,), dtype)}
    if fmt == "int8":
        return {"k": z(lead + (Dh,), torch.int8), "v": z(lead + (Dh,), torch.int8),
                "k_scale": z(lead, torch.float32), "v_scale": z(lead, torch.float32)}
    if fmt == "bgpp":
        if Dh % 8:
            raise ValueError(f"bgpp KV needs head_dim % 8 == 0, got {Dh}")
        return {
            "k_planes": z(lead[:1] + (NBITS,) + lead[1:] + (Dh // 8,), torch.uint8),
            "k_sign": z(lead + (Dh // 8,), torch.uint8),
            "k_scale": z(lead, torch.float32),
            "v": z(lead + (Dh,), torch.int8),
            "v_scale": z(lead, torch.float32),
        }
    raise ValueError(fmt)


def local_format(layout: CacheLayout) -> str:
    """Storage format of the local rings: int8 under the int8 and bgpp
    formats, bf16 (the model dtype) under bf16."""
    return "int8" if layout.kv_format == "bgpp" else layout.kv_format


def _kv_pool_specs(kv_format: str) -> Tree:
    """Logical axes of a paged pool: heads only (pool rows belong to any
    slot, so neither batch nor seq shards the token axis)."""
    if kv_format == "bf16":
        ax = (sh.LAYERS, None, sh.KV_HEADS, None)
        return {"k": ax, "v": ax}
    if kv_format == "int8":
        s = {}
        for n in ("k", "v"):
            s[n] = (sh.LAYERS, None, sh.KV_HEADS, None)
            s[f"{n}_scale"] = (sh.LAYERS, None, sh.KV_HEADS)
        return s
    if kv_format == "bgpp":
        return {"k_planes": (sh.LAYERS, None, None, sh.KV_HEADS, None),
                "k_sign": (sh.LAYERS, None, sh.KV_HEADS, None),
                "k_scale": (sh.LAYERS, None, sh.KV_HEADS),
                "v": (sh.LAYERS, None, sh.KV_HEADS, None),
                "v_scale": (sh.LAYERS, None, sh.KV_HEADS)}
    raise ValueError(kv_format)


def _kv_stack_specs(kv_format: str) -> Tree:
    """Logical axes of slot-major stacks: batch and heads (bgpp: no seq
    sharding, its top-k takes global indices)."""
    if kv_format == "bf16":
        ax = (sh.LAYERS, sh.BATCH, sh.KV_HEADS, sh.SEQ, None)
        return {"k": ax, "v": ax}
    if kv_format == "int8":
        s = {}
        for n in ("k", "v"):
            s[n] = (sh.LAYERS, sh.BATCH, sh.KV_HEADS, sh.SEQ, None)
            s[f"{n}_scale"] = (sh.LAYERS, sh.BATCH, sh.KV_HEADS, sh.SEQ)
        return s
    if kv_format == "bgpp":
        return {"k_planes": (sh.LAYERS, None, sh.BATCH, sh.KV_HEADS, None, None),
                "k_sign": (sh.LAYERS, sh.BATCH, sh.KV_HEADS, None, None),
                "k_scale": (sh.LAYERS, sh.BATCH, sh.KV_HEADS, None),
                "v": (sh.LAYERS, sh.BATCH, sh.KV_HEADS, None, None),
                "v_scale": (sh.LAYERS, sh.BATCH, sh.KV_HEADS, None)}
    raise ValueError(kv_format)


def cache_specs(cfg, layout: CacheLayout) -> Tree:
    """Logical-axis specs of :func:`init_cache_arrays`'s tree (pure data,
    the reference's): pools and stacks heads-parallel, slot stacks also
    batch-parallel, the page table replicated.  The mamba state's ``FF``
    is placed by heads on a mesh, not in contiguous blocks
    (:func:`repro_torch.models.mamba2.state_segments`)."""
    specs: Tree = {"pos": (sh.BATCH,)}
    if layout.global_layers:
        if layout.layout == "paged":
            specs["global"] = _kv_pool_specs(layout.kv_format)
            specs["page_table"] = (None, None)
        else:
            specs["global"] = _kv_stack_specs(layout.kv_format)
    if layout.local_layers:
        s = _kv_stack_specs(local_format(layout))
        s["abs_pos"] = (sh.LAYERS, sh.BATCH, None)
        specs["local"] = s
    if layout.mamba_layers:
        specs["mamba"] = {"h": (sh.LAYERS, sh.BATCH, sh.FF, None, None),
                          "conv": (sh.LAYERS, sh.BATCH, None, sh.FF)}
    if layout.has_cross:
        specs["cross_k"] = (sh.LAYERS, sh.BATCH, sh.KV_HEADS, None, None)
        specs["cross_v"] = (sh.LAYERS, sh.BATCH, sh.KV_HEADS, None, None)
    return specs


def init_cache_arrays(cfg, layout: CacheLayout, device="cuda") -> Tree:
    """Cache tree of zeros on ``device``: per-slot ``pos`` ``(B,)`` int32,
    the ``global`` store and (paged) the ``(B, pages_per_slot)`` page table
    of ``-1`` (unmapped) where there are global layers, and the ``local``
    rings with ``abs_pos`` ``(L_local, B, W)`` of ``-1`` where there are
    local ones, the ``mamba`` state (zero) where there are mamba
    layers, and ``cross_k`` / ``cross_v`` (zero) ``(num_layers, B, Hk,
    encoder_seq, Dh)`` in the model dtype where the layout has cross
    memory."""
    B, S, L = layout.batch, layout.max_seq, len(layout.global_layers)
    Hk, Dh = cfg.num_kv_heads, cfg.head_dim
    dtype = _dtype(cfg.dtype)
    cache: Tree = {"pos": torch.zeros((B,), dtype=torch.int32, device=device)}
    if L:
        if layout.layout == "paged":
            lead = (L, layout.num_pages * layout.page_size, Hk)
            cache["page_table"] = torch.full((B, layout.pages_per_slot), -1,
                                             dtype=torch.int32, device=device)
        else:
            lead = (L, B, Hk, S)
        cache["global"] = _kv_leaves(lead, Hk, Dh, layout.kv_format, dtype, device)
    if layout.local_layers:
        nl, W = len(layout.local_layers), layout.local_window
        ring = _kv_leaves((nl, B, Hk, W), Hk, Dh, local_format(layout), dtype, device)
        ring["abs_pos"] = torch.full((nl, B, W), -1, dtype=torch.int32, device=device)
        cache["local"] = ring
    if layout.mamba_layers:  # each mamba layer's decode state, stacked
        one = mamba2.init_mixer_state(cfg, B, dtype, device)
        cache["mamba"] = {n: a.expand((len(layout.mamba_layers),) + a.shape).clone()
                          for n, a in one.items()}
    if layout.has_cross:
        shape = (cfg.num_layers, B, Hk, cfg.encoder_seq, Dh)
        cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def cache_bytes(cache: Tree) -> int:
    """Bytes resident across every leaf of a cache tree (the cross memory
    and the mamba state included)."""
    return sum(a.numel() * a.element_size() for v in cache.values()
               for a in (v.values() if isinstance(v, dict) else [v]))


# --------------------------------------------------------------------------
# quantized read/write helpers
# --------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization over the trailing head dim:
    ``(..., Hk, Dh)`` -> ``(int8 values (..., Hk, Dh), f32 scales (..., Hk))``.
    ``round`` is half to even, like ``jnp.round``."""
    if x.ndim < 2:
        raise ValueError(f"quantize_kv wants (..., Hk, Dh), got {tuple(x.shape)}")
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (tests and oracles)."""
    return (q.float() * scale[..., None]).to(dtype)


def k_to_bitplanes(k_q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 K ``(..., Dh)`` -> (packed planes ``(NBITS, ..., Dh/8)``, packed
    sign ``(..., Dh/8)``)."""
    sign, mag = bitslice.to_sign_magnitude(k_q)
    planes = bitslice.bitplanes(mag, NBITS)
    return bitslice.pack_bits(planes, -1), bitslice.pack_bits(sign, -1)


def bitplanes_to_k(planes: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`k_to_bitplanes` -> int32 values."""
    mag = bitslice.from_bitplanes(bitslice.unpack_bits(planes, -1))
    return bitslice.from_sign_magnitude(bitslice.unpack_bits(sign, -1), mag)


# --------------------------------------------------------------------------
# paged addressing — logical position <-> physical pool row
# --------------------------------------------------------------------------
#
# Physical row of logical position p in slot b:
#     page_table[b, p // page_size] * page_size + p % page_size
# Writes drop padded / out-of-range lanes and unmapped pages; reads clamp
# unmapped pages to row 0 — every consumer masks those lanes by position.


def _tok_dim(name: str) -> int:
    # pool token axis after the layer dim; bgpp planes interpose their
    # plane dim: (layer, plane, token, ...)
    return 2 if name == "k_planes" else 1


def phys_table(page_table: torch.Tensor, page_size: int, max_seq: int) -> torch.Tensor:
    """Gather map: ``(B, S_max)`` physical rows for every logical position
    (unmapped pages clamp to row 0 — callers mask by position)."""
    s = torch.arange(max_seq, device=page_table.device)
    pid = page_table[:, s // page_size]
    return torch.where(pid >= 0, pid * page_size + (s % page_size)[None], 0)


def _phys_write(page_table: torch.Tensor, tpos: torch.Tensor, page_size: int,
                max_seq: int, slot=None) -> torch.Tensor:
    """Scatter map: physical rows for logical write targets ``tpos``
    (:data:`OOB_INDEX` where the lane is padded / out of range / its page
    unmapped).  ``slot=None``: tpos ``(B,)``, one row per batch slot;
    ``slot`` an int or a ``(N,)`` tensor: the slot of each lane."""
    n = page_table.shape[-1]
    page = torch.clamp(tpos // page_size, 0, n - 1).long()
    if slot is None:
        slot = torch.arange(page_table.shape[0], device=tpos.device)
    pid = page_table[slot, page]
    ok = (tpos >= 0) & (tpos < max_seq) & (pid >= 0)
    return torch.where(ok, pid * page_size + tpos % page_size, OOB_INDEX)


def paged_entry(store: Tree, idx: int, phys: torch.Tensor) -> Tree:
    """Gather layer ``idx`` of a paged pool into the slot layout's
    heads-major view: phys ``(B, S)`` -> ``(B, Hk, S, ...)`` (bgpp planes
    ``(NBITS, B, Hk, S, D/8)``)."""
    out: Tree = {}
    for n, a in store.items():
        if n == "k_planes":
            out[n] = a[idx][:, phys].movedim(3, 2)
        else:
            out[n] = a[idx][phys].movedim(2, 1)
    return out


def paged_sign(store: Tree, idx: int, phys: torch.Tensor) -> torch.Tensor:
    """Packed sign plane of layer ``idx`` at every logical position:
    ``(B, S)`` -> ``(B, Hk, S, D/8)`` heads-major."""
    return store["k_sign"][idx][phys].movedim(2, 1)


def paged_plane(store: Tree, idx: int, plane: int, phys: torch.Tensor) -> torch.Tensor:
    """ONE packed magnitude plane of layer ``idx`` at every logical
    position: ``(B, S)`` -> ``(B, Hk, S, D/8)`` heads-major."""
    return store["k_planes"][idx, plane][phys].movedim(2, 1)


# per-head logical indices (B, Hk, k) -> physical pool rows (B, Hk, k)
paged_rows_at = _bgpp_ref.rows_at


def paged_plane_rows(store: Tree, idx: int, plane: int, rows: torch.Tensor) -> torch.Tensor:
    """ONE packed magnitude plane at surviving physical rows only: rows
    ``(B, Hk, k)`` -> ``(B, Hk, k, D/8)`` (head ``h`` reads only its slice)."""
    return _bgpp_ref.rows_per_head(store["k_planes"][idx, plane], rows, False)


def paged_topk_entry(store: Tree, idx: int, rows: torch.Tensor) -> Tree:
    """Phase-2 gather: the surviving tokens' full-precision bgpp rows,
    compacted: rows ``(B, Hk, k)`` -> ``{k_planes (NBITS, B, Hk, k, D/8),
    k_sign (B, Hk, k, D/8), k_scale (B, Hk, k), v (B, Hk, k, D), v_scale}``."""
    return {n: _bgpp_ref.rows_per_head(a[idx], rows, n == "k_planes")
            for n, a in store.items()}


def identity_page_table(layout: CacheLayout, device="cuda") -> torch.Tensor:
    """Slot-major mapping (slot b, page j) -> physical page ``b*n + j``."""
    B, n = layout.batch, layout.pages_per_slot
    if B * n > layout.num_pages:
        raise ValueError("identity_page_table: table exceeds the pool")
    return torch.arange(B * n, dtype=torch.int32, device=device).reshape(B, n)


def zero_pages(store: Tree, page_ids, page_size: int) -> Tree:
    """Scrub physical pages (freed by the allocator) in place across EVERY
    pool leaf of every layer.  ``page_ids`` is host data (a sequence or
    array; ``-1`` entries are ignored)."""
    ids = np.asarray(page_ids, np.int64).reshape(-1)
    ids = ids[ids >= 0]
    if ids.size == 0:
        return store
    rows = (ids[:, None] * page_size + np.arange(page_size)[None]).reshape(-1)
    for n, a in store.items():
        r = torch.as_tensor(rows, device=a.device)
        if n == "k_planes":
            a[:, :, r] = 0
        else:
            a[:, r] = 0
    return store


def zero_token_range(store: Tree, tpos, *, page_table=None, page_size: int = 0,
                     max_seq: int = 0) -> Tree:
    """Zero per-slot logical token positions in place across EVERY leaf of
    a global KV store — the speculative-decode rollback scrub.

    ``tpos`` is ``(B, N)`` (a tensor or host array): for each batch slot,
    up to ``N`` positions whose rows held speculative writes past the
    accepted frontier; lanes outside ``[0, max_seq)`` (e.g.
    :data:`OOB_INDEX`) drop.  ``page_table`` selects the paged pool:
    positions are translated through each slot's table row and lanes on
    unmapped pages drop (:func:`zero_pages` scrubs pages the allocator
    freed).  The slot path zeroes the per-slot rows.  Both cover k/v
    bodies, int8 scales and bgpp sign and magnitude planes alike."""
    dev = next(iter(store.values())).device
    tpos = torch.as_tensor(tpos, device=dev).long()
    ok = (tpos >= 0) & (tpos < max_seq)
    if page_table is not None:
        table = torch.as_tensor(page_table, device=dev).long()
        page = torch.clamp(torch.div(tpos, page_size, rounding_mode="floor"), 0,
                           table.shape[-1] - 1)
        pid = torch.gather(table, 1, page)
        ok &= pid >= 0
        rows = (pid * page_size + tpos % page_size)[ok]
        for n, a in store.items():
            if n == "k_planes":
                a[:, :, rows] = 0
            else:
                a[:, rows] = 0
        return store
    ok &= tpos < store["k_sign" if "k_planes" in store else "k"].shape[3]
    b = torch.arange(tpos.shape[0], device=dev)[:, None].expand_as(tpos)[ok]
    s = tpos[ok]
    for n, a in store.items():
        if n == "k_planes":  # (L, NBITS, B, Hk, S, D/8)
            a[:, :, b, :, s] = 0
        else:  # (L, B, Hk, S, ...)
            a[:, b, :, s] = 0
    return store


def page_bytes(store: Tree, page_size: int) -> int:
    """Bytes one physical page occupies across every leaf of a pool."""
    total = 0
    for n, a in store.items():
        total += a.numel() * a.element_size() * page_size // a.shape[_tok_dim(n)]
    return total


# --------------------------------------------------------------------------
# KV-read accounting — bytes the decode / chunk steps gather
# --------------------------------------------------------------------------


def _cache_dtype_bytes(cfg) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def _token_row_bytes(cfg, fmt: str) -> float:
    """Bytes one token's KV row (all ``Hk`` heads, K and V plus scales)
    occupies in a store of format ``fmt``."""
    Hk, Dh = cfg.num_kv_heads, cfg.head_dim
    if fmt == "bf16":
        return Hk * Dh * _cache_dtype_bytes(cfg) * 2.0
    if fmt == "int8":
        return Hk * (2.0 * Dh + 8.0)  # int8 K+V, two f32 scales
    if fmt == "bgpp":
        # packed planes + sign plane + k_scale + int8 V + v_scale: the FULL
        # row phase 2 fetches per surviving token
        return Hk * (NBITS * Dh / 8.0 + Dh / 8.0 + 4.0 + Dh + 4.0)
    raise ValueError(fmt)


def mesh_shard_factors(layout: CacheLayout, cfg, mesh_shape) -> Tuple[int, int]:
    """``(d_eff, m_eff)``: how many ways a ``(data, model)`` mesh splits a
    decode step's KV reads.  A ``"model"`` axis that does not divide BOTH
    head counts replicates (q shards alongside k / v, so the attend stays
    local), and a ``"data"`` axis that does not divide the batch
    replicates."""
    d, m = int(mesh_shape[0]), int(mesh_shape[1])
    Hq, Hk = cfg.num_heads, cfg.num_kv_heads
    m_eff = m if m >= 1 and Hk and Hq and Hk % m == 0 and Hq % m == 0 else 1
    d_eff = d if d >= 1 and layout.batch % d == 0 else 1
    return d_eff, m_eff


def _interconnect_decode(layout: CacheLayout, cfg, d_eff: int, m_eff: int) -> Dict[str, float]:
    """Collective bytes ONE batched decode step moves between ranks: the
    f32 per-head attend outputs ``(B, Hq, Dh)`` all-gathered over
    ``"model"`` each attention layer (``attend_allgather``), and, paged,
    the step's B K/V rows of every global layer sent to each other
    ``"data"`` replica of the pool (``paged_write_bcast``)."""
    B = layout.batch
    ng, nl = len(layout.global_layers), len(layout.local_layers)
    attend = (m_eff - 1) * B * cfg.num_heads * cfg.head_dim * 4.0 * (ng + nl)
    paged_w = 0.0
    if layout.layout == "paged" and ng:
        paged_w = (d_eff - 1) * B * ng * _token_row_bytes(cfg, layout.kv_format)
    return {"attend_allgather": attend, "paged_write_bcast": paged_w,
            "total": attend + paged_w}


def bgpp_decode_plan(S: int, cfg) -> Tuple[int, int, Tuple[int, ...]]:
    """Static shapes of one two-phase BGPP decode attend over ``S`` lanes:
    ``(rounds, k_max, survivors)`` with ``survivors[r]`` the candidate-set
    width round ``r`` fetches (``S`` at round 0, then ``max(k_max, S >> r)``).
    The engine takes its widths from here and :func:`decode_read_bytes`
    prices the same tuple."""
    mo = cfg.mcbp
    if S < 1:
        raise ValueError(f"bgpp_decode_plan: cache width S={S} must be >= 1")
    if mo.bgpp_rounds < 1:
        raise ValueError(
            f"bgpp_decode_plan: bgpp_rounds={mo.bgpp_rounds} must be >= 1 "
            f"(round 0 always scans the MSB plane)"
        )
    if not (0.0 < mo.bgpp_keep_ratio <= 1.0):
        raise ValueError(
            f"bgpp_decode_plan: bgpp_keep_ratio={mo.bgpp_keep_ratio} must be "
            f"in (0, 1]"
        )
    rounds = max(1, min(mo.bgpp_rounds, NBITS))
    k_max = max(1, min(S, int(math.ceil(mo.bgpp_keep_ratio * S))))
    survivors = (S,) + tuple(max(k_max, S >> r) for r in range(1, rounds))
    return rounds, k_max, survivors


def decode_read_bytes(layout: CacheLayout, cfg,
                      mesh_shape: Tuple[int, int] = (1, 1)) -> Dict[str, Any]:
    """KV bytes ONE batched decode step gathers, at its static shapes: all
    ``layout.batch`` rows and every layer; global bf16/int8 read the full
    ``(S_max,)`` row; global bgpp follows the two-phase plan (sign + MSB
    plane everywhere, shrinking survivor planes, ``k_max`` full rows);
    local rings read their ``window`` in their own format.
    ``bf16_equiv`` is what a bf16 cache of the same geometry reads.  The
    mamba state and the cross memory are not counted, as in the reference:
    an ssm layout reads 0 B here though its step reads and writes the
    whole state, and a whisper step also reads every layer's cross K / V
    (147.5 MB a slot at whisper-medium).

    ``per_device`` divides the counters by the mesh's effective shards
    (reads split over ``"data"`` by batch and over ``"model"`` by heads,
    :func:`mesh_shard_factors`); ``interconnect`` prices the collectives
    (:func:`_interconnect_decode`).  At mesh 1x1 per-device equals total
    and interconnect is zero."""
    B, S, W = layout.batch, layout.max_seq, layout.local_window
    ng, nl = len(layout.global_layers), len(layout.local_layers)
    out: Dict[str, Any] = {"global": 0.0, "local": 0.0}
    if ng and layout.kv_format == "bgpp":
        rounds, k_max, survivors = bgpp_decode_plan(S, cfg)
        plane_row = cfg.num_kv_heads * cfg.head_dim / 8.0
        sign = S * plane_row
        planes = float(sum(survivors)) * plane_row
        topk_full = k_max * _token_row_bytes(cfg, "bgpp")
        out["bgpp"] = {
            "rounds": rounds,
            "full_rows_per_slot": k_max,
            "sign_bytes": B * ng * sign,
            "plane_bytes": B * ng * planes,
            "topk_full_bytes": B * ng * topk_full,
        }
        out["global"] = B * ng * (sign + planes + topk_full)
    elif ng:
        out["global"] = B * ng * S * _token_row_bytes(cfg, layout.kv_format)
    if nl:
        out["local"] = B * nl * W * _token_row_bytes(cfg, local_format(layout))
    out["total"] = out["global"] + out["local"]
    out["bf16_equiv"] = (B * ng * S + B * nl * W) * _token_row_bytes(cfg, "bf16")
    d_eff, m_eff = mesh_shard_factors(layout, cfg, mesh_shape)
    shards = d_eff * m_eff
    out["per_device"] = {"global": out["global"] / shards, "local": out["local"] / shards,
                         "total": out["total"] / shards, "shards": shards}
    out["interconnect"] = _interconnect_decode(layout, cfg, d_eff, m_eff)
    return out


def chunk_read_bytes(layout: CacheLayout, cfg, mesh_shape: Tuple[int, int] = (1, 1),
                     chunk_width: int = 1) -> Dict[str, Any]:
    """KV bytes ONE chunked-prefill step reads (one slot): every global
    layer attends the full ``(S_max,)`` row at full precision (BGPP's
    prediction is a decode-time saving) and every local layer gathers its
    ``window``.  A B=1 chunk shards over ``"model"`` only; its attend
    all-gather moves ``chunk_width`` lanes of ``Hq * Dh`` at the cache
    dtype, and no paged write is broadcast (every data replica runs the
    chunk and writes its own pool)."""
    ng, nl = len(layout.global_layers), len(layout.local_layers)
    g = ng * layout.max_seq * _token_row_bytes(cfg, layout.kv_format)
    loc = nl * layout.local_window * _token_row_bytes(cfg, local_format(layout))
    out: Dict[str, Any] = {"global": g, "local": loc, "total": g + loc}
    _, m_eff = mesh_shard_factors(layout, cfg, mesh_shape)
    out["per_device"] = {"total": out["total"] / m_eff, "shards": m_eff}
    attend = ((m_eff - 1) * chunk_width * cfg.num_heads * cfg.head_dim
              * _cache_dtype_bytes(cfg) * (ng + nl))
    out["interconnect"] = {"attend_allgather": attend, "paged_write_bcast": 0.0,
                           "total": attend}
    return out


# --------------------------------------------------------------------------
# stack writes — one code path for bf16 / int8 / bgpp stores
# --------------------------------------------------------------------------
#
# The format is inferred from the store's keys (``k_planes`` => bgpp,
# ``k_scale`` => int8, else bf16).  Every write is a list of lanes (slot,
# logical position, K/V row); padded lanes never reach the store.


def _encode(store: Tree, k: torch.Tensor, v: torch.Tensor) -> Tree:
    """Fresh rows ``(N, Hk, Dh)`` -> per-leaf lane-first values ``(N, ...)``
    in the store's format (bgpp planes ``(N, NBITS, Hk, Dh/8)``)."""
    if "k_planes" in store:
        kq, ks = quantize_kv(k)
        planes, sign = k_to_bitplanes(kq)
        vq, vs = quantize_kv(v)
        return {"k_planes": planes.movedim(0, 1), "k_sign": sign, "k_scale": ks,
                "v": vq, "v_scale": vs}
    if "k_scale" in store:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k.to(store["k"].dtype), "v": v.to(store["v"].dtype)}


def _drop_lanes(ok: torch.Tensor):
    """Lane map that drops the lanes where ``ok`` is False without a host
    sync: ``(src, none)`` where a dropped lane takes the first kept lane's
    write (``src``), and ``none`` is True when no lane is kept (every lane
    then rewrites target 0 with its old value)."""
    lanes = torch.arange(ok.shape[0], device=ok.device)
    first = torch.argmax(ok.to(torch.int32))  # first kept lane (0 if none)
    return torch.where(ok, lanes, first), ~ok.any()


def _write_lanes(store: Tree, idx: int, b: torch.Tensor, tpos: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, page_table, page_size: int,
                 max_seq: int) -> Tree:
    """Write rows ``k``/``v`` ``(N, Hk, Dh)`` of slots ``b`` ``(N,)`` at
    logical positions ``tpos`` ``(N,)`` into layer ``idx``, in place.
    Lanes outside the row (``max_seq`` paged, the stack's S slot) and,
    paged, lanes on unmapped pages drop."""
    vals = _encode(store, k, v)
    if page_table is not None:
        rows = _phys_write(page_table, tpos, page_size, max_seq, slot=b)
        src, none = _drop_lanes(rows != OOB_INDEX)
        rows = torch.where(none, 0, rows[src])
        for n, a in store.items():
            layer = a[idx]
            if n == "k_planes":
                layer[:, rows] = torch.where(none, layer[:, 0], vals[n][src]).movedim(0, 1)
            else:
                layer[rows] = torch.where(none, layer[0], vals[n][src])
        return store
    S = store["k_sign" if "k_planes" in store else "k"].shape[3]
    src, none = _drop_lanes((tpos >= 0) & (tpos < S))
    b = torch.where(none, 0, b[src])
    s = torch.where(none, 0, tpos[src]).long()
    for n, a in store.items():
        if n == "abs_pos":  # a ring's positions: its writer sets them
            continue
        layer = a[idx]
        if n == "k_planes":  # (NBITS, B, Hk, S, D/8)
            layer[:, b, :, s] = torch.where(none, layer[:, 0, :, 0], vals[n][src])
        else:  # (B, Hk, S, ...)
            layer[b, :, s] = torch.where(none, layer[0, :, 0], vals[n][src])
    return store


def write_token(store: Tree, idx: int, k: torch.Tensor, v: torch.Tensor,
                tpos: torch.Tensor, *, page_table=None, page_size: int = 0,
                max_seq: int = 0) -> Tree:
    """Write one decode token per slot into layer ``idx``, in place.

    k/v: ``(B, 1, Hk, Dh)``; tpos: ``(B,)`` per-slot target index — the
    absolute position in a global store, ``pos % window`` in a local ring
    (whose ``abs_pos`` the caller sets).
    ``page_table`` selects the paged pool (unmapped page => dropped write);
    positions outside ``[0, max_seq)`` drop in both layouts."""
    B = k.shape[0]
    b = torch.arange(B, device=k.device)
    return _write_lanes(store, idx, b, tpos.long(), k[:, 0], v[:, 0], page_table,
                        page_size, max_seq)


def write_prefill(store: Tree, idx: int, k: torch.Tensor, v: torch.Tensor,
                  *, slot: Optional[int] = None, offset: Optional[int] = None,
                  length: Optional[int] = None, page_table=None,
                  page_size: int = 0, max_seq: int = 0) -> Tree:
    """Write a prompt's K/V into a global stack, in place.

    k/v: ``(B, S, Hk, Dh)``.  ``slot=None`` writes every batch row at
    positions ``[0, S)``; ``slot=b`` (``B == 1``) writes one row of a live
    cache.  ``offset``/``length`` select the chunked-admission path: the
    first ``length`` lanes land at ``[offset, offset+length)`` of ``slot``;
    padded lanes are never written.  ``page_table`` selects the paged pool
    (writes to unmapped pages drop)."""
    B, S = k.shape[:2]
    dev = k.device
    if offset is not None or slot is not None:
        if slot is None or B != 1:
            raise ValueError("write_prefill: chunked / slot writes admit one "
                             "prompt (B == 1) into one slot")
        n = S if length is None else int(length)
        off = 0 if offset is None else int(offset)
        tpos = off + torch.arange(n, device=dev)
        b = torch.full((n,), int(slot), device=dev)
        kk, vv = k[0, :n], v[0, :n]
    else:
        tpos = torch.arange(S, device=dev).repeat(B)
        b = torch.arange(B, device=dev).repeat_interleave(S)
        kk, vv = k.reshape(B * S, *k.shape[2:]), v.reshape(B * S, *v.shape[2:])
    return _write_lanes(store, idx, b, tpos, kk, vv, page_table, page_size, max_seq)


def write_prefill_local(store: Tree, idx: int, k: torch.Tensor, v: torch.Tensor,
                        window: int, *, slot: Optional[int] = None,
                        offset: Optional[int] = None,
                        length: Optional[int] = None) -> Tree:
    """Ring-write a prompt's last ``min(window, S)`` positions into local
    layer ``idx`` (lane ``pos % window``), in place, recording each lane's
    absolute position in ``abs_pos``.

    k/v: ``(B, S, Hk, Dh)``.  ``slot`` selects one batch row (``B == 1``)
    as in :func:`write_prefill`.  ``offset`` / ``length`` select the
    chunked-admission path: the first ``length`` lanes are the chunk's
    tokens at ``[offset, offset + length)``, and only the last
    ``min(length, window)`` of them are written (the earlier ones would be
    evicted by them; padded lanes never land)."""
    B, S = k.shape[:2]
    dev = k.device
    if offset is not None or slot is not None:
        if slot is None or B != 1:
            raise ValueError("write_prefill_local: chunked / slot writes admit one "
                             "prompt (B == 1) into one slot")
        off = 0 if offset is None else int(offset)
        n = S if length is None else int(length)
        lo = max(0, n - window)
        apos = off + torch.arange(lo, n, device=dev)
        b = torch.full((n - lo,), int(slot), device=dev)
        kk, vv = k[0, lo:n], v[0, lo:n]
    else:
        lo = max(0, S - window)
        apos = torch.arange(lo, S, device=dev).repeat(B)
        b = torch.arange(B, device=dev).repeat_interleave(S - lo)
        kk = k[:, lo:].reshape(-1, *k.shape[2:])
        vv = v[:, lo:].reshape(-1, *v.shape[2:])
    lane = apos % window
    _write_lanes(store, idx, b, lane, kk, vv, None, 0, 0)
    store["abs_pos"][idx, b, lane] = apos.to(torch.int32)
    return store


# --------------------------------------------------------------------------
# slot lifecycle
# --------------------------------------------------------------------------


def reset_slot(cache: Tree, layout: CacheLayout, slot: int,
               row: Optional[int] = None, state_row: Optional[int] = None) -> Tree:
    """Clear one batch row in place: its global KV rows to zero (slot
    layout), its local rings to zero with ``abs_pos`` -1 (both layouts, so
    a previous occupant's lanes never alias into the new request's window),
    its mamba state and cross memory to zero and ``pos[slot]`` to 0.  Paged
    pools have no batch rows — page lifecycle belongs to
    :class:`repro_torch.serving.paging.PageAllocator`.  ``row`` is the
    slot's row in a mesh rank's slot-major stores (default ``slot``; -1:
    another rank holds it, and only ``pos`` is cleared here);
    ``state_row`` its row in the rank's mamba state and cross memory,
    which are slot-major in both layouts (default ``row``:
    :meth:`repro_torch.serving.sharded.Shard.state_row`)."""
    row = slot if row is None else row
    state_row = row if state_row is None else state_row
    rows = {"mamba": state_row}
    stores = ("local", "mamba") if layout.layout == "paged" else ("global", "local", "mamba")
    for name in stores:
        r = rows.get(name, row)
        if r < 0:
            continue
        for n, a in cache.get(name, {}).items():
            if n == "k_planes":
                a[:, :, r] = 0
            else:
                a[:, r] = -1 if n == "abs_pos" else 0
    for n in ("cross_k", "cross_v"):
        if n in cache and state_row >= 0:
            cache[n][:, state_row] = 0
    cache["pos"][slot] = 0
    return cache
