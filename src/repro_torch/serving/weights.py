"""Serve-time weight formats: the ``weight_format`` knob.

Counterpart of :mod:`repro.serving.weights`.  ``MCBPOptions.weight_format``
selects the numerics of the decode-time projections (``wq``/``wk``/``wv``/
``wo``, the dense MLP, ``lm_head``).  As in the reference, only these
explicit names convert: an MoE layer's router, expert banks and shared
expert stay raw in every format, and ``weight_read`` prices attention and
the head alone (the routed experts' reads are not counted):

* ``"bf16"`` — the raw parameter leaves, untouched;
* ``"int8"`` — per-output-channel symmetric int8: each projection becomes
  a ``{"q": int8 (..., in, out), "scale": f32 (..., out)}`` record, which
  ``layers.wdot`` contracts as the reference does, against the dense
  reconstruction ``q * scale`` in the activation dtype;
* ``"bstc"`` — the same int8 values, stored two-state coded (paper §3.2).
  The record is ``{"bstc": operands, "scale": f32}`` with one
  :class:`~repro_torch.kernels.bstc_matmul.BSTCMatmulOperands` per stacked
  layer copy (each copy has its own pattern capacities), so the card holds
  the coded planes the ``weight_read`` counter prices, and ``wdot`` runs
  the fused decode + GEMV kernel on them.  This departs from the reference
  on purpose: its ``serve_step`` contracts bstc records by dense
  reconstruction and never runs its ``bstc_matmul`` kernel.  A matrix whose
  dims do not divide the coding grid (``out % m`` or ``in % 8``) is served
  as an int8 record, as the reference prices it.

The format is resolved once, when a serve step is built (:func:`resolve`),
from the config; the Scheduler's ``weight_format`` argument overrides the
config before that.  The reference's ``REPRO_WEIGHT_FORMAT`` environment
override is not ported: the port reads no environment knobs.

Accounting mirrors ``kv_cache.decode_read_bytes``: the scheduler holds a
:class:`WeightPlan` and adds its static per-step bytes per executed decode
step into ``Scheduler.stats()["weight_read"]`` — totals, the bf16 and int8
equivalents, a per-projection breakdown and the closed-form modeled bytes
(``analysis.roofline.bstc_weight_traffic``), and the reference's mesh
columns: ``wq`` / ``wk`` / ``wv`` and the vocab-split ``lm_head`` are
column-parallel on ``"model"``, ``wo`` and the MLP replicated, so every
rank reads them whole (:attr:`WeightEntry.placement`).

On a mesh the plan prices the whole matrices, as the reference's does,
while each rank's records are converted from its own shard of the raw
leaves (``local``): a column shard is quantized and coded as a matrix of
its own, so a bstc rank holds and reads only its columns' stream.  The
int8 values are the same either way (the scale is per output column).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.analysis import roofline
from repro_torch.configs.base import WEIGHT_FORMATS
from repro_torch.core import bstc
from repro_torch.kernels.bstc_matmul.ops import (operands_from_encoded,
                                                 reconstruct_dense_weight)
from repro_torch.serving import kv_cache as kvc

Tree = Dict[str, Any]

FORMATS = WEIGHT_FORMATS

# projection leaves the serve path converts (biases, norms and the MoE
# subtree stay raw)
_ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")
_MLP_WEIGHTS = ("gate", "up", "down")
_KERNEL_TILE_K = 512  # H tile of the served operands, where it divides in_dim


def resolve(cfg) -> str:
    """The config's ``weight_format``, one of :data:`FORMATS`."""
    knob = getattr(cfg.mcbp, "weight_format", "bf16")
    if knob not in FORMATS:
        raise ValueError(f"weight_format={knob!r} is not one of {FORMATS} (config "
                         f"mcbp.weight_format)")
    return knob


def validate(cfg) -> None:
    """Raise for a config whose family the record path does not cover
    (called once at serve-step build when the format is not ``bf16``)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"weight_format={resolve(cfg)!r} covers the transformer serve families "
            f"(dense/moe/vlm); family={cfg.family!r} decodes with raw bf16 weights — "
            f"set weight_format='bf16'")


def is_record(w) -> bool:
    """True for a quantized-weight record leaf (int8 ``q`` or coded ``bstc``)."""
    return isinstance(w, dict) and "scale" in w and ("q" in w or "bstc" in w)


def _quantize_matrix(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``(in, out)`` matrix -> (int8 q, f32 scale (out,))."""
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(-2), min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def quantize(w: torch.Tensor) -> Tree:
    """Per-output-channel symmetric int8 record of a ``(..., in, out)``
    weight (leading axes = stacked layer copies): ``scale = max|w| / 127``
    over the input axis, ``q = clip(round(w / scale), ±127)``.  Rounding is
    half to even and the division IEEE, so the record is bit-exact with the
    reference's.  Copies are quantized one at a time (the f32 temporaries
    of one matrix, not of the stack)."""
    lead, (in_dim, out_dim) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
    flat = w.reshape(-1, in_dim, out_dim)
    q = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((flat.shape[0], out_dim), dtype=torch.float32, device=w.device)
    for c in range(flat.shape[0]):
        q[c], scale[c] = _quantize_matrix(flat[c])
    return {"q": q.reshape(w.shape), "scale": scale.reshape(lead + (out_dim,))}


def dequantize(record: Tree, dtype=torch.float32) -> torch.Tensor:
    """The dense reconstruction of an int8 record, ``q * scale`` in f32
    then ``dtype`` — what ``layers.wdot`` contracts against."""
    return (record["q"].to(torch.float32)
            * record["scale"][..., None, :].to(torch.float32)).to(dtype)


def check_serve_params(params: Tree, cfg, fmt: str) -> None:
    """A non-bf16 serve step must receive converted records, never raw
    leaves (probed at ``wq``; an MoE subtree is raw in every format)."""
    lay = params.get("layers", {})
    probe = lay.get("attn", {}).get("wq") if isinstance(lay, dict) else None
    if probe is not None and not is_record(probe):
        raise ValueError(
            f"serve_step was built with weight_format={fmt!r} but received raw weight "
            f"leaves — convert them first with repro_torch.serving.weights."
            f"prepare_serve_params(params, cfg) (the Scheduler does this)")


# --------------------------------------------------------------------------
# the weight-read plan — host-side byte accounting, kv_read's mirror
# --------------------------------------------------------------------------


@dataclasses.dataclass
class WeightEntry:
    """One converted projection (all its stacked layer copies).
    ``placement`` is its serving shard: ``"heads"`` (column-parallel on
    ``"model"``), ``"vocab"`` (the head's columns) or ``"replicated"``
    (``wo`` and the MLP, whose model axis is on the contraction side).
    Byte columns cover ALL ``copies`` of the whole matrix."""

    path: str
    proj: str
    copies: int
    in_dim: int
    out_dim: int
    placement: str
    coded_bytes: float
    int8_bytes: float
    bf16_bytes: float
    modeled_bytes: float
    bstc_fallback: bool = False  # dims indivisible: priced (and served) as int8


@dataclasses.dataclass
class WeightPlan:
    """Static per-step weight traffic of one built serve path: every
    converted projection is read once per batched decode step."""

    fmt: str
    entries: List[WeightEntry]

    def _sum(self, col: str) -> float:
        return float(sum(getattr(e, col) for e in self.entries))

    @property
    def total_bytes(self) -> float:
        """Coded bytes one decode step reads across every converted matrix."""
        return self._sum("coded_bytes")

    @property
    def bf16_bytes(self) -> float:
        """What raw-dtype leaves of the same geometry read."""
        return self._sum("bf16_bytes")

    def decode_read_bytes(self, layout=None, cfg=None,
                          mesh_shape: Tuple[int, int] = (1, 1)) -> Dict[str, Any]:
        """Weight bytes ONE batched ``serve_step`` reads: totals, the bf16
        and int8 equivalents, the closed-form modeled bytes, the
        per-projection breakdown and the mesh columns.  A ``"model"`` axis
        splits only the column-parallel entries (heads by
        :func:`kv_cache.mesh_shard_factors`, the head's vocab where it
        divides); weights never split over ``"data"``.  ``layout`` and
        ``cfg`` are needed off mesh 1x1."""
        m = int(mesh_shape[1])
        m_eff = m_vocab = 1
        if tuple(mesh_shape) != (1, 1):
            _, m_eff = kvc.mesh_shard_factors(layout, cfg, mesh_shape)
            m_vocab = m if m >= 1 and cfg.vocab_size % m == 0 else 1
        shards = {"heads": m_eff, "vocab": m_vocab, "replicated": 1}
        sharded = sum(e.coded_bytes for e in self.entries if shards[e.placement] > 1)
        per_proj: Dict[str, float] = {}
        for e in self.entries:
            per_proj[e.proj] = per_proj.get(e.proj, 0.0) + e.coded_bytes
        return {
            "format": self.fmt,
            "total": self.total_bytes,
            "bf16_equiv": self.bf16_bytes,
            "int8_equiv": self._sum("int8_bytes"),
            "modeled": self._sum("modeled_bytes"),
            "per_projection": per_proj,
            "per_device": {
                "sharded": sharded / max(m_eff, m_vocab, 1),
                "replicated": self.total_bytes - sharded,
                "total": sum(e.coded_bytes / shards[e.placement] for e in self.entries),
                "shards": m_eff,
            },
            # summing per_device_by_placement[p] * shards[p] recovers the total
            "per_device_by_placement": {
                p: sum(e.coded_bytes / shards[p] for e in self.entries if e.placement == p)
                for p in ("heads", "vocab", "replicated")},
            "shards_by_placement": shards,
        }


# --------------------------------------------------------------------------
# serve-params preparation
# --------------------------------------------------------------------------


def _iter_targets(params: Tree) -> Iterator[Tuple[Tuple[str, ...], str, str]]:
    """``(path, proj_name, placement)`` of every convertible leaf present."""
    lay = params.get("layers")
    if isinstance(lay, dict):
        attn = lay.get("attn")
        if isinstance(attn, dict):
            for n in _ATTN_WEIGHTS:
                if n in attn:
                    yield ("layers", "attn", n), n, "replicated" if n == "wo" else "heads"
        mlp = lay.get("mlp")
        if isinstance(mlp, dict):
            for n in _MLP_WEIGHTS:
                if n in mlp:
                    yield ("layers", "mlp", n), n, "replicated"
    if "lm_head" in params:
        yield ("lm_head",), "lm_head", "vocab"


def _get(tree: Tree, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: Tree, path: Tuple[str, ...], value) -> Tree:
    """Copy-on-write set: shallow-copies only the dicts along ``path``, so
    the caller's raw params tree is never mutated."""
    out = dict(tree)
    node = out
    for k in path[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    node[path[-1]] = value
    return out


def _dtype_bytes(cfg) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def _bstc_matrix_bytes(bw: bstc.BSTCWeight, cfg) -> Tuple[float, float]:
    """Measured and modeled coded bytes of ONE encoded ``(out, in)``
    matrix: the stream at ``m`` bits a pattern plus the f32 scales, and
    the closed form on the measured per-plane column sparsities."""
    out_dim, in_dim = bw.shape
    coded = math.ceil(bw.encoded_bits / 8) + 4.0 * out_dim
    # nnz of a coded plane from its stream length: (bits - H*G) / m
    col_sparsity = [
        None if e is None
        else 1.0 - float((e.encoded_bits - e.bitmap.numel()) // e.m) / e.bitmap.numel()
        for e in bw.encoded
    ]
    modeled = roofline.bstc_weight_traffic(
        in_dim, out_dim, m=bw.m, nbits=bw.nbits, col_sparsity=col_sparsity,
        dtype_bytes=_dtype_bytes(cfg))["bstc_bytes"]
    return float(coded), float(modeled)


def _kernel_roundtrip_check(bw: bstc.BSTCWeight, q_t: torch.Tensor) -> None:
    """Round-trip ONE coded matrix through the ``bstc_matmul`` operands
    (``tile_k`` = in_dim) and :func:`reconstruct_dense_weight`, whose plane
    decode is the ``bstc_decode`` kernel on the card: the served values
    pass through the BSTC code path rather than trusting the law."""
    ops = operands_from_encoded(bw, tile_k=bw.shape[1])
    rebuilt = reconstruct_dense_weight(ops).to(torch.int8)
    if not torch.equal(rebuilt, q_t):
        raise AssertionError(
            "BSTC round-trip mismatch: reconstruct_dense_weight did not recover the "
            "int8 weight — the coded layout cannot serve")


def _code(q: torch.Tensor, scale: torch.Tensor, cfg, roundtrip: bool, plan_rows: int = 0):
    """An int8 record's arrays (``(..., in, out)`` q, ``(..., out)`` scale)
    -> ``(bstc record, coded bytes, modeled bytes)``.  Every stacked copy
    is coded channel-major, as ``(out, in)`` (the scale is per output row),
    on the weights' device; the first copy is round-tripped when
    ``roundtrip``.  ``plan_rows``: the whole matrix's output width where
    ``q`` is a rank's column shard (K3 plans at it)."""
    in_dim, out_dim = q.shape[-2:]
    tile_k = _KERNEL_TILE_K if in_dim % _KERNEL_TILE_K == 0 else in_dim
    qs, ss = q.reshape(-1, in_dim, out_dim), scale.reshape(-1, out_dim)
    ops, coded, modeled = [], 0.0, 0.0
    for c in range(qs.shape[0]):
        q_t = qs[c].T.contiguous()
        bw = bstc.encode_weight(q_t, ss[c], m=int(cfg.mcbp.group_size),
                                threshold=float(cfg.mcbp.bstc_threshold))
        cb, mb = _bstc_matrix_bytes(bw, cfg)
        coded += cb
        modeled += mb
        if roundtrip and c == 0:
            _kernel_roundtrip_check(bw, q_t)
        ops.append(operands_from_encoded(bw, tile_k, ss[c], plan_rows))
    rec = {"bstc": ops if q.dim() > 2 else ops[0], "scale": scale}
    return rec, coded, modeled


def _fits_grid(in_dim: int, out_dim: int, cfg) -> bool:
    """Whether a matrix divides the coding grid (``out % m``, ``in % 8``)."""
    return out_dim % int(cfg.mcbp.group_size) == 0 and in_dim % 8 == 0


def bstc_record_from_int8(q: torch.Tensor, scale: torch.Tensor, cfg) -> Tree:
    """The bstc record serving an int8 record's values (the int8 record
    itself where the dims do not divide the coding grid)."""
    if not _fits_grid(*q.shape[-2:], cfg):
        return {"q": q, "scale": scale}
    return _code(q, scale, cfg, roundtrip=False)[0]


def prepare_serve_params(params: Tree, cfg, fmt: Optional[str] = None,
                         local: Optional[Tree] = None) -> Tuple[Tree, WeightPlan]:
    """Convert the decode-time projection leaves for ``fmt`` and price them.

    Returns ``(serve_params, plan)``; ``fmt=None`` resolves from the
    config.  ``"bf16"`` returns the params object untouched with a plan at
    raw-dtype bytes.  ``"int8"``/``"bstc"`` replace each projection with a
    record (module docstring); tied embeddings get an explicit ``lm_head``
    record built from ``embed.T``, matching the engine's tied head read.
    ``"bstc"`` codes every copy on the weights' device, prices the measured
    stream and round-trips the first coded matrix.  ``local`` is a rank's
    shard of ``params`` (:func:`repro_torch.serving.sharded.shard_params`):
    the plan prices ``params``, the records come from ``local``'s leaves,
    and the tree returned is ``local``'s.  (The reference also takes the
    cache layout, for its mesh columns; the port's plan takes it when it
    reports them.)"""
    fmt = resolve(cfg) if fmt is None else fmt
    if fmt not in FORMATS:
        raise ValueError(f"weight_format={fmt!r} is not one of {FORMATS}")
    dt = _dtype_bytes(cfg)
    entries: List[WeightEntry] = []
    local = params if local is None else local
    serve = local
    roundtrip = fmt == "bstc"

    def convert(w, w_local, path, proj, placement, stacked):
        nonlocal serve, roundtrip
        shape = tuple(w.shape)
        copies = math.prod(shape[:-2]) if len(shape) > 2 else 1
        in_dim, out_dim = int(shape[-2]), int(shape[-1])
        bf16_b = float(dt * in_dim * out_dim * copies)
        int8_b = float((in_dim * out_dim + 4 * out_dim) * copies)
        entry = dict(path="/".join(path) if stacked else "embed.T", proj=proj,
                     copies=copies, in_dim=in_dim, out_dim=out_dim, placement=placement,
                     int8_bytes=int8_b, bf16_bytes=bf16_b)
        if fmt == "bf16":
            entries.append(WeightEntry(coded_bytes=bf16_b, modeled_bytes=bf16_b, **entry))
            return
        rec = quantize(w)
        coded_b, modeled_b = int8_b, int8_b
        fell_back = fmt == "bstc" and not _fits_grid(in_dim, out_dim, cfg)
        if fmt == "bstc" and not fell_back:
            rec, coded_b, modeled_b = _code(rec["q"], rec["scale"], cfg, roundtrip)
            roundtrip = False
        if w_local.shape != w.shape:  # a rank's shard, coded as its own matrix
            rec = quantize(w_local)
            if fmt == "bstc" and _fits_grid(*w_local.shape[-2:], cfg):
                rec = _code(rec["q"], rec["scale"], cfg, roundtrip=False, plan_rows=out_dim)[0]
        serve = _set(serve, path, rec)
        entries.append(WeightEntry(coded_bytes=float(coded_b), modeled_bytes=float(modeled_b),
                                   bstc_fallback=fell_back, **entry))

    for path, proj, placement in list(_iter_targets(params)):
        convert(_get(params, path), _get(local, path), path, proj, placement, stacked=True)
    # tied embeddings: the engine reads embed.T as the head — price it in
    # every format, and materialise a record for it on the quantized paths
    if "lm_head" not in params and "embed" in params:
        convert(params["embed"].T, local["embed"].T, ("lm_head",), "lm_head", "vocab",
                stacked=False)
    return serve, WeightPlan(fmt=fmt, entries=entries)
