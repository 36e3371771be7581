"""BGPP — Bit-Grained Progressive Prediction (paper §3.3, Fig. 9).

Counterpart of :mod:`repro.core.bgpp`.  Predicts the top-k attention set
with *bit-serial, MSB-first* scoring of keys and per-key early termination,
so low-order key bit planes of already-rejected keys are never fetched.

Round r (r = 0 is the magnitude MSB):
  1. fetch plane ``nbits-1-r`` of the still-alive keys (+ the sign plane
     once);
  2. partial score  Â_r += 2^(nbits-1-r) · (q · signed_plane);
  3. threshold      θ_r = max_alive(Â_r) − α_r · radius      (paper Eq. 1)
     on the softmax-logit scale; keys with Â_r < θ_r are dropped;
  4. clock-gate analogue (paper §4.5): if θ_r falls below the alive minimum
     nothing would be pruned and the clipping is skipped for the round.

Accounting mirrors the paper's IO model: prediction traffic is the bytes
of the fetched planes of alive keys only; the value-level baseline (§2.2)
fetches a 4-bit MSB estimate of every key.

Step 2 is one launch of the ``bgpp_score`` kernel a round on CUDA tensors
(its plain version on CPU ones), for every query head of the call at once:
the planes are packed 8:1 along D once a call and read in place.  The
reference's predictor is pure jnp and never launches its Pallas kernel.
The round loop stays on the device: no ``.item()`` or ``bool()`` of a
device tensor, the gate, the alive history and ``min_keys`` included.  The
threshold repeats the reference's float32 arithmetic (alphas as float32,
``partial.float() * logit_scale``), so survivors at the boundary agree.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import bitslice
from repro_torch.core.topk import top_k
from repro_torch.kernels.bgpp_score.ops import bgpp_score_heads

DEFAULT_RADIUS = 3.0  # paper: "we empirically set the default radius to 3"
DEFAULT_ALPHA = 0.55  # paper §6: alpha in [0.5, 0.6]
DEFAULT_QUERY_BITS = 4  # paper precompute uses 4-bit MSB queries


class BGPPStats(NamedTuple):
    """Per-call traffic / ops accounting (summed over rounds)."""

    alive_per_round: torch.Tensor  # (nbits,) int32 (entries past `rounds` are 0)
    predict_bytes: torch.Tensor  # float32: bytes fetched by the progressive filter
    value_topk_bytes: torch.Tensor  # float32: value-level 4-bit baseline bytes
    full_bytes: torch.Tensor  # float32: fetching every key at 8 bit
    predict_ops: torch.Tensor  # int32: adder-tree adds executed


@dataclasses.dataclass(frozen=True)
class BGPPConfig:
    rounds: int = 4
    # target alpha; per-round alphas anneal 1.0 -> alpha (early partial
    # estimates are noisy, so early rounds prune conservatively — the
    # paper's per-round α_r control, §3.3)
    alpha: float = DEFAULT_ALPHA
    alpha_schedule: Optional[Tuple[float, ...]] = None  # overrides annealing
    radius: float = DEFAULT_RADIUS
    query_bits: int = DEFAULT_QUERY_BITS
    nbits: int = bitslice.WEIGHT_MAG_BITS
    # keep at least this many keys regardless of the threshold (0 = pure Eq.1)
    min_keys: int = 0

    def alphas(self, rounds: int) -> Tuple[float, ...]:
        if self.alpha_schedule is not None:
            s = tuple(self.alpha_schedule)
            return (s + (s[-1],) * rounds)[:rounds]
        start = max(1.0, self.alpha)
        if rounds == 1:
            return (self.alpha,)
        return tuple(
            start + (self.alpha - start) * r / (rounds - 1) for r in range(rounds)
        )


def _truncate_query(q: torch.Tensor, nbits: int, query_bits: int) -> torch.Tensor:
    """Keep the top ``query_bits`` magnitude bits of an int query (paper: 4b):
    ``sign(q) * ((|q| >> s) << s)``, with ``sign(0) == 0``."""
    shift = max(nbits - query_bits, 0)
    return torch.sign(q) * ((q.abs() >> shift) << shift)


def _pack_d(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} planes -> packed 8:1 along D, zero-padded to a multiple of 8
    (pad bits are 0 and score nothing)."""
    pad = (-bits.shape[-1]) % 8
    if pad:
        bits = F.pad(bits, (0, pad))
    return bitslice.pack_bits(bits)


def _predict_heads(q, planes, sign, alive0, cfg, logit_scale):
    """The rounds for every query head of a batch.

    q ``(B, Hq, D)`` int; planes ``(nbits, B, S, Hk, Dp)`` and sign ``(B,
    S, Hk, Dp)`` packed uint8; alive0 ``(B, S)`` bool.  Returns alive and
    est ``(B, Hq, S)``, and the stats' per-head tensors: bytes ``(B, Hq)``
    f32, ops ``(B, Hq)`` int32, alive history ``(B, Hq, nbits)`` int32."""
    nbits, B, S = planes.shape[:3]
    Hq, D = q.shape[1], q.shape[2]
    dev = q.device
    rounds = min(cfg.rounds, nbits)
    qt = _truncate_query(q.to(torch.int32), cfg.nbits, cfg.query_bits)
    pad = 8 * planes.shape[-1] - D
    if pad:
        qt = F.pad(qt, (0, pad))
    qt = qt.contiguous()
    alphas = torch.tensor(cfg.alphas(rounds), dtype=torch.float32, device=dev)
    plane_bytes = D / 8.0  # bit-planar packed storage: D bits per key-plane
    alive = alive0[:, None, :].expand(B, Hq, S).contiguous()
    partial = torch.zeros((B, Hq, S), dtype=torch.int32, device=dev)
    bytes_acc = torch.full((B, Hq), S * D / 8.0, dtype=torch.float32, device=dev)
    ops_acc = torch.full((B, Hq), S * D, dtype=torch.int32, device=dev)
    hist = torch.zeros((B, Hq, nbits), dtype=torch.int32, device=dev)
    for r in range(rounds):
        p = nbits - 1 - r
        # dead keys score 0, so this is the reference's where(alive, ...)
        partial = partial + bgpp_score_heads(qt, planes[p], sign, alive) * (2 ** p)
        n_alive = alive.sum(-1, dtype=torch.int32)
        bytes_acc = bytes_acc + n_alive.to(torch.float32) * plane_bytes
        ops_acc = ops_acc + n_alive * D
        logits = partial.to(torch.float32) * logit_scale
        theta = torch.where(alive, logits, -torch.inf).amax(-1) - alphas[r] * cfg.radius
        min_alive = torch.where(alive, logits, torch.inf).amin(-1)
        gate = (theta <= min_alive)[..., None]  # clock-gate: no clipping this round
        alive = torch.where(gate, alive, alive & (logits >= theta[..., None]))
        hist[..., r] = alive.sum(-1, dtype=torch.int32)

    est = partial.to(torch.float32) * logit_scale
    valid = alive0[:, None, :]
    if cfg.min_keys:
        # never return fewer than min_keys candidates (accuracy floor)
        masked = torch.where(valid, est, -torch.inf)
        kth = torch.sort(masked, dim=-1).values[..., -min(cfg.min_keys, S)]
        alive = alive | (masked >= kth[..., None])
    return alive & valid, est, bytes_acc, ops_acc, hist


def bgpp_predict(
    q: torch.Tensor,
    k_planes: torch.Tensor,
    k_sign: torch.Tensor,
    cfg: BGPPConfig = BGPPConfig(),
    logit_scale=1.0,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, BGPPStats]:
    """Progressive bit-grained filter for one query against S keys.

    q:        (D,) int32 quantized query (full sign).
    k_planes: (nbits, S, D) uint8 magnitude planes of the quantized keys.
    k_sign:   (S, D) uint8.
    logit_scale: Δq·Δk/√d — converts integer partial scores to logit scale
        so the radius threshold (Eq. 1) operates on softmax-relevant units.
    valid:    optional (S,) bool mask of usable cache slots.

    Returns (alive_mask (S,), est_scores (S,) float32 logits, stats)."""
    nbits, S, D = k_planes.shape
    planes = _pack_d(k_planes)[:, None, :, None]  # (nbits, 1, S, 1, Dp)
    sign = _pack_d(k_sign)[None, :, None]
    alive0 = torch.ones((1, S), dtype=torch.bool, device=q.device) if valid is None \
        else valid.to(torch.bool)[None]
    alive, est, nbytes, ops, hist = _predict_heads(q[None, None], planes, sign, alive0, cfg,
                                                   logit_scale)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=q.device)
    stats = BGPPStats(alive_per_round=hist[0, 0], predict_bytes=nbytes[0, 0],
                      value_topk_bytes=f32(S * D * 0.5),  # 4-bit all keys
                      full_bytes=f32(S * D * 1.0), predict_ops=ops[0, 0])
    return alive[0, 0], est[0, 0], stats


def bgpp_predict_batched(
    q: torch.Tensor,  # (B, Hq, D) int32
    k_planes: torch.Tensor,  # (nbits, B, S, Hk, D)
    k_sign: torch.Tensor,  # (B, S, Hk, D)
    cfg: BGPPConfig = BGPPConfig(),
    logit_scale=1.0,
    valid: Optional[torch.Tensor] = None,  # (B, S)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched decode-time predictor with GQA head sharing.

    Returns (alive (B, Hk, S) bool, est_scores (B, Hq, S)).  Query heads in
    the same KV group OR their alive sets (a key kept by any query head is
    kept — the conservative union the paper's per-head predictor implies
    for GQA).  Every round is one kernel launch for all B x Hq heads."""
    B, Hq, D = q.shape
    S, Hk = k_planes.shape[2], k_planes.shape[3]
    alive0 = torch.ones((B, S), dtype=torch.bool, device=q.device) if valid is None \
        else valid.to(torch.bool)
    alive, est, *_ = _predict_heads(q, _pack_d(k_planes), _pack_d(k_sign), alive0, cfg,
                                    logit_scale)
    return alive.reshape(B, Hk, Hq // Hk, S).any(2), est


def alive_to_topk_indices(
    alive: torch.Tensor, est: torch.Tensor, k_max: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape gather set: the top ``k_max`` of the alive keys by est
    score, ties by lower index (``jax.lax.top_k``'s order, the ``-inf``
    lanes of dead keys included).

    Returns (indices (..., k_max) int64, validity mask)."""
    vals, idx = top_k(torch.where(alive, est, -torch.inf), k_max)
    return idx, torch.isfinite(vals)
