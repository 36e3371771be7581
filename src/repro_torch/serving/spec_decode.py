"""Bit-plane speculative decoding: draft with truncated MSB planes, verify
batched through ``serve_step``, accept or roll back per slot.

Counterpart of :mod:`repro.serving.spec_decode`.  MCBP's thesis is that
the most significant bit planes of int8 weights are cheap, informative
predictors; the draft model here is the ordinary ``serve_step`` run with
**truncated-plane weights** — every floating leaf quantized to int8 and
keeping only the top ``draft_planes`` magnitude bits
(:func:`truncate_plane_params`) — so a draft forward reuses the serving
path unchanged (same tree structure, shapes and dtypes, every
``weight_format``).

One speculative round a scheduler step
(:meth:`~repro_torch.serving.scheduler.Scheduler._spec_round`):

  1. **draft** — ``gamma`` serve steps with the truncated weights (greedy
     argmax fed forward) propose ``gamma`` tokens for every DECODING slot;
     the draft chain's ``pos`` drift is then rewound;
  2. **verify** — up to ``gamma + 1`` serve steps with the real weights,
     fed the draft tokens; each step's exact logits give the true token
     through the scheduler's ``_pick_token`` (forced or greedy), and a
     slot stays in the chain while its drafts keep matching (1 to
     ``gamma + 1`` tokens a slot a round);
  3. **rollback** — every row's ``pos`` back to its accepted frontier,
     paged pages past it released
     (:meth:`~repro_torch.serving.paging.PageAllocator.rewind_slot`), and
     the speculative rows past it zeroed in every store leaf
     (:func:`~repro_torch.serving.kv_cache.zero_token_range`).

Verification is greedy argmax over exact logits, so speculative output is
identical to non-speculative greedy decode.  Rollback is safe because
``serve_step`` writes before it attends and masks every row by position:
a position's stale contents are overwritten in the step that first makes
them visible.

Supported on global-attention stacks only (the reference's legality rule:
a sliding-window ring overwrites window lanes on every speculative write,
which no ``pos`` rewind undoes).  The knobs come from the Scheduler's
arguments, else from the config; the reference's ``REPRO_SPEC_DECODE`` /
``REPRO_DRAFT_GAMMA`` / ``REPRO_DRAFT_PLANES`` environment overrides are
not ported (the port reads no environment knob).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Resolved speculative-decoding knobs for one Scheduler build;
    ``source`` records where the enable came from (``"kwarg"`` or
    ``"config"``)."""

    enabled: bool
    gamma: int
    planes: int
    source: str


def resolve(cfg, enabled: Optional[bool] = None, gamma: Optional[int] = None,
            planes: Optional[int] = None) -> SpecConfig:
    """Resolve the knobs: the Scheduler's argument, else the config."""
    mo = cfg.mcbp
    if enabled is not None:
        on, source = bool(enabled), "kwarg"
    else:
        on, source = bool(getattr(mo, "spec_decode", False)), "config"
    g = int(gamma if gamma is not None else getattr(mo, "draft_gamma", 4))
    p = int(planes if planes is not None else getattr(mo, "draft_planes", 4))
    if g < 1:
        raise ValueError(f"draft_gamma={g} must be >= 1")
    if not 1 <= p <= 8:
        raise ValueError(f"draft_planes={p} must be in 1..8")
    return SpecConfig(enabled=on, gamma=g, planes=p, source=source)


def validate(cfg, layout, spec: SpecConfig) -> SpecConfig:
    """Check a resolved :class:`SpecConfig` against the cache layout: an
    enabled run needs every attention layer rollback-safe, which only
    global layers are; a layout with local (ring) layers raises."""
    if spec.enabled and getattr(layout, "local_layers", None):
        raise ValueError(
            "spec_decode=True needs a rollback-safe cache: sliding-window ring "
            "layers overwrite window lanes on every speculative write (layout has "
            f"local layers {layout.local_layers}).  Use a global-only attention "
            "stack, or leave spec_decode off.")
    return spec


_CHUNK = 1 << 26  # elements of a leaf truncated at a time (bounds the f32 temporaries)


def _truncate(w: torch.Tensor, shift: int) -> torch.Tensor:
    """One floating leaf: per-tensor symmetric int8 at ``max|w| / 127``,
    magnitude cut to its top ``7 - shift`` bits, back to ``w``'s dtype.
    Each step in f32, rounding half to even, as the reference's; the
    elementwise part runs a slab of leading rows at a time."""
    scale = torch.clamp(w.abs().amax().to(torch.float32), min=1e-12) / 127.0
    out = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    flat, dst = w.reshape(w.shape[0], -1) if w.dim() else w.reshape(1, 1), out.view(-1)
    rows = max(1, _CHUNK // max(1, flat.shape[1]))
    for i in range(0, flat.shape[0], rows):
        wf = flat[i:i + rows].to(torch.float32)
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int32)
        kept = (q.abs() >> shift) << shift
        dst[i * flat.shape[1]:(i + rows) * flat.shape[1]] = (
            (torch.sign(q) * kept).to(torch.float32) * scale).to(w.dtype).reshape(-1)
    return out


def truncate_plane_params(params, planes: int):
    """Truncated-bit-plane draft weights: every floating leaf quantized to
    per-tensor symmetric int8 at ``scale = max|w| / 127``, its magnitude
    masked to the ``planes`` most significant of its 7 bits, and
    dequantized back to the leaf's dtype.  The result has the tree
    structure, shapes and dtypes of ``params`` (new tensors; ``params`` is
    not touched); ``planes >= 7`` keeps all of int8 and returns ``params``
    itself, a perfect draft model."""
    planes = int(planes)
    if not 1 <= planes <= 8:
        raise ValueError(f"draft_planes={planes} must be in 1..8")
    if planes >= 7:
        return params
    shift = 7 - planes

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor) and node.is_floating_point():
            return _truncate(node, shift)
        return node

    return walk(params)
