"""AdamW with optional 8-bit quantized moments.

Counterpart of :mod:`repro.optim.adamw`: the same config, the same state
tree (``{"step", "m", "v"}``, each moment f32 like its parameter or, with
``state_dtype="int8"``, an ``{"q": int8, "s": f32}`` record with per-row
(leading-axis) absmax scales, the second moment coded in sqrt-space) and
the same arithmetic: clip by the global norm, decoupled weight decay, bias
corrections, the warm-up-cosine schedule.

Two departures, both for memory on one card (phi4-mini-3.8b: 7.7 GB of
bf16 parameters, 30.7 GB of f32 moments, the largest stacked leaf 805 M
parameters):
  * the update runs leaf by leaf, so the f32 temporaries are those of one
    leaf (3.2 GB each at gate / up), not of the whole tree;
  * it writes the new parameters and moments into the given tensors in
    place (the returned trees hold the same tensors): a second copy of
    the moments would not fit beside the first.

On a mesh (the sharded train step, explicit SPMD) each rank holds its
blocks of the parameters, grads and moments, and ``adamw_update`` takes
``groups``: for every leaf, the process groups that split each of its
dims.  The global norm then sums each leaf's squares over exactly the
groups the leaf splits over (a replicated leaf counts once), and the int8
codec's per-row absmax is a max over the groups that split the reduced
dims, so every code and scale is the one-device update's.

``zero_partition`` is, as in the reference, only a field: whether
``"data"`` shards the moments is the sharding rules' choice (their
``fsdp_axes``), which :func:`opt_state_specs` passes on by mirroring the
parameters' logical axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (PartGroups, all_reduce_max, all_reduce_sum,
                                              group_size, part_pieces)
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.utils.tree import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "fp32"  # fp32 | int8
    zero_partition: bool = False  # ZeRO-1: the rules' fsdp_axes decide (opt_state_specs)
    warmup_steps: int = 100
    decay_steps: int = 10_000


def _check(cfg: AdamWConfig) -> None:
    if cfg.state_dtype not in ("fp32", "int8"):
        raise ValueError(f"AdamWConfig.state_dtype must be fp32 or int8, got "
                         f"{cfg.state_dtype!r}")


# ---------------------------------------------------------------------------
# int8 moment codec (per-row absmax; v in sqrt-space)
# ---------------------------------------------------------------------------


def _bcast(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    return scale.reshape((-1,) + (1,) * (ndim - 1)) if ndim > 1 else scale


def _reduced_groups(groups, ndim: int) -> Tuple:
    """The process groups splitting the dims the codec's absmax reduces:
    all of them for a 0-d / 1-d leaf, the non-leading ones otherwise."""
    dims = groups if ndim <= 1 else groups[1:]
    return tuple(g for dim in dims for g in dim)


def _q8(x: torch.Tensor, groups=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes and scales: one absmax scale a leading-axis row (``(rows,)``),
    or one for a 0-d / 1-d tensor (its shape with keepdims).  ``groups``:
    the leaf's process groups dim by dim (:func:`adamw_update`), over which
    the absmax is a max where they split a reduced dim."""
    if x.ndim <= 1:
        amax = x.abs().amax().reshape((1,) * x.ndim)
    else:
        amax = x.abs().amax(dim=tuple(range(1, x.ndim)))
    for g in _reduced_groups(groups, x.ndim):
        amax = all_reduce_max(amax, g)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / _bcast(scale, x.ndim)), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * _bcast(scale, q.ndim)


def _encode_m(m: torch.Tensor, groups=()) -> Dict[str, torch.Tensor]:
    return dict(zip(("q", "s"), _q8(m, groups)))


def _decode_m(e: Dict[str, torch.Tensor]) -> torch.Tensor:
    return _dq8(e["q"], e["s"])


def _encode_v(v: torch.Tensor, groups=()) -> Dict[str, torch.Tensor]:
    return dict(zip(("q", "s"), _q8(torch.sqrt(torch.clamp(v, min=0.0)), groups)))


def _decode_v(e: Dict[str, torch.Tensor]) -> torch.Tensor:
    r = _dq8(e["q"], e["s"])
    return r * r


# ---------------------------------------------------------------------------


def adamw_init(params: Tree, cfg: AdamWConfig) -> Tree:
    """Zero moments beside each parameter (on its device): f32 tensors, or
    int8 records; ``step`` a 0-d int32 tensor."""
    _check(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if cfg.state_dtype == "int8":
        m = tree_map(lambda p: _encode_m(zeros(p)), params)
        v = tree_map(lambda p: _encode_v(zeros(p)), params)
    else:
        m, v = tree_map(zeros, params), tree_map(zeros, params)
    device = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device), "m": m, "v": v}


def global_norm(tree: Tree, groups: Optional[Tree] = None) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, in f32.  With ``groups``
    (each leaf's process groups dim by dim) each leaf's sum of squares is
    summed over the groups that split it first, so the norm is the whole
    tree's on every rank and a replicated leaf counts once (a leaf with a
    segmented dim, :class:`~repro_torch.distributed.sharding.PartGroups`,
    sums its split parts' squares over every group and its whole parts'
    over the other dims' groups only).  Each leaf is
    summed in its row-major order whatever its strides (a tied head's
    gradient comes back transposed on one device and contiguous off a
    reduce-scatter; the sum's order follows the layout)."""
    def total(s, dims, skip=None):
        for group in (grp for dim in dims if dim is not skip for grp in dim):
            s = all_reduce_sum(s, group)
        return s

    def sq(g, dims):
        # contiguous whatever its dtype: to() keeps an f32 leaf's strides
        g = g.to(torch.float32).contiguous()
        seg = next(((i, d) for i, d in enumerate(dims) if isinstance(d, PartGroups)
                    and math.prod(group_size(x) for x in d) > 1), None)
        if seg is None:
            return total(torch.sum(torch.square(g)), dims)
        i, d = seg
        pieces = part_pieces(g, i, d.parts, math.prod(group_size(x) for x in d))
        sq_of = lambda split: torch.sum(torch.square(torch.cat(
            [p for p, s in pieces if s == split], i)))
        return total(sq_of(True), dims) + total(sq_of(False), dims, skip=d)

    if groups is None:
        groups = tree_map(lambda _: (), tree)
    return torch.sqrt(sum(tree_leaves(tree_map(sq, tree, groups))))


@torch.no_grad()
def adamw_update(
    params: Tree,
    grads: Tree,
    state: Tree,
    cfg: AdamWConfig,
    lr: Optional[torch.Tensor] = None,
    *,
    groups: Optional[Tree] = None,
) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
    """One AdamW step -> ``(new_params, new_state, {"grad_norm", "lr"})``.

    Leaf by leaf, in place: each parameter and its moments (or their int8
    records) are overwritten with the new values, which the returned trees
    hold; only ``step`` is a new tensor.  ``groups`` (on a mesh): for each
    parameter leaf a tuple, one entry a dim, of the process groups that
    split that dim; the global norm and the int8 codec's row absmax reduce
    over them."""
    _check(cfg)
    step = state["step"] + 1
    if lr is None:
        lr = warmup_cosine(step, cfg.peak_lr, cfg.warmup_steps, cfg.decay_steps)

    gnorm = global_norm(grads, groups)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)
    int8 = cfg.state_dtype == "int8"

    def update(p, g, m_state, v_state, dims):
        g = g.to(torch.float32) * clip
        m = _decode_m(m_state) if int8 else m_state
        v = _decode_v(v_state) if int8 else v_state
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        del g, m, v
        u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
        del u
        if int8:
            for rec, new in ((m_state, _encode_m(m_new, dims)),
                             (v_state, _encode_v(v_new, dims))):
                rec["q"].copy_(new["q"])
                rec["s"].copy_(new["s"])
        else:
            m_state.copy_(m_new)
            v_state.copy_(v_new)
        return p

    if groups is None:
        groups = tree_map(lambda _: (), params)
    new_params = tree_map(update, params, grads, state["m"], state["v"], groups)
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def opt_state_specs(param_specs: Tree, cfg: AdamWConfig) -> Tree:
    """Logical-axis specs for the optimizer state.

    ZeRO-1: moments are additionally sharded over "data" via the fsdp rule
    on their leading logical axis (``ShardingRules.fsdp_axes`` handles the
    mapping); here the param specs are mirrored, and the rules object
    chosen by the launcher decides whether "data" participates."""

    def moment_spec(axes):
        axes = tuple(axes)
        if cfg.state_dtype == "int8":
            # scale is (rows,) for >=2-d params, (1,) for 1-d (never sharded)
            lead = axes[0] if len(axes) > 1 else None
            return {"q": axes, "s": (lead,)}
        return axes

    return {"step": (), "m": tree_map(moment_spec, param_specs),
            "v": tree_map(moment_spec, param_specs)}
