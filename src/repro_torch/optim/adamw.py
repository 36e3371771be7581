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

ZeRO (``zero_partition``) and ``opt_state_specs`` belong to sharding,
which the port has not reached (ROADMAP item 7): ``zero_partition=True``
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

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
    zero_partition: bool = False  # ZeRO-1: sharding, not ported (ROADMAP item 7)
    warmup_steps: int = 100
    decay_steps: int = 10_000


def _check(cfg: AdamWConfig) -> None:
    if cfg.zero_partition:
        raise ValueError("AdamWConfig.zero_partition: ZeRO shards the moments over a data "
                         "mesh axis, and the port has no sharding yet (ROADMAP item 7)")
    if cfg.state_dtype not in ("fp32", "int8"):
        raise ValueError(f"AdamWConfig.state_dtype must be fp32 or int8, got "
                         f"{cfg.state_dtype!r}")


# ---------------------------------------------------------------------------
# int8 moment codec (per-row absmax; v in sqrt-space)
# ---------------------------------------------------------------------------


def _bcast(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    return scale.reshape((-1,) + (1,) * (ndim - 1)) if ndim > 1 else scale


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes and scales: one absmax scale a leading-axis row (``(rows,)``),
    or one for a 0-d / 1-d tensor (its shape with keepdims)."""
    if x.ndim <= 1:
        scale = torch.clamp(x.abs().amax().reshape((1,) * x.ndim), min=1e-12) / 127.0
    else:
        scale = torch.clamp(x.abs().amax(dim=tuple(range(1, x.ndim))), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / _bcast(scale, x.ndim)), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * _bcast(scale, q.ndim)


def _encode_m(m: torch.Tensor) -> Dict[str, torch.Tensor]:
    return dict(zip(("q", "s"), _q8(m)))


def _decode_m(e: Dict[str, torch.Tensor]) -> torch.Tensor:
    return _dq8(e["q"], e["s"])


def _encode_v(v: torch.Tensor) -> Dict[str, torch.Tensor]:
    return dict(zip(("q", "s"), _q8(torch.sqrt(torch.clamp(v, min=0.0)))))


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


def global_norm(tree: Tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(
    params: Tree,
    grads: Tree,
    state: Tree,
    cfg: AdamWConfig,
    lr: Optional[torch.Tensor] = None,
) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
    """One AdamW step -> ``(new_params, new_state, {"grad_norm", "lr"})``.

    Leaf by leaf, in place: each parameter and its moments (or their int8
    records) are overwritten with the new values, which the returned trees
    hold; only ``step`` is a new tensor."""
    _check(cfg)
    step = state["step"] + 1
    if lr is None:
        lr = warmup_cosine(step, cfg.peak_lr, cfg.warmup_steps, cfg.decay_steps)

    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)
    int8 = cfg.state_dtype == "int8"

    def update(p, g, m_state, v_state):
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
            for rec, new in ((m_state, _encode_m(m_new)), (v_state, _encode_v(v_new))):
                rec["q"].copy_(new["q"])
                rec["s"].copy_(new["s"])
        else:
            m_state.copy_(m_new)
            v_state.copy_(v_new)
        return p

    new_params = tree_map(update, params, grads, state["m"], state["v"])
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
