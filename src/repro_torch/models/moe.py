"""Mixture-of-experts FFN with GShard capacity dispatch (mixtral 8 experts
top-2, llama4-scout 16 experts top-1 with a shared expert).

Counterpart of :mod:`repro.models.moe`.  Routing is the reference's:
router logits ``x @ router`` in x's dtype then float32, softmax, top-k
with ``jax.lax.top_k``'s tie order, the gates renormalised when k > 1,
``capacity = min(max(1, ceil(T k / E cf)), T k)``, each (token, slot)'s
place in its expert's queue from a token-major cumsum, and a (token, slot)
whose place reaches the capacity dropped (gate weight 0).
``capacity_factor = E`` is dropless: the serve path's decode and chunk
steps route so, as the reference's do.

The experts are computed for the card, not as the reference's einsum over
an ``(E, C, D)`` buffer that is mostly zeros: the kept (token, slot) rows
are scattered to their queue places in one ``(E * C, D)`` buffer, and only
the experts that received a row run their FFN, each over its whole ``C``
rows (zero-padded).  So an expert's product has the same shape whatever
its neighbours routed to, and on the CPU (:func:`layers.matmul`) a row's
sum does not follow the row count: a token's dropless output does not
depend on its batch neighbours.  Which experts run is read on the host
(one sync a call).  The expert FFNs are plain ``layers.wdot`` products, as
the reference computes them with ``jnp.einsum`` outside any kernel; a
float32 activation against bfloat16 expert weights (the serve path's
decode residual) upcasts one expert's matrix at a time, never a bank.

On a mesh, serving replicates the experts (the bit-exact serving
placement) and calls :func:`moe_apply` without a split.  The sharded train
step passes its :class:`~repro_torch.distributed.sharding.ModelSplit` and
the data axis's group: dispatch is the reference's *group-local* one, the
rank's rows of the batch being its token group (``group_sizes``'
contiguous block of ``B / data`` rows, its own capacity), the experts' FF
split over ``"model"`` (``gate`` / ``up`` column shards, ``down`` row
shards, the shared expert as the dense MLP), and the auxiliary loss the
global one over every group.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.topk import top_k
from repro_torch.distributed import sharding as sh
from repro_torch.models import layers
from repro_torch.models.layers import _dtype

Params = Dict[str, Any]


def moe_specs(cfg, ep: bool = False) -> Params:
    """Logical axes of one MoE FFN: ``ff`` on the experts' hidden side
    (``expert`` on their leading axis instead under expert parallelism)."""
    expert_axis = sh.EXPERT if ep else None
    ff_axis = None if ep else sh.FF
    specs = {"router": (sh.D_MODEL, None), "gate": (expert_axis, sh.D_MODEL, ff_axis),
             "up": (expert_axis, sh.D_MODEL, ff_axis), "down": (expert_axis, ff_axis, sh.D_MODEL)}
    if cfg.moe_shared_ff:
        specs["shared"] = layers.mlp_specs(cfg.activation)
    return specs


def moe_init(cfg, generator: torch.Generator, device="cuda", stack: int = 0) -> Params:
    """Random MoE parameters on ``device`` from ``generator``, the
    reference's tree and scales: ``router`` ``(d, E)`` and ``gate`` / ``up``
    ``(E, d, f)`` at ``1/sqrt(d)``, ``down`` ``(E, f, d)`` at ``1/sqrt(f)``,
    and ``shared``, a gated MLP of width ``moe_shared_ff``, where the config
    sets one.  ``stack > 0`` stacks that many layer copies ``(L, ...)``.
    Filled one layer and one expert at a time, in the model dtype, so the
    peak memory is the parameters themselves."""
    dtype = _dtype(cfg.dtype)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    lead = (stack,) if stack else ()

    def normal(shape, scale):
        t = torch.empty(lead + shape, dtype=dtype, device=device)
        flat = t.view((-1,) + shape[-2:])
        for i in range(flat.shape[0]):  # one (layer, expert) matrix at a time
            flat[i].normal_(generator=generator)
        return t.mul_(torch.tensor(scale, dtype=dtype, device=device))

    params = {
        "router": normal((d, E), 1 / math.sqrt(d)),
        "gate": normal((E, d, f), 1 / math.sqrt(d)),
        "up": normal((E, d, f), 1 / math.sqrt(d)),
        "down": normal((E, f, d), 1 / math.sqrt(f)),
    }
    fs = cfg.moe_shared_ff
    if fs:
        params["shared"] = {"gate": normal((d, fs), 1 / math.sqrt(d)),
                            "up": normal((d, fs), 1 / math.sqrt(d)),
                            "down": normal((fs, d), 1 / math.sqrt(fs))}
    return params


def capacity_of(T: int, cfg, capacity_factor: float) -> int:
    """Rows an expert's queue holds for ``T`` tokens: the reference's
    ``min(max(1, ceil(T k / E cf)), T k)``."""
    E, k = cfg.num_experts, cfg.experts_per_token
    cap = int(max(1, math.ceil(T * k / E * capacity_factor)))
    return min(cap, T * k)


def route(params: Params, x: torch.Tensor, cfg, capacity_factor: Optional[float] = None):
    """The router and the capacity rule for x ``(..., D)`` flattened to
    ``T`` tokens.  Returns a dict: ``logits`` / ``probs`` ``(T, E)`` f32,
    ``gates`` / ``experts`` ``(T, k)`` (renormalised when k > 1), ``pos``
    ``(T, k)`` each (token, slot)'s place in its expert's queue, ``keep``
    ``(T, k)`` bool and ``capacity``."""
    cf = cfg.moe_capacity_factor if capacity_factor is None else capacity_factor
    E, k = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(-1, x.shape[-1])
    T = xt.shape[0]
    logits = layers.wdot(xt, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, k)
    if k > 1:
        gates = gates / gates.sum(-1, keepdim=True)
    capacity = capacity_of(T, cfg, cf)
    flat = experts.reshape(T * k)
    onehot = F.one_hot(flat, E).to(torch.int32)  # token-major (token, slot) rows
    pos = (onehot.cumsum(0) - 1).gather(1, flat[:, None]).reshape(T, k)
    return {"logits": logits, "probs": probs, "gates": gates, "experts": experts,
            "pos": pos, "keep": pos < capacity, "capacity": capacity}


def _expert_ffn(params: Params, e: int, h: torch.Tensor, activation: str) -> torch.Tensor:
    """Expert ``e``'s gated FFN over rows ``h`` ``(C, D)``; ``wdot`` upcasts
    this expert's matrices alone where h is wider than the weights."""
    g = layers.wdot(h, params["gate"][e])
    u = layers.wdot(h, params["up"][e])
    return layers.wdot(layers.glu_act(activation, g) * u, params["down"][e])


def _experts(params: Params, xt: torch.Tensor, r, cfg) -> torch.Tensor:
    """The kept (token, slot) rows of ``xt`` ``(T, D)`` through their
    experts -> ``(T, k, D)`` (a dropped (token, slot)'s row is zeros)."""
    T, D = xt.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C, keep = r["capacity"], r["keep"]
    # queue row of each kept (token, slot); a dropped one goes to the spare
    # row E * C, which no expert reads
    slot = torch.where(keep, r["experts"] * C + r["pos"], E * C).reshape(T * k)
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf[slot] = xt.repeat_interleave(k, dim=0)
    counts = torch.zeros(E, dtype=torch.int32, device=xt.device).index_add_(
        0, r["experts"].reshape(-1), keep.reshape(-1).to(torch.int32))
    active = [e for e, n in enumerate(counts.tolist()) if n]
    out = torch.zeros((E * C + 1, D), dtype=torch.promote_types(xt.dtype, params["gate"].dtype),
                      device=xt.device)
    for e in active:
        out[e * C:(e + 1) * C] = _expert_ffn(params, e, buf[e * C:(e + 1) * C], cfg.activation)
    return out[slot].reshape(T, k, D)


def _combine(w: torch.Tensor, gathered: torch.Tensor) -> torch.Tensor:
    """The gate-weighted sum of each token's k expert rows, slot by slot in
    order, in float32, rounded once to the rows' dtype."""
    y = w[:, 0, None].float() * gathered[:, 0].float()
    for j in range(1, w.shape[1]):
        y = y + w[:, j, None].float() * gathered[:, j].float()
    return y.to(gathered.dtype)


def _aux(r, E: int, data=None) -> torch.Tensor:
    """The switch load-balance loss plus 1e-3 of the router z-loss, from the
    top-1 expert's density, the mean router probability and the mean
    squared log-sum-exp over the tokens.  With the data axis's ``data``
    group the three means are the global ones: each rank's means (every
    rank holds the same number of tokens) times ``1 / data`` are summed over
    the group in rank order (identity backward, each rank's gradient
    reaching its own tokens) before they are combined, since
    ``sum(density * mean_prob)`` is not linear in the ranks' parts."""
    density = F.one_hot(r["experts"][:, 0], E).float().mean(0)
    mean_prob = r["probs"].mean(0)
    z_loss = torch.mean(torch.square(torch.logsumexp(r["logits"], dim=-1)))
    if data is not None:
        parts = torch.cat([density, mean_prob, z_loss[None]]) * (1.0 / sh.group_size(data))
        parts = sh.reduce_from(parts, data)
        density, mean_prob, z_loss = parts[:E], parts[E:2 * E], parts[2 * E]
    lb_loss = E * torch.sum(density * mean_prob)
    return lb_loss + 1e-3 * z_loss


def moe_apply(params: Params, x: torch.Tensor, cfg, capacity_factor: Optional[float] = None,
              split: Optional[sh.ModelSplit] = None, data=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, S, D)`` -> ``(y (B, S, D), aux)``: the routed experts'
    gate-weighted sum (dropped (token, slot)s weigh 0), plus the shared
    expert where the config has one; ``aux`` is the switch load-balance
    loss plus 1e-3 of the router z-loss, a 0-d float32 tensor.

    ``split``, a training split (the sharded train step; serving passes
    none): x is the rank's rows of the batch (its ``S / size`` sequence rows
    under ``seq``, gathered here: the block is the reference's sequence
    parallel region boundary), which are the reference's token group, so
    the capacity is the rank's own.  Where ``split.ff`` the rank holds its
    FF shard of every expert and of the shared expert: the router and the
    gates are computed whole on every model rank from the un-copied input,
    only the experts' input passes :func:`~sharding.copy_to`, the gates
    weighing the partial expert rows pass it too (so the router's gradient
    sums the ranks' partial ``dL/dw``), and the combined partial output is
    summed over ``"model"`` (reduce-scattered to the rank's rows under
    ``seq``).  ``data``: the data axis's group, over which ``aux`` is the
    global one (:func:`_aux`)."""
    rows = sh.training(split)
    if rows and split.seq:
        x = sh.gather_from(x, split.group, 1)
    B, S, D = x.shape
    r = route(params, x, cfg, capacity_factor)
    sharded = rows and split.ff
    xe = sh.copy_to(x, split.group) if sharded else x
    w = (r["gates"] * r["keep"].float()).to(x.dtype)
    if sharded:
        w = sh.copy_to(w, split.group)
    gathered = _experts(params, xe.reshape(B * S, D), r, cfg)
    y = _combine(w, gathered).reshape(B, S, D)
    if "shared" in params:
        y = y + layers.mlp_apply(params["shared"], xe, cfg.activation)
    if rows:
        y = sh.leave_block(y, split, sharded)
    return y, _aux(r, cfg.num_experts, data)
