"""Gradient compression for data-parallel sync (bit-themed, like the paper).

Counterpart of :mod:`repro.distributed.compression`, on a data axis's
process group instead of ``shard_map``: each data rank quantizes its local
gradient to int8 against a per-leaf absmax scale shared by every rank
(the scale's max is taken over the group first), the int8 payloads are
summed in int32 over the group, and the sum is dequantized and divided by
the group's size -- 4x less traffic than f32 at the cost of bounded
quantization noise.  Plain PyTorch, as the reference's is ``jnp``, with
the reference's arithmetic step for step, so the results are its bits.

``make_compressed_dp_grad_fn`` wraps a loss into an explicit data-parallel
value-and-grad function with the compressed sync.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any


def _q8_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(g.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_mean(grads: Tree, group) -> Tree:
    """int8-compressed mean over ``group`` of every rank's ``grads``.

    A *shared* scale: each leaf's absmax is max-reduced over the group
    first, every rank quantizes against it, the codes are summed in int32
    (no overflow below 2^23 ranks) and the sum is dequantized:
    ``qsum * scale / n``.  The error is then bounded by the global absmax
    whatever the ranks' gradient scales."""
    n = sh.group_size(group)

    def one(g):
        g32 = g.to(torch.float32)
        local_max = g32.abs().amax()
        scale = torch.clamp(sh.all_reduce_max(local_max, group), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        qsum = sh.all_reduce_sum(q.to(torch.int32), group)
        return (qsum.to(torch.float32) * scale / n).to(g.dtype)

    return tree_map(one, grads)


def make_compressed_dp_grad_fn(
    loss_fn: Callable[[Tree, Dict[str, torch.Tensor]], torch.Tensor],
    rules: sh.ShardingRules,
    data_axis: str = "data",
) -> Callable[[Tree, Any], Tuple[torch.Tensor, Tree]]:
    """Explicit data-parallel value and grad with the int8 gradient sync.

    The parameters are whole on every rank, the batch is the rank's rows
    over ``data_axis`` of the rules' mesh.  Returns ``f(params, batch) ->
    (loss, grads)``: the loss's mean and the grads' compressed mean over
    the axis (the loss summed in rank order, then divided by the axis's
    size)."""
    group = rules.mesh.get_group(data_axis)

    def local(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        grads = compressed_psum_mean(tree_unflatten(params, list(grads)), group)
        loss = sh.all_reduce_sum(loss.detach(), group) / sh.group_size(group)
        return loss, grads

    return local
