"""Training step: loss, grads, AdamW update.

Counterpart of :mod:`repro.training.train_step` on one device (no sharding
rules: ROADMAP item 7).  ``fwd_kwargs`` go to the model's forward as in the
reference: ``remat=True`` recomputes each layer in the backward, the
transformer families take (and ignore) ``block_q`` / ``block_k``, the ssm
family its ``chunk``.  On the card the forward's attention is the
``flash_attention`` kernel with its log-sum-exp kept, and its gradient the
``flash_attention_bwd`` kernel; on the CPU their plain versions.  The state
is the reference's plain tree ``{"params", "opt"}``; the AdamW update
writes it in place (:func:`repro_torch.optim.adamw_update`), so a step
returns the same tensors it was given, updated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import model_zoo
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any


@dataclasses.dataclass
class TrainState:
    params: Tree
    opt: Tree

    @classmethod
    def create(cls, params: Tree, opt_cfg: AdamWConfig) -> "TrainState":
        return cls(params=params, opt=adamw_init(params, opt_cfg))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL; labels < 0 are masked out.

    As the reference writes it: ``lse(logits) - logits[label]`` with the
    row max subtracted in the logits' dtype and the exponent taken in f32,
    so no f32 log-softmax copy is made: the one f32 temporary is the
    exponent (3.3 GB at phi4-mini's vocab 200,064 and S 4096), taken in
    place on its copy."""
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - m
    gold = torch.gather(shifted, -1, safe[..., None])[..., 0]
    lse = torch.log(torch.sum(shifted.to(torch.float32, copy=True).exp_(), dim=-1))
    nll = lse - gold.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)


def make_loss_fn(cfg, fwd_kwargs: Optional[Dict] = None):
    """``loss_fn(params, batch) -> (loss, {"ce", "aux"})``: cross entropy
    over the label positions (a VLM's prefix positions dropped) plus 0.01
    of the MoE auxiliary loss."""
    fwd_kwargs = fwd_kwargs or {}

    def loss_fn(params, batch):
        logits, aux = model_zoo.forward(params, cfg, batch, **fwd_kwargs)
        labels = batch["labels"]
        logits = logits[:, -labels.shape[1]:]  # drop VLM prefix positions
        ce = cross_entropy(logits, labels)
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}

    return loss_fn


def loss_and_grads(loss_fn, params: Tree, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Tree]:
    """``(loss, metrics, grads)`` of ``loss_fn`` at ``params``: the loss
    runs on detached aliases of the leaves that require a gradient (no
    copy; the caller's tensors keep their flags), the grads come back in
    the parameters' nesting and dtypes."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, list(grads))


def make_train_step(
    cfg,
    opt_cfg: AdamWConfig,
    fwd_kwargs: Optional[Dict] = None,
    grad_accum: int = 1,
) -> Callable[[Tree, Dict[str, torch.Tensor]], Tuple[Tree, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state_tree, batch) -> (state_tree, metrics)``
    with ``state_tree = {"params": ..., "opt": ...}`` and metrics ``ce``,
    ``aux``, ``loss``, ``grad_norm`` and ``lr``.

    ``grad_accum > 1`` splits the batch into that many microbatches over
    its leading dim, sums their grads in f32 and averages them (and the
    losses); ``ce`` / ``aux`` are the last microbatch's, as the reference
    reports them."""
    loss_fn = make_loss_fn(cfg, fwd_kwargs)

    def train_step(state: Tree, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        if grad_accum > 1:
            loss, grads = 0.0, None
            for i in range(grad_accum):
                mb = {k: v.reshape((grad_accum, v.shape[0] // grad_accum) + v.shape[1:])[i]
                      for k, v in batch.items()}
                mloss, metrics, mgrads = loss_and_grads(loss_fn, params, mb)
                loss = loss + mloss
                grads = tree_map(lambda g: g.to(torch.float32), mgrads) if grads is None \
                    else tree_map(torch.add, grads, mgrads)
                del mgrads
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        else:
            loss, metrics, grads = loss_and_grads(loss_fn, params, batch)

        new_params, new_opt, opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_prefill_step(cfg, fwd_kwargs: Optional[Dict] = None):
    """Inference prefill: the forward without gradients -> the
    last-position logits ``(B, 1, V)``."""
    fwd_kwargs = fwd_kwargs or {}

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = model_zoo.forward(params, cfg, batch, **fwd_kwargs)
        return logits[:, -1:]

    return prefill_step
