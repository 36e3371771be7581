"""Family dispatch for the registered architectures.

Counterpart of :mod:`repro.models.model_zoo`.  The port serves the dense
and MoE families, both on :mod:`repro_torch.models.transformer` (an MoE
config's layers carry :mod:`repro_torch.models.moe` FFNs); every other
family raises the ``ValueError`` of
:func:`repro_torch.configs.base.require_served`, which names the family
and the roadmap item that ports it.  There are no
logical-axis specs: sharding is a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import require_served
from repro_torch.models import transformer

Params = Dict[str, Any]


def init(cfg, generator: torch.Generator, device="cuda") -> Params:
    """Random parameters for ``cfg`` on ``device`` (see
    :func:`transformer.init_params`)."""
    require_served(cfg, "model_zoo.init")
    return transformer.init_params(cfg, generator, device)


def forward(params: Params, cfg, batch: Dict[str, torch.Tensor], **kw):
    """batch ``{"tokens": (B, S)}`` -> ``(logits, aux_loss)`` (plus the
    stacked K/V with ``return_kv=True``)."""
    require_served(cfg, "model_zoo.forward")
    return transformer.forward(params, cfg, batch["tokens"], **kw)


def extra_inputs(cfg) -> Tuple[str, ...]:
    """Modality-stub inputs beyond tokens: none for the dense and MoE
    families; the VLM's ``vision`` and whisper's ``frames`` come with their
    families."""
    if cfg.family == "vlm":
        return ("vision",)
    if cfg.family == "enc_dec":
        return ("frames",)
    return ()
