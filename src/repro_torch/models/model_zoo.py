"""Family dispatch for the registered architectures.

Counterpart of :mod:`repro.models.model_zoo`.  The port serves the dense,
MoE and VLM families on :mod:`repro_torch.models.transformer` (an MoE
config's layers carry :mod:`repro_torch.models.moe` FFNs; a VLM's forward
puts its projected image patches before the tokens), the ssm family on
:mod:`repro_torch.models.mamba2` and the enc_dec family on
:mod:`repro_torch.models.whisper`; the hybrid raises the ``ValueError`` of
:func:`repro_torch.configs.base.require_served`, which names the family
and the roadmap item that ports it.  There are no
logical-axis specs: sharding is a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import require_served
from repro_torch.models import mamba2, transformer, whisper

Params = Dict[str, Any]


def init(cfg, generator: torch.Generator, device="cuda") -> Params:
    """Random parameters for ``cfg`` on ``device`` (see
    :func:`transformer.init_params`, :func:`mamba2.init`,
    :func:`whisper.init`)."""
    require_served(cfg, "model_zoo.init")
    if cfg.family == "ssm":
        return mamba2.init(cfg, generator, device)
    if cfg.family == "enc_dec":
        return whisper.init(cfg, generator, device)
    return transformer.init_params(cfg, generator, device)


def forward(params: Params, cfg, batch: Dict[str, torch.Tensor], **kw):
    """batch ``{"tokens": (B, S)}`` (a VLM's also ``"vision": (B, Tv,
    d_vision)``, whisper's ``"frames": (B, encoder_seq, d_audio)``) ->
    ``(logits, aux_loss)`` (plus the stacked K/V with ``return_kv=True``;
    an ssm model takes ``chunk``, the SSD scan's; every family takes
    ``remat``, the transformer and enc_dec families also the reference's
    ``block_q`` / ``block_k``, ignored)."""
    require_served(cfg, "model_zoo.forward")
    if cfg.family == "ssm":
        return mamba2.forward(params, cfg, batch["tokens"], **kw)
    if cfg.family == "enc_dec":
        return whisper.forward(params, cfg, batch["tokens"], batch["frames"], **kw)
    if cfg.family == "vlm":
        return transformer.forward(params, cfg, batch["tokens"],
                                   vision_embeds=batch["vision"], **kw)
    return transformer.forward(params, cfg, batch["tokens"], **kw)


def extra_inputs(cfg) -> Tuple[str, ...]:
    """Modality-stub inputs beyond tokens: none for the dense and MoE
    families, the VLM's ``vision`` (precomputed patch embeddings) and
    whisper's ``frames`` (post-conv frame embeddings: the audio frontend
    is a stub)."""
    if cfg.family == "vlm":
        return ("vision",)
    if cfg.family == "enc_dec":
        return ("frames",)
    return ()
