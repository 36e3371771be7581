"""Dense decoder-only transformer: per-layer RoPE bases and parameter init.

Counterpart of :mod:`repro.models.transformer` for the dense family.  The
parameter tree follows ``transformer.init``'s (stacked ``(L, ...)`` layer
leaves, ``(in, out)`` projections, zero-centred norm scales, tied
embeddings) and its scales, drawn from a ``torch.Generator`` on the target
device.  The whole-sequence ``forward`` (eager admission, whole-batch
prefill) is a later slice: serving admits prompts through chunked prefill.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.layers import _dtype

Params = Dict[str, Any]


def layer_thetas(cfg) -> np.ndarray:
    """(L,) RoPE base per layer (every ported layer is global)."""
    return np.full((cfg.num_layers,), cfg.rope_theta, np.float32)


def init_params(cfg, generator: torch.Generator, device="cuda") -> Params:
    """Random dense parameters on ``device`` from ``generator`` (which must
    live on the same device).

    Projections are ``N(0, 1) / sqrt(fan_in)``, embeddings ``N(0, 1) *
    0.02``, norm scales zero — ``transformer.init``'s scales.  Leaves are
    filled layer by layer in the model dtype, so the peak memory is the
    parameters themselves (7.7 GB for phi4-mini-3.8b in bf16)."""
    if cfg.family != "dense" or not cfg.tie_embeddings:
        raise ValueError("init_params: the port initialises dense, tied models")
    dtype = _dtype(cfg.dtype)
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        t = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):  # one layer (or the whole table) at a time
            t[i].normal_(generator=generator)
        return t.mul_(torch.tensor(scale, dtype=dtype, device=device))

    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    embed = torch.empty((cfg.vocab_size, d), dtype=dtype, device=device)
    embed.normal_(generator=generator)
    embed.mul_(torch.tensor(0.02, dtype=dtype, device=device))
    return {
        "embed": embed,
        "layers": {
            "attn_norm": {"scale": zeros(L, d)},
            "attn": {
                "wq": normal((L, d, cfg.q_dim), 1 / math.sqrt(d)),
                "wk": normal((L, d, cfg.kv_dim), 1 / math.sqrt(d)),
                "wv": normal((L, d, cfg.kv_dim), 1 / math.sqrt(d)),
                "wo": normal((L, cfg.q_dim, d), 1 / math.sqrt(cfg.q_dim)),
            },
            "mlp_norm": {"scale": zeros(L, d)},
            "mlp": {
                "gate": normal((L, d, f), 1 / math.sqrt(d)),
                "up": normal((L, d, f), 1 / math.sqrt(d)),
                "down": normal((L, f, d), 1 / math.sqrt(f)),
            },
        },
        "final_norm": {"scale": zeros(d)},
    }


def layer_params(tree: Params, i: int) -> Params:
    """Layer ``i``'s slice of a stacked ``(L, ...)`` tree (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
