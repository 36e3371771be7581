"""Jamba-style hybrid LM: mamba mixers and attention 7:1 with MoE and
dense FFNs alternating (jamba-1.5-large: attention at ``i % 8 == 4``, MoE
at odd ``i``).

Counterpart of :mod:`repro.models.hybrid`.  The layer pattern repeats with
period ``attn_every``, so the parameters keep the reference's tree:
``embed``, ``blocks/pos{j}`` for each in-block position ``j`` stacked over
the ``num_layers // period`` super-blocks (``norm1``, ``attn`` or
``mamba``, ``norm2``, ``moe`` or ``mlp``), ``final_norm`` and the untied
``lm_head`` where the config unties it.  The attention layers apply no
RoPE (position comes from the mamba mixers, as in Jamba) and attend
through :func:`repro_torch.core.attention.blocked_attend`: the
``flash_attention`` kernel on the card.  The mamba mixers
(:mod:`repro_torch.models.mamba2`) and the MoE FFNs
(:mod:`repro_torch.models.moe`) are plain PyTorch, as the reference's
``jnp``.  The reference's ``lax.scan`` over super-blocks is a Python loop
over the layers; ``remat`` recomputes each layer in the backward (the
reference rematerialises a super-block: the same values).  In the sharded
train step (``forward``'s ``split``, ``fsdp``, ``data``) the attention
layer takes the dense family's head split
(:func:`transformer.attention_block`), the MoE layers the rank's rows and
FF shard (:func:`moe.moe_apply`), the dense MLPs Megatron's split and the
mixers their split by heads (:func:`mamba2.mixer_apply`).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.models import layers, mamba2, moe, transformer
from repro_torch.models.layers import _dtype

Params = Dict[str, Any]


def _period(cfg) -> int:
    """The super-block's length: ``attn_every``, which must divide the
    depth and be a multiple of ``moe_every`` (the reference asserts)."""
    if not (cfg.attn_every > 0 and cfg.num_layers % cfg.attn_every == 0
            and cfg.attn_every % cfg.moe_every == 0):
        raise ValueError(
            f"hybrid: {cfg.name} needs attn_every > 0 dividing num_layers and a "
            f"multiple of moe_every (attn_every={cfg.attn_every}, num_layers="
            f"{cfg.num_layers}, moe_every={cfg.moe_every})")
    return cfg.attn_every


def _pos_kinds(cfg, j: int) -> Tuple[bool, bool]:
    """``(is_attention, is_moe)`` for in-block position ``j``."""
    return (j % cfg.attn_every == cfg.attn_offset,
            cfg.num_experts > 0 and j % cfg.moe_every == cfg.moe_offset)


def _pos_specs(cfg, j: int) -> Params:
    is_attn, is_moe = _pos_kinds(cfg, j)
    s: Params = {"norm1": layers.norm_specs(cfg.norm)}
    if is_attn:
        s["attn"] = layers.attention_specs()
    else:
        s["mamba"] = mamba2.mixer_specs()
    s["norm2"] = layers.norm_specs(cfg.norm)
    s["moe" if is_moe else "mlp"] = (moe.moe_specs(cfg) if is_moe
                                     else layers.mlp_specs(cfg.activation))
    return s


def param_specs(cfg) -> Params:
    """The logical-axis tree of :func:`init`'s parameters."""
    specs: Params = {"embed": (sh.VOCAB, sh.D_MODEL),
                     "blocks": {f"pos{j}": sh.stacked(_pos_specs(cfg, j))
                                for j in range(_period(cfg))},
                     "final_norm": layers.norm_specs(cfg.norm)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (sh.D_MODEL, sh.VOCAB)
    return specs


def param_segments(cfg, split: bool, gathered: bool = False) -> Params:
    """:func:`mamba2.mixer_segments` of every mixer in :func:`init`'s tree
    (the ``mamba`` subtree of each position that is not attention)."""
    return {"blocks": {f"pos{j}": {"mamba": mamba2.mixer_segments(cfg, split, gathered)}
                       for j in range(_period(cfg)) if not _pos_kinds(cfg, j)[0]}}


def init(cfg, generator: torch.Generator, device="cuda") -> Params:
    """Random parameters on ``device`` from ``generator``, the reference's
    tree and scales: projections ``N(0, 1) / sqrt(fan_in)``, the embedding
    ``N(0, 1) * 0.02``, zero-centred norm scales, the mixers as
    :func:`mamba2.mixer_init` and the MoE FFNs as :func:`moe.moe_init`.
    Filled one matrix at a time in the model dtype, so the peak memory is
    the parameters themselves."""
    dtype = _dtype(cfg.dtype)
    period = _period(cfg)
    n = cfg.num_layers // period
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        t = torch.empty((n,) + shape, dtype=dtype, device=device)
        for i in range(n):
            t[i].normal_(generator=generator)
        return t.mul_(torch.tensor(scale, dtype=dtype, device=device))

    embed = torch.empty((cfg.vocab_size, d), dtype=dtype, device=device)
    embed.normal_(generator=generator)
    embed.mul_(torch.tensor(0.02, dtype=dtype, device=device))
    blocks = {}
    for j in range(period):
        is_attn, is_moe = _pos_kinds(cfg, j)
        p: Params = {"norm1": layers.norm_init(d, cfg.norm, dtype, device, (n,))}
        if is_attn:
            p["attn"] = {"wq": normal((d, cfg.q_dim), 1 / math.sqrt(d)),
                         "wk": normal((d, cfg.kv_dim), 1 / math.sqrt(d)),
                         "wv": normal((d, cfg.kv_dim), 1 / math.sqrt(d)),
                         "wo": normal((cfg.q_dim, d), 1 / math.sqrt(cfg.q_dim))}
        else:
            p["mamba"] = mamba2.mixer_init(cfg, generator, device, dtype, n)
        p["norm2"] = layers.norm_init(d, cfg.norm, dtype, device, (n,))
        if is_moe:
            p["moe"] = moe.moe_init(cfg, generator, device, stack=n)
        else:
            p["mlp"] = {"gate": normal((d, f), 1 / math.sqrt(d)),
                        "up": normal((d, f), 1 / math.sqrt(d)),
                        "down": normal((f, d), 1 / math.sqrt(f))}
        blocks[f"pos{j}"] = p
    params = {"embed": embed, "blocks": blocks,
              "final_norm": layers.norm_init(d, cfg.norm, dtype, device)}
    if not cfg.tie_embeddings:
        head = torch.empty((d, cfg.vocab_size), dtype=dtype, device=device)
        head.normal_(generator=generator)
        params["lm_head"] = head.mul_(torch.tensor(1 / math.sqrt(d), dtype=dtype,
                                                   device=device))
    return params


def _layer(p: Params, x: torch.Tensor, *, cfg, is_attn: bool, ssd_chunk: int,
           split: Optional[sh.ModelSplit] = None, fsdp: Optional[sh.DataSplit] = None,
           fsdp_dims=None, data=None):
    """One layer: ``x + attn(norm1(x))`` (no RoPE, causal) or ``x +
    mamba(norm1(x))``, then ``+ ffn(norm2(x))`` -> ``(x, aux)``; the MoE
    routes at the config's capacity factor, a dense layer's aux is 0.
    Under FSDP the layer's weights are gathered over ``"data"`` here."""
    if fsdp is not None:
        p = fsdp.gather(p, fsdp_dims)
    if is_attn:
        a, _ = transformer.attention_block({"attn_norm": p["norm1"], "attn": p["attn"]}, cfg,
                                           x, None, cfg.rope_theta, 0, "causal", split=split)
    else:
        a = mamba2.mixer_apply(p["mamba"], cfg, transformer.norm_rows(x, p["norm1"], cfg, split),
                               chunk=ssd_chunk, split=split)
    x = x + a
    f, aux = transformer.ffn_block(p, cfg, x, split, data, norm="norm2")
    return x + f, aux


def forward(params: Params, cfg, tokens: torch.Tensor, block_q: Optional[int] = None,
            block_k: Optional[int] = None, ssd_chunk: int = 256, remat: bool = False,
            split: Optional[sh.ModelSplit] = None, fsdp: Optional[sh.DataSplit] = None,
            data=None):
    """tokens ``(B, S)`` -> ``(logits (B, S, V), aux)``: every layer in
    order (super-block ``b``, position ``j``), the final norm and the head;
    ``aux`` is a 0-d float32 tensor, the sum of the MoE layers' losses.
    ``ssd_chunk`` is the mixers' SSD chunk (``S`` a multiple of
    ``min(ssd_chunk, S)``); ``block_q`` / ``block_k`` (the reference's
    attention tiles) are accepted and ignored: the kernel's plan sets its
    own.  ``split``, ``fsdp`` and ``data`` (the sharded train step) as in
    :func:`transformer.forward`: the rank's heads, FF shard, vocab and
    mixer heads, ``S / size`` rows of the residual stream under ``seq``,
    FSDP's leaves gathered where they are used, an MoE layer's aux global
    over ``data``."""
    period = _period(cfg)
    n = cfg.num_layers // period
    block_dims = None
    if fsdp is not None:
        params, block_dims = transformer.gather_outer(params, fsdp, "blocks")
    x = transformer.split_rows(transformer.embed_tokens(params, cfg, tokens, split), split)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    slices = {j: transformer.layer_slices(params["blocks"][f"pos{j}"], n)
              for j in range(period)}
    for b in range(n):
        for j in range(period):
            body = functools.partial(
                _layer, cfg=cfg, is_attn=_pos_kinds(cfg, j)[0], ssd_chunk=ssd_chunk,
                split=split, fsdp=fsdp, data=data,
                fsdp_dims=None if block_dims is None else block_dims[f"pos{j}"])
            x, aux_l = transformer.run_layer(body, remat, slices[j][b], x)
            aux = aux + aux_l
    return transformer.lm_logits(params, cfg, x, split), aux
