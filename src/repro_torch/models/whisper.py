"""Whisper-medium encoder-decoder backbone (audio frontend stubbed).

Counterpart of :mod:`repro.models.whisper`.  The conv frontend is a stub:
the caller hands in post-conv frame embeddings ``frames`` ``(B,
encoder_seq, d_audio)``.  The encoder is bidirectional attention over the
projected frames; each decoder layer runs causal self-attention,
cross-attention to the encoder memory and a GELU MLP.  Positions are
sinusoidal (the extended table of :func:`layers.sinusoidal_positions`):
the whole-sequence paths apply no RoPE (``positions=None``), as the
reference's.  Every attention here goes through
:func:`repro_torch.core.attention.blocked_attend`, so it launches the
``flash_attention`` kernel on CUDA tensors: the encoder's ``full`` over
``encoder_seq`` keys, the decoder's ``causal``, and the cross-attention's
``full`` with ``Sq != Sk``.

Parameters keep the reference's tree: ``embed``, ``audio_proj`` ``(d_audio,
d_model)``, ``encoder/{norm1, attn/{wq, wk, wv, wo}, norm2, mlp/{up, up_b,
down, down_b}}`` stacked over ``encoder_layers``, ``decoder/{... , norm_x,
xattn/{wq, wk, wv, wo}}`` stacked over ``num_layers``, ``enc_final_norm``
and ``final_norm`` (layer norms: ``scale`` and ``bias``).  No projection
has a bias; the head is the tied ``embed.T``.  Every projection contracts
through :func:`layers.wdot`: the reference's ``qkv_project`` does too, and
for its plain ``x @ w`` (the other projections) ``wdot``'s raw-leaf branch
is that product, in the dtype ``jnp`` promotes to (enc_dec serves raw bf16
weights only, so no record reaches it).

Serving: the encoder runs once per request (:func:`encode`), its memory is
projected into the cache's ``cross_k`` / ``cross_v`` by :func:`cross_kv`,
and ``engine.make_serve_step`` decodes a token a step from position 0.

On a ``(data, model)`` mesh (explicit SPMD) each function takes a rank's
``split`` (:class:`repro_torch.distributed.sharding.ModelSplit`), as the
transformer's blocks do, whose code the layers here share
(:func:`transformer.attention_block` and :func:`transformer.ffn_block`
under whisper's norm names).  Serving: the encoder and the cross memory on
the rank's heads (column shards of ``wq`` / ``wk`` / ``wv``, the heads'
outputs gathered before the replicated ``wo``), so a sharded run gives
one device's bits.  Training: Megatron's split in both stacks, the
decoder's residual split by sequence under ``sp`` and the encoder's never
(the reference constrains it ``(batch, None, None)``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import attention
from repro_torch.distributed import sharding as sh
from repro_torch.models import layers, transformer
from repro_torch.models.layers import _dtype

Params = Dict[str, Any]


def param_specs(cfg) -> Params:
    """The logical-axis tree of :func:`init`'s parameters."""
    enc = {"norm1": layers.norm_specs(cfg.norm), "attn": layers.attention_specs(),
           "norm2": layers.norm_specs(cfg.norm), "mlp": layers.mlp_specs("gelu")}
    dec = dict(enc, norm_x=layers.norm_specs(cfg.norm), xattn=layers.attention_specs())
    return {"embed": (sh.VOCAB, sh.D_MODEL), "audio_proj": (None, sh.D_MODEL),
            "encoder": sh.stacked(enc), "decoder": sh.stacked(dec),
            "enc_final_norm": layers.norm_specs(cfg.norm),
            "final_norm": layers.norm_specs(cfg.norm)}


def init(cfg, generator: torch.Generator, device="cuda") -> Params:
    """Random parameters on ``device`` from ``generator``: the embedding
    ``N(0, 1) * 0.02``, projections ``N(0, 1) / sqrt(fan_in)``, layer norms
    of scale 1 and bias 0, the MLP biases 0 (the reference's initialisers).
    Filled a layer at a time in the model dtype: 1.52 GB for
    whisper-medium in bf16."""
    dtype = _dtype(cfg.dtype)
    d, f, q, kv = cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim

    def normal(shape, scale):
        t = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            t[i].normal_(generator=generator)
        return t.mul_(torch.tensor(scale, dtype=dtype, device=device))

    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    norm = lambda L: layers.norm_init(d, cfg.norm, dtype, device, (L,))
    attn = lambda L: {"wq": normal((L, d, q), 1 / math.sqrt(d)),
                      "wk": normal((L, d, kv), 1 / math.sqrt(d)),
                      "wv": normal((L, d, kv), 1 / math.sqrt(d)),
                      "wo": normal((L, q, d), 1 / math.sqrt(q))}

    def stack(L, cross):
        lay = {"norm1": norm(L), "attn": attn(L), "norm2": norm(L),
               "mlp": {"up": normal((L, d, f), 1 / math.sqrt(d)), "up_b": zeros(L, f),
                       "down": normal((L, f, d), 1 / math.sqrt(f)), "down_b": zeros(L, d)}}
        if cross:
            lay["norm_x"] = norm(L)
            lay["xattn"] = attn(L)
        return lay

    embed = torch.empty((cfg.vocab_size, d), dtype=dtype, device=device)
    embed.normal_(generator=generator)
    embed.mul_(torch.tensor(0.02, dtype=dtype, device=device))
    return {
        "embed": embed,
        "audio_proj": normal((cfg.d_audio, d), 1 / math.sqrt(cfg.d_audio)),
        "encoder": stack(cfg.encoder_layers, cross=False),
        "decoder": stack(cfg.num_layers, cross=True),
        "enc_final_norm": layers.norm_init(d, cfg.norm, dtype, device),
        "final_norm": layers.norm_init(d, cfg.norm, dtype, device),
    }


def _self_attn(p: Params, cfg, x: torch.Tensor, mask_kind: str,
               split: Optional[sh.ModelSplit] = None) -> torch.Tensor:
    """``x + `` the layer-normed self-attention without RoPE under
    ``mask_kind`` (:func:`transformer.attention_block` on the leaves under
    its names: a mesh rank's ``split`` projects and attends its heads)."""
    a, _ = transformer.attention_block({"attn_norm": p["norm1"], "attn": p["attn"]}, cfg, x,
                                       None, cfg.rope_theta, 0, mask_kind, split=split)
    return x + a


def _mlp(p: Params, cfg, x: torch.Tensor, split: Optional[sh.ModelSplit]) -> torch.Tensor:
    """``x + `` the layer-normed GELU MLP (:func:`transformer.ffn_block`)."""
    f, _ = transformer.ffn_block(p, cfg, x, split, norm="norm2")
    return x + f


def _encoder_layer(p: Params, x: torch.Tensor, *, cfg, split=None, fsdp=None, fsdp_dims=None):
    if fsdp is not None:
        p = fsdp.gather(p, fsdp_dims)
    return _mlp(p, cfg, _self_attn(p, cfg, x, "full", split), split)


def encode(params: Params, cfg, frames: torch.Tensor, split: Optional[sh.ModelSplit] = None,
           fsdp: Optional[sh.DataSplit] = None, fsdp_dims=None) -> torch.Tensor:
    """frames ``(B, encoder_seq, d_audio)`` -> memory ``(B, encoder_seq,
    d_model)`` in the model dtype: ``audio_proj``, the sinusoidal table,
    each layer ``x + attn(ln(x))`` (full mask) and ``x + mlp(ln(x))``, the
    final layer norm.

    A mesh rank's ``split`` runs its heads of every layer (K5 over the
    whole ``encoder_seq`` on the rank's heads): serving gathers them before
    the replicated ``wo`` and runs the MLP whole, a training split holds
    ``wo`` and the MLP row-parallel (:func:`transformer.attention_block`,
    :func:`transformer.ffn_block`).  The encoder's residual is never split
    by sequence (the reference constrains it ``(batch, None, None)``), so a
    training split's ``seq`` is off here whatever the decoder's.  The rows
    are the caller's: a data rank encodes its own slots' (or its batch
    rows') frames.  ``fsdp`` / ``fsdp_dims``: the encoder stack's leaves
    held in blocks over ``"data"``, gathered inside each layer (the outer
    leaves already whole: :func:`forward`)."""
    if split is not None and split.seq:
        split = dataclasses.replace(split, seq=False)
    dtype = _dtype(cfg.dtype)
    x = layers.wdot(frames.to(dtype), params["audio_proj"])
    x = x + layers.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(dtype)[None]
    for p in transformer.layer_slices(params["encoder"], cfg.encoder_layers):
        x = _encoder_layer(p, x, cfg=cfg, split=split, fsdp=fsdp, fsdp_dims=fsdp_dims)
    return layers.apply_norm(x, params["enc_final_norm"], cfg.norm)


def _memory_kv(p: Params, cfg, memory: torch.Tensor, split: Optional[sh.ModelSplit] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross K / V ``(B, S_enc, Hk, Dh)`` from the memory
    (a mesh rank's ``split``: its kv heads, from its columns of ``wk`` /
    ``wv``)."""
    B = memory.shape[0]
    _, Hk = sh.local_heads(cfg, split)
    km = layers.wdot(memory, p["xattn"]["wk"]).reshape(B, -1, Hk, cfg.head_dim)
    vm = layers.wdot(memory, p["xattn"]["wv"]).reshape(B, -1, Hk, cfg.head_dim)
    return km, vm


def _cross_attn(p: Params, cfg, x: torch.Tensor, memory: torch.Tensor,
                split: Optional[sh.ModelSplit] = None) -> torch.Tensor:
    """``x + `` the cross-attention: the layer-normed queries (``full``, S
    queries over S_enc memory rows) and ``wo``.  A mesh rank's ``split``
    attends its heads (``wq`` / ``wk`` / ``wv`` columns).  Serving gathers
    them before the replicated ``wo``; a training split enters and leaves
    the block as the self-attention does (the sequence gathered under
    ``seq``, ``wo`` row-parallel); the memory's gradient is summed over
    the model axis once, for every layer, by :func:`decode_train`."""
    h = transformer.norm_rows(x, p["norm_x"], cfg, split)
    rows = sh.training(split)
    if rows:
        h = sh.enter_block(h, split, split.heads)
    Hq, _ = sh.local_heads(cfg, split)
    B, S = h.shape[:2]
    q = layers.wdot(h, p["xattn"]["wq"]).reshape(B, S, Hq, cfg.head_dim)
    km, vm = _memory_kv(p, cfg, memory, split)
    xa = attention.blocked_attend(q, km, vm, mask_kind="full")
    if not rows:
        xa = sh.gather_heads(xa, split, 2)
    out = layers.wdot(xa.reshape(B, S, -1), p["xattn"]["wo"])
    if rows:
        out = sh.leave_block(out, split, split.heads)
    return x + out


def _decoder_layer(p: Params, x: torch.Tensor, memory: torch.Tensor, *, cfg, split=None,
                   fsdp=None, fsdp_dims=None) -> torch.Tensor:
    if fsdp is not None:
        p = fsdp.gather(p, fsdp_dims)
    x = _self_attn(p, cfg, x, "causal", split)
    return _mlp(p, cfg, _cross_attn(p, cfg, x, memory, split), split)


def decode_train(params: Params, cfg, tokens: torch.Tensor, memory: torch.Tensor,
                 block_q: Optional[int] = None, block_k: Optional[int] = None,
                 remat: bool = False, split: Optional[sh.ModelSplit] = None,
                 fsdp: Optional[sh.DataSplit] = None, fsdp_dims=None) -> torch.Tensor:
    """Teacher-forced decoder pass: tokens ``(B, S)``, memory ``(B, S_enc,
    d_model)`` -> logits ``(B, S, V)``.  Each layer: causal self-attention,
    cross-attention (``full``, S queries over S_enc keys), the GELU MLP,
    each behind its layer norm; then the final norm and the tied head.
    ``remat`` recomputes each layer in the backward (the reference's
    ``jax.checkpoint``); ``block_q`` / ``block_k`` are accepted and ignored,
    as in :func:`transformer.forward`.  A mesh rank's training ``split``
    runs its heads, FF shard and (under ``seq``) its ``S / size`` rows of
    the residual, the vocab-split embedding and head where the model axis
    divides the vocab (whisper-medium's 51865 is odd: the tied embedding
    and head stay whole on every model rank); ``fsdp`` / ``fsdp_dims`` the
    decoder stack's blocks over ``"data"``, gathered inside each layer.
    Each model rank projects only its heads' cross K / V from the memory,
    so the memory's gradient is the sum of the ranks' parts: it is summed
    over the model axis (:func:`sh.copy_to`) once, after every layer's
    part has been added in the one-device order, before it flows back
    into the replicated encoder."""
    dtype = _dtype(cfg.dtype)
    S = tokens.shape[1]
    if sh.training(split) and split.heads:
        memory = sh.copy_to(memory, split.group)
    x = transformer.embed_tokens(params, cfg, tokens, split)
    x = x + layers.sinusoidal_positions(S, cfg.d_model, x.device).to(dtype)[None]
    x = transformer.split_rows(x, split)
    body = functools.partial(_decoder_layer, cfg=cfg, split=split, fsdp=fsdp,
                             fsdp_dims=fsdp_dims)
    for p in transformer.layer_slices(params["decoder"], cfg.num_layers):
        x = transformer.run_layer(body, remat, p, x, memory)
    return transformer.lm_logits(params, cfg, x, split)


def forward(params: Params, cfg, tokens: torch.Tensor, frames: torch.Tensor,
            block_q: Optional[int] = None, block_k: Optional[int] = None,
            remat: bool = False, split: Optional[sh.ModelSplit] = None,
            fsdp: Optional[sh.DataSplit] = None, data=None):
    """The whole encoder-decoder pass -> ``(logits (B, S, V), aux 0.0)``;
    ``block_q``, ``block_k`` and ``remat`` go to the decoder, as in the
    reference (its encoder has no remat).  The sharded train step's
    ``split`` and ``fsdp`` go to both stacks (:func:`encode`,
    :func:`decode_train`); under FSDP the leaves outside the two stacks
    are gathered whole first.  ``data`` (an MoE's aux group) is accepted
    and unused: whisper has no MoE."""
    enc_dims = dec_dims = None
    if fsdp is not None:
        params, (enc_dims, dec_dims) = transformer.gather_outer(params, fsdp,
                                                                ("encoder", "decoder"))
    memory = encode(params, cfg, frames, split, fsdp, enc_dims)
    logits = decode_train(params, cfg, tokens, memory, block_q, block_k, remat, split, fsdp,
                          dec_dims)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def cross_kv(params: Params, cfg, memory: torch.Tensor,
             split: Optional[sh.ModelSplit] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K / V of ``memory`` ``(B, S_enc,
    d_model)``, heads-major and stacked as the cache holds them: ``(L, B,
    Hk, S_enc, Dh)`` each, in the model dtype.  The arithmetic of
    :func:`decode_train`'s ``km`` / ``vm``; the caller writes them into
    ``cache["cross_k"]`` / ``cache["cross_v"]`` (the reference's serving
    test does the same by hand).  A mesh rank's ``split`` (with its
    serving shard of the parameters and its rows of the memory) gives its
    kv heads, ``(L, B / data, Hk / model, S_enc, Dh)``: its block of the
    sharded cache's cross memory."""
    dtype = _dtype(cfg.dtype)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        km, vm = _memory_kv(transformer.layer_params(params["decoder"], i), cfg, memory, split)
        ks.append(km.transpose(1, 2).to(dtype))
        vs.append(vm.transpose(1, 2).to(dtype))
    return torch.stack(ks), torch.stack(vs)
