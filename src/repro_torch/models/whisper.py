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
"""

from __future__ import annotations

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


def _self_attn(p: Params, cfg, x: torch.Tensor, mask_kind: str) -> torch.Tensor:
    """Self-attention without RoPE: QKV, ``blocked_attend`` under
    ``mask_kind``, ``wo``."""
    q, k, v = layers.qkv_project(p["attn"], x, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.head_dim, positions=None, rope_theta=cfg.rope_theta)
    out = attention.blocked_attend(q, k, v, mask_kind=mask_kind)
    B, S = out.shape[:2]
    return layers.wdot(out.reshape(B, S, -1), p["attn"]["wo"])


def encode(params: Params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames ``(B, encoder_seq, d_audio)`` -> memory ``(B, encoder_seq,
    d_model)`` in the model dtype: ``audio_proj``, the sinusoidal table,
    each layer ``x + attn(ln(x))`` (full mask) and ``x + mlp(ln(x))``, the
    final layer norm."""
    dtype = _dtype(cfg.dtype)
    x = layers.wdot(frames.to(dtype), params["audio_proj"])
    x = x + layers.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(dtype)[None]
    for p in transformer.layer_slices(params["encoder"], cfg.encoder_layers):
        x = x + _self_attn(p, cfg, layers.apply_norm(x, p["norm1"], cfg.norm), "full")
        x = x + layers.mlp_apply(p["mlp"], layers.apply_norm(x, p["norm2"], cfg.norm), "gelu")
    return layers.apply_norm(x, params["enc_final_norm"], cfg.norm)


def _memory_kv(p: Params, cfg, memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross K / V ``(B, S_enc, Hk, Dh)`` from the memory."""
    B = memory.shape[0]
    km = layers.wdot(memory, p["xattn"]["wk"]).reshape(B, -1, cfg.num_kv_heads, cfg.head_dim)
    vm = layers.wdot(memory, p["xattn"]["wv"]).reshape(B, -1, cfg.num_kv_heads, cfg.head_dim)
    return km, vm


def _decoder_layer(p: Params, x: torch.Tensor, memory: torch.Tensor, *, cfg) -> torch.Tensor:
    B, S = x.shape[:2]
    x = x + _self_attn(p, cfg, layers.apply_norm(x, p["norm1"], cfg.norm), "causal")
    h = layers.apply_norm(x, p["norm_x"], cfg.norm)
    q = layers.wdot(h, p["xattn"]["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    km, vm = _memory_kv(p, cfg, memory)
    xa = attention.blocked_attend(q, km, vm, mask_kind="full")
    x = x + layers.wdot(xa.reshape(B, S, -1), p["xattn"]["wo"])
    return x + layers.mlp_apply(p["mlp"], layers.apply_norm(x, p["norm2"], cfg.norm), "gelu")


def decode_train(params: Params, cfg, tokens: torch.Tensor, memory: torch.Tensor,
                 block_q: Optional[int] = None, block_k: Optional[int] = None,
                 remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder pass: tokens ``(B, S)``, memory ``(B, S_enc,
    d_model)`` -> logits ``(B, S, V)``.  Each layer: causal self-attention,
    cross-attention (``full``, S queries over S_enc keys), the GELU MLP,
    each behind its layer norm; then the final norm and the tied head.
    ``remat`` recomputes each layer in the backward (the reference's
    ``jax.checkpoint``); ``block_q`` / ``block_k`` are accepted and ignored,
    as in :func:`transformer.forward`."""
    dtype = _dtype(cfg.dtype)
    S = tokens.shape[1]
    x = params["embed"][tokens].to(dtype)
    x = x + layers.sinusoidal_positions(S, cfg.d_model, x.device).to(dtype)[None]
    body = functools.partial(_decoder_layer, cfg=cfg)
    for p in transformer.layer_slices(params["decoder"], cfg.num_layers):
        x = transformer.run_layer(body, remat, p, x, memory)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    return layers.matmul(x, params["embed"].T.to(dtype))


def forward(params: Params, cfg, tokens: torch.Tensor, frames: torch.Tensor, **kw):
    """The whole encoder-decoder pass -> ``(logits (B, S, V), aux 0.0)``;
    ``kw`` (``block_q``, ``block_k``, ``remat``) go to the decoder, as in
    the reference (its encoder has no remat)."""
    logits = decode_train(params, cfg, tokens, encode(params, cfg, frames), **kw)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def cross_kv(params: Params, cfg, memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K / V of ``memory`` ``(B, S_enc,
    d_model)``, heads-major and stacked as the cache holds them: ``(L, B,
    Hk, S_enc, Dh)`` each, in the model dtype.  The arithmetic of
    :func:`decode_train`'s ``km`` / ``vm``; the caller writes them into
    ``cache["cross_k"]`` / ``cache["cross_v"]`` (the reference's serving
    test does the same by hand)."""
    dtype = _dtype(cfg.dtype)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        km, vm = _memory_kv(transformer.layer_params(params["decoder"], i), cfg, memory)
        ks.append(km.transpose(1, 2).to(dtype))
        vs.append(vm.transpose(1, 2).to(dtype))
    return torch.stack(ks), torch.stack(vs)
