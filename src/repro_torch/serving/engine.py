"""Serving engine: single-token batched decode (``serve_step``), whole-
sequence prefill (``prefill``, ``prefill_into_slot``) and chunked prefill
for dense, MoE and VLM transformers over the paged or slot KV cache.

Counterpart of :mod:`repro.serving.engine`, transformer branch: global
layers over the full-sequence store and, for gemma3's and mixtral's
sliding-window and llama4-scout's chunked-local layers, local layers over
ring buffers of ``local_window`` lanes a slot (a stack may have no global
layer at all: mixtral's).  An MoE layer routes dropless in the decode and
chunk steps (``capacity_factor = E``), as the reference's
``_ffn_decode_layer`` does: capacity is pooled over the batch, so drops
would couple a slot to its neighbours and let a chunk's padded lanes take
capacity from its prompt tokens; the whole-sequence paths run
``transformer.forward`` at the config's capacity factor.

    serve_step(params, cache, tokens (B, 1)) -> (logits (B, 1, V), cache)
    prefill(params, cfg, layout, tokens (B, S)[, vision_embeds])
        -> (logits (B, 1, V), cache)
    prefill_into_slot(params, cfg, layout, cache, slot, prompt (S,)[, vision_embeds])
        -> (logits (1, 1, V), cache)

A VLM's image prefix enters only through the two whole-sequence paths'
``vision_embeds``, as the reference's ``**fw_kw``: decode and chunked
admission take text alone.  They keep the reference's positions: every
one of the ``Tv + S`` lanes the forward returns is written (in the paged
layout the lanes past the mapped pages drop), but ``pos`` is the text
length ``S``, so the first decode writes at lane ``S``, inside the
prefix's rows.

The two whole-sequence paths run ``transformer.forward`` (whose attention
launches the ``flash_attention`` kernel on the card) and write every
layer's K/V through ``kv_cache.write_prefill``; ``prefill_into_slot`` is
the Scheduler's eager admission.

``make_serve_step``, ``make_prefill_chunk`` / ``ChunkedPrefill`` and
``prefill_into_slot`` take the reference's ``rules``: with a mesh the
dense, MoE and VLM families run as explicit SPMD on this rank's shard
(:class:`repro_torch.serving.sharded.Shard`): q / k / v on the rank's
heads, its slots of the decode batch, the KV writes and attends local, one
all-gather of the heads' attend outputs over ``"model"`` before ``wo``,
the vocab-split embedding and head, the logits gathered over ``"model"``
then ``"data"``; a paged pool takes the step's K / V rows of every data
rank.  The kernels plan at the whole launch's geometry.  An MoE layer's
experts are replicated and route dropless over the rank's slots.
``make_serve_step`` also runs the ssm and hybrid families on a mesh: a
mamba layer steps the rank's heads of its slots' state and gathers the
gated product over ``"model"`` before the replicated norm and
``out_proj`` (:func:`repro_torch.models.mamba2.mixer_decode_step`); the
hybrid's attention layer is the dense one on the rank's heads; an enc_dec
layer's self-attention is too, and its cross-attention attends the rank's
heads over its block of the cross memory (slot-major on ``"data"`` in
both layouts) and gathers them over ``"model"`` before the replicated
``xattn.wo``.  No rules (or no mesh) is the single-device path,
unchanged.

``make_serve_step`` also decodes the families the reference decodes
outside its Scheduler: ssm (a mamba state a layer, no KV), hybrid (jamba:
per layer, the attention layers over the global store without RoPE and
the mamba layers over their state, each followed by its FFN, the MoE
dropless) and enc_dec
(whisper: the per-slot sinusoid on the token embedding; per decoder layer
the self-attention over the global store with RoPE at ``cfg.rope_theta``,
as the reference's decode applies it though its forward does not, then
cross-attention over the cache's ``cross_k`` / ``cross_v``, which the
caller fills from the encoder, then the GELU MLP).

Positions are per slot (``cache["pos"]`` is ``(B,)``), so staggered
requests share one batch.  The global-layer decode attend always goes
through :mod:`repro_torch.serving.kernel_decode`: the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors.  The local layers'
attends (decode over the ring, ``_chunk_attend_local`` in chunked prefill)
and whisper's cross attend are plain PyTorch on every device, as they are
``jnp`` in the reference, which has no kernel for them.  The cache is updated
in place (the reference's steps returned a new tree; the port returns the
same one).  PyTorch runs eagerly: there is no jit, and a ``ChunkedPrefill``
"compile" is the first run of a bucket width.

A serve step built with ``weight_format`` int8 or bstc takes the records
of :func:`repro_torch.serving.weights.prepare_serve_params`: bstc decode
projections run the ``bstc_matmul`` kernel on the coded weight planes.
Chunked prefill always reads the raw parameter tree.

The engine's own decode attends (``_decode_attend``, ``_bgpp_topk_indices``,
``_bgpp_formal_attend``, ``_bgpp_decode_attend``,
``_bgpp_paged_decode_attend``) are the reference's layer-level plain
versions, built from the same pieces as the kernels' plain versions.  The
serving path never calls them; they exist as test oracles, held against
the reference's engine attends.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import require_served, require_transformer
from repro_torch.core.attention import NEG_INF
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.bgpp_paged_attend import ref as bgpp_ref
from repro_torch.kernels.paged_flash_decode.ref import dense_attend, int8_attend, softmax
from repro_torch.models import layers, mamba2, transformer
from repro_torch.serving import kernel_decode, kv_cache as kvc, sharded as shd, weights as swt

Tree = Dict[str, Any]


# --------------------------------------------------------------------------
# attention over the cache stacks
# --------------------------------------------------------------------------


def _groups(cfg, Hq: int, who: str) -> Tuple[int, int]:
    """(Hk, g) for an operand carrying ``Hq`` query heads."""
    if cfg.num_heads % cfg.num_kv_heads:
        raise ValueError(
            f"{who}: num_heads={cfg.num_heads} not a multiple of "
            f"num_kv_heads={cfg.num_kv_heads} — GQA grouping needs an "
            f"integral ratio"
        )
    g = cfg.num_heads // cfg.num_kv_heads
    if Hq % g:
        raise ValueError(f"{who}: operand carries Hq={Hq} heads, not a "
                         f"multiple of the GQA group size g={g}")
    return Hq // g, g


def _cache_attend(q, entry: Tree, valid, cfg, fmt: str, head_mask=None):
    """Attention over the heads-major cache for Q query tokens per row.

    q ``(B, Q, Hq, Dh)``; entry heads-major ``(B, Hk, S, ...)`` leaves;
    valid ``(B, Q, S)`` bool; head_mask ``(B, Hk, S)``.  The int8 format
    runs the paper's 8-bit QK^T (A2) and 8-bit PV (A3).  Decode calls it
    with Q=1, chunked prefill with Q=chunk.  Returns f32 ``(B, Q, Hq, Dh)``.
    """
    B, Q, Hq, Dh = q.shape
    Hk, g = _groups(cfg, Hq, "_cache_attend")
    qg = q.reshape(B, Q, Hk, g, Dh).permute(0, 2, 3, 1, 4).float()
    mask = valid[:, None, None]  # (B, 1, 1, Q, S)
    if head_mask is not None:
        mask = mask & head_mask[:, :, None, None, :]
    if fmt == "bf16":
        out = dense_attend(qg, entry["k"], entry["v"], mask)
    else:
        out = int8_attend(qg, entry["k"], entry["k_scale"], entry["v"],
                          entry["v_scale"], mask)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Q, Hq, Dh)


def _decode_attend(q, entry, valid, cfg, fmt, head_mask=None):
    """Single-token wrapper: q ``(B, Hq, Dh)``, valid ``(B, S)`` -> ``(B, Hq, Dh)``."""
    return _cache_attend(q[:, None], entry, valid[:, None], cfg, fmt,
                         head_mask=head_mask)[:, 0]


def _bgpp_quant_query(q, cfg):
    """Quantize + MSB-truncate the decode query: ``(B, Hq, Dh)`` -> f32
    ``(B, Hk, g, Dh)`` (the paper's 4-bit MSB query precompute)."""
    B, Hq, Dh = q.shape
    Hk, g = _groups(cfg, Hq, "_bgpp_quant_query")
    return bgpp_ref.quant_query(q.reshape(B, Hk, g, Dh))


def _bgpp_topk_indices(qf, plane0, sign_full, plane_at, valid, cfg):
    """Progressive MSB-first top-k prediction (phase 1 of BGPP decode) with
    the plan from :func:`kv_cache.bgpp_decode_plan`; see
    :func:`repro_torch.kernels.bgpp_paged_attend.ref.progressive_topk`.
    Returns ``(idx (B, Hk, k_max), idx_valid)``."""
    rounds, k_max, survivors = kvc.bgpp_decode_plan(valid.shape[1], cfg)
    return bgpp_ref.progressive_topk(qf, plane0, sign_full, plane_at, valid,
                                     rounds, k_max, survivors)


def _bgpp_formal_attend(q, gathered: Tree, idx_valid, cfg):
    """Phase 2 of BGPP decode: the exact int8 attend (A2/A3) over the
    compacted survivors ``gathered`` (``k_planes (NBITS, B, Hk, k, D/8)``,
    ``k_sign``, ``k_scale``, ``v``, ``v_scale``).  q ``(B, Hq, Dh)``."""
    B, Hq, Dh = q.shape
    Hk, g = _groups(cfg, Hq, "_bgpp_formal_attend")
    out = bgpp_ref.formal_attend(
        q.reshape(B, Hk, g, Dh), gathered["k_planes"], gathered["k_sign"],
        gathered["k_scale"], gathered["v"], gathered["v_scale"], idx_valid,
    )
    return out.reshape(B, Hq, Dh)


def _bgpp_decode_attend(q, entry: Tree, valid, cfg):
    """BGPP progressive decode over a FULL heads-major entry (the slot
    layout's layer-level plain version): q ``(B, Hq, Dh)``."""
    qf = _bgpp_quant_query(q, cfg)
    take = lambda x, i: torch.gather(x, 2, i[..., None].expand(-1, -1, -1, x.shape[-1]))
    idx, idx_valid = _bgpp_topk_indices(
        qf, entry["k_planes"][kvc.NBITS - 1], entry["k_sign"],
        lambda p, i: take(entry["k_planes"][p], i), valid, cfg,
    )
    gathered = {
        "k_planes": torch.stack([take(entry["k_planes"][p], idx)
                                 for p in range(kvc.NBITS)]),
        "k_sign": take(entry["k_sign"], idx),
        "k_scale": torch.gather(entry["k_scale"], 2, idx),
        "v": take(entry["v"], idx),
        "v_scale": torch.gather(entry["v_scale"], 2, idx),
    }
    return _bgpp_formal_attend(q, gathered, idx_valid, cfg)


def _bgpp_paged_decode_attend(q, store: Tree, gi: int, phys, valid, cfg):
    """Two-phase BGPP decode on the paged pool (the layer-level plain
    version): phase 1 reads the sign and MSB planes at full width and one
    more plane per round for the survivors; phase 2 gathers only the
    ``k_max`` survivors' full rows."""
    qf = _bgpp_quant_query(q, cfg)
    idx, idx_valid = _bgpp_topk_indices(
        qf, kvc.paged_plane(store, gi, kvc.NBITS - 1, phys),
        kvc.paged_sign(store, gi, phys),
        lambda p, i: kvc.paged_plane_rows(store, gi, p, kvc.paged_rows_at(phys, i)),
        valid, cfg,
    )
    gathered = kvc.paged_topk_entry(store, gi, kvc.paged_rows_at(phys, idx))
    return _bgpp_formal_attend(q, gathered, idx_valid, cfg)


# --------------------------------------------------------------------------
# per-layer decode bodies
# --------------------------------------------------------------------------


def _paged_kw(layout):
    return dict(page_size=layout.page_size, max_seq=layout.max_seq)


def _local_decode_attend(q1, cache, li: int, k, v, pos, cfg, layout, layer_idx: int,
                         rows: slice = slice(None)):
    """One local (ring) layer's decode: the tokens' K/V ``(N, 1, Hk, Dh)``
    at ``pos`` ``(N,)`` land at lane ``pos % W`` with ``abs_pos`` = pos, then
    q ``(B, Hq, Dh)`` attends the lanes of ring rows ``rows`` inside its
    sliding (or chunked) window — plain PyTorch, as the reference's
    ``jnp``.  Returns f32 ``(B, Hq, Dh)``."""
    store = cache["local"]
    lane = (pos % layout.local_window).long()
    kvc.write_token(store, li, k, v, lane)
    store["abs_pos"][li, torch.arange(k.shape[0], device=pos.device), lane] = pos
    pos = pos[rows]
    abs_pos, pos_c = store["abs_pos"][li][rows], pos[:, None]  # (B, W), (B, 1)
    kind, w = cfg.layer_attn_window(layer_idx)
    if kind == "chunked":
        valid = (abs_pos >= 0) & (abs_pos // w == pos_c // w) & (abs_pos <= pos_c)
    else:
        valid = (abs_pos >= 0) & (pos_c - abs_pos < w) & (abs_pos <= pos_c)
    entry = {n: a[li][rows] for n, a in store.items() if n != "abs_pos"}
    return _decode_attend(q1, entry, valid, cfg, kvc.local_format(layout))


def _attn_decode_layer(p, norm, cfg, layout, cache, x, pos, layer_idx, theta, phys=None,
                       shard=None, pos_all=None):
    """x ``(B, 1, D)``, pos per-slot ``(B,)``; ``norm`` the layer's
    pre-norm, ``p`` its ``attn`` (and ``post_attn_norm`` where set).
    Write-then-attend: the token's K/V land at ``pos`` first (a local
    layer: its ring lane), then a global layer's attend runs through
    :func:`kernel_decode.decode_attend` and a local layer's through
    :func:`_local_decode_attend`.  RoPE at ``theta`` on q and k; none with
    ``theta=None`` (the hybrid's attention, the reference's ``use_rope``).
    With a ``shard`` x holds the rank's slots and the projections its
    heads; where the stores are whole on every data rank (paged) the K/V
    of every slot (gathered over ``"data"``) are written at ``pos_all``
    and the rank's rows attended, and the heads' outputs are gathered over
    ``"model"`` before ``wo``.  Returns ``(out, cache)``."""
    B = x.shape[0]
    h = layers.apply_norm(x, norm, cfg.norm)
    positions = None if theta is None else pos[:, None]
    split = shd.model_split(shard)
    Hq, Hk = sh.local_heads(cfg, split)
    q, k, v = layers.qkv_project(p["attn"], h, Hq, Hk, cfg.head_dim, positions, theta,
                                 qk_norm=cfg.qk_norm)
    paged = layout.layout == "paged"
    rows, kw, vw, pw = slice(None), k, v, pos
    if shard is not None and not shard.split_stores:  # stores whole on every data rank
        rows = slice(shard.lo, shard.hi)
        kw, vw, pw = shard.gather_slots(k), shard.gather_slots(v), pos_all
    if layer_idx in layout.local_layers:
        out = _local_decode_attend(q[:, 0], cache, layout.local_layers.index(layer_idx),
                                   kw, vw, pw, cfg, layout, layer_idx, rows)
    else:
        gi = layout.global_layers.index(layer_idx)
        kvc.write_token(cache["global"], gi, kw, vw, pw,
                        **(dict(page_table=cache["page_table"], **_paged_kw(layout))
                           if paged else {}))
        out = kernel_decode.decode_attend(
            q[:, 0], cache["global"], gi, pos, cfg, layout,
            phys=None if phys is None else phys[rows],
            page_table=cache["page_table"][rows] if paged else None,
            whole=None if shard is None else (layout.batch, cfg.num_kv_heads),
        )
    out = sh.gather_heads(out, split, 1)
    # the f32 attend output meets wo as it is, like the reference's
    # ``wdot(out_f32, wo)``: at bf16 width the contraction and the residual
    # stream run in f32 from layer 0's attend on (the chunk prefill casts
    # to the activation dtype first, as the reference's does)
    out = layers.wdot(out.reshape(B, 1, -1), p["attn"]["wo"])
    if cfg.post_norms:
        out = layers.apply_norm(out, p["post_attn_norm"], cfg.norm)
    return out, cache


def _ffn_decode_layer(p, norm, cfg, x):
    """The pre-norm ``norm``, the FFN of ``p`` and its post-MLP norm where
    set, for the decode and chunk steps: an MoE layer routes dropless
    (``capacity_factor = E``)."""
    h = layers.apply_norm(x, norm, cfg.norm)
    out, _ = transformer.ffn_apply(p, cfg, h, capacity_factor=float(cfg.num_experts))
    if cfg.post_norms:
        out = layers.apply_norm(out, p["post_mlp_norm"], cfg.norm)
    return out


def _mamba_decode_layer(norm, mixer, cfg, layout: kvc.CacheLayout, cache, x,
                        layer_idx: int, split=None):
    """One mamba layer's decode token: the pre-norm ``norm``, the
    recurrence of ``mixer`` on the layer's state, the state written back
    in place -> ``(out, cache)``.  With a mesh rank's ``split`` x, the
    mixer and the state hold the rank's slots and heads (the state's rows
    are x's: slot-major on ``"data"``)."""
    mi = layout.mamba_layers.index(layer_idx)
    st = cache["mamba"]
    h = layers.apply_norm(x, norm, cfg.norm)
    out, new = mamba2.mixer_decode_step(mixer, cfg, h,
                                        {"h": st["h"][mi], "conv": st["conv"][mi]}, split)
    st["h"][mi] = new["h"]
    st["conv"][mi] = new["conv"].to(st["conv"].dtype)
    return out, cache


def _whisper_decode_layer(p, cfg, layout, cache, x, pos, layer_idx: int, phys, cross_valid,
                          shard=None, pos_all=None):
    """One whisper decoder layer's token -> ``(x, cache)``: the
    self-attention over the global store (RoPE at ``cfg.rope_theta``), the
    cross-attention (layer norm, ``wq``, the plain bf16-format attend over
    the layer's ``cross_k`` / ``cross_v`` with ``cross_valid``: every lane,
    built once a step; ``wo``) and the GELU MLP, each a residual.  With a
    ``shard`` the self-attention is :func:`_attn_decode_layer`'s on the
    rank's heads (K1 / K2 planned at the whole launch), and the cross
    attend runs the rank's q heads over its cross heads and slots, gathered
    over ``"model"`` before ``xattn.wo``."""
    B = x.shape[0]
    a, cache = _attn_decode_layer(p, p["norm1"], cfg, layout, cache, x, pos, layer_idx,
                                  cfg.rope_theta, phys=phys, shard=shard, pos_all=pos_all)
    x = x + a
    split = shd.model_split(shard)
    h = layers.apply_norm(x, p["norm_x"], cfg.norm)
    q = layers.wdot(h, p["xattn"]["wq"]).reshape(B, sh.local_heads(cfg, split)[0], cfg.head_dim)
    entry = {"k": cache["cross_k"][layer_idx], "v": cache["cross_v"][layer_idx]}
    out = sh.gather_heads(_decode_attend(q, entry, cross_valid, cfg, "bf16"), split, 1)
    x = x + layers.wdot(out.reshape(B, 1, -1), p["xattn"]["wo"])
    x = x + layers.mlp_apply(p["mlp"], layers.apply_norm(x, p["norm2"], cfg.norm), "gelu")
    return x, cache


def make_serve_step(cfg, layout: kvc.CacheLayout, rules=None):
    """Build the batched decode step for one (cfg, layout):

        serve_step(params, cache, tokens (B, 1)) -> (logits (B, 1, V), cache)

    One call decodes ONE token for every slot at its own ``cache["pos"]``
    and advances every ``pos`` by one.  Paged layouts hoist one
    logical->pool gather map per step (BGPP's kernel reads through it).
    An ssm model steps every layer's mamba state instead (no KV, no
    position in the arithmetic; ``pos`` still advances).  A hybrid model
    (jamba) takes layer ``i`` from super-block ``i // attn_every`` at
    position ``i % attn_every``: an attention layer decodes over the global
    store without RoPE, a mamba layer steps its state, and each is followed
    by its FFN (the MoE dropless).  An enc_dec model
    (whisper) adds each slot's sinusoid to the token embedding and runs,
    per decoder layer, self-attention (global, RoPE at ``cfg.rope_theta``),
    cross-attention over ``cache["cross_k"]`` / ``["cross_v"]`` and the
    GELU MLP; the cross memory must already hold the encoder's K / V
    (:func:`repro_torch.models.whisper.cross_kv`).  ``rules`` with a mesh:
    the step runs on this rank's shard of params and cache (module
    docstring; every family) and returns every slot's logits on every
    rank."""
    require_served(cfg, "make_serve_step")
    shard = shd.Shard.of(cfg, layout, rules)
    split = shd.model_split(shard)
    if layout.global_layers:
        kernel_decode.validate(cfg, layout)
    thetas = transformer.layer_thetas(cfg)
    paged = layout.layout == "paged"
    # weight_format, resolved once per built step: int8/bstc steps take the
    # records weights.prepare_serve_params builds (the Scheduler feeds them)
    weight_format = swt.resolve(cfg)
    if weight_format != "bf16":
        swt.validate(cfg)

    def serve_step(params, cache, tokens):
        """One batched decode token for every slot at its own position."""
        if weight_format != "bf16":
            swt.check_serve_params(params, cfg, weight_format)
        pos = pos_all = cache["pos"]
        phys = (kvc.phys_table(cache["page_table"], layout.page_size, layout.max_seq)
                if paged and layout.kv_format == "bgpp" and layout.global_layers else None)
        if shard is not None:
            pos, tokens = pos_all[shard.lo:shard.hi], tokens[shard.lo:shard.hi]
        x = transformer.embed_tokens(params, cfg, tokens[:, :1], split)
        if cfg.family == "enc_dec":
            x = x + layers.sinusoid_at(pos, cfg.d_model).to(x.dtype)[:, None, :]
            cross_valid = torch.ones((x.shape[0], cfg.encoder_seq), dtype=torch.bool,
                                     device=x.device)
        for i in range(cfg.num_layers):
            if cfg.family == "enc_dec":
                x, cache = _whisper_decode_layer(transformer.layer_params(params["decoder"], i),
                                                 cfg, layout, cache, x, pos, i, phys,
                                                 cross_valid, shard, pos_all)
                continue
            if cfg.family == "hybrid":
                b, j = divmod(i, cfg.attn_every)
                p = transformer.layer_params(params["blocks"][f"pos{j}"], b)
                if cfg.layer_is_attention(i):
                    a, cache = _attn_decode_layer(p, p["norm1"], cfg, layout, cache, x, pos, i,
                                                  None, phys=phys, shard=shard,
                                                  pos_all=pos_all)
                else:
                    a, cache = _mamba_decode_layer(p["norm1"], p["mamba"], cfg, layout, cache,
                                                   x, i, split)
                x = x + a
                x = x + _ffn_decode_layer(p, p["norm2"], cfg, x)
                continue
            p = transformer.layer_params(params["layers"], i)
            if cfg.family == "ssm":
                m, cache = _mamba_decode_layer(p["norm"], p["mixer"], cfg, layout, cache, x, i,
                                               split)
                x = x + m
                continue
            a, cache = _attn_decode_layer(p, p["attn_norm"], cfg, layout, cache, x, pos, i,
                                          float(thetas[i]), phys=phys, shard=shard,
                                          pos_all=pos_all)
            x = x + a
            x = x + _ffn_decode_layer(p, p["mlp_norm"], cfg, x)
        logits = transformer.lm_logits(params, cfg, x, split)
        if shard is not None:
            logits = shard.gather_slots(logits)
        cache["pos"] = pos_all + 1
        return logits, cache

    return serve_step


# --------------------------------------------------------------------------
# prefill (build the cache from a whole prompt)
# --------------------------------------------------------------------------


def _write_prompt(cache, layout: kvc.CacheLayout, k_all, v_all, slot=None, **paged_kw):
    """Every layer's prompt K/V into the cache: the global stores at
    ``[0, S)``, the local rings their last ``window`` positions."""
    for gi, layer in enumerate(layout.global_layers):
        kvc.write_prefill(cache["global"], gi, k_all[layer], v_all[layer], slot=slot,
                          **paged_kw)
    for li, layer in enumerate(layout.local_layers):
        kvc.write_prefill_local(cache["local"], li, k_all[layer], v_all[layer],
                                layout.local_window, slot=slot)


def prefill(params, cfg, layout: kvc.CacheLayout, tokens: torch.Tensor,
            vision_embeds: Optional[torch.Tensor] = None):
    """Whole-batch prefill: one forward over tokens ``(B, S)`` (a VLM's
    behind ``vision_embeds``), then a fresh cache holding every row's K/V
    at ``[0, S)`` (``[0, Tv + S)`` with an image prefix) and ``pos = S``.
    Returns ``(last_logits (B, 1, V), cache)``.  The paged layout maps the
    rows slot-major (``identity_page_table``)."""
    require_transformer(cfg, "prefill")
    logits, _, (k_all, v_all) = transformer.forward(params, cfg, tokens, return_kv=True,
                                                    vision_embeds=vision_embeds)
    dev = tokens.device
    cache = kvc.init_cache_arrays(cfg, layout, dev)
    B, S = tokens.shape
    paged_kw = {}
    if layout.layout == "paged" and layout.global_layers:
        cache["page_table"] = kvc.identity_page_table(layout, dev)
        paged_kw = dict(page_table=cache["page_table"], **_paged_kw(layout))
    _write_prompt(cache, layout, k_all, v_all, **paged_kw)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=dev)
    return logits[:, -1:], cache


def prefill_into_slot(params, cfg, layout: kvc.CacheLayout, cache, slot: int,
                      prompt: torch.Tensor, vision_embeds: Optional[torch.Tensor] = None,
                      rules=None):
    """Eager admission: one B=1 forward over ``prompt`` (``(S,)`` or
    ``(1, S)``, ``S < max_seq`` so the first decoded token has a row; a
    VLM's behind ``vision_embeds`` ``(1, Tv, d_vision)``), then
    ``reset_slot`` and the forward's K/V written into row ``slot`` of the
    live cache, in place, and ``pos = S``.  Paged layouts write through the
    cache's page table: the caller maps pages covering ``[0, S)`` first
    (writes to unmapped pages drop).  Returns ``(last_logits (1, 1, V),
    cache)``.  Under ``rules`` with a mesh the forward runs on the rank's
    heads; in the slot layout only the data rank holding ``slot`` runs it
    and broadcasts its logits."""
    require_transformer(cfg, "prefill_into_slot")
    transformer.require_vision(cfg, vision_embeds)  # on every rank, before a collective
    shard = shd.Shard.of(cfg, layout, rules)
    tokens = prompt[None] if prompt.ndim == 1 else prompt
    if tokens.shape[0] != 1:
        raise ValueError(f"prefill_into_slot: one prompt per admission, got "
                         f"{tuple(tokens.shape)}")
    S = tokens.shape[1]
    if not 0 < S < layout.max_seq:
        raise ValueError(f"prefill_into_slot: prompt length {S} needs at least one "
                         f"decode slot below max_seq {layout.max_seq}")
    row = slot if shard is None else shard.row(slot)
    if row < 0:  # another data rank holds the slot: its logits come from there
        cache = kvc.reset_slot(cache, layout, slot, row=row)
        cache["pos"][slot] = S
        return shard.from_owner(_logits_buffer(cfg, 1, tokens.device), slot), cache
    logits, _, (k_all, v_all) = transformer.forward(params, cfg, tokens, return_kv=True,
                                                    vision_embeds=vision_embeds,
                                                    split=shd.model_split(shard))
    cache = kvc.reset_slot(cache, layout, slot, row=row)
    paged_kw = (dict(page_table=cache["page_table"], **_paged_kw(layout))
                if layout.layout == "paged" and layout.global_layers else {})
    _write_prompt(cache, layout, k_all, v_all, slot=row, **paged_kw)
    cache["pos"][slot] = S
    logits = logits[:, -1:]
    return (logits if shard is None else shard.from_owner(logits, slot)), cache


def _logits_buffer(cfg, C: int, device) -> torch.Tensor:
    """A ``(1, C, V)`` buffer of the admission paths' logits dtype (the
    model dtype: they read the raw tree) to receive a broadcast into."""
    return torch.empty((1, C, cfg.vocab_size), dtype=layers._dtype(cfg.dtype), device=device)


# --------------------------------------------------------------------------
# chunked, bucketed prefill — the admission path
# --------------------------------------------------------------------------
#
# A chunk step runs a fixed-shape (1, C) forward for one slot of the live
# cache at an arbitrary token offset.  Global layers write the chunk's KV
# FIRST and then attend over the full (S_max,) row with per-query causal
# masks, so the key axis has one shape however the prompt was chunked (the
# chunked == whole-prompt invariant).  Local (ring) layers attend per query
# over a gathered fixed-width window (lane r of the query at p holds
# position p - W + 1 + r), so their lane placement does not depend on the
# chunking either; the ring is written after the attend (a chunk's write
# would evict lanes its own earlier queries still need).  Padded lanes
# beyond ``length`` carry garbage queries (their logits are never read) and
# are never written.


def _chunk_attend_local(cfg, layout, store, li: int, slot: int, q, k, v, qpos,
                        offset: int, kind: str, w: int):
    """Fixed-width gathered-window attention of a local layer's chunk.

    q / k / v are the chunk's fresh projections ``(1, C, H, Dh)``; qpos
    ``(C,)`` their positions; the ring row holds positions below
    ``offset``.  The query at p attends lanes holding ``p - W + 1 .. p``,
    gathered from [the ring in position order | the fresh chunk] and masked
    by presence and the sliding / chunked rule.  Returns f32 ``(1, C, Hq,
    Dh)``."""
    _, C, Hq, Dh = q.shape
    Hk = k.shape[2]
    g = Hq // Hk
    W = layout.local_window
    dev = q.device
    kr, vr = store["k"][li, slot].float(), store["v"][li, slot].float()  # (Hk, W, D)
    if "k_scale" in store:
        kr = kr * store["k_scale"][li, slot][..., None]
        vr = vr * store["v_scale"][li, slot][..., None]
    order = (offset - W + torch.arange(W, device=dev)) % W  # lane j holds offset - W + j
    kr, vr, ap = kr[:, order], vr[:, order], store["abs_pos"][li, slot][order]
    ring_pos = torch.where((ap >= 0) & (ap < offset), ap.long(), -(1 << 30))
    buf_k = torch.cat([kr, k[0].transpose(0, 1).float()], dim=1)  # (Hk, W + C, D)
    buf_v = torch.cat([vr, v[0].transpose(0, 1).float()], dim=1)
    buf_pos = torch.cat([ring_pos, qpos.long()])
    # query i gathers buffer lanes i + 1 .. i + W: positions qpos[i] - W + 1 .. qpos[i]
    idx = (torch.arange(C, device=dev)[:, None] + 1
           + torch.arange(W, device=dev)[None, :])  # (C, W)
    gk, gv = buf_k[:, idx], buf_v[:, idx]  # (Hk, C, W, D)
    expect = qpos[:, None].long() - W + 1 + torch.arange(W, device=dev)[None, :]
    valid = (buf_pos[idx] == expect) & (expect >= 0)
    if kind == "chunked":
        cw = max(w, 1)
        valid &= torch.div(expect, cw, rounding_mode="floor") == \
            torch.div(qpos[:, None].long(), cw, rounding_mode="floor")
    else:  # sliding: a no-op when w == W, real when W was clamped to max_seq
        valid &= qpos[:, None] - expect < w
    qg = q[0].reshape(C, Hk, g, Dh).permute(1, 2, 0, 3).float()  # (Hk, g, C, D)
    logits = torch.einsum("hgqd,hqwd->hgqw", qg, gk) * Dh ** -0.5
    probs = softmax(torch.where(valid[None, None], logits, NEG_INF))
    out = torch.einsum("hgqw,hqwd->hgqd", probs, gv)
    return out.permute(2, 0, 1, 3).reshape(1, C, Hq, Dh)


def _attn_chunk_layer(p, cfg, layout, cache, x, slot, offset, length, layer_idx,
                      theta, phys=None, split=None):
    """One attention layer of the chunk forward.  x ``(1, C, D)``; ``phys``
    (paged) the slot's ``(1, S_max)`` gather map; ``slot`` the row of the
    rank's slot-major stores.  With a model-axis ``split`` the rank's
    heads, gathered over ``"model"`` before ``wo``."""
    B, C, _ = x.shape
    h = layers.apply_norm(x, p["attn_norm"], cfg.norm)
    qpos = offset + torch.arange(C, device=x.device)
    Hq, Hk = sh.local_heads(cfg, split)
    q, k, v = layers.qkv_project(p["attn"], h, Hq, Hk, cfg.head_dim, qpos[None], theta,
                                 qk_norm=cfg.qk_norm)
    if layer_idx in layout.local_layers:
        li = layout.local_layers.index(layer_idx)
        kind, w = cfg.layer_attn_window(layer_idx)
        out = _chunk_attend_local(cfg, layout, cache["local"], li, slot, q, k, v, qpos,
                                  offset, kind, w)
        kvc.write_prefill_local(cache["local"], li, k, v, layout.local_window, slot=slot,
                                offset=offset, length=length)
        return _chunk_out(p, cfg, out, x, split), cache
    gi = layout.global_layers.index(layer_idx)
    store = cache["global"]
    if layout.layout == "paged":
        kvc.write_prefill(store, gi, k, v, slot=slot, offset=offset, length=length,
                          page_table=cache["page_table"], **_paged_kw(layout))
        view = kvc.paged_entry(store, gi, phys)
    else:
        kvc.write_prefill(store, gi, k, v, slot=slot, offset=offset, length=length)
        view = {n: (a[gi][:, slot][:, None] if n == "k_planes" else a[gi, slot][None])
                for n, a in store.items()}
    valid = (torch.arange(layout.max_seq, device=x.device)[None, :]
             <= qpos[:, None])[None]  # (1, C, S)
    if layout.kv_format == "bgpp":
        # prefill attends the full causal context: rebuild the exact int8 K
        # from the planes (BGPP's prediction is a decode-time saving)
        entry = {"k": kvc.bitplanes_to_k(view["k_planes"], view["k_sign"]),
                 "k_scale": view["k_scale"], "v": view["v"], "v_scale": view["v_scale"]}
        out = _cache_attend(q, entry, valid, cfg, "int8")
    else:
        out = _cache_attend(q, view, valid, cfg, layout.kv_format)
    return _chunk_out(p, cfg, out, x, split), cache


def _chunk_out(p, cfg, out, x, split=None):
    """The chunk attend's f32 output cast to the activation dtype (its
    heads gathered over ``"model"`` under a ``split``), ``wo`` and the
    post-attention norm where set."""
    B, C = x.shape[:2]
    out = sh.gather_heads(out.to(x.dtype), split, 2)
    out = layers.wdot(out.reshape(B, C, -1), p["attn"]["wo"])
    if cfg.post_norms:
        out = layers.apply_norm(out, p["post_attn_norm"], cfg.norm)
    return out


def make_prefill_chunk(cfg, layout: kvc.CacheLayout, rules=None):
    """Build the chunk step for one (cfg, layout, rules):

        prefill_chunk(params, cache, tokens (1, C), slot, offset, length)
            -> (logits (1, C, V), cache)

    The chunk's KV lands at ``[offset, offset+length)`` of row ``slot`` and
    ``cache['pos'][slot]`` is set to ``offset + length``.  With a mesh the
    chunk runs on the rank's heads; in the slot layout only the data rank
    holding ``slot`` runs it and broadcasts its logits over ``"data"``."""
    require_transformer(cfg, "make_prefill_chunk")
    shard = shd.Shard.of(cfg, layout, rules)
    split = shd.model_split(shard)
    thetas = transformer.layer_thetas(cfg)

    def prefill_chunk(params, cache, tokens, slot: int, offset: int, length: int):
        """One fixed-shape (1, C) prefill chunk against the live cache."""
        row = slot if shard is None else shard.row(slot)
        if row < 0:  # another data rank holds the slot
            cache["pos"][slot] = offset + length
            return shard.from_owner(_logits_buffer(cfg, tokens.shape[1], tokens.device),
                                    slot), cache
        phys = (kvc.phys_table(cache["page_table"], layout.page_size,
                               layout.max_seq)[slot][None]
                if layout.layout == "paged" and layout.global_layers else None)
        x = transformer.embed_tokens(params, cfg, tokens, split)
        for i in range(cfg.num_layers):
            p = transformer.layer_params(params["layers"], i)
            a, cache = _attn_chunk_layer(p, cfg, layout, cache, x, row, offset,
                                         length, i, float(thetas[i]), phys=phys, split=split)
            x = x + a
            x = x + _ffn_decode_layer(p, p["mlp_norm"], cfg, x)
        logits = transformer.lm_logits(params, cfg, x, split)
        cache["pos"][slot] = offset + length
        return (logits if shard is None else shard.from_owner(logits, slot)), cache

    return prefill_chunk


def default_buckets(chunk_budget: int) -> Tuple[int, ...]:
    """Bucket widths for a token budget: the budget itself plus one
    half-size tail bucket (fewer padded lanes on a prompt's last chunk)."""
    budget = max(1, int(chunk_budget))
    return tuple(sorted({budget, max(4, budget // 2)} - {0}))


class ChunkedPrefill:
    """Bucketed chunk-prefill engine for one (cfg, layout).

    The scheduler drives it chunk by chunk; :meth:`admit` runs a whole
    prompt (the tests' whole-prompt reference: with a bucket >= the prompt
    length it is a single fixed-shape forward)."""

    def __init__(self, cfg, layout: kvc.CacheLayout, buckets: Tuple[int, ...] = (8, 16),
                 rules=None):
        self.cfg = cfg
        self.layout = layout
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"ChunkedPrefill: bad buckets {buckets}")
        self.shard = shd.Shard.of(cfg, layout, rules)
        self._chunk = make_prefill_chunk(cfg, layout, rules)
        self._widths_run = set()

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n, or the largest bucket (caller chunks)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    @property
    def num_compiles(self) -> int:
        """Distinct chunk widths run so far — never more than
        ``len(self.buckets)`` (the bucketing contract)."""
        return len(self._widths_run)

    def reset(self, cache, slot: int):
        """Scrub one slot (the first step of every admission)."""
        slot = int(slot)
        row = slot if self.shard is None else self.shard.row(slot)
        return kvc.reset_slot(cache, self.layout, slot, row=row)

    def run_chunk(self, params, cache, slot: int, chunk_tokens, offset: int):
        """One fixed-shape chunk: pads ``chunk_tokens`` (length n <= the
        largest bucket) to its bucket.  Returns ``(logits (1, C, V), cache, n)``."""
        toks = np.asarray(chunk_tokens, np.int64).reshape(-1)
        n = toks.shape[0]
        C = self.bucket_for(n)
        if n > C:
            raise ValueError(f"chunk of {n} tokens exceeds largest bucket {C}")
        if n < C:
            toks = np.pad(toks, (0, C - n))
        self._widths_run.add(C)
        tokens = torch.as_tensor(toks[None], device=cache["pos"].device)
        logits, cache = self._chunk(params, cache, tokens, int(slot), int(offset), n)
        return logits, cache, n

    def admit(self, params, cache, slot: int, prompt, *,
              max_chunk: Optional[int] = None, reset: bool = True):
        """Whole-prompt admission through the chunk path: reset the slot,
        then consume the prompt in <= ``max_chunk``-token chunks.  Returns
        ``(last_logits (1, 1, V), cache)``."""
        toks = np.asarray(prompt, np.int64).reshape(-1)
        S = toks.shape[0]
        if not 0 < S < self.layout.max_seq:
            raise ValueError(f"admit: prompt length {S} must be in [1, max_seq)")
        step = min(self.buckets[-1], max_chunk or self.buckets[-1])
        if reset:
            cache = self.reset(cache, slot)
        off, logits, n = 0, None, 0
        while off < S:
            logits, cache, n = self.run_chunk(params, cache, slot, toks[off:off + step], off)
            off += n
        return logits[:, n - 1:n], cache
