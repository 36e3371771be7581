"""Decoder-only transformer: parameter init and the whole-sequence forward.

Counterpart of :mod:`repro.models.transformer` for the dense and MoE
families: phi4-mini, deepseek-7b (an untied ``lm_head``), gemma3-1b / 4b
(local sliding-window layers 5:1 with global ones, their own RoPE base,
qk-norm, sandwich norms, GeGLU and the embedding scale), mixtral-8x22b
(every layer a sliding-window ring, 8 experts top-2) and
llama4-scout-17b-a16e (chunked-local layers 3:1 with global ones, 16
experts top-1 and a shared expert; :mod:`repro_torch.models.moe`) and the
VLM paligemma-3b (gemma's stack behind a ``vision_proj`` of precomputed
patch embeddings, the prefix_causal mask).  The
parameter tree follows ``transformer.init``'s (stacked ``(L, ...)`` layer
leaves, ``(in, out)`` projections, zero-centred norm scales, the optional
leaves where the config asks for them) and its scales, drawn from a
``torch.Generator`` on the target device.

``forward`` runs a whole ``(B, S)`` token batch through every layer (the
reference's ``lax.scan`` becomes a Python loop over the stacked leaves);
its attention is :func:`repro_torch.core.attention.blocked_attend`, which
launches the ``flash_attention`` kernel on the card, with the model's mask
kind and each layer's window (0, full causal, on the global layers).
Eager admission and whole-batch prefill (:mod:`repro_torch.serving.engine`)
run on it.  An MoE layer routes with the config's capacity factor, so
the whole-sequence forward drops tokens as the reference's does (1.25 on
the full configs).  A VLM's forward takes ``vision_embeds``: their
projection runs before the tokens, positions count from the first patch,
and every layer attends under prefix_causal with the patch count as its
window.  ``remat`` recomputes each layer in the backward, as the
reference's ``jax.checkpoint`` does.  Under a mesh (eager admission on a
sharded Scheduler) it runs on one rank's heads and vocab, and in the
sharded train step on the rank's rows, heads and FF shard (an MoE layer's
dispatch group-local to the rank's rows): see ``forward``'s ``split``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import require_transformer
from repro_torch.core import attention
from repro_torch.distributed import sharding as sh
from repro_torch.models import layers, moe
from repro_torch.models.layers import _dtype
from repro_torch.utils.tree import tree_leaves, tree_map

Params = Dict[str, Any]


def _mask_kind(cfg) -> str:
    """The model's one mask kind; each layer's window picks its extent
    (window 0 is full causal)."""
    if cfg.family == "vlm":
        return "prefix_causal"
    if cfg.chunk_attention > 0:
        return "chunked"
    if cfg.sliding_window > 0:
        return "sliding"
    return "causal"


def layer_windows(cfg) -> np.ndarray:
    """(L,) per-layer window / chunk size (0 = full causal)."""
    out = []
    for i in range(cfg.num_layers):
        kind, w = cfg.layer_attn_window(i)
        out.append(w if kind in ("sliding", "chunked") else 0)
    return np.asarray(out, np.int32)


def layer_thetas(cfg) -> np.ndarray:
    """(L,) RoPE base per layer: ``rope_theta_local`` on the local layers
    where the config sets one (gemma3), ``rope_theta`` elsewhere."""
    out = []
    for i in range(cfg.num_layers):
        kind, _ = cfg.layer_attn_window(i)
        local = kind in ("sliding", "chunked") and cfg.rope_theta_local > 0
        out.append(cfg.rope_theta_local if local else cfg.rope_theta)
    return np.asarray(out, np.float32)


def _layer_specs(cfg) -> Params:
    s: Params = {"attn_norm": layers.norm_specs(cfg.norm),
                 "attn": layers.attention_specs(cfg.qk_norm),
                 "mlp_norm": layers.norm_specs(cfg.norm)}
    if cfg.num_experts > 0:
        s["moe"] = moe.moe_specs(cfg)
    else:
        s["mlp"] = layers.mlp_specs(cfg.activation)
    if cfg.post_norms:
        s["post_attn_norm"] = layers.norm_specs(cfg.norm)
        s["post_mlp_norm"] = layers.norm_specs(cfg.norm)
    return s


def param_specs(cfg) -> Params:
    """The logical-axis tree of :func:`init_params`'s parameters."""
    specs: Params = {"embed": (sh.VOCAB, sh.D_MODEL), "layers": sh.stacked(_layer_specs(cfg)),
                     "final_norm": layers.norm_specs(cfg.norm)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (sh.D_MODEL, sh.VOCAB)
    if cfg.family == "vlm":
        specs["vision_proj"] = (None, sh.D_MODEL)
    return specs


def init_params(cfg, generator: torch.Generator, device="cuda") -> Params:
    """Random parameters on ``device`` from ``generator`` (which must live
    on the same device).

    Projections are ``N(0, 1) / sqrt(fan_in)``, embeddings ``N(0, 1) *
    0.02``, norm scales zero — ``transformer.init``'s scales; the
    ``(d_model, vocab)`` ``lm_head`` of an untied model is a projection.
    An MoE config builds ``layers["moe"]`` (:func:`moe.moe_init`, stacked)
    in place of ``layers["mlp"]``; a VLM the ``(d_vision, d_model)``
    ``vision_proj``, a projection.  Leaves are filled layer by layer (and
    expert by expert) in the model dtype, so the peak memory is the
    parameters themselves (7.7 GB for phi4-mini-3.8b in bf16)."""
    require_transformer(cfg, "init_params")
    dtype = _dtype(cfg.dtype)
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        t = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):  # one layer (or row block) at a time
            t[i].normal_(generator=generator)
        return t.mul_(torch.tensor(scale, dtype=dtype, device=device))

    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    embed = torch.empty((cfg.vocab_size, d), dtype=dtype, device=device)
    embed.normal_(generator=generator)
    embed.mul_(torch.tensor(0.02, dtype=dtype, device=device))
    attn = {
        "wq": normal((L, d, cfg.q_dim), 1 / math.sqrt(d)),
        "wk": normal((L, d, cfg.kv_dim), 1 / math.sqrt(d)),
        "wv": normal((L, d, cfg.kv_dim), 1 / math.sqrt(d)),
        "wo": normal((L, cfg.q_dim, d), 1 / math.sqrt(cfg.q_dim)),
    }
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": zeros(L, cfg.head_dim)}
        attn["k_norm"] = {"scale": zeros(L, cfg.head_dim)}
    lay = {"attn_norm": {"scale": zeros(L, d)}, "attn": attn,
           "mlp_norm": {"scale": zeros(L, d)}}
    if cfg.num_experts > 0:
        lay["moe"] = moe.moe_init(cfg, generator, device, stack=L)
    elif cfg.activation in ("swiglu", "geglu"):
        lay["mlp"] = {"gate": normal((L, d, f), 1 / math.sqrt(d)),
                      "up": normal((L, d, f), 1 / math.sqrt(d)),
                      "down": normal((L, f, d), 1 / math.sqrt(f))}
    else:  # the plain GELU MLP
        lay["mlp"] = {"up": normal((L, d, f), 1 / math.sqrt(d)), "up_b": zeros(L, f),
                      "down": normal((L, f, d), 1 / math.sqrt(f)), "down_b": zeros(L, d)}
    if cfg.post_norms:
        lay["post_attn_norm"] = {"scale": zeros(L, d)}
        lay["post_mlp_norm"] = {"scale": zeros(L, d)}
    params = {"embed": embed, "layers": lay, "final_norm": {"scale": zeros(d)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), 1 / math.sqrt(d))
    if cfg.family == "vlm":
        params["vision_proj"] = normal((cfg.d_vision, d), 1 / math.sqrt(cfg.d_vision))
    return params


def embed_tokens(params: Params, cfg, tokens: torch.Tensor,
                 split: Optional[sh.ModelSplit] = None) -> torch.Tensor:
    """Token embeddings in the model dtype, times ``sqrt(d_model)`` (rounded
    to that dtype) where the config asks for it (gemma).  A mesh rank's
    ``split`` looks rows up in its vocab share (:func:`sh.embed_lookup`)."""
    dtype = _dtype(cfg.dtype)
    x = sh.embed_lookup(params["embed"], tokens, split).to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype, device=x.device)
    return x


def lm_logits(params: Params, cfg, x: torch.Tensor,
              split: Optional[sh.ModelSplit] = None) -> torch.Tensor:
    """The final norm and the head: the untied ``lm_head`` (a raw leaf or a
    serve-time record), else the tied ``embed.T`` in the model dtype.  A
    mesh rank's ``split`` gathers its vocab columns over ``"model"``; a
    training split's head is column-parallel on the whole sequence."""
    x = norm_rows(x, params["final_norm"], cfg, split)
    if sh.training(split):
        x = sh.enter_block(x, split, split.vocab)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T.to(_dtype(cfg.dtype))
    logits = layers.wdot(x, head)
    return sh.gather_vocab(logits, split)


def layer_params(tree: Params, i: int) -> Params:
    """Layer ``i``'s slice of a stacked ``(L, ...)`` tree (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def layer_slices(tree: Params, n: int) -> List[Params]:
    """Every layer's slice of a stacked tree: views by indexing, or under
    gradient mode (a leaf requires a gradient) one ``unbind`` a leaf, whose
    backward stacks the leaf's ``n`` grads once (``v[i]`` would build a
    zero tensor the size of the whole stack for each slice's grad)."""
    if torch.is_grad_enabled() and any(v.requires_grad for v in tree_leaves(tree)):
        per_leaf = tree_map(lambda v: v.unbind(0), tree)
        return [tree_map(lambda u: u[i], per_leaf) for i in range(n)]
    return [layer_params(tree, i) for i in range(n)]


def run_layer(fn, remat: bool, *args):
    """``fn(*args)``, rematerialised when ``remat`` (the reference's
    ``jax.checkpoint`` of its scan body): its activations are not kept for
    the backward but recomputed from ``args`` there
    (``torch.utils.checkpoint``, non-reentrant)."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --------------------------------------------------------------------------
# forward (whole sequence: eager admission, whole-batch prefill)
# --------------------------------------------------------------------------


def norm_rows(x, p, cfg, split):
    """The config's norm of the rank's residual rows (its scale's gradient
    summed over the model axis where those rows are the rank's own)."""
    return layers.apply_norm(x, sh.shared(p, split, split is not None and split.seq), cfg.norm)


def attention_block(p, cfg, x, positions, theta: float, window: int, mask_kind: str,
                     return_kv: bool = False, split: Optional[sh.ModelSplit] = None):
    """Norm, QKV (qk-norm where set) with RoPE, ``blocked_attend``, ``wo``
    and the post-attention norm where set.  x ``(B, S, d)`` -> ``(out, (k,
    v) or None)`` with k / v ``(B, S, Hk, Dh)``.  A mesh rank's ``split``
    projects and attends its heads; serving gathers them before ``wo``, a
    training split sums its row shard of ``wo``'s product over the axis
    (:func:`sh.leave_block`)."""
    h = norm_rows(x, p["attn_norm"], cfg, split)
    rows = sh.training(split)
    if rows:
        h = sh.enter_block(h, split, split.heads)
    Hq, Hk = sh.local_heads(cfg, split)
    attn_p = p["attn"]
    if rows and cfg.qk_norm:  # applied to the rank's own heads
        attn_p = dict(attn_p, q_norm=sh.shared(attn_p["q_norm"], split, split.heads),
                      k_norm=sh.shared(attn_p["k_norm"], split, split.heads))
    q, k, v = layers.qkv_project(attn_p, h, Hq, Hk, cfg.head_dim, positions, theta,
                                 qk_norm=cfg.qk_norm)
    attn = attention.blocked_attend(q, k, v, mask_kind=mask_kind, window=window)
    if not rows:
        attn = sh.gather_heads(attn, split, 2)
    B, S = attn.shape[:2]
    out = layers.wdot(attn.reshape(B, S, -1), p["attn"]["wo"])
    if rows:
        out = sh.leave_block(out, split, split.heads)
    if cfg.post_norms:
        out = norm_rows(out, p["post_attn_norm"], cfg, split)
    return out, ((k, v) if return_kv else None)


def ffn_apply(p, cfg, h, capacity_factor=None):
    """A layer's FFN on the normed ``h`` -> ``(out, aux)``: the MoE at
    ``capacity_factor`` (the config's when None) where the layer has one,
    else the MLP with aux 0."""
    if "moe" in p:
        return moe.moe_apply(p["moe"], h, cfg, capacity_factor=capacity_factor)
    return layers.mlp_apply(p["mlp"], h, cfg.activation), 0.0


def ffn_block(p, cfg, x, split: Optional[sh.ModelSplit] = None, data=None,
              norm: str = "mlp_norm"):
    """Norm (``p[norm]``), FFN (the MoE at the config's capacity factor)
    and the post-MLP norm where set -> ``(out, aux)``; aux is 0 for a
    dense layer.  A training split's MLP runs its ``gate`` / ``up`` column
    shards and sums its ``down`` row shard's product over the model axis;
    its MoE runs on the rank's rows and FF shard (:func:`moe.moe_apply`,
    the aux global over the ``data`` group).  The GELU MLP's ``up_b`` is
    cut with ``up``'s columns and ``down_b`` added once, after the sum."""
    h = norm_rows(x, p[norm], cfg, split)
    if sh.training(split) and "moe" in p:
        out, aux = moe.moe_apply(p["moe"], h, cfg, split=split, data=data)
    elif sh.training(split):
        h = sh.enter_block(h, split, split.ff)
        mlp = p["mlp"]
        if "down_b" in mlp:  # added after the row sum, to the rank's own rows under seq
            mlp = dict(mlp, down_b=sh.shared(mlp["down_b"], split, split.seq))
        out = layers.mlp_apply(mlp, h, cfg.activation,
                               reduce=lambda y: sh.leave_block(y, split, split.ff))
        aux = 0.0
    else:
        out, aux = ffn_apply(p, cfg, h)
    if cfg.post_norms:
        out = norm_rows(out, p["post_mlp_norm"], cfg, split)
    return out, aux


def _layer(p, x, positions, *, cfg, theta: float, window: int, mask_kind: str,
           return_kv: bool, split: Optional[sh.ModelSplit] = None,
           fsdp: Optional[sh.DataSplit] = None, fsdp_dims=None, data=None):
    """One layer: ``x + attn``, then ``+ ffn`` -> ``(x, aux, kv)``.  Under
    FSDP the layer's weights are gathered over ``"data"`` here, so they
    live for the layer only (and are gathered again when remat recomputes
    it); an MoE layer's whole expert bank is gathered, whatever experts its
    tokens pick, so every data rank issues the same collectives."""
    if fsdp is not None:
        p = fsdp.gather(p, fsdp_dims)
    a, kv = attention_block(p, cfg, x, positions, theta, window, mask_kind,
                             return_kv=return_kv, split=split)
    x = x + a
    f, aux = ffn_block(p, cfg, x, split, data)
    return x + f, aux, kv


def gather_outer(params: Params, fsdp: sh.DataSplit, stacked):
    """FSDP: ``params`` with every leaf outside the stacked subtree
    ``stacked`` gathered whole over ``"data"`` (the embedding, the head,
    the final norm), and the stacked subtree's gather dims less its
    stacking dim (a layer's slice is gathered inside the layer).  A tuple
    of names (whisper's ``encoder`` and ``decoder``) keeps each of those
    stacks back and returns a tuple of their dims."""
    names = (stacked,) if isinstance(stacked, str) else tuple(stacked)
    top = {k: v for k, v in params.items() if k not in names}
    params = dict(params, **fsdp.gather(top, {k: fsdp.dims[k] for k in top}))
    dims = tuple(tree_map(lambda d: None if d is None else d - 1, fsdp.dims[n]) for n in names)
    return params, dims[0] if isinstance(stacked, str) else dims


def split_rows(x: torch.Tensor, split: Optional[sh.ModelSplit]) -> torch.Tensor:
    """The residual stream ``(B, S, d)`` cut to the rank's ``S / size``
    rows under ``seq`` (sequence parallelism), else as it is."""
    if split is None or not split.seq:
        return x
    S = x.shape[1]
    if S % split.size:
        raise ValueError(f"forward: sequence parallelism over {split.size} ranks needs "
                         f"S divisible by it (S {S})")
    return sh.scatter_to(x, split.group, 1)


def require_vision(cfg, vision_embeds) -> None:
    """A VLM's whole-sequence forward needs its image prefix: raise where
    ``vision_embeds`` is None (the reference asserts)."""
    if cfg.family == "vlm" and vision_embeds is None:
        raise ValueError(
            f"forward: {cfg.name} is of family 'vlm'; its whole-sequence forward "
            f"needs vision_embeds (B, Tv, d_vision={cfg.d_vision}), the image "
            f"prefix (chunked admission serves text prompts without it)")


def forward(params: Params, cfg, tokens: torch.Tensor, return_kv: bool = False,
            vision_embeds: Optional[torch.Tensor] = None, block_q: Optional[int] = None,
            block_k: Optional[int] = None, remat: bool = False,
            split: Optional[sh.ModelSplit] = None, fsdp: Optional[sh.DataSplit] = None,
            data=None):
    """tokens ``(B, S)`` -> ``(logits (B, S', V), aux[, (k_all, v_all)])``.

    The residual stream runs in ``cfg.dtype``; ``aux`` is a 0-d float32
    tensor, the sum of the MoE layers' losses (0 for the dense family);
    ``k_all`` / ``v_all`` stack every layer's post-RoPE K and V, ``(L, B,
    S', Hk, Dh)``.  ``S' = S`` but for a VLM, whose ``vision_embeds`` ``(B,
    Tv, d_vision)`` are projected by ``vision_proj`` (in the residual
    dtype, not scaled) and put before the token embeddings: ``S' = Tv +
    S``, positions ``0 .. Tv + S - 1``, every layer under prefix_causal
    with window ``Tv``.  A VLM without them raises (the reference
    asserts); other families ignore them, as the reference does.

    ``remat`` recomputes each layer in the backward instead of keeping its
    activations (:func:`run_layer`).  ``block_q`` / ``block_k`` (the
    reference's attention tiles) are accepted and ignored: the kernel's
    plan sets its own tiles.  ``split``: a mesh rank's place on the model
    axis (:class:`repro_torch.distributed.sharding.ModelSplit`; eager
    admission on a mesh, and the sharded train step): the rank's heads (its
    K / V), the vocab-split embedding and head, the whole logits; a
    training split also its FF shard, the row-parallel ``wo`` / ``down``
    and, with ``seq``, ``S / size`` rows of the residual stream a rank.
    ``fsdp`` (the sharded train step under FSDP rules): the leaves' dims
    held in blocks over ``"data"``, gathered where they are used (the
    layers' inside each layer).  ``data`` (the sharded train step): the data
    axis's process group, over which an MoE layer's aux is the global one;
    the rank's rows are its token group."""
    require_transformer(cfg, "forward")
    B, S = tokens.shape
    layer_dims = None
    if fsdp is not None:
        params, layer_dims = gather_outer(params, fsdp, "layers")
    x = embed_tokens(params, cfg, tokens, split)
    mask_kind = _mask_kind(cfg)
    windows = layer_windows(cfg)
    if cfg.family == "vlm":
        require_vision(cfg, vision_embeds)
        vis = (vision_embeds.to(x.dtype) @ params["vision_proj"]).to(x.dtype)
        x = torch.cat([vis, x], dim=1)
        windows = np.full_like(windows, vis.shape[1])
        S = x.shape[1]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = split_rows(x, split)
    thetas = layer_thetas(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for i, p in enumerate(layer_slices(params["layers"], cfg.num_layers)):
        x, aux_l, kv = run_layer(
            functools.partial(_layer, cfg=cfg, theta=float(thetas[i]), window=int(windows[i]),
                              mask_kind=mask_kind, return_kv=return_kv, split=split,
                              fsdp=fsdp, fsdp_dims=layer_dims, data=data),
            remat, p, x, positions)
        aux = aux + aux_l
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    logits = lm_logits(params, cfg, x, split)
    if return_kv:
        return logits, aux, (torch.stack(ks), torch.stack(vs))
    return logits, aux
