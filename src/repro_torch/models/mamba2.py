"""Mamba2 (SSD, state-space duality) mixer and the attention-free LM.

Counterpart of :mod:`repro.models.mamba2`, in plain PyTorch (the reference
writes no Pallas kernel here).  The whole-sequence forward is the chunked
dual form of the scan: inside a chunk a decay-weighted, masked contraction
of the chunk's C and B rows; across chunks a recurrent state ``(B, H, P,
N)`` carried by a loop over the chunks.  Decode is the pure recurrence ``h
= a h + dt x B^T``, ``y = C h + D x``, with a rolling window of the last
``ssm_conv - 1`` pre-activation conv inputs.  The state has no sequence
axis, so a long context costs the same memory as a short one.

Parameters keep the reference's tree: ``embed``, ``layers/{norm,
mixer/{in_proj, conv_w, conv_b, A_log, D, dt_bias, norm/scale, out_proj}}``
stacked over the layers, ``final_norm``; the head is the tied ``embed.T``.
The projections are plain ``x @ w`` (:func:`layers.matmul`), as the
reference's.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers, transformer
from repro_torch.models.layers import _dtype

Params = Dict[str, Any]


def _dims(cfg) -> Tuple[int, int, int]:
    """``(d_in, N, H)``: the inner width, the state width and the heads."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.ssm_state, d_in // cfg.ssm_head_dim


def mixer_init(cfg, generator: torch.Generator, device, dtype, stack: int) -> Params:
    """Random mixer parameters for ``stack`` layers, stacked ``(stack, ...)``:
    ``in_proj`` emits ``[z, x, B, C, dt]`` (``2 d_in + 2 N + H`` columns),
    projections ``N(0, 1) / sqrt(fan_in)``, the conv ``N(0, 1) /
    sqrt(ssm_conv)`` with a zero bias, ``A_log`` and ``dt_bias`` 0 and ``D``
    1 in f32, the gated norm's scale 0 (the reference's ``mixer_init``)."""
    d = cfg.d_model
    d_in, N, H = _dims(cfg)
    K = cfg.ssm_conv

    def normal(shape, scale):
        t = torch.empty((stack,) + shape, dtype=dtype, device=device)
        for i in range(stack):
            t[i].normal_(generator=generator)
        return t.mul_(torch.tensor(scale, dtype=dtype, device=device))

    f32 = lambda fill: torch.full((stack, H), fill, dtype=torch.float32, device=device)
    return {
        "in_proj": normal((d, 2 * d_in + 2 * N + H), 1 / math.sqrt(d)),
        "conv_w": normal((K, d_in + 2 * N), 1 / math.sqrt(K)),
        "conv_b": torch.zeros((stack, d_in + 2 * N), dtype=dtype, device=device),
        "A_log": f32(0.0),
        "D": f32(1.0),
        "dt_bias": f32(0.0),
        "norm": {"scale": torch.zeros((stack, d_in), dtype=dtype, device=device)},
        "out_proj": normal((d_in, d), 1 / math.sqrt(d_in)),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    """``in_proj``'s output -> ``(z, xBC, dt, d_in, N, H)``."""
    d_in, N, H = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * N]
    dt = zxbcdt[..., 2 * d_in + 2 * N:]
    return z, xBC, dt, d_in, N, H


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along the sequence, SiLU, in f32.

    Whole sequence: xBC ``(B, S, C)`` left-padded with ``K - 1`` zeros ->
    ``((B, S, C) in xBC's dtype, None)``.  Decode (``conv_state`` the
    ``(B, K - 1, C)`` window): the window and the token -> ``((B, 1, C),
    the window's last K - 1 rows)``.  Both sum the taps in one order, so a
    token's conv output is the same bits in either form."""
    K = conv_w.shape[0]
    w, b = conv_w.float(), conv_b.float()
    if conv_state is not None:
        window = torch.cat([conv_state, xBC], dim=1)  # (B, K, C)
        out = sum(window[:, i].float() * w[i] for i in range(K)) + b
        return F.silu(out)[:, None, :].to(xBC.dtype), window[:, 1:]
    S = xBC.shape[1]
    pad = F.pad(xBC.float(), (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S] * w[i] for i in range(K)) + b
    return F.silu(out).to(xBC.dtype), None


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int = 256, return_state: bool = False):
    """Chunked SSD scan: x ``(B, S, H, P)``, dt ``(B, S, H)`` (softplus'd
    step), A ``(H,)`` (negative), Bm / Cm ``(B, S, N)`` -> y ``(B, S, H,
    P)`` in x's dtype (and, with ``return_state``, the final state ``(B,
    H, P, N)`` f32).  ``S`` must be a multiple of ``min(chunk, S)``.

    The reference's four-operand contraction of the intra-chunk term is
    taken pairwise, heads before positions, so its one large temporary is
    the ``(B, nc, H, L, L)`` f32 decay-weighted score (134 MB a batch row
    at mamba2-1.3b's 64 heads, S 2048, chunk 256), built in place (out of
    place under gradient mode, where an operand requires a gradient)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of chunk={chunk}")
    nc, L = S // chunk, chunk
    xh = x.float().reshape(Bsz, nc, L, H, P).permute(0, 1, 3, 2, 4)  # (B, nc, H, L, P)
    dth = dt.float().reshape(Bsz, nc, L, H).permute(0, 1, 3, 2)  # (B, nc, H, L)
    Bc = Bm.float().reshape(Bsz, nc, L, N)
    Cc = Cm.float().reshape(Bsz, nc, L, N)
    a_cum = torch.cumsum(dth * A.float()[:, None], dim=-1)  # (B, nc, H, L) log decay, <= 0

    # intra-chunk: y[l] += sum_{m <= l} (C_l . B_m) exp(a_cum[l] - a_cum[m]) dt_m x_m
    w = a_cum[..., :, None] - a_cum[..., None, :]  # (B, nc, H, L, L)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        # the same operations out of place: autograd keeps what each needs
        w = w.exp().masked_fill(~causal, 0.0)
        w = w * (Cc @ Bc.transpose(-1, -2))[:, :, None] * dth[..., None, :]
    else:
        w.exp_().masked_fill_(~causal, 0.0)
        w.mul_((Cc @ Bc.transpose(-1, -2))[:, :, None]).mul_(dth[..., None, :])
    y = w @ xh  # (B, nc, H, L, P)
    del w

    # chunk-final states: sum_l exp(a_cum[L-1] - a_cum[l]) dt_l x_l B_l^T
    seg = torch.exp(a_cum[..., -1:] - a_cum) * dth  # (B, nc, H, L)
    states = (xh * seg[..., None]).transpose(-1, -2) @ Bc[:, :, None]  # (B, nc, H, P, N)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(a_cum[..., -1])  # (B, nc, H)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B, nc, H, P, N)

    # inter-chunk: y[l] += exp(a_cum[l]) C_l . h_in
    y = y + (Cc[:, :, None] @ h_in.transpose(-1, -2)) * torch.exp(a_cum)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P).to(x.dtype)
    return (y, h) if return_state else y


def _gated_out(p: Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``out_proj(rms_norm(y * silu(z)))``, the gate in f32 cast to y's dtype."""
    y = layers.rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"]["scale"])
    return layers.matmul(y, p["out_proj"])


def mixer_apply(p: Params, cfg, x: torch.Tensor, chunk: int = 256,
                return_state: bool = False):
    """Whole-sequence SSD mixer: x ``(B, S, d_model)`` -> ``(B, S,
    d_model)``.  With ``return_state`` also the decode continuation ``{"h":
    (B, H, P, N) f32, "conv": (B, K - 1, C)}`` (the last ``K - 1``
    pre-activation conv inputs)."""
    B, S, _ = x.shape
    z, xBC, dt, d_in, N, H = _split_proj(cfg, layers.matmul(x, p["in_proj"]))
    xBC_raw = xBC
    xBC, _ = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xin = xBC[..., :d_in].reshape(B, S, H, cfg.ssm_head_dim)
    Bm, Cm = xBC[..., d_in:d_in + N], xBC[..., d_in + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])
    res = ssd_chunked(xin, dt, A, Bm, Cm, chunk=chunk, return_state=return_state)
    y, h_final = res if return_state else (res, None)
    y = y + xin * p["D"][None, None, :, None].to(x.dtype)
    out = _gated_out(p, y.reshape(B, S, d_in), z)
    if return_state:
        K = p["conv_w"].shape[0]
        return out, {"h": h_final, "conv": xBC_raw[:, -(K - 1):, :]}
    return out


def mixer_decode_step(p: Params, cfg, x: torch.Tensor, state: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token of the recurrence: x ``(B, 1, d_model)``, state ``{"h":
    (B, H, P, N) f32, "conv": (B, K - 1, C)}`` -> ``(out (B, 1, d_model),
    new state)``."""
    B = x.shape[0]
    z, xBC, dt, d_in, N, H = _split_proj(cfg, layers.matmul(x, p["in_proj"]))
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state=state["conv"])
    xin = xBC[..., :d_in].reshape(B, H, cfg.ssm_head_dim).float()
    Bm = xBC[:, 0, d_in:d_in + N].float()  # (B, N)
    Cm = xBC[:, 0, d_in + N:].float()
    dt_s = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B, H)
    a = torch.exp(dt_s * -torch.exp(p["A_log"])[None, :])  # (B, H)
    h = (state["h"] * a[:, :, None, None]
         + (dt_s[:, :, None] * xin)[..., None] * Bm[:, None, None, :])
    y = (h @ Cm[:, None, :, None])[..., 0]  # (B, H, P)
    y = y + xin * p["D"][None, :, None]
    out = _gated_out(p, y.reshape(B, 1, d_in).to(x.dtype), z)
    return out, {"h": h, "conv": conv_state}


def init_mixer_state(cfg, batch: int, dtype, device="cuda") -> Dict[str, torch.Tensor]:
    """A zero decode state: ``h`` ``(batch, H, P, N)`` f32 and ``conv``
    ``(batch, K - 1, d_in + 2 N)`` in ``dtype``."""
    d_in, N, H = _dims(cfg)
    return {
        "h": torch.zeros((batch, H, cfg.ssm_head_dim, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * N), dtype=dtype,
                            device=device),
    }


# --------------------------------------------------------------------------
# the attention-free LM (mamba2-1.3b)
# --------------------------------------------------------------------------


def init(cfg, generator: torch.Generator, device="cuda") -> Params:
    """Random parameters on ``device`` from ``generator``: the embedding
    ``N(0, 1) * 0.02``, each layer's pre-norm (scale 0) and mixer
    (:func:`mixer_init`), the final norm; the head is the tied embedding.
    2.7 GB for mamba2-1.3b in bf16."""
    dtype = _dtype(cfg.dtype)
    L, d = cfg.num_layers, cfg.d_model
    embed = torch.empty((cfg.vocab_size, d), dtype=dtype, device=device)
    embed.normal_(generator=generator)
    embed.mul_(torch.tensor(0.02, dtype=dtype, device=device))
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    lay = {"norm": {"scale": zeros(L, d)},
           "mixer": mixer_init(cfg, generator, device, dtype, L)}
    return {"embed": embed, "layers": lay, "final_norm": {"scale": zeros(d)}}


def _layer(p: Params, x: torch.Tensor, *, cfg, chunk: int) -> torch.Tensor:
    return x + mixer_apply(p["mixer"], cfg, layers.apply_norm(x, p["norm"], cfg.norm),
                           chunk=chunk)


def forward(params: Params, cfg, tokens: torch.Tensor, chunk: int = 256, remat: bool = False):
    """tokens ``(B, S)`` -> ``(logits (B, S, V), aux 0.0)``: each layer
    ``x + mixer(norm(x))`` (recomputed in the backward with ``remat``, as
    the reference's ``jax.checkpoint``), the final norm and the tied
    head."""
    x = transformer.embed_tokens(params, cfg, tokens)
    body = functools.partial(_layer, cfg=cfg, chunk=chunk)
    for p in transformer.layer_slices(params["layers"], cfg.num_layers):
        x = transformer.run_layer(body, remat, p, x)
    return transformer.lm_logits(params, cfg, x), torch.zeros((), device=x.device)
