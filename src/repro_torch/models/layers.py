"""Shared dense-transformer layers on plain tensors.

Counterpart of :mod:`repro.models.layers` for the pieces the port's
families run: RMS norm and whisper's layer norm, split-halves RoPE in
float32, the sinusoidal position table, the projection contraction (raw
``(in, out)`` weight leaves and the serve-time int8 / BSTC records of
:mod:`repro_torch.serving.weights`), the SwiGLU / GeGLU / GELU MLPs and
the QKV projection with gemma3's optional qk-norm.

On the CPU every contraction sums each row in one order whatever the
number of rows beside it (:func:`matmul`), so a prompt's logits do not move
with the chunk width it was prefilled at, nor a slot's with the batch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as sh
from repro_torch.kernels.bstc_matmul import bstc_matmul

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with a zero-centred scale (``x * (1 + w)``)."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + weight.float())).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in float32 (mean and biased variance over the last axis),
    ``y * weight + bias``, cast back to x's dtype: one fused
    ``F.layer_norm`` where the reference's ``jnp`` spells it out."""
    return F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(),
                        eps).to(x.dtype)


def apply_norm(x: torch.Tensor, params, kind: str) -> torch.Tensor:
    """The config's norm: ``rms`` (``params["scale"]``) or whisper's
    ``ln`` (``params["scale"]``, ``params["bias"]``)."""
    if kind == "rms":
        return rms_norm(x, params["scale"])
    if kind == "ln":
        return layer_norm(x, params["scale"], params["bias"])
    raise ValueError(f"apply_norm: unknown norm {kind!r}")


def norm_specs(kind: str):
    """A norm's logical axes: the scale (and ``ln``'s bias) on ``d_model``."""
    if kind == "rms":
        return {"scale": (sh.D_MODEL,)}
    return {"scale": (sh.D_MODEL,), "bias": (sh.D_MODEL,)}


def mlp_specs(activation: str):
    """The MLP's logical axes: ``ff`` on the hidden side of each matrix."""
    if activation in ("swiglu", "geglu"):
        return {"gate": (sh.D_MODEL, sh.FF), "up": (sh.D_MODEL, sh.FF),
                "down": (sh.FF, sh.D_MODEL)}
    return {"up": (sh.D_MODEL, sh.FF), "up_b": (sh.FF,), "down": (sh.FF, sh.D_MODEL),
            "down_b": (sh.D_MODEL,)}


def attention_specs(qk_norm: bool = False):
    """The attention projections' logical axes: heads on the output of
    ``wq`` / ``wk`` / ``wv`` and on the input of ``wo``."""
    specs = {"wq": (sh.D_MODEL, sh.HEADS), "wk": (sh.D_MODEL, sh.KV_HEADS),
             "wv": (sh.D_MODEL, sh.KV_HEADS), "wo": (sh.HEADS, sh.D_MODEL)}
    if qk_norm:
        specs["q_norm"] = {"scale": (None,)}
        specs["k_norm"] = {"scale": (None,)}
    return specs


def norm_init(dim: int, kind: str, dtype, device, stack: Tuple[int, ...] = ()):
    """A norm's parameters, ``stack`` copies: ``rms`` a zero scale, ``ln``
    a scale of ones and a zero bias."""
    shape = tuple(stack) + (dim,)
    if kind == "rms":
        return {"scale": torch.zeros(shape, dtype=dtype, device=device)}
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` for ``i < head_dim / 2`` (float32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-halves rotary embedding in float32: x ``(B, S, H, D)``,
    positions ``(B, S)`` int -> x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_div(dim: int, device=None) -> torch.Tensor:
    """``exp(2i * -ln(10000) / dim)`` for ``i < dim / 2`` in float32: the
    exponent formed in float32, the exponential correctly rounded (taken in
    float64).  The reference's table is a constant of its compiled step,
    and XLA folds it with a correctly rounded exp; its eager ``jnp.exp``
    is off by an ulp on a few lanes, which a position of 32767 turns into
    ~1e-3 of sin / cos."""
    arg = torch.arange(0, dim, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / dim)
    return torch.exp(arg.double()).float()


def sinusoidal_positions(num_pos: int, dim: int, device=None) -> torch.Tensor:
    """The extended sinusoidal table ``(num_pos, dim)`` float32: sin on the
    even lanes and cos on the odd ones of ``pos * div`` (whisper's encoder
    and its decoder beyond the checkpoint's 448 positions)."""
    pos = torch.arange(num_pos, dtype=torch.float32, device=device)
    return sinusoid_at(pos, dim)


def sinusoid_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """The sinusoidal embedding at positions ``pos`` (any shape, any
    numeric dtype) -> ``pos.shape + (dim,)`` float32; the angle is the
    float32 product ``pos * div``, as the reference forms it."""
    ang = pos.float()[..., None] * sinusoid_div(dim, pos.device)
    out = torch.empty(pos.shape + (dim,), dtype=torch.float32, device=pos.device)
    out[..., 0::2] = torch.sin(ang)
    out[..., 1::2] = torch.cos(ang)
    return out


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D ``(in, out)`` weight.

    On the CPU the product is made row-stable: the library's GEMM sums a
    row in an order that depends on the row count when ``w`` is a
    transposed view (up to a few rows) and when there is one row (its
    matrix-vector path), and in one order for every count of two rows or
    more against a contiguous ``w``.  So a transposed ``w`` (the tied head
    ``embed.T``) is made contiguous for the call and a single row is padded
    to two.  On the card the product is ``x @ w`` as it stands."""
    if x.device.type != "cpu":
        return x @ w
    if not w.is_contiguous():
        w = w.contiguous()
    rows = x.reshape(-1, x.shape[-1])
    if rows.shape[0] == 1:
        return (torch.cat([rows, rows]) @ w)[:1].reshape(x.shape[:-1] + w.shape[-1:])
    return x @ w


def wdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a raw ``(in, out)`` weight leaf or a serve-time record.

    * raw leaf: in the promoted dtype as ``jnp`` promotes it (an f32
      activation against a bf16 weight contracts in f32; torch's ``@``
      refuses mixed dtypes, so the weight is upcast for the call);
    * int8 record ``{"q", "scale"}``: as the reference, against the dense
      reconstruction ``(q * scale)`` cast to ``x.dtype``;
    * BSTC record ``{"bstc", "scale"}``: the fused decode + GEMV
      ``bstc_matmul`` on ``x`` viewed as ``(in, N)`` with the scale applied
      after the sum (the CUDA kernel for CUDA tensors, which reads the view
      in place and writes ``(N, out)`` rows) -> ``(..., out)`` in
      ``x.dtype``.  Same product as the reference's ``x @ (q * scale)``,
      summed in another order; in bf16 the reference also rounds
      ``q * scale`` to bf16 first, where the kernel multiplies exact
      integers."""
    if isinstance(w, dict):
        if "bstc" in w:
            lead = x.shape[:-1]
            y = bstc_matmul(w["bstc"], x.reshape(-1, x.shape[-1]).T, apply_scale=True)
            return y.T.reshape(lead + (y.shape[0],)).to(x.dtype)  # (out, N) f32 -> (..., out)
        dq = w["q"].to(torch.float32) * w["scale"][..., None, :].to(torch.float32)
        return matmul(x, dq.to(x.dtype))
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return matmul(x, w)


def glu_act(kind: str, gate: torch.Tensor) -> torch.Tensor:
    """The gate's activation: SiLU (``swiglu``) or tanh-approximate GELU
    (``geglu``)."""
    if kind == "swiglu":
        return F.silu(gate)
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh")
    raise ValueError(f"glu_act: activation {kind!r} is not a gated unit")


def mlp_apply(params, x: torch.Tensor, activation: str, reduce=None) -> torch.Tensor:
    """Gated MLP ``down(act(gate(x)) * up(x))`` for ``swiglu`` / ``geglu``;
    the plain ``gelu`` MLP with biases (``up``, ``up_b``, ``down``,
    ``down_b``) otherwise.  ``reduce`` (a training split's sum of ``down``'s
    row-parallel partial products) is applied to ``down``'s product before
    its bias."""
    reduce = reduce or (lambda y: y)
    if activation in ("swiglu", "geglu"):
        gate = wdot(x, params["gate"])
        return reduce(wdot(glu_act(activation, gate) * wdot(x, params["up"]), params["down"]))
    if activation != "gelu":
        raise ValueError(f"mlp_apply: unknown activation {activation!r}")
    h = F.gelu(wdot(x, params["up"]) + params["up_b"], approximate="tanh")
    return reduce(wdot(h, params["down"])) + params["down_b"]


def qkv_project(params, x: torch.Tensor, num_heads: int, num_kv_heads: int,
                head_dim: int, positions: Optional[torch.Tensor],
                rope_theta: float, qk_norm: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x ``(B, S, D)`` -> q ``(B, S, Hq, Dh)``, k / v ``(B, S, Hk, Dh)``,
    with RoPE on q and k at ``positions`` ``(B, S)``.  ``qk_norm`` (gemma3)
    RMS-normalises every q and k head over its ``Dh`` lanes with the
    zero-centred ``q_norm`` / ``k_norm`` scales, before RoPE."""
    B, S, _ = x.shape
    q = wdot(x, params["wq"]).reshape(B, S, num_heads, head_dim)
    k = wdot(x, params["wk"]).reshape(B, S, num_kv_heads, head_dim)
    v = wdot(x, params["wv"]).reshape(B, S, num_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, params["q_norm"]["scale"])
        k = rms_norm(k, params["k_norm"]["scale"])
    if positions is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v
