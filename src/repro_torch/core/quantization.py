"""Integer quantization per the paper (§4.1, Fig. 11).

Counterpart of :mod:`repro.core.quantization`.  Weights: per-channel
*symmetric* INT8 (scale only, clipped to [-127, 127] so magnitudes fit 7
bits / SM format).  Activations: per-tensor *asymmetric* (scale + zero
point).  Output: ``Y = Scale ⊙ (W_q X_q) + Bias``, where the zero-point
correction folds into a per-output-channel bias from the weight row sums.

Weights here are ``(out, in)``, the reference's layout for this module;
the model's matrices are ``(in, out)``: :func:`quantize_model_weight` is
the one place that transposes.  The serve path keeps its own
``serving.weights.quantize`` (per output column of an ``(in, out)``
matrix).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

INT8_MAX = 127.0


class QuantizedWeight(NamedTuple):
    """Per-channel symmetric INT8 weight: ``q`` int8 (out, in), ``scale`` (out,)."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale[:, None]


class QuantizedActivation(NamedTuple):
    """Per-tensor asymmetric INT8 activation: ``x ~= (q - zero_point) * scale``."""

    q: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor

    def dequantize(self) -> torch.Tensor:
        return (self.q.to(torch.float32) - self.zero_point) * self.scale


def quantize_weight(w: torch.Tensor, eps: float = 1e-8) -> QuantizedWeight:
    """Per-channel (dim 0 = output channel) symmetric INT8 quantization."""
    absmax = w.abs().amax(dim=tuple(range(1, w.ndim)))
    scale = absmax.clamp(min=eps) / INT8_MAX
    q = torch.round(w / scale.reshape((-1,) + (1,) * (w.ndim - 1)))
    return QuantizedWeight(q=q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8), scale=scale)


def quantize_model_weight(w_in_out: torch.Tensor) -> QuantizedWeight:
    """A model matrix in its ``(in, out)`` layout -> the ``(out, in)`` =
    ``(M, H)`` int8 weight that BRCR and :func:`quantized_linear` take."""
    return quantize_weight(w_in_out.T.to(torch.float32))


def quantize_activation(
    x: torch.Tensor,
    amin: Optional[torch.Tensor] = None,
    amax: Optional[torch.Tensor] = None,
    eps: float = 1e-8,
) -> QuantizedActivation:
    """Per-tensor asymmetric INT8.  ``(amin, amax)`` may come from calibration."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=x.device)
    amin = x.amin() if amin is None else f32(amin)
    amax = x.amax() if amax is None else f32(amax)
    amin = amin.clamp(max=0.0)  # keep 0 exactly representable
    amax = amax.clamp(min=0.0)
    scale = (amax - amin).clamp(min=eps) / 255.0
    zero_point = torch.round(-amin / scale) - 128.0
    q = torch.round(x / scale + zero_point).clamp(-128, 127).to(torch.int8)
    return QuantizedActivation(q=q, scale=scale, zero_point=zero_point)


def int_matmul(w_q: torch.Tensor, x_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 GEMM of integer operands: (M, K) @ (K, N) -> (M, N).

    On the CPU in int64, then int32 (the reference's int32 accumulator;
    equal wherever that does not wrap).  CUDA has no integer matmul, so on
    the card the product runs in float64, exact while every partial sum
    stays below 2**53 (int8 operands: K < 2**38)."""
    if w_q.device.type == "cpu":
        return (w_q.to(torch.int64) @ x_q.to(torch.int64)).to(torch.int32)
    return torch.round(w_q.to(torch.float64) @ x_q.to(torch.float64)).to(torch.int32)


def quantized_linear(
    w: QuantizedWeight,
    x: QuantizedActivation,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fig. 11b: ``Y = w_scale ⊙ x_scale · (W_q @ (X_q - Z_x)) [+ bias]``.

    The zero-point term ``W_q @ (Z_x · 1) = row_sum(W_q) · Z_x`` is a rank-1
    bias.  ``x.q`` is (K, N); returns (M, N) float32."""
    acc = int_matmul(w.q, x.q).to(torch.float32)
    row_sum = w.q.to(torch.int32).sum(1, dtype=torch.int32).to(torch.float32)
    acc = acc - row_sum[:, None] * x.zero_point
    y = acc * (w.scale[:, None] * x.scale)
    if bias is not None:
        y = y + bias[:, None]
    return y


def fake_quantized_linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize reference (W8A8) for accuracy-fidelity benchmarks."""
    return quantized_linear(quantize_weight(w), quantize_activation(x))


def quantization_error(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max_abs_err, rel_fro_err) of the per-channel symmetric INT8 round trip."""
    wd = quantize_weight(w).dequantize()
    rel = torch.linalg.norm(wd - w) / torch.linalg.norm(w).clamp(min=1e-8)
    return (wd - w).abs().max(), rel
