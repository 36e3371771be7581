"""Synthetic LLM-like weights/activations for the paper-layer examples.

The port's own copy of :mod:`repro.utils.synthetic` (numpy only, so the
same seed gives the same weights as in the reference).

Real LLM weight matrices are Gaussian-bulk + per-channel outliers (LLM.int8
[17]); under per-channel absmax INT8 quantization, the outliers pin the scale
and push the bulk into low magnitudes, which is exactly what produces the
paper's Fig. 8(c) bit-plane sparsity profile (planes 3–7 ≥ 65% zero, average
bit sparsity ≈ 0.70 vs value sparsity ≈ 0.05).

``synthetic_llm_weight`` is calibrated against that profile, so
op-count/compression figures run on paper-faithful statistics without
shipping model checkpoints.
"""

from __future__ import annotations

import numpy as np


def synthetic_llm_weight(
    rng: np.random.Generator,
    shape: tuple[int, int],
    sigma: float = 0.02,
    outliers_per_channel: int = 2,
    outlier_scale: float = 12.0,
) -> np.ndarray:
    """float32 (out_channels, in_features) Gaussian bulk + channel outliers."""
    out_ch, in_f = shape
    w = rng.normal(size=shape).astype(np.float32) * sigma
    n_out = min(outliers_per_channel, in_f)
    if n_out > 0:
        cols = np.stack([rng.choice(in_f, n_out, replace=False) for _ in range(out_ch)])
        rows = np.repeat(np.arange(out_ch)[:, None], n_out, axis=1)
        w[rows, cols] *= outlier_scale
    return w


def synthetic_llm_weight_int8(
    rng: np.random.Generator, shape: tuple[int, int], **kw
) -> tuple[np.ndarray, np.ndarray]:
    """(int8 weights, per-channel scale) via per-channel symmetric quant."""
    w = synthetic_llm_weight(rng, shape, **kw)
    absmax = np.abs(w).max(axis=1)
    scale = np.maximum(absmax, 1e-8) / 127.0
    q = np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def synthetic_activation(
    rng: np.random.Generator, shape: tuple[int, ...], sigma: float = 1.0
) -> np.ndarray:
    """Post-layernorm-like activations (zero-mean Gaussian, mild outliers)."""
    x = rng.normal(size=shape).astype(np.float32) * sigma
    mask = rng.random(shape) < 0.001
    return np.where(mask, x * 8.0, x).astype(np.float32)
