"""Closed-form serve-time traffic of the BSTC weight coding.

Counterpart of :func:`repro.analysis.roofline.bstc_weight_traffic`, the one
closed form the serving slices read (the ``modeled`` column of
:class:`repro_torch.serving.weights.WeightPlan`).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.core.bstc import compression_ratio_closed_form


def bstc_weight_traffic(
    in_dim: int,
    out_dim: int,
    m: int = 4,
    nbits: int = 7,
    col_sparsity=None,
    dtype_bytes: int = 2,
) -> Dict[str, float]:
    """Closed-form HBM bytes of ONE ``(in, out)`` projection under the BSTC
    two-state weight coding (paper §4.1).

    A magnitude plane with m-bit column sparsity ``sc_p`` codes to
    ``in·out / CR(m, sc_p)`` bits; a ``None`` entry of ``col_sparsity``
    is a plane the encoder kept raw (``in·out`` bits); the sign plane is
    always raw and the f32 output-channel scales add ``4·out`` bytes.
    Omitting ``col_sparsity`` prices every plane raw — plain int8.
    Returns coded bytes plus the int8/bf16 baselines and reductions."""
    if col_sparsity is None:
        col_sparsity = [None] * nbits
    if len(col_sparsity) != nbits:
        raise ValueError(
            f"col_sparsity has {len(col_sparsity)} entries, expected nbits={nbits}")
    n = float(in_dim) * float(out_dim)
    bits = n  # sign plane, always raw
    for sc in col_sparsity:
        bits += n if sc is None else n / compression_ratio_closed_form(m, float(sc))
    coded = bits / 8.0 + 4.0 * out_dim
    int8 = n + 4.0 * out_dim
    bf16 = dtype_bytes * n
    return {
        "bstc_bytes": coded,
        "int8_bytes": int8,
        "bf16_bytes": bf16,
        "reduction_vs_int8": int8 / coded,
        "reduction_vs_bf16": bf16 / coded,
    }
