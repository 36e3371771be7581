"""BGPP — Bit-Grained Progressive Prediction (paper §3.3): the query
precompute the serving decode uses.

Counterpart of the part of :mod:`repro.core.bgpp` that the serving engine
reaches (``engine._bgpp_quant_query``): the 4-bit MSB query truncation.
"""

from __future__ import annotations

import torch

DEFAULT_QUERY_BITS = 4  # paper precompute uses 4-bit MSB queries


def _truncate_query(q: torch.Tensor, nbits: int, query_bits: int) -> torch.Tensor:
    """Keep the top ``query_bits`` magnitude bits of an int query (paper: 4b):
    ``sign(q) * ((|q| >> s) << s)``, with ``sign(0) == 0``."""
    shift = max(nbits - query_bits, 0)
    return torch.sign(q) * ((q.abs() >> shift) << shift)
