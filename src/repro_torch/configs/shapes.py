"""Assigned input shapes (every arch × these four = the 40-cell matrix).

``train_4k``/``prefill_32k`` lower train/prefill steps; ``decode_32k``/
``long_500k`` lower ``serve_step`` (one new token against a seq_len KV
cache).  ``long_500k`` requires sub-quadratic attention — the skip table in
``applicable`` mirrors the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES: List[ShapeConfig] = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
SHAPE_BY_NAME = {s.name: s for s in SHAPES}

# archs with a sub-quadratic long-context story
_LONG_OK = {
    "gemma3-4b",       # 5:1 local:global sliding window
    "gemma3-1b",
    "mixtral-8x22b",   # SWA
    "llama4-scout-17b-a16e",  # chunked local 3:1
    "mamba2-1.3b",     # O(1) state
    "jamba-1.5-large-398b",   # 1:7 attn:mamba
}


def applicable(arch: str, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; otherwise the documented skip reason."""
    if shape.name == "long_500k" and arch not in _LONG_OK:
        return "pure full-attention arch: long_500k needs sub-quadratic attention"
    return None


def get_shape(name: str) -> ShapeConfig:
    return SHAPE_BY_NAME[name]
