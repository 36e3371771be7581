"""Bring parameter trees across from the JAX package, as numpy arrays.

The tests build the JAX reference and the port from the SAME parameters:
``jax.tree.map(np.asarray, params)`` on the JAX side, then
:func:`params_from_numpy` here.  The JAX layout is kept as it is — ``(in,
out)`` projection weights, stacked ``(L, ...)`` layer leaves — so the two
sides compare like with like.  bf16 leaves arrive as numpy arrays whose
``dtype.name == "bfloat16"``; they are reinterpreted through ``uint16``
bits, so no ``ml_dtypes`` import is needed.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy array -> a torch tensor on ``device`` (bf16 bit-exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
