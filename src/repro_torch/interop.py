"""Bring parameter trees across from the JAX package, as numpy arrays.

The tests build the JAX reference and the port from the SAME parameters:
``jax.tree.map(np.asarray, params)`` on the JAX side, then
:func:`params_from_numpy` here.  The JAX layout is kept as it is — ``(in,
out)`` projection weights, stacked ``(L, ...)`` layer leaves, an MoE
layer's ``moe`` subtree (``router``, the ``(L, E, ...)`` ``gate`` / ``up`` /
``down`` banks, ``shared/*``), a VLM's ``(d_vision, d_model)``
``vision_proj``, whisper's ``encoder`` / ``decoder`` stacks with their
layer norms' ``scale`` and ``bias`` and the MLP biases — so the two sides
compare like with like.
bf16 leaves arrive as numpy arrays whose ``dtype.name == "bfloat16"``;
they are reinterpreted through ``uint16`` bits, so no ``ml_dtypes`` import
is needed.
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


def serve_params_from_numpy(tree: Any, cfg, fmt: str, device="cuda") -> Any:
    """A JAX serve-params tree (``weights.prepare_serve_params`` of the JAX
    package, as numpy) -> the port's serve tree for ``fmt``.

    The JAX tree carries int8 ``{"q", "scale"}`` records in both the int8
    and the bstc format (its bstc path serves the same records).  They
    cross as they are for ``"int8"``; for ``"bstc"`` each is coded into
    the port's ``{"bstc": operands, "scale"}`` record, as the port's own
    ``prepare_serve_params`` codes its int8 values.  Raw leaves (norms, the
    MoE experts, a VLM's ``vision_proj``) cross as tensors."""
    from repro_torch.serving import weights

    def conv(node):
        if not isinstance(node, dict):
            return tensor_from_numpy(node, device)
        if "q" in node and "scale" in node:
            q, scale = (tensor_from_numpy(node[k], device) for k in ("q", "scale"))
            if q.dtype != torch.int8 or scale.dtype != torch.float32:
                raise ValueError(f"serve_params_from_numpy: a record needs int8 q and "
                                 f"f32 scale, got {q.dtype} / {scale.dtype}")
            return {"q": q, "scale": scale} if fmt == "int8" else \
                weights.bstc_record_from_int8(q, scale, cfg)
        return {k: conv(v) for k, v in node.items()}

    if fmt not in ("int8", "bstc"):
        raise ValueError(f"serve_params_from_numpy: fmt must be int8 or bstc, got {fmt!r}")
    return conv(tree)
