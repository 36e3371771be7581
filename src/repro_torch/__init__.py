"""MCBP serving in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of the JAX package ``repro`` (which stays the reference).  Module
paths mirror ``src/repro/``; the decode hot path runs on hand-written CUDA
kernels under ``repro_torch/csrc`` (see :mod:`repro_torch.kernels`).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; asking for cuda on a host without it raises.

Importing the package turns TF32 off for float32 matrix products and
convolutions: the plain versions run integer-valued dot products as
float32 matmuls, which are exact only at full float32 precision.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.  ``cuda`` on a host
    without a usable card raises — nothing drops to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
