"""Launch the CUDA BGPP round-scoring kernel
(``src/repro_torch/csrc/bgpp_score.cu``) through ``ctypes``.

Grid: one 128-thread block per (128-key tile, query row); query row ``r``
is head ``r % Hq`` of batch ``r // Hq`` and reads kv head ``(r % Hq) //
g``'s plane through the plane's batch, token and head strides (unit stride
along the packed D).  Callers pass validated CUDA tensors; :mod:`.ops` is
the public wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def launch(q, plane, sign, alive, out) -> None:
    """Enqueue one launch on the current stream; raise if it was refused."""
    lib = build.load()
    B, Hq, D = q.shape
    S, Hk = plane.shape[1], plane.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.bgpp_score_launch(
        q.data_ptr(), plane.data_ptr(), sign.data_ptr(), alive.data_ptr(), out.data_ptr(),
        B * Hq, S, D // 8, Hq, Hq // Hk, *plane.stride()[:3], *sign.stride()[:3], stream)
    build.check(err, "bgpp_score")
