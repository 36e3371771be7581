"""Hand-written Hopper kernels of the port: the serving hot path and the
paper layer.

Each kernel package ships three files, mirroring ``repro.kernels``:
  ref.py    — the plain PyTorch version of the function (the CPU path and
              the on-card oracle)
  kernel.py — the ctypes binding of the CUDA C++ kernel in ``csrc/``
  ops.py    — the public wrapper: validation, routing by the tensors'
              device, the launch counter

Routing is decided by where the tensors live, never by a mode knob: CPU
tensors take ``ref.py``; CUDA tensors launch the kernel or the call raises.

Kernels:
  paged_flash_decode — page-table-aware single-token GQA decode attend over
                    the token-major paged pool (bf16/f32 body and int8
                    A2/A3 body)
  bgpp_paged_attend — fused two-phase BGPP decode: progressive bit-plane
                    top-k prediction, compacted survivor gather, exact int8
                    attend, in one launch
  bstc_matmul     — fused BSTC decode + GEMV: ``(w_q @ x) * scale`` straight
                    from the two-state-coded int8 weight planes (every
                    decode projection of a ``weight_format="bstc"`` run)
  bstc_decode     — BSTC plane decode: indicator bitmap + pattern stream ->
                    (G, H) group patterns (the serve-params round-trip check)
  flash_attention — tiled online-softmax GQA attention (causal, sliding,
                    chunked, full and the VLM's prefix_causal masks): the
                    attention of every layer of
                    the whole-sequence forward (eager admission,
                    whole-batch prefill, training); its backward
                    (``flash_attention_bwd``: dq, dk, dv from the forward's
                    out and row log-sum-exp) is the gradient the training
                    path takes through it
  bgpp_score      — one BGPP round: the masked bit-plane score of every key
                    for every query head, dead key tiles skipped (each round
                    of ``core.bgpp.bgpp_predict`` / ``bgpp_predict_batched``)
  brcr_gemm       — BRCR GEMM: ``w_q @ x`` from the signed-plane group
                    patterns through the MAV and E @ Z (``core.brcr.
                    brcr_matmul``)

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one where
it launches its CUDA kernel and nowhere else, so a run can show that the
main path went through the kernels (``reset_launches`` before the run,
read the dict after).
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "paged_flash_decode_bf16": 0,
    "paged_flash_decode_int8": 0,
    "bgpp_paged_attend": 0,
    "bstc_matmul": 0,
    "bstc_decode": 0,
    "flash_attention": 0,
    "flash_attention_bwd": 0,
    "bgpp_score": 0,
    "brcr_gemm": 0,
}


def reset_launches() -> None:
    """Zero every kernel's launch count."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
