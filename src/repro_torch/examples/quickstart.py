"""Quickstart: MCBP's three techniques on one weight matrix, end to end.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's counterpart of ``examples/quickstart.py``, run by default at
phi4-mini-3.8b's width: an (d_ff, d_model) = (8192, 3072) weight from the
config, x of 16 columns, BGPP over 1024 keys of head_dim 128.  On CUDA
tensors BRCR runs the ``brcr_gemm`` kernel (one launch) and BGPP the
``bgpp_score`` kernel (one launch a round).  ``main(shape=(64, 1024))``
is the reference example's own size and prints its numbers.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import bgpp, bitslice, brcr, bstc, quantization
from repro_torch.utils.synthetic import synthetic_llm_weight


def full_width_shape():
    """(M, H) = (d_ff, d_model) of phi4-mini-3.8b: its FFN up projection."""
    cfg = get_config("phi4-mini-3.8b")
    return cfg.d_ff, cfg.d_model


def main(shape=None, device="cuda"):
    """Run the three steps and print the reference example's lines.

    ``shape`` (M, H) defaults to :func:`full_width_shape`.  Returns what
    the lines report, for callers that check it: BRCR's result, its int64
    reference and operands, BSTC losslessness, the BGPP alive mask."""
    dev = resolve_device(device)
    M, H = full_width_shape() if shape is None else shape
    D = get_config("phi4-mini-3.8b").head_dim  # 128, the reference example's D
    rng = np.random.default_rng(0)

    # --- quantize an LLM-like weight (per-channel symmetric INT8) ---------
    w = torch.from_numpy(synthetic_llm_weight(rng, (M, H))).to(dev)
    qw = quantization.quantize_weight(w)
    _, mag = bitslice.to_sign_magnitude(qw.q)
    sp = bitslice.bit_sparsity(bitslice.bitplanes(mag)).cpu().numpy()
    print(f"bit-plane sparsity (LSB→MSB): {np.round(sp, 3)}")
    w_np = qw.q.cpu().numpy()
    print(f"value sparsity: {float((w_np == 0).mean()):.3f}")

    # --- BRCR: exact GEMM through the enumeration factorization -----------
    x_np = rng.integers(-50, 50, size=(H, 16))
    x = torch.from_numpy(x_np).to(torch.int32).to(dev)
    y = brcr.brcr_matmul(qw.q, x, m=4).cpu().numpy()
    ref = w_np.astype(np.int64) @ x_np.astype(np.int64)
    cost = brcr.brcr_cost(qw.q, m=4)
    exact = bool((y == ref).all())
    print(f"\nBRCR exact: {exact}")
    print(f"BRCR adds: {cost.adds_total}  vs bit-serial: {cost.adds_bsc_baseline} "
          f"({100*cost.reduction_vs_bsc:.1f}% fewer)")

    # --- BSTC: lossless two-state weight compression -----------------------
    bw = bstc.encode_weight(qw.q, qw.scale)
    lossless = bool(torch.equal(bstc.decode_weight(bw), qw.q))
    print(f"\nBSTC lossless: {lossless}, "
          f"CR = {bw.compression_ratio:.3f}x "
          f"(compressed planes: {[p+1 for p in range(7) if bw.encoded[p] is not None]})")

    # --- BGPP: progressive top-k prediction --------------------------------
    S = 1024
    k = np.clip(np.round(rng.normal(size=(S, D)) * 30), -127, 127).astype(np.int32)
    sign = torch.from_numpy((k < 0).astype(np.uint8)).to(dev)
    magk = np.abs(k).astype(np.uint8)
    planes = torch.from_numpy(np.stack([(magk >> p) & 1 for p in range(7)], 0)).to(dev)
    q_np = rng.integers(-60, 60, size=(D,)).astype(np.int32)
    q = torch.from_numpy(q_np).to(torch.int32).to(dev)
    alive, est, stats = bgpp.bgpp_predict(
        q, planes, sign, bgpp.BGPPConfig(rounds=4, alpha=0.55),
        logit_scale=1.0 / np.sqrt(D) / 900.0,
    )
    alive_np = alive.cpu().numpy()
    true_top = np.argsort(k @ q_np)[-16:]
    recall = alive_np[true_top].mean()
    predict_bytes, value_bytes = float(stats.predict_bytes), float(stats.value_topk_bytes)
    print(f"\nBGPP kept {int(alive_np.sum())}/{S} keys, top-16 recall {recall:.2f}")
    print(f"predict traffic: {predict_bytes:.0f} B vs "
          f"value-level {value_bytes:.0f} B "
          f"({100*(1-predict_bytes/value_bytes):.0f}% saved)")
    return {"brcr_exact": exact, "bstc_lossless": lossless, "bgpp_alive": alive_np,
            "brcr_y": y, "brcr_ref": ref, "w_int8": w_np, "x": x_np}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
