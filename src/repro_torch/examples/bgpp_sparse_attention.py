"""BGPP walkthrough: progressive bit-grained prediction on a realistic
attention distribution, showing per-round pruning, early termination, and
the traffic/recall trade-off vs the value-level top-k baseline (paper
Figs. 3, 5(e,g), 9).

    PYTHONPATH=src python -m repro_torch.examples.bgpp_sparse_attention [--device cpu]

The port's counterpart of ``examples/bgpp_sparse_attention.py``, at its
S = 4096 keys of D = 128 (phi4-mini-3.8b's head width).  On CUDA tensors
every predictor round is one ``bgpp_score`` kernel launch.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bgpp, topk

ALPHAS = (0.4, 0.5, 0.55, 0.6)
ROUNDS = (2, 4, 6)


def make_concentrated_keys(rng, S, D, n_relevant=32):
    """Keys where a few are aligned with the query (real attention is
    concentrated — paper §2.2's premise)."""
    q = rng.normal(size=(D,)).astype(np.float32)
    k = rng.normal(size=(S, D)).astype(np.float32)
    idx = rng.choice(S, n_relevant, replace=False)
    k[idx] += q * rng.uniform(1.0, 2.5, size=(n_relevant, 1))
    k_int = np.clip(np.round(k * 25), -127, 127).astype(np.int32)
    q_int = np.clip(np.round(q * 25), -127, 127).astype(np.int32)
    return q_int, k_int, set(idx.tolist())


def key_planes(k: np.ndarray, device):
    """int keys (..., D) -> (sign (..., D), magnitude planes (7, ..., D)) as
    {0,1} uint8 tensors on ``device``."""
    sign = torch.from_numpy((k < 0).astype(np.uint8)).to(device)
    mag = np.abs(k).astype(np.uint8)
    planes = torch.from_numpy(np.stack([(mag >> p) & 1 for p in range(7)], 0)).to(device)
    return sign, planes


def main(S: int = 4096, device="cuda"):
    """Print the reference walkthrough's table and lines over ``S`` keys of
    D = 128; return its numbers (the sweep rows, the value-level baseline,
    the 7-round alive history and mask) for callers that check them."""
    dev = resolve_device(device)
    D = 128
    rng = np.random.default_rng(0)
    q, k, _ = make_concentrated_keys(rng, S, D)

    sign, planes = key_planes(k, dev)
    qj = torch.from_numpy(q).to(dev)
    scale = 1.0 / (25 * 25 * np.sqrt(D))

    # ground truth: softmax distribution (what the attention output sees)
    logits = (k @ q).astype(np.float64) * scale
    p = np.exp(logits - logits.max())
    p /= p.sum()

    # the metric that matters: softmax mass captured by the surviving keys
    # (keys far below the max contribute nothing to the output — that's the
    # paper's radius insight: gap > radius ⇒ softmax ≈ 0)
    print(f"{'alpha':>6} {'rounds':>6} {'kept':>6} {'mass':>7} "
          f"{'traffic_vs_full':>15} {'vs_value_topk':>13}")
    rows = []
    for alpha in ALPHAS:
        for rounds in ROUNDS:
            alive, est, stats = bgpp.bgpp_predict(
                qj, planes, sign,
                bgpp.BGPPConfig(rounds=rounds, alpha=alpha),
                logit_scale=scale,
            )
            mask = alive.cpu().numpy()
            mass = float(p[mask].sum())
            frac = float(stats.predict_bytes) / (S * D)
            vs_value = float(stats.predict_bytes) / float(stats.value_topk_bytes)
            rows.append((alpha, rounds, int(mask.sum()), mass, frac, vs_value))
            print(f"{alpha:>6} {rounds:>6} {int(mask.sum()):>6} {mass:>7.4f} "
                  f"{frac:>15.3f} {vs_value:>13.3f}")

    # value-level baseline for the same fidelity
    idx, _, vstats = topk.value_topk_predict(
        qj, torch.from_numpy(k.astype(np.int8)).to(dev), k_keep=256)
    idx = idx.cpu().numpy()
    mass_v = float(p[idx].sum())
    print(f"\nvalue-level top-256: mass {mass_v:.4f}, predict bytes "
          f"{float(vstats.predict_bytes):.0f} — BGPP reaches the same mass "
          f"while fetching bit-planes of survivors only")

    alive, _, stats = bgpp.bgpp_predict(
        qj, planes, sign, bgpp.BGPPConfig(rounds=7, alpha=0.55), logit_scale=scale
    )
    hist = stats.alive_per_round.cpu().numpy()
    print(f"\nper-round alive counts (early termination visible): {hist.tolist()}")
    mask = alive.cpu().numpy()
    heavy = p > 1e-3  # keys that actually matter to the output
    print(f"softmax mass kept: {float(p[mask].sum()):.4f}; "
          f"heavy-key recall (p>1e-3): {float(mask[heavy].mean()):.3f}")
    return {"rows": rows, "value_topk_idx": idx, "value_topk_mass": mass_v,
            "alive_per_round": hist, "alive": mask}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
