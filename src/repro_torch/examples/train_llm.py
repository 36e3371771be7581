"""End-to-end training example: a ~100M-param dense LM for a few hundred
steps with the full substrate stack — synthetic data pipeline with
prefetch, AdamW (+optional int8 states), checkpointing, straggler
monitoring.

    PYTHONPATH=src python -m repro_torch.examples.train_llm [--steps 300] \\
        [--d-model 512] [--layers 8] [--int8-opt] [--ckpt-dir DIR] \\
        [--device cuda|cpu]

The counterpart of ``examples/train_llm.py`` (the reference's demo model
and loop), on ``--device cuda`` unless told otherwise; the checkpoint
directory defaults to ``mcbp_ckpt`` under the temporary directory.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data import Prefetcher, SyntheticLMDataset
from repro_torch.models import model_zoo
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import StragglerMonitor
from repro_torch.training import make_train_step


def main(argv=None):
    """Train the demo model; returns the per-step losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "mcbp_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda raises without a card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ModelConfig(
        name=f"train-demo-{args.d_model}d{args.layers}L",
        family="dense",
        num_layers=args.layers,
        d_model=args.d_model,
        num_heads=args.d_model // 64,
        num_kv_heads=max(1, args.d_model // 128),
        head_dim=64,
        d_ff=4 * args.d_model,
        vocab_size=args.vocab,
        activation="swiglu",
        norm="rms",
        dtype="float32",
    )
    print(f"[train] {cfg.name}: {cfg.total_params()/1e6:.1f}M params")

    params = model_zoo.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    opt_cfg = AdamWConfig(
        peak_lr=3e-4, warmup_steps=50, decay_steps=args.steps,
        state_dtype="int8" if args.int8_opt else "fp32",
    )
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    step_fn = make_train_step(cfg, opt_cfg, fwd_kwargs=dict(block_q=64, block_k=128, remat=True))

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq_len, args.batch, seed=0)
    pf = Prefetcher(ds, depth=2, device=device)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    # loose threshold: short steps jitter a lot relative to the median
    monitor = StragglerMonitor(threshold=8.0)

    t_start = time.perf_counter()
    losses = []
    try:
        for _ in range(args.steps):
            step, batch = pf.next()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            dt = time.perf_counter() - t0
            if monitor.record(step, dt):
                print(f"[train] straggler flagged at step {step} ({dt:.2f}s)")
            if step % 20 == 0 or step == args.steps - 1:
                tps = args.batch * args.seq_len / max(dt, 1e-9)
                print(f"[train] step {step:4d} loss {losses[-1]:7.4f} "
                      f"lr {float(metrics['lr']):.2e} gnorm "
                      f"{float(metrics['grad_norm']):.2f} ({tps:.0f} tok/s)")
            if step and step % args.ckpt_every == 0:
                ckpt.save(step, state)
    finally:
        pf.close()
        ckpt.wait()

    total = time.perf_counter() - t_start
    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    print(f"[train] {args.steps} steps in {total:.1f}s; "
          f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    ckpt.save(args.steps, state)
    ckpt.wait()
    print(f"[train] final checkpoint at {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
