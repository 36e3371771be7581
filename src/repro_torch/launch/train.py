"""Training launcher of the port: data pipeline + train step +
checkpoint/restore + heartbeat + straggler monitoring + resilient loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b --smoke \\
        --steps 100 --batch 8 --seq-len 128 [--device cuda|cpu] [--full] \\
        [--layers N] [--grad-accum 1] [--int8-opt] [--ckpt-dir DIR] \\
        [--ckpt-every 50] [--heartbeat FILE]

The counterpart of ``repro.launch.train`` on one device: no mesh, so no
``--data`` / ``--model`` / ``--fsdp`` (sharding is ROADMAP item 7).  It
runs on ``--device cuda`` unless told otherwise; ``--full`` trains the
published full-width config instead of the smoke one and ``--layers``
cuts its depth.  Weights are random, drawn from a seeded generator on the
device; batches come from :class:`repro_torch.data.SyntheticLMDataset`
(seed 0), prefetched onto the device.  The forward runs with ``remat``
(the dense families also take the reference's ``block_q`` / ``block_k``,
ignored; the ssm family ``chunk`` 64, the hybrid ``ssd_chunk`` 64).  A checkpoint is written after every
``--ckpt-every``-th step and at the end (default directory
``mcbp_train`` under the temporary directory); a run that finds one in
``--ckpt-dir`` resumes from the latest.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_REGISTRY, get_config
from repro_torch.data import Prefetcher, SyntheticLMDataset
from repro_torch.models import model_zoo
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import Heartbeat, StragglerMonitor, run_resilient
from repro_torch.training import make_train_step


def fwd_kwargs(cfg) -> Dict:
    """The forward keywords the reference's launcher trains with."""
    if cfg.family == "ssm":
        return dict(chunk=64, remat=True)
    if cfg.family == "hybrid":
        return dict(block_q=64, block_k=128, remat=True, ssd_chunk=64)
    return dict(block_q=64, block_k=128, remat=True)


def modality(cfg) -> Dict[str, tuple]:
    """The stub inputs beyond tokens: a VLM's patch embeddings, whisper's
    frames."""
    if cfg.family == "vlm":
        return {"vision": (cfg.vision_tokens, cfg.d_vision)}
    if cfg.family == "enc_dec":
        return {"frames": (cfg.encoder_seq, cfg.d_audio)}
    return {}


def main(argv: Optional[List[str]] = None) -> Dict:
    """Parse the flags and train; returns ``{"losses": {step: loss},
    "failures", "median_ms", "cfg"}``."""
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCH_REGISTRY), default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="the smoke config (the default, as the reference's flag)")
    ap.add_argument("--full", action="store_true",
                    help="train the published full-width config instead of the smoke one")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth to this many layers (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda raises without a card)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tmp, "mcbp_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--heartbeat", default=os.path.join(tmp, "mcbp_train_heartbeat.json"))
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    opt_cfg = AdamWConfig(
        peak_lr=3e-4, warmup_steps=min(50, args.steps // 4), decay_steps=args.steps,
        state_dtype="int8" if args.int8_opt else "fp32",
    )
    params = model_zoo.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    step_fn = make_train_step(cfg, opt_cfg, fwd_kwargs(cfg), grad_accum=args.grad_accum)

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq_len, args.batch, seed=0,
                            modality=modality(cfg))
    ckpt = Checkpointer(args.ckpt_dir, keep=3)
    hb = Heartbeat(args.heartbeat, interval_s=10.0, payload={"arch": cfg.name}).start()
    monitor = StragglerMonitor(threshold=8.0)

    start = ckpt.latest_step() or 0
    if start:
        start, state = ckpt.restore(state)
        print(f"[train] restored step {start} from {args.ckpt_dir}")
    holder = {"state": state}
    losses: Dict[int, float] = {}
    pf = Prefetcher(ds, depth=2, start_step=start, device=device)

    def train_one(step):
        got_step, batch = pf.next()
        assert got_step == step, (got_step, step)
        t0 = time.perf_counter()
        holder["state"], metrics = step_fn(holder["state"], batch)
        losses[step] = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        monitor.record(step, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {losses[step]:8.4f} "
                  f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt * 1e3:.0f} ms)")
        if step and step % args.ckpt_every == 0:
            ckpt.save(step + 1, holder["state"])
        hb.beat(step=step)

    def restore():
        nonlocal pf
        step, holder["state"] = ckpt.restore(holder["state"])
        pf.close()
        pf = Prefetcher(ds, depth=2, start_step=step, device=device)
        return step

    def on_failure(step, err):
        print(f"[train] step {step} failed ({type(err).__name__}: {err}); restoring the "
              f"latest checkpoint")

    try:
        failures = run_resilient(train_one, start, args.steps - start, restore,
                                 on_failure=on_failure)
        print(f"[train] done ({failures} failures survived); "
              f"median step {monitor.median * 1e3:.0f} ms")
        if device.type == "cuda":
            print(f"[train] peak device memory "
                  f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
        ckpt.save(args.steps, holder["state"])
        ckpt.wait()
    finally:
        pf.close()
        hb.stop()
    return {"losses": losses, "failures": failures, "median_ms": monitor.median * 1e3,
            "cfg": cfg}


if __name__ == "__main__":
    main()
