"""Training launcher of the port: data pipeline + train step +
checkpoint/restore + heartbeat + straggler monitoring + resilient loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b --smoke \\
        --steps 100 --batch 8 --seq-len 128 [--device cuda|cpu] [--full] \\
        [--layers N] [--grad-accum 1] [--int8-opt] [--ckpt-dir DIR] \\
        [--ckpt-every 50] [--heartbeat FILE] [--data 1 --model 1 | --mesh D,M] [--fsdp]

    python -m torch.distributed.run --nproc-per-node 8 -m repro_torch.launch.train \\
        --mesh 2,4 --fsdp ...

The counterpart of ``repro.launch.train``.  Without mesh flags it trains on
one device; ``--data`` / ``--model`` (or ``--mesh DATA,MODEL``) train on a
``(data, model)`` mesh of ``torch.distributed`` ranks (``torchrun``'s world,
or a world of one), with the reference's rules: ``fsdp_axes=(d_model,)``
under ``--fsdp``, sequence parallelism where ``model > 1``
(:mod:`repro_torch.training.sharded`; every family).  Each rank takes its
rows of the global batch (a VLM's ``vision`` stub rows and whisper's
``frames`` beside its tokens; the data axis must divide ``--batch``); rank
0 alone writes checkpoints and the
heartbeat, every rank restores.  It
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
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh
from repro_torch.models import model_zoo
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import Heartbeat, StragglerMonitor, run_resilient
from repro_torch.training import make_train_step
from repro_torch.training.sharded import TrainShard


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
    ap.add_argument("--fsdp", action="store_true",
                    help="shard every leaf's d_model over the data axis too (ZeRO-3)")
    mesh.add_mesh_args(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    meshed, rules, started, rank = mesh.mesh_from_args(args), None, False, 0
    if meshed:
        device, rules, started = mesh.start_mesh(
            args.data, args.model, device, fsdp_axes=(sh.D_MODEL,) if args.fsdp else (),
            sp=args.model > 1)
        rank = torch.distributed.get_rank()
    try:
        return _train(args, cfg, device, rules, rank)
    finally:
        mesh.stop_mesh(started)


def _train(args, cfg, device, rules, rank: int) -> Dict:
    opt_cfg = AdamWConfig(
        peak_lr=3e-4, warmup_steps=min(50, args.steps // 4), decay_steps=args.steps,
        state_dtype="int8" if args.int8_opt else "fp32",
    )
    shard = TrainShard.of(cfg, rules)
    params = model_zoo.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    if shard is not None:
        params = shard.shard_params(params)
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    step_fn = make_train_step(cfg, opt_cfg, fwd_kwargs(cfg), grad_accum=args.grad_accum,
                              rules=rules)
    shardings = None if shard is None else shard.placement(opt_cfg)

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq_len, args.batch, seed=0,
                            modality=modality(cfg))
    ckpt = Checkpointer(args.ckpt_dir, keep=3)
    hb = Heartbeat(args.heartbeat, interval_s=10.0, payload={"arch": cfg.name})
    if rank == 0:
        hb.start()
    monitor = StragglerMonitor(threshold=8.0)
    say = print if rank == 0 else (lambda *a, **k: None)

    start = ckpt.latest_step() or 0
    if start:
        start, state = ckpt.restore(state, shardings=shardings)
        say(f"[train] restored step {start} from {args.ckpt_dir}")
    if shard is not None:
        say(f"[train] mesh {shard.data}x{shard.split.size} ({cfg.name}; fsdp "
            f"{shard.fsdp is not None}, sp {shard.split.seq})")
    holder = {"state": state}
    losses: Dict[int, float] = {}
    pf = Prefetcher(ds, depth=2, start_step=start, device=device)

    def train_one(step):
        got_step, batch = pf.next()
        assert got_step == step, (got_step, step)
        if shard is not None:
            batch = shard.local_rows(batch)
        t0 = time.perf_counter()
        holder["state"], metrics = step_fn(holder["state"], batch)
        losses[step] = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        monitor.record(step, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"[train] step {step:5d} loss {losses[step]:8.4f} "
                f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.3f} "
                f"({dt * 1e3:.0f} ms)")
        if step and step % args.ckpt_every == 0:
            ckpt.save(step + 1, holder["state"], shardings=shardings)
        if rank == 0:
            hb.beat(step=step)

    def restore():
        nonlocal pf
        step, holder["state"] = ckpt.restore(holder["state"], shardings=shardings)
        pf.close()
        pf = Prefetcher(ds, depth=2, start_step=step, device=device)
        return step

    def on_failure(step, err):
        print(f"[train] rank {rank} step {step} failed ({type(err).__name__}: {err}); "
              f"restoring the latest checkpoint")

    try:
        failures = run_resilient(train_one, start, args.steps - start, restore,
                                 on_failure=on_failure)
        say(f"[train] done ({failures} failures survived); "
            f"median step {monitor.median * 1e3:.0f} ms")
        if device.type == "cuda":
            say(f"[train] peak device memory "
                f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
        ckpt.save(args.steps, holder["state"], shardings=shardings)
        ckpt.wait()
    finally:
        pf.close()
        if rank == 0:
            hb.stop()
    return {"losses": losses, "failures": failures, "median_ms": monitor.median * 1e3,
            "cfg": cfg}


if __name__ == "__main__":
    main()
