"""Serving launcher of the port: slot-level continuous batching over the
PyTorch engine (per-slot positions, bf16 / int8 / bgpp KV caches, slot or
paged layout, request scheduler).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --kv-format int8 --requests 8 --slots 4 --seed 0 \\
        [--device cuda|cpu] [--full] [--layers N] [--admission chunked|eager] \\
        [--chunk-budget 16] \\
        [--kv-layout slot|paged] [--page-size 8] [--shared-prefix 16] \\
        [--bgpp-rounds 4] [--bgpp-keep-ratio 0.25] \\
        [--weight-format bf16|int8|bstc] \\
        [--spec-decode] [--draft-gamma 4] [--draft-planes 4] \\
        [--server] [--disconnect-every 3] [--disconnect-after 1] [--trace-out trace.json] \
        [--mesh D,M | --data D --model M]

    torchrun --nproc-per-node D*M -m repro_torch.launch.serve --mesh D,M ...

The counterpart of ``repro.launch.serve``.  ``--mesh D,M`` serves on a
``(data, model)`` mesh of ``D * M`` ranks (:mod:`repro_torch.serving.sharded`:
the dense, MoE and VLM families, as the reference's driver takes them; the
ssm, hybrid and enc_dec families are refused here as on one device, since
they decode through ``make_serve_step`` on a mesh), one process a rank:
under
``torchrun`` the world comes
from its environment, NCCL on the card (each rank on the card of its
``LOCAL_RANK``) and gloo with ``--device cpu``; run without ``torchrun``,
``--mesh 1,1`` starts a world of one.  Every rank serves the same trace;
rank 0 prints, with a ``[serve] mesh DxM`` line of the reference's mesh
columns, and the JSON gains ``mesh``.  ``--server`` takes no mesh.
``--arch`` takes every registered
architecture; the dense ones serve (phi4-mini, gemma3-1b / 4b with their
sliding-window rings, deepseek-7b with its untied head), and so do the MoE
ones (mixtral-8x22b: 8 experts top-2, every layer a sliding-window ring;
llama4-scout-17b-a16e: 16 experts top-1 and a shared expert, chunked-local
rings 3:1 with global layers), and so does the VLM paligemma-3b, text
prompts only, through chunked admission as the reference's Scheduler serves
it (its image prefix enters only through ``engine.prefill`` /
``prefill_into_slot``, so ``--admission eager`` raises for it); the others
are refused with an error that names their family (mamba2-1.3b,
jamba-1.5-large-398b and whisper-medium, which the reference's launcher
refuses too, decode through ``engine.make_serve_step`` alone).  ``--full`` at
paligemma-3b is the whole model (2.5 B parameters) on one card.  It runs on ``--device cuda`` unless told otherwise;
``--full`` serves the published full-width config instead of the smoke
one, and ``--layers`` cuts its depth (a full MoE config does not fit one
card: mixtral-8x22b is 141 B parameters, llama4-scout 108 B).  Weights are
random, drawn from a seeded generator on the device.  Requests arrive on a Poisson-ish trace.  With the default
``--admission chunked`` prompts go through bucketed prefill chunks
interleaved with the batched decode step; ``--admission eager`` admits
each prompt with one whole-sequence forward (the ``flash_attention``
kernel on the card) as the reference's baseline.
``--weight-format`` puts the decode projections on the serve-time weight
path (``repro_torch.serving.weights``): int8 records, or bstc-coded planes
that the ``bstc_matmul`` kernel reads on the card; the ``weight_read``
line prints the weight bytes a decode step reads.  ``--spec-decode`` turns
on bit-plane speculative decoding (``repro_torch.serving.spec_decode``): a
``--draft-planes``-truncated copy of the serve weights drafts
``--draft-gamma`` tokens a slot a round, a batched verify chain accepts or
rolls back, and the report gains the acceptance lines; the generated
tokens stay those of the non-speculative run.

``--server`` routes the same trace through the asyncio front door
(``repro_torch.serving.server``) with simulated clients instead of the
offline replay loop: tiers rotate interactive/batch (interactive preempts
batch chunked prefills), and every ``--disconnect-every``-th client hangs
up after ``--disconnect-after`` streamed tokens — a mid-flight
cancellation that must evict the slot and free its pages.  The printed
stats grow cancellation / preemption / per-tier TTFT+ITL lines, and the
per-step ``PageAllocator.check()`` leak gate runs throughout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import (ARCH_REGISTRY, WEIGHT_FORMATS, apply_bgpp_overrides,
                                 apply_spec_decode_overrides, apply_weight_format_override,
                                 get_config, require_transformer)
from repro_torch.launch import mesh
from repro_torch.models import model_zoo
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.request import poisson_trace
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.server import simulate_clients


def main(argv=None):
    """Parse the flags, serve the trace, print the ``[serve]`` lines;
    returns the run's stats."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCH_REGISTRY), default="phi4-mini-3.8b")
    ap.add_argument("--full", action="store_true",
                    help="serve the published full-width config (default: smoke)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth to this many layers (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda raises without a card)")
    ap.add_argument("--kv-format", default="int8", choices=["bf16", "int8", "bgpp"])
    ap.add_argument("--kv-layout", default="slot", choices=["slot", "paged"])
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens to every "
                         "request (exercises paged prefix reuse)")
    ap.add_argument("--bgpp-rounds", type=int, default=None)
    ap.add_argument("--bgpp-keep-ratio", type=float, default=None)
    ap.add_argument("--weight-format", default=None, choices=sorted(WEIGHT_FORMATS),
                    help="serve-time weight numerics of the decode projections: "
                         "bf16 (raw leaves), int8 or bstc (two-state coded planes "
                         "read by the bstc_matmul kernel) (default: the config's)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="bit-plane speculative decoding: truncated-plane draft weights "
                         "propose --draft-gamma tokens a slot a round, verified and rolled "
                         "back in one batched chain (identical output)")
    ap.add_argument("--draft-gamma", type=int, default=None,
                    help="draft tokens a slot a speculative round (default: the config's, 4)")
    ap.add_argument("--draft-planes", type=int, default=None,
                    help="MSB magnitude bit planes kept in the draft weights, 1-8; >= 7 "
                         "keeps every bit (default: the config's, 4)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-prompt", type=int, default=23)
    ap.add_argument("--admission", default="chunked", choices=["chunked", "eager"],
                    help="chunked: bucketed prefill interleaved with decode; eager: "
                         "whole-prompt B=1 admission")
    ap.add_argument("--chunk-budget", type=int, default=16,
                    help="max prefill tokens between consecutive batched decode "
                         "steps (chunked admission)")
    ap.add_argument("--arrival-rate", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0, help="request-trace RNG seed")
    ap.add_argument("--server", action="store_true",
                    help="drive the asyncio front door with simulated tiered streaming "
                         "clients (interactive/batch rotation, mid-stream disconnects) "
                         "instead of the offline replay loop")
    ap.add_argument("--disconnect-every", type=int, default=3,
                    help="--server: every Nth client disconnects mid-stream (0 disables)")
    ap.add_argument("--disconnect-after", type=int, default=1,
                    help="--server: disconnecting clients hang up after this many "
                         "streamed tokens")
    ap.add_argument("--trace-out", default=None)
    mesh.add_mesh_args(ap)
    args = ap.parse_args(argv)
    meshed = mesh.mesh_from_args(args)

    device = resolve_device(args.device)
    cfg = apply_bgpp_overrides(get_config(args.arch, smoke=not args.full),
                               rounds=args.bgpp_rounds, keep_ratio=args.bgpp_keep_ratio)
    cfg = apply_weight_format_override(cfg, args.weight_format)
    cfg = apply_spec_decode_overrides(cfg, enabled=args.spec_decode or None,
                                      gamma=args.draft_gamma, planes=args.draft_planes)
    require_transformer(cfg, "launch.serve")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    rules, started, out = None, False, print
    if meshed:
        import torch.distributed as dist

        device, rules, started = mesh.start_mesh(args.data, args.model, device)
        if dist.get_rank() != 0:
            out = lambda *a, **k: None  # noqa: E731 -- rank 0 reports
    gen = torch.Generator(device=device).manual_seed(0)
    params = model_zoo.init(cfg, gen, device)
    layout = kvc.layout_for(cfg, args.slots, args.max_seq, kv_format=args.kv_format,
                            layout=args.kv_layout, page_size=args.page_size)
    sched = Scheduler(params, cfg, layout, device=device, admission=args.admission,
                      chunk_budget=args.chunk_budget, rules=rules)
    max_prompt = min(args.max_prompt, args.max_seq - 2 - args.shared_prefix)
    if max_prompt < 1:
        raise SystemExit("--shared-prefix leaves no room for prompts")
    reqs = poisson_trace(np.random.default_rng(args.seed), args.requests, cfg.vocab_size,
                         args.max_new, args.arrival_rate, max_prompt=max_prompt,
                         shared_prefix=args.shared_prefix)
    t0 = time.perf_counter()
    if args.server:
        stats = simulate_clients(sched, reqs, disconnect_every=args.disconnect_every,
                                 disconnect_after=args.disconnect_after)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        stats["wall_s"] = round(dt, 3)
        stats["tokens_per_s"] = round(stats["decoded_tokens"] / dt, 2) if dt > 0 else None
    else:
        for req in reqs:
            sched.submit(req)
        done = 0
        while sched.num_pending:
            sched.step()
            if len(sched.finished) != done:
                done = len(sched.finished)
                out(f"[serve] {done}/{args.requests} requests "
                      f"({sched.decoded_tokens} tokens, step {sched.step_count})")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        stats = sched.stats(dt)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU")
    out(f"[serve] arch={cfg.name} kv={args.kv_format} layout={args.kv_layout} "
          f"weights={sched.weight_format} admission={args.admission} "
          f"device={where}: {stats['finished_requests']} requests, "
          f"{stats['decoded_tokens']} tokens in {dt:.1f}s "
          f"({stats['tokens_per_s']:.1f} tok/s, mean occupancy "
          f"{stats['mean_occupancy']:.2f})")
    out(f"[serve] ttft_s p50={stats['ttft_s']['p50']} p95={stats['ttft_s']['p95']}  "
          f"itl_s p50={stats['itl_s']['p50']} p95={stats['itl_s']['p95']}  "
          f"max prefill tokens/step={stats['max_prefill_tokens_per_step']}")
    if args.server:
        pages = (f" pages_in_use={stats['paged']['pages_in_use']}" if "paged" in stats else "")
        out(f"[serve] server: cancelled={stats['cancelled_requests']} "
              f"shed={stats['shed_requests']} preemptions={stats['preemptions']} "
              f"disconnects={sum(c['disconnected'] for c in stats['clients'])}{pages}")
        for tier, t in stats["tiers"].items():
            out(f"[serve] tier {tier}: finished={t['finished']} cancelled={t['cancelled']} "
                  f"shed={t['shed']} preemptions={t['preemptions']} "
                  f"ttft_s p50={t['ttft_s']['p50']} itl_s p50={t['itl_s']['p50']} "
                  f"p95={t['itl_s']['p95']}")
    kv = stats["kv_read"]
    out(f"[serve] kv read: {kv['decode_bytes']/1e6:.2f} MB decode + "
          f"{kv['prefill_bytes']/1e6:.2f} MB prefill; "
          f"{kv['decode_bytes_per_step']/1e3:.1f} kB/decode-step "
          f"(bf16-equivalent {kv['decode_bf16_equiv_bytes_per_step']/1e3:.1f} kB, "
          f"{kv['decode_bytes_reduction_vs_bf16']}x reduction)")
    out(f"[serve] mesh {kv['mesh']['data']}x{kv['mesh']['model']} "
        f"({kv['kv_shards']} kv shards): "
        f"{kv['decode_bytes_per_device_per_step']/1e3:.1f} kB/device/step, "
        f"interconnect {kv['interconnect_bytes_per_step']/1e3:.2f} kB/step "
        f"({kv['interconnect_bytes']/1e6:.2f} MB total: attend all-gather "
        f"{kv['interconnect']['attend_allgather']/1e3:.2f} kB/step + paged "
        f"write bcast {kv['interconnect']['paged_write_bcast']/1e3:.2f})")
    if "spec" in stats:
        sp = stats["spec"]
        out(f"[serve] spec decode (gamma={sp['gamma']}, planes={sp['draft_planes']}, "
              f"source={sp['draft_source']}): "
              f"accepted/step={sp['accepted_tokens_per_step']:.3f} "
              f"({sp['accepted_tokens']} tokens, {sp['rounds']} rounds, "
              f"{sp['accepted_tokens_per_round']:.2f}/round, draft hit rate "
              f"{sp['draft_hit_rate']:.2f})")
        out(f"[serve] spec bytes/accepted-token: "
              f"kv {sp['kv_bytes_per_accepted_token']/1e3:.1f} kB, "
              f"weight {sp['weight_bytes_per_accepted_token']/1e3:.1f} kB "
              f"(modeled bit-plane draft "
              f"{sp['modeled_weight_bytes_per_accepted_token']/1e3:.1f} kB)")
    if "bgpp" in kv:
        bg = kv["bgpp"]
        out(f"[serve] bgpp two-phase: {bg['rounds']} rounds, "
              f"{bg['full_rows_per_slot']} full-precision rows per (slot, layer) per "
              f"step; per-step bytes = sign {bg['sign_bytes']/1e3:.1f} kB + planes "
              f"{bg['plane_bytes']/1e3:.1f} kB + top-k full "
              f"{bg['topk_full_bytes']/1e3:.1f} kB")
    wr = stats["weight_read"]
    out(f"[serve] weight read ({wr['weight_format']}): "
          f"{wr['decode_bytes']/1e6:.2f} MB decode + {wr['prefill_bytes']/1e6:.2f} MB "
          f"prefill; {wr['decode_bytes_per_step']/1e3:.1f} kB/decode-step "
          f"(bf16-equivalent {wr['decode_bf16_equiv_bytes_per_step']/1e3:.1f} kB, "
          f"{wr['decode_bytes_reduction_vs_bf16']}x reduction, measured/modeled "
          f"{wr['measured_over_modeled']})")
    if "paged" in stats:
        pg = stats["paged"]
        out(f"[serve] paged: prefix hit rate {pg['prefix_hit_rate']:.3f} "
              f"({pg['prefix_hit_tokens']} tokens over {pg['prefix_hits']} hits), "
              f"resident KV peak {pg['resident_kv_bytes_peak']/1e3:.1f} kB vs "
              f"{pg['slot_resident_kv_bytes']/1e3:.1f} kB slot-dense, "
              f"pages_in_use={pg['pages_in_use']}")
    if args.trace_out and out is print:
        stats["config"] = {k: v for k, v in vars(args).items() if k != "trace_out"}
        stats["config"]["mesh"] = [args.data, args.model]
        with open(args.trace_out, "w") as f:
            json.dump(stats, f, indent=2)
        out(f"[serve] trace -> {args.trace_out}")
    mesh.stop_mesh(started)
    return stats


if __name__ == "__main__":
    main()
