"""End-to-end serving demo: batched requests through the continuous-batching
scheduler (chunked prefill admission + per-slot decode with int8 or
bit-planar BGPP KV cache).

    PYTHONPATH=src python -m repro_torch.examples.serve_llm [--arch phi4-mini-3.8b]
        [--device cuda|cpu] [--full]
        [--kv-format int8|bf16|bgpp] [--admission chunked|eager]
        [--kv-layout slot|paged] [--page-size 8] [--shared-prefix 16]
        [--weight-format bf16|int8|bstc] [--server]
        [--spec-decode] [--draft-gamma 4] [--draft-planes 4]
        [--chunk-budget 8] [--steps 24] [--batch 4] [--mesh D,M | --data D --model M]

The port's counterpart of ``examples/serve_llm.py``.  ``--mesh D,M``
serves on a ``(data, model)`` mesh, one process a rank, as
:mod:`repro_torch.launch.serve` does (``torchrun --nproc-per-node D*M``;
``--mesh 1,1`` alone starts a world of one; rank 0 prints).
It runs on ``--device cuda`` unless told otherwise; ``--full`` serves the
published full-width config instead of the smoke one (random weights from
a seeded generator on the device).

``--server`` swaps the offline replay for the asyncio front door
(``repro_torch.serving.server``) and showcases its three signature moves: a
two-turn chat session whose second turn adopts the first turn's pinned
KV pages through the sha1 prefix index (``--kv-layout paged``), an
interactive arrival preempting a batch prompt's chunked prefill, and a
client that disconnects mid-stream (slot evicted, pages freed, nobody
else perturbed).

Each request is admitted into its own slot of ONE live cache — by default
through fixed-shape prefill chunks (``engine.ChunkedPrefill``) interleaved
with decode, so slots already decoding never stall behind a long prompt —
and all live slots decode together in a single batched ``serve_step`` per
token (the ``paged_flash_decode`` / ``bgpp_paged_attend`` kernels on the
card).
"""

from __future__ import annotations

import argparse
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
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Scheduler


def run_server_demo(sched, cfg, rng):
    """Drive the asyncio front door end to end: a two-turn chat session
    (turn 2 adopts turn 1's pinned pages on paged layouts), an interactive
    turn preempting a batch prompt's chunked prefill, and a mid-stream
    client disconnect — with the per-step page-leak gate armed.  Returns
    the server's stats."""
    import asyncio

    from repro_torch.serving.server import AsyncServer

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)

    async def collect(stream):
        return [t async for t in stream]

    async def demo():
        server = AsyncServer(sched, check_invariants=True)
        pump = asyncio.ensure_future(server.run())
        t1 = server.chat("demo", prompt(24), 6)
        print(f"[server] chat turn 1 -> {await collect(t1)}")
        # turn 2 races a batch client; the interactive tier preempts its
        # chunked prefill, then turn 2's prompt head comes from the index
        batch = server.submit(prompt(20), 6, priority="batch")
        t2 = server.chat("demo", prompt(8), 6, arrival_step=sched.step_count + 1)
        got2, gotb = await asyncio.gather(collect(t2), collect(batch))
        print(f"[server] chat turn 2 -> {got2} (adopted "
              f"{t2.request.prefix_reused_tokens} history tokens from the prefix index)")
        print(f"[server] batch client -> {gotb} "
              f"(prefill preempted {batch.request.preemptions}x)")
        gone = server.submit(prompt(12), 32)
        seen = []
        async for tok in gone:
            seen.append(tok)
            if len(seen) == 2:
                await gone.cancel()
                break
        print(f"[server] disconnecting client got {seen}, then hung up "
              f"(cancelled while {gone.request.cancel_state})")
        server.close_session("demo")
        await server.drain()
        server.close()
        await pump
        return server.stats()

    stats = asyncio.run(demo())
    print(f"[server] totals: finished={stats['finished_requests']} "
          f"cancelled={stats['cancelled_requests']} preemptions={stats['preemptions']}")
    for tier, t in stats["tiers"].items():
        print(f"[server] tier {tier}: finished={t['finished']} cancelled={t['cancelled']} "
              f"ttft_s p50={t['ttft_s']['p50']} itl_s p50={t['itl_s']['p50']}")
    if "paged" in stats:
        print(f"[server] paged: prefix hit rate {stats['paged']['prefix_hit_rate']:.3f}, "
              f"pages in use {stats['paged']['pages_in_use']} (pool drained)")
    return stats


def main(argv=None):
    """Parse the flags and serve; returns the run's stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b", choices=sorted(ARCH_REGISTRY))
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda raises without a card)")
    ap.add_argument("--full", action="store_true",
                    help="serve the published full-width config (default: smoke)")
    ap.add_argument("--kv-format", default="int8", choices=["bf16", "int8", "bgpp"])
    ap.add_argument("--kv-layout", default="slot", choices=["slot", "paged"])
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="shared system-prompt tokens prepended to every "
                         "request (paged layouts reuse their pages)")
    ap.add_argument("--admission", default="chunked", choices=["chunked", "eager"])
    ap.add_argument("--bgpp-rounds", type=int, default=None,
                    help="bgpp progressive rounds (default: config's)")
    ap.add_argument("--bgpp-keep-ratio", type=float, default=None,
                    help="fraction of keys the bgpp decode keeps at full "
                         "precision (default: config's)")
    ap.add_argument("--weight-format", default=None, choices=sorted(WEIGHT_FORMATS),
                    help="serve-time weight numerics for decode projections "
                         "(bf16 raw default; int8/bstc quantized records "
                         "with weight_read pricing) (default: config's)")
    ap.add_argument("--server", action="store_true",
                    help="demo the asyncio front door instead: two-turn "
                         "chat session (prefix-index reuse across turns), "
                         "priority preemption, and a mid-stream disconnect")
    ap.add_argument("--spec-decode", action="store_true",
                    help="bit-plane speculative decoding: truncated-plane "
                         "drafts + batched verify/rollback, identical "
                         "output with an accepted-tokens/step report")
    ap.add_argument("--draft-gamma", type=int, default=None,
                    help="draft tokens per slot per speculative round (default: config's)")
    ap.add_argument("--draft-planes", type=int, default=None,
                    help="MSB magnitude bit-planes kept in the draft "
                         "weights, 1-8 (default: config's)")
    ap.add_argument("--chunk-budget", type=int, default=8)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    mesh.add_mesh_args(ap)
    args = ap.parse_args(argv)
    meshed = mesh.mesh_from_args(args)

    device = resolve_device(args.device)
    cfg = apply_bgpp_overrides(get_config(args.arch, smoke=not args.full),
                               rounds=args.bgpp_rounds, keep_ratio=args.bgpp_keep_ratio)
    cfg = apply_weight_format_override(cfg, args.weight_format)
    cfg = apply_spec_decode_overrides(cfg, enabled=args.spec_decode or None,
                                      gamma=args.draft_gamma, planes=args.draft_planes)
    require_transformer(cfg, "examples.serve_llm")
    rules, started, out = None, False, print
    if meshed:
        import torch.distributed as dist

        device, rules, started = mesh.start_mesh(args.data, args.model, device)
        if dist.get_rank() != 0:
            out = lambda *a, **k: None  # noqa: E731 -- rank 0 reports
    rng = np.random.default_rng(0)
    params = model_zoo.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    max_seq = args.prompt_len + args.steps + 8

    layout = kvc.layout_for(cfg, args.batch, max_seq + args.shared_prefix,
                            kv_format=args.kv_format, layout=args.kv_layout,
                            page_size=args.page_size)
    sched = Scheduler(params, cfg, layout, device=device, admission=args.admission,
                      chunk_budget=args.chunk_budget, rules=rules)
    out(f"[serve] cache: {kvc.cache_bytes(sched.cache)/1e6:.2f} MB "
          f"({len(layout.global_layers)} global / {len(layout.local_layers)} local layers) "
          f"on {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'CPU'}")

    if args.server:
        return run_server_demo(sched, cfg, rng)

    # batched "requests": random prompts of varying length (no tokenizer);
    # +1 because admission itself samples the first token.
    # --shared-prefix prepends one common "system prompt" to all of them and
    # staggers arrivals — prefix reuse needs a resident donor, so a request
    # must arrive after another has prefilled the shared pages.
    prefix = rng.integers(0, cfg.vocab_size, (args.shared_prefix,)).astype(np.int32)
    for rid in range(args.batch):
        plen = max(4, args.prompt_len - 3 * rid)
        sched.submit(Request(
            rid=rid,
            prompt=np.concatenate([prefix, rng.integers(0, cfg.vocab_size, (plen,))
                                   .astype(np.int32)]),
            max_new_tokens=args.steps + 1,
            arrival_step=(args.shared_prefix // 2) * rid,
        ))

    t0 = time.perf_counter()
    sched.run(max_steps=10_000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    stats = sched.stats(dt)
    out(f"[serve] arch={cfg.name} kv={args.kv_format} admission={args.admission}: "
          f"decoded {stats['decoded_tokens']} tokens across {args.batch} seqs in "
          f"{dt*1e3:.1f} ms ({stats['tokens_per_s']:.1f} tok/s, "
          f"occupancy {stats['mean_occupancy']:.2f})")
    out(f"[serve] ttft_s p50={stats['ttft_s']['p50']} p95={stats['ttft_s']['p95']}  "
          f"itl_s p50={stats['itl_s']['p50']} p95={stats['itl_s']['p95']}  "
          f"max prefill tokens/step={stats['max_prefill_tokens_per_step']}")
    kv = stats["kv_read"]
    out(f"[serve] kv read/decode-step: {kv['decode_bytes_per_step']/1e3:.1f} kB vs "
          f"{kv['decode_bf16_equiv_bytes_per_step']/1e3:.1f} kB bf16-equivalent "
          f"({kv['decode_bytes_reduction_vs_bf16']}x); bgpp full rows/slot/layer: "
          f"{kv.get('bgpp', {}).get('full_rows_per_slot', '-')}")
    wr = stats["weight_read"]
    out(f"[serve] weight read/decode-step ({wr['weight_format']}): "
          f"{wr['decode_bytes_per_step']/1e3:.1f} kB vs "
          f"{wr['decode_bf16_equiv_bytes_per_step']/1e3:.1f} kB bf16-equivalent "
          f"({wr['decode_bytes_reduction_vs_bf16']}x, measured/modeled "
          f"{wr['measured_over_modeled']})")
    if "spec" in stats:
        sp = stats["spec"]
        out(f"[serve] spec decode (gamma={sp['gamma']}, planes={sp['draft_planes']}): "
              f"accepted/step={sp['accepted_tokens_per_step']:.3f}, "
              f"{sp['accepted_tokens_per_round']:.2f} accepted/round, "
              f"kv {sp['kv_bytes_per_accepted_token']/1e3:.1f} kB and weight "
              f"{sp['weight_bytes_per_accepted_token']/1e3:.1f} kB per accepted token")
    if "paged" in stats:
        pg = stats["paged"]
        out(f"[serve] paged: prefix hit rate {pg['prefix_hit_rate']:.3f}, "
              f"resident KV peak {pg['resident_kv_bytes_peak']/1e3:.1f} kB "
              f"vs {pg['slot_resident_kv_bytes']/1e3:.1f} kB slot-dense, "
              f"pages_in_use={pg['pages_in_use']}")
    for req in sorted(sched.finished, key=lambda r: r.rid)[:2]:
        out(f"[serve] seq{req.rid}: {req.generated[:16]}...")
    if meshed:
        out(f"[serve] mesh {kv['mesh']['data']}x{kv['mesh']['model']} "
            f"({kv['kv_shards']} kv shards): {kv['decode_bytes_per_device_per_step']/1e3:.1f} "
            f"kB/device/step, interconnect {kv['interconnect_bytes_per_step']/1e3:.2f} kB/step")
    mesh.stop_mesh(started)
    return stats


if __name__ == "__main__":
    main()
