#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # one H100

Phases, each of which fails the run (nonzero exit) on any error:

1. Prints the card's name and power limit (``nvidia-smi``); exits 1 before
   anything else when ``torch.cuda.is_available()`` is false.
2. Builds the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, sm_90a)
   and prints the build seconds.
3. Kernel phase: runs every kernel of the serving decode path at the main
   path's shapes (Hk=8, g=3, D=128, S=1024, page 16, shuffled page tables
   with -1 pages) against its plain PyTorch version on the card, and times
   kernel, plain version and, where one exists, one library call.
4. Main path: serves phi4-mini-3.8b at full width and depth (bf16 weights
   from a seeded generator) through the port's ``Scheduler`` in the paged
   layout for each KV format, and checks that each format's kernel was
   launched once per layer per decode step; then traces a few steady
   decode steps with torch.profiler (device busy share, time by kernel).
5. Reference check: the same small model and trace served on the card
   (kernels) and on the CPU (plain versions) give the same greedy tokens
   and logits within tolerance.

The second-to-last lines are the kernels' JSON record and the card line;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stdout}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, flush=None) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, CUDA events
    around each launch; ``flush()`` (outside the timed span) evicts L2
    between launches so every launch reads cold, as on the main path."""
    import torch

    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def _shuffled_table(gen, B, pp, n_pages, pos, page, device):
    """Page table over a shuffled pool: pages past each slot's position are
    unmapped (-1), and one mapped page per slot is unmapped too."""
    import torch

    perm = torch.randperm(n_pages, generator=gen, device="cpu")[:B * pp].reshape(B, pp)
    table = perm.clone().to(torch.int32)
    for b in range(B):
        last = int(pos[b]) // page
        table[b, last + 1:] = -1
        if last >= 2:
            table[b, last // 2] = -1
    return table.to(device)


def check_rows(name, got, want, step=None):
    """Max |got - want|, failing the run unless every (b, h, g) row is
    within ``1e-5 * max(1, max|want row|)`` (f32 sums in another order)
    plus ``step``, the plain version's per-row bound on one flipped int8
    probability code (:func:`int8_code_step`); ``step`` None: no codes."""
    err = (got - want).abs().amax(-1)
    tol = 1e-5 * want.abs().amax(-1).clamp(min=1.0)
    if step is not None:
        tol = tol + step
    bad = err > tol
    if bool(bad.any()):
        at = bad.nonzero()[0].tolist()
        raise AssertionError(f"{name} disagrees at row {at}: {err[tuple(at)].item():.3e} "
                             f"> {tol[tuple(at)].item():.3e}")
    return err.max().item()


def kernel_phase(device, flush):
    """Hold every kernel against its plain version at the main path's
    shapes; return the kernels' JSON records (launches filled in later)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import bgpp_paged_attend as bgpp_ops
    from repro_torch.kernels import paged_flash_decode as pfd_ops
    from repro_torch.kernels.bgpp_paged_attend.ref import (
        bgpp_paged_attend_ref, rows_at, rows_per_head)
    from repro_torch.kernels.paged_flash_decode.ref import (
        int8_code_step, paged_flash_decode_ref)
    from repro_torch.serving import kv_cache as kvc

    cfg = get_config("phi4-mini-3.8b")
    B, Hk, D = 4, cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // cfg.num_kv_heads
    S, page = 1024, 16
    pp = S // page
    n_pages = B * pp
    n_tok = n_pages * page
    gen = torch.Generator(device="cpu").manual_seed(0)
    # page ends, a page start, and a context shorter than BGPP's k_max
    pos = torch.tensor([S - 1, 100, 20 * page - 1, 33 * page], dtype=torch.int32)
    table = _shuffled_table(gen, B, pp, n_pages, pos, page, device)
    pos = pos.to(device)
    n_valid = [min(int(p) + 1, S) for p in pos.cpu()]
    dg = torch.Generator(device=device).manual_seed(1)
    q = torch.randn((B, Hk, g, D), generator=dg, device=device)
    kf = torch.randn((n_tok, Hk, D), generator=dg, device=device)
    vf = torch.randn((n_tok, Hk, D), generator=dg, device=device)
    records = []

    def record(name, source, replaces, err, ms, plain_ms, nbytes, ops, kind, lib_ms):
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = ops / PEAK_OPS[kind] * 1e3
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=0,
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bound_b, bound_o),
            bound_by="bytes" if bound_b >= bound_o else "operations",
            library_ms=lib_ms,
        ))
        print(f"[kernel] {name}: max_abs_err={err:.3e} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {records[-1]['bound_ms']:.4f} ms "
              f"({records[-1]['bound_by']}), library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")

    io_bytes = q.numel() * 4 * 2 + table.numel() * 4 + B * 4  # q, out, table, pos
    # ---- K1 bf16 ------------------------------------------------------------
    k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    run = lambda: pfd_ops.paged_flash_decode(q, k, v, table, pos, page_size=page)
    plain = lambda: paged_flash_decode_ref(q, k, v, table, pos, page_size=page)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = check_rows("paged_flash_decode bf16", got, want)
    phys = kvc.phys_table(table, page, S)
    kv_view = lambda a: a[phys.long()].movedim(2, 1)  # (B, Hk, S, ...)
    kview, vview = kv_view(k), kv_view(v)
    valid = torch.arange(S, device=device)[None, :] <= pos[:, None]  # (B, S)
    mask = valid[:, None, None, :]
    qh = q.reshape(B, Hk * g, 1, D).to(torch.bfloat16)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kview, vview, attn_mask=mask, enable_gqa=True)
    rows = sum(n_valid) * Hk
    record("paged_flash_decode_bf16", "src/repro_torch/csrc/paged_flash_decode.cu",
           "src/repro/kernels/paged_flash_decode/kernel.py:65", err,
           time_ms(run, flush=flush), time_ms(plain, flush=flush),
           rows * 2 * D * 2 + io_bytes, rows * 4 * g * D, "bf16",
           time_ms(sdpa, flush=flush))
    # ---- K1 int8 ------------------------------------------------------------
    kq, ks = kvc.quantize_kv(kf)
    vq, vs = kvc.quantize_kv(vf)
    run = lambda: pfd_ops.paged_flash_decode(q, kq, vq, table, pos, page_size=page,
                                             k_scale=ks, v_scale=vs)
    plain = lambda: paged_flash_decode_ref(q, kq, vq, table, pos, page_size=page,
                                           k_scale=ks, v_scale=vs)
    got, want = run(), plain()
    torch.cuda.synchronize()
    step = int8_code_step(q[:, :, :, None], kv_view(kq), kv_view(ks), kv_view(vs),
                          valid[:, None, None, None, :])[..., 0]
    err = check_rows("paged_flash_decode int8", got, want, step)
    record("paged_flash_decode_int8", "src/repro_torch/csrc/paged_flash_decode.cu",
           "src/repro/kernels/paged_flash_decode/kernel.py:85", err,
           time_ms(run, flush=flush), time_ms(plain, flush=flush),
           rows * (2 * D + 8) + io_bytes, rows * 4 * g * D, "int8", None)
    # ---- K2 -----------------------------------------------------------------
    planes, sign = kvc.k_to_bitplanes(kq)
    rounds, k_max, surv = kvc.bgpp_decode_plan(S, cfg)
    phys32 = phys.to(torch.int32).contiguous()
    args = (q, planes, sign, ks, vq, vs, phys32, pos)
    run = lambda: bgpp_ops.bgpp_paged_attend(*args, rounds=rounds, k_max=k_max,
                                             survivors=surv)
    plain = lambda: bgpp_paged_attend_ref(*args, rounds=rounds, k_max=k_max,
                                          survivors=surv)
    got, idx = bgpp_ops.bgpp_paged_attend(*args, rounds=rounds, k_max=k_max,
                                          survivors=surv, return_indices=True)
    want, want_idx = bgpp_paged_attend_ref(*args, rounds=rounds, k_max=k_max,
                                           survivors=surv, return_indices=True)
    torch.cuda.synchronize()
    same = bool(torch.equal(idx, want_idx))
    print(f"[kernel] bgpp_paged_attend: survivor indices equal: {same}")
    if not same:
        bad = (idx != want_idx).nonzero()[:5].tolist()
        raise AssertionError(f"bgpp_paged_attend selected other lanes, e.g. {bad}")
    # the exact int8 attend over the survivors (planes rebuild kq exactly)
    surv_rows = rows_at(phys32.long(), want_idx.long())
    surv_at = lambda a: rows_per_head(a, surv_rows, False)  # (B, Hk, k_max, ...)
    idx_valid = want_idx <= pos[:, None, None]
    step = int8_code_step(q[:, :, :, None], surv_at(kq), surv_at(ks), surv_at(vs),
                          idx_valid[:, :, None, None, :])[..., 0]
    err = check_rows("bgpp_paged_attend", got, want, step)
    Dp = D // 8
    nbytes = io_bytes + B * S * 4  # + the phys map
    for nv in n_valid:
        kv_rows = min(k_max, nv)
        nbytes += Hk * (nv * 2 * Dp  # sign + MSB plane of every valid lane
                        + sum(min(s, nv) for s in surv[1:]) * Dp  # round planes
                        + kv_rows * ((kvc.NBITS - rounds) * Dp + 4 + D + 4))
    ops = sum(Hk * (nv * g * D * 2 + k_max * g * D * 4) for nv in n_valid)
    record("bgpp_paged_attend", "src/repro_torch/csrc/bgpp_paged_attend.cu",
           "src/repro/kernels/bgpp_paged_attend/kernel.py:80", err,
           time_ms(run, flush=flush), time_ms(plain, flush=flush),
           nbytes, ops, "int8", None)
    return records


# ---------------------------------------------------------------------------
# main path: full-width phi4-mini-3.8b behind the port's Scheduler
# ---------------------------------------------------------------------------

KERNEL_OF = {"bf16": "paged_flash_decode_bf16", "int8": "paged_flash_decode_int8",
             "bgpp": "bgpp_paged_attend"}


def trace(seed: int, n: int, vocab: int, lo: int, hi: int, new: int):
    """Poisson arrivals (mean gap 2 steps), prompts of lo..hi tokens."""
    import numpy as np

    from repro_torch.serving.request import Request

    rng = np.random.default_rng(seed)
    reqs, step = [], 0
    for rid in range(n):
        step += int(rng.exponential(2.0))
        prompt = rng.integers(0, vocab, (int(rng.integers(lo, hi + 1)),)).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=new, arrival_step=step))
    return reqs


def _timed(fn, spans):
    """Wrap ``fn`` so each call records a CUDA event pair into ``spans``."""
    import torch

    def wrapped(*a, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a, **kw)
        e1.record()
        spans.append((e0, e1))
        return out

    return wrapped


def profile_decode(sched, reqs, steps: int = 4):
    """Admit ``reqs`` until every slot decodes, then trace ``steps`` steady
    decode steps with ``torch.profiler``: print the device's busy share of
    the wall time and the device time by kernel (top 8).  Only device-side
    events count (a CPU op's row repeats its kernels' time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for r in reqs:
        sched.submit(r)
    for _ in range(64):
        if all(s.state.value == "decoding" for s in sched.slots):
            break
        sched.step()
    else:
        raise AssertionError("profile_decode: the slots never all decoded")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    t = lambda e: e.self_device_time_total
    busy = sum(t(e) for e in dev)
    print(f"[profile] {steps} steady decode steps: device busy {busy / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms wall ({100 * busy / wall_us:.1f}%; the tracer's "
          f"own host cost lengthens the wall)")
    for e in sorted(dev, key=t, reverse=True)[:8]:
        print(f"[profile]   {t(e) / 1e3:8.3f} ms {100 * t(e) / busy:5.1f}% {e.count:5d} "
              f"calls  {e.key[:80]}")


def serve_phase(device, card):
    """Serve the full model in the paged layout for every KV format;
    return the launches each kernel made on its format's run."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("phi4-mini-3.8b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    nparam = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{nparam / 1e9:.3f} B params ({cfg.dtype}) initialised on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    launches = {}
    for fmt in ("bf16", "int8", "bgpp"):
        layout = kvc.layout_for(cfg, 4, 1024, kv_format=fmt, layout="paged", page_size=16)
        sched = Scheduler(params, cfg, layout, device=device, chunk_budget=128,
                          record_logits=True)
        dec, pre = [], []
        sched.serve_step = _timed(sched.serve_step, dec)
        sched.chunked._chunk = _timed(sched.chunked._chunk, pre)
        reqs = trace(0, 6, cfg.vocab_size, 64, 512, 16)
        for r in reqs:
            sched.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        stats = sched.run()
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        want = cfg.num_layers * sched.decode_steps
        for name, n in got.items():
            expect = want if name == KERNEL_OF[fmt] else 0
            if n != expect:
                raise AssertionError(f"{fmt}: {name} launched {n} times, expected {expect}")
        launches[KERNEL_OF[fmt]] = got[KERNEL_OF[fmt]]
        if stats["finished_requests"] != len(reqs):
            raise AssertionError(f"{fmt}: {stats['finished_requests']} of {len(reqs)} finished")
        for r in sched.finished:
            rows = np.stack(r.logit_rows)
            if (len(r.generated) != r.max_new_tokens or rows.shape != (16, cfg.vocab_size)
                    or not np.isfinite(rows).all()):
                raise AssertionError(f"{fmt}: request {r.rid} output is malformed")
        dec_ms = [a.elapsed_time(b) for a, b in dec]
        pre_ms = [a.elapsed_time(b) for a, b in pre]
        kv = stats["kv_read"]
        print(f"[serve] {fmt} paged: {stats['finished_requests']} requests, "
              f"{stats['decoded_tokens']} tokens, {sched.decode_steps} decode steps, "
              f"{len(pre_ms)} prefill chunks in {stats['wall_s']} s = "
              f"{stats['tokens_per_s']} tok/s; decode {np.mean(dec_ms):.3f} ms/step, "
              f"prefill {np.mean(pre_ms):.3f} ms/chunk; kv_read "
              f"{kv['decode_bytes_per_step']} B/step; ttft p50 "
              f"{stats['ttft_s']['p50']} s, itl p50 {stats['itl_s']['p50']} s; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{KERNEL_OF[fmt]} launches {got[KERNEL_OF[fmt]]} = {cfg.num_layers} "
              f"layers x {sched.decode_steps} steps [{card}]")
        profile_decode(sched, trace(1, 4, cfg.vocab_size, 200, 256, 24))
        del sched
    del params
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# reference check: the card's kernels against the CPU's plain versions
# ---------------------------------------------------------------------------


def reference_phase(device):
    """Serve the smoke config (f32) on the card and on the CPU from the same
    parameters and trace, in every layout x format cell.  bf16: the same
    greedy tokens and logits within 1e-4 (f32 sums in another order).
    int8/bgpp: teacher-forced with the CPU's tokens, logits within 2e-3 (a
    probability code may flip by one at a .5 boundary)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("phi4-mini-3.8b", smoke=True)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = {"embed": cpu["embed"].to(device),
           "layers": {k: {n: t.to(device) for n, t in v.items()}
                      for k, v in cpu["layers"].items()},
           "final_norm": {"scale": cpu["final_norm"]["scale"].to(device)}}

    def serve(params, dev, layout, forced=None):
        sched = Scheduler(params, cfg, layout, device=dev, chunk_budget=8,
                          record_logits=True)
        for r in trace(1, 4, cfg.vocab_size, 5, 30, 6):
            if forced is not None:
                r.forced_tokens = np.asarray(forced[r.rid])
            sched.submit(r)
        sched.run()
        return {r.rid: r for r in sched.finished}

    for lay in ("slot", "paged"):
        for fmt in ("bf16", "int8", "bgpp"):
            layout = kvc.layout_for(cfg, 2, 64, kv_format=fmt, layout=lay, page_size=8)
            ref = serve(cpu, "cpu", layout)
            forced = None if fmt == "bf16" else {i: r.generated for i, r in ref.items()}
            got = serve(gpu, device, layout, forced)
            same = all(got[i].generated == ref[i].generated for i in ref)
            err = max(float(np.abs(np.stack(got[i].logit_rows)
                                   - np.stack(ref[i].logit_rows)).max()) for i in ref)
            tol = 1e-4 if fmt == "bf16" else 2e-3
            print(f"[check] {lay} {fmt}: tokens equal {same}, max |logit diff| "
                  f"{err:.3e} (tolerance {tol})")
            if not same or not err <= tol:
                raise AssertionError(f"{lay} {fmt}: card and CPU disagree")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}")

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")

    device = torch.device("cuda")
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    records = kernel_phase(device, flush=lambda: l2.zero_())
    del l2

    launches = serve_phase(device, card)
    for r in records:
        r["launches"] = launches[r["name"]]
    reference_phase(device)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
