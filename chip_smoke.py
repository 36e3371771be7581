#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # one H100

Phases, each of which fails the run (nonzero exit) on any error:

1. Prints the card's name and power limit (``nvidia-smi``); exits 1 before
   anything else when ``torch.cuda.is_available()`` is false.
2. Builds the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, sm_90a)
   and prints the build seconds.
3. Kernel phase: runs every kernel of the serving paths at the main
   paths' shapes against its plain PyTorch version on the card, and times
   kernel, plain version and, where one exists, library calls: the decode
   attends (Hk=8, g=3, D=128, S=1024, page 16, shuffled page tables with
   -1 pages; K1 and K2 also at B 1, S 32768, timed, and with every
   position in the first block's lanes and one at -1 (K2: one below its
   k_max), each launched twice and required to give identical bits, K2
   with and without its survivor indices asked for), the fused BSTC
   decode + GEMV at every full-width projection shape with N = 4 columns
   (at wq/wo also N 1, 8 and 13, f32, bf16 and row-major x; and once coded
   with one tile a row; every case launched twice for identical bits), the
   BSTC plane decode on every coded plane of a 3072 x 3072 (wq), a
   3072 x 8192 (down) and an 8192 x 3072 (gate/up) matrix coded with one
   tile a row, as the serve path's round-trip check codes them (each plane
   launched twice, bit-identical; timed beside ``masked_scatter_``), and the
   forward's flash attention
   (Hq 24, Hk 8, D 128, bf16: causal at B 1 / S 512, 450 and 301 and
   B 4 / S 512; sliding and chunked with window 256; full; q_offset 256;
   bf16 at D 64, 32 and 16 with ragged tails; f32 once; the first case
   launched twice for identical bits), at whisper-medium's heads (Hq 16,
   Hk 16, D 64, bf16, full: its encoder's B 4 over 1500 frames and its
   forward's cross-attention, 128 queries over 1500 memory rows; timed,
   with records naming their case), and at llama4-scout's heads (Hq 40,
   Hk 8, D 128, bf16) over S 8448 with its chunked mask of 8192 (the
   queries past 8192 attend only their own chunk; the plain version a
   block of query rows at a time).  The head-width phase: K1 (bf16
   and int8), K2 and K5 at the heads of gemma3-1b (Hq 4, Hk 1),
   gemma3-4b (Hq 8, Hk 4) and paligemma-3b (Hq 8, Hk 1) at D 256, of
   deepseek-7b (g 1) and llama4-scout (Hq 40, Hk 8: g 5) at D 128, of
   whisper-medium (Hq 16, Hk 16: g 1) at D 64, and of
   the gemma3-1b smoke config at D 24 (run at the compiled width 32), the
   decode attends at pages 16 and 6 over S 1024, K5 causal and with
   gemma3's sliding window of 512 at B 1, S 512 (bf16, and f32 causal);
   the D 256 and whisper-medium cases at page 16 timed, with records
   naming their case.
   The long-context phase: K2 at the reference's decode_32k (S 32768)
   at the heads of gemma3-1b (g 4, D 256), llama4-scout (g 5, D 128),
   paligemma-3b (g 8, D 256) and whisper-medium (g 1, D 64), where its
   lists go to a global workspace, K1's bf16 and int8 bodies there at
   whisper-medium's heads,
   and K1's bf16 and int8 bodies at long_500k (S 524,288) at the heads of
   gemma3-4b, gemma3-1b and llama4-scout, where each block walks its
   lanes in passes, and K2 at long_500k at the same heads, its selection
   spanning blocks (and once at D 24 over 40,000 lanes, unmet by any
   compiled width: run at 128); each with a second slot ending inside K2's first
   block or K1's first pass, twice bit-identical (K2: survivor indices
   equal), timed with records naming their case.  K5's prefix_causal
   kind (the VLM's mask) at paligemma-3b's heads (Hq 8, Hk 1, D 256) over
   S 556 with its 256-patch prefix (timed beside
   ``scaled_dot_product_attention`` with the same boolean mask), and
   prefixes 100, 0 and past S, a query offset and f32, twice
   bit-identical.
   Then the paper layer's two kernels: the BGPP round at S 4096 (one
   query), at the decode geometry (B 4 x Hq 24 over Hk 8, S 1024) and at
   S 32768, alive masks from a real first round, bit-exact and launched
   twice; the BRCR GEMM at every projection shape of
   one layer (layer 0's seeded weights,
   int8) with N = 4 and 128 integer x (exact) and float32 / bfloat16 x
   (within 1e-5 of Σ|w·x|), the gate/up weight once more with whole
   row and column blocks zeroed, so its tile and plane skips run (exact,
   and faster than the whole weight), m 2 at wk/wv, a ragged 1028 x 3000
   slice at N 13, and integers of 17 to 20 bits on a sparse weight
   (exact only with all three bf16 terms of x); every K7 case launched
   twice for identical bits.  K3 is also held to its plain version at
   every decode projection shape of gemma3-4b (wq 2560 x 2048, wo, wk/wv,
   gate/up 2560 x 10240, down, the 2560 x 262144 head) and of
   llama4-scout (wq/wo 5120 x 5120, wk/wv 5120 x 1024, the 5120 x 202048
   head; its experts stay raw), f32 and bf16 x.  The shard phase: for
   every rank of the (data, model) meshes 2x1, 1x4 and 2x4, one after
   another, K1 (bf16, int8) and K2 on the rank's slots and kv heads at the
   decode geometry and K3 on phi4-mini's wq and lm_head cut into 4 column
   shards (each coded as its own matrix), each bit-equal to its slice of
   the whole launch when planned at the whole launch's geometry; the same
   launches planned at their own shapes, and cuBLAS on a column shard
   against the whole product's columns, printed as findings.
4. Paper-layer path: the quickstart at phi4-mini width (BRCR on an
   8192 x 3072 weight, BSTC, BGPP over 1024 keys), the BGPP walkthrough at
   S 4096, and the batched predictor at the decode geometry followed by
   ``alive_to_topk_indices`` and ``gather_attend``; launch counts asserted
   per run (K7 once per ``brcr_matmul``, K6 once a round, the rest 0),
   then K7 timed on the quickstart's operands.
5. Main paths: serves phi4-mini-3.8b at full width and depth (bf16 weights
   from a seeded generator) through the port's ``Scheduler`` in the paged
   layout, once per KV format with bf16 weights, once with
   ``weight_format="bstc"`` and BGPP KV (all with chunked admission), and
   once with ``admission="eager"`` and bf16 KV (one whole-prompt forward a
   request, flash attention in every layer); each run checks that its
   kernels were launched exactly as often as the path needs (every count
   zeroed just before the Scheduler is built, read just after the run).
   Then the same trace through a sharded Scheduler (``rules_for(1, 1)``
   over an NCCL world of one: every layer's collectives run) in bf16
   paged, int8 slot, bgpp paged and bgpp paged with bstc weights, each
   with the same launch checks and its tokens and logits bit-identical to
   the unsharded run of its formats; where the machine has two or more
   cards, the (1, n) mesh through ``torchrun`` (else printed as not run).
   Then two speculative runs of the same trace (bit-plane drafts, gamma 4,
   4 kept planes): bf16 KV with bf16 weights and bgpp KV with bstc weights,
   each holding its greedy tokens to the matching run above, leaking no
   page and launching K1 or K2 L times and K3 7L + 1 times a draft or
   verify step and K4 once per coded plane of both weight sets' first
   matrices.  Then the asyncio front door (``serving/server.py``) over the
   same model, layout and trace: ``simulate_clients`` in bf16 and bgpp KV
   (tiers alternating, every third client hanging up after 4 tokens,
   ``pager.check()`` after every pumped step), holding survivors' streams
   to the offline run's tokens and logits, the disconnected clients' to
   its first tokens, 2 cancels, 0 pages after ``close`` and K1 / K2 once
   per global layer a decode step; a two-turn chat session whose second
   turn adopts the first's pinned pages, held to a fresh prefill of the
   whole prompt; and the TCP front door on 127.0.0.1 (one client reads
   its whole stream, one hangs up after 2 tokens and is cancelled
   server-side).  Then the dense model zoo at full width:
   gemma3-4b with its depth cut to 6 layers (5 local sliding-window rings
   of 1024 lanes, 1 global; D 256, qk-norm, sandwich norms, GeGLU; 4 slots,
   paged, max_seq 4096; its traces below too) serves 6 requests of
   1100-2000 prompt tokens in the same
   five runs, each with every request finished, no page leaked and the
   launch formulas exact (K1 or K2 once per global layer a decode step, K3
   7L + 1, K5 L an eager admission; the ring attends are plain PyTorch and
   launch nothing), and refuses a speculative Scheduler as the reference
   does; deepseek-7b (30 layers, 32/32 heads, an untied head) serves 3
   requests once, chunked with bf16 KV.  Then the MoE family at full
   width: llama4-scout-17b-a16e with its depth cut to 8 layers (0-2 and
   4-6 chunked-local rings of 1024 lanes, 3 and 7 global; 40/8 heads, 16
   experts of d_ff 8192 top-1 and a shared expert, the untied 202048-row
   head; 19.7 B params) serves 6 requests of 201-450 prompt tokens
   (max_seq 1024) chunked with bf16 KV, with bstc weights and bgpp KV, and
   eagerly, and mixtral-8x22b cut to 2 layers (both sliding-window rings:
   no global layer, no page pool; 8 experts top-2) serves 3 requests
   chunked with int8 KV, each run with the same checks (K3 once per
   converted matrix a step: 4L + 1, the experts staying raw).  Then the
   VLM family at full width and depth: paligemma-3b (18 global layers,
   8/1 heads of 256, GeGLU d_ff 16384, the tied 257216-row head; 2.509 B
   params) serves the main trace chunked with bf16, int8 and bgpp KV
   (the last with bstc weights: K3 7L + 1 = 127 launches a step), once
   with bgpp KV at max_seq 32768 on two prompts of 12,000-16,000 tokens
   (K2 with its lists in the workspace), and runs one eager admission
   behind a 256 x 1152 patch prefix (K5 18 launches, prefix_causal)
   followed by 8 decode steps (K1 18 a step), printing the reference's
   ``pos`` convention (the text length).  Then gemma3-1b at full width and
   depth served through the Scheduler at max_seq 524,288 with bgpp KV, one
   slot (K2 over the whole row, its selection spanning blocks, 4 launches a
   step), and the ssm family: mamba2-1.3b at full width, cut to 16 of its
   48 layers (bf16, seed 0) decoding four prompts of 64-256 tokens a token a step from a
   zero state and 16 greedy tokens (4 slots; ms a step, traced), then the
   same decode through ``make_serve_step`` on a 1x1 NCCL mesh (the mixers
   split by heads: tokens and every step's logits bit-identical, ms a step
   and collectives a step), its
   forward timed at B 1, S 2048, the forward at chunk 64 held to the
   decode on an f32 copy of the weights, and its long_500k cache (the same
   bytes as a short one's, 16 steps).  Then the hybrid family:
   jamba-1.5-large-398b at full width (d_model 8192, 64/8 heads of 128,
   d_ff 24576, 128 mamba heads of 128, state 128, bf16, seed 0) cut to
   one super-block (8 layers: 7 mamba, attention at layer 4, MoE at the
   odd layers) and 8 of its 16 experts, top-2 kept (25.81 B params),
   decoding four prompts of 48-80 tokens a token a step from a zero state
   and 16 greedy tokens in bf16, int8 and bgpp KV (paged, page 16; K1 or
   K2 once a step and nothing else; ms a step, mamba state bytes, traced;
   bf16 and bgpp again on a 1x1 NCCL mesh, bit-identical with the same
   launches),
   its forward timed at B 1, S 2048 (K5 once), the forward's logits at
   each prompt's last position beside the bf16 decode's (printed), the
   forward against the decode at every prompt position on f32 weights with
   2 experts (within 1e-3 of max |logit|), and
   jamba-smoke (f32) on the card against the CPU: the forward, 24 decode
   steps of 2 slots in every KV format and layout, the forward against the
   token-by-token decode, and one remat train step (K5 twice, K5b once;
   with K5b's launch skipped it must fail the grad bound).  Then the
   enc_dec family:
   whisper-medium at full width and depth (24 encoder + 24 decoder layers,
   16/16 heads of 64, bf16, seed 0) as the reference serves it, outside
   the Scheduler: the encoder once over 4 x 1500 seeded frames (K5 full,
   24 launches), its memory projected into the cache's cross K / V, then
   4 slots fed prompts of 64-128 tokens a token a step from position 0 and
   16 greedy tokens, in bf16, int8 and bgpp KV paged and bf16 KV in the
   slot layout (K1 / K2 24 launches a step); 4 steps from the bf16 run's
   cache held to the same steps on the CPU (tokens equal, logits within
   1e-4 of max |logit|, a run with K1 blind to each slot's newest lane
   read beside it and required to fail that bound), and again on an f32
   copy with slot 0 reset so the slots decode at other positions; the
   decode_32k layout (max_seq 32768, B 2)
   in bgpp and int8 KV for 16 steps; the forward at B 1, S 128 (K5 72
   launches: full, causal and cross); the encoder and the bf16 and bgpp
   paged decodes again through ``make_serve_step`` on a 1x1 NCCL mesh
   (ROADMAP item 7c-ii (b): the encoder's memory and its cross K / V
   bit-identical, then tokens identical, every step's logits
   bit-identical and K1 / K2 24 launches a step as unsharded; ms a step,
   collectives a step and the encoder's ms for both); traces of the
   encoder and of bf16 and bgpp decode.  After
   every timed run, each of
   phi4-mini's chunked runs but int8 KV traces a few steady decode steps, and its
   eager one a whole-prompt admission, and gemma3-4b (6 layers) traces bf16
   and bgpp decode and one eager admission (K1, K2 and K5 device ms a launch at
   D 256), and llama4-scout traces bf16 decode (K1 at g 5, one MoE
   layer's decode timed alone), and paligemma-3b bf16 decode (K1 at g 8,
   D 256), with torch.profiler (device busy share,
   time by kernel), the flash attention kernel and ``scaled_dot_product_attention`` are traced at
   causal S 512 and S 450 for their device time a call, the fused BSTC
   decode + GEMV and a bf16 ``torch.matmul`` at every decode projection
   shape, the BSTC plane decode and ``masked_scatter_`` at its three
   matrices, the fused BGPP decode and K1's int8 body on the same int8 KV
   at the decode geometry, the BGPP round and a ``torch.matmul`` of the
   unpacked plane at its three shapes, and the BRCR GEMM and a bf16
   ``torch.matmul``
   on the quickstart's operands and at every projection shape of a layer
   (N 4, 16 and 128; f32 integer, f32 Gaussian and bf16 x).
   Training (after the whisper phase, before the traces): K5b
   (``flash_attention_bwd``, K5's gradient) against its plain version in
   every :data:`BWD_CASES` case (phase 3: phi4-mini's heads causal at
   B 1, S 4096, sliding 512, chunked 256, prefix_causal 100, a ragged
   S 301, a q_offset, D 24, gemma3-4b's, llama4-scout's and
   whisper-medium's heads with Sq 128 != Sk 1500, one f32 case; each
   launched twice for identical bits, K5's ``out`` bit-identical with and
   without ``lse`` and ``lse`` within 1e-5 of the plain version's, timed
   cases beside SDPA's forward plus backward); one train step of the
   smoke configs of phi4-mini, gemma3-4b, paligemma-3b and whisper-medium
   on the card against the CPU (loss within 1e-5 relative, every grad leaf
   within 1e-4 of its max |g|; phi4-mini-smoke again with K5b's launch
   skipped, which must fail that bound); phi4-mini-3.8b at full width and
   depth, B 1, S 4096, remat, 4 f32-AdamW steps on one repeated batch
   (loss falling, K5 64 and K5b 32 launches a step and nothing else) and
   2 with int8 moments, ms a step, tokens/s and peak memory printed, and
   one more f32 step traced (device busy share, kernels by group, the
   device time inside the AdamW update and the cross entropy); and
   the train launcher at phi4-mini width cut to 2 layers, int8 moments,
   S 4096: 6 steps checkpointing at step 3, then a run resumed from that
   checkpoint whose losses must be within 1e-3 of the straight run's.
   Sharded training (ROADMAP item 7b): each model rank's K5 (with its
   log-sum-exp) and K5b at phi4-mini's heads split over meshes 1x2, 1x4
   and 1x8 (causal, B 1, S 4096, bf16; phase 3), bit-equal to its heads'
   slice of the whole launch and within the plain versions' bounds;
   phi4-mini-3.8b at full width, cut to 8 layers, through the sharded
   train step with the reference launcher's ``--fsdp`` rules on a 1x1 mesh
   over an
   NCCL world of one, 3 f32 and 3 int8 steps, each loss and grad norm and
   then every parameter bit-identical to the one-device steps (K5 16, K5b
   8 launches a step), one more step's collectives counted and another
   traced; one int8-compressed grad sync held to its plain quantize
   formula; and the train launcher under ``torch.distributed.run
   --nproc-per-node 1`` with ``--mesh 1,1 --fsdp --int8-opt`` at 2
   layers, 4 steps, resumed from its step-3 checkpoint with equal losses;
   with two or more cards, the train launcher on the ``(1, n)`` mesh.
   The ssm and hybrid families on a mesh (ROADMAP item 7c-ii (a)): K1 /
   K2 at jamba's 64 / 8 heads on every rank of 1x2 and 1x8, and K5 / K5b
   (causal, S 4096) on rank 0 of 1x8 (phase 3), each bit-equal to its
   slice of the whole launch; mamba2-1.3b cut to 8 layers (3 f32 and 3
   int8 steps) and jamba cut to 2 layers (a mamba layer with its MLP, the
   attention layer with an MoE of 2 of its 16 experts; 2 f32 and 2 int8
   steps) through the sharded train step on a 1x1 NCCL mesh, bit-identical
   to one device; and the decode state a rank holds on 1x2 and 1x8.
   The enc_dec family on a mesh (ROADMAP item 7c-ii (b)): K1 / K2 at
   whisper-medium's 16 / 16 heads of 64 on every rank of 1x2 and 1x8, and
   K5 / K5b (``full``: the encoder's S 1500, the cross-attention's 448
   queries over 1500 frames) on rank 0 of 1x8 (phase 3), each bit-equal to
   its slice of the whole launch; whisper-medium at full width and depth
   (B 1, decoder S 448 over 1500 frames, remat; 3 f32 and 3 int8 steps)
   through the sharded train step on a 1x1 NCCL mesh, bit-identical to one
   device (K5 120, K5b 72 launches a step), one more f32 step's
   collectives counted.
6. Reference check: the same small models (the smoke configs of
   phi4-mini, gemma3-4b, deepseek-7b, mixtral-8x22b,
   llama4-scout-17b-a16e and paligemma-3b) and traces served on the card
   (kernels) and on the CPU (plain versions) give the same greedy tokens
   and logits within tolerance, for every KV format, for the int8 and
   bstc weight formats, and with eager admission (the smoke configs of
   mixtral-8x22b and llama4-scout-17b-a16e too), and paligemma-3b-smoke's
   forward behind its 16-patch prefix within 1e-4 of max |logit|
   (mamba2-smoke's decode, in the ssm phase: tokens equal, logits within
   1e-4), and whisper-smoke's encoder and forward within 1e-4 of max
   |value| and its ``make_serve_step`` decode in every layout and KV
   format (bf16: tokens equal, logits within 1e-4; int8 / bgpp
   teacher-forced within 5e-3), a second round from the live cache with
   slot 0 reset so the slots stand at other positions; and the paper layer's
   ``brcr_matmul``, batched predictor and examples at the reference
   examples' sizes agree between card and CPU.

The second-to-last lines are the kernels' JSON record and the card line;
the last line is ``{"ok": true, "device": {...}}``.

Each phase's seconds print as a ``[time]`` line.

``--only kernels|head-widths|long-context|prefix|score|score-device|decode|
decode-attends|ssm|hybrid|long-serve|whisper|server|train|sharded|sharded-train|
sharded-moe|sharded-ssm|sharded-encdec`` (repeatable) runs just those parts of
phase 3 or 5 (``server``: phi4-mini-3.8b's bf16 and bgpp offline runs, then the
front door over them; ``train``: K5b's cases and the training path; and, for
``score`` and ``decode``, K6's or K4's device times; ``decode-attends``
K1's and K2's device times at the decode geometry, through the public
wrappers only, so the script copied into an older tree times that tree's
kernels), prints no records and ends after them: for work on one
kernel.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# dense tensor-core peaks; float32 outside the tensor cores
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


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


def row_tol(want, step=None):
    """:func:`check_rows`' tolerance of each (b, h, g) row:
    ``1e-5 * max(1, max|want row|)`` (f32 sums in another order) plus
    ``step``, the plain version's per-row bound on one flipped int8
    probability code (:func:`int8_code_step`); ``step`` None: no codes."""
    tol = 1e-5 * want.abs().amax(-1).clamp(min=1.0)
    return tol if step is None else tol + step


def check_rows(name, got, want, step=None):
    """Max |got - want|, failing the run unless every (b, h, g) row is
    within :func:`row_tol`."""
    err = (got - want).abs().amax(-1)
    tol = row_tol(want, step)
    bad = err > tol
    if bool(bad.any()):
        at = bad.nonzero()[0].tolist()
        raise AssertionError(f"{name} disagrees at row {at}: {err[tuple(at)].item():.3e} "
                             f"> {tol[tuple(at)].item():.3e}")
    return err.max().item()


def kernel_record(name, source, replaces, err, ms, plain_ms, nbytes, ops, kind, lib_ms,
                  label="", case=None):
    """One kernel's JSON record (launches filled in after the main paths),
    printed as a ``[kernel]`` line (``label`` names the case there; a
    ``case`` goes into the record too).  The bound is the larger of
    ``nbytes`` at the HBM rate and ``ops`` at the ``kind`` peak."""
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = ops / PEAK_OPS[kind] * 1e3
    rec = dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(bound_b, bound_o),
               bound_by="bytes" if bound_b >= bound_o else "operations", library_ms=lib_ms)
    if case:
        rec["case"] = case
    print(f"[kernel] {name}{label}: max_abs_err={err:.3e} kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
          f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    return rec


K1_SOURCE = "src/repro_torch/csrc/paged_flash_decode.cu"
K1_PASS_SOURCE = "src/repro_torch/csrc/paged_flash_decode_long.cu"  # past one block's smem
K1_REPLACES = {"bf16": "src/repro/kernels/paged_flash_decode/kernel.py:65",
               "int8": "src/repro/kernels/paged_flash_decode/kernel.py:85"}


def k1_inputs(device, seed, B, S, pos, page, Hk, g, D):
    """Seeded K1 operands at one geometry: f32 q ``(B, Hk, g, D)`` and K/V
    ``(B * S, Hk, D)`` over a shuffled page table (:func:`_shuffled_table`)
    of the slots' positions ``pos``."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    pos = torch.tensor(pos, dtype=torch.int32)
    pp = S // page
    table = _shuffled_table(gen, B, pp, B * pp, pos, page, device)
    dg = torch.Generator(device=device).manual_seed(seed + 1)
    q = torch.randn((B, Hk, g, D), generator=dg, device=device)
    kf = torch.randn((B * S, Hk, D), generator=dg, device=device)
    vf = torch.randn((B * S, Hk, D), generator=dg, device=device)
    return q, kf, vf, table, pos.to(device)


def k1_int8_step(q, kq, ks, vs, table, pos, page):
    """K1's per-row tolerance step of its int8 body on these operands: the
    plain version's bound on one flipped int8 probability code
    (``int8_code_step``), ``(B, Hk, g)``."""
    import torch

    from repro_torch.kernels.paged_flash_decode.ref import int8_code_step
    from repro_torch.serving import kv_cache as kvc

    S = table.shape[1] * page
    phys = kvc.phys_table(table, page, S).long()
    kv_view = lambda a: a[phys].movedim(2, 1)  # (B, Hk, S, ...)
    valid = torch.arange(S, device=q.device)[None, :] <= pos[:, None]  # (B, S)
    return int8_code_step(q[:, :, :, None], kv_view(kq), kv_view(ks), kv_view(vs),
                          valid[:, None, None, None, :])[..., 0]


def k1_case(label, q, kf, vf, table, pos, page, flush=None, iters=20):
    """Both K1 bodies on one input set.  Each: two launches on the same
    inputs give identical bits, and the output is held against the plain
    version by :func:`check_rows` (int8: plus one probability-code step).
    With ``flush``, each body is timed (``iters`` launches) against its
    plain version and (bf16) ``scaled_dot_product_attention`` on the
    gathered view, and its record (:func:`kernel_record`) is returned; the
    ``[kernel]`` line names the plan's cluster size, lanes a block, blocks
    and, past the single pass, its passes."""
    import torch

    from repro_torch.kernels import paged_flash_decode as pfd_ops
    from repro_torch.kernels.paged_flash_decode import kernel as pfd_kernel
    from repro_torch.kernels.paged_flash_decode.ref import paged_flash_decode_ref
    from repro_torch.serving import kv_cache as kvc

    B, Hk, g, D = q.shape
    pp = table.shape[1]
    S = pp * page
    device = q.device


    phys = kvc.phys_table(table, page, S).long()
    kv_view = lambda a: a[phys].movedim(2, 1)  # (B, Hk, S, ...)
    valid = torch.arange(S, device=device)[None, :] <= pos[:, None]  # (B, S)
    n_valid = [S if int(p) < 0 else min(int(p) + 1, S) for p in pos.cpu()]
    rows = sum(n_valid) * Hk
    io_bytes = q.numel() * 4 * 2 + table.numel() * 4 + B * 4  # q, out, table, pos
    bodies = {"bf16": ((kf.to(torch.bfloat16), vf.to(torch.bfloat16)), {}, None)}
    kq, ks = kvc.quantize_kv(kf)
    vq, vs = kvc.quantize_kv(vf)
    step = k1_int8_step(q, kq, ks, vs, table, pos, page)
    bodies["int8"] = ((kq, vq), dict(k_scale=ks, v_scale=vs), step)
    del kf, vf
    records = []
    for body, ((k, v), scales, tol_step) in bodies.items():
        p = pfd_kernel.plan(B, Hk, g, D, pp, page, pfd_kernel.sm_count(device),
                            int8=body == "int8")
        passes = f", {p.passes} passes of {p.pass_lanes}" if p.pass_lanes else ""
        where = f" {label} (C {p.C}, L {p.L}, {B * Hk * p.C} blocks{passes})"
        run = lambda: pfd_ops.paged_flash_decode(q, k, v, table, pos, page_size=page,
                                                 **scales)
        plain = lambda: paged_flash_decode_ref(q, k, v, table, pos, page_size=page, **scales)
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"paged_flash_decode {body}{where}: two launches on the "
                                 f"same inputs differ")
        err = check_rows(f"paged_flash_decode {body}{where}", got, want, tol_step)
        if flush is None:
            print(f"[kernel] paged_flash_decode_{body}{where}: max_abs_err={err:.3e}, two "
                  f"launches bit-identical")
            continue
        lib_ms = None
        if body == "bf16":
            kview, vview = kv_view(k), kv_view(v)
            qh = q.reshape(B, Hk * g, 1, D).to(torch.bfloat16)
            mask = valid[:, None, None, :]
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kview, vview, attn_mask=mask, enable_gqa=True), iters, flush)
            del kview, vview
        row_bytes = 2 * D * k.element_size() + (8 if scales else 0)  # K, V (+ 2 scales)
        records.append(kernel_record(
            f"paged_flash_decode_{body}", K1_PASS_SOURCE if p.pass_lanes else K1_SOURCE,
            K1_REPLACES[body], err,
            time_ms(run, iters, flush), time_ms(plain, iters, flush),
            rows * row_bytes + io_bytes, rows * 4 * g * D, body, lib_ms,
            label=where + ", two launches bit-identical"))
    return records


K2_SOURCE = "src/repro_torch/csrc/bgpp_paged_attend.cu"
K2_SPAN_SOURCE = "src/repro_torch/csrc/bgpp_paged_attend_long.cu"  # past one cluster
K2_REPLACES = "src/repro/kernels/bgpp_paged_attend/kernel.py:80"


def k2_operands(q, kf, vf, table, pos, page):
    """K2's operands from a K1 input set: the int8 K/V of ``kf`` / ``vf``,
    K as packed bit planes + sign, and the ``(B, S)`` int32 phys map of the
    page table, as the bgpp pool and ``kernel_decode`` pass them."""
    import torch

    from repro_torch.serving import kv_cache as kvc

    kq, ks = kvc.quantize_kv(kf)
    vq, vs = kvc.quantize_kv(vf)
    planes, sign = kvc.k_to_bitplanes(kq)
    S = table.shape[1] * page
    phys = kvc.phys_table(table, page, S).to(torch.int32).contiguous()
    return (q, planes, sign, ks, vq, vs, phys, pos), kq


def k2_plain(args, kq, plan):
    """K2's plain version on ``args`` (:func:`k2_operands`) under ``plan``
    (rounds, k_max, survivors): its output, its survivor lanes and the
    per-row tolerance step of one flipped int8 probability code over the
    survivors (the planes rebuild ``kq`` exactly)."""
    from repro_torch.kernels.bgpp_paged_attend.ref import (
        bgpp_paged_attend_ref, rows_at, rows_per_head)
    from repro_torch.kernels.paged_flash_decode.ref import int8_code_step

    q, _, _, ks, _, vs, phys, pos = args
    want, idx = bgpp_paged_attend_ref(*args, **plan, return_indices=True)
    surv_at = lambda a: rows_per_head(a, rows_at(phys.long(), idx.long()), False)
    step = int8_code_step(q[:, :, :, None], surv_at(kq), surv_at(ks), surv_at(vs),
                          (idx <= pos[:, None, None])[:, :, None, None, :])[..., 0]
    return want, idx, step


def k2_case(label, args, kq, flush=None, arch="phi4-mini-3.8b"):
    """K2 on one input set (:func:`k2_operands`), with the serving plan of
    its width (``kv_cache.bgpp_decode_plan`` at ``arch``'s keep ratio and
    rounds): two launches give identical
    bits, the survivor lanes equal the plain version's and the output rows
    are within :func:`check_rows` of it (plus one probability-code step
    over the survivors), with and without the indices asked for.  With
    ``flush`` the case is timed against its plain version; the
    ``[kernel]`` line names the plan's cluster size, lanes a block and
    blocks (past one cluster: the tiles a cell of the spanning body).
    Returns ``(max_abs_err, ms, plain_ms)``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import bgpp_paged_attend as bgpp_ops
    from repro_torch.kernels.bgpp_paged_attend import kernel as bgpp_kernel
    from repro_torch.kernels.bgpp_paged_attend.ref import bgpp_paged_attend_ref
    from repro_torch.kernels.paged_flash_decode.kernel import sm_count
    from repro_torch.serving import kv_cache as kvc

    q, planes, sign, ks, vq, vs, phys, pos = args
    B, Hk, g, D = q.shape
    S = phys.shape[1]
    rounds, k_max, surv = kvc.bgpp_decode_plan(S, get_config(arch))
    p = bgpp_kernel.plan(B, Hk, g, D, S, k_max, surv, sm_count(q.device))
    ws = (f", lists in a {bgpp_kernel.workspace_ints(B, Hk, g, p) * 4 / 2**20:.0f} MiB "
          f"workspace" if p.workspace else "")
    where = (f" {label} (selection spanning blocks: {p.C} tiles of {p.L} a cell, "
             f"{B * Hk * p.C} blocks a sweep{ws})" if p.spans else
             f" {label} (C {p.C}, L {p.L}, {B * Hk * p.C} blocks{ws})")
    plan = dict(rounds=rounds, k_max=k_max, survivors=surv)
    got, idx = bgpp_ops.bgpp_paged_attend(*args, **plan, return_indices=True)
    again, idx2 = bgpp_ops.bgpp_paged_attend(*args, **plan, return_indices=True)
    serve, serve2 = (bgpp_ops.bgpp_paged_attend(*args, **plan) for _ in range(2))
    want, want_idx, step = k2_plain(args, kq, plan)
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(idx, idx2) and torch.equal(serve, serve2)):
        raise AssertionError(f"bgpp_paged_attend{where}: two launches on the same inputs "
                             f"differ")
    if not torch.equal(idx, want_idx):
        bad = (idx != want_idx).nonzero()[:5].tolist()
        raise AssertionError(f"bgpp_paged_attend{where} selected other lanes, e.g. {bad}")
    # with the indices and without them, as the serving path calls it
    err = max(check_rows(f"bgpp_paged_attend{where}", got, want, step),
              check_rows(f"bgpp_paged_attend{where} (no indices)", serve, want, step))
    ms = plain_ms = None
    timing = ""
    if flush is not None:
        ms = time_ms(lambda: bgpp_ops.bgpp_paged_attend(*args, **plan), flush=flush)
        plain_ms = time_ms(lambda: bgpp_paged_attend_ref(*args, **plan), flush=flush)
        timing = f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
    print(f"[kernel] bgpp_paged_attend{where}: survivor indices equal, max_abs_err="
          f"{err:.3e}, two launches bit-identical{timing}")
    return err, ms, plain_ms


def k2_record(args, err, ms, plain_ms, table_numel, label, arch="phi4-mini-3.8b"):
    """K2's JSON record for one timed input set: bound = q and out, the
    page table and positions, the phys map, and per (valid slot, kv head)
    the sign and MSB plane of every valid lane, each round's next plane of
    its survivors and the final survivors' other planes, scales and int8 V
    row, at the HBM rate; its operations (the plane scores' 2 g D a lane
    and the exact attend's 4 g D a survivor) at the int8 peak.  The source
    is the spanning body's where the plan spans blocks."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.bgpp_paged_attend import kernel as bgpp_kernel
    from repro_torch.serving import kv_cache as kvc

    q, _, _, _, _, _, phys, pos = args
    B, Hk, g, D = q.shape
    S = phys.shape[1]
    rounds, k_max, surv = kvc.bgpp_decode_plan(S, get_config(arch))
    spans = bgpp_kernel.plan(B, Hk, g, D, S, k_max, surv, 132).spans
    n_valid = [min(int(p) + 1, S) for p in pos.cpu()]
    Dp = D // 8
    io_bytes = q.numel() * 4 * 2 + table_numel * 4 + B * 4  # q, out, table, pos
    nbytes = io_bytes + B * S * 4  # + the phys map
    for nv in n_valid:
        kv_rows = min(k_max, nv)
        nbytes += Hk * (nv * 2 * Dp  # sign + MSB plane of every valid lane
                        + sum(min(s, nv) for s in surv[1:]) * Dp  # round planes
                        + kv_rows * ((kvc.NBITS - rounds) * Dp + 4 + D + 4))
    ops = sum(Hk * (nv * g * D * 2 + k_max * g * D * 4) for nv in n_valid)
    return kernel_record("bgpp_paged_attend", K2_SPAN_SOURCE if spans else K2_SOURCE,
                         K2_REPLACES, err, ms, plain_ms, nbytes, ops, "int8", None, label=label)


DECODE_S, DECODE_PAGE = 1024, 16  # the decode attends' width and page in the main path


def decode_attend_inputs(device, arch="phi4-mini-3.8b"):
    """The decode attends' operands at the decode geometry (B 4 slots of
    ``arch``'s heads, phi4-mini's Hk 8, g 3, D 128 by default, over S 1024
    lanes, page 16), seed 0: positions at page ends, a page start, and one
    shorter than BGPP's k_max."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    S, page = DECODE_S, DECODE_PAGE
    return k1_inputs(device, 0, 4, S, [S - 1, 100, 20 * page - 1, 33 * page], page,
                     cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim)


def kernel_phase(device, flush):
    """Hold the decode attend kernels against their plain versions at the
    main path's shapes; return their JSON records (launches filled in
    later).  Each also runs a long context (B 1, S 32768, timed) and an
    early-exit case (every position inside the first block's lanes, one
    slot at -1; K2: one below k_max), and two launches on the same inputs
    must give the same bits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.bgpp_paged_attend import kernel as bgpp_kernel
    from repro_torch.kernels.paged_flash_decode import kernel as pfd_kernel
    from repro_torch.serving import kv_cache as kvc

    cfg = get_config("phi4-mini-3.8b")
    inputs = decode_attend_inputs(device)
    q, kf, vf, table, pos = inputs
    B, Hk, g, D = q.shape
    S, page = DECODE_S, DECODE_PAGE
    records = k1_case("decode geometry", *inputs, page, flush)
    # ---- K1: a long context, and every slot ending in the first block ------
    long_ctx = k1_inputs(device, 10, 1, 32768, [32767], page, Hk, g, D)
    k1_case("long context S 32768", *long_ctx, page, flush)
    del long_ctx
    torch.cuda.empty_cache()
    L = pfd_kernel.plan(B, Hk, g, D, S // page, page, pfd_kernel.sm_count(device)).L
    k1_case("early exit", *k1_inputs(device, 20, B, S, [L - 1, 37, 0, -1], page, Hk, g, D),
            page)
    # ---- K2: the decode geometry, a long context, an early exit ------------
    args, kq = k2_operands(*inputs, page)
    err, ms, plain_ms = k2_case("decode geometry", args, kq, flush)
    records.append(k2_record(args, err, ms, plain_ms, table.numel(), " decode geometry"))
    rounds, k_max, surv = kvc.bgpp_decode_plan(S, cfg)
    del args, kq
    long_ctx = k1_inputs(device, 30, 1, 32768, [32767], page, Hk, g, D)
    k2_case("long context S 32768", *k2_operands(*long_ctx, page), flush)
    del long_ctx
    torch.cuda.empty_cache()
    L = bgpp_kernel.plan(B, Hk, g, D, S, k_max, surv, pfd_kernel.sm_count(device)).L
    early = k1_inputs(device, 40, B, S, [L - 1, k_max // 4, 0, -1], page, Hk, g, D)
    k2_case("early exit", *k2_operands(*early, page))
    return records


# (name, Hq, Hk, D) of the head-width phase: the reference's configs whose
# head widths the card once refused (src/repro/configs/gemma3_1b.py,
# gemma3_4b.py and paligemma_3b.py at D 256; gemma3-1b's smoke width 24),
# and the instances whisper-medium's decode and forward take (g 1, D 64;
# src/repro/configs/whisper_medium.py)
HEAD_WIDTH_CASES = (
    ("gemma3-1b", 4, 1, 256),
    ("gemma3-4b", 8, 4, 256),
    ("paligemma-3b", 8, 1, 256),
    ("gemma3-1b smoke", 4, 1, 24),
    ("deepseek-7b", 32, 32, 128),  # g 1
    ("llama4-scout", 40, 8, 128),  # g 5 (src/repro/configs/llama4_scout_17b_a16e.py)
    ("whisper-medium", 16, 16, 64),  # g 1, D 64
    ("jamba-1.5-large", 64, 8, 128),  # g 8, D 128 (src/repro/configs/jamba_1_5_large_398b.py)
)
HEAD_WIDTH_TIMED = ("whisper-medium",)  # timed beside the D 256 cases
HEAD_WIDTH_PAGES = (DECODE_PAGE, 6)  # a power of two and a page size that is not
GEMMA3_WINDOW = 512  # gemma3-1b's sliding window (src/repro/configs/gemma3_1b.py)


def head_width_phase(device, flush):
    """The decode attends and the forward's attend at the head widths the
    card once refused (:data:`HEAD_WIDTH_CASES`).  Per case: K1 (bf16 and
    int8 bodies, :func:`k1_case`) and K2 (:func:`k2_case`) at B 4 over
    S 1024 lanes (rounded up to whole pages) at pages 16 and 6, positions
    as :func:`decode_attend_inputs`; K5 (:func:`flash_case`) at B 1, S 512,
    causal and with gemma3's sliding window of 512, bf16, and f32 causal.
    The same tolerances and two-launch checks as the kernel phase.  The
    D 256 cases and :data:`HEAD_WIDTH_TIMED`'s at page 16 are timed, each
    kernel's record (K5: beside ``scaled_dot_product_attention``) returned
    with its case named."""
    import torch

    records = []
    for i, (name, Hq, Hk, D) in enumerate(HEAD_WIDTH_CASES):
        g = Hq // Hk
        for page in HEAD_WIDTH_PAGES:
            S = -(-DECODE_S // page) * page
            timed = (flush if (D == 256 or name in HEAD_WIDTH_TIMED) and page == DECODE_PAGE
                     else None)
            case = f"{name} Hq {Hq} Hk {Hk} D {D} page {page} S {S}"
            inputs = k1_inputs(device, 60 + 10 * i + page, 4, S,
                               [S - 1, 100, 20 * page - 1, 33 * page], page, Hk, g, D)
            recs = k1_case(case, *inputs, page, timed)
            args, kq = k2_operands(*inputs, page)
            err, ms, plain_ms = k2_case(case, args, kq, timed)
            if timed is not None:
                for r in recs:
                    r["case"] = case
                records += recs
                records.append(k2_record(args, err, ms, plain_ms, inputs[3].numel(),
                                         f" {case}"))
                records[-1]["case"] = case
            del inputs, args, kq
        gen = torch.Generator(device=device).manual_seed(70 + i)
        for kind, window, dtype in (("causal", 0, torch.bfloat16),
                                    ("sliding", GEMMA3_WINDOW, torch.bfloat16),
                                    ("causal", 0, torch.float32)):
            mk = lambda H: torch.randn((1, 512, H, D), generator=gen, device=device).to(dtype)
            q, k, v = mk(Hq), mk(Hk), mk(Hk)
            kw = dict(mask_kind=kind, window=window, q_offset=0)
            dt = "bf16" if dtype == torch.bfloat16 else "f32"
            case = f"{name} Hq {Hq} Hk {Hk} D {D} {kind} B1 S512 {dt}"
            timed = (flush if (D == 256 or name in HEAD_WIDTH_TIMED) and kind == "causal"
                     and dt == "bf16" else None)
            rec = flash_case(case, q, k, v, kw, timed, twice=True, case=case)
            if rec is not None:
                records.append(rec)
        torch.cuda.empty_cache()
    return records


# (name, Hk, g, D) of the long-context phase: the reference's decode_32k
# for K2 at the geometries whose lists pass shared memory (gemma3-1b,
# llama4-scout, paligemma-3b; src/repro/configs/shapes.py) and at
# whisper-medium's (Hk 16, g 1, D 64), K1 there at whisper-medium's, and
# its long_500k for K1 and K2 (selection spanning blocks) at the
# sub-quadratic archs' global layers (gemma3-4b, gemma3-1b, llama4-scout)
K2_LONG_CASES = (("gemma3-1b", 1, 4, 256), ("llama4-scout", 8, 5, 128),
                 ("paligemma-3b", 1, 8, 256), ("whisper-medium", 16, 1, 64))
K1_32K_CASES = (("whisper-medium", 16, 1, 64),)
K1_LONG_CASES = (("gemma3-4b", 4, 2, 256), ("gemma3-1b", 1, 4, 256),
                 ("llama4-scout", 8, 5, 128))
K2_LONG_S, K1_LONG_S = 32768, 524288
K2_SPAN_NARROW_S = 40000  # past one cluster: the spanning body
LONG_ARCH = {"gemma3-4b": "gemma3-4b", "gemma3-1b": "gemma3-1b", "paligemma-3b": "paligemma-3b",
             "llama4-scout": "llama4-scout-17b-a16e",
             "whisper-medium": "whisper-medium"}  # the config whose BGPP plan a case takes
K2_EARLY_POS, K1_EARLY_POS = 3000, 5000  # inside K2's first block, K1's first pass


def long_context_phase(device, flush):
    """The decode attends at the reference's context lengths
    (:data:`K2_LONG_CASES`, :data:`K1_32K_CASES`, :data:`K1_LONG_CASES`;
    page 16): K2 at decode_32k (S 32768) with its lists in the global
    workspace, K1's bf16 and int8 bodies at decode_32k, K2 at
    long_500k (S 524,288) with its selection spanning blocks, and K1's
    bf16 and int8 bodies at long_500k in passes, each with its arch's BGPP
    plan.  Each case has
    two slots, one at the last lane and one ending inside K2's first block
    or K1's first pass (:data:`K2_EARLY_POS`, :data:`K1_EARLY_POS`), is
    held to its plain version within the kernel phase's tolerances (K2: the
    survivor indices equal), launched twice for identical bits, and timed
    with its bound (:func:`k1_case`, :func:`k2_case`); returns the records,
    each naming its case."""
    import torch

    records = []
    for i, (name, Hk, g, D) in enumerate(K2_LONG_CASES):
        case = f"{name} Hk {Hk} g {g} D {D} page 16 S {K2_LONG_S} B 2"
        inputs = k1_inputs(device, 90 + i, 2, K2_LONG_S, [K2_LONG_S - 1, K2_EARLY_POS],
                           DECODE_PAGE, Hk, g, D)
        args, kq = k2_operands(*inputs, DECODE_PAGE)
        table_numel = inputs[3].numel()
        del inputs
        err, ms, plain_ms = k2_case(case, args, kq, flush, arch=LONG_ARCH[name])
        records.append(k2_record(args, err, ms, plain_ms, table_numel, f" {case}",
                                 arch=LONG_ARCH[name]))
        records[-1]["case"] = case
        del args, kq
        torch.cuda.empty_cache()
    # the spanning body at a width it has no instance of (the gemma3-1b smoke
    # width D 24 runs at 128, its rows byte by byte), checked, not timed
    inputs = k1_inputs(device, 84, 2, K2_SPAN_NARROW_S, [K2_SPAN_NARROW_S - 1, K2_EARLY_POS],
                       DECODE_PAGE, 2, 3, 24)
    k2_case(f"Hk 2 g 3 D 24 page 16 S {K2_SPAN_NARROW_S} B 2", *k2_operands(*inputs, DECODE_PAGE))
    del inputs
    for i, (name, Hk, g, D) in enumerate(K1_LONG_CASES):  # K2 at long_500k
        case = f"{name} Hk {Hk} g {g} D {D} page 16 S {K1_LONG_S} B 2"
        inputs = k1_inputs(device, 85 + i, 2, K1_LONG_S, [K1_LONG_S - 1, K1_EARLY_POS],
                           DECODE_PAGE, Hk, g, D)
        args, kq = k2_operands(*inputs, DECODE_PAGE)
        table_numel = inputs[3].numel()
        del inputs
        err, ms, plain_ms = k2_case(case, args, kq, flush, arch=LONG_ARCH[name])
        records.append(k2_record(args, err, ms, plain_ms, table_numel, f" {case}",
                                 arch=LONG_ARCH[name]))
        records[-1]["case"] = case
        del args, kq
        torch.cuda.empty_cache()
    for i, (name, Hk, g, D) in enumerate(K1_32K_CASES):
        case = f"{name} Hk {Hk} g {g} D {D} page 16 S {K2_LONG_S} B 2"
        recs = k1_case(case, *k1_inputs(device, 80 + i, 2, K2_LONG_S,
                                         [K2_LONG_S - 1, K2_EARLY_POS], DECODE_PAGE, Hk, g, D),
                       DECODE_PAGE, flush)
        for r in recs:
            r["case"] = case
        records += recs
        torch.cuda.empty_cache()
    for i, (name, Hk, g, D) in enumerate(K1_LONG_CASES):
        case = f"{name} Hk {Hk} g {g} D {D} page 16 S {K1_LONG_S} B 2"
        recs = k1_case(case, *k1_inputs(device, 95 + i, 2, K1_LONG_S,
                                         [K1_LONG_S - 1, K1_EARLY_POS], DECODE_PAGE, Hk, g, D),
                       DECODE_PAGE, flush, iters=5)
        for r in recs:
            r["case"] = case
        records += recs
        torch.cuda.empty_cache()
    return records


# K5's prefix_causal at paligemma-3b's heads (Hq 8, Hk 1, D 256; its 256
# image patches; src/repro/configs/paligemma_3b.py): (label, S, prefix,
# q_offset, dtype); the first is the record's case, timed beside SDPA
PREFIX_CASES = (("paligemma-3b prefix 256", 556, 256, 0, "bf16"),
                ("prefix 100 (not a tile multiple)", 556, 100, 0, "bf16"),
                ("prefix 0 (causal)", 556, 0, 0, "bf16"),
                ("prefix 600 >= S (full)", 556, 600, 0, "bf16"),
                ("prefix 256, q_offset 200", 556, 256, 200, "bf16"),
                ("prefix 256 f32", 556, 256, 0, "f32"))


def flash_prefix_phase(device, flush):
    """K5's prefix_causal kind (the VLM's mask) against its plain version
    (:func:`flash_case`) at :data:`PREFIX_CASES`, each launched twice for
    identical bits; the first timed beside ``scaled_dot_product_attention``
    with the same boolean mask.  Returns its record."""
    import torch

    gen = torch.Generator(device=device).manual_seed(8)
    record = None
    for label, S, prefix, off, dt in PREFIX_CASES:
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
        mk = lambda Sx, H: torch.randn((1, Sx, H, 256), generator=gen,
                                       device=device).to(dtype)
        q, k, v = mk(S - off, 8), mk(S, 1), mk(S, 1)
        case = f"{label}: Hq 8 Hk 1 D 256 B1 S{S} {dt}"
        rec = flash_case(case, q, k, v, dict(mask_kind="prefix_causal", window=prefix,
                                             q_offset=off),
                         flush if record is None else None, twice=True, case=case)
        record = record or rec
    return record


def decode_attend_times(device, calls: int = 50) -> None:
    """Device ms a call of K1's bf16 and int8 bodies and of K2 at the
    decode geometry (:func:`decode_attend_inputs`), one ``torch.profiler``
    trace of ``calls`` calls each, L2 flushed before every call
    (:func:`_device_ms`).  It calls the public wrappers only, so the same
    script times an older tree's kernels: copy it into that tree and run it
    there with ``--only decode-attends``, in the same call."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.bgpp_paged_attend import bgpp_paged_attend
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.serving import kv_cache as kvc

    inputs = decode_attend_inputs(device)
    q, kf, vf, table, pos = inputs
    kb, vb = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    args, kq = k2_operands(*inputs, DECODE_PAGE)
    _, _, _, ks, vq, vs, _, _ = args
    rounds, k_max, surv = kvc.bgpp_decode_plan(DECODE_S, get_config("phi4-mini-3.8b"))
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    out = []
    for label, fn in (
            ("K1 bf16", lambda: paged_flash_decode(q, kb, vb, table, pos, page_size=DECODE_PAGE)),
            ("K1 int8", lambda: paged_flash_decode(q, kq, vq, table, pos, page_size=DECODE_PAGE,
                                                   k_scale=ks, v_scale=vs)),
            ("K2", lambda: bgpp_paged_attend(*args, rounds=rounds, k_max=k_max,
                                             survivors=surv))):
        ms, counts = _device_ms(fn, calls, l2)
        out.append(f"{label} {ms:.5f} ms ({counts})")
    print(f"[compare] decode attends at the decode geometry (B 4, Hk 8, g 3, D 128, S 1024, "
          f"page 16; device ms a call, torch.profiler, {calls} calls, L2 flushed) of the tree "
          f"at {ROOT}: " + "; ".join(out))


def projection_shapes(cfg):
    """``(name, in, out, launches a decode step)`` of every distinct decode
    projection shape of ``cfg`` (7 projections a layer plus the head; an
    MoE layer's 4 attention projections, its experts staying raw); wq and
    wo share a shape where ``q_dim`` is ``d_model``."""
    d, L = cfg.d_model, cfg.num_layers
    attn = ([("wq/wo", d, cfg.q_dim, 2 * L)] if cfg.q_dim == d
            else [("wq", d, cfg.q_dim, L), ("wo", cfg.q_dim, d, L)])
    mlp = [] if cfg.num_experts else [("gate/up", d, cfg.d_ff, 2 * L),
                                      ("down", cfg.d_ff, d, L)]
    return attn + [("wk/wv", d, cfg.kv_dim, 2 * L)] + mlp + [("lm_head", d, cfg.vocab_size, 1)]


def bstc_record(w, cfg):
    """The serve path's BSTC record of one bf16 ``(in, out)`` matrix:
    int8-quantized per output channel, coded with 512-column tiles."""
    from repro_torch.serving import weights

    rec = weights.quantize(w)
    return rec, weights.bstc_record_from_int8(rec["q"], rec["scale"], cfg)


def bstc_tol(dense, x, scale):
    """:func:`check_bstc`'s tolerance of each output: 1e-5 of its
    ``Σ|w·x|``, times the scale where there is one."""
    row = dense.abs().float() @ x.float().abs()
    return 1e-5 * (row if scale is None else row * scale[:, None])


def check_bstc(label, ops, x, dense, scale):
    """One K3 case: two launches on the same inputs must give identical
    bits, and each output row must lie within :func:`bstc_tol` of the
    plain version (the products are exact, the sums run in another
    order).  Returns the largest error."""
    import torch

    from repro_torch.kernels.bstc_matmul import bstc_matmul
    from repro_torch.kernels.bstc_matmul.ref import bstc_matmul_plain

    apply = scale is not None
    got = bstc_matmul(ops, x, apply_scale=apply)
    again = bstc_matmul(ops, x, apply_scale=apply)
    want = bstc_matmul_plain(ops, x, apply_scale=apply)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"bstc_matmul {label}: two launches on the same inputs differ")
    tol = bstc_tol(dense, x, scale)
    err = (got - want).abs()
    if bool((err > tol).any()):
        at = (err > tol).nonzero()[0].tolist()
        raise AssertionError(f"bstc_matmul {label} ({x.dtype}, strides {x.stride()}) "
                             f"disagrees at {at}: "
                             f"{err[tuple(at)].item():.3e} > {tol[tuple(at)].item():.3e}")
    return err.max().item()


def bstc_plan_of(ops, x):
    """K3's launch plan for these operands and x (what the wrapper uses)."""
    from repro_torch.kernels.bstc_matmul import ops as bstc_ops

    p = bstc_ops._validate_cuda(ops, x)
    return (f"R {p.R}, C {p.C}, T {p.T}, {p.stages} stages, "
            f"{p.grid[0] * p.grid[1] * p.grid[2]} blocks")


def bstc_kernel_phase(device, flush):
    """Hold the fused BSTC decode + GEMV (K3) against its plain version at
    every full-width decode projection shape (N = 4 columns, f32 x as the
    f32 decode residual, read in place as the transpose of the (N, in)
    activations, as ``layers.wdot`` passes it; at wq/wo also N 1, 8 and 13,
    each in f32, in bf16 as layer 0's q/k/v get it, and as a row-major
    (in, N) tensor; then the full-width 3072 x 3072 matrix coded with one
    tile a row, as the serve path's round-trip check codes it, which walks
    a tile in 512-column steps), every case launched twice for identical
    bits (:func:`check_bstc`).  Tolerance: each output row within 1e-5 of
    its ``Σ|w·x|·scale``.  Returns the JSON record; its times and bound are
    the mean per launch over one decode step's mix."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.bstc_matmul import bstc_matmul
    from repro_torch.kernels.bstc_matmul.ref import bstc_matmul_plain, reconstruct_dense_ref

    cfg = get_config("phi4-mini-3.8b")
    gen = torch.Generator(device=device).manual_seed(2)
    N = 4
    mix = {"ms": 0.0, "plain": 0.0, "bytes": 0, "ops": 0, "bound": 0.0, "lib": 0.0, "n": 0,
           "err": 0.0}
    x_at = lambda d_in, dt, n=N: torch.randn((n, d_in), generator=gen, device=device).to(dt).T
    for name, d_in, d_out, count in projection_shapes(cfg):
        w = (torch.randn((d_in, d_out), generator=gen, device=device) * d_in ** -0.5
             ).to(torch.bfloat16)
        int8, rec = bstc_record(w, cfg)
        del w
        ops = rec["bstc"]
        dense = reconstruct_dense_ref(ops)  # plain decode: int32 (out, in)
        if not torch.equal(dense, int8["q"].T.to(torch.int32)):
            raise AssertionError(f"bstc_matmul {name}: the coded planes do not rebuild q")
        scale = rec["scale"]
        xs = [x_at(d_in, torch.float32)]
        if name == "wq/wo":
            for n in (1, 4, 8, 13):
                xs += [x_at(d_in, torch.float32, n)] if n != N else []
                xs += [x_at(d_in, torch.bfloat16, n), x_at(d_in, torch.float32, n).contiguous()]
        for x in xs:
            err = check_bstc(name, ops, x, dense, scale)
            mix["err"] = max(mix["err"], err)
            print(f"[kernel] bstc_matmul {name} N={x.shape[1]} {x.dtype} x strides "
                  f"{x.stride()}: max_abs_err {err:.3e}, two launches bit-identical "
                  f"({bstc_plan_of(ops, x)})")
        x = x_at(d_in, torch.float32)
        wf = (dense.float() * scale[:, None])  # the pre-reconstructed dense weight
        wb, xb = wf.to(torch.bfloat16), x.to(torch.bfloat16)
        del dense
        ms = time_ms(lambda: bstc_matmul(ops, x, apply_scale=True), flush=flush)
        xr = x.contiguous()  # the same x as a row-major (in, N) tensor
        rows_ms = time_ms(lambda: bstc_matmul(ops, xr, apply_scale=True), flush=flush)
        plain_ms = time_ms(lambda: bstc_matmul_plain(ops, x, apply_scale=True), iters=5,
                           flush=flush)
        f32_ms = time_ms(lambda: torch.matmul(wf, x), flush=flush)
        bf16_ms = time_ms(lambda: torch.matmul(wb, xb), flush=flush)
        del wf, wb
        # bytes this call needs: sign, raw planes, bitmaps, tile offsets and
        # the valid patterns (a byte each, as stored), scale, x and out
        patt_bytes = sum((ops.enc[3 * i + 2] != 0).sum().item()
                         for i in range(len(ops.enc_planes)))
        nbytes = (ops.sign_bits.numel() + sum(r.numel() for r in ops.raw)
                  + sum(ops.enc[3 * i].numel() + ops.enc[3 * i + 1].numel() * 4
                        for i in range(len(ops.enc_planes)))
                  + patt_bytes + 4 * d_out + 4 * d_in * N + 4 * d_out * N)
        ops_n = 2 * d_out * d_in * N
        bound = max(nbytes / HBM_BYTES_PER_S, ops_n / PEAK_OPS["f32"]) * 1e3
        print(f"[kernel] bstc_matmul {name} ({d_out} x {d_in}, N={N}, coded planes "
              f"{list(ops.enc_planes)}; {bstc_plan_of(ops, x)}): kernel {ms:.4f} ms "
              f"(x row-major {rows_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({nbytes} B needed; operands occupy "
              f"{ops.stored_bytes} B; plan prices {ops.hbm_bytes + 4 * d_out} B at "
              f"{ops.m} bits a pattern), torch.matmul dense f32 {f32_ms:.4f} ms, bf16 "
              f"{bf16_ms:.4f} ms; {count} launches a decode step")
        mix["ms"] += count * ms
        mix["plain"] += count * plain_ms
        mix["bytes"] += count * nbytes
        mix["ops"] += count * ops_n
        mix["bound"] += count * bound
        mix["lib"] += count * bf16_ms
        mix["n"] += count
    n = mix["n"]
    print(f"[kernel] bstc_matmul: a decode step's {n} projections take {mix['ms']:.3f} ms "
          f"(bound {mix['bound']:.3f} ms); the record below is the mean per launch, "
          f"library = torch.matmul on the dense bf16 weight")
    k3 = kernel_record(
        "bstc_matmul", "src/repro_torch/csrc/bstc_matmul.cu",
        "src/repro/kernels/bstc_matmul/kernel.py:98", mix["err"], mix["ms"] / n,
        mix["plain"] / n, mix["bytes"] / n, mix["ops"] / n, "f32", mix["lib"] / n)

    # ---- K3 on a full-width 3072 x 3072 matrix coded with one tile a row ------
    d = cfg.d_model
    w = (torch.randn((d, cfg.q_dim), generator=gen, device=device) * d ** -0.5
         ).to(torch.bfloat16)
    ops = decode_operands(w, cfg)
    x = x_at(d, torch.float32)
    err = check_bstc("wq/wo one tile a row", ops, x, reconstruct_dense_ref(ops), None)
    print(f"[kernel] bstc_matmul wq/wo coded with one tile a row (tile_k {d}): max_abs_err "
          f"{err:.3e}, two launches bit-identical ({bstc_plan_of(ops, x)})")
    del w, ops
    torch.cuda.empty_cache()
    zoo_bstc_checks(device, flush, GEMMA_ARCH)
    zoo_bstc_checks(device, flush, LLAMA4_ARCH)
    return [k3]


def zoo_bstc_checks(device, flush, arch):
    """K3 at ``arch``'s decode projection shapes (gemma3-4b: wq and wo
    apart, its q_dim 2048 is not its d_model 2560; llama4-scout: wq/wo
    5120 x 5120, wk/wv 5120 x 1024 and the 5120 x 202048 head, its experts
    staying raw; seeded bf16 weights quantized and coded as the serve path
    codes them): N 4 columns of f32
    x (the decode residual) and of bf16 x, each launched twice for
    identical bits and held to the plain version row by row
    (:func:`check_bstc`), and timed beside the plain version."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.bstc_matmul import bstc_matmul
    from repro_torch.kernels.bstc_matmul.ref import bstc_matmul_plain, reconstruct_dense_ref

    cfg = get_config(arch)
    gen = torch.Generator(device=device).manual_seed(3)
    for name, d_in, d_out, _ in projection_shapes(cfg):
        w = (torch.randn((d_in, d_out), generator=gen, device=device) * d_in ** -0.5
             ).to(torch.bfloat16)
        int8, rec = bstc_record(w, cfg)
        del w
        ops = rec["bstc"]
        dense = reconstruct_dense_ref(ops)
        if not torch.equal(dense, int8["q"].T.to(torch.int32)):
            raise AssertionError(f"bstc_matmul {cfg.name} {name}: the coded planes do not "
                                 f"rebuild q")
        del int8
        errs = []
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((4, d_in), generator=gen, device=device).to(dt).T
            errs.append(check_bstc(f"{cfg.name} {name}", ops, x, dense, rec["scale"]))
        del dense
        ms = time_ms(lambda: bstc_matmul(ops, x, apply_scale=True), flush=flush)
        plain_ms = time_ms(lambda: bstc_matmul_plain(ops, x, apply_scale=True), iters=3,
                           flush=flush)
        print(f"[kernel] bstc_matmul {cfg.name} {name} ({d_out} x {d_in}, N=4, coded planes "
              f"{list(ops.enc_planes)}; {bstc_plan_of(ops, x)}): max_abs_err f32 x "
              f"{errs[0]:.3e}, bf16 x {errs[1]:.3e}, two launches bit-identical; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (bf16 x)")
        del ops, rec
        torch.cuda.empty_cache()


# (label, out, in) of K4's shapes: the matrices whose planes the serve path's
# round-trip check decodes, coded as it codes them (one tile a row); the
# first is the JSON record's
DECODE_SHAPES = (("wq", 3072, 3072), ("down", 3072, 8192), ("gate/up", 8192, 3072))


def decode_operands(w, cfg):
    """The ``bstc_matmul`` operands of one bf16 ``(in, out)`` matrix coded
    with one tile a row, as the serve path's round-trip check codes it."""
    from repro_torch.core import bstc
    from repro_torch.kernels.bstc_matmul.ops import operands_from_encoded

    int8, _ = bstc_record(w, cfg)
    q_t = int8["q"].T.contiguous()
    bw = bstc.encode_weight(q_t, int8["scale"], m=cfg.mcbp.group_size,
                            threshold=cfg.mcbp.bstc_threshold)
    return operands_from_encoded(bw, tile_k=q_t.shape[1])


def decode_planes(device, seed=2):
    """``(label, coded plane numbers, EncodedPlaneOperands)`` of every
    :data:`DECODE_SHAPES` matrix, from seeded Gaussian weights."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.bstc_decode import EncodedPlaneOperands

    cfg = get_config("phi4-mini-3.8b")
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for label, d_out, d_in in DECODE_SHAPES:
        w = (torch.randn((d_in, d_out), generator=gen, device=device) * d_in ** -0.5
             ).to(torch.bfloat16)
        ops = decode_operands(w, cfg)
        if not ops.enc_planes:
            raise AssertionError(f"bstc_decode {label}: the matrix coded no plane")
        out.append((label, list(ops.enc_planes),
                    [EncodedPlaneOperands(*ops.enc[3 * i:3 * i + 3], H=d_in, m=ops.m)
                     for i in range(len(ops.enc_planes))]))
    return out


def decode_library(pl):
    """K4's function as one PyTorch call on operands built outside it:
    ``masked_scatter_`` of the row-compacted stream into zeros under the
    unpacked bitmap (a bool a column: 8x the bytes of K4's packed bitmap)."""
    import torch

    from repro_torch.core import bitslice

    mask = bitslice.unpack_bits(pl.bitmap).bool()
    nnz = mask.sum(1)
    cap = pl.patterns.shape[1]
    stream = pl.patterns[torch.arange(cap, device=mask.device)[None] < nnz[:, None]]
    G, H = mask.shape
    return lambda: torch.zeros((G, H), dtype=torch.uint8, device=mask.device).masked_scatter_(
        mask, stream)


def decode_plan_of(pl) -> str:
    """K4's launch plan for these operands (what the wrapper uses)."""
    from repro_torch.kernels.bstc_decode import ops as decode_ops

    p = decode_ops._validate_cuda(pl)
    if p is None or not hasattr(p, "R"):  # an older tree's wrapper: no plan
        return "no plan"
    return (f"{p.R} rows a block, {p.WR} warps a row, {p.NS} segments, {p.blocks} blocks "
            f"of {p.threads} threads, {p.smem} B shared, {p.copy}-byte copies")


def decode_kernel_phase(device, flush):
    """Hold the BSTC plane decode (K4) against its plain version at every
    :data:`DECODE_SHAPES` matrix, each coded plane launched twice (both
    bit-identical to the plain version), and time the kernel, the plain
    version and ``masked_scatter_`` (:func:`decode_library`, checked equal
    too) on each matrix's first coded plane, L2 flushed.  The bound counts
    the packed bitmap, the tile offsets, the valid stream bytes and the
    output.  Returns the wq record."""
    import torch

    from repro_torch.core import bitslice
    from repro_torch.kernels.bstc_decode import bstc_decode_patterns
    from repro_torch.kernels.bstc_decode.ref import decode_patterns_ref

    records = []
    for label, numbers, planes in decode_planes(device):
        for p, pl in zip(numbers, planes):
            want = decode_patterns_ref(bitslice.unpack_bits(pl.bitmap), pl.patterns)
            got, again = bstc_decode_patterns(pl), bstc_decode_patterns(pl)
            torch.cuda.synchronize()
            for out in (got, again):
                if not torch.equal(out, want):
                    bad = (out != want).nonzero()[:5].tolist()
                    raise AssertionError(f"bstc_decode {label} plane {p} differs from its "
                                         f"plain version at {bad}")
            print(f"[kernel] bstc_decode {label} plane {p}: two launches bit-identical to the "
                  f"plain version (G {pl.bitmap.shape[0]}, H {pl.H}, cap "
                  f"{pl.patterns.shape[1]}; {decode_plan_of(pl)})")
        pl = planes[0]
        G, H = pl.bitmap.shape[0], pl.H
        lib = decode_library(pl)
        if not torch.equal(lib(), bstc_decode_patterns(pl)):
            raise AssertionError(f"bstc_decode {label}: masked_scatter_ differs from the kernel")
        nnz = int(bitslice.unpack_bits(pl.bitmap).sum())
        records.append(kernel_record(
            "bstc_decode", "src/repro_torch/csrc/bstc_decode.cu",
            "src/repro/kernels/bstc_decode/kernel.py:48", 0.0,
            time_ms(lambda: bstc_decode_patterns(pl), flush=flush),
            time_ms(lambda: decode_patterns_ref(bitslice.unpack_bits(pl.bitmap), pl.patterns),
                    flush=flush),
            pl.bitmap.numel() + pl.tile_offsets.numel() * 4 + nnz + G * H, G * H, "f32",
            time_ms(lib, flush=flush), label=f" {label} (G {G}, H {H}, plane {numbers[0]})",
            case=label))
        del lib
    return records[0]


def decode_device_phase(device, calls: int = 20) -> None:
    """K4 against ``masked_scatter_`` (:func:`decode_library`) on device time
    at every :data:`DECODE_SHAPES` matrix's first coded plane: one
    ``torch.profiler`` trace of ``calls`` calls of each, L2 flushed before
    each call (:func:`_device_ms`)."""
    import torch

    from repro_torch.kernels.bstc_decode import bstc_decode_patterns

    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    for label, numbers, planes in decode_planes(device):
        pl = planes[0]
        k_ms, k_rec = _device_ms(lambda: bstc_decode_patterns(pl), calls, l2)
        l_ms, l_rec = _device_ms(decode_library(pl), calls, l2)
        print(f"[kernel] bstc_decode {label} device time (torch.profiler, {calls} calls each, "
              f"L2 flushed, G {pl.bitmap.shape[0]}, H {pl.H}, plane {numbers[0]}): kernel "
              f"{k_ms:.4f} ms a call, masked_scatter_ {l_ms:.4f} ms a call "
              f"({k_ms / l_ms:.2f}x); recorded: kernel {k_rec}; library {l_rec}")


# (label, B, Sq, Sk, mask_kind, window, q_offset, dtype, D[, Hq, Hk]) of each
# K5 case, at phi4-mini's heads (Hq 24, Hk 8) unless the case names its own;
# the first is the JSON record's: one eager admission's forward at the
# trace's prompt cap (512 tokens), the second the traced admission's
# (450).  Together they launch every compiled instance (bf16 at D 16 / 32 /
# 64 / 128, f32 at D 128), with ragged tails on both sides and q_offset.
# The last two are whisper-medium's (16/16 heads of 64): its encoder's
# full mask over 1500 frames (not a multiple of the 64-key tile) at B 4 and
# its forward's cross-attention, 128 queries over the 1500 memory rows;
# their records name their case.
FLASH_CASES = (
    ("causal B1 S512", 1, 512, 512, "causal", 0, 0, "bf16", 128),
    ("causal B1 S450", 1, 450, 450, "causal", 0, 0, "bf16", 128),
    ("causal B1 S301", 1, 301, 301, "causal", 0, 0, "bf16", 128),
    ("causal B4 S512", 4, 512, 512, "causal", 0, 0, "bf16", 128),
    ("sliding w256 B1 S512", 1, 512, 512, "sliding", 256, 0, "bf16", 128),
    ("chunked w256 B1 S512", 1, 512, 512, "chunked", 256, 0, "bf16", 128),
    ("full B1 S512", 1, 512, 512, "full", 0, 0, "bf16", 128),
    ("causal q_offset 256 B1 Sq256 Sk512", 1, 256, 512, "causal", 0, 256, "bf16", 128),
    ("sliding w100 B1 S201 D64", 1, 201, 201, "sliding", 100, 0, "bf16", 64),
    ("chunked w64 q_offset 170 B2 Sq130 Sk300 D32", 2, 130, 300, "chunked", 64, 170, "bf16",
     32),
    ("full B1 Sq65 Sk77 D16", 1, 65, 77, "full", 0, 0, "bf16", 16),
    ("causal f32 B1 S301", 1, 301, 301, "causal", 0, 0, "f32", 128),
    ("whisper-medium encoder full Hq 16 Hk 16 D 64 B4 S1500 bf16", 4, 1500, 1500, "full", 0,
     0, "bf16", 64, 16, 16),
    ("whisper-medium cross full Hq 16 Hk 16 D 64 B1 Sq128 Sk1500 bf16", 1, 128, 1500, "full",
     0, 0, "bf16", 64, 16, 16),
)


def flash_inputs(device, gen, case):
    """Seeded q ``(B, Sq, Hq, D)`` and k, v ``(B, Sk, Hk, D)`` of one
    :data:`FLASH_CASES` case at its heads (phi4-mini's Hq 24, Hk 8 unless
    it names its own), drawn from ``gen`` in that order, and the case's
    mask keywords."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("phi4-mini-3.8b")
    _, B, Sq, Sk, kind, window, off, dt, D = case[:9]
    Hq, Hk = case[9:] or (cfg.num_heads, cfg.num_kv_heads)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    mk = lambda S, H: torch.randn((B, S, H, D), generator=gen, device=device).to(dtype)
    q, k, v = mk(Sq, Hq), mk(Sk, Hk), mk(Sk, Hk)
    return q, k, v, dict(mask_kind=kind, window=window, q_offset=off)


def flash_library(q, k, v, kw):
    """``scaled_dot_product_attention`` computing K5's function on the
    transposed views: ``is_causal`` where it applies, else the boolean
    mask (the yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.core.attention import make_mask

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if kw["mask_kind"] == "causal" and kw["q_offset"] == 0:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)
    mask = make_mask(kw["mask_kind"], q.shape[1], k.shape[1], kw["window"], kw["q_offset"],
                     q.device)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def flash_case(label, q, k, v, kw, flush, twice=False, case=None):
    """K5 on one input set against its plain version.  Tolerance per
    element: ``1e-5 * max|v|`` (f32 sums in another order; bf16: the split
    of p, at most 2^-18 max|v|) plus, for bf16 operands, one bf16 step at
    ``|ref|`` (two f32 results that close can round to neighbouring bf16
    values).  With ``twice`` the kernel is launched twice and must give
    identical bits.  Bound: q, k, v read and out written once at the HBM
    rate, against 4 * D operations per visible (query, key) pair of the
    mask at the bf16 tensor-core peak (f32 peak for f32 operands).  The
    library call is :func:`flash_library`.  Returns the JSON record, with
    the largest error over its element's tolerance as ``err_over_tol``
    (printed in either case)."""
    import torch

    from repro_torch.core.attention import make_mask
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, Sq, Hq, D = q.shape
    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    p = flash_kernel.plan(q.dtype, *q.shape)
    where = f" {label} (BQ {p.BQ}, {p.grid[0] * p.grid[1]} blocks)"
    got = flash_attention(q, k, v, **kw)
    if twice:
        again = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"flash_attention{where}: two launches on the same "
                                 f"inputs differ")
        where += ", two launches bit-identical"
    # the plain version a block of query rows at a time (its logits are
    # (B, Hq, rows, Sk) f32: 11 GiB whole at llama4-scout's S 8448)
    want = torch.cat([flash_attention_ref(q[:, i:i + 1024], k, v,
                                          **dict(kw, q_offset=kw["q_offset"] + i))
                      for i in range(0, Sq, 1024)], 1)
    torch.cuda.synchronize()
    w = want.float()
    tol = 1e-5 * v.float().abs().max()
    if dt == "bf16":  # one bf16 step at |ref|: 2^(e - 8) for |ref| = m * 2^e, m in [.5, 1)
        tol = tol + torch.ldexp(torch.ones_like(w), torch.frexp(w.abs())[1] - 8)
    err = (got.float() - w).abs()
    if bool((err > tol).any()):
        at = (err > tol).nonzero()[0].tolist()
        raise AssertionError(f"flash_attention {label} disagrees at {at}: "
                             f"{err[tuple(at)].item():.3e} > {tol[tuple(at)].item():.3e}")
    ratio = (err / tol).max().item()
    where += f", worst err/tol {ratio:.3f}"
    if flush is None:
        print(f"[kernel] flash_attention{where}: max_abs_err={err.max().item():.3e}")
        return None
    pairs = int(make_mask(kw["mask_kind"], Sq, k.shape[1], kw["window"], kw["q_offset"],
                          q.device).sum()) * B * Hq
    esize = q.element_size()
    rec = kernel_record(
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:114", err.max().item(),
        time_ms(lambda: flash_attention(q, k, v, **kw), flush=flush),
        time_ms(lambda: flash_attention_ref(q, k, v, **kw), flush=flush),
        esize * (2 * q.numel() + k.numel() + v.numel()), 4 * D * pairs, dt,
        time_ms(flash_library(q, k, v, kw), flush=flush), label=where, case=case)
    rec["err_over_tol"] = ratio
    return rec


def flash_kernel_phase(device, flush):
    """Hold the flash-attention kernel (K5) against its plain version for
    every case of :data:`FLASH_CASES` (:func:`flash_case`; the first
    launched twice for identical bits), then at llama4-scout's heads
    (Hq 40, Hk 8, D 128, bf16) over S 8448 with its chunked-local mask of
    8192: the queries past 8192 attend only their own chunk (twice for
    identical bits, timed).  Returns the first case's JSON record, the
    whisper-medium cases' and the llama4-scout case's, which name their
    cases."""
    import torch

    gen = torch.Generator(device=device).manual_seed(3)
    records = []
    for case in FLASH_CASES:
        q, k, v, kw = flash_inputs(device, gen, case)
        named = case[0] if len(case) > 9 else None
        records.append(flash_case(case[0], q, k, v, kw, flush, twice=not records, case=named))
    mk = lambda H: torch.randn((1, LLAMA4_FLASH_S, H, 128), generator=gen,
                               device=device).to(torch.bfloat16)
    q, k, v = mk(40), mk(8), mk(8)
    case = f"llama4-scout chunked {LLAMA4_CHUNK} Hq 40 Hk 8 D 128 B1 S{LLAMA4_FLASH_S} bf16"
    records.append(flash_case(case, q, k, v, dict(mask_kind="chunked", window=LLAMA4_CHUNK,
                                                  q_offset=0), flush, twice=True, case=case))
    del q, k, v
    torch.cuda.empty_cache()
    return [records[0]] + [r for r in records[1:] if "case" in r]


def flash_device_phase(device, calls: int = 20) -> None:
    """K5 against ``scaled_dot_product_attention`` on device time, at the
    JSON record's case (causal B 1, S 512) and the traced admission's
    (S 450): one ``torch.profiler`` trace (:func:`_traced`) of ``calls``
    calls of each on the case's :data:`FLASH_CASES` operands (L2 warm, as
    in the forward, where q, k and v were just written), printed as device
    ms a call: the sum over the call's kernels of each one's mean device
    time (the trace may miss a call's first events; the kernels it recorded
    are printed with their counts; a trace that recorded nothing on every
    try is timed by CUDA events, :func:`_ms_a_call`).  Run after the serving
    runs are timed: a trace slows the process's later host work."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=device).manual_seed(3)
    for case in FLASH_CASES[:2]:  # drawn from the seed in FLASH_CASES order
        q, k, v, kw = flash_inputs(device, gen, case)
        lib = flash_library(q, k, v, kw)
        ms, counts = {}, {}
        for name, fn in (("kernel", lambda: flash_attention(q, k, v, **kw)), ("SDPA", lib)):
            fn()
            torch.cuda.synchronize()
            dev = _traced(lambda: [fn() for _ in range(calls)],
                          f"flash_attention {case[0]}: {calls} {name} calls", tries=3)
            ms[name], counts[name] = _ms_a_call(dev, fn, calls)
        print(f"[kernel] flash_attention {case[0]} device time (torch.profiler, {calls} calls "
              f"each, L2 warm): kernel {ms['kernel']:.4f} ms a call, SDPA {ms['SDPA']:.4f} ms a "
              f"call ({ms['kernel'] / ms['SDPA']:.2f}x); recorded: kernel {counts['kernel']}; "
              f"SDPA {counts['SDPA']}")


def bstc_device_phase(device, calls: int = 20) -> None:
    """K3 against a bf16 ``torch.matmul`` on the dense weight, on device
    time, at every full-width decode projection shape: one
    ``torch.profiler`` trace (:func:`_traced`) of ``calls`` calls of each,
    K3 on N = 4 f32 columns read in place as the decode step passes them,
    the matmul on the same x in bf16, L2 flushed before each call (the step
    reads every weight cold).  Prints device ms a call (the flush kernels
    left out) and the decode step's mix weighted by its launches.  Run after
    the serving runs are timed: a trace slows the process's later host
    work."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.bstc_matmul import bstc_matmul

    cfg = get_config("phi4-mini-3.8b")
    gen = torch.Generator(device=device).manual_seed(5)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    step = {"kernel": 0.0, "matmul": 0.0}
    for name, d_in, d_out, count in projection_shapes(cfg):
        w = (torch.randn((d_in, d_out), generator=gen, device=device) * d_in ** -0.5
             ).to(torch.bfloat16)
        int8, rec = bstc_record(w, cfg)
        del w
        ops = rec["bstc"]
        wb = (int8["q"].T.float() * rec["scale"][:, None]).to(torch.bfloat16)
        del int8
        x = torch.randn((4, d_in), generator=gen, device=device).T
        xb = x.to(torch.bfloat16)
        ms, counts = {}, {}
        for label, fn in (("kernel", lambda: bstc_matmul(ops, x, apply_scale=True)),
                          ("matmul", lambda: torch.matmul(wb, xb))):
            fn()
            torch.cuda.synchronize()

            def run():
                for _ in range(calls):
                    l2.zero_()
                    fn()

            dev = [e for e in _traced(run, f"bstc_matmul {name}: {calls} {label} calls",
                                      tries=3)
                   if "FillFunctor" not in e.key]
            ms[label], counts[label] = _ms_a_call(dev, fn, calls, flush=l2.zero_)
            step[label] += count * ms[label]
        print(f"[kernel] bstc_matmul {name} device time (torch.profiler, {calls} calls each, "
              f"L2 flushed): kernel {ms['kernel']:.4f} ms a call, bf16 torch.matmul "
              f"{ms['matmul']:.4f} ms a call ({ms['kernel'] / ms['matmul']:.2f}x; "
              f"{bstc_plan_of(ops, x)}); {count} launches a decode step; recorded: kernel "
              f"{counts['kernel']}; matmul {counts['matmul']}")
        del ops, wb
    print(f"[kernel] bstc_matmul: a decode step's {7 * cfg.num_layers + 1} projections by "
          f"device time (the mix above, weighted by launches): kernel {step['kernel']:.3f} ms, "
          f"bf16 torch.matmul {step['matmul']:.3f} ms")


def bgpp_device_phase(device, calls: int = 20) -> None:
    """K2 against K1's int8 body, the dense int8 attend over the same KV,
    on device time at the decode geometry (:func:`decode_attend_inputs`):
    one ``torch.profiler`` trace (:func:`_traced`) of ``calls`` calls of
    each, L2 flushed before each call (the decode step reads its KV cold).
    Prints device ms a call (the flush kernels left out) and their ratio.
    Run after the serving runs are timed: a trace slows the process's later
    host work."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.bgpp_paged_attend import bgpp_paged_attend
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.serving import kv_cache as kvc

    inputs = decode_attend_inputs(device)
    q, _, _, table, pos = inputs
    args, kq = k2_operands(*inputs, DECODE_PAGE)
    _, _, _, ks, vq, vs, _, _ = args
    rounds, k_max, surv = kvc.bgpp_decode_plan(DECODE_S, get_config("phi4-mini-3.8b"))
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    ms, counts = {}, {}
    for label, fn in (
            ("K2", lambda: bgpp_paged_attend(*args, rounds=rounds, k_max=k_max,
                                             survivors=surv)),
            ("K1 int8", lambda: paged_flash_decode(q, kq, vq, table, pos, page_size=DECODE_PAGE,
                                                   k_scale=ks, v_scale=vs))):
        fn()
        torch.cuda.synchronize()

        def run():
            for _ in range(calls):
                l2.zero_()
                fn()

        dev = [e for e in _traced(run, f"bgpp_paged_attend: {calls} {label} calls", tries=3)
               if "FillFunctor" not in e.key]
        ms[label], counts[label] = _ms_a_call(dev, fn, calls, flush=l2.zero_)
    print(f"[kernel] bgpp_paged_attend device time (torch.profiler, {calls} calls each, L2 "
          f"flushed, decode geometry): K2 {ms['K2']:.4f} ms a call, K1 int8 body on the same "
          f"int8 K/V {ms['K1 int8']:.4f} ms a call ({ms['K2'] / ms['K1 int8']:.2f}x); "
          f"recorded: K2 {counts['K2']}; K1 {counts['K1 int8']}")


# ---------------------------------------------------------------------------
# the paper layer: the BGPP round (K6) and the BRCR GEMM (K7)
# ---------------------------------------------------------------------------

# the decode geometry of the batched predictor: B slots x Hq query heads
# over Hk kv heads of D, S keys; keys from the reference walkthrough's
# concentrated-key generator, quantized at 25 a unit
DECODE_GEOMETRY = dict(B=4, Hq=24, Hk=8, S=1024, D=128)
KEY_SCALE = 25
BRCR_COLS = (4, 128)  # K7's x widths: a decode batch of four slots, a prefill chunk


@functools.lru_cache(maxsize=None)
def decode_keys(seed, B, Hq, Hk, S, D):
    """Integer queries ``(B, Hq, D)`` and keys ``(B, S, Hk, D)`` (numpy,
    int32): each (slot, kv head) draws its own concentrated keys and query
    (:func:`make_concentrated_keys`); the kv head's g query heads are that
    query plus a little integer noise.  Cached: the callers only read
    them."""
    import numpy as np

    from repro_torch.examples.bgpp_sparse_attention import make_concentrated_keys

    rng = np.random.default_rng(seed)
    g = Hq // Hk
    q = np.empty((B, Hq, D), np.int32)
    k = np.empty((B, S, Hk, D), np.int32)
    for b in range(B):
        for h in range(Hk):
            qh, kh, _ = make_concentrated_keys(rng, S, D)
            k[b, :, h] = kh
            q[b, h * g:(h + 1) * g] = np.clip(qh + rng.integers(-8, 9, (g, D)), -127, 127)
    return q, k


# K6's cases: the walkthrough's one query over S 4096, the batched
# predictor's call at the decode geometry, and the decode geometry at a
# long context
SCORE_CASES = ("S 4096, one query (the walkthrough)",
               "S 1024, B 4 x Hq 24 (the batched predictor)",
               "S 32768, B 4 x Hq 24 (a long context)")


def score_inputs(device, label):
    """K6's operands for one :data:`SCORE_CASES` case: the predictor's
    MSB-truncated query, round 1's packed plane (plane 5) and the sign,
    and the alive masks of a real first predictor round (the 4-round
    schedule's round-0 alpha), so dead key tiles occur; plus the bound's
    bytes and operations (the alive flags and q read and the scores written
    once, the plane and sign bytes of every key alive in some row of its
    kv head; 2 D integer operations a live row-key) and the library call,
    one ``torch.matmul`` of the pre-unpacked +-1 f32 plane by q, which
    reads 32x the bytes of the packed planes."""
    import numpy as np
    import torch

    from repro_torch.core import bgpp, bitslice, topk
    from repro_torch.examples.bgpp_sparse_attention import key_planes, make_concentrated_keys

    if label == SCORE_CASES[0]:
        q1, k1, _ = make_concentrated_keys(np.random.default_rng(0), 4096, 128)
        q_np, k_np = q1[None, None], k1[None, :, None]
    else:
        S = 1024 if label == SCORE_CASES[1] else 32768
        q_np, k_np = decode_keys(5, **dict(DECODE_GEOMETRY, S=S))
    B, Hq, D = q_np.shape
    S, Hk = k_np.shape[1], k_np.shape[2]
    g = Hq // Hk
    sign, planes = key_planes(k_np, device)
    q = torch.from_numpy(q_np).to(device)
    scale = 1.0 / (KEY_SCALE * KEY_SCALE * np.sqrt(D))
    first = bgpp.BGPPConfig(rounds=1, alpha_schedule=bgpp.BGPPConfig().alphas(4)[:1])
    alive_kv, _ = bgpp.bgpp_predict_batched(q, planes, sign, first, logit_scale=scale)
    alive = alive_kv.repeat_interleave(g, dim=1).contiguous()  # (B, Hq, S)
    pp, sp = bitslice.pack_bits(planes[5]), bitslice.pack_bits(sign)
    qt = topk.quantize_msb(q)  # the predictor's 4-bit query truncation
    signed = ((1 - 2 * sign.to(torch.int32)) * planes[5]).to(torch.float32)
    del sign, planes
    signed = signed.permute(0, 2, 1, 3).contiguous()  # (B, Hk, S, D), pre-unpacked +-1
    qg = qt.reshape(B, Hk, g, D).to(torch.float32).transpose(-1, -2)
    live_keys = int(alive_kv.sum())  # (slot, kv head, key) alive in some row
    nbytes = B * Hq * S * (1 + 4) + q.numel() * 4 + live_keys * 2 * (D // 8)
    ops = int(alive.sum()) * 2 * D
    return dict(args=(qt, pp, sp, alive), nbytes=nbytes, ops=ops,
                lib=lambda: torch.matmul(signed, qg), lib_bytes=signed.numel() * 4)


def bgpp_kernel_phase(device, flush):
    """Hold the BGPP round kernel (K6) against its plain version,
    bit-exact and launched twice, in every :data:`SCORE_CASES` case
    (:func:`score_inputs`), and time the decode geometry's and the long
    context's against the plain version and the library call.  Returns
    their JSON records."""
    import torch

    from repro_torch.kernels.bgpp_score import bgpp_score_heads
    from repro_torch.kernels.bgpp_score import kernel as score_kernel
    from repro_torch.kernels.bgpp_score.ref import bgpp_score_heads_ref
    from repro_torch.kernels.paged_flash_decode.kernel import sm_count

    records = []
    for label in SCORE_CASES:
        c = score_inputs(device, label)
        qt, pp, sp, alive = c["args"]
        B, Hq, D = qt.shape
        S, Hk = pp.shape[1], pp.shape[2]
        got, again = bgpp_score_heads(*c["args"]), bgpp_score_heads(*c["args"])
        want = bgpp_score_heads_ref(*c["args"])
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"bgpp_score {label}: two launches on the same inputs differ")
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist()
            raise AssertionError(f"bgpp_score {label} differs from its plain version at {bad}")
        p = score_kernel.plan(B, Hk, Hq // Hk, S, D, sm_count(device))
        cells = torch.nn.functional.pad(alive, (0, (-S) % p.TS)).reshape(B, Hk, Hq // Hk, -1, p.TS)
        dead = 1.0 - cells.any(-1).any(2).float().mean().item()
        where = (f" {label} (tile {p.TS} keys, {p.blocks} blocks, {100 * dead:.1f}% of "
                 f"(kv head, tile) cells dead)")
        print(f"[kernel] bgpp_score{where}: bit-identical to the plain version, two launches "
              f"bit-identical; {int(alive.sum())} of {B * Hq * S} row-keys alive after round "
              f"0; library = torch.matmul of the pre-unpacked +-1 f32 plane ({c['lib_bytes']} "
              f"B, 32x the packed plane)")
        if label != SCORE_CASES[0]:
            records.append(kernel_record(
                "bgpp_score", "src/repro_torch/csrc/bgpp_score.cu",
                "src/repro/kernels/bgpp_score/kernel.py:48", 0.0,
                time_ms(lambda: bgpp_score_heads(*c["args"]), flush=flush),
                time_ms(lambda: bgpp_score_heads_ref(*c["args"]), iters=3, flush=flush),
                c["nbytes"], c["ops"], "f32", time_ms(c["lib"], flush=flush), label=where,
                case=label))
        del c, got, again, want
        torch.cuda.empty_cache()
    return records


def score_device_phase(device, calls: int = 20) -> None:
    """K6 against the library call (:func:`score_inputs`) on device time
    (:func:`_device_ms`, L2 flushed before each call: a round reads its
    planes cold) in every :data:`SCORE_CASES` case, beside the bound."""
    import torch

    from repro_torch.kernels.bgpp_score import bgpp_score_heads

    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    for label in SCORE_CASES:
        c = score_inputs(device, label)
        bound = max(c["nbytes"] / HBM_BYTES_PER_S, c["ops"] / PEAK_OPS["f32"]) * 1e3
        ms, rec = _device_ms(lambda: bgpp_score_heads(*c["args"]), calls, l2)
        lib, lib_rec = _device_ms(c["lib"], calls, l2)
        print(f"[kernel] bgpp_score {label} device time (torch.profiler, {calls} calls each, "
              f"L2 flushed): kernel {ms:.4f} ms a call, library {lib:.4f} ms a call "
              f"({ms / lib:.2f}x), bound {bound:.5f} ms ({ms / bound:.1f}x); recorded: kernel "
              f"{rec}; library {lib_rec}")
        del c
        torch.cuda.empty_cache()


def check_brcr(label, got, want, w, x, exact):
    """Max |got - want| of a BRCR product, failing the run unless each
    element is within ``1e-5 * Σ|w·x|`` over its row and column (exact
    products, the sums in another order) or, with ``exact``, equal where
    that sum is below 2**24 (integer x: every partial sum is then an exact
    float32 integer)."""
    import torch

    row = w.abs().to(torch.float32) @ x.to(torch.float32).abs()
    tol = 1e-5 * row
    if exact:
        tol = torch.where(row < 2 ** 24, torch.zeros_like(tol), tol)
    err = (got - want).abs()
    bad = err > tol
    if bool(bad.any()):
        at = bad.nonzero()[0].tolist()
        raise AssertionError(f"brcr_gemm {label} disagrees at {at}: "
                             f"{err[tuple(at)].item():.3e} > {tol[tuple(at)].item():.3e}")
    return err.max().item()


def brcr_twice(label, ops, x):
    """K7 launched twice on the same operands; the run fails unless both
    give the same bits (the cluster adds in rank order, no atomics)."""
    import torch

    from repro_torch.kernels.brcr_gemm import brcr_gemm

    got, again = brcr_gemm(ops, x), brcr_gemm(ops, x)
    if not torch.equal(got, again):
        raise AssertionError(f"brcr_gemm {label}: two launches differ")
    return got


def brcr_case(label, w, x, m, exact):
    """One K7 case at group size m: launched twice (:func:`brcr_twice`) and
    held against the plain version and the dense product
    (:func:`check_brcr`); returns the max |error| against the plain
    version."""
    from repro_torch.kernels.brcr_gemm import prepare_brcr_operands
    from repro_torch.kernels.brcr_gemm.ref import brcr_gemm_ref, dense_ref

    ops = prepare_brcr_operands(w, m)
    got = brcr_twice(label, ops, x)
    err = check_brcr(label, got, brcr_gemm_ref(ops.group_idx, ops.plane_weights, x, m), w, x,
                     exact)
    check_brcr(label, got, dense_ref(w, x), w, x, exact)
    return err


def wide_ints(gen, M, H, N, device):
    """A sparse int8 (M, H) weight and integer x (H, N) of 17 to 20
    significant bits (column h of x draws its bit count) whose rows keep
    Σ|w·x| below (1 - 2^-6) 2^24 in every column: a row holds 1 to 3
    non-zeros, each within the budget its column of x leaves (up to 125
    where x has 17 bits and the row one non-zero, so every plane occurs).
    Exact only through all three bf16 terms of x: hi and mid hold 16 bits."""
    import torch

    bits = torch.randint(17, 21, (H, 1), generator=gen, device=device).float()
    half = 2.0 ** (bits - 1)
    mag = half + torch.floor(torch.rand((H, N), generator=gen, device=device) * half)
    x = mag * (2 * torch.randint(0, 2, (H, N), generator=gen, device=device) - 1)
    k = torch.randint(1, 4, (M, 1), generator=gen, device=device)
    cols = torch.randint(0, H, (M, 3), generator=gen, device=device)
    cap = torch.floor((1 - 2 ** -6) * 2 ** 24 / (k * mag.amax(1)[cols])).clamp(max=127)
    vals = torch.floor(torch.rand((M, 3), generator=gen, device=device) * (2 * cap + 1)) - cap
    vals = torch.where(torch.arange(3, device=device) < k, vals, torch.zeros_like(vals))
    w = torch.zeros((M, H), device=device).scatter_(1, cols, vals).to(torch.int8)
    return w, x


def brcr_need(ops, x):
    """(bytes, f32 adds) one BRCR product needs: every pattern byte, the
    plane weights, x and out once; per column of x, one merge add for each
    non-zero pattern, E @ Z (m 2^(m-1) adds a group and plane) and the
    +-2^p accumulation (two operations an output and plane)."""
    P, G, _ = ops.group_idx.shape
    N = x.shape[1]
    nbytes = ops.group_idx.numel() + 4 * P + x.numel() * x.element_size() + 4 * ops.M * N
    nnz = int((ops.group_idx != 0).sum())
    return nbytes, N * (nnz + P * G * ops.m * 2 ** (ops.m - 1) + 2 * P * ops.M)


def brcr_skips(ops):
    """Shares of K7's work its blocks skip: (plane, 32-group-row,
    256-column) tiles with no non-zero pattern, and (plane, 32-group-row
    block) pairs with none over the whole of H (ragged edges padded)."""
    import torch

    from repro_torch.kernels.brcr_gemm import tile_nonzero_map

    G, H = ops.group_idx.shape[1:]
    padded = torch.nn.functional.pad(ops.group_idx, (0, (-H) % 256, 0, (-G) % 32))
    live = tile_nonzero_map(padded, ops.m, 32 * ops.m, 256)  # (P, G / 32, H / 256)
    return 1.0 - live.float().mean().item(), 1.0 - live.any(-1).float().mean().item()


def brcr_kernel_phase(device, flush):
    """Hold the BRCR GEMM (K7) against its plain version and the dense
    product at every projection shape of one phi4-mini-3.8b layer (wq/wo
    3072 x 3072, wk/wv 1024 x 3072, gate/up 8192 x 3072, down 3072 x 8192;
    not the head, which no path runs BRCR on), with layer 0's seeded
    weights quantized by ``quantization.quantize_model_weight``.  x: N = 4
    (a decode batch) and N = 128 (a prefill chunk) of integers (exact where
    a row's Σ|w·x| < 2^24, else :func:`check_brcr`'s tolerance), and at
    N = 4 float32 and bfloat16 x once each (the tolerance; read as the
    transpose of (N, H) rows).  Times kernel, plain version and
    ``torch.matmul`` of the dense bf16 weight; prints the share of
    (plane, 128-row, 256-column) tiles the kernel skips.  Then, as the
    Gaussian weights leave no tile empty, the gate/up weight once more
    with whole row and column blocks zeroed, N = 128 integer x: exact,
    with tiles and whole planes of a block skipped, and timed (it must take
    less time than the whole weight).  Then m = 2 at wk/wv (N 4 and 128),
    a ragged 1028 x 3000 slice of gate/up at N 13 (m 4 and 2), and
    integers of 17 to 20 significant bits on a sparse 3072 x 3072 weight
    (:func:`wide_ints`, exact).  Every case is launched twice and must give
    identical bits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import quantization
    from repro_torch.kernels.brcr_gemm import brcr_gemm, prepare_brcr_operands
    from repro_torch.kernels.brcr_gemm.ref import brcr_gemm_ref, dense_ref
    from repro_torch.models.transformer import init_params

    cfg = get_config("phi4-mini-3.8b")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    attn, mlp = params["layers"]["attn"], params["layers"]["mlp"]
    weights = {name: quantization.quantize_model_weight(t[0]).q for name, t in (
        ("wq/wo", attn["wq"]), ("wk/wv", attn["wk"]), ("gate/up", mlp["gate"]),
        ("down", mlp["down"]))}
    del params, attn, mlp
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(4)
    dense_ms = {}  # the kernel's ms at each shape and N, by label
    for name, d_in, d_out, _ in projection_shapes(cfg)[:-1]:
        w = weights[name]
        if tuple(w.shape) != (d_out, d_in):
            raise AssertionError(f"brcr_gemm {name}: weight {tuple(w.shape)}")
        ops = prepare_brcr_operands(w)
        skipped, _ = brcr_skips(ops)
        wb = w.to(torch.bfloat16)
        for N in BRCR_COLS:
            label = f"{name} ({d_out} x {d_in}, N={N})"
            xi = torch.randint(-50, 50, (d_in, N), generator=gen, device=device).float()
            got = brcr_twice(label, ops, xi)
            err = check_brcr(label, got, brcr_gemm_ref(ops.group_idx, ops.plane_weights, xi,
                                                       ops.m), w, xi, exact=True)
            check_brcr(label, got, dense_ref(w, xi), w, xi, exact=True)
            floats = ""
            if N == BRCR_COLS[0]:
                for dt in (torch.float32, torch.bfloat16):
                    x = torch.randn((N, d_in), generator=gen, device=device).to(dt).T
                    got = brcr_twice(f"{label} {dt}", ops, x)
                    e = check_brcr(f"{label} {dt}", got, brcr_gemm_ref(
                        ops.group_idx, ops.plane_weights, x, ops.m), w, x, exact=False)
                    check_brcr(f"{label} {dt}", got, dense_ref(w, x), w, x, exact=False)
                    floats += f", {str(dt)[6:]} x max_abs_err {e:.3e}"
            xb = xi.to(torch.bfloat16)
            ms = time_ms(lambda: brcr_gemm(ops, xi), flush=flush)
            plain_ms = time_ms(lambda: brcr_gemm_ref(ops.group_idx, ops.plane_weights, xi,
                                                     ops.m), iters=3, flush=flush)
            lib_ms = time_ms(lambda: torch.matmul(wb, xb), flush=flush)
            dense_ms[label] = ms
            nbytes, adds = brcr_need(ops, xi)
            bound = max(nbytes / HBM_BYTES_PER_S, adds / PEAK_OPS["f32"]) * 1e3
            print(f"[kernel] brcr_gemm {label}: integer x exact (max_abs_err {err:.1e}"
                  f"{floats}); {100 * skipped:.1f}% of tiles skipped; kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes} B, {adds} adds), "
                  f"torch.matmul dense bf16 {lib_ms:.4f} ms")
        del ops, wb
        torch.cuda.empty_cache()

    # the skips: gate/up's weight with every other 128-row block and every
    # third 256-column block zeroed, so whole (plane, 128-row, 256-column)
    # tiles, and every plane of a zeroed row block, have no pattern
    w = weights["gate/up"].clone()
    M, H = w.shape
    w.view(M // 128, 128, H)[1::2] = 0
    w.view(M, H // 256, 256)[:, ::3] = 0
    ops = prepare_brcr_operands(w)
    tiles, planes = brcr_skips(ops)
    if not (tiles > 0 and planes > 0):
        raise AssertionError(f"brcr_gemm zeroed blocks: nothing to skip ({tiles}, {planes})")
    N = BRCR_COLS[1]
    label = f"gate/up, zeroed blocks ({M} x {H}, N={N})"
    xi = torch.randint(-50, 50, (H, N), generator=gen, device=device).float()
    got = brcr_twice(label, ops, xi)
    err = check_brcr(label, got, brcr_gemm_ref(ops.group_idx, ops.plane_weights, xi, ops.m),
                     w, xi, exact=True)
    check_brcr(label, got, dense_ref(w, xi), w, xi, exact=True)
    ms = time_ms(lambda: brcr_gemm(ops, xi), flush=flush)
    full = dense_ms[f"gate/up ({M} x {H}, N={N})"]
    print(f"[kernel] brcr_gemm {label}: integer x exact (max_abs_err {err:.1e}); "
          f"{100 * tiles:.1f}% of tiles and {100 * planes:.1f}% of (plane, 128-row block) "
          f"pairs skipped; kernel {ms:.4f} ms against {full:.4f} ms on the whole weight "
          f"({ms / full:.2f}x)")
    if not ms < full:
        raise AssertionError(f"brcr_gemm {label}: the skips saved no time")
    del ops, w
    torch.cuda.empty_cache()

    # m = 2 at wk/wv; a ragged shape at m = 4 and 2 (groups past a block,
    # H past a tile and not 16-byte aligned, N past an n-tile); integers of
    # 17 to 20 significant bits on a sparse weight (:func:`wide_ints`)
    cases = []
    w = weights["wk/wv"]
    for N in BRCR_COLS:
        cases.append((f"wk/wv, m 2 ({w.shape[0]} x {w.shape[1]}, N={N})", w, 2, N))
    w = weights["gate/up"][:1028, :3000].contiguous()
    for m in (4, 2):
        cases.append((f"ragged, m {m} ({w.shape[0]} x {w.shape[1]}, N=13)", w, m, 13))
    for label, w, m, N in cases:
        H = w.shape[1]
        xi = torch.randint(-50, 50, (H, N), generator=gen, device=device).float()
        line = f"integer x exact (max_abs_err {brcr_case(label, w, xi, m, exact=True):.1e})"
        if N != BRCR_COLS[1]:
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((N, H), generator=gen, device=device).to(dt).T
                e = brcr_case(f"{label} {dt}", w, x, m, exact=False)
                line += f", {str(dt)[6:]} x max_abs_err {e:.3e}"
        print(f"[kernel] brcr_gemm {label}: {line}; two launches bit-identical")
    w, xi = wide_ints(gen, 3072, 3072, BRCR_COLS[0], device)
    label = f"17-20-bit integer x, sparse weight (3072 x 3072, N={BRCR_COLS[0]})"
    row = (w.abs().float() @ xi.abs()).max().item()
    err = brcr_case(label, w, xi, 4, exact=True)
    print(f"[kernel] brcr_gemm {label}: exact (max_abs_err {err:.1e}; max Σ|w·x| {row:.0f} < "
          f"2^24; {int((w != 0).sum())} non-zeros); two launches bit-identical")
    del w, weights
    torch.cuda.empty_cache()


def paper_phase(device, flush):
    """The paper layer's path on the card: the quickstart at phi4-mini
    width (BRCR on an 8192 x 3072 weight, BSTC, BGPP over 1024 keys), the
    BGPP walkthrough at S 4096, and the batched predictor at the decode
    geometry followed by ``alive_to_topk_indices`` and ``gather_attend``.
    Each run zeroes the counts just before and asserts them just after:
    K7 once per ``brcr_matmul``, K6 once a predictor round, every other
    kernel 0.  Then times K7 on the quickstart's own operands for its JSON
    record.  Returns (the launches of both kernels over the path, K7's
    record)."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.core import bgpp
    from repro_torch.core.attention import decode_attend, gather_attend
    from repro_torch.examples import bgpp_sparse_attention as walk
    from repro_torch.examples import quickstart
    from repro_torch.kernels.brcr_gemm import brcr_gemm, prepare_brcr_operands
    from repro_torch.kernels.brcr_gemm.ref import brcr_gemm_ref

    t0 = time.perf_counter()
    total = {"bgpp_score": 0, "brcr_gemm": 0}

    def counted(what, want, fn):
        K.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        for name, n in got.items():
            if n != want.get(name, 0):
                raise AssertionError(f"paper layer, {what}: {name} launched {n} times, "
                                     f"expected {want.get(name, 0)}")
        for name in total:
            total[name] += got[name]
        print(f"[paper] {what}: launches {want}")
        return out

    print("[paper] quickstart at phi4-mini width:")
    res = counted("quickstart", {"brcr_gemm": 1, "bgpp_score": 4},
                  lambda: quickstart.main(device=device))
    w_np, x_np = res["w_int8"], res["x"]
    row = np.abs(w_np.astype(np.float64)) @ np.abs(x_np.astype(np.float64))
    if not (res["brcr_y"] == res["brcr_ref"])[row < 2 ** 24].all() or not res["bstc_lossless"]:
        raise AssertionError("quickstart: BRCR is not exact or BSTC not lossless")
    print(f"[paper] quickstart: BRCR equal to the int64 product on every row "
          f"(max Σ|w·x| {row.max():.0f} < 2^24: {bool(row.max() < 2 ** 24)})")
    print("[paper] BGPP walkthrough at S 4096:")
    n_rounds = len(walk.ALPHAS) * sum(walk.ROUNDS) + 7
    counted("bgpp_sparse_attention", {"bgpp_score": n_rounds}, lambda: walk.main(device=device))

    dg = DECODE_GEOMETRY
    q_np, k_np = decode_keys(5, **dg)
    B, Hq, Hk, S, D = dg["B"], dg["Hq"], dg["Hk"], dg["S"], dg["D"]
    sign, planes = walk.key_planes(k_np, device)
    q = torch.from_numpy(q_np).to(device)
    scale = 1.0 / (KEY_SCALE * KEY_SCALE * np.sqrt(D))
    k_max = S // 4
    gen = torch.Generator(device=device).manual_seed(6)
    kc = torch.from_numpy(k_np).to(device).float() / KEY_SCALE
    vc = torch.randn(kc.shape, generator=gen, device=device)
    qf = q.float() / KEY_SCALE

    def decode():
        alive, est = bgpp.bgpp_predict_batched(q, planes, sign, bgpp.BGPPConfig(),
                                               logit_scale=scale)
        est_kv = est.reshape(B, Hk, Hq // Hk, S).amax(2)
        idx, ok = bgpp.alive_to_topk_indices(alive, est_kv, k_max)
        return alive, gather_attend(qf, kc, vc, idx, ok)

    alive, out = counted("bgpp_predict_batched (B 4, Hq 24, Hk 8, S 1024) + gather_attend",
                         {"bgpp_score": bgpp.BGPPConfig().rounds}, decode)
    kept = alive.sum(-1)
    if tuple(out.shape) != (B, Hq, D) or not bool(torch.isfinite(out).all()):
        raise AssertionError("gather_attend: output malformed")
    msg = f"keys kept per (slot, kv head) {int(kept.min())}-{int(kept.max())} of {S}"
    if int(kept.max()) <= k_max:  # the gathered set is the whole alive set
        dense = decode_attend(qf, kc, vc, torch.ones((B, S), dtype=torch.bool, device=device),
                              head_mask=alive)
        # the same softmax over the same keys, its logits rounded in another
        # order: exp turns a logit's rounding (~u |s|) into a relative error
        logit = torch.einsum("bhgd,bshd->bhgs", qf.reshape(B, Hk, -1, D), kc).abs().max()
        tol = 1e-6 * max(1.0, logit.item() * D ** -0.5) * vc.abs().max().item()
        diff = (out - dense).abs().max().item()
        if not diff <= tol:
            raise AssertionError(f"gather_attend differs from decode_attend by {diff:.3e} "
                                 f"> {tol:.3e}")
        msg += (f"; gather_attend within {diff:.2e} of decode_attend on the alive sets "
                f"(tolerance {tol:.2e}: 1e-6 x max |logit| x max |v|)")
    print(f"[paper] {msg}")
    print(f"[paper] phase took {time.perf_counter() - t0:.2f} s (examples included)")

    w = torch.from_numpy(w_np).to(device)
    x = torch.from_numpy(x_np).to(device).float()
    ops = prepare_brcr_operands(w)
    plain = lambda: brcr_gemm_ref(ops.group_idx, ops.plane_weights, x, ops.m)
    err = check_brcr("quickstart", brcr_gemm(ops, x), plain(), w, x, exact=True)
    wb, xb = w.to(torch.bfloat16), x.to(torch.bfloat16)
    nbytes, adds = brcr_need(ops, x)
    k7 = kernel_record(
        "brcr_gemm", "src/repro_torch/csrc/brcr_gemm.cu",
        "src/repro/kernels/brcr_gemm/kernel.py:88", err,
        time_ms(lambda: brcr_gemm(ops, x), flush=flush), time_ms(plain, iters=3, flush=flush),
        nbytes, adds, "f32", time_ms(lambda: torch.matmul(wb, xb), flush=flush),
        label=f" quickstart ({ops.M} x {ops.H}, N={x.shape[1]})")
    return total, k7


def _device_ms(fn, calls, l2, tries: int = 3):
    """Device ms a call of ``fn`` over one ``torch.profiler`` trace of
    ``calls`` calls, ``l2`` zeroed before each (the flush kernels left
    out), and the kernels the trace recorded.  A trace that recorded no
    device time of ``fn`` is taken again, up to ``tries`` times, and then
    :func:`_ms_a_call` times it by CUDA events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                l2.zero_()
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and "FillFunctor" not in e.key and e.self_device_time_total > 0]
        if dev:
            break
    return _ms_a_call(dev, fn, calls, flush=l2.zero_, key=32)


def brcr_device_phase(device, calls: int = 10) -> None:
    """K7 against a bf16 ``torch.matmul`` of the dense weight on device
    time (:func:`_device_ms`, L2 flushed before each call: every pattern
    byte is read cold): the quickstart's own operands (8192 x 3072, N 16,
    integer x in f32), then each projection shape of one phi4-mini-3.8b
    layer (layer 0's seeded weights, as :func:`brcr_kernel_phase`) at N 4,
    16 and 128 with f32 integer x in [-50, 50) (one bf16 term a tile),
    f32 Gaussian x (three terms) and bf16 Gaussian x, and the plan of each.
    Run after the serving runs are timed: a trace slows the process's
    later host work."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import quantization
    from repro_torch.examples import quickstart
    from repro_torch.kernels.brcr_gemm import brcr_gemm, prepare_brcr_operands
    from repro_torch.kernels.brcr_gemm import ops as brcr_ops
    from repro_torch.models.transformer import init_params

    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    M, H = quickstart.full_width_shape()
    rng = np.random.default_rng(0)  # the quickstart's weight and x
    w = torch.from_numpy(quickstart.synthetic_llm_weight(rng, (M, H))).to(device)
    w = quantization.quantize_weight(w).q
    x = torch.from_numpy(rng.integers(-50, 50, size=(H, 16))).to(device).float()
    cases = [("quickstart", w, {"f32 integer": x})]
    cfg = get_config("phi4-mini-3.8b")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    attn, mlp = params["layers"]["attn"], params["layers"]["mlp"]
    for name, t in (("wq/wo", attn["wq"]), ("wk/wv", attn["wk"]), ("gate/up", mlp["gate"]),
                    ("down", mlp["down"])):
        cases.append((name, quantization.quantize_model_weight(t[0]).q, None))
    del params, attn, mlp
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(7)
    for name, w, xs in cases:
        ops = prepare_brcr_operands(w)
        wb = w.to(torch.bfloat16)
        for N in ((16,) if xs else (4, 16, 128)):
            if xs is None:
                H = w.shape[1]
                xs = {"f32 integer": torch.randint(-50, 50, (H, N), generator=gen,
                                                   device=device).float(),
                      "f32": torch.randn((H, N), generator=gen, device=device),
                      "bf16": torch.randn((H, N), generator=gen, device=device).bfloat16()}
            line = []
            for kind, x in xs.items():
                ms, rec = _device_ms(lambda: brcr_gemm(ops, x), calls, l2)
                line.append(f"{kind} x {ms:.4f} ms")
            x = next(iter(xs.values()))
            xb = x.to(torch.bfloat16)
            lib, _ = _device_ms(lambda: torch.matmul(wb, xb), calls, l2)
            geo = brcr_ops._validate_cuda(ops, x)
            print(f"[kernel] brcr_gemm {name} ({w.shape[0]} x {w.shape[1]}, N={N}) device time "
                  f"(torch.profiler, {calls} calls each, L2 flushed): {'; '.join(line)}; bf16 "
                  f"torch.matmul {lib:.4f} ms; plan C {geo.C}, T {geo.T}, grid {geo.grid}, "
                  f"{geo.NB} columns a block; recorded: {rec}")
            xs = None
        del ops, wb
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# main path: full-width phi4-mini-3.8b behind the port's Scheduler
# ---------------------------------------------------------------------------

KERNEL_OF = {"bf16": "paged_flash_decode_bf16", "int8": "paged_flash_decode_int8",
             "bgpp": "bgpp_paged_attend"}
# the CUDA function each KV format's decode attend launches, as a trace names it
BODY_OF = {"bf16": "dense_kernel", "int8": "int8_kernel", "bgpp": "bgpp_kernel"}


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


def profile_decode(sched, reqs, label: str, steps: int = 4, top: int = 8):
    """Admit ``reqs`` until every slot decodes, then trace ``steps`` steady
    decode steps with ``torch.profiler`` (:func:`_traced`); returns the
    trace's device events."""
    import torch

    for r in reqs:
        sched.submit(r)
    for _ in range(128):
        if all(s.state.value == "decoding" for s in sched.slots):
            break
        sched.step()
    else:
        raise AssertionError("profile_decode: the slots never all decoded")
    torch.cuda.synchronize()
    return _traced(lambda: [sched.step() for _ in range(steps)],
                   f"{label}: {steps} steady decode steps", top=top)


def _traced(fn, what: str, tries: int = 2, top: int = 8):
    """Run ``fn`` once under ``torch.profiler``: print the device's busy
    share of the wall time and the device time by kernel (top 8), and
    return the device-side events.  Only device-side events count (a CPU
    op's row repeats its kernels' time).  The tracer now and then records
    no device event at all: such a trace is taken again, up to ``tries``
    times (every caller's ``fn`` can simply be repeated: a pure call, an
    admission into the same slot, or more steady decode steps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = lambda e: e.self_device_time_total
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(t(e) for e in dev)
        if busy > 0 or attempt + 1 == tries:
            break
        print(f"[profile] {what}: the trace recorded no device time; tracing again")
    print(f"[profile] {what}: device busy {busy / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms wall ({100 * busy / wall_us:.1f}%; the tracer's "
          f"own host cost lengthens the wall)")
    for e in sorted(dev, key=t, reverse=True)[:top]:
        print(f"[profile]   {t(e) / 1e3:8.3f} ms {100 * t(e) / busy:5.1f}% {e.count:5d} "
              f"calls  {e.key[:80]}")
    return dev


def _ms_a_call(dev, fn, calls: int, flush=None, key: int = 40):
    """Device ms a call from ``dev``, a trace's device events over
    ``calls`` calls of ``fn`` (the sum over its kernels of each one's mean
    device time), and the kernels it recorded.  Late in a long run the
    tracer has recorded no device event at all on every try of a short
    trace (K5's 20 calls, ~3 ms): then ``fn`` is timed by CUDA events
    instead (:func:`time_ms` over ``calls`` calls, ``flush()`` between
    them, outside the timed span), and the record says so."""
    if sum(e.self_device_time_total for e in dev) > 0:
        return (sum(e.self_device_time_total / e.count for e in dev) / 1e3,
                ", ".join(f"{e.count} x {e.key[:key]}" for e in dev))
    return (time_ms(fn, iters=calls, flush=flush),
            "no device event traced, timed by CUDA events")


def profile_admission(sched, prompt, label: str, top: int = 8):
    """Trace one eager admission (``engine.prefill_into_slot``, a whole-
    prompt forward) into slot 0 of an idle scheduler, after one untraced
    warm-up, and release its pages after; returns the trace's device
    events."""
    import numpy as np
    import torch

    from repro_torch.serving import engine

    tokens = torch.as_tensor(np.asarray(prompt, np.int64), device=sched.device)
    sched._ensure_pages(0, 0, len(prompt))
    admit = lambda: engine.prefill_into_slot(sched.params, sched.cfg, sched.layout,
                                             sched.cache, 0, tokens)
    admit()
    torch.cuda.synchronize()
    dev = _traced(admit, f"{label}: one eager admission ({len(prompt)} prompt tokens)",
                  top=top)
    sched._release_pages(0)
    return dev


def coded_planes_of_first_matrix(wq, cfg) -> int:
    """Coded planes of the first matrix the serve path codes (layer 0 of
    the stacked ``wq`` leaf), encoded here on its own: the launches the
    round-trip check owes the plane decode kernel."""
    from repro_torch.core import bstc
    from repro_torch.serving import weights

    rec = weights.quantize(wq[0])
    bw = bstc.encode_weight(rec["q"].T.contiguous(), rec["scale"], m=cfg.mcbp.group_size,
                            threshold=cfg.mcbp.bstc_threshold)
    return sum(e is not None for e in bw.encoded)


def weight_set_bytes(tree) -> int:
    """Device bytes of one weight set: every tensor it holds once, a BSTC
    operand record at the bytes its arrays occupy."""
    import torch

    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif torch.is_tensor(x):
            if x.data_ptr() not in seen:
                seen.add(x.data_ptr())
                total += x.numel() * x.element_size()
        elif hasattr(x, "stored_bytes") and id(x) not in seen:
            seen.add(id(x))
            total += x.stored_bytes

    walk(tree)
    return total


# (KV format, weight format, admission) of each main-path run
SERVE_RUNS = (("bf16", "bf16", "chunked"), ("int8", "bf16", "chunked"),
              ("bgpp", "bf16", "chunked"), ("bgpp", "bstc", "chunked"),
              ("bf16", "bf16", "eager"))
# the runs trace_phase traces: SERVE_RUNS but int8 KV (its step is bf16's
# but K1's body) and bgpp KV on bf16 weights (its K2 is traced in the bstc
# run's step), both cut for the whole script's time
TRACE_RUNS = tuple(r for r in SERVE_RUNS if r[0] != "int8" and r[:2] != ("bgpp", "bf16"))
# (KV format, weight format) of each speculative run: chunked, paged, the
# main trace, gamma 4 drafts from 4 kept planes; each is held to the
# non-speculative run of the same formats
SPEC_RUNS = (("bf16", "bf16"), ("bgpp", "bstc"))
SPEC_GAMMA, SPEC_PLANES = 4, 4
# the main trace: 6 Poisson requests of 64..512 prompt tokens, 16 new each
MAIN_TRACE = dict(seed=0, n=6, lo=64, hi=512, new=16)
# gemma3-4b's trace: prompts past its 1024-lane window, so every ring wraps
# in prefill and every eager admission's sliding windows cut; max_seq 4096
GEMMA_ARCH, GEMMA_TRACE, GEMMA_MAX_SEQ = "gemma3-4b", dict(seed=0, n=6, lo=1100, hi=2000,
                                                           new=16), 4096
# its depth in the serving runs and the traces, cut from 34 to 6 layers
# (layer 5 global, 5 rings) to keep the whole script near its time beside
# the ssm, long_500k, whisper and sharded phases; width, rings, heads and
# trace stay
GEMMA_DEPTH = 6
# deepseek-7b (an untied head, g 1): one chunked bf16-KV run, 3 requests
DEEPSEEK_ARCH, DEEPSEEK_TRACE = "deepseek-7b", dict(seed=0, n=3, lo=64, hi=512, new=16)
# the MoE family at full width, depth cut to fit one card: llama4-scout
# (16 experts top-1, a shared expert, the 202048-row head; layers 0-2
# chunked-local rings of min(8192, max_seq) lanes, 3 global; g 5) in three
# runs, and mixtral-8x22b (8 experts top-2; both layers sliding-window
# rings: no global layer, no page pool) once.  llama4-scout's depth was cut
# from 8 to 4 layers (10.9 B parameters, 19.7 B at 8) to make room for the
# sharded Scheduler's runs beside its unsharded ones and for the sharded
# MoE train step's phase in the script's time
LLAMA4_ARCH, LLAMA4_DEPTH = "llama4-scout-17b-a16e", 4
LLAMA4_TRACE = dict(seed=0, n=6, lo=201, hi=450, new=16)
LLAMA4_RUNS = (("bf16", "bf16", "chunked"), ("bgpp", "bstc", "chunked"),
               ("bf16", "bf16", "eager"))
# llama4-scout's runs through a sharded Scheduler over an NCCL world of one
# (ROADMAP item 7c-i), each held to the unsharded run of its formats: bstc
# weights + bgpp KV, chunked (the MoE dropless on the rank's slots), and
# bf16 eager (the forward at capacity factor 1.25 on the rank's heads)
LLAMA4_SHARDED_RUNS = (("bgpp", "bstc", "chunked", "paged"), ("bf16", "bf16", "eager", "paged"))
MIXTRAL_ARCH, MIXTRAL_DEPTH = "mixtral-8x22b", 2
MIXTRAL_TRACE = dict(seed=0, n=3, lo=201, hi=450, new=16)
MIXTRAL_RUNS = (("int8", "bf16", "chunked"),)
# K5 at llama4-scout's heads past its attention chunk
LLAMA4_CHUNK, LLAMA4_FLASH_S = 8192, 8448
# the VLM family at full width and depth: paligemma-3b (18 layers, all
# global; 8/1 heads of 256; GeGLU d_ff 16384; the tied 257216-row head) on
# the main trace in three runs, once at max_seq 32768 with two prompts of
# 12,000-16,000 tokens and bgpp KV (K2 past its old 10,792-lane cap at
# g 8, D 256), and one eager admission with a 256-patch image prefix
PALI_ARCH = "paligemma-3b"
PALI_RUNS = (("bf16", "bf16", "chunked"), ("int8", "bf16", "chunked"),
             ("bgpp", "bstc", "chunked"))
PALI_LONG_RUNS = (("bgpp", "bf16", "chunked"),)
PALI_SHARDED_RUNS = (("bf16", "bf16", "chunked", "paged"),)  # through a sharded Scheduler
PALI_LONG_TRACE, PALI_LONG_SEQ = dict(seed=0, n=2, lo=12000, hi=16000, new=8), 32768
PALI_PROMPT, PALI_DECODES = 300, 8  # the vision prefill's text prompt, its decode steps


def free_device() -> None:
    """Collect the garbage (a Scheduler whose steps are wrapped for timing
    sits in a reference cycle) and return the cached blocks, so each run's
    peak memory is its own."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _tree_map(fn, tree):
    """``fn`` of each tensor of a parameter tree (the same nesting)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_to(tree, device):
    """A parameter tree's tensors on ``device`` (the same nesting)."""
    return _tree_map(lambda t: t.to(device), tree)


def init_model(arch, device, depth=None, experts=None):
    """``arch`` at full width in bf16, at full depth or cut to ``depth``
    layers (and to ``experts`` experts a MoE layer, top-k kept), random
    weights from seed 0 on the card; prints its size, its cuts and the
    seconds it took."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo

    cfg = get_config(arch)
    full, all_experts = cfg.num_layers, cfg.num_experts
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    if experts is not None:
        cfg = dataclasses.replace(cfg, num_experts=experts)
    t0 = time.perf_counter()
    params = model_zoo.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    nparam = sum(t.numel() for t in _leaves(params))
    kinds = [cfg.layer_attn_window(i) for i in range(cfg.num_layers)]
    n_local = sum(kind != "causal" for kind, _ in kinds)
    local = next((f"chunked, chunk {w}" if kind == "chunked" else f"sliding window {w}"
                  for kind, w in kinds if kind != "causal"), "")
    lay = (f"{cfg.num_layers} layers ({cfg.num_layers - n_local} global, {n_local} local: "
           f"{local})" if n_local else f"{cfg.num_layers} layers")
    if cfg.num_layers != full:
        lay += f", depth cut from {full}"
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        print(f"[serve] {cfg.name}: {cfg.num_layers} mamba2 layers, d_model {cfg.d_model}, "
              f"d_inner {d_in} = {d_in // cfg.ssm_head_dim} heads of {cfg.ssm_head_dim}, "
              f"state {cfg.ssm_state}, conv {cfg.ssm_conv}, vocab {cfg.vocab_size}, tied "
              f"head, {nparam / 1e9:.3f} B params ({cfg.dtype}) initialised on the card in "
              f"{time.perf_counter() - t0:.2f} s")
        return cfg, params
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * cfg.d_model
        L = cfg.num_layers
        n_attn = sum(cfg.layer_is_attention(i) for i in range(L))
        n_moe = sum(cfg.layer_is_moe(i) for i in range(L))
        print(f"[serve] {cfg.name}: {L} layers (depth cut from {full}: {L - n_attn} mamba2 "
              f"mixers, d_inner {d_in} = {d_in // cfg.ssm_head_dim} heads of "
              f"{cfg.ssm_head_dim}, state {cfg.ssm_state}; {n_attn} attention, "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, no RoPE; {n_moe} "
              f"MoE FFNs of {cfg.num_experts} experts (cut from {all_experts}) of d_ff "
              f"{cfg.d_ff}, top-{cfg.experts_per_token}; {L - n_moe} dense MLPs), d_model "
              f"{cfg.d_model}, vocab {cfg.vocab_size}, untied head, {nparam / 1e9:.3f} B "
              f"params ({cfg.dtype}, {nparam * 2 / 2**30:.2f} GiB) initialised on the card "
              f"in {time.perf_counter() - t0:.2f} s")
        return cfg, params
    if cfg.family == "enc_dec":
        print(f"[serve] {cfg.name}: {cfg.encoder_layers} encoder + {cfg.num_layers} decoder "
              f"layers (every decoder layer global), d_model {cfg.d_model}, {cfg.num_heads}/"
              f"{cfg.num_kv_heads} heads of {cfg.head_dim}, GELU d_ff {cfg.d_ff}, layer norms, "
              f"{cfg.encoder_seq} frames of {cfg.d_audio}, vocab {cfg.vocab_size}, tied head, "
              f"{nparam / 1e9:.3f} B params ({cfg.dtype}) initialised on the card in "
              f"{time.perf_counter() - t0:.2f} s")
        return cfg, params
    ffn = f"d_ff {cfg.d_ff}"
    if cfg.num_experts:
        ffn = (f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, top-{cfg.experts_per_token}"
               + (f", a shared expert of {cfg.moe_shared_ff}" if cfg.moe_shared_ff else ""))
    print(f"[serve] {cfg.name}: {lay}, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, {ffn}, vocab "
          f"{cfg.vocab_size}, {'tied' if cfg.tie_embeddings else 'untied'} head, "
          f"{nparam / 1e9:.3f} B params ({cfg.dtype}) initialised on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    return cfg, params


def serve_runs(cfg, params, runs, trace_kw, max_seq, device, card, k3_per_step=None,
               slots=4, rules=None):
    """Serve ``cfg`` in the paged layout (``slots`` slots, page 16, chunk
    budget 128) once per ``(KV format, weight format, admission)`` of ``runs`` on
    the trace ``trace_kw`` (a run's fourth entry, where it has one, names
    its layout; ``rules``: a sharded Scheduler's serving rules); every count
    zeroed just before the Scheduler is
    built and read just after the run.  Each run must finish every request
    with well-formed logits, leak no page (a stack of rings only has no
    pool) and launch each kernel exactly as often as its path needs: K1 or
    K2 once per global layer a decode step, K3 once per converted matrix a
    decode step (7L + 1 for a dense model, 4L + 1 for an MoE one, whose
    experts stay raw) and K4 once per coded plane of the first coded
    matrix with bstc weights, K5 L times an eager admission, nothing else
    (the local layers' ring attends and the MoE's experts are plain
    PyTorch).  ``k3_per_step``, where given, is the converted matrices a
    decode step the weight plan must hold (the reference's ``_iter_targets``
    count).  Returns the
    launches of each kernel on its own run (the decode attends on their KV
    format's chunked bf16-weight run, the BSTC kernels on the bstc run,
    flash attention on the eager run) and each run's outcome: its greedy
    tokens and logit rows by request, its wall seconds and its steps."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.serving import engine, kv_cache as kvc, sharded as shd
    from repro_torch.serving.scheduler import Scheduler

    L = cfg.num_layers
    launches, outcome, first_logits = {}, {}, {}
    for key in runs:
        fmt, wfmt, admission = key[:3]
        kind = key[3] if len(key) > 3 else "paged"
        mesh = "" if rules is None else "mesh %dx%d " % shd.mesh_shape(rules)
        run = f"{cfg.name} {mesh}{fmt}/{wfmt}/{admission}/{kind}"
        layout = kvc.layout_for(cfg, slots, max_seq, kv_format=fmt, layout=kind,
                                page_size=16)
        G = len(layout.global_layers)
        free_device()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        sched = Scheduler(params, cfg, layout, device=device, admission=admission,
                          chunk_budget=128, record_logits=True, weight_format=wfmt,
                          rules=rules)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        dec, pre = [], []
        prefill_k3 = [0]
        sched.serve_step = _timed(sched.serve_step, dec)
        eager = admission == "eager"
        # prefill is timed (and checked for K3 launches) around each chunk,
        # or around each whole-prompt forward of eager admission
        admit_fn = engine.prefill_into_slot
        prefill_fn = _timed(admit_fn if eager else sched.chunked._chunk, pre)

        def counted_prefill(*a, **kw):
            before = K.LAUNCHES["bstc_matmul"]
            out = prefill_fn(*a, **kw)
            prefill_k3[0] += K.LAUNCHES["bstc_matmul"] - before
            return out

        if eager:
            engine.prefill_into_slot = counted_prefill
        else:
            sched.chunked._chunk = counted_prefill
        reqs = trace(vocab=cfg.vocab_size, **trace_kw)
        for r in reqs:
            sched.submit(r)
        try:
            stats = sched.run()
        finally:
            engine.prefill_into_slot = admit_fn
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        steps = sched.decode_steps
        want = {name: 0 for name in got}
        want[KERNEL_OF[fmt]] = G * steps
        if eager:
            want["flash_attention"] = L * len(reqs)
        if wfmt == "bstc":
            per_step = sum(e.copies for e in sched.weight_plan.entries)
            if k3_per_step is not None and per_step != k3_per_step:
                raise AssertionError(f"{run}: the weight plan converts {per_step} matrices a "
                                     f"step, expected {k3_per_step}")
            want["bstc_matmul"] = per_step * steps
            want["bstc_decode"] = coded_planes_of_first_matrix(params["layers"]["attn"]["wq"],
                                                               cfg)
            if want["bstc_decode"] < 1:
                raise AssertionError("bstc: the first coded matrix coded no plane")
        for name, n in got.items():
            if n != want[name]:
                raise AssertionError(f"{run}: {name} launched {n} times, "
                                     f"expected {want[name]}")
        if prefill_k3[0]:
            raise AssertionError(f"bstc_matmul launched {prefill_k3[0]} times in prefill")
        for name, n in got.items():
            if eager:
                if name == "flash_attention":
                    launches[name] = n
            elif n and (wfmt == "bstc") == name.startswith("bstc_"):
                launches[name] = n
        if stats["finished_requests"] != len(reqs):
            raise AssertionError(f"{run}: {stats['finished_requests']} of "
                                 f"{len(reqs)} finished")
        if sched.pager is not None:
            sched.pager.check()
            if sched.pager.pages_in_use:
                raise AssertionError(f"{run}: {sched.pager.pages_in_use} pages leaked")
        new = trace_kw["new"]
        for r in sched.finished:
            rows = np.stack(r.logit_rows)
            if (len(r.generated) != r.max_new_tokens or rows.shape != (new, cfg.vocab_size)
                    or not np.isfinite(rows).all()):
                raise AssertionError(f"{run}: request {r.rid} output is malformed")
        if key == runs[0]:
            first_logits = {r.rid: r.logit_rows[0] for r in sched.finished}
        outcome[key] = {
            "tokens": {r.rid: list(r.generated) for r in sched.finished},
            "logits": {r.rid: np.stack(r.logit_rows) for r in sched.finished},
            "wall_s": stats["wall_s"], "steps": sched.step_count}
        dec_ms = [a.elapsed_time(b) for a, b in dec]
        pre_ms = [a.elapsed_time(b) for a, b in pre]
        kv, wr = stats["kv_read"], stats["weight_read"]
        counts = ", ".join(f"{n} {v}" for n, v in got.items() if v)
        if eager:
            scale = max(float(np.abs(first_logits[r.rid]).max()) for r in sched.finished)
            diff = max(float(np.abs(r.logit_rows[0] - first_logits[r.rid]).max())
                       for r in sched.finished)
            same = sum(r.generated[0] == int(np.argmax(first_logits[r.rid]))
                       for r in sched.finished)
            print(f"[serve] {cfg.name} eager admission: {len(pre_ms)} whole-prompt forwards, "
                  f"{np.mean(pre_ms):.3f} ms per admission (prompts "
                  f"{min(r.prompt_len for r in reqs)}-{max(r.prompt_len for r in reqs)} "
                  f"tokens); first-token logits vs the chunked {runs[0][0]} run: max |diff| "
                  f"{diff:.4e} = {diff / scale:.4e} of max |logit| {scale:.4e}; the same "
                  f"first token in {same} of {len(reqs)} requests")
        print(f"[serve] {cfg.name} {mesh}{fmt} {kind}, {wfmt} weights, {admission} admission: "
              f"{stats['finished_requests']} requests (prompts "
              f"{min(r.prompt_len for r in reqs)}-{max(r.prompt_len for r in reqs)} tokens), "
              f"{stats['decoded_tokens']} tokens, {steps} decode steps, "
              f"{len(pre_ms)} prefill {'forwards' if eager else 'chunks'} in "
              f"{stats['wall_s']} s = "
              f"{stats['tokens_per_s']} tok/s; decode {np.mean(dec_ms):.3f} ms/step, "
              f"prefill {np.mean(pre_ms):.3f} ms/{'forward' if eager else 'chunk'}; kv_read "
              f"{kv['decode_bytes_per_step']} B/step, weight_read "
              f"{wr['decode_bytes_per_step']} B/step (bf16-equivalent "
              f"{wr['decode_bf16_equiv_bytes_per_step']}, modeled "
              f"{wr['modeled_bytes_per_step']}); serve-params prepare {prep_s:.2f} s; "
              f"ttft p50 {stats['ttft_s']['p50']} s, itl p50 {stats['itl_s']['p50']} s; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"pages_in_use 0{'' if sched.pager else ' (no global layer: no pool)'}; "
              f"launches: {counts or 'none'} ({G} global of {L} layers x {steps} "
              f"steps) [{card}]")
        del sched
        free_device()
    return launches, outcome


def serve_phase(device, card):
    """Serve full phi4-mini-3.8b for every run of :data:`SERVE_RUNS`
    (:func:`serve_runs`), then through a sharded Scheduler for every run of
    :data:`SHARDED_RUNS` (:func:`sharded_serve`), then speculatively for every run of
    :data:`SPEC_RUNS`, then through the asyncio front door
    (:func:`server_phase`); return the launches of each kernel on its own
    run, the front door's decode attends added."""
    cfg, params = init_model("phi4-mini-3.8b", device)
    launches, outcome = serve_runs(cfg, params, SERVE_RUNS, MAIN_TRACE, 1024, device, card)
    for name, n in sharded_serve(cfg, params, outcome, device, card).items():
        launches[name] = launches.get(name, 0) + n
    for fmt, wfmt in SPEC_RUNS:
        spec_run(params, cfg, fmt, wfmt, outcome[(fmt, wfmt, "chunked")]["tokens"], device,
                 card)
    for name, n in server_phase(cfg, params, outcome, device, card).items():
        launches[name] = launches.get(name, 0) + n
    del params
    free_device()
    return launches


# ---------------------------------------------------------------------------
# sharded serving (ROADMAP item 7a): a mesh over torch.distributed
# ---------------------------------------------------------------------------

# (KV format, weight format, admission, layout) of each run through a sharded
# Scheduler over an NCCL world of one on phi4-mini-3.8b's main trace; each is
# held to the unsharded run of its formats and admission (the int8 slot run
# to the paged one: slot = paged bit for bit); the eager run's admissions
# are the sharded forward on the rank's heads (K5) and the owner's broadcast.
# The bf16 and bgpp paged chunked runs on bf16 weights were cut for the whole
# script's time: the eager run decodes through K1 bf16 on pages, the bstc
# run through K2 on pages, the int8 slot run takes chunked admission
SHARDED_RUNS = (("int8", "bf16", "chunked", "slot"), ("bgpp", "bstc", "chunked", "paged"),
                ("bf16", "bf16", "eager", "paged"))
# the meshes whose ranks' decode launches run one after another on one card
SHARD_MESHES = ((2, 1), (1, 4), (2, 4))


def start_world():
    """A ``torch.distributed`` world of one (NCCL) over a file store under
    ``build/`` (no port); False where a world is already up."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    root = os.path.join(ROOT, "build", "dist")
    os.makedirs(root, exist_ok=True)
    store = os.path.join(tempfile.mkdtemp(dir=root), "store")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    return True


def sharded_serve(cfg, params, outcome, device, card, runs=SHARDED_RUNS, trace_kw=MAIN_TRACE):
    """Serve ``trace_kw`` for every run of ``runs`` (phi4-mini-3.8b's
    :data:`SHARDED_RUNS` on :data:`MAIN_TRACE` by default) through a
    Scheduler with ``rules_for(1, 1)`` over an NCCL world of one
    (:func:`serve_runs`: the same launch counts and checks): the layers'
    collectives run through NCCL whatever the group's size.  Tokens must be
    identical and logits bit-identical to the unsharded run of the same
    formats in ``outcome``.  The default runs also time one collective
    (:func:`collective_cost`).  Returns the launches of each kernel."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.serving import sharded as shd

    started = start_world()
    try:
        rules = shd.rules_for(1, 1, "cuda")
        launches, got = serve_runs(cfg, params, runs, trace_kw, 1024, device, card,
                                   rules=rules)
        if runs is SHARDED_RUNS:
            collective_cost(rules, device, card)
    finally:
        if started:
            dist.destroy_process_group()
    for key in runs:
        want, have = outcome[key[:3]], got[key]
        if have["tokens"] != want["tokens"]:
            raise AssertionError(f"sharded {key}: tokens differ from the unsharded run")
        diff = max(float(np.abs(have["logits"][r] - want["logits"][r]).max())
                   for r in want["logits"])
        if diff:
            raise AssertionError(f"sharded {key}: logits differ from the unsharded run by "
                                 f"up to {diff:.3e}")
        print(f"[sharded] {cfg.name} mesh 1x1 over NCCL (world of one), {key[0]} {key[3]} KV, "
              f"{key[1]} weights, {key[2]} admission: {len(want['tokens'])} requests, tokens "
              f"identical and logits bit-identical to the unsharded {key[0]} paged "
              f"{key[2]} run; {have['steps']} steps in {have['wall_s']} s (unsharded "
              f"{want['wall_s']} s) [{card}]")
    return launches


def sharded_decode_check(cfg, decode, want, what, card):
    """ROADMAP item 7c-ii served: ``decode(rules, spans, rows)`` (a
    ``make_serve_step`` run from a zero state returning each slot's
    tokens) once more under ``rules_for(1, 1)`` over an NCCL world of one
    (the mixers, or whisper's heads and cross memory, split; every
    collective a group of one) against
    the unsharded run ``want`` = ``(rows (steps, B, V), tokens, ms a step,
    launches)``: tokens identical, every step's logits bit-identical, the
    same kernel launches.  Prints ms a step for both and the collectives a
    step (``sharding.all_gather`` carries every one).  Returns the
    sharded run's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.distributed import sharding as sh
    from repro_torch.serving import sharded as shd

    want_rows, want_gen, want_ms, want_launches = want
    started = start_world()
    calls, real = [], sh.all_gather
    sh.all_gather = lambda x, group, dim=0: calls.append(1) or real(x, group, dim)
    try:
        spans, rows = [], []
        K.reset_launches()
        t0 = time.perf_counter()
        gen = decode(shd.rules_for(1, 1, "cuda"), spans, rows)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in K.LAUNCHES.items() if v}
    finally:
        sh.all_gather = real
        if started:
            dist.destroy_process_group()
    got = torch.stack(rows)
    if gen != want_gen:
        raise AssertionError(f"sharded {cfg.name} {what}: tokens differ from the unsharded run")
    if got.shape != want_rows.shape or not torch.equal(got, want_rows):
        diff = (float((got - want_rows).abs().max()) if got.shape == want_rows.shape
                else got.shape)
        raise AssertionError(f"sharded {cfg.name} {what}: logits differ from the unsharded run "
                             f"({diff})")
    if launched != want_launches:
        raise AssertionError(f"sharded {cfg.name} {what}: launches {launched}, unsharded "
                             f"{want_launches}")
    ms = np.mean([a.elapsed_time(b) for a, b in spans])
    tag, cut = (("sharded-encdec", "heads and the cross memory split") if cfg.family == "enc_dec"
                else ("sharded-ssm", "mixers split by heads"))
    print(f"[{tag}] {cfg.name} {what} through make_serve_step on a 1x1 mesh over NCCL "
          f"(world of one; {cut}): {len(spans)} steps of {got.shape[1]} slots, "
          f"tokens identical and every step's logits bit-identical to the unsharded run; "
          f"launches {launched or 'none'} as unsharded; {ms:.3f} ms a step (unsharded "
          f"{want_ms:.3f}; CUDA events), {len(calls) / len(spans):.0f} collectives a step, "
          f"{wall:.2f} s [{card}]")
    del got, rows
    return launched


def collective_cost(rules, device, card, calls=200) -> None:
    """What one all-gather of a decode step costs on this world: the
    heads' attend outputs of phi4-mini's decode (4 x 24 x 128 f32) through
    ``sharding.all_gather`` and through ``all_gather_into_tensor`` alone,
    host microseconds a call (``calls`` enqueued, then one synchronize)
    and device microseconds a call (events around the same loop)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh

    group = rules.mesh.get_group(rules.model_axis)
    x = torch.randn((4, 24, 128), device=device)
    out = torch.empty((4 * dist.get_world_size(group), 24, 128), device=device)
    ways = {"sharding.all_gather": lambda: sh.all_gather(x, group, 1),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(out, x, group=group)}
    for name, fn in ways.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        host = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        print(f"[sharded] one decode-step all-gather (4 x 24 x 128 f32) over NCCL, world of "
              f"one, {name}: {host:.1f} us of host a call enqueued, "
              f"{a.elapsed_time(b) / calls * 1e3:.1f} us a call between events [{card}]")


def _rank_slices(B, Hk, mesh):
    """``(rank, slots, kv heads)`` of every rank of a ``(data, model)``
    mesh over ``B`` slots and ``Hk`` kv heads."""
    d, m = mesh
    b, h = B // d, Hk // m
    return [((i, j), slice(i * b, (i + 1) * b), slice(j * h, (j + 1) * h))
            for i in range(d) for j in range(m)]


# llama4-scout's decode geometry on a rank (ROADMAP item 7c-i: its 40 / 8
# heads, g 5, split 20 / 4 and 5 / 1): every rank of these meshes, and rank
# (0, 0) of 2x4 (10 / 2 heads on 2 slots)
LLAMA4_SHARD_MESHES = ((1, 2), (1, 8))


def shard_kernel_phase(device, flush):
    """Each mesh rank's decode launches, one after another on the card
    (:func:`shard_attends`, :func:`shard_k3`): at phi4-mini-3.8b's decode
    geometry (Hq 24, Hk 8, D 128, 4 slots of 1024 lanes, page 16) for every
    rank of the meshes :data:`SHARD_MESHES`, and at llama4-scout's (Hq 40,
    Hk 8, g 5) for every rank of :data:`LLAMA4_SHARD_MESHES` and rank (0, 0)
    of 2x4; K3 on column shards of phi4-mini's ``wq`` and ``lm_head`` (4
    shards) and of llama4-scout's ``wq`` (2 and 8).  Returns the records of
    both geometries' 2x4 rank (0, 0) launches, phi4-mini's ``lm_head``
    shard and llama4-scout's ``wq`` shard of 8."""
    records = shard_attends(device, flush, "phi4-mini-3.8b", SHARD_MESHES)
    records += shard_attends(device, flush, LLAMA4_ARCH, LLAMA4_SHARD_MESHES + ((2, 4),),
                             first_only=((2, 4),))
    records += shard_k3(device, flush, "phi4-mini-3.8b", ("wq", "lm_head"), (4,),
                        record=("lm_head", 4))
    records += shard_k3(device, flush, LLAMA4_ARCH, ("wq",), (2, 8), record=("wq", 8))
    return records


def shard_attends(device, flush, arch, meshes, first_only=(), timed_mesh=(2, 4)):
    """K1 (bf16 and int8) and K2 on each rank's slots and kv heads of
    ``meshes`` (the pools whole on every data rank, as the paged layout
    holds them; only rank (0, 0) of a mesh in ``first_only``) at ``arch``'s
    decode geometry (:func:`decode_attend_inputs`): each must equal its
    slice of the whole launch bit for bit, planned at the whole launch's
    geometry, and be held to its plain version on the same operands
    (:func:`check_rows` with the int8 bodies' code step).  The same launches
    planned at their own shapes are printed as a finding.  Returns the
    records of ``timed_mesh``'s rank (0, 0) launches, timed, with ``case``
    and ``err_over_tol``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.bgpp_paged_attend import bgpp_paged_attend
    from repro_torch.kernels.bgpp_paged_attend.ref import bgpp_paged_attend_ref
    from repro_torch.kernels.paged_flash_decode import paged_flash_decode
    from repro_torch.kernels.paged_flash_decode.ref import paged_flash_decode_ref
    from repro_torch.serving import kv_cache as kvc

    cfg = get_config(arch)
    page = DECODE_PAGE
    q, kf, vf, table, pos = decode_attend_inputs(device, arch)
    B, Hk, g, D = q.shape
    whole = (B, Hk)
    kq, ks = kvc.quantize_kv(kf)
    vq, vs = kvc.quantize_kv(vf)
    bodies = {"bf16": ((kf.to(torch.bfloat16), vf.to(torch.bfloat16)), {}),
              "int8": ((kq, vq), dict(k_scale=ks, v_scale=vs))}
    args, _ = k2_operands(q, kf, vf, table, pos, page)
    rounds, k_max, surv = kvc.bgpp_decode_plan(DECODE_S, cfg)
    k2kw = dict(rounds=rounds, k_max=k_max, survivors=surv)
    kernels = {"bf16": paged_flash_decode, "int8": paged_flash_decode,
               "bgpp": bgpp_paged_attend}
    plains = {"bf16": paged_flash_decode_ref, "int8": paged_flash_decode_ref,
              "bgpp": bgpp_paged_attend_ref}
    # each row's tolerance beyond check_rows' 1e-5: one int8 probability code
    steps = {"bf16": None, "int8": k1_int8_step(q, kq, ks, vs, table, pos, page),
             "bgpp": k2_plain(args, kq, k2kw)[2]}

    def sliced(name, b, h):
        """The operands of ``name`` on slots ``b`` and kv heads ``h``
        (copies): ``(args, kwargs)`` of the kernel and its plain version."""
        if name == "bgpp":
            a = args
            return (a[0][b, h].contiguous(), a[1][:, :, h].contiguous(),
                    a[2][:, h].contiguous(), a[3][:, h].contiguous(), a[4][:, h].contiguous(),
                    a[5][:, h].contiguous(), a[6][b].contiguous(), a[7][b].contiguous()), k2kw
        (k, v), sc = bodies[name]
        return ((q[b, h].contiguous(), k[:, h].contiguous(), v[:, h].contiguous(),
                 table[b].contiguous(), pos[b].contiguous()),
                dict(page_size=page, **{n: x[:, h].contiguous() for n, x in sc.items()}))

    def checked(label, name, b, h, got):
        """``got`` held to the plain version on the same slice: its largest
        error and largest error over :func:`row_tol`."""
        a, kw = sliced(name, b, h)
        step = None if steps[name] is None else steps[name][b, h]
        want = plains[name](*a, **kw)
        err = check_rows(label, got, want, step)
        return err, ((got - want).abs().amax(-1) / row_tol(want, step)).max().item()

    every = slice(None)
    full = {name: kernels[name](*sliced(name, every, every)[0],
                                **sliced(name, every, every)[1]) for name in kernels}
    for name, y in full.items():
        checked(f"{arch} {name} whole launch", name, every, every, y)
    records, own, errs = [], {}, {}
    for mesh in meshes:
        ranks = _rank_slices(B, Hk, mesh)[:1 if mesh in first_only else None]
        for name in kernels:
            for rank, b, h in ranks:
                a, kw = sliced(name, b, h)
                got = kernels[name](*a, whole=whole, **kw)
                if not torch.equal(got, full[name][b, h]):
                    raise AssertionError(f"{arch} {name} rank {rank} of mesh {mesh}: not its "
                                         f"slice of the whole launch")
                errs[(mesh, name, rank)] = checked(f"{arch} {name} rank {rank} of mesh {mesh}",
                                                   name, b, h, got)
                alone = kernels[name](*a, **kw)
                own[(mesh, name)] = own.get((mesh, name), 0) + int(
                    not torch.equal(alone, full[name][b, h]))
            err = max(e for (m_, n_, _), (e, _) in errs.items() if (m_, n_) == (mesh, name))
            print(f"[shard] {'K2 bgpp_paged_attend' if name == 'bgpp' else f'K1 {name}'} at "
                  f"{arch}'s heads ({Hk * g} / {Hk}, g {g}) on {len(ranks)} of the "
                  f"{mesh[0] * mesh[1]} ranks of mesh {mesh[0]}x{mesh[1]} (slots "
                  f"{B // mesh[0]}, kv heads {Hk // mesh[1]} a rank): each rank bit-equal to "
                  f"its slice of the whole launch at the whole geometry and within "
                  f"check_rows of its plain version (max_abs_err {err:.3e}); planned at its "
                  f"own shape, {own[(mesh, name)]} of {len(ranks)} ranks differ")
    # the timed mesh's rank (0, 0) launches, timed against their plain versions
    td, tm = timed_mesh
    rank, b, h = _rank_slices(B, Hk, timed_mesh)[0]
    label = (f" {arch} mesh {td}x{tm} rank (0, 0): {B // td} slots x {Hk // tm} kv heads, "
             f"whole-launch plan")
    case = (f"{arch} mesh {td}x{tm} rank (0, 0): B {B // td} Hk {Hk // tm} g {g} D {D} page "
            f"{page} S {DECODE_S}, whole-launch plan")
    for name in ("bf16", "int8"):
        a, kw = sliced(name, b, h)
        lq, lk, lt, lp = a[0], a[1], a[3], a[4]
        run = lambda: paged_flash_decode(*a, whole=whole, **kw)
        plain = lambda: paged_flash_decode_ref(*a, **kw)
        n_valid = sum(min(int(p) + 1, DECODE_S) for p in lp.cpu()) * lq.shape[1]
        row = 2 * D * lk.element_size() + (8 if len(kw) > 1 else 0)
        io = lq.numel() * 8 + lt.numel() * 4 + lq.shape[0] * 4
        err, ratio = errs[(timed_mesh, name, rank)]
        rec = kernel_record(
            f"paged_flash_decode_{name}", K1_SOURCE, K1_REPLACES[name], err,
            time_ms(run, 20, flush), time_ms(plain, 20, flush), n_valid * row + io,
            n_valid * 4 * g * D, name, None, label=label, case=case)
        rec["err_over_tol"] = ratio
        records.append(rec)
    la, _ = sliced("bgpp", b, h)
    run = lambda: bgpp_paged_attend(*la, whole=whole, **k2kw)
    plain = lambda: bgpp_paged_attend_ref(*la, **k2kw)
    err, ratio = errs[(timed_mesh, "bgpp", rank)]
    rec = k2_record(la, err, time_ms(run, 20, flush), time_ms(plain, 20, flush),
                    la[6].numel(), label, arch=arch)
    rec.update(case=case, err_over_tol=ratio)
    records.append(rec)
    del bodies, args, full, steps, kf, vf, kq, vq
    torch.cuda.empty_cache()
    return records


def shard_k3(device, flush, arch, names, splits, record):
    """K3 on column shards of ``arch``'s projections ``names`` (random bf16
    weights, int8-quantized and BSTC-coded, N 4): the model axis splits a
    weight's columns; for each ``m`` of ``splits`` every shard, coded as a
    matrix of its own and planned at the whole matrix's rows
    (``plan_rows``), must equal its rows of the whole launch bit for bit,
    and the whole and every shard be within :func:`check_bstc` of the plain
    version.  Planned at their own rows, and cuBLAS on a column shard
    against the same columns of the whole product (f32 and bf16), are
    printed as findings.  Returns the record of shard 0 of ``record``'s
    ``(name, m)``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.bstc_matmul import bstc_matmul
    from repro_torch.kernels.bstc_matmul.ref import bstc_matmul_plain
    from repro_torch.serving import weights

    cfg = get_config(arch)
    gen = torch.Generator(device=device).manual_seed(5)
    d, N = cfg.d_model, 4
    x = torch.randn((d, N), generator=gen, device=device)
    outs = {"wq": cfg.q_dim, "lm_head": cfg.vocab_size}
    records = []
    for pname in names:
        out = outs[pname]
        w = (torch.randn((d, out), generator=gen, device=device) * d ** -0.5).to(torch.bfloat16)
        rec = weights.quantize(w)
        ops = weights.bstc_record_from_int8(rec["q"], rec["scale"], cfg)["bstc"]
        whole_y = bstc_matmul(ops, x, apply_scale=True)
        err = check_bstc(f"{arch} {pname} whole", ops, x, rec["q"].T.to(torch.int32),
                         rec["scale"])
        for m in splits:
            n, differ = out // m, 0
            for r in range(m):
                cols = slice(r * n, (r + 1) * n)
                shard = weights._code(rec["q"][:, cols], rec["scale"][cols], cfg,
                                      roundtrip=False, plan_rows=out)[0]["bstc"]
                if not torch.equal(bstc_matmul(shard, x, apply_scale=True), whole_y[cols]):
                    raise AssertionError(f"bstc_matmul {arch} {pname} column shard {r} of "
                                         f"{m}: not its rows of the whole launch")
                q_cols = rec["q"][:, cols].T.to(torch.int32)
                shard_err = check_bstc(f"{arch} {pname} column shard {r} of {m}", shard, x,
                                       q_cols, rec["scale"][cols])
                err = max(err, shard_err)
                alone = dataclasses.replace(shard, plan_rows=0, _desc=None)
                differ += int(not torch.equal(bstc_matmul(alone, x, apply_scale=True),
                                              whole_y[cols]))
                if (pname, m) == record and r == 0:
                    run = lambda: bstc_matmul(shard, x, apply_scale=True)
                    plain = lambda: bstc_matmul_plain(shard, x, apply_scale=True)
                    dense = (rec["q"][:, cols].float() * rec["scale"][cols]).to(torch.bfloat16)
                    xb = x.T.to(torch.bfloat16).contiguous()
                    lib = time_ms(lambda: xb @ dense, 20, flush)
                    what = f"{arch} {pname} column shard 1 of {m}: {d} x {n}, N {N}"
                    rk = kernel_record(
                        "bstc_matmul", "src/repro_torch/csrc/bstc_matmul.cu",
                        "src/repro/kernels/bstc_matmul/kernel.py:98",
                        shard_err, time_ms(run, 20, flush),
                        time_ms(plain, 5, flush),
                        shard.stored_bytes + x.numel() * 4 + n * N * 4, 2 * n * d * N, "f32",
                        lib, label=f" {what}, whole-launch plan",
                        case=f"{what}, whole-launch plan")
                    rk["err_over_tol"] = ((run() - plain()).abs()
                                          / bstc_tol(q_cols, x, rec["scale"][cols])).max().item()
                    records.append(rk)
                del shard, alone, q_cols
            print(f"[shard] K3 bstc_matmul {arch} {pname} ({d} x {out}) in {m} column shards, "
                  f"each coded as its own matrix: each bit-equal to its rows of the whole "
                  f"launch at the whole geometry, the whole and every shard within check_bstc "
                  f"of the plain version (max_abs_err {err:.3e}); planned at its own rows, "
                  f"{differ} of {m} differ")
            # cuBLAS (the raw-weight path's product, f32 as wdot upcasts, and bf16)
            for dt in (torch.float32, torch.bfloat16):
                xr, wr = x.T.contiguous().to(dt), w.to(dt)
                full_p = xr @ wr
                gap = max(float((xr @ wr[:, r * n:(r + 1) * n].contiguous()
                                 - full_p[:, r * n:(r + 1) * n]).abs().max())
                          for r in range(m))
                print(f"[shard] cuBLAS x (4 x {d}) @ {arch} {pname} {str(dt)[6:]} column "
                      f"shards of {m} against the whole product's columns: "
                      f"{'bit-equal' if gap == 0 else f'max |diff| {gap:.3e}'}")
        del w, rec, ops, whole_y
        torch.cuda.empty_cache()
    return records


def multi_card_check(card) -> None:
    """Where the machine has two or more cards, serve deepseek-7b's and
    llama4-scout's smoke configs on the ``(1, n)`` mesh through
    ``torchrun`` (NCCL, a rank a card), then train deepseek-7b's and
    mixtral-8x22b's there 3 steps each (the train launcher, ``--fsdp``,
    ``sp``); otherwise say that it was not run."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"[sharded] the (1, n) mesh over several cards, serving deepseek-7b and "
              f"llama4-scout and training deepseek-7b and mixtral-8x22b (smoke configs): not "
              f"run ({n} card)")
        return
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for arch in ("deepseek-7b", LLAMA4_ARCH):
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={n}", "-m", "repro_torch.launch.serve", "--arch", arch,
             "--mesh", f"1,{n}", "--kv-format", "bf16", "--kv-layout", "paged", "--requests",
             "4", "--max-new", "8"], capture_output=True, text=True, timeout=600, env=env,
            cwd=ROOT)
        if out.returncode:
            raise AssertionError(f"torchrun {arch} on the (1, {n}) mesh failed: "
                                 f"{out.stderr[-2000:]}")
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[serve]")]
        print(f"[sharded] {arch}-smoke served on the (1, {n}) mesh over {n} cards through "
              f"torchrun [{card}]:")
        for ln in lines[-4:]:
            print(ln)
    for arch in ("deepseek-7b", MIXTRAL_ARCH):
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={n}", "-m", "repro_torch.launch.train", "--arch", arch,
             "--mesh", f"1,{n}", "--fsdp", "--steps", "3", "--batch", "4", "--seq-len", "64",
             "--log-every", "1", "--ckpt-dir", os.path.join(ROOT, "build", f"train-{arch}-1x{n}"),
             "--heartbeat", os.path.join(ROOT, "build", f"train-{arch}-1x{n}.json")],
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
        if out.returncode or "failed" in out.stdout:
            raise AssertionError(f"the train launcher ({arch}) on the (1, {n}) mesh failed: "
                                 f"{out.stdout[-1500:]} {out.stderr[-2000:]}")
        print(f"[sharded-train] {arch}-smoke trained on the (1, {n}) mesh over {n} cards "
              f"through torchrun (fsdp, sp) [{card}]:")
        for ln in out.stdout.splitlines():
            if ln.startswith("[train]"):
                print(ln)


def zoo_serve_phase(device, card):
    """The dense model zoo at full width: gemma3-4b at :data:`GEMMA_DEPTH`
    layers (5 local sliding-window layers of 1024 lanes beside 1 global
    one, qk-norm, sandwich norms, GeGLU, D 256) for every run of
    :data:`SERVE_RUNS` on
    :data:`GEMMA_TRACE` at max_seq 4096, and its refusal of speculative
    decoding; then deepseek-7b (an untied head, g 1) once, chunked with
    bf16 KV."""
    import torch

    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.scheduler import Scheduler

    cfg, params = init_model(GEMMA_ARCH, device, depth=GEMMA_DEPTH)
    serve_runs(cfg, params, SERVE_RUNS, GEMMA_TRACE, GEMMA_MAX_SEQ, device, card)
    layout = kvc.layout_for(cfg, 4, GEMMA_MAX_SEQ, kv_format="bf16", layout="paged",
                            page_size=16)
    try:
        Scheduler(params, cfg, layout, device=device, spec_decode=True)
    except ValueError as e:
        if "rollback-safe" not in str(e):
            raise
        print(f"[serve] {cfg.name}: spec_decode=True refused as the reference refuses it: {e}")
    else:
        raise AssertionError(f"{cfg.name}: a speculative Scheduler over local rings was built")
    del params
    free_device()
    cfg, params = init_model(DEEPSEEK_ARCH, device)
    serve_runs(cfg, params, SERVE_RUNS[:1], DEEPSEEK_TRACE, 1024, device, card)
    del params
    free_device()


def moe_serve_phase(device, card, sharded=True):
    """The MoE family at full width: llama4-scout cut to
    :data:`LLAMA4_DEPTH` layers for every run of :data:`LLAMA4_RUNS`
    on :data:`LLAMA4_TRACE` (max_seq 1024), then (``sharded``) the runs of
    :data:`LLAMA4_SHARDED_RUNS` through a sharded Scheduler over an NCCL
    world of one against them (:func:`sharded_serve`), then mixtral-8x22b
    cut to :data:`MIXTRAL_DEPTH` layers (no global layer) once
    (:data:`MIXTRAL_RUNS`); :func:`serve_runs` checks each.  Returns the
    sharded runs' launches of each kernel."""
    cfg, params = init_model(LLAMA4_ARCH, device, LLAMA4_DEPTH)
    runs = LLAMA4_RUNS if sharded else tuple(k[:3] for k in LLAMA4_SHARDED_RUNS)
    _, outcome = serve_runs(cfg, params, runs, LLAMA4_TRACE, 1024, device, card)
    launches = timed_sharded(cfg, params, outcome, device, card, LLAMA4_SHARDED_RUNS,
                             LLAMA4_TRACE)
    del params
    free_device()
    if sharded:
        cfg, params = init_model(MIXTRAL_ARCH, device, MIXTRAL_DEPTH)
        serve_runs(cfg, params, MIXTRAL_RUNS, MIXTRAL_TRACE, 1024, device, card)
        del params
        free_device()
    return launches


def vlm_serve_phase(device, card, sharded=True):
    """The VLM family at full width and depth: paligemma-3b for every run
    of :data:`PALI_RUNS` on :data:`MAIN_TRACE` at max_seq 1024 (K3 7L + 1
    = 127 launches a step, ``vision_proj`` raw), then the runs of
    :data:`PALI_SHARDED_RUNS` through a sharded Scheduler over an NCCL
    world of one against them (:func:`sharded_serve`), once at
    :data:`PALI_LONG_SEQ` on :data:`PALI_LONG_TRACE` with bgpp KV
    (:func:`serve_runs` checks each), then one eager admission with an
    image prefix (:func:`vision_prefill`).  Text prompts go through chunked
    admission, as the reference's Scheduler serves a VLM.  Without
    ``sharded`` (``--only sharded-moe``) only the sharded runs and the
    unsharded runs they are held to.  Returns the sharded runs' launches of
    each kernel."""
    cfg, params = init_model(PALI_ARCH, device)
    runs = PALI_RUNS if sharded else tuple(k[:3] for k in PALI_SHARDED_RUNS)
    _, outcome = serve_runs(cfg, params, runs, MAIN_TRACE, 1024, device, card,
                            k3_per_step=7 * cfg.num_layers + 1)
    launches = timed_sharded(cfg, params, outcome, device, card, PALI_SHARDED_RUNS, MAIN_TRACE)
    if sharded:
        serve_runs(cfg, params, PALI_LONG_RUNS, PALI_LONG_TRACE, PALI_LONG_SEQ, device, card)
        vision_prefill(cfg, params, device, card)
    del params
    free_device()
    return launches


def timed_sharded(cfg, params, outcome, device, card, runs, trace_kw):
    """:func:`sharded_serve` of ``runs``, its seconds printed as a
    ``[time]`` line."""
    t = time.perf_counter()
    launches = sharded_serve(cfg, params, outcome, device, card, runs, trace_kw)
    print(f"[time] sharded_serve {cfg.name}: {time.perf_counter() - t:.1f} s")
    return launches


# the asyncio front door (serving/server.py) over full phi4-mini-3.8b, in
# the offline runs' layout (paged, page 16, 4 slots, chunk budget 128,
# max_seq 1024): the main trace's clients in bf16 and bgpp KV, tiers
# alternating interactive / batch, every third client hanging up after 4
# streamed tokens; a two-turn chat session of a 200-token prompt then 48
# more; the TCP front door on 127.0.0.1
SERVER_RUNS = ("bf16", "bgpp")
SERVER_OFFLINE = tuple((fmt, "bf16", "chunked") for fmt in SERVER_RUNS)
SERVER_DISCONNECT_EVERY, SERVER_DISCONNECT_AFTER = 3, 4
SERVER_CHAT = (200, 48, 16)  # turn 1's prompt, turn 2's new tokens, tokens a turn
SERVER_TCP_CUT = 2  # streamed tokens before the second TCP client hangs up
# the front door's logits against the offline run's, as a share of max
# |logit|: each prompt is chunked at the same offsets and each decode step
# has 4 rows whatever the interleaving, so the sound runs read 0 in bf16
# and bgpp KV; K1 blind to each slot's newest lane (teacher-forced) read
# 1.10e-1 (PERF.md §6)
SERVER_LOGIT_SHARE = 1e-4
# a chat turn that adopted its history's pages against a fresh prefill of
# the whole prompt: the adopted pages hold K / V that turn 1's chunks and
# decode steps wrote, the fresh run's chunks write them in other widths,
# and the card's products round differently across row counts, so bf16
# stores differ in the last place; the sound run read 1.39e-2 in two calls
# (eager against chunked admission reads 2e-2 for the same reason), K1
# blind to each slot's newest lane during turn 2 (teacher-forced) 6.73e-2
SERVER_CHAT_SHARE = 3e-2


def _front_door_sched(cfg, params, fmt, device):
    """A Scheduler in the offline runs' layout, recording logits."""
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.scheduler import Scheduler

    layout = kvc.layout_for(cfg, 4, 1024, kv_format=fmt, layout="paged", page_size=16)
    return Scheduler(params, cfg, layout, device=device, chunk_budget=128,
                     record_logits=True)


def _share(rows, want):
    """Largest |rows - want| over the rows ``rows`` has, as a share of the
    largest |logit| of ``want``'s rows."""
    import numpy as np

    ref = want[:len(rows)]
    return float(np.abs(np.stack(rows) - ref).max()) / float(np.abs(ref).max())


def server_run(cfg, params, fmt, offline, device, card):
    """The main trace through :func:`~repro_torch.serving.server.simulate_clients`
    (``check_invariants``: ``pager.check()`` after every pumped step), every
    count zeroed just before the Scheduler is built and read just after.
    Holds: at least 2 requests cancelled and 0 pages in use after ``close``;
    every survivor's streamed tokens equal to the offline run's for that
    rid, and every disconnected client's to the offline run's first tokens;
    logit rows within :data:`SERVER_LOGIT_SHARE` of the offline run's; the
    decode attend launched once per global layer a decode step and nothing
    else.  Prints the gaps, the tiers' TTFT and ITL p50 in steps and ms,
    and ms per pumped step against the offline run's ms per step.  Returns
    the launches."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.serving.server import simulate_clients

    run = f"{cfg.name} {fmt} front door"
    want = offline[(fmt, "bf16", "chunked")]
    free_device()
    torch.cuda.synchronize()
    K.reset_launches()
    sched = _front_door_sched(cfg, params, fmt, device)
    dec, in_step = [], [0.0]
    sched.serve_step = _timed(sched.serve_step, dec)
    step = sched.step

    def timed_step():
        t = time.perf_counter()
        out = step()
        in_step[0] += time.perf_counter() - t
        return out

    sched.step = timed_step
    reqs = trace(vocab=cfg.vocab_size, **MAIN_TRACE)
    t0 = time.perf_counter()
    stats = simulate_clients(sched, reqs, disconnect_every=SERVER_DISCONNECT_EVERY,
                             disconnect_after=SERVER_DISCONNECT_AFTER, check_invariants=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(K.LAUNCHES)
    G = len(sched.layout.global_layers)
    expect = {name: 0 for name in got}
    expect[KERNEL_OF[fmt]] = G * sched.decode_steps
    for name, n in got.items():
        if n != expect[name]:
            raise AssertionError(f"{run}: {name} launched {n} times, expected {expect[name]}")
    sched.pager.check()
    if sched.pager.pages_in_use or stats["paged"]["pages_in_use"]:
        raise AssertionError(f"{run}: {sched.pager.pages_in_use} pages in use after close")
    if stats["cancelled_requests"] < 2:
        raise AssertionError(f"{run}: {stats['cancelled_requests']} requests cancelled")
    by_rid = {r.rid: r for r in sched.finished + sched.cancelled}
    gaps = {}
    for c in stats["clients"]:
        r, offline_tokens = by_rid[c["rid"]], want["tokens"][c["rid"]]
        if c["disconnected"]:
            ok = (c["cancelled"] and c["tokens"] == SERVER_DISCONNECT_AFTER
                  and r.generated == offline_tokens[:len(r.generated)])
        else:
            ok = not r.cancelled and r.generated == offline_tokens
        if not ok:
            raise AssertionError(f"{run}: client {c} streamed {r.generated}, the offline run "
                                 f"{offline_tokens}")
        gaps[c["rid"]] = _share(r.logit_rows, want["logits"][c["rid"]])
    worst = max(gaps.values())
    by = ", ".join(f"{rid} {share:.2e}" for rid, share in sorted(gaps.items()))
    steps_pumped = stats["server"]["steps_pumped"]
    print(f"[server] {run}: {len(reqs)} clients (tiers interactive / batch alternating), "
          f"{stats['cancelled_requests']} cancelled (every {SERVER_DISCONNECT_EVERY}rd client "
          f"hung up after {SERVER_DISCONNECT_AFTER} tokens), {stats['finished_requests']} "
          f"finished, {stats['preemptions']} preemptions; survivors' streamed tokens equal the "
          f"offline run's, the disconnected clients' its first {SERVER_DISCONNECT_AFTER}; "
          f"pager.check() after each of {steps_pumped} pumped steps, pages_in_use 0 after "
          f"close; logit rows against the offline run's: largest gap {worst:.4e} of max "
          f"|logit| (bound {SERVER_LOGIT_SHARE:.0e}; by rid: {by}); launches "
          f"{KERNEL_OF[fmt]} {got[KERNEL_OF[fmt]]} = {G} x {sched.decode_steps} decode steps "
          f"[{card}]")
    for tier, t in stats["tiers"].items():
        fin = [r for r in sched.finished if r.priority == tier]
        ttft = float(np.median([r.first_token_step - r.arrival_step for r in fin]))
        itl = float(np.median([(r.finished_step - r.first_token_step) / (len(r.generated) - 1)
                               for r in fin]))
        print(f"[server] {run}, tier {tier}: {t['finished']} finished, {t['cancelled']} "
              f"cancelled, {t['preemptions']} preemptions; TTFT p50 {ttft:.1f} steps = "
              f"{t['ttft_s']['p50'] * 1e3:.1f} ms, ITL p50 {itl:.2f} steps = "
              f"{t['itl_s']['p50'] * 1e3:.2f} ms [{card}]")
    dec_ms = float(np.mean([a.elapsed_time(b) for a, b in dec]))
    print(f"[server] {run}: {wall * 1e3 / steps_pumped:.2f} ms per pumped step, of which "
          f"{(wall - in_step[0]) * 1e3 / steps_pumped:.3f} ms outside Scheduler.step (the "
          f"asyncio pump with its pager.check() and the clients), {steps_pumped} steps in {wall:.3f} s, decode "
          f"{dec_ms:.3f} ms/step by events; the offline run "
          f"{want['wall_s'] * 1e3 / want['steps']:.2f} ms per step ({want['steps']} steps in "
          f"{want['wall_s']} s) [{card}]")
    if worst > SERVER_LOGIT_SHARE:
        raise AssertionError(f"{run}: logits {worst:.4e} of max |logit| from the offline run's")
    del sched
    free_device()
    return got


def chat_check(cfg, params, device, card):
    """A two-turn chat session through the front door (bf16 paged): turn 2's
    prompt (the history plus :data:`SERVER_CHAT`'s new tokens) must adopt
    turn 1's pinned pages (``prefix_hit_tokens`` grows by at least the
    written history's page-aligned length), give the tokens of a fresh
    Scheduler's run of the whole prompt with nothing resident (run between
    the turns), and logits within :data:`SERVER_CHAT_SHARE` of it;
    ``close_session`` returns the pool to 0 pages."""
    import asyncio

    import numpy as np

    from repro_torch.serving.request import Request
    from repro_torch.serving.server import AsyncServer

    first, more, new = SERVER_CHAT
    rng = np.random.default_rng(7)
    p1 = rng.integers(0, cfg.vocab_size, (first,)).astype(np.int32)
    p2 = rng.integers(0, cfg.vocab_size, (more,)).astype(np.int32)
    free_device()
    sched = _front_door_sched(cfg, params, "bf16", device)
    page = sched.layout.page_size

    async def session():
        server = AsyncServer(sched, check_invariants=True)
        pump = asyncio.ensure_future(server.run())
        turn1 = [t async for t in server.chat("chat", p1, new)]
        hits, hist = sched.prefix_hit_tokens, server.sessions["chat"].history
        fresh = _front_door_sched(cfg, params, "bf16", device)
        fresh.submit(Request(rid=0, prompt=np.concatenate([hist, p2]), max_new_tokens=new))
        fresh.run()
        ref = fresh.finished[0]
        del fresh
        stream = server.chat("chat", p2, new)
        turn2 = [t async for t in stream]
        grown = sched.prefix_hit_tokens - hits
        pinned = len(server.sessions["chat"].pinned)
        server.close_session("chat")
        sched.pager.check()
        left = sched.pager.pages_in_use
        server.close()
        await pump
        return turn1, hist, ref, turn2, stream.request, grown, pinned, left

    t0 = time.perf_counter()
    turn1, hist, ref, turn2, req2, grown, pinned, left = asyncio.run(session())
    took = time.perf_counter() - t0
    aligned = (len(hist) - 1) // page * page  # the written history: all but its last token
    share = _share(req2.logit_rows, np.stack(ref.logit_rows))
    print(f"[server] {cfg.name} chat session (bf16 paged): turn 1 {first} prompt tokens -> "
          f"{len(turn1)} tokens; turn 2 the {len(hist)}-token history + {more} -> "
          f"{len(turn2)} tokens, {grown} prompt tokens adopted from the pinned pages (the "
          f"history's page-aligned length {aligned}), {pinned} pages pinned after it; tokens "
          f"{'equal' if turn2 == ref.generated else 'NOT equal'} to a fresh Scheduler's run "
          f"of the whole {ref.prompt_len}-token prompt, logits {share:.4e} of max |logit| "
          f"from it (bound {SERVER_CHAT_SHARE:.0e}); pages_in_use {left} after "
          f"close_session; {took:.2f} s with the fresh run [{card}]")
    if grown < aligned or req2.prefix_reused_tokens < aligned:
        raise AssertionError(f"chat: turn 2 adopted {grown} tokens, the history's page-aligned "
                             f"length is {aligned}")
    if left:
        raise AssertionError(f"chat: {left} pages in use after close_session")
    if turn2 != ref.generated or share > SERVER_CHAT_SHARE:
        raise AssertionError("chat: turn 2 differs from a fresh run of the whole prompt")
    del sched
    free_device()


def tcp_check(cfg, params, offline, device, card):
    """The TCP front door on 127.0.0.1, port 0: one client reads its whole
    stream of the main trace's request 0 (its tokens must be the offline
    run's), a second hangs up after :data:`SERVER_TCP_CUT` tokens (the
    server must record it cancelled and drain the pool to 0)."""
    import asyncio

    from repro_torch.serving.server import AsyncServer, TCPFrontDoor

    reqs = trace(vocab=cfg.vocab_size, **MAIN_TRACE)
    new = MAIN_TRACE["new"]
    free_device()
    sched = _front_door_sched(cfg, params, "bf16", device)

    async def exchange():
        server = AsyncServer(sched, check_invariants=True)
        pump = asyncio.ensure_future(server.run())
        door = TCPFrontDoor(server)
        await door.start()

        async def client(prompt, cut=None):
            reader, writer = await asyncio.open_connection("127.0.0.1", door.port)
            writer.write(json.dumps({"prompt": prompt.tolist(), "max_new_tokens": new})
                         .encode() + b"\n")
            await writer.drain()
            msgs = []
            while not (msgs and msgs[-1].get("done")) and len(msgs) != cut:
                msgs.append(json.loads(await reader.readline()))
            writer.close()
            return msgs

        msgs = await asyncio.gather(client(reqs[0].prompt),
                                    client(reqs[1].prompt, SERVER_TCP_CUT))
        await server.drain()
        await door.stop()
        server.close()
        await pump
        return msgs

    t0 = time.perf_counter()
    full, cut = asyncio.run(exchange())
    took = time.perf_counter() - t0
    tokens = [m["token"] for m in full[:-1]]
    done = full[-1]
    gone = [r for r in sched.cancelled if r.prompt_len == reqs[1].prompt_len]
    sched.pager.check()
    print(f"[server] {cfg.name} TCP front door (127.0.0.1, bf16 paged): one client read "
          f"{len(tokens)} tokens and {done}, tokens "
          f"{'equal' if tokens == offline[('bf16', 'bf16', 'chunked')]['tokens'][0] else 'NOT equal'} "
          f"to the offline run's request 0; one hung up after {len(cut)} tokens: the server "
          f"recorded {[(r.cancel_state, len(r.generated)) for r in gone]} (cancel state, tokens "
          f"generated); pages_in_use {sched.pager.pages_in_use}; {took:.2f} s [{card}]")
    if (tokens != offline[("bf16", "bf16", "chunked")]["tokens"][0] or not done.get("done")
            or done["tokens"] != new or done["cancelled"] or len(cut) != SERVER_TCP_CUT
            or len(gone) != 1 or sched.pager.pages_in_use):
        raise AssertionError("TCP front door: the exchange or the disconnect went wrong")
    del sched
    free_device()


def server_phase(cfg, params, offline, device, card):
    """The asyncio front door over full phi4-mini-3.8b: :func:`server_run`
    in every KV format of :data:`SERVER_RUNS` against the offline runs
    ``offline`` (:func:`serve_runs`' outcome), then :func:`chat_check` and
    :func:`tcp_check`.  Returns the decode attends' launches of the
    front-door runs."""
    t0 = time.perf_counter()
    launches = {}
    for fmt in SERVER_RUNS:
        for name, n in server_run(cfg, params, fmt, offline, device, card).items():
            launches[name] = launches.get(name, 0) + n
    chat_check(cfg, params, device, card)
    tcp_check(cfg, params, offline, device, card)
    print(f"[time] server_phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


def server_only_phase(device, card):
    """``--only server``: full phi4-mini-3.8b's offline runs of
    :data:`SERVER_OFFLINE` (:func:`serve_runs`), then :func:`server_phase`."""
    cfg, params = init_model("phi4-mini-3.8b", device)
    _, offline = serve_runs(cfg, params, SERVER_OFFLINE, MAIN_TRACE, 1024, device, card)
    server_phase(cfg, params, offline, device, card)
    del params
    free_device()


# gemma3-1b at the reference's long_500k (configs/shapes.py): one slot of
# max_seq 524,288, bgpp KV, one prompt of ~300 tokens chunked, 8 decode steps
LONG_SERVE_ARCH, LONG_SERVE_SEQ = "gemma3-1b", 524288
LONG_SERVE_RUNS = (("bgpp", "bf16", "chunked"),)
LONG_SERVE_TRACE = dict(seed=3, n=1, lo=290, hi=310, new=9)


def long_serve_phase(device, card):
    """gemma3-1b at full width and depth (26 layers: 22 sliding-window
    rings, 4 global) served through the Scheduler at max_seq 524,288 with
    bgpp KV, one slot: each decode step's K2 scans the whole 524,288-lane
    row of every global layer with its selection spanning blocks
    (:func:`serve_runs` checks the request finishes, no page leaks and K2
    launches 4 x steps)."""
    cfg, params = init_model(LONG_SERVE_ARCH, device)
    serve_runs(cfg, params, LONG_SERVE_RUNS, LONG_SERVE_TRACE, LONG_SERVE_SEQ, device, card,
               slots=1)
    del params
    free_device()


# mamba2-1.3b (the ssm family) at full width, its depth cut from 48 layers to
# 24 (the whole script ran 1131.8 s of its 1200 s limit on a slow host once
# the sharded training phase joined it; this decode is host-bound, a layer at
# a time): four prompts fed a token a step from a zero state (multiples of 64,
# so the forward below runs them at chunk 64), then greedy tokens; the
# forward timed at B 1, S 2048
SSM_ARCH = "mamba2-1.3b"
# cut from 48 layers to 24, then to 16 to pay for the sharded ssm phase
SSM_DEPTH = 16
# 256-448 tokens until the sharded ssm phase: cut to 64-256 to pay for it
SSM_PROMPTS = (64, 128, 192, 256)
SSM_NEW, SSM_MAX_SEQ = 16, 1024
SSM_FWD_S, SSM_FWD_CHUNK, SSM_CHECK_CHUNK = 2048, 256, 64
# the forward against the decode, on an f32 copy of the weights: the chunked
# dual form and the recurrence are two summation orders of one scan (shares
# of max |logit| and of max |h|, |conv| for layer 0's state).  In bf16 the
# two paths round at other places and the random layers amplify it (on the
# CPU 15-25 % of max |logit| already at a prompt's first token, where no
# scan runs), so the bf16 share is printed, not bounded.
SSM_LOGIT_SHARE, SSM_STATE_SHARE = 1e-3, 1e-3


def feed_greedy(step, params, cache, prompts, new, forced=None, on_step=None):
    """Feed ``prompts`` (one a slot) through the decode ``step`` a token a
    step, then greedy tokens until every slot has ``new`` of them (with
    ``forced``, each slot's given tokens instead: teacher forcing), at
    least one step past the longest prompt.  ``on_step(t, logits, cache)``
    sees each step's ``(B, V)`` f32 logits.  Returns each slot's tokens
    and the cache."""
    import torch

    dev = cache["pos"].device
    lens = [len(p) for p in prompts]
    gen = [[] for _ in prompts]
    cur = [int(p[0]) for p in prompts]
    for t in range(max(lens) + max(new, 1) - 1):
        lg, cache = step(params, cache, torch.tensor(cur, device=dev)[:, None])
        lg = lg[:, 0].float()
        nxt = lg.argmax(-1).tolist()
        if on_step is not None:
            on_step(t, lg, cache)
        for b, n in enumerate(lens):
            if t >= n - 1 and len(gen[b]) < new:
                gen[b].append(nxt[b] if forced is None else int(forced[b][len(gen[b])]))
            if t + 1 < n:
                cur[b] = int(prompts[b][t + 1])
            else:
                cur[b] = gen[b][-1] if gen[b] else nxt[b]
    return gen, cache


def sharded_step(cfg, layout, params, cache, rules):
    """``(step, params, cache)``: ``engine.make_serve_step`` under
    ``rules`` (none: one device) and the rank's shard of ``params`` and
    ``cache`` (on a mesh of one rank the same tensors: no second copy)."""
    from repro_torch.models import model_zoo
    from repro_torch.serving import engine, sharded as shd

    if rules is not None:
        params = shd.shard_params(params, model_zoo.param_specs(cfg), rules, cfg)
        cache = shd.shard_cache(cache, cfg, layout, rules)
    return engine.make_serve_step(cfg, layout, rules), params, cache


def ssm_decode(cfg, params, prompts, new, device, timed=None, rules=None, rows=None):
    """Decode ``prompts`` (one a slot) through ``engine.make_serve_step``
    from a zero state (:func:`feed_greedy`; under ``rules`` on the rank's
    shard, :func:`sharded_step`).  Returns each slot's logits at its prompt
    positions ``(n, V)`` f32, layer 0's state ``(h, conv)`` just after its
    prompt, its greedy tokens and the cache; ``timed`` (a list) collects
    each step's CUDA event pair, ``rows`` (a list) each step's ``(B, V)``
    logits."""
    import torch

    from repro_torch.serving import kv_cache as kvc

    lens = [len(p) for p in prompts]
    layout = kvc.layout_for(cfg, len(prompts), SSM_MAX_SEQ)
    cache = kvc.init_cache_arrays(cfg, layout, device)
    step, params, cache = sharded_step(cfg, layout, params, cache, rules)
    if timed is not None:
        step = _timed(step, timed)
    logits_at = [torch.empty((n, cfg.vocab_size), dtype=torch.float32, device=device)
                 for n in lens]
    state_at = [None] * len(prompts)

    def keep(t, lg, cache):
        if rows is not None:
            rows.append(lg.clone())
        for b, n in enumerate(lens):
            if t < n:
                logits_at[b][t] = lg[b]
            if t == n - 1:
                state_at[b] = (cache["mamba"]["h"][0, b].clone(),
                               cache["mamba"]["conv"][0, b].clone())

    gen, cache = feed_greedy(step, params, cache, prompts, new, on_step=keep)
    return logits_at, state_at, gen, cache, layout


def ssm_forward_check(cfg, params, prompts, logits_at, state_at, device):
    """``model_zoo.forward`` at chunk :data:`SSM_CHECK_CHUNK` over each
    prompt against :func:`ssm_decode`'s logits at every prompt position,
    and layer 0's ``mixer_apply(return_state=True)`` state after the
    prompt against the decode's.  Returns the largest shares: logits of
    max |logit|, h of max |h|, the conv window of max |conv|, and whether
    every last position's argmax is the decode's."""
    import torch

    from repro_torch.models import layers, mamba2, model_zoo, transformer

    p0 = transformer.layer_params(params["layers"], 0)
    worst, same = [0.0, 0.0, 0.0], True
    for b, prompt in enumerate(prompts):
        tokens = torch.as_tensor(prompt, device=device)[None]
        lf, _ = model_zoo.forward(params, cfg, {"tokens": tokens}, chunk=SSM_CHECK_CHUNK)
        lf, ld = lf[0].float(), logits_at[b]
        x = layers.apply_norm(transformer.embed_tokens(params, cfg, tokens), p0["norm"],
                              cfg.norm)
        _, st = mamba2.mixer_apply(p0["mixer"], cfg, x, chunk=SSM_CHECK_CHUNK,
                                   return_state=True)
        h, conv = state_at[b][0], state_at[b][1].float()
        shares = (float((lf - ld).abs().max() / ld.abs().max()),
                  float((st["h"][0] - h).abs().max() / h.abs().max()),
                  float((st["conv"][0].float() - conv).abs().max() / conv.abs().max()))
        worst = [max(w, v) for w, v in zip(worst, shares)]
        same &= int(lf[-1].argmax()) == int(ld[-1].argmax())
    return worst, same


def ssm_phase(device, card):
    """mamba2-1.3b on the card (cut to :data:`SSM_DEPTH` layers), as the
    reference decodes it: through
    ``engine.make_serve_step`` alone from a zero state.

    * Decode (bf16): 4 slots (max_seq 1024, the slot layout ``layout_for``
      gives), the prompts of :data:`SSM_PROMPTS` fed a token a step, then
      :data:`SSM_NEW` greedy tokens each (:func:`ssm_decode`): ms a step
      (CUDA events), no kernel launched (the family runs none), peak GiB
      and the state's bytes; then 4 steps traced (device busy share, top
      device items).
    * Forward: ``model_zoo.forward`` at B 1, S 2048, chunk 256 timed (device
      ms, peak GiB); at chunk 64 over each prompt against the decode
      (:func:`ssm_forward_check`): in bf16 the shares are printed; on an
      f32 copy of the same weights the prompts are decoded again and the
      logits must agree within :data:`SSM_LOGIT_SHARE` of max |logit|,
      argmax equal at each last position, and layer 0's state within
      :data:`SSM_STATE_SHARE`.
    * long_500k: ``layout_for`` at B 1, max_seq 524,288 allocates the bytes
      of max_seq 1024; 16 steps run.
    * The CPU plain path: mamba2-smoke (f32) on the card and on the CPU,
      24 greedy steps of 2 slots: tokens equal, logits within 1e-4."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo
    from repro_torch.serving import engine, kv_cache as kvc

    cfg, params = init_model(SSM_ARCH, device, depth=SSM_DEPTH)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SSM_PROMPTS]
    B, V = len(prompts), cfg.vocab_size
    free_device()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    spans, rows = [], []
    t0 = time.perf_counter()
    logits_at, state_at, gen, cache, layout = ssm_decode(cfg, params, prompts, SSM_NEW, device,
                                                         timed=spans, rows=rows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in K.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"{cfg.name} decode launched kernels: {launched}")
    n_steps = len(spans)
    if list(map(len, gen)) != [SSM_NEW] * B or int(cache["pos"].min()) != n_steps:
        raise AssertionError(f"{cfg.name} decode: {list(map(len, gen))} tokens, pos "
                             f"{cache['pos'].tolist()}")
    state_bytes = kvc.cache_bytes(cache["mamba"])
    ms = np.mean([a.elapsed_time(b) for a, b in spans])
    print(f"[ssm] {cfg.name} decode, {B} slots ({layout.layout} layout, max_seq "
          f"{SSM_MAX_SEQ}): prompts of {SSM_PROMPTS} tokens fed a token a step from a zero "
          f"state, then {SSM_NEW} greedy tokens each, {n_steps} steps in {wall:.2f} s: "
          f"{ms:.3f} ms a step (CUDA events); launches: none; state {state_bytes} B "
          f"({state_bytes / B / 1e6:.3f} MB a slot: {cfg.num_layers} x (h {cfg.ssm_head_dim}x"
          f"{cfg.ssm_state} f32 x {cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} heads "
          f"+ conv window)); kv_read {kvc.decode_read_bytes(layout, cfg)['total']:.0f} B a "
          f"step (the reference's counter leaves the state out); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first tokens "
          f"{[g[:4] for g in gen]} [{card}]")
    step = engine.make_serve_step(cfg, layout)
    toks = torch.tensor([g[-1] for g in gen], device=device)[:, None]
    _traced(lambda: [step(params, cache, toks) for _ in range(4)],
            f"{cfg.name} decode: 4 steps of {B} slots", top=8)
    del cache
    sharded_decode_check(
        cfg, lambda r, t, w: ssm_decode(cfg, params, prompts, SSM_NEW, device, t, r, w)[2],
        (torch.stack(rows), gen, ms, {}), "decode", card)
    del rows

    # the whole-sequence forward, timed, then held to the decode
    fwd = torch.as_tensor(rng.integers(0, V, (1, SSM_FWD_S)), device=device)
    free_device()
    torch.cuda.reset_peak_memory_stats()
    run = lambda: model_zoo.forward(params, cfg, {"tokens": fwd}, chunk=SSM_FWD_CHUNK)
    fwd_ms = time_ms(run, iters=3)
    print(f"[ssm] {cfg.name} forward B 1, S {SSM_FWD_S}, chunk {SSM_FWD_CHUNK}: {fwd_ms:.3f} "
          f"ms (CUDA events, 3 calls), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB [{card}]")
    bf16, same16 = ssm_forward_check(cfg, params, prompts, logits_at, state_at, device)
    del logits_at, state_at
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree_map(lambda t: t.float(), params)
    logits32, state32, _, cache32, _ = ssm_decode(cfg32, params32, prompts, 0, device)
    del cache32
    f32, same32 = ssm_forward_check(cfg32, params32, prompts, logits32, state32, device)
    del logits32, state32, params32
    if f32[0] > SSM_LOGIT_SHARE or max(f32[1:]) > SSM_STATE_SHARE or not same32:
        raise AssertionError(f"{cfg.name} f32 forward vs decode: {f32} of max (bounds "
                             f"{SSM_LOGIT_SHARE} / {SSM_STATE_SHARE}), last argmax equal "
                             f"{same32}")
    print(f"[ssm] {cfg.name} forward (chunk {SSM_CHECK_CHUNK}) vs the token-by-token decode "
          f"over the four prompts, on an f32 copy of the weights: logits at every prompt "
          f"position within {f32[0]:.3e} of max |logit| (bound {SSM_LOGIT_SHARE}), argmax "
          f"equal at each last position; layer 0's mixer_apply(return_state=True) state "
          f"within {f32[1]:.3e} (h) and {f32[2]:.3e} (conv window) of max (bound "
          f"{SSM_STATE_SHARE}).  In {cfg.dtype} (not bounded: rounding through "
          f"{cfg.num_layers} layers): logits {bf16[0]:.3e}, h {bf16[1]:.3e}, conv {bf16[2]:.3e}, last argmax "
          f"equal {same16}")

    # long_500k: the same state bytes; 16 steps
    free_device()
    long_lay = kvc.layout_for(cfg, 1, 524288)
    long_cache = kvc.init_cache_arrays(cfg, long_lay, device)
    short = kvc.cache_bytes(kvc.init_cache_arrays(cfg, kvc.layout_for(cfg, 1, SSM_MAX_SEQ),
                                                  device))
    if kvc.cache_bytes(long_cache) != short:
        raise AssertionError(f"{cfg.name}: max_seq 524288 allocates "
                             f"{kvc.cache_bytes(long_cache)} B, "
                             f"max_seq {SSM_MAX_SEQ} {short} B")
    spans = []
    long_step = _timed(engine.make_serve_step(cfg, long_lay), spans)
    tok = torch.tensor([[int(prompts[0][0])]], device=device)
    for _ in range(16):
        lg, long_cache = long_step(params, long_cache, tok)
        tok = lg[:, 0].argmax(-1)[:, None]
    if not bool(torch.isfinite(lg).all()) or int(long_cache["pos"][0]) != 16:
        raise AssertionError(f"{cfg.name} long_500k decode is malformed")
    print(f"[ssm] {cfg.name} long_500k (B 1, max_seq 524288): cache "
          f"{kvc.cache_bytes(long_cache)} B, "
          f"the same as at max_seq {SSM_MAX_SEQ}; 16 steps at "
          f"{np.mean([a.elapsed_time(b) for a, b in spans]):.3f} ms a step [{card}]")
    del params, long_cache
    free_device()

    # the CPU plain path
    scfg = get_config(SSM_ARCH, smoke=True)
    cpu = model_zoo.init(scfg, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for key, dev, p in (("cpu", "cpu", cpu), ("card", device, _tree_to(cpu, device))):
        lay = kvc.layout_for(scfg, 2, 64)
        c = kvc.init_cache_arrays(scfg, lay, dev)
        st = engine.make_serve_step(scfg, lay)
        tok = torch.tensor([[1], [2]], device=dev)
        rows, toks = [], []
        for _ in range(24):
            lg, c = st(p, c, tok)
            tok = lg[:, 0].argmax(-1)[:, None]
            rows.append(lg[:, 0].float().cpu())
            toks.append(tok[:, 0].tolist())
        out[key] = (torch.stack(rows), toks)
    diff = float((out["card"][0] - out["cpu"][0]).abs().max())
    if out["card"][1] != out["cpu"][1] or diff > 1e-4:
        raise AssertionError(f"{scfg.name}: card and CPU differ (logits {diff:.3e})")
    print(f"[check] {scfg.name} (f32): 24 greedy steps of 2 slots, card and CPU tokens equal, "
          f"logits within {diff:.3e} (bound 1e-4)")


# jamba-1.5-large-398b (the hybrid family) at full width, as the reference
# serves it: make_serve_step from a zero state, no Scheduler.  One super-block
# of its published width is 45.14 B parameters (84.1 GiB in bf16), so the
# card holds its depth cut 72 -> 8 (the smallest whole super-block) and its
# experts 16 -> 8 (top-2 kept): 25.81 B parameters, 48.1 GiB.  4 slots fed
# prompts of 48-80 tokens, then 16 greedy tokens, in each KV format (paged,
# page 16, max_seq 1024); the forward at B 1, S 2048, SSD chunk 256
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_DEPTH, HYBRID_EXPERTS = 8, 8
HYBRID_PROMPTS = (48, 56, 64, 80)
HYBRID_NEW, HYBRID_MAX_SEQ, HYBRID_PAGE = 16, 1024, 16
HYBRID_FORMATS = ("bf16", "int8", "bgpp")
HYBRID_SHARD_FORMATS = ("bf16", "bgpp")  # served again through a 1x1 NCCL mesh
HYBRID_FWD_S, HYBRID_FWD_CHUNK = 2048, 256
# jamba-smoke (f32) on the card against the CPU: 24 greedy steps of 2 slots
# (max_seq 64, page 8); logits within 1e-4 in bf16 KV and, teacher-forced
# with the CPU's tokens, within 5e-3 in int8 / bgpp KV, the bound of the
# reference cells' smokes with 4 heads of 16 (REFERENCE_MODELS); the forward
# on the card within 1e-4 of max |logit| of the CPU's and of the card's
# token-by-token decode (S 32, SSD chunk 16)
HYBRID_SMOKE_STEPS, HYBRID_SMOKE_SEQ, HYBRID_SMOKE_CHUNK = 24, 32, 16
HYBRID_CPU_TOL, HYBRID_CODE_TOL, HYBRID_LOGIT_SHARE = 1e-4, 5e-3, 1e-4
# the forward against the decode at full width on f32 weights: 2 experts,
# top-2 (every token takes both, so no near-tied router can route the two
# paths apart), 11.3 B params, 45 GB; two summation orders of one model, as
# the ssm phase's SSM_LOGIT_SHARE
HYBRID_F32_EXPERTS, HYBRID_F32_SHARE = 2, 1e-3


def hybrid_decode(cfg, params, fmt, prompts, new, device, timed=None, rules=None, every=None):
    """Decode ``prompts`` (one a slot) through ``engine.make_serve_step``
    from a zero state, paged with an identity page table
    (:func:`feed_greedy`; under ``rules`` on the rank's shard,
    :func:`sharded_step`).  Returns each slot's logits at its prompt
    positions ``(n, V)`` f32, its greedy tokens, the cache and the layout;
    ``timed`` (a list) collects each step's CUDA event pair, ``every`` (a
    list) each step's ``(B, V)`` logits."""
    import torch

    from repro_torch.serving import kv_cache as kvc

    lay = kvc.layout_for(cfg, len(prompts), HYBRID_MAX_SEQ, kv_format=fmt, layout="paged",
                         page_size=HYBRID_PAGE)
    cache = kvc.init_cache_arrays(cfg, lay, device)
    cache["page_table"] = kvc.identity_page_table(lay, device)
    step, params, cache = sharded_step(cfg, lay, params, cache, rules)
    if timed is not None:
        step = _timed(step, timed)
    lens = [len(p) for p in prompts]
    rows = [torch.empty((n, cfg.vocab_size), dtype=torch.float32, device=device) for n in lens]

    def keep(t, lg, cache):
        if every is not None:
            every.append(lg.clone())
        for b, n in enumerate(lens):
            if t < n:
                rows[b][t] = lg[b]

    gen, cache = feed_greedy(step, params, cache, prompts, new, on_step=keep)
    return rows, gen, cache, lay


def hybrid_phase(device, card):
    """jamba-1.5-large-398b on the card at full width, one super-block and
    8 of its 16 experts (:func:`init_model` prints both cuts), as the
    reference serves the hybrid: ``engine.make_serve_step`` from a zero
    state, no Scheduler.

    * Decode, for each of :data:`HYBRID_FORMATS`: 4 slots (paged, page 16,
      max_seq 1024) fed :data:`HYBRID_PROMPTS` a token a step, then
      :data:`HYBRID_NEW` greedy tokens (:func:`hybrid_decode`): K1 (bf16 /
      int8) or K2 (bgpp) exactly once a step and nothing else, ms a step
      (CUDA events), peak GiB, the mamba state's bytes.
    * Forward: ``model_zoo.forward`` at B 1, S 2048, SSD chunk 256 (K5
      once), ms over 3 calls and peak GiB, beside K5 held to its plain
      version at that shape (:func:`flash_case`: seeded bf16 q / k / v of
      jamba's 64/8 heads of 128, causal, two launches bit-identical, the
      kernel phase's tolerance, timed); then over each prompt, its
      logits at the last position beside the bf16 decode's, as a share of
      max |logit|, printed and not bounded: the forward routes at capacity
      1.25 (it drops tokens, the dropless decode does not) and bf16 rounds
      at other places through 8 random layers; again with the forward
      dropless, which leaves the rounding alone.
    * Traces, once every run is timed: 4 decode steps in each format
      (device busy share, top device items, K1's / K2's device ms a
      launch).
    * The forward against the decode at full width on f32 weights with 2
      experts (:func:`hybrid_f32_check`), bounded.
    * jamba-smoke on the card against the CPU (:func:`hybrid_smoke_checks`).
    Returns the launches of each kernel over the phase's timed runs and
    the K5 record of the forward's shape."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.models import model_zoo
    from repro_torch.serving import engine, kv_cache as kvc

    cfg, params = init_model(HYBRID_ARCH, device, depth=HYBRID_DEPTH, experts=HYBRID_EXPERTS)
    B, V = len(HYBRID_PROMPTS), cfg.vocab_size
    total = {name: 0 for name in K.LAUNCHES}

    def count(what, want):
        got = dict(K.LAUNCHES)
        for name, n in got.items():
            if n != want.get(name, 0):
                raise AssertionError(f"{cfg.name} {what}: {name} launched {n} times, "
                                     f"expected {want.get(name, 0)}")
            total[name] += n
        return ", ".join(f"{n} {v}" for n, v in got.items() if v) or "none"

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, n) for n in HYBRID_PROMPTS]
    kept, last_of, unsharded = {}, {}, {}
    for fmt in HYBRID_FORMATS:
        free_device()
        torch.cuda.reset_peak_memory_stats()
        spans, every = [], ([] if fmt in HYBRID_SHARD_FORMATS else None)
        K.reset_launches()
        t0 = time.perf_counter()
        rows, gen, cache, lay = hybrid_decode(cfg, params, fmt, prompts, HYBRID_NEW, device,
                                              timed=spans, every=every)
        last = [r[-1] for r in rows]
        del rows
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = len(spans)
        counts = count(f"{fmt} decode", {KERNEL_OF[fmt]: steps})
        if (list(map(len, gen)) != [HYBRID_NEW] * B or int(cache["pos"].min()) != steps
                or not all(bool(torch.isfinite(r).all()) and r.shape == (V,) for r in last)):
            raise AssertionError(f"{cfg.name} {fmt} decode is malformed")
        st = cache["mamba"]
        h_b, conv_b = (st[n].numel() * st[n].element_size() for n in ("h", "conv"))
        ms = np.mean([a.elapsed_time(b) for a, b in spans])
        print(f"[hybrid] {cfg.name} {fmt} KV paged (page {HYBRID_PAGE}, max_seq "
              f"{HYBRID_MAX_SEQ}), {B} slots: prompts of {HYBRID_PROMPTS} tokens fed a token a "
              f"step from a zero state, then {HYBRID_NEW} greedy tokens each, {steps} steps in "
              f"{wall:.2f} s: {ms:.3f} ms a step (CUDA events); launches: {counts} (1 "
              f"attention layer x {steps} steps); mamba state {h_b + conv_b} B (h {h_b} B = "
              f"{len(lay.mamba_layers)} layers x {B} x {cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim}"
              f" x {cfg.ssm_head_dim} x {cfg.ssm_state} x 4 B, conv windows {conv_b} B); "
              f"kv_read {kvc.decode_read_bytes(lay, cfg)['total']:.0f} B a step (the state "
              f"left out, as the reference counts); peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first tokens "
              f"{[g[:4] for g in gen]} [{card}]")
        kept[fmt] = (lay, cache, [g[-1] for g in gen])
        last_of[fmt] = last
        if every is not None:
            unsharded[fmt] = (torch.stack(every), gen, ms, {KERNEL_OF[fmt]: steps})
        del cache, every

    # the whole-sequence forward, timed, then beside the bf16 decode
    free_device()
    torch.cuda.reset_peak_memory_stats()
    toks = torch.as_tensor(rng.integers(0, V, (1, HYBRID_FWD_S)), device=device)
    run = lambda: model_zoo.forward(params, cfg, {"tokens": toks}, ssd_chunk=HYBRID_FWD_CHUNK)
    K.reset_launches()
    logits, aux = run()
    torch.cuda.synchronize()
    counts = count("forward", {"flash_attention": 1})
    if logits.shape != (1, HYBRID_FWD_S, V) or not bool(torch.isfinite(logits).all()) \
            or not bool(torch.isfinite(aux)):
        raise AssertionError(f"{cfg.name} forward is malformed")
    del logits
    fwd_ms = time_ms(run, iters=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # K5 at the forward's own shape against its plain version
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(90)
    mk = lambda H: torch.randn((1, HYBRID_FWD_S, H, D), generator=gen,
                               device=device).to(torch.bfloat16)
    case = f"{cfg.name} forward: Hq {Hq} Hk {Hk} D {D} causal B1 S{HYBRID_FWD_S} bf16"
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    k5 = flash_case(case, mk(Hq), mk(Hk), mk(Hk),
                    dict(mask_kind="causal", window=0, q_offset=0), l2.zero_, twice=True,
                    case=case)
    del l2
    print(f"[hybrid] {cfg.name} forward B 1, S {HYBRID_FWD_S}, SSD chunk {HYBRID_FWD_CHUNK}, "
          f"MoE capacity factor {cfg.moe_capacity_factor}: {fwd_ms:.3f} ms (CUDA events, 3 "
          f"calls); launches a call: {counts}; aux {float(aux):.4f}; peak {peak:.2f} GiB; "
          f"K5 at this shape against its plain version (seeded bf16 q / k / v): "
          f"max_abs_err {k5['max_abs_err']:.3e}, worst err/tol {k5['err_over_tol']:.3f}, "
          f"{k5['ms']:.4f} ms a launch [{card}]")
    dropless = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
    for fcfg, what in ((cfg, f"capacity {cfg.moe_capacity_factor}"),
                       (dropless, "dropless, as the decode routes")):
        shares, same = [], 0
        for b, prompt in enumerate(prompts):
            tokens = torch.as_tensor(prompt, device=device)[None]
            lf = model_zoo.forward(params, fcfg, {"tokens": tokens},
                                   ssd_chunk=HYBRID_FWD_CHUNK)[0][0, -1].float()
            ld = last_of["bf16"][b]
            shares.append(float((lf - ld).abs().max() / ld.abs().max()))
            same += int(lf.argmax()) == int(ld.argmax())
        print(f"[hybrid] {cfg.name} forward ({what}) over each prompt against the bf16 decode "
              f"at its last position: {[f'{x:.3e}' for x in shares]} of max |logit|, argmax "
              f"equal in {same} of {B} (not bounded: bf16 rounds at other places in the two "
              f"paths through {cfg.num_layers} random layers, and the decode's residual is f32 "
              f"past the attention layer)")
    del last_of
    for fmt in HYBRID_SHARD_FORMATS:  # the sharded runs' launches count beside the rest
        decode = lambda r, t, w, f=fmt: hybrid_decode(cfg, params, f, prompts, HYBRID_NEW,
                                                      device, t, r, w)[1]
        for name, n in sharded_decode_check(cfg, decode, unsharded.pop(fmt), f"{fmt} KV decode",
                                            card).items():
            total[name] += n

    # traces, once every run above is timed
    heads = f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}"
    for fmt in HYBRID_FORMATS:
        lay, cache, last = kept.pop(fmt)
        step = engine.make_serve_step(cfg, lay)
        tok = torch.tensor(last, device=device)[:, None]
        dev = _traced(lambda: [step(params, cache, tok) for _ in range(4)],
                      f"{cfg.name} {fmt} KV decode: 4 steps of {B} slots", top=10)
        per_launch(dev, f"{KERNEL_OF[fmt]} (1 global layer, {heads})", (BODY_OF[fmt],))
        del cache
    del params
    free_device()
    hybrid_f32_check(cfg, prompts, device)
    hybrid_smoke_checks(device)
    return total, [k5]


def hybrid_f32_check(cfg, prompts, device):
    """The forward against the token-by-token decode at full width, on f32
    weights (seed 0) with the experts cut to :data:`HYBRID_F32_EXPERTS`,
    top-2 kept, routed dropless in both: each prompt decoded from a zero
    state (bf16-format KV, which stores the model dtype), then
    ``model_zoo.forward`` over it (SSD chunk 256); the logits at every
    prompt position within :data:`HYBRID_F32_SHARE` of max |logit|, argmax
    equal at each last position."""
    import dataclasses

    import torch

    from repro_torch.models import model_zoo

    E = HYBRID_F32_EXPERTS
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_experts=E,
                                moe_capacity_factor=float(E))
    params = model_zoo.init(cfg32, torch.Generator(device=device).manual_seed(0), device)
    nparam = sum(t.numel() for t in _leaves(params))
    rows, _, cache, _ = hybrid_decode(cfg32, params, "bf16", prompts, 0, device)
    del cache
    worst, same = 0.0, 0
    for b, prompt in enumerate(prompts):
        tokens = torch.as_tensor(prompt, device=device)[None]
        lf = model_zoo.forward(params, cfg32, {"tokens": tokens},
                               ssd_chunk=HYBRID_FWD_CHUNK)[0][0]
        worst = max(worst, float((lf - rows[b]).abs().max() / rows[b].abs().max()))
        same += int(lf[-1].argmax()) == int(rows[b][-1].argmax())
    print(f"[hybrid] {cfg.name} at full width in f32, {cfg.num_layers} layers, {E} experts "
          f"top-{cfg.experts_per_token} ({nparam / 1e9:.3f} B params): the forward against "
          f"the token-by-token decode over the four prompts, logits at every prompt "
          f"position within {worst:.3e} of max |logit| (bound {HYBRID_F32_SHARE}), argmax "
          f"equal at {same} of {len(prompts)} last positions")
    if worst > HYBRID_F32_SHARE or same != len(prompts):
        raise AssertionError(f"{cfg.name} f32: the forward and the decode disagree")
    del params, rows
    free_device()


def hybrid_smoke_checks(device):
    """jamba-smoke (f32) on the card against the CPU, from the same
    parameters (seed 0):

    * the forward (B 2, S :data:`HYBRID_SMOKE_SEQ`, SSD chunk 16; K5 once)
      within :data:`HYBRID_LOGIT_SHARE` of max |logit|;
    * ``make_serve_step``, :data:`HYBRID_SMOKE_STEPS` greedy steps of 2
      slots from a zero state in every KV format and layout: bf16 tokens
      equal and logits within :data:`HYBRID_CPU_TOL`; int8 / bgpp
      teacher-forced with the CPU's tokens, within
      :data:`HYBRID_CODE_TOL`; K1 / K2 once a step;
    * the forward against the card's own token-by-token decode (bf16 KV,
      slot) within :data:`HYBRID_LOGIT_SHARE` of max |logit|;
    * one remat train step (:func:`train_smoke_check`: K5 twice, K5b once,
      and with K5b's launch skipped the grads must fail the bound)."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo
    from repro_torch.serving import engine, kv_cache as kvc

    cfg = get_config(HYBRID_ARCH, smoke=True)
    cpu = model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = _tree_to(cpu, device)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, HYBRID_SMOKE_SEQ)))
    want = model_zoo.forward(cpu, cfg, {"tokens": toks}, ssd_chunk=HYBRID_SMOKE_CHUNK)[0]
    K.reset_launches()
    got = model_zoo.forward(gpu, cfg, {"tokens": toks.to(device)},
                            ssd_chunk=HYBRID_SMOKE_CHUNK)[0]
    torch.cuda.synchronize()
    if K.LAUNCHES["flash_attention"] != 1:
        raise AssertionError(f"{cfg.name} forward: K5 launched "
                             f"{K.LAUNCHES['flash_attention']} times, want 1")
    scale = float(want.abs().max())
    err = float((got.cpu() - want).abs().max())
    print(f"[check] {cfg.name} (f32) forward B 2, S {HYBRID_SMOKE_SEQ}, card against CPU: "
          f"max |logit diff| {err:.3e} = {err / scale:.3e} of max |logit| (bound "
          f"{HYBRID_LOGIT_SHARE}); K5 1 launch")
    if not err <= HYBRID_LOGIT_SHARE * scale:
        raise AssertionError(f"{cfg.name}: the forward disagrees card / CPU")

    def decode(params, dev, lay, first, forced=None):
        cache = kvc.init_cache_arrays(cfg, lay, dev)
        if lay.layout == "paged":
            cache["page_table"] = kvc.identity_page_table(lay, dev)
        step = engine.make_serve_step(cfg, lay)
        tok = torch.tensor(first, device=dev)[:, None]
        rows, out = [], []
        for t in range(HYBRID_SMOKE_STEPS):
            lg, cache = step(params, cache, tok)
            nxt = lg[:, 0].argmax(-1)
            rows.append(lg[:, 0].float().cpu())
            out.append(nxt.tolist())
            tok = (nxt if forced is None else torch.tensor(forced[t], device=dev))[:, None]
        return torch.stack(rows), out

    first = [1, 2]
    for fmt in HYBRID_FORMATS:
        for layout in ("paged", "slot"):
            lay = kvc.layout_for(cfg, 2, 64, kv_format=fmt, layout=layout, page_size=8)
            ref_rows, ref_toks = decode(cpu, "cpu", lay, first)
            K.reset_launches()
            rows, toks_ = decode(gpu, device, lay, first,
                                 forced=None if fmt == "bf16" else ref_toks)
            torch.cuda.synchronize()
            launched = {k: v for k, v in K.LAUNCHES.items() if v}
            if launched != {KERNEL_OF[fmt]: HYBRID_SMOKE_STEPS}:
                raise AssertionError(f"{cfg.name} {fmt} {layout} decode launched {launched}")
            err = float((rows - ref_rows).abs().max())
            tol = HYBRID_CPU_TOL if fmt == "bf16" else HYBRID_CODE_TOL
            same = toks_ == ref_toks
            print(f"[check] {cfg.name} {fmt} KV {layout}: {HYBRID_SMOKE_STEPS} steps of 2 "
                  f"slots{'' if fmt == 'bf16' else ' teacher-forced with the CPU tokens'}, "
                  f"card and CPU greedy tokens equal {same}, max |logit diff| {err:.3e} "
                  f"(tolerance {tol}); {KERNEL_OF[fmt]} {HYBRID_SMOKE_STEPS} launches")
            if not err <= tol or (fmt == "bf16" and not same):
                raise AssertionError(f"{cfg.name} {fmt} {layout}: card and CPU disagree")

    # the forward against the card's token-by-token decode
    lay = kvc.layout_for(cfg, 2, 64, kv_format="bf16")
    cache = kvc.init_cache_arrays(cfg, lay, device)
    step = engine.make_serve_step(cfg, lay)
    gtoks = toks.to(device)
    rows = []
    for t in range(HYBRID_SMOKE_SEQ):
        lg, cache = step(gpu, cache, gtoks[:, t:t + 1])
        rows.append(lg[:, 0].float())
    dec = torch.stack(rows, 1)
    scale = float(got.abs().max())
    err = float((dec - got).abs().max())
    print(f"[check] {cfg.name} (f32) forward against the token-by-token decode on the card, "
          f"S {HYBRID_SMOKE_SEQ}: {err / scale:.3e} of max |logit| (bound "
          f"{HYBRID_LOGIT_SHARE})")
    if not err <= HYBRID_LOGIT_SHARE * scale:
        raise AssertionError(f"{cfg.name}: the forward and the decode disagree on the card")
    del cpu, gpu, cache
    train_smoke_check(HYBRID_ARCH, "one super-block, attention at layer 4", device,
                      skip_check=True, k5_launches=2)


# whisper-medium (the enc_dec family) at full width and depth, decoded as the
# reference decodes it: the encoder once, its memory projected into the
# cache's cross_k / cross_v, then make_serve_step a token a step from
# position 0 (no Scheduler, no prefill).  4 slots fed prompts of 16-48
# tokens, then 16 greedy tokens, in each (KV format, layout) of
# WHISPER_RUNS (paged: page 16, max_seq 1024); the decode_32k layout
# (max_seq 32768) at B 2 for 16 steps in WHISPER_LONG_FORMATS; the forward
# at B 1, S 128
WHISPER_ARCH = "whisper-medium"
WHISPER_PROMPTS = (16, 24, 32, 48)
WHISPER_NEW, WHISPER_MAX_SEQ, WHISPER_PAGE = 16, 1024, 16
WHISPER_RUNS = (("bf16", "paged"), ("int8", "paged"), ("bgpp", "paged"), ("bf16", "slot"))
WHISPER_LONG_SEQ, WHISPER_LONG_B, WHISPER_LONG_STEPS = 32768, 2, 16
WHISPER_LONG_FORMATS = ("bgpp", "int8")
# served again through make_serve_step on a 1x1 NCCL mesh (ROADMAP item 7c-ii (b))
WHISPER_SHARD_RUNS = (("bf16", "paged"), ("bgpp", "paged"))
WHISPER_FWD_S, WHISPER_CPU_STEPS = 128, 4
# the card against the CPU at full width over 4 steps from one cache: 1e-4
# of max |logit|.  Both sides run the decode in f32 on the same weights and
# cache (the residual is f32 from layer 0's attend on), so they differ by
# f32 summation orders, diluted over the 63+ lanes each slot attends; a
# decode with K1 blind to each slot's newest lane, teacher-forced with the
# CPU's tokens, is read beside it and must fall outside the bound
WHISPER_CPU_SHARE = 1e-4


def whisper_frames(cfg, batch: int, seed: int, device):
    """Stub post-conv frames ``(batch, encoder_seq, d_audio)`` f32, drawn
    with numpy from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_audio), dtype=np.float32)
    return torch.from_numpy(frames).to(device)


def whisper_cache(cfg, cross, fmt, layout, batch, max_seq, device, page=WHISPER_PAGE):
    """A zero cache for ``batch`` slots (paged: pages of ``page``, an
    identity page table) with ``cross`` (``whisper.cross_kv``'s stacked K /
    V, at least ``batch`` rows) in its cross memory."""
    from repro_torch.serving import kv_cache as kvc

    lay = kvc.layout_for(cfg, batch, max_seq, kv_format=fmt, layout=layout, page_size=page)
    cache = kvc.init_cache_arrays(cfg, lay, device)
    if layout == "paged":
        cache["page_table"] = kvc.identity_page_table(lay, device)
    cache["cross_k"].copy_(cross[0][:, :batch])
    cache["cross_v"].copy_(cross[1][:, :batch])
    return lay, cache


def whisper_decode(cfg, params, cache, layout, prompts, new, forced=None, timed=None,
                   rules=None, every=None):
    """Feed ``prompts`` (one a slot) through ``engine.make_serve_step``
    from the cache's positions, then ``new`` greedy (or ``forced``) tokens
    (:func:`feed_greedy`; under ``rules`` on the rank's shard,
    :func:`sharded_step`).  Returns each slot's logits at its generated
    positions ``(new, V)`` f32 on the CPU, its tokens and the cache;
    ``timed`` (a list) collects each step's CUDA event pair, ``every`` (a
    list) each step's ``(B, V)`` logits."""
    import torch

    step, params, cache = sharded_step(cfg, layout, params, cache, rules)
    if timed is not None:
        step = _timed(step, timed)
    lens = [len(p) for p in prompts]
    rows = [[] for _ in prompts]

    def keep(t, lg, cache):
        if every is not None:
            every.append(lg.clone())
        for b, n in enumerate(lens):
            if n - 1 <= t < n - 1 + new:
                rows[b].append(lg[b].cpu())

    gen, cache = feed_greedy(step, params, cache, prompts, new, forced=forced, on_step=keep)
    return [torch.stack(r) for r in rows], gen, cache


def whisper_cpu_check(cfg, params, lay, cache, last, cross, device):
    """The card against the CPU at full width: :data:`WHISPER_CPU_STEPS`
    greedy steps from ``cache`` on the card and on CPU copies of the cache
    and weights (the plain versions), fed ``last`` first, in two variants:

    * bf16, the cache as the decode left it: greedy tokens equal, logits
      within :data:`WHISPER_CPU_SHARE` of max |logit|; the same steps with
      K1 blind to each slot's newest lane (teacher-forced with the CPU's
      tokens) must read more.
    * f32 (weights, cache and cross memory upcast exactly) with slot 0
      reset and its cross memory refilled, so the slots decode at other
      positions: tokens equal, logits within the same bound.  f32 K / V,
      because a fresh slot attends one to four lanes, which pass a bf16
      store's rounding of the two sides' f32 values on undiluted.

    Each prints the largest difference a slot."""
    import dataclasses

    import torch

    from repro_torch.serving import engine, kernel_decode, kv_cache as kvc

    sound = kernel_decode.decode_attend
    blind = lambda q, store, gi, pos, *a, **kw: sound(q, store, gi, (pos - 1).clamp_min(0),
                                                      *a, **kw)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    up = lambda t: t.float() if t.is_floating_point() else t.clone()
    for name, cfg_, params_, base in (("bf16", cfg, params, cache),
                                      ("f32, slot 0 reset", cfg32, None, None)):
        t0 = time.perf_counter()
        if base is None:
            params_ = _tree_map(up, params)
            base = kvc.reset_slot(_tree_map(up, cache), lay, 0)
            base["cross_k"][:, 0], base["cross_v"][:, 0] = cross[0][:, 0], cross[1][:, 0]
        step = engine.make_serve_step(cfg_, lay)
        sides = [("cpu", "cpu", _tree_to(params_, "cpu"), _tree_to(base, "cpu")),
                 ("card", device, params_, _tree_map(torch.clone, base))]
        if name == "bf16":
            sides.append(("fault", device, params_, _tree_map(torch.clone, base)))
        got = {}
        for key, dev, p, c in sides:
            tok = torch.tensor(last, device=dev)[:, None]
            rows, toks = [], []
            kernel_decode.decode_attend = blind if key == "fault" else sound
            try:
                for i in range(WHISPER_CPU_STEPS):
                    lg, c = step(p, c, tok)
                    tok = lg[:, 0].argmax(-1)[:, None]
                    if key == "fault":
                        tok = torch.tensor(got["cpu"][1][i], device=dev)[:, None]
                    rows.append(lg[:, 0].float().cpu())
                    toks.append(tok[:, 0].tolist())
            finally:
                kernel_decode.decode_attend = sound
            got[key] = (torch.stack(rows), toks)
            del c
        del sides, params_, base
        scale = float(got["cpu"][0].abs().max())
        diff = {k: (v[0] - got["cpu"][0]).abs().amax(dim=(0, 2)) for k, v in got.items()
                if k != "cpu"}
        err = float(diff["card"].max())
        fault = (f"; K1 blind to each slot's newest lane, teacher-forced: "
                 f"{float(diff['fault'].max()) / scale:.4e} of it" if "fault" in diff else "")
        print(f"[check] {cfg.name} ({name}, full width and depth) {WHISPER_CPU_STEPS} greedy "
              f"steps of {len(last)} slots at positions {cache['pos'].tolist()}"
              f"{' -> slot 0 at 0' if name != 'bf16' else ''} from the bf16 paged run's cache, "
              f"on the card and on CPU copies of the cache and weights (the plain versions): "
              f"tokens equal {got['card'][1] == got['cpu'][1]}, max |logit diff| "
              f"{err:.4e} = {err / scale:.4e} of max |logit| {scale:.4e} (bound "
              f"{WHISPER_CPU_SHARE:.4e}; a slot: "
              f"{[f'{float(d) / scale:.2e}' for d in diff['card']]}){fault}; "
              f"{time.perf_counter() - t0:.1f} s")
        if got["card"][1] != got["cpu"][1] or err > WHISPER_CPU_SHARE * scale:
            raise AssertionError(f"{cfg.name} ({name}): card and CPU decode disagree")
        if "fault" in diff and not float(diff["fault"].max()) > WHISPER_CPU_SHARE * scale:
            raise AssertionError(f"{cfg.name}: the card-vs-CPU bound does not tell a blind "
                                 f"K1 from a sound one")
        free_device()


def whisper_phase(device, card):
    """whisper-medium on the card, as the reference serves enc_dec (no
    Scheduler: ``whisper.encode`` once, ``cross_kv`` into the cache, then
    ``engine.make_serve_step`` from position 0).

    * Encoder: B 4 of :func:`whisper_frames` (seed 0), K5's full mask over
      1500 frames in all 24 layers (24 launches a call), ms (CUDA events,
      3 calls) and peak GiB; ``cross_kv`` into the cross memory.
    * Decode: for each run of :data:`WHISPER_RUNS`, 4 slots fed
      :data:`WHISPER_PROMPTS` a token a step, then :data:`WHISPER_NEW`
      greedy tokens (:func:`whisper_decode`): ms a step, K1 (bf16 / int8)
      or K2 (bgpp) exactly 24 launches a step and nothing else, tokens and
      logits well formed, ``pos`` the step count, peak GiB, ``kv_read``
      against the cross memory a step reads.
    * The card against the CPU from the bf16 paged run's final cache
      (:func:`whisper_cpu_check`): bf16 as it is, and an f32 copy with
      slot 0 reset, so the slots' positions differ.
    * The encoder and the :data:`WHISPER_SHARD_RUNS` decodes again on a
      1x1 NCCL mesh (:func:`whisper_sharded`), bit for bit.
    * decode_32k: max_seq 32768, B 2, :data:`WHISPER_LONG_FORMATS`, 16
      steps each (K1's int8 body / K2 over 32768 lanes, 24 a step).
    * Forward: ``model_zoo.forward`` at B 1, S 128 (K5 72 launches: 24
      full, 24 causal, 24 cross), ms and peak GiB.
    * Traces, after everything is timed: one encode (K5's device ms a
      launch at S 1500), 2 bf16 and 2 bgpp decode steps (device busy
      share, K1's and K2's device ms a launch).
    Returns the launches of each kernel over the phase's timed runs."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.models import model_zoo, whisper
    from repro_torch.serving import engine, kv_cache as kvc

    cfg, params = init_model(WHISPER_ARCH, device)
    L, B, V = cfg.num_layers, len(WHISPER_PROMPTS), cfg.vocab_size
    total = {name: 0 for name in K.LAUNCHES}

    def count(what, want):
        got = dict(K.LAUNCHES)
        for name, n in got.items():
            if n != want.get(name, 0):
                raise AssertionError(f"{cfg.name} {what}: {name} launched {n} times, "
                                     f"expected {want.get(name, 0)}")
            total[name] += n
        return ", ".join(f"{n} {v}" for n, v in got.items() if v) or "none"

    # the encoder, once per request, then its memory into the cross K / V
    frames = whisper_frames(cfg, B, 0, device)
    free_device()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    memory = whisper.encode(params, cfg, frames)
    torch.cuda.synchronize()
    counts = count("encoder", {"flash_attention": cfg.encoder_layers})
    enc_ms = time_ms(lambda: whisper.encode(params, cfg, frames), iters=3)
    t0 = time.perf_counter()
    cross = whisper.cross_kv(params, cfg, memory)
    torch.cuda.synchronize()
    cross_s = time.perf_counter() - t0
    if not bool(torch.isfinite(memory).all()) or memory.shape != (B, cfg.encoder_seq,
                                                                 cfg.d_model):
        raise AssertionError(f"{cfg.name} encoder output is malformed")
    cross_b = 2 * cross[0][:, :1].numel() * cross[0].element_size()
    print(f"[whisper] {cfg.name} encoder, B {B} x {cfg.encoder_seq} frames: {enc_ms:.3f} ms "
          f"(CUDA events, 3 calls); launches a call: {counts}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; cross_kv into the cache's "
          f"memory in {cross_s * 1e3:.1f} ms, {cross_b} B a slot ({L} layers x "
          f"{cfg.num_kv_heads} heads x {cfg.encoder_seq} x {cfg.head_dim} x K and V) [{card}]")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, n) for n in WHISPER_PROMPTS]
    kept, tokens_of, unsharded = {}, {}, {}
    for fmt, layout in WHISPER_RUNS:
        free_device()
        torch.cuda.reset_peak_memory_stats()
        lay, cache = whisper_cache(cfg, cross, fmt, layout, B, WHISPER_MAX_SEQ, device)
        spans, every = [], ([] if (fmt, layout) in WHISPER_SHARD_RUNS else None)
        K.reset_launches()
        t0 = time.perf_counter()
        rows, gen, cache = whisper_decode(cfg, params, cache, lay, prompts, WHISPER_NEW,
                                          timed=spans, every=every)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = len(spans)
        counts = count(f"{fmt} {layout} decode", {KERNEL_OF[fmt]: L * steps})
        if (list(map(len, gen)) != [WHISPER_NEW] * B or int(cache["pos"].min()) != steps
                or not all(bool(torch.isfinite(r).all()) and r.shape == (WHISPER_NEW, V)
                           for r in rows)):
            raise AssertionError(f"{cfg.name} {fmt} {layout} decode is malformed")
        tokens_of[(fmt, layout)] = gen
        kv = kvc.decode_read_bytes(lay, cfg)["total"]
        ms = np.mean([a.elapsed_time(b) for a, b in spans])
        if every is not None:
            unsharded[fmt] = (torch.stack(every), gen, ms, {KERNEL_OF[fmt]: L * steps})
            del every
        same = ""
        if (fmt, layout) == ("bf16", "slot"):
            same = (f"; greedy tokens equal to the paged bf16 run's in "
                    f"{sum(a == b for a, b in zip(gen, tokens_of[('bf16', 'paged')]))} of "
                    f"{B} slots")
        print(f"[whisper] {cfg.name} {fmt} KV {layout}"
              f"{f' (page {lay.page_size})' if layout == 'paged' else ''}, max_seq "
              f"{WHISPER_MAX_SEQ}, {B} slots: prompts of {WHISPER_PROMPTS} tokens fed a token "
              f"a step from position 0, then {WHISPER_NEW} greedy tokens each, {steps} steps "
              f"in {wall:.2f} s: {ms:.3f} ms a step (CUDA events); launches: {counts} ({L} "
              f"layers x {steps} steps); kv_read {kv:.0f} B a step (self-attention stores "
              f"only, as the reference prices it; the cross attends read {B * cross_b} B "
              f"more); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first tokens "
              f"{[g[:4] for g in gen]}{same} [{card}]")
        if layout == "paged" and fmt in ("bf16", "bgpp"):
            kept[fmt] = (lay, cache, [g[-1] for g in gen])
        del cache, rows

    # the card against the CPU: 4 greedy steps from the bf16 paged run's
    # cache as the run left it, then from an f32 copy with slot 0 reset
    lay, cache, last = kept["bf16"]
    whisper_cpu_check(cfg, params, lay, cache, last, cross, device)
    free_device()

    # the encoder and the paged decodes again on a 1x1 NCCL mesh: bit for bit
    for name, n in whisper_sharded(cfg, params, frames, memory, cross, enc_ms, prompts,
                                   unsharded, device, card).items():
        total[name] += n
    del memory, unsharded
    free_device()

    # decode_32k: the reference's 32768-lane cache, B 2
    for fmt in WHISPER_LONG_FORMATS:
        free_device()
        torch.cuda.reset_peak_memory_stats()
        lay, cache = whisper_cache(cfg, cross, fmt, "paged", WHISPER_LONG_B, WHISPER_LONG_SEQ,
                                   device)
        spans = []
        K.reset_launches()
        long_prompts = [p[:WHISPER_LONG_STEPS] for p in prompts[:WHISPER_LONG_B]]
        rows, gen, cache = whisper_decode(cfg, params, cache, lay, long_prompts, 1,
                                          timed=spans)
        torch.cuda.synchronize()
        steps = len(spans)
        counts = count(f"{fmt} decode_32k", {KERNEL_OF[fmt]: L * steps})
        if steps != WHISPER_LONG_STEPS or not all(bool(torch.isfinite(r).all()) for r in rows):
            raise AssertionError(f"{cfg.name} {fmt} decode_32k is malformed")
        print(f"[whisper] {cfg.name} decode_32k {fmt} KV paged (page {lay.page_size}, max_seq "
              f"{WHISPER_LONG_SEQ}), {WHISPER_LONG_B} slots, {steps} steps: "
              f"{np.mean([a.elapsed_time(b) for a, b in spans]):.3f} ms a step; launches: "
              f"{counts}; cache {kvc.cache_bytes(cache)} B; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        del cache

    # the teacher-forced forward: K5's three kinds
    free_device()
    torch.cuda.reset_peak_memory_stats()
    toks = torch.as_tensor(rng.integers(0, V, (1, WHISPER_FWD_S)), device=device)
    batch = {"tokens": toks, "frames": frames[:1]}
    K.reset_launches()
    logits, aux = model_zoo.forward(params, cfg, batch)
    torch.cuda.synchronize()
    counts = count("forward", {"flash_attention": cfg.encoder_layers + 2 * L})
    if logits.shape != (1, WHISPER_FWD_S, V) or not bool(torch.isfinite(logits).all()) \
            or float(aux) != 0.0:
        raise AssertionError(f"{cfg.name} forward is malformed")
    fwd_ms = time_ms(lambda: model_zoo.forward(params, cfg, batch), iters=3)
    print(f"[whisper] {cfg.name} forward B 1, S {WHISPER_FWD_S} over {cfg.encoder_seq} "
          f"frames: {fwd_ms:.3f} ms (CUDA events, 3 calls); launches a call: {counts} "
          f"({cfg.encoder_layers} full in the encoder, {L} causal and {L} cross Sq "
          f"{WHISPER_FWD_S} / Sk {cfg.encoder_seq} in the decoder); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del logits

    # traces, once every run above is timed
    dev = _traced(lambda: whisper.encode(params, cfg, frames), f"{cfg.name} encoder B {B}")
    heads = f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}"
    per_launch(dev, f"flash_attention (K5, full, S {cfg.encoder_seq}, {heads})",
               ("flash_kernel", "flash_mma_kernel"))
    for fmt, names in (("bf16", ("dense_kernel",)), ("bgpp", ("bgpp_kernel",))):
        lay, cache, last = kept.pop(fmt)
        step = engine.make_serve_step(cfg, lay)
        tok = torch.tensor(last, device=device)[:, None]
        dev = _traced(lambda: [step(params, cache, tok) for _ in range(2)],
                      f"{cfg.name} {fmt} KV decode: 2 steps of {B} slots", top=10)
        per_launch(dev, f"{KERNEL_OF[fmt]} ({L} global layers, {heads})", names)
        del cache
    del params, cross, frames
    free_device()
    return total


def whisper_sharded(cfg, params, frames, memory, cross, enc_ms, prompts, unsharded, device,
                    card):
    """ROADMAP item 7c-ii (b) served on the card: under ``rules_for(1, 1)``
    over an NCCL world of one, the encoder on the rank's slots' frames and
    heads (``Shard.of`` of the paged layout) and ``cross_kv`` of its kv
    heads, each bit-identical to the unsharded ``memory`` / ``cross``
    (K5 24 launches a call as unsharded; ms, CUDA events, 3 calls, beside
    the unsharded ``enc_ms``; collectives a call); then each of
    :data:`WHISPER_SHARD_RUNS` decoded from that cross memory through
    ``make_serve_step`` on the mesh (:func:`sharded_decode_check` against
    ``unsharded[fmt]``).  Returns the sharded runs' launches (the encoder's
    and the decodes')."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model_zoo, whisper
    from repro_torch.serving import kv_cache as kvc, sharded as shd

    B = len(prompts)
    started = start_world()
    total = {}
    try:
        rules = shd.rules_for(1, 1, "cuda")
        lay = kvc.layout_for(cfg, B, WHISPER_MAX_SEQ, layout="paged", page_size=WHISPER_PAGE)
        shard = shd.Shard.of(cfg, lay, rules)
        local = shd.shard_params(params, model_zoo.param_specs(cfg), rules, cfg)
        rows = frames[shard.lo:shard.hi]
        calls, real = [], sh.all_gather
        sh.all_gather = lambda x, group, dim=0: calls.append(1) or real(x, group, dim)
        try:
            K.reset_launches()
            got = whisper.encode(local, cfg, rows, shard.split)
            torch.cuda.synchronize()
            launched = {k: v for k, v in K.LAUNCHES.items() if v}
            n_enc = len(calls)
            got_cross = whisper.cross_kv(local, cfg, got, shard.split)
        finally:
            sh.all_gather = real
        for name, n in launched.items():
            total[name] = total.get(name, 0) + n
        if launched != {"flash_attention": cfg.encoder_layers}:
            raise AssertionError(f"sharded {cfg.name} encoder: launches {launched}")
        if not torch.equal(got, memory[shard.lo:shard.hi]):
            raise AssertionError(f"sharded {cfg.name} encoder: memory differs from the "
                                 f"unsharded encoder's")
        if not all(torch.equal(a, b[:, shard.lo:shard.hi]) for a, b in zip(got_cross, cross)):
            raise AssertionError(f"sharded {cfg.name} cross_kv: differs from the unsharded "
                                 f"cross memory")
        ms = time_ms(lambda: whisper.encode(local, cfg, rows, shard.split), iters=3)
        print(f"[sharded-encdec] {cfg.name} encoder on a 1x1 mesh over NCCL (world of one; "
              f"heads split): {shard.hi - shard.lo} rows x {cfg.encoder_seq} frames, memory and "
              f"cross_kv bit-identical to the unsharded encoder's; launches {launched}; "
              f"{ms:.3f} ms (unsharded {enc_ms:.3f}; CUDA events, 3 calls), {n_enc} "
              f"collectives a call [{card}]")
        del got, local
        for fmt, layout in WHISPER_SHARD_RUNS:
            def decode(r, t, w, fmt=fmt, layout=layout):
                lay_, cache = whisper_cache(cfg, got_cross if r is not None else cross, fmt,
                                            layout, B, WHISPER_MAX_SEQ, device)
                return whisper_decode(cfg, params, cache, lay_, prompts, WHISPER_NEW, timed=t,
                                      rules=r, every=w)[1]
            for name, n in sharded_decode_check(cfg, decode, unsharded.pop(fmt),
                                                f"{fmt} KV {layout} decode", card).items():
                total[name] = total.get(name, 0) + n
            free_device()
    finally:
        if started:
            dist.destroy_process_group()
    return total


def vision_prefill(cfg, params, device, card):
    """``engine.prefill_into_slot`` of a :data:`PALI_PROMPT`-token prompt
    behind ``vision_tokens`` random patch embeddings (bf16, seeded) into
    slot 0 of a paged bf16-KV cache (every page mapped), then
    :data:`PALI_DECODES` ``serve_step`` decodes of the batch: K5 launches
    once a layer in the prefill, K1 once a layer a decode step, nothing
    else; logits finite.  Prints the reference's ``pos`` convention: the
    text length, though the prefill wrote the prefix's lanes before it."""
    import torch

    from repro_torch import kernels as K
    from repro_torch.serving import engine, kv_cache as kvc

    L, Tv = cfg.num_layers, cfg.vision_tokens
    layout = kvc.layout_for(cfg, 4, 1024, kv_format="bf16", layout="paged", page_size=16)
    free_device()
    cache = kvc.init_cache_arrays(cfg, layout, device)
    cache["page_table"] = kvc.identity_page_table(layout, device)
    gen = torch.Generator(device=device).manual_seed(5)
    vis = torch.randn((1, Tv, cfg.d_vision), generator=gen, device=device).to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (PALI_PROMPT,), generator=gen, device=device)
    step = engine.make_serve_step(cfg, layout)
    tokens = torch.zeros((layout.batch, 1), dtype=torch.long, device=device)
    torch.cuda.synchronize()
    K.reset_launches()
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    e[0].record()
    logits, cache = engine.prefill_into_slot(params, cfg, layout, cache, 0, prompt,
                                             vision_embeds=vis)
    e[1].record()
    pos = int(cache["pos"][0])
    rows = [logits[0, -1].float()]
    for _ in range(PALI_DECODES):
        tokens[0, 0] = rows[-1].argmax()
        out, cache = step(params, cache, tokens)
        rows.append(out[0, -1].float())
    e[2].record()
    torch.cuda.synchronize()
    got = dict(K.LAUNCHES)
    want = {name: 0 for name in got}
    want["flash_attention"] = L
    want["paged_flash_decode_bf16"] = L * PALI_DECODES
    if got != want:
        raise AssertionError(f"{cfg.name} vision prefill: launches {got}, expected {want}")
    rows = torch.stack(rows)
    if rows.shape != (PALI_DECODES + 1, cfg.vocab_size) or not bool(rows.isfinite().all()):
        raise AssertionError(f"{cfg.name} vision prefill: logits malformed")
    if pos != PALI_PROMPT or int(cache["pos"][0]) != PALI_PROMPT + PALI_DECODES:
        raise AssertionError(f"{cfg.name} vision prefill: pos {pos}, expected the text "
                             f"length {PALI_PROMPT}")
    print(f"[serve] {cfg.name} vision prefill: {Tv} patches x {cfg.d_vision} + "
          f"{PALI_PROMPT} tokens through prefill_into_slot in {e[0].elapsed_time(e[1]):.3f} ms "
          f"(flash_attention {got['flash_attention']} launches, prefix_causal window {Tv}), "
          f"then {PALI_DECODES} serve_step decodes in {e[1].elapsed_time(e[2]):.3f} ms "
          f"(paged_flash_decode_bf16 {got['paged_flash_decode_bf16']} launches); pos after "
          f"the prefill {pos}: the text length, as the reference sets it, though "
          f"{Tv + PALI_PROMPT} lanes were written, so the first decode wrote lane {pos}, "
          f"inside them; logits finite, first token {int(rows[0].argmax())} [{card}]")


def trace_phase(device):
    """After every timed serving run (a profiler trace slows later host
    work): phi4-mini's chunked runs trace a few steady decode steps and its
    eager run one whole-prompt admission (:data:`TRACE_RUNS`); gemma3-4b
    at :data:`GEMMA_DEPTH` layers traces steady bf16-KV and bgpp-KV
    decode and one eager admission of
    1100+ tokens, and prints K1's, K2's and K5's device ms a launch at
    D 256 on its serving path; llama4-scout (cut to
    :data:`LLAMA4_DEPTH` layers) traces steady bf16-KV decode, with K1's
    device ms a launch at g 5 and one MoE layer's decode timed alone
    (:func:`moe_decode_device`); paligemma-3b traces steady bf16-KV
    decode, with K1's device ms a launch at g 8, D 256."""
    import torch

    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.scheduler import Scheduler

    cfg, params = init_model("phi4-mini-3.8b", device)
    longest = max(trace(vocab=cfg.vocab_size, **MAIN_TRACE), key=lambda r: r.prompt_len)
    for fmt, wfmt, admission in TRACE_RUNS:
        layout = kvc.layout_for(cfg, 4, 1024, kv_format=fmt, layout="paged", page_size=16)
        sched = Scheduler(params, cfg, layout, device=device, admission=admission,
                          chunk_budget=128, weight_format=wfmt)
        label = f"{fmt}/{wfmt}/{admission}"
        if admission == "eager":  # its decode step is the chunked bf16 run's
            profile_admission(sched, longest.prompt, label)
        else:
            profile_decode(sched, trace(1, 4, cfg.vocab_size, 200, 256, 24), label)
        del sched
        free_device()
    del params
    free_device()
    cfg, params = init_model(GEMMA_ARCH, device, GEMMA_DEPTH)
    for fmt, admission in (("bf16", "chunked"), ("bgpp", "chunked"), ("bf16", "eager")):
        layout = kvc.layout_for(cfg, 4, GEMMA_MAX_SEQ, kv_format=fmt, layout="paged",
                                page_size=16)
        sched = Scheduler(params, cfg, layout, device=device, admission=admission,
                          chunk_budget=128)
        label = f"{cfg.name} {fmt}/bf16/{admission}"
        if admission == "eager":
            dev = profile_admission(sched, trace(2, 1, cfg.vocab_size, 1100, 1100, 1)[0].prompt,
                                    label, top=12)
            per_launch(dev, "flash_attention (K5, D 256, sliding 1024 and causal)",
                       ("flash_kernel", "flash_mma_kernel"))
        else:
            dev = profile_decode(sched, trace(1, 4, cfg.vocab_size, 1100, 1200, 64), label,
                                 top=12)
            G = len(layout.global_layers)
            per_launch(dev, f"{KERNEL_OF[fmt]} (D 256, {G} global layers)",
                       ("bgpp_kernel",) if fmt == "bgpp" else ("dense_kernel",))
            if fmt == "bf16":
                ring_attend_device(sched)
        del sched
        free_device()
    del params
    free_device()
    cfg, params = init_model(LLAMA4_ARCH, device, LLAMA4_DEPTH)
    layout = kvc.layout_for(cfg, 4, 1024, kv_format="bf16", layout="paged", page_size=16)
    sched = Scheduler(params, cfg, layout, device=device, chunk_budget=128)
    dev = profile_decode(sched, trace(1, 4, cfg.vocab_size, 200, 256, 24),
                         f"{cfg.name} bf16/bf16/chunked", top=12)
    per_launch(dev, f"paged_flash_decode bf16 (K1, g 5, {len(layout.global_layers)} global "
                    f"layers)", ("dense_kernel",))
    moe_decode_device(sched, sum(e.self_device_time_total for e in dev) / 4e3)
    del sched, params
    free_device()
    cfg, params = init_model(PALI_ARCH, device)
    layout = kvc.layout_for(cfg, 4, 1024, kv_format="bf16", layout="paged", page_size=16)
    sched = Scheduler(params, cfg, layout, device=device, chunk_budget=128)
    dev = profile_decode(sched, trace(1, 4, cfg.vocab_size, 200, 256, 24),
                         f"{cfg.name} bf16/bf16/chunked", top=12)
    per_launch(dev, "paged_flash_decode bf16 (K1, g 8, D 256, 18 global layers)",
               ("dense_kernel",))
    del sched, params
    free_device()


def moe_decode_device(sched, step_ms: float, calls: int = 10, top: int = 6) -> None:
    """Device ms of one MoE layer's dropless decode (``moe_apply`` at
    capacity factor E on the live batch's f32 residual: the router, the
    routed experts' weight upcasts and GEMVs, the combine, the shared
    expert) on a decoding Scheduler's layer 0, from one ``torch.profiler``
    trace of ``calls`` calls (every device event over ``calls``: a kernel
    launches several times a call, so :func:`_device_ms`'s mean a launch
    would not do, and an event the tracer drops lowers the sum, which the
    launches a call it prints show; the expert weights exceed the L2 many
    times over, so it is not flushed), beside a traced step's device
    ``step_ms``; prints the time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe, transformer

    cfg, dev = sched.cfg, sched.device
    p = transformer.layer_params(sched.params["layers"], 0)["moe"]
    gen = torch.Generator(device=dev).manual_seed(6)
    h = torch.randn((sched.layout.batch, 1, cfg.d_model), generator=gen, device=dev)
    run = lambda: moe.moe_apply(p, h, cfg, float(cfg.num_experts))
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    t = lambda e: e.self_device_time_total / calls / 1e3  # ms a call
    ms = sum(t(e) for e in evs)
    active = len(set(moe.route(p, h, cfg, float(cfg.num_experts))["experts"].reshape(-1)
                     .tolist()))
    L = cfg.num_layers
    print(f"[profile]   {cfg.name} MoE decode, one layer (B {h.shape[0]}, {active} of "
          f"{cfg.num_experts} experts routed, top-{cfg.experts_per_token}, shared "
          f"{cfg.moe_shared_ff}): {ms:.4f} ms a call on the device; {L} a step: "
          f"{L * ms:.3f} ms of the traced step's {step_ms:.3f} ms "
          f"({f'{100 * L * ms / step_ms:.1f}%' if step_ms else 'the step: not traced'}); "
          f"by kernel, a call:")
    for e in sorted(evs, key=t, reverse=True)[:top]:
        print(f"[profile]     {t(e):8.4f} ms {100 * t(e) / ms:5.1f}% "
              f"{e.count / calls:5.1f} launches  {e.key[:80]}")


def ring_attend_device(sched, calls: int = 10) -> None:
    """Device ms of one local layer's plain-PyTorch ring attends on the
    live cache of a decoding gemma3-4b Scheduler (L2 flushed): the decode
    attend (ring write, window mask, attend over W lanes for every slot)
    and a 128-token chunk's gathered-window attend; prints each beside the
    count a decode step or chunk runs."""
    import torch

    from repro_torch.serving import engine

    cfg, layout, cache, dev = sched.cfg, sched.layout, sched.cache, sched.device
    B, Hq, Hk, D, W = (layout.batch, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       layout.local_window)
    gen = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    pos = cache["pos"].clone()
    kind, w = cfg.layer_attn_window(0)
    q1, k, v = rnd(B, Hq, D), rnd(B, 1, Hk, D), rnd(B, 1, Hk, D)
    dec_ms, dec_k = _device_ms(lambda: engine._local_decode_attend(
        q1, cache, 0, k, v, pos, cfg, layout, 0), calls, l2)
    C, offset = 128, int(pos.min()) - 128
    qc, kc, vc = rnd(1, C, Hq, D), rnd(1, C, Hk, D), rnd(1, C, Hk, D)
    qpos = offset + torch.arange(C, device=dev)
    chunk_ms, chunk_k = _device_ms(lambda: engine._chunk_attend_local(
        cfg, layout, cache["local"], 0, 0, qc, kc, vc, qpos, offset, kind, w), calls, l2)
    n_local = len(layout.local_layers)
    print(f"[profile]   {cfg.name} ring attend (B {B}, W {W}, Hq {Hq}, Hk {Hk}, D {D}), "
          f"plain PyTorch, L2 flushed: decode {dec_ms:.4f} ms a call on the device "
          f"({n_local} a step: {n_local * dec_ms:.3f} ms; {len(dec_k.split(', '))} kernels); "
          f"a {C}-token chunk's gathered window {chunk_ms:.4f} ms a call ({n_local} a chunk: "
          f"{n_local * chunk_ms:.3f} ms; {len(chunk_k.split(', '))} kernels)")
    del l2


def per_launch(dev, what, names) -> None:
    """Print the device ms a launch of the kernels whose names hold one of
    ``names`` in a trace's device events.  A trace that recorded no device
    event on every try of :func:`_traced` times nothing (the launch counts
    are checked elsewhere): the line says so.  A trace that recorded device
    time but no launch of ``names`` fails."""
    if sum(e.self_device_time_total for e in dev) <= 0:
        print(f"[profile]   {what}: not measured, the trace recorded no device event")
        return
    hits = [e for e in dev if any(n in e.key for n in names)]
    total, count = sum(e.self_device_time_total for e in hits), sum(e.count for e in hits)
    if not count:
        raise AssertionError(f"the trace recorded no launch of {what}")
    print(f"[profile]   {what}: {count} launches, {total / count / 1e3:.4f} ms a launch "
          f"on the device")


def spec_run(params, cfg, fmt, wfmt, want_tokens, device, card) -> None:
    """One speculative run of the main trace (paged, chunked, gamma
    :data:`SPEC_GAMMA`, :data:`SPEC_PLANES` kept planes), every count zeroed
    just before the Scheduler is built and read just after the run.  Holds
    its greedy tokens to the non-speculative run's (``want_tokens``), the
    page pool to no leak, and the launches to the formulas: K1 or K2 L a
    draft or verify step, K3 (7L + 1) a step with bstc weights, K4 the
    coded planes of both weight sets' first matrices.  Prints the spec
    counters, ms a round, a draft step and a verify step, tok/s, peak
    memory and both weight sets' bytes."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving import spec_decode as spd
    from repro_torch.serving.scheduler import Scheduler

    L = cfg.num_layers
    run = f"{fmt}/{wfmt} speculative"
    layout = kvc.layout_for(cfg, 4, 1024, kv_format=fmt, layout="paged", page_size=16)
    free_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    sched = Scheduler(params, cfg, layout, device=device, chunk_budget=128, record_logits=True,
                      weight_format=wfmt, spec_decode=True, draft_gamma=SPEC_GAMMA,
                      draft_planes=SPEC_PLANES)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    prep_peak = torch.cuda.max_memory_allocated()
    spans = {"draft": [], "verify": [], "round": []}
    step = sched.serve_step

    def serve_step(p, cache, tokens):
        kind = "draft" if p is sched.draft_params else "verify"
        return _timed(step, spans[kind])(p, cache, tokens)

    sched.serve_step = serve_step
    sched._spec_round = _timed(sched._spec_round, spans["round"])
    reqs = trace(vocab=cfg.vocab_size, **MAIN_TRACE)
    for r in reqs:
        sched.submit(r)
    stats = sched.run()
    torch.cuda.synchronize()
    got = dict(K.LAUNCHES)
    sp = stats["spec"]
    steps = sp["draft_steps"] + sp["verify_steps"]
    want = {name: 0 for name in got}
    want[KERNEL_OF[fmt]] = L * steps
    if wfmt == "bstc":
        want["bstc_matmul"] = (7 * L + 1) * steps
        draft_wq = spd.truncate_plane_params({"wq": params["layers"]["attn"]["wq"]},
                                             SPEC_PLANES)["wq"]
        want["bstc_decode"] = (coded_planes_of_first_matrix(params["layers"]["attn"]["wq"], cfg)
                               + coded_planes_of_first_matrix(draft_wq, cfg))
        del draft_wq
    for name, n in got.items():
        if n != want[name]:
            raise AssertionError(f"{run}: {name} launched {n} times, expected {want[name]}")
    if steps != sched.decode_steps or sp["draft_steps"] != SPEC_GAMMA * sp["rounds"]:
        raise AssertionError(f"{run}: {steps} draft + verify steps, {sched.decode_steps} "
                             f"serve steps counted, {sp['rounds']} rounds")
    if stats["finished_requests"] != len(reqs):
        raise AssertionError(f"{run}: {stats['finished_requests']} of {len(reqs)} finished")
    sched.pager.check()
    if sched.pager.pages_in_use:
        raise AssertionError(f"{run}: {sched.pager.pages_in_use} pages leaked")
    for r in sched.finished:
        rows = np.stack(r.logit_rows)
        if rows.shape != (MAIN_TRACE["new"], cfg.vocab_size) or not np.isfinite(rows).all():
            raise AssertionError(f"{run}: request {r.rid} output is malformed")
        if r.generated != want_tokens[r.rid]:
            at = next(i for i, (a, b) in enumerate(zip(r.generated, want_tokens[r.rid]))
                      if a != b)
            raise AssertionError(f"{run}: request {r.rid} token {at} is "
                                 f"{r.generated[at]}, the non-speculative run's "
                                 f"{want_tokens[r.rid][at]}")
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in spans.items()}
    serve_b = weight_set_bytes(sched.serve_params)
    draft_b = weight_set_bytes(sched.draft_params)
    both_b = weight_set_bytes([sched.serve_params, sched.draft_params])
    counts = ", ".join(f"{n} {v}" for n, v in got.items() if v)
    print(f"[spec] {fmt} paged, {wfmt} weights, speculative (gamma {sp['gamma']}, "
          f"{sp['draft_planes']} planes): greedy tokens of all {len(reqs)} requests identical "
          f"to the non-speculative run; {sp['rounds']} rounds, "
          f"{sp['accepted_tokens_per_round']} tokens accepted a slot-round (draft hit rate "
          f"{sp['draft_hit_rate']}, {sp['accepted_tokens']} tokens), {sp['draft_steps']} draft "
          f"+ {sp['verify_steps']} verify steps; {np.mean(ms['round']):.3f} ms a round, "
          f"{np.mean(ms['draft']):.3f} ms a draft step, {np.mean(ms['verify']):.3f} ms a "
          f"verify step; {stats['decoded_tokens']} tokens in {stats['wall_s']} s = "
          f"{stats['tokens_per_s']} tok/s; pages_in_use 0; launches: {counts} [{card}]")
    print(f"[spec] {fmt}/{wfmt} speculative: weight sets {serve_b / 2**30:.3f} GiB serve + "
          f"{draft_b / 2**30:.3f} GiB draft ({both_b / 2**30:.3f} GiB distinct, raw params "
          f"{weight_set_bytes(params) / 2**30:.3f} GiB); prepare {prep_s:.2f} s, peak memory "
          f"{prep_peak / 2**30:.2f} GiB while preparing, "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB over the run; "
          f"spec {json.dumps(sp)}")
    del sched
    free_device()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# reference check: the card's kernels against the CPU's plain versions
# ---------------------------------------------------------------------------


# smoke configs of the reference check: (arch, trace, extra cells).  gemma3's
# prompts of 12-40 tokens and 12 new ones run its 16-lane rings past a wrap
# in prefill and in decode
# int8 / bgpp KV tolerance: the logit move of one probability code flipped
# at a .5 boundary.  2e-3 covers it on phi4-mini-smoke (24 heads) and
# gemma3-4b-smoke; deepseek-7b-smoke has 4 query heads of 16 lanes, one a
# kv head (g 1), so one flipped code in K1's int8 body moves a logit by up
# to 3.5e-3 in an isolated row (the check prints the rows beyond 1e-4;
# K1's int8 body at g 1 matches its plain version within 2.4e-7 on random
# inputs: the head-width phase's deepseek-7b case).  The MoE smokes have
# the same 4 query heads of 16 lanes (2 kv heads), so they take 5e-3 too
REFERENCE_MODELS = (
    ("phi4-mini-3.8b", dict(seed=1, n=4, lo=5, hi=30, new=6), "all", 2e-3),
    ("gemma3-4b", dict(seed=1, n=4, lo=12, hi=40, new=12), "some", 2e-3),
    ("deepseek-7b", dict(seed=1, n=4, lo=5, hi=30, new=6), "none", 5e-3),
    ("mixtral-8x22b", dict(seed=1, n=4, lo=12, hi=40, new=12), "none", 5e-3),
    ("llama4-scout-17b-a16e", dict(seed=1, n=4, lo=12, hi=40, new=12), "some", 5e-3),
    ("paligemma-3b", dict(seed=1, n=4, lo=12, hi=40, new=12), "none", 5e-3),
)


def reference_phase(device):
    """Serve each smoke config of :data:`REFERENCE_MODELS` (f32) on the
    card and on the CPU from the same parameters and trace, in every layout
    x KV-format cell with bf16 weights; phi4-mini also with int8 and bstc
    weights and with eager admission (the card's forward runs the
    flash-attention kernel at D 16 in f32, the CPU's its plain version),
    gemma3-4b also with bstc weights and with eager admission (sliding
    windows of 16 on its local layers).  bf16 KV: the same greedy tokens
    and logits within 1e-4 (f32 sums in another order).  int8/bgpp KV:
    teacher-forced with the CPU's tokens, logits within the model's
    tolerance of :data:`REFERENCE_MODELS` (a probability code may flip by
    one at a .5 boundary).  Then whisper-smoke, outside the Scheduler as
    the reference serves it (:func:`whisper_reference`)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo, transformer
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.scheduler import Scheduler

    for arch, trace_kw, extra, code_tol in REFERENCE_MODELS:
        cfg = get_config(arch, smoke=True)
        cpu = model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
        gpu = _tree_to(cpu, device)

        def serve(params, dev, layout, forced=None, wfmt="bf16", admission="chunked"):
            sched = Scheduler(params, cfg, layout, device=dev, admission=admission,
                              chunk_budget=8, record_logits=True, weight_format=wfmt)
            for r in trace(vocab=cfg.vocab_size, **trace_kw):
                if forced is not None:
                    r.forced_tokens = np.asarray(forced[r.rid])
                sched.submit(r)
            sched.run()
            return {r.rid: r for r in sched.finished}

        cells = [(lay, fmt, "bf16", "chunked") for lay in ("slot", "paged")
                 for fmt in ("bf16", "int8", "bgpp")]
        if extra == "all":
            cells += [(lay, fmt, wfmt, "chunked") for wfmt in ("int8", "bstc")
                      for lay, fmt in (("paged", "bf16"), ("slot", "bgpp"))]
            cells += [(lay, "bf16", "bf16", "eager") for lay in ("paged", "slot")]
        elif extra == "some":
            cells += [("paged", "bgpp", "bstc", "chunked"), ("paged", "bf16", "bf16", "eager")]
        for lay, fmt, wfmt, admission in cells:
            layout = kvc.layout_for(cfg, 2, 64, kv_format=fmt, layout=lay, page_size=8)
            ref = serve(cpu, "cpu", layout, wfmt=wfmt, admission=admission)
            forced = None if fmt == "bf16" else {i: r.generated for i, r in ref.items()}
            got = serve(gpu, device, layout, forced, wfmt=wfmt, admission=admission)
            same = all(got[i].generated == ref[i].generated for i in ref)
            rows = np.concatenate([np.abs(np.stack(got[i].logit_rows)
                                          - np.stack(ref[i].logit_rows)).max(-1) for i in ref])
            err = float(rows.max())
            tol = 1e-4 if fmt == "bf16" else code_tol
            # how the error spreads: one flipped code shows as a row or two
            # far above the rest
            print(f"[check] {cfg.name} {lay} {fmt} KV, {wfmt} weights, {admission} admission: "
                  f"tokens equal {same}, max |logit diff| {err:.3e} (tolerance {tol}); "
                  f"{int((rows > 1e-4).sum())} of {rows.size} logit rows beyond 1e-4, the "
                  f"others within {float(np.where(rows > 1e-4, 0, rows).max()):.1e}")
            if not same or not err <= tol:
                raise AssertionError(f"{cfg.name} {lay} {fmt}/{wfmt}/{admission}: card and "
                                     f"CPU disagree")
        if cfg.family == "vlm":  # the forward behind the image prefix
            gen = torch.Generator().manual_seed(2)
            toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
            vis = torch.randn((2, cfg.vision_tokens, cfg.d_vision), generator=gen)
            want = transformer.forward(cpu, cfg, toks, vision_embeds=vis)[0]
            got = transformer.forward(gpu, cfg, toks.to(device),
                                      vision_embeds=vis.to(device))[0].cpu()
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            print(f"[check] {cfg.name} forward with a {cfg.vision_tokens}-patch prefix "
                  f"(prefix_causal through flash_attention on the card): max |logit diff| "
                  f"{err:.3e} = {err / scale:.3e} of max |logit| {scale:.3e} (tolerance 1e-4 "
                  f"of it)")
            if not err <= 1e-4 * scale:
                raise AssertionError(f"{cfg.name}: the prefix forward disagrees card / CPU")
    whisper_reference(device)


def whisper_reference(device):
    """whisper-smoke (f32) on the card (K5 in the encoder and the forward,
    K1 / K2 in the decode) and on the CPU (the plain versions), from the
    same parameters and seeded frames (B 2): the encoder's memory and the
    forward's logits (S 20) within 1e-4 of max |value|; then every layout x
    KV format of ``make_serve_step`` (max_seq 64, page 8), each side over
    its own memory, prompts of 12 and 20 tokens and 8 new ones
    (:func:`whisper_decode`), then slot 0 reset (its cross memory
    refilled) and the same again from the live cache, the slots now at
    other positions: bf16 KV the same greedy tokens and logits
    within 1e-4; int8 / bgpp KV teacher-forced with the CPU's tokens,
    logits within 5e-3 (4 heads of 16, as deepseek-7b-smoke's)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo, whisper
    from repro_torch.serving import kv_cache as kvc

    cfg = get_config(WHISPER_ARCH, smoke=True)
    side = {"cpu": model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")}
    side[device] = _tree_to(side["cpu"], device)
    frames = whisper_frames(cfg, 2, 1, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20)))
    mem, fwd = {}, {}
    for dev, p in side.items():
        mem[dev] = whisper.encode(p, cfg, frames.to(dev))
        fwd[dev] = model_zoo.forward(p, cfg, {"tokens": toks.to(dev),
                                              "frames": frames.to(dev)})[0].cpu()
    for what, a, b in (("encoder memory", mem[device].cpu(), mem["cpu"]),
                       ("forward logits", fwd[device], fwd["cpu"])):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        print(f"[check] {cfg.name} {what} (flash_attention on the card): max |diff| "
              f"{err:.3e} = {err / scale:.3e} of max {scale:.3e} (tolerance 1e-4 of it)")
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{cfg.name}: the {what} disagree card / CPU")
    cross = {dev: whisper.cross_kv(p, cfg, mem[dev]) for dev, p in side.items()}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (12, 20)]
    for layout in ("slot", "paged"):
        for fmt in ("bf16", "int8", "bgpp"):
            run = {}
            for dev, p in (("cpu", side["cpu"]), (device, side[device])):
                lay, cache = whisper_cache(cfg, cross[dev], fmt, layout, 2, 64, dev, page=8)
                rows, toks = [], []
                for r in range(2):
                    if r:  # slot 0 anew: from here the slots decode at other positions
                        cache = kvc.reset_slot(cache, lay, 0)
                        cache["cross_k"][:, 0] = cross[dev][0][:, 0]
                        cache["cross_v"][:, 0] = cross[dev][1][:, 0]
                    forced = None if fmt == "bf16" or dev == "cpu" else run["cpu"][1][r]
                    lg, gen, cache = whisper_decode(cfg, p, cache, lay, prompts, 8,
                                                    forced=forced)
                    rows += lg
                    toks.append(gen)
                run[dev] = (rows, toks)
            same = run[device][1] == run["cpu"][1]
            err = max(float((a - b).abs().max()) for a, b in zip(run[device][0], run["cpu"][0]))
            tol = 1e-4 if fmt == "bf16" else 5e-3
            print(f"[check] {cfg.name} {layout} {fmt} KV, make_serve_step over the encoder's "
                  f"memory: tokens equal {same}, max |logit diff| {err:.3e} (tolerance {tol})")
            if not same or not err <= tol:
                raise AssertionError(f"{cfg.name} {layout} {fmt}: card and CPU disagree")


def paper_reference_phase(device):
    """The paper layer's calls at the reference examples' sizes, on the
    card (kernels) and on the CPU (plain versions): ``brcr_matmul`` on the
    quickstart's 64 x 1024 weight for m = 2 and 4 (integer x: the same
    int32; float x: within 1e-5 of Σ|w·x| per element), the batched
    predictor at B 2, Hq 6, Hk 2, S 512 (alive masks, est scores and the
    top-k indices identical), and both examples at their reference sizes
    (the quickstart's printed lines and the walkthrough's numbers equal)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core import bgpp, brcr
    from repro_torch.examples import bgpp_sparse_attention as walk
    from repro_torch.examples import quickstart
    from repro_torch.utils.synthetic import synthetic_llm_weight_int8

    rng = np.random.default_rng(0)
    w = torch.from_numpy(synthetic_llm_weight_int8(rng, (64, 1024))[0])
    xi = torch.from_numpy(rng.integers(-50, 50, (1024, 16)).astype(np.int32))
    xf = torch.from_numpy(rng.normal(size=(1024, 16)).astype(np.float32))
    for m in (2, 4):
        same = torch.equal(brcr.brcr_matmul(w.to(device), xi.to(device), m=m).cpu(),
                           brcr.brcr_matmul(w, xi, m=m))
        err = check_brcr(f"brcr_matmul m={m} float x", brcr.brcr_matmul(
            w.to(device), xf.to(device), m=m).cpu(), brcr.brcr_matmul(w, xf, m=m), w, xf,
            exact=False)
        print(f"[check] brcr_matmul 64 x 1024, m={m}: integer x identical {same}, float x "
              f"max_abs_err {err:.3e} (tolerance 1e-5 of Σ|w·x|)")
        if not same:
            raise AssertionError(f"brcr_matmul m={m}: card and CPU differ on integer x")

    q_np, k_np = decode_keys(7, B=2, Hq=6, Hk=2, S=512, D=128)
    def predict(dev):
        sign, planes = walk.key_planes(k_np, dev)
        alive, est = bgpp.bgpp_predict_batched(torch.from_numpy(q_np).to(dev), planes, sign,
                                               bgpp.BGPPConfig(min_keys=8),
                                               logit_scale=1.0 / (625 * np.sqrt(128)))
        idx, ok = bgpp.alive_to_topk_indices(alive, est.reshape(2, 2, 3, -1).amax(2), 128)
        return [t.cpu() for t in (alive, est, idx, ok)]

    same = all(torch.equal(a, b) for a, b in zip(predict(torch.device("cpu")), predict(device)))
    print(f"[check] bgpp_predict_batched B 2, Hq 6, Hk 2, S 512: alive, est and top-k "
          f"indices identical {same}")
    if not same:
        raise AssertionError("bgpp_predict_batched: card and CPU differ")

    def examples(dev):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            quickstart.main(shape=(64, 1024), device=dev)
            res = walk.main(S=512, device=dev)
        return buf.getvalue(), res["rows"], res["alive_per_round"].tolist()

    same = examples("cpu") == examples(device)
    print(f"[check] quickstart 64 x 1024 and the walkthrough at S 512: card and CPU print "
          f"the same numbers {same}")
    if not same:
        raise AssertionError("paper-layer examples: card and CPU differ")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# train phase: K5's gradient (K5b), then the training path
# ---------------------------------------------------------------------------

K5B_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
# the reference has no Pallas backward: it differentiates its jnp scan
K5B_REPLACES = "src/repro/core/attention.py:97"
# (label, B, Sq, Sk, kind, window, q_offset, dtype, D, Hq, Hk, timed)
BWD_CASES = (
    ("phi4-mini causal Hq 24 Hk 8 D 128 B1 S4096 bf16", 1, 4096, 4096, "causal", 0, 0, "bf16",
     128, 24, 8, True),
    ("sliding w512 B1 S2048 bf16", 1, 2048, 2048, "sliding", 512, 0, "bf16", 128, 24, 8, False),
    ("chunked w256 B1 S1024 bf16", 1, 1024, 1024, "chunked", 256, 0, "bf16", 128, 24, 8, False),
    ("prefix_causal w100 B1 S512 bf16", 1, 512, 512, "prefix_causal", 100, 0, "bf16", 128, 24,
     8, False),
    ("causal ragged B2 S301 bf16", 2, 301, 301, "causal", 0, 0, "bf16", 128, 24, 8, False),
    ("causal q_offset 256 B1 Sq256 Sk512 bf16", 1, 256, 512, "causal", 0, 256, "bf16", 128, 24,
     8, False),
    ("sliding w100 D 24 Hq 4 Hk 1 B2 S201 bf16", 2, 201, 201, "sliding", 100, 0, "bf16", 24, 4,
     1, False),
    ("gemma3-4b causal Hq 8 Hk 4 D 256 B1 S1024 bf16", 1, 1024, 1024, "causal", 0, 0, "bf16",
     256, 8, 4, True),
    ("llama4-scout causal Hq 40 Hk 8 D 128 B1 S1024 bf16", 1, 1024, 1024, "causal", 0, 0, "bf16",
     128, 40, 8, False),
    ("whisper-medium cross full Hq 16 Hk 16 D 64 B1 Sq128 Sk1500 bf16", 1, 128, 1500, "full", 0,
     0, "bf16", 64, 16, 16, True),
    ("phi4-mini causal B1 S301 f32", 1, 301, 301, "causal", 0, 0, "f32", 128, 24, 8, True),
)
BWD_ROWS = 1024  # query rows of one plain-version block at long S


def bwd_plain_blocked(q, k, v, o, lse, dout, kw):
    """``flash_attention_bwd_ref`` a block of :data:`BWD_ROWS` query rows
    at a time, in f32 (dk and dv summed over the blocks in f32, all three
    rounded once to the operands' dtype): the whole call's function,
    summed in another order, without its ``(B, Hq, Sq, Sk)`` temporaries
    at S 4096."""
    import torch

    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    f = lambda t: t.float()
    dqs, dk, dv = [], 0.0, 0.0
    for i in range(0, q.shape[1], BWD_ROWS):
        sl = slice(i, i + BWD_ROWS)
        a, b, c = flash_attention_bwd_ref(
            f(q[:, sl]), f(k), f(v), f(o[:, sl]), lse[:, :, sl].contiguous(), f(dout[:, sl]),
            **dict(kw, q_offset=kw["q_offset"] + i))
        dqs.append(a)
        dk, dv = dk + b, dv + c
    dt = q.dtype
    return torch.cat(dqs, 1).to(dt), dk.to(dt), dv.to(dt)


def bwd_tolerance(want, bf16):
    """K5's per-element bound on one gradient: ``1e-5 * max|want|`` (its
    own scale: f32 sums in another order), plus one bf16 step at ``|want|``
    for bf16 operands (two f32 results that close can round to
    neighbouring bf16 values)."""
    import torch

    w = want.float()
    tol = 1e-5 * w.abs().max()
    if bf16:
        tol = tol + torch.ldexp(torch.ones_like(w), torch.frexp(w.abs())[1] - 8)
    return tol


def sdpa_fwd_bwd(q, k, v, dout, kw):
    """``scaled_dot_product_attention``'s forward plus backward on K5b's
    inputs (the library column; the port never calls it)."""
    import torch

    leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
    fwd = flash_library(*leaves, kw)  # its output is (B, H, S, D)
    grad_out = dout.transpose(1, 2)

    def run():
        torch.autograd.grad(fwd(), leaves, grad_out)
    return run


def flash_bwd_case(case, gen, device, flush):
    """One :data:`BWD_CASES` case: K5's forward with and without ``lse``
    (``out`` bit-identical, ``lse`` within 1e-5 of the plain version's),
    then K5b twice (identical bits) against ``flash_attention_bwd_ref`` on
    the same q, k, v, out, lse and dout (:func:`bwd_tolerance` on each of
    dq, dk and dv).  A timed case is timed beside the plain version and
    SDPA's forward plus backward, its bound 10 * D operations per visible
    (query, key) pair at the operands' peak against q, k, v, o and dout read
    and dq, dk and dv written once; returns its record (else None)."""
    import torch

    from repro_torch.core.attention import make_mask
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                          flash_attention_ref)

    label, B, Sq, Sk, kind, window, off, dt, D, Hq, Hk, timed = case
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    mk = lambda S, H: torch.randn((B, S, H, D), generator=gen, device=device).to(dtype)
    q, k, v, dout = mk(Sq, Hq), mk(Sk, Hk), mk(Sk, Hk), mk(Sq, Hq)
    kw = dict(mask_kind=kind, window=window, q_offset=off)
    out, lse = flash_ops._forward(q, k, v, kind, window, off, D ** -0.5, want_lse=True)
    plain_out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, plain_out):
        raise AssertionError(f"flash_attention {label}: out moves when lse is asked for")
    want_lse = torch.cat([flash_attention_ref(q[:, i:i + BWD_ROWS], k, v, return_lse=True,
                                              **dict(kw, q_offset=off + i))[1]
                          for i in range(0, Sq, BWD_ROWS)], 2)
    lse_err = (lse - want_lse).abs().max().item()
    if lse_err > 1e-5:
        raise AssertionError(f"flash_attention {label}: lse off by {lse_err:.3e} > 1e-5")
    got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd {label}: two launches differ")
    want = bwd_plain_blocked(q, k, v, out, lse, dout, kw)
    errs, share = [], 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w.float()).abs()
        tol = bwd_tolerance(w, dt == "bf16")
        if bool((err > tol).any()):
            at = (err > tol).nonzero()[0].tolist()
            raise AssertionError(f"flash_attention_bwd {label}: {name} disagrees at {at}: "
                                 f"{err[tuple(at)].item():.3e} > {tol[tuple(at)].item():.3e}")
        errs.append(err.max().item())
        share = max(share, (err / tol).max().item())
    p = flash_kernel.bwd_plan(dtype, B, Sq, Sk, Hq, Hk, D)
    where = (f" {label} (tile {p.tile}, {p.grid_kv[0] * p.grid_kv[1]} + "
             f"{p.grid_q[0] * p.grid_q[1]} blocks, two launches bit-identical, lse err "
             f"{lse_err:.2e}, dq/dk/dv err {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e}, worst "
             f"err/tol {share:.3f})")
    if not timed:
        print(f"[kernel] flash_attention_bwd{where}")
        return None
    pairs = int(make_mask(kind, Sq, Sk, window, off, device).sum()) * B * Hq
    esize = q.element_size()
    nbytes = esize * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    return kernel_record(
        "flash_attention_bwd", K5B_SOURCE, K5B_REPLACES, max(errs),
        time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout, **kw), flush=flush),
        time_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw), flush=flush,
                iters=3),
        nbytes, 10 * D * pairs, dt, time_ms(sdpa_fwd_bwd(q, k, v, dout, kw), flush=flush),
        label=where, case=label)


def flash_bwd_phase(device, flush):
    """Every :data:`BWD_CASES` case (:func:`flash_bwd_case`); returns the
    timed cases' records, the first (phi4-mini's training shape) first."""
    import torch

    gen = torch.Generator(device=device).manual_seed(5)
    records = [r for r in (flash_bwd_case(c, gen, device, flush) for c in BWD_CASES) if r]
    free_device()
    return records


TRAIN_ARCH = "phi4-mini-3.8b"
TRAIN_B, TRAIN_S = 1, 4096  # train_4k's length; its global batch of 256 cut to 1 for one card
TRAIN_STEPS, TRAIN_INT8_STEPS = 4, 2
TRAIN_SMOKES = (("phi4-mini-3.8b", "causal"), ("gemma3-4b", "sliding window 16, qk-norm"),
                ("paligemma-3b", "prefix_causal"), ("whisper-medium", "full and cross"))
TRAIN_SMOKE_B, TRAIN_SMOKE_S = 2, 64
TRAIN_GRAD_SHARE = 1e-4  # each grad leaf against its own max |g|
TRAIN_LOSS_REL = 1e-5
LAUNCHER_LAYERS, LAUNCHER_STEPS, LAUNCHER_EVERY = 2, 6, 2
LAUNCHER_LOSS_TOL = 1e-3


def grads_gap(got, want):
    """``(worst share, its leaf)``: each grad leaf's max |got - want| over
    its own max |want|, the worst of them."""
    from repro_torch.utils.tree import tree_items

    flat = dict(tree_items(want))
    worst, where = 0.0, ""
    for key, g in tree_items(got):
        w = flat[key].float()
        share = ((g.float().cpu() - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
        if share > worst:
            worst, where = share, key
    return worst, where


def train_card_cpu_phase(device):
    """One train step's loss and grads (remat on) of each of
    :data:`TRAIN_SMOKES` on the card against the CPU's
    (:func:`train_smoke_check`), phi4-mini-smoke also with K5b's launch
    skipped, which must fail the bound."""
    for i, (arch, what) in enumerate(TRAIN_SMOKES):
        train_smoke_check(arch, what, device, skip_check=i == 0)


def train_smoke_check(arch, what, device, skip_check=False, k5_launches=None):
    """One train step's loss and grads (remat on, the launcher's forward
    keywords) of ``arch``'s smoke config on the card against the CPU's from
    the same parameters and batch: the loss within :data:`TRAIN_LOSS_REL`
    relative, every grad leaf within :data:`TRAIN_GRAD_SHARE` of its max
    |g| (``wq`` / ``wk`` / ``wv``, whose grads flow through K5b,
    included), K5b launched once a self- or cross-attention (and K5
    ``k5_launches`` times where given).  With ``skip_check`` the same step
    again with K5b's launch skipped (dq, dk, dv left zero): that run must
    fail the grad bound, which shows the check can fail."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.launch.train import fwd_kwargs, modality
    from repro_torch.models import model_zoo
    from repro_torch.training import make_loss_fn
    from repro_torch.training.train_step import loss_and_grads

    cfg = get_config(arch, smoke=True)
    params = model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticLMDataset(cfg.vocab_size, TRAIN_SMOKE_S, TRAIN_SMOKE_B, seed=1,
                               modality=modality(cfg)).batch(0)
    loss_fn = make_loss_fn(cfg, fwd_kwargs(cfg))
    want_loss, _, want = loss_and_grads(loss_fn, params, to_device(batch, "cpu"))
    dparams = _tree_to(params, device)
    dbatch = to_device(batch, device)
    reset_launches()
    loss, _, got = loss_and_grads(loss_fn, dparams, dbatch)
    torch.cuda.synchronize()
    attends = sum(cfg.layer_is_attention(i) for i in range(cfg.num_layers)) * (
        2 if cfg.family == "enc_dec" else 1) + cfg.encoder_layers
    if LAUNCHES["flash_attention_bwd"] != attends:
        raise AssertionError(f"train {arch}-smoke: K5b launched "
                             f"{LAUNCHES['flash_attention_bwd']} times, want {attends}")
    if k5_launches is not None and LAUNCHES["flash_attention"] != k5_launches:
        raise AssertionError(f"train {arch}-smoke: K5 launched "
                             f"{LAUNCHES['flash_attention']} times, want {k5_launches}")
    rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    share, where = grads_gap(got, want)
    if rel > TRAIN_LOSS_REL or share > TRAIN_GRAD_SHARE:
        raise AssertionError(f"train {arch}-smoke ({what}): card against CPU loss rel "
                             f"{rel:.3e}, worst grad leaf {where} {share:.3e}")
    print(f"[train] {arch}-smoke ({what}) card against CPU: loss {loss.item():.6f} "
          f"(rel {rel:.2e} <= {TRAIN_LOSS_REL}), worst grad leaf {where} {share:.2e} of "
          f"its max |g| (<= {TRAIN_GRAD_SHARE}); K5 {LAUNCHES['flash_attention']}, K5b "
          f"{LAUNCHES['flash_attention_bwd']} launches")
    if not skip_check:
        return
    launch_bwd = flash_kernel.launch_bwd

    def skipped(q, k, v, o, dout, lse, delta, dq, dk, dv, *rest):
        for t in (dq, dk, dv):
            t.zero_()
    flash_kernel.launch_bwd = skipped
    try:
        _, _, bad = loss_and_grads(loss_fn, dparams, dbatch)
    finally:
        flash_kernel.launch_bwd = launch_bwd
    share, where = grads_gap(bad, want)
    if share <= TRAIN_GRAD_SHARE:
        raise AssertionError(f"train {arch}-smoke: with K5b skipped the grads still pass "
                             f"the bound ({where} {share:.3e}): the check cannot fail")
    print(f"[train] {arch}-smoke with K5b's launch skipped fails the bound, as it must: "
          f"worst grad leaf {where} {share:.2e} of its max |g|")


def _opt_bytes(opt):
    from repro_torch.utils.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(opt))


# device kernels of a train step by what they do: the first group whose
# pattern a kernel's name holds
TRAIN_GROUPS = (("K5b (flash_attention_bwd)", ("dkdv_", "dq_mma_kernel", "dq_kernel",
                                               "delta_kernel")),
                ("K5 (flash_attention)", ("flash_mma_kernel", "flash_kernel")),
                ("GEMMs (cuBLAS)", ("gemm", "Gemm", "nvjet", "cutlass", "xmma")),
                ("copies and fills", ("copy", "Copy", "Memcpy", "Memset", "fill", "Fill")),
                ("reductions", ("reduce", "Reduce")),
                ("elementwise", ("elementwise", "Elementwise")),
                ("NCCL collectives", ("nccl", "Nccl")))


def train_step_trace(step_fn, state, batch, what):
    """One more steady train step under ``torch.profiler``, after the timed
    ones: the device's busy share of the step's wall, the device time of
    the top kernels, the kernels summed by :data:`TRAIN_GROUPS` (K5b, K5,
    the GEMMs, copies, reductions, elementwise, the rest), and the device
    time launched inside ``adamw_update`` and inside the forward's
    ``cross_entropy`` (``record_function`` ranges on the calling thread;
    the backward runs on autograd's thread, so the cross entropy's
    backward counts in the groups only).  Returns the new state."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.training import train_step as ts

    def ranged(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    ranges = ("train::adamw_update", "train::cross_entropy")
    saved = ts.adamw_update, ts.cross_entropy
    ts.adamw_update = ranged(ranges[0], saved[0])
    ts.cross_entropy = ranged(ranges[1], saved[1])
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ts.adamw_update, ts.cross_entropy = saved
    events = prof.key_averages()
    # a range also shows on the device's timeline under its own name: not a kernel
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges]
    t = lambda e: e.self_device_time_total / 1e3
    busy = sum(t(e) for e in dev)
    if busy <= 0:  # the tracer now and then records no device event at all
        print(f"[profile] train {what}: the trace recorded no device time")
        return state
    print(f"[profile] train {what}: one steady step, device busy {busy:.2f} ms of "
          f"{wall_ms:.2f} ms wall ({100 * busy / wall_ms:.1f}%; the tracer's own host cost "
          f"lengthens the wall)")
    for e in sorted(dev, key=t, reverse=True)[:10]:
        print(f"[profile]   {t(e):9.3f} ms {100 * t(e) / busy:5.1f}% {e.count:6d} calls  "
              f"{e.key[:80]}")
    groups = {name: [0.0, 0] for name, _ in TRAIN_GROUPS}
    groups["other"] = [0.0, 0]
    for e in dev:
        name = next((n for n, pats in TRAIN_GROUPS if any(p in e.key for p in pats)), "other")
        groups[name][0] += t(e)
        groups[name][1] += e.count
    for name, (ms, n) in groups.items():
        print(f"[profile]   group {name}: {ms:.3f} ms ({100 * ms / busy:.1f}%), {n} kernels")
    for name in ranges:  # the kernels launched inside the range, from its host side
        ms = sum(e.device_time_total for e in events
                 if e.key == name and e.device_type == DeviceType.CPU) / 1e3
        print(f"[profile]   inside {name} (calling thread): {ms:.3f} ms "
              f"({100 * ms / busy:.1f}%)")
    return state


def train_main_run(device, card):
    """phi4-mini-3.8b at full width and depth (32 layers, bf16, seeded
    weights) trains :data:`TRAIN_STEPS` f32-AdamW steps (peak_lr 3e-4 after
    ``AdamWConfig``'s 100 warm-up steps) at B 1, S 4096 with remat on one repeated
    ``SyntheticLMDataset`` batch, then :data:`TRAIN_INT8_STEPS` steps with
    fresh int8 moments.  Every step: loss and grad norm finite, K5
    launched 2L = 64 times (the forward and its recompute) and K5b L = 32,
    nothing else; the last f32 step's loss below the first's.  Prints ms a
    step, tokens/s, the peak memory and the state's bytes, and traces one
    more f32 step (:func:`train_step_trace`).  Returns the launch counts of
    every timed step summed."""
    import math

    import torch

    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_train_step

    free_device()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = init_model(TRAIN_ARCH, device)
    L = cfg.num_layers
    batch = to_device(SyntheticLMDataset(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0).batch(0),
                      device)
    want = {name: 0 for name in LAUNCHES}
    want.update(flash_attention=2 * L, flash_attention_bwd=L)
    total = {name: 0 for name in LAUNCHES}
    state = {"params": params}
    for fmt, steps in (("fp32", TRAIN_STEPS), ("int8", TRAIN_INT8_STEPS)):
        # AdamWConfig's own schedule: 100 warm-up steps to peak_lr 3e-4.  Without the
        # warm-up the first step's 3e-4 on every weight at once raised the loss
        # (12.71 -> 14.40 -> 21.29 over 4 steps on the card)
        opt_cfg = AdamWConfig(peak_lr=3e-4, state_dtype=fmt)
        state["opt"] = None
        free_device()
        state["opt"] = adamw_init(state["params"], opt_cfg)
        step_fn = make_train_step(cfg, opt_cfg, dict(remat=True))
        pbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        print(f"[train] {cfg.name} {fmt} AdamW: state {_opt_bytes(state['opt']) / 1e9:.3f} GB "
              f"of moments beside {pbytes / 1e9:.3f} GB of bf16 parameters")
        losses = []
        for i in range(steps):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
            dt = time.perf_counter() - t0
            got = dict(LAUNCHES)
            for name, n in got.items():
                total[name] += n
            if got != want:
                raise AssertionError(f"train {cfg.name} step {i}: launches {got}, want {want}")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"train {cfg.name} step {i}: loss {loss}, grad norm {gnorm}")
            losses.append(loss)
            print(f"[train] {cfg.name} {fmt} step {i}: loss {loss:.6f} grad norm {gnorm:.4f} "
                  f"lr {metrics['lr'].item():.2e} {dt * 1e3:.1f} ms "
                  f"({TRAIN_B * TRAIN_S / dt:.0f} tokens/s); K5 {got['flash_attention']}, K5b "
                  f"{got['flash_attention_bwd']} launches ({card})")
        if fmt == "fp32" and not losses[-1] < losses[0]:
            raise AssertionError(f"train {cfg.name}: loss at step {steps - 1} {losses[-1]} is "
                                 f"not below step 0's {losses[0]} on the repeated batch")
        if fmt == "fp32":
            state = train_step_trace(step_fn, state, batch, f"{cfg.name} {fmt}")
        print(f"[train] {cfg.name} {fmt}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated "
              f"(B {TRAIN_B}, S {TRAIN_S}, remat)")
    del state, params, batch
    free_device()
    return total


def train_launcher_check(device, card):
    """``python -m repro_torch.launch.train --full`` at phi4-mini width,
    depth cut to :data:`LAUNCHER_LAYERS`, int8 moments, S 4096: a straight
    run of :data:`LAUNCHER_STEPS` steps checkpointing every
    :data:`LAUNCHER_EVERY` (a checkpoint at step 3), then a run from a
    directory that holds only that checkpoint, which resumes there; its
    losses at steps 4-6 must be within :data:`LAUNCHER_LOSS_TOL` of the
    straight run's.  Everything is written under a temporary directory,
    removed afterwards."""
    import shutil
    import tempfile

    from repro_torch.launch import train as launch_train

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        def run(ckpt_dir):
            return launch_train.main([
                "--arch", TRAIN_ARCH, "--full", "--layers", str(LAUNCHER_LAYERS), "--int8-opt",
                "--batch", "1", "--seq-len", str(TRAIN_S), "--steps", str(LAUNCHER_STEPS),
                "--ckpt-every", str(LAUNCHER_EVERY), "--log-every", "1", "--device", str(device),
                "--ckpt-dir", ckpt_dir, "--heartbeat", os.path.join(tmp, "heartbeat.json")])
        straight = run(os.path.join(tmp, "straight"))
        at = LAUNCHER_EVERY + 1
        resume_dir = os.path.join(tmp, "resume")
        os.makedirs(resume_dir)
        shutil.copytree(os.path.join(tmp, "straight", f"step_{at:08d}"),
                        os.path.join(resume_dir, f"step_{at:08d}"))
        resumed = run(resume_dir)
        if straight["failures"] or resumed["failures"]:
            raise AssertionError(f"train launcher: {straight['failures']} + "
                                 f"{resumed['failures']} steps failed (printed above)")
        if sorted(resumed["losses"]) != list(range(at, LAUNCHER_STEPS)):
            raise AssertionError(f"train launcher: the resumed run ran steps "
                                 f"{sorted(resumed['losses'])}, want {at}..{LAUNCHER_STEPS - 1}")
        gaps = [abs(resumed["losses"][s] - straight["losses"][s]) for s in resumed["losses"]]
        if max(gaps) > LAUNCHER_LOSS_TOL:
            raise AssertionError(f"train launcher: resumed losses off by {max(gaps):.3e} "
                                 f"> {LAUNCHER_LOSS_TOL}")
        equal = all(resumed["losses"][s] == straight["losses"][s] for s in resumed["losses"])
        print(f"[train] launcher --full --layers {LAUNCHER_LAYERS} --int8-opt S {TRAIN_S}: "
              f"resumed from step {at}, losses at steps {at + 1}-{LAUNCHER_STEPS} within "
              f"{max(gaps):.2e} of the straight run's (bit-equal: {equal}); median step "
              f"{straight['median_ms']:.1f} ms ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_phase(device, card):
    """The training path on the card (K5b's kernel checks run in
    :func:`flash_bwd_phase`): the card against the CPU on the smoke
    models, the main run at full phi4-mini, the launcher's resume.
    Returns the main run's launch counts."""
    train_card_cpu_phase(device)
    launches = train_main_run(device, card)
    train_launcher_check(device, card)
    return launches


# ---------------------------------------------------------------------------
# sharded training (ROADMAP item 7b): the train step on a (data, model) mesh
# ---------------------------------------------------------------------------

SHARD_TRAIN_STEPS = 3  # a run each: f32 and int8 moments, unsharded then sharded
# phi4-mini-3.8b cut from 32 layers to 8: the phase took 169.3 s at full depth,
# past its ~90 s share of the run's limit
SHARD_TRAIN_DEPTH = 8
SHARD_HEAD_MESHES = ((1, 2), (1, 4), (1, 8))  # the model axes K5 / K5b split heads over
SHARD_LAUNCH_LAYERS, SHARD_LAUNCH_STEPS, SHARD_LAUNCH_EVERY = LAUNCHER_LAYERS, 4, 2
# the MoE and VLM families' sharded step (ROADMAP item 7c-i): mixtral-8x22b
# at full width cut from 56 layers to 1 (2.91 B params: 0.40 B of embedding
# and head, 2.42 B of experts), paligemma-3b cut from 18 to 2 with a
# 256-patch prefix before 3840 text tokens (a 4096-row stream)
MOE_TRAIN_DEPTH = 1
PALI_TRAIN_DEPTH, PALI_TRAIN_S, PALI_TRAIN_STEPS = 2, 3840, 2


def train_runs(cfg, batch, rules, fmt, device, want=None, trace=False,
               steps=SHARD_TRAIN_STEPS):
    """``steps`` steps of ``cfg`` (re-initialised from seed 0) with ``fmt``
    moments, one-device when ``rules`` is None, else one rank's sharded
    step under ``rules``.  Returns a dict: ``metrics`` (each step's loss,
    ``ce``, ``aux`` and grad norm), ``ms`` a step, ``launches`` of each
    step, ``peak`` GiB, ``dropped`` (an MoE's share of (token, slot)s its
    routing dropped over the run, else None) and ``out``: the final
    parameter leaves on the card (the moments freed), or, given ``want``
    (another run's), how many of them differ from it.  With ``trace``, one
    more step then counts the collectives it issues
    (``sharding.all_gather`` carries every one) and, unless ``trace`` is
    ``"count"``, another is traced (:func:`train_step_trace`)."""
    import torch

    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import fwd_kwargs
    from repro_torch.models import model_zoo, moe
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_train_step
    from repro_torch.training.sharded import TrainShard

    free_device()
    torch.cuda.reset_peak_memory_stats()
    params = model_zoo.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    shard = TrainShard.of(cfg, rules)
    if shard is not None:
        params = shard.shard_params(params)
        batch = shard.local_rows(batch)
    opt_cfg = AdamWConfig(peak_lr=3e-4, state_dtype=fmt)
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    step_fn = make_train_step(cfg, opt_cfg, fwd_kwargs(cfg), rules=rules)
    run = {"metrics": [], "ms": [], "launches": []}
    kept, route = [0, 0], moe.route

    def counted(*a, **kw):  # the (token, slot)s kept of all routed, forward and remat alike
        r = route(*a, **kw)
        kept[0] += int(r["keep"].sum())
        kept[1] += r["keep"].numel()
        return r

    moe.route = counted
    try:
        for _ in range(steps):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            run["metrics"].append({k: metrics[k].item() for k in ("loss", "ce", "aux",
                                                                  "grad_norm")})
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            run["launches"].append(dict(LAUNCHES))
    finally:
        moe.route = route
    run["dropped"] = 1 - kept[0] / kept[1] if kept[1] else None
    run["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out = list(_leaves(state["params"]))
    if want is not None:
        out = sum(not torch.equal(a, b) for a, b in zip(out, want))
    run["out"] = out
    if trace:
        calls, real = [], sh.all_gather
        sh.all_gather = lambda x, group, dim=0: calls.append(1) or real(x, group, dim)
        try:
            state, _ = step_fn(state, batch)
        finally:
            sh.all_gather = real
        print(f"[sharded-train] {cfg.name} {fmt}, {'sharded' if rules else 'one-device'}: "
              f"{len(calls)} collectives a step")
        if trace != "count":
            state = train_step_trace(step_fn, state, batch, f"{cfg.name} {fmt} "
                                     f"{'sharded 1x1' if rules else 'one-device'}")
    del state, params, step_fn
    free_device()
    return run


def held_to_one_device(cfg, batch, rules, fmts, device, card, steps=SHARD_TRAIN_STEPS,
                       trace_fmt=None, tokens=None, count_fmt=None):
    """For each moments format of ``fmts``: ``steps`` one-device steps, then
    the same through the sharded train step under ``rules`` (an NCCL world
    of one): every step's loss, ``ce``, ``aux`` and grad norm must equal the
    one-device step's bit for bit, and after the last step every
    parameter; every step launches K5 2A times (forward and remat) and K5b
    A times, nothing else, A the attention layers (every layer but a
    mamba mixer's; whisper: K5 E + 4L, the encoder's E not rematerialised
    and the decoder's causal and cross each twice, K5b E + 2L).
    ``trace_fmt``'s sharded run counts and traces one more step,
    ``count_fmt``'s counts it only.  Prints ms a step, ``tokens`` (a step's
    rows, B x S when None) a second, the peak and an MoE's dropped share.
    Returns the sharded steps' launches summed."""
    L = cfg.num_layers
    A = sum(cfg.layer_is_attention(i) for i in range(L))
    fwd, bwd = 2 * A, A
    if cfg.family == "enc_dec":
        fwd, bwd = cfg.encoder_layers + 4 * L, cfg.encoder_layers + 2 * L
    rows = tokens or TRAIN_B * TRAIN_S
    total = {}
    for fmt in fmts:
        base = train_runs(cfg, batch, None, fmt, device, steps=steps)
        got = train_runs(cfg, batch, rules, fmt, device, want=base["out"],
                         trace=True if fmt == trace_fmt else "count" if fmt == count_fmt
                         else False, steps=steps)
        for i in range(steps):
            want = {n: 0 for n in got["launches"][i]}
            want.update(flash_attention=fwd, flash_attention_bwd=bwd)
            if got["launches"][i] != want:
                raise AssertionError(f"sharded train {cfg.name} {fmt} step {i}: launches "
                                     f"{got['launches'][i]}, want {want}")
            for name, n in got["launches"][i].items():
                total[name] = total.get(name, 0) + n
        if got["metrics"] != base["metrics"]:
            raise AssertionError(f"sharded train {cfg.name} {fmt}: metrics {got['metrics']} "
                                 f"differ from the one-device step's {base['metrics']}")
        if got["out"]:
            raise AssertionError(f"sharded train {cfg.name} {fmt}: {got['out']} parameter "
                                 f"leaves differ from the one-device step's after {steps} "
                                 f"steps")
        for what, run in (("one-device", base), ("sharded 1x1 fsdp", got)):
            steady = run["ms"][1:]
            drop = ("" if run["dropped"] is None else
                    f", {100 * run['dropped']:.2f}% of (token, slot)s dropped at capacity "
                    f"factor {cfg.moe_capacity_factor}")
            print(f"[sharded-train] {cfg.name} ({L} layers) {fmt} moments, {what}: losses "
                  f"{[round(m['loss'], 6) for m in run['metrics']]}, aux "
                  f"{[round(m['aux'], 6) for m in run['metrics']]}, ms a step "
                  f"{[round(x, 1) for x in run['ms']]} (steady {sum(steady) / len(steady):.1f} "
                  f"ms, {rows * len(steady) / sum(steady) * 1e3:.0f} tokens/s), peak "
                  f"{run['peak']:.2f} GiB{drop} [{card}]")
        print(f"[sharded-train] {cfg.name} {fmt}: the sharded 1x1 step (NCCL, fsdp rules) "
              f"is bit-identical to the one-device step: {steps} losses, ce, aux and grad "
              f"norms, then all {len(base['out'])} parameter leaves; K5 {fwd}, K5b {bwd} "
              f"launches a step")
        del base, got
        free_device()
    return total


def sharded_train_run(device, card):
    """phi4-mini-3.8b at full width (depth :data:`SHARD_TRAIN_DEPTH`, None =
    all 32 layers) at B 1, S 4096 with remat: :data:`SHARD_TRAIN_STEPS`
    one-device steps, then the same through the sharded train step with the
    reference launcher's ``--fsdp`` rules on a 1x1 mesh over an NCCL world
    of one (every FSDP gather, reduce-scatter, sum over ``"model"`` and the
    global-mean loss run as collectives of one), once with f32 and once
    with int8 moments (:func:`held_to_one_device`).  The f32 sharded run
    counts and traces one more step.  Then one int8-compressed sync of the
    step's grads (``compressed_psum_mean`` over the world of one, and
    ``make_compressed_dp_grad_fn``): each leaf equals its plain quantize
    formula ``round(g / s) * s / 1`` bit for bit, and differs from g.
    Returns the sharded steps' launches summed."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh

    cfg = get_config(TRAIN_ARCH)
    if SHARD_TRAIN_DEPTH is not None:
        cfg = dataclasses.replace(cfg, num_layers=SHARD_TRAIN_DEPTH)
    batch = to_device(SyntheticLMDataset(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0).batch(0),
                      device)
    started = start_world()
    try:
        rules = sh.rules_for_mesh(make_debug_mesh(1, 1, "cuda"), fsdp_axes=(sh.D_MODEL,),
                                  sp=False)
        total = held_to_one_device(cfg, batch, rules, ("fp32", "int8"), device, card,
                                   trace_fmt="fp32")
        compressed_sync_check(cfg, batch, rules, device, card)
    finally:
        if started:
            dist.destroy_process_group()
    return total


def sharded_moe_train_run(device, card):
    """ROADMAP item 7c-i's training on the card: the reference launcher's
    ``--fsdp`` rules on a 1x1 mesh over an NCCL world of one against the
    one-device step (:func:`held_to_one_device`).  mixtral-8x22b at full
    width cut to :data:`MOE_TRAIN_DEPTH` layer (2.91 B parameters: the
    experts, their FF split over ``"model"`` and their ``d_model`` over
    ``"data"``, the group-local dispatch on the rank's rows, the global
    aux), B 1, S 4096, remat, at its own capacity factor 1.25 so that
    tokens drop, :data:`SHARD_TRAIN_STEPS` f32 and int8 steps, K5 on the
    sliding kind; then paligemma-3b cut to :data:`PALI_TRAIN_DEPTH`
    layers, a 256-patch prefix before :data:`PALI_TRAIN_S` text tokens,
    :data:`PALI_TRAIN_STEPS` f32 steps, K5 on ``prefix_causal``.  Returns
    the sharded steps' launches summed."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import modality
    from repro_torch.models import model_zoo, transformer

    started = start_world()
    total = {}
    try:
        rules = sh.rules_for_mesh(make_debug_mesh(1, 1, "cuda"), fsdp_axes=(sh.D_MODEL,),
                                  sp=False)
        for arch, depth, S, fmts, steps in (
                (MIXTRAL_ARCH, MOE_TRAIN_DEPTH, TRAIN_S, ("fp32", "int8"), SHARD_TRAIN_STEPS),
                (PALI_ARCH, PALI_TRAIN_DEPTH, PALI_TRAIN_S, ("fp32",), PALI_TRAIN_STEPS)):
            cfg = dataclasses.replace(get_config(arch), num_layers=depth)
            ds = SyntheticLMDataset(cfg.vocab_size, S, TRAIN_B, seed=0, modality=modality(cfg))
            batch = to_device(ds.batch(0), device)
            rows = TRAIN_B * (S + (cfg.vision_tokens if cfg.family == "vlm" else 0))
            kind = transformer._mask_kind(cfg)
            window = (cfg.vision_tokens if cfg.family == "vlm"
                      else int(transformer.layer_windows(cfg)[0]))
            nparam = sum(t.numel() for t in _leaves(model_zoo.init(cfg, None, "meta")))
            print(f"[sharded-moe] {cfg.name} at full width, {depth} of "
                  f"{get_config(arch).num_layers} layers ({nparam / 1e9:.3f} B params), B "
                  f"{TRAIN_B}, a {rows}-row stream, remat; K5 / K5b on the {kind} kind "
                  f"(window {window}); capacity factor {cfg.moe_capacity_factor}")
            t = time.perf_counter()
            for name, n in held_to_one_device(cfg, batch, rules, fmts, device, card,
                                              steps=steps, tokens=rows).items():
                total[name] = total.get(name, 0) + n
            print(f"[time] sharded train {cfg.name}: {time.perf_counter() - t:.1f} s")
    finally:
        if started:
            dist.destroy_process_group()
    return total


def mixer_state_bytes(card) -> None:
    """The decode state a rank holds for one slot of mamba2-1.3b (48 mamba
    layers) and jamba-1.5-large-398b (63 of its 72 layers) at full depth on
    model axes of 1, 2 and 8: the closed form ``L (H / m · P · N · 4 +
    (K - 1)(d_in / m + 2 N) · 2)`` B held to the local shapes that
    ``sharded.cache_shardings`` cuts (meta tensors).  Printed because the
    reference's ``kv_read`` leaves the state out."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.serving import kv_cache as kvc, sharded as shd

    for arch in (SSM_ARCH, HYBRID_ARCH):
        cfg = get_config(arch)
        lay = kvc.layout_for(cfg, 1, SSM_MAX_SEQ)
        state = kvc.init_cache_arrays(cfg, lay, "meta")
        L, d_in, N = len(lay.mamba_layers), cfg.ssm_expand * cfg.d_model, cfg.ssm_state
        H, P, K = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_conv
        out = []
        for m in (1, 2, 8):
            rules = sh.ShardingRules(mesh={"data": 1, "model": m})
            specs = shd.cache_shardings(state, cfg, lay, rules)["mamba"]
            got = sum(sh.local_slice(a, specs[n], rules.mesh, {"data": 0, "model": 0}).numel()
                      * a.element_size() for n, a in state["mamba"].items())
            n = m if H % m == 0 else 1  # heads the model axis does not divide replicate
            want = L * (H // n * P * N * 4 + (K - 1) * (d_in // n + 2 * N) * 2)
            if got != want:
                raise AssertionError(f"{arch} state on 1x{m}: {got} B a rank, closed form {want}")
            out.append(f"1x{m} {got / 1e6:.3f} MB")
        print(f"[sharded-ssm] {cfg.name} decode state a slot a rank ({L} mamba layers, h "
              f"{H} heads x {P} x {N} f32 split by heads, conv window {K - 1} x (d_in {d_in} "
              f"split + 2N {2 * N} whole) bf16): {', '.join(out)} (closed form = the cut)")


# the ssm and hybrid families' sharded step (ROADMAP item 7c-ii (a)):
# mamba2-1.3b at full width cut from 48 layers to 8, and jamba-1.5-large-398b
# at full width cut to 2 layers, attn_every 2 (a mamba layer and its dense
# MLP, then the attention layer and an MoE of 2 of its 16 experts; 3.43 B
# params: one super-block with 2 experts is ~11 B, ~136 GB of f32 AdamW
# state, past one card)
SSM_TRAIN_DEPTH, HYBRID_TRAIN_EXPERTS, HYBRID_TRAIN_STEPS = 8, 2, 2


def sharded_ssm_train_run(device, card):
    """ROADMAP item 7c-ii (a)'s training on the card: the reference
    launcher's ``--fsdp`` rules on a 1x1 mesh over an NCCL world of one
    against the one-device step (:func:`held_to_one_device`, its
    ``fwd_kwargs``: SSD chunk 64, remat): mamba2-1.3b (:data:`SSM_TRAIN_DEPTH`
    layers; no kernel of the repo runs), :data:`SHARD_TRAIN_STEPS` f32 and
    int8 steps; jamba cut to 2 layers (K5 2 and K5b 1 a step, capacity
    factor 1.25, the dropped share printed), :data:`HYBRID_TRAIN_STEPS` f32
    and int8 steps; B 1, S 4096.  Then :func:`mixer_state_bytes`.  Returns
    the sharded steps' launches summed."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model_zoo

    mamba = dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_TRAIN_DEPTH)
    jamba = dataclasses.replace(get_config(HYBRID_ARCH), num_layers=2, attn_every=2,
                                attn_offset=1, num_experts=HYBRID_TRAIN_EXPERTS)
    started = start_world()
    total = {}
    try:
        rules = sh.rules_for_mesh(make_debug_mesh(1, 1, "cuda"), fsdp_axes=(sh.D_MODEL,),
                                  sp=False)
        for cfg, full, steps in ((mamba, get_config(SSM_ARCH), SHARD_TRAIN_STEPS),
                                 (jamba, get_config(HYBRID_ARCH), HYBRID_TRAIN_STEPS)):
            batch = to_device(SyntheticLMDataset(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                                 seed=0).batch(0), device)
            nparam = sum(t.numel() for t in _leaves(model_zoo.init(cfg, None, "meta")))
            experts = ("" if cfg.family == "ssm" else
                       f" (attn_every 2, {cfg.num_experts} of {full.num_experts} experts)")
            print(f"[sharded-ssm] {cfg.name} at full width, {cfg.num_layers} of "
                  f"{full.num_layers} layers{experts} ({nparam / 1e9:.3f} B params), B "
                  f"{TRAIN_B}, S {TRAIN_S}, remat; capacity factor {cfg.moe_capacity_factor}")
            t = time.perf_counter()
            for name, n in held_to_one_device(cfg, batch, rules, ("fp32", "int8"), device, card,
                                              steps=steps).items():
                total[name] = total.get(name, 0) + n
            print(f"[time] sharded train {cfg.name}: {time.perf_counter() - t:.1f} s")
    finally:
        if started:
            dist.destroy_process_group()
    mixer_state_bytes(card)
    return total


# the enc_dec family's sharded step (ROADMAP item 7c-ii (b)): whisper-medium
# at full width and depth, B 1, the published decoder context of 448 tokens
# over 1500 frames
WHISPER_TRAIN_S = 448


def sharded_encdec_train_run(device, card):
    """ROADMAP item 7c-ii (b)'s training on the card: whisper-medium at full
    width and depth (24 + 24 layers) at B 1, decoder S
    :data:`WHISPER_TRAIN_S` over 1500 frames, remat (the decoder's), the
    reference launcher's ``--fsdp`` rules on a 1x1 mesh over an NCCL world
    of one against the one-device step (:func:`held_to_one_device`):
    :data:`SHARD_TRAIN_STEPS` f32 and int8 steps, each loss, ``ce`` and
    grad norm and then every parameter bit-identical, K5 120 and K5b 72
    launches a step; the f32 run counts one more step's collectives.
    Returns the sharded steps' launches summed."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import modality
    from repro_torch.models import model_zoo

    cfg = get_config(WHISPER_ARCH)
    batch = to_device(SyntheticLMDataset(cfg.vocab_size, WHISPER_TRAIN_S, TRAIN_B, seed=0,
                                         modality=modality(cfg)).batch(0), device)
    nparam = sum(t.numel() for t in _leaves(model_zoo.init(cfg, None, "meta")))
    print(f"[sharded-encdec] {cfg.name} at full width and depth ({cfg.encoder_layers} + "
          f"{cfg.num_layers} layers, {nparam / 1e9:.3f} B params), B {TRAIN_B}, decoder S "
          f"{WHISPER_TRAIN_S} over {cfg.encoder_seq} frames, remat, fsdp rules")
    started = start_world()
    try:
        rules = sh.rules_for_mesh(make_debug_mesh(1, 1, "cuda"), fsdp_axes=(sh.D_MODEL,),
                                  sp=False)
        total = held_to_one_device(cfg, batch, rules, ("fp32", "int8"), device, card,
                                   tokens=TRAIN_B * WHISPER_TRAIN_S, count_fmt="fp32")
    finally:
        if started:
            dist.destroy_process_group()
    return total


def compressed_sync_check(cfg, batch, rules, device, card):
    """One int8-compressed sync of one step's grads on the card over the
    data axis of a world of one: ``compressed_psum_mean`` and
    ``make_compressed_dp_grad_fn`` against the plain quantize formula, leaf
    by leaf, bit for bit; the sync's ms (CUDA events) printed."""
    import torch

    from repro_torch.distributed.compression import (compressed_psum_mean,
                                                     make_compressed_dp_grad_fn)
    from repro_torch.launch.train import fwd_kwargs
    from repro_torch.models import model_zoo
    from repro_torch.training import make_loss_fn
    from repro_torch.training.train_step import loss_and_grads

    free_device()
    params = model_zoo.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    loss_fn = make_loss_fn(cfg, fwd_kwargs(cfg))
    _, _, grads = loss_and_grads(loss_fn, params, batch)
    group = rules.mesh.get_group("data")

    def plain(g):
        g32 = g.float()
        scale = torch.clamp(g32.abs().amax(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        return (q.to(torch.int32).to(torch.float32) * scale / 1).to(g.dtype)

    def held(got, label):
        bad = same = 0
        for g, c in zip(_leaves(grads), _leaves(got)):
            bad += int(not torch.equal(c, plain(g)))
            same += int(torch.equal(c, g))
        if bad or same == len(list(_leaves(grads))):
            raise AssertionError(f"compressed sync ({label}): {bad} leaves differ from the "
                                 f"plain quantize formula, {same} are copies of the grads")
        return same

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    synced = compressed_psum_mean(grads, group)
    b.record()
    torch.cuda.synchronize()
    same = held(synced, "compressed_psum_mean")
    del synced
    free_device()
    loss, got = make_compressed_dp_grad_fn(lambda p, x: loss_fn(p, x)[0], rules)(params, batch)
    held(got, "make_compressed_dp_grad_fn")
    print(f"[sharded-train] int8-compressed grad sync of {cfg.name}'s {len(list(_leaves(grads)))} "
          f"grad leaves over the data axis of a world of one: every leaf equal to round(g / s) "
          f"* s / 1 bit for bit ({same} leaves already on that grid), "
          f"{a.elapsed_time(b):.1f} ms between events; make_compressed_dp_grad_fn loss "
          f"{loss.item():.6f} [{card}]")
    del grads, got, params
    free_device()


# K5 / K5b on a model rank of the MoE archs' training shapes (ROADMAP item
# 7c-i): mixtral's 48 / 8 heads, sliding 4096 at S 4096, every rank of 1x2
# and 1x8; llama4-scout's 40 / 8 heads, chunked 8192 at S 8448, rank 0 of 1x8
MIXTRAL_FLASH = dict(Hq=48, Hk=8, S=4096, kw=dict(mask_kind="sliding", window=4096, q_offset=0),
                     meshes=((1, 2), (1, 8)), first_only=())
LLAMA4_RANK_FLASH = dict(Hq=40, Hk=8, S=LLAMA4_FLASH_S,
                         kw=dict(mask_kind="chunked", window=LLAMA4_CHUNK, q_offset=0),
                         meshes=((1, 8),), first_only=((1, 8),))


def shard_flash_phase(device, flush):
    """Each model rank's K5 (with its log-sum-exp, the training forward's
    launch) and K5b (:func:`rank_flash`): at phi4-mini-3.8b's heads (Hq 24,
    Hk 8, D 128, causal, B 1, S 4096, bf16) split over the model axes of
    :data:`SHARD_HEAD_MESHES`, at mixtral-8x22b's (:data:`MIXTRAL_FLASH`)
    and llama4-scout's (:data:`LLAMA4_RANK_FLASH`).  Returns the records of
    the 1x2 and 1x8 meshes' rank 0 launches (K5 and K5b, timed, with their
    cases and ``err_over_tol``)."""
    records = rank_flash(device, flush, "phi4-mini-3.8b", Hq=24, Hk=8, S=TRAIN_S,
                         kw=dict(mask_kind="causal", window=0, q_offset=0),
                         meshes=SHARD_HEAD_MESHES, record=(2, 8))
    records += rank_flash(device, flush, MIXTRAL_ARCH, record=(2, 8), **MIXTRAL_FLASH)
    records += rank_flash(device, flush, LLAMA4_ARCH, record=(8,), **LLAMA4_RANK_FLASH)
    return records


# jamba-1.5-large-398b's heads on a model rank (ROADMAP item 7c-ii (a)): its
# 64 / 8 heads of 128, g 8, split 32 / 4 and 8 / 1
JAMBA_RANK_MESHES = ((1, 2), (1, 8))


def shard_ssm_kernel_phase(device, flush):
    """The hybrid's attention launches on a model rank at jamba's heads:
    K1 bf16 / int8 and K2 on every rank of :data:`JAMBA_RANK_MESHES`
    (:func:`shard_attends`, rank (0, 0) of 1x8 timed), and K5 (with its
    log-sum-exp) and K5b at causal, B 1, S 4096 on rank 0 of 1x8
    (:func:`rank_flash`), each bit-equal to its slice of the whole launch.
    Returns their records."""
    records = shard_attends(device, flush, HYBRID_ARCH, JAMBA_RANK_MESHES, timed_mesh=(1, 8))
    records += rank_flash(device, flush, HYBRID_ARCH, Hq=64, Hk=8, S=TRAIN_S,
                          kw=dict(mask_kind="causal", window=0, q_offset=0), meshes=((1, 8),),
                          record=(8,), first_only=((1, 8),))
    return records


# whisper-medium's heads on a model rank (ROADMAP item 7c-ii (b)): its 16 / 16
# heads of 64, g 1, split 8 / 8 and 2 / 2
WHISPER_RANK_MESHES = ((1, 2), (1, 8))


def shard_encdec_kernel_phase(device, flush):
    """The enc_dec family's launches on a model rank at whisper-medium's
    heads: K1 bf16 / int8 and K2 on every rank of
    :data:`WHISPER_RANK_MESHES` (:func:`shard_attends`, rank (0, 0) of 1x8
    timed), and K5 (with its log-sum-exp) and K5b on rank 0 of 1x8 at the
    encoder's ``full`` over 1500 frames and the cross-attention's ``full``
    of :data:`WHISPER_TRAIN_S` queries over them (:func:`rank_flash`), each
    bit-equal to its slice of the whole launch.  Returns their records."""
    from repro_torch.configs import get_config

    cfg = get_config(WHISPER_ARCH)
    records = shard_attends(device, flush, WHISPER_ARCH, WHISPER_RANK_MESHES,
                            timed_mesh=(1, 8))
    full = dict(mask_kind="full", window=0, q_offset=0)
    for Sq in (cfg.encoder_seq, WHISPER_TRAIN_S):
        records += rank_flash(device, flush, WHISPER_ARCH, Hq=cfg.num_heads,
                              Hk=cfg.num_kv_heads, S=Sq, Sk=cfg.encoder_seq, kw=full,
                              meshes=((1, 8),), record=(8,), first_only=((1, 8),),
                              D=cfg.head_dim)
    return records


def rank_flash(device, flush, arch, Hq, Hk, S, kw, meshes, record, first_only=(), D=128,
               Sk=None):
    """K5 (with its log-sum-exp) and K5b at ``arch``'s heads (``Hq`` /
    ``Hk`` of ``D``, B 1, bf16, the mask ``kw``) at ``S`` queries over
    ``Sk`` keys (``S`` when None), split over
    the model axes of ``meshes`` (only rank 0 of a mesh in
    ``first_only``): every rank's out, lse, dq, dk and dv must equal its
    heads' slice of the whole launch bit for bit, and be within K5's
    per-element bound (:func:`flash_case`'s) and K5b's
    (:func:`bwd_tolerance`) of the plain versions' slice.  Returns the
    records of rank 0's launches on the model axes of ``record``."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                          flash_attention_ref)
    from repro_torch.core.attention import make_mask

    gen = torch.Generator(device=device).manual_seed(9)
    B, Sk = TRAIN_B, Sk or S
    mk = lambda H, n: torch.randn((B, n, H, D), generator=gen, device=device).to(torch.bfloat16)
    q, k, v, dout = mk(Hq, S), mk(Hk, Sk), mk(Hk, Sk), mk(Hq, S)
    kind, window = kw["mask_kind"], kw["window"]
    fwd = lambda q_, k_, v_: flash_ops._forward(q_, k_, v_, kind, window, 0, D ** -0.5,
                                                want_lse=True)
    out, lse = fwd(q, k, v)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want_out = torch.cat([flash_attention_ref(q[:, i:i + BWD_ROWS], k, v,
                                              **dict(kw, q_offset=i))
                          for i in range(0, S, BWD_ROWS)], 1).float()
    want_grads = bwd_plain_blocked(q, k, v, out, lse, dout, kw)
    torch.cuda.synchronize()
    out_tol = 1e-5 * v.float().abs().max() + torch.ldexp(
        torch.ones_like(want_out), torch.frexp(want_out.abs())[1] - 8)
    grad_tol = [bwd_tolerance(w, True) for w in want_grads]
    what = f"{kind} {window}" if window else kind
    records = []
    for mesh in meshes:
        m = mesh[1]
        hq, hk = Hq // m, Hk // m
        worst, ranks = 0.0, range(1 if mesh in first_only else m)
        for r in ranks:
            qh, kh = slice(r * hq, (r + 1) * hq), slice(r * hk, (r + 1) * hk)
            args = [t[:, :, h].contiguous() for t, h in ((q, qh), (k, kh), (v, kh))]
            o_r, l_r = fwd(*args)
            d_r = flash_attention_bwd(*args, o_r, l_r, dout[:, :, qh].contiguous(), **kw)
            torch.cuda.synchronize()
            whole = (out[:, :, qh], lse[:, qh], grads[0][:, :, qh], grads[1][:, :, kh],
                     grads[2][:, :, kh])
            if not all(torch.equal(a, b) for a, b in zip((o_r, l_r) + tuple(d_r), whole)):
                raise AssertionError(f"K5 / K5b {arch} rank {r} of mesh 1x{m}: not its heads' "
                                     f"slice of the whole launch")
            share = 0.0
            for what_, got, want, tol in (
                    ("out", o_r, want_out[:, :, qh], out_tol[:, :, qh]),
                    ("dq", d_r[0], want_grads[0][:, :, qh], grad_tol[0][:, :, qh]),
                    ("dk", d_r[1], want_grads[1][:, :, kh], grad_tol[1][:, :, kh]),
                    ("dv", d_r[2], want_grads[2][:, :, kh], grad_tol[2][:, :, kh])):
                err = (got.float() - want.float()).abs()
                if bool((err > tol).any()):
                    at = tuple((err / tol).flatten().argmax().item() // n % s_ for n, s_ in
                               zip(err.stride(), err.shape))
                    raise AssertionError(
                        f"K5 / K5b {arch} rank {r} of mesh 1x{m}: {what_} beyond the plain "
                        f"version's bound by {(err / tol).max().item():.3f}x at {at}: kernel "
                        f"{got[at].item():.6e}, plain {want[at].item():.6e}, bound "
                        f"{tol[at].item():.3e}, max |plain| {want.float().abs().max().item():.4e}")
                share = max(share, (err / tol).max().item())
            worst = max(worst, share)
            if r == 0 and m in record:
                length = f"S{S}" if Sk == S else f"Sq{S} Sk{Sk}"
                case = (f"{arch} sharded train mesh 1x{m} rank 0: Hq {hq} Hk {hk} D {D} "
                        f"{what} B{B} {length} bf16")
                pairs = int(make_mask(kind, S, Sk, window, 0, device).sum()) * B * hq
                o_err = (o_r.float() - want_out[:, :, qh]).abs()
                rec = kernel_record(
                    "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention/kernel.py:114", o_err.max().item(),
                    time_ms(lambda: fwd(*args), flush=flush),
                    time_ms(lambda: flash_attention_ref(*args, **kw), flush=flush, iters=3),
                    2 * (2 * args[0].numel() + 2 * args[1].numel()) + 4 * l_r.numel(),
                    4 * D * pairs, "bf16", time_ms(flash_library(*args, kw), flush=flush),
                    label=f" {case}", case=case)
                rec["err_over_tol"] = (o_err / out_tol[:, :, qh]).max().item()
                records.append(rec)
                dq_ = dout[:, :, qh].contiguous()
                errs = [(g.float() - w.float()).abs().max().item() for g, w in
                        zip(d_r, (want_grads[0][:, :, qh], want_grads[1][:, :, kh],
                                  want_grads[2][:, :, kh]))]
                rec = kernel_record(
                    "flash_attention_bwd", K5B_SOURCE, K5B_REPLACES, max(errs),
                    time_ms(lambda: flash_attention_bwd(*args, o_r, l_r, dq_, **kw),
                            flush=flush),
                    time_ms(lambda: flash_attention_bwd_ref(*args, o_r, l_r, dq_, **kw),
                            flush=flush, iters=3),
                    2 * (4 * args[0].numel() + 4 * args[1].numel()) + 4 * l_r.numel(),
                    10 * D * pairs, "bf16", time_ms(sdpa_fwd_bwd(*args, dq_, kw), flush=flush),
                    label=f" {case}", case=case)
                rec["err_over_tol"] = share
                records.append(rec)
        print(f"[shard] K5 (with lse) and K5b at {arch}'s heads on {len(ranks)} of the {m} "
              f"model ranks of mesh 1x{m} (Hq {hq}, Hk {hk} a rank, D {D}, {what}, B {B}, "
              f"Sq {S}, Sk {Sk}, bf16): each rank's out, lse, dq, dk and dv bit-equal to its heads' "
              f"slice of the whole launch, within the plain versions' bounds (worst err/tol "
              f"{worst:.3f})")
    del q, k, v, dout, out, lse, grads, want_out, want_grads
    free_device()
    return records


def _train_losses(stdout):
    """``{step: loss text}`` of a train launcher's ``[train] step`` lines."""
    out = {}
    for ln in stdout.splitlines():
        if ln.startswith("[train] step"):
            parts = ln.split()
            out[int(parts[2])] = parts[4]
    return out


def sharded_train_launcher(card):
    """``python -m torch.distributed.run --nproc-per-node 1 -m
    repro_torch.launch.train --full --layers`` :data:`SHARD_LAUNCH_LAYERS`
    ``--mesh 1,1 --fsdp --int8-opt`` at phi4-mini width, B 1, S 4096: a
    straight run of :data:`SHARD_LAUNCH_STEPS` steps checkpointing every
    :data:`SHARD_LAUNCH_EVERY` (rank 0 writing), then a run from a
    directory holding only its step-3 checkpoint, which every rank
    restores; the resumed run's logged losses must equal the straight
    run's.  Checkpoints live under ``build/``, removed afterwards."""
    import shutil
    import tempfile

    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="sharded-train-", dir=root)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    try:
        def run(ckpt):
            out = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node=1", "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH,
                 "--full", "--layers", str(SHARD_LAUNCH_LAYERS), "--mesh", "1,1", "--fsdp",
                 "--int8-opt", "--batch", "1", "--seq-len", str(TRAIN_S), "--steps",
                 str(SHARD_LAUNCH_STEPS), "--ckpt-every", str(SHARD_LAUNCH_EVERY),
                 "--log-every", "1", "--ckpt-dir", ckpt,
                 "--heartbeat", os.path.join(tmp, "heartbeat.json")],
                capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
            if out.returncode or "failed" in out.stdout:
                raise AssertionError(f"train launcher under torchrun --mesh 1,1 --fsdp failed: "
                                     f"{out.stdout[-1500:]} {out.stderr[-2000:]}")
            return out.stdout
        straight = run(os.path.join(tmp, "straight"))
        at = SHARD_LAUNCH_EVERY + 1
        os.makedirs(os.path.join(tmp, "resume"))
        shutil.copytree(os.path.join(tmp, "straight", f"step_{at:08d}"),
                        os.path.join(tmp, "resume", f"step_{at:08d}"))
        resumed = run(os.path.join(tmp, "resume"))
        a, b = _train_losses(straight), _train_losses(resumed)
        if sorted(b) != list(range(at, SHARD_LAUNCH_STEPS)) or any(b[s] != a[s] for s in b):
            raise AssertionError(f"train launcher under torchrun: resumed losses {b} against "
                                 f"the straight run's {a}")
        median = [ln for ln in straight.splitlines() if "median step" in ln]
        print(f"[sharded-train] launcher under torch.distributed.run --nproc-per-node 1, "
              f"--mesh 1,1 --fsdp --int8-opt --full --layers {SHARD_LAUNCH_LAYERS} S {TRAIN_S}: "
              f"resumed from step {at}, losses at steps {at}-{SHARD_LAUNCH_STEPS - 1} equal to "
              f"the straight run's ({', '.join(b[s] for s in sorted(b))}); "
              f"{median[-1][8:] if median else ''} [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


PHASES = ("kernels", "head-widths", "long-context", "prefix", "score", "score-device", "decode",
          "decode-attends", "ssm", "hybrid", "long-serve", "whisper", "server", "train",
          "sharded", "sharded-train", "sharded-moe", "sharded-ssm", "sharded-encdec")


def sharded_only_phase(device, card):
    """phi4-mini-3.8b's unsharded runs of :data:`SHARDED_RUNS`' formats,
    then :func:`sharded_serve` against them and :func:`multi_card_check`."""
    cfg, params = init_model("phi4-mini-3.8b", device)
    _, outcome = serve_runs(cfg, params, tuple(k[:3] for k in SHARDED_RUNS), MAIN_TRACE, 1024,
                            device, card)
    sharded_serve(cfg, params, outcome, device, card)
    del params
    free_device()
    multi_card_check(card)


def sharded_moe_only_phase(device, card):
    """ROADMAP item 7c-i alone: llama4-scout's and paligemma-3b's sharded
    Scheduler runs against their unsharded runs (:func:`moe_serve_phase`,
    :func:`vlm_serve_phase` without the other runs), the sharded MoE and
    VLM train steps (:func:`sharded_moe_train_run`) and
    :func:`multi_card_check`."""
    moe_serve_phase(device, card, sharded=False)
    vlm_serve_phase(device, card, sharded=False)
    timed(sharded_moe_train_run, device, card)
    multi_card_check(card)


def sharded_ssm_only_phase(device, card):
    """ROADMAP item 7c-ii (a) alone: mamba2-1.3b (:data:`SSM_DEPTH` layers)
    decoding :data:`SSM_PROMPTS` and jamba-1.5-large-398b (one super-block,
    8 experts) decoding :data:`HYBRID_PROMPTS` in :data:`HYBRID_SHARD_FORMATS`
    through ``make_serve_step``, unsharded then on a 1x1 NCCL mesh
    (:func:`sharded_decode_check`), then :func:`sharded_ssm_train_run`."""
    import numpy as np
    import torch

    from repro_torch import kernels as K

    for arch, depth, experts, sizes, fmts in (
            (SSM_ARCH, SSM_DEPTH, None, SSM_PROMPTS, (None,)),
            (HYBRID_ARCH, HYBRID_DEPTH, HYBRID_EXPERTS, HYBRID_PROMPTS, HYBRID_SHARD_FORMATS)):
        cfg, params = init_model(arch, device, depth=depth, experts=experts)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in sizes]
        for fmt in fmts:
            if fmt is None:
                decode = lambda r, t, w: ssm_decode(cfg, params, prompts, SSM_NEW, device, t, r,
                                                    w)[2]
            else:
                decode = lambda r, t, w, f=fmt: hybrid_decode(cfg, params, f, prompts,
                                                              HYBRID_NEW, device, t, r, w)[1]
            spans, rows = [], []
            K.reset_launches()
            gen = decode(None, spans, rows)
            torch.cuda.synchronize()
            launched = {k: v for k, v in K.LAUNCHES.items() if v}
            want = (torch.stack(rows), gen, np.mean([a.elapsed_time(b) for a, b in spans]),
                    launched)
            del rows
            sharded_decode_check(cfg, decode, want, "decode" if fmt is None else
                                 f"{fmt} KV decode", card)
            del want
            free_device()
        del params
        free_device()
    timed(sharded_ssm_train_run, device, card)


def sharded_encdec_only_phase(device, card):
    """ROADMAP item 7c-ii (b) alone: whisper-medium's encoder over 4 x 1500
    frames and its :data:`WHISPER_SHARD_RUNS` decodes of
    :data:`WHISPER_PROMPTS` unsharded, then again on a 1x1 NCCL mesh
    (:func:`whisper_sharded`), then :func:`sharded_encdec_train_run`."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.models import whisper

    cfg, params = init_model(WHISPER_ARCH, device)
    B = len(WHISPER_PROMPTS)
    frames = whisper_frames(cfg, B, 0, device)
    memory = whisper.encode(params, cfg, frames)
    cross = whisper.cross_kv(params, cfg, memory)
    enc_ms = time_ms(lambda: whisper.encode(params, cfg, frames), iters=3)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in WHISPER_PROMPTS]
    unsharded = {}
    for fmt, layout in WHISPER_SHARD_RUNS:
        lay, cache = whisper_cache(cfg, cross, fmt, layout, B, WHISPER_MAX_SEQ, device)
        spans, every = [], []
        K.reset_launches()
        _, gen, cache = whisper_decode(cfg, params, cache, lay, prompts, WHISPER_NEW,
                                       timed=spans, every=every)
        torch.cuda.synchronize()
        unsharded[fmt] = (torch.stack(every), gen,
                          np.mean([a.elapsed_time(b) for a, b in spans]),
                          {k: v for k, v in K.LAUNCHES.items() if v})
        del cache, every
        free_device()
    whisper_sharded(cfg, params, frames, memory, cross, enc_ms, prompts, unsharded, device, card)
    del params, memory, cross, unsharded
    free_device()
    timed(sharded_encdec_train_run, device, card)


def timed(fn, *args):
    """``fn(*args)``, its seconds printed as a ``[time]`` line."""
    t = time.perf_counter()
    out = fn(*args)
    print(f"[time] {fn.__name__}: {time.perf_counter() - t:.1f} s")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", action="append", choices=PHASES,
        help="run only these phases (repeatable), for work on one kernel: 'kernels' is "
             "phase 3 without K6, 'head-widths' its head-width cases, 'long-context' K1 at "
             "524,288 and K2 at 32768 and 524,288 lanes, 'prefix' K5's prefix_causal, 'score' K6's checks "
             "and device times, 'score-device' K6's device times alone, 'decode' K4's checks "
             "and device times, 'decode-attends' K1's and K2's device times at the decode "
             "geometry alone (public wrappers only: it runs on an older tree too), 'ssm' "
             "mamba2-1.3b's decode, forward and long_500k cache and mamba2-smoke against the "
             "CPU, 'hybrid' jamba-1.5-large-398b (one super-block, 8 experts) decoding "
             "in every KV format, its forward, and jamba-smoke against the CPU, "
             "'long-serve' gemma3-1b served at max_seq 524,288, 'whisper' "
             "whisper-medium's encoder, decode in every KV format, decode_32k layout and "
             "forward and whisper-smoke against the CPU, 'server' phi4-mini-3.8b's bf16 and "
             "bgpp offline runs then the asyncio front door over them, 'train' K5b's checks "
             "and the training path (smoke models against the CPU, phi4-mini-3.8b's full "
             "training steps, the launcher's resume), 'sharded' each mesh rank's K1 / K2 / "
             "K3 launches against their slice of the whole launch, then phi4-mini-3.8b "
             "served through a sharded Scheduler over NCCL against its unsharded runs, "
             "'sharded-train' each model rank's K5 / K5b launches against their slice of the "
             "whole launch, phi4-mini-3.8b's sharded 1x1 train step against the one-device "
             "step, the compressed grad sync and the train launcher's resume under "
             "torch.distributed.run, 'sharded-moe' each mesh rank's K1 / K2 / K3 and K5 / "
             "K5b launches (llama4-scout's and mixtral's heads too), llama4-scout and "
             "paligemma-3b served through a sharded Scheduler against their unsharded "
             "runs, and mixtral-8x22b's and paligemma-3b's sharded 1x1 train steps against "
             "the one-device step, 'sharded-ssm' each model rank's K1 / K2 and K5 / K5b "
             "launches at jamba's heads, mamba2-1.3b and jamba-1.5-large-398b decoding "
             "through make_serve_step on a 1x1 mesh against their unsharded runs, and their "
             "sharded 1x1 train steps against the one-device step, 'sharded-encdec' each model "
             "rank's K1 / K2 and K5 / K5b launches at whisper-medium's heads, its encoder and "
             "bf16 / bgpp paged decodes through make_serve_step on a 1x1 mesh against their "
             "unsharded runs, and its sharded 1x1 train step against the one-device step; "
             "without it "
             "every phase "
             "runs and the records are printed")
    only = parser.parse_args(argv).only

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
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s; each "
          f"source's nvcc ended at: " + ", ".join(
              f"{n} {s:.1f} s" for n, s in sorted(build.COMPILE_SECONDS.items(),
                                                  key=lambda kv: -kv[1])))

    device = torch.device("cuda")
    run = lambda phase: only is None or phase in only
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush = lambda: l2.zero_()

    records = []
    if run("kernels"):
        records += timed(kernel_phase, device, flush)
        records += timed(bstc_kernel_phase, device, flush)
    if run("kernels") or run("decode"):
        records.append(timed(decode_kernel_phase, device, flush))
    if run("kernels"):
        records += timed(flash_kernel_phase, device, flush)
    if run("kernels") or run("train"):
        records += timed(flash_bwd_phase, device, flush)
    if run("head-widths"):
        records += timed(head_width_phase, device, flush)
    if run("long-context"):
        records += timed(long_context_phase, device, flush)
    if run("prefix"):
        records.append(timed(flash_prefix_phase, device, flush))
    if run("kernels") or run("sharded") or run("sharded-moe"):
        records += timed(shard_kernel_phase, device, flush)
    if run("kernels") or run("sharded-train") or run("sharded-moe"):
        records += timed(shard_flash_phase, device, flush)
    if run("kernels") or run("sharded-ssm"):
        records += timed(shard_ssm_kernel_phase, device, flush)
    if run("kernels") or run("sharded-encdec"):
        records += timed(shard_encdec_kernel_phase, device, flush)
    if run("score"):
        records += timed(bgpp_kernel_phase, device, flush)
    if run("kernels"):
        timed(brcr_kernel_phase, device, flush)
    if only is not None:  # a partial run: device times of what it ran, no records
        if run("score") or run("score-device"):
            score_device_phase(device)
        if run("decode"):
            decode_device_phase(device)
        if run("decode-attends"):
            decode_attend_times(device)
        if run("long-serve"):
            timed(long_serve_phase, device, card)
        if run("ssm"):
            timed(ssm_phase, device, card)
        if run("hybrid"):
            timed(hybrid_phase, device, card)
        if run("whisper"):
            timed(whisper_phase, device, card)
            timed(whisper_reference, device)
        if run("server"):
            server_only_phase(device, card)
        if run("train"):
            timed(train_phase, device, card)
        if run("sharded"):
            timed(sharded_only_phase, device, card)
        if run("sharded-train"):
            timed(sharded_train_run, device, card)
            timed(sharded_train_launcher, card)
            multi_card_check(card)
        if run("sharded-moe"):
            timed(sharded_moe_only_phase, device, card)
        if run("sharded-ssm"):
            timed(sharded_ssm_only_phase, device, card)
        if run("sharded-encdec"):
            timed(sharded_encdec_only_phase, device, card)
        torch.cuda.synchronize()
        print(card)
        return 0
    paper_launches, k7 = timed(paper_phase, device, flush)
    records.append(k7)
    del l2

    launches = timed(serve_phase, device, card)
    multi_card_check(card)
    timed(zoo_serve_phase, device, card)
    # the sharded MoE and VLM Schedulers' launches count beside phi4-mini's
    for phase in (moe_serve_phase, vlm_serve_phase):
        for name, n in timed(phase, device, card).items():
            launches[name] = launches.get(name, 0) + n
    for phase in (long_serve_phase, ssm_phase):
        timed(phase, device, card)
    # K1 / K2 / K5 over jamba's and whisper's runs count beside phi4-mini's
    hybrid_launches, hybrid_records = timed(hybrid_phase, device, card)
    records += hybrid_records
    for counts in (hybrid_launches, timed(whisper_phase, device, card)):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    # K5 over the training steps counts beside the serving paths'; K5b runs there alone
    for phase in (train_phase, sharded_train_run, sharded_moe_train_run, sharded_ssm_train_run,
                  sharded_encdec_train_run):
        for name, n in timed(phase, device, card).items():
            launches[name] = launches.get(name, 0) + n
    timed(sharded_train_launcher, card)
    for phase in (trace_phase, flash_device_phase, bstc_device_phase, decode_device_phase,
                  bgpp_device_phase, score_device_phase, brcr_device_phase):
        timed(phase, device)
    launches.update(paper_launches)
    for r in records:
        r["launches"] = launches[r["name"]]
    timed(reference_phase, device)
    timed(paper_reference_phase, device)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
