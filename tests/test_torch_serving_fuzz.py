"""Randomized admission-trace oracle for the port's continuous-batching
scheduler: the port's version of ``tests/test_serving_fuzz.py``.

N requests with random prompt lengths, arrival steps and decode budgets
are driven through chunked admission (fixed-shape prefill chunks
interleaved with batched decode), then each request is re-run ALONE through
a slot-layout scheduler and compared token for token, logit row for row:

  * bf16   — greedy decode, generated tokens AND per-token logits must be
             bit-identical (slot isolation + chunk determinism; the CPU
             products do not move with the row count);
  * int8 / bgpp — teacher-forced continuations (so quantized near-tie
             argmax flips can't compound), per-token logits within 1e-5.

The joint run is parametrized over ``layout`` in {slot, paged}: the paged
joint trace (pooled KV pages, page-table translation, prefix reuse) is
checked against *slot-layout* alone runs.  After every step ``_run`` checks
``PageAllocator.check()`` and the ``kv_read`` / ``weight_read`` accounting
laws (bytes = steps x the static price a step).

The cancellation axis (``TestCancellationFuzz``) injects random mid-flight
cancels and disconnects into the joint run: the pool must drain to zero
pages, and every SURVIVING request must still match its alone run to the
same bars.  The MoE axis (``TestMoEFuzzOracle``, which the reference does
not have) runs mixtral-smoke and llama4-scout-smoke the same way in bf16.
``TestCancellationAgainstJax`` drives one fuzzed trace with a cancel plan
through the JAX package's Scheduler and the port's: the same requests are
cancelled, greedy tokens are equal (bf16) and logits lie within 1e-4.

Every run here is the port on the CPU, from JAX-initialised smoke
parameters (``interop.params_from_numpy``).  The seed comes from the
``rng_seed`` fixture (stable per test node id) and can be pinned via
``REPRO_FUZZ_SEED``; on failure each oracle writes its trace as JSON to
``REPRO_FUZZ_TRACE_DIR`` when that is set.
"""

import contextlib
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

import jax

from repro.configs import MCBPOptions as JMCBP
from repro.configs import get_config as jax_config
from repro.models import model_zoo as jzoo
from repro.serving import kv_cache as jkvc
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.configs import MCBPOptions, apply_weight_format_override, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Scheduler

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCHS = {"dense": "phi4-mini-3.8b", "swa": "gemma3-4b",
         "mixtral": "mixtral-8x22b", "llama4": "llama4-scout-17b-a16e"}
MAX_SEQ = 48
SLOTS = 2
PAGE_SIZE = 8
CHUNK_BUDGET = 6  # buckets (4, 6): lengths 3..20 hit off-bucket/exact/multi

_MODELS = {}


def _model(key):
    """(jax cfg, port cfg, jax params, port params) of ``ARCHS[key]``'s
    smoke config with keep-all BGPP: the progressive gather runs but
    selects every key, so the oracle isn't confounded by forced sparsity
    on near-uniform random-init attention."""
    if key not in _MODELS:
        keep_all = dict(bgpp_rounds=4, bgpp_keep_ratio=1.0)
        jcfg = dataclasses.replace(jax_config(ARCHS[key], smoke=True), mcbp=JMCBP(**keep_all))
        cfg = dataclasses.replace(get_config(ARCHS[key], smoke=True),
                                  mcbp=MCBPOptions(**keep_all))
        jparams, _ = jzoo.init(jax.random.key(0), jcfg)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        _MODELS[key] = (jcfg, cfg, jparams, params)
    return _MODELS[key]


def _layout_for(cfg, kv_format, layout, slots=SLOTS):
    return kvc.layout_for(cfg, slots, MAX_SEQ, kv_format=kv_format, layout=layout,
                          page_size=PAGE_SIZE)


def _random_requests(rng, cfg, n, teacher_forced):
    reqs = []
    for rid in range(n):
        max_new = int(rng.integers(2, 6))
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, (int(rng.integers(3, 21)),)).astype(np.int32),
            max_new_tokens=max_new,
            arrival_step=int(rng.integers(0, 9)),
            forced_tokens=rng.integers(0, cfg.vocab_size, (max_new,)).astype(np.int32)
            if teacher_forced else None,
        ))
    return reqs


def _clone(req, arrival_step, cls=Request):
    return cls(rid=req.rid, prompt=req.prompt, max_new_tokens=req.max_new_tokens,
               arrival_step=arrival_step, forced_tokens=req.forced_tokens,
               priority=req.priority)


@contextlib.contextmanager
def _dump_failing_trace(meta, reqs):
    """On oracle failure, write a replayable JSON trace (prompts, budgets,
    arrivals, seed) to ``REPRO_FUZZ_TRACE_DIR`` when it is set."""
    try:
        yield
    except AssertionError:
        out_dir = os.environ.get("REPRO_FUZZ_TRACE_DIR")
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            trace = dict(meta)
            trace["requests"] = [{
                "rid": r.rid,
                "prompt": np.asarray(r.prompt).tolist(),
                "max_new_tokens": r.max_new_tokens,
                "arrival_step": r.arrival_step,
                "forced_tokens": None if r.forced_tokens is None
                else np.asarray(r.forced_tokens).tolist(),
            } for r in reqs]
            name = "-".join(str(v) for v in meta.values()) + ".json"
            with open(os.path.join(out_dir, name), "w") as f:
                json.dump(trace, f, indent=2)
        raise


def _check_step(sched, cfg, layout):
    """The per-step gates: the page pool's invariants, and the byte
    counters accounting exactly for the executed decode steps."""
    if sched.pager is not None:
        sched.pager.check()
    stats = sched.stats()
    kv, wr = stats["kv_read"], stats["weight_read"]
    assert kv["decode_bytes"] == kv["decode_steps"] * kv["decode_bytes_per_step"]
    assert wr["decode_bytes"] == wr["decode_steps"] * wr["decode_bytes_per_step"]
    if layout.kv_format == "bgpp":
        assert kv["bgpp"]["full_rows_per_slot"] <= math.ceil(
            cfg.mcbp.bgpp_keep_ratio * layout.max_seq
        ), "bgpp decode may not fetch more full rows than the keep ratio"


def _run(cfg, params, layout, reqs, admission="chunked"):
    sched = Scheduler(params, cfg, layout, device="cpu", admission=admission,
                      chunk_budget=CHUNK_BUDGET, record_logits=True)
    for r in reqs:
        sched.submit(r)
    for _ in range(2000):
        if not sched.num_pending:
            break
        sched.step()
        _check_step(sched, cfg, layout)
    assert len(sched.finished) == len(reqs), "trace did not drain"
    if admission == "chunked":
        assert max(sched.prefill_tokens_per_step, default=0) <= CHUNK_BUDGET, (
            "chunk budget violated between decode steps")
    if sched.pager is not None:
        assert sched.pager.pages_in_use == 0, "the trace leaked pages"
    return sched, {r.rid: r for r in sched.finished}


def _compare_to_alone_runs(cfg, params, reqs, joint, arch_key, kv_format, layout,
                           slots=SLOTS, admission="chunked"):
    """Re-run each request alone on the SLOT layout and compare: the slot
    path is the oracle for both layouts.  ``slots`` matches the joint
    run's batch and ``admission`` its admission mode (eager and chunked
    prefills give their first-token logits through different float
    paths, so each admission mode oracles against itself)."""
    exact = kv_format == "bf16"
    slot_layout = _layout_for(cfg, kv_format, "slot", slots=slots)
    for r in reqs:
        _, alone = _run(cfg, params, slot_layout, [_clone(r, 0)], admission=admission)
        got, want = joint[r.rid], alone[r.rid]
        assert len(got.generated) == len(want.generated)
        assert len(got.logit_rows) == len(want.logit_rows)
        for t, (g, w) in enumerate(zip(got.logit_rows, want.logit_rows)):
            if exact:
                assert np.array_equal(g, w), (
                    f"{arch_key}/{kv_format}/{layout} rid {r.rid} token {t}: staggered "
                    f"logits not bit-identical to the slot-layout alone run "
                    f"(max |d| {np.max(np.abs(g - w))})")
            else:
                err = float(np.max(np.abs(g - w)))
                assert err <= 1e-5, f"{arch_key}/{kv_format}/{layout} rid {r.rid} token {t}: {err}"
        if exact:
            assert got.generated == want.generated, (
                f"{arch_key}/{kv_format}/{layout} rid {r.rid}: greedy tokens diverge")


def _fuzz_oracle(arch_key, kv_format, seed, n_requests, layout="slot", admission="chunked",
                 weight_format=None):
    seed = int(os.environ.get("REPRO_FUZZ_SEED", seed))
    rng = np.random.default_rng(seed)
    _, cfg, _, params = _model(arch_key)
    if weight_format is not None:
        cfg = apply_weight_format_override(cfg, weight_format)
    reqs = _random_requests(rng, cfg, n_requests, teacher_forced=kv_format != "bf16")
    meta = {"oracle": "fuzz", "arch": arch_key, "kv_format": kv_format, "layout": layout,
            "admission": admission, "seed": seed}
    if weight_format is not None:
        meta["weight_format"] = weight_format
    with _dump_failing_trace(meta, reqs):
        _, joint = _run(cfg, params, _layout_for(cfg, kv_format, layout),
                        [_clone(r, r.arrival_step) for r in reqs], admission=admission)
        _compare_to_alone_runs(cfg, params, reqs, joint, arch_key, kv_format, layout,
                               admission=admission)


def _shared_prefix_oracle(kv_format, seed):
    """Deterministic arrival overlap on THREE slots: request 0 prefills a
    32-token system prompt (4 pages) and keeps decoding; requests 1/2
    arrive the SAME step while it is resident, so both are assigned slots
    together and one queues behind the other with its adoption pending —
    the regression shape for the batched decode's garbage writes (a
    waiting slot must hold no shared pages, or the donor's prompt KV gets
    corrupted at its device pos).  Both must adopt the pages AND still
    match the slot-layout alone runs exactly."""
    seed = int(os.environ.get("REPRO_FUZZ_SEED", seed))
    rng = np.random.default_rng(seed)
    _, cfg, _, params = _model("dense")
    teacher = kv_format != "bf16"
    prefix = rng.integers(0, cfg.vocab_size, (32,)).astype(np.int32)

    def req(rid, tail_len, max_new, arrival):
        return Request(
            rid=rid,
            prompt=np.concatenate([prefix, rng.integers(0, cfg.vocab_size, (tail_len,))
                                   .astype(np.int32)]),
            max_new_tokens=max_new,
            arrival_step=arrival,
            forced_tokens=rng.integers(0, cfg.vocab_size, (max_new,)).astype(np.int32)
            if teacher else None,
        )

    # rid 0: resident past step 8 (prefill ~6 steps + 10 decode steps);
    # rid 1/2 arrive together at step 8 with its 4 prompt pages registered
    reqs = [req(0, 4, 10, 0), req(1, 5, 4, 8), req(2, 3, 3, 8)]
    meta = {"oracle": "shared-prefix", "arch": "dense", "kv_format": kv_format,
            "layout": "paged", "seed": seed}
    with _dump_failing_trace(meta, reqs):
        joint_sched, joint = _run(cfg, params, _layout_for(cfg, kv_format, "paged", slots=3),
                                  [_clone(r, r.arrival_step) for r in reqs])
        assert joint_sched.prefix_hit_tokens >= 64, (
            f"both late requests must adopt the 32-token prefix: "
            f"{joint_sched.prefix_hit_tokens} tokens adopted")
        _compare_to_alone_runs(cfg, params, reqs, joint, "dense", kv_format, "paged", slots=3)


@pytest.mark.parametrize("layout", ["slot", "paged"])
class TestFuzzOracle:
    def test_dense_bf16(self, rng_seed, layout):
        _fuzz_oracle("dense", "bf16", rng_seed, 4, layout=layout)

    def test_dense_int8(self, rng_seed, layout):
        _fuzz_oracle("dense", "int8", rng_seed, 4, layout=layout)

    def test_dense_bgpp(self, rng_seed, layout):
        _fuzz_oracle("dense", "bgpp", rng_seed, 4, layout=layout)

    def test_dense_bgpp_eager(self, rng_seed, layout):
        # eager whole-prompt admission over the two-phase paged decode:
        # phase-1 selection sees KV written by the B=1 prefill path, and
        # the logits must still match slot-layout EAGER alone runs
        _fuzz_oracle("dense", "bgpp", rng_seed, 3, layout=layout, admission="eager")

    def test_swa_bf16(self, rng_seed, layout):
        # gemma3 mixes ring + global stacks: paged pools behind the rings
        # (prefix reuse stays off — rings can't skip prefill)
        _fuzz_oracle("swa", "bf16", rng_seed, 4, layout=layout)


@pytest.mark.parametrize("weight_format", ["int8", "bstc"])
class TestWeightFormatOracle:
    """weight_format axis: the quantized serve-time weight path must be
    scheduling-invariant.  Joint staggered runs and alone runs derive
    IDENTICAL records from the same raw params, so with bf16 KV every
    logit row is bit-exact between them."""

    def test_dense_slot(self, rng_seed, weight_format):
        _fuzz_oracle("dense", "bf16", rng_seed, 4, weight_format=weight_format)

    def test_dense_paged(self, rng_seed, weight_format):
        _fuzz_oracle("dense", "bf16", rng_seed, 4, layout="paged",
                     weight_format=weight_format)


@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("arch_key", ["mixtral", "llama4"])
class TestMoEFuzzOracle:
    """The MoE axis: mixtral-smoke (every layer a sliding-window ring, so
    its paged layout has no pool) and llama4-scout-smoke (chunked-local
    rings beside global layers, a shared expert), bf16, joint = alone bit
    for bit: decode and chunks route dropless, a token at a time."""

    def test_moe_bf16(self, rng_seed, arch_key, layout):
        _fuzz_oracle(arch_key, "bf16", rng_seed, 4, layout=layout)


# --------------------------------------------------------------------------
# cancellation axis: random disconnects must leak nothing and perturb nobody
# --------------------------------------------------------------------------


def _cancel_plan(rng, reqs):
    """Random cancel/disconnect plan over roughly half the trace.  Token
    triggers model a client hanging up after k streamed tokens (guaranteed
    to fire while the request is still DECODING when ``k <
    max_new_tokens``); step triggers land at arbitrary scheduler steps,
    catching requests queued, mid-chunked-prefill, decoding — or already
    gone (cancel() idempotence).  The first victim is always a token
    trigger so every plan produces at least one live cancel."""
    plan = {}
    victims = list(rng.permutation(len(reqs))[:max(1, len(reqs) // 2)])
    sure = max(range(len(reqs)), key=lambda i: reqs[i].max_new_tokens)
    if sure not in victims:
        victims[0] = sure
    for idx in victims:
        r = reqs[idx]
        if idx == sure or rng.random() < 0.5:
            # v <= max_new - 2: the prefill-completion step can bank TWO
            # tokens at once (first token + same-step decode), so two
            # tokens of headroom guarantee the cancel lands while live
            plan[r.rid] = ("tokens", int(rng.integers(1, r.max_new_tokens - 1)))
        else:
            plan[r.rid] = ("step", int(rng.integers(1, 30)))
    return plan


def _drive_with_cancels(sched, reqs, plan):
    """Step ``sched`` (either package's Scheduler) over ``reqs`` with the
    plan's cancels injected between steps; ``PageAllocator.check()`` after
    EVERY step is the leak gate.  Returns the rids ``cancel`` evicted."""
    by_rid = {r.rid: r for r in reqs}
    for r in reqs:
        sched.submit(r)
    pending = dict(plan)
    cancelled = []
    for _ in range(2000):
        if not sched.num_pending:
            break
        sched.step()
        for rid, (kind, v) in list(pending.items()):
            r = by_rid[rid]
            if ((kind == "tokens" and len(r.generated) >= v)
                    or (kind == "step" and sched.step_count >= v)):
                if sched.cancel(rid):  # False when already finished: idempotent
                    cancelled.append(rid)
                del pending[rid]
        if sched.pager is not None:
            sched.pager.check()
    assert not sched.num_pending, "trace did not drain"
    assert len(sched.finished) + len(sched.cancelled) == len(reqs)
    assert max(sched.prefill_tokens_per_step, default=0) <= CHUNK_BUDGET
    if sched.pager is not None:
        sched.pager.check()
        assert sched.pager.pages_in_use == 0, "cancellation leaked pages"
    return cancelled


def _run_with_cancels(cfg, params, layout, reqs, plan):
    """Joint chunked run of the port with mid-flight cancels injected."""
    sched = Scheduler(params, cfg, layout, device="cpu", admission="chunked",
                      chunk_budget=CHUNK_BUDGET, record_logits=True)
    _drive_with_cancels(sched, reqs, plan)
    return sched, {r.rid: r for r in sched.finished}


def _cancel_trace(rng, cfg, n_requests, kv_format):
    """The cancellation fuzz's trace: random requests with at least 3
    decode tokens each, random tiers, and a cancel plan."""
    reqs = _random_requests(rng, cfg, n_requests, teacher_forced=kv_format != "bf16")
    for r in reqs:
        # the token-trigger guarantee in _cancel_plan needs >= 3 decode
        # tokens of budget; pad the teacher-forced tail to match
        if r.max_new_tokens < 3:
            extra = 3 - r.max_new_tokens
            r.max_new_tokens = 3
            if r.forced_tokens is not None:
                r.forced_tokens = np.concatenate([
                    r.forced_tokens,
                    rng.integers(0, cfg.vocab_size, (extra,)).astype(np.int32)])
    clones = [_clone(r, r.arrival_step) for r in reqs]
    for c in clones:  # stir priority scheduling into the fuzzed order too
        c.priority = "interactive" if rng.random() < 0.5 else "batch"
    return reqs, clones, _cancel_plan(rng, clones)


def _cancel_fuzz_oracle(arch_key, kv_format, seed, n_requests, layout):
    seed = int(os.environ.get("REPRO_FUZZ_SEED", seed))
    rng = np.random.default_rng(seed)
    _, cfg, _, params = _model(arch_key)
    reqs, clones, plan = _cancel_trace(rng, cfg, n_requests, kv_format)
    meta = {"oracle": "cancel-fuzz", "arch": arch_key, "kv_format": kv_format,
            "layout": layout, "seed": seed,
            "plan": ",".join(f"{r}@{k}{v}" for r, (k, v) in plan.items())}
    with _dump_failing_trace(meta, reqs):
        sched, joint = _run_with_cancels(cfg, params, _layout_for(cfg, kv_format, layout),
                                         clones, plan)
        assert len(sched.cancelled) >= 1, "plan produced no live cancel"
        survivors = [r for r in reqs if r.rid in joint]
        assert survivors, "every request was cancelled; nothing to oracle"
        _compare_to_alone_runs(cfg, params, survivors, joint, arch_key, kv_format, layout)


@pytest.mark.parametrize("layout", ["slot", "paged"])
class TestCancellationFuzz:
    """Front-door cancellation axis of the fuzz matrix: random cancels and
    disconnects at arbitrary lifecycle points must leak zero pages and
    leave every surviving request's logits exactly what an alone run
    produces (bit-exact bf16 / 1e-5 teacher-forced elsewhere)."""

    def test_dense_bf16_cancel(self, rng_seed, layout):
        _cancel_fuzz_oracle("dense", "bf16", rng_seed, 5, layout)

    def test_dense_int8_cancel(self, rng_seed, layout):
        _cancel_fuzz_oracle("dense", "int8", rng_seed, 4, layout)


class TestSharedPrefixReuse:
    def test_prefix_reuse_paged_bf16(self, rng_seed):
        _shared_prefix_oracle("bf16", rng_seed)


@pytest.mark.parametrize("kv_format,layout", [("bf16", "paged"), ("int8", "slot")])
def test_cancellation_trace_matches_jax(rng_seed, kv_format, layout):
    """One fuzzed trace with a cancel plan through the JAX package's
    Scheduler and the port's: the same requests cancelled at the same
    states and steps, the same finished set, greedy tokens equal (bf16;
    int8 is teacher-forced) and logits within 1e-4; both pools drain."""
    rng = np.random.default_rng(rng_seed)
    jcfg, cfg, jparams, params = _model("dense")
    _, clones, plan = _cancel_trace(rng, cfg, 5, kv_format)
    jlay = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format=kv_format, layout=layout,
                           page_size=PAGE_SIZE)
    jsched = JScheduler(jparams, jcfg, jlay, admission="chunked", chunk_budget=CHUNK_BUDGET,
                        record_logits=True)
    jcancel = _drive_with_cancels(jsched, [_clone(c, c.arrival_step, JRequest)
                                           for c in clones], plan)
    tsched = Scheduler(params, cfg, _layout_for(cfg, kv_format, layout), device="cpu",
                       admission="chunked", chunk_budget=CHUNK_BUDGET, record_logits=True)
    tcancel = _drive_with_cancels(tsched, [_clone(c, c.arrival_step) for c in clones], plan)
    assert tcancel == jcancel and tcancel, (tcancel, jcancel)
    assert ([r.cancel_record() for r in tsched.cancelled]
            == [r.cancel_record() for r in jsched.cancelled])
    jdone = {r.rid: r for r in jsched.finished}
    tdone = {r.rid: r for r in tsched.finished}
    assert sorted(tdone) == sorted(jdone) and tdone
    for rid, j in jdone.items():
        t = tdone[rid]
        assert t.generated == j.generated, rid
        assert (t.admitted_step, t.first_token_step, t.finished_step) == (
            j.admitted_step, j.first_token_step, j.finished_step), rid
        err = float(np.abs(np.stack(t.logit_rows) - np.stack(j.logit_rows)).max())
        assert err <= 1e-4, (rid, err)
    tstats, jstats = tsched.stats(), jsched.stats()
    for key in ("steps", "finished_requests", "cancelled_requests", "preemptions",
                "decoded_tokens"):
        assert tstats[key] == jstats[key], key
    for key in ("decode_bytes", "prefill_bytes", "decode_steps"):
        assert tstats["kv_read"][key] == jstats["kv_read"][key], key
