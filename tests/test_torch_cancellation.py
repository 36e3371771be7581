"""Deterministic cancellation / preemption edge cases of the port's
Scheduler: the port's version of ``tests/test_cancellation.py``.

The random cancellation fuzz (tests/test_torch_serving_fuzz.py) sweeps the
state space; these tests pin the specific corners:

  * cancel during the admission steps that register prefix-index entries —
    the index must not retain a dangling entry for the freed pages;
  * cancel a DONOR whose prompt pages a survivor prefix-shares — refcounts
    decrement without zeroing the shared pages (proven bit-exactly: the
    survivor's remaining decode reads that KV);
  * a higher-tier arrival preempts an in-progress chunked prefill, which
    later RESUMES at the exact frozen token offset (proven bit-exactly
    against an uncontended run);
  * state-aware eviction: a PREFILLING cancel must not fabricate
    first-token/ITL bookkeeping, and a DECODING cancel must not land in
    the finished list;
  * SLO deadline shedding of queued requests.

CPU, phi4-mini-smoke from JAX-initialised parameters
(``interop.params_from_numpy``), paged bf16 KV, chunk budget 6.
"""

import json

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jax_config
from repro.models import model_zoo

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.request import Request, SlotState
from repro_torch.serving.scheduler import Scheduler

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

MAX_SEQ = 64
PAGE_SIZE = 8
CHUNK_BUDGET = 6


@pytest.fixture(scope="module")
def served():
    jparams, _ = model_zoo.init(jax.random.key(0), jax_config("phi4-mini-3.8b", smoke=True))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return get_config("phi4-mini-3.8b", smoke=True), params


def make_sched(cfg, params, slots=2, layout="paged", record_logits=False):
    lay = kvc.layout_for(cfg, slots, MAX_SEQ, kv_format="bf16",
                         layout=layout, page_size=PAGE_SIZE)
    return Scheduler(params, cfg, lay, device="cpu", admission="chunked",
                     chunk_budget=CHUNK_BUDGET, record_logits=record_logits)


def prompt_of(rng, cfg, n):
    return rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)


class TestCancelDuringPrefixRegistration:
    def test_no_dangling_index_entry(self, served):
        """Cancel mid-chunked-prefill AFTER page boundaries were indexed:
        the freed pages must prune their index entries, so an identical
        later prompt gets no (stale) prefix hit and still runs clean."""
        cfg, params = served
        rng = np.random.default_rng(0)
        sched = make_sched(cfg, params)
        prompt = prompt_of(rng, cfg, 18)
        sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
        sched.step()
        sched.step()  # prefill_pos = 12 -> page 0 (tokens 0..7) is indexed
        slot = sched.slots[0]
        assert slot.state is SlotState.PREFILLING and slot.prefill_pos == 12
        assert sched.pager.lookup_prefix(prompt)[0] == 8

        assert sched.cancel(0)
        sched.pager.check()
        assert sched.pager.pages_in_use == 0, "cancel leaked prefill pages"
        assert sched.pager.lookup_prefix(prompt) == (0, ()), (
            "prefix index retained a dangling entry for freed pages"
        )
        # an identical prompt admitted now must prefill from scratch
        sched.submit(Request(rid=1, prompt=prompt, max_new_tokens=2))
        sched.run(max_steps=100)
        assert len(sched.finished) == 1
        assert sched.prefix_hits == 0
        sched.pager.check()
        assert sched.pager.pages_in_use == 0

    def test_cancel_between_every_chunk_step(self, served):
        """Sweep the cancel point across every prefill chunk boundary —
        each point must drain the pool completely."""
        cfg, params = served
        rng = np.random.default_rng(1)
        prompt = prompt_of(rng, cfg, 20)
        for steps in range(1, 5):
            sched = make_sched(cfg, params)
            sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
            for _ in range(steps):
                sched.step()
            sched.cancel(0)
            sched.pager.check()
            assert sched.pager.pages_in_use == 0, f"leak at chunk {steps}"


class TestCancelSharedPrefixDonor:
    def test_survivor_keeps_shared_pages(self, served):
        """rid 0 prefills a 32-token system prompt and keeps decoding;
        rid 1 adopts those 4 pages via the prefix index; rid 0 is then
        cancelled.  The shared pages must drop to refcount 1 WITHOUT
        being zeroed — proven end-to-end: rid 1's remaining decode reads
        that KV and must stay bit-identical to an uncontended run."""
        cfg, params = served
        rng = np.random.default_rng(2)
        prefix = prompt_of(rng, cfg, 32)
        pa = np.concatenate([prefix, prompt_of(rng, cfg, 4)])
        pb = np.concatenate([prefix, prompt_of(rng, cfg, 3)])

        sched = make_sched(cfg, params, record_logits=True)
        sched.submit(Request(rid=0, prompt=pa, max_new_tokens=12))
        sched.submit(Request(rid=1, prompt=pb, max_new_tokens=6,
                             arrival_step=8))
        survivor = sched.queue[-1]
        for _ in range(100):
            sched.step()
            sched.pager.check()
            if survivor.prefix_reused_tokens:
                break
        assert survivor.prefix_reused_tokens == 32, "adoption never happened"
        shared = [int(p) for p in sched.pager.table[1, :4]]
        assert all(sched.pager.refcount[p] == 2 for p in shared)

        assert sched.cancel(0)
        sched.pager.check()
        assert all(sched.pager.refcount[p] == 1 for p in shared), (
            "donor cancel must decref shared pages, not free them"
        )
        assert all(int(sched.pager.table[1, i]) == p
                   for i, p in enumerate(shared)), "survivor lost its pages"
        while sched.num_pending:
            sched.step()
            sched.pager.check()
        assert [r.rid for r in sched.finished] == [1]
        assert sched.pager.pages_in_use == 0

        # uncontended reference: same request alone on the same layout
        alone = make_sched(cfg, params, record_logits=True)
        alone.submit(Request(rid=1, prompt=pb, max_new_tokens=6))
        alone.run(max_steps=100)
        want = alone.finished[0]
        got = sched.finished[0]
        assert got.generated == want.generated
        for t, (g, w) in enumerate(zip(got.logit_rows, want.logit_rows)):
            assert np.array_equal(g, w), (
                f"token {t}: shared pages were perturbed by the donor cancel"
            )


class TestPreemptThenResume:
    def test_batch_prefill_resumes_at_frozen_offset(self, served):
        """A batch-tier 20-token prompt starts chunking; an interactive
        arrival steals the chunk budget (preemption) and the batch
        prefill's offset freezes; once the interactive prompt finishes
        prefilling, the batch one resumes AT THAT OFFSET — proven by
        bit-exact logits vs an uncontended run of the same request."""
        cfg, params = served
        rng = np.random.default_rng(3)
        long_prompt = prompt_of(rng, cfg, 20)
        sched = make_sched(cfg, params, record_logits=True)
        batch_req = Request(rid=0, prompt=long_prompt, max_new_tokens=4,
                            priority="batch")
        inter_req = Request(rid=1, prompt=prompt_of(rng, cfg, 8),
                            max_new_tokens=3, priority="interactive",
                            arrival_step=1)
        sched.submit(batch_req)
        sched.submit(inter_req)

        sched.step()  # batch slot advances to 6
        assert sched.slots[0].prefill_pos == 6
        frozen = []
        while inter_req.first_token_step < 0:
            sched.step()
            if sched.slots[1].state is SlotState.PREFILLING:
                frozen.append(sched.slots[0].prefill_pos)
        # every step the interactive prompt chunked, the batch offset froze
        assert frozen and all(p == 6 for p in frozen)
        assert sched.preemptions >= 1
        assert batch_req.preemptions >= 1
        sched.run(max_steps=200)
        assert len(sched.finished) == 2
        assert inter_req.first_token_step < batch_req.first_token_step

        alone = make_sched(cfg, params, record_logits=True)
        alone.submit(Request(rid=0, prompt=long_prompt, max_new_tokens=4,
                             priority="batch"))
        alone.run(max_steps=100)
        want = alone.finished[0]
        assert batch_req.generated == want.generated
        for t, (g, w) in enumerate(zip(batch_req.logit_rows,
                                       want.logit_rows)):
            assert np.array_equal(g, w), (
                f"token {t}: preempted prefill resumed at a wrong offset"
            )
        # per-tier columns carry the preemption + both tiers' latencies
        tiers = sched.stats()["tiers"]
        assert tiers["batch"]["preemptions"] >= 1
        assert tiers["interactive"]["ttft_s"]["p50"] is not None

    def test_priority_jumps_admission_queue(self, served):
        """With one slot busy, a later interactive arrival must be
        admitted before earlier-queued batch requests."""
        cfg, params = served
        rng = np.random.default_rng(4)
        sched = make_sched(cfg, params, slots=1)
        sched.submit(Request(rid=0, prompt=prompt_of(rng, cfg, 6),
                             max_new_tokens=8, priority="batch"))
        sched.submit(Request(rid=1, prompt=prompt_of(rng, cfg, 6),
                             max_new_tokens=2, priority="batch",
                             arrival_step=1))
        sched.submit(Request(rid=2, prompt=prompt_of(rng, cfg, 6),
                             max_new_tokens=2, priority="interactive",
                             arrival_step=2))
        sched.run(max_steps=200)
        by_rid = {r.rid: r for r in sched.finished}
        assert by_rid[2].admitted_step < by_rid[1].admitted_step


class TestStateAwareEviction:
    def test_prefilling_cancel_records_no_latency(self, served):
        """Evicting a PREFILLING slot must not run
        the DONE path's bookkeeping — no first-token timestamp, no ITL
        rows, no finished entry — while still freeing its pages."""
        cfg, params = served
        rng = np.random.default_rng(5)
        sched = make_sched(cfg, params)
        req = Request(rid=0, prompt=prompt_of(rng, cfg, 18),
                      max_new_tokens=4)
        sched.submit(req)
        sched.step()
        assert sched.slots[0].state is SlotState.PREFILLING
        assert sched.cancel(0)
        assert req.cancelled and req.cancel_state == "prefilling"
        assert req.first_token_step == -1 and req.first_token_time < 0
        assert req.token_times == [] and req.finished_step == -1
        assert sched.finished == [] and sched.cancelled == [req]
        assert sched.pager.pages_in_use == 0
        stats = sched.stats()
        assert stats["requests"] == []  # no fabricated latency rows
        assert stats["cancelled_requests"] == 1
        assert stats["cancelled"][0]["cancel_state"] == "prefilling"
        assert stats["ttft_s"]["p50"] is None
        json.dumps(stats)

    def test_decoding_cancel_keeps_partial_tokens_out_of_finished(
            self, served):
        cfg, params = served
        rng = np.random.default_rng(6)
        sched = make_sched(cfg, params)
        req = Request(rid=0, prompt=prompt_of(rng, cfg, 6),
                      max_new_tokens=32)
        sched.submit(req)
        while len(req.generated) < 2:
            sched.step()
        assert sched.cancel(0)
        assert req.cancel_state == "decoding"
        assert len(req.generated) >= 2  # streamed tokens stay with the req
        assert req.finished_step == -1 and sched.finished == []
        assert sched.pager.pages_in_use == 0
        rec = sched.stats()["cancelled"][0]
        assert rec["tokens_before_cancel"] == len(req.generated)

    def test_cancel_unknown_or_finished_is_false(self, served):
        cfg, params = served
        rng = np.random.default_rng(7)
        sched = make_sched(cfg, params)
        req = Request(rid=0, prompt=prompt_of(rng, cfg, 6),
                      max_new_tokens=2)
        sched.submit(req)
        sched.run(max_steps=100)
        assert len(sched.finished) == 1
        assert not sched.cancel(0)  # already finished
        assert not sched.cancel(99)  # never existed
        assert not sched.cancelled

    def test_slot_reusable_after_prefilling_cancel(self, served):
        """The evicted row must admit the next request cleanly (the
        logical-evict + reset-at-admission contract holds for cancels)."""
        cfg, params = served
        rng = np.random.default_rng(8)
        sched = make_sched(cfg, params, slots=1)
        sched.submit(Request(rid=0, prompt=prompt_of(rng, cfg, 18),
                             max_new_tokens=4))
        sched.step()
        sched.cancel(0)
        sched.submit(Request(rid=1, prompt=prompt_of(rng, cfg, 9),
                             max_new_tokens=3))
        sched.run(max_steps=100)
        assert [r.rid for r in sched.finished] == [1]
        assert len(sched.finished[0].generated) == 3


class TestDeadlineShedding:
    def test_queued_past_deadline_is_shed(self, served):
        """SLO-aware admission: a queued request whose deadline lapses is
        shed (never admitted), while the slotless wait of one WITHIN its
        deadline still ends in admission."""
        cfg, params = served
        rng = np.random.default_rng(9)
        sched = make_sched(cfg, params, slots=1)
        sched.submit(Request(rid=0, prompt=prompt_of(rng, cfg, 6),
                             max_new_tokens=12))
        sched.submit(Request(rid=1, prompt=prompt_of(rng, cfg, 6),
                             max_new_tokens=2, deadline_steps=3))
        sched.submit(Request(rid=2, prompt=prompt_of(rng, cfg, 6),
                             max_new_tokens=2, deadline_steps=200))
        stats = sched.run(max_steps=300)
        assert [r.rid for r in sorted(sched.finished,
                                      key=lambda r: r.rid)] == [0, 2]
        (shed,) = sched.cancelled
        assert shed.rid == 1 and shed.shed
        assert shed.cancel_state == "queued" and shed.admitted_step == -1
        assert stats["shed_requests"] == 1
        assert stats["tiers"]["interactive"]["shed"] == 1
        assert sched.pager.pages_in_use == 0
