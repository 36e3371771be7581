"""Continuous-batching request scheduler over one live per-slot KV cache.

Counterpart of :mod:`repro.serving.scheduler` (chunked and eager
admission, greedy or forced tokens, slot and paged layouts, paged prefix
reuse, eviction, cancellation, priority tiers, deadline shedding,
``stats()``).

Each step it (1) admits prompts, (2) runs ONE batched ``serve_step`` for
every DECODING slot, and (3) evicts finished slots.  With the default
``admission="chunked"`` step (1) spends at most ``chunk_budget`` prompt
tokens advancing ONE admitting request through the bucketed
:class:`~repro_torch.serving.engine.ChunkedPrefill`; ``admission="eager"``
fills every EMPTY slot with one whole-prompt B=1 forward each
(:func:`~repro_torch.serving.engine.prefill_into_slot`, whose attention
runs the ``flash_attention`` kernel on the card) before the decode step,
which stalls until they finish: the reference's baseline.

It serves the dense, MoE and VLM families.  A VLM is served text only,
through chunked admission, as the reference's Scheduler serves it: the
port's Scheduler takes no ``prefill_kw``, so an eager admission of a VLM
has no image prefix to give ``prefill_into_slot`` and its forward raises
the ``ValueError`` that names it (where the reference's forward asserts).
Paged layouts with a global layer
keep a host-side
:class:`~repro_torch.serving.paging.PageAllocator` (a stack of local rings
only, as mixtral's, has no pool and no allocator): pages are
mapped just ahead of every write, the device page table is refreshed when
the host copy changes, and eviction zeroes (on device) only pages whose
refcount hit zero.  With chunked admission a slot's prompt is matched
against the prefix index at its first advance; a hit adopts the resident
pages and skips those tokens (eager admission does not reuse prefixes, as
in the reference).

The device work is enqueued without host syncs; each decode step syncs
once, to bring its logits to the host for sampling (as the reference's
``np.asarray(logits)``), and a step that finishes a prompt syncs once more
for the first token's logits.

The serve-time weight format (``weight_format``: bf16, int8 or bstc; the
config's unless the argument names one) is resolved once: decode steps
read ``serve_params`` (int8 records, or BSTC-coded operands that the
``bstc_matmul`` kernel reads on the card), prefill (chunked or eager)
the raw ``params``; ``stats()["weight_read"]`` prices the bytes as the
reference.

Speculative decoding (``spec_decode=True`` or the config's
``mcbp.spec_decode``; :mod:`repro_torch.serving.spec_decode`) replaces each
batched decode step with one draft -> verify -> accept/rollback round
(:meth:`Scheduler._spec_round`): ``draft_gamma`` truncated-bit-plane serve
steps propose draft tokens for every DECODING slot, up to ``gamma + 1``
full-precision serve steps verify them through the ordinary
``_pick_token`` (so the output is identical to non-speculative decode), and
every slot rolls back to its accepted frontier: ``pos`` rewound, pages past
it released (``PageAllocator.rewind_slot``) and the speculative rows zeroed
in every store leaf.  ``stats()["spec"]`` reports the acceptance and the
KV and weight bytes per accepted token.

``rules`` (the reference's :class:`ShardingRules`) with a mesh serves the
dense, MoE and VLM families as explicit SPMD
(:mod:`repro_torch.serving.sharded`; the experts replicated, routing
dropless on the rank's own slots): every
rank runs the same Scheduler on the same requests from the same whole
params, keeps its shard of the params and cache, and gets every step's
logits gathered from every rank, so the host state (slots, pages,
samples) stays identical on all of them; rank 0 reports.  The page table
stays host-owned and replicated.  ``stats()`` adds the reference's mesh
columns.  The ssm, hybrid and enc_dec families raise here as they do on
one device (they decode through ``engine.make_serve_step``, which takes a
mesh), as the reference's serve launcher takes only the transformer
families.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import apply_weight_format_override, require_transformer
from repro_torch.models import model_zoo
from repro_torch.serving import engine, kv_cache as kvc, sharded as shd, spec_decode as spd
from repro_torch.serving import weights as swt
from repro_torch.serving.paging import PageAllocator
from repro_torch.serving.request import Request, Slot, SlotState, priority_rank


def greedy_sample(logits: np.ndarray) -> np.ndarray:
    """(B, V) logits -> (B,) int32 argmax tokens."""
    return np.argmax(logits, axis=-1).astype(np.int32)


def _percentiles(samples) -> Dict[str, Optional[float]]:
    a = np.asarray(list(samples), np.float64)
    if a.size == 0:
        return {"p50": None, "p95": None}
    return {"p50": round(float(np.percentile(a, 50)), 6),
            "p95": round(float(np.percentile(a, 95)), 6)}


def _host_rows(logits: torch.Tensor) -> np.ndarray:
    """Device logits -> float32 numpy (the step's one host sync)."""
    return logits.float().cpu().numpy()


class Scheduler:
    """Slot-level continuous batching on top of the port's serving engine."""

    def __init__(
        self,
        params,
        cfg,
        layout: kvc.CacheLayout,
        device="cuda",
        sample_fn: Callable[[np.ndarray], np.ndarray] = greedy_sample,
        admission: str = "chunked",
        chunk_budget: int = 16,
        buckets=None,
        record_logits: bool = False,
        weight_format: Optional[str] = None,
        spec_decode: Optional[bool] = None,
        draft_gamma: Optional[int] = None,
        draft_planes: Optional[int] = None,
        draft_fn: Optional[Callable[[Request, int], int]] = None,
        rules=None,
    ):
        from repro_torch import resolve_device

        require_transformer(cfg, "Scheduler")
        if admission not in ("chunked", "eager"):
            raise ValueError(f"Scheduler: admission {admission!r} is not chunked or eager")
        self.rules = rules
        self.mesh_shape = shd.mesh_shape(rules)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"Scheduler: params live on {params['embed'].device}, the "
                f"scheduler on {self.device}")
        cfg = apply_weight_format_override(cfg, weight_format)
        # mesh placement: this rank's shard of the params (identity off-mesh)
        self.shard = shd.Shard.of(cfg, layout, rules)
        local = params
        if self.shard is not None:
            local = shd.shard_params(params, model_zoo.param_specs(cfg), rules, cfg)
        self.params = local
        self.cfg = cfg
        self.layout = layout
        self.sample_fn = sample_fn
        self.admission = admission
        self.chunk_budget = int(chunk_budget)
        self.record_logits = record_logits

        # serve-time weights, converted once from the rank's shard and priced
        # whole: decode steps read ``serve_params``; prefill keeps the raw
        # ``params`` (with bf16, serve_params IS params)
        self.weight_format = swt.resolve(cfg)
        self.serve_params, self.weight_plan = swt.prepare_serve_params(
            params, cfg, self.weight_format, local=local)
        self.cache = kvc.init_cache_arrays(cfg, layout, self.device)
        if self.shard is not None:
            self.cache = shd.shard_cache(self.cache, cfg, layout, rules)
        self.pager: Optional[PageAllocator] = None
        if layout.layout == "paged" and layout.global_layers:
            self.pager = PageAllocator(layout)
            self._page_bytes = kvc.page_bytes(self.cache["global"], layout.page_size)
        self.slots: List[Slot] = [Slot(i) for i in range(layout.batch)]
        self.queue: Deque[Request] = collections.deque()
        self.serve_step = engine.make_serve_step(cfg, layout, rules)
        self.chunked: Optional[engine.ChunkedPrefill] = None
        if admission == "chunked":
            self.chunked = engine.ChunkedPrefill(
                cfg, layout, buckets=buckets or engine.default_buckets(self.chunk_budget),
                rules=rules)
        # next-token feed per slot; EMPTY/PREFILLING rows decode token 0 into
        # garbage that per-slot valid masks + chunk overwrites keep invisible
        self.tokens = np.zeros((layout.batch, 1), np.int64)

        # speculative decoding: the argument, else the config
        self.spec = spd.validate(cfg, layout, spd.resolve(cfg, spec_decode, draft_gamma,
                                                          draft_planes))
        self.draft_fn = draft_fn
        self.draft_params = None
        if self.spec.enabled:
            if draft_fn is None and self.spec.planes < 7:
                # truncated-plane draft weights, converted through the same
                # weight-format path as the real ones (a bstc run codes a
                # second set; the truncated raw tree is dropped after)
                self.draft_params, _ = swt.prepare_serve_params(
                    spd.truncate_plane_params(params, self.spec.planes), cfg,
                    self.weight_format,
                    local=spd.truncate_plane_params(local, self.spec.planes))
            else:
                # planes >= 7 keeps full int8 precision: the serve weights
                # are the (perfect) draft model
                self.draft_params = self.serve_params
        # spec-decode counters (stats()["spec"]): rounds, drafts proposed and
        # accepted, draft and verify steps, slot-rounds, best single accept
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_draft_steps = 0
        self.spec_verify_steps = 0
        self.spec_slot_rounds = 0
        self.spec_max_accept = 0

        self.step_count = 0
        self.finished: List[Request] = []
        self.cancelled: List[Request] = []  # cancel() + deadline sheds
        self.preemptions = 0  # chunk budgets reclaimed by a higher tier
        self._advancing: Optional[int] = None
        self.occupancy: List[float] = []  # busy slots / slots, per step
        self.decoded_tokens = 0
        # KV-read accounting: host-side closed forms of the steps' gathers
        self._decode_read = kvc.decode_read_bytes(layout, cfg, self.mesh_shape)
        self._chunk_read = kvc.chunk_read_bytes(layout, cfg, self.mesh_shape)
        # chunk interconnect scales with the chunk's lanes: priced a valid lane
        self._chunk_ic_per_lane = self._chunk_read["interconnect"]["total"]
        self.decode_steps = 0
        self.kv_bytes_read = {"decode": 0.0, "prefill": 0.0, "interconnect": 0.0}
        # weight-read accounting, kv_read's mirror: every converted
        # projection once a decode step at its coded bytes; a prefill chunk
        # reads the raw-dtype tree once
        self._weight_read = self.weight_plan.decode_read_bytes(layout, cfg, self.mesh_shape)
        self.weight_bytes_read = {"decode": 0.0, "prefill": 0.0}
        self.prefill_tokens_per_step: List[int] = []
        self.prompt_tokens_admitted = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0

    # ------------------------------------------------------------------
    # paged-layout page lifecycle (host allocator <-> device table)
    # ------------------------------------------------------------------

    def _sync_pages(self) -> None:
        """Copy the host page table into the device table if it changed."""
        if self.pager is not None and self.pager.dirty:
            self.cache["page_table"].copy_(torch.from_numpy(self.pager.table))
            self.pager.dirty = False

    def _ensure_pages(self, slot: int, lo: int, hi: int) -> None:
        if self.pager is not None:
            self.pager.ensure_range(slot, lo, hi)
            self._sync_pages()

    def _release_pages(self, slot: int) -> None:
        """Evict a slot's pages: decref all, zero (on device) the ones whose
        refcount hit zero — prefix sharers keep theirs."""
        if self.pager is None:
            return
        freed = self.pager.release_slot(slot)
        if freed:
            kvc.zero_pages(self.cache["global"], freed, self.layout.page_size)
        self._sync_pages()

    def _try_prefix_reuse(self, slot: Slot, req: Request) -> None:
        """Adopt resident prompt pages matching this prompt's head — at the
        slot's FIRST advance, never at assignment: the batched decode
        garbage-writes every row at its device pos, harmless only while the
        row maps no shared page there (see the reference's note).  Only
        global-only stacks qualify: a ring layer would need the reused
        positions' window, which nothing keeps."""
        if self.pager is None or self.layout.local_layers:
            return
        n, ids = self.pager.lookup_prefix(req.prompt)
        if n:
            self.pager.adopt_prefix(slot.index, ids)
            slot.prefill_pos = n
            req.prefix_reused_tokens = n
            self.prefix_hits += 1
            self.prefix_hit_tokens += n

    # ------------------------------------------------------------------
    # queue / admission
    # ------------------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Queue one request (FIFO among arrived; see ``Request.arrival_step``)."""
        if not 0 < request.prompt_len < self.layout.max_seq:
            raise ValueError(
                f"request {request.rid}: prompt_len {request.prompt_len} must be "
                f">= 1 and leave at least one decode slot below max_seq "
                f"{self.layout.max_seq}")
        request.submit_time = time.perf_counter()
        self.queue.append(request)

    @property
    def num_pending(self) -> int:
        """Requests not yet finished: queued plus live in a slot."""
        return len(self.queue) + sum(1 for s in self.slots if s.live)

    def _next_arrived(self) -> Optional[Request]:
        """Highest-priority arrived request, FIFO within a tier."""
        best = None
        for i, req in enumerate(self.queue):
            if req.arrival_step > self.step_count:
                continue
            if best is None or priority_rank(req.priority) < priority_rank(best[1].priority):
                best = (i, req)
        if best is None:
            return None
        del self.queue[best[0]]
        return best[1]

    def _shed_expired(self) -> None:
        """Cancel (shed) queued requests whose admission deadline passed."""
        expired = [r for r in self.queue
                   if r.deadline_steps is not None
                   and self.step_count - r.arrival_step > r.deadline_steps]
        for req in expired:
            self.queue.remove(req)
            self._record_cancel(req, "queued", shed=True)

    def _pick_token(self, req: Request, logits_row: np.ndarray) -> int:
        """Next response token: forced (teacher-forced oracles) or sampled."""
        t = len(req.generated)
        if req.forced_tokens is not None and t < len(req.forced_tokens):
            tok = int(req.forced_tokens[t])
        else:
            tok = int(self.sample_fn(logits_row[None])[0])
        if self.record_logits:
            if req.logit_rows is None:
                req.logit_rows = []
            req.logit_rows.append(np.asarray(logits_row, np.float32))
        return tok

    def _emit_first_token(self, slot: Slot, logits_row: np.ndarray) -> None:
        req = slot.request
        first = self._pick_token(req, logits_row)
        req.generated.append(first)
        now = time.perf_counter()
        req.first_token_step = self.step_count
        req.first_token_time = now
        req.token_times.append(now)
        self.tokens[slot.index, 0] = first
        slot.state = SlotState.DECODING
        if req.on_token is not None:
            req.on_token(req, first)
        if self._hit_limit(slot, req):
            self._finish(slot)

    def admit(self) -> List[Request]:
        """Eager admission: fill EMPTY slots from the queue (highest tier,
        FIFO within it), one whole-prompt B=1 forward per request; each
        admitted request gets its first token here."""
        admitted = []
        for slot in self.slots:
            if slot.state is not SlotState.EMPTY:
                continue
            req = self._next_arrived()
            if req is None:
                break
            slot.state = SlotState.PREFILLING
            slot.request = req
            req.admitted_step = self.step_count
            req.admit_time = time.perf_counter()
            self.prompt_tokens_admitted += req.prompt_len
            self._ensure_pages(slot.index, 0, req.prompt_len)
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64), device=self.device)
            logits, self.cache = engine.prefill_into_slot(
                self.params, self.cfg, self.layout, self.cache, slot.index, prompt,
                rules=self.rules)
            self._emit_first_token(slot, _host_rows(logits[0, -1]))
            self.weight_bytes_read["prefill"] += self.weight_plan.bf16_bytes
            admitted.append(req)
        return admitted

    def _advance_admission(self) -> int:
        """Chunked admission: assign arrived requests to EMPTY slots (reset the row), then
        spend at most ``chunk_budget`` prompt tokens advancing the
        highest-tier, oldest admitting request.  Returns the prompt tokens
        consumed."""
        for s in self.slots:
            if s.state is not SlotState.EMPTY:
                continue
            req = self._next_arrived()
            if req is None:
                break
            s.state = SlotState.PREFILLING
            s.request = req
            s.prefill_pos = 0
            req.admitted_step = self.step_count
            req.admit_time = time.perf_counter()
            self.cache = self.chunked.reset(self.cache, s.index)
            self.prompt_tokens_admitted += req.prompt_len
        admitting = [s for s in self.slots if s.state is SlotState.PREFILLING]
        if not admitting:
            self._advancing = None
            return 0
        slot = min(admitting, key=lambda s: (
            priority_rank(s.request.priority), s.request.admitted_step, s.index))
        prev = self._advancing
        if prev is not None and prev != slot.index:
            ps = self.slots[prev]
            if (ps.state is SlotState.PREFILLING
                    and priority_rank(ps.request.priority)
                    > priority_rank(slot.request.priority)):
                ps.request.preemptions += 1
                self.preemptions += 1
        req = slot.request
        if slot.prefill_pos == 0:
            self._try_prefix_reuse(slot, req)
        spent = 0
        logits, n = None, 0
        while spent < self.chunk_budget and slot.prefill_pos < req.prompt_len:
            take = min(req.prompt_len - slot.prefill_pos, self.chunk_budget - spent,
                       self.chunked.buckets[-1])
            self._ensure_pages(slot.index, slot.prefill_pos, slot.prefill_pos + take)
            logits, self.cache, n = self.chunked.run_chunk(
                self.params, self.cache, slot.index,
                req.prompt[slot.prefill_pos:slot.prefill_pos + take], slot.prefill_pos)
            self.kv_bytes_read["prefill"] += self._chunk_read["total"]
            self.kv_bytes_read["interconnect"] += self._chunk_ic_per_lane * n
            self.weight_bytes_read["prefill"] += self.weight_plan.bf16_bytes
            slot.prefill_pos += n
            spent += n
        if self.pager is not None and not self.layout.local_layers:
            # every page-aligned prompt prefix now fully written becomes a
            # reuse candidate for later admissions
            self.pager.register_prefix(slot.index, req.prompt, slot.prefill_pos)
        if slot.prefill_pos >= req.prompt_len:
            self._emit_first_token(slot, _host_rows(logits[0, n - 1]))
            self._advancing = None
        else:
            self._advancing = slot.index
        return spent

    # ------------------------------------------------------------------
    # decode / eviction
    # ------------------------------------------------------------------

    def _hit_limit(self, slot: Slot, req: Request) -> bool:
        if len(req.generated) >= req.max_new_tokens:
            return True
        # the next decode step writes at prompt_len + generated - 1 (the
        # device pos, tracked host-side): at max_seq the slot is full
        if req.prompt_len + len(req.generated) - 1 >= self.layout.max_seq:
            return True
        return (req.eos_id is not None and bool(req.generated)
                and req.generated[-1] == req.eos_id)

    def _evict(self, slot: Slot) -> None:
        """State-agnostic slot release: decref the slot's pages (zeroing the
        freed ones), reset the token feed, return the row to EMPTY.  The KV
        row itself is reset at the next admission."""
        self._release_pages(slot.index)
        self.tokens[slot.index, 0] = 0
        if self._advancing == slot.index:
            self._advancing = None
        slot.request = None
        slot.prefill_pos = 0
        slot.state = SlotState.EMPTY

    def _finish(self, slot: Slot) -> None:
        req = slot.request
        req.finished_step = self.step_count
        req.finish_time = time.perf_counter()
        slot.state = SlotState.DONE
        self.finished.append(req)
        self._pin_history(slot, req)
        self._evict(slot)
        if req.on_finish is not None:
            req.on_finish(req)

    def _record_cancel(self, req: Request, state: str, shed: bool = False) -> None:
        req.cancelled = True
        req.shed = shed
        req.cancel_state = state
        req.cancel_step = self.step_count
        req.cancel_time = time.perf_counter()
        self.cancelled.append(req)
        if req.on_finish is not None:
            req.on_finish(req)

    def cancel(self, rid: int) -> bool:
        """Cancel request ``rid`` wherever it is in its lifecycle (queued,
        PREFILLING or DECODING); survivors are untouched.  Returns True if
        the request was found queued or live."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                self._record_cancel(req, "queued")
                return True
        for slot in self.slots:
            if slot.live and slot.request.rid == rid:
                req = slot.request
                state = ("prefilling" if slot.state is SlotState.PREFILLING
                         else "decoding")
                self._evict(slot)
                self._record_cancel(req, state)
                return True
        return False

    def _pin_history(self, slot: Slot, req: Request) -> None:
        """``keep_prefix_resident``: index + pin the page-aligned prefix of
        the request's written history so a chat session's next turn can
        adopt it (release with :meth:`unpin_pages`)."""
        if self.pager is None or self.layout.local_layers or not req.keep_prefix_resident:
            return
        written = req.prompt_len + len(req.generated) - 1
        hist = np.concatenate([np.asarray(req.prompt, np.int32),
                               np.asarray(req.generated[:-1], np.int32)])
        self.pager.register_prefix(slot.index, hist, written)
        npages = written // self.layout.page_size
        ids = tuple(int(p) for p in self.pager.table[slot.index, :npages] if p >= 0)
        if npages > 0 and len(ids) == npages:
            self.pager.pin_pages(ids)
            req.pinned_pages = ids

    def unpin_pages(self, ids) -> None:
        """Release session pins: decref each page, zero the freed ones."""
        if self.pager is None or not ids:
            return
        freed = self.pager.unpin_pages(ids)
        kvc.zero_pages(self.cache["global"], freed, self.layout.page_size)
        self._sync_pages()

    # ------------------------------------------------------------------
    # speculative decoding (draft -> verify -> accept/rollback)
    # ------------------------------------------------------------------

    def _count_decode_step(self) -> None:
        """Account one executed ``serve_step``: the KV and weight prices are
        static totals a step, so draft, verify and plain decode steps all
        pay the same (the accounting laws hold with or without
        speculation; its gain shows in the per-accepted-token columns)."""
        self.decode_steps += 1
        self.kv_bytes_read["decode"] += self._decode_read["total"]
        self.kv_bytes_read["interconnect"] += self._decode_read["interconnect"]["total"]
        self.weight_bytes_read["decode"] += self._weight_read["total"]

    def _spec_round(self, live: List[Slot]) -> None:
        """One draft -> verify -> accept/rollback round for every DECODING
        slot (in place of the batched decode step).

        Drafts come from ``draft_fn(request, token_index)`` when given (the
        tests' perfect or adversarial drafts), else from a ``gamma``-step
        chain of ``serve_step`` over the truncated-plane ``draft_params``.
        Verification feeds the drafts through ``serve_step`` with the real
        weights and picks each slot's true token from the exact logits
        (``_pick_token``), so every accepted token is the one
        non-speculative decode would give; a slot leaves the chain at its
        first mismatch, after its corrected token.  Rollback then rewinds
        every row's ``pos`` (live slots to their accepted frontier, the
        other rows to their pre-round position), releases paged pages past
        the frontier (``PageAllocator.rewind_slot`` + page zeroing) and
        zeroes the speculative rows in every store leaf; finishes are
        deferred until after it."""
        gamma = self.spec.gamma
        B = self.layout.batch
        # pre-round frontier P: this round's first write position per slot
        P = {s.index: s.request.prompt_len + len(s.request.generated) - 1 for s in live}
        reqs = {s.index: s.request for s in live}
        if self.pager is not None:
            for slot in live:
                p = P[slot.index]
                self.pager.ensure_range(slot.index, p, min(p + gamma + 1, self.layout.max_seq))
            self._sync_pages()
        # ---- draft: gamma proposed tokens per live slot ----------------
        drafts: Dict[int, List[int]] = {i: [] for i in P}
        draft_steps = 0
        if self.draft_fn is not None:
            for slot in live:
                req = reqs[slot.index]
                n0 = len(req.generated)
                drafts[slot.index] = [int(self.draft_fn(req, n0 + j)) for j in range(gamma)]
        else:
            # greedy argmax fed forward on the live cache; its writes land
            # past every frontier and are rolled back with the round
            feed = self.tokens.copy()
            for _ in range(gamma):
                dlogits, self.cache = self.serve_step(
                    self.draft_params, self.cache, torch.as_tensor(feed, device=self.device))
                drows = _host_rows(dlogits[:, -1])
                draft_steps += 1
                self._count_decode_step()
                for slot in live:
                    tok = int(np.argmax(drows[slot.index]))
                    drafts[slot.index].append(tok)
                    feed[slot.index, 0] = tok
            # undo the draft chain's pos drift: the verify chain writes and
            # attends where non-speculative decode would
            self.cache["pos"] -= gamma
        # ---- verify: feed the drafts, accept while they match ----------
        active = {slot.index: slot for slot in live}
        accepted = {slot.index: 0 for slot in live}
        finishes: List[Slot] = []
        C = 0
        while active and C < gamma + 1:
            logits, self.cache = self.serve_step(
                self.serve_params, self.cache, torch.as_tensor(self.tokens, device=self.device))
            rows = _host_rows(logits[:, -1])
            j, C = C, C + 1
            self._count_decode_step()
            self.spec_verify_steps += 1
            self.decoded_tokens += len(active)
            now = time.perf_counter()
            for idx in list(active):
                slot = active[idx]
                req = reqs[idx]
                tok = self._pick_token(req, rows[idx])
                req.generated.append(tok)
                req.token_times.append(now)
                accepted[idx] += 1
                # while the drafts match, the next feed IS the draft
                self.tokens[idx, 0] = tok
                if req.on_token is not None:
                    req.on_token(req, tok)
                if self._hit_limit(slot, req):
                    # finish after the rollback: _pin_history must only see
                    # pages the rewind kept
                    finishes.append(slot)
                    del active[idx]
                elif j < gamma and tok != drafts[idx][j]:
                    del active[idx]  # draft diverged; the corrected token is kept
        # ---- rollback ---------------------------------------------------
        delta = np.full(B, C, np.int32)
        for slot in live:
            delta[slot.index] = C - accepted[slot.index]
        self.cache["pos"] -= torch.as_tensor(delta, device=self.device)
        if self.pager is not None:
            freed: List[int] = []
            for slot in live:
                freed += self.pager.rewind_slot(slot.index, P[slot.index] + accepted[slot.index])
            kvc.zero_pages(self.cache["global"], freed, self.layout.page_size)
            self._sync_pages()
        # zero the speculative rows [P+a, P+extent) in every leaf: freed
        # pages were scrubbed whole above; this covers the slot layout and
        # the paged frontier page's tail
        extent = max(C, gamma if draft_steps else 0)
        tpos = np.full((B, gamma + 1), kvc.OOB_INDEX, np.int64)
        dirty = False
        for slot in live:
            lo = P[slot.index] + accepted[slot.index]
            hi = min(P[slot.index] + extent, self.layout.max_seq)
            if hi > lo:
                tpos[slot.index, :hi - lo] = np.arange(lo, hi)
                dirty = True
        if dirty and self.shard is not None and self.shard.split_stores:
            tpos = tpos[self.shard.lo:self.shard.hi]  # the rank's rows of the slot stacks
        if dirty:
            kvc.zero_token_range(
                self.cache["global"], tpos,
                page_table=self.cache["page_table"] if self.pager is not None else None,
                page_size=self.layout.page_size, max_seq=self.layout.max_seq)
        # ---- bookkeeping + deferred finishes ----------------------------
        self.spec_rounds += 1
        self.spec_draft_steps += draft_steps
        for slot in live:
            a = accepted[slot.index]
            req = reqs[slot.index]
            self.spec_accepted += a
            self.spec_drafted += gamma
            self.spec_slot_rounds += 1
            self.spec_max_accept = max(self.spec_max_accept, a)
            req.spec_accepts.append(a)
            req.spec_drafted += gamma
        for slot in finishes:
            self._finish(slot)

    def step(self) -> bool:
        """Admit (eager) or advance (chunked) prefill, run one batched
        decode step, harvest, evict.
        Returns False when there was nothing to do."""
        self._shed_expired()
        if self.admission == "chunked":
            spent = self._advance_admission()
        else:
            spent = sum(r.prompt_len for r in self.admit())
        self.prefill_tokens_per_step.append(spent)
        busy = [s for s in self.slots if s.live]
        live = [s for s in self.slots if s.state is SlotState.DECODING]
        self.occupancy.append(len(busy) / len(self.slots))
        if not live:
            self.step_count += 1
            return bool(busy)
        if self.spec.enabled:
            # one draft -> verify -> accept/rollback round replaces the
            # batched decode step (same harvesting, same eviction)
            self.step_count += 1
            self._spec_round(live)
            return True
        if self.pager is not None:
            for slot in live:
                r = slot.request
                p = r.prompt_len + len(r.generated) - 1
                self.pager.ensure_range(slot.index, p, p + 1)
            self._sync_pages()
        logits, self.cache = self.serve_step(
            self.serve_params, self.cache, torch.as_tensor(self.tokens, device=self.device))
        rows = _host_rows(logits[:, -1])
        self.step_count += 1
        self._count_decode_step()
        self.decoded_tokens += len(live)
        now = time.perf_counter()
        for slot in live:
            req = slot.request
            tok = self._pick_token(req, rows[slot.index])
            req.generated.append(tok)
            req.token_times.append(now)
            self.tokens[slot.index, 0] = tok
            if req.on_token is not None:
                req.on_token(req, tok)
            if self._hit_limit(slot, req):
                self._finish(slot)
        return True

    def run(self, max_steps: Optional[int] = None) -> Dict:
        """Drive steps until every submitted request finished (or the step
        budget runs out); returns :meth:`stats`."""
        t0 = time.perf_counter()
        while self.num_pending:
            if max_steps is not None and self.step_count >= max_steps:
                break
            self.step()
        return self.stats(time.perf_counter() - t0)

    def _tier_stats(self) -> Dict[str, Dict]:
        """Per-priority-tier SLO columns."""
        tiers: Dict[str, Dict] = {}
        present = {r.priority for r in self.finished} | {r.priority for r in self.cancelled}
        for tier in sorted(present, key=priority_rank):
            fin = [r for r in self.finished if r.priority == tier]
            gaps = np.concatenate([r.itl_gaps_s() for r in fin]) if fin else np.asarray([])
            tiers[tier] = {
                "finished": len(fin),
                "cancelled": sum(1 for r in self.cancelled if r.priority == tier),
                "shed": sum(1 for r in self.cancelled if r.priority == tier and r.shed),
                "preemptions": sum(r.preemptions for r in fin),
                "ttft_s": _percentiles(r.ttft_s for r in fin if r.first_token_time > 0),
                "itl_s": _percentiles(gaps),
            }
        return tiers

    def stats(self, wall_s: Optional[float] = None) -> Dict:
        """Aggregate serving metrics: throughput/occupancy, TTFT/ITL
        percentiles, per-request traces, the ``kv_read`` counter (KV bytes
        the executed decode / chunk steps gathered, with the bgpp two-phase
        breakdown), its mirror ``weight_read`` (projection-weight bytes at
        the resolved format's coded layout) and, paged, the pool
        accounting."""
        occ = [o for o in self.occupancy if o > 0] or self.occupancy
        gaps = (np.concatenate([r.itl_gaps_s() for r in self.finished])
                if self.finished else np.asarray([]))
        out = {
            "device": str(self.device),
            "admission": self.admission,
            "kv_layout": self.layout.layout,
            "finished_requests": len(self.finished),
            "decoded_tokens": self.decoded_tokens,
            "steps": self.step_count,
            "mean_occupancy": float(np.mean(occ)) if occ else 0.0,
            "max_prefill_tokens_per_step": max(self.prefill_tokens_per_step, default=0),
            "ttft_s": _percentiles(r.ttft_s for r in self.finished if r.first_token_time > 0),
            "itl_s": _percentiles(gaps),
            "requests": [r.trace_record() for r in self.finished],
            "cancelled_requests": len(self.cancelled),
            "shed_requests": sum(1 for r in self.cancelled if r.shed),
            "preemptions": self.preemptions,
            "tiers": self._tier_stats(),
            "cancelled": [r.cancel_record() for r in self.cancelled],
        }
        dr = self._decode_read
        out["kv_read"] = {
            "decode_bytes": round(self.kv_bytes_read["decode"]),
            "prefill_bytes": round(self.kv_bytes_read["prefill"]),
            "decode_steps": self.decode_steps,
            "decode_bytes_per_step": round(dr["total"]),
            "decode_bf16_equiv_bytes_per_step": round(dr["bf16_equiv"]),
            "decode_bytes_reduction_vs_bf16":
                round(dr["bf16_equiv"] / dr["total"], 3) if dr["total"] else None,
            # mesh columns: each rank's share of the gathers and the priced
            # collectives (zero / equal to the total at mesh 1x1)
            "mesh": {"data": self.mesh_shape[0], "model": self.mesh_shape[1]},
            "kv_shards": dr["per_device"]["shards"],
            "decode_bytes_per_device_per_step": round(dr["per_device"]["total"]),
            "interconnect_bytes_per_step": round(dr["interconnect"]["total"]),
            "interconnect_bytes": round(self.kv_bytes_read["interconnect"]),
            "interconnect": {n: round(v) for n, v in dr["interconnect"].items()},
        }
        if "bgpp" in dr:
            out["kv_read"]["bgpp"] = {n: round(v) if isinstance(v, float) else v
                                      for n, v in dr["bgpp"].items()}
        wr = self._weight_read
        out["weight_read"] = {
            "weight_format": self.weight_format,
            "decode_bytes": round(self.weight_bytes_read["decode"]),
            "prefill_bytes": round(self.weight_bytes_read["prefill"]),
            "decode_steps": self.decode_steps,
            "decode_bytes_per_step": round(wr["total"]),
            "decode_bf16_equiv_bytes_per_step": round(wr["bf16_equiv"]),
            "decode_bytes_reduction_vs_bf16":
                round(wr["bf16_equiv"] / wr["total"], 3) if wr["total"] else None,
            # closed-form reconciliation (roofline.bstc_weight_traffic on the
            # measured per-plane column sparsities)
            "modeled_bytes_per_step": round(wr["modeled"]),
            "measured_over_modeled":
                round(wr["total"] / wr["modeled"], 4) if wr["modeled"] else None,
            "per_projection": {n: round(v) for n, v in wr["per_projection"].items()},
            "mesh": {"data": self.mesh_shape[0], "model": self.mesh_shape[1]},
            "weight_shards": wr["per_device"]["shards"],
            "decode_bytes_per_device_per_step": round(wr["per_device"]["total"]),
        }
        if self.spec.enabled:
            acc = self.spec_accepted
            kvb = self.kv_bytes_read["decode"]
            wb = self.weight_bytes_read["decode"]
            # a truncated-plane draft step streams only the kept planes (the
            # model); verify steps pay in full.  Callback drafts run no draft
            # step, so modeled == measured.
            modeled = (self.spec_draft_steps * wr["total"] * self.spec.planes / 8.0
                       + self.spec_verify_steps * wr["total"])
            out["spec"] = {
                "enabled": True,
                "gamma": self.spec.gamma,
                "draft_planes": self.spec.planes,
                "draft_source": "callback" if self.draft_fn is not None else "planes",
                "rounds": self.spec_rounds,
                "drafted_tokens": self.spec_drafted,
                "accepted_tokens": acc,
                "draft_steps": self.spec_draft_steps,
                "verify_steps": self.spec_verify_steps,
                "max_accepted_in_round": self.spec_max_accept,
                # true tokens per executed serve_step (draft + verify); 1.0
                # is the non-speculative baseline
                "accepted_tokens_per_step":
                    round(acc / self.decode_steps, 4) if self.decode_steps else None,
                "accepted_tokens_per_round":
                    round(acc / self.spec_slot_rounds, 4) if self.spec_slot_rounds else None,
                # drafts that survived verification (each slot-round's first
                # accepted token is the free corrected one)
                "draft_hit_rate": round((acc - self.spec_slot_rounds) / self.spec_drafted, 4)
                if self.spec_drafted else None,
                "kv_bytes_per_accepted_token": round(kvb / acc) if acc else None,
                "weight_bytes_per_accepted_token": round(wb / acc) if acc else None,
                "modeled_weight_bytes_per_accepted_token":
                    round(modeled / acc) if acc else None,
            }
        if self.pager is not None:
            pb = self._page_bytes
            out["paged"] = {
                "page_size": self.layout.page_size,
                "num_pages": self.layout.num_pages,
                "pages_allocated_total": self.pager.alloc_count,
                "pages_in_use": self.pager.pages_in_use,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_hit_rate": round(
                    self.prefix_hit_tokens / max(1, self.prompt_tokens_admitted), 4),
                "resident_kv_bytes_peak": self.pager.peak_pages * pb,
                "slot_resident_kv_bytes": self.layout.batch * self.layout.pages_per_slot * pb,
            }
        if wall_s is not None:
            out["wall_s"] = round(wall_s, 3)
            out["tokens_per_s"] = round(self.decoded_tokens / wall_s, 2) if wall_s > 0 else None
        return out
