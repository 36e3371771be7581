"""Request/slot dataclasses for the continuous-batching serving runtime.

Counterpart of :mod:`repro.serving.request` (pure Python).

A :class:`Request` is one user prompt plus its decode budget and the
timing/trace fields the scheduler fills in as the request moves through its
lifecycle.  A :class:`Slot` is one batch index of the live cache; its state
machine is

    EMPTY -> PREFILLING -> DECODING -> DONE -> (evicted) EMPTY
                  |             |
                  +-- cancel ---+--> CANCELLED -> (evicted) EMPTY

With chunked admission PREFILLING is a real multi-step state: the slot
stays in it while the scheduler feeds the prompt through fixed-shape
prefill chunks between batched decode steps, ``Slot.prefill_pos`` tracking
how many prompt tokens have been consumed.  Eager admission passes through
PREFILLING synchronously inside one ``admit()`` call.

``Scheduler.cancel(rid)`` can pull a request out at ANY lifecycle state —
still queued, mid-chunked-prefill, or decoding — releasing its pages and
recording only the bookkeeping its state actually produced (a PREFILLING
cancel has no first token, so no TTFT/ITL rows).  Requests also carry a
``priority`` tier (``interactive`` before ``batch``): the admission queue
is priority-ordered FIFO, and the chunked-prefill advance always picks the
highest-priority admitting slot, preempting an in-progress lower-tier
prefill (its ``prefill_pos`` freezes; it resumes at the same offset once
nothing above it is admitting).  ``deadline_steps`` is the SLO-aware
admission knob: a request still queued that many steps after arrival is
shed instead of admitted.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional

import numpy as np

# SLO tiers, best first: the admission queue and the chunked-prefill
# advance order both sort by PRIORITIES.index(request.priority)
PRIORITIES = ("interactive", "batch")


def priority_rank(priority: str) -> int:
    """Admission rank of a tier name (lower admits/advances first)."""
    try:
        return PRIORITIES.index(priority)
    except ValueError:
        raise ValueError(
            f"unknown priority {priority!r}: expected one of {PRIORITIES}"
        ) from None


class SlotState(enum.Enum):
    """Slot lifecycle states (EMPTY -> PREFILLING -> DECODING -> DONE,
    with cancellation folding any live state back to EMPTY)."""

    EMPTY = "empty"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    DONE = "done"


@dataclasses.dataclass(eq=False)  # identity equality: prompt is an ndarray
class Request:
    """One serving request: a prompt and a max-new-tokens budget."""

    rid: int
    prompt: np.ndarray  # (S,) int32 token ids
    max_new_tokens: int
    arrival_step: int = 0  # scheduler step at which the request "arrives"
    eos_id: Optional[int] = None  # stop decoding on this token (after 1 tok)
    # teacher-forcing hook: when set, token t of the response is
    # forced_tokens[t] instead of the sampled token (logits are still
    # produced/recorded) — the serving oracles compare quantized formats
    # like-for-like per position without greedy compounding
    forced_tokens: Optional[np.ndarray] = None
    # SLO class: admission order and the per-tier stats() bucket
    priority: str = "interactive"
    # SLO-aware admission: shed (cancel unstarted) if still queued this
    # many steps after arrival.  None = wait forever.
    deadline_steps: Optional[int] = None
    # streaming hooks (the async server's transport): on_token fires once
    # per generated token, on_finish exactly once per request — at DONE
    # *or* at cancellation/shedding (check ``cancelled``)
    on_token: Optional[Callable[["Request", int], None]] = None
    on_finish: Optional[Callable[["Request"], None]] = None
    # chat sessions: at DONE, pin the page-aligned prefix of this
    # request's written history (prompt + generated KV) so the next turn's
    # prompt can adopt it from the sha1 prefix index (paged, global-only
    # layouts; the pin ids land in ``pinned_pages``)
    keep_prefix_resident: bool = False

    # --- filled in by the scheduler -----------------------------------
    generated: List[int] = dataclasses.field(default_factory=list)
    # prompt tokens whose KV was adopted from resident shared pages at
    # admission instead of prefilled (paged layouts with prefix reuse)
    prefix_reused_tokens: int = 0
    admitted_step: int = -1  # step at which a slot started prefilling this
    first_token_step: int = -1  # step at which prefill finished (token 1)
    finished_step: int = -1
    submit_time: float = -1.0  # wall-clock seconds (scheduler clock)
    admit_time: float = -1.0
    first_token_time: float = -1.0
    finish_time: float = -1.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    # per-token logits rows (np.float32 (V,)), when Scheduler(record_logits=True)
    logit_rows: Optional[List[np.ndarray]] = None
    # cancellation bookkeeping (Scheduler.cancel / deadline shedding)
    cancelled: bool = False
    shed: bool = False  # cancelled by the admission deadline, never ran
    cancel_step: int = -1
    cancel_time: float = -1.0
    # lifecycle state at the moment of cancellation ("queued" /
    # "prefilling" / "decoding") — the fuzz oracle's coverage audit
    cancel_state: Optional[str] = None
    # times this request's in-progress chunked prefill lost the budget to
    # a higher-priority admitting slot
    preemptions: int = 0
    # page ids pinned at DONE for keep_prefix_resident (release with
    # Scheduler.unpin_pages when the session closes)
    pinned_pages: tuple = ()
    # speculative decoding: tokens accepted in each round this request
    # took part in (each in 1..gamma+1 — the corrected token alone up to
    # every draft plus the bonus token) and total drafts proposed
    spec_accepts: List[int] = dataclasses.field(default_factory=list)
    spec_drafted: int = 0

    @property
    def prompt_len(self) -> int:
        """Prompt length in tokens."""
        return int(len(self.prompt))

    @property
    def queue_wait_steps(self) -> int:
        """Scheduler steps spent queued between arrival and admission."""
        return self.admitted_step - self.arrival_step

    @property
    def latency_steps(self) -> int:
        """Scheduler steps from arrival to the last generated token."""
        return self.finished_step - self.arrival_step

    @property
    def ttft_s(self) -> float:
        """Submit -> first generated token (includes queue wait + prefill)."""
        return self.first_token_time - self.submit_time

    def itl_gaps_s(self) -> np.ndarray:
        """Inter-token latency samples (seconds between consecutive tokens)."""
        return np.diff(np.asarray(self.token_times, np.float64))

    def trace_record(self) -> dict:
        """JSON-serializable per-request trace entry (``--trace-out``)."""
        wall = self.finish_time - self.admit_time
        gaps = self.itl_gaps_s()
        return {
            "rid": self.rid,
            "priority": self.priority,
            "preemptions": self.preemptions,
            "prompt_len": self.prompt_len,
            "prefix_reused_tokens": self.prefix_reused_tokens,
            "new_tokens": len(self.generated),
            "arrival_step": self.arrival_step,
            "admitted_step": self.admitted_step,
            "first_token_step": self.first_token_step,
            "finished_step": self.finished_step,
            "queue_wait_steps": self.queue_wait_steps,
            "latency_steps": self.latency_steps,
            "queue_wait_s": round(self.admit_time - self.submit_time, 6),
            "ttft_s": round(self.ttft_s, 6),
            "mean_itl_s": round(float(np.mean(gaps)), 6) if gaps.size else None,
            "latency_s": round(self.finish_time - self.submit_time, 6),
            "tokens_per_s": round(len(self.generated) / wall, 3)
            if wall > 0 else None,
            "spec_rounds": len(self.spec_accepts),
            "spec_accepted_tokens": int(sum(self.spec_accepts)),
            "spec_drafted_tokens": self.spec_drafted,
        }

    def cancel_record(self) -> dict:
        """JSON-serializable trace entry for a cancelled/shed request."""
        return {
            "rid": self.rid,
            "priority": self.priority,
            "prompt_len": self.prompt_len,
            "tokens_before_cancel": len(self.generated),
            "cancel_state": self.cancel_state,
            "shed": self.shed,
            "arrival_step": self.arrival_step,
            "cancel_step": self.cancel_step,
        }


@dataclasses.dataclass
class Slot:
    """One batch index of the live cache."""

    index: int
    state: SlotState = SlotState.EMPTY
    request: Optional[Request] = None
    prefill_pos: int = 0  # prompt tokens consumed while PREFILLING

    @property
    def live(self) -> bool:
        """Whether the slot holds an admitted request (occupied capacity)."""
        return self.state in (SlotState.PREFILLING, SlotState.DECODING)


def poisson_trace(rng: np.random.Generator, n: int, vocab: int, max_new: int,
                  arrival_rate: float = 2.0, min_new: int = 2,
                  max_prompt: int = 23,
                  shared_prefix: int = 0) -> List[Request]:
    """Poisson-ish request trace shared by the launcher and the throughput
    benchmark: exponential inter-arrival gaps (in decode steps), prompt
    lengths ``min(8, max_prompt)..max_prompt``, decode budgets
    ``min(min_new, max_new)..max_new``.  Cap ``max_prompt`` below the
    cache's ``max_seq`` so every request is admissible.

    ``shared_prefix > 0`` prepends the same ``shared_prefix`` random tokens
    to every prompt — the shared-system-prompt workload the paged cache's
    prefix reuse targets (each request still gets its own random tail)."""
    lo = max(1, min(min_new, max_new))
    plo = max(1, min(8, max_prompt))
    prefix = rng.integers(0, vocab, (shared_prefix,)).astype(np.int32)
    reqs, step = [], 0
    for rid in range(n):
        step += int(rng.exponential(arrival_rate))
        tail = rng.integers(
            0, vocab, (int(rng.integers(plo, max_prompt + 1)),)
        ).astype(np.int32)
        reqs.append(Request(
            rid=rid,
            prompt=np.concatenate([prefix, tail]) if shared_prefix else tail,
            max_new_tokens=int(rng.integers(lo, max_new + 1)),
            arrival_step=step,
        ))
    return reqs
