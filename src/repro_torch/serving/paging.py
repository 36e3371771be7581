"""Host-side page allocator + hash-based prefix-reuse index for the paged
KV cache (``CacheLayout.layout == "paged"``).

Counterpart of :mod:`repro.serving.paging` (pure numpy), with the
speculative-decode rollback ``rewind_slot``.

The device side (``kv_cache``/``engine``) only ever sees a ``(B,
pages_per_slot)`` int32 page table; everything dynamic lives here, in plain
python/numpy, mirroring the device-graph-static / scheduling-dynamic split
the scheduler already uses:

  * a free list + per-page refcounts — a physical page may back the same
    logical prefix of several slots at once (prefix reuse maps it
    copy-on-write: refcount++, never an actual copy, because shared pages
    are always *full* prompt pages that no slot writes again);
  * per-page generation counters — bumped when a page's refcount hits zero,
    so stale prefix-index entries can never resurrect freed contents;
  * the prefix index: sha1(prompt token ids of each fully-written,
    page-aligned prompt prefix) -> the physical pages backing it.  A new
    request whose prompt matches a resident entry adopts those pages
    instead of re-prefilling them.  Lookup caps reuse at ``prompt_len - 1``
    tokens (the last prompt token must run through the chunk path to
    produce the first-token logits) and is only offered for global-only
    layouts: sliding-window ring stacks discard prefix positions as they
    decode, so a reused slot could never rebuild its window without
    recomputing the very tokens reuse skips.

The scheduler drives the lifecycle: ``ensure_range`` before every chunk /
decode write, ``register_prefix`` after chunks land, ``lookup_prefix`` +
``adopt_prefix`` at admission, ``rewind_slot`` after a speculative round,
``release_slot`` at eviction (the returned
freed ids are scrubbed on device via :func:`repro_torch.serving.kv_cache
.zero_pages` — eviction only *frees* a page when its refcount hits zero).

Pages can additionally be **pinned** (``pin_pages`` / ``unpin_pages``): a
pin is a refcount held by no slot — the async server's chat sessions use
it to keep a finished turn's prompt+history pages (and their prefix-index
entries) resident between turns, so the next turn's prompt adopts them
instead of re-prefilling.  ``check()`` accounts pins explicitly: table
reachability + pins must equal the refcount exactly.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.serving import kv_cache as kvc


class PageAllocator:
    """Free-list page allocator with refcounts and a weak prefix index."""

    def __init__(self, layout: kvc.CacheLayout):
        assert layout.layout == "paged" and layout.page_size >= 1
        self.layout = layout
        self.page_size = layout.page_size
        self.pages_per_slot = layout.pages_per_slot
        self.num_pages = layout.num_pages
        self.table = np.full(
            (layout.batch, self.pages_per_slot), -1, np.int32
        )
        self.refcount = np.zeros(self.num_pages, np.int32)
        self.generation = np.zeros(self.num_pages, np.int64)
        # refcounts held by pins (session keep-alives) rather than by a
        # slot's table row; check() reconciles them separately
        self.pins = np.zeros(self.num_pages, np.int32)
        # pop() hands out low ids first (cosmetic, but makes traces stable)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        # digest -> (prefix tokens, page ids, generations at registration)
        self._prefix: Dict[bytes, Tuple[int, Tuple[int, ...], Tuple[int, ...]]] = {}
        # page id -> digests referencing it, so freeing a page prunes its
        # index entries immediately (the index stays bounded by live pages
        # instead of growing with every prompt ever admitted)
        self._page_digests: Dict[int, set] = {}
        # per-slot high-water mark of registered prefix tokens: the
        # scheduler calls register_prefix after every chunk advance, so
        # without it each call would re-hash every boundary from page 1
        # (quadratic in prompt pages)
        self._registered = np.zeros(layout.batch, np.int64)
        self.dirty = True  # device table needs a sync
        self.alloc_count = 0
        self.peak_pages = 0

    # ------------------------------------------------------------------
    # physical pages
    # ------------------------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        """Physical pages currently mapped by at least one slot."""
        return self.num_pages - len(self._free)

    def _alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"page pool exhausted ({self.num_pages} pages of "
                f"{self.page_size} tokens); raise num_pages in layout_for"
            )
        p = self._free.pop()
        assert self.refcount[p] == 0, f"free list held live page {p}"
        self.refcount[p] = 1
        self.alloc_count += 1
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return p

    def ensure_range(self, slot: int, lo: int, hi: int) -> List[int]:
        """Map fresh pages so logical positions ``[lo, hi)`` (``[lo, lo]``
        when hi <= lo) of ``slot`` are writable; already-mapped pages
        (including adopted shared ones) are left alone.  Returns the newly
        allocated page ids."""
        hi = max(hi, lo + 1)
        new = []
        for pi in range(lo // self.page_size, (hi - 1) // self.page_size + 1):
            if self.table[slot, pi] < 0:
                self.table[slot, pi] = new_page = self._alloc()
                new.append(new_page)
        if new:
            self.dirty = True
        return new

    def release_slot(self, slot: int) -> List[int]:
        """Evict ``slot``: decref every mapped page, unmap the row.  Only
        pages whose refcount hits zero are freed (and returned for device
        zeroing) — prefix sharers keep theirs alive."""
        freed = []
        for pi in range(self.pages_per_slot):
            p = int(self.table[slot, pi])
            if p < 0:
                continue
            assert self.refcount[p] > 0, f"double free of page {p}"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.generation[p] += 1
                self._free.append(p)
                freed.append(p)
                for d in self._page_digests.pop(p, ()):
                    self._prefix.pop(d, None)
            self.table[slot, pi] = -1
            self.dirty = True
        self._registered[slot] = 0
        return freed

    def rewind_slot(self, slot: int, keep_tokens: int) -> List[int]:
        """Roll ``slot`` back so only logical positions ``[0, keep_tokens)``
        stay valid — the speculative-decode rollback.  Pages entirely past
        the kept frontier are decref'd and unmapped (freed at refcount 0:
        generation bumped, prefix entries pruned, returned for device
        zeroing); the page the frontier straddles stays mapped but has ALL
        its prefix-index digests deregistered — its tail rows held
        speculative writes, so a later prompt matching a stale hash must
        never adopt it.  The slot's registration high-water mark is clamped
        so later ``register_prefix`` calls re-hash from the kept frontier."""
        freed = []
        for pi in range(self.pages_per_slot):
            p = int(self.table[slot, pi])
            if p < 0:
                continue
            if pi * self.page_size >= keep_tokens:
                # page wholly past the accepted frontier: give it back
                assert self.refcount[p] > 0, f"double free of page {p}"
                self.refcount[p] -= 1
                if self.refcount[p] == 0:
                    self.generation[p] += 1
                    self._free.append(p)
                    freed.append(p)
                    for d in self._page_digests.pop(p, ()):
                        self._prefix.pop(d, None)
                self.table[slot, pi] = -1
                self.dirty = True
            elif (pi + 1) * self.page_size > keep_tokens:
                # frontier page: kept (its head rows are valid), but its
                # rewound tail invalidates every prefix that covered it.
                # A speculating slot never shares its frontier page (shared
                # pages are full prompt pages nobody writes again).
                assert self.refcount[p] == int(self.pins[p]) + 1, (
                    f"rewinding shared page {p} would corrupt its sharers")
                for d in self._page_digests.pop(p, ()):
                    self._prefix.pop(d, None)
        self._registered[slot] = min(int(self._registered[slot]),
                                     (keep_tokens // self.page_size) * self.page_size)
        return freed

    # ------------------------------------------------------------------
    # prefix reuse
    # ------------------------------------------------------------------

    @staticmethod
    def _digest(tokens, n: int) -> bytes:
        return hashlib.sha1(
            np.ascontiguousarray(tokens[:n], np.int32).tobytes()
        ).digest()

    def register_prefix(self, slot: int, tokens, upto: int) -> None:
        """Index every page-aligned prompt prefix of ``slot`` that is fully
        written (``boundary <= upto``) and made purely of prompt tokens.
        Incremental: boundaries at or below the slot's last registration
        (including adopted pages — the donor already indexed those) are
        skipped, so repeated calls while a prompt chunks stay linear."""
        limit = min(int(upto), len(tokens))
        start = int(self._registered[slot]) // self.page_size + 1
        for k in range(start, limit // self.page_size + 1):
            ids = tuple(int(p) for p in self.table[slot, :k])
            if any(p < 0 for p in ids):  # unmapped => nothing to share
                break
            d = self._digest(tokens, k * self.page_size)
            self._prefix[d] = (
                k * self.page_size, ids,
                tuple(int(self.generation[p]) for p in ids),
            )
            for p in ids:
                self._page_digests.setdefault(p, set()).add(d)
            self._registered[slot] = k * self.page_size

    def lookup_prefix(self, tokens) -> Tuple[int, Tuple[int, ...]]:
        """Longest indexed, still-resident prefix of ``tokens`` covering at
        most ``len(tokens) - 1`` of them.  Stale entries (a backing page
        was freed — generation moved on) are pruned on sight.  Returns
        ``(n_tokens, page_ids)`` (``(0, ())`` on miss).

        The three legality rules of prefix reuse (each enforced here or by
        the scheduler, checked in tests/test_torch_serving.py):

        * **full pages only** — only page-aligned, fully-written prompt
          prefixes are ever indexed (``register_prefix``), so a shared
          page is never written again by any adopter;
        * **resident donor** — every backing page must still be refcounted
          at its registration generation; freed pages can never resurrect;
        * **global-only stacks** — the scheduler offers reuse only when
          the layout has no sliding-window ring layers, which discard the
          very positions a reused slot would need.
        """
        for k in range((len(tokens) - 1) // self.page_size, 0, -1):
            d = self._digest(tokens, k * self.page_size)
            hit = self._prefix.get(d)
            if hit is None:
                continue
            _, ids, gens = hit
            if all(self.refcount[p] > 0 and self.generation[p] == g
                   for p, g in zip(ids, gens)):
                return k * self.page_size, ids
            del self._prefix[d]
        return 0, ()

    def adopt_prefix(self, slot: int, ids: Tuple[int, ...]) -> None:
        """Map shared prefix pages into ``slot`` (refcount++ each); the
        slot must be freshly evicted (its row unmapped)."""
        for pi, p in enumerate(ids):
            assert self.table[slot, pi] < 0, f"slot {slot} page {pi} mapped"
            self.refcount[p] += 1
            self.table[slot, pi] = p
        if ids:
            # the donor already indexed these boundaries
            self._registered[slot] = len(ids) * self.page_size
            self.dirty = True

    # ------------------------------------------------------------------
    # pins (session keep-alives)
    # ------------------------------------------------------------------

    def pin_pages(self, ids) -> None:
        """Hold ``ids`` resident without a slot mapping (refcount++ each).
        Every page must currently be live — a pin extends residency, it
        cannot resurrect a freed page."""
        for p in ids:
            p = int(p)
            assert self.refcount[p] > 0, f"cannot pin freed page {p}"
            self.refcount[p] += 1
            self.pins[p] += 1

    def unpin_pages(self, ids) -> List[int]:
        """Drop pins on ``ids``; pages whose refcount hits zero are freed
        (generation bumped, prefix entries pruned) and returned for device
        zeroing — exactly ``release_slot``'s free path, minus the table."""
        freed = []
        for p in ids:
            p = int(p)
            assert self.pins[p] > 0, f"page {p} is not pinned"
            self.pins[p] -= 1
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.generation[p] += 1
                self._free.append(p)
                freed.append(p)
                for d in self._page_digests.pop(p, ()):
                    self._prefix.pop(d, None)
        return freed

    # ------------------------------------------------------------------
    # accounting / invariants
    # ------------------------------------------------------------------

    def check(self) -> None:
        """Assert the bookkeeping invariants the property tests lean on:
        refcounts == table reachability + pins, free list disjoint from
        the table and duplicate-free, every page accounted for."""
        counts = np.zeros(self.num_pages, np.int64)
        for p in self.table.ravel():
            if p >= 0:
                counts[p] += 1
        assert np.array_equal(counts + self.pins, self.refcount), (
            f"refcount drift: table+pins say "
            f"{(counts + self.pins).nonzero()[0]}, "
            f"refcount says {self.refcount.nonzero()[0]}"
        )
        assert np.all(self.pins >= 0), "negative pin count"
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        mapped = {int(p) for p in self.table.ravel() if p >= 0}
        mapped |= {int(p) for p in np.nonzero(self.pins)[0]}
        assert not (free & mapped), f"pages both free and mapped: {free & mapped}"
        assert len(free) + len(mapped) == self.num_pages, (
            "pages leaked: every page must be exactly one of free/mapped"
        )
        # the prefix index is pruned when a backing page is freed, so every
        # entry references live pages at their registration generation —
        # the index is bounded by live pages, not by prompts ever admitted
        for ntok, ids, gens in self._prefix.values():
            for p, g in zip(ids, gens):
                assert self.refcount[p] > 0 and self.generation[p] == g, (
                    f"prefix index holds freed page {p} ({ntok}-token entry)"
                )
