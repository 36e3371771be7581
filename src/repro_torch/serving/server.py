"""Async streaming front door over the continuous-batching Scheduler.

Counterpart of :mod:`repro.serving.server`, over the port's
:class:`~repro_torch.serving.scheduler.Scheduler`, with the same wire
protocol byte for byte.  ``launch/serve.py`` replays offline traces; real
traffic streams tokens, disconnects mid-flight, and carries SLO tiers.
This module is that front door, built on the standard library alone
(asyncio + json) beside numpy: the transport is swappable (the TCP layer
below is ~80 lines over the in-process core), and every test can drive it
without fixture servers.  It holds no device code: the Scheduler owns the
device, so the server runs on the card whenever its Scheduler does.

Three layers, all on ONE event loop (no locks — the scheduler's
bookkeeping is host-side Python, and the pump yields to clients between
device steps):

* :class:`AsyncServer` — the in-process core.  ``submit()`` wires a
  :class:`~repro_torch.serving.request.Request` onto the scheduler with its
  ``on_token``/``on_finish`` hooks bridged to an :class:`asyncio.Queue`;
  the :meth:`AsyncServer.run` pump drives ``Scheduler.step()`` while work
  is pending and sleeps on an event otherwise.  Client disconnect maps to
  ``Scheduler.cancel`` — slot evicted, pages decrefed/zeroed, survivors
  bit-exact (the cancellation fuzz oracle's contract).
* :class:`TokenStream` — one request's async iterator of generated token
  ids; ``cancel()`` is the disconnect path.
* :class:`ChatSession` + :meth:`AsyncServer.chat` — multi-turn sessions:
  each finished turn pins its written history's page-aligned prefix
  (``Request.keep_prefix_resident``) so the NEXT turn's prompt hits the
  sha1 prefix index and adopts the resident pages instead of
  re-prefilling them.  Closing the session unpins (and the pool drains
  back to zero — ``PageAllocator.check()`` holds throughout).

:class:`TCPFrontDoor` exposes the core over a real socket with a
newline-delimited JSON protocol (one request per connection; client EOF
mid-stream cancels server-side).  ``simulate_clients`` is the shared
harness behind the launchers' ``--server`` mode: tiered clients, a
deterministic subset of which disconnect mid-stream.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request, priority_rank
from repro_torch.serving.scheduler import Scheduler

_DONE = object()  # TokenStream sentinel: the request left the scheduler


class TokenStream:
    """Async iterator over one request's generated token ids.

    Tokens arrive as the scheduler's batched decode steps produce them
    (the ``on_token`` hook enqueues; iteration dequeues).  When the
    request finishes, is cancelled, or is shed, iteration stops and
    :attr:`request` holds the final :class:`Request` (check
    ``.cancelled`` / ``.shed`` to tell which exit it took).
    """

    def __init__(self, server: "AsyncServer", rid: int):
        self._server = server
        self.rid = rid
        self._q: asyncio.Queue = asyncio.Queue()
        self.request: Optional[Request] = None  # set at finish/cancel

    def _push(self, tok: int) -> None:
        self._q.put_nowait(tok)

    def _close(self, req: Request) -> None:
        self.request = req
        self._q.put_nowait(_DONE)

    def __aiter__(self) -> "TokenStream":
        """Return self (async-iterator protocol)."""
        return self

    async def __anext__(self) -> int:
        """Next generated token id; stops when the request exits."""
        item = await self._q.get()
        if item is _DONE:
            raise StopAsyncIteration
        return item

    async def cancel(self) -> None:
        """Client disconnect: evict the request server-side (slot freed,
        pages decrefed — shared pages survive for their other holders)
        and close the stream.  Idempotent; a no-op after finish."""
        self._server.cancel(self.rid)
        # the on_finish hook pushed the sentinel; yield so a same-task
        # iterator observes it
        await asyncio.sleep(0)


@dataclasses.dataclass
class ChatSession:
    """One multi-turn conversation: accumulated token history plus the
    page pins keeping that history's KV resident between turns."""

    sid: str
    history: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32)
    )
    pinned: Tuple[int, ...] = ()
    turns: int = 0


class AsyncServer:
    """In-process asyncio front door over one :class:`Scheduler`.

    Run :meth:`run` as a background task; ``submit``/``chat`` from any
    coroutine on the same loop.  The pump executes one blocking device
    step at a time and yields between steps, so submissions and
    cancellations interleave at step granularity — the same boundary the
    scheduler's host-side bookkeeping already assumes.
    """

    def __init__(self, scheduler: Scheduler, check_invariants: bool = False):
        self.sched = scheduler
        # per-step PageAllocator.check() — the leak gate the server tests
        # and the --server launcher smoke run with
        self.check_invariants = check_invariants
        self._rids = itertools.count()
        self._streams: Dict[int, TokenStream] = {}
        self.sessions: Dict[str, ChatSession] = {}
        self._closed = False
        self._work = asyncio.Event()
        self.steps_pumped = 0

    # ------------------------------------------------------------------
    # submission / streaming
    # ------------------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        priority: str = "interactive",
        eos_id: Optional[int] = None,
        deadline_steps: Optional[int] = None,
        forced_tokens=None,
        session_id: Optional[str] = None,
        arrival_step: Optional[int] = None,
    ) -> TokenStream:
        """Queue one request; returns its :class:`TokenStream`.

        ``priority`` is the SLO tier (``interactive`` preempts ``batch``
        chunked prefills and jumps the admission queue);
        ``deadline_steps`` sheds the request if still queued that many
        steps after arrival.  ``session_id`` routes through
        :meth:`chat` semantics: the prompt is prepended with the
        session's history and the finished turn's pages stay pinned for
        the next turn.  ``arrival_step`` defaults to the scheduler's
        current step (live traffic); trace replays pass their own.
        """
        priority_rank(priority)  # validate at the API boundary
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        session = None
        if session_id is not None:
            session = self.sessions.setdefault(
                session_id, ChatSession(sid=session_id)
            )
            prompt = np.concatenate([session.history, prompt])
        rid = next(self._rids)
        stream = TokenStream(self, rid)
        self._streams[rid] = stream

        def on_token(req: Request, tok: int) -> None:
            stream._push(tok)

        def on_finish(req: Request) -> None:
            if session is not None and not req.cancelled:
                self._advance_session(session, req)
            self._streams.pop(rid, None)
            stream._close(req)

        req = Request(
            rid=rid,
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            arrival_step=(self.sched.step_count if arrival_step is None
                          else int(arrival_step)),
            eos_id=eos_id,
            forced_tokens=forced_tokens,
            priority=priority,
            deadline_steps=deadline_steps,
            on_token=on_token,
            on_finish=on_finish,
            keep_prefix_resident=session is not None,
        )
        self.sched.submit(req)
        self._work.set()
        return stream

    def chat(self, session_id: str, user_tokens, max_new_tokens: int,
             **kw) -> TokenStream:
        """One conversation turn: ``user_tokens`` appended to the
        session's history becomes the prompt.  On a paged global-only
        layout, turn 2+ adopts the previous turns' pinned pages through
        the prefix index instead of re-prefilling the history."""
        return self.submit(user_tokens, max_new_tokens,
                           session_id=session_id, **kw)

    def _advance_session(self, session: ChatSession, req: Request) -> None:
        """Fold a finished turn into the session: history grows by the
        response, the new pin supersedes the old one (unpin after pin, so
        shared pages never transit refcount zero)."""
        session.history = np.concatenate([
            np.asarray(req.prompt, np.int32),
            np.asarray(req.generated, np.int32),
        ])
        old = session.pinned
        session.pinned = req.pinned_pages
        session.turns += 1
        if old:
            self.sched.unpin_pages(old)

    def cancel(self, rid: int) -> bool:
        """Evict request ``rid`` at any lifecycle state (queued /
        prefilling / decoding); returns False if it already exited."""
        return self.sched.cancel(rid)

    def close_session(self, session_id: str) -> None:
        """Drop a session's history pins; its pages (if nobody else
        shares them) are zeroed and returned to the free pool."""
        session = self.sessions.pop(session_id, None)
        if session is not None and session.pinned:
            self.sched.unpin_pages(session.pinned)

    # ------------------------------------------------------------------
    # pump / lifecycle
    # ------------------------------------------------------------------

    async def run(self) -> None:
        """Pump loop: drive ``Scheduler.step()`` while requests are
        pending, yield to clients between steps, park on an event when
        idle.  Ends after :meth:`close`."""
        while not self._closed:
            if self.sched.num_pending:
                self.sched.step()
                self.steps_pumped += 1
                if self.check_invariants and self.sched.pager is not None:
                    self.sched.pager.check()
                # step boundary: let clients submit / cancel / consume
                await asyncio.sleep(0)
            else:
                self._work.clear()
                await self._work.wait()

    async def drain(self) -> None:
        """Wait until every submitted request has exited the scheduler."""
        while self.sched.num_pending:
            await asyncio.sleep(0)

    def close(self) -> None:
        """Shut down: cancel everything still live, unpin every session,
        and stop the pump (after its current step)."""
        for rid in list(self._streams):
            self.sched.cancel(rid)
        for sid in list(self.sessions):
            self.close_session(sid)
        self._closed = True
        self._work.set()

    def stats(self) -> Dict:
        """Scheduler stats plus server-level columns."""
        out = self.sched.stats()
        out["server"] = {
            "steps_pumped": self.steps_pumped,
            "open_streams": len(self._streams),
            "open_sessions": len(self.sessions),
        }
        return out


# --------------------------------------------------------------------------
# TCP transport (newline-delimited JSON, one request per connection)
# --------------------------------------------------------------------------


class TCPFrontDoor:
    """Socket transport over an :class:`AsyncServer`.

    Protocol (newline-delimited JSON): the client sends one line ::

        {"prompt": [1, 2, 3], "max_new_tokens": 8,
         "priority": "interactive", "session": "abc"}

    and receives one ``{"token": t}`` line per generated token followed
    by ``{"done": true, "rid": r, "tokens": n, "cancelled": false}``.
    Client EOF (disconnect) before the stream ends cancels the request
    server-side — the slot is evicted and its pages are freed.
    """

    def __init__(self, server: AsyncServer, host: str = "127.0.0.1",
                 port: int = 0):
        self.server = server
        self.host = host
        self.port = port  # 0 = ephemeral; .start() fills the bound port
        self._tcp: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        """Bind and start accepting connections (port 0 = ephemeral)."""
        self._tcp = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._tcp.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        """Stop accepting and close the listening socket."""
        if self._tcp is not None:
            self._tcp.close()
            await self._tcp.wait_closed()
            self._tcp = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            spec = json.loads(line)
            stream = self.server.submit(
                np.asarray(spec["prompt"], np.int32),
                int(spec.get("max_new_tokens", 16)),
                priority=spec.get("priority", "interactive"),
                eos_id=spec.get("eos_id"),
                deadline_steps=spec.get("deadline_steps"),
                session_id=spec.get("session"),
            )
            # the client sends nothing after the request line, so a
            # completed read() means EOF: the client hung up
            gone = asyncio.ensure_future(reader.read())
            try:
                async for tok in stream:
                    if gone.done():
                        raise ConnectionResetError
                    writer.write(json.dumps({"token": int(tok)}).encode()
                                 + b"\n")
                    await writer.drain()
                req = stream.request
                writer.write(json.dumps({
                    "done": True, "rid": stream.rid,
                    "tokens": len(req.generated) if req else 0,
                    "cancelled": bool(req.cancelled) if req else False,
                }).encode() + b"\n")
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError, OSError):
                await stream.cancel()
            finally:
                gone.cancel()
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass


# --------------------------------------------------------------------------
# simulated clients (the --server launcher/benchmark harness)
# --------------------------------------------------------------------------


async def _simulated_client(server: AsyncServer, req: Request,
                            disconnect_after: Optional[int],
                            log: List[Dict]) -> None:
    """One simulated client: stream a request, optionally hang up after
    ``disconnect_after`` tokens (the mid-flight cancellation path)."""
    stream = server.submit(
        req.prompt, req.max_new_tokens, priority=req.priority,
        eos_id=req.eos_id, deadline_steps=req.deadline_steps,
        forced_tokens=req.forced_tokens, arrival_step=req.arrival_step,
    )
    got = []
    async for tok in stream:
        got.append(tok)
        if disconnect_after is not None and len(got) >= disconnect_after:
            await stream.cancel()
            break
    final = stream.request
    log.append({
        "rid": stream.rid, "priority": req.priority, "tokens": len(got),
        "disconnected": disconnect_after is not None
        and len(got) >= disconnect_after,
        "cancelled": bool(final.cancelled) if final else None,
    })


def simulate_clients(
    scheduler: Scheduler,
    requests: Sequence[Request],
    disconnect_every: int = 3,
    disconnect_after: int = 1,
    tier_cycle: Tuple[str, ...] = ("interactive", "batch"),
    check_invariants: bool = True,
) -> Dict:
    """Drive an :class:`AsyncServer` with simulated tiered, disconnecting
    clients — the ``--server`` mode of ``launch/serve.py`` and
    ``examples/serve_llm.py``.

    Every ``disconnect_every``-th client (1-based; 0 disables) hangs up
    after ``disconnect_after`` streamed tokens, exercising mid-flight
    cancellation; tiers rotate through ``tier_cycle``.  Requests keep
    their trace ``arrival_step``s (the scheduler clock gates admission).
    Returns ``server.stats()`` plus a ``clients`` log.
    """

    async def main() -> Dict:
        server = AsyncServer(scheduler, check_invariants=check_invariants)
        log: List[Dict] = []
        clients = []
        for i, req in enumerate(requests):
            req.priority = tier_cycle[i % len(tier_cycle)]
            cut = (disconnect_after if disconnect_every
                   and (i + 1) % disconnect_every == 0 else None)
            clients.append(_simulated_client(server, req, cut, log))
        pump = asyncio.ensure_future(server.run())
        await asyncio.gather(*clients)
        await server.drain()
        server.close()
        await pump
        stats = server.stats()
        stats["clients"] = sorted(log, key=lambda e: e["rid"])
        return stats

    return asyncio.run(main())
