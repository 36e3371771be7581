"""The port's async streaming front door: AsyncServer / ChatSession /
TCPFrontDoor / simulate_clients, on the CPU.

The port's version of ``tests/test_server.py`` (stdlib asyncio, ``asyncio.run``
inside sync test functions): each test drives the port's Scheduler on
phi4-mini-smoke (JAX-initialised parameters brought across with
``interop.params_from_numpy``), paged bf16 KV, chunk budget 6, with the
per-step ``PageAllocator.check`` leak gate armed, so every streaming /
cancel / session path is also a pool-hygiene proof.

Against the JAX package (``TestAgainstJax``): the same simulated clients
through the JAX ``AsyncServer`` (over a JAX ``Scheduler`` with no mesh) and
the port's, bf16 paged (greedy tokens identical, logits within 1e-4) and
bgpp paged (teacher-forced, logits within 1e-4 but where an 8-bit
attention weight rounds the other way, see :data:`TF_TOL`), with equal client logs and equal
step-counted stats; and one TCP exchange against both servers gives the
same JSON lines, byte for byte.  The entry points: the launcher's
``--server`` and ``examples/serve_llm``'s ``--server`` run in-process.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jax_config
from repro.models import model_zoo
from repro.serving import kv_cache as jkvc
from repro.serving import server as jserver
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.configs import get_config
from repro_torch.examples import serve_llm
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving import server as tserver
from repro_torch.serving.request import Request, poisson_trace
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.server import AsyncServer, TCPFrontDoor, simulate_clients

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "phi4-mini-3.8b"
MAX_SEQ = 64
PAGE_SIZE = 8
CHUNK_BUDGET = 6
# bgpp KV, teacher-forced: the int8 attend rounds each attention weight to
# an 8-bit code (A3), from f32 values the two packages compute ulps apart,
# so a code at a .5 boundary can round the other way.  On this trace one
# request's layer-1 attend at one decode step does (the stored K / V codes
# are equal on both sides): that row moves by 4.0e-4, the others stay
# within 1e-6.  5e-3 is the teacher-forced int8 / bgpp bar of
# tests/test_torch_zoo.py; a wrong lane, mask or scale moves a row by 1e-1.
TF_TOL = 5e-3


@pytest.fixture(scope="module")
def both():
    """The smoke model's JAX parameters and their copy on the port."""
    jcfg = jax_config(ARCH, smoke=True)
    jparams, _ = model_zoo.init(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, get_config(ARCH, smoke=True), params


@pytest.fixture(scope="module")
def served(both):
    return both[2], both[3]


def make_sched(cfg, params, slots=2, kv_format="bf16", record_logits=False):
    layout = kvc.layout_for(cfg, slots, MAX_SEQ, kv_format=kv_format,
                            layout="paged", page_size=PAGE_SIZE)
    return Scheduler(params, cfg, layout, device="cpu", admission="chunked",
                     chunk_budget=CHUNK_BUDGET, record_logits=record_logits)


def make_jax_sched(jcfg, jparams, slots=2, kv_format="bf16"):
    layout = jkvc.layout_for(jcfg, slots, MAX_SEQ, kv_format=kv_format,
                             layout="paged", page_size=PAGE_SIZE)
    return JScheduler(jparams, jcfg, layout, admission="chunked",
                      chunk_budget=CHUNK_BUDGET, record_logits=True)


def prompt_of(rng, cfg, n):
    return rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)


def drive(sched, body):
    """Run ``body(server)`` against a pumped AsyncServer; close + drain on
    the way out and verify the page pool ended empty."""

    async def main():
        server = AsyncServer(sched, check_invariants=True)
        pump = asyncio.ensure_future(server.run())
        try:
            return await body(server)
        finally:
            server.close()
            await pump
            sched.pager.check()
            assert sched.pager.pages_in_use == 0, "server leaked pages"

    return asyncio.run(main())


class TestStreaming:
    def test_tokens_stream_incrementally(self, served):
        cfg, params = served
        rng = np.random.default_rng(0)
        sched = make_sched(cfg, params)

        async def body(server):
            stream = server.submit(prompt_of(rng, cfg, 9), 4)
            toks = [t async for t in stream]
            assert len(toks) == 4
            req = stream.request
            assert req is not None and not req.cancelled
            assert toks == req.generated  # stream IS the generated sequence
            return server.stats()

        stats = drive(sched, body)
        assert stats["finished_requests"] == 1
        assert stats["server"]["open_streams"] == 0

    def test_two_streams_interleave(self, served):
        cfg, params = served
        rng = np.random.default_rng(1)
        sched = make_sched(cfg, params)

        async def body(server):
            s1 = server.submit(prompt_of(rng, cfg, 7), 5)
            s2 = server.submit(prompt_of(rng, cfg, 11), 3)
            r1, r2 = await asyncio.gather(
                asyncio.ensure_future(_collect(s1)),
                asyncio.ensure_future(_collect(s2)),
            )
            assert len(r1) == 5 and len(r2) == 3

        drive(sched, body)

    def test_invalid_priority_rejected_at_submit(self, served):
        cfg, params = served
        rng = np.random.default_rng(2)
        sched = make_sched(cfg, params)

        async def body(server):
            with pytest.raises(ValueError, match="priority"):
                server.submit(prompt_of(rng, cfg, 5), 2, priority="vip")

        drive(sched, body)


async def _collect(stream):
    return [t async for t in stream]


class TestCancellation:
    def test_cancel_mid_stream_spares_neighbor(self, served):
        """Disconnect one client after two tokens; the other stream must
        finish its full budget and the pool must drain."""
        cfg, params = served
        rng = np.random.default_rng(3)
        sched = make_sched(cfg, params)

        async def body(server):
            victim = server.submit(prompt_of(rng, cfg, 9), 32)
            other = server.submit(prompt_of(rng, cfg, 8), 6)
            got = []
            async for t in victim:
                got.append(t)
                if len(got) == 2:
                    await victim.cancel()
                    break
            assert victim.request.cancelled
            assert victim.request.cancel_state in ("prefilling", "decoding")
            survivor = await _collect(other)
            assert len(survivor) == 6
            return server.stats()

        stats = drive(sched, body)
        assert stats["cancelled_requests"] == 1
        assert stats["finished_requests"] == 1

    def test_cancel_while_queued(self, served):
        cfg, params = served
        rng = np.random.default_rng(4)
        sched = make_sched(cfg, params, slots=1)

        async def body(server):
            busy = server.submit(prompt_of(rng, cfg, 8), 8)
            queued = server.submit(prompt_of(rng, cfg, 8), 4)
            await queued.cancel()
            assert queued.request.cancelled
            assert queued.request.cancel_state == "queued"
            assert len(await _collect(queued)) == 0
            assert len(await _collect(busy)) == 8

        drive(sched, body)

    def test_deadline_shed_closes_stream(self, served):
        """A queued request whose SLO deadline lapses is shed: its stream
        ends with zero tokens and the shed flag set."""
        cfg, params = served
        rng = np.random.default_rng(5)
        sched = make_sched(cfg, params, slots=1)

        async def body(server):
            busy = server.submit(prompt_of(rng, cfg, 8), 12)
            doomed = server.submit(prompt_of(rng, cfg, 8), 4,
                                   deadline_steps=2)
            assert await _collect(doomed) == []
            assert doomed.request.shed
            assert len(await _collect(busy)) == 12
            return server.stats()

        stats = drive(sched, body)
        assert stats["shed_requests"] == 1

    def test_close_cancels_outstanding(self, served):
        cfg, params = served
        rng = np.random.default_rng(6)
        sched = make_sched(cfg, params)

        async def body(server):
            stream = server.submit(prompt_of(rng, cfg, 9), 48)
            async for _ in stream:
                break  # client walks away without cancelling
            server.close()
            # the close path cancelled it; the stream observes the end
            rest = await _collect(stream)
            assert stream.request is not None and stream.request.cancelled
            assert isinstance(rest, list)

        drive(sched, body)


class TestPriorities:
    def test_interactive_preempts_batch_prefill(self, served):
        """An interactive arrival one step after a long batch prompt
        started chunking steals the budget: the batch request records the
        preemption and the interactive one gets its first token first."""
        cfg, params = served
        rng = np.random.default_rng(7)
        sched = make_sched(cfg, params)

        async def body(server):
            batch = server.submit(prompt_of(rng, cfg, 20), 4,
                                  priority="batch")
            inter = server.submit(prompt_of(rng, cfg, 8), 3,
                                  priority="interactive", arrival_step=1)
            b, i = await asyncio.gather(
                asyncio.ensure_future(_collect(batch)),
                asyncio.ensure_future(_collect(inter)),
            )
            assert len(b) == 4 and len(i) == 3
            assert (inter.request.first_token_step
                    < batch.request.first_token_step)
            assert batch.request.preemptions >= 1
            return server.stats()

        stats = drive(sched, body)
        assert stats["preemptions"] >= 1
        tiers = stats["tiers"]
        assert tiers["batch"]["preemptions"] >= 1
        assert tiers["interactive"]["itl_s"]["p50"] is not None


class TestChatSessions:
    def test_second_turn_hits_prefix_index(self, served):
        """Turn 2's prompt (history + new user tokens) must adopt the
        pinned pages of turn 1's written history via the sha1 index, and
        closing the session must drain the pool."""
        cfg, params = served
        rng = np.random.default_rng(8)
        sched = make_sched(cfg, params)

        async def body(server):
            t1 = server.chat("s", prompt_of(rng, cfg, 17), 3)
            await _collect(t1)
            sess = server.sessions["s"]
            assert sess.turns == 1 and len(sess.pinned) >= 1
            # turn 1 wrote 17 + 3 - 1 = 19 KV positions -> 2 full pages
            assert len(sess.pinned) == 2
            assert t1.request.pinned_pages == sess.pinned

            t2 = server.chat("s", prompt_of(rng, cfg, 5), 3)
            toks = await _collect(t2)
            assert len(toks) == 3
            assert sched.prefix_hits >= 1
            assert t2.request.prefix_reused_tokens == 16  # both full pages
            # pin handoff: the new pin covers the grown history
            assert server.sessions["s"].pinned == t2.request.pinned_pages
            server.close_session("s")
            sched.pager.check()
            assert sched.pager.pages_in_use == 0

        drive(sched, body)

    def test_cancelled_turn_preserves_session(self, served):
        """A turn cancelled mid-stream must not advance the history or
        disturb the previous turn's pins."""
        cfg, params = served
        rng = np.random.default_rng(9)
        sched = make_sched(cfg, params)

        async def body(server):
            t1 = server.chat("s", prompt_of(rng, cfg, 17), 3)
            await _collect(t1)
            sess = server.sessions["s"]
            hist_len, pins = len(sess.history), sess.pinned

            t2 = server.chat("s", prompt_of(rng, cfg, 5), 16)
            async for _ in t2:
                await t2.cancel()
                break
            assert t2.request.cancelled
            assert len(sess.history) == hist_len and sess.pinned == pins
            server.close_session("s")

        drive(sched, body)


class TestTCPFrontDoor:
    def test_roundtrip_and_disconnect(self, served):
        """One client streams to completion over a real socket; a second
        hangs up mid-stream and must be cancelled server-side."""
        cfg, params = served
        rng = np.random.default_rng(10)
        sched = make_sched(cfg, params)

        async def body(server):
            door = TCPFrontDoor(server)
            await door.start()
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", door.port)
            writer.write(json.dumps({
                "prompt": prompt_of(rng, cfg, 9).tolist(),
                "max_new_tokens": 4, "priority": "batch",
            }).encode() + b"\n")
            await writer.drain()
            msgs = []
            while True:
                msg = json.loads(await reader.readline())
                msgs.append(msg)
                if msg.get("done"):
                    break
            writer.close()
            assert len(msgs) == 5  # 4 {"token": t} lines + the done line
            assert all("token" in m for m in msgs[:-1])
            assert msgs[-1]["done"] and msgs[-1]["tokens"] == 4
            assert not msgs[-1]["cancelled"]

            r2, w2 = await asyncio.open_connection("127.0.0.1", door.port)
            w2.write(json.dumps({
                "prompt": prompt_of(rng, cfg, 9).tolist(),
                "max_new_tokens": 32,
            }).encode() + b"\n")
            await w2.drain()
            await r2.readline()  # first streamed token
            w2.close()  # disconnect mid-stream
            for _ in range(500):
                await asyncio.sleep(0)
                if sched.cancelled:
                    break
            assert len(sched.cancelled) == 1
            await server.drain()
            await door.stop()
            return server.stats()

        stats = drive(sched, body)
        assert stats["cancelled_requests"] == 1
        assert stats["finished_requests"] == 1


class TestSimulatedClients:
    def test_harness_cancels_and_reports_tiers(self, served):
        """The --server launcher harness: tiered rotating clients, every
        3rd disconnecting after one token — at least one real cancel,
        both tiers in stats, pool drained."""
        cfg, params = served
        sched = make_sched(cfg, params)
        reqs = poisson_trace(np.random.default_rng(11), 6, cfg.vocab_size,
                             6, max_prompt=14)
        stats = simulate_clients(sched, reqs, disconnect_every=3,
                                 disconnect_after=1)
        assert stats["cancelled_requests"] >= 1
        assert {"interactive", "batch"} <= set(stats["tiers"])
        assert stats["paged"]["pages_in_use"] == 0
        assert len(stats["clients"]) == 6
        assert sum(c["disconnected"] for c in stats["clients"]) == 2


# --------------------------------------------------------------------------
# the port's front door against the JAX package's
# --------------------------------------------------------------------------


def _client_trace(cfg, seed, n=6, teacher_forced=False):
    """(prompt, max_new, arrival, forced) of ``n`` Poisson clients."""
    rng = np.random.default_rng(seed)
    out = []
    for r in poisson_trace(rng, n, cfg.vocab_size, 6, max_prompt=14):
        forced = (rng.integers(0, cfg.vocab_size, (r.max_new_tokens,)).astype(np.int32)
                  if teacher_forced else None)
        out.append((r.prompt, r.max_new_tokens, r.arrival_step, forced))
    return out


def _requests(trace, cls):
    return [cls(rid=i, prompt=p, max_new_tokens=n, arrival_step=a, forced_tokens=f)
            for i, (p, n, a, f) in enumerate(trace)]


def _step_counted(stats):
    """The stats that count steps, requests and bytes (no wall clock)."""
    out = {k: stats[k] for k in ("steps", "finished_requests", "decoded_tokens",
                                 "cancelled_requests", "shed_requests", "preemptions",
                                 "clients", "server")}
    out["kv_read"] = {k: stats["kv_read"][k]
                      for k in ("decode_bytes", "prefill_bytes", "decode_steps")}
    out["tiers"] = {t: {k: v[k] for k in ("finished", "cancelled", "shed", "preemptions")}
                    for t, v in stats["tiers"].items()}
    out["pages_in_use"] = stats["paged"]["pages_in_use"]
    return out


class TestAgainstJax:
    @pytest.mark.parametrize("kv_format", ["bf16", "bgpp"])
    def test_simulated_clients_match_jax(self, both, kv_format):
        """The same tiered, disconnecting clients through the JAX front door
        and the port's: bf16 greedy tokens identical, logits within 1e-4;
        bgpp teacher-forced, logits within 1e-4 but in the one request an
        8-bit weight flip reaches (within :data:`TF_TOL`); equal client logs
        and step-counted stats."""
        jcfg, jparams, cfg, params = both
        trace = _client_trace(cfg, 12, teacher_forced=kv_format != "bf16")
        jsched = make_jax_sched(jcfg, jparams, kv_format=kv_format)
        jstats = jserver.simulate_clients(jsched, _requests(trace, JRequest),
                                          disconnect_every=3, disconnect_after=2)
        tsched = make_sched(cfg, params, kv_format=kv_format, record_logits=True)
        tstats = simulate_clients(tsched, _requests(trace, Request),
                                  disconnect_every=3, disconnect_after=2)
        assert _step_counted(tstats) == _step_counted(jstats)
        assert tstats["cancelled_requests"] >= 1 and tstats["paged"]["pages_in_use"] == 0
        assert sum(c["disconnected"] for c in tstats["clients"]) == 2
        jreq = {r.rid: r for r in jsched.finished + jsched.cancelled}
        treq = {r.rid: r for r in tsched.finished + tsched.cancelled}
        assert sorted(treq) == sorted(jreq) == list(range(len(trace)))
        past = []
        for rid, j in jreq.items():
            t = treq[rid]
            assert t.generated == j.generated, rid
            assert (t.cancelled, t.cancel_state, t.preemptions) == (
                j.cancelled, j.cancel_state, j.preemptions), rid
            if j.logit_rows:
                err = float(np.abs(np.stack(t.logit_rows) - np.stack(j.logit_rows)).max())
                assert err <= (1e-4 if kv_format == "bf16" else TF_TOL), (rid, err)
                if err > 1e-4:
                    past.append(rid)
        # a flipped code moves only the request that holds it
        assert len(past) <= 1, past

    def test_tcp_wire_format_matches_jax(self, both):
        """One newline-JSON exchange against each package's TCPFrontDoor:
        the same lines, byte for byte (the tokens, then the done line)."""
        jcfg, jparams, cfg, params = both
        prompt = prompt_of(np.random.default_rng(13), cfg, 9)
        spec = {"prompt": prompt.tolist(), "max_new_tokens": 4, "priority": "batch"}

        def exchange(mod, sched):
            async def main():
                server = mod.AsyncServer(sched, check_invariants=True)
                pump = asyncio.ensure_future(server.run())
                door = mod.TCPFrontDoor(server)
                await door.start()
                reader, writer = await asyncio.open_connection("127.0.0.1", door.port)
                writer.write(json.dumps(spec).encode() + b"\n")
                await writer.drain()
                lines = []
                while not lines or not json.loads(lines[-1]).get("done"):
                    lines.append(await reader.readline())
                writer.close()
                await door.stop()
                server.close()
                await pump
                return lines

            return asyncio.run(main())

        jlines = exchange(jserver, make_jax_sched(jcfg, jparams))
        tsched = make_sched(cfg, params)
        tlines = exchange(tserver, tsched)
        assert tlines == jlines
        assert len(tlines) == 5 and tlines[-1].endswith(b"\n")
        assert json.loads(tlines[-1]) == {"done": True, "rid": 0, "tokens": 4,
                                          "cancelled": False}
        assert tsched.pager.pages_in_use == 0


# --------------------------------------------------------------------------
# the entry points' --server mode, in-process
# --------------------------------------------------------------------------


def _well_formed(stats):
    json.dumps(stats)
    assert stats["cancelled_requests"] >= 1
    assert stats["paged"]["pages_in_use"] == 0
    assert stats["server"]["open_streams"] == 0 and stats["server"]["open_sessions"] == 0
    for tier in stats["tiers"].values():
        assert tier["finished"] + tier["cancelled"] >= 1


def test_launcher_server_mode(tmp_path, capsys):
    out = tmp_path / "trace.json"
    stats = launcher.main(["--device", "cpu", "--server", "--kv-layout", "paged",
                           "--kv-format", "bf16", "--requests", "6", "--max-new", "6",
                           "--disconnect-every", "3", "--disconnect-after", "1",
                           "--trace-out", str(out)])
    _well_formed(stats)
    assert {"interactive", "batch"} <= set(stats["tiers"])
    assert len(stats["clients"]) == 6 and sum(c["disconnected"] for c in stats["clients"]) == 2
    printed = capsys.readouterr().out
    assert "[serve] server: cancelled=" in printed and "[serve] tier interactive:" in printed
    config = json.loads(out.read_text())["config"]
    assert (config["server"], config["disconnect_every"], config["disconnect_after"]) == (
        True, 3, 1)


def test_serve_llm_server_demo(capsys):
    stats = serve_llm.main(["--device", "cpu", "--server", "--kv-layout", "paged"])
    _well_formed(stats)
    assert stats["preemptions"] >= 1 and stats["paged"]["prefix_hits"] >= 1
    printed = capsys.readouterr().out
    assert "history tokens from the prefix index" in printed
    assert "cancelled while decoding" in printed
