"""The port's serving slice against the JAX package's, end to end on CPU.

Same ``phi4-mini-smoke`` parameters (JAX-initialised, brought across with
``interop.params_from_numpy``), same request trace; the JAX ``Scheduler``
(no mesh, the way ``tests/test_scheduler.py`` drives it) against the
port's ``Scheduler(device="cpu")`` in the six {slot, paged} x {bf16, int8,
bgpp} cells.

Tolerances (smoke config is float32; torch and XLA sum in other orders):
  * bf16 format: greedy tokens identical, per-step logits within 1e-4.
  * int8 / bgpp: teacher-forced with the JAX tokens (no greedy
    compounding), logits within 1e-4 — the integer dots are exact, the
    float rescales and softmax sums differ by ulps (measured ~1e-6); a
    flipped int8 code would show as ~1e-2 and fail.
  * the same ``stats()["kv_read"]`` bytes, exactly.
Plus the port's own invariants: chunked == whole-prompt admission, joint
== alone, slot == paged, cancellation and eviction leak no page.
"""

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jax_config
from repro.models import model_zoo
from repro.serving import kv_cache as jkvc
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.interop import params_from_numpy
from repro_torch.serving import engine, kv_cache as tkvc
from repro_torch.serving.request import Request, SlotState
from repro_torch.serving.scheduler import Scheduler

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "phi4-mini-3.8b"
SLOTS, MAX_SEQ, PAGE, BUDGET = 2, 64, 8, 8
FORMATS = ["bf16", "int8", "bgpp"]
LAYOUTS = ["slot", "paged"]


@pytest.fixture(scope="module")
def served():
    jcfg = jax_config(ARCH, smoke=True)
    jparams, _ = model_zoo.init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, get_config(ARCH, smoke=True), jparams, tparams


def _prompts(seed=0, lens=(9, 13, 6), prefix=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 512, (prefix,)).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, 512, (n,)).astype(np.int32)])
            for n in lens]


def _run_torch(served, fmt, layout, prompts, max_new=4, forced=None, stagger=1,
               record_logits=True):
    _, cfg, _, params = served
    lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    sched = Scheduler(params, cfg, lay, device="cpu", chunk_budget=BUDGET,
                      record_logits=record_logits)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=max_new, arrival_step=i * stagger,
                             forced_tokens=None if forced is None else np.asarray(forced[i])))
    stats = sched.run(max_steps=500)
    return sched, stats, {r.rid: r for r in sched.finished}


def _run_jax(served, fmt, layout, prompts, max_new=4):
    jcfg, _, jparams, _ = served
    lay = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    sched = JScheduler(jparams, jcfg, lay, chunk_budget=BUDGET, record_logits=True)
    for i, p in enumerate(prompts):
        sched.submit(JRequest(rid=i, prompt=p, max_new_tokens=max_new, arrival_step=i))
    stats = sched.run(max_steps=500)
    return stats, {r.rid: r for r in sched.finished}


def _max_logit_diff(a, b):
    return max(float(np.abs(np.stack(a[i].logit_rows) - np.stack(b[i].logit_rows)).max())
               for i in a)


class TestAgainstJax:
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_scheduler_matches_jax(self, served, fmt, layout):
        prompts = _prompts()
        jstats, jreq = _run_jax(served, fmt, layout, prompts)
        forced = None if fmt == "bf16" else {i: r.generated for i, r in jreq.items()}
        _, tstats, treq = _run_torch(served, fmt, layout, prompts, forced=forced)
        assert sorted(treq) == sorted(jreq)
        for i in jreq:
            assert treq[i].generated == jreq[i].generated, i
        assert _max_logit_diff(jreq, treq) <= 1e-4
        for key in ("decode_bytes", "prefill_bytes", "decode_steps",
                    "decode_bytes_per_step", "decode_bf16_equiv_bytes_per_step"):
            assert tstats["kv_read"][key] == jstats["kv_read"][key], key
        if fmt == "bgpp":
            assert tstats["kv_read"]["bgpp"] == jstats["kv_read"]["bgpp"]
        assert tstats["steps"] == jstats["steps"]
        assert tstats["finished_requests"] == jstats["finished_requests"]

    def test_paged_prefix_reuse_matches_jax(self, served):
        """Shared system prompt: the same prefix hits, the same tokens."""
        prompts = _prompts(seed=3, lens=(5, 7, 4), prefix=16)
        jstats, jreq = _run_jax(served, "int8", "paged", prompts)
        _, tstats, treq = _run_torch(served, "int8", "paged", prompts)
        assert tstats["paged"]["prefix_hits"] == jstats["paged"]["prefix_hits"] > 0
        assert tstats["paged"]["prefix_hit_tokens"] == jstats["paged"]["prefix_hit_tokens"]
        assert tstats["paged"]["pages_allocated_total"] == jstats["paged"]["pages_allocated_total"]
        for i in jreq:
            assert treq[i].generated == jreq[i].generated


class TestPortInvariants:
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_chunked_equals_whole_prompt(self, served, fmt):
        _, cfg, _, params = served
        prompt = _prompts(seed=4, lens=(27,))[0]
        out = []
        for max_chunk in (4, 16):
            lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format=fmt)
            cp = engine.ChunkedPrefill(cfg, lay, buckets=(4, 16, 32))
            cache = tkvc.init_cache_arrays(cfg, lay, device="cpu")
            logits, cache = cp.admit(params, cache, 1, prompt, max_chunk=max_chunk)
            assert cp.num_compiles <= len(cp.buckets)
            assert int(cache["pos"][1]) == len(prompt)
            out.append(logits)
        torch.testing.assert_close(out[0], out[1], rtol=0, atol=1e-5)

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_joint_equals_alone(self, served, fmt):
        prompts = _prompts(seed=5)
        _, _, joint = _run_torch(served, fmt, "paged", prompts)
        for i, p in enumerate(prompts):
            _, _, alone = _run_torch(served, fmt, "paged", [p])
            assert alone[0].generated == joint[i].generated
            np.testing.assert_allclose(np.stack(alone[0].logit_rows),
                                       np.stack(joint[i].logit_rows), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_slot_equals_paged(self, served, fmt):
        prompts = _prompts(seed=6, lens=(11, 4, 17, 8))
        _, _, slot = _run_torch(served, fmt, "slot", prompts, max_new=5)
        _, _, paged = _run_torch(served, fmt, "paged", prompts, max_new=5)
        for i in slot:
            assert slot[i].generated == paged[i].generated
        assert _max_logit_diff(slot, paged) <= 1e-5

    def test_cancel_and_eviction_leak_no_page(self, served):
        prompts = _prompts(seed=7, lens=(20, 9, 14), prefix=8)
        _, cfg, _, params = served
        lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bgpp", layout="paged",
                              page_size=PAGE)
        sched = Scheduler(params, cfg, lay, device="cpu", chunk_budget=4)
        for i, p in enumerate(prompts):
            sched.submit(Request(rid=i, prompt=p, max_new_tokens=6, arrival_step=0))
        sched.step()  # rid 0 mid-prefill
        assert sched.cancel(0)
        sched.pager.check()
        for _ in range(6):
            sched.step()
            sched.pager.check()
        live = [s.request.rid for s in sched.slots if s.state is SlotState.DECODING]
        if live:
            assert sched.cancel(live[0])
        sched.run(max_steps=200)
        sched.pager.check()
        assert sched.pager.pages_in_use == 0
        assert not sched.cancel(99)
        stats = sched.stats()
        assert stats["cancelled_requests"] >= 1
        assert stats["finished_requests"] + stats["cancelled_requests"] == len(prompts)

    def test_priority_and_deadline(self, served):
        prompts = _prompts(seed=8, lens=(12, 12, 6, 5))
        _, cfg, _, params = served
        lay = tkvc.layout_for(cfg, 1, MAX_SEQ, kv_format="int8")
        sched = Scheduler(params, cfg, lay, device="cpu", chunk_budget=4)
        sched.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=3, priority="batch"))
        sched.submit(Request(rid=1, prompt=prompts[1], max_new_tokens=3, arrival_step=0,
                             priority="interactive"))
        sched.submit(Request(rid=2, prompt=prompts[2], max_new_tokens=3, arrival_step=0,
                             deadline_steps=1))
        stats = sched.run(max_steps=200)
        assert [r.rid for r in sched.finished][0] == 1  # interactive first
        assert stats["shed_requests"] == 1 and sched.cancelled[0].rid == 2


class TestRefusals:
    def test_later_slices_raise(self, served):
        _, cfg, _, params = served
        lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ)
        # a mesh serves the dense, MoE and VLM families: an MoE Scheduler on a
        # 1x1 mesh (a gloo world of one) builds; the ssm, hybrid and enc_dec
        # families take a mesh through make_serve_step, and the Scheduler
        # refuses them as it does on one device
        from repro_torch.launch import mesh as launch_mesh
        from repro_torch.models import model_zoo as tzoo

        moe_cfg = get_config("mixtral-8x22b", smoke=True)
        moe_params = tzoo.init(moe_cfg, torch.Generator().manual_seed(0), "cpu")
        _, mesh_rules, started = launch_mesh.start_mesh(1, 1, torch.device("cpu"))
        try:
            sched = Scheduler(moe_params, moe_cfg, tkvc.layout_for(moe_cfg, SLOTS, MAX_SEQ),
                              device="cpu", rules=mesh_rules)
            assert sched.shard is not None and sched.mesh_shape == (1, 1)
        finally:
            launch_mesh.stop_mesh(started)
        rules = ShardingRules(mesh={"data": 1, "model": 1})
        for arch in ("mamba2-1.3b", "jamba-1.5-large-398b", "whisper-medium"):
            other = get_config(arch, smoke=True)
            with pytest.raises(ValueError, match="decodes through make_serve_step directly"):
                Scheduler(params, other, tkvc.layout_for(other, SLOTS, MAX_SEQ), device="cpu",
                          rules=rules)
        # speculative decoding is ported: the call that raised now builds
        assert Scheduler(params, cfg, lay, device="cpu", spec_decode=True).spec.enabled

    def test_cuda_request_raises_without_a_card(self, served):
        if torch.cuda.is_available():
            pytest.skip("this host has a card; the refusal is for hosts without one")
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        _, cfg, _, params = served
        with pytest.raises(RuntimeError, match="cuda"):
            Scheduler(params, cfg, tkvc.layout_for(cfg, SLOTS, MAX_SEQ))

    def test_prompt_must_fit(self, served):
        _, cfg, _, params = served
        sched = Scheduler(params, cfg, tkvc.layout_for(cfg, SLOTS, MAX_SEQ), device="cpu")
        with pytest.raises(ValueError, match="prompt_len"):
            sched.submit(Request(rid=0, prompt=np.zeros(MAX_SEQ, np.int32), max_new_tokens=1))
