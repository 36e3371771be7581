"""Eager (whole-prompt) admission of the port against the JAX package's.

The port's ``Scheduler(admission="eager")`` admits each prompt with one
``engine.prefill_into_slot`` (a B=1 ``transformer.forward``, whose
attention is ``flash_attention``'s plain version on CPU tensors) and runs
the same batched decode as chunked admission.  Same ``phi4-mini-smoke``
parameters (JAX-initialised) and trace on both sides; the JAX
``Scheduler`` runs with no mesh, as ``tests/test_scheduler.py`` drives it.

Tolerances (f32 smoke config; torch and XLA sum in other orders):
  * identical greedy tokens in every {slot, paged} x {bf16, int8, bgpp}
    cell, per-step logits within 1e-4 (measured <= 5.7e-7).  With int8 /
    bgpp KV a prompt value within an ulp of a .5 boundary could quantise
    to the other code and move the logits by ~1e-2; this trace has none,
    so a flip there means the K/V that feed the quantiser went wrong.
  * ``stats()``: ``admission``, ``max_prefill_tokens_per_step`` and the
    ``weight_read`` bytes equal, exactly.
  * eager against chunked admission in the port, teacher-forced, bf16 KV:
    logits within 1e-4 (the reference's own test allows 5e-3; the two
    paths are the same math with other reduction orders).
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

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.serving import kv_cache as tkvc
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Scheduler

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "phi4-mini-3.8b"
SLOTS, MAX_SEQ, PAGE = 2, 64, 8
FORMATS = ["bf16", "int8", "bgpp"]
LAYOUTS = ["slot", "paged"]
WEIGHT_KEYS = ("weight_format", "decode_bytes", "prefill_bytes", "decode_steps",
               "decode_bytes_per_step")


@pytest.fixture(scope="module")
def served():
    jcfg = jax_config(ARCH, smoke=True)
    jparams, _ = model_zoo.init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, get_config(ARCH, smoke=True), jparams, tparams


def _prompts(seed=0, lens=(9, 13, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (n,)).astype(np.int32) for n in lens]


def _run_torch(served, fmt, layout, prompts, admission="eager", forced=None, max_new=4):
    _, cfg, _, params = served
    lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    sched = Scheduler(params, cfg, lay, device="cpu", admission=admission, chunk_budget=8,
                      record_logits=True)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=max_new, arrival_step=i,
                             forced_tokens=None if forced is None else np.asarray(forced[i])))
    stats = sched.run(max_steps=500)
    return sched, stats, {r.rid: r for r in sched.finished}


def _run_jax(served, fmt, layout, prompts, max_new=4):
    jcfg, _, jparams, _ = served
    lay = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    sched = JScheduler(jparams, jcfg, lay, admission="eager", record_logits=True)
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
    def test_eager_scheduler_matches_jax(self, served, fmt, layout):
        prompts = _prompts()
        jstats, jreq = _run_jax(served, fmt, layout, prompts)
        sched, tstats, treq = _run_torch(served, fmt, layout, prompts)
        assert sorted(treq) == sorted(jreq) == [0, 1, 2]
        for i in jreq:
            assert treq[i].generated == jreq[i].generated, i
        assert _max_logit_diff(jreq, treq) <= 1e-4
        assert tstats["admission"] == jstats["admission"] == "eager"
        assert (tstats["max_prefill_tokens_per_step"]
                == jstats["max_prefill_tokens_per_step"] >= 13)
        for key in WEIGHT_KEYS:
            assert tstats["weight_read"][key] == jstats["weight_read"][key], key
        assert tstats["weight_read"]["prefill_bytes"] > 0
        assert tstats["steps"] == jstats["steps"]
        if layout == "paged":
            sched.pager.check()
            assert tstats["paged"]["pages_in_use"] == 0
            assert tstats["paged"]["prefix_hits"] == 0  # a chunked-admission feature


class TestPortInvariants:
    def test_eager_matches_chunked_admission(self, served):
        """Teacher-forced, so both paths decode the same tokens."""
        prompts = _prompts(seed=1, lens=(9, 14))
        rng = np.random.default_rng(2)
        forced = {i: rng.integers(0, 512, (4,)).astype(np.int32) for i in range(2)}
        _, _, chunked = _run_torch(served, "bf16", "slot", prompts, "chunked", forced)
        _, _, eager = _run_torch(served, "bf16", "slot", prompts, "eager", forced)
        for i in chunked:
            assert eager[i].generated == chunked[i].generated == list(forced[i])
        assert _max_logit_diff(chunked, eager) <= 1e-4

    def test_eager_builds_no_chunk_engine(self, served):
        sched, stats, _ = _run_torch(served, "int8", "paged", _prompts(seed=3, lens=(5,)))
        assert sched.chunked is None and stats["finished_requests"] == 1

    def test_unknown_admission_raises(self, served):
        _, cfg, _, params = served
        with pytest.raises(ValueError, match="admission"):
            Scheduler(params, cfg, tkvc.layout_for(cfg, SLOTS, MAX_SEQ), device="cpu",
                      admission="lazy")

    def test_launcher_eager(self, capsys):
        launcher.main(["--device", "cpu", "--kv-format", "bf16", "--kv-layout", "paged",
                       "--admission", "eager", "--requests", "3", "--max-new", "3"])
        out = capsys.readouterr().out
        assert "admission=eager" in out and "pages_in_use=0" in out
