"""Bit-plane speculative decoding on the port against the JAX package's.

CPU, smoke size.  Held bit-exact against JAX: the truncated-plane draft
weights (planes 1-8, f32 and bf16 leaves, and the whole smoke tree), the
allocator rollback ``rewind_slot`` (table, refcounts, generations, free
list, prefix index), the rollback scrub ``zero_token_range`` (slot and
paged, every KV format and leaf), and the Scheduler's tokens and
``stats()["spec"]`` with injected perfect and adversarial drafts and with
truncated-plane drafts (each round's draft tokens too).  Then the port's
own laws, as the reference's tests state them: the accounting laws of the
spec counters (``tests/test_properties.py``, ``TestSpecDecodeAccountingLaws``)
and the dense cases of the fuzz's spec axis (``tests/test_serving_fuzz.py``):
a speculative joint run equals non-speculative alone runs — greedy bf16
logits bit-identical, teacher-forced int8 / bgpp within 1e-5 — with
``PageAllocator.check()`` after every step and no page leaked.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import model_zoo
from repro.serving import kv_cache as jkvc
from repro.serving import spec_decode as jspd
from repro.serving.paging import PageAllocator as JPageAllocator
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.configs import MCBPOptions, apply_spec_decode_overrides, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.serving import kv_cache as tkvc
from repro_torch.serving import spec_decode as tspd
from repro_torch.serving.paging import PageAllocator
from repro_torch.serving.request import Request, SlotState
from repro_torch.serving.scheduler import Scheduler

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "phi4-mini-3.8b"
FORMATS = ["bf16", "int8", "bgpp"]
LAYOUTS = ["slot", "paged"]


@pytest.fixture(scope="module")
def served():
    """The smoke model (f32), JAX-initialised and brought across."""
    jcfg = jax_config(ARCH, smoke=True)
    jparams, _ = model_zoo.init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, get_config(ARCH, smoke=True), jparams, tparams


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# --------------------------------------------------------------------------
# the draft weights
# --------------------------------------------------------------------------


class TestTruncatePlaneParams:
    @pytest.mark.parametrize("planes", range(1, 9))
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bit_exact_against_jax(self, planes, dtype):
        rng = np.random.default_rng(planes)
        arrays = {"w": rng.normal(size=(3, 40, 24)).astype(np.float32) * 0.05,
                  "tiny": rng.normal(size=(17,)).astype(np.float32) * 1e-6,
                  "ties": (rng.integers(-127, 128, (64,)) / 127 * 0.75 + 1.0 / 254)
                  .astype(np.float32)}
        jt = {n: jnp.asarray(a, getattr(jnp, dtype)) for n, a in arrays.items()}
        jt["ids"] = jnp.arange(5, dtype=jnp.int32)
        tt = {n: torch.from_numpy(a).to(getattr(torch, dtype)) for n, a in arrays.items()}
        tt["ids"] = torch.arange(5, dtype=torch.int32)
        jout = jspd.truncate_plane_params(jt, planes)
        tout = tspd.truncate_plane_params(tt, planes)
        assert set(tout) == set(jout)
        for n in arrays:
            assert tout[n].dtype == tt[n].dtype and tout[n].shape == tt[n].shape
            want = np.asarray(jout[n].astype(jnp.float32))
            np.testing.assert_array_equal(_bits(tout[n].float().numpy()), _bits(want),
                                          err_msg=f"{n} planes={planes} {dtype}")
        assert torch.equal(tout["ids"], tt["ids"])
        if planes >= 7:
            assert tout is tt  # all of int8 kept: the tree itself
        else:
            assert all(not torch.equal(tout[n], tt[n]) for n in ("w", "ties"))

    def test_smoke_tree_bit_exact_against_jax(self, served):
        _, _, jparams, tparams = served
        jout = dict(_leaves(jspd.truncate_plane_params(jparams, 4)))
        tout = dict(_leaves(tspd.truncate_plane_params(tparams, 4)))
        assert set(tout) == set(jout)
        for n, t in tout.items():
            np.testing.assert_array_equal(_bits(t.numpy()), _bits(np.asarray(jout[n])),
                                          err_msg=n)
        # the caller's tree is left as it was
        jleaves = dict(_leaves(jparams))
        for n, t in _leaves(tparams):
            assert torch.equal(t, torch.from_numpy(np.array(jleaves[n])))

    def test_rejects_plane_counts(self):
        for p in (0, 9):
            with pytest.raises(ValueError, match="draft_planes"):
                tspd.truncate_plane_params({"w": torch.ones(2)}, p)


# --------------------------------------------------------------------------
# the knobs
# --------------------------------------------------------------------------


class TestResolve:
    def test_argument_then_config(self):
        cfg = get_config(ARCH, smoke=True)
        assert tspd.resolve(cfg) == tspd.SpecConfig(False, 4, 4, "config")
        on = apply_spec_decode_overrides(cfg, enabled=True, gamma=2, planes=6)
        assert tspd.resolve(on) == tspd.SpecConfig(True, 2, 6, "config")
        assert tspd.resolve(on, enabled=False, gamma=3, planes=8) == \
            tspd.SpecConfig(False, 3, 8, "kwarg")
        assert apply_spec_decode_overrides(cfg) is cfg

    def test_knob_checks_match_jax(self):
        jcfg, tcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
        for kw in ({"gamma": 0}, {"planes": 0}, {"planes": 9}):
            for mod, cfg in ((jspd, jcfg), (tspd, tcfg)):
                with pytest.raises(ValueError, match="draft_"):
                    mod.resolve(cfg, enabled=True, **kw)
        for kw in ({"draft_gamma": 0}, {"draft_planes": 9}):
            with pytest.raises(ValueError, match="draft_"):
                MCBPOptions(**kw)
        for g in (1, 4):
            for p in (1, 7, 8):
                j = jspd.resolve(jcfg, enabled=True, gamma=g, planes=p)
                t = tspd.resolve(tcfg, enabled=True, gamma=g, planes=p)
                assert (j.enabled, j.gamma, j.planes, j.source) == \
                    (t.enabled, t.gamma, t.planes, t.source)

    def test_environment_changes_nothing(self, served, monkeypatch):
        _, cfg, _, params = served
        before = tspd.resolve(cfg)
        monkeypatch.setenv("REPRO_SPEC_DECODE", "on")
        monkeypatch.setenv("REPRO_DRAFT_GAMMA", "7")
        monkeypatch.setenv("REPRO_DRAFT_PLANES", "2")
        assert tspd.resolve(cfg) == before
        sched = Scheduler(params, cfg, tkvc.layout_for(cfg, 2, 32, kv_format="bf16"),
                          device="cpu")
        assert sched.spec == before and sched.draft_params is None
        assert "spec" not in sched.stats()

    def test_validate_refuses_local_layers(self):
        cfg = get_config(ARCH, smoke=True)
        spec = tspd.resolve(cfg, enabled=True)
        lay = tkvc.layout_for(cfg, 2, 32, kv_format="bf16")
        assert tspd.validate(cfg, lay, spec) is spec
        ring = dataclasses.make_dataclass("Ring", [("local_layers", tuple)])((1, 3))
        with pytest.raises(ValueError, match="rollback-safe"):
            tspd.validate(cfg, ring, spec)
        assert tspd.validate(cfg, ring, dataclasses.replace(spec, enabled=False)).enabled \
            is False


# --------------------------------------------------------------------------
# the rollback: allocator and scrub
# --------------------------------------------------------------------------


def _pagers(batch=3, max_seq=32, page=8, num_pages=None):
    jcfg, tcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    kw = dict(kv_format="int8", layout="paged", page_size=page, num_pages=num_pages)
    return (JPageAllocator(jkvc.layout_for(jcfg, batch, max_seq, **kw)),
            PageAllocator(tkvc.layout_for(tcfg, batch, max_seq, **kw)))


def _assert_pagers_equal(j, t):
    for name in ("table", "refcount", "generation", "pins", "_registered"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert t._free == j._free
    assert t._prefix == j._prefix
    assert t._page_digests == j._page_digests
    assert (t.alloc_count, t.peak_pages, t.pages_in_use) == \
        (j.alloc_count, j.peak_pages, j.pages_in_use)
    t.check()


def _both(pagers, op, *a):
    out = [getattr(p, op)(*a) for p in pagers]
    assert out[0] == out[1], (op, a, out)
    _assert_pagers_equal(*pagers)
    return out[1]


class TestRewindSlot:
    def test_frontier_page_deregisters_its_digests(self):
        """tests/test_paging.py's cross-page rollback case: keep 10 of 24
        tokens — page 2 frees, page 1 (the frontier) stays mapped and loses
        its 16- and 24-token digests, page 0's survives."""
        pagers = _pagers()
        prompt = np.arange(24, dtype=np.int32)
        _both(pagers, "ensure_range", 0, 0, 24)
        _both(pagers, "register_prefix", 0, prompt, 24)
        probe = np.concatenate([prompt, [99]]).astype(np.int32)
        _, ids = _both(pagers, "lookup_prefix", probe)
        freed = _both(pagers, "rewind_slot", 0, 10)
        assert freed == [int(ids[2])]
        n, hit = _both(pagers, "lookup_prefix", probe)
        assert n == 8 and list(hit) == [int(ids[0])]

    def test_page_aligned_and_full_rewinds(self):
        pagers = _pagers()
        prompt = np.arange(24, dtype=np.int32)
        probe = np.concatenate([prompt, [99]]).astype(np.int32)
        _both(pagers, "ensure_range", 0, 0, 24)
        _both(pagers, "register_prefix", 0, prompt, 24)
        assert len(_both(pagers, "rewind_slot", 0, 16)) == 1
        assert _both(pagers, "lookup_prefix", probe)[0] == 16
        assert len(_both(pagers, "rewind_slot", 0, 0)) == 2
        assert _both(pagers, "lookup_prefix", probe) == (0, ())
        _both(pagers, "ensure_range", 1, 0, 16)  # same pages, new generation
        assert _both(pagers, "lookup_prefix", probe) == (0, ())
        _both(pagers, "ensure_range", 0, 0, 16)
        _both(pagers, "register_prefix", 0, prompt, 16)
        assert _both(pagers, "lookup_prefix", probe)[0] == 16

    def test_shared_frontier_refused_like_jax(self):
        pagers = _pagers()
        prompt = np.arange(24, dtype=np.int32)
        _both(pagers, "ensure_range", 0, 0, 24)
        _both(pagers, "register_prefix", 0, prompt, 24)
        _, ids = _both(pagers, "lookup_prefix", np.concatenate([prompt, [99]]).astype(np.int32))
        _both(pagers, "adopt_prefix", 1, ids)
        for p in pagers:
            with pytest.raises(AssertionError, match="shared page"):
                p.rewind_slot(0, 12)
        _both(pagers, "rewind_slot", 0, 24)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_speculative_sequences(self, seed):
        """Random rounds as the scheduler makes them — map ahead of the
        frontier, register prompt prefixes, rewind to an accepted frontier,
        pins, releases — with equal state after every call."""
        rng = np.random.default_rng(seed)
        pagers = _pagers(batch=3, max_seq=48, page=4, num_pages=40)
        front = [0, 0, 0]
        prompts = [rng.integers(0, 50, (48,)).astype(np.int32) for _ in range(3)]
        for _ in range(60):
            s = int(rng.integers(0, 3))
            op = rng.random()
            if op < 0.45:
                hi = min(front[s] + int(rng.integers(1, 6)), 48)
                _both(pagers, "ensure_range", s, front[s], hi)
                _both(pagers, "register_prefix", s, prompts[s], hi)
                keep = int(rng.integers(front[s], hi + 1))
                _both(pagers, "rewind_slot", s, keep)
                front[s] = keep
            elif op < 0.6 and front[s] >= 4:
                ids = tuple(int(p) for p in pagers[1].table[s, :front[s] // 4])
                _both(pagers, "pin_pages", ids)
                _both(pagers, "unpin_pages", ids)
            elif op < 0.75:
                _both(pagers, "release_slot", s)
                front[s] = 0
            else:
                _both(pagers, "lookup_prefix", prompts[int(rng.integers(0, 3))][:int(
                    rng.integers(2, 48))])


def _filled_stores(fmt, layout, seed):
    """The same random store in JAX and in the port (every leaf non-zero)."""
    jcfg, tcfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    kw = dict(kv_format=fmt, layout=layout, page_size=8)
    jl, tl = jkvc.layout_for(jcfg, 3, 32, **kw), tkvc.layout_for(tcfg, 3, 32, **kw)
    jc, tc = jkvc.init_cache_arrays(jcfg, jl), tkvc.init_cache_arrays(tcfg, tl, device="cpu")
    rng = np.random.default_rng(seed)
    for n in tc["global"]:
        a = tc["global"][n]
        if a.dtype == torch.uint8:
            v = rng.integers(1, 256, a.shape).astype(np.uint8)
        elif a.dtype == torch.int8:
            v = rng.integers(1, 128, a.shape).astype(np.int8)
        else:
            v = rng.random(a.shape).astype(np.float32) + 0.5
        jc["global"][n] = jnp.asarray(v, jc["global"][n].dtype)
        tc["global"][n] = torch.from_numpy(np.array(jc["global"][n].astype(jnp.float32))
                                           ).to(a.dtype) if a.is_floating_point() \
            else torch.from_numpy(v)
    return jl, jc, tc


class TestZeroTokenRange:
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_bit_exact_against_jax(self, fmt, layout):
        jl, jc, tc = _filled_stores(fmt, layout, seed=len(fmt) + len(layout))
        O = jkvc.OOB_INDEX
        tpos = np.asarray([[5, 6, 7, O, O], [31, 32, -1, O, 0], [9, 10, 11, 12, 13]], np.int32)
        kw = dict(max_seq=32)
        if layout == "paged":
            table = np.asarray([[0, 1, 2, 3], [4, -1, 6, 7], [8, 9, -1, 11]], np.int32)
            kw.update(page_size=8)
            jout = jkvc.zero_token_range(jc["global"], jnp.asarray(tpos),
                                         page_table=jnp.asarray(table), **kw)
            tout = tkvc.zero_token_range(tc["global"], tpos, page_table=torch.from_numpy(table),
                                         **kw)
        else:
            jout = jkvc.zero_token_range(jc["global"], jnp.asarray(tpos), **kw)
            tout = tkvc.zero_token_range(tc["global"], torch.from_numpy(tpos), **kw)
        assert tout is tc["global"]  # in place
        changed = 0
        for n in jout:
            want = np.asarray(jout[n].astype(jnp.float32)) if jout[n].dtype == jnp.bfloat16 \
                else np.asarray(jout[n])
            np.testing.assert_array_equal(tout[n].float().numpy() if tout[n].dtype ==
                                          torch.bfloat16 else tout[n].numpy(), want, err_msg=n)
            changed += int((want == 0).sum())
        assert changed > 0  # every leaf had something zeroed somewhere

    def test_all_lanes_out_of_range_is_a_no_op(self):
        _, _, tc = _filled_stores("bgpp", "slot", seed=3)
        before = {n: a.clone() for n, a in tc["global"].items()}
        tkvc.zero_token_range(tc["global"], np.full((3, 2), tkvc.OOB_INDEX), max_seq=32)
        assert all(torch.equal(before[n], tc["global"][n]) for n in before)


# --------------------------------------------------------------------------
# the Scheduler against the JAX Scheduler
# --------------------------------------------------------------------------

SLOTS, MAX_SEQ, PAGE, BUDGET, GAMMA = 2, 48, 8, 6, 3


def _trace(cfg, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, (int(rng.integers(4, 14)),)).astype(np.int32),
             [8, 9, 5][i % 3], 3 * i) for i in range(n)]


def _drive(sched, trace, cls, check_pager=False):
    for rid, (prompt, new, arrival) in enumerate(trace):
        sched.submit(cls(rid=rid, prompt=prompt, max_new_tokens=new, arrival_step=arrival))
    for _ in range(1000):
        if not sched.num_pending:
            break
        sched.step()
        if check_pager and sched.pager is not None:
            sched.pager.check()
    assert not sched.num_pending
    return {r.rid: r for r in sched.finished}


def _draft_recorder(sched, states_of):
    """Wrap ``sched.serve_step`` to record, for each draft step, the argmax
    and the top-two margin of every DECODING row's logits."""
    rec, inner = [], sched.serve_step

    def wrapped(params, cache, tokens):
        logits, cache = inner(params, cache, tokens)
        if params is sched.draft_params and sched.draft_params is not sched.serve_params:
            rows = np.asarray(logits[:, -1], np.float32) if not torch.is_tensor(logits) \
                else logits[:, -1].float().numpy()
            top = np.sort(rows, -1)[:, -2:]
            rec.append([(int(np.argmax(rows[b])), float(top[b, 1] - top[b, 0]))
                        for b in states_of(sched)])
        return logits, cache

    sched.serve_step = wrapped
    return rec


class TestSchedulerAgainstJax:
    @pytest.mark.parametrize("draft", ["perfect", "adversarial"])
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_injected_drafts(self, served, layout, draft):
        jcfg, cfg, jparams, params = served
        trace = _trace(cfg)
        jlay = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format="bf16", layout=layout,
                               page_size=PAGE)
        lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bf16", layout=layout,
                              page_size=PAGE)
        truth = _drive(JScheduler(jparams, jcfg, jlay, chunk_budget=BUDGET,
                                  spec_decode=False), trace, JRequest)
        tokens = {rid: list(r.generated) for rid, r in truth.items()}

        def fn(req, t):
            true = tokens[req.rid][t] if t < len(tokens[req.rid]) else 0
            return true if draft == "perfect" else (true + 1) % cfg.vocab_size

        j = JScheduler(jparams, jcfg, jlay, chunk_budget=BUDGET, spec_decode=True,
                       draft_gamma=GAMMA, draft_fn=fn)
        t = Scheduler(params, cfg, lay, device="cpu", chunk_budget=BUDGET, spec_decode=True,
                      draft_gamma=GAMMA, draft_fn=fn)
        jfin, tfin = _drive(j, trace, JRequest), _drive(t, trace, Request, check_pager=True)
        for rid in jfin:
            assert tfin[rid].generated == jfin[rid].generated == tokens[rid]
            assert tfin[rid].spec_accepts == jfin[rid].spec_accepts
            assert tfin[rid].spec_drafted == jfin[rid].spec_drafted
        assert t.stats()["spec"] == j.stats()["spec"]
        for key in ("decode_bytes", "decode_steps"):
            assert t.stats()["kv_read"][key] == j.stats()["kv_read"][key]
            assert t.stats()["weight_read"][key] == j.stats()["weight_read"][key]

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_truncated_plane_drafts_round_by_round(self, served, layout):
        """Each draft step's proposed token for every decoding slot equals
        JAX's.  A mismatch reports the JAX logits' top-two margin, so a
        near-tie shows as one."""
        jcfg, cfg, jparams, params = served
        trace = _trace(cfg, seed=1)
        kw = dict(kv_format="bf16", layout=layout, page_size=PAGE)
        j = JScheduler(jparams, jcfg, jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, **kw),
                       chunk_budget=BUDGET, spec_decode=True, draft_gamma=GAMMA, draft_planes=3)
        t = Scheduler(params, cfg, tkvc.layout_for(cfg, SLOTS, MAX_SEQ, **kw), device="cpu",
                      chunk_budget=BUDGET, spec_decode=True, draft_gamma=GAMMA,
                      draft_planes=3)
        decoding = lambda s: [sl.index for sl in s.slots if sl.state.value == "decoding"]
        jrec, trec = _draft_recorder(j, decoding), _draft_recorder(t, decoding)
        jfin, tfin = _drive(j, trace, JRequest), _drive(t, trace, Request, check_pager=True)
        assert len(trec) == len(jrec) > 0
        for step, (jr, tr) in enumerate(zip(jrec, trec)):
            for (jt, margin), (tt, _) in zip(jr, tr):
                assert tt == jt, (f"draft step {step}: port {tt}, JAX {jt} (JAX top-two "
                                  f"margin {margin:.3e})")
        for rid in jfin:
            assert tfin[rid].generated == jfin[rid].generated
            assert tfin[rid].spec_accepts == jfin[rid].spec_accepts
        assert t.stats()["spec"] == j.stats()["spec"]
        assert t.stats()["spec"]["draft_steps"] > 0


# --------------------------------------------------------------------------
# the accounting laws (tests/test_properties.py, TestSpecDecodeAccountingLaws)
# --------------------------------------------------------------------------


class TestSpecDecodeAccountingLaws:
    """Per-slot-round acceptance bounded by gamma + 1, per-request rows
    reconciling with the global counters and the byte totals, bytes per
    accepted token equal to bytes per step over the acceptance rate,
    perfect drafts banking gamma + 1 tokens every full round and
    adversarial drafts exactly one."""

    _CACHE = {}

    @classmethod
    def _runs(cls, served):
        if not cls._CACHE:
            _, cfg, _, params = served
            lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bf16")
            trace = _trace(cfg)

            def run(**kw):
                sched = Scheduler(params, cfg, lay, device="cpu", chunk_budget=BUDGET, **kw)
                return sched, _drive(sched, trace, Request)

            _, truth = run(spec_decode=False)
            tokens = {rid: list(r.generated) for rid, r in truth.items()}
            cls._CACHE["truth"] = tokens
            perfect = lambda req, t: tokens[req.rid][t] if t < len(tokens[req.rid]) else 0
            adversarial = lambda req, t: (perfect(req, t) + 1) % cfg.vocab_size
            for name, kw in (("perfect", {"draft_fn": perfect}),
                             ("adversarial", {"draft_fn": adversarial}),
                             ("planes", {"draft_planes": 2})):
                cls._CACHE[name] = run(spec_decode=True, draft_gamma=GAMMA, **kw)
        return cls._CACHE

    def test_outputs_identical_to_reference(self, served):
        runs = self._runs(served)
        for name in ("perfect", "adversarial", "planes"):
            _, fin = runs[name]
            for rid, seq in runs["truth"].items():
                assert fin[rid].generated == seq, (name, rid)

    def test_accepted_bounded_by_gamma_plus_one(self, served):
        runs = self._runs(served)
        for name in ("perfect", "adversarial", "planes"):
            for r in runs[name][1].values():
                assert r.spec_accepts and all(1 <= a <= GAMMA + 1 for a in r.spec_accepts)

    def test_per_request_rows_reconcile_with_globals(self, served):
        runs = self._runs(served)
        for name in ("perfect", "adversarial", "planes"):
            sched, fin = runs[name]
            reqs = list(fin.values())
            assert sum(sum(r.spec_accepts) for r in reqs) == sched.spec_accepted
            assert sum(len(r.spec_accepts) for r in reqs) == sched.spec_slot_rounds
            assert sum(r.spec_drafted for r in reqs) == sched.spec_drafted \
                == GAMMA * sched.spec_slot_rounds
            for r in reqs:
                assert sum(r.spec_accepts) == len(r.generated) - 1, (name, r.rid)
                rec = r.trace_record()
                assert (rec["spec_rounds"], rec["spec_accepted_tokens"],
                        rec["spec_drafted_tokens"]) == (len(r.spec_accepts),
                                                        sum(r.spec_accepts), r.spec_drafted)

    def test_counters_reconcile_with_byte_totals(self, served):
        runs = self._runs(served)
        for name in ("perfect", "adversarial", "planes"):
            stats = runs[name][0].stats()
            sp, kv, wr = stats["spec"], stats["kv_read"], stats["weight_read"]
            assert sp["accepted_tokens"] == stats["decoded_tokens"]
            assert kv["decode_steps"] == sp["draft_steps"] + sp["verify_steps"]
            assert kv["decode_bytes"] == kv["decode_steps"] * kv["decode_bytes_per_step"]
            assert wr["decode_bytes"] == wr["decode_steps"] * wr["decode_bytes_per_step"]
            if name != "planes":
                assert sp["draft_steps"] == 0
                np.testing.assert_allclose(sp["modeled_weight_bytes_per_accepted_token"],
                                           sp["weight_bytes_per_accepted_token"], atol=1)

    def test_bytes_per_accepted_is_per_step_over_acceptance_rate(self, served):
        runs = self._runs(served)
        for name in ("perfect", "adversarial", "planes"):
            stats = runs[name][0].stats()
            sp, kv, wr = stats["spec"], stats["kv_read"], stats["weight_read"]
            rate = sp["accepted_tokens"] / kv["decode_steps"]
            np.testing.assert_allclose(kv["decode_bytes"] / sp["accepted_tokens"],
                                       kv["decode_bytes_per_step"] / rate, rtol=1e-12)
            np.testing.assert_allclose(wr["decode_bytes"] / sp["accepted_tokens"],
                                       wr["decode_bytes_per_step"] / rate, rtol=1e-12)

    def test_perfect_drafts_accept_gamma_plus_one_per_full_round(self, served):
        sched, fin = self._runs(served)["perfect"]
        for r in fin.values():
            assert all(a == GAMMA + 1 for a in r.spec_accepts[:-1]), r.spec_accepts
        assert sched.spec_max_accept == GAMMA + 1

    def test_adversarial_drafts_accept_exactly_one_per_round(self, served):
        sched, fin = self._runs(served)["adversarial"]
        for r in fin.values():
            assert all(a == 1 for a in r.spec_accepts), r.spec_accepts
        sp = sched.stats()["spec"]
        assert sp["accepted_tokens_per_round"] == 1.0 and sp["draft_hit_rate"] == 0.0


# --------------------------------------------------------------------------
# the fuzz's spec axis (tests/test_serving_fuzz.py), dense cases
# --------------------------------------------------------------------------

FUZZ_SEQ, FUZZ_BUDGET = 48, 6


@pytest.fixture(scope="module")
def keep_all(served):
    """The fuzz's model: keep-all BGPP, so the progressive gather runs but
    the oracle is not confounded by forced sparsity."""
    _, cfg, _, params = served
    return dataclasses.replace(cfg, mcbp=MCBPOptions(bgpp_rounds=4, bgpp_keep_ratio=1.0)), \
        params


def _fuzz_requests(rng, cfg, n, teacher_forced):
    reqs = []
    for rid in range(n):
        new = int(rng.integers(2, 6))
        reqs.append(Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab_size, (int(rng.integers(3, 21)),))
            .astype(np.int32), max_new_tokens=new, arrival_step=int(rng.integers(0, 9)),
            forced_tokens=rng.integers(0, cfg.vocab_size, (new,)).astype(np.int32)
            if teacher_forced else None))
    return reqs


def _clone(r, arrival):
    return Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                   arrival_step=arrival, forced_tokens=r.forced_tokens)


def _fuzz_run(cfg, params, fmt, layout, reqs, admission="chunked", slots=SLOTS, **kw):
    lay = tkvc.layout_for(cfg, slots, FUZZ_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    sched = Scheduler(params, cfg, lay, device="cpu", admission=admission,
                      chunk_budget=FUZZ_BUDGET, record_logits=True, **kw)
    for r in reqs:
        sched.submit(r)
    for _ in range(2000):
        if not sched.num_pending:
            break
        sched.step()
        if sched.pager is not None:
            sched.pager.check()
    assert not sched.num_pending and len(sched.finished) == len(reqs)
    if sched.pager is not None:
        assert sched.pager.pages_in_use == 0, "spec rollback leaked pages"
    return sched, {r.rid: r for r in sched.finished}


def _compare_to_alone(cfg, params, fmt, reqs, joint, admission="chunked", slots=SLOTS,
                      exact=None):
    """Each request alone, non-speculative, on the slot layout: greedy
    tokens equal, logits bit-identical (``exact``, bf16 KV by default) or
    within 1e-5."""
    exact = fmt == "bf16" if exact is None else exact
    for r in reqs:
        _, alone = _fuzz_run(cfg, params, fmt, "slot", [_clone(r, 0)], admission, slots,
                             spec_decode=False)
        got, want = joint[r.rid], alone[r.rid]
        assert len(got.logit_rows) == len(want.logit_rows)
        for t, (g, w) in enumerate(zip(got.logit_rows, want.logit_rows)):
            if exact:
                assert np.array_equal(g, w), f"rid {r.rid} token {t}: {np.abs(g - w).max()}"
            else:
                assert float(np.abs(g - w).max()) <= 1e-5, (r.rid, t)
        assert got.generated == want.generated


def _spec_fuzz(keep_all, fmt, seed, layout, draft="planes", admission="chunked"):
    cfg, params = keep_all
    rng = np.random.default_rng(seed)
    teacher = fmt != "bf16"
    reqs = _fuzz_requests(rng, cfg, 4, teacher)
    gamma = int(rng.integers(1, 5))
    kw = {"spec_decode": True, "draft_gamma": gamma}
    if draft == "planes":
        kw["draft_planes"] = int(rng.integers(1, 9))
    elif draft == "adversarial":
        drng = np.random.default_rng(seed + 1)
        kw["draft_fn"] = lambda req, t: int(drng.integers(0, cfg.vocab_size))
    else:
        kw["draft_fn"] = lambda req, t: (int(req.forced_tokens[t])
                                         if t < len(req.forced_tokens) else 0)
    sched, joint = _fuzz_run(cfg, params, fmt, layout, [_clone(r, r.arrival_step)
                                                        for r in reqs], admission, **kw)
    stats = sched.stats()
    kv, wr, sp = stats["kv_read"], stats["weight_read"], stats["spec"]
    assert kv["decode_bytes"] == kv["decode_steps"] * kv["decode_bytes_per_step"]
    assert wr["decode_bytes"] == wr["decode_steps"] * wr["decode_bytes_per_step"]
    assert sp["rounds"] > 0 and sp["accepted_tokens"] == stats["decoded_tokens"]
    assert sp["drafted_tokens"] == gamma * sched.spec_slot_rounds
    for r in joint.values():
        assert all(1 <= a <= gamma + 1 for a in r.spec_accepts)
        assert sum(r.spec_accepts) == len(r.generated) - 1
        if draft == "perfect":
            assert all(a == gamma + 1 for a in r.spec_accepts[:-1]), r.spec_accepts
    _compare_to_alone(cfg, params, fmt, reqs, joint, admission)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layout", LAYOUTS)
class TestSpecDecodeFuzz:
    """Speculative joint runs against non-speculative alone runs on the
    slot layout: wrong drafts may cost steps, never a token or a logit."""

    def test_spec_dense_bf16_planes(self, keep_all, layout, seed):
        _spec_fuzz(keep_all, "bf16", seed, layout)

    def test_spec_dense_bf16_adversarial(self, keep_all, layout, seed):
        _spec_fuzz(keep_all, "bf16", seed + 10, layout, draft="adversarial")

    def test_spec_dense_int8_perfect(self, keep_all, layout, seed):
        _spec_fuzz(keep_all, "int8", seed + 20, layout, draft="perfect")

    def test_spec_dense_bgpp_adversarial(self, keep_all, layout, seed):
        _spec_fuzz(keep_all, "bgpp", seed + 30, layout, draft="adversarial")

    def test_spec_dense_bf16_eager(self, keep_all, layout, seed):
        _spec_fuzz(keep_all, "bf16", seed + 40, layout, admission="eager")


@pytest.mark.parametrize("seed", [0, 1])
def test_spec_over_adopted_prefix_pages(keep_all, seed):
    """Speculation while other slots share the donor's prompt pages: request
    0 prefills a 32-token prefix and speculates long enough that requests 1
    and 2 arrive and adopt its pages while its rollback runs; both must hit
    the prefix, and every logit must equal the same joint run without
    speculation, bit for bit.  Against alone runs the tokens and logits are
    equal too, bit for bit: an adopter prefills its tail in other chunk
    widths than an alone run, and the CPU chunked prefill does not move with
    the chunk width."""
    cfg, params = keep_all
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, (32,)).astype(np.int32)

    def req(rid, tail, new, arrival):
        return Request(rid=rid, prompt=np.concatenate(
            [prefix, rng.integers(0, cfg.vocab_size, (tail,)).astype(np.int32)]),
            max_new_tokens=new, arrival_step=arrival)

    reqs = [req(0, 4, 24, 0), req(1, 5, 4, 8), req(2, 3, 3, 8)]
    runs = [_fuzz_run(cfg, params, "bf16", "paged", [_clone(r, r.arrival_step) for r in reqs],
                      slots=3, **kw)
            for kw in ({"spec_decode": True, "draft_gamma": 3, "draft_planes": 4},
                       {"spec_decode": False})]
    (sched, joint), (_, plain) = runs
    assert sched.prefix_hit_tokens >= 64
    for r in reqs:
        assert joint[r.rid].generated == plain[r.rid].generated
        assert all(np.array_equal(g, w) for g, w in zip(joint[r.rid].logit_rows,
                                                         plain[r.rid].logit_rows))
    _compare_to_alone(cfg, params, "bf16", reqs, joint, slots=3, exact=True)


def test_slot_states_after_a_round(served):
    """A slot that finishes inside a round is evicted after the rollback
    (its pages freed, none leaked), and a row that did not decode keeps
    its position."""
    _, cfg, _, params = served
    lay = tkvc.layout_for(cfg, 2, MAX_SEQ, kv_format="bf16", layout="paged", page_size=PAGE)
    sched = Scheduler(params, cfg, lay, device="cpu", chunk_budget=BUDGET, spec_decode=True,
                      draft_gamma=3, draft_fn=lambda req, t: 0)
    sched.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=2))
    sched.step()  # the prompt's one chunk, its first token, then one round
    assert sched.spec_rounds == 1 and len(sched.finished) == 1
    assert sched.slots[0].state is SlotState.EMPTY and sched.finished[0].spec_accepts == [1]
    assert int(sched.cache["pos"][1]) == 0 and sched.pager.pages_in_use == 0
    sched.pager.check()
