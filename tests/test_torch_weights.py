"""The port's serve-time weight path against the JAX package's.

Same ``phi4-mini-smoke`` parameters (JAX-initialised, brought across with
``interop.params_from_numpy``) on both sides; the JAX ``Scheduler`` is
driven without a mesh, as ``tests/test_scheduler.py`` drives it.

Tolerances:
  * ``quantize`` records, the int8 serve tree and the bstc operands:
    bit-exact (integer codes; the scale is one IEEE f32 division).
  * ``WeightPlan``: the same bytes exactly; ``modeled`` within 1e-9
    relative (a float sum of closed forms).
  * Scheduler runs (smoke config, f32): greedy tokens identical and logits
    within 1e-4 — the records hold the same values, only the sums run in
    other orders (the bstc path contracts through ``bstc_matmul``, whose
    plain version applies the scale after the sum).
    ``stats()["weight_read"]`` equal to the reference's key by key.
  * bf16 width: int8 weights within 1e-4 of the reference's step, as the
    bf16 weights are (``test_torch_engine.py``).  bstc weights depart from
    the reference on purpose at layer 0's q/k/v, whose input is the bf16
    embedding: the reference rounds each ``q·scale`` to bf16 before the
    product (relative error <= u = 2**-8, bf16's unit roundoff), the
    kernel multiplies exact integers and scales once.  Each projection
    output is then rounded to bf16 on both sides (<= u each), so the two
    outputs differ by at most ``3u·Σ|x|·|q·scale|`` (plus f32 summation
    slack): the layer test holds that bound.  Through the rest of the
    step the perturbation stays of that order; the step test holds the
    logits within 4u of their scale and the greedy tokens equal (bf16
    KV).  The int8 and bgpp KV formats quantise K/V and select keys by
    thresholds, where a perturbation that small can flip a code, so the
    step bound is stated for the bf16 KV format only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import apply_weight_format_override as japply, get_config as jax_config
from repro.models import layers as jlayers, model_zoo
from repro.serving import engine as jengine, kv_cache as jkvc, weights as jswt
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.configs import (WEIGHT_FORMATS, apply_weight_format_override,
                                 get_config)
from repro_torch.interop import params_from_numpy, serve_params_from_numpy
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.bstc_matmul import reconstruct_dense_weight
from repro_torch.models import layers as tlayers
from repro_torch.serving import engine as tengine, kv_cache as tkvc, weights as tswt
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Scheduler

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "phi4-mini-3.8b"
SLOTS, MAX_SEQ, PAGE, BUDGET = 2, 64, 8, 8
U_BF16 = 2.0 ** -8  # bf16 unit roundoff (8 significant bits)


@pytest.fixture(scope="module")
def served():
    jcfg = jax_config(ARCH, smoke=True)
    jparams, _ = model_zoo.init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, get_config(ARCH, smoke=True), jparams, tparams


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jlayout(jcfg):
    return jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format="bf16")


def _same_ops(a, b):
    """Two BSTCMatmulOperands hold the same arrays, bit for bit."""
    assert (a.enc_planes, a.raw_planes, a.m, a.M, a.H, a.tile_k) == \
        (b.enc_planes, b.raw_planes, b.m, b.M, b.H, b.tile_k)
    for x, y in zip((*a.enc, *a.raw, a.sign_bits, a.scale), (*b.enc, *b.raw, b.sign_bits, b.scale)):
        assert torch.equal(x, y)


class TestConfig:
    def test_fields_and_override(self):
        cfg = get_config(ARCH, smoke=True)
        mo = cfg.mcbp
        jmo = jax_config(ARCH, smoke=True).mcbp
        assert (mo.group_size, mo.bstc_threshold, mo.weight_format) == \
            (jmo.group_size, jmo.bstc_threshold, jmo.weight_format)
        assert WEIGHT_FORMATS == ("bf16", "int8", "bstc")
        assert apply_weight_format_override(cfg, None) is cfg
        assert apply_weight_format_override(cfg, "bstc").mcbp.weight_format == "bstc"
        with pytest.raises(ValueError, match="weight_format"):
            apply_weight_format_override(cfg, "fp4")


class TestQuantize:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_records_bit_exact(self, dtype):
        rng = np.random.default_rng(0)
        w = rng.normal(size=(3, 24, 10)).astype(np.float32)
        w[0, :, 0] = [127.0] + [2.5, -0.5, 3.5, -6.5] * 5 + [0.5, 1.5, 0.0]  # .5 ties
        w[1, :, 3] = 0.0  # an all-zero column: scale clamps to 1e-12 / 127
        jw = jnp.asarray(w, getattr(jnp, dtype))
        want = jswt.quantize(jw)
        got = tswt.quantize(_t(np.asarray(jw.astype(jnp.float32))).to(getattr(torch, dtype)))
        assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
        np.testing.assert_array_equal(tswt.dequantize(got).numpy(),
                                      np.asarray(jswt.dequantize(want)))


class TestServeParams:
    def test_bf16_untouched(self, served):
        _, cfg, _, tparams = served
        serve, plan = tswt.prepare_serve_params(tparams, cfg, "bf16")
        assert serve is tparams and plan.fmt == "bf16"

    def test_int8_tree_bit_exact(self, served):
        jcfg, cfg, jparams, tparams = served
        jserve, _ = jswt.prepare_serve_params(jparams, japply(jcfg, "int8"), _jlayout(jcfg))
        tserve, _ = tswt.prepare_serve_params(tparams, cfg, "int8")
        crossed = serve_params_from_numpy(_np_tree(jserve), cfg, "int8", "cpu")
        for path in (("layers", "attn", "wq"), ("layers", "mlp", "down"), ("lm_head",)):
            a, b, c = tserve, crossed, jserve
            for k in path:
                a, b, c = a[k], b[k], c[k]
            for f in ("q", "scale"):
                assert torch.equal(a[f], b[f])
                np.testing.assert_array_equal(a[f].numpy(), np.asarray(c[f]))
        assert tserve["embed"] is tparams["embed"]  # raw leaves stay shared

    def test_bstc_tree_codes_the_reference_records(self, served):
        """The port's bstc records hold, coded, exactly the int8 values of
        the reference's bstc serve tree; the first coded matrix round-trips
        through the plain decode (CPU: no kernel launch)."""
        jcfg, cfg, jparams, tparams = served
        jserve, _ = jswt.prepare_serve_params(jparams, japply(jcfg, "bstc"), _jlayout(jcfg))
        reset_launches()
        tserve, _ = tswt.prepare_serve_params(tparams, cfg, "bstc")
        assert LAUNCHES["bstc_decode"] == 0 and LAUNCHES["bstc_matmul"] == 0
        crossed = serve_params_from_numpy(_np_tree(jserve), cfg, "bstc", "cpu")
        L = cfg.num_layers
        for grp, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("gate", "up", "down"))):
            for n in names:
                rec, ref = tserve["layers"][grp][n], jserve["layers"][grp][n]
                assert tswt.is_record(rec) and "q" not in rec and len(rec["bstc"]) == L
                np.testing.assert_array_equal(rec["scale"].numpy(), np.asarray(ref["scale"]))
                for i in range(L):
                    _same_ops(rec["bstc"][i], crossed["layers"][grp][n]["bstc"][i])
                    assert rec["bstc"][i].tile_k == rec["bstc"][i].H  # 96, 192: no 512 tiles
                    np.testing.assert_array_equal(
                        reconstruct_dense_weight(rec["bstc"][i]).numpy(),
                        np.asarray(ref["q"][i]).T.astype(np.int32))
        _same_ops(tserve["lm_head"]["bstc"], crossed["lm_head"]["bstc"])

    def test_roundtrip_check_catches_a_bad_decode(self, served, monkeypatch):
        _, cfg, _, tparams = served
        monkeypatch.setattr(tswt, "reconstruct_dense_weight",
                            lambda ops: torch.zeros((ops.M, ops.H), dtype=torch.int32))
        with pytest.raises(AssertionError, match="round-trip"):
            tswt.prepare_serve_params(tparams, cfg, "bstc")


def _entries(plan):
    """A plan's entries as dicts, without the reference's ``placement``
    (its shard class, which the port takes up with sharding)."""
    return [{k: v for k, v in dataclasses.asdict(e).items() if k != "placement"}
            for e in plan.entries]


class TestWeightPlan:
    @pytest.mark.parametrize("fmt", ["bf16", "int8", "bstc"])
    def test_plan_matches_reference(self, served, fmt):
        jcfg, cfg, jparams, tparams = served
        jl = _jlayout(jcfg)
        _, jplan = jswt.prepare_serve_params(jparams, japply(jcfg, fmt), jl)
        _, tplan = tswt.prepare_serve_params(tparams, cfg, fmt)
        assert _entries(tplan) == _entries(jplan)
        want = jplan.decode_read_bytes(jl, jcfg)
        got = tplan.decode_read_bytes()
        for key in ("format", "total", "bf16_equiv", "int8_equiv", "per_projection"):
            assert got[key] == want[key], key
        assert got["modeled"] == pytest.approx(want["modeled"], rel=1e-9)
        # the serving bench's value-independent bytes (BENCH_serving.json)
        assert {"bf16": 835584, "int8": 216832}.get(fmt, got["total"]) == got["total"]

    def test_indivisible_dims_price_and_serve_as_int8(self, served):
        """``out % m`` or ``in % 8``: the reference prices such a matrix as
        int8 (``bstc_fallback``); the port serves it as an int8 record."""
        jcfg, cfg, _, _ = served
        rng = np.random.default_rng(4)
        tree = {"layers": {"attn": {"wq": rng.normal(size=(2, 16, 6)).astype(np.float32),
                                    "wk": rng.normal(size=(2, 12, 8)).astype(np.float32),
                                    "wv": rng.normal(size=(2, 16, 8)).astype(np.float32)}}}
        _, jplan = jswt.prepare_serve_params(jax.tree.map(jnp.asarray, tree),
                                             japply(jcfg, "bstc"), _jlayout(jcfg))
        tserve, tplan = tswt.prepare_serve_params(params_from_numpy(tree, "cpu"), cfg, "bstc")
        assert _entries(tplan) == _entries(jplan)
        assert [e.bstc_fallback for e in tplan.entries] == [True, True, False]
        attn = tserve["layers"]["attn"]
        assert "q" in attn["wq"] and "q" in attn["wk"] and "bstc" in attn["wv"]


def _prompts(seed=0, lens=(9, 13, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (n,)).astype(np.int32) for n in lens]


class TestSchedulerAgainstJax:
    @pytest.mark.parametrize("kv", ["bf16", "bgpp"])
    @pytest.mark.parametrize("layout", ["slot", "paged"])
    @pytest.mark.parametrize("fmt", ["int8", "bstc"])
    def test_scheduler_matches_jax(self, served, fmt, layout, kv):
        jcfg, cfg, jparams, tparams = served
        prompts = _prompts()
        jc = japply(jcfg, fmt)
        jlay = jkvc.layout_for(jc, SLOTS, MAX_SEQ, kv_format=kv, layout=layout, page_size=PAGE)
        jsched = JScheduler(jparams, jc, jlay, chunk_budget=BUDGET, record_logits=True)
        tlay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format=kv, layout=layout, page_size=PAGE)
        tsched = Scheduler(tparams, cfg, tlay, device="cpu", chunk_budget=BUDGET,
                           record_logits=True, weight_format=fmt)
        for i, p in enumerate(prompts):
            jsched.submit(JRequest(rid=i, prompt=p, max_new_tokens=4, arrival_step=i))
            tsched.submit(Request(rid=i, prompt=p, max_new_tokens=4, arrival_step=i))
        reset_launches()
        jstats, tstats = jsched.run(max_steps=500), tsched.run(max_steps=500)
        assert LAUNCHES["bstc_matmul"] == 0  # CPU tensors: the plain version
        jreq = {r.rid: r for r in jsched.finished}
        treq = {r.rid: r for r in tsched.finished}
        assert sorted(treq) == sorted(jreq)
        for i in jreq:
            assert treq[i].generated == jreq[i].generated, i
        err = max(float(np.abs(np.stack(treq[i].logit_rows) - np.stack(jreq[i].logit_rows)).max())
                  for i in jreq)
        assert err <= 1e-4
        assert tsched.weight_format == fmt and tstats["weight_read"]["weight_format"] == fmt
        for key, val in tstats["weight_read"].items():
            assert val == jstats["weight_read"][key], key
        assert tstats["weight_read"]["decode_bytes"] == \
            tstats["weight_read"]["decode_bytes_per_step"] * tstats["weight_read"]["decode_steps"]
        for key in ("decode_bytes", "prefill_bytes", "decode_bytes_per_step"):
            assert tstats["kv_read"][key] == jstats["kv_read"][key], key

    def test_argument_overrides_config_and_bf16_prices_raw(self, served):
        _, cfg, _, tparams = served
        lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ)
        sched = Scheduler(tparams, apply_weight_format_override(cfg, "int8"), lay,
                          device="cpu")
        assert sched.weight_format == "int8" and "q" in sched.serve_params["lm_head"]
        sched = Scheduler(tparams, apply_weight_format_override(cfg, "int8"), lay,
                          device="cpu", weight_format="bf16")
        assert sched.weight_format == "bf16" and sched.serve_params is tparams
        assert sched.stats()["weight_read"]["decode_bytes_per_step"] == 835584
        with pytest.raises(ValueError, match="weight_format"):
            Scheduler(tparams, cfg, lay, device="cpu", weight_format="fp4")

    def test_step_refuses_raw_leaves(self, served):
        _, cfg, _, tparams = served
        lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ)
        step = tengine.make_serve_step(apply_weight_format_override(cfg, "bstc"), lay)
        cache = tkvc.init_cache_arrays(cfg, lay, device="cpu")
        with pytest.raises(ValueError, match="raw weight leaves"):
            step(tparams, cache, torch.zeros((SLOTS, 1), dtype=torch.long))


class TestLauncher:
    @pytest.mark.parametrize("fmt", ["int8", "bstc"])
    def test_weight_format_flag(self, fmt, capsys):
        from repro_torch.launch import serve

        serve.main(["--device", "cpu", "--kv-layout", "paged", "--requests", "2",
                    "--max-new", "2", "--weight-format", fmt])
        out = capsys.readouterr().out
        assert f"weights={fmt}" in out and f"[serve] weight read ({fmt})" in out
        if fmt == "int8":
            assert "216.8 kB/decode-step" in out


def _bf16(fmt):
    jcfg = japply(dataclasses.replace(jax_config(ARCH, smoke=True), dtype="bfloat16"), fmt)
    cfg = apply_weight_format_override(
        dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16"), fmt)
    jparams, _ = model_zoo.init(jax.random.key(1), jcfg)
    return jcfg, cfg, jparams, params_from_numpy(_np_tree(jparams), "cpu")


class TestBf16Width:
    def test_layer0_qkv_within_the_rounding_bound(self):
        """bstc at bf16 width: layer 0's q/k/v projections of a bf16
        activation differ from the reference's by at most
        ``3u·Σ|x|·|q·scale|`` (module docstring)."""
        jcfg, cfg, jparams, tparams = _bf16("bstc")
        jl = jkvc.layout_for(jcfg, 2, 16, kv_format="bf16")
        jserve, _ = jswt.prepare_serve_params(jparams, jcfg, jl)
        tserve, _ = tswt.prepare_serve_params(tparams, cfg)
        x = np.random.default_rng(5).normal(size=(3, 1, cfg.d_model)).astype(np.float32)
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = _t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
        for n in ("wq", "wk", "wv"):
            jrec = jax.tree.map(lambda a: a[0], jserve["layers"]["attn"][n])
            trec = {"bstc": tserve["layers"]["attn"][n]["bstc"][0],
                    "scale": tserve["layers"]["attn"][n]["scale"][0]}
            want = np.asarray(jlayers.wdot(jx, jrec).astype(jnp.float32), np.float64)
            got = tlayers.wdot(tx, trec)
            assert got.dtype == torch.bfloat16
            dq = np.abs(np.asarray(jrec["q"], np.float64) * np.asarray(jrec["scale"], np.float64))
            bound = 3 * U_BF16 * (np.abs(np.asarray(jx.astype(jnp.float32), np.float64)) @ dq)
            err = np.abs(got.double().numpy() - want)
            assert np.all(err <= bound * (1 + 1e-3) + 1e-30), n
            assert err.max() > 0  # the departure is real: the reference rounds q·scale

    @pytest.mark.parametrize("fmt", ["int8", "bstc"])
    def test_decode_steps_match_jax(self, fmt):
        """Three batched decode steps from one shared cache: int8 records
        within 1e-4 (as bf16 weights); bstc within 4u of the logits' scale,
        the same greedy tokens (module docstring)."""
        jcfg, cfg, jparams, tparams = _bf16(fmt)
        B, S, page = 3, 48, 8
        jl = jkvc.layout_for(jcfg, B, S, kv_format="bf16", layout="paged", page_size=page)
        tl = tkvc.layout_for(cfg, B, S, kv_format="bf16", layout="paged", page_size=page)
        rng = np.random.default_rng(3)
        jc = jkvc.init_cache_arrays(jcfg, jl)
        jc["page_table"] = jnp.asarray(
            rng.permutation(jl.num_pages).reshape(B, -1).astype(np.int32))
        for gi in range(len(jl.global_layers)):
            k, v = (rng.normal(size=(B, S, cfg.num_kv_heads, cfg.head_dim))
                    .astype(np.float32) for _ in range(2))
            jc["global"] = jkvc.write_prefill(jc["global"], gi, jnp.asarray(k), jnp.asarray(v),
                                              page_table=jc["page_table"], page_size=page,
                                              max_seq=S)
        jc["pos"] = jnp.asarray([S - 5, 9, 23], jnp.int32)
        tc = params_from_numpy(_np_tree(jc), "cpu")
        jserve, _ = jswt.prepare_serve_params(jparams, jcfg, jl)
        tserve, _ = tswt.prepare_serve_params(tparams, cfg)
        jstep = jax.jit(jengine.make_serve_step(jcfg, jl))
        tstep = tengine.make_serve_step(cfg, tl)
        feed = np.asarray([[3], [11], [400]], np.int32)
        for _ in range(3):
            jlog, jc = jstep(jserve, jc, jnp.asarray(feed))
            tlog, tc = tstep(tserve, tc, _t(feed).long())
            want = np.asarray(jlog)
            assert tlog.dtype == torch.float32
            tol = 1e-4 if fmt == "int8" else 4 * U_BF16 * float(np.abs(want).max())
            np.testing.assert_allclose(tlog.numpy(), want, rtol=0, atol=tol)
            np.testing.assert_array_equal(tlog[:, -1].argmax(-1).numpy(),
                                          want[:, -1].argmax(-1))
            feed = want[:, -1].argmax(-1).astype(np.int32)[:, None]
