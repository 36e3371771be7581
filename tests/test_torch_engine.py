"""The port's layers and engine attends against the JAX package's.

Same numpy-seeded inputs and JAX-initialised parameters on both sides.
Float results within 1e-5 (float32; torch and XLA sum in other orders);
the kernel routing (``kernel_decode.decode_attend``, which takes the
kernels' plain versions on CPU tensors) against the JAX engine's jnp
attend on the same cache, in both layouts; the BGPP survivor sets
bit-exact.  One decode-step test runs the config at bf16 width (the full
config's dtypes), where the f32 residual of the reference shows.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import layers as jlayers, model_zoo, transformer as jtransformer
from repro.serving import engine as jengine, kv_cache as jkvc

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.models import layers as tlayers, transformer as ttransformer
from repro_torch.serving import engine as tengine, kernel_decode, kv_cache as tkvc

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "phi4-mini-3.8b"
FORMATS = ["bf16", "int8", "bgpp"]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def served():
    jcfg = jax_config(ARCH, smoke=True)
    jparams, _ = model_zoo.init(jax.random.key(1), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, get_config(ARCH, smoke=True), jparams, tparams


class TestInterop:
    def test_bf16_leaves_cross_bit_exact(self):
        x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 6)), jnp.bfloat16)
        t = tensor_from_numpy(np.asarray(x), "cpu")
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(x.astype(jnp.float32)))

    def test_init_params_tree_matches_jax(self, served):
        jcfg, cfg, jparams, _ = served
        tp = ttransformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
        tshapes = jax.tree.map(lambda a: tuple(a.shape), tp)
        assert jshapes == tshapes
        # transformer.init's scales: 1/sqrt(fan_in) projections, 0.02 embed
        assert abs(float(tp["embed"].std()) - 0.02) < 0.002
        wq = tp["layers"]["attn"]["wq"]
        assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.01
        np.testing.assert_array_equal(ttransformer.layer_thetas(cfg),
                                      np.asarray(jtransformer.layer_thetas(jcfg)))


class TestLayers:
    def test_norm_rope_mlp_qkv(self, served):
        jcfg, cfg, jparams, tparams = served
        rng = np.random.default_rng(2)
        x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
        pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
        jp = jax.tree.map(lambda a: a[0], jparams["layers"])
        tp = ttransformer.layer_params(tparams["layers"], 0)
        close = lambda a, b: np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                                        rtol=1e-5, atol=1e-5)
        close(jlayers.apply_norm(jnp.asarray(x), jp["attn_norm"], "rms"),
              tlayers.apply_norm(_t(x), tp["attn_norm"], "rms"))
        close(jlayers.mlp_apply(jp["mlp"], jnp.asarray(x), "swiglu"),
              tlayers.mlp_apply(tp["mlp"], _t(x), "swiglu"))
        for a, b in zip(
            jlayers.qkv_project(jp["attn"], jnp.asarray(x), cfg.num_heads,
                                cfg.num_kv_heads, cfg.head_dim, jnp.asarray(pos), 1e4),
            tlayers.qkv_project(tp["attn"], _t(x), cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, _t(pos), 1e4),
        ):
            close(a, b)
        close(jlayers.rope_frequencies(16, 1e4), tlayers.rope_frequencies(16, 1e4))


def _filled_caches(served, fmt, layout, B=3, S=48, page=8):
    """The same prompt K/V written into a JAX and a port cache."""
    jcfg, cfg, _, _ = served
    rng = np.random.default_rng(3)
    jl = jkvc.layout_for(jcfg, B, S, kv_format=fmt, layout=layout, page_size=page)
    tl = tkvc.layout_for(cfg, B, S, kv_format=fmt, layout=layout, page_size=page)
    jc = jkvc.init_cache_arrays(jcfg, jl)
    tc = tkvc.init_cache_arrays(cfg, tl, device="cpu")
    kw_j = kw_t = {}
    if layout == "paged":
        table = rng.permutation(jl.num_pages).reshape(B, -1).astype(np.int32)
        jc["page_table"], tc["page_table"] = jnp.asarray(table), _t(table)
        kw_j = dict(page_table=jc["page_table"], page_size=page, max_seq=S)
        kw_t = dict(page_table=tc["page_table"], page_size=page, max_seq=S)
    k = rng.normal(size=(B, S, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    v = rng.normal(size=(B, S, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    jc["global"] = jkvc.write_prefill(jc["global"], 0, jnp.asarray(k), jnp.asarray(v), **kw_j)
    tkvc.write_prefill(tc["global"], 0, _t(k), _t(v), **kw_t)
    q = rng.normal(size=(B, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    pos = np.asarray([S - 1, 9, 23], np.int32)
    return jl, tl, jc, tc, q, pos


class TestDecodeAttends:
    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("layout", ["slot", "paged"])
    def test_kernel_route_matches_engine_attend(self, served, fmt, layout):
        jcfg, cfg, _, _ = served
        jl, tl, jc, tc, q, pos = _filled_caches(served, fmt, layout)
        S = jl.max_seq
        valid = jnp.arange(S)[None, :] <= jnp.asarray(pos)[:, None]
        if layout == "paged":
            jphys = jkvc.phys_table(jc["page_table"], jl.page_size, S)
            if fmt == "bgpp":
                want = jax.jit(lambda *a: jengine._bgpp_paged_decode_attend(
                    a[0], a[1], 0, a[2], a[3], jcfg))(jnp.asarray(q), jc["global"],
                                                      jphys, valid)
            else:
                entry = jkvc.paged_entry(jc["global"], 0, jphys)
                want = jengine._decode_attend(jnp.asarray(q), entry, valid, jcfg, fmt)
            tphys = tkvc.phys_table(tc["page_table"], tl.page_size, S)
            got = kernel_decode.decode_attend(_t(q), tc["global"], 0, _t(pos), cfg, tl,
                                              phys=tphys, page_table=tc["page_table"])
        else:
            entry = {n: a[0] for n, a in jc["global"].items()}
            if fmt == "bgpp":
                want = jax.jit(lambda *a: jengine._bgpp_decode_attend(*a, jcfg))(
                    jnp.asarray(q), entry, valid)
            else:
                want = jengine._decode_attend(jnp.asarray(q), entry, valid, jcfg, fmt)
            got = kernel_decode.decode_attend(_t(q), tc["global"], 0, _t(pos), cfg, tl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("layout", ["slot", "paged"])
    def test_engine_bgpp_attends_and_selection(self, served, layout):
        jcfg, cfg, _, _ = served
        jl, tl, jc, tc, q, pos = _filled_caches(served, "bgpp", layout)
        S = jl.max_seq
        jvalid = jnp.arange(S)[None, :] <= jnp.asarray(pos)[:, None]
        tvalid = torch.arange(S)[None, :] <= _t(pos)[:, None]
        qf_j = jengine._bgpp_quant_query(jnp.asarray(q), jcfg)
        qf_t = tengine._bgpp_quant_query(_t(q), cfg)
        np.testing.assert_array_equal(np.asarray(qf_j), qf_t.numpy())
        if layout == "paged":
            jphys = jkvc.phys_table(jc["page_table"], jl.page_size, S)
            tphys = tkvc.phys_table(tc["page_table"], tl.page_size, S)
            want = jengine._bgpp_paged_decode_attend(jnp.asarray(q), jc["global"], 0,
                                                     jphys, jvalid, jcfg)
            got = tengine._bgpp_paged_decode_attend(_t(q), tc["global"], 0, tphys,
                                                    tvalid, cfg)
            jidx, _ = jengine._bgpp_topk_indices(
                qf_j, jkvc.paged_plane(jc["global"], 0, 6, jphys),
                jkvc.paged_sign(jc["global"], 0, jphys),
                lambda p, i: jkvc.paged_plane_rows(jc["global"], 0, p,
                                                   jkvc.paged_rows_at(jphys, i)),
                jvalid, jcfg)
            tidx, _ = tengine._bgpp_topk_indices(
                qf_t, tkvc.paged_plane(tc["global"], 0, 6, tphys),
                tkvc.paged_sign(tc["global"], 0, tphys),
                lambda p, i: tkvc.paged_plane_rows(tc["global"], 0, p,
                                                   tkvc.paged_rows_at(tphys, i)),
                tvalid, cfg)
            np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
        else:
            jentry = {n: a[0] for n, a in jc["global"].items()}
            tentry = {n: a[0] for n, a in tc["global"].items()}
            want = jengine._bgpp_decode_attend(jnp.asarray(q), jentry, jvalid, jcfg)
            got = tengine._bgpp_decode_attend(_t(q), tentry, tvalid, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("fmt", ["bf16", "int8"])
    def test_cache_attend_multi_query(self, served, fmt):
        jcfg, cfg, _, _ = served
        _, _, jc, tc, _, _ = _filled_caches(served, fmt, "slot")
        rng = np.random.default_rng(9)
        q = rng.normal(size=(3, 5, cfg.num_heads, cfg.head_dim)).astype(np.float32)
        valid = rng.random((3, 5, 48)) < 0.7
        jentry = {n: a[0] for n, a in jc["global"].items()}
        tentry = {n: a[0] for n, a in tc["global"].items()}
        want = jengine._cache_attend(jnp.asarray(q), jentry, jnp.asarray(valid), jcfg, fmt)
        got = tengine._cache_attend(_t(q), tentry, _t(valid), cfg, fmt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


class TestSteps:
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_serve_step_and_chunk_match_jax(self, served, fmt):
        """One chunk admission then two batched decode steps, paged."""
        jcfg, cfg, jparams, tparams = served
        jl = jkvc.layout_for(jcfg, 2, 32, kv_format=fmt, layout="paged", page_size=8)
        tl = tkvc.layout_for(cfg, 2, 32, kv_format=fmt, layout="paged", page_size=8)
        jc = jkvc.init_cache_arrays(jcfg, jl)
        tc = tkvc.init_cache_arrays(cfg, tl, device="cpu")
        table = np.asarray([[5, 1, -1, -1], [2, 7, 0, -1]], np.int32)
        jc["page_table"], tc["page_table"] = jnp.asarray(table), _t(table)
        toks = np.random.default_rng(4).integers(0, 512, (1, 8)).astype(np.int32)
        jchunk = jax.jit(jengine.make_prefill_chunk(jcfg, jl))
        tchunk = tengine.make_prefill_chunk(cfg, tl)
        for slot, n in ((0, 6), (1, 8)):
            jl_, jc = jchunk(jparams, jc, jnp.asarray(toks), slot, 0, n)
            tl_, tc = tchunk(tparams, tc, _t(toks).long(), slot, 0, n)
            np.testing.assert_allclose(tl_.numpy()[0, :n], np.asarray(jl_)[0, :n],
                                       rtol=1e-4, atol=1e-4)
        jstep = jax.jit(jengine.make_serve_step(jcfg, jl))
        tstep = tengine.make_serve_step(cfg, tl)
        feed = np.asarray([[3], [11]], np.int32)
        for _ in range(2):
            jlog, jc = jstep(jparams, jc, jnp.asarray(feed))
            tlog, tc = tstep(tparams, tc, _t(feed).long())
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
            feed = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_bf16_width_decode_matches_jax(self, fmt):
        """bf16 weights and activations, as the full-width config serves:
        from one shared cache, three batched decode steps give the
        reference's f32 logits within 1e-4 (f32 sums in other orders).  The
        reference contracts the f32 attend output with the bf16 ``wo`` in
        f32, so the residual stream is f32 from layer 0's attend on; a bf16
        residual rounds it at every layer and misses by far more."""
        jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype="bfloat16")
        cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16")
        jparams, _ = model_zoo.init(jax.random.key(1), jcfg)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        assert tparams["embed"].dtype == torch.bfloat16
        B, S, page = 3, 48, 8
        jl = jkvc.layout_for(jcfg, B, S, kv_format=fmt, layout="paged", page_size=page)
        tl = tkvc.layout_for(cfg, B, S, kv_format=fmt, layout="paged", page_size=page)
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
        tc = params_from_numpy(jax.tree.map(np.asarray, jc), "cpu")  # bit-exact copy
        jstep = jax.jit(jengine.make_serve_step(jcfg, jl))
        tstep = tengine.make_serve_step(cfg, tl)
        feed = np.asarray([[3], [11], [400]], np.int32)
        for _ in range(3):
            jlog, jc = jstep(jparams, jc, jnp.asarray(feed))
            tlog, tc = tstep(tparams, tc, _t(feed).long())
            assert tlog.dtype == torch.float32
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
            feed = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]
