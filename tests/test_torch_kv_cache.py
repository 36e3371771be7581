"""The port's bit-slice primitives and KV cache against the JAX package's,
bit for bit.

The same numpy-seeded inputs go through ``repro`` and ``repro_torch``;
every integer-domain result (packed bits, int8 codes, bit planes, page
maps, cache stores after writes/scrubs, byte counters) must be identical,
and float stores identical too (writes copy, they do not compute).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import bitslice as jbs
from repro.serving import kv_cache as jkvc

from repro_torch.configs import get_config
from repro_torch.core import bitslice as tbs
from repro_torch.serving import kv_cache as tkvc

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "phi4-mini-3.8b"
FORMATS = ["bf16", "int8", "bgpp"]
LAYOUTS = ["slot", "paged"]


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_tree_equal(jtree, ttree):
    assert set(jtree) == set(ttree)
    for n in jtree:
        if isinstance(jtree[n], dict):
            _assert_tree_equal(jtree[n], ttree[n])
            continue
        a, b = _np(jtree[n]), ttree[n].numpy()
        assert a.shape == b.shape, n
        np.testing.assert_array_equal(a, b, err_msg=n)


@pytest.fixture(scope="module")
def cfgs():
    return jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)


class TestBitslice:
    @pytest.mark.parametrize("axis", [0, -1])
    def test_pack_unpack_match(self, axis):
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, (16, 24)).astype(np.uint8)
        jp = _np(jbs.pack_bits(jnp.asarray(bits), axis=axis))
        tp = tbs.pack_bits(_t(bits), axis=axis).numpy()
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(tbs.unpack_bits(_t(tp), axis=axis).numpy(), bits)

    def test_planes_and_sign_magnitude(self):
        rng = np.random.default_rng(1)
        w = rng.integers(-127, 128, (5, 32)).astype(np.int8)
        js, jm = jbs.to_sign_magnitude(jnp.asarray(w))
        ts, tm = tbs.to_sign_magnitude(_t(w))
        np.testing.assert_array_equal(_np(js), ts.numpy())
        np.testing.assert_array_equal(_np(jm), tm.numpy())
        jpl = _np(jbs.bitplanes(jm))
        np.testing.assert_array_equal(jpl, tbs.bitplanes(tm).numpy())
        np.testing.assert_array_equal(tbs.from_sign_magnitude(
            ts, tbs.from_bitplanes(tbs.bitplanes(tm))).numpy(), w.astype(np.int32))


class TestQuantizers:
    def test_quantize_kv_bit_exact(self):
        rng = np.random.default_rng(2)
        x = (rng.normal(size=(3, 7, 2, 16)) * rng.uniform(0.1, 10, (3, 7, 2, 1))
             ).astype(np.float32)
        x[0, 0, 0] = 0.0  # all-zero row: the 1e-8 floor
        jq, js = jkvc.quantize_kv(jnp.asarray(x))
        tq, ts = tkvc.quantize_kv(_t(x))
        np.testing.assert_array_equal(_np(jq), tq.numpy())
        np.testing.assert_array_equal(_np(js), ts.numpy())
        np.testing.assert_array_equal(
            _np(jkvc.dequantize_kv(jq, js, jnp.float32)),
            tkvc.dequantize_kv(tq, ts, torch.float32).numpy())

    def test_bitplanes_roundtrip_bit_exact(self):
        rng = np.random.default_rng(3)
        k = rng.integers(-127, 128, (4, 1, 2, 16)).astype(np.int8)
        jp, js = jkvc.k_to_bitplanes(jnp.asarray(k))
        tp, ts = tkvc.k_to_bitplanes(_t(k))
        np.testing.assert_array_equal(_np(jp), tp.numpy())
        np.testing.assert_array_equal(_np(js), ts.numpy())
        np.testing.assert_array_equal(tkvc.bitplanes_to_k(tp, ts).numpy(),
                                      k.astype(np.int32))


def _layouts(cfgs, fmt, layout, batch=3, max_seq=32, page=8, num_pages=None):
    jcfg, tcfg = cfgs
    kw = dict(kv_format=fmt, layout=layout, page_size=page, num_pages=num_pages)
    return jkvc.layout_for(jcfg, batch, max_seq, **kw), tkvc.layout_for(tcfg, batch, max_seq, **kw)


def _table(rng, B, pp, num_pages):
    """Shuffled page table with some unmapped (-1) pages."""
    t = rng.permutation(num_pages)[:B * pp].reshape(B, pp).astype(np.int32)
    t[rng.random((B, pp)) < 0.3] = -1
    return t


class TestWrites:
    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_write_token_with_drops(self, cfgs, fmt, layout):
        """Per-slot decode writes, with out-of-range positions (and, paged,
        unmapped pages) dropped exactly as JAX drops them."""
        jcfg, tcfg = cfgs
        jl, tl = _layouts(cfgs, fmt, layout, num_pages=16)
        rng = np.random.default_rng(4)
        jc = jkvc.init_cache_arrays(jcfg, jl)
        tc = tkvc.init_cache_arrays(tcfg, tl, device="cpu")
        kw_j, kw_t = {}, {}
        if layout == "paged":
            table = _table(rng, 3, jl.pages_per_slot, 16)
            jc["page_table"], tc["page_table"] = jnp.asarray(table), _t(table)
            kw_j = dict(page_table=jc["page_table"], page_size=8, max_seq=32)
            kw_t = dict(page_table=tc["page_table"], page_size=8, max_seq=32)
        # JAX's .at[] wraps negative indices into the slot stack's S axis
        # (serving never writes a negative position); the paged map drops them
        neg = -1 if layout == "paged" else 1 << 30
        for step, tpos in enumerate(([0, 5, 31], [9, 40, neg], [17, 3, 32],
                                     [neg, 99, 100])):
            k = rng.normal(size=(3, 1, 2, 16)).astype(np.float32)
            v = rng.normal(size=(3, 1, 2, 16)).astype(np.float32)
            tp = np.asarray(tpos, np.int32)
            jc["global"] = jkvc.write_token(jc["global"], step % 2, jnp.asarray(k),
                                            jnp.asarray(v), jnp.asarray(tp), **kw_j)
            tkvc.write_token(tc["global"], step % 2, _t(k), _t(v), _t(tp), **kw_t)
        _assert_tree_equal(jc["global"], tc["global"])

    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_write_prefill_chunks_slots_and_batch(self, cfgs, fmt, layout):
        """Chunked writes (padded lanes and OOB lanes drop), one-slot
        prompts and whole-batch prompts land where JAX puts them."""
        jcfg, tcfg = cfgs
        jl, tl = _layouts(cfgs, fmt, layout)
        rng = np.random.default_rng(5)
        jc = jkvc.init_cache_arrays(jcfg, jl)
        tc = tkvc.init_cache_arrays(tcfg, tl, device="cpu")
        kw_j, kw_t = {}, {}
        if layout == "paged":
            table = _table(rng, 3, jl.pages_per_slot, jl.num_pages)
            jc["page_table"], tc["page_table"] = jnp.asarray(table), _t(table)
            kw_j = dict(page_table=jc["page_table"], page_size=8, max_seq=32)
            kw_t = dict(page_table=tc["page_table"], page_size=8, max_seq=32)
        rnd = lambda *s: rng.normal(size=s).astype(np.float32)
        # whole batch, [0, 12)
        k, v = rnd(3, 12, 2, 16), rnd(3, 12, 2, 16)
        jc["global"] = jkvc.write_prefill(jc["global"], 0, jnp.asarray(k), jnp.asarray(v), **kw_j)
        tkvc.write_prefill(tc["global"], 0, _t(k), _t(v), **kw_t)
        # one slot, [0, 10)
        k, v = rnd(1, 10, 2, 16), rnd(1, 10, 2, 16)
        jc["global"] = jkvc.write_prefill(jc["global"], 1, jnp.asarray(k), jnp.asarray(v),
                                          slot=2, **kw_j)
        tkvc.write_prefill(tc["global"], 1, _t(k), _t(v), slot=2, **kw_t)
        # chunks: padded lanes past length, and a chunk running off max_seq
        for slot, off, length in ((1, 4, 5), (0, 28, 8), (2, 30, 3)):
            k, v = rnd(1, 8, 2, 16), rnd(1, 8, 2, 16)
            jc["global"] = jkvc.write_prefill(
                jc["global"], 0, jnp.asarray(k), jnp.asarray(v), slot=slot,
                offset=off, length=length, **kw_j)
            tkvc.write_prefill(tc["global"], 0, _t(k), _t(v), slot=slot, offset=off,
                               length=length, **kw_t)
        _assert_tree_equal(jc["global"], tc["global"])


class TestPagedAddressing:
    def test_phys_table_and_write_map(self, cfgs):
        rng = np.random.default_rng(6)
        table = _table(rng, 3, 4, 20)
        np.testing.assert_array_equal(
            _np(jkvc.phys_table(jnp.asarray(table), 8, 32)),
            tkvc.phys_table(_t(table), 8, 32).numpy())
        tpos = np.asarray([3, 40, -2], np.int32)
        np.testing.assert_array_equal(
            _np(jkvc._phys_write(jnp.asarray(table), jnp.asarray(tpos), 8, 32)),
            tkvc._phys_write(_t(table), _t(tpos), 8, 32).numpy())
        lanes = np.arange(12, dtype=np.int32) + 25
        np.testing.assert_array_equal(
            _np(jkvc._phys_write(jnp.asarray(table), jnp.asarray(lanes), 8, 32, slot=1)),
            tkvc._phys_write(_t(table), _t(lanes), 8, 32, slot=1).numpy())

    def test_identity_page_table(self, cfgs):
        jl, tl = _layouts(cfgs, "int8", "paged")
        np.testing.assert_array_equal(_np(jkvc.identity_page_table(jl)),
                                      tkvc.identity_page_table(tl, device="cpu").numpy())

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_paged_gathers_match(self, cfgs, fmt):
        jcfg, tcfg = cfgs
        jl, tl = _layouts(cfgs, fmt, "paged")
        rng = np.random.default_rng(7)
        jc = jkvc.init_cache_arrays(jcfg, jl)
        tc = tkvc.init_cache_arrays(tcfg, tl, device="cpu")
        table = np.arange(12, dtype=np.int32)[::-1].reshape(3, 4).copy()
        jc["page_table"], tc["page_table"] = jnp.asarray(table), _t(table)
        k, v = (rng.normal(size=(3, 32, 2, 16)).astype(np.float32) for _ in range(2))
        kw = dict(page_size=8, max_seq=32)
        jc["global"] = jkvc.write_prefill(jc["global"], 1, jnp.asarray(k), jnp.asarray(v),
                                          page_table=jc["page_table"], **kw)
        tkvc.write_prefill(tc["global"], 1, _t(k), _t(v), page_table=tc["page_table"], **kw)
        jphys = jkvc.phys_table(jc["page_table"], 8, 32)
        tphys = tkvc.phys_table(tc["page_table"], 8, 32)
        _assert_tree_equal(jkvc.paged_entry(jc["global"], 1, jphys),
                           tkvc.paged_entry(tc["global"], 1, tphys))
        if fmt == "bgpp":
            np.testing.assert_array_equal(
                _np(jkvc.paged_plane(jc["global"], 1, 6, jphys)),
                tkvc.paged_plane(tc["global"], 1, 6, tphys).numpy())
            np.testing.assert_array_equal(
                _np(jkvc.paged_sign(jc["global"], 1, jphys)),
                tkvc.paged_sign(tc["global"], 1, tphys).numpy())
            idx = rng.integers(0, 32, (3, 2, 5)).astype(np.int32)
            jrows = jkvc.paged_rows_at(jphys, jnp.asarray(idx))
            trows = tkvc.paged_rows_at(tphys, _t(idx).long())
            np.testing.assert_array_equal(_np(jrows), trows.numpy())
            np.testing.assert_array_equal(
                _np(jkvc.paged_plane_rows(jc["global"], 1, 3, jrows)),
                tkvc.paged_plane_rows(tc["global"], 1, 3, trows).numpy())
            _assert_tree_equal(jkvc.paged_topk_entry(jc["global"], 1, jrows),
                               tkvc.paged_topk_entry(tc["global"], 1, trows))


class TestScrubs:
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_reset_slot_and_zero_pages(self, cfgs, fmt):
        jcfg, tcfg = cfgs
        rng = np.random.default_rng(8)
        for layout in LAYOUTS:
            jl, tl = _layouts(cfgs, fmt, layout)
            jc = jkvc.init_cache_arrays(jcfg, jl)
            tc = tkvc.init_cache_arrays(tcfg, tl, device="cpu")
            kw_j, kw_t = {}, {}
            if layout == "paged":
                table = np.arange(12, dtype=np.int32).reshape(3, 4)
                jc["page_table"], tc["page_table"] = jnp.asarray(table), _t(table)
                kw_j = dict(page_table=jc["page_table"], page_size=8, max_seq=32)
                kw_t = dict(page_table=tc["page_table"], page_size=8, max_seq=32)
            k, v = (rng.normal(size=(3, 32, 2, 16)).astype(np.float32) for _ in range(2))
            jc["global"] = jkvc.write_prefill(jc["global"], 0, jnp.asarray(k),
                                              jnp.asarray(v), **kw_j)
            tkvc.write_prefill(tc["global"], 0, _t(k), _t(v), **kw_t)
            jc["pos"] = jnp.asarray([5, 6, 7], jnp.int32)
            tc["pos"] = _t(np.asarray([5, 6, 7], np.int32))
            jc = jkvc.reset_slot(jc, jl, 1)
            tkvc.reset_slot(tc, tl, 1)
            if layout == "paged":
                ids = np.asarray([4, -1, 9, -1], np.int32)
                jc["global"] = jkvc.zero_pages(jc["global"], jnp.asarray(ids), 8)
                tkvc.zero_pages(tc["global"], ids, 8)
                assert tkvc.page_bytes(tc["global"], 8) == jkvc.page_bytes(jc["global"], 8)
            _assert_tree_equal(jc, tc)


class TestByteAccounting:
    @pytest.mark.parametrize("fmt,per_step", [("bf16", 65536), ("int8", 20480),
                                              ("bgpp", 8192)])
    def test_decode_read_bytes_bench_geometry(self, cfgs, fmt, per_step):
        """BENCH_serving.json's smoke geometry (2 slots, max_seq 64)."""
        jcfg, tcfg = cfgs
        for layout in LAYOUTS:
            jl, tl = _layouts(cfgs, fmt, layout, batch=2, max_seq=64)
            j, t = jkvc.decode_read_bytes(jl, jcfg), tkvc.decode_read_bytes(tl, tcfg)
            assert t["total"] == j["total"] == per_step
            assert t["bf16_equiv"] == j["bf16_equiv"]
            if fmt == "bgpp":
                assert t["bgpp"] == j["bgpp"]
            assert tkvc.chunk_read_bytes(tl, tcfg)["total"] == \
                jkvc.chunk_read_bytes(jl, jcfg)["total"]

    @pytest.mark.parametrize("S", [1, 7, 64, 1000, 1024])
    @pytest.mark.parametrize("rounds,keep", [(4, 0.25), (1, 0.5), (7, 0.1), (3, 1.0)])
    def test_bgpp_decode_plan(self, cfgs, S, rounds, keep):
        jcfg, tcfg = cfgs
        from repro.configs.base import apply_bgpp_overrides as japply
        from repro_torch.configs import apply_bgpp_overrides as tapply

        assert tkvc.bgpp_decode_plan(S, tapply(tcfg, rounds, keep)) == \
            jkvc.bgpp_decode_plan(S, japply(jcfg, rounds, keep))

    def test_layout_matches(self, cfgs):
        for fmt in FORMATS:
            for layout in LAYOUTS:
                jl, tl = _layouts(cfgs, fmt, layout)
                for f in dataclasses.fields(tl):
                    assert getattr(tl, f.name) == getattr(jl, f.name), f.name
                assert tl.pages_per_slot == jl.pages_per_slot
