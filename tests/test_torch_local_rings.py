"""The local ring layers on the port against the JAX package's, on the CPU:
gemma3's sliding-window rings, mixtral's (every layer a ring) and
llama4-scout's chunked-local ones.

The same numpy-seeded inputs and the same JAX-initialised smoke parameters
(brought across with ``interop.params_from_numpy``) go through ``repro``
and ``repro_torch``:

  * the layout (which layers are rings, the window), the fresh cache tree
    and the byte counters ``decode_read_bytes`` / ``chunk_read_bytes`` are
    equal, in every KV format and layout;
  * the ring writes (``write_prefill_local`` whole-batch, into one slot and
    chunk by chunk, ``write_token`` at ``pos % W``) and ``reset_slot`` leave
    stores equal bit for bit, ``abs_pos`` included (writes copy, they do not
    compute);
  * after ``prefill``, ``prefill_into_slot`` and chunked prefill the caches
    hold the same positions bit for bit and the same values within the
    forward's bounds: f32 K/V within 1e-5, int8 codes within one step (the
    forward's float sums differ by ulps, so a code may round the other way
    at a .5 boundary).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import model_zoo as jzoo
from repro.serving import engine as jengine, kv_cache as jkvc

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.serving import engine, kv_cache as tkvc

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

# mixtral-smoke: rings only (no global store, no page pool); llama4-scout-
# smoke: chunked-local rings 3:1 with a global layer
ARCHS = ["gemma3-1b", "gemma3-4b", "deepseek-7b", "mixtral-8x22b", "llama4-scout-17b-a16e"]
FORMATS = ["bf16", "int8", "bgpp"]
LAYOUTS = ["slot", "paged"]
MAX_SEQ, PAGE = 48, 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_tree_equal(jtree, ttree):
    assert set(jtree) == set(ttree)
    for n in jtree:
        if isinstance(jtree[n], dict):
            _assert_tree_equal(jtree[n], ttree[n])
            continue
        a = tensor_from_numpy(np.asarray(jtree[n]), "cpu")
        assert a.shape == ttree[n].shape and a.dtype == ttree[n].dtype, n
        assert torch.equal(a, ttree[n]), n


_MODELS = {}


def _model(arch):
    """JAX-initialised smoke parameters, and their copy on the port."""
    if arch not in _MODELS:
        jcfg = jax_config(arch, smoke=True)
        jparams, _ = jzoo.init(jax.random.key(0), jcfg)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        _MODELS[arch] = (jcfg, get_config(arch, smoke=True), jparams, tparams)
    return _MODELS[arch]


def _layouts(arch, fmt, layout, batch=2, max_seq=MAX_SEQ):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    return (jkvc.layout_for(jcfg, batch, max_seq, kv_format=fmt, layout=layout,
                            page_size=PAGE),
            tkvc.layout_for(cfg, batch, max_seq, kv_format=fmt, layout=layout,
                            page_size=PAGE))


class TestLayoutAndBytes:
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("arch", ARCHS)
    def test_layout_cache_and_bytes_match_jax(self, arch, fmt, layout):
        jl, tl = _layouts(arch, fmt, layout)
        for f in dataclasses.fields(tl):
            assert getattr(tl, f.name) == getattr(jl, f.name), f.name
        assert not jl.mamba_layers and not jl.has_cross
        if arch.startswith("gemma3"):
            assert tl.local_window == 16 and len(tl.global_layers) == 1
            assert tl.local_layers == (0, 1, 2, 3, 4)
        if arch == "mixtral-8x22b":
            assert tl.global_layers == () and tl.local_layers == (0, 1)
        if arch == "llama4-scout-17b-a16e":
            assert tl.global_layers == (3,) and tl.local_window == 16
        jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
        _assert_tree_equal(jkvc.init_cache_arrays(jcfg, jl),
                           tkvc.init_cache_arrays(cfg, tl, "cpu"))
        jd, td = jkvc.decode_read_bytes(jl, jcfg), tkvc.decode_read_bytes(tl, cfg)
        for key in ("global", "local", "total", "bf16_equiv"):
            assert td[key] == jd[key], key
        assert td.get("bgpp") == jd.get("bgpp")
        jc, tc = jkvc.chunk_read_bytes(jl, jcfg), tkvc.chunk_read_bytes(tl, cfg)
        for key in ("global", "local", "total"):
            assert tc[key] == jc[key], key


class TestRingWrites:
    """``write_prefill_local`` / ``write_token`` / ``reset_slot`` on the
    ring store against JAX's, bit for bit (the window clamps to 16)."""

    @staticmethod
    def _stores(fmt, batch=3):
        jl, tl = _layouts("gemma3-4b", fmt, "slot", batch=batch)
        jcfg, cfg = jax_config("gemma3-4b", smoke=True), get_config("gemma3-4b", smoke=True)
        return jl, tl, jkvc.init_cache_arrays(jcfg, jl), tkvc.init_cache_arrays(cfg, tl, "cpu")

    @staticmethod
    def _kv(rng, B, S, cfg):
        shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
        return (rng.normal(size=shape).astype(np.float32),
                rng.normal(size=shape).astype(np.float32))

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_prefill_local_whole_slot_and_chunks(self, fmt):
        jl, tl, jc, tc = self._stores(fmt)
        cfg = get_config("gemma3-4b", smoke=True)
        W, rng = tl.local_window, np.random.default_rng(0)
        # whole batch past the window (the ring wraps), then a short one
        for S in (37, 9):
            k, v = self._kv(rng, 3, S, cfg)
            jc["local"] = jkvc.write_prefill_local(jc["local"], 1, jnp.asarray(k),
                                                   jnp.asarray(v), W)
            tkvc.write_prefill_local(tc["local"], 1, _t(k), _t(v), W)
            _assert_tree_equal(jc["local"], tc["local"])
        # one slot of a live cache, past the window
        k, v = self._kv(rng, 1, 21, cfg)
        jc["local"] = jkvc.write_prefill_local(jc["local"], 3, jnp.asarray(k),
                                               jnp.asarray(v), W, slot=2)
        tkvc.write_prefill_local(tc["local"], 3, _t(k), _t(v), W, slot=2)
        _assert_tree_equal(jc["local"], tc["local"])
        # chunks of a prompt: padded lanes, a chunk wider than the window,
        # a chunk that wraps the ring
        for offset, C, length in ((0, 8, 5), (5, 8, 8), (13, 24, 20), (33, 8, 3)):
            k, v = self._kv(rng, 1, C, cfg)
            jc["local"] = jkvc.write_prefill_local(
                jc["local"], 0, jnp.asarray(k), jnp.asarray(v), W, slot=1,
                offset=jnp.int32(offset), length=jnp.int32(length))
            tkvc.write_prefill_local(tc["local"], 0, _t(k), _t(v), W, slot=1,
                                     offset=offset, length=length)
            _assert_tree_equal(jc["local"], tc["local"])

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_ring_token_writes_and_reset(self, fmt):
        jl, tl, jc, tc = self._stores(fmt)
        cfg = get_config("gemma3-4b", smoke=True)
        W, rng = tl.local_window, np.random.default_rng(1)
        pos = np.asarray([3, 17, 40], np.int32)
        for _ in range(20):  # every slot's lane wraps at least once
            k, v = self._kv(rng, 3, 1, cfg)
            lane = pos % W
            jc["local"] = jkvc.write_token(jc["local"], 2, jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(lane))
            jc["local"]["abs_pos"] = jc["local"]["abs_pos"].at[2, jnp.arange(3), lane].set(pos)
            tkvc.write_token(tc["local"], 2, _t(k), _t(v), _t(lane).long())
            tc["local"]["abs_pos"][2, torch.arange(3), _t(lane).long()] = _t(pos)
            pos = pos + 1
        _assert_tree_equal(jc["local"], tc["local"])
        for layout in LAYOUTS:
            jl, tl = _layouts("gemma3-4b", fmt, layout, batch=3)
            jc = jkvc.reset_slot(jc, jl, 1)
            tkvc.reset_slot(tc, tl, 1)
            _assert_tree_equal(jc["local"], tc["local"])
            assert (tc["local"]["abs_pos"][:, 1] == -1).all()
            np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _assert_cache_close(tc, jc, fmt):
    """A port cache against JAX's after a forward: positions, page table and
    ``abs_pos`` bit for bit; f32 K/V within 1e-5; int8 codes within one
    step, scales within 1e-5 relative; bgpp planes re-encode the port's own
    codes."""
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    if "page_table" in jc:
        np.testing.assert_array_equal(tc["page_table"].numpy(), np.asarray(jc["page_table"]))
    for store in ("global", "local"):
        assert (store in tc) == (store in jc)
        if store not in jc:
            continue
        tg = tc[store]
        jg = {n: tensor_from_numpy(np.asarray(a), "cpu") for n, a in jc[store].items()}
        assert set(tg) == set(jg)
        for n in tg:
            assert tg[n].shape == jg[n].shape and tg[n].dtype == jg[n].dtype, (store, n)
        if "abs_pos" in jg:
            assert torch.equal(tg["abs_pos"], jg["abs_pos"])
        sfmt = ("int8" if fmt == "bgpp" else fmt) if store == "local" else fmt
        if sfmt == "bf16":
            for n in ("k", "v"):
                torch.testing.assert_close(tg[n], jg[n], rtol=0, atol=1e-5)
            continue
        for n in ("k_scale", "v_scale"):
            torch.testing.assert_close(tg[n], jg[n], rtol=1e-5, atol=1e-12)
        codes = lambda g: (tkvc.bitplanes_to_k(g["k_planes"].movedim(1, 0), g["k_sign"])
                           if sfmt == "bgpp" else g["k"].to(torch.int32))
        for got, want in ((codes(tg), codes(jg)),
                          (tg["v"].to(torch.int32), jg["v"].to(torch.int32))):
            assert int((got - want).abs().max()) <= 1
        if sfmt == "bgpp":
            planes, sign = tkvc.k_to_bitplanes(codes(tg).to(torch.int8))
            assert torch.equal(planes.movedim(0, 1), tg["k_planes"])
            assert torch.equal(sign, tg["k_sign"])


class TestPrefillPaths:
    """The three ways a prompt reaches the cache, against JAX's: the rings
    wrap (prompts past the 16-lane window)."""

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_prefill_and_into_slot(self, fmt, layout):
        jcfg, cfg, jparams, tparams = _model("gemma3-4b")
        jl, tl = _layouts("gemma3-4b", fmt, layout)
        toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 29)).astype(np.int32)
        jlog, jc = jax.jit(jengine.prefill, static_argnums=(1, 2))(
            jparams, jcfg, jl, jnp.asarray(toks))
        log, tc = engine.prefill(tparams, cfg, tl, torch.from_numpy(toks).long())
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
        _assert_cache_close(tc, jc, fmt)
        # two admissions into a live cache, the second into the first's
        # neighbour (paged: a shuffled page table)
        jc = jkvc.init_cache_arrays(jcfg, jl)
        tc = tkvc.init_cache_arrays(cfg, tl, "cpu")
        if layout == "paged":
            table = np.asarray([[5, 1, 6, 3, -1, -1], [2, 7, 0, 4, -1, -1]], np.int32)
            jc["page_table"], tc["page_table"] = jnp.asarray(table), _t(table)
        rng = np.random.default_rng(11)
        jadmit = jax.jit(jengine.prefill_into_slot, static_argnums=(1, 2, 4))
        for slot, n in ((1, 27), (0, 13)):
            prompt = rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            jlog, jc = jadmit(jparams, jcfg, jl, jc, slot, jnp.asarray(prompt))
            log, tc = engine.prefill_into_slot(tparams, cfg, tl, tc, slot,
                                               torch.from_numpy(prompt).long())
            np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
            _assert_cache_close(tc, jc, fmt)

    @pytest.mark.parametrize("arch", ["gemma3-1b", "gemma3-4b", "mixtral-8x22b",
                                      "llama4-scout-17b-a16e"])
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_chunked_prefill(self, arch, fmt):
        """A 37-token prompt in chunks of 8 (the ring wraps mid-prompt and
        a chunk straddles the wrap) into slot 1 of a slot-layout cache."""
        jcfg, cfg, jparams, tparams = _model(arch)
        jl, tl = _layouts(arch, fmt, "slot")
        prompt = np.random.default_rng(12).integers(0, cfg.vocab_size, (37,)).astype(np.int32)
        jcp = jengine.ChunkedPrefill(jcfg, jl, buckets=(4, 8))
        tcp = engine.ChunkedPrefill(cfg, tl, buckets=(4, 8))
        jlog, jc = jcp.admit(jparams, jkvc.init_cache_arrays(jcfg, jl), 1, prompt)
        log, tc = tcp.admit(tparams, tkvc.init_cache_arrays(cfg, tl, "cpu"), 1, prompt)
        tol = 1e-4 if fmt == "bf16" else 5e-3  # int8: see test_torch_zoo's TF_TOL
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=tol)
        _assert_cache_close(tc, jc, fmt)
        ap = tc["local"]["abs_pos"][:, 1]
        assert sorted(ap[0].tolist()) == list(range(37 - 16, 37))
