"""Property laws of ``tests/test_properties.py`` on the port, the ones a
single device can state (hypothesis, the reference's example counts).

* The forward's attention: ``blocked_attend`` (the ``flash_attention``
  kernel's plain version on the CPU) equals the reference's dense
  ``attend`` under the reference's ``make_mask``, every mask kind, and at
  lengths no tile divides (2e-4, the reference's bound).
* KV-read accounting (``kv_cache.decode_read_bytes`` /
  ``chunk_read_bytes``) at mesh 1x1: the port's counters equal the
  reference's there, where its per-device share is the whole and its
  interconnect moves nothing; ``global + local`` is the total, and a bf16
  cache reads its own bf16 equivalent.  Run on deepseek-7b-smoke (the
  reference's config), gemma3-4b-smoke (local rings beside global layers)
  and jamba-smoke (mamba layers beside a global one; their state is left
  out, as in the reference).  The laws over meshes of more than one device
  wait for sharding.
* Weight-read accounting (``weights.prepare_serve_params``'s plan): the
  total is the plan's and the sum of its projections, bf16 prices the raw
  bytes exactly, BSTC at most halves bf16 and reconciles with its closed
  form within 10 %, and the closed form (``analysis.roofline``) equals the
  reference's ``bstc_weight_traffic`` and its formula, monotone in
  sparsity.
* Round trips through the kernels' plain versions: BSTC encode then
  ``bstc_decode_patterns`` is the identity on group patterns, BRCR's
  factorised GEMM is the dense integer GEMM exactly, and
  ``reconstruct_dense_weight`` rebuilds the int8 weight.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.analysis import roofline as jroofline
from repro.configs import get_config as jax_config
from repro.core import attention as jattention, bstc as jbstc
from repro.serving import kv_cache as jkvc

from repro_torch.analysis.roofline import bstc_weight_traffic
from repro_torch.configs import apply_weight_format_override, get_config
from repro_torch.core import attention, bstc
from repro_torch.kernels.brcr_gemm import brcr_gemm, prepare_brcr_operands
from repro_torch.kernels.bstc_decode import bstc_decode_patterns, prepare_encoded_plane
from repro_torch.kernels.bstc_matmul import prepare_bstc_matmul_operands
from repro_torch.kernels.bstc_matmul.ops import reconstruct_dense_weight
from repro_torch.models import model_zoo
from repro_torch.serving import kv_cache as kvc, weights as swt

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)


class TestBlockedAttendEquivalence:
    @given(st.integers(0, 2**31 - 1), st.sampled_from(["causal", "sliding", "chunked", "full"]))
    @settings(max_examples=12, deadline=None)
    def test_matches_dense_attend(self, seed, kind):
        """The reference's law over its tile shapes (8, 8) / (16, 4) /
        (4, 16); the port's plan sets its own tiles, so the law is drawn
        over seeds and mask kinds."""
        rng = np.random.default_rng(seed)
        B, S, Hq, Hk, D = 1, 32, 4, 2, 8
        q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(np.float32))
                   for h in (Hq, Hk, Hk))
        w = 8 if kind in ("sliding", "chunked") else 0
        got = attention.blocked_attend(q, k, v, mask_kind=kind, window=w)
        want = jattention.attend(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 mask=jattention.make_mask(kind, S, S, w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)

    def test_nondivisible_lengths(self):
        rng = np.random.default_rng(0)
        q = torch.from_numpy(rng.normal(size=(1, 21, 2, 8)).astype(np.float32))
        k, v = (torch.from_numpy(rng.normal(size=(1, 37, 2, 8)).astype(np.float32))
                for _ in range(2))
        got = attention.blocked_attend(q, k, v, mask_kind="full")
        want = jattention.attend(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 mask=jnp.ones((21, 37), bool))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


KV_ARCHS = ["deepseek-7b", "gemma3-4b", "jamba-1.5-large-398b"]


class TestKVReadAccountingLaws:
    @staticmethod
    def _layouts(arch, fmt, layout, slots=4):
        cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
        lay = kvc.layout_for(cfg, slots, 48, kv_format=fmt, layout=layout, page_size=8)
        jlay = jkvc.layout_for(jcfg, slots, 48, kv_format=fmt, layout=layout, page_size=8)
        return cfg, jcfg, lay, jlay

    @given(st.sampled_from(KV_ARCHS), st.sampled_from(["bf16", "int8", "bgpp"]),
           st.sampled_from(["slot", "paged"]))
    @settings(max_examples=18, deadline=None)
    def test_counters_are_the_references_at_1x1(self, arch, fmt, layout):
        """The reference's counters at mesh 1x1 (one shard, the per-device
        share the whole, no interconnect bytes) equal the port's."""
        cfg, jcfg, lay, jlay = self._layouts(arch, fmt, layout)
        for mine, ref in ((kvc.decode_read_bytes(lay, cfg),
                           jkvc.decode_read_bytes(jlay, jcfg, (1, 1))),
                          (kvc.chunk_read_bytes(lay, cfg),
                           jkvc.chunk_read_bytes(jlay, jcfg, (1, 1)))):
            assert ref["interconnect"]["total"] == 0.0
            assert ref["per_device"]["shards"] == 1
            assert ref["per_device"]["total"] == ref["total"]
            for key in ("global", "local", "total"):
                assert mine[key] == ref[key], key

    @pytest.mark.parametrize("arch", KV_ARCHS)
    @pytest.mark.parametrize("layout", ["slot", "paged"])
    def test_total_is_global_plus_local(self, arch, layout):
        """Per format: ``global + local == total``; a bf16 cache reads its
        own bf16 equivalent; a stack with no local layer reads nothing
        local, and jamba's global term is its one attention layer's."""
        for fmt in ("bf16", "int8", "bgpp"):
            cfg, _, lay, _ = self._layouts(arch, fmt, layout)
            for out in (kvc.decode_read_bytes(lay, cfg), kvc.chunk_read_bytes(lay, cfg)):
                assert out["global"] + out["local"] == out["total"], fmt
                if not lay.local_layers:
                    assert out["local"] == 0
            dec = kvc.decode_read_bytes(lay, cfg)
            if fmt == "bf16":
                assert dec["total"] == dec["bf16_equiv"]
            if lay.mamba_layers:
                assert len(lay.global_layers) == 1 and dec["global"] > 0
                ch = kvc.chunk_read_bytes(lay, cfg)
                assert ch["global"] == lay.max_seq * kvc._token_row_bytes(cfg, fmt)


class TestWeightReadAccountingLaws:
    _CACHE = {}

    @classmethod
    def _plan(cls, fmt):
        if fmt not in cls._CACHE:
            cfg = apply_weight_format_override(get_config("deepseek-7b", smoke=True), fmt)
            params = model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
            cls._CACHE[fmt] = (cfg, swt.prepare_serve_params(params, cfg, fmt)[1])
        return cls._CACHE[fmt]

    @pytest.mark.parametrize("fmt", ["bf16", "int8", "bstc"])
    def test_total_is_the_plans_and_its_projections(self, fmt):
        """At mesh 1x1 the one device reads the whole plan."""
        _, plan = self._plan(fmt)
        out = plan.decode_read_bytes()
        np.testing.assert_allclose(out["total"], plan.total_bytes)
        np.testing.assert_allclose(sum(out["per_projection"].values()), out["total"])

    def test_bf16_plan_prices_dense_bytes_exactly(self):
        cfg, plan = self._plan("bf16")
        db = 2 if cfg.dtype == "bfloat16" else 4
        for e in plan.entries:
            want = db * e.copies * e.in_dim * e.out_dim
            assert e.coded_bytes == e.bf16_bytes == want, e.path

    def test_bstc_coded_at_most_half_of_bf16(self):
        _, plan = self._plan("bstc")
        assert plan.total_bytes <= plan.bf16_bytes / 2
        out = plan.decode_read_bytes()
        assert 0.9 <= out["total"] / out["modeled"] <= 1.1

    @given(st.sampled_from([0.7, 0.8, 0.95]), st.sampled_from([2, 4, 8]))
    @settings(max_examples=9, deadline=None)
    def test_traffic_model_matches_closed_form(self, sc, m):
        nbits, in_dim, out_dim = 7, 128, 64
        out = bstc_weight_traffic(in_dim, out_dim, m=m, nbits=nbits, col_sparsity=[sc] * nbits)
        ref = jroofline.bstc_weight_traffic(in_dim, out_dim, m=m, nbits=nbits,
                                            col_sparsity=[sc] * nbits)
        assert out.keys() == ref.keys()
        for key in ref:
            np.testing.assert_allclose(out[key], ref[key], err_msg=key)
        n = in_dim * out_dim
        bits = n + nbits * n / jbstc.compression_ratio_closed_form(m, sc)
        np.testing.assert_allclose(out["bstc_bytes"], bits / 8 + 4 * out_dim)

    def test_traffic_model_monotone_in_sparsity(self):
        vals = [bstc_weight_traffic(128, 64, col_sparsity=[s] * 7)["bstc_bytes"]
                for s in (0.65, 0.8, 0.95)]
        assert vals[0] > vals[1] > vals[2]
        raw = bstc_weight_traffic(128, 64)
        np.testing.assert_allclose(raw["bstc_bytes"], raw["int8_bytes"])
        np.testing.assert_allclose(raw["bstc_bytes"],
                                   jroofline.bstc_weight_traffic(128, 64)["bstc_bytes"])


class TestDispatchRoundTripLaws:
    @given(st.integers(0, 2**31 - 1), st.sampled_from([0.05, 0.3, 0.8]))
    @settings(max_examples=6, deadline=None)
    def test_bstc_encode_decode_identity(self, seed, density):
        rng = np.random.default_rng(seed)
        plane = torch.from_numpy((rng.random((8, 512)) < density).astype(np.uint8))
        enc = bstc.encode_plane(plane, m=4)
        rows = bstc.expand_patterns(bstc_decode_patterns(prepare_encoded_plane(enc)), m=4)
        assert torch.equal(rows, bstc.decode_plane(enc))
        assert torch.equal(rows, plane)

    @given(st.integers(0, 2**31 - 1), st.sampled_from([1, 2, 4]))
    @settings(max_examples=6, deadline=None)
    def test_brcr_factorization_matches_dense_gemm(self, seed, m):
        rng = np.random.default_rng(seed)
        M, H, N = 16, 128, 8
        w = np.round(np.clip(rng.normal(size=(M, H)) * 40, -127, 127)).astype(np.int8)
        x = rng.integers(-100, 100, size=(H, N)).astype(np.float32)
        y = brcr_gemm(prepare_brcr_operands(torch.from_numpy(w), m=m), torch.from_numpy(x))
        np.testing.assert_array_equal(y.numpy().astype(np.int64),
                                      w.astype(np.int64) @ x.astype(np.int64))

    @given(st.integers(0, 2**31 - 1))
    @settings(max_examples=4, deadline=None)
    def test_bstc_matmul_weight_reconstruction_roundtrip(self, seed):
        rng = np.random.default_rng(seed)
        w = np.round(np.clip(rng.normal(size=(8, 512)) * 30, -127, 127)).astype(np.int8)
        got = reconstruct_dense_weight(prepare_bstc_matmul_operands(torch.from_numpy(w), m=4))
        np.testing.assert_array_equal(got.numpy(), w.astype(np.int32))
