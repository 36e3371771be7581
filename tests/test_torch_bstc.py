"""The port's BSTC codec and its two kernels' plain versions against the
JAX package's.

The same numpy-seeded weights go to both sides: Gaussian and synthetic-LLM
int8 weights (``repro.utils.synthetic``), sparse planes, forced plane sets,
and a plane whose coding would expand.

Tolerances:
  * the codec, the kernel operands, the plane decode (K4's plain version
    against the JAX ``bstc_decode_patterns`` in interpret mode) and the
    reconstruction: bit-exact — all of it is integer.
  * K3's plain version against the JAX ``bstc_matmul(..., apply_scale=True)``
    in interpret mode: every output row within 1e-5 of ``Σ|w·x|·scale``
    over the row.  The products of an integer |w| <= 127 with f32 or bf16
    x are exact in f32; the two sides only sum in other orders, which
    moves a row by a few ulps of that sum.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.analysis import roofline as jroofline
from repro.core import bstc as jbstc
from repro.kernels.bstc_decode import (bstc_decode_patterns as jax_decode,
                                       prepare_encoded_plane as jax_prepare_plane)
from repro.kernels.bstc_matmul import (bstc_matmul as jax_bstc_matmul,
                                       prepare_bstc_matmul_operands as jax_prepare_ops)
from repro.kernels.bstc_matmul.ops import reconstruct_dense_weight as jax_reconstruct
from repro.utils.synthetic import synthetic_llm_weight_int8

from repro_torch.analysis import roofline as troofline
from repro_torch.core import bstc as tbstc
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.bstc_decode import bstc_decode_patterns, prepare_encoded_plane
from repro_torch.kernels.bstc_decode.ref import decode_patterns_ref
from repro_torch.kernels.bstc_matmul import (bstc_matmul, prepare_bstc_matmul_operands,
                                             reconstruct_dense_weight)
from repro_torch.kernels.bstc_matmul.ref import bstc_matmul_ref

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gauss_int8(rng, M, H):
    """Per-row max-scaled Gaussian int8 weight (what ``quantize`` makes)."""
    w = rng.normal(size=(M, H)).astype(np.float32)
    scale = np.maximum(np.abs(w).max(1), 1e-12) / 127.0
    return np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8), scale


def _weights():
    rng = np.random.default_rng(0)
    llm, llm_scale = synthetic_llm_weight_int8(rng, (64, 512))
    gauss, gauss_scale = _gauss_int8(rng, 96, 192)
    sparse = (rng.integers(-127, 128, (32, 256))
              * (rng.random((32, 256)) < 0.05)).astype(np.int8)
    return {"llm": (llm, llm_scale), "gauss": (gauss, gauss_scale),
            "sparse": (sparse, np.ones(32, np.float32))}


WEIGHTS = _weights()


def _same_plane(tenc, jenc):
    _eq(tenc.bitmap, jenc.bitmap)
    _eq(tenc.patterns, jenc.patterns)  # same cap, same padding
    _eq(tenc.nnz, jenc.nnz)
    assert (tenc.m, tenc.encoded_bits, tenc.raw_bits, tenc.storage_bits) == \
        (jenc.m, jenc.encoded_bits, jenc.raw_bits, jenc.storage_bits)


class TestCodec:
    @pytest.mark.parametrize("density", [0.0, 0.03, 0.3, 0.9])
    @pytest.mark.parametrize("m", [1, 4, 8])
    def test_encode_plane_bit_exact(self, density, m):
        rng = np.random.default_rng(int(density * 100) + m)
        plane = (rng.random((32, 136)) < density).astype(np.uint8)
        tenc = tbstc.encode_plane(_t(plane), m)
        jenc = jbstc.encode_plane(plane, m)
        _same_plane(tenc, jenc)
        _eq(tbstc.decode_plane(tenc), jbstc.decode_plane(jenc))
        _eq(tbstc.decode_plane(tenc), plane)

    def test_expand_patterns_bit_order(self):
        patt = np.random.default_rng(1).integers(0, 16, (5, 24)).astype(np.int32)
        _eq(tbstc.expand_patterns(_t(patt), 4), jbstc.expand_patterns(jnp.asarray(patt), 4))

    @pytest.mark.parametrize("name", sorted(WEIGHTS))
    @pytest.mark.parametrize("mode", ["threshold", "forced", "everything"])
    def test_encode_weight_bit_exact(self, name, mode):
        w, scale = WEIGHTS[name]
        kw = {"threshold": dict(), "forced": dict(force_planes=[2, 3, 4, 5, 6]),
              # threshold 0 offers every plane to the coder: dense low planes
              # would expand and must stay raw
              "everything": dict(threshold=0.0)}[mode]
        tw = tbstc.encode_weight(_t(w), _t(scale), m=4, **kw)
        jw = jbstc.encode_weight(w, scale, m=4, **kw)
        assert [e is None for e in tw.encoded] == [e is None for e in jw.encoded]
        for te, je in zip(tw.encoded, jw.encoded):
            if je is not None:
                _same_plane(te, je)
        for tr, jr in zip(tw.raw_planes, jw.raw_planes):
            assert (tr is None) == (jr is None)
            if jr is not None:
                _eq(tr, jr)
        _eq(tw.sign, jw.sign)
        _eq(tw.scale, jw.scale)
        _eq(tw.plane_sparsity, jw.plane_sparsity)
        assert tw.plane_sparsity.dtype == torch.float32
        assert (tw.shape, tw.m, tw.nbits, tw.raw_bits, tw.encoded_bits, tw.hbm_bytes) == \
            (jw.shape, jw.m, jw.nbits, jw.raw_bits, jw.encoded_bits, jw.hbm_bytes)
        assert tw.compression_ratio == jw.compression_ratio
        _eq(tbstc.decode_weight(tw), jbstc.decode_weight(jw))
        _eq(tbstc.decode_weight(tw), w)
        if mode == "everything" and name != "sparse":
            assert any(e is None for e in jw.encoded)  # a dense plane would expand

    def test_llm_weight_codes_planes(self):
        w, scale = WEIGHTS["llm"]
        assert any(e is not None for e in tbstc.encode_weight(_t(w), _t(scale)).encoded)

    def test_closed_forms(self):
        for m in (1, 4, 8):
            for sc in (0.0, 0.5, 0.93):
                assert tbstc.compression_ratio_closed_form(m, sc) == \
                    jbstc.compression_ratio_closed_form(m, sc)
                assert tbstc.expected_column_sparsity(sc, m) == \
                    jbstc.expected_column_sparsity(sc, m)
        for cs in (None, [None] * 6 + [0.9], [0.5, None, 0.7, None, None, 0.2, 0.99]):
            assert troofline.bstc_weight_traffic(96, 192, col_sparsity=cs, dtype_bytes=4) == \
                jroofline.bstc_weight_traffic(96, 192, col_sparsity=cs, dtype_bytes=4)


class TestOperands:
    @pytest.mark.parametrize("tile_k", [8, 16, 136])
    def test_prepare_encoded_plane_bit_exact(self, tile_k):
        rng = np.random.default_rng(tile_k)
        plane = (rng.random((40, 272)) < 0.15).astype(np.uint8)
        tops = prepare_encoded_plane(tbstc.encode_plane(_t(plane), 4), tile_k=tile_k)
        jops = jax_prepare_plane(jbstc.encode_plane(plane, 4), tile_k=tile_k)
        for f in ("bitmap", "tile_offsets", "patterns"):
            _eq(getattr(tops, f), getattr(jops, f))
        assert (tops.H, tops.m, tops.compressed_bytes) == (jops.H, jops.m, jops.compressed_bytes)

    @pytest.mark.parametrize("name", sorted(WEIGHTS))
    @pytest.mark.parametrize("tile_k", [8, 32, None])
    def test_matmul_operands_and_reconstruction_bit_exact(self, name, tile_k):
        w, scale = WEIGHTS[name]
        tile_k = tile_k or w.shape[1]
        tops = prepare_bstc_matmul_operands(_t(w), _t(scale), tile_k=tile_k)
        jops = jax_prepare_ops(w, scale, tile_k=tile_k)
        assert (tops.enc_planes, tops.raw_planes, tops.m, tops.M, tops.H) == \
            (jops.enc_planes, jops.raw_planes, jops.m, jops.M, jops.H)
        assert len(tops.enc) == len(jops.enc) and len(tops.raw) == len(jops.raw)
        for a, b in zip(tops.enc + tops.raw, jops.enc + jops.raw):
            _eq(a, b)
        _eq(tops.sign_bits, jops.sign_bits)
        _eq(tops.scale, jops.scale)
        assert tops.tile_k == (tile_k if jops.enc_planes else w.shape[1])
        assert (tops.hbm_bytes, tops.dense_bytes) == (jops.hbm_bytes, jops.dense_bytes)
        reset_launches()
        rebuilt = reconstruct_dense_weight(tops)
        assert LAUNCHES["bstc_decode"] == 0  # CPU: plain version
        _eq(rebuilt, jax_reconstruct(jops))
        _eq(rebuilt, w.astype(np.int32))


class TestKernelPlainVersions:
    @pytest.mark.parametrize("density", [0.0, 0.05, 0.4])
    def test_decode_plain_matches_jax_interpret(self, density):
        rng = np.random.default_rng(int(density * 1000))
        plane = (rng.random((64, 512)) < density).astype(np.uint8)  # G = 16
        tops = prepare_encoded_plane(tbstc.encode_plane(_t(plane), 4), tile_k=128)
        jops = jax_prepare_plane(jbstc.encode_plane(plane, 4), tile_k=128)
        reset_launches()
        got = bstc_decode_patterns(tops)
        assert LAUNCHES["bstc_decode"] == 0
        assert got.dtype == torch.uint8 and tuple(got.shape) == (16, 512)
        _eq(got, jax_decode(jops, mode="interpret"))
        _eq(got, decode_patterns_ref(_t(np.asarray(jbstc.encode_plane(plane, 4).bitmap)),
                                     tops.patterns))

    @pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("name", ["llm", "sparse"])
    def test_matmul_plain_matches_jax_interpret(self, name, x_dtype):
        w, scale = WEIGHTS[name]
        M, H = w.shape
        rng = np.random.default_rng(M + H)
        x = rng.normal(size=(H, 4)).astype(np.float32)
        jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32)
        tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))
        tops = prepare_bstc_matmul_operands(_t(w), _t(scale), tile_k=128)
        jops = jax_prepare_ops(w, scale, tile_k=128)
        want = np.asarray(jax_bstc_matmul(jops, jx, tile_m=min(32, M), apply_scale=True,
                                          mode="interpret"))
        reset_launches()
        got = bstc_matmul(tops, tx, apply_scale=True)
        assert LAUNCHES["bstc_matmul"] == 0 and LAUNCHES["bstc_decode"] == 0
        assert got.dtype == torch.float32 and tuple(got.shape) == (M, 4)
        row_scale = (np.abs(w.astype(np.float64)) @ np.abs(tx.double().numpy())
                     * scale[:, None].astype(np.float64)).max(1)
        err = np.abs(got.numpy() - want).max(1)
        assert np.all(err <= 1e-5 * row_scale), float((err / np.maximum(row_scale, 1e-30)).max())
        np.testing.assert_array_equal(
            got.numpy(), bstc_matmul_ref(_t(w.astype(np.int32)), tx, _t(scale)).numpy())

    @pytest.mark.parametrize("layout", ["rows", "activations_t"])
    def test_matmul_without_scale_and_any_width(self, layout):
        """x as a row-major (H, N) tensor, or as ``wdot`` passes it: the
        transposed view of (N, H) activation rows, read without a copy."""
        w, scale = WEIGHTS["gauss"]
        tops = prepare_bstc_matmul_operands(_t(w), _t(scale), tile_k=192)
        x = torch.from_numpy(np.random.default_rng(3).normal(size=(192, 11)).astype(np.float32))
        if layout == "activations_t":
            x = x.T.contiguous().T
            assert x.stride() == (1, 192)
        got = bstc_matmul(tops, x)
        want = torch.from_numpy(w.astype(np.float32)) @ x
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

    def test_rejects_bad_operands(self):
        w, scale = WEIGHTS["gauss"]
        tops = prepare_bstc_matmul_operands(_t(w), _t(scale), tile_k=192)
        with pytest.raises(ValueError, match="x must be"):
            bstc_matmul(tops, torch.zeros(96, 4))
        with pytest.raises(ValueError, match="x lies on meta"):
            bstc_matmul(tops, torch.zeros(192, 4, device="meta"))
        # the operands are checked once, where they are built
        with pytest.raises(ValueError, match="different devices"):
            dataclasses.replace(tops, sign_bits=tops.sign_bits.to("meta"))
        with pytest.raises(ValueError, match="multiple of m"):
            dataclasses.replace(tops, M=tops.M - 1)
        with pytest.raises(ValueError, match="tile_k"):
            prepare_bstc_matmul_operands(_t(w), tile_k=100)
        plane = prepare_encoded_plane(tbstc.encode_plane(torch.zeros(8, 64, dtype=torch.uint8),
                                                         4), tile_k=64)
        with pytest.raises(ValueError, match="bitmap"):
            bstc_decode_patterns(plane._replace(H=72))
