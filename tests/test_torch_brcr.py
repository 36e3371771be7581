"""The port's BRCR layer against the JAX package's: bit slices,
quantization, BRCR operands, the BRCR GEMM's plain version, ``brcr_matmul``,
the cost model and the quickstart example.

The same numpy-seeded inputs go to both sides (Gaussian and synthetic-LLM
int8 weights, integer and float activations).  The JAX BRCR kernel runs
in interpret mode, as its own tests run it.

Tolerances:
  * bit slices, sparsities, quantization codes and scales, ``int_matmul``,
    the operands, the tile map, every cost field, the examples' printed
    numbers: bit-exact.
  * the BRCR GEMM and ``brcr_matmul`` with integer x: bit-exact (every
    partial sum is an integer of at most ``Σ|w·x|`` per row, below 2**24
    here, so exact in float32 on both sides).
  * with float x: each row within ``1e-5 · Σ|w·x|`` of it (exact products,
    the sums run in another order).
  * ``quantized_linear``: 1e-6 relative to the output's scale (the same
    float32 ops; XLA and torch may fuse the zero-point correction
    differently).
"""

import contextlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import bitslice as jbit
from repro.core import brcr as jbrcr
from repro.core import quantization as jquant
from repro.kernels.brcr_gemm import brcr_gemm as jax_brcr_gemm
from repro.kernels.brcr_gemm import prepare_brcr_operands as jax_prepare
from repro.kernels.brcr_gemm.ops import tile_nonzero_map as jax_tile_map
from repro.kernels.brcr_gemm.ref import brcr_gemm_ref as jax_brcr_ref
from repro.utils import synthetic as jsyn

from repro_torch.core import bitslice as tbit
from repro_torch.core import brcr as tbrcr
from repro_torch.core import quantization as tquant
from repro_torch.examples import quickstart as tquickstart
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.brcr_gemm import (BRCROperands, brcr_gemm, prepare_brcr_operands,
                                           tile_nonzero_map)
from repro_torch.kernels.brcr_gemm.ref import brcr_gemm_ref, dense_ref
from repro_torch.utils import synthetic as tsyn

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _gauss_int8(rng, M, H, scale=40):
    return np.clip(np.round(rng.normal(size=(M, H)) * scale), -127, 127).astype(np.int8)


def _within_row_sums(got, want, w, x):
    """Every row within 1e-5 of its Σ|w·x| (float sums in another order)."""
    row = np.abs(np.asarray(w, np.float64)) @ np.abs(np.asarray(x, np.float64))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= 1e-5 * row), float((err - 1e-5 * row).max())


class TestBitslice:
    @pytest.mark.parametrize("shape,sigma", [((64, 256), 3), ((33, 40), 20), ((7, 9), 60),
                                             ((128, 1024), 20)])
    def test_sparsities_and_split(self, shape, sigma):
        rng = np.random.default_rng(sum(shape) + sigma)
        w = _gauss_int8(rng, *shape, scale=sigma)
        wj, wt = jnp.asarray(w), _t(w)
        for a, b in zip(jbit.signed_plane_split(wj), tbit.signed_plane_split(wt)):
            _eq(b, a)
        _, mag_j = jbit.to_sign_magnitude(wj)
        _, mag_t = tbit.to_sign_magnitude(wt)
        _eq(tbit.bit_sparsity(tbit.bitplanes(mag_t)), jbit.bit_sparsity(jbit.bitplanes(mag_j)))
        _eq(tbit.value_sparsity(wt), jbit.value_sparsity(wj))
        _eq(tbit.average_bit_sparsity(wt), jbit.average_bit_sparsity(wj))
        _eq(tbit.average_bit_sparsity(wt, 5), jbit.average_bit_sparsity(wj, 5))

    @pytest.mark.parametrize("m", [1, 2, 3, 4])
    def test_group_indices_and_enumeration(self, m):
        rng = np.random.default_rng(m)
        planes = rng.integers(0, 2, size=(3, 4 * m, 24)).astype(np.uint8)
        _eq(tbit.group_indices(_t(planes), m), jbit.group_indices(jnp.asarray(planes), m))
        _eq(tbit.enumeration_matrix(m), jbit.enumeration_matrix(m))
        with pytest.raises(ValueError, match="divisible"):
            tbit.group_indices(_t(planes), 4 * m + 1)

    def test_bit_planar_tensor(self):
        """BGPP's storage format: the packed planes, the sign, one plane
        and the round trip equal the reference's."""
        rng = np.random.default_rng(5)
        w = rng.integers(-127, 128, size=(6, 5, 32)).astype(np.int32)
        j = jbit.BitPlanarTensor.from_int(jnp.asarray(w))
        t = tbit.BitPlanarTensor.from_int(_t(w))
        _eq(t.mag_planes, j.mag_planes)
        _eq(t.sign, j.sign)
        assert t.plane_nbytes == j.plane_nbytes == 6 * 5 * 4
        _eq(t.plane(6), j.plane(6))
        _eq(t.to_int(), w)


class TestQuantization:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_codes_scales_and_int_matmul(self, seed):
        rng = np.random.default_rng(seed)
        w = tsyn.synthetic_llm_weight(rng, (48, 200))
        x = tsyn.synthetic_activation(rng, (200, 7))
        jw, tw = jquant.quantize_weight(jnp.asarray(w)), tquant.quantize_weight(_t(w))
        _eq(tw.q, jw.q)
        _eq(tw.scale, jw.scale)
        _eq(tw.dequantize(), jw.dequantize())
        for cal in ((), (-3.0, 2.5), (0.5, 4.0)):
            jx = jquant.quantize_activation(jnp.asarray(x), *cal)
            tx = tquant.quantize_activation(_t(x), *cal)
            for a, b in zip(tx, jx):
                _eq(a, b)
            _eq(tx.dequantize(), jx.dequantize())
        jx, tx = jquant.quantize_activation(jnp.asarray(x)), tquant.quantize_activation(_t(x))
        _eq(tquant.int_matmul(tw.q, tx.q), jquant.int_matmul(jw.q, jx.q))
        bias = rng.normal(size=(48,)).astype(np.float32)
        for b in (None, bias):
            want = np.asarray(jquant.quantized_linear(jw, jx, None if b is None else
                                                      jnp.asarray(b)))
            got = tquant.quantized_linear(tw, tx, None if b is None else _t(b)).numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        want = np.asarray(jquant.fake_quantized_linear(jnp.asarray(w), jnp.asarray(x)))
        got = tquant.fake_quantized_linear(_t(w), _t(x)).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        for a, b in zip(tquant.quantization_error(_t(w)), jquant.quantization_error(jnp.asarray(w))):
            assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))

    def test_model_weight_is_transposed_once(self):
        """A model matrix (in, out) quantizes per output channel, as the
        reference's (out, in) call on its transpose."""
        w = np.random.default_rng(3).normal(size=(40, 24)).astype(np.float32)
        got = tquant.quantize_model_weight(_t(w))
        want = jquant.quantize_weight(jnp.asarray(w.T))
        _eq(got.q, want.q)
        _eq(got.scale, want.scale)

    def test_synthetic_generators_match(self):
        a, b = np.random.default_rng(9), np.random.default_rng(9)
        _eq(tsyn.synthetic_llm_weight(a, (16, 64)), jsyn.synthetic_llm_weight(b, (16, 64)))
        for u, v in zip(tsyn.synthetic_llm_weight_int8(a, (8, 32)),
                        jsyn.synthetic_llm_weight_int8(b, (8, 32))):
            _eq(u, v)
        _eq(tsyn.synthetic_activation(a, (5, 9)), jsyn.synthetic_activation(b, (5, 9)))


class TestOperands:
    @pytest.mark.parametrize("M,H,m", [(16, 128, 4), (24, 40, 2), (9, 33, 3), (64, 256, 4)])
    def test_prepare_bit_exact(self, M, H, m):
        rng = np.random.default_rng(M * H + m)
        w = _gauss_int8(rng, M, H)
        w[0] = -128 if m == 4 else w[0]  # the most negative int8 too
        j, t = jax_prepare(w, m=m), prepare_brcr_operands(_t(w), m=m)
        _eq(t.group_idx, j.group_idx)
        assert t.group_idx.dtype == torch.uint8
        _eq(t.plane_weights, j.plane_weights)
        assert (t.m, t.nbits, t.M, t.H) == (j.m, j.nbits, j.M, j.H)

    def test_tile_map_bit_exact(self):
        rng = np.random.default_rng(4)
        w = _gauss_int8(rng, 64, 512, scale=3)
        w[:32, :256] = 0  # whole tiles of zero patterns
        j, t = jax_prepare(w), prepare_brcr_operands(_t(w))
        for tm, tk in ((32, 128), (64, 256), (16, 512)):
            got = tile_nonzero_map(t.group_idx, 4, tm, tk)
            _eq(got, jax_tile_map(j.group_idx, 4, tm, tk))
        assert not bool(tile_nonzero_map(t.group_idx, 4, 32, 256).all())

    def test_rejects_bad_group(self):
        with pytest.raises(ValueError, match="divisible"):
            prepare_brcr_operands(torch.zeros(6, 8, dtype=torch.int8), m=4)


class TestBrcrGemmPlain:
    """The plain version against the JAX Pallas kernel in interpret mode."""

    @pytest.mark.parametrize("M,H,N,tiles", [(16, 128, 8, (16, 128, 8)),
                                             (64, 512, 5, (32, 128, 8)),
                                             (32, 256, 19, (32, 256, 8))])
    def test_int_x_bit_exact(self, M, H, N, tiles):
        rng = np.random.default_rng(M + H + N)
        w, _ = jsyn.synthetic_llm_weight_int8(rng, (M, H))
        w[:16, :128] = 0  # an all-zero (p, M, H) tile in every plane
        x = rng.integers(-50, 50, size=(H, N)).astype(np.float32)
        j = jax_prepare(w)
        want = jax_brcr_gemm(j, jnp.asarray(x), tile_m=tiles[0], tile_k=tiles[1],
                             tile_n=tiles[2], interpret=True)
        reset_launches()
        got = brcr_gemm(prepare_brcr_operands(_t(w)), _t(x))
        _eq(got, want)
        _eq(got, np.asarray(w, np.int64) @ x.astype(np.int64))
        assert LAUNCHES["brcr_gemm"] == 0  # CPU: the plain version

    @pytest.mark.parametrize("N", [8, 3])
    def test_float_x_within_row_sums(self, N):
        rng = np.random.default_rng(7 + N)
        w, _ = jsyn.synthetic_llm_weight_int8(rng, (32, 256))
        x = rng.normal(size=(256, N)).astype(np.float32)
        want = jax_brcr_gemm(jax_prepare(w), jnp.asarray(x), tile_m=16, tile_k=128,
                             tile_n=8, interpret=True)
        got = brcr_gemm(prepare_brcr_operands(_t(w)), _t(x))
        _within_row_sums(got, want, w, x)
        _within_row_sums(got, dense_ref(_t(w), _t(x)), w, x)

    def test_all_zero_weight(self):
        w = np.zeros((16, 128), np.int8)
        x = np.ones((128, 8), np.float32)
        want = jax_brcr_gemm(jax_prepare(w), jnp.asarray(x), tile_m=16, tile_k=128,
                             tile_n=8, interpret=True)
        got = brcr_gemm(prepare_brcr_operands(_t(w)), _t(x))
        _eq(got, want)
        _eq(got, np.zeros((16, 8), np.float32))

    def test_matches_jax_oracle_in_chunks(self, monkeypatch):
        """Chunking the groups (forced down to 3 a chunk) changes nothing:
        each plane's MAV, E @ Z and ±2^p accumulation are the oracle's."""
        from repro_torch.kernels.brcr_gemm import ref as tref

        rng = np.random.default_rng(12)
        w = _gauss_int8(rng, 40, 64)
        x = rng.integers(-20, 20, size=(64, 6)).astype(np.float32)
        j = jax_prepare(w)
        want = jax_brcr_ref(j.group_idx, j.plane_weights, jnp.asarray(x), 4)
        monkeypatch.setattr(tref, "ONEHOT_BYTES", 3 * 4 * 64 * 16)
        t = prepare_brcr_operands(_t(w))
        assert tref.group_chunk(64, 4) == 3
        _eq(brcr_gemm_ref(t.group_idx, t.plane_weights, _t(x), 4), want)

    def test_off_cpu_raises(self):
        """Off the CPU the wrapper launches the kernel or raises; meta
        tensors stand in for a device without one."""
        meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
        ops = BRCROperands(meta(14, 2, 16, dtype=torch.uint8), meta(14), 4, 7, 8, 16)
        reset_launches()
        with pytest.raises(ValueError, match="no kernel for device"):
            brcr_gemm(ops, meta(16, 4))
        with pytest.raises(ValueError, match="must be"):
            brcr_gemm(ops, meta(15, 4))
        assert LAUNCHES["brcr_gemm"] == 0


class TestBrcrCore:
    @pytest.mark.parametrize("m", [2, 4])
    def test_brcr_matmul_int_and_float(self, m):
        rng = np.random.default_rng(30 + m)
        w = _gauss_int8(rng, 16, 96)
        xi = rng.integers(-100, 100, size=(96, 5)).astype(np.int32)
        got = tbrcr.brcr_matmul(_t(w), _t(xi), m=m)
        assert got.dtype == torch.int32
        _eq(got, jbrcr.brcr_matmul(jnp.asarray(w), jnp.asarray(xi), m=m))
        _eq(got, w.astype(np.int64) @ xi.astype(np.int64))
        xf = rng.normal(size=(96, 5)).astype(np.float32)
        got = tbrcr.brcr_matmul(_t(w), _t(xf), m=m)
        _within_row_sums(got, jbrcr.brcr_matmul(jnp.asarray(w), jnp.asarray(xf), m=m), w, xf)

    def test_mav_and_reconstruct(self):
        rng = np.random.default_rng(1)
        idx = rng.integers(0, 16, size=(6, 40)).astype(np.int32)
        x = rng.integers(-9, 9, size=(40, 3)).astype(np.int32)
        for xx in (x, x.astype(np.float32)):
            _eq(tbrcr.merged_activation_vector(_t(idx), _t(xx), 4),
                jbrcr.merged_activation_vector(jnp.asarray(idx), jnp.asarray(xx), 4))
        z = rng.integers(-50, 50, size=(2, 16, 3)).astype(np.float32)
        _eq(tbrcr.reconstruct(_t(z), 4), jbrcr.reconstruct(jnp.asarray(z), 4))

    @pytest.mark.parametrize("M,H,m,n_cols", [(64, 256, 4, 1), (36, 80, 3, 7), (16, 64, 2, 2)])
    def test_cost_fields_equal(self, M, H, m, n_cols):
        rng = np.random.default_rng(M + H)
        w, _ = jsyn.synthetic_llm_weight_int8(rng, (M, H))
        w[1] = 0
        got = tbrcr.brcr_cost(_t(w), n_cols=n_cols, m=m)
        want = jbrcr.brcr_cost(jnp.asarray(w), n_cols=n_cols, m=m)
        assert tuple(got.__dict__.values()) == tuple(want.__dict__.values())

    def test_closed_forms(self):
        for args in ((3072, 4, 7, 0.7), (1024, 2, 7, 0.55)):
            assert tbrcr.brcr_cost_closed_form(*args) == jbrcr.brcr_cost_closed_form(*args)
        for bs in (0.5, 0.7, 0.9):
            assert tbrcr.optimal_group_size(3072, 7, bs) == jbrcr.optimal_group_size(3072, 7, bs)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*a, **kw)
    return out.getvalue(), res


def test_quickstart_prints_the_reference_numbers():
    """At the reference example's size (64 x 1024) the port's quickstart
    prints exactly its lines: sparsities, BRCR exact + adds, BSTC CR and
    coded planes, BGPP kept / recall / traffic."""
    want, _ = _printed(_jax_example("quickstart").main)
    reset_launches()
    got, res = _printed(tquickstart.main, shape=(64, 1024), device="cpu")
    assert got == want
    assert res["brcr_exact"] and res["bstc_lossless"]
    assert all(n == 0 for n in LAUNCHES.values())


def test_quickstart_full_width_defaults():
    """With no shape the example takes phi4-mini-3.8b's (d_ff, d_model)
    from the config; with no device it asks for the card."""
    assert tquickstart.full_width_shape() == (8192, 3072)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tquickstart.main(shape=(8, 16))
