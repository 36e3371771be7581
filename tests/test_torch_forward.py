"""The port's whole-sequence forward against the JAX package's, on CPU.

``flash_attention``'s plain version (what the wrapper runs on CPU tensors
and what ``chip_smoke.py`` holds the CUDA kernel against) against the JAX
Pallas kernel in interpret mode; the port's ``blocked_attend`` against
the JAX one; ``transformer.forward`` and the engine's ``prefill`` /
``prefill_into_slot`` against the reference's from the same parameters
(JAX-initialised, brought across with ``interop``).

Tolerances:
  * K5 plain version vs JAX interpret, f32: 2e-3 absolute, as the
    reference's own kernel tests hold its kernel to its oracle (measured
    ~1e-6).  bf16 operands: the interpret kernel rounds p to bf16 before
    the PV product (error <= 2^-9 of sum p|v|) and both sides round the
    output to bf16 (one step, <= 2^-7 of |out|), so each element is held to
    ``2^-7 |ref| + 2^-8 max|v|``.
  * ``blocked_attend``, the forward's K/V stacks and the prefill caches'
    floats (f32 smoke config): 1e-5, summation order; logits 1e-4.
  * int8 / bgpp cache codes: within one code step.  The K/V that feed the
    quantiser differ from JAX's by summation order, so a value within an
    ulp of a .5 boundary can round the other way (the bound of
    ``tests/test_torch_kernels.py``); bgpp planes must re-encode the
    port's own codes exactly.
  * bf16-width forward (narrow widths, ``dtype="bfloat16"``): bf16 rounds
    at every projection and residual add on both sides, in other
    summation orders, so a value may land one bf16 step (2^-8 relative to
    its power of two) away and the next layer carries it on.  Logits are
    held to ``8 * 2^-8 * max|logits|`` and K/V to ``4 * 2^-8 * max|kv|``
    (measured on three seeds: up to 3.6 and 2.2 steps); where the argmax of
    a position differs (bf16 logits tie often), the reference's pick is
    within ``2 * 2^-8 * max|logits|`` of the port's best (measured: one
    step of a logit in [0.5, 1)).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core import attention as jattention
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import model_zoo, transformer as jtransformer
from repro.serving import engine as jengine, kv_cache as jkvc

from repro_torch.configs import get_config
from repro_torch.core import attention
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as flash_kernel, ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import transformer
from repro_torch.serving import engine, kv_cache as tkvc

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "phi4-mini-3.8b"
FORMATS = ["bf16", "int8", "bgpp"]
LAYOUTS = ["slot", "paged"]
BF16_STEP = 2.0 ** -8


@pytest.fixture(scope="module")
def served():
    jcfg = jax_config(ARCH, smoke=True)
    jparams, _ = model_zoo.init(jax.random.key(2), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, get_config(ARCH, smoke=True), jparams, tparams


def _qkv(seed, B, Sq, Sk, Hq, Hk, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, Hq, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hk, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hk, D)).astype(np.float32))


def _both(arrays, dtype):
    """numpy f32 operands -> (JAX, torch) operands of one dtype (the same
    round-to-nearest-even bf16 values on both sides)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


class TestFlashAttentionPlain:
    @pytest.mark.parametrize("mask_kind,window", [
        ("causal", 0), ("sliding", 64), ("chunked", 64), ("full", 0)])
    def test_masks_match_jax_interpret(self, mask_kind, window):
        (jq, jk, jv), (q, k, v) = _both(_qkv(0, 1, 256, 256, 2, 2, 64), "float32")
        want = jax_flash(jq, jk, jv, mask_kind=mask_kind, window=window, tile_q=64,
                         tile_k=64, interpret=True)
        got = flash_attention(q, k, v, mask_kind=mask_kind, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)

    def test_gqa_grouping(self):
        (jq, jk, jv), (q, k, v) = _both(_qkv(1, 2, 128, 128, 4, 2, 32), "float32")
        want = jax_flash(jq, jk, jv, tile_q=64, tile_k=64, interpret=True)
        got = flash_attention(q, k, v)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)

    @pytest.mark.parametrize("mask_kind", ["causal", "sliding", "chunked"])
    def test_q_offset(self, mask_kind):
        """Queries at positions 128..255 against all 256 keys."""
        (jq, jk, jv), (q, k, v) = _both(_qkv(2, 1, 128, 256, 4, 2, 32), "float32")
        kw = dict(mask_kind=mask_kind, window=64, q_offset=128)
        want = jax_flash(jq, jk, jv, tile_q=64, tile_k=64, interpret=True, **kw)
        got = flash_attention(q, k, v, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dtypes(self, dtype):
        (jq, jk, jv), (q, k, v) = _both(_qkv(3, 1, 128, 128, 2, 2, 64), dtype)
        want = _np(jax_flash(jq, jk, jv, tile_q=64, tile_k=64, interpret=True))
        got = flash_attention(q, k, v)
        assert got.dtype == q.dtype
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
        else:
            tol = 2.0 ** -7 * np.abs(want) + BF16_STEP * float(v.float().abs().max())
            assert (np.abs(_np(got) - want) <= tol).all()

    def test_window_zero_is_causal(self):
        _, (q, k, v) = _both(_qkv(4, 1, 40, 40, 2, 1, 16), "float32")
        causal = flash_attention(q, k, v)
        for kind in ("sliding", "chunked"):
            torch.testing.assert_close(flash_attention(q, k, v, mask_kind=kind, window=0),
                                       causal, rtol=0, atol=0)

    def test_rejects_bad_operands(self):
        _, (q, k, v) = _both(_qkv(5, 1, 8, 8, 3, 2, 16), "float32")
        with pytest.raises(ValueError, match="multiple"):
            flash_attention(q, k, v)
        _, (q, k, v) = _both(_qkv(5, 1, 8, 8, 2, 2, 24), "float32")
        assert flash_ops._validate_cuda(q, k, v).smem == flash_kernel.smem_bytes(
            torch.float32, 32)  # the card runs D 24 at its compiled width 32
        _, (q, k, v) = _both(_qkv(5, 1, 8, 8, 2, 2, 512), "float32")
        with pytest.raises(ValueError, match="head_dim 512 is over the kernel's widest"):
            flash_ops._validate_cuda(q, k, v)  # the card's kernel; the CPU takes D 512
        _, (q, k, v) = _both(_qkv(5, 1, 8, 8, 2, 2, 16), "float32")
        with pytest.raises(ValueError, match="dtype"):
            flash_attention(q, k.double(), v)
        with pytest.raises(ValueError, match="mask_kind"):
            flash_attention(q, k, v, mask_kind="bidirectional", window=3)
        # the VLM's prefix_causal is a kind of the kernel now
        assert flash_ops._validate_cuda(q, k, v).smem == flash_kernel.smem_bytes(
            torch.float32, 16)
        flash_attention(q, k, v, mask_kind="prefix_causal", window=3)


class TestBlockedAttend:
    @pytest.mark.parametrize("mask_kind,window,q_offset", [
        ("causal", 0, 0), ("sliding", 8, 0), ("chunked", 8, 0), ("full", 0, 0),
        ("prefix_causal", 5, 0), ("causal", 0, 11), ("sliding", 0, 0)])
    def test_matches_jax_off_tile_length(self, mask_kind, window, q_offset):
        """S = 37 is no multiple of the JAX side's 16-wide blocks."""
        S = 37
        (jq, jk, jv), (q, k, v) = _both(_qkv(6, 2, S, S + q_offset, 4, 2, 16), "float32")
        kw = dict(mask_kind=mask_kind, window=window, q_offset=q_offset)
        want = jattention.blocked_attend(jq, jk, jv, block_q=16, block_k=16, **kw)
        got = attention.blocked_attend(q, k, v, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("D", [24, 256])
    @pytest.mark.parametrize("mask_kind,window", [("causal", 0), ("sliding", 8)])
    def test_head_dims_without_a_kernel_width_match_jax(self, D, mask_kind, window):
        """On CPU tensors any head width takes the plain version: D 24
        (gemma3-1b smoke) and 256 (gemma3 / paligemma at full size), which
        the card's kernel has no instance for."""
        (jq, jk, jv), (q, k, v) = _both(_qkv(8, 1, 40, 40, 4, 2, D), "float32")
        kw = dict(mask_kind=mask_kind, window=window)
        want = jattention.blocked_attend(jq, jk, jv, block_q=16, block_k=16, **kw)
        got = attention.blocked_attend(q, k, v, **kw)
        assert got.shape == (1, 40, 4, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    def test_plain_version_is_mask_and_attend(self):
        _, (q, k, v) = _both(_qkv(7, 1, 21, 21, 4, 2, 16), "float32")
        mask = attention.make_mask("sliding", 21, 21, 6)
        torch.testing.assert_close(flash_attention_ref(q, k, v, mask_kind="sliding", window=6),
                                   attention.attend(q, k, v, mask=mask), rtol=0, atol=0)


class TestForward:
    def test_logits_and_kv_match_jax(self, served):
        jcfg, cfg, jparams, tparams = served
        toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
        jlog, jaux, (jk, jv) = jtransformer.forward(jparams, jcfg, jnp.asarray(toks),
                                                    return_kv=True)
        log, aux, (k, v) = transformer.forward(tparams, cfg, torch.from_numpy(toks).long(),
                                               return_kv=True)
        L, Hk, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        assert tuple(k.shape) == tuple(v.shape) == (L, 2, 37, Hk, Dh)
        assert log.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
        log2, _ = transformer.forward(tparams, cfg, torch.from_numpy(toks).long())
        torch.testing.assert_close(log2, log, rtol=0, atol=0)

    def test_bf16_width_matches_jax(self):
        jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype="bfloat16",
                                   d_model=128, d_ff=256, head_dim=32)
        cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16",
                                  d_model=128, d_ff=256, head_dim=32)
        jparams, _ = model_zoo.init(jax.random.key(3), jcfg)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        assert tparams["embed"].dtype == torch.bfloat16
        toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 45)).astype(np.int32)
        jlog, _, (jk, jv) = jtransformer.forward(jparams, jcfg, jnp.asarray(toks),
                                                 return_kv=True)
        log, _, (k, v) = transformer.forward(tparams, cfg, torch.from_numpy(toks).long(),
                                             return_kv=True)
        assert log.dtype == k.dtype == torch.bfloat16
        want = _np(jlog)
        np.testing.assert_array_less(np.abs(_np(log) - want),
                                     8 * BF16_STEP * np.abs(want).max())
        for got, ref in ((k, jk), (v, jv)):
            ref = _np(ref)
            np.testing.assert_array_less(np.abs(_np(got) - ref),
                                         4 * BF16_STEP * np.abs(ref).max())
        # bf16 logits tie often: where the argmaxes differ, the reference's
        # pick is within two bf16 steps of max|logits| of the port's best
        got = _np(log)
        at_ref = np.take_along_axis(got, want.argmax(-1)[..., None], -1)[..., 0]
        assert (got.max(-1) - at_ref <= 2 * BF16_STEP * np.abs(want).max()).all()


def _assert_cache_close(tc, jc, fmt):
    """Every leaf of a port cache against the JAX one (see the module
    docstring for the bounds)."""
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    if "page_table" in jc:
        np.testing.assert_array_equal(tc["page_table"].numpy(), np.asarray(jc["page_table"]))
    tg = {n: a for n, a in tc["global"].items()}
    jg = {n: tensor_from_numpy(np.asarray(a), "cpu") for n, a in jc["global"].items()}
    assert set(tg) == set(jg)
    for n in tg:
        assert tg[n].shape == jg[n].shape and tg[n].dtype == jg[n].dtype, n
    if fmt == "bf16":
        for n in ("k", "v"):
            torch.testing.assert_close(tg[n], jg[n], rtol=0, atol=1e-5)
        return
    for n in ("k_scale", "v_scale"):
        torch.testing.assert_close(tg[n], jg[n], rtol=1e-5, atol=1e-12)
    codes = lambda g: (tkvc.bitplanes_to_k(g["k_planes"].movedim(1, 0), g["k_sign"])
                       if fmt == "bgpp" else g["k"].to(torch.int32))
    for got, want in ((codes(tg), codes(jg)), (tg["v"].to(torch.int32), jg["v"].to(torch.int32))):
        assert int((got - want).abs().max()) <= 1
    if fmt == "bgpp":  # the stored planes are the port's own codes, re-encoded
        planes, sign = tkvc.k_to_bitplanes(codes(tg).to(torch.int8))
        assert torch.equal(planes.movedim(0, 1), tg["k_planes"])
        assert torch.equal(sign, tg["k_sign"])


class TestPrefill:
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_prefill_matches_jax(self, served, fmt, layout):
        jcfg, cfg, jparams, tparams = served
        B, S, max_seq = 2, 21, 32
        jl = jkvc.layout_for(jcfg, B, max_seq, kv_format=fmt, layout=layout, page_size=8)
        tl = tkvc.layout_for(cfg, B, max_seq, kv_format=fmt, layout=layout, page_size=8)
        toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        jprefill = jax.jit(jengine.prefill, static_argnums=(1, 2))
        jlog, jc = jprefill(jparams, jcfg, jl, jnp.asarray(toks))
        log, tc = engine.prefill(tparams, cfg, tl, torch.from_numpy(toks).long())
        assert tuple(log.shape) == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
        _assert_cache_close(tc, jc, fmt)

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_prefill_into_slot_matches_jax(self, served, fmt, layout):
        """Two admissions into a live cache (shuffled page table): the
        second must leave the first slot's rows as they were."""
        jcfg, cfg, jparams, tparams = served
        B, max_seq = 2, 32
        jl = jkvc.layout_for(jcfg, B, max_seq, kv_format=fmt, layout=layout, page_size=8)
        tl = tkvc.layout_for(cfg, B, max_seq, kv_format=fmt, layout=layout, page_size=8)
        jc = jkvc.init_cache_arrays(jcfg, jl)
        tc = tkvc.init_cache_arrays(cfg, tl, device="cpu")
        if layout == "paged":
            table = np.asarray([[5, 1, 6, -1], [2, 7, -1, -1]], np.int32)
            jc["page_table"], tc["page_table"] = jnp.asarray(table), torch.from_numpy(table)
        rng = np.random.default_rng(11)
        jadmit = jax.jit(jengine.prefill_into_slot, static_argnums=(1, 2, 4))
        for slot, n in ((1, 19), (0, 13)):
            prompt = rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            jlog, jc = jadmit(jparams, jcfg, jl, jc, slot, jnp.asarray(prompt))
            log, tc = engine.prefill_into_slot(tparams, cfg, tl, tc, slot,
                                               torch.from_numpy(prompt).long())
            assert tuple(log.shape) == (1, 1, cfg.vocab_size)
            np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
            _assert_cache_close(tc, jc, fmt)

    def test_prompt_must_leave_a_decode_row(self, served):
        _, cfg, _, tparams = served
        tl = tkvc.layout_for(cfg, 2, 16, kv_format="bf16")
        tc = tkvc.init_cache_arrays(cfg, tl, device="cpu")
        with pytest.raises(ValueError, match="max_seq"):
            engine.prefill_into_slot(tparams, cfg, tl, tc, 0, torch.zeros(16, dtype=torch.long))
