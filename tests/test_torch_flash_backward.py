"""K5's gradient on the CPU: the plain backward ``flash_attention_bwd_ref``
(what ``flash_attention``'s autograd takes on CPU tensors and what
``chip_smoke.py`` holds the ``flash_attention_bwd.cu`` kernel against on
the card) against autograd of the plain forward and against ``jax.vjp`` of
the reference's ``blocked_attend``; the forward's log-sum-exp; the
no-grad forward unchanged; the arithmetic of the kernel's bf16 body (a
float32 model: bf16 operands, P and dS split into bf16 hi + lo, f32 sums
in the kernel's order) against the plain version; the backward's launch
plan and source layout.

Tolerances: every gradient within 1e-5 of its own max |grad| in f32 (the
same function, summed in another order: measured ~1e-6); ``lse`` within
1e-5 absolute of the masked ``logsumexp``; the bf16 body's gradients,
rounded to bf16, within ``chip_smoke.bwd_tolerance`` (the bound the card
holds the kernel to: 1e-5 of max |grad| plus one bf16 step).
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import attention as jattention

from repro_torch.core import attention
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                      flash_attention_ref)

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

_CHIP_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _CHIP_SMOKE)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

GRAD_TOL = 1e-5
# (mask_kind, window, q_offset, Sq, Sk): every kind, Sq != Sk, q_offsets
MASKS = [
    ("causal", 0, 0, 37, 37),
    ("causal", 0, 11, 26, 37),
    ("sliding", 8, 0, 40, 40),
    ("sliding", 8, 5, 30, 35),
    ("chunked", 16, 0, 40, 40),
    ("chunked", 16, 5, 30, 35),
    ("full", 0, 0, 20, 50),
    ("prefix_causal", 10, 0, 33, 33),
]
HEADS = [(4, 4), (6, 2), (8, 2)]  # g 1, 3, 4


def _inputs(seed, Sq, Sk, Hq, Hk, D, B=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(B, Sq, Hq, D), f(B, Sk, Hk, D), f(B, Sk, Hk, D), f(B, Sq, Hq, D)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= GRAD_TOL, f"{what}: {err:.3e} of max |grad| > {GRAD_TOL}"


def _plain_grads(q, k, v, do, kind, w, off):
    """flash_attention_bwd_ref on the plain forward's out and lse."""
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attention_ref(tq, tk, tv, mask_kind=kind, window=w, q_offset=off,
                                   return_lse=True)
    return flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, mask_kind=kind, window=w,
                                   q_offset=off)


# every mask with every group; D 16 and 24 alternate so each mask meets both
CASES = [(m, h, (16, 24)[(i + j) % 2]) for i, m in enumerate(MASKS) for j, h in enumerate(HEADS)]


@pytest.mark.parametrize(
    "mask,heads,D", CASES,
    ids=[f"{m[0]}-w{m[1]}-off{m[2]}-{m[3]}x{m[4]}-g{h[0] // h[1]}-D{D}" for m, h, D in CASES])
def test_plain_backward_matches_autograd_and_jax_vjp(mask, heads, D):
    kind, w, off, Sq, Sk = mask
    q, k, v, do = _inputs(7, Sq, Sk, *heads, D)
    got = _plain_grads(q, k, v, do, kind, w, off)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention_ref(*leaves, mask_kind=kind, window=w, q_offset=off)
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(do))

    # two key blocks, so the scan carries its online softmax across a block edge
    fn = lambda a, b, c: jattention.blocked_attend(a, b, c, mask_kind=kind, window=w,
                                                   q_offset=off, block_q=64, block_k=32)
    vjp = jax.jit(lambda a, b, c, g: jax.vjp(fn, a, b, c)[1](g))
    jgrads = vjp(*(jnp.asarray(x) for x in (q, k, v, do)))
    for name, g, a, j in zip(("dq", "dk", "dv"), got, auto, jgrads):
        _close(g.numpy(), a.numpy(), f"{name} against autograd")
        _close(g.numpy(), np.asarray(j), f"{name} against jax.vjp(blocked_attend)")


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"{m[0]}-w{m[1]}-off{m[2]}")
def test_lse_is_the_masked_logsumexp(mask):
    kind, w, off, Sq, Sk = mask
    q, k, _, _ = _inputs(3, Sq, Sk, 6, 2, 16)
    out, lse = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, k)), mask_kind=kind,
                                   window=w, q_offset=off, return_lse=True)
    assert lse.shape == (2, 6, Sq) and lse.dtype == torch.float32
    m = np.asarray(jattention.make_mask(kind, Sq, Sk, w, off)) if kind != "prefix_causal" \
        else attention.prefix_causal_mask(Sq, Sk, w, off).numpy()
    qg = q.reshape(2, Sq, 2, 3, 16)
    s = np.einsum("bqhgd,bkhd->bhgqk", qg.astype(np.float64), k.astype(np.float64)) / 4.0
    s = np.where(m, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    assert np.abs(lse.numpy() - want.reshape(2, 6, Sq)).max() <= 1e-5
    assert torch.equal(out, flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, k)),
                                                mask_kind=kind, window=w, q_offset=off))


def test_no_grad_forward_is_unchanged_and_the_grad_path_gives_the_same_out():
    q, k, v, do = _inputs(5, 37, 37, 6, 2, 16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = flash_attention(tq, tk, tv, mask_kind="sliding", window=8)
    mask = attention.make_mask("sliding", 37, 37, 8)
    assert plain.grad_fn is None
    assert torch.equal(plain, attention.attend(tq, tk, tv, mask=mask))
    assert torch.equal(plain, attention.blocked_attend(tq, tk, tv, mask_kind="sliding", window=8))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = flash_attention(*leaves, mask_kind="sliding", window=8)
    assert out.grad_fn is not None and torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert flash_attention(*leaves, mask_kind="sliding", window=8).grad_fn is None


@pytest.mark.parametrize("which", [(True, True, True), (True, False, False),
                                   (False, True, True)], ids=["qkv", "q", "kv"])
def test_autograd_routes_through_the_plain_backward(which):
    q, k, v, do = _inputs(9, 30, 35, 8, 2, 24)
    leaves = [torch.from_numpy(a).requires_grad_(r) for a, r in zip((q, k, v), which)]
    out = flash_attention(*leaves, mask_kind="chunked", window=16, q_offset=5)
    out.backward(torch.from_numpy(do))
    want = _plain_grads(q, k, v, do, "chunked", 16, 5)
    for t, w, r in zip(leaves, want, which):
        assert (t.grad is not None) == r
        if r:
            assert torch.equal(t.grad, w)


def test_window_zero_is_causal_in_the_backward():
    q, k, v, do = _inputs(2, 20, 20, 4, 2, 16)
    a = _plain_grads(q, k, v, do, "causal", 0, 0)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves, mask_kind="sliding", window=0).backward(torch.from_numpy(do))
    for t, w in zip(leaves, a):
        assert torch.equal(t.grad, w)


def test_bf16_gradients_come_back_in_bf16():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(4, 17, 17, 4, 1, 16))
    out, lse = flash_attention_ref(q, k, v, return_lse=True)
    grads = flash_attention_bwd(q, k, v, out, lse, do)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def test_backward_refuses_mismatched_operands():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 4, 2, 16))
    out, lse = flash_attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse[:, :, :4], do)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, out, lse, do[:, :4])
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_bwd(q, k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1].expand(-1, -1, 3, -1),
                            out, lse, do)


LOG2E = 1.4426950408889634


def _split(x, keep_lo=True):
    """The kernel's bf16 pair: ``hi = bf16(x)``, ``lo = bf16(x - hi)``
    (``keep_lo`` False: x rounded once, as a single bf16 operand)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float() if keep_lo else torch.zeros_like(x)


def _k5b_model(q, k, v, o, lse, dout, kind, w, off, keep_lo=True):
    """``flash_attention_bwd.cu``'s bf16 body in float32: S and dP from the
    bf16 operands (exact products, f32 sums), ``P = 2^(s scale log2 e -
    lse log2 e)`` (0 off the mask), ``dS = P (dP - delta)``; P and dS split
    into bf16 hi + lo and both halves multiplied.  The sums run in the
    kernel's order: dk and dv over the group's query heads in turn, each
    over its queries in 16-row chunks (one mma k-step; a chunk the kernel
    skips adds zeros), hi then lo into a zeroed fragment that one f32 add
    takes to the sum; dq over the keys in 16-key chunks, hi then lo.  The
    scale applied to dk and dq at the end.  -> f32 ``(dq, dk, dv)``."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    g, scale = Hq // Hk, D ** -0.5
    qg = q.float().reshape(B, Sq, Hk, g, D)
    dog = dout.float().reshape(B, Sq, Hk, g, D)
    kf, vf = k.float(), v.float()
    mask = attention.make_mask(kind, Sq, Sk, w, off)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
    lq = lse.float().reshape(B, Hk, g, Sq, 1) * LOG2E
    p = torch.where(mask, torch.exp2(s * (scale * LOG2E) - lq), 0.0)
    delta = (dout.float() * o.float()).sum(-1).reshape(B, Sq, Hk, g).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dog, vf) - delta[..., None])
    p2, ds2 = _split(p, keep_lo), _split(ds, keep_lo)
    dk, dv = torch.zeros(B, Sk, Hk, D), torch.zeros(B, Sk, Hk, D)
    for gi in range(g):
        for c in range(0, Sq, 16):
            sl = slice(c, c + 16)
            tv = tk = 0.0  # the chunk's products in a zeroed fragment, then one f32 add
            for x in p2:
                tv = tv + torch.einsum("bhqk,bqhd->bkhd", x[:, :, gi, sl], dog[:, sl, :, gi])
            for x in ds2:
                tk = tk + torch.einsum("bhqk,bqhd->bkhd", x[:, :, gi, sl], qg[:, sl, :, gi])
            dv, dk = dv + tv, dk + tk
    dq = torch.zeros(B, Sq, Hk, g, D)
    for c in range(0, Sk, 16):
        for x in ds2:
            dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", x[..., c:c + 16], kf[:, c:c + 16])
    return dq.reshape(B, Sq, Hq, D) * scale, dk * scale, dv


def _bf16_case(seed, kind, w, off, Sq, Sk, Hq, Hk, D, B=1):
    """Seeded bf16 q, k, v, dout, the plain forward's bf16 out and f32 lse
    (what K5 hands K5b), and ``flash_attention_bwd_ref``'s f32 gradient on
    them (``chip_smoke.bwd_plain_blocked``'s function)."""
    rng = np.random.default_rng(seed)
    mk = lambda S, H: torch.from_numpy(
        rng.standard_normal((B, S, H, D)).astype(np.float32)).bfloat16()
    q, k, v, do = mk(Sq, Hq), mk(Sk, Hk), mk(Sk, Hk), mk(Sq, Hq)
    kw = dict(mask_kind=kind, window=w, q_offset=off)
    out, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                   do.float(), **kw)
    return (q, k, v, out, lse, do), want


def _worst_share(got, want):
    """The largest ``|bf16(got) - bf16(want)| / bwd_tolerance(bf16(want))``
    over dq, dk and dv: at most 1 passes the card's check."""
    worst = 0.0
    for g, w in zip(got, want):
        wb = w.bfloat16()
        tol = chip_smoke.bwd_tolerance(wb, True)
        worst = max(worst, ((g.bfloat16().float() - wb.float()).abs() / tol).max().item())
    return worst


# (mask_kind, window, q_offset, Sq, Sk, Hq, Hk, D): every mask kind of
# chip_smoke.BWD_CASES at small shapes, D 64 / 128 / 256, g 1 and 3, ragged S
MODEL_CASES = [
    ("causal", 0, 0, 77, 77, 6, 2, 128),
    ("sliding", 24, 0, 70, 70, 2, 2, 64),
    ("chunked", 32, 0, 80, 80, 3, 1, 128),
    ("prefix_causal", 20, 0, 60, 60, 6, 2, 64),
    ("causal", 0, 40, 40, 80, 3, 1, 256),
    ("full", 0, 0, 24, 150, 2, 2, 64),
    ("causal", 0, 0, 64, 64, 2, 2, 256),
]


class TestBackwardArithmetic:
    """The bf16 body's arithmetic (:func:`_k5b_model`) against the plain
    version, within the bound the card holds the kernel to."""

    @pytest.mark.parametrize("case", MODEL_CASES,
                             ids=[f"{c[0]}-w{c[1]}-off{c[2]}-{c[3]}x{c[4]}-g{c[5] // c[6]}-D{c[7]}"
                                  for c in MODEL_CASES])
    def test_split_body_stays_inside_the_tolerance(self, case):
        """P and dS as bf16 pairs keep ~2^-17 of each: dq, dk and dv within
        1e-5 of their max |grad| before rounding, and within
        ``bwd_tolerance`` once rounded to bf16."""
        ops, want = _bf16_case(7, *case)
        got = _k5b_model(*ops, *case[:3])
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            _close(g.numpy(), w.numpy(), f"{name} of the split body")
        assert _worst_share(got, want) <= 1.0

    def test_one_bf16_rounding_of_p_and_ds_would_not_stay_inside(self):
        """The same body with P and dS rounded once to bf16 (2^-9 of each)
        moves the gradients by ~2e-3 of their max |grad|: many times the
        bound.  So the split is needed."""
        case = MODEL_CASES[0]
        ops, want = _bf16_case(7, *case)
        assert _worst_share(_k5b_model(*ops, *case[:3], keep_lo=False), want) > 10.0
        assert _worst_share(_k5b_model(*ops, *case[:3]), want) <= 1.0

    def test_split_body_matches_jax_vjp(self):
        """The split body on bf16-valued q, k, v and dout, with the f32
        forward's out and lse, against ``jax.vjp`` of the reference's
        ``blocked_attend``: within 1e-5 of each max |grad| in f32."""
        kind, w, off, Sq, Sk, Hq, Hk, D = "sliding", 24, 5, 60, 65, 6, 2, 128
        rng = np.random.default_rng(3)
        mk = lambda S, H: rng.standard_normal((1, S, H, D)).astype(np.float32)
        q, k, v, do = (torch.from_numpy(x).bfloat16().float()
                       for x in (mk(Sq, Hq), mk(Sk, Hk), mk(Sk, Hk), mk(Sq, Hq)))
        out, lse = flash_attention_ref(q, k, v, mask_kind=kind, window=w, q_offset=off,
                                       return_lse=True)
        got = _k5b_model(q, k, v, out, lse, do, kind, w, off)
        fn = lambda a, b, c: jattention.blocked_attend(a, b, c, mask_kind=kind, window=w,
                                                       q_offset=off, block_q=64, block_k=32)
        vjp = jax.jit(lambda a, b, c, gr: jax.vjp(fn, a, b, c)[1](gr))
        jgrads = vjp(*(jnp.asarray(t.numpy()) for t in (q, k, v, do)))
        for name, g, j in zip(("dq", "dk", "dv"), got, jgrads):
            _close(g.numpy(), np.asarray(j), f"{name} of the split body against jax.vjp")


# an SM's shared memory (228 KB); each resident block also takes 1 KB the
# hardware reserves
SM_SMEM, BLOCK_RESERVED = 233_472, 1024
PLAN_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


class TestBackwardPlan:
    @pytest.mark.parametrize("dt", PLAN_DTYPES)
    @pytest.mark.parametrize("D", [16, 24, 32, 64, 128, 200, 256])
    def test_blocks_fit_an_sm(self, D, dt):
        """Every block fits one block's limit; the bf16 blocks are small
        enough that two share an SM at every width (at D 128 the dk/dv block
        under ~113 KB)."""
        dtype = PLAN_DTYPES[dt]
        kv, q = flash_kernel.bwd_smem_bytes(dtype, D)
        assert max(kv, q) <= build.MAX_SMEM
        assert flash_kernel.bwd_tile(D) == (32 if D > 128 else 64)
        if dtype == torch.bfloat16:
            assert 2 * (max(kv, q) + BLOCK_RESERVED) <= SM_SMEM

    def test_source_carve_up(self):
        # bf16: mma_kv_smem_bytes / mma_q_smem_bytes, 12 T D (+ 16 T) at T 64 / 32;
        # f32: kv_smem_bytes / q_smem_bytes, at D 128 and 256
        assert flash_kernel.bwd_smem_bytes(torch.bfloat16, 128) == (99_328, 98_304)
        assert flash_kernel.bwd_smem_bytes(torch.bfloat16, 256) == (98_816, 98_304)
        assert flash_kernel.bwd_smem_bytes(torch.bfloat16, 16) == (13_312, 12_288)
        assert flash_kernel.bwd_smem_bytes(torch.float32, 128) == (165_888, 149_248)
        assert flash_kernel.bwd_smem_bytes(torch.float32, 256) == (140_288, 136_064)
        src = (build.CSRC / "flash_attention_bwd.cu").read_text()
        assert "return 12 * mma_tile<D>() * D + 16 * mma_tile<D>();" in src
        assert "return 12 * mma_tile<D>() * D;" in src
        assert "return D > 128 ? 2 : 1;" in src  # two warps a 16-row group at D 256

    def test_grids_cover_every_key_and_query_tile(self):
        bf, f32 = torch.bfloat16, torch.float32
        # bf16: (B * Hk, key tiles) and (B * Hq, query tiles), 128 threads
        p = flash_kernel.bwd_plan(bf, 1, 4096, 4096, 24, 8, 128)
        assert p.grid_kv == (8, 64) and p.grid_q == (24, 64) and p.threads == 128
        p = flash_kernel.bwd_plan(bf, 2, 128, 1500, 16, 16, 64)
        assert p.grid_kv == (32, 24) and p.grid_q == (32, 2)
        p = flash_kernel.bwd_plan(bf, 1, 1024, 1024, 8, 4, 256)
        assert p.tile == 32 and p.grid_kv == (4, 32) and p.grid_q == (8, 32)
        # f32: (key tiles, B * Hk) and (query tiles, B * Hq), 256 threads
        p = flash_kernel.bwd_plan(f32, 1, 301, 301, 24, 8, 128)
        assert p.tile == 64 and p.grid_kv == (5, 8) and p.grid_q == (5, 24)
        assert p.threads == 256
        p = flash_kernel.bwd_plan(f32, 1, 301, 301, 8, 4, 256)
        assert p.tile == 32 and p.grid_kv == (10, 4) and p.grid_q == (10, 8)

    def test_the_library_declares_the_backward(self):
        src = (build.CSRC / "flash_attention_bwd.cu").read_text()
        assert "int flash_attention_bwd_launch(" in src
        assert "flash_attention.cuh" in src
        fwd = (build.CSRC / "flash_attention.cu").read_text()
        assert "void* lse" in fwd
        # one copy of the bf16 bodies' device helpers, in the shared header
        hdr = (build.CSRC / "flash_attention.cuh").read_text()
        for helper in ("uint32_t smem_addr(", "void cp_async16(", "void cp_commit(",
                       "void cp_wait(", "void ldsm_x4(", "void ldsm_x4_trans(",
                       "void mma_bf16(", "void split_bf16x2(", "int swz_mask(",
                       "uint32_t swz(", "float ex2("):
            assert f"__forceinline__ {helper}" in hdr, helper
            assert f"__forceinline__ {helper}" not in src + fwd, helper
        # the bf16 backward: mma.sync products on split P and dS, no atomics
        assert "dkdv_mma_kernel" in src and "dq_mma_kernel" in src
        assert src.count("split_a(") >= 4
        assert not re.search(r"\batomic[A-Z]\w*\(|\b(atom|red)\.", src)
