"""The port's kernel plain versions against the JAX package's oracles.

``repro_torch.kernels.*.ref`` (what the wrappers run on CPU tensors, and
what ``chip_smoke.py`` holds the CUDA kernels against on the card) must
compute what ``repro.kernels.*.ref`` computes.  The same numpy-seeded
operands go to both; page tables and phys maps are shuffled (so the
logical -> physical translation is exercised), carry ``-1`` pages, and
positions sit at page boundaries.

Tolerances:
  * K2 survivor indices: bit-exact (plane scores are integers < 2**24, so
    the selection is exact once the quantised query matches).
  * f32 outputs: 1e-5 relative to the output's scale, from summation order
    (torch and XLA reduce in different orders).
  * int8 paths: each (b, h, g) row within that, plus one probability code
    step.  A code can flip by 1 where ``w / w_scale`` lands within an ulp
    of a .5 boundary; one flip moves the row by at most ``w_scale * 127 =
    max_j p_j * v_scale_j``, with ``p`` the reference's probabilities over
    the row's valid lanes (computed here in float64 from the operands).
    An extra or a missing lane moves a row by about ``p * |v|``, several
    times that bound at these sizes.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import bstc as jbstc
from repro.kernels.bgpp_paged_attend.ref import bgpp_paged_attend_ref as jax_bgpp_ref
from repro.kernels.bstc_decode import (bstc_decode_patterns as jax_decode,
                                       prepare_encoded_plane as jax_prepare_plane)
from repro.kernels.paged_flash_decode.ref import paged_flash_decode_ref as jax_pfd_ref
from repro.serving import kv_cache as jkvc

from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.bgpp_paged_attend import bgpp_paged_attend
from repro_torch.kernels.bgpp_paged_attend import kernel as bgpp_kernel
from repro_torch.kernels.bgpp_paged_attend import ops as bgpp_ops
from repro_torch.kernels.bgpp_paged_attend import ref as bgpp_ref
from repro_torch.kernels.bgpp_paged_attend.ref import bgpp_paged_attend_ref
from repro_torch.kernels.bstc_decode import bstc_decode_patterns, prepare_encoded_plane
from repro_torch.kernels.bstc_decode import kernel as decode_kernel
from repro_torch.kernels.bstc_decode import ops as decode_ops
from repro_torch.kernels.bstc_decode.ref import decode_patterns_ref
from repro_torch.kernels.bstc_matmul import bstc_matmul, prepare_bstc_matmul_operands
from repro_torch.kernels.bstc_matmul import kernel as bstc_kernel
from repro_torch.kernels.bstc_matmul import ops as bstc_ops
from repro_torch.kernels.bstc_matmul.ref import bstc_matmul_plain
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels import build
from repro_torch.kernels.brcr_gemm import kernel as brcr_kernel, prepare_brcr_operands
from repro_torch.kernels.brcr_gemm.ref import brcr_gemm_ref
from repro_torch.kernels.paged_flash_decode import paged_flash_decode
from repro_torch.kernels.paged_flash_decode import kernel as pfd_kernel
from repro_torch.kernels.paged_flash_decode import ops as pfd_ops
from repro_torch.core import attention as tattention
from repro_torch.core import bitslice
from repro_torch.core import bstc as tbstc
from repro_torch.serving import kv_cache as tkvc
from repro_torch.configs import ARCH_REGISTRY, get_config, shapes
from repro_torch.configs.base import TRANSFORMER_FAMILIES

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

D = 16
PAGE = 8


def _plan(S, rounds=4, keep=0.25):
    k_max = max(1, min(S, math.ceil(keep * S)))
    return rounds, k_max, (S,) + tuple(max(k_max, S >> r) for r in range(1, rounds))


def _table(rng, B, pp, n_pages, unmapped=2):
    """Shuffled page table with a few -1 (unmapped) entries."""
    ids = rng.permutation(n_pages)[:B * pp].reshape(B, pp).astype(np.int32)
    for b in range(B):
        ids[b, rng.integers(0, pp, unmapped)] = -1
    return ids


def _pos(rng, B, S):
    """Page-boundary positions plus a random one."""
    cand = [0, PAGE - 1, PAGE, S - 1, int(rng.integers(0, S))]
    return np.asarray([cand[b % len(cand)] for b in range(B)], np.int32)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _code_step(q, k, ks, vs, valid):
    """Per (b, h, g) row, ``max_j p_j * v_scale_j`` of the int8 attend
    (A2 logits, softmax over ``valid``): the most one flipped probability
    code moves the row.  q ``(B, Hk, g, D)``; k int8 ``(B, Hk, S, D)``;
    ks / vs ``(B, Hk, S)``; valid ``(B, Hk, S)`` bool."""
    q = q.astype(np.float64)
    q_scale = np.maximum(np.abs(q).max(-1, keepdims=True), 1e-8) / 127.0
    q_q = np.clip(np.round(q / q_scale), -127, 127)
    logits = (np.einsum("bhgd,bhsd->bhgs", q_q, k.astype(np.float64)) * q_scale
              * ks[:, :, None].astype(np.float64) * q.shape[-1] ** -0.5)
    logits = np.where(valid[:, :, None], logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return (p * vs[:, :, None]).max(-1)


def _assert_close_int8(got, want, step):
    """f32 agreement, allowing one prob-code ``step`` per (b, h, g) row."""
    err = np.abs(got - want).max(-1)
    tol = 1e-5 * max(1.0, float(np.abs(want).max())) + step
    assert np.all(err <= tol), float((err - tol).max())


def _k1_parity(fmt, g, D, page, seed):
    """K1's CPU path against the JAX plain version on a shuffled page table
    at head width ``D`` and ``page``: f32 within 1e-5, int8 within one
    probability-code step a row."""
    rng = np.random.default_rng(seed)
    B, Hk, pp, n_pages = 5, 2, 4, 24
    S = pp * page
    n_tok = n_pages * page
    q = rng.normal(size=(B, Hk, g, D)).astype(np.float32)
    kf = rng.normal(size=(n_tok, Hk, D)).astype(np.float32)
    vf = rng.normal(size=(n_tok, Hk, D)).astype(np.float32)
    table = _table(rng, B, pp, n_pages)
    cand = [0, page - 1, page, S - 1, int(rng.integers(0, S))]
    pos = np.asarray([cand[b % len(cand)] for b in range(B)], np.int32)
    kw_j, kw_t = {}, {}
    if fmt == "int8":
        kq, ks = (np.asarray(a) for a in jkvc.quantize_kv(_j(kf)))
        vq, vs = (np.asarray(a) for a in jkvc.quantize_kv(_j(vf)))
        kf, vf = kq, vq
        kw_j = dict(k_scale=_j(ks), v_scale=_j(vs))
        kw_t = dict(k_scale=_t(ks), v_scale=_t(vs))
    want = np.asarray(jax_pfd_ref(_j(q), _j(kf), _j(vf), _j(table), _j(pos),
                                  page_size=page, **kw_j))
    reset_launches()
    got = paged_flash_decode(_t(q), _t(kf), _t(vf), _t(table), _t(pos),
                             page_size=page, **kw_t).numpy()
    assert LAUNCHES["paged_flash_decode_bf16"] == 0  # CPU: plain version
    assert got.shape == (B, Hk, g, D) and got.dtype == np.float32
    if fmt == "int8":
        s = np.arange(S)
        pid = table[:, s // page]
        phys = np.where(pid >= 0, pid * page + s % page, 0)  # (B, S)
        hm = lambda a: np.moveaxis(a[phys], 2, 1)  # heads-major (B, Hk, S, ...)
        valid = np.broadcast_to((s[None] <= pos[:, None])[:, None], (B, Hk, S))
        _assert_close_int8(got, want, _code_step(q, hm(kq), hm(ks), hm(vs), valid))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class TestPagedFlashDecodeRef:
    @pytest.mark.parametrize("fmt", ["f32", "int8"])
    @pytest.mark.parametrize("g", [1, 3])
    def test_matches_jax_ref_on_shuffled_pages(self, fmt, g):
        _k1_parity(fmt, g, D, PAGE, 7 + g)

    @pytest.mark.parametrize("fmt", ["f32", "int8"])
    @pytest.mark.parametrize("Dh,page,g", [(24, 8, 3), (256, 8, 1), (256, 16, 8), (16, 6, 3),
                                           (24, 6, 2)])
    def test_matches_jax_ref_at_other_widths_and_pages(self, fmt, Dh, page, g):
        """The head widths the card now pads (D 24 runs at 32) or has an
        instance for (D 256), and a page size that is not a power of two."""
        _k1_parity(fmt, g, Dh, page, Dh + page + g)

    def test_unmapped_pages_never_contribute(self):
        """Garbage behind -1 pages is masked by position: poisoning it
        changes nothing."""
        rng = np.random.default_rng(3)
        B, Hk, g, pp = 2, 2, 3, 4
        q = _t(rng.normal(size=(B, Hk, g, D)).astype(np.float32))
        k = _t(rng.normal(size=(8 * PAGE, Hk, D)).astype(np.float32))
        v = _t(rng.normal(size=(8 * PAGE, Hk, D)).astype(np.float32))
        table = _t(np.asarray([[3, 5, -1, -1], [1, -1, -1, -1]], np.int32))
        pos = _t(np.asarray([2 * PAGE - 1, PAGE - 1], np.int32))
        base = paged_flash_decode(q, k, v, table, pos, page_size=PAGE)
        k2, v2 = k.clone(), v.clone()
        k2[:PAGE] = 1e4  # page 0: where -1 pages clamp
        v2[:PAGE] = -1e4
        again = paged_flash_decode(q, k2, v2, table, pos, page_size=PAGE)
        torch.testing.assert_close(base, again, rtol=0, atol=0)

    def test_rejects_bad_operands(self):
        q = torch.zeros(2, 2, 3, D)
        k = torch.zeros(4 * PAGE, 2, D)
        t = torch.zeros(2, 4, dtype=torch.int32)
        p = torch.zeros(2, dtype=torch.int32)
        with pytest.raises(ValueError, match="grouped"):
            paged_flash_decode(q[:, :, 0], k, k, t, p, page_size=PAGE)
        with pytest.raises(ValueError, match="whole"):
            paged_flash_decode(q, k[:-1], k[:-1], t, p, page_size=PAGE)
        with pytest.raises(ValueError, match="BOTH"):
            paged_flash_decode(q, k, k, t, p, page_size=PAGE,
                               k_scale=torch.zeros(4 * PAGE, 2))


class TestPagedFlashDecodePlan:
    """The CUDA launch geometry of K1 (``kernel.plan``: C blocks a (slot,
    kv-head) cluster, L lanes a block), checked from static shapes alone:
    no card is needed."""

    SMS = 132  # an H100 SXM

    @pytest.mark.parametrize("B,Hk,g,D,S,P", [
        (4, 8, 3, 128, 1024, 16),  # the decode geometry
        (4, 8, 5, 128, 1024, 16),  # llama4-scout's (g 5: the G 8 instance)
        (1, 8, 3, 128, 32768, 16),  # a long context
        (4, 8, 8, 128, 32768, 16),
        (64, 8, 3, 128, 2048, 16),  # more cells than SMs
        (2, 2, 3, 16, 64, 8),  # the smoke config
        (3, 2, 5, 64, 40, 8),  # pages that do not split evenly
        (1, 1, 1, 128, 16, 16),  # a single page
        (2, 2, 3, 16, 64, 1),  # the slot layout's identity table
    ])
    def test_every_lane_has_one_block(self, B, Hk, g, D, S, P):
        p = pfd_kernel.plan(B, Hk, g, D, S // P, P, self.SMS)
        C, L, smem = p.C, p.L, p.smem
        assert C in (1, 2, 4, 8) and L % P == 0 and (p.passes, p.pass_lanes) == (1, 0)
        owners = np.zeros(S, np.int64)
        for c in range(C):
            owners[c * L:min((c + 1) * L, S)] += 1
        np.testing.assert_array_equal(owners, 1)
        assert smem == pfd_kernel.smem_bytes(g, D, L, P) <= build.MAX_SMEM

    def test_decode_geometry_fills_the_card(self):
        B, Hk = 4, 8
        p = pfd_kernel.plan(B, Hk, 3, 128, 1024 // 16, 16, self.SMS)
        C, L = p.C, p.L
        assert (C, L, p.pass_lanes) == (4, 256, 0)
        assert 128 <= B * Hk * C <= self.SMS

    @staticmethod
    def _operands(fmt, g, S, P, D=128):
        """CPU operands the CUDA validation accepts: a one-page pool and a
        (1, S / P) table (validation never reads the page ids)."""
        q = torch.zeros(1, 2, g, D)
        dt = torch.int8 if fmt == "int8" else torch.bfloat16
        k = torch.zeros(P, 2, D, dtype=dt)
        table = torch.zeros(1, S // P, dtype=torch.int32)
        pos = torch.full((1,), S - 1, dtype=torch.int32)
        scales = {}
        if fmt == "int8":
            scales = dict(k_scale=torch.ones(P, 2), v_scale=torch.ones(P, 2))
        return q, k, table, pos, scales

    @pytest.mark.parametrize("fmt", ["bf16", "int8"])
    @pytest.mark.parametrize("g", range(1, 9))
    def test_wrapper_takes_32k_lanes_at_every_group(self, monkeypatch, fmt, g):
        monkeypatch.setattr(pfd_kernel, "sm_count", lambda device: self.SMS)
        S, P = 32768, 16
        assert pfd_kernel.max_lanes(g, 128, P) >= S
        q, k, table, pos, scales = self._operands(fmt, g, S, P)
        plan = pfd_ops._validate_cuda(q, k, k, table, pos, P, scales.get("k_scale"),
                                      scales.get("v_scale"))
        assert plan.smem <= build.MAX_SMEM and plan.C * plan.L >= S

    @pytest.mark.parametrize("g", [1, 3, 8])
    def test_past_the_cap_the_wrapper_raises_with_it(self, monkeypatch, g):
        """Past the single-pass bodies' shared memory the wrapper plans the
        pass bodies: 524,288 lanes (the reference's long_500k) in passes of
        whole pages that fit, bf16 and int8.  The cap is then the int32
        range: lanes below 2^31, and an int8 block's PV sums (1,065,088
        lanes at page 16); one page more raises with it."""
        monkeypatch.setattr(pfd_kernel, "sm_count", lambda device: self.SMS)
        P, S = 16, 524288
        single = pfd_kernel.single_pass_lanes(g, 128, P)
        assert single < S
        assert pfd_kernel.plan(1, 2, g, 128, single // P, P, self.SMS).pass_lanes == 0
        for fmt in ("bf16", "int8"):
            q, k, table, pos, scales = self._operands(fmt, g, S, P)
            p = pfd_ops._validate_cuda(q, k, k, table, pos, P, scales.get("k_scale"),
                                       scales.get("v_scale"))
            assert p.C == pfd_kernel.MAX_CLUSTER and p.C * p.L >= S and p.pass_lanes % P == 0
            assert p.passes == -(-p.L // p.pass_lanes) > 1 and p.smem <= build.MAX_SMEM
        cap = pfd_kernel.max_lanes(g, 128, P, int8=True)
        assert cap == 1_065_088 and pfd_kernel.max_lanes(g, 128, P) == 2 ** 31 - P
        pfd_kernel.plan(1, 2, g, 128, cap // P, P, self.SMS, int8=True)  # the cap itself fits
        q, k, table, pos, scales = self._operands("int8", g, cap + P, P)
        with pytest.raises(ValueError, match=f"over the cap at g={g}, D=128, page_size={P}, "
                                             f"int8: {cap} lanes"):
            pfd_ops._validate_cuda(q, k, k, table, pos, P, scales["k_scale"], scales["v_scale"])
        with pytest.raises(ValueError, match=f"cap at g={g}, D=128, page_size={P}: "
                                             f"{2 ** 31 - P} lanes"):
            pfd_kernel.plan(1, 2, g, 128, 2 ** 31 // P, P, self.SMS)

    @pytest.mark.parametrize("fmt", ["bf16", "int8"])
    @pytest.mark.parametrize("D,P,DP", [(24, 4, 32), (16, 6, 16), (24, 6, 32), (256, 6, 256),
                                         (1, 1, 16), (200, 3, 256)])
    def test_takes_padded_widths_and_any_page_size(self, monkeypatch, fmt, D, P, DP):
        """Shapes the card once refused (D 24, page 6): any D up to 256 runs
        at its compiled width, any page size >= 1, unaligned rows too."""
        monkeypatch.setattr(pfd_kernel, "sm_count", lambda device: self.SMS)
        assert pfd_kernel.padded_dim(D) == DP
        q, k, table, pos, scales = self._operands(fmt, 3, 64 * P, P, D=D)
        plan = pfd_ops._validate_cuda(q, k, k, table, pos, P, scales.get("k_scale"),
                                      scales.get("v_scale"))
        assert plan == pfd_kernel.plan(1, 2, 3, D, 64, P, self.SMS)
        assert plan.smem == pfd_kernel.smem_bytes(3, DP, plan.L, P) and plan.L % P == 0
        assert pfd_kernel.wide_rows(k, k) == ((D * k.element_size()) % 16 == 0)

    @pytest.mark.parametrize("D,g,match", [(512, 3, "D=512 is over the widest compiled width"),
                                           (24, 9, "g=9 > 8")])
    def test_rejects_shapes_it_has_no_instance_for(self, monkeypatch, D, g, match):
        monkeypatch.setattr(pfd_kernel, "sm_count", lambda device: self.SMS)
        q = torch.zeros(1, 2, g, D)
        k = torch.zeros(12, 2, D, dtype=torch.bfloat16)
        t, p = torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
        with pytest.raises(ValueError, match=match):
            pfd_ops._validate_cuda(q, k, k, t, p, 6, None, None)

    @pytest.mark.parametrize("P", [1, 2, 3, 5, 6, 7, 12, 16, 24, 100, 255, 256, 1000, 4097])
    def test_page_divider_is_exact(self, P):
        """The source's ``PageDiv``: ``(umulhi(s, magic) + s) >> shift``
        equals ``s // P`` for lanes up to 2^31 (every lane of the first
        pages and the last, and random ones)."""
        magic, shift = pfd_kernel.page_divider(P)
        assert 0 < magic < 2 ** 32 and (P & (P - 1) or (magic, shift) == (1, P.bit_length() - 1))
        rng = np.random.default_rng(P)
        s = np.concatenate([np.arange(4 * P + 70000), 2 ** 31 - 1 - np.arange(4 * P + 1000),
                            rng.integers(0, 2 ** 31, 100000)]).astype(np.uint64)
        got = (((s * np.uint64(magic)) >> np.uint64(32)) + s) >> np.uint64(shift)
        np.testing.assert_array_equal(got, s // np.uint64(P))

    @pytest.mark.parametrize("fmt", ["bf16", "int8"])
    @pytest.mark.parametrize("g", [1, 2, 4, 8])
    def test_head_width_256_keeps_the_32k_context(self, monkeypatch, fmt, g):
        """gemma3-1b (g 4, Hk 1), gemma3-4b (g 2, Hk 4) and paligemma-3b
        (g 8, Hk 1) at D 256: the cap covers the reference's decode_32k
        context at pages 16 and 6, and a 32k slot plans within shared
        memory."""
        monkeypatch.setattr(pfd_kernel, "sm_count", lambda device: self.SMS)
        for P in (16, 6):
            assert pfd_kernel.max_lanes(g, 256, P) >= 32768
            pp = -(-32768 // P)
            q, k, table, pos, scales = self._operands(fmt, g, pp * P, P, D=256)
            plan = pfd_ops._validate_cuda(q, k, k, table, pos, P, scales.get("k_scale"),
                                          scales.get("v_scale"))
            assert plan.C * plan.L >= pp * P and plan.smem <= build.MAX_SMEM
            assert plan.smem == pfd_kernel.smem_bytes(g, 256, plan.L, P)

    @pytest.mark.parametrize("g,D,P,S,pos", [
        (2, 256, 16, 524288, 524287), (4, 256, 16, 524288, 300000),
        (5, 128, 16, 524288, 1000), (8, 256, 16, 524288, -1),
        (3, 128, 6, 300000, 299999), (1, 16, 1, 500000, 77777)])
    def test_passes_walk_every_lane_once(self, g, D, P, S, pos):
        """The pass bodies' walk (``csrc/paged_flash_decode_long.cu``):
        block c owns the lanes ``[c L, (c + 1) L)`` up to the slot's span and
        walks them in passes of ``pass_lanes`` from its first lane, each pass
        whole pages (its page bases fill at most the pass's array); every
        lane of the span is walked once, a slot ending in an earlier pass
        walks no later one (a block past it none), the pass's scores and
        page bases fit shared memory, and an int8 block's PV sums fit int32."""
        pp = -(-S // P)
        span = pp * P if pos < 0 else min(pos + 1, pp * P)
        for int8 in (False, True):
            p = pfd_kernel.plan(1, 2, g, D, pp, P, self.SMS, int8=int8)
            assert p.pass_lanes > 0 and p.L % P == 0 and p.pass_lanes % P == 0
            assert p.smem == pfd_kernel.smem_bytes(g, D, p.pass_lanes, P) <= build.MAX_SMEM
            assert p.passes == -(-p.L // p.pass_lanes)
            seen = np.zeros(p.C * p.L, np.int64)
            for c in range(p.C):
                lo = c * p.L
                hi = max(lo, min(lo + p.L, span))
                walked = list(range(lo, hi, p.pass_lanes))
                assert len(walked) <= p.passes
                assert len(walked) == -(-(hi - lo) // p.pass_lanes)  # none past the span
                for plo in walked:
                    phi = min(plo + p.pass_lanes, hi)
                    assert plo % P == 0 and -(-(phi - plo) // P) <= p.pass_lanes // P
                    seen[plo:phi] += 1
            np.testing.assert_array_equal(seen[:span], 1)
            assert not seen[span:].any()
            if int8:
                assert p.L * 127 * 127 < 2 ** 31


# the served archs with attention (an ssm config has no KV heads)
SERVED_ARCHS = sorted(n for n in ARCH_REGISTRY
                      if get_config(n).family in TRANSFORMER_FAMILIES)


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_every_assigned_decode_shape_plans_on_the_card(arch):
    """Every decode cell of the reference's shape table
    (``configs/shapes.py``: decode_32k for every arch, long_500k for the
    sub-quadratic ones) that a served arch is assigned plans on the H100's
    132 SMs at the arch's heads, page 16: K1's bf16 and int8 bodies at both
    lengths (long_500k in passes), K2 at decode_32k (its lists in the
    workspace where they do not fit) in one cluster, and at long_500k with
    its selection spanning blocks (``Plan.spans``: 128 tiles a cell).  One
    lane past the cap (524,288) is refused, the cap named."""
    cfg = get_config(arch)
    Hk, D = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // Hk
    cells = [s for s in shapes.SHAPES if s.kind == "decode" and shapes.applicable(arch, s) is None]
    assert {s.name for s in cells} >= {"decode_32k"}
    for shape in cells:
        S, B, P = shape.seq_len, shape.global_batch, 16
        for int8 in (False, True):
            p = pfd_kernel.plan(B, Hk, g, D, S // P, P, 132, int8=int8)
            assert p.C * p.L >= S and p.smem <= build.MAX_SMEM
            assert (p.pass_lanes > 0) == (S > pfd_kernel.single_pass_lanes(g, D, P)
                                          or (int8 and S * 127 * 127 >= 2 ** 31))
        _, k_max, surv = tkvc.bgpp_decode_plan(S, cfg)
        p = bgpp_kernel.plan(B, Hk, g, D, S, k_max, surv, 132)
        assert p.C * p.L >= S and p.smem <= build.MAX_SMEM
        assert p.spans == (shape.name == "long_500k") == (S > bgpp_kernel.cluster_lanes(g, D))
        if p.spans:
            assert (p.C, p.L) == (128, bgpp_kernel.LONG_TILE)
            assert p.caps == tuple(-(-w // p.L) for w in bgpp_kernel.list_widths(S, k_max, surv))
        S = bgpp_kernel.max_lanes(g, D) + 1
        _, k_max, surv = tkvc.bgpp_decode_plan(S, cfg)
        with pytest.raises(ValueError, match=f"the cap at g={g}, D={D} is 524288 lanes"):
            bgpp_kernel.plan(B, Hk, g, D, S, k_max, surv, 132)


def _k2_parity(g, s_ctx, D, seed, page=None):
    """K2's CPU path against the JAX plain version at head width ``D``:
    the survivors equal the engine's top-k lanes and the output is within
    one probability-code step a row.  ``phys`` is a shuffled permutation of
    the pool's rows, or with ``page`` the rows of a shuffled page table of
    that page size."""
    rng = np.random.default_rng(seed)
    B, Hk, S = 3, 2, 48
    n_tok = 2 * B * S
    q = rng.normal(size=(B, Hk, g, D)).astype(np.float32)
    kf = _j(rng.normal(size=(n_tok, Hk, D)).astype(np.float32))
    kq, ks = jkvc.quantize_kv(kf)
    planes, sign = jkvc.k_to_bitplanes(kq)
    vq, vs = jkvc.quantize_kv(_j(rng.normal(size=(n_tok, Hk, D)).astype(np.float32)))
    ops = [np.asarray(a) for a in (planes, sign, ks, vq, vs)]
    if page is None:
        phys = rng.permutation(n_tok)[:B * S].reshape(B, S).astype(np.int32)
    else:
        pp = -(-S // page)
        table = rng.permutation(n_tok // page)[:B * pp].reshape(B, pp)
        s = np.arange(S)
        phys = (table[:, s // page] * page + s % page).astype(np.int32)
    pos = np.asarray([s_ctx - 1, min(S - 1, 2 * s_ctx), 0], np.int32)
    rounds, k_max, surv = _plan(S)
    want = np.asarray(jax_bgpp_ref(_j(q), *map(_j, ops), _j(phys), _j(pos),
                                   rounds=rounds, k_max=k_max, survivors=surv))
    got, idx = bgpp_paged_attend(_t(q), *map(_t, ops), _t(phys), _t(pos),
                                 rounds=rounds, k_max=k_max, survivors=surv,
                                 return_indices=True)
    assert idx.shape == (B, Hk, k_max) and idx.dtype == torch.int32
    assert got.shape == (B, Hk, g, D)
    # selection: the survivors are exactly the engine's top-k lanes
    want_idx = _jax_topk_indices(q, ops, phys, pos, rounds, k_max, surv)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    # the exact int8 attend over those survivors
    rows = np.take_along_axis(phys, want_idx.reshape(B, -1), 1).reshape(want_idx.shape)
    at = lambda a: np.asarray(a)[rows, np.arange(Hk)[None, :, None]]
    valid = want_idx <= pos[:, None, None]
    _assert_close_int8(got.numpy(), want, _code_step(q, at(kq), at(ks), at(vs), valid))


class TestBgppPagedAttendRef:
    @pytest.mark.parametrize("g", [1, 3])
    @pytest.mark.parametrize("s_ctx", [5, 16, 40])
    def test_matches_jax_ref_on_shuffled_phys(self, g, s_ctx):
        _k2_parity(g, s_ctx, D, 100 * g + s_ctx)

    @pytest.mark.parametrize("Dh,page,g", [(24, None, 3), (256, None, 1), (256, 6, 2),
                                           (16, 6, 3), (24, 6, 1)])
    def test_matches_jax_ref_at_other_widths_and_pages(self, Dh, page, g):
        """The head widths the card now pads (D 24 runs at 32) or has an
        instance for (D 256), and pool rows of a page-6 table."""
        _k2_parity(g, 16, Dh, Dh + g, page)

    def test_plain_version_matches_ops_wrapper(self):
        rng = np.random.default_rng(5)
        B, Hk, g, S = 2, 2, 3, 32
        n_tok = B * S
        q = torch.from_numpy(rng.normal(size=(B, Hk, g, D)).astype(np.float32))
        kq, ks = tkvc.quantize_kv(torch.randn(n_tok, Hk, D, generator=torch.Generator().manual_seed(1)))
        planes, sign = tkvc.k_to_bitplanes(kq)
        vq, vs = tkvc.quantize_kv(torch.randn(n_tok, Hk, D, generator=torch.Generator().manual_seed(2)))
        phys = torch.arange(n_tok, dtype=torch.int32).reshape(B, S)
        pos = torch.tensor([S - 1, 9], dtype=torch.int32)
        plan = dict(rounds=3, k_max=8, survivors=(S, 16, 8))
        a = bgpp_paged_attend(q, planes, sign, ks, vq, vs, phys, pos, **plan)
        b = bgpp_paged_attend_ref(q, planes, sign, ks, vq, vs, phys, pos, **plan)
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_rejects_bad_plan(self):
        B, Hk, g, S, n_tok = 1, 2, 3, 16, 16
        ops = (torch.zeros(B, Hk, g, D), torch.zeros(7, n_tok, Hk, D // 8, dtype=torch.uint8),
               torch.zeros(n_tok, Hk, D // 8, dtype=torch.uint8), torch.zeros(n_tok, Hk),
               torch.zeros(n_tok, Hk, D, dtype=torch.int8), torch.zeros(n_tok, Hk),
               torch.zeros(B, S, dtype=torch.int32), torch.zeros(B, dtype=torch.int32))
        with pytest.raises(ValueError, match="survivors"):
            bgpp_paged_attend(*ops, rounds=2, k_max=4, survivors=(8, 4))
        with pytest.raises(ValueError, match="k_max"):
            bgpp_paged_attend(*ops, rounds=2, k_max=9, survivors=(16, 8))


# ---------------------------------------------------------------------------
# K2 bgpp_paged_attend: the CUDA launch plan, the scoring arithmetic and the
# cluster selection
# ---------------------------------------------------------------------------


def _k2_survivors(S, keep=0.25, rounds=4):
    """``kv_cache.bgpp_decode_plan``'s (k_max, survivors) for a width."""
    k_max = max(1, min(S, math.ceil(keep * S)))
    return k_max, (S,) + tuple(max(k_max, S >> r) for r in range(1, rounds))


class TestBgppPagedAttendPlan:
    """K2's CUDA launch geometry (``kernel.plan``: C blocks a (slot,
    kv-head) cluster, each owning L round-0 lanes and ``caps[r]`` ranks of
    the list of round r), from static shapes alone: no card is needed."""

    SMS = 132  # an H100 SXM

    @pytest.mark.parametrize("B,Hk,g,D,S", [
        (4, 8, 3, 128, 1024),  # the decode geometry
        (4, 8, 5, 128, 1024),  # llama4-scout's (g 5: the G 8 instance)
        (1, 8, 3, 128, 32768),  # a long context
        (4, 8, 8, 128, 8192),
        (64, 8, 3, 128, 2048),  # more cells than SMs
        (2, 2, 3, 16, 64),  # the smoke config
        (3, 2, 5, 64, 1000),  # lanes that do not split evenly
        (1, 1, 1, 32, 1),  # a single lane
    ])
    def test_every_lane_has_one_block(self, B, Hk, g, D, S):
        k_max, surv = _k2_survivors(S)
        p = bgpp_kernel.plan(B, Hk, g, D, S, k_max, surv, self.SMS)
        C, L, caps, smem = p.C, p.L, p.caps, p.smem
        assert C in (1, 2, 4, 8) and L == caps[0] <= bgpp_kernel.MAX_LIST
        widths = bgpp_kernel.list_widths(S, k_max, surv)
        assert len(caps) == len(widths) == len(surv) + 1
        for width, cap in zip(widths, caps):  # round 0's lanes, every list's ranks
            owners = np.zeros(width, np.int64)
            for c in range(C):
                owners[c * cap:min((c + 1) * cap, width)] += 1
            np.testing.assert_array_equal(owners, 1)
            assert cap <= L  # every list fits a block's region
        assert smem == bgpp_kernel.smem_bytes(g, D, L, p.workspace) <= build.MAX_SMEM
        assert p.workspace == (bgpp_kernel.smem_bytes(g, D, L) > build.MAX_SMEM)

    def test_decode_geometry_fills_the_card(self):
        B, Hk, S = 4, 8, 1024
        k_max, surv = _k2_survivors(S)
        p = bgpp_kernel.plan(B, Hk, 3, 128, S, k_max, surv, self.SMS)
        assert (p.C, p.L, p.caps, p.workspace) == (4, 256, (256, 128, 64, 64, 64), False)
        C = p.C
        assert 128 <= B * Hk * C <= self.SMS

    @pytest.mark.parametrize("g", range(1, 9))
    @pytest.mark.parametrize("D", bgpp_kernel.HEAD_DIMS)
    def test_shared_memory_fits_up_to_the_cap(self, g, D):
        """The cap is the block sort's, 32768 lanes, at every group and
        width: the lists go to the workspace where they do not fit beside
        the rest (g >= 4 at D 128), whose size the plan gives."""
        cap = bgpp_kernel.cluster_lanes(g, D)
        assert cap == bgpp_kernel.MAX_CLUSTER * bgpp_kernel.MAX_LIST == 32768
        assert bgpp_kernel.max_lanes(g, D) == bgpp_kernel.LONG_MAX_LANES == 524288
        k_max, surv = _k2_survivors(cap)
        p = bgpp_kernel.plan(1, 8, g, D, cap, k_max, surv, self.SMS)
        assert p.C == bgpp_kernel.MAX_CLUSTER and p.smem <= build.MAX_SMEM
        assert p.workspace == (bgpp_kernel.smem_bytes(g, D, p.L) > build.MAX_SMEM)
        want_ws = 8 * p.C * 2 * p.L * bgpp_kernel.entry_ints(g) if p.workspace else 0
        assert bgpp_kernel.workspace_ints(1, 8, g, p) == want_ws
        if D == 128:
            assert p.workspace == (g >= 4)
        L = cap // bgpp_kernel.MAX_CLUSTER + 1  # one lane more a block does not fit
        assert L > bgpp_kernel.MAX_LIST

    @staticmethod
    def _operands(g, S, D=128, n_tok=16):
        """CPU operands the CUDA validation accepts (it never reads the
        pool rows or the phys map)."""
        Hk = 2
        return (torch.zeros(1, Hk, g, D),
                torch.zeros(7, n_tok, Hk, D // 8, dtype=torch.uint8),
                torch.zeros(n_tok, Hk, D // 8, dtype=torch.uint8),
                torch.ones(n_tok, Hk), torch.zeros(n_tok, Hk, D, dtype=torch.int8),
                torch.ones(n_tok, Hk), torch.zeros(1, S, dtype=torch.int32),
                torch.full((1,), S - 1, dtype=torch.int32))

    @pytest.mark.parametrize("g", [1, 2, 3])
    def test_wrapper_takes_32k_lanes_at_phi4_mini_group(self, monkeypatch, g):
        monkeypatch.setattr(bgpp_ops, "sm_count", lambda device: self.SMS)
        S = 32768
        assert bgpp_kernel.max_lanes(g, 128) >= S
        k_max, surv = _k2_survivors(S)
        p = bgpp_ops._validate_cuda(*self._operands(g, S), k_max, surv)
        assert p.C * p.L >= S and p.smem <= build.MAX_SMEM

    @pytest.mark.parametrize("g", [1, 3, 8])
    def test_past_the_cap_the_wrapper_raises_with_it(self, monkeypatch, g):
        monkeypatch.setattr(bgpp_ops, "sm_count", lambda device: self.SMS)
        cap = bgpp_kernel.max_lanes(g, 128)
        S = cap + 8
        k_max, surv = _k2_survivors(S)
        with pytest.raises(ValueError, match=f"the cap at g={g}, D=128 is {cap} lanes"):
            bgpp_ops._validate_cuda(*self._operands(g, S), k_max, surv)

    @pytest.mark.parametrize("D,DP", [(24, 32), (256, 256), (8, 16), (200, 256), (96, 128)])
    def test_takes_padded_head_dims(self, monkeypatch, D, DP):
        """Widths the card once refused (D 24 and 256): a multiple of 8 up to
        256 runs at its compiled width, the plane rows byte by byte where
        they are not the compiled width's whole words."""
        monkeypatch.setattr(bgpp_ops, "sm_count", lambda device: self.SMS)
        k_max, surv = _k2_survivors(64)
        ops = self._operands(3, 64, D=D)
        p = bgpp_ops._validate_cuda(*ops, k_max, surv)
        assert bgpp_kernel.padded_dim(D) == DP
        assert p == bgpp_kernel.plan(1, 2, 3, D, 64, k_max, surv, self.SMS)
        assert p.smem == bgpp_kernel.smem_bytes(3, DP, p.L)
        assert bgpp_kernel.wide_rows(ops[1], ops[2], ops[4]) == (int(D == DP) | 2)

    @pytest.mark.parametrize("D,g,match", [(512, 3, "D=512 is over the widest compiled width"),
                                           (24, 9, "g=9 > 8")])
    def test_rejects_head_dims_it_has_no_instance_for(self, monkeypatch, D, g, match):
        monkeypatch.setattr(bgpp_ops, "sm_count", lambda device: self.SMS)
        k_max, surv = _k2_survivors(64)
        with pytest.raises(ValueError, match=match):
            bgpp_ops._validate_cuda(*self._operands(g, 64, D=D), k_max, surv)

    @pytest.mark.parametrize("g,S", [(1, 32768), (2, 32768), (4, 16384), (8, 8192)])
    def test_head_width_256_caps(self, monkeypatch, g, S):
        """D 256 (gemma3-4b g 2; gemma3-1b g 4; paligemma-3b g 8): the header
        and the warps' partials at 256 fit beside the lists up to the old
        caps (S here: 32768 at g <= 2, 18,232 at g 4, 10,792 at g 8), and
        with the lists in the workspace past them, up to the reference's
        decode_32k at every g."""
        monkeypatch.setattr(bgpp_ops, "sm_count", lambda device: self.SMS)
        assert bgpp_kernel.header_bytes(256) == 4640 and bgpp_kernel.header_bytes(128) == 2592
        assert bgpp_kernel.cluster_lanes(g, 256) == 32768
        for n in (S, 32768):
            k_max, surv = _k2_survivors(n)
            p = bgpp_ops._validate_cuda(*self._operands(g, n, D=256), k_max, surv)
            assert p.C * p.L >= n
            assert p.smem == bgpp_kernel.smem_bytes(g, 256, p.L, p.workspace) <= build.MAX_SMEM
            assert p.workspace == (n > S)


def _k2_words(packed):
    """Packed bit rows ``(..., D/8)`` uint8 -> ``(..., W)`` little-endian
    32-bit words (D 16: one word, its high half zero), as the kernel loads
    them."""
    pad = (-packed.shape[-1]) % 4
    a = np.concatenate([packed, np.zeros(packed.shape[:-1] + (pad,), np.uint8)], -1)
    return np.ascontiguousarray(a).view("<u4")


def _k2_plane_dot(codes, plane, sign, qlo=3):
    """``plane_dot`` of ``csrc/bgpp_paged_attend.cu`` -> ``(g, n)`` int64:
    the query's masks are plane p of each int8 code row's truncated
    magnitude (``(|c| >> qlo) << qlo``) and its sign, and a packed row
    ``(n, D/8)`` scores sum_p 2^p (popc(q_p & k & ~(q_s ^ k_s)) -
    popc(q_p & k & (q_s ^ k_s))) over its 32-bit words."""
    mag = (np.abs(codes) >> qlo) << qlo
    pack = lambda bits: _k2_words(np.packbits(bits.astype(np.uint8), -1, bitorder="little"))
    qs = pack(codes < 0)  # (g, W)
    kb, ks = _k2_words(plane), _k2_words(sign)
    x = qs[:, None] ^ ks[None]  # (g, n, W)
    pm, nm = kb[None] & ~x, kb[None] & x
    acc = np.zeros(x.shape[:2], np.int64)
    for p in range(qlo, 7):
        q = pack((mag >> p) & 1)[:, None]  # (g, 1, W)
        cnt = (np.bitwise_count(q & pm).astype(np.int64)
               - np.bitwise_count(q & nm).astype(np.int64))
        acc += cnt.sum(-1) << p
    return acc


def _k2_rebuilt_dot(codes, planes, sign):
    """Phase 2 of ``csrc/bgpp_paged_attend.cu`` on one survivor -> ``(g,)``:
    planes ``(7, D/8)`` + sign ``(D/8,)`` in 4-byte chunks (2 at D 16); per
    8 columns, byte ``grp`` of the 8 rows' words gathered (``__byte_perm``)
    and bit-transposed (``transpose8``) into sign-magnitude bytes, dotted
    with the int8 codes ``(g, D)`` as ``dp4a(m ^ neg, q) - dp4a(neg, q)``."""
    g, D = codes.shape
    cb = 4 if D >= 32 else 2
    rows = np.concatenate([planes, sign[None]], 0)  # (8, D/8)
    word = lambda b: int.from_bytes(bytes(b.tolist()), "little")
    sbyte = lambda x, j: ((x >> 8 * j) & 0xFF) - (256 if (x >> 8 * j) & 0x80 else 0)
    dp4a = lambda a, qv: sum(sbyte(a, j) * int(qv[j]) for j in range(4))
    dot = np.zeros(g, np.int64)
    for ch in range(D // (8 * cb)):
        P = [word(rows[pl, ch * cb:(ch + 1) * cb]) for pl in range(8)]
        for grp in range(cb):
            lo = sum(((P[r] >> 8 * grp) & 0xFF) << 8 * r for r in range(4))
            hi = sum(((P[4 + r] >> 8 * grp) & 0xFF) << 8 * r for r in range(4))
            lo, hi = _k3_transpose8(lo, hi)
            col = ch * 8 * cb + 8 * grp
            for x, c0 in ((lo, col), (hi, col + 4)):
                neg = ((x >> 7) & 0x01010101) * 0xFF
                for gi in range(g):
                    qv = codes[gi, c0:c0 + 4]
                    dot[gi] += dp4a((x & 0x7F7F7F7F) ^ neg, qv) - dp4a(neg, qv)
    return dot


def _k2_cluster_select(lanes, score, nv, width, width_next, C, cap):
    """One selection of the cluster on the CPU, as the kernel makes it.

    ``lanes`` are the current list's valid entries (its first ``min(nv,
    width)``, in list order) with integer ``score``; block c holds the
    ranks ``[c * cap, (c + 1) * cap)`` of them.  Each block sorts its keys
    (score descending, list position ascending); an entry's rank is its
    rank in its block plus, for each other block, the count of that block's
    keys below it (a binary search of its sorted run), and only entries of
    local rank below the next list's valid width are ranked.  Returns the
    next list's valid lanes in rank order and the whole list (the lanes
    past the valid ones, ``nv, nv + 1, ...``, implied)."""
    n_valid = min(nv, width)
    assert len(lanes) == n_valid
    # the kernel's unsigned key (2^31 - score) << 32 | position, less 2^63:
    # the same order in int64
    key = -torch.as_tensor(score, dtype=torch.int64) << 32 | torch.arange(n_valid)
    runs = [torch.sort(key[c * cap:(c + 1) * cap]).values for c in range(C)]
    nxt = min(nv, width_next)
    out = torch.full((nxt,), -1, dtype=torch.int64)
    hits = torch.zeros(nxt, dtype=torch.int64)
    for c, run in enumerate(runs):
        keys = run[:nxt]
        at = torch.arange(keys.numel()) + sum(torch.searchsorted(o, keys)
                                              for c2, o in enumerate(runs) if c2 != c)
        keep = at < nxt
        hits.index_add_(0, at[keep], torch.ones_like(at[keep]))
        out[at[keep]] = lanes[keys[keep] & 0xFFFFFFFF]
    assert bool((hits == 1).all())  # ranks are unique and cover the next list
    return out, torch.cat([out, nv + torch.arange(width_next - nxt)])


class TestBgppPagedAttendArithmetic:
    """K2's arithmetic, emulated on the CPU: the integer plane dot and the
    phase-2 rebuild equal the plain version's scores exactly, and the
    cluster's selection equals ``ref.topk_indices`` round by round."""

    @pytest.mark.parametrize("D", [16, 32, 64, 128])
    @pytest.mark.parametrize("g", [1, 3, 8])
    def test_plane_dot_is_the_plain_plane_score(self, D, g):
        rng = np.random.default_rng(D + g)
        n = 64
        q = torch.from_numpy(rng.normal(size=(1, 1, g, D)).astype(np.float32))
        qf = bgpp_ref.quant_query(q)[0, 0]  # (g, D) truncated integer floats
        codes = tkvc.quantize_kv(q.reshape(g, 1, D))[0].reshape(g, D).numpy().astype(np.int64)
        np.testing.assert_array_equal(np.sign(codes) * ((np.abs(codes) >> 3) << 3), qf.numpy())
        kq = rng.integers(-127, 128, (n, D))
        kq[rng.random((n, D)) < 0.3] = 0
        planes, sign = tkvc.k_to_bitplanes(torch.from_numpy(kq.astype(np.int8)))
        sign[: n // 2] = torch.from_numpy(rng.integers(0, 256, (n // 2, D // 8)).astype(np.uint8))
        for p in range(7):  # signs set over zero magnitudes score nothing
            want = bgpp_ref._plane_scores(planes[p][None, None], sign[None, None],
                                          qf[None, None])[0, 0]
            got = _k2_plane_dot(codes, planes[p].numpy(), sign.numpy())
            np.testing.assert_array_equal(got, want.numpy().astype(np.int64))

    @pytest.mark.parametrize("D", [16, 32, 64, 128])
    def test_rebuilt_rows_give_the_exact_int8_dot(self, D):
        rng = np.random.default_rng(D)
        g, n = 3, 12
        codes = rng.integers(-127, 128, (g, D))
        kq = rng.integers(-127, 128, (n, D))
        kq[:, ::5] = 0
        planes, sign = tkvc.k_to_bitplanes(torch.from_numpy(kq.astype(np.int8)))
        sign[0] = 0xFF  # a set sign over a zero magnitude is still 0
        k_signed = tkvc.bitplanes_to_k(planes, sign).numpy().astype(np.int64)
        for j in range(n):
            got = _k2_rebuilt_dot(codes, planes[:, j].numpy(), sign[j].numpy())
            np.testing.assert_array_equal(got, codes @ k_signed[j])

    @pytest.mark.parametrize("C", [1, 2, 4, 8])
    @pytest.mark.parametrize("S,pos", [(1024, 1023), (1024, 100), (1024, 600), (1024, 0),
                                       (1024, -1), (1000, 999), (64, 40), (96, 5)])
    def test_cluster_selection_is_the_plain_top_k(self, C, S, pos):
        """Scores with many ties (7 distinct values a round), every
        selection of a progressive plan, at every cluster size."""
        rng = np.random.default_rng(S + pos + C)
        k_max, surv = _k2_survivors(S)
        widths = bgpp_kernel.list_widths(S, k_max, surv)
        nv = 0 if pos < 0 else min(pos + 1, S)
        valid = torch.arange(S) <= pos
        want = torch.arange(S)  # the plain version's current list
        lanes = torch.arange(nv)  # the cluster's valid entries of it
        for r in range(len(widths) - 1):
            lane_score = torch.from_numpy(rng.integers(-3, 4, S) * 64)
            full = torch.where(valid[want], lane_score[want].float(),
                               torch.tensor(bgpp_ref.NEG_INF))
            want = want[bgpp_ref.topk_indices(full, widths[r + 1])]
            lanes, got = _k2_cluster_select(lanes, lane_score[lanes], nv, widths[r],
                                            widths[r + 1], C, -(-widths[r] // C))
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        if pos < 0:
            torch.testing.assert_close(want, torch.arange(k_max), rtol=0, atol=0)

    @pytest.mark.parametrize("g,S,pos", [(5, 32768, 32767), (8, 32768, 20000), (4, 32768, 700),
                                         (8, 32768, -1), (5, 32768, 4095)])
    def test_workspace_lists_select_what_shared_memory_does(self, g, S, pos):
        """The workspace path (lists in global memory, at S 32768 with
        g >= 4): every selection writes rank ``at`` of the next list to its
        owner's list, ``(blockIdx - rank + owner, (r + 1) & 1, slot)`` of the
        ``(B Hk C, 2, L, ES)`` workspace, as the shared-memory path writes
        it to ``(owner, (r + 1) & 1, slot)`` of the blocks' own lists.  Two
        cells run at once: each address is written at most once a round,
        inside the plan's workspace and its own cell's blocks, never into
        the list the round reads; each block reads back the same entries as
        from shared memory, and the final list is the plain top k."""
        rng = np.random.default_rng(g * S + pos)
        k_max, surv = _k2_survivors(S)
        p = bgpp_kernel.plan(1, 2, g, 128, S, k_max, surv, 132)
        assert p.workspace and p.C == 8
        C, L, ES = p.C, p.L, bgpp_kernel.entry_ints(g)
        size = bgpp_kernel.workspace_ints(1, 2, g, p)
        widths = bgpp_kernel.list_widths(S, k_max, surv)
        nv = 0 if pos < 0 else min(pos + 1, S)
        ws = np.full(size, -1, np.int64)  # the workspace: entry ints (lane, then scores)
        smem = {cell: np.full((C, 2, L, ES), -1, np.int64) for cell in range(2)}
        lanes = {cell: torch.arange(nv) for cell in range(2)}
        want = {cell: torch.arange(S) for cell in range(2)}
        valid = torch.arange(S) <= pos
        count = lambda r, c: max(0, min(min(nv, widths[r]) - c * p.caps[r], p.caps[r]))
        for r in range(len(widths) - 1):
            capn = p.caps[r + 1]
            written = np.zeros(size, np.int64)
            for cell in range(2):
                score = torch.from_numpy(rng.integers(-3, 4, S) * 64)
                full = torch.where(valid[want[cell]], score[want[cell]].float(),
                                   torch.tensor(bgpp_ref.NEG_INF))
                want[cell] = want[cell][bgpp_ref.topk_indices(full, widths[r + 1])]
                nxt, _ = _k2_cluster_select(lanes[cell], score[lanes[cell]], nv, widths[r],
                                            widths[r + 1], C, p.caps[r])
                for at, lane in enumerate(nxt.tolist()):  # the selection's stores
                    owner, slot = at // capn, at % capn
                    entry = [lane] + [lane * 8 + gi for gi in range(g)]
                    entry += [-2] * (ES - len(entry))
                    base = ((cell * C + owner) * 2 * L + ((r + 1) & 1) * L + slot) * ES
                    assert slot < L and base + ES <= size
                    assert base // (2 * L * ES) // C == cell  # inside its own cell's blocks
                    ws[base:base + ES] = entry
                    written[base:base + ES] += 1
                    smem[cell][owner, (r + 1) & 1, slot] = entry
                # the blocks read their new lists back: the same entries either way
                for c in range(C):
                    base = ((cell * C + c) * 2 * L + ((r + 1) & 1) * L) * ES
                    n = count(r + 1, c)
                    got = ws[base:base + n * ES].reshape(n, ES)
                    np.testing.assert_array_equal(got, smem[cell][c, (r + 1) & 1, :n])
                    cur = ((cell * C + c) * 2 * L + (r & 1) * L) * ES  # the list being read
                    assert not written[cur:cur + L * ES].any()
                lanes[cell] = nxt
            assert written.max() <= 1
        for cell in range(2):
            final = torch.cat([lanes[cell], nv + torch.arange(k_max - lanes[cell].numel())])
            torch.testing.assert_close(final, want[cell], rtol=0, atol=0)


def _k2_span_sort(score, tile=bgpp_kernel.LONG_TILE):
    """The sort of ``csrc/bgpp_paged_attend_long.cu`` on one cell's list,
    on the CPU: keys ``(2^22 - score) << 32 | position`` in position order,
    three least-significant-digit passes over the high word's 8-bit digits,
    each a tile histogram, its scan (digits, then tiles, in order) and a
    stable scatter (a key's place: its tile's offset for the digit plus the
    keys of that digit before it in the tile); a pass whose digit has one
    value over the list is skipped.  Every scatter is a permutation.
    Returns the sorted keys (int64)."""
    n = score.size
    hi = (1 << 22) - score.astype(np.int64)
    assert n == 0 or (hi.min() > 0 and hi.max() < 1 << 23)
    cur = hi << 32 | np.arange(n, dtype=np.int64)
    tiles = -(-n // tile)
    tile_of = np.arange(n) // tile
    for p in range(3):
        d = (cur >> (32 + 8 * p)) & 255
        hist = np.bincount(tile_of * 256 + d, minlength=tiles * 256).reshape(tiles, 256)
        tot = hist.sum(0)
        if n == 0 or (tot == n).any():
            continue
        off = (np.cumsum(tot) - tot)[None, :] + np.cumsum(hist, 0) - hist
        group = tile_of * 256 + d
        order = np.argsort(group, kind="stable")
        sorted_group = group[order]
        within = np.empty(n, np.int64)
        within[order] = np.arange(n) - np.searchsorted(sorted_group, sorted_group)
        dest = off[tile_of, d] + within
        np.testing.assert_array_equal(np.sort(dest), np.arange(n))
        nxt = np.empty_like(cur)
        nxt[dest] = cur
        cur = nxt
    return cur


def _k2_span_select(scores, nv, widths, lane_tie_round=None):
    """The spanning body's selection on one cell: ``scores[r]`` each lane's
    integer score after round r's plane; round r's list (its first
    ``min(nv, widths[r])`` valid entries) is sorted by :func:`_k2_span_sort`
    and its first ``min(nv, widths[r + 1])`` keys name the next list's
    entries by position; the lanes past the valid ones follow, implied.
    With ``lane_tie_round`` that round breaks its ties by lane instead of
    list position (what the sort must not do).  Returns the final list."""
    lanes = np.arange(nv)
    for r in range(len(widths) - 1):
        lanes = lanes[:min(nv, widths[r])]
        score = scores[r][lanes]
        if r == lane_tie_round:  # rank by (score, lane): the lane order's sort
            keys = np.lexsort((lanes, -score))[:min(nv, widths[r + 1])]
        else:
            keys = _k2_span_sort(score)[:min(nv, widths[r + 1])] & 0xFFFFFFFF
        lanes = lanes[keys]
    return np.concatenate([lanes, nv + np.arange(widths[-1] - lanes.size)])


class TestBgppSpanningSelection:
    """K2 past one cluster (``csrc/bgpp_paged_attend_long.cu``): its
    selection, modelled on the CPU (:func:`_k2_span_select`), equals the
    plain version's ``progressive_topk`` at the reference's long_500k
    context, indices in order, over heavy ties."""

    @pytest.mark.parametrize("seed,pos", [(0, (524287, 5000)), (1, (300000, -1))])
    def test_spanning_selection_is_the_plain_top_k(self, seed, pos):
        """S 524,288, B 2, g 2, D 16: K rows drawn from 40 row types of
        small integers, so each round's scores repeat across hundreds of
        thousands of lanes; one slot ends at the last lane (or past
        300,000), the other at 5000 (most lanes NEG_INF) or before its
        first lane.  A fifth of the rows are two types built on one base
        row: A adds 64 in column 0 (bit 6, scored at round 0), B adds 32 in
        column 0 and 16 in column 1 (bits 5 and 4); with query codes 8 and
        16 there, A leads B by 512 after round 0, by 256 after round 1 and
        they tie from round 2 on.  Breaking round 2's ties by lane instead
        of by the previous round's selection order (A first) gives another
        order: the sort must keep the list order, and it does."""
        S, B, g, Dh = 524288, 2, 2, 16
        rng = np.random.default_rng(seed)
        rounds, k_max, surv = _plan(S)
        widths = bgpp_kernel.list_widths(S, k_max, surv)
        q_row = rng.integers(-15, 16, Dh) * 8  # truncated codes: multiples of 8 up to 120
        q_row[:2] = (8, 16)
        qf = torch.from_numpy(np.tile(q_row, (B, 1, g, 1)).astype(np.float32))
        types = rng.integers(-40, 41, (40, Dh))
        types[:, :2] = 0
        base = np.where(q_row > 0, 127, -127)  # the base row scores highest
        base[:2] = 0
        a_row, b_row = base.copy(), base.copy()
        a_row[0], b_row[0], b_row[1] = 64, 32, 16
        pick = rng.integers(0, 50, B * S)
        kq = np.where((pick < 40)[:, None], types[np.minimum(pick, 39)],
                      np.where((pick < 45)[:, None], a_row, b_row))
        kq = torch.from_numpy(kq.astype(np.int8))
        planes, sign = tkvc.k_to_bitplanes(kq)  # (7, B S, D/8), (B S, D/8)
        hm = lambda a: a.reshape(a.shape[:-2] + (B, 1, S, Dh // 8))  # heads-major, Hk 1
        planes_h, sign_h = hm(planes), hm(sign)
        valid = torch.arange(S)[None, :] <= torch.tensor(pos)[:, None]
        gather = lambda a, i: torch.gather(a, 2, i[..., None].expand(-1, -1, -1, a.shape[-1]))
        want, _ = bgpp_ref.progressive_topk(
            qf, planes_h[6], sign_h, lambda p, i: gather(planes_h[p], i), valid, rounds,
            k_max, surv)
        partial = 0
        scores = []  # (B, rounds, S) each lane's score after each round's plane
        for r in range(rounds):
            p = 6 - r
            partial = partial + bgpp_ref._plane_scores(planes_h[p], sign_h, qf) * float(2 ** p)
            scores.append(partial.amax(2)[:, 0].numpy().astype(np.int64))
        differs = False
        for b in range(B):
            nv = 0 if pos[b] < 0 else min(pos[b] + 1, S)
            got = _k2_span_select([s[b] for s in scores], nv, widths)
            np.testing.assert_array_equal(got, want[b, 0].numpy())
            lane_ties = _k2_span_select([s[b] for s in scores], nv, widths, lane_tie_round=2)
            differs |= not np.array_equal(lane_ties, got)
        assert differs  # the case tells the two tie orders apart

    @pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 70000])
    def test_sort_is_score_then_position(self, n):
        """The three passes sort by (score descending, position ascending),
        the keys' whole order, over tile edges and constant digits."""
        rng = np.random.default_rng(n)
        score = rng.integers(-5, 6, n) * 4096 + rng.integers(0, 3, n) - (1 << 21) * (n % 2)
        got = _k2_span_sort(score) & 0xFFFFFFFF
        np.testing.assert_array_equal(got, np.lexsort((np.arange(n), -score)))

    @pytest.mark.parametrize("D,DP", [(8, 128), (24, 128), (128, 128), (136, 256), (256, 256)])
    def test_every_width_runs_at_a_compiled_one(self, D, DP):
        """The spanning body has instances at 128 and 256 only: every D (a
        multiple of 8) up to 256 runs at one of them, its plane rows wide
        only at D == DP (else byte by byte), as the cluster body's padded
        widths run."""
        assert bgpp_kernel.long_dim(D) == DP
        planes = torch.zeros(7, 4, 2, D // 8, dtype=torch.uint8)
        v = torch.zeros(4, 2, D, dtype=torch.int8)
        assert bgpp_kernel.wide_rows(planes, planes[0], v, DP) == int(D == DP) | 2

    def test_workspace_holds_every_array(self):
        """``workspace_ints`` covers the source's ``Ws`` arrays at the long
        cases' heads: 64 + 8 g bytes a lane and the rest."""
        for Hk, g, D in ((4, 2, 256), (1, 4, 256), (8, 5, 128)):
            S = 524288
            k_max, surv = _k2_survivors(S)
            p = bgpp_kernel.plan(2, Hk, g, D, S, k_max, surv, 132)
            assert p.spans and p.workspace and p.smem == 0
            W, T, F = p.C * p.L, p.C, -(-k_max // p.L)
            need = 2 * Hk * (4 * W + 2 * g * bgpp_kernel.padded_dim(D) + 2 * W + 2 * g * W
                             + T * 256 + 32 + F * 3 * g + k_max * (2 + g))
            assert need <= bgpp_kernel.workspace_ints(2, Hk, g, p) < need + 2 * Hk * 2 * g * 256


class TestBstcCpuRouting:
    def test_cpu_tensors_never_count_a_launch(self):
        """The BSTC and flash-attention wrappers take their plain versions
        on CPU tensors: no counter moves (the counters are the on-card
        proof of the path)."""
        assert set(LAUNCHES) == {"paged_flash_decode_bf16", "paged_flash_decode_int8",
                                 "bgpp_paged_attend", "bstc_matmul", "bstc_decode",
                                 "flash_attention", "bgpp_score", "brcr_gemm"}
        rng = np.random.default_rng(11)
        w = (rng.integers(-127, 128, (32, 64)) * (rng.random((32, 64)) < 0.1)).astype(np.int8)
        ops = prepare_bstc_matmul_operands(_t(w), _t(np.ones(32, np.float32)), tile_k=32)
        assert ops.enc_planes  # sparse: planes are coded
        reset_launches()
        y = bstc_matmul(ops, torch.ones(64, 4), apply_scale=True)
        plane = prepare_encoded_plane(tbstc.encode_plane(_t((w != 0).astype(np.uint8)), 4),
                                      tile_k=32)
        patt = bstc_decode_patterns(plane)
        assert tuple(y.shape) == (32, 4) and tuple(patt.shape) == (8, 64)
        q, k = torch.ones(1, 9, 4, 16), torch.ones(1, 9, 2, 16)
        att = flash_attention(q, k, k, mask_kind="sliding", window=4)
        att2 = tattention.blocked_attend(q, k, k, mask_kind="chunked", window=4)
        assert att.shape == att2.shape == q.shape
        assert all(n == 0 for n in LAUNCHES.values()), dict(LAUNCHES)


class TestFlashAttentionRouting:
    def test_off_cpu_never_takes_the_plain_version(self, monkeypatch):
        """Off the CPU, ``blocked_attend`` launches the kernel or raises,
        for every mask kind (``prefix_causal`` included): the wrapper
        refuses a device it has no kernel for.  Meta tensors stand in for a
        card here; the plain versions are made to fail so a fallback would
        show."""
        def no_plain(*a, **kw):
            raise AssertionError("took the plain version off the CPU")

        monkeypatch.setattr(tattention, "attend", no_plain)
        monkeypatch.setattr(flash_ops, "flash_attention_ref", no_plain)
        q = torch.empty(1, 8, 4, 16, device="meta")
        k = torch.empty(1, 8, 2, 16, device="meta")
        reset_launches()
        with pytest.raises(ValueError, match="no kernel for device"):
            tattention.blocked_attend(q, k, k, mask_kind="prefix_causal", window=3)
        with pytest.raises(ValueError, match="no kernel for device"):
            tattention.blocked_attend(q, k, k)
        assert LAUNCHES["flash_attention"] == 0


def _pallas_live(mask_kind, window, q_offset, iq, ik, tile_q, tile_k):
    """The Pallas body's tile predicate (``live``,
    ``src/repro/kernels/flash_attention/kernel.py:61``-``:70``)."""
    q_lo = iq * tile_q + q_offset
    q_hi = q_lo + tile_q - 1
    k_lo = ik * tile_k
    k_hi = k_lo + tile_k - 1
    if mask_kind == "full":
        return True
    if mask_kind == "causal":
        return k_lo <= q_hi
    if mask_kind == "sliding":
        return k_lo <= q_hi and k_hi >= q_lo - window + 1
    return k_lo <= q_hi and k_hi // window >= q_lo // window


# (mask_kind, window) of the kernel phase's cases, and windows whose edges
# fall one key short of a tile's end; the VLM's prefix_causal at prefixes
# on, one short of and one past a tile edge, and inside the first tile
FLASH_MASKS = [("causal", 0), ("sliding", 256), ("chunked", 256), ("full", 0),
               ("sliding", 100), ("chunked", 64), ("sliding", 97), ("chunked", 96),
               ("prefix_causal", 256), ("prefix_causal", 100), ("prefix_causal", 63),
               ("prefix_causal", 65), ("prefix_causal", 20)]


def _flash_warp_rows(p, y, w, Sq):
    """The query rows warp ``w`` of bf16 grid block ``(x, y)`` writes (of
    query head ``x % Hq``), as ``csrc/flash_attention.cu`` indexes them:
    a row group's first warp its 16 rows, the key-half warp (``w >= 2``)
    none."""
    if w >= 2:
        return range(0)
    q0 = (p.grid[1] - 1 - y) * p.BQ + 16 * w
    return range(q0, min(q0 + 16, Sq))


def _flash_key_tiles(mask_kind, window, q_lo, q_hi, Sk):
    """The key tiles a block over query positions ``[q_lo, q_hi]`` visits
    (``csrc/flash_attention.cu``: the run between the first and the last
    tile ``tile_live`` passes)."""
    TK = flash_kernel.TILE_K

    def live(kt):
        k_lo, k_hi = kt * TK, min(kt * TK + TK, Sk) - 1
        if mask_kind == "full":
            return True
        if mask_kind == "prefix_causal":  # a prefix tile's rows reach key window - 1
            return k_lo <= q_hi or (k_lo < window and q_lo < window)
        if k_lo > q_hi:
            return False
        if mask_kind == "causal":
            return True
        if mask_kind == "sliding":
            return k_hi >= q_lo - window + 1
        return k_hi // window >= q_lo // window

    tiles = [kt for kt in range(-(-Sk // TK)) if live(kt)]
    return range(tiles[0], tiles[-1] + 1) if tiles else range(0)


class TestFlashAttentionPlan:
    """The CUDA launch geometry of K5 (``kernel.plan`` and the source's
    index math), checked from static shapes alone: no card is needed."""

    SMS = 132  # an H100 SXM

    @pytest.mark.parametrize("B,Sq,Hq", [(1, 1, 24), (1, 63, 24), (1, 65, 24), (1, 301, 24),
                                          (1, 450, 24), (2, 65, 4), (3, 33, 2)])
    def test_every_row_and_head_has_one_warp(self, B, Sq, Hq):
        p = flash_kernel.plan(torch.bfloat16, B, Sq, Hq, 128)
        assert p.threads == 128 and p.grid == (B * Hq, -(-Sq // p.BQ))
        owners = np.zeros((B, Sq, Hq), np.int64)
        for x in range(p.grid[0]):
            for y in range(p.grid[1]):
                for w in range(p.threads // 32):
                    for s in _flash_warp_rows(p, y, w, Sq):
                        owners[x // Hq, s, x % Hq] += 1
        np.testing.assert_array_equal(owners, 1)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("D", flash_ops.HEAD_DIMS)
    def test_shared_memory_fits(self, dtype, D):
        p = flash_kernel.plan(dtype, 1, 512, 24, D)
        assert p.smem == flash_kernel.smem_bytes(dtype, D) <= build.MAX_SMEM
        if dtype == torch.bfloat16 and D == 128:
            # three blocks (12 warps) an SM: 228 KB of the SM, 1 KB reserved a block
            assert 3 * (p.smem + 1024) <= 228 * 1024

    @pytest.mark.parametrize("S", [201, 301, 450, 512])
    def test_admission_shapes_fill_the_card(self, S):
        p = flash_kernel.plan(torch.bfloat16, 1, S, 24, 128)
        assert p.grid[0] * p.grid[1] >= self.SMS

    @pytest.mark.parametrize("mask_kind,window", FLASH_MASKS)
    @pytest.mark.parametrize("q_offset,Sq,Sk", [
        (off, Sq, Sk) for off in (0, 37, 256)
        for Sq, Sk in ((512, 512), (256, 512), (96, 448), (301, 301), (65, 77), (1, 300))
        if off + Sq <= Sk])
    def test_key_tiles_are_the_visible_ones(self, mask_kind, window, q_offset, Sq, Sk):
        """Per query tile, the kernel visits exactly the key tiles that hold
        a visible pair of the materialised mask, and (on whole tiles) as many
        as the Pallas predicate with ``tile_q`` = 32, ``tile_k`` = 64."""
        BQ, TK = flash_kernel.MMA_BQ, flash_kernel.TILE_K
        mask = tattention.make_mask(mask_kind, Sq, Sk, window, q_offset).numpy()
        for iq in range(-(-Sq // BQ)):
            rows = mask[iq * BQ:(iq + 1) * BQ]
            q_lo, q_hi = q_offset + iq * BQ, q_offset + min((iq + 1) * BQ, Sq) - 1
            got = _flash_key_tiles(mask_kind, window, q_lo, q_hi, Sk)
            want = [kt for kt in range(-(-Sk // TK)) if rows[:, kt * TK:(kt + 1) * TK].any()]
            assert list(got) == want
            if Sq % BQ == 0 and Sk % TK == 0 and mask_kind != "prefix_causal":
                assert len(got) == sum(_pallas_live(mask_kind, window, q_offset, iq, ik, BQ, TK)
                                       for ik in range(Sk // TK))

    @pytest.mark.parametrize("window", [0, 20, 63, 64, 65, 100, 256, 300, 1000])
    @pytest.mark.parametrize("q_offset,Sq,Sk", [(0, 300, 300), (37, 200, 300), (0, 1, 77),
                                                (250, 50, 300)])
    def test_prefix_rows_and_whole_halves(self, window, q_offset, Sq, Sk):
        """prefix_causal in the bf16 body: a row's visible keys are the
        interval ``[0, hi]`` (``hi`` the row's reach inside the prefix, else
        its diagonal, cut at Sk), so the element mask is that interval test;
        a warp's 32-key half that ``tile_whole`` passes is all visible, and
        one ``tile_live`` fails none; ``window <= 0`` is causal (the
        wrapper's rewrite) and ``window >= Sk`` is full attention."""
        kind = "prefix_causal" if window > 0 else "causal"
        mask = tattention.make_mask("prefix_causal", Sq, Sk, window, q_offset).numpy()
        np.testing.assert_array_equal(mask, tattention.make_mask(kind, Sq, Sk, window,
                                                                 q_offset).numpy())
        if window >= Sk:
            assert mask.all()
        w = window
        qi = q_offset + np.arange(Sq)
        reach = np.where(qi < w, np.maximum(qi, w - 1), qi) if w > 0 else qi
        hi = np.minimum(reach, Sk - 1)
        np.testing.assert_array_equal(mask, np.arange(Sk)[None] <= hi[:, None])
        for r0 in range(0, Sq, 16):
            q_lo, q_hi = q_offset + r0, q_offset + min(r0 + 16, Sq) - 1
            rows = mask[r0:r0 + 16]
            for k0 in range(0, Sk, 32):
                k_hi = min(k0 + 32, Sk) - 1
                block = rows[:, k0:k_hi + 1]
                if w > 0:
                    live = k0 <= q_hi or (k0 < w and q_lo < w)
                    whole = k_hi <= q_lo or (q_lo < w and k_hi < w)
                else:
                    live, whole = k0 <= q_hi, k_hi <= q_lo
                assert live == bool(block.any())
                if whole:
                    assert block.all()

    def test_wrapper_raises_for_what_it_has_no_instance_for(self):
        """D 24 (once refused) runs at the compiled 32, unaligned bf16 rows
        are staged element by element; D 512 has no instance."""
        q = torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16)
        k = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
        q24, k24 = torch.zeros(1, 8, 4, 24), torch.zeros(1, 8, 2, 24)
        assert flash_attention(q24, k24, k24).shape == (1, 8, 4, 24)  # the CPU takes any D
        assert flash_ops._validate_cuda(q24, k24, k24) == flash_kernel.plan(
            torch.float32, 1, 8, 4, 32)
        q512, k512 = torch.zeros(1, 8, 4, 512), torch.zeros(1, 8, 2, 512)
        with pytest.raises(ValueError, match=r"head_dim 512 .* widths \(16, 32, 64, 128, 256\)"):
            flash_ops._validate_cuda(q512, k512, k512)
        with pytest.raises(ValueError, match="dtype"):
            flash_attention(q.half(), k.half(), k.half())
        assert flash_ops._validate_cuda(q, k, k).BQ == flash_kernel.MMA_BQ
        strided = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)[..., ::2]
        with pytest.raises(ValueError, match="k must be contiguous along D"):
            flash_ops._validate_cuda(q, strided, k)
        odd = torch.zeros(1 * 8 * 2 * 16 + 1, dtype=torch.bfloat16)[1:].view(1, 8, 2, 16)
        assert flash_ops._validate_cuda(q, k, odd).BQ == flash_kernel.MMA_BQ
        assert flash_kernel.wide_rows(q, k, k) and not flash_kernel.wide_rows(q, k, odd)

    @pytest.mark.parametrize("D,DP", [(24, 32), (1, 16), (100, 128), (200, 256), (256, 256)])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_padded_widths_plan_as_their_compiled_width(self, D, DP, dtype):
        """Any D up to 256 plans as its compiled width: at 256 the bf16
        tiles take 147,456 B (one block an SM, Q read from shared memory)
        and the f32 ones 213,760 B, both under a block's 232,448."""
        assert flash_kernel.padded_dim(D) == DP
        p = flash_kernel.plan(dtype, 2, 77, 8, D)
        assert p == flash_kernel.plan(dtype, 2, 77, 8, DP)
        assert p.smem == flash_kernel.smem_bytes(dtype, DP) <= build.MAX_SMEM
        if DP == 256:
            assert p.smem == {torch.bfloat16: 147_456, torch.float32: 213_760}[dtype]


def _flash_operands(seed, B, Sq, Sk, Hq, Hk, D):
    """bf16-valued float32 q, k, v (the kernel's operands, exact in f32)."""
    rng = np.random.default_rng(seed)
    mk = lambda S, H: torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
    return [t.bfloat16().float() for t in (mk(Sq, Hq), mk(Sk, Hk), mk(Sk, Hk))]


# the kernel phase's mask cases (chip_smoke.FLASH_CASES) at 6 / 2 heads
FLASH_SPLIT_CASES = [("causal", 0, 0, 512, 512), ("sliding", 256, 0, 512, 512),
                     ("chunked", 256, 0, 512, 512), ("full", 0, 0, 512, 512),
                     ("causal", 0, 256, 256, 512)]


class TestFlashAttentionArithmetic:
    """The bf16 body's arithmetic, in float32 on the CPU, against the plain
    version within the tolerance the card holds the kernel to
    (``1e-5 * max|v|`` before the output's bf16 rounding)."""

    @staticmethod
    def _split(p):
        hi = p.bfloat16().float()
        return hi, (p - hi).bfloat16().float()

    @pytest.mark.parametrize("mask_kind,window,q_offset,Sq,Sk", FLASH_SPLIT_CASES)
    def test_split_of_p_stays_inside_the_tolerance(self, mask_kind, window, q_offset, Sq, Sk):
        """p replaced by ``bf16(p) + bf16(p - bf16(p))`` moves the output by
        at most ``2^-18 max|v|``; rounding p once to bf16, as the Pallas
        body does, would not stay inside."""
        q, k, v = _flash_operands(11, 1, Sq, Sk, 6, 2, 128)
        kw = dict(mask_kind=mask_kind, window=window, q_offset=q_offset)
        want = flash_attention_ref(q, k, v, **kw)
        mask = tattention.make_mask(mask_kind, Sq, Sk, window, q_offset)
        qg = q.reshape(1, Sq, 2, 3, 128)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * 128 ** -0.5
        s = torch.where(mask, s, tattention.NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        hi, lo = self._split(p)
        pv = lambda w: torch.einsum("bhgqk,bkhd->bqhgd", w, v).reshape(want.shape)
        den = p.sum(-1).permute(0, 3, 1, 2).reshape(1, Sq, 6, 1)
        tol = 1e-5 * float(v.abs().max())
        assert float((((pv(hi) + pv(lo)) / den) - want).abs().max()) <= tol
        if mask_kind == "full":
            assert float((pv(hi) / den - want).abs().max()) > tol

    @pytest.mark.parametrize("mask_kind,window,q_offset,Sq,Sk", FLASH_SPLIT_CASES + [
        ("causal", 0, 0, 65, 77), ("chunked", 64, 170, 130, 300),
        ("prefix_causal", 100, 0, 300, 300), ("prefix_causal", 256, 37, 200, 300)])
    def test_online_order_stays_inside_the_tolerance(self, mask_kind, window, q_offset, Sq,
                                                     Sk):
        """The body's order of work: each 16-row group in two key halves (32
        of every 64-key tile), p = 2^(s c2 - m c2) with m moved (and l, acc
        rescaled) only once a row of the group grows past it by 2^8, p split
        for PV, the halves merged, out = acc * (1 / l)."""
        q, k, v = _flash_operands(12, 1, Sq, Sk, 2, 1, 64)
        kw = dict(mask_kind=mask_kind, window=window, q_offset=q_offset)
        want = flash_attention_ref(q, k, v, **kw)[0].transpose(0, 1)  # (Hq, Sq, D)
        mask = tattention.make_mask(mask_kind, Sq, Sk, window, q_offset)
        c2 = 64 ** -0.5 * math.log2(math.e)
        s_all = torch.einsum("qhd,khd->hqk", q[0], k[0].expand(Sk, 2, 64))
        s_all = torch.where(mask, s_all, tattention.NEG_INF)
        vv = v[0, :, 0]
        out = torch.empty_like(want)
        for r0 in range(0, Sq, 16):
            rows = slice(r0, min(r0 + 16, Sq))
            halves = []
            for half in (0, 1):
                n = rows.stop - rows.start
                m = torch.full((2, n), tattention.NEG_INF)
                l, acc = torch.zeros(2, n), torch.zeros(2, n, 64)
                for k0 in range(32 * half, Sk, 64):
                    keys = slice(k0, min(k0 + 32, Sk))
                    if not mask[rows, keys].any():
                        continue
                    s = s_all[:, rows, keys]
                    mx = torch.maximum(m, s.amax(-1))
                    if bool(((mx - m) * c2 > 8).any()):
                        c = torch.exp2((m - mx) * c2)
                        m, l, acc = mx, l * c, acc * c[..., None]
                    p = torch.exp2((s - m[..., None]) * c2)
                    hi, lo = self._split(p)
                    l = l + p.sum(-1)
                    acc = acc + hi @ vv[keys] + lo @ vv[keys]
                halves.append((m, l, acc))
            (m0, l0, a0), (m1, l1, a1) = halves
            mm = torch.maximum(m0, m1)
            c0, c1 = torch.exp2((m0 - mm) * c2), torch.exp2((m1 - mm) * c2)
            l = l0 * c0 + l1 * c1
            acc = a0 * c0[..., None] + a1 * c1[..., None]
            out[:, rows] = acc * (1 / l.clamp(min=1e-30))[..., None]
        assert float((out - want).abs().max()) <= 1e-5 * float(v.abs().max())


class TestPaperLayerRouting:
    def test_off_cpu_never_takes_the_plain_version(self, monkeypatch):
        """The paper layer's entry points route like the serving ones: off
        the CPU ``brcr_matmul`` and the BGPP predictors reach their kernel
        wrappers (``brcr_gemm``, ``bgpp_score``), which launch or raise.
        Meta tensors stand in for a device with no kernel; the plain
        versions are made to fail so a fallback would show, and no count
        moves."""
        from repro_torch.core import bgpp as tbgpp
        from repro_torch.core import brcr as tbrcr
        from repro_torch.kernels.bgpp_score import ops as score_ops
        from repro_torch.kernels.brcr_gemm import ops as brcr_ops

        def no_plain(*a, **kw):
            raise AssertionError("took the plain version off the CPU")

        monkeypatch.setattr(score_ops, "bgpp_score_heads_ref", no_plain)
        monkeypatch.setattr(brcr_ops, "brcr_gemm_ref", no_plain)
        meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
        reset_launches()
        with pytest.raises(ValueError, match="no kernel for device"):
            tbrcr.brcr_matmul(meta(8, 32, dtype=torch.int8), meta(32, 4, dtype=torch.int32))
        with pytest.raises(ValueError, match="no kernel for device"):
            tbgpp.bgpp_predict(meta(16, dtype=torch.int32), meta(7, 40, 16, dtype=torch.uint8),
                               meta(40, 16, dtype=torch.uint8))
        with pytest.raises(ValueError, match="no kernel for device"):
            tbgpp.bgpp_predict_batched(meta(2, 6, 16, dtype=torch.int32),
                                       meta(7, 2, 40, 2, 16, dtype=torch.uint8),
                                       meta(2, 40, 2, 16, dtype=torch.uint8))
        assert {"bgpp_score", "brcr_gemm"} <= set(LAUNCHES)
        assert all(n == 0 for n in LAUNCHES.values()), dict(LAUNCHES)


def _jax_topk_indices(q, ops, phys, pos, rounds, k_max, surv):
    """The JAX oracle's survivor lanes (its ``_topk_indices``), for the
    bit-exact selection check."""
    from repro.kernels.bgpp_paged_attend import ref as jref

    planes, sign = (_j(a) for a in ops[:2])
    phys_j = _j(phys)
    B, Hk = q.shape[:2]
    S = phys.shape[1]
    valid = jnp.arange(S)[None, :] <= _j(pos)[:, None]
    hm = lambda a: jnp.moveaxis(a[phys_j], 2, 1)

    def plane_at(p, idx):
        rows = jnp.take_along_axis(phys_j, idx.reshape(B, -1), axis=1).reshape(idx.shape)
        return jref._rows_per_head(planes[p], rows, False)

    idx, _ = jref._topk_indices(jref._quant_query(_j(q)), hm(planes[jref.NBITS - 1]),
                                hm(sign), plane_at, valid, rounds, k_max, surv)
    return np.asarray(idx)


# ---------------------------------------------------------------------------
# K3 bstc_matmul: the CUDA launch plan and the split's arithmetic
# ---------------------------------------------------------------------------

# (in_dim, out_dim) of phi4-mini's decode projections (chip_smoke.projection_shapes)
# and of the smoke config (d_model 96, kv_dim 32, d_ff 192, vocab 512)
K3_SERVE = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 200064)]
K3_SMOKE = [(96, 96), (96, 32), (96, 192), (192, 96), (96, 512)]


def _k3_plan(H, M, N, tile_k, n_enc=1, n_raw=6, x_vec=True, sms=132):
    return bstc_kernel.plan(M, H, N, tile_k, 4, sms, n_enc, n_raw, x_vec)


def _k3_items(p, M, H, tile_k):
    """How often the grid visits each (group row, tile), as the source
    indexes it: block (bx, rank c), warp w -> group row bx * R + w and the
    tiles [c * T, min(n_tiles, (c + 1) * T))."""
    G, n_tiles = M // 4, H // tile_k
    seen = np.zeros((G, n_tiles), np.int64)
    for c in range(p.grid[1]):
        tiles = slice(c * p.T, min(n_tiles, (c + 1) * p.T))
        g = np.arange(p.grid[0] * p.R)
        g = g[g < G]
        seen[g, tiles] += 1
    return seen * p.grid[2]  # every column block repeats the walk


class TestBstcMatmulPlan:
    """K3's CUDA launch geometry (``kernel.plan``), from static shapes alone."""

    SMS = 132  # an H100 SXM

    @pytest.mark.parametrize("H,M,tile_k", [(H, M, 512) for H, M in K3_SERVE]
                             + [(H, M, H) for H, M in K3_SMOKE] + [(3072, 3072, 3072),
                                                                    (8192, 3072, 8192)])
    @pytest.mark.parametrize("N", [1, 4, 8, 13])
    def test_every_item_has_one_warp(self, H, M, tile_k, N):
        p = _k3_plan(H, M, N, tile_k)
        assert p.grid[2] == -(-N // p.NB) and p.NB == min(8, 1 << (N - 1).bit_length())
        np.testing.assert_array_equal(_k3_items(p, M, H, tile_k), p.grid[2])
        n_tiles = H // tile_k
        assert p.C <= bstc_kernel.MAX_CLUSTER and p.grid[1] == p.C  # cluster dims (1, C, 1)
        assert (p.C - 1) * p.T < n_tiles <= p.C * p.T  # every rank owns a tile
        assert p.threads == 32 * p.R and p.chunks == -(-tile_k // 512)
        # shared memory: the block fits, and two blocks share an SM
        assert p.smem == bstc_kernel.smem_bytes(p.R, p.NB, p.stages, 1, 6) <= build.MAX_SMEM
        assert 2 * (p.smem + 1024) <= bstc_kernel.SM_SMEM
        steps = p.T * p.chunks
        assert p.stages == (1 if steps == 1 else 2 if p.chunks > 1 else p.stages)
        assert 1 <= p.stages <= min(steps, bstc_kernel.MAX_STAGES) or steps == 1

    @pytest.mark.parametrize("H,M", K3_SERVE)
    @pytest.mark.parametrize("N", [1, 4, 8, 13])
    def test_serve_shapes_fill_the_card(self, H, M, N):
        """Every serve shape puts a block on each SM, copies rows and x by
        16 bytes, and takes the cluster size of least modeled cost: waves of
        two blocks an SM, each T + 1 steps long."""
        p = _k3_plan(H, M, N, 512)
        blocks = p.grid[0] * p.grid[1] * p.grid[2]
        assert blocks >= self.SMS and p.R == 8
        assert p.width == 16 and p.x_width == 16
        n_tiles, rows = H // 512, p.grid[0] * p.grid[2]
        costs = {}
        for c in range(1, min(8, n_tiles) + 1):
            T = -(-n_tiles // c)
            costs.setdefault(-(-n_tiles // T), bstc_kernel.grid_cost(rows * -(-n_tiles // T), T,
                                                                     self.SMS))
        assert costs[p.C] == min(costs.values())
        assert p.C == min(c for c, v in costs.items() if v == costs[p.C])

    @pytest.mark.parametrize("H,M,C", [(3072, 3072, 2), (3072, 1024, 6), (3072, 8192, 1),
                                       (8192, 3072, 2), (3072, 200064, 1)])
    def test_decode_batch_takes_the_measured_cluster_size(self, H, M, C):
        """At N 4 the plan picks, at each serve shape, the cluster size that
        had the least device time on an H100 (PERF.md §6)."""
        assert _k3_plan(H, M, 4, 512).C == C

    def test_a_partial_wave_costs_a_whole_one(self):
        assert bstc_kernel.grid_cost(264, 2, 132) == 3
        assert bstc_kernel.grid_cost(288, 2, 132) == 6
        assert bstc_kernel.grid_cost(192, 3, 132) == 4

    @pytest.mark.parametrize("H,tile_k,width", [(96, 96, 4), (192, 192, 8), (3072, 512, 16),
                                                (3072, 3072, 16), (96, 32, 4), (1024, 8, 1),
                                                (1024, 64, 8), (8192, 512, 16)])
    def test_copy_widths_match_the_alignment(self, H, tile_k, width):
        """A row segment starts at a multiple of gcd(H/8, tile_k/8) bytes;
        the copy width is the largest of 16, 8, 4, 1 dividing it, and x is
        copied by 16 bytes only where it is an aligned f32 view and a step's
        bytes are even."""
        p = _k3_plan(H, 64, 4, tile_k)
        assert p.width == width
        assert math.gcd(H // 8, tile_k // 8) % p.width == 0
        assert p.x_width == (16 if (tile_k // 8) % 2 == 0 else 0)
        assert _k3_plan(H, 64, 4, tile_k, x_vec=False).x_width == 0

    def test_a_step_segment_fits_the_window(self):
        """A step reads at most 512 pattern slots, staged as the 16-byte
        chunks covering them from any start: at most WINDOW bytes."""
        for skew in range(16):
            for n in (1, 100, 511, 512):
                assert -(-(skew + n) // 16) * 16 <= bstc_kernel.WINDOW

    @pytest.mark.parametrize("x_layout", ["T", "T one column", "rows", "bf16", "pitch 3073",
                                          "offset 1"])
    def test_x_is_copied_by_16_bytes_only_where_it_can_be(self, x_layout):
        """16-byte copies of x need f32, unit stride along H and 16-byte
        aligned column starts (``wdot``'s ``a.T``); anything else is copied
        element by element."""
        a = torch.zeros(4, 3072)
        x = {"T": a.T, "T one column": a[:1].T, "rows": a.T.contiguous(),
             "bf16": a.T.to(torch.bfloat16), "pitch 3073": torch.zeros(4, 3073)[:, :3072].T,
             "offset 1": torch.zeros(4 * 3072 + 1)[1:].view(4, 3072).T}[x_layout]
        assert bstc_kernel.x_vectorizable(x) == x_layout.startswith("T")

    @pytest.mark.parametrize("kw,match", [
        (dict(m=8), "groups of m=4"),
        (dict(n_enc=2, n_raw=6), "at most 7 magnitude planes"),
        (dict(n_enc=3, n_raw=6), "at most 7 magnitude planes"),
        (dict(tile_k=12), "tile_k=12"),
        (dict(tile_k=1024), "tile_k=1024"),
        (dict(M=6), "M=6"),
        (dict(N=0), "N=0"),
    ])
    def test_refusals_raise(self, kw, match):
        args = dict(M=64, H=1536, N=4, tile_k=512, m=4, n_sms=132, n_enc=1, n_raw=6)
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            bstc_kernel.plan(args["M"], args["H"], args["N"], args["tile_k"], args["m"],
                             args["n_sms"], args["n_enc"], args["n_raw"])

    def test_wrapper_refuses_planes_above_six(self, monkeypatch):
        """Magnitude bytes pack planes 0..6 (|w| <= 127): operands coded
        with 8 planes are refused before any launch."""
        monkeypatch.setattr(bstc_ops, "sm_count", lambda device: 132)
        w = torch.from_numpy(np.random.default_rng(3).integers(-127, 128, (32, 64))
                             .astype(np.int8))
        ops = prepare_bstc_matmul_operands(w, torch.ones(32), nbits=8, tile_k=32)
        with pytest.raises(ValueError, match="magnitude planes"):
            bstc_ops._validate_cuda(ops, torch.zeros(64, 4))
        ok = prepare_bstc_matmul_operands(w, torch.ones(32), tile_k=32)
        assert isinstance(bstc_ops._validate_cuda(ok, torch.zeros(64, 4)), bstc_kernel.Plan)
        assert ok._desc is not None  # the plane table, built at the first launch


def _k3_transpose8(lo, hi):
    """``transpose8`` of ``csrc/bstc_matmul.cu`` in Python integers."""
    M = 0xFFFFFFFF

    def swap(x, k, m):
        t = (x ^ (x >> k)) & m
        return (x ^ t ^ (t << k)) & M

    lo, hi = swap(lo, 7, 0x00AA00AA), swap(hi, 7, 0x00AA00AA)
    lo, hi = swap(lo, 14, 0x0000CCCC), swap(hi, 14, 0x0000CCCC)
    t = (lo ^ (hi << 4)) & 0xF0F0F0F0
    return lo ^ t, hi ^ (t >> 4)


def _k3_split(ops, x):
    """K3's split on the CPU, in plain torch: per (group row, tile) f32
    partials, each coded plane's stream slot from ``offsets[e][g, kt]`` (or
    the previous 512-column step's run) plus the exclusive scan of the
    step's bitmap, read from the step's staged window ``[lo, hi)`` as the
    source clamps it; a rank's tiles summed in order, the ranks summed in
    rank order, the scale applied last."""
    from repro_torch.core.bitslice import unpack_bits

    M, H, m, tk = ops.M, ops.H, ops.m, ops.tile_k
    G, n_tiles, N = M // m, H // tk, x.shape[1]
    p = bstc_kernel.plan(M, H, N, tk, m, 132, len(ops.enc_planes), len(ops.raw_planes))
    mag = torch.zeros((M, H), dtype=torch.int64)
    for raw, plane in zip(ops.raw, ops.raw_planes):
        mag += unpack_bits(raw).long() << plane
    rows = torch.arange(G)[:, None]
    for e, plane in enumerate(ops.enc_planes):
        bitmap, offsets, patterns = ops.enc[3 * e:3 * e + 3]
        bits, cap = unpack_bits(bitmap).long(), patterns.shape[1]
        for kt in range(n_tiles):
            run = offsets[:, kt].long()
            for c0 in range(kt * tk, (kt + 1) * tk, 512):
                c1 = min(c0 + 512, (kt + 1) * tk)
                b = bits[:, c0:c1]
                start = run
                lo = start.clamp(0, cap)
                hi = torch.minimum(lo + (c1 - c0), torch.full_like(lo, cap))
                if c1 == (kt + 1) * tk and kt + 1 < n_tiles:
                    hi = torch.minimum(hi, offsets[:, kt + 1].long())
                hi = torch.maximum(hi, lo)
                slot = start[:, None] + b.cumsum(1) - b
                assert bool(((slot >= lo[:, None]) & (slot < hi[:, None]) | (b == 0)).all())
                slot = torch.minimum(torch.maximum(slot, lo[:, None]),
                                     (hi - 1).clamp(min=0)[:, None])
                pat = torch.where(b == 1, patterns.long()[rows, slot.clamp(0, cap - 1)], 0)
                for r in range(m):
                    mag[r::m, c0:c1] += ((pat >> r) & 1) << plane
                run = start + b.sum(1)
    w = ((1 - 2 * unpack_bits(ops.sign_bits).long()) * mag).float()
    xf = x.float()
    ranks = []
    for c in range(p.C):
        acc = torch.zeros((M, N))
        for kt in range(c * p.T, min(n_tiles, (c + 1) * p.T)):
            acc = acc + w[:, kt * tk:(kt + 1) * tk] @ xf[kt * tk:(kt + 1) * tk]
        ranks.append(acc)
    y = ranks[0]
    for part in ranks[1:]:
        y = y + part
    return y * ops.scale[:, None], w


class TestBstcMatmulArithmetic:
    """K3's arithmetic, emulated on the CPU, against its plain version
    within the tolerance the card holds the kernel to (``1e-5 * Σ|w·x| *
    scale`` a row: the products are exact in f32, the sums run in another
    order)."""

    def test_transpose_is_the_bit_transpose(self):
        rng = np.random.default_rng(4)
        for _ in range(500):
            bits = rng.integers(0, 2, (8, 8))  # bits[p, c]: plane p, column c
            rows = [int((bits[p] << np.arange(8)).sum()) for p in range(8)]
            lo = rows[0] | rows[1] << 8 | rows[2] << 16 | rows[3] << 24
            hi = rows[4] | rows[5] << 8 | rows[6] << 16 | rows[7] << 24
            a, b = _k3_transpose8(lo, hi)
            got = [(a >> 8 * c) & 0xFF for c in range(4)] + [(b >> 8 * c) & 0xFF for c in range(4)]
            assert got == [int((bits[:, c] << np.arange(8)).sum()) for c in range(8)]

    def test_sign_magnitude_bytes_become_exact_floats(self):
        """bits 0-6 = |w|, bit 7 = sign -> w + 128 a byte with no carry, and
        0x4B0000uu - (2^23 + 128) is w in f32, for every byte."""
        for word in range(0, 1 << 8):
            x = word * 0x01010101  # the same byte in all four lanes
            S = (x >> 7) & 0x01010101
            u = (((x & 0x7F7F7F7F) ^ (S * 0xFF) ^ 0x80808080) + S) & 0xFFFFFFFF
            for j in range(4):
                ub = (u >> 8 * j) & 0xFF
                f = np.array([0x4B000000 | ub], np.uint32).view(np.float32)[0]
                w = (word & 0x7F) * (-1 if word & 0x80 else 1)
                assert float(np.float32(f) - np.float32(8388736.0)) == w

    @pytest.mark.parametrize("tile_k", [32, 64, 512, 1024])
    @pytest.mark.parametrize("N", [1, 4, 13])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_split_matches_the_plain_version(self, tile_k, N, dtype):
        rng = np.random.default_rng(tile_k + N)
        M, H = 64, 1024
        w = rng.integers(-127, 128, (M, H))
        w = np.where(rng.random((M, H)) < 0.7, w // 16, w).astype(np.int8)
        ops = prepare_bstc_matmul_operands(_t(w), _t(rng.random(M).astype(np.float32) + 0.5),
                                           tile_k=tile_k)
        assert len(ops.enc_planes) >= 2
        x = _t(rng.standard_normal((H, N)).astype(np.float32)).to(dtype)
        got, dense = _k3_split(ops, x)
        np.testing.assert_array_equal(dense.numpy(), w.astype(np.float32))
        want = bstc_matmul_plain(ops, x, apply_scale=True)
        tol = 1e-5 * (dense.abs() @ x.float().abs()) * ops.scale[:, None]
        assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())


# ---------------------------------------------------------------------------
# K7 (brcr_gemm): the launch geometry and the kernel's arithmetic
# ---------------------------------------------------------------------------

# the four phi4-mini projection shapes (M, H): wq/wo, wk/wv, gate/up (the
# quickstart's), down
K7_SHAPES = [(3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192)]


def _k7_part_writes(m, NT):
    """The (local row, local column) each lane of each warp writes into a
    block's E @ Z part (``csrc/brcr_gemm.cu``, after the MAV): row tile r
    of warp w covers 16 / 2^m groups; at m 4 the lanes of groupID 0 write
    the 4 rows of the tile's group, at m 2 the lanes of bin 0 the 2 rows of
    groups ``g >> 2`` and ``2 + (g >> 2)``."""
    gpt = 16 >> m
    for w in range(brcr_kernel.WARPS):
        for r in range(brcr_kernel.ROW_TILES):
            tile_g = (w * brcr_kernel.ROW_TILES + r) * gpt
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for j in range(NT):
                    for e in range(2):
                        col = 8 * j + 2 * t + e
                        if m == 4 and g == 0:
                            for q in range(4):
                                yield tile_g * 4 + q, col
                        if m == 2 and (g & 3) == 0:
                            for grp in (g >> 2, (g + 8) >> 2):
                                for q in range(2):
                                    yield (tile_g + grp) * 2 + q, col


class TestBrcrGemmPlan:
    """The CUDA launch geometry of K7 (``kernel.plan`` and the source's
    index math), checked from static shapes alone: no card is needed."""

    SMS = 132  # an H100 SXM

    @pytest.mark.parametrize("m", [4, 2])
    @pytest.mark.parametrize("terms", [3, 1])
    @pytest.mark.parametrize("M,H,N", [(M, H, N) for M, H in K7_SHAPES for N in (1, 4, 16, 128)]
                             + [(1028, 3000, 13), (12, 20, 1), (4, 1, 3), (8, 129, 33)])
    def test_every_output_and_tile_has_one_owner(self, M, H, N, m, terms):
        p = brcr_kernel.plan(M, H, N, m, 14, self.SMS, terms)
        G = M // m
        assert p.GB == brcr_kernel.groups_per_block(m) and p.threads == 128
        assert p.NB == 8 * p.NT and p.terms == terms and p.K == brcr_kernel.TILE_K[m]
        # the grid fits: (column blocks, cluster, row blocks)
        assert p.grid == (-(-N // p.NB), p.C, -(-G // p.GB))
        assert p.grid[2] <= 65535 and p.grid[0] <= 2 ** 31 - 1
        # every H tile belongs to exactly one rank, and every rank owns one
        assert 1 <= p.C <= brcr_kernel.MAX_CLUSTER and p.n_tiles == -(-H // p.K)
        owned = [range(c * p.T, min(p.n_tiles, (c + 1) * p.T)) for c in range(p.C)]
        assert all(len(r) for r in owned)
        assert sorted(kt for r in owned for kt in r) == list(range(p.n_tiles))
        # shared memory fits a block, and the plan's residency an SM
        assert p.smem == brcr_kernel.smem_bytes(m, 14, p.NT, terms) <= build.MAX_SMEM
        per_sm = min(brcr_kernel.blocks_per_sm(p.NT, terms), brcr_kernel.SM_SMEM // (p.smem + 1024))
        assert per_sm >= 1 and p.resident == self.SMS * per_sm
        # every (row, column) is written once, by one block's one lane
        owners = np.zeros((p.grid[2] * p.GB * m, p.grid[0] * p.NB), np.int64)
        local = np.zeros((p.GB * m, p.NB), np.int64)
        for row, col in _k7_part_writes(m, p.NT):
            local[row, col] += 1
        np.testing.assert_array_equal(local, 1)
        for z in range(p.grid[2]):
            for x in range(p.grid[0]):
                owners[z * p.GB * m:(z + 1) * p.GB * m, x * p.NB:(x + 1) * p.NB] += local
        np.testing.assert_array_equal(owners[:M, :N], 1)
        # the cluster's sum: each rank adds its share of the part, once
        E = p.GB * m * p.NB
        per = -(-E // p.C)
        shares = [range(c * per, min(E, (c + 1) * per)) for c in range(p.C)]
        assert sorted(i for r in shares for i in r) == list(range(E))

    def test_quickstart_shape_fills_the_card(self):
        """8192 x 3072 at N 16: 256 row blocks x a cluster of 2 (12 tiles a
        rank), all resident at once on 132 SMs."""
        p = brcr_kernel.plan(8192, 3072, 16, 4, 14, self.SMS, 3)
        assert (p.C, p.T, p.grid, p.NB) == (2, 12, (1, 2, 256), 16)
        assert p.grid[0] * p.grid[1] * p.grid[2] <= p.resident
        assert p.grid[0] * p.grid[1] * p.grid[2] > self.SMS

    @pytest.mark.parametrize("H,align,width", [(3072, 16, 16), (3000, 16, 8), (3000, 4, 4),
                                               (20, 16, 4), (129, 16, 1), (3072, 2, 1)])
    def test_pattern_copies_stay_in_a_row(self, H, align, width):
        """The copy width divides H and the operand's alignment, so a copy
        lies wholly in a row or wholly past its end (zero-filled)."""
        w = brcr_kernel.copy_width(H, align)
        assert w == width and H % w == 0 and align % w == 0
        assert brcr_kernel.plan(64, H, 4, 4, 14, self.SMS, 3, align).width == width

    def test_plan_refuses_what_the_kernel_does_not_take(self):
        for args, match in [((64, 128, 4, 3, 14), "m in"), ((66, 128, 4, 4, 14), "multiple"),
                            ((64, 128, 4, 4, 17), "planes"), ((64, 0, 4, 4, 14), "H=0")]:
            with pytest.raises(ValueError, match=match):
                brcr_kernel.plan(*args, self.SMS, 3)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _k7_terms(x):
    """The kernel's bf16 terms of f32 x: hi, mid, lo."""
    hi = _bf16(x)
    mid = _bf16(x - hi)
    return hi, mid, _bf16(x - hi - mid)


def _k7_onehot_word(word, bin_, wp):
    """csrc/brcr_gemm.cu's one-hot of a lane's pattern word: 0x80808080 -
    (w ^ bin * 0x01010101), prmt's sign replication into bf16 halves (0x9988:
    bytes 0, 1; 0xBBAA: bytes 2, 3), AND the plane weight pair."""
    def prmt_sign(y, sel):
        out = 0
        for k in range(4):
            b = (y >> 8 * (((sel >> 4 * k) & 0xF) & 7)) & 0xFF
            out |= (0xFF if b & 0x80 else 0) << 8 * k
        return out

    y = (0x80808080 - (word ^ (bin_ * 0x01010101))) & 0xFFFFFFFF
    return prmt_sign(y, 0x9988) & wp, prmt_sign(y, 0xBBAA) & wp


def _k7_emulate(ops, x, C):
    """K7's data flow on the CPU in f32: per rank's H tiles, per tile one
    accumulator from zero over every plane's one-hot (entries +-2^p) times
    each bf16 term of x (hi alone where mid is 0 over the tile), added to the
    rank's running sum; E @ Z of each rank; the ranks added in rank order.
    Returns (out, the largest |partial sum| of each (group, bin, column)
    over the run, the sum of the |terms| each bin gathered)."""
    P, G, H = ops.group_idx.shape
    m, K = ops.m, brcr_kernel.TILE_K[ops.m]
    n_tiles = -(-H // K)
    T = -(-n_tiles // C)
    xf = x.to(torch.float32)
    terms = _k7_terms(xf) if x.dtype == torch.float32 else (xf,)
    bins = torch.arange(2 ** m, dtype=ops.group_idx.dtype)
    e = ((torch.arange(2 ** m)[None] >> torch.arange(m)[:, None]) & 1).to(torch.float32)
    out = torch.zeros(G, m, x.shape[1])
    peak = torch.zeros(G, 2 ** m, x.shape[1])
    gathered = torch.zeros(G, 2 ** m, x.shape[1])
    for c in range(C):
        acc = torch.zeros(G, 2 ** m, x.shape[1])
        for kt in range(c * T, min(n_tiles, (c + 1) * T)):
            cols = slice(kt * K, min(H, (kt + 1) * K))
            use = terms if len(terms) == 1 or bool((terms[1][cols] != 0).any()) else terms[:1]
            fresh = torch.zeros_like(acc)
            for p in range(P):
                onehot = (ops.group_idx[p, :, cols, None] == bins).to(torch.float32)
                a = onehot * ops.plane_weights[p]  # (G, h, bins), +-2^p
                for t in use:
                    fresh = fresh + torch.einsum("ghc,hn->gcn", a, t[cols])
                    peak = torch.maximum(peak, (acc + fresh).abs())
                    gathered += torch.einsum("ghc,hn->gcn", a.abs(), t[cols].abs())
            acc = acc + fresh
        out = out + torch.einsum("jc,gcn->gjn", e, acc)
    return out.reshape(G * m, -1), peak, gathered


class TestBrcrGemmArithmetic:
    """K7's arithmetic, emulated in torch on the CPU, against the plain
    version within the tolerance the card holds the kernel to: bit-equal
    for integer x (every partial sum an integer below 2^24), within
    ``1e-5 * Σ|w·x|`` for float x."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_three_terms_sum_back_to_x(self, seed):
        """hi + mid + lo is x exactly, for f32 over a wide range of
        exponents and for integers of up to 24 bits; hi + mid alone misses
        integers of 17 or more significant bits."""
        rng = np.random.default_rng(seed)
        f = rng.standard_normal(100_000) * np.exp2(rng.integers(-60, 60, 100_000))
        ints = rng.integers(-(2 ** 24), 2 ** 24 + 1, 100_000)
        for arr in (f, ints):
            x = torch.from_numpy(arr.astype(np.float32))
            hi, mid, lo = _k7_terms(x)
            total = hi.double() + mid.double() + lo.double()
            assert torch.equal(total, x.double())
            assert torch.equal(hi + mid + lo, x)
        wide = torch.from_numpy(np.arange(2 ** 16, 2 ** 20, 977).astype(np.float32))
        hi, mid, _ = _k7_terms(wide)
        assert not torch.equal(hi + mid, wide)

    def test_one_hot_bytes_are_the_plane_weight_at_the_lanes_bin(self):
        """The byte trick gives +-2^p in the bf16 half of each column whose
        pattern is the lane's bin, and 0 elsewhere, for every pattern and
        bin (m 4) and every plane weight the format uses."""
        for p in range(7):
            for sign in (1, -1):
                wb = int(torch.tensor([sign * 2.0 ** p]).to(torch.bfloat16).view(torch.int16)) \
                    & 0xFFFF
                wp = wb | (wb << 16)
                for bin_ in range(16):
                    for v in range(16):
                        word = v | ((v + 1) % 16) << 8 | ((v + 7) % 16) << 16 | (15 - v) << 24
                        lo, hi = _k7_onehot_word(word, bin_, wp)
                        vals = [v, (v + 1) % 16, (v + 7) % 16, 15 - v]
                        want = [wb if u == bin_ else 0 for u in vals]
                        assert [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16] == want

    def test_fragments_follow_the_mma_layout(self):
        """The mma's A (16 bins x k 16) and B (k 16 x 8) fragments as the
        lanes build them -- k 2t+e and 2t+8+e are H columns 4t+e and
        4t+2+e -- multiply to the one-hot product of the 16 columns."""
        rng = np.random.default_rng(3)
        for m in (4, 2):
            pat = rng.integers(0, 2 ** m, (16 >> m, 16))  # the tile's groups x 16 columns
            xs = rng.standard_normal((16, 8)).astype(np.float32)
            A, B = np.zeros((16, 16)), np.zeros((16, 8))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for row in (g, g + 8):
                    grp, bin_ = row >> m, row & (2 ** m - 1)
                    for e in range(2):
                        A[row, 2 * t + e] = pat[grp, 4 * t + e] == bin_
                        A[row, 2 * t + 8 + e] = pat[grp, 4 * t + 2 + e] == bin_
                for e in range(2):
                    B[2 * t + e, g] = xs[4 * t + e, g]
                    B[2 * t + 8 + e, g] = xs[4 * t + 2 + e, g]
            want = np.zeros((16, 8))
            for row in range(16):
                grp, bin_ = row >> m, row & (2 ** m - 1)
                want[row] = (pat[grp] == bin_).astype(np.float64) @ xs
            np.testing.assert_allclose(A @ B, want, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("m", [4, 2])
    @pytest.mark.parametrize("C", [1, 3])
    @pytest.mark.parametrize("M,H,N", [(48, 320, 5), (20, 200, 9)])
    def test_one_accumulator_is_the_plain_version(self, m, C, M, H, N):
        """All planes into one Z, tile accumulators added in f32, E @ Z a
        rank, ranks in order: bit-equal to the plain version for integer x
        (in f32, and of 17 to 20 bits on a sparse weight), within
        ``1e-5 * Σ|w·x|`` for f32 and bf16 Gaussian x; and no bin's partial
        sum, nor the |terms| it gathers, exceeds a row's ``Σ|w·x|`` (times
        1 + 2^-7 for the terms of wide integers)."""
        rng = np.random.default_rng(M + H + N + m + C)
        w = torch.from_numpy(rng.integers(-127, 128, (M, H)).astype(np.int8))
        ops = prepare_brcr_operands(w, m)
        cases = [(torch.from_numpy(rng.integers(-50, 50, (H, N)).astype(np.float32)), True)]
        # three non-zeros a row, each within a third of 2^23 against its column of x
        xw = rng.integers(2 ** 16, 2 ** 20, (H, N)) * rng.choice([-1, 1], (H, N))
        sparse = np.zeros((M, H), np.int64)
        for i in range(M):
            cols = rng.choice(H, 3, replace=False)
            cap = (2 ** 23) // (3 * np.abs(xw[cols]).max(1))
            sparse[i, cols] = np.clip(rng.integers(-127, 128, 3), -cap, cap)
        for x, exact in cases + [
                (torch.from_numpy(xw.astype(np.float32)), True),
                (torch.from_numpy(rng.standard_normal((H, N)).astype(np.float32)), False),
                (torch.from_numpy(rng.standard_normal((H, N))).to(torch.bfloat16), False)]:
            ww = w if x.abs().max() < 2 ** 16 else torch.from_numpy(sparse.astype(np.int8))
            o = ops if ww is w else prepare_brcr_operands(ww, m)
            got, peak, gathered = _k7_emulate(o, x, C)
            want = brcr_gemm_ref(o.group_idx, o.plane_weights, x, m)
            row = ww.abs().to(torch.float64) @ x.to(torch.float64).abs()  # (M, N)
            if exact:
                assert float(row.max()) < 2 ** 24
                assert torch.equal(got, want)
            else:
                assert bool(((got - want).abs() <= 1e-5 * row).all())
            # bin c of group g is bounded by any of its rows j (bit j of c)
            G = M // m
            rows = row.reshape(G, m, N)
            for c in range(1, 2 ** m):
                bound = torch.stack([rows[:, j] for j in range(m) if c >> j & 1]).amin(0)
                assert bool((peak[:, c] <= bound * (1 + 2 ** -7)).all())
                assert bool((gathered[:, c] <= bound * (1 + 2 ** -7)).all())


# --------------------------------------------------------------------------
# K4 (bstc_decode): the plan and a CPU model of the kernel's addressing
# --------------------------------------------------------------------------


def _nibble_table():
    """bstc_decode.cu's NibbleTable: per 4-bit nibble, the rank selector
    and the byte mask of its set columns."""
    out = []
    for n in range(16):
        sel = mask = r = 0
        for c in range(4):
            sel |= r << (4 * c)
            if (n >> c) & 1:
                mask |= 0xFF << (8 * c)
                r += 1
        out.append((sel, mask))
    return out


def _byte_perm(x, y, sel):
    """CUDA ``__byte_perm(x, y, sel)`` for selector nibbles below 8."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((sel >> (4 * c)) & 7))) & 0xFF) << (8 * c) for c in range(4))


def _funnel_r(lo, hi, sh):
    return (((hi << 32) | lo) >> (sh & 31)) & 0xFFFFFFFF


def _k4_model(bitmap, offsets, patterns, H, geo, rng, paths=None):
    """``bstc_decode.cu`` pass by pass on the CPU: a warp per (row,
    segment of ``geo.tps`` tiles) starting at its tile offset, 32 lanes of
    16 bitmap bytes a pass with an exclusive scan, the carried total across
    passes, and per lane the fast gather (three aligned words, funnel
    shifts, byte permutes with the nibble table, masks) where every slot is
    in range, else the clamped column-by-column gather.  The shared row's
    padding past ``cap`` is random junk, as uninitialised shared memory.
    ``paths`` (a list) collects which gather each lane pass took."""
    G, cap = patterns.shape
    tile_k = H // offsets.shape[1]
    table = _nibble_table()
    out = np.full((G, H), 0xEE, np.uint8)  # every column must be written
    for g in range(G):
        s = np.concatenate([patterns[g], rng.integers(0, 256, geo.cap_s - cap, dtype=np.uint8)])
        s32 = s.view("<u4").astype(np.int64)
        for seg in range(geo.NS):
            c0, c1 = seg * geo.tps * tile_k, min((seg + 1) * geo.tps * tile_k, H)
            run = int(offsets[g, seg * geo.tps])
            for cs in range(c0, c1, decode_kernel.STRIDE):
                lanes = []
                for lane in range(32):
                    b = cs // 8 + 16 * lane
                    chunk = bitmap[g, b:min(b + 16, c1 // 8)]
                    chunk = np.concatenate([chunk, np.zeros(16 - len(chunk), np.uint8)])
                    lanes.append([int(v) for v in chunk.view("<u4")])
                counts = [sum(bin(v).count("1") for v in w) for w in lanes]
                excl = np.concatenate([[0], np.cumsum(counts)[:-1]])
                for lane, w in enumerate(lanes):
                    col = cs + 128 * lane
                    if col >= c1:
                        continue
                    p = run + int(excl[lane])
                    fast = p >= 0 and p + counts[lane] <= cap
                    if paths is not None:
                        paths.append("fast" if fast else "clamped")
                    words = []
                    for k in range(4):
                        for i in range(4):
                            bm = (w[k] >> (8 * i)) & 0xFF
                            if fast:
                                a, sh = p >> 2, (p & 3) * 8
                                lo = _funnel_r(s32[a], s32[a + 1], sh)
                                hi = _funnel_r(s32[a + 1], s32[a + 2], sh)
                                (t0, m0), (t1, m1) = table[bm & 15], table[bm >> 4]
                                n0 = bin(bm & 15).count("1")
                                words += [_byte_perm(lo, 0, t0) & m0,
                                          _byte_perm(lo, hi, t1 + n0 * 0x1111) & m1]
                                p += bin(bm).count("1")
                            else:
                                for q in range(2):
                                    word = 0
                                    for c in range(4):
                                        bit = (bm >> (4 * q + c)) & 1
                                        word |= (int(s[min(max(p, 0), cap - 1)]) * bit) << (8 * c)
                                        p += bit
                                    words.append(word)
                    vals = np.asarray(words, "<u4").view(np.uint8)
                    n = min(128, c1 - col)
                    out[g, col:col + n] = vals[:n]
                run += sum(counts)
    return out


def _coded_plane(rng, G, H, density, tile_k, m=4, all_rows=()):
    """Prepared operands of a random (G*m, H) bit plane (rows listed in
    ``all_rows`` are all ones, the last group row all zeros)."""
    plane = (rng.random((G * m, H)) < density).astype(np.uint8)
    for r in all_rows:
        plane[r * m:(r + 1) * m] = 1
    plane[(G - 1) * m:] = 0
    t = prepare_encoded_plane(tbstc.encode_plane(torch.from_numpy(plane), m), tile_k=tile_k)
    return plane, t


class TestBstcDecodePlan:
    def test_rows_a_block_fill_the_card(self):
        wq = decode_kernel.plan(768, 3072, 3072, 1064, 132)
        assert (wq.R, wq.WR, wq.NS, wq.blocks, wq.threads) == (4, 1, 1, 192, 128)
        assert wq.cap_s == 1088 and wq.smem == 4 * 1088 and wq.copy == 8
        gate = decode_kernel.plan(2048, 3072, 3072, 1056, 132)
        assert (gate.R, gate.blocks, gate.threads, gate.copy) == (8, 256, 256, 16)
        down = decode_kernel.plan(768, 8192, 8192, 6384, 132)
        assert (down.R, down.NS, down.tps, down.blocks) == (4, 1, 1, 192)
        small = decode_kernel.plan(16, 512, 128, 40, 132)
        assert (small.R, small.blocks, small.tps, small.NS) == (1, 16, 4, 1)

    def test_segments_follow_the_tiles(self):
        g = decode_kernel.plan(768, 8192, 512, 4000, 132)
        assert (g.tps, g.NS, g.WR, g.R) == (8, 2, 2, 4)  # 4096 columns a segment
        wide = decode_kernel.plan(16, 131072, 512, 16000, 132)
        assert (wide.NS, wide.WR, wide.R) == (32, 16, 1)  # warps loop over segments
        one = decode_kernel.plan(768, 3072, 512, 2000, 132)
        assert (one.tps, one.NS) == (6, 1)

    def test_copy_width_follows_cap_and_alignment(self):
        assert decode_kernel.plan(64, 512, 512, 48, 132, 16).copy == 16
        assert decode_kernel.plan(64, 512, 512, 48, 132, 8).copy == 8
        assert decode_kernel.plan(64, 512, 512, 44, 132, 16).copy == 4
        assert decode_kernel.plan(64, 512, 512, 45, 132, 16).copy == 1

    def test_refuses_a_stream_over_shared_memory(self):
        cap = build.MAX_SMEM - 16
        assert decode_kernel.plan(8, 8, 8, cap, 132).smem == build.MAX_SMEM
        with pytest.raises(ValueError, match=f"cap={build.MAX_SMEM}"):
            decode_kernel.plan(8, 8, 8, cap + 1, 132)

    def test_wrapper_plans_from_the_operands(self, monkeypatch):
        rng = np.random.default_rng(0)
        _, t = _coded_plane(rng, 8, 256, 0.3, 128)
        monkeypatch.setattr(decode_ops, "sm_count", lambda d: 132)
        geo = decode_ops._validate_cuda(t)
        assert geo == decode_kernel.plan(8, 256, 128, t.patterns.shape[1], 132,
                                         decode_kernel.alignment(t.patterns))
        assert decode_kernel.wide_rows(t.bitmap, torch.empty(8, 256, dtype=torch.uint8),
                                       256, 128)
        assert not decode_kernel.wide_rows(t.bitmap, torch.empty(8, 256, dtype=torch.uint8),
                                           256, 64)
        with pytest.raises(ValueError, match="contiguous"):
            decode_ops._validate_cuda(t._replace(patterns=t.patterns.T.contiguous().T))


class TestBstcDecodeModel:
    @pytest.mark.parametrize("H,tile_k", [(3072, 3072), (8192, 8192), (8192, 512),
                                          (3072, 512), (320, 64), (200, 40)])
    def test_model_matches_plain_and_pallas(self, H, tile_k):
        rng = np.random.default_rng(H + tile_k)
        G = 8
        plane, t = _coded_plane(rng, G, H, 0.25, tile_k, all_rows=(1,))
        geo = decode_kernel.plan(G, H, tile_k, t.patterns.shape[1], 132)
        want = decode_patterns_ref(bitslice.unpack_bits(t.bitmap), t.patterns).numpy()
        got = _k4_model(t.bitmap.numpy(), t.tile_offsets.numpy(), t.patterns.numpy(), H, geo,
                        rng)
        np.testing.assert_array_equal(got, want)
        assert (want[G - 1] == 0).all() and (want[1] == 15).all()  # all-zero / all-one rows
        if H % tile_k == 0 and tile_k % 8 == 0 and H <= 3072:
            jops = jax_prepare_plane(jbstc.encode_plane(plane, 4), tile_k=tile_k)
            np.testing.assert_array_equal(got, np.asarray(jax_decode(jops, mode="interpret")))

    @pytest.mark.parametrize("cut", [1, 7, 33])
    def test_model_clamps_slots_past_the_cap(self, cut):
        """Patterns narrower than a row's set columns: slots past the cap
        clamp to cap - 1 (the plain version's rule), through the clamped
        gather of the lanes that reach them."""
        rng = np.random.default_rng(cut)
        H = 1024
        _, t = _coded_plane(rng, 4, H, 0.4, H)
        cap = t.patterns.shape[1] - cut
        patterns = t.patterns[:, :cap].contiguous()
        geo = decode_kernel.plan(4, H, H, cap, 132)
        want = decode_patterns_ref(bitslice.unpack_bits(t.bitmap), patterns).numpy()
        paths = []
        got = _k4_model(t.bitmap.numpy(), t.tile_offsets.numpy(), patterns.numpy(), H, geo, rng,
                        paths)
        np.testing.assert_array_equal(got, want)
        assert {"fast", "clamped"} <= set(paths)

    def test_nibble_table_places_every_byte(self):
        """Each of the 256 bitmap bytes: the two permutes put the k-th set
        column's pattern at its column and zero elsewhere, from any byte
        offset of the stream."""
        table = _nibble_table()
        rng = np.random.default_rng(1)
        stream = rng.integers(1, 256, 64, dtype=np.uint8)
        s32 = stream.view("<u4").astype(np.int64)
        for bm in range(256):
            for p in range(0, 20):
                a, sh = p >> 2, (p & 3) * 8
                lo, hi = _funnel_r(s32[a], s32[a + 1], sh), _funnel_r(s32[a + 1], s32[a + 2], sh)
                (t0, m0), (t1, m1) = table[bm & 15], table[bm >> 4]
                n0 = bin(bm & 15).count("1")
                got = np.asarray([_byte_perm(lo, 0, t0) & m0,
                                  _byte_perm(lo, hi, t1 + n0 * 0x1111) & m1], "<u4").view(np.uint8)
                want, k = np.zeros(8, np.uint8), p
                for c in range(8):
                    if (bm >> c) & 1:
                        want[c], k = stream[k], k + 1
                np.testing.assert_array_equal(got, want, err_msg=f"byte {bm:08b} at slot {p}")
