"""The port's BGPP predictor layer against the JAX package's: one scoring
round (the ``bgpp_score`` kernel's plain version), ``bgpp_predict`` and its
stats, the batched GQA predictor, the top-k helpers, the formal-compute
attends and the ``bgpp_sparse_attention`` walkthrough.

The same numpy-seeded keys and queries go to both sides.  The JAX scoring
kernel runs in interpret mode, as its own tests run it.

Tolerances:
  * scores, alive masks, est scores, every ``BGPPStats`` field, indices
    and masks: bit-exact (integer partial scores times one float32 scale,
    thresholds in the reference's float32 arithmetic).  Top-k ties, which
    integer scores make common, come out in index order on both sides,
    ``-inf`` lanes of dead keys included.
  * ``gather_attend`` / ``decode_attend``: 1e-6 absolute on outputs of
    order 1 (float32 softmax and sums in another order).
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

from repro.core import attention as jatt
from repro.core import bgpp as jbgpp
from repro.core import topk as jtopk
from repro.kernels.bgpp_score import bgpp_score_round as jax_score
from repro.kernels.bgpp_score.ref import bgpp_score_round_ref as jax_score_ref

from repro_torch.core import attention as tatt
from repro_torch.core import bgpp as tbgpp
from repro_torch.core import bitslice as tbit
from repro_torch.core import topk as ttopk
from repro_torch.examples import bgpp_sparse_attention as tbsa
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import build
from repro_torch.kernels.bgpp_score import bgpp_score_heads, bgpp_score_round
from repro_torch.kernels.bgpp_score import kernel as score_kernel
from repro_torch.kernels.bgpp_score.ref import bgpp_score_heads_ref, bgpp_score_round_ref

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _keys(rng, shape, sigma=30):
    """int keys -> (k, sign (..., D), planes (7, ..., D)) as numpy."""
    k = np.clip(np.round(rng.normal(size=shape) * sigma), -127, 127).astype(np.int32)
    mag = np.abs(k).astype(np.uint8)
    return k, (k < 0).astype(np.uint8), np.stack([(mag >> p) & 1 for p in range(7)], 0)


class TestScoreRound:
    @pytest.mark.parametrize("S,D,dead", [(512, 32, True), (300, 16, True), (77, 24, False),
                                          (256, 128, True)])
    def test_plain_matches_jax_kernel(self, S, D, dead):
        """Bit-exact against the Pallas kernel in interpret mode: dead
        tiles (whole 256-key tiles with no alive key), dead keys in live
        tiles, S not a multiple of the reference's tile."""
        rng = np.random.default_rng(S + D)
        plane = rng.integers(0, 2, size=(S, D)).astype(np.uint8)
        sign = rng.integers(0, 2, size=(S, D)).astype(np.uint8)
        q = rng.integers(-120, 121, size=(D,)).astype(np.int32)
        alive = rng.random(S) < 0.3
        if dead:
            alive[:256] = False
        pp, sp = tbit.pack_bits(_t(plane)), tbit.pack_bits(_t(sign))
        want = jax_score(jnp.asarray(q), jnp.asarray(pp.numpy()), jnp.asarray(sp.numpy()),
                         jnp.asarray(alive), interpret=True)
        reset_launches()
        got = bgpp_score_round(_t(q), pp, sp, _t(alive))
        _eq(got, want)
        _eq(bgpp_score_round_ref(_t(q), _t(plane), _t(sign), _t(alive)),
            jax_score_ref(jnp.asarray(q), jnp.asarray(plane), jnp.asarray(sign),
                          jnp.asarray(alive)))
        assert got.dtype == torch.int32 and LAUNCHES["bgpp_score"] == 0

    def test_heads_read_their_kv_head(self):
        """The batch form: query head h of batch b scores kv head h // g's
        plane, read through a strided view of the stacked planes."""
        rng = np.random.default_rng(1)
        B, S, Hk, g, D = 2, 40, 2, 3, 16
        planes = rng.integers(0, 256, size=(7, B, S, Hk, D // 8)).astype(np.uint8)
        sign = rng.integers(0, 256, size=(B, S, Hk, D // 8)).astype(np.uint8)
        q = rng.integers(-100, 100, size=(B, Hk * g, D)).astype(np.int32)
        alive = rng.random((B, Hk * g, S)) < 0.5
        got = bgpp_score_heads(_t(q), _t(planes)[5], _t(sign), _t(alive))
        for b in range(B):
            for h in range(Hk * g):
                want = jax_score(jnp.asarray(q[b, h]), jnp.asarray(planes[5, b, :, h // g]),
                                 jnp.asarray(sign[b, :, h // g]), jnp.asarray(alive[b, h]),
                                 interpret=True)
                _eq(got[b, h], want)

    def test_rejects_bad_operands_and_devices(self):
        q = torch.zeros(1, 2, 16, dtype=torch.int32)
        pl = torch.zeros(1, 8, 1, 2, dtype=torch.uint8)
        alive = torch.ones(1, 2, 8, dtype=torch.bool)
        with pytest.raises(ValueError, match="alive"):
            bgpp_score_heads(q, pl, pl, alive[..., :4])
        with pytest.raises(ValueError, match="match"):
            bgpp_score_heads(q, pl[..., :1], pl[..., :1], alive)
        meta = lambda t: t.to("meta")
        reset_launches()
        with pytest.raises(ValueError, match="no kernel for device"):
            bgpp_score_heads(meta(q), meta(pl), meta(pl), meta(alive))
        assert LAUNCHES["bgpp_score"] == 0


def _words(bits):
    """``(..., D)`` {0,1} -> ``(..., W)`` little-endian uint32 words, bit d
    of word w holding dim 32 w + d (D padded with zeros to whole words)."""
    W = -(-bits.shape[-1] // 32)
    pad = np.zeros(bits.shape[:-1] + (32 * W - bits.shape[-1],), np.uint8)
    packed = np.packbits(np.concatenate([bits.astype(np.uint8), pad], -1), -1,
                         bitorder="little")
    return np.ascontiguousarray(packed).view("<u4")


def _k6_model(q, plane_packed, sign_packed, alive, plan, junk):
    """``bgpp_score.cu`` on the CPU, block by block of ``plan``: the
    group's alive bytes, a dead tile written as zeros, only keys some row
    of the group needs staged (the others hold ``junk`` words), each row's
    q split into a sign mask and its used magnitude planes, and every
    32-dim word adding ``2^j (popc(M_j & b) - 2 popc(M_j & b & (s ^ sq)))``
    modulo 2^32, words interleaved over ``LPK`` lanes."""
    B, Hq, D = q.shape
    _, S, Hk, Dp = plane_packed.shape
    g, WP, LPK, TS = Hq // Hk, plan.WP, plan.LPK, plan.TS
    unpack = lambda p: np.unpackbits(p, -1, bitorder="little")
    mag = np.abs(q.astype(np.int64)).astype(np.uint32)  # |INT_MIN| = 2^31
    sq = _words(q < 0)
    out = np.full((B, Hq, S), 12345, np.int64)
    seen = np.zeros((B, S // TS + 1, Hk), np.int64)
    for blk in range(plan.blocks):  # the source's block -> (slot, tile, kv head)
        h, tile, b = blk % Hk, (blk // Hk) % plan.tiles, blk // (Hk * plan.tiles)
        seen[b, tile, h] += 1
        s0, rows = tile * TS, slice(h * g, (h + 1) * g)
        n = min(TS, S - s0)
        alv = alive[b, rows, s0:s0 + n]
        if not alv.any():
            out[b, rows, s0:s0 + n] = 0
            continue
        kb, ks = junk[0][:n].copy(), junk[1][:n].copy()
        live = alv.any(0)
        kb[live] = _words(unpack(plane_packed[b, s0:s0 + n, h]))[live]
        ks[live] = _words(unpack(sign_packed[b, s0:s0 + n, h]))[live]
        for gi, r in enumerate(range(h * g, (h + 1) * g)):
            used = np.bitwise_or.reduce(mag[b, r])
            acc = np.zeros(n, np.uint64)
            for wl in range(LPK):
                for w in range(wl, WP, LPK):
                    if w >= sq.shape[-1]:  # words past D: the query's planes are 0
                        continue
                    x = ks[:, w] ^ sq[b, r, w]
                    for j in range(32):
                        if used >> j & 1:
                            m = _words((mag[b, r] >> j) & 1)[w]
                            y = m & kb[:, w]
                            c = (np.bitwise_count(y).astype(np.int64)
                                 - 2 * np.bitwise_count(y & x).astype(np.int64))
                            acc = (acc + (c.astype(np.uint64) << np.uint64(j))) % 2 ** 32
            out[b, r, s0:s0 + n] = np.where(alv[gi], acc.astype(np.uint32).view(np.int32), 0)
    assert (seen[:, :plan.tiles] == 1).all()  # every (slot, tile, kv head) once
    return out.astype(np.int32)


def _k6_operands(rng, B, Hk, g, S, D, q_kind, alive_kind):
    """Seeded K6 operands (numpy): q of ``q_kind`` (``full``: int32 over
    its whole range with INT_MIN and INT_MAX placed; ``msb``: the
    predictor's 4-bit truncation of int8 codes), packed plane and sign
    rows, and alive of ``alive_kind`` (``mixed`` has whole dead 32-key
    tiles and dead keys in live ones)."""
    Hq, Dp = Hk * g, D // 8
    if q_kind == "full":
        q = rng.integers(-2 ** 31, 2 ** 31, size=(B, Hq, D), dtype=np.int64).astype(np.int32)
        q[0, 0, 0], q[-1, -1, -1] = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    else:
        c = rng.integers(-127, 128, size=(B, Hq, D))
        q = (np.sign(c) * ((np.abs(c) >> 3) << 3)).astype(np.int32)
    plane = rng.integers(0, 256, size=(B, S, Hk, Dp)).astype(np.uint8)
    sign = rng.integers(0, 256, size=(B, S, Hk, Dp)).astype(np.uint8)
    alive = {"dead": np.zeros((B, Hq, S), bool), "live": np.ones((B, Hq, S), bool),
             "mixed": rng.random((B, Hq, S)) < 0.3}[alive_kind]
    if alive_kind == "mixed":
        alive[:, :, :32] = False
        alive[:, :, 64:96] = False
    return q, plane, sign, alive


class TestScoreWordArithmetic:
    """The redesigned kernel's arithmetic and block walk (a CPU model of
    the source) is bit-exact against the plain version and the JAX Pallas
    kernel in interpret mode, for int32 q over its whole range and for the
    predictor's MSB-truncated q."""

    SMS = 132  # an H100 SXM

    @pytest.mark.parametrize("D", [16, 24, 128])
    @pytest.mark.parametrize("q_kind", ["full", "msb"])
    @pytest.mark.parametrize("alive_kind", ["mixed", "dead", "live"])
    def test_model_matches_plain_and_jax(self, D, q_kind, alive_kind):
        rng = np.random.default_rng(7 * D + len(q_kind) + len(alive_kind))
        B, Hk, g, S = 2, 2, 3, 130
        q, plane, sign, alive = _k6_operands(rng, B, Hk, g, S, D, q_kind, alive_kind)
        plan = score_kernel.plan(B, Hk, g, S, D, self.SMS)
        junk = rng.integers(0, 2 ** 32, size=(2, plan.TS, plan.WP), dtype=np.uint64)
        got = _k6_model(q, plane, sign, alive, plan, junk.astype(np.uint32))
        want = bgpp_score_heads_ref(_t(q), _t(plane), _t(sign), _t(alive)).numpy()
        _eq(got, want)
        for b, h in ((0, 0), (B - 1, Hk * g - 1)):  # the Pallas kernel, one query a call
            jw = jax_score(jnp.asarray(q[b, h]), jnp.asarray(plane[b, :, h // g]),
                           jnp.asarray(sign[b, :, h // g]), jnp.asarray(alive[b, h]),
                           interpret=True)
            _eq(got[b, h], jw)
        if alive_kind == "dead":
            assert not got.any()


class TestScorePlan:
    SMS = 132  # an H100 SXM

    @pytest.mark.parametrize("B,Hk,g,S,D,blocks,TS", [
        (1, 1, 1, 4096, 128, 128, 32),  # the walkthrough: four times today's 32 blocks
        (4, 8, 3, 1024, 128, 1024, 32),  # the decode geometry
        (4, 8, 3, 32768, 128, 4096, 256),  # its long context
        (70000, 1, 1, 100, 128, 70000, 256),  # 70,000 query rows, past a 65,535 grid.y
        (1, 2, 4, 77, 24, 2, 128),  # D 24: one word a row, one lane a key
        (2, 1, 8, 300, 256, 20, 32),  # D 256: two words a lane
    ])
    def test_grid_and_tiles_cover_every_key_once(self, B, Hk, g, S, D, blocks, TS):
        p = score_kernel.plan(B, Hk, g, S, D, self.SMS)
        assert (p.blocks, p.TS) == (blocks, TS)
        W = -(-D // 32)
        assert p.WP >= W and p.WP & (p.WP - 1) == 0 and p.LPK == min(p.WP, 4)
        assert p.WP % p.LPK == 0 and p.TS % (score_kernel.THREADS // p.LPK) == 0
        assert p.tiles * p.TS >= S > (p.tiles - 1) * p.TS
        assert p.blocks == B * p.tiles * Hk
        assert p.smem == score_kernel.smem_bytes(g, p.WP, p.TS) <= build.MAX_SMEM
        ids = np.arange(p.blocks)  # the source's block -> (slot, tile, kv head)
        cells = np.stack([ids // (Hk * p.tiles), (ids // Hk) % p.tiles, ids % Hk], 1)
        assert len(np.unique(cells, axis=0)) == p.blocks
        assert (cells.max(0) == [B - 1, p.tiles - 1, Hk - 1]).all()

    def test_a_group_past_shared_memory_names_the_cap(self):
        p = score_kernel.plan(1, 1, 64, 4096, 128, self.SMS)
        assert p.TS == 32 and p.smem <= build.MAX_SMEM  # fewer passes first
        with pytest.raises(ValueError, match=r"the cap at D=4096 is g=\d+"):
            score_kernel.plan(1, 1, 64, 4096, 4096, self.SMS)

    def test_the_kernel_stages_whole_chunks_only_when_rows_allow(self):
        planes = torch.zeros(7, 2, 40, 3, 16, dtype=torch.uint8)
        assert score_kernel.wide_rows(planes[5], planes[6])  # batch, token, head strides
        assert not score_kernel.wide_rows(planes[5, ..., :8], planes[6, ..., :8])
        odd = torch.zeros(2 * 40 * 3 * 3, dtype=torch.uint8).view(2, 40, 3, 3)
        assert not score_kernel.wide_rows(odd, odd)  # D 24: byte by byte


def _stats_equal(got, want):
    for a, b in zip(got, want):
        _eq(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


class TestPredict:
    @pytest.mark.parametrize("cfg", [
        dict(rounds=4, alpha=0.55),
        dict(rounds=3, alpha=0.4, min_keys=40),
        dict(rounds=5, alpha_schedule=(1.2, 0.8, 0.5)),
        dict(rounds=7, alpha=0.6, min_keys=8),
        dict(rounds=1, alpha=0.5),
    ])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_bit_exact(self, cfg, seed):
        rng = np.random.default_rng(seed)
        S, D = 300, 32
        k, sign, planes = _keys(rng, (S, D))
        q = rng.integers(-127, 128, size=(D,)).astype(np.int32)
        valid = rng.random(S) < 0.9
        scale = 1.0 / np.sqrt(D) / 900.0
        for v in (None, valid):
            want = jbgpp.bgpp_predict(jnp.asarray(q), jnp.asarray(planes), jnp.asarray(sign),
                                      jbgpp.BGPPConfig(**cfg), logit_scale=scale,
                                      valid=None if v is None else jnp.asarray(v))
            got = tbgpp.bgpp_predict(_t(q), _t(planes), _t(sign), tbgpp.BGPPConfig(**cfg),
                                     logit_scale=scale, valid=None if v is None else _t(v))
            _eq(got[0], want[0])
            _eq(got[1], want[1])
            _stats_equal(got[2], want[2])

    def test_width_not_a_multiple_of_8(self):
        """Pad bits score nothing: D = 20 packs to 24 on the port's side."""
        rng = np.random.default_rng(3)
        k, sign, planes = _keys(rng, (90, 20))
        q = rng.integers(-127, 128, size=(20,)).astype(np.int32)
        want = jbgpp.bgpp_predict(jnp.asarray(q), jnp.asarray(planes), jnp.asarray(sign),
                                  logit_scale=0.01)
        got = tbgpp.bgpp_predict(_t(q), _t(planes), _t(sign), logit_scale=0.01)
        _eq(got[0], want[0])
        _eq(got[1], want[1])
        _stats_equal(got[2], want[2])

    def test_alphas(self):
        for kw in (dict(), dict(alpha=1.3), dict(alpha_schedule=(0.9, 0.7))):
            for r in (1, 2, 4, 7):
                assert tbgpp.BGPPConfig(**kw).alphas(r) == jbgpp.BGPPConfig(**kw).alphas(r)

    @pytest.mark.parametrize("min_keys", [0, 24])
    def test_batched_gqa_union(self, min_keys):
        rng = np.random.default_rng(11 + min_keys)
        B, S, Hk, g, D = 2, 96, 2, 3, 16
        k, sign, planes = _keys(rng, (B, S, Hk, D))
        q = rng.integers(-127, 128, size=(B, Hk * g, D)).astype(np.int32)
        valid = rng.random((B, S)) < 0.85
        cfg = dict(rounds=4, alpha=0.5, min_keys=min_keys)
        want = jbgpp.bgpp_predict_batched(jnp.asarray(q), jnp.asarray(planes),
                                          jnp.asarray(sign), jbgpp.BGPPConfig(**cfg),
                                          logit_scale=0.002, valid=jnp.asarray(valid))
        reset_launches()
        got = tbgpp.bgpp_predict_batched(_t(q), _t(planes), _t(sign), tbgpp.BGPPConfig(**cfg),
                                         logit_scale=0.002, valid=_t(valid))
        _eq(got[0], want[0])
        _eq(got[1], want[1])
        assert got[0].shape == (B, Hk, S) and LAUNCHES["bgpp_score"] == 0


class TestTopK:
    def test_indices_with_ties(self):
        """Integer scores tie often: both sides order ties by index, the
        -inf lanes of dead keys too."""
        rng = np.random.default_rng(2)
        est = rng.integers(-4, 5, size=(3, 2, 40)).astype(np.float32)
        alive = rng.random((3, 2, 40)) < 0.6
        for k_max in (5, 24, 40):
            want = jbgpp.alive_to_topk_indices(jnp.asarray(alive), jnp.asarray(est), k_max)
            got = tbgpp.alive_to_topk_indices(_t(alive), _t(est), k_max)
            _eq(got[0], want[0])
            _eq(got[1], want[1])
        for k_keep in (1, 7, 40, 50):
            _eq(ttopk.topk_mask(_t(est), k_keep), jtopk.topk_mask(jnp.asarray(est), k_keep))

    @pytest.mark.parametrize("bits", [2, 4, 7])
    def test_value_topk_with_ties(self, bits):
        rng = np.random.default_rng(bits)
        k = rng.integers(-127, 128, size=(200, 16)).astype(np.int8)
        k[50:60] = k[10]  # equal keys, equal estimates
        q = rng.integers(-60, 60, size=(16,)).astype(np.int32)
        want = jtopk.value_topk_predict(jnp.asarray(q), jnp.asarray(k), 32, bits)
        got = ttopk.value_topk_predict(_t(q), _t(k), 32, bits)
        _eq(got[0], want[0])
        _eq(got[1], want[1])
        _stats_equal(got[2], want[2])
        _eq(ttopk.quantize_msb(_t(k), bits), jtopk.quantize_msb(jnp.asarray(k), bits))


class TestFormalCompute:
    def test_gather_attend(self):
        rng = np.random.default_rng(4)
        B, S, Hk, g, D, kmax = 2, 64, 2, 3, 16, 12
        q = rng.normal(size=(B, Hk * g, D)).astype(np.float32)
        kc, vc = (rng.normal(size=(B, S, Hk, D)).astype(np.float32) for _ in range(2))
        est = rng.normal(size=(B, Hk, S)).astype(np.float32)
        alive = rng.random((B, Hk, S)) < 0.1
        idx, ok = jbgpp.alive_to_topk_indices(jnp.asarray(alive), jnp.asarray(est), kmax)
        want = jatt.gather_attend(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), idx, ok)
        tidx, tok = tbgpp.alive_to_topk_indices(_t(alive), _t(est), kmax)
        got = tatt.gather_attend(_t(q), _t(kc), _t(vc), tidx, tok)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    def test_decode_attend(self):
        rng = np.random.default_rng(5)
        B, S, Hk, g, D = 2, 48, 2, 2, 16
        q = rng.normal(size=(B, Hk * g, D)).astype(np.float32)
        kc, vc = (rng.normal(size=(B, S, Hk, D)).astype(np.float32) for _ in range(2))
        valid = rng.random((B, S)) < 0.8
        hm = rng.random((B, Hk, S)) < 0.5
        j = lambda *a, **kw: np.asarray(jatt.decode_attend(*map(jnp.asarray, a), **kw))
        t = lambda *a, **kw: tatt.decode_attend(*map(_t, a), **kw).numpy()
        for kw in (dict(), dict(scale=0.3)):
            np.testing.assert_allclose(t(q, kc, vc, valid, head_mask=_t(hm), **kw),
                                       j(q, kc, vc, valid, head_mask=jnp.asarray(hm), **kw),
                                       rtol=0, atol=1e-6)
        # valid alone: the reference takes it for one query head; the port
        # for any number (as an all-true head mask)
        np.testing.assert_allclose(t(q[:, :1], kc[:, :, :1], vc[:, :, :1], valid),
                                   j(q[:, :1], kc[:, :, :1], vc[:, :, :1], valid),
                                   rtol=0, atol=1e-6)
        everything = np.ones((B, Hk, S), bool)
        np.testing.assert_allclose(t(q, kc, vc, valid),
                                   j(q, kc, vc, valid, head_mask=jnp.asarray(everything)),
                                   rtol=0, atol=1e-6)


def _jax_sweep(S, D):
    """The reference walkthrough's numbers at ``S`` keys (its ``main`` is
    fixed at 4096): the same generator, configs and metrics."""
    spec = importlib.util.spec_from_file_location(
        "_jax_example_bgpp_sparse_attention", REPO / "examples" / "bgpp_sparse_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rng = np.random.default_rng(0)
    q, k, _ = mod.make_concentrated_keys(rng, S, D)
    sign = jnp.asarray((k < 0).astype(np.uint8))
    mag = np.abs(k).astype(np.uint8)
    planes = jnp.asarray(np.stack([(mag >> p) & 1 for p in range(7)], 0))
    qj = jnp.asarray(q)
    scale = 1.0 / (25 * 25 * np.sqrt(D))
    logits = (k @ q).astype(np.float64) * scale
    p = np.exp(logits - logits.max())
    p /= p.sum()
    rows = []
    for alpha in tbsa.ALPHAS:
        for rounds in tbsa.ROUNDS:
            alive, _, stats = jbgpp.bgpp_predict(qj, planes, sign,
                                                 jbgpp.BGPPConfig(rounds=rounds, alpha=alpha),
                                                 logit_scale=scale)
            mask = np.asarray(alive)
            rows.append((alpha, rounds, int(mask.sum()), float(p[mask].sum()),
                         float(stats.predict_bytes) / (S * D),
                         float(stats.predict_bytes) / float(stats.value_topk_bytes)))
    idx, _, _ = jtopk.value_topk_predict(qj, jnp.asarray(k, jnp.int8), k_keep=256)
    alive, _, stats = jbgpp.bgpp_predict(qj, planes, sign,
                                         jbgpp.BGPPConfig(rounds=7, alpha=0.55),
                                         logit_scale=scale)
    return rows, np.asarray(idx), np.asarray(stats.alive_per_round), np.asarray(alive)


def test_sparse_attention_sweep_matches_at_512():
    """The walkthrough at S = 512: every sweep row (kept, mass, traffic),
    the value-level top-256 indices and the 7-round alive history equal
    the reference's."""
    rows, idx, hist, alive = _jax_sweep(512, 128)
    out = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(out):
        res = tbsa.main(S=512, device="cpu")
    assert res["rows"] == rows
    _eq(res["value_topk_idx"], idx)
    _eq(res["alive_per_round"], hist)
    _eq(res["alive"], alive)
    assert "per-round alive counts" in out.getvalue()
    assert all(n == 0 for n in LAUNCHES.values())


def test_sparse_attention_asks_for_the_card_by_default():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tbsa.main(S=64)
