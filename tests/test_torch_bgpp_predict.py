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
from repro_torch.kernels.bgpp_score import bgpp_score_heads, bgpp_score_round
from repro_torch.kernels.bgpp_score.ref import bgpp_score_round_ref

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
