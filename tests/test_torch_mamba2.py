"""The port's ssm family (``models/mamba2.py``, the mamba state in
``serving/kv_cache.py``, the ssm branch of ``engine.make_serve_step``)
against the JAX package, on ``mamba2-smoke`` (f32, 3 layers, d_model 64,
2 heads of 32, state 16).

Both sides take the same parameters: JAX's ``model_zoo.init`` as numpy,
crossed with ``interop.params_from_numpy``; inputs are numpy-seeded.

Tolerances (f32 throughout):
  * conv, mixer, scan: 1e-5 relative to the output's scale — the two
    sides sum the conv taps, the SSD contractions and the projections in
    other orders (XLA's einsums against the port's pairwise matmuls).
  * logits: 1e-5 absolute at |logit| < 1 (the smoke's tied head).
  * forward / step-by-step continuation on the port alone: 1e-4 of max
    |logit| and of max |h| — the chunked dual form and the recurrence
    are two summation orders of one scan.
  * joint / alone, slot / reset: bit for bit (every op is per slot and
    ``layers.matmul`` sums a row in one order whatever the batch).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import mamba2 as jmamba2, model_zoo as jzoo
from repro.serving import engine as jengine, kv_cache as jkvc

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import layers as tlayers, mamba2, model_zoo, transformer
from repro_torch.serving import engine, kv_cache as tkvc

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "mamba2-1.3b"
TOL = 1e-5

_MODEL = {}


def _model():
    """JAX-initialised smoke parameters (numpy) and their copy on the port."""
    if not _MODEL:
        jcfg = jax_config(ARCH, smoke=True)
        jp = jax.tree.map(np.asarray, jzoo.init(jax.random.key(0), jcfg)[0])
        _MODEL.update(jcfg=jcfg, cfg=get_config(ARCH, smoke=True), jp=jp,
                      tp=params_from_numpy(jp, "cpu"))
    return _MODEL["jcfg"], _MODEL["cfg"], _MODEL["jp"], _MODEL["tp"]


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_causal_conv_both_forms():
    """The whole-sequence conv and the rolling-window decode form against
    JAX's, and the window the decode form hands on."""
    jcfg, cfg, jp, tp = _model()
    jm, tm = _layer(jp["layers"], 1)["mixer"], _layer(tp["layers"], 1)["mixer"]
    rng = np.random.default_rng(0)
    C = tm["conv_w"].shape[1]
    x = rng.normal(size=(2, 24, C)).astype(np.float32)
    want, _ = jmamba2._causal_conv(jnp.asarray(x), jm["conv_w"], jm["conv_b"])
    got, none = mamba2._causal_conv(_t(x), tm["conv_w"], tm["conv_b"])
    assert none is None
    _close(got, want)
    state = rng.normal(size=(2, cfg.ssm_conv - 1, C)).astype(np.float32)
    want, want_win = jmamba2._causal_conv(jnp.asarray(x[:, :1]), jm["conv_w"], jm["conv_b"],
                                          conv_state=jnp.asarray(state))
    got, got_win = mamba2._causal_conv(_t(x[:, :1]), tm["conv_w"], tm["conv_b"],
                                       conv_state=_t(state))
    _close(got, want)
    np.testing.assert_array_equal(got_win.numpy(), np.asarray(want_win))


@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_chunked_matches_jax(return_state):
    """Chunk 16 over S 64 (four chunks carried by the recurrence), B 2."""
    rng = np.random.default_rng(1)
    B, S, H, P, N = 2, 64, 2, 32, 16
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32) for _ in range(2))
    want = jmamba2.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=16,
                               return_state=return_state)
    got = mamba2.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk=16,
                             return_state=return_state)
    if return_state:
        _close(got[0], want[0])
        _close(got[1], want[1])
    else:
        _close(got, want)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        mamba2.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk=24)


def test_mixer_apply_and_decode_step_match_jax():
    """``mixer_apply`` (output and continuation state) and one
    ``mixer_decode_step`` from that state, each against JAX's."""
    jcfg, cfg, jp, tp = _model()
    jm, tm = _layer(jp["layers"], 0)["mixer"], _layer(tp["layers"], 0)["mixer"]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    want, wst = jmamba2.mixer_apply(jm, jcfg, jnp.asarray(x), chunk=16, return_state=True)
    got, gst = mamba2.mixer_apply(tm, cfg, _t(x), chunk=16, return_state=True)
    _close(got, want)
    _close(gst["h"], wst["h"])
    _close(gst["conv"], wst["conv"])
    _close(mamba2.mixer_apply(tm, cfg, _t(x), chunk=16), want)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    want, wst = jmamba2.mixer_decode_step(jm, jcfg, jnp.asarray(x1), wst)
    got, gst = mamba2.mixer_decode_step(tm, cfg, _t(x1), gst)
    _close(got, want)
    _close(gst["h"], wst["h"])
    _close(gst["conv"], wst["conv"])
    zero = mamba2.init_mixer_state(cfg, 2, torch.float32, "cpu")
    jzero = jmamba2.init_mixer_state(jcfg, 2, jnp.float32)
    for n in ("h", "conv"):
        assert tuple(zero[n].shape) == jzero[n].shape and not zero[n].any()


def test_forward_logits_match_jax():
    jcfg, cfg, jp, tp = _model()
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48))
    want, _ = jzoo.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, chunk=16)
    got, aux = model_zoo.forward(tp, cfg, {"tokens": _t(toks)}, chunk=16)
    _close(got, want)
    assert float(aux) == 0.0


def _serve(cfg, tp, B, feeds, max_seq=32, layout="slot"):
    """Run ``make_serve_step`` from a zero state over ``feeds``, a list of
    (B,) token rows.  Returns each step's ``(B, V)`` logits and the cache."""
    lay = tkvc.layout_for(cfg, B, max_seq, layout=layout)
    cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
    step = engine.make_serve_step(cfg, lay)
    out = []
    for row in feeds:
        lg, cache = step(tp, cache, torch.as_tensor(row)[:, None])
        out.append(lg[:, 0])
    return out, cache


def test_serve_steps_match_jax():
    """Four greedy ``serve_step``s of B 2 from a zero state against JAX's
    ``make_serve_step``: tokens equal, logits within 1e-5, ``pos`` 4 and
    the mamba state within 1e-5."""
    jcfg, cfg, jp, tp = _model()
    B = 2
    lay, jlay = tkvc.layout_for(cfg, B, 32), jkvc.layout_for(jcfg, B, 32)
    assert lay.mamba_layers == jlay.mamba_layers == (0, 1, 2)
    assert not lay.global_layers and not lay.local_layers
    cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
    jcache, _ = jkvc.init_cache(jcfg, jlay)
    for n in ("h", "conv"):
        assert tuple(cache["mamba"][n].shape) == jcache["mamba"][n].shape
    step, jstep = engine.make_serve_step(cfg, lay), jax.jit(jengine.make_serve_step(jcfg, jlay))
    cur = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 1))
    for _ in range(4):
        lg, cache = step(tp, cache, _t(cur))
        jlg, jcache = jstep(jp, jcache, jnp.asarray(cur, jnp.int32))
        _close(lg, jlg)
        nxt = lg.numpy().argmax(-1)
        np.testing.assert_array_equal(nxt, np.asarray(jlg).argmax(-1))
        cur = nxt
    np.testing.assert_array_equal(cache["pos"].numpy(), [4, 4])
    for n in ("h", "conv"):
        _close(cache["mamba"][n], jcache["mamba"][n])


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_reset_slot_clears_one_slot(layout):
    """The reference's ``test_reset_slot_covers_mamba_and_cross``: every
    state leaf filled with 3, slot 1 reset -> slot 1 zero, slot 0 untouched."""
    _, cfg, _, _ = _model()
    lay = tkvc.layout_for(cfg, 2, 16, layout=layout)
    cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
    for a in cache["mamba"].values():
        a.fill_(3)
    cache["pos"].fill_(3)
    cache = tkvc.reset_slot(cache, lay, 1)
    for n, a in cache["mamba"].items():
        assert bool((a[:, 1] == 0).all()) and bool((a[:, 0] == 3).all()), n
    np.testing.assert_array_equal(cache["pos"].numpy(), [3, 0])


def test_forward_continues_into_decode():
    """The whole-sequence forward and the token-by-token decode are one
    scan: the forward's logits at every prompt position equal the decode
    steps' (1e-4 of max |logit|), and ``mixer_apply(return_state=True)``'s
    state after the prompt equals the decode's (1e-4 of max |h|; the conv
    window exactly)."""
    _, cfg, _, tp = _model()
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 32))
    want, _ = model_zoo.forward(tp, cfg, {"tokens": _t(toks)}, chunk=16)
    got, cache = _serve(cfg, tp, 2, [toks[:, i] for i in range(32)])
    _close(torch.stack(got, 1), want, tol=1e-4)
    # the first layer's continuation state from the forward's mixer
    p = _layer(tp["layers"], 0)
    x = tlayers.apply_norm(transformer.embed_tokens(tp, cfg, _t(toks)), p["norm"], cfg.norm)
    _, st = mamba2.mixer_apply(p["mixer"], cfg, x, chunk=16, return_state=True)
    _close(st["h"], cache["mamba"]["h"][0], tol=1e-4)
    np.testing.assert_array_equal(st["conv"].numpy(), cache["mamba"]["conv"][0].numpy())


def test_joint_run_is_each_slot_alone():
    """Two staggered requests in one batch (slot 1 starts three steps
    later, reset first) give each request's logits bit for bit as a batch
    of its own, in both layouts."""
    _, cfg, _, tp = _model()
    rng = np.random.default_rng(6)
    a, b = rng.integers(0, cfg.vocab_size, 10), rng.integers(0, cfg.vocab_size, 7)
    for layout in ("slot", "paged"):
        lay = tkvc.layout_for(cfg, 2, 32, layout=layout)
        cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
        step = engine.make_serve_step(cfg, lay)
        joint = {0: [], 1: []}
        for t in range(10):
            if t == 3:
                cache = tkvc.reset_slot(cache, lay, 1)
            row = [a[t], b[t - 3] if 3 <= t < 10 else 0]
            lg, cache = step(tp, cache, torch.as_tensor(row)[:, None])
            joint[0].append(lg[0, 0])
            if t >= 3:
                joint[1].append(lg[1, 0])
        for i, toks in ((0, a), (1, b)):
            alone, _ = _serve(cfg, tp, 1, [np.array([x]) for x in toks], layout=layout)
            torch.testing.assert_close(torch.stack(joint[i]), torch.stack([x[0] for x in alone]),
                                       rtol=0, atol=0)


def test_long_500k_layout_takes_a_short_ones_bytes():
    """``layout_for`` at the reference's long_500k (max_seq 524,288, B 1)
    allocates the same state as at max_seq 32: no KV store, no page pool,
    and ``decode_read_bytes`` counts 0 B, as the reference's does (it
    leaves the state out)."""
    jcfg, cfg, _, _ = _model()
    nbytes = lambda c: sum(a.numel() * a.element_size() for t in c.values()
                           for a in (t.values() if isinstance(t, dict) else [t]))
    sizes = []
    for layout in ("slot", "paged"):
        for S in (32, 524288):
            lay = tkvc.layout_for(cfg, 1, S, layout=layout)
            cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
            assert set(cache) == {"pos", "mamba"}
            sizes.append(nbytes(cache))
            got = tkvc.decode_read_bytes(lay, cfg)
            want = jkvc.decode_read_bytes(jkvc.layout_for(jcfg, 1, S, layout=layout), jcfg)
            assert got["total"] == want["total"] == 0
    assert len(set(sizes)) == 1
    full = get_config(ARCH)
    lay = tkvc.layout_for(full, 1, 524288)
    d_in = full.ssm_expand * full.d_model
    state = 48 * (d_in // full.ssm_head_dim * full.ssm_head_dim * full.ssm_state * 4
                  + (full.ssm_conv - 1) * (d_in + 2 * full.ssm_state) * 2)
    assert len(lay.mamba_layers) == 48 and state == 101_916_672


def test_every_leaf_crosses_with_its_dtype():
    """A bf16 mamba2 tree crosses ``params_from_numpy`` leaf for leaf:
    the same paths, dtypes (bf16 projections, conv and norms; f32
    ``A_log``, ``D``, ``dt_bias``) and bits."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jzoo.init(jax.random.key(1), jcfg)[0])
    tp = params_from_numpy(jp, "cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jl) == 11
    for path, a in jl:
        t = tp
        for k in path:
            t = t[k.key]
        want = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
        assert t.dtype == want and tuple(t.shape) == a.shape, path
        bits = t.view(torch.int16).numpy() if want == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(bits, a.view(np.int16) if want == torch.bfloat16 else a)
    assert {str(p[-1].key) for p, a in jl if a.dtype.name != "bfloat16"} == {"A_log", "D", "dt_bias"}


def test_ssd_chunked_gradient_is_finite_past_f32_exp_range():
    """A chunk whose summed decay passes 88 (e^88 is float32's largest):
    the intra-chunk exponential above the diagonal would overflow, so it is
    masked before it is taken; the forward and every grad are finite and
    within 1e-5 of the same scan in float64, where nothing overflows (the
    reference's ``where(causal, exp(decay), 0)`` gives its backward
    ``0 * inf = NaN`` here)."""
    rng = np.random.default_rng(9)
    B, S, H, P, N, chunk = 1, 64, 2, 4, 3, 64
    base = {"x": rng.normal(size=(B, S, H, P)), "dt": np.full((B, S, H), 2.0),
            "A": -np.ones(H), "Bm": rng.normal(size=(B, S, N)), "Cm": rng.normal(size=(B, S, N))}
    grads = {}
    for dtype in (torch.float32, torch.float64):
        ts = {k: torch.tensor(v, dtype=dtype, requires_grad=True) for k, v in base.items()}
        y = mamba2.ssd_chunked(ts["x"], ts["dt"], ts["A"], ts["Bm"], ts["Cm"], chunk=chunk)
        (y * torch.linspace(-1, 1, y.numel(), dtype=dtype).reshape(y.shape)).sum().backward()
        grads[dtype] = {k: t.grad for k, t in ts.items()}
        assert bool(torch.isfinite(y).all())
    for k, g in grads[torch.float32].items():
        want = grads[torch.float64][k]
        assert bool(torch.isfinite(g).all()), k
        _close(g.double(), want, tol=1e-5)
