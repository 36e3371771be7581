"""The port's enc_dec family (``models/whisper.py``, the layer-norm and
sinusoid pieces of ``models/layers.py``, the cross memory of
``serving/kv_cache.py`` and the enc_dec branch of
``engine.make_serve_step``) against the JAX package, on ``whisper-smoke``
(f32, 2 + 2 layers, d_model 64, 4 heads of 16, 32 encoder frames).

Both sides take the same parameters: JAX's ``model_zoo.init`` as numpy,
crossed with ``interop.params_from_numpy``; inputs are numpy-seeded.  The
JAX functions run under ``jax.jit``, as the reference serves them: XLA
folds the constant sinusoid tables there with a correctly rounded exp,
where eager ``jnp.exp`` is off by an ulp on a few lanes.

Tolerance: 1e-5 of max |value| (f32 sums in other orders).  Greedy tokens
identical.  The decode is never held to the teacher-forced forward: the
reference's decode applies RoPE (``engine.py:420``) and its forward does
not (``whisper.py:98-100``), so the two differ in both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import layers as jlayers, model_zoo as jzoo, whisper as jwhisper
from repro.serving import engine as jengine, kv_cache as jkvc

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import layers, model_zoo, whisper
from repro_torch.serving import engine, kv_cache as tkvc

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "whisper-medium"
TOL = 1e-5
B, MAX_SEQ, PAGE = 2, 32, 8

_MODEL = {}


def _model():
    """JAX-initialised smoke parameters (numpy), their copy on the port,
    seeded frames ``(B, 32, 64)``, JAX's memory of them and the port's."""
    if not _MODEL:
        jcfg = jax_config(ARCH, smoke=True)
        cfg = get_config(ARCH, smoke=True)
        jp = jax.tree.map(np.asarray, jzoo.init(jax.random.key(0), jcfg)[0])
        tp = params_from_numpy(jp, "cpu")
        frames = np.random.default_rng(0).normal(
            size=(B, cfg.encoder_seq, cfg.d_audio)).astype(np.float32)
        jmem = np.asarray(jax.jit(lambda p, f: jwhisper.encode(p, jcfg, f))(jp, frames))
        _MODEL.update(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, frames=frames, jmem=jmem,
                      tmem=whisper.encode(tp, cfg, _t(frames)))
    return _MODEL


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# --------------------------------------------------------------------------
# layers: the layer norm and the sinusoids
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """``layer_norm`` (eps 1e-5, f32 inside, cast back) and ``apply_norm``'s
    ``ln`` against JAX's, on rows of large offset and spread."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 64)) * 7 + 3).astype(np.float32)
    w, b = rng.normal(size=(2, 64)).astype(np.float32)
    jd = getattr(jnp, dtype)
    want = jax.jit(jlayers.layer_norm)(*(jnp.asarray(a, jd) for a in (x, w, b)))
    td = getattr(torch, dtype)
    got = layers.layer_norm(*(_t(a).to(td) for a in (x, w, b)))
    assert got.dtype == td
    if dtype == "float32":
        _close(got, want)
    else:  # one bf16 rounding of a float32 result within 1e-5
        _close(got.float(), np.asarray(want, np.float32), tol=2 ** -7)
    ln = layers.apply_norm(_t(x), {"scale": _t(w), "bias": _t(b)}, "ln")
    _close(ln, jlayers.apply_norm(jnp.asarray(x), {"scale": w, "bias": b}, "ln"))
    norm = layers.norm_init(64, "ln", torch.float32, "cpu", (2,))
    jnorm, _ = jlayers.norm_init(64, "ln", jnp.float32)
    assert set(norm) == set(jnorm) == {"scale", "bias"}
    for n, a in norm.items():
        assert tuple(a.shape) == (2, 64)
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(jnorm[n]))
    with pytest.raises(ValueError, match="unknown norm"):
        layers.apply_norm(_t(x), norm, "group")


@pytest.mark.parametrize("dim", [64, 1024])
def test_sinusoids_match_jax_up_to_32767(dim):
    """``layers.sinusoid_at`` (the reference's ``engine._sinusoid_at``) at
    positions up to 32767 (decode_32k's: the
    first 2048, 2048 drawn above them and 32767) and
    ``sinusoidal_positions`` over the encoder's 1500 against the
    reference's compiled tables: within 1e-5 absolute (|value| <= 1), the
    angles' exponent table equal bit for bit."""
    rng = np.random.default_rng(dim)
    pos = np.concatenate([np.arange(2048), rng.integers(2048, 32767, 2048),
                          [32767]]).astype(np.int32)
    want = np.asarray(jax.jit(lambda p: jengine._sinusoid_at(p, dim))(jnp.asarray(pos)))
    got = layers.sinusoid_at(_t(pos), dim)
    assert got.dtype == torch.float32
    _close(got, want)
    table = np.asarray(jax.jit(lambda: jlayers.sinusoidal_positions(1500, dim))())
    _close(layers.sinusoidal_positions(1500, dim), table)
    div = jax.jit(lambda: jnp.exp(jnp.arange(0, dim, 2, dtype=jnp.float32)
                                  * (-np.log(10000.0) / dim)))()
    np.testing.assert_array_equal(layers.sinusoid_div(dim).numpy(), np.asarray(div))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def test_parameters_cross_and_init_matches_the_tree():
    """The JAX tree crosses unchanged (layer-norm biases and MLP biases
    included), and ``model_zoo.init`` builds the same tree: leaf names,
    shapes, dtypes, norms of scale 1 and bias 0, zero MLP biases, the
    projections' and the embedding's scales."""
    m = _model()
    jl, tl = dict(_leaves(m["jp"])), dict(_leaves(m["tp"]))
    assert set(jl) == set(tl)
    for n, a in jl.items():
        np.testing.assert_array_equal(tl[n].numpy(), a, err_msg=n)
    assert {"encoder/norm1/bias", "decoder/norm_x/scale", "decoder/xattn/wk",
            "decoder/mlp/up_b", "audio_proj", "enc_final_norm/bias"} <= set(tl)
    cfg = m["cfg"]
    mine = dict(_leaves(model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")))
    assert set(mine) == set(tl)
    for n, a in mine.items():
        assert tuple(a.shape) == tl[n].shape and a.dtype == tl[n].dtype, n
        if n.endswith("scale"):
            assert bool((a == 1).all()), n
        elif n.endswith("bias") or n.endswith("_b"):
            assert not a.any(), n
    for n, fan_in in (("audio_proj", cfg.d_audio), ("decoder/xattn/wq", cfg.d_model),
                      ("encoder/mlp/down", cfg.d_ff)):
        assert abs(float(mine[n].std()) * fan_in ** 0.5 - 1) < 0.1, n
    assert abs(float(mine["embed"].std()) / 0.02 - 1) < 0.1


def test_bf16_tree_crosses_bit_for_bit():
    """A bf16 whisper tree crosses ``params_from_numpy`` leaf for leaf."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jzoo.init(jax.random.key(1), jcfg)[0])
    tp = dict(_leaves(params_from_numpy(jp, "cpu")))
    jl = dict(_leaves(jp))
    assert set(jl) == set(tp) and len(jl) == 36
    for n, a in jl.items():
        assert tp[n].dtype == torch.bfloat16 and tuple(tp[n].shape) == a.shape, n
        np.testing.assert_array_equal(tp[n].view(torch.int16).numpy(), a.view(np.int16))


def test_encode_matches_jax():
    """The encoder (``audio_proj``, the table, two full-mask layers, the
    final layer norm) over 32 frames."""
    m = _model()
    assert tuple(m["tmem"].shape) == (B, m["cfg"].encoder_seq, m["cfg"].d_model)
    _close(m["tmem"], m["jmem"])


def test_decode_train_matches_jax():
    """The teacher-forced decoder (causal self-attention, cross-attention
    of 12 queries over 32 memory rows) on JAX's memory."""
    m = _model()
    cfg, jcfg = m["cfg"], m["jcfg"]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 12))
    want = jax.jit(lambda p, t, mem: jwhisper.decode_train(p, jcfg, t, mem))(
        m["jp"], jnp.asarray(toks), jnp.asarray(m["jmem"]))
    _close(whisper.decode_train(m["tp"], cfg, _t(toks), _t(m["jmem"])), want)


def test_forward_matches_jax():
    """``model_zoo.forward`` with ``batch["frames"]``: logits, and aux 0."""
    m = _model()
    cfg, jcfg = m["cfg"], m["jcfg"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 20))
    want, jaux = jax.jit(lambda p, b: jzoo.forward(p, jcfg, b))(
        m["jp"], {"tokens": jnp.asarray(toks), "frames": jnp.asarray(m["frames"])})
    got, aux = model_zoo.forward(m["tp"], cfg, {"tokens": _t(toks), "frames": _t(m["frames"])})
    _close(got, want)
    assert float(aux) == float(jaux) == 0.0 and aux.dtype == torch.float32


def _jax_cross(m, mem):
    """The stacked cross memory ``(L, B, Hk, S_enc, Dh)`` as the reference's
    ``test_whisper_decode_runs`` writes it by hand, in JAX: per layer
    ``memory @ wk`` (``wv``), heads-major."""
    jcfg, jp = m["jcfg"], m["jp"]
    mem = jnp.asarray(mem)
    ks, vs = [], []
    for i in range(jcfg.num_layers):
        p = jax.tree.map(lambda a: a[i], jp["decoder"])
        km = (mem @ p["xattn"]["wk"]).reshape(mem.shape[0], -1, jcfg.num_kv_heads,
                                              jcfg.head_dim)
        vm = (mem @ p["xattn"]["wv"]).reshape(mem.shape[0], -1, jcfg.num_kv_heads,
                                              jcfg.head_dim)
        ks.append(jnp.swapaxes(km, 1, 2))
        vs.append(jnp.swapaxes(vm, 1, 2))
    return jnp.stack(ks), jnp.stack(vs)


def test_cross_kv_is_the_reference_serving_tests_fill():
    """``whisper.cross_kv`` against the cross memory the reference's
    ``test_whisper_decode_runs`` writes by hand (:func:`_jax_cross`), in
    the cache dtype."""
    m = _model()
    want_k, want_v = _jax_cross(m, m["jmem"])
    k, v = whisper.cross_kv(m["tp"], m["cfg"], _t(m["jmem"]))
    assert k.dtype == v.dtype == torch.float32
    _close(k, want_k)
    _close(v, want_v)


# --------------------------------------------------------------------------
# serving: the cache and the decode step
# --------------------------------------------------------------------------


def _caches(fmt, layout):
    """The port's and JAX's fresh caches for one (format, layout), paged
    ones with an identity page table, the cross memory filled from each
    side's own encoder memory."""
    m = _model()
    cfg, jcfg = m["cfg"], m["jcfg"]
    lay = tkvc.layout_for(cfg, B, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    jlay = jkvc.layout_for(jcfg, B, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
    jcache, _ = jkvc.init_cache(jcfg, jlay)
    if layout == "paged":
        cache["page_table"] = tkvc.identity_page_table(lay, "cpu")
        jcache["page_table"] = jkvc.identity_page_table(jlay)
    cache["cross_k"], cache["cross_v"] = whisper.cross_kv(m["tp"], cfg, m["tmem"])
    jcache["cross_k"], jcache["cross_v"] = _jax_cross(m, m["jmem"])
    return lay, jlay, cache, jcache


@pytest.mark.parametrize("fmt", ["bf16", "int8", "bgpp"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_cache_leaves_match_reference(fmt, layout):
    """``init_cache_arrays`` against the reference's ``init_cache``: the
    same leaves, shapes and dtypes (``cross_k`` / ``cross_v`` in the model
    dtype whatever the KV format), ``has_cross``, and ``cache_bytes``."""
    m = _model()
    lay = tkvc.layout_for(m["cfg"], B, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    jlay = jkvc.layout_for(m["jcfg"], B, MAX_SEQ, kv_format=fmt, layout=layout,
                           page_size=PAGE)
    for f in dataclasses.fields(lay):
        assert getattr(lay, f.name) == getattr(jlay, f.name), f.name
    assert lay.has_cross
    assert lay.global_layers == jlay.global_layers == (0, 1) and not lay.local_layers
    cache = tkvc.init_cache_arrays(m["cfg"], lay, "cpu")
    jcache, _ = jkvc.init_cache(m["jcfg"], jlay)
    got = {n: (tuple(a.shape), str(a.dtype).split(".")[-1]) for n, a in _leaves(cache)}
    want = {n: (a.shape, a.dtype.name) for n, a in _leaves(jcache)}
    assert got == want
    assert got["cross_k"] == ((2, B, 4, 32, 16), "float32")
    assert tkvc.cache_bytes(cache) == jkvc.cache_bytes(jcache)
    assert tkvc.decode_read_bytes(lay, m["cfg"])["total"] == \
        jkvc.decode_read_bytes(jlay, m["jcfg"])["total"]


@pytest.mark.parametrize("fmt", ["bf16", "int8", "bgpp"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_serve_steps_match_jax(fmt, layout):
    """Eight greedy ``make_serve_step`` steps of B 2 from position 0 over
    each side's own encoder memory, against the reference's (jitted), with
    the slots staggered: after step 3 both sides reset slot 1 and refill
    its cross memory from batch row 0's encoder memory, so from then on the
    slots decode at other positions (their sinusoids and RoPE differ).
    Logits within 1e-5 of max |logit|, greedy tokens identical, ``pos``
    [8, 5], and every cache leaf written by the decode equal (int8 / bgpp
    codes and the page pool bit for bit, f32 leaves within 1e-5)."""
    m = _model()
    cfg, jcfg = m["cfg"], m["jcfg"]
    lay, jlay, cache, jcache = _caches(fmt, layout)
    step = engine.make_serve_step(cfg, lay)
    jstep = jax.jit(jengine.make_serve_step(jcfg, jlay))
    tk, tv = whisper.cross_kv(m["tp"], cfg, m["tmem"][:1])
    jk, jv = _jax_cross(m, m["jmem"][:1])
    cur = np.zeros((B, 1), np.int64)
    for t in range(8):
        if t == 3:
            cache = tkvc.reset_slot(cache, lay, 1)
            jcache = jkvc.reset_slot(jcache, jlay, 1)
            cache["cross_k"][:, 1], cache["cross_v"][:, 1] = tk[:, 0], tv[:, 0]
            jcache["cross_k"] = jcache["cross_k"].at[:, 1].set(jk[:, 0])
            jcache["cross_v"] = jcache["cross_v"].at[:, 1].set(jv[:, 0])
        lg, cache = step(m["tp"], cache, _t(cur))
        jlg, jcache = jstep(m["jp"], jcache, jnp.asarray(cur, jnp.int32))
        _close(lg, jlg)
        nxt = lg.numpy().argmax(-1)
        np.testing.assert_array_equal(nxt, np.asarray(jlg).argmax(-1))
        cur = nxt
    np.testing.assert_array_equal(cache["pos"].numpy(), [8, 5])
    jl = dict(_leaves(jax.tree.map(np.asarray, jcache)))
    for n, a in _leaves(cache):
        if a.is_floating_point():
            _close(a, jl[n])
        else:
            np.testing.assert_array_equal(a.numpy(), jl[n], err_msg=n)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_reset_slot_clears_cross_memory_of_one_slot(layout):
    """The reference's ``test_reset_slot_covers_mamba_and_cross``: every
    cross leaf filled with 3, slot 1 reset -> slot 1's cross memory zero
    in every layer, slot 0's untouched, ``pos`` [3, 0]."""
    m = _model()
    lay = tkvc.layout_for(m["cfg"], B, MAX_SEQ, layout=layout, page_size=PAGE)
    cache = tkvc.init_cache_arrays(m["cfg"], lay, "cpu")
    for n in ("cross_k", "cross_v"):
        cache[n].fill_(3)
    cache["pos"].fill_(3)
    cache = tkvc.reset_slot(cache, lay, 1)
    for n in ("cross_k", "cross_v"):
        assert not cache[n][:, 1].any() and bool((cache[n][:, 0] == 3).all()), n
    np.testing.assert_array_equal(cache["pos"].numpy(), [3, 0])


def test_full_width_cross_memory_bytes():
    """whisper-medium's layout: 24 global layers, cross memory of 147.456
    MB a slot in bf16 (24 x 16 heads x 1500 x 64 x 2 B, K and V), left out
    of ``kv_read`` as the reference leaves it out."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    for S in (1024, 32768):
        lay = tkvc.layout_for(cfg, 1, S, kv_format="int8")
        jlay = jkvc.layout_for(jcfg, 1, S, kv_format="int8")
        assert lay.global_layers == tuple(range(24)) and lay.has_cross
        got = tkvc.decode_read_bytes(lay, cfg)
        assert got["total"] == jkvc.decode_read_bytes(jlay, jcfg)["total"]
        assert got["total"] == 24 * S * 16 * (2 * 64 + 8)
    assert 2 * 24 * 16 * cfg.encoder_seq * cfg.head_dim * 2 == 147_456_000
