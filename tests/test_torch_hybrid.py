"""The port's hybrid family (``models/hybrid.py``, the hybrid branches of
``model_zoo`` and ``engine.make_serve_step``, a cache layout with both
mamba and global layers) against the JAX package, on ``jamba-smoke`` (f32,
8 layers: attention at layer 4, MoE at the odd layers; d_model 64, 4/2
heads of 16, 4 experts top-2, state 16).

Both sides take the same parameters: JAX's ``model_zoo.init`` as numpy,
crossed with ``interop.params_from_numpy``; inputs are numpy-seeded.

Tolerances (f32 throughout, as ``tests/test_torch_mamba2.py`` states them):
  * forward and decode against JAX: 1e-5 of max |value| — the two sides
    sum the projections, the SSD contractions, the MoE combine and the
    attention in other orders; grads 1e-4 of each leaf's max |g|, as
    ``tests/test_torch_training.py`` bounds a train step;
  * the forward against the token-by-token decode on the port alone: 1e-4
    of max |logit| — the chunked dual form and the recurrence are two
    summation orders of one scan;
  * joint / alone: bit for bit (every operation is per slot, and
    ``layers.matmul`` sums a row in one order whatever the batch).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.distributed import sharding as jsh
from repro.models import model_zoo as jzoo
from repro.serving import engine as jengine, kv_cache as jkvc
from repro.training import train_step as jts

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import hybrid, model_zoo
from repro_torch.serving import engine, kv_cache as tkvc
from repro_torch.training import make_loss_fn
from repro_torch.training.train_step import loss_and_grads
from repro_torch.utils.tree import tree_items

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"
TOL = 1e-5
GRAD_TOL = 1e-4  # a grad leaf, of its own max |g|
B, MAX_SEQ, PAGE = 2, 32, 8
FORMATS = ["bf16", "int8", "bgpp"]
LAYOUTS = ["slot", "paged"]

_MODEL = {}


def _jax_params(jcfg, seed):
    """JAX's ``model_zoo.init`` tree for ``jcfg``, as numpy."""
    return jax.tree.map(np.asarray, jzoo.init(jax.random.key(seed), jcfg)[0])


def _model():
    """JAX-initialised smoke parameters (numpy) and their copy on the port."""
    if not _MODEL:
        jcfg = jax_config(ARCH, smoke=True)
        jp = _jax_params(jcfg, 0)
        _MODEL.update(jcfg=jcfg, cfg=get_config(ARCH, smoke=True), jp=jp,
                      tp=params_from_numpy(jp, "cpu"))
    return _MODEL["jcfg"], _MODEL["cfg"], _MODEL["jp"], _MODEL["tp"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# --------------------------------------------------------------------------
# the parameters
# --------------------------------------------------------------------------


def test_parameters_cross_and_init_matches_the_tree():
    """Every JAX leaf crosses with its dtype, shape and values, and the
    port's own ``hybrid.init`` builds the same tree (names, shapes,
    dtypes), stacked over the one super-block, with the reference's
    scales: zero norm scales, ``A_log`` / ``dt_bias`` 0 and ``D`` 1 in
    f32, projections ``N(0, 1) / sqrt(fan_in)``, the embedding at 0.02."""
    jcfg, cfg, jp, tp = _model()
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert set(jl) == set(tl)
    for n, a in jl.items():
        assert tl[n].dtype == torch.float32 and tuple(tl[n].shape) == a.shape, n
        np.testing.assert_array_equal(tl[n].numpy(), a, err_msg=n)
    assert {"blocks/pos4/attn/wq", "blocks/pos0/mamba/in_proj", "blocks/pos1/moe/router",
            "blocks/pos0/mlp/gate", "blocks/pos7/norm2/scale", "lm_head"} <= set(tl)
    assert not any(n.startswith("blocks/pos4/mamba") or n.startswith("blocks/pos3/mlp")
                   for n in tl)
    mine = dict(_leaves(hybrid.init(cfg, torch.Generator().manual_seed(0), "cpu")))
    assert set(mine) == set(tl)
    for n, a in mine.items():
        assert tuple(a.shape) == tuple(tl[n].shape) and a.dtype == tl[n].dtype, n
        if n.endswith("scale") or n.endswith("A_log") or n.endswith("dt_bias") \
                or n.endswith("conv_b"):
            assert not a.any(), n
        elif n.endswith("/D"):
            assert bool((a == 1).all()), n
    assert mine["blocks/pos0/norm1/scale"].shape == (1, cfg.d_model)
    for n, fan_in in (("blocks/pos4/attn/wq", cfg.d_model), ("blocks/pos4/attn/wo", cfg.q_dim),
                      ("blocks/pos0/mlp/down", cfg.d_ff), ("lm_head", cfg.d_model),
                      ("blocks/pos2/mamba/in_proj", cfg.d_model)):
        assert abs(float(mine[n].std()) * fan_in ** 0.5 - 1) < 0.1, n
    assert abs(float(mine["embed"].std()) / 0.02 - 1) < 0.1


def test_bf16_tree_crosses_bit_for_bit():
    """A bf16 jamba tree crosses ``params_from_numpy`` leaf for leaf: bf16
    everywhere but the mixers' f32 ``A_log``, ``D`` and ``dt_bias``."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype="bfloat16")
    jp = _jax_params(jcfg, 1)
    tp = dict(_leaves(params_from_numpy(jp, "cpu")))
    jl = dict(_leaves(jp))
    assert set(jl) == set(tp)
    for n, a in jl.items():
        want = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
        assert tp[n].dtype == want and tuple(tp[n].shape) == a.shape, n
        bits = tp[n].view(torch.int16).numpy() if want == torch.bfloat16 else tp[n].numpy()
        np.testing.assert_array_equal(bits, a.view(np.int16) if want == torch.bfloat16 else a)
    assert {n.rsplit("/", 1)[-1] for n, a in jl.items() if a.dtype.name != "bfloat16"} == \
        {"A_log", "D", "dt_bias"}


def test_period_is_checked():
    """A depth that is not a whole number of super-blocks is refused, as
    the reference's ``_period`` asserts."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), num_layers=12)
    with pytest.raises(ValueError, match="attn_every > 0 dividing num_layers"):
        hybrid.init(cfg, torch.Generator(), "cpu")


# --------------------------------------------------------------------------
# the forward
# --------------------------------------------------------------------------


def test_forward_matches_jax():
    """B 2, S 32 against ``model_zoo.forward(block_q=16, block_k=16,
    ssd_chunk=16)`` (jitted): logits and aux within 1e-5."""
    jcfg, cfg, jp, tp = _model()
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 32))
    kw = dict(block_q=16, block_k=16, ssd_chunk=16)
    want, waux = jax.jit(lambda p, t: jzoo.forward(p, jcfg, {"tokens": t}, **kw))(
        jp, jnp.asarray(toks))
    got, aux = model_zoo.forward(tp, cfg, {"tokens": _t(toks)}, **kw)
    _close(got, want)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert abs(float(aux) - float(waux)) <= TOL * abs(float(waux))


def test_loss_grads_match_jax():
    """The loss and every grad leaf of one forward (``ssd_chunk`` 8, so
    the SSD scan carries four chunks; the remat train step is
    ``tests/test_torch_training.py``'s) against ``jax.grad`` of the
    reference's loss: loss 1e-5 relative, each leaf within 1e-4 of its
    own max |g|, the bound ``tests/test_torch_training.py`` states for a
    train step (the backward sums in another order again; measured up to
    1.1e-5 here, on a mixer's in_proj).  The attention's wq / wk / wv
    grads come through the plain backward, the routers' through the aux
    loss too."""
    jcfg, cfg, jp, tp = _model()
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, 32)).astype(np.int32)}
    kw = dict(block_q=16, block_k=16, ssd_chunk=8)
    jloss_fn = jts.make_loss_fn(jcfg, jsh.ShardingRules(), kw)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(p, b)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = loss_and_grads(make_loss_fn(cfg, kw), tp,
                                    {k: _t(v) for k, v in batch.items()})
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    jflat = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    for key, g in tree_items(grads):
        _close(g, jflat[key], tol=GRAD_TOL)
    assert set(jflat) == {k for k, _ in tree_items(grads)}


# --------------------------------------------------------------------------
# serving: the cache, the decode step, the byte counters
# --------------------------------------------------------------------------


def _caches(fmt, layout):
    """The port's and JAX's fresh caches for one (format, layout), paged
    ones with an identity page table."""
    jcfg, cfg, _, _ = _model()
    lay = tkvc.layout_for(cfg, B, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    jlay = jkvc.layout_for(jcfg, B, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
    jcache, _ = jkvc.init_cache(jcfg, jlay)
    if layout == "paged":
        cache["page_table"] = tkvc.identity_page_table(lay, "cpu")
        jcache["page_table"] = jkvc.identity_page_table(jlay)
    return lay, jlay, cache, jcache


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_and_cache_match_reference(fmt, layout):
    """``layout_for`` field by field (7 mamba layers, global layer 4),
    ``init_cache_arrays`` against ``init_cache`` (the same leaves, shapes,
    dtypes and bytes: the KV store and the mamba state side by side) and
    ``decode_read_bytes`` (the mamba state left out, as in the
    reference)."""
    jcfg, cfg, _, _ = _model()
    lay, jlay, cache, jcache = _caches(fmt, layout)
    for f in dataclasses.fields(lay):
        assert getattr(lay, f.name) == getattr(jlay, f.name), f.name
    assert lay.global_layers == (4,) and lay.mamba_layers == (0, 1, 2, 3, 5, 6, 7)
    assert not lay.local_layers and not lay.has_cross
    got = {n: (tuple(a.shape), str(a.dtype).split(".")[-1]) for n, a in _leaves(cache)}
    want = {n: (a.shape, a.dtype.name) for n, a in _leaves(jcache)}
    assert got == want and {"mamba/h", "mamba/conv", "pos"} <= set(got)
    assert tkvc.cache_bytes(cache) == jkvc.cache_bytes(jcache)
    mine, ref = tkvc.decode_read_bytes(lay, cfg), jkvc.decode_read_bytes(jlay, jcfg)
    for k in ("global", "local", "total", "bf16_equiv"):
        assert mine[k] == ref[k], k
    if fmt != "bgpp":  # one global layer's full rows; bgpp reads its plan's planes
        assert mine["total"] == B * MAX_SEQ * tkvc._token_row_bytes(cfg, fmt)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_serve_steps_match_jax(fmt, layout):
    """Ten greedy ``make_serve_step`` steps of B 2 from a zero state
    against the reference's (jitted), the slots staggered: after step 3
    both sides reset slot 1, so from then on the slots decode at other
    positions.  Logits within 1e-5 of max |logit|, greedy tokens equal,
    ``pos`` [10, 7], and every cache leaf equal at the end (int8 / bgpp
    codes and the page pool bit for bit, f32 leaves within 1e-5)."""
    jcfg, cfg, jp, tp = _model()
    lay, jlay, cache, jcache = _caches(fmt, layout)
    step = engine.make_serve_step(cfg, lay)
    jstep = jax.jit(jengine.make_serve_step(jcfg, jlay))
    cur = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 1))
    for t in range(10):
        if t == 3:
            cache = tkvc.reset_slot(cache, lay, 1)
            jcache = jkvc.reset_slot(jcache, jlay, 1)
        lg, cache = step(tp, cache, _t(cur))
        jlg, jcache = jstep(jp, jcache, jnp.asarray(cur, jnp.int32))
        _close(lg, jlg)
        nxt = lg.numpy().argmax(-1)
        np.testing.assert_array_equal(nxt, np.asarray(jlg).argmax(-1))
        cur = nxt
    np.testing.assert_array_equal(cache["pos"].numpy(), [10, 7])
    jl = dict(_leaves(jax.tree.map(np.asarray, jcache)))
    for n, a in _leaves(cache):
        if a.is_floating_point():
            _close(a, jl[n])
        else:
            np.testing.assert_array_equal(a.numpy(), jl[n], err_msg=n)


def test_bf16_decode_meets_the_f32_residual():
    """In bf16 the decode's residual turns float32 at the attention layer
    (its f32 attend output meets ``wo``, as the reference's does), so the
    later mixers, MLP and experts take an f32 activation against bf16
    weights, upcast for the product.  Six steps of bf16 jamba-smoke with
    int8 KV run so on both sides: f32 logits, greedy tokens equal, and the
    logits within 10 % of max |logit| — the two sides round in bf16 at
    other places through 8 random layers (measured 1.5-5.6 %), where the
    f32 tests above bound every operation."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16")
    jp = _jax_params(jcfg, 0)
    tp = params_from_numpy(jp, "cpu")
    lay = tkvc.layout_for(cfg, B, MAX_SEQ, kv_format="int8")
    jlay = jkvc.layout_for(jcfg, B, MAX_SEQ, kv_format="int8")
    cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
    jcache, _ = jkvc.init_cache(jcfg, jlay)
    step, jstep = engine.make_serve_step(cfg, lay), jax.jit(jengine.make_serve_step(jcfg, jlay))
    cur = np.array([[3], [7]])
    for _ in range(6):
        lg, cache = step(tp, cache, _t(cur))
        jlg, jcache = jstep(jp, jcache, jnp.asarray(cur, jnp.int32))
        assert lg.dtype == torch.float32 and cache["mamba"]["conv"].dtype == torch.bfloat16
        _close(lg, jlg, tol=0.1)
        cur = lg.numpy().argmax(-1)
        np.testing.assert_array_equal(cur, np.asarray(jlg).argmax(-1))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_reset_slot_clears_kv_and_mamba_state(layout):
    """Every KV and mamba leaf filled with 3 (``abs_pos`` has no ring
    here), slot 1 reset: slot 1's mamba state is zero and, in the slot
    layout, its KV row too; slot 0 is untouched; the paged pool has no
    batch row, so it stays (its pages are the allocator's)."""
    _, cfg, _, _ = _model()
    for fmt in FORMATS:
        lay = tkvc.layout_for(cfg, B, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
        cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
        for _, a in _leaves({k: v for k, v in cache.items() if k != "page_table"}):
            a.fill_(3)
        cache = tkvc.reset_slot(cache, lay, 1)
        for n, a in cache["mamba"].items():
            assert not a[:, 1].any() and bool((a[:, 0] == 3).all()), n
        for n, a in cache["global"].items():
            row = (lambda i: a[:, :, i]) if n == "k_planes" else (lambda i: a[:, i])
            if layout == "slot":
                assert not row(1).any() and bool((row(0) == 3).all()), (fmt, n)
            else:
                assert bool((a == 3).all()), (fmt, n)
        np.testing.assert_array_equal(cache["pos"].numpy(), [3, 0])


def _serve(cfg, tp, feeds, layout="slot", fmt="bf16"):
    """``make_serve_step`` from a zero state over ``feeds``, a list of
    token rows (one token a slot).  Returns each step's ``(B, V)`` logits."""
    nb = len(feeds[0])
    lay = tkvc.layout_for(cfg, nb, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
    if layout == "paged":
        cache["page_table"] = tkvc.identity_page_table(lay, "cpu")
    step = engine.make_serve_step(cfg, lay)
    out = []
    for row in feeds:
        lg, cache = step(tp, cache, torch.as_tensor(np.asarray(row))[:, None])
        out.append(lg[:, 0])
    return out


def test_forward_continues_into_decode():
    """The whole-sequence forward (chunk 16) and the token-by-token decode
    (bf16 KV, slot) give each prompt position's logits within 1e-4 of max
    |logit|: the smoke's capacity factor 8 is dropless, so the forward's
    MoE keeps every token as the decode's does."""
    _, cfg, _, tp = _model()
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, 32))
    want, _ = model_zoo.forward(tp, cfg, {"tokens": _t(toks)}, ssd_chunk=16)
    got = _serve(cfg, tp, [toks[:, i] for i in range(MAX_SEQ - 1)])
    _close(torch.stack(got, 1), want[:, :MAX_SEQ - 1], tol=1e-4)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_joint_run_is_each_slot_alone(layout):
    """Two staggered requests in one batch (slot 1 starts three steps
    later, reset first) give each request's logits bit for bit as a batch
    of its own, bf16 and int8 KV."""
    _, cfg, _, tp = _model()
    rng = np.random.default_rng(7)
    a, b = rng.integers(0, cfg.vocab_size, 10), rng.integers(0, cfg.vocab_size, 7)
    for fmt in ("bf16", "int8"):
        lay = tkvc.layout_for(cfg, 2, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
        cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
        if layout == "paged":
            cache["page_table"] = tkvc.identity_page_table(lay, "cpu")
        step = engine.make_serve_step(cfg, lay)
        joint = {0: [], 1: []}
        for t in range(10):
            if t == 3:
                cache = tkvc.reset_slot(cache, lay, 1)
            row = [a[t], b[t - 3] if t >= 3 else 0]
            lg, cache = step(tp, cache, torch.as_tensor(row)[:, None])
            joint[0].append(lg[0, 0])
            if t >= 3:
                joint[1].append(lg[1, 0])
        for i, toks in ((0, a), (1, b)):
            alone = _serve(cfg, tp, [np.array([x]) for x in toks], layout=layout, fmt=fmt)
            torch.testing.assert_close(torch.stack(joint[i]),
                                       torch.stack([x[0] for x in alone]), rtol=0, atol=0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_full_width_decode_read_bytes(fmt):
    """jamba-1.5-large's layouts (one super-block and the whole 72 layers,
    both layouts, max_seq 1024 and 32768): ``decode_read_bytes`` equals
    the reference's, and counts the 9 (or 1) global layers' KV alone."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    for depth in (8, 72):
        c, jc = (dataclasses.replace(x, num_layers=depth) for x in (cfg, jcfg))
        for layout in LAYOUTS:
            for S in (1024, 32768):
                lay = tkvc.layout_for(c, 4, S, kv_format=fmt, layout=layout, page_size=16)
                jlay = jkvc.layout_for(jc, 4, S, kv_format=fmt, layout=layout, page_size=16)
                got, want = tkvc.decode_read_bytes(lay, c), jkvc.decode_read_bytes(jlay, jc)
                assert got["total"] == want["total"] and got["local"] == 0
                assert len(lay.global_layers) == depth // 8
                assert len(lay.mamba_layers) == depth - depth // 8
