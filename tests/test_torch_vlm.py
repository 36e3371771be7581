"""The VLM family on the port against the JAX package's, on the CPU.

paligemma-smoke (2 layers, 4 query heads over one kv head of 16, GeGLU, the
embedding scale, a tied head and a ``vision_proj`` of 32-wide patch
embeddings), from parameters that JAX initialised and
``interop.params_from_numpy`` brought across:

  * ``forward`` with a 16-patch image prefix (the projected patches before
    the tokens, positions from the first patch, every layer under
    prefix_causal with the patch count as its window): logits and every
    layer's K/V within 1e-5; ``model_zoo.forward`` with ``batch["vision"]``;
  * the flash kernel's plain version at ``prefix_causal`` against JAX's
    ``blocked_attend`` at prefixes 0, a tile edge and one either side of it,
    and past the sequence, with and without a query offset;
  * ``engine.prefill`` and ``prefill_into_slot`` with the prefix: the same
    ``pos`` (the text length, the reference's convention: a decode after
    a vision prefill writes inside the prefix's rows), page table and
    written lanes as JAX's (in the paged layout the lanes past the mapped
    pages drop), every cache leaf within the prefill tests' bounds;
  * the Scheduler, chunked (text only, as the reference serves a VLM), in
    the slot and paged layouts: bf16 KV the same greedy tokens and logits
    within 1e-4, int8 / bgpp KV teacher-forced with JAX's tokens within
    ``TF_TOL``; ``kv_read`` and ``weight_read`` equal (``vision_proj`` stays
    raw in every format, unpriced); prefix reuse on (no ring);
  * the eager refusal: the port's Scheduler has no ``prefill_kw``, so an
    eager admission has no image prefix and the forward raises a
    ``ValueError`` where the reference's asserts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import apply_weight_format_override as japply, get_config as jax_config
from repro.core import attention as jattention
from repro.models import model_zoo as jzoo, transformer as jtransformer
from repro.serving import engine as jengine, kv_cache as jkvc, weights as jswt
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import model_zoo, transformer
from repro_torch.serving import engine, kv_cache as tkvc, weights as tswt
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Scheduler

from test_torch_forward import _assert_cache_close
from test_torch_zoo import (LENS, MAX_SEQ, NEW, PAGE, SLOTS, _check_against_jax, _leaves,
                            _model, _prompts, _run_jax, _run_torch)

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCH = "paligemma-3b"


def _vision(cfg, B, seed=0):
    """Seeded ``(B, Tv, d_vision)`` patch embeddings, the SigLIP stub's."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.vision_tokens, cfg.d_vision)).astype(np.float32)


def test_parameters_cross_with_the_vision_projection():
    """``vision_proj`` crosses unchanged and ``model_zoo.init`` builds the
    same tree, the projection at the reference's ``(d_vision, d_model)``
    and scale."""
    jcfg, cfg, jparams, tparams = _model(ARCH)
    jl, tl = dict(_leaves(jax.tree.map(np.asarray, jparams))), dict(_leaves(tparams))
    assert set(jl) == set(tl) and "vision_proj" in tl
    np.testing.assert_array_equal(tl["vision_proj"].numpy(), jl["vision_proj"])
    mine = dict(_leaves(model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")))
    assert {n: (t.shape, t.dtype) for n, t in mine.items()} == \
        {n: (t.shape, t.dtype) for n, t in tl.items()}
    assert tuple(mine["vision_proj"].shape) == (cfg.d_vision, cfg.d_model)
    assert abs(float(mine["vision_proj"].std()) * np.sqrt(cfg.d_vision) - 1) < 0.1


def test_forward_with_the_image_prefix_matches_jax():
    jcfg, cfg, jparams, tparams = _model(ARCH)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    vis = _vision(cfg, 2)
    jlog, _, (jk, jv) = jtransformer.forward(jparams, jcfg, jnp.asarray(toks),
                                             vision_embeds=jnp.asarray(vis), return_kv=True)
    log, aux, (k, v) = transformer.forward(tparams, cfg, torch.from_numpy(toks).long(),
                                           return_kv=True, vision_embeds=torch.from_numpy(vis))
    assert tuple(log.shape) == (2, cfg.vision_tokens + 9, cfg.vocab_size) and float(aux) == 0
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    # the batch dict of the model zoo, as the reference's
    batch = {"tokens": toks, "vision": vis}
    jz, _ = jzoo.forward(jparams, jcfg, {n: jnp.asarray(a) for n, a in batch.items()})
    tz, _ = model_zoo.forward(tparams, cfg, {"tokens": torch.from_numpy(toks).long(),
                                             "vision": torch.from_numpy(vis)})
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-5)
    torch.testing.assert_close(tz, log, rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs vision_embeds"):
        transformer.forward(tparams, cfg, torch.from_numpy(toks).long())


@pytest.mark.parametrize("prefix", [0, 1, 63, 64, 65, 100, 300])
@pytest.mark.parametrize("q_offset,Sq,Sk", [(0, 130, 130), (37, 93, 130)])
def test_prefix_causal_plain_version_matches_jax(prefix, q_offset, Sq, Sk):
    """The flash kernel's plain version (its CPU path and on-card oracle)
    at prefix_causal against the reference's jnp ``blocked_attend``: a
    prefix of 0 (causal), inside the first 64-key tile, on a tile edge and
    one either side, and past the keys (full attention)."""
    rng = np.random.default_rng(prefix + q_offset)
    q = rng.normal(size=(1, Sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, Sk, 1, 16)).astype(np.float32)
    v = rng.normal(size=(1, Sk, 1, 16)).astype(np.float32)
    want = jattention.blocked_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     mask_kind="prefix_causal", window=prefix,
                                     q_offset=q_offset, block_q=32, block_k=64)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), mask_kind="prefix_causal",
                          window=prefix, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _written(store):
    """Which lanes of a global store hold a written row (any nonzero
    element), leaf by leaf."""
    out = {}
    for n, a in store.items():
        a = torch.from_numpy(np.array(a)).float() if not isinstance(a, torch.Tensor) \
            else a.float()
        out[n] = (a != 0).reshape(a.shape[0], a.shape[1], a.shape[2], -1).any(-1) \
            if a.ndim >= 4 else a != 0
    return out


def _assert_same_lanes(tc, jc):
    tw, jw = _written(tc["global"]), _written(jc["global"])
    for n in tw:
        assert torch.equal(tw[n], jw[n]), n


@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "bgpp"])
def test_prefill_with_the_image_prefix_matches_jax(fmt, layout):
    """Whole-batch prefill behind a 16-patch prefix: every one of the
    Tv + S lanes written (the identity page table maps them), ``pos`` the
    text length S as the reference sets it."""
    jcfg, cfg, jparams, tparams = _model(ARCH)
    B, S, max_seq = 2, 11, 32
    jl = jkvc.layout_for(jcfg, B, max_seq, kv_format=fmt, layout=layout, page_size=PAGE)
    tl = tkvc.layout_for(cfg, B, max_seq, kv_format=fmt, layout=layout, page_size=PAGE)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vis = _vision(cfg, B, 3)
    jlog, jc = jengine.prefill(jparams, jcfg, jl, jnp.asarray(toks),
                               vision_embeds=jnp.asarray(vis))
    log, tc = engine.prefill(tparams, cfg, tl, torch.from_numpy(toks).long(),
                             vision_embeds=torch.from_numpy(vis))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
    _assert_cache_close(tc, jc, fmt)
    _assert_same_lanes(tc, jc)
    assert tc["pos"].tolist() == [S] * B  # the quirk: not Tv + S


@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("fmt", ["bf16", "bgpp"])
def test_prefill_into_slot_with_the_image_prefix_matches_jax(fmt, layout):
    """Eager admission with the prefix into a live cache, twice: the page
    table maps only the text's pages (as the Scheduler's ``ensure_range``
    does), so in the paged layout the prefix's lanes past them drop, as in
    the reference; ``pos`` is the text length."""
    jcfg, cfg, jparams, tparams = _model(ARCH)
    B, max_seq = 2, 40
    jl = jkvc.layout_for(jcfg, B, max_seq, kv_format=fmt, layout=layout, page_size=PAGE)
    tl = tkvc.layout_for(cfg, B, max_seq, kv_format=fmt, layout=layout, page_size=PAGE)
    jc = jkvc.init_cache_arrays(jcfg, jl)
    tc = tkvc.init_cache_arrays(cfg, tl, device="cpu")
    if layout == "paged":
        table = np.asarray([[7, 2, -1, -1, -1], [4, 0, 9, -1, -1]], np.int32)
        jc["page_table"], tc["page_table"] = jnp.asarray(table), torch.from_numpy(table)
    rng = np.random.default_rng(4)
    for slot, n in ((1, 19), (0, 13)):
        prompt = rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
        vis = _vision(cfg, 1, 5 + slot)
        jlog, jc = jengine.prefill_into_slot(jparams, jcfg, jl, jc, slot, jnp.asarray(prompt),
                                             vision_embeds=jnp.asarray(vis))
        log, tc = engine.prefill_into_slot(tparams, cfg, tl, tc, slot,
                                           torch.from_numpy(prompt).long(),
                                           vision_embeds=torch.from_numpy(vis))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
        _assert_cache_close(tc, jc, fmt)
        _assert_same_lanes(tc, jc)
        assert int(tc["pos"][slot]) == n


# (KV format, layout): every format, both layouts
CELLS = [("bf16", "slot"), ("bf16", "paged"), ("int8", "slot"), ("bgpp", "paged")]


@pytest.mark.parametrize("fmt,layout", CELLS)
def test_scheduler_matches_jax(fmt, layout):
    """Chunked admission of text prompts, as the reference's Scheduler
    serves a VLM: the same tokens (bf16) or teacher-forced logits (int8,
    bgpp with the keep-all plan), ``kv_read`` and ``weight_read`` (the
    tied head priced, ``vision_proj`` not)."""
    jcfg, cfg, jparams, tparams = _model(ARCH, keep_all=True)
    prompts = _prompts(6, LENS)
    jstats, jreq = _run_jax(jcfg, jparams, fmt, layout, prompts, NEW)
    forced = None if fmt == "bf16" else {i: r.generated for i, r in jreq.items()}
    tstats, treq = _run_torch(cfg, tparams, fmt, layout, prompts, NEW, forced)
    _check_against_jax(fmt, jstats, jreq, tstats, treq)
    assert "vision_proj" not in tstats["weight_read"]["per_projection"]


def test_prefix_reuse_is_on():
    """A shared system prompt hits the prefix index, as in the reference:
    the stack has no ring (every layer of the full config is global)."""
    from repro_torch.configs import get_config

    full = get_config(ARCH)
    assert tkvc.layout_for(full, 4, 1024).global_layers == tuple(range(18))
    assert jkvc.layout_for(jax_config(ARCH), 4, 1024).global_layers == tuple(range(18))
    jcfg, cfg, jparams, tparams = _model(ARCH)
    prompts = _prompts(7, (5, 7, 4), prefix=16)
    jstats, jreq = _run_jax(jcfg, jparams, "bf16", "paged", prompts, 4)
    tstats, treq = _run_torch(cfg, tparams, "bf16", "paged", prompts, 4)
    assert tstats["paged"]["prefix_hits"] == jstats["paged"]["prefix_hits"] > 0
    assert tstats["paged"]["prefix_hit_tokens"] == jstats["paged"]["prefix_hit_tokens"]
    for i in jreq:
        assert treq[i].generated == jreq[i].generated


def test_weight_read_matches_jax_and_vision_proj_stays_raw():
    jcfg, cfg, jparams, tparams = _model(ARCH)
    jl = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format="bf16")
    for fmt in ("bf16", "int8", "bstc"):
        _, jplan = jswt.prepare_serve_params(jparams, japply(jcfg, fmt), jl)
        serve, tplan = tswt.prepare_serve_params(tparams, cfg, fmt)
        want, got = jplan.decode_read_bytes(jl, jcfg), tplan.decode_read_bytes()
        for key in ("format", "total", "bf16_equiv", "int8_equiv", "per_projection"):
            assert got[key] == want[key], (fmt, key)
        assert serve["vision_proj"] is tparams["vision_proj"]
        assert "vision_proj" not in got["per_projection"]
    # the reference's targets: the attention and MLP projections and the head
    assert set(got["per_projection"]) == {"wq", "wk", "wv", "wo", "gate", "up", "down",
                                         "lm_head"}


def test_eager_admission_refuses_as_the_reference_asserts():
    """No ``prefill_kw``: the eager Scheduler's admission has no image
    prefix to give, and the forward raises where the reference's asserts
    (its Scheduler without ``prefill_kw`` fails the same way)."""
    jcfg, cfg, jparams, tparams = _model(ARCH)
    prompt = _prompts(8, (6,))[0]
    tl = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bf16")
    sched = Scheduler(tparams, cfg, tl, device="cpu", admission="eager")
    sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(ValueError, match="family 'vlm'.*needs vision_embeds"):
        sched.run(max_steps=10)
    jl = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format="bf16")
    jsched = JScheduler(jparams, jcfg, jl, admission="eager")
    jsched.submit(JRequest(rid=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(AssertionError):
        jsched.run(max_steps=10)
