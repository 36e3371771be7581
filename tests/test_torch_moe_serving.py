"""The MoE family served on the port against the JAX package, on the CPU.

mixtral-smoke (4 experts top-2, both layers sliding-window rings of 16
lanes: no global layer, no page pool) and llama4-scout-smoke (4 experts
top-1 and a shared expert; chunked-local rings of 16 lanes 3:1 with one
global layer), from parameters that JAX initialised and
``interop.params_from_numpy`` brought across:

  * the parameter tree, and ``forward``'s logits, aux and stacked K/V
    within 1e-5 (f32);
  * the ``Scheduler`` (chunked and eager, slot and paged) over prompts past
    the 16-lane window and 36 decode steps (so llama4-scout's chunk of 16
    is cut in prefill and in decode) against the JAX Scheduler: bf16 KV
    the same greedy tokens and logits within 1e-4; int8 / bgpp KV
    teacher-forced with JAX's tokens, logits within ``TF_TOL``; the same
    ``kv_read`` and ``weight_read`` counters (the router, expert banks and
    shared expert stay raw in every weight format, as the reference's);
  * no prefix reuse and no speculative Scheduler on these ring stacks, as
    in the reference.

Inside the port, bit for bit: joint = alone, slot = paged, chunked =
whole prompt, and the last logits and cache under bucket sets (3, 6),
(6,) and (8,).  The MoE routes dropless in the decode and chunk steps, so
a slot's logits do not depend on its neighbours or on a chunk's padding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import apply_weight_format_override as japply
from repro.models import model_zoo as jzoo, moe as jmoe
from repro.serving import kv_cache as jkvc, weights as jswt
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.models import model_zoo, moe, transformer
from repro_torch.serving import engine, kv_cache as tkvc, weights as tswt
from repro_torch.serving.scheduler import Scheduler

from test_torch_zoo import (LENS, MAX_SEQ, NEW, PAGE, SLOTS, _check_against_jax, _leaves,
                            _model, _prompts, _run_jax, _run_torch)

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

MOE = ["mixtral-8x22b", "llama4-scout-17b-a16e"]
FORMATS = ["bf16", "int8", "bgpp"]
LAYOUTS = ["slot", "paged"]


def test_smoke_stacks_are_what_the_tests_need():
    """mixtral-smoke has no global layer; llama4-scout-smoke's chunk (16)
    is shorter than the prompts and the decode."""
    for arch, glob in (("mixtral-8x22b", ()), ("llama4-scout-17b-a16e", (3,))):
        _, cfg, _, _ = _model(arch)
        lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, layout="paged", page_size=PAGE)
        assert lay.global_layers == glob and lay.local_window == 16
    assert max(LENS) > 16 and NEW > 2 * 16


@pytest.mark.parametrize("arch", MOE)
def test_parameters_cross_and_init_matches_the_tree(arch):
    """The JAX tree (``layers/moe/*``, ``shared/*`` on llama4-scout, the
    untied head) crosses unchanged, and ``model_zoo.init`` builds the same
    tree: leaf names, shapes, dtypes, zero norm scales."""
    jcfg, cfg, jparams, tparams = _model(arch)
    jl, tl = dict(_leaves(jax.tree.map(np.asarray, jparams))), dict(_leaves(tparams))
    assert set(jl) == set(tl)
    for n, a in jl.items():
        np.testing.assert_array_equal(tl[n].numpy(), a, err_msg=n)
    want = {"layers/moe/router", "layers/moe/gate", "layers/moe/up", "layers/moe/down",
            "lm_head"}
    if cfg.moe_shared_ff:
        want |= {"layers/moe/shared/gate", "layers/moe/shared/up", "layers/moe/shared/down"}
    assert want <= set(tl) and not any(n.startswith("layers/mlp/") for n in tl)
    mine = dict(_leaves(model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")))
    assert set(mine) == set(tl)
    for n, t in mine.items():
        assert t.shape == tl[n].shape and t.dtype == tl[n].dtype, n
        if n.endswith("scale"):
            assert not t.any(), n


@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_jax(arch):
    """Layer 0's MoE at the config's capacity factor, then the whole
    forward: logits, aux and every layer's K/V (prompts past the window,
    llama4-scout's chunks cut)."""
    jcfg, cfg, jparams, tparams = _model(arch)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    jp0 = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    tp0 = transformer.layer_params(tparams["layers"], 0)["moe"]
    jy, jaux = jmoe.moe_apply(jp0, jnp.asarray(x), jcfg)
    y, aux = moe.moe_apply(tp0, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-5
    toks = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jlog, jaux, (jk, jv) = jzoo.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                        return_kv=True)
    log, aux, (k, v) = model_zoo.forward(tparams, cfg, {"tokens": torch.from_numpy(toks).long()},
                                         return_kv=True)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-5)
    assert float(jaux) > 0 and abs(float(aux) - float(jaux)) <= 1e-5
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


# (arch, KV format, layout): both arches, every format, both layouts
CELLS = [("mixtral-8x22b", "bf16", "paged"), ("mixtral-8x22b", "int8", "slot"),
         ("mixtral-8x22b", "bgpp", "paged"), ("llama4-scout-17b-a16e", "bf16", "paged"),
         ("llama4-scout-17b-a16e", "bf16", "slot"), ("llama4-scout-17b-a16e", "int8", "slot"),
         ("llama4-scout-17b-a16e", "bgpp", "paged")]


@pytest.mark.parametrize("arch,fmt,layout", CELLS)
def test_scheduler_matches_jax(arch, fmt, layout):
    jcfg, cfg, jparams, tparams = _model(arch, keep_all=True)
    prompts = _prompts(1, LENS)
    jstats, jreq = _run_jax(jcfg, jparams, fmt, layout, prompts, NEW)
    forced = None if fmt == "bf16" else {i: r.generated for i, r in jreq.items()}
    tstats, treq = _run_torch(cfg, tparams, fmt, layout, prompts, NEW, forced)
    _check_against_jax(fmt, jstats, jreq, tstats, treq)
    assert ("paged" in tstats) == ("paged" in jstats)


# (arch, KV format, the port's layout, JAX's layout): the reference's eager
# admission into a paged layout with no global layer raises (it reads a
# page table that such a cache does not have), so mixtral's paged eager run
# is held to JAX's slot run: a stack of rings is the same cache in both
EAGER_CELLS = [("mixtral-8x22b", "bf16", "paged", "slot"),
               ("llama4-scout-17b-a16e", "bf16", "slot", "slot"),
               ("llama4-scout-17b-a16e", "int8", "paged", "paged")]


@pytest.mark.parametrize("arch,fmt,layout,jlayout", EAGER_CELLS)
def test_eager_scheduler_matches_jax(arch, fmt, layout, jlayout):
    """Eager admission: one whole-prompt forward (the MoE at the config's
    capacity factor) into a live slot, the rings written from it."""
    jcfg, cfg, jparams, tparams = _model(arch, keep_all=True)
    prompts = _prompts(2, (27, 9))
    jstats, jreq = _run_jax(jcfg, jparams, fmt, jlayout, prompts, 20, admission="eager")
    forced = None if fmt == "bf16" else {i: r.generated for i, r in jreq.items()}
    tstats, treq = _run_torch(cfg, tparams, fmt, layout, prompts, 20, forced,
                              admission="eager")
    _check_against_jax(fmt, jstats, jreq, tstats, treq)


@pytest.mark.parametrize("arch", MOE)
def test_weight_read_matches_jax_in_every_format(arch):
    """``weight_read`` prices attention and the untied head only, equal to
    the reference's plan; the MoE subtree passes through every format
    untouched."""
    jcfg, cfg, jparams, tparams = _model(arch)
    jl = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format="bf16")
    raw = dict(_leaves(tparams))
    for fmt in ("bf16", "int8", "bstc"):
        _, jplan = jswt.prepare_serve_params(jparams, japply(jcfg, fmt), jl)
        serve, tplan = tswt.prepare_serve_params(tparams, cfg, fmt)
        want, got = jplan.decode_read_bytes(jl, jcfg), tplan.decode_read_bytes()
        for key in ("format", "total", "bf16_equiv", "int8_equiv", "per_projection"):
            assert got[key] == want[key], (fmt, key)
        assert got["modeled"] == pytest.approx(want["modeled"], rel=1e-9)
        assert set(got["per_projection"]) == {"wq", "wk", "wv", "wo", "lm_head"}
        for n, leaf in _leaves(serve):
            if n.startswith("layers/moe/"):
                assert leaf is raw[n], n


@pytest.mark.parametrize("arch", MOE)
def test_no_prefix_reuse_and_no_speculative_scheduler(arch):
    """Both stacks carry rings: a shared system prompt gets no prefix hit
    (the same tokens as JAX), and ``spec_decode=True`` raises the
    reference's legality error."""
    jcfg, cfg, jparams, tparams = _model(arch)
    prompts = _prompts(3, (5, 7, 4), prefix=16)
    jstats, jreq = _run_jax(jcfg, jparams, "bf16", "paged", prompts, 4)
    tstats, treq = _run_torch(cfg, tparams, "bf16", "paged", prompts, 4)
    assert tstats.get("paged", {}).get("prefix_hits", 0) == 0
    assert jstats.get("paged", {}).get("prefix_hits", 0) == 0
    for i in jreq:
        assert treq[i].generated == jreq[i].generated
    jl = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format="bf16")
    tl = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bf16")
    with pytest.raises(ValueError, match="rollback-safe"):
        JScheduler(jparams, jcfg, jl, spec_decode=True)
    with pytest.raises(ValueError, match="rollback-safe") as terr:
        Scheduler(tparams, cfg, tl, device="cpu", spec_decode=True)
    assert str(tl.local_layers) in str(terr.value)


# --------------------------------------------------------------------------
# the port's own invariants, bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("arch", MOE)
def test_joint_equals_alone_and_slot_equals_paged(arch, fmt):
    """Staggered joint runs against each request alone (the same slots),
    and the slot layout against the paged one: tokens and every logit
    bit-identical, while the neighbours route to other experts."""
    _, cfg, _, params = _model(arch)
    prompts = _prompts(5, (21, 6, 30))
    _, joint = _run_torch(cfg, params, fmt, "paged", prompts, 24)
    for i, p in enumerate(prompts):
        _, alone = _run_torch(cfg, params, fmt, "paged", [p], 24)
        assert alone[0].generated == joint[i].generated
        assert np.array_equal(np.stack(alone[0].logit_rows), np.stack(joint[i].logit_rows)), i
    _, slot = _run_torch(cfg, params, fmt, "slot", prompts, 24)
    for i in joint:
        assert slot[i].generated == joint[i].generated
        assert np.array_equal(np.stack(slot[i].logit_rows), np.stack(joint[i].logit_rows)), i


@pytest.mark.parametrize("arch", MOE)
def test_chunked_equals_whole_prompt(arch):
    """bf16 KV: a prompt in chunks of 4 and in one chunk of 64 lanes give
    the same last logits and cache, bit for bit."""
    _, cfg, _, params = _model(arch)
    prompt = _prompts(4, (41,))[0]
    out = []
    for max_chunk in (4, 64):
        lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bf16")
        cp = engine.ChunkedPrefill(cfg, lay, buckets=(4, 64))
        out.append(cp.admit(params, tkvc.init_cache_arrays(cfg, lay, "cpu"), 1, prompt,
                            max_chunk=max_chunk))
    assert torch.equal(out[0][0], out[1][0])
    for store in ("global", "local"):
        assert (store in out[0][1]) == (store in out[1][1])
        for n, a in out[0][1].get(store, {}).items():
            assert torch.equal(a, out[1][1][store][n]), (store, n)


BUCKET_SETS = [(3, 6), (6,), (8,)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("arch", MOE)
def test_bucket_sets_give_identical_logits_and_caches(arch, fmt, layout):
    """One 37-token prompt through ``ChunkedPrefill.admit`` under the
    bucket sets: last chunks padded to 3, 6 or 8 lanes (the padded lanes
    route too, and take no capacity).  Last logits and every cache leaf
    bit-identical.  On int8 / bgpp rings (8,) is left out: a chunk's own
    keys enter its ring attend unquantized, as in the reference, so the
    partition moves the logits there."""
    _, cfg, _, params = _model(arch)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (37,))
    lay = tkvc.layout_for(cfg, SLOTS, 64, kv_format=fmt, layout=layout, page_size=PAGE)
    sets = BUCKET_SETS if fmt == "bf16" else [b for b in BUCKET_SETS if max(b) == 6]
    outs = []
    for buckets in sets:
        cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
        if "page_table" in cache:
            cache["page_table"] = tkvc.identity_page_table(lay, "cpu")
        logits, cache = engine.ChunkedPrefill(cfg, lay, buckets=buckets).admit(
            params, cache, 1, prompt)
        outs.append((logits, dict(_leaves({k: v for k, v in cache.items()
                                           if isinstance(v, dict)}))))
    for logits, leaves in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        for n, a in leaves.items():
            assert torch.equal(a, outs[0][1][n]), n
