"""The dense model zoo on the port against the JAX package's, on the CPU.

Configs: the ten registered architectures, field by field and with the same
parameter counts; the ssm, hybrid and enc_dec families run the entry points
the reference runs them through and are refused at the transformer-only
ones with the reference's reason.
Models: gemma3-1b-smoke (D 24, one kv head), gemma3-4b-smoke (local rings
5:1, qk-norm, sandwich norms, GeGLU, the embedding scale) and
deepseek-7b-smoke (an untied head), from parameters that JAX
initialised and ``interop.params_from_numpy`` brought across:

  * ``forward`` logits within 1e-5 (f32);
  * the ``Scheduler`` (chunked and eager) over prompts past the 16-lane
    window and at least twice the window of decode steps: bf16 KV the same
    greedy tokens and logits within 1e-4; int8 / bgpp KV teacher-forced
    with JAX's tokens, logits within :data:`TF_TOL`; the same ``kv_read``
    and ``weight_read`` counters; no prefix reuse on a local stack; the
    speculative-decoding legality error.

The CPU logits do not move with the prefill chunk's width (buckets (3, 6),
(4, 6), (6,) and (8,), bit for bit), and the port's invariants hold bit for
bit on a local stack: joint = alone, slot = paged, chunked = whole prompt
(bf16 KV; in int8 a chunk's own keys enter its ring attend unquantized, as
in the reference, so there the chunk partition moves the logits).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCH_REGISTRY as JARCH, MCBPOptions as JMCBP
from repro.configs import get_config as jax_config, shapes as jshapes
from repro.models import layers as jlayers, model_zoo as jzoo, transformer as jtransformer
from repro.serving import kv_cache as jkvc, weights as jswt
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.configs import (ARCH_REGISTRY, MCBPOptions, apply_weight_format_override,
                                 get_config, shapes)
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models import layers, model_zoo, transformer
from repro_torch.serving import engine, kv_cache as tkvc, weights as tswt
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Scheduler

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ZOO = ["gemma3-1b", "gemma3-4b", "deepseek-7b"]
FORMATS = ["bf16", "int8", "bgpp"]
LAYOUTS = ["slot", "paged"]
SLOTS, MAX_SEQ, PAGE, BUDGET = 2, 96, 8, 8
# int8 / bgpp KV, teacher-forced: a probability or KV code that rounds the
# other way at a .5 boundary (the two sides' float sums differ by ulps)
# moves a smoke logit by a few 1e-3 (deepseek-7b-smoke, 4 heads of 16: one
# flipped code moved a row by 3.5e-3 in chip_smoke.py's card-against-CPU
# check); a wrong lane, mask or scale moves them by 1e-1 or more
TF_TOL = 5e-3
HYBRID = sorted(n for n in JARCH if jax_config(n).family == "hybrid")
SSM = sorted(n for n in JARCH if jax_config(n).family == "ssm")
ENC_DEC = sorted(n for n in JARCH if jax_config(n).family == "enc_dec")
MOE = sorted(n for n in JARCH if jax_config(n).family == "moe")
VLM = sorted(n for n in JARCH if jax_config(n).family == "vlm")

_MODELS = {}


def _model(arch, keep_all=False):
    """JAX-initialised smoke parameters and their copy on the port; with
    ``keep_all`` the BGPP plan keeps every key (its machinery runs, but a
    near-tie at the top-k edge cannot pick another key on the two sides)."""
    if arch not in _MODELS:
        jcfg = jax_config(arch, smoke=True)
        jparams, _ = jzoo.init(jax.random.key(0), jcfg)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        _MODELS[arch] = (jcfg, get_config(arch, smoke=True), jparams, tparams)
    jcfg, cfg, jparams, tparams = _MODELS[arch]
    if keep_all:
        jcfg = dataclasses.replace(jcfg, mcbp=JMCBP(bgpp_rounds=4, bgpp_keep_ratio=1.0))
        cfg = dataclasses.replace(cfg, mcbp=MCBPOptions(bgpp_rounds=4, bgpp_keep_ratio=1.0))
    return jcfg, cfg, jparams, tparams


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


def test_registries_and_shapes_match():
    assert sorted(ARCH_REGISTRY) == sorted(JARCH)
    assert [dataclasses.astuple(s) for s in shapes.SHAPES] == \
        [dataclasses.astuple(s) for s in jshapes.SHAPES]
    for arch in JARCH:
        for s in shapes.SHAPES:
            assert shapes.applicable(arch, s) == jshapes.applicable(arch, jshapes.get_shape(s.name))


@pytest.mark.parametrize("name", sorted(JARCH))
def test_config_matches_reference(name):
    """Every field (the MCBP knobs the port keeps included), the per-layer
    helpers and the parameter counts, full and smoke."""
    for smoke in (False, True):
        j, t = jax_config(name, smoke=smoke), get_config(name, smoke=smoke)
        fields = {f.name for f in dataclasses.fields(j)}
        assert fields == {f.name for f in dataclasses.fields(t)}
        for f in fields - {"mcbp"}:
            assert getattr(t, f) == getattr(j, f), f
        for f in dataclasses.fields(t.mcbp):
            assert getattr(t.mcbp, f.name) == getattr(j.mcbp, f.name), f.name
        assert (t.q_dim, t.kv_dim) == (j.q_dim, j.kv_dim)
        assert t.total_params() == j.total_params()
        assert t.active_params() == j.active_params()
        for i in range(j.num_layers):
            for fn in ("layer_is_global_attn", "layer_attn_window", "layer_is_moe",
                       "layer_is_attention"):
                assert getattr(t, fn)(i) == getattr(j, fn)(i), (fn, i)
        np.testing.assert_array_equal(transformer.layer_windows(t),
                                      jtransformer.layer_windows(j))
        np.testing.assert_array_equal(transformer.layer_thetas(t),
                                      jtransformer.layer_thetas(j))
        assert model_zoo.extra_inputs(t) == jzoo.extra_inputs(j)


def _entry_points(name, model_cfg, launcher_args, vision=None, frames=None):
    """Every entry point of the port, called on arch ``name``'s smoke config
    with the parameters, layout and cache of ``model_cfg``; ``vision`` (a
    VLM's ``(1, Tv, d_vision)`` image prefix) goes to the whole-sequence
    ones, ``frames`` (whisper's ``(1, encoder_seq, d_audio)``) to
    ``model_zoo.forward``."""
    cfg = get_config(name, smoke=True)
    params = model_zoo.init(model_cfg, torch.Generator().manual_seed(0), "cpu")
    lay = tkvc.layout_for(model_cfg, SLOTS, 32)
    cache = tkvc.init_cache_arrays(model_cfg, lay, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    batch = {"tokens": toks}
    if vision is not None:
        batch["vision"] = vision
    if frames is not None:
        batch["frames"] = frames
    return {
        "model_zoo.init": lambda: model_zoo.init(cfg, torch.Generator(), "cpu"),
        "model_zoo.forward": lambda: model_zoo.forward(params, cfg, batch),
        "init_params": lambda: transformer.init_params(cfg, torch.Generator(), "cpu"),
        "forward": lambda: transformer.forward(params, cfg, toks, vision_embeds=vision),
        "layout_for": lambda: tkvc.layout_for(cfg, SLOTS, 32),
        "make_serve_step": lambda: engine.make_serve_step(cfg, lay),
        "make_prefill_chunk": lambda: engine.make_prefill_chunk(cfg, lay),
        "prefill": lambda: engine.prefill(params, cfg, lay, toks, vision_embeds=vision),
        "prefill_into_slot": lambda: engine.prefill_into_slot(params, cfg, lay, cache, 0,
                                                              toks[0], vision_embeds=vision),
        "Scheduler": lambda: Scheduler(params, cfg, lay, device="cpu"),
        "launcher": lambda: launcher.main(["--device", "cpu", "--arch", name] + launcher_args),
    }


@pytest.mark.parametrize("name", HYBRID)
def test_hybrid_family_runs_every_entry_point(name):
    """The jamba smoke runs the entry points the reference runs it through
    (``model_zoo``, the cache layout with its mamba and global layers,
    ``make_serve_step``); the transformer-only ones (``prefill``,
    ``prefill_into_slot``, chunked admission, the ``Scheduler``, the serve
    launcher) refuse it with the reference's reason (it decodes through
    ``make_serve_step`` from a zero state), and so do the int8 and bstc
    weight formats (it decodes with raw bf16 weights)."""
    cfg = get_config(name, smoke=True)
    calls = _entry_points(name, cfg, ["--requests", "2", "--max-new", "3"])
    runs = ("model_zoo.init", "model_zoo.forward", "layout_for", "make_serve_step")
    for who, call in calls.items():
        if who in runs:
            assert call() is not None, who
        else:
            with pytest.raises(ValueError,
                               match="family 'hybrid'.*make_serve_step directly, from a zero"):
                call()
    logits, aux = calls["model_zoo.forward"]()
    assert logits.shape == (1, 4, cfg.vocab_size) and float(aux) > 0.0
    lay = calls["layout_for"]()
    assert lay.global_layers == (4,) and len(lay.mamba_layers) == 7
    for fmt in ("int8", "bstc"):
        wcfg = apply_weight_format_override(cfg, fmt)
        with pytest.raises(ValueError, match="family='hybrid' decodes with raw bf16 weights"):
            engine.make_serve_step(wcfg, tkvc.layout_for(wcfg, SLOTS, 32))


@pytest.mark.parametrize("name", SSM)
def test_ssm_family_runs_every_entry_point(name):
    """The ssm smoke runs the entry points the reference runs it through
    (``model_zoo``, the cache layout, ``make_serve_step``); the
    transformer-only ones refuse it with the reference's reason (it
    decodes through ``make_serve_step`` from a zero state), and so do the
    int8 and bstc weight formats (it decodes with raw bf16 weights)."""
    cfg = get_config(name, smoke=True)
    calls = _entry_points(name, cfg, ["--requests", "2", "--max-new", "3"])
    runs = ("model_zoo.init", "model_zoo.forward", "layout_for", "make_serve_step")
    for who, call in calls.items():
        if who in runs:
            assert call() is not None, who
        else:
            with pytest.raises(ValueError, match="family 'ssm'.*make_serve_step directly"):
                call()
    for fmt in ("int8", "bstc"):
        wcfg = apply_weight_format_override(cfg, fmt)
        with pytest.raises(ValueError, match="family='ssm' decodes with raw bf16 weights"):
            engine.make_serve_step(wcfg, tkvc.layout_for(wcfg, SLOTS, 32))


@pytest.mark.parametrize("name", ENC_DEC)
def test_enc_dec_family_runs_every_entry_point(name):
    """The whisper smoke runs the entry points the reference runs it
    through (``model_zoo`` with ``batch["frames"]``, the cache layout with
    its cross memory, ``make_serve_step``); the transformer-only ones refuse
    it with the reference's reason (it decodes through ``make_serve_step``
    directly, over the cross memory the caller fills), and so do the int8
    and bstc weight formats (it decodes with raw bf16 weights)."""
    cfg = get_config(name, smoke=True)
    frames = torch.zeros((1, cfg.encoder_seq, cfg.d_audio))
    calls = _entry_points(name, cfg, ["--requests", "2", "--max-new", "3"], frames=frames)
    runs = ("model_zoo.init", "model_zoo.forward", "layout_for", "make_serve_step")
    for who, call in calls.items():
        if who in runs:
            assert call() is not None, who
        else:
            with pytest.raises(ValueError,
                               match="family 'enc_dec'.*make_serve_step directly.*cross_k"):
                call()
    logits, aux = calls["model_zoo.forward"]()
    assert logits.shape == (1, 4, cfg.vocab_size) and float(aux) == 0.0
    assert calls["layout_for"]().has_cross
    for fmt in ("int8", "bstc"):
        wcfg = apply_weight_format_override(cfg, fmt)
        with pytest.raises(ValueError, match="family='enc_dec' decodes with raw bf16 weights"):
            engine.make_serve_step(wcfg, tkvc.layout_for(wcfg, SLOTS, 32))


@pytest.mark.parametrize("name", MOE)
def test_moe_family_runs_every_entry_point(name, capsys):
    """The MoE smokes pass every entry point the refusal test calls: each
    returns (the launcher serves two requests to the end), and a
    mixed MoE / dense stack is still the hybrid's."""
    cfg = get_config(name, smoke=True)
    calls = _entry_points(name, cfg, ["--requests", "2", "--max-new", "3",
                                      "--kv-layout", "paged"])
    for who, call in calls.items():
        assert call() is not None or who == "launcher", who
    out = capsys.readouterr().out
    assert f"arch={cfg.name} kv=int8 layout=paged" in out and ": 2 requests, " in out
    mixed = dataclasses.replace(cfg, moe_every=2)
    with pytest.raises(ValueError, match="moe_every=2.*hybrid"):
        model_zoo.init(mixed, torch.Generator(), "cpu")


@pytest.mark.parametrize("name", VLM)
def test_vlm_family_runs_every_entry_point(name, capsys):
    """The VLM smoke passes every entry point the refusal test calls, its
    whole-sequence ones with a 16-patch image prefix (the launcher serves
    two text requests to the end through chunked admission); without the
    prefix its forward raises, as the reference's asserts, and so does an
    eager admission, which has none to give."""
    cfg = get_config(name, smoke=True)
    vision = torch.zeros((1, cfg.vision_tokens, cfg.d_vision))
    calls = _entry_points(name, cfg, ["--requests", "2", "--max-new", "3",
                                      "--kv-layout", "paged"], vision=vision)
    for who, call in calls.items():
        assert call() is not None or who == "launcher", who
    out = capsys.readouterr().out
    assert f"arch={cfg.name} kv=int8 layout=paged" in out and ": 2 requests, " in out
    logits, _ = calls["forward"]()
    assert logits.shape == (1, cfg.vision_tokens + 4, cfg.vocab_size)
    with pytest.raises(ValueError, match="family 'vlm'.*needs vision_embeds"):
        model_zoo.forward(model_zoo.init(cfg, torch.Generator(), "cpu"), cfg,
                          {"tokens": torch.zeros((1, 4), dtype=torch.long), "vision": None})
    with pytest.raises(ValueError, match="needs vision_embeds"):
        launcher.main(["--device", "cpu", "--arch", name, "--requests", "1", "--max-new", "2",
                       "--admission", "eager"])


# --------------------------------------------------------------------------
# parameters, layers and the forward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_parameters_cross_and_init_matches_the_tree(arch):
    """The JAX tree (q_norm / k_norm, the sandwich norms, an untied
    lm_head) crosses unchanged, and ``model_zoo.init`` builds the same tree
    (leaf names, shapes, dtypes, zero norm scales, the projections' scale)."""
    jcfg, cfg, jparams, tparams = _model(arch)
    jl, tl = dict(_leaves(jax.tree.map(np.asarray, jparams))), dict(_leaves(tparams))
    assert set(jl) == set(tl)
    for n, a in jl.items():
        np.testing.assert_array_equal(tl[n].numpy(), a, err_msg=n)
    want = {"embed", "final_norm/scale", "layers/attn/wq", "layers/mlp/gate"}
    if cfg.qk_norm:
        want |= {"layers/attn/q_norm/scale", "layers/attn/k_norm/scale",
                 "layers/post_attn_norm/scale", "layers/post_mlp_norm/scale"}
    if not cfg.tie_embeddings:
        want.add("lm_head")
    assert want <= set(tl)
    mine = dict(_leaves(model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")))
    assert set(mine) == set(tl)
    for n, t in mine.items():
        assert t.shape == tl[n].shape and t.dtype == tl[n].dtype, n
        if n.endswith("scale"):
            assert not t.any(), n
    if "lm_head" in mine:
        assert abs(float(mine["lm_head"].std()) * np.sqrt(cfg.d_model) - 1) < 0.05


@pytest.mark.parametrize("arch", ZOO)
def test_layers_and_forward_match_jax(arch):
    """qk-norm, GeGLU / SwiGLU, the embedding scale and the head layer by
    layer, then the whole forward: logits and every layer's K/V."""
    jcfg, cfg, jparams, tparams = _model(arch)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    jp0 = jax.tree.map(lambda a: a[0], jparams["layers"])
    tp0 = transformer.layer_params(tparams["layers"], 0)
    theta = float(transformer.layer_thetas(cfg)[0])
    want = jlayers.qkv_project(jp0["attn"], jnp.asarray(x), cfg.num_heads, cfg.num_kv_heads,
                               cfg.head_dim, jnp.asarray(pos), theta, qk_norm=cfg.qk_norm)
    got = layers.qkv_project(tp0["attn"], torch.from_numpy(x), cfg.num_heads,
                             cfg.num_kv_heads, cfg.head_dim, torch.from_numpy(pos.copy()),
                             theta, qk_norm=cfg.qk_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        layers.mlp_apply(tp0["mlp"], torch.from_numpy(x), cfg.activation).numpy(),
        np.asarray(jlayers.mlp_apply(jp0["mlp"], jnp.asarray(x), cfg.activation)),
        rtol=0, atol=1e-5)
    toks = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jlog, _, (jk, jv) = jtransformer.forward(jparams, jcfg, jnp.asarray(toks), return_kv=True)
    log, _, (k, v) = model_zoo.forward(tparams, cfg, {"tokens": torch.from_numpy(toks).long()},
                                       return_kv=True)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


@pytest.mark.parametrize("transposed", [False, True])
def test_cpu_matmul_rows_do_not_follow_the_row_count(transposed):
    """Each row of ``layers.matmul`` on the CPU is the same bits alone, in
    a pair, or in a block of any height, against a contiguous weight and a
    transposed view (the tied head ``embed.T``) alike."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(13, 96)).astype(np.float32))
    embed = torch.from_numpy(rng.normal(size=(512, 96)).astype(np.float32))
    w = embed.T if transposed else embed.T.contiguous()
    full = layers.matmul(x, w)
    for rows in (1, 2, 3, 4, 5, 8):
        for i in range(0, 13 - rows + 1, 3):
            assert torch.equal(layers.matmul(x[i:i + rows], w), full[i:i + rows]), (rows, i)
    assert torch.equal(layers.matmul(x[None, 4:5], w)[0], full[4:5])


# --------------------------------------------------------------------------
# the chunk width does not move the CPU logits
# --------------------------------------------------------------------------

BUCKET_SETS = [(3, 6), (4, 6), (6,), (8,)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma3-4b"])
def test_bucket_sets_give_identical_logits_and_caches(arch, fmt, layout):
    """One 37-token prompt through ``ChunkedPrefill.admit`` under four
    bucket sets: the last chunk is padded to 3, 4, 6 or 8 lanes (and (8,)
    also cuts the prompt in chunks of 8, not 6).  Last logits and every
    cache leaf bit-identical.  On gemma3's int8 / bgpp rings the (8,)
    partition is left out: a chunk's own keys enter its ring attend
    unquantized there, as in the reference, whose logits move too."""
    cfg = get_config(arch, smoke=True)
    params = model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (37,))
    lay = tkvc.layout_for(cfg, SLOTS, 64, kv_format=fmt, layout=layout, page_size=PAGE)
    sets = BUCKET_SETS
    if lay.local_layers and fmt != "bf16":
        sets = [b for b in BUCKET_SETS if max(b) == 6]
    outs = []
    for buckets in sets:
        cache = tkvc.init_cache_arrays(cfg, lay, "cpu")
        if layout == "paged":
            cache["page_table"] = tkvc.identity_page_table(lay, "cpu")
        logits, cache = engine.ChunkedPrefill(cfg, lay, buckets=buckets).admit(
            params, cache, 1, prompt)
        outs.append((logits, dict(_leaves({k: v for k, v in cache.items()
                                           if isinstance(v, dict)}))))
    for logits, leaves in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        for n, a in leaves.items():
            assert torch.equal(a, outs[0][1][n]), n


# --------------------------------------------------------------------------
# the Scheduler against JAX's
# --------------------------------------------------------------------------

# (arch, KV format, layout): every arch and format, both layouts
CELLS = [("gemma3-4b", "bf16", "paged"), ("gemma3-4b", "int8", "slot"),
         ("gemma3-4b", "bgpp", "paged"), ("gemma3-1b", "bf16", "slot"),
         ("gemma3-1b", "bgpp", "paged"), ("deepseek-7b", "bf16", "paged"),
         ("deepseek-7b", "int8", "slot")]
LENS, NEW = (27, 9, 40), 36  # prompts past the window; 36 > 2 x 16 decode steps


def _prompts(seed, lens, prefix=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 512, (prefix,)).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, 512, (n,)).astype(np.int32)])
            for n in lens]


def _run_jax(jcfg, jparams, fmt, layout, prompts, new, admission="chunked"):
    lay = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    sched = JScheduler(jparams, jcfg, lay, chunk_budget=BUDGET, record_logits=True,
                       admission=admission)
    for i, p in enumerate(prompts):
        sched.submit(JRequest(rid=i, prompt=p, max_new_tokens=new, arrival_step=i))
    stats = sched.run(max_steps=2000)
    return stats, {r.rid: r for r in sched.finished}


def _run_torch(cfg, params, fmt, layout, prompts, new, forced=None, admission="chunked",
               slots=SLOTS, arrivals=None):
    lay = tkvc.layout_for(cfg, slots, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    sched = Scheduler(params, cfg, lay, device="cpu", chunk_budget=BUDGET,
                      record_logits=True, admission=admission)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=new,
                             arrival_step=i if arrivals is None else arrivals[i],
                             forced_tokens=None if forced is None else np.asarray(forced[i])))
    stats = sched.run(max_steps=2000)
    if sched.pager is not None:
        sched.pager.check()
        assert sched.pager.pages_in_use == 0
    return stats, {r.rid: r for r in sched.finished}


def _check_against_jax(fmt, jstats, jreq, tstats, treq):
    assert sorted(treq) == sorted(jreq)
    err = max(float(np.abs(np.stack(treq[i].logit_rows)
                           - np.stack(jreq[i].logit_rows)).max()) for i in jreq)
    for i in jreq:
        assert treq[i].generated == jreq[i].generated, i
    assert err <= (1e-4 if fmt == "bf16" else TF_TOL), err
    for key in ("decode_bytes", "prefill_bytes", "decode_steps", "decode_bytes_per_step",
                "decode_bf16_equiv_bytes_per_step"):
        assert tstats["kv_read"][key] == jstats["kv_read"][key], key
    # the bgpp plan, where a global layer runs it (a stack of rings has none)
    assert tstats["kv_read"].get("bgpp") == jstats["kv_read"].get("bgpp")
    for key in ("decode_bytes", "prefill_bytes", "decode_bytes_per_step",
                "decode_bf16_equiv_bytes_per_step", "per_projection"):
        assert tstats["weight_read"][key] == jstats["weight_read"][key], key
    assert tstats["steps"] == jstats["steps"]


@pytest.mark.parametrize("arch,fmt,layout", CELLS)
def test_scheduler_matches_jax(arch, fmt, layout):
    jcfg, cfg, jparams, tparams = _model(arch, keep_all=True)
    prompts = _prompts(1, LENS)
    jstats, jreq = _run_jax(jcfg, jparams, fmt, layout, prompts, NEW)
    forced = None if fmt == "bf16" else {i: r.generated for i, r in jreq.items()}
    tstats, treq = _run_torch(cfg, tparams, fmt, layout, prompts, NEW, forced)
    _check_against_jax(fmt, jstats, jreq, tstats, treq)


@pytest.mark.parametrize("arch,fmt,layout", [("gemma3-4b", "bf16", "paged"),
                                             ("gemma3-1b", "int8", "slot")])
def test_eager_scheduler_matches_jax(arch, fmt, layout):
    """Eager admission: one whole-prompt forward (sliding windows on the
    local layers) into a live slot, the rings written from it."""
    jcfg, cfg, jparams, tparams = _model(arch, keep_all=True)
    prompts = _prompts(2, (27, 9))
    jstats, jreq = _run_jax(jcfg, jparams, fmt, layout, prompts, 20, admission="eager")
    forced = None if fmt == "bf16" else {i: r.generated for i, r in jreq.items()}
    tstats, treq = _run_torch(cfg, tparams, fmt, layout, prompts, 20, forced,
                              admission="eager")
    _check_against_jax(fmt, jstats, jreq, tstats, treq)


def test_weight_read_matches_jax_in_every_format():
    """``weight_read`` of the zoo's projections, the untied head and the
    tied ``embed.T`` included, equal to the reference's plan; the qk-norm
    and sandwich-norm leaves pass through untouched."""
    from repro.configs import apply_weight_format_override as japply

    for arch in ZOO:
        jcfg, cfg, jparams, tparams = _model(arch)
        jl = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format="bf16")
        for fmt in ("bf16", "int8", "bstc"):
            _, jplan = jswt.prepare_serve_params(jparams, japply(jcfg, fmt), jl)
            serve, tplan = tswt.prepare_serve_params(tparams, cfg, fmt)
            want, got = jplan.decode_read_bytes(jl, jcfg), tplan.decode_read_bytes()
            for key in ("format", "total", "bf16_equiv", "int8_equiv", "per_projection"):
                assert got[key] == want[key], (arch, fmt, key)
            assert got["modeled"] == pytest.approx(want["modeled"], rel=1e-9)
            for n, leaf in _leaves(serve):
                if "norm" in n:
                    assert leaf is dict(_leaves(tparams))[n], n


def test_prefix_reuse_is_off_on_a_local_stack():
    """A shared system prompt: no prefix hit on gemma3's ring stack (a ring
    cannot skip its prefill), as in the reference, the same tokens as JAX;
    deepseek-7b (global layers only) still hits."""
    prompts = _prompts(3, (5, 7, 4), prefix=16)
    for arch, hits in (("gemma3-4b", False), ("deepseek-7b", True)):
        jcfg, cfg, jparams, tparams = _model(arch)
        jstats, jreq = _run_jax(jcfg, jparams, "bf16", "paged", prompts, 4)
        tstats, treq = _run_torch(cfg, tparams, "bf16", "paged", prompts, 4)
        assert tstats["paged"]["prefix_hits"] == jstats["paged"]["prefix_hits"]
        assert (tstats["paged"]["prefix_hits"] > 0) == hits
        assert tstats["paged"]["prefix_hit_tokens"] == jstats["paged"]["prefix_hit_tokens"]
        for i in jreq:
            assert treq[i].generated == jreq[i].generated


def test_spec_decode_on_a_local_stack_raises_the_legality_error():
    jcfg, cfg, jparams, tparams = _model("gemma3-4b")
    jl = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format="bf16")
    tl = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bf16")
    with pytest.raises(ValueError, match="rollback-safe") as jerr:
        JScheduler(jparams, jcfg, jl, spec_decode=True)
    with pytest.raises(ValueError, match="rollback-safe") as terr:
        Scheduler(tparams, cfg, tl, device="cpu", spec_decode=True)
    assert str(tl.local_layers) in str(terr.value) and str(jl.local_layers) in str(jerr.value)
    assert not Scheduler(tparams, cfg, tl, device="cpu").spec.enabled


# --------------------------------------------------------------------------
# the port's own invariants on a local stack, bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_joint_equals_alone_and_slot_equals_paged(fmt):
    """Staggered joint runs against each request alone (the same slots),
    and the slot layout against the paged one: tokens and every logit
    bit-identical, with the rings wrapping in prefill and in decode."""
    _, cfg, _, params = _model("gemma3-4b")
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


def test_chunked_equals_whole_prompt():
    """bf16 KV: a prompt in chunks of 4 and in one chunk of 64 lanes give
    the same last logits and cache, bit for bit."""
    _, cfg, _, params = _model("gemma3-4b")
    prompt = _prompts(4, (41,))[0]
    out = []
    for max_chunk in (4, 64):
        lay = tkvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bf16")
        cp = engine.ChunkedPrefill(cfg, lay, buckets=(4, 64))
        logits, cache = cp.admit(params, tkvc.init_cache_arrays(cfg, lay, "cpu"), 1, prompt,
                                 max_chunk=max_chunk)
        out.append((logits, cache))
    assert torch.equal(out[0][0], out[1][0])
    for store in ("global", "local"):
        for n, a in out[0][1][store].items():
            assert torch.equal(a, out[1][1][store][n]), (store, n)
