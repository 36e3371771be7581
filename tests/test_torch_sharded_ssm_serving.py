"""The ssm and hybrid families served on ``(data, model)`` meshes through
``engine.make_serve_step``, as the reference serves them, rehearsed on the
CPU in gloo worlds.

The placement moves data only: each rank's mamba mixers take their heads'
``z``, ``x`` and ``dt`` columns of ``in_proj`` (``B`` / ``C`` whole), step
their heads of the state and gather the gated product over ``"model"``
before the replicated norm and ``out_proj``; jamba's attention layer keeps
the dense head split (4 q / 2 kv heads: split over 2 ranks, replicated
with the warning over 4, where the mixers' 4 heads still split), its MoE
layers the replicated experts routing dropless on the rank's slots.  So a
sharded decode is the single-device run's bits.

mamba2-smoke and jamba-smoke (keep-all BGPP) from the JAX package's seeded
init (the mixers' ``A_log``, ``D`` and ``dt_bias`` drawn head by head), 4
slots, 8 greedy decode steps from a zero state with slot 1 reset after
step 3 (through the rank's rows of the sharded state); one spawned world a
mesh (1x1, 2x1, 1x2, 2x2, 1x4) runs every case of that mesh:

  * every rank's tokens identical and logits bit-identical to the port's
    single-device run of the same case;
  * each single-device run held to the JAX ``make_serve_step`` on the same
    inputs: tokens identical, logits within 1e-4 of max |logit|;
  * the local shapes of layer 0's mixer and state are the head split's.
"""

import dataclasses
import datetime
import os
import pickle
import tempfile
import warnings

import numpy as np
import pytest
import torch

from test_torch_sharded_training import spawn_world

torch.set_num_threads(1)

MAMBA, JAMBA = "mamba2-1.3b", "jamba-1.5-large-398b"
SLOTS, MAX_SEQ, PAGE, STEPS, RESET_AT = 4, 32, 8, 8, 3
KEEP_ALL = dict(bgpp_rounds=4, bgpp_keep_ratio=1.0)
JAX_TOL = 1e-4

# (arch, KV format, layout) of each mesh: slot and paged layouts and every
# KV format of jamba's attention layer, mamba2 at every mesh
CASES = {
    (1, 1): [(MAMBA, "bf16", "slot"), (JAMBA, "bf16", "slot")],
    (2, 1): [(MAMBA, "bf16", "slot"), (JAMBA, "bf16", "paged"), (JAMBA, "int8", "slot")],
    (1, 2): [(MAMBA, "bf16", "paged"), (JAMBA, "bgpp", "paged"), (JAMBA, "bf16", "slot")],
    (2, 2): [(MAMBA, "bf16", "slot"), (JAMBA, "int8", "paged"), (JAMBA, "bgpp", "slot")],
    (1, 4): [(MAMBA, "bf16", "slot"), (JAMBA, "bf16", "paged")],
}
ALL = sorted({c for cs in CASES.values() for c in cs})

_JAX = {}


def _cfg(arch):
    from repro_torch.configs import MCBPOptions, get_config

    return dataclasses.replace(get_config(arch, smoke=True), mcbp=MCBPOptions(**KEEP_ALL))


def _jax_model(arch):
    """The JAX package's config and seeded init of ``arch``'s smoke config
    (keep-all BGPP), its mixers' ``A_log``, ``D`` and ``dt_bias`` drawn
    head by head (the init makes every head's alike, which would hide a
    rank taking another rank's heads), and the parameters as numpy (the
    parent only)."""
    if arch not in _JAX:
        import jax
        import jax.numpy as jnp

        from repro.configs import MCBPOptions as JMCBP, get_config as jax_config
        from repro.models import model_zoo as jzoo

        jax.config.update("jax_platform_name", "cpu")
        jcfg = dataclasses.replace(jax_config(arch, smoke=True), mcbp=JMCBP(**KEEP_ALL))
        tree = jax.tree.map(np.array, jzoo.init(jax.random.key(0), jcfg)[0])
        rng = np.random.default_rng(3)
        mixers = ([tree["layers"]["mixer"]] if arch == MAMBA else
                  [b["mamba"] for b in tree["blocks"].values() if "mamba" in b])
        for mixer in mixers:
            for k in ("A_log", "D", "dt_bias"):
                mixer[k] = (rng.normal(size=mixer[k].shape) * 0.5).astype(np.float32)
        _JAX[arch] = dict(cfg=jcfg, params=jax.tree.map(jnp.asarray, tree), numpy=tree)
    return _JAX[arch]


def _first_tokens(cfg):
    return np.random.default_rng(5).integers(0, cfg.vocab_size, (SLOTS,))


def _trace(arch, params, fmt, layout, rules):
    """One case on this rank: :data:`STEPS` greedy steps of every slot
    from a zero state, slot 1 reset after step :data:`RESET_AT` ->
    ``{"logits" (STEPS, B, V), "tokens" (STEPS, B), "shapes", "warned"}``."""
    from repro_torch.models import model_zoo
    from repro_torch.serving import engine, kv_cache as kvc, sharded as shd

    cfg = _cfg(arch)
    lay = kvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    cache = kvc.init_cache_arrays(cfg, lay, "cpu")
    if layout == "paged" and lay.global_layers:
        cache["page_table"] = kvc.identity_page_table(lay, "cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shard = shd.Shard.of(cfg, lay, rules)
        if shard is not None:
            params = shd.shard_params(params, model_zoo.param_specs(cfg), rules, cfg)
            cache = shd.shard_cache(cache, cfg, lay, rules)
        step = engine.make_serve_step(cfg, lay, rules)
    rows = dict(row=1, state_row=1) if shard is None else dict(row=shard.row(1),
                                                                state_row=shard.state_row(1))
    cur, logits, tokens = _first_tokens(cfg), [], []
    with torch.no_grad():
        for t in range(STEPS):
            if t == RESET_AT:
                cache = kvc.reset_slot(cache, lay, 1, **rows)
            lg, cache = step(params, cache, torch.as_tensor(cur)[:, None])
            logits.append(lg[:, 0].numpy())
            cur = logits[-1].argmax(-1)
            tokens.append(cur)
    mixer = (params["layers"]["mixer"] if cfg.family == "ssm"
             else params["blocks"]["pos0"]["mamba"])
    shapes = {n: tuple(mixer[n].shape) for n in ("in_proj", "conv_w", "out_proj")}
    shapes.update({f"state {n}": tuple(a.shape) for n, a in cache["mamba"].items()})
    warned = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    return {"logits": np.stack(logits), "tokens": np.stack(tokens), "shapes": shapes,
            "warned": warned, "pos": cache["pos"].numpy().copy()}


def _worker(rank, world, mesh, root):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    import torch.distributed as dist

    from repro_torch.interop import params_from_numpy
    from repro_torch.serving import sharded as shd

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'store')}",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        rules = shd.rules_for(*mesh, device="cpu")
        with open(os.path.join(root, "params.pkl"), "rb") as f:
            trees = pickle.load(f)
        params = {a: params_from_numpy(t, "cpu") for a, t in trees.items()}
        res = {case: _trace(case[0], params[case[0]], case[1], case[2], rules)
               for case in CASES[mesh]}
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_RESULTS, _BASE = {}, {}


def _sharded(mesh):
    """Every rank's results of one mesh's world (spawned once)."""
    if mesh not in _RESULTS:
        d, m = mesh
        root = tempfile.mkdtemp(prefix=f"ssm-serve-mesh{d}x{m}-")
        with open(os.path.join(root, "params.pkl"), "wb") as f:
            pickle.dump({a: _jax_model(a)["numpy"] for a in (MAMBA, JAMBA)}, f)
        spawn_world(d * m, _worker, (mesh, root), root)
        ranks = []
        for r in range(d * m):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        _RESULTS[mesh] = ranks
    return _RESULTS[mesh]


def _base(case):
    """The port's single-device run of ``case``."""
    from repro_torch.interop import params_from_numpy

    if case not in _BASE:
        arch, fmt, layout = case
        params = params_from_numpy(_jax_model(arch)["numpy"], "cpu")
        _BASE[case] = _trace(arch, params, fmt, layout, None)
    return _BASE[case]


def _jax_trace(case):
    """The JAX ``make_serve_step`` (jitted) on ``case``'s steps, fed the
    port's tokens: ``(logits (STEPS, B, V), greedy tokens (STEPS, B))``."""
    import jax
    import jax.numpy as jnp

    from repro.serving import engine as jengine, kv_cache as jkvc

    arch, fmt, layout = case
    jcfg, jparams = _jax_model(arch)["cfg"], _jax_model(arch)["params"]
    lay = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    cache, _ = jkvc.init_cache(jcfg, lay)
    if layout == "paged" and lay.global_layers:
        cache["page_table"] = jkvc.identity_page_table(lay)
    step = jax.jit(jengine.make_serve_step(jcfg, lay))
    fed = [_first_tokens(_cfg(arch))] + list(_base(case)["tokens"][:-1])
    logits = []
    for t, cur in enumerate(fed):
        if t == RESET_AT:
            cache = jkvc.reset_slot(cache, lay, 1)
        lg, cache = step(jparams, cache, jnp.asarray(cur, jnp.int32)[:, None])
        logits.append(np.asarray(lg[:, 0]))
    logits = np.stack(logits)
    return logits, logits.argmax(-1)


def _id(case):
    return "-".join((case[0].split("-")[0],) + case[1:])


@pytest.mark.parametrize("case", ALL, ids=_id)
def test_single_device_decode_is_the_jax_decode(case):
    """Each case's single-device run, the oracle of the sharded runs,
    against the JAX ``make_serve_step`` on the same inputs: greedy tokens
    identical, logits within 1e-4 of max |logit|, and ``pos`` as the trace
    left it (slot 1 reset)."""
    got = _base(case)
    logits, tokens = _jax_trace(case)
    np.testing.assert_array_equal(got["tokens"], tokens)
    err = float(np.abs(got["logits"] - logits).max())
    assert err <= JAX_TOL * float(np.abs(logits).max()), (case, err)
    np.testing.assert_array_equal(got["pos"], [STEPS, STEPS - RESET_AT, STEPS, STEPS])


@pytest.mark.parametrize("mesh,case", [
    pytest.param(mesh, c, id=f"{mesh[0]}x{mesh[1]}-" + _id(c))
    for mesh, cs in CASES.items() for c in cs])
def test_sharded_decode_is_the_single_device_decode(mesh, case):
    """Every rank's tokens identical and logits bit-identical to the
    single-device run, and layer 0's mixer and state cut by heads: ``z``,
    ``x`` and ``dt`` columns and ``x`` channels split over ``"model"``,
    ``B`` / ``C`` whole, ``out_proj`` whole, the state's slots split over
    ``"data"``."""
    d, m = mesh
    want = _base(case)
    cfg = _cfg(case[0])
    d_in, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    H, P, K = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_conv
    L = 3 if case[0] == MAMBA else 7
    for r, rank in enumerate(_sharded(mesh)):
        got = rank[case]
        np.testing.assert_array_equal(got["tokens"], want["tokens"], err_msg=f"rank {r}")
        assert np.array_equal(got["logits"], want["logits"]), (
            mesh, case, r, float(np.abs(got["logits"] - want["logits"]).max()))
        np.testing.assert_array_equal(got["pos"], want["pos"])
        stacked = (L,) if case[0] == MAMBA else (1,)
        assert got["shapes"] == {
            "in_proj": stacked + (cfg.d_model, 2 * d_in // m + 2 * N + H // m),
            "conv_w": stacked + (K, d_in // m + 2 * N),
            "out_proj": stacked + (d_in, cfg.d_model),
            "state h": (L, SLOTS // d, H // m, P, N),
            "state conv": (L, SLOTS // d, K - 1, d_in // m + 2 * N)}, (mesh, case)


def test_attention_heads_replicate_where_the_mixers_split():
    """jamba-smoke on 1x4: its 4 q / 2 kv attention heads do not divide 4
    and replicate (warning), its 4 mamba heads split, one a rank; no
    warning about the mixers."""
    got = _sharded((1, 4))[0][(JAMBA, "bf16", "paged")]
    assert any("heads (4 q, 2 kv)" in w for w in got["warned"]), got["warned"]
    assert not any("mamba" in w for w in got["warned"]), got["warned"]
    assert got["shapes"]["state h"][2] == 1
