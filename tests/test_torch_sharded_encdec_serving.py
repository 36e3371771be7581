"""The enc_dec family (whisper) served on ``(data, model)`` meshes through
``engine.make_serve_step``, as the reference serves it, rehearsed on the
CPU in gloo worlds.

The placement moves data only.  The encoder runs on the rank's rows of the
frames and its heads (their outputs gathered over ``"model"`` before the
replicated ``wo``, the MLP replicated); ``whisper.cross_kv`` projects the
rank's kv heads from its columns of ``xattn.wk`` / ``wv`` into its block of
the cross memory, which is slot-major on ``"data"`` in both layouts (it is
not paged) and split by kv heads on ``"model"``; the decode's
self-attention is the dense one on the rank's heads, and its
cross-attention attends the rank's q heads over its cross heads and
gathers them before the replicated ``xattn.wo``.  So a sharded run is the
single-device run's bits.

whisper-smoke (4 heads of 16, 32 encoder frames, vocab 512) from the JAX
package's seeded init, 4 slots, seeded frames; 8 greedy decode steps from
position 0 with slot 1 reset after step 3 and its cross memory refilled
from a new request's frames (encoded by the ranks that hold slot 1); one
spawned world a mesh (1x1, 2x1, 1x2, 2x2, 1x4) runs every case of that
mesh, over bf16 / int8 / bgpp KV and the slot / paged layouts:

  * every rank's encoder memory and cross memory bit-equal to its block of
    the single-device run's, in the local shape ``(L, B / d, Hk / m,
    S_enc, Dh)`` in both layouts;
  * every rank's tokens identical and logits bit-identical to the port's
    single-device run of the same case;
  * each single-device run held to the JAX ``make_serve_step`` (jitted) on
    the same inputs, each side over its own encoder's memory: tokens
    identical, logits within 1e-4 of max |logit|.
"""

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

ARCH = "whisper-medium"
SLOTS, MAX_SEQ, PAGE, STEPS, RESET_AT = 4, 32, 8, 8, 3
JAX_TOL = 1e-4

CASES = {
    (1, 1): [("bf16", "slot"), ("bgpp", "paged")],
    (2, 1): [("bf16", "paged"), ("int8", "slot")],
    (1, 2): [("bgpp", "paged"), ("bf16", "slot")],
    (2, 2): [("int8", "paged"), ("bgpp", "slot")],
    (1, 4): [("bf16", "paged"), ("int8", "slot")],
}
ALL = sorted({c for cs in CASES.values() for c in cs})

_JAX = {}


def _cfg():
    from repro_torch.configs import get_config

    return get_config(ARCH, smoke=True)


def _frames():
    """The slots' frames and, last, the frames of the request that takes
    slot 1 after the reset: ``(SLOTS + 1, S_enc, d_audio)`` f32."""
    cfg = _cfg()
    rng = np.random.default_rng(11)
    return rng.normal(size=(SLOTS + 1, cfg.encoder_seq, cfg.d_audio)).astype(np.float32)


def _first_tokens():
    return np.random.default_rng(5).integers(0, _cfg().vocab_size, (SLOTS,))


def _jax_model():
    """The JAX package's config and seeded init, the parameters as numpy
    (the parent only)."""
    if not _JAX:
        import jax
        import jax.numpy as jnp

        from repro.configs import get_config as jax_config
        from repro.models import model_zoo as jzoo

        jax.config.update("jax_platform_name", "cpu")
        jcfg = jax_config(ARCH, smoke=True)
        tree = jax.tree.map(np.array, jzoo.init(jax.random.key(0), jcfg)[0])
        _JAX.update(cfg=jcfg, params=jax.tree.map(jnp.asarray, tree), numpy=tree)
    return _JAX


def _fill(params, cfg, cache, frames, split, row):
    """Encode ``frames`` on this rank and write their cross K / V into the
    cache's cross memory from ``row``; returns ``(memory, (k, v))``."""
    from repro_torch.models import whisper

    memory = whisper.encode(params, cfg, torch.from_numpy(frames), split)
    k, v = whisper.cross_kv(params, cfg, memory, split)
    cache["cross_k"][:, row:row + k.shape[1]] = k
    cache["cross_v"][:, row:row + v.shape[1]] = v
    return memory, (k, v)


def _trace(params, fmt, layout, rules):
    """One case on this rank -> ``{"memory", "cross", "refill", "logits"
    (STEPS, B, V), "tokens" (STEPS, B), "pos", "shape"}``: the encoder on
    the rank's slots, ``cross_kv`` into its cross memory, then
    :data:`STEPS` greedy steps with slot 1 reset after :data:`RESET_AT` and
    refilled from the last frames row on the ranks that hold it."""
    from repro_torch.models import model_zoo
    from repro_torch.serving import engine, kv_cache as kvc, sharded as shd

    cfg = _cfg()
    frames = _frames()
    lay = kvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    cache = kvc.init_cache_arrays(cfg, lay, "cpu")
    if layout == "paged":
        cache["page_table"] = kvc.identity_page_table(lay, "cpu")
    shard = shd.Shard.of(cfg, lay, rules)
    split = shd.model_split(shard)
    lo, hi = (0, SLOTS) if shard is None else (shard.lo, shard.hi)
    if shard is not None:
        params = shd.shard_params(params, model_zoo.param_specs(cfg), rules, cfg)
        cache = shd.shard_cache(cache, cfg, lay, rules)
    step = engine.make_serve_step(cfg, lay, rules)
    out = {"shape": tuple(cache["cross_k"].shape)}
    with torch.no_grad():
        memory, cross = _fill(params, cfg, cache, frames[lo:hi], split, 0)
        out.update(memory=memory.numpy(), cross=[c.numpy() for c in cross])
        rows = dict(row=1, state_row=1) if shard is None else dict(
            row=shard.row(1), state_row=shard.state_row(1))
        cur, logits, tokens = _first_tokens(), [], []
        for t in range(STEPS):
            if t == RESET_AT:
                cache = kvc.reset_slot(cache, lay, 1, **rows)
                if rows["state_row"] >= 0:
                    _, refill = _fill(params, cfg, cache, frames[SLOTS:], split,
                                      rows["state_row"])
                    out["refill"] = [c.numpy() for c in refill]
            lg, cache = step(params, cache, torch.as_tensor(cur)[:, None])
            logits.append(lg[:, 0].numpy())
            cur = logits[-1].argmax(-1)
            tokens.append(cur)
    out.update(logits=np.stack(logits), tokens=np.stack(tokens),
               pos=cache["pos"].numpy().copy(), lo=lo, hi=hi)
    return out


def _worker(rank, world, mesh, root):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.interop import params_from_numpy
    from repro_torch.serving import sharded as shd

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'store')}",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        rules = shd.rules_for(*mesh, device="cpu")
        with open(os.path.join(root, "params.pkl"), "rb") as f:
            params = params_from_numpy(pickle.load(f), "cpu")
        res = {case: _trace(params, *case, rules) for case in CASES[mesh]}
        res["coords"] = sh.mesh_coords(rules.mesh)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_RESULTS, _BASE = {}, {}


def _sharded(mesh):
    """Every rank's results of one mesh's world (spawned once)."""
    if mesh not in _RESULTS:
        d, m = mesh
        root = tempfile.mkdtemp(prefix=f"encdec-serve-mesh{d}x{m}-")
        with open(os.path.join(root, "params.pkl"), "wb") as f:
            pickle.dump(_jax_model()["numpy"], f)
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
        _BASE[case] = _trace(params_from_numpy(_jax_model()["numpy"], "cpu"), *case, None)
    return _BASE[case]


def _jax_cross(jcfg, jp, mem):
    """The JAX side's stacked cross memory ``(L, B, Hk, S_enc, Dh)`` of
    ``mem``, as the reference's serving test writes it by hand."""
    import jax
    import jax.numpy as jnp

    ks, vs = [], []
    for i in range(jcfg.num_layers):
        p = jax.tree.map(lambda a: a[i], jp["decoder"])
        kv = [(mem @ p["xattn"][w]).reshape(mem.shape[0], -1, jcfg.num_kv_heads, jcfg.head_dim)
              for w in ("wk", "wv")]
        ks.append(jnp.swapaxes(kv[0], 1, 2))
        vs.append(jnp.swapaxes(kv[1], 1, 2))
    return jnp.stack(ks), jnp.stack(vs)


def _jax_trace(case):
    """The JAX ``make_serve_step`` (jitted) on ``case``'s steps over the JAX
    encoder's memory, fed the port's tokens, slot 1 reset and refilled as
    the port's: ``(logits (STEPS, B, V), greedy tokens (STEPS, B))``."""
    import jax
    import jax.numpy as jnp

    from repro.models import whisper as jwhisper
    from repro.serving import engine as jengine, kv_cache as jkvc

    fmt, layout = case
    jcfg, jp = _jax_model()["cfg"], _jax_model()["params"]
    frames = jnp.asarray(_frames())
    mem = jax.jit(lambda p, f: jwhisper.encode(p, jcfg, f))(jp, frames)
    ck, cv = jax.jit(lambda p, m: _jax_cross(jcfg, p, m))(jp, mem)
    lay = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format=fmt, layout=layout, page_size=PAGE)
    cache, _ = jkvc.init_cache(jcfg, lay)
    if layout == "paged":
        cache["page_table"] = jkvc.identity_page_table(lay)
    cache["cross_k"], cache["cross_v"] = ck[:, :SLOTS], cv[:, :SLOTS]
    step = jax.jit(jengine.make_serve_step(jcfg, lay))
    fed = [_first_tokens()] + list(_base(case)["tokens"][:-1])
    logits = []
    for t, cur in enumerate(fed):
        if t == RESET_AT:
            cache = jkvc.reset_slot(cache, lay, 1)
            cache["cross_k"] = cache["cross_k"].at[:, 1].set(ck[:, SLOTS])
            cache["cross_v"] = cache["cross_v"].at[:, 1].set(cv[:, SLOTS])
        lg, cache = step(jp, cache, jnp.asarray(cur, jnp.int32)[:, None])
        logits.append(np.asarray(lg[:, 0]))
    logits = np.stack(logits)
    return logits, logits.argmax(-1)


def _id(case):
    return "-".join(case)


@pytest.mark.parametrize("case", ALL, ids=_id)
def test_single_device_decode_is_the_jax_decode(case):
    """Each case's single-device run, the oracle of the sharded runs,
    against the JAX ``make_serve_step`` on the same inputs: greedy tokens
    identical, logits within 1e-4 of max |logit|, ``pos`` as the trace left
    it (slot 1 reset)."""
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
    """Every rank: its encoder memory the single-device memory's rows of
    its slots, its cross memory (and slot 1's refill, on the ranks that
    hold slot 1) the block of its slots and kv heads, of local shape ``(L,
    B / d, Hk / m, S_enc, Dh)`` in both layouts; its tokens identical and
    logits bit-identical to the single-device run."""
    d, m = mesh
    cfg = _cfg()
    want = _base(case)
    b, h = SLOTS // d, cfg.num_kv_heads // m
    refilled = 0
    for r, rank in enumerate(_sharded(mesh)):
        got, (i, j) = rank[case], (rank["coords"]["data"], rank["coords"]["model"])
        assert got["shape"] == (cfg.num_layers, b, h, cfg.encoder_seq, cfg.head_dim), got["shape"]
        assert (got["lo"], got["hi"]) == (i * b, (i + 1) * b)
        assert np.array_equal(got["memory"], want["memory"][i * b:(i + 1) * b]), (mesh, case, r)
        for name, g, w in zip(("k", "v"), got["cross"], want["cross"]):
            assert np.array_equal(g, w[:, i * b:(i + 1) * b, j * h:(j + 1) * h]), (name, r)
        if "refill" in got:
            refilled += 1
            assert i == 1 // b
            for g, w in zip(got["refill"], want["refill"]):
                assert np.array_equal(g, w[:, :, j * h:(j + 1) * h]), (mesh, case, r)
        np.testing.assert_array_equal(got["tokens"], want["tokens"], err_msg=f"rank {r}")
        assert np.array_equal(got["logits"], want["logits"]), (
            mesh, case, r, float(np.abs(got["logits"] - want["logits"]).max()))
        np.testing.assert_array_equal(got["pos"], want["pos"])
    assert refilled == m  # the model ranks of the data rank that holds slot 1


def test_cross_memory_placement_is_slot_major_in_both_layouts():
    """The cross memory's spec on a 2x2 mesh is ``(None, data, model, None,
    None)`` in the paged layout as in the slot layout, where the paged KV
    pool is whole on every data rank; a batch the data axis does not divide
    keeps it whole over ``"data"``, as the mamba state."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.serving import kv_cache as kvc, sharded as shd

    cfg = _cfg()
    rules = sh.ShardingRules(mesh={"data": 2, "model": 2})
    for layout in ("slot", "paged"):
        lay = kvc.layout_for(cfg, SLOTS, MAX_SEQ, layout=layout, page_size=PAGE)
        specs = shd.cache_shardings(kvc.init_cache_arrays(cfg, lay, "meta"), cfg, lay, rules)
        assert specs["cross_k"] == specs["cross_v"] == (None, "data", "model", None, None)
        pool = specs["global"]["k"]
        assert ("data" in pool) == (layout == "slot"), pool
    lay = kvc.layout_for(cfg, 3, MAX_SEQ, layout="paged", page_size=PAGE)
    specs = shd.cache_shardings(kvc.init_cache_arrays(cfg, lay, "meta"), cfg, lay, rules)
    assert specs["cross_k"] == (None, None, "model", None, None)
