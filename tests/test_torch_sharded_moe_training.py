"""The MoE and VLM families' sharded train step on ``torch.distributed``,
held to the JAX package's train step on a CPU mesh of the same shape,
rehearsed on the CPU in gloo worlds.

The reference's MoE dispatch is group-local: on a mesh each of the
``gcd(B, data)`` groups of contiguous rows gets its own capacity
(``src/repro/models/moe.py:78-90``), so once tokens drop the oracle of a
sharded MoE step is the JAX step on a mesh of the same shape, not the
one-device step.  The MoE configs here run at ``moe_capacity_factor`` 1.0,
where tokens drop (the smoke configs' 8.0 drops none, and there the two
oracles agree).  The JAX side runs in a subprocess with forced host
devices (as ``tests/test_multidevice.py`` runs it), one subprocess a mesh
for all its cases, under ``rules_for_mesh(mesh, fsdp_axes=..., sp=model >
1)``, the reference launcher's rules; the port runs one spawned gloo world
a mesh (``test_torch_sharded_training.spawn_world``).  The bounds are the
sharded dense step's (``test_torch_sharded_training.check_against_jax``:
metrics 1e-5 relative, parameters and the first step's grads 1e-4 of each
leaf's max, int8 codes within one step on a few codes a leaf), with the
MoE's aux beside the loss; every leaf replicated over ``"model"`` (the
router among them) and its gradient are bit-equal on every model rank.

Here: meshes 1x1 and 2x1 of mixtral-smoke (4 experts top-2, sliding
windows) and llama4-scout-smoke (4 experts top-1, a shared expert,
chunked-local layers), f32 and int8 moments, with and without FSDP, one
case with ``grad_accum`` 2; ``moe_apply`` alone on the two data ranks'
rows against the JAX ``moe_apply`` on the 2x1 mesh (y within 1e-5, aux
within 1e-6 relative), the same inputs as one group missing it by more;
and a 1x1 world bit-identical to the port's one-device step.  Meshes 1x2
and 2x2, paligemma-smoke and the checkpoint are in
``tests/test_torch_sharded_moe_training_wide.py``.
"""

import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

from test_torch_sharded_training import (B, KW, METRIC_REL, OPT, S, STEPS, Case,
                                         check_against_jax, spawn_world, unequal_over_model)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIX, SCOUT, PALI = "mixtral-8x22b", "llama4-scout-17b-a16e", "paligemma-3b"
CF = 1.0  # tokens drop: the grouping shows
Y_ABS, AUX_REL = 1e-5, 1e-6  # moe_apply on the ranks' rows against the JAX mesh's
# int8 moment scales: an absmax of a moment whose largest element is a sum
# over the batch's tokens; llama4-scout-smoke's wk m scale (6.2e-6) sits
# 1.17e-6 relative from JAX's in the port's one-device step already (the
# 1x1 world is its bits), past the dense tests' 1e-6
MOE_SCALE_REL = 1e-5


def port_cfg(arch):
    """The port's smoke config of ``arch`` (an MoE one at capacity factor
    :data:`CF`)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, moe_capacity_factor=CF) if cfg.num_experts else cfg


def batches(cfg):
    """The global batches of every step (numpy), a VLM's with its image
    prefix stub."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import modality

    ds = SyntheticLMDataset(cfg.vocab_size, S, B, seed=1, modality=modality(cfg))
    return [ds.batch(i) for i in range(STEPS)]


def moe_input(arch):
    """``moe_apply``'s input: B x S tokens of width d_model (numpy)."""
    cfg = port_cfg(arch)
    return np.random.default_rng(7).normal(size=(B, S, cfg.d_model)).astype(np.float32)


# --------------------------------------------------------------------------
# the JAX oracle: one subprocess a mesh, forced host devices
# --------------------------------------------------------------------------

JAX_CODE = r"""
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.distributed import sharding as jsh
from repro.models import model_zoo as jzoo, moe as jmoe
from repro.optim import adamw as jadamw
from repro.training import train_step as jts

job = pickle.load(open(sys.argv[1], "rb"))
d, m = job["mesh"]
mesh = Mesh(np.asarray(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
flat = lambda t, p="": ({k: v for kk, vv in t.items()
                         for k, v in flat(vv, f"{p}{kk}|").items()} if isinstance(t, dict)
                        else {p[:-1]: np.asarray(t)})
out = {"cases": {}, "moe": {}}
for key, c in job["cases"].items():
    cfg = dataclasses.replace(get_config(c["arch"], smoke=True), **c.get("replace", {}))
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=job["cf"])
    params, specs = jzoo.init(jax.random.key(0), cfg)
    rules = (jsh.rules_for_mesh(mesh, fsdp_axes=(jsh.D_MODEL,) if c["fsdp"] else (),
                                sp=c.get("sp", m > 1))
             if c["on_mesh"] else jsh.ShardingRules())
    # a case may bring its own config fields, sp, fwd_kw, AdamW settings and batches
    kw = c.get("kw") or job["kw"]
    opt = jadamw.AdamWConfig(state_dtype=c["state_dtype"], **(c.get("opt") or job["opt"]))
    bs = [{k: jnp.asarray(v) for k, v in b.items()}
          for b in (c.get("batches") or job["batches"][c["arch"]])]
    res = {}
    if c["grad_accum"] == 1:
        loss_fn = jts.make_loss_fn(cfg, rules, kw)
        res["grads"] = flat(jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))(params, bs[0]))
    step = jax.jit(jts.make_train_step(cfg, rules, opt, kw, grad_accum=c["grad_accum"],
                                       param_specs=specs))
    state = {"params": params, "opt": jadamw.adamw_init(params, opt)}
    res["metrics"] = []
    for b in bs:
        state, mt = step(state, b)
        res["metrics"].append({k: float(mt[k]) for k in ("loss", "ce", "aux", "grad_norm")})
    res["params"], res["opt"] = flat(state["params"]), flat(state["opt"])
    out["cases"][key] = res
for arch, x in job["moe"].items():
    cfg = dataclasses.replace(get_config(arch, smoke=True), moe_capacity_factor=job["cf"])
    params, _ = jzoo.init(jax.random.key(0), cfg)
    p0 = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    rules = jsh.rules_for_mesh(mesh, sp=m > 1)
    grouped = jax.jit(lambda p, x: jmoe.moe_apply(p, x, cfg, rules=rules))(p0, jnp.asarray(x))
    one = jax.jit(lambda p, x: jmoe.moe_apply(p, x, cfg))(p0, jnp.asarray(x))
    out["moe"][arch] = {"y": np.asarray(grouped[0]), "aux": float(grouped[1]),
                        "y_one": np.asarray(one[0]), "aux_one": float(one[1])}
pickle.dump(out, open(sys.argv[2], "wb"))
"""

_JAX = {}


def on_mesh(case):
    """Whether ``case``'s oracle is the JAX step on the mesh (an MoE arch)
    or the one-device step (the VLM: no MoE, so no grouping)."""
    return case.arch != PALI


def jax_mesh(mesh, cases, moe_archs=()):
    """The JAX oracle of every case of ``mesh`` (and ``moe_apply`` of
    ``moe_archs`` on it), computed in one subprocess with ``data * model``
    forced host devices."""
    if mesh not in _JAX:
        d, m = mesh
        job = {"mesh": mesh, "cf": CF, "opt": OPT, "kw": KW,
               "batches": {c.arch: batches(port_cfg(c.arch)) for c in cases},
               "cases": {i: dict(arch=c.arch, state_dtype=c.state_dtype, fsdp=c.fsdp,
                                 grad_accum=c.grad_accum, on_mesh=on_mesh(c))
                         for i, c in enumerate(cases)},
               "moe": {a: moe_input(a) for a in moe_archs}}
        root = tempfile.mkdtemp(prefix=f"jax-mesh{d}x{m}-")
        with open(os.path.join(root, "job.pkl"), "wb") as f:
            pickle.dump(job, f)
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={d * m}",
                   PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
        run = subprocess.run([sys.executable, "-c", JAX_CODE, os.path.join(root, "job.pkl"),
                              os.path.join(root, "out.pkl")], env=env, capture_output=True,
                             text=True, timeout=600)
        assert run.returncode == 0, run.stderr[-3000:]
        with open(os.path.join(root, "out.pkl"), "rb") as f:
            out = pickle.load(f)
        out["cases"] = {c: out["cases"][i] for i, c in enumerate(cases)}
        _JAX[mesh] = out
    return _JAX[mesh]


def jax_params(arch):
    """The JAX package's seeded init of ``arch``'s smoke config (numpy)."""
    from test_torch_sharded_training import jax_params as init

    return init(arch)


# --------------------------------------------------------------------------
# one rank of a world
# --------------------------------------------------------------------------


def run_case(case, rules, numpy_params):
    """One case on this rank: the first step's grads and two sharded
    steps, gathered whole on every rank (rank 0 keeps them)."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_loss_fn, make_train_step
    from repro_torch.training.sharded import TrainShard
    from repro_torch.training.train_step import loss_and_grads
    from repro_torch.utils.tree import tree_items

    cfg = port_cfg(case.arch)
    opt_cfg = AdamWConfig(state_dtype=case.state_dtype, **OPT)
    shard = TrainShard.of(cfg, rules)
    params = shard.shard_params(params_from_numpy(numpy_params, "cpu"))
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    bs = [shard.local_rows({k: torch.from_numpy(v) for k, v in b.items()})
          for b in batches(cfg)]
    model_group = rules.mesh.get_group("model")
    res = {}
    if case.grad_accum == 1:
        _, _, grads = loss_and_grads(make_loss_fn(cfg, KW, shard), state["params"], bs[0])
        grads = shard.sync_grads(grads)
        res["grads_replicated_unequal"] = unequal_over_model(shard, grads, model_group)
        res["grads"] = dict(tree_items(shard.gather_whole(grads)))
    step = make_train_step(cfg, opt_cfg, KW, grad_accum=case.grad_accum, rules=rules)
    res["metrics"] = []
    for b in bs:
        state, mt = step(state, b)
        res["metrics"].append({k: mt[k].item() for k in ("loss", "ce", "aux", "grad_norm")})
    res["params_replicated_unequal"] = unequal_over_model(shard, state["params"], model_group)
    res["params"] = dict(tree_items(shard.gather_whole(state["params"])))
    res["opt"] = dict(tree_items(shard.gather_whole(state["opt"], shard.opt_specs(opt_cfg))))
    return res


def run_moe_apply(arch, rules, numpy_params):
    """``moe_apply`` of layer 0 on this rank's rows (its sequence rows
    under ``sp``) and FF shard -> ``(y gathered whole, aux)``."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import moe
    from repro_torch.training.sharded import TrainShard

    cfg = port_cfg(arch)
    shard = TrainShard.of(cfg, rules)
    local = shard.shard_params(params_from_numpy(numpy_params, "cpu"))
    p0 = {k: (v[0] if not isinstance(v, dict) else {n: t[0] for n, t in v.items()})
          for k, v in local["layers"]["moe"].items()}
    kw = shard.forward_kwargs(S)
    split = kw["split"]
    x = torch.from_numpy(moe_input(arch))
    x = shard.local_rows({"tokens": x})["tokens"]
    if split.seq:
        x = sh.own_block(x, split.group, 1)
    with torch.no_grad():
        y, aux = moe.moe_apply(p0, x, cfg, split=split, data=kw["data"])
    if split.seq:
        y = sh.all_gather(y, split.group, 1)
    return sh.all_gather(y, shard.data_group, 0).numpy(), aux.item()


def worker(rank, world, mesh, cases, moe_archs, root):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'store')}",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        with open(os.path.join(root, "params.pkl"), "rb") as f:
            numpy_params = pickle.load(f)
        d, m = mesh
        debug = make_debug_mesh(d, m, "cpu")
        out = {"cases": {}, "moe": {}}
        for case in cases:
            rules = sh.rules_for_mesh(debug, fsdp_axes=(sh.D_MODEL,) if case.fsdp else (),
                                      sp=m > 1)
            out["cases"][case] = run_case(case, rules, numpy_params[case.arch])
        for arch in moe_archs:
            out["moe"][arch] = run_moe_apply(arch, sh.rules_for_mesh(debug, sp=m > 1),
                                             numpy_params[arch])
        if rank == 0:
            with open(os.path.join(root, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


_RESULTS = {}


def sharded(mesh, cases, moe_archs=()):
    """Every case's results of one mesh's world (spawned once)."""
    if mesh not in _RESULTS:
        d, m = mesh
        root = tempfile.mkdtemp(prefix=f"moe-train-mesh{d}x{m}-")
        archs = {c.arch for c in cases} | set(moe_archs)
        with open(os.path.join(root, "params.pkl"), "wb") as f:
            pickle.dump({a: jax_params(a) for a in archs}, f)
        spawn_world(d * m, worker, (mesh, cases, tuple(moe_archs), root), root)
        with open(os.path.join(root, "out.pkl"), "rb") as f:
            _RESULTS[mesh] = pickle.load(f)
    return _RESULTS[mesh]


def check_case(mesh, case, cases, moe_archs=()):
    """``case`` of ``mesh``'s world against its JAX oracle: the sharded
    dense step's bounds, and the aux metric within 1e-5 relative."""
    got = sharded(mesh, cases, moe_archs)["cases"][case]
    want = jax_mesh(mesh, cases, moe_archs)["cases"][case]
    check_against_jax(mesh, case, got, want, scale_rel=MOE_SCALE_REL)
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert abs(g["aux"] - w["aux"]) <= METRIC_REL * abs(w["aux"]), (mesh, case, i)
    return got, want


def check_moe_apply(mesh, arch, cases, moe_archs):
    """The ranks' ``moe_apply`` against the JAX mesh's group-local one (y
    within :data:`Y_ABS`, aux within :data:`AUX_REL` relative), and the
    same inputs as one group (JAX without rules) shown to miss it."""
    y, aux = sharded(mesh, cases, moe_archs)["moe"][arch]
    want = jax_mesh(mesh, cases, moe_archs)["moe"][arch]
    err = float(np.abs(y - want["y"]).max())
    assert err <= Y_ABS, (mesh, arch, err)
    assert abs(aux - want["aux"]) <= AUX_REL * abs(want["aux"]), (mesh, arch, aux, want["aux"])
    assert float(np.abs(want["y_one"] - want["y"]).max()) > Y_ABS, (mesh, arch)
    return err


MESHES = {
    (1, 1): (Case(MIX, fsdp=True), Case(SCOUT, "int8")),
    (2, 1): (Case(MIX), Case(SCOUT, "int8", fsdp=True), Case(MIX, grad_accum=2),
             Case(SCOUT, fsdp=True)),
}
MOE_APPLY = {(2, 1): (MIX, SCOUT)}


def _ids(v):
    if isinstance(v, tuple):
        return "x".join(map(str, v))
    return str(v)


@pytest.mark.parametrize("mesh,i", [(m, i) for m, cs in MESHES.items() for i in range(len(cs))],
                         ids=_ids)
def test_sharded_moe_train_step_matches_jax_on_the_mesh(mesh, i):
    check_case(mesh, MESHES[mesh][i], MESHES[mesh], MOE_APPLY.get(mesh, ()))


@pytest.mark.parametrize("mesh,arch", [(m, a) for m, archs in MOE_APPLY.items() for a in archs],
                         ids=_ids)
def test_moe_apply_on_the_ranks_rows_is_the_group_local_dispatch(mesh, arch):
    check_moe_apply(mesh, arch, MESHES[mesh], MOE_APPLY[mesh])


@pytest.mark.parametrize("i", range(len(MESHES[(1, 1)])))
def test_one_rank_mesh_is_the_one_device_step(i):
    """A 1x1 world (every gather and sum of FSDP, the MoE's combine and its
    aux over groups of one) gives the port's one-device step's bits."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_loss_fn, make_train_step
    from repro_torch.training.train_step import loss_and_grads
    from repro_torch.utils.tree import tree_items

    case = MESHES[(1, 1)][i]
    res = sharded((1, 1), MESHES[(1, 1)])["cases"][case]
    cfg = port_cfg(case.arch)
    opt_cfg = AdamWConfig(state_dtype=case.state_dtype, **OPT)
    params = params_from_numpy(jax_params(case.arch), "cpu")
    bs = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches(cfg)]
    _, _, grads = loss_and_grads(make_loss_fn(cfg, KW), params, bs[0])
    assert all(torch.equal(res["grads"][k], g) for k, g in tree_items(grads))
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    step = make_train_step(cfg, opt_cfg, KW)
    for b, got in zip(bs, res["metrics"]):
        state, m = step(state, b)
        assert all(got[k] == m[k].item() for k in got), (got, m)
    assert all(torch.equal(res["params"][k], p) for k, p in tree_items(state["params"]))
    assert all(torch.equal(res["opt"][k], x) for k, x in tree_items(state["opt"]))


def test_a_batch_the_data_axis_does_not_divide_is_refused():
    """Where ``"data"`` does not divide the batch, the reference's MoE
    groups (``gcd(B, data)``) would cross ranks: ``local_rows`` refuses it
    rather than compute another grouping."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.training.sharded import TrainShard

    cfg = port_cfg(MIX)

    class _Mesh:  # the shape and coordinates a DeviceMesh gives, without a world
        mesh_dim_names = ("data", "model")
        shape = (4, 1)

        @staticmethod
        def get_local_rank(axis):
            return 0

        @staticmethod
        def get_group(axis):
            return None

    shard = TrainShard.of(cfg, sh.rules_for_mesh(_Mesh()))
    rows = shard.local_rows({"tokens": torch.zeros((8, S), dtype=torch.int32)})
    assert rows["tokens"].shape == (2, S)
    with pytest.raises(ValueError, match="gcd"):
        shard.local_rows({"tokens": torch.zeros((6, S), dtype=torch.int32)})


def test_expert_leaves_split_on_two_dims_under_the_launcher_rules():
    """mixtral-smoke's placement under the reference launcher's ``--fsdp``
    rules on 2x2: the expert banks ``(L, E, d, f)`` split ``d`` over
    ``"data"`` and ``f`` over ``"model"`` (``down`` the other way round),
    the router only ``d_model`` over ``"data"``; the FSDP gather dim of an
    expert leaf is its ``d`` and the training split's ``ff`` is on."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.training.sharded import _ff_split, train_specs

    cfg = port_cfg(MIX)
    rules = sh.ShardingRules(mesh={"data": 2, "model": 2}, fsdp_axes=(sh.D_MODEL,), sp=True)
    _, specs, drop = train_specs(cfg, rules)
    moe = specs["layers"]["moe"]
    assert drop == ()
    assert moe["gate"] == moe["up"] == (None, None, ("data",), "model")
    assert moe["down"] == (None, None, "model", ("data",))
    assert moe["router"] == (None, ("data",), None)
    assert _ff_split(specs["layers"], rules)
    scout = train_specs(port_cfg(SCOUT), rules)[1]["layers"]["moe"]
    assert scout["shared"]["gate"] == (None, ("data",), "model")
