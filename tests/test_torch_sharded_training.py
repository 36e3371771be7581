"""Sharded training on ``torch.distributed``: the port's train step on
``(data, model)`` meshes held to the JAX package's single-device train
step, rehearsed on the CPU in gloo worlds.

Each mesh runs in ONE spawned world of ``data * model`` processes (a
``file://`` store under a temporary directory, a 60 s collective timeout,
one thread a process, the parent killing a world past 300 s); every case of
the mesh runs inside it and rank 0 writes the whole (gathered) results,
which the parent checks.  The rules are the reference launcher's
(``src/repro/launch/train.py:52-54``): ``fsdp_axes=(d_model,)`` under FSDP,
``sp`` where ``"model" > 1``.  The parameters are the JAX package's seeded
init (``interop.params_from_numpy``); the oracle is the JAX
``make_train_step`` on one device over the same global batches:

* loss, ``ce`` and ``grad_norm`` of both steps within 1e-5 relative;
* the parameters after two steps, and the first step's gradients, within
  1e-4 of each leaf's max |value| (``_rel``; f32 sums over the mesh in
  another order than one device's);
* int8 moments: every code within one step of JAX's (a float that lands
  on a .5 boundary on one side rounds the other way) and at most
  ``MAX_FLIPS`` (or ``MAX_FLIP_SHARE``) of a leaf's codes off, the scales
  within 1e-6 relative; a parameter whose moment code flipped at either
  step is off by that code's share of the update, so as many elements of
  a leaf may miss the parameters' bound;
* a 1x1 world is bit-identical to the port's one-device step;
* within a world, each leaf that is replicated over ``"model"`` (and its
  gradient) is bit-equal on every model rank.

One case masks part of one data rank's labels: there the loss is the mean
over every label token of the mesh, and a mean of the ranks' own means is
shown to miss JAX's by more than the tolerance.

Meshes 1x1, 2x1 and 1x2 run here; 2x2, 1x4 and 2x4 in
``tests/test_torch_sharded_training_wide.py`` (so ``--dist loadfile``
spreads them).  phi4-mini-3.8b-smoke splits its 6 / 2 heads over
``"model"`` of 2, gemma3-4b-smoke (qk-norm, sandwich norms, sliding
windows) its 4 / 2; deepseek-7b-smoke its 4 / 4 over 4.
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
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.distributed import sharding as sh
from repro_torch.interop import params_from_numpy
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.training import make_loss_fn, make_train_step
from repro_torch.training.sharded import TrainShard, train_specs
from repro_torch.training.train_step import loss_and_grads
from repro_torch.utils.tree import tree_items, tree_map

torch.set_num_threads(1)

B, S, STEPS = 4, 16, 2
JOIN_S = 300
KW = dict(block_q=64, block_k=128, remat=True)
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50, eps=1e-4)
METRIC_REL, TREE_REL, SCALE_REL = 1e-5, 1e-4, 1e-6
# int8 codes of a leaf that may sit one step from JAX's: the larger of a
# count and a share (measured: up to 3 in a leaf of 49,152)
MAX_FLIPS, MAX_FLIP_SHARE = 4, 1e-3
PHI, DEEPSEEK, GEMMA = "phi4-mini-3.8b", "deepseek-7b", "gemma3-4b"


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    state_dtype: str = "fp32"
    fsdp: bool = False
    grad_accum: int = 1
    masked: bool = False  # part of the last data rank's labels are -1

    @property
    def oracle(self):
        return (self.arch, self.state_dtype, self.grad_accum, self.masked)


def _batches(cfg, masked, data):
    ds = SyntheticLMDataset(cfg.vocab_size, S, B, seed=1)
    out = []
    for i in range(STEPS):
        b = ds.batch(i)
        if masked:  # the last data rank's rows lose 10 of their 16 labels
            b["labels"][B - B // data:, :10] = -1
        out.append(b)
    return out


# --------------------------------------------------------------------------
# the JAX oracle (the parent only: the ranks import no JAX)
# --------------------------------------------------------------------------

_JAX = {}


def jax_params(arch):
    """The JAX package's seeded init of ``arch``'s smoke config, as numpy."""
    if arch not in _JAX:
        import jax

        from repro.configs import get_config as jax_config
        from repro.models import model_zoo as jzoo

        jax.config.update("jax_platform_name", "cpu")
        jparams, _ = jzoo.init(jax.random.key(0), jax_config(arch, smoke=True))
        _JAX[arch] = jax.tree.map(np.asarray, jparams)
    return _JAX[arch]


def jax_oracle(case, data):
    """The JAX single-device train step's metrics over both steps, the
    parameters and optimizer state after them, and the first step's
    grads."""
    key = case.oracle + (data if case.masked else 0,)
    if key in _JAX:
        return _JAX[key]
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.distributed import sharding as jsh
    from repro.optim import adamw as jadamw
    from repro.training import train_step as jts

    jcfg = jax_config(case.arch, smoke=True)
    params = jax.tree.map(jnp.asarray, jax_params(case.arch))
    jopt = jadamw.AdamWConfig(state_dtype=case.state_dtype, **OPT)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _batches(jcfg, case.masked, data)]
    grads = jax.jit(jax.grad(lambda p, b: jts.make_loss_fn(jcfg, jsh.ShardingRules(), KW)(
        p, b)[0]))(params, batches[0]) if case.grad_accum == 1 else None
    step = jax.jit(jts.make_train_step(jcfg, jsh.ShardingRules(), jopt, KW,
                                       grad_accum=case.grad_accum))
    state = {"params": params, "opt": jadamw.adamw_init(params, jopt)}
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(m[k]) for k in ("loss", "ce", "grad_norm")})
    np_tree = lambda t: dict(tree_items(jax.tree.map(np.asarray, t)))
    _JAX[key] = dict(metrics=metrics, params=np_tree(state["params"]),
                     opt=np_tree(state["opt"]), grads=None if grads is None else np_tree(grads))
    return _JAX[key]


# --------------------------------------------------------------------------
# one rank of a world
# --------------------------------------------------------------------------


def unequal_over_model(shard, tree, model_group):
    """The leaves of ``tree`` not split over "model" (of a segmented leaf,
    its whole parts) that are not bit-equal on every model rank."""
    bad, specs = [], dict(tree_items(shard.specs))
    for key, x in tree_items(tree):
        seg = next(((i, e) for i, e in enumerate(specs[key]) if isinstance(e, sh.Segments)),
                   None)
        if seg is not None:
            i, e = seg
            x = torch.cat([p for p, split in sh.part_pieces(x, i, e.parts,
                                                              sh.group_size(model_group))
                           if not split], i)
        elif any("model" in (e if isinstance(e, tuple) else (e,)) for e in specs[key] if e):
            continue
        every = sh.all_gather(x[None], model_group, 0)
        if not all(torch.equal(every[0], e) for e in every[1:]):
            bad.append(key)
    return bad


def _run_case(case, mesh, rules, numpy_params):
    """One case on this rank: two sharded steps (and the first step's
    grads), the results gathered whole (on every rank; rank 0 keeps
    them)."""
    d, m = mesh
    cfg = get_config(case.arch, smoke=True)
    opt_cfg = AdamWConfig(state_dtype=case.state_dtype, **OPT)
    shard = TrainShard.of(cfg, rules)
    params = shard.shard_params(params_from_numpy(numpy_params, "cpu"))
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    batches = [shard.local_rows({k: torch.from_numpy(v) for k, v in b.items()})
               for b in _batches(cfg, case.masked, d)]
    res = {}
    model_group = rules.mesh.get_group("model")

    replicated_unequal = lambda tree: unequal_over_model(shard, tree, model_group)

    if case.grad_accum == 1:
        loss_fn = make_loss_fn(cfg, KW, shard)
        _, _, grads = loss_and_grads(loss_fn, state["params"], batches[0])
        grads = shard.sync_grads(grads)
        res["grads_replicated_unequal"] = replicated_unequal(grads)
        res["grads"] = dict(tree_items(shard.gather_whole(grads)))
    if case.masked:  # the mean of the data ranks' own means, for contrast
        own = make_loss_fn(cfg, KW, dataclasses.replace(shard, data_group=None))
        with torch.no_grad():
            loss, _ = own(state["params"], batches[0])
        res["mean_of_rank_means"] = (sh.all_reduce_sum(loss, shard.data_group) / d).item()
    step = make_train_step(cfg, opt_cfg, KW, grad_accum=case.grad_accum, rules=rules)
    res["metrics"] = []
    for b in batches:
        state, mt = step(state, b)
        res["metrics"].append({k: mt[k].item() for k in ("loss", "ce", "grad_norm")})
    res["params_replicated_unequal"] = replicated_unequal(state["params"])
    res["params"] = dict(tree_items(shard.gather_whole(state["params"])))
    res["opt"] = dict(tree_items(shard.gather_whole(state["opt"], shard.opt_specs(opt_cfg))))
    return res


def _worker(rank, world, mesh, cases, store, out_dir):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        with open(os.path.join(out_dir, "params.pkl"), "rb") as f:
            numpy_params = pickle.load(f)
        d, m = mesh
        debug = make_debug_mesh(d, m, "cpu")
        out = {}
        for case in cases:
            rules = sh.rules_for_mesh(debug, fsdp_axes=(sh.D_MODEL,) if case.fsdp else (),
                                      sp=m > 1)
            out[case] = _run_case(case, mesh, rules, numpy_params[case.arch])
        if rank == 0:
            with open(os.path.join(out_dir, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_world(world, target, args, root):
    """Run ``target(rank, world, *args)`` in a spawned gloo world of
    ``world`` processes; fail on a hang past :data:`JOIN_S` or a nonzero
    exit."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world) + tuple(args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_S)
    for p in procs:
        p.join(max(1.0, (deadline - datetime.datetime.now()).total_seconds()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {world} ranks hung past {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


_RESULTS = {}


def sharded(mesh, cases):
    """Every case's results of one mesh's world (spawned once)."""
    if mesh not in _RESULTS:
        d, m = mesh
        root = tempfile.mkdtemp(prefix=f"train-mesh{d}x{m}-")
        with open(os.path.join(root, "params.pkl"), "wb") as f:
            pickle.dump({c.arch: jax_params(c.arch) for c in cases}, f)
        spawn_world(d * m, _worker, (mesh, cases, os.path.join(root, "store"), root), root)
        with open(os.path.join(root, "out.pkl"), "rb") as f:
            _RESULTS[mesh] = pickle.load(f)
    return _RESULTS[mesh]


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def check_against_jax(mesh, case, res, want=None, scale_rel=SCALE_REL):
    """``res`` (a mesh's gathered results of ``case``) against ``want``,
    the JAX oracle's (the single-device step's by default); int8 moment
    scales within ``scale_rel`` relative."""
    want = jax_oracle(case, mesh[0]) if want is None else want
    for i, (got, ref) in enumerate(zip(res["metrics"], want["metrics"])):
        for name in ("loss", "ce", "grad_norm"):
            assert abs(got[name] - ref[name]) <= METRIC_REL * abs(ref[name]), (mesh, case, i,
                                                                                name)
    assert set(res["params"]) == set(want["params"])
    for key, p in res["params"].items():
        if case.state_dtype == "fp32":
            assert _rel(_np(p), want["params"][key]) <= TREE_REL, (mesh, case, key)
    if res.get("grads") is not None:
        for key, g in res["grads"].items():
            assert _rel(_np(g), want["grads"][key]) <= TREE_REL, (mesh, case, key)
    flips = {}
    for key, x in res["opt"].items():
        ref = want["opt"][key]
        if key.endswith("|q"):
            diff = np.abs(_np(x).astype(np.int32) - ref.astype(np.int32))
            assert diff.max() <= 1, (mesh, case, key, diff.max())
            flips[key] = int((diff > 0).sum())
            assert flips[key] <= max(MAX_FLIPS, MAX_FLIP_SHARE * diff.size), (
                mesh, case, key, flips[key])
        elif key.endswith("|s"):
            assert _rel(_np(x), ref) <= scale_rel, (mesh, case, key)
        elif key != "step":
            assert _rel(_np(x), ref) <= TREE_REL, (mesh, case, key)
    if case.state_dtype == "int8":  # a code one step off (at either step) moves its element
        for key, p in res["params"].items():
            err = np.abs(_np(p).astype(np.float64) - want["params"][key])
            bad = int((err > TREE_REL * np.abs(want["params"][key]).max()).sum())
            assert bad <= max(MAX_FLIPS, MAX_FLIP_SHARE * err.size), (mesh, case, key, bad)
    assert res.get("grads_replicated_unequal", []) == [], (mesh, case)
    assert res["params_replicated_unequal"] == [], (mesh, case)
    if case.masked:
        ref = want["metrics"][0]["ce"]
        assert abs(res["mean_of_rank_means"] - ref) > METRIC_REL * abs(ref)
    return flips


MESHES = {
    (1, 1): (Case(PHI, fsdp=True),),
    (2, 1): (Case(PHI, masked=True), Case(PHI, "int8", fsdp=True, grad_accum=2)),
    (1, 2): (Case(PHI, "int8", fsdp=True), Case(PHI), Case(GEMMA, fsdp=True)),
}


@pytest.mark.parametrize("mesh,i", [(m, i) for m, cs in MESHES.items() for i in range(len(cs))],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_sharded_train_step_matches_jax(mesh, i):
    case = MESHES[mesh][i]
    check_against_jax(mesh, case, sharded(mesh, MESHES[mesh])[case])


def test_one_rank_mesh_is_the_one_device_step():
    """A 1x1 world (FSDP rules: every gather and sum runs over groups of
    one) gives the port's one-device step's bits."""
    case = MESHES[(1, 1)][0]
    res = sharded((1, 1), MESHES[(1, 1)])[case]
    cfg = get_config(case.arch, smoke=True)
    opt_cfg = AdamWConfig(state_dtype=case.state_dtype, **OPT)
    params = params_from_numpy(jax_params(case.arch), "cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(cfg, False, 1)]
    _, _, grads = loss_and_grads(make_loss_fn(cfg, KW), params, batches[0])
    assert all(torch.equal(res["grads"][k], g) for k, g in tree_items(grads))
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    step = make_train_step(cfg, opt_cfg, KW)
    for b, got in zip(batches, res["metrics"]):
        state, m = step(state, b)
        assert all(got[k] == m[k].item() for k in got), (got, m)
    assert all(torch.equal(res["params"][k], p) for k, p in tree_items(state["params"]))
    assert all(torch.equal(res["opt"][k], x) for k, x in tree_items(state["opt"]))


class _Mesh:  # the shape and coordinates a 2x2 DeviceMesh gives, without a world
    mesh_dim_names = ("data", "model")
    shape = (2, 2)

    @staticmethod
    def get_local_rank(axis):
        return 0

    @staticmethod
    def get_group(axis):
        return None


def test_other_families_and_knobs_are_refused_under_a_training_mesh():
    """Every family trains sharded: mamba2's and jamba's placements build,
    their mixers split by heads, and whisper's, its heads, both stacks' FF
    and its vocab split over ``"model"``; ``seq_shard`` is refused, naming
    the knob."""
    mesh = {"data": 2, "model": 2}
    for arch in ("mamba2-1.3b", "jamba-1.5-large-398b"):
        shard = TrainShard.of(get_config(arch, smoke=True), sh.rules_for_mesh(_Mesh()))
        assert shard.split.ssm and shard.split.size == 2
    shard = TrainShard.of(get_config("whisper-medium", smoke=True), sh.rules_for_mesh(_Mesh()))
    assert (shard.split.heads, shard.split.ff, shard.split.vocab, shard.split.ssm) == (
        True, True, True, False)
    with pytest.raises(NotImplementedError, match="seq_shard"):
        TrainShard.of(get_config(PHI, smoke=True), sh.ShardingRules(mesh=mesh, seq_shard=True))
    assert TrainShard.of(get_config(PHI, smoke=True), sh.ShardingRules()) is None


def test_opt_state_specs_match_the_reference():
    """``opt_state_specs`` is the reference's, leaf for leaf, for f32 and
    int8 moments (the MoE's 4-D expert leaves and the VLM's too)."""
    from repro.models import model_zoo as jzoo
    from repro.optim import adamw as jadamw
    from repro.configs import get_config as jax_config

    from repro_torch.models import model_zoo
    from repro_torch.optim import opt_state_specs

    for dt in ("fp32", "int8"):
        for arch in (PHI, "gemma3-4b", "mixtral-8x22b", "llama4-scout-17b-a16e",
                     "paligemma-3b"):
            want = jadamw.opt_state_specs(jzoo.param_specs(jax_config(arch, smoke=True)),
                                          jadamw.AdamWConfig(state_dtype=dt))
            got = opt_state_specs(model_zoo.param_specs(get_config(arch, smoke=True)),
                                  AdamWConfig(state_dtype=dt))
            assert got == tree_map(lambda x: x, want), (dt, arch)


def test_training_placement_under_the_launcher_rules():
    """The physical specs of the reference launcher's rules: heads, FF and
    vocab on ``"model"``, ``d_model`` on ``"data"`` under FSDP; heads that
    ``"model"`` does not divide replicate with a ``ShardingFallbackWarning``
    (phi4-mini-3.8b-smoke's 6 / 2 heads on 4), its FF and vocab still
    split."""
    cfg = get_config(PHI, smoke=True)
    rules = sh.ShardingRules(mesh={"data": 2, "model": 2}, fsdp_axes=(sh.D_MODEL,), sp=True)
    _, specs, drop = train_specs(cfg, rules)
    lay = specs["layers"]
    assert drop == () and lay["attn"]["wq"] == (None, ("data",), "model")
    assert lay["attn"]["wo"] == (None, "model", ("data",))
    assert lay["mlp"]["down"] == (None, "model", ("data",))
    assert specs["embed"] == ("model", ("data",)) and specs["final_norm"]["scale"] == (("data",),)
    with pytest.warns(sh.ShardingFallbackWarning):
        _, wide, drop = train_specs(cfg, sh.ShardingRules(mesh={"data": 1, "model": 4}))
    assert drop == (sh.HEADS, sh.KV_HEADS)
    assert wide["layers"]["attn"]["wq"] == (None, None, None)
    assert wide["layers"]["mlp"]["gate"] == (None, None, "model")
    assert wide["embed"] == ("model", None)
