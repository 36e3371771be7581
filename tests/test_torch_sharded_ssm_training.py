"""The ssm and hybrid families' sharded train step on ``torch.distributed``,
held to the JAX package's train step on a CPU mesh of the same shape,
rehearsed on the CPU in gloo worlds; and the segmented split that places
the mamba mixer.

A mamba mixer splits by heads over ``"model"`` (``in_proj``'s ``z``, ``x``
and ``dt`` columns, the conv's ``x`` channels, the gated norm's scale and
``out_proj``'s rows) and keeps ``B`` / ``C``'s columns and channels,
``A_log``, ``D`` and ``dt_bias`` whole on every model rank, whose
gradients are summed over ``"model"``.  The JAX side runs the reference
launcher's rules (``rules_for_mesh(mesh, fsdp_axes=..., sp=model > 1)``)
and ``fwd_kw`` (``chunk`` 64 for ssm, ``ssd_chunk`` 64 for the hybrid) in
a subprocess with forced host devices, one a mesh
(``test_torch_sharded_moe_training.JAX_CODE``); the port one spawned gloo
world a mesh.  jamba-smoke runs at capacity factor 1.0, where tokens drop,
so its MoE layers' group-local dispatch shows.  The bounds are the
sharded dense step's (``test_torch_sharded_training.check_against_jax``:
metrics 1e-5 relative, parameters and the first step's grads 1e-4 of each
leaf's max, int8 codes within one step on at most 4 codes a leaf, the
codes' scales 1e-5 relative as in the MoE files); mamba2-smoke takes two
steps, jamba-smoke one at AdamW eps 1e-3 (:data:`HYBRID_EPS` says why); every
leaf and every whole part of a segmented leaf that ``"model"`` replicates,
and its gradient, are bit-equal on every model rank.

Here: meshes 1x1 and 2x1, the 1x1 world bit-identical to the port's
one-device step, the placement's local shapes at mamba2-1.3b's and
jamba's full widths as closed forms, and the launcher's ``--mesh 2,1
--fsdp`` on mamba2-smoke with a resume.  Meshes 1x2 and 2x2, ``mixer_apply``
alone and the checkpoint are in
``tests/test_torch_sharded_ssm_training_wide.py``.
"""

import datetime
import os
import pickle
import subprocess
import sys
import tempfile
import warnings

import pytest
import torch

from test_torch_sharded_moe_training import JAX_CODE, batches, port_cfg
from test_torch_sharded_training import (KW, OPT, Case, check_against_jax, jax_params,
                                         spawn_world, unequal_over_model)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAMBA, JAMBA = "mamba2-1.3b", "jamba-1.5-large-398b"
# int8 moment scales, relative (the MoE files' bound): a row's absmax of a
# moment summed with cancellation moves with the sum's order, mamba2-smoke's
# tied embedding's m by 2.55e-6 on 2x1
SCALE_REL = 1e-5
SSM_KW = dict(chunk=64, remat=True)  # the reference launcher's fwd_kw, per family
HYBRID_KW = dict(KW, ssd_chunk=64)
# AdamW eps of the hybrid's cases.  jamba-smoke's first grads sit up to
# 4.5e-5 of a leaf's max from JAX's on one device already (the mixers'
# zero-initialised conv biases and the norm scales sum over every token,
# with cancellation; tests/test_torch_hybrid.py bounds them at 1e-4), and
# AdamW's first update divides each by |g| + eps: at eps 1e-4 an element
# whose |g| is near eps carries that into 1.5e-3 of its leaf's max after
# two steps, one device against JAX, past the parameters' 1e-4 bound; at
# 1e-3 the one-device run is within 5.7e-5 and its grad norm 8.2e-6.  The
# second step's grad norm, past one such update, still moves 1.8e-5 on
# 2x1 at 1e-3, so the hybrid's cases take one step
HYBRID_EPS, HYBRID_STEPS = 1e-3, 1


def fwd_kw(arch):
    return SSM_KW if arch == MAMBA else HYBRID_KW


def batches_of(arch):
    """The global batches of ``arch``'s steps (numpy; one for the hybrid)."""
    bs = batches(port_cfg(arch))
    return bs if arch == MAMBA else bs[:HYBRID_STEPS]


def opt_of(arch):
    """The AdamW settings of ``arch``'s cases (:data:`HYBRID_EPS` for the
    hybrid)."""
    return OPT if arch == MAMBA else dict(OPT, eps=HYBRID_EPS)


# --------------------------------------------------------------------------
# the JAX oracle: one subprocess a mesh, forced host devices
# --------------------------------------------------------------------------

_JAX = {}


def jax_mesh(mesh, cases):
    """The JAX mesh step's metrics, parameters, optimizer state and first
    grads of every case of ``mesh`` (each with its family's ``fwd_kw``,
    AdamW settings and steps), in one subprocess with ``data * model``
    forced host devices, under the reference launcher's rules."""
    if mesh not in _JAX:
        d, m = mesh
        job = {"mesh": mesh, "cf": 1.0, "moe": {},
               "cases": {i: dict(arch=c.arch, state_dtype=c.state_dtype, fsdp=c.fsdp,
                                 grad_accum=1, on_mesh=True, kw=fwd_kw(c.arch),
                                 opt=opt_of(c.arch), batches=batches_of(c.arch))
                         for i, c in enumerate(cases)}}
        root = tempfile.mkdtemp(prefix=f"jax-ssm-mesh{d}x{m}-")
        with open(os.path.join(root, "job.pkl"), "wb") as f:
            pickle.dump(job, f)
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={d * m}",
                   PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
        run = subprocess.run([sys.executable, "-c", JAX_CODE, os.path.join(root, "job.pkl"),
                              os.path.join(root, "out.pkl")], env=env, capture_output=True,
                             text=True, timeout=600)
        assert run.returncode == 0, run.stderr[-3000:]
        with open(os.path.join(root, "out.pkl"), "rb") as f:
            got = pickle.load(f)["cases"]
        _JAX[mesh] = {c: got[i] for i, c in enumerate(cases)}
    return _JAX[mesh]


# --------------------------------------------------------------------------
# one rank of a world
# --------------------------------------------------------------------------


def run_case(case, rules, numpy_params):
    """One case on this rank: the first step's grads and two sharded
    steps, gathered whole on every rank (rank 0 keeps them), and which
    replicated leaves and parts differ over ``"model"``."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_loss_fn, make_train_step
    from repro_torch.training.sharded import TrainShard
    from repro_torch.training.train_step import loss_and_grads
    from repro_torch.utils.tree import tree_items

    cfg = port_cfg(case.arch)
    kw = fwd_kw(case.arch)
    opt_cfg = AdamWConfig(state_dtype=case.state_dtype, **opt_of(case.arch))
    shard = TrainShard.of(cfg, rules)
    params = shard.shard_params(params_from_numpy(numpy_params, "cpu"))
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    bs = [shard.local_rows({k: torch.from_numpy(v) for k, v in b.items()})
          for b in batches_of(case.arch)]
    _, _, grads = loss_and_grads(make_loss_fn(cfg, kw, shard), state["params"], bs[0])
    grads = shard.sync_grads(grads)
    res = {"grads_replicated_unequal": unequal_over_model(shard, grads, shard.split.group),
           "grads": dict(tree_items(shard.gather_whole(grads)))}
    step = make_train_step(cfg, opt_cfg, kw, rules=rules)
    res["metrics"] = []
    for b in bs:
        state, mt = step(state, b)
        res["metrics"].append({k: mt[k].item() for k in ("loss", "ce", "aux", "grad_norm")})
    res["params_replicated_unequal"] = unequal_over_model(shard, state["params"],
                                                          shard.split.group)
    res["params"] = dict(tree_items(shard.gather_whole(state["params"])))
    res["opt"] = dict(tree_items(shard.gather_whole(state["opt"], shard.opt_specs(opt_cfg))))
    return res, shard, state, opt_cfg


def start(rank, world, root, mesh):
    """This rank's gloo world and ``(data, model)`` debug mesh."""
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'store')}",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    return make_debug_mesh(*mesh, "cpu")


def rules_of(debug, case_fsdp: bool, m: int):
    """The reference launcher's rules on ``debug``."""
    from repro_torch.distributed import sharding as sh

    return sh.rules_for_mesh(debug, fsdp_axes=(sh.D_MODEL,) if case_fsdp else (), sp=m > 1)


def worker(rank, world, mesh, cases, root):
    import torch.distributed as dist

    debug = start(rank, world, root, mesh)
    try:
        with open(os.path.join(root, "params.pkl"), "rb") as f:
            numpy_params = pickle.load(f)
        out = {}
        for case in cases:
            out[case] = run_case(case, rules_of(debug, case.fsdp, mesh[1]),
                                 numpy_params[case.arch])[0]
        if rank == 0:
            with open(os.path.join(root, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


_RESULTS = {}


def sharded(mesh, cases):
    """Every case's results of one mesh's world (spawned once)."""
    if mesh not in _RESULTS:
        d, m = mesh
        root = tempfile.mkdtemp(prefix=f"ssm-train-mesh{d}x{m}-")
        with open(os.path.join(root, "params.pkl"), "wb") as f:
            pickle.dump({c.arch: jax_params(c.arch) for c in cases}, f)
        spawn_world(d * m, worker, (mesh, cases, root), root)
        with open(os.path.join(root, "out.pkl"), "rb") as f:
            _RESULTS[mesh] = pickle.load(f)
    return _RESULTS[mesh]


def in_sqrt_space(res):
    """``res`` with each f32 second moment ``v`` as ``sqrt(v)``, the
    quantity the update divides by (and the int8 codec codes).  Held so for
    the hybrid: ``v`` is ``g**2``, so jamba-smoke's grads at up to 4.5e-5
    of a leaf's max from JAX's on one device put ``v`` at twice that, and
    the mesh's own sums in another order take it past 1e-4 (1.03e-4,
    ``v|blocks|pos5|mamba|conv_b`` on 1x2); ``sqrt(v)`` keeps the grads'
    scale."""
    sq = lambda x: x.sqrt() if isinstance(x, torch.Tensor) else x ** 0.5
    return dict(res, opt={k: sq(x) if k.startswith("v|") else x for k, x in res["opt"].items()})


def check_case(mesh, case, got, want):
    """``case``'s results against the JAX mesh step's (every replicated
    leaf and whole part, and its gradient, bit-equal over ``"model"``), the
    aux metric within 1e-5 relative."""
    assert len(got["metrics"]) == len(batches_of(case.arch))
    if case.arch == JAMBA and case.state_dtype == "fp32":
        got, want = in_sqrt_space(got), in_sqrt_space(want)
    check_against_jax(mesh, case, got, want, scale_rel=SCALE_REL)
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert abs(g["aux"] - w["aux"]) <= 1e-5 * abs(w["aux"]), (mesh, case, i)


MESHES = {
    (1, 1): (Case(MAMBA, fsdp=True), Case(JAMBA)),
    (2, 1): (Case(MAMBA, "int8"), Case(JAMBA, fsdp=True)),
}
# the cases held to the JAX mesh step (the hybrid's 1x1 case is held to the
# port's one-device step alone, below)
HELD = [(m, i) for m, cs in MESHES.items() for i, c in enumerate(cs)
        if m != (1, 1) or c.arch == MAMBA]


def _ids(v):
    return "x".join(map(str, v)) if isinstance(v, tuple) else str(v)


@pytest.mark.parametrize("mesh,i", HELD, ids=_ids)
def test_sharded_ssm_train_step_matches_jax_on_the_mesh(mesh, i):
    case = MESHES[mesh][i]
    held = tuple(c for j, c in enumerate(MESHES[mesh]) if (mesh, j) in HELD)
    check_case(mesh, case, sharded(mesh, MESHES[mesh])[case], jax_mesh(mesh, held)[case])


@pytest.mark.parametrize("i", range(len(MESHES[(1, 1)])))
def test_one_rank_mesh_is_the_one_device_step(i):
    """A 1x1 world (FSDP's gathers and sums, the gated norm's sum, the
    whole parts' gradient sums, the MoE's aux over groups of one) gives the
    port's one-device step's bits."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_loss_fn, make_train_step
    from repro_torch.training.train_step import loss_and_grads
    from repro_torch.utils.tree import tree_items

    case = MESHES[(1, 1)][i]
    res = sharded((1, 1), MESHES[(1, 1)])[case]
    cfg = port_cfg(case.arch)
    opt_cfg = AdamWConfig(state_dtype=case.state_dtype, **opt_of(case.arch))
    params = params_from_numpy(jax_params(case.arch), "cpu")
    bs = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches_of(case.arch)]
    _, _, grads = loss_and_grads(make_loss_fn(cfg, fwd_kw(case.arch)), params, bs[0])
    assert all(torch.equal(res["grads"][k], g) for k, g in tree_items(grads))
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    step = make_train_step(cfg, opt_cfg, fwd_kw(case.arch))
    for b, got in zip(bs, res["metrics"]):
        state, m = step(state, b)
        assert all(got[k] == m[k].item() for k in got), (got, {k: m[k].item() for k in got})
    assert all(torch.equal(res["params"][k], p) for k, p in tree_items(state["params"]))
    assert all(torch.equal(res["opt"][k], x) for k, x in tree_items(state["opt"]))


# --------------------------------------------------------------------------
# the segmented split's closed forms
# --------------------------------------------------------------------------


def local_shapes(cfg, mesh, rank, fsdp=False):
    """The local shapes of one mixer's leaves on the rank at ``rank``
    (``(data, model)`` coordinates) under the launcher's rules, from the
    specs alone (meta tensors)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.training.sharded import train_specs
    from repro_torch.utils.tree import tree_items

    d, m = mesh
    rules = sh.ShardingRules(mesh={"data": d, "model": m},
                             fsdp_axes=(sh.D_MODEL,) if fsdp else (), sp=m > 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", sh.ShardingFallbackWarning)
        shapes, specs, _ = train_specs(cfg, rules)
    specs = dict(tree_items(specs))
    coords = dict(zip(("data", "model"), rank))
    mixer = "layers|mixer|" if cfg.family == "ssm" else "blocks|pos0|mamba|"
    return {k[len(mixer):]: tuple(sh.local_slice(x, specs[k], rules.mesh, coords).shape)
            for k, x in tree_items(shapes) if k.startswith(mixer)}, specs[mixer + "in_proj"]


@pytest.mark.parametrize("arch,m", [(MAMBA, 2), (MAMBA, 8), (JAMBA, 2), (JAMBA, 8)])
def test_mixer_local_shapes_at_full_width(arch, m):
    """mamba2-1.3b (d_in 4096, N 128, 64 heads) and jamba (d_in 16384, N
    128, 128 heads) on 1x``m``: ``in_proj`` ``(d, 2 d_in / m + 2 N + H /
    m)``, the conv ``d_in / m + 2 N`` channels, the norm and ``out_proj``'s
    rows ``d_in / m``, ``A_log`` / ``D`` / ``dt_bias`` whole; under FSDP on
    2x``m`` ``d_model`` halves too.  ``in_proj``'s spec is a
    :class:`Segments` of its five parts."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh

    cfg = get_config(arch)
    d, d_in, N = cfg.d_model, cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    H, K = d_in // cfg.ssm_head_dim, cfg.ssm_conv
    L = cfg.num_layers if arch == MAMBA else cfg.num_layers // cfg.attn_every
    for rank in ((0, 0), (0, m - 1)):
        got, spec = local_shapes(cfg, (1, m), rank)
        assert got == {"in_proj": (L, d, 2 * d_in // m + 2 * N + H // m),
                       "conv_w": (L, K, d_in // m + 2 * N), "conv_b": (L, d_in // m + 2 * N),
                       "A_log": (L, H), "D": (L, H), "dt_bias": (L, H),
                       "norm|scale": (L, d_in // m), "out_proj": (L, d_in // m, d)}, (rank, got)
        assert spec[-1] == sh.Segments(("model",), ((d_in, True), (d_in, True),
                                                    (2 * N, False), (H, True)))
    got, _ = local_shapes(cfg, (2, m), (1, 0), fsdp=True)
    assert got["in_proj"] == (L, d // 2, 2 * d_in // m + 2 * N + H // m)
    assert got["out_proj"] == (L, d_in // m, d // 2)


def test_mixers_replicate_where_the_model_axis_does_not_divide_their_heads():
    """mamba2-smoke's 4 mamba heads on a model axis of 8: every mixer leaf
    whole (warning); its vocab still splits."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.training.sharded import train_specs

    cfg = port_cfg(MAMBA)
    with pytest.warns(sh.ShardingFallbackWarning, match="mamba heads"):
        _, specs, _ = train_specs(cfg, sh.ShardingRules(mesh={"data": 1, "model": 8}))
    mixer = specs["layers"]["mixer"]
    assert all(e is None for k in ("in_proj", "conv_w", "conv_b", "out_proj")
               for e in mixer[k])
    assert specs["embed"] == ("model", None)


def test_train_launcher_trains_mamba2_on_a_mesh_and_resumes(tmp_path):
    """``torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train
    --device cpu --arch mamba2-1.3b --mesh 2,1 --fsdp``: 3 steps
    checkpointing after each, then a run from a directory holding only
    step 2's checkpoint resumes there and logs the straight run's loss at
    step 2."""
    def run(ckpt):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", MAMBA,
             "--mesh", "2,1", "--fsdp", "--steps", "3", "--batch", "4", "--seq-len", "16",
             "--ckpt-every", "1", "--log-every", "1", "--ckpt-dir", str(ckpt),
             "--heartbeat", str(tmp_path / "hb.json")],
            env=env, capture_output=True, text=True, timeout=240, cwd=REPO)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    straight = run(tmp_path / "straight")
    assert "[train] mesh 2x1 (mamba2-smoke; fsdp True, sp False)" in straight
    os.makedirs(tmp_path / "resume")
    os.rename(tmp_path / "straight" / "step_00000002", tmp_path / "resume" / "step_00000002")
    resumed = run(tmp_path / "resume")
    assert "restored step 2" in resumed
    loss = lambda text: [ln.split("loss")[1].split()[0] for ln in text.splitlines()
                         if ln.startswith("[train] step     2")]
    assert loss(resumed) == loss(straight) and len(loss(straight)) == 1
