"""The enc_dec family's (whisper's) sharded train step on
``torch.distributed``, held to the JAX package's train step on a CPU mesh
of the same shape, rehearsed on the CPU in gloo worlds; and its placement
at whisper-medium's full width.

Both stacks take the dense split over ``"model"``: ``wq`` / ``wk`` / ``wv``
column shards, ``wo`` row-parallel, the GELU MLP's ``up`` / ``up_b`` column
shards and ``down`` row-parallel with ``down_b`` added once after the sum.
The decoder's cross-attention projects the rank's heads' K / V from the
encoder memory, whose gradient is then summed over ``"model"`` before it
flows back into the encoder.  ``sp`` splits the decoder's residual by
sequence and never the encoder's (the reference constrains it ``(batch,
None, None)``).  Under FSDP each stack's layers are gathered inside the
layer.  whisper-medium's vocab (51865) is odd, so no model axis of more
than one rank splits it: a whisper-smoke of vocab 515 holds that case.

The JAX side runs the reference launcher's ``fwd_kw`` (``block_q`` 64,
``block_k`` 128, remat: the decoder rematerialised, the encoder not) and
rules (``rules_for_mesh(mesh, fsdp_axes=..., sp=...)``) in a subprocess
with forced host devices, one a mesh
(``test_torch_sharded_moe_training.JAX_CODE``); the port one spawned gloo
world a mesh.  The bounds are the sharded dense step's
(``test_torch_sharded_training.check_against_jax``: metrics 1e-5
relative, parameters and the first step's grads 1e-4 of each leaf's max,
int8 codes within one step on at most 4 codes a leaf, the scales 1e-5
relative as in the MoE and ssm files); every leaf that ``"model"`` replicates, and its gradient, are
bit-equal on every model rank.  A 1x1 world gives the port's one-device
step's bits.

Here: meshes 1x1, 2x1 (FSDP, int8 moments) and 1x2 (FSDP with ``sp``; the
odd vocab with ``sp``) and whisper-medium's local shapes at full width.
The 2x2 mesh (with and without ``sp``) and the launcher's ``--mesh 1,2
--fsdp`` with a resume are in
``tests/test_torch_sharded_encdec_training_wide.py``.
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

from test_torch_sharded_moe_training import JAX_CODE
from test_torch_sharded_training import (B, KW, OPT, S, STEPS, check_against_jax, spawn_world,
                                         unequal_over_model)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper-medium"
ODD_VOCAB = 515  # no model axis of more than one rank divides it, as 51865
# int8 moment scales, relative (the MoE and ssm files' bound): a row's
# absmax of a moment whose gradient sums over every decoder token, with
# cancellation, moves with the sum's order; the decoder's norm_x scale's v
# sits 1.11e-6 from JAX's on 2x2
SCALE_REL = 1e-5


@dataclasses.dataclass(frozen=True)
class Case:
    state_dtype: str = "fp32"
    fsdp: bool = False
    sp: bool = True  # the launcher's rules set it where "model" > 1
    vocab: int = 0  # 0: the smoke config's 512
    arch: str = ARCH
    grad_accum: int = 1
    masked: bool = False


def port_cfg(case):
    from repro_torch.configs import get_config

    cfg = get_config(ARCH, smoke=True)
    return dataclasses.replace(cfg, vocab_size=case.vocab) if case.vocab else cfg


def batches(case):
    """The global batches of both steps (numpy): tokens, labels and the
    frames stub."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import modality

    cfg = port_cfg(case)
    ds = SyntheticLMDataset(cfg.vocab_size, S, B, seed=1, modality=modality(cfg))
    return [ds.batch(i) for i in range(STEPS)]


_PARAMS = {}


def jax_params(case):
    """The JAX package's seeded init of the case's config (numpy)."""
    if case.vocab not in _PARAMS:
        import jax

        from repro.configs import get_config as jax_config
        from repro.models import model_zoo as jzoo

        jax.config.update("jax_platform_name", "cpu")
        jcfg = jax_config(ARCH, smoke=True)
        if case.vocab:
            jcfg = dataclasses.replace(jcfg, vocab_size=case.vocab)
        _PARAMS[case.vocab] = jax.tree.map(np.asarray, jzoo.init(jax.random.key(0), jcfg)[0])
    return _PARAMS[case.vocab]


# --------------------------------------------------------------------------
# the JAX oracle: one subprocess a mesh, forced host devices
# --------------------------------------------------------------------------

_JAX = {}


def jax_mesh(mesh, cases):
    """The JAX mesh step's metrics, parameters, optimizer state and first
    grads of every case of ``mesh``, in one subprocess with ``data * model``
    forced host devices."""
    if mesh not in _JAX:
        d, m = mesh
        job = {"mesh": mesh, "cf": 1.0, "moe": {}, "opt": OPT, "kw": KW,
               "cases": {i: dict(arch=ARCH, state_dtype=c.state_dtype, fsdp=c.fsdp,
                                 grad_accum=1, on_mesh=True, sp=c.sp and m > 1,
                                 replace=dict(vocab_size=c.vocab) if c.vocab else {},
                                 batches=batches(c))
                         for i, c in enumerate(cases)}}
        root = tempfile.mkdtemp(prefix=f"jax-encdec-mesh{d}x{m}-")
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
    replicated leaves differ over ``"model"``."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_loss_fn, make_train_step
    from repro_torch.training.sharded import TrainShard
    from repro_torch.training.train_step import loss_and_grads
    from repro_torch.utils.tree import tree_items

    cfg = port_cfg(case)
    opt_cfg = AdamWConfig(state_dtype=case.state_dtype, **OPT)
    shard = TrainShard.of(cfg, rules)
    params = shard.shard_params(params_from_numpy(numpy_params, "cpu"))
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    bs = [shard.local_rows({k: torch.from_numpy(v) for k, v in b.items()})
          for b in batches(case)]
    _, _, grads = loss_and_grads(make_loss_fn(cfg, KW, shard), state["params"], bs[0])
    grads = shard.sync_grads(grads)
    res = {"grads_replicated_unequal": unequal_over_model(shard, grads, shard.split.group),
           "grads": dict(tree_items(shard.gather_whole(grads))),
           "split": (shard.split.heads, shard.split.ff, shard.split.vocab, shard.split.seq),
           "frames": tuple(bs[0]["frames"].shape)}
    step = make_train_step(cfg, opt_cfg, KW, rules=rules)
    res["metrics"] = []
    for b in bs:
        state, mt = step(state, b)
        res["metrics"].append({k: mt[k].item() for k in ("loss", "ce", "aux", "grad_norm")})
    res["params_replicated_unequal"] = unequal_over_model(shard, state["params"],
                                                          shard.split.group)
    res["params"] = dict(tree_items(shard.gather_whole(state["params"])))
    res["opt"] = dict(tree_items(shard.gather_whole(state["opt"], shard.opt_specs(opt_cfg))))
    return res


def worker(rank, world, mesh, cases, root):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    warnings.simplefilter("ignore", UserWarning)
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'store')}",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        debug = make_debug_mesh(*mesh, "cpu")
        with open(os.path.join(root, "params.pkl"), "rb") as f:
            numpy_params = pickle.load(f)
        out = {}
        for case in cases:
            rules = sh.rules_for_mesh(debug, fsdp_axes=(sh.D_MODEL,) if case.fsdp else (),
                                      sp=case.sp and mesh[1] > 1)
            out[case] = run_case(case, rules, numpy_params[case.vocab])
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
        root = tempfile.mkdtemp(prefix=f"encdec-train-mesh{d}x{m}-")
        with open(os.path.join(root, "params.pkl"), "wb") as f:
            pickle.dump({c.vocab: jax_params(c) for c in cases}, f)
        spawn_world(d * m, worker, (mesh, cases, root), root)
        with open(os.path.join(root, "out.pkl"), "rb") as f:
            _RESULTS[mesh] = pickle.load(f)
    return _RESULTS[mesh]


def check_case(mesh, cases, i):
    """Case ``i`` of ``mesh``'s ``cases``: its two steps, parameters,
    moments and first grads against the JAX mesh step's (the int8 moments'
    scales within :data:`SCALE_REL`), the split it ran (heads, FF, vocab,
    ``sp``) and each data rank's frames rows."""
    d, m = mesh
    case = cases[i]
    got = sharded(mesh, cases)[case]
    assert got["split"] == (True, True, not case.vocab or m == 1, case.sp and m > 1)
    assert got["frames"][0] == B // d
    check_against_jax(mesh, case, got, jax_mesh(mesh, cases)[case], scale_rel=SCALE_REL)


# the 2x2 mesh is in tests/test_torch_sharded_encdec_training_wide.py
MESHES = {
    (1, 1): (Case(fsdp=True),),
    (2, 1): (Case("int8", fsdp=True),),
    (1, 2): (Case(fsdp=True), Case(vocab=ODD_VOCAB)),
}
HELD = [(m, i) for m, cs in MESHES.items() if m != (1, 1) for i in range(len(cs))]


def ids(v):
    return "x".join(map(str, v)) if isinstance(v, tuple) else str(v)


@pytest.mark.parametrize("mesh,i", HELD, ids=ids)
def test_sharded_whisper_train_step_matches_jax_on_the_mesh(mesh, i):
    check_case(mesh, MESHES[mesh], i)


def test_one_rank_mesh_is_the_one_device_step():
    """A 1x1 world (FSDP's gathers and sums, the memory's gradient sum, the
    global-mean loss: every collective a group of one) gives the port's
    one-device step's bits."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_loss_fn, make_train_step
    from repro_torch.training.train_step import loss_and_grads
    from repro_torch.utils.tree import tree_items

    case = MESHES[(1, 1)][0]
    res = sharded((1, 1), MESHES[(1, 1)])[case]
    cfg = port_cfg(case)
    opt_cfg = AdamWConfig(state_dtype=case.state_dtype, **OPT)
    params = params_from_numpy(jax_params(case), "cpu")
    bs = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches(case)]
    _, _, grads = loss_and_grads(make_loss_fn(cfg, KW), params, bs[0])
    assert all(torch.equal(res["grads"][k], g) for k, g in tree_items(grads))
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    step = make_train_step(cfg, opt_cfg, KW)
    for b, got in zip(bs, res["metrics"]):
        state, m = step(state, b)
        assert all(got[k] == m[k].item() for k in got), (got, {k: m[k].item() for k in got})
    assert all(torch.equal(res["params"][k], p) for k, p in tree_items(state["params"]))
    assert all(torch.equal(res["opt"][k], x) for k, x in tree_items(state["opt"]))


# --------------------------------------------------------------------------
# whisper-medium's placement at full width, without a world
# --------------------------------------------------------------------------


def local_shapes(mesh, rank=(0, 0), fsdp=False):
    """``{leaf: local shape}`` of whisper-medium's parameters on the rank at
    ``rank`` under the launcher's rules, from the specs alone (meta
    tensors), and the logical axes the placement dropped."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.training.sharded import train_specs
    from repro_torch.utils.tree import tree_items

    d, m = mesh
    rules = sh.ShardingRules(mesh={"data": d, "model": m},
                             fsdp_axes=(sh.D_MODEL,) if fsdp else (), sp=m > 1)
    shapes, specs, drop = train_specs(get_config(ARCH), rules)
    specs = dict(tree_items(specs))
    coords = dict(zip(("data", "model"), rank))
    return {k: tuple(sh.local_slice(x, specs[k], rules.mesh, coords).shape)
            for k, x in tree_items(shapes)}, drop


@pytest.mark.parametrize("m", [2, 8])
def test_whisper_medium_local_shapes_at_full_width(m):
    """whisper-medium (24 + 24 layers, d_model 1024, 16 heads of 64, d_ff
    4096, vocab 51865) on 1x``m``: both stacks' ``wq`` / ``wk`` / ``wv``
    ``(L, d, 1024 / m)`` and ``wo`` ``(L, 1024 / m, d)``, the MLP's ``up``
    and ``up_b`` ``4096 / m`` columns, ``down`` ``4096 / m`` rows and
    ``down_b`` whole; the embedding whole at the odd vocab (no warning-free
    split exists); under FSDP on 2x``m`` ``d_model`` halves too.  The
    serving cache's cross memory a rank: ``(24, B / d, 16 / m, 1500, 64)``
    in both layouts."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.serving import kv_cache as kvc, sharded as shd

    cfg = get_config(ARCH)
    L, d, f, q, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.vocab_size
    with pytest.warns(sh.ShardingFallbackWarning, match="vocab"):
        got, drop = local_shapes((1, m), (0, m - 1))
    assert drop == ()
    for stack in ("encoder", "decoder"):
        attn = ("attn", "xattn") if stack == "decoder" else ("attn",)
        for a in attn:
            for w in ("wq", "wk", "wv"):
                assert got[f"{stack}|{a}|{w}"] == (L, d, q // m)
            assert got[f"{stack}|{a}|wo"] == (L, q // m, d)
        assert got[f"{stack}|mlp|up"] == (L, d, f // m)
        assert got[f"{stack}|mlp|up_b"] == (L, f // m)
        assert got[f"{stack}|mlp|down"] == (L, f // m, d)
        assert got[f"{stack}|mlp|down_b"] == (L, d)
        assert got[f"{stack}|norm1|bias"] == (L, d)
    assert got["embed"] == (V, d) and got["audio_proj"] == (cfg.d_audio, d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", sh.ShardingFallbackWarning)
        wide, _ = local_shapes((2, m), (1, 0), fsdp=True)
    assert wide["decoder|xattn|wk"] == (L, d // 2, q // m)
    assert wide["encoder|mlp|down_b"] == (L, d // 2)
    assert wide["embed"] == (V, d // 2)
    for layout in ("slot", "paged"):
        lay = kvc.layout_for(cfg, 4, 1024, layout=layout, page_size=16)
        cache = kvc.init_cache_arrays(cfg, lay, "meta")
        for d_ in (1, 2):
            rules = sh.ShardingRules(mesh={"data": d_, "model": m})
            spec = shd.cache_shardings(cache, cfg, lay, rules)["cross_k"]
            local = sh.local_slice(cache["cross_k"], spec, rules.mesh, {"data": 0, "model": 0})
            assert tuple(local.shape) == (L, 4 // d_, 16 // m, cfg.encoder_seq, cfg.head_dim)


def test_heads_replicate_on_a_model_axis_past_their_count():
    """whisper-medium's 16 heads on a model axis of 32: the heads replicate
    (``ShardingFallbackWarning``, ``sh.heads_drop``), the FF still splits
    (4096 / 32) and the odd vocab stays whole."""
    from repro_torch.distributed import sharding as sh

    with pytest.warns(sh.ShardingFallbackWarning, match="heads"):
        got, drop = local_shapes((1, 32))
    assert drop == (sh.HEADS, sh.KV_HEADS)
    assert got["decoder|xattn|wq"] == (24, 1024, 1024)
    assert got["encoder|mlp|up_b"] == (24, 4096 // 32)
