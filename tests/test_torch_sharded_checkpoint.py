"""Checkpoints on a mesh, the elastic restore onto another one, and the
train launcher under ``torch.distributed.run``.

The port's counterparts of ``test_elastic_reshard_on_restore``
(``tests/test_substrates.py:136``) and
``TestElasticReshard`` (``tests/test_multidevice.py:50``): a 2x2 gloo world
(phi4-mini-3.8b-smoke from the JAX init, FSDP rules, ``sp`` on) trains two
steps, saves with ``shardings=`` (each leaf gathered whole, rank 0
writing the one-device format) and trains a third; a 4x1 world and a world
of one restore that checkpoint with ``shardings=`` of their own mesh.
Every whole leaf they hold is the saved one bit for bit, and their third
step matches the uninterrupted 2x2 run's within the sharded-training
tolerances (``tests/test_torch_sharded_training.py``: metrics 1e-5
relative, parameters 1e-4 of each leaf's max).
"""

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

from test_torch_sharded_training import (B, KW, METRIC_REL, OPT, PHI, S, TREE_REL, _np, _rel,
                                         jax_params, spawn_world)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(rank, world, mesh, root, save):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed import sharding as sh
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import make_train_step
    from repro_torch.training.sharded import TrainShard
    from repro_torch.utils.tree import tree_items

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, f'store{world}')}",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        d, m = mesh
        rules = sh.rules_for_mesh(make_debug_mesh(d, m, "cpu"), fsdp_axes=(sh.D_MODEL,),
                                  sp=m > 1)
        cfg = get_config(PHI, smoke=True)
        opt_cfg = AdamWConfig(**OPT)
        shard = TrainShard.of(cfg, rules)
        with open(os.path.join(root, "params.pkl"), "rb") as f:
            params = shard.shard_params(params_from_numpy(pickle.load(f), "cpu"))
        state = {"params": params, "opt": adamw_init(params, opt_cfg)}
        placement = shard.placement(opt_cfg)
        step = make_train_step(cfg, opt_cfg, KW, rules=rules)
        ds = SyntheticLMDataset(cfg.vocab_size, S, B, seed=1)
        batch = lambda i: shard.local_rows({k: torch.from_numpy(v)
                                            for k, v in ds.batch(i).items()})
        ckpt = Checkpointer(os.path.join(root, "ckpt"), async_save=save)
        out = {}
        if save:
            for i in range(2):
                state, _ = step(state, batch(i))
            ckpt.save(2, state, shardings=placement)
            ckpt.wait()
        else:
            at, state = ckpt.restore(state, shardings=placement)
            out["restored_step"] = at
            out["restored"] = dict(tree_items(shard.gather_whole(state, placement.specs)))
        state, metrics = step(state, batch(2))
        out["metrics"] = {k: metrics[k].item() for k in ("loss", "ce", "grad_norm")}
        out["params"] = dict(tree_items(shard.gather_whole(state["params"])))
        if rank == 0:
            with open(os.path.join(root, f"out{d}x{m}.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


_OUT = {}


def _results():
    if not _OUT:
        root = tempfile.mkdtemp(prefix="sharded-ckpt-")
        with open(os.path.join(root, "params.pkl"), "wb") as f:
            pickle.dump(jax_params(PHI), f)
        for mesh, save in (((2, 2), True), ((4, 1), False), ((1, 1), False)):
            spawn_world(mesh[0] * mesh[1], _worker, (mesh, root, save), root)
            with open(os.path.join(root, f"out{mesh[0]}x{mesh[1]}.pkl"), "rb") as f:
                _OUT[mesh] = pickle.load(f)
        with np.load(os.path.join(root, "ckpt", "step_00000002", "arrays.npz")) as z:
            _OUT["saved"] = {k: z[k] for k in z.files}
    return _OUT


def _saved(arr, like):
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@pytest.mark.parametrize("mesh", [(4, 1), (1, 1)], ids=["4x1", "1x1"])
def test_restore_onto_another_mesh_is_the_saved_state(mesh):
    res = _results()
    got = res[mesh]
    assert got["restored_step"] == 2
    assert set(got["restored"]) == set(res["saved"])
    for key, leaf in got["restored"].items():
        assert torch.equal(leaf, _saved(res["saved"][key], leaf)), key


@pytest.mark.parametrize("mesh", [(4, 1), (1, 1)], ids=["4x1", "1x1"])
def test_step_after_restore_matches_the_uninterrupted_run(mesh):
    res = _results()
    want, got = res[(2, 2)], res[mesh]
    for name, ref in want["metrics"].items():
        assert abs(got["metrics"][name] - ref) <= METRIC_REL * abs(ref), name
    for key, p in got["params"].items():
        assert _rel(_np(p), _np(want["params"][key])) <= TREE_REL, key


def _launch(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable] + args, env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


def test_train_launcher_resumes_under_torchrun(tmp_path):
    """``torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train
    --device cpu --data 2 --fsdp``: 3 steps checkpointing after step 1,
    then a run from a directory holding only that checkpoint resumes there
    and logs the straight run's loss at step 2."""
    def run(ckpt, steps):
        out = _launch(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                       "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", PHI,
                       "--data", "2", "--fsdp", "--int8-opt", "--steps", str(steps),
                       "--batch", "4", "--seq-len", "16", "--ckpt-every", "1", "--log-every",
                       "1", "--ckpt-dir", str(ckpt),
                       "--heartbeat", str(tmp_path / "hb.json")])
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    straight = run(tmp_path / "straight", 3)
    assert "[train] mesh 2x1" in straight and "failed" not in straight
    os.makedirs(tmp_path / "resume")
    os.rename(tmp_path / "straight" / "step_00000002", tmp_path / "resume" / "step_00000002")
    resumed = run(tmp_path / "resume", 3)
    assert "restored step 2" in resumed
    loss = lambda text: [ln.split("loss")[1].split()[0] for ln in text.splitlines()
                         if ln.startswith("[train] step     2")]
    assert loss(resumed) == loss(straight) and len(loss(straight)) == 1
    assert straight.count("[train] step") == 3  # rank 0 alone logs


class _Mesh:  # the shape and coordinates a 2x2 DeviceMesh gives, without a world
    mesh_dim_names = ("data", "model")
    shape = (2, 2)

    @staticmethod
    def get_local_rank(axis):
        return 0

    @staticmethod
    def get_group(axis):
        return None


def test_train_launcher_refuses_another_family_on_a_mesh(tmp_path):
    """Every family trains under ``--mesh``: the enc_dec family's launcher
    run on a 1x1 mesh takes a step and checkpoints, and the placement of
    mamba2, jamba and whisper under the launcher's ``--fsdp`` rules on 2x2
    builds, and so does its checkpoint placement."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.sharded import TrainShard

    out = _launch(["-m", "repro_torch.launch.train", "--device", "cpu", "--arch",
                   "whisper-medium", "--mesh", "1,1", "--steps", "1", "--batch", "2",
                   "--seq-len", "16", "--ckpt-dir", str(tmp_path / "c"), "--heartbeat",
                   str(tmp_path / "hb.json")])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] mesh 1x1 (whisper-smoke; fsdp False, sp False)" in out.stdout
    assert (tmp_path / "c" / "step_00000001").is_dir()
    rules = sh.rules_for_mesh(_Mesh(), fsdp_axes=(sh.D_MODEL,), sp=True)
    for arch in ("mamba2-1.3b", "jamba-1.5-large-398b", "whisper-medium"):
        shard = TrainShard.of(get_config(arch, smoke=True), rules)
        assert shard.split.ssm == (arch != "whisper-medium") and shard.fsdp is not None
        assert shard.placement(AdamWConfig(state_dtype="int8")).specs["opt"]["m"]
