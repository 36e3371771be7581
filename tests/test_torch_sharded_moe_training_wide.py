"""The MoE and VLM families' sharded train step on meshes 1x2 and 2x2
(``tests/test_torch_sharded_moe_training.py`` holds 1x1 and 2x1 and says
how), so ``--dist loadfile`` spreads them; and a checkpoint of the MoE
train state saved on 2x2 and restored onto 1x2.

Over ``"model"`` the experts split their FF (``gate`` / ``up`` column
shards, ``down`` row shards, the shared expert as the dense MLP), ``sp``
splits the residual stream's sequence, and the heads split where 2
divides both counts (mixtral-smoke's and llama4-scout-smoke's 4 / 2; the
attention layers run K5's and K5b's plain versions with the sliding and
chunked masks on the rank's heads).  paligemma-smoke (no MoE, so no
grouping) is held to the JAX one-device step: its 4 q / 1 kv heads
replicate over 2 ranks, and ``sp`` splits its ``16 + 16``-row stream of
image prefix and text.  ``moe_apply`` on the 2x2 mesh's ranks (their rows
and FF shards) is held to the JAX one on the same mesh.

The checkpoint: a 2x2 world (mixtral-smoke, FSDP rules, ``sp``) trains
two steps and saves with ``shardings=``; a 1x2 world restores it with
``shardings=`` of its own mesh, and every whole leaf it holds, the expert
banks ``(L, E, d, f)`` that split on two dims included, is the saved one
bit for bit.
"""

import datetime
import os
import pickle
import tempfile
import warnings

import pytest
import torch

from test_torch_sharded_moe_training import (MIX, MOE_SCALE_REL, PALI, SCOUT, _ids, batches,
                                             check_case, check_moe_apply, jax_params, port_cfg)
from test_torch_sharded_training import KW, OPT, Case, spawn_world

torch.set_num_threads(1)

MESHES = {
    (1, 2): (Case(SCOUT, fsdp=True), Case(MIX, "int8"), Case(PALI, fsdp=True)),
    (2, 2): (Case(MIX, fsdp=True), Case(SCOUT), Case(MIX, "int8", fsdp=True), Case(PALI)),
}
MOE_APPLY = {(2, 2): (MIX, SCOUT)}


@pytest.mark.parametrize("mesh,i", [(m, i) for m, cs in MESHES.items() for i in range(len(cs))],
                         ids=_ids)
def test_sharded_moe_and_vlm_train_step_matches_jax(mesh, i):
    check_case(mesh, MESHES[mesh][i], MESHES[mesh], MOE_APPLY.get(mesh, ()))


@pytest.mark.parametrize("mesh,arch", [(m, a) for m, archs in MOE_APPLY.items() for a in archs],
                         ids=_ids)
def test_moe_apply_on_the_ranks_rows_and_ff_shards(mesh, arch):
    check_moe_apply(mesh, arch, MESHES[mesh], MOE_APPLY[mesh])


def _ckpt_worker(rank, world, mesh, root, save):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
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
        cfg = port_cfg(MIX)
        opt_cfg = AdamWConfig(state_dtype="int8", **OPT)
        shard = TrainShard.of(cfg, rules)
        with open(os.path.join(root, "params.pkl"), "rb") as f:
            params = shard.shard_params(params_from_numpy(pickle.load(f), "cpu"))
        state = {"params": params, "opt": adamw_init(params, opt_cfg)}
        placement = shard.placement(opt_cfg)
        ckpt = Checkpointer(os.path.join(root, "ckpt"), async_save=False)
        if save:
            step = make_train_step(cfg, opt_cfg, KW, rules=rules)
            for b in batches(cfg):
                state, _ = step(state, shard.local_rows(
                    {k: torch.from_numpy(v) for k, v in b.items()}))
            ckpt.save(2, state, shardings=placement)
        else:
            _, state = ckpt.restore(state, shardings=placement)
        whole = {"params": shard.gather_whole(state["params"]),
                 "opt": shard.gather_whole(state["opt"], placement.specs["opt"])}
        local = dict(tree_items(state["params"]))
        if rank == 0:
            with open(os.path.join(root, f"{d}x{m}.pkl"), "wb") as f:
                pickle.dump({"whole": dict(tree_items(whole)),
                             "local_shapes": {k: tuple(v.shape) for k, v in local.items()}}, f)
    finally:
        dist.destroy_process_group()


def test_moe_checkpoint_saved_on_2x2_restores_onto_1x2():
    """The int8 train state of mixtral-smoke saved from a 2x2 world (each
    leaf gathered whole, rank 0 writing) and restored by a 1x2 world (each
    rank cutting its block): every whole leaf bit for bit, and the expert
    banks held in blocks on two dims (d over ``"data"`` on 2x2, f over
    ``"model"`` on both)."""
    root = tempfile.mkdtemp(prefix="moe-ckpt-")
    with open(os.path.join(root, "params.pkl"), "wb") as f:
        pickle.dump(jax_params(MIX), f)
    spawn_world(4, _ckpt_worker, ((2, 2), root, True), root)
    spawn_world(2, _ckpt_worker, ((1, 2), root, False), root)
    with open(os.path.join(root, "2x2.pkl"), "rb") as f:
        saved = pickle.load(f)
    with open(os.path.join(root, "1x2.pkl"), "rb") as f:
        restored = pickle.load(f)
    assert set(saved["whole"]) == set(restored["whole"])
    for key, x in saved["whole"].items():
        assert torch.equal(restored["whole"][key], x), key
    cfg = port_cfg(MIX)
    L, E, d, f = cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff
    assert saved["local_shapes"]["layers|moe|gate"] == (L, E, d // 2, f // 2)
    assert restored["local_shapes"]["layers|moe|gate"] == (L, E, d, f // 2)
    assert saved["local_shapes"]["layers|moe|down"] == (L, E, f // 2, d // 2)
    assert saved["local_shapes"]["layers|moe|router"] == (L, d // 2, E)
    assert int(saved["whole"]["opt|step"]) == 2
