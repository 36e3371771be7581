"""The ssm and hybrid families' sharded train step on meshes 1x2 and 2x2
(``tests/test_torch_sharded_ssm_training.py`` holds 1x1 and 2x1 and says
how), so ``--dist loadfile`` spreads them; ``mixer_apply`` alone on a 1x2
split; and the segmented split's round trips: ``gather_whole`` of
``cut_tree`` and a checkpoint of a 2x2 train state.

Over ``"model"`` each mixer runs its heads (mamba2-smoke's and
jamba-smoke's 4 mamba heads, 2 a rank), ``sp`` gathers the sequence at the
mixer's entry and reduce-scatters ``out_proj``'s row-parallel products
after it; jamba's attention layer splits its 4 / 2 heads and its MoE
layers their FF, and the replicated leaves and whole parts (``A_log``,
``D``, ``dt_bias``, ``B`` / ``C``'s columns and channels, the norms, the
router) and their gradients are bit-equal on every model rank.

``mixer_apply`` on a 1x2 split (the rank's heads, the gated norm's squares
summed over ``"model"``, ``out_proj`` row-parallel) is held to the JAX
``mixer_apply`` within 1e-5 of max |y|, on a mixer whose ``A_log``, ``D``,
``dt_bias`` and norm scale differ head by head; the same split with the
gated norm's sum over ``"model"`` left out misses it by more.
"""

import os
import pickle
import tempfile

import numpy as np
import pytest
import torch

from test_torch_sharded_ssm_training import (JAMBA, MAMBA, Case, _ids, check_case, jax_mesh,
                                             port_cfg, rules_of, run_case, start)
from test_torch_sharded_training import jax_params, spawn_world

torch.set_num_threads(1)

MESHES = {
    (1, 2): (Case(MAMBA, fsdp=True), Case(JAMBA)),
    (2, 2): (Case(MAMBA, "int8", fsdp=True),),
}
Y_REL = 1e-5  # mixer_apply on the ranks' heads against JAX's, of max |y|
MIXER_B, MIXER_S, MIXER_CHUNK = 2, 16, 8


def mixer_inputs():
    """Layer 0's mixer of mamba2-smoke's JAX init with ``A_log``, ``D``,
    ``dt_bias`` and the norm's scale drawn head by head (numpy), and an
    input ``(B, S, d_model)``."""
    cfg = port_cfg(MAMBA)
    rng = np.random.default_rng(11)
    p = {k: (v[0] if not isinstance(v, dict) else {n: t[0] for n, t in v.items()})
         for k, v in jax_params(MAMBA)["layers"]["mixer"].items()}
    for k in ("A_log", "D", "dt_bias"):
        p[k] = rng.normal(size=p[k].shape).astype(np.float32) * 0.5
    p["norm"] = {"scale": rng.normal(size=p["norm"]["scale"].shape).astype(np.float32) * 0.3}
    x = rng.normal(size=(MIXER_B, MIXER_S, cfg.d_model)).astype(np.float32)
    return p, x


def mixer_on_ranks(rules):
    """``mixer_apply`` on this rank's heads (and sequence rows under
    ``sp``) -> ``(y, y without the gated norm's sum over "model")``, each
    gathered whole."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import mamba2
    from repro_torch.training.sharded import TrainShard

    cfg = port_cfg(MAMBA)
    shard = TrainShard.of(cfg, rules)
    p, x = mixer_inputs()
    p = params_from_numpy(p, "cpu")
    phys = sh.physical_specs(p, mamba2.mixer_specs(), rules, (),
                             mamba2.mixer_segments(cfg, True))
    p = sh.cut_tree(p, phys, rules)
    split = shard.forward_kwargs(MIXER_S)["split"]
    x = torch.from_numpy(x)
    if split.seq:
        x = sh.own_block(x, split.group, 1)
    whole = mamba2._gated_norm
    out = []
    for norm in (whole, lambda g, scale, cfg, split=None: whole(g, scale, cfg, None)):
        mamba2._gated_norm = norm
        try:
            with torch.no_grad():
                y = mamba2.mixer_apply(p, cfg, x, chunk=MIXER_CHUNK, split=split)
        finally:
            mamba2._gated_norm = whole
        out.append((sh.all_gather(y, split.group, 1) if split.seq else y).numpy())
    return out


def worker(rank, world, mesh, cases, root):
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.interop import params_from_numpy
    from repro_torch.optim import adamw_init
    from repro_torch.utils.tree import tree_items

    debug = start(rank, world, root, mesh)
    try:
        with open(os.path.join(root, "params.pkl"), "rb") as f:
            numpy_params = pickle.load(f)
        out = {"cases": {}}
        for case in cases:
            res, shard, state, opt_cfg = run_case(case, rules_of(debug, case.fsdp, mesh[1]),
                                                  numpy_params[case.arch])
            out["cases"][case] = res
            if mesh == (2, 2) and case.state_dtype == "int8":  # save, restore, compare
                placement = shard.placement(opt_cfg)
                ckpt = Checkpointer(os.path.join(root, "ckpt"), async_save=False)
                ckpt.save(2, state, shardings=placement)
                fresh = shard.shard_params(params_from_numpy(numpy_params[case.arch], "cpu"))
                template = {"params": fresh, "opt": adamw_init(fresh, opt_cfg)}
                _, back = ckpt.restore(template, shardings=placement)
                out["restored_equal"] = all(
                    torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(back),
                                                                tree_items(state)))
                out["saved_whole"] = {
                    "params": res["params"],
                    "opt": {k: v for k, v in res["opt"].items()}}
                whole = params_from_numpy(numpy_params[case.arch], "cpu")
                again = shard.gather_whole(shard.shard_params(whole))
                out["cut_gather_equal"] = all(
                    torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(again),
                                                                tree_items(whole)))
        if mesh == (1, 2):
            out["mixer"] = mixer_on_ranks(rules_of(debug, False, mesh[1]))
        if rank == 0:
            with open(os.path.join(root, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


_RESULTS = {}


def sharded(mesh):
    """One mesh's world's results (spawned once)."""
    if mesh not in _RESULTS:
        d, m = mesh
        cases = MESHES[mesh]
        root = tempfile.mkdtemp(prefix=f"ssm-train-wide{d}x{m}-")
        with open(os.path.join(root, "params.pkl"), "wb") as f:
            pickle.dump({c.arch: jax_params(c.arch) for c in cases}, f)
        spawn_world(d * m, worker, (mesh, cases, root), root)
        with open(os.path.join(root, "out.pkl"), "rb") as f:
            _RESULTS[mesh] = pickle.load(f)
        _RESULTS[mesh]["root"] = root
    return _RESULTS[mesh]


@pytest.mark.parametrize("mesh,i", [(m, i) for m, cs in MESHES.items() for i in range(len(cs))],
                         ids=_ids)
def test_sharded_ssm_and_hybrid_train_step_matches_jax(mesh, i):
    case = MESHES[mesh][i]
    check_case(mesh, case, sharded(mesh)["cases"][case], jax_mesh(mesh, MESHES[mesh])[case])


def test_mixer_apply_on_a_head_split_needs_the_gated_norms_sum():
    """``mixer_apply`` on 1x2 (``sp``: each rank's sequence rows gathered
    at the entry) against the JAX ``mixer_apply`` within 1e-5 of max |y|;
    the gated norm's sum of squares left to each rank's own heads misses it
    by more than 1e-3."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import mamba2 as jmamba2

    jax.config.update("jax_platform_name", "cpu")
    p, x = mixer_inputs()
    want = np.asarray(jmamba2.mixer_apply(jax.tree.map(jnp.asarray, p),
                                          jax_config(MAMBA, smoke=True), jnp.asarray(x),
                                          chunk=MIXER_CHUNK))
    got, unsummed = sharded((1, 2))["mixer"]
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= Y_REL * scale
    assert float(np.abs(unsummed - want).max()) > 1e-3 * scale


def test_cut_then_gather_is_the_whole_tree():
    """On 2x2 under the FSDP rules, ``gather_whole(cut_tree(params))`` of
    mamba2-smoke's whole tree is that tree bit for bit (its segmented
    ``in_proj`` and conv leaves included)."""
    assert sharded((2, 2))["cut_gather_equal"]


def test_checkpoint_of_a_2x2_state_round_trips():
    """The int8 train state of mamba2-smoke after two steps on 2x2, saved
    with ``shardings=`` and restored onto a fresh 2x2 template: every local
    leaf bit for bit; the file holds the whole tree in the reference's
    column order (each leaf the gathered whole one, ``in_proj`` ``2 d_in +
    2 N + H`` wide)."""
    res = sharded((2, 2))
    assert res["restored_equal"]
    step = os.path.join(res["root"], "ckpt", "step_00000002")
    with np.load(os.path.join(step, "arrays.npz")) as z:
        saved = {k: z[k] for k in z.files}
    whole = res["saved_whole"]
    for part in ("params", "opt"):
        for key, x in whole[part].items():
            np.testing.assert_array_equal(saved[f"{part}|{key}"], x.numpy(), err_msg=key)
    cfg = port_cfg(MAMBA)
    d_in = cfg.ssm_expand * cfg.d_model
    assert saved["params|layers|mixer|in_proj"].shape == (
        cfg.num_layers, cfg.d_model, 2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim)
