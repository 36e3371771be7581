"""The port's training stack against the JAX package's, on the CPU.

``cross_entropy``, ``warmup_cosine``, ``adamw_update`` (f32 and int8
moments) and one train step of each of eight smoke configs, from the same
numpy parameters, batches and states; rematerialisation bit for bit.

Tolerances:
  * cross entropy and the schedule: 1e-6 relative (f32 sums and one
    transcendental a value, in another order and library);
  * ``adamw_update`` in f32: 1e-6 relative to each leaf's scale (the same
    f32 arithmetic; the global norm sums its leaves in another order);
    int8 moment codes bit-exact (the codec's divisions and roundings are
    exact IEEE operations on equal inputs), scales within 1e-6 relative;
  * a train step: loss and grad norm within 1e-5 relative, each grad leaf
    within 1e-4 of its own max |g| (the forward and backward in f32 in
    another summation order; measured up to ~5e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.data import SyntheticLMDataset as JaxDataset
from repro.distributed import sharding as jsh
from repro.models import model_zoo as jzoo
from repro.optim import adamw as jadamw
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.training import train_step as jts

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, tree_to_numpy
from repro_torch.launch.train import fwd_kwargs, modality
from repro_torch.models import model_zoo
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine
from repro_torch.training import cross_entropy, make_loss_fn, make_train_step
from repro_torch.training.train_step import loss_and_grads
from repro_torch.utils.tree import tree_items, tree_leaves

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

SMOKE_ARCHS = ["phi4-mini-3.8b", "deepseek-7b", "gemma3-4b", "mixtral-8x22b",
               "llama4-scout-17b-a16e", "paligemma-3b", "mamba2-1.3b", "whisper-medium"]
B, S = 2, 32


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# cross entropy and the schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax_with_masked_labels(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 11, 97)) * 4).astype(np.float32)
    labels = rng.integers(0, 97, (3, 11)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 7] = -100
    jl = jnp.asarray(logits, dtype)
    want = float(jts.cross_entropy(jl, jnp.asarray(labels)))
    tl = params_from_numpy(np.asarray(jl), "cpu")
    got = cross_entropy(tl, torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= 1e-6 * abs(want)


def test_cross_entropy_gradient_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 9, 50)).astype(np.float32)
    labels = rng.integers(-1, 50, (2, 9)).astype(np.int32)
    jg = jax.grad(lambda x: jts.cross_entropy(x, jnp.asarray(labels)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    cross_entropy(t, torch.from_numpy(labels)).backward()
    assert _rel(t.grad.numpy(), jg) <= 1e-6


def test_all_labels_masked_gives_zero():
    logits = torch.randn(1, 4, 8)
    assert cross_entropy(logits, torch.full((1, 4), -1)).item() == 0.0


@pytest.mark.parametrize("warmup,decay", [(5, 50), (0, 30), (100, 10_000)])
def test_warmup_cosine_matches_jax(warmup, decay):
    for step in list(range(0, 12)) + [warmup, decay - 1, decay, decay + 7]:
        want = float(jax_warmup_cosine(step, 3e-4, warmup, decay))
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32), 3e-4, warmup, decay)
        assert got.dtype == torch.float32
        assert abs(got.item() - want) <= 1e-6 * want + 1e-12, (step, got.item(), want)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(6, 5, 4)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32),
              "n": {"scale": rng.normal(size=(3, 9)).astype(np.float32)}}
    grads = [{k: (rng.normal(size=np.shape(v)) * 0.3).astype(np.float32)
              if not isinstance(v, dict) else
              {"scale": (rng.normal(size=(3, 9)) * 0.3).astype(np.float32)}
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("clip", [1.0, 0.05], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(state_dtype, clip):
    params, grads = _opt_inputs(3)
    jcfg = jadamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=20, grad_clip=clip,
                              state_dtype=state_dtype)
    cfg = AdamWConfig(**dataclasses.asdict(jcfg))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jadamw.adamw_init(jp, jcfg)
    tp = params_from_numpy(params, "cpu")
    tstate = params_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    for g in grads:  # three steps: the moments carry over
        jp, jstate, jm = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), jstate, jcfg)
        tp, tstate, tm = adamw_update(tp, params_from_numpy(g, "cpu"), tstate, cfg)
        assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-6 * float(
            jm["grad_norm"])
        assert abs(tm["lr"].item() - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
        for (key, a), (_, b) in zip(sorted(tree_items(tree_to_numpy(tp))),
                                    sorted(tree_items(jax.tree.map(np.asarray, jp)))):
            assert _rel(a, b) <= 1e-6, key
        jflat = dict(tree_items(jax.tree.map(np.asarray, jstate)))
        for key, a in tree_items(tree_to_numpy(tstate)):
            if key.endswith("|q"):
                assert a.dtype == np.int8
                np.testing.assert_array_equal(a, jflat[key], err_msg=key)
            else:
                assert _rel(a, jflat[key]) <= 1e-6, key


def test_adamw_updates_in_place_and_refuses_zero():
    params = {"w": torch.ones(4, 3)}
    st = adamw_init(params, AdamWConfig())
    new, st2, _ = adamw_update(params, {"w": torch.full((4, 3), 0.5)}, st, AdamWConfig())
    assert new["w"] is params["w"] and st2["m"]["w"] is st["m"]["w"]
    assert int(st2["step"]) == 1 and not torch.equal(params["w"], torch.ones(4, 3))
    with pytest.raises(ValueError, match="item 7"):
        adamw_init(params, AdamWConfig(zero_partition=True))


# ---------------------------------------------------------------------------
# one train step of each smoke config
# ---------------------------------------------------------------------------


def _batch(cfg, seed=1):
    return JaxDataset(cfg.vocab_size, S, B, seed=seed, modality=modality(cfg)).batch(0)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_train_step_matches_jax(arch):
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jparams, _ = jzoo.init(jax.random.key(0), jcfg)
    nparams = jax.tree.map(np.asarray, jparams)
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = fwd_kwargs(jcfg)
    if jcfg.family == "ssm":
        kw["chunk"] = 16
    jopt = jadamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=50)
    jgrads = jax.jit(jax.grad(lambda p, b: jts.make_loss_fn(jcfg, jsh.ShardingRules(), kw)(p, b)[0]))(
        jparams, jbatch)
    _, jm = jax.jit(jts.make_train_step(jcfg, jsh.ShardingRules(), jopt, kw))(
        {"params": jparams, "opt": jadamw.adamw_init(jparams, jopt)}, jbatch)

    tparams = params_from_numpy(nparams, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, tgrads = loss_and_grads(make_loss_fn(tcfg, kw), tparams, tbatch)
    opt = AdamWConfig(**dataclasses.asdict(jopt))
    _, tm = make_train_step(tcfg, opt, kw)({"params": tparams, "opt": adamw_init(tparams, opt)},
                                           tbatch)
    for name in ("loss", "grad_norm", "ce"):
        assert abs(tm[name].item() - float(jm[name])) <= 1e-5 * abs(float(jm[name])), name
    jflat = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    for key, g in tree_items(tgrads):
        assert _rel(g.numpy(), jflat[key]) <= 1e-4, key
    assert set(jflat) == {k for k, _ in tree_items(tgrads)}


@pytest.mark.parametrize("arch", ["gemma3-4b", "mamba2-1.3b", "whisper-medium"])
def test_remat_is_bit_identical_on_the_cpu(arch):
    cfg = get_config(arch, smoke=True)
    params = model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    kw = dict(fwd_kwargs(cfg))
    if cfg.family == "ssm":
        kw["chunk"] = 16
    runs = []
    for remat in (False, True):
        loss, _, grads = loss_and_grads(make_loss_fn(cfg, dict(kw, remat=remat)), params, batch)
        runs.append((loss, tree_leaves(grads)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_grads_keep_the_parameters_flags_and_dtypes():
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True), dtype="bfloat16")
    params = model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, metrics, grads = loss_and_grads(make_loss_fn(cfg, dict(remat=True)), params, batch)
    assert all(not p.requires_grad for p in tree_leaves(params))
    assert [g.dtype for g in tree_leaves(grads)] == [p.dtype for p in tree_leaves(params)]
    assert np.isfinite(loss.item()) and set(metrics) == {"ce", "aux"}
