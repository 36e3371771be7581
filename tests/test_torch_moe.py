"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's,
on the CPU.

The same JAX-initialised parameters (brought across with
``interop.params_from_numpy``) and numpy-seeded inputs go through
``repro.models.moe.moe_apply`` and the port's, in float32:

  * at (E, k) in {(4, 1), (4, 2), (8, 2)}, with and without a shared
    expert, at capacity factors 0.25, 1.0, 1.25 and E: the kept (token,
    slot) set equal bit for bit (JAX's from the reference's own routing
    ops), ``y`` and ``aux`` within 1e-5;
  * a router with tied columns picks JAX's expert (``jax.lax.top_k``'s
    order: the lower index first);
  * the ports of ``tests/test_properties.py``'s ``TestMoEDispatchInvariants``
    as hypothesis tests (dropless = the dense weighted sum of every expert;
    dropping only shrinks);
  * isolation: a token's dropless output is the same bits whatever its
    neighbours are and route to.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import moe as jmoe

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

EK = [(4, 1), (4, 2), (8, 2)]
TOL = 1e-5


def _cfgs(E, k, shared=0, cf=1.25):
    """The mixtral smoke config (d_model 64, d_ff 128, f32) with the MoE
    knobs replaced, on both sides."""
    kw = dict(num_experts=E, experts_per_token=k, moe_shared_ff=shared,
              moe_capacity_factor=cf)
    return (dataclasses.replace(jax_config("mixtral-8x22b", smoke=True), **kw),
            dataclasses.replace(get_config("mixtral-8x22b", smoke=True), **kw))


def _params(jcfg, seed):
    jp, _ = jmoe.moe_init(jax.random.key(seed), jcfg, jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _jax_keep(jp, x, jcfg):
    """The reference's routing ops (``repro/models/moe.py``, one token
    group): ``(expert_idx (T, k), keep (T, k))``."""
    E, k = jcfg.num_experts, jcfg.experts_per_token
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    T = xt.shape[0]
    probs = jax.nn.softmax((xt @ jp["router"]).astype(jnp.float32), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    capacity = min(int(max(1, math.ceil(T * k / E * jcfg.moe_capacity_factor))), T * k)
    flat = jax.nn.one_hot(expert_idx, E, dtype=jnp.int32).reshape(T * k, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - 1) * flat, axis=-1).reshape(T, k)
    return np.asarray(expert_idx), np.asarray(pos < capacity)


@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, "E"])
@pytest.mark.parametrize("shared", [0, 96])
@pytest.mark.parametrize("ek", EK, ids=lambda ek: f"E{ek[0]}k{ek[1]}")
def test_moe_apply_matches_jax(ek, shared, cf):
    E, k = ek
    cf = float(E) if cf == "E" else cf
    jcfg, cfg = _cfgs(E, k, shared, cf)
    jp, tp = _params(jcfg, 10 * E + k)
    x = np.random.default_rng(E + k + shared).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    r = moe.route(tp, torch.from_numpy(x), cfg)
    jexp, jkeep = _jax_keep(jp, x, jcfg)
    np.testing.assert_array_equal(r["experts"].numpy(), jexp)
    np.testing.assert_array_equal(r["keep"].numpy(), jkeep)
    if cf < 1:
        assert not jkeep.all()  # the case drops
    if cf == E:
        assert jkeep.all()  # dropless
    assert r["capacity"] == moe.capacity_of(48, cfg, cf)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    assert aux.shape == () and aux.dtype == torch.float32
    assert abs(float(aux) - float(jaux)) <= TOL


@pytest.mark.parametrize("ek", EK, ids=lambda ek: f"E{ek[0]}k{ek[1]}")
def test_tied_router_columns_pick_jax_expert(ek):
    """Every router column equal (all probabilities tie), then two equal
    leading columns: the port keeps JAX's experts and JAX's output."""
    E, k = ek
    jcfg, cfg = _cfgs(E, k, cf=1.0)
    jp, _ = _params(jcfg, 3)
    rng = np.random.default_rng(4)
    col = np.abs(rng.normal(size=(cfg.d_model, 1))).astype(np.float32)
    routers = [np.repeat(col, E, axis=1),
               np.concatenate([rng.normal(size=(cfg.d_model, E - 2)).astype(np.float32) * 0.01,
                               np.repeat(col * 3, 2, axis=1)], axis=1)]
    x = np.abs(rng.normal(size=(1, 12, cfg.d_model))).astype(np.float32)
    for router in routers:
        jpr = dict(jp, router=jnp.asarray(router))
        tpr = params_from_numpy(jax.tree.map(np.asarray, jpr), "cpu")
        jexp, jkeep = _jax_keep(jpr, x, jcfg)
        r = moe.route(tpr, torch.from_numpy(x), cfg)
        np.testing.assert_array_equal(r["experts"].numpy(), jexp)
        np.testing.assert_array_equal(r["keep"].numpy(), jkeep)
        jy, _ = jmoe.moe_apply(jpr, jnp.asarray(x), jcfg)
        y, _ = moe.moe_apply(tpr, torch.from_numpy(x), cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    # the tied pair leads, the lower index first
    assert (jexp[:, 0] == E - 2).all() and (k == 1 or (jexp[:, 1] == E - 1).all())


def _torch_cfg(E, k, cf=8.0):
    """``test_properties.moe_cfg``'s config on the port (d_model 16, d_ff 32)."""
    return dataclasses.replace(get_config("mixtral-8x22b", smoke=True), num_layers=1,
                               d_model=16, d_ff=32, num_experts=E, experts_per_token=k,
                               moe_capacity_factor=cf, moe_shared_ff=0)


class TestMoEDispatchInvariants:
    """``tests/test_properties.py``'s invariants on the port's ``moe_apply``,
    with parameters from the port's own ``moe_init``."""

    @given(st.integers(0, 2**31 - 1), st.sampled_from(EK))
    @settings(max_examples=12, deadline=None)
    def test_dropless_capacity_is_exact_weighted_sum(self, seed, ek):
        """With dropless capacity, the MoE output equals the explicit
        dense-expert weighted sum — no token lost, duplicated or misrouted."""
        E, k = ek
        cfg = _torch_cfg(E, k, cf=float(E))
        params = moe.moe_init(cfg, torch.Generator().manual_seed(seed % 1000), "cpu")
        x = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(2, 4, cfg.d_model)).astype(np.float32))
        y, _ = moe.moe_apply(params, x, cfg)
        xt = x.reshape(-1, cfg.d_model)
        probs = torch.softmax((xt @ params["router"]).float(), -1)
        gv, ei = torch.sort(probs, dim=-1, descending=True, stable=True)
        gv, ei = gv[:, :k], ei[:, :k]
        if k > 1:
            gv = gv / gv.sum(-1, keepdim=True)
        outs = torch.stack([(torch.nn.functional.silu(xt @ params["gate"][e])
                             * (xt @ params["up"][e])) @ params["down"][e]
                            for e in range(E)], 1)  # (T, E, D)
        ref = torch.zeros_like(xt)
        for j in range(k):
            ref = ref + gv[:, j:j + 1] * outs[torch.arange(xt.shape[0]), ei[:, j]]
        np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(), ref.numpy(),
                                   rtol=2e-4, atol=2e-4)

    @given(st.integers(0, 2**31 - 1))
    @settings(max_examples=8, deadline=None)
    def test_capacity_drop_only_shrinks(self, seed):
        """Dropping tokens (small capacity) never creates output where the
        dropless version had none, and a dropped token's routed output is 0."""
        cfg_full, cfg_tight = _torch_cfg(4, 1, cf=4.0), _torch_cfg(4, 1, cf=0.25)
        params = moe.moe_init(cfg_full, torch.Generator().manual_seed(1), "cpu")
        x = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(1, 8, cfg_full.d_model)).astype(np.float32))
        y_full, _ = moe.moe_apply(params, x, cfg_full)
        y_tight, _ = moe.moe_apply(params, x, cfg_tight)
        nf = y_full.reshape(8, -1).norm(dim=1)
        nt = y_tight.reshape(8, -1).norm(dim=1)
        assert (nt <= nf + 1e-4).all()
        r = moe.route(params, x, cfg_tight)
        dropped = ~r["keep"][:, 0]
        # capacity 1: each expert keeps its first token, drops the rest
        assert r["capacity"] == 1 and dropped.sum() == 8 - len(set(r["experts"][:, 0].tolist()))
        assert not y_tight.reshape(8, -1)[dropped].any()


@pytest.mark.parametrize("ek", EK, ids=lambda ek: f"E{ek[0]}k{ek[1]}")
def test_dropless_token_is_isolated_from_its_neighbours(ek):
    """Token 0's dropless output, bit for bit, beside neighbours drawn
    anew (they route elsewhere) and beside 1 to 6 of them (other buffer
    heights), with a shared expert."""
    E, k = ek
    _, cfg = _cfgs(E, k, shared=96, cf=float(E))
    params = moe.moe_init(cfg, torch.Generator().manual_seed(7), "cpu")
    rng = np.random.default_rng(8)
    tok = rng.normal(size=(1, 1, cfg.d_model)).astype(np.float32)
    outs, routes = [], set()
    for n in (1, 2, 3, 6, 6, 6):
        x = np.concatenate([tok, rng.normal(size=(1, n, cfg.d_model)).astype(np.float32)], 1)
        x = torch.from_numpy(x)
        y, _ = moe.moe_apply(params, x, cfg, capacity_factor=float(E))
        outs.append(y[0, 0])
        routes.add(tuple(moe.route(params, x, cfg)["experts"][1:].reshape(-1).tolist()))
    assert len(routes) == 6  # the neighbours routed differently each time
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    alone, _ = moe.moe_apply(params, torch.from_numpy(tok), cfg, capacity_factor=float(E))
    assert torch.equal(alone[0, 0], outs[0])


def test_init_tree_and_scales():
    """``moe_init``: the reference's leaves, shapes and scales, stacked on
    request."""
    jcfg, cfg = _cfgs(4, 2, shared=96)
    jp, _ = _params(jcfg, 0)
    tp = moe.moe_init(cfg, torch.Generator().manual_seed(0), "cpu", stack=3)
    flat = lambda t, p="": {f"{p}{n}": v for n, v in t.items() if not isinstance(v, dict)} | {
        k: v for n, sub in t.items() if isinstance(sub, dict)
        for k, v in flat(sub, f"{p}{n}/").items()}
    jl, tl = flat(jax.tree.map(np.asarray, jp)), flat(tp)
    assert set(jl) == set(tl)
    for n, a in jl.items():
        assert tuple(tl[n].shape) == (3,) + a.shape and tl[n].dtype == torch.float32, n
    d, f = cfg.d_model, cfg.d_ff
    for n, fan_in in (("router", d), ("gate", d), ("up", d), ("down", f),
                      ("shared/gate", d), ("shared/down", 96)):
        assert abs(float(tl[n].std()) * math.sqrt(fan_in) - 1) < 0.05, n
