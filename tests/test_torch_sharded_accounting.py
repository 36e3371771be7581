"""The byte counters' mesh columns against the reference's, as integers:
``kv_cache.decode_read_bytes`` / ``chunk_read_bytes`` (``per_device`` and
``interconnect``) and ``mesh_shard_factors`` for every KV format, layout
and mesh, and the weight plan's mesh columns (``per_device``,
``per_device_by_placement``, ``shards_by_placement``) for every weight
format; plus the mesh laws of ``tests/test_properties.py`` that
``tests/test_torch_properties.py`` leaves out (``TestKVReadAccountingLaws``
and ``TestWeightReadAccountingLaws`` on a mesh)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax

from repro.configs import apply_weight_format_override as japply
from repro.configs import get_config as jax_config
from repro.models import model_zoo as jzoo
from repro.serving import kv_cache as jkvc, weights as jswt

from repro_torch.configs import apply_weight_format_override, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.serving import kv_cache as kvc, weights as swt

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCHS = ["deepseek-7b", "phi4-mini-3.8b", "gemma3-4b", "jamba-1.5-large-398b",
         "llama4-scout-17b-a16e", "mixtral-8x22b", "paligemma-3b"]
MESHES = [(1, 1), (2, 1), (1, 2), (1, 4), (2, 4), (4, 2), (3, 1), (16, 16)]


def _layouts(arch, fmt, layout, slots=4):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    kw = dict(kv_format=fmt, layout=layout, page_size=8)
    return jcfg, cfg, jkvc.layout_for(jcfg, slots, 48, **kw), kvc.layout_for(cfg, slots, 48, **kw)


def _rounded(tree):
    """Every number of a counter tree rounded to an integer, as the stats
    report them."""
    if isinstance(tree, dict):
        return {k: _rounded(v) for k, v in tree.items()}
    return round(tree) if isinstance(tree, float) else tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fmt", ["bf16", "int8", "bgpp"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_kv_counters_mesh_columns_are_the_references(arch, fmt, layout):
    """Every mesh, batches 3 and 4: the whole counter dicts (per-device and
    interconnect columns included) equal the reference's, and so do the
    shard factors, the chunk's at widths 1 and 6."""
    for slots in (3, 4):
        jcfg, cfg, jl, tl = _layouts(arch, fmt, layout, slots)
        for mesh in MESHES:
            assert kvc.mesh_shard_factors(tl, cfg, mesh) == jkvc.mesh_shard_factors(jl, jcfg, mesh)
            got, want = kvc.decode_read_bytes(tl, cfg, mesh), jkvc.decode_read_bytes(jl, jcfg, mesh)
            assert _rounded(got) == _rounded(want), mesh
            for key in ("per_device", "interconnect"):
                assert got[key] == want[key], (mesh, key)
            for width in (1, 6):
                got = kvc.chunk_read_bytes(tl, cfg, mesh, chunk_width=width)
                want = jkvc.chunk_read_bytes(jl, jcfg, mesh, chunk_width=width)
                assert got == want, (mesh, width)


_PLANS = {}


def _plans(fmt):
    """(jax cfg, cfg, layout, the reference's plan, the port's) on
    deepseek-7b-smoke from the same values."""
    if fmt not in _PLANS:
        jcfg = japply(jax_config("deepseek-7b", smoke=True), fmt)
        cfg = apply_weight_format_override(get_config("deepseek-7b", smoke=True), fmt)
        jparams, _ = jzoo.init(jax.random.key(0), jcfg)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        jl = jkvc.layout_for(jcfg, 4, 48, kv_format="bf16")
        tl = kvc.layout_for(cfg, 4, 48, kv_format="bf16")
        _, jplan = jswt.prepare_serve_params(jparams, jcfg, jl, fmt)
        _, tplan = swt.prepare_serve_params(tparams, cfg, fmt)
        _PLANS[fmt] = (jcfg, cfg, jl, tl, jplan, tplan)
    return _PLANS[fmt]


@pytest.mark.parametrize("fmt", ["bf16", "int8", "bstc"])
def test_weight_plan_mesh_columns_are_the_references(fmt):
    """Placements entry by entry, and on every mesh the per-device columns
    as integers."""
    jcfg, cfg, jl, tl, jplan, tplan = _plans(fmt)
    assert [(e.path, e.placement) for e in tplan.entries] == \
        [(e.path, e.placement) for e in jplan.entries]
    for mesh in MESHES:
        got, want = tplan.decode_read_bytes(tl, cfg, mesh), jplan.decode_read_bytes(jl, jcfg, mesh)
        for key in ("per_device", "per_device_by_placement", "shards_by_placement"):
            assert _rounded(got[key]) == _rounded(want[key]), (mesh, key)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "mixtral-8x22b", "paligemma-3b"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "bstc"])
def test_moe_and_vlm_weight_plan_mesh_columns_are_the_references(arch, fmt):
    """The MoE and VLM families' weight plans on every mesh, as the
    reference's: the same entries and placements (the router, the expert
    banks, the shared expert and ``vision_proj`` stay raw and out of the
    plan), and the per-device columns as integers."""
    jcfg = japply(jax_config(arch, smoke=True), fmt)
    cfg = apply_weight_format_override(get_config(arch, smoke=True), fmt)
    jparams, _ = jzoo.init(jax.random.key(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jl = jkvc.layout_for(jcfg, 4, 48, kv_format="bf16")
    tl = kvc.layout_for(cfg, 4, 48, kv_format="bf16")
    _, jplan = jswt.prepare_serve_params(jparams, jcfg, jl, fmt)
    _, tplan = swt.prepare_serve_params(tparams, cfg, fmt)
    assert [(e.path, e.placement) for e in tplan.entries] == \
        [(e.path, e.placement) for e in jplan.entries]
    assert not any("moe" in str(e.path) or "vision" in str(e.path) for e in tplan.entries)
    for mesh in MESHES:
        got, want = tplan.decode_read_bytes(tl, cfg, mesh), jplan.decode_read_bytes(jl, jcfg, mesh)
        for key in ("per_device", "per_device_by_placement", "shards_by_placement"):
            assert _rounded(got[key]) == _rounded(want[key]), (mesh, key)


class TestKVReadAccountingLawsOnAMesh:
    """``tests/test_properties.py``'s mesh laws of the KV counters, on the
    port (deepseek-7b-smoke: 4 q / 4 kv heads, batch 4)."""

    CFG = get_config("deepseek-7b", smoke=True)

    def _layout(self, fmt, layout, slots=4):
        return kvc.layout_for(self.CFG, slots, 48, kv_format=fmt, layout=layout, page_size=8)

    @given(st.sampled_from(["bf16", "int8", "bgpp"]), st.sampled_from(["slot", "paged"]),
           st.sampled_from([(1, 1), (2, 1), (1, 2), (1, 4), (2, 4), (4, 2)]))
    @settings(max_examples=24, deadline=None)
    def test_per_device_times_shards_is_total(self, fmt, layout, mesh):
        lay = self._layout(fmt, layout)
        out = kvc.decode_read_bytes(lay, self.CFG, mesh)
        pd = out["per_device"]
        assert pd["shards"] == mesh[0] * mesh[1]
        np.testing.assert_allclose(pd["total"] * pd["shards"], out["total"])
        np.testing.assert_allclose(pd["global"] + pd["local"], pd["total"])
        ck = kvc.chunk_read_bytes(lay, self.CFG, mesh)
        np.testing.assert_allclose(ck["per_device"]["total"] * ck["per_device"]["shards"],
                                   ck["total"])

    @pytest.mark.parametrize("fmt", ["bf16", "int8", "bgpp"])
    @pytest.mark.parametrize("layout", ["slot", "paged"])
    def test_interconnect_zero_at_1x1(self, fmt, layout):
        lay = self._layout(fmt, layout)
        for reader in (kvc.decode_read_bytes, kvc.chunk_read_bytes):
            assert reader(lay, self.CFG, (1, 1))["interconnect"]["total"] == 0.0

    @pytest.mark.parametrize("fmt", ["bf16", "int8", "bgpp"])
    @pytest.mark.parametrize("layout", ["slot", "paged"])
    def test_attend_allgather_monotone_in_model(self, fmt, layout):
        lay = self._layout(fmt, layout)
        ag = [kvc.decode_read_bytes(lay, self.CFG, (1, m))["interconnect"]["attend_allgather"]
              for m in (1, 2, 4)]
        assert ag[0] == 0.0 and ag[0] < ag[1] < ag[2]

    def test_indivisible_shapes_fall_back_to_replication(self):
        # phi4 smoke: 6 q / 2 kv heads, neither divides model 4; batch 3
        # does not divide data 2
        cfg = get_config("phi4-mini-3.8b", smoke=True)
        lay = kvc.layout_for(cfg, 3, 48, kv_format="bf16", layout="slot")
        assert kvc.mesh_shard_factors(lay, cfg, (2, 4)) == (1, 1)
        out = kvc.decode_read_bytes(lay, cfg, (2, 4))
        assert out["per_device"]["shards"] == 1
        assert out["interconnect"]["total"] == 0.0

    def test_chunk_paged_write_broadcast_is_zero(self):
        lay = self._layout("int8", "paged")
        for mesh in ((2, 1), (2, 4), (4, 2)):
            assert kvc.chunk_read_bytes(lay, self.CFG, mesh)["interconnect"][
                "paged_write_bcast"] == 0.0
            assert kvc.decode_read_bytes(lay, self.CFG, mesh)["interconnect"][
                "paged_write_bcast"] > 0.0


class TestWeightReadAccountingLawsOnAMesh:
    """The weight plan's per-placement shares recombine to the whole on
    every mesh (``tests/test_properties.py:257``), on the port's plan."""

    @given(st.sampled_from(["bf16", "int8", "bstc"]),
           st.sampled_from([(1, 1), (2, 1), (1, 2), (1, 4), (2, 4), (4, 2)]))
    @settings(max_examples=18, deadline=None)
    def test_per_device_times_shards_is_total(self, fmt, mesh):
        _, cfg, _, lay, _, plan = _plans(fmt)
        out = plan.decode_read_bytes(lay, cfg, mesh)
        recomposed = sum(out["per_device_by_placement"][p] * out["shards_by_placement"][p]
                         for p in out["per_device_by_placement"])
        np.testing.assert_allclose(recomposed, out["total"])
        np.testing.assert_allclose(out["total"], plan.total_bytes)
        np.testing.assert_allclose(sum(out["per_projection"].values()), out["total"])
