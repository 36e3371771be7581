"""The port's sharding rules against the reference's: every case of
``tests/test_sharding_rules.py`` on ``repro_torch.distributed.sharding``
(a spec is a plain tuple there), ``spec`` / ``spec_for_shape`` against
JAX's on an ``AbstractMesh`` of the same shape over random logical axes and
dims (hypothesis), and the pure-data trees: ``model_zoo.param_specs`` for
every family's smoke config, ``serving_param_specs``, ``cache_specs`` and
the launch helpers."""

import warnings

import pytest
from hypothesis import given, settings, strategies as st

import jax
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh
from repro.models import model_zoo as jzoo
from repro.serving import kv_cache as jkvc, sharded as jshd

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model_zoo
from repro_torch.serving import kv_cache as kvc, sharded as shd

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["phi4-mini-3.8b", "gemma3-1b", "gemma3-4b", "deepseek-7b", "mixtral-8x22b",
         "llama4-scout-17b-a16e", "paligemma-3b", "mamba2-1.3b", "jamba-1.5-large-398b",
         "whisper-medium"]
LOGICAL = [sh.BATCH, sh.SEQ, sh.TOKENS, sh.VOCAB, sh.D_MODEL, sh.HEADS, sh.KV_HEADS,
           sh.HEAD_DIM, sh.FF, sh.EXPERT, sh.LAYERS, sh.CONV, sh.STATE, sh.VISION, None]


def fake_mesh(shape, names):
    return dict(zip(names, shape))


def _norm(spec):
    """A spec as JAX's ``PartitionSpec`` holds it: a one-axis tuple entry is
    the axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


class TestRules:
    def test_default_tp_mapping(self):
        r = sh.ShardingRules()
        assert r.spec((sh.VOCAB, sh.D_MODEL)) == ("model", None)
        assert r.spec((sh.D_MODEL, sh.HEADS)) == (None, "model")
        assert r.spec((sh.BATCH, None, None)) == ("data", None, None)

    def test_multipod_batch_axes(self):
        r = sh.ShardingRules(batch_axes=("pod", "data"))
        assert r.spec((sh.BATCH, None)) == (("pod", "data"), None)

    def test_axis_used_once(self):
        r = sh.ShardingRules()
        assert r.spec((sh.HEADS, sh.KV_HEADS)) == ("model", None)

    def test_fsdp_axes(self):
        r = sh.ShardingRules(fsdp_axes=(sh.D_MODEL,))
        assert r.spec((sh.D_MODEL, sh.FF)) == (("data",), "model")

    def test_seq_shard_mode(self):
        r = sh.ShardingRules(seq_shard=True)
        assert r.spec((sh.LAYERS, sh.BATCH, sh.SEQ, sh.KV_HEADS, None)) == (
            None, None, ("data",), "model", None)

    def test_seq_unsharded_by_default(self):
        r = sh.ShardingRules()
        assert r.spec((sh.BATCH, sh.SEQ, None)) == ("data", None, None)


class TestDivisibilitySafety:
    def test_drops_nondividing_axis(self):
        mesh = fake_mesh((16, 16), ("data", "model"))
        spec = sh.ShardingRules().spec_for_shape(
            mesh, (sh.LAYERS, sh.BATCH, sh.SEQ, sh.KV_HEADS, None), (4, 128, 32768, 1, 256))
        assert spec == (None, "data", None, None, None)

    def test_keeps_dividing_axis(self):
        mesh = fake_mesh((16, 16), ("data", "model"))
        spec = sh.ShardingRules().spec_for_shape(mesh, (sh.D_MODEL, sh.HEADS), (4096, 8192))
        assert spec == (None, "model")

    def test_batch_of_one_replicates(self):
        mesh = fake_mesh((2, 16, 16), ("pod", "data", "model"))
        r = sh.ShardingRules(batch_axes=("pod", "data"))
        assert r.spec_for_shape(mesh, (sh.BATCH, None), (1, 1)) == (None, None)

    def test_tuple_axis_product(self):
        mesh = fake_mesh((2, 16, 16), ("pod", "data", "model"))
        r = sh.ShardingRules(batch_axes=("pod", "data"))
        assert r.spec_for_shape(mesh, (sh.BATCH, None), (64, 8)) == (("pod", "data"), None)
        assert r.spec_for_shape(mesh, (sh.BATCH, None), (16, 8)) == (None, None)


class TestFallbackWarning:
    def test_warns_on_nondividing_dim(self):
        mesh = fake_mesh((16, 16), ("data", "model"))
        with pytest.warns(sh.ShardingFallbackWarning, match="kv_heads.*dim 6.*not.*divisible"):
            spec = sh.ShardingRules().spec_for_shape(mesh, (sh.KV_HEADS, None), (6, 64))
        assert spec == (None, None)

    def test_warns_on_nondividing_tuple_axis(self):
        mesh = fake_mesh((2, 16, 16), ("pod", "data", "model"))
        r = sh.ShardingRules(batch_axes=("pod", "data"))
        with pytest.warns(sh.ShardingFallbackWarning, match="size 32"):
            r.spec_for_shape(mesh, (sh.BATCH, None), (16, 8))

    def test_silent_on_dim_one(self):
        mesh = fake_mesh((16, 16), ("data", "model"))
        with warnings.catch_warnings():
            warnings.simplefilter("error", sh.ShardingFallbackWarning)
            spec = sh.ShardingRules().spec_for_shape(mesh, (sh.KV_HEADS, sh.BATCH), (1, 32))
        assert spec == (None, "data")

    def test_silent_on_duplicate_axis(self):
        mesh = fake_mesh((16, 16), ("data", "model"))
        with warnings.catch_warnings():
            warnings.simplefilter("error", sh.ShardingFallbackWarning)
            spec = sh.ShardingRules().spec_for_shape(mesh, (sh.HEADS, sh.KV_HEADS), (32, 32))
        assert spec == ("model", None)


class TestRulesForMesh:
    def test_detects_pod_axis(self):
        assert sh.rules_for_mesh(tmesh.MeshShape((1, 1, 1), ("pod", "data", "model"))
                                 ).batch_axes == ("pod", "data")
        assert sh.rules_for_mesh(tmesh.MeshShape((1, 1), ("data", "model"))
                                 ).batch_axes == ("data",)

    def test_production_meshes_are_the_references_shapes(self):
        """The reference's 16 x 16 and 2 x 16 x 16 meshes (its docstring's
        shapes: building them needs 512 devices), as shapes and names."""
        assert "2×16×16" in jmesh.make_production_mesh.__doc__
        for multi in (False, True):
            got = tmesh.make_production_mesh(multi_pod=multi)
            assert got.shape == ({"pod": 2, "data": 16, "model": 16} if multi
                                 else {"data": 16, "model": 16})
            r, jr = sh.rules_for_mesh(got), jsh.rules_for_mesh(
                AbstractMesh(got.sizes, got.axis_names))
            assert r.batch_axes == jr.batch_axes

    def test_token_groups_and_group_sizes_match(self):
        for shape, names, batch_axes in (((2, 4), ("data", "model"), ("data",)),
                                         ((2, 16, 16), ("pod", "data", "model"),
                                          ("pod", "data"))):
            for sp in (False, True):
                r = sh.ShardingRules(batch_axes=batch_axes, sp=sp,
                                     mesh=fake_mesh(shape, names))
                jr = jsh.ShardingRules(batch_axes=batch_axes, sp=sp,
                                       mesh=AbstractMesh(shape, names))
                for n in (1, 6, 64, 96, 1024):
                    assert r.token_groups(n) == jr.token_groups(n)
                    assert r.group_sizes(n, 7) == jr.group_sizes(n, 7)
        assert sh.ShardingRules().token_groups(64) == 1
        assert sh.ShardingRules().group_sizes(64, 3) == (1, 1)

    def test_parse_mesh_arg_and_mesh_shape(self):
        for arg in (None, "", "2,4", "2x4", "1,1", "8x1"):
            assert shd.parse_mesh_arg(arg) == jshd.parse_mesh_arg(arg)
        for bad in ("2", "0,1", "1,2,3"):
            with pytest.raises(ValueError):
                shd.parse_mesh_arg(bad)
        assert shd.mesh_shape(None) == shd.mesh_shape(sh.ShardingRules()) == (1, 1)
        r = sh.rules_for_mesh(tmesh.MeshShape((2, 16, 16), ("pod", "data", "model")))
        assert shd.mesh_shape(r) == (32, 16)


_rules = st.builds(
    lambda batch, fsdp, seq, sp: (batch, fsdp, seq, sp),
    st.sampled_from([("data",), ("pod", "data")]),
    st.lists(st.sampled_from([sh.D_MODEL, sh.FF, sh.VOCAB]), max_size=2, unique=True),
    st.booleans(), st.booleans())


@given(_rules, st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=6),
       st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 32, 64, 96]), min_size=6,
                max_size=6),
       st.sampled_from([(2, 4), (16, 16), (1, 1), (4, 2), (3, 8)]))
@settings(max_examples=150, deadline=None)
def test_spec_and_spec_for_shape_are_the_references(knobs, axes, dims, size):
    """Over random logical axes, dims and rule knobs, the port's specs equal
    JAX's on an ``AbstractMesh`` of the same shape (and the fallback
    warning fires in the same cases)."""
    batch, fsdp, seq, sp = knobs
    names = ("pod", "data", "model") if len(batch) == 2 else ("data", "model")
    shape = ((2,) + size) if len(batch) == 2 else size
    kw = dict(batch_axes=batch, fsdp_axes=tuple(fsdp), seq_shard=seq, sp=sp)
    r, jr = sh.ShardingRules(**kw), jsh.ShardingRules(**kw)
    assert _norm(r.spec(tuple(axes))) == tuple(jr.spec(tuple(axes)))
    dims = tuple(dims[:len(axes)])
    with warnings.catch_warnings(record=True) as mine:
        warnings.simplefilter("always")
        got = r.spec_for_shape(fake_mesh(shape, names), tuple(axes), dims)
    with warnings.catch_warnings(record=True) as ref:
        warnings.simplefilter("always")
        want = jr.spec_for_shape(AbstractMesh(shape, names), tuple(axes), dims)
    assert _norm(got) == tuple(want)
    assert len(mine) == len(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_references(arch):
    """``model_zoo.param_specs`` equals the reference's tree for every
    family's smoke config, and so do its serving restriction and the rules'
    ``tree_specs`` of both."""
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    want, got = jzoo.param_specs(jcfg), model_zoo.param_specs(cfg)
    assert got == want
    assert shd.serving_param_specs(got) == jax.tree.map(
        tuple, jshd.serving_param_specs(want), is_leaf=lambda x: isinstance(x, tuple))
    r, jr = sh.ShardingRules(), jsh.ShardingRules()
    assert jax.tree.map(_norm, r.tree_specs(got), is_leaf=lambda x: isinstance(x, tuple)) \
        == jax.tree.map(tuple, jr.tree_specs(want), is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-4b", "jamba-1.5-large-398b",
                                  "whisper-medium", "mamba2-1.3b"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "bgpp"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_cache_specs_are_the_references(arch, fmt, layout):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jl = jkvc.layout_for(jcfg, 4, 48, kv_format=fmt, layout=layout, page_size=8)
    tl = kvc.layout_for(cfg, 4, 48, kv_format=fmt, layout=layout, page_size=8)
    assert kvc.cache_specs(cfg, tl) == jkvc.cache_specs(jcfg, jl)
