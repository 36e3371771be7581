"""The MoE and VLM families served on ``(data, model)`` meshes through the
port's Scheduler, rehearsed on the CPU in gloo worlds.

The serving placement is bit-exact by construction
(``src/repro/serving/sharded.py:1-25``): the experts, the router and the
shared expert stay replicated, the decode and chunk steps route dropless
on each rank's own slots, and an eager admission is one row.  So a
sharded MoE or VLM run is the single-device run's bits, as the dense
family's is (``tests/test_torch_sharded_serving.py``, whose request trace,
sizes and checks this file reuses).

mixtral-smoke (4 experts top-2, both layers sliding-window rings: no
global layer, so no page pool), llama4-scout-smoke (4 experts top-1 and a
shared expert; chunked-local rings 3:1 with one global layer) and
paligemma-smoke (every layer global, 4 q / 1 kv heads, which replicate
over a model axis of 2, text through chunked admission), from the JAX
package's seeded init, keep-all BGPP; one spawned world a mesh (1x1, 2x1,
1x2, 2x2) runs every case of that mesh:

  * tokens identical and logits bit-identical to the port's single-device
    run of the same case on every rank, the same host state on every rank,
    and the counters' mesh columns as the reference's laws say;
  * each case's single-device run held to the JAX Scheduler's on the same
    requests and layout (tokens identical; logits within 1e-4 in bf16 KV,
    within ``TF_TOL`` teacher-forced in int8 / bgpp KV, as
    ``tests/test_torch_moe_serving.py`` holds them); mixtral's paged eager
    run against JAX's slot run (the reference's eager admission into a
    paged layout with no global layer raises);
  * paligemma's eager admission on a 2x2 mesh raises the single-device
    ``ValueError`` on every rank (no image prefix to give; no rank waits in
    a collective).
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

from test_torch_sharded_serving import (CHUNK_BUDGET, KEEP_ALL, MAX_SEQ, PAGE_SIZE, SLOTS,
                                        _requests, _trace)
from test_torch_sharded_training import spawn_world

torch.set_num_threads(1)

MIX, SCOUT, PALI = "mixtral-8x22b", "llama4-scout-17b-a16e", "paligemma-3b"
TF_TOL = 5e-3  # int8 / bgpp KV teacher-forced against JAX (tests/test_torch_zoo.py)

# (arch, (KV format, layout, admission, weight format)) of each mesh
BASE = [(a, ("bf16", lay, "chunked", "bf16")) for a in (MIX, SCOUT, PALI)
        for lay in ("slot", "paged")]
WIDE = BASE + [(SCOUT, ("int8", "paged", "chunked", "bf16")),
               (SCOUT, ("bgpp", "slot", "chunked", "bf16")),
               (MIX, ("int8", "slot", "chunked", "bf16")),
               (MIX, ("bgpp", "paged", "chunked", "bf16")),
               (PALI, ("int8", "paged", "chunked", "bf16")),
               (PALI, ("bgpp", "slot", "chunked", "bf16")),
               (SCOUT, ("bf16", "slot", "eager", "bf16")),
               (SCOUT, ("bf16", "paged", "eager", "bf16")),
               (MIX, ("bf16", "slot", "eager", "bf16")),
               (MIX, ("bf16", "paged", "eager", "bf16"))]
CASES = {(1, 1): BASE + [(SCOUT, ("bf16", "slot", "eager", "bf16"))],
         (2, 1): BASE + [(MIX, ("bf16", "slot", "eager", "bf16")),
                         (SCOUT, ("bgpp", "paged", "chunked", "bf16"))],
         (1, 2): BASE + [(SCOUT, ("int8", "slot", "chunked", "bf16")),
                         (SCOUT, ("bf16", "paged", "eager", "bf16"))],
         (2, 2): WIDE}
MESHES = list(CASES)

_JAX = {}


def _cfg(arch):
    """The port's smoke config of ``arch`` with keep-all BGPP."""
    from repro_torch.configs import MCBPOptions, get_config

    return dataclasses.replace(get_config(arch, smoke=True), mcbp=MCBPOptions(**KEEP_ALL))


def _jax_model(arch):
    """The JAX package's config and seeded init of ``arch`` (keep-all
    BGPP), and its parameters as numpy (the parent only)."""
    if arch not in _JAX:
        import jax

        from repro.configs import MCBPOptions as JMCBP, get_config as jax_config
        from repro.models import model_zoo as jzoo

        jax.config.update("jax_platform_name", "cpu")
        jcfg = dataclasses.replace(jax_config(arch, smoke=True), mcbp=JMCBP(**KEEP_ALL))
        jparams, _ = jzoo.init(jax.random.key(0), jcfg)
        _JAX[arch] = dict(cfg=jcfg, params=jparams, numpy=jax.tree.map(np.asarray, jparams))
    return _JAX[arch]


def _eager_refusal(params, rules):
    """paligemma's eager admission on this rank: the error it raises."""
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import Scheduler

    cfg = _cfg(PALI)
    lay = kvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bf16", layout="slot")
    sched = Scheduler(params, cfg, lay, device="cpu", admission="eager", rules=rules)
    sched.submit(Request(rid=0, prompt=np.arange(6, dtype=np.int32), max_new_tokens=2,
                         arrival_step=0))
    try:
        sched.run(max_steps=10)
    except ValueError as e:
        return str(e)
    return None


def _worker(rank, world, mesh, root):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    import torch.distributed as dist

    from repro_torch.interop import params_from_numpy
    from repro_torch.serving import sharded as shd

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'store')}",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        rules = shd.rules_for(*mesh, device="cpu")
        with open(os.path.join(root, "params.pkl"), "rb") as f:
            trees = pickle.load(f)
        params = {a: params_from_numpy(t, "cpu") for a, t in trees.items()}
        res = {"cases": {(arch, case): _trace(_cfg(arch), params[arch], case, rules)
                         for arch, case in CASES[mesh]}}
        if mesh == (2, 2):
            res["eager_refusal"] = _eager_refusal(params[PALI], rules)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_RESULTS, _BASE = {}, {}


def _sharded(mesh):
    """Every rank's results of one mesh's world (spawned once)."""
    if mesh not in _RESULTS:
        d, m = mesh
        root = tempfile.mkdtemp(prefix=f"moe-serve-mesh{d}x{m}-")
        with open(os.path.join(root, "params.pkl"), "wb") as f:
            pickle.dump({a: _jax_model(a)["numpy"] for a in (MIX, SCOUT, PALI)}, f)
        spawn_world(d * m, _worker, (mesh, root), root)
        ranks = []
        for r in range(d * m):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        _RESULTS[mesh] = ranks
    return _RESULTS[mesh]


def _base(arch, case):
    """The port's single-device run of ``case``."""
    from repro_torch.interop import params_from_numpy

    if (arch, case) not in _BASE:
        params = params_from_numpy(_jax_model(arch)["numpy"], "cpu")
        _BASE[(arch, case)] = _trace(_cfg(arch), params, case, None)
    return _BASE[(arch, case)]


def _jax_trace(arch, case):
    """The JAX package's Scheduler on ``case``'s requests and layout
    (mixtral's paged eager case on the slot layout)."""
    from repro.serving import kv_cache as jkvc
    from repro.serving.request import Request as JRequest
    from repro.serving.scheduler import Scheduler as JScheduler

    kv_format, layout, admission, _ = case
    if arch == MIX and admission == "eager":
        layout = "slot"
    jcfg, jparams = _jax_model(arch)["cfg"], _jax_model(arch)["params"]
    lay = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format=kv_format, layout=layout,
                          page_size=PAGE_SIZE)
    sched = JScheduler(jparams, jcfg, lay, admission=admission, chunk_budget=CHUNK_BUDGET,
                       record_logits=True)
    for r in _requests(_cfg(arch), teacher_forced=kv_format != "bf16"):
        sched.submit(JRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                              arrival_step=r.arrival_step, forced_tokens=r.forced_tokens))
    sched.run(max_steps=500)
    return {r.rid: (list(r.generated), np.stack(r.logit_rows)) for r in sched.finished}


def _id(arch, case):
    return arch.split("-")[0] + "-" + "-".join(case[:3])


@pytest.mark.parametrize("arch,case", [pytest.param(a, c, id=_id(a, c)) for a, c in WIDE])
def test_single_device_trace_is_the_jax_trace(arch, case):
    """Each case's single-device run, the oracle of the sharded runs,
    against the JAX Scheduler's: the same finished requests, tokens
    identical, logits within 1e-4 (bf16 KV) or ``TF_TOL`` (int8 / bgpp KV,
    teacher-forced)."""
    want = _jax_trace(arch, case)
    got = _base(arch, case)[0]
    assert sorted(got) == sorted(want)
    tol = 1e-4 if case[0] == "bf16" else TF_TOL
    for rid, (toks, rows) in want.items():
        assert got[rid][0] == toks, (arch, case, rid)
        err = float(np.max(np.abs(got[rid][1] - rows)))
        assert err <= tol, (arch, case, rid, err)


@pytest.mark.parametrize("mesh,arch,case", [
    pytest.param(mesh, a, c, id=f"{mesh[0]}x{mesh[1]}-" + _id(a, c))
    for mesh in MESHES for a, c in CASES[mesh]])
def test_sharded_trace_is_the_single_device_trace(mesh, arch, case):
    """Tokens identical and logits bit-identical to the single-device run
    on every rank, the same page tables on every rank, and the kv_read /
    weight_read mesh columns as the reference's laws say."""
    d, m = mesh
    ranks = _sharded(mesh)
    want, _, want_wr, want_pager = _base(arch, case)
    got, kv, wr, pager = ranks[0]["cases"][(arch, case)]
    assert sorted(got) == sorted(want)
    for rid, (toks, rows) in want.items():
        assert got[rid][0] == toks, (mesh, arch, case, rid)
        assert np.array_equal(got[rid][1], rows), (
            mesh, arch, case, rid, float(np.max(np.abs(got[rid][1] - rows))))
    for other in ranks[1:]:
        o = other["cases"][(arch, case)]
        assert all(o[0][rid][0] == got[rid][0] and np.array_equal(o[0][rid][1], got[rid][1])
                   for rid in got)
        if pager is not None:
            assert all(np.array_equal(a, b) for a, b in zip(o[3][:2], pager[:2]))
    if pager is not None:
        assert all(np.array_equal(a, b) for a, b in zip(pager[:2], want_pager[:2]))
        assert pager[2:] == want_pager[2:]
    assert kv["mesh"] == {"data": d, "model": m} == wr["mesh"]
    assert abs(kv["decode_bytes_per_device_per_step"] * kv["kv_shards"]
               - kv["decode_bytes_per_step"]) <= kv["kv_shards"]
    if (d, m) == (1, 1):
        assert kv["interconnect_bytes_per_step"] == kv["interconnect_bytes"] == 0
    assert wr["decode_bytes_per_step"] == want_wr["decode_bytes_per_step"]
    # the reference's weight shards are the heads' model shards: 1 where the
    # model axis does not divide both head counts (paligemma's 4 / 1)
    cfg = _cfg(arch)
    assert wr["weight_shards"] == (m if cfg.num_heads % m == cfg.num_kv_heads % m == 0 else 1)


def test_vlm_eager_admission_refuses_on_a_mesh():
    """paligemma's eager admission on a 2x2 mesh raises the single-device
    ``ValueError`` on every rank: the slot's owner and the rank that would
    wait for its logits alike."""
    ranks = _sharded((2, 2))
    for r in ranks:
        assert r["eager_refusal"] is not None
        assert "family 'vlm'" in r["eager_refusal"] and "needs vision_embeds" in \
            r["eager_refusal"]
