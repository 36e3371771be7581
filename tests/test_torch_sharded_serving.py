"""Sharded serving on ``torch.distributed``: the port's ``TestShardedParity``
(``tests/test_serving_fuzz.py``) and ``TestShardedPagedPools``
(``tests/test_multidevice.py``), rehearsed on the CPU in gloo worlds.

Each mesh runs in ONE spawned world of ``data * model`` processes (a
``file://`` store under ``tmp_path``, a 60 s collective timeout, one thread
a process); every case of that mesh runs inside it and each rank writes its
results, which the parent checks.  The oracle is the port's single-device
run of the same trace: tokens identical and logits bit-identical, in every
KV format (the placement moves data only; the reference holds int8 / bgpp
to 1e-5, the port holds them exact).  Every rank's host state (tokens,
page tables) must equal rank 0's.  The parameters are the JAX package's
seeded init (``interop.params_from_numpy``), and each case's single-device
trace is held to the JAX Scheduler's on the same requests and layout
(tokens identical, logits within 1e-4, as ``tests/test_torch_serving_fuzz.py``
holds them), so sharded = single-device = JAX stands on the same inputs.

Also here: a column shard's product against the same columns of the whole
product on the CPU (ROADMAP, Departures: it is bit-equal with one thread,
and not with several at 3072 x 3072).
"""

import dataclasses
import datetime
import json
import os
import pathlib
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import MCBPOptions, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.interop import params_from_numpy
from repro_torch.models import model_zoo
from repro_torch.serving import kv_cache as kvc, sharded as shd
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import Scheduler

torch.set_num_threads(1)

MESHES = [(1, 1), (2, 1), (1, 4), (2, 4)]
SLOTS, MAX_SEQ, PAGE_SIZE, CHUNK_BUDGET = 4, 48, 8, 6
JOIN_S = 300

# (kv format, layout, admission, weight format): the reference's grid
# (bf16 at every mesh; int8 and bgpp at 2x4) plus eager admission, the
# int8 / bstc serve weights and speculative decoding ("spec": chunked
# admission, 4-plane drafts, gamma 4) at 2x4
BF16 = [("bf16", "slot", "chunked", "bf16"), ("bf16", "paged", "chunked", "bf16")]
WIDE = BF16 + [("int8", "slot", "chunked", "bf16"), ("int8", "paged", "chunked", "bf16"),
               ("bgpp", "slot", "chunked", "bf16"), ("bgpp", "paged", "chunked", "bf16"),
               ("bf16", "slot", "eager", "bf16"), ("bf16", "paged", "eager", "bf16"),
               ("bf16", "slot", "chunked", "int8"), ("bgpp", "paged", "chunked", "bstc"),
               ("bf16", "slot", "spec", "bf16")]
CASES = {(1, 1): BF16, (2, 1): BF16, (1, 4): BF16, (2, 4): WIDE}


KEEP_ALL = dict(bgpp_rounds=4, bgpp_keep_ratio=1.0)
_JAX = {}


def _cfg():
    """deepseek-7b-smoke (4 q and 4 kv heads, an untied head) with
    keep-all BGPP: the reference's sharding oracle arch."""
    return dataclasses.replace(get_config("deepseek-7b", smoke=True),
                               mcbp=MCBPOptions(**KEEP_ALL))


def _jax_model():
    """The JAX package's config and seeded init of :func:`_cfg`'s arch, and
    its parameters as numpy (built once, in the parent; the spawned ranks
    import no JAX and read the numpy tree from a file)."""
    if not _JAX:
        import jax

        from repro.configs import MCBPOptions as JMCBP, get_config as jax_config
        from repro.models import model_zoo as jzoo

        jax.config.update("jax_platform_name", "cpu")
        jcfg = dataclasses.replace(jax_config("deepseek-7b", smoke=True),
                                   mcbp=JMCBP(**KEEP_ALL))
        jparams, _ = jzoo.init(jax.random.key(0), jcfg)
        _JAX.update(cfg=jcfg, params=jparams, numpy=jax.tree.map(np.asarray, jparams))
    return _JAX


def _model(tree=None):
    """The port's config and parameters from the JAX init's numpy ``tree``
    (the parent's own when ``None``)."""
    return _cfg(), params_from_numpy(_jax_model()["numpy"] if tree is None else tree, "cpu")


def _requests(cfg, teacher_forced, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(6):
        max_new = int(rng.integers(2, 6))
        prompt = rng.integers(0, cfg.vocab_size, (int(rng.integers(3, 21)),)).astype(np.int32)
        arrival = int(rng.integers(0, 9))
        forced = rng.integers(0, cfg.vocab_size, (max_new,)).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=max_new,
                            arrival_step=arrival,
                            forced_tokens=forced if teacher_forced else None))
    return reqs


def _trace(cfg, params, case, rules):
    """One case's joint run -> (per-request tokens and logit rows, the
    stats' kv_read / weight_read, the page table and refcounts)."""
    kv_format, layout, admission, weights = case
    lay = kvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format=kv_format, layout=layout,
                         page_size=PAGE_SIZE)
    spec = admission == "spec"
    sched = Scheduler(params, cfg, lay, device="cpu",
                      admission="chunked" if spec else admission, chunk_budget=CHUNK_BUDGET,
                      record_logits=True, weight_format=weights, rules=rules,
                      spec_decode=spec or None, draft_gamma=4 if spec else None,
                      draft_planes=4 if spec else None)
    for r in _requests(cfg, teacher_forced=kv_format != "bf16"):
        sched.submit(r)
    stats = sched.run(max_steps=500)
    reqs = {r.rid: (list(r.generated), np.stack(r.logit_rows)) for r in sched.finished}
    pager = None
    if sched.pager is not None:
        sched.pager.check()
        pager = (sched.pager.table.copy(), sched.pager.refcount.copy(), sched.pager.alloc_count,
                 sched.pager.peak_pages, sched.pager.pages_in_use)
    return reqs, stats["kv_read"], stats["weight_read"], pager


def _prefix_trace(cfg, params, rules):
    """The reference's shared-prefix trace (paged bf16, adoption): the
    allocator's end state."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, (16,)).astype(np.int32)
    lay = kvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bf16", layout="paged",
                         page_size=PAGE_SIZE)
    sched = Scheduler(params, cfg, lay, device="cpu", chunk_budget=CHUNK_BUDGET, rules=rules)
    for i in range(4):
        tail = rng.integers(0, cfg.vocab_size, (3 + i,)).astype(np.int32)
        sched.submit(Request(rid=i, prompt=np.concatenate([prefix, tail]),
                             max_new_tokens=3 + i, arrival_step=[0, 6, 6, 9][i]))
    sched.run(max_steps=500)
    sched.pager.check()
    p = sched.pager
    return (len(sched.finished), sched.prefix_hit_tokens, p.table.copy(), p.refcount.copy(),
            p.alloc_count, p.peak_pages, p.pages_in_use)


def _pool_checks(cfg, rules):
    """The port's ``TestShardedPagedPools`` bodies on this rank: the page
    table's translation on a head-sharded pool, ``zero_pages`` on a pool
    shard and ``reset_slot`` on a slot-stack shard, each against the same
    rows of the whole tensors."""
    shard = shd.Shard.of(cfg, kvc.layout_for(cfg, SLOTS, MAX_SEQ), rules)
    Hk = sh.local_heads(cfg, shard.split)[1]
    heads = slice(shard.split.rank * Hk, (shard.split.rank + 1) * Hk)
    rng = np.random.default_rng(0)
    out = {}
    # translation: a scrambled, valid table over a random pool
    lay = kvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bf16", layout="paged",
                         page_size=PAGE_SIZE)
    whole = kvc.init_cache_arrays(cfg, lay, "cpu")
    whole["global"] = {n: torch.as_tensor(rng.normal(size=a.shape), dtype=a.dtype)
                       for n, a in whole["global"].items()}
    local = shd.shard_cache(whole, cfg, lay, rules)
    table = rng.permutation(lay.num_pages)[:SLOTS * lay.pages_per_slot].astype(np.int32)
    table = table.reshape(SLOTS, lay.pages_per_slot)
    phys = kvc.phys_table(shd.replicated(table, rules), lay.page_size, lay.max_seq)
    entry = kvc.paged_entry(local["global"], 1, phys)
    rows = (table[:, np.arange(MAX_SEQ) // PAGE_SIZE] * PAGE_SIZE
            + np.arange(MAX_SEQ) % PAGE_SIZE)
    out["translation"] = bool(np.array_equal(phys.numpy(), rows)) and all(
        torch.equal(entry[n].movedim(1, 2), whole["global"][n][1][rows][:, :, heads])
        for n in ("k", "v"))
    # zero_pages on every leaf of an int8 pool shard
    lay = kvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="int8", layout="paged",
                         page_size=PAGE_SIZE)
    whole = kvc.init_cache_arrays(cfg, lay, "cpu")
    whole["global"] = {n: torch.as_tensor(rng.integers(1, 100, a.shape), dtype=a.dtype)
                       for n, a in whole["global"].items()}
    local = shd.shard_cache({n: (dict(v) if isinstance(v, dict) else v.clone())
                             for n, v in whole.items()}, cfg, lay, rules)
    local["global"] = {n: a.clone() for n, a in local["global"].items()}
    kvc.zero_pages(whole["global"], [1, 5], PAGE_SIZE)
    kvc.zero_pages(local["global"], [1, 5], PAGE_SIZE)
    out["zero_pages"] = all(torch.equal(a, whole["global"][n][:, :, heads])
                            for n, a in local["global"].items())
    # reset_slot(2) on a slot-stack shard: the rank holding slot 2 zeroes its row
    lay = kvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bf16", layout="slot")
    whole = kvc.init_cache_arrays(cfg, lay, "cpu")
    whole["global"] = {n: torch.as_tensor(rng.normal(size=a.shape) + 1.0, dtype=a.dtype)
                       for n, a in whole["global"].items()}
    whole["pos"] = torch.tensor([3, 4, 5, 6], dtype=torch.int32)
    local = shd.shard_cache(whole, cfg, lay, rules)
    local = {n: ({k: a.clone() for k, a in v.items()} if isinstance(v, dict) else v.clone())
             for n, v in local.items()}
    kvc.reset_slot(whole, lay, 2)
    kvc.reset_slot(local, lay, 2, row=shard.row(2))
    out["reset_slot"] = local["pos"].tolist() == [3, 4, 0, 6] and all(
        torch.equal(a, whole["global"][n][:, shard.lo:shard.hi, heads])
        for n, a in local["global"].items())
    return out


def _collectives(cfg, params, rules, layout):
    """All-gathers a decode step issues, by group: the heads' attend outputs
    once a layer and the embedding and head over ``"model"``; the logits
    (and, paged, each layer's K and V rows) over ``"data"`` -- the
    collectives ``_interconnect_decode`` prices.  No other collective runs
    in the step (the kernels' attends are rank-local)."""
    from repro_torch.serving import engine

    lay = kvc.layout_for(cfg, SLOTS, MAX_SEQ, kv_format="bgpp", layout=layout,
                         page_size=PAGE_SIZE)
    shard = shd.Shard.of(cfg, lay, rules)
    local = shd.shard_params(params, model_zoo.param_specs(cfg), rules, cfg)
    cache = shd.shard_cache(kvc.init_cache_arrays(cfg, lay, "cpu"), cfg, lay, rules)
    if layout == "paged":
        cache["page_table"] = kvc.identity_page_table(lay, "cpu")
    step = engine.make_serve_step(cfg, lay, rules)
    seen = []
    real = sh.all_gather

    def counting(x, group, dim=0):
        seen.append("model" if group is shard.split.group else "data")
        return real(x, group, dim)

    sh.all_gather = counting
    try:
        logits, _ = step(local, cache, torch.zeros((SLOTS, 1), dtype=torch.int64))
    finally:
        sh.all_gather = real
    return seen.count("model"), seen.count("data"), tuple(logits.shape)


def _worker(rank, world, mesh, store, out_dir):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        rules = shd.rules_for(*mesh, device="cpu")
        with open(os.path.join(out_dir, "params.pkl"), "rb") as f:
            cfg, params = _model(pickle.load(f))
        res = {"cases": {case: _trace(cfg, params, case, rules) for case in CASES[mesh]}}
        if mesh == (1, 1):
            from repro_torch.launch.mesh import make_debug_mesh

            try:
                make_debug_mesh(2, 1, "cpu")
                res["refuses_a_mesh_past_the_world"] = False
            except ValueError as e:
                res["refuses_a_mesh_past_the_world"] = "2 ranks" in str(e)
        if mesh == (2, 4):
            res["pools"] = _pool_checks(cfg, rules)
            res["prefix"] = _prefix_trace(cfg, params, rules)
            res["collectives"] = {lay: _collectives(cfg, params, rules, lay)
                                  for lay in ("slot", "paged")}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_RESULTS = {}
_BASE = {}


def _sharded(mesh, tmp_path_factory):
    """Every rank's results of one mesh's world (spawned once)."""
    if mesh not in _RESULTS:
        d, m = mesh
        root = tmp_path_factory.mktemp(f"mesh{d}x{m}")
        with open(root / "params.pkl", "wb") as f:
            pickle.dump(_jax_model()["numpy"], f)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_worker, args=(r, d * m, mesh, str(root / "store"),
                                                   str(root)))
                 for r in range(d * m)]
        for p in procs:
            p.start()
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_S)
        for p in procs:
            p.join(max(1.0, (deadline - datetime.datetime.now()).total_seconds()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        assert not hung, f"mesh {d}x{m}: {len(hung)} ranks hung past {JOIN_S} s"
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
        ranks = []
        for r in range(d * m):
            with open(root / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        _RESULTS[mesh] = ranks
    return _RESULTS[mesh]


def _base(case):
    if case not in _BASE:
        cfg, params = _model()
        _BASE[case] = _trace(cfg, params, case, None)
    return _BASE[case]


def _jax_trace(case):
    """The JAX package's Scheduler on ``case``'s requests and layout (its
    serve weights through the config, as the reference selects them)."""
    from repro.configs import apply_weight_format_override as japply
    from repro.serving import kv_cache as jkvc
    from repro.serving.request import Request as JRequest
    from repro.serving.scheduler import Scheduler as JScheduler

    kv_format, layout, admission, weights = case
    jcfg, jparams = _jax_model()["cfg"], _jax_model()["params"]
    jcfg = japply(jcfg, weights)
    lay = jkvc.layout_for(jcfg, SLOTS, MAX_SEQ, kv_format=kv_format, layout=layout,
                          page_size=PAGE_SIZE)
    spec = admission == "spec"
    sched = JScheduler(jparams, jcfg, lay, admission="chunked" if spec else admission,
                       chunk_budget=CHUNK_BUDGET, record_logits=True,
                       spec_decode=spec or None, draft_gamma=4 if spec else None,
                       draft_planes=4 if spec else None)
    for r in _requests(_cfg(), teacher_forced=kv_format != "bf16"):
        sched.submit(JRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                              arrival_step=r.arrival_step, forced_tokens=r.forced_tokens))
    sched.run(max_steps=500)
    return {r.rid: (list(r.generated), np.stack(r.logit_rows)) for r in sched.finished}


@pytest.mark.parametrize("case", [pytest.param(c, id="-".join(c)) for c in CASES[(2, 4)]])
def test_single_device_trace_is_the_jax_trace(case):
    """Each case's single-device trace, the oracle of the sharded runs,
    against the JAX Scheduler's on the same parameters, requests and
    layout: the same finished requests, tokens identical and logits within
    1e-4."""
    want = _jax_trace(case)
    got = _base(case)[0]
    assert sorted(got) == sorted(want)
    for rid, (toks, rows) in want.items():
        assert got[rid][0] == toks, (case, rid)
        err = float(np.max(np.abs(got[rid][1] - rows)))
        assert err <= 1e-4, (case, rid, err)


def _case_ids():
    return [pytest.param(mesh, case, id=f"{mesh[0]}x{mesh[1]}-" + "-".join(case))
            for mesh in MESHES for case in CASES[mesh]]


@pytest.mark.parametrize("mesh,case", _case_ids())
def test_sharded_trace_is_the_single_device_trace(mesh, case, tmp_path_factory):
    """Tokens identical and logits bit-identical to the single-device run,
    on every rank; the kv_read / weight_read mesh columns as the
    reference's laws say."""
    d, m = mesh
    ranks = _sharded(mesh, tmp_path_factory)
    want, _, want_wr, want_pager = _base(case)
    got, kv, wr, pager = ranks[0]["cases"][case]
    assert sorted(got) == sorted(want)
    for rid, (toks, rows) in want.items():
        assert got[rid][0] == toks, (case, rid)
        assert np.array_equal(got[rid][1], rows), (
            case, rid, float(np.max(np.abs(got[rid][1] - rows))))
    for other in ranks[1:]:
        o = other["cases"][case]
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
    elif m > 1:
        assert kv["interconnect_bytes_per_step"] > 0 and kv["interconnect_bytes"] > 0
    assert wr["decode_bytes_per_step"] == want_wr["decode_bytes_per_step"]
    assert wr["weight_shards"] == m


@pytest.mark.parametrize("check", ["translation", "zero_pages", "reset_slot"])
def test_paged_pools_on_every_shard(check, tmp_path_factory):
    """``phys_table`` + ``paged_entry`` on a head-sharded pool read the
    rows the host translation picks; ``zero_pages`` and ``reset_slot``
    act on every rank's shard exactly as on those rows of the whole cache
    (2x4)."""
    ranks = _sharded((2, 4), tmp_path_factory)
    assert all(r["pools"][check] for r in ranks), [r["pools"][check] for r in ranks]


def test_prefix_adoption_is_mesh_invariant(tmp_path_factory):
    """The host allocator never sees the mesh: a shared-prefix trace leaves
    the same page tables, refcounts and counters at 2x4 (every rank) as on
    one device."""
    ranks = _sharded((2, 4), tmp_path_factory)
    want = _prefix_trace(*_model(), None)
    assert want[0] == 4 and want[1] > 0 and want[-1] == 0
    for r in ranks:
        got = r["prefix"]
        assert got[:2] == want[:2] and got[4:] == want[4:]
        assert np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3])


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_decode_step_collectives(layout, tmp_path_factory):
    """A 2x4 decode step's all-gathers: over ``"model"`` one a layer (the
    heads' attend outputs) plus the embedding and the head; over
    ``"data"`` the logits, and in the paged layout each layer's K and V
    rows (the write broadcast).  The bgpp attend (K2's plain version)
    issues none, as the reference's shard_map."""
    cfg = _cfg()
    L = cfg.num_layers
    for r in _sharded((2, 4), tmp_path_factory):
        model, data, shape = r["collectives"][layout]
        assert model == L + 2
        assert data == 1 + (2 * L if layout == "paged" else 0)
        assert shape == (SLOTS, 1, cfg.vocab_size)


@pytest.mark.parametrize("threads,equal", [(1, True), (4, False)])
def test_column_shard_product_on_the_cpu(threads, equal):
    """A column shard's f32 product against the same columns of the whole
    product at (4, 3072) x (3072, 3072), m = 4: bit-equal with one thread
    (the sharded tests run so), not with four, where the library splits
    the contraction across threads by the width it is given.  The gap is
    bounded (ROADMAP, Departures): within 1e-6 of sum |x| |w| a column."""
    prev = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        g = torch.Generator().manual_seed(0)
        x = torch.randn((4, 3072), generator=g)
        w = torch.randn((3072, 3072), generator=g) / 3072 ** 0.5
        whole = x @ w
        n = 3072 // 4
        shards = [x @ w[:, i * n:(i + 1) * n].contiguous() for i in range(4)]
    finally:
        torch.set_num_threads(prev)
    got = torch.cat(shards, 1)
    assert torch.equal(got, whole) == equal
    bound = 1e-6 * (x.abs() @ w.abs())
    assert bool(((got - whole).abs() <= bound).all())


@pytest.mark.parametrize("knob", [dict(seq_shard=True), dict(sp=True),
                                  dict(fsdp_axes=(sh.FF,))], ids=["seq_shard", "sp", "fsdp"])
def test_serving_refuses_the_knobs_it_does_not_place(knob):
    """Sequence and FSDP sharding are the reference's training and
    long-context knobs: serving rules that set one are refused, naming the
    knob, not run on a cut the engine would misread as its slots."""
    cfg = _cfg()
    rules = sh.ShardingRules(mesh={"data": 2, "model": 4}, **knob)
    with pytest.raises(NotImplementedError, match=f"{next(iter(knob))} is not served"):
        shd.Shard.of(cfg, kvc.layout_for(cfg, SLOTS, MAX_SEQ), rules)


def test_debug_mesh_must_be_the_world(tmp_path_factory):
    """``make_debug_mesh`` refuses a mesh of more ranks than the world."""
    assert _sharded((1, 1), tmp_path_factory)[0]["refuses_a_mesh_past_the_world"]


REPO = pathlib.Path(__file__).resolve().parent.parent


def _launch(args, nproc=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    head = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={nproc}"] if nproc else [sys.executable])
    return subprocess.run(head + ["-m", "repro_torch.launch.serve", "--device", "cpu"] + args,
                          capture_output=True, text=True, timeout=timeout, env=env)


def test_serve_launcher_runs_under_torchrun(tmp_path):
    """``launch/serve.py --mesh 1,2`` under ``torchrun`` on the CPU (gloo):
    rank 0 prints the reference's mesh line and the JSON's ``mesh``."""
    trace = tmp_path / "trace.json"
    run = _launch(["--arch", "deepseek-7b", "--mesh", "1,2", "--kv-format", "bf16",
                   "--kv-layout", "paged", "--requests", "3", "--max-new", "4",
                   "--trace-out", str(trace)], nproc=2)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("[serve] mesh")]
    assert lines == [lines[0]] and lines[0].startswith("[serve] mesh 1x2 (2 kv shards)")
    stats = json.loads(trace.read_text())
    assert stats["config"]["mesh"] == [1, 2]
    assert stats["kv_read"]["mesh"] == {"data": 1, "model": 2}
    assert stats["finished_requests"] == 3


class _Mesh:  # the shape and coordinates a 1x2 DeviceMesh gives, without a world
    mesh_dim_names = ("data", "model")
    shape = (1, 2)

    @staticmethod
    def get_local_rank(axis):
        return 0

    @staticmethod
    def get_group(axis):
        return None


def test_launcher_refuses_another_family_on_a_mesh():
    """The enc_dec family under a mesh is refused by the launcher with its
    one-device reason, as the reference's serve launcher takes only the
    transformer families (the dense, MoE and VLM families are served
    sharded through it); the ssm, hybrid and enc_dec families take a mesh
    through ``make_serve_step``, which builds on a 1x2 placement."""
    from repro_torch.serving import engine

    run = _launch(["--arch", "whisper-medium", "--mesh", "1,1", "--requests", "1"])
    assert run.returncode != 0 and "decodes through make_serve_step directly" in run.stderr, \
        run.stderr[-2000:]
    rules = sh.rules_for_mesh(_Mesh())
    for arch in ("mamba2-1.3b", "jamba-1.5-large-398b", "whisper-medium"):
        cfg = get_config(arch, smoke=True)
        lay = kvc.layout_for(cfg, 2, 16)
        assert engine.make_serve_step(cfg, lay, rules) is not None
        params = model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
        local = shd.shard_params(params, model_zoo.param_specs(cfg), rules, cfg)
        if cfg.family == "enc_dec":  # the cross projections' columns cut to the rank's heads
            assert local["decoder"]["xattn"]["wk"].shape[-1] == cfg.kv_dim // 2
            continue
        mixer = (local["layers"]["mixer"] if cfg.family == "ssm"
                 else local["blocks"]["pos0"]["mamba"])
        d_in, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
        assert mixer["in_proj"].shape[-1] == d_in + 2 * N + d_in // cfg.ssm_head_dim // 2
