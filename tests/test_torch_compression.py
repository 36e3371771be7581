"""The int8-compressed data-parallel gradient sync against the reference's,
bit for bit, and the reference's own bounds on it.

The reference runs in a subprocess with four forced host devices (as
``tests/test_multidevice.py`` runs it), under ``shard_map`` on meshes of
1, 2, 3 and 4 devices; the port runs in one spawned gloo world of four
processes on the same numpy inputs: ``compressed_psum_mean`` over groups
of 1, 2, 3 and 4 ranks (f32 leaves of two shapes and a bf16 leaf, each rank's
scale skewed), and ``make_compressed_dp_grad_fn`` over the data axis of a
4x1 and a 2x2 mesh.  ``jnp.round`` and ``torch.round`` both round half to
even, the codes sum exactly in int32, and ``qsum * scale / n`` is the same
two f32 roundings in both (XLA keeps the division by 3), so every output
of the same local gradients is the reference's bits.  The reference's bounds
(``tests/test_substrates.py:199``, ``tests/test_multidevice.py:27``):
within 5% of the exact mean, the loss within 1e-5.
"""

import datetime
import os
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import torch

from test_torch_sharded_training import spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1, 2, 3, 4)


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for n in SIZES:  # each rank's rows at its own scale
        skew = (4.0 ** np.arange(n))[:, None]
        out[f"g{n}"] = (rng.normal(size=(n, 64)) * skew).astype(np.float32)
        out[f"h{n}"] = (rng.normal(size=(n, 5, 7)) * skew[:, :, None]).astype(np.float32)
        out[f"b{n}"] = (rng.normal(size=(n, 33)) * skew * 1e-3).astype(np.float32)
    out["w"] = rng.normal(size=(8,)).astype(np.float32)
    out["x"] = rng.normal(size=(16, 8)).astype(np.float32)
    # small integers: every product and sum of the loss and its gradient is
    # exact in f32, so both frameworks' local gradients are the same bits
    out["wi"] = rng.integers(-4, 5, size=(8,)).astype(np.float32)
    out["xi"] = rng.integers(-4, 5, size=(16, 8)).astype(np.float32)
    return out


JAX_CODE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.distributed.compression import compressed_psum_mean, make_compressed_dp_grad_fn
z = dict(np.load(sys.argv[1]))
out = {}
for n in (1, 2, 3, 4):
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("data",))
    f = compat.shard_map(lambda t: compressed_psum_mean(t, "data"), mesh=mesh,
                         in_specs=P("data"), out_specs=P("data"), check_vma=False)
    tree = {"g": jnp.asarray(z[f"g{n}"]), "h": jnp.asarray(z[f"h{n}"]),
            "b": jnp.asarray(z[f"b{n}"], jnp.bfloat16)}
    got = f(tree)
    for k, v in got.items():
        out[f"{k}{n}"] = np.asarray(v.astype(jnp.float32))
loss_fn = lambda p, x: jnp.mean(jnp.square(x @ p["w"]))
for data in ("", "i"):
    params = {"w": jnp.asarray(z["w" + data])}
    x = jnp.asarray(z["x" + data])
    for n in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("data",))
        loss, grads = make_compressed_dp_grad_fn(loss_fn, mesh)(params, x)
        out[f"loss{data}{n}"], out[f"grad{data}{n}"] = np.asarray(loss), np.asarray(grads["w"])
params = {"w": jnp.asarray(z["w"])}
x = jnp.asarray(z["x"])
le, ge = jax.value_and_grad(loss_fn)(params, x)
out["loss_exact"], out["grad_exact"] = np.asarray(le), np.asarray(ge["w"])
np.savez(sys.argv[2], **out)
"""


def _jax(root):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", JAX_CODE, os.path.join(root, "in.npz"),
                          os.path.join(root, "jax.npz")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(os.path.join(root, "jax.npz")))


def _worker(rank, world, root):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.compression import (compressed_psum_mean,
                                                     make_compressed_dp_grad_fn)
    from repro_torch.launch.mesh import make_debug_mesh

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'store')}",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        z = dict(np.load(os.path.join(root, "in.npz")))
        out = {}
        groups = {n: dist.new_group(list(range(n))) for n in SIZES}
        for n, group in groups.items():
            if rank >= n:
                continue
            tree = {"g": torch.from_numpy(z[f"g{n}"][rank:rank + 1]),
                    "h": torch.from_numpy(z[f"h{n}"][rank:rank + 1]),
                    "b": torch.from_numpy(z[f"b{n}"][rank:rank + 1]).to(torch.bfloat16)}
            got = compressed_psum_mean(tree, group)
            for k, v in got.items():
                out[f"{k}{n}"] = v.float().numpy()
        loss_fn = lambda p, x: torch.mean(torch.square(x @ p["w"]))
        for n, (d, m) in ((4, (4, 1)), (2, (2, 2))):
            rules = sh.rules_for_mesh(make_debug_mesh(d, m, "cpu"))
            coord = sh.mesh_coords(rules.mesh)["data"]
            for data in ("", "i"):
                params = {"w": torch.from_numpy(z["w" + data])}
                rows = z["x"].shape[0] // d
                x = torch.from_numpy(z["x" + data][coord * rows:(coord + 1) * rows])
                loss, grads = make_compressed_dp_grad_fn(loss_fn, rules)(params, x)
                out[f"loss{data}{n}"], out[f"grad{data}{n}"] = loss.numpy(), grads["w"].numpy()
        np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


_OUT = {}


def _results():
    if not _OUT:
        root = tempfile.mkdtemp(prefix="compression-")
        inputs = _inputs()
        np.savez(os.path.join(root, "in.npz"), **inputs)
        spawn_world(4, _worker, (root,), root)
        _OUT["jax"] = _jax(root)
        _OUT["ranks"] = [dict(np.load(os.path.join(root, f"rank{r}.npz"))) for r in range(4)]
        _OUT["in"] = inputs
    return _OUT


def test_compressed_psum_mean_is_the_references_bits():
    res = _results()
    for n in SIZES:
        for k in ("g", "h", "b"):
            want = res["jax"][f"{k}{n}"]
            for r in range(n):
                got = res["ranks"][r][f"{k}{n}"]
                np.testing.assert_array_equal(got[0], want[r], err_msg=f"{k}{n} rank {r}")


def test_compressed_dp_grad_fn_is_the_references_bits():
    """On integer data (the local gradients the same bits in both
    frameworks) the loss and the compressed grads are the reference's bits
    on every rank; on Gaussian data the local gradients differ in their
    last bits (another summation order), so a shared scale may move by an
    ulp: within 1e-6."""
    res = _results()
    for n in (2, 4):
        for r in range(4):
            got, want = res["ranks"][r], res["jax"]
            np.testing.assert_array_equal(got[f"gradi{n}"], want[f"gradi{n}"])
            assert got[f"lossi{n}"] == want[f"lossi{n}"]
            rel = np.abs(got[f"grad{n}"] - want[f"grad{n}"]).max() / np.abs(want[f"grad{n}"]).max()
            assert rel <= 1e-6, (n, r, rel)
            assert abs(float(got[f"loss{n}"]) - float(want[f"loss{n}"])) <= 1e-6 * abs(
                float(want[f"loss{n}"]))


def test_compressed_psum_close_to_exact():
    """``TestGradientCompression.test_compressed_psum_close_to_exact``:
    every rank receives the mean within 5% of its max."""
    res = _results()
    for n in SIZES:
        mean = res["in"][f"g{n}"].mean(axis=0)
        for r in range(n):
            rel = np.abs(res["ranks"][r][f"g{n}"][0] - mean).max() / (np.abs(mean).max() + 1e-9)
            assert rel < 0.05, (n, r, rel)


def test_dp_grad_fn_matches_uncompressed():
    """``test_dp_grad_fn_matches_uncompressed`` and
    ``test_int8_allreduce_matches_exact``: the loss within 1e-5 of the
    exact one, the grads within 5%."""
    res = _results()
    le, ge = float(res["jax"]["loss_exact"]), res["jax"]["grad_exact"]
    for n in (2, 4):
        got = res["ranks"][0]
        assert abs(float(got[f"loss{n}"]) - le) < 1e-5
        rel = np.abs(got[f"grad{n}"] - ge).max() / (np.abs(ge).max() + 1e-9)
        assert rel < 0.05, (n, rel)


def test_one_rank_compressed_mean_is_a_rounding():
    """At n = 1 the sync is no copy: each value comes back as its int8 code
    times the leaf's scale (``round(g / s) * s / 1``, s = absmax / 127)."""
    res = _results()
    g = torch.from_numpy(res["in"]["g1"][0])
    got = torch.from_numpy(res["ranks"][0]["g1"][0])
    scale = torch.clamp(g.abs().amax(), min=1e-12) / 127.0
    want = torch.round(g / scale).to(torch.int32).to(torch.float32) * scale / 1
    assert torch.equal(got, want) and not torch.equal(got, g)
