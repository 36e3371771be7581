"""The port's training substrates on the CPU: ports of
``tests/test_substrates.py``'s AdamW, data pipeline, checkpointer, fault
tolerance and train-step integration tests, of ``tests/test_arch_smoke.py``'s
per-arch train step and of ``tests/test_system.py``'s two training tests;
the batches and checkpoints against the JAX package's; the launcher and
the example in process.

The reference's elastic reshard on restore is left out with sharding
(ROADMAP item 7); the per-arch train step skips jamba, whose hybrid family
waits for it too (item 6c).
"""

import dataclasses
import json
import os
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_config
from repro.data import SyntheticLMDataset as JaxDataset
from repro.models import model_zoo as jzoo
from repro.optim import AdamWConfig as JaxAdamWConfig, adamw_init as jax_adamw_init

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_REGISTRY, get_config
from repro_torch.data import Prefetcher, SyntheticLMDataset
from repro_torch.examples import train_llm
from repro_torch.interop import params_from_numpy, tree_to_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models import model_zoo
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime import Heartbeat, StragglerMonitor, run_resilient
from repro_torch.training import make_train_step
from repro_torch.utils.tree import tree_items, tree_leaves, tree_unflatten

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

SMOKE_KW = dict(block_q=16, block_k=16)


def _to(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _init(arch, seed=0):
    cfg = get_config(arch, smoke=True)
    return cfg, model_zoo.init(cfg, torch.Generator().manual_seed(seed), "cpu")


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _zeros(tree):
    """A restore template of ``tree``'s nesting, shapes and dtypes, all zero."""
    return {k: _zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


class TestAdamW:
    @pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
    def test_converges_on_quadratic(self, state_dtype):
        rng = np.random.default_rng(0)
        params = {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
                  "b": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))}
        trng = np.random.default_rng(1)
        target = {"w": torch.from_numpy(trng.normal(size=(8, 4)).astype(np.float32)),
                  "b": torch.from_numpy(trng.normal(size=(4,)).astype(np.float32))}
        cfg = AdamWConfig(peak_lr=0.05, weight_decay=0.0, state_dtype=state_dtype,
                          warmup_steps=5, decay_steps=300)
        state = adamw_init(params, cfg)
        losses = []
        for _ in range(300):
            loss = sum(torch.sum(torch.square(params[k] - target[k])) for k in params)
            grads = {k: 2 * (params[k] - target[k]) for k in params}
            params, state, _ = adamw_update(params, grads, state, cfg)
            losses.append(float(loss))
        assert losses[-1] < 0.05 * losses[0], losses[-1]

    def test_int8_state_is_8bit(self):
        st = adamw_init({"w": torch.ones(16, 8)}, AdamWConfig(state_dtype="int8"))
        assert st["m"]["w"]["q"].dtype == torch.int8
        assert st["v"]["w"]["q"].dtype == torch.int8
        assert st["m"]["w"]["s"].shape == (16,) and st["step"].dtype == torch.int32

    def test_grad_clip_applied(self):
        params = {"w": torch.zeros(4)}
        cfg = AdamWConfig(peak_lr=1.0, grad_clip=1e-3, warmup_steps=0, weight_decay=0.0)
        st = adamw_init(params, cfg)
        new, _, metrics = adamw_update(params, {"w": torch.full((4,), 1e6)}, st, cfg)
        assert float(metrics["grad_norm"]) > 1e5
        assert float(new["w"].abs().max()) < 10.0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


class TestDataPipeline:
    def test_deterministic_across_restarts(self):
        b1 = SyntheticLMDataset(1000, 32, 4, seed=7).batch(13)
        b2 = SyntheticLMDataset(1000, 32, 4, seed=7).batch(13)
        for k in b1:
            np.testing.assert_array_equal(b1[k], b2[k])

    def test_labels_are_next_tokens(self):
        b = SyntheticLMDataset(1000, 16, 2, seed=0).batch(0)
        assert b["tokens"].shape == (2, 16) and b["labels"].shape == (2, 16)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_tokens_in_range_and_hot_ids(self):
        b = SyntheticLMDataset(500, 256, 8, seed=1).batch(3)
        assert b["tokens"].min() >= 0 and b["tokens"].max() < 500
        _, counts = np.unique(b["tokens"], return_counts=True)
        assert counts.max() > 5

    def test_prefetcher_orders_steps(self):
        ds = SyntheticLMDataset(100, 8, 2, seed=2)
        pf = Prefetcher(ds, depth=2, start_step=5)
        s0, b0 = pf.next()
        s1, _ = pf.next()
        pf.close()
        assert (s0, s1) == (5, 6)
        np.testing.assert_array_equal(b0["tokens"], ds.batch(5)["tokens"])

    def test_prefetcher_places_batches_on_a_device(self):
        ds = SyntheticLMDataset(100, 8, 2, seed=2, modality={"frames": (3, 4)})
        pf = Prefetcher(ds, depth=1, start_step=1, device="cpu")
        step, b = pf.next()
        pf.close()
        assert step == 1 and all(isinstance(v, torch.Tensor) for v in b.values())
        assert b["tokens"].dtype == torch.int32 and b["frames"].dtype == torch.float32
        np.testing.assert_array_equal(b["labels"].numpy(), ds.batch(1)["labels"])

    @pytest.mark.parametrize("step", [0, 9])
    def test_batches_equal_jax(self, step):
        mod = {"vision": (4, 6)}
        want = JaxDataset(777, 40, 3, seed=11, modality=mod).batch(step)
        got = SyntheticLMDataset(777, 40, 3, seed=11, modality=mod).batch(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


class TestCheckpointer:
    def test_roundtrip_and_retention(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), keep=2, async_save=False)
        state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
                 "opt": {"step": torch.tensor(4, dtype=torch.int32)}}
        for s in (1, 2, 3):
            ckpt.save(s, state, metadata={"note": "t"})
        assert ckpt.all_steps() == [2, 3]
        template = _zeros(state)
        step, restored = ckpt.restore(template)
        assert step == 3 and restored is template
        assert torch.equal(restored["params"]["w"], state["params"]["w"])
        assert restored["opt"]["step"].dtype == torch.int32
        with open(tmp_path / "step_00000003" / "manifest.json") as f:
            manifest = json.load(f)
        assert manifest["note"] == "t" and manifest["leaves"]["params|w"] == [[2, 3], "float32"]

    def test_async_save_then_restore(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=True)
        state = {"w": torch.ones(4, 4)}
        ckpt.save(10, state)
        ckpt.wait()
        step, restored = ckpt.restore(_zeros(state))
        assert step == 10 and torch.equal(restored["w"], state["w"])

    def test_async_save_holds_the_step_the_optimizer_then_updates_in_place(self, tmp_path,
                                                                          monkeypatch):
        """The writer thread writes the state as it was at ``save``, not as
        the in-place update that follows leaves it; ``restore`` waits for it.
        The writer is held back until the update is done, and then slowed,
        so both orders are forced."""
        updated = threading.Event()
        savez = np.savez

        def held_savez(*args, **kwargs):
            assert updated.wait(timeout=60)
            time.sleep(0.2)
            savez(*args, **kwargs)

        monkeypatch.setattr(np, "savez", held_savez)
        cfg, params = _init("deepseek-7b", seed=4)
        opt_cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=1, state_dtype="int8")
        step_fn = make_train_step(cfg, opt_cfg, SMOKE_KW)
        ds = SyntheticLMDataset(cfg.vocab_size, 16, 2, seed=1)
        state = {"params": params, "opt": adamw_init(params, opt_cfg)}
        state, _ = step_fn(state, _to(ds.batch(0)))
        saved = _clone(state)
        ckpt = Checkpointer(str(tmp_path), async_save=True)
        ckpt.save(1, state)
        state, _ = step_fn(state, _to(ds.batch(1)))  # in place, while the writer runs
        updated.set()
        assert not torch.equal(state["params"]["embed"], saved["params"]["embed"])
        step, restored = ckpt.restore(_zeros(state))
        assert step == 1
        for (key, a), (_, b) in zip(tree_items(restored), tree_items(saved)):
            assert a.dtype == b.dtype and torch.equal(a, b), key

    def test_restore_refuses_a_template_of_another_shape(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(1, {"w": torch.ones(4, 4)})
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore({"w": torch.zeros(4, 5)})

    def test_bf16_round_trip(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        w = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
        state = {"w": w, "q": torch.arange(-3, 3, dtype=torch.int8)}
        ckpt.save(1, state)
        with open(tmp_path / "step_00000001" / "manifest.json") as f:
            assert json.load(f)["leaves"]["w"] == [[5, 7], "bfloat16"]
        _, restored = ckpt.restore({"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                                    "q": torch.zeros(6, dtype=torch.int8)})
        assert restored["w"].dtype == torch.bfloat16 and torch.equal(restored["w"], w)
        assert torch.equal(restored["q"], state["q"])

    def test_missing_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            Checkpointer(str(tmp_path)).restore({"w": torch.zeros(1)})


@pytest.fixture(scope="module")
def jax_state():
    """An f32 smoke train state (int8 moments, so every leaf dtype crosses)
    of the JAX package, as numpy."""
    cfg = jax_config("deepseek-7b", smoke=True)
    params, _ = jzoo.init(jax.random.key(3), cfg)
    opt = jax_adamw_init(params, JaxAdamWConfig(state_dtype="int8"))
    return {"params": params, "opt": opt}


class TestCheckpointsCrossPackages:
    def test_jax_save_restores_in_the_port(self, tmp_path, jax_state):
        JaxCheckpointer(str(tmp_path), async_save=False).save(7, jax_state)
        template = params_from_numpy(jax.tree.map(np.zeros_like, jax.tree.map(np.asarray,
                                                                              jax_state)), "cpu")
        step, got = Checkpointer(str(tmp_path)).restore(template)
        assert step == 7
        want = dict(tree_items(jax.tree.map(np.asarray, jax_state)))
        for key, t in tree_items(got):
            assert t.dtype == template_dtype(template, key)
            np.testing.assert_array_equal(t.numpy(), want[key], err_msg=key)

    def test_port_save_restores_in_jax(self, tmp_path, jax_state):
        state = params_from_numpy(jax.tree.map(np.asarray, jax_state), "cpu")
        Checkpointer(str(tmp_path), async_save=False).save(4, state)
        step, got = JaxCheckpointer(str(tmp_path)).restore(jax_state)
        assert step == 4
        for (ka, a), (kb, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                    jax.tree_util.tree_leaves_with_path(jax_state)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_tree_to_numpy_round_trips_bf16_bits(self):
        t = torch.randn(3, 4).to(torch.bfloat16)
        bits = tree_to_numpy({"a": {"t": t}})["a"]["t"]
        assert bits.dtype == np.uint16
        as_jax = tree_to_numpy({"t": t}, bf16=jnp.bfloat16)["t"]
        assert as_jax.dtype == jnp.bfloat16
        assert torch.equal(params_from_numpy({"t": as_jax}, "cpu")["t"], t)


def template_dtype(template, key):
    return dict(tree_items(template))[key].dtype


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------


class TestFaultTolerance:
    def test_heartbeat_liveness(self, tmp_path):
        hb = Heartbeat(str(tmp_path / "hb.json"), interval_s=0.05)
        hb.start()
        time.sleep(0.15)
        hb.stop()
        assert Heartbeat.is_alive(str(tmp_path / "hb.json"), timeout_s=5.0)
        assert not Heartbeat.is_alive(str(tmp_path / "missing.json"), 1.0)

    def test_beats_from_two_threads_never_race(self, tmp_path):
        """The launcher's ``beat(step=...)`` and the heartbeat's own thread
        write one temporary file; unlocked (as the reference's is), one
        thread's ``os.replace`` finds it already moved: FileNotFoundError."""
        hb = Heartbeat(str(tmp_path / "hb.json"))
        errors = []

        def hammer():
            try:
                for i in range(500):
                    hb.beat(step=i)
            except OSError as e:
                errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert Heartbeat.is_alive(str(tmp_path / "hb.json"), timeout_s=5.0)

    def test_straggler_monitor_flags(self):
        mon = StragglerMonitor(threshold=2.0, min_steps=4)
        for i in range(8):
            assert not mon.record(i, 0.1)
        assert mon.record(8, 0.5)  # 5x median
        assert mon.flags == [8]

    def test_run_resilient_restores_and_replays(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        executed = []
        ckpt.save(0, {"x": torch.zeros(())})
        fail_at = {3}

        def step_fn(step):
            if step in fail_at:
                fail_at.discard(step)  # fail once
                raise RuntimeError("simulated node failure")
            executed.append(step)
            ckpt.save(step + 1, {"x": torch.tensor(float(step + 1))})

        failures = run_resilient(step_fn, 0, 6, ckpt.latest_step, max_failures=2)
        assert failures == 1
        assert executed == [0, 1, 2, 3, 4, 5]

    def test_run_resilient_gives_up(self):
        def step_fn(step):
            raise RuntimeError("permanent failure")

        with pytest.raises(RuntimeError):
            run_resilient(step_fn, 0, 3, lambda: 0, max_failures=2, backoff_s=0.0)


# ---------------------------------------------------------------------------
# the train step, integrated
# ---------------------------------------------------------------------------


class TestTrainStepIntegration:
    def test_loss_decreases_on_tiny_model(self):
        cfg, params = _init("deepseek-7b")
        opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=2, decay_steps=50, weight_decay=0.0)
        step_fn = make_train_step(cfg, opt_cfg, fwd_kwargs=SMOKE_KW)
        ds = SyntheticLMDataset(cfg.vocab_size, 16, 4, seed=0)
        state = {"params": params, "opt": adamw_init(params, opt_cfg)}
        losses = []
        for i in range(8):
            state, metrics = step_fn(state, _to(ds.batch(i % 2)))
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0], losses

    def test_grad_accum_matches_full_batch(self):
        cfg, params = _init("deepseek-7b", seed=1)
        opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=0, weight_decay=0.0)
        batch = _to(SyntheticLMDataset(cfg.vocab_size, 16, 8, seed=3).batch(0))
        s1 = {"params": params, "opt": adamw_init(params, opt_cfg)}
        s2 = _clone(s1)
        s1, m1 = make_train_step(cfg, opt_cfg, SMOKE_KW)(s1, batch)
        s2, m2 = make_train_step(cfg, opt_cfg, SMOKE_KW, grad_accum=4)(s2, batch)
        w1 = s1["params"]["layers"]["attn"]["wq"]
        w2 = s2["params"]["layers"]["attn"]["wq"]
        np.testing.assert_allclose(w1.numpy(), w2.numpy(), atol=2e-4)
        assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-4 * float(m1["loss"])


ARCHS = sorted(a for a in ARCH_REGISTRY if get_config(a, smoke=True).family != "hybrid")
B, S = 2, 32


def _arch_batch(cfg, rng):
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(
            rng.normal(size=(B, cfg.vision_tokens, cfg.d_vision)).astype(np.float32))
    if cfg.family == "enc_dec":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(B, cfg.encoder_seq, cfg.d_audio)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_train_step_decreases_loss(arch):
    """tests/test_arch_smoke.py's per-arch step on the port: finite grads,
    a finite loss after one SGD step, no blow-up."""
    cfg, params = _init(arch, seed=1)
    rng = np.random.default_rng(zlib.crc32(arch.encode()) % 2**31 + 1)
    batch = _arch_batch(cfg, rng)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    kw = dict(chunk=16) if cfg.family == "ssm" else SMOKE_KW

    def loss_fn(p):
        logits, aux = model_zoo.forward(p, cfg, batch, **kw)
        ll = torch.log_softmax(logits[:, -S:].float(), dim=-1)
        return -torch.gather(ll, -1, labels[..., None]).mean() + 0.01 * aux

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss0 = loss_fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss0, leaves)
    assert np.isfinite(loss0.item())
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    assert np.isfinite(gnorm.item()) and gnorm.item() > 0
    with torch.no_grad():
        loss1 = loss_fn(tree_unflatten(params, [p - 0.1 * g.to(p.dtype)
                                                for p, g in zip(leaves, grads)]))
    assert np.isfinite(loss1.item())
    assert loss1.item() < loss0.item() + 1.0


class TestResilientTraining:
    """tests/test_system.py's training tests on the port."""

    def test_training_survives_failure_and_replays_data(self, tmp_path):
        cfg, params = _init("deepseek-7b")
        opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=2, weight_decay=0.0)
        step_fn = make_train_step(cfg, opt_cfg, SMOKE_KW)
        ds = SyntheticLMDataset(cfg.vocab_size, 16, 4, seed=0)
        ckpt = Checkpointer(str(tmp_path), keep=3, async_save=False)
        holder = {"state": {"params": params, "opt": adamw_init(params, opt_cfg)}}
        ckpt.save(0, holder["state"])
        seen, fail_once = [], {2}

        def train_one(step):
            if step in fail_once:
                fail_once.discard(step)
                raise RuntimeError("simulated preemption")
            holder["state"], _ = step_fn(holder["state"], _to(ds.batch(step)))
            seen.append(step)
            ckpt.save(step + 1, holder["state"])

        def restore():
            s, holder["state"] = ckpt.restore(holder["state"])
            return s

        failures = run_resilient(train_one, 0, 5, restore, max_failures=2)
        assert failures == 1
        assert seen == [0, 1, 2, 3, 4]  # exact replay after restore
        assert ckpt.latest_step() == 5

    def test_restored_state_bitwise_identical(self, tmp_path):
        """(train 2 steps) == (train 1, checkpoint, restore, train 1)."""
        cfg, params = _init("deepseek-7b", seed=2)
        opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1, weight_decay=0.0)
        step_fn = make_train_step(cfg, opt_cfg, SMOKE_KW)
        ds = SyntheticLMDataset(cfg.vocab_size, 16, 4, seed=7)
        batches = [_to(ds.batch(i)) for i in range(2)]
        s_direct = {"params": _clone(params), "opt": adamw_init(params, opt_cfg)}
        for b in batches:
            s_direct, _ = step_fn(s_direct, b)
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        s2 = {"params": _clone(params), "opt": adamw_init(params, opt_cfg)}
        s2, _ = step_fn(s2, batches[0])
        ckpt.save(1, s2)
        _, s2r = ckpt.restore(_zeros(s2))
        s2r, _ = step_fn(s2r, batches[1])
        for a, b in zip(tree_leaves(s_direct), tree_leaves(s2r)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


class TestEntryPoints:
    def test_launcher_trains_and_resumes_from_its_checkpoint(self, tmp_path, capsys):
        ckpt = str(tmp_path / "ckpt")
        argv = ["--device", "cpu", "--arch", "phi4-mini-3.8b", "--steps", "6", "--batch", "2",
                "--seq-len", "16", "--ckpt-every", "2", "--log-every", "1", "--int8-opt",
                "--ckpt-dir", ckpt, "--heartbeat", str(tmp_path / "hb.json")]
        straight = launch_train.main(argv)
        assert sorted(straight["losses"]) == list(range(6)) and straight["failures"] == 0
        assert sorted(os.listdir(ckpt)) == ["step_00000003", "step_00000005", "step_00000006"]
        resume = tmp_path / "resume"
        resume.mkdir()
        os.rename(os.path.join(ckpt, "step_00000003"), resume / "step_00000003")
        argv[argv.index("--ckpt-dir") + 1] = str(resume)
        resumed = launch_train.main(argv)
        assert sorted(resumed["losses"]) == [3, 4, 5]
        for s in (3, 4, 5):
            assert resumed["losses"][s] == straight["losses"][s]
        assert "[train] restored step 3" in capsys.readouterr().out
        assert Heartbeat.is_alive(str(tmp_path / "hb.json"), timeout_s=60.0)

    def test_launcher_defaults_to_the_card(self):
        if torch.cuda.is_available():  # pragma: no cover - a CUDA host
            return
        with pytest.raises(RuntimeError, match="cuda"):
            launch_train.main(["--steps", "1"])

    def test_example_trains_on_the_cpu(self, tmp_path, capsys):
        losses = train_llm.main(["--device", "cpu", "--steps", "12", "--d-model", "64",
                                 "--layers", "2", "--seq-len", "32", "--batch", "4",
                                 "--vocab", "512", "--ckpt-dir", str(tmp_path)])
        assert len(losses) == 12 and all(np.isfinite(losses))
        assert "final checkpoint" in capsys.readouterr().out
        assert "step_00000012" in os.listdir(tmp_path)
