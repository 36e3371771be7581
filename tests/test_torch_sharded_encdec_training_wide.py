"""The enc_dec family's (whisper's) sharded train step on the 2x2 mesh,
held to the JAX package's train step on a CPU mesh of the same shape
(``tests/test_torch_sharded_encdec_training.py`` says how, and holds 1x1,
2x1 and 1x2): FSDP with int8 moments under ``sp``, and without ``sp``
(the decoder's residual whole on every model rank, the encoder's as
always); and the train launcher on a mesh with a resume."""

import os
import subprocess
import sys

import pytest
import torch

from test_torch_sharded_encdec_training import ARCH, REPO, Case, check_case, ids

torch.set_num_threads(1)

MESHES = {(2, 2): (Case("int8", fsdp=True), Case(sp=False))}


@pytest.mark.parametrize("mesh,i", [(m, i) for m, cs in MESHES.items() for i in range(len(cs))],
                         ids=ids)
def test_sharded_whisper_train_step_matches_jax_on_the_mesh(mesh, i):
    check_case(mesh, MESHES[mesh], i)


def test_train_launcher_trains_whisper_on_a_mesh_and_resumes(tmp_path):
    """``torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train
    --device cpu --arch whisper-medium --mesh 1,2 --fsdp`` (``sp`` on): 3
    steps checkpointing after each, then a run from a directory holding
    only step 2's checkpoint resumes there and logs the straight run's loss
    at step 2."""
    def run(ckpt):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", ARCH,
             "--mesh", "1,2", "--fsdp", "--steps", "3", "--batch", "2", "--seq-len", "16",
             "--ckpt-every", "1", "--log-every", "1", "--ckpt-dir", str(ckpt),
             "--heartbeat", str(tmp_path / "hb.json")],
            env=env, capture_output=True, text=True, timeout=240, cwd=REPO)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    straight = run(tmp_path / "straight")
    assert "[train] mesh 1x2 (whisper-smoke; fsdp True, sp True)" in straight
    os.makedirs(tmp_path / "resume")
    os.rename(tmp_path / "straight" / "step_00000002", tmp_path / "resume" / "step_00000002")
    resumed = run(tmp_path / "resume")
    assert "restored step 2" in resumed
    loss = lambda text: [ln.split("loss")[1].split()[0] for ln in text.splitlines()
                         if ln.startswith("[train] step     2")]
    assert loss(resumed) == loss(straight) and len(loss(straight)) == 1
