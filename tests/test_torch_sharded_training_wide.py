"""Sharded training on the wider gloo meshes: 2x2 (phi4-mini-3.8b-smoke),
1x4 and 2x4 (deepseek-7b-smoke, whose 4 / 4 heads split four ways), each
case held to the JAX package's single-device train step by
``tests/test_torch_sharded_training.py``'s checks (its docstring states
them)."""

import pytest

from test_torch_sharded_training import DEEPSEEK, PHI, Case, check_against_jax, sharded

MESHES = {
    (2, 2): (Case(PHI, fsdp=True, masked=True), Case(PHI, "int8", grad_accum=2)),
    (1, 4): (Case(DEEPSEEK, fsdp=True),),
    (2, 4): (Case(DEEPSEEK, "int8", fsdp=True), Case(DEEPSEEK, grad_accum=2, masked=True)),
}


@pytest.mark.parametrize("mesh,i", [(m, i) for m, cs in MESHES.items() for i in range(len(cs))],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_sharded_train_step_matches_jax(mesh, i):
    case = MESHES[mesh][i]
    check_against_jax(mesh, case, sharded(mesh, MESHES[mesh])[case])
