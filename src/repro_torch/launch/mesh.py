"""Meshes: the production shapes, and a debug mesh over a running world.

Counterpart of :mod:`repro.launch.mesh`.  The production meshes give their
shape and axis names only (:class:`MeshShape`): nothing here reaches a
device or a process group until :func:`make_debug_mesh` builds a
``DeviceMesh`` over the world the caller started.  The serving and
training launchers take their mesh flags (:func:`add_mesh_args`,
:func:`mesh_from_args`) and start their world (:func:`start_mesh`,
:func:`stop_mesh`) here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind it."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 ``(data, model)`` on one pod; 2 x 16 x 16 ``(pod, data,
    model)`` on two."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_debug_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A ``("data", "model")`` ``DeviceMesh`` over the running world, on
    ``cuda`` (NCCL) unless the caller asks for ``cpu`` (gloo).  The caller
    starts the world (``torch.distributed.init_process_group``, or
    ``torchrun``); ``data * model`` must be its size.  Rank ``r`` sits at
    ``(r // model, r % model)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh: start the process group first "
                           "(torch.distributed.init_process_group or torchrun)")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"make_debug_mesh: mesh {data}x{model} needs {data * model} "
                         f"ranks, the world has {world}")
    return init_device_mesh(device, (data, model), mesh_dim_names=("data", "model"))


def add_mesh_args(ap) -> None:
    """A launcher's ``--data`` / ``--model`` / ``--mesh`` flags."""
    ap.add_argument("--data", type=int, default=1, help="data axis of the mesh")
    ap.add_argument("--model", type=int, default=1, help="model axis of the mesh")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL mesh shape (e.g. 2,4; overrides --data / --model); "
                         "run under torchrun --nproc-per-node DATA*MODEL")


def mesh_from_args(args) -> bool:
    """Set ``args.data`` / ``args.model`` from ``--mesh`` where it is given;
    returns whether the run serves on a mesh (``--mesh``, or more than one
    rank).  ``--server`` takes none."""
    from repro_torch.serving.sharded import parse_mesh_arg

    if args.mesh:
        args.data, args.model = parse_mesh_arg(args.mesh)
    meshed = bool(args.mesh) or args.data * args.model > 1
    if meshed and getattr(args, "server", False):
        raise SystemExit("--server takes no mesh: the front door drives one Scheduler")
    return meshed


def start_mesh(data: int, model: int, device: torch.device, **rule_kw):
    """The world (``torchrun``'s, else one rank over a file store) and
    rules over a ``(data, model)`` mesh of it: NCCL on the card, where each
    rank takes the card of its ``LOCAL_RANK``, gloo on the CPU.
    ``rule_kw`` are the rules' keywords (training's ``fsdp_axes`` and
    ``sp``; serving's rules take none).  Returns ``(device, rules,
    started)``; hand ``started`` to :func:`stop_mesh`."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed.sharding import rules_for_mesh

    started = not dist.is_initialized()
    if started:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            store = os.path.join(tempfile.mkdtemp(prefix="mesh-"), "store")
            dist.init_process_group(backend, init_method=f"file://{store}", rank=0,
                                    world_size=1)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return device, rules_for_mesh(make_debug_mesh(data, model, device.type), **rule_kw), started


def stop_mesh(started: bool) -> None:
    """End the world :func:`start_mesh` started (a caller's own stays)."""
    if started:
        import torch.distributed as dist

        dist.destroy_process_group()
