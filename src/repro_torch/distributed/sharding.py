"""Logical-axis sharding rules -> mesh-axis specs, and the two helpers of
explicit SPMD.

Counterpart of :mod:`repro.distributed.sharding`.  Every parameter leaf of
the model zoo carries a tuple of *logical* axis names
(``models/*.py: param_specs``); :class:`ShardingRules` maps them onto the
physical mesh axes:

  single pod : mesh ("data", "model") = (16, 16)
  multi-pod  : mesh ("pod", "data", "model") = (2, 16, 16)

Megatron-style tensor parallelism over "model", batch parallelism over
"data" (+ "pod"); ``fsdp_axes`` and ``seq_shard`` are the reference's
strategy knobs, kept for its specs.

A spec is a plain tuple with one entry a dim: a mesh-axis name, a tuple of
them, or ``None`` (replicated) -- the port's ``PartitionSpec``.  A mesh is
anything with a ``(data, model)``-style shape: a
``torch.distributed.device_mesh.DeviceMesh``, a
:class:`repro_torch.launch.mesh.MeshShape` or a plain ``{axis: size}``
mapping.

The reference places arrays with GSPMD and steers it with ``constrain``.
The port runs explicit SPMD instead, one process a rank, each holding the
local tensors of its shard: :func:`local_slice` takes a rank's block of a
whole tensor along a spec, and :func:`all_gather` concatenates a dim over
one mesh axis's process group.  ``constrain`` has no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

# logical axis vocabulary used by the model zoo
BATCH = "batch"
SEQ = "seq"  # activation sequence axis (sequence parallelism / long-ctx KV)
TOKENS = "tokens"  # flattened B*S: all axes that shard tokens (MoE groups)
VOCAB = "vocab"
D_MODEL = "d_model"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
FF = "ff"
EXPERT = "expert"
LAYERS = "layers"  # stacked leading dim: never sharded
CONV = "conv"
STATE = "state"
VISION = "vision"
NONE = None

Spec = Tuple[Any, ...]


class ShardingFallbackWarning(UserWarning):
    """A logical axis could not shard its dim and was replicated instead.

    Warned by :meth:`ShardingRules.spec_for_shape` so a mis-sized tensor
    (a KV pool whose head axis does not divide the ``"model"`` axis) shows
    up in logs instead of passing for a sharded one.  Replication stays
    the behaviour; the warning only adds the signal."""


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a ``MeshShape`` or a
    mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # torch DeviceMesh
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in order."""
    names = getattr(mesh, "mesh_dim_names", None) or getattr(mesh, "axis_names", None)
    return tuple(names) if names is not None else tuple(mesh_sizes(mesh))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps a logical axis name to a mesh axis (or None = replicated)."""

    batch_axes: Tuple[str, ...] = ("data",)  # ("pod", "data") on multi-pod
    model_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ()  # logical axes also sharded over data
    seq_shard: bool = False  # shard KV seq over data (long-context decode)
    sp: bool = False  # sequence parallelism: activations' seq over model
    # the mesh the rules place on: a DeviceMesh for a running world, a
    # MeshShape or a mapping for pure spec work; None = one device
    mesh: Any = None

    def mesh_axis(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == BATCH:
            if self.seq_shard:
                return None  # long-context decode: data axis belongs to SEQ
            ax = tuple(self.batch_axes)
            return ax if len(ax) > 1 else ax[0]
        if logical in (VOCAB, HEADS, KV_HEADS, FF, EXPERT):
            return self.model_axis
        if logical == SEQ:
            if self.seq_shard:
                return tuple(self.batch_axes)
            return self.model_axis if self.sp else None
        if logical == TOKENS:
            # token groups shard over the batch axes only: "model" belongs
            # to the expert FF dim
            ax = tuple(self.batch_axes)
            return ax if len(ax) > 1 else (ax[0] if ax else None)
        if logical in self.fsdp_axes:
            return tuple(self.batch_axes)
        return None

    def _batch_size(self) -> int:
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes.get(a, 1) for a in self.batch_axes)

    def token_groups(self, n_tokens: int) -> int:
        """Shard-aligned groups the flattened token dim splits into (MoE
        group-local dispatch); 1 without a mesh."""
        if self.mesh is None:
            return 1
        g = self._batch_size()
        if self.sp:
            g *= mesh_sizes(self.mesh).get(self.model_axis, 1)
        return math.gcd(n_tokens, g)

    def group_sizes(self, batch: int, seq: int) -> Tuple[int, int]:
        """``(Gb, Gs)``: shard-aligned group factors along batch and seq
        (``Gs`` stays 1: S is gathered entering the expert FFN)."""
        if self.mesh is None:
            return 1, 1
        return math.gcd(batch, self._batch_size()), 1

    def spec(self, logical_axes) -> Spec:
        """Mesh-axis spec of a logical tuple; a mesh axis appears at most
        once (a later logical dim that wants it replicates)."""
        used = set()
        out = []
        for ax in logical_axes:
            phys = self.mesh_axis(ax)
            key = tuple(phys) if isinstance(phys, tuple) else (phys,)
            if phys is None or any(k in used for k in key if k is not None):
                out.append(None)
            else:
                used.update(k for k in key if k is not None)
                out.append(phys)
        return tuple(out)

    def spec_for_shape(self, mesh, logical_axes, shape) -> Spec:
        """Like :meth:`spec`, with divisibility: an axis that cannot shard
        its dim replicates it (warning :class:`ShardingFallbackWarning`
        unless the dim is 1) and stays available for a later dim."""
        sizes = mesh_sizes(mesh)
        used = set()
        out = []
        for dim, logical in zip(shape, tuple(logical_axes) + (None,) * len(shape)):
            phys = self.mesh_axis(logical)
            if phys is None:
                out.append(None)
                continue
            axes = phys if isinstance(phys, tuple) else (phys,)
            total = math.prod(sizes[a] for a in axes)
            if any(a in used for a in axes):
                out.append(None)
                continue
            if dim % total != 0:
                if dim > 1:
                    warnings.warn(
                        f"logical axis {logical!r} (dim {dim}) is not divisible by mesh "
                        f"axes {tuple(axes)} (size {total}); replicating instead",
                        ShardingFallbackWarning, stacklevel=2)
                out.append(None)
                continue
            used.update(axes)
            out.append(phys)
        return tuple(out)

    def tree_specs(self, logical_tree):
        """Map a tree (nested dicts) of logical tuples to specs."""
        if isinstance(logical_tree, dict):
            return {k: self.tree_specs(v) for k, v in logical_tree.items()}
        return self.spec(tuple(logical_tree))


def stacked(specs):
    """``specs`` with ``LAYERS`` before every leaf's axes (a stacked
    ``(L, ...)`` layer tree)."""
    if isinstance(specs, dict):
        return {k: stacked(v) for k, v in specs.items()}
    return (LAYERS,) + tuple(specs)


def rules_for_mesh(mesh, **kw) -> ShardingRules:
    """Default rules for a mesh (``"pod"`` joins the batch axes)."""
    axes = mesh_axis_names(mesh)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    return ShardingRules(batch_axes=batch or ("data",), mesh=mesh, **kw)


# --------------------------------------------------------------------------
# explicit SPMD: a rank's block, and one axis's all-gather
# --------------------------------------------------------------------------


def local_slice(x: torch.Tensor, spec: Spec, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> torch.Tensor:
    """The block of the whole tensor ``x`` that the rank at mesh
    coordinates ``coords`` holds under ``spec`` (a view).  A dim sharded
    over several axes splits them major to minor, as a ``PartitionSpec``
    does."""
    for dim, phys in enumerate(spec):
        if phys is None:
            continue
        axes = phys if isinstance(phys, tuple) else (phys,)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        step = x.shape[dim] // n
        x = x.narrow(dim, idx * step, step)
    return x


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor as its bytes, ``(leading dim, bytes a row)``
    (a 0-d tensor as one row): what the collectives move, so gloo and NCCL
    carry any dtype and no arithmetic touches it."""
    return x.reshape(x.shape[0] if x.dim() else 1, -1).view(torch.uint8)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` over ``group``, in the
    group's rank order, bit for bit.  A group of one still goes through the
    collective."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    part = x.movedim(dim, 0).contiguous()
    wire = _bytes(part)
    out = torch.empty((n * wire.shape[0],) + tuple(wire.shape[1:]), dtype=torch.uint8,
                      device=wire.device)
    # all_gather_single is all_gather_into_tensor's newer name
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, wire, group=group)
    out = out.view(part.dtype).reshape((n * part.shape[0],) + tuple(part.shape[1:]))
    return out.movedim(0, dim)


def broadcast(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """``x`` (contiguous) of the rank at group index ``src`` on every rank of
    ``group``, in place, bit for bit."""
    import torch.distributed as dist

    dist.broadcast(_bytes(x), src=dist.get_global_rank(group, src), group=group)
    return x


# --------------------------------------------------------------------------
# tensor parallelism as a model's layers see it
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """One rank's place on the model axis under explicit SPMD: the axis's
    ``size`` and ``group``, this rank's index ``rank`` on it, and whether
    the heads (q / k / v and the KV stores) and the vocab (the embedding
    and the head) split over it.  The layers take it, or ``None`` for the
    whole model, through the functions below."""

    size: int
    rank: int
    heads: bool
    vocab: bool
    group: Any


def local_heads(cfg, split: Optional[ModelSplit] = None) -> Tuple[int, int]:
    """``(Hq, Hk)`` a rank computes (the whole counts without a split)."""
    n = split.size if split is not None and split.heads else 1
    return cfg.num_heads // n, cfg.num_kv_heads // n


def gather_heads(x: torch.Tensor, split: Optional[ModelSplit], dim: int) -> torch.Tensor:
    """Every rank's heads of ``x`` along ``dim``, concatenated over the model
    axis (identity where the heads are whole)."""
    return all_gather(x, split.group, dim) if split is not None and split.heads else x


def gather_vocab(logits: torch.Tensor, split: Optional[ModelSplit]) -> torch.Tensor:
    """The whole vocab of head logits split on their last dim."""
    return all_gather(logits, split.group, -1) if split is not None and split.vocab else logits


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 split: Optional[ModelSplit]) -> torch.Tensor:
    """Rows of an embedding ``table`` whose vocab may split over the model
    axis: each rank looks up the tokens it holds (its other lanes read row
    0), the rows are all-gathered and each token takes its holder's,
    exactly."""
    if split is None or not split.vocab:
        return table[tokens]
    n = table.shape[0]
    rows = table[(tokens - split.rank * n).clamp(0, n - 1)]
    every = all_gather(rows[None], split.group, 0)  # (size, ..., D)
    owner = torch.div(tokens, n, rounding_mode="floor")
    idx = owner[None, ..., None].expand((1,) + tuple(rows.shape))
    return torch.gather(every, 0, idx)[0]
