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
whole tensor along a spec (:func:`cut_tree` a whole tree's, by the specs of
:func:`physical_specs`; :func:`gather_whole` puts a block back together),
and :func:`all_gather` concatenates a dim over one mesh axis's process
group.  ``constrain`` has no counterpart.

A dim may split in parts (:class:`Segments`): the mamba mixer's packed
``in_proj`` columns ``[z, x, B, C, dt]`` split ``z``, ``x`` and ``dt`` by
heads and keep ``B`` and ``C`` whole on every rank, where GSPMD's
placement of ``(d_model, ff)`` would cut the packed axis in contiguous
blocks across the parts.  :func:`local_slice`, :func:`cut_tree`,
:func:`gather_whole` and :func:`physical_specs` honour it, so a gathered
tree is the whole one in the reference's column order.

Training differentiates through the collectives, so it has its own:
``torch.autograd.Function`` pairs whose backward is the forward's dual
(:func:`copy_to` / :func:`reduce_from` around a model-parallel block,
:func:`gather_from` / :func:`scatter_to` for a replicated tensor's blocks,
:func:`gather_shards` / :func:`reduce_scatter_to` for sequence parallelism
and FSDP).  Every sum over ranks is :func:`all_reduce_sum`'s: each rank
gathers every part and adds them in rank order in f32, so all ranks hold
the same bits and a group of one returns its own part unchanged.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
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


class Segments(tuple):
    """A spec entry that splits a dim in parts: the tuple holds the mesh
    axes (as a plain entry's tuple does, so code that reads an entry's axes
    reads these), and ``parts`` lists ``(width, split)`` in order along the
    dim.  A split part's blocks go to the axes' ranks, a whole part is on
    every rank; a rank's block is its block of each part, concatenated.
    Built by :func:`segmented`."""

    def __new__(cls, axes, parts):
        self = super().__new__(cls, tuple(axes))
        self.parts = tuple((int(w), bool(s)) for w, s in parts)
        return self

    def __reduce__(self):
        return Segments, (tuple(self), self.parts)

    def __eq__(self, other):
        return (isinstance(other, Segments) and tuple(self) == tuple(other)
                and self.parts == other.parts)

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash((tuple(self), self.parts))

    def __repr__(self):
        return f"Segments({tuple(self)!r}, {self.parts!r})"

    def ranges(self, n: int, idx: int) -> Tuple[Tuple[int, int], ...]:
        """``(start, stop)`` of each part's piece on the rank at index
        ``idx`` of ``n``: its block of a split part, a whole part whole."""
        out, at = [], 0
        for w, split in self.parts:
            step = w // n if split else w
            lo = at + idx * step if split else at
            out.append((lo, lo + step))
            at += w
        return tuple(out)


def segmented(axis: str, parts) -> Any:
    """The spec entry of a dim made of ``parts`` ``(width, split)`` over the
    mesh axis ``axis``: ``None`` where no part splits, ``axis`` itself
    where the one part splits, else a :class:`Segments`."""
    parts = tuple((int(w), bool(s)) for w, s in parts)
    if not any(s for _, s in parts):
        return None
    if len(parts) == 1:
        return axis
    return Segments((axis,), parts)


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


def block_index(shape, spec: Spec, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The slices of a whole tensor of ``shape`` that the rank at mesh
    coordinates ``coords`` holds under ``spec``.  A dim sharded over
    several axes splits them major to minor, as a ``PartitionSpec`` does."""
    out = []
    for dim, size in enumerate(shape):
        phys = spec[dim] if dim < len(spec) else None
        if phys is None or isinstance(phys, Segments):  # a segmented dim: local_slice
            out.append(slice(None))
            continue
        n, idx = _axis_index(phys if isinstance(phys, tuple) else (phys,), sizes, coords)
        step = size // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def _axis_index(axes, sizes, coords) -> Tuple[int, int]:
    """``(n, idx)``: the ranks over ``axes`` (major to minor) and the index
    of the rank at ``coords`` among them."""
    n, idx = 1, 0
    for a in axes:
        n *= sizes[a]
        idx = idx * sizes[a] + coords[a]
    return n, idx


def local_slice(x, spec: Spec, sizes: Mapping[str, int], coords: Mapping[str, int]):
    """The block of the whole tensor (or numpy array) ``x`` that the rank
    at mesh coordinates ``coords`` holds under ``spec`` (a view; a copy
    where a dim is :class:`Segments`, its parts' pieces concatenated)."""
    y = x[block_index(x.shape, spec, sizes, coords)]
    for dim, phys in enumerate(spec):
        n, idx = _axis_index(phys, sizes, coords) if isinstance(phys, Segments) else (1, 0)
        if n > 1:  # one rank's block is the whole dim: no copy
            pieces = [y[(slice(None),) * dim + (slice(lo, hi),)]
                      for lo, hi in phys.ranges(n, idx)]
            y = torch.cat(pieces, dim) if isinstance(y, torch.Tensor) else \
                np.concatenate(pieces, dim)
    return y


def mesh_coords(mesh) -> Dict[str, int]:
    """This process's coordinate on every axis of a ``DeviceMesh``."""
    return {a: int(mesh.get_local_rank(a)) for a in mesh_axis_names(mesh)}


def physical_specs(tree, specs, rules: ShardingRules, drop=(), segments=None):
    """The mesh-axis spec of every leaf of ``tree`` from its logical
    ``specs`` (:meth:`ShardingRules.spec_for_shape` at the leaf's shape,
    the logical axes in ``drop`` replicated).  ``segments``: a tree of the
    same nesting, as deep as it needs to go, whose leaves ``(dim, parts)``
    place that dim of the leaf in parts over ``"model"``
    (:func:`segmented`) whatever its logical axis says."""
    if isinstance(tree, dict):
        sub = lambda k: segments.get(k) if isinstance(segments, dict) else None
        return {k: physical_specs(v, specs[k] if isinstance(specs, dict) else specs, rules, drop,
                                  sub(k))
                for k, v in tree.items()}
    axes = [None if a in drop else a for a in specs]
    dim = None
    if segments is not None:
        dim, parts = segments
        dim %= len(tree.shape)
        axes[dim] = None  # the parts place it, not the logical axis
    spec = rules.spec_for_shape(rules.mesh, tuple(axes), tree.shape)
    if dim is not None:
        spec = spec[:dim] + (segmented(rules.model_axis, parts),) + spec[dim + 1:]
    return spec


def cut_tree(tree, phys, rules: ShardingRules):
    """Each leaf of the whole ``tree`` cut to this rank's block of its spec
    in ``phys``.  A cut leaf is copied, contiguous, so the whole tensor can
    be freed; an uncut one is the same tensor."""
    sizes, coords = mesh_sizes(rules.mesh), mesh_coords(rules.mesh)

    def one(x, spec):
        y = local_slice(x, spec, sizes, coords)
        if y.shape == x.shape:
            return x
        return y if any(isinstance(e, Segments) for e in spec) else y.contiguous().clone()

    if isinstance(tree, dict):
        return {k: cut_tree(v, phys[k], rules) for k, v in tree.items()}
    return one(tree, phys)


def gather_whole(x: torch.Tensor, spec: Spec, rules: ShardingRules) -> torch.Tensor:
    """The whole tensor whose block under ``spec`` this rank holds in
    ``x``: every sharded dim all-gathered over its axes, the minor axis
    first (:func:`local_slice`'s inverse); every rank of the mesh takes
    part.  Contiguous; ``x`` itself where nothing is sharded."""
    for dim, phys in enumerate(spec):
        if phys is None:
            continue
        if isinstance(phys, Segments):
            x = _gather_parts(x, phys, rules, dim)
            continue
        for axis in reversed(phys if isinstance(phys, tuple) else (phys,)):
            x = all_gather(x, rules.mesh.get_group(axis), dim)
    return x.contiguous()


def _gather_parts(x: torch.Tensor, seg: Segments, rules: ShardingRules, dim: int):
    """The whole dim ``dim`` of a :class:`Segments` block: the blocks
    all-gathered over the segments' axis, then each split part's pieces
    concatenated in rank order and a whole part taken from rank 0's."""
    (axis,) = tuple(seg)
    n = mesh_sizes(rules.mesh)[axis]
    every = all_gather(x, rules.mesh.get_group(axis), dim)
    width = x.shape[dim]
    ranks = [part_pieces(every.narrow(dim, r * width, width), dim, seg.parts, n)
             for r in range(n)]
    return torch.cat([ranks[r][i][0] for i, (_, split) in enumerate(seg.parts)
                      for r in range(n if split else 1)], dim)


class PartGroups(tuple):
    """The process groups that split a :class:`Segments` dim (the tuple),
    with its ``parts``: a leaf's entry in the optimizer's ``groups``, so the
    global norm counts a whole part once (:func:`part_pieces`)."""

    def __new__(cls, groups, parts):
        self = super().__new__(cls, tuple(groups))
        self.parts = tuple(parts)
        return self


def part_pieces(x: torch.Tensor, dim: int, parts, n: int):
    """Each part's piece of a rank's block ``x`` of a dim of ``parts`` over
    ``n`` ranks, in order along ``dim``: ``(view, split)``, the rank's block
    of a split part or a whole part."""
    out, at = [], 0
    for w, s in parts:
        step = w // n if s else w
        out.append((x.narrow(dim, at, step), s))
        at += step
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tree lives on a mesh: its leaves' physical specs and the
    rules whose mesh they name (the port's tree of ``NamedSharding``s;
    :class:`repro_torch.checkpoint.Checkpointer` takes it as
    ``shardings``)."""

    specs: Any
    rules: ShardingRules


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor as its bytes, ``(leading dim, bytes a row)``
    (a 0-d tensor as one row): what the collectives move, so gloo and NCCL
    carry any dtype and no arithmetic touches it."""
    lead = x.shape[0] if x.dim() else 1
    # flat first: a size-1 dim may carry any stride, which the byte view refuses
    return x.reshape(-1).view(torch.uint8).reshape(lead, -1)


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


def group_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def group_rank(group) -> int:
    import torch.distributed as dist

    return dist.get_rank(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, the same bits on every
    rank: the parts are all-gathered and added in the group's rank order,
    floats in f32 (cast back to ``x``'s dtype), integers in their own
    dtype.  A group of one returns ``x``'s value."""
    parts = all_gather(x[None], group, 0)
    acc = parts[0].to(torch.float32 if x.is_floating_point() else x.dtype, copy=True)
    for part in parts[1:]:
        acc += part
    return acc.to(x.dtype)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of every rank's ``x`` over ``group`` (exact)."""
    return all_gather(x[None], group, 0).amax(0)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of :func:`all_reduce_sum` of ``x``
    (the parts cut before they are added), contiguous."""
    n, r = group_size(group), group_rank(group)
    step = x.shape[dim] // n
    parts = all_gather(x[None], group, 0).narrow(dim % x.dim() + 1, r * step, step)
    acc = parts[0].to(torch.float32 if x.is_floating_point() else x.dtype, copy=True)
    for part in parts[1:]:
        acc += part
    return acc.to(x.dtype).contiguous()


def own_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (contiguous)."""
    n = group_size(group)
    step = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * step, step).contiguous()


def all_reduce_sum_(x: torch.Tensor, group, chunk: int = 1 << 26) -> torch.Tensor:
    """:func:`all_reduce_sum` into ``x`` in place, a block of leading rows
    of at most ``chunk`` elements at a time, so the temporaries stay those
    of one block (a stacked leaf of 805 M elements is 3.2 GB in f32)."""
    if x.dim() == 0:
        return x.copy_(all_reduce_sum(x, group))
    rows = max(1, chunk // max(1, x[0].numel()))
    for i in range(0, x.shape[0], rows):
        block = x[i:i + rows]
        block.copy_(all_reduce_sum(block, group))
    return x


# --------------------------------------------------------------------------
# collectives with a gradient: each forward's dual is its backward
# --------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return own_block(g, ctx.group, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return own_block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim).contiguous(), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim).contiguous(), None, None


class _SumPart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, lo, hi):
        ctx.group, ctx.dim, ctx.lo, ctx.hi = group, dim, lo, hi
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        part = g.narrow(ctx.dim, ctx.lo, ctx.hi - ctx.lo)
        part.copy_(all_reduce_sum(part, ctx.group))
        return g, None, None, None, None


def sum_part(x: torch.Tensor, group, dim: int, lo: int, hi: int) -> torch.Tensor:
    """Identity forward; backward sums the gradient's ``[lo, hi)`` along
    ``dim`` over ``group``: a whole part of a leaf (the mixer's ``B`` / ``C``
    columns) that each rank applies to its own heads, so that the part's
    gradient is the whole one on every rank (:func:`copy_to` on a part)."""
    return _SumPart.apply(x, group, dim, lo, hi)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, :func:`all_reduce_sum` backward: a replicated
    tensor entering a block whose ranks compute different parts of it (or
    a replicated weight applied to different rows on each rank)."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_reduce_sum` forward, identity backward: the partial sums
    of a row-parallel product, made whole on every rank."""
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather forward, the rank's own block of the gradient backward:
    blocks made whole where every rank then computes the same thing."""
    return _GatherFrom.apply(x, group, dim)


def scatter_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The rank's own block forward, all-gather backward: a replicated
    tensor cut to the rows a rank goes on with."""
    return _ScatterTo.apply(x, group, dim)


def gather_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather forward, reduce-scatter backward: blocks made whole where
    each rank then uses the whole on data of its own (sp's sequence
    entering a model-parallel block; an FSDP weight)."""
    return _GatherShards.apply(x, group, dim)


def reduce_scatter_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Reduce-scatter forward, all-gather backward: a row-parallel
    product's partial sums, summed and cut to the rank's sequence rows."""
    return _ReduceScatterTo.apply(x, group, dim)


# --------------------------------------------------------------------------
# tensor parallelism as a model's layers see it
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """One rank's place on the model axis under explicit SPMD: the axis's
    ``size`` and ``group``, this rank's index ``rank`` on it, and whether
    the heads (q / k / v and the KV stores) and the vocab (the embedding
    and the head) split over it.  The layers take it, or ``None`` for the
    whole model, through the functions below.

    Serving gathers the heads' attend outputs before a replicated ``wo``.
    Training (``rows``) holds Megatron's split instead: ``wo`` and, where
    ``ff``, the MLP's ``down`` are row shards whose partial products are
    summed over the axis (:func:`leave_block`), ``gate`` / ``up`` column
    shards; with ``seq`` (the rules' ``sp``) the residual stream holds
    ``S / size`` rows a rank, gathered entering each block and
    reduce-scattered leaving it.  ``ssm``: the mamba mixers split by heads
    (:func:`mixer_split`): a rank computes its heads' ``z``, ``x`` and
    ``dt`` and the whole ``B`` / ``C``, steps its heads' state, and serving
    gathers the gated product before the replicated norm and ``out_proj``,
    where training sums the gated norm's squares over the axis and holds
    ``out_proj`` row-parallel."""

    size: int
    rank: int
    heads: bool
    vocab: bool
    group: Any
    ff: bool = False  # gate / up column shards, down row shards (training)
    rows: bool = False  # training: wo / down row-parallel, summed over the axis
    seq: bool = False  # sp: the residual stream splits its sequence over the axis
    ssm: bool = False  # the mamba mixers' heads split over the axis (mixer_split)


@dataclasses.dataclass(frozen=True)
class DataSplit:
    """FSDP as a forward sees it: the data axis's ``group`` and, for each
    leaf of the parameter tree, the dim whose blocks the data ranks hold
    (``None``: whole on every data rank).  :meth:`gather` makes a subtree's
    leaves whole just before their use (:func:`gather_shards`: each
    gradient comes back reduce-scattered to the rank's block)."""

    group: Any
    dims: Any

    def gather(self, tree, dims):
        """``tree``'s leaves made whole along their ``dims`` (a tree of the
        same nesting)."""
        if isinstance(tree, dict):
            return {k: self.gather(v, dims[k]) for k, v in tree.items()}
        return tree if dims is None else gather_shards(tree, self.group, dims)


def mixer_heads(cfg) -> int:
    """The mamba mixers' head count ``ssm_expand * d_model / ssm_head_dim``
    (0 for a family without mixers)."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    return cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim


def mixer_split(cfg, model: int, warn: bool = False) -> bool:
    """Whether a model axis of ``model`` ranks splits the mamba mixers by
    heads: only where it divides their head count; elsewhere the mixers
    replicate (warning :class:`ShardingFallbackWarning` with ``warn``, as
    :func:`heads_drop` does for the attention heads)."""
    H = mixer_heads(cfg)
    if not H or H % model == 0:
        return bool(H)
    if warn:
        warnings.warn(f"mamba heads ({H}) are not divisible by the model axis ({model}); "
                      f"replicating the mixers", ShardingFallbackWarning, stacklevel=3)
    return False


def heads_split(cfg, model: int) -> bool:
    """Whether a model axis of ``model`` ranks splits the heads: only where
    it divides both head counts (q and kv alike; GSPMD may split one and
    replicate the other, explicit SPMD would misread that)."""
    return cfg.num_heads % model == 0 and cfg.num_kv_heads % model == 0


def heads_drop(cfg, model: int) -> Tuple[str, ...]:
    """The logical head axes a placement replicates on purpose: both where
    :func:`heads_split` is false (warning :class:`ShardingFallbackWarning`),
    else none."""
    if heads_split(cfg, model):
        return ()
    warnings.warn(f"heads ({cfg.num_heads} q, {cfg.num_kv_heads} kv) are not divisible by the "
                  f"model axis ({model}); replicating them", ShardingFallbackWarning,
                  stacklevel=3)
    return (HEADS, KV_HEADS)


def local_heads(cfg, split: Optional[ModelSplit] = None) -> Tuple[int, int]:
    """``(Hq, Hk)`` a rank computes (the whole counts without a split)."""
    n = split.size if split is not None and split.heads else 1
    return cfg.num_heads // n, cfg.num_kv_heads // n


def training(split: Optional[ModelSplit]) -> bool:
    """Whether ``split`` is a training split (row-parallel blocks)."""
    return split is not None and split.rows


def enter_block(x: torch.Tensor, split: ModelSplit, sharded: bool) -> torch.Tensor:
    """A training block's input (the normed residual rows): under ``seq``
    the sequence gathered (its gradient reduce-scattered back where the
    block's weights split, ``sharded``, else the rank's own rows of it);
    otherwise :func:`copy_to` where the block splits, as it is elsewhere."""
    if split.seq:
        return gather_shards(x, split.group, 1) if sharded else gather_from(x, split.group, 1)
    return copy_to(x, split.group) if sharded else x


def leave_block(x: torch.Tensor, split: ModelSplit, sharded: bool) -> torch.Tensor:
    """A training block's output: a split block's partial sums summed over
    the model axis (reduce-scattered to the rank's rows under ``seq``); a
    whole block's output cut to the rank's rows under ``seq``."""
    if split.seq:
        return reduce_scatter_to(x, split.group, 1) if sharded else scatter_to(x, split.group, 1)
    return reduce_from(x, split.group) if sharded else x


def shared(w, split: Optional[ModelSplit], on_split_data: bool):
    """A replicated weight (a tensor or a norm's tree) that each model rank
    applies to data of its own (a norm under ``seq``, qk-norm on the
    rank's heads): :func:`copy_to`, so its gradient sums the ranks'
    parts."""
    if not (training(split) and on_split_data):
        return w
    if isinstance(w, dict):
        return {k: shared(v, split, on_split_data) for k, v in w.items()}
    return copy_to(w, split.group)


def gather_heads(x: torch.Tensor, split: Optional[ModelSplit], dim: int) -> torch.Tensor:
    """Every rank's heads of ``x`` along ``dim``, concatenated over the model
    axis (identity where the heads are whole)."""
    return all_gather(x, split.group, dim) if split is not None and split.heads else x


def gather_vocab(logits: torch.Tensor, split: Optional[ModelSplit]) -> torch.Tensor:
    """The whole vocab of head logits split on their last dim (a gradient
    takes each rank's own columns back)."""
    return gather_from(logits, split.group, -1) if split is not None and split.vocab else logits


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 split: Optional[ModelSplit]) -> torch.Tensor:
    """Rows of an embedding ``table`` whose vocab may split over the model
    axis: each rank looks up the tokens it holds (its other lanes read row
    0), the rows are all-gathered and each token takes its holder's,
    exactly (a gradient takes each rank's own rows back)."""
    if split is None or not split.vocab:
        return table[tokens]
    n = table.shape[0]
    rows = table[(tokens - split.rank * n).clamp(0, n - 1)]
    every = gather_from(rows[None], split.group, 0)  # (size, ..., D)
    owner = torch.div(tokens, n, rounding_mode="floor")
    idx = owner[None, ..., None].expand((1,) + tuple(rows.shape))
    return torch.gather(every, 0, idx)[0]
