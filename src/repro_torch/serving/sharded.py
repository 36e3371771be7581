"""Mesh placement for the serving stack: bit-exact by construction.

Counterpart of :mod:`repro.serving.sharded`.  The reference places arrays
with GSPMD; the port runs the same placement as explicit SPMD over
``torch.distributed``, one process a mesh rank, each holding plain local
tensors (the CUDA kernels see only those) and calling the collectives on
the mesh's process groups.  The placement moves data only, so a sharded
run gives the single-device run's bits:

* ``wq`` / ``wk`` / ``wv`` are column shards on ``"model"`` (heads on
  their last axis): each rank computes its heads with the whole ``d_model``
  contraction.  The KV stores shard the same heads, so the cache writes and
  the attends stay rank-local, and the heads' attend outputs are
  all-gathered (concatenated, never summed) over ``"model"`` before the
  replicated ``wo``.
* The embedding and the head split their vocab over ``"model"``: a token's
  row is looked up on the rank that holds it and taken from an all-gather
  over ``"model"``; the head's logit columns are all-gathered.
* The decode batch splits over ``"data"``: slot-major stores (the slot
  layout's stacks and rings) hold the rank's slots, and the step's logits
  are all-gathered over ``"data"``.  A paged pool has no batch axis and is
  whole on every data rank: each decode step's new K / V rows are
  all-gathered over ``"data"`` before the pool write, the write broadcast
  the reference prices.  In the paged layout the rings stay whole on every
  data rank too, so a B=1 prefill chunk runs on every data rank, as the
  reference's replicated chunk does; in the slot layout the rank holding
  the slot runs it and broadcasts its logits over ``"data"``.
* ``wo``, the MLP and the norms are replicated; ``pos`` and the page table
  are replicated and kept in step by the host.

Where an axis does not divide what it would split, that tensor
replicates, as the reference's divisibility fallback does (with
:class:`~repro_torch.distributed.sharding.ShardingFallbackWarning`).  The
heads split only where ``"model"`` divides both head counts
(:func:`repro_torch.serving.kv_cache.mesh_shard_factors`), for q and the
cache alike; the reference may split a KV store whose q it replicates,
which GSPMD reconciles and explicit SPMD would not.  Under a mesh the
layer collectives run whatever the group's size, so a world of one still
goes through them.

The dense, MoE and VLM families are served on a mesh, as the reference's
serve driver takes them.  An MoE layer's router, experts and shared expert
are replicated (no logical axis of theirs is in the serving subset) and
route dropless in the decode and chunk steps, each rank over its own slots;
an eager admission is one row, the reference's ``group_sizes(1, S) = (1,
1)``: so a sharded MoE serve is the single-device run's bits too.  A VLM
serves text through chunked admission (its 8 q / 1 kv heads replicate on a
model axis of more than one rank).

The ssm and hybrid families are served on a mesh through
``engine.make_serve_step``, as the reference serves them.  A mamba
mixer's ``in_proj`` is a column shard by heads (``z``, ``x`` and ``dt``
on the rank's heads, ``B`` and ``C`` whole: not GSPMD's contiguous cut of
the packed axis), its conv takes the rank's ``x`` channels, and its decode
state holds the rank's heads of ``h`` and channels of the conv window
(:func:`repro_torch.models.mamba2.mixer_segments` and ``state_segments``);
the gated product is all-gathered over ``"model"`` before the replicated
norm and ``out_proj``.  The state is slot-major on ``"data"`` in both
layouts (no admission path writes it: the decode steps each rank's own
slots).  Where ``"model"`` does not divide the mixers' heads they
replicate, with the warning.  The hybrid's attention layer keeps the
dense head split and its MoE layers the replicated experts.

The enc_dec family (whisper) is served on a mesh through
``engine.make_serve_step`` too.  Its encoder runs on the rank's rows of
the frames and its heads (the heads' outputs gathered before the
replicated ``wo``, the MLP replicated), and ``whisper.cross_kv`` projects
the rank's kv heads from its columns of ``xattn.wk`` / ``wv``.  The cross
memory ``(L, B, Hk, S_enc, Dh)`` is not paged: like the mamba state it is
slot-major on ``"data"`` in both layouts and split by kv heads on
``"model"`` (the reference's spec).  The decode's cross-attention attends
the rank's q heads over its cross heads and gathers them over ``"model"``
before the replicated ``xattn.wo``.  whisper-medium's vocab (51865) is odd,
so its embedding and head stay whole on a model axis of more than one
rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding as sh
from repro_torch.models import mamba2
from repro_torch.serving import kv_cache as kvc

# logical axes that may shard a weight only as the OUTPUT axis (last dim)
# of its matmul; contraction-side occurrences replicate
_OUTPUT_ONLY = (sh.HEADS, sh.KV_HEADS)
# logical axes that are safe wherever they appear (gather / output side)
_ALWAYS = (sh.VOCAB,)


def mesh_shape(rules: Optional[sh.ShardingRules]) -> Tuple[int, int]:
    """``(data, model)`` sizes of the rules' mesh (``(1, 1)`` without one)."""
    if rules is None or rules.mesh is None:
        return (1, 1)
    sizes = sh.mesh_sizes(rules.mesh)
    data = 1
    for a in rules.batch_axes:
        data *= sizes.get(a, 1)
    return data, sizes.get(rules.model_axis, 1)


def _map(fn, specs):
    if isinstance(specs, dict):
        return {k: _map(fn, v) for k, v in specs.items()}
    return fn(tuple(specs))


def serving_param_specs(specs):
    """Restrict a logical param-spec tree to the bit-exact serving subset:
    VOCAB anywhere, HEADS / KV_HEADS only on a leaf's last axis, every
    other logical axis replicated."""

    def fix(axes):
        last = len(axes) - 1
        return tuple(a if a in _ALWAYS or (a in _OUTPUT_ONLY and i == last) else None
                     for i, a in enumerate(axes))

    return _map(fix, specs)


def param_shardings(params, specs, rules: sh.ShardingRules, cfg=None):
    """The physical spec of every leaf of ``params`` under the serving
    placement (:func:`shard_params`)."""
    drop, segments = (), None
    if cfg is not None:
        from repro_torch.models import model_zoo

        m = mesh_shape(rules)[1]
        drop = sh.heads_drop(cfg, m)
        segments = model_zoo.param_segments(cfg, sh.mixer_split(cfg, m, warn=True),
                                            gathered=True)
    return sh.physical_specs(params, serving_param_specs(specs), rules, drop, segments)


def shard_params(params, specs, rules: sh.ShardingRules, cfg=None):
    """This rank's local parameter tree under the serving placement.
    ``specs`` is the model zoo's logical tree (``model_zoo.param_specs``),
    ``None`` replicates everything; with ``cfg`` the heads split only where
    ``"model"`` divides both head counts, and the mamba mixers by heads
    where it divides theirs.  Identity without a mesh."""
    if rules.mesh is None or specs is None:
        return params
    return sh.cut_tree(params, param_shardings(params, specs, rules, cfg), rules)


def _cache_drop(cfg, layout, rules) -> Tuple[Any, ...]:
    d, m = mesh_shape(rules)
    drop = []
    if not sh.heads_split(cfg, m):
        drop.append(sh.KV_HEADS)
    if layout.layout == "paged" or layout.batch % d:
        drop.append(sh.BATCH)
    return tuple(drop)


def cache_shardings(cache, cfg, layout, rules: sh.ShardingRules):
    """The spec of every leaf of a serving cache under the port's
    placement (``None`` without a mesh): pools and stacks heads-parallel
    on ``"model"``, slot-layout stores batch-parallel on ``"data"``,
    ``pos`` and the page table replicated; the mamba state by heads on
    ``"model"`` (``B`` / ``C``'s conv channels whole) and whisper's cross
    memory by kv heads, both slot-major on ``"data"`` in both layouts (the
    cross memory is not paged: the reference's spec)."""
    if rules.mesh is None:
        return None
    d, m = mesh_shape(rules)
    specs = dict(kvc.cache_specs(cfg, layout), pos=(None,))
    slot_major = ("mamba", "cross_k", "cross_v")
    stores = {k: v for k, v in cache.items() if k not in slot_major}
    out = sh.physical_specs(stores, specs, rules, _cache_drop(cfg, layout, rules))
    by_slot = (sh.BATCH,) if layout.batch % d else ()
    for name in ("cross_k", "cross_v"):
        if name in cache:
            heads = () if sh.heads_split(cfg, m) else (sh.KV_HEADS,)
            out[name] = sh.physical_specs(cache[name], specs[name], rules, by_slot + heads)
    if "mamba" in cache:
        out["mamba"] = sh.physical_specs(cache["mamba"], specs["mamba"], rules, by_slot,
                                         mamba2.state_segments(cfg, sh.mixer_split(cfg, m)))
    return out


def shard_cache(cache, cfg, layout, rules: sh.ShardingRules):
    """This rank's local cache: every leaf of a whole cache cut per
    :func:`cache_shardings` (identity without a mesh)."""
    if rules.mesh is None:
        return cache
    return sh.cut_tree(cache, cache_shardings(cache, cfg, layout, rules), rules)


def replicated(x, rules: Optional[sh.ShardingRules], device="cpu") -> torch.Tensor:
    """Host value -> a tensor on ``device``; always a copy (callers hand in
    live, host-mutated buffers like the allocator's page table).  Every
    rank holds the same value: the hosts keep it in step."""
    return torch.as_tensor(np.array(x), device=device)


def make_mesh(data: int, model: int, device: str = "cuda"):
    """A ``("data", "model")`` mesh over the running world
    (:func:`repro_torch.launch.mesh.make_debug_mesh`)."""
    from repro_torch.launch.mesh import make_debug_mesh

    return make_debug_mesh(data, model, device)


def parse_mesh_arg(arg: Optional[str]) -> Tuple[int, int]:
    """``"2,4"`` (or ``"2x4"``) -> ``(2, 4)``; ``None`` / empty -> ``(1, 1)``."""
    if not arg:
        return (1, 1)
    parts = str(arg).replace("x", ",").split(",")
    if len(parts) != 2:
        raise ValueError(f"--mesh expects DATA,MODEL (got {arg!r})")
    d, m = int(parts[0]), int(parts[1])
    if d < 1 or m < 1:
        raise ValueError(f"--mesh sizes must be >= 1 (got {arg!r})")
    return d, m


def rules_for(data: int, model: int, device: str = "cuda") -> sh.ShardingRules:
    """Serving rules over a ``(data, model)`` mesh of the running world."""
    return sh.rules_for_mesh(make_mesh(data, model, device))


# --------------------------------------------------------------------------
# one rank's view of the placement, for the engine's layers
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Shard:
    """What one rank holds of a ``(cfg, layout)`` under serving rules: its
    share of the decode batch over ``"data"`` and, in ``split``, its place
    on ``"model"`` as the model's layers take it
    (:class:`~repro_torch.distributed.sharding.ModelSplit`).  Built by
    :meth:`of`; the engine and the Scheduler take it where they take
    ``rules``."""

    batch: int  # the whole decode batch B
    data: int  # the data axis's size and this rank's index on it
    d_rank: int
    slots: bool  # the decode batch splits over "data"
    split_stores: bool  # slot-major stores hold only this rank's slots
    data_group: Any
    split: sh.ModelSplit

    @classmethod
    def of(cls, cfg, layout, rules: Optional[sh.ShardingRules]) -> Optional["Shard"]:
        """The rank's view (``None`` without a mesh: the single-device
        path)."""
        if rules is None or rules.mesh is None:
            return None
        knobs = [n for n in ("seq_shard", "sp", "fsdp_axes") if getattr(rules, n)]
        if knobs:
            raise NotImplementedError(
                f"sharded serving: {', '.join(knobs)} is not served (the placement shards "
                f"heads, vocab and slots only, and the reference's serve driver never sets "
                f"them)")
        if len([a for a in rules.batch_axes if sh.mesh_sizes(rules.mesh).get(a, 1) > 1]) > 1:
            raise NotImplementedError("sharded serving: one batch axis (data); a pod axis "
                                      "of more than one replica is not served")
        d, m = mesh_shape(rules)
        coords = sh.mesh_coords(rules.mesh)
        data_axis = next((a for a in rules.batch_axes if a in coords), rules.batch_axes[-1])
        slots = layout.batch % d == 0
        split = sh.ModelSplit(size=m, rank=coords[rules.model_axis],
                              heads=sh.heads_split(cfg, m), vocab=cfg.vocab_size % m == 0,
                              group=rules.mesh.get_group(rules.model_axis),
                              ssm=sh.mixer_split(cfg, m))
        return cls(batch=layout.batch, data=d, d_rank=coords.get(data_axis, 0), slots=slots,
                   split_stores=slots and layout.layout == "slot",
                   data_group=rules.mesh.get_group(data_axis), split=split)

    # ---- slots ----------------------------------------------------------

    @property
    def lo(self) -> int:
        """First slot of this rank's share of the decode batch."""
        return self.d_rank * (self.batch // self.data) if self.slots else 0

    @property
    def hi(self) -> int:
        return self.lo + self.batch // self.data if self.slots else self.batch

    def owner(self, slot: int) -> int:
        """The data rank whose slot-major stores hold ``slot``."""
        return slot // (self.batch // self.data) if self.split_stores else self.d_rank

    def row(self, slot: int) -> int:
        """``slot``'s row in this rank's slot-major stores; -1 where another
        data rank holds it."""
        if not self.split_stores:
            return slot
        return slot - self.lo if self.lo <= slot < self.hi else -1

    def state_row(self, slot: int) -> int:
        """``slot``'s row in this rank's mamba state and cross memory, which
        are slot-major on ``"data"`` in both layouts; -1 where another data
        rank holds it."""
        if not self.slots:
            return slot
        return slot - self.lo if self.lo <= slot < self.hi else -1

    # ---- collectives over "data" -----------------------------------------

    def gather_slots(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every data rank's slots of ``x`` along ``dim`` (identity where the
        batch replicates)."""
        return sh.all_gather(x, self.data_group, dim) if self.slots else x

    def from_owner(self, x: torch.Tensor, slot: int) -> torch.Tensor:
        """``x`` of the data rank that holds ``slot``, on every data rank
        (a broadcast over ``"data"``; identity where no rank holds it
        alone)."""
        if not self.split_stores:
            return x
        return sh.broadcast(x.contiguous(), self.data_group, self.owner(slot))


def model_split(shard: Optional[Shard]) -> Optional[sh.ModelSplit]:
    """The model-axis split a rank's layers take (``None`` off-mesh)."""
    return None if shard is None else shard.split
