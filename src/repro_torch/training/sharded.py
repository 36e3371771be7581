"""The sharded train step's placement: explicit SPMD on a ``(data, model)``
mesh.

The reference trains under GSPMD: its launcher places the state by
``model_zoo.param_specs`` and ``opt_state_specs`` through the rules
(``fsdp_axes=(D_MODEL,)`` under ``--fsdp``, ``sp`` where ``"model" > 1``)
and the model code steers the activations with ``constrain``.  The port
runs the same placement as explicit SPMD, one process a mesh rank holding
plain local tensors:

* ``"model"`` (Megatron): ``wq`` / ``wk`` / ``wv`` and the MLP's ``gate``
  / ``up`` are column shards, ``wo`` and ``down`` row shards whose partial
  products are summed over the axis; the embedding and the head split
  their vocab, the head's logits gathered before the loss.  The heads
  split only where ``"model"`` divides both head counts (as in serving),
  the FF and the vocab where it divides them; anything else replicates,
  with :class:`~repro_torch.distributed.sharding.ShardingFallbackWarning`.
* ``sp``: the residual stream holds ``S / model`` rows a rank (gathered
  entering each block, reduce-scattered leaving it).
* ``"data"``: each rank takes its rows of the global batch; the loss is
  the global mean over every label token of the mesh.  Under FSDP the
  ``d_model`` dim of every leaf splits over ``"data"`` too: the forward
  gathers a layer's weights inside the layer, and their gradients come
  back reduce-scattered; every other leaf's gradient is summed over
  ``"data"`` after the backward (:meth:`TrainShard.sync_grads`).
* The moments follow the parameters (``opt_state_specs``): ZeRO falls out
  of the FSDP rules, as in the reference.

The dense, MoE and VLM families train on a mesh.  An MoE layer's experts
split their FF over ``"model"`` (``gate`` / ``up`` ``(E, d, f)`` column
shards, ``down`` ``(E, f, d)`` row shards, the shared expert as the dense
MLP; the router replicated), and under FSDP their ``d_model`` over
``"data"`` too, so an expert leaf ``(L, E, d, f)`` splits on two dims at
once.  Its dispatch is the reference's group-local one: the rank's rows of
the global batch are its token group (``ShardingRules.group_sizes``'
contiguous block where ``"data"`` divides the batch; a batch it does not
divide is refused), and the auxiliary loss is the global one over
``"data"``.  A VLM's ``Tv + S`` stream is what ``sp`` splits.

The ssm and hybrid families train on a mesh too.  A mamba mixer splits by
heads where ``"model"`` divides its head count
(:func:`~repro_torch.distributed.sharding.mixer_split`; elsewhere it
replicates, with the warning): ``in_proj``'s ``z``, ``x`` and ``dt``
columns, the conv's ``x`` channels, the gated norm's scale and
``out_proj``'s rows on the rank's heads, ``B`` / ``C``'s columns and
channels, ``A_log``, ``D`` and ``dt_bias`` whole
(:func:`repro_torch.models.mamba2.mixer_segments`, a placement that differs
from GSPMD's contiguous cut of the packed axis); the gated norm's squares
are summed over ``"model"`` and ``out_proj`` is row-parallel.  Under ``sp``
the mixer gathers the sequence (its scan needs all of it).  The hybrid's
attention layer takes the dense split, its MoE layers the MoE's.

The enc_dec family (whisper) trains on a mesh too: both stacks take the
dense split (heads, the GELU MLP's FF with ``up_b`` cut with ``up`` and
``down_b`` added after the sum), the decoder's cross-attention on the
rank's heads, whose partial gradient of the encoder memory is summed over
``"model"``.  ``sp`` splits the decoder's residual and never the
encoder's (the reference constrains it ``(batch, None, None)``); each data
rank encodes its own rows of ``frames``.  Under FSDP each stack's layers
are gathered inside the layer.  whisper-medium's vocab (51865) is odd, so
its tied embedding and head stay whole on a model axis of more than one
rank.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Optional

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.utils.tree import tree_items, tree_map

Tree = Any


def _axes(entry):
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def train_specs(cfg, rules: sh.ShardingRules, logical: Optional[Tree] = None):
    """``(shapes, specs, drop)``: the whole parameters on the meta device,
    their physical specs under ``rules`` (``logical``: the model's logical
    tree, ``model_zoo.param_specs`` when None; the mamba mixers placed by
    :func:`_segments`) and the logical axes replicated on purpose: the
    heads, where ``"model"`` does not divide both head counts (warning
    :class:`~repro_torch.distributed.sharding.ShardingFallbackWarning`).
    Needs only the mesh's shape."""
    from repro_torch.models import model_zoo

    m = sh.mesh_sizes(rules.mesh).get(rules.model_axis, 1)
    logical = model_zoo.param_specs(cfg) if logical is None else logical
    shapes = model_zoo.init(cfg, None, "meta")
    drop = sh.heads_drop(cfg, m)
    return shapes, sh.physical_specs(shapes, logical, rules, drop, _segments(cfg, m)), drop


def _segments(cfg, m: int, warn: bool = True) -> Optional[Tree]:
    """The mixers' placement over a model axis of ``m``
    (``model_zoo.param_segments``): split by heads where ``m`` divides
    them, else whole (warning, with ``warn``)."""
    from repro_torch.models import model_zoo

    return model_zoo.param_segments(cfg, sh.mixer_split(cfg, m, warn=warn))


def _ff_split(layer_specs, rules: sh.ShardingRules) -> bool:
    """Whether ``"model"`` splits a layer tree's FF: the MLP's, or an MoE's
    experts' (whose shared expert must split alike)."""
    on = lambda spec: rules.model_axis in _axes(spec[-1])
    if "moe" not in layer_specs:
        return on(layer_specs["mlp"]["up"])
    ff = on(layer_specs["moe"]["up"])
    if "shared" in layer_specs["moe"] and on(layer_specs["moe"]["shared"]["up"]) != ff:
        raise NotImplementedError("sharded training: the model axis splits the experts' FF "
                                  "and the shared expert's differently")
    return ff


def _model_ff_split(specs, rules: sh.ShardingRules) -> bool:
    """:func:`_ff_split` over every layer tree with an FFN: the stacked
    ``layers``, each of the hybrid's ``blocks/pos{j}`` or whisper's
    ``encoder`` and ``decoder`` (which must agree); False for a model
    without one (mamba2)."""
    trees = ([specs["layers"]] if "layers" in specs else
             list(specs.get("blocks", {}).values())
             + [specs[k] for k in ("encoder", "decoder") if k in specs])
    found = {_ff_split(t, rules) for t in trees if "mlp" in t or "moe" in t}
    if len(found) > 1:
        raise NotImplementedError("sharded training: the model axis splits one layer's FF "
                                  "and not another's")
    return found.pop() if found else False


def _moment_segments(segments: Optional[Tree], int8: bool) -> Optional[Tree]:
    """The optimizer state's segments: the parameters' on each moment
    (an int8 moment's codes; its row scales are whole)."""
    if segments is None:
        return None
    rec = lambda t: ({k: rec(v) for k, v in t.items()} if isinstance(t, dict)
                     else ({"q": t} if int8 else t))
    return {"m": rec(segments), "v": rec(segments)}


@dataclasses.dataclass(frozen=True)
class TrainShard:
    """What one rank holds of a ``(cfg, rules)`` training placement: the
    parameters' physical ``specs`` (their whole ``shapes`` on the meta
    device), its place on ``"model"`` (``split``), FSDP's gather dims
    (``fsdp``, None without it), its share of the batch over ``"data"``,
    for each parameter leaf the process groups of each dim (``groups``:
    the optimizer's reductions) and the mamba mixers' placement
    (``segments``).  Built by :meth:`of`."""

    rules: sh.ShardingRules
    logical: Tree
    shapes: Tree  # the whole parameters on the meta device
    specs: Tree
    drop: tuple
    split: sh.ModelSplit
    fsdp: Optional[sh.DataSplit]
    data: int
    d_rank: int
    data_group: Any
    groups: Tree
    segments: Optional[Tree] = None  # the mixers' placement (physical_specs' segments)

    @classmethod
    def of(cls, cfg, rules: Optional[sh.ShardingRules],
           param_specs: Optional[Tree] = None) -> Optional["TrainShard"]:
        """The rank's placement (``None`` without a mesh: one device)."""
        if rules is None or rules.mesh is None:
            return None
        if rules.seq_shard:
            raise NotImplementedError("sharded training: seq_shard is the long-context "
                                      "decode knob, not a training rule; no family trains "
                                      "with it")
        from repro_torch.models import model_zoo

        mesh, sizes = rules.mesh, sh.mesh_sizes(rules.mesh)
        batch = [a for a in rules.batch_axes if a in sizes]
        if len([a for a in batch if sizes[a] > 1]) > 1:
            raise NotImplementedError("sharded training: one batch axis (data); a pod axis "
                                      "of more than one replica is not placed")
        data_axis = next((a for a in batch if sizes[a] > 1), batch[-1] if batch else None)
        if data_axis is None:
            raise ValueError(f"sharded training: the mesh {sizes} has no batch axis "
                             f"{rules.batch_axes}")
        m = sizes.get(rules.model_axis, 1)
        coords = sh.mesh_coords(mesh)
        logical = model_zoo.param_specs(cfg) if param_specs is None else param_specs
        shapes, specs, drop = train_specs(cfg, rules, logical)
        split = sh.ModelSplit(
            size=m, rank=coords[rules.model_axis], heads=not drop,
            vocab=rules.model_axis in _axes(specs["embed"][0]),
            group=mesh.get_group(rules.model_axis), ff=_model_ff_split(specs, rules),
            rows=True, seq=rules.sp, ssm=sh.mixer_split(cfg, m))
        data_group = mesh.get_group(data_axis)
        dims = tree_map(lambda spec: next((i for i, e in enumerate(spec)
                                           if data_axis in _axes(e)), None), specs)
        fsdp = sh.DataSplit(data_group, dims) if any(
            d is not None for _, d in tree_items(dims)) else None

        def dim_groups(e):  # a segmented dim's groups carry its parts (the global norm)
            gs = tuple(mesh.get_group(a) for a in _axes(e))
            return sh.PartGroups(gs, e.parts) if isinstance(e, sh.Segments) else gs

        groups = tree_map(lambda spec: tuple(dim_groups(e) for e in spec), specs)
        return cls(rules=rules, logical=logical, shapes=shapes, specs=specs, drop=drop,
                   split=split, fsdp=fsdp, data=sizes[data_axis], d_rank=coords[data_axis],
                   data_group=data_group, groups=groups,
                   segments=_segments(cfg, m, warn=False))

    # ---- placement ------------------------------------------------------

    def shard_params(self, params: Tree) -> Tree:
        """This rank's blocks of a whole parameter tree (copies)."""
        return sh.cut_tree(params, self.specs, self.rules)

    def opt_specs(self, opt_cfg) -> Tree:
        """The physical specs of the optimizer state
        (:func:`repro_torch.optim.opt_state_specs` at its shapes)."""
        from repro_torch.optim import adamw_init, opt_state_specs

        return sh.physical_specs(adamw_init(self.shapes, opt_cfg),
                                 opt_state_specs(self.logical, opt_cfg), self.rules, self.drop,
                                 _moment_segments(self.segments, opt_cfg.state_dtype == "int8"))

    def placement(self, opt_cfg) -> sh.Placement:
        """The train state's ``{"params", "opt"}`` placement
        (``Checkpointer``'s ``shardings``)."""
        return sh.Placement({"params": self.specs, "opt": self.opt_specs(opt_cfg)},
                            self.rules)

    def local_rows(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This data rank's rows of a global batch (views; every input of
        it, a VLM's ``vision`` beside the tokens and labels).  The data axis
        must divide the batch: otherwise rows would be lost, and the
        reference's MoE token groups (``gcd(B, data)`` of them) would cross
        ranks."""
        B = batch["tokens"].shape[0]
        if B % self.data:
            raise ValueError(f"sharded training: the data axis ({self.data} ranks) does not "
                             f"divide the batch ({B} rows); the MoE's group-local dispatch "
                             f"would put gcd(B, data) = {math.gcd(B, self.data)} token groups "
                             f"across the ranks, and no rank may hold part of a group")
        b = B // self.data
        return {k: v[self.d_rank * b:(self.d_rank + 1) * b] for k, v in batch.items()}

    def forward_kwargs(self, seq_len: int) -> Dict[str, Any]:
        """The forward's ``split``, ``fsdp`` and ``data`` (the data axis's
        group: an MoE layer's aux sums) for a residual stream of ``seq_len``
        rows a sequence (a VLM's ``Tv + S``): ``sp`` replicates the stream
        (warning
        :class:`~repro_torch.distributed.sharding.ShardingFallbackWarning`)
        where ``"model"`` does not divide it, as ``constrain`` does."""
        split = self.split
        if split.seq and seq_len % split.size:
            warnings.warn(f"logical axis 'seq' (dim {seq_len}) is not divisible by the model "
                          f"axis ({split.size}); replicating instead",
                          sh.ShardingFallbackWarning, stacklevel=2)
            split = dataclasses.replace(split, seq=False)
        return dict(split=split, fsdp=self.fsdp, data=self.data_group)

    # ---- gradients ------------------------------------------------------

    def sync_grads(self, grads: Tree) -> Tree:
        """Sum over ``"data"``, in place and in f32 (:func:`sh.all_reduce_sum_`),
        every gradient the backward has not already summed: those of the
        leaves FSDP does not split (an FSDP leaf's comes back
        reduce-scattered)."""
        def one(g, d):
            if d is None:
                sh.all_reduce_sum_(g, self.data_group)
            return g

        dims = self.fsdp.dims if self.fsdp is not None else tree_map(lambda _: None, grads)
        return tree_map(one, grads, dims)

    def gather_whole(self, tree: Tree, specs: Optional[Tree] = None) -> Tree:
        """Every leaf of this rank's ``tree`` made whole (every rank of the
        mesh takes part; the parameters' specs unless ``specs`` is given)."""
        specs = self.specs if specs is None else specs
        return tree_map(lambda x, s: sh.gather_whole(x, s, self.rules), tree, specs)
