"""Logical-axis -> mesh-axis sharding rules (MaxText-style), as DTensor
placements.

Counterpart of ``skypilot_tpu/parallel/sharding.py``. Model code names
each tensor dim by a *logical* axis ("embed", "heads", "batch", ...); a
rule table maps each logical name to a mesh axis, a tuple of mesh axes
or None (replicated). The tables are the reference's, verbatim.

:func:`spec_for` returns what the reference's ``PartitionSpec`` holds:
one entry per tensor dim, a mesh-axis name, a tuple of names or None.
:func:`placements` turns that spec into DTensor placements, one per mesh
dim (the mesh keeps only its axes of size above 1, ``parallel/mesh.py``):
a tensor dim on several mesh axes (``("dp", "fsdp")``) is ``Shard(d)`` on
each, split by the outer axis first, which is the order of JAX's
major-to-minor tuple. An axis of size 1 splits nothing, so a size-1 mesh
holds every tensor whole.

Tensors are distributed from data every rank already holds in full (the
same seed, the same batch): :func:`distribute` slices each rank's shard
locally, with no communication.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)

from skypilot_tpu_torch.parallel import mesh as mesh_lib

MeshAxis = Union[str, Tuple[str, ...], None]
Rules = Dict[str, MeshAxis]
Spec = Tuple[MeshAxis, ...]

# Default hybrid FSDP x TP rules:
#  - params' "embed" dim sharded over fsdp (ZeRO-3 style),
#  - heads / mlp / vocab dims over tp (Megatron style),
#  - activations' batch dim over (dp, fsdp) jointly.
DEFAULT_RULES: Rules = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "vocab": "tp",
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "head_dim": None,
    "layer": None,
    # MoE: the expert dim shards over ep; capacity stays local.
    "expert": "ep",
    "capacity": None,
    # Pipeline: the stage dim of stage-stacked weights shards over pp.
    "stage": "pp",
    "micro": None,
}

# Activation-side overrides: activations' "embed" stays unsharded (it is
# the contracting dim of every matmul).
ACT_RULES: Rules = dict(DEFAULT_RULES, embed=None, vocab="tp")

# Inference TP rules: Megatron-style heads/mlp/vocab over tp; no data/
# fsdp axes. The "embed" logical axis has no rule, so norms replicate.
INFER_TP_RULES: Rules = {"heads": "tp", "kv_heads": "tp",
                         "mlp": "tp", "vocab": "tp"}


def _axes(axis: MeshAxis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def _axis_size(sizes: Dict[str, int], axis: MeshAxis) -> int:
    out = 1
    for a in _axes(axis):
        out *= sizes[a]
    return out


def spec_for(logical_axes: Sequence[Optional[str]], rules: Rules,
             mesh=None, shape: Optional[Sequence[int]] = None) -> Spec:
    """Resolve logical axis names to a spec via the rule table.

    ``mesh`` is a ``DeviceMesh``, a ``MeshShape`` or a dict of axis
    sizes. When ``mesh`` and ``shape`` are given, a dim that the mapped
    mesh axis does not divide evenly is left replicated instead of
    erroring, so the same rules work for any mesh."""
    sizes = (mesh_lib.mesh_shape(mesh).as_dict() if mesh is not None
             else None)
    resolved = []
    for i, a in enumerate(logical_axes):
        axis = rules.get(a) if a is not None else None
        if (axis is not None and sizes is not None and shape is not None
                and shape[i] % _axis_size(sizes, axis) != 0):
            axis = None
        resolved.append(axis)
    return tuple(resolved)


def placements(spec: Spec, mesh) -> Tuple[Placement, ...]:
    """One placement per mesh dim (``mesh_lib.axes_of(mesh)``) for
    ``spec``."""
    sizes = mesh_lib.mesh_shape(mesh).as_dict()
    dims = mesh_lib.axes_of(mesh)
    out = [Replicate()] * len(dims)
    for d, axis in enumerate(spec):
        names = _axes(axis)
        order = [mesh_lib.MESH_AXES.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {names} are not in mesh "
                             f"order {mesh_lib.MESH_AXES}")
        for a in names:
            if sizes[a] == 1:
                continue
            i = dims.index(a)
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: Spec


def distribute(x: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """``x`` as a DTensor laid out by ``spec``. A DTensor is
    redistributed (reducing a partial sum where it holds one); a plain
    tensor must be the same whole tensor on every rank, and each rank
    keeps its own shard of it."""
    pl = placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def logical_to_sharding(logical_tree, mesh, rules: Rules = DEFAULT_RULES,
                        shapes=None):
    """Map a tree of logical-axis tuples to :class:`NamedSharding`\\ s.

    ``shapes``: optional matching tree of shapes (or objects with
    ``.shape``) enabling the divisibility guard in :func:`spec_for`."""
    if shapes is None:
        return _map(lambda axes: NamedSharding(
            mesh, spec_for(axes, rules, mesh)), logical_tree)
    return _map(lambda axes, s: NamedSharding(
        mesh, spec_for(axes, rules, mesh, getattr(s, "shape", s))),
        logical_tree, shapes)


def distribute_tree(tree, shardings):
    """Each tensor of ``tree`` laid out by its :class:`NamedSharding` in
    the matching ``shardings`` tree."""
    return _map(lambda x, s: distribute(x, s.mesh, s.spec), tree, shardings)


def shard_tree_subset(tree, logical_tree, mesh, rules: Rules):
    """Distribute every tensor in ``tree`` per its axes in
    ``logical_tree``, walking by dict key so ``tree`` may be a subset of
    the axes tree (e.g. w8a8 serving's slimmed params). Tensors without
    an axes entry are replicated."""
    if isinstance(tree, dict):
        sub = logical_tree if isinstance(logical_tree, dict) else {}
        return {k: shard_tree_subset(v, sub.get(k), mesh, rules)
                for k, v in tree.items()}
    axes = logical_tree if isinstance(logical_tree, tuple) else None
    if axes is None:
        return distribute(tree, mesh, ())
    return distribute(tree, mesh, spec_for(axes, rules, mesh, tree.shape))


def embedding(tokens: DTensor, table: DTensor) -> DTensor:
    """``F.embedding(tokens, table)`` over a table whose vocab dim may be
    split (the reference's lookup-friendly layout: vocab over tp, embed
    whole). Each rank looks the ids up in its own rows, zero for ids
    outside them, so the output is a partial sum over the vocab's mesh
    dims (its gradient comes back whole there); elsewhere it keeps the
    ids' layout. DTensor's own rule for this lookup has a backward that
    cannot take the summed gradient."""
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    table = table.redistribute(mesh, [Shard(0) if i in vocab else Replicate()
                                      for i in range(mesh.ndim)])
    tokens = tokens.redistribute(mesh, [
        Replicate() if i in vocab else p
        for i, p in enumerate(tokens.placements)])
    # Where the ids are split (the batch over dp and fsdp) and the
    # table is not, each rank's rows gather a partial sum of the
    # gradient.
    rows = table.to_local(grad_placements=[
        Shard(0) if i in vocab
        else Partial() if isinstance(p, Shard) else Replicate()
        for i, p in enumerate(tokens.placements)])
    first = 0
    for i in vocab:                      # outer mesh dims split first
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    first *= rows.shape[0]
    ids = tokens.to_local() - first
    inside = (ids >= 0) & (ids < rows.shape[0])
    out = F.embedding(ids.clamp(0, rows.shape[0] - 1), rows)
    out = out * inside[..., None].to(out.dtype)
    return DTensor.from_local(
        out, mesh, [Partial() if i in vocab else p
                    for i, p in enumerate(tokens.placements)],
        run_check=False)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (a collective: every rank of
    its mesh calls it); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def identity(x, axes):
    """The constraint of no mesh: ``x`` as it is."""
    return x


class Constrain:
    """fn(x, logical_axes) laying ``x`` out over ``mesh`` by ``rules`` (the
    reference's ``with_sharding_constraint``). The models read ``mesh``
    and ``rules`` off it where the reference passes them beside it (the
    sequence layout and the attention dispatch)."""

    def __init__(self, mesh, rules: Rules):
        self.mesh = mesh
        self.rules = rules

    def __call__(self, x, axes):
        if len(axes) != x.ndim:
            return x
        return distribute(x, self.mesh,
                          spec_for(axes, self.rules, self.mesh, x.shape))


def make_constrain(mesh, rules: Rules = ACT_RULES):
    """A :class:`Constrain` over ``mesh``; with ``mesh=None`` the identity,
    so the one-card path runs unchanged."""
    if mesh is None:
        return identity
    return Constrain(mesh, rules)


# ---------------------------------------------------------------------------
# Serving's tensor-parallel split: one process, a list of devices
# ---------------------------------------------------------------------------
# The serving engine runs one process over a tp group of devices, as the
# reference runs one process over its local chips, and holds each tree
# as one tree per shard instead of DTensors: a tensor whose logical axes
# map to "tp" is cut into equal slices along that dim, the rest copied
# whole to every shard. The programs that read them join the shards
# themselves (``infer/kvcache.py``). A device may repeat in the group.

class Shards(list):
    """A tree split over a tp group: one tree per shard, in rank order
    (:func:`split_tree`)."""


def shards_of(tree) -> list:
    """The shards of a split tree (a :class:`Shards`), or ``[tree]``."""
    return tree if isinstance(tree, Shards) else [tree]


def tp_dim(axes: Optional[Sequence[Optional[str]]],
           rules: Rules = INFER_TP_RULES) -> Optional[int]:
    """The dim that ``rules`` split over "tp", or None (replicated)."""
    dims = [d for d, a in enumerate(axes or ())
            if a is not None and "tp" in _axes(rules.get(a))]
    if len(dims) > 1:
        raise ValueError(f"axes {axes} split over tp more than once")
    return dims[0] if dims else None


def _placed(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``x`` on ``device`` in ``x``'s own memory order (an
    output-major int8 weight stays output-major)."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    inverse = [order.index(d) for d in range(x.dim())]
    y = x.permute(order).clone(memory_format=torch.contiguous_format)
    return y.to(device).permute(inverse)


def split_tensor(x: torch.Tensor, axes, devices: Sequence[torch.device],
                 rules: Rules = INFER_TP_RULES) -> list:
    """``x`` as one tensor per device: equal slices along its tp dim
    (:func:`tp_dim`), or a whole copy each. A tp dim that the group does
    not divide raises ``ValueError``, as the reference's tp <= kv_heads
    refuses: a slice of unequal heads would change the programs."""
    n = len(devices)
    d = tp_dim(axes, rules)
    if d is None:
        return [_placed(x, dev) for dev in devices]
    if x.shape[d] % n:
        raise ValueError(f"tp {n} does not divide dim {d} ({axes[d]!r}) "
                         f"of a tensor of shape {tuple(x.shape)}")
    return [_placed(p, dev) for p, dev in zip(x.chunk(n, dim=d), devices)]


def split_tree(tree, logical_tree, devices: Sequence[torch.device],
               rules: Rules = INFER_TP_RULES) -> Shards:
    """``tree`` split over ``devices`` by its axes in ``logical_tree``,
    walked by dict key as :func:`shard_tree_subset` walks it, so
    ``tree`` may be a subset of the axes tree; a tensor without an axes
    entry is copied whole to every shard."""
    n = len(devices)

    def walk(t, ax):
        if isinstance(t, dict):
            sub = ax if isinstance(ax, dict) else {}
            per_key = {k: walk(v, sub.get(k)) for k, v in t.items()}
            return [{k: parts[r] for k, parts in per_key.items()}
                    for r in range(n)]
        return split_tensor(t, ax if isinstance(ax, tuple) else None,
                            devices, rules)

    return Shards(walk(tree, logical_tree))


def gather_tree(shards, logical_tree, device: torch.device,
                rules: Rules = INFER_TP_RULES):
    """The inverse of :func:`split_tree`: one whole tree on ``device``,
    the tp slices concatenated in rank order, a replicated tensor taken
    from the first shard."""
    shards = shards_of(shards)

    def walk(ts, ax):
        if isinstance(ts[0], dict):
            sub = ax if isinstance(ax, dict) else {}
            return {k: walk([t[k] for t in ts], sub.get(k)) for k in ts[0]}
        d = tp_dim(ax if isinstance(ax, tuple) else None, rules)
        if d is None or len(ts) == 1:
            return ts[0].to(device)
        return torch.cat([t.to(device) for t in ts], dim=d)

    return walk(list(shards), logical_tree)
