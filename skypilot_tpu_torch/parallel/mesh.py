"""Device-mesh construction over the ranks of ``torch.distributed``.

Counterpart of ``skypilot_tpu/parallel/mesh.py``, with its axes,
outermost to innermost:

  ``pp``   pipeline parallel
  ``dp``   pure data parallel (gradients all-reduced; params replicated)
  ``fsdp`` fully-sharded data parallel (params/opt-state sharded on embed)
  ``ep``   expert parallel
  ``sp``   sequence/context parallel
  ``tp``   tensor parallel (heads / mlp / vocab dims sharded), innermost

:func:`make_mesh` builds a ``DeviceMesh`` of the world's ranks reshaped
``(pp, dp, fsdp, ep, sp, tp)`` exactly as the reference reshapes its
device list, so rank i sits where JAX device i sits and a tensor's
shard on rank i is the JAX array's shard on device i. One process holds
one card (``parallel/distributed.py``), so a rank is a device here.

One deliberate difference: the ``DeviceMesh`` keeps only the axes of
size above 1 (:func:`mesh_axes`; a one-rank mesh keeps ``fsdp``). A
size-1 axis splits nothing, and DTensor's sharding propagation expands
each operator's strategies over every mesh dim, so six dims where two
would do cost it minutes per operator. :func:`mesh_shape` still reads
all six sizes.

With no process group yet, :func:`make_mesh` opens a one-rank group over
a local store, so one card (or one CPU process) holds a size-1 mesh, as
the reference's ``make_mesh`` does over one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.parallel import distributed

MESH_AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def size(self) -> int:
        return (self.pp * self.dp * self.fsdp * self.ep * self.tp
                * self.sp)

    def as_dict(self) -> Dict[str, int]:
        return {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
                "ep": self.ep, "tp": self.tp, "sp": self.sp}


def _as_shape(shape, default: MeshShape) -> MeshShape:
    if shape is None:
        return default
    if isinstance(shape, dict):
        return MeshShape(**{k: v for k, v in shape.items() if k in MESH_AXES})
    return shape


def _join(device: torch.device) -> None:
    """A one-rank group over a local store when none is open yet."""
    if not dist.is_initialized():
        dist.init_process_group(distributed.backend_for(device),
                                store=dist.HashStore(), rank=0,
                                world_size=1)


def mesh_axes(shape: MeshShape) -> tuple:
    """The axes a mesh of ``shape`` keeps: those of size above 1, in
    ``MESH_AXES`` order; ``("fsdp",)`` when every axis is 1."""
    sizes = shape.as_dict()
    return tuple(a for a in MESH_AXES if sizes[a] > 1) or ("fsdp",)


def _device_mesh(device: torch.device, ranks: torch.Tensor) -> DeviceMesh:
    """``ranks`` [pp, dp, fsdp, ep, sp, tp] as a mesh of its axes above
    size 1 (:func:`mesh_axes`)."""
    shape = MeshShape(**dict(zip(MESH_AXES, ranks.shape)))
    axes = mesh_axes(shape)
    return DeviceMesh(device.type,
                      ranks.reshape([getattr(shape, a) for a in axes]),
                      mesh_dim_names=axes)


def make_mesh(shape: Optional[MeshShape | Dict[str, int]] = None,
              device: DeviceLike = None) -> DeviceMesh:
    """A 6-axis mesh over every rank. Defaults to all ranks on ``fsdp``.
    Every rank must call it (building the mesh's groups is collective)."""
    device = resolve_device(device)
    _join(device)
    n = dist.get_world_size()
    shape = _as_shape(shape, MeshShape(fsdp=n))
    if shape.size != n:
        raise ValueError(
            f"mesh shape {shape.as_dict()} needs {shape.size} devices, "
            f"got {n}")
    ranks = torch.arange(n).reshape(shape.pp, shape.dp, shape.fsdp,
                                    shape.ep, shape.sp, shape.tp)
    return _device_mesh(device, ranks)


def default_shape_for(n_devices: int, tp: int = 1, sp: int = 1,
                      dp: int = 1, ep: int = 1, pp: int = 1) -> MeshShape:
    """FSDP-dominant factorization: the remainder goes to fsdp."""
    denom = tp * sp * dp * ep * pp
    rest = n_devices // denom
    if rest * denom != n_devices:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"tp={tp} sp={sp} dp={dp} ep={ep} pp={pp}")
    return MeshShape(pp=pp, dp=dp, fsdp=rest, ep=ep, tp=tp, sp=sp)


def slice_groups(slice_ids: List[int],
                 n_slices: Optional[int] = None) -> List[List[int]]:
    """Ranks grouped by slice id (ascending), each group in rank order.
    One group and ``n_slices`` > 1 splits the ranks into that many equal
    virtual slices (for testing on one host)."""
    groups: Dict[int, List[int]] = {}
    for r, s in enumerate(slice_ids):
        groups.setdefault(s, []).append(r)
    n = len(slice_ids)
    if len(groups) == 1 and n_slices and n_slices > 1:
        per = n // n_slices
        if per * n_slices != n:
            raise ValueError(f"{n} devices not divisible "
                             f"into {n_slices} slices")
        return [list(range(i * per, (i + 1) * per))
                for i in range(n_slices)]
    return [groups[k] for k in sorted(groups)]


def multislice_ranks(slices: List[List[int]],
                     shape: Optional[MeshShape | Dict[str, int]] = None
                     ) -> torch.Tensor:
    """The ``[pp, dp, fsdp, ep, sp, tp]`` rank array of a multislice mesh:
    ``dp`` indexes the slice and every other axis ranges over that
    slice's own ranks. Validates as the reference does."""
    ns = len(slices)
    per_slice = len(slices[0])
    if any(len(s) != per_slice for s in slices):
        raise ValueError("slices are not equally sized")
    shape = _as_shape(shape, MeshShape(dp=ns, fsdp=per_slice))
    if shape.dp != ns:
        raise ValueError(
            f"multislice mesh needs dp == n_slices ({ns}), got "
            f"dp={shape.dp}")
    within = shape.pp * shape.fsdp * shape.ep * shape.sp * shape.tp
    if within != per_slice:
        raise ValueError(
            f"within-slice axes need {within} devices but each slice "
            f"has {per_slice}")
    per = [torch.tensor(s).reshape(shape.pp, shape.fsdp, shape.ep,
                                   shape.sp, shape.tp) for s in slices]
    return torch.stack(per, dim=1)


def make_multislice_mesh(shape: Optional[MeshShape | Dict[str, int]] = None,
                         n_slices: Optional[int] = None,
                         device: DeviceLike = None) -> DeviceMesh:
    """Mesh spanning multiple slices: ``dp`` indexes slices (gradient
    all-reduces cross slices), every other axis stays inside one.

    Ranks are grouped by ``MEGASCALE_SLICE_ID`` (gathered from every
    rank); with one slice, ``n_slices`` splits the ranks into equal
    virtual slices. Every rank must call it."""
    device = resolve_device(device)
    _join(device)
    mine = distributed.topology_from_env().slice_id
    ids: List[int] = [0] * dist.get_world_size()
    dist.all_gather_object(ids, mine)
    return _device_mesh(device, multislice_ranks(
        slice_groups(ids, n_slices), shape))


def mesh_shape(mesh) -> MeshShape:
    """The axis sizes of a ``DeviceMesh``, a ``MeshShape`` or a dict."""
    if isinstance(mesh, MeshShape):
        return mesh
    if isinstance(mesh, dict):
        return _as_shape(mesh, MeshShape())
    return MeshShape(**{a: mesh.size(i)
                        for i, a in enumerate(mesh.mesh_dim_names)})


def axes_of(mesh) -> tuple:
    """The mesh dims' axis names: a ``DeviceMesh``'s own, else those
    :func:`make_mesh` would keep for the shape."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return mesh_axes(mesh_shape(mesh))
