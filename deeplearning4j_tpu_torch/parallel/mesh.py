"""The device mesh of the port: named axes over the ranks of a
`torch.distributed` process group (the port of
`deeplearning4j_tpu/parallel/mesh.py`).

JAX runs SPMD over the devices of one process and names them with a
`jax.sharding.Mesh`. The port runs one rank per device, so a mesh here is
the ranks of a process group, reshaped into named axes, and the device of
this rank. The axes are JAX's:

  * "data"  — data parallelism (batch rows; gradient all-reduce /
    reduce-scatter)
  * "model" — tensor parallelism
  * "pipe"  — pipeline stages
  * "seq"   — sequence parallelism

Each axis has its process groups: `mesh.axis_group(axis)` is the group
of the ranks that share this rank's coordinates on every other axis (the
data group of a (data, model) mesh reduces gradients, its model group
carries the tensor-parallel all-reduces, the pipe group the pipeline's
point-to-point handoffs). They are made when a mesh of more than one axis
is made, every group of every axis in the same order, and kept for the
life of the default process group: `make_mesh` of such a mesh is a
collective call of every rank of the world (members or not), as making a
`torch.distributed` group is.

With no process group initialized, `make_mesh` is a world of one rank on
the caller's device: every collective of the trainer is then skipped by
`torch.distributed` itself being absent, never emulated.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..util.platform import DeviceLike, resolve_device

__all__ = ["Mesh", "MeshAxes", "make_mesh", "make_hybrid_mesh",
           "replicated", "data_sharding", "surviving_mesh_shape"]


class MeshAxes:
    DATA = "data"
    MODEL = "model"
    PIPE = "pipe"
    SEQ = "seq"


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


class Mesh:
    """Named axes over the ranks of `group` (None: the default world, or a
    world of one rank when no process group is initialized). `device` is
    this rank's device. `devices` is the array of global ranks in axis
    order, as JAX's `mesh.devices` is the array of devices."""

    def __init__(self, axes: Dict[str, int], ranks: Sequence[int],
                 device: torch.device, group=None):
        self.shape = {k: int(v) for k, v in axes.items()}
        self.axis_names = tuple(self.shape)
        self.devices = np.asarray(list(ranks), dtype=np.int64).reshape(
            tuple(self.shape.values()) or (1,))
        self.ranks = tuple(int(r) for r in ranks)
        self.device = device
        self.group = group

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def distributed(self) -> bool:
        """Whether the mesh's collectives go through torch.distributed."""
        return _dist() is not None

    @property
    def rank(self) -> int:
        """This process's index among the mesh's ranks."""
        dist = _dist()
        if dist is None:
            return 0
        return self.ranks.index(dist.get_rank())

    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis."""
        idx = np.unravel_index(self.rank, self.devices.shape)
        return {k: int(i) for k, i in zip(self.axis_names, idx)}

    def axis_ranks(self, axis: str) -> tuple:
        """The global ranks along `axis` through this rank, in axis
        order."""
        if axis not in self.shape:
            return (self.ranks[self.rank] if self.distributed else 0,)
        idx = list(np.unravel_index(self.rank, self.devices.shape))
        pos = self.axis_names.index(axis)
        idx[pos] = slice(None)
        return tuple(int(r) for r in self.devices[tuple(idx)].reshape(-1))

    def axis_index(self, axis: str) -> int:
        return int(self.coords().get(axis, 0))

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def axis_group(self, axis: str):
        """The process group along `axis` through this rank (None with no
        process group; the mesh's own group when the axis spans it)."""
        if not self.distributed:
            return None
        ranks = self.axis_ranks(axis)
        if len(ranks) == self.size:
            return self.group
        return _subgroup(ranks)

    @property
    def backend(self) -> str:
        dist = _dist()
        return "none" if dist is None else str(dist.get_backend(self.group))

    def __repr__(self):
        return (f"Mesh({self.shape}, ranks={self.ranks}, "
                f"device={self.device}, backend={self.backend})")


_GROUPS: Dict[tuple, object] = {}


def _subgroup(ranks: tuple):
    """The process group of `ranks` (global ranks), made once for the
    default process group's life (every rank of the world takes part in
    making it: `_make_axis_groups`)."""
    dist = _dist()
    key = (id(dist.distributed_c10d._get_default_group()), tuple(ranks))
    g = _GROUPS.get(key)
    if g is None:
        g = dist.new_group(list(ranks))
        _GROUPS[key] = g
    return g


def _make_axis_groups(mesh: "Mesh"):
    """Every group of every axis of the mesh, axis by axis, lines in
    order: the same sequence of group-making calls on every rank."""
    arr = mesh.devices
    for pos in range(arr.ndim):
        if arr.shape[pos] == arr.size:
            continue
        lines = np.moveaxis(arr, pos, -1).reshape(-1, arr.shape[pos])
        for line in lines:
            _subgroup(tuple(int(r) for r in line))


def forget_groups():
    """Drop the cached axis groups (the elastic trainer re-forms the
    world)."""
    _GROUPS.clear()


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None, *, group=None,
              device: DeviceLike = None) -> Mesh:
    """A mesh from {axis_name: size} over the ranks of `group` (or the
    ranks listed in `devices`, which `group` must hold; default: every rank
    of the world). Sizes must multiply to the rank count; a single
    {"data": -1} (or None) means every rank on the data axis. `device` is
    this rank's device: the GPU unless the caller asks for the CPU (each
    rank takes the card of its local rank)."""
    dist = _dist()
    if dist is None:
        ranks = [0] if devices is None else list(devices)
        if len(ranks) != 1:
            raise ValueError(
                f"a mesh over ranks {ranks} needs an initialized process "
                "group (parallel.initialize / torch.distributed)")
    elif devices is not None:
        ranks = [int(r) for r in devices]
        if group is None and len(ranks) < dist.get_world_size():
            # a mesh over some of the world's ranks: its own group
            group = _subgroup(tuple(ranks))
    elif group is not None:
        ranks = list(dist.get_process_group_ranks(group))
    else:
        ranks = list(range(dist.get_world_size()))
    n = len(ranks)
    if not axes:
        axes = {MeshAxes.DATA: n}
    axes = dict(axes)
    wild = [k for k, v in axes.items() if v in (-1, None)]
    if len(wild) > 1:
        raise ValueError("At most one axis size may be -1")
    fixed = int(np.prod([v for v in axes.values() if v not in (-1, None)]))
    if wild:
        if n % fixed:
            raise ValueError(f"{n} ranks not divisible by {fixed}")
        axes[wild[0]] = n // fixed
    total = int(np.prod(list(axes.values())))
    if total != n:
        raise ValueError(f"Mesh {axes} needs {total} ranks, have {n}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        import os
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % max(1, torch.cuda.device_count()))
    mesh = Mesh(axes, ranks, dev, group=group)
    if dist is not None and len(axes) > 1:
        _make_axis_groups(mesh)
    return mesh


def surviving_mesh_shape(n_devices: int, want: Sequence[int]) -> tuple:
    """Deterministic re-factorization of a (d, m[, p]) mesh shape onto
    `n_devices` surviving ranks (JAX's rule, unchanged): keep the MODEL
    axis, then the PIPE depth, and give the remainder to DATA; each kept
    axis must divide both the survivor count and its original size.

      surviving_mesh_shape(8, (2, 2, 2)) == (2, 2, 2)
      surviving_mesh_shape(4, (2, 2, 2)) == (1, 2, 2)
      surviving_mesh_shape(3, (2, 2, 2)) == (3, 1, 1)
    """
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"need at least one surviving device, got {n}")
    want = tuple(int(v) for v in want)
    if len(want) == 2:
        d0, m0, p0 = want[0], want[1], 1
    elif len(want) == 3:
        d0, m0, p0 = want
    else:
        raise ValueError(
            f"want must be (d, m) or (d, m, p), got {want!r}")
    m = next(k for k in range(min(m0, n), 0, -1)
             if m0 % k == 0 and n % k == 0)
    rem = n // m
    p = next(k for k in range(min(p0, rem), 0, -1)
             if p0 % k == 0 and rem % k == 0)
    d = rem // p
    return (d, m) if len(want) == 2 else (d, m, p)


def make_hybrid_mesh(ici_axes: Dict[str, int], dcn_axes: Dict[str, int],
                     *, group=None, device: DeviceLike = None) -> Mesh:
    """Multi-host mesh: `dcn_axes` outermost (across hosts), `ici_axes`
    inside a host. With one rank per device and ranks numbered host-major
    (torchrun's order) this is the plain mesh with the axes in that
    order."""
    axes = dict(dcn_axes)
    axes.update(ici_axes)
    return make_mesh(axes, group=group, device=device)


def replicated(mesh: Mesh, tensor: torch.Tensor, src: int = 0
               ) -> torch.Tensor:
    """`tensor` placed on the mesh replicated: on this rank's device, with
    rank `src`'s value on every rank (a broadcast over the mesh's group)."""
    t = tensor.to(mesh.device)
    dist = _dist()
    if dist is not None and mesh.size > 1:
        t = t.contiguous()
        from .collectives import broadcast_
        broadcast_(t, mesh.ranks[src], mesh.group)
    return t


def data_sharding(mesh: Mesh, array, axis: str = MeshAxes.DATA):
    """This rank's rows of a batch sharded over `axis` (contiguous equal
    slices in rank order, as JAX's P(axis) lays rows over devices)."""
    n = mesh.shape[axis]
    i = mesh.coords()[axis]
    rows = int(np.shape(array)[0])
    if rows % n:
        raise ValueError(f"{rows} rows do not split over {n} ranks")
    per = rows // n
    return array[i * per:(i + 1) * per]
