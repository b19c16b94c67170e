"""Meshes of ranks for the ``"sharded"`` attention backend.

Counterpart of ``repro/launch/mesh.py``'s ``make_local_mesh`` and
``make_mesh``.  A JAX mesh names the devices of one program; here every
rank is a process of its own, so a :class:`Mesh` holds the axis names and
sizes, one ``torch.distributed`` process group per axis (the ranks that
share this rank's coordinates on the other axes) and this rank's place on
each axis.  The mesh binds no device: tensors stay where the caller put
them, and the process group the caller started decides the transport.  The
intended deployment is one card a rank with the NCCL backend::

    torchrun --nproc_per_node=<cards> train_or_serve.py
    # in the script:
    dist.init_process_group("nccl")
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    mesh = make_local_mesh()

A ``gloo`` group takes CPU tensors (the tests run four CPU ranks so) and
CUDA tensors through the host, which is how ranks that share one card run.
The JAX module's ``make_production_mesh`` (a TPU pod's 16 × 16 layout) and
``ring_roofline_us`` (its ICI link constants) have no counterpart here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch.distributed as dist

__all__ = ["Mesh", "AxisGroup", "make_local_mesh", "make_mesh"]


class AxisGroup(NamedTuple):
    """One mesh axis as a rank sees it: the process group of the ranks along
    it, this rank's index on it and its size."""
    group: object
    index: int
    size: int


class Mesh:
    """Axis names and sizes over the ranks of a process group (row-major:
    rank r sits at ``np.unravel_index(r, sizes)``, as ``jax.make_mesh``
    places devices), with the process group of each axis."""

    def __init__(self, axis_names, axis_sizes, groups: dict, coords: dict, rank: int):
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self._groups = dict(groups)
        self._coords = dict(coords)
        self.rank = rank

    @property
    def shape(self) -> dict:
        """{axis name: size}, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis_group(self, axis: str) -> AxisGroup:
        return AxisGroup(self._groups[axis], self._coords[axis], self.shape[axis])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _require_group(what: str) -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs an initialised torch.distributed process group: call "
            "torch.distributed.init_process_group(...) in every rank first (torchrun "
            "with the NCCL backend, one card a rank; gloo for CPU ranks)")
    return dist.get_world_size()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over every rank of the default
    group; the sizes must multiply to its rank count.  Every rank must call
    it, in the same order as its other collective calls (a mesh of more
    than one axis creates one process group per line of each axis)."""
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: {len(shape)} sizes for {len(axes)} axes")
    world = _require_group("make_mesh")
    if math.prod(shape) != world:
        raise RuntimeError(f"make_mesh({tuple(shape)}): {math.prod(shape)} ranks for a "
                           f"group of {world} rank(s)")
    rank = dist.get_rank()
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    if len(shape) == 1:
        return Mesh(axes, shape, {axes[0]: dist.group.WORLD}, coords, rank)
    grid = np.arange(world).reshape(shape)
    groups = {}
    for a, name in enumerate(axes):
        for line in np.moveaxis(grid, a, -1).reshape(-1, shape[a]):
            pg = dist.new_group([int(r) for r in line])   # every rank makes every group
            if rank in line:
                groups[name] = pg
    return Mesh(axes, shape, groups, coords, rank)


def make_local_mesh(n_data: int | None = None, *, axis: str = "data") -> Mesh:
    """1-D mesh over every rank of the initialised default group.
    ``n_data``, when given, must be that count: a rank outside the mesh
    would have no part in its collectives."""
    have = _require_group("make_local_mesh")
    n = n_data if n_data is not None else have
    if n != have:
        raise RuntimeError(f"make_local_mesh(n_data={n}): the group has {have} rank(s); "
                           "start it with as many ranks as the mesh spans")
    return make_mesh((n,), (axis,))
