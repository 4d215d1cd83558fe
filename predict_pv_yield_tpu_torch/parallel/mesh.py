"""The (data, model) layout of the ranks of a ``torch.distributed`` world (a
port of the JAX package's ``parallel/mesh.py``).

The JAX package runs one controller per host over a ``Mesh`` of devices and
lets GSPMD derive the collectives. The port runs one process per device, as
the reference's Lightning DDP did, and writes its collectives by hand: the
data-parallel reductions in ``training/engine.py`` and the tensor-parallel
ones in ``parallel/tensor_parallel.py``. A :class:`Mesh` here is a plain
layout, two sizes and this rank's place in them; the ranks are laid out as
JAX lays out devices, row-major over ``(data, model)``, so rank
``d · model + m`` holds data coordinate ``d`` and model coordinate ``m``, and
the ranks of one model group (one replica) are contiguous.

The layout functions need no process group: without one the world is one
rank. :func:`process_groups` builds the two ``torch.distributed`` subgroups
of a mesh, a separate call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world() -> Tuple[int, int]:
    """(world size, this rank) of the initialised process group, else (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass(frozen=True)
class Mesh:
    """``data`` × ``model`` ranks and this process's ``rank`` in the world.
    Ranks at or past ``data · model`` are outside the mesh (``active``
    false): :func:`mesh_for_batch` may leave some idle."""

    data: int
    model: int
    rank: int = 0

    @property
    def shape(self):
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def active(self) -> bool:
        return self.rank < self.size

    @property
    def data_index(self) -> Optional[int]:
        """This rank's data coordinate (None outside the mesh)."""
        return self.rank // self.model if self.active else None

    @property
    def model_index(self) -> Optional[int]:
        """This rank's model coordinate (None outside the mesh)."""
        return self.rank % self.model if self.active else None

    def data_ranks(self, model_index: int):
        """The ranks that share ``model_index``: one data group."""
        return [d * self.model + model_index for d in range(self.data)]

    def model_ranks(self, data_index: int):
        """The ranks of replica ``data_index``: one model group."""
        return [data_index * self.model + m for m in range(self.model)]


def _world_size(devices) -> int:
    """A world of ``devices`` ranks: a count, a sequence of ranks, or None
    for the initialised process group's."""
    if devices is None:
        return world()[0]
    return devices if isinstance(devices, int) else len(devices)


def build_mesh(devices=None, data_parallel: Optional[int] = None, model_parallel: int = 1,
               rank: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` ranks (default: the world).

    ``data_parallel`` defaults to ``world // model_parallel``. Raises
    ``ValueError`` where the JAX package's does: a data axis under 1, or
    data × model larger than the world. One error the JAX package lacks: a
    world that ``model_parallel`` does not divide also raises. JAX would
    leave the remainder's devices idle; with one process per device those
    would be ranks that only wait on their neighbours' collectives.
    """
    n = _world_size(devices)
    if data_parallel is None:
        data_parallel = n // model_parallel
    if data_parallel < 1 or data_parallel * model_parallel > n:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} (data x model) does not fit on {n} devices")
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the world of {n} ranks")
    return Mesh(data_parallel, model_parallel, world()[1] if rank is None else rank)


def mesh_for_batch(batch_size: int, devices=None, model_parallel: int = 1, rank: Optional[int] = None) -> Mesh:
    """The largest (data, model) mesh whose data axis divides ``batch_size``;
    the ranks past it stay idle."""
    n = _world_size(devices)
    if model_parallel < 1 or model_parallel > n:
        raise ValueError(f"model_parallel={model_parallel} does not fit on {n} devices")
    data = n // model_parallel
    while data > 1 and batch_size % data != 0:
        data -= 1
    return build_mesh(n, data_parallel=data, model_parallel=model_parallel, rank=rank)


def process_groups(mesh: Mesh):
    """The ``torch.distributed`` subgroups of ``mesh`` this rank belongs to →
    ``(data group, model group)``, each None without a process group or for
    a rank outside the mesh. Every rank of the world must call this, in the
    same order: each subgroup is created collectively."""
    if not (dist.is_available() and dist.is_initialized()):
        return None, None
    data_group = model_group = None
    for m in range(mesh.model):
        group = dist.new_group(mesh.data_ranks(m))
        if mesh.model_index == m:
            data_group = group
    for d in range(mesh.data):
        group = dist.new_group(mesh.model_ranks(d))
        if mesh.data_index == d:
            model_group = group
    return data_group, model_group


def is_main_process() -> bool:
    """Rank zero of an initialised ``torch.distributed`` group, else True:
    loggers, plots, results and checkpoints write from one process only."""
    return world()[1] == 0


def barrier() -> None:
    """Wait for every rank of the world, after a write by the main process
    (a no-op without a process group)."""
    if world()[0] > 1:
        dist.barrier()
