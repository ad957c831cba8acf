"""Meshes of torch.distributed ranks (counterpart of ``repro/launch/mesh.py``).

The reference lays its devices out as a ("data", "model") grid
(``jax.make_mesh``); here each device is one process, a rank of a
``torch.distributed`` process group, and rank r sits at grid coordinates
(r // model, r % model), the row-major order in which ``jax.make_mesh``
places its devices. A ``Mesh`` carries the axis sizes, this rank's
coordinates and one process group per axis of more than one rank (the
ranks that differ only along that axis); ``runtime/collectives.py`` gathers
over those groups. A mesh without a process group is the one-rank (1, 1)
mesh: every axis has size 1 and no collective is ever issued.

The backend is the caller's choice, made once when the group is made
(``init_distributed``): NCCL for cards, one rank a card; gloo for the CPU,
and for ranks that share one card. Nothing here switches backend on a
failure.

``make_production_mesh`` is not ported: the dry run's ``MeshModel``
(``runtime/perfmodel.py``) does the arithmetic of the production meshes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("data", "model") grid of ranks, seen from one rank.

    sizes     ranks along each axis of ``axis_names``.
    coords    this rank's index along each axis.
    groups    the process group of each axis (the ranks sharing this rank's
              other coordinates); None where the axis has one rank.
    backend   the process group's backend ("nccl" or "gloo"), None without
              a process group.
    """

    sizes: Tuple[int, ...] = (1, 1)
    coords: Tuple[int, ...] = (0, 0)
    groups: Tuple = (None, None)
    backend: Optional[str] = None
    axis_names: Tuple[str, ...] = AXES

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[self.axis_names.index(axis)]


def init_distributed(backend: str, *, store_path: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> None:
    """Join the default process group on ``backend`` ("nccl" or "gloo").

    Under ``torchrun`` the rank, world size and rendezvous come from its
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). Otherwise
    ``store_path`` names a file that every rank opens as a
    ``torch.distributed.FileStore`` (tests and ranks spawned by one
    process), with ``rank`` and ``world_size`` given."""
    if dist.is_initialized():
        raise RuntimeError("the default process group already exists")
    if store_path is None:
        if "RANK" not in os.environ:
            raise ValueError("no torchrun environment (RANK, WORLD_SIZE): pass "
                             "store_path, rank and world_size")
        dist.init_process_group(backend, init_method="env://")
        return
    if rank is None or world_size is None:
        raise ValueError("a FileStore group needs rank and world_size")
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def local_device() -> torch.device:
    """This rank's card under ``torchrun`` (LOCAL_RANK), else cuda:0."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def make_local_mesh(model: int = 1) -> Mesh:
    """The (world // model, model) mesh over the default process group's
    ranks, as the reference's ``make_local_mesh`` lays out its devices
    (``model`` capped at the world size); the one-rank (1, 1) mesh without
    a process group. Every rank must call it, in the same order: it makes
    the axes' process groups."""
    if not dist.is_initialized():
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    model = max(1, min(int(model), world))
    if world % model:
        raise ValueError(f"{world} ranks do not form a grid with a 'model' axis "
                         f"of {model}")
    data = world // model
    groups = [None, None]
    # every rank makes every group (torch.distributed's rule), keeping its own
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                groups[1] = g
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                groups[0] = g
    return Mesh(sizes=(data, model), coords=(rank // model, rank % model),
                groups=tuple(groups), backend=dist.get_backend())
