"""Device meshes, the reference's ``launch/mesh.py`` on ``torch.distributed``.

A mesh is a ``DeviceMesh`` with named dims.  Single pod: 16x16 = 256 ranks
("data", "model").  Multi-pod: 2x16x16 = 512 ranks ("pod", "data",
"model") -- the "pod" axis is an extra data-parallel dimension.  Building
a mesh needs a process group of exactly its size: started by the caller
(``torch.distributed.init_process_group`` with its address, world size and
rank), or, for a mesh of one rank, started here on an in-process store.
``device_type`` "cuda" runs on the card over NCCL, "cpu" on gloo.

:class:`AbstractMesh` is the device-free stand-in (the twin of
``jax.sharding.AbstractMesh``): the sharding rules and the abstract cell
specs read its axis names and sizes, and nothing is placed on it.
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: read as a ``DeviceMesh`` is
    (``shape``, ``mesh_dim_names``)."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.mesh_dim_names} differ in length")


def abstract_mesh(shape, axis_names) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axis_names))


def _world(n: int, device_type: str) -> None:
    """A process group of ``n`` ranks: the caller's, or for one rank a
    group of its own on an in-process store."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r}: one of "
                         f"{sorted(BACKENDS)}")
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs torch.distributed initialised "
                f"with a world of {n} (init_process_group with its address, "
                f"world size and rank)")
        dist.init_process_group(BACKENDS[device_type], store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    _world(math.prod(shape), device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return _mesh(shape, POD_AXES if multi_pod else AXES, device_type)


def make_debug_mesh(n_data: int = 1, n_model: int = 1,
                    device_type: str = "cuda"):
    """A small ("data", "model") mesh: one rank on the card by default;
    ``device_type="cpu"`` runs it on gloo (the CPU tests' meshes)."""
    return _mesh((n_data, n_model), AXES, device_type)


def is_mesh(obj) -> bool:
    """True for a ``DeviceMesh`` (not for a device or an abstract mesh)."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(obj, DeviceMesh)
