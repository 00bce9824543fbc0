"""Mesh builders (port of ``repro.launch.mesh``).

The production meshes are the reference's shapes and axis names, kept so
that every dry-run cell compares with the reference's: (16, 16)
``("data", "model")`` and (2, 16, 16) ``("pod", "data", "model")``. An
H100 cluster's own layout, for example eight cards per NVLink domain, is
reached through the dry-run's ``--mesh 32x8``, as in the reference.

FUNCTIONS, not module constants: importing this module touches no device
and no process group. ``make_production_mesh`` needs a process group of
``prod(shape)`` ranks (the dry-run starts a fake one of 256 or 512 ranks
in one process); ``make_host_mesh`` starts a one-rank group where none is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of a production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device=None):
    """A (1, N) ``("data", "model")`` mesh over the N ranks of the
    initialised process group, on the card unless ``device="cpu"``. Where
    no group is initialised, a one-rank group is started (``nccl`` on the
    card, ``gloo`` on the CPU)."""
    from .._device import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))


def axis_names(mesh) -> tuple[str, ...]:
    """A ``DeviceMesh``'s dim names, or a duck-typed mesh's
    ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}: a ``DeviceMesh``'s, or a duck-typed mesh's
    ``shape`` dict (the reference's ``mesh.shape``)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    """The batch (data-parallel) axes of a production mesh."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
