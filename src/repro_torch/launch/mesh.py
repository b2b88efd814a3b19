"""Device meshes — the reference's ``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of a process group, one process a device.  Functions, not module-level
constants, so importing this module touches no process group.

  * ``make_production_mesh``: the reference's production meshes, (16, 16)
    ``("data", "model")`` or (2, 16, 16) ``("pod", "data", "model")``,
    over the first 256 or all 512 ranks of a dry-run world: one process
    standing in for 512 ranks on torch's ``fake`` backend, whose
    collectives move nothing (the counterpart of the reference's
    ``--xla_force_host_platform_device_count=512``).  Only the dry run
    (``repro_torch.launch.dryrun``) builds it.
  * ``make_host_mesh``: a small mesh over the real world's ranks (the
    trainer, the examples, the tests).  With no process group it starts
    a world of one: gloo on the CPU, NCCL on the card, rendezvous
    through an in-process ``HashStore``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve_device

# The roofline's constants: NVIDIA's data sheet for one H100 SXM (dense
# rates, at the 700 W power limit) — data-sheet figures, not measurements
PEAK_FLOPS_BF16 = 989e12       # bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12               # HBM3 bytes/s per card
NVLINK_BW = 450e9              # NVLink 4 bytes/s per card, each direction

DRY_RUN_WORLD = 512


def init_dry_run_world(world_size: int = DRY_RUN_WORLD) -> None:
    """Make this process rank 0 of a ``world_size``-rank world on the
    ``fake`` backend (no other process, no traffic), unless it already
    is one.  A process that belongs to a real world cannot also hold a
    dry-run world: run the dry run in a process of its own."""
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() >= world_size):
            return
        raise RuntimeError(
            "a process group is already initialised in this process; the "
            "dry run's fake world needs a process of its own")
    # torch's own stand-in store for the fake backend (a private module)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_dry_run_world()
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def factor_axis(mesh: DeviceMesh, axis: str, sizes) -> DeviceMesh:
    """``mesh`` over the same ranks with the mesh axis ``axis`` cut into
    factors of ``sizes`` (major first), mesh dims named ``axis.0``,
    ``axis.1``, ..: the sub-axes GSPMD makes of an axis to keep a dim
    split through a view (``sharding.split_factors``).  Specs still name
    ``axis``; ``sharding.FACTORED`` maps it to its factors' dims, and a
    spec that names it is placed on all of them
    (``sharding.mesh_axes``)."""
    names = list(mesh.mesh_dim_names)
    i = names.index(axis)
    if math.prod(sizes) != mesh.size(i):
        raise ValueError(f"{sizes} do not multiply to the {mesh.size(i)} "
                         f"ranks of {axis!r}")
    shape = tuple(mesh.shape[:i]) + tuple(sizes) + tuple(mesh.shape[i + 1:])
    dims = names[:i] + [f"{axis}.{k}" for k in range(len(sizes))] \
        + names[i + 1:]
    out = DeviceMesh(mesh.device_type, mesh.mesh.reshape(shape),
                     mesh_dim_names=tuple(dims))
    from repro_torch.parallel.sharding import FACTORED
    FACTORED[out] = {
        a: (tuple(range(i, i + len(sizes))) if a == axis
            else (j + (len(sizes) - 1 if j > i else 0),))
        for j, a in enumerate(names)}
    return out


def _init_world_of_one(device: torch.device) -> None:
    """A process group of this process alone: NCCL on the card, gloo on
    the CPU."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kw)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> DeviceMesh:
    """Small mesh over the real world's ranks (examples / tests): the
    first ``data * model`` ranks, the axes clamped to the world size as
    the reference clamps them to its devices.  ``device``: the card (the
    default) or ``"cpu"``; with no process group, a world of one on it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        _init_world_of_one(dev)
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    return DeviceMesh(dev.type, torch.arange(data * model).reshape(
        data, model), mesh_dim_names=("data", "model"))


def n_chips(mesh) -> int:
    return int(mesh.size())
