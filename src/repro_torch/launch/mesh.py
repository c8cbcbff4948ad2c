"""Mesh construction — the port of ``repro/launch/mesh.py`` on
``torch.distributed``.

A mesh is a ``DeviceMesh`` over the initialised process group, one rank a
device, with the reference's axis names.  Single pod: (data=16,
model=16) = 256 ranks; multi-pod: (pod=2, data=16, model=16) = 512 ranks.
A mesh needs as many ranks as it has places: these functions raise
otherwise (the reference's ``jax.make_mesh`` raises where the devices are
too few).

The process group comes from ``init_distributed``: NCCL for CUDA, gloo
for the CPU, with an explicit timeout, from ``torchrun``'s environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``) or from a ``FileStore`` the caller names (tests: a file
in a temporary directory, no port at all).

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --data-axis 2 --model-axis 2 --device cpu --steps 3
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import axis_sizes

DEFAULT_TIMEOUT_S = 60.0


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device="cuda", *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     store_path: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     backend: Optional[str] = None) -> torch.device:
    """Start the process group for ``device``'s type and return the device
    this rank runs on (CUDA: ``cuda:LOCAL_RANK``, or the rank modulo the
    device count).  With ``store_path`` the ranks meet in a ``FileStore``
    there (``rank`` and ``world_size`` given); without it, in
    ``torchrun``'s environment.  ``backend`` overrides the device's
    (gloo carries CUDA tensors too, where NCCL refuses two ranks on one
    card)."""
    dev = torch.device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    backend = backend or backend_for(dev)
    if store_path is not None:
        if rank is None or world_size is None:
            raise ValueError("a FileStore needs rank and world_size")
        store = dist.FileStore(str(store_path), int(world_size))
        dist.init_process_group(backend, store=store, rank=int(rank),
                                world_size=int(world_size), timeout=timeout)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no process group to join: {', '.join(missing)} unset "
                f"(launch under torchrun --nproc-per-node N, or pass "
                f"store_path, rank and world_size)")
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def collective_device() -> torch.device:
    """Where this rank's collective operands live: its CUDA device under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _make_mesh(shape, names, device_type: Optional[str]):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group: call "
                           f"init_distributed first (or run under torchrun)")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} has {n} places; "
                         f"the process group has {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: Optional[str] = None):
    """A (data, model) mesh over every rank of the process group."""
    return _make_mesh((int(data), int(model)), ("data", "model"),
                      device_type)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return axis_sizes(mesh)
