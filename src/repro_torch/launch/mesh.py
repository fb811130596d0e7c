"""Mesh shapes: ordered mappings from axis name to size.

The port of the reference's ``repro.launch.mesh``.  Where the reference
builds a ``jax.sharding.Mesh`` over however many (placeholder) devices jax
sees, these return the mesh's shape, which is all the placement rules
(``repro_torch.dist.sharding``) and the estimator read; the device count
is passed in rather than read from a runtime.  :func:`make_device_mesh`
then builds a ``torch.distributed`` ``DeviceMesh`` of such a shape over
the process group the caller initialised (``torchrun``'s environment,
or a store and a rank given by hand): NCCL on ``cuda``, gloo only where
the caller asked for the CPU (:func:`backend_for`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

Mesh = Dict[str, int]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh: 16x16 (data, model) per pod; 2 pods multi-pod."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_dryrun_mesh(n_devices: int, *, multi_pod: bool = False) -> Mesh:
    """The production mesh when ``n_devices`` reaches it (512, or 256 for
    one pod); else a proportionally scaled-down mesh, as the reference
    makes for debug runs with fewer placeholder devices."""
    n = int(n_devices)
    if n >= 512 or (not multi_pod and n >= 256):
        return make_production_mesh(multi_pod=multi_pod)
    if multi_pod:
        per_pod = n // 2
        model = max(1, int(per_pod ** 0.5))
        while per_pod % model:
            model -= 1
        return {"pod": 2, "data": per_pod // model, "model": model}
    model = max(1, int(n ** 0.5))
    while n % model:
        model -= 1
    return {"data": n // model, "model": model}


def make_host_mesh(data: int = 1, model: int = 1,
                   pod: Optional[int] = None) -> Mesh:
    """A small (data, model) mesh, with a leading pod axis if asked."""
    if pod:
        return {"pod": int(pod), "data": int(data), "model": int(model)}
    return {"data": int(data), "model": int(model)}


def describe(mesh: Mesh) -> str:
    return " x ".join(f"{k}={v}" for k, v in mesh.items())


def backend_for(device=None) -> str:
    """The process group backend of a device: ``nccl`` on ``cuda`` (the
    default; it raises without CUDA), ``gloo`` on the CPU.  Nothing falls
    back from one to the other."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process group backend for device {dev}")


def make_device_mesh(mesh: Mesh, device=None):
    """A ``DeviceMesh`` of ``mesh``'s shape (its axes as the dim names, in
    order) over the initialised default process group, on ``cuda`` unless
    ``device`` names the CPU.  Raises unless the world size equals the
    product of the axes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs an initialised process "
                           "group (torchrun, or init_process_group)")
    n = math.prod(int(v) for v in mesh.values())
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {describe(mesh)} needs {n} processes, the "
                         f"process group has {world}")
    return init_device_mesh(dev.type, tuple(int(v) for v in mesh.values()),
                            mesh_dim_names=tuple(mesh))
