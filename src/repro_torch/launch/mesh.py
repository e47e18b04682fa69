"""The serving mesh of the port: which device each tensor-parallel shard
of the cloud runs on.

Counterpart of ``repro.launch.mesh.make_serve_mesh``.  A JAX ``Mesh`` is
single-controller: one Python process drives every shard.  The port
keeps that model: a ``ServeMesh`` is a list of ``torch.device``s laid
out row-major over ``(data, model)``, as ``jax.make_mesh`` lays out its
devices, and the engines launch each shard's kernels on its device from
one process.  Several shards may sit on the same card: each still owns
its slice of the cloud weights and its own kv-head slice of the page
pool, so a shard's launches have the shape each card of a multi-card
deployment would run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["ServeMesh", "make_serve_mesh", "engine_device"]


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """``data × model`` shards; shard ``(d, m)`` runs on
    ``devices[d * model + m]``."""
    devices: Tuple[torch.device, ...]
    data: int
    model: int

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"mesh axes must be >= 1, got data={self.data}, "
                             f"model={self.model}")
        if len(self.devices) != self.data * self.model:
            raise ValueError(f"{len(self.devices)} devices for a "
                             f"{self.data} x {self.model} mesh")

    # the two attributes the sharding rules read, named as on a JAX Mesh
    axis_names = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def model_devices(self, row: int = 0) -> Tuple[torch.device, ...]:
        """The devices of the ``model`` shards in data row ``row``."""
        return self.devices[row * self.model:(row + 1) * self.model]


def make_serve_mesh(model: int = 1, data: int = 1,
                    devices: Optional[Sequence[DeviceLike]] = None,
                    device: DeviceLike = None) -> ServeMesh:
    """Cloud tensor-parallel mesh for the serving engines: ``model`` is
    the TP degree the cloud suffix and the page pool's kv heads split
    over, ``data`` the slot-parallel axis.  Shard ``i`` (row-major) runs
    on ``devices[i % len(devices)]``; without ``devices`` every shard
    runs on ``device`` (default ``"cuda"``).

    Unlike the reference, which clamps ``model`` to the number of
    devices, the degree is kept as asked: placing several shards on one
    card is what lets one card run, and check, a TP deployment's
    per-shard work."""
    if devices is None:
        devs = [resolve_device(device)]
    else:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices must not be empty")
    n = data * model
    return ServeMesh(tuple(devs[i % len(devs)] for i in range(max(n, 0))),
                     data, model)


def engine_device(mesh: Optional[ServeMesh],
                  device: DeviceLike = None) -> torch.device:
    """The device a serving engine runs on: ``device`` (default
    ``"cuda"``) without a mesh, else the mesh's first device, where the
    engine keeps its edge half, its residual stream and its host-facing
    state.  Engines take meshes of one data row only."""
    if mesh is None:
        return resolve_device(device)
    if mesh.data != 1:
        raise NotImplementedError(
            "serving engines on a mesh with data > 1 are not ported yet "
            "(ROADMAP A16)")
    if device is not None and resolve_device(device) != mesh.devices[0]:
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{mesh.devices[0]}")
    return mesh.devices[0]
