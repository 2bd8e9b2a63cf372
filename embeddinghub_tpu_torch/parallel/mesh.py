"""Device-mesh helpers: the twin of ``embeddinghub_tpu/parallel/mesh.py``.

The reference's mesh is a ``jax.sharding.Mesh`` with one ``shard`` axis:
index rows are sharded round robin across its devices, queries are
replicated, and the per-shard top-k lists meet in a merge.  Here a mesh is
an ordered tuple of ``torch.device``s, one per shard.  A device may appear
more than once: four shards on ``cuda:0`` keep four arenas (or graphs) on
one card and search each apart, which is what the JAX tests do with 8
virtual CPU devices in one process.
"""

from __future__ import annotations

import numpy as np
import torch

SHARD_AXIS = "shard"


def shard_axis() -> str:
    return SHARD_AXIS


class Mesh:
    """One shard per entry of ``devices`` (``torch.device`` or a name such
    as ``"cuda:0"`` or ``"cpu"``), in shard order; repeats allowed."""

    def __init__(self, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        for d in devs:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"mesh device {str(d)!r}: CUDA is not available on this host; "
                    f"name CPU devices to run on the CPU")
        self.devices = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    def put(self, a: np.ndarray) -> list[torch.Tensor]:
        """``a`` on each shard's device, one tensor a shard: copied once to
        each distinct device, and shared by the shards that repeat it."""
        host = torch.from_numpy(a)
        on: dict[torch.device, torch.Tensor] = {}
        for d in self.devices:
            if d not in on:
                on[d] = host.to(d)
        return [on[d] for d in self.devices]


def default_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over ``devices``, or over the visible CUDA devices (the first
    ``n_devices`` of them; all by default).  Without CUDA and with no
    devices named it raises: there is no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("default_mesh: CUDA is not available on this host; "
                               "pass devices=['cpu'] * n to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(devices)


def mesh_for(device: torch.device | str) -> Mesh:
    """The mesh of a store on ``device`` when the caller names none: every
    visible card for a CUDA device, that one device otherwise."""
    dev = torch.device(device)
    return default_mesh() if dev.type == "cuda" else Mesh([dev])
