"""Device-mesh helpers: the twin of ``embeddinghub_tpu/parallel/mesh.py``.

The reference's mesh is a ``jax.sharding.Mesh`` with one ``shard`` axis:
index rows are sharded round robin across its devices, queries are
replicated, and the per-shard top-k lists meet in a merge.  Here a mesh is
an ordered tuple of ``torch.device``s, one per shard.  A device may appear
more than once: four shards on ``cuda:0`` keep four arenas (or graphs) on
one card and search each apart, which is what the JAX tests do with 8
virtual CPU devices in one process.

A mesh may also span the ranks of a ``torch.distributed`` process group,
as the reference's global mesh spans ``jax.distributed`` processes
(``benchmarks/multihost_dryrun.py``).  Then ``devices`` are this rank's own
shards, every rank holds as many, and shard ``s`` of ``size`` belongs to
rank ``s // len(devices)``: the reference's global device order, process
0's devices first.  Every rank makes the same calls with the same
arguments (the reference's SPMD contract), and the shards' ``[B, k]`` lists
meet through :meth:`Mesh.all_gather_lists`, the one collective the engines
call for them.  The backend is the caller's: ``nccl`` gathers CUDA tensors
and needs a card for each rank; ``gloo`` gathers host tensors, for CPU
shards or for ranks that share a card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

SHARD_AXIS = "shard"


def shard_axis() -> str:
    return SHARD_AXIS


class Mesh:
    """One shard per entry of ``devices`` (``torch.device`` or a name such
    as ``"cuda:0"`` or ``"cpu"``), in shard order; repeats allowed.

    ``group``: a ``torch.distributed`` process group (``dist.group.WORLD``
    for the default one) whose ranks each hold ``len(devices)`` shards;
    constructing the mesh is then a collective of every rank.  ``None``:
    every shard is in this process."""

    def __init__(self, devices, group=None):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        for d in devs:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"mesh device {str(d)!r}: CUDA is not available on this host; "
                    f"name CPU devices to run on the CPU")
        self.devices = devs
        self.group = group
        self.rank, self.world, self.backend = 0, 1, None
        self.gather_s = 0.0  # wall seconds in all_gather_lists across ranks
        if group is not None:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise RuntimeError("a process mesh needs torch.distributed initialized "
                                   "(init_process_group) on every rank")
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))
            if self.backend == "nccl" and any(d.type != "cuda" for d in devs):
                raise ValueError("the nccl backend gathers CUDA tensors: name CUDA "
                                 "devices, or use gloo for CPU shards")
            counts = self.gather_objects(len(devs))
            if len(set(counts)) != 1:
                raise ValueError(f"every rank must hold as many shards: {counts}")

    @property
    def size(self) -> int:
        """Shards on the whole mesh, every rank's."""
        return len(self.devices) * self.world

    @property
    def shards(self) -> range:
        """The shard numbers of ``devices``, in order."""
        first = self.rank * len(self.devices)
        return range(first, first + len(self.devices))

    def owns(self, s: int) -> bool:
        return s in self.shards

    def put(self, a: np.ndarray) -> list[torch.Tensor]:
        """``a`` on each of this process's shards' devices, one tensor a
        shard: copied once to each distinct device, and shared by the
        shards that repeat it."""
        host = torch.from_numpy(a)
        on: dict[torch.device, torch.Tensor] = {}
        for d in self.devices:
            if d not in on:
                on[d] = host.to(d)
        return [on[d] for d in self.devices]

    def all_gather_lists(self, d: torch.Tensor, i: torch.Tensor):
        """Every rank's ``[B, w]`` lists joined column-wise in rank order,
        ``[B, world * w]``, on ``devices[0]``: ranks own shards in rank-major
        order, so rank-major columns are shard-major.  In one process the
        lists themselves.  Under gloo they pass through host memory."""
        if self.group is None:
            return d, i
        import torch.distributed as dist

        home = self.devices[0]
        if home.type == "cuda":  # gather_s counts the gather, not the shards' kernels
            torch.cuda.synchronize(home)
        t0 = time.perf_counter()
        via = home if self.backend == "nccl" else torch.device("cpu")
        out = []
        for t in (d, i):
            t = t.to(via).contiguous()
            parts = [torch.empty_like(t) for _ in range(self.world)]
            dist.all_gather(parts, t, group=self.group)
            out.append(torch.cat(parts, dim=1).to(home))
        self.gather_s += time.perf_counter() - t0
        return out[0], out[1]

    def gather_objects(self, obj) -> list:
        """``obj`` of every rank, in rank order (picklable objects; in one
        process ``[obj]``)."""
        if self.group is None:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)


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


def process_mesh(local_shards: int, device="cuda", group=None) -> Mesh:
    """A mesh of ``local_shards`` shards on each rank of the initialized
    process group (``group``, the default group when ``None``), all of a
    rank's shards on one device: ``"cuda"`` is card ``rank % cards`` (two
    ranks of one card share it), ``"cuda:N"`` or ``"cpu"`` as named; a
    card becomes the rank's current device.  Without CUDA a CUDA device
    raises, as :func:`default_mesh` does.  A collective of every rank."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("process_mesh: torch.distributed is not initialized; "
                           "call init_process_group on every rank first")
    group = dist.group.WORLD if group is None else group
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"process_mesh(device={str(device)!r}): CUDA is not "
                               f"available on this host; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", dist.get_rank(group) % torch.cuda.device_count())
        torch.cuda.set_device(dev)  # NCCL's collectives run on the current device
    return Mesh([dev] * int(local_shards), group=group)


def mesh_for(device: torch.device | str) -> Mesh:
    """The mesh of a store on ``device`` when the caller names none: every
    visible card for a CUDA device, that one device otherwise."""
    dev = torch.device(device)
    return default_mesh() if dev.type == "cuda" else Mesh([dev])
