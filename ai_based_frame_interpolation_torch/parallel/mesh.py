"""Meshes of the port (JAX ``parallel/mesh.py``): data parallelism in
PyTorch's idiom.

JAX runs one process over a mesh of its local devices and lets XLA insert
the collectives. PyTorch runs one process per card, so a :class:`Mesh` is
one of two things:

- a **process group's** mesh (:func:`make_mesh` once
  :func:`maybe_init_distributed` or the caller has joined a group): the
  group's ranks, this process's rank and its card. The trainer runs on it:
  each rank holds its part of the global batch, and the ranks meet only in
  ``all_reduce``, ``broadcast`` and ``barrier`` (gloo runs those three on
  CUDA tensors too, so two ranks may share one card);
- an **engine** mesh (no process group): the cards of this one process.
  ``InterpolationEngine(mesh=...)`` keeps one replica of its weights on
  each and splits every dispatch's batch across them.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

# how long a rank waits in a collective before it raises: a rank that died
# ends the others' wait instead of hanging them
DIST_TIMEOUT = datetime.timedelta(minutes=10)
NO_CARD = ("no CUDA device: pass devices=['cpu', ...] (and the gloo "
           "backend) to run a mesh on the CPU")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh. ``devices``: the engine mesh's cards, or
    this rank's card alone for a process group's (``grouped``), whose
    ``world_size`` ranks hold one card each."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "data"
    world_size: int = 1
    rank: int = 0
    grouped: bool = False

    @property
    def size(self) -> int:
        """The number of batch parts: ranks, or the engine's cards."""
        return self.world_size if self.grouped else len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's (first) card."""
        return self.devices[0]


def local_device() -> torch.device:
    """This process's card: ``cuda:LOCAL_RANK`` (the launcher's, else the
    rank, modulo the visible cards). Nothing falls back to the CPU: without
    a card it raises, and a caller that wants the CPU names it (``gloo``,
    ``devices=["cpu", ...]``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    return torch.device("cuda", local % torch.cuda.device_count())


def launched() -> bool:
    """Whether a launcher's environment describes a process group
    (torchrun's ``WORLD_SIZE`` and ``MASTER_ADDR``)."""
    return "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ


def maybe_init_distributed(backend: Optional[str] = None,
                           timeout: datetime.timedelta = DIST_TIMEOUT
                           ) -> bool:
    """Join the process group a launcher describes; returns whether one is
    joined.

    The environment is torchrun's (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), the counterpart of JAX's
    ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``.
    ``backend`` defaults to ``nccl``, on this process's card
    (:func:`local_device`, which raises without one); ``gloo`` is the
    caller's to ask for, on the CPU or on cards. Single-process runs (no
    ``WORLD_SIZE``/``MASTER_ADDR``) skip it."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    backend = backend or "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method="env://", timeout=timeout)
    return True


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D data-parallel mesh over the first ``num_devices`` devices
    (None or -1: all of them).

    In a process group the mesh spans the group's ranks; ``devices``, if
    given, lists each rank's device (else :func:`local_device`). Without
    one it spans ``devices`` (else every visible card) in this process.
    Without a card, ``devices`` must name the CPU: nothing falls back to
    it."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        n = world if num_devices is None or num_devices <= 0 else num_devices
        if n > world:
            raise ValueError(
                f"requested {n} devices, only {world} visible")
        if n < world:
            raise ValueError(f"a process group's mesh spans all its {world} "
                             f"ranks; requested {n}")
        dev = torch.device(devices[rank]) if devices is not None \
            else local_device()
        return Mesh((dev,), axis_name, world, rank, grouped=True)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(NO_CARD)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if num_devices is not None and num_devices > 0:
        if num_devices > len(devs):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devs)} visible")
        devs = devs[:num_devices]
    return Mesh(devs, axis_name)


def group_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` where it is a process group's, None where there is none or
    it holds one card; an engine mesh of several cards raises: training
    and its loader run one process per card."""
    if mesh is None or mesh.grouped:
        return mesh
    if mesh.size > 1:
        raise ValueError(
            f"training on {mesh.size} cards runs one process per card: join "
            "a process group (maybe_init_distributed, or cli train "
            "--num-devices) and pass its make_mesh()")
    return None


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for a process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a partition spec: ``(axis,)`` splits the batch,
    ``(None, axis)`` the height, ``()`` replicates (JAX's
    ``NamedSharding``)."""

    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> Sharding:
    """Split the leading (batch) axis across the mesh: a rank's part of a
    global batch (``sharding.shard_items``)."""
    return Sharding(mesh, (axis_name,))


def replicated(mesh: Mesh) -> Sharding:
    """The same on every part: parameters and scalars, broadcast from rank
    0 in a process group (``sharding.put_replicated``)."""
    return Sharding(mesh, ())


def pad_batch_to_devices(batch_size: int, mesh: Union[Mesh, int]) -> int:
    """Smallest batch >= batch_size divisible by the mesh's size (or
    ``mesh`` where it is a count)."""
    n = mesh if isinstance(mesh, int) else mesh.size
    return ((batch_size + n - 1) // n) * n
