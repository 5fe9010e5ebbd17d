"""Process meshes: one OS process a shard over ``torch.distributed`` (the
port's counterpart of ``jax.distributed`` and of a ``jax.sharding.Mesh``
that spans processes).

The JAX package's SPMD runtime (``infrastructure/orchestrator.py``,
``infrastructure/elastic.py``) joins every process to one
``jax.distributed`` cluster and runs the sharded solve over a global
mesh.  Here every process joins one ``torch.distributed`` process group
and runs the same sharded solve over a :class:`ProcessMesh`: shard s is
rank s, and the mesh's size is the world size.  Each rank builds and
steps only its own view of the problem (``parallel/mesh.py:
shard_problem``); the rounds' draws are made from the whole problem's
shapes by every rank from a generator seeded alike, and each rank keeps
its slice (``engine/batched.py:ShardedRounds``).

The backend is gloo, on CPU tensors: NCCL refuses two ranks on one card
("Duplicate GPU detected"), and several ranks on one card is the layout
of the one-card machine.  :meth:`ProcessAxis.psum` adds in shard order,
as :class:`~pydcop_tpu_torch.parallel.mesh.ShardAxis` does: every rank's
partial is gathered (a copy to the host, ``all_gather``, a copy back to
the rank's device), then summed ``((p0 + p1) + p2) + …`` on the rank's
device, so a process-mesh run equals the in-process mesh run and the
unmeshed run of the same ``n_shards`` problem bit for bit.  No
``all_reduce``: its reduction order is the backend's.

The group's ``timeout`` bounds every wait at a collective: a peer that
died, or never reaches the collective, turns into a
:class:`CollectiveError` on the ranks that wait for it, not a hang.
"""

from __future__ import annotations

import contextlib
import os
import time
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch

from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.parallel.mesh import SHARD_AXIS

BACKEND = "gloo"


class CollectiveError(RuntimeError):
    """A collective of a process mesh failed: a peer died, or did not
    reach the collective within the group's timeout.  The backend's own
    error is the ``__cause__``."""


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The device of rank ``rank``: ``cuda`` (or ``None``) is the card
    ``rank % device_count``, an explicit ``cuda:k`` is kept, and the CPU
    is taken only when asked for.  Without CUDA a card raises
    ``NoCudaDeviceError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)  # raises without CUDA
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return resolve_device(dev)


def bind_store(world_size: int, timeout: float, host: str = "localhost",
               listen_fd: Optional[int] = None):
    """Rank 0's ``TCPStore``, listening before any peer is told its
    address: on a port the OS picks, or on the listening socket
    ``listen_fd`` another process bound and handed over.  Its ``port``
    goes to the other ranks."""
    import torch.distributed as dist

    port = 0
    if listen_fd is not None:
        import socket

        with socket.socket(fileno=os.dup(listen_fd)) as s:
            port = s.getsockname()[1]
    return dist.TCPStore(
        host, port, world_size, True, timedelta(seconds=timeout),
        wait_for_workers=False, master_listen_fd=listen_fd,
    )


def init_process_mesh(coordinator: str, world_size: int, rank: int,
                      device: torch.device, timeout: float,
                      store=None) -> "ProcessMesh":
    """Join the gloo process group whose store rank 0 serves at
    ``coordinator`` (``host:port``; rank 0 passes the ``store`` it
    bound, see :func:`bind_store`) and return the mesh over it.  Every
    collective of the group waits at most ``timeout`` seconds."""
    import torch.distributed as dist

    host, port = coordinator.rsplit(":", 1)
    if store is None:
        store = dist.TCPStore(host, int(port), world_size, False,
                              timedelta(seconds=timeout))
    dist.init_process_group(
        BACKEND, store=store, rank=rank, world_size=world_size,
        timeout=timedelta(seconds=timeout),
    )
    return ProcessMesh(device)


class ProcessMesh:
    """A 1-D mesh whose shards are the ranks of the default
    ``torch.distributed`` process group: this process runs shard
    ``rank`` on ``device``.  It offers what a
    :class:`~pydcop_tpu_torch.parallel.mesh.Mesh` offers the engine
    (``size``, ``local``, ``run``, ``gather``, ``psums``).  ``psums``
    counts the collectives of its axis, ``psum_seconds`` the host
    seconds spent in them (the copy of the partial to the host, which
    waits for the device, the gather, which waits for the peers, and
    the sum)."""

    def __init__(self, device: DeviceLike):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessMesh needs an initialized torch.distributed "
                "process group (init_process_mesh)"
            )
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = dist.get_backend()
        self.psums = 0
        self.psum_seconds = 0.0
        self._axis = ProcessAxis(self)

    def __repr__(self) -> str:
        return (f"ProcessMesh(rank={self.rank}, size={self.size}, "
                f"device={self.device})")

    @property
    def local(self):
        """``(shard, device)`` of the shards this process runs."""
        return ((self.rank, self.device),)

    def run(self, fn: Callable[[int, "ProcessAxis"], Any]) -> List[Any]:
        """``fn(0, axis)`` in the calling thread (the rank's device
        current): as :meth:`Mesh.run`, the first argument is the
        shard's position in :attr:`local` (the one local shard) and
        ``axis.index`` its shard index (the rank); the one result in a
        list."""
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            return [fn(0, self._axis)]

    def gather(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's tensor (``parts`` holds this rank's), in shard
        order, on the host.  The shapes must agree across ranks."""
        (x,) = parts
        return list(self._all_gather(x).unbind(0))

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        flag = x.dtype == torch.bool  # gloo moves no bool
        host = x.detach().to("cpu", torch.uint8 if flag else x.dtype)
        host = host.contiguous()
        out = torch.empty((self.size,) + tuple(host.shape), dtype=host.dtype)
        try:
            dist.all_gather(list(out.unbind(0)), host)
        except RuntimeError as e:
            raise CollectiveError(
                f"rank {self.rank}: a collective of the process mesh "
                "failed (a peer died, or missed it within the group's "
                "timeout)"
            ) from e
        return out.bool() if flag else out

    def close(self, barrier: bool = True) -> None:
        """Leave the process group (after a barrier when ``barrier``: a
        clean run's ranks part together)."""
        import torch.distributed as dist

        if not dist.is_initialized():
            return
        try:
            if barrier:
                dist.barrier()
        finally:
            dist.destroy_process_group()


class ProcessAxis:
    """The shard axis of a :class:`ProcessMesh` as a step sees it (what
    :class:`~pydcop_tpu_torch.parallel.mesh.ShardAxis` offers): this
    rank's ``index``, the mesh ``size`` and :meth:`psum`."""

    name = SHARD_AXIS

    def __init__(self, mesh: ProcessMesh):
        self._mesh = mesh
        self.index = mesh.rank

    @property
    def size(self) -> int:
        return self._mesh.size

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` (same shape), added in shard
        order on ``x``'s device."""
        m = self._mesh
        t0 = time.perf_counter()
        parts = m._all_gather(x).to(x.device)
        acc = parts[0]
        for i in range(1, m.size):
            acc = acc + parts[i]
        m.psums += 1
        m.psum_seconds += time.perf_counter() - t0
        return acc
