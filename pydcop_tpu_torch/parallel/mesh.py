"""Shard meshes: sharded runs of an ``n_shards > 1`` problem (port of
``pydcop_tpu/parallel/mesh.py``).

The JAX package runs a sharded round under ``shard_map``: constraint,
edge and bucket arrays are split over a 1-D device mesh, per-variable
arrays are replicated, and a round's neighbor exchange is one ``psum``
of the ``[n_vars, d]`` accumulator.  Here the same program runs SPMD in
one process: one thread per shard runs the step on its shard's views
(``ops/compile.py:shard_view``), and :class:`ShardAxis` (what the JAX
step receives as ``axis_name``) carries the collective:

- ``psum`` meets the other shards at a barrier with a timeout, sums the
  partials IN SHARD ORDER on shard 0's device (``((p0 + p1) + p2) +
  …``, the order in which an unmeshed ``n_shards > 1`` problem adds its
  segments, so a meshed run equals the unmeshed run of the same problem
  bit for bit), and hands every shard the sum on its own device.  The
  sum may be shared between shards on one device: it is read-only.
- A shard that raises breaks the barrier; the other shards stop at it,
  and the caller gets the shard's error (a barrier that times out gives
  ``TimeoutError``).

A :class:`Mesh` is an explicit sequence of ``torch.device`` s and may
repeat one: ``Mesh([torch.device("cuda", 0)] * 4)`` is four shards on
one card, the counterpart of the JAX tests' virtual CPU devices; shards
on one card share its default stream.  Random draws are not made by
the shards: the engine draws them in its own thread from the run's one
generator and hands each shard its slice (``engine/batched.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from pydcop_tpu_torch.ops.compile import (
    BUCKET_SHARD_AXES,
    SHARD_AXES,
    CompiledProblem,
    StackedProblem,
    shard_stacked,
    shard_view,
    slot_tables,
)

SHARD_AXIS = "shard"

#: seconds a shard waits at a collective for the others by default
BARRIER_TIMEOUT = 300.0


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry per
    leading axis, :data:`SHARD_AXIS` on the axis that splits over the
    mesh and ``None`` on the others; ``P()`` is replicated.  A state
    leaf's spec names its trailing (unbatched) axes: the engine prepends
    ``None`` for each restart or instance axis, as the JAX engine does."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def split_dim(self) -> Optional[int]:
        """The axis that splits, or ``None`` when replicated."""
        return self.index(SHARD_AXIS) if SHARD_AXIS in self else None


class Mesh:
    """A 1-D mesh of shards, shard s on ``devices[s]`` (a device may
    repeat).  ``barrier_timeout`` bounds every wait of a shard at a
    collective.  ``psums`` counts the collectives made over the mesh
    (one per ``psum``, whatever the shard count)."""

    def __init__(
        self,
        devices: Sequence[Union[str, torch.device]],
        barrier_timeout: float = BARRIER_TIMEOUT,
    ):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        for d in self.devices:
            if d.type == "cuda":
                if d.index is None:
                    raise ValueError(
                        f"mesh device {d}: name the card (cuda:<index>)"
                    )
                if d.index >= torch.cuda.device_count():
                    raise ValueError(
                        f"mesh device {d}: only "
                        f"{torch.cuda.device_count()} CUDA device(s)"
                    )
            elif d.type != "cpu":
                raise ValueError(f"unsupported mesh device {d} (cuda or cpu)")
        self.barrier_timeout = float(barrier_timeout)
        self.psums = 0
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self):
        """``(shard, device)`` of the shards this process runs: all of
        them."""
        return tuple(enumerate(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def gather(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's tensor in shard order: ``parts`` already holds
        them (a :class:`~pydcop_tpu_torch.parallel.distributed.
        ProcessMesh` gathers them from the other ranks)."""
        return list(parts)

    def run(self, fn: Callable[[int, "ShardAxis"], Any]) -> List[Any]:
        """``fn(index, axis)`` in one thread per shard (the thread's
        current CUDA device is the shard's); returns the results in
        shard order.  ``index`` is the shard's position in
        :attr:`local`, here its shard index too.  One call at a time
        per mesh.  A shard's exception
        breaks the barrier and is raised here, its traceback's frames
        cleared so that no shard's tensors outlive the failure."""
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    self.size, thread_name_prefix="shard"
                )
            group = _Group(self)
            axes = [ShardAxis(group, i) for i in range(self.size)]
            results: List[Any] = [None] * self.size
            errors: List[Optional[BaseException]] = [None] * self.size

            def body(i: int) -> None:
                dev = self.devices[i]
                ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                       else contextlib.nullcontext())
                try:
                    with ctx:
                        results[i] = fn(i, axes[i])
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errors[i] = e
                    group.barrier.abort()

            futures = [self._pool.submit(body, i) for i in range(self.size)]
            for f in futures:
                f.result()
            self.psums += group.psums
        failed = [e for e in errors if e is not None]
        if not failed:
            return results
        for e in failed:
            traceback.clear_frames(e.__traceback__)
        own = [e for e in failed if not isinstance(e, _BarrierBroken)]
        if own:
            raise own[0]
        raise TimeoutError(
            f"a shard waited more than {self.barrier_timeout} s at a "
            "collective for the others"
        )


class _BarrierBroken(RuntimeError):
    """A shard's wait ended because another shard failed or the barrier
    timed out."""


class _Group:
    """One :meth:`Mesh.run`'s rendezvous: the barrier, a slot per shard
    and the last collective's result."""

    def __init__(self, mesh: Mesh):
        self.size = mesh.size
        self.timeout = mesh.barrier_timeout
        self.barrier = threading.Barrier(self.size, action=self._reduce)
        self.slots: List[Optional[torch.Tensor]] = [None] * self.size
        self.result: Optional[torch.Tensor] = None
        self.psums = 0

    def _reduce(self) -> None:
        acc = self.slots[0]
        for x in self.slots[1:]:
            acc = acc + x.to(acc.device)
        self.result = acc
        self.slots = [None] * self.size
        self.psums += 1


class ShardAxis:
    """The shard axis as a step sees it (the JAX step's ``axis_name``):
    this shard's ``index``, the mesh ``size``, and :meth:`psum`.  A
    ``torch.distributed`` implementation would offer the same three."""

    name = SHARD_AXIS

    def __init__(self, group: _Group, index: int):
        self._group = group
        self.index = index

    @property
    def size(self) -> int:
        return self._group.size

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's ``x`` (same shape), in shard order on
        shard 0's device, returned on ``x``'s device (read-only)."""
        g = self._group
        g.slots[self.index] = x
        try:
            g.barrier.wait(g.timeout)
        except threading.BrokenBarrierError:
            raise _BarrierBroken(
                f"shard {self.index}: the collective was abandoned"
            ) from None
        out = g.result
        return out if out.device == x.device else out.to(x.device)


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` distinct devices.

    ``device="cuda"``: the first n cards (default: all of them); more than
    ``torch.cuda.device_count()`` raises ``ValueError``.  ``device="cpu"``:
    n CPU shards (default 1).  Several shards on one card are
    ``Mesh([torch.device("cuda", 0)] * n)``."""
    if device == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    if device != "cuda":
        raise ValueError(f"make_mesh(device={device!r}): 'cuda' or 'cpu'")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else n_devices
    if n < 1 or n > count:
        raise ValueError(
            f"Requested {n} CUDA device(s), only {count} available; "
            "several shards on one card are Mesh([torch.device('cuda', 0)] "
            f"* {max(n, 1)}), and make_mesh({max(n, 1)}, device='cpu') "
            "gives CPU shards"
        )
    return Mesh([torch.device("cuda", i) for i in range(n)])


_RP = P()


def _spec(dim: Optional[int], ndim: int) -> P:
    if dim is None:
        return _RP
    axes = [None] * ndim
    axes[dim] = SHARD_AXIS
    return P(*axes)


def problem_pspecs(problem: CompiledProblem) -> Dict[str, Any]:
    """The placement of each tensor field of ``problem``
    (``ops/compile.py:SHARD_AXES``): constraint, edge and bucket arrays
    split on their constraint or edge axis (``tables_t`` on its last),
    per-variable arrays and the flat table pool replicated; ``var_edges``
    is replaced by each shard's own slot table."""
    specs: Dict[str, Any] = {
        f: _spec(SHARD_AXES[f], getattr(problem, f).dim())
        for f in SHARD_AXES
    }
    specs["buckets"] = {
        k: {f: _spec(dim % getattr(b, f).dim(), getattr(b, f).dim())
            for f, dim in BUCKET_SHARD_AXES.items()}
        for k, b in problem.buckets.items()
    }
    return specs


def state_pspecs(algo_module, problem) -> Dict[str, Any]:
    """State placement of an algorithm: its own ``state_specs`` if it
    declares them, else replicated."""
    if hasattr(algo_module, "state_specs"):
        return algo_module.state_specs(problem)
    return {"values": _RP}


@dataclasses.dataclass
class ShardedProblem:
    """A problem placed on a mesh: ``problem`` is the whole problem as
    compiled (or a stacked group of them), ``views`` the views of the
    shards this process runs (``mesh.local``: every shard of a
    :class:`Mesh`, the rank's own of a ``ProcessMesh``), each on its
    device."""

    problem: Union[CompiledProblem, StackedProblem]
    mesh: Mesh
    views: tuple

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def device(self) -> torch.device:
        """The device of the first local shard."""
        return self.mesh.local[0][1]

    def split(self, tree: Dict[str, Any], specs: Dict[str, Any],
              lead: int = 0, unbatched=()) -> List[Dict[str, Any]]:
        """Each local shard's part of each tensor of ``tree`` on its
        device, by ``specs`` (a missing key is replicated); ``lead``
        batch axes are prepended to the spec of every key not in
        ``unbatched``."""
        out = []
        for s, dev in self.mesh.local:
            part = {}
            for k, x in tree.items():
                if not isinstance(x, torch.Tensor):
                    part[k] = x
                    continue
                dim = _dim(specs.get(k, _RP), 0 if k in unbatched else lead)
                if dim is not None:
                    size = x.shape[dim] // self.n_shards
                    x = x.narrow(dim, s * size, size).contiguous()
                part[k] = x.to(dev)
            out.append(part)
        return out

    def join(self, parts: List[Dict[str, Any]], specs: Dict[str, Any],
             lead: int = 0, device=None, unbatched=()) -> Dict[str, Any]:
        """The inverse of :meth:`split` on ``device`` (default: the
        first local shard's): split leaves concatenated in shard order
        (gathered from the other ranks under a ``ProcessMesh``: a
        collective), replicated ones taken from the first local
        shard."""
        dev = torch.device(device) if device is not None else self.device
        out = {}
        for k, x0 in parts[0].items():
            if not isinstance(x0, torch.Tensor):
                out[k] = x0
                continue
            dim = _dim(specs.get(k, _RP), 0 if k in unbatched else lead)
            if dim is None:
                out[k] = x0.to(dev)
            else:
                pieces = self.mesh.gather([p[k] for p in parts])
                out[k] = torch.cat([x.to(dev) for x in pieces], dim)
        return out


def _dim(spec, lead: int) -> Optional[int]:
    if not isinstance(spec, P):
        raise TypeError(f"not a partition spec: {spec!r}")
    d = spec.split_dim()
    return None if d is None else d + lead


def check_mesh(n_shards: int, mesh) -> None:
    """Refuse what is not a :class:`Mesh` or a ``ProcessMesh``, and a
    mesh whose size is not the problem's shard count."""
    from pydcop_tpu_torch.parallel.distributed import ProcessMesh

    if not isinstance(mesh, (Mesh, ProcessMesh)):
        raise TypeError(
            f"mesh must be a pydcop_tpu_torch.parallel.Mesh or "
            f"ProcessMesh, got {type(mesh).__name__}"
        )
    if n_shards != mesh.size:
        raise ValueError(
            f"Problem compiled for {n_shards} shard(s) but mesh "
            f"has {mesh.size} device(s); recompile with "
            f"compile_dcop(dcop, n_shards={mesh.size})"
        )


def shard_problem(problem, mesh) -> ShardedProblem:
    """Place an ``n_shards``-compiled problem (or a stacked group of
    them) on ``mesh``: one view per local shard on its device (under a
    ``ProcessMesh``, the rank's own view only)."""
    check_mesh(problem.n_shards, mesh)
    shards = [s for s, _ in mesh.local]
    devices = [d for _, d in mesh.local]
    if mesh.size == 1:
        views = (problem.to(devices[0]) if isinstance(
            problem, CompiledProblem) else problem,)
    elif isinstance(problem, StackedProblem):
        views = shard_stacked(problem, devices, shards)
    else:
        tables = slot_tables([problem])
        views = tuple(
            shard_view(problem, s, dev, slots=tables[s])
            for s, dev in zip(shards, devices)
        )
    return ShardedProblem(problem=problem, mesh=mesh, views=views)
