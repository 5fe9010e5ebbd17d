"""Max-Sum's factor phase and q update as CUDA kernels, with their plain
PyTorch versions.

The counterpart of ``pydcop_tpu/ops/pallas_maxsum.py``: its three Pallas
TPU kernels become hand-written CUDA kernels for Hopper in
``pydcop_tpu_torch/csrc/maxsum_kernels.cu`` (the source notes there give
the design and the bounds), built with ``nvcc`` on first use and bound
with ``ctypes`` (``ops/_build.py``).

- :func:`factor_round_binary_shared` — the binary factor phase when all
  m factors share one ``[d, d]`` table (the coloring benchmark).
- :func:`factor_round_binary` — the same with per-factor tables
  ``[d, d, m]``.
- :func:`q_update` — ``q_new = damp·q + (1 − damp)·norm(be − r)`` with
  ``be = belief[:, edge_idx]`` (the broadcast-back gather) read inside
  the kernel.

Each wrapper takes the plain version (``*_plain``, the same function in
PyTorch operations) for tensors on the CPU, and only for them; for CUDA
tensors it launches the kernel or raises.  ``launches`` counts kernel
launches per wrapper, so a run can show that it went through them.

The batch axis (the JAX package's ``vmap`` of the Pallas kernels, for
restarts and instances).  Every operand may lead with a batch axis: the
messages (and the q update's belief) with ``B = I·R`` batches, the
operands that belong to an instance (the factor table, the q update's
edge index and damping) with ``I`` or none.  Batch b then reads instance
``b // R``'s operands; an operand without the axis is shared by every
batch.  One launch serves all B batches, and batch b equals an
unbatched call on batch b's operands bit for bit.

The factor kernels and the q update have an unrolled instance for each
d in ``UNROLLED_D``; every other d takes a lane-tile instance (a block
per tile of lanes, the rows split across its threads;
``csrc/maxsum_kernels.cu`` has the design), up to ``MAX_D`` for the
factor kernels and with no such cap for the q update.

Messages and tables may each be f32 or bf16.  The factor phase computes
in the table's dtype, as the Pallas kernels do (bf16 tables: every add
rounded to bf16); the q update computes in f32, or with ``per_op`` in
bf16 operation by operation (the JAX package's XLA form for a bf16
belief outside the factor-kernel gate).  Outputs are rounded to the
message dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

MAX_D = 64  # largest domain the factor kernels take (the Pallas cap)

#: domain sizes with their own unrolled factor-kernel instance; every
#: other d <= MAX_D takes the lane-tile instance
UNROLLED_D = (2, 3, 4, 5, 8)

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {
    "factor_round_binary_shared": 0,
    "factor_round_binary": 0,
    "q_update": 0,
}

_SOURCE = "maxsum_kernels.cu"
_DTYPES = (torch.float32, torch.bfloat16)  # messages and tables


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build():
    """Build (or reuse) and load the kernel library; returns
    ``ops._build.Built``."""
    from pydcop_tpu_torch.ops import _build

    built = _build.load(_SOURCE)
    lib = built.lib
    if not hasattr(lib, "_pydcop_bound"):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.pydcop_factor_round_binary.argtypes = [
            i32, vp, i32, vp, vp, vp, vp, i32, i64, i64, i64, i32,
            i32, i32, i64, i64, i64, vp,
        ]
        lib.pydcop_factor_round_binary.restype = i32
        lib.pydcop_q_update.argtypes = [
            vp, vp, vp, vp, ctypes.c_float, vp, vp, i32, i64, i64, i32, i32,
            i32, i32, i32, i64, i64, i64, vp,
        ]
        lib.pydcop_q_update.restype = i32
        lib._pydcop_bound = True
    return built


# -- plain versions --------------------------------------------------------


def _by_instance(x: torch.Tensor, n_inst: int, rank: int) -> torch.Tensor:
    """A batched operand of rank ``rank + 1`` (``[B, ...]``) viewed as
    ``[I, B // I, ...]``; an unbatched one (rank ``rank``) as it is."""
    if x.dim() == rank:
        return x
    return x.reshape((n_inst, x.shape[0] // n_inst) + tuple(x.shape[1:]))


def _per_instance(x: torch.Tensor, rank: int) -> torch.Tensor:
    """An instance operand ``[I, ...]`` with an axis of 1 after its
    instance axis (it broadcasts over the restarts); a shared one as it
    is."""
    return x if x.dim() == rank else x.unsqueeze(1)


def _instances(x: torch.Tensor, rank: int) -> int:
    return x.shape[0] if x.dim() > rank else 1


def _unbatch(x: torch.Tensor, batched: bool) -> torch.Tensor:
    return x.flatten(0, 1) if batched else x


def _project(s, q0f, q1f, out_dtype):
    """Both min-projections of the joint ``s[..., a, b, i]``, minus own
    q, min-normalized over the domain axis, rounded to ``out_dtype``."""
    r0 = s.amin(dim=-2) - q0f
    r0 = r0 - r0.amin(dim=-2, keepdim=True)
    r1 = s.amin(dim=-3) - q1f
    r1 = r1 - r1.amin(dim=-2, keepdim=True)
    return r0.to(out_dtype), r1.to(out_dtype)


def _factor_plain(tab, q0, q1, tab_rank):
    """The plain factor phase: ``q0``, ``q1`` ``[(B,) d, m]``, ``tab`` of
    rank ``tab_rank`` with an optional leading instance axis."""
    batched = q0.dim() == 3
    n_inst = _instances(tab, tab_rank) if batched else 1
    f = tab.dtype
    q0f = _by_instance(q0.to(f), n_inst, 2)
    q1f = _by_instance(q1.to(f), n_inst, 2)
    t = _per_instance(tab, tab_rank) if batched else tab
    if tab_rank == 2:  # one [d, d] table: broadcast over the lanes
        t = t[..., None]
    s = (t + q0f[..., :, None, :]) + q1f[..., None, :, :]
    r0, r1 = _project(s, q0f, q1f, q0.dtype)
    return _unbatch(r0, batched), _unbatch(r1, batched)


def factor_round_binary_shared_plain(
    tab: torch.Tensor, q0: torch.Tensor, q1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``S[a,b,i] = (T[a,b] + q0[a,i]) + q1[b,i]``; ``r0 = min_b S − q0``,
    ``r1 = min_a S − q1``, each minus its min over the domain axis.
    Batched: ``q0``, ``q1`` ``[B, d, m]`` with ``tab`` ``[d, d]`` (shared)
    or ``[I, d, d]`` (batch b reads table ``b // (B // I)``)."""
    return _factor_plain(tab, q0, q1, 2)


def factor_round_binary_plain(
    tab: torch.Tensor, q0: torch.Tensor, q1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same as :func:`factor_round_binary_shared_plain` with a
    per-factor table ``tab [(I,) d, d, m]``."""
    return _factor_plain(tab, q0, q1, 3)


def q_update_plain(
    belief: torch.Tensor,
    r_new: torch.Tensor,
    q: torch.Tensor,
    damping: Union[float, torch.Tensor],
    per_op: bool = False,
    edge_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``be = belief`` rounded to q's dtype and, with ``edge_idx``,
    gathered per edge (``be[a, i] = belief[a, edge_idx[i]]``, the
    broadcast-back gather; without it ``belief`` is already ``[d, E]``);
    ``qn = be − r_new``; ``qn −= min_d qn``;
    ``q_new = damp·q + (1 − damp)·qn`` in f32 (``1 − damp`` rounded in
    f32, as the kernel and the JAX package compute it), rounded to q's
    dtype.  ``per_op`` (bf16 messages only) computes in bf16 instead,
    every difference, product and sum rounded, and ``damp`` and
    ``1 − damp`` too.  A float damping makes 0-d CPU tensors, so no
    host-to-device copy is made (the call can be captured in a CUDA
    graph).

    Batched: ``belief`` ``[B, d, n]``, ``r_new`` and ``q`` ``[B, d, E]``;
    ``edge_idx`` ``[E]`` (shared) or ``[I, E]``, and ``damping`` a float
    or an f32 tensor of ``I`` values (batch b reads instance
    ``b // (B // I)``'s)."""
    batched = q.dim() == 3
    n_inst = _q_instances(edge_idx, damping) if batched else 1
    be = _by_instance(belief.to(q.dtype), n_inst, 2)
    if edge_idx is not None and edge_idx.dim() == 2:
        idx = edge_idx.long()[:, None, None, :]
        be = be.gather(-1, idx.expand(be.shape[:-1] + idx.shape[-1:]))
    elif edge_idx is not None:
        be = be.index_select(-1, edge_idx)
    f = torch.bfloat16 if per_op else torch.float32
    if isinstance(damping, torch.Tensor):
        damp = damping.to(torch.float32).reshape(
            (-1, 1, 1, 1) if batched else ()
        )
    else:
        damp = torch.tensor(damping, dtype=torch.float32)
    omd = (1.0 - damp).to(f)
    damp = damp.to(f)
    qf = _by_instance(q.to(f), n_inst, 2)
    qn = be.to(f) - _by_instance(r_new.to(f), n_inst, 2)
    qn = qn - qn.amin(dim=-2, keepdim=True)
    return _unbatch((damp * qf + omd * qn).to(q.dtype), batched)


def _q_instances(edge_idx, damping) -> int:
    """I of a batched q update: the instance axis of ``edge_idx``
    ``[I, E]`` and of a damping tensor, which must agree (1 when
    neither has one)."""
    counts = set()
    if edge_idx is not None and edge_idx.dim() == 2:
        counts.add(edge_idx.shape[0])
    if isinstance(damping, torch.Tensor):
        counts.add(damping.numel())
    if len(counts) > 1:
        raise ValueError(
            f"q_update: edge_idx and damping disagree on the instance "
            f"count ({sorted(counts)})"
        )
    return counts.pop() if counts else 1


# -- wrappers --------------------------------------------------------------


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel {name} was not launched: cudaError {rc}"
        )


def _check_rows(name: str, x: torch.Tensor, d: int, m: int, dev,
                batch: Optional[int] = None) -> None:
    """A [d, m] message block (``[batch, d, m]`` when batched): on
    ``dev``, rows contiguous (any row and batch stride), message
    dtype."""
    if x.device != dev:
        raise ValueError(f"{name}: {x.device} is not {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} (f32 or bf16)")
    want = (d, m) if batch is None else (batch, d, m)
    if tuple(x.shape) != want or (m > 1 and x.stride(-1) != 1):
        raise ValueError(
            f"{name}: shape {tuple(x.shape)} strides {x.stride()} — "
            f"need {list(want)} with unit lane stride"
        )


def _row_stride(x: torch.Tensor) -> int:
    """The row stride of a ``[(B,) d, m]`` block (m for a single row)."""
    d, m = x.shape[-2:]
    return x.stride(-2) if d > 1 else m


def _batch_stride(x: torch.Tensor) -> int:
    return x.stride(0) if x.dim() == 3 and x.shape[0] > 1 else 0


def _instance_count(name: str, x: torch.Tensor, rank: int, batch: int):
    """(I, B // I) of an instance operand of base rank ``rank``: I from
    its leading axis (1 without one), which must divide the batch."""
    n_inst = x.shape[0] if x.dim() == rank + 1 else 1
    if x.dim() not in (rank, rank + 1) or batch % n_inst:
        raise ValueError(
            f"{name}: shape {tuple(x.shape)} — need rank {rank}, or "
            f"{rank + 1} with an instance count dividing the batch "
            f"{batch}"
        )
    return n_inst, batch // n_inst


def _factor_launch(
    name: str,
    shared: bool,
    tab: torch.Tensor,
    q0: torch.Tensor,
    q1: torch.Tensor,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = q0.device
    batch = q0.shape[0] if q0.dim() == 3 else None
    d, m = q0.shape[-2:]
    if not 1 <= d <= MAX_D or m < 1:
        raise ValueError(f"{name}: d={d}, m={m} (need 1 <= d <= {MAX_D})")
    want = (d, d) if shared else (d, d, m)
    n_b = batch or 1
    n_inst, per = _instance_count(f"{name} table", tab, len(want), n_b)
    if batch is None and tab.dim() != len(want):
        raise ValueError(f"{name}: a batched table needs batched messages")
    if (
        tab.device != dev
        or tab.dtype not in _DTYPES
        or tuple(tab.shape[-len(want):]) != want
        or not tab.is_contiguous()
    ):
        raise ValueError(
            f"{name}: table must be contiguous f32 or bf16 "
            f"[(I,) {', '.join(map(str, want))}] on {dev}, got "
            f"{tab.dtype}{list(tab.shape)} on {tab.device}"
        )
    _check_rows(f"{name} q0", q0, d, m, dev, batch)
    _check_rows(f"{name} q1", q1, d, m, dev, batch)
    if q1.dtype != q0.dtype or q1.stride() != q0.stride():
        raise ValueError(f"{name}: q0 and q1 differ in dtype or strides")
    if out is None:
        out = (torch.empty_like(q0, memory_format=torch.contiguous_format),
               torch.empty_like(q0, memory_format=torch.contiguous_format))
    r0, r1 = out
    _check_rows(f"{name} r0", r0, d, m, dev, batch)
    _check_rows(f"{name} r1", r1, d, m, dev, batch)
    if (
        r0.dtype != q0.dtype or r1.dtype != q0.dtype
        or r1.stride() != r0.stride()
    ):
        raise ValueError(f"{name}: r0 and r1 must share q's dtype and "
                         "strides")
    tab_bstride = tab[0].numel() if n_inst > 1 else 0
    lib = build().lib
    with torch.cuda.device(dev):
        rc = lib.pydcop_factor_round_binary(
            int(shared), tab.data_ptr(), int(tab.dtype == torch.bfloat16),
            q0.data_ptr(), q1.data_ptr(),
            r0.data_ptr(), r1.data_ptr(), d, m, _row_stride(q0),
            _row_stride(r0), int(q0.dtype == torch.bfloat16),
            n_b, per, tab_bstride, _batch_stride(q0), _batch_stride(r0),
            _stream(dev),
        )
    _check_rc(rc, name)
    launches[name] += 1
    return r0, r1


def _plain_into(out, r0, r1):
    if out is None:
        return r0, r1
    out[0].copy_(r0)
    out[1].copy_(r1)
    return out


def factor_round_binary_shared(
    tab: torch.Tensor,  # f32|bf16[(I,) d, d] — one table per instance
    q0: torch.Tensor,  # [(B,) d, m] — position-0 variable→factor messages
    q1: torch.Tensor,  # [(B,) d, m]
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary factor phase with one shared table → ``(r0, r1)``, each
    ``[(B,) d, m]`` in q's dtype.  ``out`` may name two row views (for
    example column blocks of the ``[(B,) d, E]`` r array) to write into.
    Batched (q ``[B, d, m]``): a ``[d, d]`` table serves every batch, an
    ``[I, d, d]`` one gives batch b table ``b // (B // I)``."""
    if q0.device.type == "cpu":
        return _plain_into(out, *factor_round_binary_shared_plain(tab, q0, q1))
    return _factor_launch(
        "factor_round_binary_shared", True, tab, q0, q1, out
    )


def factor_round_binary(
    tab: torch.Tensor,  # f32|bf16[(I,) d, d, m] — per-factor tables
    q0: torch.Tensor,
    q1: torch.Tensor,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary factor phase with per-factor tables (see
    :func:`factor_round_binary_shared`)."""
    if q0.device.type == "cpu":
        return _plain_into(out, *factor_round_binary_plain(tab, q0, q1))
    return _factor_launch("factor_round_binary", False, tab, q0, q1, out)


def _check_gather(belief, edge_idx, d: int, e: int, q: torch.Tensor,
                  batch: Optional[int]) -> None:
    """The belief and the edge index of a q update with q ``[(B,) d,
    E]``: a ``[(B,) d, n]`` belief in q's dtype or f32 on q's device,
    and an i32 ``[(I,) E]`` index on the same device (or none, and then
    n == E)."""
    if belief.dtype not in (q.dtype, torch.float32):
        raise TypeError(
            f"q_update belief: dtype {belief.dtype} (q's {q.dtype} or f32)"
        )
    if belief.device != q.device:
        raise ValueError(f"q_update belief: {belief.device} is not {q.device}")
    lead = () if batch is None else (batch,)
    if belief.dim() != len(lead) + 2 or belief.shape[:-1] != lead + (d,):
        raise ValueError(
            f"q_update belief: shape {tuple(belief.shape)}, need "
            f"{list(lead + (d,))} + [n]"
        )
    if edge_idx is None:
        if belief.shape[-1] != e:
            raise ValueError(
                f"q_update belief: shape {tuple(belief.shape)} without an "
                f"edge index, need [..., {d}, {e}]"
            )
        return
    if edge_idx.dtype != torch.int32:
        raise TypeError(f"q_update edge_idx: dtype {edge_idx.dtype} (int32)")
    if edge_idx.shape[-1:] != (e,) or edge_idx.dim() > (
        1 if batch is None else 2
    ):
        raise ValueError(
            f"q_update edge_idx: shape {tuple(edge_idx.shape)}, need "
            f"[(I,) {e}]"
        )
    if edge_idx.device != q.device:
        raise ValueError(
            f"q_update edge_idx: {edge_idx.device} is not {q.device}"
        )


def q_update(
    belief: torch.Tensor,  # [(B,) d, n] — the variables' beliefs
    edge_idx: Optional[torch.Tensor],  # i32[(I,) E] — each edge's variable
    r_new: torch.Tensor,  # [(B,) d, E]
    q: torch.Tensor,  # [(B,) d, E] — previous q (damping)
    damping: Union[float, torch.Tensor],
    per_op: bool = False,
) -> torch.Tensor:
    """Fused q update with the broadcast-back gather inside: ``be[a, i] =
    belief[a, edge_idx[i]]`` rounded to q's dtype (``edge_idx`` None:
    ``belief`` is ``[d, E]`` itself, the Pallas kernel's form), subtract
    own r, min-normalize, damp → ``[(B,) d, E]`` in q's dtype.  Any
    domain size (no ``MAX_D`` cap).  ``belief`` is in q's dtype or f32;
    the entries of ``edge_idx`` must lie in ``[0, n)`` (the kernel reads
    them unchecked).  ``per_op`` rounds every operation to bf16 (see
    :func:`q_update_plain`); it needs bf16 messages and a bf16 belief
    (``maxsum.step`` asks for it only for a bf16 belief).

    Batched (q ``[B, d, E]``): ``edge_idx`` ``[E]`` serves every batch,
    ``[I, E]`` gives batch b row ``b // (B // I)``; ``damping`` is a
    float or an f32 tensor of ``I`` values on q's device, one per
    instance."""
    if per_op and torch.float32 in (q.dtype, belief.dtype):
        raise ValueError(
            f"q_update: per_op needs bf16 messages and belief, not "
            f"{q.dtype} and {belief.dtype}"
        )
    if q.dim() not in (2, 3):
        raise ValueError(
            f"q_update q: shape {tuple(q.shape)}, need [(B,) d, E]"
        )
    batch = q.shape[0] if q.dim() == 3 else None
    d, e = q.shape[-2:]
    _check_gather(belief, edge_idx, d, e, q, batch)
    n_inst = _q_instances(edge_idx, damping) if batch else 1
    if batch is None and isinstance(damping, torch.Tensor):
        raise ValueError("q_update: per-instance damping needs a batch")
    if batch is not None and batch % n_inst:
        raise ValueError(
            f"q_update: {n_inst} instances do not divide the batch {batch}"
        )
    if q.device.type == "cpu":
        return q_update_plain(belief, r_new, q, damping, per_op, edge_idx)
    dev = q.device
    if d < 1 or e < 1:
        raise ValueError(f"q_update: d={d}, E={e} (need d, E >= 1)")
    for nm, x in (("r_new", r_new), ("q", q)):
        _check_rows(f"q_update {nm}", x, d, e, dev, batch)
        if x.dtype != q.dtype or not x.is_contiguous():
            raise ValueError(
                f"q_update {nm}: must be contiguous {q.dtype}, got "
                f"{x.dtype} strides {x.stride()}"
            )
    for nm, x in (("belief", belief), ("edge_idx", edge_idx)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"q_update {nm}: must be contiguous")
    damp_arr = None
    if isinstance(damping, torch.Tensor):
        if (damping.dtype != torch.float32 or damping.device != dev
                or not damping.is_contiguous()):
            raise ValueError(
                "q_update damping: a per-instance damping must be a "
                f"contiguous f32 tensor on {dev}"
            )
        damp_arr, damping = damping, 0.0
    n_b = batch or 1
    idx_bstride = e if edge_idx is not None and edge_idx.dim() == 2 else 0
    out = torch.empty_like(q)
    lib = build().lib
    with torch.cuda.device(dev):
        rc = lib.pydcop_q_update(
            belief.data_ptr(),
            None if edge_idx is None else edge_idx.data_ptr(),
            r_new.data_ptr(), q.data_ptr(), float(damping),
            None if damp_arr is None else damp_arr.data_ptr(),
            out.data_ptr(), d, e, belief.shape[-1],
            int(belief.dtype == torch.bfloat16),
            int(q.dtype == torch.bfloat16), int(per_op),
            n_b, n_b // n_inst, _batch_stride(belief), idx_bstride,
            _batch_stride(q), _stream(dev),
        )
    _check_rc(rc, "q_update")
    launches["q_update"] += 1
    return out
