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
from typing import Optional, Tuple

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
            i32, vp, i32, vp, vp, vp, vp, i32, i64, i64, i64, i32, vp,
        ]
        lib.pydcop_factor_round_binary.restype = i32
        lib.pydcop_q_update.argtypes = [
            vp, vp, vp, vp, ctypes.c_float, vp, i32, i64, i64, i32, i32,
            i32, vp,
        ]
        lib.pydcop_q_update.restype = i32
        lib._pydcop_bound = True
    return built


# -- plain versions --------------------------------------------------------


def _project(s, q0f, q1f, out_dtype):
    """Both min-projections of the joint ``s[a, b, i]``, minus own q,
    min-normalized over the domain axis, rounded to ``out_dtype``."""
    r0 = s.amin(dim=1) - q0f
    r0 = r0 - r0.amin(dim=0, keepdim=True)
    r1 = s.amin(dim=0) - q1f
    r1 = r1 - r1.amin(dim=0, keepdim=True)
    return r0.to(out_dtype), r1.to(out_dtype)


def factor_round_binary_shared_plain(
    tab: torch.Tensor, q0: torch.Tensor, q1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``S[a,b,i] = (T[a,b] + q0[a,i]) + q1[b,i]``; ``r0 = min_b S − q0``,
    ``r1 = min_a S − q1``, each minus its min over the domain axis."""
    f = tab.dtype
    q0f, q1f = q0.to(f), q1.to(f)
    s = (tab[:, :, None] + q0f[:, None, :]) + q1f[None, :, :]
    return _project(s, q0f, q1f, q0.dtype)


def factor_round_binary_plain(
    tab: torch.Tensor, q0: torch.Tensor, q1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same as :func:`factor_round_binary_shared_plain` with a
    per-factor table ``tab [d, d, m]``."""
    f = tab.dtype
    q0f, q1f = q0.to(f), q1.to(f)
    s = (tab + q0f[:, None, :]) + q1f[None, :, :]
    return _project(s, q0f, q1f, q0.dtype)


def q_update_plain(
    belief: torch.Tensor,
    r_new: torch.Tensor,
    q: torch.Tensor,
    damping: float,
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
    ``1 − damp`` too.  The two factors are 0-d CPU tensors, so no
    host-to-device copy is made (the call can be captured in a CUDA
    graph)."""
    be = belief.to(q.dtype)
    if edge_idx is not None:
        be = be.index_select(1, edge_idx)
    f = torch.bfloat16 if per_op else torch.float32
    damp = torch.tensor(damping, dtype=torch.float32)
    omd = (1.0 - damp).to(f)
    damp = damp.to(f)
    qn = be.to(f) - r_new.to(f)
    qn = qn - qn.amin(dim=0, keepdim=True)
    return (damp * q.to(f) + omd * qn).to(q.dtype)


# -- wrappers --------------------------------------------------------------


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel {name} was not launched: cudaError {rc}"
        )


def _check_rows(name: str, x: torch.Tensor, d: int, m: int, dev) -> None:
    """A [d, m] message block: on ``dev``, rows contiguous (any row
    stride), message dtype."""
    if x.device != dev:
        raise ValueError(f"{name}: {x.device} is not {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} (f32 or bf16)")
    if tuple(x.shape) != (d, m) or (m > 1 and x.stride(1) != 1):
        raise ValueError(
            f"{name}: shape {tuple(x.shape)} strides {x.stride()} — "
            f"need [{d}, {m}] with unit lane stride"
        )


def _factor_launch(
    name: str,
    shared: bool,
    tab: torch.Tensor,
    q0: torch.Tensor,
    q1: torch.Tensor,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = q0.device
    d, m = q0.shape
    if not 1 <= d <= MAX_D or m < 1:
        raise ValueError(f"{name}: d={d}, m={m} (need 1 <= d <= {MAX_D})")
    want = (d, d) if shared else (d, d, m)
    if (
        tab.device != dev
        or tab.dtype not in _DTYPES
        or tuple(tab.shape) != want
        or not tab.is_contiguous()
    ):
        raise ValueError(
            f"{name}: table must be contiguous f32 or bf16 {list(want)} "
            f"on {dev}, got {tab.dtype}{list(tab.shape)} on {tab.device}"
        )
    _check_rows(f"{name} q0", q0, d, m, dev)
    _check_rows(f"{name} q1", q1, d, m, dev)
    if q1.dtype != q0.dtype or q1.stride(0) != q0.stride(0):
        raise ValueError(f"{name}: q0 and q1 differ in dtype or row stride")
    if out is None:
        out = (torch.empty_like(q0, memory_format=torch.contiguous_format),
               torch.empty_like(q0, memory_format=torch.contiguous_format))
    r0, r1 = out
    _check_rows(f"{name} r0", r0, d, m, dev)
    _check_rows(f"{name} r1", r1, d, m, dev)
    if (
        r0.dtype != q0.dtype or r1.dtype != q0.dtype
        or r1.stride(0) != r0.stride(0)
    ):
        raise ValueError(f"{name}: r0 and r1 must share q's dtype and "
                         "one row stride")
    ldq = q0.stride(0) if d > 1 else m
    ldr = r0.stride(0) if d > 1 else m
    lib = build().lib
    with torch.cuda.device(dev):
        rc = lib.pydcop_factor_round_binary(
            int(shared), tab.data_ptr(), int(tab.dtype == torch.bfloat16),
            q0.data_ptr(), q1.data_ptr(),
            r0.data_ptr(), r1.data_ptr(), d, m, ldq, ldr,
            int(q0.dtype == torch.bfloat16), _stream(dev),
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
    tab: torch.Tensor,  # f32|bf16[d, d] — ONE table shared by all m factors
    q0: torch.Tensor,  # [d, m] — position-0 variable→factor messages
    q1: torch.Tensor,  # [d, m]
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary factor phase with one shared table → ``(r0, r1)``, each
    ``[d, m]`` in q's dtype.  ``out`` may name two ``[d, m]`` row views
    (for example column blocks of the ``[d, E]`` r array) to write into."""
    if q0.device.type == "cpu":
        return _plain_into(out, *factor_round_binary_shared_plain(tab, q0, q1))
    return _factor_launch(
        "factor_round_binary_shared", True, tab, q0, q1, out
    )


def factor_round_binary(
    tab: torch.Tensor,  # f32|bf16[d, d, m] — per-factor tables
    q0: torch.Tensor,
    q1: torch.Tensor,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary factor phase with per-factor tables (see
    :func:`factor_round_binary_shared`)."""
    if q0.device.type == "cpu":
        return _plain_into(out, *factor_round_binary_plain(tab, q0, q1))
    return _factor_launch("factor_round_binary", False, tab, q0, q1, out)


def _check_gather(belief, edge_idx, d: int, e: int, q: torch.Tensor) -> None:
    """The belief and the edge index of a q update with q ``[d, E]``: a
    ``[d, n]`` belief in q's dtype or f32 on q's device, and an i32
    ``[E]`` index on the same device (or none, and then n == E)."""
    if belief.dtype not in (q.dtype, torch.float32):
        raise TypeError(
            f"q_update belief: dtype {belief.dtype} (q's {q.dtype} or f32)"
        )
    if belief.device != q.device:
        raise ValueError(f"q_update belief: {belief.device} is not {q.device}")
    if belief.dim() != 2 or belief.shape[0] != d:
        raise ValueError(
            f"q_update belief: shape {tuple(belief.shape)}, need [{d}, n]"
        )
    if edge_idx is None:
        if belief.shape[1] != e:
            raise ValueError(
                f"q_update belief: shape {tuple(belief.shape)} without an "
                f"edge index, need [{d}, {e}]"
            )
        return
    if edge_idx.dtype != torch.int32:
        raise TypeError(f"q_update edge_idx: dtype {edge_idx.dtype} (int32)")
    if tuple(edge_idx.shape) != (e,):
        raise ValueError(
            f"q_update edge_idx: shape {tuple(edge_idx.shape)}, need [{e}]"
        )
    if edge_idx.device != q.device:
        raise ValueError(
            f"q_update edge_idx: {edge_idx.device} is not {q.device}"
        )


def q_update(
    belief: torch.Tensor,  # [d, n] — the variables' beliefs
    edge_idx: Optional[torch.Tensor],  # i32[E] — each edge's variable
    r_new: torch.Tensor,  # [d, E]
    q: torch.Tensor,  # [d, E] — previous q (damping)
    damping: float,
    per_op: bool = False,
) -> torch.Tensor:
    """Fused q update with the broadcast-back gather inside: ``be[a, i] =
    belief[a, edge_idx[i]]`` rounded to q's dtype (``edge_idx`` None:
    ``belief`` is ``[d, E]`` itself, the Pallas kernel's form), subtract
    own r, min-normalize, damp → [d, E] in q's dtype.  Any domain size
    (no ``MAX_D`` cap).  ``belief`` is in q's dtype or f32; the entries
    of ``edge_idx`` must lie in ``[0, n)`` (the kernel reads them
    unchecked).  ``per_op`` rounds every operation to bf16 (see
    :func:`q_update_plain`); it needs bf16 messages and a bf16 belief
    (``maxsum.step`` asks for it only for a bf16 belief)."""
    if per_op and torch.float32 in (q.dtype, belief.dtype):
        raise ValueError(
            f"q_update: per_op needs bf16 messages and belief, not "
            f"{q.dtype} and {belief.dtype}"
        )
    if q.dim() != 2:
        raise ValueError(f"q_update q: shape {tuple(q.shape)}, need [d, E]")
    d, e = q.shape
    _check_gather(belief, edge_idx, d, e, q)
    if q.device.type == "cpu":
        return q_update_plain(belief, r_new, q, damping, per_op, edge_idx)
    dev = q.device
    if d < 1 or e < 1:
        raise ValueError(f"q_update: d={d}, E={e} (need d, E >= 1)")
    for nm, x in (("r_new", r_new), ("q", q)):
        _check_rows(f"q_update {nm}", x, d, e, dev)
        if x.dtype != q.dtype or not x.is_contiguous():
            raise ValueError(
                f"q_update {nm}: must be contiguous {q.dtype}, got "
                f"{x.dtype} strides {x.stride()}"
            )
    for nm, x in (("belief", belief), ("edge_idx", edge_idx)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"q_update {nm}: must be contiguous")
    out = torch.empty_like(q)
    lib = build().lib
    with torch.cuda.device(dev):
        rc = lib.pydcop_q_update(
            belief.data_ptr(),
            None if edge_idx is None else edge_idx.data_ptr(),
            r_new.data_ptr(), q.data_ptr(), float(damping), out.data_ptr(),
            d, e, belief.shape[1], int(belief.dtype == torch.bfloat16),
            int(q.dtype == torch.bfloat16), int(per_op), _stream(dev),
        )
    _check_rc(rc, "q_update")
    launches["q_update"] += 1
    return out
