"""The port's sparse (COO) tables against the JAX package's.

The same numpy-made tables go through both packages on the CPU: the
pack (indices, values, fill, truncation) and its exact host gathers,
the candidate-list prep, the gather/segment-reduce kernel in its plain
eager form (bit-equal arg and margins for min/max, ties and NaN cells
included; rtol 1e-6 for logsumexp), the task-scheduling generator's
YAML, and whole DPOP and inference runs at ``table_format='sparse'``
(cost, assignment, UTIL counts and the ``semiring.sparse_*`` counters
equal to JAX and to the dense run).
"""

from argparse import Namespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import pydcop_tpu.api as japi  # noqa: E402
from pydcop_tpu.commands.generators import taskscheduling as jts  # noqa: E402
from pydcop_tpu.dcop.yamldcop import dcop_yaml as jyaml  # noqa: E402
from pydcop_tpu.ops import sparse as jsp  # noqa: E402

import pydcop_tpu_torch.api as tapi  # noqa: E402
from pydcop_tpu_torch.commands.generators import (  # noqa: E402
    taskscheduling as tts,
)
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml as tyaml  # noqa: E402
from pydcop_tpu_torch.ops import semiring as tsr  # noqa: E402
from pydcop_tpu_torch.ops import sparse as tsp  # noqa: E402

CPU = "cpu"
TASKS = dict(  # bench.py's sparse stage (26 tasks, 10 slots, window 6)
    # cut to 12 tasks, 6 slots, window 4 so a run takes a second
    nb_tasks=12, nb_slots=6, window=4, stride=3, forbid_density=0.3,
    lateness_weight=1.0, capacity=100.0, seed=3,
)


def tasks(gen):
    return gen.generate(Namespace(**TASKS))


def counters(result):
    return {
        k: v for k, v in result["telemetry"]["counters"].items()
        if k.startswith(("semiring.", "dpop.", "membound.", "engine.oom"))
    }


def hard_table(shape, seed, frac=0.7, fill=np.inf):
    """A table whose ``frac`` of cells is ``fill``, the rest quarter
    integers (exact ties)."""
    rng = np.random.default_rng(seed)
    t = (rng.integers(0, 20, shape) * 0.25).astype(np.float64)
    t[rng.random(shape) < frac] = fill
    return t


# -- packing ------------------------------------------------------------


@pytest.mark.parametrize("fill,drop", [(np.inf, 0.0), (-np.inf, 0.0),
                                       (-np.inf, 1e-3)])
def test_pack_and_gathers_equal_jax(fill, drop):
    t = hard_table((8, 6, 7), seed=1, fill=fill)
    if drop:
        t = np.where(np.isfinite(t), -t * 4, t)
    jt = jsp.pack_table(t, fill, drop_tol=drop)
    pt = tsp.pack_table(t, fill, drop_tol=drop)
    assert np.array_equal(pt.flat, jt.flat)
    assert pt.vals.tobytes() == jt.vals.tobytes()
    assert (pt.fill, pt.trunc, pt.shape, pt.nbytes) == (
        jt.fill, jt.trunc, jt.shape, jt.nbytes)
    assert np.asarray(pt).tobytes() == np.asarray(jt).tobytes()
    assert pt.finite_amax() == jt.finite_amax()
    idx = (np.arange(8)[:, None], np.array([[0, 5]]), 3)
    assert pt.gather(idx).tobytes() == jt.gather(idx).tobytes()
    # too dense or too small: no pack
    assert tsp.pack_table(np.zeros((20, 20)), np.inf) is None
    assert tsp.pack_table(hard_table((4, 4), 2), np.inf) is None
    for n in (0, 1, 9, 300):
        assert tsp.nnz_bucket(n) == jsp.nnz_bucket(n)
    assert tsp.as_table_format("coo") == jsp.as_table_format("coo")
    with pytest.raises(ValueError, match="did you mean 'sparse'"):
        tsp.as_table_format("sprase")


def _node(pkg, seed, identity, dense_second=True):
    """A three-part node over target (a, b, c, own): two sparse parts
    and a dense child message."""
    rng = np.random.default_rng(seed)
    t1 = hard_table((8, 6, 6), seed, fill=identity)
    t2 = hard_table((6, 9, 6), seed + 1, fill=identity)
    parts = [
        (["a", "b", "own"], pkg.pack_table(t1, identity)),
        (["b", "c", "own"], pkg.pack_table(t2, identity)),
    ]
    assert all(isinstance(t, pkg.SparseTable) for _, t in parts)
    if dense_second:
        parts.append((["a", "c"], rng.integers(0, 8, (8, 9)) * 0.5))
    return parts, ["a", "b", "c", "own"], [8, 6, 9, 6]


@pytest.mark.parametrize("identity", [np.inf, -np.inf])
def test_node_prep_equals_jax(identity):
    jparts, target, shape = _node(jsp, 3, identity)
    tparts, _, _ = _node(tsp, 3, identity)
    jp = jsp.sparse_node_prep(jparts, target, shape, identity)
    tp = tsp.sparse_node_prep(tparts, target, shape, identity)
    assert tp.key == jp.key and (tp.n_cand, tp.n_seg, tp.trunc) == (
        jp.n_cand, jp.n_seg, jp.trunc)
    assert np.array_equal(tp.sep_ids, jp.sep_ids)
    assert np.array_equal(tp.own_ids, jp.own_ids)
    for a, b in zip(tp.gidx, jp.gidx):
        assert np.array_equal(a, b)
    for a, b in zip(tp.part_flats, jp.part_flats):
        assert a.tobytes() == b.tobytes()


# -- the gather/segment-reduce kernel -----------------------------------


def _buffers(preps, P):
    """Stacked kernel buffers of a bucket (ghost candidates in the
    ghost segment), as the sweep's sparse dispatch builds them."""
    n_cand_b, n_seg_b, lens = preps[0].key
    rows = len(preps)
    sep = np.full((rows, n_cand_b), n_seg_b, dtype=np.int32)
    own = np.zeros((rows, n_cand_b), dtype=np.int32)
    vals = [np.zeros((rows, L)) for L in lens]
    gid = [np.zeros((rows, n_cand_b), dtype=np.int32) for _ in lens]
    for r, sp in enumerate(preps):
        sep[r, :sp.n_cand] = sp.sep_ids
        own[r, :sp.n_cand] = sp.own_ids
        for i in range(P):
            vals[i][r, :sp.part_flats[i].size] = sp.part_flats[i]
            gid[i][r, :sp.n_cand] = sp.gidx[i]
    return sep, own, vals, gid


def _same_or_nan(a, b):
    return a.shape == b.shape and bool(
        np.all((a == b) | (np.isnan(a) & np.isnan(b))))


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("sr", ["min_sum", "max_sum", "log_sum_exp"])
def test_sparse_kernel_matches_jax(sr, dt):
    """Two rows of one bucket, quarter-integer values (exact ties) and,
    for min/max, a dense part with ``-inf`` cells so some candidate
    sums are NaN (``inf - inf``): bit-equal args and margins, NaN cells
    by position; logsumexp to rtol 1e-6.  int8 values go through the
    JAX package's numpy dequant reference (the JAX in-trace dequant is
    one fused multiply-add on the CPU; ROADMAP C)."""
    semiring = tsr.get_semiring(sr)
    identity = semiring.plus_identity
    parts, target, shape = _node(tsp, 5, identity)
    if semiring.idempotent:
        d = parts[2][1].copy()
        d[0, :3] = -identity
        parts[2] = (parts[2][0], d)
    # a second row of the same geometry: the same supports, other values
    rng = np.random.default_rng(9)
    parts2 = [
        (dims, tsp.SparseTable(t.shape, t.flat,
                               rng.integers(0, 20, t.nnz) * 0.25, t.fill))
        for dims, t in parts[:2]
    ] + [(parts[2][0], parts[2][1][::-1].copy())]
    preps = [tsp.sparse_node_prep(p, target, shape, identity)
             for p in (parts, parts2)]
    assert preps[0].key == preps[1].key
    n_cand_b, n_seg_b, lens = preps[0].key
    P = len(lens)
    sep, own, vals, gid = _buffers(preps, P)
    if dt == "int8":
        packed = tsr._quantize_rows(vals, 2, tsr_met())
        scales, offsets, qs = packed[0], packed[1], packed[2:]
        targs = [torch.from_numpy(scales), torch.from_numpy(offsets)]
        tvals = [torch.from_numpy(q) for q in qs]
        jvals = [
            np.stack([
                jpad_deq(q[r], scales[r, i], offsets[r, i])
                for r in range(2)
            ])
            for i, q in enumerate(qs)
        ]
        jdt = "f32"
    elif dt == "bf16":
        targs = []
        tvals = [torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                 for v in vals]
        jvals = [v.astype(np.float32).astype(ml_dtypes.bfloat16)
                 for v in vals]
        jdt = "bf16"
    else:
        targs = []
        tvals = [torch.from_numpy(v.astype(np.float32)) for v in vals]
        jvals = [v.astype(np.float32) for v in vals]
        jdt = "f32"
    got = [x.numpy() for x in tsp.sparse_contraction_kernel(
        sr, n_cand_b, n_seg_b, lens, table_dtype=dt)(
            *targs, torch.from_numpy(sep), torch.from_numpy(own), *tvals,
            *(torch.from_numpy(g) for g in gid))]
    want = [np.asarray(x) for x in jsp.sparse_contraction_kernel(
        sr, n_cand_b, n_seg_b, lens, table_dtype=jdt)(
            sep, own, *jvals, *gid)]
    assert len(got) == len(want)
    n_seg = preps[0].n_seg
    if semiring.idempotent:
        for g, w in zip(got, want):
            assert _same_or_nan(g[:, :n_seg], w[:, :n_seg].astype(g.dtype))
        assert np.isnan(want[1][:, :n_seg]).any()  # the case reaches NaN
    else:
        g, w = got[0][:, :n_seg], want[0][:, :n_seg]
        assert np.array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-6)


@pytest.mark.parametrize("sr", ["min_sum", "max_sum", "log_sum_exp"])
def test_sparse_kernel_bnb_matches_jax(sr):
    """The pruned sparse kernel (``bnb=True``): a per-row budget between
    two of the row's segment values keeps the JAX kernel's segments
    (NaN bounds kept), with bit-equal args and margins (min/max) and
    values and discard to rtol 1e-6 (logsumexp)."""
    semiring = tsr.get_semiring(sr)
    identity = semiring.plus_identity
    parts, target, shape = _node(tsp, 5, identity)
    if semiring.idempotent:
        d = parts[2][1].copy()
        d[0, :3] = -identity
        parts[2] = (parts[2][0], d)
    prep = tsp.sparse_node_prep(parts, target, shape, identity)
    n_cand_b, n_seg_b, lens = prep.key
    sep, own, vals, gid = _buffers([prep, prep], len(lens))
    vals = [v.astype(np.float32) for v in vals]
    vals[0][1] = vals[0][1][::-1]  # a second row with other values
    budgets = []
    for r in range(2):
        cand = sum(v[r][g[r]] for v, g in zip(vals, gid))
        seg = np.full(n_seg_b + 1, identity, dtype=np.float32)
        with np.errstate(invalid="ignore"):
            (np.maximum if semiring.maximize or not semiring.idempotent
             else np.minimum).at(seg, sep[r], cand)
        f = np.unique(seg[np.isfinite(seg)])
        budgets.append((f[len(f) // 2 - 1] + f[len(f) // 2]) / 2)
    budgets = np.asarray(budgets, dtype=np.float32)
    got = [x.numpy() for x in tsp.sparse_contraction_kernel(
        sr, n_cand_b, n_seg_b, lens, bnb=True)(
            torch.from_numpy(budgets), torch.from_numpy(sep),
            torch.from_numpy(own), *(torch.from_numpy(v) for v in vals),
            *(torch.from_numpy(g) for g in gid))]
    want = [np.asarray(x) for x in jsp.sparse_contraction_kernel(
        sr, n_cand_b, n_seg_b, lens, bnb=True)(
            budgets, sep, own, *vals, *gid)]
    assert len(got) == len(want)
    n_seg = prep.n_seg
    keep_at = 2 if semiring.idempotent else 1
    keep = got[keep_at][:, :n_seg]
    assert np.array_equal(keep, want[keep_at][:, :n_seg])
    assert keep.any() and not keep.all()
    if semiring.idempotent:
        for g, w in zip(got[:2], want[:2]):
            assert _same_or_nan(g[:, :n_seg], w[:, :n_seg].astype(g.dtype))
        return
    g, w = got[0][:, :n_seg], want[0][:, :n_seg]
    assert np.array_equal(np.isinf(g), np.isinf(w))
    np.testing.assert_allclose(g, w, rtol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)


def jpad_deq(q, s, o):
    from pydcop_tpu.ops.padding import dequantize_table_int8

    return dequantize_table_int8(q, s, o)


def tsr_met():
    from pydcop_tpu_torch.telemetry import get_metrics

    return get_metrics()


def _runs(seed, n_rows, n_seg, n_cand):
    """Sorted separator ids ``[n_rows, n_cand]``: random runs over
    ``n_seg`` segments (many empty, one long), ghost candidates
    (``n_seg``) at each row's end."""
    rng = np.random.default_rng(seed)
    sep = np.full((n_rows, n_cand), n_seg, dtype=np.int64)
    for r in range(n_rows):
        lens = rng.integers(0, 4, n_seg) * (rng.random(n_seg) < 0.4)
        lens[rng.integers(n_seg)] = 11  # a run longer than 8
        ids = np.repeat(np.arange(n_seg), lens)[: n_cand - 3]
        sep[r, : len(ids)] = ids
    return sep


@pytest.mark.parametrize("op", ["min", "max", "add", "int-min"])
def test_segment_fold_equals_the_padded_block(op):
    """The candidate-list fold gives, bit for bit, what an identity-padded
    ``[B, S1, L]`` block reduced over its last axis gives (``amin``/
    ``amax``, NaN included; ``fixed_order_sum`` for the sum)."""
    from pydcop_tpu_torch.ops.costs import fixed_order_sum

    n_rows, n_seg, n_cand = 3, 40, 64
    S1 = n_seg + 1
    sep = torch.from_numpy(_runs(5, n_rows, n_seg, n_cand))
    rng = np.random.default_rng(6)
    if op == "int-min":
        vals = torch.from_numpy(rng.integers(0, 50, sep.shape))
        fn, red, fill = torch.minimum, torch.amin, tsp._SENT
    else:
        v = rng.standard_normal(sep.shape).astype(np.float32)
        if op == "add":
            v = np.exp(v)
        else:
            v[rng.random(v.shape) < 0.05] = np.nan
        vals = torch.from_numpy(v)
        fn, red, fill = {
            "min": (torch.minimum, torch.amin, np.inf),
            "max": (torch.maximum, torch.amax, -np.inf),
            "add": (torch.add, None, 0.0),
        }[op]
    rank = torch.arange(n_cand) - torch.searchsorted(sep, sep)
    L = 16  # the pow-2 longest real run (11)
    got = tsp._segment_fold(vals, tsp._fold_pairs(rank, L), fn,
                            tsp._fold_heads(sep, S1), S1, fill)
    block = vals.new_full((n_rows, S1, L), fill)
    real = sep < n_seg
    rows = torch.arange(n_rows).unsqueeze(-1).expand_as(sep)
    block[rows[real], sep[real], rank[real]] = vals[real]
    want = fixed_order_sum(block) if red is None else red(block, dim=-1)
    assert _same_or_nan(got[:, :n_seg].numpy(), want[:, :n_seg].numpy())


def test_sparse_kernel_allocates_in_candidates_not_the_box():
    """No tensor the sparse join makes is larger than its candidate list
    or its ``[B, S1 + 1]`` outputs: the segments are never laid out as a
    ``[B, S1, L]`` block (here 8x the outputs)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n_rows, n_seg, n_cand = 2, 256, 64
    sep = _runs(7, n_rows, n_seg, n_cand)
    own = np.arange(n_cand) - np.stack(
        [np.searchsorted(row, row) for row in sep])
    rng = np.random.default_rng(8)
    tab = torch.from_numpy(rng.standard_normal((n_rows, 32)).astype(
        np.float32))
    gidx = torch.from_numpy(rng.integers(0, 32, sep.shape).astype(np.int32))
    args = (torch.from_numpy(sep.astype(np.int32)),
            torch.from_numpy(own.astype(np.int32)), tab, gidx)
    cap = n_rows * max(n_cand, n_seg + 2)

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(o, torch.Tensor):
                    Largest.numel = max(Largest.numel, o.numel())
            return out

    for sr in ("min_sum", "log_sum_exp"):
        Largest.numel = 0
        with Largest():
            tsp.sparse_contraction_kernel(sr, n_cand, n_seg, (32,))(*args)
        assert 0 < Largest.numel <= cap, (sr, Largest.numel, cap)


def test_sparse_kernel_refuses_structured_cells():
    with pytest.raises(ValueError, match="scalar"):
        tsp.sparse_contraction_kernel("kbest:3", 8, 8, (8,))
    with pytest.raises(ValueError, match="scalar"):
        tsp.sparse_contraction_kernel("expectation", 8, 8, (8,))
    with pytest.raises(ValueError, match="scalar"):
        tsp.sparse_contraction_kernel("kbest:3", 8, 8, (8,), bnb=True)


# -- the workload and whole runs ----------------------------------------


def test_task_scheduling_generator_writes_the_jax_yaml():
    assert tyaml(tasks(tts)) == jyaml(tasks(jts))


@pytest.mark.parametrize("pad", ["none", "pow2"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_dpop_sparse_equals_jax_and_dense(dt, pad):
    params = {"util_device": "always", "table_dtype": dt,
              "table_format": "sparse"}
    want = japi.solve(tasks(jts), "dpop", params,
                      pad_policy=pad)
    got = tapi.solve(tasks(tts), "dpop", params, pad_policy=pad, device=CPU)
    for k in ("assignment", "cost", "util_cells", "util_dispatches",
              "util_device_nodes", "util_host_nodes", "membound"):
        assert got[k] == want[k], k
    assert counters(got) == counters(want)
    assert counters(got)["semiring.sparse_nodes"] > 0
    dense = tapi.solve(tasks(tts), "dpop", dict(params, table_format="dense"),
                       pad_policy=pad, device=CPU)
    assert (got["assignment"], got["cost"]) == (
        dense["assignment"], dense["cost"])
    assert got["cost"] == 0.0  # the planted schedule


@pytest.mark.parametrize("query", ["map", "kbest:3", "log_z", "marginals"])
def test_infer_sparse(query):
    """map/kbest bit-equal to JAX and to dense (kbest keeps the dense
    kernels: structured cells never pack); log Z and marginals within
    the reported bound of host f64."""
    kw = dict(device="always", device_min_cells=256, pad_policy="pow2",
              table_format="sparse", tol=1e-3)
    want = japi.infer(tasks(jts), query, **kw)
    got = tapi.infer(tasks(tts), query, torch_device=CPU, **kw)
    assert counters(got) == counters(want)
    if query in ("map", "kbest:3"):
        for k in want:
            if k not in ("time", "telemetry"):
                assert got[k] == want[k], k
        return
    assert counters(got).get("semiring.sparse_nodes", 0) > 0
    host = tapi.infer(tasks(tts), query, device="never", torch_device=CPU)
    err = got["error_bound"]
    assert abs(got["log_z"] - host["log_z"]) <= err + 1e-9
    assert abs(got["log_z"] - want["log_z"]) <= err + want["error_bound"]
    if query == "marginals":
        for v, p in host["marginals"].items():
            assert np.allclose(got["marginals"][v], p, rtol=0, atol=err + 1e-9)
