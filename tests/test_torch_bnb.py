"""The port's branch-and-bound pruning (``bnb``) against the JAX package's.

The same instances, built once with each package's model objects, go
through both packages on the CPU:

- the pruning context (:class:`_BnbContext`: the greedy incumbent, the
  k-th incumbent, the subtree rest bounds, every node's ``budget()``)
  bit-equal on a hard-capped overlap SECP, per semiring and storage type;
- ``contraction_kernel(bnb=True)`` per semiring and storage type: keep
  masks equal to the JAX kernel's (NaN bounds kept), min/max/kbest
  outputs bit-equal, the mass kinds' values and measured discard within
  rtol 1e-6;
- whole DPOP runs at ``bnb`` on/auto/off (one of them through the
  compact host pass 2): assignment, cost and every ``semiring.*`` and
  ``dpop.*`` counter equal to JAX's; sparse and budgeted pruned runs
  equal to the dense and unbounded ones;
- ``infer`` at ``bnb="on"``: map and kbest equal to the unpruned run,
  log_z, marginals and ``e_cost`` within ``error_bound`` of host f64 and
  equal to JAX's value and bound within rtol 1e-6;
- Max-Sum's pruned factor phase (``bp_factor_messages(bnb=True)``)
  bit-equal to the unpruned one and to JAX's.
"""

import itertools
import random
from argparse import Namespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import pydcop_tpu.api as japi  # noqa: E402
import pydcop_tpu.dcop as jdcop  # noqa: E402
import pydcop_tpu.ops.semiring as jsr  # noqa: E402
from pydcop_tpu.commands.generators import secp as jsecp  # noqa: E402
from pydcop_tpu.commands.generators import taskscheduling as jts  # noqa
from pydcop_tpu.ops import padding as jpad  # noqa: E402

import pydcop_tpu_torch.api as tapi  # noqa: E402
import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
import pydcop_tpu_torch.ops.semiring as tsr  # noqa: E402
from pydcop_tpu_torch import telemetry as ttel  # noqa: E402
from pydcop_tpu_torch.commands.generators import secp as tsecp  # noqa
from pydcop_tpu_torch.commands.generators import (  # noqa: E402
    taskscheduling as tts,
)
from pydcop_tpu_torch.ops.padding import as_pad_policy  # noqa: E402

CPU = "cpu"
# bench.py's bnb-stage SECP (28 lights, 18 models, 10 levels) cut to 16
# lights, 10 models and 8 levels: the sweep still prunes most rows and
# sends buckets through the compact host pass 2
SECP = dict(
    nb_lights=16, nb_models=10, nb_rules=8, light_levels=8,
    model_arity=5, zone_size=8, zone_layout="overlap", zone_overlap=5,
    efficiency_weight=0.1, capacity=100.0, seed=11, hard_cap=1.02,
)
# the membound control band (tests/test_torch_membound.py's OVERLAP)
OVERLAP = dict(
    nb_lights=16, nb_models=10, nb_rules=0, light_levels=4,
    model_arity=4, zone_size=7, zone_layout="overlap", zone_overlap=3,
    efficiency_weight=0.1, capacity=100.0, seed=7, hard_cap=1.1,
)
TASKS = dict(  # tests/test_torch_sparse.py's task-scheduling cut
    nb_tasks=12, nb_slots=6, window=4, stride=3, forbid_density=0.3,
    lateness_weight=1.0, capacity=100.0, seed=3,
)


@pytest.fixture(autouse=True)
def no_session_left():
    assert ttel._active is None
    yield
    assert ttel._active is None


def gen(module, spec):
    return module.generate(Namespace(**spec))


def hard_band(m, n, seed, d=4, arity=4, stride=2, cap=1.15, ties=False):
    """A chained band with hard over-sum caps (``+inf`` past ``cap ×
    target``), the structure the pruned kernels prune (the JAX package's
    ``tests/test_semiring.py:_hard_band_dcop``), built with the model
    objects of package ``m``."""
    rnd = random.Random(seed)
    dom = m.Domain("d", "", list(range(d)))
    dcop = m.DCOP(f"hb{seed}")
    vs = [m.Variable(f"v{i}", dom) for i in range(n)]
    for i, v in enumerate(vs):
        dcop.add_variable(v)
        dcop.add_constraint(m.NAryMatrixRelation(
            [v], np.arange(d, dtype=np.float64) * rnd.uniform(0.05, 0.3),
            name=f"u{i}",
        ))
    for k in range((n - arity) // stride + 1):
        scope = vs[k * stride:k * stride + arity]
        t = rnd.uniform(0.3, 0.8) * arity * (d - 1)
        mat = np.zeros((d,) * arity)
        for idx in itertools.product(range(d), repeat=arity):
            s = sum(idx)
            if s > cap * t:
                mat[idx] = np.inf
            else:
                c = abs(s - t)
                mat[idx] = round(c * 2) / 2.0 if ties else c
        dcop.add_constraint(m.NAryMatrixRelation(scope, mat, name=f"m{k}"))
    dcop.add_agents([m.AgentDef(f"a{i}") for i in range(n)])
    return dcop


def both(builder, *args, **kw):
    return builder(jdcop, *args, **kw), builder(tdcop, *args, **kw)


def counters(result):
    return {
        k: v for k, v in result["telemetry"]["counters"].items()
        if k.startswith(("semiring.", "dpop.", "membound."))
    }


# -- the context -----------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize(
    "sr", ["min_sum", "max_sum", "log_sum_exp", "marginals", "kbest:3",
           "expectation"],
)
def test_context_equals_jax(sr, dt):
    """Incumbents, rest bounds and every node's budget bit for bit."""
    jp = jsr.build_plan(gen(jsecp, OVERLAP))
    tp = tsr.build_plan(gen(tsecp, OVERLAP))
    jc = jsr.plan_bnb_context(jp, jsr.get_semiring(sr), 0.7, 1e-4, dt)
    tc = tsr.plan_bnb_context(tp, tsr.get_semiring(sr), 0.7, 1e-4, dt)
    for f in ("inc", "inc_k", "rest", "rest_logdom", "tol_node",
              "table_dtype"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert np.isfinite(tc.inc)
    for i, v in enumerate(tp.order):
        kids = tp.children[v]
        shift = 0.25 * i
        for c in (jc, tc):
            c.record_shift(v, shift, kids)
        args = (v, tc.shift_under(kids), 3, 7.25, 4, 16)
        assert tc.budget(*args) == jc.budget(*args), v
        assert tc.account(v, -3.5, shift, 4) == jc.account(v, -3.5, shift, 4)
    assert tc.cumshift == jc.cumshift
    assert tc.no_prune() == jc.no_prune()
    first = {v: 1 for v in tp.order}
    assert tc.seed_incumbent(
        {}, first) == jc.seed_incumbent({}, first)
    for pad in ("none", "pow2"):
        assert tsr.max_padded_join_cells(tp, as_pad_policy(pad)) == (
            jsr.max_padded_join_cells(jp, jpad.as_pad_policy(pad)))


# -- the pruned kernels ----------------------------------------------------

CASES = {
    # semiring: (joined shape, aligned part shapes; a trailing k or pair
    # axis marks a kbest child cell or an expectation pair part)
    "min_sum": ((4, 3, 5), ((4, 1, 5), (1, 3, 5), (4, 3, 1))),
    "max_sum": ((4, 3, 5), ((4, 1, 5), (1, 3, 5), (4, 3, 1))),
    "log_sum_exp": ((4, 3, 5), ((4, 1, 5), (1, 3, 5), (4, 3, 1))),
    "marginals": ((6, 4), ((6, 4), (1, 4))),
    "kbest:3": ((4, 3, 5), ((4, 1, 5), (1, 3, 5, 3), (4, 3, 1, 3))),
    "expectation": ((4, 3, 5), ((4, 1, 5, 2), (1, 3, 5, 2), (1, 1, 5))),
}


def _parts(sr, shapes, lead, seed):
    """Quarter-integer f32 parts (exact ties), a fifth of the cells
    infinite: ±inf in alternate parts for min/max (so some joined rows
    are NaN), ``+inf`` costs for kbest (child k-cells sorted ascending),
    ``-inf`` log-weights (zero mass) for the mass kinds."""
    rng = np.random.default_rng(seed)
    out = []
    for i, ps in enumerate(shapes):
        p = (rng.integers(0, 40, lead + ps) * 0.25).astype(np.float32)
        flat = p.reshape(-1)
        pick = rng.choice(flat.size, size=max(1, flat.size // 5),
                          replace=False)
        kbest = sr.startswith("kbest")
        if sr in ("min_sum", "max_sum"):
            flat[pick] = np.inf if i % 2 == 0 else -np.inf
        else:
            flat[pick] = np.inf if kbest else -np.inf
        if kbest and len(ps) == len(shapes[0]) + 1:
            p = np.sort(p, axis=-1)
        out.append(p)
    return out


def _budget_between(bounds, lead):
    """A per-row budget strictly between two distinct finite bounds near
    the median (so no row sits on it, whatever the rounding)."""
    rows = bounds.reshape(lead + (-1,)) if lead else bounds.reshape(1, -1)
    out = []
    for r in rows:
        f = np.unique(r[np.isfinite(r)])
        if len(f) < 2:  # a stack row with no two finite bounds
            f = np.unique(bounds[np.isfinite(bounds)])
        mid = len(f) // 2
        out.append(np.float32((f[mid - 1] + f[mid]) / 2))
    return np.array(out, dtype=np.float32) if lead else out[0]


def _kernel_args(parts, dt, batched):
    if dt == "f32":
        return parts, [torch.from_numpy(p) for p in parts]
    if dt == "bf16":
        return ([p.astype(ml_dtypes.bfloat16) for p in parts],
                [torch.from_numpy(p).to(torch.bfloat16) for p in parts])
    if batched:
        packed = tsr._quantize_rows(
            [p.astype(np.float64) for p in parts], parts[0].shape[0],
            ttel.get_metrics())
    else:
        packed = tsr._pack_parts(parts, "int8")
    return packed, [torch.from_numpy(np.asarray(p)) for p in packed]


def _dequantized(jargs, batched):
    scales, offsets, *qs = jargs
    if not batched:
        return [jpad.dequantize_table_int8(q, scales[i], offsets[i])
                for i, q in enumerate(qs)]
    return [np.stack([jpad.dequantize_table_int8(q[r], scales[r, i],
                                                 offsets[r, i])
                      for r in range(q.shape[0])])
            for i, q in enumerate(qs)]


def _same_or_nan(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(
        np.all((a == b) | (np.isnan(a) & np.isnan(b))))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("sr,dt", [
    ("min_sum", "f32"), ("min_sum", "bf16"), ("min_sum", "int8"),
    ("max_sum", "f32"), ("max_sum", "bf16"), ("max_sum", "int8"),
    ("log_sum_exp", "f32"), ("log_sum_exp", "bf16"),
    ("log_sum_exp", "int8"), ("marginals", "f32"), ("kbest:3", "f32"),
    ("expectation", "f32"),
])
def test_contraction_kernel_bnb_matches_jax(sr, dt, batched):
    shape, part_shapes = CASES[sr]
    lead = (3,) if batched else ()
    parts = _parts(sr, part_shapes, lead, seed=len(sr) + 3 * batched)
    jargs, targs = _kernel_args(parts, dt, batched)
    # the bounds from the parts the kernel joins (int8: dequantized)
    fparts = (_dequantized(jargs, batched) if dt == "int8" else
              [np.asarray(p, dtype=np.float32) for p in jargs])
    semiring = tsr.get_semiring(sr)
    if semiring.idempotent:
        j = fparts[0]
        for p in fparts[1:]:
            j = j + p
        with np.errstate(invalid="ignore"):
            bounds = j.min(-1) if sr == "min_sum" else j.max(-1)
    else:
        unpruned = [np.asarray(x) for x in jsr.contraction_kernel(
            sr, shape, part_shapes, batched=batched)(*fparts)]
        bounds = unpruned[0][..., 0] if semiring.cell_width > 1 else (
            unpruned[0])
    budget = _budget_between(bounds, lead)
    jfn = jsr.contraction_kernel(sr, shape, part_shapes, batched=batched,
                                 bnb=True, table_dtype=dt)
    want = [np.asarray(x) for x in jfn(budget, *jargs)]
    tfn = tsr.contraction_kernel(sr, shape, part_shapes, batched=batched,
                                 bnb=True, table_dtype=dt)
    got = [x.numpy() for x in tfn(torch.as_tensor(budget), *targs)]
    assert len(got) == len(want)
    keep_at = -1 if semiring.idempotent or semiring.kind == "kbest" else -2
    keep = got[keep_at]
    assert np.array_equal(keep, want[keep_at])
    assert keep.any() and not keep.all()  # the budget prunes some rows
    if sr == "min_sum" and dt == "f32":
        assert np.isnan(bounds).any() and keep[np.isnan(bounds)].all()
    if dt == "int8":  # bit-equal against JAX fed the dequantized parts
        want = [np.asarray(x) for x in jsr.contraction_kernel(
            sr, shape, part_shapes, batched=batched, bnb=True)(
                budget, *fparts)]
    if semiring.idempotent or semiring.kind == "kbest":
        for g, w in zip(got, want):
            assert _same_or_nan(g, w.astype(g.dtype))
        return
    (g, _, gd), (w, _, wd) = got, want
    assert np.array_equal(np.isneginf(g), np.isneginf(w))
    np.testing.assert_allclose(g, w, rtol=1e-6)
    assert np.array_equal(np.isneginf(gd), np.isneginf(wd))
    np.testing.assert_allclose(gd, wd, rtol=1e-6)


def test_nan_bounds_are_kept():
    """``~(bound > budget)``: a NaN row (``+inf`` and ``-inf`` parts
    meeting) is kept, as NumPy's and XLA's negated comparisons keep it."""
    fn = tsr.contraction_kernel("min_sum", (2, 2), ((2, 2), (2, 2)), bnb=True)
    a = torch.tensor([[np.inf, np.inf], [5.0, 6.0]])
    b = torch.tensor([[-np.inf, -np.inf], [0.0, 0.0]])
    _, margins, keep = fn(torch.tensor(1.0), a, b)
    assert keep.tolist() == [True, False]
    assert margins[1].item() == np.inf


# -- DPOP -----------------------------------------------------------------

_SECP_RUNS = {}


def _secp_dpop(package, bnb, util_batch):
    key = (package, bnb, util_batch)
    if key not in _SECP_RUNS:
        mod, api = (jsecp, japi) if package == "jax" else (tsecp, tapi)
        kw = {} if package == "jax" else {"device": CPU}
        _SECP_RUNS[key] = api.solve(
            gen(mod, SECP), "dpop",
            {"util_device": "always", "bnb": bnb, "util_batch": util_batch},
            pad_policy="pow2", **kw,
        )
    return _SECP_RUNS[key]


@pytest.mark.parametrize("bnb,util_batch", [
    ("on", "level"), ("on", "node"), ("auto", "level"), ("off", "level"),
])
def test_dpop_equals_jax(bnb, util_batch):
    want = _secp_dpop("jax", bnb, util_batch)
    got = _secp_dpop("port", bnb, util_batch)
    for k in ("assignment", "cost", "util_cells", "util_device_nodes",
              "util_host_nodes", "util_dispatches"):
        assert got[k] == want[k], k
    assert counters(got) == counters(want)
    c = counters(got)
    if bnb == "off":
        assert not any(k.startswith("semiring.bnb") for k in c)
        return
    assert c["semiring.bnb_pruned_cells"] > 0
    off = _secp_dpop("port", "off", "level")
    assert (got["assignment"], got["cost"]) == (off["assignment"],
                                                off["cost"])
    if bnb == "on" and util_batch == "level":
        # the compact host pass 2 took buckets: more passes than
        # dispatches, and those nodes count as host nodes
        assert c["semiring.bnb_passes"] > c["dpop.level_dispatches"]
        assert got["util_host_nodes"] > off["util_host_nodes"]


def test_solve_many_keeps_modes_apart():
    """A merged sweep mixing on, auto and off never shares a pruned
    kernel with an unpruned instance: each result equals its own solve."""
    dcops = [gen(tsecp, OVERLAP) for _ in range(3)]
    params = [{"util_device": "always", "bnb": b} for b in ("on", "auto",
                                                            "off")]
    many = tapi.solve_many(dcops, "dpop", params, device=CPU)
    for d, p, r in zip(dcops, params, many):
        one = tapi.solve(d, "dpop", p, pad_policy="pow2", device=CPU)
        assert (r["assignment"], r["cost"]) == (one["assignment"],
                                                one["cost"])
    c = counters(many[0])
    assert c["semiring.bnb_passes"] > 0 and c["semiring.bnb_skipped_small"]


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_low_precision_pruning_stays_conservative(dt):
    """The budget's slack widens to the storage eps (and int8's grid
    bound): pruned bf16/int8 runs equal the host f64 oracle."""
    jd, td = both(hard_band, 10, 5, ties=True)
    oracle = japi.solve(jd, "dpop", {"util_device": "never"})
    params = {"util_device": "always", "bnb": "on", "table_dtype": dt}
    got = tapi.solve(td, "dpop", params, pad_policy="pow2", device=CPU)
    want = japi.solve(jd, "dpop", params, pad_policy="pow2")
    assert (got["cost"], got["assignment"]) == (oracle["cost"],
                                                oracle["assignment"])
    assert counters(got)["semiring.bnb_passes"] > 0
    assert counters(got) == counters(want)


def test_sparse_pruned_equals_dense_and_jax():
    params = {"util_device": "always", "bnb": "on"}
    dense = tapi.solve(gen(tts, TASKS), "dpop", params, pad_policy="pow2",
                       device=CPU)
    sp = dict(params, table_format="sparse")
    got = tapi.solve(gen(tts, TASKS), "dpop", sp, pad_policy="pow2",
                     device=CPU)
    want = japi.solve(gen(jts, TASKS), "dpop", sp, pad_policy="pow2")
    assert (got["cost"], got["assignment"]) == (dense["cost"],
                                                dense["assignment"])
    assert (got["cost"], got["assignment"]) == (want["cost"],
                                                want["assignment"])
    assert counters(got) == counters(want)
    assert counters(got)["semiring.sparse_nodes"] > 0
    assert counters(got)["semiring.bnb_passes"] > 0


def test_budgeted_pruned_equals_unbounded():
    """A budgeted pruned run is bit-identical to the unbounded one, with
    the planner's sizing unchanged by the pruning."""
    p = {"util_device": "always", "bnb": "on"}
    free = tapi.solve(gen(tsecp, OVERLAP), "dpop", p, device=CPU)
    cut = tapi.solve(gen(tsecp, OVERLAP), "dpop", p, max_util_bytes=64,
                     device=CPU)
    off = tapi.solve(gen(tsecp, OVERLAP), "dpop", dict(p, bnb="off"),
                     max_util_bytes=64, device=CPU)
    want = japi.solve(gen(jsecp, OVERLAP), "dpop", p, max_util_bytes=64)
    assert (cut["cost"], cut["assignment"]) == (free["cost"],
                                                free["assignment"])
    assert cut["membound"] == off["membound"] == want["membound"]
    assert cut["membound"]["cut_lanes"] > 1
    assert counters(cut) == counters(want)


# -- inference --------------------------------------------------------------


@pytest.mark.parametrize("query", ["map", "kbest:5", "log_z", "marginals",
                                   "expectation"])
def test_infer_on_matches_jax_and_host(query):
    jd, td = both(hard_band, 9, 4, d=4, arity=4)
    kw = dict(device="always", tol=1e-3, pad_policy="pow2")
    want = japi.infer(jd, query, bnb="on", **kw)
    got = tapi.infer(td, query, bnb="on", torch_device=CPU, **kw)
    off = tapi.infer(td, query, bnb="off", torch_device=CPU, **kw)
    host = tapi.infer(td, query, device="never", torch_device=CPU)
    assert counters(got) == counters(want)
    assert counters(got)["semiring.bnb_pruned_cells"] > 0
    if query in ("map", "kbest:5"):
        for k in ("assignment", "cost", "costs", "solutions"):
            if k in want:
                assert got[k] == want[k] == off[k], k
        return
    np.testing.assert_allclose(got["error_bound"], want["error_bound"],
                               rtol=1e-6)
    err = got["error_bound"] + 1e-9
    key = "e_cost" if query == "expectation" else "log_z"
    np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    assert abs(got["log_z"] - host["log_z"]) <= err
    if query == "marginals":
        for v, p in host["marginals"].items():
            assert np.max(np.abs(np.subtract(got["marginals"][v], p))) <= err
    if query == "expectation":
        assert abs(got["e_cost"] - host["e_cost"]) <= err * max(
            1.0, abs(host["e_cost"])) * 10


def test_infer_many_and_cli_take_bnb(capsys):
    from pydcop_tpu_torch.cli import main as tmain

    jd, td = both(hard_band, 9, 4, d=4, arity=4)
    kw = dict(device="always", pad_policy="pow2")
    many = tapi.infer_many([td, td], "map", bnb="on", torch_device=CPU, **kw)
    one = tapi.infer(td, "map", bnb="on", torch_device=CPU, **kw)
    assert many[0]["assignment"] == one["assignment"]
    assert counters(many[0])["semiring.bnb_passes"] > 0
    import json
    import tempfile

    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

    with tempfile.NamedTemporaryFile("w", suffix=".yaml") as f:
        f.write(dcop_yaml(td))
        f.flush()
        assert tmain(["infer", f.name, "-q", "map", "--bnb", "on",
                      "--device", "always", "--torch_device", "cpu"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["assignment"] == one["assignment"]
        assert tmain(["solve", f.name, "-a", "dpop", "--bnb", "on",
                      "-p", "util_device:always", "--device", "cpu"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["cost"] == one["cost"]


def test_auto_skips_small_dispatches_as_jax():
    jd, td = both(hard_band, 8, 9, d=3, arity=3)
    p = {"util_device": "always", "bnb": "auto"}
    want = japi.solve(jd, "dpop", p, pad_policy="pow2")
    got = tapi.solve(td, "dpop", p, pad_policy="pow2", device=CPU)
    assert counters(got) == counters(want)
    assert counters(got)["semiring.bnb_skipped_small"] >= 1
    assert "semiring.bnb_passes" not in counters(got)
    wi = japi.infer(jd, "log_z", device="always")
    gi = tapi.infer(td, "log_z", device="always", torch_device=CPU)
    assert counters(gi) == counters(wi)


# -- Max-Sum ------------------------------------------------------------------


def test_bp_factor_messages_bnb_bit_equal():
    """Ternary, tie-heavy, ``+inf`` cells, two restarts: the pruned
    messages equal the unpruned ones and the JAX package's, bit for
    bit."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    k, d, m = 3, 4, 6
    tab = np.round(rng.uniform(0, 4, size=(d,) * k + (m,)), 1)
    tab[tab > 3.5] = np.inf
    tab = tab.astype(np.float32)
    qs = [np.round(rng.uniform(0, 2, size=(2, d, m)), 1).astype(np.float32)
          for _ in range(k)]
    tt = torch.from_numpy(tab)
    base = tsr.bp_factor_messages(
        "min_sum", tt, [torch.from_numpy(q) for q in qs], torch.float32)
    pruned = tsr.bp_factor_messages(
        "min_sum", tt, [torch.from_numpy(q) for q in qs], torch.float32,
        bnb=True)
    for r in range(2):
        want = jsr.bp_factor_messages(
            jsr.MIN_SUM, jnp.asarray(tab), [jnp.asarray(q[r]) for q in qs],
            jnp.float32, bnb=True)
        for b, p, w in zip(base, pruned, want):
            assert torch.equal(b, p)
            assert np.array_equal(p[r].numpy(), np.asarray(w))


def test_maxsum_generic_path_bnb_on_equals_off():
    """A ternary bucket (outside the factor-kernel gate) with ``bnb``
    on: every round's messages equal the unpruned run's."""
    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.engine.batched import run_batched
    from pydcop_tpu_torch.ops.compile import compile_dcop

    _, td = both(hard_band, 10, 2, d=3, arity=3, stride=1)
    problem = compile_dcop(td, device=CPU)
    mod = load_algorithm_module("maxsum")
    runs = [
        run_batched(problem, mod, prepare_algo_params(
            {"bnb": b, "noise": 0.0}, mod.algo_params), rounds=12,
            return_state=True)
        for b in ("on", "off")
    ]
    for key in ("q", "r", "values"):
        assert torch.equal(runs[0].state[key], runs[1].state[key])
    assert runs[0].cost_trace.tolist() == runs[1].cost_trace.tolist()
