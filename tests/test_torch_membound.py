"""The port's memory-bounded sweep (``ops/membound.py``) against the JAX
package's.

The same instances go through both packages on the CPU: the
consistency pruning and the cut planner (equal plans, including the
bench fixture where one byte budget makes f32 cut and bf16 not), whole
DPOP runs at every ``max_util_bytes`` × ``table_dtype`` ×
``table_format`` combination (cost, assignment, UTIL counts and the
``membound`` block equal), budgeted inference (map and kbest
bit-equal, log Z and marginals within ``error_bound``), and the OOM
re-plan rung: a device that runs out of memory above a byte capacity
makes the sweep re-plan at half the budget and still return the exact
answer.
"""

import importlib.util
import os
from argparse import Namespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pydcop_tpu.api as japi  # noqa: E402
from pydcop_tpu.commands.generators import secp as jsecp  # noqa: E402
from pydcop_tpu.dcop.yamldcop import dcop_yaml as jyaml  # noqa: E402
from pydcop_tpu.ops import membound as jmb  # noqa: E402
from pydcop_tpu.ops import semiring as jsr  # noqa: E402

import pydcop_tpu_torch.api as tapi  # noqa: E402
from pydcop_tpu_torch.commands.generators import secp as tsecp  # noqa: E402
from pydcop_tpu_torch.dcop.yamldcop import load_dcop as tload  # noqa: E402
from pydcop_tpu_torch.ops import membound as tmb  # noqa: E402
from pydcop_tpu_torch.ops import semiring as tsr  # noqa: E402
from pydcop_tpu_torch.ops.padding import as_pad_policy  # noqa: E402

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's membound control instance (64 models, zone 7, overlap 3,
# arity 4) cut to 16 lights and 10 models
OVERLAP = dict(
    nb_lights=16, nb_models=10, nb_rules=0, light_levels=4,
    model_arity=4, zone_size=7, zone_layout="overlap", zone_overlap=3,
    efficiency_weight=0.1, capacity=100.0, seed=7, hard_cap=1.1,
)


def overlap(gen):
    return gen.generate(Namespace(**OVERLAP))


def guard_band():
    """The recompile guard's overlap band (``tools/recompile_guard.py``)
    that bench.py's precision stage plans at 512 bytes: the JAX
    package's instance, and the port's from its YAML."""
    spec = importlib.util.spec_from_file_location(
        "recompile_guard_for_tests",
        os.path.join(REPO, "tools", "recompile_guard.py"),
    )
    guard = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(guard)
    band = guard._build_secp_overlap(12, 10, 3, seed=77)
    return band, tload(jyaml(band))


def counters(result):
    return {
        k: v for k, v in result["telemetry"]["counters"].items()
        if k.startswith(("semiring.", "dpop.", "membound.", "engine.oom"))
    }


# -- the planner ---------------------------------------------------------


def test_prune_plan_equals_jax():
    jp = jsr.build_plan(overlap(jsecp))
    tp = tsr.build_plan(overlap(tsecp))
    jc, jkeep, jlen = jmb.prune_plan(jp)
    tc, tkeep, tlen = tmb.prune_plan(tp)
    assert (tc, tlen) == (jc, jlen) and tc > 0
    assert all(np.array_equal(tkeep[v], jkeep[v]) for v in jkeep)
    assert tp.domains == jp.domains
    for v in jp.order:
        for (ts, tt), (js, jt) in zip(tp.buckets[v], jp.buckets[v]):
            assert ts == js and np.asarray(tt).tobytes() == (
                np.asarray(jt).tobytes())


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("budget", [64, 256, 1024])
@pytest.mark.parametrize("pad", ["none", "pow2"])
def test_plan_cut_equals_jax(pad, budget, dt, fmt):
    jp = jsr.build_plan(overlap(jsecp))
    tp = tsr.build_plan(overlap(tsecp))
    kw = dict(table_dtype=dt, table_format=fmt)
    try:
        want = jmb.plan_cut(jp, budget, as_pad_policy(pad), **kw)
    except jmb.MemboundError as e:
        with pytest.raises(tmb.MemboundError) as got:
            tmb.plan_cut(tp, budget, as_pad_policy(pad), **kw)
        assert str(got.value) == str(e)
        return
    got = tmb.plan_cut(tp, budget, as_pad_policy(pad), **kw)
    assert got.__dict__ == want.__dict__


def test_bench_fixture_f32_cuts_and_bf16_does_not():
    """bench.py's PREC_MB_BUDGET = 512 on the overlap band: f32 must
    condition a cut, bf16 and int8 (2x/4x the cells per byte) must not;
    every plan equal to the JAX package's, byte for byte."""
    jband, tband = guard_band()
    mbs = {}
    for dt in ("f32", "bf16", "int8"):
        p = {"util_device": "never", "table_dtype": dt}
        want = japi.solve(jband, "dpop", p, max_util_bytes=512,
                          pad_policy="pow2")
        got = tapi.solve(tband, "dpop", p, max_util_bytes=512,
                         pad_policy="pow2", device=CPU)
        assert got["membound"] == want["membound"]
        assert (got["cost"], got["assignment"]) == (
            want["cost"], want["assignment"])
        mbs[dt] = got["membound"]
    assert mbs["f32"]["cut_width"] > 0
    assert mbs["bf16"]["cut_width"] == mbs["int8"]["cut_width"] == 0


# -- whole runs ----------------------------------------------------------


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("budget", [None, 1024, 256])
def test_dpop_budget_dtype_format_equal_jax(budget, dt, fmt):
    params = {"util_device": "always", "table_dtype": dt,
              "table_format": fmt}
    want = japi.solve(overlap(jsecp), "dpop", params,
                      max_util_bytes=budget, pad_policy="pow2")
    got = tapi.solve(overlap(tsecp), "dpop", params, max_util_bytes=budget,
                     pad_policy="pow2", device=CPU)
    assert set(got) == set(want)
    for k in want:
        if k not in ("time", "util_time", "telemetry"):
            assert got[k] == want[k], k
    assert counters(got) == counters(want)


def test_dpop_bounded_equals_unbounded_and_host():
    dcop = overlap(tsecp)
    free = tapi.solve(dcop, "dpop", {"util_device": "always"}, device=CPU)
    host = tapi.solve(dcop, "dpop", {"util_device": "never"},
                      max_util_bytes=256, device=CPU)
    got = tapi.solve(dcop, "dpop", {"util_device": "always"},
                     max_util_bytes=256, pad_policy="pow2", device=CPU)
    assert got["membound"]["cut_width"] > 0
    assert got["membound"]["on_device"] and not host["membound"]["on_device"]
    for r in (host, got):
        assert (r["cost"], r["assignment"]) == (
            free["cost"], free["assignment"])


@pytest.mark.parametrize("query", ["map", "kbest:3", "log_z", "marginals",
                                   "expectation"])
def test_infer_bounded(query):
    kw = dict(device="always", pad_policy="pow2", max_util_bytes=512,
              tol=float("inf"))
    want = japi.infer(overlap(jsecp), query, **kw)
    got = tapi.infer(overlap(tsecp), query, torch_device=CPU, **kw)
    assert got["membound"] == want["membound"]
    assert got["membound"]["cut_width"] > 0
    assert counters(got) == counters(want)
    if query in ("map", "kbest:3"):
        for k in want:
            if k not in ("time", "telemetry"):
                assert got[k] == want[k], k
        return
    host = tapi.infer(overlap(tsecp), query, device="never",
                      torch_device=CPU)
    err = got["error_bound"]
    assert abs(got["log_z"] - host["log_z"]) <= err + 1e-9
    assert abs(got["log_z"] - want["log_z"]) <= err + want["error_bound"]
    if query == "marginals":
        for v, p in host["marginals"].items():
            assert np.allclose(got["marginals"][v], p, rtol=0, atol=err + 1e-9)


def test_unplannable_budget_and_marginal_map_raise():
    dcop = overlap(tsecp)
    with pytest.raises(tmb.MemboundError, match="max_util_bytes=8"):
        tapi.solve(dcop, "dpop", {"util_device": "always"},
                   max_util_bytes=8, device=CPU)
    with pytest.raises(ValueError, match="marginal_map cannot run"):
        tapi.infer(dcop, "marginal_map", map_vars=["l0000"],
                   max_util_bytes=512, torch_device=CPU)
    with pytest.raises(ValueError, match="must be > 0"):
        tapi.solve(dcop, "dpop", max_util_bytes=0, device=CPU)
    with pytest.raises(ValueError, match="memory_bound"):
        tapi.solve(dcop, "dpop", {"memory_bound": 64}, max_util_bytes=512,
                   device=CPU)
    with pytest.raises(ValueError, match="no such table"):
        tapi.solve(dcop, "mgm", max_util_bytes=512, device=CPU)


def test_device_oom_replans_at_half_budget(monkeypatch):
    """A device that runs out of memory for any dispatch whose parts
    exceed a byte capacity (the JAX package's ``device_oom_bytes``
    capacity model, on the port's dispatch): the stacked dispatch splits
    to nodes, a node that still does not fit re-plans the sweep at half
    the budget (``membound.replans``), and the answer does not move."""
    dcop = overlap(tsecp)
    kw = dict(max_util_bytes=1024, pad_policy="pow2", device=CPU)
    want = tapi.solve(dcop, "dpop", {"util_device": "always"}, **kw)
    inner = tsr._dispatch

    def capped(fn, parts, device):
        if sum(np.asarray(p).nbytes for p in parts) > 600:
            raise torch.cuda.OutOfMemoryError("simulated")
        return inner(fn, parts, device)

    monkeypatch.setattr(tsr, "_dispatch", capped)
    got = tapi.solve(dcop, "dpop", {"util_device": "always"}, **kw)
    assert got["membound"]["replans"] >= 1
    assert counters(got)["membound.replans"] == got["membound"]["replans"]
    assert got["membound"]["budget_bytes"] < 1024
    assert (got["cost"], got["assignment"]) == (
        want["cost"], want["assignment"])
