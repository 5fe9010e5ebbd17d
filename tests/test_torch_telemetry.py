"""The port's telemetry against the JAX package's.

``pydcop_tpu_torch.api`` attaches the JAX package's ``telemetry`` block
to ``solve``, ``solve_many``, ``infer`` and ``infer_many`` results.  On
the same runs the counters and span names must be the JAX package's,
but for the ones that time XLA or its jitted-runner cache, which have no
counterpart in the port (``jit.*``, ``engine.runner_cache_*``, the
``jit-compile`` span and ``backend-compile`` event).  The
branch-and-bound counters (``semiring.bnb_*``) are compared with the
rest.  The port's trace files are read by the JAX package's trace
reader.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import pydcop_tpu.api as japi  # noqa: E402
from pydcop_tpu.telemetry import summary as jsummary  # noqa: E402

import pydcop_tpu_torch.api as tapi  # noqa: E402
from pydcop_tpu_torch import telemetry as ttel  # noqa: E402
from pydcop_tpu_torch.telemetry.metrics import (  # noqa: E402
    MetricsRegistry,
    percentiles_from_histogram,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = os.path.join(REPO, "examples", "graph_coloring_3.yaml")
BLOCK = {"phases", "events", "counters", "gauges", "histograms"}
NO_COUNTERPART = ("jit.", "engine.runner_cache_")
NO_COUNTERPART_SPANS = {"jit-compile"}


@pytest.fixture(autouse=True)
def no_session_left():
    """No test here starts or ends with a port session installed: the
    session is process-wide, so one left behind would leak counters into
    whichever test the worker runs next."""
    assert ttel._active is None
    yield
    assert ttel._active is None


def compared(block):
    """The counters and span names the port must reproduce."""
    counters = {
        k: v for k, v in block["counters"].items()
        if not k.startswith(NO_COUNTERPART)
    }
    return counters, set(block["phases"]) - NO_COUNTERPART_SPANS


RUNS = {
    # name: (JAX call, port call)
    "solve-maxsum": (
        lambda: japi.solve(RING, "maxsum", {"damping": 0.5}, rounds=30,
                           chunk_size=16),
        lambda: tapi.solve(RING, "maxsum", {"damping": 0.5}, rounds=30,
                           chunk_size=16, device="cpu"),
    ),
    "solve-dpop": (
        lambda: japi.solve(RING, "dpop", {"util_device": "always"}),
        lambda: tapi.solve(RING, "dpop", {"util_device": "always"},
                           device="cpu"),
    ),
    "solve_many-dpop": (
        lambda: japi.solve_many([RING, RING], "dpop",
                                {"util_device": "always"}),
        lambda: tapi.solve_many([RING, RING], "dpop",
                                {"util_device": "always"}, device="cpu"),
    ),
    "solve_many-mgm": (
        lambda: japi.solve_many([RING, RING], "mgm", rounds=20),
        lambda: tapi.solve_many([RING, RING], "mgm", rounds=20,
                                device="cpu"),
    ),
    "infer-log_z": (
        lambda: japi.infer(RING, "log_z", device="always"),
        lambda: tapi.infer(RING, "log_z", device="always",
                           torch_device="cpu"),
    ),
    "infer-marginals": (
        lambda: japi.infer(RING, "marginals", device="never"),
        lambda: tapi.infer(RING, "marginals", device="never",
                           torch_device="cpu"),
    ),
    "infer-kbest": (
        lambda: japi.infer(RING, "kbest:3", device="always"),
        lambda: tapi.infer(RING, "kbest:3", device="always",
                           torch_device="cpu"),
    ),
    "infer_many-map": (
        lambda: japi.infer_many([RING, RING], "map", device="always"),
        lambda: tapi.infer_many([RING, RING], "map", device="always",
                                torch_device="cpu"),
    ),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_counters_and_spans_equal_jax(name):
    jrun, trun = RUNS[name]
    want, got = jrun(), trun()
    if isinstance(want, list):
        assert all(r["telemetry"] is got[0]["telemetry"] for r in got)
        want, got = want[0], got[0]
    block = got["telemetry"]
    assert set(block) == BLOCK
    assert set(want["telemetry"]) == BLOCK
    assert compared(block) == compared(want["telemetry"])
    assert block["events"] == {}
    assert block["counters"]  # every run counts something


def test_trace_files_read_by_the_jax_trace_reader(tmp_path):
    """A JSONL and a Chrome trace of the port load through the JAX
    package's ``load_trace``/``summarize`` and render its ``semiring
    contractions`` block with cells/s."""
    for fmt in ("jsonl", "chrome"):
        path = str(tmp_path / f"t.{fmt}")
        r = tapi.infer(RING, "log_z", device="never", torch_device="cpu",
                       trace=path, trace_format=fmt)
        s = jsummary.summarize(jsummary.load_trace(path))
        assert s["phases"]["semiring.contract"]["count"] == 1
        text = jsummary.format_summary(s)
        assert "semiring contractions" in text
        assert "log_sum_exp" in text and "cells/s" in text
        assert s["metrics"]["counters"] == r["telemetry"]["counters"]
    path = str(tmp_path / "solve.jsonl")
    tapi.solve(RING, "maxsum", rounds=16, device="cpu", trace=path)
    s = jsummary.summarize(jsummary.load_trace(path))
    assert s["phases"]["cycle"]["count"] == 1
    assert s["metrics"]["counters"]["engine.rounds"] == 16


def test_session_nesting_and_restore(tmp_path):
    """A session without a path inside an active one reuses it; one with
    a path opens a fresh session and restores the outer one on exit."""
    assert ttel.get_metrics().enabled is False
    with ttel.session() as outer:
        with ttel.session() as inner:
            assert inner is outer
        tapi.solve(RING, "mgm", rounds=8, device="cpu")
        assert outer.metrics.snapshot()["counters"]["engine.rounds"] == 8
        path = str(tmp_path / "inner.jsonl")
        with ttel.session(path) as fresh:
            assert fresh is not outer
            assert ttel.get_tracer() is fresh.tracer
        assert ttel.get_tracer() is outer.tracer
        assert os.path.exists(path)
    assert ttel.get_tracer() is ttel.NULL_TRACER
    assert ttel.get_metrics() is ttel.NULL_METRICS


RAISING = {
    # name: a call that raises once its session is installed
    "solve-dpop-bnb-on": lambda: tapi.solve(
        RING, "dpop", {"bnb": "on"}, resume=True, device="cpu"),
    "solve_many-compile_cache": lambda: tapi.solve_many(
        [RING, RING], "mgm", rounds=4, compile_cache=object(),
        device="cpu"),
    "infer-max_util_bytes": lambda: tapi.infer(
        RING, "marginal_map", map_vars=["v1"], max_util_bytes=1 << 20,
        torch_device="cpu"),
    "infer-sparse": lambda: tapi.infer(
        RING, "log_z", table_format="sprase", torch_device="cpu"),
    "infer_many-typo": lambda: tapi.infer_many(
        [RING, RING], "kbset:3", torch_device="cpu"),
}


@pytest.mark.parametrize("name", sorted(RAISING))
def test_raising_calls_leave_no_session(name, tmp_path):
    """A call that raises restores what was installed before it: nothing
    at top level, the outer session inside one (which keeps collecting)."""
    with pytest.raises((NotImplementedError, ValueError)):
        RAISING[name]()
    assert ttel._active is None
    assert ttel.get_metrics() is ttel.NULL_METRICS
    with ttel.session(str(tmp_path / "outer.jsonl")) as outer:
        with pytest.raises((NotImplementedError, ValueError)):
            RAISING[name]()
        assert ttel._active is outer
        tapi.solve(RING, "mgm", rounds=4, device="cpu")
        assert outer.metrics.snapshot()["counters"]["engine.rounds"] == 4
    assert ttel._active is None


def test_record_cap_reports_dropped_records():
    with ttel.session() as sess:
        sess.tracer.max_records = 2
        for i in range(5):
            sess.tracer.event("e", i=i)
        out = sess.summary()
    assert out["dropped_records"] == 3
    assert out["events"] == {"e": 2}
    assert out["counters"]["telemetry.dropped_records"] == 3


def test_histograms_equal_jax():
    from pydcop_tpu.telemetry.metrics import MetricsRegistry as JReg

    t, j = MetricsRegistry(), JReg()
    for v in (0.0004, 0.003, 0.2, 0.2, 7.0, 100.0):
        t.observe("x", v)
        j.observe("x", v)
        t.inc("n", 2)
        j.inc("n", 2)
    t.gauge("g", 1.5)
    j.gauge("g", 1.5)
    assert t.snapshot() == j.snapshot()
    assert percentiles_from_histogram((1.0,), [0, 0]) == {
        "p50": 0.0, "p90": 0.0, "p99": 0.0}
