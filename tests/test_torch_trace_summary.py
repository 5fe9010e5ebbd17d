"""The port's trace reader (``telemetry/summary.py``) and ``trace-summary``
CLI against the JAX package's, on the same files.

The files: traces the port writes (a Max-Sum solve in JSONL and Chrome
format, an inference query, a ``solve_many`` call under device chaos), a
trace the JAX package writes, and hand-built JSONL traces of a client
and a server with ``client.request``/``client.attempt`` and
``service.request``/``service.queue-wait``/``service.dispatch`` spans
tagged with trace ids (there is no service in the port to write them).
``load_trace``, ``summarize``, ``format_summary``, ``stitch_requests``
and ``format_requests`` give equal values and text, and the CLI prints
the JAX command's text and ``--json``.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import pydcop_tpu.api as japi  # noqa: E402
import pydcop_tpu.telemetry.summary as jsum  # noqa: E402
from pydcop_tpu.cli import main as jax_main  # noqa: E402

import pydcop_tpu_torch.api as tapi  # noqa: E402
import pydcop_tpu_torch.telemetry.summary as tsum  # noqa: E402
from pydcop_tpu_torch.cli import main as port_main  # noqa: E402

CPU = "cpu"
EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
COLORING = os.path.join(EXAMPLES, "graph_coloring_3.yaml")


def _service_traces(d):
    """A client trace and a server trace of three requests: t1 retried
    once (its reply replayed), t2 and t3 coalesced into one dispatch,
    plus serving counters and a latency histogram."""
    client = [
        {"kind": "meta", "version": 1, "unix_t0": 1000.0, "pid": 1},
        {"kind": "span", "name": "client.attempt", "cat": "client",
         "t": 0.01, "dur": 0.2, "tid": 1,
         "args": {"trace": "t1", "attempt": 0, "error": "timeout"}},
        {"kind": "span", "name": "client.attempt", "cat": "client",
         "t": 0.3, "dur": 0.05, "tid": 1, "args": {"trace": "t1",
                                                   "attempt": 1}},
        {"kind": "span", "name": "client.request", "cat": "client",
         "t": 0.01, "dur": 0.34, "tid": 1,
         "args": {"trace": "t1", "status": "finished"}},
        {"kind": "span", "name": "client.request", "cat": "client",
         "t": 0.5, "dur": 0.12, "tid": 2,
         "args": {"trace": "t2", "status": "finished"}},
        {"kind": "event", "name": "client-retry", "cat": "client",
         "t": 0.25, "tid": 1, "args": {"trace": "t1", "agent": "c0"}},
    ]
    phases = {"admission": 0.001, "queue": 0.02, "compile": 0.0,
              "device": 0.05, "decode": 0.004, "reply_write": 0.001}
    server = [
        {"kind": "meta", "version": 1, "unix_t0": 1000.005, "pid": 2},
        {"kind": "span", "name": "service.queue-wait", "cat": "service",
         "t": 0.02, "dur": 0.02, "tid": 3, "args": {"trace": "t1"}},
        {"kind": "span", "name": "service.dispatch", "cat": "service",
         "t": 0.05, "dur": 0.06, "tid": 3,
         "args": {"trace": ["t1"], "instances": 1}},
        {"kind": "span", "name": "service.request", "cat": "service",
         "t": 0.02, "dur": 0.09, "tid": 3,
         "args": {"trace": "t1", "status": "finished", "phases": phases}},
        {"kind": "event", "name": "service-replay", "cat": "service",
         "t": 0.31, "tid": 3, "args": {"trace": "t1"}},
        {"kind": "span", "name": "service.queue-wait", "cat": "service",
         "t": 0.5, "dur": 0.01, "tid": 3, "args": {"trace": "t2"}},
        {"kind": "span", "name": "service.dispatch", "cat": "service",
         "t": 0.52, "dur": 0.07, "tid": 3,
         "args": {"trace": ["t2", "t3"], "instances": 2}},
        {"kind": "span", "name": "service.request", "cat": "service",
         "t": 0.5, "dur": 0.1, "tid": 3,
         "args": {"trace": "t2", "status": "finished"}},
        {"kind": "span", "name": "service.request", "cat": "service",
         "t": 0.51, "dur": 0.11, "tid": 3,
         "args": {"trace": "t3", "status": "degraded"}},
        {"kind": "span", "name": "service.drain", "cat": "service",
         "t": 0.9, "dur": 0.03, "tid": 3, "args": {}},
        {"kind": "event", "name": "device_oom", "cat": "fault",
         "t": 0.53, "tid": 3, "args": {"agent": "a1"}},
        {"kind": "metrics", "counters": {
            "service.shed": 2, "service.client_retries": 1,
            "service.replayed_replies": 1, "engine.chunks": 4},
         "gauges": {"service.queue_depth": 0},
         "histograms": {"service.latency_s": {
             "bounds": [0.01, 0.1, 1.0], "counts": [0, 2, 1, 0]}}},
    ]
    paths = []
    for name, recs in (("client.jsonl", client), ("server.jsonl", server)):
        p = os.path.join(d, name)
        with open(p, "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs) + "\n")
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("traces"))
    out = {}
    for fmt in ("jsonl", "chrome"):
        out[f"port-solve-{fmt}"] = p = os.path.join(d, f"solve.{fmt}")
        tapi.solve(COLORING, "maxsum", {"damping": 0.5}, rounds=24,
                   chunk_size=8, device=CPU, trace=p, trace_format=fmt)
    out["port-infer"] = p = os.path.join(d, "infer.jsonl")
    tapi.infer(COLORING, "log_z", device="always", torch_device=CPU,
               trace=p)
    out["port-many-chaos"] = p = os.path.join(d, "many.jsonl")
    tapi.solve_many([COLORING] * 3, "maxsum", rounds=16, chunk_size=8,
                    device=CPU, chaos="device_oom=2", chaos_seed=1, trace=p)
    for fmt in ("jsonl", "chrome"):
        out[f"jax-solve-{fmt}"] = p = os.path.join(d, f"jax.{fmt}")
        japi.solve(COLORING, "maxsum", {"damping": 0.5}, rounds=24,
                   chunk_size=8, trace=p, trace_format=fmt)
    out["client"], out["server"] = _service_traces(d)
    return out


NAMES = ["port-solve-jsonl", "port-solve-chrome", "port-infer",
         "port-many-chaos", "jax-solve-jsonl", "jax-solve-chrome",
         "client", "server"]


@pytest.mark.parametrize("name", NAMES)
def test_reader_and_summary_equal_jax(name, traces):
    path = traces[name]
    recs = tsum.load_trace(path)
    assert recs == jsum.load_trace(path)
    s = tsum.summarize(recs)
    assert s == jsum.summarize(recs)
    assert tsum.format_summary(s) == jsum.format_summary(s)
    if name.startswith("port-solve"):
        assert s["phases"]["cycle"]["count"] == 3
        assert s["metrics"]["counters"]["engine.rounds"] == 24
    if name == "server":
        assert s["service"]["requests"] == 3 and s["service"]["shed"] == 2
    if name == "port-infer":
        assert "semiring" in s


def test_port_trace_formats_give_equal_aggregates(traces):
    """The JSONL and Chrome traces of the same solve: equal counts and
    counters (timings differ from run to run)."""
    def counts(path):
        s = tsum.summarize(tsum.load_trace(path))
        return ({k: v["count"] for k, v in s["phases"].items()},
                s["events"], s["faults"], s["metrics"]["counters"])

    assert counts(traces["port-solve-jsonl"]) == counts(
        traces["port-solve-chrome"])


def test_stitch_requests_equal_jax(traces):
    sets = [tsum.load_trace(traces["client"]),
            tsum.load_trace(traces["server"])]
    got = tsum.stitch_requests(sets)
    assert got == jsum.stitch_requests(sets)
    assert (got["t1"]["attempts"], got["t1"]["server_requests"],
            got["t1"]["replays"]) == (2, 1, 1)
    assert tsum.format_requests(got) == jsum.format_requests(got)
    port_only = [tsum.load_trace(traces["port-solve-jsonl"])]
    assert tsum.stitch_requests(port_only) == {}
    assert tsum.format_requests({}) == jsum.format_requests({})
    assert tsum.percentiles_from_histogram([0.1, 1.0], [1, 3, 2]) == (
        jsum.percentiles_from_histogram([0.1, 1.0], [1, 3, 2]))


def _cli(main, argv, capsys):
    capsys.readouterr()
    rc = main(["trace-summary"] + argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("flags", [[], ["--json"]])
def test_cli_prints_the_jax_text(flags, traces, tmp_path, capsys):
    for name in NAMES:
        argv = [traces[name]] + flags
        assert _cli(port_main, argv, capsys) == _cli(jax_main, argv,
                                                     capsys), name
    argv = [traces["client"], traces["server"], "--requests"] + flags
    got = _cli(port_main, argv, capsys)
    assert got == _cli(jax_main, argv, capsys) and "t1" in got[1]
    out = tmp_path / "o.txt"
    _cli(port_main, [traces["server"], "--output", str(out)] + flags,
         capsys)
    assert out.read_text() == _cli(jax_main, [traces["server"]] + flags,
                                   capsys)[1]


def test_cli_errors_as_jax(traces, tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "meta"}\nnot json\n')
    for argv in ([traces["client"], traces["server"]],
                 [str(tmp_path / "missing.jsonl")], [str(empty)],
                 [str(bad)]):
        msgs = []
        for main in (jax_main, port_main):
            with pytest.raises(SystemExit) as e:
                main(["trace-summary"] + argv)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert msgs[1].startswith("trace-summary: ")
