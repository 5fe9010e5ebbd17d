"""The port's serving wire and observability: the JAX package's
``ServiceClient`` against the port's ``ServiceServer`` and the port's
client against the JAX server (equal replies both ways), idempotent
replay under the wire chaos kinds, malformed frames, the metrics
exporter, the flight recorder and ``flight-dump``, ``top``, the
``trace-summary --requests`` stitch, and ``serve`` as a process.

Everything runs in threads on loopback, except the two ``serve``
subprocess tests, which wait at most 60 s (``communicate(timeout=60)``)
and kill the process in ``finally``.
"""

import json
import os
import select
import signal
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from pydcop_tpu.engine import service as jservice  # noqa: E402
from pydcop_tpu.telemetry import flightrec as jflight  # noqa: E402

from pydcop_tpu_torch import telemetry as ttel  # noqa: E402
from pydcop_tpu_torch.cli import main  # noqa: E402
from pydcop_tpu_torch.engine import service as tservice  # noqa: E402
from pydcop_tpu_torch.telemetry import export, flightrec  # noqa: E402

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = open(os.path.join(REPO, "examples", "graph_coloring_3.yaml")).read()
SENSOR_YAML = """name: ext
objective: min
domains:
  colors: {values: [0, 1, 2]}
variables:
  v0: {domain: colors}
  v1: {domain: colors}
  v2: {domain: colors}
external_variables:
  sensor: {domain: colors, initial_value: 0}
constraints:
  c0: {type: intention, function: '1 if v0 == v1 else 0'}
  c1: {type: intention, function: '1 if v1 == v2 else 0'}
  track: {type: intention, function: '0 if v0 == sensor else 1'}
agents: [a1]
"""
TIMING = ("time", "util_time", "phases", "queue_wait")


@pytest.fixture(autouse=True)
def no_session_left():
    assert ttel._active is None
    yield
    assert ttel._active is None


def _service(mod, **kw):
    kw.setdefault("max_batch", 1)
    kw.setdefault("max_wait", 0.0)
    if mod is tservice:
        kw["device"] = CPU
    return mod.SolverService(**kw)


def _exchange(client_mod, address):
    """One fixed conversation; returns the replies minus timing."""
    out = []
    with client_mod.ServiceClient(address, timeout=60, client_id="w0",
                                  retry_window=0) as c:
        out.append(c.ping())
        out.append(sorted(c.stats()))
        for algo, params in (("dpop", {}), ("syncbb", {})):
            r = c.solve(RING, algo, params)
            out.append({k: v for k, v in r.items() if k not in TIMING})
        r = c.infer(RING, "kbest:2")
        out.append({k: v for k, v in r.items() if k not in TIMING})
        r = c.solve(SENSOR_YAML, "dpop", {}, session="s1")
        out.append({k: v for k, v in r.items() if k not in TIMING})
        out.append(c.close_session("s1"))
        out.append(c.close_session("s1"))
        with pytest.raises(client_mod.ServiceError, match="unknown"):
            c._call("nosuchop")
    return out


@pytest.mark.parametrize("server_mod", [tservice, jservice],
                         ids=["port-server", "jax-server"])
def test_both_clients_get_equal_replies_from_either_server(server_mod):
    with _service(server_mod) as svc:
        with server_mod.ServiceServer(svc) as server:
            addr = "%s:%d" % server.address
            via_jax = _exchange(jservice, addr)
            via_port = _exchange(tservice, addr)
    assert via_port == via_jax
    assert via_port[0] is True and via_port[-1] is False


def test_port_and_jax_servers_answer_alike():
    replies = {}
    for mod in (tservice, jservice):
        with _service(mod) as svc, mod.ServiceServer(svc) as server:
            replies[mod] = _exchange(tservice, "%s:%d" % server.address)
    port, jax = replies[tservice], replies[jservice]
    assert port[1] == jax[1]  # the stats keys
    for p, j in zip(port[2:6], jax[2:6]):
        assert set(p) - {"telemetry"} == set(j) - {"telemetry"}
        for k in ("status", "cost", "assignment", "costs", "session",
                  "segment", "memo", "trace", "instances_batched"):
            assert p.get(k) == j.get(k), k


def test_malformed_frame_gets_a_structured_error_and_the_link_survives():
    with _service(tservice) as svc, tservice.ServiceServer(svc) as server:
        with socket.create_connection(server.address, timeout=30) as s:
            r = s.makefile("rb")
            s.sendall(b"{not json\n")
            err = json.loads(r.readline())
            assert err["ok"] is False and err["frame_rejected"] is True
            s.sendall(b'["a list"]\n')
            assert "not a JSON object" in json.loads(r.readline())["error"]
            s.sendall(b'{"op": "ping", "id": 7}\n')
            assert json.loads(r.readline()) == {
                "ok": True, "pong": True, "id": 7,
            }
        assert svc.stats()["frames_rejected"] == 2


@pytest.mark.parametrize("chaos,fault", [
    ("conn_drop=1:1", "fault.conn_drop"),
    ("frame_corrupt=1:1,slow_client=0.01", "fault.frame_corrupt"),
])
def test_wire_chaos_reply_is_replayed_never_resolved(chaos, fault):
    with ttel.session() as tel:
        with _service(tservice, autostart=False, chaos=chaos,
                      chaos_seed=5) as svc:
            with tservice.ServiceServer(svc) as server:
                with tservice.ServiceClient(
                    server.address, timeout=60, client_id="c0",
                    retry_window=30.0,
                ) as cli:
                    assert cli.ping()  # reply 1 of the connection: exempt
                    r = cli.solve(RING, "mgm", {}, seed=1, rounds=8)
                    assert r["status"] == "finished"
                stats = svc.stats()
        counters = tel.summary()["counters"]
    assert stats["requests"] == 1  # the retry never re-solved
    assert stats["replayed_replies"] >= 1
    assert counters["service.client_retries"] >= 1
    assert counters[fault] >= 1


def test_exporter_flight_dump_top_and_request_stitch(tmp_path, capsys):
    dump = str(tmp_path / "flight.json")
    client_trace = str(tmp_path / "c.jsonl")
    server_trace = str(tmp_path / "s.jsonl")
    with ttel.session(server_trace) as tel:
        svc = _service(tservice, max_queue=1, autostart=False,
                       flight_dump=dump)
        server = tservice.ServiceServer(svc)
        exporter = export.MetricsExporter(
            tel.metrics.snapshot, svc.health, port=0
        )
        try:
            # a shed is a flight trigger: the dump names its trace id
            svc.submit(RING, "maxsum", {}, rounds=8)
            shed = svc.submit(RING, "maxsum", {}, rounds=8).result(0)
            assert shed["status"] == "shed"
            doc = flightrec.load_dump(dump)
            assert doc["trigger"] == "shed"
            assert doc["trace_id"] == shed["trace"]
            # the JAX package's reader takes the port's dump
            assert jflight.load_dump(dump)["trace_id"] == shed["trace"]
            svc.start()
            addr = "http://%s:%d" % exporter.address
            metrics = export.parse_prometheus_text(
                export.http_get(addr + "/metrics")
            )
            assert metrics["pydcop_service_requests_total"] == (
                tel.metrics.snapshot()["counters"]["service.requests"]
            )
            health = json.loads(export.http_get(addr + "/healthz"))
            assert health["status"] == "ok" and health["shed"] == 1
            assert main(["top", "%s:%d" % exporter.address,
                         "--count", "1"]) == 0
            assert "requests" in capsys.readouterr().out
            with ttel.session(client_trace):
                with tservice.ServiceClient(server.address, timeout=60,
                                            client_id="c9") as c:
                    r = c.solve(RING, "maxsum", {}, rounds=8)
            assert sum(r["phases"].values()) > 0
        finally:
            svc.close()
            assert svc.health()["status"] == "drained"
            server.close()
            exporter.close()
    assert flightrec.load_dump(dump)["trigger"] == "drain"
    assert main(["flight-dump", dump, "--tail", "5"]) == 0
    assert "trigger='drain'" in capsys.readouterr().out
    assert main(["trace-summary", client_trace, server_trace,
                 "--requests"]) == 0
    out = capsys.readouterr().out
    assert r["trace"] in out and "1 server solve(s)" in out


def test_flight_ring_outlives_the_tracer_cap():
    rec = flightrec.FlightRecorder(maxlen=4)
    tr = ttel.Tracer(max_records=2)
    tr.flight = rec
    for i in range(6):
        tr.event(f"e{i}")
    assert tr.dropped == 4
    assert [r["name"] for r in rec.snapshot()] == ["e2", "e3", "e4", "e5"]
    with pytest.raises(RuntimeError, match="no flight recorder"):
        flightrec.NULL_FLIGHT.dump("x", "shed")


def _serve(*argv):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.Popen(
        [sys.executable, "-m", "pydcop_tpu_torch", "serve", "--port", "0",
         "--device", "cpu", "--max_wait", "0", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env,
    )


def _head(proc, timeout=60):
    """The serving line, waited for at most ``timeout`` seconds."""
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    assert ready, "serve printed no serving line in time"
    return json.loads(proc.stdout.readline())


def test_serve_wire_solve_then_sigterm_drains_and_prints_stats(tmp_path):
    ck = str(tmp_path / "sessions.json")
    proc = _serve("--session_checkpoint", ck, "-t", "60")
    try:
        head = _head(proc)
        with tservice.ServiceClient(head["serving"], timeout=30) as c:
            r = c.solve(SENSOR_YAML, "maxsum", {}, rounds=8,
                        session="plant")
        assert r["status"] == "finished" and r["segment"] == 1
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0
    stats = json.loads(err.strip().splitlines()[-1])["stats"]
    assert stats["requests"] == 1 and stats["drained"] is True
    assert json.load(open(ck))["sessions"][0]["name"] == "plant"


def test_serve_resume_continues_the_checkpointed_session(tmp_path):
    ck = str(tmp_path / "sessions.json")
    with _service(tservice, session_checkpoint=ck) as svc:
        for dcop, sv in ((SENSOR_YAML, None), (None, {"sensor": 1})):
            svc.submit(dcop, "maxsum", {}, rounds=8, session="plant",
                       set_values=sv).result(60)
    proc = _serve("--session_checkpoint", ck, "--resume", "-t", "60")
    try:
        head = _head(proc)
        assert head["sessions_restored"] == 1
        with tservice.ServiceClient(head["serving"], timeout=30) as c:
            r = c.solve(None, "maxsum", {}, rounds=8, session="plant",
                        set_values={"sensor": 2})
            c.shutdown()
        _, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0
    assert r["segment"] == 3 and r["status"] == "finished"
    assert json.loads(err.strip().splitlines()[-1])["stats"][
        "sessions_restored"] == 1
