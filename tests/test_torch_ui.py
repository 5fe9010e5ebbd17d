"""The port's live observability feed (``pydcop_tpu_torch/infrastructure/
ui.py``) on the batched engine, on the CPU.

The cases of the JAX package's ``tests/test_ui.py`` on the port: an SSE
client follows a short solve chunk by chunk, ``solve(ui_port=...)`` serves
the feed end to end, and ``/state`` answers the latest event.  Against
the JAX package: the same run publishes the same cycles with the same
keys, and one published event is the same SSE frame and ``/state`` body
(``t``, the wall clock, apart).
"""

import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")


def _ring_dcop(n=12, pkg="pydcop_tpu_torch"):
    import importlib

    dcop_mod = importlib.import_module(f"{pkg}.dcop.dcop")
    objs = importlib.import_module(f"{pkg}.dcop.objects")
    rels = importlib.import_module(f"{pkg}.dcop.relations")
    dom = objs.Domain("colors", "", [0, 1, 2])
    dcop = dcop_mod.DCOP("ring")
    vs = [objs.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    eye = np.eye(3)
    for i in range(n):
        dcop.add_constraint(
            rels.NAryMatrixRelation([vs[i], vs[(i + 1) % n]], eye,
                                    name=f"c{i}")
        )
    return dcop


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _follow(port, events, ready):
    req = urllib.request.urlopen(f"http://localhost:{port}/events",
                                 timeout=30)
    ready.set()
    for raw in req:
        line = raw.decode().strip()
        if line.startswith("data: "):
            events.append(json.loads(line[6:]))


def _followed_run(pkg, rounds=64, chunk_size=8):
    """A client attached before a ``run_batched`` that publishes every
    chunk, then the final event: ``(events, result)``."""
    import importlib

    ui_mod = importlib.import_module(f"{pkg}.infrastructure.ui")
    algos = importlib.import_module(f"{pkg}.algorithms")
    run_batched = importlib.import_module(f"{pkg}.engine.batched").run_batched
    compile_dcop = importlib.import_module(f"{pkg}.ops.compile").compile_dcop

    port = _free_port()
    events = []
    ready = threading.Event()
    ui = ui_mod.UiServer(port)
    t = threading.Thread(target=_follow, args=(port, events, ready),
                         daemon=True)
    t.start()
    ready.wait(10)
    kw = {"device": "cpu"} if pkg == "pydcop_tpu_torch" else {}
    problem = compile_dcop(_ring_dcop(pkg=pkg), **kw)
    module = algos.load_algorithm_module("maxsum")
    params = algos.prepare_algo_params({}, module.algo_params)
    result = run_batched(
        problem, module, params, rounds=rounds, seed=1,
        chunk_size=chunk_size, chunk_callback=ui_mod.chunk_publisher(ui),
    )
    ui.publish(
        result.cycles, result.cost, result.best_cost,
        values=result.best_assignment, status=result.status,
    )
    ui.close()
    t.join(10)
    assert not t.is_alive()
    return events, result


def test_sse_client_follows_solve():
    events, result = _followed_run("pydcop_tpu_torch")
    assert len(events) >= 7  # interior chunk boundaries + final
    cycles = [e["cycle"] for e in events]
    assert cycles == sorted(cycles)  # monotone
    final = events[-1]
    assert final["cycle"] == 64
    assert final["cost"] == result.cost
    assert final["values"] == result.best_assignment
    assert final["status"] == "finished"


def test_solve_ui_port_end_to_end():
    from pydcop_tpu_torch.api import solve

    port = _free_port()
    collected = []

    def delayed_client():
        req = None
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            try:
                req = urllib.request.urlopen(
                    f"http://localhost:{port}/events", timeout=30
                )
                break
            except OSError:
                time.sleep(0.05)
        if req is None:
            return
        try:
            for raw in req:
                line = raw.decode().strip()
                if line.startswith("data: "):
                    collected.append(json.loads(line[6:]))
        except OSError:
            pass

    t = threading.Thread(target=delayed_client, daemon=True)
    t.start()
    # enough chunks that the client connects mid-run
    result = solve(
        _ring_dcop(), "maxsum", rounds=4_000, chunk_size=8, ui_port=port,
        device="cpu",
    )
    t.join(10)
    assert result["cost"] == 0.0
    assert collected, "client saw no events"
    assert collected[-1]["cycle"] == 4_000
    assert collected[-1]["values"] == result["assignment"]


def test_state_endpoint():
    from pydcop_tpu_torch.infrastructure.ui import UiServer

    ui = UiServer(0)
    try:
        ui.publish(5, 1.5, 1.0, values={"v0": 1})
        body = urllib.request.urlopen(
            f"http://localhost:{ui.port}/state", timeout=10
        ).read()
        snap = json.loads(body)
        assert snap["cycle"] == 5
        assert snap["values"] == {"v0": 1}
    finally:
        ui.close()


def test_event_stream_equals_jax():
    """The same run publishes the JAX package's cycles, keys, best costs
    and final status.  The final assignments may differ: Max-Sum's noise
    comes from each package's own random stream (ROADMAP C, 'Random
    streams')."""
    got, _ = _followed_run("pydcop_tpu_torch")
    want, _ = _followed_run("pydcop_tpu")

    def shape(events):
        return [(e["cycle"], sorted(e), e.get("status"), e["best_cost"])
                for e in events]

    assert shape(got) == shape(want)
    assert sorted(got[-1]["values"]) == sorted(want[-1]["values"])


def test_published_frame_equals_jax():
    """One event, published by each package's server: the same SSE frame
    and the same ``/state`` body, but the wall-clock ``t``."""
    from pydcop_tpu.infrastructure.ui import UiServer as JaxUiServer

    from pydcop_tpu_torch.infrastructure.ui import UiServer

    out = []
    for cls in (JaxUiServer, UiServer):
        ui = cls(0)
        try:
            ui.publish(7, 2.5, 1.0, values={"v0": 2, "v1": 0},
                       status="finished")
            state = json.loads(urllib.request.urlopen(
                f"http://localhost:{ui.port}/state", timeout=10).read())
            req = urllib.request.urlopen(
                f"http://localhost:{ui.port}/events", timeout=10)
            frame = req.readline() + req.readline()
            page = urllib.request.urlopen(
                f"http://localhost:{ui.port}/", timeout=10).read()
        finally:
            ui.close()
        state.pop("t")
        evt = json.loads(frame[len(b"data: "):])
        evt.pop("t")
        out.append((state, evt, frame.endswith(b"\n\n"),
                    b"EventSource" in page))
    assert out[0] == out[1]
    assert out[1][0]["status"] == "finished" and out[1][2] and out[1][3]
