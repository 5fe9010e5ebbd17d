"""The port's replicated serving fleet (``engine/fleet.py``,
``commands/fleet.py``) against the JAX package's, on the CPU.

The ring placement is a pure function of the replica names and the key
(``blake2b``), so the port's ``HashRing``, ``ring_key`` and
``standby_map`` must equal the JAX package's exactly.  An in-process
``FleetRouter`` in front of two port ``ServiceServer``s (``device="cpu"``)
re-pins a killed owner's session to its standby with results equal to an
undisturbed service, replays an answered request by its idempotency key
exactly once, and answers the fleet ops; the ``fleet`` command spawns
``python -m pydcop_tpu_torch serve --device cpu`` replicas and survives a
seeded ``replica_kill``.  Every subprocess wait is bounded.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from pydcop_tpu.engine import fleet as jax_fleet  # noqa: E402

from pydcop_tpu_torch.engine.fleet import (  # noqa: E402
    FleetError,
    FleetRouter,
    HashRing,
    ring_key,
    standby_map,
)
from pydcop_tpu_torch.engine.service import (  # noqa: E402
    ServiceClient,
    ServiceServer,
    SolverService,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: session segments are tiny on purpose — determinism, not quality
SKW = dict(rounds=8, chunk_size=8, seed=5)

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


def _svc(**kw):
    kw.setdefault("max_batch", 1)
    kw.setdefault("max_wait", 0.0)
    return SolverService(autostart=False, device="cpu", **kw)


def _seg(svc, sv=None, name="plant"):
    first = name not in svc._sessions and name not in svc._standby_sessions
    return svc.solve(
        SENSOR_YAML if first else None, "maxsum", {"damping": 0.5},
        session=name, set_values=sv, **SKW,
    )


def _addr(server) -> str:
    return "%s:%d" % server.address


def _raw_call(address, frame, timeout=60):
    host, _, port = address.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.sendall((json.dumps(frame) + "\n").encode("utf-8"))
        line = s.makefile("rb").readline()
    return json.loads(line)


# -- the ring: equal to the JAX package's ------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_ring_placement_equals_jax(n):
    names = [f"r{i}" for i in range(n)]
    ring, jring = HashRing(names), jax_fleet.HashRing(list(reversed(names)))
    keys = [f"s:sess-{i}" for i in range(300)] + [f"d:{i:064x}" for i in range(50)]
    assert [ring.lookup(k) for k in keys] == [jring.lookup(k) for k in keys]
    for name in names:
        for k in range(1, n + 1):
            assert ring.successors(name, k) == jring.successors(name, k)
        assert ring.successor(name) == jring.successor(name)
        dead_sets = [frozenset(), frozenset({name}),
                     frozenset(names[: max(n - 1, 0)])]
        for dead in dead_sets:
            if dead >= set(names):
                continue
            assert ring.next_alive(name, dead) == jring.next_alive(name, dead)
    for k in range(1, 4):
        assert standby_map(names, k=k) == jax_fleet.standby_map(names, k=k)
    with pytest.raises(FleetError, match="all marked dead"):
        ring.next_alive(names[0], frozenset(names))


@pytest.mark.parametrize("frame", [
    {"op": "solve", "session": "plant", "dcop": "x"},
    {"op": "solve", "session": "plant"},
    {"op": "solve", "dcop": SENSOR_YAML},
    {"op": "infer", "dcop": "yaml-b"},
    {"op": "solve"},
])
def test_ring_key_equals_jax(frame):
    assert ring_key(frame) == jax_fleet.ring_key(frame)


def test_router_pick_owner_is_sticky_then_walks_the_chain():
    router = FleetRouter({"r0": "h:1", "r1": "h:2", "r2": "h:3"},
                         autostart=False)
    try:
        key = "s:plant"
        home = router.ring.lookup(key)
        assert home == jax_fleet.HashRing(["r0", "r1", "r2"]).lookup(key)
        assert router._pick_owner(key, None, frozenset()) == home
        prev = router.ring.successor(home)
        assert router._pick_owner(key, prev, frozenset()) == prev
        assert (router._pick_owner(key, prev, frozenset({prev}))
                == router.ring.successor(prev))
    finally:
        router.close()


def test_router_health_degrades_and_revives():
    router = FleetRouter({"r0": "h:1", "r1": "h:2"}, autostart=False)
    try:
        assert router.health()["status"] == "ok"
        router.mark_dead("r0")
        h = router.health()
        assert h["status"] == "degraded" and h["fleet"] is True
        assert h["replicas"]["r0"]["alive"] is False
        router.mark_dead("r1")
        assert router.health()["status"] == "down"
        router.mark_alive("r0")
        assert router.dead() == ["r1"]
        assert router.stats()["revived"] == 1
    finally:
        router.close()


# -- the in-process router in front of two port replicas --------------


def _mutual_pair():
    p, s = _svc(), _svc()
    p.start()
    s.start()
    p_srv, s_srv = ServiceServer(p, port=0), ServiceServer(s, port=0)
    p.set_standbys([_addr(s_srv)])
    s.set_standbys([_addr(p_srv)])
    return (p, p_srv), (s, s_srv)


def test_router_replays_by_ikey_and_answers_fleet_ops():
    with _svc() as svc:
        with ServiceServer(svc, port=0) as srv:
            with FleetRouter({"r0": _addr(srv)}) as router:
                addr = "%s:%d" % router.address
                assert _raw_call(addr, {"op": "ping", "id": 1}) == {
                    "ok": True, "pong": True, "fleet": True, "id": 1}
                frame = {
                    "op": "solve", "id": 2, "cid": "t",
                    "ikey": "t:router:1", "dcop": SENSOR_YAML,
                    "algo": "maxsum", "params": {"damping": 0.5}, **SKW,
                }
                r1 = _raw_call(addr, frame)
                assert r1["ok"]
                r2 = _raw_call(addr, frame)
                assert {k: v for k, v in r2.items() if k != "id"} == {
                    k: v for k, v in r1.items() if k != "id"}
                assert svc.stats()["requests"] == 1
                stats = router.stats()
                assert stats["replayed_replies"] == 1
                assert stats["requests"] == 2
                doc = _raw_call(addr, {"op": "stats", "id": 3})
                assert doc["stats"]["fleet"]["replicas"] == 1
                assert "r0" in doc["stats"]["replicas"]
                bad = _raw_call(addr, {"op": "nope", "id": 4})
                assert not bad["ok"] and "unknown op" in bad["error"]


def test_router_failover_repins_session_and_replays_exactly_once():
    """The owner answers segment 1 (its reply replicated onto the
    standby before it leaves), then dies: a retry of the SAME frame
    through the router is answered from the standby's replicated reply
    cache, and the follow-ups re-pin to the standby and continue the
    segment sequence with results equal to an undisturbed service."""
    (a_svc, a_srv), (b_svc, b_srv) = _mutual_pair()
    try:
        with FleetRouter({"r0": _addr(a_srv), "r1": _addr(b_srv)}) as router:
            addr = "%s:%d" % router.address
            owner = router.ring.lookup("s:plant")
            victim_svc, victim_srv = {"r0": (a_svc, a_srv),
                                      "r1": (b_svc, b_srv)}[owner]
            standby_svc = b_svc if victim_svc is a_svc else a_svc
            frame = {
                "op": "solve", "id": 1, "cid": "t", "ikey": "t:eo:1",
                "dcop": SENSOR_YAML, "algo": "maxsum",
                "params": {"damping": 0.5}, "session": "plant", **SKW,
            }
            r1 = _raw_call(addr, frame)
            assert r1["ok"] and r1["result"]["segment"] == 1
            victim_srv.close()
            victim_svc.close()
            with router._lock:
                router._replies.clear()
            r1b = _raw_call(addr, frame)
            assert {k: v for k, v in r1b.items() if k != "id"} == {
                k: v for k, v in r1.items() if k != "id"}
            assert standby_svc.stats()["requests"] == 0
            with ServiceClient(addr, retry_window=30.0) as cli:
                r2 = cli.solve(algo="maxsum", params={"damping": 0.5},
                               session="plant", set_values={"sensor": 2},
                               **SKW)
                r3 = cli.solve(algo="maxsum", params={"damping": 0.5},
                               session="plant", set_values={"sensor": 1},
                               **SKW)
                assert (r2["segment"], r3["segment"]) == (2, 3)
                assert cli.close_session("plant") is True
            assert standby_svc.stats()["sessions_promoted"] == 1
            stats = router.stats()
            assert stats["failovers"] >= 1
            assert stats["dead"] == [owner]
        with _svc() as control:
            _seg(control)
            ref2 = _seg(control, {"sensor": 2})
            ref3 = _seg(control, {"sensor": 1})
        for got, ref in ((r2, ref2), (r3, ref3)):
            assert got["cost"] == ref["cost"]
            assert got["assignment"] == ref["assignment"]
    finally:
        for svc, srv in ((a_svc, a_srv), (b_svc, b_srv)):
            srv.close()
            svc.close()


# -- the fleet command -------------------------------------------------


@pytest.mark.parametrize("argv,match", [
    (["fleet", "--chaos", "conn_drop=0.5"], "serve --chaos"),
    (["fleet", "--chaos", "device_oom=4"], "serve --chaos"),
    (["fleet", "--chaos", "drop=0.5"], "run/agent"),
    (["fleet", "--chaos", "replica_kill=1", "--attach", "127.0.0.1:1"],
     "does not own attached"),
    (["fleet", "--replicas", "0"], "replicas must be"),
    (["fleet", "--resilience", "0"], "resilience must be"),
    (["fleet", "--attach", "nonsense"], "not host:port"),
])
def test_fleet_cli_rejects_as_jax(argv, match):
    from pydcop_tpu.cli import main as jax_main

    from pydcop_tpu_torch.cli import main

    msgs = []
    for fn in (jax_main, main):
        with pytest.raises(SystemExit, match=match) as info:
            fn(argv)
        msgs.append(str(info.value))
    assert msgs[1] == msgs[0]


def test_fleet_cli_refuses_compile_cache():
    from pydcop_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="compile_cache"):
        main(["fleet", "--compile_cache", "/nowhere"])


def _read_head(proc, timeout):
    import queue
    import threading

    box = queue.Queue()
    threading.Thread(target=lambda: box.put(proc.stdout.readline()),
                     daemon=True).start()
    try:
        return box.get(timeout=timeout)
    except queue.Empty:
        return ""


def test_fleet_subprocess_survives_replica_kill():
    """``fleet --replicas 2 --device cpu`` with ``replica_kill`` pinned
    on the session's owner: the session's follow-up after the kill is
    answered by the standby, equal to an undisturbed service, and the
    router's ``/healthz`` shows the victim dead."""
    from pydcop_tpu_torch.telemetry.export import http_get

    owner = HashRing(["r0", "r1"]).lookup("s:plant")
    kill_after = 6.0
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pydcop_tpu_torch", "fleet",
         "--replicas", "2", "--device", "cpu", "--port", "0",
         "--metrics_port", "0", "--max_batch", "1", "--max_wait", "0",
         "--health_interval", "0.1",
         "--chaos", f"replica_kill={kill_after}:{owner[1:]}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )
    try:
        line = _read_head(proc, 90)
        assert line, "fleet printed no head line"
        head = json.loads(line)
        t_up = time.monotonic()
        with ServiceClient(head["fleet"], retry_window=60.0) as cli:
            r1 = cli.solve(SENSOR_YAML, "maxsum", {"damping": 0.5},
                           session="plant", timeout=60, **SKW)
            r2 = cli.solve(algo="maxsum", params={"damping": 0.5},
                           session="plant", set_values={"sensor": 2},
                           timeout=60, **SKW)
            assert (r1["segment"], r2["segment"]) == (1, 2)
            deadline = t_up + kill_after + 30.0
            health = None
            while time.monotonic() < deadline:
                health = json.loads(
                    http_get(f"http://{head['metrics']}/healthz", timeout=5))
                if not health["replicas"][owner]["alive"]:
                    break
                time.sleep(0.2)
            assert health["replicas"][owner]["alive"] is False, health
            r3 = cli.solve(algo="maxsum", params={"damping": 0.5},
                           session="plant", set_values={"sensor": 1},
                           timeout=60, **SKW)
            assert r3["segment"] == 3
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    with _svc() as control:
        _seg(control)
        _seg(control, {"sensor": 2})
        ref = _seg(control, {"sensor": 1})
    assert r3["cost"] == ref["cost"]
    assert r3["assignment"] == ref["assignment"]
