"""The port's cross-process host runtime over TCP
(``pydcop_tpu_torch/infrastructure/hostnet.py``), on the CPU.

Every case of the JAX package's ``tests/test_hostnet.py`` runs here on the
port: the two-process ring for each protocol family, the ``solve(mode=
"process")`` embedding and its CLI, five processes placed by a strategy,
a dead peer, agent death, placement, the UI feed, SIGKILL recovery with
replicas and with islands, and the ``k_target`` refusals.  Agents with an
island take ``--device cpu``.  Against the JAX package, where the result
does not depend on timing: exact process runs (DPOP, SyncBB) equal the
JAX package's process runs and the port's sim runs; placements by
strategy and with replicas equal the JAX orchestrator's; the bytes on
the wire equal the JAX package's (module paths mapped, ROADMAP C
'Message log module names'); a process-mode MGM run with lockstep
islands equals the all-host sim run change for change.  Also here: the
faults C.3 (A-Max-Sum placements) and C.4 (the JAX keywords of the
backoff, the supervisor and the contraction sweep), and the refusal of
an island agent left on the default device on a machine without CUDA.

Ports come from binding port 0.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ring_yaml(n=8):
    lines = [
        "name: ring",
        "objective: min",
        "domains:",
        "  colors: {values: [0, 1, 2]}",
        "variables:",
    ]
    for i in range(n):
        lines.append(f"  v{i}: {{domain: colors}}")
    lines.append("constraints:")
    for i in range(n):
        j = (i + 1) % n
        lines.append(f"  c{i}:")
        lines.append("    type: intention")
        lines.append(f"    function: 1 if v{i} == v{j} else 0")
    lines.append(f"agents: [{', '.join(f'a{i}' for i in range(n))}]")
    return "\n".join(lines) + "\n"


def _parse_json_tail(text):
    start = text.index("{")
    return json.loads(text[start:])


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _listener():
    """A pre-bound control-plane server socket and its port."""
    server = socket.create_server(("", 0))
    return server, server.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _port_cmd(*args):
    return [sys.executable, "-m", "pydcop_tpu_torch", *args]


def _reap(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


def _connect(port):
    deadline = time.monotonic() + 20
    while True:
        try:
            return socket.create_connection(("localhost", port), timeout=5)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def _mapped(text):
    return text.replace("pydcop_tpu_torch.", "pydcop_tpu.")


# -- the JAX package's cases, on the port ------------------------------------


TWO_PROCESS_ALGOS = ["maxsum", "mgm", "mgm2", "dpop", "syncbb"]


@pytest.fixture(scope="module")
def two_process_runs(tmp_path_factory):
    """One orchestrator and two agent processes per algorithm, all
    started at once (each case then reads its own run)."""
    tmp = tmp_path_factory.mktemp("two_processes")
    yaml_file = tmp / "ring.yaml"
    yaml_file.write_text(_ring_yaml())
    env = _env()
    runs = {}
    for algo in TWO_PROCESS_ALGOS:
        port = _free_port()
        orch = subprocess.Popen(
            _port_cmd("orchestrator", str(yaml_file), "-a", algo,
                      "--runtime", "host", "--port", str(port),
                      "--nb_agents", "2", "--rounds", "200", "--seed", "3"),
            env=env, cwd=str(tmp),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        agents = [
            subprocess.Popen(
                _port_cmd("agent", "--names", name, "--runtime", "host",
                          "--orchestrator", f"localhost:{port}"),
                env=env, cwd=str(tmp),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for name in ("a1", "a2")
        ]
        runs[algo] = (orch, agents)
    yield runs
    for orch, agents in runs.values():
        _reap([orch, *agents])


@pytest.mark.parametrize("algo", TWO_PROCESS_ALGOS)
def test_host_runtime_two_processes(two_process_runs, algo):
    """2 agent processes solve a ring to its optimum over TCP, one
    protocol family each: quiescence (maxsum), round-synchronized local
    search (mgm, 5-phase mgm2), pseudo-tree waves (dpop), the ordered
    bound token (syncbb)."""
    orch, agents = two_process_runs[algo]
    orc_out, orc_err = orch.communicate(timeout=180)
    assert orch.returncode == 0, orc_err[-3000:]
    result = _parse_json_tail(orc_out)
    assert result["cost"] == 0.0
    assert result["status"] in ("finished", "msg_budget")
    assert set(result["assignment"]) == {f"v{i}" for i in range(8)}
    assert sorted(result["agents"]) == ["a1", "a2"]
    placement = result["placement"]
    assert placement["a1"] and placement["a2"]
    assert result["msg_count"] > 0
    for a in agents:
        _, a_err = a.communicate(timeout=30)
        assert a.returncode == 0, a_err[-3000:]


def test_solve_mode_process_embedding(tmp_path):
    """``solve(mode='process')`` forks local agent OS processes and
    returns the assembled result, through the API and the CLI."""
    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop

    yaml_file = tmp_path / "ring9.yaml"
    yaml_file.write_text(_ring_yaml(9))
    proc = subprocess.Popen(  # the CLI run goes on beside the API run
        _port_cmd("solve", str(yaml_file), "-a", "maxsum", "--mode",
                  "process", "--nb_agents", "2", "--rounds", "300",
                  "--seed", "1"),
        env=_env(), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        r = solve(
            load_dcop(_ring_yaml(9)), "maxsum", mode="process",
            nb_agents=3, rounds=300, timeout=90, seed=1,
        )
        out, err = proc.communicate(timeout=180)
    finally:
        _reap([proc])
    assert r["cost"] == 0.0, r
    assert len(r["agents"]) == 3
    assert set(r["agents"]) <= {f"a{i}" for i in range(9)}
    assert all(r["placement"].values())
    assert r["telemetry"]["phases"]["deliver-loop"]["count"] == 1

    assert proc.returncode == 0, err[-2000:]
    result = _parse_json_tail(out)
    assert result["cost"] == 0.0
    assert result["status"] in ("finished", "msg_budget")


def test_host_runtime_five_processes_with_strategy(tmp_path):
    """5 agent processes placed by the adhoc strategy over the registered
    agents on a 20-variable ring: all host computations and the run
    reaches the optimum."""
    n = 20
    yaml_file = tmp_path / "ring20.yaml"
    yaml_file.write_text(_ring_yaml(n))
    env = _env()
    port = _free_port()
    orch = subprocess.Popen(
        _port_cmd("orchestrator", str(yaml_file), "-a", "maxsum",
                  "--runtime", "host", "--port", str(port),
                  "--nb_agents", "5", "--rounds", "200", "--seed", "1",
                  "-d", "adhoc"),
        env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    names = [f"a{i}" for i in range(1, 6)]
    # one `agent` command with five names forks one process each
    agents = subprocess.Popen(
        _port_cmd("agent", "--names", *names, "--runtime", "host",
                  "--orchestrator", f"localhost:{port}"),
        env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        orc_out, orc_err = orch.communicate(timeout=180)
        assert orch.returncode == 0, orc_err[-3000:]
        result = _parse_json_tail(orc_out)
        assert result["cost"] == 0.0
        assert sorted(result["agents"]) == names
        placement = result["placement"]
        assert all(placement[a] for a in names), placement
        assert result["msg_count"] > 0
        _, a_err = agents.communicate(timeout=30)
        assert agents.returncode == 0, a_err[-3000:]
    finally:
        _reap([orch, agents])


def test_tcp_layer_dead_peer_reports_and_raises():
    """A dead destination surfaces through ``on_send_error`` and fails
    later sends fast with ``UnreachableAgent``; the lost frame stays
    counted as sent."""
    from pydcop_tpu_torch.infrastructure.communication import (
        UnreachableAgent,
    )
    from pydcop_tpu_torch.infrastructure.computations import Message
    from pydcop_tpu_torch.infrastructure.hostnet import (
        TcpCommunicationLayer,
    )

    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()

    errors = []
    layer = TcpCommunicationLayer(
        on_send_error=lambda dest, e: errors.append((dest, e)),
        retry_window=1.0,
    )
    try:
        layer.set_addresses({"ghost": ("127.0.0.1", dead_port)})
        layer.send_msg("ghost", "c1", "c2", Message("m", 1))
        deadline = time.time() + 15
        while not errors and time.time() < deadline:
            time.sleep(0.02)
        assert errors and errors[0][0] == "ghost", errors
        with pytest.raises(UnreachableAgent):
            layer.send_msg("ghost", "c1", "c2", Message("m", 2))
        assert layer.count_sent == 1
    finally:
        layer.close()


def test_host_runtime_agent_death_fails_cleanly():
    """A control connection dying mid-solve fails the orchestrator with
    ``AgentFailureError`` promptly (scripted protocol agents)."""
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.infrastructure.hostnet import (
        AgentFailureError,
        _recv,
        _send,
        run_host_orchestrator,
    )

    dcop = load_dcop(_ring_yaml())
    server, port = _listener()
    outcome = {}

    def orchestrate():
        try:
            run_host_orchestrator(
                dcop, "maxsum", {}, nb_agents=2, port=port,
                rounds=10_000_000, register_timeout=30.0, server=server,
            )
            outcome["result"] = "finished"
        except AgentFailureError as e:
            outcome["error"] = str(e)
        except Exception as e:  # pragma: no cover — test diagnostics
            outcome["error"] = f"unexpected {type(e).__name__}: {e}"

    orch = threading.Thread(target=orchestrate, daemon=True)
    orch.start()

    def scripted_agent(name, die_after_polls):
        conn = _connect(port)
        reader = conn.makefile("rb")
        _send(conn, {"type": "register", "agent": name, "msg_port": 1})
        dep = _recv(reader)
        assert dep["type"] == "deploy"
        my_vars = [c for c in dep["computations"] if c.startswith("v")]
        _send(conn, {"type": "deployed", "n": len(dep["computations"])})
        polls = 0
        while True:
            msg = _recv(reader)
            if msg is None or msg["type"] == "stop":
                break
            if msg["type"] == "status?":
                polls += 1
                if die_after_polls and polls >= die_after_polls:
                    conn.close()
                    return
                _send(
                    conn,
                    {"type": "status", "idle": False, "delivered": polls},
                )
            elif msg["type"] == "collect":
                _send(conn, {"type": "result",
                             "values": {v: 0 for v in my_vars},
                             "delivered": polls, "size": polls})
        conn.close()

    t1 = threading.Thread(target=scripted_agent, args=("a1", 3), daemon=True)
    t2 = threading.Thread(target=scripted_agent, args=("a2", 0), daemon=True)
    t0 = time.monotonic()
    t1.start()
    t2.start()
    orch.join(timeout=30)
    assert not orch.is_alive(), "orchestrator hung after agent death"
    assert "died" in outcome.get("error", ""), outcome
    assert time.monotonic() - t0 < 25


def _scripted_run(hn, dcop, names=("a1", "a2"), **kw):
    """``hn.run_host_orchestrator`` against scripted agents that deploy
    nothing, report idle and collect zeros: ``(box, deploys)``."""
    server, port = _listener()
    box = {}

    def orchestrate():
        try:
            box["result"] = hn.run_host_orchestrator(
                dcop, "maxsum", {}, nb_agents=len(names), port=port,
                rounds=50, register_timeout=30.0, server=server, **kw,
            )
        except Exception as e:
            box["error"] = f"{type(e).__name__}: {e}"

    orch = threading.Thread(target=orchestrate, daemon=True)
    orch.start()
    deploys = {}

    def scripted_agent(name):
        conn = _connect(port)
        reader = conn.makefile("rb")
        hn._send(conn, {"type": "register", "agent": name, "msg_port": 1})
        dep = hn._recv(reader)
        if not dep or dep.get("type") != "deploy":
            conn.close()  # the run failed before deploy: end quietly
            return
        deploys[name] = dep
        hn._send(conn, {"type": "deployed", "n": 0})
        vals = {v: 0 for v in dep["computations"] if v.startswith("v")}
        while True:
            msg = hn._recv(reader)
            if msg is None or msg["type"] == "stop":
                break
            if msg["type"] == "status?":
                hn._send(conn, {"type": "status", "idle": True,
                                "delivered": 1})
            elif msg["type"] == "collect":
                hn._send(conn, {"type": "result", "values": vals,
                                "delivered": 1, "size": 1})
        conn.close()

    ts = [threading.Thread(target=scripted_agent, args=(n,), daemon=True)
          for n in names]
    for t in ts:
        t.start()
    orch.join(timeout=30)
    assert not orch.is_alive()
    for t in ts:
        t.join(timeout=10)
    return box, deploys


def test_host_runtime_placement_and_strategy():
    """Explicit placement maps and distribution strategies both drive
    the host deploy (protocol level, scripted agents)."""
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.infrastructure import hostnet

    dcop = load_dcop(_ring_yaml())
    var_names = [f"v{i}" for i in range(8)]
    want = {
        "a1": var_names[:2] + [f"c{i}" for i in range(8)],
        "a2": var_names[2:],
    }
    box, deploys = _scripted_run(hostnet, dcop, placement=want)
    result = box["result"]
    assert sorted(deploys["a1"]["computations"]) == sorted(want["a1"])
    assert sorted(deploys["a2"]["computations"]) == sorted(want["a2"])
    assert result["placement"]["a1"] == sorted(want["a1"])

    dup = dict(want)
    dup["a2"] = want["a2"] + [want["a1"][0]]
    box, _ = _scripted_run(hostnet, dcop, placement=dup)
    assert "result" not in box and "assigned to both" in box.get(
        "error", ""
    ), box

    box, deploys = _scripted_run(hostnet, dcop, distribution="adhoc")
    all_comps = sorted(
        deploys["a1"]["computations"] + deploys["a2"]["computations"]
    )
    assert all_comps == sorted(var_names + [f"c{i}" for i in range(8)])


def test_host_runtime_ui_feed():
    """``ui_port`` on the host orchestrator streams best-cost samples; a
    client sees events during the run and the final status event."""
    import urllib.request

    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.infrastructure.hostnet import (
        _recv,
        _send,
        run_host_orchestrator,
    )

    dcop = load_dcop(_ring_yaml())
    server, port = _listener()
    ui_port = _free_port()
    box = {}
    events = []
    ready = threading.Event()

    def client():
        deadline = time.monotonic() + 15
        while True:  # the UI server comes up after agents register
            try:
                req = urllib.request.urlopen(
                    f"http://localhost:{ui_port}/events", timeout=30
                )
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        ready.set()
        for raw in req:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[6:]))

    def orchestrate():
        try:
            box["result"] = run_host_orchestrator(
                dcop, "maxsum", {}, nb_agents=1, port=port,
                rounds=5000, register_timeout=30.0, ui_port=ui_port,
                best_sample_period=0.2, server=server,
            )
        except Exception as e:
            box["error"] = f"{type(e).__name__}: {e}"

    def scripted_agent():
        conn = _connect(port)
        reader = conn.makefile("rb")
        _send(conn, {"type": "register", "agent": "a1", "msg_port": 1})
        dep = _recv(reader)
        vals = {v: 0 for v in dep["computations"] if v.startswith("v")}
        _send(conn, {"type": "deployed", "n": 0})
        t_busy = time.monotonic() + 1.5  # busy ~3 sample periods
        while True:
            msg = _recv(reader)
            if msg is None or msg["type"] == "stop":
                break
            if msg["type"] == "status?":
                _send(conn, {"type": "status",
                             "idle": time.monotonic() > t_busy,
                             "delivered": 5})
            elif msg["type"] == "collect":
                _send(conn, {"type": "result", "values": vals,
                             "delivered": 5, "size": 5})
        conn.close()

    t = threading.Thread(target=client, daemon=True)
    orch = threading.Thread(target=orchestrate, daemon=True)
    orch.start()
    t.start()
    threading.Thread(target=scripted_agent, daemon=True).start()
    ready.wait(15)
    orch.join(timeout=30)
    assert not orch.is_alive()
    assert "result" in box, box
    t.join(10)
    assert len(events) >= 2  # in-run samples + the final event
    final = events[-1]
    assert final["status"] == "finished"
    assert final["values"] == box["result"]["assignment"]


def _run_sigkill_scenario(algo, params, k, n, victim="a2", accel=None):
    """3 real agent processes, a UI-gated SIGKILL of ``victim``
    mid-solve, and the recovered result (asserts the run finished with
    a recorded migration of ``victim``)."""
    import urllib.request

    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.infrastructure.hostnet import run_host_orchestrator

    dcop = load_dcop(_ring_yaml(n).replace(
        "agents: [" + ", ".join(f"a{i}" for i in range(n)) + "]",
        "agents: [a1, a2, a3]",
    ))
    assert list(dcop.agents) == ["a1", "a2", "a3"]
    server, port = _listener()
    uiport = _free_port()
    box = {}

    def orch():
        try:
            box["result"] = run_host_orchestrator(
                dcop, algo, params, nb_agents=3, port=port,
                rounds=100_000, timeout=60, seed=2, k_target=k,
                ui_port=uiport, server=server, device="cpu",
                accel_agents=[accel] if accel else None,
            )
        except Exception as e:
            box["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=orch, daemon=True)
    t.start()
    agents = [
        subprocess.Popen(
            _port_cmd("agent", "--names", f"a{i}", "--runtime", "host",
                      "--orchestrator", f"localhost:{port}",
                      "--device", "cpu"),
            env=_env(), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in (1, 2, 3)
    ]
    try:
        # kill only once the run is demonstrably underway (a first
        # complete sample reached the UI feed)
        deadline = time.monotonic() + 60
        seen = False
        while time.monotonic() < deadline:
            if "error" in box or "result" in box:
                break
            try:
                st = json.load(urllib.request.urlopen(
                    f"http://127.0.0.1:{uiport}/state", timeout=2))
                if st.get("cost") is not None:
                    seen = True
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert "error" not in box, box["error"]
        assert seen, f"run never produced a first sample ({box})"
        agents[int(victim[1]) - 1].kill()  # SIGKILL mid-solve
        t.join(90)
        assert not t.is_alive(), "orchestrator hung after SIGKILL"
        assert "error" not in box, box["error"]
        r = box["result"]
        assert r["status"] == "finished"
        assert r["migrations"], "no migration recorded"
        assert r["migrations"][0]["dead"] == [victim]
        survivors = {"a1", "a2", "a3"} - {victim}
        assert set(r["placement"]) == survivors
        return r
    finally:
        _reap(agents)


@pytest.mark.parametrize(
    "algo,params,k,n",
    [
        # a 300-variable ring with a low move probability keeps DSA
        # busy until the kill lands
        ("dsa", {"probability": 0.06}, 1, 300),
        ("maxsum", {"damping": 0.5}, 2, 48),
    ],
)
def test_host_runtime_sigkill_recovers_with_replicas(algo, params, k, n):
    """k-resilience: a SIGKILLed agent's computations migrate to live
    replica holders (value restart) and the run quiesces at the ring's
    optimum; k=2 spreads them over both survivors."""
    r = _run_sigkill_scenario(algo, params, k, n)
    assert r["cost"] == 0.0
    moved = r["migrations"][0]["moved"]
    assert moved, "nothing migrated"
    assert set(moved.values()) <= {"a1", "a3"}


def test_ktarget_rejects_round_barrier_algorithms():
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.infrastructure.hostnet import (
        PlacementError,
        run_host_orchestrator,
    )

    dcop = load_dcop(_ring_yaml(6))
    with pytest.raises(PlacementError, match="k_target"):
        run_host_orchestrator(
            dcop, "mgm", {}, nb_agents=2, port=0, k_target=1,
            register_timeout=5.0,
        )


@pytest.mark.parametrize("accel,victim", [("a2", "a2"), ("a1", "a2")])
def test_sigkill_recovery_with_islands(accel, victim):
    """k-resilience with a compiled island (on the CPU): the island agent
    dies and its computations come back as host computations, or a plain
    agent dies and the surviving island re-announces its boundary."""
    r = _run_sigkill_scenario(
        "dsa", {"probability": 0.06}, 1, 300, victim=victim, accel=accel,
    )
    assert r["cost"] == 0.0


def test_solve_k_target_mode_validation():
    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop

    dcop = load_dcop(_ring_yaml(6))
    for mode in ("batched", "thread", "sim"):
        with pytest.raises(ValueError, match="k_target"):
            solve(dcop, "dsa", mode=mode, k_target=1, timeout=10,
                  device="cpu")


# -- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("algo", ["dpop", "syncbb"])
def test_exact_process_runs_equal_jax_and_sim(algo):
    """Exact algorithms do not depend on timing: a process run equals the
    JAX package's process run and the port's sim run in assignment and
    cost."""
    from pydcop_tpu.api import solve as jax_solve
    from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load

    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop

    text = _ring_yaml(7)
    box = {}
    jax_run = threading.Thread(target=lambda: box.update(want=jax_solve(
        jax_load(text), algo, mode="process", nb_agents=2, seed=3,
        timeout=90)), daemon=True)
    jax_run.start()  # the JAX package's agent processes start alongside
    got = solve(load_dcop(text), algo, mode="process", nb_agents=2,
                seed=3, timeout=90)
    jax_run.join(timeout=120)
    want = box["want"]
    sim = solve(load_dcop(text), algo, mode="sim", seed=3, device="cpu")
    for other in (want, sim):
        assert (got["assignment"], got["cost"]) == (
            other["assignment"], other["cost"])
    assert got["placement"] == want["placement"]


@pytest.mark.parametrize("kw", [
    {"distribution": "adhoc"},
    {"distribution": "heur_comhost", "k_target": 1},
    {"k_target": 2},
], ids=["adhoc", "heur_comhost-k1", "round_robin-k2"])
def test_placements_equal_jax(kw):
    """Over the same registered names, the port's orchestrator deploys
    and reports the JAX orchestrator's placement."""
    from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load
    from pydcop_tpu.infrastructure import hostnet as jax_hostnet

    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.infrastructure import hostnet

    text = _ring_yaml(12).replace(
        "agents: [" + ", ".join(f"a{i}" for i in range(12)) + "]",
        "agents: [a1, a2, a3]",
    )
    names = ("a1", "a2", "a3")
    box_t, dep_t = _scripted_run(hostnet, load_dcop(text), names, **kw)
    box_j, dep_j = _scripted_run(jax_hostnet, jax_load(text), names, **kw)
    assert "result" in box_t and "result" in box_j, (box_t, box_j)
    assert box_t["result"]["placement"] == box_j["result"]["placement"]
    for name in names:
        for key in ("computations", "placement", "directory", "seed",
                    "accel", "grace", "params"):
            if key == "directory":
                continue  # the scripted agents' message ports
            assert dep_t[name][key] == dep_j[name][key], (name, key)


def test_tcp_frames_equal_jax():
    """The message plane's frame for the same algorithm message, and the
    control plane's ``_send`` line, are the JAX package's bytes (module
    paths mapped; ``sa`` is each sender's own listening address)."""
    from pydcop_tpu.algorithms._host_maxsum import (
        MaxSumCostMessage as JaxCosts,
    )
    from pydcop_tpu.infrastructure import hostnet as jax_hostnet

    from pydcop_tpu_torch.algorithms._host_maxsum import MaxSumCostMessage
    from pydcop_tpu_torch.infrastructure import hostnet

    peer = socket.create_server(("127.0.0.1", 0))
    peer.settimeout(15)
    frames = []
    for hn, costs in ((jax_hostnet, JaxCosts), (hostnet, MaxSumCostMessage)):
        layer = hn.TcpCommunicationLayer()
        try:
            layer.set_addresses({"peer": peer.getsockname()})
            layer.send_msg("peer", "c1", "v2",
                           costs({0: 0.5, 1: 1.25, 2: -3.0}))
            conn, _ = peer.accept()
            with conn:
                line = conn.makefile("rb").readline()
            sa = f"{layer.address[0]}:{layer.address[1]}"
            frames.append(line.replace(sa.encode(), b"SA"))
        finally:
            layer.close()
    peer.close()
    assert _mapped(frames[1].decode()) == frames[0].decode()
    assert b"pydcop_tpu_torch." in frames[1]

    a, b = socket.socketpair()
    with a, b:
        obj = {"type": "status", "idle": True, "delivered": 3, "sent": 3,
               "error": None, "values": {"v0": 1}}
        jax_hostnet._send(a, obj)
        want = b.makefile("rb").readline()
        hostnet._send(a, obj)
        got = b.makefile("rb").readline()
    assert got == want


@pytest.mark.parametrize("pkg", ["pydcop_tpu", "pydcop_tpu_torch"])
def test_process_lockstep_islands_equal_all_host_sim(pkg):
    """A process-mode MGM run over TCP with two lockstep islands (agent
    threads of this process, so that their value changes can be stamped)
    decides the all-host sim run's values, cycle for cycle, over the
    cycles the process run completed: in the JAX package, so in the
    port."""
    import argparse
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    solve = mod("api").solve
    generate = mod("commands.generators.graphcoloring").generate
    agents = mod("infrastructure.agents")
    computations = mod("infrastructure.computations")
    runtime = mod("infrastructure.runtime")
    hostnet = mod("infrastructure.hostnet")
    dev = {"device": "cpu"} if pkg == "pydcop_tpu_torch" else {}

    side = 12
    dcop = generate(argparse.Namespace(
        graph="grid", variables_count=side * side, colors_count=3,
        soft=True, noise=0.02, seed=1, intentional=False,
        agents_count=None, capacity=100.0, p_edge=0.5, m_edge=2,
    ))
    mapping = {"a0": [], "a1": [], "a2": []}
    for v in dcop.variables:
        row = int(v[1:]) // side
        mapping["a0" if row < 5 else ("a2" if row < 7 else "a1")].append(v)

    cls, own_sel = computations.VariableComputation, (
        computations.VariableComputation.value_selection)
    own_deploy = agents.Agent.deploy_computation
    own_build = runtime._build_computations
    lock = threading.Lock()
    log, made = {}, []

    def owner(comp):  # the island of a proxy (``_island`` in JAX's)
        return (getattr(comp, "island", None)
                or getattr(comp, "_island", None) or comp)

    def value_selection(comp, value):
        if value != comp.current_value:
            with lock:
                log.setdefault(comp.name, []).append(
                    [owner(comp)._cycle, value])
        own_sel(comp, value)

    def deploy(agent, comp):  # the process run's computations
        made.append(comp)
        own_deploy(agent, comp)

    def build(*args, **kwargs):  # the sim run's
        comps, placement = own_build(*args, **kwargs)
        made.extend(comps)
        return comps, placement

    def upto(stamps, cycles):
        return {v: [x for x in h if x[0] < cycles]
                for v, h in sorted(stamps.items())}

    cls.value_selection = value_selection
    agents.Agent.deploy_computation = deploy
    runtime._build_computations = build
    try:
        server, port = _listener()
        threads = [threading.Thread(
            target=hostnet.run_host_agent, args=(a, f"127.0.0.1:{port}"),
            kwargs=dev, daemon=True) for a in mapping]
        for t in threads:
            t.start()
        r = hostnet.run_host_orchestrator(
            dcop, "mgm", {}, nb_agents=3, port=port, server=server,
            rounds=40, seed=1, placement=mapping,
            accel_agents=["a0", "a1"], timeout=60,
        )
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        cycles = min(owner(c)._cycle for c in made)
        islands = {owner(c) for c in made if owner(c) is not c}
        process_log = {v: list(h) for v, h in log.items()}
        log.clear()
        made.clear()
        solve(dcop, "mgm", {}, mode="sim", rounds=400, seed=1, **dev)
        sim_cycles = min(owner(c)._cycle for c in made)
    finally:
        cls.value_selection = own_sel
        agents.Agent.deploy_computation = own_deploy
        runtime._build_computations = own_build
    assert r["status"] == "msg_budget" and len(islands) == 2
    assert cycles >= 8 and sim_cycles >= cycles
    changes = upto(process_log, cycles)
    assert changes == upto(log, cycles)
    # every variable's initial value, and moves after it
    assert sum(map(len, changes.values())) > side * side
    assert len(process_log) == side * side


# -- faults C.3 and C.4, and the device the islands run on --------------------


def test_amaxsum_placements_refuse_as_jax(tmp_path, capsys):
    """C.3: A-Max-Sum weighs computations with Max-Sum's footprints, so on
    the re-anchor's coloring ``distribute`` refuses as the JAX package
    does and ``replica_dist`` prints its bytes."""
    from pydcop_tpu.cli import main as jax_main

    from pydcop_tpu_torch.cli import main as port_main

    gen = ["generate", "graph_coloring", "--graph", "scalefree", "-n", "30",
           "-m", "2", "-c", "3", "--soft", "--seed", "3",
           "--agents_count", "8", "--capacity", "60"]

    def run(main, argv):
        capsys.readouterr()
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
        except Exception as e:  # the refusal, as each package raises it
            rc = f"{type(e).__name__}: {e}"
        out = capsys.readouterr()
        return rc, out.out, out.err

    problem = tmp_path / "coloring.yaml"
    rc, text, _ = run(jax_main, gen)
    assert rc in (0, None)
    problem.write_text(text)
    for method in ("adhoc", "heur_comhost", "ilp_fgdp"):
        argv = ["distribute", "-d", method, "-a", "amaxsum", str(problem)]
        want, got = run(jax_main, argv), run(port_main, argv)
        assert want == got, method
        assert want[0] not in (0, None), want
    big = tmp_path / "agents12.yaml"
    rc, text, _ = run(jax_main, ["generate", "agents", "-n", "12",
                                 "--capacity", "400"])
    big.write_text(text)
    argv = ["replica_dist", "-k", "2", "-a", "amaxsum", "-d", "adhoc",
            str(problem), str(big)]
    want, got = run(jax_main, argv), run(port_main, argv)
    assert want == got and want[1]


def test_jax_keywords_of_backoff_supervisor_and_sweep():
    """C.4: the keywords a JAX-style caller passes are taken, with the JAX
    defaults and the JAX package's delays and results."""
    import inspect
    import itertools

    from pydcop_tpu.engine.supervisor import SupervisorConfig as JaxConfig
    from pydcop_tpu.ops.semiring import contract_sweep as jax_sweep
    from pydcop_tpu.utils import backoff as jax_backoff

    from pydcop_tpu_torch.engine.supervisor import SupervisorConfig
    from pydcop_tpu_torch.ops import semiring
    from pydcop_tpu_torch.utils import backoff

    def sig(fn, drop=()):
        return {k: p.default for k, p in inspect.signature(fn).parameters
                .items() if k not in drop}

    assert sig(backoff.call_with_backoff) == sig(jax_backoff.call_with_backoff)
    assert sig(backoff.backoff_delays) == sig(jax_backoff.backoff_delays)
    # the same schedule: keyed, seeded, and as call_with_backoff sleeps it
    for kw in ({"key": "hostnet:a1", "seed": 3}, {"seed": 7},
               {"base": 0.05, "max_delay": 1.0, "key": "agent:a2:connect"}):
        take = lambda it: list(itertools.islice(it, 8))  # noqa: E731
        assert take(backoff.backoff_delays(**kw)) == take(
            jax_backoff.backoff_delays(**kw))
    slept = {}
    for name, mod in (("jax", jax_backoff), ("port", backoff)):
        now, naps = [0.0], []
        calls = iter([OSError("a"), OSError("b"), OSError("c"), "ok"])

        def fn():
            x = next(calls)
            if isinstance(x, Exception):
                raise x
            return x

        def sleep(dt, now=now, naps=naps):
            naps.append(dt)
            now[0] += dt

        assert mod.call_with_backoff(
            fn, 10.0, exceptions=(OSError,), base=0.1, factor=3.0,
            max_delay=0.5, jitter=0.5, seed=2, key="k",
            clock=lambda now=now: now[0], sleep=sleep) == "ok"
        slept[name] = naps
    assert slept["port"] == slept["jax"] and len(slept["jax"]) == 3

    fields = ("retry_budget", "chunk_floor", "on_numeric_fault",
              "backoff_base", "backoff_factor", "backoff_max",
              "backoff_jitter")
    assert [getattr(SupervisorConfig(), f) for f in fields] == [
        getattr(JaxConfig(), f) for f in fields]
    custom = dict(backoff_base=0.5, backoff_factor=3.0, backoff_max=2.0,
                  backoff_jitter=0.1)
    cfg = SupervisorConfig(**custom)
    want = list(itertools.islice(jax_backoff.backoff_delays(
        base=0.5, factor=3.0, max_delay=2.0, jitter=0.1, seed=0,
        key="supervisor:engine.chunk"), 6))
    assert list(itertools.islice(cfg.delays("supervisor:engine.chunk"),
                                 6)) == want

    assert sig(semiring.contract_sweep)["level_sync"] is True
    assert inspect.signature(jax_sweep).parameters["level_sync"].default
    # four independent pairs: one stacked dispatch a level, or one a node,
    # with the JAX package's dispatch counts and root totals
    from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load
    from pydcop_tpu.ops import semiring as jax_semiring

    from pydcop_tpu_torch.dcop.yamldcop import load_dcop

    lines = ["name: pairs", "objective: min", "domains:",
             "  d: {values: [0, 1, 2]}", "variables:"]
    lines += [f"  x{i}: {{domain: d}}" for i in range(8)]
    lines.append("constraints:")
    for i in range(0, 8, 2):
        lines += [f"  c{i}:", "    type: intention",
                  f"    function: {i + 1} if x{i} == x{i + 1} else "
                  f"x{i} + x{i + 1} + 1"]
    text = "\n".join(lines + ["agents: [a0]"]) + "\n"
    runs = [semiring.contract_sweep(
        [semiring.build_plan(load_dcop(text))],
        semiring.get_semiring("min_sum"), level_sync=ls,
        device_min_cells=1, torch_device=torch.device("cpu"))
        for ls in (True, False)]
    jruns = [jax_sweep([jax_semiring.build_plan(jax_load(text))],
                       jax_semiring.get_semiring("min_sum"), level_sync=ls,
                       device_min_cells=1) for ls in (True, False)]
    assert [(r.root_total, r.dispatches) for r in runs] == [
        (r.root_total, r.dispatches) for r in jruns]
    assert runs[0].dispatches[0] < runs[1].dispatches[0]


def test_island_agent_left_on_the_default_device_fails_without_cuda():
    """No fallback: an accel agent's process asked for no device wants the
    card, and on a machine without CUDA the run fails naming it."""
    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.infrastructure.hostnet import AgentFailureError

    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(AgentFailureError) as info:
        solve(load_dcop(_ring_yaml(6)), "maxsum", mode="process",
              nb_agents=2, accel_agents=["a1"], timeout=60)
    assert "no CUDA device is available" in str(info.value)
    assert "--- a1 stderr ---" in str(info.value)


def test_migration_safe_flags_equal_jax():
    """The algorithms ``k_target`` may migrate are the JAX package's."""
    from pydcop_tpu.algorithms import list_available_algorithms as jax_list
    from pydcop_tpu.algorithms import load_algorithm_module as jax_load

    from pydcop_tpu_torch.algorithms import (
        list_available_algorithms,
        load_algorithm_module,
    )

    names = list_available_algorithms()
    assert names == [a for a in jax_list() if a in names]
    for algo in names:
        assert getattr(load_algorithm_module(algo), "MIGRATION_SAFE",
                       False) == getattr(jax_load(algo), "MIGRATION_SAFE",
                                         False), algo
