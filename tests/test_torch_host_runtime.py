"""The port's host message-driven runtime against the JAX package's, on
the CPU.

All-host ``sim`` runs use no jax randomness: the event loop's channel
choice is ``random.Random(seed)``, each computation's stream is
``stable_seed`` (crc32) and every cost is Python arithmetic on the model
objects.  So they must equal the JAX package's ``solve_host(mode="sim")``
bit for bit, every result key but ``time``; the ``msg_log`` lines differ
only by the package prefix of the ``simple_repr`` module names, which is
mapped before comparing (ROADMAP C, 'Message log module names').  Thread
mode is timing-dependent, so it is held to the known optimum instead.
The chaos layer's decisions are a pure hash, so its event sequence on the
same traffic equals the JAX layer's.  Every refusal of a host mode has
the JAX package's exception type and message.
"""

import json
import os
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load  # noqa: E402
from pydcop_tpu.infrastructure import solve_host as jax_solve_host  # noqa: E402

from pydcop_tpu_torch.dcop.yamldcop import load_dcop as port_load  # noqa: E402
from pydcop_tpu_torch.infrastructure import solve_host  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLORING = os.path.join(REPO, "examples", "graph_coloring_3.yaml")
HOST_ALGOS = ["maxsum", "amaxsum", "dsa", "adsa", "dsatuto", "mgm", "mgm2",
              "dba", "gdba", "syncbb", "dpop"]
#: round-synchronized algorithms re-send every round and never quiesce:
#: their runs stop at a budget of this many rounds
PHASED = {"mgm": 30, "mgm2": 12, "dba": 30, "gdba": 30}


def _yaml(kind: str, agents=()) -> str:
    """Small instances of the JAX package's host-runtime tests
    (``tests/test_infrastructure.py``): a 6-ring and a 7-node binary tree
    of 3-colorings, a 4-chain 'max' agreement problem, and a 5-variable
    problem with unary costs and a ternary constraint."""
    lines = ["name: " + kind]
    if kind == "maxchain":
        lines.append("objective: max")
    else:
        lines.append("objective: min")
    lines += ["domains:", "  colors: {values: [0, 1, 2]}", "variables:"]
    if kind == "ring":
        n, edges = 6, [(i, (i + 1) % 6) for i in range(6)]
    elif kind == "tree":
        n, edges = 7, [(i, (i - 1) // 2) for i in range(1, 7)]
    elif kind == "maxchain":
        n, edges = 4, [(i, i + 1) for i in range(3)]
    else:  # mixed
        n, edges = 5, [(0, 1), (1, 2), (3, 4), (2, 3)]
    for i in range(n):
        if kind == "mixed" and i in (0, 3):
            lines.append(
                f"  v{i}: {{domain: colors, cost_function: 0.5 * v{i}}}"
            )
        else:
            lines.append(f"  v{i}: {{domain: colors}}")
    lines.append("constraints:")
    for k, (i, j) in enumerate(edges):
        fn = (
            f"5 if v{i} == v{j} else 0" if kind == "maxchain"
            else f"1 if v{i} == v{j} else 0"
        )
        lines += [f"  c{k}:", "    type: intention", f"    function: {fn}"]
    if kind == "mixed":
        lines += [
            "  t0:", "    type: intention",
            "    function: 0.3 * abs(v0 + v2 - v4)",
        ]
    if agents:
        lines.append(f"agents: [{', '.join(agents)}]")
    return "\n".join(lines) + "\n"


def _both(kind: str, agents=()):
    if kind == "coloring3":
        text = open(COLORING).read()
    else:
        text = _yaml(kind, agents)
    return jax_load(text), port_load(text)


def _mapped(obj):
    """``simple_repr`` output with the port's module names mapped to the
    JAX package's."""
    if isinstance(obj, dict):
        return {k: _mapped(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mapped(v) for v in obj]
    if isinstance(obj, str) and obj.startswith("pydcop_tpu_torch."):
        return "pydcop_tpu." + obj[len("pydcop_tpu_torch."):]
    return obj


def _log_lines(path):
    out = []
    for ln in open(path).read().splitlines():
        rec = json.loads(ln)
        rec.pop("t")
        out.append(rec)
    return out


def _same_result(rj, rt, skip=("time",)):
    assert set(rj) == set(rt)
    for k in rj:
        if k in skip:
            continue
        assert rt[k] == rj[k], k


INSTANCES = ["ring", "tree", "maxchain", "mixed", "coloring3"]


@pytest.mark.parametrize("kind", INSTANCES)
@pytest.mark.parametrize("algo", HOST_ALGOS)
def test_all_host_sim_equals_jax_bit_for_bit(algo, kind, tmp_path):
    dj, dt = _both(kind)
    params = {"damping": 0.5} if "maxsum" in algo else {}
    seed = 3
    pj, pt = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    rounds = PHASED.get(algo)
    rj = jax_solve_host(dj, algo, params, mode="sim", seed=seed, msg_log=pj,
                        rounds=rounds)
    rt = solve_host(
        dt, algo, params, mode="sim", seed=seed, msg_log=pt, device="cpu",
        rounds=rounds,
    )
    _same_result(rj, rt)
    lj, lt = _log_lines(pj), _log_lines(pt)
    assert len(lj) == rj["msg_count"] > 0
    assert [_mapped(x) for x in lt] == lj


@pytest.mark.parametrize("seed", [0, 5])
def test_sim_budget_and_rounds_equal_jax(seed):
    dj, dt = _both("ring")
    for kw in ({"max_msgs": 7}, {"rounds": 2}):
        rj = jax_solve_host(dj, "amaxsum", {}, mode="sim", seed=seed, **kw)
        rt = solve_host(dt, "amaxsum", {}, mode="sim", seed=seed,
                        device="cpu", **kw)
        _same_result(rj, rt)
        assert rt["status"] == "msg_budget"


def test_api_sim_equals_jax_api_and_cli(tmp_path, capsys):
    from pydcop_tpu.api import solve as jax_solve
    from pydcop_tpu.cli import main as jax_main

    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.cli import main as port_main

    rj = jax_solve(COLORING, "amaxsum", {"damping": 0.5}, mode="sim", seed=2)
    rt = solve(COLORING, "amaxsum", {"damping": 0.5}, mode="sim", seed=2,
               device="cpu")
    _same_result(rj, rt, skip=("time", "telemetry"))
    argv = ["solve", "-a", "dsa", "-m", "sim", "--seed", "4", COLORING]
    assert jax_main(argv) == 0
    out_j = json.loads(capsys.readouterr().out)
    assert port_main(argv + ["--device", "cpu"]) == 0
    out_t = json.loads(capsys.readouterr().out)
    _same_result(out_j, out_t, skip=("time", "telemetry"))


def test_sim_message_counters_equal_jax():
    from pydcop_tpu.api import solve as jax_solve

    from pydcop_tpu_torch.api import solve

    rj = jax_solve(COLORING, "maxsum", {}, mode="sim", seed=5)
    rt = solve(COLORING, "maxsum", {}, mode="sim", seed=5, device="cpu")
    cj, ct = rj["telemetry"]["counters"], rt["telemetry"]["counters"]
    msg = sorted(k for k in cj if k.startswith("msg."))
    assert msg == ["msg.delivered", "msg.size"]
    assert {k: ct[k] for k in msg} == {k: cj[k] for k in msg}
    assert ct["msg.delivered"] == rt["msg_count"]


def test_algorithm_def_and_params_resolve_as_jax():
    from pydcop_tpu.algorithms import AlgorithmDef as JDef

    from pydcop_tpu_torch.algorithms import AlgorithmDef

    dj, dt = _both("tree")
    rj = jax_solve_host(dj, JDef("dsa", {"variant": "A"}), {"probability": 0.9},
                        mode="sim", seed=1)
    rt = solve_host(dt, AlgorithmDef("dsa", {"variant": "A"}),
                    {"probability": 0.9}, mode="sim", seed=1, device="cpu")
    _same_result(rj, rt)


# -- the phased and exact host computations ----------------------------


def _coloring(pkg: str, n_vars: int, degree: int = 2, seed: int = 3):
    """``__graft_entry__._make_coloring_dcop`` built with ``pkg``'s model
    classes: noisy unary costs (deterministic per name) and random
    equality penalties; at ``(24, 2, 3)`` MGM stays stuck above cost 1."""
    import importlib
    import random

    import numpy as np

    dcop_mod = importlib.import_module(f"{pkg}.dcop.dcop")
    objects = importlib.import_module(f"{pkg}.dcop.objects")
    relations = importlib.import_module(f"{pkg}.dcop.relations")
    expr = importlib.import_module(f"{pkg}.utils.expressionfunction")
    rnd = random.Random(seed)
    d = objects.Domain("colors", "", [0, 1, 2])
    dcop = dcop_mod.DCOP(f"coloring_{n_vars}")
    vs = [
        objects.VariableNoisyCostFunc(
            f"v{i}", d, expr.ExpressionFunction(f"v{i} * 0"),
            noise_level=0.02,
        )
        for i in range(n_vars)
    ]
    for v in vs:
        dcop.add_variable(v)
    seen, cid = set(), 0
    for i in range(n_vars):
        for _ in range(degree):
            j = rnd.randrange(n_vars)
            if i == j or (min(i, j), max(i, j)) in seen:
                continue
            seen.add((min(i, j), max(i, j)))
            dcop.add_constraint(relations.NAryMatrixRelation(
                [vs[i], vs[j]], np.eye(3), name=f"c{cid}"))
            cid += 1
    return dcop


def _one_opt(dcop, assignment):
    base = dcop.solution_cost(assignment)
    for name, var in dcop.variables.items():
        for val in var.domain.values:
            if val != assignment[name]:
                assert dcop.solution_cost(
                    {**assignment, name: val}) >= base - 1e-6, (name, val)


def test_host_mgm_sim_equals_jax_and_is_one_opt_in_both_modes():
    """MGM's host computations end 1-opt (its convergence guarantee);
    the sim run equals the JAX package's bit for bit."""
    dj, dt = _coloring("pydcop_tpu", 24), _coloring("pydcop_tpu_torch", 24)
    rj = jax_solve_host(dj, "mgm", {}, mode="sim", rounds=400, timeout=30)
    rt = solve_host(dt, "mgm", {}, mode="sim", rounds=400, timeout=30,
                    device="cpu")
    _same_result(rj, rt)
    assert rt["cost"] > 1.0  # the instance MGM stays stuck on
    _one_opt(dt, rt["final_assignment"])
    rt = solve_host(dt, "mgm", {}, mode="thread", rounds=400, timeout=30,
                    device="cpu")
    _one_opt(dt, rt["final_assignment"])


def test_host_mgm_isolated_variable_settles_unary_best():
    from pydcop_tpu_torch.dcop.dcop import DCOP
    from pydcop_tpu_torch.dcop.objects import Domain, VariableWithCostDict

    dcop = DCOP("iso")
    dcop.add_variable(VariableWithCostDict(
        "x", Domain("d", "", [0, 1, 2]), {0: 0.0, 1: 5.0, 2: 5.0}))
    r = solve_host(dcop, "mgm", {}, mode="sim", rounds=20, timeout=10,
                   device="cpu")
    assert r["final_assignment"] == {"x": 0} and r["final_cost"] == 0.0


@pytest.mark.parametrize("algo,params", [
    ("dba", {}),
    ("gdba", {"increase_mode": "E"}),
    ("gdba", {"increase_mode": "R"}),
    ("gdba", {"increase_mode": "C"}),
])
def test_host_breakout_escapes_the_mgm_minimum_as_jax(algo, params):
    dj, dt = _coloring("pydcop_tpu", 24), _coloring("pydcop_tpu_torch", 24)
    rj = jax_solve_host(dj, algo, params, mode="sim", rounds=400, timeout=30)
    rt = solve_host(dt, algo, params, mode="sim", rounds=400, timeout=30,
                    device="cpu")
    _same_result(rj, rt)
    assert rt["cost"] < 0.5  # conflict-free: noise only


def test_host_gdba_endpoint_weight_copies_stay_equal():
    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.infrastructure.runtime import (
        _build_computations,
        _run_sim,
    )

    dcop = _coloring("pydcop_tpu_torch", 24)
    params = prepare_algo_params({}, load_algorithm_module("gdba").algo_params)
    comps, _ = _build_computations(dcop, "gdba", params, seed=0)
    _run_sim(comps, 30.0, 40_000, 0, time.perf_counter(), lambda *a: None)
    assert dcop.solution_cost(
        {c.name: c.current_value for c in comps}) < 0.5
    tables = {}
    for comp in comps:
        for cname, wt in comp._weights.items():
            tables.setdefault(cname, set()).add(tuple(sorted(wt.items())))
    assert all(len(v) == 1 for v in tables.values())
    assert any(wt for comp in comps for wt in comp._weights.values())


@pytest.mark.parametrize("mode", ["sim", "thread"])
def test_host_mgm2_pair_move_escapes_the_mgm_minimum(mode):
    """(1, 1) is reachable from (0, 0) only by a coordinated pair move:
    MGM stays at 0.5, MGM-2 reaches 0; in sim both equal the JAX runs."""
    import numpy as np

    def pair(pkg):
        import importlib

        dcop_mod = importlib.import_module(f"{pkg}.dcop.dcop")
        objects = importlib.import_module(f"{pkg}.dcop.objects")
        relations = importlib.import_module(f"{pkg}.dcop.relations")
        b = objects.Domain("b", "", [0, 1])
        dcop = dcop_mod.DCOP("pair")
        x = objects.Variable("x", b, initial_value=0)
        y = objects.Variable("y", b, initial_value=0)
        dcop.add_variable(x)
        dcop.add_variable(y)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [x, y], np.array([[0.5, 2.0], [2.0, 0.0]]), name="c"))
        return dcop

    declared = {"initial": "declared"}
    for algo, rounds, want in (("mgm", 60, 0.5), ("mgm2", 200, 0.0)):
        rt = solve_host(pair("pydcop_tpu_torch"), algo, declared, mode=mode,
                        rounds=rounds, timeout=30, device="cpu")
        assert rt["final_cost"] == want, (algo, rt)
        if mode == "sim":
            rj = jax_solve_host(pair("pydcop_tpu"), algo, declared,
                                mode=mode, rounds=rounds, timeout=30)
            _same_result(rj, rt)
    assert rt["final_assignment"] == {"x": 1, "y": 1}


@pytest.mark.parametrize("mode", ["sim", "thread"])
def test_host_dpop_and_syncbb_reach_the_batched_optimum(mode):
    from pydcop_tpu_torch.api import solve

    for seed in range(3):
        dt = _coloring("pydcop_tpu_torch", 12, seed=seed)
        exact = solve(dt, "dpop", device="cpu")["cost"]
        for algo in ("dpop", "syncbb"):
            r = solve_host(dt, algo, {}, mode=mode, timeout=60,
                           max_msgs=500_000, device="cpu")
            assert r["status"] == "finished", (algo, r)
            assert r["final_cost"] == pytest.approx(exact, abs=1e-9)
            if mode == "sim":
                rj = jax_solve_host(
                    _coloring("pydcop_tpu", 12, seed=seed), algo, {},
                    mode=mode, timeout=60, max_msgs=500_000)
                _same_result(rj, r)


# -- thread mode -------------------------------------------------------


@pytest.mark.parametrize("kind", ["ring", "tree"])
@pytest.mark.parametrize("placement", ["declared", "file", "strategy"])
def test_thread_mode_reaches_the_optimum(kind, placement, tmp_path):
    from pydcop_tpu_torch.api import solve

    agents = ("a1", "a2", "a3")
    _, dt = _both(kind, agents)
    dist = None
    algo = "adsa" if kind == "ring" else "amaxsum"
    if placement == "file":
        n = len(dt.variables)
        mapping = {a: [] for a in agents}
        for i in range(n):
            mapping[agents[i % 3]].append(f"v{i}")
        # dsa family: one computation per variable
        algo = "adsa"
        path = tmp_path / "dist.yaml"
        path.write_text(json.dumps({"distribution": mapping}))
        dist = str(path)
    elif placement == "strategy":
        dist = "adhoc"
    r = solve(dt, algo, {}, mode="thread", timeout=20, seed=1,
              distribution=dist, device="cpu")
    assert r["status"] == "finished"
    assert r["cost"] == 0
    assert r["msg_count"] > 0


def test_thread_mode_msg_log_counts_every_delivery(tmp_path):
    _, dt = _both("ring")
    path = str(tmp_path / "thread.jsonl")
    r = solve_host(dt, "maxsum", mode="thread", seed=1, timeout=20,
                   msg_log=path, device="cpu")
    lines = _log_lines(path)
    assert len(lines) == r["msg_count"] > 0
    from pydcop_tpu_torch.utils.simple_repr import from_repr

    for rec in lines[:20]:
        assert from_repr(rec["content"]).type == rec["type"]


# -- the chaos layer ---------------------------------------------------


def _chaos_events(pkg: str):
    import importlib

    faults = importlib.import_module(f"{pkg}.faults")
    comm = importlib.import_module(f"{pkg}.infrastructure.communication")
    comps = importlib.import_module(f"{pkg}.infrastructure.computations")
    inner = comm.InProcessCommunicationLayer()
    inbox = comm.Messaging("a2")
    inner.register("a2", inbox)
    layer = faults.ChaosCommunicationLayer(
        inner,
        faults.FaultPlan.from_spec("drop=0.25,dup=0.15,reorder=0.2", 9),
        "a1",
    )
    try:
        for i in range(120):
            layer.send_msg("a2", "c1", "c2", comps.Message("m", i))
        time.sleep(0.35)  # a trailing reorder hold releases by timer
        delivered = []
        while True:
            item = inbox.next_msg(timeout=0.01)
            if item is None:
                break
            delivered.append(item[2].content)
            inbox.task_done()
        return list(layer.events), delivered, layer.event_summary()
    finally:
        layer.close()


def test_chaos_layer_event_sequence_equals_jax():
    ej, dj, sj = _chaos_events("pydcop_tpu")
    et, dt, st = _chaos_events("pydcop_tpu_torch")
    assert et == ej and len(et) > 10
    assert dt == dj
    assert st == sj
    assert {k for k, _, _ in et} >= {"drop", "dup", "reorder"}


def test_chaos_smoke_thread_mode():
    """A ring solved to its optimum THROUGH injected drops, duplicates
    and delays in thread mode, twice; the recorded plan rebuilds the
    identical decision sequence, and every recorded event is the plan's
    decision for its link and sequence number."""
    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.faults import FaultPlan

    _, dt = _both("ring", ("a1", "a2", "a3", "a4"))
    spec = "drop=0.05,dup=0.05,delay=0.1:0.02"
    runs = [
        solve(dt, "maxsum", {"damping": 0.5}, mode="thread", rounds=400,
              timeout=60, seed=1, chaos=spec, chaos_seed=7, device="cpu")
        for _ in range(2)
    ]
    for r in runs:
        assert r["cost"] == 0.0
        assert r["status"] == "finished"
        assert r["chaos"]["spec"] == spec and r["chaos"]["seed"] == 7
        assert sum(r["chaos"]["events"].values()) > 0
    plans = [FaultPlan.from_spec(r["chaos"]["spec"], r["chaos"]["seed"])
             for r in runs]
    assert plans[0].decisions("a1", "a2", 300) == plans[1].decisions(
        "a1", "a2", 300)


# -- refusals ----------------------------------------------------------

REFUSALS = [
    ("sim", {"checkpoint_path": "x.npz"}),
    ("thread", {"resume": True}),
    ("sim", {"n_restarts": 2}),
    ("thread", {"nb_agents": 2}),
    ("sim", {"k_target": 1}),
    ("sim", {"ui_port": 8080}),
    ("thread", {"pad_policy": "pow2"}),
    ("sim", {"retry_budget": 1}),
    ("thread", {"on_numeric_fault": "raise"}),
    ("sim", {"max_util_bytes": 1024}),
    ("thread", {"chaos": "device_oom=1"}),
    ("thread", {"chaos": "conn_drop=0.1"}),
    ("thread", {"chaos": "replica_kill=1"}),
    ("thread", {"chaos": "crash=a1@1"}),
    ("sim", {"chaos": "drop=0.1"}),
    ("thread", {"chaos": "drop=0.1,a9>a1:drop=0.5"}),
    ("sim", {"accel_agents": ["nobody"], "algo": "maxsum"}),
    ("sim", {"accel_agents": ["a1"], "algo": "syncbb"}),
    ("sim", {"distribution": "no_such_strategy", "accel_agents": ["a1"]}),
    ("bogus", {}),
    ("batched", {"k_target": 1}),
    ("batched", {"accel_agents": ["a1"]}),
    ("batched", {"msg_log": "m.jsonl"}),
    ("batched", {"nb_agents": 3}),
    ("batched", {"chaos": "drop=0.1"}),
]


@pytest.mark.parametrize("mode,kw", REFUSALS)
def test_refusals_equal_jax(mode, kw):
    from pydcop_tpu.api import solve as jax_solve

    from pydcop_tpu_torch.api import solve

    kw = dict(kw)
    algo = kw.pop("algo", "dsa")
    errs = []
    for fn, extra in ((jax_solve, {}), (solve, {"device": "cpu"})):
        with pytest.raises(Exception) as info:
            fn(COLORING, algo, {}, mode=mode, rounds=5, timeout=10, **kw,
               **extra)
        errs.append(info.value)
    assert type(errs[1]) is type(errs[0])
    # a message that names a module names the port's package
    port_msg = str(errs[1]).replace("pydcop_tpu_torch.", "pydcop_tpu.")
    assert port_msg == str(errs[0])


@pytest.mark.parametrize("argv,where", [
    (["agent", "--names", "a1", "--orchestrator", "127.0.0.1:{port}"],
     "agent --runtime spmd"),
    (["orchestrator", COLORING, "-a", "maxsum"],
     "orchestrator --runtime spmd"),
])
def test_unported_parts_name_a15b(argv, where):
    """The SPMD runtime (the default ``--runtime``, ported since A15b.2)
    with the default ``--device`` on a machine without CUDA raises
    ``NoCudaDeviceError`` and never runs on the CPU: the orchestrator
    before it parses the problem, the agent on its deploy, before it
    joins the process group (a stand-in orchestrator deploys to it and
    sees no chunk)."""
    import socket
    import threading

    from pydcop_tpu_torch.cli import main
    from pydcop_tpu_torch.device import NoCudaDeviceError

    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    assert where.split()[0] == argv[0]
    seen = []
    with socket.create_server(("127.0.0.1", 0)) as server:
        server.settimeout(30)

        def deploy():  # one agent: register, a static deploy, listen
            conn, _ = server.accept()
            with conn, conn.makefile("rb") as reader:
                seen.append(json.loads(reader.readline()))
                conn.sendall((json.dumps({
                    "type": "deploy", "dcop_yaml": open(COLORING).read(),
                    "algo": "maxsum", "params": {}, "rounds": 8, "seed": 0,
                    "chunk_size": 4, "num_processes": 2, "process_id": 1,
                    "coordinator": "127.0.0.1:1", "heartbeat_timeout": 5,
                    "abort_grace": 5,
                }) + "\n").encode())
                seen.extend(json.loads(line) for line in reader)

        stand_in = threading.Thread(target=deploy, daemon=True)
        if argv[0] == "agent":
            stand_in.start()
        port = server.getsockname()[1]
        with pytest.raises(NoCudaDeviceError):
            main([a.format(port=port) for a in argv])
        if argv[0] == "agent":
            stand_in.join(30)
            assert not stand_in.is_alive()
            assert [m["type"] for m in seen] == ["register"]


def test_host_mode_needs_a_card_or_the_cpu():
    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.device import NoCudaDeviceError

    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(NoCudaDeviceError):
        solve(COLORING, "maxsum", {}, mode="sim")
