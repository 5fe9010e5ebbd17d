"""The port's SPMD runtime, one process a shard over ``torch.distributed``
(``pydcop_tpu_torch/parallel/distributed.py``,
``infrastructure/orchestrator.py``, ``infrastructure/elastic.py``), on the
CPU with gloo.

The JAX package's own multi-process runs do not work on a CPU-only
image, so its orchestrator and elastic tests are ``slow``; the reference
here is the JAX in-process sharded solve on the conftest's virtual CPU
devices (as ``tests/test_orchestrator.py`` compares), and the port's
in-process ``Mesh`` for bit-equality.  Every subprocess is bounded by
``communicate(timeout=…)`` and killed in a ``finally``.  Ports come from
the OS: a control plane started with ``--port 0`` (or a live feed with
``--uiport 0``) says on stderr which port it got, and a process group's
store listens on a socket the test bound and hands to rank 0.
"""

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from pydcop_tpu.algorithms import load_algorithm_module as jax_algo  # noqa: E402
from pydcop_tpu.algorithms import prepare_algo_params as jax_params  # noqa: E402
from pydcop_tpu.ops import compile as jcompile  # noqa: E402
from pydcop_tpu.parallel import mesh as jmesh  # noqa: E402

import pydcop_tpu.dcop as jdcop  # noqa: E402
import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
from pydcop_tpu_torch import interop  # noqa: E402
from pydcop_tpu_torch.algorithms import load_algorithm_module  # noqa: E402
from pydcop_tpu_torch.algorithms import prepare_algo_params  # noqa: E402
from pydcop_tpu_torch.engine.batched import ShardedRounds, run_batched  # noqa: E402
from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from pydcop_tpu_torch.ops.costs import total_cost  # noqa: E402
from pydcop_tpu_torch.parallel import make_mesh, shard_problem  # noqa: E402
from test_orchestrator_failures import _SCENARIO, _ring_yaml  # noqa: E402
from test_torch_local_search import _jax_draws  # noqa: E402
from test_torch_parallel import _start, coloring_ring  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
WAIT = 60.0  # seconds any one process may take

# one rank of a test process group: argv = mode, rank, world, port,
# listening fd (rank 0), work file
_RANK = r"""
import json, os, sys, time
import torch
from pydcop_tpu_torch.parallel.distributed import (
    CollectiveError, bind_store, init_process_mesh)

mode, rank, world, port, fd, work = sys.argv[1:7]
rank, world, port, fd = int(rank), int(world), int(port), int(fd)
store = bind_store(world, 30.0, listen_fd=fd) if rank == 0 else None
mesh = init_process_mesh(f"127.0.0.1:{port}", world, rank, "cpu", 30.0,
                         store=store)
axis = mesh._axis
if mode == "psum":
    parts = torch.load(work)
    s = mesh.run(lambda i, ax: ax.psum(parts[ax.index]))[0]
    print(json.dumps({"sum": s.tolist(), "index": axis.index,
                      "size": axis.size, "psums": mesh.psums}))
    mesh.close()
elif mode == "die":
    if rank == 1:
        os._exit(3)
    t0 = time.perf_counter()
    try:
        axis.psum(torch.ones(3))
    except CollectiveError as e:
        print(json.dumps({"error": type(e).__name__,
                          "cause": type(e.__cause__).__name__,
                          "seconds": time.perf_counter() - t0}))
else:  # one sharded step
    from pydcop_tpu_torch.algorithms import load_algorithm_module
    from pydcop_tpu_torch.engine.batched import ShardedRounds
    from pydcop_tpu_torch.ops.costs import total_cost
    from pydcop_tpu_torch.parallel import shard_problem
    job = torch.load(work, weights_only=False)
    p, mod = job["problem"], load_algorithm_module(job["algo"])
    loop = ShardedRounds(shard_problem(p, mesh), p, mod, job["params"], 0,
                         total_cost)
    assert len(loop.views) == 1 and loop.views[0].n_edges == p.n_edges // world
    got = loop.whole(loop.apply(loop.place(job["state"]), job["drawn"]),
                     "cpu")
    if rank == 0:
        torch.save(got, work + ".out")
    if job["algo"] == "maxsum":  # a checkpointed run: rank 0 writes
        from pydcop_tpu_torch.engine.batched import run_batched
        run_batched(p, mod, job["params"], rounds=8, chunk_size=4,
                    mesh=mesh, checkpoint_path=f"{work}.ck{rank}.npz")
    mesh.close()
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        try:
            p.communicate(timeout=10)
        except (subprocess.TimeoutExpired, ValueError):
            pass


def _group(mode, world, work):
    """``world`` rank processes of ``_RANK`` in ``mode``; rank 0 serves
    the store on a socket bound here.  Returns ``(rc, stdout, stderr)``
    per rank."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(64)
    s.set_inheritable(True)
    port, fd = s.getsockname()[1], s.fileno()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK, mode, str(r), str(world),
             str(port), str(fd), str(work)],
            env=_env(), pass_fds=(fd,) if r == 0 else (),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    s.close()
    try:
        out = []
        for p in procs:
            o, e = p.communicate(timeout=WAIT)
            out.append((p.returncode, o, e))
        return out
    finally:
        _stop(procs)


# -- the process mesh -------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_psum_over_gloo_equals_the_in_process_mesh(world, tmp_path):
    """Every rank gets the in-process mesh's sum, bit for bit: the
    partials added in shard order (they are chosen so that the order
    shows)."""
    rng = np.random.default_rng(7)
    parts = (rng.standard_normal((world, 6, 3)) * 10.0 ** rng.integers(
        -4, 9, (world, 6, 3))).astype(np.float32)
    parts[:, 0, 0] = [1e8, 1.0, -1e8, 1.0][:world]
    parts = [torch.from_numpy(x) for x in parts]
    work = tmp_path / "parts.pt"
    torch.save(parts, work)
    want = make_mesh(world, device=CPU).run(lambda i, ax: ax.psum(parts[i]))
    got = _group("psum", world, work)
    for r, (rc, out, err) in enumerate(got):
        assert rc == 0, err[-3000:]
        res = json.loads(out)
        assert (res["index"], res["size"], res["psums"]) == (r, world, 1)
        np.testing.assert_array_equal(
            np.asarray(res["sum"], np.float32), want[r].numpy())
    if world == 4:  # and the order shows: (1 + 1) + (1e8 - 1e8) is 2
        assert float(want[0][0, 0]) == 1.0


def test_a_dead_rank_is_an_error_not_a_hang(tmp_path):
    """Rank 1 exits before the collective: rank 0's psum raises
    ``CollectiveError`` long before the group's 30 s timeout."""
    (rc0, out0, err0), (rc1, _, _) = _group("die", 2, tmp_path / "none")
    assert rc1 == 3
    assert rc0 == 0, err0[-3000:]
    res = json.loads(out0)
    assert res["error"] == "CollectiveError"
    assert res["seconds"] < 20.0


def _jax_sharded_step(algo, ref, js, key, jp, n):
    from jax.sharding import PartitionSpec as JP

    jm = jmesh.make_mesh(n)
    sref = jmesh.shard_problem(ref, jm)
    jmod = jax_algo(algo)
    declared = jmesh.state_pspecs(jmod, sref)
    sspecs = {k: declared.get(k, JP()) for k in js}
    fn = jmesh.shard_map(
        lambda p, s, k: jmod.step(p, s, k, jp, axis_name=jmesh.SHARD_AXIS),
        mesh=jm,
        in_specs=(jmesh.problem_pspecs(sref), sspecs, JP()),
        out_specs=sspecs,
        check_vma=False,
    )
    return jax.jit(fn)(sref, js, key)


@pytest.mark.parametrize("algo", ["maxsum", "dsa"])
def test_one_sharded_step_per_rank(algo, tmp_path):
    """One round of two rank processes from a shared state and shared
    draws: bit-equal to the in-process mesh's round, and to the JAX
    ``shard_map`` step within ``test_torch_parallel.py``'s tolerances
    (q through the belief within 1e-6, everything else exact).  And a
    checkpointed run: only rank 0 writes, the in-process mesh's file."""
    n = 2
    ref = jcompile.compile_dcop(coloring_ring(jdcop, 24, with_ternary=True),
                                n_shards=n)
    port = tcompile.compile_dcop(coloring_ring(tdcop, 24, with_ternary=True),
                                 n_shards=n, device=CPU)
    jp = jax_params({}, jax_algo(algo).algo_params)
    tmod = load_algorithm_module(algo)
    tp = prepare_algo_params({}, tmod.algo_params)
    js, ts = _start(algo, ref, port, jp, tp)
    key = jax.random.PRNGKey(11)
    drawn = _jax_draws(algo, key, ref) if algo == "dsa" else None
    work = str(tmp_path / "job.pt")
    torch.save({"problem": port, "algo": algo, "params": tp, "state": ts,
                "drawn": drawn}, work)
    for rc, _, err in _group("step", n, work):
        assert rc == 0, err[-3000:]
    got = torch.load(work + ".out")

    loop = ShardedRounds(shard_problem(port, make_mesh(n, device=CPU)), port,
                         tmod, tp, 0, total_cost)
    here = loop.whole(loop.apply(loop.place(ts), drawn), CPU)
    assert set(got) == set(here)
    for k in here:
        assert torch.equal(got[k], here[k]), k
    if algo == "maxsum":  # the state in its global layout, once
        assert not os.path.exists(work + ".ck1.npz")
        run_batched(port, tmod, tp, rounds=8, chunk_size=4,
                    mesh=make_mesh(n, device=CPU),
                    checkpoint_path=str(tmp_path / "here.npz"))
        with np.load(work + ".ck0.npz") as a, \
                np.load(tmp_path / "here.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = _jax_sharded_step(algo, ref, js, key, jp, n)
    for k in want:
        w, g = np.asarray(want[k]), interop.to_numpy(got[k])
        if k == "q":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# -- the commands -----------------------------------------------------------


def _cli(*args, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "pydcop_tpu_torch", *args], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw,
    )


class _Orchestrator:
    """An ``orchestrator … --port 0`` process whose stderr is read as it
    comes: :meth:`port` waits for the port it announces."""

    def __init__(self, *args, cwd):
        self.proc = _cli("orchestrator", *args, "--port", "0", cwd=cwd)
        self.lines: "queue.Queue" = queue.Queue()
        self.err = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stderr:
            self.err.append(line)
            self.lines.put(line)
        self.lines.put(None)

    def port(self, what="control plane"):
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            try:
                line = self.lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if line is None:
                break
            if line.startswith(f"orchestrator: {what} on port "):
                return int(line.split()[-1])
        raise AssertionError(f"no {what} port announced:\n"
                             + "".join(self.err)[-3000:])

    def result(self, timeout=WAIT):
        out = self.proc.stdout.read()
        self.proc.wait(timeout=timeout)
        return out

    def stderr(self):
        time.sleep(0.2)
        return "".join(self.err)


def _agents(port, *names, extra=()):
    return [
        _cli("agent", "--names", name, "--orchestrator", f"localhost:{port}",
             "--device", CPU, *extra)
        for name in names
    ]


def _parse(text):
    return json.loads(text[text.index("{"):])


def _trace_counters(path):
    counters = {}
    for line in open(path):
        rec = json.loads(line)
        if rec.get("kind") == "metrics":
            counters = rec.get("counters", {})
    return counters


def test_orchestrator_and_agent_equal_the_in_process_mesh(tmp_path):
    """``tests/test_orchestrator.py``'s case on the port: the 12-ring,
    Max-Sum, 32 rounds, chunk 16, seed 5, the orchestrator and one
    agent both ``--runtime spmd``: equal to the in-process
    ``make_mesh(2)`` run bit for bit, the agent's cost the
    orchestrator's, and the best cost within 1e-5 of the JAX in-process
    sharded run."""
    (tmp_path / "ring.yaml").write_text(_ring_yaml())
    orch = _Orchestrator("ring.yaml", "-a", "maxsum", "--nb_agents", "1",
                         "--rounds", "32", "--chunk_size", "16", "--seed",
                         "5", "--runtime", "spmd", "--device", CPU,
                         "--trace", "orch.jsonl", cwd=tmp_path)
    agents = []
    try:
        agents = _agents(orch.port(), "a1",
                         extra=("--runtime", "spmd", "--trace",
                                str(tmp_path / "a1.jsonl")))
        out = orch.result()
        assert orch.proc.returncode == 0, orch.stderr()[-3000:]
        a_out, a_err = agents[0].communicate(timeout=WAIT)
        assert agents[0].returncode == 0, a_err[-3000:]
    finally:
        _stop([orch.proc, *agents])
    result, agent = _parse(out), _parse(a_out)
    assert (result["n_shards"], result["num_processes"]) == (2, 2)
    assert result["backend"] == "gloo"
    assert result["agents"] == ["a1"]
    assert agent["cost"] == result["cost"]
    assert agent["cycle"] == result["cycle"] == 32

    dcop = tdcop.load_dcop_from_file(str(tmp_path / "ring.yaml"))
    mod = load_algorithm_module("maxsum")
    prm = prepare_algo_params({}, mod.algo_params)
    local = run_batched(tcompile.compile_dcop(dcop, n_shards=2, device=CPU),
                        mod, prm, rounds=32, seed=5, chunk_size=16,
                        mesh=make_mesh(2, device=CPU))
    assert result["assignment"] == local.best_assignment
    assert (result["cost"], result["final_cost"], result["status"],
            result["msg_count"]) == (local.best_cost, local.cost,
                                     local.status, local.messages)
    # each rank: one psum a round and one a cost sample; no kernel on
    # the CPU (the wrappers run their plain versions)
    for trace in (tmp_path / "orch.jsonl", tmp_path / "a1.jsonl"):
        c = _trace_counters(trace)
        assert c["spmd.psums"] == 64, c
        assert c.get("kernel.q_update.launches", 0) == 0

    jdcop_ = jdcop.load_dcop_from_file(str(tmp_path / "ring.yaml"))
    from pydcop_tpu.engine.batched import run_batched as jax_run

    jmod = jax_algo("maxsum")
    ref = jax_run(jcompile.compile_dcop(jdcop_, n_shards=2), jmod,
                  jax_params({}, jmod.algo_params), rounds=32, seed=5,
                  chunk_size=16, mesh=jmesh.make_mesh(2))
    np.testing.assert_allclose(ref.best_cost, result["cost"], atol=1e-5)


def test_agent_sigkill_fails_the_orchestrator_fast(tmp_path):
    """``tests/test_orchestrator_failures.py``'s case: an agent SIGKILLed
    mid-run; the orchestrator exits non-zero, naming it, well inside
    20 s, and no rank process outlives the test."""
    (tmp_path / "ring.yaml").write_text(_ring_yaml())
    orch = _Orchestrator("ring.yaml", "-a", "maxsum", "--nb_agents", "1",
                         "--rounds", "200000", "--chunk_size", "8",
                         "--seed", "5", "--heartbeat_timeout", "75",
                         "--abort_grace", "4", "--uiport", "0",
                         "--device", CPU, cwd=tmp_path)
    agents = []
    try:
        agents = _agents(orch.port(), "a1")
        ui = orch.port("live feed")
        _wait_state(ui, lambda s: s.get("cycle", 0) > 0, "first chunk",
                    orch.proc)
        agents[0].send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        orch.result(timeout=60)
        detect = time.monotonic() - t_kill
        err = orch.stderr()
        assert orch.proc.returncode != 0
        assert detect < 20.0, f"took {detect:.1f}s to fail"
        assert ("AgentFailureError" in err and "'a1'" in err) or (
            "FATAL" in err), err[-2000:]
    finally:
        _stop([orch.proc, *agents])


def test_scenario_across_processes_equals_in_process(tmp_path):
    """``--scenario`` with ``--ktarget 1`` on the 24-agent ring across 2
    processes: equal to the in-process ``run_dynamic`` over
    ``make_mesh(2)`` in every key but the times."""
    from pydcop_tpu_torch.dcop.yamldcop import load_scenario
    from pydcop_tpu_torch.engine.dynamic import run_dynamic

    (tmp_path / "ring.yaml").write_text(_ring_yaml(n_agents=24))
    (tmp_path / "scen.yaml").write_text(_SCENARIO)
    orch = _Orchestrator("ring.yaml", "-a", "maxsum", "--nb_agents", "1",
                         "--rounds", "32", "--chunk_size", "16", "--seed",
                         "5", "--scenario", "scen.yaml", "--ktarget", "1",
                         "--device", CPU, cwd=tmp_path)
    agents = []
    try:
        agents = _agents(orch.port(), "a1")
        out = orch.result()
        assert orch.proc.returncode == 0, orch.stderr()[-3000:]
        _, a_err = agents[0].communicate(timeout=WAIT)
        assert agents[0].returncode == 0, a_err[-3000:]
    finally:
        _stop([orch.proc, *agents])
    result = _parse(out)
    assert result["n_shards"] == 2
    removes = [e for e in result["events"]
               if e.get("action") == "remove_agent"]
    assert len(removes) == 1 and removes[0]["agent"] == "a3"
    local = run_dynamic(
        tdcop.load_dcop_from_file(str(tmp_path / "ring.yaml")), "maxsum",
        {}, load_scenario(_SCENARIO), k_target=1, final_rounds=32, seed=5,
        mesh=make_mesh(2, device=CPU), n_shards=2, chunk_size=16,
        device=CPU,
    )
    for k in ("assignment", "cost", "cycle", "status", "events",
              "lost_computations", "agents_final", "replicas"):
        assert result[k] == local[k], k


# -- the elastic runtime ----------------------------------------------------


def _wait_state(ui_port, pred, what, proc):
    """Poll the live feed's ``/state`` until ``pred`` holds (the JAX
    tests' ``_wait_state``)."""
    deadline = time.monotonic() + WAIT
    last = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"orchestrator exited ({proc.returncode}) "
                                 f"waiting for {what}; last={last}")
        try:
            with urllib.request.urlopen(
                    f"http://localhost:{ui_port}/state", timeout=5) as r:
                last = json.loads(r.read().decode())
            if pred(last):
                return last
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}; last={last}")


def _elastic_args():
    return ("ring.yaml", "-a", "maxsum", "--elastic", "--device", CPU,
            "--heartbeat_timeout", "60")


def test_elastic_happy_path(tmp_path):
    (tmp_path / "ring.yaml").write_text(_ring_yaml())
    orch = _Orchestrator(*_elastic_args(), "--nb_agents", "1",
                         "--rounds", "64", "--chunk_size", "16", "--seed",
                         "5", cwd=tmp_path)
    agents = []
    try:
        agents = _agents(orch.port(), "a1")
        out = orch.result()
        assert orch.proc.returncode == 0, orch.stderr()[-3000:]
        a_out, _ = agents[0].communicate(timeout=WAIT)
    finally:
        _stop([orch.proc, *agents])
    r = _parse(out)
    assert (r["status"], r["epochs"], r["events"]) == ("finished", 1, [])
    assert r["cost"] == 0.0  # the ring's 3-colouring optimum
    assert len(r["assignment"]) == 12
    assert _parse(a_out)["deploys"] == 1


def test_elastic_survives_an_agent_sigkill(tmp_path):
    """``tests/test_elastic.py``'s case: one of two agent supervisors
    SIGKILLed after the first barrier; the run re-forms once and
    finishes with the dead partition's variables frozen, and its cost
    is the port's ``solution_cost`` of its assignment."""
    (tmp_path / "ring.yaml").write_text(_ring_yaml())
    orch = _Orchestrator(*_elastic_args(), "--nb_agents", "2",
                         "--rounds", "2000", "--chunk_size", "8", "--seed",
                         "5", "--uiport", "0", cwd=tmp_path)
    agents = []
    try:
        port = orch.port()
        agents = _agents(port, "a1", "a2")
        ui = orch.port("live feed")
        _wait_state(ui, lambda s: s.get("epoch") == 1, "epoch 1",
                    orch.proc)
        agents[1].send_signal(signal.SIGKILL)
        out = orch.result(timeout=WAIT)
        assert orch.proc.returncode == 0, orch.stderr()[-3000:]
    finally:
        _stop([orch.proc, *agents])
    r = _parse(out)
    assert r["status"] == "finished"
    assert r["epochs"] == 2
    lost = [e for e in r["events"] if e["type"] == "participant_lost"]
    assert len(lost) == 1 and lost[0]["participant"] == "a2"
    assert lost[0]["frozen"] == r["lost_computations"]
    assert 0 < len(r["lost_computations"]) <= 4  # 12 vars / 3 parts
    assert len(r["assignment"]) == 12
    assert r["agents_final"] == ["a1"]
    dcop = tdcop.load_dcop_from_file(str(tmp_path / "ring.yaml"))
    assert r["cost"] == dcop.solution_cost(r["assignment"])


def test_discovery_events():
    """``tests/test_elastic.py:test_discovery_events`` on the port's
    ``Discovery``."""
    from pydcop_tpu_torch.infrastructure.discovery import (
        ADDED,
        AGENT,
        COMPUTATION,
        REMOVED,
        Discovery,
    )

    d = Discovery()
    events = []
    unsub = d.subscribe(
        lambda kind, ev, name, detail: events.append(
            (kind, ev, name, detail)
        )
    )
    d.register_agent("a1", capacity=10)
    d.register_computation("v1", "a1")
    d.register_computation("v2", "a1")
    assert d.agents() == ["a1"]
    assert d.computations("a1") == ["v1", "v2"]
    assert d.computation_agent("v1") == "a1"
    assert d.agent_info("a1") == {"capacity": 10}

    orphans = d.unregister_agent("a1")
    assert sorted(orphans) == ["v1", "v2"]
    assert d.agents() == []
    assert d.computations() == []

    kinds = [(k, e, n) for k, e, n, _ in events]
    assert (AGENT, ADDED, "a1") in kinds
    assert (COMPUTATION, ADDED, "v1") in kinds
    assert (COMPUTATION, REMOVED, "v1") in kinds
    assert (AGENT, REMOVED, "a1") in kinds
    assert kinds.index((COMPUTATION, REMOVED, "v2")) < kinds.index(
        (AGENT, REMOVED, "a1")
    )

    unsub()
    d.register_agent("a2")
    assert all(n != "a2" for _, _, n, _ in events)

    with pytest.raises(ValueError):
        d.register_computation("vx", "missing_agent")


def test_the_control_planes_import_no_torch():
    """The elastic supervisors run these modules and must never load
    torch (they cannot wedge in a collective)."""
    code = ("import sys; import pydcop_tpu_torch.infrastructure."
            "orchestrator, pydcop_tpu_torch.infrastructure.elastic; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=WAIT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
