"""The port stands alone: it imports neither jax nor the JAX package.

``tests/conftest.py`` imports jax into every test process, so the
runtime check (an array-built maxsum solve and CPU maxsum and dsa solves
of a YAML file, an inference query on the device path, a budgeted
sparse int8 DPOP solve, a pruned DPOP solve, a SyncBB solve, a
checkpointed, resumed Max-Sum solve, a dynamic run with replicas, an
ILP placement, the ``run`` CLI, ``trace-summary``, ``batch
--simulate``, a solver-service solve and a sharded solve over a CPU
shard mesh, after checking that
``api.ServiceClient`` imports without torch; and, in a second probe, a
``sim`` solve with a compiled island, a ``sim`` solve with an MGM
lockstep island, a thread-mode solve, ``fleet --help``, a batched solve
feeding the live UI, and a process-mode run whose spawned ``agent``
child reports its own loaded modules) runs in a fresh subprocess; a
static AST scan covers every module of the port, ``chip_smoke.py`` and
the plugin example.  Also pinned here: an entry point asked for no
device raises when there is no CUDA device, instead of carrying on on
the CPU.
"""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pydcop_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "pydcop_tpu")

_PROBE = r"""
import sys
# the wire client imports without torch (a client process needs none)
from pydcop_tpu_torch.api import ServiceClient
assert "torch" not in sys.modules and "jax" not in sys.modules
import pydcop_tpu_torch
from pydcop_tpu_torch.api import solve, solve_compiled
from pydcop_tpu_torch.ops.compile import compile_from_arrays
from pydcop_tpu_torch.ops.generate import coloring_arrays

s, t, u = coloring_arrays(200, seed=1)
p = compile_from_arrays(s, t, 3, unary=u, device="cpu")
r = solve_compiled(p, "maxsum", {"damping": 0.5}, rounds=16, cost_every=8)
assert r["cycle"] == 16, r
# the array path needs no PyYAML (the card's machine may lack it)
assert "yaml" not in sys.modules
r = solve(sys.argv[1], "maxsum", rounds=8, device="cpu")
assert r["cost"] == 0.0, r
r = solve(sys.argv[1], "dsa", rounds=16, device="cpu", n_restarts=2)
assert r["cost"] == 0.0 and len(r["restart_costs"]) == 2, r
from pydcop_tpu_torch.api import infer
r = infer(sys.argv[1], "kbest:3", device="always", torch_device="cpu")
assert r["costs"] == [0.0, 0.0, 0.0] and r["telemetry"]["counters"], r
r = solve(sys.argv[1], "dpop", {"util_device": "always"}, device="cpu",
          table_dtype="int8", table_format="sparse", max_util_bytes=16)
assert r["cost"] == 0.0 and r["membound"]["cut_width"] > 0, r
r = solve(sys.argv[1], "syncbb", device="cpu")
assert r["cost"] == 0.0, r
r = solve(sys.argv[1], "dpop", {"util_device": "always"}, bnb="on",
          device="cpu")
assert r["telemetry"]["counters"]["semiring.bnb_passes"] > 0, r
import os, tempfile
ck = os.path.join(tempfile.mkdtemp(), "ck.npz")
solve(sys.argv[1], "maxsum", rounds=8, chunk_size=4, checkpoint_path=ck,
      device="cpu")
r = solve(sys.argv[1], "maxsum", rounds=16, chunk_size=4,
          checkpoint_path=ck, resume=True, device="cpu")
assert r["cycle"] == 16 and os.path.exists(ck), r
r = solve(sys.argv[1], "maxsum", {"belief": "blockdiag"}, rounds=8,
          chunk_size=8, chunk_floor=2, chaos="device_oom=-:2", device="cpu")
assert r["telemetry"]["counters"]["engine.oom_chunk_halvings"] == 2, r
from pydcop_tpu_torch.dcop import load_dcop_from_file, load_scenario_from_file
from pydcop_tpu_torch.engine.dynamic import run_dynamic
r = run_dynamic(load_dcop_from_file(sys.argv[1]), "maxsum", {},
                scenario=load_scenario_from_file(sys.argv[2]),
                distribution="ilp_compref", k_target=1, final_rounds=8,
                device="cpu")
assert r["agents_final"] == ["a1", "a3", "a4"] and r["replicas"], r
import subprocess
out = subprocess.run(
    [sys.executable, "-m", "pydcop_tpu_torch", "run", "-a", "maxsum",
     "-d", "adhoc", "-s", sys.argv[2], "--final_rounds", "8",
     "--device", "cpu", sys.argv[1]],
    capture_output=True, text=True, check=True,
).stdout
assert '"state_transfers"' in out, out
from pydcop_tpu_torch.cli import main
tr = os.path.join(tempfile.mkdtemp(), "t.jsonl")
solve(sys.argv[1], "maxsum", rounds=8, device="cpu", trace=tr)
assert main(["trace-summary", tr]) == 0
assert main(["batch", sys.argv[3], "--simulate", "--result_file",
             os.path.join(tempfile.mkdtemp(), "r.csv")]) == 0
from pydcop_tpu_torch.api import SolverService
with SolverService(device="cpu", max_batch=1) as svc:
    assert svc.solve(sys.argv[1], "maxsum", rounds=4)["status"] == "finished"
import pydcop_tpu_torch.engine.memo, pydcop_tpu_torch.commands.serve
import pydcop_tpu_torch.commands.top, pydcop_tpu_torch.commands.flight_dump
import pydcop_tpu_torch.telemetry.export
import pydcop_tpu_torch.distribution.adhoc, pydcop_tpu_torch.utils.graphs
import pydcop_tpu_torch.utils.various, pydcop_tpu_torch.commands.run
# a sharded Max-Sum solve over a CPU shard mesh
from pydcop_tpu_torch.engine.batched import run_batched
from pydcop_tpu_torch.algorithms import load_algorithm_module
from pydcop_tpu_torch.algorithms import prepare_algo_params
from pydcop_tpu_torch.parallel import make_mesh
mod = load_algorithm_module("maxsum")
ps = compile_from_arrays(s, t, 3, unary=u, n_shards=4, device="cpu")
rs = run_batched(ps, mod, prepare_algo_params({}, mod.algo_params),
                 rounds=8, mesh=make_mesh(4, device="cpu"))
assert rs.cycles == 8, rs
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib") or m.startswith("pydcop_tpu.")
    or m == "pydcop_tpu"
)
print("LOADED", bad)
"""


def test_import_and_cpu_solve_leave_jax_unloaded():
    ring = os.path.join(REPO, "examples", "graph_coloring_3.yaml")
    scenario = os.path.join(REPO, "examples", "dynamic_scenario.yaml")
    sweep = os.path.join(REPO, "examples", "batch_sweep.yaml")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, ring, scenario, sweep],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []"


_HOST_PROBE = r"""
import subprocess, sys
from pydcop_tpu_torch.api import FleetRouter, solve
from pydcop_tpu_torch.distribution import Distribution
d = {"a1": ["v1", "diff_1_2", "diff_1_3"], "a2": ["v2", "v3", "diff_2_3"]}
r = solve(sys.argv[1], "maxsum", {"damping": 0.5}, mode="sim", rounds=20,
          distribution=Distribution(d), accel_agents=["a1"], device="cpu")
assert r["cost"] == 0.0 and r["telemetry"]["counters"]["island.flushes"], r
r = solve(sys.argv[1], "mgm", mode="sim", rounds=20,
          distribution=Distribution({"a1": ["v1"], "a2": ["v2", "v3"]}),
          accel_agents=["a2"], device="cpu")
assert r["final_cost"] == 0.0 and r["telemetry"]["counters"]["island.flushes"], r
r = solve(sys.argv[1], "dsa", mode="thread", timeout=20,
          accel_agents=["a2"], device="cpu")
assert r["cost"] == 0.0, r
out = subprocess.run(
    [sys.executable, "-c",
     "import sys; sys.argv[0] = 'pydcop_tpu_torch'; "
     "from pydcop_tpu_torch.cli import main\n"
     "try:\n main(['fleet', '--help'])\n"
     "except SystemExit:\n pass\n"
     "print(sorted(m for m in sys.modules if m.split('.')[0] in "
     "('jax', 'jaxlib', 'pydcop_tpu')))"],
    capture_output=True, text=True, check=True,
).stdout
assert "--replicas" in out and out.strip().splitlines()[-1] == "[]", out
r = solve(sys.argv[1], "maxsum", rounds=8, device="cpu", ui_port=0)
assert r["cost"] == 0.0, r
# process mode: the orchestrator here, one `agent` child over TCP that
# prints the modules it loaded when its run ends
import socket, threading
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.infrastructure.hostnet import run_host_orchestrator
server = socket.create_server(("127.0.0.1", 0))
port = server.getsockname()[1]
child = subprocess.Popen(
    [sys.executable, "-c",
     "import sys\nfrom pydcop_tpu_torch.cli import main\n"
     "main(sys.argv[1:])\n"
     "print(sorted(m for m in sys.modules if m.split('.')[0] in "
     "('jax', 'jaxlib', 'pydcop_tpu')))",
     "agent", "--names", "a1", "--runtime", "host", "--orchestrator",
     f"127.0.0.1:{port}", "--device", "cpu"],
    stdout=subprocess.PIPE, text=True,
)
r = run_host_orchestrator(load_dcop_from_file(sys.argv[1]), "maxsum", {},
                          nb_agents=1, port=port, server=server,
                          accel_agents=["a1"], register_timeout=60)
out, _ = child.communicate(timeout=60)
assert r["cost"] == 0.0 and child.returncode == 0, (r, out)
assert out.strip().splitlines()[-1] == "[]", out
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib") or m.startswith("pydcop_tpu.")
    or m == "pydcop_tpu"
)
print("LOADED", bad)
"""


def test_host_runtime_island_and_fleet_leave_jax_unloaded():
    ring = os.path.join(REPO, "examples", "graph_coloring_3.yaml")
    proc = subprocess.run(
        [sys.executable, "-c", _HOST_PROBE, ring],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []"


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    # the port's plugin example, which chip_smoke.py runs on the card
    yield os.path.join(REPO, "examples", "greedy_plugin_torch.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "import_module"
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value).split(".")[0]


def test_no_port_module_imports_jax_or_the_jax_package():
    files = list(_sources())
    assert len(files) > 20
    scanned = {os.path.relpath(f, PORT) for f in files}
    for module in ("ops/sparse.py", "ops/membound.py",
                   "algorithms/syncbb.py", "graphs/ordered_graph.py",
                   "engine/checkpoint.py",
                   "commands/generators/taskscheduling.py",
                   "engine/incremental.py", "engine/dynamic.py",
                   "commands/run.py", "graphs/factor_graph.py",
                   "graphs/constraints_hypergraph.py",
                   "distribution/_ilp.py", "distribution/oilp_secp.py",
                   "replication/repair.py",
                   "replication/ucs_hostingcosts.py",
                   "utils/graphs.py", "utils/various.py",
                   "commands/graph.py", "commands/distribute.py",
                   "commands/replica_dist.py", "commands/batch.py",
                   "commands/consolidate.py", "commands/trace_summary.py",
                   "commands/generators/agents.py",
                   "telemetry/summary.py", "telemetry/context.py",
                   "telemetry/flightrec.py", "telemetry/export.py",
                   "engine/memo.py", "engine/service.py",
                   "commands/serve.py", "commands/top.py",
                   "commands/flight_dump.py",
                   "infrastructure/runtime.py", "infrastructure/agents.py",
                   "infrastructure/communication.py",
                   "infrastructure/discovery.py", "faults/chaos.py",
                   "algorithms/_host_maxsum.py", "algorithms/_host_dsa.py",
                   "algorithms/_island_common.py",
                   "algorithms/_island_maxsum.py",
                   "algorithms/_island_dsa.py", "engine/fleet.py",
                   "commands/fleet.py", "algorithms/_tables.py",
                   "algorithms/_host_phased.py",
                   "algorithms/_host_twophase.py",
                   "algorithms/_host_mgm.py", "algorithms/_host_mgm2.py",
                   "algorithms/_host_dba.py", "algorithms/_host_gdba.py",
                   "algorithms/_host_syncbb.py", "algorithms/_host_dpop.py",
                   "algorithms/_island_lockstep.py",
                   "algorithms/_island_mgm.py",
                   "algorithms/_island_dba.py",
                   "algorithms/_island_gdba.py",
                   "infrastructure/hostnet.py", "infrastructure/ui.py",
                   "commands/agent.py", "commands/orchestrator.py",
                   "parallel/__init__.py", "parallel/mesh.py",
                   "commands/lint.py", "commands/bench_history.py",
                   "commands/bench_compare.py", "lint/__init__.py",
                   "lint/config.py", "lint/rules.py"):
        assert module in scanned, module
    for path in files:
        bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
        assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_entry_points_raise_without_cuda(monkeypatch):
    from pydcop_tpu_torch import api, device
    from pydcop_tpu_torch.ops.compile import compile_from_arrays
    from pydcop_tpu_torch.ops.generate import coloring_arrays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ring = os.path.join(REPO, "examples", "graph_coloring_3.yaml")
    with pytest.raises(device.NoCudaDeviceError):
        api.solve(ring, "maxsum", rounds=2)
    for mode in ("sim", "thread"):
        with pytest.raises(device.NoCudaDeviceError):
            api.solve(ring, "maxsum", rounds=2, mode=mode)
    s, t, u = coloring_arrays(50, seed=1)
    with pytest.raises(device.NoCudaDeviceError):
        compile_from_arrays(s, t, 3, unary=u)
    with pytest.raises(device.NoCudaDeviceError):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "maxsum",
         "--rounds", "2", ring],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert "NoCudaDeviceError" in proc.stderr
    scenario = os.path.join(REPO, "examples", "dynamic_scenario.yaml")
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "run", "-a", "maxsum",
         "-d", "adhoc", "-s", scenario, "--final_rounds", "2", ring],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert "NoCudaDeviceError" in proc.stderr
