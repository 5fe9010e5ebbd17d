"""External algorithm plugins by dotted module name, on the port.

The cases of the JAX package's ``tests/test_extending.py`` on the port:
a dotted name loads and solves, reaches the agent processes of
``mode="process"``, must be a plugin (``GRAPH_TYPE`` or ``solve_host``,
and ``algo_params``), a broken import and a missing module are worded
apart, an unknown plain name lists the available algorithms, a relative
name is refused, and ``accel_agents`` without island support fails
before any fork.

The same greedy plugin is written once for each package: the JAX form
below (the contract of ``docs/extending.md``: ``init_state(problem,
key, params)``, ``step(problem, state, key, params, axis_name)``) and
the port's form, ``examples/greedy_plugin_torch.py``
(``init_state(problem, seed, params, batch)``, ``step(problem, state,
params, gen)``).  Both are deterministic, so their runs on the ring are
equal; every refusal's message is the JAX package's, module paths
mapped.
"""

import os
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from pydcop_tpu.algorithms import (  # noqa: E402
    load_algorithm_module as jax_load_algorithm_module,
)

from pydcop_tpu_torch.algorithms import (  # noqa: E402
    AlgorithmDefError,
    load_algorithm_module,
)
from pydcop_tpu_torch.api import solve  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PLUGIN = os.path.join(REPO, "examples", "greedy_plugin_torch.py")

JAX_PLUGIN = textwrap.dedent(
    """
    # greedy best response with alternating parity classes (JAX form)
    import jax.numpy as jnp
    from pydcop_tpu.ops.costs import local_cost_sweep

    GRAPH_TYPE = "constraints_hypergraph"
    algo_params = []

    def init_state(problem, key, params):
        return {"values": problem.init_idx, "t": jnp.int32(0)}

    def step(problem, state, key, params, axis_name=None):
        local = local_cost_sweep(problem, state["values"], axis_name)
        parity = jnp.arange(problem.n_vars) % 2
        cand = jnp.argmin(local, axis=1).astype(state["values"].dtype)
        move = parity == state["t"] % 2
        return {"values": jnp.where(move, cand, state["values"]),
                "t": state["t"] + 1}

    def values_from_state(state):
        return state["values"]

    def messages_per_round(problem, params=None):
        import numpy as np
        return int(np.asarray(problem.neighbor_mask).sum())

    def computation_memory(node):
        return len(node.neighbors)

    def communication_load(node, neighbor_name):
        return 1.0

    def build_computation(comp_def, seed=0):
        from pydcop_tpu.algorithms import _host_dsa
        return _host_dsa.build_computation(
            comp_def, seed=seed, variant="C", probability=1.0
        )
    """
)


def ring(n=8, colors=3, pkg="pydcop_tpu_torch"):
    import importlib

    dcop_mod = importlib.import_module(f"{pkg}.dcop.dcop")
    objs = importlib.import_module(f"{pkg}.dcop.objects")
    rels = importlib.import_module(f"{pkg}.dcop.relations")
    d = objs.Domain("colors", "", list(range(colors)))
    dcop = dcop_mod.DCOP(f"ring{n}")
    vs = [objs.Variable(f"v{i}", d) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(n):
        dcop.add_constraint(rels.constraint_from_str(
            f"c{i}", f"1 if v{i} == v{(i + 1) % n} else 0", vs))
    return dcop


def _on_path(tmp_path, package, files):
    pkg = tmp_path / package
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    for name, text in files.items():
        (pkg / name).write_text(text)
    sys.path.insert(0, str(tmp_path))


def _off_path(tmp_path, package):
    sys.path.remove(str(tmp_path))
    for m in [m for m in sys.modules
              if m == package or m.startswith(package + ".")]:
        sys.modules.pop(m, None)


@pytest.fixture()
def plugin_on_path(tmp_path):
    """``extlab.greedy`` (the port's form) and ``jaxlab.greedy`` (the
    JAX form) on ``sys.path``."""
    _on_path(tmp_path, "extlab", {"greedy.py": open(PORT_PLUGIN).read()})
    (tmp_path / "jaxlab").mkdir()
    (tmp_path / "jaxlab" / "__init__.py").write_text("")
    (tmp_path / "jaxlab" / "greedy.py").write_text(JAX_PLUGIN)
    try:
        yield "extlab.greedy"
    finally:
        _off_path(tmp_path, "extlab")
        for m in ("jaxlab", "jaxlab.greedy"):
            sys.modules.pop(m, None)


def _refusal(load, name):
    with pytest.raises(Exception) as info:
        load(name)
    return type(info.value).__name__, str(info.value).replace(
        "pydcop_tpu_torch.", "pydcop_tpu.")


def test_dotted_name_loads_and_solves(plugin_on_path):
    mod = load_algorithm_module(plugin_on_path)
    assert mod.GRAPH_TYPE == "constraints_hypergraph"
    result = solve(ring(8, 3), plugin_on_path, rounds=60, seed=0,
                   device="cpu")
    assert result["cost"] == 0.0
    assert result["msg_count"] > 0


def test_plugin_runs_equal_jax(plugin_on_path):
    """The two forms of the plugin, each on its package's batched
    engine, give the same run on the ring."""
    from pydcop_tpu.api import solve as jax_solve

    got = solve(ring(8, 3), plugin_on_path, rounds=60, seed=0,
                device="cpu")
    want = jax_solve(ring(8, 3, "pydcop_tpu"), "jaxlab.greedy", rounds=60,
                     seed=0)
    keys = ("assignment", "cost", "final_assignment", "final_cost",
            "cycle", "msg_count", "msg_size", "status", "cost_trace")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def test_dotted_name_reaches_process_mode_children(plugin_on_path):
    # the forked agent processes inherit the plugin's sys.path entry
    # (api._solve_process forwards it through PYTHONPATH)
    result = solve(
        ring(6, 3), plugin_on_path, mode="process", nb_agents=2,
        timeout=60,
    )
    assert result["status"] in ("finished", "stopped", "msg_budget")
    assert set(result["assignment"]) == {f"v{i}" for i in range(6)}


def test_dotted_name_must_be_a_plugin():
    with pytest.raises(AlgorithmDefError, match="not an algorithm plugin"):
        load_algorithm_module("os.path")  # importable, but no GRAPH_TYPE
    assert _refusal(load_algorithm_module, "os.path") == _refusal(
        jax_load_algorithm_module, "os.path")


def test_plugin_without_algo_params_refused_as_jax(tmp_path):
    _on_path(tmp_path, "paramlab", {"noparams.py": "GRAPH_TYPE = 'x'\n"})
    try:
        got = _refusal(load_algorithm_module, "paramlab.noparams")
        want = _refusal(jax_load_algorithm_module, "paramlab.noparams")
    finally:
        _off_path(tmp_path, "paramlab")
    assert got == want and "declares no algo_params" in got[1]


def test_broken_external_plugin_reports_import_failure(tmp_path):
    _on_path(tmp_path, "brokenlab",
             {"bad.py": "import not_a_real_dependency\n"})
    try:
        with pytest.raises(
            AlgorithmDefError, match="exists but failed to import"
        ):
            load_algorithm_module("brokenlab.bad")
        with pytest.raises(AlgorithmDefError) as ei:
            load_algorithm_module("brokenlab.nope")
        assert "available" not in str(ei.value)
        for name in ("brokenlab.bad", "brokenlab.nope"):
            assert _refusal(load_algorithm_module, name) == _refusal(
                jax_load_algorithm_module, name)
    finally:
        _off_path(tmp_path, "brokenlab")


def test_unknown_plain_name_lists_available():
    with pytest.raises(AlgorithmDefError, match="available"):
        load_algorithm_module("definitely_not_an_algo")
    # the same list: every algorithm of the JAX package is ported
    assert _refusal(load_algorithm_module, "definitely_not_an_algo") == (
        _refusal(jax_load_algorithm_module, "definitely_not_an_algo"))


def test_relative_name_rejected_cleanly():
    with pytest.raises(AlgorithmDefError, match="relative"):
        load_algorithm_module(".foo")
    assert _refusal(load_algorithm_module, ".foo") == _refusal(
        jax_load_algorithm_module, ".foo")


def test_solve_host_only_external_plugin_loads(tmp_path):
    _on_path(tmp_path, "exactlab", {"solver.py": (
        "algo_params = []\n"
        "def solve_host(dcop, params, timeout=None):\n"
        "    return {}\n")})
    try:
        mod = load_algorithm_module("exactlab.solver")
        assert hasattr(mod, "solve_host")
    finally:
        _off_path(tmp_path, "exactlab")


def test_accel_agents_without_island_support_fails_prefork():
    from pydcop_tpu.api import solve as jax_solve

    errors = []
    for run, pkg in ((solve, "pydcop_tpu_torch"), (jax_solve, "pydcop_tpu")):
        with pytest.raises(ValueError, match="no compiled-island support") \
                as info:
            run(ring(6, 3, pkg), "mgm2", mode="process", nb_agents=2,
                accel_agents=["agent_0"], timeout=30)
        errors.append(str(info.value))
    assert errors[0] == errors[1]

