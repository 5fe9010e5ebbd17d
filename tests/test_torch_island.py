"""The port's compiled islands against the JAX package's, on the CPU.

A Max-Sum island compiles its agent's subgraph (owned variables and
factors, plus one shadow variable per boundary edge) and steps the
port's batched ``maxsum.step`` on it; a DSA-family island steps its
algorithm's ``draws``/``apply`` round.  The packages draw different
random numbers (ROADMAP C, 'Island noise'), so the JAX and port islands
get the SAME noise here (made with numpy from each variable's name) and
the DSA islands the JAX island's own draws, rebuilt from its keys.  The
JAX engine runs with its per-slot gather belief (ROADMAP C, 'Belief
summation').  From that shared state whole sim runs with islands equal
the JAX package's in every result key but ``time``.
"""

import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pydcop_tpu.algorithms import maxsum as jax_maxsum  # noqa: E402
# both ``amaxsum`` modules bind ``maxsum.init_state`` when imported:
# import them here, before ``shared_state`` patches it, so no later test
# inherits the patch
import pydcop_tpu.algorithms.amaxsum  # noqa: E402, F401
import pydcop_tpu_torch.algorithms.amaxsum  # noqa: E402, F401
from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load  # noqa: E402
from pydcop_tpu.distribution import Distribution as JaxDistribution  # noqa: E402
from pydcop_tpu.infrastructure import solve_host as jax_solve_host  # noqa: E402

from pydcop_tpu_torch.algorithms import maxsum as port_maxsum  # noqa: E402
from pydcop_tpu_torch.algorithms._island_dsa import DsaIsland  # noqa: E402
from pydcop_tpu_torch.dcop.yamldcop import load_dcop as port_load  # noqa: E402
from pydcop_tpu_torch.distribution import Distribution  # noqa: E402
from pydcop_tpu_torch.infrastructure import solve_host  # noqa: E402
from pydcop_tpu_torch.telemetry import session  # noqa: E402


@pytest.fixture
def shared_state(monkeypatch):
    """Both packages' islands start from the same noise (a numpy draw
    per variable name, zero on shadows as the islands set it), and the
    JAX engine sums beliefs with the per-slot gather the port uses."""
    from pydcop_tpu.ops import costs

    monkeypatch.setattr(costs, "CPU_SEGMENT_MIN_EDGES", 1 << 62)

    def noise_for(problem, level):
        d = problem.d_max
        cols = [
            np.random.default_rng(zlib.crc32(name.encode())).random(d)
            for name in problem.var_names
        ]
        return (level * np.stack(cols, axis=1)).astype(np.float32)

    jax_init, port_init = jax_maxsum.init_state, port_maxsum.init_state

    def jax_state(problem, key, params):
        st = jax_init(problem, key, params)
        return {**st, "noise": jnp.asarray(
            noise_for(problem, params.get("noise", 0.0)))}

    def port_state(problem, seed, params, batch=()):
        st = port_init(problem, seed, params, batch)
        noise = noise_for(problem, params.get("noise", 0.0))
        return {**st, "noise": torch.from_numpy(noise).to(problem.device)}

    monkeypatch.setattr(jax_maxsum, "init_state", jax_state)
    monkeypatch.setattr(port_maxsum, "init_state", port_state)
    yield


def _grid_yaml(side: int) -> str:
    """``generate graph_coloring --graph grid -n side² -c 3 --soft
    --noise 0.02 --seed 1`` (the port's generator writes the JAX
    package's text)."""
    import argparse

    from pydcop_tpu_torch.commands.generators.graphcoloring import generate
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

    args = argparse.Namespace(
        graph="grid", variables_count=side * side, colors_count=3,
        soft=True, noise=0.02, seed=1, intentional=False,
        agents_count=None, capacity=100.0, p_edge=0.5, m_edge=2,
    )
    return dcop_yaml(generate(args))


def three_agent_split(dcop, side: int, lo: int, hi: int, factors=True):
    """``{agent: [computations]}``: rows ``[0, lo)`` on ``a0``, rows
    ``[lo, hi)`` on ``a2``, the rest on ``a1``; each factor on the agent
    of its first variable."""
    def agent(vname):
        row = int(vname[1:]) // side
        return "a0" if row < lo else ("a2" if row < hi else "a1")

    mapping = {"a0": [], "a1": [], "a2": []}
    for v in dcop.variables:
        mapping[agent(v)].append(v)
    if factors:
        for c in dcop.constraints.values():
            mapping[agent(c.dimensions[0].name)].append(c.name)
    return mapping


def _same(rj, rt):
    assert set(rj) == set(rt)
    for k in rj:
        if k != "time":
            assert rt[k] == rj[k], k


def _run_both(text, algo, params, mapping, accel, seed=1, rounds=60):
    dj, dt = jax_load(text), port_load(text)
    rj = jax_solve_host(
        dj, algo, params, mode="sim", rounds=rounds, seed=seed,
        distribution=JaxDistribution(mapping), accel_agents=accel,
    )
    with session() as tel:
        rt = solve_host(
            dt, algo, params, mode="sim", rounds=rounds, seed=seed,
            distribution=Distribution(mapping), accel_agents=accel,
            device="cpu",
        )
        counters = tel.summary()["counters"]
    # the islands really ran
    assert counters["island.flushes"] >= len(accel)
    return rj, rt


@pytest.mark.parametrize("algo", ["maxsum", "amaxsum"])
def test_grid_islands_sim_equals_jax(algo, shared_state):
    side = 10
    text = _grid_yaml(side)
    mapping = three_agent_split(port_load(text), side, 4, 6)
    rj, rt = _run_both(text, algo, {"damping": 0.5}, mapping, ["a0", "a1"])
    _same(rj, rt)
    assert rt["msg_count"] > 0 and rt["assignment"]


# -- one flush ---------------------------------------------------------


def _defs(pkg, dcop, algo="maxsum", params=None):
    import importlib

    algos = importlib.import_module(f"{pkg}.algorithms")
    graphs = importlib.import_module(f"{pkg}.graphs")
    module = algos.load_algorithm_module(algo)
    params = algos.prepare_algo_params(params or {}, module.algo_params)
    graph = graphs.load_graph_module(
        module.GRAPH_TYPE).build_computation_graph(dcop)
    algo_def = algos.AlgorithmDef(algo, params, dcop.objective)
    return module, {n.name: algos.ComputationDef(n, algo_def)
                    for n in graph.nodes}


class _Sink:
    """Collects what island proxies post."""

    def __init__(self):
        self.sent = []

    def __call__(self, src, dest, msg):
        self.sent.append((src, dest, dict(msg.costs)))


def _island_pair(text, names, seed=2):
    dj, dt = jax_load(text), port_load(text)
    mj, defs_j = _defs("pydcop_tpu", dj, params={"damping": 0.5})
    mt, defs_t = _defs("pydcop_tpu_torch", dt, params={"damping": 0.5})
    pj = mj.build_island([defs_j[n] for n in sorted(names)], dj, seed=seed)
    pt = mt.build_island([defs_t[n] for n in sorted(names)], dt, seed=seed,
                         device="cpu")
    sinks = []
    for proxies in (pj, pt):
        sink = _Sink()
        for p in proxies:
            p.message_sender = sink
        sinks.append(sink)
    return pj, pt, sinks


def _r_shadow(island, torch_side):
    edges = sorted(island._shadow_edge.values())
    r = island._state["r"]
    r = r.numpy() if torch_side else np.asarray(r)
    return r[:, edges]


def test_island_flush_equals_jax(shared_state):
    side = 4
    text = _grid_yaml(side)
    # the middle rows 1-2: shadows below, remote factors above
    mapping = three_agent_split(port_load(text), side, 1, 3)
    pj, pt, (sj, st) = _island_pair(text, mapping["a2"])
    for proxies in (pj, pt):
        for p in proxies:
            p.start()
    ij, it = pj[0]._island, pt[0].island
    np.testing.assert_array_equal(_r_shadow(it, True), _r_shadow(ij, False))
    np.testing.assert_array_equal(
        it._state["values"].numpy(), np.asarray(ij._state["values"]))
    assert st.sent == sj.sent and st.sent
    # boundary traffic in: a q pin on a shadow edge and an r fold on an
    # owned variable, then one steady flush each
    (f, u), _ = sorted(ij._shadow_of.items())[0]
    owned_v = sorted(ij._remote_factors_of)[0]
    g = ij._remote_factors_of[owned_v][0]
    for isl in (ij, it):
        isl.receive(f, u, {0: 0.0, 1: 2.5, 2: 1.0})
        isl.receive(owned_v, g, {0: 3.0, 1: 0.0, 2: 1.5})
    np.testing.assert_array_equal(_r_shadow(it, True), _r_shadow(ij, False))
    np.testing.assert_array_equal(
        it._state["values"].numpy(), np.asarray(ij._state["values"]))
    np.testing.assert_array_equal(it._state["q"].numpy(),
                                  np.asarray(ij._state["q"]))
    assert st.sent == sj.sent


def test_boundary_r_fold_changes_the_island_belief():
    """An r message from a remote factor folds into the owned variable's
    unary: the next flush sees it (a stale cached ``unary_t`` would
    leave the value where it was)."""
    text = _grid_yaml(3)
    dt = port_load(text)
    mt, defs = _defs("pydcop_tpu_torch", dt, params={"damping": 0.5})
    mapping = three_agent_split(dt, 3, 1, 2)  # a2: the middle row
    proxies = mt.build_island([defs[n] for n in mapping["a2"]], dt,
                              seed=0, device="cpu")
    for p in proxies:
        p.message_sender = lambda *a: None
        p.start()
    isl = proxies[0].island
    v = sorted(isl._remote_factors_of)[0]
    slot = isl._slot[v]
    before = int(isl._state["values"][slot])
    want = (before + 1) % 3
    costs = {k: (0.0 if k == want else 50.0) for k in range(3)}
    isl.receive(v, isl._remote_factors_of[v][0], costs)
    assert int(isl._state["values"][slot]) == want
    assert isl.flushes == 2


# -- the JAX package's island cases (tests/test_island.py) ------------

def _chain_text(n=6, objective="min", reward=False):
    lines = [f"name: chain", f"objective: {objective}", "domains:",
             "  colors: {values: [0, 1, 2]}", "variables:"]
    lines += [f"  v{i}: {{domain: colors}}" for i in range(n)]
    lines.append("constraints:")
    for i in range(n - 1):
        fn = (f"0 if v{i} == v{i+1} else 1" if reward
              else f"1 if v{i} == v{i+1} else 0")
        lines += [f"  c{i}:", "    type: intention", f"    function: {fn}"]
    lines.append("agents: [a0, a1]")
    return "\n".join(lines) + "\n"


MIXED = """name: mixed
objective: min
domains:
  d4: {values: [0, 1, 2, 3]}
  d2: {values: [0, 1]}
variables:
  v0: {domain: d4}
  v1: {domain: d2}
  v2: {domain: d4}
constraints:
  c0: {type: intention, function: 5 if v0 == v1 else 0}
  c1: {type: intention, function: 5 if v1 == v2 else 0}
agents: [a0, a1]
"""


@pytest.mark.parametrize("case", ["boundary_factor", "mixed_domains", "max"])
def test_island_cases_equal_jax(case, shared_state):
    """The island owns a factor whose scope is split (the shadow path),
    a remote shadow with a smaller domain than the island's d_max (the
    BIG pin on the padded tail), and a 'max' objective."""
    if case == "boundary_factor":
        text, island = _chain_text(), ["v0", "v1", "c0", "c1"]
    elif case == "mixed_domains":
        text, island = MIXED, ["v0", "c0"]
    else:
        text, island = _chain_text(4, "max", reward=True), [
            "v0", "v1", "c0", "c1"]
    dt = port_load(text)
    _, defs = _defs("pydcop_tpu_torch", dt)
    mapping = {"a0": island, "a1": sorted(set(defs) - set(island))}
    rj, rt = _run_both(text, "maxsum", {"damping": 0.5}, mapping, ["a0"],
                       seed=3, rounds=200)
    _same(rj, rt)
    assert rt["status"] == "finished"
    best = 3.0 if case == "max" else 0.0
    assert rt["cost"] == best


# -- the DSA island ----------------------------------------------------


def _jax_dsa_draws(key, problem, n_rounds):
    out = []
    n, d = problem.n_vars, problem.d_max
    for k in jax.random.split(key, n_rounds):
        k_tie, k_move = jax.random.split(k)
        out.append({
            "tie": torch.from_numpy(np.array(
                jax.random.uniform(k_tie, (n, d)))),
            "move": torch.from_numpy(np.array(
                jax.random.uniform(k_move, (n,)))),
        })
    return out


@pytest.fixture
def jax_island_draws(monkeypatch):
    """The port's DSA islands draw what the JAX island draws: its key
    ``PRNGKey(stable_seed)`` folded with the flush count, split per
    round."""
    def draws(self, problem, n_rounds):
        key = jax.random.fold_in(
            jax.random.PRNGKey(self.seed), self.flushes)
        return _jax_dsa_draws(key, problem, n_rounds)

    monkeypatch.setattr(DsaIsland, "draws", draws)
    yield


@pytest.mark.parametrize("variant", ["A", "B"])
def test_dsa_islands_sim_equal_jax(variant, shared_state, jax_island_draws):
    side = 6
    text = _grid_yaml(side)
    mapping = three_agent_split(port_load(text), side, 2, 3, factors=False)
    params = {"variant": variant, "probability": 0.7, "initial": "declared"}
    rj, rt = _run_both(text, "dsa", params, mapping, ["a0", "a1"], rounds=40)
    _same(rj, rt)
    assert rt["msg_count"] > 0


def test_dsa_island_apply_equals_jax_step(jax_island_draws, shared_state):
    """Island bursts: the port's ``apply`` on the JAX island's draws
    gives the JAX ``step``'s values round after round."""
    from pydcop_tpu.algorithms import dsa as jdsa
    from pydcop_tpu.ops.compile import compile_dcop as jcompile

    from pydcop_tpu_torch.algorithms import dsa as tdsa
    from pydcop_tpu_torch.ops.compile import compile_dcop as tcompile

    text = _grid_yaml(5)
    pj, pt = jcompile(jax_load(text)), tcompile(port_load(text), device="cpu")
    params = {"variant": "B", "probability": 0.7}
    values = np.random.default_rng(3).integers(0, 3, pj.n_vars).astype(np.int32)
    key = jax.random.PRNGKey(11)
    sj = {"values": jnp.asarray(values)}
    st = {"values": torch.from_numpy(values)}
    for k, drawn in zip(jax.random.split(key, 4),
                        _jax_dsa_draws(key, pt, 4)):
        sj = jdsa.step(pj, sj, k, params)
        st = tdsa.apply(pt, st, params, drawn)
        np.testing.assert_array_equal(st["values"].numpy(),
                                      np.asarray(sj["values"]))


def test_island_thread_mode_reaches_the_tree_optimum():
    from pydcop_tpu_torch.api import solve

    text = _chain_text()
    dt = port_load(text)
    _, defs = _defs("pydcop_tpu_torch", dt)
    island = ["v0", "v1", "v2", "c0", "c1"]
    mapping = {"a0": island, "a1": sorted(set(defs) - set(island))}
    t0 = time.perf_counter()
    r = solve(dt, "maxsum", {"damping": 0.5}, mode="thread", timeout=30,
              distribution=Distribution(mapping), accel_agents=["a0"],
              device="cpu")
    assert r["cost"] == 0.0 and r["status"] == "finished"
    assert time.perf_counter() - t0 < 30


def test_island_counters_in_the_telemetry_block():
    from pydcop_tpu_torch.api import solve

    text = _grid_yaml(4)
    mapping = three_agent_split(port_load(text), 4, 2, 2)
    r = solve(port_load(text), "maxsum", {"damping": 0.5}, mode="sim",
              rounds=20, seed=1, distribution=Distribution(mapping),
              accel_agents=["a0", "a1"], device="cpu")
    counters = r["telemetry"]["counters"]
    assert counters["island.flushes"] >= 2
    assert counters["island.boundary_msgs"] > 0
