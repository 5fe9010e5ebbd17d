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


# -- the lockstep islands (MGM, DBA, GDBA) -------------------------------
#
# MGM, DBA and GDBA break ties by name and draw their initial values from
# ``random.Random(stable_seed(seed, name))``: no jax randomness reaches a
# lockstep island, so a mixed run must equal the JAX package's mixed run
# and the port's all-host run bit for bit, value histories included
# (tolerance: none).  The JAX sweep sums with the per-slot gather the port
# uses (``sweep_pin``).


@pytest.fixture
def sweep_pin(monkeypatch):
    from pydcop_tpu.ops import costs

    monkeypatch.setattr(costs, "CPU_SEGMENT_MIN_EDGES", 1 << 62)
    yield


def _model(pkg):
    import importlib

    return (importlib.import_module(f"{pkg}.dcop.dcop").DCOP,
            importlib.import_module(f"{pkg}.dcop.objects"),
            importlib.import_module(
                f"{pkg}.dcop.relations").NAryMatrixRelation)


def _cycle_dcop(pkg, n, colors, closed):
    """A path v0-...-v{n-1} of equality penalties, closed into a ring
    when ``closed``."""
    DCOP, objects, Rel = _model(pkg)
    d = objects.Domain("colors", "", list(range(colors)))
    dcop = DCOP("cycle" if closed else "chain", objective="min")
    vs = [objects.Variable(f"v{i}", d) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(n if closed else n - 1):
        dcop.add_constraint(Rel([vs[i], vs[(i + 1) % n]], np.eye(colors),
                                name=f"c{i}"))
    return dcop


def _stuck_coloring(pkg):
    """The 24-variable noisy coloring MGM stays stuck on
    (``tests/test_torch_host_runtime.py:_coloring``)."""
    from tests.test_torch_host_runtime import _coloring

    return _coloring(pkg, 24)


def _lockstep_run(pkg, dcop, algo, params, island, seed, sim_seed, budget):
    """``island``'s variables on one lockstep island (the CPU for the
    port), the others as host computations, run by the ``sim`` loop."""
    import importlib

    module, defs = _defs(pkg, dcop, algo, params)
    kw = {"device": "cpu"} if pkg == "pydcop_tpu_torch" else {}
    comps = (module.build_island([defs[n] for n in sorted(island)], dcop,
                                 seed=seed, **kw) if island else [])
    comps += [module.build_computation(defs[n], seed=seed)
              for n in sorted(set(defs) - set(island))]
    runtime = importlib.import_module(f"{pkg}.infrastructure.runtime")
    vc = importlib.import_module(
        f"{pkg}.infrastructure.computations").VariableComputation
    _, delivered, _ = runtime._run_sim(
        comps, 60, budget, sim_seed, time.perf_counter(), lambda *a: None)
    var = [c for c in comps if isinstance(c, vc)]
    assignment = {c.name: c.current_value for c in var}
    return dict(
        assignment=assignment, cost=dcop.solution_cost(assignment),
        histories={c.name: list(c.value_history) for c in var},
        delivered=delivered, comps=comps,
    )


def _three_ways(make, algo, params, island, seed, sim_seed, budget):
    """The port's mixed and all-host runs and the JAX mixed run."""
    mixed = _lockstep_run("pydcop_tpu_torch", make("pydcop_tpu_torch"),
                          algo, params, island, seed, sim_seed, budget)
    host = _lockstep_run("pydcop_tpu_torch", make("pydcop_tpu_torch"),
                         algo, params, (), seed, sim_seed, 2 * budget)
    jax_mixed = _lockstep_run("pydcop_tpu", make("pydcop_tpu"), algo,
                              params, island, seed, sim_seed, budget)
    for k in ("assignment", "cost", "histories", "delivered"):
        assert mixed[k] == jax_mixed[k], k
    return mixed, host


LOCKSTEP_CASES = [("mgm", {}), ("dba", {})] + [
    ("gdba", {"increase_mode": m}) for m in ("E", "R", "C", "T")]


@pytest.mark.parametrize("algo,params", LOCKSTEP_CASES)
def test_lockstep_island_equals_jax_and_the_all_host_run(algo, params,
                                                         sweep_pin):
    """Half a chain on the island: the mixed run replays the all-host
    run exactly while the interior messages become tensor ops."""
    mixed, host = _three_ways(
        lambda pkg: _cycle_dcop(pkg, 10, 3, closed=False), algo, params,
        {f"v{i}" for i in range(5)}, seed=3, sim_seed=5, budget=4_000)
    assert mixed["cost"] == host["cost"] == 0.0
    assert mixed["assignment"] == host["assignment"]
    assert mixed["histories"] == host["histories"]
    island = mixed["comps"][0].island
    assert island.flushes > 0 and island.boundary_msgs > 0
    assert mixed["delivered"] > 0


@pytest.mark.parametrize("algo", ["dba", "gdba"])
def test_lockstep_island_multi_neighbor_boundary(algo, sweep_pin):
    """A frustrated odd ring (2 colors) with every even variable but
    the last islanded: each remote borders TWO island variables, so its
    payload reaches the island through two proxies, and breakout flags
    do cross the seam.  The run never settles, and the budgets cut the
    mixed and all-host runs at different rounds: each history is a
    prefix-equal of the other, and the mixed run equals the JAX one."""
    params = {"increase_mode": "R"} if algo == "gdba" else {}
    mixed, host = _three_ways(
        lambda pkg: _cycle_dcop(pkg, 9, 2, closed=True), algo, params,
        {f"v{i}" for i in range(0, 8, 2)}, seed=4, sim_seed=9,
        budget=6_000)
    for v, h in host["histories"].items():
        m = mixed["histories"][v]
        k = min(len(m), len(h))
        assert k >= 6, (v, m, h)
        assert m[:k] == h[:k], (v, m, h)


@pytest.mark.parametrize("algo,params", [
    ("dba", {}), ("gdba", {"increase_mode": "R"})])
def test_lockstep_island_breaks_out_of_the_mgm_minimum(algo, params,
                                                      sweep_pin):
    """Every second variable islanded (many boundary constraints): the
    weight increases crossing the seam take the mixed run out of the
    minimum MGM stays in, exactly as the JAX mixed run does."""
    mixed = _lockstep_run(
        "pydcop_tpu_torch", _stuck_coloring("pydcop_tpu_torch"), algo,
        params, {f"v{i}" for i in range(0, 24, 2)}, 0, 0, 40_000)
    jax_mixed = _lockstep_run(
        "pydcop_tpu", _stuck_coloring("pydcop_tpu"), algo, params,
        {f"v{i}" for i in range(0, 24, 2)}, 0, 0, 40_000)
    assert mixed["cost"] < 0.5
    for k in ("assignment", "cost", "histories", "delivered"):
        assert mixed[k] == jax_mixed[k], k


def test_gdba_island_applies_each_senders_flags_once():
    """Remote ``u`` borders island variables ``v0`` and ``v2``: its
    (value, flags) payload arrives through both proxies, and its cell
    increase must apply once, as at every host endpoint."""
    DCOP, objects, Rel = _model("pydcop_tpu_torch")
    d2 = objects.Domain("colors", "", [0, 1])
    dcop = DCOP("tri", objective="min")
    v0, u, v2 = (objects.Variable(nm, d2) for nm in ("v0", "u", "v2"))
    for v in (v0, u, v2):
        dcop.add_variable(v)
    for name, pair in (("c0", [v0, u]), ("c1", [u, v2]), ("c2", [v0, v2])):
        dcop.add_constraint(Rel(pair, np.eye(2), name=name))
    module, defs = _defs("pydcop_tpu_torch", dcop, "gdba")
    comps = module.build_island([defs["v0"], defs["v2"]], dcop, seed=1,
                                device="cpu")
    island = comps[0].island
    for c in comps:
        c.message_sender = lambda s, d, m: None
    for c in comps:
        c.start()
    k, row, _ = island._con_meta["c0"]
    before = island._weights[k][row].copy()
    got = {("v0", "u"): (0, [("c0", [(0, 0)])]),
           ("v2", "u"): (0, [("c0", [(0, 0)])])}
    island._pin_values(got)
    island.phase0_complete(got)
    assert island._weights[k][row][0] - before[0] == 1.0


def test_mgm_island_pure_reaches_a_proper_coloring(sweep_pin):
    """The whole chain on one island: the no-boundary rounds alone reach
    a conflict-free coloring, with no wire message, in the values the
    JAX pure island reaches."""
    runs = []
    for pkg in ("pydcop_tpu_torch", "pydcop_tpu"):
        dcop = _cycle_dcop(pkg, 8, 3, closed=False)
        module, defs = _defs(pkg, dcop, "mgm")
        kw = {"device": "cpu"} if pkg == "pydcop_tpu_torch" else {}
        comps = module.build_island(list(defs.values()), dcop, seed=1, **kw)
        assert {c.name for c in comps} == set(defs)
        sent = []
        for c in comps:
            c.message_sender = lambda s, d, m: sent.append((s, d))
        for c in comps:
            c.start()
        assignment = {c.name: c.current_value for c in comps}
        assert dcop.solution_cost(assignment) == 0.0 and sent == []
        runs.append(assignment)
    assert runs[0] == runs[1]


@pytest.mark.parametrize("algo,params", LOCKSTEP_CASES[:3])
def test_lockstep_islands_grid_sim_equals_jax(algo, params, sweep_pin):
    """``solve_host`` on a 6x6 noisy grid with rows 0-1 and 3-5 as
    islands and row 2 on the host: the JAX package's result keys, and
    the all-host run's assignment."""
    side = 6
    text = _grid_yaml(side)
    mapping = three_agent_split(port_load(text), side, 2, 3, factors=False)
    rj, rt = _run_both(text, algo, params, mapping, ["a0", "a1"],
                       rounds=200)
    _same(rj, rt)
    # both runs reach their fixed point inside the budget
    host = solve_host(port_load(text), algo, params, mode="sim",
                      rounds=200, seed=1, device="cpu")
    assert rt["final_assignment"] == host["final_assignment"]
    assert rt["msg_count"] == rj["msg_count"] > 0


def test_lockstep_island_thread_mode_reaches_a_proper_coloring():
    from pydcop_tpu_torch.api import solve

    text = _chain_text(8)
    mapping = {"a0": [f"v{i}" for i in range(4)],
               "a1": [f"v{i}" for i in range(4, 8)]}
    r = solve(port_load(text), "mgm", {}, mode="thread", timeout=3,
              distribution=Distribution(mapping), accel_agents=["a0"],
              device="cpu")
    assert len(r["final_assignment"]) == 8
    assert r["final_cost"] == 0.0
    assert r["cost"] == port_load(text).solution_cost(r["assignment"])


def test_lockstep_island_counters_in_the_telemetry_block():
    """One ``island.flushes`` per phase dispatched, one
    ``island.boundary_msgs`` per boundary message posted."""
    from pydcop_tpu_torch.api import solve

    text = _grid_yaml(4)
    mapping = three_agent_split(port_load(text), 4, 2, 2, factors=False)
    islands = []
    from pydcop_tpu_torch.algorithms import _island_lockstep

    attach = _island_lockstep.LockstepIsland.attach

    def record(island, proxy):
        if island not in islands:
            islands.append(island)
        attach(island, proxy)

    _island_lockstep.LockstepIsland.attach = record
    try:
        r = solve(port_load(text), "dba", {}, mode="sim", rounds=10,
                  seed=1, distribution=Distribution(mapping),
                  accel_agents=["a0", "a1"], device="cpu")
    finally:
        _island_lockstep.LockstepIsland.attach = attach
    counters = r["telemetry"]["counters"]
    assert len(islands) == 2
    assert counters["island.flushes"] == sum(i.flushes for i in islands) > 2
    assert counters["island.boundary_msgs"] == sum(
        i.boundary_msgs for i in islands) > 0


# -- the formulas the batched rounds and the islands share ---------------


def _formula_inputs(seed=7):
    """A 5x5 noisy grid plus two ternary constraints, compiled by both
    packages, with numpy-made values, weights and improves."""
    text = _grid_yaml(5).replace("constraints:\n", (
        "constraints:\n"
        "  t0: {type: intention, function: "
        "0.5 * abs(v00000 + v00006 - v00012)}\n"
        "  t1: {type: intention, function: "
        "2 if v00003 == v00009 == v00024 else 0}\n"
    ), 1)
    from pydcop_tpu.ops.compile import compile_dcop as jcompile

    from pydcop_tpu_torch.ops.compile import compile_dcop as tcompile

    pj, pt = jcompile(jax_load(text)), tcompile(port_load(text),
                                                device="cpu")
    assert pt.buckets.keys() == pj.buckets.keys() == {2, 3}
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 3, pt.n_vars).astype(np.int32)
    return pj, pt, rng, values


def _eq(jax_array, tensor):
    np.testing.assert_array_equal(tensor.numpy(), np.asarray(jax_array))


def test_dba_formulas_equal_jax(sweep_pin):
    from pydcop_tpu.algorithms import dba as jdba

    from pydcop_tpu_torch.algorithms import dba as tdba

    pj, pt, rng, values = _formula_inputs()
    weights = (1 + rng.integers(0, 4, pt.n_cons)).astype(np.float32)
    got = tdba.candidate_metrics(pt, torch.from_numpy(values),
                                 torch.from_numpy(weights))
    want = jdba.candidate_metrics(pj, jnp.asarray(values),
                                  jnp.asarray(weights), pj.edge_con, None)
    for w, g in zip(want, got):
        _eq(w, g)
    improve = rng.integers(0, 2, pt.n_vars).astype(np.float32)
    violated = rng.random(pt.n_cons) < 0.4
    _eq(jdba.qlm_mask(pj, jnp.asarray(improve), jnp.asarray(violated),
                      pj.edge_con, None),
        tdba.qlm_mask(pt, torch.from_numpy(improve),
                      torch.from_numpy(violated)))


@pytest.mark.parametrize("modifier", ["A", "M"])
@pytest.mark.parametrize("violation", ["NZ", "NM", "MX"])
def test_gdba_formulas_equal_jax(modifier, violation, sweep_pin):
    from pydcop_tpu.algorithms import gdba as jgdba

    from pydcop_tpu_torch.algorithms import gdba as tgdba

    pj, pt, rng, values = _formula_inputs()
    params = {"modifier": modifier, "violation": violation,
              "increase_mode": "E"}
    weights = {k: rng.integers(0, 3, (b.n_cons, pt.d_max ** k)).astype(
        np.float32) for k, b in pt.buckets.items()}
    got = tgdba.effective_metrics(
        pt, torch.from_numpy(values),
        {k: torch.from_numpy(w) for k, w in weights.items()}, params)
    want = jgdba.effective_metrics(
        pj, jnp.asarray(values),
        {k: jnp.asarray(w) for k, w in weights.items()}, params)
    for i in (0, 1, 3):  # improve, candidate, edge_violated
        _eq(want[i], got[i])
    for k in weights:
        _, cur_cell, violated, vals = want[2][k]
        for w, g in zip((cur_cell, violated, vals), got[2][k]):
            _eq(w, g)
    improve = np.array(want[0])
    _eq(jgdba.qlm_mask(pj, jnp.asarray(improve), want[3]),
        tgdba.qlm_mask(pt, torch.from_numpy(improve), got[3]))
