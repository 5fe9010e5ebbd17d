"""The port's computation graphs, footprint hooks and distribution
strategies against the JAX package's (host code on both sides).

The same DCOPs (the example yamls and a generated SECP, loaded or
generated by each package from the same inputs) go through both
packages' graph builders, each algorithm's ``computation_memory`` and
``communication_load``, and every distribution strategy: nodes, links,
footprints and placements are equal, and a placement that cannot be
made raises the same ``ImpossibleDistributionException`` in both.
"""

import os
from types import SimpleNamespace

import pytest

import pydcop_tpu.algorithms as jalgos
import pydcop_tpu.dcop as jdcop
import pydcop_tpu.distribution as jdist
import pydcop_tpu.graphs as jgraphs
from pydcop_tpu.commands.generators import secp as jsecp

import pydcop_tpu_torch.algorithms as talgos
import pydcop_tpu_torch.dcop as tdcop
import pydcop_tpu_torch.distribution as tdist
import pydcop_tpu_torch.graphs as tgraphs
from pydcop_tpu_torch.commands.generators import secp as tsecp

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "..", "examples")
GRAPH_MODELS = ["factor_graph", "constraints_hypergraph", "pseudotree",
                "ordered_graph"]
ALGOS = ["dsa", "adsa", "dsatuto", "mgm", "mgm2", "dba", "gdba", "maxsum",
         "amaxsum", "dpop", "syncbb"]
# an algorithm per graph model whose footprint hooks drive the placement
HOOKS = {"factor_graph": "maxsum", "constraints_hypergraph": "mgm"}
SECP_ARGS = dict(nb_lights=4, nb_models=3, nb_rules=2, light_levels=3,
                 model_arity=2, efficiency_weight=0.1, capacity=100.0,
                 seed=4)


def _instance(name):
    """(JAX dcop, port dcop) of one named instance."""
    if name == "secp":
        args = SimpleNamespace(**SECP_ARGS)
        return jsecp.generate(args), tsecp.generate(args)
    path = os.path.join(EXAMPLES, name)
    return jdcop.load_dcop_from_file(path), tdcop.load_dcop_from_file(path)


INSTANCES = ["graph_coloring_3.yaml", "meeting_preferences.yaml", "secp"]


def _graph_key(graph):
    nodes = sorted(
        (n.name, n.type, tuple(sorted(n.neighbors))) for n in graph.nodes
    )
    links = sorted((link.type, tuple(link.nodes)) for link in graph.links)
    return nodes, links


def test_graph_model_registry_as_jax():
    assert (tgraphs.list_available_graph_models()
            == jgraphs.list_available_graph_models())
    with pytest.raises(ValueError, match="Unknown graph model"):
        tgraphs.load_graph_module("nope")
    assert (tdist.list_available_distributions()
            == jdist.list_available_distributions())


@pytest.mark.parametrize("model", GRAPH_MODELS)
@pytest.mark.parametrize("name", INSTANCES)
def test_graph_builders_equal(name, model):
    jd, td = _instance(name)
    jg = jgraphs.load_graph_module(model).build_computation_graph(jd)
    tg = tgraphs.load_graph_module(model).build_computation_graph(td)
    assert _graph_key(tg) == _graph_key(jg)
    assert tg.graph_type == jg.graph_type
    assert tg.density() == jg.density()


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", INSTANCES)
def test_footprint_hooks_equal(name, algo):
    jd, td = _instance(name)
    jm = jalgos.load_algorithm_module(algo)
    tm = talgos.load_algorithm_module(algo)
    assert tm.GRAPH_TYPE == jm.GRAPH_TYPE
    jg = jgraphs.load_graph_module(jm.GRAPH_TYPE).build_computation_graph(jd)
    tg = tgraphs.load_graph_module(tm.GRAPH_TYPE).build_computation_graph(td)
    tnodes = {n.name: n for n in tg.nodes}
    for jn in jg.nodes:
        tn = tnodes[jn.name]
        assert tm.computation_memory(tn) == jm.computation_memory(jn)
        for nb in jn.neighbors:
            assert (tm.communication_load(tn, nb)
                    == jm.communication_load(jn, nb)), (jn.name, nb)


def _agent_sets(name, jd, td):
    """Agent lists to place on: the instance's own, and a capacity-bound
    variant (4 agents of capacity 12 with graded hosting costs)."""
    out = []
    if jd.agents:
        out.append(("own", list(jd.agents.values()),
                    list(td.agents.values())))

    def graded(m):
        return [m.AgentDef(f"g{i}", capacity=12.0,
                           default_hosting_cost=float(i))
                for i in range(4)]
    out.append(("graded", graded(jdcop), graded(tdcop)))
    return out


def _place(mod_pkg, strategy, graph, agents, algo_module):
    try:
        dist = mod_pkg.compute_distribution(
            strategy, graph, agents, algo_module=algo_module
        )
    except mod_pkg.ImpossibleDistributionException as e:
        return ("impossible", str(e))
    return ("placed", {a: sorted(c) for a, c in dist.mapping.items()})


@pytest.mark.parametrize("model", sorted(HOOKS))
@pytest.mark.parametrize("strategy", jdist.list_available_distributions())
@pytest.mark.parametrize("name", INSTANCES)
def test_distribution_strategies_equal(name, strategy, model):
    jd, td = _instance(name)
    jg = jgraphs.load_graph_module(model).build_computation_graph(jd)
    tg = tgraphs.load_graph_module(model).build_computation_graph(td)
    jm = jalgos.load_algorithm_module(HOOKS[model])
    tm = talgos.load_algorithm_module(HOOKS[model])
    for label, ja, ta in _agent_sets(name, jd, td):
        want = _place(jdist, strategy, jg, ja, jm)
        got = _place(tdist, strategy, tg, ta, tm)
        assert got == want, (label, got, want)


def test_distribution_cost_and_repr_as_jax():
    """Each strategy module's ``distribution_cost`` and the
    ``Distribution`` object's behaviour (lookups, moves, simple repr)."""
    from pydcop_tpu.utils.simple_repr import simple_repr as jrepr

    from pydcop_tpu_torch.utils.simple_repr import from_repr, simple_repr

    jd, td = _instance("secp")
    jg = jgraphs.load_graph_module("factor_graph").build_computation_graph(jd)
    tg = tgraphs.load_graph_module("factor_graph").build_computation_graph(td)
    jm = jalgos.load_algorithm_module("maxsum")
    tm = talgos.load_algorithm_module("maxsum")
    for strategy in jdist.list_available_distributions():
        jmod = jdist.load_distribution_module(strategy)
        tmod = tdist.load_distribution_module(strategy)
        if _place(jdist, strategy, jg, jd.agents.values(), jm)[0] != "placed":
            continue  # oneagent: fewer agents than computations
        jp = jdist.compute_distribution(strategy, jg, jd.agents.values(),
                                        algo_module=jm)
        tp = tdist.compute_distribution(strategy, tg, td.agents.values(),
                                        algo_module=tm)
        kw_j = dict(computation_memory=jm.computation_memory,
                    communication_load=jm.communication_load)
        kw_t = dict(computation_memory=tm.computation_memory,
                    communication_load=tm.communication_load)
        assert (tmod.distribution_cost(tp, tg, td.agents.values(), **kw_t)
                == jmod.distribution_cost(jp, jg, jd.agents.values(),
                                          **kw_j))
        r = simple_repr(tp)
        assert from_repr(r) == tp
        assert r["mapping"] == jrepr(jp)["mapping"]
    d = tdist.Distribution({"a1": ["c1", "c2"], "a2": ["c3"]})
    d.remove_computation("c2")
    d.host_on_agent("a2", ["c2"])
    assert d.agent_for("c2") == "a2" and d.computations_hosted("a1") == ["c1"]
    with pytest.raises(ValueError, match="already hosted"):
        d.host_on_agent("a1", ["c3"])
    with pytest.raises(ValueError, match="assigned to both"):
        tdist.Distribution({"a1": ["c1"], "a2": ["c1"]})


def test_unknown_distribution_rejected_as_jax():
    for bad in ("objects", "_cost", "nope"):
        with pytest.raises(ValueError) as je:
            jdist.load_distribution_module(bad)
        with pytest.raises(ValueError) as te:
            tdist.load_distribution_module(bad)
        assert str(te.value).replace("pydcop_tpu_torch", "pydcop_tpu") == str(
            je.value)
