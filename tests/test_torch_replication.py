"""The port's replica placement and repair against the JAX package's, on
the fixtures of ``tests/test_resilience.py`` (host code; the repair's
reparation solve runs on the port's CPU).

``replica_distribution`` and ``build_reparation_dcop`` are deterministic
and equal the JAX package's exactly.  ``repair_placement`` equals it
wherever the placement does not depend on the reparation solve's random
initial values (the fast paths, capacity-forced placements, a unique
optimum); where the reparation DCOP has tied optima the packages' random
streams pick among them (ROADMAP.md, C, 'Random streams'), so there the
placements are held to equal reparation cost and validity.
"""

import pytest

import pydcop_tpu.dcop as jdcop
import pydcop_tpu.replication as jrep
from pydcop_tpu.distribution.objects import Distribution as JDist
from pydcop_tpu.replication.repair import build_reparation_dcop as jbuild

import pydcop_tpu_torch.dcop as tdcop
import pydcop_tpu_torch.replication as trep
from pydcop_tpu_torch.distribution.objects import Distribution as TDist
from pydcop_tpu_torch.replication.repair import build_reparation_dcop as tbuild

CPU = "cpu"


def _agents(m, specs):
    return [m.AgentDef(name, **kw) for name, kw in specs]


REPLICA_CASES = {
    "cheap-hosting": (
        [("h", dict(default_hosting_cost=0.0)),
         ("cheap", dict(default_hosting_cost=1.0)),
         ("mid", dict(default_hosting_cost=5.0)),
         ("dear", dict(default_hosting_cost=50.0))],
        {"h": ["c1"], "cheap": [], "mid": [], "dear": []}, 2, None),
    "capacity": (
        [("h", dict(capacity=10)),
         ("small", dict(capacity=1.0, default_hosting_cost=0.0)),
         ("big", dict(capacity=10.0, default_hosting_cost=2.0))],
        {"h": ["c1", "c2"], "small": [], "big": []}, 2, lambda c: 1.0),
    "multi-hop": (
        [("h", dict(routes={"far": 10.0, "relay": 1.0})),
         ("relay", dict(routes={"h": 1.0, "far": 1.0})),
         ("far", dict(routes={"h": 10.0, "relay": 1.0},
                      default_hosting_cost=0.0))],
        {"h": ["c1"], "relay": [], "far": []}, 2, None),
    "ring-k1": (
        [(f"a{i}", dict(default_hosting_cost=float(i % 2)))
         for i in range(5)],
        {f"a{i}": [f"c{i}", f"c{i + 5}"] for i in range(5)}, 1,
        lambda c: 1.0 + int(c[1:]) % 3),
    "ring-k3": (
        [(f"a{i}", dict(capacity=6.0)) for i in range(5)],
        {f"a{i}": [f"c{i}", f"c{i + 5}"] for i in range(5)}, 3, None),
}


@pytest.mark.parametrize("case", sorted(REPLICA_CASES))
def test_replica_distribution_equal(case):
    specs, mapping, k, foot = REPLICA_CASES[case]
    want = jrep.replica_distribution(
        JDist(mapping), _agents(jdcop, specs), k, footprint=foot
    )
    got = trep.replica_distribution(
        TDist(mapping), _agents(tdcop, specs), k, footprint=foot
    )
    assert got.mapping == want.mapping


def test_replica_distribution_repr_roundtrip():
    from pydcop_tpu_torch.utils.simple_repr import from_repr, simple_repr

    rep = trep.ReplicaDistribution({"c1": ["a1", "a2"], "c2": []})
    assert from_repr(simple_repr(rep)) == rep
    assert rep.replicas("c1") == ["a1", "a2"]


def _tables(dcop):
    return {
        name: (c.scope_names, c.as_matrix().matrix.tolist())
        for name, c in dcop.constraints.items()
    }


@pytest.mark.parametrize("weight", [0.5, 2.0])
def test_reparation_dcop_equal(weight):
    specs = [("a1", dict(default_hosting_cost=1.0)),
             ("a2", dict(default_hosting_cost=2.0)),
             ("a3", dict(hosting_costs={"c2": 0.5}))]
    cands = {"c1": ["a1", "a2"], "c2": ["a1", "a2", "a3"], "c3": ["a3"],
             "c4": []}
    foot = {"c1": 1.0, "c2": 2.0, "c3": 3.0}.get
    jd = jbuild(cands, {a.name: a for a in _agents(jdcop, specs)}, foot,
                weight)
    td = tbuild(cands, {a.name: a for a in _agents(tdcop, specs)}, foot,
                weight)
    assert sorted(td.variables) == sorted(jd.variables) == ["c1", "c2", "c3"]
    assert {n: list(v.domain.values) for n, v in td.variables.items()} == {
        n: list(v.domain.values) for n, v in jd.variables.items()}
    assert _tables(td) == _tables(jd)


# (candidates, agent specs, remaining capacity, footprint): placements
# that no random draw decides
DETERMINISTIC = {
    "lost": ({"c1": ["a1"], "c2": []}, [("a1", {})], None, None),
    "single-candidates": (
        {"c1": ["a2"], "c2": ["a3"]}, [("a2", {}), ("a3", {})], None, None),
    "no-feasible-candidate": (
        {"big": ["a1", "a2"], "small": ["a1", "a2"]},
        [("a1", dict(default_hosting_cost=0.0)),
         ("a2", dict(default_hosting_cost=0.1))],
        {"a1": 1.0, "a2": 0.0}, lambda c: 3.0 if c == "big" else 1.0),
    "zero-capacity": (
        {"c1": ["a1", "a2"]},
        [("a1", dict(default_hosting_cost=0.0)),
         ("a2", dict(default_hosting_cost=0.1))],
        {"a1": 0.0, "a2": 0.0}, lambda c: 1.0),
    "unknown-capacity": (
        {"c1": ["a3"]}, [("a3", {})], {}, lambda c: 1.0),
    "unique-optimum": (
        {"c1": ["a1", "a2"], "c2": ["a2", "a3"]},
        [("a1", dict(default_hosting_cost=0.0)),
         ("a2", dict(default_hosting_cost=5.0)),
         ("a3", dict(default_hosting_cost=0.0))],
        {"a1": 4.0, "a2": 4.0, "a3": 4.0}, lambda c: 1.0),
}


@pytest.mark.parametrize("case", sorted(DETERMINISTIC))
def test_repair_placement_equal(case):
    cands, specs, cap, foot = DETERMINISTIC[case]
    kw = dict(remaining_capacity=cap, footprint=foot, seed=1)
    want = jrep.repair_placement(cands, _agents(jdcop, specs), **kw)
    got = trep.repair_placement(cands, _agents(tdcop, specs), device=CPU,
                                **kw)
    assert got == want


def _reparation_cost(dcop, placed):
    return dcop.solution_cost(placed)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_repair_tied_optima_equal_cost(seed):
    """Two orphans over two agents of capacity 1: the two spread
    placements tie.  Each package reaches one of them: both spread, at
    the reparation optimum."""
    cands = {"c1": ["a1", "a2"], "c2": ["a1", "a2"]}
    specs = [("a1", dict(default_hosting_cost=0.0)),
             ("a2", dict(default_hosting_cost=0.1))]
    kw = dict(remaining_capacity={"a1": 1.0, "a2": 1.0},
              footprint=lambda c: 1.0, seed=seed)
    want = jrep.repair_placement(cands, _agents(jdcop, specs), **kw)
    got = trep.repair_placement(cands, _agents(tdcop, specs), device=CPU,
                                **kw)
    assert sorted(got) == sorted(want) == ["c1", "c2"]
    assert got["c1"] != got["c2"] and want["c1"] != want["c2"]
    td = tbuild(cands, {a.name: a for a in _agents(tdcop, specs)},
                lambda c: 1.0)
    assert _reparation_cost(td, got) == _reparation_cost(td, want)


def test_repair_runs_on_the_given_device(monkeypatch):
    """The reparation solve goes to the port's ``api.solve`` on the
    device the caller names (the CUDA device by default)."""
    import pydcop_tpu_torch.api as api

    seen = []
    real = api.solve

    def spy(*a, **kw):
        seen.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(api, "solve", spy)
    cands = {"c1": ["a1", "a2"], "c2": ["a1", "a2"]}
    agents = _agents(tdcop, [("a1", {}), ("a2", {})])
    trep.repair_placement(cands, agents, device=CPU)
    assert seen == [CPU]
    if not __import__("torch").cuda.is_available():
        from pydcop_tpu_torch.device import NoCudaDeviceError

        with pytest.raises(NoCudaDeviceError):
            trep.repair_placement(cands, agents)
