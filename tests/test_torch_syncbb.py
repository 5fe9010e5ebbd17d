"""The port's SyncBB against the JAX package's.

The same instances, built from seeds with each package's model objects,
go through ``pydcop_tpu.api.solve(…, "syncbb")`` and the port's: the
assignment, the cost and the message counts must be equal (SyncBB is an
exact, deterministic host search).  Also here: the ordered chain graph,
the CLI, ``solve_many`` and DPOP's optimum as the oracle.
"""

import json
import os
import sys
from argparse import Namespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pydcop_tpu.api as japi  # noqa: E402
import pydcop_tpu.dcop as jdcop  # noqa: E402
from pydcop_tpu.commands.generators import secp as jsecp  # noqa: E402
from pydcop_tpu.graphs import ordered_graph as jog  # noqa: E402

import pydcop_tpu_torch.api as tapi  # noqa: E402
import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
from pydcop_tpu_torch.commands.generators import secp as tsecp  # noqa: E402
from pydcop_tpu_torch.graphs import ordered_graph as tog  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_dpop import (  # noqa: E402
    costs_and_external,
    random_binary,
)

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = os.path.join(REPO, "examples", "graph_coloring_3.yaml")
KEYS = ("assignment", "cost", "final_assignment", "final_cost", "cycle",
        "msg_count", "msg_size", "status", "cost_trace")
SECP_8 = dict(  # bench_configs.py's configuration 4 SECP cut to 8 lights
    nb_lights=8, nb_models=6, nb_rules=2, light_levels=4, model_arity=3,
    zone_size=4, zone_layout="tiled", efficiency_weight=0.1,
    capacity=100.0, seed=3,
)

CASES = {
    "ring": lambda m: (jdcop if m is jdcop else tdcop).load_dcop_from_file(
        RING),
    "binary": lambda m: random_binary(m, 8, 3, 0.4, 1),
    "binary-max": lambda m: random_binary(m, 7, 3, 0.5, 2, objective="max"),
    "binary-hard": lambda m: random_binary(m, 7, 3, 0.5, 5, hard=True),
    "costs-external": costs_and_external,
    "secp": lambda m: (jsecp if m is jdcop else tsecp).generate(
        Namespace(**SECP_8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_syncbb_equals_jax_and_dpop(case):
    want = japi.solve(CASES[case](jdcop), "syncbb")
    got = tapi.solve(CASES[case](tdcop), "syncbb", device=CPU)
    assert set(got) == set(want)
    for k in KEYS:
        assert got[k] == want[k], k
    assert sorted(got["telemetry"]["phases"]) == ["search"]
    dpop = tapi.solve(CASES[case](tdcop), "dpop", {"util_device": "never"},
                      device=CPU)
    assert got["cost"] == dpop["cost"]


def test_ordered_graph_equals_jax():
    jg = jog.build_computation_graph(CASES["binary"](jdcop))
    tg = tog.build_computation_graph(CASES["binary"](tdcop))
    assert tg.ordering == jg.ordering
    for name in jg.ordering:
        jn, tn = jg.node(name), tg.node(name)
        assert (tn.position, tn.prev, tn.next) == (jn.position, jn.prev,
                                                   jn.next)
        assert sorted(c.name for c in tn.constraints) == sorted(
            c.name for c in jn.constraints)
    with pytest.raises(ValueError, match="misses"):
        tog.build_computation_graph(CASES["binary"](tdcop), ordering=["v0"])
    node = tg.node(tg.ordering[2])
    assert pytest.importorskip(
        "pydcop_tpu_torch.algorithms.syncbb"
    ).computation_memory(node) == 3


def test_syncbb_timeout_and_solve_many():
    d = CASES["binary"](tdcop)
    many = tapi.solve_many([d, CASES["ring"](tdcop)], "syncbb", device=CPU)
    one = tapi.solve(d, "syncbb", device=CPU)
    assert many[0]["instances_batched"] == 1
    assert (many[0]["assignment"], many[0]["msg_count"]) == (
        one["assignment"], one["msg_count"])
    assert many[1]["cost"] == 0.0
    late = tapi.solve(d, "syncbb", timeout=0.0, device=CPU)
    assert late["status"] == "timeout"


def test_cli_matches_jax_cli(capsys):
    from pydcop_tpu.cli import main as jmain

    from pydcop_tpu_torch.cli import main as tmain

    assert jmain(["solve", "-a", "syncbb", RING]) in (0, None)
    want = json.loads(capsys.readouterr().out)
    assert tmain(["solve", "-a", "syncbb", "--device", "cpu", RING]) in (
        0, None)
    got = json.loads(capsys.readouterr().out)
    for k in ("assignment", "cost", "cycle", "msg_count", "status"):
        assert got[k] == want[k], k
    assert np.isclose(got["cost"], 0.0)
