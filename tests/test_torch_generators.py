"""The port's instance generators against the JAX package's.

``pydcop_tpu_torch/commands/generators`` keeps its own copies of the
graph-coloring (random, grid and scale-free graphs), Ising and PEAV
meeting-scheduling generators.  From the same arguments and seed both
packages must build the same DCOP (variables and their domains and
value costs, constraint names, scopes and tables, exactly) and write
the same YAML text.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from pydcop_tpu.commands.generators import graphcoloring as jgc  # noqa: E402
from pydcop_tpu.commands.generators import ising as jising  # noqa: E402
from pydcop_tpu.commands.generators import meetingscheduling as jms  # noqa: E402
from pydcop_tpu.dcop.yamldcop import dcop_yaml as jax_yaml  # noqa: E402

from pydcop_tpu_torch.commands.generators import graphcoloring as tgc  # noqa: E402
from pydcop_tpu_torch.commands.generators import ising as tising  # noqa: E402
from pydcop_tpu_torch.commands.generators import meetingscheduling as tms  # noqa: E402
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _coloring(graph, seed):
    return types.SimpleNamespace(
        variables_count=25 if graph == "grid" else 30, colors_count=3,
        graph=graph, m_edge=2, p_edge=0.15, noise=0.02, soft=True,
        intentional=False, agents_count=None, capacity=100.0, seed=seed,
    )


def _ising(seed):
    return types.SimpleNamespace(
        row_count=5, col_count=4, bin_range=1.6, un_range=0.05,
        no_agents=False, capacity=100.0, seed=seed,
    )


def _meetings(seed):
    return types.SimpleNamespace(
        slots_count=5, events_count=12, resources_count=6,
        max_resources_event=3, eq_cost=10.0, noconflict_cost=10.0,
        value_range=1.0, capacity=1000.0, seed=seed,
    )


CASES = (
    [(f"coloring-{g}", jgc, tgc, _coloring, g)
     for g in ("random", "grid", "scalefree")]
    + [("ising", jising, tising, _ising, None),
       ("meetings", jms, tms, _meetings, None)]
)


def _assert_same_dcop(port, ref):
    assert port.name == ref.name and port.objective == ref.objective
    assert list(port.variables) == list(ref.variables)
    for name, v in ref.variables.items():
        w = port.variables[name]
        assert list(w.domain.values) == list(v.domain.values), name
        assert [w.cost_for_val(x) for x in w.domain] == [
            v.cost_for_val(x) for x in v.domain
        ], name
    assert list(port.constraints) == list(ref.constraints)
    for name, c in ref.constraints.items():
        mine = port.constraints[name]
        assert mine.scope_names == c.scope_names, name
        np.testing.assert_array_equal(
            mine.as_matrix().matrix, c.as_matrix().matrix, err_msg=name
        )
    assert list(port.agents) == list(ref.agents)


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize(
    "label,jmod,tmod,spec,graph", CASES, ids=[c[0] for c in CASES]
)
def test_generator_builds_the_jax_instance(label, jmod, tmod, spec, graph,
                                           seed):
    args = spec(graph, seed) if graph else spec(seed)
    ref, port = jmod.generate(args), tmod.generate(args)
    _assert_same_dcop(port, ref)
    assert dcop_yaml(port) == jax_yaml(ref)


def test_generate_cli_writes_the_jax_yaml(tmp_path):
    """``python -m pydcop_tpu_torch generate`` writes, to ``--output``,
    the text ``pydcop_tpu generate`` prints for the same arguments."""
    argv = ["generate", "graph_coloring", "-n", "20", "--graph",
            "scalefree", "--noise", "0.02", "--seed", "3"]
    out = tmp_path / "g.yaml"
    subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", *argv, "--output",
         str(out)], check=True, cwd=REPO, timeout=120,
    )
    want = jgc.generate(types.SimpleNamespace(
        variables_count=20, colors_count=3, graph="scalefree", m_edge=2,
        p_edge=0.2, noise=0.02, soft=False, intentional=False,
        agents_count=None, capacity=100.0, seed=3,
    ))
    assert out.read_text() == jax_yaml(want)
