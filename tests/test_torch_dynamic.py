"""The port's dynamic path (``engine/dynamic.py:run_dynamic`` and the
``run`` CLI) against the JAX package's, on the CPU.

Max-Sum (damping 0.5, no noise: nothing is drawn) plays the same
scenario in both packages, the JAX engine pinned to its per-slot gather
belief (ROADMAP.md, C, 'Belief summation'): the event log, the carry
count, the lost computations, the replicas, the final agents, the
assignment and the cost are equal, and the cost traces agree within
1e-6.  DSA draws from each package's own stream, so there only what no
draw decides is compared.  The ``run`` CLI prints the JAX command's
JSON keys and writes its metric CSVs (all columns but ``time`` equal),
and refuses every ``--chaos`` spec the JAX command refuses, with the
same message.
"""

import csv
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import pydcop_tpu.dcop as jdcop  # noqa: E402
from pydcop_tpu.cli import main as jax_main  # noqa: E402
from pydcop_tpu.engine.dynamic import run_dynamic as jax_dynamic  # noqa: E402

import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
from pydcop_tpu_torch.algorithms import load_algorithm_module  # noqa: E402
from pydcop_tpu_torch.algorithms import prepare_algo_params  # noqa: E402
from pydcop_tpu_torch.cli import main as port_main  # noqa: E402
from pydcop_tpu_torch.engine.batched import run_batched  # noqa: E402
from pydcop_tpu_torch.engine.dynamic import run_dynamic  # noqa: E402
from pydcop_tpu_torch.ops.compile import compile_dcop  # noqa: E402

from test_torch_incremental import sensor_dcop  # noqa: E402
from test_torch_maxsum import jax_gather_lowering  # noqa: E402,F401

CPU = "cpu"
EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
COLORING = os.path.join(EXAMPLES, "graph_coloring_3.yaml")
SCENARIO = os.path.join(EXAMPLES, "dynamic_scenario.yaml")
MAXSUM = {"damping": 0.5, "noise": 0.0}
EXACT_KEYS = ("events", "state_transfers", "lost_computations", "replicas",
              "agents_final", "assignment", "cost", "cycle", "msg_count",
              "status")


def sensor_scenario(m):
    """The phase-14 scenario at test size: settle, a set_value event on
    three sensors (the incremental path), a delay, the loss of ``a1``
    (its orphans migrate to their one replica), a delay, ``a2`` and
    ``a3`` together (the computations whose one replica was on the other
    are lost and freeze), a new agent, a delay."""
    E, A = m.ScenarioEvent, m.EventAction
    return m.Scenario([
        E("sense", actions=[A("set_value", variable=v, value=x)
                            for v, x in (("s0", 2), ("s1", 1), ("s4", 2))]),
        E(delay=0.5),
        E("lose_a1", actions=[A("remove_agent", agent="a1")]),
        E(delay=0.5),
        E("lose_a2_a3", actions=[A("remove_agent", agent="a2"),
                                 A("remove_agent", agent="a3")]),
        E("join", actions=[A("add_agent", agent="a9")]),
        E(delay=0.5),
    ])


def _both(build, scenario, algo="maxsum", params=MAXSUM, **kw):
    want = jax_dynamic(build(jdcop), algo, params,
                       scenario=scenario(jdcop), **kw)
    got = run_dynamic(build(tdcop), algo, params, scenario=scenario(tdcop),
                      device=CPU, **kw)
    return want, got


def _same(got, want, keys=EXACT_KEYS):
    assert list(got) == list(want)  # the JAX keys, in its order
    for k in keys:
        assert got[k] == want[k], (k, got[k], want[k])


DYN = dict(distribution="adhoc", k_target=1, rounds_per_second=40.0,
           final_rounds=40, seed=2, chunk_size=16)


@pytest.mark.parametrize("pad_policy", ["none", "pow2:16"])
def test_maxsum_sensor_scenario_equals_jax(pad_policy, jax_gather_lowering):
    want, got = _both(sensor_dcop, sensor_scenario, pad_policy=pad_policy,
                      **DYN)
    _same(got, want)
    np.testing.assert_allclose(got["cost_trace"], want["cost_trace"],
                               rtol=0, atol=1e-6)
    # the scenario reached every branch: migration, loss, carry
    removal = [e for e in got["events"] if e.get("action") == "remove_agent"]
    assert removal[0]["migrated"] and not removal[0]["lost"]
    assert got["lost_computations"]
    assert got["state_transfers"] >= 2


def test_maxsum_example_scenario_equals_jax(jax_gather_lowering):
    def build(m):
        return m.load_dcop_from_file(COLORING)

    def scenario(m):
        return m.load_scenario_from_file(SCENARIO)

    want, got = _both(build, scenario, distribution="adhoc", k_target=1,
                      final_rounds=30, seed=0)
    _same(got, want)
    np.testing.assert_allclose(got["cost_trace"], want["cost_trace"],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("k_target", [0, 1])
def test_dsa_decides_the_same_events(k_target):
    """DSA's trajectory follows each package's random stream; the
    scenario's bookkeeping does not."""
    want, got = _both(sensor_dcop, sensor_scenario, algo="dsa",
                      params={"variant": "B"},
                      **dict(DYN, k_target=k_target))
    for k in ("state_transfers", "lost_computations", "replicas",
              "agents_final", "cycle", "msg_count", "status"):
        assert got[k] == want[k], k
    strip = [{k: v for k, v in e.items()} for e in got["events"]]
    assert strip == want["events"]
    assert len(got["cost_trace"]) == len(want["cost_trace"])


def test_state_carry_across_a_delay_equals_one_run():
    """A delay segment continues the carried state: settle + delay +
    settle equals one uninterrupted run of as many rounds."""
    dcop = tdcop.load_dcop_from_file(COLORING)
    scenario = tdcop.Scenario([tdcop.ScenarioEvent(delay=0.75)])
    got = run_dynamic(dcop, "maxsum", MAXSUM, scenario=scenario,
                      distribution="adhoc", k_target=0,
                      rounds_per_second=40.0, final_rounds=24, chunk_size=8,
                      device=CPU)
    assert got["state_transfers"] == 2
    mod = load_algorithm_module("maxsum")
    one = run_batched(compile_dcop(dcop, device=CPU), mod,
                      prepare_algo_params(MAXSUM, mod.algo_params),
                      rounds=24 + 30 + 24, chunk_size=8)
    assert got["cycle"] == one.cycles
    np.testing.assert_array_equal(np.asarray(got["cost_trace"]),
                                  one.cost_trace)
    assert got["assignment"] == one.assignment


def test_no_card_and_sharded_refused():
    dcop = tdcop.load_dcop_from_file(COLORING)
    if not torch.cuda.is_available():
        from pydcop_tpu_torch.device import NoCudaDeviceError

        with pytest.raises(NoCudaDeviceError):
            run_dynamic(dcop, "maxsum", MAXSUM, distribution="adhoc")
    # sharded segments run (tests/test_torch_parallel.py holds them
    # over a mesh); a mesh of another size than n_shards is refused
    from pydcop_tpu_torch.parallel import make_mesh

    got = run_dynamic(dcop, "maxsum", MAXSUM, distribution="adhoc",
                      n_shards=2, final_rounds=20, device=CPU)
    want = run_dynamic(dcop, "maxsum", MAXSUM, distribution="adhoc",
                       final_rounds=20, device=CPU)
    assert got["msg_count"] == want["msg_count"]  # ghosts not counted
    assert got["cost"] == pytest.approx(want["cost"], abs=1e-4)
    with pytest.raises(ValueError, match="recompile"):
        run_dynamic(dcop, "maxsum", MAXSUM, distribution="adhoc",
                    n_shards=2, mesh=make_mesh(3, device=CPU), device=CPU)
    with pytest.raises(ValueError, match="host-side"):
        run_dynamic(dcop, "dpop", {}, distribution="adhoc", device=CPU)


# -- the run CLI -----------------------------------------------------------


def _cli(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


def _csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    i = rows[0].index("time")
    return [r[:i] + r[i + 1:] for r in rows]


@pytest.mark.parametrize("collect_on", ["cycle_change", "value_change"])
def test_run_cli_matches_jax(collect_on, tmp_path, capsys,
                             jax_gather_lowering):
    base = ["run", COLORING, "-a", "maxsum", "-p", "damping:0.5",
            "-p", "noise:0", "-s", SCENARIO, "-d", "adhoc",
            "--final_rounds", "30", "--collect_on", collect_on]

    def paths(tag):
        return ["--run_metrics", str(tmp_path / f"{tag}_run.csv"),
                "--end_metrics", str(tmp_path / f"{tag}_end.csv")]

    rc_j, want = _cli(jax_main, base + paths("jax"), capsys)
    rc_t, got = _cli(port_main, base + paths("port") + ["--device", CPU],
                     capsys)
    assert rc_j == rc_t == 0
    assert list(got) == list(want)
    for k in EXACT_KEYS:
        assert got[k] == want[k], k
    for kind in ("run", "end"):
        assert (_csv(tmp_path / f"port_{kind}.csv")
                == _csv(tmp_path / f"jax_{kind}.csv"))
    assert len(_csv(tmp_path / "port_run.csv")) > 1


def test_run_cli_chaos_crash_schedule_matches_jax(capsys,
                                                  jax_gather_lowering):
    base = ["run", COLORING, "-a", "maxsum", "-p", "damping:0.5",
            "-p", "noise:0", "-d", "adhoc", "--final_rounds", "20",
            "--chaos", "crash=a2@0.5", "--chaos_seed", "3"]
    _, want = _cli(jax_main, base, capsys)
    _, got = _cli(port_main, base + ["--device", CPU], capsys)
    for k in EXACT_KEYS + ("chaos",):
        assert got[k] == want[k], k
    assert got["events"][1]["id"] == "chaos_crash_a2"


REFUSED = [
    ["--chaos", "drop=0.1", "-s", SCENARIO],
    ["--chaos", "conn_drop=0.1", "-s", SCENARIO],
    ["--chaos", "replica_kill=2.5:1", "-s", SCENARIO],
    ["--chaos", "crash=a9@1"],
    ["--chaos", "crash=a1@1", "-s", SCENARIO],
    ["--chaos", "device_oom=4"],
    ["--chaos", "bogus=1", "-s", SCENARIO],
    [],
]


@pytest.mark.parametrize("extra", REFUSED, ids=lambda a: " ".join(a[:2]))
def test_run_cli_refusals_match_jax(extra):
    argv = ["run", COLORING, "-a", "maxsum", "-d", "adhoc"] + extra
    with pytest.raises(SystemExit) as je:
        jax_main(argv)
    with pytest.raises(SystemExit) as te:
        port_main(argv + ["--device", CPU])
    assert str(te.value) == str(je.value)


def test_run_cli_refuses_compile_cache(tmp_path):
    with pytest.raises(SystemExit, match="compile_cache"):
        port_main(["run", COLORING, "-a", "maxsum", "-s", SCENARIO,
                   "--compile_cache", str(tmp_path), "--device", CPU])
