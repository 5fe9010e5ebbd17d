"""The port's CLI against the JAX package's, in process, on the CPU.

Covers the global options (``-v``, ``--log``, ``-t``/``--timeout``,
``--output``, before and after the subcommand), the flag sets of every
ported command, and the host-only commands: ``graph``, ``distribute``,
``replica_dist`` and ``generate agents`` print (or write) the JAX
package's text on the same inputs.  ``solve``/``infer --compile_cache``
take only the default, and ``solve --profile`` writes one Chrome trace
of the solve without changing its result.
"""

import argparse
import glob
import json
import logging
import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from pydcop_tpu.cli import COMMANDS as JAX_COMMANDS  # noqa: E402
from pydcop_tpu.cli import build_parser as jax_parser  # noqa: E402
from pydcop_tpu.cli import main as jax_main  # noqa: E402

from pydcop_tpu_torch.cli import COMMANDS  # noqa: E402
from pydcop_tpu_torch.cli import build_parser as port_parser  # noqa: E402
from pydcop_tpu_torch.cli import main as port_main  # noqa: E402

CPU = "cpu"
EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
COLORING = os.path.join(EXAMPLES, "graph_coloring_3.yaml")
SECP = ["generate", "secp", "--nb_lights", "4", "--nb_models", "3",
        "--nb_rules", "2", "--light_levels", "3", "--model_arity", "2",
        "--seed", "4"]

#: flags of the JAX commands the port does not have: none since the host
#: runtime's solve flags (-d, -m, --nb_agents, --accel_agents, --msg_log,
#: --uiport) arrived with ROADMAP A15a
A15_SOLVE_FLAGS = set()
#: the port's own flags: the card or the CPU, on the commands that run on
#: a device (infer's --device is the JAX offload policy; fleet passes
#: --device to its serve replicas; an agent's island or shard and the
#: orchestrator's shard or reparation solve take theirs; an elastic
#: worker takes its supervisor's, and rank 0's the socket its store
#: listens on)
DEVICE_FLAGS = {"solve": {"--device"}, "run": {"--device"},
                "batch": {"--device"}, "serve": {"--device"},
                "fleet": {"--device"}, "infer": {"--torch_device"},
                "agent": {"--device"}, "orchestrator": {"--device"},
                "worker": {"--device", "--store-fd"}}


def _subparsers(parser):
    return next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction))


def _flag_sets(parser, prefix=""):
    """{command path: option strings} for every (sub-)subcommand."""
    out = {prefix.strip(): {o for a in parser._actions
                            for o in a.option_strings}}
    if any(isinstance(a, argparse._SubParsersAction)
           for a in parser._actions):
        for name, sub in _subparsers(parser).choices.items():
            out.update(_flag_sets(sub, f"{prefix} {name}"))
    return out


def test_registry_is_the_jax_order_of_the_ported_commands():
    assert COMMANDS == [c for c in JAX_COMMANDS if c in COMMANDS]
    names = set(_subparsers(port_parser()).choices)
    assert names == {"solve", "infer", "run", "graph", "distribute",
                     "generate", "batch", "consolidate", "replica_dist",
                     "orchestrator", "agent", "worker", "serve",
                     "fleet", "top", "lint", "trace-summary",
                     "flight-dump", "bench-history", "bench-compare"}


def test_flag_sets_equal_but_the_named_exclusions():
    want, got = _flag_sets(jax_parser()), _flag_sets(port_parser())
    assert set(got) <= set(want)
    for path, flags in got.items():
        jax_only = A15_SOLVE_FLAGS if path == "solve" else set()
        port_only = DEVICE_FLAGS.get(path, set())
        assert want[path] - flags == jax_only, path
        assert flags - want[path] == port_only, path
    # every generator of the JAX package, agents included
    assert {p for p in got if p.startswith("generate ")} == {
        p for p in want if p.startswith("generate ")}


@pytest.mark.parametrize("where", ["before", "after"])
def test_global_options_before_and_after_the_subcommand(where, tmp_path):
    flags = ["-t", "7.5", "--output", str(tmp_path / "o.json"), "-v", "2",
             "--log", "log.ini"]
    tail = ["graph", "-a", "maxsum", COLORING]
    argv = flags + tail if where == "before" else tail + flags
    for parser in (jax_parser(), port_parser()):
        a = parser.parse_args(argv)
        assert (a.timeout, a.output, a.verbosity, a.log) == (
            7.5, str(tmp_path / "o.json"), 2, "log.ini")
    # a flag given before is not clobbered by the subcommand's default
    a = port_parser().parse_args(["-t", "3", "solve", "-a", "maxsum",
                                  COLORING])
    assert a.timeout == 3.0 and a.output is None
    a = port_parser().parse_args(["generate", "agents", "-n", "2",
                                  "--output", "x.yaml", "-t", "4"])
    assert (a.output, a.timeout) == ("x.yaml", 4.0)


def test_output_and_timeout_reach_the_commands(tmp_path, capsys):
    for i, argv in enumerate((
        ["--output", str(tmp_path / "0.json"), "-t", "60", "solve", "-a",
         "maxsum", "--rounds", "8", "--device", CPU, COLORING],
        ["solve", "-a", "maxsum", "--rounds", "8", "--device", CPU,
         COLORING, "--output", str(tmp_path / "1.json"), "-t", "60"],
    )):
        capsys.readouterr()
        assert port_main(argv) == 0
        out = json.loads(capsys.readouterr().out)
        assert json.loads((tmp_path / f"{i}.json").read_text()) == out
        assert out["status"] == "finished"
    # a timeout of ~0 stops the run early, as in the JAX command
    capsys.readouterr()
    port_main(["solve", "-a", "maxsum", "--rounds", "100000",
               "--device", CPU, COLORING, "-t", "1e-9"])
    assert json.loads(capsys.readouterr().out)["cycle"] < 100000


@pytest.fixture
def own_logging(monkeypatch):
    """``fileConfig`` closes every handler of the process and replaces
    the root logger's: keep pytest's capture handlers open and give the
    root logger its handlers and level back after the test."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    monkeypatch.setattr(logging, "shutdown", lambda *a, **k: None)
    yield
    for h in root.handlers[:]:
        root.removeHandler(h)
    for h in handlers:
        root.addHandler(h)
    root.setLevel(level)


@pytest.mark.parametrize("where", ["before", "after"])
def test_log_file_config(where, tmp_path, capsys, own_logging):
    ini = tmp_path / "log.ini"
    ini.write_text(
        "[loggers]\nkeys=root,probe\n\n[handlers]\nkeys=h\n\n"
        "[formatters]\nkeys=f\n\n[logger_root]\nlevel=WARNING\n"
        "handlers=h\n\n[logger_probe]\nlevel=DEBUG\nhandlers=h\n"
        f"qualname=probe_{where}\npropagate=0\n\n[handler_h]\n"
        "class=NullHandler\nformatter=f\nargs=()\n\n[formatter_f]\n"
        "format=%(message)s\n"
    )
    kept = logging.getLogger("kept_" + where)  # existing loggers stay on
    tail = ["graph", "-a", "maxsum", COLORING]
    glob_ = ["--log", str(ini)]
    port_main(glob_ + tail if where == "before" else tail + glob_)
    capsys.readouterr()
    assert logging.getLogger(f"probe_{where}").level == logging.DEBUG
    assert not kept.disabled


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def secp_file(tmp_path_factory):
    """A generated SECP with an agents section (hosting costs, routes)."""
    path = tmp_path_factory.mktemp("secp") / "secp.yaml"
    jax_main(SECP + ["--output", str(path)])
    return str(path)


def _instances(secp_file):
    return [COLORING, secp_file]


GRAPH_ARGS = [["-g", "factor_graph"], ["-g", "constraints_hypergraph"],
              ["-g", "pseudotree"], ["-g", "ordered_graph"],
              ["-a", "maxsum"], ["-a", "dpop"], ["-a", "mgm"]]


@pytest.mark.parametrize("display", [False, True])
@pytest.mark.parametrize("how", GRAPH_ARGS, ids=lambda a: "".join(a))
def test_graph_prints_the_jax_json(how, display, secp_file, capsys):
    for path in _instances(secp_file):
        argv = ["graph", path] + how + (["--display"] if display else [])
        want = _run(jax_main, argv, capsys)
        got = _run(port_main, argv, capsys)
        assert got == want
        assert ("node_list" in json.loads(got[1])) == display


def test_graph_needs_a_graph_or_an_algorithm():
    for main in (jax_main, port_main):
        with pytest.raises(SystemExit, match="graph: provide --graph or "
                           "--algo"):
            main(["graph", COLORING])


def _sorted_mapping(text):
    doc = json.loads(text)
    doc["distribution"] = {a: sorted(c)
                           for a, c in doc["distribution"].items()}
    return doc


@pytest.mark.parametrize("strategy,algo", [
    ("oneagent", "mgm"), ("adhoc", "maxsum"), ("heur_comhost", "maxsum"),
    ("ilp_compref", "maxsum"), ("ilp_fgdp", "maxsum"),
])
def test_distribute_prints_and_writes_the_jax_placement(
        strategy, algo, secp_file, tmp_path, capsys):
    for path in _instances(secp_file):
        out = {}
        for label, main in (("jax", jax_main), ("port", port_main)):
            yml = tmp_path / f"{label}.yaml"
            argv = ["distribute", path, "-d", strategy, "-a", algo,
                    "--output", str(yml)]
            rc, text = _run(main, argv, capsys)
            out[label] = (rc, text, yml.read_text())
        if strategy.startswith("ilp"):
            # the ILP's mappings compared as sets per agent, as the
            # strategy tests compare them
            for label in out:
                rc, text, _ = out[label]
                out[label] = (rc, _sorted_mapping(text))
        assert out["port"] == out["jax"], (path, strategy)


def test_distribute_errors_as_jax(capsys):
    argv = ["distribute", COLORING, "-d", "oneagent", "-a", "maxsum"]
    msgs = []
    for main in (jax_main, port_main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith("distribute: oneagent needs at least")


def test_replica_dist_by_strategy_and_by_file(secp_file, tmp_path, capsys):
    for path in _instances(secp_file):
        dist = tmp_path / "dist.yaml"
        jax_main(["distribute", path, "-d", "adhoc", "-a", "maxsum",
                  "--output", str(dist)])
        for d in ("adhoc", "heur_comhost", str(dist)):
            for k in ("1", "2"):
                argv = ["replica_dist", path, "-k", k, "-a", "maxsum",
                        "-d", d]
                assert _run(port_main, argv, capsys) == _run(
                    jax_main, argv, capsys), (path, d, k)


@pytest.mark.parametrize("seed", ["0", "7"])
@pytest.mark.parametrize("extra", [[], ["--hosting_range", "12.5"],
                                   ["--hosting_default", "3",
                                    "--routes_default", "1.5",
                                    "--agent_prefix", "ag"]])
def test_generate_agents_byte_equal(seed, extra, tmp_path, capsys):
    argv = ["generate", "agents", "-n", "12", "--capacity", "40",
            "--seed", seed] + extra
    assert _run(port_main, argv, capsys) == _run(jax_main, argv, capsys)
    files = []
    for label, main in (("jax", jax_main), ("port", port_main)):
        f = tmp_path / f"{label}.yaml"
        main(argv + ["--output", str(f)])
        files.append(f.read_bytes())
    assert files[0] == files[1] and b"agents:" in files[0]


@pytest.mark.parametrize("command", ["solve", "infer"])
def test_compile_cache_takes_only_the_default(command, tmp_path, capsys):
    base = ([command, COLORING] + (
        ["-a", "maxsum", "--rounds", "4", "--device", CPU]
        if command == "solve" else ["-q", "map", "--torch_device", CPU]))
    assert port_main(base) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit, match=f"{command}: compile_cache= "):
        port_main(base + ["--compile_cache", str(tmp_path)])
    if command == "solve":
        with pytest.raises(SystemExit, match=f"{command}: compile_cache= "):
            port_main(base + ["--many", "--compile_cache", str(tmp_path)])


def test_solve_profile_writes_one_chrome_trace(tmp_path, capsys):
    argv = ["solve", "-a", "maxsum", "-p", "noise:0", "--rounds", "16",
            "--device", CPU, COLORING]
    _, plain = _run(port_main, argv, capsys)
    prof = tmp_path / "prof"
    _, profiled = _run(port_main, argv + ["--profile", str(prof)], capsys)
    strip = ("time", "telemetry")
    a, b = json.loads(plain), json.loads(profiled)
    assert {k: v for k, v in a.items() if k not in strip} == {
        k: v for k, v in b.items() if k not in strip}
    files = glob.glob(str(prof / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


def test_solve_profile_flushes_when_the_solve_raises(tmp_path):
    prof = tmp_path / "prof"
    with pytest.raises(ValueError):
        port_main(["solve", "-a", "maxsum", "-p", "nope:2",
                   "--device", CPU, "--profile", str(prof), COLORING])
    assert len(glob.glob(str(prof / "*.json"))) == 1


def test_single_run_options_refused_with_many(tmp_path):
    for flags in (["--profile", str(tmp_path)],
                  ["--checkpoint", str(tmp_path / "c.npz")], ["--resume"]):
        msgs = []
        for main, extra in ((jax_main, []), (port_main, ["--device", CPU])):
            with pytest.raises(SystemExit) as e:
                main(["solve", "-a", "maxsum", "--many", COLORING, COLORING]
                     + flags + extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("algo", ["mgm", "gdba"])
def test_solve_sim_with_a_lockstep_island_equals_jax(algo, capsys):
    """``solve -a mgm|gdba -m sim --accel_agents a1``: the island runs on
    the CPU with ``--device cpu`` and the result equals the JAX CLI's
    (all but ``time`` and the telemetry block, whose island counters the
    JAX package names after its jitted programs)."""
    argv = ["solve", "-a", algo, "-m", "sim", "--rounds", "40",
            "--accel_agents", "a1", "--seed", "2", COLORING]
    assert jax_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert port_main(argv + ["--device", CPU]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.pop("telemetry")["counters"]["island.flushes"] > 0
    want.pop("telemetry")
    got.pop("time"), want.pop("time")
    assert got == want and got["cost"] == 0.0
