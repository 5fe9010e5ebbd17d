"""The port's ``bench-history`` and ``bench-compare`` against the JAX
package's: the same argv gives the same stdout and stderr, byte for
byte, and the same exit code.

Every input is synthetic and written in ``tmp_path``: a ledger of a few
rounds, stages and backends (one round on another backend, for the
fingerprint refusal), pairs files (a regression, a null), and a root
with two ``BENCH_r*.json``-shaped files, a TPU log and a copy of the
tool for ``--rebuild``.
Both commands run in this process through each package's ``cli.main``.
"""

import json
import random
import shutil
import sys
from pathlib import Path

import pytest

from pydcop_tpu import cli as jax_cli
from pydcop_tpu_torch import cli as port_cli

pytestmark = pytest.mark.lint

REPO = Path(__file__).resolve().parent.parent
NOW = "2026-10-19T12:00:00Z"

if str(REPO / "tools") not in sys.path:
    sys.path.insert(0, str(REPO / "tools"))

from benchkeeper import ledger as bk_ledger  # noqa: E402


def _row(ts, rnd, stage, metric, value, backend="cpu", hib=True, **fp):
    return bk_ledger.make_row(
        ts=ts, source=f"bench_{rnd}", stage=stage, metric=metric,
        value=value, unit="msgs/s" if hib else "s", higher_is_better=hib,
        fingerprint=bk_ledger.null_fingerprint(backend=backend, **fp),
        round_name=rnd,
    )


def _ledger_rows():
    rows = []
    fp = {"device_kind": "NVIDIA H100 80GB HBM3", "python": "3.12.3"}
    for i, (msgs, lat) in enumerate(
        [(1.2e8, 0.41), (1.5e8, 0.38), (1.1e8, 0.45), (2.0e8, 0.30)]
    ):
        rnd = f"r{i + 1:02d}"
        ts = f"2026-10-{10 + i:02d}T08:00:00Z"
        rows.append(_row(ts, rnd, "bench_round", "rc", 0.0, hib=False))
        rows.append(_row(ts, rnd, "north_star", "msgs_per_sec", msgs, **fp))
        rows.append(_row(ts, rnd, "solver_service", "latency_p99_s", lat,
                         hib=False, **fp))
    # r05 on another backend: the fingerprint refusal, and a STALE row
    rows.append(_row("2026-10-01T08:00:00Z", "r05", "north_star",
                     "msgs_per_sec", 9.9e9, backend="gpu", **fp))
    return rows


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    ledger = d / "ledger.jsonl"
    bk_ledger.write_ledger(str(ledger), _ledger_rows())
    rng = random.Random(7)
    base = [rng.uniform(0.95, 1.05) for _ in range(20)]
    (d / "regression.json").write_text(json.dumps({
        "baseline": base,
        "candidate": [b * 0.88 * rng.uniform(0.99, 1.01) for b in base],
        "higher_is_better": True, "name": "a 12% drop",
    }))
    (d / "null.json").write_text(json.dumps({
        "baseline": [rng.uniform(1.0, 2.0) for _ in range(20)],
        "candidate": [rng.uniform(1.0, 2.0) for _ in range(20)],
    }))
    (d / "bad.json").write_text(json.dumps({"baseline": [1.0]}))
    root = d / "root"
    root.mkdir()
    for rnd, value in (("r01", 1.0e8), ("r02", 1.3e8)):
        (root / f"BENCH_{rnd}.json").write_text(json.dumps({
            "rc": 0,
            "parsed": {
                "backend": "cpu", "value": value, "vs_baseline": value / 1e8,
                "bnb": {"speedup_on_vs_off": 4.2, "pruned_fraction": 0.5},
            },
        }))
    (root / "BENCH_TPU_LOG.jsonl").write_text("")
    # both commands look the tool up under --root
    shutil.copytree(REPO / "tools" / "benchkeeper",
                    root / "tools" / "benchkeeper")
    return {
        "ledger": str(ledger), "regression": str(d / "regression.json"),
        "null": str(d / "null.json"), "bad": str(d / "bad.json"),
        "missing": str(d / "missing.json"), "empty": str(d / "none.jsonl"),
        "root": str(root), "rebuilt": str(d / "rebuilt.jsonl"),
    }


#: (case, argv with {file} placeholders, expected exit code)
CASES = [
    ("history-golden", ["bench-history", "--ledger", "{ledger}",
                        "--now", NOW], 0),
    ("history-stage", ["bench-history", "--ledger", "{ledger}", "--stage",
                       "north_star", "--now", NOW], 0),
    ("history-json", ["bench-history", "--ledger", "{ledger}", "--json",
                      "--now", NOW, "--stale_hours", "200"], 0),
    ("history-rebuild", ["bench-history", "--rebuild", "--root", "{root}",
                         "--ledger", "{rebuilt}", "--now", NOW], 0),
    ("history-empty", ["bench-history", "--ledger", "{empty}"], 1),
    ("compare-regression", ["bench-compare", "--pairs", "{regression}"], 1),
    ("compare-regression-json", ["bench-compare", "--pairs", "{regression}",
                                 "--json", "--seed", "3", "--n_boot",
                                 "500"], 1),
    ("compare-noise", ["bench-compare", "--pairs", "{null}"], 0),
    ("compare-rounds", ["bench-compare", "--baseline", "r01",
                        "--candidate", "r04", "--ledger", "{ledger}"], 0),
    ("compare-rounds-refused", ["bench-compare", "--baseline", "r04",
                                "--candidate", "r05", "--ledger",
                                "{ledger}", "--json"], 0),
    ("compare-rounds-none", ["bench-compare", "--baseline", "r01",
                             "--candidate", "r09", "--ledger",
                             "{ledger}"], 2),
    ("usage-no-mode", ["bench-compare", "--ledger", "{ledger}"], 2),
    ("usage-both-modes", ["bench-compare", "--pairs", "{null}",
                          "--baseline", "r01", "--candidate", "r02"], 2),
    ("usage-unreadable", ["bench-compare", "--pairs", "{missing}"], 2),
    ("usage-malformed", ["bench-compare", "--pairs", "{bad}"], 2),
    ("usage-empty-ledger", ["bench-compare", "--baseline", "r01",
                            "--candidate", "r02", "--ledger", "{empty}"], 2),
]


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("case,argv,want_rc", CASES,
                         ids=[c[0] for c in CASES])
def test_port_bench_command_equals_jax_command(case, argv, want_rc, files,
                                               capsys):
    argv = [a.format(**files) for a in argv]
    jax_rc, jax_out, jax_err = _run(jax_cli.main, argv, capsys)
    jax_ledger = (Path(files["rebuilt"]).read_bytes()
                  if case == "history-rebuild" else None)
    port_rc, port_out, port_err = _run(port_cli.main, argv, capsys)
    assert (port_rc, jax_rc) == (want_rc, want_rc)
    assert port_out == jax_out
    assert port_err == jax_err
    if not case.startswith("usage") and case != "history-empty":
        assert port_out  # every case that renders printed something
    if case == "history-rebuild":
        # the rebuilt ledger is the same file, byte for byte
        assert Path(files["rebuilt"]).read_bytes() == jax_ledger
        assert "r01 ok  r02 ok" in port_out
    if case == "compare-rounds-refused":
        entry, = json.loads(port_out)["entries"]
        assert "refused" in entry
    if case == "history-golden":
        assert "STALE" in port_out and "r04" in port_out



def test_bench_commands_take_the_jax_commands_flags():
    """Each subcommand's options and defaults equal the JAX one's."""
    def options(parser, name):
        sub = next(a for a in parser._actions
                   if hasattr(a, "choices") and a.choices
                   and name in a.choices).choices[name]
        return sorted(
            (tuple(a.option_strings), a.dest, repr(a.default))
            for a in sub._actions
        )

    jp, pp = jax_cli.build_parser(), port_cli.build_parser()
    for name in ("bench-history", "bench-compare"):
        assert options(pp, name) == options(jp, name), name
