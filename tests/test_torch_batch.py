"""The port's ``batch`` and ``consolidate`` against the JAX package's, in
process, on the CPU.

``--simulate`` prints the JAX text.  On deterministic cells (DPOP on the
host path; Max-Sum with two dampings and ``noise: 0``, the JAX engine
pinned to its gather belief: ROADMAP.md, C, 'Belief summation') the rows
equal the JAX package's in every column but ``time``.  Where the seed
reaches a row (DSA, Max-Sum's default noise) each package draws from
its own stream (C, 'Random streams'), so only the keys, their order and
the statuses are compared.  Resume, error-row retries, ``--vmap_cells``
(rows equal to the sequential ones), ``--vmap_iterations`` (one solve
per cell) and the dict-spec seam (:func:`run_sweep` with a ``load``
function) are held on the port alone; ``consolidate`` writes the JAX
CSV from JAX-written and port-written inputs.
"""

import csv
import glob
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

from pydcop_tpu.cli import main as jax_main  # noqa: E402

import pydcop_tpu_torch.api as tapi  # noqa: E402
from pydcop_tpu_torch.cli import main as port_main  # noqa: E402
from pydcop_tpu_torch.commands.batch import CSV_FIELDS, run_sweep  # noqa: E402
from pydcop_tpu_torch.dcop import load_dcop_from_file  # noqa: E402

from test_torch_maxsum import jax_gather_lowering  # noqa: E402,F401

CPU = "cpu"
EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
SWEEP = os.path.join(EXAMPLES, "batch_sweep.yaml")
COLORING = os.path.join(EXAMPLES, "graph_coloring_3.yaml")
KEY = ["batch", "set", "problem", "iteration", "algo", "params"]
NO_TIME = [f for f in CSV_FIELDS if f != "time"]

#: a deterministic sweep: DPOP (host path) and Max-Sum without noise
DETERMINISTIC = {
    "sets": {
        "ring": {"path": "graph_coloring_3.yaml", "iterations": 2},
        "meetings": {"path": ["meeting*.yaml"], "iterations": 1},
    },
    "batches": {
        "dpop": {"algo": "dpop"},
        "maxsum": {"algo": "maxsum",
                   "algo_params": {"damping": [0.5, 0.7], "noise": 0},
                   "rounds": 24, "chunk_size": 8},
    },
}
#: Max-Sum with its default noise: the seed reaches every row
NOISY = {
    "sets": {"ring": {"path": "graph_coloring_3.yaml", "iterations": 3}},
    "batches": {"ms": {"algo": "maxsum", "algo_params": {"damping": 0.6},
                       "rounds": 16, "chunk_size": 8,
                       "pad_policy": "pow2"}},
}


def _spec_dir(tmp_path, spec, name="spec.yaml"):
    """The spec written beside copies of the example problems."""
    d = tmp_path / "specs"
    d.mkdir(exist_ok=True)
    for f in ("graph_coloring_3.yaml", "meeting_preferences.yaml"):
        shutil.copy(os.path.join(EXAMPLES, f), d / f)
    (d / name).write_text(yaml.safe_dump(spec))
    return str(d / name)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _batch(main, argv, capsys, extra=()):
    capsys.readouterr()
    rc = main(["batch"] + argv + list(extra))
    out = capsys.readouterr().out
    return rc, out


def _both(spec_file, tmp_path, capsys, flags=()):
    """Run one spec through both packages; returns ((rc, last line,
    rows) for JAX, same for the port)."""
    out = []
    for label, main, extra in (("jax", jax_main, []),
                               ("port", port_main, ["--device", CPU])):
        res = str(tmp_path / f"{label}.csv")
        rc, text = _batch(main, [spec_file, "--result_file", res,
                                 *flags], capsys, extra)
        last = json.loads(text.strip().splitlines()[-1])
        last.pop("result_file")
        out.append((rc, last, _rows(res)))
    return out


def test_simulate_prints_the_jax_text(tmp_path, capsys):
    argv = [SWEEP, "--simulate", "--result_file", str(tmp_path / "r.csv")]
    want = _batch(jax_main, argv, capsys)
    assert _batch(port_main, argv, capsys, ["--device", CPU]) == want
    # with some runs done: the skip states and the count
    res = tmp_path / "r.csv"
    port_main(["batch", SWEEP, "--result_file", str(res), "--device", CPU])
    rows = _rows(res)
    with open(res, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        w.writeheader()
        w.writerows(rows[::2])
    capsys.readouterr()
    want = _batch(jax_main, argv, capsys)
    got = _batch(port_main, argv, capsys, ["--device", CPU])
    assert got == want and "skip:" in got[1]


def test_deterministic_rows_equal_jax(tmp_path, capsys,
                                      jax_gather_lowering):
    (rc_j, last_j, want), (rc_t, last_t, got) = _both(
        _spec_dir(tmp_path, DETERMINISTIC), tmp_path, capsys)
    assert (rc_t, last_t) == (rc_j, last_j) == (0, {
        "runs": 9, "executed": 9, "skipped": 0, "failed": 0})
    assert [[r[k] for k in NO_TIME] for r in got] == [
        [r[k] for k in NO_TIME] for r in want]
    assert {r["status"] for r in got} == {"finished"}


@pytest.mark.parametrize("spec", ["sweep", "noisy"])
def test_seeded_rows_equal_jax_in_keys_and_status(spec, tmp_path, capsys):
    path = SWEEP if spec == "sweep" else _spec_dir(tmp_path, NOISY)
    (rc_j, last_j, want), (rc_t, last_t, got) = _both(path, tmp_path,
                                                      capsys)
    assert (rc_t, last_t) == (rc_j, last_j)
    cols = KEY + ["status", "cycle", "msg_count"]
    assert [[r[k] for k in cols] for r in got] == [
        [r[k] for k in cols] for r in want]


def test_resume_skips_done_keys_and_retries_error_rows(tmp_path, capsys):
    spec = _spec_dir(tmp_path, NOISY)
    res = tmp_path / "port.csv"
    port_main(["batch", spec, "--result_file", str(res), "--device", CPU])
    rows = _rows(res)
    # the second run failed: an error row, retried and dropped on resume
    rows[1].update(status="error: boom", cost="", cycle="", msg_count="",
                   time="")
    seeded = []
    for label in ("jax", "port"):
        f = tmp_path / f"{label}.csv"
        with open(f, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=CSV_FIELDS)
            w.writeheader()
            w.writerows(rows)
        seeded.append(str(f))
    out = []
    for main, f, extra in ((jax_main, seeded[0], []),
                           (port_main, seeded[1], ["--device", CPU])):
        _, text = _batch(main, [spec, "--result_file", f], capsys, extra)
        last = json.loads(text.strip().splitlines()[-1])
        last.pop("result_file")
        out.append((last, [(r["iteration"], r["status"])
                           for r in _rows(f)]))
    assert out[1] == out[0]
    assert out[1] == ({"runs": 3, "executed": 1, "skipped": 2,
                       "failed": 0},
                      [("0", "finished"), ("2", "finished"),
                       ("1", "finished")])
    # the retried row is the run's own: equal to the first pass's
    assert [r["cost"] for r in _rows(seeded[1])] == [
        r["cost"] for r in (_rows(res)[0], _rows(res)[2], _rows(res)[1])]
    # everything done: nothing runs
    _, text = _batch(port_main, [spec, "--result_file", seeded[1],
                                 "--device", CPU], capsys)
    assert json.loads(text.strip().splitlines()[-1])["executed"] == 0


def test_failed_runs_record_error_rows_and_exit_1(tmp_path, capsys):
    spec = {"sets": {"s": {"path": "missing.yaml"}},
            "batches": {"b": {"algo": "maxsum", "rounds": 4}}}
    path = _spec_dir(tmp_path, spec)
    res = str(tmp_path / "r.csv")
    rc, text = _batch(port_main, [path, "--result_file", res], capsys,
                      ["--device", CPU])
    assert rc == 1 and json.loads(text)["failed"] == 1
    (row,) = _rows(res)
    assert row["status"].startswith("error: ") and row["problem"] == (
        "missing.yaml")


def test_without_a_card_the_sweep_raises_before_any_row(tmp_path,
                                                        monkeypatch):
    from pydcop_tpu_torch.device import NoCudaDeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = tmp_path / "r.csv"
    with pytest.raises(NoCudaDeviceError):
        port_main(["batch", SWEEP, "--result_file", str(res)])
    assert not res.exists() or _rows(res) == []
    assert port_main(["batch", SWEEP, "--result_file", str(res),
                      "--simulate"]) == 0


def test_vmap_cells_rows_equal_the_sequential_rows(tmp_path, monkeypatch):
    spec = _spec_dir(tmp_path, {
        "sets": {"ring": {"path": "graph_coloring_3.yaml", "iterations": 2},
                 "meet": {"path": "meeting_preferences.yaml",
                          "iterations": 2}},
        "batches": {"ms": {"algo": "maxsum",
                           "algo_params": {"damping": [0.5, 0.8]},
                           "rounds": 24, "chunk_size": 8,
                           "pad_policy": "pow2"},
                    "dpop": {"algo": "dpop"}},
    })
    rows = {}
    calls = []
    many = tapi.solve_many

    def recording(dcops, *a, **kw):
        out = many(dcops, *a, **kw)
        calls.append([r["instances_batched"] for r in out])
        return out

    monkeypatch.setattr(tapi, "solve_many", recording)
    for flags in ([], ["--vmap_cells"]):
        res = str(tmp_path / f"r{len(flags)}.csv")
        port_main(["batch", spec, "--result_file", res, "--device", CPU]
                  + flags)
        rows[len(flags)] = _rows(res)
    # one solve_many call for the Max-Sum batch (8 runs, 2 groups of 4:
    # the two problems' shapes), none for DPOP (the host path)
    assert calls == [[4] * 8]
    key = {tuple(r[k] for k in KEY): [r[k] for k in NO_TIME]
           for r in rows[1]}
    assert len(key) == len(rows[0]) == 12
    for r in rows[0]:
        assert key[tuple(r[k] for k in KEY)] == [r[k] for k in NO_TIME]


def test_vmap_iterations_makes_one_solve_per_cell(tmp_path, monkeypatch):
    spec = _spec_dir(tmp_path, NOISY)
    solve = tapi.solve
    calls = []

    def recording(dcop, *a, **kw):
        calls.append(kw.get("n_restarts"))
        out = solve(dcop, *a, **kw)
        calls[-1] = (calls[-1], out["restart_costs"])
        return out

    res = str(tmp_path / "r.csv")
    monkeypatch.setattr(tapi, "solve", recording)
    port_main(["batch", spec, "--result_file", res, "--device", CPU,
               "--vmap_iterations"])
    ((k, costs),) = calls
    assert k == 3
    assert [float(r["cost"]) for r in _rows(res)] == costs


def test_run_sweep_takes_a_dict_spec_and_a_loader(tmp_path):
    """The seam ``chip_smoke.py`` drives: problems built in memory, named
    by strings that match no file, each loaded once."""
    dcop = load_dcop_from_file(COLORING)
    loads = []

    def load(problem):
        loads.append(os.path.basename(problem))
        return dcop

    spec = {"sets": {"mem": {"path": ["ring-a", "ring-b"],
                             "iterations": 2}},
            "batches": {"ms": {"algo": "maxsum",
                               "algo_params": {"damping": [0.5, 0.7],
                                               "noise": 0},
                               "rounds": 8, "chunk_size": 8}}}
    res = str(tmp_path / "r.csv")
    for vmap_cells in (False, True):
        out = run_sweep(spec, str(tmp_path), res, vmap_cells=vmap_cells,
                        device=CPU, load=load)
        assert out == {"runs": 8, "executed": 0 if vmap_cells else 8,
                       "skipped": 8 if vmap_cells else 0, "failed": 0,
                       "result_file": res}
    assert loads == ["ring-a", "ring-b"]
    rows = _rows(res)
    assert [r["problem"] for r in rows] == ["ring-a"] * 4 + ["ring-b"] * 4
    assert {r["status"] for r in rows} == {"finished"}
    assert run_sweep(spec, str(tmp_path), res, simulate=True,
                     load=load) is None


@pytest.fixture(scope="module")
def result_csvs(tmp_path_factory):
    """A JAX-written and a port-written result CSV of the same sweep, the
    port's with an error row (excluded from the aggregates, counted)."""
    d = tmp_path_factory.mktemp("csvs")
    spec = _spec_dir(d, DETERMINISTIC)
    jax_main(["batch", spec, "--result_file", str(d / "jax.csv")])
    port_main(["batch", spec, "--result_file", str(d / "port.csv"),
               "--device", CPU])
    with open(d / "port.csv", "a", newline="") as f:
        csv.writer(f).writerow(["maxsum", "ring", "x.yaml", "0", "maxsum",
                                "{}", "error: boom", "", "", "", ""])
    return d


@pytest.mark.parametrize("flags", [
    [], ["--group_by", "params"],
    ["--group_by", "algo", "params", "--aggregate", "min"],
    ["--group_by", "batch", "--aggregate", "max"],
])
def test_consolidate_writes_the_jax_csv(flags, result_csvs, tmp_path,
                                        capsys):
    for inputs in ([str(result_csvs / "jax.csv")],
                   [str(result_csvs / "port.csv")],
                   [str(result_csvs / "*.csv")]):
        out = []
        for label, main in (("jax", jax_main), ("port", port_main)):
            res = tmp_path / f"c_{label}.csv"
            capsys.readouterr()
            main(["consolidate", *inputs, "--result_file", str(res),
                  *flags])
            last = json.loads(capsys.readouterr().out)
            last.pop("result_file")
            out.append((last, res.read_text()))
        assert out[1] == out[0], inputs
        assert out[1][0]["files"] == len(glob.glob(inputs[0]))


def test_consolidate_unknown_column_as_jax(tmp_path):
    res = tmp_path / "r.csv"
    res.write_text("a,b\n1,2\n")
    msgs = []
    for main in (jax_main, port_main):
        with pytest.raises(SystemExit) as e:
            main(["consolidate", str(res), "--group_by", "nope",
                  "--result_file", str(tmp_path / "o.csv")])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "consolidate: unknown column(s) ['nope']"
