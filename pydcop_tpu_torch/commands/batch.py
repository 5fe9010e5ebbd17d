"""``pydcop_tpu_torch batch`` (port of ``pydcop_tpu/commands/batch.py``;
reference: ``pydcop/commands/batch.py``).

Parameter-sweep experiment runner: a yaml spec defines problem *sets*
(file globs + iteration counts) and *batches* (command options, with
list-valued parameters expanded as a cross product).  Every (batch,
problem, parameter-combination, iteration) tuple is solved in-process
on the batched engine and appended as one CSV row — the reference's
reproducibility harness.  The runs go to the CUDA device unless
``--device cpu`` is given.

:func:`run_sweep` is the sweep once the spec is read: it takes the spec
as a dict and a ``load`` function from a problem string to a DCOP
(default: the port's ``load_dcop_from_file``), loads each problem once,
and hands the DCOP objects to ``api.solve``/``api.solve_many``; rows
record the problem string, as the JAX command does.

Finished runs are skipped when the output CSV already contains their
key, giving crude experiment-level resume (same behavior the reference
gets by skipping existing output files).

``--vmap_iterations`` collapses each (problem, parameter-combination)
cell's iterations into ONE multi-restart solve (engine ``n_restarts``:
the restarts share each kernel launch) — K iterations at roughly one
run's wall-clock, one row per iteration from the per-restart cost
distribution.

Spec format::

    sets:
      coloring:
        path: "instances/coloring_*.yaml"   # glob or list of files
        iterations: 3                        # seeds 0..2
    batches:
      dsa_sweep:
        algo: dsa
        algo_params:
          variant: [A, B, C]                 # lists are swept
          probability: 0.7
        rounds: 200
        timeout: 10
"""

from __future__ import annotations

import csv
import glob as globmod
import itertools
import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

# batch options forwarded to api.solve (anything else is a spec error)
_SOLVE_OPTIONS = {
    "rounds",
    "timeout",
    "chunk_size",
    "convergence_chunks",
    "n_restarts",
    "pad_policy",
    # supervised device dispatch (engine/supervisor.py): a sweep can
    # tune retry/degradation policy per batch — useful on busy shared
    # accelerators where transient failures and HBM pressure are real
    "retry_budget",
    "chunk_floor",
    "on_numeric_fault",
}


def _supervisor_options(options: Dict[str, Any]) -> Dict[str, Any]:
    """The supervised-dispatch knobs of a batch spec, typed for
    ``api.solve``/``api.solve_many`` (absent keys stay None = the
    supervisor defaults)."""
    out: Dict[str, Any] = {}
    if options.get("retry_budget") is not None:
        out["retry_budget"] = int(options["retry_budget"])
    if options.get("chunk_floor") is not None:
        out["chunk_floor"] = int(options["chunk_floor"])
    if options.get("on_numeric_fault") is not None:
        out["on_numeric_fault"] = str(options["on_numeric_fault"])
    return out

CSV_FIELDS = [
    "batch",
    "set",
    "problem",
    "iteration",
    "algo",
    "params",
    "status",
    "cost",
    "cycle",
    "msg_count",
    "time",
]


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "batch", help="run a parameter-sweep experiment from a yaml spec"
    )
    p.add_argument("spec", help="batch spec yaml file")
    p.add_argument(
        "--result_file", default="batch_results.csv",
        help="CSV to append per-run rows to (existing rows are skipped)",
    )
    p.add_argument(
        "--simulate", action="store_true",
        help="list the runs without executing them",
    )
    p.add_argument(
        "--vmap_iterations", action="store_true",
        help="solve all iterations of a (problem, params) cell as ONE "
        "batched multi-restart run (engine n_restarts) — K iterations "
        "at roughly one run's wall-clock on accelerators.  Each "
        "iteration's row gets its own restart's cost; RNG streams "
        "differ from sequential per-seed runs (both are valid "
        "independent samples, but rows are not bit-reproducible "
        "across the two modes).  Applies only to plain fixed-round "
        "cells; cells with timeout/convergence_chunks (early stops "
        "would truncate non-best restarts), partially-done cells, "
        "host-path algorithms, single-iteration cells, and cells "
        "whose batched solve fails all fall back to sequential runs",
    )
    p.add_argument(
        "--vmap_cells", action="store_true",
        help="collapse WHOLE same-bucket groups of (problem x params "
        "x iteration) cells into one batched device call each "
        "(api.solve_many): every pending run becomes one instance "
        "with seed=iteration, instances whose compiled problems share "
        "a shape bucket (spec option pad_policy, default pow2 here) "
        "and static params solve in one device program.  Rows are "
        "bit-identical to sequential runs for deterministic "
        "algorithms.  Cells with timeout/convergence_chunks (early "
        "stops act on a whole group at once) and host-path "
        "algorithms fall back to sequential runs; supersedes "
        "--vmap_iterations for the runs it covers",
    )
    p.add_argument(
        "--device", default=None,
        help="'cpu' to run on the CPU; default: the CUDA device (the "
        "command fails when there is none)",
    )
    p.set_defaults(func=run_cmd)


def _expand_params(algo_params: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    """Cross product over list-valued parameters."""
    if not algo_params:
        yield {}
        return
    keys = sorted(algo_params)
    pools = [
        v if isinstance(v, list) else [v]
        for v in (algo_params[k] for k in keys)
    ]
    for combo in itertools.product(*pools):
        yield dict(zip(keys, combo))


def _set_files(set_def: Dict[str, Any], base_dir: str) -> List[str]:
    path = set_def.get("path")
    if isinstance(path, list):
        files: List[str] = []
        for p in path:
            files.extend(_resolve(p, base_dir))
        return files
    return _resolve(path, base_dir)


def _resolve(pattern: str, base_dir: str) -> List[str]:
    if not os.path.isabs(pattern):
        pattern = os.path.join(base_dir, pattern)
    matches = sorted(globmod.glob(pattern))
    return matches if matches else [pattern]


def iter_runs(
    spec: Dict[str, Any], base_dir: str
) -> Iterator[Tuple[str, str, str, int, str, Dict[str, Any], Dict[str, Any]]]:
    """Yield (batch, set, problem, iteration, algo, params, options)."""
    sets = spec.get("sets", {}) or {}
    batches = spec.get("batches", {}) or {}
    for bname, bdef in sorted(batches.items()):
        algo = bdef.get("algo")
        if not algo:
            raise SystemExit(f"batch {bname!r}: missing 'algo'")
        options = {
            k: v
            for k, v in bdef.items()
            if k not in ("algo", "algo_params")
        }
        unknown = set(options) - _SOLVE_OPTIONS
        if unknown:
            raise SystemExit(
                f"batch {bname!r}: unknown option(s) {sorted(unknown)}; "
                f"accepted: {sorted(_SOLVE_OPTIONS)}"
            )
        for sname, sdef in sorted(sets.items()):
            iterations = int(sdef.get("iterations", 1))
            for problem in _set_files(sdef, base_dir):
                for params in _expand_params(bdef.get("algo_params")):
                    for it in range(iterations):
                        yield (
                            bname, sname, problem, it, algo, params, options
                        )


def _run_key(batch, set_, problem, iteration, algo, params, base_dir) -> Tuple:
    # path relative to the spec dir: distinguishes same-named files in
    # different directories, stays stable if the tree moves
    try:
        pkey = os.path.relpath(problem, base_dir)
    except ValueError:  # different drive (windows)
        pkey = problem
    return (
        batch,
        set_,
        pkey,
        str(iteration),
        algo,
        json.dumps(params, sort_keys=True),
    )


def _write_row(writer, run, result, base_dir) -> None:
    batch, set_, problem, it, algo, params, _ = run
    key = _run_key(batch, set_, problem, it, algo, params, base_dir)
    writer.writerow(
        {
            "batch": key[0],
            "set": key[1],
            "problem": key[2],
            "iteration": key[3],
            "algo": key[4],
            "params": key[5],
            "status": result["status"],
            "cost": result["cost"],
            "cycle": result["cycle"],
            "msg_count": result["msg_count"],
            "time": result["time"],
        }
    )


def _vmappable(algo: str) -> bool:
    from pydcop_tpu_torch.algorithms import load_algorithm_module

    try:
        return not hasattr(load_algorithm_module(algo), "solve_host")
    except Exception:
        return False


def _vmap_cells_pass(writer, fobj, runs, done, base_dir, device, load):
    """``--vmap_cells``: execute every eligible pending run through
    :func:`pydcop_tpu_torch.api.solve_many`, grouped per batch (options
    are uniform within a batch, so rounds/chunk_size agree).

    Each run becomes one problem instance with ``seed=iteration`` —
    the exact seed the sequential loop would use, so rows are
    bit-identical to sequential execution for deterministic
    algorithms.  ``solve_many`` splits each batch's instances into
    same-bucket, same-static-params groups internally and solves each
    group in one batched device program (one launch of each kernel a
    round for the whole group); a batch whose batched solve fails falls
    back (untouched) to the sequential loop.

    Eligible: vmappable (non-host-path) algorithm, no ``timeout`` and
    no ``convergence_chunks`` in the batch options — early stops act
    on a whole fused group at once, which would diverge from the
    per-run semantics the rows claim.

    Returns ``(handled_keys, executed, failed)``.
    """
    from pydcop_tpu_torch.api import solve_many

    handled = set()
    executed = failed = 0
    by_batch: Dict[str, List[Tuple[Tuple, Tuple]]] = {}
    for run in runs:
        batch, set_, problem, it, algo, params, options = run
        key = _run_key(batch, set_, problem, it, algo, params, base_dir)
        if key in done:
            continue
        if options.get("timeout") is not None:
            continue
        if int(options.get("convergence_chunks", 0)):
            continue
        if not _vmappable(algo):
            continue
        by_batch.setdefault(batch, []).append((run, key))
    for batch, pairs in sorted(by_batch.items()):
        _, _, _, _, algo, _, options = pairs[0][0]
        try:
            results = solve_many(
                [load(run[2]) for run, _ in pairs],
                algo,
                [run[5] for run, _ in pairs],
                rounds=int(options.get("rounds", 200)),
                chunk_size=int(options.get("chunk_size", 64)),
                n_restarts=int(options.get("n_restarts", 1)),
                pad_policy=options.get("pad_policy", "pow2"),
                seed=[run[3] for run, _ in pairs],
                device=device,
                **_supervisor_options(options),
            )
        except Exception:
            # e.g. the stacked state OOMs where single runs fit — the
            # whole batch falls back to the sequential per-run loop
            continue
        for (run, key), result in zip(pairs, results):
            # result["time"] is already the instance's even share of
            # its group's wall-clock (api.solve_many)
            _write_row(writer, run, {
                "status": result["status"],
                "cost": result["cost"],
                "cycle": result["cycle"],
                "msg_count": result["msg_count"],
                "time": round(result["time"], 6),
            }, base_dir)
            handled.add(key)
            executed += 1
        fobj.flush()
    return handled, executed, failed


def run_cmd(args) -> int:
    import yaml

    with open(args.spec) as f:
        spec = yaml.safe_load(f)
    summary = run_sweep(
        spec,
        os.path.dirname(os.path.abspath(args.spec)),
        args.result_file,
        simulate=args.simulate,
        vmap_iterations=args.vmap_iterations,
        vmap_cells=args.vmap_cells,
        device=args.device,
    )
    if summary is None:  # --simulate printed the runs
        return 0
    print(json.dumps(summary))
    return 0 if summary["failed"] == 0 else 1


def run_sweep(
    spec: Dict[str, Any],
    base_dir: str,
    result_file: str,
    *,
    simulate: bool = False,
    vmap_iterations: bool = False,
    vmap_cells: bool = False,
    device=None,
    load: Optional[Callable[[str], Any]] = None,
) -> Optional[Dict[str, Any]]:
    """Run (or with ``simulate`` list) the sweep of ``spec``, appending
    one row a run to ``result_file``; relative ``path`` entries resolve
    against ``base_dir``.  ``load`` maps a problem string (a path, or a
    pattern that matched no file, passed through joined to ``base_dir``)
    to a DCOP; each problem is loaded once.  Returns the command's final
    JSON record (``runs``, ``executed``, ``skipped``, ``failed``,
    ``result_file``), or None under ``simulate``."""
    if load is None:
        from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

        load = load_dcop_from_file
    loaded: Dict[str, Any] = {}

    def load_once(problem: str):
        if problem not in loaded:
            loaded[problem] = load(problem)
        return loaded[problem]

    done = set()
    exists = os.path.exists(result_file)
    if exists:
        kept_rows: List[Dict[str, str]] = []
        n_errors = 0
        with open(result_file, newline="") as f:
            for row in csv.DictReader(f):
                if row.get("status", "").startswith("error"):
                    n_errors += 1  # retried on resume; row superseded
                    continue
                kept_rows.append(row)
                done.add(
                    (
                        row["batch"],
                        row["set"],
                        row["problem"],
                        row["iteration"],
                        row["algo"],
                        row["params"],
                    )
                )
        if n_errors and not simulate:
            # drop the stale error rows so a successful retry doesn't
            # leave two rows per key (consolidate would keep counting
            # the superseded failure); write-then-rename so a crash
            # mid-rewrite can't lose the successful rows
            import tempfile

            d = os.path.dirname(os.path.abspath(result_file))
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".csv.tmp")
            try:
                with os.fdopen(fd, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=CSV_FIELDS)
                    w.writeheader()
                    w.writerows(kept_rows)
                os.replace(tmp, result_file)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise

    runs = list(iter_runs(spec, base_dir))
    if simulate:
        for batch, set_, problem, it, algo, params, options in runs:
            key = _run_key(batch, set_, problem, it, algo, params, base_dir)
            state = "skip" if key in done else "run"
            print(
                f"{state}: [{batch}/{set_}] {os.path.basename(problem)} "
                f"algo={algo} params={params} iteration={it}"
            )
        print(f"{len(runs)} runs total, {len(done)} already done")
        return None

    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.device import resolve_device

    # no card and no --device cpu: fail before the first row, instead of
    # recording every run as an error
    device = resolve_device(device)

    # group consecutive runs that differ only in `iteration` (the
    # innermost loop of iter_runs): each group is one sweep cell
    cells: List[List[Tuple]] = []
    for run in runs:
        if cells and cells[-1][0][:3] + cells[-1][0][4:] == run[:3] + run[4:]:
            cells[-1].append(run)
        else:
            cells.append([run])

    executed = skipped = failed = 0
    handled: set = set()
    with open(result_file, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        if not exists:
            writer.writeheader()
        if vmap_cells:
            handled, cells_executed, _ = _vmap_cells_pass(
                writer, f, runs, done, base_dir, device, load_once
            )
            executed += cells_executed
        for cell in cells:
            batch, set_, problem, _, algo, params, options = cell[0]
            keys = [
                _run_key(
                    run[0], run[1], run[2], run[3], run[4], run[5],
                    base_dir,
                )
                for run in cell
            ]
            skipped += sum(1 for k in keys if k in done)
            pending = [
                run for run, k in zip(cell, keys)
                if k not in done and k not in handled
            ]
            if not pending:
                continue
            common = dict(
                rounds=int(options.get("rounds", 200)),
                timeout=options.get("timeout"),
                chunk_size=int(options.get("chunk_size", 64)),
                convergence_chunks=int(
                    options.get("convergence_chunks", 0)
                ),
                n_restarts=int(options.get("n_restarts", 1)),
                pad_policy=options.get("pad_policy", "none"),
                device=device,
                **_supervisor_options(options),
            )
            # vmap only plain fixed-round cells: a shared timeout or a
            # best-judged convergence stop would truncate the non-best
            # restarts mid-descent, biasing their cost rows vs what
            # the same spec records sequentially; an n_restarts option
            # already claims the restart axis for best-of-K rows
            if (
                vmap_iterations
                and len(pending) == len(cell)  # whole cell fresh
                and len(cell) > 1
                and common["timeout"] is None
                and common["convergence_chunks"] == 0
                and common["n_restarts"] == 1
                and _vmappable(algo)
            ):
                try:
                    result = solve(
                        load_once(problem), algo, params, seed=0,
                        **{**common, "n_restarts": len(cell)},
                    )
                    for i, run in enumerate(cell):
                        _write_row(writer, run, {
                            "status": result["status"],
                            "cost": result["restart_costs"][i],
                            "cycle": result["cycle"],
                            # per-iteration share of the cell's totals
                            "msg_count": result["msg_count"] // len(cell),
                            "time": round(result["time"] / len(cell), 6),
                        }, base_dir)
                        executed += 1
                    f.flush()
                    continue
                except Exception:
                    # e.g. the K-fold state OOMs where one run fits —
                    # fall through to the sequential per-run loop
                    # rather than condemning the whole cell
                    pass
            for run in pending:
                it = run[3]
                try:
                    result = solve(
                        load_once(problem), algo, params, seed=it, **common
                    )
                except Exception as e:  # record failure, keep sweeping
                    failed += 1
                    result = {
                        "status": f"error: {e}", "cost": "", "cycle": "",
                        "msg_count": "", "time": "",
                    }
                _write_row(writer, run, result, base_dir)
                f.flush()
                executed += 1
    return {
        "runs": len(runs),
        "executed": executed,
        "skipped": skipped,
        "failed": failed,
        "result_file": result_file,
    }
