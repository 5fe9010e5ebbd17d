"""Checkpoint and resume of the port's batched engine
(``pydcop_tpu_torch/engine/checkpoint.py``, ``run_batched``), on the
model of the JAX package's ``tests/test_checkpoint.py``.

On the CPU: the ``.npz`` round trip (nested leaves, static keys, bf16
messages as raw records), the shape, dtype and missing-leaf rejections,
a run resumed from its checkpoint equal to an uninterrupted run in every
result key but ``time`` (Max-Sum, DSA, MGM-2, A-Max-Sum and a K-restart
stack: the rounds' generator state travels in the file), each of the
five compatibility checks, the ``solve`` CLI's ``--checkpoint`` and
``--resume``, the problem fingerprint against the JAX package's on the
same YAML, and a stochastic run refusing to resume on another device
type.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pydcop_tpu.ops import compile as jcompile  # noqa: E402
from pydcop_tpu.dcop.yamldcop import load_dcop_from_file as jload  # noqa

from pydcop_tpu_torch import telemetry as ttel  # noqa: E402
from pydcop_tpu_torch.algorithms import (  # noqa: E402
    load_algorithm_module,
    prepare_algo_params,
)
from pydcop_tpu_torch.api import solve, solve_compiled  # noqa: E402
from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file as tload  # noqa
from pydcop_tpu_torch.engine.batched import run_batched  # noqa: E402
from pydcop_tpu_torch.engine.checkpoint import (  # noqa: E402
    checkpoint_meta,
    load_checkpoint,
    save_checkpoint,
)
from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from pydcop_tpu_torch.ops.generate import coloring_arrays  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = os.path.join(REPO, "examples", "graph_coloring_3.yaml")
CPU = "cpu"


@pytest.fixture(autouse=True)
def no_session_left():
    assert ttel._active is None
    yield
    assert ttel._active is None


def coloring(n=60, seed=4, **kw):
    sc, tb, un = coloring_arrays(n, seed=seed)
    return tcompile.compile_from_arrays(sc, tb, 3, unary=un, device=CPU,
                                        **kw)


def rewrite_meta(path, **changes):
    """The checkpoint at ``path`` with its meta record changed."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta.update(changes)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)


# -- the file -------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ck.npz")
    state = {
        "values": torch.arange(4, dtype=torch.int32),
        "nested": {"msgs": torch.ones((3, 2))},
    }
    save_checkpoint(path, state, 1.5, np.zeros(4, np.int32), 42, {"x": "y"})
    template = {"values": torch.zeros(4, dtype=torch.int32),
                "nested": {"msgs": torch.zeros((3, 2))}}
    got, best_cost, best_values, rounds, meta = load_checkpoint(
        path, template)
    assert (best_cost, rounds, meta["x"]) == (1.5, 42, "y")
    assert torch.equal(got["values"], state["values"])
    assert torch.equal(got["nested"]["msgs"], state["nested"]["msgs"])
    assert np.array_equal(best_values, np.zeros(4))
    with np.load(path) as data:  # the JAX package's layout
        assert set(data.files) == {"state/values", "state/nested/msgs",
                                   "best_values", "__meta__"}
    assert os.listdir(tmp_path) == ["ck.npz"]  # no temporary file left


def test_checkpoint_rejects_wrong_shape_and_missing_leaves(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"values": torch.zeros(4)}, 0.0, np.zeros(4), 1)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"values": torch.zeros(5)})
    with pytest.raises(ValueError, match="misses"):
        load_checkpoint(path, {"other": torch.zeros(4)})


def test_checkpoint_rejects_wrong_dtype(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"q": torch.zeros(4)}, 0.0, np.zeros(4), 1)
    with pytest.raises(ValueError, match="expects int32"):
        load_checkpoint(path, {"q": torch.zeros(4, dtype=torch.int32)})
    with pytest.raises(ValueError, match="expects bfloat16"):
        load_checkpoint(path, {"q": torch.zeros(4, dtype=torch.bfloat16)})
    save_checkpoint(path, {"q": torch.zeros(4, dtype=torch.bfloat16)}, 0.0,
                    np.zeros(4), 1)
    with pytest.raises(ValueError, match="msg_dtype setting"):
        load_checkpoint(path, {"q": torch.zeros(4)})


def test_checkpoint_never_unpickles(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"q": torch.zeros(2)}, 0.0, np.zeros(2), 1)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["state/q"] = np.array([object(), object()], dtype=object)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="pickle"):
        load_checkpoint(path, {"q": torch.zeros(2)})


def test_checkpoint_static_keys_roundtrip(tmp_path):
    path = str(tmp_path / "ck.npz")
    state = {"values": torch.arange(4, dtype=torch.int32),
             "idx": torch.arange(12, dtype=torch.int32).reshape(3, 4)}
    save_checkpoint(path, state, 2.0, np.zeros(4, np.int32), 7,
                    static_keys=("idx",))
    with np.load(path) as data:
        assert "state/values" in data.files
        assert "state/idx" not in data.files  # skipped at save
    template = {"values": torch.zeros(4, dtype=torch.int32),
                "idx": state["idx"] + 0}
    got, best_cost, _, rounds, _ = load_checkpoint(
        path, template, static_keys=("idx",))
    assert (best_cost, rounds) == (2.0, 7)
    assert torch.equal(got["values"], state["values"])
    assert torch.equal(got["idx"], state["idx"])  # backfilled
    with pytest.raises(ValueError, match="misses"):
        load_checkpoint(path, template)


# -- resume -----------------------------------------------------------------


def _split_run(tmp_path, algo, prm, n_restarts=1, problem=None):
    """(uninterrupted 64-round result, resumed result): 32 rounds saved,
    then 64 resumed, chunk 16, through ``solve_compiled``."""
    problem = coloring() if problem is None else problem
    path = str(tmp_path / f"{algo}.npz")
    kw = dict(seed=2, chunk_size=16, n_restarts=n_restarts, cost_every=4)
    full = solve_compiled(problem, algo, prm, rounds=64, **kw)
    half = solve_compiled(problem, algo, prm, rounds=32,
                          checkpoint_path=path, **kw)
    assert half["cycle"] == 32 and os.path.exists(path)
    resumed = solve_compiled(problem, algo, prm, rounds=64,
                             checkpoint_path=path, resume=True, **kw)
    return full, resumed, path


@pytest.mark.parametrize("algo,prm", [
    ("maxsum", {"damping": 0.5}), ("dsa", {"variant": "B"}),
    ("mgm2", {}), ("amaxsum", {}),
])
def test_resume_equals_uninterrupted_run(tmp_path, algo, prm):
    full, resumed, path = _split_run(tmp_path, algo, prm)
    assert resumed.pop("time") >= 0 and full.pop("time") >= 0
    assert resumed == full
    assert len(full["cost_trace"]) == 16  # the restored samples included
    meta = checkpoint_meta(path)
    assert meta["rounds_done"] == 64 and meta["rng_device"] == CPU
    # Max-Sum draws nothing a round; DSA, MGM-2, A-Max-Sum do
    assert meta["rng_drawn"] == (algo != "maxsum")


def test_resume_restart_stack(tmp_path):
    full, resumed, path = _split_run(tmp_path, "dsa", {"variant": "B"},
                                     n_restarts=4)
    full.pop("time"), resumed.pop("time")
    assert resumed == full and len(full["restart_costs"]) == 4
    with np.load(path) as data:
        assert data["state/values"].shape == (4, 60)
        assert data["best_values"].shape == (4, 60)
    mod = load_algorithm_module("dsa")
    with pytest.raises(ValueError, match="n_restarts"):
        run_batched(coloring(), mod, prepare_algo_params(
            {"variant": "B"}, mod.algo_params), rounds=64, seed=2,
            chunk_size=16, n_restarts=8, checkpoint_path=path, resume=True)


def test_resume_bf16_messages(tmp_path):
    """bf16 message state round-trips as raw 2-byte records."""
    full, resumed, path = _split_run(
        tmp_path, "maxsum", {"msg_dtype": "bf16"})
    full.pop("time"), resumed.pop("time")
    assert resumed == full
    with np.load(path) as data:
        assert data["state/q"].dtype.kind == "V"


def test_resume_backfills_static_state_keys(tmp_path):
    """A checkpoint without a static leaf (mgm2's pair index data) stays
    resumable: the leaf is rebuilt from the fresh template."""
    mod = load_algorithm_module("mgm2")
    static = sorted(mod.STATIC_STATE_KEYS)
    full, resumed, path = _split_run(tmp_path, "mgm2", {})
    with np.load(path) as data:
        assert not any(f"state/{k}" in data.files for k in static)
    full.pop("time"), resumed.pop("time")
    assert resumed == full


_REJECT = {
    # name: (keyword changed on resume, the message)
    "algo": ({"algo": "mgm"}, "was written by"),
    "seed": ({"seed": 3}, "seed 2, not 3"),
    "chunk_size": ({"chunk_size": 8}, "chunk_size 16, not 8"),
    "problem": ({"problem": "other"}, "different problem instance"),
    "n_restarts": ({"n_restarts": 2}, "n_restarts=1, not 2"),
}


@pytest.mark.parametrize("name", sorted(_REJECT))
def test_resume_rejects_an_incompatible_checkpoint(tmp_path, name):
    change, msg = _REJECT[name]
    path = str(tmp_path / "ck.npz")
    kw = dict(rounds=16, seed=2, chunk_size=16, checkpoint_path=path)
    solve_compiled(coloring(), "dsa", **kw)
    kw.update(resume=True, rounds=32)
    problem = coloring(seed=5) if name == "problem" else coloring()
    algo = change.get("algo", "dsa")
    kw.update({k: v for k, v in change.items()
               if k in ("seed", "chunk_size", "n_restarts")})
    with pytest.raises(ValueError, match=msg):
        solve_compiled(problem, algo, **kw)


def test_stochastic_resume_refuses_another_device_type(tmp_path):
    """A generator state belongs to its device type: a DSA checkpoint
    marked as written on the card cannot continue on the CPU; Max-Sum,
    which draws nothing a round, resumes across."""
    for algo, raises in (("dsa", True), ("maxsum", False)):
        path = str(tmp_path / f"{algo}.npz")
        solve_compiled(coloring(), algo, rounds=16, chunk_size=16,
                       checkpoint_path=path)
        rewrite_meta(path, rng_device="cuda")
        if raises:
            with pytest.raises(ValueError, match="resume on a cuda"):
                solve_compiled(coloring(), algo, rounds=32, chunk_size=16,
                               checkpoint_path=path, resume=True)
        else:
            r = solve_compiled(coloring(), algo, rounds=32, chunk_size=16,
                               checkpoint_path=path, resume=True)
            assert r["cycle"] == 32


def test_checkpoint_every_and_telemetry(tmp_path):
    """Saves every ``checkpoint_every`` chunks inside a ``checkpoint``
    span (``engine.checkpoints``), plus a final save of the rest."""
    path = str(tmp_path / "ck.npz")
    r = solve(RING, "maxsum", rounds=40, chunk_size=8, checkpoint_path=path,
              checkpoint_every=2, device=CPU)
    c = r["telemetry"]["counters"]
    assert c["engine.checkpoints"] == 2  # after chunks 2 and 4; 5 at the end
    assert "checkpoint" in r["telemetry"]["phases"]
    assert checkpoint_meta(path)["rounds_done"] == 40
    with pytest.raises(ValueError, match="checkpoint"):
        solve(RING, "dpop", checkpoint_path=path, device=CPU)


def test_solve_cli_checkpoint_resume(tmp_path, capsys):
    from pydcop_tpu_torch.cli import main

    ck = str(tmp_path / "state.npz")
    assert main(["solve", RING, "-a", "dsa", "--rounds", "20",
                 "--checkpoint", ck, "--device", "cpu"]) == 0
    capsys.readouterr()
    assert os.path.exists(ck)
    assert main(["solve", RING, "-a", "dsa", "--rounds", "40",
                 "--checkpoint", ck, "--checkpoint_every", "2", "--resume",
                 "--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert result["cycle"] == 40  # 20 restored + 20 new
    assert checkpoint_meta(ck)["rounds_done"] == 40


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
def test_fingerprint_equals_jax(table_dtype):
    """The same YAML (and array-built problem) fingerprints alike in both
    packages: host bytes, bf16 tables as raw words."""
    from pydcop_tpu.ops.generate import coloring_arrays as jcol

    kw = {"table_dtype": table_dtype}
    want = jcompile.problem_fingerprint(jcompile.compile_dcop(jload(RING),
                                                              **kw))
    got = tcompile.problem_fingerprint(tcompile.compile_dcop(
        tload(RING), device=CPU, **kw))
    assert got == want and len(got) == 16
    sc, tb, un = jcol(60, seed=4)
    want = jcompile.problem_fingerprint(
        jcompile.compile_from_arrays(sc, tb, 3, unary=un, **kw))
    assert tcompile.problem_fingerprint(coloring(**kw)) == want
    assert tcompile.problem_fingerprint(coloring(seed=5)) != (
        tcompile.problem_fingerprint(coloring()))
