"""Several instances at once: the port's ``api.solve_many`` and
``engine.run_many_batched`` against the JAX package's ``solve_many`` and
against the port's own sequential solves (CPU).

- Max-Sum with ``noise=0`` (deterministic in both packages) gives each
  instance the JAX ``solve_many``'s assignment and cost (an f32 sum in
  another order: within 1e-6), with the JAX engine on its per-slot
  gather belief (ROADMAP queue C, 'Belief summation').
- A deterministic algorithm (Max-Sum, MGM, DBA, GDBA) gives each
  instance exactly what ``solve(dcops[i], seed=seeds[i], pad_policy=…)``
  gives, with and without restarts: the result dicts are equal key for
  key (time fields aside).
- A stochastic one (DSA, A-Max-Sum) is held through ``apply``: one
  round of the group on the group's draws equals each instance's round
  on its slice of them, bit for bit.
- DPOP gives the JAX ``solve_many``'s results, ``util_dispatches``
  included.
- Numeric params may differ inside a group; str/bool params split it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import pydcop_tpu.dcop as jdcop  # noqa: E402
from pydcop_tpu.api import solve_many as jax_solve_many  # noqa: E402

import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
from pydcop_tpu_torch.algorithms import load_algorithm_module  # noqa: E402
from pydcop_tpu_torch.algorithms import prepare_algo_params  # noqa: E402
from pydcop_tpu_torch.api import solve, solve_many  # noqa: E402
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml  # noqa: E402
from pydcop_tpu_torch.engine import batched  # noqa: E402
from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from test_torch_dpop import STATS, random_tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD = "pow2:16"
SIZES = (5, 6, 8, 40)  # three share the 16-variable bucket


def ring(m, n, seed=0, maximize=False):
    """A ring of n 3-colour variables with weights 1..3 and small
    per-variable value costs (so Max-Sum has one optimum to find)."""
    rng = np.random.RandomState(seed + n)
    dom = m.Domain("d", "", [0, 1, 2])
    dcop = m.DCOP(f"ring{n}", objective="max" if maximize else "min")
    vs = [
        m.VariableWithCostDict(
            f"v{i}", dom,
            {k: float(c) for k, c in enumerate(rng.randint(0, 4, 3) / 8)},
        )
        for i in range(n)
    ]
    for v in vs:
        dcop.add_variable(v)
    for i in range(n):
        j = (i + 1) % n
        w = 1 + (i % 3)
        dcop.add_constraint(m.constraint_from_str(
            f"c{i}_{j}", f"{w} if v{i} == v{j} else 0", vs
        ))
    return dcop


def _same_result(got, want):
    # every key but the call's time, its group size and its telemetry
    # block (one per call, covering the whole group)
    for k in set(want) - {"time", "instances_batched", "telemetry"}:
        assert got[k] == want[k], (k, got[k], want[k])


@pytest.fixture
def jax_gather_lowering(monkeypatch):
    from pydcop_tpu.engine import batched as jbatched
    from pydcop_tpu.ops import costs

    monkeypatch.setattr(costs, "CPU_SEGMENT_MIN_EDGES", 1 << 62)
    jbatched._RUNNER_CACHE.clear()
    yield
    jbatched._RUNNER_CACHE.clear()


def test_maxsum_solve_many_matches_jax(jax_gather_lowering):
    params = {"damping": 0.5, "noise": 0.0}
    kw = dict(rounds=24, chunk_size=8, pad_policy=PAD, seed=3)
    want = jax_solve_many([ring(jdcop, n) for n in SIZES], "maxsum",
                          params, **kw)
    got = solve_many([ring(tdcop, n) for n in SIZES], "maxsum", params,
                     device="cpu", **kw)
    for g, w in zip(got, want):
        assert g["assignment"] == w["assignment"]
        assert g["final_assignment"] == w["final_assignment"]
        assert g["cost"] == pytest.approx(w["cost"], rel=1e-6)
        assert g["msg_count"] == w["msg_count"]
        assert g["instances_batched"] == w["instances_batched"]
    assert [g["instances_batched"] for g in got] == [3, 3, 3, 1]


@pytest.mark.parametrize("algo,params,restarts", [
    ("maxsum", {"noise": 0.01}, 1), ("maxsum", {"damping": 0.3}, 2),
    ("mgm", {}, 1), ("mgm", {}, 3), ("dba", {}, 1), ("gdba", {}, 2),
])
def test_deterministic_instances_equal_sequential_solves(algo, params,
                                                         restarts):
    dcops = [ring(tdcop, n, seed=1) for n in SIZES]
    seeds = [4, 5, 6, 7]
    kw = dict(rounds=16, chunk_size=8, pad_policy=PAD, n_restarts=restarts,
              device="cpu")
    many = solve_many(dcops, algo, params, seed=seeds, **kw)
    for i, dcop in enumerate(dcops):
        _same_result(many[i], solve(dcop, algo, params, seed=seeds[i], **kw))
    assert [r["instances_batched"] for r in many] == [3, 3, 3, 1]
    if restarts > 1:
        assert all(len(r["restart_costs"]) == restarts for r in many)


def _group(algo, user, n_restarts, params_list=None):
    """(module, stacked, run problem, group params, state) of the three
    16-variable rings, as run_many_batched builds them."""
    mod = load_algorithm_module(algo)
    probs = [tcompile.compile_dcop(ring(tdcop, n), pad_policy=PAD,
                                   device="cpu") for n in SIZES[:3]]
    [stacked] = tcompile.stack_problems(probs)
    plist = params_list or [user] * 3
    plist = [prepare_algo_params(p, mod.algo_params) for p in plist]
    inst = getattr(mod, "INSTANCE_AXIS", False)
    run = stacked if inst else tcompile.union_problem(stacked)
    gp = batched._group_params(mod, plist, run, 3, inst)
    states = [mod.init_state(p, 2, q, (n_restarts,))
              for p, q in zip(probs, plist)]
    return mod, stacked, run, gp, plist, states


@pytest.mark.parametrize("n_restarts", [1, 2])
def test_dsa_union_apply_equals_each_instance(n_restarts):
    """DSA on the group's disjoint union, per-instance probabilities
    (0.3, 0.6, 0.9) as one per-variable tensor: four rounds of ``apply``
    on the union's draws equal each instance's rounds on its slice."""
    plist = [{"variant": "B", "probability": p} for p in (0.3, 0.6, 0.9)]
    mod, stacked, union, gp, plist, states = _group("dsa", None, n_restarts,
                                                    plist)
    n, I, R = stacked.n_vars, 3, n_restarts
    su = {"values": torch.stack([s["values"] for s in states], -1)
          .reshape(R, n * I)}
    gen = torch.Generator().manual_seed(9)
    for _ in range(4):
        drawn = mod.draws(union, gp, gen, (R,))
        su = mod.apply(union, su, gp, drawn)
        for i in range(I):
            mine = {k: v.unflatten(1, (n, I)).select(2, i)
                    for k, v in drawn.items()}
            states[i] = mod.apply(stacked.host_problems[i], states[i],
                                  plist[i], mine)
    want = torch.stack([s["values"] for s in states], -1).reshape(R, n * I)
    assert torch.equal(su["values"], want)


def test_amaxsum_stacked_apply_equals_each_instance():
    """A-Max-Sum on the stacked problem (state [I, R, ...]), per-instance
    activation and damping: four rounds of ``apply`` on the group's
    draws equal each instance's rounds on its slice, bit for bit."""
    plist = [{"activation": a, "damping": d}
             for a, d in ((0.3, 0.5), (0.7, 0.4), (0.5, 0.9))]
    mod, stacked, _, gp, plist, states = _group("amaxsum", None, 2, plist)
    st = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    gen = torch.Generator().manual_seed(9)
    for _ in range(4):
        drawn = mod.draws(stacked, gp, gen, (3, 2))
        st = mod.apply(stacked, st, gp, drawn)
        states = [
            mod.apply(stacked.host_problems[i], s, plist[i],
                      {k: v[i] for k, v in drawn.items()})
            for i, s in enumerate(states)
        ]
    for k in ("q", "r", "values"):
        assert torch.equal(st[k], torch.stack([s[k] for s in states])), k


def test_maxsum_per_instance_damping_shares_a_group():
    """Numeric params differ per instance inside one group (Max-Sum
    damping, on the kernels' per-instance damping): each instance equals
    its sequential solve; a str param splits the group."""
    dcops = [ring(tdcop, n, seed=2) for n in SIZES[:3]]
    plist = [{"damping": x, "noise": 0.0} for x in (0.3, 0.5, 0.7)]
    kw = dict(rounds=12, chunk_size=4, pad_policy=PAD, device="cpu")
    many = solve_many(dcops, "maxsum", plist, **kw)
    assert [r["instances_batched"] for r in many] == [3, 3, 3]
    for r, d, p in zip(many, dcops, plist):
        _same_result(r, solve(d, "maxsum", p, **kw))
    split = solve_many(
        dcops, "dsa",
        [{"variant": "A"}, {"variant": "B"}, {"variant": "B"}], **kw,
    )
    assert [r["instances_batched"] for r in split] == [1, 2, 2]


@pytest.mark.parametrize("pad", ["none", "pow2"])
def test_dpop_solve_many_matches_jax(pad):
    params = {"util_device": "always"}
    want = jax_solve_many(
        [random_tree(jdcop, 9, 3, s, extra_edges=2) for s in (0, 1, 2)],
        "dpop", params, pad_policy=pad,
    )
    got = solve_many(
        [random_tree(tdcop, 9, 3, s, extra_edges=2) for s in (0, 1, 2)],
        "dpop", params, pad_policy=pad, device="cpu",
    )
    for g, w in zip(got, want):
        for k in STATS:
            assert g[k] == w[k], (k, g[k], w[k])
        assert g["instances_batched"] == w["instances_batched"] == 3


def test_solve_takes_compile_cache_none_only():
    """``api.solve`` takes the JAX package's ``compile_cache`` keyword
    and refuses anything but None, as ``solve_many`` does."""
    got = solve(ring(tdcop, 5), "mgm", rounds=8, compile_cache=None,
                device="cpu")
    assert got["status"] == "finished"
    with pytest.raises(NotImplementedError, match="compile_cache"):
        solve(ring(tdcop, 5), "mgm", compile_cache="cache", device="cpu")


def test_unported_options_raise():
    dcops = [ring(tdcop, 5)]
    with pytest.raises(NotImplementedError, match="compile_cache"):
        solve_many(dcops, "mgm", compile_cache="cache", device="cpu")
    # device chaos is ported: a width cap of 1 splits the pair into
    # single instances, each equal to the fault-free group's
    pair = [ring(tdcop, 5), ring(tdcop, 6)]
    split = solve_many(pair, "mgm", pad_policy=PAD, chaos="device_oom=1",
                       device="cpu")
    for g, w in zip(split, solve_many(pair, "mgm", pad_policy=PAD,
                                      device="cpu")):
        _same_result(g, w)
        assert g["chaos"] == {"spec": "device_oom=1", "seed": 0}
    assert split[0]["telemetry"]["counters"]["engine.oom_splits"] == 1
    with pytest.raises(ValueError, match="syncbb"):
        solve_many(dcops, "syncbb", n_restarts=2, device="cpu")
    # SyncBB has no merged sweep: its instances solve one by one
    one = solve_many(dcops, "syncbb", device="cpu")[0]
    assert one["instances_batched"] == 1 and one["status"] == "finished"
    with pytest.raises(ValueError, match="n_restarts"):
        solve_many(dcops, "dpop", n_restarts=2, device="cpu")
    assert solve_many([], "mgm", device="cpu") == []


def test_solve_many_and_restarts_cli(tmp_path):
    """``solve --many`` prints one result per file, as ``solve_many``
    returns them (without ``cost_trace``); ``solve --restarts`` runs
    Max-Sum's restarts."""
    paths = []
    for n in SIZES[:2]:
        p = tmp_path / f"ring{n}.yaml"
        p.write_text(dcop_yaml(ring(tdcop, n)))
        paths.append(str(p))
    base = [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "mgm",
            "--rounds", "8", "--device", "cpu", "--pad_policy", PAD]
    out = subprocess.run(base + ["--many"] + paths, capture_output=True,
                         text=True, check=True, cwd=REPO, timeout=120)
    got = json.loads(out.stdout)
    want = solve_many(paths, "mgm", rounds=8, pad_policy=PAD, device="cpu")
    for g, w in zip(got, want):
        w.pop("cost_trace")
        _same_result(g, w)
    out = subprocess.run(
        base[:4] + ["-a", "maxsum", "--rounds", "8", "--device", "cpu",
                    "--restarts", "3", paths[0]],
        capture_output=True, text=True, check=True, cwd=REPO, timeout=120,
    )
    assert len(json.loads(out.stdout)["restart_costs"]) == 3
