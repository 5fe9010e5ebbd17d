"""The port's local-search family and A-Max-Sum against the JAX package's,
on the CPU.

Stochastic algorithms are held round by round: the JAX step runs with
key ``fold_in(PRNGKey(5), i)``, and the port's ``apply`` gets the draws
that step makes from that key, rebuilt here with ``jax.random`` (the
port does not replay jax's stream; see the registry's docstring).
Values (and A-Max-Sum's q and r) must be bit-equal every round.  The
deterministic algorithms (MGM lexic, DBA, GDBA) are held as whole runs
of both engines from the same numpy initial state.  The JAX package runs
with its per-slot gather aggregation (``jax_gather_lowering``), the one
the port uses, so f32 local costs are summed in one order.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pydcop_tpu.algorithms import load_algorithm_module as jax_algo  # noqa: E402
from pydcop_tpu.algorithms import prepare_algo_params as jax_params  # noqa: E402
from pydcop_tpu.engine.batched import run_batched as jax_run  # noqa: E402
from pydcop_tpu.ops import compile as jcompile  # noqa: E402

from pydcop_tpu_torch import interop  # noqa: E402
from pydcop_tpu_torch.algorithms import load_algorithm_module  # noqa: E402
from pydcop_tpu_torch.algorithms import prepare_algo_params  # noqa: E402
from pydcop_tpu_torch.engine.batched import run_batched  # noqa: E402
from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from pydcop_tpu_torch.ops.generate import coloring_arrays  # noqa: E402
from test_torch_maxsum import jax_gather_lowering  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = os.path.join(REPO, "examples", "graph_coloring_3.yaml")
ROUNDS = 16


def _mixed(n=200):
    """A binary (shared coloring table) + ternary (per-constraint random
    tables) instance, both packages."""
    scopes, table, unary = coloring_arrays(n, seed=1)
    rng = np.random.default_rng(11)
    s3 = np.stack([rng.choice(n, 3, replace=False) for _ in range(n // 2)])
    t3 = rng.random((len(s3), 3, 3, 3)).astype(np.float32)
    args = ([scopes, s3], [table, t3], 3)
    return (
        jcompile.compile_from_arrays(*args, unary=unary),
        tcompile.compile_from_arrays(*args, unary=unary, device="cpu"),
    )


@pytest.fixture(scope="module")
def problems():
    return _mixed()


@pytest.fixture(scope="module")
def binary():
    """The shared-table coloring alone (A-Max-Sum's instance: the JAX
    package compiles its generic binary factor path faster)."""
    s, t, u = coloring_arrays(200, seed=1)
    return (
        jcompile.compile_from_arrays(s, t, 3, unary=u),
        tcompile.compile_from_arrays(s, t, 3, unary=u, device="cpu"),
    )


def _jax_draws(algo, key, ref):
    """The draws the JAX ``step`` makes from ``key``, as numpy."""
    n, d, split = ref.n_vars, ref.d_max, jax.random.split
    u = jax.random.uniform
    if algo == "dsa":
        k_tie, k_move = split(key)
        out = {"tie": u(k_tie, (n, d)), "move": u(k_move, (n,))}
    elif algo == "adsa":
        k_wake, k_tie, k_move = split(key, 3)
        out = {"wake": u(k_wake, (n,)), "tie": u(k_tie, (n, d)),
               "move": u(k_move, (n,))}
    elif algo == "dsatuto":
        out = {"move": u(key, (n,))}
    elif algo == "mgm":
        out = {"prio": u(key, (n,))}
    elif algo == "mgm2":
        k_role, k_partner = split(key)
        degree = jnp.sum(ref.neighbor_mask, axis=1)
        out = {"role": u(k_role, (n,)),
               "partner": jax.random.randint(
                   k_partner, (n,), 0, jnp.maximum(degree, 1))}
    else:  # amaxsum
        _, k_q, k_r = split(key, 3)
        out = {"fire_q": u(k_q, (1, ref.n_edges)),
               "fire_r": u(k_r, (1, ref.n_edges))}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return interop.to_numpy(x)
    return np.asarray(x)


def _start_state(algo, ref, port, params):
    """(JAX state, port state) from one numpy state."""
    rng = np.random.default_rng(3)
    n = ref.n_vars
    if algo == "amaxsum":
        d, e = ref.d_max, ref.n_edges
        st = {
            "q": rng.random((d, e)).astype(np.float32),
            "r": np.zeros((d, e), np.float32),
            "values": np.zeros(n, np.int32),
            "noise": (0.001 * rng.random((d, n))).astype(np.float32),
        }
        return (
            {k: jnp.asarray(v) for k, v in st.items()},
            interop.state_from_arrays(st, "cpu"),
        )
    values = rng.integers(0, ref.d_max, size=n).astype(np.int32)
    js = jax_algo(algo).init_state(ref, jax.random.PRNGKey(0), params[0])
    js = {**js, "values": jnp.asarray(values)}
    ts = load_algorithm_module(algo).init_state(port, 0, params[1])
    ts = {**ts, "values": torch.from_numpy(values)}
    return js, ts


@pytest.mark.parametrize(
    "algo,params",
    [("dsa", {"variant": "A"}), ("dsa", {"variant": "B"}),
     ("dsa", {"variant": "C", "probability": 0.3}), ("adsa", {}),
     ("dsatuto", {}), ("mgm", {"break_mode": "random"}), ("mgm2", {}),
     ("amaxsum", {"activation": 0.6})],
)
def test_stochastic_round_by_round_matches_jax(
    algo, params, problems, binary, jax_gather_lowering
):
    ref, port = binary if algo == "amaxsum" else problems
    jmod, tmod = jax_algo(algo), load_algorithm_module(algo)
    jp = jax_params(params, jmod.algo_params)
    tp = prepare_algo_params(params, tmod.algo_params)
    js, ts = _start_state(algo, ref, port, (jp, tp))
    jstep = jax.jit(lambda s, k: jmod.step(ref, s, k, jp))
    moved = 0
    for i in range(ROUNDS):
        key = jax.random.fold_in(jax.random.PRNGKey(5), i)
        before = ts["values"]
        js = jstep(js, key)
        ts = tmod.apply(port, ts, tp, _jax_draws(algo, key, ref))
        moved += int((ts["values"] != before).sum())
        for leaf in ("q", "r", "values") if algo == "amaxsum" else ("values",):
            np.testing.assert_array_equal(
                _np(ts[leaf]), _np(js[leaf]), err_msg=f"{leaf}, round {i}"
            )
    assert moved > 0  # the trajectory is not a fixed point


def test_mgm2_pair_index_matches_jax(problems):
    from pydcop_tpu.algorithms import mgm2 as jmgm2

    from pydcop_tpu_torch.algorithms import mgm2 as tmgm2

    ref, port = problems
    for want, got in zip(jmgm2._pair_index(ref), tmgm2._pair_index(port)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert tmgm2._pair_index(port) is tmgm2._pair_index(port)  # cached


@pytest.mark.parametrize(
    "algo,params",
    [("mgm", {}), ("dba", {"increase": 2.0}), ("gdba", {}),
     ("gdba", {"modifier": "M", "violation": "NM", "increase_mode": "R"}),
     ("gdba", {"violation": "MX", "increase_mode": "C"}),
     ("gdba", {"increase_mode": "T"})],
)
def test_deterministic_whole_run_matches_jax(
    algo, params, problems, jax_gather_lowering
):
    ref, port = problems
    jmod, tmod = jax_algo(algo), load_algorithm_module(algo)
    jp = jax_params(params, jmod.algo_params)
    tp = prepare_algo_params(params, tmod.algo_params)
    st = {
        k: interop.to_numpy(v)
        for k, v in tmod.init_state(port, 3, tp).items()
    }
    kw = dict(rounds=24, chunk_size=8, cost_every=4, initial_state=st,
              return_state=True)
    rj = jax_run(ref, jmod, jp, **kw)
    rt = run_batched(port, tmod, tp, **kw)
    assert rt.best_assignment == rj.best_assignment
    assert rt.messages == rj.messages
    assert set(rt.state) == set(rj.state)
    for k in rj.state:
        np.testing.assert_array_equal(_np(rt.state[k]), rj.state[k])
    assert len(rt.cost_trace) == len(rj.cost_trace) == 6
    np.testing.assert_allclose(rt.cost_trace, rj.cost_trace, rtol=1e-5)
    if algo != "mgm":
        assert any(  # the breakout weights did grow
            not np.array_equal(rt.state[k], st[k]) for k in st
            if k != "values"
        )


def test_engine_draws_follow_the_seed(problems):
    _, port = problems
    mod = load_algorithm_module("dsa")
    params = prepare_algo_params({}, mod.algo_params)

    def run(seed):
        r = run_batched(port, mod, params, rounds=8, seed=seed,
                        return_state=True)
        return r.state["values"], r.cost_trace

    (v0, c0), (v0b, c0b), (v1, _) = run(0), run(0), run(1)
    assert torch.equal(v0, v0b) and np.array_equal(c0, c0b)
    assert not torch.equal(v0, v1)


def test_dsa_c_moves_at_its_probability():
    """Variant C is always eligible, and value 0 is every variable's worst
    value here, so a variable changes value iff its move draw fires."""
    n = 2000
    scopes = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    unary = np.zeros((n, 3), np.float32)
    unary[:, 0] = 1.0
    port = tcompile.compile_from_arrays(
        [scopes.astype(np.int32)], [np.zeros((3, 3), np.float32)], 3,
        unary=unary, device="cpu",
    )
    mod = load_algorithm_module("dsa")
    params = prepare_algo_params(
        {"variant": "C", "probability": 0.7, "initial": "declared"},
        mod.algo_params,
    )
    r = run_batched(port, mod, params, rounds=1, return_state=True)
    frac = float((r.state["values"] != 0).float().mean())
    assert abs(frac - 0.7) < 0.03, frac


@pytest.mark.parametrize(
    "algo",
    ["adsa", "amaxsum", "dba", "dsa", "dsatuto", "gdba", "maxsum", "mgm",
     "mgm2"],
)
def test_algo_params_equal_jax(algo):
    """Names, types, allowed values and defaults equal the JAX module's;
    the host-runtime ones (``island_*``) are kept, accepted and unused."""
    from pydcop_tpu_torch.algorithms import list_available_algorithms

    assert algo in list_available_algorithms()

    def spec(defs):
        return [
            (p.name, p.type, None if p.values is None else list(p.values),
             p.default)
            for p in defs
        ]

    assert spec(load_algorithm_module(algo).algo_params) == spec(
        jax_algo(algo).algo_params
    )


def test_cli_mgm_matches_jax_solve():
    from pydcop_tpu.api import solve as jax_solve

    want = jax_solve(RING, "mgm", {"initial": "declared"}, rounds=20)
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "mgm",
         "-p", "initial:declared", "--rounds", "20", "--device", "cpu",
         RING],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    for k in ("cost", "assignment", "cycle", "msg_count"):
        assert got[k] == want[k], k
    assert got["cycle"] == 20
