"""Sharded runs of the port (``pydcop_tpu_torch.parallel``) against the
JAX package's sharded path, on the CPU.

The JAX package shards over the conftest's 8 virtual CPU devices; the
port's CPU mesh is 8 shards on the CPU (``make_mesh(8, device="cpu")``),
one thread each.  The shard-major compile is held leaf for leaf; one
sharded step of each batched algorithm is held against the JAX step run
under ``shard_map`` from one numpy state and the JAX step's own draws
(the factor messages and values bit-equal, q within 1e-6, where the JAX
belief sums with ``segment_sum`` + ``psum``); whole meshed runs are held
bit for bit against the unmeshed run of the same ``n_shards`` problem in
the port (the mesh adds the shards' partial sums in the order the
unmeshed problem adds its segments).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pydcop_tpu.algorithms import load_algorithm_module as jax_algo  # noqa: E402
from pydcop_tpu.algorithms import prepare_algo_params as jax_params  # noqa: E402
from pydcop_tpu.ops import compile as jcompile  # noqa: E402
from pydcop_tpu.parallel import mesh as jmesh  # noqa: E402

import pydcop_tpu.dcop as jdcop  # noqa: E402
import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
from pydcop_tpu_torch import interop  # noqa: E402
from pydcop_tpu_torch.algorithms import load_algorithm_module  # noqa: E402
from pydcop_tpu_torch.algorithms import prepare_algo_params  # noqa: E402
from pydcop_tpu_torch.engine.batched import (  # noqa: E402
    ShardedRounds,
    run_batched,
    run_many_batched,
)
from pydcop_tpu_torch.engine.dynamic import run_dynamic  # noqa: E402
from pydcop_tpu_torch.ops import compile as tcompile  # noqa: E402
from pydcop_tpu_torch.ops.costs import total_cost  # noqa: E402
from pydcop_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    make_mesh,
    shard_problem,
)
from test_torch_compile import _coloring, assert_same_problem  # noqa: E402
from test_torch_incremental import sensor_dcop  # noqa: E402
from test_torch_local_search import _jax_draws  # noqa: E402

CPU = "cpu"
ALGOS = ["maxsum", "amaxsum", "dsa", "adsa", "dsatuto", "mgm", "mgm2",
         "dba", "gdba"]


def coloring_ring(m, n=24, colors=3, with_ternary=False, weight=0.5):
    """The JAX sharded tests' ring (with a ternary every fifth
    variable, ``weight`` times the sum of its values), built with
    package ``m``'s objects."""
    d = m.Domain("colors", "", list(range(colors)))
    dcop = m.DCOP(f"ring{n}")
    vs = [m.Variable(f"v{i}", d) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(n):
        j = (i + 1) % n
        dcop.add_constraint(
            m.constraint_from_str(f"c{i}", f"1 if v{i} == v{j} else 0", vs)
        )
    if with_ternary:
        for i in range(0, n - 2, 5):
            dcop.add_constraint(m.constraint_from_str(
                f"t{i}", f"{weight} * (v{i} + v{i+1} + v{i+2})", vs))
    return dcop


def ring(n_shards, n=24, with_ternary=True, **kw):
    return tcompile.compile_dcop(
        coloring_ring(tdcop, n, with_ternary=with_ternary),
        n_shards=n_shards, device=CPU, **kw)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, device=CPU)


def _same_runs(a, b):
    assert a.assignment == b.assignment
    assert a.best_assignment == b.best_assignment
    assert (a.cost, a.best_cost, a.cycles, a.messages, a.status) == (
        b.cost, b.best_cost, b.cycles, b.messages, b.status)
    np.testing.assert_array_equal(a.cost_trace, b.cost_trace)


# -- the shard-major compile ------------------------------------------------


@pytest.mark.parametrize("n_shards,pad", [(2, "none"), (8, "none"),
                                          (8, "pow2")])
def test_compile_dcop_shard_major_equals_jax(n_shards, pad):
    assert_same_problem(
        tcompile.compile_dcop(coloring_ring(tdcop, 10, with_ternary=True),
                              n_shards=n_shards, pad_policy=pad, device=CPU),
        jcompile.compile_dcop(coloring_ring(jdcop, 10, with_ternary=True),
                              n_shards=n_shards, pad_policy=pad),
    )


@pytest.mark.parametrize("shared,pad", [(True, "none"), (False, "none"),
                                        (True, "pow2")])
def test_compile_from_arrays_shard_major_equals_jax(shared, pad):
    scopes, table, unary = _coloring(shared=shared, n=50)
    kw = dict(unary=unary, n_shards=4, pad_policy=pad)
    assert_same_problem(
        tcompile.compile_from_arrays(scopes, table, 3, device=CPU, **kw),
        jcompile.compile_from_arrays(scopes, table, 3, **kw),
    )


def test_shard_major_layout_keeps_every_cost():
    """Ghosts and the reordering change no cost (the JAX package's
    cost-parity check, at 1e-6 relative)."""
    p1, p8 = ring(1, 10), ring(8, 10)
    assert p8.n_edges % 8 == 0 and p8.n_cons % 8 == 0
    assert all(b.tables.shape[0] % 8 == 0 for b in p8.buckets.values())
    rng = np.random.default_rng(0)
    for _ in range(10):
        a = {f"v{i}": int(rng.integers(3)) for i in range(10)}
        c1 = float(total_cost(p1, tcompile.encode_assignment(p1, a)))
        c8 = float(total_cost(p8, tcompile.encode_assignment(p8, a)))
        assert c8 == pytest.approx(c1, rel=1e-6)


def test_ghost_edges_excluded_from_message_count():
    p1, p8 = ring(1, 10, with_ternary=False), ring(8, 10, with_ternary=False)
    assert p8.n_edges > p1.n_edges  # padding added ghost edges
    mod = load_algorithm_module("maxsum")
    assert mod.messages_per_round(p1) == mod.messages_per_round(p8) == 40
    # nor in the names a result is keyed by
    assert not any(n.startswith("__") for n in p8.var_names)


def test_a_sharded_group_still_stacks():
    groups = tcompile.stack_problems([ring(4), ring(4), ring(2)])
    assert [g.n_instances for g in groups] == [2, 1]
    assert groups[0].n_shards == 4
    union = tcompile.union_problem(groups[0])
    assert union.n_shards == 4


# -- the mesh ---------------------------------------------------------------


def test_shard_problem_mismatch_and_bad_meshes_raise(mesh8):
    p = ring(2, 6, with_ternary=False)
    with pytest.raises(ValueError, match="recompile"):
        shard_problem(p, mesh8)
    with pytest.raises(TypeError, match="Mesh"):
        shard_problem(p, object())
    with pytest.raises(ValueError, match="CUDA device"):
        Mesh([torch.device("cuda", 0)] * 2) if not torch.cuda.is_available() \
            else Mesh([torch.device("cuda", 99)])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match=r"Mesh\(\[torch.device"):
            make_mesh(2)
    assert make_mesh(3, device=CPU).devices == (torch.device(CPU),) * 3


def test_views_split_the_arrays(mesh8):
    from pydcop_tpu_torch.parallel import SHARD_AXIS, P, problem_pspecs

    p = ring(8)
    specs = problem_pspecs(p)  # the JAX package's placement
    assert specs["edge_var"] == specs["con_scopes"][:1] == P(SHARD_AXIS)
    assert specs["unary"] == specs["tables_flat"] == P()
    assert specs["buckets"][3]["tables_t"] == P(None, None, None, SHARD_AXIS)
    sp = shard_problem(p, mesh8)
    E_s = p.n_edges // 8
    for s, v in enumerate(sp.views):
        assert torch.equal(v.edge_var, p.edge_var[s * E_s:(s + 1) * E_s])
        assert torch.equal(v.tables_flat, p.tables_flat)
        for k, b in v.buckets.items():
            m = p.buckets[k].n_cons // 8
            assert torch.equal(b.tables_t,
                               p.buckets[k].tables_t[..., s * m:(s + 1) * m])
        # the local slot table lists exactly the shard's edges
        ve = v.var_edges
        local = sorted(int(e) for e in ve[ve < E_s])
        assert local == list(range(E_s))


def test_psum_adds_in_shard_order():
    mesh = make_mesh(4, device=CPU)
    parts = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8]),
             torch.tensor([1.0])]
    out = mesh.run(lambda i, ax: ax.psum(parts[i]))
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(torch.equal(o, want) for o in out)
    assert mesh.run(lambda i, ax: (ax.index, ax.size)) == [
        (i, 4) for i in range(4)]


def test_a_shard_that_raises_ends_the_run_with_its_error():
    """The failing shard breaks the barrier: the others stop at once,
    well inside the barrier's timeout, and the caller gets the error."""
    mesh = Mesh([CPU] * 4, barrier_timeout=30.0)

    def fn(i, ax):
        if i == 2:
            raise KeyError("shard two")
        return ax.psum(torch.ones(3))

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="shard two"):
        mesh.run(fn)
    assert time.perf_counter() - t0 < 5.0
    # the mesh is usable again
    assert mesh.run(lambda i, ax: int(ax.psum(torch.ones(1)))) == [4] * 4


def test_a_shard_missing_a_collective_times_out():
    mesh = Mesh([CPU] * 3, barrier_timeout=0.3)
    with pytest.raises(TimeoutError):
        mesh.run(lambda i, ax: None if i == 0 else ax.psum(torch.ones(1)))
    assert threading.active_count() < 100


def test_a_failing_shard_fails_run_batched(mesh8):
    """A step that raises on one shard ends the run with its error."""
    mod = load_algorithm_module("maxsum")

    class Broken:
        __name__ = "broken"
        algo_params = mod.algo_params
        init_state = staticmethod(mod.init_state)
        state_specs = staticmethod(mod.state_specs)
        messages_per_round = staticmethod(mod.messages_per_round)

        @staticmethod
        def step(problem, state, params, gen=None, axis=None):
            if axis.index == 5:
                raise ArithmeticError("shard five failed")
            return mod.step(problem, state, params, gen, axis=axis)

    prm = prepare_algo_params({}, mod.algo_params)
    with pytest.raises(ArithmeticError, match="shard five"):
        run_batched(ring(8), Broken, prm, rounds=4, mesh=mesh8)


# -- one sharded step against the JAX shard_map step -----------------------


def _jax_sharded_step(algo, ref, js, key, jp):
    from jax.sharding import PartitionSpec as JP

    jm = jmesh.make_mesh(8)
    sref = jmesh.shard_problem(ref, jm)
    jmod = jax_algo(algo)
    declared = jmesh.state_pspecs(jmod, sref)
    sspecs = {k: declared.get(k, JP()) for k in js}
    fn = jmesh.shard_map(
        lambda p, s, k: jmod.step(p, s, k, jp, axis_name=jmesh.SHARD_AXIS),
        mesh=jm,
        in_specs=(jmesh.problem_pspecs(sref), sspecs, JP()),
        out_specs=sspecs,
        check_vma=False,
    )
    return jax.jit(fn)(sref, js, key)


def _sharded_draws(algo, key, ref):
    """The draws of the JAX step under ``shard_map`` as one whole-problem
    draw: per-variable draws are the unsharded ones (the key arrives
    replicated); A-Max-Sum folds the shard index into its fire keys and
    draws ``[1, E_local]`` per shard, concatenated here in shard order."""
    if algo != "amaxsum":
        return _jax_draws(algo, key, ref)
    _, k_q, k_r = jax.random.split(key, 3)
    e_local = ref.n_edges // 8
    out = {}
    for name, k in (("fire_q", k_q), ("fire_r", k_r)):
        out[name] = torch.from_numpy(np.concatenate([
            np.asarray(jax.random.uniform(jax.random.fold_in(k, s),
                                          (1, e_local)))
            for s in range(8)
        ], axis=1))
    return out


def _start(algo, ref, port, jp, tp):
    rng = np.random.default_rng(3)
    jmod, tmod = jax_algo(algo), load_algorithm_module(algo)
    js = jmod.init_state(ref, jax.random.PRNGKey(0), jp)
    ts = tmod.init_state(port, 0, tp)
    n = ref.n_vars
    common = {"values": rng.integers(0, 3, size=n).astype(np.int32)}
    if "q" in ts:
        d, e = ref.d_max, ref.n_edges
        common.update(
            q=rng.random((d, e)).astype(np.float32),
            r=np.zeros((d, e), np.float32),
            noise=(0.001 * rng.random((d, n))).astype(np.float32),
        )
    if "weights" in ts:
        common["weights"] = (1 + rng.integers(0, 3, size=ref.n_cons)).astype(
            np.float32)
    js = {**js, **{k: jnp.asarray(v) for k, v in common.items()}}
    ts = {**ts, **interop.state_from_arrays(common, CPU)}
    return js, ts


@pytest.fixture(scope="module")
def rings():
    jd = coloring_ring(jdcop, 24, with_ternary=True)
    td = coloring_ring(tdcop, 24, with_ternary=True)
    return (jcompile.compile_dcop(jd, n_shards=8),
            tcompile.compile_dcop(td, n_shards=8, device=CPU))


@pytest.mark.parametrize("algo", ALGOS)
def test_one_sharded_step_matches_jax_shard_map(algo, rings, mesh8):
    ref, port = rings
    params = {"activation": 0.6} if algo == "amaxsum" else {}
    jp = jax_params(params, jax_algo(algo).algo_params)
    tmod = load_algorithm_module(algo)
    tp = prepare_algo_params(params, tmod.algo_params)
    js, ts = _start(algo, ref, port, jp, tp)
    key = jax.random.PRNGKey(11)
    want = _jax_sharded_step(algo, ref, js, key, jp)

    loop = ShardedRounds(shard_problem(port, mesh8), port, tmod, tp, 0,
                         total_cost)
    drawn = _sharded_draws(algo, key, ref) if hasattr(tmod, "draws") \
        and algo not in ("dba", "gdba", "mgm") else None
    got = loop.whole(loop.apply(loop.place(ts), drawn), CPU)
    assert loop.rounds == 1 and loop.step_psums >= 1
    for k in want:
        w, g = np.asarray(want[k]), interop.to_numpy(got[k])
        if k == "q":  # through the belief: psum order differs
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        else:  # r (the factor phase), values, weights: bit for bit
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_maxsum_sharded_step_is_one_psum(mesh8):
    mod = load_algorithm_module("maxsum")
    p = ring(8)
    prm = prepare_algo_params({}, mod.algo_params)
    loop = ShardedRounds(shard_problem(p, mesh8), p, mod, prm, 0,
                         total_cost)
    parts = loop.place(mod.init_state(p, 0, prm))
    for _ in range(3):
        parts = loop.step(parts, None)
    assert (loop.rounds, loop.step_psums) == (3, 3)
    # and a whole run: one psum a round plus one a cost sample
    mesh = make_mesh(8, device=CPU)
    r = run_batched(p, mod, prm, rounds=12, chunk_size=6, cost_every=4,
                    mesh=mesh)
    assert mesh.psums == 12 + len(r.cost_trace)


# -- whole runs -------------------------------------------------------------


@pytest.mark.parametrize("algo", ALGOS)
def test_meshed_run_equals_unmeshed_run(algo, mesh8):
    """Same ``n_shards = 8`` problem, same seed: the run over the CPU
    mesh equals the unmeshed run in every result and state leaf."""
    mod = load_algorithm_module(algo)
    prm = prepare_algo_params({}, mod.algo_params)
    p = ring(8)
    kw = dict(rounds=12, seed=5, chunk_size=4, cost_every=2,
              return_state=True)
    one = run_batched(p, mod, prm, **kw)
    meshed = run_batched(p, mod, prm, mesh=mesh8, **kw)
    _same_runs(meshed, one)
    assert set(meshed.state) == set(one.state)
    for k in one.state:
        assert torch.equal(meshed.state[k], one.state[k]), k
    # against the one-shard compile: the same costs up to reassociation
    flat = run_batched(ring(1), mod, prm, **kw)
    if algo in ("maxsum", "mgm", "dba", "gdba"):  # draw nothing
        assert meshed.best_cost == pytest.approx(flat.best_cost, abs=1e-4)


def test_maxsum_solves_tree_exactly_under_a_mesh(mesh8):
    import itertools

    d = tdcop.Domain("d", "", [0, 1, 2])
    dcop = tdcop.DCOP("tree")
    vs = [tdcop.Variable(f"v{i}", d) for i in range(9)]
    for v in vs:
        dcop.add_variable(v)
    rng = np.random.RandomState(3)
    for i in range(1, 9):
        m = rng.uniform(0, 10, (3, 3)).round(1)
        dcop.add_constraint(tdcop.NAryMatrixRelation(
            [vs[(i - 1) // 2], vs[i]], m, name=f"c{i}"))
    opt = min(
        dcop.solution_cost(dict(zip([v.name for v in vs], combo)))
        for combo in itertools.product(range(3), repeat=9)
    )
    mod = load_algorithm_module("maxsum")
    prm = prepare_algo_params({"damping": 0.0}, mod.algo_params)
    r = run_batched(tcompile.compile_dcop(dcop, n_shards=8, device=CPU), mod,
                    prm, rounds=30, seed=0, mesh=mesh8)
    assert r.best_cost == pytest.approx(opt, rel=1e-5)


@pytest.mark.parametrize("algo", ["dsa", "maxsum"])
def test_restarts_compose_with_mesh(algo, mesh8):
    mod = load_algorithm_module(algo)
    prm = prepare_algo_params(
        {"variant": "B"} if algo == "dsa" else {"damping": 0.5},
        mod.algo_params)
    kw = dict(rounds=12, seed=7, chunk_size=6, n_restarts=4,
              return_state=True)
    meshed = run_batched(ring(8), mod, prm, mesh=mesh8, **kw)
    one = run_batched(ring(8), mod, prm, **kw)
    _same_runs(meshed, one)
    np.testing.assert_array_equal(meshed.restart_costs, one.restart_costs)
    for k in one.state:
        assert torch.equal(meshed.state[k], one.state[k]), k
    assert meshed.state["values"].shape == (4, 24)
    flat = run_batched(ring(1), mod, prm, **kw)  # the JAX test's check
    np.testing.assert_allclose(meshed.restart_costs, flat.restart_costs,
                               atol=1e-4)


def test_checkpoint_resume_under_mesh(tmp_path, mesh8):
    """Interrupted at its midpoint and resumed under the same mesh, a
    sharded run lands on the uninterrupted run; the file holds the
    state in its global layout, with ``n_shards`` in the meta."""
    from pydcop_tpu_torch.engine.checkpoint import checkpoint_meta

    p = ring(8)
    mod = load_algorithm_module("maxsum")
    prm = prepare_algo_params({"damping": 0.5}, mod.algo_params)
    ck = str(tmp_path / "mesh.npz")
    kw = dict(seed=3, mesh=mesh8, chunk_size=4)
    full = run_batched(p, mod, prm, rounds=16, **kw)
    run_batched(p, mod, prm, rounds=8, checkpoint_path=ck, **kw)
    assert checkpoint_meta(ck)["n_shards"] == 8
    with np.load(ck) as data:
        assert data["state/q"].shape == (3, p.n_edges)
    resumed = run_batched(p, mod, prm, rounds=16, checkpoint_path=ck,
                          resume=True, **kw)
    _same_runs(resumed, full)
    # an unmeshed run of the same problem resumes the file too
    _same_runs(run_batched(p, mod, prm, rounds=16, seed=3, chunk_size=4,
                           checkpoint_path=ck, resume=True), full)


def test_constraint_free_problem_shards(mesh8):
    d = tdcop.Domain("colors", "", [0, 1, 2])
    dcop = tdcop.DCOP("frozen_ring")
    vs = []
    for i in range(8):
        v = (tdcop.ExternalVariable(f"v{i}", d, 0) if i % 2
             else tdcop.Variable(f"v{i}", d))
        vs.append(v)
        dcop.add_variable(v)
    for i in range(8):
        dcop.add_constraint(tdcop.constraint_from_str(
            f"c{i}", f"1 if v{i} == v{(i + 1) % 8} else 0", vs))
    problem = tcompile.compile_dcop(dcop, n_shards=8, device=CPU)
    assert problem.n_real_edges == 0 and problem.n_cons == 8  # ghosts
    for algo in ("maxsum", "dsa"):
        mod = load_algorithm_module(algo)
        prm = prepare_algo_params({}, mod.algo_params)
        r = run_batched(problem, mod, prm, rounds=4, seed=0, mesh=mesh8,
                        chunk_size=4)
        assert r.cycles == 4 and r.cost == 0.0
    assert load_algorithm_module("maxsum").messages_per_round(problem) == 0


@pytest.mark.parametrize("algo", ["maxsum", "dsa", "dba"])
def test_run_many_batched_under_a_mesh(algo):
    """The instance axis batched, the shards on the mesh: each instance
    equals the unmeshed group's, and (deterministic algorithms) its own
    sharded solve."""
    mesh = make_mesh(4, device=CPU)
    probs = [
        tcompile.compile_dcop(coloring_ring(tdcop, 24, with_ternary=True,
                                            weight=w), n_shards=4, device=CPU)
        for w in (0.5, 0.7)
    ]
    mod = load_algorithm_module(algo)
    prm = prepare_algo_params({}, mod.algo_params)
    kw = dict(rounds=12, seeds=[1, 2], chunk_size=4, n_restarts=2)
    group = tcompile.stack_problems(probs)
    assert len(group) == 1
    meshed = run_many_batched(group[0], mod, prm, mesh=mesh, **kw)
    plain = run_many_batched(group[0], mod, prm, **kw)
    for a, b in zip(meshed, plain):
        _same_runs(a, b)
    if algo != "dsa":
        for r, p, seed in zip(meshed, probs, (1, 2)):
            _same_runs(r, run_batched(p, mod, prm, rounds=12, seed=seed,
                                      chunk_size=4, n_restarts=2))
    with pytest.raises(ValueError, match="recompile"):
        run_many_batched(group[0], mod, prm, mesh=make_mesh(2, device=CPU),
                         **kw)


def test_run_dynamic_under_a_mesh():
    """Every segment recompiles sharded and runs over the mesh: equal to
    the unmeshed sharded run in every key but the times."""
    from test_torch_dynamic import EXACT_KEYS, sensor_scenario

    mesh = make_mesh(2, device=CPU)
    kw = dict(distribution="adhoc", k_target=1, rounds_per_second=40.0,
              final_rounds=16, seed=2, chunk_size=8, n_shards=2, device=CPU)
    got = run_dynamic(sensor_dcop(tdcop), "maxsum", {"damping": 0.5},
                      scenario=sensor_scenario(tdcop), mesh=mesh, **kw)
    want = run_dynamic(sensor_dcop(tdcop), "maxsum", {"damping": 0.5},
                       scenario=sensor_scenario(tdcop), **kw)
    for k in EXACT_KEYS:
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["cost_trace"], want["cost_trace"])
    assert got["state_transfers"] >= 1
    assert mesh.psums > 0


@pytest.mark.parametrize("failure,counter", [
    ("CUDA out of memory. Tried to allocate 2.00 GiB", "oom_chunk_halvings"),
    ("UNAVAILABLE: link blipped", "retries"),
])
def test_supervisor_recovers_a_sharded_chunk(failure, counter, mesh8):
    """One shard fails once inside a chunk: the supervisor halves the
    chunk (OOM) or retries it (transient) from the chunk's generator
    state, the failed chunk's shard tensors are released, and the run
    equals the undisturbed meshed run."""
    import weakref

    from pydcop_tpu_torch.engine.supervisor import (
        make_supervisor,
        supervision,
    )
    from pydcop_tpu_torch.telemetry import session

    dsa = load_algorithm_module("dsa")
    held = []

    class Flaky:
        __name__ = "flaky_dsa"
        algo_params = dsa.algo_params
        init_state = staticmethod(dsa.init_state)
        draws = staticmethod(dsa.draws)
        messages_per_round = staticmethod(dsa.messages_per_round)

        @staticmethod
        def apply(problem, state, params, drawn, axis=None):
            out = dsa.apply(problem, state, params, drawn, axis=axis)
            if axis.index == 3 and not held:
                big = torch.zeros(1000)
                held.append(weakref.ref(big))
                raise RuntimeError(failure)
            return out

    prm = prepare_algo_params({"variant": "B"}, dsa.algo_params)
    kw = dict(rounds=12, seed=3, chunk_size=12, mesh=mesh8)
    base = run_batched(ring(8), dsa, prm, **kw)
    with supervision(make_supervisor(chunk_floor=4)), session() as tel:
        got = run_batched(ring(8), Flaky, prm, **kw)
    _same_runs(got, base)
    assert tel.summary()["counters"][f"engine.{counter}"] == 1
    assert held and held[0]() is None  # the failed shard's tensor is gone


def test_psum_under_thread_pressure():
    """More shards than cores, the interpreter switching threads as
    often as it can: every psum of many is the shard-order sum, on every
    shard."""
    import sys

    mesh = Mesh([CPU] * 16, barrier_timeout=30.0)
    vals = torch.rand(16, 50, 7, generator=torch.Generator().manual_seed(0))
    want = vals[0]
    for s in range(1, 16):
        want = want + vals[s]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = mesh.run(lambda i, ax: [ax.psum(vals[i, j]) for j in range(50)])
    finally:
        sys.setswitchinterval(old)
    for got in out:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
