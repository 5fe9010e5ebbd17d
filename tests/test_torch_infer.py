"""The port's exact inference against the JAX package's.

The same instances, built once with each package's model objects (the
ring of ``examples/graph_coloring_3.yaml``, a 40-variable random
recursive 3-colouring tree as ``bench.py:_build_coloring_tree`` builds
its 10k one, a 4x4 grid of random tables under the ``min_fill`` order
and a 24-light tiled SECP), go through ``pydcop_tpu.api.infer`` and
``pydcop_tpu_torch.api.infer``:

- at ``device="never"`` (pure host f64 on both sides) every query's
  result is bit-equal, key for key, but ``time`` and ``telemetry``;
- at ``device="always"`` (the port's contractions on the CPU) ``map``
  and ``kbest`` are equal, ``log_z`` is within the sum of both
  ``error_bound``s and the sweep counts are equal;
- each semiring's ``contraction_kernel`` against the JAX package's on
  random parts holding ``±inf`` cells: arg-reduces, margins, kbest
  values, own indices and provenance bit-equal (NaN by position),
  logsumexp and expectation within rtol 1e-6.

Also here: the device path's marginals and ``e_cost`` against the
port's host f64 within its ``error_bound``, ``infer_many`` against
sequential ``infer``, the CLI against the JAX CLI, the did-you-mean
message, the OOM ladder and the knobs that are not ported.
"""

import functools
import json
import os
from argparse import Namespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pydcop_tpu.api as japi  # noqa: E402
import pydcop_tpu.dcop as jdcop  # noqa: E402
import pydcop_tpu.ops.semiring as jsr  # noqa: E402
from pydcop_tpu.commands.generators import secp as jsecp  # noqa: E402
from pydcop_tpu.dcop.yamldcop import load_dcop_from_file as jload  # noqa

import pydcop_tpu_torch.api as tapi  # noqa: E402
import pydcop_tpu_torch.dcop as tdcop  # noqa: E402
import pydcop_tpu_torch.ops.semiring as tsr  # noqa: E402
from pydcop_tpu_torch import telemetry as ttel  # noqa: E402
from pydcop_tpu_torch.commands.generators import secp as tsecp  # noqa
from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file as tload  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = os.path.join(REPO, "examples", "graph_coloring_3.yaml")
CPU = "cpu"
COUNTS = ("cells", "dispatches", "device_nodes", "host_nodes", "width")
SKIP_KEYS = {"time", "telemetry"}


@pytest.fixture(autouse=True)
def no_session_left():
    """No test here starts or ends with a port telemetry session
    installed (the session is process-wide)."""
    assert ttel._active is None
    yield
    assert ttel._active is None


# -- instances, built with either package's model objects (``m``) ------


def coloring_tree(m, n=40):
    """``bench.py:_build_coloring_tree`` at ``n`` variables: each
    variable ``i`` joins a uniformly drawn earlier one with the 3x3
    identity (cost 1 when equal), ``random.Random(1)``."""
    import random

    rnd = random.Random(1)
    dom = m.Domain("colors", "", list(range(3)))
    tree = m.DCOP(f"tree_coloring_{n}")
    vs = [m.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        tree.add_variable(v)
    for i in range(1, n):
        j = rnd.randrange(i)
        tree.add_constraint(
            m.NAryMatrixRelation([vs[j], vs[i]], np.eye(3), name=f"c{i}")
        )
    return tree


def grid(m, side=4, seed=3):
    """A side x side 4-neighbour grid of 3-value variables with random
    uniform(0, 4) tables (``RandomState(seed)``): loopy, so ``min_fill``
    has fill edges to choose."""
    rng = np.random.RandomState(seed)
    dom = m.Domain("d", "", [0, 1, 2])
    dcop = m.DCOP(f"grid{side}")
    vs = {
        (r, c): m.Variable(f"x{r}_{c}", dom)
        for r in range(side) for c in range(side)
    }
    for v in vs.values():
        dcop.add_variable(v)
    for (r, c), v in vs.items():
        for nb in ((r, c + 1), (r + 1, c)):
            if nb in vs:
                dcop.add_constraint(m.NAryMatrixRelation(
                    [v, vs[nb]], rng.uniform(0, 4, (3, 3)),
                    name=f"g{r}_{c}_{nb[0]}_{nb[1]}",
                ))
    return dcop


SECP_24 = dict(  # bench.py:1046-1056 at 24 lights (its 192 scaled by 8)
    nb_lights=24, nb_models=24, nb_rules=6, light_levels=5,
    model_arity=3, zone_size=8, zone_layout="tiled",
    efficiency_weight=0.1, capacity=100.0, seed=7,
)

FIXTURES = {
    # name: (builder(package) -> dcop, infer keywords)
    "ring": (lambda p: (jload if p == "jax" else tload)(RING), {}),
    "tree40": (
        lambda p: coloring_tree(jdcop if p == "jax" else tdcop), {},
    ),
    "grid4x4-min_fill": (
        lambda p: grid(jdcop if p == "jax" else tdcop),
        {"order": "min_fill"},
    ),
    "secp24-tiled": (
        lambda p: (jsecp if p == "jax" else tsecp).generate(
            Namespace(**SECP_24)
        ),
        {},
    ),
}


@functools.lru_cache(maxsize=None)
def instance(name, package):
    return FIXTURES[name][0](package)


def first_vars(dcop, n=2):
    return sorted(dcop.variables)[:n]


def run_both(name, query, jax_kw=None, **kw):
    kw = dict(FIXTURES[name][1], **kw)
    if query == "marginal_map":
        kw["map_vars"] = first_vars(instance(name, "jax"))
    want = japi.infer(instance(name, "jax"), query,
                      **dict(kw, **(jax_kw or {})))
    got = tapi.infer(instance(name, "port"), query, torch_device=CPU, **kw)
    return want, got


QUERIES = ("map", "log_z", "marginals", "kbest:4", "marginal_map",
           "expectation")


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_host_f64_bit_equal_to_jax(name, query):
    want, got = run_both(name, query, device="never")
    assert want["status"] == got["status"] == "finished"
    assert set(got) == set(want)
    for k in set(want) - SKIP_KEYS:
        assert got[k] == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("name", ["tree40", "grid4x4-min_fill",
                                  "secp24-tiled"])
def test_device_path_on_cpu_matches_jax(name):
    """``device="always"`` with the contractions in eager PyTorch on
    the CPU: exact queries equal, log_z within both bounds, equal
    counts (the certificates decide the same cells on both sides)."""
    kw = dict(device="always", pad_policy="pow2")
    for query in ("map", "kbest:4"):
        want, got = run_both(name, query, **kw)
        for k in ("assignment", "cost") + COUNTS + (
            ("costs", "solutions") if query != "map" else ("log_weight",)
        ):
            assert got[k] == want[k], (query, k, got[k], want[k])
        # the card contracted; a tie-heavy node is then redone on host
        assert got["dispatches"] > 0
    want, got = run_both(name, "log_z", tol=float("inf"), **kw)
    for k in COUNTS:
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["device_nodes"] > 0
    assert abs(got["log_z"] - want["log_z"]) <= (
        got["error_bound"] + want["error_bound"]
    )
    host = tapi.infer(instance(name, "port"), "log_z", device="never",
                      torch_device=CPU, **FIXTURES[name][1])
    assert abs(got["log_z"] - host["log_z"]) <= got["error_bound"] + 1e-9


@pytest.mark.parametrize("query", ["marginals", "expectation"])
@pytest.mark.parametrize("name", ["tree40", "grid4x4-min_fill",
                                  "secp24-tiled"])
def test_device_mass_queries_within_error_bound(name, query):
    """The f32 contractions against the host f64 sweep: ``log_z``,
    every marginal probability and ``e_cost`` within the device run's
    ``error_bound`` + 1e-9, the gate ``chip_smoke.py`` holds the card
    to.  A belief cell is off by at most the bound in the log domain,
    so a normalised probability moves by at most tanh(bound / 2)."""
    dcop = instance(name, "port")
    kw = dict(FIXTURES[name][1], torch_device=CPU)
    host = tapi.infer(dcop, query, device="never", **kw)
    got = tapi.infer(dcop, query, device="always", tol=float("inf"),
                     pad_policy="pow2", **kw)
    assert got["device_nodes"] > 0
    err = got["error_bound"]
    assert err > 0
    assert abs(got["log_z"] - host["log_z"]) <= err + 1e-9
    if query == "marginals":
        assert set(got["marginals"]) == set(host["marginals"])
        for v, p in got["marginals"].items():
            dp = np.max(np.abs(np.asarray(p) - np.asarray(
                host["marginals"][v])))
            assert dp <= np.tanh(err / 2) + 1e-12, (v, dp, err)
    else:
        assert abs(got["e_cost"] - host["e_cost"]) <= err + 1e-9


def test_external_dists_expectation_matches_jax():
    """``expectation`` with a stochastic external: the external joins
    the plan as a summed variable weighted by its distribution."""
    def build(m):
        dom = m.Domain("d", "", [0, 1, 2])
        dcop = m.DCOP("sensor")
        x, y = m.Variable("x", dom), m.Variable("y", dom)
        ext = m.ExternalVariable("s", dom, value=1)
        for v in (x, y, ext):
            dcop.add_variable(v)  # an ExternalVariable files itself
        rng = np.random.RandomState(5)
        dcop.add_constraint(m.NAryMatrixRelation(
            [x, y], rng.uniform(0, 3, (3, 3)), name="xy"))
        dcop.add_constraint(m.NAryMatrixRelation(
            [y, ext], rng.uniform(0, 3, (3, 3)), name="ys"))
        return dcop

    dists = {"s": {0: 0.5, 1: 0.2, 2: 0.3}}
    want = japi.infer(build(jdcop), "expectation", device="never",
                      external_dists=dists)
    got = tapi.infer(build(tdcop), "expectation", device="never",
                     external_dists=dists, torch_device=CPU)
    for k in set(want) - SKIP_KEYS:
        assert got[k] == want[k], k


# -- contraction kernels -------------------------------------------------

KERNEL_CASES = {
    # name: (joined shape, aligned part shapes; a trailing k axis marks
    # a kbest child cell)
    "three-parts": ((4, 3, 5), ((4, 1, 5), (1, 3, 5), (4, 3, 1))),
    "own-1": ((5, 1), ((5, 1), (1, 1))),
    "kbest-children": ((4, 3, 5), ((4, 1, 5), (1, 3, 5, 3),
                                   (4, 3, 1, 3))),
    "kbest-no-scalar": ((6, 2), ((6, 2, 3), (1, 2, 3))),
    "expect-pairs": ((4, 3, 5), ((4, 1, 5, 2), (1, 3, 5, 2),
                                 (1, 1, 5))),
}


def kernel_parts(shapes, lead, seed, pos_inf_only):
    """Random f32 parts, a fifth of the cells ±inf; for kbest
    (``pos_inf_only``) three fifths +inf, so some cells have fewer than
    k finite candidates (kbest cells hold costs: +inf only, since a
    sort orders ``inf - inf`` NaNs by sign in XLA but not in
    PyTorch)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, ps in enumerate(shapes):
        p = (rng.random(lead + ps, dtype=np.float32) * 10).astype(
            np.float32)
        flat = p.reshape(-1)
        n_inf = flat.size * (3 if pos_inf_only else 1) // 5
        pick = rng.choice(flat.size, size=max(1, n_inf), replace=False)
        flat[pick] = np.inf if (pos_inf_only or i % 2 == 0) else -np.inf
        out.append(p)
    return out


def _same_or_nan(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.all(
        (a == b) | (np.isnan(a) & np.isnan(b))))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("sr,case", [
    ("max_sum", "three-parts"), ("max_sum", "own-1"),
    ("log_sum_exp", "three-parts"), ("marginals", "own-1"),
    ("kbest:3", "kbest-children"), ("kbest:3", "kbest-no-scalar"),
    ("kbest:4", "three-parts"),
    ("expectation", "expect-pairs"),
])
def test_contraction_kernel_matches_jax(sr, case, batched):
    shape, part_shapes = KERNEL_CASES[case]
    lead = (3,) if batched else ()
    parts = kernel_parts(part_shapes, lead, seed=len(case) + batched,
                         pos_inf_only=sr.startswith("kbest"))
    want = [np.asarray(x) for x in jsr.contraction_kernel(
        sr, shape, part_shapes, batched=batched)(*parts)]
    got = [x.numpy() for x in tsr.contraction_kernel(
        sr, shape, part_shapes, batched=batched)(
            *(torch.from_numpy(p) for p in parts))]
    assert len(got) == len(want)
    semiring = tsr.get_semiring(sr)
    if semiring.idempotent or semiring.kind == "kbest":
        for g, w in zip(got, want):  # values, margins, indices
            assert _same_or_nan(g, w.astype(g.dtype))
        if semiring.kind == "kbest":
            assert np.isinf(want[0]).any()  # the case reaches +inf slots
    else:
        g, w = got[0], want[0]
        assert g.shape == w.shape
        assert np.array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-6)


@pytest.mark.parametrize("sr", ["max_sum", "log_sum_exp"])
def test_factor_messages_match_jax(sr):
    """Max-Sum's factor phase under the maximizing and summing
    semirings (the min-sum form is pinned by the Max-Sum tests)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    tab = rng.random((3, 3, 5), dtype=np.float32)
    qs = [rng.random((3, 5), dtype=np.float32) for _ in range(2)]
    want = jsr.bp_factor_messages(
        jsr.get_semiring(sr), jnp.asarray(tab),
        [jnp.asarray(q) for q in qs], jnp.float32)
    got = tsr.bp_factor_messages(
        sr, torch.from_numpy(tab), [torch.from_numpy(q) for q in qs],
        torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


# -- merged sweeps, the CLI and the knobs --------------------------------


def test_infer_many_equals_sequential_infer():
    names = ["tree40", "secp24-tiled", "tree40"]
    dcops = [instance(n, "port") for n in names]
    kw = dict(device="always", pad_policy="pow2", torch_device=CPU)
    for query in ("map", "log_z"):
        qkw = dict(kw, tol=float("inf")) if query == "log_z" else kw
        many = tapi.infer_many(dcops, query, **qkw)
        seq = [tapi.infer(d, query, **qkw) for d in dcops]
        for m_, s_ in zip(many, seq):
            assert m_["instances_batched"] == 3
            for k in set(s_) - SKIP_KEYS - {"instances_batched"}:
                assert m_[k] == s_[k], (query, k)
        assert sum(m_["dispatches"] for m_ in many[:2]) < sum(
            s_["dispatches"] for s_ in seq[:2]) + seq[2]["dispatches"]
        assert many[0]["telemetry"] is many[1]["telemetry"]


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0
    return json.loads(out)


def test_cli_output_matches_jax_cli(capsys, tmp_path):
    """One file: one JSON object, the JAX CLI's keys and values (but
    time and telemetry); several files: a JSON array from one merged
    sweep."""
    from pydcop_tpu.cli import main as jmain
    from pydcop_tpu_torch.cli import main as tmain

    for query in ("log_z", "kbest:3"):
        want = _cli(jmain, ["infer", RING, "-q", query], capsys)
        got = _cli(tmain, ["infer", RING, "-q", query, "--torch_device",
                           "cpu"], capsys)
        assert set(got) == set(want)
        for k in set(want) - SKIP_KEYS:
            assert got[k] == want[k], k
    trace = tmp_path / "t.jsonl"
    many = _cli(tmain, ["infer", RING, RING, "-q", "map", "--torch_device",
                        "cpu", "--trace", str(trace)], capsys)
    jmany = _cli(jmain, ["infer", RING, RING, "-q", "map"], capsys)
    assert [set(r) for r in many] == [set(r) for r in jmany]
    assert [r["assignment"] for r in many] == [r["assignment"]
                                               for r in jmany]
    assert trace.exists()


def test_typo_query_suggests_the_nearest(capsys):
    with pytest.raises(ValueError, match="did you mean 'kbest:5'"):
        tapi.infer(RING, "kbset:3", torch_device=CPU)
    with pytest.raises(ValueError, match="did you mean 'log_z'"):
        tapi.infer(RING, "logz", torch_device=CPU)
    from pydcop_tpu_torch.cli import main as tmain

    with pytest.raises(SystemExit, match="did you mean 'marginals'"):
        tmain(["infer", RING, "-q", "marginalz", "--torch_device", "cpu"])


@pytest.mark.parametrize("kw,item", [
    ({"bnb": "on"}, None),
    ({"table_dtype": "bf16"}, None),
    ({"table_dtype": "int8"}, None),
    ({"table_format": "sparse"}, None),
    ({"max_util_bytes": 1 << 20}, None),
    ({"retry_budget": 1}, None),
    ({"compile_cache": "cache"}, "compile_cache"),
])
def test_unported_knobs_raise(kw, item):
    """The knobs of ROADMAP A10, A5 and A3 (ported) run and the map
    result equals the JAX package's key for key; ``compile_cache`` has
    no counterpart and raises."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            tapi.infer(RING, "map", torch_device=CPU, **kw)
        return
    want, got = run_both("ring", "map", device="always", **kw)
    for k in want:
        if k not in ("time", "telemetry"):
            assert got[k] == want[k], k


def test_no_cuda_device_raises_unless_cpu_is_asked():
    from pydcop_tpu_torch.device import NoCudaDeviceError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoCudaDeviceError):
        tapi.infer(RING, "map")


def test_oom_ladder_keeps_results_exact(monkeypatch):
    """A stacked dispatch that runs out of device memory splits into
    per-node dispatches (``engine.oom_splits``); a node that still does
    not fit is redone on host f64.  The answer does not move."""
    dcop = instance("tree40", "port")
    kw = dict(device="always", pad_policy="pow2", torch_device=CPU)
    want = tapi.infer(dcop, "map", **kw)
    inner = tsr._dispatch

    def stacked_ooms(fn, parts, device):
        if parts[0].ndim > 2:  # the stack axis leads a level dispatch
            raise torch.cuda.OutOfMemoryError("simulated")
        return inner(fn, parts, device)

    monkeypatch.setattr(tsr, "_dispatch", stacked_ooms)
    split = tapi.infer(dcop, "map", **kw)
    assert split["telemetry"]["counters"]["engine.oom_splits"] > 0
    assert split["assignment"] == want["assignment"]
    assert split["dispatches"] > want["dispatches"]

    def all_oom(fn, parts, device):
        raise torch.cuda.OutOfMemoryError("simulated")

    monkeypatch.setattr(tsr, "_dispatch", all_oom)
    host = tapi.infer(dcop, "map", **kw)
    assert host["assignment"] == want["assignment"]
    assert host["device_nodes"] == 0 and host["dispatches"] == 0
