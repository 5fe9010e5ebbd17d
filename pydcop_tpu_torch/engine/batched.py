"""The synchronous batched engine (port of ``pydcop_tpu/engine/batched.py``).

One ``step`` is one DCOP round for every agent at once.  Rounds run in
chunks: inside a chunk a Python loop calls the step (the counterpart of
the JAX package's ``lax.scan``), samples the anytime cost every
``cost_every`` rounds and keeps the best-so-far cost and assignment on
the device; the host synchronises once per chunk, when it reads the
chunk's cost trace.  Between chunks it checks ``timeout`` and
``convergence_chunks``.

Random numbers.  ``init_state`` draws on a CPU ``torch.Generator``
seeded with ``seed``, so a card run and a CPU run start from the same
state.  The rounds draw from ONE ``torch.Generator`` on the problem's
device (no host-to-device copy per round), seeded from ``seed`` through
:func:`round_generator`.  The card's and the CPU's generators give
different streams, so a card run and a CPU run of a stochastic algorithm
are not equal as whole runs: they are compared through the algorithm's
``apply`` fed the same draws (``chip_smoke.py``).

Restarts.  ``n_restarts = K > 1`` runs K independent solver instances
of the same problem as a leading ``[K]`` axis on every state leaf (the
PyTorch form of the JAX package's ``vmap``; the leaves an algorithm
names in ``STATIC_STATE_KEYS`` are shared) and reports the best over
them.  The per-round draws carry the batch shape ``[K, ...]``: this is
the JAX program's best-of-K semantics, not its stream.  Max-Sum and
A-Max-Sum take the restart axis into their kernels (one launch of each
per round for all K).

Instances.  :func:`run_many_batched` solves I same-shape problems (a
``StackedProblem``) in one chunk loop, with one host sync per chunk for
the whole group.  Max-Sum and A-Max-Sum (``INSTANCE_AXIS``) run on the
stacked problem, state ``[I, R, ...]``; the local-search family runs on
the group's disjoint union (``ops/compile.py:union_problem``), state
``[R, n·I]``.  Either way a round makes no per-instance Python loop and
the anytime costs are split per instance.

Checkpoints.  ``checkpoint_path`` saves the run state every
``checkpoint_every`` chunks (and once more at the end when chunks remain
unsaved) to an ``.npz`` file in the JAX package's layout
(``engine/checkpoint.py``); ``resume=True`` continues from it.  Beyond
the JAX package's keys the file holds the rounds' generator state
(``rng/round``) and the cost trace so far, so a resumed run equals an
uninterrupted one on the same device type in every result but its
time.  A generator state is device-specific: a checkpoint of a run that
drew random numbers resumes only on the device type it was written on.

Supervision.  Every chunk goes through the ambient supervisor's
dispatch (``engine/supervisor.py``): retries, OOM chunk halving and
group splits, the NaN quarantine and the device chaos kinds, as in the
JAX package (see :func:`run_batched` and :func:`run_many_batched`).

Sharded runs.  ``mesh`` (a ``pydcop_tpu_torch.parallel.Mesh``) runs an
``n_shards``-compiled problem over the mesh, the JAX package's
``shard_map``: one thread per shard runs each round on the shard's views
and its slice of the state (the algorithm's ``state_specs``), the
neighbor exchange is one ``psum`` a round, and the anytime cost is
evaluated per shard with one psum too (``ops/costs.py``).  The rounds'
draws are made once, in the calling thread, from the run's one
generator on the mesh's first device, and each shard gets its slice
(the algorithm's ``draw_specs``; replicated otherwise).  A meshed run
equals the unmeshed run of the same problem bit for bit.  Checkpoints
hold the state in its global layout (``n_shards`` in the meta) and
resume under a mesh of the same size.  Under a ``ProcessMesh`` (one
process a shard, ``parallel/distributed.py``) every rank runs this same
loop on its own view: every rank draws the whole problem's draws from a
generator seeded alike and keeps its slice, joining the state is a
gather, and only rank 0 writes a checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence
from typing import Union

import numpy as np
import torch

from pydcop_tpu_torch.engine.supervisor import (
    DeviceOOMError,
    DeviceTransientError,
    UnrecoverableDeviceError,
    get_supervisor,
)
from pydcop_tpu_torch.ops.compile import (
    CompiledProblem,
    StackedProblem,
    decode_assignment,
    shard_stacked,
    stack_problems,
    union_problem,
)
from pydcop_tpu_torch.ops.costs import instance_costs, total_cost
from pydcop_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    P,
    check_mesh,
    shard_problem,
    state_pspecs,
)
from pydcop_tpu_torch.telemetry import get_metrics, get_tracer


@dataclasses.dataclass
class RunResult:
    """Outcome of a batched run (costs in the problem's native sign)."""

    assignment: Dict[str, Any]  # final assignment
    cost: float  # final cost
    best_assignment: Dict[str, Any]  # best-seen (anytime) assignment
    best_cost: float
    cycles: int  # rounds executed
    messages: int  # logical messages (see algo.messages_per_round)
    time: float  # wall-clock seconds
    status: str  # 'finished' | 'timeout' | 'converged'
    cost_trace: np.ndarray  # per-sample cost (native sign)
    # per-restart best costs (native sign) when n_restarts > 1
    restart_costs: Optional[np.ndarray] = None
    # the final algorithm state as CPU tensors when return_state=True
    state: Optional[Dict[str, torch.Tensor]] = None


def round_generator(seed: int, device: torch.device) -> torch.Generator:
    """The rounds' generator on ``device``: seeded with a word derived
    from ``seed`` (numpy's ``SeedSequence``), so its stream is not the
    one ``init_state`` draws from ``seed`` itself."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(seed).generate_state(1)[0]))
    return gen


class _Checkpointer:
    """The checkpoint side of one :func:`run_batched` call: the JAX
    package's meta record and checks, plus the rounds' generator state
    (``rng/round``, with the device type it belongs to and whether the
    run has drawn from it) and the cost trace so far (``cost_trace``)."""

    def __init__(self, path, algo_module, problem, seed, chunk_size,
                 n_restarts, gen, gen0, whole, writer=True):
        from pydcop_tpu_torch.ops.compile import problem_fingerprint

        self.path = path
        self.static = getattr(algo_module, "STATIC_STATE_KEYS", ())
        self.gen, self.gen0 = gen, gen0
        self.meta = {
            "algo": algo_module.__name__,
            "seed": seed,
            "chunk_size": chunk_size,
            "problem": problem_fingerprint(problem),
            "n_restarts": n_restarts,
            "n_shards": problem.n_shards,
        }
        self.device_type = gen.device.type
        self.whole = whole  # the run's state -> its global layout
        self.writer = writer  # False on the ranks > 0 of a process mesh
        self.unsaved = 0

    def load(self, template, best_cost, best_values):
        """Check the file against this run (the JAX package's five
        checks, in its order and words, then the generator's device), and
        return ``(state, best_cost, best_values, rounds_done, trace)``."""
        from pydcop_tpu_torch.engine.checkpoint import (
            checkpoint_arrays,
            checkpoint_meta,
            load_checkpoint,
        )

        path, want = self.path, self.meta
        meta = checkpoint_meta(path)
        if meta.get("algo") != want["algo"]:
            raise ValueError(
                f"Checkpoint {path} was written by {meta.get('algo')}, "
                f"not {want['algo']}"
            )
        if meta.get("seed") != want["seed"]:
            raise ValueError(
                f"Checkpoint {path} was written with seed "
                f"{meta.get('seed')}, not {want['seed']} — the RNG stream "
                "would diverge"
            )
        if meta.get("chunk_size") not in (None, want["chunk_size"]):
            raise ValueError(
                f"Checkpoint {path} was written with chunk_size "
                f"{meta.get('chunk_size')}, not {want['chunk_size']} — "
                "per-round keys are derived from chunk boundaries, so the "
                "RNG stream would diverge"
            )
        if meta.get("problem") not in (None, want["problem"]):
            raise ValueError(
                f"Checkpoint {path} was written for a different problem "
                f"instance (fingerprint {meta.get('problem')} != "
                f"{want['problem']}) — resuming would silently produce "
                "wrong results"
            )
        if meta.get("n_restarts", 1) != want["n_restarts"]:
            raise ValueError(
                f"Checkpoint {path} was written with n_restarts="
                f"{meta.get('n_restarts', 1)}, not {want['n_restarts']} — "
                "the restart stack and RNG streams would not line up"
            )
        if meta.get("n_shards", 1) != want["n_shards"]:
            raise ValueError(
                f"Checkpoint {path} was written for n_shards="
                f"{meta.get('n_shards', 1)}, not {want['n_shards']}"
            )
        arrays = checkpoint_arrays(path, ("rng/round", "cost_trace"))
        if meta.get("rng_drawn"):
            if meta.get("rng_device") != self.device_type:
                raise ValueError(
                    f"Checkpoint {path} holds the rounds' random generator "
                    f"of a {meta.get('rng_device')} run; a "
                    f"{self.device_type} generator cannot continue its "
                    "stream, so the resumed run would diverge — resume on "
                    f"a {meta.get('rng_device')} device"
                )
            self.gen.set_state(torch.from_numpy(arrays["rng/round"]))
        state, bc, bv, done, _ = load_checkpoint(path, template, self.static)
        dev = best_values.device
        best_cost = torch.tensor(bc, dtype=best_cost.dtype, device=dev)
        best_values = torch.from_numpy(np.asarray(bv)).to(
            dtype=best_values.dtype, device=dev)
        trace = arrays.get("cost_trace", np.zeros(0, dtype=np.float32))
        return state, best_cost, best_values, done, trace

    def chunk_done(self, every, state, best_cost, best_values, done,
                   traces):
        self.unsaved += 1
        if self.unsaved >= every:
            tr, met = get_tracer(), get_metrics()
            with tr.span("checkpoint", cat="checkpoint", round=done):
                self.save(state, best_cost, best_values, done, traces)
            if met.enabled:
                met.inc("engine.checkpoints")

    def save(self, state, best_cost, best_values, done, traces):
        from pydcop_tpu_torch.engine.checkpoint import save_checkpoint

        rng = self.gen.get_state()
        meta = dict(self.meta, rng_device=self.device_type,
                    rng_drawn=not torch.equal(rng, self.gen0))
        whole = self.whole(state)  # a collective under a process mesh
        self.unsaved = 0
        if not self.writer:
            return
        save_checkpoint(
            self.path, whole, best_cost, best_values, done, meta,
            static_keys=self.static,
            arrays={"rng/round": rng.numpy(),
                    "cost_trace": np.concatenate(traces) if traces
                    else np.zeros(0, dtype=np.float32)},
        )


def _run_chunk(rounds, state, gen, n_rounds, cost_every, best_cost,
               best_values):
    """``n_rounds`` rounds of ``rounds`` (:class:`_Rounds` or
    :class:`ShardedRounds`); the anytime cost is evaluated after every
    ``cost_every``-th round and after the last one.  Returns the new
    state, best cost/values (device tensors, per restart under
    restarts) and the chunk's cost samples as one device tensor."""
    costs = []
    for i in range(1, n_rounds + 1):
        state = rounds.step(state, gen)
        if i % cost_every == 0 or i == n_rounds:
            cost, values = rounds.observe(state)
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best_values = torch.where(better[..., None], values, best_values)
            costs.append(cost)
    return state, best_cost, best_values, torch.stack(costs)


class _Rounds:
    """The round loop's access to an unmeshed run: the state is the
    algorithm's dict.  ``observe(state)`` gives ``(costs, values)`` in
    the layout the best is tracked in (``costs(values)`` and
    ``to_inst(values)``)."""

    def __init__(self, problem, algo_module, params, costs, to_inst=None):
        self.problem, self.algo, self.params = problem, algo_module, params
        self.costs = costs
        self.to_inst = to_inst or (lambda v: v)

    def step(self, state, gen):
        return self.algo.step(self.problem, state, self.params, gen)

    def observe(self, state):
        v = self.to_inst(state["values"])
        return self.costs(v), v

    def values(self, state):
        return state["values"]

    def whole(self, state, device=None):
        return state if device is None else {
            k: v.to(device) for k, v in state.items()
        }

    def place(self, state):
        return state


class ShardedRounds(_Rounds):
    """The round loop over a shard mesh (``parallel/mesh.py``): the state
    is one dict per shard (split by the algorithm's ``state_specs``, with
    ``lead`` batch axes in front of the non-static leaves).  Each round
    the draws are made here, from the run's generator, with the whole
    problem's shapes (``whole``), and split by the algorithm's
    ``draw_specs``; every shard then runs ``apply`` (or ``step``, for an
    algorithm that draws nothing) on its view with its axis.
    ``costs(view, values, axis)`` is evaluated on every shard, and shard
    0's result is the sample.  ``rounds`` and ``step_psums`` count the
    rounds run and the collectives they made."""

    def __init__(self, sharded, whole, algo_module, params, lead, costs,
                 to_inst=None, cost_views=None):
        super().__init__(whole, algo_module, params, costs, to_inst)
        self.sharded = sharded
        self.mesh = sharded.mesh
        self.views = sharded.views
        self.cost_views = cost_views or sharded.views
        self.lead = lead
        self.static = frozenset(getattr(algo_module, "STATIC_STATE_KEYS", ()))
        self.specs = dict(state_pspecs(algo_module, whole))
        self.draw_specs = (algo_module.draw_specs(whole)
                           if hasattr(algo_module, "draw_specs") else {})
        self.seam = hasattr(algo_module, "draws") and hasattr(
            algo_module, "apply")
        # numeric params one value per constraint of the problem split
        # with the constraints; the others go whole to every shard
        axes = getattr(algo_module, "INSTANCE_PARAM_AXES", {})
        pspecs = {
            k: P(SHARD_AXIS) for k, v in params.items()
            if isinstance(v, torch.Tensor) and axes.get(k) == "constraints"
        }
        self.shard_params = sharded.split(params, pspecs)
        self.rounds = 0
        self.step_psums = 0

    def place(self, state):
        """The whole state split over the mesh."""
        return self.sharded.split(state, self.specs, self.lead, self.static)

    def whole(self, parts, device=None):
        """The shards' parts joined into the whole state on ``device``
        (default: the mesh's first device)."""
        return self.sharded.join(parts, self.specs, self.lead, device,
                                 self.static)

    def step(self, parts, gen):
        drawn = None
        if self.seam:
            batch = tuple(parts[0]["values"].shape[:-1])
            drawn = self.algo.draws(self.problem, self.params, gen, batch)
        return self.apply(parts, drawn)

    def apply(self, parts, drawn=None):
        """One round on the shards' ``parts`` from the whole problem's
        ``drawn`` (its ``draws``; ``None`` for a step that draws
        nothing): each shard runs ``apply`` (or ``step``) on its view
        with its slice of the draws.  Returns the new parts."""
        algo, views, prm = self.algo, self.views, self.shard_params
        if self.seam:
            drawn = self.sharded.split(drawn or {}, self.draw_specs,
                                       self.lead)

            def fn(i, axis):
                return algo.apply(views[i], parts[i], prm[i], drawn[i],
                                  axis=axis)
        else:
            def fn(i, axis):
                return algo.step(views[i], parts[i], prm[i], None, axis=axis)

        before = self.mesh.psums
        out = self.mesh.run(fn)
        self.step_psums += self.mesh.psums - before
        self.rounds += 1
        return out

    def observe(self, parts):
        views, to_inst, costs = self.cost_views, self.to_inst, self.costs
        out = self.mesh.run(
            lambda i, axis: costs(views[i], to_inst(parts[i]["values"]), axis)
        )
        return out[0], to_inst(parts[0]["values"])

    def values(self, parts):
        return parts[0]["values"]


def _initial_state(problem, algo_module, params, seed, initial_state,
                   batch):
    """Validate a caller-supplied state (as the JAX engine does) and put
    it on the problem's device, each leaf in the dtype ``init_state``
    gives it; static leaves it lacks are rebuilt."""
    from pydcop_tpu_torch.interop import as_tensor

    if not isinstance(initial_state, dict) or "values" not in initial_state:
        raise ValueError(
            "initial_state must be a state dict with a 'values' leaf "
            "(RunResult.state of a previous run)"
        )
    want = batch + (problem.n_vars,)
    got = tuple(initial_state["values"].shape)
    if got != want:
        raise ValueError(
            f"initial_state 'values' has shape {got}, expected {want} "
            f"(n_restarts={batch[0] if batch else 1}) — a state from a "
            "different problem or restart count?"
        )
    static = frozenset(getattr(algo_module, "STATIC_STATE_KEYS", ()))
    fresh = algo_module.init_state(problem, seed, params, batch)
    expect = set(fresh) - static
    have = set(initial_state) - static
    if have != expect:
        raise ValueError(
            f"initial_state leaves {sorted(have)} do not match "
            f"{algo_module.__name__}'s state {sorted(expect)}"
        )
    state = dict(fresh)
    for k, v in initial_state.items():
        if k in fresh:
            state[k] = as_tensor(v, problem.device).to(fresh[k].dtype)
    return state


def run_batched(
    problem: CompiledProblem,
    algo_module,
    params: Dict[str, Any],
    rounds: int = 100,
    seed: int = 0,
    timeout: Optional[float] = None,
    chunk_size: int = 64,
    convergence_chunks: int = 0,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    chunk_callback: Optional[Callable[[int, float], Optional[str]]] = None,
    cost_every: int = 1,
    n_restarts: int = 1,
    initial_state: Optional[Dict[str, Any]] = None,
    return_state: bool = False,
) -> RunResult:
    """Run a batched algorithm for up to ``rounds`` rounds on the
    problem's device.

    The run proceeds in chunks of ``chunk_size`` rounds; between chunks
    the host checks ``timeout`` and (optionally) convergence: if
    ``convergence_chunks > 0`` and neither the best cost improved nor any
    value changed for that many consecutive chunks, the run stops with
    status ``converged`` (under restarts the across-restart best cost
    alone decides).  ``cost_every`` samples the anytime cost every that
    many rounds (and at each chunk's last round); the cost trace has one
    entry per sample (the minimum over restarts).  ``n_restarts > 1``
    runs that many independent instances and reports the best;
    ``restart_costs`` holds each one's best cost and ``messages`` counts
    all of them.  ``initial_state`` seeds the run with a state dict
    (tensors or numpy arrays; ``values`` ``[K, n]`` under restarts)
    instead of ``init_state``; ``return_state=True`` puts the final state
    (CPU tensors) on ``RunResult.state``.

    ``checkpoint_path`` writes the run state there every
    ``checkpoint_every`` chunks, inside a ``checkpoint`` span
    (``engine.checkpoints`` counts the saves), and at the end when chunks
    remain unsaved; with ``resume=True`` an existing file is checked
    against this run (algorithm, seed, chunk size, problem fingerprint,
    restarts, as the JAX package checks them) and loaded before the
    first chunk.  ``rounds`` counts the restored rounds too.

    Every chunk is one supervised dispatch (``engine/supervisor.py``,
    scope ``engine.chunk``): a transient failure retries the chunk in
    place, a device OOM halves ``chunk_size`` down to the supervisor's
    ``chunk_floor`` (``engine.oom_chunk_halvings``), and an
    unrecoverable failure writes a final checkpoint first.  Each attempt
    starts from the chunk's generator state, so a retried or halved run
    draws what the undisturbed run draws.  A NaN cost at a chunk
    boundary ends the run ``status="degraded"`` with its last finite
    best (or raises under ``on_numeric_fault='raise'``); a degraded
    state is never checkpointed.  ``chunk_callback(rounds_done,
    best_cost)`` runs after every chunk but the last (the best cost in
    the minimizing sign; with a ``wants_values`` attribute it also gets
    the current values); a status it returns ends the run with it.
    """
    if n_restarts < 1:
        raise ValueError(f"n_restarts must be >= 1, got {n_restarts}")
    if cost_every < 1 or chunk_size < 1:
        raise ValueError("cost_every and chunk_size must be >= 1")
    sharded = None if mesh is None else shard_problem(problem, mesh)
    if n_restarts > 1 and getattr(chunk_callback, "wants_values", False):
        raise ValueError(
            "n_restarts > 1 cannot feed a wants_values chunk_callback "
            "(the elastic runtime expects per-variable [n] values, not "
            "the [K, n] restart stack)"
        )

    t0 = time.perf_counter()
    sign = -1.0 if problem.maximize else 1.0
    batch = (n_restarts,) if n_restarts > 1 else ()
    if initial_state is not None:
        state = _initial_state(
            problem, algo_module, params, seed, initial_state, batch
        )
    else:
        state = algo_module.init_state(problem, seed, params, batch)
    run_dev = problem.device if sharded is None else sharded.device
    gen = round_generator(seed, run_dev)
    gen0 = gen.get_state()
    # the eager cost, outside the rounds, on the whole problem
    best_values = state["values"].to(run_dev)
    best_cost = total_cost(problem, state["values"]).to(run_dev)  # [] / [K]
    if sharded is None:
        loop = _Rounds(problem, algo_module, params,
                       lambda v: total_cost(problem, v))
    else:
        loop = ShardedRounds(sharded, problem, algo_module, params,
                             len(batch), total_cost)

    traces = []
    done = 0
    ck = None
    if checkpoint_path is not None:
        ck = _Checkpointer(checkpoint_path, algo_module, problem, seed,
                           chunk_size, n_restarts, gen, gen0, loop.whole,
                           writer=getattr(mesh, "rank", 0) == 0)
        if resume and os.path.exists(checkpoint_path):
            state, best_cost, best_values, done, trace = ck.load(
                state, best_cost, best_values)
            traces.append(trace)
    state = loop.place(state)
    status = "finished"
    stall = 0
    if convergence_chunks:
        prev_best = float(best_cost.min())
        prev_values = None if batch else best_values.cpu()
    tr, met = get_tracer(), get_metrics()
    sup = get_supervisor()

    def save_final():
        """The final checkpoint before an unrecoverable error surfaces:
        the last healthy state, and the rounds' generator at its
        chunk boundary (best effort: the error is the report)."""
        if ck is None:
            return
        try:
            ck.save(state, best_cost, best_values, done, traces)
        except Exception:  # noqa: BLE001 — the original failure wins
            return
        if met.enabled:
            met.inc("engine.checkpoints")

    while done < rounds:
        this_chunk = min(chunk_size, rounds - done)
        # a chunk that fails part-way has advanced the generator; every
        # attempt and every halved re-dispatch starts from this state
        # (the steps never write into the carried tensors, so the
        # chunk-start carry is intact)
        gen_start = gen.get_state()

        def chunk(n=this_chunk):
            gen.set_state(gen_start)
            out = _run_chunk(loop, state, gen, n, cost_every, best_cost,
                             best_values)
            # the chunk's one host sync, inside the dispatch: a kernel's
            # failure surfaces here, where the supervisor classifies it
            return out[:3] + (out[3].float().cpu().numpy(),)

        # the cycle span covers the chunk's dispatch AND its host sync
        try:
            with tr.span("cycle", cat="cycle", first=done,
                         rounds=this_chunk):
                state, best_cost, best_values, costs = sup.dispatch(
                    chunk, scope="engine.chunk", width=n_restarts,
                    rounds=this_chunk,
                )
        except DeviceOOMError as e:
            # halve the chunk down to the floor: fewer rounds in flight
            # between syncs.  The same generator state continues, so a
            # halved run draws what the unhalved run draws.
            gen.set_state(gen_start)
            new_chunk = max(sup.chunk_floor, this_chunk // 2)
            if new_chunk >= this_chunk:
                save_final()
                raise UnrecoverableDeviceError(
                    f"device OOM with the chunk already at the floor "
                    f"({this_chunk} rounds, chunk_floor="
                    f"{sup.chunk_floor}): {e}",
                    scope="engine.chunk", kind="oom",
                ) from e
            chunk_size = new_chunk
            if met.enabled:
                met.inc("engine.oom_chunk_halvings")
            if tr.enabled:
                tr.event("oom-halve", cat="supervisor", chunk=new_chunk,
                         round=done)
            continue
        except UnrecoverableDeviceError:
            gen.set_state(gen_start)
            save_final()
            raise
        if met.enabled:
            met.inc("engine.chunks")
            met.inc("engine.rounds", this_chunk)
        if batch:
            costs = costs.min(axis=-1)
        # the NaN screen at the chunk boundary (and the nan_inject
        # seam), over the samples already on the host.  The anytime
        # best is immune (cost < best is False for NaN), so a degraded
        # result carries the last finite best.
        poisoned = False
        if sup.active:
            if sup.nan_lanes(1, scope="engine.chunk"):
                costs[-1] = np.nan
            poisoned = bool(np.isnan(costs).any())
        traces.append(costs)
        done += this_chunk
        if poisoned:
            if met.enabled:
                met.inc("engine.numeric_faults")
            if sup.on_numeric_fault == "raise":
                save_final()
                raise UnrecoverableDeviceError(
                    "NaN cost at a chunk boundary "
                    f"(round {done}) under on_numeric_fault='raise'",
                    scope="engine.chunk", kind="numeric",
                )
            if met.enabled:
                met.inc("engine.quarantined_instances")
            if tr.enabled:
                tr.event("quarantine", cat="supervisor",
                         scope="engine.chunk", round=done)
            status = "degraded"
            break
        if ck is not None:
            ck.chunk_done(max(1, checkpoint_every), state, best_cost,
                          best_values, done, traces)
        if chunk_callback is not None and done < rounds:
            # a wants_values callback also receives the current values
            best_now = float(best_cost.min())
            if getattr(chunk_callback, "wants_values", False):
                cb_status = chunk_callback(
                    done, best_now, loop.values(state).cpu().numpy()
                )
            else:
                cb_status = chunk_callback(done, best_now)
            if cb_status is not None:
                status = cb_status
                break
        if timeout is not None and time.perf_counter() - t0 > timeout:
            status = "timeout"
            break
        if convergence_chunks:
            best_now = float(best_cost.min())
            # under restarts the [K, n] stack never crosses to the host:
            # one mover among K would block the early stop anyway
            cur_values = None if batch else loop.values(state).cpu()
            frozen = bool(batch) or torch.equal(cur_values, prev_values)
            if best_now >= prev_best - 1e-9 and frozen:
                stall += 1
                if stall >= convergence_chunks:
                    status = "converged"
                    break
            else:
                stall = 0
            prev_best = best_now
            prev_values = cur_values
    # a degraded (NaN-poisoned) state never lands in a checkpoint:
    # resuming from it would continue the poisoned trajectory
    if ck is not None and ck.unsaved and status != "degraded":
        ck.save(state, best_cost, best_values, done, traces)

    final_values = loop.values(state)
    final_costs = total_cost(problem, final_values.to(problem.device))
    restart_costs = None
    if batch:
        # report the best restart: final = lowest final cost, anytime
        # best = lowest best-seen cost
        i_fin = int(torch.argmin(final_costs))
        final_values = final_values[i_fin]
        final_costs = final_costs[i_fin]
        i_best = int(torch.argmin(best_cost))
        restart_costs = sign * best_cost.cpu().numpy()
        best_values = best_values[i_best]
        best_cost = best_cost[i_best]
    final_cost = float(final_costs)
    best_cost_f = float(best_cost)
    if status == "degraded":
        # the post-poison final values are not trusted: report the
        # anytime best for both, as the JAX package does
        final_values, final_cost = best_values, best_cost_f
    elapsed = time.perf_counter() - t0
    msgs = algo_module.messages_per_round(problem, params) * done * n_restarts
    trace = np.concatenate(traces) if traces else np.zeros(0)
    out_state = (
        loop.whole(state, "cpu") if return_state else None
    )
    return RunResult(
        assignment=decode_assignment(problem, final_values),
        cost=sign * final_cost,
        best_assignment=decode_assignment(problem, best_values),
        best_cost=sign * best_cost_f,
        cycles=done,
        messages=msgs,
        time=elapsed,
        status=status,
        cost_trace=sign * trace,
        restart_costs=restart_costs,
        state=out_state,
    )


def _split_params(p: Mapping[str, Any]):
    """(statics, numeric) of one params mapping: str/bool values are
    statics, the other non-None ones numeric."""
    statics = {k: v for k, v in p.items() if isinstance(v, (str, bool))}
    dyn = {
        k: v for k, v in p.items()
        if not isinstance(v, (str, bool)) and v is not None
    }
    return statics, dyn


def _group_params(algo_module, params_list, run_problem, n_inst: int,
                  instance_axis: bool) -> Dict[str, Any]:
    """The params one round of the group takes: shared values as they
    are; a numeric param whose value differs between instances as an f32
    tensor on the device, one value per instance on a stacked problem,
    else one per element of the union along the axis the algorithm names
    in ``INSTANCE_PARAM_AXES`` (``"variables"`` by default, or
    ``"constraints"``)."""
    statics, dyn0 = _split_params(params_list[0])
    for i, p in enumerate(params_list[1:], 1):
        s, d = _split_params(p)
        if s != statics or sorted(d) != sorted(dyn0):
            raise ValueError(
                f"run_many_batched: instance {i} differs from instance 0 "
                "in static (str/bool) params or param structure — group "
                "instances by them upstream"
            )
    out = dict(params_list[0])
    axes = getattr(algo_module, "INSTANCE_PARAM_AXES", {})
    for k in dyn0:
        vals = [float(p[k]) for p in params_list]
        if all(v == vals[0] for v in vals):
            continue
        t = torch.tensor(vals, dtype=torch.float32)
        if not instance_axis:  # interleaved union: element x·I + i
            size = (run_problem.n_cons if axes.get(k) == "constraints"
                    else run_problem.n_vars) // n_inst
            t = t.repeat(size)
        out[k] = t.to(run_problem.device)
    return out


def run_many_batched(
    stacked: Union[StackedProblem, List[StackedProblem]],
    algo_module,
    params: Union[Mapping[str, Any], Sequence[Mapping[str, Any]]],
    *,
    rounds: int = 100,
    seeds: Union[int, Sequence[int]] = 0,
    timeout: Optional[float] = None,
    chunk_size: int = 64,
    convergence_chunks: int = 0,
    cost_every: int = 1,
    n_restarts: int = 1,
    mesh=None,
) -> List[RunResult]:
    """Solve the I instances of ``stacked`` (``ops/compile.py:
    stack_problems``) together: one chunk loop for the group, one host
    sync a chunk, each round one pass of the algorithm over all
    instances (and ``n_restarts`` restarts of each).

    ``params`` is one mapping or one per instance: str/bool params must
    agree (they select code paths), numeric ones may differ per instance.
    ``seeds`` (an int or one per instance) seed each instance's initial
    state as ``run_batched(host_problems[i], seed=seeds[i])`` would, so
    a deterministic algorithm (Max-Sum, MGM, DBA, GDBA) returns for each
    instance what its own run returns, bit for bit.  The rounds' draws
    come from one device generator seeded from ``seeds[0]``, in the
    group's layout: a stochastic algorithm's instance keeps its
    semantics, not the stream of a run of its own.

    ``timeout`` and ``convergence_chunks`` act on the whole group at
    chunk boundaries, as in the JAX package: converged when no
    instance's best improved (and, without restarts, no instance's
    values changed) for that many chunks.  Returns one
    :class:`RunResult` per instance in stack order (``stacked.indices``
    maps back to the caller's order); each ``time`` is the wall time of
    the group (or split half) that produced it.

    Every chunk is one supervised dispatch (scope ``engine.group``,
    width ``I·n_restarts``).  A device OOM splits the group in half and
    runs each half from round 0 as a group of its own (down to single
    instances; ``engine.oom_splits``); a one-instance group halves its
    chunk instead.  A real transient restarts the whole group from round
    0 (``group-restart``, within the supervisor's ``retry_budget``).  A
    lane whose costs go NaN is quarantined: it reports
    ``status="degraded"`` with its last finite best, and the other lanes
    finish as they would have.  A half draws from a generator seeded
    with its own first seed, so a split half of a stochastic group on
    the union equals that half run alone, not the unsplit group
    (ROADMAP.md, C); a group that draws nothing is unchanged by a split.

    Recoveries run from a work list, not by recursion: a split group's
    stacked tensors are released before its halves are stacked and run.
    ``stacked`` may be handed over in a one-element list, which the call
    empties: the call then holds the only reference to the group, so
    a split frees the group's stacked problem on the device before the
    halves start (``api.solve_many`` hands its groups over this way).
    """
    if isinstance(stacked, list):
        if len(stacked) != 1:
            raise ValueError("hand the group over as a one-element list")
        first = stacked.pop()
    else:
        first = stacked
    del stacked
    t0 = time.perf_counter()
    I = first.n_instances
    R = n_restarts
    if R < 1:
        raise ValueError(f"n_restarts must be >= 1, got {R}")
    if mesh is not None:  # the type and size checks, before any work
        check_mesh(first.n_shards, mesh)
    if cost_every < 1 or chunk_size < 1:
        raise ValueError("cost_every and chunk_size must be >= 1")
    if isinstance(params, Mapping):
        params_list = [dict(params)] * I
    else:
        params_list = [dict(p) for p in params]
    if len(params_list) != I:
        raise ValueError(f"params: got {len(params_list)} for {I} instances")
    seeds = [int(seeds)] * I if isinstance(seeds, (int, np.integer)) else [
        int(x) for x in seeds
    ]
    if len(seeds) != I:
        raise ValueError(f"seeds: got {len(seeds)} for {I} instances")
    hosts = list(first.host_problems)
    deadline = None if timeout is None else t0 + timeout
    results: List[Optional[RunResult]] = [None] * I
    # the work list, last in first out, so that halves run in order:
    # (lo, hi, stacked group or None to stack it, chunk size, attempt)
    work = [(0, I, first, chunk_size, 0)]
    del first
    while work:
        lo, hi, part, chunk, attempt = work.pop()
        if part is None:
            part = stack_problems(hosts[lo:hi])[0]
        group = [part]  # _run_group takes the only reference
        del part
        outcome, arg = _run_group(
            group, algo_module, params_list[lo:hi], seeds[lo:hi],
            rounds=rounds,
            timeout=None if deadline is None
            else max(deadline - time.perf_counter(), 0.01),
            chunk_size=chunk, convergence_chunks=convergence_chunks,
            cost_every=cost_every, n_restarts=R, attempt=attempt, mesh=mesh,
        )
        if outcome == "done":
            results[lo:hi] = arg
        elif outcome == "split":
            mid = lo + (hi - lo + 1) // 2
            work += [(mid, hi, None, chunk, 0), (lo, mid, None, chunk, 0)]
        else:  # "restart": the same group from round 0
            new_chunk, new_attempt, same = arg
            work.append((lo, hi, same, new_chunk, new_attempt))
        del arg
    return results


def _run_group(holder, algo_module, params_list, seeds, *, rounds, timeout,
               chunk_size, convergence_chunks, cost_every, n_restarts,
               attempt, mesh=None):
    """One group's chunk loop (:func:`run_many_batched`).  ``holder``
    holds the stacked group, which this call takes out.  Returns
    ``("done", results)``, ``("split", None)`` after a device OOM (the
    group's tensors are released when this returns), or ``("restart",
    (chunk, attempt, group))`` to run the same group again from round
    0."""
    t0 = time.perf_counter()
    stacked = holder.pop()
    I = stacked.n_instances
    R = n_restarts
    sign = -1.0 if stacked.maximize else 1.0
    n = stacked.n_vars
    hosts = stacked.host_problems
    instance_axis = getattr(algo_module, "INSTANCE_AXIS", False)
    inits = [
        algo_module.init_state(hp, seed, p, (R,))
        for hp, seed, p in zip(hosts, seeds, params_list)
    ]
    if instance_axis:  # the stacked problem itself, state [I, R, ...]
        problem = stacked
        static = sorted(set(inits[0]) & set(
            getattr(algo_module, "STATIC_STATE_KEYS", ())))
        if static:
            raise ValueError(
                f"{algo_module.__name__}: the state leaves {static} index "
                "one problem's structure, which a stacked group does not "
                "share (maxsum belief='blockdiag' runs one problem at a "
                "time; use belief='auto' in a group)"
            )
        state = {k: torch.stack([s[k] for s in inits]) for k in inits[0]}

        def to_inst(values):
            return values
    else:  # the disjoint union, state [R, n·I], interleaved
        problem = union_problem(stacked)
        state = algo_module.init_state(problem, seeds[0], params_list[0],
                                       (R,))
        state["values"] = torch.stack(
            [s["values"] for s in inits], dim=-1
        ).reshape(R, n * I)

        def to_inst(values):  # [R, n·I] -> [I, R, n]
            return values.view(R, n, I).permute(2, 0, 1)
    del inits  # the per-instance copies: the group holds its own
    run_params = _group_params(algo_module, params_list, problem, I,
                               instance_axis)
    if mesh is None:
        loop = _Rounds(problem, algo_module, run_params,
                       lambda v: instance_costs(stacked, v), to_inst)
        run_dev = stacked.device
    else:
        # the instance axis batched, the shards mesh-mapped: Max-Sum's
        # stacked group splits per instance (stacked views), the union
        # splits as one problem and its costs read stacked views
        sharded = shard_problem(problem, mesh)
        loop = ShardedRounds(
            sharded, problem, algo_module, run_params,
            2 if instance_axis else 1, instance_costs, to_inst,
            None if instance_axis else shard_stacked(
                stacked, [d for _, d in mesh.local],
                [s for s, _ in mesh.local]),
        )
        run_dev = sharded.device

    gen = round_generator(seeds[0], run_dev)
    # the eager costs, outside the rounds, on the whole group
    v0 = to_inst(state["values"])
    best_cost = instance_costs(stacked, v0).to(run_dev)  # [I, R]
    best_values = v0.to(run_dev).clone()  # [I, R, n]
    state = loop.place(state)

    sup = get_supervisor()
    traces = []
    done = 0
    status = "finished"
    stall = 0
    # lane -> (best cost [R], best values [R, n]) at the boundary where
    # the lane went NaN: the other lanes run on, the quarantined one
    # reports this last finite best with status 'degraded'
    quarantined: Dict[int, Any] = {}
    prev_best = best_cost.amin(dim=1).cpu().numpy()
    prev_values = None if R > 1 else to_inst(loop.values(state)).cpu()
    tr, met = get_tracer(), get_metrics()
    while done < rounds:
        this_chunk = min(chunk_size, rounds - done)

        def chunk(n=this_chunk):
            out = _run_chunk(loop, state, gen, n, cost_every, best_cost,
                             best_values)
            # the one host sync of the chunk: [samples, I, R] -> [I, samples]
            return out[:3] + (out[3].float().amin(dim=-1).t().cpu().numpy(),)

        # a recovery that re-runs the group runs after the except
        # clause: the failed chunk's tensors, which the exception's
        # frames hold, are free by then
        restart = split = halve = None
        try:
            with tr.span(
                "cycle", cat="cycle", first=done, rounds=this_chunk,
                instances=I,
            ):
                state, best_cost, best_values, costs = sup.dispatch(
                    chunk, scope="engine.group", width=I * R,
                    rounds=this_chunk,
                    # a real failure is never replayed in place: the
                    # group restarts from round 0 (below), as the JAX
                    # package's donated group does
                    retryable=False,
                )
        except DeviceTransientError as e:
            # a real transient: the retry is a whole-group restart from
            # round 0, with its own keyed backoff and the call's budget
            if attempt >= sup.config.retry_budget:
                raise UnrecoverableDeviceError(
                    "engine.group: transient device failure persisted "
                    f"through the retry budget ({sup.config.retry_budget})"
                    f" across group restarts: {e}",
                    scope="engine.group", kind="transient",
                    attempts=attempt,
                ) from e
            restart = str(e)[:200]
        except DeviceOOMError as e:
            if I > 1:
                split = str(e)[:200]
            else:
                # one instance: run_batched's chunk-halving ladder
                new_chunk = max(sup.chunk_floor, this_chunk // 2)
                if new_chunk >= this_chunk:
                    raise UnrecoverableDeviceError(
                        f"device OOM on a single-instance group with the "
                        f"chunk already at the floor ({this_chunk} "
                        f"rounds, chunk_floor={sup.chunk_floor}): {e}",
                        scope="engine.group", kind="oom",
                    ) from e
                halve = (new_chunk, e.injected)
        if restart is not None:
            cfg = sup.config
            if met.enabled:
                met.inc("engine.retries")
            if tr.enabled:
                tr.event("group-restart", cat="supervisor",
                         scope="engine.group", attempt=attempt + 1,
                         error=restart)
            delays = cfg.delays("supervisor:engine.group.restart")
            for _ in range(attempt):  # this restart's place in the stream
                next(delays)
            cfg.sleep(next(delays))
            return "restart", (chunk_size, attempt + 1, stacked)
        if split is not None:
            # the caller splits the instance stack in half and runs each
            # half from round 0, once this group's tensors are gone
            if met.enabled:
                met.inc("engine.oom_splits")
            if tr.enabled:
                tr.event("oom-split", cat="supervisor",
                         scope="engine.group", instances=I, error=split)
            return "split", None
        if halve is not None:
            new_chunk, injected = halve
            if met.enabled:
                met.inc("engine.oom_chunk_halvings")
            if tr.enabled:
                tr.event("oom-halve", cat="supervisor", chunk=new_chunk,
                         round=done)
            if not injected:
                # a real OOM fired inside the chunk: restart from round
                # 0 at the halved chunk (an injected one fired before)
                return "restart", (new_chunk, attempt, stacked)
            chunk_size = new_chunk
            continue
        if met.enabled:
            if done == 0:
                met.inc("engine.batch_groups")
                met.inc("engine.instances_batched", I)
            met.inc("engine.chunks")
            met.inc("engine.rounds", this_chunk)
        # the per-lane NaN screen (and the nan_inject seam) over the
        # samples on the host: a poisoned lane is quarantined while the
        # others run on bit for bit (lanes never exchange data)
        if sup.active:
            for lane in sup.nan_lanes(I, scope="engine.group"):
                costs[lane, -1] = np.nan
            new_bad = [int(i) for i in np.nonzero(np.isnan(costs).any(1))[0]
                       if int(i) not in quarantined]
            if new_bad:
                if met.enabled:
                    met.inc("engine.numeric_faults", len(new_bad))
                if sup.on_numeric_fault == "raise":
                    raise UnrecoverableDeviceError(
                        f"NaN cost in instance lane(s) {new_bad} at "
                        f"round {done + this_chunk} under "
                        "on_numeric_fault='raise'",
                        scope="engine.group", kind="numeric",
                    )
                bc_np = best_cost.cpu().numpy()
                bv_np = best_values.cpu().numpy()
                for i in new_bad:
                    quarantined[i] = (bc_np[i].copy(), bv_np[i].copy())
                    if met.enabled:
                        met.inc("engine.quarantined_instances")
                    if tr.enabled:
                        tr.event("quarantine", cat="supervisor",
                                 scope="engine.group", lane=i,
                                 round=done + this_chunk)
        traces.append(costs)
        done += this_chunk
        if len(quarantined) == I:  # nothing healthy left to run
            status = "degraded"
            break
        if timeout is not None and time.perf_counter() - t0 > timeout:
            status = "timeout"
            break
        if convergence_chunks:
            best_now = best_cost.amin(dim=1).cpu().numpy()
            cur_values = None if R > 1 else to_inst(loop.values(state)).cpu()
            frozen = R > 1 or torch.equal(cur_values, prev_values)
            if np.all(best_now >= prev_best - 1e-9) and frozen:
                stall += 1
                if stall >= convergence_chunks:
                    status = "converged"
                    break
            else:
                stall = 0
            prev_best = best_now
            prev_values = cur_values

    final_costs, final_values = loop.observe(state)  # [I, R]
    rows = torch.arange(I, device=final_costs.device)
    i_fin = final_costs.argmin(dim=1)
    i_best = best_cost.argmin(dim=1)
    fv = final_values[rows, i_fin].cpu().numpy()
    fc = final_costs[rows, i_fin].double().cpu().numpy()
    bv = best_values[rows, i_best].cpu().numpy()
    bc = best_cost[rows, i_best].double().cpu().numpy()
    restart_costs = sign * best_cost.cpu().numpy() if R > 1 else None
    statuses = [status] * I
    for i, (q_bc, q_bv) in quarantined.items():
        # the lane's post-poison values are not trusted: its snapshot
        # (last finite anytime best) is both its final and its best
        statuses[i] = "degraded"
        j = int(np.argmin(q_bc))
        if restart_costs is not None:
            restart_costs[i] = sign * q_bc
        fv[i] = bv[i] = q_bv[j]
        fc[i] = bc[i] = float(q_bc[j])
    elapsed = time.perf_counter() - t0
    trace = np.concatenate(traces, axis=1) if traces else np.zeros((I, 0))
    return "done", [
        RunResult(
            assignment=decode_assignment(hp, fv[i]),
            cost=sign * float(fc[i]),
            best_assignment=decode_assignment(hp, bv[i]),
            best_cost=sign * float(bc[i]),
            cycles=done,
            messages=algo_module.messages_per_round(hp, params_list[i])
            * done * R,
            time=elapsed,
            status=statuses[i],
            cost_trace=sign * trace[i],
            restart_costs=None if restart_costs is None
            else restart_costs[i],
        )
        for i, hp in enumerate(hosts)
    ]
