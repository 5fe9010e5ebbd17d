"""Forbidden-pair task-scheduling generator — the sparse-table
workload.  A copy of ``pydcop_tpu/commands/generators/taskscheduling.py``
(the same instance and YAML from the same arguments and seed; the table
fill is vectorized, value for value).

``nb_tasks`` jobs each pick one of ``nb_slots`` time slots.  A chain
of sliding windows of ``--window`` consecutive tasks (advancing by
``--stride``, like the SECP overlap layout) carries one extensional
constraint per window: every pair of tasks inside the window draws a
random set of FORBIDDEN slot pairs with density ``--forbid_density``
(machine conflicts, crew exclusions, setup incompatibilities — the
hard-cap analogue of ``secp --hard_cap``), and a joint tuple whose
ANY pair lands in a forbidden set costs ``+inf``.  Feasible tuples
pay the soft lateness ``sum_t |slot_t - due_t|``, with due dates
drawn from a PLANTED schedule whose pairs are never forbidden — so
every instance is feasible by construction and the planted schedule
costs 0.

Sparsity is the point: a window of arity ``k`` survives all its
``k·(k-1)/2`` pairwise filters with probability about
``(1 - forbid_density)^(k(k-1)/2)`` per tuple — the defaults
(``window=4``, ``forbid_density=0.5``) leave ~1.6% of cells finite,
i.e. >= 98% ``+inf``.  Dense UTIL packs must ship (and a
``--max_util_bytes`` planner must budget) the full ``d^k`` box
regardless; ``--table_format sparse`` packs only the feasible tuples
(``ops/sparse.py``), so the same byte budget holds windows no dense
plan could fit.
"""

from __future__ import annotations

import itertools
import random

import numpy as np

from pydcop_tpu_torch.commands.generators._common import write_dcop


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "task_scheduling",
        help="generate a forbidden-pair task-scheduling DCOP "
        "(>=90%%-infeasible windowed tables — the sparse "
        "table_format workload)",
    )
    p.add_argument("--nb_tasks", type=int, required=True)
    p.add_argument(
        "--nb_slots", type=int, default=8,
        help="time slots per task (the domain size)",
    )
    p.add_argument(
        "--window", type=int, default=4,
        help="tasks per sliding-window constraint (the table "
        "arity): cell count d^window, so window x nb_slots sets "
        "the dense table size the sparse pack undercuts",
    )
    p.add_argument(
        "--stride", type=int, default=2,
        help="window advance; stride < window chains consecutive "
        "windows through shared tasks (wider separators, deeper "
        "pseudo-tree) exactly like secp --zone_layout overlap",
    )
    p.add_argument(
        "--forbid_density", type=float, default=0.5,
        help="probability each (task pair, slot pair) is forbidden "
        "(+inf).  A window of arity k keeps a tuple with "
        "probability ~(1-p)^(k(k-1)/2): the default 0.5 at "
        "window=4 leaves ~1.6%% of cells finite.  The planted "
        "schedule's pairs are never forbidden, so instances stay "
        "feasible at any density < 1",
    )
    p.add_argument(
        "--lateness_weight", type=float, default=1.0,
        help="soft cost per slot of |slot - due| lateness on "
        "feasible tuples (due dates = the planted schedule)",
    )
    p.add_argument("--capacity", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    return write_dcop(args, generate(args))


def generate(args):
    from pydcop_tpu_torch.dcop.dcop import DCOP
    from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
    from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation

    n, d = int(args.nb_tasks), int(args.nb_slots)
    k = int(args.window)
    stride = int(args.stride)
    p_forbid = float(args.forbid_density)
    if not 2 <= k <= n:
        raise ValueError(
            f"window={k} must be in [2, nb_tasks={n}] — a window "
            "of one task has no pairs to forbid"
        )
    if not 0 < stride <= k:
        raise ValueError(
            f"stride={stride} must be in [1, window={k}] — a "
            "stride past the window leaves tasks constraint-free"
        )
    if not 0.0 <= p_forbid < 1.0:
        raise ValueError(
            f"forbid_density={p_forbid} must be in [0, 1) — at 1 "
            "every non-planted pair is outlawed and the table "
            "degenerates to the single planted tuple"
        )

    rnd = random.Random(args.seed)
    dcop = DCOP(
        f"tasks_{n}t_{d}s_w{k}",
        objective="min",
        description=(
            "forbidden-pair task scheduling, seed %d" % args.seed
        ),
    )
    slots = Domain("slots", "time_slot", list(range(d)))
    tasks = []
    for i in range(n):
        v = Variable(f"t{i:04d}", slots)
        tasks.append(v)
        dcop.add_variable(v)

    # the planted schedule: due dates AND the feasibility witness
    planted = [rnd.randrange(d) for _ in range(n)]

    # forbidden slot pairs per ORDERED task pair (i < j), drawn once
    # globally so overlapping windows agree on the shared pairs'
    # conflicts — two windows disagreeing about the same task pair
    # would encode no consistent scheduling story
    forbid: dict = {}

    def _pairs(i: int, j: int) -> np.ndarray:
        key = (i, j)
        m = forbid.get(key)
        if m is None:
            m = np.zeros((d, d), dtype=bool)
            for a in range(d):
                for b in range(d):
                    if rnd.random() < p_forbid:
                        m[a, b] = True
            m[planted[i], planted[j]] = False
            forbid[key] = m
        return m

    w = float(args.lateness_weight)
    anchors = list(range(0, max(n - k, 0) + 1, stride))
    if anchors[-1] != n - k:
        anchors.append(n - k)  # the tail window covers the last tasks
    grid = np.indices((d,) * k) if anchors else None
    for a in anchors:
        scope_ids = list(range(a, a + k))
        pair_masks = [
            (x, y, _pairs(scope_ids[x], scope_ids[y]))
            for x, y in itertools.combinations(range(k), 2)
        ]
        # the integer lateness sum, then one multiply: the same value
        # as the per-tuple w * sum(...)
        late = np.zeros((d,) * k, dtype=np.int64)
        for x, t in enumerate(scope_ids):
            late += np.abs(grid[x] - planted[t])
        forbidden = np.zeros((d,) * k, dtype=bool)
        for x, y, m in pair_masks:
            forbidden |= m[grid[x], grid[y]]
        matrix = np.where(forbidden, np.inf, w * late.astype(np.float64))
        dcop.add_constraint(
            NAryMatrixRelation(
                [tasks[t] for t in scope_ids], matrix,
                name=f"win{a:04d}",
            )
        )

    dcop.add_agents(
        [
            AgentDef(f"a{i:04d}", capacity=args.capacity)
            for i in range(n)
        ]
    )
    return dcop
