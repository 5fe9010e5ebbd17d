"""Meeting-scheduling problem generator (PEAV encoding).

A copy of ``pydcop_tpu/commands/generators/meetingscheduling.py`` (the same instance
from the same arguments and seed).

Role-equivalent to the reference's ``generators/meetingscheduling.py``:
resources (people) attend events (meetings) scheduled into time slots.
PEAV (Private Events As Variables): each resource owns one variable per
event it attends, whose domain is the slot set.  Constraints:

- equality between all variables of one event (every participant agrees
  on the slot) — violation cost ``--eq_cost``;
- mutual exclusion between variables of the same resource whose events
  would overlap (same slot) — violation cost ``--noconflict_cost``;
- a per-variable preference cost: each resource values each slot
  randomly in ``U(0, value_range)`` (expressed extensionally).
"""

from __future__ import annotations

import random

import numpy as np

from pydcop_tpu_torch.commands.generators._common import write_dcop


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "meeting_scheduling",
        help="generate a PEAV meeting-scheduling DCOP",
    )
    p.add_argument("--slots_count", "-s", type=int, required=True)
    p.add_argument("--events_count", "-e", type=int, required=True)
    p.add_argument("--resources_count", "-r", type=int, required=True)
    p.add_argument(
        "--max_resources_event", type=int, default=2,
        help="resources drawn per event (attendance)",
    )
    p.add_argument("--eq_cost", type=float, default=10.0)
    p.add_argument("--noconflict_cost", type=float, default=10.0)
    p.add_argument("--value_range", type=float, default=1.0)
    p.add_argument("--capacity", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    return write_dcop(args, generate(args))


def generate(args):
    from pydcop_tpu_torch.dcop.dcop import DCOP
    from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
    from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation

    rnd = random.Random(args.seed)
    n_slots = args.slots_count

    dcop = DCOP(
        f"meetings_{args.events_count}e_{args.resources_count}r_{n_slots}s",
        objective="min",
        description="PEAV meeting scheduling, seed %d" % args.seed,
    )
    slots = Domain("slots", "time_slot", list(range(n_slots)))

    # attendance: each event draws its participants
    attendance = {}
    for e in range(args.events_count):
        k = min(
            args.max_resources_event, args.resources_count
        )
        attendance[e] = sorted(
            rnd.sample(range(args.resources_count), k)
        )

    # PEAV variables: one per (resource, attended event)
    variables = {}
    for e, members in attendance.items():
        for r in members:
            v = Variable(f"m{e:03d}_r{r:03d}", slots)
            variables[(e, r)] = v
            dcop.add_variable(v)

    eye = np.eye(n_slots, dtype=bool)
    eq_matrix = np.where(eye, 0.0, np.float32(args.eq_cost))
    excl_matrix = np.where(eye, np.float32(args.noconflict_cost), 0.0)

    # equality inside one event: ALL pairs of participant variables
    # (PEAV encoding), not a chain — the chain under-penalizes
    # disagreement for events with >2 participants
    import itertools

    for e, members in attendance.items():
        for r1, r2 in itertools.combinations(members, 2):
            v1 = variables[(e, r1)]
            v2 = variables[(e, r2)]
            dcop.add_constraint(
                NAryMatrixRelation(
                    [v1, v2], eq_matrix, name=f"eq_{v1.name}_{v2.name}"
                )
            )

    # mutual exclusion inside one resource's calendar
    by_resource = {}
    for (e, r), v in variables.items():
        by_resource.setdefault(r, []).append(v)
    for r, vs in by_resource.items():
        for i in range(len(vs)):
            for j in range(i + 1, len(vs)):
                dcop.add_constraint(
                    NAryMatrixRelation(
                        [vs[i], vs[j]],
                        excl_matrix,
                        name=f"excl_{vs[i].name}_{vs[j].name}",
                    )
                )

    # slot preferences per (resource, event) variable
    for (e, r), v in variables.items():
        prefs = np.array(
            [rnd.uniform(0, args.value_range) for _ in range(n_slots)],
            dtype=np.float32,
        )
        dcop.add_constraint(
            NAryMatrixRelation([v], prefs, name=f"pref_{v.name}")
        )

    # one agent per resource (it owns that resource's variables)
    dcop.add_agents(
        [
            AgentDef(f"a{r:03d}", capacity=args.capacity)
            for r in range(args.resources_count)
        ]
    )
    dcop.dist_hints = _hints(by_resource)
    return dcop


def _hints(by_resource):
    from pydcop_tpu_torch.distribution.objects import DistributionHints

    return DistributionHints(
        must_host={
            f"a{r:03d}": [v.name for v in vs]
            for r, vs in by_resource.items()
        }
    )
