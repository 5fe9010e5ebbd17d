"""SECP (Smart Environment Configuration Problem) generator.

A copy of ``pydcop_tpu/commands/generators/secp.py``.  Role-equivalent
to the reference's ``generators/secp.py`` / ``generators/iot.py``: the
smart-lighting scenario from the SECP papers.
Lights are dimmable actuators (variables, levels 0..k); *models* are
target light levels for zones, expressed as n-ary constraints over the
lights reaching the zone (cost = |weighted level sum − target|); *rules*
are scene preferences pinning a light near a level (unary); each light
also pays an efficiency cost proportional to its level.
"""

from __future__ import annotations

import itertools
import random

import numpy as np

from pydcop_tpu_torch.commands.generators._common import write_dcop


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "secp", help="generate a smart-lighting SECP DCOP"
    )
    p.add_argument("--nb_lights", "-l", type=int, required=True)
    p.add_argument("--nb_models", "-m", type=int, required=True)
    p.add_argument("--nb_rules", "-r", type=int, required=True)
    p.add_argument(
        "--light_levels", type=int, default=5,
        help="dimmer resolution (domain size)",
    )
    p.add_argument(
        "--model_arity", type=int, default=3,
        help="max lights per model zone",
    )
    p.add_argument(
        "--zone_size", type=int, default=0,
        help="locality window: each model draws its lights from a "
        "window of this many consecutive lights (0 = anywhere). "
        "Bounds the constraint graph's treewidth the way physical "
        "rooms do — required for exact DPOP at scale",
    )
    p.add_argument(
        "--zone_layout", choices=["random", "tiled", "overlap"],
        default="random",
        help="'random': zone windows start anywhere (overlapping "
        "windows chain the whole building into one deep band); "
        "'tiled': windows align to disjoint zone_size blocks — "
        "independent rooms, giving the wide shallow pseudo-forest "
        "that DPOP's level-synchronous UTIL batching exploits "
        "(docs/performance.md, 'Level-synchronous DPOP'); "
        "'overlap': windows slide by zone_size - zone_overlap so "
        "every consecutive pair of zones SHARES zone_overlap lights "
        "— an open-plan floor whose chained zones drive the induced "
        "width up with the overlap degree, the workload the "
        "memory-bounded planner (--max_util_bytes, "
        "docs/semirings.md) exists for; tiled zones are deliberately "
        "shallow and can never exercise it",
    )
    p.add_argument(
        "--zone_overlap", type=int, default=0,
        help="(zone_layout=overlap) lights shared by consecutive "
        "zone windows (0 = half the zone).  More overlap = wider "
        "separators = exponentially bigger UTIL tables",
    )
    p.add_argument(
        "--efficiency_weight", type=float, default=0.1,
        help="unary cost per emitted light level",
    )
    p.add_argument(
        "--hard_cap", type=float, default=0.0,
        help="over-illumination HARD cap: a model window whose "
        "level sum exceeds hard_cap x its target costs +inf "
        "(infeasible), not just |sum - target| — the power-budget "
        "rule of real lighting deployments.  Must be > 1 when set "
        "(0 = off, all-soft costs).  Hard caps give the "
        "branch-and-bound pruned kernels (--bnb, docs/semirings.md "
        "'Branch-and-bound pruning') their bite: jointly-infeasible "
        "and provably-over-budget separator rows prune in-kernel, "
        "which single-part consistency pruning "
        "(ops/membound.py:prune_plan) cannot see",
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

    rnd = random.Random(args.seed)
    levels = args.light_levels

    dcop = DCOP(
        f"secp_{args.nb_lights}l_{args.nb_models}m_{args.nb_rules}r",
        objective="min",
        description="SECP smart lighting, seed %d" % args.seed,
    )
    lum = Domain("lum", "luminosity", list(range(levels)))

    lights = []
    for i in range(args.nb_lights):
        v = Variable(f"l{i:04d}", lum)
        lights.append(v)
        dcop.add_variable(v)
        # efficiency: cost grows with emitted level
        cost = np.arange(levels, dtype=np.float32) * args.efficiency_weight
        dcop.add_constraint(
            NAryMatrixRelation([v], cost, name=f"eff_{v.name}")
        )

    max_level = levels - 1
    zone = int(getattr(args, "zone_size", 0) or 0)
    hard_cap = float(getattr(args, "hard_cap", 0.0) or 0.0)
    if hard_cap and hard_cap <= 1.0:
        raise ValueError(
            f"hard_cap={hard_cap} must be > 1 (it multiplies the "
            "model target; at <= 1 the cap would outlaw the target "
            "itself)"
        )
    for m in range(args.nb_models):
        arity = rnd.randint(1, min(args.model_arity, args.nb_lights))
        if zone and zone < args.nb_lights:
            layout = getattr(args, "zone_layout", "random")
            if layout == "tiled":
                # disjoint rooms: windows snap to zone_size blocks;
                # ceil so a non-divisible nb_lights puts the tail
                # lights in a final short room instead of leaving
                # them model-free
                n_blocks = -(-args.nb_lights // zone)
                start = rnd.randrange(n_blocks) * zone
            elif layout == "overlap":
                # chained zones: window m slides by stride =
                # zone - overlap, so consecutive zones share exactly
                # `overlap` lights — every shared light sits in two
                # zones' separators and the chain's induced width
                # grows with the overlap degree (deterministic
                # anchors per model index; the scope draw below
                # stays seeded-random inside the window).  Anchors
                # CYCLE over the fixed lattice 0, stride, 2·stride…
                # instead of wrapping mid-stride: model counts past
                # one full sweep of the strip revisit the SAME
                # chain of windows (a raw (m·stride) % span would
                # drift the anchors by a few lights per wrap and
                # consecutive zones at the seam would share
                # nothing).
                overlap = int(
                    getattr(args, "zone_overlap", 0) or 0
                ) or zone // 2
                if not 0 < overlap < zone:
                    raise ValueError(
                        f"zone_overlap={overlap} must be in "
                        f"[1, zone_size={zone}) — equal windows "
                        "never advance, and a non-positive overlap "
                        "is not an overlap"
                    )
                stride = zone - overlap
                span = args.nb_lights - zone + 1
                n_anchors = (span - 1) // stride + 1
                start = (m % n_anchors) * stride
            else:
                start = rnd.randrange(args.nb_lights - zone + 1)
            pool = lights[start : start + zone]
            scope = rnd.sample(pool, min(arity, len(pool)))
        else:
            scope = rnd.sample(lights, arity)
        target = rnd.uniform(0.3, 1.0) * arity * max_level
        shape = (levels,) * arity
        matrix = np.zeros(shape, dtype=np.float32)
        for idx in itertools.product(range(levels), repeat=arity):
            s = sum(idx)
            if hard_cap and s > hard_cap * target:
                matrix[idx] = np.inf
            else:
                matrix[idx] = abs(s - target)
        dcop.add_constraint(
            NAryMatrixRelation(scope, matrix, name=f"mod{m:03d}")
        )

    for r in range(args.nb_rules):
        light = rnd.choice(lights)
        wanted = rnd.randrange(levels)
        cost = np.abs(
            np.arange(levels, dtype=np.float32) - wanted
        )
        dcop.add_constraint(
            NAryMatrixRelation([light], cost, name=f"rule{r:03d}")
        )

    # one agent per light, as in the IoT deployment story
    dcop.add_agents(
        [
            AgentDef(
                f"a{i:04d}",
                capacity=args.capacity,
                default_hosting_cost=10.0,
                hosting_costs={lights[i].name: 0.0},
            )
            for i in range(args.nb_lights)
        ]
    )
    return dcop
