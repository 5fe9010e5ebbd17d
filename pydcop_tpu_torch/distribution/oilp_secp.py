"""Optimal ILP SECP placement (reference: the ``oilp_secp_*``
distribution modules — fgdp/cgdp variants are covered by the one
``distribute`` since the graph model arrives as an argument).

Same mixed-integer program as ``ilp_compref`` (hosting +
communication·route objective, capacity constraints, HiGHS backend —
see ``_ilp``), with the SECP actuator pinning added as ``must_host``
constraints, so only factor/rule computations are free variables.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from pydcop_tpu_torch.distribution._cost import (  # noqa: F401  (re-export)
    RATIO_HOST_COMM,
    distribution_cost,
)
from pydcop_tpu_torch.distribution._ilp import solve_ilp_placement
from pydcop_tpu_torch.distribution._secp import secp_pins
from pydcop_tpu_torch.distribution.objects import Distribution, DistributionHints


def distribute(
    computation_graph,
    agentsdef: Iterable,
    hints: Optional[DistributionHints] = None,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
) -> Distribution:
    agents = list(agentsdef)
    pins = secp_pins(computation_graph, agents, hints)
    must_host = {}
    for comp, agent in pins.items():
        must_host.setdefault(agent, []).append(comp)
    pinned_hints = DistributionHints(
        must_host=must_host,
        host_with=hints.host_with_map if hints is not None else None,
    )
    return solve_ilp_placement(
        computation_graph,
        agents,
        pinned_hints,
        computation_memory,
        communication_load,
        comm_w=1.0,
        hosting_w=RATIO_HOST_COMM,
    )
