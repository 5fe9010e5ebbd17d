"""ILP distribution over computation-memory + communication-load.

Role-equivalent to ``pydcop/distribution/ilp_compref.py``: exact
placement minimizing the weighted sum of communication (edge load ×
route) and hosting costs under capacity constraints — the same
objective ``distribution_cost`` evaluates, solved to optimality.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from pydcop_tpu_torch.distribution._cost import (
    RATIO_HOST_COMM,
    distribution_cost as _dc,
)
from pydcop_tpu_torch.distribution._ilp import solve_ilp_placement
from pydcop_tpu_torch.distribution.objects import Distribution, DistributionHints


def distribute(
    computation_graph,
    agentsdef: Iterable,
    hints: Optional[DistributionHints] = None,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
) -> Distribution:
    return solve_ilp_placement(
        computation_graph,
        agentsdef,
        hints,
        computation_memory,
        communication_load,
        comm_w=1.0,
        hosting_w=RATIO_HOST_COMM,
    )


def distribution_cost(
    distribution,
    computation_graph,
    agentsdef,
    computation_memory=None,
    communication_load=None,
):
    return _dc(
        distribution,
        computation_graph,
        agentsdef,
        computation_memory,
        communication_load,
    )
