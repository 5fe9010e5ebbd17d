"""Optimal factor-graph distribution as an ILP (FGDP).

Role-equivalent to ``pydcop/distribution/ilp_fgdp.py``: exact placement
of a factor graph's computations minimizing inter-agent communication
(edge load × route cost) under agent capacities.  The reference solves
it with pulp→CBC; here scipy/HiGHS (see ``_ilp``).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from pydcop_tpu_torch.distribution._cost import distribution_cost as _dc
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
        hosting_w=0.0,  # FGDP: pure communication objective
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
