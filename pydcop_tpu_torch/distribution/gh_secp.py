"""Greedy SECP placement heuristic (reference: the ``gh_secp_*``
distribution modules — fgdp/cgdp variants are covered by the one
``distribute`` since the graph model arrives as an argument).

Actuator variable computations are pinned to their owning device agent
(``_secp.secp_pins``); the remaining factor/rule computations are then
placed greedily by the communication+hosting heuristic, exactly the
``heur_comhost`` rule, but starting from the SECP pinning.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from pydcop_tpu_torch.distribution._cost import (  # noqa: F401  (re-export)
    distribution_cost,
)
from pydcop_tpu_torch.distribution._secp import secp_pins
from pydcop_tpu_torch.distribution.heur_comhost import (
    distribute as _heur_distribute,
)
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
    pinned_hints = DistributionHints(
        must_host=_pins_as_must_host(pins),
        host_with=hints.host_with_map if hints is not None else None,
    )
    return _heur_distribute(
        computation_graph,
        agents,
        hints=pinned_hints,
        computation_memory=computation_memory,
        communication_load=communication_load,
    )


def _pins_as_must_host(pins):
    out = {}
    for comp, agent in pins.items():
        out.setdefault(agent, []).append(comp)
    return out
