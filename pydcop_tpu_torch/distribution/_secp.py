"""Shared SECP-placement pinning logic.

The SECP deployment papers' premise (reference: the ``gh_secp_*`` /
``oilp_secp_*`` modules under ``pydcop/distribution/``): actuator
*variable* computations are physically tied to the device that owns
the actuator — only factor/rule computations are free to place.  The
owner is identified as the unique agent with a zero hosting cost for
the computation (the SECP generator encodes ownership exactly this
way); explicit ``must_host`` hints take precedence.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from pydcop_tpu_torch.distribution.objects import (
    DistributionHints,
    ImpossibleDistributionException,
)


def secp_pins(
    computation_graph,
    agentsdef: Iterable,
    hints: Optional[DistributionHints],
) -> Dict[str, str]:
    """computation name → pinned agent name for actuator variables."""
    agents = list(agentsdef)
    pins: Dict[str, str] = {}
    if hints is not None:
        for agent_name, comps in hints.must_host_map.items():
            for comp in comps:
                pins[comp] = agent_name

    for node in computation_graph.nodes:
        if node.name in pins:
            continue
        if not _is_variable_node(node):
            continue
        owners = [
            a.name for a in agents if a.hosting_cost(node.name) == 0
        ]
        if len(owners) == 1:
            pins[node.name] = owners[0]
        elif not owners:
            raise ImpossibleDistributionException(
                f"SECP placement: variable computation {node.name!r} "
                "has no owning agent (no agent hosts it at cost 0 and "
                "no must_host hint names it)"
            )
        # several zero-cost agents: genuinely free — leave unpinned
    return pins


def _is_variable_node(node) -> bool:
    """Variable computations are pinned; factor computations are free."""
    return hasattr(node, "variable")
