"""Distribution (computation → agent placement) strategies; copies of
the modules of ``pydcop_tpu/distribution/``.

Role-equivalent to ``pydcop/distribution/``: each strategy module
exports ``distribute(computation_graph, agentsdef, hints,
computation_memory, communication_load) -> Distribution`` and
``distribution_cost(...) -> (total, comm, hosting)``.
"""

from __future__ import annotations

import importlib
import pkgutil
from typing import List

from pydcop_tpu_torch.distribution.objects import (  # noqa: F401
    Distribution,
    DistributionHints,
    ImpossibleDistributionException,
)

_PACKAGE = "pydcop_tpu_torch.distribution"


def load_distribution_module(name: str):
    """Import a distribution strategy module by name."""
    if name.startswith("_") or name == "objects":
        raise ValueError(f"Unknown distribution method {name!r}")
    try:
        mod = importlib.import_module(f"{_PACKAGE}.{name}")
    except ImportError as e:
        raise ValueError(
            f"Could not load distribution {name!r}: {e}; available: "
            f"{list_available_distributions()}"
        ) from e
    if not hasattr(mod, "distribute"):
        raise ValueError(f"{name!r} is not a distribution method")
    return mod


def compute_distribution(
    distribution,
    graph,
    agent_defs,
    *,
    hints=None,
    algo_module=None,
    computation_memory=None,
    communication_load=None,
) -> Distribution:
    """Run a distribution strategy — the one shared invocation ritual
    (used by the distribute CLI, the dynamic engine, and the host
    runtime, which would otherwise each copy it).

    ``distribution`` is a strategy name or an already-imported
    strategy module.  Footprint callbacks default to the algorithm
    module's ``computation_memory``/``communication_load`` when an
    ``algo_module`` is given; explicit callbacks win.
    """
    mod = (
        load_distribution_module(distribution)
        if isinstance(distribution, str)
        else distribution
    )
    if computation_memory is None and algo_module is not None:
        computation_memory = getattr(
            algo_module, "computation_memory", None
        )
    if communication_load is None and algo_module is not None:
        communication_load = getattr(
            algo_module, "communication_load", None
        )
    return mod.distribute(
        graph,
        agent_defs,
        hints=hints,
        computation_memory=computation_memory,
        communication_load=communication_load,
    )


def list_available_distributions() -> List[str]:
    import pydcop_tpu_torch.distribution as pkg

    names = []
    for info in pkgutil.iter_modules(pkg.__path__):
        if info.name.startswith("_") or info.name == "objects":
            continue
        try:
            mod = importlib.import_module(f"{_PACKAGE}.{info.name}")
        except ImportError:
            continue  # an unimportable strategy must not hide the rest
        if hasattr(mod, "distribute"):
            names.append(info.name)
    return sorted(names)
