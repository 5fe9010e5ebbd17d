"""An external algorithm plugin in the port's form: greedy best response
with two alternating parity classes, so that neighbours on a ring never
move together.  Deterministic: it draws nothing from ``gen``, so a run on
the card equals its run on the CPU.

Load it by a dotted name from ``sys.path``: copy this file to
``extlab/greedy.py`` beside an empty ``extlab/__init__.py`` and pass
``"extlab.greedy"`` as the algorithm (``solve``, ``--algo``, and the
agent processes of ``mode="process"``, which get the parent's path).
"""

import torch

from pydcop_tpu_torch.algorithms import _host_dsa
from pydcop_tpu_torch.ops.costs import local_cost_sweep

GRAPH_TYPE = "constraints_hypergraph"
algo_params = []


def init_state(problem, seed, params, batch=()):
    values = problem.init_idx.expand(batch + (problem.n_vars,)).clone()
    return {"values": values,
            "t": torch.zeros(batch, dtype=torch.int32, device=values.device)}


def step(problem, state, params, gen):
    values = state["values"]
    local = local_cost_sweep(problem, values)
    parity = torch.arange(problem.n_vars, device=values.device) % 2
    cand = torch.argmin(local, dim=-1).to(values.dtype)
    move = parity == (state["t"] % 2)[..., None]
    return {"values": torch.where(move, cand, values), "t": state["t"] + 1}


def messages_per_round(problem, params=None):
    return int(problem.neighbor_mask.sum())


def computation_memory(node):
    return len(node.neighbors)


def communication_load(node, neighbor_name):
    return 1.0


def build_computation(comp_def, seed=0):
    # the host runtimes: DSA-C with probability 1, the same greedy move
    return _host_dsa.build_computation(
        comp_def, seed=seed, variant="C", probability=1.0
    )
