"""``pydcop_tpu_torch worker`` (port of ``pydcop_tpu/commands/worker.py``)
— internal: one elastic-runtime SPMD worker.

Spawned by the elastic orchestrator/agent supervisors
(``infrastructure/elastic.py``); not intended for direct use.  The
worker connects to the orchestrator's control port, receives its
epoch's deployment, joins the epoch's ``torch.distributed`` process
group on ``--device``, and solves in lockstep until the epoch ends
(result/halt) or is killed by its supervisor at a reform.
"""

from __future__ import annotations


def set_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "worker",
        help="internal: elastic-runtime SPMD worker (spawned by the "
        "elastic orchestrator/agent, see orchestrator --elastic)",
    )
    p.add_argument("--orchestrator", required=True, metavar="HOST:PORT")
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument(
        "--device", default="cuda",
        help="where this worker's shard runs: 'cuda' (default: the card "
        "process-id modulo the card count; the worker fails when there "
        "is none), 'cuda:<k>' or 'cpu'",
    )
    p.add_argument(
        "--store-fd", type=int, default=None,
        help="an inherited listening socket to serve the epoch's "
        "process-group store on (the rank-0 worker)",
    )
    p.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    from pydcop_tpu_torch.infrastructure.elastic import run_worker

    return run_worker(args.orchestrator, args.epoch, args.process_id,
                      device=args.device, store_fd=args.store_fd)
