"""pydcop_tpu_torch — the PyTorch/CUDA port of pydcop_tpu.

The JAX package ``pydcop_tpu`` is the reference; this package does the
same work with PyTorch on an NVIDIA GPU and imports nothing of it (nor
of jax).

- ``pydcop_tpu_torch.dcop`` / ``utils`` — the problem model and YAML
  format (copies of the JAX package's jax-free modules).
- ``pydcop_tpu_torch.ops`` — the problem compiler (DCOP → tensors),
  cost evaluation, the generic factor contraction, and the hand-written
  CUDA Max-Sum kernels (``ops/maxsum_kernels.py`` + ``csrc/``).
- ``pydcop_tpu_torch.algorithms`` — the registry and the algorithms.
- ``pydcop_tpu_torch.engine`` — the chunked batched round loop (with
  the restart axis), the memoized exact sessions and the solver service
  (``engine/service.py``: ``SolverService``, ``ServiceServer``,
  ``ServiceClient``).
- ``pydcop_tpu_torch.parallel`` — shard meshes: an ``n_shards``-compiled
  problem run over shards (one thread each, on one or several devices)
  whose exchange is one ``psum`` a round (``run_batched(mesh=...)``).
- ``pydcop_tpu_torch.api`` — ``solve`` / ``solve_compiled`` and the
  rest of the embedding API, with the service's names.
- ``pydcop_tpu_torch.interop`` — builds the port's objects from numpy
  leaves (how tests hand the JAX package's state across).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu`` on the CLI); without a CUDA device
and without that request they raise (``device.py``).
"""

__version__ = "0.1.0"
