#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (``pydcop_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero; nothing is
caught and passed over).  Phases 1-9 run one after another.  Then five
child processes on the same card, running phases 14-16, phases 17-18,
phase 19, phase 20 and phase 22, start beside phases 10-13 (host Python,
most of all twelve): their lines follow phase 13's, and a child's
failure fails the script.  Phase 21 runs after them, alone, in a sixth
child process.

1. Device and build: the card's name and power limit, then the port's
   CUDA kernels built from ``pydcop_tpu_torch/csrc`` with nvcc, and one
   ``ptxas`` line per kernel instance, factor kernels and q update
   (registers, stack frame, spills): any instance with a stack frame or
   a spill fails.
2. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes (f32 and bf16 messages, f32 and bf16 tables, a
   ragged width, strided row views, a NaN input, domains past 64 for
   the q update, the q update with every operation rounded to bf16),
   and the factor kernels' lane-tile instance (every d outside
   {2, 3, 4, 5, 8}) at d = 1, 6, 7, 10, 16, 32, 64 and 257 lanes, d = 10
   at 299,988 lanes and d = 16, 32, 64 at 100,000, each with f32 and
   bf16 messages and tables as strided row views, and a NaN input.  The
   q update also in its gathered form (the belief read through the
   edge index, as ``maxsum.step`` calls it) at coloring-10k, coloring-1M
   and the d-10 cells' shape, with f32 and bf16 messages, a bf16 belief,
   ``per_op`` and NaN, and its generic instance at d = 65 to 20,000 (in
   registers up to 128, staged in shared memory past it).  Outputs must
   be bit-equal (the kernels are built without FMA contraction).  One
   line per kernel and shape: the instance (unrolled, or the lane tile
   with its warps, row groups or lanes), kernel and plain device times
   (20 calls captured in one CUDA graph, the replay timed with CUDA
   events, median of 10 replays, divided by 20: no host launch cost in
   it), the host launch interval (CUDA events around 10 eager calls),
   the bound (bytes over 3.35 TB/s, or f32 operations over 67 TFLOP/s,
   whichever is larger), the share of it reached and the launches made;
   a gathered q-update row adds the device time of the separate gather
   the step made before (``gather_ms``: the cast to the message dtype
   and ``index_select``) and of that gather followed by the identity
   form (``two_pass_ms``).
3. Max-Sum on the 10k-variable 3-colour coloring (the benchmark
   workload: damping 0.5, 1024 rounds, chunk 256, cost sampled every 8
   rounds) through ``api.solve_compiled``: the shared-table factor and
   q-update kernels must be launched exactly once per round.  msgs/s =
   2·n_real_edges·rounds over the engine's time (``result["time"]``,
   which leaves out turning the assignments into dicts); the wall time
   around the call is printed beside it.  Then 256 rounds on the card
   and on the CPU through the port: q, r, values and cost traces
   bit-equal (``ops/costs.py`` sums in one order on every device); the
   same for 64 rounds with bf16 messages, and for
   64 rounds with bf16 tables (the kernels launched once per round), and
   for 64 rounds with bf16 tables and a ternary bucket added (outside
   the factor-kernel gate: the q update kernel, launched once per round,
   rounds every operation to bf16, as the JAX package computes there).
   A torch.profiler pass over 32 rounds gives device time by kernel and
   the device's idle share; a ``cost-sum`` line times one cost
   evaluation (``total_cost``'s fixed-order sum) against ``torch.sum``
   of the same cells.
4. The same with per-factor 5x5 tables at 100k variables (the
   per-factor factor kernel; card vs CPU also with bf16 tables), with a
   profiler pass over 16 rounds.
5. Max-Sum at d = 10, the lane-tile instance on the main path: the
   100k-variable 10-colour instance (phase 4's scopes) with one random
   10x10 table per constraint (per-factor-100k-d10) and with the shared
   identity table (coloring-100k-d10), 64 rounds each through
   ``api.solve_compiled`` (64 launches of its factor kernel, 64 q
   updates, none of the other factor kernel), msgs/s and peak device
   memory; 32 rounds card vs CPU (per-factor also with bf16 tables, 16
   rounds); a profiler pass over 16 rounds.
6. The 1M-variable coloring: 256 rounds, msgs/s and peak device
   memory; 4 rounds card vs CPU; a profiler pass over 16 rounds; a
   ``cost-sum`` line as in phase 3.
7. The local-search family and A-Max-Sum.  Full width: each of the eight
   algorithms through ``api.solve_compiled`` on the 1M coloring (DSA-B
   and MGM-2 256 rounds, the others 32; chunk 256, cost every 8), launch
   counts set to 0 just before each run and read just after (A-Max-Sum
   must launch the shared factor kernel and the q update once per round,
   the others no kernel), msgs/s under each algorithm's own
   ``messages_per_round``, engine and wall time, peak device memory, the
   size of MGM-2's pair accumulator, and a profiler pass over 16 rounds
   for DSA-B and MGM-2.  Card vs CPU: 32 rounds of each algorithm's
   ``apply`` on both devices from one state with the same CPU-made draws,
   on the 10k coloring (and, for MGM-2 and A-Max-Sum, the 100x100 Ising
   grid): every state leaf bit-equal, A-Max-Sum's kernel launches pinned
   at one of each per round (the shared-table kernel on the coloring,
   the per-factor one on the grid).  Then the repo's benchmark
   configurations 1 and 2 with restarts (``bench_configs.py``, built as
   the JAX package builds them, with the port's copies of the
   generators): DSA-B on a 50-variable coloring with K=64 and MGM-2 on
   the 32x32 Ising torus with K=8, 1024 rounds, chunk 256: msgs/s over all restarts' messages, the
   best cost and the K restart costs, and a profiler pass over 32 rounds
   each.
8. Exact DPOP (``api.solve(dcop, "dpop", …)``, the pseudo-tree on the
   host, the UTIL joins on the card; no hand kernel on this path: the
   contraction is eager PyTorch, as the JAX package's is XLA).
   ``dpop-hubtree-d24``: the repo's configuration 6 (3 hubs, 45 leaves,
   d = 24) at ``util_device: auto``, cold and warm on the card, on the
   CPU through the port and on the host in f64 (``util_device: never``):
   equal assignments and costs, equal UTIL counts card and CPU, some
   joins on the card; each dispatch's joined shape, stack height and
   host time, util-cells/s, peak device memory and a profiler pass.
   Then the min-sum contraction on the card against its CPU run, bit for
   bit, at the hubtree's dispatch shapes (random parts) and on the tie,
   -0.0, +inf-row, NaN and d = 1 rows of the tests, each with its device
   time and bound.  ``dpop-secp-768-tiled``: ``bench.py``'s
   config4_dpop_secp stage (768 lights, zone 8 tiled, seed 7) with
   ``pad_policy="pow2"`` and ``util_device: always``, level and node
   dispatches, each against the port's CPU run: equal results,
   util-cells/s and dispatch counts, a profiler pass.
9. Restarts, instances and the kernels' batch axis (B = instances x
   restarts in one launch).  9a: each kernel's batched instance on the
   card against its batched plain version and against B unbatched
   launches, bit for bit, with its device time, the plain version's, the
   B launches' and the bound, each timed cold: the inputs rotate through
   copies that together exceed 256 MiB, five times the L2, so a time is
   held against HBM's rate (a row faster than its bound fails).  The
   shapes: configuration 3's (d 3, B 8, one per-factor table for all
   batches; the q update with one edge index), 8 coloring-10k instances
   (stacked shared tables, and at the pow2 shape stacked per-factor
   tables; the q update with per-instance edge indices and damping),
   per-factor-100k-d10 at B 2 (the lane tiles).
   9b ``config3-scalefree1k-maxsum-K8``: ``bench_configs.py:41-51``'s
   scale-free coloring from the port's generator, Max-Sum best of 8,
   1024 rounds, chunk 256: msgs/s over all restarts, the best and the 8
   restart costs, one launch of each kernel a round, card = CPU bit for
   bit over 256 rounds, a profiler pass.  9c
   ``config5-meeting10k-maxsum``: ``bench_configs.py:109-118``'s PEAV
   meeting scheduling at full size (10,000 variables, d 8), 512 rounds,
   chunk 128, the kernel instances it runs, card = CPU over 64 rounds, a
   profiler pass.  9d ``many-coloring-dsaB-K{1,8,32}``:
   ``bench.py:82-94``'s stage (4 colorings of 26-32 variables, seeds
   100-103, DSA-B p 0.7, 64 rounds (256 there), chunk 64, pow2, seeds
   0..K-1):
   instances/s of ``api.solve_many`` against sequential solves.  9e
   ``many-coloring10k-maxsum-I8``: 8 different coloring-10k graphs in
   one group: phase 3's and seven rewirings of it by degree-preserving
   edge swaps (seeds 2-8, so every variable keeps its degree and the
   group key), each with its own noisy unary costs, through
   ``solve_many`` (pow2, 1024 rounds, the cost sampled every round as
   ``solve_many`` does): msgs/s against phase 3's; over 128 rounds
   every result key of each instance (assignments, costs,
   cost trace) equal to its sequential solve; the same for the unpadded
   group (stacked shared tables with per-instance weights, damping
   0.50-0.85); 32 rounds of DSA-B's ``apply`` on the group's disjoint
   union with per-instance probabilities, card against CPU on shared
   draws; a profiler pass.  Then per-factor-100k-d10 with 2 restarts
   (the lane tiles batched) and card = CPU.  9f ``many-secp-dpop-K8``:
   ``bench.py:121-133``'s 8 SECP instances through ``solve_many``
   against sequential solves: equal results and ``util_dispatches``.
10. Exact inference (``api.infer``/``infer_many``: the plan and the
   certificates on the host, the stacked contractions on the card, eager
   PyTorch as the JAX package's are XLA).  Each query runs twice on
   the card (the warm run's seconds, cells/s, dispatches, device nodes, peak
   device memory, the telemetry counters), once with the port on the CPU
   (skipped where the card run dispatched nothing: the same host
   computation) and once in host f64 (``device="never"``).  Gates: map
   and kbest assignments, costs and lists equal on all three; log_z,
   every marginal and ``e_cost`` within the card's ``error_bound``
   (+1e-9) of host f64; the counts (``cells``,
   ``dispatches``, ``device_nodes``, ``host_nodes``, ``width``) and
   counters equal card and CPU.  ``infer-tree10k``: ``bench.py:946-969``'s
   10,000-variable coloring tree, log_z, marginals, map, kbest:5 and
   expectation at ``device="auto"``, log_z at ``"always"``; map cost =
   the port's DPOP cost, the kbest list ascending, distinct and led by
   map, expectation's log_z = log_z's.  ``infer-secp192-tiled``: the
   semiring_infer stage's SECP (``bench.py:1046-1056``) at ``"always"``,
   ``device_min_cells=256``, pow2: log_z (``tol=inf``), map, and kbest:5
   and expectation (the tree's tables are too small for the card).
   ``infer-hubtree-d24``: phase 8's instance, map at ``"auto"``, log_z
   and marginals at ``"always"``, ``tol=inf`` (the logsumexp stack at 44 x
   24^4 cells), and a profiler pass: the contraction's device time
   against the bound of the run's dispatches, and the eager kernel
   launches behind those dispatches.  ``infer-many-secp192-I4``:
   the SECP at seeds 7-10 through ``infer_many``: each instance equal to
   its sequential ``infer`` in every key but time, ``instances_batched``
   and ``telemetry``, fewer dispatches than the sequential runs, counts
   and telemetry counters equal to the CPU's.  Then one ``contraction-<semiring>`` row per
   semiring run on the card: its largest dispatch shape of the phase on
   random parts, card against CPU, its time (CUDA events around eager
   calls) beside the bound and the dispatches (not kernel launches) of
   the phase's card runs.
11. The rest of the semiring core: the bf16/int8 UTIL packs, the
   memory-bounded sweep (``max_util_bytes``), sparse COO tables and
   SyncBB (eager PyTorch on the card, as the JAX package's joins are XLA;
   no hand kernel).  Each line carries its numbers; every gate below
   fails the script.  11a ``packs``: ``bench.py``'s precision-stage SECP
   (384 lights, zone 8 tiled, seed 7) through DPOP at ``always``,
   ``level``, pow2, at f32, bf16 and int8: cost and assignment equal
   across the dtypes and to host f64, the card equal to the port's CPU
   run in the UTIL counts, ``semiring.precision_repairs`` and
   ``semiring.int8_requant``, util-cells/s per dtype; log_z of the
   semiring_infer SECP at bf16 (``always``, ``device_min_cells`` 256,
   ``tol`` inf) within its ``error_bound`` + 1e-9 of host f64 and map at
   bf16 equal to f32, every SECP cell keeping device joins; phase 8's
   hub tree at each dtype (its uniform tables send every bf16/int8 leaf
   join to the host, printed as ``all_host_fallback``), the planted hub
   tree (one planted value per leaf, margins the bf16 certificate
   passes) at each dtype equal to host f64 and to the CPU run in its
   counts, with at least the 44-leaf stack's device joins kept; in a child
   process of its own (the profiler loses events late in a long
   process) the host-to-device copies of one warm run at each dtype
   (profiler events) beside the 44 x 24^4 leaf stack's part bytes and a
   CUDA-event timing of one pageable copy of those bytes.  11b ``bounded``: the membound
   stage's overlap SECP (96 lights, zone 8, overlap 5, arity 5, 4
   levels) at ``max_util_bytes`` 16,384: equal to the bounded host-f64
   run, the unbounded card run and the CPU run (counts and counters);
   log_z under the same budget within its bound; the control instance
   (64 models, zone 7, overlap 3, arity 4) budgeted at 2,048 against
   unbounded; the hub tree at 4·24^3 bytes (a d-24 variable cut, at
   least 24 lanes on the card) equal to its unbounded run.  11c ``oom``
   (in the same child process, so the cap is set above a fresh
   allocator): a d-64 hub tree planned at 128 MiB (no cut) under a
   caching allocator capped (``set_per_process_memory_fraction``) 40
   MiB above what the process holds, below one 67 MB leaf join:
   ``membound.replans`` >= 1 and the result equal to the uncapped run;
   the cap is restored after.  11d ``sparse``: the sparse
   stage's task scheduling (26 tasks, 10 slots, window 6, stride 5,
   density 0.2, seed 11) at ``table_format`` sparse and dense against
   host f64, the card equal to the CPU in every ``semiring.sparse_*``
   counter, the window tables' +inf fraction, the peak device memory
   of one sparse and one dense run (``max_memory_allocated``); the bnb stage's
   hard-capped overlap SECP sparse against dense; log_z at sparse within
   its bound.  11e ``syncbb``: configuration 4's SECP at 10 lights,
   equal to DPOP's optimum and the CPU run.  11f (in the child process,
   before 11c): the min-sum contraction at bf16 and int8 at the hub
   tree's leaf stack and the sparse min-sum and logsumexp joins at
   their largest dispatch of the task scheduling's DPOP and log_z,
   card against CPU, CUDA events around 5 eager calls, the bound (bytes
   read and written once over 3.35 TB/s; for sparse, the rows' real
   candidates, segments and packed values) and the eager kernel launches
   of one call (torch.profiler).
12. Branch-and-bound pruning (``bnb``) and checkpoint/resume, one JSON
   line a cell; any gate below fails the script.  12a: the bnb stage's
   hard-capped overlap SECP (``bench.py:245-268``: 28 lights, 18
   models, 8 rules, 10 levels, zone 8, overlap 5, arity 5, cap 1.02,
   seed 11; pow2, ``always``) through DPOP at bnb on, auto and off: each
   equal to host f64, the card equal to the CPU in its counts and every
   ``semiring.*``/``dpop.*`` counter, some cells pruned and some buckets
   through the compact host pass 2 at on; the pruned fraction and
   util-cells/s on against off (interleaved, median of 3).  12b: phase
   8's hub tree at f32, bf16 and int8 (``auto``: the default, which now
   prunes its leaf stack) against ``off`` once as the control, and cut
   at 4·24^3 bytes, each equal to host f64 (f32 auto also to the CPU in
   its counters, the cut's plan unchanged by pruning); map at auto and
   off equal to host f64; log_z and marginals at bnb on and off within
   ``error_bound`` + 1e-9 of host f64, card equal to CPU in counts and
   counters; then the pruned
   min-sum and logsumexp contractions at the hub's largest dispatch on
   random parts (a budget per stack row near its median bound): card
   against CPU, CUDA events around eager calls beside the unpruned
   kernel on the same inputs, and the bound.  12c: the sparse stage's
   task scheduling at bnb on, sparse and dense, each equal to host f64
   and to the CPU's counters.  12d: the membound SECP at 16,384 bytes
   with bnb on equal to its unbounded run, the plan unchanged.  12e:
   Max-Sum on phase 3's binary + ternary instance (outside the
   factor-kernel gate) with bnb on, bit-equal to off over 64 rounds,
   the q update launched once a round.  12f: checkpoint/resume: the
   coloring-10k Max-Sum (512 rounds, chunk 256) saved at 256 and
   resumed, on the card and on the CPU, config5-meeting10k-maxsum (256
   rounds, chunk 128) saved at 128, and DSA-B with 8 restarts on the
   coloring-10k (256 rounds, chunk 64) saved at 128: q, r, values,
   best cost, restart costs and cost trace bit-equal to the
   uninterrupted run, each kernel launched once a round in each half
   (counts set to 0 just before each half); one save and one load of
   the coloring-1M Max-Sum state, its bytes and seconds.
13. The supervised device dispatch (``engine/supervisor.py``) and
   Max-Sum's ``belief="blockdiag"``, one JSON line a cell; any gate
   below fails the script.  13a: phase 3's coloring-10k Max-Sum (1024
   rounds, chunk 256, cost every 8) under ``device_transient=0.2``,
   chaos seed 6 (seed 1 draws no fault in 4 chunks), ``retry_budget=4``: q, r, values, best cost and cost
   trace bit-equal to the run without injection, ``engine.retries`` and
   ``fault.device_transient`` equal to the port's CPU run of the same
   spec (its 4 dispatches at 8 rounds each); the supervision overhead
   at coloring-10k (512 rounds) and coloring-1M (256): engine seconds
   with the default supervisor against ``UNSUPERVISED``, 2 interleaved
   pairs, and the
   wrapper's own host microseconds per chunk (dispatch, the generator's
   get/set, the NaN screen) over the chunk's time.  13b: the same run under
   ``device_oom=-:64``: two chunk halvings (256, 128, 64), bit-equal; at
   ``chunk_floor=128`` it raises ``UnrecoverableDeviceError`` and its
   final checkpoint resumes to the uninterrupted run.  13c: phase 9e's 8
   graphs through ``solve_many`` (pow2, 1024 rounds) under
   ``device_oom=2``: 3 splits (8, 4+4, 2+2+2+2), each kernel launched
   once a round in each of the 4 final groups, every instance equal to
   the uninjected group's, the counters equal to the CPU run's (8
   rounds: the splits fire on the first dispatch); then, in a child
   process, the 8 graphs with 8 restarts each (B 64, 64 rounds) under a
   caching allocator capped at a half's peak plus half the group's
   stacked problem (below the whole group's peak): a real
   ``torch.cuda.OutOfMemoryError`` answered by a split, which frees the
   group's stacked tensors before its halves run, every instance equal
   to the uncapped run.  13d: the group under
   ``nan_inject=1:3``: lane 3 ``degraded`` with its last finite best,
   the other 7 equal to the uninjected group, ``on_numeric_fault=
   "raise"`` raising; one coloring-10k run under ``nan_inject=1``
   degraded, with no final checkpoint.  13e: phase 8's hub tree under
   ``device_oom=8`` (its leaf stack goes per node) equal to the
   uninjected run, its counts and counters equal to the CPU run's; the
   membound SECP (11b) under ``device_oom_bytes`` at half its planned
   table: re-planned, equal to the CPU run in result and ``membound``
   block.  13f: ``belief="blockdiag"`` at coloring-10k: 256 rounds, each
   one step on the card and on the CPU from the card's state, q within
   1e-5; the 256-round best cost equal card and CPU; the kernels once a
   round; at coloring-1M the belief alone (5 calls in one CUDA graph)
   blockdiag against the slot gathers with the one-hot's bytes, a
   profiled stretch of 16 rounds in each mode, 256 rounds through the
   engine.
14. The dynamic path (``engine/dynamic.py:run_dynamic``), one JSON line
   a cell, on the dynamic-coloring10k-sensors cell: phase 9's coloring
   (10,000 variables, seed 1) with 200 external sensors, 100 ``track_k``
   constraints (unary after slicing) and 100 ternary ``pair_k``
   constraints (per-factor binary rows after slicing), Max-Sum (damping
   0.5) over 100 agents ``a00…a99`` placed by ``adhoc`` (each agent's
   capacity 2.03 shares of the factor graph's footprint; ``a13`` and
   ``a14`` share a cheap route, so each holds the other's replicas),
   ``final_rounds=256``, ``rounds_per_second=320``, chunk 64.  The
   scenario: settle; one event setting 50 sensors; a delay of 0.8 s;
   ``a07`` leaves; a delay of 0.4 s; ``a13`` and ``a14`` leave in one
   event; ``a100`` joins; a delay of 0.4 s; the final settle.  14a, at
   ``k_target=1``: the card run equals the port's CPU run of the same
   call in assignment, cost, cost trace, events, carry count, lost
   computations, replicas and ``compile.*`` counters (at least one full,
   one incremental and one reused compile); every segment launches the
   per-factor factor kernel and the q update once a round (counts set
   to 0 before the call); ``a07``'s orphans all migrate and the rack's
   loss freezes variables; after the ``set_value`` event the patched
   tensors equal a fresh ``compile_dcop`` of the active problem, bit for
   bit.  It prints each compile's kind, seconds and patch bytes, each
   segment's engine seconds and msgs/s beside phase 3's, and the
   distribution, replica and repair host seconds.  14b, at
   ``k_target=2`` on ``a07``'s departure and a delay: a reparation DCOP
   solved on the card; every migrated computation lands on one of its
   live replica holders within capacity, and the card run equals the
   CPU run.
15. The rest of the CLI, driven in-process through the functions the
   commands call, one JSON line a cell; any gate below fails the script.
   15a ``batch-coloring10k-maxsum``: ``commands/batch.py:run_sweep`` on
   a dict spec (no YAML file to parse) whose one set names
   four coloring-10k DCOPs built in memory (phase 9's ``coloring_dcop(
   10_000, 3, 3, seed=s)``, seeds 1-4; ``iterations: 2``) and whose one
   batch is Max-Sum with ``damping: [0.5, 0.7]``, 64 rounds, chunk 64,
   ``pad_policy: pow2``: 16 runs, 8 cells.  Three passes, each into its
   own CSV, launch counts set to 0 just before each: sequential (16
   ``api.solve`` calls, each kernel 16 x 64 times), ``--vmap_cells``
   (one ``api.solve_many`` call and no ``solve``: no fallback; each
   kernel launched 64 times per group, the groups from the
   ``engine.batch_groups`` counter and the results'
   ``instances_batched``) and ``--vmap_iterations`` (8 ``solve`` calls
   with ``n_restarts=2``, each kernel 8 x 64 times).  Every row
   ``finished``, ``failed`` 0; the ``--vmap_cells`` rows equal the
   sequential rows in every column but ``time``, and equal the port's
   CPU run of the same ``--vmap_cells`` call; the same spec again into
   the same CSV executes 0 runs and skips 16.  It prints each pass's
   wall seconds, solves or groups and msgs/s (the rows' ``msg_count``
   over the pass's wall seconds) beside phase 3's msgs/s.  15b
   ``profile-coloring10k-maxsum``, in a child process (the profiler
   loses events late in a long process): the seed-1 coloring, Max-Sum 64
   rounds through ``api.solve`` inside ``commands/solve.py:profile``
   (what ``solve --profile DIR`` runs): one Chrome trace in the
   directory, parsed, with 64 ``factor_kernel`` and 64
   ``q_update_kernel`` events, the result equal to the unprofiled
   solve's; the trace's bytes, the engine seconds profiled and not, and
   the device busy share of the trace window (kernel events' time over
   the window).  15c ``trace-summary-coloring10k-maxsum``: the same
   solve (chunk 16) with ``trace=`` in JSONL and Chrome format on the
   card and in JSONL on the CPU, each read by the port's
   ``telemetry/summary.py``: span counts, events, faults, agents and
   counters equal card and CPU and across the two formats, and
   ``format_summary`` renders.
16. Serving (``engine/service.py``), in-process (DCOP objects, and
   JSON text, which PyYAML reads, where a text is needed), one JSON
   line a cell; any gate below fails the script and every wait has a
   timeout.  16a ``serve-coloring10k-maxsum-C32``: a ``SolverService``
   on the card (pow2 pads and instance buckets, ``max_batch`` 32,
   ``max_wait`` 0.05 s) inside a telemetry session with a JSONL trace;
   32 client threads behind one barrier, thread i submitting phase 15a's
   DCOP ``i % 4`` with seed ``i // 4`` (Max-Sum, damping 0.5, 256
   rounds, chunk 64): every result finished and equal, in every key but
   time and phases, to a solo ``api.solve_compiled`` of the same
   compiled problem on the card (4 compiles); ``service.requests`` 32,
   the dispatch spans' occupancy summing to 32 and, with their pads, to
   32 plus ``service.pad_instances``; the per-factor factor kernel and
   the q update each launched 256 times a dispatch, the shared factor
   kernel never; a 4-request subset (the first DCOP, seeds 0-3) equal
   on the port's CPU service;
   ``trace-summary``'s ``service: N requests / M dispatches`` block.  It
   prints ticks, dispatches, occupancy, requests/s, client p50/p99
   latency, the median of each ``phases`` segment and the sequential
   ``solve_compiled`` loop's seconds.  16b: a Max-Sum session on phase
   14's sensor coloring (64 rounds a segment) with 4 follow-ups of 50
   sensors each: compile counters 1 full and 4 incremental, each
   segment equal to a fresh ``api.solve`` of the DCOP at those values
   on the card, card equal to CPU in results and counters; an exact
   DPOP session (``util_device: always``) on ``tools/
   recompile_guard.py``'s delta tree (16 hubs x 256 leaves, 4,112
   nodes) with 6 one-delta follow-ups: equal to the memo-off session at
   every delta, at most 5% of the nodes re-contracted a follow-up,
   every counter equal card and CPU, the per-delta milliseconds of the
   three arms; ``InferSession`` ``log_z`` and ``map`` on the same tree
   within ``error_bound`` of (equal to) a fresh session.  16c: a session
   on a JSON-text sensor coloring (2,000 variables, 20 sensors) written
   to the session checkpoint by ``close()`` and replayed by
   ``SolverService(resume=True)``: the next follow-up incremental-only
   and equal to an undisturbed card service's; ``nan_inject`` on a tick
   of 8 (the first DCOP, seeds 0-7: one group) quarantines one request,
   its batchmates equal to 16a's fault-free results, and the flight
   dump names its trace id; a ``MetricsExporter`` scraped once (``service.requests``
   as the registry holds it) and ``/healthz`` reading ``draining`` and
   then ``drained`` across ``close()``.  16d: a ``ServiceServer`` on an
   ephemeral loopback port and a ``ServiceClient``: ping, stats,
   ``close_session``, a JSON-text solve, a malformed frame answered with
   the structured error on a link that survives, and ``shutdown``
   stopping the server within its timeout.
17. The host runtimes with compiled islands, and the serving fleet, on
   ``grid10k`` (``generate graph_coloring --graph grid -n 10000 -c 3
   --soft --noise 0.02 --seed 1`` built in memory: 19,800 binary
   constraints, d 3) with the three-agent split (rows 0-48 on the island
   ``a0``, rows 49-50 on the host agent ``a2``, rows 51-99 on the
   island ``a1``; each factor on the agent of its first variable).
   17a: Max-Sum (damping 0.5) in ``mode="sim"``, 10 rounds, seed 1, on
   the card and, at the same time in a child process, on the CPU (the
   child sees no card; its result comes back as JSON, whose floats
   round-trip exactly): equal in assignment, cost, final cost,
   message count and size and cost trace; the islands' factor-kernel
   and q-update launches (> 0), seconds, flushes and boundary messages.
   Then the boundary messages each island received in the card run are
   replayed into a fresh ``MaxSumIsland`` of ``a0`` (q pins on its
   shadow edges) and of ``a1`` (r folds into its unary rows), each built
   on the card and on the CPU (the noise is drawn on a CPU generator, so
   both hold the same): after the start burst and each of 4 flushes fed
   by those messages, ``r``, ``q``, ``values`` and the posted messages
   are bit-equal card and CPU; then a strong r message folded into one
   of ``a1``'s boundary variables must move its value, on both.
   17b: the same in ``mode="thread"`` on the card, stopped after 5 s,
   then under the seeded chaos plan ``drop=0.02,dup=0.02,reorder=0.02``
   (seed 7): a complete assignment whose cost is ``solution_cost``'s,
   and every ``(kind, link, seq)`` the chaos layers recorded is the
   plan's decision for that link and sequence number, none missing.
   17c: DSA-B (p 0.7) islands on the split's variables in ``mode="sim"``,
   the card and the CPU fed the same CPU-made draws: every result key
   equal.  17d: ``python -m pydcop_tpu_torch fleet --replicas 2 --device
   cuda`` (``--max_batch 8 --max_wait 0.05``, ``replica_kill`` pinned on
   the owner of the first session, 90 s after the fleet is up); a
   ``ServiceClient`` runs 4 sessions (4 follow-ups each) of 16c's
   2,000-variable sensor coloring, each session's segments 1-3 before
   the kill and 4-5 after it, then 16 stateless Max-Sum solves: no
   request or session lost, each result equal to the same request on an
   undisturbed in-process card service, the standby's takeover
   ``compile.incremental``-only (its exporter's counters), a retry of an
   answered frame sent to the standby answered from its replicated reply
   cache without admitting a solve, and the router's ``/healthz``
   showing the victim dead; requests/s, p50, p99 and the seconds from
   the kill to the first failed-over answer.
18. Every algorithm on the host runtimes, and the lockstep islands of
   MGM, DBA and GDBA (``increase_mode`` E) on the card; no kernel is
   launched (the islands' sweeps are eager PyTorch).  18a: the three on
   grid10k with 17's split of the variables (islands ``a0`` and ``a1``
   of 4,900 variables each, the host strip ``a2``) in ``mode="sim"``, 9
   rounds (90,000 deliveries, ~44 cycles), seed 1, on the card and, at
   the same time in a child process, on the CPU: equal in assignment,
   cost, final assignment and cost, message count and size, cost trace,
   the cycles every computation completed and every variable's value
   history (each change stamped with the cycle that decided it; a
   SHA-256 of the whole log); cycles, deliveries, seconds, the islands'
   phase dispatches (``island.flushes``, one a lockstep phase) and
   boundary messages.  18b: a 30x30 grid (``generate graph_coloring
   --graph grid -n 900 -c 3 --soft --noise 0.02 --seed 1``) cut the
   same way (rows 0-13 ``a0``, 14-15 ``a2``, 16-29 ``a1``): each mixed
   run on the card (30 rounds) against the all-host run (200 rounds,
   in the child process): every stamped value change of the cycles both
   completed equal (at least 10), hence the assignment and cost after
   them; the mixed run's deliveries a cycle below the all-host run's.
   18c: an MGM island run in ``mode="thread"`` on 18a's deployment,
   stopped after 5 s: a complete assignment whose cost is
   ``solution_cost``'s; the host DPOP and SyncBB in ``mode="sim"`` on
   11e's SECP, finished at the batched ``solve(dcop, "dpop")``'s cost on
   the card; an all-host MGM-2 ``sim`` run on 18b's grid (100 rounds)
   with its deliveries a second.
19. Process mode over TCP (``infrastructure/hostnet.py``): agent OS
   processes (``python -m pydcop_tpu_torch agent --runtime host --device
   cuda``) under ``run_host_orchestrator``.  19a: grid10k Max-Sum
   (damping 0.5) with 17's split, the islands ``a0`` and ``a1`` in their
   own agent processes on the card and the host strip ``a2`` in a third,
   a budget of 2 rounds (59,600 deliveries) or 120 s: a complete
   assignment and final assignment whose costs are the port's
   ``solution_cost`` of them; each island agent's own telemetry (its
   ``--trace``) shows flushes and factor-kernel and q-update launches
   (> 0), the host agent's none; every Max-Sum message each island agent
   delivered (its ``--msg_log``) replayed into fresh islands on the card
   and on the CPU as 17a replays the sim record, equal flush by flush;
   deliveries/s over the deliver loop, seconds and the TCP frames the
   agents received.  19b: MGM with lockstep islands on 18b's 30x30 grid
   and split, three agent processes (each stamps its value changes with
   the cycle that decided them), the islands on the card, 15 rounds:
   every stamped change of the cycles both completed (at least 10) equal
   to the all-host ``sim`` run's on the CPU (200 rounds).  19c: the
   tests' SIGKILL case, a 300-variable DSA ring (p 0.06) on ``a1``
   (an island on the card), ``a2`` and ``a3``, ``k_target`` 1: ``a2`` is
   SIGKILLed once the UI feed shows a first sample, and the run finishes
   at cost 0 with ``a2``'s computations migrated.  19d: coloring-10k
   Max-Sum (512 rounds, chunk 64) on the card with ``ui_port`` and an SSE
   client on ``/state`` and ``/events``: one event a chunk (the final one
   with the assignment) published, the client's events the tail of
   them, its final event the result; engine seconds with the feed and
   without it (after a warm-up run; the same result).  19e:
   ``examples/greedy_plugin_torch.py`` loaded by the dotted name ``extlab.greedy`` on ``bench.py``'s
   coloring-10k model (``coloring_dcop(10_000, 3, 3, seed=1)``, 15a's
   first coloring), 64 rounds on the card and on the CPU: equal in
   every result key.
20. Sharded runs (``pydcop_tpu_torch.parallel``): every mesh is 4 shards
   on the one card (``Mesh([cuda:0] * 4)``), the counterpart of the JAX
   tests' virtual devices; it exercises the sharded path, it does not use
   the card better.  20a: coloring-1M compiled with ``n_shards=4``,
   Max-Sum (damping 0.5, 256 rounds, chunk 64, cost every 8) over the
   mesh against the unmeshed card run of the same problem: the same
   assignments, costs within 1e-4 relative, exactly one psum a round
   (the mesh's psums less one a cost sample), the factor kernels never
   launched (the sharded factor phase is the generic one) and the q
   update once a shard a round; msgs/s and engine seconds beside phase
   6's.  Over distinct cards too where the machine has more than one (no
   gate).  20b: the nine batched algorithms on phase 3's binary +
   ternary coloring-10k with 4 shards, 16 rounds (32 until PR 17's run
   2, cut for the time limit) on the card mesh and on a CPU mesh from one
   CPU-made state and CPU-made draws, beside the unmeshed card run: every
   state leaf and the cost samples bit-equal.
   20c, each over the card mesh against its unmeshed run, equal: DSA-B
   and Max-Sum with 4 restarts; a Max-Sum checkpoint saved at round 64
   of 128 under the mesh and resumed under it (the file in the global
   layout); a ``run_many_batched`` group of phase 3's coloring and three
   rewirings (:func:`rewired`); a constraint-free problem (Max-Sum, DSA);
   phase 14's sensor scenario through ``run_dynamic`` with ``n_shards=4``
   (40 rounds a second, an eighth of phase 14's, and 16 final rounds).
21. The SPMD runtime, one OS process a shard over ``torch.distributed``
   (``python -m pydcop_tpu_torch orchestrator``/``agent --runtime spmd``,
   ``parallel/distributed.py:ProcessMesh``, gloo on host copies: NCCL
   takes no two ranks on one card), one JSON line a cell, every process
   waited for with a timeout and killed at the end.  21a: grid10k (17's
   instance, dumped to YAML) through ``orchestrator -a maxsum -p
   damping:0.5 --nb_agents 3 --rounds 256 --chunk_size 64 --seed 1`` and
   ``agent --names a1 a2 a3``: 4 ranks and 4 shards on ``cuda:0``, run
   from a copy of the package with no built library (the 4 ranks build
   the kernels at once: one library must be left).  Gates: assignment,
   costs, cycle, status and message count equal, bit for bit, to
   ``run_batched(compile_dcop(dcop, n_shards=4), mesh=Mesh([cuda:0] *
   4))`` of the same YAML, seed and chunking (which must equal the
   unmeshed run of the same problem as in 20a), each agent's cost the
   orchestrator's, and each rank's ``--trace``: the q update launched
   once a round, the factor kernels never, two psums a round (the step's
   and the cost sample's).  It prints each rank's deploy seconds (joining
   the group, the YAML parse, the compile), engine seconds, psums and
   psum seconds, msgs/s beside the in-process mesh's and the unmeshed
   run's, and whether NCCL took two ranks on the card (two processes,
   one ``all_reduce``; no gate).  While 21a's orchestrator loads and
   dumps the YAML, 21b-e and that probe run side by side, each in a
   thread and a directory of its own; 21a's agents start after them.  21b: DSA-B (p 0.7) on a 50x50 grid (grid10k cut to 2,500
   variables: its YAML deploy again would take the phase past its
   budget), 4 ranks, 64 rounds, equal to the in-process card mesh's run.
   21c: the tests' SIGKILL case (12-ring, Max-Sum, chunk 8), the agent
   killed once the live feed shows a chunk: the orchestrator exits
   non-zero within 20 s, naming it.  21d: ``orchestrator --elastic
   --nb_agents 2`` on the 12-ring (Max-Sum, chunk 8, seed 5, 800
   rounds; 1,500 until this PR's run 1), workers on the card: ``a2``'s
   supervisor SIGKILLed in epoch 1, then the orchestrator's own worker
   in epoch 2: finished after 3 epochs with one ``participant_lost``
   (``a2``, its variables frozen: ``lost_computations``) and one
   ``worker_crash`` (nothing lost), and the cost the port's
   ``solution_cost`` of the assignment.  21e: the
   tests' scenario (``--scenario``, ``--ktarget 1``, the 24-agent
   12-ring) over 2 ranks, equal to ``run_dynamic`` over ``Mesh([cuda:0]
   * 2)`` in every key but the times.
22. The tooling commands on a machine without jax, one JSON line a
   cell.  22a: ``python -m pydcop_tpu_torch lint --json`` in a child
   process on the checkout: ``ok``, no finding, the port's 14 rules,
   ``scan_seconds`` under 30 s (the lane shares the host's cores), and
   neither torch nor jax loaded by the run.  22b: 20 interleaved A/A pairs of one sample each, the device
   time (:func:`device_ms`) of the same q-update launch at coloring-1M
   (the gathered form, phase 6's edge index), through ``bench-compare
   --pairs --json``: exit 0, verdict ``noise``, the JAX command's JSON
   keys.  22c: those 40 samples as ledger rows (one stage, 20 rounds) in
   a temporary directory, ``bench-history --now`` on them twice: exit 0
   and the same bytes both times.  Its launches are timings, not a main
   path: none is counted.
23. One ``{"kernels": [...]}`` JSON line (each kernel at its main-path
   shape, the q update in its gathered form, each kernel's lane-tile
   instance as ``<kernel>.runtime_d`` at phase 5's, and phase 9a's
   batched instances with the launches of phase 9's paths; the launches
   of phases 13-17, 19a, 20 and 21a are added to the entries their runs
   launch), the card line, and last the ``{"ok": true, ...}`` line.

It imports no jax and nothing of the JAX package; only 16c-d's and
17d's JSON text goes through PyYAML.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
REPS = 10  # few: the whole script has one time limit
COLD_BYTES = 1 << 28  # a working set five times the H100's 50 MB L2

PALLAS = "pydcop_tpu/ops/pallas_maxsum.py"
KERNELS = {
    "factor_round_binary_shared": f"{PALLAS}:175",
    "factor_round_binary": f"{PALLAS}:114",
    "q_update": f"{PALLAS}:222",
}
SOURCE = "pydcop_tpu_torch/csrc/maxsum_kernels.cu"
# phase 2's shapes for the factor kernels' lane-tile instance (d outside
# {2, 3, 4, 5, 8}): a ragged narrow width, phase 5's d = 10 width, and
# 100,000 lanes at the larger domains
RUNTIME_D_SHAPES = (
    [(d, 257) for d in (1, 6, 7, 10, 16, 32, 64)]
    + [(10, 299_988)]
    + [(d, 100_000) for d in (16, 32, 64)]
)
# phase 3's binary + ternary instance: the 10k coloring's 29,987 binary
# constraints and 3,333 ternaries, 2·29,987 + 3·3,333 directed edges
N_TERNARY = 3_333
E_TERNARY = 2 * 29_987 + 3 * N_TERNARY


def ternary_arrays(n, seed):
    """3-variable constraints over disjoint random triples of ``n``
    variables, with integer costs in [0, 8) (exact in bf16, so cost sums
    do not depend on the order of addition)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    scopes = rng.permutation(n)[: 3 * N_TERNARY].reshape(N_TERNARY, 3)
    tables = rng.integers(0, 8, (N_TERNARY, 3, 3, 3)).astype(np.float32)
    return scopes, tables


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _event_ms(torch, run) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def launch_ms(torch, fn, batch: int = 10) -> float:
    """Host launch interval of one call: CUDA events around ``batch``
    eager back-to-back calls, divided by ``batch``; the median of REPS
    such samples, after warm-up.  Where a call's device work is shorter
    than its host-side launch, this is the launch cost, not the device
    time."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(batch):
            fn()

    return statistics.median(
        _event_ms(torch, run) / batch for _ in range(REPS)
    )


def device_ms(torch, fn, batch: int = 20) -> float:
    """Device time of one call: ``batch`` calls captured in one CUDA
    graph, the graph's replay timed with CUDA events, divided by
    ``batch``; the median of REPS replays.  No host launch cost is in
    it, only the calls' kernels back to back on the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as required
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = statistics.median(
        _event_ms(torch, graph.replay) / batch for _ in range(REPS)
    )
    del graph
    torch.cuda.empty_cache()
    return ms


def profile_rounds(torch, run_batched, module, params, problem, rounds,
                   label, n_restarts=1):
    """Device time by kernel over ``rounds`` rounds (torch.profiler,
    CUPTI) and the device's idle share of the profiled wall time (the
    profiler adds host overhead: read the msgs/s of the unprofiled run
    for speed)."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(rounds=rounds, chunk_size=rounds, cost_every=8,
              n_restarts=n_restarts)
    run_batched(problem, module, params, **kw)  # warm
    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        res = run_batched(problem, module, params, **kw)
        torch.cuda.synchronize()
    # the engine's time excludes decoding the assignment dicts
    wall_ms = res.time * 1e3
    ops = prof.key_averages()
    kern = [e for e in ops if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if not kern or busy_ms <= 0:
        print(f"profile {label}: the profiler recorded no device time")
        return
    print(f"profile {label}: rounds={rounds} engine_ms={wall_ms} "
          f"device_busy_ms={busy_ms} "
          f"device_busy_ms_per_round={busy_ms / rounds} "
          f"idle_share={1 - busy_ms / wall_ms}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        us = e.self_device_time_total
        print(f"profile {label} kernel: calls={e.count} "
              f"us_per_call={us / e.count} share={us / 1e3 / busy_ms} "
              f"name={e.key[:100]!r}")
    host = [e for e in ops if e.device_type == torch.autograd.DeviceType.CPU
            and e.key.startswith("aten::")]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"profile {label} host-op: calls={e.count} "
              f"self_cpu_us={e.self_cpu_time_total} "
              f"device_us={e.device_time_total} name={e.key!r}")


def ptxas_instances(log: str):
    """(mangled name, registers, stack frame bytes, spill store bytes,
    spill load bytes) of every kernel in nvcc's ``-Xptxas -v`` output."""
    out, name, frame = [], None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line and name:
            frame = [int(x.split()[0]) for x in line.strip().split(",")]
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used ")[1].split()[0])
            out.append((name, regs, *frame))
            name = None
    return out


def demangle(names):
    """Readable kernel names (the toolkit's or binutils' demangler; the
    mangled names where neither is installed)."""
    import shutil

    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True, timeout=60).stdout
    short = []
    for x in out.splitlines():  # "void ns::kernel<(int)4, float>(args)"
        x = x.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
        short.append(x[: x.index(">(") + 1] if ">(" in x else x)
    return short


def same_bits(torch, a, b) -> bool:
    """Equal dtype, shape and bits; NaN where the other has NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    iview = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(iview)[~na], b.view(iview)[~nb])


def max_abs_err(torch, a, b) -> float:
    ok = ~(torch.isnan(a) | torch.isnan(b))
    if not bool(ok.any()):
        return 0.0
    return float((a.float() - b.float()).abs()[ok].max())


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def q_instance(mk, d, smem_optin):
    """The q update's instance at domain size d (as the launcher picks
    it): unrolled, the lane tile in registers with its row groups and
    lanes, or the tile staged in shared memory with its lanes."""
    if d in mk.UNROLLED_D:
        return "unrolled"
    if d <= 128:
        return f"tile-G{-(-d // 4)}-L32"
    lanes = 32
    while lanes > 1 and 4 * (64 + d) * lanes > smem_optin:
        lanes //= 2
    return f"staged-L{lanes}"


def check_kernels(torch, mk, dev, m4, edges):
    """Phase 2: every kernel against its plain version on the card.
    ``edges``: each coloring's edge index (i32, on the card) by its
    number of variables, for the q update's gathered form."""
    g = torch.Generator(device=dev).manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []

    def rand(*shape, scale=1.0, dtype=torch.float32):
        x = torch.rand(*shape, generator=g, device=dev) * scale
        return x.to(dtype)

    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin

    def instance(name, d):
        """Which instance runs at domain size d: an unrolled one, the
        factor kernels' lane tile (with its warps per block, 4 rows
        each) or the q update's (see q_instance)."""
        if name == "q_update":
            return q_instance(mk, d, optin)
        return "unrolled" if d in mk.UNROLLED_D else f"tile-W{-(-d // 4)}"

    def record(name, d, w, dtype, fn, plain, nbytes, nops, tag="",
               table="", extra=None):
        before = mk.launches[name]
        got = fn()
        launched = mk.launches[name] - before
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        equal = all(same_bits(torch, x, y) for x, y in zip(got, want))
        err = max(max_abs_err(torch, x, y) for x, y in zip(got, want))
        if not equal:
            raise AssertionError(
                f"{name} d={d} width={w} {tag}: differs from its plain "
                f"version, max_abs_err={err}"
            )
        b_ms, b_by = bound_ms(nbytes, nops)
        ms = device_ms(torch, fn)
        row = dict(
            kernel=name, d=d, width=w,
            dtype="bf16" if dtype == torch.bfloat16 else "f32",
            table=table, case=tag or "random", instance=instance(name, d),
            ms=ms, plain_ms=device_ms(torch, plain),
            launch_ms=launch_ms(torch, fn),
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
            launches=launched, max_abs_err=err, bit_equal=equal,
        )
        for k, f in (extra or {}).items():  # further timings: name -> fn
            row[k] = device_ms(torch, f) if callable(f) else f
        print("kernel-check " + " ".join(f"{k}={v}" for k, v in row.items()))
        rows.append(row)

    def factor(shared, d, m, dtype, nan=False, strided=False, tab_dtype=f32):
        name = "factor_round_binary_shared" if shared else "factor_round_binary"
        tab = rand(*((d, d) if shared else (d, d, m)), scale=10.0,
                   dtype=tab_dtype)
        if strided:  # q and r as column blocks of [d, E], as step passes them
            q = rand(d, 2 * m + 7, dtype=dtype)
            q0, q1 = q[:, 7 : 7 + m], q[:, 7 + m :]
            r = torch.empty_like(q)
            out = (r[:, 7 : 7 + m], r[:, 7 + m :])
        else:
            q0, q1, out = rand(d, m, dtype=dtype), rand(d, m, dtype=dtype), None
        if nan:
            q0[min(1, d - 1), 7] = float("nan")
            q1[0, m - 1] = float("nan")
        wrap = mk.factor_round_binary_shared if shared else mk.factor_round_binary
        plain = (mk.factor_round_binary_shared_plain if shared
                 else mk.factor_round_binary_plain)
        sz = 2 if dtype == torch.bfloat16 else 4
        tsz = 2 if tab_dtype == torch.bfloat16 else 4
        nbytes = 4 * d * m * sz + tsz * d * d * (1 if shared else m)
        nops = (4 * d * d + 6 * d) * m
        tag = "nan" if nan else ("strided" if strided else "")
        record(name, d, m, dtype, lambda: wrap(tab, q0, q1, out=out),
               lambda: plain(tab, q0, q1), nbytes, nops, tag,
               table="bf16" if tab_dtype == torch.bfloat16 else "f32")

    def q_update(d, e, dtype, nan=False, damping=0.5, per_op=False, n=None,
                 belief_dtype=None):
        """One q-update row.  ``n`` (a key of ``edges``): the gathered
        form, a ``[d, n]`` belief (f32 unless ``belief_dtype``) read
        through that coloring's edge index, E its length; the step's
        former sequence (cast, ``index_select``, then the identity form)
        is timed beside it.  Else the identity form, ``be`` ``[d, e]``."""
        ev = None if n is None else edges[n]
        if ev is not None:
            e = ev.shape[0]
            belief = rand(d, n, scale=5.0, dtype=belief_dtype or f32)
        else:
            belief = rand(d, e, scale=5.0, dtype=dtype)
        r, q = rand(d, e, dtype=dtype), rand(d, e, dtype=dtype)
        if nan:
            belief[d - 1, 11 if ev is None else int(ev[11])] = float("nan")
        sz = 2 if dtype == torch.bfloat16 else 4
        bsz = 2 if belief.dtype == torch.bfloat16 else 4
        nbytes = 3 * d * e * sz + belief.numel() * bsz
        tag = "nan" if nan else ("" if damping == 0.5 else f"damping{damping}")
        extra = {"belief": "bf16" if bsz == 2 else "f32"}
        if ev is not None:
            nbytes += 4 * e
            tag = "gathered" + (f"-{tag}" if tag else "")
            extra.update(
                n=n,
                gather_ms=lambda: belief.to(dtype).index_select(1, ev),
                two_pass_ms=lambda: mk.q_update(
                    belief.to(dtype).index_select(1, ev), None, r, q,
                    damping, per_op),
            )
        if per_op:
            tag = "per_op" + (f"-{tag}" if tag else "")
        record("q_update", d, e, dtype,
               lambda: mk.q_update(belief, ev, r, q, damping, per_op),
               lambda: mk.q_update_plain(belief, r, q, damping, per_op,
                                         edge_idx=ev),
               nbytes, 6 * d * e, tag, extra=extra)

    for dtype in (f32, bf16):
        for m in (29_987, 2_999_991, 257):
            factor(True, 3, m, dtype)
    for m in (29_987, 2_999_991):  # as step passes them, f32 and bf16 tables
        factor(True, 3, m, f32, strided=True)
        factor(True, 3, m, bf16, strided=True, tab_dtype=bf16)
    factor(True, 3, 257, f32, nan=True)
    factor(True, 3, 257, f32, tab_dtype=bf16)
    factor(True, 64, 257, bf16, tab_dtype=bf16)
    factor(True, 3, 257, bf16, nan=True, tab_dtype=bf16)
    for d in (2, 4, 5, 8, 64):
        factor(True, d, 257, f32)
    for m in (29_987, 2_999_991):  # the coloring shapes, per-factor
        factor(False, 3, m, f32)
    for d in (3, 5, 64):
        factor(False, d, 100_000, f32)
    factor(False, 5, m4, f32, strided=True)
    factor(False, 5, m4, bf16, strided=True, tab_dtype=bf16)
    factor(False, 5, 100_000, bf16)
    factor(False, 3, 257, f32, tab_dtype=bf16)
    factor(False, 64, 257, f32, tab_dtype=bf16)
    for d in (2, 3, 4, 8, 64):
        factor(False, d, 257, f32)
    factor(False, 3, 257, bf16)
    factor(False, 3, 257, f32, nan=True)
    # the lane-tile instance (every d outside mk.UNROLLED_D): each shape
    # with f32 and bf16 messages and tables as step passes them (strided
    # column blocks of [d, E]), and a NaN input
    for shared in (True, False):
        for d, m in RUNTIME_D_SHAPES:
            for dtype, tab_dtype in ((f32, f32), (bf16, f32), (f32, bf16),
                                     (bf16, bf16)):
                factor(shared, d, m, dtype, strided=True, tab_dtype=tab_dtype)
            factor(shared, d, m, f32, nan=True)
    for dtype in (f32, bf16):
        for e in (59_974, 5_999_982, 257):
            q_update(3, e, dtype)
    q_update(5, 2 * m4, f32)
    q_update(3, 59_974, f32, damping=0.3)
    for d in (2, 4, 8, 64, 100):  # 100: the generic instance past 64
        q_update(d, 257, f32)
    q_update(65, 59_974, f32)
    q_update(70, 257, bf16)
    q_update(3, 257, f32, nan=True)
    # bf16 rounding after every operation: a bf16 belief outside the
    # factor-kernel gate (phase 3's ternary instance, E = E_TERNARY)
    q_update(3, E_TERNARY, bf16, per_op=True)
    q_update(3, E_TERNARY, bf16, damping=0.3, per_op=True)
    q_update(70, 257, bf16, per_op=True)
    q_update(3, 257, bf16, nan=True, per_op=True)
    # the gathered form (the belief read through the edge index), at the
    # main path's shapes: coloring-10k and -1M (d 3), the d-10 cells
    # (100k variables, E 599,976); f32 and bf16 messages with an f32
    # belief, a bf16 belief (bf16 tables), per_op and NaN
    for n, d in ((10_000, 3), (1_000_000, 3), (100_000, 10)):
        q_update(d, 0, f32, n=n)
        q_update(d, 0, bf16, n=n)
    q_update(3, 0, bf16, n=10_000, belief_dtype=bf16)
    q_update(10, 0, bf16, n=100_000, belief_dtype=bf16)
    q_update(3, 0, f32, n=10_000, damping=0.3)
    q_update(3, 0, f32, n=10_000, nan=True)
    q_update(10, 0, f32, n=100_000, nan=True)
    q_update(3, 0, bf16, n=10_000, belief_dtype=bf16, per_op=True)
    q_update(10, 0, bf16, n=100_000, belief_dtype=bf16, per_op=True)
    # the generic instance past 64 (in registers up to 128, then staged
    # in shared memory, with fewer lanes per tile at the largest d)
    for d in (65, 100):
        q_update(d, 0, f32, n=10_000)
    q_update(70, 0, bf16, n=10_000)
    q_update(70, 0, bf16, n=10_000, belief_dtype=bf16, per_op=True)
    q_update(65, 0, f32, n=10_000, nan=True)
    for d in (129, 300, 1000):
        q_update(d, 0, f32, n=10_000)
    q_update(300, 0, bf16, n=10_000, nan=True)
    q_update(3000, 257, f32)
    q_update(20_000, 100, f32, nan=True)
    return rows


def card_vs_cpu(torch, mk, run_batched, module, params, p_dev, p_cpu,
                rounds, chunk, label, expect=None, n_restarts=1):
    """The port on the card and on the CPU from the same seed: q, r and
    values bit-equal, and the cost traces (``ops/costs.py`` sums in one
    order on every device).  ``expect``:
    the launches the card run must count, per kernel."""
    import numpy as np

    kw = dict(rounds=rounds, chunk_size=chunk, cost_every=8,
              return_state=True, n_restarts=n_restarts)
    mk.reset_launches()
    rc = run_batched(p_dev, module, params, **kw)
    counts = dict(mk.launches)
    for name, want in (expect or {}).items():
        if counts[name] != want:
            raise AssertionError(
                f"{label}: {name} launched {counts[name]} times, "
                f"expected {want} ({counts})"
            )
    rh = run_batched(p_cpu, module, params, **kw)
    for k in ("q", "r", "values"):
        if not same_bits(torch, rc.state[k], rh.state[k]):
            raise AssertionError(f"{label}: card and CPU differ in {k}")
    np.testing.assert_array_equal(rc.cost_trace, rh.cost_trace)
    print(f"card-vs-cpu {label}: {rounds} rounds, q/r/values bit-equal, "
          f"best cost card {rc.best_cost} cpu {rh.best_cost} "
          f"launches={counts}")


def cost_sum_row(torch, problem, label):
    """One cost evaluation at ``problem``'s size (``ops/costs.py:
    total_cost``, its fixed-order sum) against the same cells summed by
    ``torch.sum``: device time (graph), host launch interval, and the
    two results."""
    from pydcop_tpu_torch.ops import costs

    g = torch.Generator(device=problem.device).manual_seed(5)
    v = torch.randint(0, problem.d_max, (problem.n_vars,), generator=g,
                      device=problem.device, dtype=torch.int32)

    def summed():
        vv = v.long()
        con = problem.tables_flat[costs.con_cells(problem, vv)].sum(-1)
        return con + problem.unary.gather(-1, vv[:, None])[:, 0].sum(-1)

    def fixed():
        return costs.total_cost(problem, v)

    print(f"cost-sum {label}: cells={problem.n_cons + problem.n_vars} "
          f"fixed_order_ms={device_ms(torch, fixed)} "
          f"torch_sum_ms={device_ms(torch, summed)} "
          f"fixed_order_launch_ms={launch_ms(torch, fixed)} "
          f"torch_sum_launch_ms={launch_ms(torch, summed)} "
          f"fixed_order={float(fixed())} torch_sum={float(summed())}")


MAIN_PATH_RATES = {}  # label: msgs/s of the main_path runs


def main_path(torch, mk, solve_compiled, problem, rounds, chunk, expect,
              label, card):
    """One timed run of the main path through ``api.solve_compiled``,
    launch counts set to 0 just before and read just after."""
    import math

    params = {"damping": 0.5}
    solve_compiled(problem, "maxsum", params, rounds=min(rounds, chunk),
                   chunk_size=chunk, cost_every=8)  # warm run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    t0 = time.perf_counter()
    res = solve_compiled(problem, "maxsum", params, rounds=rounds,
                         chunk_size=chunk, cost_every=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    dt = res["time"]  # the engine's time: without decoding the dicts
    counts = dict(mk.launches)
    for name, want in expect.items():
        if counts[name] != want:
            raise AssertionError(
                f"{label}: {name} launched {counts[name]} times, "
                f"expected {want} ({counts})"
            )
    trace = res["cost_trace"]
    if res["cycle"] != rounds or len(trace) != math.ceil(rounds / 8):
        raise AssertionError(f"{label}: bad result shape {res['cycle']}")
    if not all(math.isfinite(c) for c in trace + [res["cost"]]):
        raise AssertionError(f"{label}: non-finite cost")
    if res["cost"] > trace[0]:
        raise AssertionError(f"{label}: best cost above the first sample")
    msgs = 2 * problem.n_real_edges * rounds
    MAIN_PATH_RATES[label] = msgs / dt
    print(f"solve {label}: n_vars={problem.n_vars} "
          f"n_real_edges={problem.n_real_edges} rounds={rounds} "
          f"engine_seconds={dt} msgs_per_s={msgs / dt} "
          f"wall_seconds={wall} msgs_per_s_wall={msgs / wall} "
          f"best_cost={res['cost']} peak_memory_bytes={peak} "
          f"launches={counts} card={card}")
    return counts


# -- phase 7: the local-search family and A-Max-Sum -------------------------

LOCAL_SEARCH = (  # (algorithm, parameters, rounds at 1M)
    ("dsa", {"variant": "B", "probability": 0.7}, 256),
    ("mgm2", {}, 256),
    ("adsa", {}, 32),
    ("dsatuto", {}, 32),
    ("mgm", {}, 32),
    ("dba", {}, 32),
    ("gdba", {}, 32),
    ("amaxsum", {}, 32),
)


def kernel_counts(mk, label, algo, rounds, table):
    """The launches ``algo`` must count over ``rounds`` rounds: A-Max-Sum
    one factor kernel (``table``) and one q update per round, the
    local-search family none."""
    want = dict.fromkeys(mk.launches, 0)
    if algo == "amaxsum":
        want[table] = rounds
        want["q_update"] = rounds
    got = dict(mk.launches)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    return got


def full_width(torch, mk, solve_compiled, problem, card):
    """Each algorithm through ``api.solve_compiled`` on the 1M coloring."""
    import math

    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.algorithms.mgm2 import pair_cells
    from pydcop_tpu_torch.engine.batched import round_generator

    cells = pair_cells(problem)
    print(f"mgm2 pair accumulator coloring-1M: n_vars={problem.n_vars} "
          f"max_degree={problem.neighbors.shape[1]} d={problem.d_max} "
          f"cells={cells} f32_bytes={4 * cells}")
    for algo, user, rounds in LOCAL_SEARCH:
        label = f"{algo}-coloring-1M"
        mod = load_algorithm_module(algo)
        params = prepare_algo_params(user, mod.algo_params)
        state = mod.init_state(problem, 0, params)  # warm: 2 rounds
        gen = round_generator(0, problem.device)
        for _ in range(2):
            state = mod.step(problem, state, params, gen)
        del state
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mk.reset_launches()
        t0 = time.perf_counter()
        res = solve_compiled(problem, algo, user, rounds=rounds,
                             chunk_size=min(rounds, 256), cost_every=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_counts(mk, label, algo, rounds,
                               "factor_round_binary_shared")
        peak = torch.cuda.max_memory_allocated()
        trace = res["cost_trace"]
        if res["cycle"] != rounds or len(trace) != math.ceil(rounds / 8):
            raise AssertionError(f"{label}: bad result shape {res['cycle']}")
        if not all(math.isfinite(c) for c in trace + [res["cost"]]):
            raise AssertionError(f"{label}: non-finite cost")
        if res["cost"] > min(trace):
            raise AssertionError(f"{label}: best cost above the samples")
        dt = res["time"]
        print(f"solve {label}: n_vars={problem.n_vars} rounds={rounds} "
              f"messages_per_round={mod.messages_per_round(problem, params)} "
              f"msg_count={res['msg_count']} engine_seconds={dt} "
              f"msgs_per_s={res['msg_count'] / dt} wall_seconds={wall} "
              f"msgs_per_s_wall={res['msg_count'] / wall} "
              f"first_cost={trace[0]} best_cost={res['cost']} "
              f"peak_memory_bytes={peak} launches={counts} card={card}")


def same_leaf(torch, a, b) -> bool:
    if a.dtype.is_floating_point:
        return same_bits(torch, a, b)
    return a.dtype == b.dtype and torch.equal(a, b)


def apply_card_vs_cpu(torch, mk, algo, user, p_dev, p_cpu, rounds, label,
                      table):
    """``rounds`` rounds of ``apply`` on the card and on the CPU from one
    state, fed the same draws made on a CPU generator: every state leaf
    must stay bit-equal."""
    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )

    mod = load_algorithm_module(algo)
    params = prepare_algo_params(user, mod.algo_params)
    st_cpu = mod.init_state(p_cpu, 3, params)
    st_dev = {k: v.to(p_dev.device) for k, v in st_cpu.items()}
    first = st_cpu["values"]
    gen = torch.Generator().manual_seed(11)
    mk.reset_launches()
    for _ in range(rounds):
        drawn = mod.draws(p_cpu, params, gen)
        st_cpu = mod.apply(p_cpu, st_cpu, params, drawn)
        st_dev = mod.apply(p_dev, st_dev, params,
                           {k: v.to(p_dev.device) for k, v in drawn.items()})
    torch.cuda.synchronize()
    counts = kernel_counts(mk, f"{algo}-{label}", algo, rounds, table)
    for k, v in st_cpu.items():
        if not same_leaf(torch, st_dev[k].cpu(), v):
            raise AssertionError(f"{algo}-{label}: card and CPU differ in {k}")
    changed = int((st_cpu["values"] != first).sum())
    print(f"card-vs-cpu {algo}-{label}: {rounds} rounds of apply on shared "
          f"CPU draws, {sorted(st_cpu)} bit-equal, values changed from the "
          f"start={changed} launches={counts}")


def restart_config(torch, mk, solve_compiled, run_batched, problem, algo,
                   user, k, label, card):
    """One of the repo's benchmark configurations with restarts: 1024
    rounds, chunk 256, cost every 8, best of ``k``; then a profiler pass
    over 32 rounds."""
    import math

    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )

    kw = dict(chunk_size=256, cost_every=8, n_restarts=k)
    solve_compiled(problem, algo, user, rounds=256, **kw)  # warm chunk
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    res = solve_compiled(problem, algo, user, rounds=1024, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts(mk, label, algo, 1024, None)
    rc = res["restart_costs"]
    if len(rc) != k or res["cost"] != min(rc) or res["cycle"] != 1024:
        raise AssertionError(f"{label}: bad restart result {res['cost']} {rc}")
    if not all(math.isfinite(c) for c in rc):
        raise AssertionError(f"{label}: non-finite cost")
    dt = res["time"]
    print(f"solve {label}: n_vars={problem.n_vars} "
          f"n_real_edges={problem.n_real_edges} restarts={k} rounds=1024 "
          f"msg_count={res['msg_count']} engine_seconds={dt} "
          f"msgs_per_s={res['msg_count'] / dt} wall_seconds={wall} "
          f"best_cost={res['cost']} restart_costs={rc} launches={counts} "
          f"card={card}")
    mod = load_algorithm_module(algo)
    profile_rounds(torch, run_batched, mod,
                   prepare_algo_params(user, mod.algo_params), problem, 32,
                   label, n_restarts=k)


def local_search_phase(torch, mk, solve_compiled, run_batched, p3, p3c, p5,
                       card):
    """Phase 7 (see the module docstring)."""
    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.ops.compile import compile_from_arrays
    from pydcop_tpu_torch.ops.generate import ising_arrays

    full_width(torch, mk, solve_compiled, p5, card)
    for algo, user, _ in LOCAL_SEARCH[:2]:  # DSA-B and MGM-2
        mod = load_algorithm_module(algo)
        profile_rounds(torch, run_batched, mod,
                       prepare_algo_params(user, mod.algo_params), p5, 16,
                       f"{algo}-coloring-1M")

    si, ti, ui = ising_arrays(100, 100, seed=1)
    pic = compile_from_arrays(si, ti, 2, unary=ui, device="cpu")
    pi = pic.to(p3.device)
    for algo, user, _ in LOCAL_SEARCH:
        apply_card_vs_cpu(torch, mk, algo, user, p3, p3c, 32, "coloring-10k",
                          "factor_round_binary_shared")
    for algo in ("mgm2", "amaxsum"):
        apply_card_vs_cpu(torch, mk, algo, {}, pi, pic, 32, "ising-100x100",
                          "factor_round_binary")

    # configurations 1 and 2 as the JAX package builds them
    # (bench_configs.py:24-38), with the port's copies of the generators
    from argparse import Namespace

    from pydcop_tpu_torch.commands.generators import ising
    from pydcop_tpu_torch.ops.compile import compile_dcop

    p1 = compile_dcop(coloring_dcop(50, colors=3, degree=3, seed=1),
                      device=p3.device)
    restart_config(torch, mk, solve_compiled, run_batched, p1, "dsa",
                   {"variant": "B", "probability": 0.7}, 64,
                   "config1-coloring50-dsaB-K64", card)
    p2 = compile_dcop(ising.generate(Namespace(
        row_count=32, col_count=32, bin_range=1.6, un_range=0.05,
        no_agents=False, capacity=100.0, seed=1,
    )), device=p3.device)
    restart_config(torch, mk, solve_compiled, run_batched, p2, "mgm2", {}, 8,
                   "config2-ising32-mgm2-K8", card)


# -- phase 8: exact DPOP ----------------------------------------------------

SECP_SPEC = dict(  # bench.py's config4_dpop_secp stage (bench.py:121-133)
    nb_lights=768, nb_models=768, nb_rules=192, light_levels=6,
    model_arity=3, zone_size=8, zone_layout="tiled", efficiency_weight=0.1,
    capacity=100.0, seed=7,
)
DPOP_STATS = ("util_cells", "util_device_nodes", "util_host_nodes",
              "util_dispatches")


def hubtree_dcop(planted=False):
    """Configuration 6 (``bench_configs.py:65-107``, ``_gen_dpop_large``)
    rebuilt with the port's model objects: 3 hubs chained, 45 leaves each
    bound to every hub, d = 24, 137 binary uniform(0, 10) tables from
    ``RandomState(5)`` drawn in the same order.

    ``planted``: the same graph and draws with one planted value per leaf
    (``x_i = i mod 24``): its hub-leaf tables are rescaled to [5, 10) and
    the planted column to [0, 1), so each leaf's best value leads the
    next by at least 12 against a bf16 certificate bound of about 1.9
    (uniform tables leave margins below the bound, and every leaf join
    falls back to the host at bf16 and int8)."""
    import numpy as np

    from pydcop_tpu_torch.dcop import DCOP, Domain, NAryMatrixRelation, Variable

    rnd = np.random.RandomState(5)
    d, n_hubs, n_leaves = 24, 3, 45
    dom = Domain("d", "", list(range(d)))
    dcop = DCOP("hubtree", objective="min")
    hubs = [Variable(f"h{i}", dom) for i in range(n_hubs)]
    for h in hubs:
        dcop.add_variable(h)
    ci = 0
    for i in range(1, n_hubs):
        t = rnd.uniform(0, 10, (d, d))
        dcop.add_constraint(
            NAryMatrixRelation([hubs[i - 1], hubs[i]], t, name=f"c{ci}"))
        ci += 1
    for i in range(n_leaves):
        leaf = Variable(f"x{i}", dom)
        dcop.add_variable(leaf)
        for h in hubs:
            t = rnd.uniform(0, 10, (d, d))
            if planted:
                t = 5 + t / 2
                t[:, i % d] = (t[:, i % d] - 5) / 5
            dcop.add_constraint(
                NAryMatrixRelation([h, leaf], t, name=f"c{ci}"))
            ci += 1
    return dcop


def record_dispatches(sr_mod):
    """Wrap the sweep's dispatch (``ops/semiring.py:_dispatch``, which
    DPOP's UTIL sweep calls) for one run: each dispatch's part shapes (the
    stack height leads them in a stacked dispatch) and its host time,
    transfers included.  Returns the log and the function that unwraps."""
    log, inner = [], sr_mod._dispatch

    def wrapped(fn, parts, device):
        t0 = time.perf_counter()
        out = inner(fn, parts, device)
        log.append(([p.shape for p in parts], time.perf_counter() - t0))
        return out

    sr_mod._dispatch = wrapped
    return log, lambda: setattr(sr_mod, "_dispatch", inner)


def profile_solve(torch, solve, dcop, params, pad, label):
    """Device time by operation over one warm solve on the card
    (torch.profiler) and the device's idle share of its wall time."""
    def run():
        t0 = time.perf_counter()
        res = solve(dcop, "dpop", params, pad_policy=pad)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    (res, wall_ms), prof, kern = profiled(torch, run, label)
    ops = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"profile {label}: wall_ms={wall_ms} util_time_ms="
          f"{res['util_time'] * 1e3} device_busy_ms={busy_ms} "
          f"idle_share={1 - busy_ms / wall_ms} "
          f"dispatches={res['util_dispatches']} "
          f"device_busy_ms_per_dispatch={busy_ms / res['util_dispatches']}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        us = e.self_device_time_total
        print(f"profile {label} kernel: calls={e.count} "
              f"us_per_call={us / e.count} share={us / 1e3 / busy_ms} "
              f"name={e.key[:100]!r}")


def contraction_cost(shape, part_shapes, lead):
    """(bytes the contraction must move, its f32 operations, the bytes
    the eager form moves): each part read once, ``amin`` (int64) and
    ``margins`` (f32) written once; the eager form writes and re-reads
    the joined table once per add, then reads it for the minimum and the
    argmin, reads and writes it for the masked copy and reads that for
    the second minimum."""
    import math

    cells = math.prod(lead + tuple(shape))
    parts = sum(4 * math.prod(lead + tuple(p)) for p in part_shapes)
    out = 12 * cells // shape[-1]
    n = len(part_shapes)
    eager = parts + 4 * cells * (2 * (n - 1) + 5) + out
    return parts + out, cells * (n + 4), eager


def contraction_rows(torch, dev, hub_shapes):
    """The min-sum contraction on the card against its CPU run, bit for
    bit (``amin`` as int64, ``margins`` NaN where the other is NaN): random
    stacks at the hubtree's shapes, then the tie, -0.0, +inf-row, mixed
    ±inf (NaN) and d = 1 rows of ``tests/test_torch_semiring.py``."""
    import numpy as np

    from pydcop_tpu_torch.ops.semiring import MIN_SUM, contraction_kernel

    rng = np.random.default_rng(17)
    f32 = np.float32

    def edge_parts(case, part_shapes, lead):
        out = []
        for i, ps in enumerate(part_shapes):
            full = lead + ps
            if case == "ties":
                p = rng.integers(0, 3, full).astype(f32)
            elif case == "negzero":
                p = -rng.integers(0, 2, full).astype(f32)
            elif case == "inf_rows":
                p = rng.random(full, dtype=f32)
                if i == 0:
                    p[(Ellipsis, 0) if p.ndim > 1 else Ellipsis] = np.inf
            elif case == "mixed_inf":
                p = rng.random(full, dtype=f32)
                flat = p.reshape(-1)
                pick = rng.choice(flat.size, size=max(1, flat.size // 5),
                                  replace=False)
                flat[pick] = np.inf if i % 2 == 0 else -np.inf
            else:
                p = rng.random(full, dtype=f32) * 10
            out.append(p)
        return out

    cases = [(f"hubtree-{name}", "random", shape, ps, lead)
             for name, shape, ps, lead in hub_shapes]
    for case in ("ties", "negzero", "inf_rows", "mixed_inf", "random"):
        for shape, ps in (((4, 3, 5), ((4, 1, 5), (1, 3, 5), (4, 3, 1))),
                          ((5, 1), ((5, 1), (1, 1)))):
            for lead in ((), (3,)):
                cases.append((f"edge-{case}", case, shape, ps, lead))
    for label, case, shape, ps, lead in cases:
        parts = edge_parts(case, ps, lead)
        fn = contraction_kernel(MIN_SUM, shape, ps, batched=bool(lead))
        a_cpu, m_cpu = fn(*(torch.from_numpy(p) for p in parts))
        on_card = [torch.from_numpy(p).to(dev) for p in parts]
        a_dev, m_dev = fn(*on_card)
        torch.cuda.synchronize()
        if a_dev.dtype != torch.int64 or not torch.equal(a_dev.cpu(), a_cpu):
            raise AssertionError(f"contraction {label}: amin differs")
        if not same_bits(torch, m_dev.cpu(), m_cpu):
            raise AssertionError(f"contraction {label}: margins differ")
        nbytes, nops, eager = contraction_cost(shape, ps, lead)
        b_ms, b_by = bound_ms(nbytes, nops)
        ms = device_ms(torch, lambda: fn(*on_card))
        print(f"contraction {label}: shape={shape} stack={lead} "
              f"parts={len(ps)} bit_equal=True "
              f"nan_cells={int(torch.isnan(m_cpu).sum())} ms={ms} "
              f"bound_ms={b_ms} bound_by={b_by} share_of_bound={b_ms / ms} "
              f"eager_bytes_ms={eager / HBM_BYTES_PER_S * 1e3}")
        del on_card, a_dev, m_dev
    torch.cuda.empty_cache()


def dpop_card_cpu_oracle(torch, solve, dcop, params, pad, label, card):
    """The card run (cold, then warm with peak memory), the port's CPU run
    and, for ``util_device`` other than ``never``, checks: equal
    assignments and costs, equal counts between card and CPU."""
    t0 = time.perf_counter()
    cold = solve(dcop, "dpop", params, pad_policy=pad)
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # earlier phases' live tensors
    t0 = time.perf_counter()
    warm = solve(dcop, "dpop", params, pad_policy=pad)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    cpu = solve(dcop, "dpop", params, pad_policy=pad, device="cpu")
    for r in (cold, warm, cpu):
        if r["status"] != "finished":
            raise AssertionError(f"{label}: status {r['status']}")
    for name, r in (("cold card", cold), ("cpu", cpu)):
        if (r["assignment"], r["cost"]) != (warm["assignment"], warm["cost"]):
            raise AssertionError(f"{label}: {name} run differs from the card")
        for k in DPOP_STATS:
            if r[k] != warm[k]:
                raise AssertionError(
                    f"{label}: {k} {name} {r[k]} card {warm[k]}")
    if warm["util_device_nodes"] <= 0:
        raise AssertionError(f"{label}: no join ran on the card")
    print(f"solve {label}: n_vars={len(dcop.variables)} "
          f"tree_height={warm['cycle']} cost={warm['cost']} "
          f"util_cells={warm['util_cells']} "
          f"util_device_nodes={warm['util_device_nodes']} "
          f"util_host_nodes={warm['util_host_nodes']} "
          f"util_dispatches={warm['util_dispatches']} "
          f"util_time_cold={cold['util_time']} util_time={warm['util_time']} "
          f"util_cells_per_s={warm['util_cells'] / warm['util_time']} "
          f"solve_seconds_cold={cold_wall} solve_seconds={wall} "
          f"time={warm['time']} peak_memory_bytes_above_start={peak} "
          f"cpu_util_time={cpu['util_time']} card={card}")
    return warm


def dpop_phase(torch, dev, card):
    """Phase 8 (see the module docstring)."""
    from argparse import Namespace

    import numpy as np

    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.commands.generators.secp import generate
    from pydcop_tpu_torch.ops import semiring as sr_mod

    # -- 8a. configuration 6 at full width
    hub = hubtree_dcop()
    if (len(hub.variables), len(hub.constraints)) != (48, 137):
        raise AssertionError("unexpected hubtree size")
    auto = {"util_device": "auto"}
    card_r = dpop_card_cpu_oracle(torch, solve, hub, auto, "none",
                                  "dpop-hubtree-d24", card)
    oracle = solve(hub, "dpop", {"util_device": "never"}, device="cpu")
    if ((oracle["assignment"], oracle["cost"])
            != (card_r["assignment"], card_r["cost"])):
        raise AssertionError("dpop-hubtree-d24: differs from the host f64 "
                             "oracle")
    print(f"oracle dpop-hubtree-d24: host f64 util_time="
          f"{oracle['util_time']} cost={oracle['cost']} equal=True")
    log, unwrap = record_dispatches(sr_mod)
    try:
        rec = solve(hub, "dpop", auto)
    finally:
        unwrap()
    if len(log) != rec["util_dispatches"]:
        raise AssertionError("dpop-hubtree-d24: dispatch log incomplete")
    hub_shapes = []
    for i, (shapes, secs) in enumerate(log):
        # the joins' parts (4 axes, and the stack's): a pruned dispatch
        # (bnb "auto") also passes its budget, 0-d or [stack]
        shapes = [s for s in shapes if len(s) >= 4]
        joined = np.broadcast_shapes(*shapes)
        stacked = len(shapes[0]) > 4  # the joins are 4-axis: d^4 cells
        lead, shape = (joined[:1], joined[1:]) if stacked else ((), joined)
        cells = int(np.prod(joined))
        print(f"dispatch dpop-hubtree-d24 {i}: joined={tuple(shape)} "
              f"stack={lead[0] if lead else 1} parts={len(shapes)} "
              f"cells={cells} f32_bytes={4 * cells} host_seconds={secs}")
        hub_shapes.append((
            f"{'stack' if stacked else 'node'}{i}", tuple(shape),
            tuple(tuple(s[len(lead):]) for s in shapes), tuple(lead)))
    profile_solve(torch, solve, hub, auto, "none", "dpop-hubtree-d24")

    # -- the contraction on the card against its CPU run
    contraction_rows(torch, dev, hub_shapes)

    # -- 8b. the config4_dpop_secp stage, level against node dispatches
    secp = generate(Namespace(**SECP_SPEC))
    always = {"util_device": "always"}
    runs = {}
    for mode in ("level", "node"):
        runs[mode] = dpop_card_cpu_oracle(
            torch, solve, secp, dict(always, util_batch=mode), "pow2",
            f"dpop-secp-768-tiled-{mode}", card)
    lv, nd = runs["level"], runs["node"]
    if (lv["assignment"], lv["cost"]) != (nd["assignment"], nd["cost"]):
        raise AssertionError("dpop-secp-768-tiled: level and node differ")
    print(f"compare dpop-secp-768-tiled: level util_cells_per_s="
          f"{lv['util_cells'] / lv['util_time']} dispatches="
          f"{lv['util_dispatches']} node util_cells_per_s="
          f"{nd['util_cells'] / nd['util_time']} dispatches="
          f"{nd['util_dispatches']} equal=True")
    profile_solve(torch, solve, secp, dict(always, util_batch="level"),
                  "pow2", "dpop-secp-768-tiled-level")


# -- phase 9: restarts, instances and the kernels' batch axis ----------------

CONFIG3_SPEC = dict(  # bench_configs.py:41-51, _gen_scalefree_1k
    variables_count=1000, colors_count=3, graph="scalefree", m_edge=2,
    p_edge=None, noise=0.02, soft=False, intentional=False,
    agents_count=None, capacity=100.0, seed=1,
)
CONFIG5_SPEC = dict(  # bench_configs.py:109-118, _gen_meeting_10k
    slots_count=8, events_count=2500, resources_count=500,
    max_resources_event=4, eq_cost=10.0, noconflict_cost=10.0,
    value_range=1.0, capacity=1000.0, seed=1,
)
MANY_KS = (1, 8, 32)  # bench.py:82-94, the solve_many stage
MANY_ROUNDS = 64  # its rounds (256 there): the script has one time limit


def coloring_dcop(n_vars, colors=3, degree=3, seed=0):
    """``bench.py``'s many-instance coloring (``__graft_entry__.py:17``,
    ``_make_coloring_dcop``), built with the port's model objects: ring
    edges drawn from ``random.Random(seed)``, cost 1 on equal colours,
    and per-variable noisy value costs."""
    import random

    import numpy as np

    from pydcop_tpu_torch.dcop.dcop import DCOP
    from pydcop_tpu_torch.dcop.objects import Domain, VariableNoisyCostFunc
    from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation
    from pydcop_tpu_torch.utils.expressionfunction import ExpressionFunction

    rnd = random.Random(seed)
    d = Domain("colors", "", list(range(colors)))
    dcop = DCOP(f"coloring_{n_vars}")
    vs = [
        VariableNoisyCostFunc(f"v{i}", d, ExpressionFunction(f"v{i} * 0"),
                              noise_level=0.02)
        for i in range(n_vars)
    ]
    for v in vs:
        dcop.add_variable(v)
    eq_penalty = np.eye(colors)
    seen = set()
    cid = 0
    for i in range(n_vars):
        for _ in range(degree):
            j = rnd.randrange(n_vars)
            if i == j or (min(i, j), max(i, j)) in seen:
                continue
            seen.add((min(i, j), max(i, j)))
            dcop.add_constraint(
                NAryMatrixRelation([vs[i], vs[j]], eq_penalty, name=f"c{cid}")
            )
            cid += 1
    return dcop


def cold_ms(torch, calls, reps: int = 10) -> float:
    """Device time of one call when its inputs are not in L2: ``calls``
    run the same function on copies of its inputs that together exceed
    COLD_BYTES; one pass over them (repeated to at least 20 calls) is
    captured in a CUDA graph and its replay timed as in
    :func:`device_ms` (median of ``reps``), so each call's inputs were
    last touched a whole working set before."""
    passes = max(1, math.ceil(20 / len(calls)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as required
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(passes):
            for c in calls:
                c()
    graph.replay()
    torch.cuda.synchronize()
    n = passes * len(calls)
    ms = statistics.median(
        _event_ms(torch, graph.replay) / n for _ in range(reps)
    )
    del graph
    torch.cuda.empty_cache()
    return ms


def batched_rows(torch, mk, dev, m3, e3, n3):
    """Phase 9a: each batched kernel instance against its batched plain
    version and against B unbatched launches, bit for bit, with the
    batched launch's time, the plain version's, the B launches' and the
    bound, each timed cold (:func:`cold_ms`: the inputs rotate through
    copies larger than L2, so the time is held against HBM's rate).
    ``m3``, ``e3``, ``n3``: configuration 3's constraints, edges and
    variables."""
    g = torch.Generator(device=dev).manual_seed(9)
    rows = {}

    def rand(*shape, scale=1.0):
        return torch.rand(*shape, generator=g, device=dev) * scale

    def record(key, name, d, width, B, make, nbytes, nops, extra=""):
        """``make()`` builds one copy of the inputs and returns the
        (batched launch, plain version, B unbatched launches) on it."""
        fn, plain, singles = make()
        got, want, one = fn(), plain(), singles()
        torch.cuda.synchronize()
        equal = all(same_bits(torch, x, y) for x, y in zip(got, want))
        equal_one = all(same_bits(torch, x, y) for x, y in zip(got, one))
        err = max(max_abs_err(torch, x, y) for x, y in zip(got, want))
        if not (equal and equal_one):
            raise AssertionError(
                f"{key}: batched kernel differs (plain equal={equal}, "
                f"unbatched equal={equal_one}), max_abs_err={err}"
            )
        b_ms, b_by = bound_ms(nbytes, nops)
        copies = [(fn, plain, singles)] + [
            make() for _ in range(math.ceil(COLD_BYTES / nbytes) - 1)
        ]
        ms = cold_ms(torch, [c[0] for c in copies])
        tile = d not in mk.UNROLLED_D
        row = dict(
            entry=key, kernel=name, d=d, width=width, batch=B, case=extra,
            instance=("tile" if tile else "unrolled"), ms=ms,
            plain_ms=cold_ms(torch, [c[1] for c in copies]),
            unbatched_ms=cold_ms(torch, [c[2] for c in copies]),
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
            max_abs_err=err, bit_equal=True, input_copies=len(copies),
        )
        del copies
        torch.cuda.empty_cache()
        if row["share_of_bound"] > 1:
            raise AssertionError(f"{key}: faster than its bound: {row}")
        print("kernel-check-batched " + " ".join(
            f"{k}={v}" for k, v in row.items()))
        rows[key] = row

    def factor(key, shared, d, m, B, n_tab):
        """``n_tab`` tables (0: one table without a batch axis)."""
        name = "factor_round_binary_shared" if shared else "factor_round_binary"
        shape = (d, d) if shared else (d, d, m)
        wrap = mk.factor_round_binary_shared if shared else mk.factor_round_binary
        plain = (mk.factor_round_binary_shared_plain if shared
                 else mk.factor_round_binary_plain)
        per = B // max(n_tab, 1)

        def make():
            tab = rand(*(((n_tab,) if n_tab else ()) + shape), scale=10.0)
            q = rand(B, d, 2 * m)
            q0, q1 = q[:, :, :m], q[:, :, m:]
            r, rs = torch.empty_like(q), torch.empty_like(q)
            out = (r[:, :, :m], r[:, :, m:])
            outs = (rs[:, :, :m], rs[:, :, m:])

            def singles():
                for b in range(B):
                    t = tab[b // per] if n_tab else tab
                    wrap(t, q0[b], q1[b], out=(outs[0][b], outs[1][b]))
                return outs

            return (lambda: wrap(tab, q0, q1, out=out),
                    lambda: plain(tab, q0, q1), singles)

        nbytes = 16 * d * m * B + 4 * d * d * (m if not shared else 1) * max(
            n_tab, 1)
        record(key, name, d, m, B, make, nbytes, (4 * d * d + 6 * d) * m * B,
               f"tables={n_tab or 'one'}")

    def q_update(key, d, e, n, B, n_inst, per_instance_damping):
        dl = [0.5 + 0.05 * i for i in range(max(n_inst, 1))]
        per = B // max(n_inst, 1)

        def make():
            belief = rand(B, d, n, scale=5.0)
            idx_all = torch.randint(0, n, (max(n_inst, 1), e), generator=g,
                                    device=dev, dtype=torch.int32)
            idx = idx_all if n_inst else idx_all[0]
            r, q = rand(B, d, e), rand(B, d, e)
            damp = (torch.tensor(dl, dtype=torch.float32, device=dev)
                    if per_instance_damping else 0.5)
            outs = torch.empty_like(q)

            def singles():
                for b in range(B):
                    i = b // per
                    outs[b].copy_(mk.q_update(
                        belief[b], idx[i] if n_inst else idx, r[b], q[b],
                        dl[i] if per_instance_damping else 0.5,
                    ))
                return (outs,)

            return (lambda: (mk.q_update(belief, idx, r, q, damp),),
                    lambda: (mk.q_update_plain(belief, r, q, damp,
                                               edge_idx=idx),),
                    singles)

        nbytes = 12 * d * e * B + 4 * B * d * n + 4 * max(n_inst, 1) * e
        record(key, "q_update", d, e, B, make, nbytes, 6 * d * e * B,
               f"index={'per_instance' if n_inst else 'one'} damping="
               f"{'per_instance' if per_instance_damping else 'one'}")

    # configuration 3 (9b): 8 restarts, one per-factor table for all
    factor("factor_round_binary.batched_restarts", False, 3, m3, 8, 0)
    q_update("q_update.batched_restarts", 3, e3, n3, 8, 0, False)
    # 8 coloring-10k instances: stacked shared tables and per-instance
    # damping (9e's unpadded group), stacked per-factor tables (9e, pow2)
    factor("factor_round_binary_shared.batched_instances", True, 3, 29_987,
           8, 8)
    q_update("q_update.batched_instances", 3, 59_974, 10_000, 8, 8, True)
    factor("factor_round_binary.batched_instances", False, 3, 32_768, 8, 8)
    q_update("q_update.batched_instances_pow2", 3, 65_536, 16_384, 8, 8,
             False)
    # per-factor-100k-d10 at B 2: the lane-tile instances
    factor("factor_round_binary.runtime_d.batched", False, 10, 299_988, 2, 2)
    q_update("q_update.runtime_d.batched", 10, 599_976, 100_000, 2, 2, True)
    return rows


def rewired(scopes, seed):
    """``scopes`` (binary, as ``coloring_arrays`` makes them) rewired by
    one degree-preserving double edge swap per edge drawn from
    ``random.Random(seed)``: (a, b), (c, d) become (a, d), (c, b) where
    that makes no self-loop and no duplicate edge.  Every variable keeps
    its degree, so the compiled problems share one group key while their
    graphs differ."""
    import random

    import numpy as np

    rnd = random.Random(seed)
    edges = [tuple(e) for e in scopes.tolist()]
    have = set(edges)
    m = len(edges)
    for _ in range(m):
        i, j = rnd.randrange(m), rnd.randrange(m)
        (a, b), (c, d) = edges[i], edges[j]
        if rnd.random() < 0.5:
            c, d = d, c
        e1, e2 = (min(a, d), max(a, d)), (min(c, b), max(c, b))
        if a == d or c == b or e1 in have or e2 in have or e1 == e2:
            continue
        have -= {edges[i], edges[j]}
        have |= {e1, e2}
        edges[i], edges[j] = e1, e2
    return np.unique(np.asarray(edges, dtype=np.int32), axis=0)


def union_apply_card_vs_cpu(torch, mk, dev, problems, rounds, label):
    """DSA-B on a group's disjoint union (the local search's lowering of
    ``solve_many``), one probability per instance (0.30, 0.35, ...):
    ``rounds`` rounds of ``apply`` on the card and on the CPU from one
    state, fed the same CPU-made draws; the values must stay bit-equal
    and no kernel is launched."""
    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.engine.batched import _group_params
    from pydcop_tpu_torch.ops.compile import stack_problems, union_problem

    mod = load_algorithm_module("dsa")
    plist = [
        prepare_algo_params({"variant": "B", "probability": 0.3 + 0.05 * i},
                            mod.algo_params)
        for i in range(len(problems))
    ]
    [grp] = stack_problems(problems)
    if grp.n_instances != len(problems):
        raise AssertionError(f"{label}: not one group")
    u_cpu = union_problem(grp)
    u_dev = u_cpu.to(dev)
    gp_cpu = _group_params(mod, plist, u_cpu, len(problems), False)
    gp_dev = _group_params(mod, plist, u_dev, len(problems), False)
    st_cpu = mod.init_state(u_cpu, 3, gp_cpu)
    st_dev = {k: v.to(dev) for k, v in st_cpu.items()}
    first = st_cpu["values"]
    gen = torch.Generator().manual_seed(11)
    mk.reset_launches()
    for _ in range(rounds):
        drawn = mod.draws(u_cpu, gp_cpu, gen)
        st_cpu = mod.apply(u_cpu, st_cpu, gp_cpu, drawn)
        st_dev = mod.apply(u_dev, st_dev, gp_dev,
                           {k: v.to(dev) for k, v in drawn.items()})
    torch.cuda.synchronize()
    counts = kernel_counts(mk, label, "dsa", rounds, None)
    for k, v in st_cpu.items():
        if not same_leaf(torch, st_dev[k].cpu(), v):
            raise AssertionError(f"{label}: card and CPU differ in {k}")
    print(f"card-vs-cpu {label}: {rounds} rounds of apply on the union of "
          f"{len(problems)} instances (n_vars={u_cpu.n_vars}), per-instance "
          f"probabilities, shared CPU draws, {sorted(st_cpu)} bit-equal, "
          f"values changed from the start="
          f"{int((st_cpu['values'] != first).sum())} launches={counts}")


def same_result(label, got, want):
    """A ``solve_many`` result equal to a sequential solve's, key for key
    (times and the group size aside)."""
    for k in set(want) - {"time", "instances_batched"}:
        if got[k] != want[k]:
            raise AssertionError(f"{label}: {k} differs from its own solve")


def expect_launches(mk, label, want):
    got = dict(mk.launches)
    full = dict.fromkeys(got, 0)
    full.update(want)
    if got != full:
        raise AssertionError(f"{label}: launches {got}, expected {full}")
    return got


def profile_call(torch, label, fn, rounds):
    """Device time by kernel and the idle share over one call of ``fn``
    (which runs ``rounds`` rounds and returns its engine seconds)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        secs = fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if not kern or busy_ms <= 0:
        print(f"profile {label}: the profiler recorded no device time")
        return
    print(f"profile {label}: rounds={rounds} engine_ms={secs * 1e3} "
          f"device_busy_ms={busy_ms} "
          f"device_busy_ms_per_round={busy_ms / rounds} "
          f"idle_share={1 - busy_ms / (secs * 1e3)}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        us = e.self_device_time_total
        print(f"profile {label} kernel: calls={e.count} "
              f"us_per_call={us / e.count} share={us / 1e3 / busy_ms} "
              f"name={e.key[:100]!r}")


def many_phase(torch, mk, dev, card, arrays, single_msgs_per_s):
    """Phase 9 (see the module docstring).  ``arrays``: phase 3's
    coloring-10k and phase 5's per-factor-100k-d10 arrays;
    ``single_msgs_per_s``: phase 3's msgs/s.  Returns (batched kernel
    rows, launches by kernel entry)."""
    from argparse import Namespace

    from pydcop_tpu_torch.algorithms import load_algorithm_module, maxsum
    from pydcop_tpu_torch.algorithms import prepare_algo_params
    from pydcop_tpu_torch.api import solve, solve_compiled, solve_many
    from pydcop_tpu_torch.commands.generators import graphcoloring
    from pydcop_tpu_torch.commands.generators import meetingscheduling
    from pydcop_tpu_torch.commands.generators.secp import generate as secp
    from pydcop_tpu_torch.engine.batched import run_batched, run_many_batched
    from pydcop_tpu_torch.ops.compile import (
        compile_dcop,
        compile_from_arrays,
        stack_problems,
    )
    from pydcop_tpu_torch.ops.generate import coloring_arrays

    params = prepare_algo_params({"damping": 0.5}, maxsum.algo_params)
    counts = {}
    t_lap = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        print(f"phase {part} seconds={now - t_lap[0]}")
        t_lap[0] = now

    # -- 9b. configuration 3: Max-Sum best of 8 on the scale-free 1k
    t0 = time.perf_counter()
    c3 = graphcoloring.generate(Namespace(**CONFIG3_SPEC))
    p3c = compile_dcop(c3, device="cpu")
    p3 = p3c.to(dev)
    print(f"build config3: n_vars={p3.n_vars} n_edges={p3.n_edges} "
          f"host_seconds={time.perf_counter() - t0}")
    rows = batched_rows(torch, mk, dev, p3.buckets[2].n_cons, p3.n_edges,
                        p3.n_vars)
    lap("9a")
    kw = dict(chunk_size=256, cost_every=8, n_restarts=8)
    solve_compiled(p3, "maxsum", {"damping": 0.5}, rounds=8, **kw)  # warm
    torch.cuda.synchronize()
    mk.reset_launches()
    res = solve_compiled(p3, "maxsum", {"damping": 0.5}, rounds=1024, **kw)
    torch.cuda.synchronize()
    got = expect_launches(mk, "config3-scalefree1k-maxsum-K8",
                          {"factor_round_binary": 1024, "q_update": 1024})
    counts["factor_round_binary.batched_restarts"] = got[
        "factor_round_binary"]
    counts["q_update.batched_restarts"] = got["q_update"]
    rc = res["restart_costs"]
    if len(rc) != 8 or res["cost"] != min(rc) or not all(
            math.isfinite(c) for c in rc):
        raise AssertionError(f"config3: bad restart result {rc}")
    print(f"solve config3-scalefree1k-maxsum-K8: n_vars={p3.n_vars} "
          f"n_real_edges={p3.n_real_edges} restarts=8 rounds=1024 "
          f"msg_count={res['msg_count']} engine_seconds={res['time']} "
          f"msgs_per_s={res['msg_count'] / res['time']} "
          f"best_cost={res['cost']} restart_costs={rc} launches={got} "
          f"card={card}")
    rkw = dict(rounds=256, chunk_size=256, cost_every=8, n_restarts=8,
               return_state=True)
    rc_dev = run_batched(p3, maxsum, params, **rkw)
    rc_cpu = run_batched(p3c, maxsum, params, **rkw)
    for k in ("q", "r", "values", "noise"):
        if not same_bits(torch, rc_dev.state[k].float(),
                         rc_cpu.state[k].float()):
            raise AssertionError(f"config3: card and CPU differ in {k}")
    print(f"card-vs-cpu config3-scalefree1k-maxsum-K8: 256 rounds, 8 "
          f"restarts, q/r/values bit-equal, restart costs card "
          f"{list(rc_dev.restart_costs)} cpu {list(rc_cpu.restart_costs)}")
    profile_rounds(torch, run_batched, maxsum, params, p3, 32,
                   "config3-scalefree1k-maxsum-K8", n_restarts=8)
    lap("9b")

    # -- 9c. configuration 5: Max-Sum on the PEAV meeting scheduling
    t0 = time.perf_counter()
    c5 = meetingscheduling.generate(Namespace(**CONFIG5_SPEC))
    t1 = time.perf_counter()
    p5c = compile_dcop(c5, device="cpu")
    p5 = p5c.to(dev)
    print(f"build config5: n_vars={p5.n_vars} n_constraints="
          f"{len(c5.constraints)} binary={p5.buckets[2].n_cons} "
          f"n_edges={p5.n_edges} d={p5.d_max} generate_seconds={t1 - t0} "
          f"compile_seconds={time.perf_counter() - t1}")
    if set(p5.buckets) != {2} or p5.buckets[2].shared_table:
        raise AssertionError("config5: expected per-factor binary tables")
    print(f"instance config5-meeting10k-maxsum: factor_round_binary "
          f"d={p5.d_max} "
          f"{'unrolled' if p5.d_max in mk.UNROLLED_D else 'tile'}; "
          f"q_update d={p5.d_max} "
          f"{q_instance(mk, p5.d_max, 0)}")
    counts5 = main_path(torch, mk, solve_compiled, p5, 512, 128,
                        {"factor_round_binary": 512, "q_update": 512,
                         "factor_round_binary_shared": 0},
                        "config5-meeting10k-maxsum", card)
    card_vs_cpu(torch, mk, run_batched, maxsum, params, p5, p5c, 64, 64,
                "config5-meeting10k-maxsum",
                {"factor_round_binary": 64, "q_update": 64})
    profile_rounds(torch, run_batched, maxsum, params, p5, 32,
                   "config5-meeting10k-maxsum")
    counts["config5"] = counts5
    del p5, p5c, c5
    lap("9c")

    # -- 9d. bench.py's solve_many stage: DSA-B on small colorings
    base = [coloring_dcop(32 - 2 * i, degree=3, seed=100 + i)
            for i in range(4)]
    dsa = {"variant": "B", "probability": 0.7}
    dkw = dict(rounds=MANY_ROUNDS, chunk_size=64, pad_policy="pow2")
    warm = dict(dkw, rounds=8)
    solve(base[0], "dsa", dsa, seed=0, **warm)  # warm both paths
    solve_many(base[:1], "dsa", dsa, seed=0, **warm)
    for K in MANY_KS:
        batch = [base[i % 4] for i in range(K)]
        torch.cuda.synchronize()
        mk.reset_launches()
        t0 = time.perf_counter()
        many = solve_many(batch, "dsa", dsa, seed=list(range(K)), **dkw)
        torch.cuda.synchronize()
        dt_many = time.perf_counter() - t0
        expect_launches(mk, f"many-coloring-dsaB-K{K}", {})
        t0 = time.perf_counter()
        seq = [solve(d, "dsa", dsa, seed=i, **dkw)
               for i, d in enumerate(batch)]
        torch.cuda.synchronize()
        dt_seq = time.perf_counter() - t0
        for r in many + seq:
            if r["cycle"] != MANY_ROUNDS or not math.isfinite(r["cost"]):
                raise AssertionError(f"many-coloring-dsaB-K{K}: bad result")
        print(f"solve many-coloring-dsaB-K{K}: instances={K} "
              f"instances_batched={[r['instances_batched'] for r in many]} "
              f"instances_per_s_batched={K / dt_many} "
              f"instances_per_s_sequential={K / dt_seq} "
              f"speedup={dt_seq / dt_many} "
              f"mean_cost_batched={sum(r['cost'] for r in many) / K} "
              f"mean_cost_sequential={sum(r['cost'] for r in seq) / K} "
              f"card={card}")
    lap("9d")

    # -- 9e. 8 coloring-10k instances through solve_many (pow2): phase
    # 3's graph and seven rewirings of it, each with its own noise
    s, t, u = arrays["coloring-10k"]
    seeds = list(range(1, 9))
    graphs = [(s, u)] + [
        (rewired(s, sd), coloring_arrays(len(u), colors=3, degree=3,
                                         seed=sd)[2])
        for sd in seeds[1:]
    ]
    pes = [compile_from_arrays(sk, t, 3, unary=uk, pad_policy="pow2",
                               device=dev) for sk, uk in graphs]
    mkw = dict(chunk_size=256, seed=seeds)
    solve_many(pes, "maxsum", {"damping": 0.5}, rounds=8, **mkw)  # warm
    torch.cuda.synchronize()
    mk.reset_launches()
    many = solve_many(pes, "maxsum", {"damping": 0.5}, rounds=1024, **mkw)
    torch.cuda.synchronize()
    got = expect_launches(mk, "many-coloring10k-maxsum-I8",
                          {"factor_round_binary": 1024, "q_update": 1024})
    counts["factor_round_binary.batched_instances"] = got[
        "factor_round_binary"]
    counts["q_update.batched_instances_pow2"] = got["q_update"]
    secs = many[0]["time"] * len(many)  # the group's engine time
    msgs = sum(r["msg_count"] for r in many)
    if {r["instances_batched"] for r in many} != {8}:
        raise AssertionError("many-coloring10k-maxsum-I8: not one group")
    ratio = (msgs / secs / single_msgs_per_s if single_msgs_per_s
             else "not measured")
    print(f"solve many-coloring10k-maxsum-I8: instances=8 (phase 3's graph "
          f"and 7 degree-preserving rewirings) n_vars={pes[0].n_vars} "
          f"n_real_edges={pes[0].n_real_edges} distinct_graphs="
          f"{len({sk.tobytes() for sk, _ in graphs})} rounds=1024 "
          f"msg_count={msgs} engine_seconds={secs} msgs_per_s={msgs / secs} "
          f"single_instance_msgs_per_s={single_msgs_per_s} ratio={ratio} "
          f"costs={[r['cost'] for r in many]} launches={got} card={card}")
    short = solve_many(pes, "maxsum", {"damping": 0.5}, rounds=128,
                       chunk_size=128, seed=seeds)
    for sd, p, r in zip(seeds, pes, short):
        one = solve_compiled(p, "maxsum", {"damping": 0.5}, rounds=128,
                             chunk_size=128, seed=sd)
        same_result(f"many-coloring10k-maxsum-I8 instance {sd}", r, one)
    print("equal many-coloring10k-maxsum-I8: 128 rounds, 8 instances, "
          "every result key (assignments, costs, cost trace) equal to each "
          "sequential solve")

    # the unpadded group on the same graphs: stacked shared tables
    # (per-instance weights) and per-instance damping
    probs = [compile_from_arrays(sk, t * (1 + 0.1 * (sd - 1)), 3, unary=uk,
                                 device=dev)
             for sd, (sk, uk) in zip(seeds, graphs)]
    damp = [{"damping": 0.5 + 0.05 * (sd - 1)} for sd in seeds]
    solve_many(probs, "maxsum", damp, rounds=8, chunk_size=128, seed=seeds)
    torch.cuda.synchronize()
    mk.reset_launches()
    many = solve_many(probs, "maxsum", damp, rounds=128, chunk_size=128,
                      seed=seeds)
    torch.cuda.synchronize()
    got = expect_launches(mk, "many-coloring10k-maxsum-I8-shared",
                          {"factor_round_binary_shared": 128,
                           "q_update": 128})
    counts["factor_round_binary_shared.batched_instances"] = got[
        "factor_round_binary_shared"]
    counts["q_update.batched_instances"] = got["q_update"]
    if {r["instances_batched"] for r in many} != {8}:
        raise AssertionError("many-coloring10k-maxsum-I8-shared: not one "
                             "group")
    secs = many[0]["time"] * len(many)
    msgs = sum(r["msg_count"] for r in many)
    for sd, p, dp, r in zip(seeds, probs, damp, many):
        one = solve_compiled(p, "maxsum", dp, rounds=128, chunk_size=128,
                             seed=sd)
        same_result(f"many-coloring10k-maxsum-I8-shared instance {sd}", r,
                    one)
    print(f"solve many-coloring10k-maxsum-I8-shared: instances=8 rounds=128 "
          f"stacked shared tables, damping 0.50..0.85, msgs_per_s="
          f"{msgs / secs} every result key equal to each sequential solve "
          f"launches={got} card={card}")
    union_apply_card_vs_cpu(
        torch, mk, dev,
        [compile_from_arrays(sk, t, 3, unary=uk, pad_policy="pow2",
                             device="cpu") for sk, uk in graphs],
        32, "many-coloring10k-dsaB-union")
    [grp] = stack_problems(pes)
    ms = load_algorithm_module("maxsum")
    profile_call(torch, "many-coloring10k-maxsum-I8", lambda: run_many_batched(
        grp, ms, params, rounds=64, chunk_size=64, cost_every=8,
        seeds=seeds)[0].time, 64)
    del pes, probs, grp
    lap("9e")

    # -- per-factor-100k-d10 with 2 restarts: the batched lane tiles
    s10, tabs10, u10 = arrays["per-factor-100k-d10"]
    p10c = compile_from_arrays(s10, tabs10, 10, unary=u10, device="cpu")
    p10 = p10c.to(dev)
    mk.reset_launches()
    r10 = run_batched(p10, maxsum, params, rounds=16, chunk_size=16,
                      cost_every=8, n_restarts=2)
    torch.cuda.synchronize()
    got = expect_launches(mk, "per-factor-100k-d10-K2",
                          {"factor_round_binary": 16, "q_update": 16})
    counts["factor_round_binary.runtime_d.batched"] = got[
        "factor_round_binary"]
    counts["q_update.runtime_d.batched"] = got["q_update"]
    print(f"solve per-factor-100k-d10-K2: rounds=16 restarts=2 engine_seconds="
          f"{r10.time} restart_costs={list(r10.restart_costs)} "
          f"launches={got}")
    card_vs_cpu(torch, mk, run_batched, maxsum, params, p10, p10c, 2, 2,
                "per-factor-100k-d10-K2", n_restarts=2)
    del p10, p10c
    torch.cuda.empty_cache()
    lap("9-d10")

    # -- 9f. bench.py's 8 SECP instances through solve_many (DPOP)
    dcops = [secp(Namespace(**SECP_SPEC)) for _ in range(8)]
    level = {"util_device": "always", "util_batch": "level"}
    solve_many(dcops, "dpop", level, pad_policy="pow2")  # warm
    t0 = time.perf_counter()
    many = solve_many(dcops, "dpop", level, pad_policy="pow2")
    dt_many = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = [solve(d, "dpop", level, pad_policy="pow2") for d in dcops]
    dt_seq = time.perf_counter() - t0
    for a, b in zip(many, seq):
        for k in ("assignment", "cost", "util_dispatches", "util_cells",
                  "util_device_nodes", "util_host_nodes"):
            if a[k] != b[k]:
                raise AssertionError(f"many-secp-dpop-K8: {k} differs")
    print(f"solve many-secp-dpop-K8: instances=8 instances_batched="
          f"{many[0]['instances_batched']} instances_per_s_batched="
          f"{8 / dt_many} instances_per_s_sequential={8 / dt_seq} "
          f"speedup={dt_seq / dt_many} util_dispatches={many[0]['util_dispatches']} "
          f"util_cells={many[0]['util_cells']} cost={many[0]['cost']} "
          f"equal_to_sequential=True card={card}")
    lap("9f")
    return rows, counts


# -- phase 10: exact inference ----------------------------------------------

SEM_SECP_SPEC = dict(  # bench.py:1046-1056, the semiring_infer stage's SECP
    nb_lights=192, nb_models=192, nb_rules=48, light_levels=5,
    model_arity=3, zone_size=8, zone_layout="tiled", efficiency_weight=0.1,
    capacity=100.0, seed=7,
)
INFER_COUNTS = ("cells", "dispatches", "device_nodes", "host_nodes", "width")
INFER_REPS = 2  # few: the whole script has one time limit
INFER_DISPATCHES = {}  # semiring: dispatches of one warm card run per query


def coloring_tree_dcop(n_vars=10_000, colors=3):
    """``bench.py:946-969`` ``_build_coloring_tree`` rebuilt with the
    port's model objects: variable i joins a uniformly drawn earlier one
    (``random.Random(1)``) with the colours' identity table."""
    import random

    import numpy as np

    from pydcop_tpu_torch.dcop import (
        DCOP, AgentDef, Domain, NAryMatrixRelation, Variable,
    )

    rnd = random.Random(1)
    dom = Domain("colors", "", list(range(colors)))
    tree = DCOP(f"tree_coloring_{n_vars}")
    vs = [Variable(f"v{i}", dom) for i in range(n_vars)]
    for v in vs:
        tree.add_variable(v)
    eq = np.eye(colors)
    for i in range(1, n_vars):
        j = rnd.randrange(i)
        tree.add_constraint(NAryMatrixRelation([vs[j], vs[i]], eq,
                                               name=f"c{i}"))
    tree.add_agents([AgentDef("a0")])
    return tree


def record_contractions(sr_mod):
    """Wrap the sweep's ``contraction_kernel`` for one run: each dispatch's
    semiring, joined shape, part shapes and stack height.  Returns the log
    and the function that unwraps."""
    log, inner = [], sr_mod.contraction_kernel

    def wrapped(sr, shape, part_shapes, batched=False, **kw):
        fn = inner(sr, shape, part_shapes, batched=batched, **kw)
        name = sr_mod.get_semiring(sr).name

        def run(*tabs):
            lead = tuple(tabs[0].shape[:1]) if batched else ()
            log.append((name, tuple(shape), tuple(part_shapes), lead))
            return fn(*tabs)

        return run

    sr_mod.contraction_kernel = wrapped
    return log, lambda: setattr(sr_mod, "contraction_kernel", inner)


def contraction_bytes(sr_name, shape, part_shapes, lead, kk=1):
    """(bytes the contraction must move, its f32 operations): each part
    read once and each output written once; a join add per part and cell,
    plus the projection's compare/exp/add per cell (kbest: its sorts'
    compares, d·k·log2(d·k) per row cell)."""
    cells = math.prod(lead + tuple(shape))
    rows = cells // shape[-1]
    parts = sum(4 * math.prod(lead + tuple(p)) for p in part_shapes)
    n = len(part_shapes)
    if sr_name.startswith("kbest"):
        out = rows * kk * (4 + 4 + 8 * (1 + max(n - 2, 0)))
        cand = shape[-1] * kk
        ops = cells * kk * n + rows * cand * max(1, cand.bit_length())
    elif sr_name == "expectation":
        out, ops = 8 * rows, cells * (2 * n + 6)
    elif sr_name in ("min_sum", "max_sum"):
        out, ops = 12 * rows, cells * (n + 4)
    else:
        out, ops = 4 * rows, cells * (n + 4)
    return parts + out, ops


def eager_ms(torch, fn, calls: int = 5) -> float:
    """Time of one call as the sweep makes it (eager operations, host
    launches included): CUDA events around ``calls`` calls, the median of
    5 such samples after a warm-up."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()

    return statistics.median(_event_ms(torch, run) / calls for _ in range(5))


def contraction_row(torch, dev, sr_mod, name, shape, part_shapes, lead,
                    dispatches, seed):
    """One semiring's contraction on the card at a dispatch shape of the
    phase (random parts; kbest cells sorted ascending), its time beside the
    bound, and the card against the CPU on the same parts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sr = sr_mod.get_semiring(name)
    parts = []
    for ps in part_shapes:
        p = (rng.random(lead + tuple(ps), dtype=np.float32) * 10)
        if sr.kind == "kbest" and len(ps) == len(shape) + 1:
            p = np.sort(p, axis=-1)
        parts.append(p.astype(np.float32))
    fn = sr_mod.contraction_kernel(sr, shape, part_shapes,
                                   batched=bool(lead))
    on_card = [torch.from_numpy(p).to(dev) for p in parts]
    got = [o.cpu() for o in fn(*on_card)]
    want = fn(*(torch.from_numpy(p) for p in parts))
    if sr.idempotent or sr.kind == "kbest":
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"contraction {name}: card differs from "
                                 "the CPU")
        err = 0.0
    else:
        err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
        if not all(torch.allclose(g, w, rtol=1e-5, atol=1e-5)
                   for g, w in zip(got, want)):
            raise AssertionError(f"contraction {name}: card far from CPU")
    ms = eager_ms(torch, lambda: fn(*on_card))
    nbytes, nops = contraction_bytes(name, shape, part_shapes, lead,
                                     sr.cell_width)
    b_ms, b_by = bound_ms(nbytes, nops)
    print(f"contraction-{name}: joined={shape} "
          f"stack={lead[0] if lead else 1} parts={len(part_shapes)} "
          f"dispatches={dispatches} ms={ms} bound_ms={b_ms} bound_by={b_by} "
          f"share_of_bound={b_ms / ms} card_vs_cpu_max_abs_err={err} "
          "library_ms=None")
    del on_card
    torch.cuda.empty_cache()


def check_infer_pair(label, query, card_r, cpu_r, host_r):
    """The gates between a card run, the port's CPU run and the host f64
    run (``device="never"``) of one query."""
    for name, r in (("card", card_r), ("cpu", cpu_r), ("never", host_r)):
        if r["status"] != "finished":
            raise AssertionError(f"{label} {query}: {name} {r['status']}")
    for k in INFER_COUNTS:
        if card_r[k] != cpu_r[k]:
            raise AssertionError(
                f"{label} {query}: {k} card {card_r[k]} cpu {cpu_r[k]}")
    if card_r["telemetry"]["counters"] != cpu_r["telemetry"]["counters"]:
        raise AssertionError(f"{label} {query}: telemetry counters differ "
                             "between card and CPU")
    kind = query.split(":")[0]
    if kind in ("map", "kbest", "marginal_map"):
        keys = ("assignment", "cost") + (
            ("costs", "solutions") if kind == "kbest" else ())
        for name, r in (("cpu", cpu_r), ("never", host_r)):
            for k in keys:
                if r.get(k) != card_r.get(k):
                    raise AssertionError(
                        f"{label} {query}: {k} card differs from {name}")
        return 0.0
    err = card_r["error_bound"]
    dev = abs(card_r["log_z"] - host_r["log_z"])
    if dev > err + 1e-9:
        raise AssertionError(f"{label} {query}: |log_z card - never| {dev} "
                             f"> error_bound {err}")
    if kind == "marginals":
        # each belief cell is off by at most err in the log domain, so a
        # normalised probability moves by at most tanh(err / 2) < err
        for v, p in card_r["marginals"].items():
            q = host_r["marginals"][v]
            dp = max(abs(a - b) for a, b in zip(p, q))
            if dp > err + 1e-9:
                raise AssertionError(f"{label} marginals {v}: {dp} > "
                                     f"error_bound {err}")
            dev = max(dev, dp)
    if kind == "expectation":
        de = abs(card_r["e_cost"] - host_r["e_cost"])
        if de > err + 1e-9:
            raise AssertionError(f"{label} expectation: |e_cost card - "
                                 f"never| {de} > error_bound {err}")
        dev = max(dev, de)
    return dev


def infer_cell(torch, infer, label, dcop, query, card, **kw):
    """One query of one cell: INFER_REPS card runs (the first is the cold
    one; the median time of the others), peak device memory, the port's
    CPU run and the host f64 run (``device="never"``), checked against
    each other;
    one line of numbers.  A card run that dispatched nothing ran on the
    host only, the same computation as the CPU run, which is then not
    repeated."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    secs, outs = [], []
    for _ in range(INFER_REPS):
        t0 = time.perf_counter()
        outs.append(infer(dcop, query, **kw))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    r = outs[-1]
    for k in INFER_COUNTS:
        if outs[0][k] != r[k]:
            raise AssertionError(f"{label} {query}: cold and warm {k} differ")
    cpu_r = (infer(dcop, query, torch_device="cpu", **kw)
             if r["dispatches"] else r)
    host_r = infer(dcop, query, torch_device="cpu",
                   **dict(kw, device="never"))
    dev = check_infer_pair(label, query, r, cpu_r, host_r)
    INFER_DISPATCHES[r["semiring"]] = (
        INFER_DISPATCHES.get(r["semiring"], 0) + r["dispatches"])
    sec = statistics.median(secs[1:])  # the warm runs
    value = {k: r[k] for k in ("log_z", "cost", "e_cost") if k in r}
    print(f"infer {label} {query}: device={kw.get('device', 'auto')} "
          f"seconds={sec} cold_seconds={secs[0]} cells={r['cells']} "
          f"cells_per_s={r['cells'] / sec} "
          f"dispatches={r['dispatches']} device_nodes={r['device_nodes']} "
          f"host_nodes={r['host_nodes']} width={r['width']} "
          f"error_bound={r['error_bound']} card_vs_never={dev} "
          f"value={value} peak_memory_bytes_above_start={peak} "
          f"cpu_seconds={cpu_r['time'] if r['dispatches'] else None} "
          f"never_seconds={host_r['time']} "
          f"counters={r['telemetry']['counters']} card={card}")
    return r, host_r


def profile_infer(torch, infer, dcop, query, label, kw, dispatch_log):
    """Device time of one warm card run by kind (torch.profiler): the
    contraction's kernels against the bound of the run's dispatches (each
    part read once, each output written once), the copies apart, and the
    eager kernel launches the run's dispatches made."""
    from torch.profiler import ProfilerActivity, profile

    start = len(dispatch_log)
    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        infer(dcop, query, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    copy = sum(e.self_device_time_total for e in kern
               if "memcpy" in e.key.lower()) / 1e3
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    n_copies = sum(e.count for e in kern if "memcpy" in e.key.lower())
    n_kernels = sum(e.count for e in kern) - n_copies
    if not kern or busy <= 0:
        raise AssertionError(f"profile {label}: no device time recorded")
    nbytes = nops = 0
    for name, shape, ps, lead in dispatch_log[start:]:
        b, o = contraction_bytes(name, shape, ps, lead)
        nbytes, nops = nbytes + b, nops + o
    b_ms, b_by = bound_ms(nbytes, nops)
    contraction = busy - copy
    n_disp = len(dispatch_log) - start
    print(f"profile {label}: wall_ms={wall_ms} device_busy_ms={busy} "
          f"idle_share={1 - busy / wall_ms} copy_ms={copy} "
          f"contraction_device_ms={contraction} dispatches={n_disp} "
          f"kernel_launches={n_kernels} copies={n_copies} "
          f"kernel_launches_per_dispatch={n_kernels / max(n_disp, 1)} "
          f"bound_ms={b_ms} "
          f"bound_by={b_by} share_of_bound={b_ms / contraction}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        us = e.self_device_time_total
        print(f"profile {label} kernel: calls={e.count} "
              f"us_per_call={us / e.count} share={us / 1e3 / busy} "
              f"name={e.key[:100]!r}")


def infer_phase(torch, dev, card):
    """Phase 10 (see the module docstring)."""
    from argparse import Namespace

    from pydcop_tpu_torch.api import infer, infer_many, solve
    from pydcop_tpu_torch.commands.generators.secp import generate
    from pydcop_tpu_torch.ops import semiring as sr_mod

    log, unwrap = record_contractions(sr_mod)
    try:
        # -- 10a. the semiring stages' 10k coloring tree
        tree = coloring_tree_dcop()
        runs = {}
        for query in ("log_z", "marginals", "map", "kbest:5",
                      "expectation"):
            runs[query] = infer_cell(torch, infer, "infer-tree10k", tree,
                                     query, card)
        dpop_r = solve(tree, "dpop", {"util_device": "auto"})
        if dpop_r["cost"] != runs["map"][0]["cost"]:
            raise AssertionError("infer-tree10k: map cost differs from DPOP")
        kb = runs["kbest:5"][0]
        costs = kb["costs"]
        sols = [tuple(sorted(s["assignment"].items()))
                for s in kb["solutions"]]
        if (costs != sorted(costs) or len(set(sols)) != len(sols)
                or costs[0] != runs["map"][0]["cost"]):
            raise AssertionError("infer-tree10k: kbest list not ascending, "
                                 "not distinct or not led by map")
        if abs(runs["expectation"][0]["log_z"]
               - runs["log_z"][0]["log_z"]) > 1e-9:
            raise AssertionError("infer-tree10k: expectation log_z differs")
        print(f"check infer-tree10k: map_cost={runs['map'][0]['cost']} "
              f"dpop_cost={dpop_r['cost']} kbest_costs={costs} "
              f"log_z={runs['log_z'][0]['log_z']} "
              f"expectation_log_z={runs['expectation'][0]['log_z']} "
              f"e_cost={runs['expectation'][0]['e_cost']} equal=True")
        r, _ = infer_cell(torch, infer, "infer-tree10k", tree, "log_z",
                          card, device="always")
        if r["device_nodes"] <= 0:
            raise AssertionError("infer-tree10k log_z: no device node")

        # -- 10b. the semiring_infer stage's tiled SECP on the card
        secp_kw = dict(device="always", device_min_cells=256,
                       pad_policy="pow2")
        secps = [generate(Namespace(**dict(SEM_SECP_SPEC, seed=s)))
                 for s in (7, 8, 9, 10)]
        # kbest and expectation run on the card here only: the tree's
        # tables are too small for device="auto"
        for query, extra in (("log_z", {"tol": float("inf")}), ("map", {}),
                             ("kbest:5", {}),
                             ("expectation", {"tol": float("inf")})):
            r, _ = infer_cell(torch, infer, "infer-secp192-tiled", secps[0],
                              query, card, **secp_kw, **extra)
            if r["device_nodes"] <= 0:
                raise AssertionError(f"infer-secp192-tiled {query}: no "
                                     "device node")

        # -- 10c. configuration 6's hub tree: the stacks at a real size
        hub = hubtree_dcop()
        infer_cell(torch, infer, "infer-hubtree-d24", hub, "map", card)
        hub_kw = dict(device="always", tol=float("inf"))
        for query in ("log_z", "marginals"):
            r, _ = infer_cell(torch, infer, "infer-hubtree-d24", hub, query,
                              card, **hub_kw)
            if r["device_nodes"] <= 0:
                raise AssertionError(f"infer-hubtree-d24 {query}: no device "
                                     "node")
        profile_infer(torch, infer, hub, "log_z", "infer-hubtree-d24-log_z",
                      hub_kw, log)

        # -- 10d. four SECP instances in one merged sweep
        for query, extra in (("log_z", {"tol": float("inf")}), ("map", {})):
            kw = dict(secp_kw, **extra)
            infer_many(secps, query, **kw)  # cold
            t0 = time.perf_counter()
            many = infer_many(secps, query, **kw)
            torch.cuda.synchronize()
            t_many = time.perf_counter() - t0
            t0 = time.perf_counter()
            seq = [infer(d, query, **kw) for d in secps]
            torch.cuda.synchronize()
            t_seq = time.perf_counter() - t0
            cpu = infer_many(secps, query, torch_device="cpu", **kw)
            for i, (m_, s_, c_) in enumerate(zip(many, seq, cpu)):
                for k in set(s_) - {"time", "instances_batched",
                                    "telemetry"}:
                    if m_[k] != s_[k]:
                        raise AssertionError(
                            f"infer-many-secp192-I4 {query} #{i}: {k} "
                            "differs from its sequential infer")
                for k in INFER_COUNTS:
                    if m_[k] != c_[k]:
                        raise AssertionError(
                            f"infer-many-secp192-I4 {query} #{i}: {k} card "
                            "differs from the CPU")
                if (m_["telemetry"]["counters"]
                        != c_["telemetry"]["counters"]):
                    raise AssertionError(
                        f"infer-many-secp192-I4 {query} #{i}: telemetry "
                        "counters differ between card and CPU")
                if m_["device_nodes"] <= 0:
                    raise AssertionError("infer-many-secp192-I4: no device "
                                         "node")
            merged = many[0]["telemetry"]["counters"]["semiring.dispatches"]
            single = sum(s_["dispatches"] for s_ in seq)
            if merged >= single:
                raise AssertionError("infer-many-secp192-I4: merging saved "
                                     "no dispatch")
            print(f"infer infer-many-secp192-I4 {query}: instances=4 "
                  f"seconds={t_many} sequential_seconds={t_seq} "
                  f"instances_per_s={4 / t_many} "
                  f"sequential_instances_per_s={4 / t_seq} "
                  f"dispatches={merged} sequential_dispatches={single} "
                  f"cells={sum(m_['cells'] for m_ in many)} "
                  f"counters={many[0]['telemetry']['counters']} "
                  f"equal_to_sequential=True card={card}")
    finally:
        unwrap()

    # -- 10e. each semiring's contraction at its largest dispatch here
    largest = {}
    for name, shape, ps, lead in log:
        cells = math.prod(lead + shape)
        if cells > largest.get(name, (0,))[0]:
            largest[name] = (cells, shape, ps, lead)
    for i, name in enumerate(sorted(largest)):
        _, shape, ps, lead = largest[name]
        contraction_row(torch, dev, sr_mod, name, shape, ps, lead,
                        INFER_DISPATCHES.get(name, 0), seed=30 + i)


# -- phase 11: the rest of the semiring core ---------------------------------

PREC_SPEC = dict(  # bench.py:236-243, the precision stage's tiled SECP
    nb_lights=384, nb_models=384, nb_rules=96, light_levels=6,
    model_arity=3, zone_size=8, zone_layout="tiled", efficiency_weight=0.1,
    capacity=100.0, seed=7,
)
MB_SPEC = dict(  # bench.py:206-212, the membound stage's overlap SECP
    nb_lights=96, nb_models=96, nb_rules=0, light_levels=4, model_arity=5,
    zone_size=8, zone_layout="overlap", zone_overlap=5,
    efficiency_weight=0.1, capacity=100.0, seed=7,
)
MB_BUDGET = 16_384  # bytes; the naive peak is 262,144
MB_CTL_SPEC = dict(MB_SPEC, nb_models=64, zone_size=7, zone_overlap=3,
                   model_arity=4)  # bench.py:213-217
MB_CTL_BUDGET = 2_048
TASKS_SPEC = dict(  # bench.py:287-292, the sparse stage's workload
    nb_tasks=26, nb_slots=10, window=6, stride=5, forbid_density=0.2,
    lateness_weight=1.0, capacity=100.0, seed=11,
)
GUARD_SPEC = dict(  # bench.py:258-267, the bnb stage's hard-capped SECP
    nb_lights=28, nb_models=18, nb_rules=8, light_levels=10,
    model_arity=5, zone_size=8, zone_layout="overlap", zone_overlap=5,
    efficiency_weight=0.1, capacity=100.0, seed=11, hard_cap=1.02,
)
SYNCBB_SPEC = dict(  # bench_configs.py:53-62 (configuration 4's SECP) at
    # 10 of its 40 lights: SyncBB's search is exponential in them
    nb_lights=10, nb_models=8, nb_rules=5, light_levels=8, model_arity=3,
    efficiency_weight=0.1, capacity=1000.0, seed=1,
)
HUB_CUT_BUDGET = 4 * 24 ** 3  # the hub tree's leaf tables one axis down
OOM_HEADROOM = 40 << 20  # the capped allocator's room above its start,
# below the 67 MB one leaf join of the d-64 hub tree needs
STORAGE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
CARD = {"card": None}  # the card's name and power limit, set by core_phase


def emit(phase, cell, **fields):
    """One cell as one JSON line, with the card it ran on (one write, so
    that cells run side by side never share a line)."""
    sys.stdout.write(json.dumps({"phase": phase, "cell": cell, **fields,
                                 "card": CARD["card"]}) + "\n")
    sys.stdout.flush()


def oom_hub_dcop():
    """Phase 8's hub tree with d = 64 and 4 leaves (``RandomState(6)``):
    each leaf's join is a 64^4 table (67 MB at f32), the size a capped
    allocator refuses, while a hub cut leaves 64^3 tables per lane."""
    import numpy as np

    from pydcop_tpu_torch.dcop import DCOP, Domain, NAryMatrixRelation, Variable

    rnd = np.random.RandomState(6)
    d, n_hubs, n_leaves = 64, 3, 4
    dom = Domain("d", "", list(range(d)))
    dcop = DCOP("hubtree-d64", objective="min")
    hubs = [Variable(f"h{i}", dom) for i in range(n_hubs)]
    for h in hubs:
        dcop.add_variable(h)
    ci = 0
    for i in range(1, n_hubs):
        dcop.add_constraint(NAryMatrixRelation(
            [hubs[i - 1], hubs[i]], rnd.uniform(0, 10, (d, d)),
            name=f"c{ci}"))
        ci += 1
    for i in range(n_leaves):
        leaf = Variable(f"x{i}", dom)
        dcop.add_variable(leaf)
        for h in hubs:
            dcop.add_constraint(NAryMatrixRelation(
                [h, leaf], rnd.uniform(0, 10, (d, d)), name=f"c{ci}"))
            ci += 1
    return dcop


def core_counters(r, prefix=("semiring.", "membound.", "dpop.")):
    return {k: v for k, v in r["telemetry"]["counters"].items()
            if k.startswith(prefix)}


def record_core_dispatches(sr_mod):
    """Wrap the dense and the sparse contraction builders for a stretch
    of runs: each dispatch's semiring, storage dtype, shapes, stack height
    and (for the largest of each kind) its arguments, copied to the
    host.  Returns the log and the function that unwraps."""
    log = {"dense": [], "sparse": {}}
    dense, sparse = sr_mod.contraction_kernel, sr_mod.sparse_contraction_kernel
    dispatch_sparse = sr_mod._dispatch_sparse
    real = {"rows": None}  # the sparse dispatch in flight: its real sizes

    def wrap_dispatch_sparse(sw, sr, entries, *args, **kw):
        real["rows"] = [(sp.n_cand, sp.n_seg,
                         sum(f.size for f in sp.part_flats))
                        for _, sp in entries]
        return dispatch_sparse(sw, sr, entries, *args, **kw)

    def wrap_dense(sr, shape, part_shapes, batched=False, table_dtype="f32",
                   **kw):
        fn = dense(sr, shape, part_shapes, batched=batched,
                   table_dtype=table_dtype, **kw)
        name = sr_mod.get_semiring(sr).name

        def run(*args):
            lead = tuple(args[-1].shape[:1]) if batched else ()
            log["dense"].append((name, table_dtype, tuple(shape),
                                 tuple(part_shapes), lead))
            return fn(*args)

        return run

    def wrap_sparse(sr, n_cand_b, n_seg_b, part_lens_b, table_dtype="f32",
                    bnb=False, **kw):
        fn = sparse(sr, n_cand_b, n_seg_b, part_lens_b,
                    table_dtype=table_dtype, bnb=bnb, **kw)
        name = sr_mod.get_semiring(sr).name

        def run(*args):
            rows = int(args[-1].shape[0])
            size = rows * n_cand_b
            best = log["sparse"].get((name, table_dtype))
            if best is None or size > best[0]:
                log["sparse"][(name, table_dtype)] = (
                    size, (n_cand_b, n_seg_b, tuple(part_lens_b)),
                    [a.cpu() for a in args], real["rows"], bnb)
            return fn(*args)

        return run

    sr_mod.contraction_kernel = wrap_dense
    sr_mod.sparse_contraction_kernel = wrap_sparse
    sr_mod._dispatch_sparse = wrap_dispatch_sparse

    def unwrap():
        sr_mod.contraction_kernel = dense
        sr_mod.sparse_contraction_kernel = sparse
        sr_mod._dispatch_sparse = dispatch_sparse

    return log, unwrap


PROFILE_TRIES = 3  # profiler sessions a call may take to record events


def profiled(torch, fn, label):
    """One call of ``fn`` under torch.profiler (CPU and CUDA): its output,
    the profile and the profile's device entries (``key_averages``).  The
    profiler has lost every CUDA event of a session now and then late in
    a long process; such a session is printed and the call profiled
    again in a new one, PROFILE_TRIES sessions at most."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if kern and sum(e.self_device_time_total for e in kern) > 0:
            return out, prof, kern
        print(f"profile {label}: session {attempt} recorded no device time")
    raise AssertionError(f"profile {label}: no device time recorded in "
                         f"{PROFILE_TRIES} sessions")


def h2d_profile(torch, fn, label):
    """Host-to-device copy time and count of one call (torch.profiler's
    device events whose name says HtoD), beside the call's device busy
    time and its eager kernel launches."""
    out, prof, kern = profiled(torch, fn, label)
    h2d = [e for e in kern if "htod" in e.key.lower()]
    h2d_each = [e.device_time_total for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "htod" in e.name.lower()]
    copies = [e for e in kern if "memcpy" in e.key.lower()
              or "memset" in e.key.lower()]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    return out, {
        "h2d_ms": sum(e.self_device_time_total for e in h2d) / 1e3,
        "h2d_largest_ms": max(h2d_each, default=0.0) / 1e3,
        "h2d_copies": sum(e.count for e in h2d),
        "device_busy_ms": busy,
        "kernel_launches": sum(e.count for e in kern)
        - sum(e.count for e in copies),
    }


def peak_device_bytes(torch, fn):
    """One call and the most device memory the caching allocator held
    during it above what it held before (``max_memory_allocated``)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def same_solution(label, a, b):
    if (a["assignment"], a["cost"]) != (b["assignment"], b["cost"]):
        raise AssertionError(f"{label}: cost/assignment differ "
                             f"({a['cost']} against {b['cost']})")


def packs_phase(torch, solve, infer, generate, hub):
    """11a: the bf16/int8 UTIL packs."""
    from argparse import Namespace

    prec = generate(Namespace(**PREC_SPEC))
    oracle = solve(prec, "dpop", {"util_device": "never"}, device="cpu")
    base = {"util_device": "always", "util_batch": "level"}
    runs = {}
    for dt in ("f32", "bf16", "int8"):
        p = dict(base, table_dtype=dt)
        solve(prec, "dpop", p, pad_policy="pow2")  # cold
        r = solve(prec, "dpop", p, pad_policy="pow2")
        c = solve(prec, "dpop", p, pad_policy="pow2", device="cpu")
        same_solution(f"packs dpop-secp-384-{dt} card/host", r, oracle)
        same_solution(f"packs dpop-secp-384-{dt} card/cpu", r, c)
        if r["util_device_nodes"] <= 0:
            raise AssertionError(f"packs dpop-secp-384-{dt}: no node "
                                 "kept its device join")
        for k in DPOP_STATS:
            if r[k] != c[k]:
                raise AssertionError(f"packs dpop-secp-384-{dt}: {k} card "
                                     f"{r[k]} cpu {c[k]}")
        for k in ("semiring.precision_repairs", "semiring.int8_requant",
                  "dpop.level_dispatches"):
            if core_counters(r).get(k, 0) != core_counters(c).get(k, 0):
                raise AssertionError(f"packs dpop-secp-384-{dt}: {k} card "
                                     "differs from the CPU")
        runs[dt] = r
        emit("11a", f"dpop-secp-384-{dt}", cost=r["cost"],
             util_cells=r["util_cells"], util_time=r["util_time"],
             util_cells_per_s=r["util_cells"] / r["util_time"],
             util_dispatches=r["util_dispatches"],
             util_device_nodes=r["util_device_nodes"],
             util_host_nodes=r["util_host_nodes"],
             cpu_util_time=c["util_time"], counters=core_counters(r),
             equal_to_host_f64=True, equal_to_cpu=True)
    for dt in ("bf16", "int8"):
        same_solution(f"packs dpop-secp-384-{dt}/f32", runs[dt], runs["f32"])

    # inference on the semiring_infer stage's SECP at bf16
    secp = generate(Namespace(**SEM_SECP_SPEC))
    kw = dict(device="always", device_min_cells=256, pad_policy="pow2")
    z = infer(secp, "log_z", table_dtype="bf16", tol=float("inf"), **kw)
    zh = infer(secp, "log_z", device="never", torch_device="cpu")
    dz = abs(z["log_z"] - zh["log_z"])
    if dz > z["error_bound"] + 1e-9 or z["device_nodes"] <= 0:
        raise AssertionError(f"packs infer-secp192 log_z bf16: |card - "
                             f"never| {dz} > {z['error_bound']}")
    m16 = infer(secp, "map", table_dtype="bf16", **kw)
    m32 = infer(secp, "map", **kw)
    same_solution("packs infer-secp192 map bf16/f32", m16, m32)
    emit("11a", "infer-secp192-bf16", log_z=z["log_z"],
         error_bound=z["error_bound"], card_vs_never=dz,
         dispatches=z["dispatches"], device_nodes=z["device_nodes"],
         seconds=z["time"], map_cost=m16["cost"], map_equal_f32=True,
         map_counters=core_counters(m16))

    # the hub tree's 44 x 24^4 leaf stack at each storage dtype (the
    # copies' profile runs in a fresh process: hub_copy_rows).  On its
    # uniform tables every bf16/int8 leaf join misses its certificate and
    # is redone on host f64 (printed, not gated); the planted hub tree
    # has margins the certificate passes, and there the leaf stack must
    # keep its device joins.
    hub_runs = {}
    planted = hubtree_dcop(planted=True)
    planted_oracle = solve(planted, "dpop", {"util_device": "never"},
                           device="cpu")
    for dt in ("f32", "bf16", "int8"):
        p = {"util_device": "auto", "table_dtype": dt}
        solve(hub, "dpop", p)  # cold
        r = solve(hub, "dpop", p)
        hub_runs[dt] = r
        emit("11a", f"dpop-hubtree-d24-{dt}", cost=r["cost"],
             util_time=r["util_time"],
             util_cells_per_s=r["util_cells"] / r["util_time"],
             util_dispatches=r["util_dispatches"],
             util_device_nodes=r["util_device_nodes"],
             all_host_fallback=r["util_device_nodes"] == 0,
             counters=core_counters(r))
        r = solve(planted, "dpop", p)
        c = solve(planted, "dpop", p, device="cpu")
        label = f"packs dpop-hubtree-d24-planted-{dt}"
        same_solution(f"{label} card/host", r, planted_oracle)
        for k in ("util_device_nodes", "util_host_nodes", "util_dispatches"):
            if r[k] != c[k]:
                raise AssertionError(f"{label}: {k} card {r[k]} cpu {c[k]}")
        if core_counters(r) != core_counters(c):
            raise AssertionError(f"{label}: counters differ card and CPU")
        if r["util_device_nodes"] < 44:
            raise AssertionError(f"{label}: {r['util_device_nodes']} device "
                                 "nodes, the 44-leaf stack left the device")
        emit("11a", f"dpop-hubtree-d24-planted-{dt}", cost=r["cost"],
             util_time=r["util_time"],
             util_cells_per_s=r["util_cells"] / r["util_time"],
             util_dispatches=r["util_dispatches"],
             util_device_nodes=r["util_device_nodes"],
             util_host_nodes=r["util_host_nodes"],
             counters=core_counters(r), equal_to_host_f64=True,
             equal_to_cpu=True)
    for dt in ("bf16", "int8"):
        same_solution(f"packs dpop-hubtree-d24-{dt}/f32", hub_runs[dt],
                      hub_runs["f32"])
    return hub_runs["f32"]


def hub_copy_rows(torch, solve, log):
    """11a's copy rows: the hub tree's host-to-device copies at each
    storage dtype from torch.profiler's events over one warm run, beside
    the leaf stack's packed bytes and a CUDA-event timing of one
    pageable copy of that many bytes."""
    import numpy as np

    hub = hubtree_dcop()
    for dt in ("f32", "bf16", "int8"):
        p = {"util_device": "auto", "table_dtype": dt}
        solve(hub, "dpop", p)  # warm
        start = len(log["dense"])
        r, prof = h2d_profile(torch, lambda: solve(hub, "dpop", p),
                              f"copies-dpop-hubtree-d24-{dt}")
        stacks = [e for e in log["dense"][start:] if e[4]]
        _, _, shape, ps, lead = max(
            stacks, key=lambda e: math.prod(e[4] + e[2]))
        part_bytes = sum(math.prod(lead + p_) for p_ in ps) * (
            STORAGE_BYTES[dt])
        if prof["h2d_copies"] <= 0:
            raise AssertionError(f"copies dpop-hubtree-d24-{dt}: the "
                                 "profiler saw no host-to-device copy")
        host = torch.from_numpy(np.ones(part_bytes, dtype=np.uint8))
        copy_ms = statistics.median(
            _event_ms(torch, lambda: host.to(torch.device("cuda")))
            for _ in range(5))
        emit("11a", f"copies-dpop-hubtree-d24-{dt}", cost=r["cost"],
             leaf_stack=[lead[0], *shape], stack_part_bytes=part_bytes,
             stack_copy_event_ms=copy_ms, **prof)


def bounded_phase(torch, solve, infer, generate, hub, hub_free):
    """11b: the memory-bounded sweep."""
    from argparse import Namespace

    mb = generate(Namespace(**MB_SPEC))
    always = {"util_device": "always"}
    kw = dict(max_util_bytes=MB_BUDGET, pad_policy="pow2")
    solve(mb, "dpop", always, **kw)  # cold
    r = solve(mb, "dpop", always, **kw)
    c = solve(mb, "dpop", always, device="cpu", **kw)
    host = solve(mb, "dpop", {"util_device": "never"},
                 max_util_bytes=MB_BUDGET, device="cpu")
    free = solve(mb, "dpop", always, pad_policy="pow2")
    for other, name in ((host, "bounded host f64"), (free, "unbounded"),
                        (c, "cpu")):
        same_solution(f"bounded membound-secp96 card/{name}", r, other)
    if core_counters(r) != core_counters(c) or any(
            r[k] != c[k] for k in DPOP_STATS):
        raise AssertionError("bounded membound-secp96: card counts differ "
                             "from the CPU")
    mbk = r["membound"]
    if mbk["cut_width"] <= 0 or not mbk["on_device"]:
        raise AssertionError("bounded membound-secp96: no cut on the card")
    emit("11b", "membound-secp96", cost=r["cost"],
         max_util_bytes=MB_BUDGET,
         naive_peak_table_bytes=mbk["naive_peak_table_bytes"],
         peak_table_bytes=mbk["peak_table_bytes"],
         cut_width=mbk["cut_width"], cut_lanes=mbk["cut_lanes"],
         pruned_cells=mbk["pruned_cells"], replans=mbk["replans"],
         util_cells=r["util_cells"], util_time=r["util_time"],
         util_cells_per_s=r["util_cells"] / r["util_time"],
         util_dispatches=r["util_dispatches"],
         unbounded_util_time=free["util_time"],
         unbounded_util_cells_per_s=free["util_cells"] / free["util_time"],
         host_util_time=host["util_time"], counters=core_counters(r),
         equal=True)
    z = infer(mb, "log_z", device="always", pad_policy="pow2",
              tol=float("inf"), max_util_bytes=MB_BUDGET)
    zh = infer(mb, "log_z", device="never", max_util_bytes=MB_BUDGET,
               torch_device="cpu")
    dz = abs(z["log_z"] - zh["log_z"])
    if dz > z["error_bound"] + 1e-9 or z["device_nodes"] <= 0:
        raise AssertionError(f"bounded membound-secp96 log_z: |card - "
                             f"never| {dz} > {z['error_bound']}")
    emit("11b", "membound-secp96-log_z", log_z=z["log_z"],
         error_bound=z["error_bound"], card_vs_never=dz, seconds=z["time"],
         dispatches=z["dispatches"], cut_lanes=z["membound"]["cut_lanes"])

    ctl = generate(Namespace(**MB_CTL_SPEC))
    solve(ctl, "dpop", always, pad_policy="pow2")
    solve(ctl, "dpop", always, max_util_bytes=MB_CTL_BUDGET,
          pad_policy="pow2")
    u = solve(ctl, "dpop", always, pad_policy="pow2")
    b = solve(ctl, "dpop", always, max_util_bytes=MB_CTL_BUDGET,
              pad_policy="pow2")
    same_solution("bounded membound-control", b, u)
    emit("11b", "membound-control", cost=b["cost"],
         max_util_bytes=MB_CTL_BUDGET,
         budgeted_util_cells_per_s=b["util_cells"] / b["util_time"],
         unbounded_util_cells_per_s=u["util_cells"] / u["util_time"],
         budgeted_util_time=b["util_time"],
         unbounded_util_time=u["util_time"],
         cut_width=b["membound"]["cut_width"],
         cut_lanes=b["membound"]["cut_lanes"],
         budgeted_dispatches=b["util_dispatches"],
         unbounded_dispatches=u["util_dispatches"], equal=True)

    # at device size: the hub tree with a d-24 variable cut
    solve(hub, "dpop", always, max_util_bytes=HUB_CUT_BUDGET)  # cold
    h = solve(hub, "dpop", always, max_util_bytes=HUB_CUT_BUDGET)
    same_solution("bounded dpop-hubtree-d24 cut/unbounded", h, hub_free)
    hk = h["membound"]
    if hk["cut_lanes"] < 24 or not hk["on_device"]:
        raise AssertionError("bounded dpop-hubtree-d24: fewer than 24 lanes "
                             "on the card")
    emit("11b", "dpop-hubtree-d24-cut", cost=h["cost"],
         max_util_bytes=HUB_CUT_BUDGET, cut=hk["cut"],
         cut_lanes=hk["cut_lanes"], peak_table_bytes=hk["peak_table_bytes"],
         naive_peak_table_bytes=hk["naive_peak_table_bytes"],
         util_time=h["util_time"],
         util_cells_per_s=h["util_cells"] / h["util_time"],
         util_dispatches=h["util_dispatches"],
         unbounded_util_time=hub_free["util_time"], equal=True)


def oom_phase(torch, solve):
    """11c: a real device OOM and the re-plan it triggers."""
    dcop = oom_hub_dcop()
    always = {"util_device": "always"}
    budget = 128 << 20  # the first plan: no cut (the naive peak is 67 MB)
    free = solve(dcop, "dpop", always, max_util_bytes=budget)
    if free["membound"]["cut_width"] or free["membound"]["replans"]:
        raise AssertionError("oom: the uncapped run was cut or re-planned")
    leaf_bytes = 4 * 64 ** 4
    stack_bytes = 4 * leaf_bytes  # the 4 leaves' stacked parts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    # the cap leaves OOM_HEADROOM above what this process holds, less
    # than one leaf join needs
    cap = torch.cuda.memory_reserved() + OOM_HEADROOM
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        capped = solve(dcop, "dpop", always, max_util_bytes=budget)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    mbk = capped["membound"]
    if mbk["replans"] < 1:
        raise AssertionError("oom: no OOM re-plan happened under the cap")
    same_solution("oom hubtree-d64 capped/uncapped", capped, free)
    emit("11c", "oom-hubtree-d64", cap_bytes=cap,
         first_plan_stack_bytes=stack_bytes,
         first_plan_node_bytes=leaf_bytes, replans=mbk["replans"],
         budget_bytes=mbk["budget_bytes"], cut=mbk["cut"],
         cut_lanes=mbk["cut_lanes"],
         oom_splits=capped["telemetry"]["counters"].get(
             "engine.oom_splits", 0),
         util_dispatches=capped["util_dispatches"],
         util_time=capped["util_time"], uncapped_util_time=free["util_time"],
         equal=True)


def sparse_phase(torch, solve, infer, generate):
    """11d: sparse COO tables."""
    from argparse import Namespace

    import numpy as np

    from pydcop_tpu_torch.commands.generators.taskscheduling import (
        generate as gen_tasks,
    )

    ts = gen_tasks(Namespace(**TASKS_SPEC))
    inf_frac = [
        float(np.isposinf(np.asarray(c.as_matrix().matrix)).mean())
        for n, c in ts.constraints.items() if n.startswith("win")
    ]
    always = {"util_device": "always"}
    sp = dict(always, table_format="sparse")
    solve(ts, "dpop", sp, pad_policy="pow2")  # cold
    solve(ts, "dpop", always, pad_policy="pow2")
    s, s_peak = peak_device_bytes(
        torch, lambda: solve(ts, "dpop", sp, pad_policy="pow2"))
    d, d_peak = peak_device_bytes(
        torch, lambda: solve(ts, "dpop", always, pad_policy="pow2"))
    c = solve(ts, "dpop", sp, pad_policy="pow2", device="cpu")
    host = solve(ts, "dpop", {"util_device": "never"}, device="cpu")
    for other, name in ((d, "dense"), (host, "host f64"), (c, "cpu")):
        same_solution(f"sparse tasks26 sparse/{name}", s, other)
    sc = core_counters(s, ("semiring.sparse",))
    if sc != core_counters(c, ("semiring.sparse",)):
        raise AssertionError("sparse tasks26: sparse counters differ card "
                             "and CPU")
    if sc.get("semiring.sparse_packs", 0) <= 0:
        raise AssertionError("sparse tasks26: nothing packed")
    emit("11d", "tasks26", cost=s["cost"], window_inf_fraction=inf_frac,
         sparse_util_time=s["util_time"], dense_util_time=d["util_time"],
         util_cells=s["util_cells"],
         sparse_util_cells_per_s=s["util_cells"] / s["util_time"],
         dense_util_cells_per_s=d["util_cells"] / d["util_time"],
         sparse_dispatches=s["util_dispatches"],
         dense_dispatches=d["util_dispatches"],
         peak_table_bytes=s["membound"]["peak_table_bytes"],
         sparse_peak_device_bytes=s_peak, dense_peak_device_bytes=d_peak,
         counters=sc, equal=True)

    guard = generate(Namespace(**GUARD_SPEC))
    gs = solve(guard, "dpop", sp, pad_policy="pow2")
    gd = solve(guard, "dpop", always, pad_policy="pow2")
    same_solution("sparse guard-secp28 sparse/dense", gs, gd)
    emit("11d", "guard-secp28", cost=gs["cost"],
         sparse_util_time=gs["util_time"], dense_util_time=gd["util_time"],
         counters=core_counters(gs, ("semiring.sparse",)), equal=True)

    kw = dict(device="always", pad_policy="pow2", table_format="sparse",
              tol=float("inf"))
    z = infer(ts, "log_z", **kw)
    zc = infer(ts, "log_z", torch_device="cpu", **kw)
    zh = infer(ts, "log_z", device="never", torch_device="cpu")
    dz = abs(z["log_z"] - zh["log_z"])
    if dz > z["error_bound"] + 1e-9 or z["device_nodes"] <= 0:
        raise AssertionError(f"sparse tasks26 log_z: |card - never| {dz} > "
                             f"{z['error_bound']}")
    if (core_counters(z, ("semiring.sparse",))
            != core_counters(zc, ("semiring.sparse",))):
        raise AssertionError("sparse tasks26 log_z: sparse counters differ "
                             "card and CPU")
    emit("11d", "tasks26-log_z", log_z=z["log_z"],
         error_bound=z["error_bound"], card_vs_never=dz, seconds=z["time"],
         dispatches=z["dispatches"], device_nodes=z["device_nodes"],
         counters=core_counters(z, ("semiring.sparse",)))


def syncbb_phase(solve, generate):
    """11e: SyncBB (host-only: the entry point works)."""
    from argparse import Namespace

    d = generate(Namespace(**SYNCBB_SPEC))
    r = solve(d, "syncbb", timeout=120)
    c = solve(d, "syncbb", device="cpu", timeout=120)
    opt = solve(d, "dpop", {"util_device": "never"}, device="cpu")
    if r["status"] != "finished" or r["cost"] != opt["cost"]:
        raise AssertionError(f"syncbb secp10: {r['status']} cost {r['cost']} "
                             f"against DPOP's {opt['cost']}")
    for k in ("assignment", "cost", "msg_count", "cycle"):
        if r[k] != c[k]:
            raise AssertionError(f"syncbb secp10: {k} differs from the CPU")
    emit("11e", "syncbb-secp10", cost=r["cost"], dpop_cost=opt["cost"],
         msg_count=r["msg_count"], seconds=r["time"], equal=True)


def dense_pack_row(torch, dev, sr_mod, name, dt, shape, ps, lead, seed):
    """One dense contraction at a storage dtype on the card: random parts
    packed as the sweep packs them, card against CPU, time and bound."""
    import numpy as np

    rng = np.random.default_rng(seed)
    parts = [(rng.random(lead + tuple(p), dtype=np.float32) * 10)
             for p in ps]
    if dt == "int8":
        packed = sr_mod._quantize_rows(
            [p.astype(np.float64) for p in parts], lead[0],
            _null_metrics())
    else:
        packed = sr_mod._pack_parts(parts, dt)
    fn = sr_mod.contraction_kernel(name, shape, ps, batched=bool(lead),
                                   table_dtype=dt)
    host = [p if isinstance(p, torch.Tensor) else torch.from_numpy(p)
            for p in packed]
    on_card = [t.to(dev) for t in host]
    got = [o.cpu() for o in fn(*on_card)]
    want = fn(*host)
    if not all(same_out(torch, g, w) for g, w in zip(got, want)):
        raise AssertionError(f"contraction {name}-{dt}: card differs from "
                             "the CPU")
    ms = eager_ms(torch, lambda: fn(*on_card))
    _, prof = h2d_profile(torch, lambda: fn(*on_card),
                          f"contraction-{name}-{dt}")
    cells = math.prod(lead + tuple(shape))
    rows = cells // shape[-1]
    nbytes = (STORAGE_BYTES[dt] * sum(math.prod(lead + tuple(p)) for p in ps)
              + 12 * rows + (8 * lead[0] * len(ps) if dt == "int8" else 0))
    nops = cells * (len(ps) + 4) + (
        2 * sum(math.prod(lead + tuple(p)) for p in ps) if dt != "f32" else 0)
    b_ms, b_by = bound_ms(nbytes, nops)
    emit("11f", f"contraction-{name}-{dt}", joined=list(shape),
         stack=lead[0] if lead else 1, parts=len(ps), ms=ms, bound_ms=b_ms,
         bound_by=b_by, share_of_bound=b_ms / ms,
         eager_launches=prof["kernel_launches"], bit_equal=True,
         library_ms=None)
    del on_card


def same_out(torch, a, b) -> bool:
    """Equal outputs: integer tensors value for value, float tensors bit
    for bit with NaN where the other has NaN."""
    if a.is_floating_point():
        return same_bits(torch, a, b)
    return a.dtype == b.dtype and torch.equal(a, b)


def _null_metrics():
    from pydcop_tpu_torch.telemetry import get_metrics

    return get_metrics()


def sparse_row(torch, dev, sp_mod, key, entry):
    """The largest sparse dispatch of a semiring on the card: its recorded
    arguments replayed, card against CPU, time and bound.  The bound
    counts the rows' real candidates, segments and packed values, summed
    over the stack (the padded sizes are printed beside them), and ``fold_levels`` is
    how many in-place passes each segment fold makes over the candidate
    list (``ops/sparse.py:_segment_fold``), which the bound leaves out."""
    name, dt = key
    _, (n_cand_b, n_seg_b, lens), args, real_rows, bnb = entry
    fn = sp_mod.sparse_contraction_kernel(name, n_cand_b, n_seg_b, lens,
                                          table_dtype=dt, bnb=bnb)
    on_card = [a.to(dev) for a in args]
    got = [o.cpu() for o in fn(*on_card)]
    want = fn(*args)
    rows = int(args[-1].shape[0])
    if name == "log_sum_exp":
        g, w = got[0], want[0]
        fin = torch.isfinite(g) & torch.isfinite(w)
        err = float((g - w).abs()[fin].max()) if bool(fin.any()) else 0.0
        if not (torch.equal(g[~fin].nan_to_num(), w[~fin].nan_to_num())
                and torch.allclose(g[fin], w[fin], rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"contraction sparse-{name}: card far from "
                                 "the CPU")
    else:
        err = 0.0
        if not all(same_out(torch, g, w) for g, w in zip(got, want)):
            raise AssertionError(f"contraction sparse-{name}: card differs "
                                 "from the CPU")
    ms = eager_ms(torch, lambda: fn(*on_card))
    _, prof = h2d_profile(torch, lambda: fn(*on_card),
                          f"contraction-sparse-{name}")
    P = len(lens)
    n_cand = sum(r[0] for r in real_rows)
    n_seg = sum(r[1] for r in real_rows)
    n_vals = sum(r[2] for r in real_rows)
    # outputs per segment: an i32 arg and an f32 margin, or one f32 value
    out_bytes = (8 if name != "log_sum_exp" else 4) * n_seg
    nbytes = (n_cand * (8 + 4 * P) + STORAGE_BYTES[dt] * n_vals + out_bytes
              + (8 * rows * P if dt == "int8" else 0))
    nops = n_cand * (P + 4)
    b_ms, b_by = bound_ms(nbytes, nops)
    sep = args[(2 if dt == "int8" else 0) + bool(bnb)].long()
    rank = torch.arange(sep.shape[1]) - torch.searchsorted(sep, sep)
    longest = int(torch.where(sep < n_seg_b, rank, 0).max()) + 1
    emit("11f", f"contraction-sparse-{name}-{dt}", bnb=bool(bnb),
         candidates=n_cand,
         segments=n_seg, packed_values=n_vals,
         padded_candidates=rows * n_cand_b,
         padded_segments=rows * (n_seg_b + 1), stack=rows, parts=P,
         fold_levels=(longest - 1).bit_length(), ms=ms, bound_ms=b_ms,
         bound_by=b_by, share_of_bound=b_ms / ms,
         eager_launches=prof["kernel_launches"],
         card_vs_cpu_max_abs_err=err, library_ms=None)
    del on_card


def fresh_phase(card):
    """The part of phase 11 that needs a process of its own: the profiled
    copies and 11f's launch counts (torch.profiler loses events late in a
    long process) and the capped allocator of 11c (the cap is set above
    what this process holds).  Run by :func:`core_phase` in a child
    process."""
    from argparse import Namespace

    import torch

    from pydcop_tpu_torch.api import infer, solve
    from pydcop_tpu_torch.commands.generators.taskscheduling import (
        generate as gen_tasks,
    )
    from pydcop_tpu_torch.ops import semiring as sr_mod

    CARD["card"] = card
    log, unwrap = record_core_dispatches(sr_mod)
    try:
        hub_copy_rows(torch, solve, log)
        ts = gen_tasks(Namespace(**TASKS_SPEC))
        solve(ts, "dpop", {"util_device": "always",
                           "table_format": "sparse"}, pad_policy="pow2")
        infer(ts, "log_z", device="always", pad_policy="pow2",
              table_format="sparse", tol=float("inf"))
    finally:
        unwrap()
    contraction_rows_11f(torch, torch.device("cuda"), log)
    oom_phase(torch, solve)


def run_fresh_phase(card):
    """:func:`fresh_phase` in a child process on the same card: its JSON
    lines are printed here; its failure fails the phase."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.fresh_phase(sys.argv[2])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(HERE), card], cwd=HERE,
        capture_output=True, text=True, timeout=600,
    )
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        raise AssertionError("phase 11 (its own process) failed:\n"
                             + proc.stderr[-4000:])


def contraction_rows_11f(torch, dev, log):
    """11f: the new contractions at their largest dispatch of the
    process's runs (the hub tree at bf16 and int8, the sparse task
    scheduling's DPOP and log_z)."""
    from pydcop_tpu_torch.ops import semiring as sr_mod
    from pydcop_tpu_torch.ops import sparse as sp_mod

    for i, dt in enumerate(("bf16", "int8")):
        stacks = [e for e in log["dense"]
                  if e[0] == "min_sum" and e[1] == dt and e[4]]
        _, _, shape, ps, lead = max(
            stacks, key=lambda e: math.prod(e[4] + e[2]))
        dense_pack_row(torch, dev, sr_mod, "min_sum", dt, shape, ps, lead,
                       seed=40 + i)
    for key in sorted(log["sparse"]):
        if key[0] in ("min_sum", "log_sum_exp"):
            sparse_row(torch, dev, sp_mod, key, log["sparse"][key])
    if not {"min_sum", "log_sum_exp"} <= {k[0] for k in log["sparse"]}:
        raise AssertionError("phase 11: a sparse join did not run on the "
                             "card")
    torch.cuda.empty_cache()


def core_phase(torch, dev, card):
    """Phase 11 (see the module docstring)."""
    from pydcop_tpu_torch.api import infer, solve
    from pydcop_tpu_torch.commands.generators.secp import generate

    CARD["card"] = card
    t_lap = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        print(f"phase {part} seconds={now - t_lap[0]}")
        t_lap[0] = now

    hub = hubtree_dcop()
    hub_free = packs_phase(torch, solve, infer, generate, hub)
    lap("11a")
    bounded_phase(torch, solve, infer, generate, hub, hub_free)
    lap("11b")
    sparse_phase(torch, solve, infer, generate)
    lap("11d")
    syncbb_phase(solve, generate)
    lap("11e")
    run_fresh_phase(card)
    lap("11a copies, 11f, 11c")


# -- phase 12: branch-and-bound pruning and checkpoint/resume ---------------


def bnb_secp_cell(torch, solve, generate):
    """12a: the bnb stage's hard-capped overlap SECP through DPOP at bnb
    on, auto and off: each equal to host f64, the card equal to the CPU in
    its counts and every counter; the pruned fraction, the compact host
    pass-2 buckets, and util-cells/s on against off (interleaved)."""
    from argparse import Namespace

    secp = generate(Namespace(**GUARD_SPEC))
    oracle = solve(secp, "dpop", {"util_device": "never"}, device="cpu")
    runs = {}
    for mode in ("on", "auto", "off"):
        p = {"util_device": "always", "bnb": mode}
        solve(secp, "dpop", p, pad_policy="pow2")  # cold
        r = solve(secp, "dpop", p, pad_policy="pow2")
        c = solve(secp, "dpop", p, pad_policy="pow2", device="cpu")
        same_solution(f"bnb-secp28 {mode} card/host f64", r, oracle)
        same_solution(f"bnb-secp28 {mode} card/cpu", r, c)
        if core_counters(r) != core_counters(c) or any(
                r[k] != c[k] for k in DPOP_STATS):
            raise AssertionError(f"bnb-secp28 {mode}: card counts differ "
                                 "from the CPU")
        if r["util_device_nodes"] <= 0:
            raise AssertionError(f"bnb-secp28 {mode}: no join on the card")
        runs[mode] = r
    c_on = core_counters(runs["on"])
    pruned = c_on.get("semiring.bnb_pruned_cells", 0)
    host_pass2 = (c_on.get("semiring.bnb_passes", 0)
                  - c_on.get("dpop.level_dispatches", 0))
    if pruned <= 0 or host_pass2 <= 0:
        raise AssertionError("bnb-secp28 on: nothing pruned, or no bucket "
                             "took the host pass 2")
    times = {"on": [], "off": []}
    for _ in range(3):  # interleaved
        for mode in ("off", "on"):
            r = solve(secp, "dpop", {"util_device": "always", "bnb": mode},
                      pad_policy="pow2")
            times[mode].append(r["util_time"])
    cells = runs["on"]["util_cells"]
    med = {m: statistics.median(v) for m, v in times.items()}
    emit("12a", "bnb-secp28", cost=runs["on"]["cost"], util_cells=cells,
         join_cells=cells * GUARD_SPEC["light_levels"],
         pruned_cells=pruned,
         pruned_fraction=pruned / (cells * GUARD_SPEC["light_levels"]),
         host_pass2_buckets=host_pass2,
         util_time_on=med["on"], util_time_off=med["off"],
         util_cells_per_s_on=cells / med["on"],
         util_cells_per_s_off=cells / med["off"],
         on_over_off=med["off"] / med["on"],
         util_time_auto=runs["auto"]["util_time"],
         counters={m: core_counters(r) for m, r in runs.items()},
         host_f64_util_time=oracle["util_time"], equal=True)


def bnb_hub_cells(torch, solve, infer, sr_mod):
    """12b: the hub tree's DPOP at each storage dtype and cut at 4·24^3
    bytes with bnb at auto (the default, now pruning) against off (the
    control, once: phases 8 and 11 warmed these shapes), equal to host
    f64 (f32 auto also to the CPU in its counters: phase 11a compares
    the packs'); map at auto and off equal to host f64; log_z and
    marginals at on and off within ``error_bound`` + 1e-9 of host f64.
    Returns the run's pruned dispatches as ``record_contractions`` logs
    them."""
    hub = hubtree_dcop()
    oracle = solve(hub, "dpop", {"util_device": "never"}, device="cpu")
    log, unwrap = record_contractions(sr_mod)
    try:
        for dt in ("f32", "bf16", "int8"):
            out = {}
            for mode in ("auto", "off"):
                p = {"util_device": "auto", "bnb": mode, "table_dtype": dt}
                out[mode] = solve(hub, "dpop", p)
                same_solution(f"bnb dpop-hubtree-d24-{dt} {mode}/host f64",
                              out[mode], oracle)
            a = out["auto"]
            if dt == "f32":
                c = solve(hub, "dpop", dict(p, bnb="auto"), device="cpu")
                if core_counters(a) != core_counters(c) or any(
                        a[k] != c[k] for k in DPOP_STATS):
                    raise AssertionError(f"bnb dpop-hubtree-d24-{dt}: card "
                                         "counts differ from the CPU")
            emit("12b", f"bnb-dpop-hubtree-d24-{dt}", cost=a["cost"],
                 util_time_auto=a["util_time"], util_time_off=out["off"][
                     "util_time"],
                 util_cells_per_s_auto=a["util_cells"] / a["util_time"],
                 util_cells_per_s_off=a["util_cells"]
                 / out["off"]["util_time"],
                 device_nodes_auto=a["util_device_nodes"],
                 device_nodes_off=out["off"]["util_device_nodes"],
                 counters_auto=core_counters(a),
                 counters_off=core_counters(out["off"]), equal=True)
        cut = {}
        for mode in ("auto", "off"):
            p = {"util_device": "always", "bnb": mode}
            cut[mode] = solve(hub, "dpop", p, max_util_bytes=HUB_CUT_BUDGET)
            same_solution(f"bnb dpop-hubtree-d24-cut {mode}/host f64",
                          cut[mode], oracle)
        if cut["auto"]["membound"] != cut["off"]["membound"]:
            raise AssertionError("bnb dpop-hubtree-d24-cut: pruning moved "
                                 "the plan")
        emit("12b", "bnb-dpop-hubtree-d24-cut",
             util_time_auto=cut["auto"]["util_time"],
             util_time_off=cut["off"]["util_time"],
             cut_lanes=cut["auto"]["membound"]["cut_lanes"],
             counters_auto=core_counters(cut["auto"]), equal=True)
        host = infer(hub, "map", device="never", torch_device="cpu")
        maps = {m: infer(hub, "map", bnb=m) for m in ("auto", "off")}
        for m, r in maps.items():
            if (r["assignment"], r["cost"]) != (host["assignment"],
                                                host["cost"]):
                raise AssertionError(f"bnb infer-hubtree-d24 map {m}: "
                                     "differs from host f64")
        emit("12b", "bnb-infer-hubtree-d24-map", cost=host["cost"],
             seconds_auto=maps["auto"]["time"],
             seconds_off=maps["off"]["time"],
             counters_auto=core_counters(maps["auto"]), equal=True)
        kw = dict(device="always", tol=float("inf"))
        for query in ("log_z", "marginals"):
            host = infer(hub, query, device="never", torch_device="cpu")
            got = {}
            for mode in ("on", "off"):
                got[mode] = r = infer(hub, query, bnb=mode, **kw)
                err = r["error_bound"] + 1e-9
                dz = abs(r["log_z"] - host["log_z"])
                dm = max((max(abs(x - y) for x, y in zip(
                    r["marginals"][v], host["marginals"][v]))
                    for v in host.get("marginals", {})), default=0.0)
                if dz > err or dm > err or r["device_nodes"] <= 0:
                    raise AssertionError(
                        f"bnb infer-hubtree-d24 {query} {mode}: |card - "
                        f"never| {max(dz, dm)} > {err}")
            c = infer(hub, query, bnb="on", torch_device="cpu", **kw)
            if (core_counters(c) != core_counters(got["on"]) or any(
                    c[k] != got["on"][k] for k in INFER_COUNTS)):
                raise AssertionError(f"bnb infer-hubtree-d24 {query}: card "
                                     "counts differ from the CPU")
            emit("12b", f"bnb-infer-hubtree-d24-{query}",
                 log_z_on=got["on"]["log_z"], log_z_off=got["off"]["log_z"],
                 error_bound_on=got["on"]["error_bound"],
                 error_bound_off=got["off"]["error_bound"],
                 seconds_on=got["on"]["time"], seconds_off=got["off"]["time"],
                 counters_on=core_counters(got["on"]), within_bound=True)
    finally:
        unwrap()
    return log


def bnb_row(torch, dev, sr_mod, name, shape, ps, lead, seed):
    """One pruned contraction (``contraction_kernel(bnb=True)``) at a hub
    dispatch's shape on random parts, a budget per stack row at a gap in
    its row bounds near their median (about half the rows pruned): card
    against CPU (keep masks equal; min-sum bit for bit, logsumexp to rtol
    1e-5), CUDA events around eager calls for it and for the unpruned
    kernel on the same inputs, and the bound (parts and budgets read
    once, outputs written once)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sign = -1.0 if name != "min_sum" else 1.0  # log-weights for the mass
    parts = [(sign * rng.random(lead + tuple(p), dtype=np.float32) * 10
              ).astype(np.float32) for p in ps]
    batched = bool(lead)
    plain = sr_mod.contraction_kernel(name, shape, ps, batched=batched)
    pruned = sr_mod.contraction_kernel(name, shape, ps, batched=batched,
                                       bnb=True)
    host = [torch.from_numpy(p) for p in parts]
    if name == "min_sum":
        j = parts[0]
        for p in parts[1:]:
            j = j + p
        bounds = j.min(axis=-1)
    else:
        bounds = plain(*host)[0].numpy()
    rows = bounds.reshape((lead[0] if lead else 1), -1)
    budgets = []
    for r in rows:
        f = np.sort(r[np.isfinite(r)])
        mid = len(f) // 2
        w = f[max(mid - 500, 0):mid + 500]
        g = int(np.argmax(np.diff(w)))
        budgets.append((w[g] + w[g + 1]) / 2)
    budget = torch.tensor(budgets if lead else budgets[0],
                          dtype=torch.float32)
    want = pruned(budget, *host)
    on_card = [t.to(dev) for t in host]
    b_dev = budget.to(dev)
    got = [o.cpu() for o in pruned(b_dev, *on_card)]
    keep_at = 2 if name == "min_sum" else 1
    if not torch.equal(got[keep_at], want[keep_at]):
        raise AssertionError(f"bnb contraction {name}: keep masks differ")
    if name == "min_sum":
        if not all(same_out(torch, g, w) for g, w in zip(got, want)):
            raise AssertionError("bnb contraction min_sum: card differs "
                                 "from the CPU")
        err = 0.0
    else:
        g, w = got[0], want[0]
        fin = torch.isfinite(w)
        if not (torch.equal(g[~fin], w[~fin])
                and torch.allclose(g[fin], w[fin], rtol=1e-5, atol=0)):
            raise AssertionError("bnb contraction log_sum_exp: card far "
                                 "from the CPU")
        err = float((g[fin] - w[fin]).abs().max())
    kept = float(want[keep_at].float().mean())
    ms = eager_ms(torch, lambda: pruned(b_dev, *on_card))
    plain_ms = eager_ms(torch, lambda: plain(*on_card))
    cells = math.prod(lead + tuple(shape))
    n_rows = cells // shape[-1]
    stack = lead[0] if lead else 1
    out = (8 + 4 + 1) * n_rows if name == "min_sum" else (
        (4 + 1) * n_rows + 4 * stack)
    nbytes = sum(4 * math.prod(lead + tuple(p)) for p in ps) + 4 * stack + out
    nops = cells * (len(ps) + 4) + 2 * n_rows
    b_ms, b_by = bound_ms(nbytes, nops)
    emit("12b", f"contraction-bnb-{name}", joined=list(shape), stack=stack,
         parts=len(ps), kept_row_fraction=kept, ms=ms, plain_ms=plain_ms,
         bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
         card_vs_cpu_max_abs_err=err, library_ms=None)
    del on_card


def bnb_more_cells(torch, solve, generate):
    """12c-12d: task scheduling sparse against dense at bnb on, and the
    membound SECP budgeted at 16,384 bytes with bnb on against its
    unbounded run."""
    from argparse import Namespace

    from pydcop_tpu_torch.commands.generators.taskscheduling import (
        generate as gen_tasks,
    )

    ts = gen_tasks(Namespace(**TASKS_SPEC))
    on = {"util_device": "always", "bnb": "on"}
    host = solve(ts, "dpop", {"util_device": "never"}, device="cpu")
    res = {}
    for fmt in ("dense", "sparse"):
        p = dict(on, table_format=fmt)
        solve(ts, "dpop", p, pad_policy="pow2")  # cold
        res[fmt] = r = solve(ts, "dpop", p, pad_policy="pow2")
        c = solve(ts, "dpop", p, pad_policy="pow2", device="cpu")
        same_solution(f"bnb tasks26 {fmt}/host f64", r, host)
        if core_counters(r) != core_counters(c):
            raise AssertionError(f"bnb tasks26 {fmt}: card counters differ "
                                 "from the CPU")
    if not core_counters(res["sparse"]).get("semiring.bnb_passes"):
        raise AssertionError("bnb tasks26 sparse: no pruned dispatch")
    emit("12c", "bnb-tasks26", cost=res["sparse"]["cost"],
         sparse_util_time=res["sparse"]["util_time"],
         dense_util_time=res["dense"]["util_time"],
         counters_sparse=core_counters(res["sparse"]),
         counters_dense=core_counters(res["dense"]), equal=True)
    mb = generate(Namespace(**MB_SPEC))
    kw = dict(pad_policy="pow2")
    solve(mb, "dpop", on, max_util_bytes=MB_BUDGET, **kw)  # cold
    b = solve(mb, "dpop", on, max_util_bytes=MB_BUDGET, **kw)
    free = solve(mb, "dpop", on, **kw)
    off = solve(mb, "dpop", {"util_device": "always"},
                max_util_bytes=MB_BUDGET, **kw)
    same_solution("bnb membound-secp96 bounded/unbounded", b, free)
    if b["membound"] != off["membound"]:
        raise AssertionError("bnb membound-secp96: pruning moved the plan")
    emit("12d", "bnb-membound-secp96", cost=b["cost"],
         util_time=b["util_time"], unbounded_util_time=free["util_time"],
         cut_lanes=b["membound"]["cut_lanes"], counters=core_counters(b),
         equal=True)


def bnb_maxsum_cell(torch, mk, run_batched, maxsum, p3t):
    """12e: Max-Sum on phase 3's binary + ternary instance (the ternary
    bucket outside the factor-kernel gate) with bnb on, bit-equal to off,
    the q update launched once a round in each."""
    from pydcop_tpu_torch.algorithms import prepare_algo_params

    out = {}
    for mode in ("on", "off"):
        params = prepare_algo_params({"damping": 0.5, "bnb": mode},
                                     maxsum.algo_params)
        mk.reset_launches()
        out[mode] = run_batched(p3t, maxsum, params, rounds=64,
                                chunk_size=64, cost_every=8,
                                return_state=True)
        expect_launches(mk, f"bnb maxsum-ternary {mode}",
                        {"q_update": 64, "factor_round_binary": 0,
                         "factor_round_binary_shared": 0})
    for k in ("q", "r", "values"):
        if not same_bits(torch, out["on"].state[k], out["off"].state[k]):
            raise AssertionError(f"bnb maxsum-ternary: on and off differ in "
                                 f"{k}")
    emit("12e", "bnb-maxsum-coloring10k-ternary", rounds=64,
         best_cost=out["on"].best_cost, seconds_on=out["on"].time,
         seconds_off=out["off"].time, bit_equal=True)


def resume_cell(torch, mk, label, problem, algo, prm, rounds, chunk, path,
                expect=None, n_restarts=1, resume_on=None):
    """One run split at half its rounds by a checkpoint and resumed (on
    ``resume_on``'s copy of the problem when given) against the
    uninterrupted run: state, best cost, restart costs and cost trace bit
    for bit; ``expect`` the launches per kernel in EACH half (counts set
    to 0 just before and read just after)."""
    import os

    import numpy as np

    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.engine.batched import run_batched

    mod = load_algorithm_module(algo)
    params = prepare_algo_params(prm, mod.algo_params)
    kw = dict(seed=3, chunk_size=chunk, cost_every=8, n_restarts=n_restarts,
              return_state=True)
    full = run_batched(problem, mod, params, rounds=rounds, **kw)
    if os.path.exists(path):
        os.unlink(path)
    halves, secs = [], []
    for i, (p, r) in enumerate(((problem, rounds // 2),
                                (resume_on or problem, rounds))):
        mk.reset_launches()
        t0 = time.perf_counter()
        halves.append(run_batched(p, mod, params, rounds=r,
                                  checkpoint_path=path, resume=i == 1, **kw))
        if p.device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if expect is not None and p.device.type == "cuda":
            expect_launches(mk, f"resume {label} half {i + 1}", expect)
    res = halves[1]
    for k in full.state:
        if not same_bits(torch, full.state[k].float(), res.state[k].float()):
            raise AssertionError(f"resume {label}: {k} differs from the "
                                 "uninterrupted run")
    if (res.best_cost, res.cost, res.cycles, res.messages) != (
            full.best_cost, full.cost, full.cycles, full.messages):
        raise AssertionError(f"resume {label}: result differs")
    np.testing.assert_array_equal(res.cost_trace, full.cost_trace)
    if n_restarts > 1:
        np.testing.assert_array_equal(res.restart_costs, full.restart_costs)
    emit("12f", f"resume-{label}", rounds=rounds, saved_at=rounds // 2,
         resumed_on=(resume_on or problem).device.type,
         best_cost=res.best_cost, file_bytes=os.path.getsize(path),
         first_half_seconds=secs[0], resumed_half_seconds=secs[1],
         uninterrupted_seconds=full.time, bit_equal=True)


def checkpoint_cells(torch, mk, dev, arrays, s5, t5, u5, path):
    """12f: checkpoint/resume of the batched engine."""
    from argparse import Namespace

    from pydcop_tpu_torch.algorithms import maxsum, prepare_algo_params
    from pydcop_tpu_torch.commands.generators import meetingscheduling
    from pydcop_tpu_torch.engine.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from pydcop_tpu_torch.ops.compile import compile_dcop, compile_from_arrays

    s, t, u = arrays
    p3c = compile_from_arrays(s, t, 3, unary=u, device="cpu")
    p3 = p3c.to(dev)
    every = {"factor_round_binary_shared": 256, "q_update": 256,
             "factor_round_binary": 0}
    resume_cell(torch, mk, "coloring10k-maxsum", p3, "maxsum",
                {"damping": 0.5}, 512, 256, path, expect=every)
    resume_cell(torch, mk, "coloring10k-maxsum-on-cpu", p3, "maxsum",
                {"damping": 0.5}, 512, 256, path, expect=every,
                resume_on=p3c)
    resume_cell(torch, mk, "coloring10k-dsaB-K8", p3, "dsa",
                {"variant": "B", "probability": 0.7}, 256, 64, path,
                n_restarts=8)
    c5 = meetingscheduling.generate(Namespace(**CONFIG5_SPEC))
    p5 = compile_dcop(c5, device=dev)
    resume_cell(torch, mk, "config5-meeting10k-maxsum", p5, "maxsum",
                {"damping": 0.5}, 256, 128, path,
                expect={"factor_round_binary": 128, "q_update": 128,
                        "factor_round_binary_shared": 0})
    del p5, c5, p3
    # one save and one load at coloring-1M: the state's bytes and seconds
    p1 = compile_from_arrays(s5, t5, 3, unary=u5, device=dev)
    params = prepare_algo_params({"damping": 0.5}, maxsum.algo_params)
    state = maxsum.init_state(p1, 0, params)
    state = maxsum.step(p1, state, params)
    values = state["values"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(path, state, 0.0, values, 1, {"algo": "maxsum"},
                    static_keys=getattr(maxsum, "STATIC_STATE_KEYS", ()))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, _, _, _, _ = load_checkpoint(path, maxsum.init_state(p1, 0, params))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for k in state:
        if not same_bits(torch, got[k].float(), state[k].float()):
            raise AssertionError(f"checkpoint coloring-1M: {k} changed")
    import os

    emit("12f", "checkpoint-coloring1M", state_bytes=sum(
        v.numel() * v.element_size() for v in state.values()),
         file_bytes=os.path.getsize(path), save_seconds=save_s,
         load_seconds=load_s, equal=True)
    del p1, state, got
    os.unlink(path)
    torch.cuda.empty_cache()


def bnb_checkpoint_phase(torch, mk, dev, card, arrays, s5, t5, u5):
    """Phase 12 (see the module docstring)."""
    import tempfile

    from pydcop_tpu_torch.algorithms import maxsum
    from pydcop_tpu_torch.api import infer, solve
    from pydcop_tpu_torch.commands.generators.secp import generate
    from pydcop_tpu_torch.engine.batched import run_batched
    from pydcop_tpu_torch.ops import semiring as sr_mod
    from pydcop_tpu_torch.ops.compile import compile_from_arrays

    CARD["card"] = card
    t_lap = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        print(f"phase {part} seconds={now - t_lap[0]}")
        t_lap[0] = now

    bnb_secp_cell(torch, solve, generate)
    lap("12a")
    log = bnb_hub_cells(torch, solve, infer, sr_mod)
    largest = {}
    for name, shape, ps, lead in log:
        cells = math.prod(lead + shape)
        if name in ("min_sum", "log_sum_exp") and cells > largest.get(
                name, (0,))[0]:
            largest[name] = (cells, shape, ps, lead)
    for i, name in enumerate(sorted(largest)):
        _, shape, ps, lead = largest[name]
        bnb_row(torch, dev, sr_mod, name, shape, ps, lead, seed=50 + i)
    torch.cuda.empty_cache()
    lap("12b")
    bnb_more_cells(torch, solve, generate)
    lap("12c-d")
    s, t, u = arrays
    s3, t3 = ternary_arrays(10_000, seed=5)
    p3t = compile_from_arrays([s, s3], [t, t3], 3, unary=u, device=dev)
    bnb_maxsum_cell(torch, mk, run_batched, maxsum, p3t)
    del p3t
    lap("12e")
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint_cells(torch, mk, dev, arrays, s5, t5, u5,
                         str(Path(tmp) / "run.npz"))
    lap("12f")


# -- phase 13: the supervised dispatch and belief="blockdiag" ---------------

SUP_KNOBS = ("engine.retries", "engine.oom_chunk_halvings",
             "engine.oom_splits", "engine.quarantined_instances",
             "engine.numeric_faults", "fault.device_oom",
             "fault.device_transient", "fault.nan_inject")
MANY_SEEDS = tuple(range(1, 9))  # phase 9e's 8 graphs
BD_TOL = 1e-5  # per-round |q card - q CPU| bound for belief="blockdiag"
BD_ROUNDS = 256  # 13f's coloring-10k rounds (few: one time limit)


def same_instance(label, got, want):
    """A ``solve_many`` instance equal to the uninjected group's, key for
    key (times, the call's telemetry block and its chaos record aside)."""
    skip = {"time", "instances_batched", "telemetry", "chaos"}
    for k in set(want) - skip:
        if got[k] != want[k]:
            raise AssertionError(f"{label}: {k} differs from the "
                                 "uninjected group")


def sup_counts(summary):
    c = summary["counters"]
    return {k: c[k] for k in SUP_KNOBS if c.get(k)}


def supervised(run_batched, problem, module, params, spec=None,
               chaos_seed=1, knobs=None, **kw):
    """``run_batched`` under a supervisor of its own (the device chaos
    plan ``spec``) inside a telemetry session: (RunResult, the
    supervision counters, the session summary)."""
    from pydcop_tpu_torch.engine.supervisor import (
        make_supervisor,
        supervision,
    )
    from pydcop_tpu_torch.faults import FaultPlan
    from pydcop_tpu_torch.telemetry import session

    plan = FaultPlan.from_spec(spec, chaos_seed) if spec else None
    with session() as tel, supervision(
            make_supervisor(plan=plan, **(knobs or {}))):
        r = run_batched(problem, module, params, **kw)
        summary = tel.summary()
    return r, sup_counts(summary), summary


def same_run(torch, label, got, want):
    """Two ``return_state`` runs bit-equal: q, r, values, best cost,
    cost trace."""
    import numpy as np

    for k in ("q", "r", "values"):
        if not same_bits(torch, got.state[k].float(), want.state[k].float()):
            raise AssertionError(f"{label}: {k} differs from the run "
                                 "without injection")
    if (got.best_cost, got.cost, got.cycles) != (want.best_cost, want.cost,
                                                 want.cycles):
        raise AssertionError(f"{label}: result differs")
    np.testing.assert_array_equal(got.cost_trace, want.cost_trace)


def wrapper_host_us(torch, device, samples):
    """Microseconds of host time that supervision adds to one chunk of
    ``run_batched``, each piece timed alone (mean of 2,000 calls): the
    default supervisor's ``dispatch`` around a no-op closure less the
    bare call, the chunk-start ``get_state``/``set_state`` of the rounds'
    generator on ``device``, and the NaN screen (``nan_lanes`` and an
    ``isnan`` over ``samples`` host cost samples)."""
    import numpy as np

    from pydcop_tpu_torch.engine.batched import round_generator
    from pydcop_tpu_torch.engine.supervisor import make_supervisor

    n = 2000
    sup = make_supervisor()
    gen = round_generator(0, device)
    costs = np.zeros(samples, np.float32)

    def noop():
        return None

    def per_call(fn):
        fn()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6

    def dispatch():
        sup.dispatch(noop, scope="engine.chunk", width=1, rounds=256)

    def generator():
        gen.set_state(gen.get_state())

    def screen():
        sup.nan_lanes(1, scope="engine.chunk")
        bool(np.isnan(costs).any())

    torch.cuda.synchronize()
    parts = {"dispatch_us": per_call(dispatch) - per_call(noop),
             "generator_us": per_call(generator),
             "nan_screen_us": per_call(screen)}
    return parts, sum(parts.values())


OVERHEAD_PAIRS = 2  # few: the whole script has one time limit


def overhead_row(torch, run_batched, maxsum, params, problem, rounds,
                 label):
    """The supervision overhead two ways.  End to end: engine seconds
    with the default supervisor against UNSUPERVISED (the JAX bench's
    supervised_overhead), OVERHEAD_PAIRS pairs interleaved with the order
    alternating, the median of each side and of the pairs' ratios.  By
    its parts: the wrapper's host microseconds per chunk
    (``wrapper_host_us``) times the run's chunks, over the supervised
    median: the share the end-to-end pairs, spread by the shared
    host's noise, cannot resolve."""
    from pydcop_tpu_torch.engine.supervisor import UNSUPERVISED, supervision

    chunk, every = 256, 8
    kw = dict(rounds=rounds, chunk_size=chunk, cost_every=every)
    run_batched(problem, maxsum, params, **kw)  # warm
    sup_s, bare_s = [], []
    for i in range(OVERHEAD_PAIRS):  # each order in turn, against drift
        for bare in ((False, True) if i % 2 == 0 else (True, False)):
            if bare:
                with supervision(UNSUPERVISED):
                    bare_s.append(
                        run_batched(problem, maxsum, params, **kw).time)
            else:
                sup_s.append(run_batched(problem, maxsum, params, **kw).time)
    s, b = statistics.median(sup_s), statistics.median(bare_s)
    pair = statistics.median(x / y for x, y in zip(sup_s, bare_s))
    chunks = -(-rounds // chunk)
    parts, per_chunk = wrapper_host_us(torch, problem.device, chunk // every)
    emit("13a", f"supervised-overhead-{label}", rounds=rounds,
         pairs=len(sup_s), supervised_seconds=s, unsupervised_seconds=b,
         overhead=s / b - 1, pair_ratio_median=pair,
         supervised_all=sup_s, unsupervised_all=bare_s,
         chunks=chunks, wrapper_us_per_chunk=per_chunk,
         wrapper_parts_us=parts,
         wrapper_share=per_chunk * chunks * 1e-6 / s)


def group_graphs(s, u):
    """Phase 9e's 8 coloring-10k graphs (phase 3's and 7 rewirings)."""
    from pydcop_tpu_torch.ops.generate import coloring_arrays

    return [(s, u)] + [
        (rewired(s, sd), coloring_arrays(len(u), colors=3, degree=3,
                                         seed=sd)[2])
        for sd in MANY_SEEDS[1:]
    ]


def transient_and_halving_cells(torch, mk, dev, s, t, u, p1):
    """13a-b on the main path: coloring-10k Max-Sum (phase 3's run);
    ``p1`` is the coloring-1M problem on the card."""
    import os
    import tempfile

    from pydcop_tpu_torch.algorithms import maxsum, prepare_algo_params
    from pydcop_tpu_torch.engine.batched import run_batched
    from pydcop_tpu_torch.engine.checkpoint import checkpoint_meta
    from pydcop_tpu_torch.engine.supervisor import UnrecoverableDeviceError
    from pydcop_tpu_torch.ops.compile import compile_from_arrays

    params = prepare_algo_params({"damping": 0.5}, maxsum.algo_params)
    p3c = compile_from_arrays(s, t, 3, unary=u, device="cpu")
    p3 = p3c.to(dev)
    kw = dict(rounds=1024, chunk_size=256, cost_every=8, return_state=True)
    base, _, _ = supervised(run_batched, p3, maxsum, params, **kw)
    launches = {}

    # -- 13a. transient retries.  Chaos seed 6, not 1: under seed 1 no
    # chunk of the 4 draws a fault (the schedule is a pure hash, so the
    # CPU shows it); seed 6 fails chunks 1 and 3 once each, far inside
    # the budget
    spec, knobs, seed = "device_transient=0.2", {"retry_budget": 4}, 6
    mk.reset_launches()
    got, cnt, _ = supervised(run_batched, p3, maxsum, params, spec, seed,
                             knobs=knobs, **kw)
    torch.cuda.synchronize()
    for k, v in mk.launches.items():
        launches[k] = launches.get(k, 0) + v
    same_run(torch, "13a transient-coloring10k", got, base)
    # the CPU run of the same spec: the same 4 dispatches of the scope
    # (the decisions are a pure hash of the sequence), 8 rounds each
    _, cnt_cpu, _ = supervised(run_batched, p3c, maxsum, params, spec,
                               seed, knobs=knobs, rounds=32, chunk_size=8,
                               cost_every=8)
    if cnt != cnt_cpu or cnt.get("engine.retries") != 2:
        raise AssertionError(f"13a: card counters {cnt}, CPU {cnt_cpu}")
    emit("13a", "transient-coloring10k", spec=spec, chaos_seed=seed,
         retry_budget=4, counters=cnt, cpu_counters=cnt_cpu,
         cpu_rounds=32, cpu_chunk=8,
         engine_seconds=got.time, base_engine_seconds=base.time,
         bit_equal=True)
    overhead_row(torch, run_batched, maxsum, params, p3, 512,
                 "coloring-10k")
    overhead_row(torch, run_batched, maxsum, params, p1, 256, "coloring-1M")

    # -- 13b. OOM chunk halving 256 -> 128 -> 64
    spec = "device_oom=-:64"
    mk.reset_launches()
    got, cnt, _ = supervised(run_batched, p3, maxsum, params, spec, **kw)
    torch.cuda.synchronize()
    for k, v in mk.launches.items():
        launches[k] = launches.get(k, 0) + v
    same_run(torch, "13b oom-halve-coloring10k", got, base)
    if cnt.get("engine.oom_chunk_halvings") != 2:
        raise AssertionError(f"13b: {cnt}")
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "floor.npz")
        try:
            supervised(run_batched, p3, maxsum, params, spec,
                       knobs={"chunk_floor": 128}, checkpoint_path=ck,
                       checkpoint_every=999, **kw)
        except UnrecoverableDeviceError as e:
            kind = e.kind
        else:
            raise AssertionError("13b: chunk_floor=128 did not raise")
        meta = checkpoint_meta(ck)
        # the file holds the last healthy state: resumed without the
        # fault it ends as the uninterrupted run
        resumed, _, _ = supervised(run_batched, p3, maxsum, params,
                                   checkpoint_path=ck, resume=True, **kw)
        same_run(torch, "13b resume from the floor's checkpoint", resumed,
                 base)
    emit("13b", "oom-halve-coloring10k", spec=spec, counters=cnt,
         floor_128_raised=kind, floor_checkpoint_round=meta.get("rounds_done"),
         resumed_bit_equal=True, engine_seconds=got.time, bit_equal=True)
    return launches


def group_cells(torch, mk, dev, s, t, u):
    """13c-d: phase 9e's group under device_oom=2 and nan_inject=1:3."""
    from pydcop_tpu_torch.api import solve_many
    from pydcop_tpu_torch.engine.supervisor import UnrecoverableDeviceError
    from pydcop_tpu_torch.ops.compile import compile_from_arrays

    graphs = group_graphs(s, u)
    pes = [compile_from_arrays(sk, t, 3, unary=uk, pad_policy="pow2",
                               device=dev) for sk, uk in graphs]
    mkw = dict(rounds=1024, chunk_size=256, seed=list(MANY_SEEDS))
    prm = {"damping": 0.5}
    base = solve_many(pes, "maxsum", prm, **mkw)
    launches = {}

    # -- 13c. the group split: 8 -> 4+4 -> 2+2+2+2
    mk.reset_launches()
    split = solve_many(pes, "maxsum", prm, chaos="device_oom=2",
                       chaos_seed=1, **mkw)
    torch.cuda.synchronize()
    got = expect_launches(mk, "13c many-coloring10k-maxsum-I8 split",
                          {"factor_round_binary": 4 * 1024,
                           "q_update": 4 * 1024})
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    for i, (g, b) in enumerate(zip(split, base)):
        same_instance(f"13c split instance {i}", g, b)
    cnt = sup_counts(split[0]["telemetry"])
    cpu = solve_many(
        [compile_from_arrays(sk, t, 3, unary=uk, pad_policy="pow2",
                             device="cpu") for sk, uk in graphs],
        "maxsum", prm, rounds=8, chunk_size=256, seed=list(MANY_SEEDS),
        chaos="device_oom=2", chaos_seed=1, device="cpu")
    cnt_cpu = sup_counts(cpu[0]["telemetry"])
    if cnt.get("engine.oom_splits") != 3 or cnt != cnt_cpu:
        raise AssertionError(f"13c: card {cnt}, CPU {cnt_cpu}")
    emit("13c", "split-many-coloring10k-maxsum-I8", spec="device_oom=2",
         width=8, counters=cnt, cpu_counters=cnt_cpu, cpu_rounds=8,
         launches=got, group_seconds=split[0]["time"] * 8,
         base_group_seconds=base[0]["time"] * 8, bit_equal=True)
    run_real_oom_split()

    # -- 13d. NaN quarantine of lane 3
    mk.reset_launches()
    nan = solve_many(pes, "maxsum", prm, chaos="nan_inject=1:3",
                     chaos_seed=1, **mkw)
    torch.cuda.synchronize()
    got = expect_launches(mk, "13d many-coloring10k-maxsum-I8 quarantine",
                          {"factor_round_binary": 1024, "q_update": 1024})
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    statuses = [r["status"] for r in nan]
    if statuses != ["finished"] * 3 + ["degraded"] + ["finished"] * 4:
        raise AssertionError(f"13d: statuses {statuses}")
    for i, (g, b) in enumerate(zip(nan, base)):
        if i != 3:
            same_instance(f"13d instance {i}", g, b)
    lane = nan[3]
    if not (math.isfinite(lane["cost"]) and lane["final_cost"] == lane["cost"]
            and lane["cost"] >= base[3]["cost"]):
        raise AssertionError(f"13d: lane 3 reports {lane['cost']}")
    try:
        solve_many(pes, "maxsum", prm, chaos="nan_inject=1:3", chaos_seed=1,
                   on_numeric_fault="raise", rounds=256, chunk_size=256,
                   seed=list(MANY_SEEDS))
    except UnrecoverableDeviceError as e:
        raised = e.kind
    else:
        raise AssertionError("13d: on_numeric_fault='raise' did not raise")
    emit("13d", "quarantine-many-coloring10k-maxsum-I8",
         spec="nan_inject=1:3", statuses=statuses, lane3_cost=lane["cost"],
         lane3_uninjected_cost=base[3]["cost"],
         counters=sup_counts(nan[0]["telemetry"]), raise_mode=raised,
         others_bit_equal=True)
    return launches


def single_nan_cell(torch, dev, s, t, u):
    """13d: one coloring-10k run under nan_inject=1 degrades and writes
    no final checkpoint."""
    import os
    import tempfile

    from pydcop_tpu_torch.algorithms import maxsum, prepare_algo_params
    from pydcop_tpu_torch.engine.batched import run_batched
    from pydcop_tpu_torch.ops.compile import compile_from_arrays

    params = prepare_algo_params({"damping": 0.5}, maxsum.algo_params)
    p3 = compile_from_arrays(s, t, 3, unary=u, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "nan.npz")
        r, cnt, _ = supervised(run_batched, p3, maxsum, params,
                               "nan_inject=1", rounds=1024, chunk_size=256,
                               cost_every=8, checkpoint_path=ck,
                               checkpoint_every=999)
        written = os.path.exists(ck)
    if r.status != "degraded" or written or not math.isfinite(r.best_cost):
        raise AssertionError(f"13d single: {r.status}, checkpoint {written}")
    emit("13d", "quarantine-coloring10k", status=r.status, cycles=r.cycles,
         best_cost=r.best_cost, counters=cnt, final_checkpoint=written)


def exact_cells(torch):
    """13e: DPOP's level ladder and the planner's re-plan rung."""
    from argparse import Namespace

    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.commands.generators.secp import generate

    hub = hubtree_dcop()
    auto = {"util_device": "auto"}
    free = solve(hub, "dpop", auto)
    kw = dict(chaos="device_oom=8", chaos_seed=1)
    card = solve(hub, "dpop", auto, **kw)
    cpu = solve(hub, "dpop", auto, device="cpu", **kw)
    same_solution("13e dpop-hubtree-d24 device_oom=8", card, free)
    cc, cp = sup_counts(card["telemetry"]), sup_counts(cpu["telemetry"])
    if (cc != cp or any(card[k] != cpu[k] for k in DPOP_STATS)
            or not cc.get("engine.oom_splits")):
        raise AssertionError(f"13e hub: card {cc}, CPU {cp}")
    emit("13e", "dpop-hubtree-d24-oom", spec="device_oom=8", counters=cc,
         util_dispatches=card["util_dispatches"],
         free_util_dispatches=free["util_dispatches"],
         util_time=card["util_time"], free_util_time=free["util_time"],
         equal=True)
    mb = generate(Namespace(**MB_SPEC))
    always = {"util_device": "always"}
    mkw = dict(max_util_bytes=MB_BUDGET, pad_policy="pow2")
    free = solve(mb, "dpop", always, **mkw)
    cap = free["membound"]["peak_table_bytes"] // 2
    spec = f"device_oom_bytes={cap}"
    card = solve(mb, "dpop", always, chaos=spec, chaos_seed=1, **mkw)
    cpu = solve(mb, "dpop", always, chaos=spec, chaos_seed=1, device="cpu",
                **mkw)
    same_solution("13e membound-secp96 device_oom_bytes", card, free)
    same_solution("13e membound-secp96 card/cpu", card, cpu)
    if (card["membound"] != {**cpu["membound"]}
            or card["membound"]["replans"] < 1):
        raise AssertionError(f"13e membound: card {card['membound']}, CPU "
                             f"{cpu['membound']}")
    emit("13e", "membound-secp96-oom-bytes", spec=spec,
         planned_peak_table_bytes=free["membound"]["peak_table_bytes"],
         replans=card["membound"]["replans"],
         budget_bytes=card["membound"]["budget_bytes"],
         on_device=card["membound"]["on_device"],
         counters=sup_counts(card["telemetry"]),
         util_time=card["util_time"], free_util_time=free["util_time"],
         equal=True)


def blockdiag_cells(torch, mk, dev, s, t, u, p1):
    """13f: Max-Sum's belief="blockdiag" on the card; ``p1`` is the
    coloring-1M problem on the card."""
    import numpy as np

    from pydcop_tpu_torch.algorithms import maxsum, prepare_algo_params
    from pydcop_tpu_torch.engine.batched import run_batched
    from pydcop_tpu_torch.ops.compile import compile_from_arrays

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("13f: TF32 products are on")
    pb = prepare_algo_params({"damping": 0.5, "belief": "blockdiag"},
                             maxsum.algo_params)
    pa = prepare_algo_params({"damping": 0.5}, maxsum.algo_params)
    p3c = compile_from_arrays(s, t, 3, unary=u, device="cpu")
    p3 = p3c.to(dev)
    # per round: one step on the card and one on the CPU from the card's
    # state (the one-hot products add in another order on each)
    st = maxsum.init_state(p3, 0, pb)
    cpu_static = {k: v.cpu() for k, v in st.items() if k.startswith("bd_")}
    worst = 0.0
    for _ in range(BD_ROUNDS):
        nxt = maxsum.step(p3, st, pb)
        ref = maxsum.step(p3c, {**{k: v.cpu() for k, v in st.items()
                                   if not k.startswith("bd_")},
                                **cpu_static}, pb)
        worst = max(worst, float((nxt["q"].cpu() - ref["q"]).abs().max()))
        st = nxt
    if worst > BD_TOL:
        raise AssertionError(f"13f: per-round q differs by {worst}")
    kw = dict(rounds=BD_ROUNDS, chunk_size=256, cost_every=8)
    mk.reset_launches()
    card = run_batched(p3, maxsum, pb, **kw)
    torch.cuda.synchronize()
    got = expect_launches(mk, "13f blockdiag-coloring10k",
                          {"factor_round_binary_shared": BD_ROUNDS,
                           "q_update": BD_ROUNDS})
    cpu = run_batched(p3c, maxsum, pb, **kw)
    auto = run_batched(p3, maxsum, pa, **kw)
    if card.best_cost != cpu.best_cost:
        raise AssertionError(f"13f: best cost {card.best_cost} on the card, "
                             f"{cpu.best_cost} on the CPU")
    n_real = p3.n_real_edges
    emit("13f", "blockdiag-coloring10k", rounds=BD_ROUNDS,
         per_round_q_max_abs_diff=worst, tolerance=BD_TOL,
         best_cost=card.best_cost, cpu_best_cost=cpu.best_cost,
         auto_best_cost=auto.best_cost,
         onehot_bytes=int(st["bd_onehot"].numel() * 4),
         onehot_shape=list(st["bd_onehot"].shape),
         msgs_per_s=2 * n_real * BD_ROUNDS / card.time,
         auto_msgs_per_s=2 * n_real * BD_ROUNDS / auto.time, launches=got)
    del st, nxt, ref, cpu_static

    # coloring-1M: the belief alone, the engine, a profiled stretch of
    # rounds in each mode
    t0 = time.perf_counter()
    st1 = maxsum.init_state(p1, 0, pb)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    perm, onehot = st1["bd_perm"], st1["bd_onehot"]
    gen = torch.Generator(device=dev).manual_seed(5)
    r = torch.rand((3, p1.n_edges), generator=gen, device=dev)
    unary_t = p1.unary_t.clone()
    bd = maxsum._belief_blockdiag(p1, perm, onehot, r, unary_t)
    slots = maxsum.belief_from_r(p1, r, unary_t)
    diff = float((bd - slots).abs().max())
    if not diff <= BD_TOL * float(slots.abs().max()):
        raise AssertionError(f"13f 1M: blockdiag belief off by {diff}")
    del bd, slots
    bd_ms = device_ms(torch, lambda: maxsum._belief_blockdiag(
        p1, perm, onehot, r, unary_t), batch=5)
    slots_ms = device_ms(torch, lambda: maxsum.belief_from_r(
        p1, r, unary_t), batch=5)
    del r
    onehot_bytes = onehot.numel() * 4
    onehot_shape = list(onehot.shape)
    # the bytes the product must move: the one-hot once, the permuted r
    # (d·B·Lmax f32) and the belief (d·n f32)
    bd_bytes = onehot_bytes + 4 * 3 * (perm.numel() + p1.n_vars)

    def steps(state, params, n=16):
        t1 = time.perf_counter()
        for _ in range(n):
            state = maxsum.step(p1, state, params)
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    profile_call(torch, "blockdiag-coloring-1M", lambda: steps(st1, pb), 16)
    st_a = maxsum.init_state(p1, 0, pa)
    profile_call(torch, "slot-gathers-coloring-1M",
                 lambda: steps(st_a, pa), 16)
    del st1, st_a, perm, onehot
    torch.cuda.empty_cache()
    mk.reset_launches()
    res = run_batched(p1, maxsum, pb, rounds=256, chunk_size=256,
                      cost_every=8)
    torch.cuda.synchronize()
    got1 = expect_launches(mk, "13f blockdiag-coloring1M",
                           {"factor_round_binary_shared": 256,
                            "q_update": 256})
    for k, v in got1.items():
        got[k] = got.get(k, 0) + v
    emit("13f", "blockdiag-coloring1M", rounds=256,
         onehot_shape=onehot_shape,
         onehot_bytes=onehot_bytes, index_build_seconds=build_s,
         belief_device_ms_blockdiag=bd_ms,
         belief_device_ms_slot_gathers=slots_ms,
         belief_blockdiag_bound_ms=bd_bytes / HBM_BYTES_PER_S * 1e3,
         belief_max_abs_diff=diff,
         engine_seconds_with_index_build=res.time,
         best_cost=res.best_cost, launches=got1)
    torch.cuda.empty_cache()
    return got


def real_oom_split(card):
    """13c's real OOM (a child process: the allocator cap is process
    wide).  The 8 graphs with 8 restarts each (B = 64) under a cap that
    the whole group exceeds and a half fits: the first dispatch raises
    torch.cuda.OutOfMemoryError, the group splits, and every instance
    equals the uncapped run."""
    import os
    import tempfile

    import torch

    from pydcop_tpu_torch.api import solve_many
    from pydcop_tpu_torch.ops.compile import (
        compile_from_arrays,
        stack_problems,
    )
    from pydcop_tpu_torch.ops.generate import coloring_arrays

    CARD["card"] = card
    dev = torch.device("cuda", 0)
    s, t, u = coloring_arrays(10_000, colors=3, degree=3, seed=1)
    pes = [compile_from_arrays(sk, t, 3, unary=uk, pad_policy="pow2",
                               device=dev) for sk, uk in group_graphs(s, u)]
    kw = dict(rounds=64, chunk_size=64, seed=list(MANY_SEEDS), n_restarts=8)
    prm = {"damping": 0.5}

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_reserved() - base

    free, whole = peak(lambda: solve_many(pes, "maxsum", prm, **kw))
    _, half = peak(lambda: solve_many(pes[:4], "maxsum", prm,
                                      **dict(kw, seed=list(MANY_SEEDS[:4]))))
    before = torch.cuda.memory_allocated()
    grp = stack_problems(pes)
    stack_bytes = torch.cuda.memory_allocated() - before
    del grp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the cap: a half's peak plus half the group's stacked problem.  A
    # split frees the group's stacked tensors before its halves run, so
    # a half fits; had the group stayed alive beside its halves, they
    # would not
    room = half + stack_bytes // 2
    if whole - room < (16 << 20):
        raise AssertionError(f"13c real OOM: whole {whole} B, half {half} B "
                             f"+ stack {stack_bytes} B / 2 leave no room")
    cap = torch.cuda.memory_reserved() + room
    total = torch.cuda.get_device_properties(0).total_memory
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "oom.jsonl")
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            capped = solve_many(pes, "maxsum", prm, trace=trace, **kw)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
            torch.cuda.empty_cache()
        with open(trace) as f:
            events = [json.loads(line) for line in f]
    splits = [e for e in events if e.get("kind") == "event"
              and e.get("name") == "oom-split"]
    real = [e for e in splits if "out of memory" in e["args"]["error"]]
    cnt = sup_counts(capped[0]["telemetry"])
    if not real or cnt.get("fault.device_oom"):
        raise AssertionError(f"13c real OOM: no real OOM split ({cnt})")
    for i, (g, b) in enumerate(zip(capped, free)):
        same_instance(f"13c real OOM instance {i}", g, b)
    emit("13c", "real-oom-many-coloring10k-maxsum-I8-K8", width=64,
         rounds=64, whole_group_peak_bytes=whole, half_group_peak_bytes=half,
         stacked_group_bytes=stack_bytes, cap_room_bytes=room,
         oom_splits=cnt.get("engine.oom_splits"),
         real_oom_splits=len(real),
         first_error=real[0]["args"]["error"][:120], bit_equal=True)


def run_real_oom_split():
    """:func:`real_oom_split` in a child process on the same card."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.real_oom_split(sys.argv[2])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(HERE), CARD["card"]], cwd=HERE,
        capture_output=True, text=True, timeout=600,
    )
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        raise AssertionError("13c real OOM (its own process) failed:\n"
                             + proc.stderr[-4000:])


def supervisor_phase(torch, mk, dev, card, arrays, s5, t5, u5):
    """Phase 13 (see the module docstring).  Returns the launches of its
    main-path runs by kernel entry."""
    CARD["card"] = card
    t_lap = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        print(f"phase {part} seconds={now - t_lap[0]}")
        t_lap[0] = now

    from pydcop_tpu_torch.ops.compile import compile_from_arrays

    s, t, u = arrays
    p1 = compile_from_arrays(s5, t5, 3, unary=u5, device=dev)
    single = transient_and_halving_cells(torch, mk, dev, s, t, u, p1)
    lap("13a-b")
    group = group_cells(torch, mk, dev, s, t, u)
    single_nan_cell(torch, dev, s, t, u)
    lap("13c-d")
    exact_cells(torch)
    lap("13e")
    bd = blockdiag_cells(torch, mk, dev, s, t, u, p1)
    del p1
    torch.cuda.empty_cache()
    lap("13f")
    counts = {}
    for k in ("factor_round_binary_shared", "q_update"):
        counts[k] = single.get(k, 0) + bd.get(k, 0)
    counts["factor_round_binary.batched_instances"] = group.get(
        "factor_round_binary", 0)
    counts["q_update.batched_instances_pow2"] = group.get("q_update", 0)
    return counts


# -- phase 14: the dynamic path ------------------------------------------------

# the dynamic-coloring10k-sensors cell (module docstring, phase 14)
DYN_FINAL_ROUNDS = 256
DYN_ROUNDS_PER_S = 320.0
DYN_CHUNK = 64
DYN_SIZE = {"n_vars": 10_000, "n_sensors": 200, "n_agents": 100}
DYN_CAPACITY = 2.03  # each agent's capacity, in shares of the footprint


def sensor_coloring_dcop(n_vars, n_sensors, n_agents):
    """Phase 9's coloring (:func:`coloring_dcop`, seed 1) with
    ``n_sensors`` external sensors ``s0…`` (3 colours, value 0): the
    first half tracked by ``track_k`` (``v`` at every ``n_vars /
    (n_sensors / 2)``-th variable equals its sensor, cost 1 otherwise:
    a unary row after slicing), the second half read by ternary
    ``pair_k`` constraints on evenly spread coloring edges (cost 1 on
    equal endpoints plus 0.5 when the first equals the sensor: a
    per-factor binary row after slicing).  ``n_agents`` agents
    ``a00…`` with a capacity of ``DYN_CAPACITY`` shares of the Max-Sum
    factor graph's footprint (their own share, one replica share and 3%
    to spare); ``a13`` and ``a14`` share a cheap route (0.1) and every
    other agent reaches them at 10, so each holds the other's replicas,
    as co-located agents do.  Returns the DCOP and the capacity."""
    from pydcop_tpu_torch.algorithms import maxsum
    from pydcop_tpu_torch.dcop import (
        AgentDef,
        ExternalVariable,
        constraint_from_str,
    )
    from pydcop_tpu_torch.graphs import factor_graph

    dcop = coloring_dcop(n_vars, colors=3, degree=3, seed=1)
    dom = dcop.variables["v0"].domain
    sensors = [ExternalVariable(f"s{k}", dom, value=0)
               for k in range(n_sensors)]
    for s in sensors:
        dcop.add_variable(s)
    half = n_sensors // 2
    edges = [c for c in dcop.constraints.values()]
    for k in range(half):
        i = k * (n_vars // half)
        v = dcop.variables[f"v{i}"]
        dcop.add_constraint(constraint_from_str(
            f"track_{k}", f"0 if v{i} == s{k} else 1", [v, sensors[k]]))
    for k in range(half):
        a, b = edges[k * (len(edges) // half)].scope_names
        dcop.add_constraint(constraint_from_str(
            f"pair_{k}",
            f"(1 if {a} == {b} else 0) + (0.5 if {a} == s{half + k} else 0)",
            [dcop.variables[a], dcop.variables[b], sensors[half + k]]))
    graph = factor_graph.build_computation_graph(dcop)
    share = sum(maxsum.computation_memory(n) for n in graph.nodes) / n_agents
    names = [f"a{i:02d}" for i in range(n_agents)]
    rack = {"a13": "a14", "a14": "a13"}
    dcop.add_agents([
        AgentDef(name, capacity=DYN_CAPACITY * share,
                 routes=({rack[name]: 0.1} if name in rack
                         else {"a13": 10.0, "a14": 10.0}))
        for name in names
    ])
    return dcop, DYN_CAPACITY * share


def sensor_scenario(capacity, n_set=50):
    """Phase 14's scenario: one event setting ``n_set`` sensors to 1
    (the incremental path), a delay of 0.8 s, ``a07`` leaves (each
    orphan migrates to its one replica: no reparation solve, the problem
    and its fingerprint unchanged, the full state carries), a delay,
    ``a13`` and ``a14`` leave in one event (``a13``'s orphans move onto
    their replicas on ``a14``; the survivors' capacity then falls 1%
    short of a replica for every computation, so the last ones placed,
    variables, have none when ``a14`` leaves: they are lost, freeze, and
    the problem recompiles in full), ``a100`` joins with ``capacity``,
    a delay."""
    from pydcop_tpu_torch.dcop import EventAction, Scenario, ScenarioEvent

    n_sensors = DYN_SIZE["n_sensors"]
    sets = [EventAction("set_value", variable=f"s{k}", value=1)
            for k in range(0, n_sensors, max(1, n_sensors // n_set))][:n_set]
    return Scenario([
        ScenarioEvent("sense", actions=sets),
        ScenarioEvent(delay=0.8),
        ScenarioEvent("lose_a07", actions=[
            EventAction("remove_agent", agent="a07")]),
        ScenarioEvent(delay=0.4),
        ScenarioEvent("lose_rack", actions=[
            EventAction("remove_agent", agent="a13"),
            EventAction("remove_agent", agent="a14")]),
        ScenarioEvent("join", actions=[
            EventAction("add_agent", agent="a100", capacity=capacity)]),
        ScenarioEvent(delay=0.4),
    ])


class _Patched:
    """Wrap ``getattr(owner, name)`` for the length of a ``with``:
    ``hook(real, *args, **kw)`` runs in its place."""

    def __init__(self, owner, name, hook):
        self.owner, self.name, self.hook = owner, name, hook

    def __enter__(self):
        self.real = getattr(self.owner, self.name)
        real, hook = self.real, self.hook
        setattr(self.owner, self.name,
                lambda *a, **kw: hook(real, *a, **kw))
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


def dynamic_run(torch, mk, dev, dcop, scenario, k_target, final_rounds,
                fresh_check=False):
    """One ``run_dynamic`` of Max-Sum on ``dev`` with every seam the
    phase reads recorded: each segment's compile (kind, seconds, patch
    bytes) and engine run (rounds, seconds, messages, kernel launches),
    the distribution, replica, repair and reparation-solve host
    seconds, the ``compile.*`` counters.  With ``fresh_check`` the first incremental update's
    tensors are held against a fresh ``compile_dcop`` of the active
    problem, bit for bit.  Returns (result, record)."""
    import contextlib

    import pydcop_tpu_torch.api as api
    import pydcop_tpu_torch.distribution as dist_pkg
    import pydcop_tpu_torch.replication as rep_pkg
    from pydcop_tpu_torch.engine import batched, incremental
    from pydcop_tpu_torch.engine.dynamic import run_dynamic
    from pydcop_tpu_torch.ops.compile import ARRAY_FIELDS, compile_dcop
    from pydcop_tpu_torch.telemetry import session

    rec = {"compiles": [], "segments": [], "host": {}, "fresh": None}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    class Recording(incremental.IncrementalCompiler):
        def compile(self, frozen, ext_overrides):
            self.kind = "reused"
            sync()
            t0 = time.perf_counter()
            out = super().compile(frozen, ext_overrides)
            sync()
            kind = self.kind
            row = {"kind": kind, "seconds": time.perf_counter() - t0}
            if kind == "incremental":
                row.update(self.last_update)
                if fresh_check and rec["fresh"] is None:
                    rec["fresh"] = self._fresh_equal(frozen)
            rec["compiles"].append(row)
            return out

        def _apply_updates(self, *a):
            self.kind = "incremental"
            return super()._apply_updates(*a)

        def _full_compile(self, *a):
            self.kind = "full"
            return super()._full_compile(*a)

        def _fresh_equal(self, frozen):
            p = self._problem
            fresh = compile_dcop(self._active_dcop(frozen, self._ext_state),
                                 pad_policy=self.pad_policy,
                                 device=self.device)
            leaves = [(f, getattr(p, f), getattr(fresh, f))
                      for f in ARRAY_FIELDS]
            for k, b in fresh.buckets.items():
                leaves += [(f"buckets.{k}.{f}", getattr(p.buckets[k], f),
                            getattr(b, f)) for f in ("tables", "tables_t")]
            bad = [n for n, a, b in leaves
                   if not (same_bits(torch, a, b) if a.is_floating_point()
                           else torch.equal(a, b))]
            return {"leaves": len(leaves), "unequal": bad}

    def engine(real, problem, module, params, **kw):
        if module.__name__.rsplit(".", 1)[-1] != "maxsum":
            return real(problem, module, params, **kw)
        before = dict(mk.launches)
        res = real(problem, module, params, **kw)
        rec["segments"].append({
            "rounds": res.cycles, "seconds": res.time,
            "messages": res.messages,
            "launches": {k: mk.launches[k] - before[k] for k in before},
        })
        return res

    def timed(key):
        def hook(real, *a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            rec["host"].setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return hook

    with contextlib.ExitStack() as st:
        st.enter_context(_Patched(incremental, "IncrementalCompiler",
                                  lambda real, *a, **kw: Recording(*a, **kw)))
        st.enter_context(_Patched(batched, "run_batched", engine))
        st.enter_context(_Patched(dist_pkg, "compute_distribution",
                                  timed("distribution")))
        st.enter_context(_Patched(rep_pkg, "replica_distribution",
                                  timed("replicas")))
        st.enter_context(_Patched(rep_pkg, "repair_placement",
                                  timed("repair")))
        st.enter_context(_Patched(api, "solve", timed("reparation_solve")))
        tel = st.enter_context(session())
        t0 = time.perf_counter()
        res = run_dynamic(
            dcop, "maxsum", {"damping": 0.5}, scenario=scenario,
            distribution="adhoc", k_target=k_target,
            rounds_per_second=DYN_ROUNDS_PER_S, final_rounds=final_rounds,
            seed=1, chunk_size=DYN_CHUNK, device=dev,
        )
        rec["seconds"] = time.perf_counter() - t0
        rec["counters"] = {k: v for k, v in tel.summary()["counters"].items()
                           if k.startswith("compile.")}
    return res, rec


DYN_EXACT = ("assignment", "cost", "cost_trace", "cycle", "msg_count",
             "status", "events", "state_transfers", "lost_computations",
             "replicas", "agents_final")


def dynamic_phase(torch, mk, dev, card, single_msgs_per_s):
    """Phase 14 (see the module docstring).  Returns the launches of its
    card run by kernel entry."""
    CARD["card"] = card
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dcop, cap = sensor_coloring_dcop(**DYN_SIZE)
    build_s = time.perf_counter() - t0
    cpu = torch.device("cpu")

    # 14a: k = 1 on the card (counts set to 0 just before) and the CPU
    mk.reset_launches()
    card_r, card_rec = dynamic_run(torch, mk, dev, dcop,
                                   sensor_scenario(capacity=cap), 1,
                                   DYN_FINAL_ROUNDS, fresh_check=True)
    launches = dict(mk.launches)
    cpu_r, cpu_rec = dynamic_run(torch, mk, cpu, dcop,
                                 sensor_scenario(capacity=cap), 1,
                                 DYN_FINAL_ROUNDS)
    for k in DYN_EXACT:
        if card_r[k] != cpu_r[k]:
            raise AssertionError(f"14a: card and CPU differ in {k}")
    if card_rec["counters"] != cpu_rec["counters"]:
        raise AssertionError(f"14a: compile counters differ: "
                             f"{card_rec['counters']} {cpu_rec['counters']}")
    kinds = [c["kind"] for c in card_rec["compiles"]]
    for kind in ("full", "incremental", "reused"):
        if card_rec["counters"].get(f"compile.{kind}", 0) < 1:
            raise AssertionError(f"14a: no {kind} compile ({kinds})")
    fresh = card_rec["fresh"]
    if fresh is None or fresh["unequal"]:
        raise AssertionError(f"14a: patched tensors differ from a fresh "
                             f"compile: {fresh}")
    rounds = [s["rounds"] for s in card_rec["segments"]]
    if sum(rounds) != card_r["cycle"] or len(rounds) != len(kinds):
        raise AssertionError(f"14a: segments {rounds} vs cycle "
                             f"{card_r['cycle']}, compiles {kinds}")
    for i, seg in enumerate(card_rec["segments"]):
        got = seg["launches"]
        if (got["factor_round_binary"], got["q_update"],
                got["factor_round_binary_shared"]) != (seg["rounds"],
                                                       seg["rounds"], 0):
            raise AssertionError(f"14a: segment {i} ran {seg['rounds']} "
                                 f"rounds, launches {got}")
    removal = [e for e in card_r["events"] if e.get("action") == "remove_agent"]
    migrated_only = removal[0]["migrated"] and not removal[0]["lost"]
    if not migrated_only or not card_r["lost_computations"]:
        raise AssertionError(f"14a: the scenario missed a branch: a07 "
                             f"lost {removal[0]['lost'][:5]}, frozen "
                             f"{card_r['lost_computations'][:5]}")
    if not all(math.isfinite(c) for c in card_r["cost_trace"]):
        raise AssertionError("14a: non-finite cost")
    segs = [dict(rounds=s["rounds"], engine_seconds=s["seconds"],
                 msgs_per_s=s["messages"] / s["seconds"])
            for s in card_rec["segments"]]
    emit("14a", "dynamic-coloring10k-sensors", k_target=1,
         n_vars=len(dcop.variables), n_sensors=len(dcop.external_variables),
         n_constraints=len(dcop.constraints), agents=len(dcop.agents),
         capacity=cap, build_seconds=build_s,
         compiles=card_rec["compiles"], segments=segs,
         phase3_coloring10k_msgs_per_s=single_msgs_per_s,
         distribution_seconds=card_rec["host"].get("distribution"),
         replica_seconds=card_rec["host"].get("replicas"),
         repair_seconds=card_rec["host"].get("repair"),
         run_seconds=card_rec["seconds"], cpu_run_seconds=cpu_rec["seconds"],
         cycle=card_r["cycle"], cost=card_r["cost"],
         state_transfers=card_r["state_transfers"],
         migrated_a07=len(removal[0]["migrated"]),
         lost=[len(e["lost"]) for e in removal],
         frozen_variables=len(card_r["lost_computations"]),
         compile_counters=card_rec["counters"], fresh_compile=fresh,
         launches=launches, card_equals_cpu=True)

    # 14b: k = 2: a07's orphans have two live candidates each, so a
    # reparation DCOP is solved (MGM, on the run's device)
    from pydcop_tpu_torch.algorithms import maxsum
    from pydcop_tpu_torch.dcop import Scenario
    from pydcop_tpu_torch.distribution import compute_distribution
    from pydcop_tpu_torch.graphs import factor_graph
    from pydcop_tpu_torch.replication import replica_distribution

    short = Scenario(sensor_scenario(capacity=cap).events[2:4])  # a07, delay

    graph = factor_graph.build_computation_graph(dcop)
    nodes = {n.name: n for n in graph.nodes}

    def foot(c):
        return float(maxsum.computation_memory(nodes[c]))

    dist0 = compute_distribution("adhoc", graph, dcop.agents.values(),
                                 algo_module=maxsum)
    reps0 = replica_distribution(dist0, dcop.agents.values(), 2,
                                 footprint=foot)
    k2 = {}
    for label, device in (("card", dev), ("cpu", cpu)):
        k2[label] = dynamic_run(torch, mk, device, dcop, short, 2, 64)
    (c2, r2), (h2, _) = k2["card"], k2["cpu"]
    moved = c2["events"][0]["migrated"]
    hosted = {a: sum(foot(c) for c in cs)
              for a, cs in dist0.mapping.items() if a != "a07"}
    for comp, agent in moved.items():
        if agent == "a07" or agent not in reps0.replicas(comp):
            raise AssertionError(f"14b: {comp} moved to {agent}, not a live "
                                 f"replica holder {reps0.replicas(comp)}")
        hosted[agent] += foot(comp)
    over = {a: h for a, h in hosted.items() if h > cap + 1e-6}
    if over or not moved or not r2["host"].get("reparation_solve"):
        raise AssertionError(f"14b: repair invalid: over capacity {over}, "
                             f"moved {len(moved)}")
    same = all(c2[k] == h2[k] for k in DYN_EXACT)
    if not same:
        raise AssertionError("14b: card and CPU differ")
    emit("14b", "dynamic-coloring10k-sensors-k2", k_target=2,
         orphans=len(c2["events"][0]["orphaned"]), migrated=len(moved),
         lost=len(c2["events"][0]["lost"]),
         repair_seconds=r2["host"].get("repair"),
         reparation_solve_seconds=r2["host"].get("reparation_solve"),
         replica_seconds=r2["host"].get("replicas"),
         run_seconds=r2["seconds"], within_capacity=True,
         card_equals_cpu=same)
    emit("14", "phase", seconds=time.perf_counter() - t_phase)
    return {"factor_round_binary": launches["factor_round_binary"],
            "q_update": launches["q_update"]}


# -- phase 15: the rest of the CLI: batch, solve --profile, trace-summary ----

# the batch-coloring10k-maxsum cell (module docstring, phase 15)
BATCH_SEEDS = (1, 2, 3, 4)
BATCH_ROUNDS = 64  # short: the whole script has one time limit
BATCH_SPEC = {
    "sets": {"coloring10k": {
        "path": [f"coloring10k-s{s}" for s in BATCH_SEEDS],
        "iterations": 2}},
    "batches": {"maxsum": {
        "algo": "maxsum", "algo_params": {"damping": [0.5, 0.7]},
        "rounds": BATCH_ROUNDS, "chunk_size": 64, "pad_policy": "pow2"}},
}
BATCH_RUNS = len(BATCH_SEEDS) * 2 * 2
BATCH_CELLS = len(BATCH_SEEDS) * 2
PROFILE_ROUNDS = 64
NO_TIME = ("batch", "set", "problem", "iteration", "algo", "params",
           "status", "cost", "cycle", "msg_count")


def csv_rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class Recorder:
    """Wraps an ``api`` entry point and keeps each call's keywords and
    results, so a pass can show which path it took."""

    def __init__(self, api, name):
        self.api, self.name = api, name
        self.fn = getattr(api, name)
        self.calls = []

    def __enter__(self):
        def wrapped(*args, **kwargs):
            out = self.fn(*args, **kwargs)
            self.calls.append((kwargs, out))
            return out

        setattr(self.api, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.api, self.name, self.fn)


def batch_pass(torch, mk, label, result_file, base, load, dev, **flags):
    """One ``run_sweep`` of BATCH_SPEC with launch counts set to 0 just
    before; returns (summary, rows, launches, wall seconds, the
    ``solve``/``solve_many`` calls)."""
    import pydcop_tpu_torch.api as api
    from pydcop_tpu_torch.commands.batch import run_sweep

    if dev.type == "cuda":
        torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    with Recorder(api, "solve") as one, Recorder(api, "solve_many") as many:
        summary = run_sweep(BATCH_SPEC, base, result_file, device=dev,
                            load=load, **flags)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = csv_rows(result_file)
    if summary["failed"] or any(r["status"] != "finished" for r in rows):
        raise AssertionError(f"15a {label}: failed runs {summary}, "
                             f"{sorted({r['status'] for r in rows})}")
    return summary, rows, dict(mk.launches), wall, one.calls, many.calls


def trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def batch_phase(torch, mk, dev, base, dcops, single_msgs_per_s):
    """15a (see the module docstring).  Returns launches by kernel
    entry."""
    cpu = torch.device("cpu")

    def load(problem):
        return dcops[Path(problem).name]

    def out(name):
        return str(Path(base) / f"{name}.csv")

    def msgs_per_s(rows, wall):
        return sum(int(r["msg_count"]) for r in rows) / wall

    per = {}
    # sequential: one solve a run, each kernel once a round
    _, seq, got, wall, solves, _ = batch_pass(
        torch, mk, "sequential", out("sequential"), base, load, dev)
    want = BATCH_RUNS * BATCH_ROUNDS
    if (got["factor_round_binary"], got["q_update"],
            got["factor_round_binary_shared"]) != (want, want, 0) or len(
            solves) != BATCH_RUNS:
        raise AssertionError(f"15a sequential: launches {got}, "
                             f"{len(solves)} solves")
    per["sequential"] = dict(wall_seconds=wall, solves=len(solves),
                             msgs_per_s=msgs_per_s(seq, wall),
                             launches=got)
    # --vmap_cells: one solve_many, each group once a round
    _, cells, got, wall, solves, many = batch_pass(
        torch, mk, "vmap_cells", out("vmap_cells"), base, load, dev,
        vmap_cells=True)
    if solves or len(many) != 1:
        raise AssertionError(f"15a vmap_cells: {len(solves)} solves, "
                             f"{len(many)} solve_many calls (a fallback)")
    results = many[0][1]
    groups = results[0]["telemetry"]["counters"]["engine.batch_groups"]
    sizes = sorted(r["instances_batched"] for r in results)
    if round(sum(1 / b for b in sizes)) != groups:
        raise AssertionError(f"15a vmap_cells: {groups} groups, sizes "
                             f"{sizes}")
    want = groups * BATCH_ROUNDS
    if (got["factor_round_binary"], got["q_update"],
            got["factor_round_binary_shared"]) != (want, want, 0):
        raise AssertionError(f"15a vmap_cells: launches {got}, expected "
                             f"{want} of each ({groups} groups)")
    key = {tuple(r[k] for k in NO_TIME[:6]): [r[k] for k in NO_TIME]
           for r in cells}
    for r in seq:
        if key.get(tuple(r[k] for k in NO_TIME[:6])) != [
                r[k] for k in NO_TIME]:
            raise AssertionError(f"15a: vmap_cells row differs from the "
                                 f"sequential row: {r}")
    per["vmap_cells"] = dict(wall_seconds=wall, groups=groups,
                             instances_batched=sizes[-1],
                             msgs_per_s=msgs_per_s(cells, wall),
                             launches=got)
    cell_launches = got
    # --vmap_iterations: one solve a cell with 2 restarts
    _, its, got, wall, solves, many = batch_pass(
        torch, mk, "vmap_iterations", out("vmap_iterations"), base, load,
        dev, vmap_iterations=True)
    want = BATCH_CELLS * BATCH_ROUNDS
    if many or [kw.get("n_restarts") for kw, _ in solves] != [2] * (
            BATCH_CELLS) or (got["factor_round_binary"], got["q_update"],
                             got["factor_round_binary_shared"]) != (
            want, want, 0):
        raise AssertionError(f"15a vmap_iterations: {len(solves)} solves "
                             f"{[kw.get('n_restarts') for kw, _ in solves]}"
                             f", launches {got}")
    per["vmap_iterations"] = dict(wall_seconds=wall, solves=len(solves),
                                  msgs_per_s=msgs_per_s(its, wall),
                                  launches=got)
    iter_launches = got
    # the card's --vmap_cells CSV equals the port's CPU run of the call
    _, cpu_rows, _, cpu_wall, _, _ = batch_pass(
        torch, mk, "vmap_cells-cpu", out("vmap_cells_cpu"), base, load,
        cpu, vmap_cells=True)
    if [[r[k] for k in NO_TIME] for r in cpu_rows] != [
            [r[k] for k in NO_TIME] for r in cells]:
        raise AssertionError("15a: the card's vmap_cells CSV differs from "
                             "the CPU run's")
    # the same spec again into the same CSV: nothing runs
    again = batch_pass(torch, mk, "rerun", out("vmap_cells"), base, load,
                       dev, vmap_cells=True)[0]
    if (again["executed"], again["skipped"]) != (0, BATCH_RUNS):
        raise AssertionError(f"15a rerun: {again}")
    emit("15a", "batch-coloring10k-maxsum", runs=BATCH_RUNS,
         cells=BATCH_CELLS, rounds=BATCH_ROUNDS, passes=per,
         cpu_vmap_cells_seconds=cpu_wall, card_csv_equals_cpu=True,
         vmap_cells_equal_sequential=True, rerun=again,
         phase3_coloring10k_msgs_per_s=single_msgs_per_s,
         best_costs=sorted(float(r["cost"]) for r in cells)[:4])
    return {
        "factor_round_binary": per["sequential"]["launches"][
            "factor_round_binary"],
        "q_update": per["sequential"]["launches"]["q_update"],
        "factor_round_binary.batched_instances": cell_launches[
            "factor_round_binary"],
        "q_update.batched_instances_pow2": cell_launches["q_update"],
        "factor_round_binary.batched_restarts": iter_launches[
            "factor_round_binary"],
        "q_update.batched_restarts": iter_launches["q_update"],
    }


def profile_phase(torch, mk, dev, base, dcop):
    """15b (see the module docstring), run by :func:`profile_child`.
    Returns launches by kernel entry."""
    import glob

    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.commands.solve import profile

    kw = dict(rounds=PROFILE_ROUNDS, chunk_size=PROFILE_ROUNDS, device=dev)
    params = {"damping": 0.5}
    solve(dcop, "maxsum", params, **kw)  # warm: this process's first run
    torch.cuda.synchronize()
    mk.reset_launches()
    plain = solve(dcop, "maxsum", params, **kw)
    torch.cuda.synchronize()
    launches = expect_launches(mk, "15b unprofiled", {
        "factor_round_binary": PROFILE_ROUNDS, "q_update": PROFILE_ROUNDS})
    out = str(Path(base) / "profile")
    mk.reset_launches()
    with profile(out, dev):
        prof = solve(dcop, "maxsum", params, **kw)
        torch.cuda.synchronize()
    expect_launches(mk, "15b profiled", {
        "factor_round_binary": PROFILE_ROUNDS, "q_update": PROFILE_ROUNDS})
    for k in set(plain) - {"time", "telemetry"}:
        if prof[k] != plain[k]:
            raise AssertionError(f"15b: the profiled solve differs in {k}")
    files = glob.glob(str(Path(out) / "*.json"))
    if len(files) != 1:
        raise AssertionError(f"15b: {len(files)} trace files in {out}")
    events = trace_events(files[0])
    kern = [e for e in events if e.get("cat") == "kernel"]
    factor = sum(1 for e in kern
                 if "factor_kernel<" in e.get("name", ""))
    qup = sum(1 for e in kern if "q_update_kernel<" in e.get("name", ""))
    if (factor, qup) != (PROFILE_ROUNDS, PROFILE_ROUNDS):
        raise AssertionError(f"15b: the trace holds {factor} factor and "
                             f"{qup} q-update kernel events")
    spans = [e for e in events if e.get("ph") == "X"]
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e.get("dur", 0) for e in spans)
    busy = sum(e.get("dur", 0) for e in kern)
    launches = {k: 2 * launches[k] for k in ("factor_round_binary",
                                             "q_update")}
    emit("15b", "profile-coloring10k-maxsum", rounds=PROFILE_ROUNDS,
         trace_bytes=Path(files[0]).stat().st_size,
         trace_events=len(events), kernel_events=len(kern),
         factor_kernel_events=factor, q_update_kernel_events=qup,
         engine_seconds_profiled=prof["time"],
         engine_seconds_unprofiled=plain["time"],
         trace_window_ms=(t1 - t0) / 1e3, kernel_busy_ms=busy / 1e3,
         device_busy_share=busy / (t1 - t0),
         result_equals_unprofiled=True, launches=launches)
    return launches


def profile_child(card, base):
    """15b in a process of its own: torch.profiler loses events late in
    a long process (phase 11's note), and the gate counts every kernel
    event of the trace.  Run by :func:`run_profile_child`."""
    import torch

    from pydcop_tpu_torch.ops import maxsum_kernels as mk

    CARD["card"] = card
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mk.build()
    profile_phase(torch, mk, dev, base,
                  coloring_dcop(10_000, 3, 3, seed=BATCH_SEEDS[0]))


def run_profile_child(base):
    """:func:`profile_child` in a child process on the same card: its
    JSON line is printed here; its failure fails the phase.  Returns the
    launches of its solves by kernel entry."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.profile_child(sys.argv[2], "
            "sys.argv[3])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(HERE), CARD["card"], base],
        cwd=HERE, capture_output=True, text=True, timeout=600,
    )
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        raise AssertionError("15b (its own process) failed:\n"
                             + proc.stderr[-4000:])
    line = next(json.loads(x) for x in proc.stdout.splitlines()
                if x.startswith('{"phase": "15b"'))
    return line["launches"]


def trace_summary_phase(torch, mk, dev, base, dcop):
    """15c (see the module docstring).  Returns launches by kernel
    entry."""
    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.telemetry.summary import (
        format_summary,
        load_trace,
        summarize,
    )

    def aggregates(path):
        s = summarize(load_trace(path))
        return ({k: v["count"] for k, v in s["phases"].items()},
                s["events"], s["faults"], s["agents"],
                s["metrics"].get("counters")), s

    kw = dict(rounds=PROFILE_ROUNDS, chunk_size=16)
    runs = {}
    mk.reset_launches()
    for label, device, fmt in (("card-jsonl", dev, "jsonl"),
                               ("card-chrome", dev, "chrome"),
                               ("cpu-jsonl", torch.device("cpu"), "jsonl")):
        if label == "cpu-jsonl":  # the card runs' launches
            launches = expect_launches(mk, "15c", {
                "factor_round_binary": 2 * PROFILE_ROUNDS,
                "q_update": 2 * PROFILE_ROUNDS})
        path = str(Path(base) / f"trace-{label}.{fmt}")
        solve(dcop, "maxsum", {"damping": 0.5}, device=device, trace=path,
              trace_format=fmt, **kw)
        runs[label] = (path,) + aggregates(path)
    card, chrome, cpu = (runs[k][1] for k in ("card-jsonl", "card-chrome",
                                              "cpu-jsonl"))
    if card != cpu:
        raise AssertionError(f"15c: the card trace's counts differ from "
                             f"the CPU run's: {card} {cpu}")
    if card != chrome:
        raise AssertionError(f"15c: the JSONL and Chrome traces differ: "
                             f"{card} {chrome}")
    text = format_summary(runs["card-jsonl"][2])
    if "cycle" not in text or "engine.rounds" not in text:
        raise AssertionError(f"15c: format_summary rendered {text!r}")
    emit("15c", "trace-summary-coloring10k-maxsum", rounds=PROFILE_ROUNDS,
         spans=card[0], counters=card[4],
         bytes={k: Path(v[0]).stat().st_size for k, v in runs.items()},
         card_equals_cpu=True, jsonl_equals_chrome=True,
         summary_lines=len(text.splitlines()))
    return launches


def cli_phase(torch, mk, dev, card, single_msgs_per_s):
    """Phase 15 (see the module docstring).  Returns the launches of its
    card runs by kernel entry."""
    import tempfile

    CARD["card"] = card
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dcops = {f"coloring10k-s{s}": coloring_dcop(10_000, 3, 3, seed=s)
             for s in BATCH_SEEDS}
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=HERE) as base:
        counts = batch_phase(torch, mk, dev, base, dcops, single_msgs_per_s)
        for k, v in run_profile_child(base).items():
            counts[k] += v
        for k, v in trace_summary_phase(torch, mk, dev, base,
                                        dcops["coloring10k-s1"]).items():
            counts[k] = counts.get(k, 0) + v
    emit("15", "phase", seconds=time.perf_counter() - t_phase,
         build_seconds=build_s)
    return counts


# -- phase 16: serving: the solver service, sessions, recovery, the wire -----

# the serve-coloring10k-maxsum-C32 cell (module docstring, phase 16)
SERVE_CLIENTS = 32
SERVE_VARS = 10_000
SERVE_SEEDS = (1, 2, 3, 4)  # phase 15a's four coloring-10k DCOPs
SERVE_ROUNDS = 256
SERVE_CHUNK = 64
SERVE_PARAMS = {"damping": 0.5}
SERVE_WAIT = 300.0  # seconds: every wait of phase 16 is bounded
SESSION_ROUNDS = 64
RECOVERY_VARS = 2_000  # 16c's JSON-text session (its text parses 3 times)
# recompile_guard.py's incremental stage: 16 hubs x 256 leaves, seed 77
DELTA_TREE = (16, 256, 77)
DELTA_STEPS = 6
INCR_MAX_FRACTION = 0.05
SERVICE_ONLY = ("time", "util_time", "phases", "queue_wait",
                "instances_batched", "trace")


def serve_solve(svc, *args, **kwargs):
    """``SolverService.solve`` with phase 16's bounded wait."""
    return svc.submit(*args, **kwargs).result(SERVE_WAIT)


def serve_strip(r):
    return {k: v for k, v in r.items() if k not in SERVICE_ONLY}


def service_counters(tel, prefixes=("service.", "compile.", "engine.memo",
                                    "dpop.", "semiring.", "telemetry.")):
    return {k: v for k, v in tel.metrics.snapshot()["counters"].items()
            if k.startswith(prefixes)}


def serve_requests(svc, dcops, n, timeout):
    """``n`` client threads behind one barrier; thread i submits
    ``dcops[i % len(dcops)]`` with seed ``i // len(dcops)``.  Returns the
    results in thread order, the client latencies and the wall seconds
    from the barrier to the last result."""
    import threading

    barrier = threading.Barrier(n + 1)
    out = [None] * n
    lat = [0.0] * n
    errors = []

    def client(i):
        try:
            barrier.wait(timeout)
            t0 = time.perf_counter()
            p = svc.submit(dcops[i % len(dcops)], "maxsum", SERVE_PARAMS,
                           rounds=SERVE_ROUNDS, chunk_size=SERVE_CHUNK,
                           seed=i // len(dcops))
            out[i] = p.result(timeout)
            lat[i] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    barrier.wait(timeout)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"16: clients failed or hung: {errors[:3]}")
    return out, lat, wall


def serve_c32(torch, mk, dev, dcops, base):
    """16a (see the module docstring).  Returns the results by request,
    the launches and the service's trace path."""
    import statistics

    from pydcop_tpu_torch import telemetry
    from pydcop_tpu_torch.api import solve_compiled
    from pydcop_tpu_torch.engine.service import SolverService
    from pydcop_tpu_torch.ops.compile import _leaves, compile_dcop
    from pydcop_tpu_torch.telemetry.summary import (
        format_summary,
        load_trace,
        summarize,
    )

    t_cell = time.perf_counter()
    trace = str(Path(base) / "serve-c32.jsonl")
    torch.cuda.synchronize()
    mk.reset_launches()
    with telemetry.session(trace) as tel:
        with SolverService(pad_policy="pow2", instance_bucket="pow2",
                           max_batch=SERVE_CLIENTS, max_wait=0.05,
                           device=dev) as svc:
            got, lat, wall = serve_requests(svc, dcops, SERVE_CLIENTS,
                                            SERVE_WAIT)
        torch.cuda.synchronize()
        launches = dict(mk.launches)
        counters = service_counters(tel)
        stats = svc.stats()
    dispatches = counters["service.dispatches"]
    if counters["service.requests"] != SERVE_CLIENTS:
        raise AssertionError(f"16a: service.requests {counters}")
    spans = [r for r in load_trace(trace) if r.get("kind") == "span"
             and r.get("name") == "service.dispatch"]
    occupancy = [s["args"]["instances"] for s in spans]
    padded = sum(s["args"]["padded"] for s in spans)
    if (sum(occupancy), sum(occupancy) + padded) != (
            SERVE_CLIENTS, SERVE_CLIENTS
            + counters.get("service.pad_instances", 0)):
        raise AssertionError(f"16a: occupancy {occupancy}, padded {padded}")
    want = SERVE_ROUNDS * dispatches
    if (launches["factor_round_binary"], launches["q_update"],
            launches["factor_round_binary_shared"]) != (want, want, 0):
        raise AssertionError(f"16a: launches {launches}, expected {want} "
                             f"factor and q-update launches "
                             f"({dispatches} dispatches)")
    # every result equals a solo solve of the same compiled problem on
    # the card (four compiles, not 32)
    t0 = time.perf_counter()
    problems = [compile_dcop(d, pad_policy="pow2", device=dev)
                for d in dcops]
    compile_s = time.perf_counter() - t0
    # what one entry of the service's compiled-problem cache holds on
    # the card (a full cache holds compile_cache_max = 256 of them)
    entry_bytes = max(
        sum(t.numel() * t.element_size() for _, t in _leaves(p)
            if isinstance(t, torch.Tensor))
        for p in problems)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo = [solve_compiled(problems[i % len(dcops)], "maxsum", SERVE_PARAMS,
                           rounds=SERVE_ROUNDS, chunk_size=SERVE_CHUNK,
                           seed=i // len(dcops))
            for i in range(SERVE_CLIENTS)]
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    del problems
    for i, (r, s) in enumerate(zip(got, solo)):
        if r["status"] != "finished" or serve_strip(r) != serve_strip(s):
            raise AssertionError(f"16a: request {i} differs from its solo "
                                 f"solve_compiled")
    # a 4-request subset (requests 0, 4, 8, 12: the first DCOP, seeds
    # 0-3, one group of 4): the card equals the port's CPU service
    t0 = time.perf_counter()
    with SolverService(pad_policy="pow2", max_batch=4, max_wait=5.0,
                       device="cpu") as cpu_svc:
        cpu = [p.result(SERVE_WAIT) for p in [
            cpu_svc.submit(dcops[0], "maxsum", SERVE_PARAMS,
                           rounds=SERVE_ROUNDS, chunk_size=SERVE_CHUNK,
                           seed=j) for j in range(4)]]
    cpu_s = time.perf_counter() - t0
    for j, r in enumerate(cpu):
        if serve_strip(r) != serve_strip(got[len(dcops) * j]):
            raise AssertionError(f"16a: request {len(dcops) * j}: card "
                                 f"and CPU differ")
    text = format_summary(summarize(load_trace(trace)))
    head = f"service: {SERVE_CLIENTS} requests / {dispatches} dispatches"
    if head not in text:
        raise AssertionError(f"16a: trace-summary lacks {head!r}")
    lat_sorted = sorted(lat)
    phases = {k: statistics.median(r["phases"][k] for r in got)
              for k in got[0]["phases"]}
    emit("16a", "serve-coloring10k-maxsum-C32", clients=SERVE_CLIENTS,
         rounds=SERVE_ROUNDS, ticks=stats["ticks"], dispatches=dispatches,
         occupancy=occupancy, pad_instances=padded,
         requests_per_s=SERVE_CLIENTS / wall, wall_seconds=wall,
         client_latency_p50_s=lat_sorted[len(lat) // 2],
         client_latency_p99_s=lat_sorted[min(len(lat) - 1,
                                             round(0.99 * (len(lat) - 1)))],
         phases_median_s=phases, launches=launches,
         sequential_solve_compiled_seconds=seq_wall,
         sequential_compile_seconds=compile_s,
         cache_entry_bytes=entry_bytes,
         full_cache_bytes=256 * entry_bytes,
         solo_equal=True, card_equals_cpu_subset=len(cpu),
         cpu_subset_seconds=cpu_s, seconds=time.perf_counter() - t_cell,
         trace_summary=head, best_costs=sorted(r["cost"] for r in got)[:4])
    return got, launches


def sensor_values(k, n_sensors):
    """Follow-up k's set_values: 50 sensors, a window moving by 50."""
    lo = (50 * (k - 1)) % n_sensors
    return {f"s{(lo + j) % n_sensors}": 1 + (k % 2) for j in range(50)}


def maxsum_session(torch, svc_dev, dcop, n_sensors):
    """One Max-Sum session (segment 1, then 4 follow-ups) through a
    service on ``svc_dev``; returns the results and the counters."""
    from pydcop_tpu_torch import telemetry
    from pydcop_tpu_torch.engine.service import SolverService

    with telemetry.session() as tel:
        with SolverService(pad_policy="pow2", max_batch=1, max_wait=0.0,
                           device=svc_dev) as svc:
            outs = [serve_solve(svc, dcop, "maxsum", SERVE_PARAMS,
                                rounds=SESSION_ROUNDS,
                                chunk_size=SERVE_CHUNK, session="plant")]
            for k in range(1, 5):
                outs.append(serve_solve(
                    svc, None, "maxsum", SERVE_PARAMS, rounds=SESSION_ROUNDS,
                    chunk_size=SERVE_CHUNK, session="plant",
                    set_values=sensor_values(k, n_sensors)))
        counters = service_counters(tel)
    return outs, counters


def delta_tree_dcop(n_hubs, n_leaves, seed):
    """``tools/recompile_guard.py:_build_delta_tree`` with the port's
    model objects: a chain of ``n_hubs`` binary hubs, each with
    ``n_leaves`` leaves, random 2x2 tables, and one external ``e0``
    driving a tracking constraint on the last leaf."""
    import random

    import numpy as np

    from pydcop_tpu_torch.dcop import (
        DCOP,
        AgentDef,
        Domain,
        ExternalVariable,
        NAryMatrixRelation,
        Variable,
    )

    rnd = random.Random(seed)
    dcop = DCOP(f"delta_tree_{n_hubs}x{n_leaves}_{seed}")
    dom = Domain("b", "", [0, 1])
    ext = ExternalVariable("e0", dom, value=0)
    dcop.add_variable(ext)

    def m22():
        return np.array([[rnd.uniform(0.0, 1.0) for _ in range(2)]
                         for _ in range(2)])

    prev = track = None
    for h in range(n_hubs):
        hv = Variable(f"h{h}", dom)
        dcop.add_variable(hv)
        if prev is not None:
            dcop.add_constraint(
                NAryMatrixRelation([prev, hv], m22(), name=f"ch{h}"))
        for leaf in range(n_leaves):
            lv = Variable(f"x{h}_{leaf}", dom)
            dcop.add_variable(lv)
            dcop.add_constraint(
                NAryMatrixRelation([hv, lv], m22(), name=f"c{h}_{leaf}"))
            track = lv
        prev = hv
    dcop.add_constraint(NAryMatrixRelation([track, ext], m22(),
                                           name="track"))
    dcop.add_agents([AgentDef("a0")])
    return dcop


def dpop_session(torch, svc_dev, dcop, memo_bytes):
    """The exact session through a service: segment 1 and DELTA_STEPS
    one-delta follow-ups toggling ``e0``.  Returns the results, the
    per-delta milliseconds and the counters of each segment."""
    from pydcop_tpu_torch import telemetry
    from pydcop_tpu_torch.engine.service import SolverService

    params = {"util_device": "always"}
    outs, ms, counters = [], [], []
    with SolverService(pad_policy="pow2", max_batch=1, max_wait=0.0,
                       session_memo_bytes=memo_bytes,
                       device=svc_dev) as svc:
        for k in range(DELTA_STEPS + 1):
            with telemetry.session() as tel:
                t0 = time.perf_counter()
                outs.append(serve_solve(
                    svc, dcop if k == 0 else None, "dpop", params,
                    session="tree",
                    set_values=None if k == 0 else {"e0": k % 2}))
                ms.append(1e3 * (time.perf_counter() - t0))
            counters.append(service_counters(tel))
    return outs, ms, counters


def serve_sessions(torch, mk, dev):
    """16b (see the module docstring).  Returns the launches of its card
    Max-Sum session."""
    import copy

    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.engine.memo import InferSession

    cpu = torch.device("cpu")
    # 1. the Max-Sum session on phase 14's sensor coloring
    t_cell = t0 = time.perf_counter()
    dcop, _cap = sensor_coloring_dcop(**DYN_SIZE)
    build_s = time.perf_counter() - t0
    n_sensors = DYN_SIZE["n_sensors"]
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    card, card_c = maxsum_session(torch, dev, dcop, n_sensors)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = dict(mk.launches)
    if (card_c.get("compile.full"), card_c.get("compile.incremental")) != (
            1, 4):
        raise AssertionError(f"16b: compile counters {card_c}")
    if [r["segment"] for r in card] != [1, 2, 3, 4, 5]:
        raise AssertionError("16b: session segments out of order")
    want = 5 * SESSION_ROUNDS
    if (launches["factor_round_binary"], launches["q_update"],
            launches["factor_round_binary_shared"]) != (want, want, 0):
        raise AssertionError(f"16b: launches {launches}")
    t0 = time.perf_counter()
    fresh = copy.deepcopy(dcop)
    for k, r in enumerate(card):
        if k:
            for name, v in sensor_values(k, n_sensors).items():
                fresh.external_variables[name].value = v
        f = solve(fresh, "maxsum", SERVE_PARAMS, rounds=SESSION_ROUNDS,
                  chunk_size=SERVE_CHUNK, pad_policy="pow2", device=dev)
        f.pop("telemetry")
        if serve_strip(r) != {**serve_strip(f), "session": "plant",
                              "segment": k + 1}:
            raise AssertionError(f"16b: segment {k + 1} differs from a "
                                 f"fresh solve")
    fresh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_r, cpu_c = maxsum_session(torch, cpu, dcop, n_sensors)
    cpu_s = time.perf_counter() - t0
    if [serve_strip(r) for r in cpu_r] != [serve_strip(r) for r in card]:
        raise AssertionError("16b: the session differs card and CPU")
    if cpu_c != card_c:
        raise AssertionError(f"16b: counters differ: {card_c} {cpu_c}")
    emit("16b", "serve-sessions-maxsum-sensors10k", segments=5,
         rounds=SESSION_ROUNDS, build_seconds=build_s,
         card_seconds=card_s, cpu_seconds=cpu_s, fresh_seconds=fresh_s,
         seconds=time.perf_counter() - t_cell, compile={
             k: v for k, v in card_c.items() if k.startswith("compile.")},
         launches=launches, fresh_equal=True, card_equals_cpu=True,
         costs=[r["cost"] for r in card])

    # 2. the exact DPOP session on the delta tree, memo on and off
    t_cell = time.perf_counter()
    tree = delta_tree_dcop(*DELTA_TREE)
    nodes = len(tree.variables)
    on, on_ms, on_c = dpop_session(torch, dev, tree, 64 << 20)
    off, off_ms, _ = dpop_session(torch, dev, tree, 0)
    cpu_on, cpu_ms, cpu_c = dpop_session(torch, cpu, tree, 64 << 20)
    for k, (a, b, c) in enumerate(zip(on, off, cpu_on)):
        if (a["assignment"], a["cost"]) != (b["assignment"], b["cost"]):
            raise AssertionError(f"16b: delta {k}: memo on != memo off")
        if serve_strip(a) != serve_strip(c):
            raise AssertionError(f"16b: delta {k}: card != CPU")
    if on_c != cpu_c:
        raise AssertionError("16b: DPOP session counters card != CPU")
    recon = [c.get("engine.memo_recontractions", 0) for c in on_c[1:]]
    if max(recon) > INCR_MAX_FRACTION * nodes or min(
            c.get("engine.memo_hits", 0) for c in on_c[1:]) < 1:
        raise AssertionError(f"16b: re-contractions {recon} of {nodes}")
    emit("16b", "serve-sessions-dpop-delta-tree", nodes=nodes,
         deltas=DELTA_STEPS, memo_recontractions=recon,
         memo_hits=[c.get("engine.memo_hits", 0) for c in on_c[1:]],
         card_memo_ms=on_ms, card_memo_off_ms=off_ms, cpu_memo_ms=cpu_ms,
         util_dispatches=[r["util_dispatches"] for r in on],
         memo_equals_off=True, card_equals_cpu=True,
         seconds=time.perf_counter() - t_cell)

    # 3. InferSession (log_z, map) on the tree against fresh sessions
    t_cell = time.perf_counter()
    rows = {}
    for query in ("log_z", "map"):
        s = InferSession(tree, query, device="always", pad_policy="pow2",
                         torch_device=dev)
        ms = []
        for k in range(3):
            t0 = time.perf_counter()
            s.set_values({"e0": k % 2})
            r = s.solve()
            ms.append(1e3 * (time.perf_counter() - t0))
            f = InferSession(tree, query, device="always",
                             pad_policy="pow2", torch_device=dev)
            f.set_values({"e0": k % 2})
            w = f.solve()
            if query == "map":
                if (r["assignment"], r["cost"]) != (w["assignment"],
                                                    w["cost"]):
                    raise AssertionError(f"16b: infer map delta {k}")
            elif abs(r["log_z"] - w["log_z"]) > (
                    r["error_bound"] + w["error_bound"] + 1e-9):
                raise AssertionError(f"16b: infer log_z delta {k}: "
                                     f"{r['log_z']} {w['log_z']}")
        rows[query] = dict(ms=ms, memo=r["memo"])
    emit("16b", "serve-sessions-infer-delta-tree", nodes=nodes, **rows,
         seconds=time.perf_counter() - t_cell)
    return launches


def sensor_json(n_vars, n_sensors):
    """A sensor coloring as JSON text (a subset of YAML: ``load_dcop``
    reads it through PyYAML): phase 9's coloring edges as intention
    constraints and ``n_sensors`` tracked external sensors."""
    base = coloring_dcop(n_vars, colors=3, degree=3, seed=1)
    doc = {
        "name": f"sensor_coloring_{n_vars}", "objective": "min",
        "domains": {"colors": {"values": [0, 1, 2]}},
        "variables": {v: {"domain": "colors"} for v in base.variables},
        "external_variables": {
            f"s{k}": {"domain": "colors", "initial_value": 0}
            for k in range(n_sensors)},
        "constraints": {},
        "agents": ["a0"],
    }
    for c in base.constraints.values():
        a, b = c.scope_names
        doc["constraints"][c.name] = {
            "type": "intention", "function": f"1 if {a} == {b} else 0"}
    step = n_vars // n_sensors
    for k in range(n_sensors):
        doc["constraints"][f"track_{k}"] = {
            "type": "intention",
            "function": f"0 if v{k * step} == s{k} else 1"}
    # indented: the service reads a string with a newline as text
    return json.dumps(doc, indent=1)


def serve_recovery(torch, mk, dev, base, c32):
    """16c (see the module docstring).  Returns the launches of its card
    runs: the one-instance runs' and the chaos tick's."""
    import threading

    from pydcop_tpu_torch import telemetry
    from pydcop_tpu_torch.engine.service import SolverService
    from pydcop_tpu_torch.telemetry import export, flightrec

    single, batched = {}, {}

    def add(into, got):
        for k, v in got.items():
            into[k] = into.get(k, 0) + v

    # checkpoint on close(), replay under resume=True, against an
    # undisturbed service that saw the same segments
    t_cell = time.perf_counter()
    text = sensor_json(RECOVERY_VARS, 20)
    ck = str(Path(base) / "sessions.json")
    kw = dict(rounds=SESSION_ROUNDS, chunk_size=SERVE_CHUNK,
              session="plant")
    deltas = [{"s1": 2}, {"s2": 1, "s3": 2}]
    mk.reset_launches()
    undisturbed = SolverService(max_batch=1, max_wait=0.0, device=dev)
    try:
        with SolverService(max_batch=1, max_wait=0.0,
                           session_checkpoint=ck, device=dev) as svc:
            for sv in [None] + deltas:
                for s in (svc, undisturbed):
                    serve_solve(s, None if sv else text, "maxsum",
                                SERVE_PARAMS, set_values=sv, **kw)
        want = serve_solve(undisturbed, None, "maxsum", SERVE_PARAMS,
                           set_values={"s4": 1}, **kw)
    finally:
        undisturbed.close()
    entry = json.load(open(ck))["sessions"]
    if [e["name"] for e in entry] != ["plant"] or entry[0]["deltas"] != (
            deltas):
        raise AssertionError(f"16c: checkpoint {entry}")
    with telemetry.session() as tel:
        r = SolverService(max_batch=1, max_wait=0.0, session_checkpoint=ck,
                          resume=True, device=dev)
        try:
            replay = service_counters(tel)
            got = serve_solve(r, None, "maxsum", SERVE_PARAMS,
                              set_values={"s4": 1}, **kw)
        finally:
            r.close()
        after = service_counters(tel)
    add(single, mk.launches)
    follow = {k: after.get(k, 0) - replay.get(k, 0)
              for k in ("compile.full", "compile.incremental")}
    if (replay.get("compile.full"), replay.get("compile.incremental")) != (
            1, len(deltas)) or follow != {"compile.full": 0,
                                          "compile.incremental": 1}:
        raise AssertionError(f"16c: replay {replay}, follow-up {follow}")
    if serve_strip(got) != serve_strip(want) or got["segment"] != 4:
        raise AssertionError("16c: the resumed follow-up differs from the "
                             "undisturbed service's")
    emit("16c", "serve-recovery-resume", sessions_restored=1,
         replay_compiles={k: v for k, v in replay.items()
                          if k.startswith("compile.")},
         follow_up_compiles=follow, segment=got["segment"],
         equals_undisturbed=True, seconds=time.perf_counter() - t_cell)

    # nan_inject on a tick of 8 (the first DCOP, seeds 0-7: one group):
    # the named request quarantined, its batchmates equal to 16a's
    # fault-free results (16a's request 4j); the flight dump
    t_cell = time.perf_counter()
    dump = str(Path(base) / "flight.json")
    dcops = c32["dcops"]
    mk.reset_launches()
    with telemetry.session():
        with SolverService(pad_policy="pow2", max_batch=8, max_wait=5.0,
                           chaos="nan_inject=1:3", chaos_seed=0,
                           flight_dump=dump, device=dev) as svc:
            pend = [svc.submit(dcops[0], "maxsum", SERVE_PARAMS,
                               rounds=SERVE_ROUNDS, chunk_size=SERVE_CHUNK,
                               seed=j) for j in range(8)]
            res = [p.result(SERVE_WAIT) for p in pend]
            doc = flightrec.load_dump(dump)
    add(batched, mk.launches)
    bad = [j for j, x in enumerate(res) if x["status"] == "degraded"]
    if len(bad) != 1:
        raise AssertionError(f"16c: degraded {bad}")
    for j, x in enumerate(res):
        if j not in bad and serve_strip(x) != serve_strip(
                c32["got"][len(dcops) * j]):
            raise AssertionError(f"16c: batchmate {j} differs from the "
                                 f"fault-free run")
    if doc["trigger"] != "quarantine" or doc["trace_id"] != res[bad[0]][
            "trace"]:
        raise AssertionError(f"16c: flight dump {doc['trigger']} "
                             f"{doc['trace_id']}")

    # the exporter: one scrape, then /healthz during a drain
    mk.reset_launches()
    with telemetry.session() as tel:
        svc = SolverService(max_batch=1, max_wait=0.0, device=dev)
        ex = export.MetricsExporter(tel.metrics.snapshot, svc.health)
        try:
            serve_solve(svc, dcops[0], "maxsum", SERVE_PARAMS, rounds=16)
            addr = "http://%s:%d" % ex.address
            scraped = export.parse_prometheus_text(
                export.http_get(addr + "/metrics"))
            if scraped["pydcop_service_requests_total"] != (
                    tel.metrics.snapshot()["counters"]["service.requests"]):
                raise AssertionError("16c: scraped requests differ")
            long = svc.submit(dcops[1], "maxsum", SERVE_PARAMS,
                              rounds=4 * SERVE_ROUNDS)
            closer = threading.Thread(target=svc.close, daemon=True)
            seen = set()
            closer.start()
            deadline = time.perf_counter() + SERVE_WAIT
            while closer.is_alive() and time.perf_counter() < deadline:
                seen.add(json.loads(export.http_get(
                    addr + "/healthz"))["status"])
                time.sleep(0.005)
            closer.join(SERVE_WAIT)
            long.result(SERVE_WAIT)
            seen.add(json.loads(export.http_get(addr + "/healthz"))[
                "status"])
        finally:
            svc.close()
            ex.close()
    add(single, mk.launches)
    if "draining" not in seen or "drained" not in seen:
        raise AssertionError(f"16c: /healthz read {sorted(seen)}")
    emit("16c", "serve-recovery-chaos-exporter", quarantined=bad,
         batchmates_equal=True, flight_trigger=doc["trigger"],
         flight_trace=doc["trace_id"], flight_records=len(doc["records"]),
         scraped_requests=scraped["pydcop_service_requests_total"],
         healthz=sorted(seen), seconds=time.perf_counter() - t_cell)
    return single, batched


def serve_wire(torch, dev, dcops):
    """16d (see the module docstring)."""
    import socket

    from pydcop_tpu_torch.engine.service import (
        ServiceClient,
        ServiceServer,
        SolverService,
    )

    t_cell = time.perf_counter()
    with SolverService(max_batch=1, max_wait=0.0, device=dev) as svc:
        server = ServiceServer(svc)
        try:
            with ServiceClient(server.address, timeout=60) as c:
                if not c.ping():
                    raise AssertionError("16d: ping")
                stats = c.stats()
                closed = c.close_session("nope")
                text = sensor_json(200, 4)
                r = c.solve(text, "maxsum", SERVE_PARAMS, rounds=32)
                if r["status"] != "finished":
                    raise AssertionError(f"16d: wire solve {r['status']}")
                with socket.create_connection(server.address,
                                              timeout=60) as s:
                    rd = s.makefile("rb")
                    s.sendall(b"{not json\n")
                    err = json.loads(rd.readline())
                    s.sendall(b'{"op": "ping", "id": 1}\n')
                    alive = json.loads(rd.readline())
                if not err.get("frame_rejected") or not alive.get("pong"):
                    raise AssertionError(f"16d: {err} {alive}")
                t0 = time.perf_counter()
                c.shutdown()
            if not server.wait(30):
                raise AssertionError("16d: shutdown did not stop the "
                                     "server within 30 s")
            shut_s = time.perf_counter() - t0
        finally:
            server.close()
    emit("16d", "serve-wire", seconds=time.perf_counter() - t_cell,
         ping=True, stats_keys=len(stats),
         close_session=closed, json_solve_cost=r["cost"],
         malformed_error=err["error"], link_survived=True,
         shutdown_seconds=shut_s,
         frames_rejected=svc.stats()["frames_rejected"])


def serve_phase(torch, mk, dev, card):
    """Phase 16 (see the module docstring).  Returns the launches of its
    card runs by kernel entry."""
    import tempfile

    CARD["card"] = card
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dcops = [coloring_dcop(SERVE_VARS, 3, 3, seed=s) for s in SERVE_SEEDS]
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=HERE) as base:
        got, c32_launches = serve_c32(torch, mk, dev, dcops, base)
        session_launches = serve_sessions(torch, mk, dev)
        rec_single, rec_batched = serve_recovery(
            torch, mk, dev, base, {"dcops": dcops, "got": got})
        serve_wire(torch, dev, dcops)
    emit("16", "phase", seconds=time.perf_counter() - t_phase,
         build_seconds=build_s)
    return {
        # group dispatches (16a, 16c's chaos tick): the batched instances
        "factor_round_binary.batched_instances": c32_launches[
            "factor_round_binary"] + rec_batched.get("factor_round_binary",
                                                     0),
        "q_update.batched_instances_pow2": c32_launches["q_update"]
        + rec_batched.get("q_update", 0),
        # sessions and one-request ticks, one instance a run
        **{k: session_launches.get(k, 0) + rec_single.get(k, 0)
           for k in ("factor_round_binary", "q_update")},
    }


# -- phase 17: the host runtimes with compiled islands, and the fleet --------

ISLAND_SIDE = 100  # grid10k: a 100x100 grid, 19,800 binary constraints
ISLAND_ROWS = (49, 51)  # a0: rows [0, 49); a2 (host): [49, 51); a1: the rest
ISLAND_ROUNDS = 10  # 298,000 deliveries (10 x 29,800 computations)
ISLAND_PARAMS = {"damping": 0.5}
CPU_RUN_SLACK = 300.0  # seconds 17a's CPU child may run past the card run
THREAD_TIMEOUT = 5.0  # seconds: the thread runs' wall-clock stop
CHAOS_SPEC = "drop=0.02,dup=0.02,reorder=0.02"
CHAOS_SEED = 7
SIM_KEYS = ("assignment", "cost", "final_cost", "msg_count", "msg_size",
            "cost_trace")
REPLAY_FLUSHES = 4  # 17a's replay: flushes fed by recorded messages
DSA_ROUNDS = 10  # 17c's run: 100,000 deliveries
DSA_TICKS = 8  # 17c's island bursts after the boundary wave
FLEET_SESSIONS = ("plant0", "plant1", "plant2", "plant3")
FLEET_STATELESS = 16
FLEET_FOLLOW_UPS = 4
# seconds after the fleet's head line: the four sessions' first three
# segments (each replica parses, compiles and replicates them) took
# 24.9-33.9 s on the H100 machine's host alone, 38.5 s beside other
# phases
FLEET_KILL_AFTER = 90.0
FLEET_WAIT = 120.0  # seconds: every wait of 17d is bounded


def grid10k_dcop():
    """``generate graph_coloring --graph grid -n 10000 -c 3 --soft
    --noise 0.02 --seed 1``, built in memory with the port's generator."""
    import argparse

    from pydcop_tpu_torch.commands.generators.graphcoloring import generate

    return generate(argparse.Namespace(
        graph="grid", variables_count=ISLAND_SIDE ** 2, colors_count=3,
        soft=True, noise=0.02, seed=1, intentional=False,
        agents_count=None, capacity=100.0, p_edge=0.5, m_edge=2,
    ))


def three_agent_split(dcop, factors=True):
    """The island deployment's locality layout: rows 0-48 on ``a0`` (an
    island), rows 49-50 on ``a2`` (host computations), rows 51-99 on
    ``a1`` (an island); each factor on the agent of its first
    variable."""
    from pydcop_tpu_torch.distribution import Distribution

    lo, hi = ISLAND_ROWS

    def agent(vname):
        row = int(vname[1:]) // ISLAND_SIDE
        return "a0" if row < lo else ("a2" if row < hi else "a1")

    mapping = {"a0": [], "a1": [], "a2": []}
    for v in dcop.variables:
        mapping[agent(v)].append(v)
    if factors:
        for c in dcop.constraints.values():
            mapping[agent(c.dimensions[0].name)].append(c.name)
    return Distribution(mapping)


class _IslandInbox:
    """Every boundary message the Max-Sum islands of one run receive, as
    ``(dest, sender, costs)`` in arrival order, by the islands' agent."""

    def __init__(self, dist):
        from pydcop_tpu_torch.algorithms import _island_maxsum

        cls = self._cls = _island_maxsum.MaxSumIsland
        own = self._own = cls.receive
        got = self.got = {}

        def receive(island, dest, sender, costs):
            agent = dist.agent_for(dest)
            got.setdefault(agent, []).append((dest, sender, dict(costs)))
            own(island, dest, sender, costs)

        cls.receive = receive

    def close(self):
        self._cls.receive = self._own


def _sim_kw(dist):
    return dict(mode="sim", rounds=ISLAND_ROUNDS, seed=1, distribution=dist,
                accel_agents=["a0", "a1"])


def islands_sim_cpu():
    """17a's CPU run, in a child process that :func:`islands_sim` starts
    beside the card run (each run is a core's worth of host Python):
    prints the compared keys and its seconds as one JSON line."""
    from pydcop_tpu_torch.api import solve

    dcop = grid10k_dcop()
    t0 = time.perf_counter()
    r = solve(dcop, "maxsum", ISLAND_PARAMS, device="cpu",
              **_sim_kw(three_agent_split(dcop)))
    print(json.dumps({"seconds": time.perf_counter() - t0,
                      **{k: r[k] for k in SIM_KEYS}}))


def islands_sim(torch, mk, dev, dcop, dist):
    """17a (see the module docstring).  Returns the card run's launches
    and result."""
    import os

    from pydcop_tpu_torch.api import solve

    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.islands_sim_cpu()")
    child = subprocess.Popen(
        [sys.executable, "-c", code, str(HERE)], cwd=HERE,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        mk.reset_launches()
        inbox = _IslandInbox(dist)
        t0 = time.perf_counter()
        try:
            card = solve(dcop, "maxsum", ISLAND_PARAMS, device=dev,
                         **_sim_kw(dist))
        finally:
            inbox.close()
        card_s = time.perf_counter() - t0
        launches = dict(mk.launches)
        out, err = child.communicate(timeout=card_s + CPU_RUN_SLACK)
    finally:
        stop(child)
    if child.returncode != 0:
        raise AssertionError("17a: the CPU run failed:\n" + err[-4000:])
    cpu = json.loads(out.splitlines()[-1])
    cpu_s = cpu.pop("seconds")
    # both sides as JSON carries them (floats round-trip exactly)
    card_keys = json.loads(json.dumps({k: card[k] for k in SIM_KEYS}))
    differ = [k for k in SIM_KEYS if card_keys[k] != cpu[k]]
    if differ:
        raise AssertionError(f"17a: card != CPU in {differ}")
    if launches["factor_round_binary"] == 0 or launches["q_update"] == 0:
        raise AssertionError(f"17a: the islands launched {launches}")
    if len(card["assignment"]) != len(dcop.variables):
        raise AssertionError("17a: incomplete assignment")
    c = card["telemetry"]["counters"]
    emit("17a", "grid10k-islands-sim", rounds=ISLAND_ROUNDS,
         status=card["status"], cost=card["cost"],
         final_cost=card["final_cost"], msg_count=card["msg_count"],
         msg_size=card["msg_size"], flushes=c["island.flushes"],
         boundary_msgs=c["island.boundary_msgs"], seconds=card_s,
         cpu_seconds=cpu_s, msgs_per_s=card["msg_count"] / card_s,
         launches=launches, card_equals_cpu=True)
    island_replay(torch, dev, dcop, dist, inbox.got)
    return launches, card


def _island_state(island):
    return {k: island._state[k].cpu() for k in ("r", "q", "values")}


def island_replay(torch, dev, dcop, dist, got, phase="17a"):
    """17a's replay (see the module docstring): ``got`` is what each
    island received in the card run (19a: in its agent process)."""
    import numpy as np

    from pydcop_tpu_torch.algorithms import (
        AlgorithmDef,
        ComputationDef,
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.graphs import load_graph_module

    t0 = time.perf_counter()
    module = load_algorithm_module("maxsum")
    graph = load_graph_module(module.GRAPH_TYPE).build_computation_graph(
        dcop)
    algo_def = AlgorithmDef(
        "maxsum", prepare_algo_params(ISLAND_PARAMS, module.algo_params),
        dcop.objective)
    fields = {}
    for agent in ("a0", "a1"):
        msgs = got.get(agent, [])
        if len(msgs) < REPLAY_FLUSHES:
            raise AssertionError(f"{phase}: {agent} received {len(msgs)} "
                                 "boundary messages")
        owned = set(dist.computations_hosted(agent))
        defs = [ComputationDef(n, algo_def)
                for n in sorted(graph.nodes, key=lambda n: n.name)
                if n.name in owned]
        runs = []
        for where in (dev, torch.device("cpu")):
            pending = [0]
            proxies = module.build_island(
                defs, dcop, seed=1, pending_fn=lambda: pending[0],
                device=where)
            sent = []
            for p in proxies:
                p.message_sender = (lambda src, dest, msg, *_:
                                    sent.append((src, dest,
                                                 dict(msg.costs))))
                p.start()
            island = proxies[0].island
            states = [_island_state(island)]
            for batch in np.array_split(np.arange(len(msgs)),
                                        REPLAY_FLUSHES):
                for j, i in enumerate(batch):
                    pending[0] = len(batch) - 1 - j  # the last one flushes
                    island.receive(*msgs[i])
                states.append(_island_state(island))
            moved = None
            if island._remote_factors_of:
                # the fold gate: a strong r message on one boundary
                # variable decides its value at the next flush
                v = sorted(island._remote_factors_of)[0]
                slot, labels = island._slot[v], island._labels[v]
                want = (int(island._state["values"][slot]) + 1) % len(labels)
                island.receive(v, island._remote_factors_of[v][0], {
                    lab: 0.0 if k == want else 50.0
                    for k, lab in enumerate(labels)})
                states.append(_island_state(island))
                moved = int(island._state["values"][slot]) == want
            runs.append((island, states, sent, moved))
        (card, card_states, card_sent, moved), (cpu, cpu_states, cpu_sent,
                                                cpu_moved) = runs
        q_pins = sum(d in card.owned_factor_names for d, _, _ in msgs)
        r_folds = sum(d in card.owned_var_names for d, _, _ in msgs)
        if q_pins + r_folds != len(msgs):
            raise AssertionError(f"{phase}: {agent} received messages that "
                                 "are not boundary messages")
        if not torch.equal(card._state["noise"].cpu(),
                           cpu._state["noise"]):
            raise AssertionError(f"{phase}: {agent}'s noise differs")
        flushes = 1 + REPLAY_FLUSHES + (moved is not None)
        if card.flushes != flushes or cpu.flushes != flushes:
            raise AssertionError(f"{phase}: {agent} flushed {card.flushes} / "
                                 f"{cpu.flushes} times, not {flushes}")
        for n, (x, y) in enumerate(zip(card_states, cpu_states)):
            differ = [k for k in x if not torch.equal(x[k], y[k])]
            if differ:
                raise AssertionError(f"{phase}: {agent}'s {differ} differ "
                                     f"card and CPU after flush {n + 1}")
        if card_sent != cpu_sent or not card_sent:
            raise AssertionError(f"{phase}: {agent}'s posted messages differ "
                                 "card and CPU")
        if moved is not None and not (moved and cpu_moved):
            raise AssertionError(f"{phase}: the r fold did not move {agent}'s "
                                 f"value (card {moved}, CPU {cpu_moved})")
        fields[agent] = dict(received=len(msgs), q_pins=q_pins,
                             r_folds=r_folds, flushes=flushes,
                             posted=len(card_sent), fold_moved=moved)
    if not (sum(f["q_pins"] for f in fields.values())
            and sum(f["r_folds"] for f in fields.values())):
        raise AssertionError(f"{phase}: the replay lacks q pins or r folds "
                             f"{fields}")
    emit(phase, "grid10k-island-replay", islands=fields,
         seconds=time.perf_counter() - t0, card_equals_cpu=True)


class _ChaosRecorder:
    """Every ``ChaosCommunicationLayer`` a thread run makes, kept so its
    recorded events can be held against the plan."""

    def __init__(self, faults):
        base = faults.ChaosCommunicationLayer
        made = self.made = []

        class Recording(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        self._faults, self._base = faults, base
        faults.ChaosCommunicationLayer = Recording

    def close(self):
        self._faults.ChaosCommunicationLayer = self._base


def check_chaos_events(layers, plan):
    """Every recorded ``(kind, link, seq)`` is the plan's decision for
    that link and sequence number, and every faulted sequence number a
    layer sent is recorded.  Returns the event count by kind."""
    def kind_of(d):
        for k in ("drop", "dup", "reorder"):
            if getattr(d, k):
                return k
        return "delay" if d.delay else None

    counts = {}
    for layer in layers:
        got = sorted(layer.events, key=lambda e: (e[1], e[2]))
        want = []
        for dest, n in layer._seq.items():
            for seq in range(1, n + 1):
                k = kind_of(plan.decide(layer.src_agent, dest, seq))
                if k is not None:
                    want.append((k, f"{layer.src_agent}>{dest}", seq))
        if got != sorted(want, key=lambda e: (e[1], e[2])):
            raise AssertionError(f"17b: {layer.src_agent}'s events differ "
                                 "from the plan's decisions")
        for k, _, _ in got:
            counts[k] = counts.get(k, 0) + 1
    return counts


def islands_thread(torch, mk, dev, dcop, dist, sim_card):
    """17b (see the module docstring).  Returns the launches."""
    from pydcop_tpu_torch import faults
    from pydcop_tpu_torch.api import solve

    kw = dict(mode="thread", rounds=ISLAND_ROUNDS, seed=1,
              timeout=THREAD_TIMEOUT, distribution=dist,
              accel_agents=["a0", "a1"], device=dev)
    launches = {}
    for label, extra in (("grid10k-islands-thread", {}),
                         ("grid10k-islands-thread-chaos",
                          dict(chaos=CHAOS_SPEC, chaos_seed=CHAOS_SEED))):
        rec = _ChaosRecorder(faults) if extra else None
        mk.reset_launches()
        t0 = time.perf_counter()
        try:
            r = solve(dcop, "maxsum", ISLAND_PARAMS, **kw, **extra)
        finally:
            if rec is not None:
                rec.close()
        secs = time.perf_counter() - t0
        for k, v in mk.launches.items():
            launches[k] = launches.get(k, 0) + v
        a = r["assignment"]
        if len(a) != len(dcop.variables) or any(
                v is None for v in a.values()):
            raise AssertionError(f"17b: {label}: incomplete assignment")
        if r["cost"] != dcop.solution_cost(a):
            raise AssertionError(f"17b: {label}: cost {r['cost']} is not "
                                 "the assignment's")
        fields = {}
        if rec is not None:
            events = check_chaos_events(
                rec.made, faults.FaultPlan.from_spec(CHAOS_SPEC, CHAOS_SEED))
            if not rec.made or events != r["chaos"]["events"]:
                raise AssertionError(f"17b: events {events} "
                                     f"{r['chaos']['events']}")
            fields = dict(chaos=CHAOS_SPEC, chaos_seed=CHAOS_SEED,
                          events=events, layers=len(rec.made),
                          events_equal_plan=True)
        c = r["telemetry"]["counters"]
        emit("17b", label, status=r["status"], cost=r["cost"],
             sim_cost=sim_card["cost"], msg_count=r["msg_count"],
             flushes=c.get("island.flushes", 0), seconds=secs,
             launches=dict(mk.launches), **fields)
    if launches["factor_round_binary"] == 0 or launches["q_update"] == 0:
        raise AssertionError(f"17b: the islands launched {launches}")
    return launches


def _cpu_draws(torch):
    """A ``DsaIsland.draws`` that makes each flush's draws on a CPU
    generator (seeded by the island's stream and flush count) and moves
    them to the island's device: card and CPU islands apply the same
    numbers."""
    def draws(island, problem, n_rounds):
        gen = torch.Generator().manual_seed(
            (island.seed + island.flushes) & ((1 << 63) - 1))
        out = []
        for _ in range(n_rounds):
            # draws() sizes its tensors from the problem and makes them
            # on the generator's device
            drawn = island._module.draws(problem, island._params, gen)
            out.append({k: v.to(problem.device) for k, v in drawn.items()})
        return out

    return draws


def islands_dsa(torch, dev, dcop):
    """17c (see the module docstring)."""
    from pydcop_tpu_torch.algorithms import (
        AlgorithmDef,
        ComputationDef,
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.algorithms._island_dsa import DsaIsland
    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.graphs import load_graph_module

    dist = three_agent_split(dcop, factors=False)
    params = {"variant": "B", "probability": 0.7}
    t0 = time.perf_counter()
    r = solve(dcop, "dsa", params, mode="sim", rounds=DSA_ROUNDS, seed=1,
              distribution=dist, accel_agents=["a0", "a1"], device=dev)
    run_s = time.perf_counter() - t0
    a = r["final_assignment"]
    if len(a) != len(dcop.variables) or any(v is None for v in a.values()):
        raise AssertionError("17c: incomplete assignment")
    if r["final_cost"] != dcop.solution_cost(a):
        raise AssertionError("17c: the final cost is not the assignment's")

    # a0's island on the card and on the CPU, its boundary pinned at the
    # run's final values, then FLUSHES bursts fed the same draws
    module = load_algorithm_module("dsa")
    graph = load_graph_module(module.GRAPH_TYPE).build_computation_graph(
        dcop)
    algo_def = AlgorithmDef(
        "dsa", prepare_algo_params(params, module.algo_params),
        dcop.objective)
    owned = set(dist.computations_hosted("a0"))
    defs = [ComputationDef(n, algo_def) for n in graph.nodes
            if n.name in owned]
    own = DsaIsland.draws
    DsaIsland.draws = _cpu_draws(torch)
    try:
        trails = []
        for where in (dev, torch.device("cpu")):
            proxies = module.build_island(defs, dcop, seed=1, device=where)
            for p in proxies:
                p.message_sender = lambda *args: None
                p.start()
            island = proxies[0].island
            first = island._state["values"].cpu().clone()
            dest = {}  # each remote neighbor once, to one owned variable
            for v, remotes in sorted(island._remote_neighbors_of.items()):
                for u in remotes:
                    dest.setdefault(u, v)
            for u, v in sorted(dest.items()):
                island.receive(v, u, a[u])
            trail = [island._state["values"].cpu().clone()]
            for _ in range(DSA_TICKS):
                island.tick()
                trail.append(island._state["values"].cpu().clone())
            trails.append((island.flushes, first, trail))
    finally:
        DsaIsland.draws = own
    (flushes, first, card), (cpu_flushes, _, cpu) = trails
    if flushes != 1 + DSA_TICKS or cpu_flushes != flushes:
        raise AssertionError(f"17c: flushes {flushes} / {cpu_flushes}")
    if any(not torch.equal(x, y) for x, y in zip(card, cpu)):
        raise AssertionError("17c: the island's apply differs card and CPU")
    if torch.equal(card[-1], first):
        raise AssertionError("17c: the island's bursts moved nothing")
    emit("17c", "grid10k-dsa-islands", rounds=DSA_ROUNDS,
         status=r["status"], cost=r["cost"], final_cost=r["final_cost"],
         msg_count=r["msg_count"],
         run_flushes=r["telemetry"]["counters"].get("island.flushes", 0),
         seconds=run_s, island_flushes=flushes,
         island_vars=len(owned),
         moved=int((card[-1] != first).sum()),
         apply_card_equals_cpu=True)


def _read_line(proc, timeout):
    """The process's next stdout line, or "" after ``timeout`` s."""
    import queue
    import threading

    box = queue.Queue()
    threading.Thread(target=lambda: box.put(proc.stdout.readline()),
                     daemon=True).start()
    try:
        return box.get(timeout=timeout)
    except queue.Empty:
        return ""


def _wire(x):
    """An in-process service result as the wire carries it (the JSON
    round trip, without the keys the wire drops:
    ``engine/service.py:_WIRE_DROP``), less the service-only keys."""
    from pydcop_tpu_torch.engine.service import _WIRE_DROP

    return serve_strip(json.loads(json.dumps(
        {k: v for k, v in x.items() if k not in _WIRE_DROP}, default=str)))


def serving_fleet(torch, mk, dev):
    """17d (see the module docstring).  Returns the reference service's
    launches (the fleet's replicas are processes of their own)."""
    import os
    import socket
    import threading

    from pydcop_tpu_torch.engine.fleet import HashRing
    from pydcop_tpu_torch.engine.service import ServiceClient, SolverService
    from pydcop_tpu_torch.telemetry import export

    text = sensor_json(RECOVERY_VARS, 20)
    owners = {s: HashRing(["r0", "r1"]).lookup(f"s:{s}")
              for s in FLEET_SESSIONS}
    first = FLEET_SESSIONS[0]
    victim = owners[first]
    standby = "r1" if victim == "r0" else "r0"
    seg_kw = dict(rounds=SESSION_ROUNDS, chunk_size=SERVE_CHUNK)
    deltas = [{f"s{j + 1}": (j + 1) % 3, f"s{j + 5}": 2}
              for j in range(FLEET_FOLLOW_UPS)]
    lat = []
    got = {"stateless": [None] * FLEET_STATELESS,
           "sessions": {s: [] for s in FLEET_SESSIONS}}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pydcop_tpu_torch", "fleet",
         "--replicas", "2", "--device", dev.type, "--port", "0",
         "--metrics_port", "0", "--max_batch", "8", "--max_wait", "0.05",
         "--health_interval", "0.1",
         "--chaos", f"replica_kill={FLEET_KILL_AFTER}:{victim[1:]}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(HERE), env={**os.environ, "PYTHONPATH": str(HERE)},
    )
    try:
        line = _read_line(proc, FLEET_WAIT)
        if not line:
            raise AssertionError("17d: the fleet printed no head line")
        head = json.loads(line)
        kill_at = time.monotonic() + FLEET_KILL_AFTER
        addr = head["fleet"]

        def client(a=None):
            return ServiceClient(a or addr, timeout=FLEET_WAIT,
                                 retry_window=FLEET_WAIT)

        def timed(fn, *a, **k):
            t0 = time.perf_counter()
            r = fn(*a, **k)
            lat.append(time.perf_counter() - t0)
            return r

        def session(name, upto):
            with client() as c:
                for j in range(len(got["sessions"][name]), upto):
                    got["sessions"][name].append(timed(
                        c.solve, None if j else text, "maxsum",
                        SERVE_PARAMS, session=name,
                        set_values=deltas[j - 1] if j else None, **seg_kw))

        def stateless(i):
            with client() as c:
                got["stateless"][i] = timed(
                    c.solve, text, "maxsum", SERVE_PARAMS, seed=i, **seg_kw)

        def run_all(target, args):
            threads = [threading.Thread(target=target, args=a) for a in args]
            for th in threads:
                th.start()
            for th in threads:
                th.join(FLEET_WAIT)
            if any(th.is_alive() for th in threads):
                raise AssertionError("17d: a client did not finish")

        def raw(address, frame):
            host, _, port = address.rpartition(":")
            with socket.create_connection((host, int(port)),
                                          timeout=FLEET_WAIT) as s:
                s.sendall((json.dumps(frame) + "\n").encode())
                return json.loads(s.makefile("rb").readline())

        def std_counters():
            with client(std_addr) as c:
                requests = c.stats()["requests"]
            doc = export.parse_prometheus_text(export.http_get(
                f"http://{std_metrics}/metrics", timeout=10))
            return requests, {k: doc.get(f"pydcop_compile_{k}_total", 0)
                              for k in ("full", "incremental")}

        def healthz():
            return json.loads(export.http_get(
                f"http://{head['metrics']}/healthz", timeout=10))

        # before the kill: each session's first segment and two
        # follow-ups; the victim's second follow-up (its segment 3) goes
        # as a raw frame with a known idempotency key
        t0 = time.perf_counter()
        run_all(session, [(s, 2 if s == first else 3)
                          for s in FLEET_SESSIONS])
        frame = {"op": "solve", "id": 1, "cid": "smoke",
                 "ikey": "smoke:fleet:retry", "algo": "maxsum",
                 "params": SERVE_PARAMS, "session": first,
                 "set_values": deltas[1], **seg_kw}
        t1 = time.perf_counter()
        reply = raw(addr, frame)
        lat.append(time.perf_counter() - t1)
        if not reply.get("ok"):
            raise AssertionError(f"17d: {reply}")
        got["sessions"][first].append(reply["result"])
        before_kill_s = time.perf_counter() - t0
        seg_s = [round(x, 3) for x in lat]
        if time.monotonic() > kill_at - 0.5:
            raise AssertionError(f"17d: the sessions took {before_kill_s} "
                                 f"s, past the kill (segments {seg_s})")
        std_addr = head["replicas"][standby]
        std_metrics = healthz()["replicas"][standby]["metrics"]
        req0, comp0 = std_counters()

        # the kill, then at once the victim's session's next follow-up
        time.sleep(max(0.0, kill_at - time.monotonic()) + 0.05)
        sent_after_kill = time.monotonic() - kill_at
        session(first, 4)
        failover_s = time.monotonic() - kill_at
        # the answered raw frame again, straight to the standby: its
        # replicated reply cache answers, no solve admitted
        again = raw(std_addr, frame)
        if {k: v for k, v in again.items() if k != "id"} != {
                k: v for k, v in reply.items() if k != "id"}:
            raise AssertionError("17d: the retry was not the replicated "
                                 "reply")
        run_all(session, [(s, 1 + FLEET_FOLLOW_UPS) for s in FLEET_SESSIONS])
        req1, comp1 = std_counters()
        # every session's last two segments ran on the standby, one
        # incremental compile each; the retry was admitted nowhere
        after_kill = 2 * len(FLEET_SESSIONS)
        if comp1["full"] != comp0["full"] or (
                comp1["incremental"] - comp0["incremental"] < after_kill):
            raise AssertionError(f"17d: standby compiles {comp0} -> "
                                 f"{comp1}")
        if req1 - req0 != after_kill:
            raise AssertionError(f"17d: standby admitted {req1 - req0}")

        # 16 stateless solves on the surviving replica: one, then 15
        # at once (the first puts the text in its compiled cache)
        t2 = time.perf_counter()
        stateless(0)
        run_all(stateless, [(i,) for i in range(1, FLEET_STATELESS)])
        stateless_s = time.perf_counter() - t2
        health = healthz()
        if health["replicas"][victim]["alive"] is not False:
            raise AssertionError(f"17d: /healthz {health['replicas']}")
        with client(std_addr) as c:
            std_stats = c.stats()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    lost = [i for i, r in enumerate(got["stateless"]) if r is None]
    for name, segs in got["sessions"].items():
        if [r["segment"] for r in segs] != list(
                range(1, 2 + FLEET_FOLLOW_UPS)):
            lost.append(name)
    if lost:
        raise AssertionError(f"17d: lost {lost}")

    # the same requests on one undisturbed in-process service on the card
    mk.reset_launches()
    with SolverService(pad_policy="pow2", max_batch=1, max_wait=0.0,
                       device=dev) as ref:
        for name, segs in got["sessions"].items():
            for j, r in enumerate(segs):
                want = serve_solve(ref, None if j else text, "maxsum",
                                   SERVE_PARAMS, session=name,
                                   set_values=deltas[j - 1] if j else None,
                                   **seg_kw)
                if _wire(want) != serve_strip(r):
                    raise AssertionError(f"17d: session {name} segment "
                                         f"{j + 1} differs")
        for i in range(FLEET_STATELESS):
            want = serve_solve(ref, text, "maxsum", SERVE_PARAMS, seed=i,
                               **seg_kw)
            if _wire(want) != serve_strip(got["stateless"][i]):
                raise AssertionError(f"17d: stateless request {i} differs")
    launches = dict(mk.launches)
    lat_s = sorted(lat)
    emit("17d", "fleet-sensors2k-R2", replicas=2, victim=victim,
         moved_sessions=[s for s in FLEET_SESSIONS if owners[s] == victim],
         requests=len(lat), lost=0,
         stateless_requests_per_s=FLEET_STATELESS / stateless_s,
         p50_s=lat_s[len(lat_s) // 2],
         p99_s=lat_s[min(len(lat_s) - 1, int(0.99 * len(lat_s)))],
         before_kill_seconds=before_kill_s,
         sent_after_kill_s=sent_after_kill, failover_seconds=failover_s,
         standby_compiles={k: comp1[k] - comp0[k] for k in comp0},
         standby_admitted_after_kill=req1 - req0,
         segments_before_kill_s=seg_s,
         standby_stats={k: std_stats.get(k) for k in (
             "replica_updates", "replicated_segments",
             "replication_errors", "sessions_promoted", "replayed_replies")},
         replicated_reply_replay=True, victim_dead=True,
         equals_undisturbed=True)
    return launches


def host_runtime_phase(torch, mk, dev, card):
    """Phase 17 (see the module docstring).  Returns the launches of its
    card runs by kernel entry (every run launches one instance)."""
    CARD["card"] = card
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dcop = grid10k_dcop()
    dist = three_agent_split(dcop)
    build_s = time.perf_counter() - t0
    side = ISLAND_SIDE
    if (len(dcop.variables), len(dcop.constraints)) != (
            side * side, 2 * side * (side - 1)):
        raise AssertionError("17: unexpected grid10k size")
    total = {}

    def add(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    launches, sim_card = islands_sim(torch, mk, dev, dcop, dist)
    add(launches)
    add(islands_thread(torch, mk, dev, dcop, dist, sim_card))
    islands_dsa(torch, dev, dcop)
    add(serving_fleet(torch, mk, dev))
    emit("17", "phase", seconds=time.perf_counter() - t_phase,
         build_seconds=build_s)
    return {k: total.get(k, 0) for k in ("factor_round_binary", "q_update")}


# -- phase 18: every algorithm on the host runtimes; the lockstep islands ---

LOCKSTEP = (("mgm", {}), ("dba", {}), ("gdba", {"increase_mode": "E"}))
LOCKSTEP_ROUNDS = 9  # 18a: 90,000 deliveries on grid10k (~42 cycles)
GRID30_SIDE = 30  # 18b: a 30x30 grid cut as grid10k is
GRID30_ROWS = (14, 16)  # a0: rows [0, 14); a2 (host): [14, 16); a1: the rest
# 18b's budgets in rounds of 900 deliveries: the mixed run covers ~45
# cycles with it, the all-host run ~25 (~7,000 deliveries a cycle)
GRID30_ROUNDS = {"mixed": 30, "host": 200}
MGM2_ROUNDS = 100  # 18c's all-host MGM-2 run on the 30x30 grid
LOCKSTEP_THREAD_TIMEOUT = 5.0  # seconds: 18c's thread run's stop


def grid30_dcop():
    """``generate graph_coloring --graph grid -n 900 -c 3 --soft --noise
    0.02 --seed 1``, built in memory with the port's generator."""
    import argparse

    from pydcop_tpu_torch.commands.generators.graphcoloring import generate

    return generate(argparse.Namespace(
        graph="grid", variables_count=GRID30_SIDE ** 2, colors_count=3,
        soft=True, noise=0.02, seed=1, intentional=False,
        agents_count=None, capacity=100.0, p_edge=0.5, m_edge=2,
    ))


def grid30_split(dcop):
    """18b's three-agent split of the 30x30 grid's variables."""
    from pydcop_tpu_torch.distribution import Distribution

    lo, hi = GRID30_ROWS
    mapping = {"a0": [], "a1": [], "a2": []}
    for v in dcop.variables:
        row = int(v[1:]) // GRID30_SIDE
        mapping["a0" if row < lo else ("a2" if row < hi else "a1")].append(v)
    return Distribution(mapping)


class _Stamps:
    """Every value change of one run's variable computations, stamped with
    the lockstep cycle that decided it (the initial value and cycle 0's
    decision both stamp 0), and the computations the run built."""

    def __init__(self):
        from pydcop_tpu_torch.infrastructure import computations, runtime

        self._cls, self._runtime = computations.VariableComputation, runtime
        own_sel = self._own_sel = self._cls.value_selection
        own_build = self._own_build = runtime._build_computations
        log = self.log = {}
        made = self.made = []

        def value_selection(comp, value):
            if value != comp.current_value:
                island = getattr(comp, "island", None)
                cycle = (comp if island is None else island)._cycle
                log.setdefault(comp.name, []).append((cycle, value))
            own_sel(comp, value)

        def build(*args, **kwargs):
            comps, placement = own_build(*args, **kwargs)
            made.extend(comps)
            return comps, placement

        self._cls.value_selection = value_selection
        runtime._build_computations = build

    def close(self):
        self._cls.value_selection = self._own_sel
        self._runtime._build_computations = self._own_build

    def islands(self):
        out = []
        for c in self.made:
            island = getattr(c, "island", None)
            if island is not None and island not in out:
                out.append(island)
        return out

    def cycles(self):
        """``(fewest, most)`` cycles completed by a computation."""
        done = [getattr(c, "island", c)._cycle for c in self.made]
        return min(done), max(done)

    def upto(self, cycles):
        """The stamped changes decided in the first ``cycles`` cycles."""
        return {v: [[c, x] for c, x in h if c < cycles]
                for v, h in sorted(self.log.items())}


def stamped_solve(solve, dcop, algo, params, **kw):
    """``api.solve`` with its value changes stamped: ``(result, stamps,
    seconds)``."""
    stamps = _Stamps()
    t0 = time.perf_counter()
    try:
        r = solve(dcop, algo, params, **kw)
    finally:
        stamps.close()
    return r, stamps, time.perf_counter() - t0


def _digest(log):
    import hashlib

    return hashlib.sha256(json.dumps(log).encode()).hexdigest()


LOCKSTEP_KEYS = ("assignment", "cost", "final_assignment", "final_cost",
                 "msg_count", "msg_size", "cost_trace")


def _grid10k_kw(dist):
    return dict(mode="sim", rounds=LOCKSTEP_ROUNDS, seed=1, distribution=dist,
                accel_agents=["a0", "a1"])


def lockstep_cpu():
    """18a's CPU runs and 18b's all-host runs, in a child process that
    :func:`lockstep_phase` starts beside its card runs: one JSON line."""
    from pydcop_tpu_torch.api import solve

    dcop = grid10k_dcop()
    dist = three_agent_split(dcop, factors=False)
    out = {"18a": {}, "18b": {}}
    for algo, params in LOCKSTEP:
        r, stamps, secs = stamped_solve(solve, dcop, algo, params,
                                        device="cpu", **_grid10k_kw(dist))
        out["18a"][algo] = dict(
            {k: r[k] for k in LOCKSTEP_KEYS}, seconds=secs,
            changes=sum(len(h) for h in stamps.log.values()),
            history=_digest(stamps.upto(1 << 30)), cycles=stamps.cycles())
    g30 = grid30_dcop()
    for algo, params in LOCKSTEP:
        r, stamps, secs = stamped_solve(
            solve, g30, algo, params, device="cpu", mode="sim",
            rounds=GRID30_ROUNDS["host"], seed=1)
        out["18b"][algo] = dict(
            msg_count=r["msg_count"], seconds=secs, cycles=stamps.cycles(),
            log=stamps.upto(1 << 30))
    print(json.dumps(out))


def lockstep_grid10k(dev, dcop, dist):
    """18a's card runs: ``{algo: (result, stamps, seconds)}``."""
    from pydcop_tpu_torch.api import solve

    runs = {}
    for algo, params in LOCKSTEP:
        runs[algo] = stamped_solve(solve, dcop, algo, params, device=dev,
                                   **_grid10k_kw(dist))
    return runs


def check_grid10k(dev, dcop, runs, cpu):
    """18a (see the module docstring): the card runs against the CPU's."""
    for algo, params in LOCKSTEP:
        r, stamps, secs = runs[algo]
        islands = stamps.islands()
        if [i.device.type for i in islands] != [dev.type] * 2:
            raise AssertionError(f"18a {algo}: the islands are not on the "
                                 "card")
        want = cpu[algo]
        got = json.loads(json.dumps({k: r[k] for k in LOCKSTEP_KEYS}))
        differ = [k for k in LOCKSTEP_KEYS if got[k] != want[k]]
        if _digest(stamps.upto(1 << 30)) != want["history"]:
            differ.append("value histories")
        if list(stamps.cycles()) != want["cycles"]:
            differ.append("cycles")
        if differ:
            raise AssertionError(f"18a {algo}: card != CPU in {differ}")
        if len(r["final_assignment"]) != len(dcop.variables):
            raise AssertionError(f"18a {algo}: incomplete assignment")
        c = r["telemetry"]["counters"]
        dispatched = sum(i.flushes for i in islands)
        if c["island.flushes"] != dispatched or not dispatched:
            raise AssertionError(f"18a {algo}: {c['island.flushes']} "
                                 f"flushes counted, {dispatched} dispatched")
        emit("18a", f"grid10k-{algo}-islands-sim", rounds=LOCKSTEP_ROUNDS,
             params=params, status=r["status"], cycles=stamps.cycles(),
             cost=r["cost"], final_cost=r["final_cost"],
             msg_count=r["msg_count"], msg_size=r["msg_size"],
             changes=sum(len(h) for h in stamps.log.values()),
             phase_dispatches=dispatched,
             boundary_msgs=c["island.boundary_msgs"], seconds=secs,
             cpu_seconds=want["seconds"],
             deliveries_per_s=r["msg_count"] / secs, card_equals_cpu=True)


def lockstep_grid30(dev):
    """18b's mixed runs on the card: ``{algo: (result, stamps,
    seconds)}``."""
    from pydcop_tpu_torch.api import solve

    dcop = grid30_dcop()
    if (len(dcop.variables), len(dcop.constraints)) != (900, 1740):
        raise AssertionError("18b: unexpected 30x30 grid size")
    dist = grid30_split(dcop)
    return {algo: stamped_solve(
        solve, dcop, algo, params, device=dev, mode="sim",
        rounds=GRID30_ROUNDS["mixed"], seed=1, distribution=dist,
        accel_agents=["a0", "a1"]) for algo, params in LOCKSTEP}


def check_grid30(dev, runs, host):
    """18b (see the module docstring): the mixed runs against the
    all-host runs, over the cycles both completed."""
    n_vars = GRID30_SIDE ** 2
    for algo, params in LOCKSTEP:
        r, stamps, secs = runs[algo]
        h = host[algo]
        common = min(stamps.cycles()[0], h["cycles"][0])
        mixed_log = stamps.upto(common)
        host_log = {v: [[c, x] for c, x in hist if c < common]
                    for v, hist in h["log"].items()}
        if mixed_log != host_log:
            raise AssertionError(f"18b {algo}: the mixed run's values "
                                 "differ from the all-host run's")
        if len(mixed_log) != n_vars:
            raise AssertionError(f"18b {algo}: incomplete assignment")
        if common < 10:
            raise AssertionError(f"18b {algo}: only {common} cycles in "
                                 "common")
        per_cycle = r["msg_count"] / stamps.cycles()[0]
        host_per_cycle = h["msg_count"] / h["cycles"][0]
        if not per_cycle < host_per_cycle:
            raise AssertionError(f"18b {algo}: the mixed run delivers "
                                 f"{per_cycle} a cycle, the all-host run "
                                 f"{host_per_cycle}")
        if [i.device.type for i in stamps.islands()] != [dev.type] * 2:
            raise AssertionError(f"18b {algo}: the islands are not on the "
                                 "card")
        emit("18b", f"grid30-{algo}-mixed-vs-host", params=params,
             cycles_compared=common, mixed_cycles=stamps.cycles(),
             host_cycles=h["cycles"], mixed_msgs=r["msg_count"],
             host_msgs=h["msg_count"], mixed_msgs_per_cycle=per_cycle,
             host_msgs_per_cycle=host_per_cycle,
             changes=sum(len(x) for x in mixed_log.values()),
             mixed_seconds=secs, host_seconds=h["seconds"],
             mixed_equals_host=True)


def lockstep_thread_and_exact(dev, dcop, dist):
    """18c (see the module docstring)."""
    from argparse import Namespace

    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.commands.generators.secp import generate

    t0 = time.perf_counter()
    r = solve(dcop, "mgm", {}, mode="thread", seed=1,
              timeout=LOCKSTEP_THREAD_TIMEOUT, distribution=dist,
              accel_agents=["a0", "a1"], device=dev)
    secs = time.perf_counter() - t0
    a = r["assignment"]
    if len(a) != len(dcop.variables) or any(v is None for v in a.values()):
        raise AssertionError("18c: the thread run's assignment is "
                             "incomplete")
    if r["cost"] != dcop.solution_cost(a):
        raise AssertionError("18c: the thread run's cost is not the "
                             "assignment's")
    c = r["telemetry"]["counters"]
    emit("18c", "grid10k-mgm-islands-thread", status=r["status"],
         cost=r["cost"], msg_count=r["msg_count"],
         phase_dispatches=c.get("island.flushes", 0), seconds=secs)

    secp = generate(Namespace(**SYNCBB_SPEC))
    batched = solve(secp, "dpop", device=dev)
    costs = {}
    for algo in ("dpop", "syncbb"):
        t0 = time.perf_counter()
        h = solve(secp, algo, mode="sim", seed=1, device=dev,
                  rounds=100_000)
        if h["status"] != "finished" or h["final_cost"] != batched["cost"]:
            raise AssertionError(f"18c: host {algo} {h['status']} cost "
                                 f"{h['final_cost']} against the batched "
                                 f"DPOP's {batched['cost']}")
        costs[algo] = dict(cost=h["final_cost"], msg_count=h["msg_count"],
                           seconds=time.perf_counter() - t0)
    emit("18c", "syncbb-secp10-host-exact", batched_dpop_cost=batched["cost"],
         host=costs, equal=True)

    g30 = grid30_dcop()
    t0 = time.perf_counter()
    r = solve(g30, "mgm2", {}, mode="sim", rounds=MGM2_ROUNDS, seed=1,
              device=dev)
    secs = time.perf_counter() - t0
    a = r["final_assignment"]
    if len(a) != len(g30.variables) or r["final_cost"] != g30.solution_cost(a):
        raise AssertionError("18c: the MGM-2 run's result is not whole")
    emit("18c", "grid30-mgm2-host-sim", status=r["status"],
         cost=r["cost"], final_cost=r["final_cost"],
         msg_count=r["msg_count"], seconds=secs,
         deliveries_per_s=r["msg_count"] / secs)


def lockstep_phase(torch, dev, card):
    """Phase 18 (see the module docstring).  The CPU runs go on in a
    child process while the card runs go on here."""
    import os

    CARD["card"] = card
    t_phase = time.perf_counter()
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.lockstep_cpu()")
    child = subprocess.Popen(
        [sys.executable, "-c", code, str(HERE)], cwd=HERE,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        dcop = grid10k_dcop()
        dist = three_agent_split(dcop, factors=False)
        grid10k = lockstep_grid10k(dev, dcop, dist)
        grid30 = lockstep_grid30(dev)
        lockstep_thread_and_exact(dev, dcop, dist)
        card_s = time.perf_counter() - t_phase
        out, err = child.communicate(timeout=CPU_RUN_SLACK)
    finally:
        stop(child)
    if child.returncode != 0:
        raise AssertionError("18: the CPU runs failed:\n" + err[-4000:])
    cpu = json.loads(out.splitlines()[-1])
    check_grid10k(dev, dcop, grid10k, cpu["18a"])
    check_grid30(dev, grid30, cpu["18b"])
    emit("18", "phase", seconds=time.perf_counter() - t_phase,
         card_seconds=card_s)


# -- phase 19: process mode over TCP ----------------------------------------

PROC_ROUNDS = 2  # 19a's budget: 59,600 deliveries (2 x 29,800 computations)
# seconds: 19a's run stops here whatever its budget; the deploy alone
# took ~44 s on the card's machine (each agent parses grid10k's YAML)
PROC_TIMEOUT = 120.0
PROC_LOCKSTEP_ROUNDS = 15  # 19b's budget: 13,500 deliveries on the 30x30 grid
KILL_RING = 300  # 19c: the tests' 300-variable DSA ring
KILL_TIMEOUT = 90.0  # seconds 19c's run may take
UI_ROUNDS = 512  # 19d: coloring-10k Max-Sum with the feed, chunk UI_CHUNK
UI_CHUNK = 64
PLUGIN_ROUNDS = 64  # 19e: the plugin on coloring-10k
AGENT_WAIT = 240.0  # seconds: every wait on an agent process of phase 19


def _agent_proc(names, port, dev, workdir=None):
    """``python -m pydcop_tpu_torch agent --runtime host --device
    <dev's type>`` for ``names`` (one OS process each) against the
    orchestrator on ``port``; with ``workdir``, each agent's
    ``--msg_log`` and ``--trace`` go to ``workdir/log.<name>`` and
    ``workdir/trace.<name>``."""
    cmd = [sys.executable, "-m", "pydcop_tpu_torch", "agent", "--names",
           *names, "--runtime", "host", "--orchestrator",
           f"127.0.0.1:{port}", "--device", dev.type]
    if workdir is not None:
        cmd += ["--msg_log", str(workdir / "log"),
                "--trace", str(workdir / "trace")]
    return subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _control_server():
    import socket

    server = socket.create_server(("127.0.0.1", 0))
    return server, server.getsockname()[1]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _agents_done(label, procs):
    """Waits for the agent processes; any nonzero exit fails ``label``."""
    for proc in procs:
        _, err = proc.communicate(timeout=AGENT_WAIT)
        if proc.returncode != 0:
            raise AssertionError(f"{label}: an agent process exited "
                                 f"{proc.returncode}:\n{err[-4000:]}")


def _trace_counters(path):
    """The counters an agent's ``--trace`` file ends with."""
    counters = {}
    for line in open(path):
        rec = json.loads(line)
        if rec.get("kind") == "metrics":
            counters = rec.get("counters", {})
    return counters


def _island_inbox(path, owned):
    """The Max-Sum messages an agent's ``--msg_log`` delivered to its
    computations ``owned``, as ``(dest, sender, costs)`` in delivery
    order (what 17a's replay feeds an island)."""
    from pydcop_tpu_torch.utils.simple_repr import from_repr

    got = []
    for line in open(path):
        rec = json.loads(line)
        costs = getattr(from_repr(rec["content"]), "costs", None)
        if costs is not None and rec["dest"] in owned:
            got.append((rec["dest"], rec["src"], dict(costs)))
    return got


def process_maxsum(torch, mk, dev, workdir):
    """19a (see the module docstring).  Returns the islands' launches by
    kernel entry, read from the island agents' own telemetry."""
    from pydcop_tpu_torch.infrastructure.hostnet import run_host_orchestrator
    from pydcop_tpu_torch.telemetry import session

    dcop = grid10k_dcop()
    dist = three_agent_split(dcop)
    server, port = _control_server()
    agents = _agent_proc(["a0", "a1", "a2"], port, dev, workdir)
    try:
        t0 = time.perf_counter()
        with session() as tel:
            r = run_host_orchestrator(
                dcop, "maxsum", ISLAND_PARAMS, nb_agents=3, port=port,
                server=server, rounds=PROC_ROUNDS, timeout=PROC_TIMEOUT,
                seed=1, placement=dist.mapping, accel_agents=["a0", "a1"],
                register_timeout=AGENT_WAIT, device=dev,
            )
            phases = tel.summary()["phases"]
        secs = time.perf_counter() - t0
        _agents_done("19a", [agents])
    finally:
        stop(agents)
    n = len(dcop.variables)
    if len(r["assignment"]) != n or len(r["final_assignment"]) != n:
        raise AssertionError("19a: incomplete assignment")
    if (dcop.solution_cost(r["assignment"]) != r["cost"]
            or dcop.solution_cost(r["final_assignment"]) != r["final_cost"]):
        raise AssertionError("19a: the reported cost is not the port's "
                             "cost of the assignment")
    counters = {a: _trace_counters(workdir / f"trace.{a}")
                for a in ("a0", "a1", "a2")}
    launches = dict.fromkeys(mk.launches, 0)
    for a in ("a0", "a1"):
        c = counters[a]
        got = {k: c.get(f"kernel.{k}.launches", 0) for k in launches}
        # (a CPU rehearsal launches no kernel: the plain versions run)
        launched = dev.type != "cuda" or (got["factor_round_binary"]
                                          and got["q_update"])
        if not (c.get("island.flushes") and launched):
            raise AssertionError(f"19a: {a}'s island flushed "
                                 f"{c.get('island.flushes')} times and "
                                 f"launched {got}")
        for k in launches:
            launches[k] += got[k]
    if any(k.startswith("kernel.") for k in counters["a2"]):
        raise AssertionError("19a: the host agent launched kernels")
    deliver_s = phases["deliver-loop"]["total_s"]
    emit("19a", "grid10k-maxsum-process", rounds=PROC_ROUNDS,
         status=r["status"], cost=r["cost"], final_cost=r["final_cost"],
         msg_count=r["msg_count"], msg_size=r["msg_size"],
         seconds=secs, deliver_seconds=deliver_s,
         deliveries_per_s=r["msg_count"] / deliver_s,
         tcp_frames=sum(c.get("hostnet.recv_frames", 0)
                        for c in counters.values()),
         flushes={a: counters[a]["island.flushes"] for a in ("a0", "a1")},
         boundary_msgs={a: counters[a].get("island.boundary_msgs")
                        for a in ("a0", "a1")},
         launches=launches)
    got = {a: _island_inbox(workdir / f"log.{a}",
                            set(dist.computations_hosted(a)))
           for a in ("a0", "a1")}
    island_replay(torch, dev, dcop, dist, got, phase="19a")
    return launches


def stamped_agent(name, orchestrator, device, out_path):
    """19b's agent process: ``run_host_agent`` with every value change of
    its computations stamped with the lockstep cycle that decided it;
    writes ``{"log", "cycles", "devices"}`` as JSON to ``out_path``."""
    from pydcop_tpu_torch.infrastructure import agents
    from pydcop_tpu_torch.infrastructure.hostnet import run_host_agent

    stamps = _Stamps()
    own = agents.Agent.deploy_computation

    def deploy(agent, comp):
        stamps.made.append(comp)
        own(agent, comp)

    agents.Agent.deploy_computation = deploy
    try:
        run_host_agent(name, orchestrator, device=device)
    finally:
        stamps.close()
        agents.Agent.deploy_computation = own
    Path(out_path).write_text(json.dumps({
        "log": stamps.log, "cycles": stamps.cycles()[0],
        "devices": [i.device.type for i in stamps.islands()]}))


def process_lockstep(dev, workdir):
    """19b (see the module docstring)."""
    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.infrastructure.hostnet import run_host_orchestrator

    dcop = grid30_dcop()
    dist = grid30_split(dcop)
    server, port = _control_server()
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.stamped_agent(*sys.argv[2:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(HERE), a, f"127.0.0.1:{port}",
         dev.type, str(workdir / f"stamps.{a}")], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for a in ("a0", "a1", "a2")]
    try:
        t0 = time.perf_counter()
        r = run_host_orchestrator(
            dcop, "mgm", {}, nb_agents=3, port=port, server=server,
            rounds=PROC_LOCKSTEP_ROUNDS, timeout=PROC_TIMEOUT, seed=1,
            placement=dist.mapping, accel_agents=["a0", "a1"],
            register_timeout=AGENT_WAIT, device=dev,
        )
        secs = time.perf_counter() - t0
        _agents_done("19b", procs)
    finally:
        for proc in procs:
            stop(proc)
    runs = [json.loads((workdir / f"stamps.{a}").read_text())
            for a in ("a0", "a1", "a2")]
    if [x["devices"] for x in runs] != [[dev.type], [dev.type], []]:
        raise AssertionError("19b: the islands are not on the card: "
                             f"{[x['devices'] for x in runs]}")
    log = {v: h for x in runs for v, h in x["log"].items()}
    cycles = min(x["cycles"] for x in runs)
    host, stamps, host_s = stamped_solve(
        solve, dcop, "mgm", {}, device="cpu", mode="sim",
        rounds=GRID30_ROUNDS["host"], seed=1)
    common = min(cycles, stamps.cycles()[0])
    process_log = {v: [c for c in h if c[0] < common]
                   for v, h in sorted(log.items())}
    if process_log != stamps.upto(common):
        raise AssertionError("19b: the process run's values differ from "
                             "the all-host sim run's")
    if len(process_log) != len(dcop.variables) or common < 10:
        raise AssertionError(f"19b: {len(process_log)} variables stamped, "
                             f"{common} cycles in common")
    emit("19b", "grid30-mgm-process-vs-host", status=r["status"],
         cycles_compared=common, process_cycles=cycles,
         host_cycles=stamps.cycles(), process_msgs=r["msg_count"],
         host_msgs=host["msg_count"],
         changes=sum(len(h) for h in process_log.values()),
         seconds=secs, host_seconds=host_s, process_equals_host=True)


def _ring_dcop_text(n, agents):
    """The tests' ring: ``n`` variables of 3 colours, cost 1 on equal
    neighbours, and the agents ``agents``."""
    lines = ["name: ring", "objective: min", "domains:",
             "  colors: {values: [0, 1, 2]}", "variables:"]
    lines += [f"  v{i}: {{domain: colors}}" for i in range(n)]
    lines.append("constraints:")
    for i in range(n):
        lines += [f"  c{i}:", "    type: intention",
                  f"    function: 1 if v{i} == v{(i + 1) % n} else 0"]
    lines.append(f"agents: [{', '.join(agents)}]")
    return "\n".join(lines) + "\n"


def process_sigkill(dev):
    """19c (see the module docstring)."""
    import threading
    import urllib.request

    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.infrastructure.hostnet import run_host_orchestrator

    dcop = load_dcop(_ring_dcop_text(KILL_RING, ["a1", "a2", "a3"]))
    server, port = _control_server()
    uiport = _free_port()
    box = {}

    def orchestrate():
        try:
            box["result"] = run_host_orchestrator(
                dcop, "dsa", {"probability": 0.06}, nb_agents=3, port=port,
                server=server, rounds=100_000, timeout=KILL_TIMEOUT, seed=2,
                k_target=1, ui_port=uiport, accel_agents=["a1"],
                register_timeout=AGENT_WAIT, device=dev,
            )
        except Exception as e:  # re-raised below
            box["error"] = e

    t0 = time.perf_counter()
    orch = threading.Thread(target=orchestrate, daemon=True)
    orch.start()
    procs = [_agent_proc([f"a{i}"], port, dev) for i in (1, 2, 3)]
    try:
        deadline = time.monotonic() + AGENT_WAIT
        while "error" not in box and "result" not in box:
            if time.monotonic() > deadline:
                raise AssertionError("19c: the run never produced a "
                                     "first sample")
            try:
                st = json.load(urllib.request.urlopen(
                    f"http://127.0.0.1:{uiport}/state", timeout=2))
                if st.get("cost") is not None:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        if "error" in box or "result" in box:
            raise AssertionError(f"19c: the run ended before the kill: "
                                 f"{box}")
        t_kill = time.perf_counter()
        procs[1].kill()  # SIGKILL a2 mid-solve
        orch.join(AGENT_WAIT)
        if orch.is_alive():
            raise AssertionError("19c: the orchestrator hung after the kill")
        if "error" in box:
            raise box["error"]
        _agents_done("19c", [procs[0], procs[2]])
    finally:
        for proc in procs:
            stop(proc)
    r = box["result"]
    if (r["status"], r["cost"]) != ("finished", 0.0):
        raise AssertionError(f"19c: status {r['status']}, cost {r['cost']}")
    if not r["migrations"] or r["migrations"][0]["dead"] != ["a2"]:
        raise AssertionError(f"19c: migrations {r['migrations']}")
    if set(r["placement"]) != {"a1", "a3"}:
        raise AssertionError(f"19c: placement {sorted(r['placement'])}")
    emit("19c", "ring300-dsa-sigkill", status=r["status"], cost=r["cost"],
         moved=len(r["migrations"][0]["moved"]), msg_count=r["msg_count"],
         seconds=time.perf_counter() - t0,
         after_kill_seconds=time.perf_counter() - t_kill,
         recovered=True)


def ui_feed(dev):
    """19d (see the module docstring)."""
    import threading
    import urllib.request

    from pydcop_tpu_torch.api import solve_compiled
    from pydcop_tpu_torch.infrastructure import ui as ui_mod
    from pydcop_tpu_torch.ops.compile import compile_from_arrays
    from pydcop_tpu_torch.ops.generate import coloring_arrays

    s, t, u = coloring_arrays(10_000, colors=3, degree=3, seed=1)
    problem = compile_from_arrays(s, t, 3, unary=u, device=dev)
    kw = dict(rounds=UI_ROUNDS, chunk_size=UI_CHUNK, seed=1)
    solve_compiled(problem, "maxsum", ISLAND_PARAMS, **kw)  # warm-up
    base = ui_mod.UiServer
    servers = []

    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.log = []
            servers.append(self)

        def publish(self, *a, **k):
            super().publish(*a, **k)
            self.log.append(self._last)

    port = _free_port()
    events, states = [], []

    def client():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                req = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/events", timeout=30)
                break
            except OSError:
                time.sleep(0.005)
        else:
            return
        for raw in req:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[6:]))
                if not states:  # the snapshot, while the run goes on
                    states.append(json.load(urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/state", timeout=10)))

    reader = threading.Thread(target=client, daemon=True)
    reader.start()
    ui_mod.UiServer = Recording
    try:
        fed = solve_compiled(problem, "maxsum", ISLAND_PARAMS, ui_port=port,
                             **kw)
    finally:
        ui_mod.UiServer = base
    plain = solve_compiled(problem, "maxsum", ISLAND_PARAMS, **kw)
    reader.join(30)
    if reader.is_alive() or len(servers) != 1:
        raise AssertionError("19d: the client did not finish")
    log = json.loads(json.dumps(servers[0].log))
    want = list(range(UI_CHUNK, UI_ROUNDS + 1, UI_CHUNK))
    if [e["cycle"] for e in log] != want:
        raise AssertionError(f"19d: published cycles "
                             f"{[e['cycle'] for e in log]}")
    if not events or events != log[-len(events):]:
        raise AssertionError(f"19d: the client's {len(events)} events are "
                             "not the published ones")
    final = events[-1]
    if (final.get("status"), final.get("values")) != (fed["status"],
                                                      fed["assignment"]):
        raise AssertionError("19d: the final event is not the result")
    if not states or states[0].get("cycle") not in want:
        raise AssertionError(f"19d: /state answered {states[:1]}")
    for k in ("assignment", "cost", "cost_trace"):
        if fed[k] != plain[k]:
            raise AssertionError(f"19d: the fed run's {k} differs")
    emit("19d", "coloring10k-maxsum-ui", rounds=UI_ROUNDS, chunk=UI_CHUNK,
         events_published=len(log), events_seen=len(events),
         first_seen_cycle=events[0]["cycle"], state_cycle=states[0]["cycle"],
         engine_seconds_with_feed=fed["time"],
         engine_seconds_without=plain["time"], final_equals_result=True)


def plugin_on_card(dev, workdir):
    """19e (see the module docstring)."""
    import shutil

    from pydcop_tpu_torch.api import solve

    pkg = workdir / "extlab"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    shutil.copy(HERE / "examples" / "greedy_plugin_torch.py",
                pkg / "greedy.py")
    sys.path.insert(0, str(workdir))
    dcop = coloring_dcop(10_000, seed=1)
    t0 = time.perf_counter()
    card = solve(dcop, "extlab.greedy", rounds=PLUGIN_ROUNDS, seed=0,
                 device=dev)
    card_s = time.perf_counter() - t0
    cpu = solve(dcop, "extlab.greedy", rounds=PLUGIN_ROUNDS, seed=0,
                device="cpu")
    keys = ("assignment", "cost", "final_assignment", "final_cost", "cycle",
            "msg_count", "status", "cost_trace")
    got, want = (json.loads(json.dumps({k: x[k] for k in keys}))
                 for x in (card, cpu))
    differ = [k for k in keys if got[k] != want[k]]
    if differ:
        raise AssertionError(f"19e: card != CPU in {differ}")
    emit("19e", "coloring10k-greedy-plugin", rounds=PLUGIN_ROUNDS,
         cost=card["cost"], msg_count=card["msg_count"], seconds=card_s,
         engine_seconds=card["time"], cpu_engine_seconds=cpu["time"],
         card_equals_cpu=True)


def process_phase(torch, mk, dev, card):
    """Phase 19 (see the module docstring).  Returns 19a's launches by
    kernel entry."""
    import tempfile

    CARD["card"] = card
    t_phase = time.perf_counter()
    seconds = {}

    def timed(name, run):
        t0 = time.perf_counter()
        out = run()
        seconds[name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        timed("19d", lambda: ui_feed(dev))
        timed("19e", lambda: plugin_on_card(dev, workdir))
        launches = timed("19a", lambda: process_maxsum(torch, mk, dev,
                                                       workdir))
        timed("19b", lambda: process_lockstep(dev, workdir))
        timed("19c", lambda: process_sigkill(dev))
    emit("19", "phase", seconds=time.perf_counter() - t_phase,
         sub_seconds=seconds)
    return launches


# -- phase 20: sharded runs over a shard mesh --------------------------------

SHARDS = 4  # the shards of phase 20's meshes


def same_states(torch, label, a, b):
    """Every leaf of two state dicts bit-equal (after a move to the
    CPU)."""
    if set(a) != set(b):
        raise AssertionError(f"{label}: state leaves {sorted(a)} {sorted(b)}")
    for k in a:
        if not same_leaf(torch, a[k].cpu(), b[k].cpu()):
            raise AssertionError(f"{label}: the runs differ in {k}")


def same_runs(label, a, b, rel=0.0):
    """Two ``RunResult`` s: equal assignments and statuses, and costs
    equal (``rel`` > 0: within that relative tolerance)."""
    import numpy as np

    if (a.assignment, a.best_assignment, a.cycles, a.messages,
            a.status) != (b.assignment, b.best_assignment, b.cycles,
                          b.messages, b.status):
        raise AssertionError(f"{label}: the runs differ")
    for x, y in ((a.cost_trace, b.cost_trace), ([a.cost], [b.cost]),
                 ([a.best_cost], [b.best_cost])):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if x.shape != y.shape or not np.all(
                np.abs(x - y) <= rel * np.maximum(1.0, np.abs(y))):
            raise AssertionError(f"{label}: costs differ {x[:4]} {y[:4]}")


def sharded_full_width(torch, mk, dev, card, rate, n_vars=1_000_000):
    """20a: coloring-1M compiled with 4 shards, Max-Sum over the card
    mesh against the unmeshed card run of the same problem."""
    import numpy as np

    from pydcop_tpu_torch.algorithms import maxsum, prepare_algo_params
    from pydcop_tpu_torch.engine.batched import run_batched
    from pydcop_tpu_torch.ops.compile import compile_from_arrays
    from pydcop_tpu_torch.ops.generate import coloring_arrays
    from pydcop_tpu_torch.parallel import Mesh

    s5, t5, u5 = coloring_arrays(n_vars, colors=3, degree=3, seed=1)
    t0 = time.perf_counter()
    pc = compile_from_arrays(s5, t5, 3, unary=u5, n_shards=SHARDS,
                             device="cpu")
    compile_s = time.perf_counter() - t0
    per_shard = -(-len(s5) // SHARDS)  # constraints a shard, ghosts included
    if (pc.n_real_edges, pc.n_edges, pc.n_shards) != (
            2 * len(s5), 2 * SHARDS * per_shard, SHARDS):
        raise AssertionError("20a: unexpected sharded coloring size")
    p = pc.to(dev)
    del pc
    params = prepare_algo_params({"damping": 0.5}, maxsum.algo_params)
    mesh = Mesh([dev] * SHARDS)
    for m in (None, mesh):  # warm: 8 rounds each
        run_batched(p, maxsum, params, rounds=8, chunk_size=8, mesh=m)
    rounds = 256
    kw = dict(rounds=rounds, chunk_size=64, cost_every=8)
    runs = {}
    for label, m in (("unmeshed", None), ("meshed", mesh)):
        torch.cuda.synchronize()
        mesh.psums = 0
        mk.reset_launches()
        t0 = time.perf_counter()
        r = run_batched(p, maxsum, params, mesh=m, **kw)
        torch.cuda.synchronize()
        runs[label] = (r, time.perf_counter() - t0, dict(mk.launches),
                       mesh.psums)
    (ru, wall_u, lu, _), (rm, wall_m, lm, psums) = (runs["unmeshed"],
                                                    runs["meshed"])
    same_runs("20a", rm, ru, rel=1e-4)
    samples = len(rm.cost_trace)
    if samples != rounds // 8 or not np.all(np.isfinite(rm.cost_trace)):
        raise AssertionError(f"20a: bad cost trace ({samples} samples)")
    if psums - samples != rounds:  # one a round, one a cost sample
        raise AssertionError(f"20a: {psums} psums over {rounds} rounds and "
                             f"{samples} cost samples")
    want_u = {"factor_round_binary_shared": 0, "factor_round_binary": 0,
              "q_update": rounds}
    want_m = dict(want_u, q_update=rounds * SHARDS)
    if lu != want_u or lm != want_m:
        raise AssertionError(f"20a: launches {lu} {lm}")
    msgs = 2 * p.n_real_edges * rounds
    print(f"solve sharded-coloring-1M-maxsum: n_vars={p.n_vars} "
          f"n_real_edges={p.n_real_edges} n_edges={p.n_edges} "
          f"shards={SHARDS} mesh={mesh} rounds={rounds} "
          f"compile_seconds={compile_s} "
          f"meshed_engine_seconds={rm.time} meshed_msgs_per_s={msgs / rm.time} "
          f"meshed_wall_seconds={wall_m} "
          f"unmeshed_engine_seconds={ru.time} "
          f"unmeshed_msgs_per_s={msgs / ru.time} "
          f"phase6_coloring1M_msgs_per_s={rate} "
          f"step_psums={psums - samples} cost_psums={samples} "
          f"best_cost={rm.best_cost} bit_equal_costs="
          f"{bool(np.array_equal(rm.cost_trace, ru.cost_trace))} "
          f"launches_meshed={lm} launches_unmeshed={lu} card={card}")
    count = torch.cuda.device_count()
    if count > 1:  # distinct cards, where the machine has them
        devs = [torch.device("cuda", i % count) for i in range(SHARDS)]
        r = run_batched(p, maxsum, params, mesh=Mesh(devs), **kw)
        print(f"solve sharded-coloring-1M-maxsum over {devs}: "
              f"engine_seconds={r.time} best_cost={r.best_cost}")
    return {"q_update": lu["q_update"] + lm["q_update"]}


SHARDED_ALGOS = (("maxsum", {"damping": 0.5}),) + tuple(
    (algo, user) for algo, user, _ in LOCAL_SEARCH)


SHARDED_ROUNDS = 16  # 20b's rounds an algorithm (32 until its run 2)


def sharded_card_vs_cpu(torch, mk, dev, card, p, pc):
    """20b: ``SHARDED_ROUNDS`` rounds of each batched algorithm over the
    card mesh and over a CPU mesh from one CPU-made state and CPU-made
    draws, and the unmeshed card run of the same problem beside them."""
    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.engine.batched import ShardedRounds
    from pydcop_tpu_torch.ops.costs import total_cost
    from pydcop_tpu_torch.parallel import Mesh, make_mesh, shard_problem

    sc = shard_problem(p, Mesh([dev] * SHARDS))
    sh = shard_problem(pc, make_mesh(SHARDS, device="cpu"))
    launched = 0
    for algo, user in SHARDED_ALGOS:
        label = f"20b {algo}-coloring-10k-ternary"
        mod = load_algorithm_module(algo)
        params = prepare_algo_params(user, mod.algo_params)
        lc = ShardedRounds(sc, p, mod, params, 0, total_cost)
        lh = ShardedRounds(sh, pc, mod, params, 0, total_cost)
        st = mod.init_state(pc, 3, params)
        st_u = {k: v.to(dev) for k, v in st.items()}
        parts_h, parts_c = lh.place(st), lc.place(st_u)
        gen = torch.Generator().manual_seed(11)
        costs = {"card": [], "cpu": [], "unmeshed": []}
        t0 = time.perf_counter()
        mk.reset_launches()
        for i in range(SHARDED_ROUNDS):
            drawn = mod.draws(pc, params, gen) if lc.seam else None
            moved = (None if drawn is None
                     else {k: v.to(dev) for k, v in drawn.items()})
            parts_h = lh.apply(parts_h, drawn)
            parts_c = lc.apply(parts_c, moved)
            st_u = (mod.apply(p, st_u, params, moved) if lc.seam
                    else mod.step(p, st_u, params))
            if (i + 1) % 8 == 0:
                costs["card"].append(lc.observe(parts_c)[0].cpu())
                costs["cpu"].append(lh.observe(parts_h)[0])
                costs["unmeshed"].append(total_cost(p, st_u["values"]).cpu())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = dict(mk.launches)
        card_state = lc.whole(parts_c, "cpu")
        same_states(torch, f"{label} card mesh vs CPU mesh", card_state,
                    lh.whole(parts_h, "cpu"))
        same_states(torch, f"{label} card mesh vs unmeshed", card_state,
                    st_u)
        for other in ("cpu", "unmeshed"):
            if not all(same_bits(torch, a, b) for a, b in
                       zip(costs["card"], costs[other])):
                raise AssertionError(f"{label}: costs differ from {other}")
        kernel = algo in ("maxsum", "amaxsum")
        want = {"factor_round_binary_shared": 0, "factor_round_binary": 0,
                "q_update": SHARDED_ROUNDS * (SHARDS + 1) if kernel else 0}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        launched += got["q_update"]
        print(f"card-vs-cpu {label}: {SHARDS} shards, {SHARDED_ROUNDS} "
              f"rounds, card mesh "
              f"= CPU mesh = unmeshed card run in {sorted(card_state)} and "
              f"costs {[float(c) for c in costs['card']]}, "
              f"step_psums={lc.step_psums} seconds={seconds} "
              f"launches={got} card={card}")
    return launched


def frozen_ring_dcop():
    """8 variables on a ring, every other one an external variable: after
    slicing, no constraint is left between decision variables."""
    from pydcop_tpu_torch.dcop import (
        DCOP,
        Domain,
        ExternalVariable,
        Variable,
        constraint_from_str,
    )

    d = Domain("colors", "", [0, 1, 2])
    dcop = DCOP("frozen_ring")
    vs = [ExternalVariable(f"v{i}", d, 0) if i % 2 else Variable(f"v{i}", d)
          for i in range(8)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(8):
        dcop.add_constraint(constraint_from_str(
            f"c{i}", f"1 if v{i} == v{(i + 1) % 8} else 0", vs))
    return dcop


def sharded_runs(torch, mk, dev, card, p, arrays):
    """20c: what a multi-device dry run covers, each item over the card
    mesh against its unmeshed run: restarts, a checkpoint resumed under
    the mesh, a run_many_batched group, a constraint-free problem and a
    dynamic run."""
    import os
    import tempfile

    import numpy as np

    from pydcop_tpu_torch.algorithms import (
        load_algorithm_module,
        prepare_algo_params,
    )
    from pydcop_tpu_torch.engine.batched import run_batched, run_many_batched
    from pydcop_tpu_torch.engine.dynamic import run_dynamic
    from pydcop_tpu_torch.ops.compile import (
        compile_dcop,
        compile_from_arrays,
        stack_problems,
    )
    from pydcop_tpu_torch.ops.generate import coloring_arrays
    from pydcop_tpu_torch.parallel import Mesh

    mesh = Mesh([dev] * SHARDS)
    maxsum = load_algorithm_module("maxsum")
    ms_params = prepare_algo_params({"damping": 0.5}, maxsum.algo_params)
    launched = 0

    def pair(label, problem, mod, params, **kw):
        nonlocal launched
        mk.reset_launches()
        t0 = time.perf_counter()
        rm = run_batched(problem, mod, params, mesh=mesh, **kw)
        ru = run_batched(problem, mod, params, **kw)
        launched += mk.launches["q_update"]
        same_runs(label, rm, ru)
        return rm, time.perf_counter() - t0

    # restarts: the restart axis inside every shard's step
    for algo, user in (("dsa", {"variant": "B", "probability": 0.7}),
                       ("maxsum", {"damping": 0.5})):
        mod = load_algorithm_module(algo)
        params = prepare_algo_params(user, mod.algo_params)
        r, s = pair(f"20c {algo}-K4", p, mod, params, rounds=64,
                    chunk_size=32, cost_every=8, n_restarts=4, seed=7)
        print(f"solve sharded-{algo}-coloring-10k-ternary-K4: restarts=4 "
              f"rounds=64 restart_costs={r.restart_costs.tolist()} "
              f"seconds_meshed_and_unmeshed={s} equal=True card={card}")

    # a checkpoint at the midpoint, resumed under the same mesh
    ck = os.path.join(tempfile.mkdtemp(prefix="chip20"), "mesh.npz")
    kw = dict(seed=3, chunk_size=32, cost_every=8, mesh=mesh)
    full = run_batched(p, maxsum, ms_params, rounds=128, **kw)
    run_batched(p, maxsum, ms_params, rounds=64, checkpoint_path=ck, **kw)
    resumed = run_batched(p, maxsum, ms_params, rounds=128,
                          checkpoint_path=ck, resume=True, **kw)
    same_runs("20c checkpoint", resumed, full)
    with np.load(ck) as data:
        if data["state/q"].shape != (3, p.n_edges):
            raise AssertionError("20c: the checkpoint is not global")
    print(f"resume sharded-maxsum-coloring-10k-ternary: saved at 64 of 128 "
          f"rounds under the mesh, resumed equal, file_bytes="
          f"{os.path.getsize(ck)} card={card}")
    os.remove(ck)

    # a run_many_batched group of 4 rewired coloring-10k graphs
    s, t, u = arrays
    graphs = [(s, u)] + [
        (rewired(s, sd), coloring_arrays(len(u), colors=3, degree=3,
                                         seed=sd)[2])
        for sd in (2, 3, 4)
    ]
    probs = [compile_from_arrays(sk, t, 3, unary=uk, n_shards=SHARDS,
                                 device=dev) for sk, uk in graphs]
    groups = stack_problems(probs)
    if len(groups) != 1:
        raise AssertionError("20c: the rewired graphs do not stack")
    mk.reset_launches()
    gkw = dict(rounds=64, seeds=[1, 2, 3, 4], chunk_size=32, cost_every=8)
    t0 = time.perf_counter()
    meshed = run_many_batched(groups[0], maxsum, ms_params, mesh=mesh, **gkw)
    group_s = time.perf_counter() - t0
    plain = run_many_batched(groups[0], maxsum, ms_params, **gkw)
    launched += mk.launches["q_update"]
    for i, (a, b) in enumerate(zip(meshed, plain)):
        same_runs(f"20c group instance {i}", a, b)
    print(f"solve sharded-many-coloring10k-maxsum-I4: instances=4 rounds=64 "
          f"costs={[r.cost for r in meshed]} meshed_seconds={group_s} "
          f"equal=True card={card}")

    # a constraint-free problem shards and runs
    free = compile_dcop(frozen_ring_dcop(), n_shards=SHARDS, device=dev)
    if free.n_real_edges != 0:
        raise AssertionError("20c: the frozen ring kept a constraint")
    for algo in ("maxsum", "dsa"):
        mod = load_algorithm_module(algo)
        r, _ = pair(f"20c constraint-free {algo}", free, mod,
                    prepare_algo_params({}, mod.algo_params), rounds=4,
                    chunk_size=4)
        if (r.cycles, r.cost) != (4, 0.0):
            raise AssertionError(f"20c constraint-free {algo}: {r.cost}")
    print(f"solve sharded-constraint-free: maxsum and dsa, 4 rounds, "
          f"cost 0 card={card}")

    # a short dynamic run of phase 14's scenario, every segment sharded
    dcop, cap = sensor_coloring_dcop(**DYN_SIZE)
    # an eighth of phase 14's rounds a second, 16 final rounds (a round
    # over the mesh costs four threads' host issue: PERF.md, PR 17)
    dkw = dict(distribution="adhoc", k_target=1,
               rounds_per_second=DYN_ROUNDS_PER_S / 8, final_rounds=16,
               seed=1, chunk_size=DYN_CHUNK, device=dev, n_shards=SHARDS)
    mk.reset_launches()
    t0 = time.perf_counter()
    dm = run_dynamic(dcop, "maxsum", {"damping": 0.5},
                     scenario=sensor_scenario(capacity=cap), mesh=mesh, **dkw)
    dyn_s = time.perf_counter() - t0
    du = run_dynamic(dcop, "maxsum", {"damping": 0.5},
                     scenario=sensor_scenario(capacity=cap), **dkw)
    launched += mk.launches["q_update"]
    for k in DYN_EXACT:
        if dm[k] != du[k]:
            raise AssertionError(f"20c dynamic: meshed and unmeshed differ "
                                 f"in {k}")
    print(f"run sharded-dynamic-coloring10k-sensors: shards={SHARDS} "
          f"cycle={dm['cycle']} cost={dm['cost']} "
          f"state_transfers={dm['state_transfers']} meshed_seconds={dyn_s} "
          f"equal=True card={card}")
    return launched


def sharded_phase(torch, mk, dev, card, rate):
    """Phase 20 (see the module docstring).  Returns its launches by
    kernel entry."""
    from pydcop_tpu_torch.ops.compile import compile_from_arrays
    from pydcop_tpu_torch.ops.generate import coloring_arrays

    t_lap = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        print(f"phase {part} seconds={now - t_lap[0]}")
        t_lap[0] = now

    counts = sharded_full_width(torch, mk, dev, card, rate)
    torch.cuda.empty_cache()
    lap("20a")
    s, t, u = coloring_arrays(10_000, colors=3, degree=3, seed=1)
    s3, t3 = ternary_arrays(10_000, seed=5)
    pc = compile_from_arrays([s, s3], [t, t3], 3, unary=u, n_shards=SHARDS,
                             device="cpu")
    p = pc.to(dev)
    counts["q_update"] += sharded_card_vs_cpu(torch, mk, dev, card, p, pc)
    lap("20b")
    counts["q_update"] += sharded_runs(torch, mk, dev, card, p, (s, t, u))
    lap("20c")
    return counts


# -- phase 21: the SPMD runtime, one process a shard --------------------------

SPMD_RANKS = 4  # 21a-b: the orchestrator and 3 agents, 4 shards on the card
SPMD_ROUNDS = 256  # 21a: Max-Sum rounds, chunk SPMD_CHUNK
SPMD_CHUNK = 64
SPMD_DSA_ROUNDS = 64  # 21b
SPMD_DSA_SIDE = 50  # 21b's grid: 50x50 (grid10k's YAML deploy again: ~60 s)
ELASTIC_ROUNDS = 800  # 21d: long enough for both kills to land mid-run
SPMD_WAIT = 300.0  # seconds: every wait on a process of phase 21


def grid_dcop(side):
    """``generate graph_coloring --graph grid -n side² -c 3 --soft
    --noise 0.02 --seed 1``, built in memory with the port's
    generator."""
    import argparse

    from pydcop_tpu_torch.commands.generators.graphcoloring import generate

    return generate(argparse.Namespace(
        graph="grid", variables_count=side ** 2, colors_count=3,
        soft=True, noise=0.02, seed=1, intentional=False,
        agents_count=None, capacity=100.0, p_edge=0.5, m_edge=2,
    ))


class _SpmdRun:
    """``python -m pydcop_tpu_torch orchestrator … --port 0`` and its
    agents (``agent --names …``, one process each) under ``root`` (a
    checkout's root: the package imported from there).  The
    orchestrator's stderr is read as it comes, for the ports it
    announces."""

    def __init__(self, root, cwd, orch_args, names=(), agent_args=()):
        import queue
        import threading

        self.cwd, self.names = cwd, names
        self.env = dict(__import__("os").environ, PYTHONPATH=str(root))
        self.t0 = time.perf_counter()
        self.orch = subprocess.Popen(
            [sys.executable, "-m", "pydcop_tpu_torch", "orchestrator",
             *orch_args, "--port", "0"], cwd=cwd, env=self.env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.lines, self.err = queue.Queue(), []
        threading.Thread(target=self._pump, daemon=True).start()
        self.agents, self.control = [], None
        if names:
            self.start_agents(names, agent_args)

    def start_agents(self, names, agent_args=()):
        """``agent --names …`` (one process each) against the control
        port the orchestrator announces."""
        if self.control is None:
            self.control = self.port()
        self.agents.append(subprocess.Popen(
            [sys.executable, "-m", "pydcop_tpu_torch", "agent", "--names",
             *names, "--orchestrator", f"127.0.0.1:{self.control}",
             *agent_args], cwd=self.cwd, env=self.env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def _pump(self):
        for line in self.orch.stderr:
            self.err.append(line)
            self.lines.put(line)
        self.lines.put(None)

    def port(self, what="control plane"):
        import queue

        deadline = time.monotonic() + SPMD_WAIT
        while time.monotonic() < deadline:
            try:
                line = self.lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if line is None:
                break
            if line.startswith(f"orchestrator: {what} on port "):
                return int(line.split()[-1])
        raise AssertionError(f"21: no {what} port announced:\n"
                             + "".join(self.err)[-3000:])

    def result(self, label):
        """The orchestrator's result and each agent process's output;
        any nonzero exit fails ``label``."""
        out = self.orch.stdout.read()
        self.orch.wait(timeout=SPMD_WAIT)
        self.seconds = time.perf_counter() - self.t0
        if self.orch.returncode != 0:
            raise AssertionError(f"{label}: the orchestrator exited "
                                 f"{self.orch.returncode}:\n"
                                 + "".join(self.err)[-4000:])
        agents = []
        for proc in self.agents:
            a_out, a_err = proc.communicate(timeout=SPMD_WAIT)
            if proc.returncode != 0:
                raise AssertionError(f"{label}: an agent process exited "
                                     f"{proc.returncode}:\n{a_err[-4000:]}")
            agents += _json_objects(a_out)  # the forked agents' lines
        return json.loads(out[out.index("{"):]), agents

    def stop(self):
        for proc in [self.orch, *self.agents]:
            stop(proc)


def _json_objects(text):
    """The JSON objects in ``text``, however the processes that share
    one pipe interleaved their lines."""
    dec, out, i = json.JSONDecoder(), [], text.find("{")
    while i >= 0:
        obj, end = dec.raw_decode(text, i)
        out.append(obj)
        i = text.find("{", end)
    return out


def _state(ui_port, pred, what, proc):
    """Polls a live feed's ``/state`` until ``pred`` holds."""
    import urllib.request

    deadline = time.monotonic() + SPMD_WAIT
    last = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"21: the orchestrator exited "
                                 f"({proc.returncode}) waiting for {what}")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ui_port}/state", timeout=5) as r:
                last = json.loads(r.read().decode())
            if pred(last):
                return last
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"21: timed out waiting for {what}; last={last}")


def _rank_telemetry(path):
    """The counters and gauges a rank's ``--trace`` file ends with."""
    snap = {}
    for line in open(path):
        rec = json.loads(line)
        if rec.get("kind") == "metrics":
            snap = rec
    return snap.get("counters", {}), snap.get("gauges", {})


def _spmd_ranks(workdir):
    """Every rank's telemetry of 21a's run (its ``--trace``): kernel
    launches, psums, and deploy, engine and psum seconds."""
    ranks = {}
    for name, path in [("orchestrator", workdir / "orch.jsonl")] + [
            (f"a{i}", workdir / f"agents.jsonl.a{i}")
            for i in range(1, SPMD_RANKS)]:
        c, g = _rank_telemetry(path)
        ranks[name] = {
            "q_update": c.get("kernel.q_update.launches", 0),
            "factor": c.get("kernel.factor_round_binary.launches", 0)
            + c.get("kernel.factor_round_binary_shared.launches", 0),
            "psums": c.get("spmd.psums"),
            "psum_seconds": g.get("spmd.psum_seconds"),
            "deploy_seconds": g.get("spmd.deploy_seconds"),
            "engine_seconds": g.get("spmd.engine_seconds"),
        }
    return ranks


def _same_spmd(label, got, want):
    """A process-mesh result dict against an in-process ``RunResult``:
    assignment, costs, cycle and status bit-equal."""
    if (got["assignment"], got["cost"], got["final_cost"], got["cycle"],
            got["status"], got["msg_count"]) != (
            want.best_assignment, want.best_cost, want.cost, want.cycles,
            want.status, want.messages):
        raise AssertionError(
            f"{label}: the process mesh's run differs from the in-process "
            f"mesh's: cost {got['cost']} / {want.best_cost}, cycle "
            f"{got['cycle']} / {want.cycles}")


def spmd_full_width(torch, mk, dev, card, workdir):
    """21a (see the module docstring), from a copy of the package with no
    built library: the 4 ranks build the kernels at once.  Returns the
    launches of its card runs by kernel entry."""
    import shutil

    import numpy as np

    from pydcop_tpu_torch.algorithms import maxsum, prepare_algo_params
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop
    from pydcop_tpu_torch.engine.batched import run_batched
    from pydcop_tpu_torch.ops.compile import compile_dcop
    from pydcop_tpu_torch.parallel import Mesh

    root = workdir / "fresh"
    shutil.copytree(HERE / "pydcop_tpu_torch", root / "pydcop_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    t0 = time.perf_counter()
    text = dcop_yaml(grid_dcop(ISLAND_SIDE))
    (workdir / "grid10k.yaml").write_text(text)
    dump_s = time.perf_counter() - t0
    # the orchestrator loads and dumps the YAML while the phase's other
    # cells run side by side (each in its own directory) and the same
    # problem is compiled here; the agents start after them, so that
    # the 4 ranks' deploy and rounds run alone
    run = _SpmdRun(
        root, workdir,
        ["grid10k.yaml", "-a", "maxsum", "-p", "damping:0.5", "--runtime",
         "spmd", "--nb_agents", str(SPMD_RANKS - 1), "--rounds",
         str(SPMD_ROUNDS), "--chunk_size", str(SPMD_CHUNK), "--seed", "1",
         "--trace", "orch.jsonl", "--heartbeat_timeout", str(SPMD_WAIT)])
    window = _spmd_window(torch, dev, card, workdir)
    try:
        t0 = time.perf_counter()
        problem = compile_dcop(load_dcop(text), n_shards=SPMD_RANKS,
                               device=dev)
        parse_s = time.perf_counter() - t0
        for f in window.values():
            f.exception()
        run.start_agents([f"a{i}" for i in range(1, SPMD_RANKS)],
                         ["--runtime", "spmd", "--trace", "agents.jsonl"])
        t_agents = time.perf_counter()
        result, agents = run.result("21a")
        agents_s = time.perf_counter() - t_agents
    finally:
        run.stop()
        for f in window.values():  # each stops its own processes
            f.exception()
    window = {name: f.result() for name, f in window.items()}
    nccl = window.pop("nccl")[0]
    ranks = _spmd_ranks(workdir)
    libs = sorted(p.name for p in (root / "pydcop_tpu_torch" /
                                   "_build").iterdir())
    params = prepare_algo_params({"damping": 0.5}, maxsum.algo_params)
    kw = dict(rounds=SPMD_ROUNDS, seed=1, chunk_size=SPMD_CHUNK)
    mesh = Mesh([dev] * SPMD_RANKS)
    here = {}
    for label, m in (("mesh", mesh), ("unmeshed", None)):
        mk.reset_launches()
        r = run_batched(problem, maxsum, params, mesh=m, **kw)
        torch.cuda.synchronize()
        here[label] = (r, dict(mk.launches), m.psums if m else 0)
    (rm, lm, psums_m), (ru, lu, _) = here["mesh"], here["unmeshed"]
    _same_spmd("21a", result, rm)
    same_runs("21a unmeshed", rm, ru, rel=1e-4)
    costs = {a["agent"]: a["cost"] for a in agents}
    if sorted(costs) != [f"a{i}" for i in range(1, SPMD_RANKS)] or any(
            c != result["cost"] for c in costs.values()):
        raise AssertionError(f"21a: agents' costs {costs}, orchestrator's "
                             f"{result['cost']}")
    if (result["n_shards"], result["num_processes"]) != (SPMD_RANKS,
                                                         SPMD_RANKS):
        raise AssertionError(f"21a: {result['n_shards']} shards")
    for name, t in ranks.items():
        if (t["q_update"], t["factor"]) != (SPMD_ROUNDS, 0):
            raise AssertionError(f"21a: rank {name} launched {t}")
        if t["psums"] != 2 * SPMD_ROUNDS:  # a round's and a cost sample's
            raise AssertionError(f"21a: rank {name} made {t['psums']} psums")
    if len([x for x in libs if x.endswith(".so")]) != 1 or any(
            not x.startswith("maxsum_kernels-") for x in libs):
        raise AssertionError(f"21a: the fresh build left {libs}")
    msgs = result["msg_count"]
    emit("21a", "grid10k-maxsum-spmd-R4", ranks=SPMD_RANKS,
         n_vars=problem.n_vars, n_real_edges=problem.n_real_edges,
         rounds=SPMD_ROUNDS, cost=result["cost"], cycle=result["cycle"],
         status=result["status"], equal_to_in_process_mesh=True,
         msg_count=msgs, engine_seconds=result["time"],
         msgs_per_s=msgs / result["time"], wall_seconds=run.seconds,
         agents_to_result_seconds=agents_s,
         yaml_dump_seconds=dump_s, reference_parse_compile_seconds=parse_s,
         per_rank=ranks, fresh_build=libs,
         in_process_mesh={"engine_seconds": rm.time,
                          "msgs_per_s": msgs / rm.time, "psums": psums_m,
                          "q_update": lm["q_update"]},
         unmeshed={"engine_seconds": ru.time, "msgs_per_s": msgs / ru.time,
                   "q_update": lu["q_update"],
                   "bit_equal_costs": bool(np.array_equal(rm.cost_trace,
                                                          ru.cost_trace))},
         backend=result["backend"], nccl_two_ranks_one_card=nccl,
         side_cells_seconds={k: v[1] for k, v in window.items()})
    return {"q_update": sum(t["q_update"] for t in ranks.values())
            + lm["q_update"] + lu["q_update"]}


def _spmd_window(torch, dev, card, workdir):
    """21b-e and the NCCL probe, each in a thread of its own and a
    directory of its own; returns ``{name: future}``, each future giving
    ``(result, seconds)``."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn, sub):
        sub.mkdir()
        t0 = time.perf_counter()
        return fn(torch, dev, card, sub), time.perf_counter() - t0

    pool = ThreadPoolExecutor(5, thread_name_prefix="phase21")
    futures = {name: pool.submit(timed, fn, workdir / name) for name, fn in (
        ("nccl", nccl_probe), ("21b", spmd_draws), ("21c", spmd_sigkill),
        ("21d", spmd_elastic), ("21e", spmd_scenario))}
    pool.shutdown(wait=False)
    return futures


def spmd_draws(torch, dev, card, workdir):
    """21b: DSA-B over the process mesh against the in-process card
    mesh, bit for bit (every rank draws the whole problem's draws)."""
    from pydcop_tpu_torch.algorithms import dsa, prepare_algo_params
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop
    from pydcop_tpu_torch.engine.batched import run_batched
    from pydcop_tpu_torch.ops.compile import compile_dcop
    from pydcop_tpu_torch.parallel import Mesh

    text = dcop_yaml(grid_dcop(SPMD_DSA_SIDE))
    (workdir / "grid_dsa.yaml").write_text(text)
    run = _SpmdRun(
        HERE, workdir,
        ["grid_dsa.yaml", "-a", "dsa", "-p", "variant:B", "-p",
         "probability:0.7", "--nb_agents", str(SPMD_RANKS - 1), "--rounds",
         str(SPMD_DSA_ROUNDS), "--chunk_size", str(SPMD_CHUNK), "--seed",
         "1"],
        [f"b{i}" for i in range(1, SPMD_RANKS)])
    try:
        problem = compile_dcop(load_dcop(text), n_shards=SPMD_RANKS,
                               device=dev)
        result, agents = run.result("21b")
    finally:
        run.stop()
    params = prepare_algo_params({"variant": "B", "probability": 0.7},
                                 dsa.algo_params)
    rm = run_batched(problem, dsa, params, rounds=SPMD_DSA_ROUNDS, seed=1,
                     chunk_size=SPMD_CHUNK, mesh=Mesh([dev] * SPMD_RANKS))
    _same_spmd("21b", result, rm)
    if any(a["cost"] != result["cost"] for a in agents):
        raise AssertionError(f"21b: agents' costs {agents}")
    emit("21b", f"grid{SPMD_DSA_SIDE ** 2}-dsaB-spmd-R4", ranks=SPMD_RANKS,
         n_vars=problem.n_vars, rounds=SPMD_DSA_ROUNDS, cost=result["cost"],
         equal_to_in_process_mesh=True, engine_seconds=result["time"],
         in_process_mesh_engine_seconds=rm.time, wall_seconds=run.seconds)


def nccl_probe(torch, dev, card, workdir):
    """Whether NCCL takes two ranks on one card: two processes, one
    ``all_reduce``; the outcome as a string (no gate)."""
    import socket

    code = (
        "import sys, datetime, torch, torch.distributed as dist\n"
        "r, port, fd = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])\n"
        "t = datetime.timedelta(seconds=30)\n"
        "store = dist.TCPStore('127.0.0.1', port, 2, r == 0, t,\n"
        "    wait_for_workers=False, master_listen_fd=fd if r == 0 else None)\n"
        "torch.cuda.set_device(0)\n"
        "try:\n"
        "    dist.init_process_group('nccl', store=store, rank=r,\n"
        "        world_size=2, timeout=t, device_id=torch.device('cuda', 0))\n"
        "    x = torch.ones(4, device='cuda')\n"
        "    dist.all_reduce(x)\n"
        "    torch.cuda.synchronize()\n"
        "    print('worked', float(x[0]))\n"
        "except Exception as e:\n"
        "    print('refused:', str(e).splitlines()[-1][:200])\n")
    s = socket.create_server(("127.0.0.1", 0))
    s.set_inheritable(True)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(s.getsockname()[1]),
         str(s.fileno())], cwd=workdir, pass_fds=(s.fileno(),) if r == 0
        else (), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True) for r in range(2)]
    s.close()
    try:
        outs = [p.communicate(timeout=90)[0].strip() for p in procs]
    except subprocess.TimeoutExpired:
        outs = ["hung"]
    finally:
        for p in procs:
            stop(p)
    return outs[0] or "no output"


def spmd_sigkill(torch, dev, card, workdir):
    """21c: the tests' SIGKILL case, ranks on the card."""
    (workdir / "ring12.yaml").write_text(_ring_dcop_text(
        12, [f"a{i}" for i in range(12)]))
    run = _SpmdRun(HERE, workdir,
                   ["ring12.yaml", "-a", "maxsum", "--nb_agents", "1",
                    "--rounds", "200000", "--chunk_size", "8", "--seed",
                    "5", "--heartbeat_timeout", "75", "--abort_grace", "4",
                    "--uiport", "0"], ["a1"])
    try:
        _state(run.port("live feed"), lambda s: s.get("cycle", 0) > 0,
               "21c's first chunk", run.orch)
        run.agents[0].kill()
        t_kill = time.perf_counter()
        run.orch.wait(timeout=60)
        detect = time.perf_counter() - t_kill
        time.sleep(0.2)
        err = "".join(run.err)
        if run.orch.returncode == 0 or detect > 20.0 or not (
                ("AgentFailureError" in err and "'a1'" in err)
                or "FATAL" in err):
            raise AssertionError(f"21c: exit {run.orch.returncode} after "
                                 f"{detect} s:\n{err[-3000:]}")
        alive = [p.pid for p in (run.orch, *run.agents) if p.poll() is None]
    finally:
        run.stop()
    emit("21c", "ring12-maxsum-spmd-sigkill", exit=run.orch.returncode,
         detect_seconds=detect, named_agent=True, ranks_left=alive)


def _children(pid):
    """The pids of ``pid``'s child processes (from /proc)."""
    import os

    kids = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                stat = open(f"/proc/{d}/stat").read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                kids.append(int(d))
    return kids


def spmd_elastic(torch, dev, card, workdir):
    """21d (see the module docstring)."""
    import os
    import signal

    from pydcop_tpu_torch.dcop.yamldcop import load_dcop

    text = _ring_dcop_text(12, [f"a{i}" for i in range(12)])
    (workdir / "ring12.yaml").write_text(text)
    run = _SpmdRun(HERE, workdir,
                   ["ring12.yaml", "-a", "maxsum", "--elastic",
                    "--nb_agents", "2", "--rounds", str(ELASTIC_ROUNDS),
                    "--chunk_size", "8", "--seed", "5", "--uiport", "0",
                    "--heartbeat_timeout", "60"])
    try:
        port = run.port()
        run.agents = [subprocess.Popen(
            [sys.executable, "-m", "pydcop_tpu_torch", "agent", "--names",
             name, "--orchestrator", f"127.0.0.1:{port}"], cwd=workdir,
            env=run.env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for name in ("a1", "a2")]
        ui = run.port("live feed")
        _state(ui, lambda s: s.get("epoch") == 1, "21d's epoch 1", run.orch)
        run.agents[1].kill()  # a2's supervisor: its worker is orphaned
        _state(ui, lambda s: (s.get("epoch") or 0) >= 2, "21d's epoch 2",
               run.orch)
        workers = _children(run.orch.pid)  # the orchestrator's own worker
        if len(workers) != 1:
            raise AssertionError(f"21d: orchestrator children {workers}")
        os.kill(workers[0], signal.SIGKILL)
        out = run.orch.stdout.read()
        run.orch.wait(timeout=SPMD_WAIT)
        if run.orch.returncode != 0:
            raise AssertionError("21d: the orchestrator exited "
                                 f"{run.orch.returncode}:\n"
                                 + "".join(run.err)[-4000:])
    finally:
        run.stop()
    r = json.loads(out[out.index("{"):])
    lost = [e for e in r["events"] if e["type"] == "participant_lost"]
    crash = [e for e in r["events"] if e["type"] == "worker_crash"]
    cost = load_dcop(text).solution_cost(r["assignment"])
    if (r["status"], r["epochs"], len(lost), len(crash)) != (
            "finished", 3, 1, 1) or lost[0]["participant"] != "a2" or \
            crash[0]["participant"] != "_orchestrator" or \
            lost[0]["frozen"] != r["lost_computations"] or \
            r["agents_final"] != ["a1"] or len(r["assignment"]) != 12 or \
            r["cost"] != cost:
        raise AssertionError(f"21d: {r}")
    emit("21d", "ring12-maxsum-elastic", epochs=r["epochs"],
         events=r["events"], lost_computations=r["lost_computations"],
         cost=r["cost"], solution_cost=cost, cycle=r["cycle"],
         seconds=time.perf_counter() - run.t0)


SCENARIO_TEXT = """
events:
  - id: w1
    delay: 0.5
  - id: e1
    actions:
      - type: remove_agent
        agent: a3
  - id: w2
    delay: 0.5
"""


def spmd_scenario(torch, dev, card, workdir):
    """21e: the tests' scenario across 2 ranks on the card against the
    in-process ``run_dynamic`` over the card mesh."""
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop, load_scenario
    from pydcop_tpu_torch.engine.dynamic import run_dynamic
    from pydcop_tpu_torch.parallel import Mesh

    text = _ring_dcop_text(12, [f"a{i}" for i in range(24)])
    (workdir / "ring12x24.yaml").write_text(text)
    (workdir / "scen.yaml").write_text(SCENARIO_TEXT)
    run = _SpmdRun(HERE, workdir,
                   ["ring12x24.yaml", "-a", "maxsum", "--nb_agents", "1",
                    "--rounds", "32", "--chunk_size", "16", "--seed", "5",
                    "--scenario", "scen.yaml", "--ktarget", "1"], ["a1"])
    try:
        result, agents = run.result("21e")
    finally:
        run.stop()
    local = run_dynamic(load_dcop(text), "maxsum", {},
                        load_scenario(SCENARIO_TEXT), k_target=1,
                        final_rounds=32, seed=5, mesh=Mesh([dev] * 2),
                        n_shards=2, chunk_size=16, device=dev)
    keys = ("assignment", "cost", "cycle", "status", "events",
            "lost_computations", "agents_final", "replicas")
    diff = [k for k in keys if result[k] != local[k]]
    if diff or result["n_shards"] != 2 or agents[0]["cost"] != result["cost"]:
        raise AssertionError(f"21e: the process mesh differs in {diff}")
    emit("21e", "ring12x24-maxsum-spmd-scenario", ranks=2,
         cost=result["cost"], cycle=result["cycle"],
         events=len(result["events"]), equal_to_in_process=True,
         wall_seconds=run.seconds)


def spmd_phase(torch, mk, dev, card):
    """Phase 21 (see the module docstring).  Returns its launches by
    kernel entry."""
    import tempfile

    CARD["card"] = card
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # 21a, with 21b-e run while its ranks deploy
        counts = spmd_full_width(torch, mk, dev, card, Path(tmp))
    emit("21", "phase", seconds=time.perf_counter() - t_phase)
    return counts


# -- phase 22: the tooling commands on the card's machine --------------------

#: the port's lint rules (``pydcop_tpu_torch/lint/rules.py:RULES``)
LINT_RULES = [
    "chaos-clause-doc", "chaos-inert-field", "chaos-symmetry",
    "cuda-atomics", "impure-call", "jax-import", "kernel-build-site",
    "lazy-init-eager-import", "metric-stale-doc", "metric-undocumented",
    "set-iteration", "span-undocumented", "torch-import-surface",
    "unseeded-random",
]
#: the JSON keys of ``pydcop_tpu bench-compare --pairs F --json``
COMPARE_KEYS = [
    "alpha", "ci", "ci_excludes_one", "conf", "higher_is_better",
    "max_ratio", "median_ratio", "min_ratio", "n_above", "n_below",
    "n_boot", "n_pairs", "name", "noise_floor", "p_sign", "seed",
    "verdict",
]
#: 22a's gate on the scan (about 3 s on a quiet host; this lane shares
#: the host's cores with five other processes)
LINT_SCAN_S = 30.0
LINT_PROBE = r"""
import json, sys, time
from pydcop_tpu_torch.cli import main
t0 = time.perf_counter()
rc = main(["lint", "--json"])
print(json.dumps({"rc": rc, "seconds": time.perf_counter() - t0,
                  "torch": "torch" in sys.modules,
                  "jax": "jax" in sys.modules}))
"""


def port_cli(*argv, timeout=120):
    """``python -m pydcop_tpu_torch <argv>`` in a child process on this
    checkout: (exit code, stdout)."""
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", *argv], cwd=HERE,
        capture_output=True, text=True, timeout=timeout,
    )
    return proc.returncode, proc.stdout


def lint_cell():
    """22a: the port's lint in a child process."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", LINT_PROBE], cwd=HERE,
                          capture_output=True, text=True, timeout=120)
    wall = time.perf_counter() - t0
    text = proc.stdout
    if proc.returncode != 0 or "\n{" not in text:
        raise AssertionError(f"22a lint exited {proc.returncode}: "
                             f"{text[-2000:]}{proc.stderr[-2000:]}")
    run = json.loads(text.strip().splitlines()[-1])
    report = json.loads(text[: text.rindex("\n{")])
    if not (run["rc"] == 0 and report["ok"] and not report["findings"]
            and not report["stale"] and report["rules"] == LINT_RULES
            and 0 < report["scan_seconds"] < LINT_SCAN_S
            and not run["torch"] and not run["jax"]):
        raise AssertionError(f"22a lint: {run} {report}")
    emit("22a", "lint", rc=run["rc"], ok=report["ok"],
         rules=len(report["rules"]), baselined=report["baselined"],
         scan_seconds=report["scan_seconds"], command_seconds=run["seconds"],
         wall_seconds=wall, torch_loaded=run["torch"],
         jax_loaded=run["jax"])


def q_update_pairs(torch, mk, dev, n_pairs=20):
    """22b's samples: the device time of the q update's gathered launch
    at coloring-1M, A and B the same launch, interleaved (B first on
    odd pairs)."""
    import numpy as np

    from pydcop_tpu_torch.ops.generate import coloring_arrays

    s5, _, _ = coloring_arrays(1_000_000, colors=3, degree=3, seed=1)
    ev = torch.from_numpy(np.concatenate([s5[:, 0], s5[:, 1]])).to(dev)
    g = torch.Generator(device=dev).manual_seed(22)
    d, e = 3, ev.shape[0]
    belief = torch.rand(d, 1_000_000, generator=g, device=dev) * 5.0
    r = torch.rand(d, e, generator=g, device=dev)
    q = torch.rand(d, e, generator=g, device=dev)

    def launch():
        return mk.q_update(belief, ev, r, q, 0.5, False)

    a, b = [], []
    for i in range(n_pairs):
        for arm in ((a, b) if i % 2 == 0 else (b, a)):
            arm.append(device_ms(torch, launch))
    return a, b, e


def history_rows(a, b, card):
    """22c's ledger: each pair a round (``tools/benchkeeper`` row schema:
    its status row and the two samples), an hour apart from
    2026-01-01."""
    import platform

    if str(HERE / "tools") not in sys.path:
        sys.path.insert(0, str(HERE / "tools"))
    from benchkeeper import ledger

    fp = ledger.null_fingerprint(backend="gpu", device_kind=card,
                                 python=platform.python_version())
    rows = []
    for i, pair in enumerate(zip(a, b)):
        ts = ledger.format_ts(1767225600 + 3600 * i)
        rows.append(ledger.make_row(  # the round's status row: exit 0
            ts=ts, source="chip_smoke", stage="bench_round", metric="rc",
            value=0.0, unit="code", higher_is_better=False, fingerprint=fp,
            round_name=f"r{i + 1:02d}", extra={"parsed": True},
        ))
        for metric, ms in zip(("device_ms_a", "device_ms_b"), pair):
            rows.append(ledger.make_row(
                ts=ts, source="chip_smoke", stage="q_update_coloring_1m",
                metric=metric, value=ms, unit="ms", higher_is_better=False,
                fingerprint=fp, round_name=f"r{i + 1:02d}",
            ))
    return ledger, rows, ledger.format_ts(1767225600 + 3600 * len(a))


def tooling_phase(torch, mk, dev, card):
    """Phase 22 (see the module docstring)."""
    import tempfile

    CARD["card"] = card
    t_phase = time.perf_counter()
    lint_cell()
    t0 = time.perf_counter()
    a, b, e = q_update_pairs(torch, mk, dev)
    sample_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        pairs = Path(tmp) / "pairs.json"
        pairs.write_text(json.dumps({
            "baseline": a, "candidate": b, "higher_is_better": False,
            "name": "q_update coloring-1M A/A",
        }))
        rc, out = port_cli("bench-compare", "--pairs", str(pairs), "--json")
        doc = json.loads(out) if out.strip() else {}
        if rc != 0 or doc.get("verdict") != "noise" or sorted(
                doc) != COMPARE_KEYS:
            raise AssertionError(f"22b bench-compare exited {rc}: {out}")
        emit("22b", "bench-compare-q_update-coloring-1M-AA", rc=rc,
             verdict=doc["verdict"], n_pairs=doc["n_pairs"],
             median_ratio=doc["median_ratio"], ci=doc["ci"],
             p_sign=doc["p_sign"], edges=e,
             a_ms_median=statistics.median(a),
             b_ms_median=statistics.median(b), a_ms=a, b_ms=b,
             sample_seconds=sample_s)
        ledger, rows, now = history_rows(a, b, card)
        path = str(Path(tmp) / "ledger.jsonl")
        ledger.write_ledger(path, rows)
        runs = [port_cli("bench-history", "--ledger", path, "--now", now)
                for _ in range(2)]
        text = runs[0][1]
        if any(rc != 0 for rc, _ in runs) or text != runs[1][1] or (
                "q_update_coloring_1m/device_ms_a" not in text
                or f"{len(rows)} rows, {len(a)} rounds" not in text):
            raise AssertionError(f"22c bench-history: {runs}")
        emit("22c", "bench-history-twice", rcs=[rc for rc, _ in runs],
             same_bytes=True, rows=len(rows), stdout_bytes=len(text),
             now=now)
    emit("22", "phase", seconds=time.perf_counter() - t_phase)


# -- the lanes: phases 14-16, 17-18, 19, 20 and 22 beside phases 10-13; 21 after

LANE_WAIT = 900.0  # seconds a lane may run past the end of phase 13


def _lane_device():
    import torch

    from pydcop_tpu_torch.ops import maxsum_kernels as mk

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mk.build()  # the parent's build: loaded, not rebuilt
    return torch, mk, dev


def lane_14_16(card, rate):
    """Phases 14-16 in a child process (see :func:`start_lane`);
    ``rate``: phase 3's coloring-10k msgs/s, or ``"None"``."""
    torch, mk, dev = _lane_device()
    rate = None if rate == "None" else float(rate)
    t14 = time.perf_counter()
    dcounts = dynamic_phase(torch, mk, dev, card, rate)
    print(f"phase 14 seconds={time.perf_counter() - t14}")
    t15 = time.perf_counter()
    ccounts = cli_phase(torch, mk, dev, card, rate)
    print(f"phase 15 seconds={time.perf_counter() - t15}")
    t16 = time.perf_counter()
    vcounts = serve_phase(torch, mk, dev, card)
    print(f"phase 16 seconds={time.perf_counter() - t16}")
    print(json.dumps({"lane_launches": [dcounts, ccounts, vcounts]}),
          flush=True)


def lane_19(card):
    """Phase 19 in a child process (see :func:`start_lane`)."""
    torch, mk, dev = _lane_device()
    t19 = time.perf_counter()
    pcounts = process_phase(torch, mk, dev, card)
    print(f"phase 19 seconds={time.perf_counter() - t19}")
    print(json.dumps({"lane_launches": [pcounts]}), flush=True)


def lane_20(card, rate):
    """Phase 20 in a child process (see :func:`start_lane`); ``rate``:
    phase 6's coloring-1M msgs/s, or ``"None"``."""
    torch, mk, dev = _lane_device()
    t20 = time.perf_counter()
    counts = sharded_phase(torch, mk, dev, card,
                           None if rate == "None" else float(rate))
    print(f"phase 20 seconds={time.perf_counter() - t20}")
    print(json.dumps({"lane_launches": [counts]}), flush=True)


def lane_22(card):
    """Phase 22 in a child process (see :func:`start_lane`)."""
    torch, mk, dev = _lane_device()
    t22 = time.perf_counter()
    tooling_phase(torch, mk, dev, card)
    print(f"phase 22 seconds={time.perf_counter() - t22}")
    print(json.dumps({"lane_launches": [{}]}), flush=True)


def lane_21(card):
    """Phase 21 in a child process (see :func:`start_lane`)."""
    torch, mk, dev = _lane_device()
    t21 = time.perf_counter()
    counts = spmd_phase(torch, mk, dev, card)
    print(f"phase 21 seconds={time.perf_counter() - t21}")
    print(json.dumps({"lane_launches": [counts]}), flush=True)


def lane_17_18(card):
    """Phases 17 and 18 in a child process (see :func:`start_lane`)."""
    torch, mk, dev = _lane_device()
    t17 = time.perf_counter()
    hcounts = host_runtime_phase(torch, mk, dev, card)
    print(f"phase 17 seconds={time.perf_counter() - t17}")
    t18 = time.perf_counter()
    lockstep_phase(torch, dev, card)
    print(f"phase 18 seconds={time.perf_counter() - t18}")
    print(json.dumps({"lane_launches": [hcounts]}), flush=True)


def start_lane(func, *args):
    """``chip_smoke.<func>(*args)`` in a child process on the same card,
    so that phases of host Python (most of 10-18) run side by side and
    the script stays well inside its time limit.  Returns what
    :func:`join_lane` takes."""
    import threading

    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            f"import chip_smoke; chip_smoke.{func}(*sys.argv[2:])")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(HERE), *args], cwd=HERE,
        stdout=subprocess.PIPE, text=True,
    )
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()
    return func, proc, reader, lines, time.perf_counter()


def join_lane(lane):
    """Waits for :func:`start_lane`'s child, prints its lines and returns
    the launches its phases counted (a list of dicts by kernel entry);
    the child's failure fails the script."""
    func, proc, reader, lines, t0 = lane
    try:
        proc.wait(timeout=LANE_WAIT)
    finally:
        stop(proc)
    reader.join(timeout=60)
    sys.stdout.write("".join(lines))
    print(f"{func} (a child process) seconds={time.perf_counter() - t0}")
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"{func} (its own process) exited "
                             f"{proc.returncode}")
    return json.loads(lines[-1])["lane_launches"]


def stop(proc):
    """Ends ``proc`` if it still runs."""
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import pydcop_tpu_torch

    if Path(pydcop_tpu_torch.__file__).resolve().parent.parent != HERE:
        raise RuntimeError(
            "pydcop_tpu_torch was not imported from this checkout"
        )
    from pydcop_tpu_torch.algorithms import maxsum
    from pydcop_tpu_torch.algorithms import prepare_algo_params
    from pydcop_tpu_torch.api import solve_compiled
    from pydcop_tpu_torch.engine.batched import run_batched
    from pydcop_tpu_torch.ops import maxsum_kernels as mk
    from pydcop_tpu_torch.ops.compile import compile_from_arrays
    from pydcop_tpu_torch.ops.generate import coloring_arrays

    t_start = time.perf_counter()
    # -- 1. device and build ---------------------------------------------
    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = mk.build()
    print(f"build: {built.path.name} nvcc_seconds={built.seconds} "
          f"wall_seconds={time.perf_counter() - t0}")
    instances = ptxas_instances(built.log)
    if not instances:
        print("ptxas: the library was reused, no build log to read")
    print(f"ptxas: instances={len(instances)} "
          f"max_registers={max((x[1] for x in instances), default=0)} "
          f"max_stack_frame_bytes={max((x[2] for x in instances), default=0)} "
          f"instances_spilling={sum(x[3] + x[4] > 0 for x in instances)}")
    local = []
    names = demangle([x[0] for x in instances])
    for (_, regs_, stack_, stores, loads), name in zip(instances, names):
        print(f"ptxas {name}: registers={regs_} stack_frame_bytes={stack_} "
              f"spill_store_bytes={stores} spill_load_bytes={loads}")
        if stack_ or stores or loads:
            local.append(name)
    if local:
        raise AssertionError(f"kernel instances in local memory: {local}")

    # the arrays of phases 3, 5 and 9: the 10k coloring and the
    # 100k-variable 10-colour instance with its per-factor tables
    s, t, u = coloring_arrays(10_000, colors=3, degree=3, seed=1)
    s10, t10, u10 = coloring_arrays(100_000, colors=10, degree=3, seed=2)
    tabs10 = np.random.default_rng(4).random((len(s10), 10, 10),
                                             dtype=np.float32)
    # phases 3-6's instances set phase 2's shapes: the per-factor width
    # and each coloring's edge index (position-major, as compiled)
    s4, _, u4 = coloring_arrays(100_000, colors=5, degree=3, seed=2)
    tabs4 = np.random.default_rng(4).random((len(s4), 5, 5), dtype=np.float32)
    m4 = len(s4)
    s5, t5, u5 = coloring_arrays(1_000_000, colors=3, degree=3, seed=1)
    edges = {  # n_vars: the edges' variables on the card
        n: torch.from_numpy(np.concatenate([sc[:, 0], sc[:, 1]])).to(dev)
        for n, sc in ((10_000, s), (100_000, s4), (1_000_000, s5))
    }

    # -- 2. kernels vs plain versions ------------------------------------
    rows = check_kernels(torch, mk, dev, m4, edges)
    params = prepare_algo_params({"damping": 0.5}, maxsum.algo_params)

    # -- 3. 10k coloring --------------------------------------------------
    p3c = compile_from_arrays(s, t, 3, unary=u, device="cpu")
    p3 = p3c.to(dev)
    if (p3.n_real_edges, p3.buckets[2].n_cons) != (59_974, 29_987):
        raise AssertionError("unexpected 10k coloring size")
    counts3 = main_path(
        torch, mk, solve_compiled, p3, 1024, 256,
        {"factor_round_binary_shared": 1024, "q_update": 1024,
         "factor_round_binary": 0}, "coloring-10k", card,
    )
    card_vs_cpu(torch, mk, run_batched, maxsum, params, p3, p3c, 256, 256,
                "coloring-10k")
    params_bf16 = prepare_algo_params(
        {"damping": 0.5, "msg_dtype": "bf16"}, maxsum.algo_params
    )
    card_vs_cpu(torch, mk, run_batched, maxsum, params_bf16, p3, p3c, 64,
                64, "coloring-10k-bf16-messages")
    # bf16 tables (and so bf16 unary and messages): the kernels compute
    # the factor phase in bf16, as the Pallas kernels do
    p3hc = compile_from_arrays(s, t, 3, unary=u, table_dtype="bf16",
                               device="cpu")
    card_vs_cpu(torch, mk, run_batched, maxsum, params, p3hc.to(dev), p3hc,
                64, 64, "coloring-10k-bf16-tables",
                {"factor_round_binary_shared": 64, "q_update": 64})
    # bf16 tables with a ternary bucket: outside the factor-kernel gate,
    # so the factor phase is the generic one and the q update kernel
    # rounds every operation to bf16, as the JAX package computes it
    s3, t3 = ternary_arrays(10_000, seed=5)
    p3tc = compile_from_arrays([s, s3], [t, t3], 3, unary=u,
                               table_dtype="bf16", device="cpu")
    if p3tc.n_real_edges != E_TERNARY:
        raise AssertionError("unexpected ternary instance size")
    card_vs_cpu(torch, mk, run_batched, maxsum, params, p3tc.to(dev), p3tc,
                64, 64, "coloring-10k-ternary-bf16-tables",
                {"factor_round_binary_shared": 0, "factor_round_binary": 0,
                 "q_update": 64})
    profile_rounds(torch, run_batched, maxsum, params, p3, 32,
                   "coloring-10k")
    cost_sum_row(torch, p3, "coloring-10k")

    # -- 4. per-factor tables, 100k variables ----------------------------
    p4c = compile_from_arrays(s4, tabs4, 5, unary=u4, device="cpu")
    p4 = p4c.to(dev)
    counts4 = main_path(
        torch, mk, solve_compiled, p4, 64, 64,
        {"factor_round_binary": 64, "q_update": 64,
         "factor_round_binary_shared": 0}, "per-factor-100k-d5", card,
    )
    card_vs_cpu(torch, mk, run_batched, maxsum, params, p4, p4c, 32, 32,
                "per-factor-100k-d5")
    p4hc = compile_from_arrays(s4, tabs4, 5, unary=u4, table_dtype="bf16",
                               device="cpu")
    card_vs_cpu(torch, mk, run_batched, maxsum, params, p4hc.to(dev), p4hc,
                16, 16, "per-factor-100k-d5-bf16-tables",
                {"factor_round_binary": 16, "q_update": 16})
    profile_rounds(torch, run_batched, maxsum, params, p4, 16,
                   "per-factor-100k-d5")

    # -- 5. d = 10: the factor kernels' lane-tile instance ---------------
    p10c = compile_from_arrays(s10, tabs10, 10, unary=u10, device="cpu")
    p10 = p10c.to(dev)
    if (p10.n_real_edges, p10.buckets[2].n_cons) != (599_976, 299_988):
        raise AssertionError("unexpected 100k 10-colour size")
    per_factor = {"factor_round_binary": 64, "q_update": 64,
                  "factor_round_binary_shared": 0}
    counts10 = main_path(torch, mk, solve_compiled, p10, 64, 64, per_factor,
                         "per-factor-100k-d10", card)
    half = {k: v // 2 for k, v in per_factor.items()}
    card_vs_cpu(torch, mk, run_batched, maxsum, params, p10, p10c, 32, 32,
                "per-factor-100k-d10", half)
    p10hc = compile_from_arrays(s10, tabs10, 10, unary=u10,
                                table_dtype="bf16", device="cpu")
    card_vs_cpu(torch, mk, run_batched, maxsum, params, p10hc.to(dev), p10hc,
                16, 16, "per-factor-100k-d10-bf16-tables",
                {k: v // 4 for k, v in per_factor.items()})
    del p10hc
    profile_rounds(torch, run_batched, maxsum, params, p10, 16,
                   "per-factor-100k-d10")
    del p10, p10c
    p10sc = compile_from_arrays(s10, t10, 10, unary=u10, device="cpu")
    p10s = p10sc.to(dev)
    if not p10s.buckets[2].shared_table:
        raise AssertionError("the 10-colour coloring lost its shared table")
    shared = {"factor_round_binary_shared": 64, "q_update": 64,
              "factor_round_binary": 0}
    counts10s = main_path(torch, mk, solve_compiled, p10s, 64, 64, shared,
                          "coloring-100k-d10", card)
    card_vs_cpu(torch, mk, run_batched, maxsum, params, p10s, p10sc, 32, 32,
                "coloring-100k-d10", {k: v // 2 for k, v in shared.items()})
    profile_rounds(torch, run_batched, maxsum, params, p10s, 16,
                   "coloring-100k-d10")
    del p10s, p10sc
    torch.cuda.empty_cache()

    # -- 6. 1M coloring ---------------------------------------------------
    del edges
    p5c = compile_from_arrays(s5, t5, 3, unary=u5, device="cpu")
    p5 = p5c.to(dev)
    if (p5.n_real_edges, p5.buckets[2].n_cons) != (5_999_982, 2_999_991):
        raise AssertionError("unexpected 1M coloring size")
    torch.cuda.reset_peak_memory_stats()
    main_path(
        torch, mk, solve_compiled, p5, 256, 256,
        {"factor_round_binary_shared": 256, "q_update": 256,
         "factor_round_binary": 0}, "coloring-1M", card,
    )
    print(f"coloring-1M max_memory_allocated_bytes="
          f"{torch.cuda.max_memory_allocated()}")
    card_vs_cpu(torch, mk, run_batched, maxsum, params, p5, p5c, 4, 4,
                "coloring-1M")
    profile_rounds(torch, run_batched, maxsum, params, p5, 16,
                   "coloring-1M")
    cost_sum_row(torch, p5, "coloring-1M")

    # -- 7. the local-search family and A-Max-Sum -------------------------
    local_search_phase(torch, mk, solve_compiled, run_batched, p3, p3c, p5,
                       card)

    # -- 8. exact DPOP ----------------------------------------------------
    del p5, p5c
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    dpop_phase(torch, dev, card)
    print(f"phase 8 seconds={time.perf_counter() - t8}")

    # -- 9. restarts, instances and the batch axis ------------------------
    t9 = time.perf_counter()
    brows, bcounts = many_phase(
        torch, mk, dev, card,
        {"coloring-10k": (s, t, u),
         "per-factor-100k-d10": (s10, tabs10, u10)},
        MAIN_PATH_RATES.get("coloring-10k"),
    )
    print(f"phase 9 seconds={time.perf_counter() - t9}")

    # -- 14-16, 17-18, 19, 20 and 22: five child processes on the card,
    # beside 10-13 --------------------------------------------------------
    rate = MAIN_PATH_RATES.get("coloring-10k")
    lanes = [start_lane("lane_14_16", card, str(rate)),
             start_lane("lane_17_18", card), start_lane("lane_19", card),
             start_lane("lane_20", card,
                        str(MAIN_PATH_RATES.get("coloring-1M"))),
             start_lane("lane_22", card)]
    try:
        # -- 10. exact inference ------------------------------------------
        t10 = time.perf_counter()
        infer_phase(torch, dev, card)
        print(f"phase 10 seconds={time.perf_counter() - t10}")

        # -- 11. the rest of the semiring core ----------------------------
        t11 = time.perf_counter()
        core_phase(torch, dev, card)
        print(f"phase 11 seconds={time.perf_counter() - t11}")

        # -- 12. branch-and-bound pruning and checkpoint/resume -----------
        t12 = time.perf_counter()
        bnb_checkpoint_phase(torch, mk, dev, card, (s, t, u), s5, t5, u5)
        print(f"phase 12 seconds={time.perf_counter() - t12}")

        # -- 13. the supervised dispatch and belief="blockdiag" -----------
        t13 = time.perf_counter()
        scounts = supervisor_phase(torch, mk, dev, card, (s, t, u), s5, t5,
                                   u5)
        print(f"phase 13 seconds={time.perf_counter() - t13}")

        # -- 14-19: the lanes' lines, in phase order ----------------------
        dcounts, ccounts, vcounts = join_lane(lanes[0])
        hcounts, = join_lane(lanes[1])
        pcounts, = join_lane(lanes[2])
        mcounts, = join_lane(lanes[3])
        join_lane(lanes[4])  # 22: timings only, no main-path launch
        # -- 21: alone after them (its rank processes time-slice the
        # card and share the host's cores; beside 10-20 they slowed
        # every phase) --------------------------------------------------
        lanes.append(start_lane("lane_21", card))
        rcounts, = join_lane(lanes[5])
    finally:
        for lane in lanes:
            stop(lane[1])

    # -- 23. summary ------------------------------------------------------
    kernels = []
    main_shape = {  # entry: (kernel, d, width, case, main-path launches)
        "factor_round_binary_shared": (
            "factor_round_binary_shared", 3, 29_987, "strided",
            counts3["factor_round_binary_shared"]),
        "factor_round_binary": (
            "factor_round_binary", 5, m4, "strided",
            counts4["factor_round_binary"]),
        "q_update": ("q_update", 3, 59_974, "gathered", counts3["q_update"]),
        # the lane-tile instance of each factor kernel, on phase 5's paths
        "factor_round_binary_shared.runtime_d": (
            "factor_round_binary_shared", 10, 299_988, "strided",
            counts10s["factor_round_binary_shared"]),
        "factor_round_binary.runtime_d": (
            "factor_round_binary", 10, 299_988, "strided",
            counts10["factor_round_binary"]),
        # the q update's lane-tile instance, on the same paths
        "q_update.runtime_d": (
            "q_update", 10, 599_976, "gathered", counts10["q_update"]),
    }
    for entry, (name, d, w, case, launched) in main_shape.items():
        tile = entry.endswith(".runtime_d")
        row = next(
            r for r in rows
            if r["kernel"] == name and r["table"] != "bf16"
            and (r["d"], r["width"], r["case"], r["dtype"]) == (d, w, case,
                                                                "f32")
        )
        kernels.append(dict(
            name=entry, route="cuda", source=SOURCE,
            replaces=KERNELS[name],
            launches=launched + scounts.get(entry, 0)
            + dcounts.get(entry, 0) + ccounts.get(entry, 0)
            + vcounts.get(entry, 0) + hcounts.get(entry, 0)
            + pcounts.get(entry, 0) + mcounts.get(entry, 0)
            + rcounts.get(entry, 0),
            max_abs_err=max(
                r["max_abs_err"] for r in rows if r["kernel"] == name
                and (r["instance"] != "unrolled") == tile),
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None,
        ))
    # the batched instances (phase 9a's rows, launches from 9's paths)
    for entry, row in brows.items():
        kernels.append(dict(
            name=entry, route="cuda", source=SOURCE,
            replaces=KERNELS[row["kernel"]],
            launches=bcounts[entry] + scounts.get(entry, 0)
            + ccounts.get(entry, 0) + vcounts.get(entry, 0),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
        ))
    print(f"total_seconds={time.perf_counter() - t_start}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
