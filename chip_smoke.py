#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Eight phases, each printing JSON lines (the third with the iterators, MIND,
the durability, the sharded and the mesh phases after it, the fifth with
the MoE LM, the training and the GNN phases after it):

1. **build** - compile the CUDA sources under ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the card's name and power
   limit.
2. **kernels** - boot the serve configuration and serve its first six
   requests (two updates, the second of which compacts both views on the
   policy's own trigger, and the reads between them), capturing the
   arguments the main path hands each kernel; then hold every kernel
   against its plain PyTorch version on those inputs (probe, commit, the
   sweep in all four semirings with and without a frontier, the live census
   and the chain walk) and time both with CUDA events: each kernel on the
   device alone (the card spins while the host queues the call between two
   events; the probe and the chain walk with the L2 cache flushed), each
   plain version per call, host syncs and launch gaps included.  The sweep
   reads a row only up to its first EMPTY lane, so the phase first checks
   that no row of the pools it captured (both views, before and after the
   compaction) holds a key after an EMPTY lane, and prints the count
   (``unpacked_rows``); its bound counts the filled lanes, beside PR 15's
   whole-row bound (``whole_row_bound_ms``).  The probe and the chain walk
   read a chain a run of consecutive rows at a time, so for each the phase
   prints the walks' lengths (``longest_walk``, ``hops``, ``longest_chain``)
   and the share of the pool's overflow links that are ``r -> r + 1``
   (``contiguous_links``), and holds and times both kernels again on a copy
   of their pool whose overflow rows are relabelled by a seeded permutation
   (``relabelled_ms``), where almost no link is.  The commit adds each
   run of one ``deg_idx`` in its sorted plan with one atomic, so for each
   captured plan the phase prints the runs, the live vertices and the
   longest run (``deg_runs``, ``deg_vertices``, ``longest_run``), and times
   the same kernel on a plan of the same size with every entry parked
   (``parked_ms``: no store and no atomic, the kernel's own fixed cost).
   Kernel 4, PageRank's contribution sums (``kernels/slab_pagerank``, its
   own kernel ``csrc/slab_pagerank.cu``, which sums every lane of a row as
   the reference does; not on the serve, whose PageRank sweeps through
   kernel 3), is driven as a path of its own: one call of its op on the
   served transpose pool with PageRank's contributions, the launch counts
   zeroed just before and read just after (the ``kernels`` line's
   launches: its kernel once, kernel 3 never), held to its plain version,
   and again on a seeded copy of the pool whose rows' lanes are rotated so
   that EMPTY lanes come first, where kernel 3's error is printed beside
   it (``sweep_err_unpacked``: kernel 3 stops at a row's first EMPTY lane,
   so the two functions differ there); timed on the device alone (``ms``)
   and per call of the op (``op_ms``), beside its whole-row bound.
3. **serve** - the port's ``launch.serve`` on the card at RMAT scale 20
   (1,048,576 vertices, 2**24 generated edges, 65,536-edge update batches
   with 25% deletes, 15 requests cycling update, PageRank, BFS and WCC
   reads and membership, a maintenance policy that compacts at a tombstone
   ratio of 0.0015), with the launch counts zeroed just before and read
   just after; then a self-check without the reference: a static rebuild
   from the request generator's edge ledger must hold the same edge set,
   the same BFS tree, PageRank within tolerance and the same components
   (scipy's weak components, labelled by their minimum vertex), and
   membership answers must match the ledger.  The static PageRank also
   runs with the reference's default ``contrib_impl="ref"`` (kernel 4,
   one launch an iteration) and must agree with the ``"sweep"`` vector.
   The check runs again after a forced slab reclamation and after a
   forced compaction, whose forward view must equal a compaction planned
   by the plain census and chain walk.
   Then, on the same store, **iterators**: an epoch opens on a copy of the
   forward view with one insert-only batch of 65,536 pairs through the
   engine, bit-equal to ``insert_edges_ref`` on a second copy; on the open
   epoch ``updated_edges``, ``updated_lane_mask``'s lanes and the batch's
   inserted edges must be one set, the four incremental WCC schemes
   (``naive``, ``batch``, ``slab_iterator``, ``update_iterator``) from the
   served labels must equal ``wcc_static``, ``csr_snapshot``'s rows the
   view's live counts, and ``slab_iterator`` on the hub (vertex 0) its CSR
   row; on the served views ``bfs_vanilla`` from vertex 0 through the
   transpose's int32 ``sum`` sweeps and through the frontier expansion must
   give the self-check's BFS distances.  Kernel 3 is held to its plain
   version on the int32 ``sum`` call with the largest frontier and timed as
   in phase 2; the phase prints each call's host-clock time.
   Then **durability**, on host copies of the serve's views as booted (the
   serve's device memory is not raised by them) and the serve's three
   update batches, with the serve's maintenance policy (update 2
   compacts): an uninterrupted twin registers PageRank, ``bfs_0``, ``wcc``
   and ``sssp_0`` lazily and applies the three updates with no WAL.  For
   each of ``apply.admitted`` (before the WAL append: the batch is lost
   and fed again) and ``apply.post_wal`` (after it: the log recovers it)
   a fresh store journals to a ``WriteAheadLog``, applies update 1, reads
   the four properties, saves a checkpoint, applies update 2 (a
   compaction), dies in update 3 under the fault, and ``recover``
   (restore onto the card plus WAL replay, the compaction re-derived)
   and re-feeding must give the twin's version, every pool leaf
   ``torch.equal`` to the twin's, its maintenance count, BFS, SSSP and
   WCC bit for bit, PageRank within ``DUR_PR_ATOL``, and an audit with no
   violation.  A disk with less free space than three checkpoints fails
   the phase.  Each site prints checkpoint bytes, save, restore and
   recovery seconds, replay ms per record, WAL record bytes, and the
   update latencies with the WAL beside the twin's.
   Then **sharded**: the serve again with ``--shards 4 --health
   --slo-update-ms 2000 --metrics --metrics-json``, a ``ShardedGraphStore``
   of four shards on the card fed the same batches, with the launch counts
   zeroed before and read after.  Before its first request the booted
   symmetric view's triangles are counted (``triangles_sharded``, int64),
   which must equal phase 4's static count.  The union of the shards' live
   edges must be phase 3's edge set, the last BFS levels and WCC labels
   equal phase 3's bit for bit, PageRank within ``DUR_PR_ATOL`` of it, the
   membership answers equal; no shard pool row may hold a key after an
   EMPTY lane, and ``audit_store`` must find nothing.  The health report
   must sample every request class and be healthy at 2,000 ms; the kernel
   summary must count one ``slab_update.update_shards`` dispatch an update
   and, for every shard pool shape it swept, a steady ``sweep_vertices``
   call no shorter than kernel 3's device time for the cheapest sweep at
   that shape; the probe, commit, sweep, census, chain-walk and count
   kernels must launch.  A planted SLO fault (a 1e-3 ms update target, a
   breaker with ``burn_threshold`` 1.0) must shed the updates after the
   first report.  One ``sharded`` line prints each request's ms beside
   phase 3's, the route imbalance per update, the fixpoints' host reads
   and instrumented waits per iteration, peak memory, the health report
   and the kernel summary.  Its boot hook also saves the booted store.
   Then **mesh**: the sharded store's multi-process rendering.  A stacked
   store restored from that checkpoint replays the stream, recording the
   sha256 of every pool leaf of every shard after each update (its
   answers must equal the sharded phase's); then SHARDS gloo ranks
   sharing the card (``spawn``ed, a ``FileStore`` rendezvous, a 120 s
   group timeout, a parent deadline that kills them) each restore the
   checkpoint, keep their shard (``place_on_mesh``), count the booted
   triangles of the RMAT scale-16 graph restored as SHARDS shards (whose
   stacked count, ``triangles_sharded`` in int64, must first equal
   ``triangles_static`` on the same graph unsharded and hashed) and
   placed on the same mesh (G1 walks the ring: ``ring_shift`` on every
   rotation, the shares summed over the ranks) and serve the stream
   through ``RequestPipeline`` with the three sharded properties, with
   the launch counts zeroed after the placement: every rank's leaf
   digests after every update must equal the stacked shard's, the answers
   the sharded phase's (BFS, WCC and membership bit for bit, PageRank
   within ``MESH_PR_REL / V``) and agree on every rank with equal fixpoint
   counts, the triangle count the stacked SHARDS-shard store's, and every
   rank must launch kernels 1–3 and 5–7.  The ranks
   journal to a ``WriteAheadLog`` (rank 0 writes) and audit every epoch
   (``AuditPolicy(every=1)``), both attached before the placement; before
   the stream's last update every rank saves (a mesh checkpoint, rank 0
   writes), the update is killed after its WAL append
   (``apply.post_wal``), and ``recover(store_cls=ShardedGraphStore,
   device=...)`` onto the card and ``place_on_mesh`` stand in for it: the
   recovered shards' digests must equal the uninterrupted stacked replay's
   after that update, the reads after it the sharded phase's answers,
   every audit (the recovered store's too) be clean and the same on
   every rank, and rank 0's WAL byte-equal to the stacked replay's.  One
   NCCL rank then serves a 1-shard store at RMAT scale 16 (three compacting
   updates, three reads, 1,024 queries) against a 1-shard stacked store,
   with the same WAL, audits, kill and recovery; it also counts the booted
   triangles of the same graph on its mesh, which must equal both stacked
   counts, and launches kernels 1–3 and 5–7.  (The sharded phase's
   scale-20 booted count, held to phase 4's, is not repeated on the
   ranks: on the unhashed shard pools it took ~59 s a rank.)
   The ``mesh`` line prints per request the max over ranks of its ms,
   collective ms and bytes and all-to-all bytes, the fixpoints'
   iterations and host reads, each rank's restore and placement seconds,
   peak memory and launches; the ranks time-slice one card and gloo
   stages through host memory, so these times say nothing of NCCL across
   cards.
4. **triangles** - a second store on the same RMAT scale-20 graph, hashed,
   with the forward and symmetric views and a maintenance policy that
   compacts at a tombstone ratio of 0.0015, serves a live triangle count
   (``read:triangles``) through ``RequestPipeline``: a read, two cycles of
   an insert-only update (49,152 loop-free pairs), a read, a delete-only
   update (16,384 ledger edges) and a read, then 1,024 membership queries.
   The launch counts are zeroed before the property's static count and
   read after the membership check.  Self-checks without the reference:
   Count() over sampled boot edges and over every edge of the top hub
   against numpy's intersections of a host CSR, the maintained count
   against a static recount after the policy's own compaction, the
   symmetric view against the ledger's symmetric closure, and the
   kernel-path membership probe against ``query_edges`` and the closure.
   The intersection count is held against its plain version on the
   inputs it was captured with (the static chunk with the most active
   items, the first Count(G', G') of an insert epoch, the first call whose
   G2 is the batch graph), the membership probe on the member queries;
   both are timed as in phase 2, after the same packed-row check of the
   phase's pools (both views, the captured G1 pools and the batch graph).
   The count's bound counts the compares each probe needs and the filled
   sectors of the rows it reads, beside PR 15's whole-row bound; the
   static count's wall time is printed beside PR 15's (``static_s_pr15``).
5. **lm** - first the attention kernel's build: for each instantiation,
   the registers and spill bytes ``ptxas -v`` reported and the count of
   ``HMMA``/``HGMMA`` instructions in its SASS (``cuobjdump -sass``); every
   one (bf16 and float32, head_dim 64, 128, 256) must spill nothing, and
   every bf16 one run on the tensor cores; nor may any instantiation of
   its backward's three kernels spill.  Then gemma2-9b at its full
   config (42 layers, d_model 3584, bf16, random weights from a seeded
   generator) serves two prompts
   of 8,192 tokens (``lm_batches``, seed 0): request 1 is the prefill
   through ``build_lm_prefill_step`` (one ``flash_attention`` launch per
   layer), requests 2-33 are 32 greedy decode steps through
   ``build_lm_decode_step`` against a cache of 8,224 slots seeded from the
   prefill's.  The launch counts are zeroed just before the prefill and
   read after the last step.  Self-checks without the reference: ``forward``
   over the 8,224 prompt and generated tokens (through the kernel) must
   give the prefill's logits at position 8,191 and each decode step's at
   its position.  The same weights in float32 then serve a prefill and 16
   decode steps against a float32 forward, at a limit that the phase shows
   two planted faults (the position and the ring slot off by one) fail.
   The bf16 prefill runs again, warm, timed and under the profiler.
   Kernel 10 is held to ``attention_ref`` on the q/k/v the prefill gave
   its first local and first global layer, at a limit that fails a
   dropped key tile or a mask edge moved by a tile on the last query tile,
   and timed on the device alone beside PyTorch's SDPA (without softcap,
   which SDPA lacks); its float32 variant is held to ``attention_ref`` on
   the layers of the float32 prefill within the reference test's float32
   tolerance, which the same two planted faults must fail, and timed
   likewise.
   Then **moe**: qwen3-moe-30b-a3b at its full config (48 layers, d_model
   2048, GQA 32/4, head_dim 128, QK norm, 128 experts top-8, d_ff 768,
   vocab 151,936, bf16, 30.5 G parameters from a seeded generator, drawn a
   layer at a time) serves the same two prompts of 8,192 tokens (one
   ``flash_attention`` launch a layer in the prefill) and 32 greedy
   decode steps through ``launch.steps``, printing per layer the share of
   (token, expert) assignments dropped at capacity 1.25.  The prefill's
   logits must equal ``forward``'s over the same prompts within
   ``MOE_PREFILL_ATOL`` (the same T, so the same drops), which the second
   expert dropped and the top-k renormalisation skipped must fail; decode
   at capacity E / K (nothing drops) over the first 256 tokens of each
   prompt and 16 steps must equal forward within ``MOE_DECODE_ATOL``,
   which the position off by one and both MoE faults must fail; kernel
   10 is held to ``attention_ref`` on the first layer's q/k/v.
   Then **train**: gemma-2b at its full config (18 layers, d_model 2048,
   MQA 8/1, head_dim 256, vocab 256,000, 2.51 G parameters from a seeded
   generator; float32 master weights, bf16 compute, remat "full") takes
   TRAIN_STEPS steps of 2 sequences of 4,096 tokens (``lm_batches``; the
   train_4k shape's global batch of 256 cut to 2, MICROBATCH's 2
   microbatches) through ``build_lm_train_step``, with the launch counts
   zeroed before each step and read after: kernel 10's forward 2 x 18 x 2
   times (the forward, then its recompute) and its backward 18 x 2; each
   step prints its ms, tokens/s, loss, gradient norm and peak memory, and
   one warm step runs under the profiler (kernel 10's forward and
   backward, cuBLAS, the rest).  Kernel 10's backward is held to
   ``attention_bwd_ref`` on the (q, k, v, o, lse, dO) layers 0 and 17 saw
   in the first step, on gemma2-9b's first local and global layer and on
   qwen3-moe's layer 0 (their q, k, v from the LM and MoE phases, a seeded
   dO), in bf16 and float32, at BWD_TOL, which three planted faults must
   fail (a dropped tile in dK/dV, delta left out, and on q scaled until
   the scores reach the softcap, the softcap's derivative left out), two
   launches bit-equal; each timed beside its bound and SDPA's backward.
   At 2 layers of the full width (a depth cut): in float32 the step
   through the kernels against the same step through ``attention_ref``
   (loss and every gradient leaf within STEP_TOL, which a planted dropped
   tile fails; the updated parameters within Adam's 2 lr); in bf16 the
   same step twice, and remat off, "full" and "dots", bit for bit, and
   ``train.loop.train`` preempted at step 1 and resumed from its
   checkpoint bit for bit against the run through (free disk checked
   first; the checkpoint's bytes, save and restore seconds printed).
   Then MIND at its full config takes MIND_TRAIN_STEPS steps at
   train_batch (65,536 users), and one step on a 4,096-user slice is held
   to the same step on CPU copies.
   Then **gnn**: the four GNNs (NequIP, MACE, PNA, EquiformerV2) at their
   full configs, float32 without TF32, seeded random weights and AdamW
   through ``build_gnn_train_step``, GNN_STEPS steps and a profiled one
   more on each of GNN_RUNS: ``molecule`` (128 graphs of 30 atoms, 3,840
   nodes, 8,192 edges) and ``full_graph_sm`` (2,708 nodes, 10,556 edges;
   PNA's ``d_in`` 1,433) from the random builders, and ``minibatch_lg``
   (169,984 nodes, 168,960 edges) for PNA, NequIP and MACE, sampled by
   ``data.sampler.sample_khop`` (1,024 seeds, fanout (15, 10)) over the
   ``csr_snapshot`` of the served forward view after its updates (taken
   right after the MIND phase).  Each run prints its step ms, losses,
   gradient norms, peak bytes and the profiled step's kernel time split
   into gathers and scatters, matrix products and the rest; the cells that
   do not fit one card are printed with the tensor that rules them out
   (GNN_NOT_RUN).  Gates: at 2 layers of full width, the loss and every
   gradient leaf on the card against the CPU's (STEP_TOL; PNA's looser, see
   GNN_STEP_TOL), which a planted fault per model must fail (a CG block
   with its output's m order reversed, the attention softmax over senders,
   PNA's min replaced by its max); at full depth, the geometric models'
   energies invariant under a seeded rotation (GNN_INV_TOL), which the CG
   fault must fail.  Then the reference's ``examples/gnn_molecules.py``
   loop at full width: NequIP trains 20 steps on a SlabGraph of 3,840 atoms
   whose intra-molecule bonds are inserted (and every third step deleted)
   through the update engine (kernels 1-2, counted), fed through
   ``edges_from_slab`` into 8,192 edge slots, the card's edges bit-equal to
   the CPU port's on a host copy of the pool every step.
6. **embedding_bag** - kernel 9 through its op on MIND's table (2**21 x 64
   float32, and a bfloat16 copy) for 50-slot history bags from
   ``recsys_batches`` (B = 512 and 65,536), against its plain version and
   ``F.embedding_bag``, timed on the device alone with the L2 warm (``ms``)
   and flushed (``flushed_ms``), beside the bytes its rows gather
   (``gathered_bytes``: valid slots times row bytes, where the bound counts
   each distinct row once).
7. **examples** - the four ``examples/torch_*.py`` in-process, each
   through its ``main``, with the launch counts zeroed before and read
   after each run.  ``torch_quickstart`` and ``torch_streaming_analytics``
   on the card must print what the same example prints on the CPU (the
   plain versions) bit for bit, PageRank's top within 2e-5;
   ``torch_gnn_molecules`` its 20 edge counts bit for bit and its losses
   within EX_GNN_LOSS_TOL of the CPU's, which the same run with one AdamW
   step skipped must fall outside; ``torch_train_lm`` (gemma2-9b's smoke
   config, head_dim 16 run zero-padded to the kernels' 64) trains
   EX_TRAIN_STEPS[0] steps on the card, then resumes in the same
   checkpoint directory to EX_TRAIN_STEPS[1], with finite losses; the
   q, k, v and options of its first local and first global attention call
   then go once more through ``ops.flash_attention`` forward and backward
   (kernel 10 and its backward, 16-wide heads padded to 64) against
   ``attention_ref`` and its autograd on the same inputs and a seeded
   cotangent, within EX_ATTN_TOL (those launches are not the run's).  Each
   must launch its EX_KERNELS (kernel 10 and its backward for the LM).
   One ``examples`` line an example: card and CPU ms, kernels launched.
8. **dryrun** - the dry run and the roofline held to the card.  A worker
   process started right after the build (``--dryrun-worker``, niced and
   pinned to one core; it makes fake tensors only, nothing is allocated
   or launched on the card) traces every cell the script runs at full
   width with the script's own cuts, and the five GNN cells it does not
   run, through ``launch.dryrun.run_cell`` on ``"single"`` with
   ``attn_impl="kernel"`` (the LM steps on CUDA fake tensors, so their
   attention is kernel 10's registered operators, the card's own path).
   The phase prints each cell's predicted peak beside the step's measured
   one (its bytes above what it found allocated, plus its arguments) and
   its roofline floor on one H100 (``roofline.bound_s``: its flops at the
   bf16 peak or its arguments and outputs at the HBM rate, whichever is
   longer) beside the measured median step, with the eager operators'
   traffic time beside them, and checks that no step beats its floor,
   that every prediction lies within DRY_PEAK_FACTOR, that the cells run
   fit the card and GNN_NOT_RUN's do not (``gnn_not_run`` prints their
   predicted peaks), and that gemma-2b's traced step holds kernel 10's
   forward and backward operators with the formula's flops (nothing
   launched).  The worker's end (``worker_done_t_s``) says which phases
   it ran beside.  Then the two meerkat-graph cells run for real
   through ``run_cell`` on the card (kernels 1-3 launched), and
   EquiformerV2 with its three levers is held to the CPU port and timed
   beside its plain step.

Any failed check exits nonzero.  The last lines are the card's name and
power limit, the per-kernel JSON line and ``{"ok": true, "device": ...}``.
Exits nonzero without printing a result when no CUDA card is available or
when the repository's sources are missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SERVE_ARGS = ["--device", "cuda", "--vertices", "1048576",
              "--initial-edges", "16777216", "--batch", "65536",
              "--delete-frac", "0.25", "--maintain",
              "--tombstone-ratio", "0.0015", "--requests", "15",
              "--seed", "0"]
#: the serve's request kinds after ``update``, in its cycle
PROPS = ["pagerank", "bfs_0", "wcc"]
#: the triangles phase: the serve's graph (RMAT scale 20), two update
#: cycles that split the serve's 65,536-edge batch into its insert and
#: delete halves, and the maintenance trigger that compacts at the second
#: delete epoch's close (16,384 tombstones per delete epoch against about
#: 16.1 M forward edges: a ratio of 0.0010, then 0.0020)
TRI_VERTICES, TRI_EDGES = 1 << 20, 1 << 24
TRI_INSERTS, TRI_DELETES, TRI_MEMBER = 49152, 16384, 1024
TRI_TOMBSTONE_RATIO = 0.0015
#: the iterators phase: one insert-only batch of the serve's size on a copy
#: of the served forward view, with ITER_HUB edges out of the hub (vertex
#: 0), ITER_PRESENT edges the graph holds and ITER_DUP in-batch repeats
ITER_BATCH, ITER_HUB, ITER_PRESENT, ITER_DUP = 65536, 4096, 1024, 1024
#: the durability phase: the two kill sites (before and after the WAL
#: append), and PageRank against the twin's, max abs: both stop at an L1
#: step <= 1e-5, and on the card the contributions are summed with float
#: atomics (``index_add_``), so the recovered vector, warm-started from
#: the checkpointed one, need not equal the twin's bit for bit
DUR_SITES = ("apply.admitted", "apply.post_wal")
DUR_PR_ATOL = 2e-5
DUR_PROPS = ("pagerank", "bfs_0", "wcc", "sssp_0")
#: the sharded phase: the serve on SHARDS shards of one card, its update
#: SLO (objective 0.9; property reads 4x, membership 1x), the kernels it
#: must launch, and the seed of its planted SLO fault's batches
SHARDS = 4
SHARD_SLO_UPDATE_MS = 2000
SHARD_KERNELS = ("slab_probe", "slab_commit", "slab_sweep", "slab_live",
                 "slab_chain_rank", "slab_count")
SHARD_FAULT_SEED = 5
#: BFS levels of an unreached vertex (``algorithms.bfs.UNREACHED``)
SHARD_UNREACHED = 2 ** 30
#: the mesh phase: the sharded phase's store as one process a shard, its
#: ranks sharing the card over gloo (NCCL refuses two ranks on one card),
#: a deadline after which the parent kills them, and the kernels they must
#: launch (kernel 7 in the booted triangle count, which both meshes take on
#: the RMAT scale-16 graph); then one NCCL rank at RMAT scale 16 (a 1-shard
#: mesh), its update batches, deletes and maintenance trigger
MESH_BACKEND, MESH_DEVICE = "gloo", "cuda"
MESH_DEADLINE_S = 480
MESH_KERNELS = SHARD_KERNELS
MESH_NCCL_BACKEND = "nccl"
MESH_NCCL_VERTICES, MESH_NCCL_EDGES = 1 << 16, 1 << 20
MESH_NCCL_BATCH, MESH_NCCL_DELETES, MESH_NCCL_RATIO = 8192, 2048, 0.002
#: a mesh job's PageRank against the stacked store's, max abs, as a share
#: of the mean value 1 / V: the same kernel sweeps the same shard and the
#: gathers are exact, but the sweep's sum (``index_add_`` in
#: ``kernels/slab_sweep/ops.py``) adds a vertex's rows with float atomics,
#: so two runs need not agree in the last bits (on an H100: at most
#: 1.2e-9 at V = 2^20, where the limit is 9.5e-9)
MESH_PR_REL = 1e-2
#: the serve phase's kernels; the triangles phase adds the other two
SERVE_KERNELS = ("slab_probe", "slab_commit", "slab_sweep", "slab_live",
                 "slab_chain_rank")
INT32_MAX = 2 ** 31 - 1
#: the LM phase: gemma2-9b serving 2 prompts of 8,192 tokens (a multiple of
#: the 4,096-token window, so the prefill's last-window cache lines up with
#: the decode ring) and 32 greedy tokens (a cut of the request count, to keep
#: the script well inside its time limit)
LM_BATCH, LM_PROMPT, LM_NEW = 2, 8192, 32
#: decode (and prefill) logits against forward's at the same positions.
#: Both are bf16 serves of the same weights; each lands up to ~4.4 (mean
#: ~0.27) from a float32 forward of those weights (the float32 oracle below,
#: printed every run), and at this seed they differ from each other by up
#: to 0.997.  A decode at the position off by one lands 1.63 from forward,
#: one with the ring slots off by one only 1.09 (PERF.md, Findings), so 1.3
#: sits between the clean reading and the position fault; the bf16 noise
#: leaves the ring fault in reach only of the float32 gate below.
LM_LOGIT_ATOL = 1.3
#: decode steps rerun as served and with each planted fault (position off
#: by one, ring slots off by one), in bf16 and in float32
LM_FAULT_STEPS = 16
#: the MoE phase: qwen3-moe-30b-a3b at its full config (48 layers,
#: 128 experts top-8, bf16, random seeded weights) serving the LM phase's
#: LM_BATCH prompts of LM_PROMPT tokens and LM_NEW greedy steps; the decode
#: check runs on the first MOE_SHORT tokens of each prompt and
#: LM_FAULT_STEPS steps at capacity E / K (C = T: nothing drops)
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_SHORT = 256
#: prefill logits against forward's at the same T (the same assignments
#: drop), bf16, max abs: the clean reading is 0 (the same kernels on the
#: same shapes), the planted faults 0.492 (the second expert dropped) and
#: 0.861 (no renormalisation) at seed 0 on an H100 (PERF.md, Findings);
#: each run prints all three and shows both faults fail the gate
MOE_PREFILL_ATOL = 0.125
#: decode logits against forward's at capacity E / K, bf16, max abs over
#: LM_FAULT_STEPS steps: clean 0.278 (decode's T = 2 products round
#: otherwise than forward's), the position off by one 0.340 (rope_theta
#: 1e6 turns a one-step shift by little), the second expert dropped 0.781,
#: no renormalisation 1.059, at seed 0 on an H100: a thin margin, printed
#: every run
MOE_DECODE_ATOL = 0.31
#: the float32 model's prefill and decode against its own forward: float32
#: reordering alone moves them 3.7e-4 at most, the planted faults 0.0125
#: (ring) and 0.147 (position); 2e-3 is about the geometric mean of the
#: clean reading and the smaller fault, and the phase checks both faults
#: fail it
LM_F32_ATOL = 2e-3
#: kernel 10 against attention_ref in bf16: rtol 2e-2 as the reference test
#: (tests/test_kernels.py:47), which covers one bf16 rounding of either
#: output; atol 1e-3, well under the outputs' typical magnitude (the phase
#: prints the mean and per-row median |output| of both captured layers), so
#: that an output near 0 is held to its own scale.  The phase also plants a
#: dropped key tile and a mask edge moved by one tile in a dense float32
#: version of the last query tile and prints whether this tolerance fails
#: them.
ATTN_ATOL, ATTN_RTOL = 1e-3, 2e-2
#: kernel 10 in float32 against attention_ref on the float32 serve's
#: layers: the reference test's float32 tolerance (tests/test_kernels.py:47),
#: which the card test holds it to; the two differ by float32 summation
#: order alone.  A dropped key tile and a mask edge moved by a tile, of
#: the float32 kernel's 32 keys and unrounded, must fail it.
ATTN_F32_ATOL = ATTN_F32_RTOL = 2e-5
#: the float32 kernel's key tile: the width of the faults planted for it
ATTN_F32_KEY_TILE = 32
#: a recorded constant, not a reading of this run: the float32 kernel's
#: largest error against attention_ref on the float32 serve's first local
#: and global layer before its redesign (the kernel of 64-row query tiles
#: and 64-key tiles of commit 63c8e58, in this script's phase 5 at seed 0
#: on an H100 80GB HBM3 at 700.00 W)
F32_ATTN_ERR_RECORDED_BEFORE = {"local": 8.702278137207031e-06,
                                "global": 1.0251998901367188e-05}
#: SDPA against the kernel rerun without softcap: another algorithm, so the
#: reference test's bf16 tolerance
LIB_TOL = 2e-2
#: the EmbeddingBag phase: MIND's table (repro/configs/mind.py: 2**21 items,
#: embed_dim 64, 50-item histories), its serve_p99 and train_batch batches
BAG_ROWS, BAG_DIM, BAG_HIST = 2 ** 21, 64, 50
BAG_BATCHES = (512, 65536)
#: kernel 9 against its plain version (tests/test_kernels.py:176)
BAG_TOL = {"f32": 1e-5, "bf16": 3e-2}
#: the MIND phase: MIND's full config (repro/configs/mind.py) over
#: histories read from the served forward view, its three serving shapes
#: (repro/configs/common.py RECSYS_SHAPES), the users whose histories are
#: held to the per-user ``slab_iterator``, and the users of serve_bulk
#: whose scores are held to the CPU's
MIND_SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand")
MIND_SAMPLE_USERS, MIND_CPU_ROWS = 64, 1024
#: MIND's scores on the card against the same functions on CPU copies,
#: float32 (no TF32): the scores are below 1 in magnitude, and the two
#: devices' products differ by summation order alone
MIND_ATOL, MIND_RTOL = 1e-5, 1e-4
#: H100 SXM published rates (NVIDIA H100 datasheet): HBM3 bytes/s and
#: float32 (non-tensor-core) operations/s, which counts a fused multiply-add
#: as two over 128 float32 lanes per SM
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: int32 operations/s: a Hopper SM has 64 int32 lanes (NVIDIA H100 Tensor
#: Core GPU Architecture whitepaper), half the float32 lanes, and a compare
#: is one operation, so a quarter of the float32 rate at the same clock;
#: the bound of the kernels whose work is key compares
INT32_OPS_PER_S = F32_OPS_PER_S / 4
#: dense bf16 tensor-core operations/s (NVIDIA H100 datasheet): the least
#: time of attention's matrix products on this card
BF16_OPS_PER_S = 989e12
#: PageRank tolerance of the self-check, in L1: both the maintained and the
#: static vector stop at an L1 step <= 1e-5 with damping 0.85, which leaves
#: each within 1e-5 * 0.85 / 0.15 = 5.7e-5 (L1) of the fixed point
PR_L1_TOL = 2.5e-4
#: the ``contrib_impl="ref"`` vector against the ``"sweep"`` one, max-abs:
#: the same iterations over sums of the same lanes in another order (the
#: card test's bound; the H100 read 2.75e-8 in L1)
PR_REF_ABS = 2e-5
#: float sum sweeps add the 128 lanes in another order than the plain
#: version: rounding of the row total, a few float32 ulp
SUM_RTOL = 1e-6
#: the key of an empty lane, as the port's int32 bit pattern
EMPTY_KEY = -2
#: the property's static triangle count (``static_s``) in PR 15's final run
#: of this script (run F: H100 80GB HBM3 at 700.00 W), before the redesign
#: of the intersection count
PR15_STATIC_S = 10.209373804999984


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


#: the script's start on the host clock: each phase line carries its
#: seconds since (``t_s``), so that a run shows where its time went
START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(torch, fn, *, warmup: int = 1, reps: int = 5) -> float:
    """Median time of one call of ``fn`` in ms, from a CUDA event pair
    around each call: for the plain versions, whose host syncs and launch
    gaps are part of their cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, *, flush=None, warmup: int = 3,
              samples: int = 20) -> float:
    """Device time of one call of ``fn`` in ms, for calls that never wait
    for the host: each call is queued between two CUDA events while the
    card spins, so the interval holds the call and no host launch overhead.
    ``flush``, a tensor larger than the L2 cache, is overwritten before each
    call, for a caller that finds the cache cold.  The median of
    ``samples`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 1 << 20                       # clock cycles, ~0.5 ms on an H100
    times = []
    while len(times) < samples:
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        queued_in_time = not a.query()   # the spin outlasted the queuing
        b.synchronize()
        if queued_in_time:
            times.append(a.elapsed_time(b))
        elif spin >= 1 << 30:
            raise SmokeFailure("the host could not queue a timed call "
                               "within the spin")
        else:
            spin <<= 2
    return statistics.median(times)


def busy_time(torch, fn, top: int = 6):
    """One call of ``fn`` under ``torch.profiler``: the card's busy time (the
    sum of its kernels' device time), its kernel count, the wall time of
    the profiled call and the ``top`` kernels by device time.  None when the
    trace holds no device time.  For a call of too many launches to queue
    behind ``device_ms``'s spin (the launch queue fills while the card
    sleeps)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy <= 0:
        return None
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.self_device_time_total / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_ms": busy, "kernels": len(kern),
            "profiled_wall_ms": 1e3 * wall,
            "top_ms": {name[:80]: ms for name, ms in ranked}}


def storage_bytes(torch, *trees) -> int:
    """Bytes of the distinct storages of the tensors in ``trees`` (tensors,
    modules, dicts, lists, tuples and dataclasses of them)."""
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                walk(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    for t in trees:
        walk(t)
    return sum(seen.values())


@contextlib.contextmanager
def step_peak(torch, *args):
    """The peak a step allocates, as the dry run predicts it: its
    arguments' bytes (``args``) plus the most it allocates above what was
    allocated before it (``max_memory_allocated`` over the step less
    ``memory_allocated`` before it), so that what earlier phases leave
    allocated does not count."""
    torch.cuda.synchronize()
    arg_bytes = storage_bytes(torch, *args)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = {}
    yield out
    torch.cuda.synchronize()
    out["bytes"] = torch.cuda.max_memory_allocated() - before + arg_bytes
    out["left_before"] = before - arg_bytes


def in_sorted(np, x, keys):
    """``np.isin(x, keys)`` for sorted unique ``keys``, by binary search
    (``np.isin`` sorts both arrays together on every call)."""
    if not len(keys):
        return np.zeros(len(x), bool)
    return keys[np.minimum(np.searchsorted(keys, x), len(keys) - 1)] == x


def bound(n_bytes: float, n_ops: float, *,
          ops_per_s: float = F32_OPS_PER_S) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes)}


def unpacked_rows(torch, pools) -> int:
    """Rows of the distinct ``pools`` (slab key tensors) with a non-EMPTY
    lane after an EMPTY lane: the sweep and the intersection count read a
    row only up to its first EMPTY lane, which is exact on packed rows."""
    seen, bad = set(), 0
    for keys in pools:
        if keys.data_ptr() in seen:
            continue
        seen.add(keys.data_ptr())
        empty = keys == EMPTY_KEY
        first = torch.where(empty.any(dim=1), empty.byte().argmax(dim=1),
                            keys.shape[1])
        bad += int(((~empty).sum(dim=1) != first).sum())
        del empty, first
    return bad


# ----------------------------------------------------------------------------
# phase 2: capture the main path's kernel inputs, compare and time
# ----------------------------------------------------------------------------

@contextlib.contextmanager
def swapped(module, **fns):
    """Rebind names of ``module`` for the duration of the block."""
    real = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield real
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


def drawn_once(rmat_edges):
    """``rmat_edges`` that draws each (arguments) graph once a run: the
    serve's boots (phases 2, 3 and the sharded phase) and the triangles
    phase draw the same RMAT scale-20 graph, ~17 s of host numpy each.
    Later calls get copies of the first draw's arrays, so each boot still
    builds its store from arrays of its own."""
    drawn = {}

    def draw(n_vertices, n_edges, **kw):
        key = (n_vertices, n_edges, tuple(sorted(kw.items())))
        if key not in drawn:
            drawn[key] = rmat_edges(n_vertices, n_edges, **kw)
        return tuple(a.copy() for a in drawn[key])
    return draw


def capture_serve_inputs(torch, np, serve_mod):
    """Serve the serve phase's first six requests (update, the three reads,
    membership, update) with every kernel call recorded: the first probe and
    commit of each batch size (the forward view's), the first sweep of each
    (semiring, frontier) pair, and the first census and chain walk (the
    forward view's, in the compaction the second update triggers); and the
    pools, for the packed-row check."""
    from repro_torch.kernels.slab_compact import ops as compact_ops
    from repro_torch.kernels.slab_sweep import ops as sweep_ops
    from repro_torch.kernels.slab_update import ops as update_ops
    from repro_torch.stream import RequestPipeline

    real_probe, real_commit = update_ops.slab_probe, update_ops.slab_commit
    real_sweep = sweep_ops.slab_sweep
    real_live, real_chain = compact_ops.slab_live, compact_ops.chain_rank
    got = {"probe": {}, "commit": {}, "sweep": {}}

    def probe(keys, next_slab, start, dst):
        key = start.shape[0]
        if key not in got["probe"]:
            got["probe"][key] = (keys.clone(), next_slab.clone(),
                                 start.clone(), dst.clone())
        return real_probe(keys, next_slab, start, dst)

    def commit(keys, degree, weights, *plan):
        key = plan[0].shape[0]
        if key not in got["commit"]:
            got["commit"][key] = (
                keys.clone(), degree.clone(),
                None if weights is None else weights.clone(),
                *[None if t is None else t.clone() for t in plan])
        return real_commit(keys, degree, weights, *plan)

    def sweep(keys, slab_vertex, values, weights=None, frontier=None,
              target=None, *, semiring, n_vertices):
        key = (semiring, frontier is not None)
        if key not in got["sweep"]:
            got["sweep"][key] = dict(
                keys=keys, slab_vertex=slab_vertex, values=values.clone(),
                weights=weights, target=None if target is None
                else target.clone(), n_vertices=n_vertices,
                frontier=None if frontier is None else frontier.clone())
        return real_sweep(keys, slab_vertex, values, weights, frontier,
                          target, semiring=semiring, n_vertices=n_vertices)

    # compaction builds new pools and leaves the old tensors as they were,
    # so the census and walk inputs are kept without a copy
    def live(keys, slab_vertex):
        got.setdefault("live", (keys, slab_vertex))
        return real_live(keys, slab_vertex)

    def chain(next_slab, live_count, n_buckets):
        got.setdefault("chain", (next_slab, live_count, n_buckets))
        return real_chain(next_slab, live_count, n_buckets)

    # boot exactly as the serve phase does, with no request served yet
    args = serve_mod.parse_args(SERVE_ARGS[:-4] + ["--requests", "0",
                                                   "--seed", "0"])
    out = serve_mod.serve(args, log=lambda s: None)
    store, registry, ledger = out["store"], out["registry"], out["ledger"]
    pairs = serve_mod.EdgeLedger.pairs(ledger.keys)
    reqs = [req for _, req in serve_mod.build_requests(
        args.vertices, (pairs[:, 0], pairs[:, 1]),
        np.random.default_rng(args.seed), n_requests=len(PROPS) + 3,
        batch=args.batch, delete_frac=args.delete_frac, prop_names=PROPS)]
    with swapped(update_ops, slab_probe=probe, slab_commit=commit), \
            swapped(sweep_ops, slab_sweep=sweep), \
            swapped(compact_ops, slab_live=live, chain_rank=chain):
        RequestPipeline(store, registry).run(reqs)
        torch.cuda.synchronize()
    check(store.maintenance_count >= 1,
          "the second update should compact on the policy's trigger")
    got["n_buckets"] = store.forward.n_buckets
    # both views as they stand, and the pools the sweeps and the census
    # read before the compaction replaced them
    got["pools"] = ([store.forward.keys, store.transpose.keys]
                    + [c["keys"] for c in got["sweep"].values()]
                    + ([got["live"][0]] if "live" in got else []))
    return got, store


def probe_walks(torch, keys, next_slab, start, dst) -> dict:
    """The rows the probe must read for these queries: the distinct rows
    (``rows_read``), the longest walk in rows (``longest_walk``) and the
    rows of all walks (``hops``)."""
    cur = start.clone()
    seen = []
    longest = 0
    while True:
        walking = cur != -1
        if not bool(walking.any()):
            break
        longest += 1
        c = cur[walking].long()
        seen.append(c)
        hit = (keys[c] == dst[walking][:, None]).any(dim=1)
        nxt = torch.where(hit, torch.full_like(c, -1),
                          next_slab[c].long())
        cur = torch.full_like(cur, -1)
        cur[walking] = nxt.to(cur.dtype)
    rows = torch.cat(seen) if seen else start[:0].long()
    return {"rows_read": int(torch.unique(rows).numel()),
            "longest_walk": longest, "hops": int(rows.numel())}


def contiguous_links(torch, next_slab, n_buckets: int) -> float:
    """The share of the pool's overflow links (out of rows ``n_buckets``
    up) that are ``r -> r + 1``, None without any: the runs the probe and
    the chain walk read a window at a time."""
    nxt = next_slab[n_buckets:]
    rows = torch.arange(n_buckets + 1, next_slab.shape[0] + 1,
                        device=nxt.device, dtype=nxt.dtype)
    linked = nxt >= 0
    n = int(linked.sum())
    return float((nxt[linked] == rows[linked]).sum()) / n if n else None


def relabelled(torch, next_slab, n_buckets: int, *rows, seed: int = 0):
    """A copy of a pool with its overflow rows (``n_buckets`` up) relabelled
    by a seeded permutation, so that almost no link is ``r -> r + 1``: the
    same chains for the probe and the chain walk, the worst layout for
    their run reading.  ``rows`` are per-row tensors moved with the rows."""
    S, dev = next_slab.shape[0], next_slab.device
    perm = torch.arange(S, device=dev)
    gen = torch.Generator().manual_seed(seed)
    perm[n_buckets:] = n_buckets + torch.randperm(
        S - n_buckets, generator=gen).to(dev)
    nxt = torch.full_like(next_slab, -1)
    nxt[perm] = torch.where(next_slab >= 0, perm[next_slab.clamp_min(
        0).long()].to(next_slab.dtype), next_slab)
    out = []
    for t in rows:
        u = torch.empty_like(t)
        u[perm] = t
        out.append(u)
    return (nxt, *out)


def csr_of_pool(torch, keys, owner, n):
    """The live lanes of a pool as an (S, n) float32 CSR matrix of ones."""
    valid = (keys >= 0) & (keys < n) & (owner[:, None] >= 0)
    rows, lanes = torch.nonzero(valid, as_tuple=True)
    crow = torch.zeros(keys.shape[0] + 1, dtype=torch.int64,
                       device=keys.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=keys.shape[0]), 0)
    return torch.sparse_csr_tensor(
        crow, keys[rows, lanes].long(),
        torch.ones(rows.numel(), dtype=torch.float32, device=keys.device),
        size=(keys.shape[0], n), check_invariants=False)


def degree_runs(torch, deg_idx, n_vertices: int) -> dict:
    """The runs of one live ``deg_idx`` in a commit plan (parked entries
    dropped; the kernel adds each run's deltas with one atomic), the live
    vertices and the longest run."""
    live = deg_idx[(deg_idx >= 0) & (deg_idx < n_vertices)]
    if not live.numel():
        return {"deg_runs": 0, "deg_vertices": 0, "longest_run": 0}
    _, counts = torch.unique_consecutive(live, return_counts=True)
    return {"deg_runs": int(counts.numel()),
            "deg_vertices": int(torch.unique(live).numel()),
            "longest_run": int(counts.max())}


def compare_kernels(torch, got) -> list:
    """Each kernel against its plain version on the captured inputs."""
    from repro_torch.kernels.slab_compact import (chain_rank,
                                                  chain_rank_torch,
                                                  slab_live, slab_live_torch)
    from repro_torch.kernels.slab_sweep import slab_sweep, slab_sweep_ref
    from repro_torch.kernels.slab_update import (slab_commit,
                                                 slab_commit_torch,
                                                 slab_probe,
                                                 slab_probe_torch)
    results = []
    # 256 MiB, five times the L2: the update probes rows no recent kernel
    # touched, so each timed probe (and chain walk) starts with the cache
    # cold
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")

    nb = got["n_buckets"]

    def equal_outputs(k, p):
        return all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(k, p))

    # -- probe: every batch size the update used, on the pool as captured and
    # on a copy with its overflow rows relabelled ----------------------------
    for B, (keys, nxt, start, dst) in sorted(got["probe"].items()):
        k = slab_probe(keys, nxt, start, dst)
        p = slab_probe_torch(keys, nxt, start, dst)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max()) for a, b in
                  zip(k, p))
        check(equal_outputs(k, p),
              f"slab_probe differs from its plain version at B={B}")
        walks = probe_walks(torch, keys, nxt, start, dst)
        hits = int(k[0].sum())
        pnxt, pkeys = relabelled(torch, nxt, nb, keys)
        k = slab_probe(pkeys, pnxt, start, dst)
        p = slab_probe_torch(pkeys, pnxt, start, dst)
        torch.cuda.synchronize()
        check(equal_outputs(k, p), f"slab_probe differs from its plain "
                                   f"version at B={B} on the relabelled pool")
        rows = walks["rows_read"]
        results.append(dict(
            name="slab_probe", variant=f"B={B}", max_abs_err=err,
            ms=device_ms(torch, lambda: slab_probe(keys, nxt, start, dst),
                         flush=flush),
            plain_ms=time_ms(torch,
                             lambda: slab_probe_torch(keys, nxt, start, dst)),
            **walks, hits=hits,
            contiguous_links=contiguous_links(torch, nxt, nb),
            relabelled_ms=device_ms(
                torch, lambda: slab_probe(pkeys, pnxt, start, dst),
                flush=flush),
            relabelled_contiguous_links=contiguous_links(torch, pnxt, nb),
            library_ms=None,
            **bound(rows * (512 + 4) + B * (4 + 4) + B * (1 + 4 + 4),
                    rows * 128, ops_per_s=INT32_OPS_PER_S)))
        del pkeys, pnxt, k, p

    # -- commit: the delete and insert plans ------------------------------------
    for B, (keys, deg, w, *plan) in sorted(got["commit"].items()):
        outs = []
        for fn in (slab_commit, slab_commit_torch):
            kk, dd = keys.clone(), deg.clone()
            ww = None if w is None else w.clone()
            fn(kk, dd, ww, *plan)
            outs.append((kk, dd))
        torch.cuda.synchronize()
        err = max(int((outs[0][i].long() - outs[1][i].long()).abs().max())
                  for i in range(2))
        check(all(torch.equal(outs[0][i], outs[1][i]) for i in range(2)),
              f"slab_commit differs from its plain version at B={B}")
        kk, dd = keys.clone(), deg.clone()
        S, V = keys.shape[0], deg.shape[0]
        live = int(((plan[0] >= 0) & (plan[0] < S)).sum())
        runs = degree_runs(torch, plan[3], V)
        # the same kernel on a plan of the same B with every entry parked:
        # no store and no atomic: the launch, loads and scan alone
        parked = [torch.full_like(plan[0], S), plan[1], plan[2],
                  torch.full_like(plan[3], V), *plan[4:]]
        results.append(dict(
            name="slab_commit", variant=f"B={B}", max_abs_err=err,
            ms=device_ms(torch, lambda: slab_commit(kk, dd, None, *plan)),
            parked_ms=device_ms(torch, lambda: slab_commit(kk, dd, None,
                                                           *parked)),
            plain_ms=time_ms(torch, lambda: slab_commit_torch(
                kk, dd, None, *plan)),
            live_lanes=live, **runs, library_ms=None,
            **bound(B * 5 * 4 + live * 4 + runs["deg_vertices"] * 8, B,
                    ops_per_s=INT32_OPS_PER_S)))

    # -- sweep: the four semirings, with and without frontier -------------------
    base = got["sweep"][("min_plus", True)]
    f_any = base["frontier"]
    keys, owner = base["keys"], base["slab_vertex"]
    S, n = keys.shape[0], base["n_vertices"]
    dist = base["values"]
    tgt = got["sweep"][("arg_min_plus", True)]["target"]
    rows_alloc = int((owner >= 0).sum())
    filled = int(((keys != EMPTY_KEY) & (owner >= 0)[:, None]).sum())
    unpacked = unpacked_rows(torch, got["pools"])
    check(unpacked == 0, f"{unpacked} rows of the serve's pools hold a key "
                         f"after an EMPTY lane")
    for semiring in ("sum", "min", "min_plus", "arg_min_plus"):
        for use_f in (False, True):
            cap = got["sweep"].get((semiring, use_f))
            values = cap["values"] if cap is not None else dist
            frontier = f_any if use_f else None
            target = tgt if semiring == "arg_min_plus" else None
            k = slab_sweep(keys, owner, values, None, frontier, target,
                           semiring=semiring, n_vertices=n)
            p = slab_sweep_ref(keys, owner, values, semiring=semiring,
                               n_vertices=n, frontier=frontier,
                               target=target)
            torch.cuda.synchronize()
            if semiring == "sum":
                err = float((k - p).abs().max())
                check(err <= SUM_RTOL * float(p.abs().max()) + 1e-30,
                      f"sum sweep off by {err}")
            else:
                err = int((k.long() - p.long()).abs().max()) \
                    if k.dtype == torch.int32 else float((k - p).abs().max())
                check(torch.equal(k, p),
                      f"{semiring} sweep differs from its plain version")
            # the filled lanes' keys; owner and output of every row;
            # values and frontier once each, target per allocated row; two
            # operations per filled lane.  PR 15's bound charged the whole
            # 512 B of every allocated row's keys
            rest = (S * (4 + 4) + n * 4 + (n if use_f else 0)
                    + (rows_alloc * 4 if target is not None else 0))
            whole_rows = bound(rows_alloc * 512 + rest, S * 128 * 2)
            library_ms = None
            if semiring == "sum" and not use_f:
                # the same sums as one sparse product: the pool's live lanes
                # as an (S, n) CSR matrix of ones (built outside the timing)
                a = csr_of_pool(torch, keys, owner, n)
                lib = torch.mv(a, values)
                torch.cuda.synchronize()
                check(float((lib - p).abs().max())
                      <= SUM_RTOL * float(p.abs().max()) + 1e-30,
                      "the CSR product disagrees with the sum sweep")
                library_ms = device_ms(torch, lambda: torch.mv(a, values))
                del a
            results.append(dict(
                name="slab_sweep",
                variant=f"{semiring}{'+frontier' if use_f else ''}"
                        f"{' (main path)' if cap is not None else ''}",
                max_abs_err=err,
                ms=device_ms(torch, lambda: slab_sweep(
                    keys, owner, values, None, frontier, target,
                    semiring=semiring, n_vertices=n)),
                plain_ms=time_ms(torch, lambda: slab_sweep_ref(
                    keys, owner, values, semiring=semiring, n_vertices=n,
                    frontier=frontier, target=target)),
                library_ms=library_ms, rows=S, rows_allocated=rows_alloc,
                filled_lanes=filled, unpacked_rows=unpacked,
                whole_row_bound_ms=whole_rows["bound_ms"],
                whole_row_bound_by=whole_rows["bound_by"],
                **bound(filled * 4 + rest, filled * 2)))

    # -- kernel 4: PageRank's contribution sums through their op, on the
    # served transpose pool with PageRank's contrib ---------------------------
    results.append(contrib_sums_row(torch, got["sweep"][("sum", False)]))

    # -- census: the forward view's pool at its first compaction ----------------
    keys, owner = got["live"]
    k = slab_live(keys, owner)
    p = slab_live_torch(keys, owner)
    torch.cuda.synchronize()
    check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(k, p)),
          "slab_live differs from its plain version")
    S = keys.shape[0]
    rows_alloc = int((owner >= 0).sum())
    # keys of allocated rows, owner and count of every row, a rank per lane;
    # no single PyTorch call computes the census, so no library time
    results.append(dict(
        name="slab_live", variant="forward view",
        max_abs_err=max(int((a - b).abs().max()) for a, b in zip(k, p)),
        ms=device_ms(torch, lambda: slab_live(keys, owner)),
        plain_ms=time_ms(torch, lambda: slab_live_torch(keys, owner)),
        rows=S, rows_allocated=rows_alloc, live_lanes=int(p[0].sum()),
        library_ms=None,
        **bound(rows_alloc * 512 + S * (4 + 4 + 512), S * 128,
                ops_per_s=INT32_OPS_PER_S)))
    del k, p

    # -- chain walk: the same compaction's plan, and on a copy with the
    # overflow rows relabelled -------------------------------------------------
    nxt, cnt, nb = got["chain"]
    k = chain_rank(nxt, cnt, nb)
    p = chain_rank_torch(nxt, cnt, nb)
    torch.cuda.synchronize()
    check(equal_outputs(k, p),
          "slab_chain_rank differs from its plain version")
    err = max(int((a - b).abs().max()) for a, b in zip(k, p))
    visited = int((p[1] >= 0).sum())
    longest = int(p[2].max()) + 1
    pnxt, pcnt = relabelled(torch, nxt, nb, cnt)
    k = chain_rank(pnxt, pcnt, nb)
    p = chain_rank_torch(pnxt, pcnt, nb)
    torch.cuda.synchronize()
    check(equal_outputs(k, p), "slab_chain_rank differs from its plain "
                               "version on the relabelled pool")
    del k, p
    # next and count of each visited row, three outputs for every row, a
    # count per bucket
    results.append(dict(
        name="slab_chain_rank", variant="forward view", max_abs_err=err,
        ms=device_ms(torch, lambda: chain_rank(nxt, cnt, nb), flush=flush),
        plain_ms=time_ms(torch, lambda: chain_rank_torch(nxt, cnt, nb)),
        buckets=nb, slabs_visited=visited, longest_chain=longest,
        contiguous_links=contiguous_links(torch, nxt, nb),
        relabelled_ms=device_ms(torch, lambda: chain_rank(pnxt, pcnt, nb),
                                flush=flush),
        relabelled_contiguous_links=contiguous_links(torch, pnxt, nb),
        library_ms=None,
        **bound(visited * (4 + 4) + nxt.shape[0] * 3 * 4 + nb * 4,
                visited, ops_per_s=INT32_OPS_PER_S)))
    del pnxt, pcnt
    for r in results:
        emit({"phase": "kernels", **r})
    return results


def rotated_rows(torch, keys, *, seed: int):
    """A copy of ``keys`` (S, 128) with each row's lanes rotated right by a
    seeded amount in [1, its EMPTY lanes]: a packed row's EMPTY lanes come
    first, and its keys follow them."""
    S, W = keys.shape
    n_empty = (keys == EMPTY_KEY).sum(dim=1)
    gen = torch.Generator(device=keys.device).manual_seed(seed)
    u = torch.rand(S, generator=gen, device=keys.device)
    shift = 1 + (u * n_empty).long().clamp(max=W - 1)
    lane = torch.arange(W, device=keys.device)
    return torch.gather(keys, 1, (lane[None, :] - shift[:, None]) % W)


def contrib_sums_row(torch, cap) -> dict:
    """Kernel 4 (``kernels/slab_pagerank``, ``csrc/slab_pagerank.cu``) on a
    captured PageRank sweep.  The op is not on the serve (PageRank sweeps
    through kernel 3's ``sweep_partials``), so it is driven here as a path
    of its own: one call of the op (``slab_contrib_sums``) with the launch
    counts zeroed just before and read just after (``launches``: its
    kernel once, kernel 3 never), held to ``ref.slab_contrib_sums_ref``
    within SUM_RTOL of the row totals; then the kernel again on a seeded
    copy of the pool whose rows' lanes are rotated so that EMPTY lanes come
    first (``rotated_rows``), held to its plain version there too, beside
    kernel 3's error on that copy (``sweep_err_unpacked``; kernel 3 reads a
    row only up to its first EMPTY lane).  Timed on the device alone
    (``ms``; ``unpacked_ms`` on the copy) and per call of the op
    (``op_ms``: the owner mask from ``valid`` and the launch), beside the
    plain version and the CSR product.  The function sums every lane, so
    its bound reads every allocated row whole."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.slab_pagerank import (slab_contrib_sums,
                                                   slab_contrib_sums_cuda,
                                                   slab_contrib_sums_ref)
    from repro_torch.kernels.slab_sweep import slab_sweep

    keys, owner, contrib = cap["keys"], cap["slab_vertex"], cap["values"]
    n = cap["n_vertices"]
    check(contrib.numel() == n, "PageRank's contrib is not one per vertex")
    # pool_edges(view).valid of the captured pool
    valid = (owner[:, None] >= 0) & (keys >= 0) & (keys < n)
    runtime.reset_launches()
    k = slab_contrib_sums(keys, valid, contrib)
    torch.cuda.synchronize()
    launched = {name: c for name, c in runtime.LAUNCHES.items() if c}
    check(launched == {"slab_contrib_sums": 1},
          f"one call of the op launched {launched}, not kernel 4 once")
    p = slab_contrib_sums_ref(keys, owner, contrib, n_vertices=n)
    err = float((k - p).abs().max())
    tol = SUM_RTOL * float(p.abs().max()) + 1e-30
    check(err <= tol, f"slab_contrib_sums off by {err}")
    del k

    rot = rotated_rows(torch, keys, seed=0)
    unpacked = unpacked_rows(torch, [rot])
    check(unpacked > 0, "the rotated pool holds no unpacked row")
    ku = slab_contrib_sums_cuda(rot, owner, contrib, n_vertices=n)
    pu = slab_contrib_sums_ref(rot, owner, contrib, n_vertices=n)
    su = slab_sweep(rot, owner, contrib, semiring="sum", n_vertices=n)
    torch.cuda.synchronize()
    err_u = float((ku - pu).abs().max())
    tol_u = SUM_RTOL * float(pu.abs().max()) + 1e-30
    check(err_u <= tol_u,
          f"slab_contrib_sums off by {err_u} on the rotated pool")
    sweep_err_u = float((su - pu).abs().max())
    check(sweep_err_u > tol_u, "kernel 3 agrees with kernel 4 on the "
          "rotated pool: the copy does not tell the two functions apart")
    del ku, pu, su

    S = keys.shape[0]
    rows_alloc = int((owner >= 0).sum())
    filled = int(((keys != EMPTY_KEY) & (owner >= 0)[:, None]).sum())
    a = csr_of_pool(torch, keys, owner, n)
    library_ms = device_ms(torch, lambda: torch.mv(a, contrib))
    del a
    row = dict(
        name="slab_contrib_sums", variant="PageRank contrib (transpose view)",
        max_abs_err=max(err, err_u),
        ms=device_ms(torch, lambda: slab_contrib_sums_cuda(
            keys, owner, contrib, n_vertices=n)),
        unpacked_ms=device_ms(torch, lambda: slab_contrib_sums_cuda(
            rot, owner, contrib, n_vertices=n)),
        op_ms=time_ms(torch, lambda: slab_contrib_sums(keys, valid,
                                                       contrib)),
        plain_ms=time_ms(torch, lambda: slab_contrib_sums_ref(
            keys, owner, contrib, n_vertices=n)),
        library_ms=library_ms, rows=S, rows_allocated=rows_alloc,
        filled_lanes=filled, unpacked_rows=unpacked,
        max_abs_err_unpacked=err_u, sweep_err_unpacked=sweep_err_u,
        launches=launched["slab_contrib_sums"],
        # every allocated row's 512 B of keys, owner and output of every
        # row, contrib once; a compare of every lane read
        **bound(rows_alloc * 512 + S * (4 + 4) + n * 4, rows_alloc * 128,
                ops_per_s=INT32_OPS_PER_S))
    del rot
    return row


# ----------------------------------------------------------------------------
# phase 3: serve at full size, then the self-check
# ----------------------------------------------------------------------------

def static_reference(torch, np, out) -> dict:
    """What the served state must equal, from the edge ledger alone: a
    static rebuild's BFS tree and PageRank, and scipy's weak components
    labelled by their minimum vertex."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from repro_torch.algorithms import bfs_tree_static, pagerank
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import EdgeLedger
    from repro_torch.stream import GraphStore

    store, ledger = out["store"], out["ledger"]
    V, dev = store.n_vertices, store.device
    pairs = EdgeLedger.pairs(ledger.keys)
    static = GraphStore.from_edges(V, pairs[:, 0], pairs[:, 1],
                                   hashing=False, with_symmetric=False,
                                   device=dev)
    tree, _ = bfs_tree_static(static.forward, 0, edge_capacity=1,
                              g_in=static.transpose)
    pr, iters = pagerank(static.transpose, static.out_degree)
    # the reference's default pool sweep, kernel 4: one launch an iteration
    before = dict(runtime.LAUNCHES)
    t0 = time.perf_counter()
    pr_ref, iters_ref = pagerank(static.transpose, static.out_degree,
                                 contrib_impl="ref")
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    k4 = runtime.LAUNCHES["slab_contrib_sums"] - before["slab_contrib_sums"]
    k3 = runtime.LAUNCHES["slab_sweep"] - before["slab_sweep"]
    check(k4 == iters_ref and k3 == 0,
          f"PageRank with contrib_impl='ref' ran {iters_ref} iterations "
          f"with {k4} launches of kernel 4 and {k3} of kernel 3")
    check(iters_ref == iters, f"PageRank with contrib_impl='ref' ran "
          f"{iters_ref} iterations, with 'sweep' {iters}")
    l1_ref = float((pr_ref - pr).abs().sum())
    abs_ref = float((pr_ref - pr).abs().max())
    check(l1_ref <= PR_L1_TOL and abs_ref <= PR_REF_ABS,
          f"PageRank with contrib_impl='ref' is {l1_ref} (L1) and "
          f"{abs_ref} (max-abs) from the 'sweep' vector")
    adj = coo_matrix((np.ones(len(pairs), np.int8),
                      (pairs[:, 0].astype(np.int64),
                       pairs[:, 1].astype(np.int64))), shape=(V, V))
    n_comp, comp = connected_components(adj, directed=True,
                                        connection="weak")
    lowest = np.full(n_comp, V, np.int64)
    np.minimum.at(lowest, comp, np.arange(V))
    return {"tree": tree, "pagerank": pr, "pagerank_iters": iters,
            "wcc": torch.from_numpy(lowest[comp].astype(np.int32)).to(dev),
            "components": int(n_comp),
            "pagerank_ref": {"iters": iters_ref, "sweep_iters": iters,
                             "l1_vs_sweep": l1_ref,
                             "max_abs_vs_sweep": abs_ref,
                             "slab_contrib_sums_launches": k4,
                             "seconds": ref_s}}


def check_state(torch, np, out, want, stage: str) -> dict:
    """Hold the served state to the static reference."""
    from repro_torch.core.worklist import pool_edges
    from repro_torch.launch.serve import EdgeLedger, pair_keys

    store, registry, ledger = out["store"], out["registry"], out["ledger"]
    V = store.n_vertices
    dev = store.device
    t0 = time.perf_counter()
    split = {}

    # the maintained forward view holds exactly the ledger's edges
    view = pool_edges(store.forward)
    rows, lanes = torch.nonzero(view.valid, as_tuple=True)
    live = (store.forward.slab_vertex[rows].long() << 32) | \
        store.forward.keys[rows, lanes].long()
    live = torch.sort(live).values
    ledger_keys = torch.from_numpy(ledger.keys.astype(np.int64)).to(dev)
    check(live.numel() == ledger_keys.numel()
          and torch.equal(live, ledger_keys),
          f"{stage}: forward view holds {live.numel()} edges, ledger "
          f"{ledger_keys.numel()}")
    check(store.n_edges == len(ledger),
          f"{stage}: n_edges disagrees with the ledger")
    split["edge_set_s"] = time.perf_counter() - t0

    tree = registry.read("bfs_0")
    check(torch.equal(tree.dist, want["tree"].dist)
          and torch.equal(tree.parent, want["tree"].parent),
          f"{stage}: maintained BFS tree differs from the static one")
    pr = registry.read("pagerank")
    l1 = float((pr - want["pagerank"]).abs().sum())
    check(l1 <= PR_L1_TOL, f"{stage}: PageRank L1 distance {l1} > "
          f"{PR_L1_TOL}")
    labels = registry.read("wcc")
    check(torch.equal(labels, want["wcc"]),
          f"{stage}: WCC labels differ from scipy's weak components")
    split["properties_s"] = time.perf_counter() - t0

    # membership: the last member request saw the final graph
    rng = np.random.default_rng(1)
    kind, req, resp, _ = out["responses"][-1]
    check(kind == "member", "the stream should end on a membership query")
    q = pair_keys(req.src, req.dst)
    check(np.array_equal(resp.payload["found"],
                         in_sorted(np, q, ledger.keys)),
          f"{stage}: membership answers disagree with the ledger")
    sample = ledger.keys[rng.choice(len(ledger), 4096, replace=False)]
    sp = EdgeLedger.pairs(sample)
    qs = np.concatenate([sp[:, 0], rng.integers(0, V, 4096)])
    qd = np.concatenate([sp[:, 1], rng.integers(0, V, 4096)])
    found = store.query(qs, qd)
    check(np.array_equal(found,
                         in_sorted(np, pair_keys(qs, qd), ledger.keys)),
          f"{stage}: membership answers disagree with the ledger")
    return {"stage": stage, "edges": int(live.numel()),
            "bfs_reachable": int((tree.dist < 2 ** 30).sum()),
            "pagerank_l1": l1, "pagerank_static_iters":
            want["pagerank_iters"], "components": want["components"],
            "member_hits": int(found.sum()),
            "split_s": {**split, "membership_s": time.perf_counter() - t0}}


def check_maintenance(torch, np, out, want) -> list:
    """Force a slab reclamation and then a compaction on the served store,
    checking the state after each; the compacted forward view must equal a
    compaction of the same pool planned by the plain census and chain walk,
    and hold no tombstone."""
    from repro_torch.core.slab_graph import FIELDS, pool_stats
    from repro_torch.kernels.slab_compact import (chain_rank_torch, compact,
                                                  ops as compact_ops,
                                                  slab_live_torch)

    store = out["store"]
    done = []
    t0 = time.perf_counter()
    rec = store.maintain(action="reclaim")
    torch.cuda.synchronize()
    done.append({**check_state(torch, np, out, want, "after reclaim"),
                 "reclaimed": rec.reclaimed, "duration_s": rec.duration_s,
                 "scan_s": rec.scan_s,
                 "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    before = store.forward      # compaction leaves these tensors as they are
    rec = store.maintain(action="compact")
    torch.cuda.synchronize()
    rep = rec.reports["forward"]
    with swapped(compact_ops, slab_live=slab_live_torch,
                 chain_rank=chain_rank_torch):
        plain, plain_rep = compact(before, capacity_slabs=rep.new_capacity)
    torch.cuda.synchronize()
    for name in FIELDS:
        a, b = getattr(store.forward, name), getattr(plain, name)
        check((a is None and b is None) or torch.equal(a, b),
              f"compacted forward view: {name} differs from the plain "
              f"versions' compaction")
    check(torch.equal(rep.perm, plain_rep.perm),
          "compaction perm differs from the plain versions'")
    del before, plain
    tombs = pool_stats(store.forward)["tombstone_lanes"]
    check(tombs == 0, f"{tombs} tombstones after the compaction")
    done.append({**check_state(torch, np, out, want, "after compaction"),
                 "compaction": rec.describe(), "duration_s": rec.duration_s,
                 "scan_s": rec.scan_s,
                 "live_slabs": rep.live_slabs,
                 "seconds": time.perf_counter() - t0})
    return done


# ----------------------------------------------------------------------------
# the iterators phase: the iterator API and its consumers on the served store
# ----------------------------------------------------------------------------

def clone_graph(g, device=None):
    """A copy of a SlabGraph whose tensors the engine may mutate, on
    ``device`` (the graph's own by default)."""
    from repro_torch.core.slab_graph import FIELDS
    return dataclasses.replace(g, **{
        name: None if getattr(g, name) is None
        else getattr(g, name).to(device or g.device, copy=True)
        for name in FIELDS})


def edge_keys(torch, src, dst):
    """Edges as sorted int64 keys ``src << 32 | dst`` (dst as uint32)."""
    return torch.sort((src.long() << 32) | (dst.long() & 0xFFFFFFFF)).values


def iterator_batch(np, V: int, ledger):
    """The phase's insert-only batch of ITER_BATCH pairs: ITER_HUB edges
    out of vertex 0, uniform pairs, ITER_PRESENT edges the graph already
    holds and ITER_DUP repeats of the batch's own pairs; and the keys the
    insert must add (``pair_keys``)."""
    from repro_torch.launch.serve import EdgeLedger, pair_keys

    rng = np.random.default_rng(3)
    n_rand = ITER_BATCH - ITER_HUB - ITER_PRESENT - ITER_DUP
    src = np.concatenate([np.zeros(ITER_HUB, np.int64),
                          rng.integers(0, V, n_rand)])
    dst = rng.integers(0, V, ITER_HUB + n_rand)
    present = EdgeLedger.pairs(ledger.keys[rng.choice(
        len(ledger), ITER_PRESENT, replace=False)]).astype(np.int64)
    dup = rng.choice(len(src), ITER_DUP, replace=False)
    src = np.concatenate([src, present[:, 0], src[dup]])
    dst = np.concatenate([dst, present[:, 1], dst[dup]])
    keys = pair_keys(src, dst)
    new = np.unique(keys[~in_sorted(np, keys, ledger.keys)])
    return src.astype(np.int32), dst.astype(np.int32), new


def iterators_phase(torch, np, out, want) -> dict:
    """The iterator API and the whole-pool oracle on the served store (RMAT
    scale 20, hashing off), against the static reference ``want``.

    An epoch opens on a copy of the forward view: one insert-only batch
    through the engine (kernels 1 and 2), the same batch through
    ``insert_edges_ref`` on a second copy, pools and masks bit-equal.  On
    the open epoch: ``updated_edges`` against ``updated_lane_mask``'s lanes
    and the batch's inserted edges; the four incremental WCC schemes from
    the served labels against ``wcc_static``; ``csr_snapshot`` against the
    per-vertex live counts; ``slab_iterator`` on the hub against its CSR
    row.  On the served views: ``bfs_vanilla`` from vertex 0 through the
    transpose's int32 ``sum`` sweeps and through the frontier expansion,
    against the static BFS tree.  Then kernel 3 on the sweep call with the
    largest frontier, against its plain version, timed as in phase 2."""
    from repro_torch.algorithms import (UNREACHED, bfs_vanilla,
                                        wcc_incremental_batch,
                                        wcc_incremental_naive,
                                        wcc_incremental_slab_iterator,
                                        wcc_incremental_update_iterator,
                                        wcc_static)
    from repro_torch.core import (csr_snapshot, ensure_capacity, next_pow2,
                                  pool_edges, slab_iterator,
                                  updated_lane_mask, updated_vertices)
    from repro_torch.core.worklist import updated_edges
    from repro_torch.core.batch import insert_edges
    from repro_torch.core.slab_graph import FIELDS
    from repro_torch.kernels import runtime
    from repro_torch.kernels.slab_sweep import ops as sweep_ops
    from repro_torch.kernels.slab_sweep import slab_sweep, slab_sweep_ref
    from repro_torch.kernels.slab_update import insert_edges_ref

    t_phase = time.perf_counter()
    store, ledger = out["store"], out["ledger"]
    V, dev = store.n_vertices, store.device
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        return r

    # -- an open epoch: the engine and the oracle on the same batch ----------
    src, dst, new = iterator_batch(np, V, ledger)
    bsrc = torch.from_numpy(src).to(dev)
    bdst = torch.from_numpy(dst).to(dev)
    base = ensure_capacity(clone_graph(store.forward), ITER_BATCH + 64)
    g = clone_graph(base)
    runtime.reset_launches()
    g, inserted = timed("engine_insert", lambda: insert_edges(g, bsrc, bdst))
    engine_launches = {k: runtime.LAUNCHES[k]
                       for k in ("slab_probe", "slab_commit")}
    check(all(engine_launches.values()),
          f"the engine's insert launched {engine_launches}")
    oracle, inserted_o = timed("oracle_insert",
                               lambda: insert_edges_ref(base, bsrc, bdst))
    for name in FIELDS:
        a, b = getattr(g, name), getattr(oracle, name)
        check((a is None and b is None) or torch.equal(a, b),
              f"the engine's insert differs from insert_edges_ref in {name}")
    check(torch.equal(inserted, inserted_o),
          "the engine's inserted mask differs from insert_edges_ref's")
    del oracle, inserted_o, base
    want_new = torch.from_numpy(new.astype(np.int64)).to(dev)
    check(torch.equal(edge_keys(torch, bsrc[inserted], bdst[inserted]),
                      want_new),
          "the inserted edges are not the batch's new pairs")

    # -- the UpdateIterator: the walk, the lane mask, the batch --------------
    flagged = int(g.upd_flag.sum())
    ef = timed("updated_edges", lambda: updated_edges(
        g, max_buckets=2 * ITER_BATCH, out_capacity=2 * ITER_BATCH))
    check(flagged <= 2 * ITER_BATCH and not bool(ef.overflow),
          f"updated_edges overflowed ({flagged} flagged buckets)")
    n = int(ef.size)
    mask = timed("updated_lane_mask", lambda: updated_lane_mask(g))
    rows, lanes = torch.nonzero(mask, as_tuple=True)
    del mask
    check(torch.equal(edge_keys(torch, ef.src[:n], ef.dst[:n]), want_new)
          and torch.equal(edge_keys(torch, g.slab_vertex[rows],
                                    g.keys[rows, lanes]), want_new),
          "updated_edges, the lane mask and the inserted edges disagree")
    del ef, rows, lanes

    # -- the four incremental WCC schemes from the served labels --------------
    labels = want["wcc"]
    static = timed("wcc_static", lambda: wcc_static(g))
    touched = updated_vertices(g)
    cap_slab = next_pow2(int(g.degree[touched].sum()) + 1)
    schemes = {
        "naive": lambda: wcc_incremental_naive(labels, g),
        "batch": lambda: wcc_incremental_batch(labels, bsrc, bdst, inserted),
        "slab_iterator": lambda: wcc_incremental_slab_iterator(
            labels, g, cap=cap_slab),
        "update_iterator": lambda: wcc_incremental_update_iterator(
            labels, g, cap=2 * ITER_BATCH)}
    for name, fn in schemes.items():
        got = timed(f"wcc_{name}", fn)
        check(torch.equal(got, static),
              f"WCC's {name} scheme differs from wcc_static after the batch")
    components = int((static == torch.arange(V, device=dev)).sum())
    del static, got

    # -- CSR and the hub's SlabIterator ---------------------------------------
    csr = timed("csr_snapshot", lambda: csr_snapshot(
        g, max_edges=next_pow2(int(g.n_edges))))
    view = pool_edges(g)
    live = torch.zeros(V, dtype=torch.int64, device=dev).index_add_(
        0, g.slab_vertex.clamp_min(0).long(), view.valid.sum(dim=1))
    del view
    check(torch.equal(csr.indptr.diff().long(), live)
          and torch.equal(live, g.degree.long())
          and int(csr.n_edges) == int(g.n_edges),
          "csr_snapshot's rows disagree with the view's live counts")
    hub = int(live[0])
    nbrs, cnt = timed("slab_iterator_hub", lambda: slab_iterator(
        g, 0, max_neighbors=hub))
    check(int(cnt) == hub and torch.equal(
        torch.sort(nbrs).values, torch.sort(csr.indices[:hub]).values),
          "slab_iterator on vertex 0 differs from its CSR row")
    hub_slabs = int((g.slab_vertex == 0).sum())
    del csr, nbrs, g, touched

    # -- vanilla BFS on the served views, both bodies -------------------------
    fwd, tr = store.forward, store.transpose
    cap_bfs = next_pow2(int(fwd.n_edges))
    runtime.reset_launches()
    lv_sweep, it_sweep = timed("bfs_vanilla_sweep", lambda: bfs_vanilla(
        fwd, src=0, edge_capacity=cap_bfs, g_in=tr))
    sweep_launches = runtime.LAUNCHES["slab_sweep"]
    lv_expand, it_expand = timed("bfs_vanilla_expand", lambda: bfs_vanilla(
        fwd, src=0, edge_capacity=cap_bfs))
    dist = want["tree"].dist
    reached = dist < 1e29
    check(torch.equal(lv_sweep, lv_expand) and it_sweep == it_expand,
          "bfs_vanilla's sweep and expansion bodies disagree")
    check(torch.equal(lv_sweep < UNREACHED, reached)
          and torch.equal(lv_sweep[reached].float(), dist[reached]),
          "bfs_vanilla's levels differ from the static BFS tree")
    check(sweep_launches == it_sweep,
          f"bfs_vanilla launched the sweep {sweep_launches} times in "
          f"{it_sweep} levels")
    reached_n = int(reached.sum())
    del lv_expand, dist, reached

    # -- kernel 3's int32 sum on the level with the largest frontier ----------
    calls = []
    real_sweep = sweep_ops.slab_sweep

    def capture(keys, slab_vertex, values, weights=None, frontier=None,
                target=None, *, semiring, n_vertices):
        calls.append((keys, slab_vertex, values.clone()))
        return real_sweep(keys, slab_vertex, values, weights, frontier,
                          target, semiring=semiring, n_vertices=n_vertices)

    with swapped(sweep_ops, slab_sweep=capture):
        lv, _ = bfs_vanilla(fwd, src=0, edge_capacity=cap_bfs, g_in=tr)
    check(torch.equal(lv, lv_sweep), "a second bfs_vanilla run differs")
    keys, owner, vals = max(calls, key=lambda c: int(c[2].count_nonzero()))
    del calls, lv, lv_sweep
    check(vals.dtype == torch.int32, "bfs_vanilla should sweep int32 values")
    unpacked = unpacked_rows(torch, [keys])
    check(unpacked == 0, f"{unpacked} rows of the transpose view hold a key "
                         f"after an EMPTY lane")
    k = slab_sweep(keys, owner, vals, semiring="sum", n_vertices=V)
    p = slab_sweep_ref(keys, owner, vals, semiring="sum", n_vertices=V)
    torch.cuda.synchronize()
    check(k.dtype == p.dtype == torch.int32 and torch.equal(k, p),
          "the int32 sum sweep differs from its plain version")
    S = keys.shape[0]
    filled = int(((keys != EMPTY_KEY) & (owner >= 0)[:, None]).sum())
    # the same sums as one sparse product, where PyTorch's CSR product
    # takes int32 values (the pool's live lanes as a matrix of ones)
    ones = csr_of_pool(torch, keys, owner, V)
    ones = torch.sparse_csr_tensor(
        ones.crow_indices(), ones.col_indices(),
        ones.values().to(torch.int32), size=ones.shape,
        check_invariants=False)
    try:
        lib = torch.mv(ones, vals)
    except RuntimeError as e:
        library, library_ms = f"torch.mv raises: {str(e)[:160]}", None
    else:
        check(torch.equal(lib, p), "the int32 CSR product disagrees with "
                                   "the int32 sum sweep")
        library = "torch.mv, int32 CSR"
        library_ms = device_ms(torch, lambda: torch.mv(ones, vals))
    del ones
    # the filled lanes' keys, owner and output of every row, the values
    # once; two integer operations per filled lane
    row = dict(
        name="slab_sweep", variant="sum int32 (bfs_vanilla)",
        max_abs_err=int((k.long() - p.long()).abs().max()),
        ms=device_ms(torch, lambda: slab_sweep(keys, owner, vals,
                                               semiring="sum",
                                               n_vertices=V)),
        plain_ms=time_ms(torch, lambda: slab_sweep_ref(
            keys, owner, vals, semiring="sum", n_vertices=V)),
        library_ms=library_ms, library=library, rows=S,
        rows_allocated=int((owner >= 0).sum()),
        filled_lanes=filled, frontier_vertices=int(vals.count_nonzero()),
        unpacked_rows=unpacked, launches=sweep_launches,
        **bound(filled * 4 + S * (4 + 4) + V * 4, filled * 2,
                ops_per_s=INT32_OPS_PER_S))
    del k, p, keys, owner, vals
    emit({"phase": "kernels", **row})
    emit({"phase": "iterators", "batch": ITER_BATCH,
          "inserted": int(inserted.sum()), "flagged_buckets": flagged,
          "updated_edges": n, "engine_launches": engine_launches,
          "components": components, "slab_iterator_cap": cap_slab,
          "hub_degree": hub, "hub_slabs": hub_slabs,
          "bfs_levels": it_sweep, "bfs_reached": reached_n,
          "bfs_sweep_launches": sweep_launches, "ms": ms,
          "seconds": time.perf_counter() - t_phase})
    return {"results": [row]}


# ----------------------------------------------------------------------------
# the durability phase: checkpoint, write-ahead log and crash recovery
# ----------------------------------------------------------------------------

@contextlib.contextmanager
def keeping_boot(stream_mod, kept: dict):
    """Copy the serve's views to the host as booted: the serve builds its
    ``RequestPipeline`` right after the boot, before any request."""
    real = stream_mod.RequestPipeline

    def pipeline(store, registry=None, **kw):
        kept.update({name: clone_graph(g, "cpu")
                     for name, g in store.views.items()})
        return real(store, registry, **kw)

    with swapped(stream_mod, RequestPipeline=pipeline):
        yield kept


#: flight-recorder events that end each phase of an apply, and the name of
#: the phase's time in a durability line
APPLY_PHASE_ENDS = {"store.capacity_grow": "grow_ms",
                    "store.apply.post_wal": "wal_ms",
                    "store.apply.dispatch": "engine_ms",
                    "store.apply.close": "close_ms",
                    "store.maintain": "maintain_ms"}


def apply_phases_ms(since_ns: int) -> list:
    """Each apply since ``since_ns`` split by the flight recorder (which
    is always on): ms from admission to the end of capacity growth, then
    to the end of the WAL append, of the engine, of the epoch close and of
    a maintenance pass, each from the end of the phase before."""
    from repro_torch.obs import flight
    out = []
    for e in flight.snapshot():
        if e["ts_ns"] < since_ns:
            continue
        if e["event"] == "store.apply.admitted":
            out.append({"version": e["a"] + 1})
            last = e["ts_ns"]
        elif out and e["event"] in APPLY_PHASE_ENDS:
            out[-1][APPLY_PHASE_ENDS[e["event"]]] = (e["ts_ns"] - last) / 1e6
            last = e["ts_ns"]
    return out


def durability_phase(torch, np, boot: dict, updates: list, *,
                     device: str = "cuda") -> dict:
    """The twin, then a kill, recovery and re-feed at each of DUR_SITES;
    one ``durability`` line per site.  ``boot`` holds host copies of the
    serve's booted views, ``updates`` the serve's first three update
    batches (the second compacts on the serve's policy)."""
    import shutil
    import tempfile

    from repro_torch import resilience as rz
    from repro_torch.algorithms import (bfs_stream_property,
                                        pagerank_stream_property,
                                        sssp_stream_property,
                                        wcc_stream_property)
    from repro_torch.core.slab_graph import FIELDS
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve as serve_mod
    from repro_torch.resilience import faults
    from repro_torch.stream import (GraphStore, MaintenancePolicy,
                                    PropertyRegistry)

    t_phase = time.perf_counter()
    args = serve_mod.parse_args(SERVE_ARGS)
    n_edges = int(boot["forward"].n_edges)
    cap = n_edges + args.requests * args.batch + 4096

    def policy():
        return MaintenancePolicy(tombstone_ratio=args.tombstone_ratio)

    def specs():
        return [pagerank_stream_property(),
                bfs_stream_property(0, edge_capacity=cap),
                wcc_stream_property(),
                sssp_stream_property(0, edge_capacity=cap)]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def fresh():
        views = {name: clone_graph(g, device) for name, g in boot.items()}
        store = GraphStore(views, weighted=False, maintenance=policy())
        registry = PropertyRegistry(store)
        for spec in specs():
            registry.register(spec)
        return store, registry

    def apply_ms(store, b):
        t0 = time.perf_counter()
        store.apply(b.ins_src, b.ins_dst, b.ins_w, b.del_src, b.del_dst)
        sync()
        return 1e3 * (time.perf_counter() - t0)

    def read_all(registry):
        out = {name: registry.read(name) for name in DUR_PROPS}
        sync()
        return out

    runtime.reset_launches()
    # -- the uninterrupted twin -------------------------------------------
    twin, twin_reg = fresh()
    update_ms, versions = [], []
    t_ns = time.perf_counter_ns()
    for k, b in enumerate(updates):
        update_ms.append(apply_ms(twin, b))
        versions.append(twin.version)
        if k == 0:
            read_all(twin_reg)        # the same reads as the killed runs
    check(twin.maintenance_count >= 1,
          "the twin's second update should compact on the policy")
    twin_split = apply_phases_ms(t_ns)
    want = read_all(twin_reg)

    est = sum(g.nbytes() for g in twin.views.values())
    rows = []
    for site in DUR_SITES:
        t_site = time.perf_counter()
        root = Path(tempfile.mkdtemp(prefix="durability-"))
        ck, wd = root / "ckpt", root / "wal"
        free = shutil.disk_usage(root).free
        check(free >= 3 * est, f"{root}: {free} bytes free, under three "
              f"checkpoints' {3 * est} bytes")
        try:
            store, registry = fresh()
            store.attach_wal(rz.WriteAheadLog(wd))
            t_ns = time.perf_counter_ns()
            ms_wal = [apply_ms(store, updates[0])]
            read_all(registry)
            t0 = time.perf_counter()
            path = store.save(ck, registry=registry)
            save_s = time.perf_counter() - t0
            ckpt_bytes = sum(f.stat().st_size for f in path.iterdir())
            # passes before the checkpoint (0 on the serve's policy): the
            # restored store counts only the passes it replays
            before = store.maintenance_count
            ms_wal.append(apply_ms(store, updates[1]))
            check(store.maintenance_count > before,
                  f"{site}: update 2 should compact before the kill")
            wal_split = apply_phases_ms(t_ns)
            crashed = False
            try:
                with faults.inject(rz.FaultSpec(site, at=1)):
                    b = updates[2]
                    store.apply(b.ins_src, b.ins_dst, b.ins_w, b.del_src,
                                b.del_dst)
            except rz.InjectedCrash:
                crashed = True
            check(crashed, f"{site}: the injected crash never fired")
            store.wal.close()
            records, _ = rz.read_wal(wd)
            record_bytes = [rz.wal._HEAD.size + 4 * (
                (2 + (r.ins_w is not None)) * len(r.ins_src)
                + 2 * len(r.del_src)) for r in records]
            del store, registry
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()

            timed = {}

            class TimedRestore(GraphStore):
                @classmethod
                def restore(cls, *a, **kw):
                    t = time.perf_counter()
                    out = super().restore(*a, **kw)
                    sync()
                    timed["restore_s"] = time.perf_counter() - t
                    return out

            t0 = time.perf_counter()
            t_ns = time.perf_counter_ns()
            rec, rec_reg, report = rz.recover(
                ck, wd, store_cls=TimedRestore, specs=specs(),
                maintenance=policy(), device=device)
            sync()
            recover_s = time.perf_counter() - t0
            replay_split = apply_phases_ms(t_ns)
            check(not report.anomalies, f"{site}: {report.anomalies}")
            check(report.crash_reason == f"injected_crash@{site}",
                  f"{site}: recovery read {report.crash_reason!r}")
            compactions = rec.maintenance_count
            check(compactions >= 1,
                  f"{site}: replay re-derived no compaction")
            resume = versions.index(rec.version) + 1
            for b in updates[resume:]:
                rec.apply(b.ins_src, b.ins_dst, b.ins_w, b.del_src,
                          b.del_dst)
            sync()
            check(rec.version == twin.version,
                  f"{site}: recovered to v{rec.version}, twin "
                  f"v{twin.version}")
            for name, g in twin.views.items():
                for f in FIELDS:
                    a, b = getattr(rec.views[name], f), getattr(g, f)
                    check((a is None and b is None) or (
                        a.shape == b.shape and torch.equal(a, b)),
                        f"{site}: recovered {name}.{f} differs from the "
                        f"twin's")
            check(before + rec.maintenance_count == twin.maintenance_count
                  and rec._resilience_meta() == twin._resilience_meta(),
                  f"{site}: maintenance counters differ from the twin's")
            got = read_all(rec_reg)
            for name in ("bfs_0", "sssp_0"):
                check(torch.equal(got[name].dist, want[name].dist)
                      and torch.equal(got[name].parent,
                                      want[name].parent),
                      f"{site}: recovered {name} differs from the twin's")
            check(torch.equal(got["wcc"], want["wcc"]),
                  f"{site}: recovered wcc differs from the twin's")
            pr_err = float((got["pagerank"] - want["pagerank"]).abs().max())
            check(pr_err <= DUR_PR_ATOL, f"{site}: PageRank {pr_err} from "
                  f"the twin's, over {DUR_PR_ATOL}")
            t0 = time.perf_counter()
            audit = rz.audit_store(rec)
            audit_s = time.perf_counter() - t0
            check(audit.ok, f"{site}: audit found {audit.violations}")
            replay_s = recover_s - timed["restore_s"]
            row = {"phase": "durability", "site": site,
                   "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
                   "restore_s": timed["restore_s"],
                   "replayed": report.replayed,
                   "replay_ms": 1e3 * replay_s / max(1, report.replayed),
                   "recover_s": recover_s,
                   "wal_record_bytes": record_bytes,
                   "update_ms_wal": ms_wal, "update_ms": update_ms[:2],
                   "wal_split_ms": wal_split[:2],
                   "twin_split_ms": twin_split[:2],
                   "replay_split_ms": replay_split,
                   "audit_s": audit_s, "audit_checks": audit.checks_run,
                   "compaction_replayed": compactions,
                   "version": rec.version, "pagerank_max_abs": pr_err,
                   "disk_free_bytes": free,
                   "seconds": time.perf_counter() - t_site}
            emit(row)
            rows.append(row)
            del rec, rec_reg, got
            gc.collect()
        finally:
            shutil.rmtree(root, ignore_errors=True)
    launches = dict(runtime.LAUNCHES)
    emit({"phase": "durability", "twin_update_ms": update_ms,
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    return {"rows": rows, "launches": launches}


# ----------------------------------------------------------------------------
# the sharded phase: the serve on a ShardedGraphStore, health and kernel
# instrumentation armed
# ----------------------------------------------------------------------------

def served_reference(torch, np, out) -> dict:
    """Host copies of what phase 3's unsharded serve answered: its edge
    ledger, each request's host-clock ms, and its last BFS (as int32
    levels), WCC, PageRank and membership answers."""
    last = {}
    for kind, _, resp, _ in out["responses"]:
        last[kind] = resp
    dist = last["read:bfs_0"].payload["value"].dist
    levels = torch.where(dist >= 1e29, SHARD_UNREACHED, dist).to(torch.int32)
    return {"ledger": out["ledger"].keys.copy(),
            "request_ms": [1e3 * resp.latency_s
                           for _, _, resp, _ in out["responses"]],
            "bfs_0": levels.cpu(),
            "wcc": last["read:wcc"].payload["value"].cpu(),
            "pagerank": last["read:pagerank"].payload["value"].cpu(),
            "member": np.asarray(last["member"].payload["found"]).copy()}


@contextlib.contextmanager
def at_boot(stream_mod, fn):
    """Call ``fn(store)`` on the serve's store as booted: the serve builds
    its ``RequestPipeline`` right after the boot, before any request."""
    real = stream_mod.RequestPipeline

    def pipeline(store, registry=None, **kw):
        fn(store)
        return real(store, registry, **kw)

    with swapped(stream_mod, RequestPipeline=pipeline):
        yield


def sharded_edge_keys(torch, sg):
    """Sorted ``src << 32 | dst`` of every live lane over the shards, the
    src ids made global again."""
    from repro_torch.core.worklist import pool_edges
    from repro_torch.distributed.sharded_graph import shard_slice

    parts = []
    for k in range(sg.n_shards):
        g = shard_slice(sg, k)
        rows, lanes = torch.nonzero(pool_edges(g).valid, as_tuple=True)
        src = g.slab_vertex[rows].long() * sg.n_shards + k
        parts.append((src << 32) | (g.keys[rows, lanes].long() & 0xFFFFFFFF))
    return torch.sort(torch.cat(parts)).values


def sweep_floor_ms(torch, store, shape: str) -> dict:
    """Kernel 3's device time for the cheapest sweep the fixpoints make on
    a shard pool of ``shape`` (``rows x 128``): the head rows only (every
    sweep reads at least those), an all-inactive frontier, int32 ``min``."""
    from repro_torch.kernels.slab_sweep.kernel import slab_sweep

    for name, sg in store.views.items():
        g = sg.graphs
        if "x".join(str(d) for d in g.keys.shape[1:]) != shape:
            continue
        rows = g.n_buckets
        keys, owner = g.keys[0, :rows], g.slab_vertex[0, :rows]
        V = store.n_vertices
        values = torch.zeros(V, dtype=torch.int32, device=keys.device)
        frontier = torch.zeros(V, dtype=torch.bool, device=keys.device)
        ms = device_ms(torch, lambda: slab_sweep(
            keys, owner, values, None, frontier, None, semiring="min",
            n_vertices=V))
        return {"view": name, "rows": rows, "kernel_ms": ms}
    raise SmokeFailure(f"no view of the sharded store has shard pools of "
                       f"shape {shape}")


def sharded_phase(torch, np, ref3: dict, mesh_dir: Path) -> dict:
    """Serve the sharded configuration (SHARDS shards on the card) with the
    health engine and the kernel instrumentation armed, hold it to phase
    3's answers, plant an SLO fault, and count the booted symmetric view's
    triangles; returns the launch counts, the triangle count and what the
    mesh phase serves again: the booted store (saved under ``mesh_dir``),
    the request stream and host copies of its answers."""
    import shutil
    import tempfile

    import repro_torch.stream as stream_mod
    from repro_torch import obs
    from repro_torch.distributed import sharded_graph
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve as serve_mod
    from repro_torch.obs.health import HealthEngine, SLOTarget
    from repro_torch.resilience import CircuitBreaker
    from repro_torch.stream import UpdateBatch, canonical_batch

    t_phase = time.perf_counter()
    obs.reset()
    sharded_graph.reset_fix_stats()
    torch.cuda.reset_peak_memory_stats()
    tri = {}

    def count_triangles(store):
        t0 = time.perf_counter()
        tri["triangles"] = int(sharded_graph.triangles_sharded(
            store.symmetric))
        tri["triangles_s"] = time.perf_counter() - t0
        # the mesh phase restores this store on every rank
        need = sum(sg.graphs.nbytes() for sg in store.views.values())
        free = shutil.disk_usage(mesh_dir).free
        check(free > 1.2 * need, f"{free} bytes free under {mesh_dir}, "
              f"the booted sharded store takes {need}")
        t0 = time.perf_counter()
        store.save(mesh_dir)
        tri["save_s"] = time.perf_counter() - t0

    args = SERVE_ARGS + ["--shards", str(SHARDS), "--health",
                         "--slo-update-ms", str(SHARD_SLO_UPDATE_MS),
                         "--metrics"]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "metrics.json"
        with at_boot(stream_mod, count_triangles):
            runtime.reset_launches()
            out = serve_mod.main(args + ["--metrics-json", str(path)])
            torch.cuda.synchronize()
        launches = dict(runtime.LAUNCHES)
        metrics_json = json.loads(path.read_text())
    peak = torch.cuda.max_memory_allocated()
    summary = obs.kernel_summary()
    obs.disable()
    fix = dict(sharded_graph.FIX_STATS)
    store, registry = out["store"], out["registry"]
    check(store.n_shards == SHARDS, "the serve did not shard its store")
    check(metrics_json.get("kernels") == summary,
          "--metrics-json does not carry the kernel summary")

    # the served state against phase 3's unsharded serve of the same batches
    t0 = time.perf_counter()
    check(np.array_equal(out["ledger"].keys, ref3["ledger"]),
          "the sharded serve drew other batches than phase 3")
    live = sharded_edge_keys(torch, store.forward)
    want = torch.from_numpy(ref3["ledger"].astype(np.int64)).to(live.device)
    check(live.numel() == want.numel() and torch.equal(live, want),
          f"the shards hold {live.numel()} edges, phase 3's store "
          f"{want.numel()}")
    del live, want
    last = {}
    for kind, _, resp, _ in out["responses"]:
        last[kind] = resp
    bfs = last["read:bfs_0"].payload["value"].cpu()
    check(torch.equal(bfs, ref3["bfs_0"]),
          "sharded BFS levels differ from phase 3's")
    wcc = last["read:wcc"].payload["value"].cpu()
    check(torch.equal(wcc, ref3["wcc"]),
          "sharded WCC labels differ from phase 3's")
    pr_err = float((last["read:pagerank"].payload["value"].cpu()
                    - ref3["pagerank"]).abs().max())
    check(pr_err <= DUR_PR_ATOL, f"sharded PageRank {pr_err} from phase "
          f"3's, above {DUR_PR_ATOL}")
    check(np.array_equal(last["member"].payload["found"], ref3["member"]),
          "sharded membership answers differ from phase 3's")
    unpacked = unpacked_rows(torch, [sg.graphs.keys[k]
                                     for sg in store.views.values()
                                     for k in range(SHARDS)])
    check(unpacked == 0, f"{unpacked} rows of the shard pools hold a key "
          "after an EMPTY lane")
    audit = store.audit()
    check(audit.ok, f"audit of the sharded store: {audit.as_event()}")
    check_s = time.perf_counter() - t0

    # the health report of the serve: every class sampled, healthy
    report = out["health_report"]
    check(report is not None and all(c.samples > 0 for c in report.classes)
          and {c.request_class for c in report.classes}
          >= {"update", "property", "member"},
          "the health report misses a request class")
    check(report.healthy, f"the serve burned its SLOs at "
          f"{SHARD_SLO_UPDATE_MS} ms: {report.as_dict()}")

    # the kernel statistics: one update_shards dispatch an update served
    updates = [req for kind, req, _, _ in out["responses"]
               if kind == "update"]
    calls = sum(k["calls"] for k in summary.values()
                if k["family"] == "slab_update" and k["op"] == "update_shards")
    check(calls == len(updates), f"{calls} update_shards dispatches for "
          f"{len(updates)} updates")
    floors = {}
    for key, k in summary.items():
        if k["op"] != "sweep_vertices" or not k["steady_calls"]:
            continue
        floor = sweep_floor_ms(torch, store, k["shape"])
        steady_ms = 1e3 * k["steady_s"] / k["steady_calls"]
        check(steady_ms >= floor["kernel_ms"],
              f"{key}: {steady_ms} ms a steady call, under kernel 3's "
              f"{floor['kernel_ms']} ms on the same pool")
        floors[key] = {**floor, "steady_ms": steady_ms}
    check(floors, "no steady sweep_vertices dispatch was recorded")
    for name in SHARD_KERNELS:
        check(launches[name] > 0,
              f"{name} was never launched in the sharded phase")

    # a planted SLO fault: a 1e-3 ms update target burns the budget, and a
    # breaker with burn_threshold 1.0 sheds the updates after the report
    rng = np.random.default_rng(SHARD_FAULT_SEED)
    engine = HealthEngine([SLOTarget("update", latency_s=1e-6,
                                     objective=0.9)], window=16)
    breaker = CircuitBreaker(threshold=99, cooldown=8, burn_threshold=1.0)
    pipe = stream_mod.RequestPipeline(store, registry, coalesce=False,
                                      breaker=breaker, health=engine,
                                      health_every=2)
    batches = [rng.integers(0, store.n_vertices, (1024, 2)).astype(np.uint32)
               for _ in range(6)]
    resps = pipe.run([UpdateBatch(ins_src=b[:, 0], ins_dst=b[:, 1])
                      for b in batches])
    shed = [bool(r.payload.get("shed")) for r in resps]
    check(breaker.burn_trips >= 1 and shed[:2] == [False, False]
          and all(shed[2:]),
          f"the planted SLO fault should trip after the first report and "
          f"shed the rest: burn_trips {breaker.burn_trips}, shed {shed}")

    imbalance = []
    for req in updates:
        i_s, _, _, d_s, _ = canonical_batch(req.ins_src, req.ins_dst, None,
                                            req.del_src, req.del_dst,
                                            weighted=False)
        row = {}
        for kind, a in (("ins", i_s), ("del", d_s)):
            counts = np.bincount(a.astype(np.int64) % SHARDS,
                                 minlength=SHARDS)
            row[kind] = float(counts.max() / counts.mean())
        imbalance.append(row)
    sweeps = sum(k["calls"] for k in summary.values()
                 if k["op"] == "sweep_vertices")
    last_m = store.last_maintenance
    emit({"phase": "sharded", "card": gpu_line(), "shards": SHARDS,
          "boot_s": out["boot_s"], "serve_s": out["serve_s"],
          "requests": [{"i": i, "kind": kind,
                        "ms": 1e3 * resp.latency_s,
                        "unsharded_ms": ref3["request_ms"][i],
                        "launched": launched}
                       for i, (kind, _, resp, launched)
                       in enumerate(out["responses"])],
          "latency": out["latency"],
          "route_imbalance": imbalance,
          "fixpoint": {"iterations": fix["iterations"],
                       "host_reads": fix["host_reads"],
                       "host_reads_per_iteration":
                           fix["host_reads"] / max(1, fix["iterations"]),
                       "instrumented_waits_per_iteration":
                           sweeps / max(1, fix["iterations"])},
          "max_memory_allocated": peak,
          "pagerank_max_abs_err": pr_err,
          "maintenance": {"passes": store.maintenance_count,
                          "last": last_m.describe() if last_m else None,
                          "events": store.maintenance_events},
          "unpacked_rows": unpacked, "audit_checks": audit.checks_run,
          "check_s": check_s,
          "health": report.as_dict(),
          "slo_fault": {"burn_trips": breaker.burn_trips, "shed": shed,
                        "breaker": breaker.status()},
          "kernel_summary": summary, "sweep_floor": floors,
          "triangles_at_boot": tri["triangles"],
          "triangles_s": tri["triangles_s"],
          "kernels": launches,
          "boot_save_s": tri["save_s"],
          "seconds": time.perf_counter() - t_phase})
    answers = {}
    for i, (kind, _, resp, _) in enumerate(out["responses"]):
        if kind.startswith("read:"):
            answers[i] = resp.payload["value"].cpu()
        elif kind == "member":
            answers[i] = np.asarray(resp.payload["found"]).copy()
    mesh = {"ckpt_dir": str(mesh_dir),
            "requests": [(kind, req) for kind, req, _, _ in out["responses"]],
            "answers": answers,
            "request_ms": [1e3 * resp.latency_s
                           for _, _, resp, _ in out["responses"]],
            "policy": serve_mod.parse_args(SERVE_ARGS).policy,
            "tombstone_ratio":
                serve_mod.parse_args(SERVE_ARGS).tombstone_ratio}
    return {"launches": launches, "triangles": tri["triangles"],
            "mesh": mesh}


# ----------------------------------------------------------------------------
# the mesh phase: the sharded store as one process a shard, held to the
# sharded phase leaf for leaf
# ----------------------------------------------------------------------------

def leaf_digests(np, g) -> dict:
    """sha256 of every tensor field of one shard's SlabGraph (its bytes as
    laid out on the device), hashed on host threads."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.slab_graph import FIELDS

    def one(f):
        t = getattr(g, f)
        if t is None:
            return f, None
        return f, hashlib.sha256(np.ascontiguousarray(
            t.cpu().numpy())).hexdigest()

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(one, FIELDS))


def shard_digests(np, store, k: int) -> dict:
    """``leaf_digests`` of shard ``k`` of every view of a sharded store."""
    from repro_torch.distributed.sharded_graph import shard_slice
    return {name: leaf_digests(np, shard_slice(sg, k))
            for name, sg in store.views.items()}


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _read_value(np, resp):
    """A read's or a membership query's answer, on the host."""
    if "value" in resp.payload:
        return resp.payload["value"].cpu().numpy()
    return np.asarray(resp.payload["found"])


def _specs(stream_mod) -> list:
    """The mesh jobs' properties, named as PROPS."""
    return [stream_mod.sharded_pagerank_property(),
            stream_mod.sharded_bfs_property(0),
            stream_mod.sharded_wcc_property()]


def _registry(stream_mod, store, policy: str):
    registry = stream_mod.PropertyRegistry(store)
    for spec in _specs(stream_mod):
        registry.register(spec, policy=policy)
    return registry


def stacked_serve(torch, np, job: dict) -> dict:
    """The stacked rendering of a mesh job: its checkpoint restored on the
    card as one stacked store journaling to a WAL, the same requests
    served, every shard's digests after each update and every answer
    kept."""
    import repro_torch.stream as stream_mod

    from repro_torch import resilience

    dev = torch.device(job["device"])
    store, _ = stream_mod.ShardedGraphStore.restore(
        job["ckpt_dir"], device=dev,
        maintenance=stream_mod.MaintenancePolicy(
            tombstone_ratio=job["tombstone_ratio"]))
    store.attach_wal(resilience.WriteAheadLog(job["stacked_wal_dir"]))
    pipe = stream_mod.RequestPipeline(
        store, _registry(stream_mod, store, job["policy"]))
    S = store.n_shards
    digests = [[shard_digests(np, store, k) for k in range(S)]]
    answers = {}
    for i, (kind, req) in enumerate(job["requests"]):
        resp = pipe.run([req])[0]
        check(resp.kind != "error", f"stacked request {i}: {resp.payload}")
        if kind == "update":
            digests.append([shard_digests(np, store, k) for k in range(S)])
        else:
            answers[i] = _read_value(np, resp)
    _sync(torch, dev)
    store.wal.close()
    out = {"digests": digests, "answers": answers,
           "maintenance_count": store.maintenance_count}
    del store, pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_rank(rank: int, world: int, run_dir: str) -> None:
    """One rank of a mesh job (``run_dir/job.pkl``): join the mesh, restore
    the stacked checkpoint and keep this rank's shard, count the booted
    triangles of the job's triangle checkpoint on the mesh, serve the
    requests, and write what it measured and answered to
    ``run_dir/rank{rank}.pkl``."""
    import hashlib
    import pickle
    import traceback

    import numpy as np
    import torch

    with open(Path(run_dir) / "job.pkl", "rb") as f:
        job = pickle.load(f)
    res = {"rank": rank}
    code = 0
    try:
        import repro_torch.stream as stream_mod
        from repro_torch import resilience
        from repro_torch.distributed import collectives, ranks
        from repro_torch.distributed import sharded_graph as sgm
        from repro_torch.kernels import runtime
        from repro_torch.resilience import faults

        dev = torch.device(job["device"])
        mesh = ranks.init_shard_mesh(
            rank, world, init_file=str(Path(run_dir) / "rdzv"),
            backend=job["backend"], device=dev)
        policy = stream_mod.MaintenancePolicy(
            tombstone_ratio=job["tombstone_ratio"])
        wal_dir, kill_ckpt = Path(run_dir) / "wal", Path(run_dir) / "kill"
        try:
            t0 = time.perf_counter()
            store, _ = stream_mod.ShardedGraphStore.restore(
                job["ckpt_dir"], device="cpu", maintenance=policy)
            res["restore_s"] = time.perf_counter() - t0
            # journal and audit every epoch: attached before the placement
            store.attach_wal(resilience.WriteAheadLog(wal_dir))
            store.attach_audits(resilience.AuditPolicy(every=1))
            t0 = time.perf_counter()
            store.place_on_mesh(mesh)
            _sync(torch, store.device)
            res["place_s"] = time.perf_counter() - t0
            check(store._mode() == "shard_map" and store.forward.graphs
                  .keys.shape[0] == 1, "the store is not placed on the mesh")
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            runtime.reset_launches()
            sgm.reset_fix_stats()
            res["digests"] = [shard_digests(np, store, rank)]
            # the booted triangles of a store of their own, placed on the
            # same mesh: one rotation of G1 a shard, summed over the ranks
            tri, _ = stream_mod.ShardedGraphStore.restore(
                job["triangles_ckpt"], device="cpu")
            tri.place_on_mesh(mesh)
            collectives.reset_collective_stats()
            t0 = time.perf_counter()
            res["triangles"] = int(sgm.triangles_sharded(tri.symmetric))
            res["triangles_s"] = time.perf_counter() - t0
            res["triangles_collective"] = dict(collectives.COLLECTIVE_STATS)
            del tri
            gc.collect()
            registry = _registry(stream_mod, store, job["policy"])
            pipe = stream_mod.RequestPipeline(store, registry)
            rows, maint_base = [], 0
            for i, (kind, req) in enumerate(job["requests"]):
                collectives.reset_collective_stats()
                fix0 = dict(sgm.FIX_STATS)
                if i == job["kill_at"]:
                    # a checkpoint, then a kill after this update's WAL
                    # append; recovery (stacked, onto the card) and the
                    # placement stand in for the update
                    t0 = time.perf_counter()
                    store.save(kill_ckpt, registry=registry)
                    res["save_s"] = time.perf_counter() - t0
                    try:
                        with faults.inject(resilience.FaultSpec(
                                "apply.post_wal", at=1)):
                            pipe.run([req])
                    except resilience.InjectedCrash:
                        res["killed"] = True
                    res["audits"] = [
                        {k: v for k, v in ev.items() if k != "duration_s"}
                        for ev in store.audit_events]
                    maint_base = store.maintenance_count
                    store.wal.close()
                    del pipe, registry, store
                    gc.collect()
                    if dev.type == "cuda":
                        torch.cuda.empty_cache()
                    torch.distributed.barrier(group=mesh.get_group("shard"))
                    t0 = time.perf_counter()
                    store, registry, report = resilience.recover(
                        kill_ckpt, wal_dir,
                        store_cls=stream_mod.ShardedGraphStore,
                        specs=_specs(stream_mod),
                        policies={n: job["policy"] for n in PROPS},
                        maintenance=policy,
                        wal=resilience.WriteAheadLog(wal_dir), device=dev)
                    _sync(torch, dev)
                    res["recover_s"] = time.perf_counter() - t0
                    res["replayed"] = report.replayed
                    t0 = time.perf_counter()
                    store.place_on_mesh(mesh)
                    _sync(torch, dev)
                    res["recover_place_s"] = time.perf_counter() - t0
                    audit = store.audit()
                    res["audits"].append({k: v for k, v in
                                          audit.as_event().items()
                                          if k != "duration_s"})
                    res["recovered_audit_s"] = audit.duration_s
                    pipe = stream_mod.RequestPipeline(store, registry)
                    rows.append({
                        "kind": kind, "ms": 1e3 * res["recover_s"],
                        "recovered": True, "version": store.version,
                        "collective": dict(collectives.COLLECTIVE_STATS),
                        "fix": {k: v - fix0[k]
                                for k, v in sgm.FIX_STATS.items()},
                        "digests": shard_digests(np, store, rank)})
                    continue
                _sync(torch, dev)
                t0 = time.perf_counter()
                resp = pipe.run([req])[0]
                _sync(torch, dev)
                row = {"kind": kind, "ms": 1e3 * (time.perf_counter() - t0),
                       "version": resp.version,
                       "collective": dict(collectives.COLLECTIVE_STATS),
                       "fix": {k: v - fix0[k]
                               for k, v in sgm.FIX_STATS.items()}}
                check(resp.kind != "error", f"rank {rank}: {resp.payload}")
                if kind == "update":
                    row["n"] = (resp.payload["inserted"],
                                resp.payload["deleted"])
                    row["digests"] = shard_digests(np, store, rank)
                else:
                    value = _read_value(np, resp)
                    row["sha"] = hashlib.sha256(value).hexdigest()
                    if rank == 0:
                        row["value"] = value
                rows.append(row)
            res["requests"] = rows
            res["wal_appended"] = store.wal.appended
            store.wal.close()
            res["launches"] = dict(runtime.LAUNCHES)
            res["fix"] = dict(sgm.FIX_STATS)
            res["maintenance_count"] = maint_base + store.maintenance_count
            res["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None)
        finally:
            ranks.close_shard_mesh()
    except BaseException:
        res["error"] = traceback.format_exc()
        code = 1
    res["jax_imported"] = "jax" in sys.modules
    with open(Path(run_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    sys.exit(code)


def run_mesh_job(job: dict, world: int, run_dir: Path) -> list:
    """Start ``world`` ranks on ``job`` (spawned: this process has
    initialised CUDA) under the parent's deadline; their results."""
    import pickle

    from repro_torch.distributed.ranks import RankGroup

    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    group = RankGroup(mesh_rank, world, (str(run_dir),),
                      deadline_s=MESH_DEADLINE_S)
    try:
        group.wait()
    except RuntimeError as e:
        errors = []
        for r in range(world):
            path = run_dir / f"rank{r}.pkl"
            if path.is_file():
                with open(path, "rb") as f:
                    errors.append(pickle.load(f).get("error") or "")
        raise SmokeFailure(f"mesh ranks: {e}\n" + "\n".join(errors))
    out = []
    for r in range(world):
        with open(run_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def check_mesh_ranks(np, got: list, want: dict, what: str) -> dict:
    """Hold a mesh job's ranks to the stacked serve of the same job: every
    shard's digests after every update (the killed one recovered), every
    answer (bit for bit, or PageRank within MESH_PR_REL / V), replicated
    answers, audits and equal fixpoint counts on every rank, no JAX;
    returns the PageRank reading."""
    world = len(got)
    check(not any(r["jax_imported"] for r in got), f"{what}: a rank "
          "imported JAX")
    n_epochs = len(want["digests"])
    for r, res in enumerate(got):
        # the kill, recovery and audits: every audit clean and the same
        # report on every rank, one record replayed
        check(res.get("killed") and res["replayed"] == 1,
              f"{what}: rank {r} was not killed and recovered "
              f"({res.get('killed')}, {res.get('replayed')})")
        check(len(res["audits"]) == n_epochs - 1
              and all(a["ok"] for a in res["audits"]),
              f"{what}: rank {r}'s audits {res['audits']}")
        check(res["audits"] == got[0]["audits"],
              f"{what}: the audits of rank {r} differ from rank 0's")
        digests = [res["digests"][0]] + [row["digests"]
                                         for row in res["requests"]
                                         if row["kind"] == "update"]
        check(len(digests) == n_epochs, f"{what}: rank {r} served "
              f"{len(digests) - 1} updates, the stacked store "
              f"{n_epochs - 1}")
        for e, (d_rank, d_stacked) in enumerate(zip(digests,
                                                    want["digests"])):
            for view, leaves in d_stacked[r].items():
                for f, h in leaves.items():
                    check(d_rank[view][f] == h, f"{what}: epoch {e} "
                          f"rank {r} {view}.{f} differs from the stacked "
                          "shard")
        check(res["maintenance_count"] == want["maintenance_count"],
              f"{what}: rank {r} maintained {res['maintenance_count']} "
              f"times, the stacked store {want['maintenance_count']}")
        check(res["fix"] == got[0]["fix"], f"{what}: fixpoint counts "
              f"differ between ranks: {res['fix']} {got[0]['fix']}")
    pr_err, pr_equal = 0.0, True
    for i, row in enumerate(got[0]["requests"]):
        if row["kind"] == "update":
            continue
        for r in range(1, world):
            check(got[r]["requests"][i]["sha"] == row["sha"],
                  f"{what}: request {i} differs between rank 0 and {r}")
        ans, ref = row["value"], want["answers"][i]
        if row["kind"] == "read:pagerank":
            err = float(np.abs(ans - ref).max())
            pr_err = max(pr_err, err)
            pr_equal = pr_equal and np.array_equal(ans, ref)
            check(err <= MESH_PR_REL / ref.size, f"{what}: PageRank at "
                  f"request {i} {err} from the stacked store's, over "
                  f"{MESH_PR_REL / ref.size}")
        else:
            check(ans.dtype == ref.dtype and np.array_equal(ans, ref),
                  f"{what}: {row['kind']} at request {i} differs from "
                  "the stacked store's")
    return {"pagerank_max_abs_err": pr_err, "pagerank_bit_equal": pr_equal}


def mesh_lines(got: list) -> dict:
    """What a mesh job measured: per request the max over ranks of its
    latency (the killed update's: its recovery), collective time, bytes
    and all-to-all bytes, with the fixpoints' iterations and host reads;
    per rank restore, placement, save, recovery and re-placement seconds,
    the recovered store's audit seconds, peak memory and kernel
    launches."""
    reqs = []
    for i, row in enumerate(got[0]["requests"]):
        rows = [r["requests"][i] for r in got]
        reqs.append({
            "i": i, "kind": row["kind"],
            "ms": max(x["ms"] for x in rows),
            "ms_per_rank": [x["ms"] for x in rows],
            "collective_ms": max(1e3 * x["collective"]["seconds"]
                                 for x in rows),
            "collective_calls": row["collective"]["calls"],
            "all_to_all_bytes": max(x["collective"]["all_to_all_bytes"]
                                    for x in rows),
            "collective_bytes": max(x["collective"]["bytes"] for x in rows),
            "iterations": row["fix"]["iterations"],
            "host_reads": row["fix"]["host_reads"]})
    return {"requests": reqs,
            "restore_s": [r["restore_s"] for r in got],
            "place_s": [r["place_s"] for r in got],
            "save_s": [r["save_s"] for r in got],
            "recover_s": [r["recover_s"] for r in got],
            "recover_place_s": [r["recover_place_s"] for r in got],
            "recovered_audit_s": [r["recovered_audit_s"] for r in got],
            "peak_bytes": [r["peak_bytes"] for r in got],
            "launches": [r["launches"] for r in got],
            "fixpoint": got[0]["fix"]}


def small_graph():
    """The mesh's RMAT scale-16 graph (deduplicated pairs)."""
    import repro_torch.stream as stream_mod
    from repro_torch.data.synth import rmat_edges

    src, dst = rmat_edges(MESH_NCCL_VERTICES, MESH_NCCL_EDGES, seed=3)
    src, dst, _ = stream_mod.dedup_pairs(src, dst)
    return src, dst


def triangle_ckpt(torch, n_shards: int, ckpt_dir: Path) -> int:
    """The scale-16 graph booted as an ``n_shards`` stacked store on the
    card and saved to ``ckpt_dir``; its booted triangle count (stacked),
    which the mesh's ranks must count on its restored shards."""
    import repro_torch.stream as stream_mod
    from repro_torch.distributed import sharded_graph as sgm

    src, dst = small_graph()
    store = stream_mod.ShardedGraphStore.from_edges(
        MESH_NCCL_VERTICES, n_shards, src, dst, device=MESH_DEVICE)
    count = int(sgm.triangles_sharded(store.symmetric))
    store.save(ckpt_dir)
    del store
    gc.collect()
    torch.cuda.empty_cache()
    return count


def unsharded_triangles(torch) -> int:
    """The scale-16 graph's static triangle count on one hashed store on
    the card, as the triangles phase counts: the sharded counts' yardstick."""
    import repro_torch.stream as stream_mod
    from repro_torch.algorithms import triangles_static
    from repro_torch.algorithms.triangle import _sym_bpv

    src, dst = small_graph()
    store = stream_mod.GraphStore.from_edges(
        MESH_NCCL_VERTICES, src, dst, hashing=True, with_transpose=False,
        device=MESH_DEVICE)
    count = int(triangles_static(store.symmetric,
                                 max_bpv=_sym_bpv(store.symmetric)))
    del store
    gc.collect()
    torch.cuda.empty_cache()
    return count


def nccl_job(torch, np, run_dir: Path) -> dict:
    """The one-rank NCCL job: a 1-shard sharded store at RMAT scale 16 on
    the card, saved (its booted triangles counted stacked), and a stream
    of three mixed updates (the deletes reach the maintenance trigger), a
    read of each property between them and a membership query."""
    import repro_torch.stream as stream_mod

    V = MESH_NCCL_VERTICES
    src, dst = small_graph()
    triangles = triangle_ckpt(torch, 1, run_dir / "ckpt")
    rng = np.random.default_rng(3)
    requests = []
    for prop in ("wcc", "pagerank", "bfs_0"):
        pick = rng.choice(len(src), MESH_NCCL_DELETES, replace=False)
        ins = rng.integers(0, V, (2, MESH_NCCL_BATCH)).astype(np.uint32)
        requests.append(("update", stream_mod.UpdateBatch(
            ins_src=ins[0], ins_dst=ins[1], del_src=src[pick],
            del_dst=dst[pick])))
        requests.append((f"read:{prop}", stream_mod.PropertyRead(prop)))
    q = rng.integers(0, len(src), 1024)
    requests.append(("member", stream_mod.MembershipQuery(src=src[q],
                                                          dst=dst[q])))
    return {"ckpt_dir": str(run_dir / "ckpt"), "requests": requests,
            "policy": "lazy", "tombstone_ratio": MESH_NCCL_RATIO,
            "triangles_ckpt": str(run_dir / "ckpt"),
            "triangles_stacked": triangles,
            "backend": MESH_NCCL_BACKEND, "device": MESH_DEVICE,
            "kill_at": last_update(requests),
            "stacked_wal_dir": str(run_dir / "stacked_wal")}


def last_update(requests) -> int:
    """The index of a stream's last update: where a mesh job is killed."""
    return max(i for i, (kind, _) in enumerate(requests) if kind == "update")


def wal_bytes(wal_dir) -> dict:
    """``{segment name: bytes}`` of a WAL directory."""
    return {p.name: p.read_bytes() for p in sorted(Path(wal_dir).glob(
        "wal-*.log"))}


def check_mesh_wal(run_dir: Path, job: dict, what: str) -> dict:
    """The WAL rank 0 wrote (the killed update's record kept) against the
    stacked replay's: byte for byte."""
    mine, want = wal_bytes(run_dir / "wal"), wal_bytes(job["stacked_wal_dir"])
    check(mine and mine == want, f"{what}: the mesh WAL "
          f"({ {k: len(v) for k, v in mine.items()} }) differs from the "
          f"stacked replay's ({ {k: len(v) for k, v in want.items()} })")
    return {"wal_segments": len(mine),
            "wal_bytes": sum(len(v) for v in mine.values())}


def mesh_phase(torch, np, sharded: dict) -> dict:
    """Serve the sharded phase's stream again on a mesh of SHARDS gloo
    ranks sharing the card, each restoring the sharded phase's booted
    store and keeping its shard: every shard's pool leaves (sha256) after
    every update must equal those of the stacked store replaying the
    stream, the answers the sharded phase's (BFS, WCC and membership bit
    for bit, PageRank within MESH_PR_REL / V); the same ranks count the
    booted triangles of the RMAT scale-16 graph restored as SHARDS shards,
    which must equal the stacked store's count.  Then one NCCL rank on a
    1-shard mesh against a 1-shard stacked store, its triangle count on
    the same graph the same.  Returns every rank's launch counts."""
    import tempfile

    import shutil

    t_phase = time.perf_counter()
    mesh_in = sharded["mesh"]
    tmp_ctx = tempfile.TemporaryDirectory()
    tmp = Path(tmp_ctx.name)
    need = sum(p.stat().st_size for p in Path(mesh_in["ckpt_dir"]).rglob("*")
               if p.is_file())
    free = shutil.disk_usage(tmp).free
    check(free > 1.2 * need, f"{free} bytes free under {tmp}, the mesh's "
          f"checkpoint before its kill takes {need}")
    # at RMAT scale 20 on the unhashed shard pools the ranks' booted count
    # took ~59 s a rank: they count the scale-16 graph's, restored as
    # SHARDS shards, and the sharded phase's count is held to phase 4's;
    # the stacked scale-16 count is held to the same graph's unsharded
    t0 = time.perf_counter()
    triangles = triangle_ckpt(torch, SHARDS, tmp / "triangles_ckpt")
    triangle_ckpt_s = time.perf_counter() - t0
    unsharded = unsharded_triangles(torch)
    check(triangles == unsharded,
          f"triangles_sharded counted {triangles} on {SHARDS} stacked "
          f"shards, triangles_static {unsharded} on the graph unsharded")
    job = {"ckpt_dir": mesh_in["ckpt_dir"],
           "requests": mesh_in["requests"], "policy": mesh_in["policy"],
           "tombstone_ratio": mesh_in["tombstone_ratio"],
           "triangles_ckpt": str(tmp / "triangles_ckpt"),
           "triangles_stacked": triangles, "backend": MESH_BACKEND,
           "device": MESH_DEVICE, "kill_at": last_update(mesh_in["requests"]),
           "stacked_wal_dir": str(tmp / "stacked_wal")}
    t0 = time.perf_counter()
    want = stacked_serve(torch, np, job)
    replay_s = time.perf_counter() - t0
    answers = {i: (a.numpy() if hasattr(a, "numpy") else a)
               for i, a in mesh_in["answers"].items()}
    for i, ref in answers.items():
        kind = mesh_in["requests"][i][0]
        if kind == "read:pagerank":
            check(float(np.abs(want["answers"][i] - ref).max())
                  <= MESH_PR_REL / ref.size, f"the stacked replay's "
                  f"PageRank at request {i} differs from the sharded "
                  "phase's")
        else:
            check(np.array_equal(want["answers"][i], ref),
                  f"the stacked replay's {kind} at request {i} differs "
                  "from the sharded phase's")
    # the mesh's answers are held to the sharded phase's own
    want["answers"] = answers
    with tmp_ctx:
        t0 = time.perf_counter()
        got = run_mesh_job(job, SHARDS, tmp / "ranks")
        ranks_s = time.perf_counter() - t0
        wal = check_mesh_wal(tmp / "ranks", job, "mesh")
    reading = check_mesh_ranks(np, got, want, "mesh")
    for r, res in enumerate(got):
        check(res["triangles"] == triangles,
              f"rank {r} counted {res['triangles']} triangles on the mesh, "
              f"the stacked store {triangles}")
        # the bound's max, G1 shifted one rank on each of SHARDS - 1
        # rotations, the sum
        check(res["triangles_collective"]["calls"] >= SHARDS + 1,
              f"rank {r}'s triangle count made "
              f"{res['triangles_collective']['calls']} collective calls: G1 "
              "did not walk the ring")
        for name in MESH_KERNELS:
            check(res["launches"][name] > 0,
                  f"{name} was never launched on mesh rank {r}")
    lines = mesh_lines(got)
    for row in lines["requests"]:
        row["sharded_ms"] = mesh_in["request_ms"][row["i"]]
    emit({"phase": "mesh", "card": gpu_line(), "ranks": SHARDS,
          "backend": MESH_BACKEND,
          "note": "the ranks time-slice one card and gloo stages their "
                  "collectives through host memory: these times say "
                  "nothing about NCCL across cards",
          **lines, **reading, **wal, "audits": got[0]["audits"],
          "triangles": got[0]["triangles"],
          "triangles_unsharded": unsharded,
          "triangles_s": [r["triangles_s"] for r in got],
          "triangles_collective": [r["triangles_collective"] for r in got],
          "triangle_ckpt_s": triangle_ckpt_s,
          "stacked_replay_s": replay_s,
          "ranks_s": ranks_s, "seconds": time.perf_counter() - t_phase})

    # one NCCL rank: a 1-shard mesh against a 1-shard stacked store
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        job = nccl_job(torch, np, Path(tmp))
        want = stacked_serve(torch, np, job)
        got1 = run_mesh_job(job, 1, Path(tmp) / "ranks")
        wal1 = check_mesh_wal(Path(tmp) / "ranks", job, "nccl")
    reading1 = check_mesh_ranks(np, got1, want, "nccl")
    check(got1[0]["maintenance_count"] >= 1,
          "the NCCL rank's store never compacted")
    check(got1[0]["requests"][0]["collective"]["all_to_all_bytes"] > 0,
          "the NCCL rank's update exchanged nothing")
    check(got1[0]["triangles"] == job["triangles_stacked"] == triangles,
          f"the NCCL rank counted {got1[0]['triangles']} triangles on its "
          f"mesh, the 1-shard stacked store {job['triangles_stacked']}, "
          f"the {SHARDS}-shard one {triangles}")
    for name in MESH_KERNELS:
        check(got1[0]["launches"][name] > 0,
              f"{name} was never launched on the NCCL rank")
    emit({"phase": "mesh_nccl", "card": gpu_line(), "ranks": 1,
          "backend": MESH_NCCL_BACKEND, **mesh_lines(got1), **reading1,
          **wal1, "audits": got1[0]["audits"],
          "maintenance_count": got1[0]["maintenance_count"],
          "triangles": got1[0]["triangles"],
          "triangles_s": got1[0]["triangles_s"],
          "triangles_collective": got1[0]["triangles_collective"],
          "seconds": time.perf_counter() - t0})
    return {"launches": [r["launches"] for r in got],
            "nccl_launches": got1[0]["launches"]}


# ----------------------------------------------------------------------------
# phase 4: live triangle counting on the symmetric view
# ----------------------------------------------------------------------------

class CountCapture:
    """Stands in for ``slab_count`` in the engine and records its inputs:
    in the ``static`` stage the chunk with the most active items (the pool
    cloned once, since the static count leaves it as it is), in the
    ``delta`` stage the first call whose G1 is its G2 (Count(G', G') of an
    insert epoch) and the first call whose G2 is another graph (the batch
    graph).  The pools mutate in place later, so captured G1 pools are
    cloned; a batch graph is never written after it is built."""

    def __init__(self, real):
        self.real = real
        self.stage = None
        self.got = {}
        self._clones = {}

    def _pool(self, keys, nxt, boff, bcnt):
        key = (self.stage, keys.data_ptr())
        if key not in self._clones:
            self._clones[key] = (keys.clone(), nxt.clone(), boff.clone(),
                                 bcnt.clone())
        return self._clones[key]

    def __call__(self, g1k, g1n, g1o, g1c, g2k, g2n, start, us):
        if self.stage == "static":
            n = int((start != -1).sum())
            best = self.got.get("static")
            if best is None or n > best["active"]:
                pool = self._pool(g1k, g1n, g1o, g1c)
                self.got["static"] = dict(
                    args=pool + pool[:2] + (start.clone(), us.clone()),
                    active=n)
        elif self.stage == "delta":
            name = "incremental" if g2k is g1k else "batch graph"
            if name not in self.got:
                pool = self._pool(g1k, g1n, g1o, g1c)
                g2 = pool[:2] if g2k is g1k else (g2k, g2n)
                self.got[name] = dict(
                    args=pool + g2 + (start.clone(), us.clone()),
                    active=int((start != -1).sum()))
        return self.real(g1k, g1n, g1o, g1c, g2k, g2n, start, us)


def triangle_requests(np, V, ledger, rng):
    """Yield ``(kind, request)``: a read, two cycles of an insert-only
    update, a read, a delete-only update and a read, then a membership
    query.  Reads sit between updates, so the pipeline coalesces none."""
    from repro_torch.launch.serve import EdgeLedger, pair_keys
    from repro_torch.stream import MembershipQuery, PropertyRead, UpdateBatch

    yield "read:triangles", PropertyRead("triangles")
    for _ in range(2):
        s = rng.integers(0, V, TRI_INSERTS).astype(np.uint32)
        d = rng.integers(0, V, TRI_INSERTS).astype(np.uint32)
        d = np.where(s == d, (d + 1) % V, d).astype(np.uint32)
        ledger.update(ledger.keys[:0], pair_keys(s, d))
        yield "insert", UpdateBatch(ins_src=s, ins_dst=d)
        yield "read:triangles", PropertyRead("triangles")
        gone = ledger.keys[rng.choice(len(ledger), TRI_DELETES,
                                      replace=False)]
        ledger.update(gone, gone[:0])
        p = EdgeLedger.pairs(gone)
        yield "delete", UpdateBatch(del_src=p[:, 0], del_dst=p[:, 1])
        yield "read:triangles", PropertyRead("triangles")
    q = rng.integers(0, V, (TRI_MEMBER, 2)).astype(np.uint32)
    yield "member", MembershipQuery(src=q[:, 0], dst=q[:, 1])


def closure_keys(np, src, dst):
    """Sorted ``pair_keys`` of the symmetric closure of (src, dst), as host
    uint64.  Deduplicated by ``torch.unique`` on the card: the keys are
    below 2**52, so their int64 order is their uint64 order, and numpy's
    sort of 32 M keys took ~45 s on the H100 machine's host."""
    import torch

    from repro_torch.launch.serve import pair_keys
    keys = np.concatenate([pair_keys(src, dst), pair_keys(dst, src)])
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.unique(torch.from_numpy(keys.view(np.int64)).to(dev)
                        ).cpu().numpy().view(np.uint64)


def check_boot_counts(torch, np, store, src, dst) -> dict:
    """Count() on the boot graph against numpy, independent of the port:
    4,096 sampled symmetric edges (the sum of ``np.intersect1d`` of the
    endpoints' neighbour lists in a host CSR) and every edge of the highest-
    degree vertex h (the symmetric edges with both ends in N(h))."""
    from repro_torch.algorithms.triangle import _sym_bpv
    from repro_torch.kernels.slab_intersect import count_edges

    t0 = time.perf_counter()
    V, dev, g = store.n_vertices, store.device, store.symmetric
    keys = closure_keys(np, src, dst)
    cu = (keys >> np.uint64(32)).astype(np.int64)
    cv = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
    indptr = np.searchsorted(cu, np.arange(V + 1))
    rng = np.random.default_rng(2)
    pick = rng.choice(len(keys), 4096, replace=False)
    want_sample = sum(
        len(np.intersect1d(cv[indptr[u]:indptr[u + 1]],
                           cv[indptr[v]:indptr[v + 1]], assume_unique=True))
        for u, v in zip(cu[pick], cv[pick]))
    h = int(np.argmax(np.diff(indptr)))
    nbrs = cv[indptr[h]:indptr[h + 1]]
    mark = np.zeros(V, bool)
    mark[nbrs] = True
    want_hub = int(np.sum(mark[cu] & mark[cv]))

    def ids(a):
        return torch.from_numpy(np.asarray(a).astype(np.uint32)
                                .view(np.int32)).to(dev)

    host_s = time.perf_counter() - t0
    mb = _sym_bpv(g)
    got = {}
    for name, us, vs in (("sample", cu[pick], cv[pick]),
                         ("hub", np.full(len(nbrs), h), nbrs)):
        got[name] = int(count_edges(g, g, ids(us), ids(vs),
                                    torch.ones(len(us), dtype=torch.bool,
                                               device=dev), max_bpv=mb))
    check(got["sample"] == want_sample,
          f"Count() over 4,096 sampled edges: {got['sample']}, numpy "
          f"{want_sample}")
    check(got["hub"] == want_hub,
          f"Count() over the hub's {len(nbrs)} edges: {got['hub']}, numpy "
          f"{want_hub}")
    return {"host_s": host_s, "sample_count": got["sample"], "hub": h,
            "hub_degree": int(len(nbrs)), "hub_count": got["hub"],
            "symmetric_edges": int(len(keys)), "max_bpv": mb}


def count_work(torch, g1k, g1n, g1o, g1c, g2k, g2n, start, us) -> dict:
    """What the count must read and compare for these items: the distinct
    G2 rows the items walk, the candidates, the (candidate, G1 row) visits
    of their probes, the compares a visit needs (up to the hit, else the
    row's filled lanes), the distinct G1 rows probed and the 32 B sectors
    that hold the filled lanes of the distinct rows."""
    from repro_torch.core.hashing import bucket_hash, is_valid_vertex

    act = start != -1
    cur, u = start[act].long(), us[act].long()
    n_u = int(torch.unique(u).numel())
    boff, bcnt = g1o[u], g1c[u]
    g2_rows, g1_rows = [], []
    cands = visits = compares = 0
    while cur.numel():
        g2_rows.append(cur)
        rows = g2k[cur]
        it, lane = torch.nonzero(is_valid_vertex(rows) & (bcnt > 0)[:, None],
                                 as_tuple=True)
        w_all = rows[it, lane]
        cands += w_all.numel()
        for c0 in range(0, w_all.numel(), 1 << 22):
            i, w = it[c0:c0 + (1 << 22)], w_all[c0:c0 + (1 << 22)]
            pc = (boff[i] + bucket_hash(w, bcnt[i])).long()
            while pc.numel():
                g1_rows.append(torch.unique(pc))
                visits += pc.numel()
                r = g1k[pc]
                eq = r == w[:, None]
                hit = eq.any(dim=1)
                compares += int(torch.where(
                    hit, eq.byte().argmax(dim=1) + 1,
                    (r != EMPTY_KEY).sum(dim=1)).sum())
                del r, eq
                nxt = g1n[pc]
                keep = ~hit & (nxt != -1)
                pc, w = nxt[keep].long(), w[keep]
        nx = g2n[cur]
        keep = nx != -1
        cur, boff, bcnt = nx[keep].long(), boff[keep], bcnt[keep]

    def distinct(parts, keys):
        if not parts:
            return 0, 0
        rows = torch.unique(torch.cat(parts))
        filled = (keys[rows] != EMPTY_KEY).sum(dim=1)
        return int(rows.numel()), int(((filled + 7) // 8).sum())

    g2_n, g2_sectors = distinct(g2_rows, g2k)
    g1_n, g1_sectors = distinct(g1_rows, g1k)
    return {"items": int(start.numel()), "active_items": int(act.sum()),
            "g2_rows": g2_n, "candidates": cands, "g1_visits": visits,
            "compares": compares, "g1_rows": g1_n, "distinct_u": n_u,
            "filled_sectors": g1_sectors + g2_sectors}


def compare_triangle_kernels(torch, cap, member, pools) -> list:
    """The intersection count and the membership probe against their plain
    versions on the captured inputs, timed as in phase 2, after the
    packed-row check of ``pools``."""
    from repro_torch.kernels.slab_intersect import (probe_hits,
                                                    probe_hits_torch,
                                                    slab_count,
                                                    slab_count_torch)
    unpacked = unpacked_rows(torch, pools)
    check(unpacked == 0, f"{unpacked} rows of the triangle phase's pools "
                         f"hold a key after an EMPTY lane")
    flush = torch.empty(1 << 26, dtype=torch.int32, device=member[2].device)
    results = []
    for variant in ("static", "incremental", "batch graph"):
        args = cap[variant]["args"]
        k = slab_count(*args)
        p = slab_count_torch(*args)
        torch.cuda.synchronize()
        check(k.dtype == p.dtype and torch.equal(k, p),
              f"slab_count differs from its plain version ({variant})")
        work = count_work(torch, *args)
        B = work["items"]
        # start, u and count of every item, u's bucket window once per
        # distinct u, the filled sectors and the link of each walked G2 row
        # and each probed G1 row once; the compares each visit needs.
        # PR 15's bound charged whole 512 B rows and 128 compares a visit
        rest = B * 12 + work["distinct_u"] * 8 \
            + (work["g2_rows"] + work["g1_rows"]) * 4
        whole_rows = bound(
            rest + (work["g2_rows"] + work["g1_rows"]) * 512,
            work["g1_visits"] * 128, ops_per_s=INT32_OPS_PER_S)
        results.append(dict(
            name="slab_count", variant=variant,
            max_abs_err=int((k - p).abs().max()), total=int(p.sum()),
            ms=device_ms(torch, lambda: slab_count(*args), flush=flush),
            plain_ms=time_ms(torch, lambda: slab_count_torch(*args)),
            library_ms=None, unpacked_rows=unpacked, **work,
            whole_row_bound_ms=whole_rows["bound_ms"],
            whole_row_bound_by=whole_rows["bound_by"],
            **bound(rest + work["filled_sectors"] * 32, work["compares"],
                    ops_per_s=INT32_OPS_PER_S)))
        del k, p

    ws, rows, keys = member
    k = probe_hits(ws, rows, keys)
    p = probe_hits_torch(ws, rows, keys)
    torch.cuda.synchronize()
    check(torch.equal(k, p), "probe_hits differs from its plain version")
    Q, C = rows.shape
    distinct = int(torch.unique(rows[rows >= 0]).numel())
    # the queries, their rows and each distinct row once, a bool out
    results.append(dict(
        name="probe_hits", variant=f"Q={Q}, C={C}",
        max_abs_err=int((k.int() - p.int()).abs().max()),
        ms=device_ms(torch, lambda: probe_hits(ws, rows, keys), flush=flush),
        plain_ms=time_ms(torch, lambda: probe_hits_torch(ws, rows, keys)),
        rows_read=distinct, hits=int(k.sum()), library_ms=None,
        **bound(Q * 4 + Q * C * 4 + distinct * 512 + Q, distinct * 128,
                ops_per_s=INT32_OPS_PER_S)))
    for r in results:
        emit({"phase": "triangle_kernels", **r})
    return results


def triangles_phase(torch, np) -> dict:
    """Serve the live triangle count on the symmetric view at RMAT scale 20
    and check it; returns the launch counts and the kernels' results."""
    from repro_torch.algorithms import (triangle_stream_property,
                                        triangles_static)
    from repro_torch.algorithms.triangle import _sym_bpv
    from repro_torch.core.batch import query_edges
    from repro_torch.core.slab_graph import pool_stats
    from repro_torch.core.worklist import pool_edges
    from repro_torch.data import synth
    from repro_torch.kernels import runtime
    from repro_torch.kernels.slab_intersect import (materialize_chains,
                                                    ops as intersect_ops,
                                                    search_edges_kernel)
    from repro_torch.launch.serve import EdgeLedger, pair_keys
    from repro_torch.stream import (GraphStore, MaintenancePolicy,
                                    PropertyRegistry, RequestPipeline,
                                    dedup_pairs)

    V = TRI_VERTICES
    torch.cuda.reset_peak_memory_stats()
    t0 = t_phase = time.perf_counter()
    marks = {}

    def mark(name):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter() - t_phase

    src, dst = synth.rmat_edges(V, TRI_EDGES, seed=0)
    src, dst, _ = dedup_pairs(src, dst)
    mark("graph generated")
    # two insert epochs, each opening at most one slab per symmetric lane
    store = GraphStore.from_edges(
        V, src, dst, hashing=True, with_transpose=False,
        with_symmetric=True, slack_slabs=4 * TRI_INSERTS + 512,
        maintenance=MaintenancePolicy(tombstone_ratio=TRI_TOMBSTONE_RATIO),
        device="cuda")
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    boot = check_boot_counts(torch, np, store, src, dst)
    mark("boot counts checked")
    emit({"phase": "triangles", "boot_s": boot_s,
          "count_check_s": time.perf_counter() - t0, **boot,
          "forward_edges": store.n_edges,
          "symmetric_pool": pool_stats(store.symmetric)})

    capture = CountCapture(intersect_ops.slab_count)
    registry = PropertyRegistry(store)
    pipeline = RequestPipeline(store, registry)
    ledger = EdgeLedger(src, dst)
    rng = np.random.default_rng(3)
    mark("ledger")
    responses = []
    runtime.reset_launches()
    with swapped(intersect_ops, slab_count=capture):
        capture.stage = "static"
        t0 = time.perf_counter()
        registry.register(triangle_stream_property())
        torch.cuda.synchronize()
        static_s = time.perf_counter() - t0
        capture.stage = None
        mark("static count")
        static_count = int(registry.read("triangles"))
        inserted = False
        for kind, req in triangle_requests(np, V, ledger, rng):
            capture.stage = ("delta" if kind == "read:triangles" and inserted
                             and "incremental" not in capture.got else None)
            before = dict(runtime.LAUNCHES)
            resp = pipeline.run([req])[0]
            launched = {k: n - before[k] for k, n in runtime.LAUNCHES.items()
                        if n > before[k]}
            responses.append((kind, req, resp, launched))
            inserted = inserted or kind == "insert"
            mark(f"request {len(responses) - 1}")
            emit({"phase": "triangles", "request": len(responses) - 1,
                  "kind": kind, "ms": 1e3 * resp.latency_s,
                  "version": resp.version, "launched": launched,
                  "maintenance_count": store.maintenance_count,
                  **({"triangles": int(resp.payload["value"])}
                     if resp.kind == "property" else {})})
        capture.stage = None
    maintained = int(registry.read("triangles"))
    check(store.maintenance_count >= 1,
          "the policy never compacted during the triangle stream")

    # membership through the probe kernel: the member queries and 4,096
    # edges of the ledger's symmetric closure
    g = store.symmetric
    pairs = EdgeLedger.pairs(ledger.keys)
    closure = closure_keys(np, pairs[:, 0], pairs[:, 1])
    mark("closure")
    member = responses[-1][1]
    sample = closure[np.random.default_rng(4).choice(len(closure), 4096,
                                                     replace=False)]
    sp = EdgeLedger.pairs(sample)
    qs = np.concatenate([np.asarray(member.src, np.uint32), sp[:, 0]])
    qd = np.concatenate([np.asarray(member.dst, np.uint32), sp[:, 1]])
    tq = [torch.from_numpy(a.view(np.int32).copy()).to(g.device)
          for a in (qs, qd)]
    mask = torch.ones(len(qs), dtype=torch.bool, device=g.device)
    max_chain = pool_stats(g)["max_chain"]
    mark("pool stats")
    found = search_edges_kernel(g, tq[0], tq[1], mask, max_chain=max_chain)
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    mark("membership")

    t0 = time.perf_counter()
    recount = int(triangles_static(g, max_bpv=_sym_bpv(g)))
    recount_s = time.perf_counter() - t0
    check(recount == maintained,
          f"maintained count {maintained} != static recount {recount}")

    # the symmetric view holds exactly the ledger's symmetric closure
    view = pool_edges(g)
    rows, lanes = torch.nonzero(view.valid, as_tuple=True)
    live = torch.sort((g.slab_vertex[rows].long() << 32)
                      | g.keys[rows, lanes].long()).values
    want = torch.from_numpy(closure.astype(np.int64)).to(g.device)
    check(live.numel() == want.numel() and torch.equal(live, want),
          f"symmetric view holds {live.numel()} lanes, the closure "
          f"{want.numel()}")
    del view, rows, lanes, live, want
    mark("recount and edge set")

    want_found = in_sorted(np, pair_keys(qs, qd), closure)
    check(np.array_equal(found.cpu().numpy(), want_found),
          "search_edges_kernel disagrees with the closure")
    check(torch.equal(found, query_edges(g, tq[0], tq[1])),
          "search_edges_kernel disagrees with query_edges")
    for name in ("slab_count", "probe_hits"):
        check(launches[name] > 0,
              f"{name} was never launched on the triangle path")
    for name in ("static", "incremental", "batch graph"):
        check(name in capture.got, f"slab_count never saw a {name} call")
    mark("membership checked")
    last = store.last_maintenance
    emit({"phase": "triangles", "static_s": static_s,
          "static_s_pr15": PR15_STATIC_S,
          "recount_s": recount_s, "triangles": maintained,
          "six_t": 6 * maintained,
          "static_total_int64": recount,
          "static_sum_above_int32": 6 * recount > INT32_MAX,
          "maintenance": {"passes": store.maintenance_count,
                          "last": last.describe() if last else None,
                          "events": store.maintenance_events},
          "membership_hits": int(found.sum()), "max_chain": max_chain,
          "kernels": launches,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "captured_active_items": {k: v["active"]
                                    for k, v in capture.got.items()},
          "marks_s": marks})
    print(f"triangles: {recount} (int64; the sum of |N(u) & N(v)| over the "
          f"symmetric edges is {6 * recount}, "
          f"{'above' if 6 * recount > INT32_MAX else 'within'} int32)",
          flush=True)

    rows = materialize_chains(g, tq[0], tq[1], mask, max_chain=max_chain)
    pools = [store.forward.keys, g.keys] + [
        t for c in capture.got.values() for t in (c["args"][0],
                                                  c["args"][4])]
    results = compare_triangle_kernels(torch, capture.got,
                                       (tq[1], rows, g.keys), pools)
    return {"launches": launches, "results": results,
            "static_count": static_count}


# ----------------------------------------------------------------------------
# phase 5: gemma2-9b prefill and decode at full width
# ----------------------------------------------------------------------------

#: the instantiations of the attention kernels in a ptxas log: the
#: forward's ``attn_<dtype>_kernel<D>`` and the backward's: delta and the
#: reduction ``attn_bwd_<part>_kernel<T, D...>``, the dK/dV and dQ passes
#: ``attn_bwd_<part>_<tc|f32>_kernel<D>`` (tc: the bf16 tensor-core form)
ATTN_FWD_NAME = r"attn_(bf16|f32)_kernelILi(\d+)E"
ATTN_BWD_NAME = (r"attn_bwd_(?:(delta|reduce)_kernelI(f|13__nv_bfloat16)"
                 r"|(dkdv|dq)_(tc|f32)_kernelI)Li(\d+)E")


def attention_build_readings(runtime, built: dict,
                             pattern: str = ATTN_FWD_NAME) -> dict:
    """Per instantiation of an attention kernel (``pattern``: the
    forward's by default): the registers, stack frame and spill bytes
    ``ptxas -v`` reported in the build log, and the count of tensor-core
    instructions (``HMMA``, ``HGMMA``) in its SASS from ``cuobjdump -sass``
    of the built library."""
    kernels = {}
    cur = None
    for ln in built["log"].splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", ln)
        if m:
            cur = None
            name = re.search(pattern, m.group(1))
            if name:
                groups = [g for g in name.groups()[:-1] if g]
                if pattern != ATTN_FWD_NAME:
                    # the backward's dtype as "bf16" or "f" (float32)
                    groups = [{"13__nv_bfloat16": "bf16", "tc": "bf16",
                               "f32": "f"}.get(g, g) for g in groups]
                key = " ".join(groups)
                cur = kernels.setdefault(f"{key} D={name.groups()[-1]}",
                                         {"mangled": m.group(1)})
            continue
        if cur is None:
            continue
        for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers")):
            m = re.search(pat, ln)
            if m:
                cur[key] = int(m.group(1))
    sass = subprocess.run(
        [str(Path(runtime.nvcc()).with_name("cuobjdump")), "-sass",
         built["path"]], capture_output=True, text=True, check=True).stdout
    owner = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            owner = next((r for r in kernels.values()
                          if r["mangled"] == m.group(1)), None)
            if owner is not None:
                owner["tensor_core_instructions"] = 0
        elif owner is not None and re.search(r"\bHG?MMA\b", ln):
            owner["tensor_core_instructions"] += 1
    return kernels


def check_attention_build(runtime, built: dict, built_bwd=None) -> None:
    """Every instantiation of the attention kernel (bf16 and float32,
    head_dim 64, 128, 256) builds with no spill; the bf16 ones run on the
    tensor cores.  So does every one of its backward's four kernels, given
    ``built_bwd``: no spill, and the bf16 dK/dV and dQ passes on the tensor
    cores (HGMMA).  Prints each one's registers."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS

    kernels = attention_build_readings(runtime, built)
    bwd = {} if built_bwd is None else attention_build_readings(
        runtime, built_bwd, ATTN_BWD_NAME)
    emit({"phase": "lm_attention_build", "kernels": kernels,
          "backward": bwd})
    for part in BWD_PARTS if built_bwd is not None else ():
        for dtype in ("bf16", "f"):
            for D in HEAD_DIMS:
                r = bwd.get(f"{part} {dtype} D={D}")
                check(r is not None and "registers" in r,
                      f"ptxas reported no backward {part} kernel ({dtype}) "
                      f"for head_dim {D}")
                check(r.get("spill_store_bytes") == 0
                      and r.get("spill_load_bytes") == 0,
                      f"the backward {part} kernel ({dtype}) spills at "
                      f"head_dim {D}: {r}")
                if dtype == "bf16" and part in ("dkdv", "dq"):
                    check(r.get("tensor_core_instructions", 0) > 0,
                          f"the bf16 backward {part} kernel's SASS holds "
                          f"no HGMMA at head_dim {D}")
    for dtype in ("bf16", "f32"):
        for D in HEAD_DIMS:
            r = kernels.get(f"{dtype} D={D}")
            check(r is not None and "registers" in r,
                  f"ptxas reported no {dtype} attention kernel for head_dim "
                  f"{D}")
            check(r.get("spill_store_bytes") == 0
                  and r.get("spill_load_bytes") == 0,
                  f"the {dtype} attention kernel spills at head_dim {D}: {r}")
            if dtype == "bf16":
                check(r.get("tensor_core_instructions", 0) > 0,
                      f"the bf16 attention kernel's SASS holds no HMMA/HGMMA "
                      f"at head_dim {D}")


def visible_pairs(S: int, window: int) -> int:
    """(q, k) pairs a causal query sequence of S tokens attends to (query i
    sees min(i + 1, window) keys under a window)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def capture_attention(torch, tfm, got: dict):
    """Stands in for the flash-attention op in the model and keeps the
    inputs of its first local and first global call (k and v cloned: they
    are views of the prefill's cache; ``impl`` dropped, as the comparison
    calls the kernel and its plain version by name)."""
    real = tfm.flash_attention

    def attn(q, k, v, **kw):
        name = "local" if kw.get("window", 0) > 0 else "global"
        if name not in got:
            got[name] = (q, k.clone(), v.clone(),
                         {a: b for a, b in kw.items() if a != "impl"})
        return real(q, k, v, **kw)
    return attn


def rows_attention(torch, q, k, v, rows, *, window: int, softcap: float,
                   drop=None, edge: int = 0):
    """Dense float32 attention of the query rows ``rows`` (absolute
    positions) under the causal / window mask, with a planted fault: the
    key range ``drop`` hidden, or the mask's edge moved by ``edge`` keys
    (the window's start later, or the causal edge later).  q (B, Hq, S, D),
    k and v (B, Hkv, S, D) -> (B, Hq, len(rows), D) float32."""
    group = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows].float(), kk)
    del kk
    s.mul_(q.shape[-1] ** -0.5)
    if softcap > 0:
        s.div_(softcap).tanh_().mul_(softcap)
    qi = rows[:, None]
    kj = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = qi + (0 if window else edge) >= kj
    if window > 0:
        mask &= qi - kj < window - edge
    if drop is not None:
        mask &= (kj < drop[0]) | (kj >= drop[1])
    s.masked_fill_(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.float().repeat_interleave(group, dim=1))


def attention_tolerance_readings(torch, q, k, v, kw, plain, *,
                                 atol: float = ATTN_ATOL,
                                 rtol: float = ATTN_RTOL,
                                 tile: int = 64) -> dict:
    """How large the compared outputs are, and whether the tolerance
    (``atol``, ``rtol``) fails a kernel that is wrong by one key tile of
    ``tile`` keys (the kernel's own: 64 in bf16, 32 in float32): on the
    last 64 query rows, a dense float32 attention with the middle key tile
    of the last row's band dropped, and one with the mask's edge moved by a
    tile (a local layer's window start ``tile`` keys later, a global
    layer's causal edge ``tile`` keys later), each rounded to q's dtype and
    held to ``plain`` as the kernel is."""
    S, window = q.shape[2], kw.get("window", 0)
    a = plain.float().abs()
    row_median = a.median(dim=-1).values.flatten()
    out = {"mean_abs": float(a.mean()),
           "row_median_abs": {
               "median": float(row_median.median()),
               "p01": float(torch.quantile(row_median, 0.01))}}
    del a, row_median
    rows = torch.arange(S - 64, S, device=q.device)
    want = plain[:, :, S - 64:].float()
    lo = S - window if 0 < window < S else 0
    mid = (lo + S) // 2 // tile * tile
    sane = rows_attention(torch, q, k, v, rows, window=window,
                          softcap=kw.get("softcap", 0.0))
    sane = sane.to(q.dtype).float()
    out["dense_rows_err"] = float((sane - want).abs().max())
    out["dense_rows_close"] = torch.allclose(sane, want, atol=atol,
                                             rtol=rtol)
    del sane
    for fault, extra in (("tile_dropped", {"drop": (mid, mid + tile)}),
                         ("edge_by_tile", {"edge": tile})):
        bad = rows_attention(torch, q, k, v, rows, window=window,
                             softcap=kw.get("softcap", 0.0), **extra)
        bad = bad.to(q.dtype).float()
        d = (bad - want).abs()
        outside = d > atol + rtol * want.abs()
        out[fault] = {
            "max_abs": float(d.max()), "mean_abs": float(d.mean()),
            "share_outside": float(outside.float().mean()),
            "caught": bool(outside.any()),
            "caught_at_2e-2": not torch.allclose(bad, want, atol=2e-2,
                                                 rtol=2e-2)}
        del bad, d, outside
    return out


def sdpa(torch, q, k, v, window: int):
    """PyTorch's SDPA on the shape of a captured layer, the yardstick beside
    kernel 10 (never called by the port): causal with GQA, or with a
    boolean band mask for a window; it has no softcap.  -> (call, what)."""
    import torch.nn.functional as F

    if window > 0:
        i = torch.arange(q.shape[2], device=q.device)
        band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        return (lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=band, enable_gqa=True),
            "SDPA, boolean band mask, no softcap")
    return (lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True),
        "SDPA, is_causal, no softcap")


def compare_attention(torch, captured, *, layers=None,
                      model: str = "") -> list:
    """Kernel 10 against ``attention_ref`` on the captured local and global
    layers (``layers``: name -> layer index, gemma2-9b's first local and
    global layers by default; ``model`` prefixes the variant), at bf16 with
    the reference test's tolerance; both timed on the device alone.  Beside
    them the library call: SDPA (causal, GQA) on the global shape against
    the kernel rerun with softcap 0, and SDPA with a boolean band mask on
    the local shape, likewise without softcap (SDPA has no softcap)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    layers = layers or {"local": 0, "global": 1}
    results = []
    for name, layer in layers.items():
        q, k, v, kw = captured[name]
        B, Hq, S, D = q.shape
        kern = flash_attention(q, k, v, **kw)
        plain = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((kern.float() - plain.float()).abs().max())
        check(torch.allclose(kern.float(), plain.float(), atol=ATTN_ATOL,
                             rtol=ATTN_RTOL),
              f"flash_attention differs from attention_ref on the {name} "
              f"layer by {err}")
        readings = attention_tolerance_readings(torch, q, k, v, kw, plain)
        del plain
        emit({"phase": "lm_attention_tolerance", "layer": model + name,
              "atol": ATTN_ATOL, "rtol": ATTN_RTOL, **readings})
        check(readings["dense_rows_close"],
              f"the dense rows differ from attention_ref on the {name} "
              f"layer by {readings['dense_rows_err']}")
        for fault in ("tile_dropped", "edge_by_tile"):
            check(readings[fault]["caught"],
                  f"the kernel's tolerance passes a planted fault ({fault}) "
                  f"on the {name} layer")
        window = kw.get("window", 0)
        nocap = dict(kw, softcap=0.0)
        kern0 = flash_attention(q, k, v, **nocap)
        library, library_what = sdpa(torch, q, k, v, window)
        lib_out = library()
        torch.cuda.synchronize()
        lib_err = float((kern0.float() - lib_out.float()).abs().max())
        check(torch.allclose(kern0.float(), lib_out.float(), atol=LIB_TOL,
                             rtol=LIB_TOL),
              f"the kernel without softcap differs from SDPA on the {name} "
              f"layer by {lib_err}")
        del kern0, lib_out
        pairs = visible_pairs(S, window)
        n_bytes = (q.numel() + k.numel() + v.numel() + kern.numel()) \
            * q.element_size()
        results.append(dict(
            name="flash_attention", variant=f"{model}{name} (layer "
            f"{layer})", window=window,
            shape={"q": list(q.shape), "kv": list(k.shape)},
            max_abs_err=err,
            ms=device_ms(torch, lambda: flash_attention(q, k, v, **kw)),
            plain_ms=device_ms(torch, lambda: attention_ref(q, k, v, **kw)),
            ms_softcap0=device_ms(torch,
                                  lambda: flash_attention(q, k, v, **nocap)),
            library_ms=device_ms(torch, library), library=library_what,
            library_max_abs_err=lib_err, pairs_per_head=pairs,
            **bound(n_bytes, pairs * B * Hq * 4 * D,
                    ops_per_s=BF16_OPS_PER_S)))
        del kern
        torch.cuda.empty_cache()
    for r in results:
        emit({"phase": "lm_kernels", **r})
    return results


def time_attention_f32(torch, captured) -> list:
    """Kernel 10's float32 variant (the CUDA-core kernel the float32 serve
    runs) on the q/k/v of that serve's first local and first global layer:
    held to ``attention_ref`` within ATTN_F32_ATOL / ATTN_F32_RTOL (the
    error recorded before the redesign printed beside), with a dropped
    32-key tile and a mask edge moved by 32 keys shown to fail that
    tolerance; then its time
    beside the plain version's and SDPA's without softcap, each on the
    device alone.
    Its bound is the float32 CUDA-core rate: a float32 product on the
    tensor cores (TF32) would not hold the float32 gates."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    results = []
    for name in ("local", "global"):
        q, k, v, kw = captured.pop(name)
        B, Hq, S, D = q.shape
        window = kw.get("window", 0)
        kern = flash_attention(q, k, v, **kw)
        plain = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((kern - plain).abs().max())
        close = torch.allclose(kern, plain, atol=ATTN_F32_ATOL,
                               rtol=ATTN_F32_RTOL)
        del kern
        readings = attention_tolerance_readings(
            torch, q, k, v, kw, plain, atol=ATTN_F32_ATOL,
            rtol=ATTN_F32_RTOL, tile=ATTN_F32_KEY_TILE)
        del plain
        emit({"phase": "lm_attention_tolerance", "layer": f"{name} float32",
              "atol": ATTN_F32_ATOL, "rtol": ATTN_F32_RTOL,
              "max_abs_err": err,
              "max_abs_err_recorded_before_redesign":
                  F32_ATTN_ERR_RECORDED_BEFORE[name],
              **readings})
        check(close, f"the float32 flash_attention differs from "
                     f"attention_ref on the {name} layer by {err}")
        check(readings["dense_rows_close"],
              f"the float32 dense rows differ from attention_ref on the "
              f"{name} layer by {readings['dense_rows_err']}")
        for fault in ("tile_dropped", "edge_by_tile"):
            check(readings[fault]["caught"],
                  f"the float32 tolerance passes a planted fault ({fault}) "
                  f"on the {name} layer")
        nocap = dict(kw, softcap=0.0)
        library, library_what = sdpa(torch, q, k, v, window)
        pairs = visible_pairs(S, window)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        results.append(dict(
            name="flash_attention", variant=f"{name} float32 (float32 "
            "serve)", window=window,
            shape={"q": list(q.shape), "kv": list(k.shape)},
            max_abs_err=err,
            ms=device_ms(torch, lambda: flash_attention(q, k, v, **kw)),
            plain_ms=device_ms(torch, lambda: attention_ref(q, k, v, **kw)),
            ms_softcap0=device_ms(torch,
                                  lambda: flash_attention(q, k, v, **nocap)),
            library_ms=device_ms(torch, library), library=library_what,
            pairs_per_head=pairs,
            **bound(n_bytes, pairs * B * Hq * 4 * D)))
        del q, k, v
        torch.cuda.empty_cache()
    for r in results:
        emit({"phase": "lm_kernels", **r})
    return results


def decode_readings(torch, model, cache, generated, want) -> dict:
    """The first LM_FAULT_STEPS decode steps again on ``cache`` (seeded
    from a prefill of LM_PROMPT tokens, its slots past the prompt unused),
    fed the generated tokens: as served, with the position off by one
    (RoPE and the cache slot), and with the ring caches one slot off.  Each
    run's logits against ``want`` (B, LM_FAULT_STEPS, V), forward's at the
    same positions: max and mean |difference| and argmax agreement.  The
    ring slots the runs write are restored between them; the ring fault
    runs last, as it leaves the ring rolled."""
    n = LM_FAULT_STEPS
    rings = [cache["k_local"], cache["v_local"]]
    saved = [r[:, :, :, :n + 1].clone() for r in rings]
    out = {}
    for fault, shift, ring_shift in (("none", 0, 0),
                                     ("position_plus_1", 1, 0),
                                     ("ring_slot_plus_1", 0, 1)):
        for r, kept in zip(rings, saved):
            r[:, :, :, :n + 1].copy_(kept)
            if ring_shift:
                r.copy_(r.roll(ring_shift, dims=3))
        for name in ("k", "v"):
            cache[name][:, :, :, LM_PROMPT:].zero_()
        got = torch.stack([model.decode_step(cache, generated[i],
                                             LM_PROMPT + i + shift)[0]
                           for i in range(n)], dim=1)
        d = (got - want).abs()
        out[fault] = {"max": float(d.max()), "mean": float(d.mean()),
                      "argmax_agreement": float(
                          (got.argmax(-1) == want.argmax(-1))
                          .float().mean())}
        del got, d
    return out


def lm_phase(torch, np, attn_build: dict, bwd_build=None, *,
             seed: int = 0) -> dict:
    """Serve gemma2-9b at full width: a prefill of 2 prompts of 8,192 tokens
    and LM_NEW greedy decode steps, with the launch counts zeroed just before
    the prefill and read after the last step; then the self-checks and the
    kernel against its plain version.  First, the attention kernel's build
    (``attn_build``: ``runtime.build(verbose=True)``'s entry for it, with
    the ``ptxas -v`` log) is checked: no spill in any instantiation, and
    tensor-core instructions in every bf16 one.  ``seed`` draws the weights
    and the prompts."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synth
    from repro_torch.kernels import runtime
    from repro_torch.launch.steps import (build_lm_decode_step,
                                          build_lm_prefill_step)
    from repro_torch.models import transformer as tfm

    check_attention_build(runtime, attn_build, bwd_build)

    # 42 layers, d_model 3584, GQA 16/8, head_dim 256, local(4096)/global
    # alternation, softcaps 50 and 30, bf16
    cfg = get_arch("gemma2-9b").full_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = tfm.init_params(cfg, gen, dtype=torch.bfloat16)
    model = tfm.TransformerLM(cfg, params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks, _ = next(synth.lm_batches(cfg.vocab_size, LM_BATCH, LM_PROMPT,
                                    seed=seed))
    tokens = torch.from_numpy(toks).to("cuda")
    prefill = build_lm_prefill_step(cfg)
    decode = build_lm_decode_step(cfg)

    captured = {}
    runtime.reset_launches()
    t0 = time.perf_counter()
    with swapped(tfm, flash_attention=capture_attention(torch, tfm,
                                                        captured)):
        logits, pc = prefill(model, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = runtime.LAUNCHES["flash_attention"]

    # the decode cache, seeded from the prefill's: k/v into slots 0..S-1,
    # the ring caches as they are (S is a multiple of the window, so slot
    # pos % window of the ring holds position pos)
    def seeded_cache():
        cache = tfm.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_NEW)
        for name, t in pc.items():
            cache[name][:, :, :, :t.shape[3]].copy_(t)
        return cache

    cache = seeded_cache()
    kv_bytes = {"prefill": sum(t.numel() * t.element_size()
                               for t in pc.values()),
                "decode": sum(t.numel() * t.element_size()
                              for t in cache.values())}
    token = logits.argmax(dim=-1)
    generated, step_logits, decode_ms = [], [], []
    for i in range(LM_NEW):
        generated.append(token)
        t0 = time.perf_counter()
        lg, cache = decode(model, cache, token, LM_PROMPT + i)
        torch.cuda.synchronize()
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        step_logits.append(lg)
        token = lg.argmax(dim=-1)
    launches = dict(runtime.LAUNCHES)
    # the last step again under the profiler (it writes the same key and
    # value into the same slots): the card's busy time in a decode step
    pos = LM_PROMPT + LM_NEW - 1
    decode_busy = busy_time(torch, lambda: decode(model, cache,
                                                  generated[-1], pos))
    del cache
    torch.cuda.empty_cache()
    decode_s = sum(decode_ms) / 1e3
    peak = torch.cuda.max_memory_allocated()
    # the prefill again, warm: its time and its own peak, then where the
    # card spends it
    with step_peak(torch, model, tokens) as warm_peak:
        t0 = time.perf_counter()
        prefill(model, tokens)
        torch.cuda.synchronize()
        prefill_warm_s = time.perf_counter() - t0
    prefill_busy = busy_time(torch, lambda: prefill(model, tokens), top=8)
    emit({"phase": "lm", "model": cfg.name, "seed": seed,
          "n_params": cfg.n_params(),
          "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
          "init_s": init_s, "prefill_ms": 1e3 * prefill_s,
          "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
          "prefill_warm_ms": 1e3 * prefill_warm_s,
          "prefill_profile": prefill_busy,
          "decode_ms_median": statistics.median(decode_ms),
          "decode_ms_first": decode_ms[0], "decode_ms_max": max(decode_ms),
          "decode_tokens_per_s": LM_BATCH * LM_NEW / decode_s,
          "decode_step_profile": decode_busy,
          "decode_idle_share": None if decode_busy is None else
          1 - decode_busy["busy_ms"] / statistics.median(decode_ms),
          "kv_cache_bytes": kv_bytes, "max_memory_allocated": peak,
          "prefill_launches": prefill_launches, "kernels": launches})
    emit({"phase": "lm", "request_ms": [1e3 * prefill_s] + decode_ms})
    check(prefill_launches == cfg.n_layers,
          f"the prefill launched flash_attention {prefill_launches} times, "
          f"not once per layer ({cfg.n_layers})")
    check(launches["flash_attention"] == cfg.n_layers,
          "decode should launch no flash_attention")
    check(set(captured) == {"local", "global"},
          "the prefill should run local and global layers")

    # self-checks without the reference: forward over prompt + generated
    # tokens, through the kernel, at the prefill's and every decode step's
    # position
    seq = torch.cat([tokens, torch.stack(generated, dim=1)], dim=1)
    before = runtime.LAUNCHES["flash_attention"]
    t0 = time.perf_counter()
    full = model(seq)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    fwd_launches = runtime.LAUNCHES["flash_attention"] - before
    want = full[:, LM_PROMPT - 1:].float()          # (B, 1 + LM_NEW, V)
    check(bool(torch.isfinite(full).all()), "forward logits not finite")
    del full
    torch.cuda.empty_cache()
    got = torch.cat([logits[:, None], torch.stack(step_logits, dim=1)],
                    dim=1)
    check(got.shape == want.shape == (LM_BATCH, 1 + LM_NEW,
                                      cfg.vocab_size),
          f"logits of shape {tuple(got.shape)}, forward's {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), "served logits not finite")
    diff = (got - want).abs()
    err_prefill = float(diff[:, 0].max())
    err_decode = float(diff[:, 1:].max())
    same_argmax = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    check(fwd_launches == cfg.n_layers,
          f"forward launched flash_attention {fwd_launches} times")
    del diff, step_logits

    # the gates' power: the first steps again with planted faults
    n = LM_FAULT_STEPS
    faults = decode_readings(torch, model, seeded_cache(), generated,
                             want[:, 1:1 + n])
    del pc, model
    gc.collect()

    # the float32 oracle: the same weights and tokens through a float32
    # forward (the kernel's float32 variant, matrix products without TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    params["embed"] = params["embed"].float()
    params["final_norm"] = params["final_norm"].float()
    for name in list(params["layers"]):
        params["layers"][name] = params["layers"][name].float()
    torch.cuda.empty_cache()
    model32 = tfm.TransformerLM(dataclasses.replace(cfg, dtype=torch.float32),
                                params)
    t0 = time.perf_counter()
    full = model32(seq)
    exact = full[:, LM_PROMPT - 1:].clone()
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    del full
    torch.cuda.empty_cache()

    # the float32 model serves too: its prefill seeds a float32 cache (k and
    # v grown by the slots the runs write, the ring caches as they are), and
    # decode_readings runs its first steps against the float32 forward.
    # Without bf16 rounding the two paths differ by float32 reordering
    # alone, so LM_F32_ATOL can sit below what a planted fault moves.
    captured32 = {}
    t0 = time.perf_counter()
    with swapped(tfm, flash_attention=capture_attention(torch, tfm,
                                                        captured32)):
        last32, pc32 = model32.prefill(tokens)
    torch.cuda.synchronize()
    prefill32_s = time.perf_counter() - t0
    err32_prefill = float((last32 - exact[:, 0]).abs().max())
    del last32
    cache32 = {name: pc32.pop(name) for name in ("k_local", "v_local")}
    for name in ("k", "v"):
        t = pc32.pop(name)
        cache32[name] = t.new_zeros(t.shape[:3] + (LM_PROMPT + n + 1,)
                                    + t.shape[4:])
        cache32[name][:, :, :, :LM_PROMPT].copy_(t)
        del t
    faults32 = decode_readings(torch, model32, cache32, generated,
                               exact[:, 1:1 + n])
    del cache32, pc32, model32, params
    gc.collect()
    torch.cuda.empty_cache()

    def dist(a, b):
        d = (a - b).abs()
        return {"max": float(d.max()), "mean": float(d.mean())}
    emit({"phase": "lm_check", "forward_ms": 1e3 * forward_s,
          "forward_tokens": int(seq.numel()),
          "forward_launches": fwd_launches, "f32_oracle_ms": 1e3 * oracle_s,
          "f32_prefill_ms": 1e3 * prefill32_s,
          "prefill_vs_forward": dist(got[:, :1], want[:, :1]),
          "decode_vs_forward": dist(got[:, 1:], want[:, 1:]),
          "forward_vs_f32": dist(want, exact),
          "decode_vs_f32": dist(got[:, 1:], exact[:, 1:]),
          "prefill_vs_f32": dist(got[:, :1], exact[:, :1]),
          "max_abs_logit": float(want.abs().max()),
          "argmax_agreement": same_argmax, "atol": LM_LOGIT_ATOL,
          "fault_steps": n, "bf16_decode_readings": faults,
          "f32_atol": LM_F32_ATOL, "f32_prefill_vs_forward": err32_prefill,
          "f32_decode_readings": faults32})
    del got, want, exact
    check(err_prefill <= LM_LOGIT_ATOL,
          f"prefill logits differ from forward's by {err_prefill}")
    check(err_decode <= LM_LOGIT_ATOL,
          f"decode logits differ from forward's by {err_decode}")
    check(err32_prefill <= LM_F32_ATOL,
          f"the float32 prefill differs from its forward by {err32_prefill}")
    check(faults32["none"]["max"] <= LM_F32_ATOL,
          f"the float32 decode differs from its forward by "
          f"{faults32['none']['max']}")
    for fault in ("position_plus_1", "ring_slot_plus_1"):
        check(faults32[fault]["max"] > LM_F32_ATOL,
              f"the float32 decode check passes a planted fault ({fault}: "
              f"{faults32[fault]['max']})")
    torch.cuda.empty_cache()
    results = compare_attention(torch, captured)
    results += time_attention_f32(torch, captured32)
    # the bf16 layers' inputs, kept on the host for the train phase
    kept = {f"gemma2-9b {name} (layer {layer})":
            tuple(t.cpu() for t in captured[name][:3]) + (captured[name][3],)
            for name, layer in (("local", 0), ("global", 1))}
    return {"launches": launches, "results": results, "captured": kept,
            "dry": {"ms": 1e3 * prefill_warm_s, "peak": warm_peak["bytes"]}}


# ----------------------------------------------------------------------------
# MIND over histories from the served graph
# ----------------------------------------------------------------------------

def mind_phase(torch, np, graph, *, seed: int = 0) -> dict:
    """MIND at its full config (a 2**21 x 64 item table, 4 interests, 3
    routing iterations, 50-item histories, random weights from a seeded
    generator) over histories read from ``graph``, the served forward view
    after its updates (``history_from_slab``: user vertex -> its first slab
    list's items): ``serve_p99`` (512 users, 4,096 candidates),
    ``serve_bulk`` (262,144 users) and ``retrieval_cand`` (1 user, 10**6
    pre-materialised candidate embeddings), users drawn from the vertices
    with out-edges.  Histories are held bit for bit to the per-user
    ``slab_iterator`` on a sample of users (the hub among them); scores to
    the same functions on CPU copies (serve_bulk on its first
    MIND_CPU_ROWS users) within MIND_ATOL / MIND_RTOL."""
    from repro_torch.configs import get_arch
    from repro_torch.core.iterators import slab_iterator
    from repro_torch.models.recsys import mind

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("mind").full_config()
    shapes = get_arch("mind").SHAPES
    check(graph.n_vertices <= cfg.n_items, f"{graph.n_vertices} vertices "
          f"hold item ids past the table's {cfg.n_items} rows")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = mind.init_params(cfg, gen)
    host = {k: v.cpu() for k, v in params.items()}
    rng = np.random.default_rng(seed)
    active = torch.nonzero(graph.degree > 0)[:, 0].cpu().numpy()
    out = {"phase": "mind", "model": cfg.name, "items": cfg.n_items,
           "graph_vertices": graph.n_vertices,
           "users_with_edges": int(active.size), "calls": {}}

    # histories: the card's batched walk against slab_iterator per user
    users = np.concatenate([[0], rng.choice(active, MIND_SAMPLE_USERS - 1)])
    hist, mask = mind.history_from_slab(graph, torch.from_numpy(users)
                                        .cuda(), hist_len=cfg.hist_len)
    for i, u in enumerate(users.tolist()):
        items, cnt = slab_iterator(graph, u, max_neighbors=cfg.hist_len)
        keep = torch.arange(cfg.hist_len, device="cuda") < cnt
        check(torch.equal(hist[i], torch.where(keep, items, -1))
              and torch.equal(mask[i], keep.float()),
              f"history of user {u} differs from slab_iterator's")
    out["history_check_users"] = int(users.size)
    out["hub_history_len"] = int(mask[0].sum())

    for shape in MIND_SHAPES:
        spec = shapes[shape]
        B, Nc = spec["batch"], spec["n_candidates"]
        users = torch.from_numpy(rng.choice(active, B)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist, mask = mind.history_from_slab(graph, users,
                                            hist_len=cfg.hist_len)
        torch.cuda.synchronize()
        hist_ms = 1e3 * (time.perf_counter() - t0)
        if spec["kind"] == "serve":
            cand = torch.from_numpy(rng.integers(0, cfg.n_items, Nc)).cuda()

            def call(p, h, m, c):
                return mind.serve_scores(p, h, m, c, cfg)
        else:
            cand = params["item_embed"][:Nc]

            def call(p, h, m, c):
                return mind.retrieval_scores(p, h, m, c, cfg)
        ms = []
        for _ in range(2):                       # first call, then warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = call(params, hist, mask, cand)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        check(scores.shape == (B, Nc) and bool(torch.isfinite(scores).all()),
              f"MIND {shape}: scores {tuple(scores.shape)} not finite")
        rows = min(B, MIND_CPU_ROWS)
        want = call(host, hist[:rows].cpu(), mask[:rows].cpu(), cand.cpu())
        got = scores[:rows].cpu()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=MIND_ATOL, rtol=MIND_RTOL),
              f"MIND {shape}: scores differ from the CPU's by {err}")
        out["calls"][shape] = {
            "batch": B, "candidates": Nc, "history_ms": hist_ms,
            "scores_ms": ms[0], "scores_warm_ms": ms[1],
            "mean_history_len": float(mask.sum(dim=1).mean()),
            "cpu_rows": rows, "max_abs_err": err,
            "max_abs_score": float(want.abs().max())}
        del scores, hist, mask, cand
        torch.cuda.empty_cache()
    emit(out)
    del params
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------------
# phase 5b: the MoE LM at full width
# ----------------------------------------------------------------------------

def moe_faults(torch, tfm) -> dict:
    """Planted faults of the MoE FFN, each a stand-in for ``moe_ffn`` (one
    dispatch group): the second-highest gate's expert dropped, and the
    top-k gates left without their renormalisation."""
    route_of, experts = tfm.moe_route, tfm.moe_experts

    def faulty(edit):
        def ffn(x, lw, cfg):
            xg = x[None]
            route = route_of(xg, lw["router"], cfg)
            edit(route, xg, lw)
            return experts(xg, lw, cfg, route)[0]
        return ffn

    def drop_second(route, xg, lw):
        route.top_g = route.top_g.clone()
        route.top_g[..., 1] = 0

    def raw_gates(route, xg, lw):
        gates = torch.softmax((xg @ lw["router"]).float(), dim=-1)
        route.top_g = gates.gather(-1, route.top_e)

    return {"second_expert_dropped": faulty(drop_second),
            "renormalisation_skipped": faulty(raw_gates)}


def moe_drop_recorder(torch, tfm, shares: list):
    """Stands in for ``moe_ffn`` and appends, per call (one a layer), the
    share of (token, expert) assignments past their expert's capacity (a
    device scalar, read after the call)."""
    real = tfm.moe_ffn

    def ffn(x, lw, cfg):
        route = tfm.moe_route(x[None], lw["router"], cfg)
        shares.append(1 - route.keep.float().mean())
        return real(x, lw, cfg)
    return ffn


def moe_decode_readings(torch, tfm, model, tokens, n: int) -> dict:
    """The decode gate's readings at capacity E / K: a prefill of
    ``tokens`` (B, MOE_SHORT), ``n`` greedy decode steps, and ``forward``
    over prompt and generated tokens, which drops no assignment at that
    capacity; then the same steps with a planted fault each (the position
    off by one, an MoE fault).  Each run's max |difference| from
    forward's logits at the same positions."""
    B, S = tokens.shape
    last, pc = model.prefill(tokens)
    cache = tfm.init_cache(model.cfg, B, S + n + 1)
    for name in ("k", "v"):
        cache[name][:, :, :, :S].copy_(pc[name])
    del pc
    generated, steps = [], []
    token = last.argmax(dim=-1)
    for i in range(n):
        generated.append(token)
        lg, cache = model.decode_step(cache, token, S + i)
        steps.append(lg)
        token = lg.argmax(dim=-1)
    seq = torch.cat([tokens, torch.stack(generated, dim=1)], dim=1)
    shares = []
    with swapped(tfm, moe_ffn=moe_drop_recorder(torch, tfm, shares)):
        want = model(seq)[:, S - 1:S - 1 + n + 1].float()
    dropped = max(float(x) for x in shares)
    got = torch.cat([last[:, None], torch.stack(steps, dim=1)], dim=1)
    out = {"prefill": float((got[:, 0] - want[:, 0]).abs().max()),
           "decode": float((got[:, 1:] - want[:, 1:]).abs().max()),
           "decode_mean": float((got[:, 1:] - want[:, 1:]).abs().mean()),
           "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                     .float().mean()),
           "forward_dropped_share": dropped, "faults": {},
           "faults_mean": {}}
    for fault, shift, ffn in (
            [("position_plus_1", 1, None)]
            + [(name, 0, f) for name, f in moe_faults(torch, tfm).items()]):
        cache["k"][:, :, :, S:].zero_()
        cache["v"][:, :, :, S:].zero_()
        with swapped(tfm, **({} if ffn is None else {"moe_ffn": ffn})):
            lg = torch.stack([model.decode_step(cache, generated[i],
                                                S + i + shift)[0]
                              for i in range(n)], dim=1)
        d = (lg - want[:, 1:]).abs()
        out["faults"][fault] = float(d.max())
        out["faults_mean"][fault] = float(d.mean())
    return out


def moe_phase(torch, np, *, seed: int = 0) -> dict:
    """Serve qwen3-moe-30b-a3b at its full config (48 layers, d_model 2048,
    GQA 32/4, QK norm, 128 experts top-8, vocab 151,936, bf16, random
    weights from a seeded generator, drawn a layer at a time): a prefill of
    LM_BATCH prompts of LM_PROMPT tokens (one ``flash_attention`` launch a
    layer) and LM_NEW greedy decode steps through ``launch.steps``, with
    the launch counts zeroed just before the prefill and read after the
    last step, and the share of assignments each layer drops at capacity
    1.25.  Self-checks without the reference: the prefill's logits against
    ``forward``'s over the same prompts (the same T, so the same
    assignments drop), and decode against forward at capacity E / K over
    a shorter prompt, each gate shown to fail planted faults; kernel 10
    held to ``attention_ref`` on the first layer's captured q/k/v."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synth
    from repro_torch.kernels import runtime
    from repro_torch.launch.steps import (build_lm_decode_step,
                                          build_lm_prefill_step)
    from repro_torch.models import transformer as tfm

    cfg = get_arch(MOE_ARCH).full_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = tfm.init_params(cfg, gen, dtype=torch.bfloat16)
    model = tfm.TransformerLM(cfg, params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    toks, _ = next(synth.lm_batches(cfg.vocab_size, LM_BATCH, LM_PROMPT,
                                    seed=seed))
    tokens = torch.from_numpy(toks).to("cuda")
    prefill = build_lm_prefill_step(cfg)
    decode = build_lm_decode_step(cfg)

    captured, shares = {}, []
    runtime.reset_launches()
    t0 = time.perf_counter()
    with swapped(tfm, flash_attention=capture_attention(torch, tfm,
                                                        captured),
                 moe_ffn=moe_drop_recorder(torch, tfm, shares)):
        logits, pc = prefill(model, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = runtime.LAUNCHES["flash_attention"]
    dropped = [float(x) for x in shares]

    cache = tfm.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_NEW)
    for name in ("k", "v"):
        cache[name][:, :, :, :LM_PROMPT].copy_(pc[name])
    del pc
    token = logits.argmax(dim=-1)
    decode_ms = []
    for i in range(LM_NEW):
        t0 = time.perf_counter()
        lg, cache = decode(model, cache, token, LM_PROMPT + i)
        torch.cuda.synchronize()
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        check(bool(torch.isfinite(lg).all()),
              f"decode step {i} logits not finite")
        token = lg.argmax(dim=-1)
    launches = dict(runtime.LAUNCHES)
    del cache, lg
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    with step_peak(torch, model, tokens) as warm_peak:
        t0 = time.perf_counter()
        warm, _ = prefill(model, tokens)
        torch.cuda.synchronize()
        prefill_warm_s = time.perf_counter() - t0
    emit({"phase": "moe", "model": cfg.name, "seed": seed,
          "n_params": cfg.n_params(), "param_bytes": param_bytes,
          "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
          "capacity": tfm.moe_capacity(LM_BATCH * LM_PROMPT, cfg),
          "init_s": init_s, "prefill_ms": 1e3 * prefill_s,
          "prefill_warm_ms": 1e3 * prefill_warm_s,
          "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_warm_s,
          "prefill_bit_equal_warm": bool(torch.equal(warm, logits)),
          "decode_ms_median": statistics.median(decode_ms),
          "decode_ms_first": decode_ms[0], "decode_ms_max": max(decode_ms),
          "decode_tokens_per_s": LM_BATCH * LM_NEW / (sum(decode_ms) / 1e3),
          "dropped_share_per_layer": dropped,
          "dropped_share_mean": statistics.mean(dropped),
          "max_memory_allocated": peak,
          "prefill_launches": prefill_launches, "kernels": launches})
    del warm
    emit({"phase": "moe", "request_ms": [1e3 * prefill_s] + decode_ms})
    check(prefill_launches == cfg.n_layers,
          f"the MoE prefill launched flash_attention {prefill_launches} "
          f"times, not once per layer ({cfg.n_layers})")
    check(launches["flash_attention"] == cfg.n_layers,
          "the MoE decode should launch no flash_attention")
    check(len(dropped) == cfg.n_layers
          and all(0.0 <= x < 1.0 for x in dropped),
          f"dropped shares {dropped}")
    check(set(captured) == {"global"}, "the MoE prefill should run global "
          "layers only")

    # the prefill gate: forward over the same prompts at the same T, then
    # the prefill again with each planted MoE fault
    t0 = time.perf_counter()
    full = model(tokens)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    check(full.shape == (LM_BATCH, LM_PROMPT, cfg.vocab_size)
          and bool(torch.isfinite(full[:, -1]).all()),
          f"forward logits {tuple(full.shape)} not finite")
    want = full[:, -1].float()
    del full
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    err_prefill = float((logits - want).abs().max())
    prefill_faults = {}
    for fault, ffn in moe_faults(torch, tfm).items():
        with swapped(tfm, moe_ffn=ffn):
            bad, _ = model.prefill(tokens)
        prefill_faults[fault] = float((bad - want).abs().max())
        del bad
    torch.cuda.empty_cache()

    # the decode gate at capacity E / K, on the same weights
    model_all = tfm.TransformerLM(
        dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k),
        params)
    t0 = time.perf_counter()
    dec = moe_decode_readings(torch, tfm, model_all, tokens[:, :MOE_SHORT],
                              LM_FAULT_STEPS)
    decode_check_s = time.perf_counter() - t0
    del model_all
    emit({"phase": "moe_check", "forward_ms": 1e3 * forward_s,
          "prefill_vs_forward": err_prefill,
          "prefill_atol": MOE_PREFILL_ATOL,
          "prefill_faults": prefill_faults,
          "max_abs_logit": float(want.abs().max()),
          "short_prompt": MOE_SHORT, "fault_steps": LM_FAULT_STEPS,
          "decode_atol": MOE_DECODE_ATOL, "decode_readings": dec,
          "decode_check_s": decode_check_s})
    check(err_prefill <= MOE_PREFILL_ATOL,
          f"MoE prefill logits differ from forward's by {err_prefill}")
    for fault, err in prefill_faults.items():
        check(err > MOE_PREFILL_ATOL, f"the MoE prefill gate passes a "
              f"planted fault ({fault}: {err})")
    check(dec["forward_dropped_share"] == 0.0,
          "forward at capacity E / K dropped assignments")
    for what in ("prefill", "decode"):
        check(dec[what] <= MOE_DECODE_ATOL,
              f"MoE {what} at capacity E / K differs from forward's by "
              f"{dec[what]}")
    for fault, err in dec["faults"].items():
        check(err > MOE_DECODE_ATOL, f"the MoE decode gate passes a planted "
              f"fault ({fault}: {err})")
    del model, params, logits, want
    gc.collect()
    torch.cuda.empty_cache()
    results = compare_attention(torch, captured, layers={"global": 0},
                                model="qwen3-moe ")
    kept = {"qwen3-moe layer 0": tuple(t.cpu() for t in
                                       captured["global"][:3])
            + (captured["global"][3],)}
    return {"launches": launches, "results": results, "captured": kept,
            "dry": {"ms": 1e3 * prefill_warm_s, "peak": warm_peak["bytes"]}}


# ----------------------------------------------------------------------------
# phase 5c: training, gemma-2b at full width, and kernel 10's backward
# ----------------------------------------------------------------------------

#: the train phase: gemma-2b's full config (bf16 compute, float32 master
#: weights, remat "full") on the train_4k shape's 4,096-token sequences,
#: the global batch cut from 256 to TRAIN_BATCH (MICROBATCH's 2
#: microbatches of one sequence), TRAIN_STEPS steps through
#: build_lm_train_step; the step checks at TRAIN_CHECK_LAYERS layers of the
#: full width (a depth cut)
TRAIN_ARCH, TRAIN_SHAPE = "gemma-2b", "train_4k"
TRAIN_BATCH, TRAIN_STEPS, TRAIN_CHECK_LAYERS = 2, 4, 2
#: kernel 10's backward against attention_bwd_ref, per output (dq, dk,
#: dv): |kernel - plain| <= atol_rel * max|plain| + rtol * |plain|.  In
#: bf16 both round a float32 result once, so they differ by up to one bf16
#: ulp (2**-7 relative); in float32 by summation order over up to 16K
#: terms.  The phase shows its planted faults fail these.
BWD_TOL = {"bfloat16": (1e-3, 2e-2), "float32": (1e-5, 1e-4)}
#: the softcap derivative's planted fault also runs on q scaled by this:
#: random weights keep |x / softcap| near 0.02, where 1 - tanh^2 is 1
#: within 4e-4, below what bf16 resolves; scaled, the scores reach the cap
BWD_SOFTCAP_STRESS = 8.0
#: the float32 step through the kernels against the same step through
#: attention_ref at TRAIN_CHECK_LAYERS layers: the loss and every gradient
#: leaf within atol_rel * max|plain| + rtol * |plain| (float32 summation
#: orders through two layers and a 256,000-way softmax)
STEP_TOL = (1e-4, 1e-3)
#: MIND's train phase: steps at train_batch, and the users of the slice
#: held against a step on CPU copies (float32 without TF32)
MIND_TRAIN_STEPS, MIND_CPU_USERS = 3, 4096
#: a planted fault's tile, per dtype: the dK/dV pass's key tile and its
#: units' query tile (64 x 64 in bf16, 32 x 32 in float32)
BWD_KEY_TILE = {"bfloat16": 64, "float32": 32}
#: the backward's split by launch at gemma-2b's training shape before its
#: redesign (the CUDA-core kernels: delta, dK/dV on a grid of 128 key
#: tiles, dQ; no reduction), device ms from ``bwd_split_ms`` on random
#: inputs, one H100 80GB HBM3 at 700.00 W (tools/attention_bwd_probe.py on
#: that checkout; a recorded constant, not a reading of the run)
BWD_SPLIT_MS_BEFORE_REDESIGN = {
    "bfloat16": {"delta": 0.0157, "dkdv": 11.786, "dq": 4.891,
                 "total_ms": 16.699},
    "float32": {"delta": 0.0268, "dkdv": 11.944, "dq": 5.052,
                "total_ms": 17.033}}


def bwd_readings(torch, got, want, tol) -> dict:
    """Per output, the largest |got - want|, the output's scale (max
    |want|), the share of elements outside the tolerance ``tol`` =
    (atol_rel, rtol) and whether all are inside."""
    atol_rel, rtol = tol
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        d = (g - w).abs()
        outside = d > atol_rel * scale + rtol * w.abs()
        out[name] = {"max_abs": float(d.max()), "scale": scale,
                     "share_outside": float(outside.float().mean()),
                     "close": not bool(outside.any())}
        del d, outside
    out["close"] = all(out[n]["close"] for n in ("dq", "dk", "dv"))
    return out


def faulty_bwd(torch, q, k, v, o, lse, do, *, fault, causal, window,
               softcap, sm_scale, kv_len):
    """attention_bwd_ref's formulas in float32 with a planted fault:
    ``tile_dropped`` (the dK/dV pass skips one unit of one key tile: the
    middle key tile's diagonal tile, ``BWD_KEY_TILE`` of q's dtype),
    ``softcap_derivative`` (dS without 1 - tanh^2) or ``delta`` (dS =
    P dP)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    kk = k.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * sm_scale
    dcap = None
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = softcap * t
        dcap = 1.0 - t * t
        del t
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = kj < kv_len
    if causal:
        mask = mask & (qi >= kj)
    if window > 0:
        mask = mask & (qi - kj < window)
    p = torch.exp(s - lse[..., None].float()).masked_fill(~mask, 0.0)
    del s
    dof = do.float()
    ds = torch.einsum("bhqd,bhkd->bhqk", dof,
                      v.float().repeat_interleave(g, dim=1))
    if fault != "delta":
        ds = ds - (dof * o.float()).sum(dim=-1)[..., None]
    ds = p * ds
    if dcap is not None and fault != "softcap_derivative":
        ds = ds * dcap
    del dcap
    ds = ds * sm_scale
    pk, dsk = p, ds
    if fault == "tile_dropped":
        t = BWD_KEY_TILE["bfloat16" if q.dtype == torch.bfloat16
                         else "float32"]
        c = min(Sq, Skv) // 2 // t * t
        drop = torch.zeros_like(mask)
        drop[c:c + t, c:c + t] = True
        pk, dsk = p.masked_fill(drop, 0.0), ds.masked_fill(drop, 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk)
    fold = (B, Hkv, g, Skv, D)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsk, q.float()).view(fold).sum(2)
    dv = torch.einsum("bhqk,bhqd->bhkd", pk, dof).view(fold).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def plain_bwd(torch, q, k, v, o, lse, do, kw, *, kv_chunk: int,
              fault=None):
    """The plain backward (``attention_bwd_ref``, or ``faulty_bwd`` with
    ``fault``) over chunks of ``kv_chunk`` KV heads and their query-head
    groups, so that the (B, heads, Sq, Skv) float32 tensors stay a chunk's
    size."""
    from repro_torch.kernels.flash_attention import attention_bwd_ref

    Hq, Hkv = q.shape[1], k.shape[1]
    g = Hq // Hkv
    outs = []
    for h0 in range(0, Hkv, kv_chunk):
        h1 = min(Hkv, h0 + kv_chunk)
        sq, sk = slice(h0 * g, h1 * g), slice(h0, h1)
        args = (q[:, sq], k[:, sk], v[:, sk], o[:, sq], lse[:, sq],
                do[:, sq])
        if fault is None:
            outs.append(attention_bwd_ref(*args, **kw))
        else:
            outs.append(faulty_bwd(torch, *args, fault=fault, **kw))
    return tuple(torch.cat([o_[i] for o_ in outs], dim=1) for i in range(3))


def bwd_check(torch, name: str, q, k, v, kw, *, do=None, o=None, lse=None,
              seed: int = 0, kv_chunk: int = 1, samples: int = 10) -> list:
    """Kernel 10's backward on one layer's q, k, v (bf16) in bf16 and in
    float32 (the same values widened): the forward kernel's o and lse (or
    the captured ones), dO captured or seeded; the kernel against
    ``plain_bwd`` within BWD_TOL, each planted fault shown outside it (the
    softcap derivative's on q scaled by BWD_SOFTCAP_STRESS too), two
    launches bit-equal; then its time on the device alone beside the
    plain version's, its bound and SDPA's backward (causal or a band mask,
    GQA, no softcap) on the same shapes.  -> the ``kernels`` rows."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    B, Hq, S, D = q.shape
    window, softcap = kw.get("window", 0), kw.get("softcap", 0.0)
    full = dict(causal=True, window=window, softcap=softcap,
                sm_scale=D ** -0.5, kv_len=k.shape[2])
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        tag = "bfloat16" if dt == torch.bfloat16 else "float32"
        qd, kd, vd = (x.to(dt) for x in (q, k, v))
        if o is not None and dt == q.dtype:
            od, ld = o, lse
        else:
            od, ld = flash_attention_cuda(qd, kd, vd, lse=True, **full)
        if do is not None:
            dod = do.to(dt)
        else:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            dod = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        got = flash_attention_bwd_cuda(qd, kd, vd, od, ld, dod, **full)
        again = flash_attention_bwd_cuda(qd, kd, vd, od, ld, dod, **full)
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = plain_bwd(torch, qd, kd, vd, od, ld, dod, full,
                         kv_chunk=kv_chunk)
        torch.cuda.synchronize()
        tol = BWD_TOL[tag]
        clean = bwd_readings(torch, got, want, tol)
        faults = {}
        for fault in ("tile_dropped", "delta") + (
                ("softcap_derivative",) if softcap > 0 else ()):
            bad = plain_bwd(torch, qd, kd, vd, od, ld, dod, full,
                            kv_chunk=kv_chunk, fault=fault)
            faults[fault] = bwd_readings(torch, bad, want, tol)
            del bad
        stress = None
        if softcap > 0:
            qs = qd * BWD_SOFTCAP_STRESS
            os_, ls_ = flash_attention_cuda(qs, kd, vd, lse=True, **full)
            ws = plain_bwd(torch, qs, kd, vd, os_, ls_, dod, full,
                           kv_chunk=kv_chunk)
            gs = flash_attention_bwd_cuda(qs, kd, vd, os_, ls_, dod, **full)
            bs = plain_bwd(torch, qs, kd, vd, os_, ls_, dod, full,
                           kv_chunk=kv_chunk, fault="softcap_derivative")
            stress = {"q_scale": BWD_SOFTCAP_STRESS,
                      "kernel": bwd_readings(torch, gs, ws, tol),
                      "softcap_derivative": bwd_readings(torch, bs, ws,
                                                         tol)}
            del qs, os_, ls_, ws, gs, bs
        emit({"phase": "train_attention_bwd", "layer": name, "dtype": tag,
              "shape": {"q": list(q.shape), "kv": list(k.shape)},
              "window": window, "softcap": softcap, "tol": tol,
              "kernel": clean, "bit_equal": bit_equal, "faults": faults,
              "softcap_stress": stress})
        check(clean["close"], f"flash_attention_bwd differs from "
              f"attention_bwd_ref on {name} ({tag}): {clean}")
        check(bit_equal, f"two backward launches differ on {name} ({tag})")
        for fault, r in faults.items():
            if fault != "softcap_derivative":
                check(not r["close"], f"the backward tolerance passes a "
                      f"planted fault ({fault}) on {name} ({tag})")
        if stress is not None:
            check(stress["kernel"]["close"], f"flash_attention_bwd differs "
                  f"from attention_bwd_ref on {name} ({tag}) with q scaled")
            check(not stress["softcap_derivative"]["close"],
                  f"the backward tolerance passes the softcap derivative's "
                  f"fault on {name} ({tag}) with q scaled")

        # times: the kernel and its launches, the plain version, SDPA's
        # backward
        def kernel():
            return flash_attention_bwd_cuda(qd, kd, vd, od, ld, dod, **full)
        ms = device_ms(torch, kernel, samples=samples)
        split = bwd_split_ms(torch, kernel, reps=2 if samples < 10 else 5)
        plain_ms = time_ms(torch, lambda: plain_bwd(
            torch, qd, kd, vd, od, ld, dod, full, kv_chunk=kv_chunk),
            warmup=1, reps=3)
        library_ms, library_what = None, None
        try:
            qg, kg, vg = (x.detach().requires_grad_() for x in (qd, kd, vd))
            fn, library_what = sdpa(torch, qg, kg, vg, window)
            out = fn()
            library_ms = device_ms(torch, lambda: torch.autograd.grad(
                out, (qg, kg, vg), dod, retain_graph=True), samples=samples)
            library_what = f"{library_what}, backward"
            del out, qg, kg, vg
        except torch.OutOfMemoryError as e:
            library_what = f"SDPA backward ran out of memory: {e}"[:200]
        torch.cuda.empty_cache()
        pairs = visible_pairs(S, window)
        item = q.element_size() if dt == torch.bfloat16 else 4
        # q, o, dO read and dq written; k, v read and dk, dv written; lse
        n_bytes = (4 * q.numel() + 4 * k.numel()) * item + ld.numel() * 4
        rows.append(dict(
            name="flash_attention_bwd", variant=f"{name} {tag}",
            window=window, softcap=softcap,
            shape={"q": list(q.shape), "kv": list(k.shape)},
            max_abs_err=max(clean[n]["max_abs"] for n in ("dq", "dk", "dv")),
            ms=ms, split_ms=split, plain_ms=plain_ms, library_ms=library_ms,
            library=library_what, pairs_per_head=pairs,
            # the flops a pair the kernels spend against the bound's 10·D
            # (both dtypes compute S and dP twice; bf16 also doubles dV, dK
            # and dQ, whose P and dS operands are hi + lo)
            flops_per_pair_spent=(20 if dt == torch.bfloat16 else 14) * D,
            **({"split_ms_before_redesign":
                BWD_SPLIT_MS_BEFORE_REDESIGN[tag]}
               if name == "gemma-2b layer 0" else {}),
            **bound(n_bytes, pairs * B * Hq * 10 * D,
                    ops_per_s=BF16_OPS_PER_S if dt == torch.bfloat16
                    else F32_OPS_PER_S)))
        del got, want, qd, kd, vd, od, ld, dod
        torch.cuda.empty_cache()
    for r in rows:
        emit({"phase": "train_kernels", **r})
    return rows


#: kernel 10's backward launches, by the part their names carry
#: (``attn_bwd_<part>_...``): delta, the dK/dV pass, its reduction (from
#: the work-list form on) and dQ
BWD_PARTS = ("delta", "dkdv", "reduce", "dq")


def bwd_split_ms(torch, fn, reps: int = 5):
    """Device ms that one call of ``fn`` (a backward launch) spends in each
    of its kernels (``BWD_PARTS``; each launches at most once a call): the
    mean over the launches of each that ``torch.profiler`` recorded in
    ``reps`` calls after a warm one (the trace has been seen to drop a
    call's events); None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(BWD_PARTS, 0.0)
    seen = dict.fromkeys(BWD_PARTS, 0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"attn_bwd_(delta|dkdv|reduce|dq)_", e.name)
        if m:
            total[m.group(1)] += e.self_device_time_total / 1e3
            seen[m.group(1)] += 1
    if not any(seen.values()):
        return None
    return {p: total[p] / seen[p] if seen[p] else 0.0 for p in BWD_PARTS}


def profile_split(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the card's kernel time
    split into kernel 10's forward, its backward, cuBLAS and everything
    else (ms), and the call's wall ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = {"attention_fwd": 0.0, "attention_bwd": 0.0, "cublas": 0.0,
             "other": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        name, ms = e.name, e.self_device_time_total / 1e3
        if "attn_bwd_" in name:
            split["attention_bwd"] += ms
        elif "attn_bf16_kernel" in name or "attn_f32_kernel" in name:
            split["attention_fwd"] += ms
        elif re.search(r"gemm|nvjet|cutlass|xmma|cublas|sm90_", name,
                       re.IGNORECASE):
            split["cublas"] += ms
        else:
            split["other"] += ms
    return {"busy_ms": sum(split.values()), "kernels": n, "split_ms": split,
            "profiled_wall_ms": 1e3 * wall}


def step_readings(torch, got, want, tol=STEP_TOL, floor=0.0) -> dict:
    """The loss and every leaf of ``got`` against ``want`` (trees of the
    same structure): per leaf the largest |difference| over the leaf's
    scale, and whether all lie within atol_rel * max|want| + rtol *
    |want|; with ``floor``, a leaf's scale is at least ``floor`` times the
    largest leaf's.  ``worst`` names the leaf of the largest reading."""
    from repro_torch.core.tree import flatten

    atol_rel, rtol = tol
    pairs = [(path, a.float(), b.float()) for (path, a), (_, b) in
             zip(flatten(got)[0], flatten(want)[0])]
    top = max(float(b.abs().max()) for _, _, b in pairs)
    worst, ok, at = 0.0, True, None
    for path, a, b in pairs:
        scale = max(float(b.abs().max()), floor * top)
        d = (a - b).abs()
        ok = ok and not bool((d > atol_rel * scale + rtol * b.abs()).any())
        r = float(d.max()) / max(scale, 1e-30)
        if at is None or r > worst:
            worst, at = r, path
    return {"close": ok, "max_rel_to_scale": worst, "worst": at}


def trees_equal(torch, a, b) -> bool:
    from repro_torch.core.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def train_checks(torch, np, cfg, seq: int, n_micro: int) -> dict:
    """The step checks at TRAIN_CHECK_LAYERS layers of the full width: in
    float32, the kernels' loss, gradients and updated parameters against
    attention_ref's, and a planted backward fault outside that tolerance;
    in bf16, the same step twice, and remat off, "full" and "dots", bit for
    bit; ``train.loop.train`` preempted and resumed from its checkpoint,
    bit for bit against the run not interrupted.  Only the preempted
    run's checkpoint is written: the loop's saves that nothing reads (the
    run through's and the resumed run's, at their last step) are skipped,
    ~17 s each at 8.9 GB."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.core import tree
    from repro_torch.data import synth
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.train import loop, optimizer as opt

    out = {"layers": TRAIN_CHECK_LAYERS}
    toks, labels = next(synth.lm_batches(cfg.vocab_size, TRAIN_BATCH, seq,
                                         seed=1))
    toks = torch.from_numpy(toks).cuda()
    labels = torch.from_numpy(labels).cuda()

    # float32: the kernels against attention_ref, and a planted fault
    c32 = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS,
                              dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    p32 = tfm.init_params(c32, gen, dtype=torch.float32)

    def grads(**swaps):
        with swapped(tfm, **swaps.pop("model", {})), \
                swapped(attn_ops, **swaps):
            return steps.lm_value_and_grad(c32, p32, toks, labels,
                                           n_microbatches=n_micro)

    kern = grads()
    plain = grads(model={"flash_attention": attention_ref})

    def tile_dropped(q, k, v, o, lse, do, **kw):
        return plain_bwd(torch, q, k, v, o, lse, do, kw, kv_chunk=1,
                         fault="tile_dropped")
    fault = grads(flash_attention_bwd_cuda=tile_dropped)
    loss_rel = abs(float(kern[0]) - float(plain[0])) / abs(float(plain[0]))
    g_read = step_readings(torch, kern[1], plain[1])
    f_read = step_readings(torch, fault[1], plain[1])
    state = opt.init(p32)
    lr = float(opt._schedule(steps.ADAMW, state.count))
    new_k, _ = opt.update(steps.ADAMW, kern[1], state, p32)
    new_p, _ = opt.update(steps.ADAMW, plain[1], state, p32)
    param_diff = max(float((a - b).abs().max()) for a, b in zip(
        tree.tree_leaves(new_k), tree.tree_leaves(new_p)))
    out["float32"] = {"loss": float(kern[0]), "loss_plain": float(plain[0]),
                      "loss_rel_diff": loss_rel, "grads": g_read,
                      "tol": STEP_TOL, "planted_tile_dropped": f_read,
                      "params_max_abs_diff": param_diff, "lr": lr}
    del kern, plain, fault, new_k, new_p, p32, state
    torch.cuda.empty_cache()
    check(loss_rel <= STEP_TOL[1], f"the float32 step's loss through the "
          f"kernels differs from attention_ref's by {loss_rel}")
    check(g_read["close"], f"the float32 step's gradients through the "
          f"kernels differ from attention_ref's: {g_read}")
    check(not f_read["close"], "the step tolerance passes a planted backward "
          "fault (tile_dropped)")
    # Adam's first step moves a parameter by lr * m / sqrt(v) ~ +-lr: a
    # gradient that differs in sign at noise level moves it by 2 lr
    check(param_diff <= 2.0 * lr * (1 + 1e-3), f"the updated parameters "
          f"differ by {param_diff} (lr {lr})")

    # bf16: determinism and remat, bit for bit
    cb = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(2)
    pb = tfm.init_params(cb, gen, dtype=torch.float32)
    sb = opt.init(pb)

    def one_step(c):
        return steps.build_lm_train_step(c, n_microbatches=n_micro)(
            pb, sb, toks, labels)
    first = one_step(cb)
    bits = {"same_step_twice": trees_equal(torch, one_step(cb), first)}
    for name, kw in (("remat_off", dict(remat=False)),
                     ("remat_full", dict(remat=True, remat_policy="full")),
                     ("remat_dots", dict(remat=True, remat_policy="dots"))):
        bits[name] = trees_equal(torch, one_step(
            dataclasses.replace(cb, **kw)), first)
    out["bf16_bit_equal"] = bits
    del first
    torch.cuda.empty_cache()
    for name, ok in bits.items():
        check(ok, f"the bf16 step is not bit-equal ({name})")

    # the loop: preempted at step 1 and resumed, against the run through
    ckpt_bytes = sum(t.numel() * t.element_size()
                     for t in tree.tree_leaves((pb, sb)))
    tmp = Path(tempfile.mkdtemp(prefix="train_ckpt_"))
    free = shutil.disk_usage(tmp).free
    out["loop"] = {"checkpoint_bytes": ckpt_bytes, "disk_free": free}
    check(free > 1.1 * ckpt_bytes, f"{free} bytes free under {tmp}: the "
          f"loop check writes a checkpoint of {ckpt_bytes} bytes")
    timed = {"save_s": [], "restore_s": [], "saves_skipped": 0}
    real_save, real_restore = ckpt.save, ckpt.restore
    saving = [False]      # on for the preempted run alone

    def save(*a, **k):
        if not saving[0]:
            timed["saves_skipped"] += 1
            return None
        t0 = time.perf_counter()
        r = real_save(*a, **k)
        timed["save_s"].append(time.perf_counter() - t0)
        return r

    def restore(*a, **k):
        t0 = time.perf_counter()
        r = real_restore(*a, **k)
        torch.cuda.synchronize()
        timed["restore_s"].append(time.perf_counter() - t0)
        return r

    def data():
        for t, l in synth.lm_batches(cfg.vocab_size, TRAIN_BATCH, seq,
                                     seed=3):
            yield torch.from_numpy(t).cuda(), torch.from_numpy(l).cuda()

    step = steps.build_lm_train_step(cb, n_microbatches=n_micro)
    quiet = {"log": lambda *a: None}
    try:
        with swapped(ckpt, save=save, restore=restore):
            through = loop.train(step, pb, sb, data(), ckpt_dir=tmp / "a",
                                 max_steps=2, ckpt_every=2, **quiet)
            saving[0] = True
            try:
                loop.train(step, pb, sb, data(), ckpt_dir=tmp / "b",
                           max_steps=2, ckpt_every=1, preempt_at=1, **quiet)
                preempted = False
            except loop.Preempted:
                preempted = True
            saving[0] = False
            resumed = loop.train(step, pb, sb, data(), ckpt_dir=tmp / "b",
                                 max_steps=2, ckpt_every=1, **quiet)
        out["loop"].update(
            preempted=preempted, **timed,
            losses=through["losses"], resumed_losses=resumed["losses"],
            bit_equal=trees_equal(torch, (through["params"],
                                          through["opt_state"]),
                                  (resumed["params"], resumed["opt_state"])))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del pb, sb
    torch.cuda.empty_cache()
    emit({"phase": "train_check", **out})
    check(out["loop"]["preempted"], "the loop did not preempt at step 1")
    check(len(out["loop"]["save_s"]) == 1 and
          len(out["loop"]["restore_s"]) == 1, "the resumed run did not "
          f"restore the preempted run's one checkpoint: {out['loop']}")
    check(out["loop"]["bit_equal"], "the resumed run differs from the run "
          "through")
    return out


def mind_train_phase(torch, np, *, seed: int = 0) -> dict:
    """MIND at its full config (2**21 x 64 table, neg_groups 1) takes
    MIND_TRAIN_STEPS steps of ``build_mind_train_step`` at train_batch
    (65,536 users: a 65,536 x 65,536 float32 logits matrix), batches from
    ``recsys_batches``; then one step on a MIND_CPU_USERS-user slice against
    the same step on CPU copies (float32, no TF32): loss and gradients at
    the CPU parity test's tolerance, the updated parameters within Adam's
    2 lr."""
    from repro_torch.configs import get_arch
    from repro_torch.core import tree
    from repro_torch.data import synth
    from repro_torch.launch import steps
    from repro_torch.models.recsys import mind
    from repro_torch.train import optimizer as opt

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = get_arch("mind")
    cfg = arch.full_config()
    B = arch.SHAPES["train_batch"]["batch"]
    torch.cuda.reset_peak_memory_stats()
    left_before = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = mind.init_params(cfg, gen)
    state = opt.init(params)
    data = synth.recsys_batches(cfg.n_items, B, cfg.hist_len, seed=seed)
    step = steps.build_mind_train_step(cfg, donate=True)
    ms, losses = [], []
    for _ in range(MIND_TRAIN_STEPS):
        h, m, t = (torch.from_numpy(x).cuda() for x in next(data))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, h, m, t)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"MIND train losses {losses}")

    # one step on a slice, on the card and on CPU copies
    h, m, t = (torch.from_numpy(x[:MIND_CPU_USERS]) for x in next(data))
    host_p = tree.tree_map(lambda x: x.cpu(), params)
    host_s = tree.tree_map(lambda x: x.cpu(), state)

    def vg(p, *args):
        return steps.value_and_grad(
            lambda pp, hh, mm, tt: mind.train_loss(pp, hh, mm, tt, cfg), p,
            *args)
    gl, gg = vg(params, h.cuda(), m.cuda(), t.cuda())
    cl, cg = vg(host_p, h, m, t)
    grad_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree.tree_leaves(gg), tree.tree_leaves(cg)))
    grads_close = all(torch.allclose(a.cpu(), b, atol=1e-6, rtol=1e-4)
                      for a, b in zip(tree.tree_leaves(gg),
                                      tree.tree_leaves(cg)))
    lr = float(opt._schedule(steps.ADAMW, state.count))
    new_card, _ = opt.update(steps.ADAMW, gg, state, params)
    new_host, _ = opt.update(steps.ADAMW, cg, host_s, host_p)
    param_diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree.tree_leaves(new_card), tree.tree_leaves(new_host)))
    out = {"phase": "mind_train", "model": cfg.name, "items": cfg.n_items,
           "batch": B, "step_ms": ms, "losses": losses,
           "users_per_s": B / (statistics.median(ms) / 1e3),
           "max_memory_allocated": peak, "cpu_users": MIND_CPU_USERS,
           "cpu_loss": float(cl), "card_loss": float(gl),
           "grads_max_abs_err": grad_err, "params_max_abs_diff": param_diff,
           "lr": lr}
    emit(out)
    out["dry"] = {"ms": statistics.median(ms), "peak": peak - left_before}
    check(abs(float(gl) - float(cl)) <= 1e-5 * abs(float(cl)),
          f"MIND slice loss {float(gl)} on the card, {float(cl)} on the CPU")
    check(grads_close, f"MIND slice gradients differ from the CPU's by "
          f"{grad_err}")
    check(param_diff <= 2.0 * lr * (1 + 1e-3), f"MIND updated parameters "
          f"differ from the CPU's by {param_diff} (lr {lr})")
    del params, state, new_card, gg
    torch.cuda.empty_cache()
    return out


def train_phase(torch, np, captured: dict) -> dict:
    """Train gemma-2b at its full config (18 layers, d_model 2048, MQA 8/1,
    head_dim 256, vocab 256,000; bf16 compute on float32 master weights,
    remat "full", random weights from a seeded generator): TRAIN_STEPS
    steps of TRAIN_BATCH sequences of 4,096 tokens from ``lm_batches`` in
    MICROBATCH's 2 microbatches, through ``build_lm_train_step``, the
    launch counts zeroed before each step and read after (kernel 10's
    forward 2 x 18 x 2 times, its backward 18 x 2); then one warm step
    under the profiler.  Then kernel 10's backward against its plain
    version on the (q, k, v, o, lse, dO) that layers 0 and 17 saw in the
    first step, on ``captured`` (gemma2-9b's first local and global layer,
    qwen3-moe's layer 0, from the LM and MoE phases), the step checks
    (``train_checks``) and MIND's training (``mind_train_phase``)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import tree
    from repro_torch.data import synth
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt

    arch = get_arch(TRAIN_ARCH)
    cfg = arch.full_config()
    seq = arch.SHAPES[TRAIN_SHAPE]["seq_len"]
    n_micro = steps.MICROBATCH[(TRAIN_ARCH, TRAIN_SHAPE)]
    check(cfg.remat and cfg.remat_policy == "full", "gemma-2b trains with "
          "remat 'full'")
    torch.cuda.reset_peak_memory_stats()
    left_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tfm.init_params(cfg, gen, dtype=torch.float32)
    state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree.tree_leaves((params, state)))
    data = synth.lm_batches(cfg.vocab_size, TRAIN_BATCH, seq, seed=0)
    step = steps.build_lm_train_step(cfg, n_microbatches=n_micro,
                                     donate=True)

    norms = []
    real_norm = opt.global_norm

    def record_norm(tree):
        n = real_norm(tree)
        norms.append(n)
        return n

    calls, grabbed = [], {}
    real_bwd = attn_ops.flash_attention_bwd_cuda

    def capture(q, k, v, o, lse, do, **kw):
        layer = cfg.n_layers - 1 - len(calls)    # backward runs 17 .. 0
        calls.append(layer)
        if len(calls) <= cfg.n_layers and layer in (0, cfg.n_layers - 1):
            grabbed[layer] = (q.clone(), k.clone(), v.clone(), o.clone(),
                              lse.clone(), do.clone(), dict(kw))
        return real_bwd(q, k, v, o, lse, do, **kw)

    per_step, total = [], {"flash_attention": 0, "flash_attention_bwd": 0}
    for i in range(TRAIN_STEPS):
        toks, labels = (torch.from_numpy(x).cuda() for x in next(data))
        swaps = {"flash_attention_bwd_cuda": capture} if i == 0 else {}
        torch.cuda.synchronize()
        runtime.reset_launches()
        t0 = time.perf_counter()
        with swapped(opt, global_norm=record_norm), \
                swapped(attn_ops, **swaps):
            params, state, loss = step(params, state, toks, labels)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: runtime.LAUNCHES[k] for k in total}
        for k in total:
            total[k] += launches[k]
        per_step.append({"step": i + 1, "ms": 1e3 * dt,
                         "tokens_per_s": TRAIN_BATCH * seq / dt,
                         "loss": float(loss), "grad_norm": float(norms[-1]),
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated(),
                         "launches": launches})
        check(bool(torch.isfinite(loss)), f"train step {i + 1}: loss "
              f"{float(loss)}")
        check(launches["flash_attention"] == 2 * cfg.n_layers * n_micro,
              f"train step {i + 1} launched flash_attention "
              f"{launches['flash_attention']} times, not 2 x "
              f"{cfg.n_layers} x {n_micro}")
        check(launches["flash_attention_bwd"] == cfg.n_layers * n_micro,
              f"train step {i + 1} launched flash_attention_bwd "
              f"{launches['flash_attention_bwd']} times, not "
              f"{cfg.n_layers} x {n_micro}")
    peak = torch.cuda.max_memory_allocated()
    toks, labels = (torch.from_numpy(x).cuda() for x in next(data))

    def warm():
        nonlocal params, state
        params, state, _ = step(params, state, toks, labels)
    profile = profile_split(torch, warm)
    warm_ms = statistics.median(s["ms"] for s in per_step[1:])
    emit({"phase": "train", "model": cfg.name, "n_params": cfg.n_params(),
          "params_and_state_bytes": state_bytes, "seq_len": seq,
          "batch": TRAIN_BATCH, "global_batch_cut_from":
              arch.SHAPES[TRAIN_SHAPE]["global_batch"],
          "microbatches": n_micro, "remat": cfg.remat_policy,
          "init_s": init_s, "steps": per_step,
          "warm_step_ms_median": warm_ms,
          "warm_tokens_per_s": TRAIN_BATCH * seq / (warm_ms / 1e3),
          "max_memory_allocated": peak, "warm_step_profile": profile,
          "launches": total})
    check(set(grabbed) == {0, cfg.n_layers - 1},
          f"the captured step's backward reached layers {sorted(grabbed)}")
    del params, state, toks, labels
    gc.collect()
    torch.cuda.empty_cache()

    # kernel 10's backward on the captured layers and the served shapes
    rows = []
    for layer in sorted(grabbed):
        q, k, v, o, lse, do, kw = grabbed.pop(layer)
        rows += bwd_check(torch, f"gemma-2b layer {layer}", q, k, v, kw,
                          o=o, lse=lse, do=do, kv_chunk=1)
        del q, k, v, o, lse, do
    for name, (q, k, v, kw) in captured.items():
        rows += bwd_check(torch, name, q.cuda(), k.cuda(), v.cuda(), kw,
                          seed=7, kv_chunk=1, samples=5)
    captured.clear()
    torch.cuda.empty_cache()
    checks = train_checks(torch, np, cfg, seq, n_micro)
    mind_out = mind_train_phase(torch, np)
    return {"launches": total, "results": rows, "checks": checks,
            "mind": mind_out,
            "dry": {"ms": warm_ms, "peak": peak - left_before}}


# ----------------------------------------------------------------------------
# the GNN phase (after the MIND train phase)
# ----------------------------------------------------------------------------

#: the (arch, shape) runs on one card, full config and full width, each
#: GNN_STEPS steps and a profiled one more (shapes: configs.common's
#: GNN_SHAPES; minibatch_lg through the sampler over the served view)
GNN_RUNS = (("nequip", "molecule"), ("mace", "molecule"),
            ("pna", "molecule"), ("equiformer-v2", "molecule"),
            ("nequip", "full_graph_sm"), ("mace", "full_graph_sm"),
            ("pna", "full_graph_sm"), ("equiformer-v2", "full_graph_sm"),
            ("pna", "minibatch_lg"), ("nequip", "minibatch_lg"),
            ("mace", "minibatch_lg"))
#: the cells not run: the dry run's predicted peak of each exceeds the
#: card's memory (the dryrun phase)
GNN_NOT_RUN = (("equiformer-v2", "minibatch_lg"), ("pna", "ogb_products"),
               ("nequip", "ogb_products"), ("mace", "ogb_products"),
               ("equiformer-v2", "ogb_products"))
GNN_STEPS = 3
GNN_SEED = 0
#: the step gate: 2 layers of each full config (a depth cut; full width),
#: on 8 molecules of 30 atoms (240 nodes, 512 edges) or a feature graph of
#: the same size, the loss and every gradient leaf on the card against the
#: CPU's in float32 at STEP_TOL
GNN_GATE_LAYERS, GNN_GATE_GRAPHS = 2, 8
#: the step gate's floor, as a share of the largest gradient leaf's scale:
#: a leaf whose gradient vanishes in exact arithmetic (MACE's (1, 1, 1)
#: products of a vector field with itself, EquiformerV2's last attention
#: bias under the softmax's shift invariance) carries rounding noise alone
#: (CPU float32 against float64: 2e-12 on a zero leaf whose float64 reading
#: is 4e-21), so each leaf is held to STEP_TOL of its scale or of this
#: floor, whichever is larger
GNN_LEAF_FLOOR = 1e-3
#: the step gate's (atol over the leaf's scale, rtol) per arch: STEP_TOL,
#: but for PNA, whose std aggregator sqrt(max(E[m^2] - E[m]^2, 1e-8))
#: scales the rounding of a near-zero variance by 1 / (2 std): float32
#: against float64 on the CPU differs by 1.6e-3 of a leaf's scale there,
#: the card against the CPU by 3.4e-3 (NVIDIA H100 80GB HBM3), the planted
#: fault by 1.16
GNN_STEP_TOL = {"pna": (2e-2, 1e-3)}
#: the invariance gate: each geometric full config's energies on the
#: molecule shape's batch with each atom in a GNN_INV_BOX A box (so that
#: its bonds lie within the 5 A cutoff), at full depth, against those of
#: its positions under a seeded rotation, max |difference| over the
#: energies' scale.  On the CPU (16 molecules) the clean readings were
#: 1.0e-7 (NequIP), 1.6e-7 (MACE) and 5.2e-7 (EquiformerV2), the planted
#: CG fault 2.3e-2 (NequIP) and 6.2e-3 (MACE); in the random builder's box
#: (side 31 A at 3,840 nodes) most edges lie past the cutoff and the MACE
#: fault moved the energies by 4.4e-6 alone (NVIDIA H100 80GB HBM3)
GNN_INV_TOL, GNN_INV_BOX = 1e-5, 4.0
#: the live loop: NequIP's full config on a SlabGraph of 128 molecules of
#: 30 atoms (the molecule shape), GNN_LIVE_INSERTS intra-molecule bonds
#: inserted a step, GNN_LIVE_DELETES of them deleted every third step,
#: edges_from_slab into the molecule shape's 8,192 edge slots
GNN_LIVE_STEPS, GNN_LIVE_INSERTS, GNN_LIVE_DELETES = 20, 512, 128


def gnn_shape_size(shape: dict):
    """(nodes, edges, graphs) a step of ``shape``, as the reference's
    ``gnn_cell`` reads them."""
    from repro_torch.configs.common import sampled_subgraph_size
    if shape["kind"] == "train_sampled":
        return (*sampled_subgraph_size(shape), 1)
    if shape["kind"] == "train_batched":
        return (shape["n_nodes"] * shape["batch"],
                shape["n_edges"] * shape["batch"], shape["batch"])
    return shape["n_nodes"], shape["n_edges"], 1


def gnn_config(arch: str, shape: dict):
    """The full config; PNA's ``d_in`` from the shape's ``d_feat``, else
    100 (the reference's ``make_cell``)."""
    from repro_torch.configs import get_arch
    m = get_arch(arch)
    if arch == "pna":
        return m.full_config(d_in=shape.get("d_feat", 100) or 100)
    return m.full_config()


def sampled_minibatch(torch, np, graph, shape: dict) -> dict:
    """``minibatch_lg``'s subgraph over a live view: the view's
    ``csr_snapshot`` on the host, ``sample_khop`` from ``batch_nodes``
    seeded seeds with the shape's fanout, each sampled id mapped to its
    position in ``nodes`` (senders of hop k to their slot in layer k + 1,
    receivers to ``offset_k + j // f_k``).  Host numpy; checked: the
    local ids gather back the sampled global ids."""
    from repro_torch.core.worklist import csr_snapshot
    from repro_torch.data.sampler import sample_khop

    t0 = time.perf_counter()
    n_e = int(graph.n_edges)
    csr = csr_snapshot(graph, max_edges=n_e)
    check(int(csr.n_edges) == n_e, "csr_snapshot lost edges")
    indptr = csr.indptr.cpu().numpy().astype(np.int64)
    indices = csr.indices.cpu().numpy()[:n_e]
    del csr
    B, fanout = shape["batch_nodes"], tuple(shape["fanout"])
    rng = np.random.default_rng(GNN_SEED)
    seeds = rng.choice(graph.n_vertices, B, replace=False).astype(np.int32)
    nodes, snd, rcv, mask = sample_khop(indptr, indices, seeds, fanout,
                                        seed=GNN_SEED)
    offsets, n_front = [0], B
    for f in fanout:
        offsets.append(offsets[-1] + n_front)
        n_front *= f
    snd_l, rcv_l = [], []
    n_front = B
    for k, f in enumerate(fanout):
        j = np.arange(n_front * f)
        snd_l.append(offsets[k + 1] + j)
        rcv_l.append(offsets[k] + j // f)
        n_front *= f
    snd_l = np.concatenate(snd_l).astype(np.int32)
    rcv_l = np.concatenate(rcv_l).astype(np.int32)
    N, E, _ = gnn_shape_size(shape)
    check(nodes.shape == (N,) and snd.shape == (E,),
          f"sampled {nodes.shape[0]} nodes and {snd.shape[0]} edges, the "
          f"shape says {N} and {E}")
    check(np.array_equal(nodes[snd_l], snd) and
          np.array_equal(nodes[rcv_l], rcv),
          "the local ids do not gather back the sampled ids")
    return {"nodes": nodes, "senders": snd_l, "receivers": rcv_l,
            "edge_mask": mask, "n_vertices": graph.n_vertices,
            "graph_edges": n_e, "live_edges": int(mask.sum()),
            "degree0_seeds": int((indptr[seeds + 1] == indptr[seeds]).sum()),
            "sample_s": time.perf_counter() - t0}


def gnn_batch(torch, np, arch: str, shape_name: str, cfg, style: str,
              sampled: dict):
    """A step's (batch, targets) on the card: the port's random builders
    for ``molecule`` and ``full_graph_sm`` (positions and species for the
    geometric models, features and labels for PNA), or ``minibatch_lg``'s
    sampled subgraph with per-vertex features, positions (a 4 A box) and
    species gathered from seeded per-vertex tables."""
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.models.gnn.common import (GraphBatch,
                                               random_feature_graph,
                                               random_geometric_batch)
    shape = GNN_SHAPES[shape_name]
    N, E, G = gnn_shape_size(shape)
    gen = torch.Generator(device="cuda").manual_seed(GNN_SEED)
    if shape_name != "minibatch_lg":
        if style == "geometric":
            b = random_geometric_batch(gen, N, E, n_species=cfg.n_species,
                                       n_graphs=G)
            return b, torch.randn((G,), generator=gen, device="cuda")
        b = random_feature_graph(gen, N, E, cfg.d_in)
        return b, torch.randint(0, cfg.n_classes, (N,), generator=gen,
                                device="cuda")
    V = sampled["n_vertices"]
    nodes = torch.from_numpy(sampled["nodes"]).cuda().long()
    common = dict(senders=torch.from_numpy(sampled["senders"]).cuda(),
                  receivers=torch.from_numpy(sampled["receivers"]).cuda(),
                  edge_mask=torch.from_numpy(sampled["edge_mask"]).cuda(),
                  node_mask=torch.ones(N, dtype=torch.bool, device="cuda"),
                  graph_ids=torch.zeros(N, dtype=torch.int32,
                                        device="cuda"), n_graphs=1)
    if style == "geometric":
        pos = torch.rand((V, 3), generator=gen, device="cuda") * 4.0
        species = torch.randint(0, cfg.n_species, (V,), generator=gen,
                                device="cuda", dtype=torch.int32)
        b = GraphBatch(positions=pos[nodes], node_feat=None,
                       species=species[nodes], **common)
        return b, torch.randn((1,), generator=gen, device="cuda")
    feat = torch.randn((V, cfg.d_in), generator=gen, device="cuda")
    labels = torch.randint(0, cfg.n_classes, (V,), generator=gen,
                           device="cuda")
    b = GraphBatch(positions=None, node_feat=feat[nodes], species=None,
                   **common)
    return b, labels[nodes]


def gnn_loss(module, cfg, style):
    if style == "geometric":
        return lambda p, b, t: module.energy_loss(p, b, t, cfg)
    return lambda p, b, t: module.node_xent_loss(p, b, t, cfg)


def gnn_profile_split(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the card's kernel time
    split into gathers and scatters (indexing, ``index_add``,
    ``scatter_reduce``), matrix products (cuBLAS: the einsums, batched
    products and MLPs) and the rest (ms), and the call's wall ms."""
    from torch.profiler import ProfilerActivity, profile

    # the card's activity alone: a step's CPU events (tens of thousands of
    # small ops) take the profiler's post-processing seconds
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = {"gather_scatter": 0.0, "matmul": 0.0, "other": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        name, ms = e.name, e.self_device_time_total / 1e3
        if re.search(r"gemm|gemv|nvjet|cutlass|xmma|cublas|sm90_|dot_kernel",
                     name, re.IGNORECASE):
            split["matmul"] += ms
        elif re.search(r"index|scatter|gather", name, re.IGNORECASE):
            split["gather_scatter"] += ms
        else:
            split["other"] += ms
    return {"busy_ms": sum(split.values()), "kernels": n, "split_ms": split,
            "profiled_wall_ms": 1e3 * wall}


def gnn_run(torch, np, arch: str, shape_name: str, sampled: dict) -> dict:
    """One (arch, shape) cell: the full config with seeded random weights
    and AdamW through ``build_gnn_train_step``, GNN_STEPS steps and a
    profiled one more; each step's ms, loss and gradient norm (read inside
    the step's AdamW update), the peak bytes."""
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps as S
    from repro_torch.train import optimizer as opt

    module, style = S._GNN[arch]
    cfg = gnn_config(arch, GNN_SHAPES[shape_name])
    batch, targets = gnn_batch(torch, np, arch, shape_name, cfg, style,
                               sampled)
    params = module.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(GNN_SEED))
    ostate = opt.init(params)
    step = S.build_gnn_train_step(module, cfg, style)
    norms = []
    real_update = opt.update

    def update(cfg_, grads, *a, **kw):
        norms.append(float(opt.global_norm(grads)))
        return real_update(cfg_, grads, *a, **kw)

    out = {"phase": "gnn", "arch": arch, "shape": shape_name,
           "nodes": batch.n_nodes, "edges": batch.n_edges,
           "live_edges": int(batch.edge_mask.sum()),
           "graphs": batch.n_graphs,
           "parameters": sum(p.numel() for p in tree_leaves(params)),
           "step_ms": [], "loss": []}
    torch.cuda.synchronize()
    arg_bytes = storage_bytes(torch, params, ostate, batch, targets)
    torch.cuda.reset_peak_memory_stats()
    left_before = torch.cuda.memory_allocated() - arg_bytes
    with swapped(S.opt, update=update):
        for _ in range(GNN_STEPS):
            t0 = time.perf_counter()
            params, ostate, loss = step(params, ostate, batch, targets)
            torch.cuda.synchronize()
            out["step_ms"].append(1e3 * (time.perf_counter() - t0))
            out["loss"].append(float(loss))
        last = {}

        def profiled():
            last["out"] = step(params, ostate, batch, targets)

        out["profile"] = gnn_profile_split(torch, profiled)
    params, ostate, loss = last["out"]
    out["loss"].append(float(loss))
    out["grad_norm"] = norms
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["step_peak_bytes"] = out["peak_bytes"] - left_before
    check(all(np.isfinite(out["loss"])) and all(np.isfinite(norms)),
          f"{arch} on {shape_name}: a loss or gradient norm is not finite")
    check(len(norms) == GNN_STEPS + 1, "the step did not run AdamW")
    del params, ostate, batch, targets
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rotation(torch, np, seed: int):
    """A seeded random rotation (QR of a Gaussian matrix, det +1)."""
    Q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return torch.tensor(Q, dtype=torch.float32)


def gnn_faults(torch, arch: str, batch):
    """The planted fault of each model, as a context manager: a CG block
    with its output's m order reversed (NequIP, MACE: the (0, 1, 1) block
    that carries every layer's scalars into l = 1; an axis transposition of
    a CG block is itself an invariant tensor and cannot fail the invariance
    gate), the attention softmax normalised over senders (EquiformerV2), or
    PNA's min aggregator replaced by its max."""
    from repro_torch.models.gnn import equiformer_v2 as eq2
    from repro_torch.models.gnn import pna, tensor_field

    if arch in ("nequip", "mace"):
        real = tensor_field.cg_tensor

        def cg(l1, l2, l3, device, dtype=torch.float32):
            C = real(l1, l2, l3, device, dtype)
            return C.flip(2) if (l1, l2, l3) == (0, 1, 1) else C
        return "cg_block_m_reversed", swapped(tensor_field, cg_tensor=cg)
    if arch == "equiformer-v2":
        real = eq2.segment_softmax
        snd = batch.senders

        def over_senders(logits, segs, n, mask):
            return real(logits, snd, n, mask)
        return "softmax_over_senders", swapped(
            eq2, segment_softmax=over_senders)
    real = pna._aggregate

    def min_is_max(msg, *a):
        out = real(msg, *a)
        d = msg.shape[1]
        return torch.cat([out[:, :6 * d], out[:, 3 * d:6 * d],
                          out[:, 9 * d:]], dim=-1)
    return "min_replaced_by_max", swapped(pna, _aggregate=min_is_max)


def gnn_step_gate(torch, np) -> dict:
    """Each full config cut to GNN_GATE_LAYERS layers: the loss and every
    gradient leaf on the card against the same on the CPU (float32, no
    TF32) within STEP_TOL (GNN_STEP_TOL for PNA) of each leaf's scale
    (floored at GNN_LEAF_FLOOR of the largest), and with its planted fault
    on the card, which must fall outside."""
    import dataclasses

    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import steps as S
    from repro_torch.models.gnn.common import (random_feature_graph,
                                               random_geometric_batch)

    out = {}
    mol = GNN_SHAPES["molecule"]
    N = mol["n_nodes"] * GNN_GATE_GRAPHS
    E = mol["n_edges"] * GNN_GATE_GRAPHS
    for arch in ("nequip", "mace", "pna", "equiformer-v2"):
        module, style = S._GNN[arch]
        cfg = dataclasses.replace(gnn_config(arch, mol),
                                  n_layers=GNN_GATE_LAYERS)
        gen = torch.Generator().manual_seed(GNN_SEED)
        params = module.init_params(cfg, gen)
        if style == "geometric":
            batch = random_geometric_batch(gen, N, E, n_graphs=GNN_GATE_GRAPHS,
                                           n_species=cfg.n_species)
            targets = torch.randn((GNN_GATE_GRAPHS,), generator=gen)
        else:
            batch = random_feature_graph(gen, N, E, cfg.d_in)
            targets = torch.randint(0, cfg.n_classes, (N,), generator=gen)
        loss = gnn_loss(module, cfg, style)
        lw, gw = S.value_and_grad(loss, params, batch, targets)
        want = (lw.reshape(1), gw)
        card = tree_map(lambda x: x.cuda(), params)
        cb, ct = batch.to("cuda"), targets.cuda()

        def on_card():
            lc, gc_ = S.value_and_grad(loss, card, cb, ct)
            return tree_map(lambda x: x.cpu(), (lc.reshape(1), gc_))

        tol = GNN_STEP_TOL.get(arch, STEP_TOL)
        got = on_card()
        clean = step_readings(torch, got, want, tol, GNN_LEAF_FLOOR)
        # the segment sums add with atomics on the card: the same step
        # twice, bit for bit or not (read, not gated)
        again = trees_equal(torch, got, on_card())
        fault, ctx = gnn_faults(torch, arch, cb)
        with ctx:
            faulty = step_readings(torch, on_card(), want, tol,
                                   GNN_LEAF_FLOOR)
        out[arch] = {"loss": float(lw), "tol": tol, "clean": clean,
                     "bit_equal_twice": again, "fault": fault,
                     "faulty": faulty}
    return out


def gnn_invariance_gate(torch, np) -> dict:
    """Each geometric full config's energies on the molecule shape's batch
    (positions redrawn in a GNN_INV_BOX box), at full depth, against those
    of the same batch with its positions under a seeded rotation: within
    GNN_INV_TOL of the energies' scale, and the planted CG fault (NequIP,
    MACE) outside."""
    import dataclasses

    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.launch import steps as S

    R = rotation(torch, np, GNN_SEED + 1).cuda()
    out = {}
    for arch in ("nequip", "mace", "equiformer-v2"):
        module, style = S._GNN[arch]
        cfg = gnn_config(arch, GNN_SHAPES["molecule"])
        batch, _ = gnn_batch(torch, np, arch, "molecule", cfg, style, None)
        gen = torch.Generator(device="cuda").manual_seed(GNN_SEED + 2)
        batch = dataclasses.replace(batch, positions=torch.rand(
            (batch.n_nodes, 3), generator=gen, device="cuda") * GNN_INV_BOX)
        turned = dataclasses.replace(batch, positions=batch.positions @ R.T)
        params = module.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(GNN_SEED))

        def reading():
            with torch.no_grad():
                e = module.forward(params, batch, cfg)
                er = module.forward(params, turned, cfg)
            return float((e - er).abs().max() / e.abs().max())

        row = {"layers": cfg.n_layers, "rel_err": reading()}
        if arch in ("nequip", "mace"):
            fault, ctx = gnn_faults(torch, arch, batch)
            with ctx:
                row["fault"], row["fault_rel_err"] = fault, reading()
        out[arch] = row
        del params, batch, turned
    return out


def gnn_live_loop(torch, np) -> dict:
    """The reference's examples/gnn_molecules.py at full width: NequIP's
    full config on a SlabGraph of 128 molecules of 30 atoms whose bond
    graph changes every step (intra-molecule inserts through the update
    engine, kernels 1-2 on the card, deletes every third step), fed to the
    train step through ``edges_from_slab``; every step the card's edges
    must equal the CPU port's on a host copy of the same pool bit for
    bit."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.core import batch as tbatch
    from repro_torch.core.bridge import (slab_graph_from_numpy,
                                         slab_graph_to_numpy)
    from repro_torch.core.slab_graph import empty, ensure_capacity
    from repro_torch.kernels import runtime
    from repro_torch.launch import steps as S
    from repro_torch.models.gnn.common import GraphBatch, edges_from_slab
    from repro_torch.train import optimizer as opt

    mol = GNN_SHAPES["molecule"]
    per, G = mol["n_nodes"], mol["batch"]
    V, E_CAP = per * G, mol["n_edges"] * G
    cfg = get_arch("nequip").full_config()
    module, style = S._GNN["nequip"]
    rng = np.random.default_rng(GNN_SEED)
    gen = torch.Generator(device="cuda").manual_seed(GNN_SEED)
    params = module.init_params(cfg, gen)
    ostate = opt.init(params)
    step = S.build_gnn_train_step(module, cfg, style)
    pos = (torch.rand((V, 3), generator=gen, device="cuda") * 4.0)
    species = torch.randint(0, cfg.n_species, (V,), generator=gen,
                            device="cuda", dtype=torch.int32)
    gids = torch.arange(V, device="cuda", dtype=torch.int32) // per
    g = empty(V, np.ones(V, np.int32), 256, device="cuda")

    def pad(xs, n):
        a = np.full(n, 0xFFFFFFFF, np.uint32)
        a[:len(xs)] = np.asarray(xs, np.uint32)
        return torch.from_numpy(a.view(np.int32)).cuda()

    runtime.reset_launches()
    out = {"phase": "gnn_live", "vertices": V, "max_edges": E_CAP,
           "edges": [], "step_ms": [], "update_ms": [], "loss": []}
    for it in range(GNN_LIVE_STEPS):
        t0 = time.perf_counter()
        mol_id = rng.integers(0, G, GNN_LIVE_INSERTS)
        ns = mol_id * per + rng.integers(0, per, GNN_LIVE_INSERTS)
        nd = mol_id * per + rng.integers(0, per, GNN_LIVE_INSERTS)
        g = ensure_capacity(g, GNN_LIVE_INSERTS // 128 + 8)
        g, _ = tbatch.insert_edges(g, pad(ns, GNN_LIVE_INSERTS),
                                   pad(nd, GNN_LIVE_INSERTS))
        if it % 3 == 2:
            k = GNN_LIVE_DELETES
            g, _ = tbatch.delete_edges(g, pad(ns[:k], k), pad(nd[:k], k))
        snd, rcv, emask = edges_from_slab(g, max_edges=E_CAP)
        torch.cuda.synchronize()
        out["update_ms"].append(1e3 * (time.perf_counter() - t0))
        host = slab_graph_from_numpy(slab_graph_to_numpy(g), "cpu")
        want = edges_from_slab(host, max_edges=E_CAP)
        check(all(torch.equal(a.cpu(), b) for a, b in
                  zip((snd, rcv, emask), want)),
              f"edges_from_slab on the card differs from the CPU's at "
              f"step {it}")
        batch = GraphBatch(positions=pos, node_feat=None, species=species,
                           senders=snd, receivers=rcv, edge_mask=emask,
                           node_mask=torch.ones(V, dtype=torch.bool,
                                                device="cuda"),
                           graph_ids=gids, n_graphs=G)
        target = torch.full((G,), float(np.sin(it)), device="cuda")
        t0 = time.perf_counter()
        params, ostate, loss = step(params, ostate, batch, target)
        torch.cuda.synchronize()
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["loss"].append(float(loss))
        out["edges"].append(int(emask.sum()))
    out["launches"] = {k: runtime.LAUNCHES[k]
                       for k in ("slab_probe", "slab_commit")}
    out["live_edges_end"] = int(g.n_edges)
    check(all(np.isfinite(out["loss"])), "the live loop's loss is not finite")
    for name, n in out["launches"].items():
        check(n > 0, f"the live loop never launched {name}")
    check(out["live_edges_end"] > E_CAP,
          "the live graph never outgrew the edge slots")
    return out


def gnn_phase(torch, np, sampled: dict) -> dict:
    """The GNN family at full width: the GNN_RUNS cells, the step and
    invariance gates and the live loop."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    for arch, shape in GNN_RUNS:
        t0 = time.perf_counter()
        row = gnn_run(torch, np, arch, shape, sampled)
        row["seconds"] = time.perf_counter() - t0
        emit(row)
        runs.append(row)
    t0 = time.perf_counter()
    gates = {"step": gnn_step_gate(torch, np),
             "invariance": gnn_invariance_gate(torch, np)}
    emit({"phase": "gnn_gates", "leaf_floor": GNN_LEAF_FLOOR,
          "inv_tol": GNN_INV_TOL, **gates,
          "seconds": time.perf_counter() - t0})
    for arch, r in gates["step"].items():
        check(r["clean"]["close"], f"{arch}: the step on the card is outside "
                                   f"{r['tol']} of the CPU's: {r['clean']}")
        check(not r["faulty"]["close"], f"{arch}: the planted fault "
                                        f"{r['fault']} passes the step gate")
    for arch, r in gates["invariance"].items():
        check(r["rel_err"] <= GNN_INV_TOL, f"{arch}: energies moved by "
              f"{r['rel_err']} of their scale under a rotation")
        check(r.get("fault_rel_err", 1.0) > GNN_INV_TOL,
              f"{arch}: the planted fault passes the invariance gate")
    live = gnn_live_loop(torch, np)
    emit(live)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "gates": gates, "live": live}


# ----------------------------------------------------------------------------
# phase 6: EmbeddingBag at MIND's full table
# ----------------------------------------------------------------------------

def bag_inputs(torch, np):
    """Phase 6's inputs on the card: MIND's table in float32 and a bfloat16
    copy (``{"f32", "bf16"}``), ``{B: (indices, weights)}`` of 50-slot
    history bags for each of ``BAG_BATCHES``, and the op's calls as
    ``(name, B, dtype)``."""
    from repro_torch.data import synth

    gen = torch.Generator(device="cuda").manual_seed(1)
    table = torch.randn((BAG_ROWS, BAG_DIM), generator=gen, device="cuda")
    tables = {"f32": table, "bf16": table.to(torch.bfloat16)}
    bags = {}
    for B in BAG_BATCHES:
        hist, mask, _ = next(synth.recsys_batches(BAG_ROWS, B, BAG_HIST,
                                                  seed=0))
        idx = np.where(mask > 0, hist, -1).astype(np.int32)
        w = np.random.default_rng(2).standard_normal(idx.shape) \
            .astype(np.float32)
        bags[B] = (torch.from_numpy(idx).to("cuda"),
                   torch.from_numpy(w).to("cuda"))
    calls = [(f"B={B} f32", B, "f32") for B in BAG_BATCHES] + \
        [(f"B={BAG_BATCHES[-1]} bf16", BAG_BATCHES[-1], "bf16")]
    return tables, bags, calls


def embedding_bag_phase(torch, np) -> dict:
    """The EmbeddingBag op on MIND's table (2**21 items x 64, float32, and a
    bfloat16 copy) for bags of 50-slot histories: the op's three calls with
    the launch counts zeroed just before, then each against its plain
    version, timed on the device alone, beside ``F.embedding_bag``."""
    import torch.nn.functional as F

    from repro_torch.kernels import runtime
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref)

    tables, bags, variants = bag_inputs(torch, np)
    # 256 MiB, five times the L2, overwritten before each ``flushed_ms``
    # call: the table's rows are read from device memory, as by a caller
    # whose other work evicted them
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    runtime.reset_launches()
    outs = {name: embedding_bag(*bags[B], tables[dt])
            for name, B, dt in variants}
    torch.cuda.synchronize()
    launches = runtime.LAUNCHES["embedding_bag"]
    check(launches == len(variants),
          f"embedding_bag launched {launches} times for {len(variants)} "
          "calls")

    results = []
    for name, B, dt in variants:
        idx, w = bags[B]
        tab = tables[dt]
        got = outs[name]
        plain = embedding_bag_ref(idx, w, tab)
        torch.cuda.synchronize()
        check(got.dtype == tab.dtype and got.shape == (B, BAG_DIM),
              f"embedding_bag {name}: {got.dtype} {tuple(got.shape)}")
        tol = BAG_TOL[dt]
        err = float((got.float() - plain).abs().max())
        check(torch.allclose(got.float(), plain, atol=tol, rtol=tol),
              f"embedding_bag differs from its plain version ({name}) by "
              f"{err}")
        valid = idx >= 0
        flat = idx[valid].long()
        offsets = torch.zeros(B, dtype=torch.long, device=idx.device)
        offsets[1:] = torch.cumsum(valid.sum(dim=1), 0)[:-1]
        psw = w[valid].to(tab.dtype)

        def library():
            return F.embedding_bag(flat, tab, offsets, mode="sum",
                                   per_sample_weights=psw)
        lib_err = float((library().float() - plain).abs().max())
        check(lib_err <= tol * (1 + float(plain.abs().max())),
              f"F.embedding_bag disagrees with the plain version ({name})")
        rows = int(torch.unique(flat).numel())
        item = tab.element_size()
        # each slot's index and weight, each distinct row once, the output
        n_bytes = B * BAG_HIST * 8 + rows * BAG_DIM * item \
            + B * BAG_DIM * item
        results.append(dict(
            name="embedding_bag", variant=name, max_abs_err=err,
            ms=device_ms(torch, lambda: embedding_bag(idx, w, tab)),
            flushed_ms=device_ms(torch, lambda: embedding_bag(idx, w, tab),
                                 flush=flush),
            gathered_bytes=int(flat.numel()) * BAG_DIM * item,
            plain_ms=device_ms(torch, lambda: embedding_bag_ref(idx, w,
                                                                tab)),
            library_ms=device_ms(torch, library),
            library="F.embedding_bag(mode='sum', per_sample_weights)",
            library_max_abs_err=lib_err, valid_slots=int(flat.numel()),
            distinct_rows=rows,
            **bound(n_bytes, 2 * int(flat.numel()) * BAG_DIM)))
        del plain
    for r in results:
        emit({"phase": "embedding_bag", **r})
    return {"launches": launches, "results": results}



# ----------------------------------------------------------------------------
# the examples phase: the four examples/torch_*.py on the card
# ----------------------------------------------------------------------------

#: each example's kernels, all of which must launch in its run on the card
#: (the quickstart's BFS and WCC expand edges and union-find: no sweep)
EX_KERNELS = {
    "torch_quickstart": ("slab_probe", "slab_commit"),
    "torch_streaming_analytics": ("slab_probe", "slab_commit", "slab_sweep",
                                  "slab_live", "slab_chain_rank"),
    "torch_gnn_molecules": ("slab_probe", "slab_commit"),
    "torch_train_lm": ("flash_attention", "flash_attention_bwd"),
}
#: gnn_molecules' 20 losses on the card against the CPU's (float32, no
#: TF32; the segment sums' float atomics order the card's sums anew each
#: run); one step's AdamW update skipped (EX_GNN_FAULT_STEP) must fall
#: outside.  On an H100 80GB HBM3 at 700 W the largest difference read
#: 1.55e-6 clean and 0.242 with the step skipped (PERF.md section 6).
EX_GNN_LOSS_TOL = 1e-3
EX_GNN_FAULT_STEP = 10
#: train_lm on the card: a first run and its resumption in the same
#: checkpoint directory
EX_TRAIN_STEPS = (20, 25)
#: kernel 10 and its backward through ``ops.flash_attention`` at
#: train_lm's shapes (its 16-wide heads zero-padded to 64) against
#: ``attention_ref`` and its autograd in float32, as atol = rtol: the card
#: test ``test_flash_attention_narrow_head_matches_plain``'s
EX_ATTN_TOL = {"forward": 2e-5, "backward": 1e-4}
EX_ATTN_SEED = 3


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(torch, fn) -> tuple:
    """(``fn()``'s result, its ms on the host clock, the kernels it
    launched), the launch counts zeroed just before and read just after."""
    from repro_torch.kernels import runtime
    runtime.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return out, ms, {k: v for k, v in runtime.LAUNCHES.items() if v}


def skipping_update(opt, step: int):
    """``opt.update`` that leaves parameters and moments as they were at
    call ``step`` (counted from 0): one AdamW step skipped."""
    real, calls = opt.update, [0]

    def update(cfg, grads, state, params, **kw):
        calls[0] += 1
        if calls[0] - 1 == step:
            return params, state
        return real(cfg, grads, state, params, **kw)
    return update


def ex_attention_check(torch, captured: dict) -> dict:
    """Kernel 10's forward and backward through ``ops.flash_attention`` on
    the q, k, v and options train_lm's first local and global calls took,
    against ``attention_ref`` and its autograd on the same inputs and a
    seeded cotangent; per call the largest error and its excess over
    EX_ATTN_TOL (fails above 0), and the launches the check made."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def excess(got, want, tol):
        return float(((got - want).abs() - tol * (1 + want.abs())).max())

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, (q, k, v, kw) in sorted(captured.items()):
        gen = torch.Generator(device=q.device).manual_seed(EX_ATTN_SEED)
        do = torch.randn(q.shape, generator=gen, device=q.device,
                         dtype=q.dtype)
        before = dict(runtime.LAUNCHES)
        ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        got = ops.flash_attention(*ts, **kw)
        grads = torch.autograd.grad(got, ts, do)
        launched = {n: runtime.LAUNCHES[n] - before.get(n, 0)
                    for n in ("flash_attention", "flash_attention_bwd")}
        refs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        want = attention_ref(*refs, **kw)
        want_grads = torch.autograd.grad(want, refs, do)
        got, want = got.detach(), want.detach()
        row = {"shape": {"q": list(q.shape), "k": list(k.shape)},
               "dtype": str(q.dtype).replace("torch.", ""),
               "window": kw.get("window", 0),
               "softcap": kw.get("softcap", 0.0), "launched": launched,
               "forward_err": float((got - want).abs().max()),
               "forward_excess": excess(got, want, EX_ATTN_TOL["forward"]),
               "backward_err": max(float((a - b).abs().max())
                                   for a, b in zip(grads, want_grads)),
               "backward_excess": max(
                   excess(a, b, EX_ATTN_TOL["backward"])
                   for a, b in zip(grads, want_grads))}
        check(all(n == 1 for n in launched.values()),
              f"train_lm's {name} attention check launched {launched}")
        check(row["forward_excess"] <= 0 and row["backward_excess"] <= 0,
              f"kernel 10 at train_lm's {name} attention differs from "
              f"attention_ref: {row}")
        out[name] = row
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def examples_phase(torch, np) -> dict:
    """The four ported examples in-process on the card, each held to the
    same example on the CPU (the plain versions) but train_lm, which runs
    on the card only, then resumes."""
    import contextlib
    import io
    import tempfile
    lines = {}

    def quiet(fn):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn()

    def line(name, card_ms, cpu_ms, launched, **kw):
        for k in EX_KERNELS[name]:
            check(launched.get(k, 0) > 0,
                  f"{name} never launched {k} on the card")
        row = {"phase": "examples", "example": name, "card_ms": card_ms,
               "cpu_ms": cpu_ms, "kernels": launched, **kw}
        emit(row)
        lines[name] = row

    for name in ("torch_quickstart", "torch_streaming_analytics"):
        mod = load_example(name)
        card, card_ms, launched = run_example(
            torch, lambda: quiet(lambda: mod.main(device="cuda")))
        t0 = time.perf_counter()
        cpu = quiet(lambda: mod.main(device="cpu"))
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        top = None
        if "pagerank_top" in card:
            top = abs(card.pop("pagerank_top") - cpu.pop("pagerank_top"))
            check(top <= PR_REF_ABS, f"{name}: PageRank's top on the card "
                                     f"is {top} from the CPU's")
        check(card == cpu, f"{name}: the card printed {card}, the CPU {cpu}")
        line(name, card_ms, cpu_ms, launched, pagerank_top_err=top)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    name = "torch_gnn_molecules"
    mod = load_example(name)
    card, card_ms, launched = run_example(
        torch, lambda: quiet(lambda: mod.main(device="cuda")))
    t0 = time.perf_counter()
    cpu = quiet(lambda: mod.main(device="cpu"))
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    with swapped(mod.opt, update=skipping_update(mod.opt,
                                                 EX_GNN_FAULT_STEP)):
        faulty = quiet(lambda: mod.main(device="cuda"))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    err = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
    fault_err = max(abs(a - b)
                    for a, b in zip(faulty["losses"], cpu["losses"]))
    check(card["edges"] == cpu["edges"] == faulty["edges"],
          f"{name}: edges on the card {card['edges']}, on the CPU "
          f"{cpu['edges']}")
    check(all(np.isfinite(card["losses"])), f"{name}: a loss is not finite")
    check(err <= EX_GNN_LOSS_TOL, f"{name}: the card's losses are {err} "
                                  f"from the CPU's")
    check(fault_err > EX_GNN_LOSS_TOL,
          f"{name}: a skipped AdamW step passes the gate ({fault_err})")
    line(name, card_ms, cpu_ms, launched, loss_err=err,
         fault_loss_err=fault_err, tol=EX_GNN_LOSS_TOL,
         edges=card["edges"])

    name = "torch_train_lm"
    mod = load_example(name)
    import repro_torch.models.transformer as tfm
    captured = {}
    with tempfile.TemporaryDirectory() as d, swapped(
            tfm, flash_attention=capture_attention(torch, tfm, captured)):
        runs = []
        for n in EX_TRAIN_STEPS:
            runs.append(run_example(torch, lambda n=n: quiet(lambda: mod.main(
                ["--steps", str(n), "--ckpt-dir", d]))))
    (first, ms1, l1), (second, ms2, l2) = runs
    losses = first["losses"] + second["losses"]
    check(all(np.isfinite(losses)), f"{name}: a loss is not finite")
    check(len(first["losses"]) == first["final_step"] == EX_TRAIN_STEPS[0],
          f"{name}: the first run took {len(first['losses'])} steps")
    check(second["final_step"] == EX_TRAIN_STEPS[1] and
          len(second["losses"]) == EX_TRAIN_STEPS[1] - EX_TRAIN_STEPS[0],
          f"{name}: the second run did not resume at step "
          f"{EX_TRAIN_STEPS[0]}: {len(second['losses'])} steps")
    launched = {k: l1.get(k, 0) + l2.get(k, 0) for k in set(l1) | set(l2)}
    check(set(captured) == {"local", "global"},
          f"{name}: attention calls captured {sorted(captured)}")
    attention = ex_attention_check(torch, captured)
    line(name, ms1 + ms2, None, launched, steps=list(EX_TRAIN_STEPS),
         first_loss=losses[0], last_loss=losses[-1],
         resumed_at=second["final_step"] - len(second["losses"]),
         attention=attention, attention_tol=EX_ATTN_TOL)
    return lines


# ----------------------------------------------------------------------------
# the dryrun phase: the dry run and the roofline held to the card
# ----------------------------------------------------------------------------

#: a predicted peak must lie within this factor of the measured one (both
#: ways).  The first run (NVIDIA H100 80GB HBM3, 700.00 W) read predicted
#: over measured 0.925 (PNA on full_graph_sm: 16 MB of a 217 MB step the
#: trace does not see, cuBLAS workspaces and the allocator's rounding)
#: to 1.000 (both prefills, MIND); PERF.md section 6
DRY_PEAK_FACTOR = 1.25
#: EquiformerV2 with all three levers (bf16 compute, two edge chunks, the
#: truncated rotation): the step gate's cut (GNN_GATE_LAYERS layers, full
#: width, GNN_GATE_GRAPHS molecules) on the card against the CPU, its loss
#: within EQ_LEVER_LOSS relative and every gradient leaf within
#: EQ_LEVER_GRAD of the largest gradient.  The card against the CPU port
#: read 8.6e-5 to 1.6e-3 (loss) and 7.0e-4 to 9.4e-4 (gradients) in three
#: runs (NVIDIA H100 80GB HBM3, 700.00 W; bf16 index_add's atomics make
#: them vary); the planted fault, the last of the two edge chunks left out
#: of the aggregation (``last_chunk_dropped``), must break both bounds
#: (0.45 and 0.35 on the CPU at one layer).  Then EQ_LEVER_STEPS timed
#: steps at full depth on the molecule shape (the two edge chunks
#: recompute the Wigner blocks a chunk, a pass and a layer: ~8.8 s a step
#: against 0.45 s without the levers, tools/eq_levers.py, so one step)
EQ_LEVERS = {"compute_dtype": "bfloat16", "edge_chunks": 2,
             "trunc_rotation": True}
EQ_LEVER_LOSS, EQ_LEVER_GRAD, EQ_LEVER_STEPS = 5e-3, 5e-3, 1

_DRY_WORKER = {}


def dry_cells() -> list:
    """(arch, shape, shape overrides, parameter dtype) of every cell the
    script runs at full width, with the script's own cuts, then the GNN
    cells it does not run."""
    lm = {"global_batch": LM_BATCH, "seq_len": LM_PROMPT}
    return ([(TRAIN_ARCH, TRAIN_SHAPE, {"global_batch": TRAIN_BATCH},
              "float32"),
             ("gemma2-9b", "prefill_32k", lm, "bfloat16"),
             (MOE_ARCH, "prefill_32k", lm, "bfloat16"),
             ("mind", "train_batch", None, "float32")]
            + [(a, sh, None, "float32") for a, sh in GNN_RUNS + GNN_NOT_RUN])


def dryrun_worker(out: str) -> int:
    """``--dryrun-worker OUT``: trace every ``dry_cells`` cell with
    ``launch.dryrun.run_cell`` on ``"single"`` with ``attn_impl="kernel"``
    (fake tensors; an LM step's on the CUDA device, so its attention is
    kernel 10's registered operators, as the card runs it) and write the
    records to OUT as they come.  Runs at the lowest priority on one core
    (the host's last) with one thread, beside the phases that time the
    host."""
    import os
    os.nice(19)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun

    recs = []
    for arch, shape, ov, dtype in dry_cells():
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, "single", overrides=ov,
                              attn_impl="kernel",
                              param_dtype=getattr(torch, dtype),
                              verbose=False)
        rec["wall_s"] = time.perf_counter() - t0
        recs.append(rec)
        Path(out).write_text(json.dumps(recs))
    return 0


def start_dryrun_worker(tmp: Path) -> None:
    """Start ``dryrun_worker`` in its own process: it runs nothing on the
    card, so it traces while the card runs the other phases."""
    out, log = tmp / "dryrun.json", tmp / "dryrun.log"
    _DRY_WORKER.update(out=out, log=log, t0=time.perf_counter(),
                       proc=subprocess.Popen(
                           [sys.executable, str(Path(__file__).resolve()),
                            "--dryrun-worker", str(out)],
                           stdout=log.open("w"), stderr=subprocess.STDOUT))


def stop_dryrun_worker() -> None:
    proc = _DRY_WORKER.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def dryrun_records(timeout_s: float = 600) -> dict:
    """The worker's records by (arch, shape), after waiting for it."""
    proc = _DRY_WORKER["proc"]
    try:
        rc = proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        stop_dryrun_worker()
        raise SmokeFailure(f"the dry-run worker ran past {timeout_s} s")
    log = _DRY_WORKER["log"].read_text()
    check(rc == 0, f"the dry-run worker failed (rc {rc}): {log[-2000:]}")
    # when the worker wrote its last record, on the script's clock
    _DRY_WORKER["done_t_s"] = (time.perf_counter() - START) - (
        time.time() - _DRY_WORKER["out"].stat().st_mtime)
    recs = json.loads(_DRY_WORKER["out"].read_text())
    check(all(r["ok"] for r in recs), "a dry-run cell failed")
    return {(r["arch"], r["shape"]): r for r in recs}


@contextlib.contextmanager
def last_chunk_dropped():
    """A planted fault in EquiformerV2's chunked attention: the
    aggregation pass skips the second of two edge chunks (its
    checkpointed call returns the aggregates unchanged)."""
    import torch.utils.checkpoint as ckpt_mod
    real, calls = ckpt_mod.checkpoint, [0]

    def checkpoint(fn, *args, **kw):
        if fn.__name__ == "agg_chunk":
            calls[0] += 1
            if calls[0] % 2 == 0:
                n = (len(args) - 4) // 2
                return tuple(args[4:4 + n])
        return real(fn, *args, **kw)
    ckpt_mod.checkpoint = checkpoint
    try:
        yield
    finally:
        ckpt_mod.checkpoint = real


def eq_lever_phase(torch, np, plain_ms: float) -> dict:
    """EquiformerV2 on ``molecule`` with EQ_LEVERS: the step gate's cut on
    the card against the CPU port (loss and gradients), then
    EQ_LEVER_STEPS steps of the full config through
    ``build_gnn_train_step``, timed beside the plain step of the gnn
    phase (``plain_ms``)."""
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch import steps as S
    from repro_torch.models.gnn.common import random_geometric_batch
    from repro_torch.train import optimizer as opt

    module, style = S._GNN["equiformer-v2"]
    mol = GNN_SHAPES["molecule"]
    levers = dict(EQ_LEVERS, compute_dtype=getattr(
        torch, EQ_LEVERS["compute_dtype"]))
    cfg = dataclasses.replace(gnn_config("equiformer-v2", mol), **levers)
    # the gate: the CPU port and the card, the same weights and batch
    small = dataclasses.replace(cfg, n_layers=GNN_GATE_LAYERS)
    gen = torch.Generator().manual_seed(GNN_SEED)
    params = module.init_params(small, gen)
    N = mol["n_nodes"] * GNN_GATE_GRAPHS
    E = mol["n_edges"] * GNN_GATE_GRAPHS
    batch = random_geometric_batch(gen, N, E, n_graphs=GNN_GATE_GRAPHS,
                                   n_species=small.n_species)
    targets = torch.randn((GNN_GATE_GRAPHS,), generator=gen)
    loss = gnn_loss(module, small, style)
    lw, gw = S.value_and_grad(loss, params, batch, targets)
    card = (tree_map(lambda x: x.cuda(), params), batch.to("cuda"),
            targets.cuda())
    top = max(float(g.abs().max()) for g in tree_leaves(gw))

    def errs(lc, gc_):
        return (abs(float(lc) - float(lw)) / abs(float(lw)),
                max(float((a.cpu() - b).abs().max())
                    for a, b in zip(tree_leaves(gc_), tree_leaves(gw))))
    loss_err, grad_err = errs(*S.value_and_grad(loss, *card))
    with last_chunk_dropped():
        fault_loss, fault_grad = errs(*S.value_and_grad(loss, *card))
    # the full config, timed
    gen = torch.Generator(device="cuda").manual_seed(GNN_SEED)
    Nf, Ef, Gf = gnn_shape_size(mol)
    fb = random_geometric_batch(gen, Nf, Ef, n_graphs=Gf,
                                n_species=cfg.n_species)
    ft = torch.randn((Gf,), generator=gen, device="cuda")
    fp = module.init_params(cfg, gen)
    fs = opt.init(fp)
    step = S.build_gnn_train_step(module, cfg, style)
    ms, losses = [], []
    for _ in range(EQ_LEVER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fp, fs, fl = step(fp, fs, fb, ft)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(fl))
    out = {"phase": "dryrun_eq_levers", "levers": EQ_LEVERS,
           "gate": {"layers": GNN_GATE_LAYERS, "graphs": GNN_GATE_GRAPHS,
                    "cpu_loss": float(lw),
                    "loss_rel_err": loss_err,
                    "grad_err_over_top": grad_err / top,
                    "dropped_chunk": {"loss_rel_err": fault_loss,
                                      "grad_err_over_top": fault_grad / top},
                    "tol": {"loss": EQ_LEVER_LOSS, "grad": EQ_LEVER_GRAD}},
           "step_ms": ms, "losses": losses,
           "plain_step_ms_median": plain_ms,
           "lever_step_ms_median": statistics.median(ms)}
    emit(out)
    check(loss_err <= EQ_LEVER_LOSS, f"EquiformerV2 with its levers: the "
          f"card's loss differs from the CPU's by {loss_err} relative")
    check(grad_err <= EQ_LEVER_GRAD * top, f"EquiformerV2 with its levers: "
          f"a gradient differs from the CPU's by {grad_err / top} of the "
          "largest")
    check(fault_loss > EQ_LEVER_LOSS and fault_grad > EQ_LEVER_GRAD * top,
          "EquiformerV2 with its levers: a dropped edge chunk passes the "
          f"gate ({fault_loss}, {fault_grad / top})")
    check(all(np.isfinite(losses)), f"EquiformerV2 lever losses {losses}")
    del fp, fs, fb, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def kernel_trace_check(r: dict) -> None:
    """gemma-2b's train step as the worker traced it on CUDA fake tensors
    (record ``r``): kernel 10's forward operator 2 x layers x microbatches
    times (remat recomputes it), its backward layers x microbatches times,
    each with the formula's flops."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import attention_flops
    from repro_torch.launch.steps import MICROBATCH

    cfg = get_arch(TRAIN_ARCH).full_config()
    seq = get_arch(TRAIN_ARCH).SHAPES[TRAIN_SHAPE]["seq_len"]
    n_micro = MICROBATCH[(TRAIN_ARCH, TRAIN_SHAPE)]
    q = (TRAIN_BATCH // n_micro, cfg.n_heads, seq, cfg.head_dim)
    k = (q[0], cfg.n_kv_heads, seq, cfg.head_dim)
    fwd_n, bwd_n = 2 * cfg.n_layers * n_micro, cfg.n_layers * n_micro
    kw = dict(causal=True, window=0, kv_len=seq)
    want = {"repro_torch.flash_attention_fwd":
            fwd_n * attention_flops(q, k, **kw),
            "repro_torch.flash_attention_bwd":
            bwd_n * attention_flops(q, k, backward=True, **kw)}
    ops = r["custom_ops"]
    got = {name: r["flops_by_op"].get(name, 0) for name in want}
    emit({"phase": "dryrun_kernel_trace", "ops": ops, "flops": got,
          "formula": want})
    check(ops.get("repro_torch.flash_attention_fwd.default") == fwd_n and
          ops.get("repro_torch.flash_attention_bwd.default") == bwd_n,
          f"the traced train step holds kernel 10's operators {ops}, not "
          f"{fwd_n} forwards and {bwd_n} backwards")
    check(got == want, f"kernel 10's traced flops {got}, the formula's "
                       f"{want}")


def dryrun_phase(torch, np, measured: dict) -> dict:
    """The dry run and the roofline against the card.

    1. Every cell the script runs at full width, traced on ``"single"`` by
       the worker: its predicted peak beside the measured one
       (``measured``: (arch, shape) -> {"ms": median step, "peak": the
       step's own peak}), its roofline floor on one H100
       (``roofline.bound_s``) beside the measured step, and the eager
       operators' traffic time (``eager_traffic_ms``, an upper bound on a
       fused program's, gated by nothing).  No step may be faster than its
       floor, every prediction lies within
       DRY_PEAK_FACTOR of its reading, every cell run is predicted to fit
       the card and every GNN_NOT_RUN cell not to.
    2. gemma-2b's train cell traced with kernel 10 as its operators: the
       trace holds the forward 2 x layers x microbatches times (remat
       recomputes it) and the backward layers x microbatches times, and
       their flops are the formula's.  Nothing is launched.
    3. The two meerkat-graph cells run for real on the card through
       ``run_cell`` (the stacked four-shard plane): seconds, peak bytes,
       kernels 1, 2 and 3 launched.
    4. EquiformerV2 with its levers (``eq_lever_phase``)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import runtime
    from repro_torch.launch import dryrun, roofline

    t0 = time.perf_counter()
    recs = dryrun_records()
    waited = time.perf_counter() - t0
    total = torch.cuda.get_device_properties(0).total_memory
    cells = []
    for (arch, shape), m in measured.items():
        r = recs[(arch, shape)]
        pred = r["memory"]["peak_bytes"]
        bound = 1e3 * roofline.bound_s(r)
        row = {"arch": arch, "shape": shape, "predicted_peak": pred,
               "measured_peak": m["peak"], "peak_ratio": pred / m["peak"],
               "compute_ms": 1e3 * r["cost"]["flops"] / roofline.PEAK_FLOPS,
               "memory_ms": 1e3 * roofline.floor_bytes(r) / roofline.HBM_BW,
               "bound_ms": bound, "measured_ms": m["ms"],
               "bound_share": bound / m["ms"],
               "eager_traffic_ms": 1e3 * roofline.eager_traffic_s(r),
               "fits": pred <= total, "trace_s": r["wall_s"]}
        emit({"phase": "dryrun", **row})
        cells.append(row)
    for row in cells:
        what = f"{row['arch']} on {row['shape']}"
        check(row["measured_ms"] >= row["bound_ms"], f"{what}: measured "
              f"{row['measured_ms']} ms under its floor {row['bound_ms']}")
        check(1 / DRY_PEAK_FACTOR <= row["peak_ratio"] <= DRY_PEAK_FACTOR,
              f"{what}: predicted peak {row['predicted_peak']} against "
              f"{row['measured_peak']} measured")
        check(row["fits"], f"{what} ran, but its predicted peak "
              f"{row['predicted_peak']} exceeds the card's {total}")
    not_run = []
    for arch, shape in GNN_NOT_RUN:
        r = recs[(arch, shape)]
        not_run.append({"arch": arch, "shape": shape,
                        "predicted_peak": r["memory"]["peak_bytes"],
                        "fits": r["memory"]["peak_bytes"] <= total})
    emit({"phase": "gnn_not_run", "total_memory": total,
          "cells": not_run})
    for row in not_run:
        check(not row["fits"], f"{row['arch']} on {row['shape']} is not "
              f"run, but its predicted peak {row['predicted_peak']} fits")

    # 2. kernel 10's operators in gemma-2b's traced train step
    kernel_trace_check(recs[(TRAIN_ARCH, TRAIN_SHAPE)])

    # 3. the graph cells, run for real on the card
    graph = []
    for shape in get_arch("meerkat-graph").SHAPES:
        runtime.reset_launches()
        rec = dryrun.run_cell("meerkat-graph", shape, "single",
                              verbose=False)
        graph.append(rec)
        emit({"phase": "dryrun_graph", "shape": shape,
              "seconds": rec["seconds"], "memory": rec["memory"],
              "launches": rec["launches"], "result": rec["result"]})
        want_k = (("slab_probe", "slab_commit") if shape == "stream_10k"
                  else ("slab_sweep",))
        for name in want_k:
            check(rec["launches"].get(name, 0) > 0,
                  f"meerkat-graph {shape} never launched {name}")
    gc.collect()
    torch.cuda.empty_cache()

    # 4. EquiformerV2's levers
    eq = eq_lever_phase(torch, np,
                        measured[("equiformer-v2", "molecule")]["ms"])
    return {"cells": cells, "not_run": not_run, "graph": graph, "eq": eq,
            "worker_done_t_s": _DRY_WORKER["done_t_s"],
            "waited_s": waited}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    import repro_torch.stream as stream_mod
    from repro_torch.data import synth
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve as serve_mod

    t_start = time.perf_counter()
    card = gpu_line()
    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = runtime.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: round(v["seconds"], 3) for k, v in built.items()},
          "ptxas": {k: [ln.strip() for ln in v["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in built.items()}})
    print(card, flush=True)
    dev_name = torch.cuda.get_device_name(0)
    import tempfile
    dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    start_dryrun_worker(dry_dir)
    measured = {}

    # the graph phases draw one RMAT graph: draw it once
    synth.rmat_edges = drawn_once(synth.rmat_edges)

    # -------------------------------------------------------------- kernels
    t0 = time.perf_counter()
    got, _ = capture_serve_inputs(torch, np, serve_mod)
    for key in (("sum", False), ("min_plus", True), ("arg_min_plus", True)):
        check(key in got["sweep"], f"main path never swept {key}")
    check(len(got["probe"]) >= 2 and len(got["commit"]) >= 2,
          "main path should probe and commit its delete and insert batches")
    check("live" in got and "chain" in got,
          "main path should plan a compaction")
    results = compare_kernels(torch, got)
    del got
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})

    # ---------------------------------------------------------------- serve
    torch.cuda.reset_peak_memory_stats()
    boot = {}
    with keeping_boot(stream_mod, boot):
        runtime.reset_launches()
        out = serve_mod.main(SERVE_ARGS)
        torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    store = out["store"]
    last = store.last_maintenance
    emit({"phase": "serve", "boot_s": out["boot_s"],
          "serve_s": out["serve_s"], "generate_s": out["generate_s"],
          "latency": out["latency"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "pool": out["pool"], "kernels": launches,
          "maintenance": {"passes": store.maintenance_count,
                          "last": last.describe() if last else None,
                          "scan_s": last.scan_s if last else None,
                          "events": store.maintenance_events}})
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"{name} was never launched on the main path")
    check(store.maintenance_count >= 1,
          "the maintenance policy never compacted during the serve")
    per_kind = {}
    for kind, _, _, launched in out["responses"]:
        for name, n in launched.items():
            per_kind.setdefault(kind, {}).setdefault(name, []).append(n)
    emit({"phase": "serve", "launches_per_request": per_kind,
          "requests": [{"i": i, "kind": kind,
                        "ms": 1e3 * resp.latency_s, "launched": launched}
                       for i, (kind, _, resp, launched)
                       in enumerate(out["responses"])]})
    t0 = time.perf_counter()
    want = static_reference(torch, np, out)
    emit({"phase": "self_check", "static_reference_s":
          time.perf_counter() - t0, "pagerank_ref": want["pagerank_ref"]})
    t0 = time.perf_counter()
    emit({"phase": "self_check", **check_state(torch, np, out, want,
                                               "served"),
          "seconds": time.perf_counter() - t0})
    for line in check_maintenance(torch, np, out, want):
        emit({"phase": "self_check", **line})

    # ------------------------------------------------------------ iterators
    t0 = time.perf_counter()
    results += iterators_phase(torch, np, out, want)["results"]
    emit({"phase": "iterators", "seconds": time.perf_counter() - t0})

    # ----------------------------------------------------------------- mind
    t0 = time.perf_counter()
    mind_phase(torch, np, store.forward)
    emit({"phase": "mind", "seconds": time.perf_counter() - t0})
    # the GNN phase's minibatch_lg subgraph, sampled over the same view
    from repro_torch.configs.common import GNN_SHAPES
    sampled = sampled_minibatch(torch, np, store.forward,
                                GNN_SHAPES["minibatch_lg"])
    emit({"phase": "gnn_sample", **{k: v for k, v in sampled.items()
                                    if not isinstance(v, np.ndarray)}})
    updates = [req for kind, req, _, _ in out["responses"]
               if kind == "update"][:3]
    ref3 = served_reference(torch, np, out)
    del out, want, store, last
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- durability
    t0 = time.perf_counter()
    durability_phase(torch, np, boot, updates)
    for name in SERVE_KERNELS:
        check(runtime.LAUNCHES[name] > 0,
              f"{name} was never launched in the durability phase")
    emit({"phase": "durability", "seconds": time.perf_counter() - t0})
    del boot, updates
    gc.collect()
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- sharded
    import tempfile
    with tempfile.TemporaryDirectory() as mesh_dir:
        t0 = time.perf_counter()
        sharded = sharded_phase(torch, np, ref3, Path(mesh_dir))
        emit({"phase": "sharded", "seconds": time.perf_counter() - t0})
        del ref3
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------------------------------------- mesh
        t0 = time.perf_counter()
        mesh_phase(torch, np, sharded)
        emit({"phase": "mesh", "seconds": time.perf_counter() - t0})
        del sharded["mesh"]
        gc.collect()
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ triangles
    t0 = time.perf_counter()
    tri = triangles_phase(torch, np)
    results += tri["results"]
    launches.update({k: tri["launches"][k]
                     for k in ("slab_count", "probe_hits")})
    check(sharded["triangles"] == tri["static_count"],
          f"triangles_sharded counted {sharded['triangles']} on the booted "
          f"sharded view, the triangles phase {tri['static_count']}")
    emit({"phase": "triangles", "seconds": time.perf_counter() - t0})
    del tri
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------- lm
    t0 = time.perf_counter()
    lm = lm_phase(torch, np, built["flash_attention"],
                  built["flash_attention_bwd"])
    results += lm["results"]
    launches["flash_attention"] = lm["launches"]["flash_attention"]
    attn_layers = dict(lm["captured"])
    measured[("gemma2-9b", "prefill_32k")] = lm["dry"]
    emit({"phase": "lm", "seconds": time.perf_counter() - t0})
    del lm
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ moe
    t0 = time.perf_counter()
    moe = moe_phase(torch, np)
    results += moe["results"]
    launches["flash_attention"] += moe["launches"]["flash_attention"]
    attn_layers.update(moe["captured"])
    measured[(MOE_ARCH, "prefill_32k")] = moe["dry"]
    emit({"phase": "moe", "seconds": time.perf_counter() - t0})
    del moe
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- train
    t0 = time.perf_counter()
    train = train_phase(torch, np, attn_layers)
    results += train["results"]
    launches["flash_attention"] += train["launches"]["flash_attention"]
    launches["flash_attention_bwd"] = train["launches"]["flash_attention_bwd"]
    measured[(TRAIN_ARCH, TRAIN_SHAPE)] = train["dry"]
    measured[("mind", "train_batch")] = train["mind"]["dry"]
    emit({"phase": "train", "seconds": time.perf_counter() - t0})
    del train, attn_layers
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ gnn
    t0 = time.perf_counter()
    gnn = gnn_phase(torch, np, sampled)
    for row in gnn["runs"]:
        measured[(row["arch"], row["shape"])] = {
            "ms": statistics.median(row["step_ms"]),
            "peak": row["step_peak_bytes"]}
    emit({"phase": "gnn", "seconds": time.perf_counter() - t0})
    del sampled, gnn

    # -------------------------------------------------------- embedding_bag
    t0 = time.perf_counter()
    bag = embedding_bag_phase(torch, np)
    results += bag["results"]
    launches["embedding_bag"] = bag["launches"]
    emit({"phase": "embedding_bag", "seconds": time.perf_counter() - t0})

    # ------------------------------------------------------------- examples
    t0 = time.perf_counter()
    ex = examples_phase(torch, np)
    launches["flash_attention"] += ex["torch_train_lm"]["kernels"].get(
        "flash_attention", 0)
    launches["flash_attention_bwd"] += ex["torch_train_lm"]["kernels"].get(
        "flash_attention_bwd", 0)
    emit({"phase": "examples", "seconds": time.perf_counter() - t0})
    del ex

    # --------------------------------------------------------------- dryrun
    t0 = time.perf_counter()
    dry = dryrun_phase(torch, np, measured)
    import shutil
    shutil.rmtree(dry_dir, ignore_errors=True)
    emit({"phase": "dryrun", "seconds": time.perf_counter() - t0,
          "worker_done_t_s": dry["worker_done_t_s"],
          "waited_s": dry["waited_s"]})
    del dry

    # ------------------------------------------------------------- summary
    # kernel 4's op is not on the serve: its launches are those of its own
    # path in phase 2
    launches["slab_contrib_sums"] = next(
        r["launches"] for r in results if r["name"] == "slab_contrib_sums")
    batch = f"B={serve_mod.parse_args(SERVE_ARGS).batch}"
    main_variant = {"slab_probe": batch, "slab_commit": batch,
                    "slab_sweep": "sum (main path)",
                    "slab_contrib_sums": "PageRank contrib (transpose view)",
                    "slab_live": "forward view",
                    "slab_chain_rank": "forward view",
                    "slab_count": "static",
                    "probe_hits": next(r["variant"] for r in results
                                       if r["name"] == "probe_hits"),
                    "flash_attention": "global (layer 1)",
                    "flash_attention_bwd": "gemma-2b layer 0 bfloat16",
                    "embedding_bag": f"B={BAG_BATCHES[-1]} f32"}
    replaces = {
        "slab_probe": "src/repro/kernels/slab_update/kernel.py:81",
        "slab_commit": "src/repro/kernels/slab_update/kernel.py:160",
        "slab_sweep": "src/repro/kernels/slab_sweep/kernel.py:80",
        "slab_contrib_sums": "src/repro/kernels/slab_pagerank/kernel.py:23",
        "slab_live": "src/repro/kernels/slab_compact/kernel.py:60",
        "slab_chain_rank": "src/repro/kernels/slab_compact/kernel.py:137",
        "slab_count": "src/repro/kernels/slab_intersect/kernel.py:120",
        "probe_hits": "src/repro/kernels/slab_intersect/kernel.py:180",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:99",
        # kernel 10's gradient: the TPU kernel has no VJP
        "flash_attention_bwd":
            "src/repro/kernels/flash_attention/kernel.py:99",
        "embedding_bag": "src/repro/kernels/embedding_bag/kernel.py:29"}
    source = {"slab_probe": "src/repro_torch/csrc/slab_update.cu",
              "slab_commit": "src/repro_torch/csrc/slab_update.cu",
              "slab_sweep": "src/repro_torch/csrc/slab_sweep.cu",
              "slab_contrib_sums": "src/repro_torch/csrc/slab_pagerank.cu",
              "slab_live": "src/repro_torch/csrc/slab_compact.cu",
              "slab_chain_rank": "src/repro_torch/csrc/slab_compact.cu",
              "slab_count": "src/repro_torch/csrc/slab_intersect.cu",
              "probe_hits": "src/repro_torch/csrc/slab_intersect.cu",
              "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
              "flash_attention_bwd":
                  "src/repro_torch/csrc/flash_attention_bwd.cu",
              "embedding_bag": "src/repro_torch/csrc/embedding_bag.cu"}
    kernels = []
    for name in main_variant:
        rows = [r for r in results if r["name"] == name]
        main_row = next(r for r in rows if r["variant"] == main_variant[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-worker"]:
        sys.exit(dryrun_worker(sys.argv[2]))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)
    finally:
        stop_dryrun_worker()
