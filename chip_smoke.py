#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``quiver_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases:
1. set-up: the card's name and power limit, the build of the three
   kernel sources (one ``nvcc`` each, all at once; each timed, with one
   line per kernel of registers, stack frame and spills from ``nvcc
   -Xptxas -v``), a products-scale synthetic graph made on
   the card from a seed (2.45M nodes, lognormal degrees with median 25
   clipped to 10,000, about 100M edges) and 100-dim features,
   int8-quantized;
2. the fused kernels and the split walk's sampler against their plain
   PyTorch versions at the shapes the walks give them, requiring exact equality of every
   output, with the wrapper's and the plain version's times (CUDA events
   around the call), the kernel's own device time (the median of its
   ``torch.profiler`` kernel events over 20 launches) and the least
   time the card could take (bytes moved at 3.35 TB/s); the split walk's
   ``sample_layer_kernel`` is also held equal to ``fused_sample_hop``;
3. the served path: ``ServeEngine(fused_hot_hop=True)`` serving
   GraphSAGE 100 -> 256 -> 256 -> 47, fanout [15, 10, 5], batch 1024,
   random weights from a seed, on 16 batches; the launch counts prove
   the path ran through the fused kernels, and one batch is held
   against the plain walk within 1e-4 (``index_add_`` atomics sum in
   another order), its frontier rows bit for bit and the padding rows
   of ``x`` +0.0 by their bits;
4. the split walk (``fused_multihop_reference``: ``sample_layer_kernel``
   on every hop) on that batch: 3 launches, equal to the fused walk bit
   for bit, its logits within 1e-4 of the served ones, and both walks
   (and both leaf hops) timed; then ``gather_rows`` driven at the
   batch's valid frontier, equal to ``feat[ids]``, to
   ``torch.index_select`` (timed as the library's yardstick) and to the
   fused walk's rows, for fp32 and bf16 tables, with its own time;
5. training: ``build_train_step(fused_hot_hop=True)`` on the graph of
   phase 1 with ``examples/train_products_synthetic.py``'s data (labels
   from the seed, features ``centers[labels] + 0.5 * noise``, fp32),
   GraphSAGE 100 -> 256 -> 256 -> 47 with dropout 0.5, fanout
   [15, 10, 5], batch 1024, Adam lr 3e-3, one warm-up step and then 32
   steps on distinct batches, counted and timed:
   2 ``fused_sample_hop`` and 1 ``fused_hot_hop`` launches per step and
   no other kernel, every loss finite, the mean of the last 8 losses
   below 0.7 of the first 8's; step p50/p99, sampled edges and seeds
   per second, the device time per step and idle share over 4 more
   steps (``torch.profiler``) and its top kernels; then one step's loss
   and gradients through the kernel walk held against the plain walk
   (fp32 and int8 tables; loss within 1e-4, each gradient within 1e-4
   of its tensor's largest entry), and one step of the split route
   (``fused_hot_hop=False``) with a finite loss and no kernel launched;
6. tiered serving at full width: the tiered ``Feature`` store over the
   graph of phase 1 and 100-dim features from the seed, 25% of its rows
   (by degree) hot on the card as int8, the rest in pinned host memory
   as packed rows (``quant.pack``: codes, scale and zero in one
   128-byte row),
   ``dedup_cold=True`` (``examples/serve_sage.py``'s configuration),
   served by ``ServeEngine(fused_hot_hop=True)`` on 16 batches: p50/p99,
   device time and idle share per batch, launches per batch, and per
   batch (read after the timed run) the hot and cold frontier slots, the
   unique cold rows, the host rows the cold fixup reads and its branch
   (narrow, compacted or full). Checks: the tiered walk's ``x`` equal bit
   for bit to the same walk over one device table (both tiers
   concatenated) and its logits within 1e-4; the host-tier gather (int8
   and fp32, with and without ``out=`` and -1 ids) equal to its plain
   version at the batch's cold ids, with its times (the int8 and the
   fp32 kernel's own) against a bound from the measured pinned-to-device
   copy rate, and the own time of each of a served batch's three
   host-tier launches; a lookup at
   ``cold_budget=256`` (both fallbacks) equal to the one-table gather;
   the store's lookup free of host synchronisation (the registry's
   ``no_host_sync`` check on the card, ``op_lint.card_host_syncs``:
   ``torch.cuda.set_sync_debug_mode``); and finite logits from
   the split route over the store and from ``dedup_gather=True`` over a
   plain table, where ``gather_rows_q8_kernel`` (int8 codes with fp32
   scale and zero apart) launches: at that call, equal to its plain
   version, its own and wrapper time against ``index_select`` of the
   three leaves and the decode, and against its byte bound;
7. the sampler: ``GraphSageSampler`` over the graph of phase 1 (its
   tensors, not copied), fanout [15, 10, 5], batch 1024, eight arms:
   HBM (a) exact scattered, (b) exact wide (pair layout), (c) rotation
   pair+sort, (d) rotation overlap+sort, (e) rotation overlap+butterfly,
   (f) window pair+sort; HOST (g) exact wide, (h) rotation
   overlap+sort. Each arm: one reshuffle where the method has one
   (timed apart), a warm-up batch, then 32 timed batches, consecutive
   slices of one node permutation, with sampled edges per second
   (valid edges over the wall time, bench.py's metric), ms per batch and
   launches per batch printed on ``sampler:`` lines. Checks: (b) equal
   to (a), (g) to (b) and (h) to (d) bit for bit on every batch; the HBM
   arms launch no kernel of the port and the HOST arms the topology
   gathers; (b), (d), (f), (g) and (h) sample four more batches with no
   host synchronisation (``op_lint.card_host_syncs``); each arm's device time
   per batch and idle share come from ``torch.profiler`` over four
   batches; HOST mode's
   ``max_memory_allocated`` grows by less than the bytes of
   ``indices``; one ``with_eid`` batch of every arm whose edge ids are
   CSR slots of their targets holding their sources, ``min(deg, k)``
   edges per target, distinct within a hop; and the topology gathers
   (180,224 rows of the 128- and 256-wide int32 views, 901,120
   elements of ``indices``; pinned and device tables; -1 ids) equal to
   their plain versions, with own times against their bounds, host read
   requests per second and, for device tables, indexing as a yardstick;
   the HOST arms read each hop's indptr heads through the span gather
   (``gather_segments_kernel``, counted in ``ELEMS_LAUNCHES`` and under
   ``gather_elems``: one launch a hop) and their scattered picks
   through the flat form (``gather_elems_kernel``); the span gather
   at the 180,224-seed heads over the pinned int32 indptr and an int64
   copy (-1 seeds, a start at the table's end, a span past it) equal to
   its plain version and to the parent's flat form over ``[2, bs]``
   ids, both timed, with the 32-byte sectors it asks for;
8. weighted sampling and GAT (``examples/gat_weighted.py``'s
   configuration on the graph of phase 1): edge weights ``0.5 +
   deg[indices] / max(deg)`` made on the card; four weighted sampler
   arms at [15, 10, 5], batch 1024, on phase 7's batches (16 timed
   each): HBM (i) exact (the ``row_cap`` pool draw), (j) rotation
   overlap+sort (the windowed weighted draw); HOST (k) exact, (l)
   rotation overlap+sort (weights and weight rows pinned, read by
   ``gather_elems`` and ``gather_rows``), with the phase 7 line per arm,
   the peak allocated bytes over one batch, (k) = (i) and (l) = (j) bit
   for bit, the HBM arms launching no kernel of the port, HOST growth on
   the card below the weights' bytes, butterfly with weighted rotation
   refused, and one ``with_eid`` batch per arm over weights with 10% of
   the edges zeroed held to the contract (CSR slots of their targets,
   no pick of weight 0, ``min(deg, k)`` draws per target of positive
   mass); the HOST arms' weight reads (pinned fp32 elements at the hop-2
   pool through the flat form over the materialised ids and through the
   span gather, which (k) runs: 2 span launches a hop, the heads and the
   pool; pinned fp32 rows 128 and 256 wide) against their plain
   versions with own times, bounds and read requests per second; GAT
   (100 -> 4 x 64 -> 47, 2 layers, dropout 0, Adam 3e-3) trained 1 + 32
   steps at [10, 5] through ``GraphSageSampler(edge_weight=...,
   sampling="exact")``, the masked gather and
   ``build_split_train_step``'s ``step_fn``, then 1 + 32 with
   ``sampling="rotation"`` (labels: each node's most common neighbour
   class of phase 5's classes, since GAT has no self term; the loss
   must fall below the first 8's mean and below ln 47), step p50/p99,
   edges per second, device time and idle share; GAT through the fused
   walk (1 + 1 launches a step, loss and gradients within 1e-4 of the
   plain walk), served 4 batches by ``ServeEngine(fused_hot_hop=True)``
   (one within 1e-4 of the plain walk); one GraphSAGE step of
   ``build_train_step(method="rotation", indices_stride=128)`` over the
   reshuffled overlap view and one ``ServeEngine(method="rotation")``
   batch; one 1-step ``random_walk`` from 1024 starts held to its
   contract;
9. the device counters, rotation and ``ShardTensor`` (``metrics.py``):
   (a) a ``ServeEngine(collect_metrics=True)`` beside phase 6's over its
   store serves its 16 batches on its hop seeds: logits equal bit for bit
   (torch's deterministic algorithms on for that check, so the model's
   ``index_add_`` sums in one order), each batch's counters equal to
   phase 6's host reading, one batch under sync "error", host p50/p99
   and device time per batch metered and not, ``derive()``'s ratios;
   (b) phase 5's configuration, 8 steps metered and 8 not from copies of
   one state: losses and parameters equal bit for bit, the frontier fill
   of each step, then 4 timed steps each (``StepStats``, a ``MetricsSink``
   JSONL under ``build/`` read back with ``read_jsonl``, device time);
   (c) phase 7's arms (a) and (g), metered and not from one generator
   state: samples equal, frontier fill; (d) a full-width
   ``host_placement="numpy"`` int8 store (25% hot) under a fused engine:
   4,096 pairs rotated (the cold nodes phase 6's frontiers saw most, the
   hot ones they saw least), lookups at a served frontier and the
   engine's logits the same bits before, between the rotation and
   ``refresh_feature``, and after, both timed; (e) ``ShardTensor`` over
   100-dim features, 25% on the card and the rest pinned, fp32 then
   int8: a lookup at a served frontier equal to the plain version, one
   ``gather_rows`` launch, its own time against the copy-rate bound.
   Results on ``metrics``, ``rotation`` and ``shard_tensor`` lines;
10. the host side of training (``pipeline.py``, ``native/``,
   ``MixedGraphSageSampler``, ``inference.py``, ``checkpoint.py``):
   (a) ``examples/train_products_synthetic.py``'s tiered loop at phase
   5's configuration over phase 6's store (int8, 25% hot by degree,
   ``dedup_cold=True``, the cold tier packed and pinned):
   ``build_split_train_step``'s ``sample_fn`` for batch i+1 and
   ``feature.prefetch(n_id)`` (the lookup on the pipeline worker's own
   stream) while ``step_fn`` runs batch i, beside the same loop serial
   from a copy of the state: 8 steps of each under torch's deterministic
   algorithms with losses and parameters equal bit for bit, then 32
   timed steps of each in turns (serial, buffered, buffered, serial):
   step p50/p99 (host clock, ``float(loss)`` each step as the example
   does), sampled edges/s, 3 ``gather_rows`` launches a step, the loss
   falling (last-8 mean below 0.7 of the first-8), device ms and idle
   share over 4 more steps; one ``sample_ahead`` pass over an HBM
   ``GraphSageSampler`` equal to serial ``sample()`` calls; (b)
   ``GraphSageSampler(mode="CPU")`` (the native C++ engine, built by
   ``g++`` into ``build/quiver_tpu_torch/``) on the graph of phase 1
   copied to the host once: 16 batches at [15, 10, 5], batch 1024,
   SEPS, ms per batch and the engine's threads, every batch again with
   edge ids held to the contract, one hop of 1,024 seeds uniform and
   weighted equal to the plain numpy version bit for bit; (c)
   ``MixedGraphSageSampler`` over a job of 64 batches, the device side
   in HBM and then HOST mode (with edge ids): every batch once and held
   to the contract, the HOST side's topology gathers launched, each
   engine's share, SEPS and EMA times beside phase 7's arms; (d)
   ``layerwise_inference`` of (a)'s buffered model over all nodes
   (batch 4096, ``max_degree`` 256): seconds and windows per layer,
   4,096 nodes of every layer (the 64 largest degrees and isolated rows
   among them) within 1e-4 of a plain full-neighbourhood mean by
   ``index_add_`` over the CSR; (e) ``save_state``/``restore_state`` of
   (a)'s state under ``build/``, one more step from both equal bit for
   bit; (f) an injected ``"pipeline.worker"`` fault (``faults.py``): the
   worker dies before it claims the queued lookup, ``ensure_worker()``
   restarts it and ``Future.result()`` gives the rows; a failing lookup
   surfaces through ``Future.result()`` and ``pipelined``; closed, no
   worker thread is left. Results on ``pipeline``, ``cpu_sampler``,
   ``mixed``, ``inference`` and ``checkpoint`` lines;
11. the disk tier and the cold prefetch (``partition.py``, ``io.py``,
   ``prefetch.py``, ``Feature.set_mmap_file``): (a) phase 10 (a)'s
   features (``centers[labels] + 0.5 * noise``) in descending-degree
   storage order written by ``save_disk_tier(dtype_policy="int8")`` into
   a temporary directory (its file system printed from ``/proc/mounts``),
   ``load_disk_tier_store(hot_rows=`` a quarter of the nodes ``)`` and
   ``set_local_order`` (node ids in, as JAX's disk path takes them);
   a staging probe: the prefetcher with its default IO engine
   (``io_engine="auto"``), 2 workers and queue depth 16 staging the first
   50,000 unique cold rows of a batch's frontier (the frontier's density
   kept), timed, with the engine chosen, extents, coalescing factor,
   bytes, peak queue depth, and the card's sampler timed alone and while
   it runs; then phase 10 (a)'s split training loop (GraphSAGE 100 -> 256
   -> 256 -> 47, [15, 10, 5], batch 1024, Adam 3e-3, the masked lookup
   ``getitem_masked(n_id)``) in four arms of 4 warm-up steps (under
   torch's deterministic algorithms), 16 timed and 4 profiled steps: off
   (every cold row read from the file), on with decoded rows, on with
   packed int8 rows, and that again with ``evict_file_cache`` at the
   start of every step (whether it drops pages is timed first); the
   prefetch arms (a ring of 2^20 slots pinned, 2 workers, the
   mmap engine: the probe shows why) sample and publish batch i+1 before
   batch i's lookup, from the training thread. Each arm prints step
   p50/p99 and sampled edges/s beside phase 10 (a)'s serial step and
   phase 6's tiered batch, device time and idle share, and the ring's
   hit rate, sync, staged, dropped and truncated rows; every lookup
   equals the rows ``read_mmap`` decodes on the host, bit for bit, and
   the four arms' losses and parameters after the warm-up are equal bit
   for bit; the median staging task comes from ``pipeline.execute``
   spans; the ring
   gather (``gather_rows`` over the pinned ring, each layout) is held to
   its plain version at a step's slots, with its own time against its
   bound at phase 6's measured copy rate. Then the fence: a ring of 1.05x
   one batch's unique cold rows with the stager publishing batch i+1
   while the card reads batch i, 16 lookups equal to ``read_mmap``'s
   rows; and ``sample_ahead(..., feature=store)`` over an HBM
   ``GraphSageSampler``: batches equal to serial ``sample()``, lookups
   exact, ring hits. (b) the JAX package's synthetic cold dataset at its
   defaults (1,000,000 nodes, dim 128, avg_deg 15, hot_frac 0.05, int8,
   skew 2), generated and loaded by the port, 16 batches of 1024 at [15,
   10, 5] through ``sample_ahead`` with the prefetcher (mmap engine):
   hit rate, sync rows, every lookup equal to the same store without
   prefetch. Results
   on ``disk`` and ``cold dataset`` lines;
12. the request path (``MicroBatchServer`` and ``rpc.py``) over phase
   6's tiered store: ``ServeEngine(fused_hot_hop=True,
   collect_metrics=True)`` with phase 3's model and weights, the ladder
   [[15, 10, 5], [6, 4, 2]], ``batch_cap`` 1024, warmed up before any
   server starts; ``examples/serve_sage.py``'s server settings
   (``max_wait_ms`` 2, ``queue_depth`` 1024, ``slo_p99_ms`` 50,
   ``shed_queue_frac`` 0.25). (a) 2 x 1024 + 3 distinct ids and 64
   duplicates staged into a paused server (``max_wait_ms`` 250 and
   ``queue_depth`` 4,096, so they fit and the batches fill) through an
   engine that records each batch's hop
   seeds: 3 batches (1024, 1024, 3), 2 ``fused_sample_hop`` + 1
   ``fused_hot_hop`` + phase 6's host-tier ``gather_rows`` launches per
   server batch, every future's row within 1e-4 of its batch replayed;
   (b) the example's open-loop Poisson trace (2,000 requests/s for 3 s,
   one client thread, ids uniform) with the ``serve.*`` spans on:
   per-request p50/p99 beside phase 6's bare tiered batch, batches, fill,
   variant mix, rejections, ``health()``, the SLO block, the spans'
   p50/p99 against ``max_wait_ms``, the engine's bare batch per variant,
   device ms and idle share over 4 blocks of 1,024 requests on a fresh
   server at full quality (no SLO target, no queue trigger), and the
   readback's time; (c) 4,096 requests at once into a server with no
   SLO target, twice, the second time with the fill cap at 256:
   ``OverloadError`` at the door, every admitted future resolved, a shed batch in the capped
   burst, the ladder back at 0 after ``calm_batches`` calm ones; (d)
   tenancy
   (``default_tenant_classes(50.0)``): a best_effort flood from one
   thread and an interactive trickle from another, no interactive
   request rejected or displaced, the classes' counts adding to the
   server's; (e) ``RpcServer`` on 127.0.0.1 and an ``RpcClient``: 256
   lookups one at a time (finite ``[47]`` rows, round-trip p50/p99), a 1
   ms budget back as ``DeadlineExceeded``, then 64 traced lookups: each
   client's trace id among the replica's ``serve.*`` spans, the round
   trip by span; (f) a ``serve.execute`` fault fails
   exactly its batch and the next serves; a ``serve.coalesce`` fault
   breaks the server (queued futures and ``submit`` get
   ``ServerClosed``). Results on ``server`` lines;
13. heterogeneous graphs at MAG240M's widths (``hetero.py``,
   ``hetero_feature.py``, ``models/rgcn.py``, ``models/mag.py``; the
   OGB-LSC MAG240M R-GNN baseline's widths: 768-wide features, 153
   classes, hidden 1024, sizes [25, 15] per relation, batch 1024, dropout
   0.5, lr 0.001), cut in node counts only: ``tests/test_mag240m_scale.py``'s
   typed graph from seed 0 (2,000,000 papers citing about 20 papers,
   600,000 authors writing about 3 papers each, 30,000 institutions
   employing about 2 authors each), ``examples/hetero_rgcn.py``'s
   features (noise, papers shifted by twice their class centre) made on
   the card, its stores: papers int8 with a quarter of the rows hot by
   cites degree and the rest pinned as 896-byte packed rows
   (``host_placement="offload"``, ``dedup_cold=True``, ``cold_budget``
   500,000, above a step's 425,984 paper slots), authors and
   institutions fp32 on the card; the host's resident memory before,
   at its peak during and after the build. (a) R-GCN through
   ``HeteroGraphSageSampler`` (exact, ``frontier_cap={"inst": 30000}``)
   and ``HeteroFeature.lookup``, the step inline as the example writes
   it, one warm-up step then 32 timed: one ``gather_rows`` launch a
   step and no other kernel of the port, the loss falling (last-8 mean
   below the first-8's), step p50/p99, sampled edges/s, device ms and
   idle share over 4 more steps, top kernels; on one more batch the
   frontier capacities (26,624 / 25,600 after hop 0; 425,984 / 424,960 /
   30,000 after hop 1), the paper lookup's counters (no dedup overflow,
   cold rows within the budget), the institution cap masking no edge,
   and ``sample()`` and ``lookup()`` under sync "error"; then the row
   gather at D=768 at that frontier's cold ids (the step's form with -1
   where hot and ``out=``, dense, and an fp32 pinned table) equal to its
   plain version bit for bit, wrapper, own, back-to-back (10 calls
   between two events, where the profiler drops events) and plain ms
   against the bound at the measured copy rate; (b) the lookup through the kernel
   against the lookup through the gather's plain version bit for bit,
   and one step from the same parameters on each under torch's
   deterministic algorithms (loss within 1e-4, gradients within 1e-4 of
   their largest entry); (c) rotation overlap+butterfly and window
   pair+sort, reshuffle times and 8 batches each, edges/s, the contract
   on every batch (each edge's ``e_id`` a slot of its target holding
   its source, ``min(deg, k)`` edges per target at distinct slots,
   frontiers distinct and prefixed); (d) exponential weights on cites
   with ``with_eid`` (``examples/hetero_rgcn.py --weighted``), 8 steps,
   the edge-id contract on every step's sample; (e) ``MAG240MGNN``
   graphsage and gat (4 heads) over paper-cites-paper through
   ``GraphSageSampler`` and the paper store, 8 steps each, one
   ``gather_rows`` a step; (f) ``HeteroFeature.prefetch`` of two
   frontiers equal to ``lookup`` bit for bit, staged on its own stream
   without a host synchronisation. Results on ``hetero`` lines;
14. the partitioned store across ranks (``DistFeature``, the
   ``all_to_all`` exchange of ``comm.py``) on the graph of phase 1 with
   phase 5's data as an int8 table: (a) world size 1 over NCCL in this
   process: ``ShardedServeEngine(fused_hot_hop=True)`` over
   ``DistFeature.from_partition`` serving 16 batches (p50/p99, device
   time and idle share, 3 ``fused_sample_hop`` and 2 ``gather_rows``
   launches a batch and no other, host synchronisations counted by
   ``op_lint.card_host_syncs``, the dense lookup held to none),
   its logits equal to the single-store fused ``ServeEngine``'s bit for
   bit on every batch and its frontier rows to the fused walk's; the
   exchange's two ``gather_rows`` launches (the owner's read of raw
   packed rows, the unbucket with the int8 decode) against their plain
   versions, with own times, bounds and ``index_select``; three metered
   arms (dense, ``exchange_cap=True``, the cap planned by
   ``plan_exchange_cap`` from the dup factor the second arm measures):
   p50/p99 and the ``EXCH_*`` and dedup counters; then 32 steps each of
   ``build_dist_train_step`` and ``build_e2e_train_step(fused_hot_hop=
   True)`` (step p50/p99, edges/s, the loss falling, launches per step);
   (b) 4 ranks over gloo sharing the card (``RankPool``, below),
   the rows partitioned by ``partition_feature_without_replication``
   over ``sample_prob`` of four train sets: every rank's logits on 2
   batches of a dense and a planned-cap arm equal to (a)'s single-store
   logits bit for bit, and one dist step's loss equal to the
   data-parallel step's on every rank. Results on ``sharded`` lines;
15. one process over a clique (``Feature(cache_policy=
   "p2p_clique_replicate")`` over a mesh of 4 entries of this card, so
   4 blocks, each its own allocation, read by one ``gather_rows_sharded``
   launch as peers would be) on the graph of phase 1 with phase 5's
   data: the kernel at a served frontier (1,081,344 ids; fp32, bf16 and
   packed int8 blocks; the lookup's form and the ``out=`` form with -1
   slots) bit for bit against its plain version, with own, wrapper and
   plain times, ``index_select`` over the concatenated table and the
   bound; (a) ``ServeEngine`` over an fp32 store held whole by the
   clique and an int8 store half hot (packed blocks) and half cold
   (pinned, packed), fused and split routes, 16 batches each: p50/p99,
   device time and idle share, launches a batch, host synchronisations
   (0), logits equal to the ``device_replicate`` store's engine bit for
   bit; (b) 32 steps of ``build_train_step(fused_hot_hop=True)`` over
   the int8 clique store (loss falling) and one step's loss and
   gradients equal to the replicate store's on both routes; (c) the TP
   step (``build_gspmd_train_step``) at full width: world size 1 over
   NCCL (mesh 1 x 1) for 32 steps with a falling loss, then 4 gloo ranks
   sharing the card (mesh 2 x 2) whose 2 steps equal the world-1 run's:
   in fp64 their losses, gradients and parameters within 1e-5, in fp32
   the losses and the first step within 1e-5, the second step's
   gradients within 1e-2 and its parameters within 1e-4 of the exact
   run (world size 1 in fp64); (d) a spawned worker
   opening the int8 clique store through ``share_ipc``, its lookups of
   16 served frontiers equal to the parent's, its allocated device
   memory below the hot tier's size; (e) ``ShardTensor`` with two device
   groups and a pinned host group read by one launch; (f) ``Topo`` and
   ``init_p2p`` over the cards there are. Results on ``clique`` lines;
   (c) also prints each ``data`` rank's frontier rows and sampled edges a
   step beside world size 1's: each rank walks its half of the seeds
   (draws keyed by node id and hop), so each is smaller;
16. the serving fleet's control plane at phase 12's width, ``phase 16:
   N s``: (a) 3 replica processes on this card (``python3 chip_smoke.py
   --replica``: ``fleet_world``, the graph and an int8 offload store
   from the seed, served by ``MicroBatchServer`` with a
   ``TelemetryHub``, the default tenant classes and a ``TailSampler``,
   behind ``RpcServer``, each with its own ``MetricsSink``) under a
   ``ReplicaSupervisor``; this process runs ``FleetAggregator`` ->
   ``HealthRouter`` -> ``RpcClient`` and a ``FleetExporter``, and
   replays ``traffic.generate_scenario("flash_crowd")`` for 10 s at a
   base of 400 requests/s (what one client process offers in pace; the
   offered rate is printed beside the trace's), with phase 12's lookup
   budget and SLO, while a seeded ``FaultPlan`` kills ``r0`` after its
   400th request: every request resolves with a row or a typed
   rejection, ``r0`` goes stale, is drained, restarted and re-admitted
   in that order, each replica replays answers of its own batches with
   their hop seeds (within 1e-4) and reports its launches per server
   batch (2 ``fused_sample_hop``, 1 ``fused_hot_hop``, the cold fixup's
   ``gather_rows``), ``/metrics`` and ``/healthz`` answer, and a kept
   trace joins the client's ``rpc.*`` and a replica's ``serve.*``
   spans. The replicas share one card: no speed across cards is
   measured; (b) two numpy-placement int8 stores replay one
   ``generate_drifting_trace`` ABBA per window, the adaptive arm's
   ``Actuator`` rotating through its live server's engine: hit rates
   before and after the drift, rotations, served p99; the rotated store
   equal to one built with its hot set bit for bit, a knob swap inside
   the lattice applied and one outside refused (WARN), the fake-clock
   ``FleetAutoscaler`` trajectory; (c) the dispatch p50 of full
   batches, the served batch's bytes and phase 2's gather rate into
   ``capacity.predict``, at most 4 steady replays searching the
   sustained rate, ``capacity.verdict`` (printed, not gated); (d) 64
   metered batches recorded by ``TelemetryHub.observe_counters`` under
   sync "error", its totals after ``flush`` equal to
   ``metrics.reduce_counters``, cold-only lookups firing an ``anomaly``,
   ``replan``'s advice and a ``FlightRecorder`` dump; (e) after (c),
   over the fleet's own sinks, the operator CLIs as a user runs them
   (``python -m quiver_tpu_torch.scripts.<name>``, one process each):
   ``qt_agg --once`` over the three replica sinks (one row a replica,
   each in the health band of (a)'s last ``/healthz``) and ``--smoke``,
   ``qt_top --once`` over a replica sink (serving series, the SLO and
   tenant lines) and ``--fleet`` over the aggregator's sink (the fleet
   line, a row a replica, ``r0``'s staleness), ``qt_trace`` (the table,
   ``--slowest 5``, ``--errors``, ``--trace-id`` of (a)'s joined trace
   and ``--export``: a process track a segment) against a
   ``TraceStore`` over the same files, ``qt_capacity`` over (c)'s
   record and ``--predict`` from the replicas' ``serving`` records with
   the probe on the card: each exits 0, its wall seconds printed, the
   predicted rate beside (a)'s sustained one. Results on ``fleet``
   lines;
17. profiling and the analysis contracts, ``profile (a)``..``(e)`` lines
   and ``phase 17: N s``: (a) ``machine_probe()`` on the card (copy,
   random-gather, pinned h2d and d2h rates) beside phase 6's h2d rate;
   (b) ``analysis.registry.run_registry()`` over its nine entries on the
   card: no ERROR, each spec's host synchronisations by the op recorder
   equal to the card's sync debug mode's and to its declared count (the
   compact exchange's one), the fused kernels launched by ``train_step``,
   ``serve_step``, ``fused_multihop`` and ``fused_hot_hop`` and
   ``gather_rows`` by ``lookup_tiered`` and ``dist_lookup``, and a
   second pass that loads no kernel library; (c) ``StageProfiler`` at
   full width (phase 1's graph, an int8 offload store a quarter hot,
   GraphSAGE 100 -> 256 -> 256 -> 47): the served batch and the train
   pipeline's ``sample``, ``gather``, ``step``, ``fused_hop`` and
   ``fused_multihop`` stages, best and mean of 5 CUDA-event timings,
   modeled bytes and FLOPs (the leaf hop's equal to ``hot_hop_cost``'s),
   shares of the probe's peak and of the 3.35 TB/s bound, fed to a
   ``TelemetryHub`` whose ``stage_share:*`` watch arms on every stage;
   (d) ``host_lint`` over ``quiver_tpu_torch/``: only its documented
   deviations; (e) ``profiling.trace`` around two served batches: the
   Chrome trace holds the scope and the three kernels' device events;
18. the leak check (``quiver_tpu_torch.check_leak``): its 16 phases
   in-process on the card at full width (phase 1's graph, phase 5's
   data, GraphSAGE 100 -> 256 -> 256 -> 47, [15, 10, 5] at batch 1024,
   phase 12's ladder over the int8 store a quarter hot; lookups of
   65,536 ids; phases 4 and 14 on two gloo ranks sharing the card),
   only the cycle counts cut (16 a loop). One ``leak phase N`` line a
   phase: the base and the end of every reading (live blocks, requested
   bytes, allocator segments, kernel libraries, RSS), the launches per
   unit of work by kernel, the phase's facts and the card's line; then
   ``phase 18: N s`` with each phase's seconds. Any growth fails the
   run; the counts, set to 0 before it, must show every kernel of the
   path launched (``fused_sample_hop``, ``fused_hot_hop``,
   ``sample_layer``, ``gather_rows``);
19. a JSON line of the five kernels (``ms`` the wrapper's time, ``own_ms``
   the kernel's own, ``launches_per_train_step`` from phase 5,
   ``launches_per_tiered_batch`` from phase 6, and for ``gather_rows``
   its host-tier variant under ``host_tier``, with the fp32 host tier
   under ``fp32`` and the served launches' own times under
   ``served_launch_own_ms``, and the topology variants of phase 7 under
   ``host_topology``, and the weight reads of phase 8 under
   ``host_weights``, and the ``ShardTensor`` host read under
   ``shard_tensor``, and ``launches_per_buffered_step`` from phase 10
   (a) with the mixed sampler's HOST launches under
   ``mixed_host_launches``, and the disk tier's ring gather under
   ``disk_ring``, and ``launches_per_server_batch`` from phase 12 (a),
   and ``launches_per_hetero_step`` from phase 13 (a) with the D=768
   gather under ``hetero``, and ``launches_per_sharded_batch``,
   ``launches_per_dist_step`` and ``launches_per_e2e_step`` from phase
   14 (a) with the exchange's gathers under ``exchange``, and
   ``launches_per_clique_batch``/``launches_per_clique_step`` from
   phase 15 (a) and (b), with ``gather_rows_sharded``'s variants and its
   ``ShardTensor`` reads (phases 9 and 15) under it; the HBM design of
   the packed int8 gather under ``packed_hbm`` of each of the two
   (``gather_rows_packed_hbm_kernel``: the exchange's unbucket, its
   launches in phase 14 (a) and the dist step;
   ``gather_rows_sharded_packed_hbm_kernel``: the clique's int8 hot
   tier, its launches in phase 15 (a) and (b)), every phase having
   checked which packed kernel ran (the HBM design on the card, the
   host design on pinned rows: phases 6, 9, 11, 14 and 15); the raw-row
   designs where the main paths launch them under ``raw_designs`` of
   ``gather_rows`` (``gather_rows_kernel``, the loop design: the HOST
   sampler's pinned rows views; ``gather_rows_tile_kernel``, the tile
   design: the exchange's owner read) and ``kernel`` on each of the two,
   every phase that reads raw rows having checked and printed which
   raw-row kernel ran (``gather.raw_design``: the tile design on the
   card, the loop design on pinned rows: phases 4, 6, 7, 8, 9, 11, 13,
   14 and 15);
   the arms' records under ``sampler``, phase 8's under ``weighted``,
   phase 9's under ``metrics``, ``rotation`` and ``shard_tensor``,
   phase 10's under ``host_side``, phase 11's under ``disk_tier``,
   phase 12's under ``server``, phase 13's under ``hetero``, phase 14's
   under ``sharded``, phase 15's under ``clique``, phase 16's under
   ``fleet`` and each kernel's ``launches_per_fleet_batch``, over the
   replicas' server batches, phase 17's under ``profile`` and each
   kernel's ``launches_registry_pass``, phase 18's under ``leak`` and
   each kernel's ``launches_leak_check`` and ``launches_per_leak_cycle``,
   by leak phase and unit), the script's total
   seconds, the card's line, then the
   last line ``{"ok": true,
   "device": {...}}``.

Any failure exits non-zero without that last line; with no CUDA device
the script exits 2 at once. TF32 is switched off for matrix products and
cuDNN, so the model runs in full fp32.
"""

from __future__ import annotations

import asyncio
import copy
import json
import logging
import math
import os
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import NamedTuple

# the byte counts of the kernels' bounds, shared with the profiler's
# roofline (quiver_tpu_torch/analysis/costmodel.py)
from quiver_tpu_torch.analysis.costmodel import (gather_rows_bytes,
                                                 hot_hop_cost,
                                                 sample_hop_bytes,
                                                 served_batch_bytes)
# what counts as a host synchronisation on the card: one implementation,
# the registry's no_host_sync rule's
from quiver_tpu_torch.analysis.op_lint import card_host_syncs

SEED = 0
NODES = 2_450_000
MEDIAN_DEG = 25
MAX_DEG = 10_000
DIM, HIDDEN, CLASSES = 100, 256, 47
SIZES = [15, 10, 5]
BATCH = 1024
ROW_CAP = 2048
BATCHES = 16
HBM_BYTES_PER_S = 3.35e12      # H100 SXM
FP32_OPS_PER_S = 67e12         # H100 SXM, outside the tensor cores
CSRC = "quiver_tpu_torch/csrc/"
SOURCES = {"fused_sample_hop": CSRC + "fused_hop.cu",
           "fused_hot_hop": CSRC + "fused_hop.cu",
           "sample_layer": CSRC + "sample_kernel.cu",
           "gather_rows": CSRC + "gather.cu",
           "gather_rows_sharded": CSRC + "gather.cu"}
# gather_rows_sharded: JAX's quant.gather_rows over a row-sharded array,
# which XLA partitions (no pallas_call of its own)
REPLACES = {"fused_sample_hop": "quiver_tpu/ops/pallas/fused.py:513",
            "fused_hot_hop": "quiver_tpu/ops/pallas/fused.py:411",
            "sample_layer": "quiver_tpu/ops/pallas/sample_kernel.py:174",
            "gather_rows": "quiver_tpu/ops/pallas/gather.py:92",
            "gather_rows_sharded": "quiver_tpu/feature.py:383"}
SPLIT_HOP_SEEDS = [12345, -67890, 2**31 - 7]
TRAIN_STEPS = 32
LR = 3e-3
DROPOUT = 0.5
LOSS_TOL = 1e-4
GRAD_TOL = 1e-4                # of the largest |gradient| of each tensor
COPY_BYTES = 256 * 2**20       # the pinned-to-device copy that sets the rate
FP32_HOST_ROWS = 2**18         # the fp32 host table of the gather check
SAMPLER_BATCHES = 32           # timed batches of each sampler arm


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Median device time of ``fn`` over ``iters`` runs, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def own_ms(fn, kernel: str, iters: int):
    """Median device duration of the ``torch.profiler`` CUDA kernel
    events whose name holds ``kernel`` over ``iters`` calls of ``fn``:
    the kernel's own time, without the wrapper's allocations, launch
    and tensor ops. The profiler drops a kernel event now and then (18 of
    20 in one run, none in others), so a window short of events is
    profiled once more; None when the second one is short too."""
    for _ in range(2):
        durs = kernel_events(lambda: [fn() for _ in range(iters)], kernel,
                             warmup=fn)
        if 4 * len(durs) >= 3 * iters:
            durs = sorted(durs)
            return durs[len(durs) // 2]
        print(f"profile: {len(durs)} events of {kernel} in {iters} calls",
              flush=True)
    return None


def kernel_events(run, kernel: str, warmup=None):
    """The durations in ms, in launch order, of the ``torch.profiler``
    CUDA kernel events whose name holds ``kernel`` during one call of
    ``run`` (after one call of ``warmup``, unprofiled). The window opens
    and closes with the card idle and 50 ms of host time, so no launch
    sits on its edge."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warmup is not None:
        warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        run()
        torch.cuda.synchronize()
        time.sleep(0.05)
    seen: dict = {}
    hits = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        seen[e.name] = seen.get(e.name, 0) + 1
        if kernel in e.name:
            hits.append((e.time_range.start, e.time_range.elapsed_us() / 1e3))
    if not hits:
        print(f"profile: no event of {kernel}; device events seen: "
              + "; ".join(f"{n} x{c}" for n, c in seen.items())[:600],
              flush=True)
    return [ms for _, ms in sorted(hits)]


def burst_ms(fn, iters: int) -> float:
    """Device time per call of ``fn`` over ``iters`` calls issued back to
    back between two CUDA events (after one warm-up call): for a ``fn``
    that launches one kernel and nothing else, that kernel's time with
    the card kept busy, where the profiler's events are missing."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_own_ms(run, kernel: str, units: int):
    """The own time of each launch of ``kernel`` within one unit (a
    batch) of ``run``, which runs ``units`` of them: the median, across
    units, of the kernel's ``torch.profiler`` events at that position.
    None when the events do not split evenly into units."""
    durs = kernel_events(run, kernel)
    if not durs or len(durs) % units:
        return None
    per = len(durs) // units
    return [sorted(durs[i::per])[units // 2] for i in range(per)]


def made(counts: dict, **want) -> dict:
    """The launches by kernel in ``counts`` (``kernels.PACKED_LAUNCHES``:
    the packed int8 gathers' HBM and host designs; ``RAW_LAUNCHES``: the
    raw-row gathers' tile and loop designs) since the last
    ``reset_launches()``, checked to equal ``want`` (kernel name: count;
    every kernel not named: 0)."""
    got = dict(counts)
    check(got == {k: want.get(k, 0) for k in got},
          f"gather launches by kernel {nonzero(got)}, expected {want}")
    return got


def made_once(counts: dict, run, kernel: str, what: str) -> None:
    """``run()``, checked to launch ``kernel`` of ``counts`` at least once
    and no other kernel counted there."""
    before = dict(counts)
    run()
    got = nonzero({k: v - before[k] for k, v in counts.items()})
    check(set(got) == {kernel},
          f"{what}: gather launches by kernel {got}, expected {kernel}")


class KernelArgs:
    """An op recorder (``_build._RECORDER``) that runs each kernel
    wrapper as it is and keeps the arguments of the calls that
    ``keep(name, args)`` accepts."""

    def __init__(self, keep):
        self.keep = keep
        self.calls = []

    def kernel_call(self, name, fn, args, kwargs):
        if self.keep(name, args):
            self.calls.append((args, kwargs))
        return fn(*args, **kwargs)


def separate_sidecars(feat) -> bool:
    """An int8 table whose codes, scale and zero are tensors apart: what
    ``gather_rows`` reads with ``gather_rows_q8_kernel``."""
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import gather
    if not quant.is_quantized(feat) or quant.is_sharded(feat):
        return False
    _, scale, _, stride = gather._leaves(feat)
    return scale is not None and stride is None


def q8_gather_times(call, iters, card) -> dict:
    """``gather_rows_q8_kernel`` at one of its main-path calls, with its
    arguments (the ``out=`` form included): own and wrapper ms against
    the plain version, the library's form (``index_select`` of codes,
    scale and zero at the live ids, then the decode) and the bound of
    ``costmodel.gather_rows_bytes`` at 3.35 TB/s."""
    from quiver_tpu_torch.ops.kernels import gather
    args, kwargs = call
    tab, ids = args[0], args[1]
    out = kwargs.get("out", args[2] if len(args) > 2 else None)
    scratch = None if out is None else out.clone()
    run = lambda: gather.gather_rows(tab, ids, out)               # noqa: E731
    plain = lambda: gather.gather_rows_plain(tab, ids, scratch)   # noqa: E731
    live = ids >= 0
    idx = ids[live].long()

    def library():
        return tab.data.index_select(0, idx).to(tab.scale.dtype) \
            * tab.scale.index_select(0, idx) + tab.zero.index_select(0, idx)
    got, want = run(), plain()
    check(same_bits(got, want) and same_bits(library(), want[live]),
          "gather_rows_q8_kernel or index_select + decode differs from the "
          "plain version at phase 6's check 5")
    table_bytes, dev_bytes, distinct = gather_rows_bytes(tab, ids)
    b_ms = (table_bytes + dev_bytes) / HBM_BYTES_PER_S * 1e3
    rec = {"ids": int(ids.shape[0]), "live": int(idx.shape[0]),
           "distinct": distinct, "dim": int(tab.data.shape[1]),
           "on_card": bool(tab.data.is_cuda), "out": out is not None,
           "max_abs_err": 0.0, "ms": cuda_ms(run, iters),
           "own_ms": own_ms(run, "gather_rows_q8_kernel", iters),
           "plain_ms": cuda_ms(plain, 3), "bound_ms": b_ms,
           "bound_by": "bytes", "library_ms": cuda_ms(library, iters),
           "kernel": "gather_rows_q8_kernel"}
    share = "" if rec["own_ms"] is None else \
        f" (bound / own {b_ms / rec['own_ms']:.0%})"
    print(f"tiered check 5: gather_rows_q8_kernel at {rec['ids']} ids "
          f"({rec['live']} live, {distinct} distinct"
          f"{', out=' if rec['out'] else ''}) x {rec['dim']} int8 "
          f"with fp32 sidecars, table on the "
          f"{'card' if rec['on_card'] else 'host'}: own "
          f"{fmt_ms(rec['own_ms'])}{share}, wrapper {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms, index_select + decode "
          f"{rec['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
          f"({table_bytes + dev_bytes} B at 3.35 TB/s); equal to its plain "
          f"version; on {card}", flush=True)
    return rec


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def add_ms(a, b):
    return None if a is None or b is None else a + b


def ptxas_kernels(log: str):
    """``(name, registers, stack frame, spill stores, spill loads)`` of
    every kernel in one ``nvcc -Xptxas -v`` log."""
    out, name, frame = [], None, (0, 0, 0)
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for", 1)[1].strip()
        elif "bytes stack frame" in ln:
            frame = tuple(int(w) for w in ln.split() if w.isdigit())[:3]
        elif "Used" in ln and "registers" in ln and name is not None:
            regs = int(ln.split("Used", 1)[1].split()[0])
            out.append((name, regs) + frame)
            name, frame = None, (0, 0, 0)
    return out


def make_graph(dev, gen, nodes):
    import torch
    ln = torch.randn(nodes, generator=gen, device=dev) + math.log(MEDIAN_DEG)
    deg = torch.exp(ln).to(torch.int32).clamp_(0, MAX_DEG)
    indptr = torch.zeros(nodes + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(deg, 0)
    edges = int(indptr[-1])
    check(edges < 2**31, "edge count exceeds int32")
    indices = torch.randint(0, nodes, (edges,), generator=gen, device=dev,
                            dtype=torch.int32)
    return indptr.to(torch.int32), indices, deg


def make_seeds(dev, gen, nodes, bs, deg):
    """``bs`` distinct ids with the rows the kernel must get right: the
    highest-degree rows (above row_cap), isolated rows and -1 seeds."""
    import torch
    seeds = torch.randperm(nodes, generator=gen, device=dev)[:bs]
    top = torch.argsort(deg, descending=True)[:8]
    zero = torch.nonzero(deg == 0)[:4, 0]
    seeds = seeds[~torch.isin(seeds, torch.cat([top, zero]))][:bs - 12]
    seeds = torch.cat([top, zero, seeds]).to(torch.int32)
    seeds[20::97] = -1
    return seeds.contiguous()


def same_bits(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))
    return torch.equal(a, b)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def h2d_rate(dev):
    """The pinned-to-device copy rate in bytes/s (one ``copy_`` of
    ``COPY_BYTES``, median of 5) and that copy's ms."""
    import torch
    src = torch.empty(COPY_BYTES, dtype=torch.uint8).pin_memory()
    dst = torch.empty(COPY_BYTES, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), 5)
    return COPY_BYTES / (ms / 1e3), ms


def host_gather_bound(tab, ids, h2d):
    """``(bound ms, by what, host bytes, device bytes, distinct rows)``
    of a host-tier gather: the bytes of ``costmodel.gather_rows_bytes``
    (each distinct row's data bytes, not a packed row's padding, read
    once at the copy rate ``h2d``; or the ids read and the fp32 rows
    written at 3.35 TB/s), whichever takes longer. Negative ids read
    nothing."""
    host_bytes, dev_bytes, distinct = gather_rows_bytes(tab, ids)
    b_host = host_bytes / h2d * 1e3
    b_dev = dev_bytes / HBM_BYTES_PER_S * 1e3
    if b_host >= b_dev:
        return b_host, "bytes (host)", host_bytes, dev_bytes, distinct
    return b_dev, "bytes (device)", host_bytes, dev_bytes, distinct


def phase_kernels(dev, gen, nodes, indptr, indices, deg, feats, forder,
                  iters):
    """The fused kernels and the split walk's sampler against their
    plain versions at the shapes the walks give them."""
    from quiver_tpu_torch.ops.kernels import fused, sample_kernel
    results = {}
    shapes = [BATCH]
    for k in SIZES:
        shapes.append(shapes[-1] * (1 + k))
    # interior hops: hop 0 (1,024 seeds x 15) and hop 1 (16,384 x 10)
    rec = {"ms": 0.0, "own_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "err": 0.0}
    for hop in range(len(SIZES) - 1):
        bs, k = shapes[hop], SIZES[hop]
        seeds = make_seeds(dev, gen, nodes, bs, deg)
        hs = 1000 + hop
        got = fused.fused_sample_hop(indptr, indices, seeds, k, hs, ROW_CAP)
        want = fused.sample_hop_plain(indptr, indices, seeds, k, hs, ROW_CAP)
        for g, w, name in zip(got, want, ("nbrs", "counts")):
            check(same_bits(g, w), f"fused_sample_hop hop {hop}: {name} "
                  "differs from the plain version")
        check(int(got[1].max()) == k, "no seed reached the fanout")
        ms = cuda_ms(lambda: fused.fused_sample_hop(
            indptr, indices, seeds, k, hs, ROW_CAP), iters)
        own = own_ms(lambda: fused.fused_sample_hop(
            indptr, indices, seeds, k, hs, ROW_CAP),
            "fused_sample_hop_kernel", iters)
        plain_ms = cuda_ms(lambda: fused.sample_hop_plain(
            indptr, indices, seeds, k, hs, ROW_CAP), 3)
        nbytes = sample_hop_bytes(seeds, k, got[1])
        b_ms, _ = bound(nbytes, 0)
        print(f"fused_sample_hop hop{hop} bs={bs} k={k}: wrapper {ms:.4f} "
              f"ms, kernel own {fmt_ms(own)}, plain {plain_ms:.4f} ms, "
              f"moves {nbytes} B, bound {b_ms:.4f} ms, exact", flush=True)
        rec["ms"] += ms
        rec["own_ms"] = add_ms(rec["own_ms"], own)
        rec["plain_ms"] += plain_ms
        rec["bound_ms"] += b_ms
        rec["err"] = max(rec["err"], max_abs(got[0], want[0]))
    results["fused_sample_hop"] = rec

    # the leaf hop (180,224 seeds x 5) over every table variant; the
    # int8 table without an order is the served one and gives the times
    bs, k = shapes[-2], SIZES[-1]
    seeds = make_seeds(dev, gen, nodes, bs, deg)
    hot_rows = (nodes * 3) // 4
    err = 0.0
    for name, feat in feats.items():
        for fo in (None, forder):
            hr = None if fo is None else hot_rows
            got = fused.fused_hot_hop(indptr, indices, seeds, feat, k, 77,
                                      ROW_CAP, fo, hr)
            want = fused.hot_hop_plain(indptr, indices, seeds, feat, k, 77,
                                       ROW_CAP, fo, hr)
            for g, w, out in zip(got, want, ("nbrs", "counts", "seed_rows",
                                            "pick_rows")):
                check(same_bits(g, w), f"fused_hot_hop {name} forder="
                      f"{fo is not None}: {out} differs from the plain "
                      "version")
                err = max(err, max_abs(g, w))
            tag = f"{name}{'+forder' if fo is not None else ''}"
            ms = cuda_ms(lambda: fused.fused_hot_hop(
                indptr, indices, seeds, feat, k, 77, ROW_CAP, fo, hr), iters)
            own = own_ms(lambda: fused.fused_hot_hop(
                indptr, indices, seeds, feat, k, 77, ROW_CAP, fo, hr),
                "fused_hot_hop_kernel", iters)
            plain_ms = cuda_ms(lambda: fused.hot_hop_plain(
                indptr, indices, seeds, feat, k, 77, ROW_CAP, fo, hr), 3)
            nbytes, ops = hot_hop_cost(seeds, k, got[1], got[0], feat, fo,
                                       hot_rows)
            b_ms, b_by = bound(nbytes, ops)
            share = "" if own is None else f" (bound / own {b_ms / own:.0%})"
            print(f"fused_hot_hop leaf {tag} bs={bs} k={k} "
                  f"({fused.hot_hop_vec(feat, got[2], got[3])}-value "
                  f"words): wrapper {ms:.4f} ms, kernel own {fmt_ms(own)}"
                  f"{share}, plain {plain_ms:.4f} ms, moves {nbytes} B, "
                  f"bound {b_ms:.4f} ms ({b_by}), exact", flush=True)
            if name == "int8" and fo is None:
                results["fused_hot_hop"] = {
                    "ms": ms, "own_ms": own, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by}
    results["fused_hot_hop"]["err"] = err

    # the split walk's sampler on all three hops, against its plain
    # version and against the fused sampler on the same seeds and seed
    rec = {"ms": 0.0, "own_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "err": 0.0}
    for hop, k in enumerate(SIZES):
        bs = shapes[hop]
        seeds = make_seeds(dev, gen, nodes, bs, deg)
        hs = 2000 + hop
        args = (indptr, indices, seeds, k, hs, ROW_CAP)
        got = sample_kernel.sample_layer_kernel(*args)
        want = sample_kernel.sample_layer_plain(*args)
        hop_out = fused.fused_sample_hop(*args)
        for g, w, h, name in zip(got, want, hop_out, ("nbrs", "counts")):
            check(same_bits(g, w), f"sample_layer_kernel hop {hop}: {name} "
                  "differs from the plain version")
            check(same_bits(g, h), f"sample_layer_kernel hop {hop}: {name} "
                  "differs from fused_sample_hop")
        check(int(got[1].max()) == k, "no seed reached the fanout")
        ms = cuda_ms(lambda: sample_kernel.sample_layer_kernel(*args), iters)
        own = own_ms(lambda: sample_kernel.sample_layer_kernel(*args),
                     "sample_layer_kernel", iters)
        plain_ms = cuda_ms(lambda: sample_kernel.sample_layer_plain(*args),
                           3)
        nbytes = sample_hop_bytes(seeds, k, got[1])
        b_ms, _ = bound(nbytes, 0)
        edges = int(got[1].long().sum())
        print(f"sample_layer_kernel hop{hop} bs={bs} k={k}: wrapper "
              f"{ms:.4f} ms, kernel own {fmt_ms(own)}, plain "
              f"{plain_ms:.4f} ms, moves {nbytes} B, bound {b_ms:.4f} ms, "
              f"{edges} edges = {edges / ms * 1e3:.4g} sampled edges/s "
              "through the wrapper, exact, equal to fused_sample_hop",
              flush=True)
        rec["ms"] += ms
        rec["own_ms"] = add_ms(rec["own_ms"], own)
        rec["plain_ms"] += plain_ms
        rec["bound_ms"] += b_ms
        rec["err"] = max(rec["err"], max_abs(got[0], want[0]))
    results["sample_layer"] = rec
    return results


def phase_slice(dev, gen, nodes, indptr, indices, featq, batches):
    """Serve full-width batches through the kernels; return the engine,
    the requests, the logits of the batch held against the plain walk,
    the latencies and the launch counts of the served run."""
    import torch
    from quiver_tpu_torch import CSRTopo, GraphSAGE, ServeEngine
    from quiver_tpu_torch.models.convert import (flax_to_state_dict,
                                                 random_flax_params)
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.ops.kernels import fused
    from quiver_tpu_torch.parallel import layers_to_adjs

    topo = CSRTopo(indptr=indptr, indices=indices, device=dev)
    model = GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES))
    params = flax_to_state_dict(
        random_flax_params(DIM, HIDDEN, CLASSES, len(SIZES), seed=SEED))
    eng = ServeEngine(model, params, topo, featq, [SIZES], BATCH,
                      fused_hot_hop=True, fused_row_cap=ROW_CAP, seed=SEED,
                      device=dev).warmup()
    requests = [torch.randperm(nodes, generator=gen, device=dev)[:BATCH]
                for _ in range(batches)]
    torch.cuda.synchronize()

    kernels.reset_launches()
    lat, outs = [], []
    for ids in requests:
        t0 = time.perf_counter()
        outs.append(eng.run(ids))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)

    for o in outs:
        check(tuple(o.shape) == (BATCH, CLASSES), "logits shape")
        check(bool(torch.isfinite(o).all()), "non-finite logits")
    check(launches["fused_sample_hop"] == (len(SIZES) - 1) * batches,
          f"fused_sample_hop launches {launches}")
    check(launches["fused_hot_hop"] == batches,
          f"fused_hot_hop launches {launches}")
    check(launches["sample_layer"] == launches["gather_rows"]
          == launches["gather_elems"] == 0,
          f"the served path launched split-walk kernels: {launches}")

    # one batch against the plain walk with the same hop seeds
    hs = SPLIT_HOP_SEEDS
    seeds = eng.pad_seeds(requests[0])
    got = eng.run(requests[0], hop_seeds=hs)
    n_id, layers, x = fused.fused_multihop(
        eng._indptr, eng._indices, seeds, eng._feat, SIZES, hs, ROW_CAP)
    rn, rl, rx = fused.multihop_plain(
        eng._indptr, eng._indices, seeds, eng._feat, SIZES, hs, ROW_CAP)
    check(torch.equal(n_id, rn), "frontier differs from the plain walk")
    for a, b in zip(layers, rl):
        check(torch.equal(a.row, b.row) and torch.equal(a.col, b.col),
              "layer COO differs from the plain walk")
    valid = n_id >= 0
    check(same_bits(x[valid], rx[valid]), "frontier rows differ")
    check(not x[~valid].view(torch.int32).any(),
          "padding rows of x are not +0.0")
    with torch.inference_mode():
        want = eng.model(rx, layers_to_adjs(rl, BATCH, SIZES))[:BATCH]
    err = max_abs(got, want)
    check(torch.allclose(got, want, atol=1e-4, rtol=1e-4),
          f"logits differ from the plain path by {err}")
    frontier = int(valid.sum())
    print(f"slice: frontier {frontier} of {n_id.shape[0]} slots, logits "
          f"max |kernel - plain| = {err:.3g} (tolerance 1e-4)", flush=True)
    breakdown(eng, requests, x, layers)
    return eng, requests, got, lat, launches


def phase_split(eng, requests, served, feat, iters):
    """The split walk and the row gather on one served batch: each path
    driven with the launch counts set to 0 just before it and read just
    after; every output held against the fused walk's."""
    import torch
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.ops.kernels import fused, gather
    from quiver_tpu_torch.parallel import layers_to_adjs

    hs = SPLIT_HOP_SEEDS
    seeds = eng.pad_seeds(requests[0])
    walk = (eng._indptr, eng._indices, seeds, eng._feat, SIZES, hs, ROW_CAP)
    torch.cuda.synchronize()
    kernels.reset_launches()
    sn, sl, sx = fused.fused_multihop_reference(*walk)
    torch.cuda.synchronize()
    split_launches = dict(kernels.LAUNCHES)
    check(split_launches == {"fused_sample_hop": 0, "fused_hot_hop": 0,
                             "sample_layer": len(SIZES), "gather_rows": 0,
                             "gather_elems": 0, "gather_rows_sharded": 0},
          f"split walk launches {split_launches}")

    n_id, layers, x = fused.fused_multihop(*walk)
    check(torch.equal(n_id, sn), "split walk: frontier differs from the "
          "fused walk")
    for a, b in zip(layers, sl):
        check(torch.equal(a.row, b.row) and torch.equal(a.col, b.col),
              "split walk: layer COO differs from the fused walk")
    valid = n_id >= 0
    check(same_bits(x[valid], sx[valid]), "split walk: frontier rows "
          "differ from the fused walk")
    with torch.inference_mode():
        logits = eng.model(sx, layers_to_adjs(sl, BATCH, SIZES))[:BATCH]
    err = max_abs(served, logits)
    check(torch.allclose(served, logits, atol=1e-4, rtol=1e-4),
          f"split walk logits differ from the served ones by {err}")
    print(f"split walk: 3 sample_layer launches, n_id, layer COOs and "
          f"{int(valid.sum())} frontier rows equal to the fused walk bit "
          f"for bit, logits max |split - served| = {err:.3g} (tolerance "
          "1e-4)", flush=True)

    # the card's counterparts of bench.py's fused-against-split figures
    split_ms = cuda_ms(lambda: fused.fused_multihop_reference(*walk), 10)
    fused_ms = cuda_ms(lambda: fused.fused_multihop(*walk), 10)
    leaf = (eng._indptr, eng._indices, layers[-2].n_id, eng._feat,
            SIZES[-1], hs[-1], ROW_CAP)
    got = fused.fused_hot_hop(*leaf)
    want = fused.fused_hot_hop_reference(*leaf)
    for g, w, name in zip(got, want, ("nbrs", "counts", "seed_rows",
                                      "pick_rows")):
        check(same_bits(g, w), f"fused_hot_hop: {name} differs from the "
              "split hop")
    hot_split_ms = cuda_ms(lambda: fused.fused_hot_hop_reference(*leaf), 10)
    hot_fused_ms = cuda_ms(lambda: fused.fused_hot_hop(*leaf), 10)
    print(f"split vs fused walk: {split_ms:.4f} ms vs {fused_ms:.4f} ms, "
          f"fused_multihop_vs_split {split_ms / fused_ms:.3f}x; leaf hop "
          f"bs={leaf[2].shape[0]} k={SIZES[-1]}: split {hot_split_ms:.4f} "
          f"ms vs fused {hot_fused_ms:.4f} ms, fused_vs_split "
          f"{hot_split_ms / hot_fused_ms:.3f}x (CUDA events, median of 10)",
          flush=True)

    # gather_rows at the batch's valid frontier, fp32 table (no order)
    _, _, xf = fused.fused_multihop(eng._indptr, eng._indices, seeds, feat,
                                    SIZES, hs, ROW_CAP)
    ids = n_id[valid]
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = gather.gather_rows(feat, ids)
    torch.cuda.synchronize()
    gather_launches = dict(kernels.LAUNCHES)
    check(gather_launches == {"fused_sample_hop": 0, "fused_hot_hop": 0,
                              "sample_layer": 0, "gather_rows": 1,
                              "gather_elems": 0, "gather_rows_sharded": 0},
          f"gather path launches {gather_launches}")
    check(same_bits(out, xf[valid]), "gather_rows differs from the fused "
          "walk's rows")
    rec = None
    for name, table in (("fp32", feat), ("bf16", feat.to(torch.bfloat16))):
        got = gather.gather_rows(table, ids)
        want = gather.gather_rows_plain(table, ids)
        lib = torch.index_select(table, 0, ids)
        check(same_bits(got, want), f"gather_rows {name}: differs from "
              "feat[ids]")
        check(same_bits(got, lib), f"gather_rows {name}: differs from "
              "index_select")
        design, words, kname = gather.raw_launch(table, got)
        made_once(kernels.RAW_LAUNCHES,
                  lambda: gather.gather_rows(table, ids), kname,
                  f"gather_rows {name}")
        ms = cuda_ms(lambda: gather.gather_rows(table, ids), iters)
        own = own_ms(lambda: gather.gather_rows(table, ids), kname, iters)
        plain_ms = cuda_ms(lambda: gather.gather_rows_plain(table, ids), 3)
        lib_ms = cuda_ms(lambda: torch.index_select(table, 0, ids), iters)
        nbytes = ids.shape[0] * (4 + 2 * table.shape[1]
                                 * table.element_size())
        b_ms, _ = bound(nbytes, 0)
        print(f"gather_rows {name} ids={ids.shape[0]} D={table.shape[1]} "
              f"({design} design, {kname}, {words}-byte words): wrapper "
              f"{ms:.4f} ms, kernel own {fmt_ms(own)}, plain "
              f"{plain_ms:.4f} ms, index_select "
              f"{lib_ms:.4f} ms, moves {nbytes} B, bound {b_ms:.4f} ms, "
              "exact", flush=True)
        if rec is None:
            rec = {"ms": ms, "own_ms": own, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "library_ms": lib_ms,
                   "err": max_abs(got, want), "kernel": kname}
    launches = {"sample_layer": split_launches["sample_layer"],
                "gather_rows": gather_launches["gather_rows"]}
    return rec, launches


def make_train_data(dev, gen, nodes):
    """``examples/train_products_synthetic.py``'s data on the card:
    labels from the seed, features ``centers[labels] + 0.5 * noise``."""
    import torch
    labels = torch.randint(0, CLASSES, (nodes,), generator=gen, device=dev,
                           dtype=torch.int32)
    centers = torch.randn(CLASSES, DIM, generator=gen, device=dev)
    feat = centers[labels.long()] + 0.5 * torch.randn(
        nodes, DIM, generator=gen, device=dev)
    return feat, labels


def new_trainer(model, fused_hot_hop=True):
    """``model``'s train state with a fresh Adam (``optax.adam(LR)``'s
    counterpart) and a train step for it."""
    import torch
    from quiver_tpu_torch.parallel import build_train_step, init_state
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    step = build_train_step(model, opt, SIZES, BATCH,
                            fused_hot_hop=fused_hot_hop,
                            fused_row_cap=ROW_CAP)
    return init_state(model, opt), step


def grads_of(model, loss_fn):
    """The loss and every parameter's gradient of ``loss_fn(model)``."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def check_walks_agree(model, table, name, indptr, indices, seeds, labels,
                      hop_seeds, dropout_seed, sizes=SIZES):
    """One train step's loss and gradients from the same parameters,
    hop seeds and dropout seed, once through the kernel walk (the step's
    own loss) and once through the plain walk: equal frontier and COOs,
    the loss within ``LOSS_TOL``, each gradient within ``GRAD_TOL`` of
    its tensor's largest entry. Both steps run under torch's
    deterministic algorithms: with atomics, ``index_add_`` and the
    backward of ``x_src[s]`` sum in another order on each run, and that
    noise alone reached 2.2e-4 of a gradient's largest entry on the
    card (int8, one run in about twenty)."""
    import torch
    from quiver_tpu_torch.ops.kernels import fused
    from quiver_tpu_torch.parallel import layers_to_adjs, train
    _, layers = train._fused_multihop_x(table, None, indptr, indices, seeds,
                                        sizes, hop_seeds, ROW_CAP)
    rn, rl, rx = fused.multihop_plain(indptr, indices, seeds, table, sizes,
                                      hop_seeds, ROW_CAP)
    check(torch.equal(layers[-1].n_id, rn), f"train {name}: frontier differs "
          "from the plain walk")
    for a, b in zip(layers, rl):
        check(torch.equal(a.row, b.row) and torch.equal(a.col, b.col),
              f"train {name}: layer COO differs from the plain walk")
    with deterministic():
        loss_k, grads_k = grads_of(copy.deepcopy(model), lambda m: (
            train._fused_loss(m, sizes, BATCH, table, None, indptr,
                              indices, seeds, labels, hop_seeds,
                              dropout_seed, fused={"row_cap": ROW_CAP})))
        loss_p, grads_p = grads_of(copy.deepcopy(model), lambda m: (
            train._model_loss(m, rx, layers_to_adjs(rl, BATCH, sizes),
                              labels, BATCH, dropout_seed)))
    check(math.isfinite(loss_k) and abs(loss_k - loss_p) <= LOSS_TOL,
          f"train {name}: loss {loss_k} against the plain walk's {loss_p}")
    worst = 0.0
    for n, g in grads_k.items():
        rel = max_abs(g, grads_p[n]) / max(float(grads_p[n].abs().max()),
                                           1e-30)
        check(rel <= GRAD_TOL, f"train {name}: gradient {n} differs from the "
              f"plain walk's by {rel:.3g} of its largest entry")
        worst = max(worst, rel)
    print(f"train {name}: kernel walk against plain walk: n_id and "
          f"{len(layers)} COOs equal, loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(|diff| {abs(loss_k - loss_p):.3g}, tolerance {LOSS_TOL}), "
          f"{len(grads_k)} gradients within {worst:.3g} of their largest "
          f"entry (tolerance {GRAD_TOL})", flush=True)


def phase_train(dev, gen, nodes, indptr, indices, card):
    """Train GraphSAGE at full width through the fused walk: launch
    counts per step, the loss falling, step times, device time, sampled
    edges per second; then the kernel walk held against the plain walk
    (fp32 and int8 tables) and one step of the split route. Returns the
    launches of the timed steps."""
    import torch
    from quiver_tpu_torch import GraphSAGE
    from quiver_tpu_torch.models.convert import (flax_to_state_dict,
                                                 random_flax_params)
    from quiver_tpu_torch.ops import kernels, quant
    from quiver_tpu_torch.parallel import draw_step_seeds, train

    feat, labels = make_train_data(dev, gen, nodes)
    model = GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES), dropout=DROPOUT)
    model.load_state_dict(flax_to_state_dict(
        random_flax_params(DIM, HIDDEN, CLASSES, len(SIZES), seed=SEED)))
    state, step = new_trainer(model.to(dev))
    order = torch.randperm(nodes, generator=gen, device=dev).to(torch.int32)
    # batch 0 warms the step up (the first backward's GEMM set-up, Adam's
    # moments), the next TRAIN_STEPS are counted and timed, 4 more are
    # profiled and the last one feeds the checks
    timed = range(1, 1 + TRAIN_STEPS)
    batches = [order[i * BATCH:(i + 1) * BATCH].contiguous()
               for i in range(TRAIN_STEPS + 6)]
    ys = [labels[b.long()] for b in batches]
    host = torch.Generator().manual_seed(SEED)
    rand = [draw_step_seeds(host, len(SIZES)) for _ in batches]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, warm_loss = step(state, feat, None, indptr, indices, batches[0],
                            ys[0], *rand[0])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3

    kernels.reset_launches()
    lat, losses = [], []
    for i in timed:
        t0 = time.perf_counter()
        state, loss = step(state, feat, None, indptr, indices, batches[i],
                           ys[i], *rand[i])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = dict(kernels.LAUNCHES)
    losses = torch.stack(losses).tolist()
    check(state.step == 1 + TRAIN_STEPS, "step count")
    check(launches == {"fused_sample_hop": (len(SIZES) - 1) * TRAIN_STEPS,
                       "fused_hot_hop": TRAIN_STEPS, "sample_layer": 0,
                       "gather_rows": 0, "gather_elems": 0,
                       "gather_rows_sharded": 0},
          f"train step launches {launches}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    check(last < 0.7 * first, f"loss did not fall: first 8 mean {first}, "
          f"last 8 mean {last}")

    edges = 0
    for i in timed:
        _, layers = train._fused_multihop_x(feat, None, indptr, indices,
                                            batches[i], SIZES, rand[i][0],
                                            ROW_CAP)
        edges += sum(int(lay.edge_count) for lay in layers)
    wall_s = sum(lat) / 1e3
    srt = sorted(lat)
    p50 = srt[len(srt) // 2]
    p99 = srt[min(len(srt) - 1, math.ceil(0.99 * len(srt)) - 1)]
    print(f"train: {TRAIN_STEPS} steps of {BATCH} seeds, fanout {SIZES}, "
          f"GraphSAGE {DIM}->{HIDDEN}->{HIDDEN}->{CLASSES}, dropout "
          f"{DROPOUT}, Adam lr {LR}, fp32 features, on {card}", flush=True)
    print(f"train: step p50 {p50:.3f} ms p99 {p99:.3f} ms (host clock + "
          f"synchronize; the warm-up step before them {warm_ms:.3f} ms), "
          f"{edges} sampled edges = "
          f"{edges / wall_s:.6g} sampled edges/s, "
          f"{TRAIN_STEPS * BATCH / wall_s:.6g} seeds/s, on {card}",
          flush=True)
    print(f"train: loss of the warm-up step {float(warm_loss):.4f}; then "
          f"first {losses[0]:.4f} last {losses[-1]:.4f}; mean "
          f"of the first 8 {first:.4f}, of the last 8 {last:.4f}; every "
          f"loss: {' '.join(f'{v:.4f}' for v in losses)}; on {card}",
          flush=True)
    print(f"train: launches per step: fused_sample_hop "
          f"{launches['fused_sample_hop'] / TRAIN_STEPS:g}, fused_hot_hop "
          f"{launches['fused_hot_hop'] / TRAIN_STEPS:g}, sample_layer 0, "
          "gather_rows 0", flush=True)

    def four_steps():
        nonlocal state
        for i in range(1 + TRAIN_STEPS, 5 + TRAIN_STEPS):
            state, _ = step(state, feat, None, indptr, indices, batches[i],
                            ys[i], *rand[i])
    busy = device_profile(four_steps, 4, "step")
    print(f"train: device time per step {fmt_ms(busy)} on {card}",
          flush=True)

    last_batch = (batches[-1], ys[-1], *rand[-1])
    for name, table in (("fp32", feat), ("int8", quant.quantize(feat,
                                                                "int8"))):
        check_walks_agree(state.model, table, name, indptr, indices,
                          *last_batch)

    split_state, split_step = new_trainer(copy.deepcopy(state.model),
                                          fused_hot_hop=False)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, loss = split_step(split_state, feat, None, indptr, indices,
                         *last_batch)
    split_loss = float(loss)
    split_ms = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(split_loss), f"split route loss {split_loss}")
    check(not any(kernels.LAUNCHES.values()),
          f"the split route launched kernels: {kernels.LAUNCHES}")
    print(f"train split route (exact sampler, masked gather): one step "
          f"{split_ms:.3f} ms (host clock, first call), loss "
          f"{split_loss:.4f}, no kernel launched, on {card}", flush=True)
    return launches


def tiered_stats(eng, store, requests, hop_seeds):
    """Per served batch, replayed with its hop seeds after the timed run:
    the frontier's hot and cold valid slots, its unique cold rows, and
    the branch of the store's lookup in the cold fixup with the host rows
    that branch reads (the dedup table's live rows when narrow; the cold
    slots when compacted, and when the raw cold count overflows too)."""
    import torch
    from quiver_tpu_torch.feature import _resolve_cold_budget
    from quiver_tpu_torch.ops.kernels import fused
    forder, hot = store.feature_order, store.cache_rows
    out = []
    for ids, hs in zip(requests, hop_seeds):
        n_id, _, _ = fused.fused_multihop(
            eng._indptr, eng._indices, eng.pad_seeds(ids), store.device_part,
            SIZES, hs, ROW_CAP, forder, hot)
        valid = n_id >= 0
        t = forder.long()[n_id.long().clamp(min=0)]
        is_cold = valid & (t >= hot)
        n_cold = int(is_cold.sum())
        n_uniq = int(torch.unique(t[is_cold]).numel())
        budget = _resolve_cold_budget(store.dedup_cold, store.cold_budget,
                                      n_id.shape[0])
        if n_uniq <= budget:
            branch, rows = "narrow", n_uniq
        elif n_cold <= budget:
            branch, rows = "compacted", n_cold
        else:
            branch, rows = "full", n_cold
        out.append({"hot": int(valid.sum()) - n_cold, "cold": n_cold,
                    "unique_cold": n_uniq, "budget": budget,
                    "branch": branch, "host_rows": rows})
    return out


def phase_tiered(dev, gen, nodes, indptr, indices, card, batches, iters):
    """Serve full-width batches from the tiered store (hot tier on the
    card, cold tier pinned in host memory) through the cold fixup, and
    hold the path, the host-tier gather and the store's lookup to their
    references. Returns the host-tier gather's record and the launches
    of the served run."""
    import torch
    from quiver_tpu_torch import CSRTopo, Feature, GraphSAGE, ServeEngine
    from quiver_tpu_torch import serving
    from quiver_tpu_torch.models.convert import (flax_to_state_dict,
                                                 random_flax_params)
    from quiver_tpu_torch.ops import kernels, quant
    from quiver_tpu_torch.ops.kernels import fused, gather
    from quiver_tpu_torch.parallel import layers_to_adjs, masked_feature_gather

    t0 = time.perf_counter()
    feat = torch.randn(nodes, DIM, generator=gen, device=dev).cpu()
    topo = CSRTopo(indptr=indptr, indices=indices, device=dev)
    store = Feature(
        device_cache_size=(nodes // 4) * quant.row_bytes(DIM, "int8"),
        csr_topo=topo, dedup_cold=True, dtype_policy="int8",
        host_placement="offload", device=dev).from_cpu_tensor(feat)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    del feat
    cold = store._host_offload
    check(store.host_part is None and all(t.is_pinned() for t in cold),
          "the cold tier is not in pinned host memory")
    stride = quant.packed_stride(DIM)
    check(cold.data.stride(0) == stride and cold.scale.data_ptr()
          == cold.data.data_ptr() + quant.sidecar_offset(DIM),
          "the cold tier is not packed")
    hot_rows, cold_rows = store.cache_rows, quant.tier_rows(cold)
    rb = quant.row_read_bytes(cold)
    print(f"tiered: store of {nodes} rows x {DIM} int8 (+ fp32 scale and "
          f"zero): {hot_rows} hot rows on the card ({hot_rows * rb} B), "
          f"{cold_rows} cold rows in pinned host memory ({cold_rows * rb} "
          f"B of data in packed {stride}-byte rows: {cold_rows * stride} "
          f"B), dedup_cold=True; built in {setup_s:.2f} s (degree order, "
          "int8 quantization on the host, packing and pinning)",
          flush=True)

    model = GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES))
    params = flax_to_state_dict(
        random_flax_params(DIM, HIDDEN, CLASSES, len(SIZES), seed=SEED))
    eng = ServeEngine(model, params, topo, store, [SIZES], BATCH,
                      fused_hot_hop=True, fused_row_cap=ROW_CAP, seed=SEED,
                      device=dev).warmup()
    requests = [torch.randperm(nodes, generator=gen, device=dev)[:BATCH]
                for _ in range(batches)]
    hop_seeds = [eng.draw_hop_seeds(len(SIZES)) for _ in requests]
    torch.cuda.synchronize()

    kernels.reset_launches()
    lat, outs = [], []
    for ids, hs in zip(requests, hop_seeds):
        t0 = time.perf_counter()
        outs.append(eng.run(ids, hop_seeds=hs))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)
    for o in outs:
        check(tuple(o.shape) == (BATCH, CLASSES), "tiered logits shape")
        check(bool(torch.isfinite(o).all()), "non-finite tiered logits")
    check(launches["fused_sample_hop"] == (len(SIZES) - 1) * batches
          and launches["fused_hot_hop"] == batches
          and launches["sample_layer"] == launches["gather_elems"] == 0
          and launches["gather_rows"] >= batches,
          f"tiered serving launches {launches}")
    # the pinned cold tier: the host design's kernel, every launch
    made(kernels.PACKED_LAUNCHES,
         gather_rows_packed_kernel=launches["gather_rows"])
    srt = sorted(lat)
    p50 = srt[len(srt) // 2]
    p99 = srt[min(len(srt) - 1, math.ceil(0.99 * len(srt)) - 1)]
    print(f"tiered: {batches} batches of {BATCH}, per-batch latency p50 "
          f"{p50:.3f} ms p99 {p99:.3f} ms on {card}", flush=True)
    print(f"tiered: launches per batch: fused_sample_hop "
          f"{launches['fused_sample_hop'] / batches:g}, fused_hot_hop "
          f"{launches['fused_hot_hop'] / batches:g}, gather_rows (host "
          f"tier, gather_rows_packed_kernel) "
          f"{launches['gather_rows'] / batches:g}, sample_layer 0",
          flush=True)
    device_profile(lambda: [eng.run(ids, hop_seeds=hs) for ids, hs in
                            zip(requests[:4], hop_seeds[:4])], 4,
                   "tiered batch")

    stats = tiered_stats(eng, store, requests, hop_seeds)
    for i, s in enumerate(stats):
        print(f"tiered batch {i}: hot slots {s['hot']}, cold slots "
              f"{s['cold']}, unique cold rows {s['unique_cold']}, budget "
              f"{s['budget']}, branch {s['branch']}, host rows read "
              f"{s['host_rows']} ({s['host_rows'] * rb} B)", flush=True)
    mean = {k: sum(s[k] for s in stats) / len(stats)
            for k in ("hot", "cold", "unique_cold", "host_rows")}
    mix = {b: sum(s["branch"] == b for s in stats)
           for b in ("narrow", "compacted", "full")}
    print(f"tiered: per batch mean hot slots {mean['hot']:.1f}, cold slots "
          f"{mean['cold']:.1f}, unique cold rows {mean['unique_cold']:.1f}, "
          f"host rows {mean['host_rows']:.1f} = "
          f"{mean['host_rows'] * rb:.0f} B; branch mix {mix}", flush=True)

    # 1. the tiered walk against the same walk over one device table
    table = quant.QuantizedTensor(*(torch.cat([h, c.to(dev)]) for h, c in
                                    zip(store.device_part, cold)))
    forder = store.feature_order
    hs = hop_seeds[0]
    seeds = eng.pad_seeds(requests[0])
    feat_args, _, store_gather = serving._feature_gather(store)
    n_id, layers, x = fused.fused_multihop(
        eng._indptr, eng._indices, seeds, store.device_part, SIZES, hs,
        ROW_CAP, forder, hot_rows)
    x = serving._cold_fixup(store_gather, feat_args, forder, n_id, x,
                            hot_rows)
    rn, rl, rx = fused.fused_multihop(eng._indptr, eng._indices, seeds,
                                      table, SIZES, hs, ROW_CAP, forder)
    check(torch.equal(n_id, rn), "tiered: frontier differs from the "
          "one-table walk")
    for a, b in zip(layers, rl):
        check(torch.equal(a.row, b.row) and torch.equal(a.col, b.col),
              "tiered: layer COO differs from the one-table walk")
    check(same_bits(x, rx), "tiered: x differs from the one-table walk's")
    served = eng.run(requests[0], hop_seeds=hs)
    with torch.inference_mode():
        want = eng.model(rx, layers_to_adjs(rl, BATCH, SIZES))[:BATCH]
    err = max_abs(served, want)
    check(torch.allclose(served, want, atol=1e-4, rtol=1e-4),
          f"tiered logits differ from the one-table walk's by {err}")
    t = forder.long()[n_id.long().clamp(min=0)]
    is_cold = (n_id >= 0) & (t >= hot_rows)
    print(f"tiered check 1: x over {n_id.shape[0]} slots ({int(is_cold.sum())}"
          f" cold) equal bit for bit to the one-table walk's, logits max "
          f"|tiered - one table| = {err:.3g} (tolerance 1e-4)", flush=True)

    # 2. the host-tier gather against its plain version at the cold ids
    cold_ids = (t[is_cold] - hot_rows).to(torch.int32).contiguous()
    holes = torch.where(is_cold, t - hot_rows, -1).to(torch.int32)
    f32_rows = min(FP32_HOST_ROWS, cold_rows)
    f32 = quant.dequantize(quant.QuantizedTensor(
        *(c[:f32_rows] for c in cold))).pin_memory()
    for name, tab, mod in (("int8", cold, cold_rows), ("fp32", f32, f32_rows)):
        ids_m, holes_m = cold_ids % mod, torch.where(holes >= 0, holes % mod,
                                                     holes)
        got = gather.gather_rows(tab, ids_m)
        check(same_bits(got, gather.gather_rows_plain(tab, ids_m)),
              f"host-tier gather {name} differs from its plain version")
        a = torch.full((holes.shape[0], DIM), 7.5, device=dev)
        b = a.clone()
        gather.gather_rows(tab, holes_m, out=a)
        gather.gather_rows_plain(tab, holes_m, out=b)
        check(same_bits(a, b), f"host-tier gather {name} with out= differs "
              "from its plain version")
    h2d, copy_ms = h2d_rate(dev)
    recs = {}
    f32_ids = cold_ids % f32_rows
    f32_kernel = gather.raw_launch(f32, gather.gather_rows(f32, f32_ids))[2]
    made_once(kernels.RAW_LAUNCHES,
              lambda: gather.gather_rows(f32, f32_ids), f32_kernel,
              "host-tier gather fp32")
    for name, tab, ids_m, kname in (
            ("int8", cold, cold_ids, "gather_rows_packed_kernel"),
            ("fp32", f32, f32_ids, f32_kernel)):
        words = gather.word_bytes(tab, gather.gather_rows(tab, ids_m))
        ms = cuda_ms(lambda: gather.gather_rows(tab, ids_m), iters)
        own = own_ms(lambda: gather.gather_rows(tab, ids_m), kname, iters)
        plain_ms = cuda_ms(lambda: gather.gather_rows_plain(tab, ids_m), 3)
        b_ms, b_by, host_bytes, dev_bytes, distinct = host_gather_bound(
            tab, ids_m, h2d)
        share = "" if own is None else f" (bound / own {b_ms / own:.0%})"
        rate = "" if own is None else \
            f", {ids_m.shape[0] / own / 1e3:.1f}M host rows/s"
        print(f"host-tier gather_rows {name} ids={ids_m.shape[0]} distinct="
              f"{distinct} D={DIM} ({kname}, {words}-byte words): wrapper "
              f"{ms:.4f} ms, kernel own {fmt_ms(own)}{share}{rate}, plain "
              f"{plain_ms:.4f} ms, reads {host_bytes} B from the host at the"
              f" measured {h2d / 1e9:.2f} GB/s pinned-to-device copy rate "
              f"({COPY_BYTES} B copy_ in {copy_ms:.4f} ms) and moves "
              f"{dev_bytes} B on the card: bound {b_ms:.4f} ms ({b_by}), "
              "exact", flush=True)
        recs[name] = {"ms": ms, "own_ms": own, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": "bytes",
                      "library_ms": None, "err": 0.0, "kernel": kname}
    del f32
    rec = dict(recs["int8"], h2d_bytes_per_s=h2d, fp32=recs["fp32"],
               batch_p50_ms=p50, batch_p99_ms=p99)

    # the served form: each of a tiered batch's host-tier launches
    per_launch = launch_own_ms(
        lambda: [eng.run(ids, hop_seeds=hs) for ids, hs in
                 zip(requests[:4], hop_seeds[:4])],
        "gather_rows_packed_kernel", 4)
    check(per_launch is not None, "the profiler did not see every "
          "host-tier launch of the served batches")
    rec["served_launch_own_ms"] = per_launch
    print(f"tiered: host-tier gather_rows launches per batch, in order "
          f"(the dedup table's read, the compaction's, the full read; "
          f"ids {stats[0]['budget']} / {stats[0]['budget']} / "
          f"{n_id.shape[0]}): own "
          f"{' / '.join(f'{x:.4f}' for x in per_launch)} ms (median over "
          f"4 batches, torch.profiler), {sum(per_launch):.4f} ms per "
          "batch", flush=True)

    # 3. both fallbacks: a budget of 256 against the one-table gather
    fix_ids = torch.where(is_cold, n_id, -1)
    store.cold_budget = 256
    try:
        got = store.lookup_tiered(fix_ids, masked=True)
    finally:
        store.cold_budget = None
    n_uniq = int(torch.unique(t[is_cold]).numel())
    check(n_uniq > 256 and int(is_cold.sum()) > 256, "the budget of 256 "
          "did not overflow both the unique table and the compaction")
    want = masked_feature_gather(table, fix_ids, forder)
    check(same_bits(got[is_cold], want[is_cold])
          and not got[~is_cold].any(),
          "the lookup at cold_budget=256 differs from the one-table gather")
    print(f"tiered check 3: lookup at cold_budget=256 ({n_uniq} unique cold "
          "rows: unique overflow, then cold overflow) equal to the "
          "one-table gather", flush=True)

    # 4. no host synchronisation in the store's lookup; and the step?
    # (the registry's no_host_sync check on the card decides)
    _, n_sync = card_host_syncs(store.lookup_tiered, (fix_ids,),
                                {"masked": True})
    check(n_sync == 0, f"the store's lookup_tiered synchronised with the "
          f"host {n_sync} time(s)")
    _, n_step = card_host_syncs(eng.run, (requests[0],), {"hop_seeds": hs})
    step_note = "runs without one too" if n_step == 0 else \
        f"synchronises {n_step} time(s)"
    print(f"tiered check 4: the store's lookup_tiered runs under the "
          f"card's sync debug mode without a host synchronisation; the "
          f"whole serve step {step_note}", flush=True)

    # 5. the split route over the store; dedup_gather over a plain table
    split = ServeEngine(model, None, topo, store, [SIZES], BATCH, seed=SEED,
                        device=dev)
    dedup = ServeEngine(model, None, topo, table, [SIZES], BATCH,
                        forder=forder, dedup_gather=True, seed=SEED,
                        device=dev)
    from quiver_tpu_torch.ops.kernels import _build
    q8 = "gather_rows_q8_kernel"
    q8_before = _build.KERNEL_TOTALS.get(q8, 0)
    taken = KernelArgs(lambda name, args: name == "gather_rows"
                       and separate_sidecars(args[0]))
    token = _build._RECORDER.set(taken)
    try:
        for name, e in (("split route over the store", split),
                        ("dedup_gather over one table", dedup)):
            o = e.run(requests[1])
            check(bool(torch.isfinite(o).all()),
                  f"{name}: non-finite logits")
            print(f"tiered check 5: {name}: finite logits {tuple(o.shape)}",
                  flush=True)
    finally:
        _build._RECORDER.reset(token)
    # the int8 gather over separate sidecars: the one-table dedup read
    rec["q8_launches_check5"] = _build.KERNEL_TOTALS.get(q8, 0) - q8_before
    check(len(taken.calls) == rec["q8_launches_check5"] > 0,
          f"{len(taken.calls)} gather_rows calls over separate sidecars, "
          f"{rec['q8_launches_check5']} {q8} launches")
    before = _build.KERNEL_TOTALS.get(q8, 0)
    rec["q8"] = [q8_gather_times(a, iters, card) for a in taken.calls]
    rec["q8_timing_launches"] = _build.KERNEL_TOTALS.get(q8, 0) - before
    ctx = dict(store=store, eng=eng, topo=topo, requests=requests,
               hop_seeds=hop_seeds, stats=stats)
    return rec, launches, ctx


# the sampler's arms: (label, mode, constructor arguments)
SAMPLER_ARMS = [
    ("a", "HBM", dict(sampling="exact", wide_exact=False)),
    ("b", "HBM", dict(sampling="exact")),
    ("c", "HBM", dict(sampling="rotation")),
    ("d", "HBM", dict(sampling="rotation", layout="overlap")),
    ("e", "HBM", dict(sampling="rotation", layout="overlap",
                      shuffle="butterfly")),
    ("f", "HBM", dict(sampling="window")),
    ("g", "HOST", dict(sampling="exact")),
    ("h", "HOST", dict(sampling="rotation", layout="overlap"))]
SAME_PICKS = {"b": "a", "g": "b", "h": "d"}   # arm: the arm it equals
SYNC_FREE = "bdfgh"                           # sampled under sync "error"
KEEP = set(SAME_PICKS.values()) | set(SAME_PICKS)


def arm_name(mode, kw) -> str:
    s, layout = kw["sampling"], kw.get("layout", "pair")
    if s == "exact":
        return f"{mode} exact " + (f"wide {layout}" if kw.get(
            "wide_exact", True) else "scattered")
    return f"{mode} {s} {layout}+{kw.get('shuffle', 'sort')}"


def same_sample(x, y) -> bool:
    """Two ``sample()`` results equal bit for bit: n_id and every adj."""
    import torch
    return torch.equal(x[0], y[0]) and x[1] == y[1] and all(
        torch.equal(a.edge_index, b.edge_index) and a.size == b.size
        and (a.e_id is None) == (b.e_id is None)
        for a, b in zip(x[2], y[2]))


def sample_bytes(out) -> int:
    return out[0].nbytes + sum(
        a.edge_index.nbytes + a.mask.nbytes
        + (0 if a.e_id is None else a.e_id.nbytes) for a in out[2])


def check_eid_contract(name, indptr, indices, out):
    """Every valid edge of one ``with_eid`` sample, with target ``t``,
    source ``u`` and edge id ``slot`` (a CSR slot: the topology has no
    eid map): ``indptr[t] <= slot < indptr[t + 1]``,
    ``indices[slot] == u``; per target ``min(deg, k)`` edges; within a
    hop the slots distinct. Returns the edges checked."""
    import torch
    n_id, bs, adjs = out
    ip = indptr.long()
    edges = 0
    n_valid = bs         # hop i's seeds: the first n_valid slots of n_id
    for hop, (adj, k) in enumerate(zip(adjs[::-1], SIZES)):
        m = adj.mask
        src, dst = adj.edge_index[0][m].long(), adj.edge_index[1][m].long()
        slot = adj.e_id[m].long()
        t, u = n_id[dst].long(), n_id[src].long()
        check(bool(((ip[t] <= slot) & (slot < ip[t + 1])).all()),
              f"{name} hop {hop}: an edge id outside its target's segment")
        check(torch.equal(indices[slot].long(), u),
              f"{name} hop {hop}: indices[slot] is not the edge's source")
        seeds = n_id[:n_valid].long()
        deg = ip[seeds + 1] - ip[seeds]
        cnt = torch.bincount(dst, minlength=adj.size[1])
        check(torch.equal(cnt[:n_valid], deg.clamp(max=k))
              and not cnt[n_valid:].any(),
              f"{name} hop {hop}: edges per target differ from min(deg, k)")
        n_valid = max(n_valid, int(src.max()) + 1 if src.numel() else 0)
        check(int(torch.unique(slot).numel()) == slot.numel(),
              f"{name} hop {hop}: repeated slots")
        edges += slot.numel()
    return edges


def run_arm(label, mode, kw, topo, batches, card, edge_weight=None,
            keep=KEEP, sync_free=SYNC_FREE):
    """One arm: the sampler built and placed (with ``edge_weight``, a
    weighted sampler with its weights placed), one reshuffle where the
    method has one (timed apart), a warm-up batch, then the timed
    batches. Returns its record, the timed batches' samples (for the
    arms in ``keep``) and the sampler."""
    import torch
    from quiver_tpu_torch import GraphSageSampler
    from quiver_tpu_torch.ops import kernels
    weighted = edge_weight is not None
    aname = arm_name(mode, kw)
    if weighted:         # the weighted exact draw is the pool draw
        aname = f"weighted {mode} exact pool" if kw["sampling"] == "exact" \
            else f"weighted {aname}"
    name = f"({label}) {aname}"
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = GraphSageSampler(topo, SIZES, mode=mode, seed=SEED,
                         device=topo.device, edge_weight=edge_weight, **kw)
    s.lazy_init_quiver()
    if weighted:
        s._ensure_weights_placed()
    elif kw["sampling"] == "exact" and kw.get("wide_exact", True):
        s._ensure_exact_rows()
        s._exact_hub_frac()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_grow = torch.cuda.max_memory_allocated() - base
    reshuffle_ms = None
    if kw["sampling"] != "exact":
        # HOST mode shuffles on the card too, then keeps no E-sized
        # array there: its growth is measured from after the reshuffle
        t0 = time.perf_counter()
        s.reshuffle()
        torch.cuda.synchronize()
        reshuffle_ms = (time.perf_counter() - t0) * 1e3
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    warm = s.sample(batches[0])
    torch.cuda.synchronize()
    del warm
    warm_grow = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernels.reset_launches()
    outs = []
    t0 = time.perf_counter()
    for b in batches[1:]:
        outs.append(s.sample(b))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    raw = nonzero(kernels.RAW_LAUNCHES)
    elems = nonzero(kernels.ELEMS_LAUNCHES)
    kept = sum(sample_bytes(o) for o in outs)
    loop_grow = torch.cuda.max_memory_allocated() - before - kept
    resident = torch.cuda.memory_allocated() - before - kept
    edges = int(sum(a.mask.sum() for o in outs for a in o[2]))
    n = len(outs)
    rec = {"arm": label, "name": aname, "mode": mode,
           "seps": edges / wall, "ms_per_batch": wall * 1e3 / n,
           "edges_per_batch": edges / n, "reshuffle_ms": reshuffle_ms,
           "setup_s": setup_s, "launches": launches, "raw_launches": raw,
           "elems_launches": elems,
           "setup_growth_bytes": setup_grow,
           "warmup_growth_bytes": warm_grow, "loop_growth_bytes": loop_grow,
           "resident_growth_bytes": resident,
           "sync_free": label in sync_free}
    per = ", ".join(f"{k} {v / n:g}" for k, v in launches.items() if v)
    if raw or elems:
        per += " (" + ", ".join(f"{k} {v / n:g}" for k, v in
                                {**raw, **elems}.items()) + ")"
    sync = ""
    if label in sync_free:       # four more batches, none may synchronise
        _, n_sync = card_host_syncs(lambda: [s.sample(b)
                                             for b in batches[1:5]])
        check(n_sync == 0, f"sampler: {name}: {n_sync} host "
              "synchronisation(s) in 4 batches")
        sync = "; 4 more batches sampled with no host synchronisation"
    print(f"sampler: {name}: {n} batches of {BATCH}, fanout {SIZES}: "
          f"{rec['ms_per_batch']:.3f} ms per batch (host clock + "
          f"synchronize), {edges / n:.0f} sampled edges per batch, "
          f"{rec['seps']:.6g} sampled edges/s; reshuffle "
          f"{fmt_ms(reshuffle_ms)}; set-up {setup_s:.2f} s; launches per "
          f"batch: {per or 'none'}{sync}; on {card}", flush=True)
    prof = {}
    rec["device_ms_per_batch"] = device_profile(
        lambda: [s.sample(b) for b in batches[1:5]], 4, f"({label}) batch",
        top=6, stats=prof)
    rec.update(prof)
    return rec, (outs if label in keep else None), s


def last_hop_reads(dev, indptr):
    """A last-hop frontier's topology reads (180,224 seeds, a fifth of
    them -1, drawn from seed SEED + 7): each seed's first row in the
    128-wide rows views (-1 for a -1 seed or one with no neighbours), its
    picks' slots of ``indices`` (5 a seed, -1 past its degree), and the
    seeds."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    hop = [BATCH]
    for k in SIZES[:-1]:
        hop.append(hop[-1] * (1 + k))
    bs, k = hop[-1], SIZES[-1]
    seeds = torch.randperm(NODES, generator=gen, device=dev)[:bs]
    seeds[torch.rand(bs, generator=gen, device=dev) < 0.2] = -1
    seeds = seeds.to(torch.int32)
    ip = indptr.long()
    valid = seeds >= 0
    sl = seeds.long().clamp(min=0)
    start = torch.where(valid, ip[sl], 0)
    deg = torch.where(valid, ip[sl + 1] - ip[sl], 0)
    r0 = torch.where(valid & (deg > 0), start // 128, -1).to(torch.int32)
    pos = torch.randint(0, 2**62, (bs, k), generator=gen, device=dev) \
        % deg.clamp(min=1)[:, None]
    picked = torch.arange(k, device=dev) < deg.clamp(max=k)[:, None]
    slots = torch.where(picked, start[:, None] + pos, -1).reshape(-1) \
        .contiguous()
    return r0, slots, seeds


def span_units(tab, start, count, width, unit: int) -> int:
    """The ``unit``-byte blocks of ``tab`` (32: sectors, 128: lines; at
    its address as the card reads it: a pinned table's host address maps
    one to one) that the spans ``[start, start + min(count, width))``
    touch, each span cut at the table's end (the kernel clamps reads
    past it into its last element)."""
    eb = tab.element_size()
    n = count.long().clamp(0, width)
    lo = start.long().clamp(0, tab.shape[0] - 1)
    hi = (start.long() + n).clamp(max=tab.shape[0])
    live = (n > 0) & (hi > lo)
    first = tab.data_ptr() + lo[live] * eb
    last = tab.data_ptr() + hi[live] * eb - 1
    return int((last // unit - first // unit + 1).sum())


def span_gather(name, tab, start, count, width, h2d, card, iters,
                flat=None):
    """The span gather (``gather_segments``) over ``tab`` at these spans
    against its plain version bit for bit and, given ``flat`` (the
    output of the flat form over the implied ids), against the flat
    form; one launch of ``gather_segments_kernel``; its own time against
    its bound (12 bytes a seed read and the output written at 3.35 TB/s,
    or the live host bytes at the pinned copy rate ``h2d``), the 32-byte
    sectors it asks for and, for a pinned table, host read requests a
    second."""
    import torch
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.ops.kernels import gather
    run = lambda: gather.gather_segments(tab, start, count, width)
    plain = lambda: gather.gather_segments_plain(tab, start, count, width)
    got, want = run(), plain()
    check(same_bits(got, want), f"span gather {name}: the kernel differs "
          "from its plain version")
    if flat is not None:
        check(same_bits(got.reshape(-1), flat.reshape(-1)),
              f"span gather {name}: the span and the flat form differ")
    kernels.reset_launches()
    run()
    check(kernels.LAUNCHES["gather_elems"] == 1,
          f"span gather {name}: launches {kernels.LAUNCHES}")
    made(kernels.ELEMS_LAUNCHES, gather_segments_kernel=1)
    ms = cuda_ms(run, iters)
    own = own_ms(run, "gather_segments_kernel", iters)
    plain_ms = cuda_ms(plain, 3)
    on_host = tab.device.type == "cpu"
    bs, eb = start.shape[0], tab.element_size()
    n_live = int(count.long().clamp(0, width).sum())
    dev_b = 12 * bs + width * eb * bs
    b_dev = dev_b / HBM_BYTES_PER_S * 1e3
    b_host = n_live * eb / h2d * 1e3 if on_host else 0.0
    b_ms, b_by = (b_host, "bytes (host)") if b_host > b_dev \
        else (b_dev, "bytes (device)")
    sectors = span_units(tab, start, count, width, 32)
    rate = None if own is None or not on_host else sectors / (own / 1e3)
    share = "" if own is None else f" (bound / own {b_ms / own:.0%})"
    print(f"span gather {name}: {'pinned' if on_host else 'device'} "
          f"{str(tab.dtype)[6:]} {tuple(tab.shape)}, {bs} spans of width "
          f"{width} ({int((count > 0).sum())} non-empty, {n_live} elements "
          f"live): wrapper {ms:.4f} ms, kernel own {fmt_ms(own)}{share}, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; device "
          f"{b_dev:.4f} ms, host {b_host:.4f} ms at the measured "
          f"{h2d / 1e9:.2f} GB/s pinned copy rate); {sectors} 32-byte "
          "sectors asked for"
          + ("" if rate is None else
             f", {rate / 1e6:.1f}M host read requests/s")
          + "; equal to the plain version bit for bit"
          + ("" if flat is None else " and to the flat form")
          + f"; on {card}", flush=True)
    return {"ms": ms, "own_ms": own, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": "bytes", "library_ms": None, "max_abs_err": 0.0,
            "spans": bs, "width": width, "live_elements": n_live,
            "sectors": sectors, "host_requests_per_s": rate,
            "kernel": "gather_segments_kernel"}


def heads_spans(dev, seeds, n_table):
    """``_segment_heads``'s spans of these seeds (``start`` the clamped
    seed, ``count`` 2, 0 for a -1 seed), with the edge cases the kernel
    must get right written over the first slots: a start at the table's
    end with count 0, a span running past the end, the last node's
    heads."""
    import torch
    valid = seeds >= 0
    start = seeds.long().clamp(0, n_table - 2)
    count = torch.where(valid, 2, 0).to(torch.int32)
    start[:3] = torch.tensor([n_table, n_table - 1, n_table - 2])
    count[:3] = torch.tensor([0, 2, 2], dtype=torch.int32)
    return start.contiguous(), count.contiguous()


def topology_gathers(dev, samplers, indptr, indices, card, iters):
    """The topology variants of the gather against their plain versions,
    bit for bit, at the arms' shapes (a last-hop frontier of 180,224
    seeds: its rows of the pair and overlap views, 901,120 slots of
    ``indices``), over pinned and device tables, with -1 ids; own times
    against their bounds, host read requests per second, and for device
    tables the indexing yardstick."""
    import torch
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.ops.kernels import gather
    r0, slots, seeds = last_hop_reads(dev, indptr)
    h2d, _ = h2d_rate(dev)
    pair_host = samplers["g"]._exact_rows
    over_host = samplers["h"]._rot
    tables = {
        "rows128": (pair_host, samplers["b"]._exact_rows, r0, 128),
        "rows256": (over_host, samplers["d"]._rot, r0, 256),
        "elems": (samplers["g"]._placed[1], indices, slots, 1)}
    recs = {}
    for vname, (host_t, dev_t, ids, width) in tables.items():
        rec = {}
        for where, tab in (("host", host_t), ("device", dev_t)):
            check(tab.is_pinned() == (where == "host"),
                  f"{vname}: the {where} table is misplaced")
            live = ids[ids >= 0]
            if width == 1:
                run = lambda tab=tab, ids=ids: gather.gather_elems(tab, ids)
                plain = lambda tab=tab, ids=ids: gather.gather_elems_plain(
                    tab, ids)
                kname = "gather_elems_kernel"
                lib = (lambda tab=tab, live=live: tab[live.long()]) \
                    if where == "device" else None
                got, want = run(), plain()
                check(bool((got[ids < 0] == -1).all()),
                      f"{vname} {where}: a -1 id did not give -1")
                row_b = tab.element_size()
            else:
                out = torch.full((ids.shape[0], width), 7, dtype=torch.int32,
                                 device=dev)
                ref = out.clone()
                run = lambda tab=tab, ids=ids, out=out: gather.gather_rows(
                    tab, ids, out=out)
                plain = lambda tab=tab, ids=ids, ref=ref: \
                    gather.gather_rows_plain(tab, ids, out=ref)
                kname = gather.raw_launch(tab, out)[2]
                lib = (lambda tab=tab, live=live: torch.index_select(
                    tab, 0, live)) if where == "device" else None
                got, want = run(), plain()
                dense = live.contiguous()
                check(same_bits(gather.gather_rows(tab, dense),
                                gather.gather_rows_plain(tab, dense)),
                      f"{vname} {where}: the gather of live ids differs "
                      "from its plain version")
                row_b = width * 4
            check(same_bits(got, want), f"{vname} {where}: the gather "
                  "differs from its plain version")
            kernels.reset_launches()
            run()
            check(kernels.LAUNCHES["gather_elems" if width == 1
                                   else "gather_rows"] == 1,
                  f"{vname} {where}: launches {kernels.LAUNCHES}")
            made(kernels.RAW_LAUNCHES, **({} if width == 1 else {kname: 1}))
            made(kernels.ELEMS_LAUNCHES, **({kname: 1} if width == 1
                                            else {}))
            ms = cuda_ms(run, iters)
            own = own_ms(run, kname, iters)
            plain_ms = cuda_ms(plain, 3)
            lib_ms = None if lib is None else cuda_ms(lib, iters)
            n_live = int(live.numel())
            data_b = n_live * row_b
            dev_b = ids.shape[0] * 4 + (n_live * row_b
                                        if where == "host" else 2 * data_b)
            if where == "host":
                b_host = data_b / h2d * 1e3
                b_dev = dev_b / HBM_BYTES_PER_S * 1e3
                b_ms, b_by = (b_host, "bytes (host)") if b_host >= b_dev \
                    else (b_dev, "bytes (device)")
            else:
                b_ms, b_by = bound(dev_b, 0)
            lines = n_live * max(1, row_b // 128)
            rate = None if own is None or where == "device" else \
                lines / (own / 1e3)
            share = "" if own is None else f" (bound / own {b_ms / own:.0%})"
            print(f"topology gather {vname} {where} table "
                  f"{tuple(tab.shape)} {str(tab.dtype)[6:]} ({kname}): ids "
                  f"{ids.shape[0]} ({n_live} live, the rest -1): wrapper "
                  f"{ms:.4f} ms, kernel own {fmt_ms(own)}{share}, plain "
                  f"{plain_ms:.4f} ms"
                  + ("" if lib_ms is None else
                     f", indexing yardstick {lib_ms:.4f} ms")
                  + f", bound {b_ms:.4f} ms ({b_by}"
                  + (f" at the measured {h2d / 1e9:.2f} GB/s pinned copy "
                     "rate" if where == "host" else "") + ")"
                  + ("" if rate is None else
                     f", {rate / 1e6:.1f}M host read requests/s "
                     f"({max(1, row_b // 128)} per id)")
                  + f", exact; on {card}", flush=True)
            rec[where] = {"ms": ms, "own_ms": own, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": "bytes",
                          "library_ms": lib_ms, "max_abs_err": 0.0,
                          "ids": int(ids.shape[0]), "live_ids": n_live,
                          "host_requests_per_s": rate, "kernel": kname}
        recs[vname] = rec
    recs["heads"] = topology_heads(dev, samplers["g"]._placed[0], seeds,
                                   h2d, card, iters)
    return recs, h2d


def topology_heads(dev, ip_host, seeds, h2d, card, iters):
    """The indptr heads of a last-hop frontier (180,224 seeds, a fifth
    of them -1) through the span gather over the pinned int32 indptr and
    an int64 copy, each against its plain version and the flat form over
    the parent's ``[2, bs]`` ids (timed too: own time and host read
    requests a second, one request an id)."""
    import torch
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.ops.kernels import gather
    from quiver_tpu_torch.utils.placement import pinned_put
    start, count = heads_spans(dev, seeds, ip_host.shape[0])
    flat_ids = torch.where(count > 0, torch.stack([start, start + 1]),
                           -1).reshape(-1)
    recs = {}
    for dtype in (torch.int32, torch.int64):
        name = str(dtype)[6:]
        tab = ip_host if ip_host.dtype == dtype else pinned_put(
            ip_host.to(dtype), dev, f"the {name} indptr")
        check(tab.is_pinned(), f"heads {name}: indptr is not pinned")
        flat_run = lambda tab=tab: gather.gather_elems(tab, flat_ids)
        flat = flat_run()
        rec = span_gather(f"heads {name} indptr", tab, start, count, 2, h2d,
                          card, iters, flat=flat.reshape(2, -1).t())
        kernels.reset_launches()
        flat_run()
        made(kernels.ELEMS_LAUNCHES, gather_elems_kernel=1)
        f_ms = cuda_ms(flat_run, iters)
        f_own = own_ms(flat_run, "gather_elems_kernel", iters)
        live = int((flat_ids >= 0).sum())
        f_rate = None if f_own is None else live / (f_own / 1e3)
        print(f"span gather heads {name} indptr, the flat form over the "
              f"[2, {seeds.shape[0]}] ids (gather_elems_kernel): wrapper "
              f"{f_ms:.4f} ms, kernel own {fmt_ms(f_own)}, {live} live ids"
              + ("" if f_rate is None else
                 f", {f_rate / 1e6:.1f}M host read requests/s (one an id)")
              + f"; on {card}", flush=True)
        rec["flat"] = {"ms": f_ms, "own_ms": f_own, "live_ids": live,
                       "host_requests_per_s": f_rate}
        recs[name] = rec
        del flat
    return recs


def phase_sampler(dev, gen, nodes, indptr, indices, card):
    """``GraphSageSampler`` at bench.py's scale in both modes: the eight
    arms timed on the same 32 batches, their picks held to each other
    bit for bit, ``sample()`` free of host synchronisation, HOST mode's
    footprint on the card, every method's edge ids held to the CSR, and
    the topology gathers against their plain versions."""
    import torch
    from quiver_tpu_torch import CSRTopo, GraphSageSampler
    topo = CSRTopo(indptr=indptr, indices=indices, device=dev)
    check(topo.indptr.data_ptr() == indptr.data_ptr()
          and topo.indices.data_ptr() == indices.data_ptr(),
          "CSRTopo copied the graph")
    meta = topo.exact_bucket_meta()
    perm = torch.randperm(nodes, generator=gen, device=dev).to(torch.int32)
    batches = [perm[i * BATCH:(i + 1) * BATCH].contiguous()
               for i in range(SAMPLER_BATCHES + 1)]
    print(f"sampler: {nodes} nodes, {indices.numel()} edges, bucket split "
          f"node_frac {meta.node_frac:.4f} edge_frac {meta.edge_frac:.4f}; "
          f"pinned for the HOST arms: indices {indices.nbytes} B, pair "
          f"rows view {((indices.numel() + 255) // 128 + 1) * 512} B, "
          f"overlap view {((indices.numel() + 255) // 128 + 1) * 1024} B; "
          f"on {card}", flush=True)
    recs, kept, samplers = {}, {}, {}
    for i, (label, mode, kw) in enumerate(SAMPLER_ARMS):
        rec, outs, s = run_arm(label, mode, kw, topo, batches, card)
        recs[label] = rec
        if label in "bdgh":             # their tables feed the gather check
            samplers[label] = s
        del s
        if outs is not None:
            kept[label] = outs
        ref = SAME_PICKS.get(label)
        if ref is not None:
            check(all(same_sample(x, y) for x, y in zip(kept[label],
                                                       kept[ref])),
                  f"sampler ({label}) differs from ({ref})")
            print(f"sampler check: ({label}) equal to ({ref}) bit for bit "
                  f"over {len(kept[label])} batches (n_id and every adj)",
                  flush=True)
            later = {SAME_PICKS.get(y) for y, _, _ in SAMPLER_ARMS[i + 1:]}
            for x in (ref, label):
                if x not in later:
                    del kept[x]
        if mode == "HBM":
            check(not any(rec["launches"].values()),
                  f"({label}) HBM launched port kernels: {rec['launches']}")
        else:
            check(rec["launches"]["gather_elems"] > 0
                  and rec["launches"]["gather_rows"] > 0,
                  f"({label}) HOST did not read through the topology "
                  f"gathers: {rec['launches']}")
            # the pinned int32 rows views: each read by the design the
            # dispatcher picks for its rows
            check(sum(rec["raw_launches"].values())
                  == rec["launches"]["gather_rows"],
                  f"({label}) raw launches {rec['raw_launches']} against "
                  f"{rec['launches']}")
            # the 1-D reads: each hop's indptr heads through the span
            # gather, the scattered picks through the flat form
            check(sum(rec["elems_launches"].values())
                  == rec["launches"]["gather_elems"]
                  and rec["elems_launches"].get("gather_segments_kernel")
                  == len(SIZES) * SAMPLER_BATCHES,
                  f"({label}) 1-D launches {rec['elems_launches']} against "
                  f"{rec['launches']}")
            for key in ("setup_growth_bytes", "warmup_growth_bytes",
                        "loop_growth_bytes"):
                check(rec[key] < indices.nbytes,
                      f"({label}) the card's memory grew by {rec[key]} B "
                      f"({key}), not below the indices' {indices.nbytes} B")
            print(f"sampler check: ({label}) HOST mode: "
                  f"max_memory_allocated grew by {rec['setup_growth_bytes']}"
                  f" B over set-up, {rec['warmup_growth_bytes']} B over the "
                  f"warm-up batch and {rec['loop_growth_bytes']} B over the "
                  f"timed batches beyond the samples they returned, each "
                  f"below the indices' {indices.nbytes} B", flush=True)
    check(not kept, f"samples left uncompared: {sorted(kept)}")
    for a, b, what in (("g", "b", "exact wide"), ("h", "d", "rotation")):
        print(f"sampler: HOST/HBM SEPS for {what}: "
              f"{recs[a]['seps'] / recs[b]['seps']:.3f}; on {card}",
              flush=True)

    gathers, h2d = topology_gathers(dev, samplers, indptr, indices, card,
                                    iters=20)
    del samplers

    edges = 0
    for label, mode, kw in SAMPLER_ARMS:
        s = GraphSageSampler(topo, SIZES, mode=mode, seed=SEED + 1,
                             with_eid=True, device=dev, **kw)
        out = s.sample(batches[0])
        edges += check_eid_contract(f"({label}) with_eid", indptr, indices,
                                    out)
        del s, out
    print(f"sampler check: with_eid on one batch of each of the "
          f"{len(SAMPLER_ARMS)} arms: {edges} edges, each id a CSR slot "
          "of its target holding its source, min(deg, k) edges per target,"
          " distinct slots within each hop", flush=True)
    host_l = sum(recs[x]["launches"]["gather_rows"]
                 + recs[x]["launches"]["gather_elems"] for x in "gh")
    return recs, gathers, host_l, h2d, topo, batches


# -- phase 8: weighted sampling, GAT, the windowed steps, random walks ------

WEIGHTED_ARMS = [
    ("i", "HBM", dict(sampling="exact")),
    ("j", "HBM", dict(sampling="rotation", layout="overlap")),
    ("k", "HOST", dict(sampling="exact")),
    ("l", "HOST", dict(sampling="rotation", layout="overlap"))]
WEIGHTED_SAME = {"k": "i", "l": "j"}          # arm: the arm it equals
WEIGHTED_BATCHES = 16                         # timed batches of each arm
ZERO_FRAC = 0.1          # the share of edges whose weight the check zeroes
GAT_SIZES = [10, 5]
GAT_HIDDEN, GAT_HEADS = 64, 4                 # examples/gat_weighted.py
GAT_STEPS = 32


def example_weights(indices, deg):
    """``examples/gat_weighted.py``'s refresh weights on the card: ``0.5
    + deg[indices] / max(deg)``, fp32, CSR-slot-aligned."""
    import torch
    d = deg.to(torch.float32)
    return 0.5 + d[indices.long()] / d.max()


def majority_labels(indptr, indices, cls, nodes):
    """Each node's label: the class (of ``cls``) most common among its
    neighbours, ties to the lowest; a node with none keeps its own. GAT
    has no self term, so it can learn only what the neighbours carry."""
    import torch
    from quiver_tpu_torch.ops.sample import edge_row_ids
    rows = edge_row_ids(indptr, indices.shape[0]).long()
    counts = torch.zeros(nodes * CLASSES, dtype=torch.int32,
                         device=cls.device)
    counts.index_add_(0, rows * CLASSES + cls.long()[indices.long()],
                      torch.ones_like(indices))
    del rows
    deg = (indptr[1:] - indptr[:-1]).long()
    return torch.where(deg > 0, counts.view(nodes, CLASSES).argmax(1),
                       cls.long()).to(torch.int32)


def check_weighted_contract(name, indptr, indices, w, out, windowed):
    """One ``with_eid`` sample of a weighted arm over weights with zeros:
    each edge id a CSR slot of its target holding its source, none of
    weight 0; per target ``min(deg, k)`` draws where the target's weight
    (within the window, for a windowed draw whose segment passes it) is
    positive, else none. Returns the edges checked."""
    import torch
    n_id, bs, adjs = out
    ip = indptr.long()
    csum = torch.cat([w.new_zeros(1, dtype=torch.float64),
                      torch.cumsum(w.double(), 0)])   # one prefix sum
    edges = 0
    n_valid = bs
    for hop, (adj, k) in enumerate(zip(adjs[::-1], SIZES)):
        m = adj.mask
        src, dst = adj.edge_index[0][m].long(), adj.edge_index[1][m].long()
        slot = adj.e_id[m].long()
        t, u = n_id[dst].long(), n_id[src].long()
        check(bool(((ip[t] <= slot) & (slot < ip[t + 1])).all()),
              f"{name} hop {hop}: an edge id outside its target's segment")
        check(torch.equal(indices[slot].long(), u),
              f"{name} hop {hop}: indices[slot] is not the edge's source")
        check(bool((w[slot] > 0).all()),
              f"{name} hop {hop}: a pick on a zero-weight edge")
        seeds = n_id[:n_valid].long()
        deg = ip[seeds + 1] - ip[seeds]
        cnt = torch.bincount(dst, minlength=adj.size[1])
        mass = csum[ip[seeds + 1]] - csum[ip[seeds]]
        full = deg.clamp(max=k)
        sure = mass > 0 if not windowed else (mass > 0) & (deg <= 129)
        check(torch.equal(cnt[:n_valid][sure], full[sure])
              and bool((cnt[:n_valid][mass == 0] == 0).all())
              and bool(((cnt[:n_valid] == 0) | (cnt[:n_valid] == full))
                       .all())
              and not cnt[n_valid:].any(),
              f"{name} hop {hop}: draws per target differ from min(deg, k)")
        n_valid = max(n_valid, int(src.max()) + 1 if src.numel() else 0)
        edges += slot.numel()
    return edges


def weight_gathers(dev, samplers, indptr, card, h2d, iters):
    """The HOST weighted arms' reads against their plain versions at
    their shapes: the pool draw's pinned fp32 weights at hop 2 (a
    180,224-seed frontier, 80% live, each live seed's first min(deg,
    2048) slots and -1 for the rest of its 2048 columns), through the
    flat form over the materialised ids (the parent's read) and through
    the span gather (HOST mode's read), and the pinned fp32 weight rows,
    128 (the pair layout) and 256 wide, at the frontier's row ids; own
    times against the copy-rate bound, host read requests per second."""
    import torch
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.ops.kernels import gather
    from quiver_tpu_torch.utils.placement import pinned_put
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    bs = BATCH
    for k in SIZES[:-1]:
        bs *= 1 + k
    seeds = torch.randperm(NODES, generator=gen, device=dev)[:bs]
    seeds[torch.rand(bs, generator=gen, device=dev) < 0.2] = -1
    ip = indptr.long()
    valid = seeds >= 0
    sl = seeds.long().clamp(min=0)
    start = torch.where(valid, ip[sl], 0)
    deg = torch.where(valid, ip[sl + 1] - ip[sl], 0)
    offs = torch.arange(ROW_CAP, device=dev)[None, :]
    pool = torch.where(offs < deg.clamp(max=ROW_CAP)[:, None],
                       start[:, None] + offs, -1).reshape(-1)
    r0 = torch.where(valid & (deg > 0), start // 128, -1).to(torch.int32)
    w_host = samplers["k"]._weight_placed
    rows256 = samplers["l"]._rot_w
    rows128 = pinned_put(rows256[:, :128].contiguous(), dev,
                         "the pair weight rows")
    recs = {}
    for vname, tab, ids, width in (("elems", w_host, pool, 1),
                                   ("rows128", rows128, r0, 128),
                                   ("rows256", rows256, r0, 256)):
        check(tab.is_pinned() and tab.dtype == torch.float32,
              f"weights {vname}: the table is not pinned fp32")
        live = ids[ids >= 0]
        if width == 1:
            run = lambda tab=tab, ids=ids: gather.gather_elems(tab, ids)
            plain = lambda tab=tab, ids=ids: gather.gather_elems_plain(
                tab.view(torch.int32), ids).view(torch.float32)
            kname = "gather_elems_kernel"
        else:
            out = torch.full((ids.shape[0], width), 7.5, device=dev)
            ref = out.clone()
            run = lambda tab=tab, ids=ids, out=out: gather.gather_rows(
                tab, ids, out=out)
            plain = lambda tab=tab, ids=ids, ref=ref: \
                gather.gather_rows_plain(tab, ids, out=ref)
            kname = gather.raw_launch(tab, out)[2]
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = run()
        check(same_bits(got, want), f"weights {vname}: the gather differs "
              "from its plain version")
        if width == 1:
            check(torch.equal(got[ids >= 0], w_host[live.cpu()].to(dev)),
                  "weights elems: live values differ from the table")
        kernels.reset_launches()
        run()
        check(kernels.LAUNCHES["gather_elems" if width == 1
                               else "gather_rows"] == 1,
              f"weights {vname}: launches {kernels.LAUNCHES}")
        made(kernels.RAW_LAUNCHES, **({} if width == 1 else {kname: 1}))
        made(kernels.ELEMS_LAUNCHES, **({kname: 1} if width == 1 else {}))
        ms = cuda_ms(run, iters)
        own = own_ms(run, kname, iters)
        n_live = int(live.numel())
        data_b = n_live * 4 * width
        dev_b = ids.shape[0] * ids.element_size() + ids.shape[0] * 4 * width
        b_host = data_b / h2d * 1e3
        b_dev = dev_b / HBM_BYTES_PER_S * 1e3
        b_ms, b_by = (b_host, "bytes (host)") if b_host >= b_dev \
            else (b_dev, "bytes (device)")
        lines = n_live * max(1, 4 * width // 128)
        rate = None if own is None else lines / (own / 1e3)
        share = "" if own is None else f" (bound / own {b_ms / own:.0%})"
        print(f"weight gather {vname} pinned fp32 table "
              f"{tuple(tab.shape)} ({kname}): ids {ids.shape[0]} ({n_live} "
              f"live, the "
              f"rest -1): wrapper {ms:.4f} ms, kernel own {fmt_ms(own)}"
              f"{share}, plain {plain_ms:.4f} ms (host clock, one call), "
              f"bound {b_ms:.4f} ms ({b_by} at the measured "
              f"{h2d / 1e9:.2f} GB/s pinned copy rate)"
              + ("" if rate is None else
                 f", {rate / 1e6:.1f}M host read requests/s "
                 f"({max(1, 4 * width // 128)} per id)")
              + f", exact; on {card}", flush=True)
        recs[vname] = {"ms": ms, "own_ms": own, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": "bytes",
                       "library_ms": None, "max_abs_err": 0.0,
                       "ids": int(ids.shape[0]), "live_ids": n_live,
                       "host_requests_per_s": rate, "kernel": kname}
        if width == 1:
            flat = got.reshape(bs, ROW_CAP)
        del got, want
    # the pool draw's read as HOST mode makes it now: each seed's span of
    # live weights from its start and pool size (0 for a -1 seed), no id
    # array; held to the flat form's output above too
    recs["span"] = span_gather(
        "weights pool (the hop-2 pool draw)", w_host, start.contiguous(),
        deg.clamp(max=ROW_CAP).to(torch.int32).contiguous(), ROW_CAP, h2d,
        card, iters, flat=flat)
    return recs


def gat_model(dev):
    """``examples/gat_weighted.py``'s GAT (hidden 64, 4 heads, 2 layers,
    dropout 0) over phase 5's widths, random weights from the seed."""
    from quiver_tpu_torch import GAT
    from quiver_tpu_torch.models.convert import (gat_flax_to_state_dict,
                                                 random_gat_flax_params)
    model = GAT(DIM, GAT_HIDDEN, CLASSES, len(GAT_SIZES), heads=GAT_HEADS,
                dropout=0.0)
    model.load_state_dict(gat_flax_to_state_dict(random_gat_flax_params(
        DIM, GAT_HIDDEN, CLASSES, len(GAT_SIZES), heads=GAT_HEADS,
        seed=SEED)))
    return model.to(dev)


def adam(model):
    import torch
    return torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8)


def gat_train(dev, topo, w, feat, labels, order, sampling, card):
    """GAT through the user's path: ``GraphSageSampler(edge_weight=w,
    sampling=...)``, the masked gather, ``build_split_train_step``'s
    ``step_fn``; one warm-up step, ``GAT_STEPS`` counted and timed, four
    profiled. Returns the run's record."""
    import torch
    from quiver_tpu_torch import GraphSageSampler
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.parallel import (build_split_train_step,
                                           init_state, masked_feature_gather)
    model = gat_model(dev)
    opt = adam(model)
    _, step_fn = build_split_train_step(model, opt, GAT_SIZES, BATCH)
    sampler = GraphSageSampler(topo, GAT_SIZES, device=dev, seed=SEED,
                               edge_weight=w, sampling=sampling,
                               layout="overlap")
    state = init_state(model, opt)
    batches = [order[i * BATCH:(i + 1) * BATCH].contiguous()
               for i in range(GAT_STEPS + 5)]

    def one(i):
        nonlocal state
        n_id, _, adjs = sampler.sample(batches[i])
        x = masked_feature_gather(feat, n_id)
        state, loss = step_fn(state, x, adjs, labels[batches[i].long()], i)
        return loss, sum(a.mask.sum() for a in adjs)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm, _ = one(0)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    kernels.reset_launches()
    lat, losses, edges = [], [], []
    for i in range(1, 1 + GAT_STEPS):
        t0 = time.perf_counter()
        loss, e = one(i)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        edges.append(e)
    launches = dict(kernels.LAUNCHES)
    losses = torch.stack(losses).tolist()
    n_edges = int(torch.stack(edges).sum())
    check(all(math.isfinite(v) for v in losses), f"GAT losses {losses}")
    check(not any(launches.values()),
          f"GAT on the HBM sampler launched port kernels: {launches}")
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    check(last < first and last < math.log(CLASSES),
          f"GAT ({sampling}) loss did not fall below the uniform guess "
          f"ln {CLASSES} = {math.log(CLASSES):.4f}: first 8 mean {first}, "
          f"last 8 mean {last}")
    srt = sorted(lat)
    p50 = srt[len(srt) // 2]
    p99 = srt[min(len(srt) - 1, math.ceil(0.99 * len(srt)) - 1)]
    wall_s = sum(lat) / 1e3
    print(f"gat train ({sampling}): {GAT_STEPS} steps of {BATCH} seeds, "
          f"fanout {GAT_SIZES}, GAT {DIM}->{GAT_HEADS}x{GAT_HIDDEN}->"
          f"{CLASSES}, weighted {sampling} sampler (HBM), masked gather, "
          f"split step_fn, Adam lr {LR}: step p50 {p50:.3f} ms p99 "
          f"{p99:.3f} ms (host clock + synchronize, sampling and gather "
          f"included; the warm-up step {warm_ms:.3f} ms), {n_edges} sampled "
          f"edges = {n_edges / wall_s:.6g} sampled edges/s; loss of the "
          f"warm-up step {float(warm):.4f}, then first {losses[0]:.4f} last "
          f"{losses[-1]:.4f}, mean of the first 8 {first:.4f}, of the last "
          f"8 {last:.4f} (ln {CLASSES} = {math.log(CLASSES):.4f}); every "
          f"loss: {' '.join(f'{v:.4f}' for v in losses)}; on {card}",
          flush=True)
    prof = {}
    busy = device_profile(
        lambda: [one(i) for i in range(1 + GAT_STEPS, 5 + GAT_STEPS)], 4,
        f"GAT {sampling} step", stats=prof)
    return {"sampling": sampling, "steps": GAT_STEPS, "step_p50_ms": p50,
            "step_p99_ms": p99, "warmup_ms": warm_ms,
            "edges_per_s": n_edges / wall_s, "loss_first8": first,
            "loss_last8": last, "losses": losses,
            "device_ms_per_step": busy, **prof}


def gat_fused(dev, gen, nodes, indptr, indices, feat, labels, model, card):
    """GAT through the fused walk: one ``build_train_step(fused_hot_hop=
    True)`` step (1 + 1 kernel launches at [10, 5]) and its loss and
    gradients against the plain walk; then 4 batches served by
    ``ServeEngine(gat, fused_hot_hop=True)`` (1 + 1 a batch), one held
    against the plain walk within 1e-4. Returns the launches."""
    import torch
    from quiver_tpu_torch import CSRTopo, ServeEngine
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.ops.kernels import fused
    from quiver_tpu_torch.parallel import (build_train_step, init_state,
                                           layers_to_adjs)
    seeds = torch.randperm(nodes, generator=gen, device=dev)[:BATCH] \
        .to(torch.int32)
    ys = labels[seeds.long()]
    hs = SPLIT_HOP_SEEDS[:len(GAT_SIZES)]
    check_walks_agree(model, feat, "GAT fused walk", indptr, indices, seeds,
                      ys, hs, 7, sizes=GAT_SIZES)
    fmodel = copy.deepcopy(model)
    opt = adam(fmodel)
    step = build_train_step(fmodel, opt, GAT_SIZES, BATCH,
                            fused_hot_hop=True, fused_row_cap=ROW_CAP)
    state = init_state(fmodel, opt)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, loss = step(state, feat, None, indptr, indices, seeds, ys, hs, 7)
    loss = float(loss)
    step_ms = (time.perf_counter() - t0) * 1e3
    train_l = dict(kernels.LAUNCHES)
    check(train_l == {"fused_sample_hop": 1, "fused_hot_hop": 1,
                      "sample_layer": 0, "gather_rows": 0,
                      "gather_elems": 0, "gather_rows_sharded": 0},
          f"GAT fused train step launches {train_l}")
    check(math.isfinite(loss), f"GAT fused step loss {loss}")
    print(f"gat fused: one build_train_step(fused_hot_hop=True) step "
          f"{step_ms:.3f} ms (host clock, first call), loss {loss:.4f}, "
          f"launches fused_sample_hop 1, fused_hot_hop 1; on {card}",
          flush=True)

    topo = CSRTopo(indptr=indptr, indices=indices, device=dev)
    eng = ServeEngine(copy.deepcopy(state.model), None, topo, feat,
                      [GAT_SIZES], BATCH, fused_hot_hop=True,
                      fused_row_cap=ROW_CAP, seed=SEED, device=dev).warmup()
    requests = [torch.randperm(nodes, generator=gen, device=dev)[:BATCH]
                for _ in range(4)]
    torch.cuda.synchronize()
    kernels.reset_launches()
    lat = []
    for ids in requests:
        t0 = time.perf_counter()
        o = eng.run(ids)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        check(tuple(o.shape) == (BATCH, CLASSES)
              and bool(torch.isfinite(o).all()), "GAT served logits")
    serve_l = dict(kernels.LAUNCHES)
    check(serve_l["fused_sample_hop"] == 4 and serve_l["fused_hot_hop"] == 4
          and serve_l["sample_layer"] == serve_l["gather_rows"]
          == serve_l["gather_elems"] == 0,
          f"GAT served launches {serve_l}")
    sd = eng.pad_seeds(requests[0])
    got = eng.run(requests[0], hop_seeds=hs)
    rn, rl, rx = fused.multihop_plain(eng._indptr, eng._indices, sd,
                                      eng._feat, GAT_SIZES, hs, ROW_CAP)
    with torch.inference_mode():
        want = eng.model(rx, layers_to_adjs(rl, BATCH, GAT_SIZES))[:BATCH]
    err = max_abs(got, want)
    check(torch.allclose(got, want, atol=1e-4, rtol=1e-4),
          f"GAT served logits differ from the plain walk by {err}")
    print(f"gat serve: ServeEngine(GAT, fused_hot_hop=True), 4 batches of "
          f"{BATCH}: ms {' '.join(f'{v:.3f}' for v in lat)} (host clock + "
          f"synchronize); launches per batch fused_sample_hop 1, "
          f"fused_hot_hop 1; one batch's logits max |kernel - plain| = "
          f"{err:.3g} (tolerance 1e-4); on {card}", flush=True)
    return {"train_step": train_l, "served_4": serve_l,
            "serve_ms": lat, "train_step_ms": step_ms, "serve_err": err}


def windowed_steps(dev, gen, nodes, indptr, indices, feat, labels, rows,
                   card):
    """One full-width GraphSAGE step of the windowed train route
    (``build_train_step(method="rotation", indices_stride=128)`` over the
    sampler's reshuffled overlap view) and one batch served by
    ``ServeEngine(method="rotation")`` (a permute of the topology per
    call); neither launches a kernel of the port."""
    import torch
    from quiver_tpu_torch import CSRTopo, GraphSAGE, ServeEngine
    from quiver_tpu_torch.models.convert import (flax_to_state_dict,
                                                 random_flax_params)
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.parallel import (build_train_step, draw_step_seeds,
                                           init_state)
    params = flax_to_state_dict(
        random_flax_params(DIM, HIDDEN, CLASSES, len(SIZES), seed=SEED))
    model = GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES), dropout=DROPOUT)
    model.load_state_dict(params)
    model = model.to(dev)
    opt = adam(model)
    step = build_train_step(model, opt, SIZES, BATCH, method="rotation",
                            indices_stride=128)
    state = init_state(model, opt)
    host = torch.Generator().manual_seed(SEED + 3)
    times, losses = [], []
    kernels.reset_launches()
    for _ in range(2):
        seeds = torch.randperm(nodes, generator=gen, device=dev)[:BATCH] \
            .to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, feat, None, indptr, indices, seeds,
                           labels[seeds.long()],
                           *draw_step_seeds(host, len(SIZES)), rows)
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    eng = ServeEngine(model, None, CSRTopo(indptr=indptr, indices=indices,
                                           device=dev), feat, [SIZES],
                      BATCH, method="rotation", seed=SEED,
                      device=dev).warmup()
    ids = torch.randperm(nodes, generator=gen, device=dev)[:BATCH]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run(ids)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(out).all()), "rotation-served logits")
    check(not any(kernels.LAUNCHES.values()),
          f"the windowed routes launched kernels: {kernels.LAUNCHES}")
    print(f"windowed steps: build_train_step(GraphSAGE, method='rotation', "
          f"indices_stride=128) over the reshuffled overlap view, fanout "
          f"{SIZES}, batch {BATCH}: step {times[0]:.3f} ms (first call) "
          f"then {times[1]:.3f} ms, losses {losses[0]:.4f} "
          f"{losses[1]:.4f}; ServeEngine(method='rotation') one batch "
          f"{serve_ms:.3f} ms (a permute of the {indices.numel()} edges "
          f"per call); no kernel launched; on {card}", flush=True)
    return {"train_step_ms": times, "serve_ms": serve_ms}


def walk_check(dev, gen, nodes, indptr, indices, card):
    """One ``random_walk`` of 1-step walks from 1024 starts: paths start
    at the starts, each step a neighbour (a zero-degree start stays)."""
    import torch
    from quiver_tpu_torch.ops import random_walk
    starts = torch.randperm(nodes, generator=gen, device=dev)[:BATCH] \
        .to(torch.int32)
    wgen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = random_walk(indptr, indices, starts, 1, wgen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ip = indptr.long()
    st, dg = ip[starts.long()], ip[starts.long() + 1] - ip[starts.long()]
    rows = torch.repeat_interleave(torch.arange(BATCH, device=dev), dg)
    first = torch.cumsum(dg, 0) - dg
    pos = st[rows] + torch.arange(rows.numel(), device=dev) - first[rows]
    hit = torch.zeros(BATCH, dtype=torch.int32, device=dev).index_add_(
        0, rows, (indices[pos] == paths[rows, 1]).to(torch.int32)) > 0
    check(tuple(paths.shape) == (BATCH, 2)
          and torch.equal(paths[:, 0], starts)
          and bool(torch.where(dg > 0, hit, paths[:, 1] == starts).all()),
          "random_walk broke its contract")
    print(f"random walk: 1-step walks from {BATCH} starts in {ms:.3f} ms "
          f"(host clock, first call): paths[:, 0] the starts, every step a "
          f"neighbour ({int((dg == 0).sum())} zero-degree starts stayed); "
          f"on {card}", flush=True)
    return ms


def phase_weighted(dev, gen, nodes, indptr, indices, deg, topo, batches,
                   h2d, card):
    """Phase 8: the weighted sampler arms at bench.py's scale and their
    HOST-mode weight gathers; GAT trained through the weighted sampler
    and through the fused walk, and served; one step of the windowed
    train and serve routes; one random walk."""
    import torch
    from quiver_tpu_torch import GraphSageSampler
    w = example_weights(indices, deg)
    zgen = torch.Generator(device=dev).manual_seed(SEED + 9)
    w_zero = torch.where(torch.rand(w.shape[0], generator=zgen, device=dev)
                         < ZERO_FRAC, 0.0, w)
    print(f"weighted: edge weights 0.5 + deg[indices] / max(deg) "
          f"({w.nbytes} B fp32); the contract check's copy with "
          f"{int((w_zero == 0).sum())} edges zeroed; on {card}", flush=True)
    timed = batches[:WEIGHTED_BATCHES + 1]
    recs, kept, samplers = {}, {}, {}
    for label, mode, kw in WEIGHTED_ARMS:
        rec, outs, s = run_arm(label, mode, kw, topo, timed, card,
                               edge_weight=w, keep=set("ijkl"),
                               sync_free="ijkl")
        recs[label] = rec
        kept[label] = outs
        if label in "jkl":
            samplers[label] = s
        del s
        ref = WEIGHTED_SAME.get(label)
        if ref is not None:
            check(all(same_sample(x, y) for x, y in zip(kept[label],
                                                       kept[ref])),
                  f"weighted ({label}) differs from ({ref})")
            print(f"weighted check: ({label}) equal to ({ref}) bit for bit "
                  f"over {len(kept[label])} batches", flush=True)
            del kept[label], kept[ref]
        launches = rec["launches"]
        if mode == "HBM":
            check(not any(launches.values()),
                  f"({label}) HBM launched port kernels: {launches}")
        else:
            check(launches["gather_elems"] > 0 and (
                kw["sampling"] == "exact" or launches["gather_rows"] > 0),
                f"({label}) HOST did not read through the gathers: "
                f"{launches}")
            check(sum(rec["raw_launches"].values())
                  == launches["gather_rows"],
                  f"({label}) raw launches {rec['raw_launches']} against "
                  f"{launches}")
            # the heads of each hop, and the pool draw's weights, through
            # the span gather
            spans = len(SIZES) * WEIGHTED_BATCHES \
                * (2 if kw["sampling"] == "exact" else 1)
            check(sum(rec["elems_launches"].values())
                  == launches["gather_elems"]
                  and rec["elems_launches"].get("gather_segments_kernel")
                  == spans,
                  f"({label}) 1-D launches {rec['elems_launches']} against "
                  f"{launches}, {spans} span launches expected")
            check(rec["setup_growth_bytes"] < w.nbytes
                  and rec["resident_growth_bytes"] < w.nbytes,
                  f"({label}) the card's memory grew by "
                  f"{rec['setup_growth_bytes']} B over set-up and "
                  f"{rec['resident_growth_bytes']} B resident, not below "
                  f"the weights' {w.nbytes} B")
        print(f"weighted memory: ({label}) peak allocated over one batch "
              f"{rec['warmup_growth_bytes']} B, over the timed batches "
              f"{rec['loop_growth_bytes']} B beyond their samples, resident "
              f"growth {rec['resident_growth_bytes']} B, set-up "
              f"{rec['setup_growth_bytes']} B; on {card}", flush=True)
    check(not kept, f"weighted samples left uncompared: {sorted(kept)}")
    for a, b, what in (("k", "i", "exact"), ("l", "j", "rotation")):
        print(f"weighted: HOST/HBM SEPS for {what}: "
              f"{recs[a]['seps'] / recs[b]['seps']:.3f}; on {card}",
              flush=True)
    try:
        GraphSageSampler(topo, SIZES, device=dev, edge_weight=w,
                         sampling="rotation", shuffle="butterfly")
        refused = False
    except ValueError:
        refused = True
    check(refused, "butterfly with weighted rotation was not refused")

    edges = 0
    for label, mode, kw in WEIGHTED_ARMS:
        s = GraphSageSampler(topo, SIZES, mode=mode, seed=SEED + 1,
                             edge_weight=w_zero, with_eid=True, device=dev,
                             **kw)
        edges += check_weighted_contract(
            f"({label}) weighted with_eid", indptr, indices, w_zero,
            s.sample(batches[0]), kw["sampling"] != "exact")
        del s
    print(f"weighted check: one with_eid batch of each arm over the zeroed "
          f"weights: {edges} edges, each id a CSR slot of its target "
          "holding its source, none of weight 0, min(deg, k) draws per "
          "target of positive weight; butterfly with weighted rotation "
          "refused", flush=True)

    gathers = weight_gathers(dev, samplers, indptr, card, h2d, iters=20)
    rot_rows = samplers["j"]._rot
    del samplers

    feat, cls = make_train_data(dev, gen, nodes)
    labels = majority_labels(indptr, indices, cls, nodes)
    del cls
    order = torch.randperm(nodes, generator=gen, device=dev).to(torch.int32)
    gat = [gat_train(dev, topo, w, feat, labels, order, sampling, card)
           for sampling in ("exact", "rotation")]
    fused = gat_fused(dev, gen, nodes, indptr, indices, feat, labels,
                      gat_model(dev), card)
    steps = windowed_steps(dev, gen, nodes, indptr, indices, feat, labels,
                           rot_rows, card)
    walk_ms = walk_check(dev, gen, nodes, indptr, indices, card)
    host_l = {x: {k: v / WEIGHTED_BATCHES
                  for k, v in recs[x]["launches"].items() if v}
              for x in "kl"}
    return {"arms": list(recs.values()), "gat_train": gat,
            "gat_fused": fused, "windowed_steps": steps,
            "random_walk_ms": walk_ms}, gathers, host_l


# -- phase 9: device counters, rotation, ShardTensor --------------------------

METER_STEPS = 8                # metered and unmetered train steps each
METER_SAMPLER_BATCHES = 4      # metered and unmetered batches per arm
ROTATE_PAIRS = 4096


class deterministic:
    """torch's deterministic algorithms for a block: the model's
    ``index_add_`` (and its backward's) sums then run in one order
    instead of by atomics, so two runs can be compared bit for bit."""

    def __enter__(self):
        import torch
        self.fill = torch.utils.deterministic.fill_uninitialized_memory
        # nothing here reads memory it did not write: no NaN fill needed
        torch.utils.deterministic.fill_uninitialized_memory = False
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        import torch
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = self.fill


def sync_free(fn, what):
    """``fn()``, checked by the registry's no_host_sync check on the
    card (``op_lint.card_host_syncs``): a host synchronisation inside it
    fails the phase."""
    out, n = card_host_syncs(fn)
    check(n == 0, f"{what} synchronised with the host {n} time(s)")
    return out


def pcts(lat):
    srt = sorted(lat)
    return (srt[len(srt) // 2],
            srt[min(len(srt) - 1, math.ceil(0.99 * len(srt)) - 1)])


def nonzero(named):
    return {k: v for k, v in named.items() if v}


def fmt_ratios(d) -> str:
    return ", ".join(f"{k} {'n/a' if v is None else f'{v:.4f}'}"
                     for k, v in d.items() if v is not None)


def metered_serving(dev, ctx, card):
    """(a) A metered engine beside phase 6's unmetered one over the same
    store: the same batches and hop seeds, logits bit-equal, each
    batch's counters equal to phase 6's host reading, one batch under
    sync "error", and the counters' cost in device time."""
    import torch
    from quiver_tpu_torch import ServeEngine, metrics
    from quiver_tpu_torch.ops import kernels
    store, eng, stats = ctx["store"], ctx["eng"], ctx["stats"]
    requests, hop_seeds = ctx["requests"], ctx["hop_seeds"]
    meng = ServeEngine(copy.deepcopy(eng.model), None, ctx["topo"], store,
                       [SIZES], BATCH, fused_hot_hop=True,
                       fused_row_cap=ROW_CAP, collect_metrics=True,
                       seed=SEED, device=dev).warmup()
    t0 = time.perf_counter()
    with deterministic():
        for i, (ids, hs) in enumerate(zip(requests, hop_seeds)):
            check(same_bits(meng.run(ids, hop_seeds=hs),
                            eng.run(ids, hop_seeds=hs)),
                  f"metered serving: batch {i}'s logits differ from the "
                  "unmetered engine's")
    print(f"metrics serving: {len(requests)} batches, metered logits equal "
          "to the unmetered engine's bit for bit (deterministic "
          f"algorithms on for this check, {time.perf_counter() - t0:.2f} s)",
          flush=True)

    torch.cuda.synchronize()
    kernels.reset_launches()
    lat, vecs = {True: [], False: []}, []
    step_stats = metrics.StepStats()
    for ids, hs in zip(requests, hop_seeds):
        for metered, e in ((True, meng), (False, eng)):
            t0 = time.perf_counter()
            e.run(ids, hop_seeds=hs)
            torch.cuda.synchronize()
            lat[metered].append((time.perf_counter() - t0) * 1e3)
            if metered:
                vecs.append(meng.last_counters)
                step_stats.record_step(lat[True][-1] / 1e3,
                                       meng.last_counters)
    launches = dict(kernels.LAUNCHES)
    n = len(requests)
    check(launches["fused_sample_hop"] == 2 * (len(SIZES) - 1) * n
          and launches["fused_hot_hop"] == 2 * n
          and launches["gather_rows"] == 6 * n,
          f"metered serving launches (both engines) {launches}")
    got = torch.stack(vecs).cpu()
    for i, (c, s) in enumerate(zip(got.tolist(), stats)):
        want = {metrics.LOOKUP_CALLS: 1, metrics.HOT_ROWS: 0,
                metrics.COLD_ROWS: s["cold"],
                metrics.DEDUP_CALLS: 1, metrics.DEDUP_TOTAL: s["cold"],
                metrics.DEDUP_UNIQUE: s["unique_cold"],
                metrics.DEDUP_OVERFLOW: int(s["branch"] != "narrow"),
                metrics.FRONTIER_VALID: s["hot"] + s["cold"],
                metrics.FRONTIER_CAP: BATCH * math.prod(1 + k
                                                        for k in SIZES)}
        bad = {metrics.SLOT_NAMES[k]: (c[k], v) for k, v in want.items()
               if c[k] != v}
        rest = [metrics.SLOT_NAMES[k] for k in range(metrics.NUM_COUNTERS)
                if k not in want and c[k]]
        check(not bad and not rest, f"metered serving: batch {i}'s "
              f"counters (got, phase 6) {bad}, nonzero elsewhere {rest}")
    print(f"metrics serving: every batch's counters equal phase 6's host "
          f"reading (lookup 1, hot rows 0, cold rows = cold slots, dedup "
          f"total/unique/overflow, frontier valid/cap); batch 0: "
          f"{metrics.report(got[0])}", flush=True)
    sync_free(lambda: meng.run(requests[0], hop_seeds=hop_seeds[0]),
              "the metered serve step")
    print("metrics serving: one metered batch runs under the card's sync "
          "debug mode without a host synchronisation",
          flush=True)

    prof = {}
    for metered, e in ((True, meng), (False, eng)):
        st: dict = {}
        busy = device_profile(lambda: [e.run(ids, hop_seeds=hs) for ids, hs
                                       in zip(requests[:4], hop_seeds[:4])],
                              4, "metered batch" if metered
                              else "unmetered batch", top=4, stats=st)
        prof[metered] = dict(device_ms=busy, **st)
    snap = step_stats.snapshot()
    total = got.sum(0)
    valid = int(total[metrics.FRONTIER_VALID])
    hit = (valid - int(total[metrics.COLD_ROWS])) / valid
    p50m, p99m = pcts(lat[True])
    p50u, p99u = pcts(lat[False])
    cost = add_ms(prof[True]["device_ms"], None if prof[False]["device_ms"]
                  is None else -prof[False]["device_ms"])
    print(f"metrics serving: per batch p50/p99 metered {p50m:.3f}/{p99m:.3f}"
          f" ms, unmetered {p50u:.3f}/{p99u:.3f} ms (host clock, "
          f"interleaved); device ms per batch metered "
          f"{fmt_ms(prof[True]['device_ms'])}, unmetered "
          f"{fmt_ms(prof[False]['device_ms'])} (counters' cost "
          f"{fmt_ms(cost)}), idle share "
          f"{prof[True].get('idle_share', float('nan')):.3f} / "
          f"{prof[False].get('idle_share', float('nan')):.3f}, device "
          f"kernels per batch {prof[True].get('device_kernels_per_unit')}"
          f" / {prof[False].get('device_kernels_per_unit')}; StepStats p50 "
          f"{snap['wall']['p50_ms']} p99 {snap['wall']['p99_ms']} ms; on "
          f"{card}", flush=True)
    print(f"metrics serving: derive() over {n} batches: "
          f"{fmt_ratios(snap['derived'])}; this route's hit rate "
          f"(frontier_valid - cold_rows) / frontier_valid = {hit:.4f} "
          "(the store sees only the cold slots: hot_rows reads 0)",
          flush=True)
    return {"batches": n, "p50_ms": p50m, "p99_ms": p99m,
            "unmetered_p50_ms": p50u, "unmetered_p99_ms": p99u,
            "device_ms": prof[True]["device_ms"],
            "unmetered_device_ms": prof[False]["device_ms"],
            "idle_share": prof[True].get("idle_share"),
            "unmetered_idle_share": prof[False].get("idle_share"),
            "launches_both_engines": launches,
            "counters": nonzero(metrics.counters_dict(got)),
            "derived": snap["derived"], "hit_rate": hit,
            "per_batch": [nonzero(metrics.counters_dict(c)) for c in got]}


def metered_training(dev, gen, nodes, indptr, indices, card):
    """(b) Phase 5's configuration, metered and unmetered from copies of
    one state on the same batches and seeds: losses and parameters
    bit-equal, the frontier fill of each step, ``StepStats`` and a
    ``MetricsSink`` JSONL read back."""
    import torch
    from quiver_tpu_torch import GraphSAGE, metrics
    from quiver_tpu_torch.models.convert import (flax_to_state_dict,
                                                 random_flax_params)
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.parallel import build_train_step, init_state
    from quiver_tpu_torch.parallel import draw_step_seeds

    feat, labels = make_train_data(dev, gen, nodes)
    model = GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES), dropout=DROPOUT)
    model.load_state_dict(flax_to_state_dict(
        random_flax_params(DIM, HIDDEN, CLASSES, len(SIZES), seed=SEED)))
    model = model.to(dev)
    order = torch.randperm(nodes, generator=gen, device=dev).to(torch.int32)
    batches = [order[i * BATCH:(i + 1) * BATCH].contiguous()
               for i in range(METER_STEPS + 8)]
    ys = [labels[b.long()] for b in batches]
    host = torch.Generator().manual_seed(SEED + 5)
    rand = [draw_step_seeds(host, len(SIZES)) for _ in batches]
    runs = {}
    t0 = time.perf_counter()
    for metered in (True, False):
        m = copy.deepcopy(model)
        opt = torch.optim.Adam(m.parameters(), lr=LR, betas=(0.9, 0.999),
                               eps=1e-8)
        step = build_train_step(m, opt, SIZES, BATCH, fused_hot_hop=True,
                                fused_row_cap=ROW_CAP,
                                collect_metrics=metered)
        state, losses, vecs = init_state(m, opt), [], []
        with deterministic():
            for i in range(METER_STEPS):
                out = step(state, feat, None, indptr, indices, batches[i],
                           ys[i], *rand[i])
                state, loss = out[0], out[1]
                losses.append(loss)
                if metered:
                    vecs.append(out[2])
        runs[metered] = dict(step=step, state=state, losses=losses,
                             vecs=vecs, model=m)
    check(torch.equal(torch.stack(runs[True]["losses"]),
                      torch.stack(runs[False]["losses"])),
          "metered training: losses differ from the unmetered steps'")
    check(all(torch.equal(a, b) for a, b in zip(
        runs[True]["model"].parameters(), runs[False]["model"].parameters())),
          "metered training: parameters differ from the unmetered steps'")
    got = torch.stack(runs[True]["vecs"]).cpu()
    cap = BATCH * math.prod(1 + k for k in SIZES)
    fills = (got[:, metrics.FRONTIER_VALID].double() / cap).tolist()
    check(bool((got[:, metrics.FRONTIER_CAP] == cap).all())
          and int(got[:, [i for i in range(metrics.NUM_COUNTERS)
                          if i not in (metrics.FRONTIER_VALID,
                                       metrics.FRONTIER_CAP)]].abs().sum())
          == 0, f"metered training counters {got.tolist()}")
    losses = torch.stack(runs[True]["losses"]).tolist()
    print(f"metrics training: {METER_STEPS} steps metered and unmetered "
          f"from one state: losses and parameters equal bit for bit "
          f"(deterministic algorithms on for this check, "
          f"{time.perf_counter() - t0:.2f} s); losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; frontier_fill per "
          f"step {' '.join(f'{v:.4f}' for v in fills)}", flush=True)

    # timed, without deterministic algorithms: StepStats from the host
    # clock and the counters, a JSONL sink, and the device time per step
    step_stats = metrics.StepStats()
    lat = {True: [], False: []}
    torch.cuda.synchronize()
    kernels.reset_launches()
    for i in range(METER_STEPS, METER_STEPS + 4):
        for metered in (True, False):
            r = runs[metered]
            t0 = time.perf_counter()
            out = r["step"](r["state"], feat, None, indptr, indices,
                            batches[i], ys[i], *rand[i])
            torch.cuda.synchronize()
            lat[metered].append((time.perf_counter() - t0) * 1e3)
            r["state"] = out[0]
            if metered:
                step_stats.record_step(lat[True][-1] / 1e3, out[2])
    launches = dict(kernels.LAUNCHES)
    check(launches["fused_hot_hop"] == 8 and launches["gather_rows"] == 0,
          f"metered training launches (both) {launches}")
    sync_free(lambda: runs[True]["step"](
        runs[True]["state"], feat, None, indptr, indices,
        batches[METER_STEPS + 4], ys[METER_STEPS + 4],
        *rand[METER_STEPS + 4]), "the metered train step")
    prof = {}
    for metered in (True, False):
        r = runs[metered]

        def four():
            for i in range(METER_STEPS + 4, METER_STEPS + 8):
                r["state"] = r["step"](r["state"], feat, None, indptr,
                                       indices, batches[i], ys[i],
                                       *rand[i])[0]
        st: dict = {}
        busy = device_profile(four, 4, "metered step" if metered
                              else "unmetered step", top=4, stats=st)
        prof[metered] = dict(device_ms=busy, **st)
    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "chip_smoke_metrics.jsonl")
    for p in (path, path + ".1"):
        if os.path.exists(p):
            os.remove(p)
    with metrics.MetricsSink(path) as sink:
        rec = sink.emit_stats(step_stats)
    back = metrics.read_jsonl(path)
    check([r["kind"] for r in back] == ["meta", "step_stats"]
          and back[1]["counters"] == rec["counters"]
          and back[1]["steps"] == 4,
          f"the MetricsSink JSONL read back as {back}")
    snap = step_stats.snapshot()
    cost = add_ms(prof[True]["device_ms"], None if prof[False]["device_ms"]
                  is None else -prof[False]["device_ms"])
    print(f"metrics training: 4 timed steps each, step p50 metered "
          f"{pcts(lat[True])[0]:.3f} ms unmetered {pcts(lat[False])[0]:.3f}"
          f" ms (host clock, interleaved); StepStats p50 "
          f"{snap['wall']['p50_ms']} p99 {snap['wall']['p99_ms']} ms, "
          f"frontier_fill {snap['derived']['frontier_fill']:.4f}; device "
          f"ms per step metered {fmt_ms(prof[True]['device_ms'])}, "
          f"unmetered {fmt_ms(prof[False]['device_ms'])} (counters' cost "
          f"{fmt_ms(cost)}), idle share "
          f"{prof[True].get('idle_share', float('nan')):.3f} / "
          f"{prof[False].get('idle_share', float('nan')):.3f}; one metered "
          f"step under the card's sync debug mode without a host "
          f"synchronisation; {path} written and read back "
          f"({len(back)} records); on {card}", flush=True)
    return {"steps": METER_STEPS, "losses": losses, "frontier_fill": fills,
            "p50_ms": snap["wall"]["p50_ms"], "p99_ms": snap["wall"]["p99_ms"],
            "unmetered_p50_ms": pcts(lat[False])[0],
            "device_ms": prof[True]["device_ms"],
            "unmetered_device_ms": prof[False]["device_ms"],
            "idle_share": prof[True].get("idle_share"),
            "unmetered_idle_share": prof[False].get("idle_share"),
            "jsonl": path}


def metered_sampler(dev, topo, batches, card):
    """(c) Phase 7's arms (a) and (g), each sampler sampling the same
    batches from the same generator state metered and unmetered."""
    import torch
    from quiver_tpu_torch import GraphSageSampler, metrics
    out = {}
    arms = {label: (mode, kw) for label, mode, kw in SAMPLER_ARMS}
    for label in "ag":
        mode, kw = arms[label]
        s = GraphSageSampler(topo, SIZES, mode=mode, seed=SEED,
                             device=dev, **kw)
        s.sample(batches[0])                  # placement and warm-up
        res, lat = {}, {True: [], False: []}
        for metered in (True, False):
            s.collect_metrics = metered
            s.generator.manual_seed(SEED)
            res[metered] = []
            for b in batches[1:1 + METER_SAMPLER_BATCHES]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o = s.sample(b)
                torch.cuda.synchronize()
                lat[metered].append((time.perf_counter() - t0) * 1e3)
                res[metered].append((o, s.last_counters))
        for (x, c), (y, _) in zip(res[True], res[False]):
            check(same_sample(x, y), f"metered sampler ({label}) differs "
                  "from the unmetered samples")
            c = c.cpu()
            check(int(c[metrics.FRONTIER_VALID]) == int((x[0] >= 0).sum())
                  and int(c[metrics.FRONTIER_CAP]) == x[0].shape[0],
                  f"metered sampler ({label}) counters {c.tolist()}")
        s.collect_metrics = True
        sync_free(lambda: s.sample(batches[1]),
                  f"the metered sampler ({label})")
        fills = [metrics.derive(c)["frontier_fill"] for _, c in res[True]]
        out[label] = {"arm": arm_name(mode, kw), "frontier_fill": fills,
                      "ms_per_batch": sum(lat[True]) / len(lat[True]),
                      "unmetered_ms_per_batch":
                          sum(lat[False]) / len(lat[False])}
        print(f"metrics sampler: ({label}) {arm_name(mode, kw)}: "
              f"{METER_SAMPLER_BATCHES} batches metered equal to unmetered "
              f"bit for bit, frontier_fill "
              f"{' '.join(f'{v:.4f}' for v in fills)}, ms per batch metered "
              f"{out[label]['ms_per_batch']:.3f} unmetered "
              f"{out[label]['unmetered_ms_per_batch']:.3f} (host clock); "
              f"sample() under sync 'error' with counters; on {card}",
              flush=True)
        del s
    return out


def rotation_check(dev, gen, nodes, ctx, card):
    """(d) A full-width numpy-placement int8 store and a fused engine
    over it; 4,096 pairs rotated by phase 6's frontier counts; lookups
    and logits the same bits before, between rotation and refresh, and
    after."""
    import torch
    from quiver_tpu_torch import Feature, ServeEngine
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import fused
    topo, requests, hop_seeds = ctx["topo"], ctx["requests"], ctx["hop_seeds"]
    t0 = time.perf_counter()
    feat = torch.randn(nodes, DIM, generator=gen, device=dev).cpu()
    store = Feature(
        device_cache_size=(nodes // 4) * quant.row_bytes(DIM, "int8"),
        csr_topo=topo, dedup_cold=True, dtype_policy="int8",
        host_placement="numpy", device=dev).from_cpu_tensor(feat)
    del feat
    eng = ServeEngine(copy.deepcopy(ctx["eng"].model), None, topo, store,
                      [SIZES], BATCH, fused_hot_hop=True,
                      fused_row_cap=ROW_CAP, seed=SEED, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    hot = store.cache_rows
    counts = torch.zeros(nodes, dtype=torch.float32, device=dev)
    frontiers = []
    for ids, hs in zip(requests, hop_seeds):
        n_id, _, _ = fused.fused_multihop(
            eng._indptr, eng._indices, eng.pad_seeds(ids), store.device_part,
            SIZES, hs, ROW_CAP, store.feature_order, hot)
        counts.index_add_(0, n_id[n_id >= 0].long(),
                          torch.ones_like(n_id[n_id >= 0],
                                          dtype=torch.float32))
        frontiers.append(n_id)
    is_hot = store.feature_order.long() < hot
    promote = torch.topk(torch.where(is_hot, -1.0, counts),
                         ROTATE_PAIRS).indices
    demote = torch.topk(torch.where(is_hot, -counts, -float("inf")),
                        ROTATE_PAIRS).indices
    seen = (int(counts[promote].min()), int(counts[promote].max()),
            int(counts[demote].min()), int(counts[demote].max()))
    ids = frontiers[0]
    before = store.getitem_masked(ids)
    q, hs = requests[0], hop_seeds[0]
    with deterministic():
        logits = [eng.run(q, hop_seeds=hs)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = store.rotate_hot_set(promote.cpu(), demote.cpu())
    torch.cuda.synchronize()
    rotate_ms = (time.perf_counter() - t0) * 1e3
    check(res == {"rotated": ROTATE_PAIRS}, f"rotate_hot_set returned {res}")
    order = store.feature_order.long()
    check(bool((order[promote] < hot).all())
          and bool((order[demote] >= hot).all()),
          "the rotation did not swap the pairs' tiers")
    after = store.getitem_masked(ids)
    check(same_bits(before, after), "lookups at a served frontier differ "
          "across the rotation")
    with deterministic():
        logits.append(eng.run(q, hop_seeds=hs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.refresh_feature()
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    with deterministic():
        logits.append(eng.run(q, hop_seeds=hs))
    check(same_bits(logits[0], logits[1]) and same_bits(logits[0],
                                                         logits[2]),
          "engine logits differ across the rotation or the refresh")
    moved = int(((frontiers[0] >= 0) & torch.isin(
        frontiers[0], torch.cat([promote, demote]).to(torch.int32))).sum())
    print(f"rotation: numpy-placement int8 store, {hot} hot rows, built "
          f"with its fused engine in {setup_s:.2f} s; {ROTATE_PAIRS} pairs "
          f"(promoted nodes seen {seen[0]}..{seen[1]} times in phase 6's "
          f"16 frontiers, demoted {seen[2]}..{seen[3]}); rotate_hot_set "
          f"{rotate_ms:.3f} ms, refresh_feature {refresh_ms:.3f} ms (host "
          f"clock + synchronize); lookups at one served frontier "
          f"({ids.shape[0]} ids, {moved} slots on rotated nodes) equal bit "
          f"for bit before and after; engine logits equal before, between "
          f"rotation and refresh, and after; on {card}", flush=True)
    return {"pairs": ROTATE_PAIRS, "rotate_ms": rotate_ms,
            "refresh_ms": refresh_ms, "setup_s": setup_s,
            "frontier_ids": int(ids.shape[0]), "rotated_slots": moved,
            "promote_seen": seen[:2], "demote_seen": seen[2:]}


def shard_tensor_check(dev, gen, nodes, ctx, h2d, card, iters):
    """(e) ``ShardTensor`` over 100-dim product-scale features, 25% in
    the device group and the rest pinned, fp32 and int8: a lookup at a
    served frontier equal to the plain version (device rows indexed on
    the card, host rows indexed on the host and copied), one
    ``gather_rows_sharded`` launch over both groups, its own time against
    the copy-rate bound of the host rows."""
    import torch
    from quiver_tpu_torch import ShardTensor
    from quiver_tpu_torch.ops import kernels, quant
    from quiver_tpu_torch.ops.kernels import fused, gather
    eng, store = ctx["eng"], ctx["store"]
    ids, _, _ = fused.fused_multihop(
        eng._indptr, eng._indices, eng.pad_seeds(ctx["requests"][0]),
        store.device_part, SIZES, ctx["hop_seeds"][0], ROW_CAP,
        store.feature_order, store.cache_rows)
    feat = torch.randn(nodes, DIM, generator=gen, device=dev)
    n_dev = nodes // 4
    idl = ids.long()
    valid = (idl >= 0) & (idl < nodes)
    in_dev, in_host = valid & (idl < n_dev), valid & (idl >= n_dev)
    hids = torch.where(in_host, idl - n_dev, -1).to(torch.int32)
    out = {}
    for policy in (None, "int8"):
        name = policy or "fp32"
        t0 = time.perf_counter()
        st = ShardTensor(dtype_policy=policy, device=dev)
        st.append(feat[:n_dev], 0)
        st.append(feat[n_dev:], -1)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        host_tier = st._blocks[1]
        check(all(t.is_pinned() for t in quant.tier_parts(host_tier)
                  if t is not None), f"ShardTensor {name}: host group not "
              "pinned")
        kernels.reset_launches()
        got = sync_free(lambda: st[ids], f"ShardTensor {name} lookup")
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        check(launches["gather_rows_sharded"] == 1
              and sum(launches.values()) == 1,
              f"ShardTensor {name} launches {launches}")
        # a pinned group: packed rows through the host design's kernel,
        # raw rows through the design the dispatcher picks
        kname = gather.packed_kernel(True, sharded=True) if policy \
            else gather.raw_launch(st._tier, got)[2]
        made(kernels.PACKED_LAUNCHES, **({kname: 1} if policy else {}))
        made(kernels.RAW_LAUNCHES, **({} if policy else {kname: 1}))
        dev_rows = st.device_tensor_list[0]
        host_rows = st.cpu_tensor

        def plain():
            want = torch.zeros((ids.shape[0], DIM), device=dev)
            want[in_dev] = dev_rows[idl[in_dev]]
            want[in_host] = host_rows[(idl[in_host] - n_dev).cpu()].to(dev)
            return want
        check(same_bits(got, plain()), f"ShardTensor {name} lookup differs "
              "from its plain version")
        ms = cuda_ms(lambda: st[ids], iters)
        own = own_ms(lambda: st[ids], kname, iters)
        plain_ms = cuda_ms(plain, 3)
        b_ms, b_by, host_bytes, dev_bytes, distinct = host_gather_bound(
            host_tier, hids, h2d)
        share = "" if own is None else f" (bound / own {b_ms / own:.0%})"
        pinned = (nodes - n_dev) * (quant.packed_stride(DIM) if policy
                                    else 4 * DIM)
        print(f"shard_tensor {name}: {nodes - n_dev} pinned host rows "
              f"({pinned} B), "
              f"{n_dev} on the card, built in {build_s:.2f} s; lookup at a "
              f"served frontier ({ids.shape[0]} ids, {int(in_dev.sum())} "
              f"device rows, {int(in_host.sum())} host rows, {distinct} "
              f"distinct) equal to the plain version bit for bit, 1 "
              f"gather_rows_sharded launch ({kname}), no host "
              f"synchronisation; lookup "
              f"{ms:.4f} ms, kernel own (both groups) {fmt_ms(own)}{share}, "
              f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: {host_bytes}"
              f" B from the host at {h2d / 1e9:.2f} GB/s); on {card}",
              flush=True)
        out[name] = {"ms": ms, "own_ms": own, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "kernel": kname,
                     "host_bytes": host_bytes, "launches_per_lookup": 1,
                     "ids": int(ids.shape[0]),
                     "host_rows": int(in_host.sum()), "build_s": build_s}
        del st, dev_rows, host_rows, got, host_tier
    return out


def phase_metered(dev, gen, nodes, indptr, indices, card, ctx, topo,
                  batches, h2d):
    """Phase 9: the device counters through the serve and train steps
    and the sampler, a rotation of the hot set under a serving engine,
    and ``ShardTensor``."""
    secs, rec = {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        return out
    rec["serving"] = part("(a)", metered_serving, dev, ctx, card)
    rec["training"] = part("(b)", metered_training, dev, gen, nodes, indptr,
                           indices, card)
    rec["sampler"] = part("(c)", metered_sampler, dev, topo, batches, card)
    rot = part("(d)", rotation_check, dev, gen, nodes, ctx, card)
    st = part("(e)", shard_tensor_check, dev, gen, nodes, ctx, h2d, card, 10)
    print(f"phase 9: {sum(secs.values()):.2f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in secs.items()), flush=True)
    return rec, rot, st


HOST_EQUAL_STEPS = 8           # steps of each loop held bit for bit
HOST_STEPS = 32                # timed steps of each loop, in two halves
CPU_BATCHES = 16               # timed batches of the native engine
MIXED_BATCHES = 64             # the mixed sampler's job
INFER_BATCH, INFER_MAX_DEG = 4096, 256
INFER_CHECK = 4096             # nodes held to the plain mean


class _ListJob:
    """A ``SampleJob`` over fixed batches, shuffled by a seeded
    permutation of their order."""

    def __init__(self, batches, seed):
        import torch
        self.batches = list(batches)
        self.gen = torch.Generator().manual_seed(seed)
        self.order = list(range(len(self.batches)))

    def __getitem__(self, i):
        return self.batches[self.order[i]]

    def __len__(self):
        return len(self.batches)

    def shuffle(self):
        import torch
        self.order = torch.randperm(len(self.batches),
                                    generator=self.gen).tolist()


def host_training(dev, gen, nodes, indptr, indices, card, topo):
    """(a) The example's tiered path at phase 5's configuration over phase
    6's store: ``build_split_train_step``'s ``sample_fn`` for batch i+1
    and ``feature.prefetch(n_id)`` while ``step_fn`` runs batch i, beside
    the same loop serial. Returns its record and the context (d)-(f)
    use."""
    import torch
    from quiver_tpu_torch import Feature, GraphSAGE, GraphSageSampler
    from quiver_tpu_torch import tracing
    from quiver_tpu_torch.async_sampler import sample_ahead
    from quiver_tpu_torch.models.convert import (flax_to_state_dict,
                                                 random_flax_params)
    from quiver_tpu_torch.ops import kernels, quant
    from quiver_tpu_torch.parallel import build_split_train_step, init_state
    from quiver_tpu_torch.parallel.train import draw_int32

    t0 = time.perf_counter()
    feat, labels = make_train_data(dev, gen, nodes)
    store = Feature(
        device_cache_size=(nodes // 4) * quant.row_bytes(DIM, "int8"),
        csr_topo=topo, dedup_cold=True, dtype_policy="int8",
        host_placement="offload", device=dev).from_cpu_tensor(feat.cpu())
    torch.cuda.synchronize()
    check(store._host_offload.data.is_pinned(), "the cold tier is not "
          "pinned")
    build_s = time.perf_counter() - t0
    model0 = GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES), dropout=DROPOUT)
    model0.load_state_dict(flax_to_state_dict(
        random_flax_params(DIM, HIDDEN, CLASSES, len(SIZES), seed=SEED)))
    model0 = model0.to(dev)
    order = torch.randperm(nodes, generator=gen, device=dev).to(torch.int32)
    n_b = HOST_EQUAL_STEPS + HOST_STEPS + 5
    batches = [order[i * BATCH:(i + 1) * BATCH].contiguous()
               for i in range(n_b)]
    ys = [labels[b.long()] for b in batches]
    host = torch.Generator().manual_seed(SEED + 10)
    seeds = [draw_int32(host, 2) for _ in batches]   # (sample, dropout)

    def trainer(model):
        opt = torch.optim.Adam(model.parameters(), lr=LR,
                               betas=(0.9, 0.999), eps=1e-8)
        sample_fn, step_fn = build_split_train_step(model, opt, SIZES,
                                                    BATCH)
        return dict(state=init_state(model, opt), sample_fn=sample_fn,
                    step_fn=step_fn, losses=[], lat=[], edges=[], parts=[])

    def serial(run, steps):
        for i in steps:
            t = time.perf_counter()
            n_id, adjs = run["sample_fn"](indptr, indices, batches[i],
                                          seeds[i][0])
            t1 = time.perf_counter()
            x = store[n_id]
            t2 = time.perf_counter()
            run["state"], loss = run["step_fn"](
                run["state"], x, adjs, ys[i], seeds[i][1])
            t3 = time.perf_counter()
            run["losses"].append(float(loss))
            t4 = time.perf_counter()
            run["lat"].append((t4 - t) * 1e3)
            # host ms: sample_fn, lookup, step_fn (dispatch), the wait
            run["parts"].append((1e3 * (t1 - t), 1e3 * (t2 - t1),
                                 1e3 * (t3 - t2), 1e3 * (t4 - t3)))
            run["edges"].append(sum(a.mask.sum() for a in adjs))

    def buffered(run, steps):
        def stage(i):
            t = time.perf_counter()
            n_id, adjs = run["sample_fn"](indptr, indices, batches[i],
                                          seeds[i][0])
            t1 = time.perf_counter()
            fut = store.prefetch(n_id)
            return adjs, fut, ys[i], (1e3 * (t1 - t),
                                      1e3 * (time.perf_counter() - t1))

        t = time.perf_counter()
        nxt = stage(steps[0])
        for j, i in enumerate(steps):
            adjs, fut, y, _ = nxt
            staged = (0.0, 0.0)
            if j + 1 < len(steps):
                nxt = stage(steps[j + 1])
                staged = nxt[3]
            t2 = time.perf_counter()
            x = fut.result()
            t3 = time.perf_counter()
            run["state"], loss = run["step_fn"](run["state"], x, adjs, y,
                                                seeds[i][1])
            t4 = time.perf_counter()
            run["losses"].append(float(loss))
            now = time.perf_counter()
            run["lat"].append((now - t) * 1e3)
            # host ms: sample_fn and prefetch of batch i+1, the wait for
            # batch i's rows, step_fn (dispatch), the wait for its loss
            run["parts"].append(staged + (1e3 * (t3 - t2), 1e3 * (t4 - t3),
                                          1e3 * (now - t4)))
            t = now
            run["edges"].append(sum(a.mask.sum() for a in adjs))

    runs = {"serial": trainer(copy.deepcopy(model0)),
            "buffered": trainer(copy.deepcopy(model0))}
    loops = {"serial": serial, "buffered": buffered}
    eq = range(HOST_EQUAL_STEPS)
    with deterministic():
        for name in ("serial", "buffered"):
            loops[name](runs[name], eq)
    torch.cuda.synchronize()
    for name in runs:
        for k in ("lat", "edges", "parts"):
            runs[name][k].clear()
    check(runs["serial"]["losses"] == runs["buffered"]["losses"],
          f"buffered losses {runs['buffered']['losses']} differ from the "
          f"serial loop's {runs['serial']['losses']}")
    check(all(same_bits(a, b) for a, b in zip(
        runs["serial"]["state"].model.parameters(),
        runs["buffered"]["state"].model.parameters())),
          "buffered parameters differ from the serial loop's")
    print(f"pipeline: {HOST_EQUAL_STEPS} steps double-buffered and serial "
          f"from copies of one state on the same batches and seeds "
          f"(torch's deterministic algorithms on): losses and parameters "
          f"equal bit for bit; losses "
          f"{' '.join(f'{v:.4f}' for v in runs['serial']['losses'])}",
          flush=True)

    # timed, in turns: serial, buffered, buffered, serial
    half = HOST_STEPS // 2
    first = range(HOST_EQUAL_STEPS, HOST_EQUAL_STEPS + half)
    second = range(HOST_EQUAL_STEPS + half, HOST_EQUAL_STEPS + HOST_STEPS)
    launches = {}
    tracing.clear()
    tracing.enable()             # the worker's pipeline.* spans
    for name, steps in (("serial", first), ("buffered", first),
                        ("buffered", second), ("serial", second)):
        torch.cuda.synchronize()
        kernels.reset_launches()
        loops[name](runs[name], steps)
        torch.cuda.synchronize()
        for k, v in kernels.LAUNCHES.items():
            launches.setdefault(name, {}).setdefault(k, 0)
            launches[name][k] += v
    tracing.disable()
    spans = {}
    for r in tracing.records():
        spans.setdefault(r[0], []).append(1e3 * r[3])
    tracing.clear()
    check(len(spans.get("pipeline.execute", [])) == HOST_STEPS,
          f"pipeline spans {[(k, len(v)) for k, v in spans.items()]}")
    rec = {}
    for name, run in runs.items():
        lat = run["lat"]
        edges = int(torch.stack(run["edges"]).sum())
        p50, p99 = pcts(lat)
        losses = run["losses"]
        first8, last8 = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
        check(all(math.isfinite(v) for v in losses), f"{name} losses")
        check(last8 < 0.7 * first8, f"{name} loss did not fall: first 8 "
              f"mean {first8}, last 8 mean {last8}")
        per = {k: v / HOST_STEPS for k, v in launches[name].items()}
        check(per["gather_rows"] == 3 and per["gather_elems"] == 0
              and per["fused_hot_hop"] == per["fused_sample_hop"] == 0,
              f"{name} launches per step {per}")
        rec[name] = dict(p50_ms=p50, p99_ms=p99,
                         edges_per_s=edges / (sum(lat) / 1e3),
                         edges_per_step=edges / HOST_STEPS,
                         launches_per_step=per, losses=losses)
        print(f"pipeline: {name}: {HOST_STEPS} steps of {BATCH} seeds, "
              f"fanout {SIZES}, GraphSAGE {DIM}->{HIDDEN}->{HIDDEN}->"
              f"{CLASSES}, dropout {DROPOUT}, Adam lr {LR}, int8 tiered "
              f"store (25% hot, dedup_cold, cold tier packed and pinned): "
              f"step p50 {p50:.3f} ms p99 {p99:.3f} ms (host clock, "
              f"float(loss) each step), {edges / HOST_STEPS:.0f} sampled "
              f"edges per step = {rec[name]['edges_per_s']:.6g} sampled "
              f"edges/s; gather_rows launches per step "
              f"{per['gather_rows']:g}; loss first-8 mean {first8:.4f}, "
              f"last-8 mean {last8:.4f}; on {card}", flush=True)
    prof_steps = range(HOST_EQUAL_STEPS + HOST_STEPS,
                       HOST_EQUAL_STEPS + HOST_STEPS + 4)
    for name in ("serial", "buffered"):
        st: dict = {}
        busy = device_profile(lambda: loops[name](runs[name], prof_steps),
                              4, f"{name} step", top=6, stats=st)
        rec[name].update(device_ms=busy, **st)
        print(f"pipeline: {name}: device time per step {fmt_ms(busy)}, "
              f"idle share {st.get('idle_share', float('nan')):.3f}, on "
              f"{card}", flush=True)
    for name in ("serial", "buffered"):
        parts = runs[name]["parts"][:HOST_STEPS]
        rec[name]["host_ms_parts"] = [sorted(p[k] for p in parts)[
            len(parts) // 2] for k in range(len(parts[0]))]
    lookup = sorted(spans["pipeline.execute"])[HOST_STEPS // 2]
    qwait = sorted(spans["pipeline.queue_wait"])[HOST_STEPS // 2]
    rec["buffered"]["worker_lookup_ms"] = lookup
    print("pipeline: host ms a step (medians, host clock): serial: "
          "sample_fn {:.3f}, lookup {:.3f}, step_fn {:.3f}, float(loss) "
          "wait {:.3f}; buffered, main thread: sample_fn {:.3f}, prefetch "
          "{:.3f}, result() wait {:.3f}, step_fn {:.3f}, float(loss) wait "
          "{:.3f}".format(*rec["serial"]["host_ms_parts"],
                          *rec["buffered"]["host_ms_parts"])
          + f"; worker: lookup {lookup:.3f} (pipeline.execute spans), "
          f"queue wait {qwait:.3f}; on {card}", flush=True)
    gain = rec["serial"]["p50_ms"] / rec["buffered"]["p50_ms"]
    print(f"pipeline: double-buffered step p50 {rec['buffered']['p50_ms']:.3f}"
          f" ms against serial {rec['serial']['p50_ms']:.3f} ms ({gain:.3f}x)"
          f"; prefetch pipeline stats {store._pool.stats()}; store built in "
          f"{build_s:.2f} s; on {card}", flush=True)

    # sample_ahead over an HBM sampler: the serial results, in order
    ahead_b = batches[:8]
    s1 = GraphSageSampler(topo, SIZES, seed=SEED, device=dev)
    s2 = GraphSageSampler(topo, SIZES, seed=SEED, device=dev)
    want = [s1.sample(b) for b in ahead_b]
    got = list(sample_ahead(s2, ahead_b, feature=store, depth=2))
    check(len(got) == len(want) and all(same_sample(a, b)
                                        for a, b in zip(want, got)),
          "sample_ahead differs from serial sample()")
    print(f"pipeline: sample_ahead over GraphSageSampler(HBM) yields the "
          f"{len(got)} serial sample() results in order, bit for bit "
          "(stage_frontier: no disk tier, None)", flush=True)
    ctx = dict(store=store, feat=feat, runs=runs, batches=batches, ys=ys,
               seeds=seeds, trainer=trainer, serial=serial)
    return rec, ctx


def cpu_engine(dev, gen, nodes, indptr, indices, deg, card, topo, batches):
    """(b) ``GraphSageSampler(mode="CPU")`` at the graph of phase 1, its
    batches held to the contract, and one hop held bit for bit to the
    plain numpy version."""
    import numpy as np
    import torch
    from quiver_tpu_torch import GraphSageSampler, native

    t0 = time.perf_counter()
    s = GraphSageSampler(topo, SIZES, mode="CPU", seed=SEED, device=dev)
    s.lazy_init_quiver()
    native.get_lib()
    copy_s = time.perf_counter() - t0
    warm = s.sample(batches[0])
    torch.cuda.synchronize()
    del warm
    outs = []
    t0 = time.perf_counter()
    for b in batches[1:1 + CPU_BATCHES]:
        outs.append(s.sample(b))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    edges = int(sum(a.mask.sum() for o in outs for a in o[2]))
    hw = native.get_lib().qt_hardware_threads()
    # the same batches again with edge ids (CSR slots): the same picks,
    # held to the contract
    se = GraphSageSampler(topo, SIZES, mode="CPU", seed=SEED, device=dev,
                          with_eid=True)
    se.sample(batches[0])
    checked = 0
    for o, b in zip(outs, batches[1:1 + CPU_BATCHES]):
        oe = se.sample(b)
        check(torch.equal(o[0], oe[0]) and all(
            torch.equal(x.edge_index, y.edge_index)
            for x, y in zip(o[2], oe[2])), "CPU mode with edge ids drew "
              "other picks")
        checked += check_eid_contract("cpu_sampler", indptr, indices, oe)
    # one hop of 1,024 seeds bit for bit against the plain version
    ip, ix = (t.numpy() for t in s._placed)
    hop = make_seeds(dev, gen, nodes, BATCH, deg).cpu().numpy()
    w = example_weights(indices, deg).cpu().numpy()
    t1 = time.perf_counter()
    for name, run, plain in (
            ("uniform", lambda: native.cpu_sample_layer(
                ip, ix, hop, SIZES[0], seed=77, with_slots=True),
             lambda: native.sample_layer_plain(
                ip, ix, hop, SIZES[0], seed=77, with_slots=True)),
            ("weighted", lambda: native.cpu_sample_layer_weighted(
                ip, ix, w, hop, SIZES[0], seed=77, row_cap=ROW_CAP,
                with_slots=True),
             lambda: native.sample_layer_weighted_plain(
                ip, ix, w, hop, SIZES[0], seed=77, row_cap=ROW_CAP,
                with_slots=True))):
        a, b = run(), plain()
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"native {name} hop differs from its plain version")
    plain_s = time.perf_counter() - t1
    rec = dict(seps=edges / wall, ms_per_batch=wall * 1e3 / CPU_BATCHES,
               edges_per_batch=edges / CPU_BATCHES, hardware_threads=hw,
               threads_per_call=[native.threads_used(0, BATCH * math.prod(
                   1 + k for k in SIZES[:i])) for i in range(len(SIZES))],
               host_copy_s=copy_s, edges_checked=checked)
    print(f"cpu_sampler: GraphSageSampler(mode='CPU'), graph {nodes} nodes "
          f"{indices.numel()} edges copied to the host once in "
          f"{copy_s:.2f} s; {CPU_BATCHES} batches of {BATCH}, fanout "
          f"{SIZES}: {rec['ms_per_batch']:.3f} ms per batch (host clock + "
          f"synchronize, the batch on the card), {edges / CPU_BATCHES:.0f} "
          f"sampled edges per batch, {rec['seps']:.6g} sampled edges/s; "
          f"engine threads per hop {rec['threads_per_call']} of {hw} "
          f"hardware threads; on {card}", flush=True)
    print(f"cpu_sampler: every batch again with edge ids: the same picks, "
          f"{checked} edges held to the contract (CSR slot of the target "
          f"holding the source, min(deg, k) per target, distinct); one hop "
          f"of {BATCH} seeds (hubs, isolated rows, -1 seeds), uniform and "
          f"weighted (row_cap {ROW_CAP}) with slots, equal to the plain "
          f"numpy version bit for bit ({plain_s:.2f} s)", flush=True)
    return rec


def mixed_sampler(dev, card, topo, order, arms):
    """(c) ``MixedGraphSageSampler`` over a job of 64 batches, the device
    side in HBM and then HOST mode."""
    import torch
    from quiver_tpu_torch import MixedGraphSageSampler
    from quiver_tpu_torch.ops import kernels

    job_b = [order[i * BATCH:(i + 1) * BATCH].contiguous()
             for i in range(MIXED_BATCHES)]
    by_first = {int(b[0]): b for b in job_b}
    rec = {}
    for mode in ("HBM", "HOST"):
        m = MixedGraphSageSampler(_ListJob(job_b, SEED), SIZES, topo,
                                  device=dev, device_mode=mode, seed=SEED,
                                  with_eid=True)
        m.device_sampler.lazy_init_quiver()
        m.device_sampler._ensure_exact_rows()
        m.device_sampler._exact_hub_frac()
        m.cpu_sampler.lazy_init_quiver()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs = list(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        elems = nonzero(kernels.ELEMS_LAUNCHES)
        m.close()
        seen = set()
        edges = checked = 0
        for o in outs:
            first = int(o[0][0])
            check(first in by_first and first not in seen and torch.equal(
                o[0][:BATCH], by_first[first]), f"mixed {mode}: a batch "
                  "yielded twice or not from the job")
            seen.add(first)
            checked += check_eid_contract(f"mixed {mode}", topo.indptr,
                                          topo.indices, o)
            edges += int(sum(a.mask.sum() for a in o[2]))
        check(len(seen) == MIXED_BATCHES, f"mixed {mode}: {len(seen)} "
              f"batches of {MIXED_BATCHES}")
        host_reads = launches["gather_elems"] + launches["gather_rows"]
        check((host_reads > 0) == (mode == "HOST")
              and ("gather_segments_kernel" in elems) == (mode == "HOST"),
              f"mixed {mode}: launches {launches} {elems}")
        rec[mode] = dict(seps=edges / wall, ms=wall * 1e3,
                         tasks=dict(m.tasks),
                         device_ema_ms=1e3 * m._device_time,
                         cpu_ema_ms=None if m._cpu_time is None
                         else 1e3 * m._cpu_time,
                         launches=launches, elems_launches=elems,
                         num_workers=m.num_workers)
        share = m.tasks["cpu"] / MIXED_BATCHES
        arm = {"HBM": "b", "HOST": "g"}[mode]
        print(f"mixed: device_mode {mode}: {MIXED_BATCHES} batches of "
              f"{BATCH}, each once, {checked} edges held to the contract; "
              f"{wall * 1e3:.1f} ms, {edges / wall:.6g} sampled edges/s "
              f"(with edge ids); device took {m.tasks['device']}, the "
              f"native engine {m.tasks['cpu']} ({share:.3f}) on "
              f"{m.num_workers} worker threads; EMA per task device "
              f"{rec[mode]['device_ema_ms']:.3f} ms, host "
              f"{fmt_ms(rec[mode]['cpu_ema_ms'])}; launches "
              f"{ {k: v for k, v in launches.items() if v} } {elems}; "
              f"phase 7 "
              f"device-only arms: (a) {arms['a']['seps']:.6g}, ({arm}) "
              f"{arms[arm]['seps']:.6g} sampled edges/s; on {card}",
              flush=True)
    return rec


def host_inference(dev, gen, nodes, indptr, indices, deg, card, ctx):
    """(d) ``layerwise_inference`` of (a)'s buffered model over every
    node, 4,096 nodes (hubs among them) of each layer held to a plain
    full-neighbourhood mean."""
    import torch
    from quiver_tpu_torch import inference

    model = ctx["runs"]["buffered"]["state"].model
    model.eval()
    base = inference.sage_apply_layer(model)
    inputs = {1: [], 2: []}            # each layer's input, batch by batch

    def apply(i, x_self, mean):
        if i in inputs:
            inputs[i].append(x_self)
        return base(i, x_self, mean)

    ip64 = indptr.long()
    host_deg = deg.cpu()
    windows = sum(max(1, -(-int(host_deg[lo:lo + INFER_BATCH].max())
                           // INFER_MAX_DEG))
                  for lo in range(0, nodes, INFER_BATCH))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = inference.layerwise_inference(
            apply, ip64, indices, ctx["feat"], len(SIZES),
            batch_size=INFER_BATCH, max_degree=INFER_MAX_DEG)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(tuple(out.shape) == (nodes, CLASSES)
          and bool(torch.isfinite(out).all()), "inference output")
    xs = [ctx["feat"]] + [torch.cat(inputs[i])[:nodes] for i in (1, 2)]
    del inputs
    top = torch.argsort(deg, descending=True)[:64]
    iso = torch.nonzero(deg == 0)[:16, 0]
    rest = torch.randperm(nodes, generator=gen, device=dev)
    rest = rest[~torch.isin(rest, torch.cat([top, iso]))]
    nodes_c = torch.cat([top, iso, rest])[:INFER_CHECK]
    d = (ip64[nodes_c + 1] - ip64[nodes_c])
    seg = torch.repeat_interleave(torch.arange(nodes_c.numel(), device=dev),
                                  d)
    starts = torch.repeat_interleave(ip64[nodes_c], d)
    offs = torch.arange(seg.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(d, 0) - d, d)
    src = indices[(starts + offs)].long()
    worst = []
    with torch.no_grad():
        for layer in range(len(SIZES)):
            x = xs[layer]
            agg = torch.zeros((nodes_c.numel(), x.shape[1]), device=dev) \
                .index_add_(0, seg, x[src])
            mean = agg / d.clamp(min=1).to(x.dtype)[:, None]
            want = base(layer, x[nodes_c], mean)
            got = (xs[layer + 1] if layer + 1 < len(SIZES) else out)[nodes_c]
            worst.append(max_abs(got, want))
    check(max(worst) <= 1e-4, f"inference: layers differ from the plain "
          f"mean by {worst}")
    rec = dict(seconds=secs, windows_per_layer=windows,
               batches_per_layer=-(-nodes // INFER_BATCH),
               max_abs_err=worst, checked_nodes=int(nodes_c.numel()),
               max_degree_checked=int(d.max()))
    print(f"inference: layerwise_inference of the trained model over "
          f"{nodes} nodes, 3 layers, batch {INFER_BATCH}, max_degree "
          f"{INFER_MAX_DEG}: {secs:.2f} s, {rec['batches_per_layer']} "
          f"batches and {windows} windows per layer; {INFER_CHECK} nodes "
          f"(the 64 largest degrees up to {int(d.max())}, isolated rows) "
          f"of each layer within {max(worst):.3g} of a plain "
          f"full-neighbourhood mean (index_add_ over the CSR; tolerance "
          f"1e-4); on {card}", flush=True)
    return rec


def host_checkpoint(dev, indptr, indices, card, ctx):
    """(e) ``save_state``/``restore_state`` of (a)'s buffered state under
    ``build/``; one more step from the original and from the restored
    state agree bit for bit."""
    import torch
    from quiver_tpu_torch import GraphSAGE, checkpoint

    run = ctx["runs"]["buffered"]
    path = os.path.join("build", "chip_smoke_checkpoint")
    t0 = time.perf_counter()
    checkpoint.save_state(path, run["state"], step=run["state"].step)
    save_s = time.perf_counter() - t0
    fresh = ctx["trainer"](GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES),
                                     dropout=DROPOUT).to(dev))
    t0 = time.perf_counter()
    fresh["state"] = checkpoint.restore_state(path, fresh["state"],
                                              step=run["state"].step)
    load_s = time.perf_counter() - t0
    check(fresh["state"].step == run["state"].step, "restored step count")
    i = len(ctx["batches"]) - 1
    with deterministic():
        for r in (run, fresh):
            ctx["serial"](r, [i])
    check(run["losses"][-1] == fresh["losses"][-1] and all(
        same_bits(a, b) for a, b in zip(run["state"].model.parameters(),
                                        fresh["state"].model.parameters())),
          "a step from the restored state differs from the original's")
    print(f"checkpoint: save_state {save_s:.2f} s, restore_state "
          f"{load_s:.2f} s ({path}, step {run['state'].step}); one more "
          f"step from the original and the restored state: loss "
          f"{run['losses'][-1]:.6f} and parameters equal bit for bit; on "
          f"{card}", flush=True)
    return dict(save_s=save_s, restore_s=load_s, step=run["state"].step)


def host_fault(card, ctx):
    """(f) An injected ``"pipeline.worker"`` fault: the worker dies before
    it claims the queued lookup, the watchdog restarts it, and the
    lookup's ``Future.result()`` gives its rows; a stage that raises
    surfaces through ``Future.result()`` and ``pipelined``; closed, the
    pipeline leaves no thread."""
    import threading
    import torch
    from quiver_tpu_torch import faults
    from quiver_tpu_torch.pipeline import Pipeline, pipelined

    store = ctx["store"]
    ids = ctx["batches"][0]
    want = store[ids]
    name = "chip-smoke-fault"
    p = Pipeline(depth=2, name=name)
    plan = faults.install(faults.FaultPlan(seed=SEED, rules={
        "pipeline.worker": faults.FaultRule("error", exc="runtime",
                                            times=1)}))
    try:
        fut = p.submit(store.__getitem__, ids)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and p._box["thread"].is_alive():
            time.sleep(0.005)
        died = not p._box["thread"].is_alive()
        check(died and not fut.done(), "the injected fault did not stop "
              "the worker before its item")
        check(p.ensure_worker(), "the watchdog did not restart the worker")
        rows = fut.result(timeout=60)
    finally:
        faults.disarm()
    check(torch.equal(rows, want), "the lookup after the restart differs")
    # ids that cannot become a tensor: the lookup raises before it
    # launches anything
    bad_ids = ["not", "ids"]
    bad = p.submit(store.__getitem__, bad_ids)
    try:
        bad.result(timeout=60)
        raised = None
    except TypeError as e:
        raised = type(e).__name__
    check(raised is not None, "a failing stage did not surface")
    try:
        list(pipelined(store.__getitem__, [ids, bad_ids], name=name))
        check(False, "pipelined swallowed a failing stage")
    except TypeError:
        pass
    stats = p.stats()
    p.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            t.name == name for t in threading.enumerate()):
        time.sleep(0.01)
    left = [t.name for t in threading.enumerate() if t.name == name]
    check(p.closed and not left, f"threads left after close: {left}")
    check(stats["worker_restarts"] == 1 and plan.counts()[
        "pipeline.worker"]["fires"] == 1, f"fault stats {stats}")
    print(f"pipeline: injected 'pipeline.worker' fault (faults.FaultPlan): "
          f"the worker died before claiming the queued lookup, "
          f"ensure_worker() restarted it, Future.result() gave its rows "
          f"bit for bit (worker_restarts {stats['worker_restarts']}); a "
          f"failing lookup surfaced through Future.result() ({raised}) and "
          f"through pipelined; closed with no worker thread left",
          flush=True)
    return dict(worker_restarts=stats["worker_restarts"],
                stage_error=raised)


def phase_host_side(dev, gen, nodes, indptr, indices, deg, card, topo,
                    batches, arms):
    """Phase 10: the host side of training (module doc)."""
    import torch
    secs, rec = {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        return out
    rec["pipeline"], ctx = part("(a)", host_training, dev, gen, nodes,
                                indptr, indices, card, topo)
    rec["cpu_sampler"] = part("(b)", cpu_engine, dev, gen, nodes, indptr,
                              indices, deg, card, topo, batches)
    order = torch.randperm(nodes, generator=gen, device=dev) \
        .to(torch.int32)
    rec["mixed"] = part("(c)", mixed_sampler, dev, card, topo, order, arms)
    rec["inference"] = part("(d)", host_inference, dev, gen, nodes, indptr,
                            indices, deg, card, ctx)
    rec["checkpoint"] = part("(e)", host_checkpoint, dev, indptr, indices,
                             card, ctx)
    rec["fault"] = part("(f)", host_fault, card, ctx)
    ctx["store"].close()
    print(f"phase 10: {sum(secs.values()):.2f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in secs.items()), flush=True)
    rec["seconds"] = secs
    return rec


DISK_WARMUP, DISK_TIMED, DISK_PROFILED = 4, 16, 4
DISK_RING_ROWS = 1 << 20       # slots of the staging ring, (a) and (b)
DISK_FENCE_LOOKUPS = 16
DISK_AHEAD_BATCHES = 8
PROBE_ROWS = 50_000            # cold rows the engine probe stages
COLD_BATCHES = 16              # (b): batches through sample_ahead
# the prefetcher's workers and queue depth; the arms stage through the
# mmap engine (the module doc, phase 11)
DISK_PREFETCH = dict(workers=2, io_qd=16)
DISK_ARMS = [("off", None, False),
             ("on decoded", dict(decode_staged=True), False),
             ("on packed", dict(decode_staged=False), False),
             ("on packed evicted", dict(decode_staged=False), True)]


def fs_type(path) -> str:
    """The file system type of ``path`` and its mount point, from
    ``/proc/mounts`` (the longest mount point that holds it)."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as fh:
            for ln in fh:
                parts = ln.split()
                if len(parts) < 3:
                    continue
                mnt = parts[1]
                inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
                if inside and len(mnt) > len(best):
                    best, kind = mnt, parts[2]
    except OSError:
        pass
    return f"{kind} at {best or '?'}"


def disk_reference(store, plain, n_id):
    """The lookup's plain version: every row decoded on the host by
    ``read_mmap`` (``plain``, all file rows, on the card), taken at the
    ids' storage rows, -1 ids giving the masked lookup's zero rows."""
    import torch
    valid = n_id >= 0
    t = torch.where(valid, store.feature_order[n_id.clamp(min=0).long()], 0)
    return plain.index_select(0, t.long()) * valid.to(plain.dtype)[:, None]


def ring_slots(store, n_id):
    """The ring gather's ids for one masked lookup, read off the ring as
    it stands: the slot of each staged cold row, -1 elsewhere."""
    import numpy as np
    import torch
    ring = store._cold_prefetch._ring
    valid = n_id >= 0
    t = torch.where(valid, store.feature_order[n_id.clamp(min=0).long()],
                    -1).cpu().numpy()
    pos = np.flatnonzero(t >= store.cache_rows)
    slots = np.full(t.shape[0], -1, np.int32)
    slots[pos] = ring._slot_of[store.disk_map[t[pos]]]
    return torch.from_numpy(slots).to(n_id.device)


def ring_gather_timing(store, n_id, h2d, name):
    """``gather_rows`` over the staging ring at one lookup's slots: equal
    to its plain version, its wrapper, own and plain times, and its bound
    (the distinct ring rows' bytes read at the measured pinned copy rate,
    or the device bytes at 3.35 TB/s)."""
    import torch
    from quiver_tpu_torch.ops import kernels, quant
    from quiver_tpu_torch.ops.kernels import gather
    ring = store._cold_prefetch._ring
    slots = ring_slots(store, n_id)
    n = slots.shape[0]
    got = torch.zeros((n, DIM), device=slots.device)
    want = torch.zeros((n, DIM), device=slots.device)
    if quant.is_quantized(ring.table):          # the pinned ring
        kernel = "gather_rows_packed_kernel"
        made_once(kernels.PACKED_LAUNCHES,
                  lambda: gather.gather_rows(ring.table, slots, out=got),
                  kernel, f"ring gather ({name})")
    else:
        kernel = gather.raw_launch(ring.table, got)[2]
        made_once(kernels.RAW_LAUNCHES,
                  lambda: gather.gather_rows(ring.table, slots, out=got),
                  kernel, f"ring gather ({name})")
    gather.gather_rows_plain(ring.table, slots, out=want)
    check(same_bits(got, want), f"ring gather ({name}) differs from its "
          "plain version")
    ms = cuda_ms(lambda: gather.gather_rows(ring.table, slots, out=got), 20)
    # the profiler drops a kernel event now and then: a window that
    # keeps at least half of them gives their median
    durs = sorted(kernel_events(lambda: [gather.gather_rows(
        ring.table, slots, out=got) for _ in range(20)], kernel))
    own = durs[len(durs) // 2] if len(durs) >= 10 else None
    plain_ms = cuda_ms(lambda: gather.gather_rows_plain(ring.table, slots,
                                                        out=want), 3)
    b_ms, b_by, host_b, dev_b, distinct = host_gather_bound(ring.table,
                                                            slots, h2d)
    share = "" if own is None else f" (bound / own {b_ms / own:.0%})"
    print(f"disk ring gather_rows {name}: ids={n} staged hits={distinct} "
          f"({quant.row_read_bytes(ring.table)} B a row, {kernel}): wrapper "
          f"{ms:.4f} ms, kernel own {fmt_ms(own)}{share}, plain "
          f"{plain_ms:.4f} ms, reads {host_b} B of ring rows at the "
          f"measured {h2d / 1e9:.2f} GB/s pinned-to-device copy rate and "
          f"moves {dev_b} B on the card: bound {b_ms:.4f} ms ({b_by}), "
          "exact", flush=True)
    return {"ms": ms, "own_ms": own, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": "bytes", "library_ms": None,
            "max_abs_err": 0.0, "ids": n, "staged_hits": distinct,
            "ring_bytes": host_b, "kernel": kernel}


def staging_probe(store, path, sample, n_id, local, card):
    """The prefetcher with its default IO engine (``io_engine="auto"``),
    2 workers and queue depth 16 staging a slice of a products batch's
    frontier: its first ``PROBE_ROWS`` unique cold rows in storage order,
    so the slice keeps the frontier's density (and so its coalescing).
    Timed, with its IO facts, the whole frontier's time at that rate,
    and the card's sampler (the training thread's host work) timed alone
    and while the staging runs."""
    import torch
    valid = n_id >= 0
    t = store.feature_order[n_id[valid].long()]
    rows = torch.unique(t[t >= store.cache_rows]).cpu()
    probe_rows = rows[:PROBE_ROWS]
    nodes = local.cpu()[probe_rows.long()]
    t_alone = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample()
        torch.cuda.synchronize()
        t_alone.append((time.perf_counter() - t0) * 1e3)
    pf = store.enable_cold_prefetch(DISK_RING_ROWS, **DISK_PREFETCH)
    engine = pf.stats()["io"]["engine"]
    t0 = time.perf_counter()
    fut = pf.publish(nodes, block=True)
    t_busy = []
    while not fut.done() and len(t_busy) < 8:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sample()
        torch.cuda.synchronize()
        t_busy.append((time.perf_counter() - t1) * 1e3)
    staged = fut.result(timeout=600)
    stage_s = time.perf_counter() - t0
    io = pf.stats()["io"]
    store.close()
    alone = sorted(t_alone)[1]
    busy = sorted(t_busy)[len(t_busy) // 2] if t_busy else None
    rate = staged / stage_s
    parts = staging_parts(store, rows.numpy(), card)
    print(f"disk staging probe: {staged} unique cold rows (the first of "
          f"batch 0's {rows.numel()}, in storage order) published with "
          f"io_engine='auto' (chose {engine!r} on {fs_type(path)}), "
          f"workers 2, io_qd 16: staged in {stage_s:.3f} s = {rate:.0f} "
          f"rows/s; {io['extents']} extents, coalescing factor "
          f"{io['coalescing_factor']}, {io['bytes_read']} B read, peak "
          f"queue depth {io['depth_peak']}, retries {io['retries']}; the "
          f"whole frontier at that rate: {rows.numel() / rate:.2f} s; the "
          f"card's sample_fn on the training thread {alone:.3f} ms alone, "
          + ("not measured while staging" if busy is None else
             f"{busy:.3f} ms while the staging runs (median of "
             f"{len(t_busy)}, {busy / alone:.1f}x)") + f"; on {card}",
          flush=True)
    return {"engine": engine, "fs": fs_type(path), "rows": staged,
            "frontier_cold_rows": int(rows.numel()), "seconds": stage_s,
            "rows_per_s": rate, "io": io,
            "frontier_seconds_at_rate": rows.numel() / rate,
            "sample_ms_alone": alone, "sample_ms_while_staging": busy,
            "staging_parts_ms": parts}


def staging_parts(store, rows, card):
    """A staging task's pieces, each timed alone on this thread over one
    frontier's unique cold rows (``rows``, storage rows): the mmap read
    of the file rows, their decode, and the writes into fresh rings of
    2^20 slots, decoded and packed (the slots pinned, as on the card)."""
    import numpy as np
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.prefetch import StagingRing
    disk = store.disk_map[rows]
    ms = {}
    t0 = time.perf_counter()
    codes = np.asarray(store.mmap_array[disk])
    ms["mmap_read"] = (time.perf_counter() - t0) * 1e3
    scale, zero = store.disk_scale[disk], store.disk_zero[disk]
    t0 = time.perf_counter()
    dec = quant.decode_np(codes, scale, zero)
    ms["decode"] = (time.perf_counter() - t0) * 1e3
    n = store.mmap_array.shape[0]
    for name, args, side in (("ring_write_decoded", (dec,), None),
                             ("ring_write_packed", (codes, scale, zero),
                              np.float32)):
        ring = StagingRing(DISK_RING_ROWS, DIM, args[0].dtype, n, side,
                           device=store.device)
        t0 = time.perf_counter()
        ring.stage(disk, *args)
        ms[name] = (time.perf_counter() - t0) * 1e3
        del ring
    print(f"disk staging parts: {rows.size} rows, each part alone on one "
          f"thread: mmap read {ms['mmap_read']:.3f} ms, decode "
          f"{ms['decode']:.3f} ms, ring write decoded "
          f"{ms['ring_write_decoded']:.3f} ms, packed "
          f"{ms['ring_write_packed']:.3f} ms; on {card}", flush=True)
    return ms


def time_calls(obj, name, log):
    """Wrap the method ``name`` of the object ``obj`` (an instance
    attribute over the class's) so that each call's ms go to
    ``log[name]``: a staging task's parts, measured where they run."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
    setattr(obj, name, timed)


def eviction_check(store, tmp):
    """Whether ``evict_file_cache`` drops the artifact's pages here: the
    time of one ``read_mmap`` of 50,000 random rows read again warm, and
    right after an eviction."""
    import numpy as np
    from quiver_tpu_torch.prefetch import evict_file_cache
    n = store.mmap_array.shape[0]
    rows = np.sort(np.random.default_rng(SEED).choice(
        n, min(50_000, n // 2), replace=False))
    store.read_mmap(rows)
    t0 = time.perf_counter()
    store.read_mmap(rows)
    warm = (time.perf_counter() - t0) * 1e3
    took = evict_file_cache(store.mmap_array.filename,
                            mapped=store.mmap_array)
    t0 = time.perf_counter()
    store.read_mmap(rows)
    cold = (time.perf_counter() - t0) * 1e3
    fs = fs_type(tmp)
    print(f"disk: evict_file_cache returned {took} on {fs}: {rows.size} "
          f"random rows by read_mmap {warm:.3f} ms warm, {cold:.3f} ms right "
          f"after "
          f"the eviction ({cold / warm:.2f}x)"
          + ("; tmpfs keeps the file in memory, nothing is dropped"
             if fs.startswith("tmpfs") else ""), flush=True)
    return {"returned": took, "fs": fs, "warm_ms": warm, "evicted_ms": cold}


def disk_training(dev, gen, nodes, deg, indptr, indices, card, topo, h2d,
                  refs):
    """(a) The products-scale disk tier and phase 10 (a)'s split training
    loop in four arms (see phase_disk). Returns its record."""

    import numpy as np
    import torch
    from quiver_tpu_torch import GraphSAGE, GraphSageSampler, metrics, tracing
    from quiver_tpu_torch.async_sampler import sample_ahead
    from quiver_tpu_torch.models.convert import (flax_to_state_dict,
                                                 random_flax_params)
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.parallel import build_split_train_step, init_state
    from quiver_tpu_torch.parallel.train import draw_int32
    from quiver_tpu_torch.partition import (load_disk_tier_store,
                                            save_disk_tier)
    from quiver_tpu_torch.prefetch import evict_file_cache

    tmp = tempfile.mkdtemp(prefix="qt_disk_")
    try:
        t0 = time.perf_counter()
        feat, labels = make_train_data(dev, gen, nodes)
        # storage row r holds the r-th node by degree: the hot set is the
        # top quarter by degree, as phase 6 places it
        order = torch.argsort(deg, descending=True, stable=True)
        rows = feat[order].cpu()
        del feat
        made_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        path = os.path.join(tmp, "disk")
        save_disk_tier(rows, np.arange(nodes), path, dtype_policy="int8")
        del rows
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hot = nodes // 4
        store, _ = load_disk_tier_store(path, hot_rows=hot, device=dev)
        store.set_local_order(order)
        plain = store.read_mmap(np.arange(nodes)).to(dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        files = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        sizes = ", ".join(f"{k} {v} B" for k, v in files.items())
        print(f"disk: artifact of {nodes} rows x {DIM} int8 written by "
              f"save_disk_tier in {save_s:.2f} s ({sizes}) "
              f"on {fs_type(tmp)}; features made in {made_s:.2f} s; "
              f"load_disk_tier_store(hot_rows={hot}) with set_local_order "
              f"(degree order) and every row decoded by read_mmap for the "
              f"checks in {load_s:.2f} s", flush=True)

        model0 = GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES),
                           dropout=DROPOUT)
        model0.load_state_dict(flax_to_state_dict(random_flax_params(
            DIM, HIDDEN, CLASSES, len(SIZES), seed=SEED)))
        model0 = model0.to(dev)
        perm = torch.randperm(nodes, generator=gen, device=dev) \
            .to(torch.int32)
        n_b = DISK_WARMUP + DISK_TIMED + DISK_PROFILED
        batches = [perm[i * BATCH:(i + 1) * BATCH].contiguous()
                   for i in range(n_b)]
        ys = [labels[b.long()] for b in batches]
        host = torch.Generator().manual_seed(SEED + 11)
        seeds = [draw_int32(host, 2) for _ in batches]
        sample_fn, _ = build_split_train_step(model0, None, SIZES, BATCH)

        def sample(i):
            return sample_fn(indptr, indices, batches[i], seeds[i][0])

        probe = staging_probe(store, tmp, lambda: sample(0),
                              sample(0)[0], order, card)

        def drive(run, steps, evict):
            """Steps ``steps`` of one arm: with a prefetcher, batch i+1 is
            sampled and published before batch i's lookup (from this
            thread); the masked lookup, the split step, float(loss)."""
            for i in steps:
                t = time.perf_counter()
                if evict:
                    evict_file_cache(store.mmap_array.filename,
                                     mapped=store.mmap_array)
                te = time.perf_counter()
                n_id, adjs = run["nxt"] or sample(i)
                run["nxt"] = None
                if run["ahead"] and i + 1 < n_b:
                    run["nxt"] = sample(i + 1)
                    store.stage_frontier(run["nxt"][0])
                t1 = time.perf_counter()
                x = store.getitem_masked(n_id)
                t2 = time.perf_counter()
                run["state"], loss = run["step_fn"](
                    run["state"], x, adjs, ys[i], seeds[i][1])
                run["losses"].append(float(loss))
                t3 = time.perf_counter()
                run["lat"].append((t3 - t) * 1e3)
                run["parts"].append((1e3 * (te - t), 1e3 * (t1 - te),
                                     1e3 * (t2 - t1), 1e3 * (t3 - t2)))
                run["edges"].append(sum(a.mask.sum() for a in adjs))
                run["xs"].append((n_id, x))

        rec = {"probe": probe, "files": files, "save_s": save_s,
               "load_s": load_s, "arms": {}}
        runs = {}
        pub_launches = {}
        for name, kw, evict in DISK_ARMS:
            store.close()
            if kw is not None:
                store.enable_cold_prefetch(DISK_RING_ROWS, io_engine="mmap",
                                           **DISK_PREFETCH, **kw)
            pf = store._cold_prefetch
            parts_log = {}
            if pf is not None:
                time_calls(pf, "_stage_shard", parts_log)
                time_calls(pf._ring, "stage", parts_log)
            evicted = None
            if evict:
                evicted = eviction_check(store, tmp)
            model = copy.deepcopy(model0)
            opt = torch.optim.Adam(model.parameters(), lr=LR,
                                   betas=(0.9, 0.999), eps=1e-8)
            _, step_fn = build_split_train_step(model, opt, SIZES, BATCH)
            run = dict(state=init_state(model, opt), step_fn=step_fn,
                       ahead=pf is not None, nxt=None, losses=[], lat=[],
                       parts=[], edges=[], xs=[])
            if pf is not None:
                run["nxt"] = sample(0)
                store.stage_frontier(run["nxt"][0])
            # the warm-up under deterministic algorithms: the arms' losses
            # and parameters are compared bit for bit after it
            with deterministic():
                drive(run, range(DISK_WARMUP), evict)
                torch.cuda.synchronize()
            run["params"] = [p.detach().clone()
                             for p in run["state"].model.parameters()]
            before = pf.stats() if pf is not None else None
            parts_log.clear()
            for k in ("lat", "parts", "edges"):
                run[k].clear()
            tracing.clear()
            tracing.enable()             # the staging tasks' spans
            kernels.reset_launches()
            drive(run, range(DISK_WARMUP, DISK_WARMUP + DISK_TIMED), evict)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            tracing.disable()
            stage_ms = sorted(1e3 * r[3] for r in tracing.records()
                              if r[0] == "pipeline.execute")
            tracing.clear()
            task_parts = {k: sorted(v)[len(v) // 2]
                          for k, v in parts_log.items() if v}
            after = pf.stats() if pf is not None else None
            pub_launches[name] = launches
            st = {}
            busy = device_profile(
                lambda: drive(run, range(DISK_WARMUP + DISK_TIMED, n_b),
                              evict), DISK_PROFILED, f"disk {name} step",
                top=6, stats=st)
            # every lookup against its plain version (read_mmap)
            for i, (n_id, x) in enumerate(run["xs"]):
                check(same_bits(x, disk_reference(store, plain, n_id)),
                      f"disk arm {name}: lookup {i} differs from "
                      "read_mmap's rows")
            n_checked = len(run["xs"])
            last_n_id = run["xs"][-1][0]
            run["xs"] = []
            check(all(math.isfinite(v) for v in run["losses"]),
                  f"disk arm {name}: non-finite loss")
            p50, p99 = pcts(run["lat"])
            edges = int(torch.stack(run["edges"]).sum())
            parts = [sorted(p[k] for p in run["parts"])[
                len(run["parts"]) // 2] for k in range(4)]
            per = launches["gather_rows"] / DISK_TIMED
            arm = dict(p50_ms=p50, p99_ms=p99,
                       edges_per_s=edges / (sum(run["lat"]) / 1e3),
                       edges_per_step=edges / DISK_TIMED,
                       device_ms=busy, host_ms_parts=parts,
                       gather_rows_per_step=per,
                       launches={k: v for k, v in launches.items() if v},
                       **st)
            if pf is None:
                check(launches["gather_rows"] == 0,
                      f"the off arm launched {launches}")
            else:
                check(launches["gather_rows"] >= 1,
                      f"disk arm {name}: the ring gather was not "
                      f"launched in {DISK_TIMED} steps ({launches})")
                d = {k: after[k] - before[k] for k in (
                    "published", "dropped", "hit_rows", "sync_rows",
                    "staged_rows", "truncated_rows")}
                io = {k: after["io"][k] - before["io"][k]
                      for k in ("extents", "rows_read", "bytes_read")}
                tot = d["hit_rows"] + d["sync_rows"]
                arm.update(
                    hit_rate=d["hit_rows"] / tot if tot else None,
                    sync_rows_per_step=d["sync_rows"] / DISK_TIMED,
                    staged_rows_per_step=d["staged_rows"] / DISK_TIMED,
                    published=d["published"], dropped=d["dropped"],
                    truncated_rows=d["truncated_rows"],
                    staging_ms_p50=(stage_ms[len(stage_ms) // 2]
                                    if stage_ms else None),
                    staging_parts_ms_p50=task_parts,
                    io=dict(io, engine=after["io"]["engine"],
                            depth_peak=after["io"]["depth_peak"]))
                # the ring as the main path leaves it for a lookup: this
                # batch's frontier staged
                pf.publish(last_n_id, block=True).result(timeout=600)
                arm["ring"] = ring_gather_timing(store, last_n_id, h2d, name)
                _, vec = store.lookup_tiered(last_n_id, masked=True,
                                             collect_metrics=True)
                arm["metered_slots"] = {
                    metrics.SLOT_NAMES[k]: int(vec[k]) for k in range(13, 23)}
            if evict:
                arm["eviction"] = evicted
            rec["arms"][name] = arm
            runs[name] = run
            hit = "" if pf is None else (
                f"; ring hit rate {arm['hit_rate']:.4f}, sync rows "
                f"{arm['sync_rows_per_step']:.0f} a step, staged "
                f"{arm['staged_rows_per_step']:.0f} a step, a staging task "
                f"p50 {fmt_ms(arm['staging_ms_p50'])} (pipeline.execute "
                f"spans; of it a worker's shard "
                f"{fmt_ms(task_parts.get('_stage_shard'))}, its ring write "
                f"{fmt_ms(task_parts.get('stage'))}, medians), "
                f"{arm['published']} published, {arm['dropped']} "
                f"dropped, {arm['truncated_rows']} truncated; IO engine "
                f"{arm['io']['engine']}, {arm['io']['extents']} extents, "
                f"{arm['io']['bytes_read']} B; gather_rows {per:g} "
                "launches a step")
            print(f"disk: arm {name}: {DISK_TIMED} steps (after "
                  f"{DISK_WARMUP}) of {BATCH} seeds, fanout {SIZES}: step "
                  f"p50 {p50:.3f} ms p99 {p99:.3f} ms, "
                  f"{arm['edges_per_s']:.6g} sampled edges/s; host ms "
                  f"(medians) evict {parts[0]:.3f}, sample+publish "
                  f"{parts[1]:.3f}, lookup {parts[2]:.3f}, step+float(loss) "
                  f"{parts[3]:.3f}; device {fmt_ms(busy)} a step, idle "
                  f"share {st.get('idle_share', float('nan')):.3f}{hit}; "
                  f"{n_checked} lookups equal to read_mmap's rows bit for "
                  f"bit; on {card}", flush=True)
        store.close()
        names = [a[0] for a in DISK_ARMS]
        first = runs[names[0]]
        for name in names[1:]:
            check(runs[name]["losses"][:DISK_WARMUP]
                  == first["losses"][:DISK_WARMUP],
                  f"disk arm {name}: losses differ from the off arm's")
            check(all(same_bits(a, b) for a, b in zip(
                runs[name]["params"], first["params"])),
                f"disk arm {name}: parameters differ from the off arm's")
        print(f"disk: the {len(names)} arms' losses and parameters after "
              f"the {DISK_WARMUP} warm-up steps (torch's deterministic "
              f"algorithms on) equal bit for bit; the timed steps run "
              f"without them, as phase 10 (a)'s: its serial step p50 "
              f"{refs['serial_p50_ms']:.3f} ms, phase 6's tiered batch p50 "
              f"{refs['tiered_p50_ms']:.3f} ms; on {card}", flush=True)
        rec["launches"] = pub_launches

        # the fence: a ring of 1.05x one batch's unique cold rows, the
        # stager wrapping around while the card reads
        n_ids = [sample(i)[0] for i in range(DISK_FENCE_LOOKUPS + 1)]
        fo = store.feature_order
        cold = max(int(((n >= 0) & (fo[n.clamp(min=0).long()] >= hot))
                        .sum()) for n in n_ids)
        cap = int(1.05 * cold)
        store.enable_cold_prefetch(cap, io_engine="mmap", decode_staged=False,
                                   **DISK_PREFETCH)
        store.stage_frontier(n_ids[0])
        xs = []
        kernels.reset_launches()
        for i in range(DISK_FENCE_LOOKUPS):
            store.stage_frontier(n_ids[i + 1])
            xs.append(store.getitem_masked(n_ids[i]))
        torch.cuda.synchronize()
        fence_launches = kernels.LAUNCHES["gather_rows"]
        for i, x in enumerate(xs):
            check(same_bits(x, disk_reference(store, plain, n_ids[i])),
                  f"fence: lookup {i} differs from read_mmap's rows")
        fst = store._cold_prefetch.stats()
        store.close()
        print(f"disk fence: ring of {cap} slots (1.05 x {cold} unique cold "
              f"rows, the most of {DISK_FENCE_LOOKUPS + 1} batches), "
              f"packed, the stager publishing batch i+1 while the card "
              f"reads batch i: {DISK_FENCE_LOOKUPS} lookups equal to "
              f"read_mmap's rows bit for bit; {fence_launches} ring "
              f"gathers, {fst['hit_rows']} hit rows, {fst['sync_rows']} "
              f"sync rows, {fst['dropped']} publications dropped",
              flush=True)
        rec["fence"] = {"capacity": cap, "batch_cold_rows": cold,
                        "lookups": DISK_FENCE_LOOKUPS,
                        "ring_gathers": fence_launches,
                        "hit_rows": fst["hit_rows"],
                        "sync_rows": fst["sync_rows"]}

        # sample_ahead over the HBM sampler publishes through the store
        store.enable_cold_prefetch(DISK_RING_ROWS, io_engine="mmap",
                                   **DISK_PREFETCH)
        ahead = batches[:DISK_AHEAD_BATCHES]
        s1 = GraphSageSampler(topo, SIZES, seed=SEED, device=dev)
        s2 = GraphSageSampler(topo, SIZES, seed=SEED, device=dev)
        want = [s1.sample(b) for b in ahead]
        got, xs = [], []
        for out in sample_ahead(s2, ahead, feature=store, depth=2):
            got.append(out)
            xs.append(store.getitem_masked(out[0]))
        check(len(got) == len(want) and all(
            same_sample(a, b) for a, b in zip(want, got)),
            "sample_ahead differs from serial sample()")
        for out, x in zip(got, xs):
            check(same_bits(x, disk_reference(store, plain, out[0])),
                  "sample_ahead: a lookup differs from read_mmap's rows")
        ast = store._cold_prefetch.stats()
        check(ast["hit_rows"] > 0, f"sample_ahead: no ring hit ({ast})")
        store.close()
        print(f"disk sample_ahead: {len(got)} GraphSageSampler(HBM) batches "
              f"equal to serial sample() bit for bit, published by the "
              f"worker; ring hit rate {ast['hit_rate']:.4f} "
              f"({ast['hit_rows']} hit, {ast['sync_rows']} sync rows, "
              f"{ast['dropped']} of {ast['published']} dropped); lookups "
              "equal to read_mmap's rows", flush=True)
        rec["sample_ahead"] = {k: ast[k] for k in (
            "published", "dropped", "hit_rows", "sync_rows", "hit_rate")}
        del plain
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def disk_synthetic(dev, card):
    """(b) The JAX package's synthetic cold dataset at its defaults,
    generated and loaded by the port, 16 batches through sample_ahead
    over a GraphSageSampler, held to the same store without prefetch."""

    import torch
    from quiver_tpu_torch import GraphSageSampler
    from quiver_tpu_torch.async_sampler import sample_ahead
    from quiver_tpu_torch.datasets import (generate_synthetic_cold_dataset,
                                           load_synthetic_cold_dataset)
    from quiver_tpu_torch.ops import kernels

    tmp = tempfile.mkdtemp(prefix="qt_cold_")
    try:
        t0 = time.perf_counter()
        meta = generate_synthetic_cold_dataset(tmp)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        topo, store, _ = load_synthetic_cold_dataset(
            tmp, prefetch_rows=DISK_RING_ROWS, device=dev,
            io_engine="mmap", **DISK_PREFETCH)
        _, ref, _ = load_synthetic_cold_dataset(tmp, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"cold dataset: generate_synthetic_cold_dataset at its "
              f"defaults ({meta['nodes']} nodes, dim {meta['dim']}, "
              f"{meta['edges']} edges, avg_deg {meta['avg_deg']}, hot_frac "
              f"{meta['hot_frac']}, {meta['dtype_policy']}, skew "
              f"{meta['skew']}) in {gen_s:.2f} s on {fs_type(tmp)}; loaded "
              f"twice (with and without prefetch) in {load_s:.2f} s",
              flush=True)
        sampler = GraphSageSampler(topo, SIZES, seed=SEED, device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 12)
        perm = torch.randperm(meta["nodes"], generator=g, device=dev) \
            .to(torch.int32)
        batches = [perm[i * BATCH:(i + 1) * BATCH]
                   for i in range(COLD_BATCHES)]
        xs, lat = [], []
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.perf_counter()
        for n_id, bs, _ in sample_ahead(sampler, batches, feature=store):
            xs.append((n_id, store.getitem_masked(n_id)))
            torch.cuda.synchronize()
            now = time.perf_counter()
            lat.append((now - t) * 1e3)
            t = now
        launches = kernels.LAUNCHES["gather_rows"]
        check(launches >= 1, f"(b): the ring gather launched {launches} "
              "times")
        for i, (n_id, x) in enumerate(xs):
            check(same_bits(x, ref.getitem_masked(n_id)),
                  f"(b): lookup {i} differs from the store without "
                  "prefetch")
        st = store._cold_prefetch.stats()
        store.close()
        ref.close()
        p50, p99 = pcts(lat)
        print(f"cold dataset: {COLD_BATCHES} batches of {BATCH} at {SIZES} "
              f"through sample_ahead and the masked lookup: p50 {p50:.3f} "
              f"ms p99 {p99:.3f} ms a batch (host clock, synchronised); "
              f"ring hit rate {st['hit_rate']}, {st['hit_rows']} hit rows, "
              f"{st['sync_rows']} sync rows, {st['staged_rows']} staged, "
              f"{st['dropped']} of {st['published']} publications dropped, "
              f"{launches} ring gathers; every lookup equal to the store "
              f"without prefetch bit for bit; on {card}", flush=True)
        return {"meta": meta, "generate_s": gen_s, "load_s": load_s,
                "p50_ms": p50, "p99_ms": p99, "ring_gathers": launches,
                **{k: st[k] for k in ("published", "dropped", "hit_rows",
                                      "sync_rows", "staged_rows",
                                      "hit_rate")}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_disk(dev, gen, nodes, indptr, indices, deg, card, topo, h2d,
               refs):
    """Phase 11: the disk tier and the cold prefetch (module doc)."""
    secs, rec = {}, {}
    t0 = time.perf_counter()
    rec["products"] = disk_training(dev, gen, nodes, deg, indptr, indices,
                                    card, topo, h2d, refs)
    secs["(a)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["synthetic"] = disk_synthetic(dev, card)
    secs["(b)"] = time.perf_counter() - t0
    print(f"phase 11: {sum(secs.values()):.2f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in secs.items()), flush=True)
    rec["seconds"] = secs
    return rec


SERVER_LADDER = [SIZES, [6, 4, 2]]   # serve_sage.py's shed rung: ~0.4x
SERVER_CFG = dict(max_wait_ms=2.0, queue_depth=1024, slo_p99_ms=50.0,
                  shed_queue_frac=0.25)   # examples/serve_sage.py:98-100
SCATTER_DUPS = 64              # (a): duplicates staged beside originals
TRACE_RATE = 2000.0            # (b): examples/serve_sage.py's defaults
TRACE_SECONDS = 3.0
OVERLOAD_BURST = 4096          # (c)
OVERLOAD_FILL_CAP = 256        # (c): the second burst's fill cap
FLOOD = 20_000                 # (d): best_effort submissions at most
TRICKLE = 200                  # (d): interactive, one each 5 ms
RPC_LOOKUPS = 256              # (e)
RPC_TRACED = 64                # (e): lookups with tracing on
SERVER_TOL = 1e-4              # a future's row against its batch's replay
SCATTER_WAIT_MS = 250.0        # (a): staged batches fill to the cap
SCATTER_QUEUE = 4096           # (a): holds the 2,115 staged requests


class RecordingEngine:
    """The engine as ``MicroBatchServer`` sees it: each ``run`` draws its
    hop seeds from the engine's generator, records ``(seeds, variant,
    hop_seeds)`` and serves with them, so every batch can be replayed."""

    def __init__(self, eng):
        self._eng = eng
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def run(self, seeds, variant=0):
        hs = self._eng.draw_hop_seeds(len(self._eng.variants[variant]))
        self.calls.append((seeds.copy(), variant, hs))
        return self._eng.run(seeds, variant, hop_seeds=hs)


def ms_pcts(lat_s):
    p50, p99 = pcts(lat_s)
    return 1e3 * p50, 1e3 * p99


def span_ms(recs, name):
    """p50/p99 ms of the recorded spans called ``name``."""
    durs = [r[3] for r in recs if r[0] == name]
    return (None, None) if not durs else ms_pcts(durs)


def server_scatter(eng, nodes, hot_per_batch):
    """(a): 2 x 1024 + 3 distinct ids with 64 duplicates beside their
    originals, staged into a paused server (``max_wait_ms`` 250 and
    ``queue_depth`` 4,096, so that they fit and the batches fill); every
    future's row against its batch replayed with the batch's hop seeds;
    the launches per server batch."""
    import numpy as np
    from quiver_tpu_torch import MicroBatchServer, ServeConfig
    from quiver_tpu_torch.ops import kernels
    rng = np.random.default_rng(SEED + 12)
    ids = rng.choice(nodes, 2 * BATCH + 3, replace=False)
    plan = []
    for i, nid in enumerate(ids):
        plan.append(int(nid))
        if i % 32 == 0 and len(plan) - i - 1 < SCATTER_DUPS:
            plan.append(int(nid))          # lands in its original's batch
    rec_eng = RecordingEngine(eng)
    # a queue that holds the staged requests, and a wait long enough that
    # the staged batches fill to the cap however the executor's dispatch
    # holds the interpreter lock meanwhile
    srv = MicroBatchServer(rec_eng, ServeConfig(**dict(
        SERVER_CFG, max_wait_ms=SCATTER_WAIT_MS,
        queue_depth=SCATTER_QUEUE)), start=False)
    kernels.reset_launches()
    futs = [srv.submit(n) for n in plan]
    t0 = time.perf_counter()
    srv.start()
    rows = [f.result(timeout=120) for f in futs]
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    snap = srv.snapshot()["serving"]
    srv.close()
    batches = len(rec_eng.calls)
    fills = [int((s >= 0).sum()) for s, _, _ in rec_eng.calls]
    check(len(plan) == len(ids) + SCATTER_DUPS, "scatter plan")
    check(fills == [BATCH, BATCH, 3], f"server batches filled {fills}, "
          f"expected [{BATCH}, {BATCH}, 3]")
    check(launches["fused_sample_hop"] == 2 * batches
          and launches["fused_hot_hop"] == batches
          and launches["gather_rows"] == hot_per_batch * batches
          and launches["sample_layer"] == launches["gather_elems"] == 0,
          f"server launches {launches} over {batches} batches")
    where = {}
    for k, (s, _, _) in enumerate(rec_eng.calls):
        for slot, nid in enumerate(s.tolist()):
            if nid >= 0:
                where[nid] = (k, slot)
    replay = [eng.run(s, v, hop_seeds=hs).cpu().numpy()
              for s, v, hs in rec_eng.calls]
    err = 0.0
    for nid, row in zip(plan, rows):
        k, slot = where[nid]
        check(row.shape == (CLASSES,) and np.isfinite(row).all(),
              "a served row is not finite [47]")
        err = max(err, float(np.abs(row - replay[k][slot]).max()))
    check(err <= SERVER_TOL, f"a served row differs from its batch's "
          f"replay by {err}")
    dup_shared = sum(1 for a, b in zip(plan, plan[1:]) if a == b)
    print(f"server (a): {len(plan)} requests ({len(ids)} distinct, "
          f"{dup_shared} duplicates sharing their original's slot) in "
          f"{batches} batches (max_wait_ms {SCATTER_WAIT_MS}, queue_depth "
          f"{SCATTER_QUEUE}), fills "
          f"{fills}, variants "
          f"{[v for _, v, _ in rec_eng.calls]}, {wall * 1e3:.3f} ms; "
          f"every row within {err:.3g} of its batch's replay (tolerance "
          f"{SERVER_TOL}); launches per server batch: fused_sample_hop "
          f"{launches['fused_sample_hop'] / batches:g}, fused_hot_hop "
          f"{launches['fused_hot_hop'] / batches:g}, gather_rows (host "
          f"tier) {launches['gather_rows'] / batches:g}", flush=True)
    return {"requests": len(plan), "distinct": len(ids), "batches": batches,
            "fills": fills, "variants": [v for _, v, _ in rec_eng.calls],
            "max_abs_err": err, "serving": snap}, launches, batches


def server_trace(eng, nodes, card, hot_per_batch, bare_p50):
    """(b): ``examples/serve_sage.py``'s open-loop Poisson trace from one
    client thread, with the ``serve.*`` spans on; then the engine's bare
    batch per variant, the device time and idle share of 4 blocks of
    1,024 requests through a server at full quality, and the readback's
    own time."""
    import numpy as np
    import torch
    from quiver_tpu_torch import (MicroBatchServer, OverloadError,
                                  ServeConfig, serving, tracing)
    from quiver_tpu_torch.ops import kernels
    rng = np.random.default_rng(SEED + 13)
    n_req = int(TRACE_RATE * TRACE_SECONDS)
    gaps = rng.exponential(1.0 / TRACE_RATE, n_req)
    ids = rng.integers(0, nodes, n_req)
    tracing.clear()
    tracing.enable()
    srv = MicroBatchServer(eng, ServeConfig(**SERVER_CFG))
    lat, rejected, futs = [], 0, []
    kernels.reset_launches()
    t_next = t0 = time.perf_counter()
    for k in range(n_req):
        t_next += gaps[k]
        delay = t_next - time.perf_counter()
        if delay > 0.0015:
            time.sleep(delay - 0.001)
        t_sub = time.perf_counter()
        try:
            f = srv.submit(int(ids[k]))
        except OverloadError:
            rejected += 1
            continue
        f.add_done_callback(
            lambda _, t=t_sub: lat.append(time.perf_counter() - t))
        futs.append(f)
    offered_s = time.perf_counter() - t0
    rows = [f.result(timeout=120) for f in futs]
    served_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    srv.close()            # joins the executor: every span is filed
    tracing.disable()
    spans = tracing.records()
    tracing.clear()
    snap = srv.snapshot()
    sv = snap["serving"]
    check(all(r.shape == (CLASSES,) and np.isfinite(r).all() for r in rows),
          "trace: a served row is not finite [47]")
    check(sv["completed"] == len(futs) and sv["failed"] == 0,
          f"trace: {sv['completed']} of {len(futs)} completed")
    b = sv["batches"]
    check(launches["fused_sample_hop"] == 2 * b
          and launches["fused_hot_hop"] == b
          and launches["gather_rows"] == hot_per_batch * b,
          f"trace launches {launches} over {b} batches")
    p50, p99 = ms_pcts(lat)
    health = srv.health()
    waits = {n: span_ms(spans, n) for n in (
        "serve.coalesce_wait", "serve.batch_coalesce", "serve.dispatch",
        "serve.scatter", "serve.admission_wait")}
    fmt = lambda x: "n/a" if x[0] is None else f"{x[0]:.3f}/{x[1]:.3f}"
    print(f"server (b): {n_req} requests offered over {offered_s:.3f} s "
          f"({n_req / offered_s:.1f} req/s, Poisson, one client thread), "
          f"{len(futs)} admitted, {rejected} rejected at admission, "
          f"{sv['deadline_expired']} deadline-shed; served in "
          f"{served_s:.3f} s; per-request latency p50 {p50:.3f} ms p99 "
          f"{p99:.3f} ms (client clock, submit to result; the server's "
          f"histogram: p50 {snap['request']['p50_ms']} p99 "
          f"{snap['request']['p99_ms']}) against phase 6's bare tiered "
          f"batch p50 {bare_p50:.3f} ms on {card}", flush=True)
    print(f"server (b): {b} batches, mean fill {sv['mean_batch_fill']:.2f}"
          f", variant mix {sv['variant_batches']}, shed level "
          f"{sv['shed_level']}, health {health}", flush=True)
    print("server (b): span p50/p99 ms (max_wait_ms 2.0): " + ", ".join(
        f"{n} {fmt(v)}" for n, v in waits.items()) + f"; batch wall "
          f"p50 {snap['wall']['p50_ms']} p99 {snap['wall']['p99_ms']}",
          flush=True)
    sl = snap["slo"]
    print(f"server (b): slo target {sl['target_p99_ms']} ms, short burn "
          f"{sl['windows']['short']['burn_rate']}, long burn "
          f"{sl['windows']['long']['burn_rate']}, budget remaining "
          f"{sl['budget_remaining']}, shedding {sl['shedding']}, "
          f"{sl['total']}", flush=True)

    # the same engine's batches alone, one thread, per variant
    bare = {}
    for v in range(len(SERVER_LADDER)):
        blat = []
        for _ in range(8):
            blk = rng.choice(nodes, BATCH, replace=False)
            t = time.perf_counter()
            eng.run(blk, v)
            torch.cuda.synchronize()
            blat.append(time.perf_counter() - t)
        bare[v] = ms_pcts(blat)[0]
    print(f"server (b): the engine's bare batch (one thread, 8 batches "
          f"each) p50 variant 0 {bare[0]:.3f} ms, variant 1 "
          f"{bare[1]:.3f} ms", flush=True)

    # 4 blocks of 1,024 distinct ids under the profiler, each submitted at
    # once and waited for, on a fresh server at full quality (the trace's
    # SLO budget stays burnt for its 30 s window, and a block submitted
    # at once presses the queue): no SLO target, no queue trigger
    blocks = [rng.choice(nodes, BATCH, replace=False) for _ in range(4)]
    srv = MicroBatchServer(eng, ServeConfig(**dict(
        SERVER_CFG, slo_p99_ms=None, shed_queue_frac=1.0)))

    def four():
        for blk in blocks:
            for f in srv.submit_many(int(n) for n in blk):
                f.result(timeout=60)
    four()
    prof = {}
    before = srv.snapshot()["serving"]
    dev_ms = device_profile(four, 4, f"block of {BATCH} requests",
                            stats=prof)
    after = srv.snapshot()["serving"]
    srv.close()
    prof_batches = after["batches"] - before["batches"]
    prof_mix = [a - b for a, b in zip(after["variant_batches"],
                                      before["variant_batches"])]
    if dev_ms is not None:
        dev_ms = 4 * dev_ms / prof_batches
        print(f"server (b): the 4 blocks ran as {prof_batches} server "
              f"batches (variant mix {prof_mix}): device {dev_ms:.3f} ms "
              "per server batch", flush=True)

    out = eng.run(blocks[0])
    torch.cuda.synchronize()
    rb = []
    for _ in range(20):
        t = time.perf_counter()
        serving._readback(out)
        rb.append(time.perf_counter() - t)
    rb_ms = 1e3 * sorted(rb)[len(rb) // 2]
    print(f"server (b): readback of the [{BATCH}, {CLASSES}] fp32 logits "
          f"(one device-to-host copy into a fresh host array) "
          f"{rb_ms:.4f} ms (median of 20, host clock, logits ready)",
          flush=True)
    return {"offered": n_req, "offered_s": offered_s, "admitted": len(futs),
            "rejected": rejected, "request_p50_ms": p50,
            "request_p99_ms": p99, "bare_tiered_p50_ms": bare_p50,
            "batches": b, "mean_fill": sv["mean_batch_fill"],
            "variant_batches": sv["variant_batches"],
            "health": health, "slo": sl, "spans_ms": waits,
            "bare_batch_p50_ms": bare,
            "device_ms_per_batch": dev_ms, "profiled_batches": prof_batches,
            "profiled_variant_batches": prof_mix,
            **prof, "readback_ms": rb_ms,
            "launches": launches}


def overload_burst(srv, ids):
    """Submit ``ids`` at once into a running server and wait for every
    admitted future; the burst's counts and batches."""
    from quiver_tpu_torch import OverloadError
    import numpy as np
    before = srv.snapshot()["serving"]
    futs, rejected = [], 0
    for n in ids:
        try:
            futs.append(srv.submit(int(n)))
        except OverloadError:
            rejected += 1
    rows = [f.result(timeout=120) for f in futs]
    after = srv.snapshot()["serving"]
    check(rejected > 0 and rejected + len(futs) == len(ids)
          and after["rejected"] - before["rejected"] == rejected,
          f"overload: {rejected} rejected, {len(futs)} admitted")
    check(len(rows) == len(futs) and all(np.isfinite(r).all()
                                         for r in rows),
          "overload: an admitted future did not resolve to a finite row")
    return {"admitted": len(futs), "rejected": rejected,
            "batches": after["batches"] - before["batches"],
            "variant_batches": [a - b for a, b in zip(
                after["variant_batches"], before["variant_batches"])],
            "shed_level": after["shed_level"]}


def server_overload(eng, nodes):
    """(c): 4,096 requests at once into a running server of depth 1,024
    with no SLO target (the rejections would keep an SLO budget burning
    for its 30 s window, so the ladder could not come back within the
    phase): once as it is, then with the fill cap at 256
    (``set_batch_fill_cap``), so that a batch leaves queue behind it;
    then lone requests until the ladder is back at 0."""
    import numpy as np
    from quiver_tpu_torch import MicroBatchServer, ServeConfig
    cfg = dict(SERVER_CFG, slo_p99_ms=None)
    rng = np.random.default_rng(SEED + 14)
    srv = MicroBatchServer(eng, ServeConfig(**cfg))
    bursts = {}
    for name, cap in (("full", None), ("cap", OVERLOAD_FILL_CAP)):
        srv.set_batch_fill_cap(cap)
        bursts[name] = overload_burst(
            srv, rng.integers(0, nodes, OVERLOAD_BURST))
    srv.set_batch_fill_cap(None)
    capped = bursts["cap"]
    check(capped["variant_batches"][1] >= 1,
          f"overload: queue pressure shed no batch ({capped})")
    # the hysteresis: one step back after calm_batches calm decisions in
    # a row; the burst's own tail may already have made some of them
    calm_batches = srv.config.calm_batches
    needed = calm_batches - srv._calm if capped["shed_level"] else 0
    calm = 0
    while srv.snapshot()["serving"]["shed_level"] and calm < calm_batches:
        srv.submit(int(rng.integers(0, nodes))).result(timeout=60)
        calm += 1
    after = srv.snapshot()["serving"]
    srv.close()
    check(after["shed_level"] == 0 and calm == needed,
          f"overload: the ladder came back after {calm} calm batches, "
          f"{needed} expected (calm_batches {calm_batches})")
    for name, b in bursts.items():
        print(f"server (c): {OVERLOAD_BURST} requests at once into a queue "
              f"of {SERVER_CFG['queue_depth']}, fill cap "
              f"{BATCH if name == 'full' else OVERLOAD_FILL_CAP}: "
              f"{b['admitted']} admitted (all resolved), {b['rejected']} "
              f"rejected with OverloadError; {b['batches']} batches, "
              f"variant mix {b['variant_batches']}, shed level after "
              f"{b['shed_level']}", flush=True)
    print(f"server (c): the ladder back at 0 after {calm} more calm "
          f"batches, as the hysteresis requires (calm_batches "
          f"{calm_batches})", flush=True)
    return {**bursts, "calm_batches_to_recover": calm}


def server_tenancy(eng, nodes):
    """(d): a best_effort flood from one thread and an interactive
    trickle from another into a server with ``default_tenant_classes(
    50.0)``."""
    import numpy as np
    import threading
    from quiver_tpu_torch import (MicroBatchServer, OverloadError,
                                  ServeConfig, default_tenant_classes)
    rng = np.random.default_rng(SEED + 15)
    srv = MicroBatchServer(eng, ServeConfig(**SERVER_CFG),
                           tenants=default_tenant_classes(50.0))
    flood_ids = rng.integers(0, nodes, FLOOD)
    trickle_ids = rng.integers(0, nodes, TRICKLE)
    be_futs, be_rejected, stop = [], [0], threading.Event()

    def flood():
        for n in flood_ids:
            if stop.is_set():
                return
            try:
                be_futs.append(srv.submit(int(n), tenant="best_effort"))
            except OverloadError:
                be_rejected[0] += 1

    th = threading.Thread(target=flood, name="best-effort-flood")
    th.start()
    ia_futs, ia_refused = [], []
    try:
        for n in trickle_ids:
            try:
                ia_futs.append(srv.submit(int(n), tenant="interactive"))
            except OverloadError as e:
                ia_refused.append(e)
            time.sleep(0.005)
    finally:
        stop.set()
        th.join(timeout=60)
    check(not th.is_alive(), "tenancy: the flood thread did not stop")
    ia_rows, ia_failed = [], 0
    for f in ia_futs:
        try:
            ia_rows.append(f.result(timeout=120))
        except OverloadError:
            ia_failed += 1
    be_done = be_lost = 0
    for f in be_futs:
        try:
            f.result(timeout=120)
            be_done += 1
        except OverloadError:
            be_lost += 1               # displaced after admission
    tens = {t["tenant"]: t for t in srv.tenant_snapshots()}
    agg = srv.snapshot()["serving"]
    srv.close()
    ia, be = tens["interactive"], tens["best_effort"]
    check(not ia_refused and ia_failed == 0 and ia["rejected"] == 0
          and ia["displaced"] == 0 and ia["completed"] == len(ia_futs)
          == TRICKLE, f"tenancy: interactive refused {len(ia_refused)}, "
          f"displaced {ia_failed} ({ia})")
    check(be["rejected"] + be["displaced"] > 0,
          "tenancy: best_effort absorbed no shed")
    for key in ("requests", "completed", "rejected", "displaced",
                "deadline_expired", "failed"):
        total = sum(t[key] for t in tens.values())
        check(total == agg[key], f"tenancy: the classes' {key} add to "
              f"{total}, the server counted {agg[key]}")
    print(f"server (d): best_effort flood {len(be_futs) + be_rejected[0]} "
          f"submitted, {be['completed']} completed, {be['rejected']} "
          f"rejected, {be['displaced']} displaced, p50/p99 "
          f"{be['latency']['p50_ms']}/{be['latency']['p99_ms']} ms; "
          f"interactive {TRICKLE} (one each 5 ms), {ia['completed']} "
          f"completed, 0 rejected, 0 displaced, p50/p99 "
          f"{ia['latency']['p50_ms']}/{ia['latency']['p99_ms']} ms; "
          f"{agg['batches']} batches, variant mix "
          f"{agg['variant_batches']}; per-class counts add to the "
          f"server's", flush=True)
    keep = ("requests", "completed", "rejected", "displaced", "shed",
            "latency")
    return {name: {k: t[k] for k in keep} for name, t in tens.items()} | {
        "aggregate": {k: agg[k] for k in ("requests", "completed",
                                          "rejected", "displaced",
                                          "batches", "variant_batches")}}


async def rpc_round_trip(port, msg):
    """One raw frame to a replica on 127.0.0.1 and its answer."""
    from quiver_tpu_torch import rpc
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        rpc.write_frame(writer, msg)
        await writer.drain()
        return await rpc.read_frame(reader)
    finally:
        writer.close()
        await writer.wait_closed()


def server_rpc(eng, nodes):
    """(e): ``RpcServer`` over a server on 127.0.0.1 and an ``RpcClient``
    looking up 256 nodes one at a time; a spent budget on the wire and
    through the client; 64 more lookups with tracing on, each client's
    trace context among the replica's ``serve.*`` spans, and the round
    trip by span."""
    import numpy as np
    from quiver_tpu_torch import MicroBatchServer, ServeConfig, rpc, tracing
    rng = np.random.default_rng(SEED + 16)
    srv = MicroBatchServer(eng, ServeConfig(**SERVER_CFG))
    front = rpc.RpcServer(srv, host="127.0.0.1", port=0)
    cli = rpc.RpcClient({"r0": ("127.0.0.1", front.port)}, retries=0,
                        hedge=False)
    try:
        rtt = []
        for n in rng.integers(0, nodes, RPC_LOOKUPS):
            t0 = time.perf_counter()
            row = cli.lookup(int(n), budget_ms=5000.0)
            rtt.append(time.perf_counter() - t0)
            check(row.shape == (CLASSES,) and np.isfinite(row).all(),
                  "rpc: a row is not finite [47]")
        # a budget spent before arrival, on the wire; then a 1 ms budget
        # through a client that may retry once: the budget runs out
        wire = asyncio.run(rpc_round_trip(front.port, {
            "op": "lookup", "id": 1, "node": int(rng.integers(0, nodes)),
            "budget_ms": 0.0}))
        check(wire.get("error") == "DeadlineExceeded"
              and front.shed_deadline == 1,
              f"rpc: a spent budget came back as {wire}")
        late = rpc.RpcClient({"r0": ("127.0.0.1", front.port)}, retries=1,
                             hedge=False, backoff_ms=1.0)
        spent = None
        try:
            late.lookup(int(rng.integers(0, nodes)), budget_ms=1.0)
        except rpc.DeadlineExceeded as e:
            spent = e
        finally:
            late.close()
        check(spent is not None, "rpc: a 1 ms budget came back with a row, "
              "not DeadlineExceeded")
        # traced lookups, each under a context the client injects: its
        # trace id on the replica's serve spans, and the round trip by
        # span
        tracing.clear()
        tracing.enable()
        try:
            tids = []
            for n in rng.integers(0, nodes, RPC_TRACED):
                ctx = tracing.inject({})
                cli.lookup(int(n), budget_ms=5000.0, context=ctx)
                tids.append(ctx[tracing.CTX_TRACE_ID])
            # the executor files a batch's serve.request spans after it
            # resolves the futures: wait for the last batch's
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not set(tids) <= {
                    r[4] for r in tracing.records()
                    if r[0] == "serve.request"}:
                time.sleep(0.01)
            spans = tracing.records()
        finally:
            tracing.disable()
            tracing.clear()
        names = sorted({r[0] for r in spans
                        if r[4] == tids[0] and r[0].startswith("serve.")})
        served = {r[4] for r in spans if r[0] == "serve.request"}
        check("serve.request" in names and served >= set(tids),
              f"rpc: a client's trace id is not among the replica's serve "
              f"spans ({names}, {len(served & set(tids))} of {len(tids)})")
        by_span = {n: span_ms(spans, n) for n in (
            "rpc.lookup", "rpc.attempt", "serve.request",
            "serve.admission_wait", "serve.coalesce_wait",
            "serve.dispatch", "serve.scatter")}
        stats = cli.stats()
    finally:
        cli.close()
        front.close()
        srv.close()
    p50, p99 = ms_pcts(rtt)
    print(f"server (e): RpcClient -> RpcServer on 127.0.0.1, "
          f"{RPC_LOOKUPS} lookups one at a time: round trip p50 "
          f"{p50:.3f} ms p99 {p99:.3f} ms; a spent budget came back on "
          f"the wire as {wire['error']}, a 1 ms budget as "
          f"DeadlineExceeded ({spent}); front-end deadline sheds "
          f"{front.shed_deadline}; the client's trace id on the replica's "
          f"spans {names}", flush=True)
    print(f"server (e): {RPC_TRACED} traced lookups, span p50/p99 ms: "
          + ", ".join(f"{n} {v[0]:.3f}/{v[1]:.3f}"
                      for n, v in by_span.items() if v[0] is not None),
          flush=True)
    return {"lookups": RPC_LOOKUPS, "rtt_p50_ms": p50, "rtt_p99_ms": p99,
            "wire_spent_budget": wire, "deadline_exceeded": str(spent),
            "front_shed_deadline": front.shed_deadline,
            "traced_spans": names, "traced_spans_ms": by_span,
            "client": stats}


def server_faults(eng, nodes):
    """(f): one ``serve.execute`` fault fails exactly its batch and the
    next batch serves; a ``serve.coalesce`` fault breaks the server."""
    import numpy as np
    from quiver_tpu_torch import (MicroBatchServer, ServeConfig,
                                  ServerClosed, faults)
    from quiver_tpu_torch.faults import FaultPlan, FaultRule
    rng = np.random.default_rng(SEED + 17)
    ids = [int(n) for n in rng.choice(nodes, 48, replace=False)]
    srv = MicroBatchServer(eng, ServeConfig(**SERVER_CFG), start=False)
    first = srv.submit_many(ids[:16])
    faults.install(FaultPlan(rules={"serve.execute": FaultRule(
        "error", exc="runtime", times=1)}))
    try:
        srv.start()
        errs = []
        for f in first:
            try:
                f.result(timeout=60)
            except RuntimeError as e:
                errs.append(e)
        check(len(errs) == 16 and all("injected" in str(e) for e in errs),
              f"faults: the execute fault failed {len(errs)} of 16")
    finally:
        faults.disarm()
    rows = [f.result(timeout=60) for f in srv.submit_many(ids[16:32])]
    s = srv.snapshot()["serving"]
    srv.close()
    check(all(np.isfinite(r).all() for r in rows) and s["failed"] == 16
          and s["completed"] == 16,
          f"faults: after the execute fault {s}")

    broken = MicroBatchServer(eng, ServeConfig(**SERVER_CFG), start=False)
    staged = broken.submit_many(ids[32:])
    faults.install(FaultPlan(rules={"serve.coalesce": FaultRule(
        "error", exc="runtime")}))
    try:
        broken.start()
        closed = 0
        for f in staged:
            try:
                f.result(timeout=60)
            except ServerClosed:
                closed += 1
        deadline = time.monotonic() + 10.0
        while broken.health()["score"] != 0.0 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        refused = False
        try:
            broken.submit(ids[0])
        except ServerClosed:
            refused = True
    finally:
        faults.disarm()
        broken.close()
    check(closed == len(staged) and refused,
          f"faults: coalesce fault: {closed} of {len(staged)} queued futures "
          f"failed with ServerClosed, submit refused {refused}")
    print(f"server (f): a serve.execute fault failed exactly its batch's 16 "
          f"futures and the next batch served 16; a serve.coalesce fault "
          f"failed all {closed} queued futures with ServerClosed, health 0, "
          f"submit refused with ServerClosed", flush=True)
    return {"execute": {"failed": 16, "served_after": 16},
            "coalesce": {"queued_failed": closed, "submit_refused": refused}}


def phase_server(dev, nodes, card, ctx, hot_per_batch, bare_p50):
    """Phase 12: the request path (module doc). Returns its record, the
    launches of (a) and its batch count."""
    from quiver_tpu_torch import GraphSAGE, ServeEngine
    from quiver_tpu_torch.models.convert import (flax_to_state_dict,
                                                 random_flax_params)
    secs, rec = {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        return out
    model = GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES))
    params = flax_to_state_dict(
        random_flax_params(DIM, HIDDEN, CLASSES, len(SIZES), seed=SEED))
    eng = part("warmup", lambda: ServeEngine(
        model, params, ctx["topo"], ctx["store"], SERVER_LADDER, BATCH,
        fused_hot_hop=True, fused_row_cap=ROW_CAP, collect_metrics=True,
        seed=SEED, device=dev).warmup())
    rec["scatter"], launches, batches = part(
        "(a)", server_scatter, eng, nodes, hot_per_batch)
    rec["trace"] = part("(b)", server_trace, eng, nodes, card,
                        hot_per_batch, bare_p50)
    rec["overload"] = part("(c)", server_overload, eng, nodes)
    rec["tenancy"] = part("(d)", server_tenancy, eng, nodes)
    rec["rpc"] = part("(e)", server_rpc, eng, nodes)
    rec["faults"] = part("(f)", server_faults, eng, nodes)
    print(f"phase 12: {sum(secs.values()):.2f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in secs.items()), flush=True)
    rec["seconds"] = secs
    rec["ladder"] = SERVER_LADDER
    rec["config"] = SERVER_CFG
    return rec, launches, batches


MAG_COUNTS = {"paper": 2_000_000, "author": 600_000, "inst": 30_000}
MAG_CITES = ("paper", "cites", "paper")
MAG_WRITES = ("author", "writes", "paper")
MAG_EMPLOYS = ("inst", "employs", "author")
MAG_RELS = [(MAG_CITES, 20), (MAG_WRITES, 3), (MAG_EMPLOYS, 2)]
MAG_DIM, MAG_HIDDEN, MAG_CLASSES = 768, 1024, 153
MAG_SIZES = [25, 15]
MAG_LR = 1e-3                  # the OGB-LSC MAG240M R-GNN baseline's
MAG_STEPS = 32                 # (a): timed steps after one warm-up
MAG_ARM_STEPS = 8              # (c)-(e): batches or steps of each arm
MAG_INST_CAP = 30_000
MAG_COLD_BUDGET = 500_000      # above a step's 425,984 paper slots
MAG_FP32_ROWS = 2**19          # the fp32 host table of the width check


class host_rss_peak:
    """The process's resident host memory before a block and its peak
    during it, in bytes: ``/proc/self/status``'s VmRSS sampled every 5 ms
    on a thread."""

    @staticmethod
    def rss() -> int:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) * 1024
        return 0

    def __enter__(self):
        import threading
        self.before = self.peak = self.rss()
        self._stop = threading.Event()

        def watch():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, self.rss())
        self._t = threading.Thread(target=watch, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.after = self.rss()
        self.peak = max(self.peak, self.after)


def mag_graph(dev):
    """``tests/test_mag240m_scale.py``'s typed graph from seed 0 (numpy,
    the recipe's draws), placed on the card: papers cite about 20 papers,
    about 3 authors write each paper, about 2 institutions employ each
    author. Returns the ``HeteroCSRTopo``."""
    import numpy as np
    from quiver_tpu_torch import CSRTopo, HeteroCSRTopo
    rng = np.random.default_rng(SEED)
    rels = {}
    for et, avg in MAG_RELS:
        n_dst, n_src = MAG_COUNTS[et[2]], MAG_COUNTS[et[0]]
        deg = rng.integers(1, 2 * avg, n_dst).astype(np.int64)
        indptr = np.zeros(n_dst + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = rng.integers(0, n_src, int(indptr[-1]), dtype=np.int32)
        rels[et] = CSRTopo(indptr=indptr, indices=indices, device=dev)
    return HeteroCSRTopo(rels, MAG_COUNTS)


def mag_features(dev, gen):
    """``examples/hetero_rgcn.py``'s features at 768 wide, made on the
    card from the seed: noise for every type, papers shifted by twice
    their class centre; labels for the papers."""
    import torch
    n = MAG_COUNTS["paper"]
    labels = torch.randint(0, MAG_CLASSES, (n,), generator=gen, device=dev)
    centers = torch.randn(MAG_CLASSES, MAG_DIM, generator=gen, device=dev)
    feats = {t: torch.empty(c, MAG_DIM, device=dev)
             for t, c in MAG_COUNTS.items()}
    for t, f in feats.items():
        for lo in range(0, f.shape[0], 1 << 18):
            hi = min(lo + (1 << 18), f.shape[0])
            f[lo:hi] = torch.randn(hi - lo, MAG_DIM, generator=gen,
                                   device=dev)
            if t == "paper":
                f[lo:hi] += 2.0 * centers[labels[lo:hi]]
    return feats, labels


def check_hetero_contract(name, topo, seeds, layers, sizes, weighted=()):
    """On the card, every valid edge of every hop: its ``e_id`` a CSR
    slot in its target's row holding its source; ``min(deg, k)`` edges
    per valid target and none for padding; distinct slots per target
    (unless the relation draws with replacement); each frontier distinct
    and starting with the frontier before the hop. Returns the edges
    checked."""
    import torch
    pre = {"paper": seeds}
    edges = 0
    for hop, layer in enumerate(layers[::-1]):
        for t, f in layer.frontier.items():
            if f is None:
                continue
            valid = f[f >= 0]
            check(torch.unique(valid).numel() == valid.numel()
                  and bool((f[valid.numel():] == -1).all()),
                  f"{name}: frontier {t} after hop {hop} not distinct and "
                  "valid-first")
            if pre.get(t) is not None:
                before = pre[t][pre[t] >= 0]
                check(torch.equal(valid[:before.numel()], before),
                      f"{name}: frontier {t} after hop {hop} does not "
                      "start with the frontier before it")
        for et, adj in layer.adjs.items():
            t = topo.rels[et]
            indptr, indices = t.indptr.long(), t.indices
            k = sizes[hop]
            dst_front, src_front = pre[et[2]], layer.frontier[et[0]]
            s = dst_front.shape[0]
            src, dst = adj.edge_index.long()
            ok = src >= 0
            e = adj.e_id.long()
            g_dst = dst_front.long()[dst.clamp(min=0)]
            slot = e.clamp(min=0)
            check(torch.equal(ok, adj.mask) and bool((e[~ok] == -1).all()),
                  f"{name} {et}: mask and e_id fill disagree")
            check(bool((dst == torch.where(ok, torch.arange(
                      s, device=dst.device).repeat_interleave(k), -1)).all()),
                  f"{name} {et}: targets out of place")
            inrow = (indptr[g_dst] <= slot) & (slot < indptr[g_dst + 1])
            holds = indices.long()[slot] == src_front.long()[src.clamp(min=0)]
            check(bool((inrow & holds)[ok].all()),
                  f"{name} {et}: {int((~(inrow & holds) & ok).sum())} edges "
                  "whose e_id is not a slot of their target holding their "
                  "source")
            per = ok.reshape(s, k).sum(1)
            dv = dst_front >= 0
            dl = dst_front.long().clamp(min=0)
            deg = (indptr[dl + 1] - indptr[dl]).clamp(max=k)
            check(torch.equal(per, torch.where(dv, deg, 0)),
                  f"{name} {et}: edges per target differ from min(deg, k)")
            if et not in weighted:
                srt = torch.where(ok, e, -1).reshape(s, k).sort(1).values
                dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
                check(not bool(dup.any()),
                      f"{name} {et}: a target picked one slot twice")
            edges += int(ok.sum())
        pre = {t: f for t, f in layer.frontier.items()}
    return edges


def mag_step_fn(sampler, store, model, opt, labels, gen):
    """``examples/hetero_rgcn.py``'s step, inline as there: sample, look
    up the frontier's rows, the model's logits of the seeds, cross
    entropy, Adam. Returns ``(loss, valid sampled edges, layers)``, the
    first two on the card."""
    import torch
    import torch.nn.functional as F

    def step(seeds):
        _, bs, layers = sampler.sample(seeds)
        x = store.lookup(layers[0].frontier)
        model.train()
        logits = model(x, layers, generator=gen)[:bs]
        loss = F.cross_entropy(logits, labels[seeds.long()])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        edges = sum(a.mask.sum() for lay in layers
                    for a in lay.adjs.values())
        return loss.detach(), edges, layers
    return step


def timed_steps(step, batches, what):
    """One warm-up call, then one synchronised call per batch timed on the
    host clock, the launch counts set to 0 between them. Returns
    ``(latencies ms, losses, edges, warm-up ms)``."""
    import torch
    from quiver_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batches[0])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    kernels.reset_launches()
    lat, losses, edges = [], [], []
    for b in batches[1:]:
        t0 = time.perf_counter()
        loss, e = step(b)[:2]
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        edges.append(e)
    losses = torch.stack(losses).tolist()
    check(all(math.isfinite(v) for v in losses), f"{what}: losses {losses}")
    return lat, losses, int(torch.stack(edges).sum()), warm_ms


def mag_rgcn(dev, topo, edge_types):
    import torch
    from quiver_tpu_torch.models import RGCN
    from quiver_tpu_torch.models.convert import (random_rgcn_flax_params,
                                                 rgcn_flax_to_state_dict)
    dims = {t: MAG_DIM for t in MAG_COUNTS}
    model = RGCN(dims, MAG_HIDDEN, MAG_CLASSES, len(MAG_SIZES), "paper",
                 edge_types, dropout=DROPOUT)
    model.load_state_dict(rgcn_flax_to_state_dict(random_rgcn_flax_params(
        dims, MAG_HIDDEN, MAG_CLASSES, edge_types, seed=SEED)))
    model = model.to(dev)
    return model, torch.optim.Adam(model.parameters(), lr=MAG_LR)


def hetero_gathers(store, frontier, h2d, iters):
    """The paper lookup's host read at a step's frontier: the packed int8
    tier (896-byte rows) in the step's form (every slot, -1 where hot,
    into the rows) and dense, and an fp32 pinned table of 768-wide rows
    on the same ids; each against its plain version bit for bit, then
    timed (wrapper, own, plain) against its bound. Returns the records
    and the step's ids."""
    import torch
    from quiver_tpu_torch.ops import kernels, quant
    from quiver_tpu_torch.ops.kernels import gather
    f = store["paper"]
    tab = f._host_offload
    t = f.feature_order.long()[frontier.long().clamp(min=0)]
    cold = (frontier >= 0) & (t >= f.cache_rows)
    holes = torch.where(cold, t - f.cache_rows, -1).to(torch.int32)
    dense = holes[holes >= 0].contiguous()
    f32 = quant.dequantize(quant.QuantizedTensor(
        *(c[:MAG_FP32_ROWS] for c in tab))).pin_memory()
    n = holes.shape[0]
    base = torch.full((n, MAG_DIM), 7.5, device=frontier.device)
    f32_ids = dense % MAG_FP32_ROWS
    f32_kernel = gather.raw_launch(f32, base)[2]
    made_once(kernels.RAW_LAUNCHES,
              lambda: gather.gather_rows(f32, f32_ids), f32_kernel,
              "hetero gather fp32")
    recs = {}
    for name, table, ids, out, kname in (
            ("int8 step", tab, holes, base, "gather_rows_packed_kernel"),
            ("int8 dense", tab, dense, None, "gather_rows_packed_kernel"),
            ("fp32", f32, f32_ids, None, f32_kernel)):
        def run(plain=False):
            fn = gather.gather_rows_plain if plain else gather.gather_rows
            return fn(table, ids) if out is None else fn(table, ids,
                                                         out=out.clone())
        got, want = run(), run(True)
        check(same_bits(got, want), f"hetero gather {name} at D={MAG_DIM} "
              "differs from its plain version")
        del got, want
        ms = cuda_ms(run, iters)
        # the kernel alone: into one buffer, no clone
        dst = None if out is None else out.clone()
        alone = (lambda: gather.gather_rows(table, ids)) if dst is None \
            else (lambda: gather.gather_rows(table, ids, out=dst))
        own = own_ms(alone, kname, iters)
        burst = burst_ms(alone, iters)
        del dst
        plain_ms = cuda_ms(lambda: run(True), 3)
        b_ms, b_by, host_bytes, dev_bytes, distinct = host_gather_bound(
            table, ids, h2d)
        share = "" if own is None else f" (bound / own {b_ms / own:.0%})"
        stride = table.data.stride(0) if quant.is_quantized(table) \
            else MAG_DIM * 4
        print(f"hetero gather_rows {name}: {ids.shape[0]} ids, {distinct} "
              f"distinct rows, D={MAG_DIM}, {stride}-byte host rows "
              f"({kname}): "
              f"wrapper {ms:.4f} ms, kernel own {fmt_ms(own)}{share}, "
              f"{iters} back to back {burst:.4f} ms a call (bound / burst "
              f"{b_ms / burst:.0%}), plain {plain_ms:.4f} ms; reads {host_bytes} B from the host at "
              f"{h2d / 1e9:.2f} GB/s and moves {dev_bytes} B on the card: "
              f"bound {b_ms:.4f} ms ({b_by}); equal to the plain version "
              "bit for bit", flush=True)
        recs[name] = {"ids": int(ids.shape[0]), "distinct_rows": distinct,
                      "row_stride_bytes": int(stride), "ms": ms,
                      "own_ms": own, "burst_ms": burst,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": "bytes", "library_ms": None,
                      "max_abs_err": 0.0, "kernel": kname}
    del f32
    return recs


def hetero_train(dev, topo, store, labels, order, card):
    """(a): the R-GCN on the exact sampler, timed, counted and profiled;
    the cold budget and the institution cap checked; the sample and the
    lookup held sync-free. Returns the record, the launches of the timed
    steps, the model and optimiser, and a step's frontier."""
    import torch
    from quiver_tpu_torch import HeteroGraphSageSampler, metrics
    from quiver_tpu_torch.ops import kernels
    sampler = HeteroGraphSageSampler(
        topo, MAG_SIZES, seed_type="paper", seed=SEED,
        frontier_cap={"inst": MAG_INST_CAP}, device=dev)
    t0 = time.perf_counter()
    _, bs, layers = sampler.sample(order[:BATCH])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    edge_types = [list(lay.adjs) for lay in layers]
    model, opt = mag_rgcn(dev, topo, edge_types)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = mag_step_fn(sampler, store, model, opt, labels, gen)
    batches = [order[i * BATCH:(i + 1) * BATCH].contiguous()
               for i in range(MAG_STEPS + 6)]
    lat, losses, edges, warm_ms = timed_steps(
        step, batches[:1 + MAG_STEPS], "R-GCN")
    launches = dict(kernels.LAUNCHES)
    want = {k: 0 for k in launches}
    want["gather_rows"] = MAG_STEPS
    check(launches == want, f"R-GCN step launches {launches}: one "
          "gather_rows a step expected")
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    check(last < first, f"R-GCN loss did not fall: first 8 mean {first}, "
          f"last 8 mean {last}")
    p50, p99 = pcts(lat)
    wall_s = sum(lat) / 1e3
    print(f"hetero (a) R-GCN {MAG_DIM}->{MAG_HIDDEN}->{MAG_CLASSES}, "
          f"sizes {MAG_SIZES} per relation, batch {BATCH}, dropout "
          f"{DROPOUT}, Adam lr {MAG_LR}, exact wide sampler: {MAG_STEPS} "
          f"steps, step p50 {p50:.3f} ms p99 {p99:.3f} ms (host clock + "
          f"synchronize; sample, lookup, forward, backward, Adam; the "
          f"warm-up step {warm_ms:.3f} ms, the sampler's first sample and "
          f"set-up {setup_s:.3f} s), {edges} sampled edges = "
          f"{edges / wall_s:.6g} sampled edges/s; gather_rows launches per "
          f"step {launches['gather_rows'] / MAG_STEPS:g}, no other "
          f"kernel of the port; loss first {losses[0]:.4f} last "
          f"{losses[-1]:.4f}, mean of the first 8 {first:.4f}, of the last "
          f"8 {last:.4f} (ln {MAG_CLASSES} = {math.log(MAG_CLASSES):.4f}); "
          f"every loss: {' '.join(f'{v:.4f}' for v in losses)}; on {card}",
          flush=True)
    prof = {}
    busy = device_profile(lambda: [step(b) for b in batches[-5:-1]], 4,
                          "R-GCN step", stats=prof)

    # the frontier of one more batch: its capacities, the cold budget,
    # the institution cap, and the sync checks
    seeds = batches[-1]
    sampler.sample(seeds)
    _, _, layers = sync_free(lambda: sampler.sample(seeds), "hetero sample")
    x = sync_free(lambda: store.lookup(layers[0].frontier),
                  "HeteroFeature.lookup")
    caps = {t: (None if f is None else int(f.shape[0]))
            for t, f in layers[0].frontier.items()}
    inner = {t: (None if f is None else int(f.shape[0]))
             for t, f in layers[1].frontier.items()}
    k0, k1 = MAG_SIZES           # hetero.py's capacities, worked out
    p0, a0 = BATCH * (1 + k0), BATCH * k0
    check(inner == {"author": a0, "inst": None, "paper": p0} and caps == {
              "author": a0 + p0 * k1, "inst": min(a0 * k1, MAG_INST_CAP),
              "paper": p0 * (1 + k1)},
          f"frontier capacities {inner} then {caps}")
    paper = layers[0].frontier["paper"]
    _, vec = store["paper"].lookup_tiered(paper, masked=True,
                                          collect_metrics=True)
    vec = vec.tolist()
    check(vec[metrics.DEDUP_OVERFLOW] == 0 and
          vec[metrics.COLD_ROWS] <= MAG_COLD_BUDGET,
          f"paper lookup counters {vec}: the cold budget overflowed")
    emp = layers[0].adjs[MAG_EMPLOYS]
    authors = layers[1].frontier["author"]
    ip = topo.rels[MAG_EMPLOYS].indptr.long()
    a = authors.long().clamp(min=0)
    want_e = int(torch.where(authors >= 0, (ip[a + 1] - ip[a]).clamp(
        max=MAG_SIZES[1]), 0).sum())
    n_inst = int(layers[0].counts["inst"])
    check(int(emp.mask.sum()) == want_e and n_inst <= MAG_INST_CAP,
          f"the institution cap masked edges: {int(emp.mask.sum())} of "
          f"{want_e}, {n_inst} institutions")
    valid = {t: int((f >= 0).sum()) for t, f in layers[0].frontier.items()
             if f is not None}
    out_gb = sum(v.numel() * 4 for v in x.values()) / 1e9
    print(f"hetero (a) frontier capacities after hop 0 {inner}, after hop "
          f"1 {caps}; valid {valid}; lookup output {out_gb:.3f} GB fp32; "
          f"paper lookup: hot rows {vec[metrics.HOT_ROWS]}, cold rows "
          f"{vec[metrics.COLD_ROWS]} (budget {MAG_COLD_BUDGET}, dedup "
          f"overflows {vec[metrics.DEDUP_OVERFLOW]}); employs: "
          f"{int(emp.mask.sum())} edges = sum of min(deg, "
          f"{MAG_SIZES[1]}), {n_inst} institutions under the cap "
          f"{MAG_INST_CAP} (no edge masked); sample() and lookup() free of "
          "host synchronisation", flush=True)
    rec = {"steps": MAG_STEPS, "step_p50_ms": p50, "step_p99_ms": p99,
           "warmup_ms": warm_ms, "sampler_setup_s": setup_s,
           "edges_per_s": edges / wall_s, "loss_first8": first,
           "loss_last8": last, "losses": losses,
           "device_ms_per_step": busy, **prof,
           "gather_rows_per_step": launches["gather_rows"] / MAG_STEPS,
           "frontier_caps": caps, "frontier_valid": valid,
           "paper_hot_rows": vec[metrics.HOT_ROWS],
           "paper_cold_rows": vec[metrics.COLD_ROWS],
           "lookup_output_gb": out_gb}
    return rec, launches, model, opt, layers, seeds, sampler


def hetero_plain(store, model, layers, seeds, labels, card):
    """(b): the paper lookup through the kernel against the same lookup
    through the gather's plain version (same card tensors) bit for bit,
    and one R-GCN step from the same parameters on each, deterministic:
    the loss within ``LOSS_TOL`` and each gradient within ``GRAD_TOL``
    of its largest entry."""
    import torch
    import torch.nn.functional as F
    from quiver_tpu_torch import feature
    from quiver_tpu_torch.ops.kernels import gather
    frontier = layers[0].frontier
    x_k = store.lookup(frontier)
    feature.gather_rows = gather.gather_rows_plain
    try:
        t0 = time.perf_counter()
        x_p = store.lookup(frontier)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        feature.gather_rows = gather.gather_rows
    for t in x_k:
        check(same_bits(x_k[t], x_p[t]), f"hetero lookup {t}: the kernel's "
              "rows differ from the plain version's")

    def loss_of(m, x):
        m.eval()       # dropout off: the two runs see the same network
        return F.cross_entropy(m(x, layers)[:BATCH], labels[seeds.long()])
    with deterministic():
        loss_k, grads_k = grads_of(copy.deepcopy(model),
                                   lambda m: loss_of(m, x_k))
        loss_p, grads_p = grads_of(copy.deepcopy(model),
                                   lambda m: loss_of(m, x_p))
    check(abs(loss_k - loss_p) <= LOSS_TOL,
          f"R-GCN loss {loss_k} through the kernel, {loss_p} plain")
    worst, exact = 0.0, loss_k == loss_p
    for n, g in grads_k.items():
        rel = max_abs(g, grads_p[n]) / max(float(grads_p[n].abs().max()),
                                           1e-30)
        check(rel <= GRAD_TOL, f"R-GCN gradient {n}: {rel:.3g} of its "
              "largest entry from the plain walk's")
        worst = max(worst, rel)
        exact = exact and same_bits(g, grads_p[n])
    print(f"hetero (b) the lookup through gather_rows_packed_kernel equals "
          f"the lookup through the plain version bit for bit "
          f"({', '.join(f'{t} {tuple(v.shape)}' for t, v in x_k.items())}; "
          f"the plain lookup {plain_s:.3f} s); one step from the same "
          f"parameters, deterministic: loss {loss_k:.6f} vs {loss_p:.6f}, "
          f"{len(grads_k)} gradients within {worst:.3g} of their largest "
          f"entry ({'bit for bit' if exact else 'not bit for bit'}); on "
          f"{card}", flush=True)
    return {"lookup_bit_equal": True, "loss_kernel": loss_k,
            "loss_plain": loss_p, "grad_worst_rel": worst,
            "step_bit_equal": exact}


def hetero_modes(dev, topo, order, card):
    """(c): rotation (butterfly, overlap) and window (sort, pair), the
    sampler alone on ``MAG_ARM_STEPS`` batches each: reshuffle time,
    sampled edges per second, and the contract on every batch."""
    import torch
    from quiver_tpu_torch import HeteroGraphSageSampler
    recs = {}
    for name, kw in (("rotation overlap+butterfly",
                      dict(sampling="rotation", layout="overlap",
                           shuffle="butterfly")),
                     ("window pair+sort", dict(sampling="window"))):
        s = HeteroGraphSageSampler(
            topo, MAG_SIZES, seed_type="paper", seed=SEED, with_eid=True,
            frontier_cap={"inst": MAG_INST_CAP}, device=dev, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.reshuffle()
        torch.cuda.synchronize()
        shuffle_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        s.reshuffle()
        torch.cuda.synchronize()
        again_ms = (time.perf_counter() - t0) * 1e3
        batches = [order[i * BATCH:(i + 1) * BATCH].contiguous()
                   for i in range(MAG_ARM_STEPS + 1)]
        s.sample(batches[0])
        lat, outs = [], []
        for b in batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = s.sample(b)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            outs.append((b, out[2]))
        edges = sum(check_hetero_contract(f"hetero (c) {name}", topo, b, ls,
                                          MAG_SIZES) for b, ls in outs)
        p50, p99 = pcts(lat)
        seps = edges / (sum(lat) / 1e3)
        print(f"hetero (c) {name}: reshuffle {shuffle_ms:.3f} ms (first), "
              f"{again_ms:.3f} ms (second), then {MAG_ARM_STEPS} batches: "
              f"sample p50 {p50:.3f} ms p99 {p99:.3f} ms, {edges} sampled "
              f"edges = {seps:.6g} sampled edges/s; every edge's e_id a slot"
              " of its target holding its source, min(deg, k) edges per "
              "target at distinct slots, frontiers distinct and prefixed; "
              f"on {card}", flush=True)
        recs[name] = {"reshuffle_ms": [shuffle_ms, again_ms],
                      "sample_p50_ms": p50, "sample_p99_ms": p99,
                      "edges_per_s": seps, "edges": edges}
        del s, outs
    return recs


def hetero_weighted(dev, gen, topo, store, labels, model, opt, order,
                    card):
    """(d): ``examples/hetero_rgcn.py --weighted``: exponential weights on
    cites, ``with_eid``, ``MAG_ARM_STEPS`` training steps; the edge-id
    contract on every sampled edge of every step."""
    import torch
    from quiver_tpu_torch import HeteroGraphSageSampler
    from quiver_tpu_torch.ops import kernels
    e = topo.rels[MAG_CITES].edge_count
    w = torch.empty(e, device=dev).exponential_(1.0, generator=gen)
    s = HeteroGraphSageSampler(
        topo, MAG_SIZES, seed_type="paper", seed=SEED,
        edge_weight={MAG_CITES: w}, with_eid=True,
        frontier_cap={"inst": MAG_INST_CAP}, device=dev)
    inner = mag_step_fn(s, store, model, opt, labels,
                        torch.Generator(device=dev).manual_seed(SEED + 1))
    seen = []

    def step(seeds):
        out = inner(seeds)
        seen.append((seeds, out[2]))
        return out
    batches = [order[i * BATCH:(i + 1) * BATCH].contiguous()
               for i in range(MAG_ARM_STEPS + 1)]
    lat, losses, edges, warm_ms = timed_steps(step, batches,
                                              "weighted R-GCN")
    launches = kernels.LAUNCHES["gather_rows"]
    check(launches == MAG_ARM_STEPS,
          f"weighted steps launched gather_rows {launches} times")
    checked = sum(check_hetero_contract(
        "hetero (d) weighted", topo, b, ls, MAG_SIZES, weighted={MAG_CITES})
        for b, ls in seen)
    p50, p99 = pcts(lat)
    seps = edges / (sum(lat) / 1e3)
    print(f"hetero (d) weighted cites (exponential weights), with_eid: "
          f"{MAG_ARM_STEPS} R-GCN steps, step p50 {p50:.3f} ms p99 "
          f"{p99:.3f} ms (warm-up {warm_ms:.3f} ms), {edges} sampled edges "
          f"= {seps:.6g} sampled edges/s, gather_rows launches per step "
          f"{launches / MAG_ARM_STEPS:g}, losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; the edge-id contract on "
          f"{checked} edges of the {len(seen)} steps' samples; on {card}",
          flush=True)
    return {"step_p50_ms": p50, "step_p99_ms": p99, "edges_per_s": seps,
            "losses": losses, "edges_checked": checked,
            "gather_rows_per_step": launches / MAG_ARM_STEPS}


def hetero_mag240m(dev, topo, store, labels, order, card):
    """(e): ``MAG240MGNN`` (graphsage, then gat with 4 heads) on the
    paper-cites-paper projection: the port's ``GraphSageSampler`` over
    the cites topology and the paper store's masked lookup,
    ``MAG_ARM_STEPS`` training steps each after one warm-up."""
    import torch
    import torch.nn.functional as F
    from quiver_tpu_torch import GraphSageSampler
    from quiver_tpu_torch.models import MAG240MGNN
    from quiver_tpu_torch.models.convert import (mag_flax_to_state_dict,
                                                 random_mag_flax_params)
    from quiver_tpu_torch.ops import kernels
    sampler = GraphSageSampler(topo.rels[MAG_CITES], MAG_SIZES, device=dev,
                               seed=SEED)
    batches = [order[i * BATCH:(i + 1) * BATCH].contiguous()
               for i in range(MAG_ARM_STEPS + 1)]
    recs = {}
    for variant in ("graphsage", "gat"):
        model = MAG240MGNN(variant, MAG_DIM, MAG_HIDDEN, MAG_CLASSES,
                           len(MAG_SIZES), heads=4, dropout=DROPOUT)
        model.load_state_dict(mag_flax_to_state_dict(random_mag_flax_params(
            variant, MAG_DIM, MAG_HIDDEN, MAG_CLASSES, len(MAG_SIZES),
            heads=4, seed=SEED)))
        model = model.to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=MAG_LR)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def step(seeds):
            n_id, bs, adjs = sampler.sample(seeds)
            x = store["paper"].getitem_masked(n_id)
            model.train()
            loss = F.cross_entropy(model(x, adjs, generator=gen)[:bs],
                                   labels[seeds.long()])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach(), sum(a.mask.sum() for a in adjs)
        lat, losses, edges, warm_ms = timed_steps(step, batches,
                                                  f"MAG240MGNN {variant}")
        launches = dict(kernels.LAUNCHES)
        want = {k: 0 for k in launches}
        want["gather_rows"] = MAG_ARM_STEPS
        check(launches == want, f"MAG240MGNN {variant} launches {launches}")
        p50, p99 = pcts(lat)
        seps = edges / (sum(lat) / 1e3)
        print(f"hetero (e) MAG240MGNN {variant} {MAG_DIM}->{MAG_HIDDEN}"
              f"{' (4 heads)' if variant == 'gat' else ''}->MLP->"
              f"{MAG_CLASSES} on paper-cites-paper, GraphSageSampler "
              f"{MAG_SIZES}, int8 paper store: {MAG_ARM_STEPS} steps, step "
              f"p50 {p50:.3f} ms p99 {p99:.3f} ms (warm-up {warm_ms:.3f} "
              f"ms), {edges} sampled edges = {seps:.6g} sampled edges/s, "
              f"gather_rows launches per step "
              f"{launches['gather_rows'] / MAG_ARM_STEPS:g}, losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}; on {card}",
              flush=True)
        recs[variant] = {"step_p50_ms": p50, "step_p99_ms": p99,
                         "edges_per_s": seps, "losses": losses,
                         "gather_rows_per_step":
                             launches["gather_rows"] / MAG_ARM_STEPS}
        del model, opt
    return recs


def hetero_prefetch(sampler, store, order, card):
    """(f): ``HeteroFeature.prefetch`` of two frontiers at once equals
    ``lookup`` bit for bit, staged on its own stream of the ids' card
    without a host synchronisation."""
    import torch
    frontiers = [sampler.sample(order[i * BATCH:(i + 1) * BATCH]
                                .contiguous())[2][0].frontier
                 for i in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sync_free(lambda: [f.result(timeout=120) for f in
                             [store.prefetch(x) for x in frontiers]],
                    "HeteroFeature.prefetch")
    torch.cuda.synchronize()
    pf_ms = (time.perf_counter() - t0) * 1e3
    dev = frontiers[0]["paper"].device
    check(set(store._streams) == {dev} and
          store._streams[dev] != torch.cuda.current_stream(dev),
          "the prefetch did not stage on its own stream of the ids' card")
    for g, f in zip(got, frontiers):
        want = store.lookup(f)
        check(list(g) == list(want) and all(same_bits(g[t], want[t])
                                            for t in want),
              "HeteroFeature.prefetch differs from lookup")
    del got
    print(f"hetero (f) HeteroFeature.prefetch of 2 frontiers at once: "
          f"{pf_ms:.3f} ms to both results (host clock), staged on the "
          f"pipeline's own stream of {dev}, no host synchronisation, equal "
          f"to lookup bit for bit; on {card}", flush=True)
    return {"two_frontiers_ms": pf_ms, "bit_equal": True}


def phase_hetero(dev, card):
    """Phase 13: the typed-graph path at MAG240M's widths (module doc).
    Returns its record and the launches of (a)'s timed steps."""
    import torch
    from quiver_tpu_torch import HeteroFeature
    from quiver_tpu_torch.ops import quant
    secs = {}
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    with host_rss_peak() as mem:
        t0 = time.perf_counter()
        topo = mag_graph(dev)
        feats, labels = mag_features(dev, gen)
        torch.cuda.synchronize()
        secs["graph and features"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        store = HeteroFeature.from_cpu_tensors(
            feats, configs={"paper": dict(
                device_cache_size=(MAG_COUNTS["paper"] // 4)
                * quant.row_bytes(MAG_DIM, "int8"),
                csr_topo=topo.rels[MAG_CITES], dtype_policy="int8",
                host_placement="offload", dedup_cold=True,
                cold_budget=MAG_COLD_BUDGET)},
            default=dict(device_cache_size=MAG_COUNTS["author"] * MAG_DIM
                         * 4, device=dev))
        del feats
        torch.cuda.synchronize()
        secs["stores"] = time.perf_counter() - t0
    paper = store["paper"]
    stride = paper._host_offload.data.stride(0)
    check(paper.cache_rows == MAG_COUNTS["paper"] // 4 and stride == 896
          and all(store[t].cache_rows == MAG_COUNTS[t]
                  and store[t]._host_offload is None
                  and store[t].host_part is None for t in ("author", "inst")),
          f"store layout: paper hot rows {paper.cache_rows}, packed stride "
          f"{stride}")
    growth = mem.peak - mem.before
    check(growth < 8e9, f"building the stores grew host memory by "
          f"{growth / 1e9:.2f} GB")
    pinned = quant.tier_rows(paper._host_offload) * stride
    edges = ", ".join(f"{et[1]} {t.edge_count} edges"
                      for et, t in topo.rels.items())
    print(f"hetero setup: {edges} over {MAG_COUNTS}; features {MAG_DIM} "
          f"wide made on the card; graph and features "
          f"{secs['graph and features']:.2f} s, stores "
          f"{secs['stores']:.2f} s; paper int8, {paper.cache_rows} rows hot "
          f"by cites degree, {quant.tier_rows(paper._host_offload)} pinned "
          f"as {stride}-byte packed rows ({pinned / 1e9:.3f} GB); author "
          f"and inst fp32 on the card; host RSS before {mem.before / 1e9:.3f}"
          f" GB, peak during the build {mem.peak / 1e9:.3f} GB (+"
          f"{growth / 1e9:.3f} GB), after {mem.after / 1e9:.3f} GB; on "
          f"{card}", flush=True)
    order = torch.randperm(MAG_COUNTS["paper"], generator=gen,
                           device=dev).to(torch.int32)
    span = 64 * BATCH
    h2d, _ = h2d_rate(dev)

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out
    train, launches, model, opt, layers, seeds, sampler = part(
        "(a)", hetero_train, dev, topo, store, labels, order, card)
    rec = {"config": {"counts": MAG_COUNTS, "dim": MAG_DIM,
                      "hidden": MAG_HIDDEN, "classes": MAG_CLASSES,
                      "sizes": MAG_SIZES, "batch": BATCH, "lr": MAG_LR,
                      "dropout": DROPOUT, "inst_cap": MAG_INST_CAP,
                      "cold_budget": MAG_COLD_BUDGET},
           "setup": {"seconds": dict(secs), "host_rss_before": mem.before,
                     "host_rss_peak": mem.peak, "host_rss_after": mem.after,
                     "pinned_bytes": pinned},
           "train": train}
    rec["gather"] = part("gathers", hetero_gathers, store,
                         layers[0].frontier["paper"], h2d, 10)
    rec["gather"]["h2d_bytes_per_s"] = h2d
    rec["plain"] = part("(b)", hetero_plain, store, model, layers, seeds,
                        labels, card)
    del layers
    rec["modes"] = part("(c)", hetero_modes, dev, topo, order[span:], card)
    rec["weighted"] = part("(d)", hetero_weighted, dev, gen, topo, store,
                           labels, model, opt, order[2 * span:], card)
    del model, opt
    rec["mag240m"] = part("(e)", hetero_mag240m, dev, topo, store, labels,
                          order[3 * span:], card)
    rec["prefetch"] = part("(f)", hetero_prefetch, sampler, store,
                           order[4 * span:], card)
    store.close()
    total = time.perf_counter() - t_phase
    print(f"phase 13: {total:.2f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in secs.items()), flush=True)
    rec["seconds"] = dict(secs, total=total)
    return rec, launches


# -- rank processes: phase 14 (b) and the multi-rank tests ------------------
#
# ``RankPool(world_size)`` spawns ``world_size`` processes that join one
# ``torch.distributed`` group through a ``file://`` rendezvous in a fresh
# temporary directory (no TCP port to collide with another pool on the
# machine) and then run the calls they are sent: ``pool.run(fn, *args)``
# calls ``fn(ctx, *args)`` on every rank at once and returns the ranks'
# results in rank order. Phase 14 (b) and the port's multi-rank CPU tests
# (``tests/test_torch_comm.py`` and the others, one pool a module) drive
# their ranks through it: one spawn and many calls, since each spawn
# imports torch anew.
#
# Every wait is bounded. The group's ``timeout`` bounds each collective, so
# a rank whose peers died or took another branch raises instead of
# hanging; ``run`` waits at most ``call_timeout`` for the results, and
# after a failure or a timeout the pool is closed (its processes ended) and
# refuses further calls.
#
# ``fn`` must be importable by name (a module-level function); its
# arguments and results cross processes by pickle (``torch.multiprocessing``:
# CUDA tensors go as IPC handles, which the sender must keep alive while
# the ranks use them). CPU tensors in a result come back as numpy arrays,
# bf16 ones as tensors.


class RankContext(NamedTuple):
    """What a call runs with on its rank: the rank, the world size, and
    the groups by size (``groups[world_size]`` the whole group; a
    subgroup of the first ``h`` ranks at ``groups[h]``, None on the
    ranks outside it)."""

    rank: int
    world_size: int
    groups: dict


def _rank_host(obj):
    """``obj`` with CPU tensors as numpy arrays (bf16 ones, which numpy
    lacks, stay tensors), through lists, tuples and dicts."""
    import torch
    if torch.is_tensor(obj) and obj.device.type == "cpu" \
            and obj.dtype != torch.bfloat16:
        return obj.detach().numpy().copy()
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_rank_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _rank_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, world_size, backend, init_method, timeout, subgroups,
               tasks, results):
    """A rank's loop: join the group, make the subgroups, run calls
    until told to stop (None)."""
    import torch
    import torch.distributed as tdist
    try:
        from quiver_tpu_torch import init_distributed
        if backend == "nccl":
            torch.cuda.set_device(0 if torch.cuda.device_count() == 1
                                  else rank)
        init_distributed(backend, init_method, world_size, rank, timeout)
        groups = {world_size: tdist.group.WORLD}
        for h in subgroups:
            grp = tdist.new_group(list(range(h)))
            groups[h] = grp if rank < h else None
        ctx = RankContext(rank, world_size, groups)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "ready"))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, True, _rank_host(fn(ctx, *args))))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    tdist.destroy_process_group()


class RankPool:
    """``world_size`` spawned ranks of one process group (``backend``
    ``"gloo"`` or ``"nccl"``), each group collective bounded by
    ``timeout`` seconds; ``subgroups`` lists sizes ``h`` of subgroups
    of the first ``h`` ranks to make as well. Use as a context manager,
    or call :meth:`close`."""

    def __init__(self, world_size: int, backend: str = "gloo",
                 timeout: float = 60.0, subgroups=(),
                 call_timeout: float = 300.0):
        import torch.multiprocessing as mp
        self.world_size = int(world_size)
        self.call_timeout = float(call_timeout)
        self._dir = tempfile.mkdtemp(prefix="qt_ranks_")
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(self.world_size)]
        self._results = ctx.Queue()
        init_method = "file://" + os.path.join(self._dir, "rendezvous")
        self._procs = [
            ctx.Process(target=_rank_main,
                        args=(r, self.world_size, backend, init_method,
                              float(timeout), tuple(subgroups),
                              self._tasks[r], self._results),
                        daemon=True)
            for r in range(self.world_size)]
        self._closed = False
        for p in self._procs:
            p.start()
        self._collect("start")

    def _collect(self, what: str) -> list:
        out = [None] * self.world_size
        errors = []
        try:
            for _ in range(self.world_size):
                rank, ok, val = self._results.get(timeout=self.call_timeout)
                if ok:
                    out[rank] = val
                else:
                    errors.append(f"rank {rank}:\n{val}")
        except queue.Empty:
            errors.append(f"no result within {self.call_timeout:g} s")
        if errors:
            self.close()
            raise RuntimeError(f"RankPool {what} failed; the pool is "
                               "closed:\n" + "\n".join(errors))
        return out

    def run(self, fn, *args) -> list:
        """``fn(ctx, *args)`` on every rank; the results in rank order."""
        if self._closed:
            raise RuntimeError("the RankPool is closed")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(getattr(fn, "__name__", "call"))

    def close(self):
        """Stop the ranks (ending any that do not stop within the group
        timeout) and remove the rendezvous directory."""
        if self._closed:
            return
        self._closed = True
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc):
        self.close()


SHARD_BATCHES = 16             # (a): timed sharded batches of each arm
SHARD_STEPS = 32               # (a): timed steps of each train step
SHARD_RANKS = 4                # (b): gloo ranks sharing the card
SHARD_CHECK_BATCHES = 2        # (b): batches of each arm held to (a)
SHARD_TIMEOUT = 300.0          # (b): the group's collective timeout, s
SHARD_TRAIN_FRAC = 5           # (b): a fifth of the nodes train


def gather_calls(fn):
    """``fn()`` with every ``gather_rows`` call of the exchange
    (``comm.gather_rows``) recorded: ``(result, [(table, ids, out),
    ...])``, ``out`` a copy of the destination as it was passed."""
    from quiver_tpu_torch import comm
    calls, real = [], comm.gather_rows

    def spy(table, ids, out=None):
        calls.append((table, ids.clone(),
                      None if out is None else out.clone()))
        return real(table, ids, out=out)
    comm.gather_rows = spy
    try:
        return fn(), calls
    finally:
        comm.gather_rows = real


def exchange_gather_timing(calls, card, iters):
    """Each recorded exchange gather against its plain version (bit for
    bit), with its own time, the wrapper's, the plain version's,
    ``index_select``'s where it computes the same function (the owner's
    read of raw rows), and the bound: ids read once, each live row read
    once (its data bytes, not a packed row's padding) and written once,
    at 3.35 TB/s."""
    import torch
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import gather
    out = {}
    for name, (table, ids, dest) in zip(("owner read", "unbucket+decode"),
                                        calls):
        if dest is None:
            run = lambda: gather.gather_rows(table, ids)    # noqa: E731
            plain = lambda: gather.gather_rows_plain(table, ids)  # noqa
            got, want = run(), plain()
            live = ids.shape[0]
        else:
            got = gather.gather_rows(table, ids, out=dest.clone())
            want = gather.gather_rows_plain(table, ids, out=dest.clone())
            buf = dest.clone()        # the timed calls rewrite one block
            run = lambda: gather.gather_rows(table, ids,     # noqa: E731
                                             out=buf)
            plain = lambda: gather.gather_rows_plain(      # noqa: E731
                table, ids, out=buf)
            live = int((ids >= 0).sum())
        check(same_bits(got, want), f"exchange {name}: kernel differs from "
              "its plain version")
        # the received block lies on the card: the HBM design's kernel;
        # the owner's shard read as raw rows by the dispatched design
        kernel = (gather.packed_kernel(quant.tier_parts(table)[0].device
                                       .type == "cpu")
                  if quant.is_quantized(table)
                  else gather.raw_launch(table, got)[2])
        # the out= form skips -1 ids: it reads and writes live rows only
        row_in = quant.row_read_bytes(table)
        row_out = got.shape[1] * got.element_size()
        nbytes = 4 * ids.shape[0] + (row_in + row_out) * live
        lib = None
        if dest is None:
            idx = ids.long()
            lib = cuda_ms(lambda: table.index_select(0, idx), iters)
        rec = {"ids": int(ids.shape[0]), "live_rows": live,
               "row_bytes_in": int(row_in),
               "row_bytes_out": int(row_out),
               "max_abs_err": 0.0, "ms": cuda_ms(run, iters),
               "own_ms": own_ms(run, kernel, iters),
               "burst_ms": burst_ms(run, iters),
               "plain_ms": cuda_ms(plain, iters),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": lib, "kernel": kernel}
        out[name] = rec
        print(f"sharded gather_rows {name}: {rec['ids']} ids "
              f"({live} live), {kernel}, own {fmt_ms(rec['own_ms'])}, "
              f"back to back {rec['burst_ms']:.4f} ms a call, wrapper "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"index_select {fmt_ms(lib)}, bound {rec['bound_ms']:.4f} ms "
              f"({nbytes} bytes at 3.35 TB/s); equal to its plain version; "
              f"on {card}", flush=True)
    return out


def count_syncs(fn) -> int:
    """The host synchronisations ``fn()`` makes, as the registry's
    no_host_sync check on the card counts them."""
    return card_host_syncs(fn)[1]


def sage(dev, dropout=0.0):
    """Phase 3's GraphSAGE (100 -> 256 -> 256 -> 47) with its random
    weights from the seed, and those weights as a state dict."""
    from quiver_tpu_torch import GraphSAGE
    from quiver_tpu_torch.models.convert import (flax_to_state_dict,
                                                 random_flax_params)
    params = flax_to_state_dict(
        random_flax_params(DIM, HIDDEN, CLASSES, len(SIZES), seed=SEED))
    model = GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES), dropout=dropout)
    model.load_state_dict(params)
    return model.to(dev), params


def sharded_arm(eng, requests, hop_seeds):
    """One arm's timed batches (metered): host-clock latencies, the
    counters of each batch and the host synchronisations of one."""
    import torch
    lat, counters = [], []
    for ids, hs in zip(requests, hop_seeds):
        t0 = time.perf_counter()
        eng.run(ids, hop_seeds=hs)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        counters.append(eng.last_counters.cpu())
    syncs = count_syncs(lambda: eng.run(requests[0], hop_seeds=hop_seeds[0]))
    return lat, torch.stack(counters), syncs


def sharded_world1(dev, card, g, group):
    """(a): the sharded serve path and both train steps at world size 1
    over NCCL, in this process."""
    import torch
    from quiver_tpu_torch import (DistFeature, PartitionInfo, ServeEngine,
                                  ShardedServeEngine, TorchComm, metrics)
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.ops.kernels import fused, gather
    from quiver_tpu_torch.parallel.train import draw_int32
    from quiver_tpu_torch.pyg.sage_sampler import layer_shapes

    t0 = time.perf_counter()
    info = PartitionInfo(hosts=1, global2host=torch.zeros(NODES,
                                                          dtype=torch.int32))
    dist = DistFeature.from_partition(g["feat"], info,
                                      TorchComm(0, 1, group=group),
                                      dtype_policy="int8", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    topo = (g["indptr"], g["indices"])
    model, params = sage(dev)
    eng = ShardedServeEngine(model, None, topo, dist, [SIZES], BATCH,
                             fused_hot_hop=True, fused_row_cap=ROW_CAP,
                             seed=SEED).warmup()
    single = ServeEngine(sage(dev)[0], None, topo, g["featq"], [SIZES],
                         BATCH, fused_hot_hop=True, fused_row_cap=ROW_CAP,
                         seed=SEED, device=dev).warmup()
    host = torch.Generator().manual_seed(SEED + 14)
    requests = [torch.randperm(NODES, generator=g["gen"], device=dev)[:BATCH]
                for _ in range(SHARD_BATCHES)]
    hop_seeds = [draw_int32(host, len(SIZES)) for _ in requests]
    torch.cuda.synchronize()

    kernels.reset_launches()
    lat, outs = [], []
    for ids, hs in zip(requests, hop_seeds):
        t0 = time.perf_counter()
        outs.append(eng.run(ids, hop_seeds=hs))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)
    check(launches == {"fused_sample_hop": len(SIZES) * SHARD_BATCHES,
                       "fused_hot_hop": 0, "sample_layer": 0,
                       "gather_rows": 2 * SHARD_BATCHES, "gather_elems": 0,
                       "gather_rows_sharded": 0},
          f"sharded serve launches {launches}")
    # the unbucket decodes the received block on the card: the HBM design;
    # the owner reads its shard's packed rows as raw 128-byte rows
    hbm = made(kernels.PACKED_LAUNCHES,
               gather_rows_packed_hbm_kernel=SHARD_BATCHES)
    owner = gather.raw_kernel(gather.raw_design(on_host=False))
    raw = made(kernels.RAW_LAUNCHES, **{owner: SHARD_BATCHES})
    for o in outs:
        check(tuple(o.shape) == (BATCH, CLASSES)
              and bool(torch.isfinite(o).all()), "sharded logits")
    p50, p99 = pcts(lat)
    stats = {}
    busy = device_profile(lambda: [eng.run(r) for r in requests[:4]], 4,
                          "sharded batch", stats=stats)
    syncs = count_syncs(lambda: eng.run(requests[0],
                                        hop_seeds=hop_seeds[0]))
    n_id, _ = fused.fused_sample_multihop(
        g["indptr"], g["indices"], eng.pad_seeds(requests[0]), SIZES,
        hop_seeds[0], ROW_CAP)
    sync_free(lambda: dist[n_id], "the dense exchange")
    print(f"sharded (a): world size 1 over NCCL, int8 store packed "
          f"{dist.shard.data.stride(0)}-byte rows, {NODES} rows, built in "
          f"{build_s:.2f} s; {SHARD_BATCHES} batches of {BATCH}, fanout "
          f"{SIZES}, batch p50 {p50:.3f} ms p99 {p99:.3f} ms (host clock "
          f"+ synchronize), device {fmt_ms(busy)} per batch, idle share "
          f"{stats.get('idle_share', float('nan')):.3f}; launches per batch "
          f"fused_sample_hop {launches['fused_sample_hop'] / SHARD_BATCHES:g}"
          f", gather_rows {launches['gather_rows'] / SHARD_BATCHES:g} (of "
          f"them gather_rows_packed_hbm_kernel "
          f"{hbm['gather_rows_packed_hbm_kernel'] / SHARD_BATCHES:g}, "
          f"{owner} {raw[owner] / SHARD_BATCHES:g}); host "
          f"synchronisations per batch {syncs} (the dense lookup alone: "
          f"none); on {card}", flush=True)

    # the single-store fused engine over the same rows and hop seeds
    want = []
    with deterministic():
        for ids, hs in zip(requests, hop_seeds):
            a, b = eng.run(ids, hop_seeds=hs), single.run(ids, hop_seeds=hs)
            check(same_bits(a, b), "sharded logits differ from the "
                  "single-store fused engine's")
            want.append(b)
    x, calls = gather_calls(lambda: dist[n_id])
    _, _, x1 = fused.fused_multihop(g["indptr"], g["indices"],
                                    eng.pad_seeds(requests[0]), g["featq"],
                                    SIZES, hop_seeds[0], ROW_CAP)
    valid = n_id >= 0
    check(same_bits(x[valid], x1[valid]) and not x[~valid].view(
        torch.int32).any(), "sharded frontier rows differ from the fused "
        "walk's")
    print(f"sharded (a) check: {SHARD_BATCHES} batches' logits equal to the "
          "single-store fused ServeEngine's bit for bit (deterministic "
          f"algorithms on); batch 0's {int(valid.sum())} frontier rows equal "
          "to the fused walk's, padding +0.0", flush=True)
    gathers = exchange_gather_timing(calls, card, iters=20)

    # the exchange's arms, metered: dense, the default cap, the cap
    # planned from the dup factor the default arm measures
    frontier = layer_shapes(BATCH, SIZES)[-1].n_id_cap
    arms = {}
    for name in ("dense", "default cap", "planned cap"):
        if name == "planned cap":
            c = arms["default cap"]["counters_sum"]
            dup = frontier * SHARD_BATCHES / max(c[metrics.DEDUP_UNIQUE], 1)
            dist.exchange_cap = info.plan_exchange_cap(
                frontier, degree=g["deg"], dup_factor=dup).cap
        else:
            dist.exchange_cap = None if name == "dense" else True
        arm_eng = ShardedServeEngine(sage(dev)[0], None, topo, dist,
                                     [SIZES], BATCH, collect_metrics=True,
                                     fused_hot_hop=True,
                                     fused_row_cap=ROW_CAP, seed=SEED)
        arm_eng.warmup()
        lat_a, counters, arm_syncs = sharded_arm(arm_eng, requests,
                                                 hop_seeds)
        c = counters.long().sum(0).tolist()
        d = metrics.derive(counters.long().sum(0))
        a50, a99 = pcts(lat_a)
        arms[name] = {
            "exchange_cap": dist.exchange_cap, "p50_ms": a50, "p99_ms": a99,
            "fallbacks": c[metrics.EXCH_FALLBACK],
            "bucket_max": int(counters[:, metrics.EXCH_BUCKET_MAX].max()),
            "frontier_valid": c[metrics.FRONTIER_VALID],
            "dedup_total": c[metrics.DEDUP_TOTAL],
            "dedup_unique": c[metrics.DEDUP_UNIQUE],
            "host_syncs_per_batch": arm_syncs, "counters_sum": c,
            "derived": {k: v for k, v in d.items() if v is not None}}
        print(f"sharded (a) {name}: exchange_cap {dist.exchange_cap}, "
              f"p50 {a50:.3f} ms p99 {a99:.3f} ms, EXCH_CALLS "
              f"{c[metrics.EXCH_CALLS]}, EXCH_FALLBACK "
              f"{c[metrics.EXCH_FALLBACK]} of {SHARD_BATCHES}, "
              f"EXCH_BUCKET_MAX {arms[name]['bucket_max']}, EXCH_CAP "
              f"{int(counters[:, metrics.EXCH_CAP].max())}, frontier valid "
              f"{c[metrics.FRONTIER_VALID]} of {c[metrics.FRONTIER_CAP]}, "
              f"dedup {c[metrics.DEDUP_TOTAL]} ids -> "
              f"{c[metrics.DEDUP_UNIQUE]} unique, host synchronisations per "
              f"batch {arm_syncs}; on {card}", flush=True)
    dist.exchange_cap = None
    rec = {"world_size": 1, "backend": "nccl", "build_s": build_s,
           "batch_p50_ms": p50, "batch_p99_ms": p99, "device_ms": busy,
           "idle_share": stats.get("idle_share"),
           "launches_per_batch": {k: v / SHARD_BATCHES
                                  for k, v in launches.items() if v},
           "host_syncs_per_batch": syncs, "gathers": gathers,
           "arms": arms, "frontier_cap": frontier,
           "packed_launches": hbm, "raw_launches": raw}
    return rec, launches, dist, requests, hop_seeds, want


def shard_train_steps(dev, card, g, group, dist):
    """(a): ``build_dist_train_step`` over the int8 shard and
    ``build_e2e_train_step(fused_hot_hop=True)`` over the int8 table,
    one warm-up and SHARD_STEPS timed steps each."""
    import torch
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.ops.kernels import gather
    from quiver_tpu_torch.parallel import (build_dist_train_step,
                                           build_e2e_train_step, init_state,
                                           rank_step_seeds, train)
    order = torch.randperm(NODES, generator=g["gen"], device=dev) \
        .to(torch.int32)
    batches = [order[i * BATCH:(i + 1) * BATCH].contiguous()
               for i in range(SHARD_STEPS + 1)]
    ys = [g["labels"][b.long()] for b in batches]
    seeds = [rank_step_seeds(SEED + i, 0, len(SIZES))
             for i in range(len(batches))]
    owner = gather.raw_kernel(gather.raw_design(on_host=False))
    out, launches = {}, {}
    for name in ("dist", "e2e fused"):
        model = sage(dev, DROPOUT)[0]
        opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                               eps=1e-8)
        if name == "dist":
            step = build_dist_train_step(model, opt, SIZES, BATCH, group,
                                         dist._rows_per_host)
            args = (dist.shard, dist._g2h, dist._g2l)
        else:
            step = build_e2e_train_step(model, opt, SIZES, BATCH, group,
                                        fused_hot_hop=True,
                                        fused_row_cap=ROW_CAP)
            args = (g["featq"], None)
        state = init_state(model, opt)
        state, _ = step(state, *args, g["indptr"], g["indices"], batches[0],
                        ys[0], *seeds[0])
        torch.cuda.synchronize()
        kernels.reset_launches()
        lat, losses = [], []
        for i in range(1, len(batches)):
            t0 = time.perf_counter()
            state, loss = step(state, *args, g["indptr"], g["indices"],
                               batches[i], ys[i], *seeds[i])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        launches[name] = dict(kernels.LAUNCHES)
        losses = torch.stack(losses).tolist()
        first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
        check(all(math.isfinite(v) for v in losses) and last < 0.7 * first,
              f"{name} step: loss did not fall ({first} -> {last})")
        want = ({"gather_rows": 2 * SHARD_STEPS} if name == "dist" else
                {"fused_sample_hop": (len(SIZES) - 1) * SHARD_STEPS,
                 "fused_hot_hop": SHARD_STEPS})
        check(nonzero(launches[name]) == want,
              f"{name} step launches {launches[name]}")
        # the dist step's unbucket: the HBM design, once a step; its
        # owner read by the raw design the dispatcher picks
        is_dist = name == "dist"
        packed = made(kernels.PACKED_LAUNCHES, **(
            {"gather_rows_packed_hbm_kernel": SHARD_STEPS} if is_dist
            else {}))
        raw = made(kernels.RAW_LAUNCHES,
                   **({owner: SHARD_STEPS} if is_dist else {}))
        edges = 0
        for i in range(1, len(batches)):
            if name == "dist":
                _, layers = train._split_sample(
                    g["indptr"], g["indices"], batches[i], SIZES,
                    torch.Generator(device=dev).manual_seed(seeds[i][0][0]))
            else:
                _, layers = train._fused_multihop_x(
                    g["featq"], None, g["indptr"], g["indices"], batches[i],
                    SIZES, seeds[i][0], ROW_CAP)
            edges += sum(int(lay.edge_count) for lay in layers)
        p50, p99 = pcts(lat)
        out[name] = {"step_p50_ms": p50, "step_p99_ms": p99,
                     "edges_per_s": edges / (sum(lat) / 1e3),
                     "first8_loss": first, "last8_loss": last,
                     "launches_per_step": {k: v / SHARD_STEPS for k, v in
                                           nonzero(launches[name]).items()},
                     "packed_launches": packed, "raw_launches": raw}
        print(f"sharded (a) train {name}: {SHARD_STEPS} steps of {BATCH} "
              f"seeds, world size 1, step p50 {p50:.3f} ms p99 {p99:.3f} ms, "
              f"{edges} sampled edges = {out[name]['edges_per_s']:.6g} "
              f"edges/s, loss mean of the first 8 {first:.4f}, of the last "
              f"8 {last:.4f}; launches per step "
              f"{out[name]['launches_per_step']} (raw-row designs "
              f"{raw or 'none'}); on {card}", flush=True)
    return out, launches


def _shard_serve_rank(ctx, dev, batch, indptr, indices, feat, g2h, params,
                      requests, hop_seeds, caps):
    """(b), on each rank: the sharded engine over this rank's partition
    under every cap, on the check batches (deterministic algorithms on,
    so the logits can be held to the single-store engine's)."""
    import torch
    from quiver_tpu_torch import (DistFeature, PartitionInfo,
                                  ShardedServeEngine, TorchComm, metrics)
    group = ctx.groups[ctx.world_size]
    info = PartitionInfo(host=ctx.rank, hosts=ctx.world_size,
                         global2host=g2h)
    t0 = time.perf_counter()
    dist = DistFeature.from_partition(
        feat, info, TorchComm(ctx.rank, ctx.world_size, group=group),
        dtype_policy="int8", device=dev)
    build_s = time.perf_counter() - t0
    out = {"build_s": build_s, "rows_per_host": dist._rows_per_host}
    for name, cap in caps.items():
        dist.exchange_cap = cap
        model = sage(dev)[0]
        eng = ShardedServeEngine(model, params, (indptr, indices), dist,
                                 [SIZES], batch, collect_metrics=True,
                                 fused_hot_hop=True, fused_row_cap=ROW_CAP,
                                 seed=SEED)
        logits, lat, fallbacks = [], [], 0
        with deterministic():
            for ids, hs in zip(requests, hop_seeds):
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits.append(eng.run(ids, hop_seeds=hs).cpu())
                lat.append((time.perf_counter() - t0) * 1e3)
                fallbacks += int(eng.last_counters[metrics.EXCH_FALLBACK])
        out[name] = {"logits": logits, "ms": lat, "fallbacks": fallbacks}
    return out


def _shard_train_rank(ctx, dev, batch, indptr, indices, feat, featq, labels,
                      g2h, params, seeds_all, step_seed):
    """(b), on each rank: one dist step over the rank's partition and one
    data-parallel step over the whole table from the same parameters,
    seeds and streams (deterministic algorithms on): the losses."""
    import torch
    from quiver_tpu_torch import DistFeature, PartitionInfo, TorchComm
    from quiver_tpu_torch.parallel import (build_dist_train_step,
                                           build_e2e_train_step, init_state,
                                           rank_step_seeds)
    group = ctx.groups[ctx.world_size]
    info = PartitionInfo(host=ctx.rank, hosts=ctx.world_size,
                         global2host=g2h)
    dist = DistFeature.from_partition(
        feat, info, TorchComm(ctx.rank, ctx.world_size, group=group),
        dtype_policy="int8", device=dev)
    mine = seeds_all[ctx.rank * batch:(ctx.rank + 1) * batch]
    ys = labels[mine.long()]
    hs, drop = rank_step_seeds(step_seed, ctx.rank, len(SIZES))
    out = {}
    with deterministic():
        for name in ("dist", "e2e"):
            model = sage(dev, DROPOUT)[0]
            model.load_state_dict(params)
            opt = torch.optim.Adam(model.parameters(), lr=LR)
            if name == "dist":
                step = build_dist_train_step(model, opt, SIZES, batch, group,
                                             dist._rows_per_host)
                args = (dist.shard, dist._g2h, dist._g2l)
            else:
                step = build_e2e_train_step(model, opt, SIZES, batch, group)
                args = (featq, None)
            t0 = time.perf_counter()
            _, loss = step(init_state(model, opt), *args, indptr, indices,
                           mine, ys, hs, drop)
            out[name] = float(loss)
            out[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def sharded_ranks(dev, card, g, params, requests, hop_seeds, want, dup):
    """(b): SHARD_RANKS gloo ranks on this card, the rows partitioned by
    the probability partitioner over ``sample_prob``: every rank's
    sharded logits equal to (a)'s single-store ones bit for bit (dense
    and planned-cap arms), and the dist step's loss equal to the
    data-parallel step's."""
    import numpy as np
    import torch
    from quiver_tpu_torch import (PartitionInfo,
                                  partition_feature_without_replication)
    from quiver_tpu_torch.ops import sample_prob
    from quiver_tpu_torch.pyg.sage_sampler import layer_shapes

    t0 = time.perf_counter()
    train = torch.randperm(NODES, generator=g["gen"], device=dev)[
        :NODES // SHARD_TRAIN_FRAC].chunk(SHARD_RANKS)
    probs = [sample_prob(g["indptr"], g["indices"], t, SIZES, NODES).cpu()
             for t in train]
    prob_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts, _ = partition_feature_without_replication(probs)
    g2h = np.zeros(NODES, np.int32)
    for h, part in enumerate(parts):
        g2h[part] = h
    part_s = time.perf_counter() - t0
    info = PartitionInfo(hosts=SHARD_RANKS, global2host=g2h)
    frontier = layer_shapes(BATCH, SIZES)[-1].n_id_cap
    plan = info.plan_exchange_cap(frontier, degree=g["deg"], dup_factor=dup)
    print(f"sharded (b): {SHARD_RANKS} partitions of "
          f"{info.local_sizes} rows from sample_prob over {SHARD_RANKS} "
          f"train sets of {NODES // SHARD_TRAIN_FRAC // SHARD_RANKS} "
          f"({prob_s:.2f} s) and partition_feature_without_replication "
          f"({part_s:.2f} s); planned cap {plan.cap} (dup factor "
          f"{dup:.4f}, heaviest owner {plan.owner_frac:.4f} of the degree "
          f"mass, balanced {plan.balanced_cap})", flush=True)
    caps = {"dense": None, "planned cap": plan.cap}
    t0 = time.perf_counter()
    with RankPool(SHARD_RANKS, backend="gloo", timeout=SHARD_TIMEOUT,
                  call_timeout=2 * SHARD_TIMEOUT) as pool:
        spawn_s = time.perf_counter() - t0
        served = pool.run(_shard_serve_rank, dev, BATCH, g["indptr"],
                          g["indices"],
                          g["feat"], g2h, params,
                          requests[:SHARD_CHECK_BATCHES],
                          hop_seeds[:SHARD_CHECK_BATCHES], caps)
        seeds_all = torch.randperm(NODES, generator=g["gen"], device=dev)[
            :SHARD_RANKS * BATCH].to(torch.int32)
        trained = pool.run(_shard_train_rank, dev, BATCH, g["indptr"],
                           g["indices"], g["feat"], g["featq"], g["labels"],
                           g2h, params, seeds_all, SEED + 1414)
    for rank, r in enumerate(served):
        for name in caps:
            for a, b in zip(r[name]["logits"], want):
                check(same_bits(torch.as_tensor(a).to(dev), b),
                      f"(b) rank {rank} {name}: sharded logits differ from "
                      "the single-store engine's")
    for rank, r in enumerate(trained):
        check(r["dist"] == r["e2e"] == trained[0]["dist"],
              f"(b) rank {rank}: dist loss {r['dist']} != e2e {r['e2e']}")
    r0 = served[0]
    rec = {"ranks": SHARD_RANKS, "backend": "gloo", "device": str(dev),
           "partition_rows": info.local_sizes,
           "rows_per_host": r0["rows_per_host"], "spawn_s": spawn_s,
           "planned_cap": plan.cap, "dup_factor": dup,
           "arms": {name: {"ms": r0[name]["ms"],
                           "fallbacks": r0[name]["fallbacks"]}
                    for name in caps},
           "train_loss": trained[0]["dist"],
           "dist_step_ms": trained[0]["dist_ms"],
           "e2e_step_ms": trained[0]["e2e_ms"]}
    print(f"sharded (b): {SHARD_RANKS} ranks over gloo on {card}, spawned "
          f"in {spawn_s:.2f} s, shard of {r0['rows_per_host']} rows built in "
          f"{r0['build_s']:.2f} s; every rank's logits equal to (a)'s "
          f"single-store logits bit for bit on {SHARD_CHECK_BATCHES} "
          f"batches of each arm (dense {['%.1f' % v for v in r0['dense']['ms']]}"
          f" ms, planned cap {['%.1f' % v for v in r0['planned cap']['ms']]} "
          f"ms a batch on rank 0, deterministic algorithms on; fallbacks "
          f"{r0['planned cap']['fallbacks']} of {SHARD_CHECK_BATCHES}); the "
          f"dist step's loss {trained[0]['dist']:.6f} equal to the "
          f"data-parallel step's on every rank (rank 0: dist "
          f"{trained[0]['dist_ms']:.1f} ms, e2e {trained[0]['e2e_ms']:.1f} "
          "ms, first calls)", flush=True)
    return rec


def phase_sharded(dev, card):
    """Phase 14: the partitioned store across ranks. (a) world size 1
    over NCCL in this process: the sharded serve path at full width, its
    exchange gathers and arms, and both train steps; (b) SHARD_RANKS
    gloo ranks sharing the card, held to (a). Returns the record and the
    launches of (a)'s sharded serve run and train steps."""
    import torch
    import torch.distributed as tdist
    from quiver_tpu_torch import init_distributed
    from quiver_tpu_torch.ops import quant
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    indptr, indices, deg = make_graph(dev, gen, NODES)   # phase 1's graph
    feat, labels = make_train_data(dev, gen, NODES)
    g = {"gen": gen, "indptr": indptr, "indices": indices, "deg": deg,
         "feat": feat, "featq": quant.quantize(feat, "int8"),
         "labels": labels}
    tmp = tempfile.mkdtemp(prefix="qt_nccl_")
    group = init_distributed("nccl" if dev.type == "cuda" else "gloo",
                             f"file://{tmp}/rendezvous", 1, 0,
                             timeout=SHARD_TIMEOUT)
    try:
        rec_a, launches, dist, requests, hop_seeds, want = sharded_world1(
            dev, card, g, group)
        train_rec, train_launches = shard_train_steps(dev, card, g, group,
                                                      dist)
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    rec_a["train"] = train_rec
    c = rec_a["arms"]["default cap"]["counters_sum"]
    from quiver_tpu_torch import metrics
    dup = rec_a["frontier_cap"] * SHARD_BATCHES / max(
        c[metrics.DEDUP_UNIQUE], 1)
    del dist
    _, params = sage(dev)
    rec_b = sharded_ranks(dev, card, g, params, requests, hop_seeds, want,
                          dup)
    secs = time.perf_counter() - t_phase
    print(f"phase 14: {secs:.1f} s: (a) world size 1 over NCCL, (b) "
          f"{SHARD_RANKS} gloo ranks", flush=True)
    return {"a": rec_a, "b": rec_b, "seconds": secs}, launches, \
        train_launches


CLIQUE = 4                     # entries of phase 15's clique (one card)
CLIQUE_BATCHES = 16            # (a): timed batches of each arm and route
CLIQUE_STEPS = 32              # (b), (c): timed steps
TP_RANKS = 4                   # (c): gloo ranks sharing the card, 2 x 2
TP_CHECK_STEPS = 2             # (c): steps of the 4 ranks held to world 1
TP_TOL = 1e-5                  # (c): relative, fp64 and fp32 step 1
# (c): fp32's second step, relative: its gradients by each tensor's largest
# entry, its parameters by norm. Set from the first runs' readings (1.05e-3
# and 2.83e-5, NVIDIA H100 80GB HBM3, 700 W) once the fp64 run showed the
# same two steps within 1e-5: Adam turns gradient roundings near 0 into
# whole steps of lr, and step 2 is taken from parameters that differ so.
# The parameters are held against the exact run, world size 1 in fp64
# (tp_exact_gaps), not against world 1's fp32 run: on this phase's data
# that run itself departs from the exact one by 6.78e-4 by norm on
# convs.0.lin_root.bias after step 2, where the ranks' fp32 run is within
# 4.2e-5 (NVIDIA H100 80GB HBM3, 700 W).
TP_STEP2_GRAD_TOL = 1e-2
TP_STEP2_PARAM_TOL = 1e-4
CLIQUE_TIMEOUT = 300.0         # (c), (d): collectives and calls, s


def sharded_kernel_check(dev, tiers, ids, card, iters):
    """``gather_rows_sharded`` at a served frontier over each clique tier
    (fp32, bf16, packed int8): the lookup's form (every slot read, ids
    clamped) and the ``out=`` form with the frontier's -1 slots, each
    held bit for bit to the plain version; the own time (profiler), the
    wrapper's, the plain version's, ``index_select`` of the same rows
    from one concatenated device table (the replicate store's read) and
    the bound: the ids read once, each distinct row they read (the
    clamped -1 slots all read row 0) read once, and each output row the
    form writes (every slot, or the live ones) written once, at 3.35
    TB/s."""
    import torch
    from quiver_tpu_torch.ops import kernels, quant
    from quiver_tpu_torch.ops.kernels import gather
    out = {}
    live = int((ids >= 0).sum())
    safe = ids.clamp(min=0)
    for name, tier in tiers.items():
        whole = tier.unsharded() if not quant.is_quantized(tier.shards[0]) \
            else None
        for form in ("lookup", "out="):
            if form == "lookup":
                run = lambda: gather.gather_rows_sharded(tier, safe)  # noqa
                plain = lambda: gather.gather_rows_sharded_plain(  # noqa
                    tier, safe)
                got, want = run(), plain()
                n_read, distinct = ids.shape[0], int(safe.unique().numel())
            else:
                base = torch.zeros((ids.shape[0], tier.dim),
                                   dtype=quant.tier_dtype(tier), device=dev)
                got = gather.gather_rows_sharded(tier, ids, out=base.clone())
                want = gather.gather_rows_sharded_plain(tier, ids,
                                                        out=base.clone())
                run = lambda: gather.gather_rows_sharded(  # noqa: E731
                    tier, ids, out=base)
                plain = lambda: gather.gather_rows_sharded_plain(  # noqa
                    tier, ids, out=base)
                n_read = live
                distinct = int(ids[ids >= 0].unique().numel())
            check(same_bits(got, want), f"gather_rows_sharded {name} {form}:"
                  " kernel differs from its plain version")
            row_in = quant.row_read_bytes(tier)
            row_out = tier.dim * got.element_size()
            nbytes = 4 * ids.shape[0] + row_in * distinct + row_out * n_read
            lib = None
            if whole is not None and form == "lookup":
                table = whole.to(dev)
                idx = safe.long()
                check(same_bits(table.index_select(0, idx), got),
                      f"gather_rows_sharded {name}: differs from "
                      "index_select over the concatenated table")
                lib = cuda_ms(lambda: table.index_select(0, idx), iters)
                del table
            # every block on the card: packed rows take the HBM design,
            # raw rows the design the dispatcher picks
            if quant.is_quantized(tier.shards[0]):
                kname = gather.packed_kernel(
                    any(quant.tier_parts(b)[0].device.type == "cpu"
                        for b in tier.shards), sharded=True)
            else:
                kname = gather.raw_launch(tier, got)[2]
                made_once(kernels.RAW_LAUNCHES, run, kname,
                          f"gather_rows_sharded {name} {form}")
            rec = {"ids": int(ids.shape[0]), "rows_written": n_read,
                   "distinct_rows_read": distinct,
                   "shards": len(tier.shards), "max_abs_err": 0.0,
                   "ms": cuda_ms(run, iters),
                   "own_ms": own_ms(run, kname, iters),
                   "burst_ms": burst_ms(run, iters),
                   "plain_ms": cuda_ms(plain, 3),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes", "library_ms": lib, "kernel": kname}
            out[f"{name} {form}"] = rec
            share = "" if rec["own_ms"] is None else \
                f" (bound / own {rec['bound_ms'] / rec['own_ms']:.0%})"
            print(f"clique gather_rows_sharded {name} {form} ({kname}): "
                  f"{rec['ids']} "
                  f"ids ({n_read} rows written, {distinct} distinct rows "
                  f"read) over {len(tier.shards)} "
                  f"blocks, equal to its plain version; own "
                  f"{fmt_ms(rec['own_ms'])}{share}, back to back "
                  f"{rec['burst_ms']:.4f} ms, wrapper {rec['ms']:.4f} ms, "
                  f"plain {rec['plain_ms']:.4f} ms, index_select "
                  f"{fmt_ms(lib)}, bound {rec['bound_ms']:.4f} ms "
                  f"({nbytes} B at 3.35 TB/s); on {card}", flush=True)
    return out


def clique_stores(dev, g, card):
    """(a)'s stores: the fp32 table whole on a clique of CLIQUE entries
    of this card and the int8 store half hot on it (packed blocks) and
    half cold (pinned, packed), each beside its ``device_replicate``
    counterpart over the same rows, order and knobs."""
    import torch
    from quiver_tpu_torch import Feature
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.parallel import make_mesh
    mesh = make_mesh(("cache",), devices=[dev] * CLIQUE)
    stores, build = {}, {}
    for arm, policy, hot in (("fp32 whole", None, NODES),
                             ("int8 half", "int8", NODES // 2)):
        row = quant.row_bytes(DIM, policy)
        kw = dict(csr_topo=g["topo"], dtype_policy=policy,
                  host_placement="offload", dedup_cold=True, device=dev)
        for kind in ("clique", "replicate"):
            t0 = time.perf_counter()
            if kind == "clique":
                s = Feature(device_cache_size=-(-hot // CLIQUE) * row,
                            cache_policy="p2p_clique_replicate", mesh=mesh,
                            **kw)
            else:
                s = Feature(device_cache_size=hot * row, **kw)
            stores[(arm, kind)] = s.from_cpu_tensor(g["feat"])
            torch.cuda.synchronize()
            build[(arm, kind)] = time.perf_counter() - t0
        c, r = stores[(arm, "clique")], stores[(arm, "replicate")]
        check(c.sharded and c.cache_rows == r.cache_rows == hot
              and torch.equal(c.feature_order, r.feature_order),
              f"{arm}: the clique store's hot rows {c.cache_rows}")
        blocks = c.device_part.shards
        lead = quant.tier_parts(blocks[0])[0]
        print(f"clique (a) {arm}: {c.cache_rows} hot rows in "
              f"{len(blocks)} blocks of {quant.tier_rows(blocks[0])} rows "
              f"({lead.stride(0) * lead.element_size()} B a row), "
              f"{NODES - c.cache_rows} cold rows pinned; built in "
              f"{build[(arm, 'clique')]:.2f} s (replicate "
              f"{build[(arm, 'replicate')]:.2f} s); on {card}", flush=True)
    return stores, build


def clique_serving(dev, g, stores, card):
    """(a): ``ServeEngine`` over each clique store, fused and split
    routes, 16 batches each: p50/p99, device ms and idle share, launches
    a batch and host synchronisations; then every batch's logits equal
    to the replicate store's engine bit for bit (deterministic
    algorithms on)."""
    import torch
    from quiver_tpu_torch import ServeEngine
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.ops.kernels import gather
    from quiver_tpu_torch.parallel.train import draw_int32
    host = torch.Generator().manual_seed(SEED + 15)
    requests = [torch.randperm(NODES, generator=g["gen"], device=dev)[:BATCH]
                for _ in range(CLIQUE_BATCHES)]
    hop_seeds = [draw_int32(host, len(SIZES)) for _ in requests]
    rec, launches = {}, {}
    for arm in ("fp32 whole", "int8 half"):
        for fused in (True, False):
            route = "fused" if fused else "split"
            engs = {kind: ServeEngine(
                sage(dev)[0], None, g["topo"], stores[(arm, kind)], [SIZES],
                BATCH, fused_hot_hop=fused, fused_row_cap=ROW_CAP,
                seed=SEED, device=dev).warmup()
                for kind in ("clique", "replicate")}
            eng = engs["clique"]
            torch.cuda.synchronize()
            kernels.reset_launches()
            lat = []
            for ids, hs in zip(requests, hop_seeds):
                t0 = time.perf_counter()
                o = eng.run(ids, hop_seeds=hs)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                check(tuple(o.shape) == (BATCH, CLASSES)
                      and bool(torch.isfinite(o).all()), "clique logits")
            got = dict(kernels.LAUNCHES)
            launches[(arm, route)] = got
            # the split route's exact sampler is torch ops, no kernel
            check(got["fused_sample_hop"]
                  == (len(SIZES) * CLIQUE_BATCHES if fused else 0)
                  and got["gather_rows_sharded"] >= CLIQUE_BATCHES
                  and got["fused_hot_hop"] == 0
                  and (got["gather_rows"] >= CLIQUE_BATCHES)
                  == (arm == "int8 half"),
                  f"clique {arm} {route} launches {got}")
            # int8: the hot blocks on the card through the HBM design, the
            # pinned cold tier through the host design
            packed = made(kernels.PACKED_LAUNCHES, **({
                "gather_rows_sharded_packed_hbm_kernel":
                    got["gather_rows_sharded"],
                "gather_rows_packed_kernel": got["gather_rows"]}
                if arm == "int8 half" else {}))
            # fp32: every block on the card, raw rows by the dispatched
            # design
            raw = made(kernels.RAW_LAUNCHES, **({} if arm == "int8 half" else {
                gather.raw_kernel(gather.raw_design(on_host=False),
                                  sharded=True):
                got["gather_rows_sharded"]}))
            stats = {}
            busy = device_profile(lambda: [eng.run(r) for r in requests[:4]],
                                  4, f"clique {route} batch", stats=stats)
            syncs = count_syncs(lambda: eng.run(requests[0],
                                                hop_seeds=hop_seeds[0]))
            with deterministic():
                for ids, hs in zip(requests, hop_seeds):
                    a = eng.run(ids, hop_seeds=hs)
                    b = engs["replicate"].run(ids, hop_seeds=hs)
                    check(same_bits(a, b), f"clique {arm} {route}: logits "
                          "differ from the replicate store's engine")
            p50, p99 = pcts(lat)
            per = {k: v / CLIQUE_BATCHES for k, v in nonzero(got).items()}
            rec[f"{arm} {route}"] = {
                "batch_p50_ms": p50, "batch_p99_ms": p99,
                "device_ms": busy, "idle_share": stats.get("idle_share"),
                "packed_launches": packed, "raw_launches": raw,
                "launches_per_batch": per, "host_syncs_per_batch": syncs}
            print(f"clique (a) {arm} {route}: {CLIQUE_BATCHES} batches of "
                  f"{BATCH}, fanout {SIZES}, p50 {p50:.3f} ms p99 "
                  f"{p99:.3f} ms (host clock + synchronize), device "
                  f"{fmt_ms(busy)} a batch, idle share "
                  f"{stats.get('idle_share', float('nan')):.3f}, launches "
                  f"a batch {per} (raw-row designs {raw or 'none'}), host "
                  f"synchronisations a batch {syncs}; "
                  f"logits equal to the replicate store's engine bit for "
                  f"bit on all {CLIQUE_BATCHES} batches (deterministic "
                  f"algorithms on); on {card}", flush=True)
            check(syncs == 0, f"clique {arm} {route}: {syncs} host "
                  "synchronisations a batch")
            del engs, eng
    return rec, launches, requests, hop_seeds


def clique_training(dev, g, stores, card):
    """(b): 32 steps of ``build_train_step(fused_hot_hop=True)`` over the
    int8 clique store (the sample-only walk, then the store's lookup),
    the loss falling; one step's loss and gradients over the clique and
    the replicate store equal bit for bit on both routes (deterministic
    algorithms on)."""
    import torch
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.parallel import rank_step_seeds, train
    store = stores[("int8 half", "clique")]
    order = torch.randperm(NODES, generator=g["gen"], device=dev) \
        .to(torch.int32)
    batches = [order[i * BATCH:(i + 1) * BATCH].contiguous()
               for i in range(CLIQUE_STEPS + 1)]
    ys = [g["labels"][b.long()] for b in batches]
    seeds = [rank_step_seeds(SEED + 150 + i, 0, len(SIZES))
             for i in range(len(batches))]
    state, step = new_trainer(sage(dev, DROPOUT)[0])
    state, _ = step(state, store, None, g["indptr"], g["indices"],
                    batches[0], ys[0], *seeds[0])
    torch.cuda.synchronize()
    kernels.reset_launches()
    lat, losses = [], []
    for i in range(1, len(batches)):
        t0 = time.perf_counter()
        state, loss = step(state, store, None, g["indptr"], g["indices"],
                           batches[i], ys[i], *seeds[i])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = dict(kernels.LAUNCHES)
    losses = torch.stack(losses).tolist()
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    check(all(math.isfinite(v) for v in losses) and last < 0.7 * first,
          f"clique train: loss did not fall ({first} -> {last})")
    check(launches["fused_sample_hop"] == len(SIZES) * CLIQUE_STEPS
          and launches["gather_rows_sharded"] >= CLIQUE_STEPS
          and launches["fused_hot_hop"] == 0
          and launches["gather_rows"] >= CLIQUE_STEPS,
          f"clique train launches {launches}")
    packed = made(
        kernels.PACKED_LAUNCHES,
        gather_rows_sharded_packed_hbm_kernel=launches["gather_rows_sharded"],
        gather_rows_packed_kernel=launches["gather_rows"])
    p50, p99 = pcts(lat)
    stats = {}
    busy = device_profile(lambda: [step(state, store, None, g["indptr"],
                                        g["indices"], batches[i], ys[i],
                                        *seeds[i]) for i in range(1, 5)],
                          4, "clique step", stats=stats)
    rec = {"step_p50_ms": p50, "step_p99_ms": p99, "device_ms": busy,
           "idle_share": stats.get("idle_share"), "first8_loss": first,
           "last8_loss": last,
           "launches_per_step": {k: v / CLIQUE_STEPS for k, v in
                                 nonzero(launches).items()},
           "packed_launches": packed}
    print(f"clique (b) train: {CLIQUE_STEPS} steps of {BATCH} over the int8 "
          f"clique store, step p50 {p50:.3f} ms p99 {p99:.3f} ms, device "
          f"{fmt_ms(busy)} a step, idle share "
          f"{stats.get('idle_share', float('nan')):.3f}, loss mean of the "
          f"first 8 {first:.4f}, of the last 8 {last:.4f}; launches a step "
          f"{rec['launches_per_step']}; on {card}", flush=True)
    params = sage(dev, DROPOUT)[1]
    hs, drop = seeds[1]
    for fused in (True, False):
        got = []
        with deterministic():
            for kind in ("clique", "replicate"):
                model = sage(dev, DROPOUT)[0]
                model.load_state_dict(params)
                knobs = train._step_knobs(fused, ROW_CAP, SIZES, "exact",
                                          None)
                got.append(grads_of(model, lambda m: train._fused_loss(
                    m, SIZES, BATCH, stores[("int8 half", kind)], None,
                    g["indptr"], g["indices"], batches[1], ys[1], hs, drop,
                    fused=knobs, gather=train.store_gather)))
        (la, ga), (lb, gb) = got
        check(la == lb and all(same_bits(ga[k], gb[k]) for k in ga),
              f"clique train ({'fused' if fused else 'split'}): loss or "
              "gradients differ from the replicate store's")
        rec["one_step_loss_" + ("fused" if fused else "split")] = la
    print(f"clique (b) check: one step's loss "
          f"({rec['one_step_loss_fused']:.6f} fused, "
          f"{rec['one_step_loss_split']:.6f} split) and every "
          "gradient over the clique store equal to those over the "
          "replicate store bit for bit (deterministic algorithms on)",
          flush=True)
    return rec, launches


def _tp_steps(model, mesh, g, batches, steps, keep, walks=None):
    """The TP step over ``mesh`` for ``steps`` steps of ``batches``:
    losses, step times, and for each of the first ``keep`` steps the
    full gradients the optimizer applied and the full parameters after
    it. ``walks`` (a list) gains each step's frontier rows and sampled
    edges of this rank's walk (``keyed_walk`` over the rank's slice of
    the seeds, the walk its step took), after the step's time is
    taken."""
    import torch
    from quiver_tpu_torch.parallel import (build_gspmd_train_step,
                                           full_parameters, init_state,
                                           keyed_walk, shard_state)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    st = shard_state(init_state(model, opt), mesh)
    step = build_gspmd_train_step(model, opt, SIZES, mesh)
    losses, lat, params, grads = [], [], [], []
    apply = st.optimizer.step

    def recorded(*a, **k):
        # the averaged gradients, read (collectively) before the update
        if len(grads) < keep:
            grads.append(full_parameters(model, grad=True))
        return apply(*a, **k)
    st.optimizer.step = recorded
    for i in range(steps):
        seeds, ys, hs, drop = batches[i]
        t0 = time.perf_counter()
        st, loss = step(st, g["feat"], None, g["indptr"], g["indices"],
                        seeds, ys, hs, drop)
        losses.append(float(loss))
        lat.append((time.perf_counter() - t0) * 1e3)
        if walks is not None:
            part = len(seeds) // mesh["data"].size()
            d = mesh["data"].get_local_rank()
            with torch.no_grad():
                layers = keyed_walk(
                    g["feat"], None, g["indptr"], g["indices"],
                    seeds[d * part:(d + 1) * part], SIZES, hs)[1]
            walks.append({"frontier_rows": int(layers[-1].n_count),
                          "edges": int(sum(la.edge_count
                                           for la in layers))})
            del layers
        if i < keep:
            params.append(full_parameters(model))
    return losses, lat, params, grads


def tp_model(dev, params, wide):
    """Phase 3's GraphSAGE from ``params`` for the TP step; with ``wide``
    its weights and arithmetic in float64, the fp32 rows the walk gathers
    widened at its input."""
    import torch
    model = sage(dev, DROPOUT)[0]
    model.load_state_dict(params)
    if not wide:
        return model

    class Wide(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x, adjs, generator=None):
            return self.inner(x.double(), adjs, generator=generator)
    return Wide(model.double())


TP_WIDTHS = (("fp32", False), ("fp64", True))


def _tp_rank(ctx, dev, g, params, batches):
    """(c), on each of the TP_RANKS gloo ranks: a 2 x 2 mesh over this
    card, TP_CHECK_STEPS steps from ``params`` in fp32 and in fp64, the
    losses, gradients and full parameters (host copies) of each, and
    each fp32 weight's local shape."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(dev.type, (2, 2),
                            mesh_dim_names=("data", "model"))
    host = lambda steps: [{k: v.cpu() for k, v in p.items()}  # noqa: E731
                          for p in steps]
    out = {"data_rank": mesh["data"].get_local_rank()}
    for name, wide in TP_WIDTHS:
        model = tp_model(dev, params, wide)
        walks = []
        with deterministic():
            losses, lat, full, grads = _tp_steps(
                model, mesh, g, batches, TP_CHECK_STEPS, TP_CHECK_STEPS,
                walks)
        out[name] = {"losses": losses, "ms": lat, "params": host(full),
                     "grads": host(grads), "walks": walks}
        if not wide:
            out["local"] = {n: tuple(p.shape)
                            for n, p in model.named_parameters()}
    return out


def tp_exact_gaps(ref, ranks, dev):
    """fp32's second-step parameters against the exact run, world size 1
    in fp64 (the same walk and masks; the fp64 ranks equal it within
    TP_TOL): for each tensor, the ranks' largest difference norm over its
    norm, and world 1's own fp32 run's."""
    import torch
    exact = {k.removeprefix("inner."): v
             for k, v in ref["fp64"][2][1].items()}

    def gap(got, name):
        want = exact[name]
        return float((torch.as_tensor(got).to(dev).double() - want).norm()
                     / want.norm().clamp(min=1e-30))
    return {name: {"ranks": max(gap(r["fp32"]["params"][1][name], name)
                                for r in ranks),
                   "world1": gap(want, name)}
            for name, want in ref["fp32"][2][1].items()}


def clique_tp(dev, g, card):
    """(c): the TP step at full width, world size 1 over NCCL (mesh 1 x
    1) for CLIQUE_STEPS steps with a falling loss, then TP_RANKS gloo
    ranks on this card (2 x 2) for TP_CHECK_STEPS steps in fp32 and in
    fp64, held to world size 1's same steps, both under torch's
    deterministic algorithms: fp64's losses, gradients and parameters of
    every step within TP_TOL; fp32's losses of every step and its first
    step's gradients and parameters within TP_TOL, its second step's
    gradients within TP_STEP2_GRAD_TOL and its parameters within
    TP_STEP2_PARAM_TOL of the exact run (world size 1 in fp64)."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from quiver_tpu_torch import init_distributed
    from quiver_tpu_torch.parallel.train import draw_int32
    order = torch.randperm(NODES, generator=g["gen"], device=dev) \
        .to(torch.int32)
    host = torch.Generator().manual_seed(SEED + 1515)
    batches = []
    for i in range(CLIQUE_STEPS):
        s = order[i * BATCH:(i + 1) * BATCH].contiguous()
        batches.append((s, g["labels"][s.long()],
                        draw_int32(host, len(SIZES)), draw_int32(host, 1)[0]))
    params = sage(dev, DROPOUT)[1]
    tmp = tempfile.mkdtemp(prefix="qt_nccl_")
    init_distributed("nccl" if dev.type == "cuda" else "gloo",
                     f"file://{tmp}/rendezvous", 1, 0,
                     timeout=CLIQUE_TIMEOUT)
    try:
        mesh = init_device_mesh(dev.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        # the reference for the ranks: the first steps under torch's
        # deterministic algorithms (the model's index_add_ sums in one
        # order), as the ranks run them, in both widths
        ref, ref_walks = {}, []
        for name, wide in TP_WIDTHS:
            with deterministic():
                ref[name] = _tp_steps(tp_model(dev, params, wide), mesh, g,
                                      batches, TP_CHECK_STEPS,
                                      TP_CHECK_STEPS,
                                      ref_walks if name == "fp32" else None)
        losses, lat, _, _ = _tp_steps(tp_model(dev, params, False), mesh,
                                      g, batches, CLIQUE_STEPS, 0)
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    check(all(math.isfinite(v) for v in losses) and last < 0.7 * first,
          f"TP step: loss did not fall ({first} -> {last})")
    p50, p99 = pcts(lat[1:])
    rec = {"world1": {"backend": "nccl", "mesh": [1, 1],
                      "step_p50_ms": p50, "step_p99_ms": p99,
                      "first8_loss": first, "last8_loss": last}}
    print(f"clique (c) TP world size 1 over NCCL (mesh 1 x 1): "
          f"{CLIQUE_STEPS} steps of {BATCH}, step p50 {p50:.3f} ms p99 "
          f"{p99:.3f} ms (after the first), loss mean of the first 8 "
          f"{first:.4f}, of the last 8 {last:.4f}; on {card}", flush=True)
    t0 = time.perf_counter()
    with RankPool(TP_RANKS, backend="gloo", timeout=CLIQUE_TIMEOUT,
                  call_timeout=2 * CLIQUE_TIMEOUT) as pool:
        spawn_s = time.perf_counter() - t0
        ranks = pool.run(_tp_rank, dev, {k: g[k] for k in (
            "indptr", "indices", "feat")}, params, batches[:TP_CHECK_STEPS])

    def rel_errs(width, kind, norm):
        """Each tensor's error over the ranks, by step, relative to the
        world-1 run's: its largest entry's error over its largest entry,
        or with ``norm`` the norm of the difference over its norm."""
        ref_steps = ref[width][2 if kind == "params" else 3]
        out = {}
        for r in ranks:
            for i, (got_i, want_i) in enumerate(zip(r[width][kind],
                                                    ref_steps)):
                for name, want in want_i.items():
                    diff = torch.as_tensor(got_i[name]).to(dev) - want
                    err = float(diff.norm() / want.norm().clamp(min=1e-30)
                                if norm else diff.abs().max()
                                / want.abs().max().clamp(min=1e-30))
                    key = f"step {i + 1} {name}"
                    out[key] = max(out.get(key, 0.0), err)
        return out

    exact = tp_exact_gaps(ref, ranks, dev)
    print("clique (c) TP fp32 step 2 parameters against the exact run "
          "(world size 1 in fp64), difference norm over norm by tensor, "
          "the 2 x 2 ranks' / world size 1's own fp32 run: " + ", ".join(
              f"{k} {v['ranks']:.2e} / {v['world1']:.2e}"
              for k, v in exact.items()) + f"; on {card}", flush=True)

    def worst(errs, step=None):
        return max(v for k, v in errs.items()
                   if step is None or k.startswith(f"step {step} "))
    # Part of the split walk: each data rank's frontier and edges a step
    # beside world 1's (the same seeds, the whole batch)
    walk_rows = {}
    for r in ranks:
        walk_rows.setdefault(r["data_rank"], r["fp32"]["walks"])
        check(r["fp32"]["walks"] == walk_rows[r["data_rank"]],
              "TP 2 x 2: the model ranks of one data rank walked apart")
    for d, walks in sorted(walk_rows.items()):
        check(all(0 < w["frontier_rows"] < v["frontier_rows"]
                  and 0 < w["edges"] < v["edges"]
                  for w, v in zip(walks, ref_walks)),
              f"TP 2 x 2: data rank {d}'s walk {walks} is not a slice of "
              f"world 1's {ref_walks}")
    print(f"clique (c) TP walk, frontier rows and sampled edges a step: "
          f"world size 1 {[(w['frontier_rows'], w['edges']) for w in ref_walks]}"
          + "".join(f"; data rank {d} "
                    f"{[(w['frontier_rows'], w['edges']) for w in ws]}"
                    for d, ws in sorted(walk_rows.items()))
          + f" (each data rank walks {BATCH // 2} of the {BATCH} seeds); "
          f"on {card}", flush=True)
    rec["walks"] = {"world1": ref_walks,
                    **{f"data_rank_{d}": ws
                       for d, ws in sorted(walk_rows.items())}}
    rec["ranks"] = {"ranks": TP_RANKS, "backend": "gloo", "mesh": [2, 2],
                    "spawn_s": spawn_s,
                    "local_shapes": {k: list(v) for k, v in
                                     ranks[0]["local"].items()}}
    verdicts = {}
    for width, _ in TP_WIDTHS:
        loss_err = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r[width]["losses"], ref[width][0]))
        errs = {"grad": rel_errs(width, "grads", False),
                "param": rel_errs(width, "params", True),
                "param_max": rel_errs(width, "params", False)}
        for what, key in (("gradient's largest entry error, relative to "
                           "its largest entry", "grad"),
                          ("parameter's difference norm, relative to its "
                           "norm", "param"),
                          ("parameter's largest entry error, relative to "
                           "its largest entry", "param_max")):
            print(f"clique (c) TP 2 x 2 {width} against world size 1, each "
                  f"{what}: " + ", ".join(f"{k} {v:.2e}"
                                          for k, v in errs[key].items()),
                  flush=True)
        if width == "fp64":
            held = {"loss": (loss_err, TP_TOL),
                    "gradients": (worst(errs["grad"]), TP_TOL),
                    "parameters": (worst(errs["param_max"]), TP_TOL)}
        else:
            held = {"loss": (loss_err, TP_TOL),
                    "step 1 gradients": (worst(errs["grad"], 1), TP_TOL),
                    "step 1 parameters": (worst(errs["param"], 1), TP_TOL),
                    "step 2 gradients": (worst(errs["grad"], 2),
                                         TP_STEP2_GRAD_TOL),
                    "step 2 parameters against the exact run": (
                        max(v["ranks"] for v in exact.values()),
                        TP_STEP2_PARAM_TOL)}
        verdicts[width] = held
        rec["ranks"][width] = {
            "losses": ranks[0][width]["losses"],
            "step_ms": ranks[0][width]["ms"], "loss_rel_err": loss_err,
            "held": {k: list(v) for k, v in held.items()},
            "grad_rel_errs": errs["grad"], "param_rel_errs": errs["param"],
            "param_max_rel_errs": errs["param_max"]}
        if width == "fp32":
            rec["ranks"][width]["step2_param_exact_gaps"] = exact
        print(f"clique (c) TP {TP_RANKS} gloo ranks on this card (mesh 2 x "
              f"2), {width}, {TP_CHECK_STEPS} steps: losses "
              f"{ranks[0][width]['losses']}; held against world size 1 "
              f"(measured, limit): "
              + ", ".join(f"{k} {v:.2e} <= {lim:g}"
                          for k, (v, lim) in held.items())
              + f"; parameters after {TP_CHECK_STEPS} steps within "
              f"{worst(errs['param']):.2e} by norm, "
              f"{worst(errs['param_max']):.2e} of the largest entry; steps "
              f"{['%.1f' % v for v in ranks[0][width]['ms']]} ms "
              f"(deterministic algorithms on both); on {card}", flush=True)
    print(f"clique (c) TP ranks spawned in {spawn_s:.2f} s; rank 0's conv2 "
          f"lin_root weight {ranks[0]['local']['convs.2.lin_root.weight']} "
          f"of (47, 256); on {card}", flush=True)
    for width, held in verdicts.items():
        check(all(v <= lim for v, lim in held.values()),
              f"TP 2 x 2 {width} against world size 1: {held}")
    return rec


def _ipc_worker(handle, frontiers, want, out, done):
    """(d), in the spawned worker: the store from its ``share_ipc``
    handle, each frontier's lookup held to the parent's rows, and the
    device memory this process allocated."""
    import torch
    try:
        from quiver_tpu_torch import Feature
        card = frontiers[0].is_cuda

        def allocated():
            if not card:
                return 0
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated()
        start = allocated()
        store = Feature.new_from_ipc_handle(0, handle)
        opened = allocated() - start
        equal = True
        for ids, rows in zip(frontiers, want):
            equal = equal and same_bits(store.getitem_masked(ids), rows)
        after = allocated() - start
        out.put(("ok", equal, opened, after,
                 torch.cuda.max_memory_allocated() if card else 0))
    except Exception:
        out.put(("error", traceback.format_exc(), None, None, None))
    done.get(timeout=CLIQUE_TIMEOUT)


def clique_ipc(dev, g, stores, requests, hop_seeds, card):
    """(d): a spawned worker opens the int8 clique store through
    ``share_ipc`` and looks up 16 served frontiers: equal to the
    parent's rows bit for bit, and the worker's allocated device memory
    grows by less than the hot tier's size."""
    import torch
    import torch.multiprocessing as mp
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import fused
    store = stores[("int8 half", "clique")]
    frontiers = []
    for ids, hs in zip(requests, hop_seeds):
        seeds = torch.full((BATCH,), -1, dtype=torch.int32, device=dev)
        seeds[:ids.shape[0]] = ids
        frontiers.append(fused.fused_sample_multihop(
            g["indptr"], g["indices"], seeds, SIZES, hs, ROW_CAP)[0])
    t0 = time.perf_counter()
    handle = store.share_ipc()
    share_s = time.perf_counter() - t0
    want = [store.getitem_masked(f) for f in frontiers]
    hot_bytes = sum(quant.tier_parts(b)[0].untyped_storage().nbytes()
                    for b in store.device_part.shards)
    ctx = mp.get_context("spawn")
    out, done = ctx.Queue(), ctx.Queue()
    t0 = time.perf_counter()
    proc = ctx.Process(target=_ipc_worker,
                       args=(handle, frontiers, want, out, done))
    proc.start()
    try:
        status, equal, opened, after, peak = out.get(timeout=CLIQUE_TIMEOUT)
    finally:
        done.put(None)
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
    worker_s = time.perf_counter() - t0
    check(status == "ok", f"IPC worker failed:\n{equal}")
    check(equal, "the IPC worker's lookups differ from the parent's")
    check(after < hot_bytes, f"the IPC worker allocated {after} B after "
          f"its lookups, the hot tier is {hot_bytes} B")
    rec = {"frontiers": len(frontiers), "share_s": share_s,
           "worker_s": worker_s, "opened_alloc_bytes": opened,
           "after_alloc_bytes": after, "peak_alloc_bytes": peak,
           "hot_tier_bytes": hot_bytes}
    print(f"clique (d) IPC: share_ipc {share_s:.2f} s (the cold tier moved "
          f"to shared pages and registered); a spawned worker opened the "
          f"int8 clique store and looked up {len(frontiers)} served "
          f"frontiers of {frontiers[0].shape[0]} ids, equal to the "
          f"parent's bit for bit; its allocated device memory grew by "
          f"{opened} B on opening and {after} B after the lookups (peak "
          f"{peak} B during them), the hot tier is {hot_bytes} B; "
          f"{worker_s:.2f} s with the spawn; on {card}", flush=True)
    return rec


def clique_shard_tensor(dev, g, ids, h2d, card, iters):
    """(e): ``ShardTensor`` with two device groups (both on this card)
    and a pinned host group over the fp32 features, read at a served
    frontier by one launch, equal to the plain version."""
    import torch
    from quiver_tpu_torch import ShardTensor
    from quiver_tpu_torch.ops import kernels, quant
    from quiver_tpu_torch.ops.kernels import gather
    q = NODES // 4
    st = ShardTensor(0, device=dev)
    st.append(g["feat"][:q], 0)
    st.append(g["feat"][q:2 * q], 1)
    st.append(g["feat"][2 * q:].cpu(), -1)
    kernels.reset_launches()
    got = sync_free(lambda: st[ids], "ShardTensor lookup")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(nonzero(launches) == {"gather_rows_sharded": 1},
          f"ShardTensor launches {launches}")
    kname = gather.raw_launch(st._tier, got)[2]
    made(kernels.RAW_LAUNCHES, **{kname: 1})
    idl = ids.long()
    valid = (idl >= 0) & (idl < NODES)
    want = gather.gather_rows_sharded_plain(
        st._tier, torch.where(valid, idl, -1).to(torch.int32),
        out=torch.zeros_like(got))
    check(same_bits(got, want), "ShardTensor lookup differs from its plain "
          "version")
    check(same_bits(got[valid], g["feat"][idl[valid]]),
          "ShardTensor rows differ from the table's")
    run = lambda: st[ids]                                  # noqa: E731
    own = own_ms(run, kname, iters)
    hids = torch.where(valid & (idl >= 2 * q), idl - 2 * q, -1)
    b_ms, b_by, host_bytes, _, distinct = host_gather_bound(
        st._blocks[2], hids, h2d)
    dev_live = int((valid & (idl < 2 * q)).sum())
    dev_ms = (4 * ids.shape[0] + 8 * DIM * dev_live) / HBM_BYTES_PER_S * 1e3
    rec = {"ids": int(ids.shape[0]), "launches_per_lookup": 1,
           "kernel": kname,
           "groups": [0, 1, -1], "ms": cuda_ms(run, iters), "own_ms": own,
           "plain_ms": cuda_ms(lambda: gather.gather_rows_sharded_plain(
               st._tier, torch.where(valid, idl, -1).to(torch.int32),
               out=torch.zeros_like(got)), 3),
           "bound_ms": max(b_ms, dev_ms),
           "bound_by": b_by if b_ms >= dev_ms else "bytes (device)",
           "host_bytes": host_bytes, "host_distinct_rows": distinct}
    print(f"clique (e) ShardTensor: device groups 0 and 1 on {dev} and a "
          f"pinned host group ({NODES - 2 * q} rows), lookup at a served "
          f"frontier of {ids.shape[0]} ids in 1 gather_rows_sharded launch "
          f"({kname}), "
          f"equal to the plain version and the table bit for bit, no host "
          f"synchronisation; wrapper {rec['ms']:.4f} ms, own "
          f"{fmt_ms(own)}, plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {host_bytes} B of "
          f"{distinct} distinct host rows at {h2d / 1e9:.2f} GB/s); on "
          f"{card}", flush=True)
    return rec


def phase_clique(dev, card):
    """Phase 15: one process over a clique of CLIQUE entries of this card
    on phase 1's graph with phase 5's data: (a) clique serving against
    the replicate store, (b) training over the int8 clique store, (c)
    the TP step, (d) IPC, (e) ``ShardTensor`` across groups, (f) the
    topology; and the clique kernel held to its plain version at a
    served frontier. Returns the record, the kernel's record and the
    launches of (a)'s fused int8 run and of (b)."""
    import torch
    import quiver_tpu_torch as qt
    from quiver_tpu_torch import CSRTopo
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import fused
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    indptr, indices, _ = make_graph(dev, gen, NODES)     # phase 1's graph
    feat, labels = make_train_data(dev, gen, NODES)
    g = {"gen": gen, "indptr": indptr, "indices": indices, "feat": feat,
         "labels": labels,
         "topo": CSRTopo(indptr=indptr, indices=indices, device=dev)}
    stores, build = clique_stores(dev, g, card)
    serve_rec, serve_launches, requests, hop_seeds = clique_serving(
        dev, g, stores, card)

    # the kernel at a served frontier: the fp32 store's storage ids
    seeds = torch.full((BATCH,), -1, dtype=torch.int32, device=dev)
    seeds[:BATCH] = requests[0]
    n_id = fused.fused_sample_multihop(indptr, indices, seeds, SIZES,
                                       hop_seeds[0], ROW_CAP)[0]
    whole = stores[("fp32 whole", "clique")]
    order = whole.feature_order
    ids = torch.where(n_id >= 0, order[n_id.long().clamp(min=0)],
                      -1).to(torch.int32)
    tiers = {"fp32": whole.device_part,
             "bf16": qt.Feature(
                 device_cache_size=-(-NODES // CLIQUE) * 2 * DIM,
                 cache_policy="p2p_clique_replicate",
                 mesh=whole.mesh, dtype_policy="bf16",
                 device=dev).from_cpu_tensor(feat).device_part,
             "int8": qt.Feature(
                 device_cache_size=-(-NODES // CLIQUE)
                 * quant.row_bytes(DIM, "int8"),
                 cache_policy="p2p_clique_replicate", mesh=whole.mesh,
                 dtype_policy="int8", device=dev)
             .from_cpu_tensor(feat).device_part}
    kernel = sharded_kernel_check(dev, tiers, ids, card, iters=20)
    del tiers
    for k in [k for k in stores if k[0] == "fp32 whole"]:
        del stores[k]
    del whole
    torch.cuda.empty_cache()

    train_rec, train_launches = clique_training(dev, g, stores, card)
    tp_rec = clique_tp(dev, g, card)
    ipc_rec = clique_ipc(dev, g, stores, requests, hop_seeds, card)
    h2d, _ = h2d_rate(dev)
    st_rec = clique_shard_tensor(dev, g, n_id, h2d, card, iters=20)
    n = torch.cuda.device_count()
    info = qt.Topo(list(range(n))).info()
    qt.init_p2p(list(range(n)))
    print(f"clique (f) Topo over {n} card(s): {info!r}; init_p2p over "
          f"them done; on {card}", flush=True)
    secs = time.perf_counter() - t_phase
    print(f"phase 15: {secs:.1f} s: (a) clique serving, (b) clique "
          f"training, (c) TP step, (d) IPC, (e) ShardTensor, (f) Topo",
          flush=True)
    rec = {"clique": CLIQUE, "build_s": {f"{a} {k}": v for (a, k), v in
                                         build.items()},
           "serving": serve_rec, "training": train_rec, "tp": tp_rec,
           "ipc": ipc_rec, "shard_tensor": st_rec,
           "topo": {"cards": n, "info": info}, "seconds": secs}
    return rec, kernel, serve_launches, train_launches


# -- phase 16: the serving fleet's control plane --------------------------

FLEET = ("r0", "r1", "r2")     # (a): replica processes sharing the card
FLEET_RATE = 400.0             # (a): flash_crowd's base rate in all: one
                               # client process offers ~1,500/s at most,
                               # and the crowd peaks at 2.8x the base
FLEET_SECONDS = 10.0           # (a): the flash_crowd trace's length
FLEET_BUDGET_MS = 5000.0       # (a): each lookup's budget, phase 12 (e)'s
FLEET_KILL_AFTER = 400         # (a): r0's requests before the seeded kill
FLEET_POLL_S = 0.5             # (a): the aggregator's interval
FLEET_STALE_S = 1.5            # (a): with a poll, below the backoff
FLEET_BACKOFF_S = 4.0          # (a): the supervisor's first restart wait
FLEET_BOOT_S = 300.0           # (a): replicas answer within
FLEET_AFTER = 256              # (a): lookups sent to r0 after its restart
FLEET_CHECKS = 32              # (a): answers each replica replays
FLEET_SAMPLE_EVERY = 8         # (a): a replica keeps every 8th answer
FLEET_CFG = SERVER_CFG         # (a): the replicas' knobs, phase 12's
FLEET_HEAD_RATE = 0.02         # (a): the tail samplers' floors
CLIENT_HEAD_RATE = 0.1
REPLICA_BEAT_S = 0.2           # (a): a replica's serving records
REPLICA_SINK_BYTES = 256 << 10 # (a): the aggregator re-reads 2x this
TELEM_BATCHES = 64             # (d): metered batches under sync "error"
TELEM_COLLAPSE = 16            # (d): uniform, then cold-only lookups
PLAN_HIT_RATE = 0.9            # (d): the hit rate the replan's plan wants
ACT_WINDOW = 1024              # (b): trace ids a window, each arm
ACT_WINDOWS = 12               # (b): the drift lands at window 4
ACT_DRIFT_AT = 4
ACT_ROTATE_EVERY = 2           # (b): the adaptive arm's rotation cadence
ACT_MAX_ROWS = 8192            # (b): pairs a rotation
ACT_SERVER_CFG = dict(SERVER_CFG, queue_depth=4096, shed_queue_frac=1.0)
CAPACITY_BUDGET_MS = 150.0     # (c): the p99 budget predicted against
CAPACITY_TRIAL_S = 2.0         # (c): each replay trial, at most
CAPACITY_TRIAL_MAX = 20_000    # (c): requests, so that a trial ends
CAPACITY_TRIALS = 4
CAPACITY_BURST = 4 * BATCH     # (c): the staged burst for the host cost
CLI_TIMEOUT_S = 120            # (e): each operator CLI's process, at most
# (b): the fake-clock autoscaler pass (tests/test_torch_actuator.py holds
# both packages to the same trajectory)
AUTOSCALE_BURNS = [2.0] * 6 + [9.0] * 6 + [0.1] * 30 + [1.6] * 4 + [0.2] * 10
AUTOSCALE_QUEUE = [None] * 20 + [0] * 26 + [50] * 4 + [0] * 6
AUTOSCALE_TRAJECTORY = (
    [2, 2] + [3] * 13 + [2] * 3 + [1] * 26 + [2] * 3 + [3] * 6 + [2] * 3)


class _InertProc:
    """A supervised child that never runs (the autoscaler pass)."""

    pid = 1

    def __init__(self):
        self._rc = None

    def poll(self):
        return self._rc

    def terminate(self):
        self._rc = 0

    def kill(self):
        self._rc = -9

    def send_signal(self, sig):
        self._rc = -int(sig)

    def wait(self, timeout=None):
        return self._rc


def autoscale_pass(act_mod, fleet_mod, **kw):
    """A ``FleetAutoscaler`` over a ``ReplicaSupervisor`` of inert
    children under a fake clock, fed AUTOSCALE_BURNS and AUTOSCALE_QUEUE
    (every 7th poll one replica stale): ``(trajectory, actions, records,
    router snapshot)``. Takes either package's modules."""
    clk = [0.0]
    sup = fleet_mod.ReplicaSupervisor(lambda n, i, a: _InertProc(), 2,
                                      grace_s=0.0, clock=lambda: clk[0])
    sup.step()
    router = fleet_mod.HealthRouter(names=["r0", "r1"])
    sc = act_mod.FleetAutoscaler(sup, router=router, clock=lambda: clk[0],
                                 sustain=2, calm=3, cooldown_s=10.0,
                                 drain_wait_s=0.0, **kw)
    recs = []
    for i, (b, q) in enumerate(zip(AUTOSCALE_BURNS, AUTOSCALE_QUEUE)):
        clk[0] = float(i * 4)
        n = sup.replica_count
        recs.append(sc.step({"replicas": {
            f"r{j}": {"stale": i % 7 == 0 and j == 1,
                      "components": {"burn": b}} for j in range(n)}},
            queue_depth=q))
        sup.step()
    sup.close()
    return sc.trajectory, recs, sc.records, router.snapshot()


def placed(store, feat, what):
    """Fail the run unless ``store``'s hot tier on the card holds the
    host's encoding of its rows of ``feat`` bit for bit."""
    from quiver_tpu_torch import check_leak
    try:
        check_leak.check_placed(store, feat)
    except check_leak.LeakError as e:
        raise SmokeFailure(f"{what}: {e}") from None


def fleet_world(dev):
    """The fleet's full-width world, the same in the parent and in every
    replica: phase 1's graph from the seed, features from ``SEED + 16``,
    an int8 offload store a quarter hot by degree (``dedup_cold``, the
    cold tier pinned and packed), phase 3's GraphSAGE and a fused
    ``ServeEngine`` over SERVER_LADDER, warmed up."""
    import torch
    from quiver_tpu_torch import CSRTopo, Feature, ServeEngine
    from quiver_tpu_torch.ops import quant
    gen = torch.Generator(device=dev).manual_seed(SEED)
    indptr, indices, deg = make_graph(dev, gen, NODES)
    fgen = torch.Generator(device=dev).manual_seed(SEED + 16)
    feat = torch.randn(NODES, DIM, generator=fgen, device=dev).cpu()
    topo = CSRTopo(indptr=indptr, indices=indices, device=dev)
    store = Feature(
        device_cache_size=(NODES // 4) * quant.row_bytes(DIM, "int8"),
        csr_topo=topo, dedup_cold=True, dtype_policy="int8",
        host_placement="offload", device=dev).from_cpu_tensor(feat)
    placed(store, feat, "fleet")
    model, params = sage(dev)
    eng = ServeEngine(model, params, topo, store, SERVER_LADDER, BATCH,
                      fused_hot_hop=True, fused_row_cap=ROW_CAP,
                      collect_metrics=True, seed=SEED,
                      device=dev).warmup()
    return {"indptr": indptr, "indices": indices, "deg": deg, "feat": feat,
            "topo": topo, "store": store, "eng": eng, "params": params}


class AnswerTap:
    """A replica's backend for ``RpcServer``: the server's ``submit``,
    keeping every FLEET_SAMPLE_EVERY-th answer ``(node, row)``."""

    def __init__(self, srv):
        self.srv = srv
        self.seen = 0
        self.sample = []

    def submit(self, node, context=None, deadline=None, tenant=None):
        fut = self.srv.submit(node, context=context, deadline=deadline,
                              tenant=tenant)
        self.seen += 1
        if self.seen % FLEET_SAMPLE_EVERY == 0 and \
                len(self.sample) < 64 * FLEET_CHECKS:
            def keep(f, n=node):
                if f.exception() is None:
                    self.sample.append((n, f.result()))
            fut.add_done_callback(keep)
        return fut

    def health(self):
        return self.srv.health()


def replica_check(eng, rec_eng, tap, launches):
    """A replica's own check after its traffic: its launches per server
    batch, and answers of nodes that sat in exactly one of its batches
    against that batch replayed with its hop seeds."""
    import numpy as np
    calls = list(rec_eng.calls)
    where = {}
    for k, (s, _, _) in enumerate(calls):
        for slot, nid in enumerate(s.tolist()):
            if nid >= 0:
                where.setdefault(nid, []).append((k, slot))
    picked = [(n, row) for n, row in list(tap.sample)
              if len(where.get(n, ())) == 1][:FLEET_CHECKS]
    replay, err = {}, 0.0
    finite = True
    for n, row in picked:
        k, slot = where[n][0]
        if k not in replay:
            s, v, hs = calls[k]
            replay[k] = eng.run(s, v, hop_seeds=hs).cpu().numpy()
        finite &= bool(row.shape == (CLASSES,) and np.isfinite(row).all())
        err = max(err, float(np.abs(row - replay[k][slot]).max()))
    return {"batches": len(calls), "requests": tap.seen,
            "launches": launches, "checked": len(picked),
            "replayed_batches": len(replay), "max_abs_err": err,
            "finite": finite,
            "fills": [int((s >= 0).sum()) for s, _, _ in calls[-8:]]}


def replica_main(argv) -> int:
    """A serve replica of phase 16 (a), run as ``python3 chip_smoke.py
    --replica NAME PORT SINK DIR``: it builds ``fleet_world`` on the
    card, serves it through ``MicroBatchServer`` (a ``TelemetryHub`` as
    its hub, the default tenant classes) behind ``RpcServer`` on PORT, a
    ``TailSampler`` on its tracer and its ``serving``, ``tenant`` and
    kept ``trace`` records in the ``MetricsSink`` SINK; when DIR/check
    appears it writes DIR/NAME.json (``replica_check``). It runs until
    it is killed."""
    import torch
    if not torch.cuda.is_available():
        print(f"replica {argv[:1]}: no CUDA device available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from quiver_tpu_torch.ops import kernels
    kernels.build_kernels()
    serve_replica(torch.device("cuda"), argv[0], int(argv[1]), argv[2],
                  argv[3])
    return 0


def serve_replica(dev, name, port, sink_path, ctl):
    """The replica's body (``replica_main``) on ``dev``."""
    from quiver_tpu_torch import (MicroBatchServer, ServeConfig,
                                  default_tenant_classes, rpc, tracing)
    from quiver_tpu_torch.metrics import MetricsSink
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.ops.kernels import _build
    from quiver_tpu_torch.tailsampling import (TailSampler,
                                               latency_source_from)
    from quiver_tpu_torch.telemetry import TelemetryHub
    t0 = time.perf_counter()
    tracing.set_replica(name)
    w = fleet_world(dev)
    eng = w["eng"]
    del w["feat"]
    rec_eng = RecordingEngine(eng)
    sink = MetricsSink(sink_path, max_bytes=REPLICA_SINK_BYTES)
    # a kernel library built while serving is the port's recompile
    hub = TelemetryHub(sink=sink).watch_compiles(_build.loaded_libraries)
    srv = MicroBatchServer(rec_eng, ServeConfig(**FLEET_CFG), hub=hub,
                           tenants=default_tenant_classes(
                               FLEET_CFG["slo_p99_ms"]))
    TailSampler(sink=sink, head_rate=FLEET_HEAD_RATE,
                seed=SEED + FLEET.index(name),
                latency_source=latency_source_from(stats=srv.stats)).attach()
    tap = AnswerTap(srv)
    kernels.reset_launches()
    front = rpc.RpcServer(tap, host="127.0.0.1", port=port)
    print(f"replica {name}: serving on {front.port} after "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    done = False
    while True:
        srv.emit(sink)
        srv.emit_tenants(sink)
        if not done and os.path.exists(os.path.join(ctl, "check")):
            launches = dict(kernels.LAUNCHES)
            out = replica_check(eng, rec_eng, tap, launches)
            snap = srv.snapshot()
            out.update(replica=name, pid=os.getpid(),
                       hub_series=len(hub.series),
                       anomalies=len(hub.anomalies),
                       batch_ms=snap.get("wall"),
                       request_ms=snap.get("request"),
                       serving={k: snap["serving"].get(k) for k in (
                           "requests", "completed", "rejected",
                           "deadline_expired", "batches",
                           "mean_batch_fill", "variant_batches")})
            tmp = os.path.join(ctl, f"{name}.json.tmp")
            with open(tmp, "w") as f:
                json.dump(out, f)
            os.replace(tmp, os.path.join(ctl, f"{name}.json"))
            done = True
        time.sleep(REPLICA_BEAT_S)


class Timeline:
    """A ``MetricsSink`` stand-in stamping each record with the host's
    monotonic clock before passing it on."""

    def __init__(self, sink):
        self.sink = sink
        self.events = []

    def emit(self, rec, kind=None):
        self.events.append((time.monotonic(), kind, dict(rec)))
        return self.sink.emit(rec, kind=kind)


def free_ports(k):
    import socket
    socks = [socket.socket() for _ in range(k)]
    try:
        for s in socks:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def fleet_start(tmp):
    """Spawn FLEET through a ``ReplicaSupervisor`` (``r0``'s first life
    armed with a seeded ``rpc.request`` kill after FLEET_KILL_AFTER
    requests); returns ``(supervisor, ports, sinks, timeline)``."""
    from quiver_tpu_torch import FaultPlan, FaultRule, fleet
    from quiver_tpu_torch.metrics import MetricsSink
    ports = dict(zip(FLEET, free_ports(len(FLEET))))
    sinks = {n: os.path.join(tmp, f"{n}.jsonl") for n in FLEET}
    plan = FaultPlan(seed=SEED + 7, rules={
        "rpc.request": FaultRule("kill", after=FLEET_KILL_AFTER)})
    here = os.path.dirname(os.path.abspath(__file__))

    def spawn(name, index, attempt):
        env = {k: v for k, v in os.environ.items()
               if k not in ("QT_FAULTS", "QT_FAULTS_SEED")}
        if name == "r0" and attempt == 0:
            env.update(plan.env())
        with open(os.path.join(tmp, f"{name}.{attempt}.log"), "w") as log:
            return subprocess.Popen(
                [sys.executable, os.path.join(here, "chip_smoke.py"),
                 "--replica", name, str(ports[name]), sinks[name], tmp],
                env=env, cwd=here, stdout=log, stderr=subprocess.STDOUT)
    events = Timeline(MetricsSink(os.path.join(tmp, "events.jsonl")))
    sup = fleet.ReplicaSupervisor(
        spawn, len(FLEET), names=list(FLEET), backoff_s=FLEET_BACKOFF_S,
        backoff_cap_s=2 * FLEET_BACKOFF_S, monitor_interval_s=0.05,
        healthy_uptime_s=60.0, grace_s=5.0, sink=events).start()
    return sup, ports, sinks, events


def replica_logs(tmp):
    out = []
    for f in sorted(os.listdir(tmp)):
        if f.endswith(".log"):
            with open(os.path.join(tmp, f)) as fh:
                out.append(f"--- {f}\n" + fh.read()[-2000:])
    return "\n".join(out)


def wait_until(cond, seconds, what, tmp=None):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise SmokeFailure(f"{what} within {seconds:.0f} s"
                       + (f"\n{replica_logs(tmp)}" if tmp else ""))


class OutcomeTap:
    """The fleet's client as ``traffic.replay`` drives it, tallying how
    each request resolved: answered, or the typed error it raised
    (``typed_rejection``); anything else is a lost request."""

    def __init__(self, cli, victim):
        import collections
        import threading
        self.cli, self.victim = cli, victim
        self.outcomes = collections.Counter()
        self._lock = threading.Lock()

    def lookup_future(self, node, budget_ms=None, tenant=None):
        fut = self.cli.lookup_future(node, budget_ms=budget_ms,
                                     tenant=tenant)
        fut.add_done_callback(self._done)
        return fut

    def _done(self, fut):
        e = fut.exception()
        key = "answered" if e is None else typed_rejection(e, self.victim)
        with self._lock:
            self.outcomes[key or f"lost {type(e).__name__}: {e}"[:160]] += 1


def typed_rejection(e, victim):
    """The kind of a typed rejection, or None: the fleet shed the request
    (``Overloaded`` at admission, ``DeadlineExceeded`` or an attempt
    timed out at the end of its budget), or every attempt met one of
    those or the killed replica's closed connection
    (``AllAttemptsFailed``)."""
    from quiver_tpu_torch import rpc
    shed = (rpc.Overloaded, rpc.DeadlineExceeded, rpc.AttemptTimeout)

    def typed(c):
        return isinstance(c, shed) or (
            isinstance(c, (rpc.ReplicaUnavailable, rpc.ServerClosed))
            and str(c).startswith(f"{victim}:"))
    if isinstance(e, rpc.AllAttemptsFailed):
        kinds = sorted({type(c).__name__ for c in e.causes})
        return (f"AllAttemptsFailed ({', '.join(kinds)})"
                if e.causes and all(typed(c) for c in e.causes) else None)
    return type(e).__name__ if typed(e) else None


def fleet_replay(sup, ports, sinks, events, tmp, card, hot_per_batch):
    """(a): the aggregator, router, client and exporter over the fleet,
    ``flash_crowd`` replayed for FLEET_SECONDS at FLEET_RATE, the seeded
    kill of ``r0``, its restart and re-admission, then each replica's
    own check, ``/metrics`` and ``/healthz``, and a kept trace
    assembled across the client and a replica."""
    import urllib.request
    import numpy as np
    from quiver_tpu_torch import fleet, rpc, tracing, traffic
    from quiver_tpu_torch.metrics import MetricsSink, read_jsonl
    from quiver_tpu_torch.tailsampling import TailSampler, TraceStore
    t_boot = time.perf_counter()
    agg = fleet.FleetAggregator(sinks, interval_s=FLEET_POLL_S,
                                stale_after_s=FLEET_STALE_S, sink=events,
                                trace_capacity=4096)
    router = fleet.HealthRouter(list(FLEET), seed=SEED + 3)
    polls = []                      # (time, the router's drained set)

    def follow(snap):
        router.sync(snap)
        polls.append((time.monotonic(), set(router.snapshot()["drained"])))
    agg.on_poll.append(follow)
    addrs = {n: ("127.0.0.1", p) for n, p in ports.items()}
    # an attempt may wait out the whole budget (a queued request is
    # shed by the server's deadline, a typed answer); no hedges, which
    # would double the flash crowd
    cli = rpc.RpcClient(addrs, router=router, timeout_ms=FLEET_BUDGET_MS,
                        retries=3, backoff_ms=20.0, backoff_cap_ms=200.0,
                        hedge=False, seed=SEED + 5)
    exporter = fleet.FleetExporter(agg, port=0)
    client_sink = MetricsSink(os.path.join(tmp, "client.jsonl"))
    sampler = None
    try:
        def pings(names):
            ok = set()
            for n in names:
                try:
                    if cli.ping(n, timeout_ms=500)["ok"]:
                        ok.add(n)
                except Exception:
                    pass
            return ok
        up = set()
        wait_until(lambda: up.update(pings(set(FLEET) - up)) or
                   up == set(FLEET), FLEET_BOOT_S,
                   "the fleet did not come up", tmp)
        boot_s = time.perf_counter() - t_boot
        check(all(s["restarts"] == 0 for s in sup.status().values()),
              f"a replica restarted while booting: {sup.status()}")
        agg.start()
        tracing.clear()
        sampler = TailSampler(sink=client_sink, head_rate=CLIENT_HEAD_RATE,
                              seed=SEED).attach()
        trace = traffic.generate_scenario("flash_crowd", FLEET_SECONDS,
                                          FLEET_RATE, NODES, seed=SEED)
        t_replay = time.monotonic()
        tap = OutcomeTap(cli, "r0")
        rep = traffic.replay(trace, tap, budget_ms=FLEET_BUDGET_MS,
                             sink=client_sink)
        sampler.detach()
        tracing.disable()
        tenants = rep["tenants"]
        outcomes = dict(tap.outcomes)
        lost = {k: v for k, v in outcomes.items() if k.startswith("lost")}
        check(sum(outcomes.values()) == trace["length"] and not lost,
              f"requests lost across the kill: {sum(outcomes.values())} of "
              f"{trace['length']} resolved, {outcomes}")
        wait_until(lambda: sup.status()["r0"]["restarts"] >= 1
                   and sup.status()["r0"]["alive"], FLEET_BOOT_S,
                   "r0 was not restarted", tmp)
        t_back = [t for t, k, r in events.events if k == "chaos"
                  and r.get("event") == "restart"
                  and r.get("replica") == "r0"][0]
        wait_until(lambda: "r0" in pings(["r0"]) and any(
            t > t_back and "r0" not in d for t, d in polls),
            FLEET_BOOT_S, "r0 was not re-admitted", tmp)
        # r0's second life serves too, so that it has batches to check
        solo = rpc.RpcClient({"r0": addrs["r0"]}, retries=2, hedge=False)
        try:
            futs = [solo.lookup_future(int(n), budget_ms=FLEET_BUDGET_MS)
                    for n in np.random.default_rng(SEED + 160).integers(
                        0, NODES, FLEET_AFTER)]
            errs = [f.exception(timeout=60) for f in futs]
        finally:
            solo.close()
        bad = [repr(e) for e in errs if e is not None]
        check(not bad, f"r0's second life failed {len(bad)} of "
              f"{FLEET_AFTER} lookups ({bad[:2]}); supervisor "
              f"{sup.status()['r0']}\n{replica_logs(tmp)}")
        check(all(f.result().shape == (CLASSES,)
                  and np.isfinite(f.result()).all() for f in futs),
              "r0's answers after its restart")
        open(os.path.join(tmp, "check"), "w").close()
        paths = {n: os.path.join(tmp, f"{n}.json") for n in FLEET}
        wait_until(lambda: all(os.path.exists(p) for p in paths.values()),
                   120.0, "the replicas' checks did not finish", tmp)
        checks = {}
        for n, p in paths.items():
            with open(p) as f:
                checks[n] = json.load(f)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{exporter.port}/metrics",
                timeout=10) as r:
            metrics_text = r.read().decode()
            metrics_status = r.status
        with urllib.request.urlopen(
                f"http://127.0.0.1:{exporter.port}/healthz",
                timeout=10) as r:
            healthz = json.loads(r.read())
            healthz_status = r.status
        agg_snap = agg.poll()
        router_snap = router.snapshot()
        client_stats = cli.stats()
    finally:
        if sampler is not None:
            sampler.detach()
        tracing.disable()
        tracing.clear()
        cli.close()
        exporter.close()
        agg.close()
        client_sink.close()
    # the kill's story, in order, on the host's clock
    t_exit = [t for t, k, r in events.events if k == "chaos"
              and r.get("event") == "exit" and r.get("replica") == "r0"]
    t_stale = [t for t, k, r in events.events if k == "anomaly"
               and r.get("detector") == "staleness"
               and r.get("replica") == "r0"]
    t_restart = [t for t, k, r in events.events if k == "chaos"
                 and r.get("event") == "restart" and r.get("replica") == "r0"]
    check(t_exit and t_restart and [t for t in t_stale if t >= t_exit[0]],
          f"r0's story: exit {t_exit}, stale {t_stale}, restart {t_restart}")
    story = {"exit": t_exit[0],
             "stale": min(t for t in t_stale if t >= t_exit[0])}
    t_drain = [t for t, d in polls if t >= story["stale"] and "r0" in d]
    check(t_drain, "r0 was not drained once stale")
    story.update(drained=t_drain[0], restarted=min(
        t for t in t_restart if t >= t_exit[0]))
    story["readmitted"] = min(t for t, d in polls
                              if t > story["restarted"] and "r0" not in d)
    order = ["exit", "stale", "drained", "restarted", "readmitted"]
    check(all(story[a] <= story[b] for a, b in zip(order, order[1:])),
          f"r0's story out of order: {story}")
    story_s = {k: round(v - t_replay, 3) for k, v in story.items()}
    # each replica's check
    per = {}
    for n, c in checks.items():
        b, la = c["batches"], c["launches"]
        check(b > 0 and c["checked"] > 0 and c["finite"]
              and c["max_abs_err"] <= SERVER_TOL,
              f"replica {n}: {c['checked']} answers checked over {b} "
              f"batches, max error {c['max_abs_err']}")
        check(la["fused_sample_hop"] == 2 * b and la["fused_hot_hop"] == b
              and la["gather_rows"] == hot_per_batch * b
              and la["sample_layer"] == la["gather_elems"] == 0,
              f"replica {n}: launches {la} over {b} server batches")
        per[n] = {k: v / b for k, v in la.items()}
    check(metrics_status == 200 and "qt_fleet_replicas 3" in metrics_text
          and all(f'qt_replica_health{{replica="{n}"}}' in metrics_text
                  for n in FLEET),
          "/metrics did not answer the fleet's exposition")
    check(healthz_status == 200 and set(healthz["replicas"]) == set(FLEET),
          f"/healthz answered {healthz_status}")
    # a kept trace: the client's rpc.* spans and a replica's serve.*
    store = TraceStore(capacity=1 << 16)
    for n in FLEET:
        for r in read_jsonl(sinks[n]):
            if r.get("kind") == "trace":
                store.add(r, n)
    client_kept = 0
    for r in read_jsonl(os.path.join(tmp, "client.jsonl")):
        if r.get("kind") == "trace":
            store.add(r, "client")
            client_kept += 1
    joined = None
    for tid in store.trace_ids():
        t = store.get(tid)
        roots = {s.get("root") for s in t["segments"]}
        if {"rpc.lookup", "serve.request"} <= roots:
            joined = t
            break
    check(joined is not None, f"no kept trace joins the client's and a "
          f"replica's segments ({len(store)} traces, {client_kept} from "
          "the client)")
    names = sorted({s["name"] for seg in joined["segments"]
                    for s in seg.get("spans", ())})
    check(any(x.startswith("rpc.") for x in names)
          and any(x.startswith("serve.") for x in names),
          f"the joined trace's spans: {names}")
    total = {k: sum(r[k] for r in tenants.values()) for k in (
        "offered", "completed", "rejected", "deadline_expired", "failed")}
    p99 = {t: r["latency"]["p99_ms"] for t, r in tenants.items()}
    offered = trace["length"] / rep["offer_wall_s"]
    print(f"fleet (a): {len(FLEET)} replica processes on the card (one "
          f"card: no speed across cards is measured), up in {boot_s:.2f} "
          f"s; flash_crowd {FLEET_SECONDS:g} s at a base of "
          f"{FLEET_RATE:g}/s ({trace['length']} requests: "
          f"{trace['length'] / FLEET_SECONDS:.0f}/s in the trace, "
          f"{offered:.0f}/s offered, offer loop {rep['offer_wall_s']:.2f} "
          f"s, wall {rep['wall_s']:.2f} s; lookup budget "
          f"{FLEET_BUDGET_MS:g} ms, replicas' SLO "
          f"{FLEET_CFG['slo_p99_ms']:g} ms): {total}; outcomes "
          f"{outcomes}; p99 ms by tenant {p99}; on {card}", flush=True)
    print(f"fleet (a): r0 killed after its {FLEET_KILL_AFTER} requests: "
          f"seconds from the replay's start: {story_s}; router "
          f"{router_snap['drains']} drains, {router_snap['readmits']} "
          f"re-admits; fleet status {agg_snap['fleet']['status']}; client "
          f"{client_stats}", flush=True)
    for n, c in checks.items():
        print(f"fleet (a) {n}: {c['requests']} requests in {c['batches']} "
              f"server batches (last fills {c['fills']}); {c['checked']} "
              f"answers against {c['replayed_batches']} replayed batches "
              f"within {c['max_abs_err']:.3g}; launches per server batch "
              + ", ".join(f"{k} {v:g}" for k, v in per[n].items() if v)
              + f"; hub {c['hub_series']} series, {c['anomalies']} "
              f"anomalies; batch ms {c['batch_ms']}; request ms "
              f"{c['request_ms']}; {c['serving']}", flush=True)
    print(f"fleet (a): /metrics {len(metrics_text)} bytes, /healthz "
          f"{healthz['fleet']['status']}; trace {joined['trace_id']} joins "
          f"{joined['replicas']}: {names}; {len(store)} kept traces",
          flush=True)
    launches = {k: sum(c["launches"][k] for c in checks.values())
                for k in checks["r0"]["launches"]}
    batches = sum(c["batches"] for c in checks.values())
    return {"boot_s": boot_s, "requests": trace["length"], "totals": total,
            "base_rps": FLEET_RATE, "offered_rps": offered,
            "budget_ms": FLEET_BUDGET_MS,
            "slo_p99_ms": FLEET_CFG["slo_p99_ms"],
            "outcomes": outcomes, "client": client_stats,
            "tenants": tenants, "offer_wall_s": rep["offer_wall_s"],
            "wall_s": rep["wall_s"], "kill_story_s": story_s,
            "router": router_snap, "replicas": checks,
            "launches_per_batch": per, "metrics_bytes": len(metrics_text),
            "healthz": healthz["fleet"],
            "healthz_replicas": {n: {k: r.get(k) for k in ("health",
                                                          "stale")}
                                 for n, r in healthz["replicas"].items()},
            "joined_trace": {
                "trace_id": joined["trace_id"],
                "replicas": joined["replicas"], "spans": names},
            "kept_traces": len(store)}, launches, batches


def fleet_telemetry(dev, w, card, tmp):
    """(d): TELEM_BATCHES metered batches with the hub recording each
    counter vector under sync "error"; after ``flush`` the hub's totals
    against ``metrics.reduce_counters`` of the same vectors; cold-only
    lookups collapse the hit rate (an ``anomaly``), ``replan`` advises,
    a ``FlightRecorder`` dump holds the spans and series. Returns the
    record and the server batch's ``gather_rows`` launches."""
    import numpy as np
    import torch
    from quiver_tpu_torch import metrics, tracing
    from quiver_tpu_torch.metrics import MetricsSink, read_jsonl
    from quiver_tpu_torch.ops import kernels
    from quiver_tpu_torch.telemetry import (FlightRecorder, PlanContext,
                                            TelemetryHub)
    eng, store = w["eng"], w["store"]
    rng = np.random.default_rng(SEED + 161)
    batches = [torch.from_numpy(rng.choice(NODES, BATCH, replace=False)
                                .astype(np.int32)).to(dev)
               for _ in range(TELEM_BATCHES)]
    kernels.reset_launches()
    eng.run(batches[0])
    torch.cuda.synchronize()
    hot_per_batch = kernels.LAUNCHES["gather_rows"]
    path = os.path.join(tmp, "telemetry.jsonl")
    sink = MetricsSink(path)
    hub = TelemetryHub(sink=sink)
    vecs = []
    tracing.clear()
    tracing.enable()

    def serve():
        for i, ids in enumerate(batches):
            with tracing.span("fleet.telemetry_batch", args={"i": i}):
                eng.run(ids)
                hub.observe_counters(eng.last_counters)
                vecs.append(eng.last_counters.clone())
    t0 = time.perf_counter()
    sync_free(serve, "the hub's recording path")
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    hub.flush()
    want = metrics.reduce_counters(torch.stack(vecs))
    got = hub.counters()
    check(np.array_equal(got, want), f"the hub's counters {got.tolist()} "
          f"differ from reduce_counters {want.tolist()}")
    # the served batches count the cold fixup's rows only (the leaf
    # kernel reads the hot ones): the hit rate's baseline comes from the
    # store's metered lookups of uniform ids, then cold-only ones
    order = store._order_host()
    cold = np.nonzero(order >= store.cache_rows)[0]
    for pool in (np.arange(NODES), cold):
        for _ in range(TELEM_COLLAPSE):
            ids = torch.from_numpy(rng.choice(pool, BATCH, replace=False)
                                   .astype(np.int32)).to(dev)
            _, c = store.lookup_tiered(ids, collect_metrics=True)
            hub.observe_counters(c)
        hub.flush()
        if pool is not cold:
            base = hub.series["hot_hit_rate"].window_stats(
                TELEM_COLLAPSE)["mean"]
    fired = [a for a in hub.anomalies if a["series"] == "hot_hit_rate"]
    check(fired, f"the hot tier's collapse fired no anomaly "
          f"({list(hub.anomalies)})")
    advice = hub.replan(PlanContext(
        hot_capacity=store.cache_rows, total_rows=NODES,
        degree=w["deg"].cpu().numpy(), expected_hit_rate=PLAN_HIT_RATE,
        batch_cap=BATCH, max_wait_ms=SERVER_CFG["max_wait_ms"],
        target_p99_ms=SERVER_CFG["slo_p99_ms"]))
    check(any(a["key"] == "hot_capacity" for a in advice),
          f"replan gave no hot_capacity advice: {advice}")
    pm = FlightRecorder(path=os.path.join(tmp, "postmortem.json"),
                        hub=hub).dump(reason="phase 16 (d)")
    tracing.disable()
    tracing.clear()
    sink.close()
    with open(pm) as f:
        doc = json.load(f)
    check(any(s["name"] == "fleet.telemetry_batch" for s in doc["spans"])
          and doc["series"].get("hot_hit_rate")
          and doc["counters"] == metrics.counters_dict(hub.counters()),
          "the flight recorder's dump lacks the spans, series or counters")
    kinds = [r["kind"] for r in read_jsonl(path)]
    check("anomaly" in kinds and "advice" in kinds,
          f"the hub's sink holds {sorted(set(kinds))}")
    hot = {a["key"]: a for a in advice}["hot_capacity"]
    print(f"fleet (d): {TELEM_BATCHES} metered batches, each counter vector "
          f"recorded by TelemetryHub.observe_counters under "
          f"the card's sync debug mode: no sync, {serve_ms:.1f} ms; "
          f"after flush the hub's totals equal reduce_counters of the same "
          f"vectors; lookups' hit rate {base:.4f} -> 0 over "
          f"{TELEM_COLLAPSE} cold-only lookups: anomaly {fired[0]['detector']} at step "
          f"{fired[0]['step']}; advice {[a['key'] for a in advice]} "
          f"(hot_capacity {hot['current']} -> {hot['recommended']}); "
          f"postmortem {len(doc['spans'])} spans, {len(doc['series'])} "
          f"series; on {card}", flush=True)
    return {"batches": TELEM_BATCHES, "serve_ms": serve_ms,
            "hit_rate": base, "anomaly": fired[0], "advice": advice,
            "postmortem_spans": len(doc["spans"]),
            "counters": metrics.counters_dict(got)}, hot_per_batch


def fleet_actuation(dev, w, card, tmp):
    """(b): two numpy-placement int8 stores (a quarter hot by degree) with
    a fused engine and a server each replay one drifting trace, ABBA per
    window; the adaptive arm's ``Actuator`` observes the served ids and
    rotates through its live server's engine. Then the rotated store
    against one built with its hot set, a knob swap inside and one
    outside the lattice, and the fake-clock autoscaler pass."""
    import numpy as np
    import torch
    from quiver_tpu_torch import (Feature, MicroBatchServer, ServeConfig,
                                  ServeEngine, actuator, fleet, metrics)
    from quiver_tpu_torch.datasets import generate_drifting_trace
    from quiver_tpu_torch.metrics import MetricsSink, read_jsonl
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch import GraphSAGE

    def make_store():
        store = Feature(
            device_cache_size=(NODES // 4) * quant.row_bytes(DIM, "int8"),
            csr_topo=w["topo"], dedup_cold=True, dtype_policy="int8",
            host_placement="numpy", device=dev).from_cpu_tensor(w["feat"])
        placed(store, w["feat"], "(b)")
        return store
    t0 = time.perf_counter()
    stores = {"static": make_store(), "adaptive": make_store()}
    engines, servers = {}, {}
    for name, s in stores.items():
        engines[name] = ServeEngine(
            GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES)), w["params"],
            w["topo"], s, [SIZES], BATCH, fused_hot_hop=True,
            fused_row_cap=ROW_CAP, seed=SEED, device=dev).warmup()
        servers[name] = MicroBatchServer(engines[name],
                                         ServeConfig(**ACT_SERVER_CFG))
    setup_s = time.perf_counter() - t0
    trace = generate_drifting_trace(ACT_WINDOWS * ACT_WINDOW, NODES,
                                    skew=4.0,
                                    rotate_every=ACT_DRIFT_AT * ACT_WINDOW,
                                    hot_frac=0.05, seed=7)
    clk = [0.0]
    path = os.path.join(tmp, "actuate.jsonl")
    sink = MetricsSink(path)
    act = actuator.Actuator(sink=sink, clock=lambda: clk[0], cooldown_s=1.0,
                            settle_s=0.0)
    hits = {a: [] for a in stores}
    rot = []
    try:
        for i in range(ACT_WINDOWS):
            clk[0] = float(i)
            ids = trace[i * ACT_WINDOW:(i + 1) * ACT_WINDOW].astype(np.int32)
            arms = ["static", "adaptive"][::1 if i % 2 == 0 else -1]
            for name in arms:
                store, srv = stores[name], servers[name]
                futs = srv.submit_many([int(v) for v in ids])
                rows = [f.result(timeout=120) for f in futs]
                check(all(np.isfinite(r).all() for r in rows[:8]),
                      "(b): a served row is not finite")
                _, c = store.lookup_tiered(torch.from_numpy(ids).to(dev),
                                           collect_metrics=True)
                c = np.asarray(c.cpu())
                hits[name].append((int(c[metrics.HOT_ROWS]),
                                   int(c[metrics.COLD_ROWS])))
                if name == "adaptive":
                    act.observe_ids(ids, total_rows=NODES)
                    if i % ACT_ROTATE_EVERY == ACT_ROTATE_EVERY - 1:
                        t1 = time.perf_counter()
                        r = act.maybe_rotate(store, engine=engines[name],
                                             max_rows=ACT_MAX_ROWS,
                                             min_gain=2)
                        if r is not None:
                            rot.append((i, r["rotated"],
                                        (time.perf_counter() - t1) * 1e3))
        p99 = {a: servers[a].snapshot()["request"]["p99_ms"]
               for a in servers}

        def rate(name, lo, hi):
            h = np.array(hits[name][lo:hi]).sum(axis=0)
            return float(h[0] / h.sum())
        rates = {a: {"before": rate(a, 1, ACT_DRIFT_AT),
                     "after": rate(a, ACT_DRIFT_AT, ACT_WINDOWS),
                     "last": rate(a, ACT_WINDOWS - 2, ACT_WINDOWS),
                     "windows": [h / max(h + c, 1) for h, c in hits[a]]}
                 for a in stores}
        # the rotated store against one built with its hot set
        ad = stores["adaptive"]
        fresh = make_store()
        o_ad, o_fr = ad._order_host(), fresh._order_host()
        hot_ad, hot_fr = o_ad < ad.cache_rows, o_fr < fresh.cache_rows
        promote = np.nonzero(hot_ad & ~hot_fr)[0]
        demote = np.nonzero(hot_fr & ~hot_ad)[0]
        fresh.rotate_hot_set(promote, demote)
        check(np.array_equal(fresh._order_host() < fresh.cache_rows, hot_ad),
              "(b): the rebuilt store's hot set differs")
        probe = np.unique(np.concatenate([
            promote, demote, np.random.default_rng(SEED + 162).integers(
                0, NODES, 1 << 18)])).astype(np.int32)
        pt = torch.from_numpy(probe).to(dev)
        check(same_bits(ad[pt], fresh[pt]), "(b): the rotated store's rows "
              "differ from a store built with its hot set")
        # a swap inside the lattice applies, one outside is refused
        act.attach_server(servers["adaptive"])
        act.tick([{"key": "batch_cap", "recommended": BATCH // 2,
                   "observed": {}, "reason": "phase 16 (b)"}])
        applied = servers["adaptive"].knobs()["batch_fill_cap"]
        refused = act.tick([{"key": "max_wait_ms", "recommended": 0.3,
                             "observed": {}, "reason": "phase 16 (b)"}])
        check(applied == BATCH // 2, f"(b): the batch_cap swap gave "
              f"{applied}")
        check(refused and refused[-1]["action"] == "refuse"
              and refused[-1]["level"] == "WARN"
              and servers["adaptive"].knobs()["max_wait_ms"]
              == SERVER_CFG["max_wait_ms"],
              f"(b): the swap outside the lattice: {refused}")
    finally:
        for srv in servers.values():
            srv.close()
        sink.close()
    warn = [r for r in read_jsonl(path) if r.get("kind") == "actuate"
            and r.get("level") == "WARN"]
    check(warn and warn[-1]["action"] == "refuse",
          "(b): no WARN actuate record on the sink")
    traj = autoscale_pass(actuator, fleet, max_replicas=3, min_replicas=1)[0]
    check(traj == AUTOSCALE_TRAJECTORY, f"(b): the autoscaler's trajectory "
          f"{traj}")
    print(f"fleet (b): two numpy-placement int8 stores ({ad.cache_rows} hot "
          f"rows) with engines and servers, built in {setup_s:.2f} s; "
          f"{ACT_WINDOWS} windows of {ACT_WINDOW} drifting-trace ids "
          f"(the head moves at window {ACT_DRIFT_AT}), ABBA: hit rate before "
          f"/ after the drift / last 2 windows: static "
          f"{rates['static']['before']:.4f} / {rates['static']['after']:.4f}"
          f" / {rates['static']['last']:.4f}, adaptive "
          f"{rates['adaptive']['before']:.4f} / "
          f"{rates['adaptive']['after']:.4f} / "
          f"{rates['adaptive']['last']:.4f}; {len(rot)} rotations "
          f"({sum(r[1] for r in rot)} pairs, "
          f"{', '.join('%.1f' % r[2] for r in rot)} ms each with the "
          f"refresh); served p99 static {p99['static']:.2f} ms, adaptive "
          f"{p99['adaptive']:.2f} ms; on {card}", flush=True)
    print(f"fleet (b): the rotated store's rows equal a store built with "
          f"its hot set bit for bit ({probe.size} ids); batch_cap swap to "
          f"{applied} applied, max_wait_ms 0.3 refused (WARN); autoscaler "
          f"trajectory {traj}", flush=True)
    for s in (*stores.values(), fresh):
        s.close()
    return {"setup_s": setup_s, "hit_rates": rates, "rotations": rot,
            "served_p99_ms": p99, "autoscale_trajectory": traj,
            "probe_ids": int(probe.size)}


def capacity_trial(eng, rate):
    """One steady replay at ``rate`` against a fresh server: (sustained,
    completed rps, p99 ms)."""
    from quiver_tpu_torch import MicroBatchServer, ServeConfig, traffic
    rate = max(rate, 16.0 / CAPACITY_TRIAL_S)
    seconds = min(CAPACITY_TRIAL_S, CAPACITY_TRIAL_MAX / rate)
    trace = traffic.generate_scenario(
        "steady", seconds, rate, NODES,
        mix={"interactive": 1.0}, seed=SEED + int(rate) % 1000)
    srv = MicroBatchServer(eng, ServeConfig(**dict(
        SERVER_CFG, queue_depth=1 << 16, shed_queue_frac=1.0)))
    try:
        rep = traffic.replay(trace, srv, budget_ms=CAPACITY_BUDGET_MS)
    finally:
        srv.close()
    r = rep["tenants"]["interactive"]
    p99 = r["latency"]["p99_ms"]
    ok = (r["completed"] == r["offered"] and p99 is not None
          and p99 <= CAPACITY_BUDGET_MS
          and rep["offer_wall_s"] <= 1.1 * seconds)
    return ok, rate, r["completed_rps"], p99, rep["offer_wall_s"]


def fleet_capacity(dev, w, card, tmp, gather_gbps):
    """(c): the dispatch p50 of a full-fill ``engine.run`` loop, the
    served batch's bytes and phase 2's gather rate into
    ``capacity.predict``, the coalescer's per-request host cost from a
    staged burst, then a doubling-and-bisect search of at most
    CAPACITY_TRIALS steady replays from the predicted rate, and
    ``capacity.verdict``."""
    import numpy as np
    import torch
    from quiver_tpu_torch import (MicroBatchServer, ServeConfig, ServeEngine,
                                  capacity, GraphSAGE)
    from quiver_tpu_torch.metrics import MetricsSink
    eng = ServeEngine(GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES)),
                      w["params"], w["topo"], w["store"], [SIZES], BATCH,
                      fused_hot_hop=True, fused_row_cap=ROW_CAP, seed=SEED,
                      device=dev).warmup()
    rng = np.random.default_rng(SEED + 163)
    lat = []
    for _ in range(16):
        ids = torch.from_numpy(rng.choice(NODES, BATCH, replace=False)
                               .astype(np.int32)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(ids)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    dispatch = pcts(lat)[0]
    cost = served_batch_bytes(eng, ids, [11, 22, 33], SIZES, ROW_CAP)
    srv = MicroBatchServer(eng, ServeConfig(**dict(
        SERVER_CFG, queue_depth=2 * CAPACITY_BURST, shed_queue_frac=1.0)),
        start=False)
    futs = srv.submit_many([int(v) for v in rng.choice(
        NODES, CAPACITY_BURST, replace=False)])
    t0 = time.perf_counter()
    srv.start()
    for f in futs:
        f.result(timeout=120)
    burst_ms = (time.perf_counter() - t0) * 1e3
    burst_batches = srv.snapshot()["serving"]["batches"]
    srv.close()
    overhead = max(0.0, burst_ms - burst_batches * dispatch) / CAPACITY_BURST
    pred = capacity.predict(
        batch_cap=BATCH, dispatch_ms=dispatch,
        budget_p99_ms=CAPACITY_BUDGET_MS, replicas=1,
        max_wait_ms=SERVER_CFG["max_wait_ms"], overhead_per_req_ms=overhead,
        probe={"gather_gbps": gather_gbps}, cost=cost)
    trials, good, bad = [], None, None
    rate = pred["predicted_rps"]
    for _ in range(CAPACITY_TRIALS):
        ok, rate, rps, p99, offer = capacity_trial(eng, rate)
        trials.append({"rate": rate, "sustained": ok, "completed_rps": rps,
                       "p99_ms": p99, "offer_wall_s": offer})
        if ok:
            good = max(good or 0.0, rate)
            rate = rate * 2 if bad is None else (rate + bad) / 2
        else:
            bad = rate if bad is None else min(bad, rate)
            rate = rate / 2 if good is None else (good + rate) / 2
    # the best sustained trial's rate; none sustained: the slowest
    # trial's completions, the nearest the search came
    measured = (max(t["completed_rps"] for t in trials if t["sustained"])
                if good is not None else
                min(trials, key=lambda t: t["rate"])["completed_rps"])
    verdict = capacity.verdict(pred, measured)
    with MetricsSink(os.path.join(tmp, "capacity.jsonl")) as sink:
        capacity.emit(sink, {**pred, "verdict": verdict, "trials": trials})
    print(f"fleet (c): dispatch p50 {dispatch:.3f} ms (16 full batches), "
          f"served batch {cost} B (floor {pred['floor_ms']} ms at "
          f"{gather_gbps:.1f} GB/s), coalescer host cost "
          f"{overhead * 1e3:.2f} us a request ({CAPACITY_BURST} staged in "
          f"{burst_batches} batches, {burst_ms:.1f} ms); predicted "
          f"{pred['predicted_rps']:.1f} req/s (fill {pred['fill']}, "
          f"utilization cap {pred['utilization_cap']}, budget p99 "
          f"{CAPACITY_BUDGET_MS:g} ms); trials "
          + ", ".join(f"{t['rate']:.0f}/s {'ok' if t['sustained'] else 'no'}"
                      f" ({t['completed_rps']:.0f}/s, p99 {t['p99_ms']} ms, "
                      f"offer {t['offer_wall_s']:.2f} s)" for t in trials)
          + f"; verdict {verdict}; on {card}", flush=True)
    return {"dispatch_p50_ms": dispatch, "cost_bytes": cost,
            "overhead_per_req_ms": overhead, "prediction": pred,
            "trials": trials, "verdict": verdict}


def health_band(h, stale=False) -> str:
    """The band ``qt_agg`` and ``qt_top`` color a replica's health by."""
    return ("red" if stale or h is None or h < 0.4
            else "yellow" if h < 0.75 else "green")


def fleet_cli(name, *args):
    """``python -m quiver_tpu_torch.scripts.NAME ARGS`` from the checkout
    (no color), checked to exit 0; returns its output and wall seconds."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("FORCE_COLOR", "QT_METRICS_JSONL")}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        f"quiver_tpu_torch.scripts.{name}", *args,
                        "--no-color"], cwd=here, env=env, capture_output=True,
                       text=True, timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    check(r.returncode == 0, f"{name} {' '.join(args)} exited "
          f"{r.returncode}:\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    return r.stdout, secs


def fleet_clis(tmp, sinks, rec, card):
    """(e): the four operator CLIs over the fleet's own sinks, after (a)
    and (c) (module doc)."""
    from quiver_tpu_torch.metrics import read_jsonl
    from quiver_tpu_torch.tailsampling import TraceStore
    a, c = rec["fleet"], rec["capacity"]
    secs, notes = {}, []
    spec = ",".join(f"{n}={sinks[n]}" for n in FLEET)

    # qt_agg: one pass over the replica sinks, then its own probe
    out, secs["qt_agg --once"] = fleet_cli(
        "qt_agg", "--once", "--replicas", spec, "--interval",
        str(FLEET_POLL_S), "--stale-after", str(FLEET_STALE_S), "--jsonl",
        os.path.join(tmp, "agg_once.jsonl"))
    rows = {}
    for ln in out.splitlines():
        m = re.match(r"^  (\S+): health ([0-9.]+)(  STALE)?", ln)
        if m:
            rows[m.group(1)] = (float(m.group(2)), bool(m.group(3)))
    check(sorted(rows) == sorted(FLEET), f"qt_agg --once rows {rows}")
    for n in FLEET:
        hz = a["healthz_replicas"][n]
        got, want = health_band(*rows[n]), health_band(hz["health"],
                                                       hz["stale"])
        check(got == want, f"qt_agg --once: {n} health {rows[n]} ({got}); "
              f"(a)'s /healthz {hz} ({want})")
    notes.append("qt_agg --once: " + ", ".join(
        f"{n} {rows[n][0]:.2f} ({health_band(*rows[n])}; /healthz "
        f"{a['healthz_replicas'][n]['health']:.2f})" for n in FLEET))
    out, secs["qt_agg --smoke"] = fleet_cli("qt_agg", "--smoke")
    check("status ok" in out and "format OK" in out,
          f"qt_agg --smoke: {out[-800:]}")

    # qt_top: a replica's sink, then the aggregator's
    out, secs["qt_top"] = fleet_cli("qt_top", "--once", "--jsonl",
                                    sinks["r1"])
    for needle in ("batch_p50_ms", "request_p99_ms", "queue_depth",
                   "slo: burn", "tenant interactive"):
        check(needle in out, f"qt_top over r1's sink lacks {needle!r}:\n"
              f"{out[-3000:]}")
    n_recs = re.search(r"\((\d+) records", out)
    events = os.path.join(tmp, "events.jsonl")
    out, secs["qt_top --fleet"] = fleet_cli("qt_top", "--once", "--fleet",
                                            "--jsonl", events)
    # the panel shows the window's last 6 anomalies: r0's staleness, or
    # the fleet hub's detectors that fired after it
    shown = [r for r in read_jsonl(events)[-4096:]
             if r.get("kind") == "anomaly"][-6:]
    check(f"fleet: {len(FLEET)} replicas, status" in out
          and all(re.search(rf"^  {n} ", out, re.M) for n in FLEET)
          and shown and all(f"ANOMALY [{r.get('detector')}] "
                            f"{r.get('series')}:" in out for r in shown),
          f"qt_top --fleet:\n{out[-3000:]}")
    stale_r0 = any(r.get("detector") == "staleness"
                   and r.get("replica") == "r0" for r in shown)
    notes.append(f"qt_top: r1's sink ({n_recs.group(1) if n_recs else '?'} "
                 "records) with its serving, SLO and tenant lines; --fleet: "
                 f"{len(FLEET)} rows and {len(shown)} anomalies (r0's "
                 f"staleness {'among' if stale_r0 else 'before'} them)")

    # qt_trace: the client's sink and the replicas', against a TraceStore
    # filled in the CLI's order
    targs = ["--jsonl", os.path.join(tmp, "client.jsonl"), "--replicas",
             spec]
    store = TraceStore(capacity=4096)
    for src, path in [("sink", os.path.join(tmp, "client.jsonl"))] + \
            [(n, sinks[n]) for n in FLEET]:
        for r in read_jsonl(path):
            if r.get("kind") == "trace":
                store.add(r, src)
    traces = store.assembled()
    out, secs["qt_trace"] = fleet_cli("qt_trace", *targs)
    check(f"{len(traces)} kept traces from {len(FLEET) + 1} sink(s)" in out,
          f"qt_trace: {out[:400]} against {len(traces)} traces")
    out, secs["qt_trace --slowest"] = fleet_cli("qt_trace", *targs,
                                                "--slowest", "5")
    slow = sorted(traces, key=lambda t: -t["duration_ms"])[:5]
    got = [int(ln.split()[0]) for ln in out.splitlines()[1:]]
    check(got == [t["trace_id"] for t in slow],
          f"qt_trace --slowest 5: {got}, expected "
          f"{[t['trace_id'] for t in slow]}")
    out, secs["qt_trace --errors"] = fleet_cli("qt_trace", *targs,
                                               "--errors")
    bad = [t for t in traces if set(t["policies"])
           & {"error", "deadline_exceeded"}][:20]
    got = [int(ln.split()[0]) for ln in out.splitlines()[1:]
           if ln.split() and ln.split()[0].isdigit()]
    check(got == [t["trace_id"] for t in bad],
          f"qt_trace --errors: {got}, expected {len(bad)} traces")
    tid = a["joined_trace"]["trace_id"]
    joined = store.get(tid)
    check(joined is not None, f"(a)'s joined trace {tid} is not among the "
          "4096 newest the CLI keeps")
    export = os.path.join(tmp, "trace.json")
    out, secs["qt_trace --trace-id --export"] = fleet_cli(
        "qt_trace", *targs, "--trace-id", str(tid), "--export", export)
    n_seg = len(joined["segments"])
    check(out.count("\n  segment ") == n_seg and f"trace {tid} [" in out
          and "critical path" in out,
          f"qt_trace --trace-id {tid}: {out[-2000:]}")
    with open(export) as f:
        events = json.load(f)["traceEvents"]
    pids = {e["pid"] for e in events}
    check(len(pids) == n_seg, f"qt_trace --export: {len(pids)} process "
          f"tracks for {n_seg} segments")
    notes.append(f"qt_trace: {len(traces)} traces from {len(FLEET) + 1} "
                 f"sinks, the 5 slowest, {len(bad)} error-kept, trace {tid} "
                 f"({n_seg} segments: {'+'.join(joined['replicas'])}) "
                 f"exported as {len(events)} events on {len(pids)} process "
                 "tracks")

    # qt_capacity: (c)'s record, then a prediction from the replicas'
    # serving records with the probe on the card
    pred = c["prediction"]["predicted_rps"]
    out, secs["qt_capacity"] = fleet_cli(
        "qt_capacity", "--jsonl", os.path.join(tmp, "capacity.jsonl"))
    check(out.startswith(f"capacity: 1 replica(s) sustain {pred:.0f} "
                         "req/s") and "replay verdict" in out,
          f"qt_capacity over (c)'s record: {out[:600]}")
    served = sorted((r for n in FLEET for r in read_jsonl(sinks[n])
                     if r.get("kind") == "serving"),
                    key=lambda r: r.get("ts", 0.0))
    history = os.path.join(tmp, "serving.jsonl")
    with open(history, "w") as f:
        for r in served:
            f.write(json.dumps(r) + "\n")
    out, secs["qt_capacity --predict"] = fleet_cli(
        "qt_capacity", "--jsonl", history, "--predict", "--replicas",
        str(len(FLEET)), "--budget-ms", str(FLEET_CFG["slo_p99_ms"]))
    caps = [r for r in read_jsonl(history) if r.get("kind") == "capacity"]
    check(len(caps) == 1 and f"sustain {caps[0]['predicted_rps']:.0f} "
          "req/s" in out, f"qt_capacity --predict: {out[:600]}")
    predicted = caps[0]
    sustained = a["totals"]["completed"] / a["wall_s"]
    notes.append(
        f"qt_capacity: (c)'s {pred:.1f} req/s; --predict (probe on the "
        f"card) from {len(served)} serving records: {len(FLEET)} replicas "
        f"sustain {predicted['predicted_rps']:.1f} req/s within p99 "
        f"{FLEET_CFG['slo_p99_ms']:g} ms (dispatch "
        f"{predicted['dispatch_ms']:.3f} ms, fill {predicted['fill']}/"
        f"{predicted['batch_cap']}) beside (a)'s sustained "
        f"{sustained:.1f} req/s ({a['totals']['completed']} completed in "
        f"{a['wall_s']:.2f} s; {a['offered_rps']:.1f}/s offered)")
    for note in notes:
        print(f"fleet (e): {note}; on {card}", flush=True)
    print("fleet (e): seconds " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()) + f"; on {card}",
        flush=True)
    return {"seconds": secs, "agg_health": {n: rows[n][0] for n in FLEET},
            "traces": len(traces), "error_traces": len(bad),
            "joined_segments": n_seg, "export_tracks": len(pids),
            "predicted_rps": predicted["predicted_rps"],
            "prediction": predicted, "sustained_rps": sustained,
            "offered_rps": a["offered_rps"]}


def phase_fleet(dev, card, gather_gbps):
    """Phase 16: the serving fleet's control plane (module doc). The
    replicas boot while (d) and (b) run in this process; (c) runs after
    the fleet has stopped. Returns the record, the replicas' launches
    and their server batches."""
    secs, rec = {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        return out
    tmp = tempfile.mkdtemp(prefix="qt_fleet_")
    t_all = time.perf_counter()
    sup = None
    # the killed replica's torn connections: asyncio logs each abandoned
    # frame's exception, and (a)'s outcomes count them instead
    logging.getLogger("asyncio").setLevel(logging.CRITICAL)
    try:
        sup, ports, sinks, events = fleet_start(tmp)
        import torch
        w = part("world", fleet_world, dev)
        rec["telemetry"], hot_per_batch = part("(d)", fleet_telemetry, dev,
                                               w, card, tmp)
        rec["actuation"] = part("(b)", fleet_actuation, dev, w, card, tmp)
        rec["fleet"], launches, batches = part(
            "(a)", fleet_replay, sup, ports, sinks, events, tmp, card,
            hot_per_batch)
        sup.close()
        sup = None
        rec["capacity"] = part("(c)", fleet_capacity, dev, w, card, tmp,
                               gather_gbps)
        w["store"].close()
        del w
        torch.cuda.empty_cache()
        rec["clis"] = part("(e)", fleet_clis, tmp, sinks, rec, card)
    finally:
        if sup is not None:
            sup.close()
        shutil.rmtree(tmp, ignore_errors=True)
        import gc
        gc.collect()
        logging.getLogger("asyncio").setLevel(logging.NOTSET)
    total = time.perf_counter() - t_all
    print(f"phase 16: {total:.2f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in secs.items()), flush=True)
    rec["seconds"] = dict(secs, total=total)
    return rec, launches, batches


PROFILE_REPS = 5               # (c): timed calls of each stage
PROFILE_HOPS = [101, 102, 103]  # (c), (e): the walks' per-hop seeds


def profile_world(dev):
    """Phase 17's full-width world: phase 1's graph from the seed,
    features from ``SEED + 17``, the int8 offload store a quarter hot by
    degree (phase 6's configuration) and phase 3's GraphSAGE in a fused
    ``ServeEngine``; the same features int8 on the card whole, and a
    GraphSAGE with dropout 0.5 under Adam (phase 5's) for the train
    pipeline."""
    import torch
    from types import SimpleNamespace
    from quiver_tpu_torch import CSRTopo, Feature, GraphSAGE, ServeEngine
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.parallel import init_state
    gen = torch.Generator(device=dev).manual_seed(SEED)
    indptr, indices, deg = make_graph(dev, gen, NODES)
    fgen = torch.Generator(device=dev).manual_seed(SEED + 17)
    feat = torch.randn(NODES, DIM, generator=fgen, device=dev)
    featq = quant.quantize(feat, "int8")
    topo = CSRTopo(indptr=indptr, indices=indices, device=dev)
    store = Feature(
        device_cache_size=(NODES // 4) * quant.row_bytes(DIM, "int8"),
        csr_topo=topo, dedup_cold=True, dtype_policy="int8",
        host_placement="offload", device=dev).from_cpu_tensor(feat.cpu())
    del feat
    model, params = sage(dev)
    eng = ServeEngine(model, params, topo, store, [SIZES], BATCH,
                      fused_hot_hop=True, fused_row_cap=ROW_CAP, seed=SEED,
                      device=dev).warmup()
    torch.manual_seed(SEED + 17)
    train_model = GraphSAGE(DIM, HIDDEN, CLASSES, len(SIZES),
                            dropout=DROPOUT).to(dev)
    seeds = torch.randperm(NODES, generator=fgen, device=dev)[:BATCH] \
        .to(torch.int32)
    labels = torch.randint(0, CLASSES, (BATCH,), generator=fgen, device=dev)
    fx = SimpleNamespace(
        indptr=indptr, indices=indices, feat=featq, forder=None,
        seeds=seeds, labels=labels, sizes=SIZES, row_cap=ROW_CAP,
        hop_seeds=PROFILE_HOPS,
        state=init_state(train_model, torch.optim.Adam(
            train_model.parameters(), lr=LR)))
    return eng, store, fx


def registry_pass(dev, card):
    """(b): every registry entry on the card, twice; one line per spec
    (findings by rule, host synchronisations by the recorder and the
    card, launches by kernel). Returns the record and the first pass's
    launches by kernel."""
    from quiver_tpu_torch.analysis import registry
    from quiver_tpu_torch.ops.kernels import _build
    libs = _build.loaded_libraries._cache_size()
    specs = []
    t0 = time.perf_counter()
    findings, ran = registry.run_registry(device=dev, specs_out=specs)
    first_s = time.perf_counter() - t0
    check(len(ran) == 9, f"the registry ran {ran}")
    errors = [str(f) for f in findings if f.level == "ERROR"]
    check(not errors, "registry ERROR findings on the card: "
          + "; ".join(errors)[:800])
    by_spec, launches = {}, {}
    for spec in specs:
        rec = spec.recording()
        rules: dict = {}
        for f in findings:
            if f.entry == spec.name:
                key = f"{f.rule} {f.level}"
                rules[key] = rules.get(key, 0) + 1
        check(spec.card_syncs == len(rec.syncs) == spec.host_syncs,
              f"{spec.name}: the card counts {spec.card_syncs} host "
              f"synchronisations, the recorder {len(rec.syncs)}, the "
              f"entry declares {spec.host_syncs}")
        for k, v in rec.launches.items():
            launches[k] = launches.get(k, 0) + v
        by_spec[spec.name] = {"findings": rules, "syncs": len(rec.syncs),
                              "card_syncs": spec.card_syncs,
                              "launches": dict(rec.launches)}
        rules_s = ", ".join(f"{k} x{v}" for k, v in sorted(rules.items()))
        made_s = ", ".join(f"{k} {v}" for k, v in rec.launches.items())
        print(f"profile (b): {spec.name}: findings {rules_s or 'none'}; "
              f"host syncs: recorder {len(rec.syncs)}, card "
              f"{spec.card_syncs} (declared {spec.host_syncs}); launches "
              f"{made_s or 'none'}", flush=True)
    for entry, want in (("train_step", ("fused_sample_hop", "fused_hot_hop")),
                        ("serve_step", ("fused_sample_hop", "fused_hot_hop")),
                        ("fused_multihop",
                         ("fused_sample_hop", "fused_hot_hop")),
                        ("fused_hot_hop", ("fused_hot_hop",)),
                        ("lookup_tiered", ("gather_rows",)),
                        ("dist_lookup", ("gather_rows",))):
        for name, r in by_spec.items():
            if name.split("[")[0] == entry:
                check(all(r["launches"].get(k, 0) > 0 for k in want),
                      f"{name} launched {r['launches']}, expected {want}")
    libs_first = _build.loaded_libraries._cache_size()
    t0 = time.perf_counter()
    again, _ = registry.run_registry(device=dev)
    second_s = time.perf_counter() - t0
    libs_second = _build.loaded_libraries._cache_size()
    check(libs_second == libs_first and not [
        f for f in again if f.level == "ERROR"],
          f"the second registry pass loaded {libs_second - libs_first} "
          "kernel libraries or found errors")
    print(f"profile (b): {len(specs)} specs of {len(ran)} entries on "
          f"{card}: 0 ERROR; {sum(f.level == 'INFO' for f in findings)} "
          f"INFO; kernel libraries {libs} before, {libs_first} after the "
          f"first pass, {libs_second} after the second; passes "
          f"{first_s:.2f} s and {second_s:.2f} s; launches in the first "
          f"pass: {nonzero(launches)}", flush=True)
    return {"specs": by_spec, "libraries": [libs, libs_first, libs_second],
            "seconds": [first_s, second_s]}, launches


def stage_profile(dev, card, eng, fx, probe):
    """(c): the full-width stage profile: the served batch (one group)
    and the train pipeline's five stages, best and mean of PROFILE_REPS
    CUDA-event timings each, modeled bytes and FLOPs, shares of the
    probe's peak; the leaf hop held to ``hot_hop_cost`` and set against
    phase 2's 3.35 TB/s bound; the records fed to a ``TelemetryHub``."""
    from quiver_tpu_torch import TelemetryHub
    from quiver_tpu_torch.analysis.costmodel import cost_of_fn
    from quiver_tpu_torch.profile import (ProfileGroup, ProfileStage,
                                          StageProfiler, render_records)
    hub = TelemetryHub()
    prof = StageProfiler(reps=PROFILE_REPS, probe=probe, hub=hub)
    served = fx.seeds[:BATCH]

    def serve(seeds):
        return eng.run(seeds, hop_seeds=PROFILE_HOPS)
    prof.add_group(ProfileGroup("served_batch", [ProfileStage(
        "serve", serve, (served,), cost=cost_of_fn(serve, (served,)))]))
    prof.add_pipeline(fixture=fx)
    records = prof.run()
    for line in render_records(records).splitlines():
        print(f"profile (c): {line}", flush=True)
    pipe = prof.groups[-1]
    hop = pipe.stages[3]
    out = hop.fn(*hop.args)
    want, ops = hot_hop_cost(hop.args[2], SIZES[-1], out[1], out[0],
                             hop.args[3], None, fx.feat.data.shape[0])
    check(hop.cost.total_bytes == want and hop.cost.flops == ops,
          f"the fused_hop stage models {hop.cost.total_bytes} bytes, "
          f"hot_hop_cost {want}")
    rows = {}
    for rec in records[1:]:
        for st in rec["stages"]:
            m = st["modeled"]
            b_ms, b_by = bound(m["total_bytes"], m["flops"])
            rows[f"{rec['entry']}/{st['stage']}"] = dict(
                st, bound_ms=b_ms, bound_by=b_by,
                bound_share=b_ms / st["best_ms"])
            print(f"profile (c): {rec['entry']}/{st['stage']}: best "
                  f"{st['best_ms']:.4f} ms, mean {st['mean_ms']:.4f} ms "
                  f"(CUDA events, {PROFILE_REPS} calls); modeled "
                  f"{m['total_bytes']} bytes, {m['flops']} FLOPs; "
                  f"{st.get('achieved_gbps', 0):.1f} GB/s = "
                  f"{100 * st.get('efficiency', 0):.1f}% of the probe's "
                  f"{st.get('peak')}; share {st['share']}; 3.35 TB/s "
                  f"bound {b_ms:.4f} ms by {b_by} = "
                  f"{100 * b_ms / st['best_ms']:.1f}% of best; on {card}",
                  flush=True)
    leaf = rows["train_pipeline/fused_hop"]
    print(f"profile (c): leaf hop: modeled {want} bytes = hot_hop_cost on "
          f"the same input; best {leaf['best_ms']:.4f} ms against the "
          f"{leaf['bound_ms']:.4f} ms bound of phase 2's 3.35 TB/s: "
          f"{100 * leaf['bound_share']:.1f}%", flush=True)
    armed = sorted(n for n in hub._detectors if n.startswith("stage_share:"))
    check(len(armed) == sum(len(g.stages) for g in prof.groups),
          f"the hub's stage_share:* watch armed {armed}")
    print(f"profile (c): TelemetryHub: the default stage_share:* watch "
          f"armed on {len(armed)} series ({', '.join(armed)}); "
          f"{len(hub.anomalies)} anomalies after one pass", flush=True)
    return {"stages": rows, "armed": armed}


def chrome_trace(eng, fx, card):
    """(e): ``profiling.trace`` around two served batches: the Chrome
    trace's event count, the scope and the kernels' device events."""
    from quiver_tpu_torch import profiling
    tmp = tempfile.mkdtemp(prefix="qt_trace_")
    try:
        with profiling.trace(tmp, "served.json"):
            for i in range(2):
                with profiling.scope("qt.served_batch"):
                    eng.run(fx.seeds[:BATCH].roll(i), hop_seeds=PROFILE_HOPS)
        with open(os.path.join(tmp, "served.json")) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    names = [str(e.get("name", "")) for e in events]
    counts = {k: sum(k in n for n in names) for k in (
        "qt.served_batch", "fused_sample_hop_kernel", "fused_hot_hop_kernel",
        "gather_rows")}
    # the cold fixup's host-tier reads: any of gather.cu's row kernels
    counts["gather_rows"] = sum("gather_rows" in n and "_kernel" in n
                                for n in names)
    print(f"profile (e): Chrome trace of 2 served batches: {len(events)} "
          f"events; {counts}; on {card}", flush=True)
    check(all(counts.values()), f"the Chrome trace lacks {counts}")
    return {"events": len(events), "counts": counts}


def phase_profile(dev, card, h2d):
    """Phase 17: the machine probe (a), the registry's entry points on
    the card (b), the full-width stage profile (c), the host lint over
    the port (d) and a Chrome trace of two served batches (e). ``h2d``
    is phase 6's pinned-to-device copy rate in bytes/s."""
    import torch
    from quiver_tpu_torch.analysis import host_lint
    from quiver_tpu_torch.profile import machine_probe
    secs, rec = {}, {}
    t_all = time.perf_counter()

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        return out
    probe = part("(a)", machine_probe, False, 3, None, dev)
    rec["probe"] = probe
    print(f"profile (a): machine probe on {card} "
          f"({probe['device']}, power limit {probe['power_limit']}): memcpy "
          f"{probe['memcpy_gbps']} GB/s, random gather {probe['gather_gbps']} "
          f"GB/s, h2d {probe['h2d_gbps']} GB/s (phase 6's h2d_rate "
          f"{h2d / 1e9:.3f} GB/s), d2h {probe['d2h_gbps']} GB/s "
          f"({probe['size_mb']} MB, best of 3, CUDA events)", flush=True)
    rec["registry"], launches = part("(b)", registry_pass, dev, card)
    eng, store, fx = part("world", profile_world, dev)
    rec["stages"] = part("(c)", stage_profile, dev, card, eng, fx, probe)
    t0 = time.perf_counter()
    lint = host_lint.run_host_lint(root=os.path.dirname(
        os.path.abspath(__file__)))
    secs["(d)"] = time.perf_counter() - t0
    by_rule: dict = {}
    for f in lint:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    bad = [str(f) for f in lint if host_lint.documented(f) is None]
    check(not bad, "host lint: " + "; ".join(bad)[:600])
    print(f"profile (d): host lint over quiver_tpu_torch/: {len(lint)} "
          f"findings {by_rule or ''}, all documented deviations "
          f"({len(host_lint.DOCUMENTED)} listed)", flush=True)
    rec["host_lint"] = by_rule
    rec["trace"] = part("(e)", chrome_trace, eng, fx, card)
    store.close()
    del eng, store, fx
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_all
    print(f"phase 17: {total:.2f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in secs.items()), flush=True)
    rec["seconds"] = dict(secs, total=total)
    return rec, launches


LEAK_CYCLES = 16               # each leak phase's steady loop (JAX: 50)
LEAK_REQUESTS = 200            # phases 6 and 7's waves
LEAK_BURSTS = 8                # phase 12's bursts of 24 (JAX: 20)
LEAK_LOOKUP = 65536            # ids a lookup batch; the dedup budget an 8th
LEAK_DIST_BATCH = 4096         # ids each of phase 4's ranks looks up


def phase_leak(dev, card):
    """Phase 18: ``quiver_tpu_torch.check_leak``'s 16 phases in-process
    on the card at full width (phase 1's graph, phase 5's data,
    GraphSAGE 100 -> 256 -> 256 -> 47, [15, 10, 5] at batch 1024, phase
    12's ladder over the int8 store a quarter hot), only the cycle
    counts cut. A reading that grows raises ``SmokeFailure``. Returns
    the record (each leak phase's readings, launches per cycle and
    seconds) and the launches of the whole run, counted from 0."""
    import torch
    from quiver_tpu_torch import check_leak
    from quiver_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    indptr, indices, _ = make_graph(dev, gen, NODES)    # phase 1's graph
    feat, labels = make_train_data(dev, gen, NODES)
    w = check_leak.World(
        device=dev, indptr=indptr, indices=indices, feat=feat.cpu(),
        labels=labels, sizes=SIZES, batch=BATCH, hidden=HIDDEN,
        classes=CLASSES, variants=SERVER_LADDER, serve_cap=BATCH,
        lookup=LEAK_LOOKUP, cold_budget=LEAK_LOOKUP // 8,
        dist_batch=LEAK_DIST_BATCH, cycles=LEAK_CYCLES,
        requests=LEAK_REQUESTS, bursts=LEAK_BURSTS, seed=SEED,
        row_cap=ROW_CAP, card=card)
    del feat
    world_s = time.perf_counter() - t0
    print(f"leak: full width: {NODES} nodes, {indices.numel()} edges, "
          f"features {DIM} wide, GraphSAGE {DIM} -> {HIDDEN} -> {HIDDEN} -> "
          f"{CLASSES}, fanout {SIZES} at batch {BATCH}, ladder "
          f"{SERVER_LADDER}; {LEAK_CYCLES} cycles a loop, lookups of "
          f"{LEAK_LOOKUP} ids; made in {world_s:.2f} s; on {card}",
          flush=True)
    kernels.reset_launches()
    try:
        recs = check_leak.run(w, log=lambda line: print(line, flush=True))
    except check_leak.LeakError as e:
        raise SmokeFailure(f"phase 18: {e}") from None
    launches = dict(kernels.LAUNCHES)
    for name in ("fused_sample_hop", "fused_hot_hop", "sample_layer",
                 "gather_rows"):
        check(launches[name] > 0, f"phase 18: {name} never launched")
    secs = {r["phase"]: r["seconds"] for r in recs}
    total = time.perf_counter() - t0
    print(f"phase 18: {total:.2f} s: world {world_s:.2f} s, " + ", ".join(
        f"({n}) {v:.2f} s" for n, v in secs.items()) + f"; launches "
        f"{launches}; on {card}", flush=True)
    per_cycle: dict = {}
    for r in recs:
        for unit, counts in r["launches_per_cycle"].items():
            for name, v in counts.items():
                per_cycle.setdefault(name, {})[f"{r['phase']} {unit}"] = v
    rec = {"seconds": dict(secs, world=world_s, total=total),
           "cycles": LEAK_CYCLES, "launches": launches,
           "launches_per_cycle": per_cycle,
           "phases": {r["phase"]: {k: v for k, v in r.items()
                                   if k not in ("phase", "ranks")}
                      for r in recs}}
    return rec, launches


def breakdown(eng, requests, x, layers):
    """Where a served batch spends its time: the walk and the model
    timed apart with CUDA events, then a ``torch.profiler`` trace of
    four batches for the device's busy share and its top kernels."""
    import torch
    from quiver_tpu_torch.ops.kernels import fused
    from quiver_tpu_torch.parallel import layers_to_adjs
    seeds = eng.pad_seeds(requests[0])
    hs = [1, 2, 3]
    walk_ms = cuda_ms(lambda: fused.fused_multihop(
        eng._indptr, eng._indices, seeds, eng._feat, SIZES, hs, ROW_CAP), 10)
    adjs = layers_to_adjs(layers, BATCH, SIZES)
    with torch.inference_mode():
        model_ms = cuda_ms(lambda: eng.model(x, adjs), 10)
    print(f"breakdown: walk {walk_ms:.3f} ms, model {model_ms:.3f} ms "
          "(CUDA events, one batch each)", flush=True)

    device_profile(lambda: [eng.run(ids) for ids in requests[:4]], 4,
                   "batch")


def device_profile(run, units: int, unit: str, top: int = 12, stats=None):
    """``torch.profiler`` over one call of ``run`` (``units`` batches or
    steps): wall time, the device's busy time (the union of its kernel
    intervals) and idle share, and the top kernels per unit. Returns
    the busy ms per unit, None when the profiler saw no device time;
    ``stats`` (a dict) also gets the idle share and the device kernels
    per unit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profile: torch.profiler saw no device time: device busy "
              f"per {unit} not measured", flush=True)
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0, None
    for a, b in spans:                   # union of kernel intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"profile: {units} x {unit}, wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms = {busy / units / 1e3:.3f} ms per "
          f"{unit}, idle share {1 - busy / wall_us:.3f}, "
          f"{len(kernels) / units:g} device kernels per {unit}", flush=True)
    if stats is not None:
        stats.update(idle_share=1 - busy / wall_us,
                     device_kernels_per_unit=len(kernels) / units)
    for name, (t, n) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:top]:
        print(f"profile: {t / units / 1e3:9.4f} ms/{unit} "
              f"{n // units:5d}x/{unit} {name[:110]}", flush=True)
    return busy / units / 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # full fp32 for the model's products: no TF32 in matmul or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from quiver_tpu_torch.ops import kernels, quant
    from quiver_tpu_torch.ops.kernels import _build

    t_main = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    kernels.build_kernels()
    build_s = time.perf_counter() - t0
    for name, log in _build.build_logs.items():
        print(f"nvcc {name}.cu: {_build.build_seconds[name]:.2f} s",
              flush=True)
        for kname, regs, stack, st, ld in ptxas_kernels(log):
            print(f"nvcc {name}: {kname[:72]}: {regs} registers, {stack} "
                  f"bytes stack frame, {st} bytes spill stores, {ld} bytes "
                  "spill loads", flush=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    indptr, indices, deg = make_graph(dev, gen, NODES)
    feat = torch.randn(NODES, DIM, generator=gen, device=dev)
    featq = quant.quantize(feat, "int8")
    forder = torch.randperm(NODES, generator=gen, device=dev) \
        .to(torch.int32)
    torch.cuda.synchronize()
    print(f"setup: kernel build {build_s:.2f} s, graph {NODES} nodes "
          f"{indices.numel()} edges (max degree {int(deg.max())}), "
          f"features {tuple(feat.shape)} made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    kern = phase_kernels(dev, gen, NODES, indptr, indices, deg,
                         {"int8": featq, "fp32": feat}, forder, iters=20)
    del forder
    eng, requests, served, lat, launches = phase_slice(
        dev, gen, NODES, indptr, indices, featq, BATCHES)
    lat_sorted = sorted(lat)
    p50 = lat_sorted[len(lat) // 2]
    p99 = lat_sorted[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
    print(f"slice: {len(lat)} batches of {BATCH}, per-batch latency p50 "
          f"{p50:.3f} ms p99 {p99:.3f} ms on {card}", flush=True)
    kern["gather_rows"], split_launches = phase_split(
        eng, requests, served, feat, iters=20)
    launches.update(split_launches)
    del eng, requests, served, feat, featq
    train_launches = phase_train(dev, gen, NODES, indptr, indices, card)
    host_tier, tiered_launches, tiered_ctx = phase_tiered(
        dev, gen, NODES, indptr, indices, card, BATCHES, iters=20)
    arms, topo_gathers, host_launches, h2d, topo, batches = phase_sampler(
        dev, gen, NODES, indptr, indices, card)
    weighted, weight_gathers_rec, weighted_host_l = phase_weighted(
        dev, gen, NODES, indptr, indices, deg, topo, batches, h2d, card)
    metered, rotation, shard = phase_metered(
        dev, gen, NODES, indptr, indices, card, tiered_ctx, topo, batches,
        h2d)
    host_side = phase_host_side(dev, gen, NODES, indptr, indices, deg, card,
                                topo, batches, arms)
    buffered = host_side["pipeline"]["buffered"]["launches_per_step"]
    disk = phase_disk(dev, gen, NODES, indptr, indices, deg, card, topo,
                      host_tier["h2d_bytes_per_s"], refs={
                          "tiered_p50_ms": host_tier["batch_p50_ms"],
                          "serial_p50_ms":
                              host_side["pipeline"]["serial"]["p50_ms"]})
    server, server_launches, server_batches = phase_server(
        dev, NODES, card, tiered_ctx,
        tiered_launches["gather_rows"] // BATCHES, host_tier["batch_p50_ms"])
    del tiered_ctx, topo, batches, indptr, indices, deg
    torch.cuda.empty_cache()
    hetero, hetero_launches = phase_hetero(dev, card)
    torch.cuda.empty_cache()
    sharded, sharded_launches, shard_train_launches = phase_sharded(dev,
                                                                    card)
    torch.cuda.empty_cache()
    clique, clique_kernel, clique_launches, clique_train_l = phase_clique(
        dev, card)
    # the clique kernel's main path is phase 15 (a): the int8 store's
    # fused route; its numbers are the fp32 store's lookup at a served
    # frontier
    # phase 2's device gather rate: the bytes of gather_rows' bound over
    # its own time
    g = kern["gather_rows"]
    gather_gbps = g["bound_ms"] * HBM_BYTES_PER_S / g["own_ms"] / 1e9
    torch.cuda.empty_cache()
    fleet_rec, fleet_launches, fleet_batches = phase_fleet(dev, card,
                                                           gather_gbps)
    torch.cuda.empty_cache()
    prof_rec, registry_launches = phase_profile(
        dev, card, host_tier["h2d_bytes_per_s"])
    torch.cuda.empty_cache()
    leak_rec, leak_launches = phase_leak(dev, card)
    clique_served = clique_launches[("int8 half", "fused")]
    launches["gather_rows_sharded"] = clique_served["gather_rows_sharded"]
    k = clique_kernel["fp32 lookup"]
    kern["gather_rows_sharded"] = {
        "err": 0.0, **{x: k[x] for x in ("ms", "own_ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}}

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": kern[name]["err"], "ms": kern[name]["ms"],
         "own_ms": kern[name]["own_ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name].get("bound_by", "bytes"),
         "library_ms": kern[name].get("library_ms"),
         "launches_per_train_step": train_launches[name] / TRAIN_STEPS,
         "launches_per_tiered_batch": tiered_launches[name] / BATCHES,
         "launches_per_buffered_step": buffered.get(name, 0),
         "launches_per_server_batch": server_launches[name] / server_batches,
         "launches_per_hetero_step": hetero_launches[name] / MAG_STEPS,
         "launches_per_sharded_batch":
             sharded_launches[name] / SHARD_BATCHES,
         "launches_per_dist_step":
             shard_train_launches["dist"][name] / SHARD_STEPS,
         "launches_per_e2e_step":
             shard_train_launches["e2e fused"][name] / SHARD_STEPS,
         "launches_per_clique_batch":
             clique_served[name] / CLIQUE_BATCHES,
         "launches_per_clique_step": clique_train_l[name] / CLIQUE_STEPS,
         "launches_per_fleet_batch":
             fleet_launches.get(name, 0) / fleet_batches,
         "launches_registry_pass": registry_launches.get(name, 0),
         "launches_leak_check": leak_launches[name],
         "launches_per_leak_cycle": leak_rec["launches_per_cycle"].get(
             name, {})}
        for name in SOURCES]}
    line["kernels"][list(SOURCES).index("gather_rows_sharded")].update(
        kernel=k["kernel"], variants=clique_kernel,
        shard_tensor=clique["shard_tensor"],
        shard_tensor_phase9={
            k: {x: v[x] for x in ("own_ms", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "kernel")}
            for k, v in shard.items()})
    gather_entry = line["kernels"][list(SOURCES).index("gather_rows")]
    gather_entry["kernel"] = kern["gather_rows"]["kernel"]
    gather_entry["host_tier"] = {
        "launches": tiered_launches["gather_rows"],
        "max_abs_err": host_tier["err"], "ms": host_tier["ms"],
        "own_ms": host_tier["own_ms"], "plain_ms": host_tier["plain_ms"],
        "bound_ms": host_tier["bound_ms"],
        "bound_by": host_tier["bound_by"], "library_ms": None,
        "h2d_bytes_per_s": host_tier["h2d_bytes_per_s"],
        "served_launch_own_ms": host_tier["served_launch_own_ms"],
        "fp32": host_tier["fp32"]}
    elems = topo_gathers["elems"]["host"]
    gather_entry["host_topology"] = {
        "name": "gather_elems + gather_rows (int32 rows views)",
        "route": "cuda", "source": SOURCES["gather_rows"],
        "replaces": REPLACES["gather_rows"], "launches": host_launches,
        "launches_per_host_batch": {
            arm["arm"]: {k: v / SAMPLER_BATCHES for k, v in
                         arm["launches"].items() if v}
            for arm in arms.values() if arm["mode"] == "HOST"},
        "max_abs_err": 0.0, "ms": elems["ms"], "own_ms": elems["own_ms"],
        "plain_ms": elems["plain_ms"], "bound_ms": elems["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "h2d_bytes_per_s": h2d,
        "variants": topo_gathers}
    # the raw-row designs where the main paths launch them: the HOST
    # sampler's pinned rows views, and the exchange's owner read
    rows128 = topo_gathers["rows128"]["host"]
    host_raw: dict = {}
    for arm in arms.values():
        for k, v in arm.get("raw_launches", {}).items():
            host_raw[k] = host_raw.get(k, 0) + v
    owner = sharded["a"]["gathers"]["owner read"]
    gather_entry["raw_designs"] = {
        rows128["kernel"]: {
            "name": f"{rows128['kernel']}: the HOST sampler's pinned int32 "
                    "rows views (phase 7, rows128 at a last-hop frontier)",
            "route": "cuda", "source": SOURCES["gather_rows"],
            "replaces": REPLACES["gather_rows"],
            "launches": host_raw.get(rows128["kernel"], 0),
            "launches_per_host_batch": {
                arm["arm"]: {k: v / SAMPLER_BATCHES for k, v in
                             arm.get("raw_launches", {}).items()}
                for arm in arms.values() if arm["mode"] == "HOST"},
            **{k: rows128[k] for k in ("max_abs_err", "ms", "own_ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")}},
        owner["kernel"]: {
            "name": f"{owner['kernel']}: the exchange's owner read (raw "
                    "128-byte rows on the card, phase 14 (a))",
            "route": "cuda", "source": SOURCES["gather_rows"],
            "replaces": REPLACES["gather_rows"],
            "launches": sharded["a"]["raw_launches"].get(owner["kernel"], 0),
            "launches_per_sharded_batch": sharded["a"]["raw_launches"].get(
                owner["kernel"], 0) / SHARD_BATCHES,
            **{k: owner[k] for k in ("max_abs_err", "ms", "own_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}}
    elems_w = weight_gathers_rec["elems"]
    gather_entry["host_weights"] = {
        "name": "gather_elems + gather_rows (pinned fp32 edge weights and "
                "weight rows)",
        "route": "cuda", "source": SOURCES["gather_rows"],
        "replaces": REPLACES["gather_rows"],
        "launches": sum(v * WEIGHTED_BATCHES for x in weighted_host_l.values()
                        for v in x.values()),
        "launches_per_host_batch": weighted_host_l,
        "max_abs_err": 0.0, "ms": elems_w["ms"], "own_ms": elems_w["own_ms"],
        "plain_ms": elems_w["plain_ms"], "bound_ms": elems_w["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "h2d_bytes_per_s": h2d,
        "variants": weight_gathers_rec}
    # the span gather: the HOST arms' indptr heads (phase 7, 8) and the
    # weighted pool's weights (phase 8 (k)); its numbers are the heads'
    # over the pinned int32 indptr at a last-hop frontier
    span_l = {arm["arm"]: arm["elems_launches"].get(
        "gather_segments_kernel", 0) for arm in
        [*arms.values(), *weighted["arms"]] if arm["mode"] == "HOST"}
    heads = topo_gathers["heads"]
    line["kernels"].append({
        "name": "gather_segments", "route": "cuda",
        "source": SOURCES["gather_rows"], "replaces": REPLACES["gather_rows"],
        "launches": sum(span_l.values()),
        "launches_per_host_batch": {
            a: v / (SAMPLER_BATCHES if a in "gh" else WEIGHTED_BATCHES)
            for a, v in span_l.items()},
        "mixed_host_launches": host_side["mixed"]["HOST"][
            "elems_launches"].get("gather_segments_kernel", 0),
        **{k: heads["int32"][k] for k in (
            "max_abs_err", "ms", "own_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "kernel": "gather_segments_kernel", "h2d_bytes_per_s": h2d,
        "launches_per_fleet_batch":
            fleet_launches.get("gather_elems", 0) / fleet_batches,
        "launches_leak_check": leak_launches["gather_elems"],
        "launches_per_leak_cycle": leak_rec["launches_per_cycle"].get(
            "gather_elems", {}),
        "variants": {"heads int32": heads["int32"],
                     "heads int64": heads["int64"],
                     "weights pool": weight_gathers_rec["span"]}})
    line["sampler"] = [{k: v for k, v in arm.items()} for arm in
                       arms.values()]
    line["weighted"] = weighted
    line["metrics"] = metered
    line["rotation"] = rotation
    line["shard_tensor"] = shard
    line["host_side"] = host_side
    gather_entry["mixed_host_launches"] = {
        "device_mode": "HOST", "batches": MIXED_BATCHES,
        "device_batches": host_side["mixed"]["HOST"]["tasks"]["device"],
        **{k: v for k, v in host_side["mixed"]["HOST"]["launches"].items()
           if v}}
    line["disk_tier"] = disk
    line["server"] = server
    ring = {}
    for name, arm in disk["products"]["arms"].items():
        if "ring" in arm:
            ring[name.replace("on ", "")] = dict(
                arm["ring"], launches_per_disk_step=arm[
                    "gather_rows_per_step"])
    packed = disk["products"]["arms"]["on packed"]
    gather_entry["disk_ring"] = {
        "name": "gather_rows over the disk tier's staging ring (pinned)",
        "route": "cuda", "source": SOURCES["gather_rows"],
        "replaces": REPLACES["gather_rows"],
        "launches": sum(v["gather_rows"] for v in
                        disk["products"]["launches"].values()),
        "launches_per_disk_step": packed["gather_rows_per_step"],
        **{k: packed["ring"][k] for k in (
            "max_abs_err", "ms", "own_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "h2d_bytes_per_s": host_tier["h2d_bytes_per_s"], "layouts": ring}
    step_gather = hetero["gather"]["int8 step"]
    gather_entry["hetero"] = {
        "name": "gather_rows_packed_kernel over the paper store's pinned "
                "int8 tier at D=768 (896-byte rows), one launch a hetero "
                "step",
        "route": "cuda", "source": SOURCES["gather_rows"],
        "replaces": REPLACES["gather_rows"],
        "launches": hetero_launches["gather_rows"],
        "launches_per_hetero_step": hetero_launches["gather_rows"] / MAG_STEPS,
        **{k: step_gather[k] for k in (
            "max_abs_err", "ms", "own_ms", "burst_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")},
        "h2d_bytes_per_s": hetero["gather"]["h2d_bytes_per_s"],
        "variants": {k: v for k, v in hetero["gather"].items()
                     if isinstance(v, dict)}}
    line["hetero"] = hetero
    exch = sharded["a"]["gathers"]
    gather_entry["exchange"] = {
        "name": "gather_rows in the all_to_all exchange: the owner's read "
                f"of its packed int8 shard (raw 128-byte rows, "
                f"{exch['owner read']['kernel']}) and the unbucket of the "
                "received "
                "block with the int8 decode (gather_rows_packed_hbm_kernel"
                "), "
                "phase 14 (a) at world size 1",
        "route": "cuda", "source": SOURCES["gather_rows"],
        "replaces": REPLACES["gather_rows"],
        "launches": sharded_launches["gather_rows"],
        "launches_per_sharded_batch":
            sharded_launches["gather_rows"] / SHARD_BATCHES,
        "launches_per_dist_step":
            shard_train_launches["dist"]["gather_rows"] / SHARD_STEPS,
        **{k: exch["owner read"][k] for k in (
            "max_abs_err", "ms", "own_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "variants": exch}
    # the HBM design of the packed int8 gather, where the main paths run it:
    # the exchange's unbucket (phase 14 (a)) and the clique's int8 hot tier
    # (phase 15 (a), (b))
    unb = exch["unbucket+decode"]
    dist_packed = sharded["a"]["train"]["dist"]["packed_launches"]
    gather_entry["packed_hbm"] = {
        "name": "gather_rows_packed_hbm_kernel: packed int8 rows in device "
                "memory, the exchange's unbucket + decode",
        "route": "cuda", "source": SOURCES["gather_rows"],
        "replaces": REPLACES["gather_rows"],
        "launches": sharded["a"]["packed_launches"][
            "gather_rows_packed_hbm_kernel"],
        "launches_per_sharded_batch": sharded["a"]["packed_launches"][
            "gather_rows_packed_hbm_kernel"] / SHARD_BATCHES,
        "launches_per_dist_step":
            dist_packed["gather_rows_packed_hbm_kernel"] / SHARD_STEPS,
        **{k: unb[k] for k in ("max_abs_err", "ms", "own_ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")}}
    k8 = clique_kernel["int8 lookup"]
    hbm_served = clique["serving"]["int8 half fused"]["packed_launches"]
    hbm_steps = clique["training"]["packed_launches"]
    line["kernels"][list(SOURCES).index("gather_rows_sharded")][
        "packed_hbm"] = {
        "name": "gather_rows_sharded_packed_hbm_kernel: the clique's int8 "
                "hot tier, every block on the card (lookup form; the out= "
                "form under out_form)",
        "route": "cuda", "source": SOURCES["gather_rows_sharded"],
        "replaces": REPLACES["gather_rows_sharded"],
        "launches": hbm_served["gather_rows_sharded_packed_hbm_kernel"],
        "launches_per_clique_batch":
            hbm_served["gather_rows_sharded_packed_hbm_kernel"]
            / CLIQUE_BATCHES,
        "launches_per_clique_step":
            hbm_steps["gather_rows_sharded_packed_hbm_kernel"] / CLIQUE_STEPS,
        **{k: k8[k] for k in ("max_abs_err", "ms", "own_ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms")},
        "out_form": {k: clique_kernel["int8 out="][k] for k in (
            "own_ms", "ms", "plain_ms", "bound_ms")}}
    line["sharded"] = sharded
    line["clique"] = clique
    line["fleet"] = fleet_rec
    line["profile"] = prof_rec
    line["leak"] = leak_rec
    # gather_rows_q8_kernel (int8 rows with separate sidecar arrays):
    # its launches over the whole run, against those of phase 6's check
    q8_all = _build.KERNEL_TOTALS.get("gather_rows_q8_kernel", 0) \
        - host_tier["q8_timing_launches"]
    gather_entry["q8"] = {
        "name": "gather_rows_q8_kernel: int8 rows with fp32 scale and zero "
                "apart, phase 6's check 5 (its first call there)",
        "route": "cuda", "source": SOURCES["gather_rows"],
        "replaces": REPLACES["gather_rows"], "kernel": "gather_rows_q8_kernel",
        "launches": host_tier["q8_launches_check5"],
        "launches_whole_run": q8_all,
        "launches_phase6_check5": host_tier["q8_launches_check5"],
        **{k: host_tier["q8"][0][k] for k in (
            "max_abs_err", "ms", "own_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "calls": host_tier["q8"]}
    print(f"gather_rows_q8_kernel: {q8_all} launches in the whole run, "
          f"{host_tier['q8_launches_check5']} of them in phase 6's check 5 "
          "(the split route over the store and dedup_gather over the int8 "
          f"one-table), besides {host_tier['q8_timing_launches']} to time "
          f"it; on {card}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s in all",
          flush=True)
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--replica"]:
        sys.exit(replica_main(sys.argv[2:]))
    sys.exit(main())
