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
   the store's lookup free of host synchronisation
   (``torch.cuda.set_sync_debug_mode("error")``); and finite logits from
   the split route over the store and from ``dedup_gather=True`` over a
   plain table;
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
   gathers; (b), (d), (f), (g) and (h) sample four more batches under
   ``torch.cuda.set_sync_debug_mode("error")``; each arm's device time
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
   pool, pinned fp32 rows 128 and 256 wide) against their plain
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
12. a JSON line of the four kernels (``ms`` the wrapper's time, ``own_ms``
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
   ``disk_ring``; the arms' records under ``sampler``, phase
   8's under ``weighted``, phase 9's under ``metrics``, ``rotation`` and
   ``shard_tensor``, phase 10's under ``host_side``, phase 11's under
   ``disk_tier``), then the last line ``{"ok": true, "device":
   {...}}``.

Any failure exits non-zero without that last line; with no CUDA device
the script exits 2 at once. TF32 is switched off for matrix products and
cuDNN, so the model runs in full fp32.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

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
           "gather_rows": CSRC + "gather.cu"}
REPLACES = {"fused_sample_hop": "quiver_tpu/ops/pallas/fused.py:513",
            "fused_hot_hop": "quiver_tpu/ops/pallas/fused.py:411",
            "sample_layer": "quiver_tpu/ops/pallas/sample_kernel.py:174",
            "gather_rows": "quiver_tpu/ops/pallas/gather.py:92"}
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
        if len(durs) >= iters:
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


def sample_hop_bytes(seeds, k, counts) -> int:
    """Least bytes: the seeds, each valid seed's indptr pair, each pick's
    index entry, and the outputs."""
    bs = seeds.shape[0]
    valid = int((seeds >= 0).sum())
    return 4 * bs + 8 * valid + 4 * int(counts.long().sum()) \
        + 4 * bs * k + 4 * bs


def hot_hop_cost(seeds, k, counts, nbrs, feat, forder, hot_rows):
    """(bytes, fp32 ops) the leaf hop needs on this run's data: the
    sampling bytes, each distinct hot storage row once (codes and
    sidecars), the order entries of the distinct ids, and the fp32 rows
    written for every seed and pick."""
    import torch
    from quiver_tpu_torch.ops import quant
    ids = torch.cat([seeds, nbrs.reshape(-1)]).long()
    ids = torch.unique(ids[ids >= 0])
    rows = ids
    extra = 0
    if forder is not None:
        rows = forder.long()[ids]
        rows = rows[rows < hot_rows]
        extra = 4 * ids.numel()
    nrows = int(torch.unique(rows).numel())
    dim = quant.tier_dim(feat)
    bs = seeds.shape[0]
    nbytes = sample_hop_bytes(seeds, k, counts) + extra \
        + nrows * quant.row_read_bytes(feat) + 4 * dim * bs * (1 + k)
    ops = 2 * dim * bs * (1 + k) if quant.is_quantized(feat) else 0
    return nbytes, ops


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
    of a host-tier gather: each distinct row's data bytes (codes and
    sidecars, not a packed row's padding) read once at the copy rate
    ``h2d``, or the ids read and the fp32 rows written at 3.35 TB/s,
    whichever is longer. Negative ids read nothing."""
    import torch
    from quiver_tpu_torch.ops import quant
    live = ids[ids >= 0]
    distinct = int(torch.unique(live).numel())
    host_bytes = distinct * quant.row_read_bytes(tab)
    dev_bytes = ids.shape[0] * 4 + live.shape[0] * 4 * quant.tier_dim(tab)
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
                             "gather_elems": 0},
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
                              "gather_elems": 0},
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
        ms = cuda_ms(lambda: gather.gather_rows(table, ids), iters)
        own = own_ms(lambda: gather.gather_rows(table, ids),
                     "gather_rows_kernel", iters)
        plain_ms = cuda_ms(lambda: gather.gather_rows_plain(table, ids), 3)
        lib_ms = cuda_ms(lambda: torch.index_select(table, 0, ids), iters)
        nbytes = ids.shape[0] * (4 + 2 * table.shape[1]
                                 * table.element_size())
        b_ms, _ = bound(nbytes, 0)
        print(f"gather_rows {name} ids={ids.shape[0]} D={table.shape[1]} "
              f"({gather.word_bytes(table, got)}-byte words): wrapper "
              f"{ms:.4f} ms, kernel own {fmt_ms(own)}, plain "
              f"{plain_ms:.4f} ms, index_select "
              f"{lib_ms:.4f} ms, moves {nbytes} B, bound {b_ms:.4f} ms, "
              "exact", flush=True)
        if rec is None:
            rec = {"ms": ms, "own_ms": own, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "library_ms": lib_ms,
                   "err": max_abs(got, want)}
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
    its tensor's largest entry (``index_add_`` and the backward of
    ``x_src[s]`` sum with atomics in another order on each run)."""
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
    loss_k, grads_k = grads_of(copy.deepcopy(model), lambda m: (
        train._fused_loss(m, sizes, BATCH, table, None, indptr, indices,
                          seeds, labels, hop_seeds, dropout_seed,
                          fused={"row_cap": ROW_CAP})))
    loss_p, grads_p = grads_of(copy.deepcopy(model), lambda m: (
        train._model_loss(m, rx, layers_to_adjs(rl, BATCH, sizes), labels,
                          BATCH, dropout_seed)))
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
                       "gather_rows": 0, "gather_elems": 0},
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
    srt = sorted(lat)
    p50 = srt[len(srt) // 2]
    p99 = srt[min(len(srt) - 1, math.ceil(0.99 * len(srt)) - 1)]
    print(f"tiered: {batches} batches of {BATCH}, per-batch latency p50 "
          f"{p50:.3f} ms p99 {p99:.3f} ms on {card}", flush=True)
    print(f"tiered: launches per batch: fused_sample_hop "
          f"{launches['fused_sample_hop'] / batches:g}, fused_hot_hop "
          f"{launches['fused_hot_hop'] / batches:g}, gather_rows (host "
          f"tier) {launches['gather_rows'] / batches:g}, sample_layer 0",
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
    for name, tab, ids_m, kname in (
            ("int8", cold, cold_ids, "gather_rows_packed_kernel"),
            ("fp32", f32, cold_ids % f32_rows, "gather_rows_kernel")):
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
              f"{distinct} D={DIM} ({words}-byte words): wrapper "
              f"{ms:.4f} ms, kernel own {fmt_ms(own)}{share}{rate}, plain "
              f"{plain_ms:.4f} ms, reads {host_bytes} B from the host at the"
              f" measured {h2d / 1e9:.2f} GB/s pinned-to-device copy rate "
              f"({COPY_BYTES} B copy_ in {copy_ms:.4f} ms) and moves "
              f"{dev_bytes} B on the card: bound {b_ms:.4f} ms ({b_by}), "
              "exact", flush=True)
        recs[name] = {"ms": ms, "own_ms": own, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": "bytes",
                      "library_ms": None, "err": 0.0}
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
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        store.lookup_tiered(fix_ids, masked=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.run(requests[0], hop_seeds=hs)
        step_note = "runs without one too"
    except RuntimeError as e:
        step_note = f"synchronises: {str(e).splitlines()[0][:160]}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"tiered check 4: the store's lookup_tiered runs under "
          f"set_sync_debug_mode('error') without a host synchronisation; "
          f"the whole serve step {step_note}", flush=True)

    # 5. the split route over the store; dedup_gather over a plain table
    split = ServeEngine(model, None, topo, store, [SIZES], BATCH, seed=SEED,
                        device=dev)
    dedup = ServeEngine(model, None, topo, table, [SIZES], BATCH,
                        forder=forder, dedup_gather=True, seed=SEED,
                        device=dev)
    for name, e in (("split route over the store", split),
                    ("dedup_gather over one table", dedup)):
        o = e.run(requests[1])
        check(bool(torch.isfinite(o).all()), f"{name}: non-finite logits")
        print(f"tiered check 5: {name}: finite logits {tuple(o.shape)}",
              flush=True)
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
    kept = sum(sample_bytes(o) for o in outs)
    loop_grow = torch.cuda.max_memory_allocated() - before - kept
    resident = torch.cuda.memory_allocated() - before - kept
    edges = int(sum(a.mask.sum() for o in outs for a in o[2]))
    n = len(outs)
    rec = {"arm": label, "name": aname, "mode": mode,
           "seps": edges / wall, "ms_per_batch": wall * 1e3 / n,
           "edges_per_batch": edges / n, "reshuffle_ms": reshuffle_ms,
           "setup_s": setup_s, "launches": launches,
           "setup_growth_bytes": setup_grow,
           "warmup_growth_bytes": warm_grow, "loop_growth_bytes": loop_grow,
           "resident_growth_bytes": resident,
           "sync_free": label in sync_free}
    per = ", ".join(f"{k} {v / n:g}" for k, v in launches.items() if v)
    sync = ""
    if label in sync_free:       # four more batches, none may synchronise
        torch.cuda.set_sync_debug_mode("error")
        try:
            for b in batches[1:5]:
                s.sample(b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        sync = "; 4 more batches sampled under set_sync_debug_mode(error)"
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
                kname = "gather_rows_kernel"
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
                  f"{tuple(tab.shape)} {str(tab.dtype)[6:]}: ids "
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
                          "host_requests_per_s": rate}
        recs[vname] = rec
    return recs, h2d


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
    2048) slots and -1 for the rest of its 2048 columns), and the pinned
    fp32 weight rows, 128 (the pair layout) and 256 wide, at the
    frontier's row ids; own times against the copy-rate bound, host
    read requests per second."""
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
            kname = "gather_rows_kernel"
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
              f"{tuple(tab.shape)}: ids {ids.shape[0]} ({n_live} live, the "
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
                       "host_requests_per_s": rate}
        del got, want
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
                      "gather_elems": 0},
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
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: a
    host synchronisation inside it fails the phase."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        raise SmokeFailure(f"{what} synchronised with the host: "
                           f"{str(e).splitlines()[0][:200]}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)


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
    print("metrics serving: one metered batch runs under "
          "set_sync_debug_mode('error') without a host synchronisation",
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
    import os
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
          f"step under set_sync_debug_mode('error') without a host "
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
    the card, host rows indexed on the host and copied), one host-read
    launch, its own time against the copy-rate bound."""
    import torch
    from quiver_tpu_torch import ShardTensor
    from quiver_tpu_torch.ops import kernels, quant
    from quiver_tpu_torch.ops.kernels import fused
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
    for policy, kname in ((None, "gather_rows_kernel"),
                          ("int8", "gather_rows_packed_kernel")):
        name = policy or "fp32"
        t0 = time.perf_counter()
        st = ShardTensor(dtype_policy=policy, device=dev)
        st.append(feat[:n_dev], 0)
        st.append(feat[n_dev:], -1)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(all(t.is_pinned() for t in quant.tier_parts(st._host_data)
                  if t is not None), f"ShardTensor {name}: host group not "
              "pinned")
        kernels.reset_launches()
        got = sync_free(lambda: st[ids], f"ShardTensor {name} lookup")
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        check(launches["gather_rows"] == 1 and sum(launches.values()) == 1,
              f"ShardTensor {name} launches {launches}")
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
            st._host_data, hids, h2d)
        share = "" if own is None else f" (bound / own {b_ms / own:.0%})"
        pinned = (nodes - n_dev) * (quant.packed_stride(DIM) if policy
                                    else 4 * DIM)
        print(f"shard_tensor {name}: {nodes - n_dev} pinned host rows "
              f"({pinned} B), "
              f"{n_dev} on the card, built in {build_s:.2f} s; lookup at a "
              f"served frontier ({ids.shape[0]} ids, {int(in_dev.sum())} "
              f"device rows, {int(in_host.sum())} host rows, {distinct} "
              f"distinct) equal to the plain version bit for bit, 1 "
              f"gather_rows launch, no host synchronisation; lookup "
              f"{ms:.4f} ms, host read own {fmt_ms(own)}{share}, plain "
              f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: {host_bytes}"
              f" B from the host at {h2d / 1e9:.2f} GB/s); on {card}",
              flush=True)
        out[name] = {"ms": ms, "own_ms": own, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "host_bytes": host_bytes, "launches_per_lookup": 1,
                     "ids": int(ids.shape[0]),
                     "host_rows": int(in_host.sum()), "build_s": build_s}
        del st, dev_rows, host_rows, got
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
        check((host_reads > 0) == (mode == "HOST"),
              f"mixed {mode}: launches {launches}")
        rec[mode] = dict(seps=edges / wall, ms=wall * 1e3,
                         tasks=dict(m.tasks),
                         device_ema_ms=1e3 * m._device_time,
                         cpu_ema_ms=None if m._cpu_time is None
                         else 1e3 * m._cpu_time,
                         launches=launches, num_workers=m.num_workers)
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
              f"{ {k: v for k, v in launches.items() if v} }; phase 7 "
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
    import os
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
    import os
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
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import gather
    ring = store._cold_prefetch._ring
    slots = ring_slots(store, n_id)
    n = slots.shape[0]
    got = torch.zeros((n, DIM), device=slots.device)
    want = torch.zeros((n, DIM), device=slots.device)
    gather.gather_rows(ring.table, slots, out=got)
    gather.gather_rows_plain(ring.table, slots, out=want)
    check(same_bits(got, want), f"ring gather ({name}) differs from its "
          "plain version")
    kernel = "gather_rows_packed_kernel" if quant.is_quantized(ring.table) \
        else "gather_rows_kernel"
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
          f"({quant.row_read_bytes(ring.table)} B a row): wrapper "
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
    import os
    import shutil
    import tempfile

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
    import shutil
    import tempfile

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
    del tiered_ctx
    host_side = phase_host_side(dev, gen, NODES, indptr, indices, deg, card,
                                topo, batches, arms)
    buffered = host_side["pipeline"]["buffered"]["launches_per_step"]
    disk = phase_disk(dev, gen, NODES, indptr, indices, deg, card, topo,
                      host_tier["h2d_bytes_per_s"], refs={
                          "tiered_p50_ms": host_tier["batch_p50_ms"],
                          "serial_p50_ms":
                              host_side["pipeline"]["serial"]["p50_ms"]})

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
         "launches_per_buffered_step": buffered[name]}
        for name in SOURCES]}
    gather_entry = line["kernels"][list(SOURCES).index("gather_rows")]
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
    gather_entry["shard_tensor"] = {
        "name": "gather_rows over the ShardTensor's pinned host group",
        "launches_per_lookup": 1,
        **{k: {x: v[x] for x in ("own_ms", "ms", "plain_ms", "bound_ms",
                                  "bound_by")} for k, v in shard.items()}}
    line["disk_tier"] = disk
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
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
