#!/usr/bin/env python3
"""The port's kernels, an older commit's against this tree's, in one
process on one NVIDIA card.

    git archive <commit> quiver_tpu_torch/csrc | tar -x -C DIR
    python3 kernel_ab.py --old DIR          # the sampling kernels
    python3 kernel_ab.py --old-gather DIR   # the row gather
    python3 kernel_ab.py --old-packed DIR   # the packed host gather
    python3 kernel_ab.py --old-packed-device DIR  # packed rows on the card
    python3 kernel_ab.py --old-raw DIR      # raw rows (commit e836ba3)
    python3 kernel_ab.py --old-elems DIR    # 1-D topology (commit 0d840bb)
    python3 kernel_ab.py --old-arms DIR     # HOST sampler arms, whole tree

Each option runs its part; give one or several.

``--old``: the older sources (``DIR/quiver_tpu_torch/csrc``) are built with this
tree's ``nvcc`` flags and launched through the C interface they had
before the group sampler (``OLD_ARGS``: one thread per seed, the hot
hop's seed rows in their own block); this tree's kernels run through
their wrappers. At the served walk's shapes, on ``chip_smoke.py``'s
graph and seeds: ``fused_sample_hop`` at hop 0 (1,024 x 15) and hop 1
(16,384 x 10), ``fused_hot_hop`` at the leaf (180,224 x 5, int8), and
``sample_layer`` at all three. Every old output is held equal to the new
one bit for bit, then each shape is timed old, new, new, old: each turn
the median of the kernel's own ``torch.profiler`` events over 20
launches. Last, the fused walk of one served batch, old (the older
kernels, compaction, the seed scatter and the pick scatter) against new
(``fused_multihop``), timed the same way with CUDA events around the
walk, its outputs held equal.

``--old-gather``: the older ``gather.cu`` (the interface of commit
9c17a96: int8 codes with separate scale and zero arrays), built with
this tree's flags, against this tree's ``gather_rows``, at
``chip_smoke.py``'s shapes with ids drawn from the seed: the int8 host
tier of phase 6 (1,837,500 cold rows x 100 pinned; old over separate
pinned sidecars, new over packed rows of 112 and of 128 bytes) at 491,677
distinct dense cold ids and in the served form (1,081,344 ids with
499,107 live and distinct, and 270,336 all -1, both with ``out=``); the
fp32 host table of phase 6 (2**18 rows, the dense ids modulo 2**18); and
the device tables of phase 4 (fp32 and bf16, 2,450,000 x 100, 662,640
distinct ids). Every output is held equal bit for bit across the sides,
then each case is timed old, new, new, old (with two new layouts: old,
112, 128, 128, 112, old), each turn the median of the kernel's own
``torch.profiler`` events over 20 launches.

``--old-packed``: an older ``gather.cu`` with this tree's packed-row C
interface (``qt_gather_rows_packed``: any commit since the packed tier),
built with this tree's flags, against this tree's ``gather_rows`` over
the packed int8 host tier of phase 6 (1,837,500 cold rows x 100, 128-byte rows,
pinned) at the same three id sets as ``--old-gather``: both sides launch
``gather_rows_packed_kernel``, held equal bit for bit, then timed old,
new, new, old as above.

``--old-packed-device``: an older ``gather.cu`` with the packed C
interfaces of PR 15 (``qt_gather_rows_packed``, and
``qt_gather_rows_sharded`` without the host flag), whose packed gathers
ran the host design on device tables too, against this tree's HBM
design (``gather_rows_packed_hbm_kernel``,
``gather_rows_sharded_packed_hbm_kernel``), at ``chip_smoke.py``'s
shapes with ids drawn from the seed: phase 15's clique int8 hot tier (all
2,450,000 rows x 100 packed at 128 bytes in 4 device blocks; 1,081,344
ids of which 669,862 are live and distinct, the rest -1) read in the
lookup form (the -1 ids clamped to row 0) and in the ``out=`` form; and
phase 14's unbucket of the received block (1,081,344 packed rows on the
card; 1,081,344 ids of which 671,169 are live, each the rank of its slot
among the live ones, as the exchange at world size 1 numbers them, the
rest -1, ``out=`` zeros). Held equal bit for bit, then timed old, new,
new, old as above; the bound is the ids read once, each distinct row's
108 data bytes read once and each written row's 400 bytes written once,
at 3.35 TB/s.

``--old-raw``: the raw-row kernels of commit e836ba3 (``gather.cu``
with its C interface: one row a warp, and 8 lanes a row in the sharded
kernel), built with this tree's flags, against this tree's raw-row
designs (``gather.raw_design``: the tile design for rows on the card,
the loop design for pinned rows), at the main paths' shapes with ids
drawn from the seed: the HOST sampler's pinned int32 rows views of
phase 7's graph (``[779,022, 128]`` and ``[779,022, 256]``, a last-hop
frontier's 180,224 row ids, 144,048 live, ``out=``) and the same views
on the card; phase 9's
``ShardTensor`` fp32 groups (612,500 rows on the card, 1,837,500
pinned; 1,081,344 ids, 163,823 device and 491,983 host rows, ``out=``);
phase 11's ring of decoded fp32 rows (2**20 pinned, 481,688 of 1,081,344
slots hit, ``out=``); phase 13's pinned fp32 3,072-byte rows (166,576
ids); phase 14's owner read (int8 ``[2,450,000, 128]`` on the card,
671,169 requests then the block's zeros); phase 4's fp32 and bf16
device tables (662,640 distinct ids) and phase 15's 4-block clique tiers
of them (1,081,344 ids, 669,862 live, the lookup form with -1 clamped
and ``out=``). Each side is held to the wrapper's output bit for bit,
then timed old, then this tree's designs (the dispatched one and the
tile design where they differ) and back, with each side's share of the
bound (phase 4's, 7's, 9's and 15's formulas) and, for pinned rows, the
128-byte host lines its rows touch a second.

``--old-elems``: the 1-D topology gather of commit 0d840bb
(``gather.cu``'s ``gather_elems_kernel``, one id a thread, through its
C interface), built with this tree's flags, against this tree's span
gather (``gather_segments_kernel``) and flat form, at the main paths'
shapes on ``chip_smoke.py``'s graph (:func:`elems_cases`): phase 7's
indptr heads of a last-hop frontier (the parent's ``[2, bs]`` ids
against the span form; int32 and int64 indptr), its 901,120 scattered
``indices`` picks (the flat form both sides), and phase 8's
hop-2 weight pool (the flat form over the materialised ids against the
span form). Each side is held to the parent's output bit for bit, then
timed old, new, new, old, with each side's share of the bound, host
read requests a second (the flat form's live ids, the span form's
32-byte sectors) and the 128-byte lines each side's warp loads ask for.

``--old-arms``: a whole older tree (``git archive <commit> | tar -x -C
DIR``) against this one end to end: the HOST sampler arms of
``chip_smoke.py`` (phase 7's (g) and (h), phase 8's (k) and (l), on
phase 7's graph and batches, the timed batches and the profile of four),
each tree in a process of its own running its own ``chip_smoke.py`` and
package, in the order old, new, new, old: ms and device ms a batch, idle
share, sampled edges a second and the peak allocated over one batch.

Prints the card (and this tree's ``nvcc -Xptxas -v`` lines of
``gather.cu``), one line per case and a JSON line; exits non-zero on any
failure.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

ITERS = 20
WALK_ITERS = 10
BUILD = Path(__file__).resolve().parent / "build" / "kernel_ab"

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_ARGS = {
    "qt_gather_rows": [_p, _i, _p, _ll, _ll, _ll, _p, _i, _p],
    "qt_gather_rows_q8": [_p, _p, _p, _i, _p, _ll, _ll, _ll, _p, _i, _p],
    "qt_gather_rows_packed": [_p, _i, _p, _ll, _ll, _ll, _ll, _ll, _p, _i,
                              _p],
    "qt_gather_rows_sharded": [_p, _p, _i, _ll, _p, _ll, _ll, _ll, _ll, _ll,
                               _p, _i, _p],
    "qt_fused_sample_hop": [_p, _p, _p, _i, _i, _i, _i, _i, _p, _p, _p],
    "qt_fused_hot_hop": [_p, _p, _p, _i, _i, _i, _i, _i, _p, _p, _p, _i,
                         _i, _i, _p, _i, _i, _p, _p, _p, _p, _p],
    "qt_sample_layer": [_p, _p, _p, _i, _i, _i, _i, _p, _p, _p],
}


_OLD_LIBS: dict = {}


def build_old(csrc: Path, names):
    """Build the named older sources, all at once, and bind their C
    functions; prints their ptxas lines. A source built before in this
    process is loaded once."""
    from quiver_tpu_torch.ops.kernels import _build
    BUILD.mkdir(parents=True, exist_ok=True)
    done = {n: _OLD_LIBS[(str(csrc), n)] for n in names
            if (str(csrc), n) in _OLD_LIBS}
    jobs = {}
    for name in names:
        if name in done:
            continue
        out = BUILD / f"libold_{len(_OLD_LIBS)}_{name}.so"
        jobs[name] = (out, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"old {name}.cu did not build:\n{log}")
        for kname, regs, stack, st, ld in cs.ptxas_kernels(log):
            print(f"nvcc old {name}: {kname[:72]}: {regs} registers, {stack} "
                  f"bytes stack frame, {st} bytes spill stores, {ld} bytes "
                  "spill loads", flush=True)
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in OLD_ARGS.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _i
        libs[name] = _OLD_LIBS[(str(csrc), name)] = lib
    return {**done, **libs}


def _stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def old_sample_hop(lib, indptr, indices, seeds, k, seed):
    import torch
    bs = seeds.shape[0]
    nbrs = torch.empty((bs, k), dtype=torch.int32, device=seeds.device)
    counts = torch.empty((bs,), dtype=torch.int32, device=seeds.device)
    err = lib.qt_fused_sample_hop(
        indptr.data_ptr(), indices.data_ptr(), seeds.data_ptr(), bs,
        indptr.shape[0] - 1, k, cs.ROW_CAP, seed, nbrs.data_ptr(),
        counts.data_ptr(), _stream())
    cs.check(err == 0, f"old fused_sample_hop launch failed: {err}")
    return nbrs, counts


def old_hot_hop(lib, indptr, indices, seeds, featq, k, seed):
    import torch
    bs = seeds.shape[0]
    data, scale, zero = featq
    tier_n, dim = data.shape
    dev = seeds.device
    nbrs = torch.empty((bs, k), dtype=torch.int32, device=dev)
    counts = torch.empty((bs,), dtype=torch.int32, device=dev)
    seed_rows = torch.empty((bs, dim), dtype=torch.float32, device=dev)
    pick_rows = torch.empty((bs * k, dim), dtype=torch.float32, device=dev)
    err = lib.qt_fused_hot_hop(
        indptr.data_ptr(), indices.data_ptr(), seeds.data_ptr(), bs,
        indptr.shape[0] - 1, k, cs.ROW_CAP, seed, data.data_ptr(),
        scale.data_ptr(), zero.data_ptr(), 1, tier_n, dim, None, 0, tier_n,
        nbrs.data_ptr(), counts.data_ptr(), seed_rows.data_ptr(),
        pick_rows.data_ptr(), _stream())
    cs.check(err == 0, f"old fused_hot_hop launch failed: {err}")
    return nbrs, counts, seed_rows, pick_rows


def old_sample_layer(lib, indptr, indices, seeds, k, seed):
    import torch
    from quiver_tpu_torch.ops.kernels.sample_kernel import _seed_rows
    bs = seeds.shape[0]
    nbrs = torch.empty((bs, k), dtype=torch.int32, device=seeds.device)
    counts = torch.empty((bs,), dtype=torch.int32, device=seeds.device)
    start, deg = _seed_rows(indptr, seeds)
    err = lib.qt_sample_layer(
        indices.data_ptr(), start.data_ptr(), deg.data_ptr(), bs, k,
        cs.ROW_CAP, seed, nbrs.data_ptr(), counts.data_ptr(), _stream())
    cs.check(err == 0, f"old sample_layer launch failed: {err}")
    return nbrs, counts


def old_walk(lib, indptr, indices, seeds, featq, hop_seeds):
    """The fused walk as the older tree ran it: the older kernels, and
    the seed rows and pick rows scattered into a zeroed block."""
    import torch
    from quiver_tpu_torch.ops.sample import compact_layer
    cur, layers = seeds, []
    for i, (k, s) in enumerate(zip(cs.SIZES, hop_seeds)):
        if i < len(cs.SIZES) - 1:
            nbrs, _ = old_sample_hop(lib, indptr, indices, cur, k, s)
        else:
            leaf_seeds = cur
            nbrs, _, seed_rows, pick_rows = old_hot_hop(
                lib, indptr, indices, cur, featq, k, s)
        layers.append(compact_layer(cur, nbrs, seeds_dense=True))
        cur = layers[-1].n_id
    leaf = layers[-1]
    n, cap, dev = leaf_seeds.shape[0], leaf.n_id.shape[0], seeds.device
    x = torch.zeros((cap + 1, seed_rows.shape[1]), device=dev)
    x.index_copy_(0, torch.where(leaf_seeds >= 0,
                                 torch.arange(n, device=dev), cap), seed_rows)
    x.index_copy_(0, torch.where(leaf.col >= 0, leaf.col.long(), cap),
                  pick_rows)
    return leaf.n_id, layers, x[:cap]


def abba(old, new, timer):
    """Times old, new, new, old; the two readings of each side."""
    t = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        t[side].append(timer(old if side == "old" else new))
    return t


def sampling_ab(csrc: Path, dev, gen, indptr, indices, deg, rows):
    """The sampling kernels and the fused walk, old against new."""
    import torch
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import fused, sample_kernel
    libs = build_old(csrc, ("fused_hop", "sample_kernel"))
    featq = quant.quantize(
        torch.randn(cs.NODES, cs.DIM, generator=gen, device=dev), "int8")
    shapes = [cs.BATCH]
    for k in cs.SIZES:
        shapes.append(shapes[-1] * (1 + k))

    # (kernel, label, seeds, k, new call, old call, profiler name)
    cases = []
    fh, sk = libs["fused_hop"], libs["sample_kernel"]
    for hop in range(len(cs.SIZES)):
        bs, k = shapes[hop], cs.SIZES[hop]
        seeds = cs.make_seeds(dev, gen, cs.NODES, bs, deg)
        hs = 3000 + hop
        label = f"hop{hop} bs={bs} k={k}"
        if hop < len(cs.SIZES) - 1:
            cases.append((
                "fused_sample_hop", label, seeds, k,
                lambda s=seeds, k=k, hs=hs: fused.fused_sample_hop(
                    indptr, indices, s, k, hs, cs.ROW_CAP),
                lambda s=seeds, k=k, hs=hs: old_sample_hop(
                    fh, indptr, indices, s, k, hs),
                "fused_sample_hop_kernel"))
        else:
            cases.append((
                "fused_hot_hop", label + " int8", seeds, k,
                lambda s=seeds, k=k, hs=hs: fused.fused_hot_hop(
                    indptr, indices, s, featq, k, hs, cs.ROW_CAP),
                lambda s=seeds, k=k, hs=hs: old_hot_hop(
                    fh, indptr, indices, s, featq, k, hs),
                "fused_hot_hop_kernel"))
        cases.append((
            "sample_layer", label, seeds, k,
            lambda s=seeds, k=k, hs=hs: sample_kernel.sample_layer_kernel(
                indptr, indices, s, k, hs, cs.ROW_CAP),
            lambda s=seeds, k=k, hs=hs: old_sample_layer(
                sk, indptr, indices, s, k, hs),
            "sample_layer_kernel"))

    for kernel, label, seeds, k, new, old, pname in cases:
        got, want = new(), old()
        for g, w in zip(got, want):
            cs.check(cs.same_bits(g, w), f"{kernel} {label}: the old and "
                     "the new kernel disagree")
        if kernel == "fused_hot_hop":
            b_ms, _ = cs.bound(*cs.hot_hop_cost(seeds, k, got[1], got[0],
                                                featq, None, 0))
        else:
            b_ms, _ = cs.bound(cs.sample_hop_bytes(seeds, k, got[1]), 0)
        t = abba(old, new, lambda fn: cs.own_ms(fn, pname, ITERS))
        rows.append({"kernel": kernel, "shape": label, "old_ms": t["old"],
                     "new_ms": t["new"], "bound_ms": b_ms})
        print(f"{kernel} {label}: own device time old "
              f"{' / '.join(cs.fmt_ms(x) for x in t['old'])}, new "
              f"{' / '.join(cs.fmt_ms(x) for x in t['new'])} (torch.profiler,"
              f" median of {ITERS} launches per turn, order old new new "
              f"old), bound {b_ms:.5f} ms, outputs equal", flush=True)

    seeds = cs.make_seeds(dev, gen, cs.NODES, cs.BATCH, deg)
    seeds = torch.cat([seeds[seeds >= 0],
                       seeds[seeds < 0]]).contiguous()   # dense
    hs = [11, -12, 13]
    got = fused.fused_multihop(indptr, indices, seeds, featq, cs.SIZES, hs,
                               cs.ROW_CAP)
    want = old_walk(fh, indptr, indices, seeds, featq, hs)
    cs.check(torch.equal(got[0], want[0]), "walk: n_id differs")
    for a, b in zip(got[1], want[1]):
        cs.check(torch.equal(a.row, b.row) and torch.equal(a.col, b.col),
                 "walk: layer COO differs")
    valid = got[0] >= 0
    cs.check(cs.same_bits(got[2][valid], want[2][valid]),
             "walk: frontier rows differ")
    t = abba(lambda: old_walk(fh, indptr, indices, seeds, featq, hs),
             lambda: fused.fused_multihop(indptr, indices, seeds, featq,
                                          cs.SIZES, hs, cs.ROW_CAP),
             lambda fn: cs.cuda_ms(fn, WALK_ITERS))
    rows.append({"kernel": "walk", "shape": f"batch {cs.BATCH} "
                 f"{cs.SIZES}", "old_ms": t["old"], "new_ms": t["new"]})
    print(f"fused walk batch {cs.BATCH} {cs.SIZES}: old "
          f"{t['old'][0]:.4f} / {t['old'][1]:.4f} ms, new "
          f"{t['new'][0]:.4f} / {t['new'][1]:.4f} ms (CUDA events, median "
          f"of {WALK_ITERS} per turn, order old new new old), outputs "
          "equal", flush=True)


def old_gather(lib, table, ids, out):
    """The older ``gather.cu``'s ``out=`` form over ``table`` (a tensor,
    or a ``QuantizedTensor`` of contiguous leaves) into ``out``."""
    from quiver_tpu_torch.ops import quant
    data, scale, zero = quant.tier_parts(table)
    on_host, skip = int(data.device.type == "cpu"), 1
    n, dim = ids.shape[0], data.shape[1]
    if scale is None:
        err = lib.qt_gather_rows(
            data.data_ptr(), on_host, ids.data_ptr(), n, data.shape[0],
            dim * data.element_size(), out.data_ptr(), skip, _stream())
    else:
        err = lib.qt_gather_rows_q8(
            data.data_ptr(), scale.data_ptr(), zero.data_ptr(), on_host,
            ids.data_ptr(), n, data.shape[0], dim, out.data_ptr(), skip,
            _stream())
    cs.check(err == 0, f"old gather launch failed: {err}")
    return out


def cold_ids(dev, gen, cold_rows):
    """Phase 6's cold-tier id sets: 491,677 distinct dense ids; a served
    full read (1,081,344 ids, 499,107 live and distinct); an empty read
    (270,336 ids, all -1)."""
    import torch
    dense = torch.randperm(cold_rows, generator=gen, device=dev)[
        :491_677].to(torch.int32)
    served = torch.full((1_081_344,), -1, dtype=torch.int32, device=dev)
    slots = torch.randperm(served.shape[0], generator=gen, device=dev)[
        :499_107]
    served[slots] = torch.randperm(cold_rows, generator=gen, device=dev)[
        :slots.shape[0]].to(torch.int32)
    empty = torch.full((270_336,), -1, dtype=torch.int32, device=dev)
    return dense, served, empty


def packed_ab(csrc: Path, dev, rows):
    """The packed int8 host-tier gather, an older ``gather.cu`` with the
    same C interface against this tree's, at phase 6's shapes."""
    import torch
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import gather
    lib = build_old(csrc, ("gather",))["gather"]
    h2d, copy_ms = cs.h2d_rate(dev)
    print(f"pinned-to-device copy rate {h2d / 1e9:.2f} GB/s "
          f"({cs.COPY_BYTES} B in {copy_ms:.4f} ms)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    cold_rows = cs.NODES - cs.NODES // 4
    q = quant.quantize(torch.randn(cold_rows, cs.DIM, generator=gen,
                                   device=dev), "int8")
    tier = quant.pack(quant.QuantizedTensor(*(t.cpu() for t in q)),
                      stride=128, pin=True)
    del q
    data = tier.data
    side = quant.sidecar_offset(cs.DIM)

    def old(ids, out):
        err = lib.qt_gather_rows_packed(
            data.data_ptr(), 1, ids.data_ptr(), ids.shape[0], data.shape[0],
            128, cs.DIM, side, out.data_ptr(), 1, _stream())
        cs.check(err == 0, f"old packed gather launch failed: {err}")
        return out

    dense, served, empty = cold_ids(dev, gen, cold_rows)
    for label, ids in (("dense cold ids", dense),
                       ("served full read", served),
                       ("served empty read", empty)):
        outs = {side_: torch.full((ids.shape[0], cs.DIM), 7.5, device=dev)
                for side_ in ("old", "new")}
        calls = {"old": lambda: old(ids, outs["old"]),
                 "new": lambda: gather.gather_rows(tier, ids,
                                                   out=outs["new"])}
        for fn in calls.values():
            fn()
        cs.check(cs.same_bits(outs["old"], outs["new"]), f"packed gather "
                 f"{label}: new and old disagree")
        b_ms = cs.host_gather_bound(tier, ids, h2d)[0]
        t = abba(calls["old"], calls["new"], lambda fn: cs.own_ms(
            fn, "gather_rows_packed_kernel", ITERS))
        live = int((ids >= 0).sum())
        rows.append({"kernel": "gather_rows_packed_kernel", "shape":
                     f"int8 host tier, {label}: {ids.shape[0]} ids, {live} "
                     "live", "bound_ms": b_ms,
                     **{f"{k}_ms": v for k, v in t.items()}})
        print(f"gather_rows packed int8 host tier, {label}: {ids.shape[0]} "
              f"ids, {live} live: own device time old "
              f"{' / '.join(cs.fmt_ms(x) for x in t['old'])}, new "
              f"{' / '.join(cs.fmt_ms(x) for x in t['new'])} "
              f"(torch.profiler, median of {ITERS} launches per turn, order "
              f"old new new old), bound {b_ms:.5f} ms, outputs equal",
              flush=True)


CLIQUE = 4                    # phase 15's blocks


def device_ids(dev, gen, n_rows, n_ids, live):
    """``n_ids`` slots, ``live`` of them at random holding distinct random
    rows of ``n_rows``, the rest -1."""
    import torch
    ids = torch.full((n_ids,), -1, dtype=torch.int32, device=dev)
    slots = torch.randperm(n_ids, generator=gen, device=dev)[:live]
    ids[slots] = torch.randperm(n_rows, generator=gen, device=dev)[
        :live].to(torch.int32)
    return ids


def packed_device_ab(csrc: Path, dev, rows):
    """Packed int8 rows on the card, an older ``gather.cu`` (the host
    design on device tables) against this tree's HBM design, at phase
    15's clique reads and phase 14's unbucket."""
    import torch
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import gather
    lib = build_old(csrc, ("gather",))["gather"]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    q = quant.quantize(torch.randn(cs.NODES, cs.DIM, generator=gen,
                                   device=dev), "int8")
    cuts = [cs.NODES * s // CLIQUE for s in range(CLIQUE + 1)]
    blocks = [quant.pack(quant.QuantizedTensor(*(t[lo:hi] for t in q)),
                         stride=128, device=dev)
              for lo, hi in zip(cuts[:-1], cuts[1:])]
    tier = gather.prepare_sharded(quant.ShardedTier(blocks, cuts, dev))
    addrs, offs, bits, stride, on_host = gather._sharded_table(tier)
    cs.check(not on_host, "the clique tier lies on the card")
    n_ids = 1_081_344
    block = quant.pack(quant.QuantizedTensor(*(t[:n_ids] for t in q)),
                       stride=128, device=dev)
    del q
    side = quant.sidecar_offset(cs.DIM)
    row_in, row_out = quant.row_read_bytes(block), 4 * cs.DIM

    def old_sharded(ids, out, skip):
        err = lib.qt_gather_rows_sharded(
            addrs.data_ptr(), offs.data_ptr(), CLIQUE, bits, ids.data_ptr(),
            ids.shape[0], stride, cs.DIM, cs.DIM, side, out.data_ptr(),
            skip, _stream())
        cs.check(err == 0, f"old sharded gather launch failed: {err}")
        return out

    def old_flat(ids, out):
        err = lib.qt_gather_rows_packed(
            block.data.data_ptr(), 0, ids.data_ptr(), ids.shape[0],
            block.data.shape[0], 128, cs.DIM, side, out.data_ptr(), 1,
            _stream())
        cs.check(err == 0, f"old packed gather launch failed: {err}")
        return out

    frontier = device_ids(dev, gen, cs.NODES, n_ids, 669_862)
    safe = frontier.clamp(min=0)
    live = torch.zeros(n_ids, dtype=torch.bool, device=dev)
    live[torch.randperm(n_ids, generator=gen, device=dev)[:671_169]] = True
    unbucket = torch.where(live, torch.cumsum(live, 0) - 1, -1).to(
        torch.int32)
    # (label, old call, new call, old kernel, new kernel, rows written,
    #  distinct rows read)
    outs = {k: torch.zeros((n_ids, cs.DIM), device=dev)
            for k in ("old", "new")}
    cases = [
        ("clique int8 hot tier, lookup form (-1 ids clamped)",
         lambda: old_sharded(safe, outs["old"], 0),
         lambda: gather.gather_rows_sharded(tier, safe),
         "gather_rows_sharded_packed_kernel",
         "gather_rows_sharded_packed_hbm_kernel", n_ids,
         int(safe.unique().numel())),
        ("clique int8 hot tier, out= form",
         lambda: old_sharded(frontier, outs["old"], 1),
         lambda: gather.gather_rows_sharded(tier, frontier, out=outs["new"]),
         "gather_rows_sharded_packed_kernel",
         "gather_rows_sharded_packed_hbm_kernel",
         int((frontier >= 0).sum()), int((frontier >= 0).sum())),
        ("exchange unbucket + decode, out= zeros",
         lambda: old_flat(unbucket, outs["old"]),
         lambda: gather.gather_rows(block, unbucket, out=outs["new"]),
         "gather_rows_packed_kernel", "gather_rows_packed_hbm_kernel",
         int(live.sum()), int(live.sum())),
    ]
    for label, old, new, old_k, new_k, written, distinct in cases:
        for o in outs.values():
            o.zero_()
        got_old, got_new = old(), new()
        cs.check(cs.same_bits(got_old, got_new), f"packed device gather "
                 f"{label}: new and old disagree")
        nbytes = 4 * n_ids + row_in * distinct + row_out * written
        b_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
        t = {"old": [], "new": []}
        for side_ in ("old", "new", "new", "old"):
            t[side_].append(cs.own_ms(old if side_ == "old" else new,
                                      old_k if side_ == "old" else new_k,
                                      ITERS))
        share = {k: [None if x is None else b_ms / x for x in v]
                 for k, v in t.items()}
        rows.append({"kernel": new_k, "old_kernel": old_k, "shape":
                     f"{label}: {n_ids} ids, {written} rows written, "
                     f"{distinct} distinct rows read", "bound_ms": b_ms,
                     "bound_share": share,
                     **{f"{k}_ms": v for k, v in t.items()}})
        print(f"packed gather on the card, {label}: {n_ids} ids, {written} "
              f"rows written, {distinct} distinct rows read: own device time "
              f"old ({old_k}) {' / '.join(cs.fmt_ms(x) for x in t['old'])}, "
              f"new ({new_k}) {' / '.join(cs.fmt_ms(x) for x in t['new'])} "
              f"(torch.profiler, median of {ITERS} launches per turn, order "
              f"old new new old), bound {b_ms:.5f} ms ({nbytes} B at 3.35 "
              "TB/s): new at " + " / ".join(
                  "not measured" if x is None else f"{x:.0%}"
                  for x in share["new"]) + " of it, old at " + " / ".join(
                  "not measured" if x is None else f"{x:.0%}"
                  for x in share["old"]) + "; outputs equal", flush=True)


def gather_ab(csrc: Path, dev, rows):
    """The row gather, old against new, at chip_smoke.py's shapes."""
    import torch
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import gather
    lib = build_old(csrc, ("gather",))["gather"]
    h2d, copy_ms = cs.h2d_rate(dev)
    print(f"pinned-to-device copy rate {h2d / 1e9:.2f} GB/s "
          f"({cs.COPY_BYTES} B in {copy_ms:.4f} ms)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    cold_rows = cs.NODES - cs.NODES // 4
    q = quant.quantize(torch.randn(cold_rows, cs.DIM, generator=gen,
                                   device=dev), "int8")
    q = quant.QuantizedTensor(*(t.cpu() for t in q))
    old_tier = quant.QuantizedTensor(*(t.pin_memory() for t in q))
    new_tiers = {s: quant.pack(q, stride=s, pin=True) for s in (112, 128)}
    f32 = quant.dequantize(quant.QuantizedTensor(
        *(t[:cs.FP32_HOST_ROWS] for t in q))).pin_memory()
    del q
    dense, served, empty = cold_ids(dev, gen, cold_rows)
    table = torch.randn(cs.NODES, cs.DIM, generator=gen, device=dev)
    frontier = torch.randperm(cs.NODES, generator=gen, device=dev)[
        :662_640].to(torch.int32)

    # (label, old table, {side: new table}, ids, old / new kernel names)
    q8 = ("gather_rows_q8_kernel", "gather_rows_packed_kernel")
    plain = ("gather_rows_kernel", "gather_rows_kernel")
    cases = [
        ("int8 host tier, dense cold ids", old_tier, new_tiers, dense, q8),
        ("int8 host tier, served full read", old_tier, new_tiers, served, q8),
        ("int8 host tier, served empty read", old_tier, new_tiers, empty,
         q8),
        ("fp32 host table", f32, {"new": f32},
         dense % cs.FP32_HOST_ROWS, plain),
        ("fp32 device table", table, {"new": table}, frontier, plain),
        ("bf16 device table", table.to(torch.bfloat16),
         {"new": table.to(torch.bfloat16)}, frontier, plain),
    ]
    for label, old_t, news, ids, (old_k, new_k) in cases:
        dtype = quant.tier_dtype(old_t)
        shape = (ids.shape[0], cs.DIM)
        outs = {"old": torch.full(shape, 7.5, dtype=dtype, device=dev)}
        outs.update({s: outs["old"].clone() for s in news})
        calls = {"old": lambda o=outs["old"]: old_gather(lib, old_t, ids, o)}
        calls.update({s: (lambda t=t, o=outs[s]: gather.gather_rows(
            t, ids, out=o)) for s, t in news.items()})
        for fn in calls.values():
            fn()
        for side in news:
            cs.check(cs.same_bits(outs[side], outs["old"]), f"gather "
                     f"{label}: new ({side}) and old disagree")
        if quant.tier_parts(old_t)[0].device.type == "cuda":
            b_ms, _ = cs.bound(ids.shape[0] * (4 + 2 * cs.DIM
                                               * old_t.element_size()), 0)
        else:
            b_ms = cs.host_gather_bound(old_t, ids, h2d)[0]
        order = ["old", *news, *reversed(list(news)), "old"]
        t = {side: [] for side in calls}
        for side in order:
            t[side].append(cs.own_ms(calls[side],
                                     old_k if side == "old" else new_k,
                                     ITERS))
        live = int((ids >= 0).sum())
        rows.append({"kernel": "gather_rows", "shape": f"{label}: "
                     f"{ids.shape[0]} ids, {live} live", "bound_ms": b_ms,
                     **{f"{side}_ms": t[side] for side in t}})
        print(f"gather_rows {label}: {ids.shape[0]} ids, {live} live: own "
              "device time " + ", ".join(
                  f"{side} {' / '.join(cs.fmt_ms(x) for x in t[side])}"
                  for side in t) +
              f" (torch.profiler, median of {ITERS} launches per turn, "
              f"order {' '.join(map(str, order))}), bound {b_ms:.5f} ms, "
              "outputs equal", flush=True)


# the raw-row C interface of commit e836ba3 (qt_gather_rows_sharded with
# the host flag, no design or word)
RAW_ARGS = {
    "qt_gather_rows": OLD_ARGS["qt_gather_rows"],
    "qt_gather_rows_sharded": [_p, _p, _i, _ll, _i, _p, _ll, _ll, _ll, _ll,
                               _ll, _p, _i, _p],
}
SHARD_DEV_ROWS = cs.NODES // 4          # phase 9's ShardTensor device group
RING_ROWS = 1 << 20                     # phase 11's staging ring


def host_lines(base: int, stride: int, row_bytes: int, ids) -> int:
    """The 128-byte lines of host memory that the rows of the live ids
    touch, in a table at address ``base`` with this row stride."""
    live = ids[ids >= 0].long()
    first = base + live * stride
    return int(((first + row_bytes - 1) // 128 - first // 128 + 1).sum())


def new_raw(table, ids, out, skip, design):
    """This tree's flat raw-row gather forced to ``design`` (the wrapper
    picks one by ``gather.raw_design``)."""
    from quiver_tpu_torch.ops.kernels import gather
    row = table.shape[1] * table.element_size()
    align = gather.address_align(table.data_ptr(), out.data_ptr())
    err = gather._lib().qt_gather_rows(
        table.data_ptr(), int(table.device.type == "cpu"), ids.data_ptr(),
        ids.shape[0], table.shape[0], row, out.data_ptr(), skip,
        gather.RAW_DESIGNS[design], gather.raw_word_bytes(design, row, align),
        _stream())
    cs.check(err == 0, f"new {design} gather launch failed: {err}")
    return out


def new_raw_sharded(tier, ids, out, skip, design):
    """The same over a sharded tier of raw rows."""
    from quiver_tpu_torch.ops.kernels import gather
    addrs, offs, bits, stride, on_host = gather._sharded_table(tier)
    row = stride
    align = gather.address_align(bits, out.data_ptr())
    err = gather._lib().qt_gather_rows_sharded(
        addrs.data_ptr(), offs.data_ptr(), len(tier.shards), bits,
        int(on_host), ids.data_ptr(), ids.shape[0], stride, row, tier.dim,
        -1, out.data_ptr(), skip, gather.RAW_DESIGNS[design],
        gather.raw_word_bytes(design, row, align), _stream())
    cs.check(err == 0, f"new sharded {design} gather launch failed: {err}")
    return out


def raw_cases(dev, gen, h2d):
    """The raw-row shapes of the main paths: ``(label, table or tier,
    ids, out= base or None, bound ms, 128-byte host lines or None)``,
    each made when its turn comes (a generator: the pinned tables of one
    case are freed before the next)."""
    import torch
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import gather
    from quiver_tpu_torch.ops.sample import (as_index_rows,
                                             as_index_rows_overlapping)

    def dev_bound(n, row_in, distinct, row_out, written):
        return (4 * n + row_in * distinct + row_out * written) \
            / cs.HBM_BYTES_PER_S * 1e3

    indptr, indices, _ = cs.make_graph(dev, gen, cs.NODES)
    r0, _, _ = cs.last_hop_reads(dev, indptr)
    del indptr
    for width, view in ((128, as_index_rows),
                        (256, as_index_rows_overlapping)):
        on_card = view(indices, 128)
        tab = on_card.cpu().pin_memory()
        out = torch.full((r0.shape[0], width), 7, dtype=torch.int32,
                         device=dev)
        # phase 7's bounds: every live id's row at the copy rate, or the
        # ids and those rows on the card (read and written there)
        data = int((r0 >= 0).sum()) * 4 * width
        yield (f"HOST topology rows{width}: pinned int32 "
               f"{tuple(tab.shape)}, out= form", tab, r0, out,
               max(data / h2d * 1e3, (4 * r0.shape[0] + data)
                   / cs.HBM_BYTES_PER_S * 1e3),
               host_lines(tab.data_ptr(), 4 * width, 4 * width, r0))
        del tab
        yield (f"topology rows{width} on the card: int32 "
               f"{tuple(on_card.shape)}, out= form", on_card, r0, out,
               (4 * r0.shape[0] + 2 * data) / cs.HBM_BYTES_PER_S * 1e3,
               None)
        del on_card
    del indices

    feat = torch.randn(cs.NODES, cs.DIM, generator=gen, device=dev)
    # ShardTensor's two groups (phase 9): a quarter on the card, the rest
    # pinned; a served frontier's 163,823 device and 491,983 host rows
    host = feat[SHARD_DEV_ROWS:].cpu().pin_memory()
    tier = gather.prepare_sharded(quant.ShardedTier(
        [feat[:SHARD_DEV_ROWS], host], [0, SHARD_DEV_ROWS, cs.NODES], dev))
    n_ids = 1_081_344
    ids = torch.full((n_ids,), -1, dtype=torch.int32, device=dev)
    slots = torch.randperm(n_ids, generator=gen, device=dev)
    ids[slots[:163_823]] = torch.randperm(
        SHARD_DEV_ROWS, generator=gen, device=dev)[:163_823].to(torch.int32)
    ids[slots[163_823:655_806]] = (SHARD_DEV_ROWS + torch.randperm(
        cs.NODES - SHARD_DEV_ROWS, generator=gen, device=dev)[
        :491_983]).to(torch.int32)
    hids = torch.where(ids >= SHARD_DEV_ROWS, ids - SHARD_DEV_ROWS, -1)
    b_host = cs.host_gather_bound(host, hids, h2d)[0]
    yield ("ShardTensor fp32 groups through gather_rows_sharded: 612,500 "
           "device rows, 1,837,500 pinned, out= form", tier, ids,
           torch.zeros((n_ids, cs.DIM), device=dev),
           max(b_host, dev_bound(n_ids, 4 * cs.DIM, 163_823, 4 * cs.DIM,
                                 163_823)),
           host_lines(host.data_ptr(), 4 * cs.DIM, 4 * cs.DIM, hids))
    del tier, host, hids

    # the disk ring's decoded fp32 rows (phase 11): a step's slots
    ring = torch.randn(RING_ROWS, cs.DIM, generator=gen, device=dev) \
        .cpu().pin_memory()
    slots = torch.full((n_ids,), -1, dtype=torch.int32, device=dev)
    slots[torch.randperm(n_ids, generator=gen, device=dev)[:481_688]] = \
        torch.randperm(RING_ROWS, generator=gen, device=dev)[
            :481_688].to(torch.int32)
    yield ("disk ring, decoded fp32 rows (pinned [1048576, 100]), out= "
           "form", ring, slots, torch.zeros((n_ids, cs.DIM), device=dev),
           cs.host_gather_bound(ring, slots, h2d)[0],
           host_lines(ring.data_ptr(), 4 * cs.DIM, 4 * cs.DIM, slots))
    del ring

    # the hetero fp32 check (phase 13): 3,072-byte pinned rows
    wide = torch.randn(cs.MAG_FP32_ROWS, cs.MAG_DIM, generator=gen,
                       device=dev).cpu().pin_memory()
    wids = torch.randint(0, cs.MAG_FP32_ROWS, (166_576,), generator=gen,
                         device=dev, dtype=torch.int32)
    yield (f"hetero fp32 rows (pinned {tuple(wide.shape)}, 3,072 B), "
           "lookup form", wide, wids, None,
           cs.host_gather_bound(wide, wids, h2d)[0],
           host_lines(wide.data_ptr(), 4 * cs.MAG_DIM, 4 * cs.MAG_DIM, wids))
    del wide

    # the exchange's owner read (phase 14): its packed int8 shard read as
    # raw 128-byte rows, 671,169 requests then the block's zero padding
    shard = torch.randint(-128, 128, (cs.NODES, 128), generator=gen,
                          device=dev, dtype=torch.int8)
    req = torch.zeros(n_ids, dtype=torch.int32, device=dev)
    req[:671_169] = torch.randperm(cs.NODES, generator=gen, device=dev)[
        :671_169].to(torch.int32)
    yield ("exchange owner read: int8 [2450000, 128] on the card, lookup "
           "form", shard, req, None, dev_bound(n_ids, 128, n_ids, 128, n_ids),
           None)
    del shard

    # device tables (phase 4) and the clique's 4 blocks (phase 15)
    frontier = torch.randperm(cs.NODES, generator=gen, device=dev)[
        :662_640].to(torch.int32)
    served = device_ids(dev, gen, cs.NODES, n_ids, 669_862)
    safe = served.clamp(min=0)
    cuts = [cs.NODES * s // CLIQUE for s in range(CLIQUE + 1)]
    for name, table in (("fp32", feat), ("bf16", feat.to(torch.bfloat16))):
        row = cs.DIM * table.element_size()
        yield (f"{name} device table {tuple(table.shape)}, lookup form",
               table, frontier, None,
               dev_bound(662_640, row, 662_640, row, 662_640), None)
        blocks = [table[lo:hi] for lo, hi in zip(cuts[:-1], cuts[1:])]
        tier = gather.prepare_sharded(quant.ShardedTier(blocks, cuts, dev))
        yield (f"{name} clique tier, 4 device blocks, lookup form (-1 ids "
               "clamped)", tier, safe, None,
               dev_bound(n_ids, row, int(safe.unique().numel()), row, n_ids),
               None)
        yield (f"{name} clique tier, 4 device blocks, out= form", tier,
               served, torch.zeros((n_ids, cs.DIM), dtype=table.dtype,
                                   device=dev),
               dev_bound(n_ids, row, 669_862, row, 669_862), None)
        del tier, blocks


def raw_ab(csrc: Path, dev, rows):
    """The raw-row gathers, commit e836ba3's kernels (one row a warp, or
    8 lanes a row in the sharded kernel) against this tree's designs, at
    the main paths' shapes."""
    import torch
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import gather
    lib = build_old(csrc, ("gather",))["gather"]
    for fn, argtypes in RAW_ARGS.items():
        getattr(lib, fn).argtypes = argtypes
    h2d, copy_ms = cs.h2d_rate(dev)
    print(f"pinned-to-device copy rate {h2d / 1e9:.2f} GB/s "
          f"({cs.COPY_BYTES} B in {copy_ms:.4f} ms)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def old_call(table, ids, out, skip):
        if quant.is_sharded(table):
            addrs, offs, bits, stride, on_host = gather._sharded_table(table)
            err = lib.qt_gather_rows_sharded(
                addrs.data_ptr(), offs.data_ptr(), len(table.shards), bits,
                int(on_host), ids.data_ptr(), ids.shape[0], stride, stride,
                table.dim, -1, out.data_ptr(), skip, _stream())
        else:
            err = lib.qt_gather_rows(
                table.data_ptr(), int(table.device.type == "cpu"),
                ids.data_ptr(), ids.shape[0], table.shape[0],
                table.shape[1] * table.element_size(), out.data_ptr(), skip,
                _stream())
        cs.check(err == 0, f"old gather launch failed: {err}")
        return out

    for label, table, ids, base, b_ms, lines in raw_cases(dev, gen, h2d):
        sharded = quant.is_sharded(table)
        if sharded:
            _, _, _, row, on_host = gather._sharded_table(table)
            dtype, dim = quant.tier_dtype(table), table.dim
        else:
            on_host = table.device.type == "cpu"
            dtype, dim = table.dtype, table.shape[1]
            row = dim * table.element_size()
        skip = int(base is not None)
        outs = {k: (base.clone() if skip else
                    torch.empty((ids.shape[0], dim), dtype=dtype,
                                device=dev))
                for k in ("old", *gather.RAW_DESIGNS, "wrapper")}
        picked = gather.raw_design(on_host)
        # the new tree's loop design is the parent's kernel: timed only
        # where the dispatcher picks it
        designs = ["tile"] if picked == "tile" else [picked, "tile"]
        force = new_raw_sharded if sharded else new_raw
        calls = {"old": lambda: old_call(table, ids, outs["old"], skip)}
        for d in designs:
            calls[d] = (lambda d=d: force(table, ids, outs[d], skip, d))
        wrap = gather.gather_rows_sharded if sharded else gather.gather_rows
        got = wrap(table, ids, out=outs["wrapper"]) if skip else \
            wrap(table, ids)
        for fn in calls.values():
            fn()
        for side in (*designs, "old"):
            cs.check(cs.same_bits(outs[side], got), f"raw gather {label}: "
                     f"{side} and the wrapper ({picked}) disagree")
        del got
        kname = {d: gather.raw_kernel(d, sharded) for d in designs}
        kname["old"] = gather.raw_kernel("loop", sharded)
        order = ["old", *designs, *reversed(designs), "old"]
        t = {side: [] for side in calls}
        for side in order:
            t[side].append(cs.own_ms(calls[side], kname[side], ITERS))
        share = {k: [None if x is None else b_ms / x for x in v]
                 for k, v in t.items()}
        rate = None if lines is None else {
            k: [None if x is None else lines / (x / 1e3) for x in v]
            for k, v in t.items()}
        live = int((ids >= 0).sum())
        rows.append({"kernel": kname[picked], "old_kernel": kname["old"],
                     "shape": f"{label}: {ids.shape[0]} ids, {live} live",
                     "row_bytes": int(row), "dispatched": picked,
                     "bound_ms": b_ms, "bound_share": share,
                     "host_lines": lines, "host_lines_per_s": rate,
                     **{f"{k}_ms": v for k, v in t.items()}})
        print(f"raw gather {label}: {ids.shape[0]} ids, {live} live, "
              f"{row}-byte rows, dispatched {kname[picked]}: own device "
              "time " + ", ".join(
                  f"{side} {' / '.join(cs.fmt_ms(x) for x in t[side])} ("
                  + " / ".join("not measured" if x is None else f"{x:.0%}"
                               for x in share[side]) + ")"
                  + ("" if rate is None else " " + " / ".join(
                      "not measured" if x is None else f"{x / 1e6:.1f}M"
                      for x in rate[side]) + " lines/s")
                  for side in t)
              + f" (torch.profiler, median of {ITERS} launches per turn, "
              f"order {' '.join(order)}; share of the bound {b_ms:.5f} ms"
              + ("" if lines is None else f"; {lines} 128-byte host lines")
              + "); outputs equal", flush=True)
        del outs, calls


ELEMS_ARGS = {"qt_gather_elems": [_p, _i, _i, _p, _i, _ll, _ll, _p, _p]}


def id_lines(tab, ids) -> int:
    """The 128-byte lines of ``tab`` that a flat gather's warp load
    instructions ask for: per 32 consecutive ids, the distinct lines of
    their live elements."""
    import torch
    pad = (-ids.shape[0]) % 32
    ids = torch.cat([ids.long(), ids.new_full((pad,), -1).long()])
    line = torch.where(ids >= 0, (tab.data_ptr() + ids.clamp(
        0, tab.shape[0] - 1) * tab.element_size()) // 128, -1)
    line = torch.sort(line.reshape(-1, 32), dim=1).values
    new = torch.ones_like(line, dtype=torch.bool)
    new[:, 1:] = line[:, 1:] != line[:, :-1]
    return int((new & (line >= 0)).sum())


def elems_cases(dev, gen, h2d):
    """The 1-D topology reads of the main paths, each ``(label, table,
    {side: (call, kernel)}, check, bound ms, bound by, requests a side,
    128-byte lines a side)``, the older side's entry its ids (its call is
    bound by the caller): phase 7's indptr heads of a last-hop frontier
    (180,224 seeds, a fifth -1) over the pinned int32 indptr and an int64
    copy, the parent's flat form over ``[2, bs]`` ids against the span
    gather; phase 7's 901,120 scattered ``indices`` picks, the flat form
    both sides; phase 8's hop-2 weight pool (180,224 seeds x 2,048
    columns over the pinned fp32 weights), the flat form over the
    materialised int64 ids against the span gather. A generator: each
    case's tables are freed before the next is made."""
    import torch
    from quiver_tpu_torch.ops.kernels import gather
    from quiver_tpu_torch.utils.placement import pinned_put

    def bound(dev_bytes, host_bytes):
        b_dev = dev_bytes / cs.HBM_BYTES_PER_S * 1e3
        b_host = host_bytes / h2d * 1e3
        return (b_host, "bytes (host)") if b_host > b_dev \
            else (b_dev, "bytes (device)")

    indptr, indices, deg = cs.make_graph(dev, gen, cs.NODES)
    _, slots, seeds = cs.last_hop_reads(dev, indptr)
    bs = seeds.shape[0]
    for dtype in (torch.int32, torch.int64):
        tab = pinned_put(indptr.to(dtype), dev, "indptr")
        start, count = cs.heads_spans(dev, seeds, tab.shape[0])
        ids = torch.where(count > 0, torch.stack([start, start + 1]),
                          -1).reshape(-1)
        live = int((ids >= 0).sum())
        eb = tab.element_size()
        b_ms, b_by = bound(12 * bs + 2 * eb * bs, live * eb)
        yield (f"heads over the pinned {str(dtype)[6:]} indptr "
               f"{tuple(tab.shape)}, {bs} seeds", tab,
               {"old": (ids, "gather_elems_kernel"),
                "span": (lambda tab=tab, start=start, count=count:
                         gather.gather_segments(tab, start, count, 2),
                         "gather_segments_kernel")},
               lambda old, new: cs.same_bits(old.reshape(2, -1).t(), new),
               b_ms, b_by, {"old": live, "span": cs.span_units(
                   tab, start, count, 2, 32)},
               {"old": id_lines(tab, ids),
                "span": cs.span_units(tab, start, count, 2, 128)})
        del tab

    tab = pinned_put(indices, dev, "indices")
    live = int((slots >= 0).sum())
    b_ms, b_by = bound(12 * slots.shape[0], 4 * live)

    yield (f"scattered indices picks over the pinned int32 indices "
           f"{tuple(tab.shape)}", tab,
           {"old": (slots, "gather_elems_kernel"),
            "flat": (lambda tab=tab: gather.gather_elems(tab, slots),
                     "gather_elems_kernel")},
           cs.same_bits, b_ms, b_by, {"old": live, "flat": live},
           dict.fromkeys(("old", "flat"), id_lines(tab, slots)))
    del tab

    w = pinned_put(cs.example_weights(indices, deg), dev, "weights")
    del indices
    g8 = torch.Generator(device=dev).manual_seed(cs.SEED + 8)
    pseeds = torch.randperm(cs.NODES, generator=g8, device=dev)[:bs]
    pseeds[torch.rand(bs, generator=g8, device=dev) < 0.2] = -1
    ip = indptr.long()
    valid = pseeds >= 0
    sl = pseeds.long().clamp(min=0)
    start = torch.where(valid, ip[sl], 0).contiguous()
    count = torch.where(valid, ip[sl + 1] - ip[sl], 0) \
        .clamp(max=cs.ROW_CAP).to(torch.int32).contiguous()
    pool = gather._implied_ids(start, count, cs.ROW_CAP).reshape(-1)
    live = int(count.long().sum())
    b_ms, b_by = bound(12 * bs + 4 * cs.ROW_CAP * bs, 4 * live)
    yield (f"hop-2 weight pool over the pinned fp32 weights "
           f"{tuple(w.shape)}, {bs} seeds x {cs.ROW_CAP} (flat form's "
           f"bound {12 * pool.shape[0] / cs.HBM_BYTES_PER_S * 1e3:.4f} ms: "
           "its ids' bytes)", w,
           {"old": (pool, "gather_elems_kernel"),
            "span": (lambda: gather.gather_segments(w, start, count,
                                                    cs.ROW_CAP),
                     "gather_segments_kernel")},
           lambda old, new: cs.same_bits(old.view(torch.float32)
                                         .reshape(bs, cs.ROW_CAP), new),
           b_ms, b_by, {"old": live, "span": cs.span_units(
               w, start, count, cs.ROW_CAP, 32)},
           {"old": id_lines(w, pool),
            "span": cs.span_units(w, start, count, cs.ROW_CAP, 128)})


def elems_ab(csrc: Path, dev, rows):
    """The 1-D topology gathers, the parent's flat kernel (one id a
    thread) against this tree's span gather and flat forms, at the main
    paths' shapes (:func:`elems_cases`)."""
    import torch
    lib = build_old(csrc, ("gather",))["gather"]
    for fn, argtypes in ELEMS_ARGS.items():
        getattr(lib, fn).argtypes = argtypes
    h2d, copy_ms = cs.h2d_rate(dev)
    print(f"pinned-to-device copy rate {h2d / 1e9:.2f} GB/s "
          f"({cs.COPY_BYTES} B in {copy_ms:.4f} ms)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def old_call(tab, ids):
        words = tab.view(torch.int32) if tab.dtype == torch.float32 else tab
        out = torch.empty(ids.shape[0], dtype=words.dtype, device=dev)
        err = lib.qt_gather_elems(
            words.data_ptr(), 1, words.element_size(), ids.data_ptr(),
            ids.element_size(), ids.shape[0], words.shape[0],
            out.data_ptr(), _stream())
        cs.check(err == 0, f"old gather_elems launch failed: {err}")
        return out

    for label, tab, sides, same, b_ms, b_by, reqs, lines in elems_cases(
            dev, gen, h2d):
        ids, _ = sides["old"]
        calls = {"old": lambda tab=tab, ids=ids: old_call(tab, ids)}
        calls.update({k: v[0] for k, v in sides.items() if k != "old"})
        kname = {k: v[1] for k, v in sides.items()}
        old = calls["old"]()
        for side, fn in calls.items():
            if side != "old":
                cs.check(same(old, fn()), f"elems {label}: {side} and the "
                         "parent's kernel disagree")
        del old
        new = [k for k in calls if k != "old"]
        order = ["old", *new, *reversed(new), "old"]
        t = {side: [] for side in calls}
        for side in order:
            t[side].append(cs.own_ms(calls[side], kname[side], ITERS))
        share = {k: [None if x is None else b_ms / x for x in v]
                 for k, v in t.items()}
        rate = {k: [None if x is None else reqs[k] / (x / 1e3) for x in v]
                for k, v in t.items()}
        line_rate = {k: [None if x is None else lines[k] / (x / 1e3)
                         for x in v] for k, v in t.items()}
        rows.append({"shape": label, "kernels": kname, "bound_ms": b_ms,
                     "bound_by": b_by, "bound_share": share,
                     "requests": reqs, "host_requests_per_s": rate,
                     "lines": lines, "lines_per_s": line_rate,
                     **{f"{k}_ms": v for k, v in t.items()}})
        print(f"elems {label}: own device time " + ", ".join(
            f"{side} ({kname[side]}) "
            f"{' / '.join(cs.fmt_ms(x) for x in t[side])} ("
            + " / ".join("not measured" if x is None else f"{x:.0%}"
                         for x in share[side]) + "; " + " / ".join(
                "not measured" if x is None else f"{x / 1e6:.1f}M"
                for x in rate[side])
            + f" host read requests/s of {reqs[side]}; " + " / ".join(
                "not measured" if x is None else f"{x / 1e6:.1f}M"
                for x in line_rate[side])
            + f" lines/s of {lines[side]} 128-byte lines asked for)"
            for side in t)
            + f" (torch.profiler, median of {ITERS} launches per turn, "
            f"order {' '.join(order)}; share of the bound {b_ms:.5f} ms, "
            f"{b_by}; requests: the flat form's live ids, the span form's "
            "32-byte sectors); outputs equal", flush=True)
        del calls, sides


# one process's HOST sampler arms, run in the root of a tree (this one,
# or an older one unpacked whole by git archive) with that tree's
# chip_smoke.py and package: phase 7's (g) and (h) and phase 8's (k) and
# (l) on phase 7's graph, one line of their records
ARMS_RUN = r"""
import json, torch
import chip_smoke as cs
from quiver_tpu_torch import CSRTopo
from quiver_tpu_torch.ops import kernels
kernels.build_kernels()
dev = torch.device("cuda")
card = cs.card_line()
gen = torch.Generator(device=dev).manual_seed(cs.SEED)
indptr, indices, deg = cs.make_graph(dev, gen, cs.NODES)
topo = CSRTopo(indptr=indptr, indices=indices, device=dev)
perm = torch.randperm(cs.NODES, generator=gen, device=dev).to(torch.int32)
batches = [perm[i * cs.BATCH:(i + 1) * cs.BATCH].contiguous()
           for i in range(cs.SAMPLER_BATCHES + 1)]
w = cs.example_weights(indices, deg)
recs = {}
for arms, kw_arm in ((cs.SAMPLER_ARMS, {}),
                     (cs.WEIGHTED_ARMS, {"edge_weight": w})):
    run = batches if not kw_arm else batches[:cs.WEIGHTED_BATCHES + 1]
    for label, mode, kw in arms:
        if mode == "HOST":
            rec, _, s = cs.run_arm(label, mode, kw, topo, run, card,
                                   keep=set(), sync_free="", **kw_arm)
            recs[label] = rec
            del s
print("ARMS " + json.dumps(recs))
"""
ARM_KEYS = ("ms_per_batch", "device_ms_per_batch", "idle_share",
            "warmup_growth_bytes", "loop_growth_bytes", "seps")


def arms_ab(old_root: Path, rows):
    """The HOST sampler arms end to end, an older tree (``old_root``, a
    whole ``git archive`` of it) against this one, each in a process of
    its own, in the order old, new, new, old: ms and device ms a batch,
    idle share and the peak allocated over one batch."""
    import torch
    torch.cuda.empty_cache()
    here = Path(__file__).resolve().parent
    got = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        root = old_root if side == "old" else here
        proc = subprocess.run([sys.executable, "-c", ARMS_RUN], cwd=root,
                              capture_output=True, text=True, timeout=900)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("ARMS ")]
        cs.check(proc.returncode == 0 and line, f"arms ({side}) failed "
                 f"with {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                 f"{proc.stderr[-3000:]}")
        got[side].append(json.loads(line[0][5:]))
    for arm in got["new"][0]:
        row = {"arm": arm, "name": got["new"][0][arm]["name"],
               **{f"{side}_{k}": [r[arm].get(k) for r in got[side]]
                  for side in got for k in ARM_KEYS}}
        rows.append(row)
        print(f"arms ({arm}) {row['name']}: " + "; ".join(
            f"{side} " + ", ".join(
                f"{k} " + " / ".join("not measured" if x is None else
                                     f"{x:.6g}" for x in row[f'{side}_{k}'])
                for k in ARM_KEYS) for side in got)
            + " (order old new new old, a process each)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="directory holding quiver_tpu_torch/csrc "
                    "of a commit before the group sampler (the sampling "
                    "kernels' A/B)")
    ap.add_argument("--old-gather", help="directory holding "
                    "quiver_tpu_torch/csrc of commit 9c17a96 (the row "
                    "gather's A/B)")
    ap.add_argument("--old-packed", help="directory holding "
                    "quiver_tpu_torch/csrc of a commit with the packed "
                    "gather's C interface (the packed host-tier A/B)")
    ap.add_argument("--old-packed-device", help="directory holding "
                    "quiver_tpu_torch/csrc of a commit with PR 15's packed "
                    "and sharded C interfaces (packed rows on the card)")
    ap.add_argument("--old-raw", help="directory holding "
                    "quiver_tpu_torch/csrc of commit e836ba3 (the raw-row "
                    "designs' A/B)")
    ap.add_argument("--old-elems", help="directory holding "
                    "quiver_tpu_torch/csrc of commit 0d840bb (the 1-D "
                    "topology gathers' A/B)")
    ap.add_argument("--old-arms", help="directory holding a whole older "
                    "tree (git archive), whose HOST sampler arms run "
                    "against this tree's, a process each")
    args = ap.parse_args()
    if not (args.old or args.old_gather or args.old_packed
            or args.old_packed_device or args.old_raw or args.old_elems
            or args.old_arms):
        ap.error("give --old, --old-gather, --old-packed, "
                 "--old-packed-device, --old-raw, --old-elems, --old-arms "
                 "or several")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    from quiver_tpu_torch.ops.kernels import _build, build_kernels

    card = cs.card_line()
    print(card, flush=True)
    build_kernels()
    for kname, regs, stack, st, ld in cs.ptxas_kernels(
            _build.build_logs.get("gather", "")):
        print(f"nvcc gather: {kname[:72]}: {regs} registers, {stack} bytes "
              f"stack frame, {st} bytes spill stores, {ld} bytes spill "
              "loads", flush=True)
    dev = torch.device("cuda")
    rows = []
    if args.old:
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        indptr, indices, deg = cs.make_graph(dev, gen, cs.NODES)
        sampling_ab(Path(args.old) / "quiver_tpu_torch" / "csrc", dev, gen,
                    indptr, indices, deg, rows)
    if args.old_gather:
        gather_ab(Path(args.old_gather) / "quiver_tpu_torch" / "csrc", dev,
                  rows)
    if args.old_packed:
        packed_ab(Path(args.old_packed) / "quiver_tpu_torch" / "csrc", dev,
                  rows)
    if args.old_packed_device:
        packed_device_ab(Path(args.old_packed_device) / "quiver_tpu_torch"
                         / "csrc", dev, rows)
    if args.old_raw:
        raw_ab(Path(args.old_raw) / "quiver_tpu_torch" / "csrc", dev, rows)
    if args.old_elems:
        elems_ab(Path(args.old_elems) / "quiver_tpu_torch" / "csrc", dev,
                 rows)
    if args.old_arms:
        arms_ab(Path(args.old_arms).resolve(), rows)
    print(card, flush=True)
    print(json.dumps({"card": card, "cases": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
