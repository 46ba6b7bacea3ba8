"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA card with ``nvcc`` (the kernels have no CPU mode)
and skip elsewhere. Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda``.

The sampling cases cover one seed per group of 8, 16 and 32 lanes and a
second step per lane (``k`` 1, 4, 31, 33, 64); the hot-hop cases every
table (int8, fp32, each with and without ``feature_order`` +
``hot_rows``) at widths 3, 7, 20 and 100 (the scalar and the 4-value
gather words), a table whose base is not 16-byte aligned, and the
``seed_rows_out`` destination. Every seed list has a ragged last
128-seed block, seeds of degree 0 and above ``row_cap``, and -1 seeds.
The train step is counted (one launch of each kernel per hop) and its
loss and gradients through the kernel walk are held against the plain
walk's; the split serve path answers on the card.

The sampler's topology gathers (``gather_rows`` over int32 rows views
128 and 256 wide, ``gather_elems`` over 4- and 8-byte elements with 4-
and 8-byte ids) read pinned and device tables, with -1 ids, 1, 31, 33
and 270,336 of them, equal to their plain versions; ``GraphSageSampler``
in HOST mode gives HBM mode's picks bit for bit in every method, HBM
mode launching no kernel of the port and HOST mode the topology
gathers, and ``sample()`` runs under
``torch.cuda.set_sync_debug_mode("error")`` in both modes.

The host-tier row gather reads pinned host tables (fp32, bf16, int8 with
sidecars; misaligned widths and bases) from the card, with and without
``out=`` and its negative ids, equal to its plain version; so does its
id scan over the packed int8 tier at widths 7, 100, 128 and 256, fp32
and bf16 host tables and device tables, with ids all -1, with holes or
dense, 1, 31, 33 and 270,336 of them; the tiered
store's lookup runs on the card with no host synchronisation, equal to
the same store on the CPU, and the engine serves through it.

The raw-row designs (``gather.raw_design``: the tile design for rows on
the card, the loop design for pinned rows) are each forced on device and
pinned tables at rows of 400, 200, 512, 3,072, 128, 20, 6 and 7 bytes
(every word width), lookup and ``out=`` with -1 ids at 0, 1, 33 and 4,099
ids, and on sharded tables of 4 and 100 blocks with a pinned last
block, each equal to its plain version and counted by kernel in
``RAW_LAUNCHES``; a word a design does not take raises; unforced, each
read runs the dispatched design's kernel (by the profiler's names).

Weighted sampling reads pinned fp32 weights through ``gather_elems`` and
pinned fp32 weight rows (128 and 256 wide) through ``gather_rows``, each
equal to its plain version with -1 ids; ``GraphSageSampler(edge_weight=
...)`` in HOST mode gives HBM mode's samples bit for bit (exact,
rotation, window), free of host synchronisation; GAT's forward and
backward on the card are within 1e-4 of the CPU's.

The metered lookup, train step, engine and sampler run on the card
without a host synchronisation, their counters equal to the CPU's and
their results to the unmetered ones (compared under torch's
deterministic algorithms, so that the model's sums run in one order);
a rotated store looks up the same bits and its engine serves the same
logits before and after ``refresh_feature``; ``ShardTensor``'s pinned
host group, read by the card, equals the same store on the CPU.

The host side: ``Feature.prefetch`` stages lookups on the pipeline
worker's own stream with no host synchronisation (the sync check covers
the worker too) and returns the lookup's rows; CPU mode puts its batch
on the card equal to the CPU device's sample; ``MixedGraphSageSampler``
yields every batch once on the card, HOST mode through the topology
gathers; ``layerwise_inference`` on the card is within 1e-4 of the
CPU's.

The disk tier: the cold prefetcher's staging ring in pinned memory, read
on the card by ``gather_rows`` (decoded fp32 rows, and packed int8 rows
the kernel decodes), equals its plain version and the store on the CPU;
with a ring of 1.05x one batch's cold rows and the stager wrapping around
while the card reads, every lookup is still exact (the fence); with two
cards, the events go on the ids' card.

The request path: a ``MicroBatchServer`` over a fused engine on the card
reads each batch back into a host array of its own (no row of one batch
aliases another's, and every row equals its batch's replay), serves an
engine on the last visible card from its executor thread (skips on one
card), and fails a batch whose run raises without a retry.

Heterogeneous graphs: the typed sampler (exact, rotation, weighted) and
``HeteroFeature.lookup`` on the card make no host synchronisation and
look up the CPU stores' bits, the paper tier read by one packed
``gather_rows`` launch; that gather at MAG240M's width 768 (896-byte
packed rows, and fp32 rows) equals its plain version bit for bit;
``HeteroFeature.prefetch`` stages on the ids' card (the second card's
case skips on one card); one R-GCN step on the card is within 1e-4 of
the CPU's under torch's deterministic algorithms; a store built from a
table on the card stores the host build's bits.

The partitioned store: the exchange's two ``gather_rows`` launches (the
owner's read of raw packed int8 rows, the unbucket with the decode)
equal their plain versions; a one-rank NCCL group's lookups (dense,
compact, falling back; fp32 and int8) equal a gloo group's on the CPU,
counters included, the dense one free of host synchronisation; two
ranks over NCCL, one card each, look up the rows (skips on one
card).

The clique: ``gather_rows_sharded`` over blocks on the card, several
allocations of it and pinned host memory (fp32, bf16, fp16, raw and
packed int8; with and without ``out=``, -1 ids, empty blocks) equals its
plain version bit for bit; a clique store over a mesh naming the card
four times looks up the replicate store's bits in one kernel launch per
hot read, free of host synchronisation, and its engine serves the same
logits; with two cards, a clique over both reads the peer's block (skips
on one card); a spawned worker opens a clique store from ``share_ipc``
and looks up the parent's bits.

The operator CLIs: ``qt_capacity --predict`` probes the card by default
and appends the prediction it prints; a ``qt_agg --once`` pass leaves
CUDA uninitialised in its process."""

import numpy as np
import pytest
import torch

import copy

from quiver_tpu_torch import (CSRTopo, Feature, GraphSAGE, GraphSageSampler,
                              ServeEngine)
from quiver_tpu_torch.ops import quant
from quiver_tpu_torch.ops.kernels import _build, fused, gather, sample_kernel
from quiver_tpu_torch.parallel import (build_train_step, init_state,
                                       layers_to_adjs, train)
from quiver_tpu_torch.utils.placement import pinned_put

pytestmark = pytest.mark.cuda

N, DIM, K, ROW_CAP = 3000, 20, 4, 32
WIDE = 100                         # the served feature width
HUBS = np.arange(10, 20)           # degree 200: above every row_cap here


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def graph(card):
    g = np.random.default_rng(0)
    deg = g.integers(0, 60, N)
    deg[:10] = 0
    deg[HUBS] = 200
    indptr = np.zeros(N + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    indices = g.integers(0, N, indptr[-1]).astype(np.int32)
    # 1,000 seeds: a ragged last block of 104, -1 holes, an isolated row
    # and the hubs
    seeds = g.choice(np.arange(20, N), 1000, replace=False).astype(np.int32)
    seeds[1] = 3
    seeds[2:2 + HUBS.size] = HUBS
    seeds[::37] = -1
    feat = g.standard_normal((N, WIDE)).astype(np.float32)
    perm = g.permutation(N).astype(np.int32)
    on = lambda a: torch.from_numpy(a).to(card)
    return dict(indptr=on(indptr), indices=on(indices), seeds=on(seeds),
                feat=on(feat), forder=on(perm))


def _bits(t):
    if not t.is_floating_point():
        return t
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _offset(t, by):
    """``t`` copied into a flat buffer ``by`` elements past its start:
    the same values with a base that is not 16-byte aligned."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    out = buf[by:].view(t.shape)
    out.copy_(t)
    return out


def _table(graph, kind, dim, offset=0):
    """The feature table of a case and its ``(feature_order, hot_rows)``."""
    f = graph["feat"][:, :dim].contiguous()
    if kind.startswith("int8"):
        q = quant.quantize(f, "int8")
        feat = q._replace(data=_offset(q.data, offset)) if offset else q
    else:
        feat = _offset(f, offset) if offset else f
    fo = (graph["forder"], N // 2) if kind.endswith("forder") else (None, None)
    return feat, fo


# (k, row_cap): groups of 8, 16 and 32 lanes, then two steps per lane
SAMPLE_CASES = [(1, 32), (4, 32), (31, 32), (33, 40), (64, 80)]


@pytest.mark.parametrize("k,row_cap", SAMPLE_CASES)
def test_sample_hop_kernel_equals_plain(graph, k, row_cap):
    args = (graph["indptr"], graph["indices"], graph["seeds"], k, -77,
            row_cap)
    before = fused.LAUNCHES["fused_sample_hop"]
    got = fused.fused_sample_hop(*args)
    assert fused.LAUNCHES["fused_sample_hop"] == before + 1
    want = fused.sample_hop_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].max()) == k and int(got[1].min()) == 0


# (kind, dim, k, offset, vec): every table at widths 3, 7, 20 and 100,
# fanouts across the group sizes, and tables with a misaligned base
HOT_CASES = [(kind, dim, K, 0, 4 if dim % 4 == 0 else 1)
             for kind in ("int8", "fp32", "int8_forder", "fp32_forder")
             for dim in (3, 7, DIM, WIDE)]
HOT_CASES += [("int8", WIDE, k, 0, 4) for k in (1, 5, 31, 33, 64)]
HOT_CASES += [("int8", WIDE, 5, 1, 1), ("fp32", WIDE, 5, 1, 1),
              ("int8_forder", DIM, 33, 2, 1)]


@pytest.mark.parametrize("kind,dim,k,offset,vec", HOT_CASES)
def test_hot_hop_kernel_equals_plain(graph, kind, dim, k, offset, vec):
    feat, (fo, hot) = _table(graph, kind, dim, offset)
    row_cap = max(ROW_CAP, k)
    args = (graph["indptr"], graph["indices"], graph["seeds"], feat, k, 5,
            row_cap, fo, hot)
    got = fused.fused_hot_hop(*args)
    want = fused.hot_hop_plain(*args)
    assert fused.hot_hop_vec(feat, got[2], got[3]) == vec
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("kind,dim", [("int8", WIDE), ("fp32_forder", 7)])
def test_hot_hop_writes_seed_rows_into_a_destination(graph, kind, dim):
    """``seed_rows_out`` (the walk's ``x[:n]``): the valid seeds' rows
    land there, row-strided, and a -1 seed's slot keeps its bits."""
    feat, (fo, hot) = _table(graph, kind, dim)
    seeds = graph["seeds"]
    bs = seeds.shape[0]
    block = torch.full((bs, dim + 4), 7.5, device=seeds.device)
    out = block[:, :dim]
    args = (graph["indptr"], graph["indices"], seeds, feat, K, 9, ROW_CAP,
            fo, hot)
    got = fused.fused_hot_hop(*args, seed_rows_out=out)
    want = fused.hot_hop_plain(*args)
    assert got[2] is out
    valid = seeds >= 0
    assert torch.equal(_bits(out[valid]), _bits(want[2][valid]))
    assert (out[~valid] == 7.5).all() and (block[:, dim:] == 7.5).all()
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("k,row_cap", [(K, ROW_CAP), (33, 40), (64, 80)])
def test_sample_layer_kernel_equals_plain_and_fused_hop(graph, k, row_cap):
    args = (graph["indptr"], graph["indices"], graph["seeds"], k, -77,
            row_cap)
    before = fused.LAUNCHES["sample_layer"]
    got = sample_kernel.sample_layer_kernel(*args)
    assert fused.LAUNCHES["sample_layer"] == before + 1
    want = sample_kernel.sample_layer_plain(*args)
    hop = fused.fused_sample_hop(*args)
    for g, w, h in zip(got, want, hop):
        assert torch.equal(g, w) and torch.equal(g, h)
    torch.cuda.synchronize()


# (dtype, width): one case for each word the kernel copies in
@pytest.mark.parametrize("dtype,dim,word", [
    (torch.float32, DIM, 16), (torch.bfloat16, DIM, 8),
    (torch.float16, 3, 2), (torch.int8, 7, 1)])
def test_gather_rows_kernel_equals_plain(graph, dtype, dim, word):
    feat = (graph["feat"][:, :dim] * 20).to(dtype).contiguous()
    ids = graph["seeds"][graph["seeds"] >= 0].contiguous()
    before = fused.LAUNCHES["gather_rows"]
    got = gather.gather_rows(feat, ids)
    assert fused.LAUNCHES["gather_rows"] == before + 1
    assert gather.word_bytes(feat, got) == word
    want = gather.gather_rows_plain(feat, ids)
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(got, torch.index_select(feat, 0, ids))
    torch.cuda.synchronize()


def test_split_walk_equals_fused_walk(graph):
    feat = quant.quantize(graph["feat"][:, :DIM].contiguous(), "int8")
    # dense: distinct valid ids, then a -1 tail
    seeds = torch.cat([graph["seeds"][2:30],
                       torch.full((4,), -1, dtype=torch.int32,
                                  device=graph["seeds"].device)])
    args = (graph["indptr"], graph["indices"], seeds, feat, [4, 3, 2],
            [5, -6, 7], ROW_CAP)
    fused.reset_launches()
    rn, rl, rx = fused.fused_multihop_reference(*args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == {"fused_sample_hop": 0, "fused_hot_hop": 0,
                              "sample_layer": 3, "gather_rows": 0,
                              "gather_elems": 0, "gather_rows_sharded": 0}
    n_id, layers, x = fused.fused_multihop(*args)
    assert torch.equal(n_id, rn)
    for a, b in zip(layers, rl):
        assert torch.equal(a.row, b.row) and torch.equal(a.col, b.col)
    valid = n_id >= 0
    assert torch.equal(_bits(x[valid]), _bits(rx[valid]))
    assert (~valid).any() and not _bits(x[~valid]).any()   # +0.0 padding


def test_engine_serves_through_the_kernels(graph):
    topo = CSRTopo(indptr=graph["indptr"], indices=graph["indices"])
    eng = ServeEngine(GraphSAGE(DIM, 16, 5, 2), None, topo,
                      quant.quantize(graph["feat"][:, :DIM].contiguous(),
                                     "int8"), [[4, 3]], 64,
                      fused_hot_hop=True, fused_row_cap=ROW_CAP)
    fused.reset_launches()
    out = eng.run(torch.arange(40, dtype=torch.int32))
    torch.cuda.synchronize()
    assert out.shape == (64, 5) and torch.isfinite(out).all()
    assert fused.LAUNCHES == {"fused_sample_hop": 1, "fused_hot_hop": 1,
                              "sample_layer": 0, "gather_rows": 0,
                              "gather_elems": 0, "gather_rows_sharded": 0}


def _train_batch(graph):
    """A dense seed block (distinct valid ids, then a -1 tail), labels
    for every slot, an fp32 table and its int8 copy."""
    dev = graph["seeds"].device
    seeds = torch.cat([graph["seeds"][2:30],
                       torch.full((4,), -1, dtype=torch.int32, device=dev)])
    labels = torch.randint(0, 5, (32,), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    f32 = graph["feat"][:, :DIM].contiguous()
    return seeds, labels, {"fp32": f32, "int8": quant.quantize(f32, "int8")}


def test_train_step_launches_each_kernel_per_hop(graph):
    seeds, labels, tables = _train_batch(graph)
    model = GraphSAGE(DIM, 16, 5, 2).to(seeds.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = build_train_step(model, opt, [4, 3], 32, fused_hot_hop=True,
                            fused_row_cap=ROW_CAP)
    state = init_state(model, opt)
    fused.reset_launches()
    losses = []
    for i in range(3):
        state, loss = step(state, tables["int8"], None, graph["indptr"],
                           graph["indices"], seeds, labels, [i, -i], 7 + i)
        losses.append(loss)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == {"fused_sample_hop": 3, "fused_hot_hop": 3,
                              "sample_layer": 0, "gather_rows": 0,
                              "gather_elems": 0, "gather_rows_sharded": 0}
    assert state.step == 3 and torch.isfinite(torch.stack(losses)).all()


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_train_kernel_walk_equals_plain_walk(graph, kind):
    """One step's loss and gradients from the same parameters and seeds,
    through the kernel walk (the step's own loss) and the plain walk:
    the loss within 1e-4 and each gradient within 1e-4 of its tensor's
    largest entry, since ``index_add_`` and the backward of
    ``x_src[s]`` sum with atomics in another order on each run."""
    seeds, labels, tables = _train_batch(graph)
    table, sizes, hs = tables[kind], [4, 3], [11, -12]
    model = GraphSAGE(DIM, 16, 5, 2, dropout=0.5).to(seeds.device).train()
    args = (graph["indptr"], graph["indices"], seeds)
    rn, rl, rx = fused.multihop_plain(*args, table, sizes, hs, ROW_CAP)
    _, layers = train._fused_multihop_x(table, None, *args, sizes, hs,
                                        ROW_CAP)
    assert torch.equal(layers[-1].n_id, rn)
    for a, b in zip(layers, rl):
        assert torch.equal(a.row, b.row) and torch.equal(a.col, b.col)
    out = []
    for loss_of in (
            lambda m: train._fused_loss(m, sizes, 32, table, None, *args,
                                        labels, hs, 5,
                                        fused={"row_cap": ROW_CAP}),
            lambda m: train._model_loss(m, rx, layers_to_adjs(rl, 32, sizes),
                                        labels, 32, 5)):
        m = copy.deepcopy(model)
        loss = loss_of(m)
        loss.backward()
        out.append((loss.item(), {n: p.grad for n, p in
                                  m.named_parameters()}))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-4
    for n, g in gk.items():
        assert (g - gp[n]).abs().max() <= 1e-4 * gp[n].abs().max(), n


def test_split_engine_answers_on_the_card(graph):
    topo = CSRTopo(indptr=graph["indptr"], indices=graph["indices"])
    eng = ServeEngine(GraphSAGE(DIM, 16, 5, 2), None, topo,
                      quant.quantize(graph["feat"][:, :DIM].contiguous(),
                                     "int8"), [[4, 3]], 64)
    fused.reset_launches()
    ids = torch.arange(40, dtype=torch.int32)
    out = eng.run(ids, hop_seeds=[3, 4])
    again = eng.run(ids, hop_seeds=[3, 4])
    torch.cuda.synchronize()
    assert out.shape == (64, 5) and out.device.type == "cuda"
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, again, atol=1e-5, rtol=1e-5)
    assert not any(fused.LAUNCHES.values())


# (kind, width, base offset): 16-byte / 4-value words, then the narrow
# and misaligned ones
HOST_CASES = [(kind, dim, off) for kind in ("fp32", "bf16", "int8")
              for dim, off in ((WIDE, 0), (7, 0), (3, 0), (WIDE, 1))]


def _host_table(graph, kind, dim, offset):
    """A table in pinned host memory (``offset`` elements past an aligned
    base when not 0) and its rows' dtype."""
    f = graph["feat"][:, :dim].contiguous().cpu()

    def pinned(t):
        buf = torch.empty(t.numel() + offset, dtype=t.dtype).pin_memory()
        out = buf[offset:].view(t.shape)
        out.copy_(t)
        return out

    if kind == "int8":
        return quant.QuantizedTensor(*(pinned(t) for t in
                                       quant.quantize(f, "int8")))
    return pinned(f.to(torch.bfloat16) if kind == "bf16" else f)


@pytest.mark.parametrize("kind,dim,offset", HOST_CASES)
def test_host_tier_gather_equals_plain(graph, kind, dim, offset):
    table = _host_table(graph, kind, dim, offset)
    assert quant.tier_parts(table)[0].is_pinned()
    ids = graph["seeds"].clamp(min=0).contiguous()
    before = fused.LAUNCHES["gather_rows"]
    got = gather.gather_rows(table, ids)
    want = gather.gather_rows_plain(table, ids)
    assert got.device == ids.device
    assert torch.equal(_bits(got), _bits(want))
    # out=: negative ids leave their rows untouched
    holes = graph["seeds"]
    out = torch.full((holes.shape[0], dim), 7.5, device=ids.device,
                     dtype=got.dtype)
    res = gather.gather_rows(table, holes, out=out)
    assert res is out and fused.LAUNCHES["gather_rows"] == before + 2
    keep = holes >= 0
    assert torch.equal(_bits(out[keep]), _bits(want[keep]))
    assert (out[~keep] == 7.5).all()
    torch.cuda.synchronize()


def test_host_tier_gather_needs_pinned_memory(graph):
    with pytest.raises(ValueError, match="pinned"):
        gather.gather_rows(graph["feat"].cpu(), graph["seeds"].clamp(min=0))


# ids all -1, with holes, or dense; counts below, just past and far past
# a warp's 32
GATHER_IDS = ["none", "holes", "dense"]
GATHER_COUNTS = [1, 31, 33, 270_336]


def _gather_ids(dev, kind, n):
    g = np.random.default_rng(n)
    ids = g.integers(0, N, n).astype(np.int32)
    if kind == "none":
        ids[:] = -1
    elif kind == "holes":
        ids[g.random(n) < 0.5] = -1
    return torch.from_numpy(ids).to(dev)


def _check_gather(table, ids, dim, dtype):
    """The kernel against its plain version: without ``out=`` over the
    ids clamped to 0, then with ``out=`` over the ids as they are."""
    before = fused.LAUNCHES["gather_rows"]
    dense = ids.clamp(min=0)
    got = gather.gather_rows(table, dense)
    assert torch.equal(_bits(got),
                       _bits(gather.gather_rows_plain(table, dense)))
    out = torch.full((ids.shape[0], dim), 7.5, device=ids.device,
                     dtype=dtype)
    want = out.clone()
    assert gather.gather_rows(table, ids, out=out) is out
    gather.gather_rows_plain(table, ids, out=want)
    assert torch.equal(_bits(out), _bits(want))
    assert fused.LAUNCHES["gather_rows"] == before + 2
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_ids", GATHER_COUNTS)
@pytest.mark.parametrize("kind", GATHER_IDS)
@pytest.mark.parametrize("dim", [7, 100, 128, 256])
def test_packed_host_gather_equals_plain(card, dim, kind, n_ids):
    f = np.random.default_rng(dim).standard_normal((N, dim)) \
        .astype(np.float32)
    table = pinned_put(quant.quantize(torch.from_numpy(f), "int8"), card,
                       "the test tier")
    assert table.data.is_pinned()
    assert table.data.stride(0) == quant.packed_stride(dim)
    assert gather.word_bytes(table, torch.empty(1, device=card)) == 16
    _check_gather(table, _gather_ids(card, kind, n_ids), dim, torch.float32)


@pytest.mark.parametrize("n_ids", GATHER_COUNTS)
@pytest.mark.parametrize("kind", GATHER_IDS)
@pytest.mark.parametrize("dtype,where", [
    (torch.float32, "host"), (torch.bfloat16, "host"),
    (torch.float32, "device"), (torch.bfloat16, "device"),
    (torch.int8, "device")])
def test_row_gather_id_scan_equals_plain(graph, dtype, where, kind, n_ids):
    f = graph["feat"]
    if dtype == torch.int8:
        table = quant.quantize(f, "int8")
        out_dt = torch.float32
    else:
        table = f.to(dtype).contiguous()
        out_dt = dtype
    if where == "host":
        table = table.cpu().pin_memory()
    _check_gather(table, _gather_ids(f.device, kind, n_ids), WIDE, out_dt)


def _stores(graph, **kw):
    """The same tiered int8 store on the card and on the CPU."""
    topo = CSRTopo(indptr=graph["indptr"], indices=graph["indices"])
    feat = graph["feat"][:, :DIM].cpu().numpy()
    mk = lambda dev: Feature(device_cache_size=(N // 4) * (DIM + 8),
                             csr_topo=topo, dtype_policy="int8",
                             host_placement="offload", device=dev,
                             **kw).from_cpu_tensor(feat)
    return mk("cuda"), mk("cpu")


@pytest.mark.parametrize("budget", [None, 64])
def test_tiered_lookup_runs_without_host_sync(graph, budget):
    card, cpu = _stores(graph, dedup_cold=True, cold_budget=budget)
    assert card._host_offload.data.is_pinned()
    ids = torch.cat([graph["seeds"], graph["seeds"][:500]]).contiguous()
    fused.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    safe = ids.clamp(min=0)             # the unmasked lookup's contract
    try:
        got = card.lookup_tiered(safe)
        got_m = card.lookup_tiered(ids, masked=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fused.LAUNCHES["gather_rows"] > 0
    assert torch.equal(_bits(got.cpu()), _bits(cpu.lookup_tiered(safe.cpu())))
    assert torch.equal(_bits(got_m.cpu()),
                       _bits(cpu.lookup_tiered(ids.cpu(), masked=True)))


def test_engine_serves_a_tiered_store(graph):
    card, cpu = _stores(graph, dedup_cold=True)
    model = GraphSAGE(DIM, 16, 5, 2)
    state = model.state_dict()
    topo = (graph["indptr"], graph["indices"])
    eng = ServeEngine(model, state, topo, card, [[4, 3]], 64,
                      fused_hot_hop=True, fused_row_cap=ROW_CAP)
    ref = ServeEngine(copy.deepcopy(model), state,
                      tuple(t.cpu() for t in topo), cpu, [[4, 3]], 64,
                      fused_hot_hop=True,
                      fused_row_cap=ROW_CAP, device="cpu")
    ids = torch.arange(20, 60, dtype=torch.int32)
    fused.reset_launches()
    out = eng.run(ids, hop_seeds=[3, 4])
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_sample_hop"] == 1
    assert fused.LAUNCHES["fused_hot_hop"] == 1
    assert fused.LAUNCHES["gather_rows"] > 0
    torch.testing.assert_close(out.cpu(), ref.run(ids, hop_seeds=[3, 4]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n_ids", GATHER_COUNTS)
@pytest.mark.parametrize("kind", GATHER_IDS)
@pytest.mark.parametrize("where", ["host", "device"])
@pytest.mark.parametrize("width", [128, 256])
def test_int32_rows_gather_equals_plain(card, width, where, kind, n_ids):
    rows = torch.from_numpy(np.random.default_rng(width).integers(
        -2**31, 2**31 - 1, (N, width), dtype=np.int64).astype(np.int32))
    rows = pinned_put(rows, card, "rows") if where == "host" \
        else rows.to(card)
    assert rows.is_pinned() == (where == "host")
    _check_gather(rows, _gather_ids(card, kind, n_ids), width, torch.int32)


@pytest.mark.parametrize("n_ids", GATHER_COUNTS)
@pytest.mark.parametrize("kind", GATHER_IDS)
@pytest.mark.parametrize("where", ["host", "device"])
@pytest.mark.parametrize("dtype,id_dtype", [
    (torch.int32, torch.int32), (torch.int32, torch.int64),
    (torch.int64, torch.int32), (torch.int64, torch.int64)])
def test_gather_elems_equals_plain(card, dtype, id_dtype, where, kind,
                                   n_ids):
    g = np.random.default_rng(n_ids)
    table = torch.from_numpy(g.integers(-2**40, 2**40, 5 * N)).to(dtype)
    table = pinned_put(table, card, "elems") if where == "host" \
        else table.to(card)
    ids = _gather_ids(card, kind, n_ids).to(id_dtype) * 5 + \
        (_gather_ids(card, "dense", n_ids) % 5).to(id_dtype)
    ids = torch.where(ids < 0, -1, ids).contiguous()
    before = fused.LAUNCHES["gather_elems"]
    got = gather.gather_elems(table, ids)
    want = gather.gather_elems_plain(table, ids)
    assert got.dtype == dtype and got.device.type == "cuda"
    assert torch.equal(got, want)
    assert (got[ids < 0] == -1).all()
    assert fused.LAUNCHES["gather_elems"] == before + 1


@pytest.mark.parametrize("n_seeds", [1, 33, 4_099, 180_224])
@pytest.mark.parametrize("where", ["host", "device"])
@pytest.mark.parametrize("width", [1, 2, 7, 64, 2048])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
def test_gather_segments_equals_plain(card, dtype, width, where, n_seeds):
    """The span gather against its plain version bit for bit: counts 0
    (the -1 seeds' form) to past the width, starts at 0, unaligned, at
    the table's end and running past it; one launch of
    ``gather_segments_kernel``, counted under ``gather_elems``."""
    g = np.random.default_rng(width * 7 + n_seeds)
    n_table = 5 * N
    if dtype == torch.float32:
        table = torch.from_numpy(g.standard_normal(n_table)
                                 .astype(np.float32))
    else:
        table = torch.from_numpy(g.integers(-2**40, 2**40, n_table)) \
            .to(dtype)
    table = pinned_put(table, card, "spans") if where == "host" \
        else table.to(card)
    start = g.integers(0, n_table, n_seeds)
    count = g.integers(0, min(width, 40) + 1, n_seeds)
    count[g.random(n_seeds) < 0.2] = 0
    edge = [(0, width), (n_table, 0), (n_table - 1, width), (1, width + 5),
            (3, width)]
    for i, (s, c) in enumerate(edge[:n_seeds]):
        start[i], count[i] = s, c
    start = torch.from_numpy(start.astype(np.int64)).to(card)
    count = torch.from_numpy(count.astype(np.int32)).to(card)
    before = dict(_build.ELEMS_LAUNCHES)
    n_before = fused.LAUNCHES["gather_elems"]
    got = gather.gather_segments(table, start, count, width)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["gather_elems"] == n_before + 1
    assert {k: v - before[k] for k, v in _build.ELEMS_LAUNCHES.items()} \
        == {"gather_elems_kernel": 0, "gather_segments_kernel": 1}
    words = table.view(torch.int32) if dtype == torch.float32 else table
    want = gather.gather_segments_plain(words, start, count, width)
    assert got.dtype == dtype and tuple(got.shape) == (n_seeds, width)
    got_w = got.view(torch.int32) if dtype == torch.float32 else got
    assert torch.equal(got_w, want)
    flat = gather.gather_elems(words, gather._implied_ids(
        start, count, width).reshape(-1).contiguous())
    assert torch.equal(got_w.reshape(-1), flat)
    out = torch.full((n_seeds, width), 5, dtype=dtype, device=card)
    assert gather.gather_segments(table, start, count, width, out=out) \
        .data_ptr() == out.data_ptr()
    assert torch.equal(out.view(torch.uint8), got.view(torch.uint8))


def test_take_segments_refuses_unpinned_host_tables(card):
    from quiver_tpu_torch.ops.sample import take_segments
    start = torch.zeros(4, dtype=torch.int64, device=card)
    count = torch.ones(4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="pinned"):
        take_segments(torch.arange(10, dtype=torch.int32), start, count, 2)
    with pytest.raises(ValueError, match="pinned"):
        gather.gather_segments(torch.arange(10, dtype=torch.int32), start,
                               count, 2)


def test_topology_reader_refuses_unpinned_host_tables(card):
    from quiver_tpu_torch.ops.sample import take
    ids = torch.arange(4, device=card)
    with pytest.raises(ValueError, match="pinned"):
        take(torch.arange(10, dtype=torch.int32), ids)
    with pytest.raises(ValueError, match="pinned"):
        gather.gather_elems(torch.arange(10, dtype=torch.int32), ids)
    assert torch.equal(take(torch.arange(10, device=card), ids), ids)


SAMPLER_METHODS = [dict(sampling="exact", wide_exact=False),
                   dict(sampling="exact"),
                   dict(sampling="exact", layout="overlap"),
                   dict(sampling="rotation"),
                   dict(sampling="rotation", layout="overlap"),
                   dict(sampling="rotation", layout="overlap",
                        shuffle="butterfly"),
                   dict(sampling="window"),
                   dict(sampling="window", layout="overlap",
                        shuffle="butterfly")]


@pytest.mark.parametrize("kw", SAMPLER_METHODS)
def test_sampler_host_equals_hbm_without_sync(graph, kw):
    """Both modes draw the same picks bit for bit; HBM mode launches no
    kernel of the port, HOST mode the topology gathers; ``sample()``
    after the first batch runs with no host synchronisation."""
    topo = CSRTopo(indptr=graph["indptr"], indices=graph["indices"],
                   eid=torch.randperm(int(graph["indices"].shape[0]),
                                      device=graph["seeds"].device))
    seeds = graph["seeds"][graph["seeds"] >= 0][:200].contiguous()
    out = {}
    for mode in ("HBM", "HOST"):
        s = GraphSageSampler(topo, [5, 4, 3], mode=mode, seed=11,
                             with_eid=True, **kw)
        s.sample(seeds)
        torch.cuda.synchronize()
        fused.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = s.sample(seeds)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        out[mode] = (got, dict(fused.LAUNCHES))
        if mode == "HOST":
            assert s._placed[1].is_pinned() and s._placed[0].is_pinned()
            # the indptr heads of every hop through the span gather
            assert _build.ELEMS_LAUNCHES["gather_segments_kernel"] == 3
    (hbm, hbm_l), (host, host_l) = out["HBM"], out["HOST"]
    assert not any(hbm_l.values()), hbm_l
    assert host_l["gather_elems"] > 0 and host_l["fused_hot_hop"] == 0
    wide = kw["sampling"] != "exact" or kw.get("wide_exact", True)
    assert (host_l["gather_rows"] > 0) == wide
    assert torch.equal(hbm[0], host[0]) and hbm[1] == host[1]
    for a, b in zip(hbm[2], host[2]):
        assert torch.equal(a.edge_index, b.edge_index)
        assert torch.equal(a.e_id, b.e_id) and a.size == b.size


# -- weighted sampling and GAT ------------------------------------------------

@pytest.mark.parametrize("n_ids", [33, 270_336])
@pytest.mark.parametrize("kind", GATHER_IDS)
@pytest.mark.parametrize("width", [128, 256])
def test_fp32_weight_rows_gather_equals_plain(card, width, kind, n_ids):
    """The weighted windowed draw's reads: pinned fp32 rows views of the
    co-shuffled weights, 128 (pair) and 256 (overlap) wide."""
    rows = torch.from_numpy(np.random.default_rng(width).standard_normal(
        (N, width)).astype(np.float32))
    rows = pinned_put(rows, card, "weight rows")
    assert rows.is_pinned() and rows.dtype == torch.float32
    _check_gather(rows, _gather_ids(card, kind, n_ids), width,
                  torch.float32)


@pytest.mark.parametrize("n_ids", [1, 33, 270_336])
@pytest.mark.parametrize("kind", GATHER_IDS)
def test_fp32_weight_elems_gather_equals_plain(card, kind, n_ids):
    """The weighted pool draw's reads: pinned fp32 edge weights through
    ``gather_elems``, read as int32 words (a -1 id gives the bits of int
    -1, a NaN), equal to the plain version over the same words."""
    w = torch.from_numpy(np.random.default_rng(n_ids).random(
        5 * N).astype(np.float32))
    table = pinned_put(w, card, "weights")
    ids = _gather_ids(card, kind, n_ids) * 5 + \
        _gather_ids(card, "dense", n_ids) % 5
    ids = torch.where(ids < 0, -1, ids).contiguous()
    before = fused.LAUNCHES["gather_elems"]
    got = gather.gather_elems(table, ids)
    want = gather.gather_elems_plain(table.view(torch.int32), ids)
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    assert torch.equal(got.view(torch.int32), want)
    live = ids >= 0
    assert torch.equal(got[live], w.to(card)[ids[live].long()])
    assert fused.LAUNCHES["gather_elems"] == before + 1


WEIGHTED_METHODS = [dict(sampling="exact"),
                    dict(sampling="rotation", layout="overlap"),
                    dict(sampling="window")]


@pytest.mark.parametrize("kw", WEIGHTED_METHODS)
def test_weighted_sampler_host_equals_hbm(graph, kw):
    """``GraphSageSampler(edge_weight=...)``: HOST mode (weights pinned,
    read by ``gather_elems``; the windowed draw's weight rows by
    ``gather_rows``) gives HBM mode's samples bit for bit, with no host
    synchronisation after the first batch; HBM mode launches no kernel
    of the port; no pick lands on a zero-weight edge."""
    e = int(graph["indices"].shape[0])
    g = torch.Generator(device=graph["seeds"].device).manual_seed(3)
    w = torch.rand(e, generator=g, device=graph["seeds"].device)
    w[torch.rand(e, generator=g, device=w.device) < 0.3] = 0.0
    topo = CSRTopo(indptr=graph["indptr"], indices=graph["indices"])
    seeds = graph["seeds"][graph["seeds"] >= 0][:200].contiguous()
    out = {}
    for mode in ("HBM", "HOST"):
        s = GraphSageSampler(topo, [5, 4, 3], mode=mode, seed=11,
                             edge_weight=w, with_eid=True, **kw)
        s.sample(seeds)
        torch.cuda.synchronize()
        fused.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = s.sample(seeds)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        out[mode] = (got, dict(fused.LAUNCHES))
        if mode == "HOST":
            assert s._weight_placed.is_pinned()
            # the heads, and the pool's weights, a span a seed
            spans = 6 if kw["sampling"] == "exact" else 3
            assert _build.ELEMS_LAUNCHES["gather_segments_kernel"] == spans
    (hbm, hbm_l), (host, host_l) = out["HBM"], out["HOST"]
    assert not any(hbm_l.values()), hbm_l
    assert host_l["gather_elems"] > 0
    assert (host_l["gather_rows"] > 0) == (kw["sampling"] != "exact")
    assert torch.equal(hbm[0], host[0]) and hbm[1] == host[1]
    for a, b in zip(hbm[2], host[2]):
        assert torch.equal(a.edge_index, b.edge_index)
        assert torch.equal(a.e_id, b.e_id) and a.size == b.size
        assert bool((w[a.e_id[a.mask].long()] > 0).all())


def test_gat_forward_backward_on_card_equals_cpu(graph):
    """GAT on a sampled block: logits and every gradient on the card
    within 1e-4 (of the largest entry) of the same model on the CPU."""
    from quiver_tpu_torch import GAT
    sizes = [4, 3]
    seeds = graph["seeds"][:64].contiguous()
    _, layers, x = fused.fused_multihop(
        graph["indptr"], graph["indices"], seeds, graph["feat"], sizes,
        [5, 6], ROW_CAP)
    adjs = layers_to_adjs(layers, 64, sizes)
    torch.manual_seed(0)
    model = GAT(WIDE, 16, 7, 2, heads=4, dropout=0.0).to(graph["seeds"].device)
    cpu = copy.deepcopy(model).cpu()
    labels = torch.arange(64, device=x.device) % 7
    res = []
    for m, dev in ((model, x.device), (cpu, torch.device("cpu"))):
        m.train()
        logits = m(x.to(dev), [a.to(dev) for a in adjs])
        torch.nn.functional.cross_entropy(logits[:64],
                                          labels.to(dev)).backward()
        res.append((logits.detach().cpu(),
                    {n: p.grad.cpu() for n, p in m.named_parameters()}))
    (lg, gg), (lc, gc) = res
    torch.testing.assert_close(lg, lc, atol=1e-4, rtol=1e-4)
    for n, g in gg.items():
        assert float((g - gc[n]).abs().max()) <= \
            1e-4 * max(float(gc[n].abs().max()), 1e-30), n


# -- device counters, rotation and ShardTensor --------------------------------

@pytest.mark.parametrize("budget", [None, 64])
def test_metered_lookup_runs_without_host_sync(graph, budget):
    """The offload store's metered lookup on the card: no host
    synchronisation, the counters on the card and equal to the same
    store's on the CPU, the rows those of the unmetered lookup."""
    card, cpu = _stores(graph, dedup_cold=True, cold_budget=budget)
    ids = torch.cat([graph["seeds"], graph["seeds"][:500]]).contiguous()
    for masked in (False, True):
        q = ids if masked else ids.clamp(min=0)
        plain = card.lookup_tiered(q, masked=masked)
        rows, vec = _sync_free(lambda: card.lookup_tiered(
            q, masked=masked, collect_metrics=True))
        assert vec.device.type == "cuda" and vec.dtype == torch.int32
        _, want = cpu.lookup_tiered(q.cpu(), masked=masked,
                                    collect_metrics=True)
        assert torch.equal(vec.cpu(), want)
        assert torch.equal(_bits(rows.cpu()), _bits(plain.cpu()))


def _deterministic(fn):
    """``fn()`` with torch's deterministic algorithms (the model's
    ``index_add_`` sums in a fixed order instead of by atomics), so two
    runs can be compared bit for bit."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


def _sync_free(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_metered_steps_and_sampler_run_without_host_sync(graph):
    """The metered fused train step, the metered tiered engine and the
    metered sampler (HBM and HOST) on the card: no host
    synchronisation, counters equal to the CPU's on the same hop seeds,
    losses, logits and samples equal to the unmetered ones (under
    deterministic algorithms)."""
    from quiver_tpu_torch import metrics
    sizes, bs = [4, 3], 64
    seeds = graph["seeds"][graph["seeds"] >= 0][:bs].contiguous()
    labels = torch.arange(bs, device=seeds.device, dtype=torch.int32) % 5
    feat = graph["feat"][:, :DIM].contiguous()
    model = GraphSAGE(DIM, 16, 5, 2, dropout=0.0).cuda()
    args = (feat, None, graph["indptr"], graph["indices"], seeds, labels,
            [5, 6], 7)
    outs = {}
    for metered in (True, False):
        m = copy.deepcopy(model)
        opt = torch.optim.Adam(m.parameters(), lr=1e-3)
        step = build_train_step(m, opt, sizes, bs, fused_hot_hop=True,
                                fused_row_cap=ROW_CAP,
                                collect_metrics=metered)
        outs[metered] = _deterministic(lambda: step(init_state(m, opt),
                                                    *args))
        outs[metered] += ([p.detach().clone() for p in m.parameters()],)
        if metered:
            _sync_free(lambda: step(init_state(m, opt), *args))
    assert torch.equal(outs[True][1], outs[False][1])
    assert all(torch.equal(a, b) for a, b in zip(outs[True][-1],
                                                  outs[False][-1]))
    vec = outs[True][2].cpu()
    n_id, _, _ = fused.fused_multihop(graph["indptr"], graph["indices"],
                                      seeds, feat, sizes, [5, 6], ROW_CAP)
    assert int(vec[metrics.FRONTIER_VALID]) == int((n_id >= 0).sum())
    assert int(vec[metrics.FRONTIER_CAP]) == n_id.shape[0]

    card, cpu = _stores(graph, dedup_cold=True)
    topo = (graph["indptr"], graph["indices"])
    state = GraphSAGE(DIM, 16, 5, 2).state_dict()
    mk = lambda store, dev, metered: ServeEngine(
        GraphSAGE(DIM, 16, 5, 2), state,
        topo if dev is None else tuple(t.cpu() for t in topo), store,
        [[4, 3]], 64, fused_hot_hop=True, fused_row_cap=ROW_CAP,
        collect_metrics=metered, device=dev)
    eng, ref = mk(card, None, True), mk(cpu, "cpu", True)
    ids = torch.arange(20, 60, dtype=torch.int32, device="cuda")
    eng.run(ids, hop_seeds=[3, 4])
    _sync_free(lambda: eng.run(ids, hop_seeds=[3, 4]))
    out = _deterministic(lambda: eng.run(ids, hop_seeds=[3, 4]))
    plain = mk(card, None, False)
    assert torch.equal(out, _deterministic(
        lambda: plain.run(ids, hop_seeds=[3, 4])))
    ref.run(ids.cpu(), hop_seeds=[3, 4])
    assert torch.equal(eng.last_counters.cpu(), ref.last_counters)

    for mode in ("HBM", "HOST"):
        s = GraphSageSampler(CSRTopo(indptr=graph["indptr"],
                                     indices=graph["indices"]), [5, 4],
                             mode=mode, seed=2, collect_metrics=True)
        s.sample(seeds)
        n_id, _, _ = _sync_free(lambda: s.sample(seeds))
        vec = s.last_counters.cpu()
        assert int(vec[metrics.FRONTIER_VALID]) == int((n_id >= 0).sum())
        assert int(vec[metrics.FRONTIER_CAP]) == n_id.shape[0]


def test_rotation_on_the_card(graph):
    """``rotate_hot_set`` on a numpy-placement store on the card: lookups
    give the same bits before and after, an engine serves the old store
    until ``refresh_feature`` and the same logits after it."""
    topo = CSRTopo(indptr=graph["indptr"], indices=graph["indices"])
    feat = graph["feat"][:, :DIM].cpu().numpy()
    store = Feature(device_cache_size=(N // 4) * (DIM + 8), csr_topo=topo,
                    dtype_policy="int8").from_cpu_tensor(feat)
    ids = torch.cat([graph["seeds"], graph["seeds"][:300]]).contiguous()
    before = store.getitem_masked(ids)
    eng = ServeEngine(GraphSAGE(DIM, 16, 5, 2), None,
                      (graph["indptr"], graph["indices"]), store,
                      [[4, 3]], 64, fused_hot_hop=True,
                      fused_row_cap=ROW_CAP)
    q = torch.arange(20, 60, dtype=torch.int32)
    run = lambda: _deterministic(lambda: eng.run(q, hop_seeds=[3, 4]))
    want = run()
    order = store.feature_order.cpu().numpy()
    promote = np.flatnonzero(order >= store.cache_rows)[:50]
    demote = np.flatnonzero(order < store.cache_rows)[-50:]
    assert store.rotate_hot_set(promote, demote) == {"rotated": 50}
    assert torch.equal(_bits(store.getitem_masked(ids).cpu()),
                       _bits(before.cpu()))
    assert torch.equal(run(), want)
    eng.refresh_feature()
    assert torch.equal(run(), want)


@pytest.mark.parametrize("policy", [None, "bf16", "int8"])
def test_shard_tensor_host_group_equals_plain(graph, policy):
    """The device groups and the pinned host group, read by the card in
    one ``gather_rows_sharded`` launch, equal the same store on the CPU
    bit for bit, with no host synchronisation."""
    from quiver_tpu_torch import ShardTensor
    feat = graph["feat"][:, :WIDE].cpu()
    stores = {}
    for dev in ("cuda", "cpu"):
        st = ShardTensor(dtype_policy=policy, device=dev)
        st.append(feat[:700], 0)
        st.append(feat[700:2000], -1)
        st.append(feat[2000:2500], 1)
        st.append(feat[2500:], -1)
        stores[dev] = st
    assert all(t.is_pinned() for t in quant.tier_parts(
        stores["cuda"]._blocks[1]) if t is not None)
    ids = torch.cat([graph["seeds"].long(),
                     torch.tensor([N, N + 5, -3], device="cuda")])
    fused.reset_launches()
    got = _sync_free(lambda: stores["cuda"][ids])
    # every group, the card's and the pinned host's, in one launch
    assert fused.LAUNCHES["gather_rows_sharded"] == 1
    assert sum(fused.LAUNCHES.values()) == 1
    assert torch.equal(_bits(got.cpu()), _bits(stores["cpu"][ids.cpu()]))


def test_pickled_offload_store_on_the_card(graph):
    """A card store pickles with its pinned tier as a CPU copy and comes
    back on the card, pinned and packed again, looking up the same bits."""
    import pickle
    card, _ = _stores(graph, dedup_cold=True, cold_budget=64)
    back = pickle.loads(pickle.dumps(card))
    assert back.device_part.data.is_cuda and back.feature_order.is_cuda
    assert back._host_offload.data.is_pinned()
    assert back._host_offload.data.stride(0) == card._host_offload.data \
        .stride(0)
    ids = torch.cat([graph["seeds"], graph["seeds"][:500]]).contiguous()
    assert torch.equal(_bits(back.lookup_tiered(ids, masked=True)),
                       _bits(card.lookup_tiered(ids, masked=True)))
    assert (back.cold_budget, back.dedup_cold) == (64, True)


# -- the host side: staging, the native engine, the mixed sampler -------------


def test_prefetch_on_the_worker_stream_without_sync(graph):
    """``Feature.prefetch`` runs the tiered lookup on the pipeline's own
    stream, with no host synchronisation on either thread, and the rows
    read on the caller's stream equal the lookup's."""
    card, cpu = _stores(graph, dedup_cold=True)
    ids = [torch.cat([graph["seeds"], graph["seeds"][:i * 100]]).clamp(min=0)
           .contiguous() for i in range(1, 5)]
    want = [card[i] for i in ids]
    fused.reset_launches()
    got = _sync_free(lambda: [f.result(timeout=60) for f in
                              [card.prefetch(i) for i in ids]])
    assert fused.LAUNCHES["gather_rows"] > 0
    assert card._stage_stream is not None
    assert card._stage_stream != torch.cuda.current_stream()
    for g, w, i in zip(got, want, ids):
        assert torch.equal(_bits(g), _bits(w))
        assert torch.equal(_bits(g.cpu()), _bits(cpu[i.cpu()]))
    card.close()


def test_cpu_mode_on_the_card_equals_the_cpu(graph):
    """CPU mode with its batch put on the card (one pinned buffer, one
    copy) gives the CPU device's sample bit for bit."""
    topo = CSRTopo(indptr=graph["indptr"], indices=graph["indices"])
    seeds = graph["seeds"][:300]
    outs = [GraphSageSampler(topo, [5, 3], device=dev, mode="CPU", seed=3,
                             with_eid=True).sample(seeds)
            for dev in ("cuda", "cpu")]
    assert outs[0][0].is_cuda and torch.equal(outs[0][0].cpu(), outs[1][0])
    for a, b in zip(outs[0][2], outs[1][2]):
        assert a.edge_index.is_cuda
        assert torch.equal(a.edge_index.cpu(), b.edge_index)
        assert torch.equal(a.e_id.cpu(), b.e_id)


@pytest.mark.parametrize("device_mode", ["HBM", "HOST"])
def test_mixed_on_the_card(graph, device_mode):
    from quiver_tpu_torch import MixedGraphSageSampler, SampleJob

    class Job(SampleJob):
        def __init__(self):
            perm = torch.randperm(N, generator=torch.Generator()
                                  .manual_seed(0)).to(torch.int32)
            self.b = [perm[i * 100:(i + 1) * 100] for i in range(24)]

        def __getitem__(self, i):
            return self.b[i]

        def __len__(self):
            return len(self.b)

        def shuffle(self):
            pass

    topo = CSRTopo(indptr=graph["indptr"], indices=graph["indices"])
    m = MixedGraphSageSampler(Job(), [5, 3], topo, device_mode=device_mode,
                              num_workers=2)
    fused.reset_launches()
    try:
        outs = list(m)
    finally:
        m.close()
    assert len(outs) == 24 and all(o[0].is_cuda for o in outs)
    assert sorted(tuple(o[0][:100].tolist()) for o in outs) == \
        sorted(tuple(b.tolist()) for b in Job().b)
    assert m.tasks["cpu"] >= 1
    host_reads = fused.LAUNCHES["gather_elems"] + fused.LAUNCHES["gather_rows"]
    assert (host_reads > 0) == (device_mode == "HOST")


def test_layerwise_inference_on_the_card_equals_the_cpu(graph):
    from quiver_tpu_torch import inference
    model = GraphSAGE(WIDE, 32, 7, 2).to("cuda")
    args = dict(batch_size=512, max_degree=64)
    got = inference.layerwise_inference(
        inference.sage_apply_layer(model), graph["indptr"], graph["indices"],
        graph["feat"], 2, **args)
    want = inference.layerwise_inference(
        inference.sage_apply_layer(copy.deepcopy(model).cpu()),
        graph["indptr"].cpu(), graph["indices"].cpu(), graph["feat"].cpu(),
        2, **args)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


# -- the disk tier: the staging ring read by the card ---------------------------


def _disk_stores(graph, tmp_path, **pf):
    """The graph's features as an int8 disk-tier artifact (a quarter of
    the rows hot, ``graph["forder"]`` as the node order), loaded on the
    card (with ``pf`` the cold prefetcher) and on the CPU."""
    from quiver_tpu_torch.partition import (load_disk_tier_store,
                                            save_disk_tier)
    d = str(tmp_path / "disk")
    save_disk_tier(graph["feat"].cpu(), np.arange(N), d, dtype_policy="int8")
    stores = {}
    for dev in ("cuda", "cpu"):
        s, _ = load_disk_tier_store(d, hot_rows=N // 4, device=dev,
                                    **({"prefetch_rows": pf.pop("rows"),
                                        **pf} if pf and dev == "cuda"
                                       else {}))
        s.set_local_order(graph["forder"].cpu())
        stores[dev] = s
    return stores


@pytest.mark.parametrize("decode_staged", [True, False])
def test_disk_ring_gather_equals_plain(graph, tmp_path, decode_staged):
    """The ring in pinned memory, read by ``gather_rows`` on the card
    (decoded fp32 rows, or packed int8 rows decoded by the kernel),
    equals the plain gather over the same ring and the store on the
    CPU, masked and not, bit for bit."""
    from quiver_tpu_torch.ops.kernels.gather import gather_rows_plain
    stores = _disk_stores(graph, tmp_path, rows=2 * N,
                          decode_staged=decode_staged, workers=2)
    card, cpu = stores["cuda"], stores["cpu"]
    ring = card._cold_prefetch._ring
    data = ring.table.data if decode_staged is False else ring.table
    assert data.is_pinned()
    for i in range(4):
        ids = graph["seeds"][i * 200:(i + 1) * 200 + 300].contiguous()
        card.stage_frontier(ids).result(timeout=60)
        fused.reset_launches()
        got = card.getitem_masked(ids)
        torch.cuda.synchronize()
        assert fused.LAUNCHES["gather_rows"] >= 1
        assert torch.equal(_bits(got.cpu()),
                           _bits(cpu.getitem_masked(ids.cpu())))
    slots = torch.from_numpy(ring._slot_of[ring.ids[ring.ids >= 0]]) \
        .to(torch.int32)
    want = gather_rows_plain(ring.table, slots)
    got = gather.gather_rows(ring.table, slots.cuda())
    assert torch.equal(_bits(got.cpu()), _bits(want))
    assert card._cold_prefetch.stats()["hit_rows"] > 0
    card.close()


def test_disk_ring_fence_holds_under_wraparound(graph, tmp_path):
    """A ring of 1.05x one batch's unique cold rows with the stager
    publishing the next batch while the card still reads the current
    one: every lookup equals the CPU store bit for bit."""
    order = graph["forder"].cpu().numpy()
    batches = [torch.from_numpy(np.random.default_rng(s).choice(
        N, 900, replace=False).astype(np.int32)).cuda() for s in range(17)]
    cold = max(int((order[b.cpu().numpy()] >= N // 4).sum())
               for b in batches)
    stores = _disk_stores(graph, tmp_path, rows=int(cold * 1.05),
                          workers=2)
    card, cpu = stores["cuda"], stores["cpu"]
    card.stage_frontier(batches[0]).result(timeout=60)
    outs = []
    for i in range(16):
        card.stage_frontier(batches[i + 1])
        outs.append(card[batches[i]])
    torch.cuda.synchronize()
    for b, o in zip(batches, outs):
        assert torch.equal(_bits(o.cpu()), _bits(cpu[b.cpu()]))
    st = card._cold_prefetch.stats()
    assert st["hit_rows"] > 0
    card.close()


def test_events_on_the_ids_device_with_two_cards(graph):
    """With two cards, ``Feature.prefetch`` and the prefetcher's id copy
    record their events on the second card's stream: the rows are the
    lookup's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from quiver_tpu_torch import prefetch
    dev = torch.device("cuda", 1)
    feat = graph["feat"].cpu()
    store = Feature(device_cache_size=(N // 4) * WIDE * 4,
                    host_placement="offload", device=dev) \
        .from_cpu_tensor(feat)
    ids = graph["seeds"].clamp(min=0).to(dev)
    assert torch.equal(store.prefetch(ids).result(timeout=60), store[ids])
    host, ready = prefetch._snapshot(ids)
    ready.synchronize()
    assert torch.equal(host, ids.cpu())
    store.close()


class _Recorded:
    """An engine as ``MicroBatchServer`` sees it, drawing each batch's
    hop seeds itself so the batch can be replayed, and recording the
    executor thread's current card."""

    def __init__(self, eng):
        self._eng = eng
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def run(self, seeds, variant=0):
        hs = self._eng.draw_hop_seeds(len(self._eng.variants[variant]))
        self.calls.append((seeds.copy(), variant, hs,
                           torch.cuda.current_device()))
        return self._eng.run(seeds, variant, hop_seeds=hs)


def _server_engine(graph, dev):
    topo = CSRTopo(indptr=graph["indptr"].to(dev),
                   indices=graph["indices"].to(dev), device=dev)
    feat = quant.quantize(graph["feat"][:, :DIM].contiguous().to(dev),
                          "int8")
    return ServeEngine(GraphSAGE(DIM, 16, 5, 2), None, topo, feat, [[4, 3]],
                       64, fused_hot_hop=True, fused_row_cap=ROW_CAP,
                       device=dev).warmup()


def _served_rows(eng, ids, batches):
    """Serve ``batches`` staged batches of ``ids`` through a server over
    ``eng``; every row checked against its batch's replay."""
    from quiver_tpu_torch import MicroBatchServer, ServeConfig
    rec = _Recorded(eng)
    srv = MicroBatchServer(rec, ServeConfig(max_wait_ms=50.0,
                                            queue_depth=512,
                                            shed_queue_frac=1.0),
                           start=False)
    futs = [srv.submit(int(i)) for i in ids]
    srv.start()
    rows = [f.result(timeout=60) for f in futs]
    srv.close()
    assert len(rec.calls) == batches
    for (seeds, v, hs, _), k in zip(rec.calls, range(batches)):
        want = eng.run(seeds, v, hop_seeds=hs).cpu().numpy()
        for j in range(k * 64, min((k + 1) * 64, len(ids))):
            np.testing.assert_allclose(rows[j], want[j - k * 64],
                                       atol=1e-4, rtol=1e-4)
    return rows, rec


def test_server_readback_gives_each_batch_its_rows(graph):
    """Two batches read back to two host arrays: no row of the first
    is a view into the second's array, and the first batch's rows keep
    their values after the second lands."""
    eng = _server_engine(graph, graph["seeds"].device)
    ids = np.arange(20, 148)                 # two full batches of 64
    rows, _ = _served_rows(eng, ids, 2)
    kept = [r.copy() for r in rows[:64]]
    assert all(isinstance(r, np.ndarray) for r in rows)
    assert not np.shares_memory(rows[0], rows[64])
    _served_rows(eng, np.arange(200, 264), 1)
    assert all(np.array_equal(a, b) for a, b in zip(kept, rows[:64]))


def test_server_executor_serves_the_last_card(graph):
    """An engine on the last visible card: the executor thread enters
    that card before each run, and the rows are its batch's."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", n - 1)
    eng = _server_engine(graph, dev)
    assert eng.device == dev
    _, rec = _served_rows(eng, np.arange(20, 84), 1)
    assert [c[3] for c in rec.calls] == [n - 1]


def test_server_failing_run_fails_its_futures_without_retry(graph):
    """A batch whose ``engine.run`` raises fails its futures with that
    exception, runs nowhere else, and the next batch serves on the
    card."""
    from quiver_tpu_torch import MicroBatchServer, ServeConfig
    eng = _server_engine(graph, graph["seeds"].device)
    real, calls = eng.run, []

    def boom(seeds, variant=0, hop_seeds=None):
        calls.append(seeds.copy())
        raise RuntimeError("the card fell over")

    eng.run = boom
    srv = MicroBatchServer(eng, ServeConfig(max_wait_ms=5.0), start=False)
    try:
        futs = [srv.submit(i) for i in range(20, 30)]
        srv.start()
        for f in futs:
            with pytest.raises(RuntimeError, match="fell over"):
                f.result(timeout=60)
        assert len(calls) == 1
        eng.run = real
        row = srv.submit(31).result(timeout=60)
        assert row.shape == (5,) and np.isfinite(row).all()
        s = srv.snapshot()["serving"]
        assert s["failed"] == 10 and s["completed"] == 1
    finally:
        srv.close()


# -- the fleet's control plane ---------------------------------------------------

def _metered_engine(graph, dev):
    topo = CSRTopo(indptr=graph["indptr"], indices=graph["indices"],
                   device=dev)
    store = Feature(device_cache_size=(N // 4) * quant.row_bytes(WIDE,
                                                                "int8"),
                    csr_topo=topo, dtype_policy="int8",
                    host_placement="offload", device=dev) \
        .from_cpu_tensor(graph["feat"].cpu())
    return ServeEngine(GraphSAGE(WIDE, 16, 5, 2), None, topo, store,
                       [[4, 3]], 64, fused_hot_hop=True,
                       fused_row_cap=ROW_CAP, collect_metrics=True,
                       device=dev).warmup(), store


def test_fleet_hub_records_card_counters_without_a_sync(graph):
    """``TelemetryHub.observe_counters`` and ``observe_step`` over the
    metered engine's counter vectors on the card, under
    ``set_sync_debug_mode("error")``: no host synchronisation; after
    ``flush`` the totals equal ``metrics.reduce_counters`` of the same
    vectors, and the newest vector was never read before it."""
    from quiver_tpu_torch import metrics
    from quiver_tpu_torch.telemetry import TelemetryHub
    dev = graph["seeds"].device
    eng, store = _metered_engine(graph, dev)
    hub = TelemetryHub(fold_every=4, watches=())
    vecs = []
    seeds = [graph["seeds"][i * 64:(i + 1) * 64] for i in range(12)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i, s in enumerate(seeds):
            eng.run(s)
            if i % 2:
                hub.observe_step(0.001, eng.last_counters)
            else:
                hub.observe_counters(eng.last_counters)
            vecs.append(eng.last_counters.clone())
        _, c = store.lookup_tiered(graph["seeds"].clamp(min=0),
                                   collect_metrics=True)
        hub.observe_counters(c)
        vecs.append(c.clone())
        pending = len(hub._pending)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pending >= 1
    hub.flush()
    want = metrics.reduce_counters(torch.stack(vecs))
    np.testing.assert_array_equal(hub.counters(), want)
    assert hub.series["step_ms"].total == 6


def test_fleet_replica_on_the_card(graph):
    """A replica as phase 16 runs one, at this graph's size: a metered
    engine on the card behind ``MicroBatchServer`` (a ``TelemetryHub``
    as its hub, the default tenant classes), ``RpcServer`` and a
    ``TailSampler``; an ``RpcClient`` looks up 96 nodes under trace
    contexts, every row equal to its batch replayed with the batch's
    hop seeds, the hub's totals equal to the engine's counters, and a
    kept trace carries the client's id."""
    from quiver_tpu_torch import (MicroBatchServer, ServeConfig,
                                  default_tenant_classes, rpc, tracing)
    from quiver_tpu_torch import metrics
    from quiver_tpu_torch.tailsampling import TailSampler
    from quiver_tpu_torch.telemetry import TelemetryHub
    dev = graph["seeds"].device
    eng, _ = _metered_engine(graph, dev)
    rec = _Recorded(eng)
    hub = TelemetryHub(watches=())
    kept = []

    class Keep:
        def emit(self, r, kind=None):
            kept.append(r)
            return r
    srv = MicroBatchServer(rec, ServeConfig(max_wait_ms=5.0), hub=hub,
                           tenants=default_tenant_classes(1000.0))
    sampler = TailSampler(sink=Keep(), head_rate=1.0).attach()
    front = rpc.RpcServer(srv, host="127.0.0.1", port=0)
    cli = rpc.RpcClient({"r0": ("127.0.0.1", front.port)}, retries=0,
                        hedge=False)
    try:
        nodes = [int(v) for v in np.arange(100, 196)]
        futs = [cli.lookup_future(n, budget_ms=30000.0,
                                  tenant="interactive") for n in nodes]
        rows = [f.result(timeout=120) for f in futs]
    finally:
        cli.close()
        front.close()
        srv.close()
        sampler.detach()
        tracing.disable()
        tracing.clear()
    where = {}
    for k, (s, _, _, _) in enumerate(rec.calls):
        for slot, nid in enumerate(s.tolist()):
            if nid >= 0:
                where[nid] = (k, slot)
    replay = {}
    for n, row in zip(nodes, rows):
        k, slot = where[n]
        if k not in replay:
            s, v, hs, _ = rec.calls[k]
            replay[k] = eng.run(s, v, hop_seeds=hs).cpu().numpy()
        np.testing.assert_allclose(row, replay[k][slot], atol=1e-4,
                                   rtol=1e-4)
    hub.flush()
    assert hub.counters()[metrics.COLD_ROWS] > 0
    assert any(r["root"] == "serve.request" for r in kept)
    assert any(r["root"] == "rpc.lookup" for r in kept)
    ids = {r["trace_id"] for r in kept if r["root"] == "serve.request"}
    assert ids & {r["trace_id"] for r in kept if r["root"] == "rpc.lookup"}


# -- heterogeneous graphs -------------------------------------------------------

HETERO = {"paper": 3000, "author": 1000, "inst": 100}
H_CITES = ("paper", "cites", "paper")
H_WRITES = ("author", "writes", "paper")
H_EMPLOYS = ("inst", "employs", "author")
H_DIM = 768                        # MAG240M's width: 896-byte packed rows


@pytest.fixture(scope="module")
def hetero():
    """A MAG240M-shaped typed graph at a small node count, 768-wide
    features, as numpy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = np.random.default_rng(2)

    def rel(n_dst, n_src, avg):
        deg = g.integers(1, 2 * avg, n_dst)
        indptr = np.zeros(n_dst + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        return indptr, g.integers(0, n_src, int(indptr[-1])).astype(np.int32)
    raw = {H_CITES: rel(3000, 3000, 20), H_WRITES: rel(3000, 1000, 3),
           H_EMPLOYS: rel(1000, 100, 2)}
    feats = {t: g.standard_normal((c, H_DIM)).astype(np.float32)
             for t, c in HETERO.items()}
    return raw, feats


def _hetero_parts(hetero, dev):
    """The typed topology and the stores on ``dev``: papers int8 with a
    quarter hot by cites degree and the rest pinned (offload), a cold
    budget above any frontier (one host read a lookup), the other types
    whole on the device."""
    from quiver_tpu_torch import HeteroCSRTopo, HeteroFeature
    raw, feats = hetero
    topo = HeteroCSRTopo({et: CSRTopo(indptr=ip, indices=ix, device=dev)
                          for et, (ip, ix) in raw.items()}, HETERO)
    store = HeteroFeature.from_cpu_tensors(
        feats, configs={"paper": dict(
            device_cache_size=(HETERO["paper"] // 4) * (H_DIM + 8),
            csr_topo=topo.rels[H_CITES], dtype_policy="int8",
            host_placement="offload", dedup_cold=True,
            cold_budget=1 << 20)},
        default=dict(device_cache_size="1G", device=dev))
    return topo, store


@pytest.mark.parametrize("policy", [None, "int8"])
def test_store_from_a_card_table_equals_the_host_build(hetero, policy):
    """``Feature.from_cpu_tensor`` given the table on the card (permuted
    and quantized there) stores the bits of the build from the host
    table, both tiers, and looks up the same rows."""
    raw, feats = hetero
    topo = CSRTopo(indptr=raw[H_CITES][0], indices=raw[H_CITES][1])
    stores = [Feature(device_cache_size=(HETERO["paper"] // 4) * H_DIM,
                      csr_topo=topo, dtype_policy=policy,
                      host_placement="offload").from_cpu_tensor(t)
              for t in (feats["paper"],
                        torch.from_numpy(feats["paper"]).cuda())]
    a, b = stores
    assert a.cache_rows == b.cache_rows > 0
    for x, y in zip(quant.tier_parts(a.device_part),
                    quant.tier_parts(b.device_part)):
        if x is not None:
            assert y.is_cuda and torch.equal(_bits(x), _bits(y))
    for x, y in zip(quant.tier_parts(a._host_offload),
                    quant.tier_parts(b._host_offload)):
        if x is not None:
            assert y.is_pinned() and torch.equal(_bits(x), _bits(y))
    ids = torch.randperm(HETERO["paper"], device="cuda")[:1000]
    assert torch.equal(_bits(a[ids]), _bits(b[ids]))


def test_hetero_sample_and_lookup_without_host_sync(hetero):
    """The typed sampler and the stores' lookup on the card make no host
    synchronisation, launch the packed row gather, and look up the CPU
    stores' bits on the same frontier."""
    from quiver_tpu_torch import HeteroGraphSageSampler
    topo, store = _hetero_parts(hetero, "cuda")
    _, cpu_store = _hetero_parts(hetero, "cpu")
    assert store["paper"]._host_offload.data.stride(0) == 896
    seeds = torch.randperm(3000, generator=torch.Generator()
                           .manual_seed(0))[:256].cuda()
    for kw in (dict(), dict(sampling="rotation", layout="overlap"),
               dict(edge_weight={H_CITES: np.ones(
                   hetero[0][H_CITES][1].shape[0], np.float32)},
                   with_eid=True)):
        s = HeteroGraphSageSampler(topo, [5, 3], seed_type="paper",
                                   frontier_cap={"inst": 100}, **kw)
        s.sample(seeds)                    # set-up: rows views, meta
        fused.reset_launches()
        _, _, layers = _sync_free(lambda: s.sample(seeds))
        x = _sync_free(lambda: store.lookup(layers[0].frontier))
        assert fused.LAUNCHES["gather_rows"] == 1
        want = cpu_store.lookup({t: None if f is None else f.cpu()
                                 for t, f in layers[0].frontier.items()})
        assert list(x) == list(want) == ["author", "inst", "paper"]
        for t in want:
            assert torch.equal(_bits(x[t].cpu()), _bits(want[t]))
    store.close()


@pytest.mark.parametrize("kind", ["packed", "fp32"])
def test_hetero_width_768_gather_equals_plain(hetero, kind):
    """The row gather at MAG240M's width over a pinned host tier (packed
    int8 rows of 896 bytes, or fp32 rows of 3,072), with and without
    ``out=`` and -1 ids, equal to its plain version bit for bit."""
    feat = torch.from_numpy(hetero[1]["paper"])
    tab = pinned_put(quant.quantize(feat, "int8") if kind == "packed"
                     else feat, torch.device("cuda"), "the test table")
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 3000, (20_000,), generator=g,
                        dtype=torch.int32).cuda()
    holes = torch.where(torch.arange(20_000, device="cuda") % 7 == 0, -1,
                        ids)
    fused.reset_launches()
    got = gather.gather_rows(tab, ids)
    assert torch.equal(_bits(got), _bits(gather.gather_rows_plain(tab, ids)))
    out = torch.full((20_000, H_DIM), 3.0, device="cuda")
    got = gather.gather_rows(tab, holes, out=out.clone())
    want = gather.gather_rows_plain(tab, holes, out=out.clone())
    assert torch.equal(_bits(got), _bits(want))
    assert fused.LAUNCHES["gather_rows"] == 2


def test_hetero_prefetch_on_the_ids_stream(hetero):
    """``HeteroFeature.prefetch`` records its event on the ids' card's
    current stream, looks up on that card's staging stream without a
    host synchronisation, and returns ``lookup``'s bits."""
    from quiver_tpu_torch import HeteroGraphSageSampler
    topo, store = _hetero_parts(hetero, "cuda")
    s = HeteroGraphSageSampler(topo, [5, 3], seed_type="paper")
    frontiers = [s.sample(torch.arange(i * 64, (i + 1) * 64).cuda())[2][0]
                 .frontier for i in range(3)]
    want = [store.lookup(f) for f in frontiers]
    got = _sync_free(lambda: [fut.result(timeout=60) for fut in
                              [store.prefetch(f) for f in frontiers]])
    dev = frontiers[0]["paper"].device
    assert set(store._streams) == {dev}
    assert store._streams[dev] != torch.cuda.current_stream(dev)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for t in w:
            assert torch.equal(_bits(g[t]), _bits(w[t]))
    store.close()


def test_hetero_prefetch_events_on_the_second_card(hetero):
    """With two cards, a store on the second card stages on that card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from quiver_tpu_torch import HeteroGraphSageSampler
    dev = torch.device("cuda", 1)
    topo, store = _hetero_parts(hetero, dev)
    s = HeteroGraphSageSampler(topo, [5, 3], seed_type="paper", device=dev)
    frontier = s.sample(torch.arange(64))[2][0].frontier
    got = store.prefetch(frontier).result(timeout=60)
    assert set(store._streams) == {frontier["paper"].device}
    for t, w in store.lookup(frontier).items():
        assert torch.equal(_bits(got[t]), _bits(w))
    store.close()


def test_rgcn_step_on_card_equals_cpu(hetero):
    """One R-GCN training step (cross-entropy over the seeds, Adam) on
    the card from a sampled block: the loss within 1e-4 and every
    gradient within 1e-4 of its largest entry of the same step on the
    CPU, both under torch's deterministic algorithms."""
    from quiver_tpu_torch import HeteroGraphSageSampler
    from quiver_tpu_torch.models import RGCN
    topo, store = _hetero_parts(hetero, "cuda")
    s = HeteroGraphSageSampler(topo, [5, 3], seed_type="paper")
    _, bs, layers = s.sample(torch.arange(128).cuda())
    x = store.lookup(layers[0].frontier)
    torch.manual_seed(0)
    model = RGCN({t: H_DIM for t in HETERO}, 64, 11, 2, "paper",
                 [list(lay.adjs) for lay in layers], dropout=0.0).cuda()
    cpu = copy.deepcopy(model).cpu()
    cpu_layers = [type(lay)(adjs={et: a.to("cpu")
                                  for et, a in lay.adjs.items()},
                            frontier={}, counts={}) for lay in layers]
    y = torch.arange(bs, device="cuda") % 11
    res = []
    for m, ls, dev in ((model, layers, "cuda"), (cpu, cpu_layers, "cpu")):
        def step():
            opt = torch.optim.Adam(m.parameters(), lr=1e-3)
            loss = torch.nn.functional.cross_entropy(
                m({t: v.to(dev) for t, v in x.items()}, ls)[:bs], y.to(dev))
            opt.zero_grad()
            loss.backward()
            grads = {n: p.grad.cpu() for n, p in m.named_parameters()}
            opt.step()
            return loss.item(), grads
        res.append(_deterministic(step))
    (lg, gg), (lc, gc) = res
    assert abs(lg - lc) <= 1e-4
    for n, g in gg.items():
        assert float((g - gc[n]).abs().max()) <= \
            1e-4 * max(float(gc[n].abs().max()), 1e-30), n
    store.close()


# -- the partitioned store across ranks ---------------------------------------


def _feat(graph, width):
    """The features at ``width``: the graph's (100 wide), or a table
    of that width drawn from the seed."""
    if width == WIDE:
        return graph["feat"]
    f = np.random.default_rng(width).standard_normal((N, width))
    return torch.from_numpy(f.astype(np.float32)).cuda()


def _exchange_blocks(graph, n, width=WIDE):
    """A packed int8 shard as the owner reads it (raw packed rows), owner
    read ids (clamped, in range) and an unbucket index with -1 slots, as
    the exchange's two ``gather_rows`` launches get them."""
    from quiver_tpu_torch import comm
    g = np.random.default_rng(n)
    q = quant.pack(quant.quantize(_feat(graph, width), "int8"),
                   device="cuda")
    raw = comm._wire_table(q)
    read = torch.from_numpy(g.integers(0, N, n).astype(np.int32)).cuda()
    idx = torch.from_numpy(np.where(g.random(n) < 0.3, -1,
                                    g.integers(0, n, n)).astype(np.int32))
    return q, raw, read, idx.cuda()


def _hbm_launches(fn, kernel):
    """``fn()``, and the launches of the packed ``kernel`` it made, which
    must be all the packed launches it made (the other design's none)."""
    before = dict(_build.PACKED_LAUNCHES)
    got = fn()
    made = {k: v - before[k] for k, v in _build.PACKED_LAUNCHES.items()}
    assert all(v == 0 for k, v in made.items() if k != kernel), made
    return got, made[kernel]


# widths: 100 (the served width), 768 (MAG240M's papers, 896-byte packed
# rows) and 7 (one code a thread: no float4 store)
@pytest.mark.parametrize("width", [WIDE, 768, 7])
@pytest.mark.parametrize("n", [1, 33, 270_336])
def test_exchange_gathers_equal_plain(graph, n, width):
    """The owner's read of raw packed rows and the unbucket-with-decode
    of the received block (``out=`` zeros, -1 slots) equal their plain
    versions bit for bit, the unbucket through the HBM design's kernel;
    the decoded rows equal the int8 tier's own gather; an fp32 shard's
    read too. The same block read with ids all -1 (out= untouched), in
    the lookup form with ids clamped into it (below 0 and past its end),
    and into a misaligned ``out`` (one code a thread)."""
    q, raw, read, idx = _exchange_blocks(graph, n, width)
    got = gather.gather_rows(raw, read)
    assert torch.equal(got, gather.gather_rows_plain(raw, read))
    block = quant.packed_views(got.view(torch.uint8), width)
    # a one-row block's views are contiguous: the separate-sidecar kernel
    # reads it, not a packed one
    packed = int(gather.packed_row_stride(block) is not None)
    assert packed == int(n > 1)
    out = torch.zeros((n, width), device="cuda")
    dec, made = _hbm_launches(lambda: gather.gather_rows(
        block, idx, out=out.clone()), "gather_rows_packed_hbm_kernel")
    assert made == packed
    want = gather.gather_rows_plain(block, idx, out=out.clone())
    assert torch.equal(_bits(dec), _bits(want))
    live = idx >= 0
    ref = gather.gather_rows(q, read[idx[live].long()])
    assert torch.equal(_bits(dec[live]), _bits(ref))
    assert not _bits(dec[~live]).any()
    feat = _feat(graph, width)
    assert torch.equal(gather.gather_rows(feat, read), feat[read.long()])

    none = torch.full_like(idx, -1)
    base = torch.full((n, width), 7.5, device="cuda")
    kept = gather.gather_rows(block, none, out=base.clone())
    assert torch.equal(_bits(kept), _bits(base))
    wild = torch.where(idx >= 0, idx, torch.where(read % 2 == 0, -5, n + 9))
    got, made = _hbm_launches(lambda: gather.gather_rows(block, wild),
                              "gather_rows_packed_hbm_kernel")
    assert made == packed
    assert torch.equal(_bits(got),
                       _bits(gather.gather_rows_plain(block, wild)))
    odd = _offset(torch.zeros((n, width), device="cuda"), 1)
    gather.gather_rows(block, idx, out=odd)
    assert torch.equal(_bits(odd), _bits(want))


def _lookup_world1(dev, group, feat, ids, cap, policy):
    from quiver_tpu_torch import DistFeature, PartitionInfo, TorchComm
    info = PartitionInfo(hosts=1, global2host=np.zeros(N, np.int32))
    d = DistFeature.from_partition(feat, info, TorchComm(0, 1, group=group),
                                   exchange_cap=cap, dtype_policy=policy,
                                   device=dev, collect_metrics=True)
    return d[ids.to(dev)].cpu(), d.last_counters.cpu()


@pytest.mark.parametrize("policy", [None, "int8"])
def test_world_size_one_nccl_lookup_equals_cpu(graph, tmp_path, policy):
    """A one-rank NCCL group on the card and a gloo group over the same
    rank on the CPU: the dense, compact and falling-back lookups give the
    same bits and counters, and the dense one makes no host
    synchronisation."""
    import torch.distributed as dist
    from quiver_tpu_torch import init_distributed
    ids = graph["seeds"].cpu()
    group = init_distributed("nccl", f"file://{tmp_path}/pg", 1, 0,
                             timeout=60)
    try:
        cpu_group = dist.new_group([0], backend="gloo")
        for cap in (None, 600, 4):
            got, c = _lookup_world1("cuda", group, graph["feat"], ids, cap,
                                    policy)
            want, wc = _lookup_world1("cpu", cpu_group, graph["feat"].cpu(),
                                      ids, cap, policy)
            assert torch.equal(_bits(got), _bits(want)) and torch.equal(c, wc)
        from quiver_tpu_torch import DistFeature, PartitionInfo, TorchComm
        d = DistFeature.from_partition(
            graph["feat"], PartitionInfo(hosts=1, global2host=np.zeros(
                N, np.int32)), TorchComm(0, 1, group=group),
            dtype_policy=policy)
        _sync_free(lambda: d[graph["seeds"]])
    finally:
        dist.destroy_process_group()


def _rank_two_cards(ctx, feat, ids, policy):
    """One rank of the two-card case: its half of the ids through the
    NCCL exchange, back on the host."""
    from quiver_tpu_torch import DistFeature, PartitionInfo, TorchComm
    g2h = (np.arange(N) % 2).astype(np.int32)
    d = DistFeature.from_partition(
        feat, PartitionInfo(host=ctx.rank, hosts=2, global2host=g2h),
        TorchComm(ctx.rank, 2, group=ctx.groups[2]), dtype_policy=policy,
        exchange_cap=256)
    half = ids.shape[0] // 2
    return d[ids[ctx.rank * half:(ctx.rank + 1) * half]].cpu()


def test_two_card_exchange_over_nccl(graph):
    """Two ranks over NCCL, one card each: the ids' rows, bit for bit
    (int8 against the tier's own gather)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from chip_smoke import RankPool
    ids = graph["seeds"].cpu()
    ids = ids[:ids.shape[0] // 2 * 2]
    feat = graph["feat"].cpu()
    with RankPool(2, backend="nccl", timeout=60) as pool:
        for policy in (None, "int8"):
            got = torch.cat([torch.as_tensor(r) for r in
                             pool.run(_rank_two_cards, feat, ids, policy)])
            table = quant.quantize(feat, policy) if policy else feat
            want = quant.gather_rows(table, ids.clamp(min=0))
            want[ids < 0] = 0
            assert torch.equal(_bits(got), _bits(want))


# -- the clique: one process over several allocations or cards ---------------


def _sharded(graph, kind, cuts, host_last=False):
    """A sharded tier over ``cuts`` of the features as ``kind`` (int8 at
    width w as ``int8_w``), its last block pinned on the host when
    ``host_last``, and the whole table."""
    from quiver_tpu_torch.ops.kernels import gather as g
    full = graph["feat"]
    if kind.startswith("int8_"):
        full = _feat(graph, int(kind.split("_")[1]))
        kind = "int8"
    if kind in ("bf16", "fp16"):
        full = full.to(torch.bfloat16 if kind == "bf16" else torch.float16)
    elif kind == "int8":
        full = quant.quantize(full, "int8")
    elif kind == "int8raw":
        full = (full * 20).to(torch.int8)
    blocks = []
    for s, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        b = quant.tree_map_tier(lambda t: t[lo:hi].contiguous(), full)
        host = host_last and s == len(cuts) - 2
        if quant.is_quantized(b):
            b = quant.pack(b, device="cpu" if host else "cuda", pin=host)
        elif host:
            b = b.cpu().pin_memory()
        blocks.append(b)
    dev = torch.device("cuda", torch.cuda.current_device())
    return g.prepare_sharded(quant.ShardedTier(blocks, cuts, dev)), full


def _sharded_kernel(tier):
    """The packed kernel a sharded int8 tier's reads launch (None for raw
    rows): the host design where a block is pinned, else the HBM
    design's."""
    if not quant.is_quantized(tier.shards[0]):
        return None
    on_host = any(quant.tier_parts(b)[0].device.type == "cpu"
                  for b in tier.shards)
    return gather.packed_kernel(on_host, sharded=True)


@pytest.mark.parametrize("host_last", [False, True], ids=["card", "host"])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "fp16", "int8raw",
                                  "int8", "int8_768", "int8_7"])
def test_gather_rows_sharded_equals_plain(graph, kind, host_last):
    """Both forms equal the plain version bit for bit (packed int8 at
    widths 100, 768 and 7 too: the HBM design's kernel over blocks on the
    card, the host design's with a pinned block), with ids at every block
    boundary, -1 and past the table (clamped in the lookup form, skipped
    with ``out=``), and with ids all -1."""
    tier, full = _sharded(graph, kind, [0, 700, 700, 1900, N], host_last)
    ids = torch.cat([graph["seeds"], torch.tensor(
        [0, 699, 700, 1899, 1900, N - 1, N + 7], dtype=torch.int32,
        device="cuda")])
    kernel = _sharded_kernel(tier)
    before = fused.LAUNCHES["gather_rows_sharded"]
    run = lambda: gather.gather_rows_sharded(tier, ids.clamp(min=0))
    if kernel is None:
        got = run()
    else:
        got, made = _hbm_launches(run, kernel)
        assert made == 1
    assert fused.LAUNCHES["gather_rows_sharded"] == before + 1
    want = gather.gather_rows_sharded_plain(tier, ids.clamp(min=0))
    assert torch.equal(_bits(got), _bits(want))
    wild = torch.where(ids >= 0, ids, -3)
    assert torch.equal(_bits(gather.gather_rows_sharded(tier, wild)),
                       _bits(gather.gather_rows_sharded_plain(tier, wild)))
    plain_full = quant.gather_rows(full, ids.clamp(0, N - 1))
    assert torch.equal(_bits(got), _bits(plain_full))
    base = torch.full(got.shape, 5, dtype=got.dtype, device="cuda")
    got = _sync_free(lambda: gather.gather_rows_sharded(tier, ids,
                                                        out=base.clone()))
    want = gather.gather_rows_sharded_plain(tier, ids, out=base.clone())
    assert torch.equal(_bits(got), _bits(want))
    got = gather.gather_rows_sharded(tier, torch.full_like(ids, -1),
                                     out=base.clone())
    assert torch.equal(_bits(got), _bits(base))


@pytest.mark.parametrize("host_last", [False, True], ids=["card", "host"])
@pytest.mark.parametrize("blocks", [65, 100])
@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_gather_rows_sharded_past_64_blocks(graph, kind, blocks, host_last):
    """65 and 100 blocks: the kernel reads the table from global memory
    instead of shared memory, and still equals its plain version and the
    whole table (packed int8 through the HBM design's kernel with every
    block on the card)."""
    cuts = np.linspace(0, N, blocks + 1).astype(int).tolist()
    tier, full = _sharded(graph, kind, cuts, host_last=host_last)
    ids = torch.cat([graph["seeds"], torch.tensor(
        cuts[1:-1] + [c - 1 for c in cuts[1:]], dtype=torch.int32,
        device="cuda")]).clamp(min=0)
    kernel = _sharded_kernel(tier)
    run = lambda: gather.gather_rows_sharded(tier, ids)
    if kernel is None:
        got = run()
    else:
        got, made = _hbm_launches(run, kernel)
        assert made == 1
    assert torch.equal(_bits(got),
                       _bits(gather.gather_rows_sharded_plain(tier, ids)))
    assert torch.equal(_bits(got), _bits(quant.gather_rows(full, ids)))


# -- raw rows: the loop and tile designs, each forced ----------------------

# (dtype, width): rows of 400 bytes (16-byte words), 200 (8-byte words in
# the tile design, 4-byte in the loop design), 512 (the int32 rows views),
# 3,072, 128 (the exchange's owner read), 20 (4-byte words), 6 (2-byte
# words) and 7 (1-byte words)
RAW_WIDTHS = [(torch.float32, 100), (torch.bfloat16, 100), (torch.int32, 128),
              (torch.float32, 768), (torch.int8, 128), (torch.float32, 5),
              (torch.float16, 3), (torch.int8, 7)]
RAW_CASES = [
    pytest.param(dtype, dim, where, design,
                 id=f"{str(dtype)[6:]}x{dim}-{where}-{design}")
    for dtype, dim in RAW_WIDTHS for where in ("device", "host")
    for design in gather.RAW_DESIGNS]


def _raw_table(card, dtype, dim, where, offset=0):
    """An ``[N, dim]`` table of ``dtype`` on the card or pinned, ``offset``
    elements past an aligned base when not 0."""
    g = torch.Generator(device=card).manual_seed(dim)
    t = (torch.randn(N, dim, generator=g, device=card) * 20).to(dtype)
    if where == "host":
        buf = torch.empty(t.numel() + offset, dtype=dtype).pin_memory()
    else:
        buf = torch.empty(t.numel() + offset, dtype=dtype, device=card)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _raw_made(before):
    return {k: v - before[k] for k, v in _build.RAW_LAUNCHES.items()
            if v != before[k]}


@pytest.mark.parametrize("dtype,dim,where,design", RAW_CASES)
def test_raw_design_equals_plain(card, monkeypatch, dtype, dim, where,
                                 design):
    """Each raw-row design, forced, on device and pinned tables at every
    word width: the lookup form (ids clamped) and ``out=`` with -1 ids
    (their rows left as they were), at 0, 1, 33 and 4,099 ids, bit for
    bit against the plain version; each launch counted under the
    design's kernel, none for no ids."""
    table = _raw_table(card, dtype, dim, where)
    monkeypatch.setattr(gather, "raw_design", lambda *a, **k: design)
    kernel = gather.raw_kernel(design)
    for n in (0, 1, 33, 4099):
        ids = _gather_ids(card, "holes", n)
        before = dict(_build.RAW_LAUNCHES)
        dense = ids.clamp(min=0)
        got = gather.gather_rows(table, dense)
        assert torch.equal(_bits(got),
                           _bits(gather.gather_rows_plain(table, dense)))
        out = torch.full((n, dim), 7, dtype=dtype, device=card)
        want = out.clone()
        assert gather.gather_rows(table, ids, out=out) is out
        gather.gather_rows_plain(table, ids, out=want)
        assert torch.equal(_bits(out), _bits(want))
        assert _raw_made(before) == ({kernel: 2} if n else {})
    torch.cuda.synchronize()


def test_raw_designs_refuse_what_they_do_not_take(card, monkeypatch):
    """No fallback: a design forced on words its kernel does not take
    (16-byte words over a base that is 4-byte aligned; 8-byte words in
    the loop design) raises instead of running another design."""
    table = _raw_table(card, torch.float32, 100, "device", offset=1)
    ids = torch.arange(8, dtype=torch.int32, device=card)
    monkeypatch.setattr(gather, "raw_word_bytes", lambda *a: 16)
    with pytest.raises(RuntimeError, match="launch failed"):
        gather.gather_rows(table, ids)
    monkeypatch.setattr(gather, "raw_design", lambda *a, **k: "loop")
    monkeypatch.setattr(gather, "raw_word_bytes", lambda *a: 8)
    with pytest.raises(RuntimeError, match="launch failed"):
        gather.gather_rows(_raw_table(card, torch.bfloat16, 100, "device"),
                           ids)


@pytest.mark.parametrize("design", list(gather.RAW_DESIGNS))
@pytest.mark.parametrize("blocks", [4, 100])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8raw"])
def test_raw_sharded_designs_equal_plain(graph, monkeypatch, kind, blocks,
                                         design):
    """Each raw-row design of ``gather_rows_sharded``, forced, over a
    table whose last block is pinned and the others on the card (4
    blocks, and 100: the block table read from global memory): the
    lookup form, ``out=`` with -1 ids and with no ids, bit for bit
    against the plain version and the whole table, each launch counted
    under the design's kernel."""
    cuts = np.linspace(0, N, blocks + 1).astype(int).tolist()
    tier, full = _sharded(graph, kind, cuts, host_last=True)
    monkeypatch.setattr(gather, "raw_design", lambda *a, **k: design)
    ids = torch.cat([graph["seeds"], torch.tensor(
        cuts[1:-1] + [c - 1 for c in cuts[1:]], dtype=torch.int32,
        device="cuda")])
    kernel = gather.raw_kernel(design, sharded=True)
    before = dict(_build.RAW_LAUNCHES)
    got = gather.gather_rows_sharded(tier, ids.clamp(min=0))
    assert torch.equal(_bits(got), _bits(gather.gather_rows_sharded_plain(
        tier, ids.clamp(min=0))))
    assert torch.equal(_bits(got), _bits(quant.gather_rows(
        full, ids.clamp(min=0))))
    base = torch.full(got.shape, 5, dtype=got.dtype, device="cuda")
    got = gather.gather_rows_sharded(tier, ids, out=base.clone())
    assert torch.equal(_bits(got), _bits(gather.gather_rows_sharded_plain(
        tier, ids, out=base.clone())))
    none = ids[:0]
    assert gather.gather_rows_sharded(tier, none, out=base[:0]).shape \
        == (0, got.shape[1])
    assert _raw_made(before) == {kernel: 2}
    torch.cuda.synchronize()


@pytest.mark.parametrize("where", ["device", "host"])
def test_raw_gathers_take_the_dispatched_design(graph, where):
    """Unforced, raw rows take :func:`gather.raw_design`'s choice: by the
    profiler's kernel names and the raw launch counts, for a flat table
    and a sharded one whose last block lies ``where``."""
    host = where == "host"
    flat = graph["feat"].cpu().pin_memory() if host else graph["feat"]
    tier, _ = _sharded(graph, "fp32", [0, 1000, 2000, N], host_last=host)
    ids = graph["seeds"].clamp(min=0)
    for sharded, fn in ((False, lambda: gather.gather_rows(flat, ids)),
                        (True, lambda: gather.gather_rows_sharded(tier,
                                                                  ids))):
        name = gather.raw_kernel(gather.raw_design(host), sharded)
        fn()
        fused.reset_launches()
        seen = _profiled_kernels(fn)
        assert _build.RAW_LAUNCHES[name] == 1
        assert sum(_build.RAW_LAUNCHES.values()) == 1
        hits = [s for s in seen if "gather_rows" in s]
        assert len(hits) == 1 and name in hits[0], seen


def _profiled_kernels(fn):
    """The names of the CUDA kernels ``fn()`` ran, by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize("where", ["card", "host"])
def test_packed_gathers_pick_their_design(graph, where):
    """Packed int8 rows on the card go through the HBM design's kernels,
    rows in pinned host memory (a flat tier, a sharded tier with one
    pinned block) through the host design's, by the profiler's kernel
    names and the packed launch counts."""
    host = where == "host"
    tier, _ = _sharded(graph, "int8", [0, 1000, 2000, N], host_last=host)
    flat = quant.pack(quant.quantize(graph["feat"], "int8"),
                      device="cpu" if host else "cuda", pin=host)
    ids = graph["seeds"].clamp(min=0)
    for name, fn in (
            (gather.packed_kernel(host, sharded=True),
             lambda: gather.gather_rows_sharded(tier, ids)),
            (gather.packed_kernel(host),
             lambda: gather.gather_rows(flat, ids))):
        fn()
        fused.reset_launches()
        seen = _profiled_kernels(fn)
        assert _build.PACKED_LAUNCHES[name] == 1
        assert sum(_build.PACKED_LAUNCHES.values()) == 1
        hits = [s for s in seen if "packed" in s]
        assert len(hits) == 1 and name in hits[0], seen


def _clique_stores(graph, policy, mesh_devices):
    from quiver_tpu_torch.parallel import make_mesh
    topo = CSRTopo(indptr=graph["indptr"], indices=graph["indices"])
    row = quant.row_bytes(WIDE, policy)
    kw = dict(csr_topo=topo, dtype_policy=policy, host_placement="offload",
              dedup_cold=True)
    n = len(mesh_devices)
    clique = Feature(device_cache_size=(N // 2 // n) * row,
                     cache_policy="p2p_clique_replicate",
                     mesh=make_mesh(("cache",), devices=mesh_devices),
                     **kw).from_cpu_tensor(graph["feat"].cpu())
    repl = Feature(device_cache_size=(N // 2 // n) * n * row,
                   **kw).from_cpu_tensor(graph["feat"].cpu())
    assert clique.sharded and clique.cache_rows == repl.cache_rows
    return topo, clique, repl


@pytest.mark.parametrize("policy", [None, "int8"])
def test_clique_store_on_the_card(graph, policy):
    """A clique of four allocations of this card: lookups equal the
    replicate store's bits, one ``gather_rows_sharded`` launch per hot
    read and no host synchronisation; the engine over it serves the
    replicate engine's logits (deterministic algorithms on)."""
    topo, clique, repl = _clique_stores(graph, policy, ["cuda"] * 4)
    ids = torch.cat([graph["seeds"], graph["seeds"][:300]]).contiguous()
    fused.reset_launches()
    got = _sync_free(lambda: clique.getitem_masked(ids))
    assert fused.LAUNCHES["gather_rows_sharded"] >= 1
    assert torch.equal(_bits(got), _bits(repl.getitem_masked(ids)))
    seeds = graph["seeds"][graph["seeds"] >= 0][:64]   # distinct, valid
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for fused_hot_hop in (True, False):
            a, b = (ServeEngine(GraphSAGE(WIDE, 16, 5, 2, dropout=0.0),
                                _sage_state(), topo, store, [[4, 3]], 64,
                                fused_hot_hop=fused_hot_hop,
                                fused_row_cap=ROW_CAP).run(
                                    seeds, hop_seeds=[3, 4])
                    for store in (clique, repl))
            assert torch.equal(_bits(a), _bits(b)), fused_hot_hop
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def _sage_state():
    torch.manual_seed(0)
    return GraphSAGE(WIDE, 16, 5, 2, dropout=0.0).state_dict()


def test_two_card_clique_reads_the_peer(graph):
    """A clique over two cards: peer access enabled by ``init_p2p``, the
    lookup on card 0 reads card 1's block in the same launch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import quiver_tpu_torch as qt
    topo = qt.init_p2p([0, 1])
    assert topo.get_clique_id(0) == topo.get_clique_id(1)
    _, clique, repl = _clique_stores(graph, "int8", ["cuda:0", "cuda:1"])
    assert clique.device_part.block_devices()[1] == torch.device("cuda", 1)
    ids = graph["seeds"]
    assert torch.equal(_bits(clique.getitem_masked(ids)),
                       _bits(repl.getitem_masked(ids)))


def _ipc_card_worker(handle, ids, want, out, done):
    try:
        from quiver_tpu_torch import Feature
        store = Feature.new_from_ipc_handle(0, handle)
        out.put(("ok", bool(torch.equal(_bits(store.getitem_masked(ids)),
                                        _bits(want)))))
    except Exception as e:
        out.put(("error", repr(e)))
    done.get(timeout=120)


def test_ipc_worker_on_the_card(graph):
    """A spawned worker opens an int8 clique store from ``share_ipc``
    (hot blocks by CUDA IPC, the cold tier in shared pages it pins
    again) and looks up the parent's bits."""
    import torch.multiprocessing as mp
    _, clique, _ = _clique_stores(graph, "int8", ["cuda"] * 4)
    ids = torch.cat([graph["seeds"], graph["seeds"][:300]]).contiguous()
    handle = clique.share_ipc()
    assert clique._host_offload.data.is_shared()
    assert clique._host_offload.data.is_pinned()
    want = clique.getitem_masked(ids)
    ctx = mp.get_context("spawn")
    out, done = ctx.Queue(), ctx.Queue()
    proc = ctx.Process(target=_ipc_card_worker,
                       args=(handle, ids, want, out, done))
    proc.start()
    try:
        status, equal = out.get(timeout=120)
    finally:
        done.put(None)
        proc.join(timeout=60)
    assert status == "ok" and equal is True, equal


# -- the verifier and the profiler on the card -------------------------------


@pytest.mark.parametrize("name", [
    "train_step", "lookup_tiered", "dist_lookup", "serve_step",
    "sharded_serve_step", "fused_hot_hop", "fused_multihop"])
def test_registry_entry_on_the_card(card, name):
    """A quick registry entry on ``cuda:0``: no ERROR, the recorder's
    host synchronisations equal to the card's sync debug mode's (and to
    the entry's declared count), and the wrappers' recorded calls equal
    to the launches counted."""
    from quiver_tpu_torch.analysis import registry
    specs = []
    findings, _ = registry.run_registry([name], device="cuda",
                                        specs_out=specs)
    assert [str(f) for f in findings if f.level == "ERROR"] == []
    for spec in specs:
        rec = spec.recording()
        assert spec.card_syncs == len(rec.syncs) == spec.host_syncs
        named = {"gather_segments": "gather_elems",
                 "sample_layer_kernel": "sample_layer"}
        calls: dict = {}
        for k, n in rec.kernel_names().items():
            calls[named.get(k, k)] = calls.get(named.get(k, k), 0) + n
        assert rec.launches == calls


@pytest.mark.parametrize("has_card", [True, False])
def test_machine_probe_on_the_card(has_card, monkeypatch):
    """``machine_probe(device="cuda")`` measures positive rates on the
    card, and raises where there is none (the CPU case)."""
    from quiver_tpu_torch.profile import machine_probe
    if not has_card:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            machine_probe(quick=True, device="cuda")
        return
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = machine_probe(quick=True, device="cuda")
    assert all(p[k] > 0 for k in ("memcpy_gbps", "gather_gbps",
                                  "h2d_gbps", "d2h_gbps"))
    assert p["platform"] == "gpu"
    assert p["device"] == torch.cuda.get_device_name(0)


# -- shared host tiers: a registration ends with its pages -------------------


def test_a_freed_shared_tier_leaves_no_stale_registration(card):
    """A shared host tier registered for the card (``share_host``) and
    then freed leaves no registration behind: the CUDA driver keeps one
    past the unmapping of its pages, so a new tier that the kernel maps
    at the same addresses could not be registered (CUDA error 712), and
    a copy from those addresses would read the old pages. Each new tier here
    registers, and reaches the card with its own bytes."""
    import gc
    from quiver_tpu_torch.utils.placement import share_host
    dev = torch.device("cuda", 0)
    n = 64 << 20          # a mapping of its own, whose addresses recur
    ptrs = []
    for i in range(4):
        tier = share_host(torch.full((n,), i + 1, dtype=torch.uint8), dev)
        ptrs.append(tier.data_ptr())
        got = tier.to(dev)
        assert bool((got == i + 1).all()), f"tier {i} at {ptrs[-1]:#x}"
        del tier, got
        gc.collect()


# -- the leak check on the card ----------------------------------------------


def test_check_leak_quick_on_the_card(card):
    """``python -m quiver_tpu_torch.check_leak --quick`` (the card by
    default) runs its 16 phases there and exits 0, one line a phase."""
    import subprocess
    import sys
    from pathlib import Path
    out = subprocess.run(
        [sys.executable, "-m", "quiver_tpu_torch.check_leak", "--quick"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [l for l in out.stdout.splitlines() if l.startswith("leak phase ")]
    assert len(lines) == 16 and all(
        torch.cuda.get_device_name(0) in l for l in lines)


def test_check_leak_segments_catch_small_blocks_on_the_card(card):
    """Small-pool blocks kept past the base take new 2 MB segments: the
    segment reading fails the probe beyond its one segment of slack,
    while the live and bytes readings stay inside their bounds."""
    from quiver_tpu_torch import check_leak
    dev = torch.device("cuda", 0)
    probe = check_leak.Probe(0, "planted small blocks", dev,
                             out_bytes=1 << 30)
    probe.base()
    kept = [torch.empty(1 << 20, dtype=torch.uint8, device=dev)
            for _ in range(check_leak.LIVE_SLACK)]
    with pytest.raises(check_leak.LeakError, match=r"small pool"):
        probe.end()
    assert len(kept) == probe.live_bound()


def test_check_leak_catches_a_kept_tensor_on_the_card(card, monkeypatch):
    """A tensor kept every cycle on the card fails phase 1: its live
    blocks and allocated bytes grow."""
    from quiver_tpu_torch import check_leak
    w = check_leak.make_world("cuda", quick=True)
    kept = []
    prefetch = Feature.prefetch

    def keeping(self, node_idx):
        fut = prefetch(self, node_idx)
        kept.append(fut.result())
        return fut

    monkeypatch.setattr(Feature, "prefetch", keeping)
    with pytest.raises(check_leak.LeakError, match=r"phase 1 .*live"):
        check_leak.run(w, [1], log=lambda line: None)
    assert all(t.is_cuda for t in kept) and len(kept) > 16


# -- the operator CLIs beside the card ---------------------------------------


def _cli(*argv, code=None, timeout=300):
    import subprocess
    import sys
    from pathlib import Path
    cmd = [sys.executable, "-c", code, *argv] if code else \
        [sys.executable, "-m", *argv]
    return subprocess.run(cmd, cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=timeout)


def test_qt_capacity_predicts_with_the_probe_on_the_card(card, tmp_path):
    """``qt_capacity --predict`` runs the machine probe on the card (its
    default device) and appends the prediction it prints."""
    from quiver_tpu_torch import metrics as qm
    p = str(tmp_path / "h.jsonl")
    with qm.MetricsSink(p) as sink:
        sink.emit({"wall": {"p50_ms": 4.0},
                   "serving": {"mean_batch_fill": 12.0,
                               "knobs": {"max_wait_ms": 2.0,
                                         "batch_fill_cap": 64}}},
                  kind="serving")
    out = _cli("quiver_tpu_torch.scripts.qt_capacity", "--jsonl", p,
               "--predict", "--replicas", "3", "--no-color")
    assert out.returncode == 0, out.stderr[-4000:]
    (rec,) = [r for r in qm.read_jsonl(p) if r["kind"] == "capacity"]
    assert f"sustain {rec['predicted_rps']:.0f} req/s" in out.stdout
    assert rec["replicas"] == 3 and rec["batch_cap"] == 64


_AGG_ONCE = """
import sys, torch
from quiver_tpu_torch.scripts import qt_agg
rc = qt_agg.main(sys.argv[1:])
print("CUDA_INITIALIZED", torch.cuda.is_initialized())
sys.exit(rc)
"""


def test_qt_agg_once_leaves_cuda_uninitialised(card, tmp_path):
    """The aggregator never touches the card: a ``qt_agg --once`` pass
    over replica sinks leaves CUDA uninitialised in its process."""
    from quiver_tpu_torch import metrics as qm
    specs = []
    for name in ("r0", "r1"):
        p = str(tmp_path / f"{name}.jsonl")
        with qm.MetricsSink(p, replica=name) as sink:
            sink.emit({"counters": {"hot_rows": 10, "cold_rows": 5},
                       "wall": {"p50_ms": 2.0}}, kind="step_stats")
        specs.append(f"{name}={p}")
    out = _cli("--once", "--no-color", "--replicas", ",".join(specs),
               "--jsonl", str(tmp_path / "fleet.jsonl"), code=_AGG_ONCE)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "fleet: 2 replicas" in out.stdout
    assert "CUDA_INITIALIZED False" in out.stdout
