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
cards, the events go on the ids' card."""

import numpy as np
import pytest
import torch

import copy

from quiver_tpu_torch import (CSRTopo, Feature, GraphSAGE, GraphSageSampler,
                              ServeEngine)
from quiver_tpu_torch.ops import quant
from quiver_tpu_torch.ops.kernels import fused, gather, sample_kernel
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
    (torch.float32, DIM, 16), (torch.bfloat16, DIM, 4),
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
                              "gather_elems": 0}
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
                              "gather_elems": 0}


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
                              "gather_elems": 0}
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
    """The pinned host group read by the card (``gather_rows`` with -1
    ids off the group) equals the same store on the CPU bit for bit,
    with no host synchronisation."""
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
        stores["cuda"]._host_data) if t is not None)
    ids = torch.cat([graph["seeds"].long(),
                     torch.tensor([N, N + 5, -3], device="cuda")])
    fused.reset_launches()
    got = _sync_free(lambda: stores["cuda"][ids])
    assert fused.LAUNCHES["gather_rows"] == 1
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
