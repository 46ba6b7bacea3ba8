"""The registered hot paths ``python -m quiver_tpu_torch.analysis``
checks (counterpart of ``quiver_tpu/analysis/registry.py``).

Every entry point the serving and training system reaches is declared
here as an :class:`~.op_lint.EntrySpec` builder: the port's real builder
(``build_train_step``, ``build_e2e_train_step``,
``build_dist_train_step``, ``build_dist_lookup_fn`` /
``dist_lookup_local``, the serve steps of ``ServeEngine`` and
``ShardedServeEngine``, ``Feature._lookup_tiered`` and the fused
kernels' walk) at the JAX registry's fixture shapes (256 nodes, dim 16,
batch 8, fanout [3, 2]), plus the invariants it promises. The nine
names and their ``quick`` flags are JAX's. Each builder returns every
point of its census lattice (each serve ladder variant, each arity of
the rows view), so the rules read each reachable program, not one.

Where the port's entry differs from JAX's it says so: the train and
serve steps take the fused route (the kernels' walk, the route the
card runs in production), not the split route with ``dedup_gather``;
the compact exchange documents one host synchronisation per lookup
(``host_syncs=1``: one ``all_reduce(MAX)`` of the overflow flag and one
``.item()``, where JAX's ``lax.cond`` needs none).

Each entry runs on the device the caller names (default the card: the
builders raise where there is none). Mesh entries run over the default
process group when one exists, else over a world of one that
:func:`mesh_group` starts (gloo on the CPU, NCCL on the card) and
:func:`release_group` ends.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

from .op_lint import CensusSpec, EntrySpec, run_rules

# name -> (builder, quick): quick entries form the mini matrix
# ``python -m quiver_tpu_torch.analysis --quick`` runs
_REGISTRY: Dict[str, tuple] = {}


def register_entry(name: str, builder: Callable, quick: bool = False) -> None:
    """``builder(device, group)`` returns one ``EntrySpec`` or a list."""
    _REGISTRY[name] = (builder, quick)


def entry_names(quick: bool = False) -> List[str]:
    return [n for n, (_, q) in _REGISTRY.items() if q or not quick]


def build_entry_specs(name: str, device="cuda",
                      group=None) -> List[EntrySpec]:
    """ALL specs of one entry: every point of its census lattice."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown entry point {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}")
    built = _REGISTRY[name][0](_device(device), group)
    return list(built) if isinstance(built, (list, tuple)) else [built]


def build_entry(name: str, device="cuda", group=None) -> EntrySpec:
    """The entry's primary spec (the one carrying its census)."""
    return build_entry_specs(name, device, group)[0]


def run_registry(names: Optional[List[str]] = None, quick: bool = False,
                 device="cuda", group=None, specs_out=None):
    """Build and verify entries; returns ``(findings, entries_run)``.
    ``specs_out`` (a list) receives every spec run, for callers that
    print their recordings. A world of one started here ends here."""
    owned = _OWNED["group"] is None and group is None
    findings, ran = [], []
    try:
        for name in (names or entry_names(quick=quick)):
            for spec in build_entry_specs(name, device, group):
                findings += run_rules(spec)
                if specs_out is not None:
                    specs_out.append(spec)
            ran.append(name)
    finally:
        if owned:
            release_group()
    return findings, ran


# ---------------------------------------------------------------------------
# the device, the process group, the shared small-shape fixture
# ---------------------------------------------------------------------------


def _device(device):
    import torch
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_OWNED = {"group": None}


def mesh_group(device):
    """The default process group, starting a world of one (gloo on the
    CPU, NCCL on the card, an in-process store) when none exists."""
    import torch.distributed as dist
    if not dist.is_initialized():
        kw = {}
        if device.type == "cuda":
            kw["device_id"] = device
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1, **kw)
        _OWNED["group"] = dist.group.WORLD
    return dist.group.WORLD


def release_group() -> None:
    """End the world of one :func:`mesh_group` started, if any."""
    import torch.distributed as dist
    if _OWNED["group"] is not None:
        _OWNED["group"] = None
        if dist.is_initialized():
            dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _graph():
    """JAX's fixture arrays, drawn in JAX's order from the same seed."""
    import numpy as np
    rng = np.random.default_rng(0)
    n, dim, bs, sizes = 256, 16, 8, [3, 2]
    deg = rng.integers(1, 6, n).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1]), dtype=np.int32)
    feat = rng.standard_normal((n, dim)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    return SimpleNamespace(n=n, dim=dim, bs=bs, sizes=sizes,
                           indptr_np=indptr, indices_np=indices,
                           feat_np=feat, labels_np=labels)


def _fixture(device) -> SimpleNamespace:
    """The fixture's tensors on ``device``."""
    import torch
    g = _graph()
    return SimpleNamespace(
        **vars(g), device=device,
        indptr=torch.as_tensor(g.indptr_np.astype("int32"), device=device),
        indices=torch.as_tensor(g.indices_np, device=device),
        feat=torch.as_tensor(g.feat_np, device=device),
        labels=torch.as_tensor(g.labels_np, device=device),
        seeds=torch.arange(g.bs, dtype=torch.int32, device=device))


def _model(fx):
    """GraphSAGE 16 -> 8 -> 4 (JAX's fixture model, no dropout) from a
    fixed seed."""
    import torch
    from ..models import GraphSAGE
    torch.manual_seed(1)
    return GraphSAGE(fx.dim, 8, 4, 2, dropout=0.0).to(fx.device)


def _state(fx):
    """A fresh train state with its Adam moments made (one step on zero
    gradients, which moves no parameter), as JAX's ``init_state`` makes
    them up front: the in-place rule then watches the moments too."""
    import torch
    from ..parallel.train import init_state
    model = _model(fx)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    opt.zero_grad(set_to_none=True)
    return init_state(model, opt)


def _frontier_cap(batch: int, sizes) -> int:
    from ..pyg.sage_sampler import layer_shapes
    return layer_shapes(batch, sizes)[-1].n_id_cap


def _exchange(h: int, slots: int, dim: int) -> dict:
    """The exchange budget of ``slots`` request slots per owner: the
    dense payload's bytes, and its two shapes as they cross the wire (a
    ``uint8`` view: the ``[H * slots]`` int32 requests and the
    ``[H * slots, dim]`` fp32 rows)."""
    return {"prims": ("all_to_all",),
            "dense_bytes": h * slots * 4 + h * slots * dim * 4,
            "max_frac": 0.25,
            "dense_shapes": ((4 * h * slots,), (h * slots, 4 * dim))}


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------


def _train_step(device, group) -> EntrySpec:
    from ..parallel import build_train_step
    fx = _fixture(device)
    state = _state(fx)
    step = build_train_step(state.model, state.optimizer, fx.sizes, fx.bs,
                            collect_metrics=True, fused_hot_hop=True)
    args = (state, fx.feat, None, fx.indptr, fx.indices, fx.seeds,
            fx.labels[fx.seeds.long()], [2, 3], 4)
    return EntrySpec(
        name="train_step", fn=step, args=args, donate_argnums=(0,),
        census=CensusSpec({"program": ("fused",)}, max_programs=1))


def _lookup_tiered(device, group) -> EntrySpec:
    import numpy as np
    import torch
    from .. import metrics
    from ..feature import Feature
    from ..utils import CSRTopo
    fx = _fixture(device)
    budget = 64
    topo = CSRTopo(indptr=fx.indptr_np, indices=fx.indices_np,
                   device="cpu")
    store = Feature(device_cache_size=(fx.n // 4) * fx.dim * 4,
                    csr_topo=topo, dedup_cold=True, cold_budget=budget,
                    host_placement="offload", device=device)
    store.from_cpu_tensor(fx.feat_np)
    host = store._host_offload
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        0, fx.n, 128, dtype=np.int32), device=device)

    def fn(dev_part, host_part, ids_, order):
        # the driven lattice: unmasked, metered
        col = metrics.Collector(ids_.device)
        rows = store._lookup_tiered(dev_part, host_part, ids_, order,
                                    False, col)
        return rows, col.counters()

    return EntrySpec(
        name="lookup_tiered", fn=fn,
        args=(store.device_part, host, ids, store.feature_order),
        tier_budgets=((host, budget, 0),),
        census=CensusSpec({"masked": (False,), "collect": (True,)},
                          max_programs=1),
        detail={"cold_budget": budget})


def dist_lookup_spec(device, group=None, ids=None, cap: int = 8,
                     name: str = "dist_lookup") -> EntrySpec:
    """The compact exchange's entry; ``ids`` (this rank's 64 ids over
    the ``world * 32`` node table) replaces the fixture's draw."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ..comm import build_dist_lookup_fn
    fx = _fixture(device)
    group = group if group is not None else mesh_group(device)
    h, me = dist.get_world_size(group), dist.get_rank(group)
    rows, batch = 32, 64
    fn = build_dist_lookup_fn(group, rows, batch, exchange_cap=cap,
                              collect_metrics=True, merge_counters=True)
    total = h * rows
    rng = np.random.default_rng(2)
    all_ids = rng.integers(0, total, h * batch, dtype=np.int32)
    full = rng.standard_normal((total, fx.dim)).astype(np.float32)
    if ids is None:
        ids = all_ids[me * batch:(me + 1) * batch]
    args = (torch.as_tensor(np.asarray(ids, np.int32), device=device),
            torch.as_tensor((np.arange(total) // rows).astype(np.int32),
                            device=device),
            torch.as_tensor((np.arange(total) % rows).astype(np.int32),
                            device=device),
            torch.as_tensor(full[me * rows:(me + 1) * rows], device=device))
    return EntrySpec(
        name=name, fn=fn, args=args, host_syncs=1,
        exchange=_exchange(h, batch, fx.dim),
        census=CensusSpec({"program": ("compact",)}, max_programs=1),
        detail={"exchange_cap": cap, "batch_per_host": batch})


_LADDER = [[3, 2], [2, 1], [1, 1]]


def _serve_step(device, group) -> List[EntrySpec]:
    from ..serving import ServeEngine
    fx = _fixture(device)
    engine = ServeEngine(_model(fx), None, (fx.indptr, fx.indices), fx.feat,
                         sizes_variants=_LADDER, batch_cap=16,
                         collect_metrics=True, fused_hot_hop=True,
                         device=device)
    seeds = engine.pad_seeds(list(range(8)))
    census = CensusSpec({"fanout_variant": tuple(
        tuple(v) for v in engine.variants)}, max_programs=4)
    # every ladder variant is recorded (a sync in the shed variant alone
    # must not slip past); the census rides the primary spec once
    return [EntrySpec(
        name="serve_step" if v == 0 else f"serve_step[variant{v}]",
        fn=step, args=([5 + i for i in range(len(engine.variants[v]))],
                       engine._feat, engine._forder, engine._indptr,
                       engine._indices, seeds),
        census=census if v == 0 else None,
        detail={"batch_cap": engine.batch_cap,
                "fanout": engine.variants[v]})
        for v, step in enumerate(engine._steps)]


def _sharded_serve_step(device, group) -> List[EntrySpec]:
    import numpy as np
    import torch.distributed as dist
    from ..comm import TorchComm
    from ..feature import DistFeature, PartitionInfo
    from ..serving import ShardedServeEngine
    fx = _fixture(device)
    group = group if group is not None else mesh_group(device)
    h, me = dist.get_world_size(group), dist.get_rank(group)
    cap = 16
    rows = fx.n // h
    g2h = (np.arange(fx.n) // rows).astype(np.int32)
    info = PartitionInfo(host=me, hosts=h, global2host=g2h)
    comm = TorchComm(rank=me, world_size=h, group=group)
    store = DistFeature.from_partition(fx.feat_np, info, comm,
                                       exchange_cap=cap, device=device)
    engine = ShardedServeEngine(_model(fx), None, (fx.indptr, fx.indices),
                                store, sizes_variants=_LADDER,
                                batch_cap=16, home=me,
                                collect_metrics=True, fused_hot_hop=True)
    seeds = engine.pad_seeds(list(range(8)))
    census = CensusSpec({"fanout_variant": tuple(
        tuple(v) for v in engine.variants)}, max_programs=4)
    return [EntrySpec(
        name="sharded_serve_step" if v == 0
        else f"sharded_serve_step[variant{v}]",
        fn=step, args=([5 + i for i in range(len(engine.variants[v]))],
                       store.shard, store._g2h, store._g2l,
                       engine._indptr, engine._indices, seeds),
        host_syncs=1,
        exchange=_exchange(h, _frontier_cap(engine.batch_cap,
                                            engine.variants[v]), fx.dim),
        census=census if v == 0 else None,
        detail={"batch_cap": engine.batch_cap, "exchange_cap": cap,
                "home": engine.home, "fanout": engine.variants[v]})
        for v, step in enumerate(engine._steps)]


def _rows_view(fx):
    """The exact-mode wide-path rows view of the fixture's indices (what
    callers pass as ``indices_rows``), so the rows arity is recorded and
    not just declared in the census."""
    from ..ops import as_index_rows
    return as_index_rows(fx.indices)


def _e2e_train_step(device, group) -> List[EntrySpec]:
    import torch
    import torch.distributed as dist
    from ..parallel import build_e2e_train_step
    fx = _fixture(device)
    group = group if group is not None else mesh_group(device)
    h, me = dist.get_world_size(group), dist.get_rank(group)
    per_dev = 4
    state = _state(fx)
    step = build_e2e_train_step(state.model, state.optimizer, fx.sizes,
                                per_dev, group, dedup_gather=True,
                                collect_metrics=True, merge_counters=True)
    seeds = torch.arange(me * per_dev, (me + 1) * per_dev,
                         dtype=torch.int32, device=device)
    args = (state, fx.feat, None, fx.indptr, fx.indices, seeds,
            fx.labels[seeds.long()], [3 + me, 5 + me], 7)
    return [
        EntrySpec(name="e2e_train_step", fn=step, args=args,
                  donate_argnums=(0,),
                  census=CensusSpec({"rows_arity": (False, True)},
                                    max_programs=2)),
        # the with-rows arity (the wide-exact read) is its own program:
        # record it too, so both census points are verified
        EntrySpec(name="e2e_train_step[rows]", fn=step,
                  args=args + (_rows_view(fx),), donate_argnums=(0,))]


def _dist_train_step(device, group) -> List[EntrySpec]:
    import numpy as np
    import torch
    import torch.distributed as dist
    from ..parallel import build_dist_train_step
    fx = _fixture(device)
    group = group if group is not None else mesh_group(device)
    h, me = dist.get_world_size(group), dist.get_rank(group)
    rows = fx.n // h
    per_host, cap = 4, 8
    state = _state(fx)
    step = build_dist_train_step(state.model, state.optimizer, fx.sizes,
                                 per_host, group, rows_per_host=rows,
                                 exchange_cap=cap, collect_metrics=True,
                                 merge_counters=True)
    g2h = torch.as_tensor((np.arange(fx.n) // rows).astype(np.int32),
                          device=device)
    g2l = torch.as_tensor((np.arange(fx.n) % rows).astype(np.int32),
                          device=device)
    seeds = torch.arange(me * per_host, (me + 1) * per_host,
                         dtype=torch.int32, device=device)
    args = (state, fx.feat[me * rows:(me + 1) * rows].contiguous(), g2h, g2l,
            fx.indptr, fx.indices, seeds, fx.labels[seeds.long()],
            [11 + me, 12 + me], 13)
    frontier = _frontier_cap(per_host, fx.sizes)
    detail = {"exchange_cap": cap, "frontier_cap": frontier}
    return [
        EntrySpec(name="dist_train_step", fn=step, args=args,
                  donate_argnums=(0,), host_syncs=1,
                  exchange=_exchange(h, frontier, fx.dim),
                  census=CensusSpec({"rows_arity": (False, True)},
                                    max_programs=2),
                  detail=detail),
        EntrySpec(name="dist_train_step[rows]", fn=step,
                  args=args + (_rows_view(fx),), donate_argnums=(0,),
                  host_syncs=1, exchange=_exchange(h, frontier, fx.dim),
                  detail=detail)]


def _wide(fx):
    """A dim-128 table beside the fixture (JAX's fused entries use one:
    its per-row DMAs want 128 lanes) and its int8 quantization."""
    import numpy as np
    import torch
    from ..ops import quant
    wide = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (fx.n, 128)).astype(np.float32), device=fx.device)
    return wide, quant.quantize(wide, "int8")


def _fused_hot_hop(device, group) -> List[EntrySpec]:
    from ..ops.kernels.fused import fused_hot_hop
    fx = _fixture(device)
    k, row_cap = 4, 64
    wide, feat_q = _wide(fx)

    def make(feat):
        def fn(indptr, indices, seeds, seed):
            return fused_hot_hop(indptr, indices, seeds, feat, k, seed,
                                 row_cap=row_cap)
        return fn

    args = (fx.indptr, fx.indices, fx.seeds, 7)
    # rows the kernel reads from the tier per call: each seed's and each
    # pick's (JAX's budget is its 128-seed grid block's, 128 * (1 + k))
    budget = fx.bs * (1 + k)
    return [
        EntrySpec(
            name="fused_hot_hop", fn=make(feat_q), args=args,
            tier_budgets=((feat_q, budget, 0),),
            census=CensusSpec({"variant": ("quantized", "plain")},
                              max_programs=2),
            detail={"k": k, "row_cap": row_cap}),
        EntrySpec(
            name="fused_hot_hop[plain]", fn=make(wide), args=args,
            tier_budgets=((wide, budget, 0),))]


def _fused_multihop(device, group) -> List[EntrySpec]:
    from ..ops.kernels.fused import fused_multihop
    fx = _fixture(device)
    sizes, row_cap = [3, 2], 64
    wide, feat_q = _wide(fx)

    def make(feat):
        def fn(indptr, indices, seeds, hop_seeds):
            # the whole fused walk: interior sampling hops, the leaf
            # sample+gather hop, compaction and reassembly
            return fused_multihop(indptr, indices, seeds, feat, sizes,
                                  hop_seeds, row_cap=row_cap)
        return fn

    args = (fx.indptr, fx.indices, fx.seeds, [11, 12])
    # tier rows the leaf kernel reads: its seeds are the hop-0 frontier
    # (8 * (1 + 3) = 32), each reading (1 + k_leaf) rows
    budget = _frontier_cap(fx.bs, sizes[:1]) * (1 + sizes[-1])
    return [
        EntrySpec(
            name="fused_multihop", fn=make(feat_q), args=args,
            tier_budgets=((feat_q, budget, 0),),
            census=CensusSpec({"variant": ("quantized", "plain")},
                              max_programs=2),
            detail={"sizes": tuple(sizes), "row_cap": row_cap}),
        EntrySpec(
            name="fused_multihop[plain]", fn=make(wide), args=args,
            tier_budgets=((wide, budget, 0),))]


register_entry("train_step", _train_step, quick=True)
register_entry("lookup_tiered", _lookup_tiered, quick=True)
register_entry("dist_lookup", dist_lookup_spec, quick=True)
register_entry("serve_step", _serve_step, quick=True)
register_entry("sharded_serve_step", _sharded_serve_step, quick=True)
register_entry("fused_hot_hop", _fused_hot_hop, quick=True)
register_entry("fused_multihop", _fused_multihop, quick=True)
register_entry("e2e_train_step", _e2e_train_step)
register_entry("dist_train_step", _dist_train_step)
