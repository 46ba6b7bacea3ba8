"""Single-device training steps: sample -> gather -> forward/backward ->
update (counterpart of ``quiver_tpu/parallel/train.py``).

Two routes feed the same loss of any model with ``forward(x, adjs,
generator=None)`` (``GraphSAGE``, ``GAT``). ``fused_hot_hop=True`` runs
the fused frontier walk (``ops.kernels.fused.fused_multihop``): the
interior hops launch the CUDA sampling kernel and the leaf hop samples
and gathers its rows in one kernel. ``fused_hot_hop=False`` runs the
sampler of ``method`` (``ops.sample_multihop``: exact, or rotation and
window over the caller's rows view of a reshuffled ``indices``) and
then the masked row gather. Neither kernel has a backward: gradients
reach only the model's parameters, and the sampled feature block is a
constant of the step.

JAX derives every random stream of a step from one key. Here the
caller passes them as plain ints: one int32 kernel seed per hop
(``hop_seeds``) and a ``dropout_seed``; :func:`draw_step_seeds` draws
both from a host ``torch.Generator`` without touching the device. The
JAX streams themselves (``fold_in(key, 1000)`` for dropout, the JAX
PRNG for the exact sampler) cannot be reproduced in torch, so
only the fused walk's picks, which come from the kernels' counter hash,
match the JAX package's bit for bit.

``dedup_gather`` (True or an int unique budget) swaps the split
route's gather for :func:`dedup_feature_gather`. ``collect_metrics``
adds the step's device counter vector (``metrics.Collector``: the
final frontier's fill, and the dedup gather's statistics) to its
outputs.

``build_e2e_train_step`` is the data-parallel step over a
``torch.distributed`` process group: every rank holds the whole table
and samples its own seeds, and the gradients (with the loss) are
averaged by one ``all_reduce`` before each rank's identical update, the
JAX step's ``pmean``. ``parallel/dist.py`` holds the step whose table is
partitioned over the ranks.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import metrics
from ..ops import quant
from ..ops.dedup import unique_within_budget
from ..ops.kernels.fused import fused_multihop, fused_sample_multihop
from ..ops.kernels._build import gated
from ..ops.kernels.gather import gather_rows
from ..ops.sample_multihop import _METHODS, sample_multihop
from ..profiling import hot_path
from ..pyg.sage_sampler import Adj, layer_shapes
from .mesh import axis_size

class TrainState(NamedTuple):
    """The model (its parameters), its optimizer (its moments) and the
    number of steps taken. torch updates both in place, so a step
    returns the same two objects with the count advanced; JAX's
    ``donate`` and its donation guard have nothing left to do."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def init_state(model, optimizer) -> TrainState:
    """A fresh ``TrainState``; ``model`` is initialised and on the data's
    device, ``optimizer`` holds its parameters."""
    return TrainState(model, optimizer, 0)


def cross_entropy_logits(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    return F.cross_entropy(logits, labels.long())


def draw_int32(generator: torch.Generator, n: int) -> List[int]:
    """``n`` int32 values from a host generator (no device sync)."""
    return torch.randint(-2**31, 2**31 - 1, (n,),
                         generator=generator).tolist()


def draw_step_seeds(generator: torch.Generator,
                    hops: int) -> Tuple[List[int], int]:
    """The next step's ``(hop_seeds, dropout_seed)``: ``hops + 1`` int32
    values from a host generator, with no device synchronisation."""
    vals = draw_int32(generator, hops + 1)
    return vals[:hops], vals[hops]


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def layers_to_adjs(layers, batch_size: int, sizes: Sequence[int]):
    """LayerSamples (sampling order) -> Adj list (outermost hop first)."""
    adjs = []
    for layer, shape in zip(layers, layer_shapes(batch_size, sizes)):
        adjs.append(Adj(edge_index=torch.stack([layer.col, layer.row]),
                        e_id=layer.e_id,
                        size=(shape.n_id_cap, shape.num_seeds),
                        mask=layer.col >= 0))
    return adjs[::-1]


@hot_path
def masked_feature_gather(feat, n_id: torch.Tensor, feature_order=None,
                          collector=None) -> torch.Tensor:
    """Feature rows for a -1-padded frontier, through the optional
    hot-order indirection; padded rows come back zeroed. ``feat`` is a
    tensor, a ``QuantizedTensor`` (dequant fused into the gather) or a
    clique's ``quant.ShardedTier`` (read by ``gather_rows_sharded``).
    ``collector`` is taken for the gathers' common signature and records
    nothing (one tier: nothing tiered to count), as in JAX."""
    ids = n_id.long()
    if feature_order is not None:
        ids = feature_order.long()[ids.clamp(min=0)]
    safe = ids.clamp(0, quant.tier_rows(feat) - 1)
    x = quant.gather_rows(feat, safe)
    return x * (n_id >= 0).to(x.dtype)[:, None]


@hot_path
def dedup_feature_gather(feat, n_id: torch.Tensor, feature_order=None,
                         budget: Optional[int] = None,
                         collector=None) -> torch.Tensor:
    """:func:`masked_feature_gather` reading each distinct valid id once
    (default budget ``max(len(n_id) // 4, 256)``): a ``[budget, dim]``
    gather of the unique rows expanded to the positions. When the unique
    count overflows the budget, every slot is gathered instead; as in
    ``ops.dedup``, that read is predicated (ids -1 unless overflowed,
    through ``gather_rows``), so the host never picks the branch. Equal
    to the JAX function in both branches. ``collector`` records the
    unique table's statistics (``unique_within_budget``)."""
    n = n_id.shape[0]
    if budget is None:
        budget = quant.default_cold_budget(n)
    if budget >= n:
        return masked_feature_gather(feat, n_id, feature_order)
    valid = n_id >= 0
    uniq, inv, n_uniq = unique_within_budget(n_id, budget, valid=valid,
                                             collector=collector)
    ids = n_id.long().clamp(min=0)
    hi = quant.tier_rows(feat) - 1
    if feature_order is not None:
        hi = feature_order.shape[0] - 1
        ids = feature_order.long()[ids.clamp(max=hi)]
    # the int32-max fill reads the last row, as JAX's clamping gather does
    rows_u = masked_feature_gather(feat, uniq.clamp(max=hi), feature_order)
    x = rows_u.index_select(0, inv.long())
    ids = ids.clamp(0, quant.tier_rows(feat) - 1).to(torch.int32)
    with gated():
        x = gather_rows(feat, torch.where(n_uniq > budget, ids,
                                          torch.full_like(ids, -1)), out=x)
    return x * valid.to(x.dtype)[:, None]


def store_gather(store, n_id: torch.Tensor, feature_order=None,
                 collector=None) -> torch.Tensor:
    """A ``Feature`` store's masked lookup (-1 ids give zero rows) as a
    step's gather: the steps take a store as their ``feat`` and read
    each frontier through it, whatever its tiers and placement (a
    clique's blocks, a pinned cold tier). The store applies its own
    order, so ``feature_order`` must be None. ``collector`` absorbs the
    lookup's counters."""
    if feature_order is not None:
        raise ValueError("a Feature store applies its own feature_order; "
                         "pass forder=None with it")
    if collector is None:
        return store.lookup_tiered(n_id, masked=True)
    rows, counters = store.lookup_tiered(n_id, masked=True,
                                         collect_metrics=True)
    collector.absorb(counters.to(n_id.device))
    return rows


def _is_store(feat) -> bool:
    return hasattr(feat, "lookup_tiered")


def _dedup_gather_fn(dedup_gather):
    """The ``dedup_gather`` knob (None, True or an int unique budget) as
    the gather the split route takes (None keeps the masked gather)."""
    if dedup_gather is None:
        return None
    budget = None if dedup_gather is True else int(dedup_gather)
    return lambda feat, n_id, forder, collector=None: dedup_feature_gather(
        feat, n_id, forder, budget, collector=collector)


def _fused_multihop_x(feat, forder, indptr, indices, seeds,
                      sizes: Sequence[int], hop_seeds: Sequence[int],
                      row_cap: int = 2048, hot_rows: Optional[int] = None,
                      collector=None):
    """The fused frontier walk (``ops.kernels.fused.fused_multihop``):
    interior hops run the sampling kernel, the leaf hop samples and
    gathers in one kernel. Hop ``i`` draws from ``hop_seeds[i]``.
    Returns ``(x, layers)``; ``collector`` records the final frontier's
    valid slots and capacity."""
    n_id, layers, x = fused_multihop(
        indptr, indices, seeds, feat, list(sizes), hop_seeds,
        row_cap=row_cap, feature_order=forder, hot_rows=hot_rows)
    _frontier_counters(collector, n_id)
    return x, layers


def _frontier_counters(collector, n_id):
    """The fused walk's counters: the final frontier's valid slots and
    capacity."""
    if collector is not None:
        collector.add(metrics.FRONTIER_VALID,
                      (n_id >= 0).sum(dtype=torch.int32))
        collector.add(metrics.FRONTIER_CAP, int(n_id.shape[0]))


def _fused_knobs(enabled, row_cap, sizes, method, dedup_gather=None,
                 indices_stride=None, hub_frac=None):
    """Validate and pack the ``fused_hot_hop`` knobs of a step: the walk
    covers any exact-method fanout ladder and gathers in-kernel, so it
    composes with nothing that reshapes sampling or the gather."""
    if not enabled:
        return None
    if not sizes:
        raise ValueError("fused_hot_hop needs at least one hop in sizes")
    if method != "exact":
        raise ValueError(
            f"fused_hot_hop requires method='exact', got {method!r}")
    if dedup_gather is not None:
        raise ValueError(
            "fused_hot_hop gathers in-kernel (one row per frontier "
            "slot); dedup_gather does not compose with it")
    if indices_stride is not None or hub_frac is not None:
        raise ValueError(
            "fused_hot_hop takes neither indices_stride nor hub_frac "
            "(no wide-exact/rotation layout views in the fused kernel)")
    return {"row_cap": int(row_cap)}


def _check_method(method: str):
    if method not in _METHODS:
        raise ValueError(f"unknown sampling method {method!r}")


def _step_knobs(fused_hot_hop, row_cap, sizes, method, dedup_gather,
                indices_stride=None, hub_frac=None):
    """The knobs of the train and serve steps: the method, then the
    fused walk's (see :func:`_fused_knobs`)."""
    _check_method(method)
    return _fused_knobs(fused_hot_hop, row_cap, sizes, method,
                        dedup_gather=dedup_gather,
                        indices_stride=indices_stride, hub_frac=hub_frac)


def _check_rows(method: str, indices_rows, kind: str) -> bool:
    """The ``indices_rows`` contract of the step builders: rotation and
    window need the per-epoch reshuffled view (``as_index_rows`` or
    ``as_index_rows_overlapping`` of a ``reshuffle_csr`` output); exact
    may take a view of the un-shuffled ``indices``, which switches it to
    the wide-exact read (the same draw). Returns whether the method is
    windowed."""
    windowed = method in ("rotation", "window")
    if windowed and indices_rows is None:
        raise TypeError(
            f"{method} {kind} step requires indices_rows (the shuffled "
            "as_index_rows/as_index_rows_overlapping view; refresh per "
            "epoch via permute_csr)")
    return windowed


def _split_sample(indptr, indices, seeds, sizes, generator, method="exact",
                  indices_rows=None, indices_stride=None, hub_frac=None,
                  collector=None):
    """The split route's sampling: ``sample_multihop`` under the step's
    batch contract (distinct valid seeds first, so ``seeds_dense``).
    ``indices_stride`` counts only with a rows view, as in JAX."""
    return sample_multihop(
        indptr, indices, seeds, sizes, generator, method=method,
        indices_rows=indices_rows,
        indices_stride=indices_stride if indices_rows is not None else None,
        seeds_dense=True, hub_frac=hub_frac, collector=collector)


def _walk(fused, feat, forder, indptr, indices, seeds, sizes, hop_seeds,
          hot_rows: Optional[int] = None, gather=None, collector=None,
          **sampling):
    """One batch's ``(x, layers)``. ``fused`` (the packed knobs) takes
    the fused walk, hop ``i`` seeded with ``hop_seeds[i]``: the leaf
    kernel gathers from ``feat``, or, over a clique's sharded tier or
    with a ``gather``, the walk only samples and ``gather`` (default the
    masked gather) reads the final frontier; ``None``
    takes the split route: :func:`_split_sample` with the ``sampling``
    knobs (``method``, ``indices_rows``, ``indices_stride``,
    ``hub_frac``), all hops drawing from one generator seeded with
    ``hop_seeds[0]`` on the seeds' device, then ``gather(feat, n_id,
    forder)`` (default the masked gather) over the final frontier.
    ``collector`` (a ``metrics.Collector``, or None) goes to the walk or
    the sampler, and to the gather as ``collector=``."""
    if len(hop_seeds) != len(sizes):
        raise ValueError(f"need one seed per hop: {len(sizes)} hops, "
                         f"{len(hop_seeds)} seeds")
    if fused is not None and gather is None and not quant.is_sharded(feat):
        return _fused_multihop_x(feat, forder, indptr, indices, seeds,
                                 sizes, hop_seeds, hot_rows=hot_rows,
                                 collector=collector, **fused)
    if fused is not None:
        # the sample-only walk (every hop a sampling launch), then the
        # gather: a clique's blocks, or a store's tiers, are read after it
        n_id, layers = fused_sample_multihop(indptr, indices, seeds, sizes,
                                             hop_seeds, fused["row_cap"])
        _frontier_counters(collector, n_id)
    else:
        n_id, layers = _split_sample(indptr, indices, seeds, sizes,
                                     _generator(seeds.device, hop_seeds[0]),
                                     collector=collector, **sampling)
    gather = gather or masked_feature_gather
    if collector is None:
        return gather(feat, n_id, forder), layers
    return gather(feat, n_id, forder, collector=collector), layers


def _model_loss(model, x, adjs, labels, batch_size: int,
                dropout_seed: int) -> torch.Tensor:
    """``model`` (any module with ``forward(x, adjs, generator=None)``:
    ``GraphSAGE``, ``GAT``) in train mode on a sampled block, its
    dropout drawn from a generator seeded with ``dropout_seed`` on
    ``x``'s device, and the loss over the first ``batch_size`` rows:
    every batch slot counts, the -1 padded seeds included, as in the JAX
    package."""
    logits = model(x, adjs, generator=_generator(x.device, dropout_seed))
    return cross_entropy_logits(logits[:batch_size], labels)


@hot_path
def _fused_loss(model, sizes, batch_size, feat, forder, indptr, indices,
                seeds, labels, hop_seeds, dropout_seed, fused=None,
                gather=None, collector=None, **sampling):
    """The step's loss over one batch's walk (:func:`_walk`, the split
    route taking the ``sampling`` knobs). The walk runs without
    autograd: ``x`` and the layers are constants of the step.

    Batch contract: ``seeds`` are distinct valid ids with -1 padding at
    the tail only, and ``labels`` holds a class in ``[0, classes)`` at
    every slot."""
    with torch.no_grad():
        x, layers = _walk(fused, feat, forder, indptr, indices, seeds,
                          sizes, hop_seeds, gather=gather,
                          collector=collector, **sampling)
    adjs = layers_to_adjs(layers, batch_size, sizes)
    return _model_loss(model, x, adjs, labels, batch_size, dropout_seed)


def _update(state: TrainState, model, optimizer, loss) -> TrainState:
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the state's model and optimizer must be the "
                         "ones the step was built with")
    loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return TrainState(model, optimizer, state.step + 1)


def _mean_update(state: TrainState, model, optimizer, loss, group):
    """The JAX step's ``pmean`` of the gradients and the loss over
    ``group``, then the update: every gradient and the loss go into one
    flat buffer, one ``all_reduce(SUM)``, a division by the rank count,
    and each rank applies the same mean gradients. Returns the new state
    and the mean loss."""
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the state's model and optimizer must be the "
                         "ones the step was built with")
    loss.backward()
    params = [p for p in model.parameters() if p.requires_grad]
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params] + [loss.detach().reshape(1)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= axis_size(group)
    at = 0
    for p in params:
        p.grad = flat[at:at + p.numel()].view_as(p).clone()
        at += p.numel()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return TrainState(model, optimizer, state.step + 1), flat[-1].clone()


def build_train_step(model, optimizer, sizes: Sequence[int],
                     batch_size: int, method: str = "exact",
                     indices_stride: Optional[int] = None,
                     hub_frac: Optional[float] = None,
                     dedup_gather=None, collect_metrics: bool = False,
                     fused_hot_hop: bool = False,
                     fused_row_cap: int = 2048):
    """Single-device train step:
    ``step(state, feat, forder, indptr, indices, seeds, labels,
    hop_seeds, dropout_seed, indices_rows=None) -> (state, loss)``, or
    ``(state, loss, counters)`` with ``collect_metrics=True``.
    ``model`` is any module with ``forward(x, adjs, generator=None)``
    (``GraphSAGE``, ``GAT``).

    ``state`` is ``init_state(model, optimizer)`` or a state the step
    returned. ``feat`` is an fp32 table or an int8 ``QuantizedTensor``
    (dequant fused into the gather), a clique's ``quant.ShardedTier``,
    or a ``Feature`` store (read through its masked lookup,
    :func:`store_gather`; ``forder`` None), ``forder`` an optional
    hot-order permutation; every tensor lies on one device. Over a
    sharded tier or a store, ``fused_hot_hop=True`` samples every hop
    with the sampling kernel and then reads the frontier through the
    store (or ``gather_rows_sharded``), instead of gathering in the leaf
    kernel. ``seeds`` is
    ``[batch_size]`` int32, distinct valid ids first and -1 fill at the
    tail, ``labels`` ``[batch_size]``. ``hop_seeds`` holds one int32 per
    hop, ``dropout_seed`` one int (see :func:`draw_step_seeds`). The
    loss comes back as a 0-d tensor on the device: the step never waits
    for the device.

    ``fused_hot_hop=True`` (``method="exact"``, any ``sizes`` ladder)
    samples and gathers through the fused walk's CUDA kernels, hop ``i``
    seeded with ``hop_seeds[i]``; ``fused_row_cap`` bounds the
    candidates per seed (degrees beyond it are truncated, the kernels'
    contract); it takes no ``indices_rows``. ``fused_hot_hop=False``
    samples every hop with ``method`` from one generator seeded with
    ``hop_seeds[0]``: ``"exact"``, with an optional ``indices_rows``
    view of the un-shuffled ``indices`` for the wide-exact read (pass
    ``hub_frac``, ``CSRTopo.exact_bucket_meta().frac``, to size its
    budget of scattered reads), or ``"rotation"`` / ``"window"``, which
    require ``indices_rows``, the rows view of an ``indices`` reshuffled
    per epoch (``reshuffle_csr``; ``indices_stride=128`` for the
    overlapping view), and raise ``TypeError`` without it, as the JAX
    package's data-parallel step does. ``dedup_gather`` (split route
    only, as in JAX) reads each distinct frontier row once
    (:func:`dedup_feature_gather`).

    The update is the optimizer's: ``optax.adam(lr)`` is
    ``torch.optim.Adam(params, lr, betas=(0.9, 0.999), eps=1e-8)``, both
    adding ``eps`` outside the square root of the bias-corrected second
    moment. torch updates the parameters and moments in place, so JAX's
    ``donate`` has no counterpart.

    ``collect_metrics=True`` adds one output, the step's
    ``[metrics.NUM_COUNTERS]`` int32 counter vector on the device: the
    final frontier's valid slots and capacity on either route, and with
    ``dedup_gather`` the unique table's statistics. It is counted with
    tensor ops on values the step computes anyway: no host
    synchronisation, and the loss and the update are the ones of the
    step without it, bit for bit. Feed it to ``metrics.StepStats``."""
    sizes = [int(k) for k in sizes]

    def finish(state, loss, col):
        new_state = _update(state, model, optimizer, loss)
        if col is None:
            return new_state, loss.detach()
        return new_state, loss.detach(), col.counters()

    return _build_step(model, sizes, batch_size, method, indices_stride,
                       hub_frac, dedup_gather, collect_metrics,
                       fused_hot_hop, fused_row_cap, finish, "train")


def _build_step(model, sizes, batch_size, method, indices_stride, hub_frac,
                dedup_gather, collect_metrics, fused_hot_hop, fused_row_cap,
                finish, kind):
    """The step of :func:`build_train_step` and
    :func:`build_e2e_train_step`: the knobs checked, one batch's loss,
    then ``finish(state, loss, collector)`` (the update, and the
    outputs)."""
    fused = _step_knobs(fused_hot_hop, fused_row_cap, sizes, method,
                        dedup_gather, indices_stride=indices_stride,
                        hub_frac=hub_frac)
    gather = _dedup_gather_fn(dedup_gather)

    def step(state: TrainState, feat, forder, indptr, indices, seeds,
             labels, hop_seeds, dropout_seed, indices_rows=None):
        if fused is not None and indices_rows is not None:
            raise TypeError(
                "fused_hot_hop does not take indices_rows (the fused "
                "walk does its own in-kernel CSR reads every hop)")
        sampling = {}
        if fused is None:
            _check_rows(method, indices_rows, kind)
            sampling = dict(method=method, indices_rows=indices_rows,
                            indices_stride=indices_stride,
                            hub_frac=hub_frac)
        model.train()
        col = metrics.Collector(seeds.device) if collect_metrics else None
        loss = _fused_loss(model, sizes, batch_size, feat, forder, indptr,
                           indices, seeds, labels, hop_seeds, dropout_seed,
                           fused=fused,
                           gather=store_gather if _is_store(feat) else gather,
                           collector=col, **sampling)
        return finish(state, loss, col)

    return step


def _mean_outputs(state, model, optimizer, loss, col, group,
                  merge_counters: bool):
    """A data-parallel step's outputs: the mean update
    (:func:`_mean_update`), the mean loss, and with a collector this
    rank's ``[1, N]`` counter block, or with ``merge_counters`` the
    group's ``[N]`` vector (``metrics.pmerge_counters``)."""
    new_state, loss = _mean_update(state, model, optimizer, loss, group)
    if col is None:
        return new_state, loss
    if merge_counters:
        return new_state, loss, metrics.pmerge_counters(col.counters(),
                                                        group)
    return new_state, loss, col.counters()[None]


def build_e2e_train_step(model, optimizer, sizes: Sequence[int],
                         per_device_batch: int, group=None,
                         method: str = "exact",
                         indices_stride: Optional[int] = None,
                         hub_frac: Optional[float] = None,
                         dedup_gather=None, collect_metrics: bool = False,
                         merge_counters: bool = False,
                         fused_hot_hop: bool = False,
                         fused_row_cap: int = 2048):
    """Data-parallel step over the process ``group`` (None = the default
    group), one rank's part:
    ``step(state, feat, forder, indptr, indices, seeds, labels,
    hop_seeds, dropout_seed, indices_rows=None) -> (state, loss)``.

    Every rank holds the whole ``feat`` table, the topology and an
    identical model and optimizer; ``seeds``/``labels`` are this rank's
    ``[per_device_batch]`` block (rank ``h``'s slice of the JAX step's
    sharded ``[H * per_device_batch]``) and ``hop_seeds``/
    ``dropout_seed`` its own streams (``parallel.dist.rank_step_seeds``
    derives them from one seed and the rank, where JAX folds the rank
    into its key). The loss and the sampling are those of
    :func:`build_train_step` with the same knobs (``fused_hot_hop=True``
    runs each rank's fused walk through the CUDA kernels); then one
    ``all_reduce`` averages the gradients and the loss over the group,
    and every rank takes the same optimizer step. The loss returned is
    the group's mean. Every rank of the group calls the step together.

    ``collect_metrics=True`` adds this rank's ``[1,
    metrics.NUM_COUNTERS]`` counter block, or with ``merge_counters``
    the group's ``[N]`` vector, merged on the device."""
    sizes = [int(k) for k in sizes]
    if merge_counters and not collect_metrics:
        raise ValueError("merge_counters=True requires "
                         "collect_metrics=True")

    def finish(state, loss, col):
        return _mean_outputs(state, model, optimizer, loss, col, group,
                             merge_counters)

    return _build_step(model, sizes, per_device_batch, method,
                       indices_stride, hub_frac, dedup_gather,
                       collect_metrics, fused_hot_hop, fused_row_cap,
                       finish, "e2e")


def build_split_train_step(model, optimizer, sizes: Sequence[int],
                           batch_size: int, method: str = "exact",
                           indices_stride: Optional[int] = None,
                           hub_frac: Optional[float] = None):
    """Two-stage step for callers that fetch the rows themselves:

      ``sample_fn(indptr, indices, seeds, seed, indices_rows=None) ->
      (n_id, adjs)``
      ``step_fn(state, x, adjs, labels, dropout_seed) -> (state, loss)``

    ``sample_fn`` samples every hop with ``method`` from one generator
    seeded with ``seed`` (``indices_rows``, ``indices_stride`` and
    ``hub_frac`` as in :func:`build_train_step`; rotation or window
    without ``indices_rows`` permute the topology on every call, as
    ``sample_multihop`` does). The caller gathers ``x = feature[n_id]``
    (padded slots zeroed), or samples by other means, such as a
    ``GraphSageSampler`` with edge weights, and hands ``x`` and the adjs
    to ``step_fn``. ``model`` is any module with ``forward(x, adjs,
    generator=None)``. The batch contract is the one of
    :func:`build_train_step`."""
    sizes = [int(k) for k in sizes]
    _check_method(method)

    def sample_fn(indptr, indices, seeds, seed: int, indices_rows=None):
        with torch.no_grad():
            n_id, layers = _split_sample(
                indptr, indices, seeds, sizes,
                _generator(seeds.device, seed), method=method,
                indices_rows=indices_rows, indices_stride=indices_stride,
                hub_frac=hub_frac)
        return n_id, layers_to_adjs(layers, batch_size, sizes)

    def step_fn(state: TrainState, x, adjs, labels, dropout_seed):
        model.train()
        loss = _model_loss(model, x, adjs, labels, batch_size,
                           dropout_seed)
        return _update(state, model, optimizer, loss), loss.detach()

    return sample_fn, step_fn
