"""2-D mesh training: data x model (tensor) parallelism (counterpart of
``quiver_tpu/parallel/gspmd.py``).

JAX annotates shardings over a ``(data, model)`` mesh and lets GSPMD
partition one program. Here ``mesh`` is a 2-D
``torch.distributed.device_mesh.DeviceMesh``, one process a rank, and
the step is written out as GSPMD partitions it:

- every ``nn.Linear`` of the model is split over ``model`` on its output
  dimension (a flax kernel ``P(None, model)`` is a torch weight split on
  dim 0) and its bias follows it (JAX ``_leaf_spec``);
  :class:`ColumnParallelLinear` holds this rank's rows and gathers the
  output columns of every rank back whole, as XLA all-gathers the
  column-sharded activations feeding the next layer; on the way back,
  the input's gradient (each rank's columns' part) is summed over
  ``model``. A width the axis does not divide is split unevenly
  (``torch.chunk``'s rule), where JAX's ``device_put`` refuses it;
- Adam's moments mirror the parameters (they are kept per shard), and
  scalars are replicated;
- the topology and the features are replicated;
- the walk is split over ``data``: each ``data`` rank samples only its
  slice of the global batch's seeds, with draws keyed by node id and hop
  (``ops.sample_multihop.KeyedWalk``: the kernels' counter hash keyed by
  the node, not its position), so each seed's sampled tree is its tree
  in the walk over the whole batch; dropout is keyed by row the same way
  (``models.sage.RowKeyedDropout``: node id and layer), so a seed's
  logits do not depend on which slice walked it. The rank runs forward
  and backward over its own frontier, takes the loss over its slice, and
  the gradients and the loss are averaged over ``data``. So the step
  equals itself at world size 1 (``mesh=None``: the whole batch in one
  walk) up to reduction order, for a batch with no -1 fill (a padded
  slot's logits read the row the frontier puts in its place, which
  depends on the walk, as in the JAX package). JAX's XLA partitions
  the sampler and the activations over ``data`` the same way; its draws
  are keyed by position in the one program, so the two packages' trees
  are held to each other by contract only (membership, ``min(deg,
  k)``, distinct picks).

The collectives are ``torch.distributed`` calls on the mesh's groups
(one ``all_gather_into_tensor`` a Linear forward, one ``all_reduce``
backward, one ``all_reduce`` of the gradients a step), so the step runs
over NCCL, and over gloo on the CPU or with CUDA tensors. DTensor's
``ColwiseParallel`` computes the same step, but its functional
collectives hang with CUDA tensors over gloo (PyTorch 2.11, CUDA
12.8, on an H100), which is how ranks sharing one card talk. Its sampling
is the split route's (``ops.sample_multihop``), as JAX's GSPMD step runs
its jitted sampler; the fused walk's kernels are not on this path.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..models.sage import RowKeyedDropout
from ..ops.sample_multihop import KeyedWalk, sample_multihop
from .train import (TrainState, _check_method, _check_rows,
                    cross_entropy_logits, layers_to_adjs,
                    masked_feature_gather)


def _chunks(n: int, parts: int):
    """``torch.chunk``'s split of ``n`` rows into ``parts``: the sizes,
    0 for a part it leaves empty."""
    sizes = [c.numel() for c in torch.arange(n).chunk(parts)]
    return sizes + [0] * (parts - len(sizes))


class _SumGradOverModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group: each
    rank's columns contribute their part of the input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """Every rank's output columns gathered whole (in rank order);
    backward keeps this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, y, group, sizes, index):
        ctx.at = (sum(sizes[:index]), sizes[index])
        width = max(sizes)
        n = y.shape[0]
        pad = torch.zeros((n, width), dtype=y.dtype, device=y.device)
        pad[:, :y.shape[1]] = y
        out = torch.empty((len(sizes) * n, width), dtype=y.dtype,
                          device=y.device)
        dist.all_gather_into_tensor(out, pad, group=group)
        out = out.view(len(sizes), n, width)
        return torch.cat([out[r, :, :c] for r, c in enumerate(sizes)], 1)

    @staticmethod
    def backward(ctx, grad):
        start, width = ctx.at
        return grad[:, start:start + width].contiguous(), None, None, None


class ColumnParallelLinear(nn.Module):
    """This rank's rows of an ``nn.Linear``'s weight and bias (its output
    columns, ``torch.chunk``'s split over the model group); the forward
    returns every column, gathered over the group."""

    def __init__(self, linear: nn.Linear, group, size: int, index: int):
        super().__init__()
        self.group, self.index = group, index
        self.sizes = _chunks(linear.out_features, size)
        lo = sum(self.sizes[:index])
        hi = lo + self.sizes[index]
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        self.weight = nn.Parameter(linear.weight.detach()[lo:hi].clone())
        self.bias = None if linear.bias is None else nn.Parameter(
            linear.bias.detach()[lo:hi].clone())
        self.rows = (lo, hi)

    def forward(self, x):
        x = _SumGradOverModel.apply(x, self.group)
        y = nn.functional.linear(x, self.weight, self.bias)
        return _GatherColumns.apply(y, self.group, self.sizes, self.index)


def _linears(model):
    return [name for name, m in model.named_modules()
            if isinstance(m, (nn.Linear, ColumnParallelLinear))]


def _leaf_placement(param_name: str, linears, ndim: int):
    """JAX's ``_leaf_spec`` on torch's layout: a Linear's 2-D weight and
    1-D bias split on dim 0 over the model axis, anything else
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    owner = param_name.rsplit(".", 1)[0]
    if owner in linears and ndim in (1, 2):
        return (Shard(0),)
    return (Replicate(),)


def state_sharding(state: TrainState, mesh=None,
                   model_axis: str = "model"):
    """The TP placement of each parameter of ``state.model`` over
    ``mesh[model_axis]`` (its Adam moments mirror it):
    ``{name: placements}``."""
    linears = set(_linears(state.model))
    return {name: _leaf_placement(name, linears, p.dim())
            for name, p in state.model.named_parameters()}


def shard_state(state: TrainState, mesh,
                model_axis: str = "model") -> TrainState:
    """Place an unsharded ``TrainState`` on ``mesh`` with the TP layout:
    every ``nn.Linear`` of the model replaced in place by a
    :class:`ColumnParallelLinear` over ``mesh[model_axis]``, and a new
    optimizer of the same class and settings over the sharded
    parameters, carrying any moments cut like their parameter."""
    model, opt = state.model, state.optimizer
    sub = mesh[model_axis]
    group, size, index = sub.get_group(), sub.size(), sub.get_local_rank()
    old = dict(model.named_parameters())
    for name in _linears(model):
        lin = model.get_submodule(name)
        if isinstance(lin, ColumnParallelLinear):
            continue
        parent, _, leaf = name.rpartition(".")
        holder = model.get_submodule(parent) if parent else model
        setattr(holder, leaf, ColumnParallelLinear(lin, group, size, index))
    new = dict(model.named_parameters())
    new_opt = type(opt)(list(new.values()), **opt.defaults)
    for name, p_new in new.items():
        moments = opt.state.get(old[name])
        if not moments:
            continue
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        lo, hi = getattr(owner, "rows", (0, p_new.shape[0]))
        new_opt.state[p_new] = {
            k: v[lo:hi].clone() if torch.is_tensor(v)
            and v.shape == old[name].shape else v
            for k, v in moments.items()}
    return TrainState(model, new_opt, state.step)


def full_parameters(model, grad: bool = False) -> dict:
    """Every parameter of a sharded model whole, or with ``grad`` every
    parameter's gradient (collective over each
    :class:`ColumnParallelLinear`'s group; the same on every rank)."""
    out = {}
    for name, p in model.named_parameters():
        if grad:
            p = p.grad
        owner = model.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else model
        if isinstance(owner, ColumnParallelLinear):
            t = p.detach()
            flat = t.reshape(t.shape[0], -1)
            out[name] = _GatherColumns.apply(
                flat.t().contiguous(), owner.group, owner.sizes,
                owner.index).t().reshape((-1,) + tuple(t.shape[1:]))
        else:
            out[name] = p.detach().clone()
    return out


def keyed_walk(feat, forder, indptr, indices, seeds, sizes, hop_seeds,
               method: str = "exact", indices_rows=None,
               indices_stride=None):
    """One batch's ``(x, layers)`` with the draws keyed by node id and hop
    (hop ``i`` keyed by ``hop_seeds[i]``): the split route's samplers
    over :class:`KeyedWalk`, then the masked gather of the final
    frontier. ``seeds`` are distinct valid ids first, -1 fill at the
    tail."""
    n_id, layers = sample_multihop(
        indptr, indices, seeds, sizes, KeyedWalk(hop_seeds), method=method,
        indices_rows=indices_rows,
        indices_stride=indices_stride if indices_rows is not None else None,
        seeds_dense=True)
    return masked_feature_gather(feat, n_id, forder), layers


def dropout_rows(seeds, layers):
    """The node ids of the rows each of ``GraphSAGE``'s dropouts sees,
    in forward order: the targets of ``adjs[j]`` (outermost hop first),
    i.e. the seeds of the hops from the last to the second."""
    fronts = [seeds] + [layer.n_id for layer in layers[:-1]]
    return fronts[::-1][:-1]


def build_gspmd_train_step(model, optimizer, sizes: Sequence[int], mesh,
                           data_axis: str = "data",
                           model_axis: str = "model",
                           loss_fn: Callable = cross_entropy_logits,
                           method: str = "exact",
                           indices_stride: Optional[int] = None):
    """``step(state, feat, forder, indptr, indices, seeds, labels,
    hop_seeds, dropout_seed, indices_rows=None) -> (state, loss)`` on
    every rank of ``mesh`` together, with ``state`` placed by
    :func:`shard_state` (``state.model`` is ``model``; the step steps
    ``state.optimizer``, the sharded counterpart of ``optimizer``).
    ``mesh=None`` is world size 1: one process, the model unsharded, no
    collectives. ``seeds``/``labels`` hold the global batch (any multiple
    of the ``data`` axis size; distinct valid ids first, -1 fill at the
    tail), the same on every rank, as are ``hop_seeds`` (hop ``i``'s
    draws are keyed by ``hop_seeds[i]``) and ``dropout_seed``; each
    ``data`` rank walks ``seeds[d*part:(d+1)*part]``. ``method``
    ``"rotation"``/``"window"`` require ``indices_rows``, as in JAX. The
    loss returned is the global batch's mean. :func:`keyed_walk` over a
    rank's slice gives the walk that rank's step takes."""
    sizes = [int(k) for k in sizes]
    _check_method(method)
    if mesh is None:
        data_group, n_data, d_rank = None, 1, 0
    else:
        data_group = mesh[data_axis].get_group()
        n_data = mesh[data_axis].size()
        d_rank = mesh[data_axis].get_local_rank()

    def step(state: TrainState, feat, forder, indptr, indices, seeds,
             labels, hop_seeds, dropout_seed, indices_rows=None):
        if state.model is not model:
            raise ValueError("the state's model must be the one the step "
                             "was built with")
        _check_rows(method, indices_rows, "gspmd")
        if len(hop_seeds) != len(sizes):
            raise ValueError(f"need one seed per hop: {len(sizes)} hops, "
                             f"{len(hop_seeds)} seeds")
        b = seeds.shape[0]
        if b % n_data:
            raise ValueError(f"the global batch ({b}) must be a multiple "
                             f"of the {data_axis!r} axis size ({n_data})")
        part = b // n_data
        mine = slice(d_rank * part, (d_rank + 1) * part)
        seeds, labels = seeds[mine], labels[mine]
        with torch.no_grad():
            x, layers = keyed_walk(feat, forder, indptr, indices, seeds,
                                   sizes, hop_seeds, method=method,
                                   indices_rows=indices_rows,
                                   indices_stride=indices_stride)
        adjs = layers_to_adjs(layers, part, sizes)
        model.train()
        keyed = RowKeyedDropout(dropout_seed, dropout_rows(seeds, layers))
        logits = model(x, adjs, generator=keyed)[:part]
        loss = loss_fn(logits, labels)
        loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [loss.detach().reshape(1)])
        if n_data > 1:
            dist.all_reduce(flat, group=data_group)
            flat /= n_data
        at = 0
        for p in params:
            p.grad = flat[at:at + p.numel()].view_as(p).clone()
            at += p.numel()
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return TrainState(model, state.optimizer, state.step + 1), \
            flat[-1].clone()

    return step
