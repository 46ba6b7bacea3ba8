"""The comparisons that decide ``correct``.

Training: the gap between the program's and the reference's loss, and,
leaf by leaf, between the norms of the first gradient and of the
parameters' change after the checked steps, each measured against the
reference's norm of that leaf or of the median leaf, whichever is
larger (:func:`train_readings` says which are compared). Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of the change: Adam moves them by round-off alone.

Sampling: each sampled hop judged by what it says (:class:`SampledCSR`):
every edge is an edge of the graph among the target's first ``row_cap``
slots, every target has ``min(deg, k)`` picks, and the frontier is the
seeds followed by every new pick once. For draws proportional to edge
weight, the picks' summed weight share is held against its expectation
in standard errors (:func:`weight_draw_z`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref))


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in d.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms, ``| |p| - |r| |`` over ``max(|r|,
    median leaf's |r|)``."""
    names = list(ref) if leaves is None else list(leaves)
    rn, pn = _norms({n: ref[n] for n in names}), \
        _norms({n: prog[n] for n in names})
    med = sorted(rn.values())[len(rn) // 2]
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names}


def leaf_gap(prog, ref, leaves=None) -> float:
    """The worst leaf's gap of norms (:func:`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, leaves).values())


def moving_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's."""
    gn = _norms(grads)
    med = sorted(gn.values())[len(gn) // 2]
    return [n for n, v in gn.items() if v >= 1e-3 * med]


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{"losses", "grad1", "params0",
    "params_end"}``.

    Compared: the first step's loss gap, the first gradient's worst
    leaf, and the parameters' change after the checked steps by the
    median leaf. Adam turns the round-off of a gradient entry near zero
    into a step of the full learning rate, and the atomics of the
    backward's sums make that round-off vary from run to run; so the
    later steps' losses and the worst leaf's change wander by more than
    rounding on a few seeds. They are given beside, and not compared
    (``loss_gap_steps``, ``delta_gap_worst``)."""
    moving = moving_leaves(ref["grad1"])
    d_prog = {n: prog["params_end"][n] - prog["params0"][n] for n in moving}
    d_ref = {n: ref["params_end"][n] - ref["params0"][n] for n in moving}
    deltas = sorted(leaf_gaps(d_prog, d_ref).values())
    return {"loss_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
            "grad_gap": leaf_gap(prog["grad1"], ref["grad1"]),
            "delta_gap": deltas[len(deltas) // 2],
            "loss_gap_steps": loss_gap(prog["losses"], ref["losses"]),
            "delta_gap_worst": deltas[-1]}


class SampledCSR:
    """The graph's edges as sorted ``row * n + col`` keys, with each
    key's CSR slot, for membership and position look-ups.

    With ``weights`` (one per CSR slot), each distinct edge also gets
    its weight in the draw's pool, fp64: the summed weight of its copies
    among the row's first ``row_cap`` slots (negative weights count 0);
    and each row the pool's total and sum of squares over its distinct
    edges. A draw proportional to weight picks edge ``t -> s`` with
    probability ``W(t, s) / T(t)``."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
                 weights: Optional[torch.Tensor] = None,
                 row_cap: Optional[int] = None):
        n = indptr.shape[0] - 1
        self.n = n
        self.indptr = indptr.long()
        self.deg = self.indptr[1:] - self.indptr[:-1]
        rows = torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                       self.deg)
        keys = rows * n + indices.long()
        self.keys, self.slot = torch.sort(keys)
        del keys
        self.key_w = None
        if weights is not None:
            self._pool_weights(rows, weights, row_cap)

    def _pool_weights(self, rows, weights, row_cap):
        w = weights.double().clamp(min=0.0)
        if row_cap is not None:
            pos = torch.arange(rows.shape[0], device=rows.device) \
                - self.indptr[rows]
            w = torch.where(pos < int(row_cap), w, 0.0)
            del pos
        self.uniq, inv = torch.unique_consecutive(self.keys,
                                                  return_inverse=True)
        self.key_w = torch.zeros(self.uniq.shape[0], dtype=torch.float64,
                                 device=w.device).index_add_(
            0, inv, w[self.slot])
        del inv, w
        urow = self.uniq // self.n
        self.row_total = torch.zeros(self.n, dtype=torch.float64,
                                     device=urow.device).index_add_(
            0, urow, self.key_w)
        self.row_sq = torch.zeros_like(self.row_total).index_add_(
            0, urow, self.key_w.pow(2))
        self.row_cube = torch.zeros_like(self.row_total).index_add_(
            0, urow, self.key_w.pow(3))

    def draw_moments(self, t: torch.Tensor, s: torch.Tensor):
        """For picks ``t -> s`` of a draw proportional to weight: each
        pick's weight share ``W(t, s) / T(t)``, its expectation
        ``sum W^2 / T^2`` and variance ``sum W^3 / T^3 - mean^2`` over
        ``t``'s pool, and whether it counts (``t``'s pool has weight on
        more than one edge)."""
        q = t * self.n + s
        at = torch.searchsorted(self.uniq, q).clamp(
            max=self.uniq.shape[0] - 1)
        total = self.row_total[t]
        safe = total.clamp(min=1e-300)
        share = torch.where(self.uniq[at] == q, self.key_w[at], 0.0) / safe
        mean = self.row_sq[t] / safe.pow(2)
        var = (self.row_cube[t] / safe.pow(3) - mean.pow(2)).clamp(min=0.0)
        counts = (total > 0) & (mean < 1.0 - 1e-12)
        return share, mean, var, counts

    def find(self, t: torch.Tensor, s: torch.Tensor):
        """For edges ``t -> s`` (global ids): ``(present, slot of the
        first copy in CSR order among equal keys)``."""
        q = t * self.n + s
        lo = torch.searchsorted(self.keys, q)
        at = lo.clamp(max=self.keys.shape[0] - 1)
        return self.keys[at] == q, self.slot[at]


def judge_hops(g: SampledCSR, n_id: torch.Tensor, seeds: torch.Tensor,
               hops: Sequence[Tuple[torch.Tensor, int]],
               row_cap: Optional[int] = None) -> dict:
    """Judge one sampled batch. ``hops`` in sampling order, each
    ``(edge_index [2, E] (source slot, target slot), k)`` with -1 on
    padded edges. Returns the number of faults found and, where ``g``
    holds weights, the picks' summed weight share, its expectation and
    variance (:meth:`SampledCSR.draw_moments`)."""
    dev = n_id.device
    n_id = n_id.long()
    faults = 0
    valid_ids = n_id[n_id >= 0]
    v_total = valid_ids.numel()
    # the frontier: a valid prefix, then -1; distinct; the seeds first
    faults += int((n_id[v_total:] >= 0).sum())
    faults += v_total - int(torch.unique(valid_ids).numel())
    b = int((seeds >= 0).sum())
    faults += int((n_id[:b] != seeds[:b].long()).sum())
    v = b
    share = {"share_sum": 0.0, "share_mean": 0.0, "share_var": 0.0}
    for edge_index, k in hops:
        src, tgt = edge_index[0].long(), edge_index[1].long()
        live = (src >= 0) & (tgt >= 0)
        faults += int(((src >= 0) != (tgt >= 0)).sum())
        src, tgt = src[live], tgt[live]
        faults += int((tgt >= v).sum())
        tgt = tgt.clamp(max=max(v - 1, 0))
        src = src.clamp(max=n_id.shape[0] - 1)
        t, s = n_id[tgt], n_id[src]
        faults += int((s < 0).sum())
        s = s.clamp(min=0)
        present, first = g.find(t, s)
        faults += int((~present).sum())
        got = torch.zeros(v, dtype=torch.int64, device=dev).index_add_(
            0, tgt, torch.ones_like(tgt))
        faults += int((got != g.deg[n_id[:v]].clamp(max=k)).sum())
        if row_cap is not None:
            pos = first - g.indptr[t]
            faults += int((present & (pos >= row_cap)).sum())
        if g.key_w is not None:
            got_s, mean, var, counts = g.draw_moments(t, s)
            counts &= present
            share["share_sum"] += float(got_s[counts].sum())
            share["share_mean"] += float(mean[counts].sum())
            share["share_var"] += float(var[counts].sum())
        # the next frontier: every new id is a pick of this hop
        nxt = max(v, int(src.max()) + 1) if src.numel() else v
        new = torch.zeros(nxt, dtype=torch.bool, device=dev)
        new[src] = True
        faults += int((~new[v:nxt]).sum())
        v = nxt
    faults += int(v != v_total)
    return {"faults": faults, **share}


def weight_draw_z(share_sum: float, share_mean: float,
                  share_var: float) -> float:
    """How far the picks' summed weight share lies from its expectation,
    in standard errors: about ``|N(0, 1)|`` for independent draws
    proportional to weight, and large for a draw that ignores the
    weights (its share sums to about ``sum 1 / pool size``)."""
    if share_var <= 0:
        return 0.0
    return abs(share_sum - share_mean) / share_var ** 0.5
