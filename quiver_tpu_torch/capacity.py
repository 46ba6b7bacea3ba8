"""The capacity model: what a fleet of N replicas sustains of a request
mix within its latency budget (counterpart of
``quiver_tpu/capacity.py``; the same arithmetic, record for record).

Three sources compose:

- a byte cost of one served batch (``cost``: total bytes, a dict with
  ``total_bytes``, or an object with that attribute) over a measured
  device gather rate (``probe["gather_gbps"]``) floors the service time
  no measurement may undercut;
- an observed per-batch dispatch time (a timed ``ServeEngine.run``
  loop, or :func:`observe_serving` folding ``serving`` JSONL) is the
  device service time; the coalescer's per-request host cost
  (``overhead_per_req_ms``) runs beside dispatch when the server
  pipelines, so the batch cycle is ``s = max(dispatch, fill *
  overhead)``;
- the server's queueing discipline bounds how hot it may run: with
  headroom ``w = budget_p99 - s - max_wait``, the utilization cap is
  ``rho = 2w / (2w + s)`` (the M/D/1 mean-wait bound for paced load),
  clipped to [0.05, 0.95]. It is a heuristic: :func:`verdict` holds a
  prediction against the rate a replay of the mix at that rate
  sustained.

Throughput follows from batch amortization: ``predicted_rps = replicas
* fill * rho / s``, with ``fill`` the fixed point of the coalescer's
fill law ``fill = clip(rate_per_replica * (max_wait + s), 1,
batch_cap)``. Host arithmetic only: no torch import. :func:`emit`
writes one ``capacity`` record to a ``metrics.MetricsSink``.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["predict", "observe_serving", "verdict", "emit"]


def _total_bytes(cost) -> Optional[int]:
    """Bytes of ``cost``: a number, a dict's ``total_bytes``, or an
    object's ``total_bytes`` attribute."""
    if cost is None:
        return None
    if isinstance(cost, (int, float)):
        return int(cost)
    if isinstance(cost, dict):
        v = cost.get("total_bytes")
        return None if v is None else int(v)
    v = getattr(cost, "total_bytes", None)
    return None if v is None else int(v)


def predict(*, batch_cap: int, dispatch_ms: float, budget_p99_ms: float,
            mix: Optional[Dict[str, float]] = None, replicas: int = 1,
            max_wait_ms: float = 2.0, fill: Optional[float] = None,
            overhead_per_req_ms: float = 0.0,
            probe: Optional[dict] = None, cost=None) -> dict:
    """The capacity prediction record (see the module docstring for the
    model).

    ``dispatch_ms`` is the observed full-fill batch service time;
    ``cost`` (total bytes, a dict with ``total_bytes``, or an object
    with that attribute) over ``probe["gather_gbps"]`` floors it: a
    dispatch measurement faster than the batch's bytes at the measured
    rate is clock noise, not capacity. ``overhead_per_req_ms`` is the
    coalescer's per-request host cost (serial round trip minus serial
    dispatch); it bounds the cycle time from the host side. ``fill`` pins the per-batch
    fill instead of solving the fixed point. ``mix`` (tenant ->
    weight) splits the predicted rate into per-tenant shares."""
    if batch_cap < 1:
        raise ValueError(f"batch_cap must be >= 1, got {batch_cap}")
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if dispatch_ms <= 0:
        raise ValueError(f"dispatch_ms must be > 0, got {dispatch_ms}")
    if budget_p99_ms <= 0:
        raise ValueError(
            f"budget_p99_ms must be > 0, got {budget_p99_ms}")
    if overhead_per_req_ms < 0:
        raise ValueError(f"overhead_per_req_ms must be >= 0, got "
                         f"{overhead_per_req_ms}")
    floor_ms = None
    tb = _total_bytes(cost)
    if tb is not None and probe:
        gbps = float(probe.get("gather_gbps") or 0.0)
        if gbps > 0:
            floor_ms = tb / (gbps * 1e9) * 1e3
    service_ms = max(float(dispatch_ms), floor_ms or 0.0)

    def cycle_of(f):
        # pipeline_depth >= 2 overlaps device dispatch with host
        # coalescing: the batch cycle is whichever side is slower
        return max(service_ms, f * float(overhead_per_req_ms))

    def rho_of(cyc):
        # the M/D/1 mean-wait bound for paced offered load (module
        # docstring), with no extra tail margin
        headroom_ms = budget_p99_ms - cyc - max_wait_ms
        r = 2.0 * headroom_ms / (2.0 * headroom_ms + cyc) \
            if headroom_ms > 0 else 0.0
        return min(max(r, 0.05), 0.95)

    if fill is None:
        # the coalescer's fill law, iterated to its fixed point: a
        # replica at rate r fills batches with r * (max_wait + s)
        # arrivals (clipped to the batch), and the rate is fill * rho /
        # s with s = cycle(fill). Monotone, but in the latency-bound
        # regime the decay toward fill 1 is geometric with a ratio near
        # 1, so the iteration budget covers a slow crawl.
        f = float(batch_cap)
        for _ in range(512):
            cyc = cycle_of(f)
            rho = rho_of(cyc)
            per_replica_rps = f * rho / (cyc / 1e3)
            f_new = min(max(per_replica_rps
                            * (max_wait_ms + cyc) / 1e3, 1.0),
                        float(batch_cap))
            if abs(f_new - f) < 1e-9:
                break
            f = f_new
        fill = f
    else:
        fill = min(max(float(fill), 1.0), float(batch_cap))
    cycle_ms = cycle_of(fill)
    rho = rho_of(cycle_ms)
    predicted = replicas * fill * rho / (cycle_ms / 1e3)

    rec = {
        "replicas": int(replicas),
        "batch_cap": int(batch_cap),
        "dispatch_ms": round(float(dispatch_ms), 6),
        "floor_ms": None if floor_ms is None else round(floor_ms, 6),
        "service_ms": round(service_ms, 6),
        "overhead_per_req_ms": round(float(overhead_per_req_ms), 6),
        "cycle_ms": round(cycle_ms, 6),
        "budget_p99_ms": round(float(budget_p99_ms), 6),
        "max_wait_ms": round(float(max_wait_ms), 6),
        "utilization_cap": round(rho, 6),
        "fill": round(float(fill), 4),
        "predicted_rps": round(predicted, 3),
    }
    if mix:
        if any(w <= 0 for w in mix.values()):
            raise ValueError(
                f"mix needs positive tenant weights, got {mix}")
        wsum = sum(mix.values())
        rec["mix"] = {t: round(w / wsum, 6)
                      for t, w in sorted(mix.items())}
        rec["per_tenant_rps"] = {
            t: round(predicted * w / wsum, 3)
            for t, w in sorted(mix.items())}
    return rec


def observe_serving(records) -> dict:
    """Fold a ``serving``-kind JSONL record list (newest wins) into
    the observed inputs :func:`predict` takes: ``{"dispatch_ms"`` (the
    per-batch wall p50), ``"fill"`` (mean batch fill),
    ``"max_wait_ms"``, ``"batch_cap"`` (the fill cap knob)``}`` —
    absent keys mean the stream never carried that fact."""
    out: dict = {}
    for rec in records:
        if rec.get("kind") not in (None, "serving"):
            continue
        wall = rec.get("wall")
        if isinstance(wall, dict) and wall.get("p50_ms"):
            out["dispatch_ms"] = float(wall["p50_ms"])
        sv = rec.get("serving")
        if isinstance(sv, dict):
            if sv.get("mean_batch_fill"):
                out["fill"] = float(sv["mean_batch_fill"])
            knobs = sv.get("knobs")
            if isinstance(knobs, dict):
                if knobs.get("max_wait_ms") is not None:
                    out["max_wait_ms"] = float(knobs["max_wait_ms"])
                if knobs.get("batch_fill_cap") is not None:
                    out["batch_cap"] = int(knobs["batch_fill_cap"])
    return out


def verdict(prediction: dict, measured_rps: float,
            tol: float = 0.25) -> dict:
    """Judge one prediction against a replay-measured sustained rate:
    ``ratio = predicted / measured``, within tolerance when ``|ratio -
    1| <= tol``. Returns the JSONL-ready verdict block."""
    if measured_rps <= 0:
        raise ValueError(
            f"measured_rps must be > 0, got {measured_rps}")
    pred = float(prediction["predicted_rps"])
    ratio = pred / float(measured_rps)
    return {
        "predicted_rps": round(pred, 3),
        "measured_rps": round(float(measured_rps), 3),
        "ratio": round(ratio, 4),
        "abs_err_frac": round(abs(ratio - 1.0), 4),
        "tol": float(tol),
        "within_tol": abs(ratio - 1.0) <= tol,
    }


def emit(sink, rec: dict) -> dict:
    """Append one capacity record (a :func:`predict` output, usually
    with a ``verdict`` block merged in) to a ``metrics.MetricsSink``
    as kind ``capacity``."""
    return sink.emit(rec, kind="capacity")
