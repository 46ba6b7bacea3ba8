"""Trace replay: seeded multi-tenant arrival scenarios and a replay
loop (counterpart of ``quiver_tpu/traffic.py``; traces equal the JAX
package's array for array).

- :func:`generate_scenario` builds a seeded ``(tenant, arrival_ts,
  node)`` trace for a named scenario (:data:`SCENARIO_NAMES`): a steady
  Poisson mix, a diurnal rate curve, a flash crowd (one tenant
  multiplies its rate inside a window), or a hot-key storm (arrivals
  inside a window hit one contiguous region of ids). Every per-element
  draw comes from fixed ``datasets._GEN_BLOCK``-sized blocks keyed
  ``(sub_seed, block_start)``, and arrival ``i``'s time inverts the
  scenario's cumulative rate at ``(i + u_i) / n``, so any ``[lo, hi)``
  slicing assembles the same trace.
- :func:`replay` plays a trace against a live target (a
  ``serving.MicroBatchServer``, an ``rpc.RpcClient`` or a callable),
  pacing arrivals on the wall clock, and returns (and emits as kind
  ``replay`` JSONL) one record per tenant: offered and completed rates,
  latency percentiles, shed and reject counts.

numpy and the standard library at import time; the block generator,
the latency histogram and the server's typed error are imported when
used, so a replay-only client loads this module without torch.
"""

from __future__ import annotations

import concurrent.futures as _futures
import threading
import time
from typing import Dict, Optional

import numpy as np

from . import rpc as _rpc

__all__ = ["SCENARIO_NAMES", "generate_scenario", "replay"]

#: the scenario registry
SCENARIO_NAMES = ("steady", "diurnal", "flash_crowd", "hot_storm")

#: default tenant mix (weights, not probabilities — normalized at use):
#: the interactive-heavy steady state the capacity report assumes
DEFAULT_MIX = {"interactive": 0.5, "batch": 0.3, "best_effort": 0.2}

# sub-stream tags: each per-element random stream draws from its own
# seed lane (seed * 8 + tag keeps lanes injective across seeds)
_LANE_ARRIVAL, _LANE_TENANT, _LANE_NODE, _LANE_STORM = 0, 1, 2, 3


def _lane(seed: int, tag: int) -> int:
    return int(seed) * 8 + tag


def _uniform(seed: int, tag: int, lo: int, hi: int, n: int) -> np.ndarray:
    # lazy: datasets imports torch; generation pays that import, a
    # replay-only client never does
    from .datasets import _gen_block
    return _gen_block(_lane(seed, tag), lo, hi, n, (),
                      lambda r, k: r.random(k))


def generate_scenario(name: str, duration_s: float, rate_rps: float,
                      nodes: int, *, mix: Optional[Dict[str, float]] = None,
                      seed: int = 0, lo: int = 0, hi: Optional[int] = None,
                      skew: float = 2.0,
                      diurnal_amp: float = 0.5,
                      diurnal_period_s: Optional[float] = None,
                      flash_tenant: str = "best_effort",
                      flash_x: float = 10.0,
                      flash_start_frac: float = 0.4,
                      flash_dur_frac: float = 0.2,
                      storm_frac: float = 0.8,
                      storm_region_frac: float = 0.02,
                      storm_start_frac: float = 0.4,
                      storm_dur_frac: float = 0.2) -> dict:
    """A seeded multi-tenant arrival trace for scenario ``name``.

    Returns ``{"scenario", "duration_s", "rate_rps", "nodes",
    "tenants": (names...), "length": n, "seed", "t": float64 [m],
    "tenant": int16 [m] (index into ``tenants``), "node": int64 [m]}``
    where ``n = round(Λ(duration_s))`` is the WHOLE trace's arrival
    count and ``m = hi - lo`` is the requested slice of it.

    Scenario shapes (``Λ`` is the cumulative expected-arrival curve;
    arrival ``i`` lands at ``Λ⁻¹((i + uᵢ)/n · Λ(T))``, inverted by
    vectorized bisection — monotone, so per-element and therefore
    chunk-invariant):

    - ``steady`` — constant ``rate_rps``; tenants drawn from ``mix``.
    - ``diurnal`` — ``rate · (1 + amp · sin(2πt/period))`` (period
      defaults to the whole duration: one full cycle).
    - ``flash_crowd`` — steady base, but ``flash_tenant`` multiplies
      its arrival rate by ``flash_x`` inside the window
      ``[start_frac, start_frac + dur_frac) · T`` (both the total rate
      and the in-window tenant weights account for the surge — the
      flood-gate input: a 10x best-effort crowd over steady
      interactive traffic).
    - ``hot_storm`` — steady rate and mix, but inside the window each
      arrival's node is, with probability ``storm_frac``, drawn
      uniformly from ONE contiguous region of ``storm_region_frac *
      nodes`` ids (seed-chosen placement) instead of the power-law
      rank law — the correlated hot-key storm that slams one graph
      partition.

    Node ids otherwise follow the ``generate_drifting_trace`` rank law
    ``floor(nodes · u^skew)``. ``seed`` must be >= 0 (the block-keyed
    sub-streams use non-negative SeedSequence entries).
    """
    if name not in SCENARIO_NAMES:
        raise ValueError(
            f"unknown scenario {name!r} (known: {list(SCENARIO_NAMES)})")
    if duration_s < 0:
        raise ValueError(f"duration_s must be >= 0, got {duration_s}")
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if nodes < 1:
        raise ValueError(f"nodes must be >= 1, got {nodes}")
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    mix = dict(DEFAULT_MIX if mix is None else mix)
    if not mix or any(w <= 0 for w in mix.values()):
        raise ValueError(f"mix needs positive tenant weights, got {mix}")
    tenants = tuple(sorted(mix))
    weights = np.array([mix[t] for t in tenants], np.float64)
    wsum = float(weights.sum())
    T = float(duration_s)

    # -- the scenario's cumulative expected-arrival curve Λ(t) ---------------
    if name == "flash_crowd":
        if flash_tenant not in mix:
            raise ValueError(f"flash_tenant {flash_tenant!r} not in mix "
                             f"{sorted(mix)}")
        if flash_x < 1.0:
            raise ValueError(f"flash_x must be >= 1, got {flash_x}")
        w_flash = mix[flash_tenant] / wsum
        f0, f1 = flash_start_frac * T, (flash_start_frac
                                        + flash_dur_frac) * T

        def cum(t):
            burst = np.clip(t - f0, 0.0, max(f1 - f0, 0.0))
            return rate_rps * (t + w_flash * (flash_x - 1.0) * burst)
    elif name == "diurnal":
        if not 0.0 <= diurnal_amp < 1.0:
            raise ValueError(
                f"diurnal_amp must be in [0, 1), got {diurnal_amp}")
        period = float(diurnal_period_s
                       if diurnal_period_s is not None else max(T, 1e-9))
        if period <= 0:
            raise ValueError(
                f"diurnal_period_s must be > 0, got {period}")
        w = 2.0 * np.pi / period

        def cum(t):
            return rate_rps * (np.asarray(t, np.float64)
                               + diurnal_amp / w * (1.0 - np.cos(w * t)))
    else:                                   # steady / hot_storm
        def cum(t):
            return rate_rps * np.asarray(t, np.float64)

    total = float(cum(np.float64(T)))
    n = int(round(total))
    hi = n if hi is None else hi
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"need 0 <= lo <= hi <= length, got "
                         f"[{lo}, {hi}) of {n}")
    out = {"scenario": name, "duration_s": T, "rate_rps": float(rate_rps),
           "nodes": int(nodes), "tenants": tenants, "length": n,
           "seed": int(seed)}
    if hi == lo or n == 0:
        out.update(t=np.empty((0,), np.float64),
                   tenant=np.empty((0,), np.int16),
                   node=np.empty((0,), np.int64))
        return out

    # -- arrival times: invert Λ per element (bisection: Λ monotone) ---------
    u = _uniform(seed, _LANE_ARRIVAL, lo, hi, n)
    target = (np.arange(lo, hi, dtype=np.float64) + u) * (total / n)
    t_lo = np.zeros(hi - lo, np.float64)
    t_hi = np.full(hi - lo, T, np.float64)
    for _ in range(60):
        mid = 0.5 * (t_lo + t_hi)
        below = cum(mid) < target
        t_lo = np.where(below, mid, t_lo)
        t_hi = np.where(below, t_hi, mid)
    t = 0.5 * (t_lo + t_hi)

    # -- tenants: per-element categorical draw (window-aware weights) --------
    v = _uniform(seed, _LANE_TENANT, lo, hi, n)
    wmat = np.broadcast_to(weights, (hi - lo, len(tenants))).copy()
    if name == "flash_crowd":
        in_win = (t >= f0) & (t < f1)
        wmat[in_win, tenants.index(flash_tenant)] *= flash_x
    cw = np.cumsum(wmat, axis=1)
    cw /= cw[:, -1:]
    tenant = (v[:, None] >= cw).sum(axis=1).astype(np.int16)

    # -- nodes: power-law rank, storm window slams one region ----------------
    un = _uniform(seed, _LANE_NODE, lo, hi, n)
    node = np.minimum((nodes * un ** skew), nodes - 1).astype(np.int64)
    if name == "hot_storm":
        if not 0.0 <= storm_frac <= 1.0:
            raise ValueError(
                f"storm_frac must be in [0, 1], got {storm_frac}")
        region_w = max(1, int(storm_region_frac * nodes))
        # seed-chosen region placement: a deterministic scalar draw
        # (not part of any per-element stream, so it cannot perturb
        # chunk assembly)
        region_start = int(np.random.default_rng(
            [_lane(seed, _LANE_STORM), 1]).integers(
                0, max(nodes - region_w + 1, 1)))
        s0, s1 = storm_start_frac * T, (storm_start_frac
                                        + storm_dur_frac) * T
        draw = _uniform(seed, _LANE_STORM, lo, hi, n)
        hit = (t >= s0) & (t < s1) & (draw < storm_frac)
        region_node = region_start + np.minimum(
            (un * region_w).astype(np.int64), region_w - 1)
        node = np.where(hit, region_node, node)
    out.update(t=t, tenant=tenant, node=node)
    return out


# -- replay -------------------------------------------------------------------


class _TenantTally:
    """Host-side per-tenant outcome fold for one replay (internal)."""

    __slots__ = ("offered", "accepted", "rejected", "failed",
                 "deadline_expired", "completed", "hist")

    def __init__(self):
        from .metrics import _Histogram
        self.offered = 0
        self.accepted = 0
        self.rejected = 0
        self.failed = 0
        self.deadline_expired = 0
        self.completed = 0
        self.hist = _Histogram()


def _classify(exc, overload_error) -> str:
    """Outcome key for one failed request: the shed-order evidence
    depends on rejects being counted as rejects, not generic
    failures."""
    if isinstance(exc, _rpc.DeadlineExceeded):
        return "deadline_expired"
    if isinstance(exc, _rpc.Overloaded):
        return "rejected"
    if overload_error is not None and isinstance(exc, overload_error):
        return "rejected"
    return "failed"


def replay(trace: dict, target, *, speed: float = 1.0,
           budget_ms: Optional[float] = None, sink=None,
           drain_timeout_s: float = 60.0) -> dict:
    """Play one :func:`generate_scenario` trace against ``target``,
    pacing arrivals on the wall clock (``speed`` > 1 compresses time).

    ``target`` is duck-typed by probe order:

    - ``submit(node, tenant=...)`` — a ``serving.MicroBatchServer``
      (or a stub with the same contract) returning a
      ``concurrent.futures.Future``;
    - ``lookup_future(node, budget_ms=..., tenant=...)`` — an
      ``rpc.RpcClient`` against a live fleet;
    - otherwise called as ``target(node, tenant)`` synchronously.

    Admission rejections (``serving.OverloadError``,
    ``rpc.Overloaded``) and deadline expiries are counted per tenant,
    never raised — an overloaded target is a measurement, not an
    error. Returns ``{"scenario", "wall_s", "offer_wall_s" (how long
    the offer loop itself ran — past ``duration_s`` means the
    generator, not the target, was the bottleneck), "speed",
    "tenants": {name: record}}`` and, when ``sink`` is given, emits
    each per-tenant record as kind ``replay`` JSONL."""
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    try:
        from .serving import OverloadError as _OverloadError
    except Exception:                       # pragma: no cover - no torch
        _OverloadError = None
    submit = getattr(target, "submit", None)
    lookup = getattr(target, "lookup_future", None)
    tenants = tuple(trace["tenants"])
    tally = {name: _TenantTally() for name in tenants}
    lock = threading.Lock()
    pending = []                            # (tenant, future, t_submit)

    # pre-resolve the trace into plain python (the submit loop is the
    # generator's hot path: per-arrival numpy indexing would cap the
    # offered rate well below a busy server's capacity)
    t_sched = (np.asarray(trace["t"], np.float64) / speed).tolist()
    names_seq = [tenants[i] for i in
                 np.asarray(trace["tenant"]).tolist()]
    nodes_seq = np.asarray(trace["node"]).tolist()
    done_lat: Dict[int, float] = {}
    t0 = time.perf_counter()
    for k in range(len(t_sched)):
        delay = t_sched[k] - (time.perf_counter() - t0)
        if delay > 0.0015:
            # sub-quantum sleep guard: sleep most of it, absorb the
            # scheduler slop
            time.sleep(delay - 0.001)
        name = names_seq[k]
        node = nodes_seq[k]
        tl = tally[name]
        with lock:
            tl.offered += 1
        t_sub = time.perf_counter()
        try:
            if submit is not None:
                fut = submit(node, tenant=name)
            elif lookup is not None:
                fut = lookup(node, budget_ms=budget_ms, tenant=name)
            else:
                row = target(node, name)
                with lock:
                    tl.accepted += 1
                    tl.completed += 1
                    tl.hist.add(time.perf_counter() - t_sub)
                continue
        except Exception as e:
            key = _classify(e, _OverloadError)
            with lock:
                setattr(tl, key, getattr(tl, key) + 1)
            continue
        with lock:
            tl.accepted += 1
        # done-callback latency capture: the completion instant is the
        # callback's, not the drain loop's (the drain may lag)
        fut.add_done_callback(
            lambda f, i=len(pending), t=t_sub:
                done_lat.setdefault(i, time.perf_counter() - t))
        pending.append((name, fut, t_sub))
    # how long the offer loop itself took: when this outruns the
    # trace's duration the GENERATOR was the bottleneck, and the
    # replay measured its own pacing loop, not the target
    offer_wall = time.perf_counter() - t0

    deadline = time.perf_counter() + drain_timeout_s
    for i, (name, fut, t_sub) in enumerate(pending):
        tl = tally[name]
        try:
            fut.result(timeout=max(deadline - time.perf_counter(), 0.0))
            with lock:
                tl.completed += 1
                tl.hist.add(done_lat.get(
                    i, time.perf_counter() - t_sub))
        except _futures.CancelledError:
            with lock:
                tl.failed += 1
        except Exception as e:
            key = _classify(e, _OverloadError)
            with lock:
                setattr(tl, key, getattr(tl, key) + 1)
    wall = time.perf_counter() - t0

    recs = {}
    for name in tenants:
        tl = tally[name]
        with lock:
            n, total, mx = tl.hist.n, tl.hist.total, tl.hist.max
            p50, p99 = tl.hist.quantile(0.5), tl.hist.quantile(0.99)
            rec = {
                "scenario": trace.get("scenario"),
                "tenant": name,
                "offered": tl.offered,
                "accepted": tl.accepted,
                "rejected": tl.rejected,
                "failed": tl.failed,
                "deadline_expired": tl.deadline_expired,
                "completed": tl.completed,
                "wall_s": round(wall, 6),
                "speed": float(speed),
                "offered_rps": tl.offered / wall if wall else None,
                "completed_rps": tl.completed / wall if wall else None,
                "latency": {
                    "n": n,
                    "mean_ms": 1e3 * total / n if n else None,
                    "p50_ms": 1e3 * p50 if n else None,
                    "p99_ms": 1e3 * p99 if n else None,
                    "max_ms": 1e3 * mx if n else None,
                },
            }
        recs[name] = rec
    if sink is not None:
        for rec in recs.values():
            sink.emit(rec, kind="replay")
    return {"scenario": trace.get("scenario"), "wall_s": wall,
            "offer_wall_s": round(offer_wall, 6),
            "speed": float(speed), "tenants": recs}
