"""Advice-driven actuation: the controller that closes the
observe/decide loop (counterpart of ``quiver_tpu/actuator.py``; the same
decisions and records).

``TelemetryHub.replan()`` emits ``advice`` sized from observed
distributions, and ``fleet.ReplicaSupervisor``/``fleet.HealthRouter``
are actuation surfaces. The :class:`Actuator` consumes the advice and
acts, at three levels:

- **knobs**: swap a serving knob (the batch fill cap, the coalescing
  deadline) to a point of its declared lattice only. In the JAX package
  the lattice is the set a census of compiled programs counted
  (:func:`lattice_from_census` reads one, duck-typed on ``spec.axes``);
  the port compiles no programs, and its serving knobs change no shape
  (the fill cap pads inside the engine's ``[batch_cap]`` seeds, the
  deadline is host timing), so the lattice disciplines the swaps. A
  recommendation outside the lattice is refused with a WARN ``actuate``
  record and nothing changes. At most one swap per knob per
  ``cooldown_s``.
- **hot-set rotation**: :meth:`Actuator.observe_ids` folds the served
  ids into a host-side hit census, and :meth:`Actuator.maybe_rotate`
  swaps the least-hit hot rows for the most-hit cold rows through
  ``Feature.rotate_hot_set`` (the rows bit for bit the store's, nothing
  rebuilt), then ``ServeEngine.refresh_feature``. A store with a disk
  tier stages its hottest cold rows instead
  (:meth:`Actuator.maybe_promote`, ``Feature.stage_frontier``).
- **fleet**: ``HealthRouter.plan_quality`` turns the replicas' SLO burn
  into one fleet-wide quality floor (:meth:`Actuator.plan_fleet`,
  through ``MicroBatchServer.set_shed_floor``), and
  :class:`FleetAutoscaler` grows or shrinks a ``ReplicaSupervisor``
  from the burn and queue series, draining a replica through the
  router before retiring it.

Every action emits one ``actuate`` JSONL record with the observed
metrics before and after (the after side is sampled once ``settle_s``
has passed, at the next :meth:`Actuator.tick`). Refusals and
suppressions emit at once, at WARN and INFO. :data:`ACTUATION_KEYS`
lists the keys a record can carry.

Usage (one closed loop over a live server)::

    act = Actuator(hub=hub, sink=sink)
    act.attach_server(server)
    ...
    act.observe_ids(batch_ids)        # per served batch (host-side)
    act.tick()                        # periodically: advice -> knobs
    act.maybe_rotate(feature, engine) # periodically: hit census -> tiers
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ACTUATION_KEYS", "Actuator", "FleetAutoscaler", "Knob",
           "lattice_from_census"]

#: keys an ``actuate`` record can carry
ACTUATION_KEYS = ("batch_cap", "max_wait_ms", "hot_set", "fleet_shed",
                  "replicas")


@dataclasses.dataclass
class Knob:
    """One actuatable knob: how to read it, how to apply a new value,
    and the pre-census'd ``lattice`` of values it may ever take.

    The lattice IS the safety contract — a census axis of the programs
    the knob feeds (:func:`lattice_from_census` extracts it), or values
    that change no shape by construction (the serving knobs: the fill
    cap and the deadline). ``apply`` must be cheap and
    synchronous; the actuator calls it while holding no lock of its
    own."""

    key: str
    read: Callable[[], Any]
    apply: Callable[[Any], None]
    lattice: Tuple
    cooldown_s: Optional[float] = None   # None = the actuator default

    def snap(self, value):
        """The lattice point ``value`` lands on, or None when it is
        outside the lattice (ints match exactly; floats within 1e-9
        relative — advice rounds through JSON)."""
        for p in self.lattice:
            if p == value:
                return p
            try:
                if abs(float(p) - float(value)) <= 1e-9 * max(
                        abs(float(p)), abs(float(value)), 1.0):
                    return p
            except (TypeError, ValueError):
                continue
        return None


def lattice_from_census(spec, axis: str) -> Tuple:
    """The discrete value lattice a census spec declares for ``axis``
    (anything with an ``axes`` mapping) — the bridge from a counted
    program set to a :class:`Knob`'s allowed points. Refuses unbounded axes (an int
    cardinality names a COUNT, not the values; a knob built from it
    would actuate uncounted programs)."""
    if axis not in spec.axes:
        raise KeyError(f"census has no axis {axis!r} "
                       f"(axes: {sorted(spec.axes)})")
    vals = spec.axes[axis]
    if vals is None or isinstance(vals, (int, str, bytes)):
        raise ValueError(
            f"census axis {axis!r} is not an enumerated lattice "
            f"({vals!r}) — an actuator needs the VALUES the census "
            "counted, not a cardinality")
    return tuple(vals)


class _Pending:
    """One applied action awaiting its after-window sample."""

    def __init__(self, rec: dict, key: str, settle_at: float):
        self.rec = rec
        self.key = key
        self.settle_at = settle_at


class Actuator:
    """The advice consumer. ``tick()`` pulls the newest advice (from
    ``hub.replan()`` when a hub is attached, or an explicit record
    list — what tests drive) and actuates every registered knob it
    names; rotation and fleet planning are separate explicit calls
    because their cadence differs (see the module docstring).

    - ``cooldown_s`` — minimum seconds between swaps of the SAME knob
      (per-knob override via :class:`Knob`); oscillating advice
      across a lattice boundary produces at most one swap per window,
      the rest are suppressed (counted, and emitted at most once per
      window as an INFO ``suppress`` record).
    - ``settle_s`` — how long an applied action waits before its
      after-window metrics are sampled and the completed ``actuate``
      record emits (the before/after pair is the record's point).
    - ``clock`` — injectable monotonic clock (tests pin hysteresis
      deterministically).

    Thread-safety: one control thread calls ``tick``/``maybe_rotate``
    /``plan_fleet``; ``observe_ids`` may race it from the serving
    thread (it only touches the hit census under its own lock)."""

    def __init__(self, hub=None, sink=None, cooldown_s: float = 30.0,
                 settle_s: float = 5.0, clock=None):
        self.hub = hub
        self.sink = sink
        self.cooldown_s = float(cooldown_s)
        self.settle_s = float(settle_s)
        self._clock = clock if clock is not None else time.monotonic
        self.knobs: Dict[str, Knob] = {}
        self._last_action: Dict[str, float] = {}
        self._last_suppress: Dict[str, float] = {}
        self._pending: List[_Pending] = []
        self.records: List[dict] = []       # every emitted record
        self.applied = 0
        self.refused = 0
        self.suppressed = 0
        # the rotation hit census (hot-set adaptation): node id ->
        # observed lookups since the last rotation
        self._hits: Optional[np.ndarray] = None
        self._hits_lock = threading.Lock()

    # -- record plumbing -----------------------------------------------------
    def _emit(self, rec: dict) -> dict:
        rec.setdefault("level", "INFO")
        self.records.append(rec)
        if self.sink is not None:
            self.sink.emit(rec, kind="actuate")
        return rec

    def _observed(self, key: str) -> Optional[dict]:
        """The newest observed-metrics block for ``key`` — the advice
        record's ``observed`` dict (the hub keeps latest-per-key), the
        shared vocabulary both sides of a before/after pair use."""
        if self.hub is None:
            return None
        rec = self.hub.advice.get(key)
        return rec.get("observed") if rec else None

    def _cooldown(self, knob_key: str,
                  override: Optional[float] = None) -> float:
        if override is not None:
            return override
        k = self.knobs.get(knob_key)
        if k is not None and k.cooldown_s is not None:
            return k.cooldown_s
        return self.cooldown_s

    def _in_cooldown(self, key: str, now: float,
                     override: Optional[float] = None) -> bool:
        last = self._last_action.get(key)
        return (last is not None
                and now - last < self._cooldown(key, override))

    # -- knob registration ---------------------------------------------------
    def register(self, knob: Knob) -> Knob:
        """Register one knob under its advice key (replacing any
        previous binding)."""
        if not knob.lattice:
            raise ValueError(f"knob {knob.key!r} has an empty lattice")
        self.knobs[knob.key] = knob
        return knob

    def attach_server(self, server,
                      max_wait_lattice: Sequence[float] = (
                          0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0),
                      batch_cap_lattice: Optional[Sequence[int]] = None,
                      ) -> "Actuator":
        """Bind the two serving knobs the hub's advisors size:

        - ``batch_cap`` -> ``server.set_batch_fill_cap``. The default
          lattice is every power of two up to the engine's
          ``batch_cap`` — all padding-only (the seed shape never
          changes); a recommendation to grow PAST the engine's cap
          falls outside the lattice and is refused (it would need a
          new engine).
        - ``max_wait_ms`` -> ``server.set_max_wait_ms`` (host-side
          timing; the lattice only disciplines hysteresis)."""
        caps = (tuple(int(c) for c in batch_cap_lattice)
                if batch_cap_lattice is not None else tuple(
                    1 << i for i in range(
                        server.engine.batch_cap.bit_length())
                    if (1 << i) <= server.engine.batch_cap))
        bad = [c for c in caps if not 1 <= c <= server.engine.batch_cap]
        if bad:
            raise ValueError(
                f"batch_cap lattice points {bad} fall outside the "
                f"compiled [1, {server.engine.batch_cap}] range")
        self.register(Knob(
            key="batch_cap",
            read=lambda: server.knobs()["batch_fill_cap"],
            apply=server.set_batch_fill_cap, lattice=caps))
        self.register(Knob(
            key="max_wait_ms",
            read=lambda: server.knobs()["max_wait_ms"],
            apply=server.set_max_wait_ms,
            lattice=tuple(float(w) for w in max_wait_lattice)))
        return self

    # -- the advice consumer -------------------------------------------------
    def tick(self, advice: Optional[Sequence[dict]] = None
             ) -> List[dict]:
        """One control pass: finalize settled actions, then actuate
        the newest advice. Returns the records emitted this pass."""
        now = self._clock()
        out = self._finalize(now)
        if advice is None:
            advice = self.hub.replan() if self.hub is not None else []
        for rec in advice:
            key = rec.get("key")
            if key in self.knobs:
                done = self._actuate(key, rec, now)
                if done is not None:
                    out.append(done)
        return out

    def _finalize(self, now: float) -> List[dict]:
        out = []
        still = []
        for p in self._pending:
            if now < p.settle_at:
                still.append(p)
                continue
            p.rec["after"]["observed"] = self._observed(p.key)
            out.append(self._emit(p.rec))
        self._pending = still
        return out

    def flush(self) -> List[dict]:
        """Finalize every pending action NOW (shutdown path — a
        record with a missing after-window beats a lost record)."""
        for p in self._pending:
            p.settle_at = -float("inf")
        return self._finalize(self._clock())

    def _actuate(self, key: str, advice: dict,
                 now: float) -> Optional[dict]:
        knob = self.knobs[key]
        cur = knob.read()
        target = knob.snap(advice.get("recommended"))
        if target is None:
            # out of the census'd lattice: refuse LOUDLY, touch
            # nothing — the census is the safety proof and this point
            # was never counted
            self.refused += 1
            return self._emit({
                "key": key, "action": "refuse", "level": "WARN",
                "recommended": advice.get("recommended"),
                "lattice": list(knob.lattice),
                "before": {"value": cur,
                           "observed": advice.get("observed")},
                "reason": "recommended point is outside the "
                          "pre-census'd lattice"})
        if target == cur:
            return None
        if self._in_cooldown(key, now):
            # hysteresis: at most one swap per cooldown window, and
            # at most one suppress record per window (oscillating
            # advice must not flood the sink either)
            self.suppressed += 1
            if self._last_suppress.get(key) == \
                    self._last_action.get(key):
                return None
            self._last_suppress[key] = self._last_action.get(key)
            return self._emit({
                "key": key, "action": "suppress",
                "recommended": target,
                "before": {"value": cur},
                "cooldown_s": round(self._cooldown(key), 3),
                "reason": advice.get("reason")})
        knob.apply(target)
        self.applied += 1
        self._last_action[key] = now
        rec = {"key": key, "action": "apply",
               "recommended": advice.get("recommended"),
               "before": {"value": cur,
                          "observed": advice.get("observed")},
               "after": {"value": knob.read(), "observed": None},
               "reason": advice.get("reason")}
        self._pending.append(_Pending(rec, key,
                                      now + self.settle_s))
        return rec

    # -- hot-set rotation (FastSample-style adaptation) ----------------------
    def observe_ids(self, node_ids, total_rows: Optional[int] = None
                    ) -> None:
        """Fold one served batch's node ids into the hit census
        (host-side ``bincount`` — never on the lookup hot path; -1
        padding is ignored). Cheap enough to call per batch."""
        ids = np.asarray(node_ids).reshape(-1)
        ids = ids[ids >= 0].astype(np.int64)
        if ids.size == 0:
            return
        need = int(ids.max()) + 1
        if total_rows is not None:
            need = max(need, int(total_rows))
        with self._hits_lock:
            if self._hits is None or self._hits.shape[0] < need:
                grown = np.zeros((need,), np.int64)
                if self._hits is not None:
                    grown[:self._hits.shape[0]] = self._hits
                self._hits = grown
            np.add.at(self._hits, ids, 1)

    def hit_census(self) -> Optional[np.ndarray]:
        """A copy of the observed per-node hit counts (None before the
        first :meth:`observe_ids`)."""
        with self._hits_lock:
            return None if self._hits is None else self._hits.copy()

    def reset_hits(self) -> None:
        with self._hits_lock:
            self._hits = None

    def maybe_rotate(self, feature, engine=None, max_rows: int = 64,
                     min_gain: int = 1,
                     cooldown_s: Optional[float] = None
                     ) -> Optional[dict]:
        """Rotate up to ``max_rows`` hot/cold pairs where an observed
        cold row out-hit an observed hot row by at least ``min_gain``
        lookups — ``Feature.rotate_hot_set`` under the ``hot_set``
        cooldown, refreshing ``engine``'s captured tiers afterwards.
        Returns the ``actuate`` record, or None when nothing rotated
        (no census yet, no profitable pair, or cooling down). The hit
        census resets after a rotation — the next window measures the
        NEW placement, not the grievances that caused it."""
        now = self._clock()
        if self._in_cooldown("hot_set", now, cooldown_s):
            return None
        with self._hits_lock:
            hits = None if self._hits is None else self._hits.copy()
        if hits is None:
            return None
        order = feature._order_host()
        if order is None or not feature.cache_rows:
            return None
        n = min(order.shape[0], hits.shape[0])
        counts = np.zeros((order.shape[0],), np.int64)
        counts[:n] = hits[:n]
        hot_mask = order < feature.cache_rows
        hot_ids = np.nonzero(hot_mask)[0]
        cold_ids = np.nonzero(~hot_mask)[0]
        if hot_ids.size == 0 or cold_ids.size == 0:
            return None
        k = min(int(max_rows), hot_ids.size, cold_ids.size)
        # coldest residents vs hottest outsiders, paired best-vs-worst
        hot_by = hot_ids[np.argsort(counts[hot_ids],
                                    kind="stable")][:k]
        cold_by = cold_ids[np.argsort(-counts[cold_ids],
                                      kind="stable")][:k]
        gain = counts[cold_by] - counts[hot_by]
        take = gain >= int(min_gain)
        if not take.any():
            return None
        promote, demote = cold_by[take], hot_by[take]
        before = (self.hub.snapshot()["derived"].get("hot_hit_rate")
                  if self.hub is not None else None)
        res = feature.rotate_hot_set(promote, demote)
        if engine is not None:
            engine.refresh_feature()
        self._last_action["hot_set"] = now
        self.reset_hits()
        self.applied += 1
        rec = {"key": "hot_set", "action": "rotate",
               "rotated": res["rotated"],
               "before": {"value": None,
                          "observed": {
                              "hot_hit_rate": before,
                              "gain_hits": int(counts[promote].sum()
                                               - counts[demote].sum()),
                          }},
               "after": {"value": res["rotated"], "observed": None},
               "reason": f"{res['rotated']} observed-hot cold rows "
                         "out-hit the coldest residents"}
        self._pending.append(_Pending(rec, "hot_set",
                                      now + self.settle_s))
        return rec

    def maybe_promote(self, feature, top: int = 256,
                      min_hit_rate: float = 0.5) -> Optional[dict]:
        """Disk/mmap-tier adaptation: when the observed
        ``prefetch_hit_rate`` sits under ``min_hit_rate``, publish the
        ``top`` hottest observed COLD ids to the store's
        ``StagingRing`` (``stage_frontier``) so the prefetcher holds
        the drifted hot set resident. No tier bytes move and nothing
        is rebuilt — this is a staging hint, the rotation analogue
        for stores whose cold tier is pinned."""
        if self.hub is not None:
            rate = self.hub.snapshot()["derived"].get(
                "prefetch_hit_rate")
            if rate is not None and rate >= float(min_hit_rate):
                return None
        else:
            rate = None
        with self._hits_lock:
            hits = None if self._hits is None else self._hits.copy()
        if hits is None:
            return None
        order = feature._order_host()
        if order is None:
            return None
        n = min(order.shape[0], hits.shape[0])
        ids = np.nonzero((order[:n] >= feature.cache_rows)
                         & (hits[:n] > 0))[0]
        if ids.size == 0:
            return None
        ids = ids[np.argsort(-hits[ids], kind="stable")][:int(top)]
        fut = feature.stage_frontier(ids.astype(np.int32))
        if fut is None:
            return None
        return self._emit({
            "key": "hot_set", "action": "promote",
            "rows": int(ids.size),
            "before": {"observed": {"prefetch_hit_rate": rate}},
            "reason": "observed-hot cold rows staged into the ring "
                      "(prefetch hit rate under target)"})

    # -- fleet quality planning ----------------------------------------------
    def plan_fleet(self, server, snapshot: dict,
                   cooldown_s: Optional[float] = None
                   ) -> Optional[dict]:
        """Apply ``HealthRouter.plan_quality``'s planned fleet-wide
        shed floor to this replica's server (every replica's actuator
        runs the same deterministic plan over the same aggregator
        snapshot — agreement without coordination). Emits under the
        ``fleet_shed`` key; the cooldown stops an oscillating fleet
        burn from flapping the floor."""
        from .fleet import HealthRouter
        now = self._clock()
        ladder = max(len(server.engine.variants) - 1, 0)
        plan = HealthRouter.plan_quality(snapshot, ladder)
        cur = server.knobs()["shed_floor"]
        floor = plan["shed_floor"]
        if floor == cur:
            return None
        if self._in_cooldown("fleet_shed", now, cooldown_s):
            self.suppressed += 1
            return None
        server.set_shed_floor(floor)
        self._last_action["fleet_shed"] = now
        self.applied += 1
        return self._emit({
            "key": "fleet_shed", "action": "apply",
            "before": {"value": cur,
                       "observed": {k: plan[k] for k in
                                    ("burn_mean", "burn_max",
                                     "considered", "stale_count")}},
            "after": {"value": floor, "observed": None},
            "reason": "planned fleet-wide quality floor "
                      f"(ladder {ladder})"})

    def snapshot(self) -> dict:
        return {"knobs": sorted(self.knobs),
                "applied": self.applied, "refused": self.refused,
                "suppressed": self.suppressed,
                "pending": len(self._pending),
                "records": len(self.records)}


# -- elastic fleet autoscaling -------------------------------------------------


class FleetAutoscaler:
    """Grow/shrink a ``ReplicaSupervisor``'s replica count from the
    aggregator's burn + queue-depth series — the planned scalability
    response (capacity follows observed load,
    instead of every replica degrading alone).

    Feed :meth:`step` one :class:`~quiver_tpu_torch.fleet.FleetAggregator`
    snapshot per poll (``agg.on_poll.append(scaler.step)`` wires it
    live) plus the fleet queue depth when the caller tracks it
    separately. Policy, deterministic and arguable:

    - **scale up** when the mean live-replica burn exceeds
      ``burn_up`` OR the queue depth exceeds ``queue_up`` for
      ``sustain`` consecutive polls (one noisy poll is not load);
    - **scale down** when burn stays under ``burn_down`` AND the
      queue stays empty for ``calm`` consecutive polls;
    - never below ``min_replicas`` or above ``max_replicas``, at
      most one action per ``cooldown_s``;
    - scale-down retires the newest replica THROUGH the router's
      drain path (``supervisor.shrink(drain=router.drain,
      drain_wait_s=...)``) — no new traffic routes at the victim
      while its in-flight requests resolve, the zero-loss property
      the chaos gate pins.

    Every action emits an ``actuate`` record (key ``replicas``) with
    the before/after replica count and the burn/queue evidence."""

    def __init__(self, supervisor, router=None, sink=None,
                 min_replicas: int = 1, max_replicas: int = 8,
                 burn_up: float = 1.5, burn_down: float = 0.75,
                 queue_up: float = 8.0, sustain: int = 2,
                 calm: int = 5, cooldown_s: float = 30.0,
                 drain_wait_s: float = 0.5, clock=None):
        if not 1 <= int(min_replicas) <= int(max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas} / {max_replicas}")
        self.supervisor = supervisor
        self.router = router
        self.sink = sink
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.burn_up = float(burn_up)
        self.burn_down = float(burn_down)
        self.queue_up = float(queue_up)
        self.sustain = max(int(sustain), 1)
        self.calm = max(int(calm), 1)
        self.cooldown_s = float(cooldown_s)
        self.drain_wait_s = float(drain_wait_s)
        self._clock = clock if clock is not None else time.monotonic
        self._pressed = 0
        self._calm = 0
        self._last_action: Optional[float] = None
        self.records: List[dict] = []
        self.trajectory: List[int] = []      # replica count per step

    def _emit(self, rec: dict) -> dict:
        rec.setdefault("level", "INFO")
        self.records.append(rec)
        if self.sink is not None:
            self.sink.emit(rec, kind="actuate")
        return rec

    @staticmethod
    def _burn(snapshot: dict) -> Optional[float]:
        burns = []
        for rec in (snapshot.get("replicas") or {}).values():
            comp = rec.get("components") or {}
            if rec.get("stale") or comp.get("stale"):
                continue
            b = comp.get("burn")
            if b is not None:
                burns.append(float(b))
        return sum(burns) / len(burns) if burns else None

    def step(self, snapshot: dict,
             queue_depth: Optional[float] = None) -> Optional[dict]:
        """Fold one fleet snapshot; possibly act. Returns the
        ``actuate`` record when an action ran, else None."""
        now = self._clock()
        burn = self._burn(snapshot)
        count = self.supervisor.replica_count
        self.trajectory.append(count)
        hot = ((burn is not None and burn > self.burn_up)
               or (queue_depth is not None
                   and queue_depth > self.queue_up))
        cold = ((burn is None or burn < self.burn_down)
                and (queue_depth is None or queue_depth <= 0))
        self._pressed = self._pressed + 1 if hot else 0
        self._calm = self._calm + 1 if cold else 0
        if self._last_action is not None and \
                now - self._last_action < self.cooldown_s:
            return None
        evidence = {"burn_mean": (None if burn is None
                                  else round(burn, 4)),
                    "queue_depth": queue_depth}
        if self._pressed >= self.sustain and count < self.max_replicas:
            added = self.supervisor.grow(1)
            self._last_action = now
            self._pressed = 0
            return self._emit({
                "key": "replicas", "action": "scale_up",
                "replicas": added,
                "before": {"value": count, "observed": evidence},
                "after": {"value": count + len(added),
                          "observed": None},
                "reason": "sustained burn/queue pressure"})
        if self._calm >= self.calm and count > self.min_replicas:
            drain = self.router.drain if self.router is not None \
                else None
            gone = self.supervisor.shrink(
                1, drain=drain, drain_wait_s=self.drain_wait_s)
            if self.router is not None:
                for name in gone:
                    self.router.forget(name)
            self._last_action = now
            self._calm = 0
            return self._emit({
                "key": "replicas", "action": "scale_down",
                "replicas": gone,
                "before": {"value": count, "observed": evidence},
                "after": {"value": count - len(gone),
                          "observed": None},
                "reason": "sustained calm (drained before retiring)"})
        return None
