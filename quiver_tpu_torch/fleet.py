"""The fleet's observability and control plane: telemetry aggregation
over replica processes, health-weighted routing, replica supervision,
and a Prometheus and health endpoint (counterpart of
``quiver_tpu/fleet.py``; the same picks, schedules and text).

Every replica already writes a ``MetricsSink`` JSONL file (with its
``meta`` header), so the fleet plane is a reader of those files, not a
wire format:

- :class:`FleetAggregator` tails N replicas' sink files and folds them
  through ``TelemetryHub.ingest_records`` into one hub per replica and
  one for the fleet (cumulative counters diffed per source, gauge
  points high-water-marked, so re-reading a growing file never counts
  twice). Each poll scores every replica's health
  (``serving.health_score``: SLO burn, shed level, staleness); a
  replica whose sink stops advancing is stale: health 0 and one
  ``anomaly`` record (detector ``staleness``). One ``fleet`` record per
  poll carries the verdict; kept ``trace`` records are assembled by
  ``trace_id`` (``tailsampling.TraceStore``).
- :class:`HealthRouter` draws a replica weighted by health (seeded),
  drains one whose score falls below ``drain_below`` and re-admits it
  past ``readmit_above``, and can blend in partition locality
  (``partition.build_locality_table``).
- :class:`ReplicaSupervisor` spawns replica processes, restarts a
  crashed one under capped exponential backoff, opens a breaker on a
  crash loop, grows and shrinks the set without losing a request, and
  kills one on demand.
- :func:`prometheus_text` and :class:`FleetExporter`: ``/metrics`` in
  the Prometheus text format (with OpenMetrics exemplars pointing at
  kept traces) and ``/healthz`` (the fleet verdict; 503 only when every
  replica is stale), on a standard-library HTTP server.

Everything here is host-side file reading and process management on
threads of its own; none of it touches the card.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import random
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import metrics as _metrics
from .serving import health_score
from .tailsampling import TraceStore
from .telemetry import TelemetryHub

__all__ = ["FleetAggregator", "FleetExporter", "HealthRouter",
           "ReplicaSupervisor", "health_score", "prometheus_text"]

_log = logging.getLogger("quiver_tpu_torch.fleet")


class _Replica:
    """One replica's aggregation state (internal)."""

    def __init__(self, name: str, path, capacity: int, window: int):
        self.name = name
        self.path = str(path)
        self.hub = TelemetryHub(capacity=capacity, window=window,
                                watches=())
        self.meta: Optional[dict] = None
        self.last_serving: Optional[dict] = None
        self.tenants: dict = {}   # latest `tenant` record per class
        self.records = 0          # kind-matching records ever folded
        self.last_new: Optional[float] = None   # clock of last advance
        self.stale = False
        self.health = 1.0
        self.components: dict = {}


class FleetAggregator:
    """Tail N replicas' ``MetricsSink`` JSONL files into per-replica
    and fleet-global :class:`TelemetryHub` series + health scores.

    ``replicas`` is ``{name: sink_path}`` (or a path list — names
    default to ``r0..rN-1``). ``poll()`` runs one aggregation pass and
    returns the fleet snapshot; ``start()`` spins a daemon thread
    polling every ``interval_s`` until :meth:`close` (idempotent, also
    reaped by a finalizer). A replica with no new records for
    ``stale_after_s`` (default ``3 * interval_s``) is STALE: health 0,
    one ``anomaly`` record (detector ``staleness``) emitted on the
    transition; it recovers the moment its sink advances again.

    ``sink`` (a ``metrics.MetricsSink``) receives one ``fleet`` record
    per poll plus the staleness anomalies; the fleet-global hub also
    emits its own detector ``anomaly`` records through it (regime
    shifts visible only in the merged series).

    Each poll re-reads every replica sink whole (the fold is
    idempotent, only the tail is ingested) — so long-running replicas
    should write SIZE-BOUNDED sinks (``MetricsSink(max_bytes=...)``),
    which caps a poll's parse work at ``2 * max_bytes`` per replica
    forever; an unbounded sink makes polls grow linearly with its
    history. Poll passes are serialized on their own lock, and the
    scored state the exporter snapshots is guarded separately, so a
    slow poll (or a slow sink disk) never stalls a ``/metrics`` or
    ``/healthz`` answer."""

    def __init__(self, replicas, interval_s: float = 2.0,
                 stale_after_s: Optional[float] = None,
                 sink=None, capacity: int = 512, window: int = 8,
                 kinds: Sequence[str] = TelemetryHub.INGEST_KINDS,
                 trace_capacity: int = 256, clock=None):
        if isinstance(replicas, dict):
            items = list(replicas.items())
        else:
            items = [(f"r{i}", p) for i, p in enumerate(replicas)]
        if not items:
            raise ValueError("need at least one replica sink path")
        names = [n for n, _ in items]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names in {names}")
        self.interval_s = float(interval_s)
        self.stale_after_s = (float(stale_after_s)
                              if stale_after_s is not None
                              else 3.0 * self.interval_s)
        self.sink = sink
        self.kinds = tuple(kinds)
        self._clock = clock if clock is not None else time.monotonic
        self.fleet = TelemetryHub(capacity=capacity, window=window,
                                  sink=sink)
        self._replicas: "collections.OrderedDict[str, _Replica]" = \
            collections.OrderedDict(
                (n, _Replica(n, p, capacity, window)) for n, p in items)
        self.anomalies: "collections.deque" = collections.deque(
            maxlen=64)
        # the fleet trace assembler: per-replica `trace`
        # records (kept by each replica's TailSampler) stitch by the
        # propagated global trace_id — client RPC spans + replica
        # serve spans in one assembled record; bounded LRU, and
        # `latest()` is what the /metrics exemplars point at
        self.traces = TraceStore(capacity=trace_capacity)
        self.polls = 0
        self.poll_errors = 0
        # observers called with each poll's snapshot AFTER every lock
        # releases (same discipline as sink emission) — how a
        # HealthRouter follows the aggregator's verdicts live
        self.on_poll: List[Callable[[dict], None]] = []
        self._t_start = self._clock()
        # two locks: _poll_lock serializes whole aggregation passes
        # (file reads + hub folds + any sink emission the fleet hub's
        # detectors do — all the slow work); _lock guards only the
        # scored replica state and is held for microseconds, so the
        # exporter threads' snapshot() calls under /metrics and
        # /healthz can never be stalled by a slow disk
        self._poll_lock = threading.Lock()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._finalizer = weakref.finalize(self, self._stop.set)

    # -- one aggregation pass -----------------------------------------------
    def _poll_replica(self, r: _Replica, now: float) -> int:
        recs = _metrics.read_jsonl(r.path)
        # provenance + serve-shape facts the hubs don't retain: the
        # newest meta header names the writer, the newest serving
        # record carries the shed-ladder depth the health score
        # normalizes by
        for rec in recs:
            kind = rec.get("kind")
            if kind == "meta":
                r.meta = {k: rec.get(k)
                          for k in ("host", "pid", "start_ts",
                                    "replica") if k in rec}
            elif kind == "serving":
                r.last_serving = rec
            elif kind == "tenant" and rec.get("tenant"):
                # latest record per tenant class — the per-tenant
                # counters are cumulative, so newest wins
                r.tenants[rec["tenant"]] = rec
            elif kind == "trace":
                # TraceStore.add dedups by (source, root), so the
                # whole-file re-read every poll folds each kept trace
                # exactly once
                self.traces.add(rec, r.name)
        n = r.hub.ingest_records(recs, r.path, self.kinds)
        self.fleet.ingest_records(recs, f"{r.name}:{r.path}",
                                  self.kinds)
        r.records += n
        if n:
            r.last_new = now
        return n

    def _score_replica(self, r: _Replica, now: float) -> Optional[dict]:
        since = r.last_new if r.last_new is not None else self._t_start
        age = now - since
        was_stale = r.stale
        r.stale = age > self.stale_after_s
        burns = [r.hub.series[s].last()
                 for s in ("slo_burn_short", "slo_burn_long")
                 if s in r.hub.series]
        burns = [b for b in burns if b is not None]
        burn = max(burns) if burns else None
        shed_s = r.hub.series.get("serve_shed_level")
        shed = shed_s.last() if shed_s is not None else None
        ladder = 1
        if r.last_serving is not None:
            variants = (r.last_serving.get("serving") or {}).get(
                "fanout_variants") or []
            ladder = max(len(variants) - 1, 1)
        r.health, r.components = health_score(
            burn=burn, shed_frac=(shed or 0.0) / ladder,
            stale=r.stale, age_s=age)
        if r.stale and not was_stale:
            rec = {"series": f"replica_health:{r.name}",
                   "detector": "staleness", "replica": r.name,
                   "value": round(age, 3),
                   "baseline": round(self.stale_after_s, 3),
                   "shift": round(age - self.stale_after_s, 3),
                   "step": r.records}
            self.anomalies.append(rec)
            return rec
        return None

    def poll(self) -> dict:
        """One aggregation pass over every replica sink; returns (and
        ``fleet``-emits) the fleet snapshot. Thread-safe — the
        background loop and an on-scrape caller may race harmlessly
        (passes are serialized; both do the same idempotent fold)."""
        staleness: List[dict] = []
        with self._poll_lock:
            # the slow half (file reads, JSON parses, hub folds, the
            # fleet hub's own detector emissions) runs OUTSIDE the
            # state lock — only poll passes contend on it
            now = self._clock()
            for r in self._replicas.values():
                self._poll_replica(r, now)
            with self._lock:
                for r in self._replicas.values():
                    hit = self._score_replica(r, now)
                    if hit is not None:
                        staleness.append(hit)
                self.polls += 1
                snap = self._snapshot_locked(now)
        # sink emission AFTER every lock releases: a slow sink disk
        # must not stall
        # the exporter threads snapshotting concurrently
        if self.sink is not None:
            for rec in staleness:
                self.sink.emit(rec, kind="anomaly")
            self.sink.emit(snap, kind="fleet")
        for cb in list(self.on_poll):
            try:
                cb(snap)
            except Exception:
                _log.exception("fleet on_poll observer failed")
        return snap

    def _snapshot_locked(self, now: float) -> dict:
        reps = {}
        for r in self._replicas.values():
            since = r.last_new if r.last_new is not None \
                else self._t_start
            serving = ((r.last_serving or {}).get("serving") or {})
            derived = ((r.last_serving or {}).get("derived") or {})
            reps[r.name] = {
                "path": r.path,
                "health": r.health,
                "stale": r.stale,
                "age_s": round(now - since, 3),
                "records": r.records,
                "components": dict(r.components),
                "meta": r.meta,
                # partition ownership + the locality payoff, straight
                # off the replica's newest serving record
                "partition": serving.get("partition"),
                "locality_hit_rate": derived.get("locality_hit_rate"),
            }
            if r.tenants:
                # per-tenant accounting plane: the newest per-class
                # record, condensed to the fields the
                # fleet view + Prometheus export pivot on
                reps[r.name]["tenants"] = {
                    name: {
                        "priority": t.get("priority"),
                        "requests": t.get("requests"),
                        "completed": t.get("completed"),
                        "rejected": t.get("rejected"),
                        "shed": t.get("shed"),
                        "p99_ms": (t.get("latency") or {}).get("p99_ms"),
                        "burn": ((t.get("slo") or {}).get("windows", {})
                                 .get("short", {}).get("burn_rate")),
                    }
                    for name, t in sorted(r.tenants.items())}
        healths = [v["health"] for v in reps.values()]
        n_stale = sum(1 for v in reps.values() if v["stale"])
        if n_stale == len(reps):
            status = "down"
        elif n_stale or min(healths) < 0.5:
            status = "degraded"
        else:
            status = "ok"
        return {
            "replicas": reps,
            "fleet": {
                "status": status,
                "replica_count": len(reps),
                "stale_count": n_stale,
                "health_min": round(min(healths), 4),
                "health_mean": round(sum(healths) / len(healths), 4),
                "polls": self.polls,
                "poll_errors": self.poll_errors,
            },
        }

    def snapshot(self) -> dict:
        """The latest fleet verdict WITHOUT re-reading any file (ages
        advance against the live clock)."""
        with self._lock:
            return self._snapshot_locked(self._clock())

    def replica_hub(self, name: str) -> TelemetryHub:
        """The named replica's merged :class:`TelemetryHub`."""
        return self._replicas[name].hub

    @property
    def replica_names(self) -> List[str]:
        return list(self._replicas)

    # -- life cycle ----------------------------------------------------------
    def start(self) -> "FleetAggregator":
        """Spin the background polling thread (daemon — dies with the
        process; ``close()`` reaps it deterministically)."""
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("aggregator is closed")
            if self._thread is None:
                t = threading.Thread(target=self._loop,
                                     name="qt-fleet-agg", daemon=True)
                t.start()
                self._thread = t
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and not self._stop.is_set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll()
            except Exception:
                # a torn file mid-write must not kill the plane (the
                # next poll heals) — but the swallow is COUNTED, never
                # silent
                with self._lock:
                    self.poll_errors += 1

    def close(self) -> None:
        """Stop the polling thread and join it. Idempotent."""
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)

    def __enter__(self) -> "FleetAggregator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- health-weighted routing ---------------------------------------------------


class HealthRouter:
    """Health-weighted replica selection with drain/re-admit hysteresis
    — consuming
    :func:`health_score` verdicts (typically the
    :class:`FleetAggregator`'s, via ``agg.on_poll.append(router.sync)``).

    - :meth:`pick` draws a replica weighted by its health score
      (seeded ``random.Random`` — reproducible), never a drained one
      while an active one exists;
    - :meth:`ranked` lists replicas healthiest-first (what the RPC
      client's retry/hedge path walks) with drained replicas LAST —
      a last resort, not a routing target;
    - **drain hysteresis**: a replica whose score falls below
      ``drain_below`` (staleness scores 0, so a dead replica drains on
      the first sync) is drained — no new traffic routes to it, while
      requests already in flight re-route through the client's retry
      path rather than being dropped — and re-admits only once its
      score recovers past ``readmit_above`` (two thresholds, so a
      replica hovering at the boundary doesn't flap).

    Scores arrive via :meth:`update` / :meth:`sync`; unknown replicas
    auto-register (score 1.0 until told otherwise). ``snapshot()``
    is one JSONL-ready dict.

    **Partition-aware locality routing**: after
    :meth:`set_locality`, a ``seed``-carrying :meth:`pick` /
    :meth:`ranked` blends each replica's health with the degree-mass
    fraction of that request's expected frontier resident in the
    replica's partition's HOT tier
    (``partition.build_locality_table`` — the ``plan_hot_capacity``
    math applied per partition)::

        effective(name) = health(name)
                          * ((1 - w) + w * table[seed, owner(name)])

    The router IS the cache policy: a request lands on the replica
    whose hot tier already holds most of its frontier, so the sharded
    engine's exchange ships fewer remote rows (measurably lower
    ``locality_miss_rows``) — while health keeps its veto (a locality
    factor can only scale a replica's weight DOWN toward ``1 - w``,
    never resurrect a drained or dying one; drain hysteresis runs on
    raw health, untouched). Seed-less calls (and health-only routers)
    behave exactly as before."""

    def __init__(self, names: Sequence[str] = (), seed: int = 0,
                 drain_below: float = 0.25, readmit_above: float = 0.5):
        if not 0.0 <= drain_below <= readmit_above <= 1.0:
            raise ValueError(
                f"need 0 <= drain_below <= readmit_above <= 1, got "
                f"{drain_below} / {readmit_above}")
        self.drain_below = float(drain_below)
        self.readmit_above = float(readmit_above)
        self._scores: Dict[str, float] = {str(n): 1.0 for n in names}
        self._drained: set = set()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.picks = 0
        self.drains = 0
        self.readmits = 0
        # locality state (set_locality): [n, partitions] degree-mass
        # table, replica -> partition ownership, blend weight
        self._loc_table = None
        self._loc_owners: Dict[str, int] = {}
        self._loc_weight = 0.0

    def update(self, name: str, score: float) -> None:
        """Fold one replica's health score (clamped to [0, 1]) and run
        the drain/re-admit hysteresis."""
        name = str(name)
        score = min(max(float(score), 0.0), 1.0)
        with self._lock:
            self._scores[name] = score
            if name in self._drained:
                if score >= self.readmit_above:
                    self._drained.discard(name)
                    self.readmits += 1
            elif score < self.drain_below:
                self._drained.add(name)
                self.drains += 1

    def sync(self, snapshot: dict) -> None:
        """Fold a :class:`FleetAggregator` snapshot (per-replica
        ``health`` values) — the shape ``agg.on_poll`` delivers."""
        for name, rec in (snapshot.get("replicas") or {}).items():
            h = rec.get("health")
            if h is not None:
                self.update(name, h)

    def drain(self, name: str) -> None:
        """Manually drain (deploys, maintenance): no new traffic until
        :meth:`readmit` or a recovered score re-admits it."""
        with self._lock:
            self._drained.add(str(name))
            self.drains += 1

    def readmit(self, name: str) -> None:
        with self._lock:
            self._drained.discard(str(name))
            self.readmits += 1

    def forget(self, name: str) -> None:
        """Remove a replica entirely (a scale-down retired it) — a
        drained ghost would otherwise linger in :meth:`ranked`'s
        last-resort tail forever."""
        with self._lock:
            self._scores.pop(str(name), None)
            self._drained.discard(str(name))

    def set_locality(self, table, owners: Dict[str, int],
                     weight: float = 0.5) -> None:
        """Arm partition-aware routing: ``table`` is the
        ``[n, partitions]`` degree-mass locality table
        (``partition.build_locality_table``), ``owners`` maps replica
        name -> owned partition, ``weight`` in [0, 1) is the blend
        (0 restores pure health routing; 1 is refused — health must
        keep its veto). Replicas absent from ``owners`` route with a
        NEUTRAL locality factor of 1 (they are never penalized for
        what the router doesn't know)."""
        weight = float(weight)
        if not 0.0 <= weight < 1.0:
            raise ValueError(
                f"locality weight must be in [0, 1), got {weight}")
        import numpy as _np
        table = None if table is None else _np.asarray(table)
        if table is not None and table.ndim != 2:
            raise ValueError(
                f"locality table must be [n, partitions], got shape "
                f"{table.shape}")
        with self._lock:
            self._loc_table = table
            self._loc_owners = {str(k): int(v)
                                for k, v in (owners or {}).items()}
            self._loc_weight = weight if table is not None else 0.0

    def _locality(self, name: str, seed) -> float:
        """Locality factor in [1 - w, 1] (lock held)."""
        w = self._loc_weight
        t = self._loc_table
        if w <= 0.0 or t is None or seed is None:
            return 1.0
        part = self._loc_owners.get(name)
        s = int(seed)
        if part is None or not 0 <= s < t.shape[0] \
                or not 0 <= part < t.shape[1]:
            return 1.0
        return (1.0 - w) + w * float(t[s, part])

    def _active(self, exclude) -> Tuple[List[str], List[str]]:
        ex = set(exclude)
        active = [n for n in self._scores
                  if n not in self._drained and n not in ex]
        rest = [n for n in self._scores
                if n not in ex and n not in active]
        return active, rest

    def ranked(self, exclude: Sequence[str] = (),
               seed=None) -> List[str]:
        """Replicas healthiest-first; drained ones LAST (a retry path
        may still try them when nothing healthy remains). Excluded
        names (this request's already-failed replicas) drop entirely
        unless that would leave nothing. ``seed`` (the request's node
        id) folds the locality blend into the order when
        :meth:`set_locality` armed it."""
        with self._lock:
            key = lambda n: (-self._scores[n] * self._locality(n, seed),
                             n)
            active, rest = self._active(exclude)
            out = sorted(active, key=key) + sorted(rest, key=key)
            if not out:
                out = sorted(self._scores, key=key)
            return out

    def pick(self, exclude: Sequence[str] = (), seed=None) -> str:
        """One replica, drawn with probability proportional to health
        among the non-drained set (a replica at health 0.3 takes 3x
        less traffic than one at 0.9 — shed pressure routes AWAY
        before the SLO blows, the planned trade). ``seed`` (the
        request's node id) scales each weight by the locality blend
        when :meth:`set_locality` armed it — the hot-set-aware draw
        that makes the router the cache policy."""
        with self._lock:
            active, rest = self._active(exclude)
            pool = active or rest or list(self._scores)
            if not pool:
                raise ValueError("router knows no replicas")
            weights = [max(self._scores.get(n, 1.0)
                           * self._locality(n, seed), 1e-6)
                       for n in pool]
            total = sum(weights)
            x = self._rng.random() * total
            self.picks += 1
            for n, w in zip(pool, weights):
                x -= w
                if x <= 0:
                    return n
            return pool[-1]

    def snapshot(self) -> dict:
        with self._lock:
            out = {"scores": dict(self._scores),
                   "drained": sorted(self._drained),
                   "picks": self.picks, "drains": self.drains,
                   "readmits": self.readmits}
            if self._loc_table is not None and self._loc_weight > 0.0:
                out["locality"] = {"weight": self._loc_weight,
                                   "owners": dict(self._loc_owners)}
            return out

    @staticmethod
    def plan_quality(snapshot: dict, ladder: int,
                     step_burn: float = 0.5) -> dict:
        """Turn a :class:`FleetAggregator` snapshot into one PLANNED
        fleet-wide quality floor (fleet actuation: otherwise each
        replica sheds alone, reacting only to its own queue/burn;
        this makes the latency/quality trade a fleet decision). The
        policy is deterministic and arguable from its inputs:

        - only non-stale replicas vote (a silent replica's last burn
          is stale data, and staleness is the supervisor's problem,
          not a quality problem); with NO live replica the floor is 0
          — shedding quality cannot help a fleet that is down;
        - the fleet burn is the MEAN of the voters' worst burn rates
          (one hot replica should shift traffic — the router's job —
          not degrade everyone; the whole fleet burning is what
          justifies a fleet-wide floor);
        - every ``step_burn`` of mean burn past sustainable (1.0)
          plans one shed step, capped at ``ladder`` (the variant
          ladder depth, ``len(engine.variants) - 1``).

        Returns ``{"shed_floor", "burn_mean", "burn_max",
        "considered", "stale_count", "ladder"}`` — the payload an
        ``actuate`` record carries so the plan self-explains. The
        :class:`~quiver_tpu_torch.actuator.Actuator` applies the floor via
        ``MicroBatchServer.set_shed_floor`` under its cooldown, so an
        oscillating burn cannot flap the fleet."""
        ladder = max(int(ladder), 0)
        reps = (snapshot.get("replicas") or {})
        burns = []
        stale = 0
        for rec in reps.values():
            comp = rec.get("components") or {}
            if rec.get("stale") or comp.get("stale"):
                stale += 1
                continue
            b = comp.get("burn")
            if b is not None:
                burns.append(float(b))
        if burns:
            burn_mean = sum(burns) / len(burns)
            burn_max = max(burns)
            excess = max(0.0, burn_mean - 1.0)
            floor = min(ladder, int(math.ceil(excess / step_burn
                                              - 1e-9)) if excess > 0
                        else 0)
        else:
            burn_mean = burn_max = None
            floor = 0
        return {"shed_floor": floor,
                "burn_mean": (None if burn_mean is None
                              else round(burn_mean, 4)),
                "burn_max": (None if burn_max is None
                             else round(burn_max, 4)),
                "considered": len(burns), "stale_count": stale,
                "ladder": ladder}


# -- replica supervision -------------------------------------------------------


class _Child:
    """One supervised replica's state (internal)."""

    def __init__(self, name: str):
        self.name = name
        self.proc = None
        self.spawned_at: Optional[float] = None
        self.next_restart_at: Optional[float] = 0.0   # 0 = spawn now
        self.spawned_ever = False
        self.restarts = 0
        self.consecutive = 0          # crashes without healthy uptime
        self.crash_times: collections.deque = collections.deque(maxlen=64)
        self.breaker_open = False
        self.last_rc: Optional[int] = None


class ReplicaSupervisor:
    """Spawn N serve replicas as REAL processes and keep them alive:
    crashed replicas restart under capped exponential backoff, and a
    crash LOOP (``crash_loop_limit`` crashes inside
    ``crash_loop_window_s``) opens a circuit breaker — restarting a
    replica that dies on arrival every time only burns CPU and floods
    logs; the breaker holds for ``breaker_reset_s``, then clears the
    crash history and tries once more (half-open).

    ``spawn(name, index, attempt)`` returns a started
    ``subprocess.Popen`` — the supervisor owns WHEN processes run,
    the caller owns WHAT they run (stdlib stand-ins in the tests,
    serve replicas on the card). A replica
    that stays up ``healthy_uptime_s`` resets its consecutive-crash
    count, so one crash a day pays the MINIMUM backoff, not an
    ever-growing one.

    Lifecycle events (spawn / exit / breaker transitions) append to
    ``sink`` as ``chaos`` JSONL records and to the in-memory
    ``events`` deque. ``kill(name)`` is the chaos trigger
    (SIGKILL by default — the crash the restart path must survive).
    ``close()`` stops the monitor and terminates the children
    (SIGTERM, then SIGKILL after ``grace_s``)."""

    def __init__(self, spawn: Callable, count: int,
                 names: Optional[Sequence[str]] = None,
                 backoff_s: float = 0.25, backoff_cap_s: float = 8.0,
                 crash_loop_limit: int = 5,
                 crash_loop_window_s: float = 30.0,
                 breaker_reset_s: Optional[float] = None,
                 healthy_uptime_s: Optional[float] = None,
                 monitor_interval_s: float = 0.1,
                 grace_s: float = 2.0, sink=None, clock=None):
        if count < 1 and not names:
            raise ValueError("need at least one replica")
        self._spawn = spawn
        self.names = ([str(n) for n in names] if names
                      else [f"r{i}" for i in range(count)])
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"duplicate replica names in {self.names}")
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.crash_loop_limit = int(crash_loop_limit)
        self.crash_loop_window_s = float(crash_loop_window_s)
        self.breaker_reset_s = (float(breaker_reset_s)
                                if breaker_reset_s is not None
                                else 2.0 * self.crash_loop_window_s)
        self.healthy_uptime_s = (float(healthy_uptime_s)
                                 if healthy_uptime_s is not None
                                 else self.crash_loop_window_s)
        self.monitor_interval_s = float(monitor_interval_s)
        self.grace_s = float(grace_s)
        self.sink = sink
        self._clock = clock if clock is not None else time.monotonic
        self._children = {n: _Child(n) for n in self.names}
        self.events: collections.deque = collections.deque(maxlen=256)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._finalizer = weakref.finalize(self, self._stop.set)

    # -- events --------------------------------------------------------------
    def _event(self, **rec) -> None:
        """Record one lifecycle event (sink emission OUTSIDE any
        lock, per the lock_held_emit contract — callers ensure it)."""
        self.events.append(rec)
        if self.sink is not None:
            self.sink.emit(rec, kind="chaos")

    # -- the monitor ---------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        """Spawn every replica now and spin the monitor thread."""
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("supervisor is closed")
            if self._thread is None:
                t = threading.Thread(target=self._monitor,
                                     name="qt-replica-supervisor",
                                     daemon=True)
                t.start()
                self._thread = t
        return self

    def _monitor(self) -> None:
        while not self._stop.wait(self.monitor_interval_s):
            try:
                self.step()
            except Exception:
                # one bad spawn attempt must not kill supervision of
                # the other replicas — counted via an event, retried
                # on the next tick
                self._event(event="monitor_error")

    def step(self) -> None:
        """One supervision pass (the monitor thread's body; tests call
        it directly under a fake clock for determinism)."""
        now = self._clock()
        events = []
        try:
            with self._lock:
                for c in self._children.values():
                    self._step_child(c, now, events)
        finally:
            for rec in events:         # outside the lock: sink IO
                self._event(**rec)

    def _step_child(self, c: _Child, now: float, events: list) -> None:
        if c.proc is not None:
            rc = c.proc.poll()
            if rc is None:
                if c.consecutive and c.spawned_at is not None and \
                        now - c.spawned_at >= self.healthy_uptime_s:
                    # earned a clean slate: the next crash pays the
                    # MINIMUM backoff and the breaker window restarts
                    c.consecutive = 0
                    c.crash_times.clear()
                return
            # the replica died: schedule the restart under backoff
            c.last_rc = rc
            c.proc = None
            self._crash_ladder(c, now, events,
                               dict(event="exit", rc=rc))
            return
        # no process: spawn when its restart time arrives
        if c.next_restart_at is None or now < c.next_restart_at:
            return
        if c.breaker_open:
            # half-open: the cool-down elapsed — clear history, try once
            c.breaker_open = False
            c.crash_times.clear()
            c.consecutive = 0
            events.append(dict(event="breaker_reset", replica=c.name))
        first = not c.spawned_ever
        attempt = 0 if first else c.restarts + 1
        try:
            proc = self._spawn(c.name, self.names.index(c.name),
                               attempt)
        except Exception as e:
            # a failing spawn() is a crash that never got a pid: it
            # pays the SAME backoff/breaker ladder (a bad binary must
            # not hot-loop at the monitor interval), and it must not
            # abort this pass — the other children still get stepped
            self._crash_ladder(c, now, events,
                               dict(event="spawn_error",
                                    error=repr(e)))
            return
        c.proc = proc
        c.spawned_ever = True
        c.spawned_at = now
        c.next_restart_at = None
        if not first:
            c.restarts += 1
        events.append(dict(
            event="spawn" if first else "restart", replica=c.name,
            pid=c.proc.pid, attempt=attempt))

    def _crash_ladder(self, c: _Child, now: float, events: list,
                      event: dict) -> None:
        """The one backoff/circuit-breaker ladder both crash shapes
        pay — a process exit and a failing ``spawn()`` differ only in
        their event payload."""
        c.crash_times.append(now)
        c.consecutive += 1
        recent = sum(1 for t in c.crash_times
                     if now - t <= self.crash_loop_window_s)
        if recent >= self.crash_loop_limit and not c.breaker_open:
            c.breaker_open = True
            c.next_restart_at = now + self.breaker_reset_s
            events.append(dict(
                event, event="breaker_open", replica=c.name,
                crashes_in_window=recent,
                retry_in_s=round(self.breaker_reset_s, 3)))
            return
        backoff = min(self.backoff_cap_s,
                      self.backoff_s * (2 ** (c.consecutive - 1)))
        c.next_restart_at = now + backoff
        events.append(dict(
            event, replica=c.name, consecutive=c.consecutive,
            restart_in_s=round(backoff, 3)))

    # -- elastic scaling ---------------------------------------------------
    def _fresh_names(self, n: int) -> List[str]:
        taken = set(self.names)
        out: List[str] = []
        i = len(self.names)
        while len(out) < n:
            cand = f"r{i}"
            i += 1
            if cand not in taken:
                taken.add(cand)
                out.append(cand)
        return out

    def grow(self, n: int = 1,
             names: Optional[Sequence[str]] = None) -> List[str]:
        """Add ``n`` replicas (or the explicitly ``names``d ones) to
        the supervised set — each spawns on the next monitor tick
        through the SAME spawn/backoff/breaker path a restart takes,
        so a replica that dies on arrival pays the ladder, not a
        hot-loop. Emits one ``scale_up`` chaos event. Returns the new
        names."""
        new = ([str(x) for x in names] if names
               else self._fresh_names(int(n)))
        if not new:
            return []
        with self._lock:
            dup = [x for x in new if x in self._children]
            if dup:
                raise ValueError(f"replica names already exist: {dup}")
            for name in new:
                self.names.append(name)
                self._children[name] = _Child(name)
        self._event(event="scale_up", replicas=list(new),
                    count=len(self.names))
        return new

    def shrink(self, n: int = 1,
               names: Optional[Sequence[str]] = None,
               drain: Optional[Callable[[str], None]] = None,
               drain_wait_s: float = 0.0) -> List[str]:
        """Retire ``n`` replicas (newest first, or the explicitly
        ``names``d ones) WITHOUT losing a request — the zero-loss
        choreography:

        1. ``drain(name)`` (typically ``HealthRouter.drain``) stops
           NEW traffic routing at each victim;
        2. ``drain_wait_s`` lets in-flight requests finish (the RPC
           client's retry/hedge path re-routes any that don't);
        3. only THEN the victim leaves the supervised set (so the
           monitor won't resurrect it) and gets SIGTERM, escalating
           to SIGKILL after ``grace_s`` — the replica's own graceful
           close resolves everything it already claimed.

        A retirement is NOT a crash: no backoff, no breaker, one
        ``scale_down`` chaos event. At least one replica always
        remains. Returns the retired names."""
        with self._lock:
            pool = list(self.names)
        if names:
            victims = [str(x) for x in names]
            missing = [x for x in victims if x not in pool]
            if missing:
                raise ValueError(f"unknown replicas: {missing}")
        else:
            victims = pool[-int(n):] if int(n) > 0 else []
        if not victims:
            return []
        if len(victims) >= len(pool):
            raise ValueError(
                f"shrink would retire every replica ({victims}); "
                "at least one must remain")
        if drain is not None:
            for name in victims:
                drain(name)
        if drain_wait_s > 0:
            time.sleep(float(drain_wait_s))
        procs = []
        with self._lock:
            for name in victims:
                c = self._children.pop(name)
                self.names.remove(name)
                if c.proc is not None and c.proc.poll() is None:
                    procs.append(c.proc)
        # signal OUTSIDE the lock (the monitor must keep stepping the
        # survivors while a slow victim drains out)
        for p in procs:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + self.grace_s
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except Exception:
                try:
                    p.kill()
                    p.wait(timeout=5.0)
                except Exception:
                    pass
        self._event(event="scale_down", replicas=list(victims),
                    count=len(self.names), drained=drain is not None)
        return victims

    def scale_to(self, count: int, drain=None,
                 drain_wait_s: float = 0.0) -> List[str]:
        """Grow or shrink to exactly ``count`` replicas; returns the
        names added or retired (empty list when already at size)."""
        count = int(count)
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        with self._lock:
            cur = len(self.names)
        if count > cur:
            return self.grow(count - cur)
        if count < cur:
            return self.shrink(cur - count, drain=drain,
                               drain_wait_s=drain_wait_s)
        return []

    @property
    def replica_count(self) -> int:
        with self._lock:
            return len(self.names)

    # -- chaos + introspection ------------------------------------------------
    def kill(self, name: str, sig=None) -> Optional[int]:
        """SIGKILL (default) a replica — the chaos trigger. Returns the
        killed pid, or None if it was not running."""
        import signal
        with self._lock:
            c = self._children[str(name)]
            proc = c.proc
        if proc is None or proc.poll() is not None:
            return None
        proc.send_signal(signal.SIGKILL if sig is None else sig)
        return proc.pid

    def status(self) -> dict:
        """Per-replica ``{pid, alive, rc, restarts, consecutive,
        breaker_open, next_restart_in_s}`` snapshot."""
        now = self._clock()
        with self._lock:
            out = {}
            for c in self._children.values():
                alive = c.proc is not None and c.proc.poll() is None
                out[c.name] = {
                    "pid": c.proc.pid if c.proc is not None else None,
                    "alive": alive,
                    "rc": c.last_rc,
                    "restarts": c.restarts,
                    "consecutive_crashes": c.consecutive,
                    "breaker_open": c.breaker_open,
                    "next_restart_in_s": (
                        None if c.next_restart_at is None
                        else round(max(c.next_restart_at - now, 0.0), 3)),
                }
            return out

    @property
    def running(self) -> bool:
        return self._thread is not None and not self._stop.is_set()

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Stop the monitor, terminate the children (SIGTERM, SIGKILL
        after ``grace_s``), reap them. Idempotent."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)
        with self._lock:
            procs = [c.proc for c in self._children.values()
                     if c.proc is not None]
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + self.grace_s
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except Exception:
                try:
                    p.kill()
                    p.wait(timeout=5.0)
                except Exception:
                    pass

    def __enter__(self) -> "ReplicaSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- Prometheus text exposition ----------------------------------------------


def _prom_escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt_value(v: float) -> str:
    f = float(v)
    return repr(f) if f != int(f) else str(int(f))


def prometheus_text(agg: FleetAggregator) -> str:
    """Render the aggregator's state in Prometheus text exposition
    format (version 0.0.4 — what a ``/metrics`` scrape returns):
    see :func:`_prometheus_text_ex` for the body."""
    return _prometheus_text_ex(agg)[0]


def _prometheus_text_ex(agg: FleetAggregator) -> Tuple[str, bool]:
    """:func:`prometheus_text` plus whether an exemplar was stamped
    (computed AT the stamp — the exporter's content-type switch must
    not sniff the text, where a series name could fake a match):

    - ``qt_replica_health`` / ``qt_replica_stale`` /
      ``qt_replica_age_seconds`` / ``qt_replica_records_total``
      gauges+counters, one sample per replica;
    - ``qt_fleet_replicas`` / ``qt_fleet_stale_replicas`` /
      ``qt_fleet_health_min`` / ``qt_fleet_health_mean`` /
      ``qt_fleet_polls_total`` fleet rollups;
    - ``qt_series`` — every hub series' LAST value, labeled
      ``{replica=..., name=...}`` per replica and ``{name=...}``
      (no replica label) for the fleet-global fold;
    - ``qt_counter_total`` — the cumulative device-counter totals with
      the same labeling.

    Series names ride in a label (not the metric name), so arbitrary
    in-tree series names (``stage_share:<entry>/<stage>``) can never
    produce an invalid exposition."""
    snap = agg.snapshot()
    lines: List[str] = []
    stamped = [False]

    def head(name, typ, help_):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {typ}")

    head("qt_replica_health", "gauge",
         "Replica health score (0 worst .. 1 best; 0 when stale).")
    for name, r in snap["replicas"].items():
        lines.append(f'qt_replica_health{{replica="'
                     f'{_prom_escape(name)}"}} '
                     f'{_fmt_value(r["health"])}')
    head("qt_replica_stale", "gauge",
         "1 when the replica's sink stopped advancing.")
    for name, r in snap["replicas"].items():
        lines.append(f'qt_replica_stale{{replica="'
                     f'{_prom_escape(name)}"}} {int(r["stale"])}')
    head("qt_replica_age_seconds", "gauge",
         "Seconds since the replica's sink last advanced.")
    for name, r in snap["replicas"].items():
        lines.append(f'qt_replica_age_seconds{{replica="'
                     f'{_prom_escape(name)}"}} '
                     f'{_fmt_value(r["age_s"])}')
    head("qt_replica_records_total", "counter",
         "Telemetry records aggregated from the replica's sink.")
    for name, r in snap["replicas"].items():
        lines.append(f'qt_replica_records_total{{replica="'
                     f'{_prom_escape(name)}"}} {int(r["records"])}')
    fl = snap["fleet"]
    for metric, typ, key, help_ in (
            ("qt_fleet_replicas", "gauge", "replica_count",
             "Replicas the aggregator watches."),
            ("qt_fleet_stale_replicas", "gauge", "stale_count",
             "Replicas whose sinks stopped advancing."),
            ("qt_fleet_health_min", "gauge", "health_min",
             "Worst replica health score."),
            ("qt_fleet_health_mean", "gauge", "health_mean",
             "Mean replica health score."),
            ("qt_fleet_polls_total", "counter", "polls",
             "Aggregation passes completed.")):
        head(metric, typ, help_)
        lines.append(f"{metric} {_fmt_value(fl[key])}")

    # per-tenant accounting plane: one sample per
    # (replica, tenant-class), straight off each replica's newest
    # `tenant` record — tenant names ride in a label, same discipline
    # as series names, so arbitrary registry names stay valid
    tenant_metrics = (
        ("qt_tenant_requests_total", "counter", "requests",
         "Requests admitted for the tenant class."),
        ("qt_tenant_completed_total", "counter", "completed",
         "Requests completed for the tenant class."),
        ("qt_tenant_rejected_total", "counter", "rejected",
         "Requests rejected at admission for the tenant class."),
        ("qt_tenant_shed_total", "counter", "shed",
         "Requests turned away for the tenant class (rejected + "
         "displaced + deadline-expired)."),
        ("qt_tenant_p99_ms", "gauge", "p99_ms",
         "Per-tenant request latency p99 (milliseconds)."),
        ("qt_tenant_burn_rate", "gauge", "burn",
         "Per-tenant SLO short-window error-budget burn rate."),
    )
    for metric, typ, key, help_ in tenant_metrics:
        samples = []
        for rname, r in snap["replicas"].items():
            for tname, t in (r.get("tenants") or {}).items():
                val = t.get(key)
                if val is None:
                    continue
                samples.append(
                    f'{metric}{{replica="{_prom_escape(rname)}",'
                    f'tenant="{_prom_escape(tname)}"}} '
                    f'{_fmt_value(val)}')
        if samples:
            head(metric, typ, help_)
            lines.extend(samples)

    head("qt_series", "gauge",
         "Last value of each telemetry series (no replica label = "
         "the fleet-global fold).")
    traces = getattr(agg, "traces", None)

    def series_lines(hub, replica: Optional[str]):
        label = (f'replica="{_prom_escape(replica)}",'
                 if replica is not None else "")
        # OpenMetrics exemplar on latency series: the newest KEPT
        # trace for this replica — the path from a bad p99 sample to
        # the exact request behind it. The
        # exemplar's own value is that trace's duration_ms.
        ex = traces.latest(replica) if traces is not None else None
        for sname in sorted(hub.series):
            last = hub.series[sname].last()
            if last is None:
                continue
            line = (f'qt_series{{{label}name="'
                    f'{_prom_escape(sname)}"}} '
                    f'{_fmt_value(last)}')
            if ex is not None and sname.endswith("_ms"):
                line += (f' # {{trace_id="{int(ex[0])}"}} '
                         f'{_fmt_value(ex[1])}')
                stamped[0] = True
            lines.append(line)

    for name in agg.replica_names:
        series_lines(agg.replica_hub(name), name)
    series_lines(agg.fleet, None)

    head("qt_counter_total", "counter",
         "Cumulative device-counter totals (no replica label = the "
         "fleet-global add/max fold).")

    def counter_lines(hub, replica: Optional[str]):
        label = (f'replica="{_prom_escape(replica)}",'
                 if replica is not None else "")
        named = _metrics.counters_dict(hub.counters())
        for cname, val in sorted(named.items()):
            if not val:
                continue
            lines.append(f'qt_counter_total{{{label}name="'
                         f'{_prom_escape(cname)}"}} {int(val)}')

    for name in agg.replica_names:
        counter_lines(agg.replica_hub(name), name)
    counter_lines(agg.fleet, None)
    # the OpenMetrics terminator: required once the exposition carries
    # exemplar syntax (the exporter then declares the OpenMetrics
    # content type); a plain comment to the classic 0.0.4 parser
    lines.append("# EOF")
    return "\n".join(lines) + "\n", stamped[0]


# -- the export endpoint ------------------------------------------------------


class FleetExporter:
    """Stdlib HTTP endpoint over a :class:`FleetAggregator`:

    - ``GET /metrics`` — :func:`prometheus_text` (content type
      ``text/plain; version=0.0.4``, switching to
      ``application/openmetrics-text`` once kept-trace exemplars
      appear — exemplar syntax belongs to that grammar). If the
      aggregator has no background thread running, the scrape itself
      polls — scrape-time aggregation is the Prometheus-idiomatic
      mode.
    - ``GET /healthz`` — the fleet verdict as JSON (the aggregator
      snapshot). HTTP 200 while at least one replica is alive
      (``ok``/``degraded``), 503 when the whole fleet is stale
      (``down``) — a load balancer probing the plane should only
      fail over when there is truly nothing left to route to.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` —
    what tests use). ``close()`` shuts the server down and joins its
    thread; also bound to a finalizer."""

    def __init__(self, agg: FleetAggregator, host: str = "127.0.0.1",
                 port: int = 0, start: bool = True):
        import http.server

        exporter = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib contract)
                try:
                    exporter._respond(self)
                except BrokenPipeError:
                    pass               # scraper hung up mid-answer

            def log_message(self, *a):
                pass                   # scrapes must not spam stderr

        self.agg = agg
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        self._finalizer = weakref.finalize(
            self, FleetExporter._shutdown, self._httpd)
        if start:
            self.start()

    @staticmethod
    def _shutdown(httpd) -> None:
        try:
            # shutdown() blocks on an event only serve_forever() sets:
            # calling it on a server whose loop never ran (constructed
            # with start=False, never started) would hang forever —
            # including from the finalizer at interpreter exit
            if getattr(httpd, "_qt_serving", False):
                httpd.shutdown()
            httpd.server_close()
        except Exception:
            pass

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def _respond(self, handler) -> None:
        path = handler.path.split("?", 1)[0]
        if path == "/metrics":
            if not self.agg.running:
                self.agg.poll()
            text, has_exemplar = _prometheus_text_ex(self.agg)
            body = text.encode()
            handler.send_response(200)
            # exemplar syntax is OpenMetrics, not classic 0.0.4: the
            # moment a kept trace stamps one, the declared format must
            # follow, or a strict scraper drops the whole exposition
            handler.send_header(
                "Content-Type",
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8" if has_exemplar else
                "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            if not self.agg.running:
                self.agg.poll()
            snap = self.agg.snapshot()
            body = (json.dumps(snap) + "\n").encode()
            code = 503 if snap["fleet"]["status"] == "down" else 200
            handler.send_response(code)
            handler.send_header("Content-Type", "application/json")
        else:
            body = b"not found (try /metrics or /healthz)\n"
            handler.send_response(404)
            handler.send_header("Content-Type", "text/plain")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def start(self) -> "FleetExporter":
        if self._thread is None:
            self._httpd._qt_serving = True
            t = threading.Thread(target=self._httpd.serve_forever,
                                 name="qt-fleet-export", daemon=True)
            t.start()
            self._thread = t
        return self

    def close(self) -> None:
        """Shut the HTTP server down and join its thread. Idempotent."""
        FleetExporter._shutdown(self._httpd)
        t = self._thread
        self._thread = None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)

    def __enter__(self) -> "FleetExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
