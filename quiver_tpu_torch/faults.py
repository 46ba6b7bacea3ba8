"""Deterministic fault injection (the port's own copy of
``quiver_tpu/faults.py``; stdlib only, and the same spec strings, sites
and seeded triggers, so a plan armed in either package fires
identically).

A :class:`FaultPlan` maps named sites (:data:`SITES`, fixed strings on
host-side control paths) to :class:`FaultRule` triggers: fire on the
Nth visit (``after``), at a seeded probability (``rate``, one
``random.Random(f"{seed}:{site}")`` per site, no wall-clock randomness),
at most ``times`` times. A fired rule raises (``OSError`` with a chosen
``errno``, or ``RuntimeError``), sleeps (``delay``/``hang``) or ends the
process (``kill``/``exit``).

Arming is process-wide and off by default: each site is one
``faults.fire(name)`` call whose disarmed body is one ``None`` check.
No site is inside a kernel or on a per-row path. In the port the
staging pipeline's worker fires ``"pipeline.worker"`` and
``MetricsSink.emit`` fires ``"sink.write"``; the other sites belong to
modules still to be ported and are listed so that a spec written for
the JAX package parses here.

Arm from the environment::

    QT_FAULTS="pipeline.worker:error,exc=runtime,times=1" QT_FAULTS_SEED=7

or in-process::

    faults.install(FaultPlan(seed=7, rules={
        "pipeline.worker": FaultRule("error", exc="runtime", times=1)}))
    ...
    faults.disarm()
"""

from __future__ import annotations

import errno as _errno
import os
import random
import threading
import time
from typing import Dict, Optional

__all__ = ["SITES", "FaultRule", "FaultPlan", "install", "disarm",
           "active", "fire", "drain_injected", "plan_from_env"]

#: The named injection sites, the JAX package's. Adding a site is adding
#: a ``faults.fire("<name>")`` call on a host-side control path.
SITES = (
    "io.read",          # ExtentReader: one coalesced-extent read
    "io.slow",          # ExtentReader: delay before an extent read
    "prefetch.stager",  # ColdPrefetcher: one staging shard
    "pipeline.worker",  # Pipeline: worker loop top (thread death)
    "sink.write",       # MetricsSink.emit: the JSONL write
    "serve.coalesce",   # MicroBatchServer: coalescer loop top
    "serve.execute",    # MicroBatchServer: batch execute
    "rpc.request",      # RpcServer: per accepted request
)

_ERRNO_OK = ("EIO", "EINTR", "EAGAIN", "ENOSPC", "EPIPE", "ECONNRESET")


class FaultRule:
    """One site's trigger + effect.

    ``action``: ``error`` (raise), ``delay`` (sleep ``delay_ms`` then
    continue), ``hang`` (sleep ``hang_s``, default 30 — longer than any
    sane deadline), ``kill`` (SIGKILL self), ``exit`` (``os._exit``).
    ``rate`` fires the rule on that fraction of eligible visits (seeded
    per-site RNG; 1.0 = every visit). ``after`` skips the first N
    visits (a deterministic "at request N+1" trigger). ``times`` caps
    total fires (None = unlimited). ``errno_name`` picks the OSError
    errno for ``error`` kind; ``exc="runtime"`` raises RuntimeError
    instead."""

    __slots__ = ("action", "rate", "after", "times", "errno_name",
                 "delay_ms", "hang_s", "exc")

    def __init__(self, action: str = "error", rate: float = 1.0,
                 after: int = 0, times: Optional[int] = None,
                 errno_name: str = "EIO", delay_ms: float = 5.0,
                 hang_s: float = 30.0, exc: str = "oserror"):
        if action not in ("error", "delay", "hang", "kill", "exit"):
            raise ValueError(f"unknown fault action {action!r}")
        if not 0.0 <= float(rate) <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        if errno_name not in _ERRNO_OK:
            raise ValueError(f"errno must be one of {_ERRNO_OK}, "
                             f"got {errno_name!r}")
        self.action = action
        self.rate = float(rate)
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.errno_name = errno_name
        self.delay_ms = float(delay_ms)
        self.hang_s = float(hang_s)
        self.exc = exc

    def spec(self) -> str:
        """The one-rule half of a ``QT_FAULTS`` spec string."""
        parts = [self.action]
        if self.rate != 1.0:
            parts.append(f"rate={self.rate}")
        if self.after:
            parts.append(f"after={self.after}")
        if self.times is not None:
            parts.append(f"times={self.times}")
        if self.action == "error":
            if self.errno_name != "EIO":
                parts.append(f"errno={self.errno_name}")
            if self.exc != "oserror":
                parts.append(f"exc={self.exc}")
        if self.action == "delay" and self.delay_ms != 5.0:
            parts.append(f"delay_ms={self.delay_ms}")
        if self.action == "hang" and self.hang_s != 30.0:
            parts.append(f"hang_s={self.hang_s}")
        return ",".join(parts)

    def __repr__(self):
        return f"FaultRule({self.spec()})"


class _SiteState:
    __slots__ = ("rng", "checks", "fires")

    def __init__(self, seed: int, site: str):
        self.rng = random.Random(f"{seed}:{site}")
        self.checks = 0
        self.fires = 0


class FaultPlan:
    """A seeded set of site rules (see module doc). Thread-safe; the
    trigger decision runs under one lock, the effect (raise/sleep/kill)
    outside it."""

    def __init__(self, seed: int = 0,
                 rules: Optional[Dict[str, FaultRule]] = None):
        for site in (rules or {}):
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r} "
                                 f"(known: {SITES})")
        self.seed = int(seed)
        self.rules: Dict[str, FaultRule] = dict(rules or {})
        self._state = {s: _SiteState(self.seed, s) for s in self.rules}
        self._lock = threading.Lock()
        self._injected = 0
        self._drained = 0

    # -- the hot-path check --------------------------------------------------
    def check(self, site: str) -> None:
        rule = self.rules.get(site)
        if rule is None:
            return
        with self._lock:
            st = self._state[site]
            st.checks += 1
            if st.checks <= rule.after:
                return
            if rule.times is not None and st.fires >= rule.times:
                return
            if rule.rate < 1.0 and st.rng.random() >= rule.rate:
                return
            st.fires += 1
            self._injected += 1
        self._fire(site, rule)

    def _fire(self, site: str, rule: FaultRule) -> None:
        if rule.action == "error":
            if rule.exc == "runtime":
                raise RuntimeError(f"injected fault at {site} "
                                   f"(seed {self.seed})")
            code = getattr(_errno, rule.errno_name)
            raise OSError(code, f"injected {rule.errno_name} at {site} "
                                f"(seed {self.seed})")
        if rule.action == "delay":
            time.sleep(rule.delay_ms / 1e3)
            return
        if rule.action == "hang":
            time.sleep(rule.hang_s)
            return
        if rule.action == "kill":
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
            return                       # pragma: no cover (we died)
        os._exit(17)                     # action == "exit"

    # -- accounting ----------------------------------------------------------
    def counts(self) -> Dict[str, Dict[str, int]]:
        """Per-site ``{checks, fires}`` (snapshot)."""
        with self._lock:
            return {s: {"checks": st.checks, "fires": st.fires}
                    for s, st in self._state.items()}

    @property
    def injected(self) -> int:
        with self._lock:
            return self._injected

    def drain(self) -> int:
        """Fires since the last drain — the ``faults_injected`` slot's
        per-interval figure."""
        with self._lock:
            d = self._injected - self._drained
            self._drained = self._injected
            return d

    # -- serialization -------------------------------------------------------
    def spec(self) -> str:
        """The ``QT_FAULTS`` string reproducing this plan (modulo seed,
        which rides ``QT_FAULTS_SEED``) — how the supervisor/bench arm
        child replicas."""
        return ";".join(f"{site}:{rule.spec()}"
                        for site, rule in sorted(self.rules.items()))

    def env(self) -> Dict[str, str]:
        """The env-var pair arming a child process with this plan."""
        return {"QT_FAULTS": self.spec(),
                "QT_FAULTS_SEED": str(self.seed)}

    def snapshot(self) -> dict:
        """JSONL-ready ``chaos`` payload: the plan + what it did."""
        return {"seed": self.seed, "spec": self.spec(),
                "injected": self.injected, "sites": self.counts()}

    def emit(self, sink, kind: str = "chaos") -> dict:
        """Append :meth:`snapshot` to a ``metrics.MetricsSink``."""
        return sink.emit(self.snapshot(), kind=kind)

    def __repr__(self):
        return f"FaultPlan(seed={self.seed}, {self.spec()!r})"


def parse_spec(spec: str, seed: int = 0) -> FaultPlan:
    """Parse a ``QT_FAULTS`` spec string (see module doc) into a plan.
    Format: ``site:action[,key=value...]`` joined by ``;``. Unknown
    sites/actions/keys raise — a typo'd chaos plan silently injecting
    nothing would report "survived" without the test."""
    rules: Dict[str, FaultRule] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"bad QT_FAULTS rule {part!r} "
                             "(want site:action[,k=v...])")
        site, body = part.split(":", 1)
        fields = [f.strip() for f in body.split(",") if f.strip()]
        if not fields:
            raise ValueError(f"bad QT_FAULTS rule {part!r}: no action")
        kw: dict = {"action": fields[0]}
        for f in fields[1:]:
            if "=" not in f:
                raise ValueError(f"bad QT_FAULTS field {f!r} in {part!r}")
            k, v = f.split("=", 1)
            if k == "errno":
                kw["errno_name"] = v
            elif k in ("rate", "delay_ms", "hang_s"):
                kw[k] = float(v)
            elif k in ("after", "times"):
                kw[k] = int(v)
            elif k == "exc":
                kw["exc"] = v
            else:
                raise ValueError(f"unknown QT_FAULTS key {k!r} in {part!r}")
        rules[site.strip()] = FaultRule(**kw)
    return FaultPlan(seed=seed, rules=rules)


def plan_from_env(environ=None) -> Optional[FaultPlan]:
    """The plan ``QT_FAULTS``/``QT_FAULTS_SEED`` describe, or None."""
    env = os.environ if environ is None else environ
    spec = env.get("QT_FAULTS")
    if not spec:
        return None
    return parse_spec(spec, seed=int(env.get("QT_FAULTS_SEED", "0")))


# -- process-global arming ----------------------------------------------------

_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Arm ``plan`` process-wide (replaces any previous plan)."""
    global _PLAN
    _PLAN = plan
    return plan


def disarm() -> None:
    """Disarm: every ``fire()`` is a no-op again."""
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    """The armed plan, or None."""
    return _PLAN


def fire(site: str) -> None:
    """The site hook the instrumented layers call. Disarmed (the
    default), this is one global load + None check."""
    p = _PLAN
    if p is not None:
        p.check(site)


def drain_injected() -> int:
    """Fires since the last drain across the armed plan (0 when
    disarmed) — what the metered lookup writes into the
    ``faults_injected`` counter slot."""
    p = _PLAN
    return 0 if p is None else p.drain()


# arm from the environment at import: QT_FAULTS is how the chaos bench
# and the supervisor arm whole child processes without code changes
_env_plan = plan_from_env()
if _env_plan is not None and _env_plan.rules:
    install(_env_plan)
del _env_plan
