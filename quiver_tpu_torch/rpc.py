"""RPC front end for the serving fleet: deadlines, retries, hedging
(counterpart of ``quiver_tpu/rpc.py``, the same wire format byte for
byte, so either package's client talks to the other's server).

An asyncio front end over ``MicroBatchServer.submit`` speaking a simple
length-prefixed RPC, so load generators and real clients hit a replica
over a socket, plus the CLIENT discipline a fleet needs to survive its
own replicas:

**Wire format** (both directions): a 4-byte big-endian unsigned length
prefix, then that many bytes of UTF-8 JSON. One logical message per
frame; a connection multiplexes many in-flight requests, correlated by
a client-chosen ``id``. Requests::

    {"op": "lookup", "id": 7, "node": 123,
     "budget_ms": 80.0,                  # remaining deadline budget
     "ctx": {"qt.trace_id": ..., ...}}   # optional tracing.inject()
    {"op": "ping", "id": 8}

Responses::

    {"id": 7, "ok": true, "row": [...]}            # float32 logits row
    {"id": 7, "ok": false, "error": "DeadlineExceeded",
     "message": "..."}
    {"id": 8, "ok": true, "pong": true, "health": 0.83}

**Deadlines are a budget, not a wall-clock timestamp** (fleet clocks
disagree): the client sends the milliseconds REMAINING at send time;
the server restarts the clock at arrival. A request whose budget is
already spent is shed immediately — before it wastes a coalescer batch
slot (:class:`~quiver_tpu_torch.serving.MicroBatchServer` drops expired
requests at coalesce time too, via ``submit(deadline=...)``).

**The client** (:class:`RpcClient`) owns the failure discipline:

- *timeout → retry*: capped exponential backoff with FULL jitter
  (seeded ``random.Random`` — reproducible), each retry routed to the
  next-healthiest replica (a duck-typed ``router=`` with ``ranked`` and
  ``pick`` when attached, seeded rotation otherwise); connection
  failures fail every in-flight request on that connection with
  :class:`ReplicaUnavailable` and the next attempt reconnects;
- *hedging*: when the primary attempt is still unanswered after the
  client's OBSERVED p95 latency (tracked per client, floor/ceiling
  clamped), the same request is sent again to the next-healthiest
  replica; first answer wins and the loser is cancelled — safe because
  serve lookups are read-only/idempotent (a duplicate dispatch costs a
  batch slot, never a wrong answer);
- *typed failure, never silence*: every ``lookup`` resolves with a row
  or raises a typed :class:`RpcError` (``DeadlineExceeded``,
  ``Overloaded``, ``ServerClosed``, ``ReplicaUnavailable``, or
  :class:`AllAttemptsFailed` carrying the per-attempt causes). Zero
  accepted requests are silently lost.

Everything here is stdlib + numpy on HOST threads: it imports only the
package's ``faults`` and ``tracing``, never torch, so a replica or a
client process loads it in milliseconds and nothing here touches the
card.
"""

from __future__ import annotations

import asyncio
import collections
import json
import random
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import faults, tracing

__all__ = ["RpcError", "DeadlineExceeded", "AttemptTimeout",
           "Overloaded", "ServerClosed", "ReplicaUnavailable",
           "AllAttemptsFailed", "RpcServer", "RpcClient", "read_frame",
           "write_frame", "MAX_FRAME"]

#: frame size bound: a length prefix claiming more than this is a
#: protocol error (garbage/hostile peer), not an allocation request
MAX_FRAME = 8 << 20

_LEN = struct.Struct(">I")


# -- typed errors (the wire's ``error`` field <-> these classes) --------------


class RpcError(RuntimeError):
    """Base of every typed RPC failure; ``error`` is the wire name."""

    error = "ServerError"


class DeadlineExceeded(RpcError):
    """The request's deadline budget was spent — at admission, in the
    coalescer, or waiting for the answer. Not retried (the budget is
    the caller's; there is nothing left to spend)."""

    error = "DeadlineExceeded"


class AttemptTimeout(RpcError):
    """ONE attempt went unanswered within the per-attempt timeout
    (client-local, never on the wire). Retriable — the overall deadline
    budget may still have room, and the retry goes elsewhere."""

    error = "AttemptTimeout"


class Overloaded(RpcError):
    """The replica shed the request at admission (its queue was full).
    Retriable — another replica may have capacity."""

    error = "Overloaded"


class ServerClosed(RpcError):
    """The replica is shutting down (or its coalescer died): the
    request was never dispatched. Retriable elsewhere."""

    error = "ServerClosed"


class ReplicaUnavailable(RpcError):
    """Transport-level failure: connect refused, connection reset,
    torn frame. The replica may be dead — retriable elsewhere."""

    error = "ReplicaUnavailable"


class AllAttemptsFailed(RpcError):
    """Every retry (and hedge) failed; ``causes`` carries the
    per-attempt exceptions in order."""

    error = "AllAttemptsFailed"

    def __init__(self, msg: str, causes: Sequence[BaseException] = ()):
        super().__init__(msg)
        self.causes = list(causes)


_WIRE_ERRORS = {c.error: c for c in
                (RpcError, DeadlineExceeded, Overloaded, ServerClosed,
                 ReplicaUnavailable, AllAttemptsFailed)}

#: retriable wire errors — the others mean spending more attempts
#: cannot change the outcome
_RETRIABLE = ("Overloaded", "ServerClosed", "ReplicaUnavailable",
              "ServerError", "AttemptTimeout")


def _wire_error_of(exc: BaseException) -> Tuple[str, str]:
    """(wire name, message) for an exception the backend raised."""
    if isinstance(exc, RpcError):
        return exc.error, str(exc)
    name = type(exc).__name__
    if name == "OverloadError":          # serving.OverloadError, by
        return "Overloaded", str(exc)    # name: no serving import here
    return "ServerError", f"{name}: {exc}"


# -- framing ------------------------------------------------------------------


async def read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    """One length-prefixed JSON frame, or None at clean EOF. A torn
    prefix/body or an oversized length raises ``ConnectionError``."""
    try:
        head = await reader.readexactly(_LEN.size)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None                  # clean EOF between frames
        raise ConnectionError("torn frame prefix") from None
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise ConnectionError(f"frame length {n} exceeds {MAX_FRAME}")
    try:
        body = await reader.readexactly(n)
    except asyncio.IncompleteReadError:
        raise ConnectionError("torn frame body") from None
    try:
        return json.loads(body.decode())
    except ValueError:
        raise ConnectionError("frame is not valid JSON") from None


def write_frame(writer: asyncio.StreamWriter, msg: dict) -> None:
    """Queue one frame on ``writer`` (caller drains)."""
    body = json.dumps(msg).encode()
    writer.write(_LEN.pack(len(body)) + body)


# -- the server ---------------------------------------------------------------


class RpcServer:
    """Asyncio front end over one serve backend.

    ``backend`` is duck-typed: ``submit(node_id, context=None[,
    deadline=None][, tenant=None]) -> concurrent.futures.Future`` (the
    ``MicroBatchServer`` contract; ``deadline`` — an absolute
    ``time.perf_counter()`` instant — is passed when the signature
    takes it, so the coalescer can shed expired work before it costs a
    batch slot; ``tenant`` — a tenant-class name from the request's
    ``tenant`` wire field — likewise, so per-tenant SLO accounting and
    shed-order policy apply fleet-wide) plus optional ``health() ->
    {"score": float, ...}`` for ``ping``. The loop runs on a daemon
    thread; ``port=0`` binds ephemeral (read ``.port`` back).
    ``close()`` is idempotent.

    Each accepted request passes the ``rpc.request`` fault site — a
    replica kill/hang trigger for fault injection."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 start: bool = True):
        self.backend = backend
        self.host = host
        self._want_port = int(port)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._closed = False
        self.requests = 0
        self.shed_deadline = 0
        try:
            import inspect
            params = inspect.signature(backend.submit).parameters
            self._takes_deadline = "deadline" in params
            self._takes_tenant = "tenant" in params
        except (TypeError, ValueError):
            self._takes_deadline = False
            self._takes_tenant = False
        if start:
            self.start()

    # -- life cycle ----------------------------------------------------------
    def start(self) -> "RpcServer":
        if self._closed:
            raise ServerClosed("rpc server is closed")
        if self._thread is None:
            t = threading.Thread(target=self._run, name="qt-rpc-server",
                                 daemon=True)
            t.start()
            self._thread = t
            if not self._ready.wait(timeout=10.0):
                raise RuntimeError("rpc server failed to start")
        return self

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._serve_conn, self.host, self._want_port)
            self._ready.set()

        loop.run_until_complete(boot())
        try:
            loop.run_forever()
        finally:
            to_cancel = asyncio.all_tasks(loop)
            for task in to_cancel:
                task.cancel()
            if to_cancel:
                loop.run_until_complete(asyncio.gather(
                    *to_cancel, return_exceptions=True))
            loop.close()

    @property
    def port(self) -> int:
        if self._server is None:
            return self._want_port
        return self._server.sockets[0].getsockname()[1]

    def close(self) -> None:
        """Stop accepting, cancel in-flight handlers, join the loop
        thread. Idempotent. The backend is NOT closed — the owner that
        built it closes it."""
        if self._closed:
            return
        self._closed = True
        loop, self._loop = self._loop, None
        t, self._thread = self._thread, None
        if loop is not None:
            def _stop():
                if self._server is not None:
                    self._server.close()
                loop.stop()
            try:
                loop.call_soon_threadsafe(_stop)
            except RuntimeError:
                pass                     # loop already gone
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "RpcServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- connection handling --------------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        wlock = asyncio.Lock()
        tasks: set = set()
        try:
            while True:
                try:
                    msg = await read_frame(reader)
                except ConnectionError:
                    break                # hostile/torn peer: hang up
                if msg is None:
                    break
                task = asyncio.ensure_future(
                    self._handle(msg, writer, wlock))
                tasks.add(task)
                task.add_done_callback(tasks.discard)
        finally:
            for task in tasks:
                task.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _respond(self, writer, wlock, msg: dict) -> None:
        async with wlock:
            write_frame(writer, msg)
            try:
                await writer.drain()
            except (ConnectionError, OSError):
                pass                     # client hung up mid-answer

    async def _handle(self, msg: dict, writer, wlock) -> None:
        rid = msg.get("id")
        op = msg.get("op")
        t_in = time.perf_counter()
        self.requests += 1
        try:
            # the fault-injection replica trigger: a kill/hang/error
            # rule here IS "the replica died/hung mid-traffic".
            # Exception (not just OSError): an exc=runtime rule must
            # still produce a typed answer, never an unanswered id
            # the client only resolves by burning its whole timeout
            faults.fire("rpc.request")
        except Exception as e:
            await self._respond(writer, wlock,
                                {"id": rid, "ok": False,
                                 "error": "ServerError",
                                 "message": f"injected: {e}"})
            return
        if op == "ping":
            health = None
            h = getattr(self.backend, "health", None)
            if callable(h):
                try:
                    health = h().get("score")
                except Exception:
                    health = None
            await self._respond(writer, wlock,
                                {"id": rid, "ok": True, "pong": True,
                                 "health": health})
            return
        if op != "lookup" or "node" in msg and not isinstance(
                msg.get("node"), int):
            await self._respond(writer, wlock,
                                {"id": rid, "ok": False,
                                 "error": "ServerError",
                                 "message": f"bad request op={op!r}"})
            return
        budget_ms = msg.get("budget_ms")
        deadline = None
        if budget_ms is not None:
            deadline = t_in + float(budget_ms) / 1e3
            if float(budget_ms) <= 0.0:
                # spent before arrival: shed NOW, before the request
                # costs a batch slot (the deadline's whole point)
                self.shed_deadline += 1
                await self._respond(writer, wlock,
                                    {"id": rid, "ok": False,
                                     "error": "DeadlineExceeded",
                                     "message": "budget spent before "
                                                "arrival"})
                return
        try:
            kw = {"context": msg.get("ctx")}
            if self._takes_deadline:
                kw["deadline"] = deadline
            if self._takes_tenant and msg.get("tenant") is not None:
                # tenant rides the wire as plain request metadata; a
                # backend without a registry (no `tenant` parameter)
                # simply never sees it
                kw["tenant"] = str(msg["tenant"])
            fut = self.backend.submit(int(msg["node"]), **kw)
        except BaseException as e:
            name, text = _wire_error_of(e)
            await self._respond(writer, wlock,
                                {"id": rid, "ok": False, "error": name,
                                 "message": text})
            return
        try:
            timeout = (None if deadline is None
                       else max(deadline - time.perf_counter(), 0.0))
            row = await asyncio.wait_for(asyncio.wrap_future(fut),
                                         timeout=timeout)
        except asyncio.TimeoutError:
            self.shed_deadline += 1
            fut.cancel()
            await self._respond(writer, wlock,
                                {"id": rid, "ok": False,
                                 "error": "DeadlineExceeded",
                                 "message": "deadline passed while "
                                            "queued/dispatched"})
            return
        except asyncio.CancelledError:
            fut.cancel()
            raise
        except BaseException as e:
            name, text = _wire_error_of(e)
            await self._respond(writer, wlock,
                                {"id": rid, "ok": False, "error": name,
                                 "message": text})
            return
        await self._respond(writer, wlock,
                            {"id": rid, "ok": True,
                             "row": np.asarray(row, np.float32)
                             .ravel().tolist()})


# -- the client ---------------------------------------------------------------


class _Conn:
    """One multiplexed connection to one replica (client side, lives on
    the client's loop): pending requests correlated by id; a transport
    failure fails EVERY pending request with ReplicaUnavailable."""

    def __init__(self, name: str):
        self.name = name
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.pending: Dict[int, asyncio.Future] = {}
        self.wlock = asyncio.Lock()
        self._reader_task: Optional[asyncio.Task] = None

    async def open(self, host: str, port: int, timeout: float) -> None:
        self.reader, self.writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout=timeout)
        self._reader_task = asyncio.ensure_future(self._read_loop())

    async def _read_loop(self) -> None:
        err: BaseException = ReplicaUnavailable(
            f"{self.name}: connection closed")
        try:
            while True:
                msg = await read_frame(self.reader)
                if msg is None:
                    break
                fut = self.pending.pop(msg.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
        except (ConnectionError, OSError) as e:
            err = ReplicaUnavailable(f"{self.name}: {e}")
        finally:
            for fut in self.pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self.pending.clear()

    @property
    def alive(self) -> bool:
        t = self._reader_task
        return t is not None and not t.done()

    async def call(self, msg: dict, timeout: Optional[float]) -> dict:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.pending[msg["id"]] = fut
        try:
            async with self.wlock:
                write_frame(self.writer, msg)
                await self.writer.drain()
            return await asyncio.wait_for(fut, timeout=timeout)
        except asyncio.TimeoutError:
            # an unanswered attempt, not a transport failure (the caller
            # makes it AttemptTimeout); since Python 3.11 TimeoutError
            # is an OSError, so it must pass before the clause below
            raise
        except (ConnectionError, OSError) as e:
            raise ReplicaUnavailable(f"{self.name}: {e}") from None
        finally:
            self.pending.pop(msg["id"], None)

    async def close(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self.writer is not None:
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except (ConnectionError, OSError):
                pass


class RpcClient:
    """Deadline/retry/hedge client over N replicas (see module doc).

    ``replicas`` is ``{name: (host, port)}`` (or a list — names default
    ``r0..``). ``router`` (duck-typed: ``ranked(exclude=, seed=)`` and
    ``pick(exclude=, seed=)``, as a fleet health router has them) ranks
    replicas by health for routing and hedging; without one a seeded
    rotation spreads load. The client owns one daemon loop thread; ``lookup``
    blocks, ``lookup_future`` returns a ``concurrent.futures.Future``.

    Policy knobs: ``timeout_ms`` per attempt (clamped to the remaining
    deadline budget), ``retries`` additional attempts after the first
    (each on the next-healthiest replica, after capped-exponential
    full-jitter backoff), ``hedge=True`` arms hedged requests (the
    hedge fires after the observed p95 of recent request latencies,
    clamped to ``[hedge_floor_ms, timeout_ms/2]``; a fixed
    ``hedge_delay_ms`` overrides). ``stats()`` reports attempts,
    retries, hedges, hedge wins, and typed-error counts."""

    def __init__(self, replicas, router=None, timeout_ms: float = 1000.0,
                 retries: int = 3, backoff_ms: float = 25.0,
                 backoff_cap_ms: float = 1000.0, hedge: bool = True,
                 hedge_delay_ms: Optional[float] = None,
                 hedge_floor_ms: float = 5.0,
                 connect_timeout_ms: float = 2000.0, seed: int = 0):
        if isinstance(replicas, dict):
            items = list(replicas.items())
        else:
            items = [(f"r{i}", a) for i, a in enumerate(replicas)]
        if not items:
            raise ValueError("need at least one replica address")
        self.addrs: Dict[str, Tuple[str, int]] = {
            n: (str(h), int(p)) for n, (h, p) in items}
        self.router = router
        self.timeout_ms = float(timeout_ms)
        self.retries = int(retries)
        self.backoff_ms = float(backoff_ms)
        self.backoff_cap_ms = float(backoff_cap_ms)
        self.hedge = bool(hedge)
        self.hedge_delay_ms = hedge_delay_ms
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.connect_timeout_ms = float(connect_timeout_ms)
        self._rng = random.Random(seed)
        self._rotation = 0
        self._ids = iter(range(1, 1 << 62))
        self._conns: Dict[str, _Conn] = {}
        # per-replica open serialization (loop-thread only): two
        # concurrent lookups racing a reconnect must share ONE
        # connection, not leak the loser's socket + reader task
        self._open_locks: Dict[str, asyncio.Lock] = {}
        self._lat_ms: collections.deque = collections.deque(maxlen=256)
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "attempts": 0, "retries": 0,
                       "hedges": 0, "hedge_wins": 0, "deadline_shed": 0}
        self._errors: collections.Counter = collections.Counter()
        self._closed = False
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run_loop,
                                        name="qt-rpc-client",
                                        daemon=True)
        self._thread.start()

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()
        self._loop.close()

    # -- routing -------------------------------------------------------------
    def _ranked(self, exclude: Sequence[str],
                seed=None) -> List[str]:
        """Replicas to try for one attempt. With a router: the PRIMARY
        is a health-WEIGHTED pick (load spreads away from pressed
        replicas), the rest follow healthiest-first (what the hedge
        and any fallback walk). Without one, a deterministic rotation
        spreads load. ``seed`` (the request's node id) is forwarded to
        locality-aware routers so partition ownership biases the draw;
        routers without the kwarg keep working (pure health)."""
        names = [n for n in self.addrs if n not in exclude]
        if not names:
            names = list(self.addrs)     # all excluded: try anyway
        if self.router is not None:
            try:
                ranked = [n for n in self.router.ranked(
                              exclude=exclude, seed=seed)
                          if n in self.addrs]
            except TypeError:            # router without seed kwarg
                ranked = [n for n in self.router.ranked(exclude=exclude)
                          if n in self.addrs]
            try:
                try:
                    primary = self.router.pick(exclude=exclude,
                                               seed=seed)
                except TypeError:        # router without seed kwarg
                    primary = self.router.pick(exclude=exclude)
            except ValueError:
                primary = None
            if primary in self.addrs:
                ranked = [primary] + [n for n in ranked
                                      if n != primary]
            if ranked:
                return ranked + [n for n in names if n not in ranked]
        with self._lock:
            k = self._rotation
            self._rotation += 1
        return names[k % len(names):] + names[:k % len(names)]

    def _hedge_delay_s(self) -> float:
        if self.hedge_delay_ms is not None:
            return self.hedge_delay_ms / 1e3
        with self._lock:
            lats = sorted(self._lat_ms)
        if len(lats) >= 8:
            p95 = lats[min(int(0.95 * len(lats)), len(lats) - 1)]
        else:
            p95 = self.timeout_ms / 4.0
        return min(max(p95, self.hedge_floor_ms),
                   self.timeout_ms / 2.0) / 1e3

    # -- the call path (coroutines, client loop) ------------------------------
    async def _conn_of(self, name: str) -> _Conn:
        conn = self._conns.get(name)
        if conn is not None and conn.alive:
            return conn
        lock = self._open_locks.setdefault(name, asyncio.Lock())
        async with lock:
            conn = self._conns.get(name)     # the race winner's conn
            if conn is not None and conn.alive:
                return conn
            if conn is not None:
                await conn.close()
            conn = _Conn(name)
            host, port = self.addrs[name]
            try:
                await conn.open(host, port,
                                self.connect_timeout_ms / 1e3)
            except (ConnectionError, OSError,
                    asyncio.TimeoutError) as e:
                raise ReplicaUnavailable(
                    f"{name}: connect failed: {e}") from None
            self._conns[name] = conn
            return conn

    async def _call_replica(self, name: str, node: int,
                            budget_ms: Optional[float],
                            ctx: Optional[dict],
                            timeout_s: float,
                            tid: Optional[int] = None,
                            hedge: bool = False,
                            tenant: Optional[str] = None) -> np.ndarray:
        # with tracing on, each dispatch leaves an `rpc.attempt` (or
        # `rpc.hedge`) span under the request's trace_id — retries and
        # hedge races are visible per replica in the assembled trace
        if tid is None:
            return await self._call_replica_raw(name, node, budget_ms,
                                                ctx, timeout_s, tenant)
        t0 = time.perf_counter()
        span = "rpc.hedge" if hedge else "rpc.attempt"
        try:
            row = await self._call_replica_raw(name, node, budget_ms,
                                               ctx, timeout_s, tenant)
        except asyncio.CancelledError:
            # a cancelled hedge loser is NOT an outcome — the winner's
            # span tells the request's story; recording
            # error=CancelledError here would make the tail sampler's
            # `error` policy keep every hedge-raced SUCCESS
            raise
        except BaseException as e:
            tracing.record(span, t0, time.perf_counter() - t0, tid,
                           {"replica": name,
                            "error": type(e).__name__})
            raise
        tracing.record(span, t0, time.perf_counter() - t0, tid,
                       {"replica": name})
        return row

    async def _call_replica_raw(self, name: str, node: int,
                                budget_ms: Optional[float],
                                ctx: Optional[dict],
                                timeout_s: float,
                                tenant: Optional[str] = None
                                ) -> np.ndarray:
        conn = await self._conn_of(name)
        msg = {"op": "lookup", "id": next(self._ids), "node": int(node)}
        if budget_ms is not None:
            msg["budget_ms"] = round(float(budget_ms), 3)
        if ctx:
            msg["ctx"] = ctx
        if tenant is not None:
            msg["tenant"] = str(tenant)
        try:
            resp = await conn.call(msg, timeout_s)
        except asyncio.TimeoutError:
            raise AttemptTimeout(
                f"{name}: no answer within {timeout_s * 1e3:.0f} ms") \
                from None
        if resp.get("ok"):
            return np.asarray(resp["row"], np.float32)
        err = _WIRE_ERRORS.get(resp.get("error"), RpcError)
        raise err(f"{name}: {resp.get('message', resp.get('error'))}")

    async def _attempt(self, names: List[str], node: int,
                       remaining_ms: Optional[float],
                       ctx: Optional[dict],
                       causes: List[BaseException],
                       dispatched: List[str],
                       tid: Optional[int] = None,
                       tenant: Optional[str] = None) -> np.ndarray:
        """One attempt = a primary call plus (optionally) one hedge to
        the next-ranked replica once the hedge delay passes unanswered.
        First answer wins; the loser is cancelled (idempotent serve
        lookups make the duplicate safe). Every replica actually
        dispatched to lands in ``dispatched`` — the retry loop
        excludes them all, so the next attempt spends its budget on an
        UNTOUCHED replica, not the hedge target that just failed."""
        timeout_s = self.timeout_ms / 1e3
        if remaining_ms is not None:
            timeout_s = min(timeout_s, max(remaining_ms, 1.0) / 1e3)
        primary = asyncio.ensure_future(self._call_replica(
            names[0], node, remaining_ms, ctx, timeout_s, tid,
            tenant=tenant))
        dispatched.append(names[0])
        tasks = {primary: names[0]}
        if self.hedge and len(names) > 1:
            delay = self._hedge_delay_s()
            done, _ = await asyncio.wait({primary}, timeout=delay)
            if not done:
                with self._lock:
                    self._stats["hedges"] += 1
                left_ms = (None if remaining_ms is None
                           else max(remaining_ms - delay * 1e3, 1.0))
                hedge = asyncio.ensure_future(self._call_replica(
                    names[1], node, left_ms, ctx,
                    max(timeout_s - delay, 1e-3), tid, hedge=True,
                    tenant=tenant))
                dispatched.append(names[1])
                tasks[hedge] = names[1]
        pending = set(tasks)
        result = None
        got = False
        while pending and not got:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED)
            for task in done:
                if task.exception() is None and not got:
                    got = True
                    result = task.result()
                    if task is not primary:
                        with self._lock:
                            self._stats["hedge_wins"] += 1
                elif task.exception() is not None:
                    causes.append(task.exception())
        for task in pending:
            task.cancel()                # first answer won: cancel dup
        if got:
            return result
        raise causes[-1]

    async def _lookup(self, node: int, budget_ms: Optional[float],
                      ctx: Optional[dict],
                      tenant: Optional[str] = None) -> np.ndarray:
        if not tracing.enabled():
            return await self._lookup_inner(node, budget_ms, ctx, None,
                                            tenant)
        # the client's ROOT span (`rpc.lookup`) closes the trace on
        # this side of the wire — the tail sampler's completion
        # signal; a failed lookup closes it error-stamped, so the
        # client keeps exactly the traces its user saw fail
        c = tracing.extract(ctx)
        tid = c.trace_id if c is not None else tracing.new_global_trace_id()
        t0 = time.perf_counter()
        try:
            row = await self._lookup_inner(node, budget_ms, ctx, tid,
                                           tenant)
        except asyncio.CancelledError:
            # a cancelled lookup (caller cancelled the future, client
            # shutting down) is NOT a failed request — no root span,
            # or the `error` policy would keep every such trace
            raise
        except BaseException as e:
            tracing.record("rpc.lookup", t0, time.perf_counter() - t0,
                           tid, {"node": int(node),
                                 "error": type(e).__name__})
            raise
        tracing.record("rpc.lookup", t0, time.perf_counter() - t0, tid,
                       {"node": int(node)})
        return row

    async def _lookup_inner(self, node: int, budget_ms: Optional[float],
                            ctx: Optional[dict],
                            tid: Optional[int],
                            tenant: Optional[str] = None) -> np.ndarray:
        t0 = time.perf_counter()
        deadline = (None if budget_ms is None
                    else t0 + float(budget_ms) / 1e3)
        causes: List[BaseException] = []
        tried: List[str] = []
        for attempt in range(self.retries + 1):
            remaining_ms = None
            if deadline is not None:
                remaining_ms = (deadline - time.perf_counter()) * 1e3
                if remaining_ms <= 0:
                    with self._lock:
                        self._stats["deadline_shed"] += 1
                        self._errors["DeadlineExceeded"] += 1
                    raise DeadlineExceeded(
                        f"budget spent after {attempt} attempts "
                        f"({[type(c).__name__ for c in causes]})")
            names = self._ranked(exclude=tried, seed=node)
            with self._lock:
                self._stats["attempts"] += 1
                if attempt:
                    self._stats["retries"] += 1
            dispatched: List[str] = []
            try:
                row = await self._attempt(names, node, remaining_ms,
                                          ctx, causes, dispatched, tid,
                                          tenant)
                with self._lock:
                    self._lat_ms.append(
                        (time.perf_counter() - t0) * 1e3)
                return row
            except RpcError as e:
                if e.error not in _RETRIABLE:
                    with self._lock:
                        self._errors[e.error] += 1
                    raise
            tried.extend(n for n in dispatched if n not in tried)
            if attempt < self.retries:
                # capped exponential backoff, FULL jitter: the whole
                # delay is uniform in [0, cap] — the discipline that
                # de-synchronizes a thundering herd of retriers
                cap_ms = min(self.backoff_cap_ms,
                             self.backoff_ms * (2 ** attempt))
                delay_ms = self._rng.uniform(0.0, cap_ms)
                if deadline is not None:
                    delay_ms = min(
                        delay_ms,
                        max((deadline - time.perf_counter()) * 1e3
                            - 1.0, 0.0))
                if delay_ms > 0:
                    t_back = time.perf_counter()
                    await asyncio.sleep(delay_ms / 1e3)
                    if tid is not None:
                        tracing.record("rpc.backoff", t_back,
                                       time.perf_counter() - t_back,
                                       tid, {"attempt": attempt})
        with self._lock:
            self._errors["AllAttemptsFailed"] += 1
        raise AllAttemptsFailed(
            f"{self.retries + 1} attempts failed for node {node}: "
            f"{[f'{type(c).__name__}: {c}' for c in causes[-4:]]}",
            causes)

    # -- the sync facade ------------------------------------------------------
    def lookup_future(self, node: int, budget_ms: Optional[float] = None,
                      context: Optional[dict] = None,
                      tenant: Optional[str] = None):
        """Submit one lookup; returns a ``concurrent.futures.Future``
        resolving to the float32 logits row or raising a typed
        :class:`RpcError`. ``tenant`` (a tenant-class name) rides the
        wire as request metadata — replicas with a tenant registry
        apply their per-tenant SLO accounting + shed-order policy;
        replicas without one ignore it."""
        if self._closed:
            raise ServerClosed("rpc client is closed")
        if tracing.enabled():
            # mint + inject a global trace context so the replica's
            # serve spans and this client's rpc spans share one
            # trace_id — the fleet assembler's stitch key. Caller
            # metadata without a context gets stamped into a COPY
            # (the caller's dict is not ours to mutate); a context
            # the caller already injected passes through untouched.
            if context is None:
                context = tracing.inject({})
            elif tracing.extract(context) is None:
                context = tracing.inject(dict(context))
        with self._lock:
            self._stats["requests"] += 1
        return asyncio.run_coroutine_threadsafe(
            self._lookup(int(node), budget_ms, context, tenant),
            self._loop)

    def lookup(self, node: int, budget_ms: Optional[float] = None,
               context: Optional[dict] = None,
               tenant: Optional[str] = None) -> np.ndarray:
        """Blocking :meth:`lookup_future`."""
        timeout = None
        if budget_ms is not None:
            # generous host-side guard: the coroutine enforces the real
            # deadline; this only stops a wedged loop from hanging the
            # caller forever
            timeout = budget_ms / 1e3 + 30.0
        return self.lookup_future(node, budget_ms, context,
                                  tenant).result(timeout=timeout)

    def ping(self, name: str, timeout_ms: float = 1000.0) -> dict:
        """One ``ping`` to a named replica (health probe)."""
        async def _ping():
            conn = await self._conn_of(name)
            return await conn.call({"op": "ping", "id": next(self._ids)},
                                   timeout_ms / 1e3)
        return asyncio.run_coroutine_threadsafe(
            _ping(), self._loop).result(timeout=timeout_ms / 1e3 + 10.0)

    def stats(self) -> dict:
        """Requests/attempts/retries/hedges + typed-error counts +
        the observed latency p50/p95 the hedge delay derives from."""
        with self._lock:
            s = dict(self._stats)
            s["errors"] = dict(self._errors)
            lats = sorted(self._lat_ms)
        if lats:
            s["lat_p50_ms"] = round(lats[len(lats) // 2], 3)
            s["lat_p95_ms"] = round(
                lats[min(int(0.95 * len(lats)), len(lats) - 1)], 3)
        s["hedge_delay_ms"] = round(self._hedge_delay_s() * 1e3, 3)
        return s

    # -- life cycle -----------------------------------------------------------
    def close(self) -> None:
        """Close every connection, stop the loop thread. Idempotent."""
        if self._closed:
            return
        self._closed = True

        async def _shutdown():
            for conn in list(self._conns.values()):
                await conn.close()
            self._conns.clear()
            asyncio.get_running_loop().stop()

        try:
            asyncio.run_coroutine_threadsafe(_shutdown(), self._loop)
        except RuntimeError:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "RpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
