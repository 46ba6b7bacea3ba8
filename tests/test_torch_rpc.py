"""The port's RPC plane (``quiver_tpu_torch/rpc.py``) against the JAX
package's (``quiver_tpu/rpc.py``).

The wire protocol (frames, typed errors, ping), deadline budgets (spent
before arrival: shed at the front end; spent while queued: shed at the
coalescer) and the client's discipline (retry to the next replica,
hedging, typed ``AllAttemptsFailed``) of ``tests/test_rpc.py``, with a
fake backend and a duck-typed router in place of the fleet's. Then the
front end over the port's ``MicroBatchServer`` on the CPU engine, and
across the packages: a JAX ``RpcClient`` against the port's
``RpcServer`` and the port's client against JAX's server, rows equal to
1e-5 and error names equal on the wire, and the frames both packages
write for one message equal byte for byte."""

import asyncio
import concurrent.futures as cf
import json
import socket
import struct
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import quiver_tpu as qv
from quiver_tpu import rpc as jrpc
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.ops import sample_multihop as jsample_multihop
from quiver_tpu.parallel.train import (init_state, layers_to_adjs,
                                       masked_feature_gather)

import quiver_tpu_torch as qt
from quiver_tpu_torch import rpc as qrpc
from quiver_tpu_torch import tracing
from quiver_tpu_torch.models import flax_to_state_dict

N, DIM, CLASSES, CAP = 300, 8, 3, 8
FULL = [4, 4]


# ---------------------------------------------------------------------------
# helpers: fake backends, a duck-typed router, a raw synchronous caller
# ---------------------------------------------------------------------------


def fake_row(node: int) -> np.ndarray:
    return np.array([node, node * 0.5, node % 7], np.float32)


class FakeBackend:
    def __init__(self, delay_s: float = 0.0, fail=None):
        self.delay_s = delay_s
        self.fail = fail
        self.calls = 0

    def submit(self, node, context=None, deadline=None):
        self.calls += 1
        fut: cf.Future = cf.Future()
        if self.fail is not None:
            fut.set_exception(self.fail())
            return fut
        if self.delay_s:
            def resolve():
                if fut.set_running_or_notify_cancel():
                    fut.set_result(fake_row(node))
            t = threading.Timer(self.delay_s, resolve)
            t.daemon = True
            t.start()
        else:
            fut.set_result(fake_row(node))
        return fut

    def health(self):
        return {"score": 1.0}


class Router:
    """What the client asks of a fleet's health router: ``ranked`` (best
    first) and ``pick`` (the primary), both honouring ``exclude``;
    ``drained`` names stay reachable by a hedge, never as the primary."""

    def __init__(self, order, drained=()):
        self.order = list(order)
        self.drained = set(drained)

    def ranked(self, exclude=(), seed=None):
        return [n for n in self.order if n not in exclude]

    def pick(self, exclude=(), seed=None):
        live = [n for n in self.ranked(exclude) if n not in self.drained]
        if not live:
            raise ValueError("no replica")
        return live[0]


def sync_call(port, msg, timeout=10.0):
    """One raw length-prefixed round trip."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        body = json.dumps(msg).encode()
        s.sendall(struct.pack(">I", len(body)) + body)

        def recvn(n):
            buf = b""
            while len(buf) < n:
                chunk = s.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("peer closed")
                buf += chunk
            return buf

        (n,) = struct.unpack(">I", recvn(4))
        return json.loads(recvn(n))


def free_port():
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------


class TestWireProtocol:
    def test_lookup_ping_and_bad_op(self):
        srv = qrpc.RpcServer(FakeBackend())
        try:
            r = sync_call(srv.port, {"op": "lookup", "id": 1, "node": 5})
            assert r["ok"] and r["id"] == 1
            np.testing.assert_array_equal(np.asarray(r["row"], np.float32),
                                          fake_row(5))
            p = sync_call(srv.port, {"op": "ping", "id": 2})
            assert p["ok"] and p["pong"] and p["health"] == 1.0
            bad = sync_call(srv.port, {"op": "frobnicate", "id": 3})
            assert not bad["ok"] and bad["error"] == "ServerError"
            bad = sync_call(srv.port, {"op": "lookup", "id": 4,
                                       "node": "x"})
            assert not bad["ok"] and bad["error"] == "ServerError"
            assert srv.requests == 4
        finally:
            srv.close()
        assert srv.closed

    def test_oversized_frame_hangs_up(self):
        srv = qrpc.RpcServer(FakeBackend())
        try:
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=5) as s:
                s.settimeout(5)
                s.sendall(struct.pack(">I", qrpc.MAX_FRAME + 1))
                assert s.recv(4) == b""        # server hung up
            assert sync_call(srv.port, {"op": "ping", "id": 1})["ok"]
        finally:
            srv.close()

    def test_torn_and_garbled_frames(self):
        async def frames(data):
            reader = asyncio.StreamReader()
            reader.feed_data(data)
            reader.feed_eof()
            return await qrpc.read_frame(reader)

        body = b'{"id": 1}'
        assert asyncio.run(frames(b"")) is None          # clean EOF
        assert asyncio.run(frames(struct.pack(">I", len(body)) + body)) \
            == {"id": 1}
        for data, what in ((b"\x00\x00", "prefix"),
                           (struct.pack(">I", 20) + body, "body"),
                           (struct.pack(">I", 3) + b"{{{", "JSON")):
            with pytest.raises(ConnectionError, match=what):
                asyncio.run(frames(data))

    @pytest.mark.parametrize("exc,name", [
        (lambda: qt.OverloadError("queue full"), "Overloaded"),
        (lambda: qt.ServerClosed("closed"), "ServerClosed"),
        (lambda: qt.DeadlineExceeded("late"), "DeadlineExceeded"),
        (lambda: ValueError("odd"), "ServerError"),
    ])
    def test_backend_exception_maps_to_typed_error(self, exc, name):
        srv = qrpc.RpcServer(FakeBackend(fail=exc))
        try:
            r = sync_call(srv.port, {"op": "lookup", "id": 1, "node": 0})
            assert not r["ok"] and r["error"] == name
        finally:
            srv.close()

    def test_frames_equal_jax_byte_for_byte(self):
        class Sink:
            def __init__(self):
                self.data = b""

            def write(self, b):
                self.data += b

        msgs = [{"op": "lookup", "id": 7, "node": 123, "budget_ms": 80.0,
                 "ctx": {"qt.trace_id": 99, "qt.replica": "c"}},
                {"op": "ping", "id": 8},
                {"id": 7, "ok": True,
                 "row": np.asarray(fake_row(3)).tolist()},
                {"id": 7, "ok": False, "error": "DeadlineExceeded",
                 "message": "budget spent — before arrival"},
                {"id": 8, "ok": True, "pong": True, "health": 0.83}]
        for msg in msgs:
            a, b = Sink(), Sink()
            qrpc.write_frame(a, msg)
            jrpc.write_frame(b, msg)
            assert a.data == b.data and len(a.data) > 4
        assert qrpc.MAX_FRAME == jrpc.MAX_FRAME
        for name in ("RpcError", "DeadlineExceeded", "AttemptTimeout",
                     "Overloaded", "ServerClosed", "ReplicaUnavailable",
                     "AllAttemptsFailed"):
            assert getattr(qrpc, name).error == getattr(jrpc, name).error


# ---------------------------------------------------------------------------
# deadline budgets
# ---------------------------------------------------------------------------


class TestDeadlines:
    def test_budget_spent_before_arrival_sheds_at_front_end(self):
        backend = FakeBackend()
        srv = qrpc.RpcServer(backend)
        try:
            r = sync_call(srv.port, {"op": "lookup", "id": 1, "node": 3,
                                     "budget_ms": -5.0})
            assert not r["ok"] and r["error"] == "DeadlineExceeded"
            assert backend.calls == 0          # never cost a batch slot
            assert srv.shed_deadline == 1
        finally:
            srv.close()

    def test_deadline_passes_while_waiting_for_answer(self):
        srv = qrpc.RpcServer(FakeBackend(delay_s=1.0))
        try:
            t0 = time.perf_counter()
            r = sync_call(srv.port, {"op": "lookup", "id": 1, "node": 3,
                                     "budget_ms": 60.0})
            took = time.perf_counter() - t0
            assert not r["ok"] and r["error"] == "DeadlineExceeded"
            assert took < 0.9                  # answered AT the budget
        finally:
            srv.close()

    def test_unanswered_attempt_is_attempt_timeout(self):
        # an attempt that outlives its timeout is AttemptTimeout (and is
        # retried), never a transport failure; once the budget is spent
        # the next attempt raises DeadlineExceeded
        srv = qrpc.RpcServer(FakeBackend(delay_s=1.0))
        cli = qrpc.RpcClient({"r0": ("127.0.0.1", srv.port)}, retries=0,
                             hedge=False, timeout_ms=50.0)
        late = qrpc.RpcClient({"r0": ("127.0.0.1", srv.port)}, retries=1,
                              hedge=False, backoff_ms=1.0)
        try:
            with pytest.raises(qrpc.AllAttemptsFailed) as ei:
                cli.lookup(1, budget_ms=5000)
            assert [type(c) for c in ei.value.causes] == \
                [qrpc.AttemptTimeout]
            with pytest.raises(qrpc.DeadlineExceeded):
                late.lookup(2, budget_ms=30.0)
        finally:
            cli.close()
            late.close()
            srv.close()

    def test_client_budget_spent_raises_without_a_call(self):
        backend = FakeBackend()
        srv = qrpc.RpcServer(backend)
        cli = qrpc.RpcClient({"r0": ("127.0.0.1", srv.port)}, hedge=False)
        try:
            with pytest.raises(qrpc.DeadlineExceeded):
                cli.lookup(1, budget_ms=0.0)
            assert backend.calls == 0
            assert cli.stats()["deadline_shed"] == 1
        finally:
            cli.close()
            srv.close()


# ---------------------------------------------------------------------------
# client: retries, hedging, typed failure
# ---------------------------------------------------------------------------


class TestClientDiscipline:
    def test_retry_routes_to_next_healthiest(self):
        sick = qrpc.RpcServer(FakeBackend(fail=lambda: RuntimeError("boom")))
        well = qrpc.RpcServer(FakeBackend())
        cli = qrpc.RpcClient(
            {"sick": ("127.0.0.1", sick.port),
             "well": ("127.0.0.1", well.port)},
            router=Router(["sick", "well"]), retries=3, hedge=False,
            backoff_ms=5.0, seed=1)
        try:
            for n in range(6):
                np.testing.assert_array_equal(
                    cli.lookup(n, budget_ms=5000), fake_row(n))
            assert cli.stats()["retries"] == 6   # each re-routed once
        finally:
            cli.close()
            sick.close()
            well.close()

    def test_rotation_without_a_router(self):
        a, b = FakeBackend(), FakeBackend()
        sa, sb = qrpc.RpcServer(a), qrpc.RpcServer(b)
        cli = qrpc.RpcClient([("127.0.0.1", sa.port),
                              ("127.0.0.1", sb.port)], hedge=False)
        try:
            for n in range(6):
                cli.lookup(n, budget_ms=5000)
            assert a.calls == b.calls == 3
        finally:
            cli.close()
            sa.close()
            sb.close()

    def test_hedge_first_answer_wins(self):
        slow = qrpc.RpcServer(FakeBackend(delay_s=0.8))
        fast = qrpc.RpcServer(FakeBackend())
        cli = qrpc.RpcClient(
            {"slow": ("127.0.0.1", slow.port),
             "fast": ("127.0.0.1", fast.port)},
            router=Router(["slow", "fast"], drained=["fast"]), retries=0,
            timeout_ms=5000, hedge=True, hedge_delay_ms=40.0, seed=1)
        try:
            t0 = time.perf_counter()
            row = cli.lookup(9, budget_ms=5000)
            took = time.perf_counter() - t0
            np.testing.assert_array_equal(row, fake_row(9))
            assert took < 0.7                  # the hedge answered
            s = cli.stats()
            assert s["hedges"] >= 1 and s["hedge_wins"] >= 1
        finally:
            cli.close()
            slow.close()
            fast.close()

    def test_all_attempts_failed_carries_causes(self):
        sick = qrpc.RpcServer(FakeBackend(fail=lambda: RuntimeError("boom")))
        cli = qrpc.RpcClient({"sick": ("127.0.0.1", sick.port)},
                             retries=1, hedge=False, backoff_ms=1.0)
        try:
            with pytest.raises(qrpc.AllAttemptsFailed) as ei:
                cli.lookup(1, budget_ms=5000)
            assert len(ei.value.causes) >= 2
            assert cli.stats()["errors"]["AllAttemptsFailed"] == 1
        finally:
            cli.close()
            sick.close()

    def test_non_retriable_error_is_raised_at_once(self):
        srv = qrpc.RpcServer(FakeBackend(
            fail=lambda: qt.DeadlineExceeded("late")))
        cli = qrpc.RpcClient({"r0": ("127.0.0.1", srv.port)}, retries=3,
                             hedge=False)
        try:
            with pytest.raises(qrpc.DeadlineExceeded):
                cli.lookup(1, budget_ms=5000)
            s = cli.stats()
            assert s["attempts"] == 1 and s["errors"] == {
                "DeadlineExceeded": 1}
        finally:
            cli.close()
            srv.close()

    def test_dead_replica_is_replica_unavailable_then_rerouted(self):
        well = qrpc.RpcServer(FakeBackend())
        cli = qrpc.RpcClient(
            {"dead": ("127.0.0.1", free_port()),
             "well": ("127.0.0.1", well.port)},
            router=Router(["dead", "well"]), retries=2, hedge=False,
            backoff_ms=2.0)
        try:
            np.testing.assert_array_equal(cli.lookup(4, budget_ms=5000),
                                          fake_row(4))
            assert cli.ping("well")["pong"]
            with pytest.raises(qrpc.ReplicaUnavailable):
                cli.ping("dead")
        finally:
            cli.close()
            well.close()
        with pytest.raises(qrpc.ServerClosed):
            cli.lookup_future(1)


# ---------------------------------------------------------------------------
# over the port's MicroBatchServer, and across the two packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_world():
    rng = np.random.default_rng(7)
    deg = rng.integers(1, 4, N)
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, N, int(indptr[-1]), dtype=np.int32)
    feat = rng.standard_normal((N, DIM)).astype(np.float32)
    model = FlaxSAGE(hidden_dim=8, out_dim=CLASSES, num_layers=2,
                     dropout=0.0)
    ij = jnp.asarray(indptr.astype(np.int32))
    xj = jnp.asarray(indices)
    n_id, layers = jsample_multihop(ij, xj, jnp.arange(4, dtype=jnp.int32),
                                    FULL, jax.random.key(0))
    state = init_state(model, optax.adam(1e-3),
                       masked_feature_gather(jnp.asarray(feat), n_id),
                       layers_to_adjs(layers, 4, FULL), jax.random.key(1))
    return dict(model=model, params=state.params, ij=ij, xj=xj,
                indptr=indptr, indices=indices, feat=feat)


@pytest.fixture(scope="module")
def engines(serve_world):
    """The JAX engine and the port's CPU engine over one world."""
    w = serve_world
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = qv.ServeEngine(w["model"], w["params"], (w["ij"], w["xj"]),
                              w["feat"], sizes_variants=[FULL],
                              batch_cap=CAP).warmup()
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, w["params"]))
    peng = qt.ServeEngine(qt.GraphSAGE(DIM, 8, CLASSES, 2, dropout=0.0), sd,
                          (w["indptr"], w["indices"]), w["feat"], [FULL],
                          CAP, device="cpu").warmup()
    # max degree < fanout: each node's row does not depend on the draws
    reference = {v: np.asarray(jeng.run(np.array([v], np.int32)))[0]
                 for v in range(16)}
    return jeng, peng, reference


class TestRpcOverRealEngine:
    def test_rows_match_the_reference(self, engines):
        _, peng, reference = engines
        srv = qt.MicroBatchServer(peng, qt.ServeConfig(max_wait_ms=1.0))
        front = qrpc.RpcServer(srv)
        cli = qrpc.RpcClient({"r0": ("127.0.0.1", front.port)},
                             retries=1, hedge=False)
        try:
            for v in range(16):
                np.testing.assert_allclose(cli.lookup(v, budget_ms=30_000),
                                           reference[v], rtol=1e-5,
                                           atol=1e-6)
            assert cli.ping("r0")["health"] == 1.0
        finally:
            cli.close()
            front.close()
            srv.close()

    def test_coalescer_sheds_expired_before_batching(self, engines):
        _, peng, _ = engines
        srv = qt.MicroBatchServer(peng, qt.ServeConfig(max_wait_ms=1.0),
                                  start=False)
        dead = srv.submit(1, deadline=time.perf_counter() - 0.01)
        live = srv.submit(2)
        srv.start()
        with pytest.raises(qt.DeadlineExceeded):
            dead.result(timeout=10)
        assert live.result(timeout=30).shape == (CLASSES,)
        assert srv.snapshot()["serving"]["deadline_expired"] == 1
        srv.close()

    def test_trace_context_continues_into_replica_spans(self, engines):
        _, peng, _ = engines
        srv = qt.MicroBatchServer(peng, qt.ServeConfig(max_wait_ms=1.0))
        front = qrpc.RpcServer(srv)
        cli = qrpc.RpcClient({"r0": ("127.0.0.1", front.port)},
                             retries=1, hedge=False)
        tracing.clear()
        tracing.enable()
        try:
            ctx = tracing.inject({})
            cli.lookup(3, budget_ms=30_000, context=ctx)
            tid = ctx[tracing.CTX_TRACE_ID]
            want = {"serve.request", "serve.admission_wait",
                    "serve.coalesce_wait", "rpc.lookup", "rpc.attempt"}
            # the executor files serve.request after it resolves the
            # future the reply carried
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not want <= {
                    r[0] for r in tracing.records() if r[4] == tid}:
                time.sleep(0.01)
            assert want <= {r[0] for r in tracing.records() if r[4] == tid}
        finally:
            tracing.disable()
            tracing.clear()
            cli.close()
            front.close()
            srv.close()

    def test_tenant_rides_the_wire(self, engines):
        _, peng, _ = engines
        srv = qt.MicroBatchServer(peng, qt.ServeConfig(max_wait_ms=1.0),
                                  tenants=qt.default_tenant_classes())
        front = qrpc.RpcServer(srv)
        cli = qrpc.RpcClient({"r0": ("127.0.0.1", front.port)},
                             hedge=False)
        try:
            cli.lookup(3, budget_ms=30_000, tenant="interactive")
            snaps = {t["tenant"]: t for t in srv.tenant_snapshots()}
            assert snaps["interactive"]["completed"] == 1
        finally:
            cli.close()
            front.close()
            srv.close()


def _wire_outcomes(cli, port, closed_port):
    """What a client sees from one replica: rows for 8 nodes and the
    error names of a spent budget, a bad op and a closed server."""
    rows = [cli.lookup(v, budget_ms=30_000) for v in range(8)]
    errs = [sync_call(port, {"op": "lookup", "id": 1, "node": 3,
                             "budget_ms": -1.0})["error"],
            sync_call(port, {"op": "nope", "id": 2})["error"],
            sync_call(closed_port, {"op": "lookup", "id": 3,
                                    "node": 1})["error"]]
    return rows, errs


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_cross_package_round_trip(engines, client_pkg, server_pkg):
    jeng, peng, reference = engines
    pkg, eng = (qt, peng) if server_pkg == "port" else (qv, jeng)
    srpc = qrpc if server_pkg == "port" else jrpc
    crpc = qrpc if client_pkg == "port" else jrpc
    srv = pkg.MicroBatchServer(eng, pkg.ServeConfig(max_wait_ms=1.0))
    gone = pkg.MicroBatchServer(eng, pkg.ServeConfig(), start=False)
    gone.close()
    front, dead = srpc.RpcServer(srv), srpc.RpcServer(gone)
    cli = crpc.RpcClient({"r0": ("127.0.0.1", front.port)}, retries=0,
                         hedge=False)
    lone = crpc.RpcClient({"d": ("127.0.0.1", dead.port)}, retries=0,
                          hedge=False)
    try:
        rows, errs = _wire_outcomes(cli, front.port, dead.port)
        for v, row in enumerate(rows):
            np.testing.assert_allclose(row, reference[v], rtol=1e-5,
                                       atol=1e-5)
        assert errs == ["DeadlineExceeded", "ServerError", "ServerClosed"]
        # the client maps the wire name to its own typed error (retried
        # elsewhere, so it comes back as the one attempt's cause)
        with pytest.raises(crpc.AllAttemptsFailed) as ei:
            lone.lookup(1, budget_ms=5000)
        assert [type(c) for c in ei.value.causes] == [crpc.ServerClosed]
    finally:
        lone.close()
        cli.close()
        front.close()
        dead.close()
        srv.close()
