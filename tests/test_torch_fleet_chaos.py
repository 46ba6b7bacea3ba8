"""The fleet's chaos gates against the port (``quiver_tpu_torch/rpc.py``
and ``fleet.py``), ported from ``tests/test_rpc.py``'s
``TestChaosKillFleet``, ``TestScaleDownZeroLoss`` and
``TestPartitionOwnerKill``. The replicas serve a fixed row per node and
write a heartbeat sink: in the kill tests standard-library processes (no
torch: each loads the port's ``rpc.py`` through a synthetic package, as
the JAX tests load theirs), in the scale-down test the port's
``MicroBatchServer`` over an engine that serves those rows; a seeded ``FaultPlan`` kills ``r0`` after its
35th request. Zero requests are lost across the kill, the retirement of
a replica, and the kill of a partition's owner; the supervisor restarts
the victim and the router drains and re-admits it. Each test runs under
a time limit (``SIGALRM``)."""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import quiver_tpu_torch as qv
from quiver_tpu_torch import fleet as qf
from quiver_tpu_torch import metrics as qm
from quiver_tpu_torch import rpc as qrpc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KILL_AFTER = 35
LIMIT_S = 60

_REPLICA = r"""
import importlib, json, os, sys, time, types
import concurrent.futures as cf
import numpy as np

root, name, port_s, sink_path, mode = sys.argv[1:6]
if mode == "server":
    # the port's MicroBatchServer over an engine that serves each node's
    # fixed row (imports torch)
    sys.path.insert(0, root)
    from quiver_tpu_torch import MicroBatchServer, ServeConfig, rpc

    class Engine:
        batch_cap, variants = 64, [[1]]
        collect_metrics, jitted_fns = False, ()

        def run(self, seeds, variant=0):
            s = np.asarray(seeds, np.float32)
            return np.stack([s, s * 0.5, np.mod(s, 7)], 1)

    backend = MicroBatchServer(Engine(), ServeConfig(max_wait_ms=1.0))
else:
    pkg = types.ModuleType("_qt_port")
    pkg.__path__ = [os.path.join(root, "quiver_tpu_torch")]
    sys.modules["_qt_port"] = pkg
    rpc = importlib.import_module("_qt_port.rpc")

    class Backend:
        def submit(self, node, context=None, deadline=None):
            fut = cf.Future()
            fut.set_result(np.array([node, node * 0.5, node % 7],
                                    np.float32))
            return fut

        def health(self):
            return {"score": 1.0}

    backend = Backend()


srv = rpc.RpcServer(backend, port=int(port_s))
with open(sink_path, "a", buffering=1) as f:
    f.write(json.dumps({"ts": time.time(), "kind": "meta", "host": "fake",
                        "pid": os.getpid(), "start_ts": time.time(),
                        "replica": name}) + "\n")
    beats = 0
    while True:
        beats += 1
        f.write(json.dumps({"ts": time.time(), "kind": "step_stats",
                            "counters": {"hot_rows": beats}}) + "\n")
        time.sleep(0.05)
"""


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {LIMIT_S} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def fake_row(node):
    return np.array([node, node * 0.5, node % 7], np.float32)


def free_ports(k):
    socks = [socket.socket() for _ in range(k)]
    try:
        for s in socks:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def spawner(ports, sinks, plan=None, mode="stdlib"):
    def spawn(name, index, attempt):
        env = {k: v for k, v in os.environ.items()
               if k not in ("QT_FAULTS", "QT_FAULTS_SEED")}
        if plan is not None and name == "r0" and attempt == 0:
            # the kill arms only the victim's first life
            env.update(plan.env())
        return subprocess.Popen(
            [sys.executable, "-c", _REPLICA, REPO, name, str(ports[name]),
             sinks[name], mode], env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
    return spawn


def client(ports, router):
    return qrpc.RpcClient({n: ("127.0.0.1", p) for n, p in ports.items()},
                          router=router, timeout_ms=400.0, retries=3,
                          backoff_ms=20.0, backoff_cap_ms=150.0, hedge=True,
                          hedge_delay_ms=60.0, seed=5)


def wait_up(cli, names):
    deadline = time.monotonic() + 20.0
    up = set()
    while time.monotonic() < deadline and len(up) < len(names):
        for n in names:
            if n not in up:
                try:
                    if cli.ping(n, timeout_ms=300)["ok"]:
                        up.add(n)
                except Exception:
                    pass
        time.sleep(0.05)
    assert up == set(names), f"fleet never came up: {up}"


def load(cli, count, gap_s, nodes, lat=None, at=None):
    futs = []
    t0 = time.perf_counter()
    for k in range(count):
        delay = t0 + k * gap_s - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if at is not None and k in at:
            at[k]()
        fut = cli.lookup_future(k % nodes, budget_ms=8000.0)
        if lat is not None:
            t_sub = time.perf_counter()
            fut.add_done_callback(lambda f, i=k, t=t_sub: lat.setdefault(
                i, time.perf_counter() - t))
        futs.append((k, fut))
    failed = []
    for k, fut in futs:
        try:
            np.testing.assert_array_equal(fut.result(timeout=30),
                                          fake_row(k % nodes))
        except qrpc.RpcError as e:
            failed.append((k, type(e).__name__))
    return failed


def wait_for(cond, seconds=15.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline and not cond():
        time.sleep(0.1)
    return cond()


def kill_plan():
    return qv.FaultPlan(seed=7, rules={
        "rpc.request": qv.FaultRule("kill", after=KILL_AFTER)})


def test_seeded_kill_detect_reroute_restart(tmp_path):
    names = ["r0", "r1", "r2"]
    ports = dict(zip(names, free_ports(3)))
    sinks = {n: str(tmp_path / f"{n}.jsonl") for n in names}
    ev_path = str(tmp_path / "events.jsonl")
    ev_sink = qm.MetricsSink(ev_path)
    # the staleness horizon sits below the restart backoff: detect ->
    # drain -> restart -> re-admit are each observable in one run
    sup = qf.ReplicaSupervisor(
        spawner(ports, sinks, kill_plan()), 3, names=names, backoff_s=1.2,
        backoff_cap_s=2.4, monitor_interval_s=0.05, healthy_uptime_s=5.0,
        sink=ev_sink).start()
    agg = qf.FleetAggregator(sinks, interval_s=0.2, stale_after_s=0.4,
                             sink=ev_sink)
    router = qf.HealthRouter(names, seed=3)
    agg.on_poll.append(router.sync)
    cli = client(ports, router)
    lat = {}
    try:
        wait_up(cli, names)
        agg.start()
        failed = load(cli, 240, 0.018, 50, lat=lat)
        assert not failed, f"requests lost to the kill: {failed}"
        assert wait_for(lambda: sup.status()["r0"]["alive"]
                        and sup.status()["r0"]["restarts"] >= 1)
        st = sup.status()
        assert not st["r0"]["breaker_open"]
        assert st["r1"]["restarts"] == 0 and st["r2"]["restarts"] == 0

        def serves():
            try:
                return cli.ping("r0", timeout_ms=300)["ok"]
            except Exception:
                return False
        assert wait_for(serves), "restarted replica never served"
        assert wait_for(lambda: "r0" not in router.snapshot()["drained"])
        assert router.snapshot()["drains"] >= 1
    finally:
        cli.close()
        agg.close()
        sup.close()
        ev_sink.close()
    events = qm.read_jsonl(ev_path)
    exits = [r for r in events if r.get("kind") == "chaos"
             and r.get("event") == "exit" and r.get("replica") == "r0"]
    assert exits
    stales = [r for r in events if r.get("kind") == "anomaly"
              and r.get("detector") == "staleness"
              and r.get("replica") == "r0" and r["ts"] >= exits[0]["ts"]]
    assert stales, "the aggregator never flagged the dead replica"
    assert 0.0 <= stales[0]["ts"] - exits[0]["ts"] <= 0.4 + 0.2 + 2.0
    assert [r for r in events if r.get("kind") == "chaos"
            and r.get("event") == "restart" and r.get("replica") == "r0"]
    lats = sorted(lat.values())
    assert lats[min(int(0.99 * len(lats)), len(lats) - 1)] < 2.0


def test_mid_load_retirement_resolves_every_request(tmp_path):
    names = ["r0", "r1", "r2"]
    ports = dict(zip(names, free_ports(3)))
    sinks = {n: str(tmp_path / f"{n}.jsonl") for n in names}
    ev_path = str(tmp_path / "events.jsonl")
    ev_sink = qm.MetricsSink(ev_path)
    sup = qf.ReplicaSupervisor(spawner(ports, sinks, mode="server"), 3,
                               names=names, monitor_interval_s=0.05,
                               grace_s=1.0, sink=ev_sink).start()
    router = qf.HealthRouter(names, seed=3)
    cli = client(ports, router)
    retired = []

    def retire():
        retired.extend(sup.shrink(names=["r2"], drain=router.drain,
                                  drain_wait_s=0.3))
        router.forget("r2")

    shrinker = threading.Thread(target=retire, daemon=True)
    try:
        wait_up(cli, names)
        failed = load(cli, 160, 0.015, 50, at={50: shrinker.start})
        shrinker.join(timeout=30)
        assert not shrinker.is_alive()
        assert not failed, f"requests lost to scale-down: {failed}"
        assert retired == ["r2"] and sup.replica_count == 2
        time.sleep(0.3)
        st = sup.status()
        assert set(st) == {"r0", "r1"} and all(v["alive"]
                                               for v in st.values())
        assert "r2" not in router.snapshot()["scores"]
    finally:
        cli.close()
        sup.close()
        ev_sink.close()
    events = qm.read_jsonl(ev_path)
    downs = [r for r in events if r.get("kind") == "chaos"
             and r.get("event") == "scale_down"]
    assert len(downs) == 1 and downs[0]["replicas"] == ["r2"]
    assert downs[0]["drained"] and downs[0]["count"] == 2
    assert not [r for r in events if r.get("kind") == "chaos"
                and r.get("replica") == "r2"
                and r.get("event") in ("exit", "restart")]


def test_owner_kill_zero_lost_then_locality_resumes(tmp_path):
    names = ["r0", "r1", "r2"]
    ports = dict(zip(names, free_ports(3)))
    sinks = {n: str(tmp_path / f"{n}.jsonl") for n in names}
    ev_sink = qm.MetricsSink(str(tmp_path / "events.jsonl"))
    sup = qf.ReplicaSupervisor(
        spawner(ports, sinks, kill_plan()), 3, names=names, backoff_s=1.2,
        backoff_cap_s=2.4, monitor_interval_s=0.05, healthy_uptime_s=5.0,
        sink=ev_sink).start()
    agg = qf.FleetAggregator(sinks, interval_s=0.2, stale_after_s=0.4,
                             sink=ev_sink)
    router = qf.HealthRouter(names, seed=3)
    # replica rI owns partition I; node v's mass lives in partition v % 3
    nodes = 50
    table = np.full((nodes, 3), 0.05, np.float32)
    table[np.arange(nodes), np.arange(nodes) % 3] = 0.9
    router.set_locality(table, {"r0": 0, "r1": 1, "r2": 2}, weight=0.8)
    agg.on_poll.append(router.sync)
    cli = client(ports, router)
    try:
        wait_up(cli, names)
        agg.start()
        failed = load(cli, 240, 0.018, nodes)
        assert not failed, f"requests lost to the owner kill: {failed}"
        assert wait_for(lambda: sup.status()["r0"]["alive"]
                        and sup.status()["r0"]["restarts"] >= 1)
        st = sup.status()
        assert st["r1"]["restarts"] == 0 and st["r2"]["restarts"] == 0
        assert wait_for(lambda: "r0" not in router.snapshot()["drained"])
        rsnap = router.snapshot()
        assert rsnap["drains"] >= 1
        assert rsnap["locality"]["owners"]["r0"] == 0
        assert wait_for(lambda: router.ranked(seed=0)[0] == "r0")
        assert router.ranked(seed=1)[0] == "r1"
    finally:
        cli.close()
        agg.close()
        sup.close()
        ev_sink.close()
