"""The port's leak check (``quiver_tpu_torch/check_leak.py``) on the CPU.

Each of the 16 phases runs at the JAX check's sizes with its cycle
counts cut (``make_world("cpu", quick=True)``: 50,000 nodes, 64-wide
features, [10, 5] at batch 512) and must find no growth. Then a leak is
planted in the port for each kind the module claims to catch, and the
phase named must fail: a tensor kept every cycle (phase 1), a kernel
library loaded mid-loop and a launch count that grows (phase 2), a
staging-ring buffer reallocated and a stager thread left alive (phase
8), a span ring that grows (phase 7). Two checks hold the module's
inputs to the JAX package's on the same numpy data: phase 3's int8
lookup rows, bit for bit against JAX's lookup over tiers decoded with
two roundings (and within one rounding of JAX's own), and phase 16's
hand-fold of a ``flash_crowd`` trace's per-tenant arrivals, exactly.
The counts asserted are counts and objects, never wall-clock times."""

import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quiver_tpu as qv
from quiver_tpu import traffic as jtraffic
from quiver_tpu.ops import quant as jquant
from quiver_tpu_torch import Feature, check_leak
from quiver_tpu_torch.ops import quant
from quiver_tpu_torch.ops.kernels import _build
from quiver_tpu_torch.prefetch import ColdPrefetcher, StagingRing
from quiver_tpu_torch.tracing import Tracer

ROOT = Path(__file__).resolve().parents[1]
# half an ulp of a product below 8 in magnitude (|code * scale| stays
# under the largest |feature| of a standard-normal table), with room
ONE_ROUNDING = 2.0 ** -20


@pytest.fixture(scope="module")
def world():
    w = check_leak.make_world("cpu", quick=True)
    yield w
    w.close()


def _run(world, number):
    lines = []
    recs = check_leak.run(world, [number], log=lines.append)
    assert len(recs) == 1 and len(lines) == 1
    assert lines[0].startswith(f"leak phase {number} (")
    assert lines[0].endswith("on cpu") and "no leak" in lines[0]
    return recs[0]


@pytest.mark.parametrize("number", sorted(check_leak.PHASES))
def test_phase_finds_no_leak(world, number):
    rec = _run(world, number)
    readings = [rec] + rec.get("ranks", [])
    for r in readings:
        base, end = r["base"], r["end"]
        assert end["live"] <= base["live"] + r["live_bound"]
        assert r["live_bound"] <= check_leak.LIVE_SLACK
        assert end["bytes"] <= base["bytes"] + r["out_bytes"]
        assert end["libraries"] == base["libraries"]
        assert end["segments"] is None       # no allocator on the CPU
        assert end["large_segments"] is end["small_segments"] is None
        # no kernel launches on the CPU: every wrapper's plain version
        assert all(not c for c in r["launches_per_cycle"].values())
    if number in (4, 14):
        assert len(rec["ranks"]) == check_leak.RANKS
    if number == 14:
        half = world.cycles // 2
        assert [(r["narrow"], r["fallback"]) for r in rec["ranks"]] == \
            [(world.cycles - half, half)] * check_leak.RANKS
    if number == 8:
        assert rec["threads_left"] == [] and rec["filled"] == rec["ring"]
    if number == 16:
        assert rec["shed"] > 0


def test_cli_prints_a_line_a_phase_and_exits_0():
    out = subprocess.run(
        [sys.executable, "-m", "quiver_tpu_torch.check_leak", "--device",
         "cpu", "--quick", "--phase", "3", "13"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert [l.split(" (")[0] for l in lines[:-1]] == \
        ["leak phase 3", "leak phase 13"]
    assert lines[-1].startswith("check_leak: no leak in 2 phases")


def test_cli_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert check_leak.main(["--phase", "1"]) == 2


# -- planted leaks ------------------------------------------------------------


def test_a_tensor_kept_each_cycle_fails_phase_1(world, monkeypatch):
    kept = []
    prefetch = Feature.prefetch

    def keeping(self, node_idx):
        fut = prefetch(self, node_idx)
        kept.append(fut.result())
        return fut

    monkeypatch.setattr(Feature, "prefetch", keeping)
    with pytest.raises(check_leak.LeakError, match=r"phase 1 .*live"):
        check_leak.run(world, [1], log=lambda line: None)
    assert len(kept) > check_leak.LIVE_SLACK


# chip_smoke.py's steady loops: 16 cycles, and phase 15's 8 steps of them
SMOKE_CYCLES = 16


@pytest.mark.parametrize("cycles", [SMOKE_CYCLES, SMOKE_CYCLES // 2])
def test_a_4_byte_tensor_kept_each_cycle_fails_phase_1(world, monkeypatch,
                                                       cycles):
    """One 4-byte tensor kept per cycle, at the full-width run's cycle
    counts: the bytes stay within a cycle's output, so the live reading
    must catch it."""
    kept = []
    prefetch = Feature.prefetch

    def keeping(self, node_idx):
        kept.append(torch.zeros(1))
        return prefetch(self, node_idx)

    monkeypatch.setattr(world, "cycles", cycles)
    monkeypatch.setattr(Feature, "prefetch", keeping)
    with pytest.raises(check_leak.LeakError, match=r"phase 1 .*live"):
        check_leak.run(world, [1], log=lambda line: None)


def test_a_4_byte_tensor_kept_each_step_fails_phase_15(world, monkeypatch):
    """The same in phase 15, which runs half the loop's cycles: 8 steps
    at the full-width run's 16."""
    from quiver_tpu_torch.ops.kernels import fused
    kept = []
    walk = fused.fused_multihop

    def keeping(*args, **kwargs):
        kept.append(torch.zeros(1))
        return walk(*args, **kwargs)

    monkeypatch.setattr(world, "cycles", SMOKE_CYCLES)
    monkeypatch.setattr(fused, "fused_multihop", keeping)
    with pytest.raises(check_leak.LeakError, match=r"phase 15 .*live"):
        check_leak.run(world, [15], log=lambda line: None)


@pytest.mark.parametrize("part", [0, 1])
def test_a_placed_tier_with_other_bytes_fails(world, part):
    """``check_placed`` reads a store's hot tier back against the host's
    encoding of the same rows: one byte changed in the codes or the
    scales fails it."""
    store = check_leak.int8_store(world)
    try:
        t = quant.tier_parts(store.device_part)[part]
        flat = t.view(torch.uint8).reshape(-1)
        flat[flat.numel() // 2] ^= 1
        with pytest.raises(check_leak.LeakError, match="hot tier placed"):
            check_leak.check_placed(store, world.feat)
    finally:
        store.close()


def _on_call(monkeypatch, at, action):
    """Wrap ``Feature._lookup_tiered`` to run ``action(calls)`` from its
    ``at``-th call on (after the warm-up's calls)."""
    lookup = Feature._lookup_tiered
    calls = [0]

    def wrapped(self, *args, **kwargs):
        calls[0] += 1
        if calls[0] >= at:
            action(calls[0])
        return lookup(self, *args, **kwargs)

    monkeypatch.setattr(Feature, "_lookup_tiered", wrapped)
    return calls


def test_a_library_loaded_mid_loop_fails_phase_2(world, monkeypatch):
    _on_call(monkeypatch, 10, lambda n: monkeypatch.setitem(
        _build._loaded, "planted", object()))
    with pytest.raises(check_leak.LeakError,
                       match=r"phase 2 .*kernel libraries"):
        check_leak.run(world, [2], log=lambda line: None)


def test_a_growing_launch_count_fails_phase_2(world, monkeypatch):
    # fresh counters, so the planted launches stay out of other tests'
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    monkeypatch.setattr(_build, "KERNEL_TOTALS", dict(_build.KERNEL_TOTALS))

    def launch(n):
        for _ in range(n):
            _build.launched(0, "gather_rows", "planted_kernel")

    _on_call(monkeypatch, 1, launch)
    with pytest.raises(check_leak.LeakError,
                       match=r"phase 2 .*planted_kernel launched"):
        check_leak.run(world, [2], log=lambda line: None)


def test_a_reallocated_ring_buffer_fails_phase_8(world, monkeypatch):
    stage = StagingRing.stage
    calls = [0]

    def reallocating(self, *args, **kwargs):
        calls[0] += 1
        if calls[0] == 16:        # past the warm-up's (at most 10)
            with self._lock:
                self._slot_of = self._slot_of.copy()
        return stage(self, *args, **kwargs)

    monkeypatch.setattr(StagingRing, "stage", reallocating)
    with pytest.raises(check_leak.LeakError,
                       match="the staging ring reallocated a buffer"):
        check_leak.run(world, [8], log=lambda line: None)
    assert calls[0] >= 16


def test_a_stager_left_alive_fails_phase_8(world, monkeypatch):
    close = ColdPrefetcher.close
    left = []

    def leaving(self, wait=True):
        pool, self._stagers = self._stagers, None
        if pool is not None:
            self._stagers_finalizer.detach()
            left.append(pool)
        close(self, wait)

    monkeypatch.setattr(ColdPrefetcher, "close", leaving)
    try:
        with pytest.raises(check_leak.LeakError,
                           match="close.. left staging threads alive"):
            check_leak.run(world, [8], log=lambda line: None)
    finally:
        for pool in left:
            pool.shutdown(wait=True)
    assert left
    assert not [t for t in threading.enumerate()
                if t.name.startswith("qt-stager")]


def test_a_growing_span_ring_fails_phase_7(world, monkeypatch):
    def growing(self, name, t0, dur, trace_id=None, args=None):
        if self._enabled:
            self._ring.append((name, threading.get_ident(), t0, dur,
                               trace_id, args))

    monkeypatch.setattr(Tracer, "record", growing)
    with pytest.raises(check_leak.LeakError, match="the span ring holds"):
        check_leak.run(world, [7], log=lambda line: None)


# -- against the JAX package --------------------------------------------------


def _decoded(tier):
    """A JAX tier as fp32 rows: an int8 tier decoded by numpy with a
    rounded multiply, then a rounded add (the port's rounding)."""
    if jquant.is_quantized(tier):
        return np.asarray(tier.data).astype(np.float32) \
            * np.asarray(tier.scale) + np.asarray(tier.zero)
    return np.asarray(tier).astype(np.float32)


def _jax_lookup(j, ids):
    host = jquant.tree_map_tier(jnp.asarray, j.host_part)
    return np.asarray(j._lookup_tiered(j.device_part, host, jnp.asarray(ids),
                                       j.feature_order))


def test_phase_3_int8_rows_equal_the_jax_lookup(world):
    """Phase 3's store and batches, through the lookup phase 3 runs,
    against JAX's store over the same table: bit for bit against JAX's
    lookup over its tiers decoded with two roundings, and within one
    rounding of JAX's own int8 lookup (XLA fuses its decode)."""
    t = check_leak.int8_store(world, dedup_cold=True,
                              cold_budget=world.cold_budget,
                              host_placement="offload")
    indptr = world.indptr.numpy().astype(np.int64)
    indices = world.indices.numpy()
    feat = world.feat.numpy()
    n, dim = feat.shape
    j = qv.Feature(device_cache_size=n // 4 * (dim + 8),
                   csr_topo=qv.CSRTopo(indptr=indptr, indices=indices),
                   dedup_cold=True, cold_budget=world.cold_budget,
                   dtype_policy="int8")
    j.from_cpu_tensor(feat)
    assert t.cache_rows == j.cache_rows
    assert np.array_equal(t.feature_order.numpy(),
                          np.asarray(j.feature_order))
    jx = qv.Feature(device_cache_size=j.cache_rows * dim * 4,
                    cold_budget=j.cold_budget, dedup_cold=j.dedup_cold)
    jx.from_cpu_tensor(np.concatenate([_decoded(j.device_part),
                                       _decoded(j.host_part)]))
    assert jx.cache_rows == j.cache_rows
    jx.feature_order = j.feature_order
    rng = np.random.default_rng(3)
    for ids in check_leak.dup_batches(rng, n, 3, world.lookup, "cpu"):
        got = t._lookup_tiered(t.device_part, t._host_offload, ids,
                               t.feature_order).numpy()
        want = _jax_lookup(jx, ids.numpy())
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
        np.testing.assert_allclose(got, _jax_lookup(j, ids.numpy()), rtol=0,
                                   atol=ONE_ROUNDING)
    t.close()


def test_phase_16_hand_fold_equals_the_jax_package(world):
    """The per-tenant arrivals phase 16 folds from the port's trace equal
    the JAX package's hand-fold of its own trace, exactly."""
    kw = dict(seed=17, flash_tenant="best_effort", flash_x=10.0)
    from quiver_tpu_torch import traffic
    got = check_leak.fold_tenants(traffic.generate_scenario(
        "flash_crowd", 40.0, 25.0, world.n, **kw))
    trace = jtraffic.generate_scenario("flash_crowd", 40.0, 25.0, world.n,
                                       **kw)
    want = {name: 0 for name in trace["tenants"]}
    for i in np.asarray(trace["tenant"]).tolist():
        want[trace["tenants"][i]] += 1
    assert got == want
    assert sum(got.values()) == len(trace["tenant"]) > 1000

