"""The port's cost model (``quiver_tpu_torch/analysis/costmodel.py``),
machine probe and stage profiler (``quiver_tpu_torch/profile.py``)
against the JAX package's (``tests/test_profile.py``).

The cost model prices one recorded run: FLOPs equal JAX's ``cost_of``
on the serve step (every ladder variant) and on the train step at the
registry's fixture; on the fused walk JAX prices its kernel's 128-seed
grid block and the port its real seeds, so JAX's FLOPs are the port's
times the block's padding; the tiered lookup's host-tier bytes equal
JAX's ``tier_read_bytes``. The byte formulas moved out of
``chip_smoke.py`` give the numbers they gave there on a fixed input.
The profiler's records, shares, sink, in-place state, second pass and
the injected slowdown (a stage's share shifts and the hub raises an
anomaly) follow JAX's tests; the CLI prints and writes its records.
JAX is imported only inside the tests that compare against it."""

import json
import math

import numpy as np
import pytest
import torch

from quiver_tpu_torch.analysis import registry
from quiver_tpu_torch.analysis.costmodel import (CostModel, cost_of,
                                                 cost_of_fn,
                                                 gather_rows_bytes,
                                                 hot_hop_cost,
                                                 sample_hop_bytes,
                                                 served_batch_bytes)
from quiver_tpu_torch.ops.kernels import _build
from quiver_tpu_torch.profile import (PROFILE_SERIES, ProfileGroup,
                                      ProfileStage, StageProfiler,
                                      machine_probe, render_records)

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


class TestCostModel:
    def test_matmul_flops(self):
        # [4,8] @ [8,3]: 2 * out(4*3) * K(8) = 192
        c = cost_of_fn(lambda a, b: a @ b, (torch.ones(4, 8), torch.ones(8, 3)))
        assert c.flops == 192

    def test_gather_bytes_and_index_bytes(self):
        c = cost_of_fn(lambda t, i: t[i], (torch.ones(100, 16),
                                            torch.arange(10)))
        assert c.gather_bytes == 640
        assert c.gather_index_bytes == 80          # int64 ids
        assert c.input_bytes == 0
        assert c.output_bytes == 640

    def test_index_buffer_feeding_two_gathers_counts_once(self):
        def f(t1, t2, i):
            return t1[i], t2[i]
        c = cost_of_fn(f, (torch.ones(50, 8), torch.ones(50, 4),
                           torch.arange(10, dtype=torch.int32)))
        assert c.gather_index_bytes == 40
        assert c.gather_bytes == 10 * 8 * 4 + 10 * 4 * 4

    def test_loop_multiplies(self):
        def f(x, w):
            for _ in range(7):
                x = x @ w
            return x
        c = cost_of_fn(f, (torch.ones(4, 4), torch.ones(4, 4)))
        assert c.flops == 7 * 2 * 4 * 4 * 4

    def test_gated_branch_prices_outside_the_floor(self):
        # a read inside a predicated branch (JAX's lax.cond fallback):
        # neither its rows nor its index enter the floor
        def f(t, i):
            with _build.gated():
                return t[i].sum()
        c = cost_of_fn(f, (torch.ones(100, 16),
                           torch.arange(10, dtype=torch.int32)))
        assert c.gather_bytes == 0 and c.gather_index_bytes == 0
        assert c.cond_extra_bytes >= 640 + 40

    def test_backward_products_count(self):
        w = torch.ones(8, 3, requires_grad=True)

        def f(x):
            (x @ w).sum().backward()
        c = cost_of_fn(f, (torch.ones(4, 8),))
        # forward 2*4*3*8, the weight's gradient 2*8*3*4
        assert c.flops == 2 * 4 * 3 * 8 * 2

    def test_registry_entry_prices_with_tiers(self):
        spec = registry.build_entry("lookup_tiered", CPU)
        c = cost_of(spec)
        assert isinstance(c, CostModel)
        assert c.gather_bytes > 0 and c.gather_index_bytes > 0
        assert c.tier_bytes and c.cond_extra_bytes > 0
        assert c.total_bytes >= c.gather_bytes
        rec = c.record()
        assert rec["total_bytes"] == c.total_bytes and "tier_bytes" in rec

    def test_kernel_call_priced_by_its_formula(self):
        # a fused hop alone: every argument is the kernel's and every
        # output its own, so its modeled total is hot_hop_cost's bytes
        spec = registry.build_entry("fused_hot_hop", CPU)
        c = cost_of(spec)
        nbrs, counts = spec.recording().out[:2]
        fx = registry._fixture(CPU)
        feat = spec.tier_budgets[0][0]
        want = hot_hop_cost(fx.seeds, 4, counts, nbrs, feat, None,
                            fx.n)
        assert (c.total_bytes, c.flops) == want
        assert c.gather_index_bytes == 0


@pytest.fixture(scope="module")
def jax_registry():
    from quiver_tpu.analysis import registry as jreg
    from quiver_tpu.analysis.costmodel import cost_of as jcost
    return jreg, jcost


class TestAgainstJax:
    @pytest.mark.parametrize("variant", [0, 1, 2])
    def test_serve_step_flops_equal(self, jax_registry, variant):
        jreg, jcost = jax_registry
        want = jcost(jreg.build_entry_specs("serve_step")[variant]).flops
        got = cost_of(registry.build_entry_specs("serve_step",
                                                 CPU)[variant]).flops
        assert got == want > 0

    def test_train_step_flops_equal(self, jax_registry):
        jreg, jcost = jax_registry
        want = jcost(jreg.build_entry("train_step")).flops
        got = cost_of(registry.build_entry("train_step", CPU)).flops
        assert got == want > 0

    def test_fused_multihop_flops_equal_but_for_the_block(self,
                                                          jax_registry):
        # JAX's kernel prices its 128-seed grid block (32 leaf seeds
        # padded to 128); the port's kernel runs the 32 seeds alone
        jreg, jcost = jax_registry
        want = jcost(jreg.build_entry("fused_multihop")).flops
        got = cost_of(registry.build_entry("fused_multihop", CPU)).flops
        seeds = 8 * (1 + 3)
        padded = 128 * math.ceil(seeds / 128)
        assert want == got * padded // seeds and got > 0

    def test_lookup_tier_bytes_equal_tier_read_bytes(self, jax_registry):
        jreg, _ = jax_registry
        from quiver_tpu.analysis.jaxpr_lint import tier_read_bytes
        spec = jreg.build_entry("lookup_tiered")
        want = tier_read_bytes(spec.fn, spec.args, spec.tier_budgets[0][0])
        got = cost_of(registry.build_entry("lookup_tiered", CPU)).tier_bytes
        assert list(got.values()) == [want] == [64 * 16 * 4]


def _fixed_input():
    """The fixed CPU input the moved formulas are pinned on."""
    from quiver_tpu_torch.ops import quant
    from quiver_tpu_torch.ops.kernels import fused
    rng = np.random.default_rng(5)
    n = 2000
    deg = rng.integers(0, 40, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    feat = rng.standard_normal((n, 100)).astype(np.float32)
    seeds = torch.arange(0, 640, 5, dtype=torch.int32)
    seeds[7::11] = -1
    nbrs, counts = fused.fused_sample_hop(
        torch.as_tensor(indptr.astype(np.int32)), torch.as_tensor(indices),
        seeds, 6, 1234, 32)
    f32 = torch.as_tensor(feat)
    return dict(n=n, indptr=indptr, indices=indices, feat=feat, seeds=seeds,
                nbrs=nbrs, counts=counts, f32=f32,
                fq=quant.quantize(f32, "int8"),
                forder=torch.as_tensor(np.random.default_rng(6).permutation(
                    n).astype(np.int32)))


class TestMovedFormulas:
    """The numbers ``chip_smoke.py``'s own formulas gave before they
    moved here, on one fixed input."""

    def test_sample_and_hot_hop(self):
        d = _fixed_input()
        assert sample_hop_bytes(d["seeds"], 6, d["counts"]) == 7688
        assert hot_hop_cost(d["seeds"], 6, d["counts"], d["nbrs"], d["fq"],
                            d["forder"], 1500) == (422416, 179200)
        assert hot_hop_cost(d["seeds"], 6, d["counts"], d["nbrs"], d["f32"],
                            None, d["n"]) == (631288, 0)

    def test_gather_rows_bytes(self):
        from quiver_tpu_torch.ops import quant
        d = _fixed_input()
        ids = torch.cat([d["nbrs"].reshape(-1), d["seeds"]]).contiguous()
        assert gather_rows_bytes(quant.pack(d["fq"]), ids) == \
            (71604, 315984, 663)
        assert gather_rows_bytes(d["f32"], ids) == (265200, 315984, 663)

    def test_served_batch_bytes(self):
        from quiver_tpu_torch import (CSRTopo, Feature, GraphSAGE,
                                      ServeEngine)
        d = _fixed_input()
        topo = CSRTopo(indptr=d["indptr"], indices=d["indices"],
                       device="cpu")
        store = Feature(device_cache_size=500 * 104, csr_topo=topo,
                        dtype_policy="int8", host_placement="offload",
                        device="cpu").from_cpu_tensor(d["feat"])
        torch.manual_seed(0)
        eng = ServeEngine(GraphSAGE(100, 16, 4, 3), None, topo, store,
                          [[15, 10, 5]], 64, fused_hot_hop=True,
                          device="cpu")
        assert served_batch_bytes(eng, list(range(0, 640, 10)), [3, 4, 5],
                                  [15, 10, 5], 2048) == 27703692

    def test_chip_smoke_reads_these(self):
        import chip_smoke
        assert chip_smoke.sample_hop_bytes is sample_hop_bytes
        assert chip_smoke.hot_hop_cost is hot_hop_cost
        assert chip_smoke.served_batch_bytes is served_batch_bytes
        d = _fixed_input()
        ids = torch.cat([d["nbrs"].reshape(-1), d["seeds"]]).contiguous()
        ms, by, hb, db, distinct = chip_smoke.host_gather_bound(
            d["f32"], ids, 2.5e10)
        assert (by, hb, db, distinct) == ("bytes (host)", 265200, 315984,
                                          663)
        assert ms == pytest.approx(265200 / 2.5e10 * 1e3)


# ---------------------------------------------------------------------------
# the machine probe
# ---------------------------------------------------------------------------


class TestMachineProbe:
    def test_quick_probe_shape(self):
        p = machine_probe(quick=True, size_mb=2, device="cpu")
        for k in ("memcpy_gbps", "gather_gbps", "h2d_gbps", "d2h_gbps"):
            assert p[k] > 0, k
        assert p["platform"] == "cpu" and p["device"] == "cpu"
        assert p["size_mb"] == 2

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            machine_probe(quick=True, size_mb=1)


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------


def _matmul_stage(name, scale, dim=48):
    """A stage whose work scales with ``scale`` (a loop of matmuls):
    the injected-slowdown knob."""
    w = torch.eye(dim)

    def fn(x):
        for _ in range(scale):
            x = x @ w
        return x
    args = (torch.ones(dim, dim),)
    return ProfileStage(name, fn, args, cost=cost_of_fn(fn, args))


def _group(scale_a=2, scale_b=2):
    return ProfileGroup("prof_test", [_matmul_stage("A", scale_a),
                                      _matmul_stage("B", scale_b)])


class TestStageProfiler:
    def test_record_shape_and_shares(self):
        prof = StageProfiler(reps=2, probe=machine_probe(
            quick=True, size_mb=2, device="cpu"))
        prof.add_group(_group())
        recs = prof.run()
        assert [r["entry"] for r in recs] == ["__machine__", "prof_test"]
        assert recs[1]["device"] == "cpu"
        stages = recs[1]["stages"]
        assert [s["stage"] for s in stages] == ["A", "B"]
        for s in stages:
            assert s["mean_ms"] > 0 and s["best_ms"] <= s["mean_ms"]
            assert s["modeled"]["flops"] > 0
            assert s["achieved_gbps"] > 0
            assert 0 <= s["efficiency"]
        assert sum(s["share"] for s in stages) == pytest.approx(1.0,
                                                                abs=0.01)
        text = render_records(recs)
        assert "machine probe" in text and "prof_test" in text

    def test_sink_emits_profile_kind(self, tmp_path):
        from quiver_tpu_torch.metrics import MetricsSink
        path = tmp_path / "prof.jsonl"
        with MetricsSink(str(path)) as sink:
            prof = StageProfiler(reps=1, sink=sink)
            prof.add_group(_group())
            prof.run()
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        recs = [r for r in recs if r["kind"] != "meta"]
        assert recs and all(r["kind"] == "profile" for r in recs)
        assert recs[-1]["entry"] == "prof_test"

    def test_second_pass_loads_no_library(self):
        prof = StageProfiler(reps=1)
        prof.add_registry(["fused_hot_hop"], device=CPU)
        prof.run()
        base = _build.loaded_libraries._cache_size()
        prof.run()
        assert _build.loaded_libraries._cache_size() == base

    def test_inplace_args_survive_profiling(self):
        # a stage that updates its argument in place, profiled twice,
        # leaves the caller's tensor as it was
        x0 = torch.arange(16.0)

        def step(x):
            x.add_(1.0)
            return x
        st = ProfileStage("inplace", step, (x0,), donate_argnums=(0,))
        prof = StageProfiler(reps=3)
        prof.add_group(ProfileGroup("donated", [st]))
        prof.run()
        prof.run()
        assert x0[5].item() == 5.0

    def test_ref_stage_share_semantics(self):
        g = ProfileGroup("withref", [_matmul_stage("part", 1),
                                     _matmul_stage("whole", 120)],
                         ref_stage="whole")
        prof = StageProfiler(reps=2)
        prof.add_group(g)
        rec = prof.run()[0]
        shares = {s["stage"]: s["share"] for s in rec["stages"]}
        assert shares["whole"] == pytest.approx(1.0)
        assert 0 < shares["part"] < 1.0

    def test_pipeline_group(self):
        # the train path's five stages at the registry's fixture; the
        # leaf hop's modeled bytes are hot_hop_cost's on its input, and
        # the step's state is left as the profiler found it
        prof = StageProfiler(reps=1)
        prof.add_pipeline(device=CPU)
        group = prof.groups[0]
        assert [s.name for s in group.stages] == [
            "sample", "gather", "step", "fused_hop", "fused_multihop"]
        hop = group.stages[3]
        out = hop.fn(*hop.args)
        ip, ix, seeds, feat, forder = hop.args
        nbytes, ops = hot_hop_cost(seeds, 2, out[1], out[0], feat, forder,
                                   feat.shape[0])
        assert hop.cost.total_bytes == nbytes and hop.cost.flops == ops
        state = group.stages[2].args[0]
        before = [p.clone() for p in state.model.parameters()]
        rec = prof.run()[0]
        assert rec["ref_stage"] == "step"
        assert all(torch.equal(a, b) for a, b in
                   zip(before, state.model.parameters()))

    def test_quick_registry_lists_every_quick_entry(self):
        prof = StageProfiler(reps=1)
        try:
            prof.add_registry(quick=True, device=CPU)
        finally:
            registry.release_group()
        assert [g.name for g in prof.groups] == \
            registry.entry_names(quick=True)


class TestInjectedSlowdown:
    def test_deoptimized_stage_shifts_attribution_and_raises_anomaly(self):
        from quiver_tpu_torch.telemetry import TelemetryHub
        hub = TelemetryHub(window=4)       # default watches, stage_share:*
        prof = StageProfiler(reps=2, hub=hub)
        prof.add_group(_group(scale_a=2, scale_b=2))
        for _ in range(8):
            prof.run()
        series = hub.series["stage_share:prof_test/B"]
        base_share = float(np.median(series.values()[-8:]))
        assert base_share == pytest.approx(0.5, abs=0.25)
        slow = StageProfiler(reps=2, hub=hub)
        slow.add_group(_group(scale_a=2, scale_b=100))
        for _ in range(8):
            slow.run()
        slow_share = float(np.median(series.values()[-8:]))
        assert slow_share > 0.8
        anomalies = [a for a in hub.anomalies
                     if a["series"] == "stage_share:prof_test/B"]
        assert anomalies and anomalies[-1]["shift"] > 0

    def test_prefix_watch_arms_per_matching_series(self):
        from quiver_tpu_torch.telemetry import TelemetryHub
        hub = TelemetryHub(window=2, watches=())
        hub.watch("stage_share:*", "spike", threshold=0.9)
        hub.observe("stage_share:x/a", 0.5)
        hub.observe("stage_share:x/b", 0.95)
        hub.observe("unrelated", 5.0)
        assert [a["series"] for a in hub.anomalies] == ["stage_share:x/b"]


class TestNoHostSyncWithProfilerImported:
    def test_hot_paths_stay_sync_free(self):
        import quiver_tpu_torch.profile as prof_mod
        assert prof_mod.StageProfiler
        for entry in ("train_step", "lookup_tiered"):
            spec = registry.build_entry(entry, CPU)
            assert spec.recording().syncs == [], entry

    def test_profile_series_names_are_declared(self):
        assert set(PROFILE_SERIES) == {"stage_share", "stage_ms",
                                       "gather_efficiency"}


class TestCli:
    def test_single_entry_contract(self, tmp_path, capsys):
        from quiver_tpu_torch.profile import main
        path = tmp_path / "prof.jsonl"
        rc = main(["--entry", "lookup_tiered", "--device", "cpu",
                   "--jsonl", str(path), "--reps", "2", "--no-color"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "lookup_tiered" in out and "machine probe" in out
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        assert {r["kind"] for r in recs} == {"meta", "profile"}
        by_entry = {r["entry"]: r for r in recs if r["kind"] == "profile"}
        assert set(by_entry) == {"__machine__", "lookup_tiered"}
        st = by_entry["lookup_tiered"]["stages"][0]
        assert st["mean_ms"] > 0 and st["modeled"]["total_bytes"] > 0
        assert "efficiency" in st
