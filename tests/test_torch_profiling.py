"""The port's ``profiling`` (``quiver_tpu_torch/profiling.py``) against
the JAX package's contract (``tests/test_profiling.py``): ``ScopeTimer``
never invents a row on read, accumulates, waits only for the cards of
the CUDA tensors it is given, and lands its spans in ``tracing``;
``annotate`` keeps the wrapped function's identity; ``hot_path`` stamps
without wrapping; ``scope`` is a profiler range that works on a CPU
build; ``trace`` writes a Chrome trace holding the scope names."""

import inspect
import json

import pytest
import torch

from quiver_tpu_torch import profiling, tracing
from quiver_tpu_torch.profiling import ScopeTimer, annotate, hot_path


class TestScopeTimer:
    def test_mean_of_unmeasured_name_does_not_pollute(self):
        t = ScopeTimer()
        with t.measure("real"):
            pass
        assert t.mean("never-measured") == 0.0
        assert "never-measured" not in t.totals
        assert "never-measured" not in t.counts
        assert set(t.summary_dict()) == {"real"}
        assert "never-measured" not in t.summary()

    def test_mean_on_empty_timer(self):
        t = ScopeTimer()
        assert t.mean("anything") == 0.0
        assert t.summary_dict() == {}
        assert t.totals == {} and t.counts == {}

    def test_measure_accumulates(self):
        t = ScopeTimer()
        for _ in range(3):
            with t.measure("s"):
                pass
        assert t.counts["s"] == 3
        assert t.totals["s"] >= 0.0
        assert t.mean("s") == pytest.approx(t.totals["s"] / 3)

    def test_measure_blocks_only_on_cuda_tensors(self, monkeypatch):
        # a nested structure of CPU tensors: no card to wait for, so the
        # timer must not synchronise anything
        def refuse(*a, **k):
            raise AssertionError("synchronised with no CUDA tensor given")
        monkeypatch.setattr(torch.cuda, "synchronize", refuse)
        t = ScopeTimer()
        tree = {"a": torch.arange(8.0),
                "b": (torch.ones(4, 4), torch.zeros(3)), "c": None}
        with t.measure("tree", block_on=tree):
            tree["a"] = tree["a"] * 2
        assert t.counts["tree"] == 1
        assert t.totals["tree"] > 0.0

    def test_cuda_devices_of_block_on(self):
        # the cards measure() waits for: every CUDA tensor's, none else
        assert profiling._cuda_devices(
            {"a": torch.ones(2), "b": [torch.zeros(1), None]}) == set()

    def test_reset(self):
        t = ScopeTimer()
        with t.measure("x"):
            pass
        t.reset()
        assert t.summary_dict() == {}

    def test_spans_land_in_tracing(self):
        tracing.clear()
        tracing.enable()
        try:
            t = ScopeTimer()
            with t.measure("spanned"):
                pass
            names = [r[0] for r in tracing.records()]
        finally:
            tracing.disable()
            tracing.clear()
        assert "scope.spanned" in names

    def test_emit_to_sink(self, tmp_path):
        from quiver_tpu_torch.metrics import MetricsSink
        t = ScopeTimer()
        with t.measure("x"):
            pass
        path = tmp_path / "s.jsonl"
        with MetricsSink(str(path)) as sink:
            t.emit(sink)
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        recs = [r for r in recs if r["kind"] == "scope_timer"]
        assert recs and set(recs[0]["scopes"]) == {"x"}


class TestAnnotate:
    def test_preserves_signature_and_identity(self):
        def hot_fn(a, b=2, *, c: int = 3):
            """The docstring."""
            return a + b + c

        wrapped = annotate("my_scope")(hot_fn)
        assert inspect.signature(wrapped) == inspect.signature(hot_fn)
        assert wrapped.__doc__ == "The docstring."
        assert wrapped.__name__ == "hot_fn"
        assert wrapped.__wrapped__ is hot_fn
        assert wrapped(1) == 6

    def test_wrapped_fn_computes(self):
        @annotate("scoped_add")
        def f(a, b):
            return a + b

        assert f(torch.arange(4), torch.arange(4)).tolist() == [0, 2, 4, 6]


class TestHotPath:
    def test_stamps_without_wrapping(self):
        def f(x):
            return x

        g = hot_path(f)
        assert g is f
        assert f.__qt_hot_path__ is True
        assert f(7) == 7

    def test_marked_counterparts_of_the_jax_hot_paths(self):
        # the port's counterparts of every function JAX marks @hot_path
        from quiver_tpu_torch import comm, feature, serving
        from quiver_tpu_torch.parallel import train
        marked = [comm.dist_lookup_local, train.masked_feature_gather,
                  train.dedup_feature_gather, train._fused_loss,
                  feature.Feature._lookup_tiered]
        assert all(getattr(f, "__qt_hot_path__", False) for f in marked)
        src = inspect.getsource(serving)
        assert src.count("@hot_path\n    def step(") == 2


class TestScopeAndTrace:
    def test_scope_runs_on_a_cpu_build(self):
        with profiling.scope("cpu_scope"):
            x = torch.ones(3) + 1
        assert x.sum().item() == 6.0

    def test_trace_writes_chrome_trace_with_scopes(self, tmp_path):
        with profiling.trace(str(tmp_path)):
            with profiling.scope("qt.outer"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        data = json.loads((tmp_path / "trace.json").read_text())
        names = {e.get("name") for e in data["traceEvents"]}
        assert "qt.outer" in names
