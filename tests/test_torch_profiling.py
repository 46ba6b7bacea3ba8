"""The port's ``profiling`` (``quiver_tpu_torch/profiling.py``) against
the JAX package's contract (``tests/test_profiling.py``): ``hot_path``
stamps without wrapping; ``scope`` is a profiler range that works on a
CPU build; ``trace`` writes a Chrome trace holding the scope names. The
spans' torch side is in ``tests/test_torch_tracing.py``."""

import inspect
import json

import torch

from quiver_tpu_torch import profiling
from quiver_tpu_torch.profiling import hot_path


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
