"""Each per-layer metric's reader on a small synthetic profiler trace."""

import json

import pytest

from qbench import spec, trace
from qbench.costs import peaks


def _trace(tmp_path):
    ev = [
        # host ops (microseconds)
        {"ph": "X", "cat": "cpu_op", "name": "aten::index_add_",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 65,
         "dur": 300},
        # device intervals: 10-30 and 20-40 overlap, then 60-70, 80-90
        {"ph": "X", "cat": "kernel", "name": "void fused_hot_hop_kernel<4>",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "fused_sample_hop_kernel",
         "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "gather_rows_packed_kernel",
         "ts": 80, "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read_chrome_trace(str(path))


def test_slice_busy_gaps_breakdown(tmp_path):
    s = trace.Slice(_trace(tmp_path), 100e-6, 2)
    assert s.busy_s() == pytest.approx(50e-6)
    assert s.gaps() == [(40.0, 60.0), (70.0, 80.0)]
    b = s.breakdown()
    assert b["device_ops"][0][1] == pytest.approx(20e-6)
    assert b["idle_gaps"][0] == ["aten::index_add_", pytest.approx(20e-6)]
    assert b["idle_gaps"][1][0] == "aten::mm"
    assert s.kernel_count("") == 3


def _readers():
    """Every reader in ``qbench/metrics/``."""
    return spec.metric_readers(sorted(
        p.name[:-3] for p in (spec.HERE / "metrics").glob("*.py")))


def test_every_per_layer_metric_has_a_reader():
    bench = spec.load_benchmark()
    assert {m["name"] for m in bench["per_layer"]} <= set(_readers())


def test_readers_on_the_synthetic_trace(tmp_path):
    r = _readers()
    facts = {"model_flops": 67e12 * 50e-6, "tf32": False,
             "host_gather_host_bytes": 64e9 * 5e-6,
             "host_gather_device_bytes": 0, "sampler_ms": 1.5}
    s = trace.Slice(_trace(tmp_path), 100e-6, 2, facts)
    assert r["train_mfu"].read(s) == pytest.approx(50.0)
    assert r["serve_mfu"].read(s) == pytest.approx(50.0)
    assert r["host_gather_roofline.serve"].read(s) == pytest.approx(50.0)
    assert r["sampler_ms.train"].read(s) == 1.5
    assert r["kernels_per_step.train"].read(s) == 1.5
    assert r["kernels_per_batch.serve"].read(s) == 1.5
    for name in ("device_idle.train", "device_idle.serve"):
        assert r[name].read(s) == pytest.approx(50.0)
    # no host-tier gather in the slice: nothing to read
    no_gather = trace.Slice([e for e in _trace(tmp_path)
                             if "gather" not in e.name], 100e-6, 2, facts)
    assert r["host_gather_roofline.serve"].read(no_gather) is None


def test_readers_find_nothing_and_return_nothing():
    r = _readers()
    s = trace.Slice([], 1.0, 0, {})
    for name, mod in r.items():
        assert mod.read(s) is None, name


def test_tf32_peak_is_used_when_on(tmp_path):
    r = _readers()
    s = trace.Slice(_trace(tmp_path), 1.0, 1,
                    {"model_flops": peaks.TF32_FLOPS, "tf32": True})
    assert r["train_mfu"].read(s) == pytest.approx(100.0)
