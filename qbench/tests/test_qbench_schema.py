"""The result's last line, and a run with no card."""

import json
import subprocess
import sys

from qbench import run, spec


def _out(traced):
    out = {"correct": True, "attempted": 7, "failed": 0,
           "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
           "checks": {"loss_gap": {"value": 1e-7, "limit": 1e-5}},
           "memory_peak_bytes": 10}
    if traced:
        out.update(busy_s=0.5, window_s=1.0,
                   breakdown={"device_ops": [["k", 0.1]],
                              "idle_gaps": [["aten::mm", 0.01]]})
    return out


def test_last_line_keys_and_order():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 10}
    for traced in (False, True):
        r = run.result_line(_out(traced), dev, traced)
        keys = list(r)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"]
        assert keys[-1] == "checks"
        assert ("breakdown" in r) == traced
        d = r["device"]
        assert d["platform"] == "gpu" and d["count"] == 1
        assert ("busy_s" in d and "window_s" in d) == traced
        json.loads(json.dumps(r))
        for m in r["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in r["checks"].values():
            assert set(c) == {"value", "limit"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "qbench.run", "--workload",
         "products_sage.serve_tiered", "--seed", "3000000001", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=spec.root(), env={"CUDA_VISIBLE_DEVICES": "",
                              "PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
