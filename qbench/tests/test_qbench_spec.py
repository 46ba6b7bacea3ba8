"""Cells, configurations, traffic mixes and metrics found by name, and
a cell added by files alone."""

import json
import shutil

from qbench import spec


def test_every_cell_resolves():
    bench = spec.load_benchmark()
    names = [w["name"] for w in bench["workloads"]]
    assert spec.cells(bench) == names
    for n in names:
        c = spec.cell(bench, n)
        assert c.config["name"] == c.config_name
        assert spec.driver(c.traffic["driver"]).Driver
        assert c.limits["limits"]
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer
        moved = {m["name"] for m in c.end_to_end}
        assert all(m["moves"] in moved for m in c.per_layer)


def test_contract_shape():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        with open(spec.root() / c["file"]) as f:
            assert json.load(f)["name"] == c["name"]
        assert c["file"].startswith("qbench/")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert all(w["chips"] == 1 for w in bench["workloads"])


def test_a_new_cell_is_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.root() / "BENCHMARK.json", root / "BENCHMARK.json")
    base = root / "qbench"
    cfg = json.loads((base / "configs" / "products_sage.json").read_text())
    cfg["name"] = "tiny_sage"
    (base / "configs" / "tiny_sage.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "train_gpu.json").read_text())
    traffic["checked_steps"] = 2
    (base / "traffic" / "train_tiny.json").write_text(json.dumps(traffic))
    (base / "limits" / "tiny_sage.train_tiny.json").write_text(
        json.dumps({"limits": {"loss_gap": 1e-4}}))
    (base / "metrics" / "step_count.train.py").write_text(
        "def read(s):\n    return float(s.units) if s.units else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_sage", "source": "x",
                             "file": "qbench/configs/tiny_sage.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny_sage.train_tiny",
                               "config": "tiny_sage",
                               "traffic": "train_tiny", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "step_count.train", "unit": "count",
                               "better": "higher", "source": "device_trace",
                               "layer": "entry", "moves": "setup_s",
                               "workloads": ["tiny_sage.train_tiny"]})
    assert "tiny_sage.train_tiny" in spec.cells(bench, base)
    c = spec.cell(bench, "tiny_sage.train_tiny", base)
    assert c.traffic["checked_steps"] == 2
    assert [m["name"] for m in c.per_layer] == ["step_count.train"]
    readers = spec.metric_readers(["step_count.train"], base)
    from qbench import trace
    assert readers["step_count.train"].read(trace.Slice([], 1.0, 3)) == 3.0
    # a cell whose traffic file is missing is not listed
    bench["workloads"].append({"name": "tiny_sage.none", "config":
                               "tiny_sage", "traffic": "none", "chips": 1,
                               "why": "x"})
    assert "tiny_sage.none" not in spec.cells(bench, base)
