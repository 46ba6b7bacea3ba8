"""Everything a cell needs, found by name.

``BENCHMARK.json`` names the cells. A cell ``<config>.<traffic>`` is
made of files that each stand alone, so a later change adds a cell by
adding files and an entry, and edits none that is there:

- ``qbench/configs/<config>.json``: the model and the graph, as run;
- ``qbench/traffic/<traffic>.json``: the traffic mix's parameters, with
  the driver that feeds them to the program's entry point;
- ``qbench/drivers/<driver>.py``: one entry point's set-up, timed unit
  and output check;
- ``qbench/limits/<cell>.json``: the limit of each number the check
  compares;
- ``qbench/metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent


def root() -> Path:
    """The checkout the benchmark runs in: the folder above ``qbench``."""
    return HERE.parent


class Cell(NamedTuple):
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]     # the cell's end-to-end metrics
    per_layer: List[dict]      # the cell's per-layer metrics


def load_benchmark(path: Optional[Path] = None) -> dict:
    with open(path or root() / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, base: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``bench`` with its files read."""
    base = base or HERE
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(base.parent / conf["file"])
    traffic = _json(base / "traffic" / f"{entry['traffic']}.json")
    limits = _json(base / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in moved and _reports(m, name)]
    return Cell(name, entry["config"], config, entry["traffic"], traffic,
                limits, e2e, layer)


def cells(bench: dict, base: Optional[Path] = None) -> List[str]:
    """The cells of ``bench`` whose files are all there."""
    base = base or HERE
    out = []
    for w in bench["workloads"]:
        try:
            c = cell(bench, w["name"], base)
        except (KeyError, StopIteration, FileNotFoundError):
            continue
        if (base / "drivers" / f"{c.traffic['driver']}.py").exists():
            out.append(w["name"])
    return out


def driver(name: str):
    """The driver module ``qbench/drivers/<name>.py``."""
    return importlib.import_module(f"qbench.drivers.{name}")


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers(names: List[str],
                   base: Optional[Path] = None) -> Dict[str, object]:
    """The reader of each named per-layer metric,
    ``qbench/metrics/<name>.py``, loaded from its file (a metric's name
    may hold dots)."""
    base = base or HERE
    return {n: _load_file(base / "metrics" / f"{n}.py",
                          "qbench_metric_" + n.replace(".", "_"))
            for n in names}
