"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m qbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run is one process. It makes its inputs on the card from ``--seed``,
sets up the program and warms the cell's own shapes (``setup_s``, from
the start of this module to the first timed unit), measures for
``--seconds`` seconds, checks what the timed path produced against the
plain reference, and prints one JSON object as the last line of
standard output. With ``--trace 0`` its metrics are the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from
a profiler trace of a few units inside the window. The numbers the
check compared are printed with their limits as the last lines of
standard error, and under ``checks``, the last key of the result.

A run that finds no CUDA card, fewer cards than the cell asks for, or a
module of JAX or of the JAX package loaded when the window has closed,
exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import guard, spec  # noqa: E402


# the port's own CUDA kernels, by the names the profiler gives them
PORT_KERNELS = ("fused_sample_hop_kernel", "fused_hot_hop_kernel",
                "sample_layer_kernel", "gather_rows", "gather_elems_kernel",
                "gather_segments_kernel")


def _cache_dirs(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    only a cell's first run in a checkout builds."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "qbench" / sub)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m qbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def window(drv, seconds: float, trace_units: int = 0):
    """Run units from ``drv.first_unit`` for ``seconds`` seconds; the
    window ends in a synchronise. With ``trace_units`` the units after
    the first third of the window run under the profiler. Returns
    ``(units, seconds, traced units, (metric slice events, its
    seconds), host slice events)``: the metric slice records device
    activity alone, then a slice of a sixth as many units records host
    ops too."""
    from quiver_tpu_torch.ops.kernels import _build
    from . import trace
    from .drivers.base import sync
    i = drv.first_unit
    traced, slice_, host_events = range(0), ([], 0.0), []
    t0 = time.perf_counter()
    while True:
        drv.unit(i)
        i += 1
        now = time.perf_counter() - t0
        if trace_units and not traced and now >= seconds / 3:
            start = i

            def run_units(n):
                for j in range(start, start + n):
                    drv.unit(j)
            drv.tracing = True
            _build.reset_launches()
            slice_ = trace.capture(run_units, trace_units)
            drv.launches = dict(_build.LAUNCHES)
            drv.tracing = False
            traced = range(start, start + trace_units)
            i += trace_units
            start = i
            n_host = max(1, trace_units // 6)
            host_events, _ = trace.capture(run_units, n_host, host=True)
            i += n_host
            now = time.perf_counter() - t0
        if now >= seconds:
            break
    sync(drv.dev)
    return i - drv.first_unit, time.perf_counter() - t0, traced, slice_, \
        host_events


def device_info(torch) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        out.stderr.strip()


def run_cell(cell, seed: int, seconds: float, trace_on: bool, dev,
             t_start: float = None) -> dict:
    """One run of ``cell`` on ``dev``: the result's fields before the
    device's and the guard's (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``checks`` and, traced, ``breakdown``, ``busy_s``,
    ``window_s``)."""
    import torch
    from . import trace
    t_start = time.perf_counter() if t_start is None else t_start
    drv = spec.driver(cell.traffic["driver"]).Driver(cell, seed, dev)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    n_trace = int(cell.traffic["trace_units"]) if trace_on else 0
    units, secs, traced, (events, traced_s), host_events = window(
        drv, seconds, n_trace)
    e2e = drv.end_to_end(units, secs)
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if torch.device(dev).type == "cuda" else 0
    out = {"attempted": units, "failed": 0, "memory_peak_bytes": peak}
    if trace_on:
        sl = trace.Slice(events, traced_s, len(traced),
                         drv.trace_facts(traced))
        readers = spec.metric_readers([m["name"] for m in cell.per_layer])
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(sl)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        out["busy_s"], out["window_s"] = sl.busy_s(), sl.window_s
        out["breakdown"] = sl.breakdown(trace.Slice(host_events, 0.0, 0))
        out["trace_counts"] = {
            "units": sl.units, "kernel_events": len(sl.kernels()),
            "port_kernel_events": sl.kernel_count(*PORT_KERNELS),
            "port_launches_counted": sum(drv.launches.values())}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        out["metrics"] = metrics
    drv.release()
    readings = drv.readings()
    checks = {}
    for name, limit in cell.limits["limits"].items():
        checks[name] = {"value": readings[name], "limit": limit}
    out["checks"] = checks
    out["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    return out


def main(argv=None) -> int:
    args = parse(argv)
    root = spec.root()
    _cache_dirs(root)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"qbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if torch.backends.cuda.matmul.allow_tf32:
        print("qbench: fp32 matmuls are set to run in TF32; the "
              "configurations state fp32", file=sys.stderr)
        return 2
    from quiver_tpu_torch.ops.kernels import _build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                   T_START)
    bad = guard.forbidden_modules()
    if bad:
        print("qbench: modules of JAX or of the JAX package are loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    print(f"qbench: card {power_limit()}; peak used for fp32 matmuls: "
          f"{'TF32' if torch.backends.cuda.matmul.allow_tf32 else 'fp32'}",
          file=sys.stderr)
    print(f"qbench: launches by the program's kernel wrappers: "
          f"{json.dumps(dict(_build.LAUNCHES))}", file=sys.stderr)
    if args.trace:
        print(f"qbench: profiler kernel events in the traced slice: "
              f"{out['trace_counts']}", file=sys.stderr)
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    device = device_info(torch)
    device["memory_peak_bytes"] = out["memory_peak_bytes"]
    result = result_line(out, device, bool(args.trace))
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


def result_line(out: dict, device: dict, traced: bool) -> dict:
    """The result's last line from a run's fields: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device`` (with ``busy_s``
    and ``window_s`` when traced), ``breakdown`` when traced, and
    ``checks`` last."""
    device = dict(device)
    if traced:
        device["busy_s"], device["window_s"] = out["busy_s"], \
            out["window_s"]
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if traced:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result


if __name__ == "__main__":
    sys.exit(main())
