"""A traced slice of a run's window, read from the profiler's trace.

``capture`` runs a few timed units under ``torch.profiler``, writes the
Chrome trace under ``TMPDIR``, reads it back and deletes it. A run
takes two slices: one with device activity alone, which the metrics
read (recording every host op would slow the host and inflate the
device's idle time), and a shorter one with host activity too, which
only names what the host was doing in the longest idle gaps.
``Slice`` holds what the metric readers read: the device intervals
(kernels, copies, fills) with their names, the host ops, the slice's
length on the host clock, and the facts the cell's driver worked out
for the traced units (bytes, FLOPs, span times).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Event(NamedTuple):
    name: str
    cat: str
    ts: float      # microseconds
    dur: float     # microseconds


class Slice:
    """A traced slice. ``window_s`` is its length on the host clock,
    from its first unit's start to the synchronise after its last."""

    def __init__(self, events: List[Event], window_s: float, units: int,
                 facts: Dict[str, float] = None):
        self.device = sorted((e for e in events if e.cat in DEVICE_CATS),
                             key=lambda e: e.ts)
        self.host = [e for e in events if e.cat in HOST_CATS]
        self.window_s = float(window_s)
        self.units = int(units)
        self.facts = dict(facts or {})

    def kernels(self) -> List[Event]:
        return [e for e in self.device if e.cat == "kernel"]

    def kernel_seconds(self, *names: str) -> float:
        """Summed device time of the kernels whose name holds one of
        ``names``."""
        return sum(e.dur for e in self.kernels()
                   if any(n in e.name for n in names)) * 1e-6

    def kernel_count(self, *names: str) -> int:
        return sum(1 for e in self.kernels()
                   if any(n in e.name for n in names))

    def busy_s(self) -> float:
        """Seconds in which a kernel, copy or fill ran: the union of
        their intervals."""
        total, end = 0.0, float("-inf")
        for e in self.device:
            lo, hi = e.ts, e.ts + e.dur
            if hi <= end:
                continue
            total += hi - max(lo, end)
            end = hi
        return total * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals between device intervals, in microseconds."""
        out, end = [], None
        for e in self.device:
            if end is not None and e.ts > end:
                out.append((end, e.ts))
            end = e.ts + e.dur if end is None else max(end, e.ts + e.dur)
        return out

    def host_op_at(self, t: float) -> str:
        """The innermost host op running at ``t``."""
        best = None
        for e in self.host:
            if e.ts <= t <= e.ts + e.dur and (best is None
                                              or e.ts >= best.ts):
                best = e
        return best.name if best is not None else "(no host op)"

    def breakdown(self, host: "Slice" = None, top: int = 10) -> dict:
        """The device ops that took most time in this slice, and the
        longest idle gaps of ``host`` (a slice with host activity;
        default this one) by the host op in progress at their start."""
        host = self if host is None else host
        by_name: Dict[str, float] = {}
        for e in self.device:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(host.gaps(), key=lambda g: g[0] - g[1])[:top]
        idle = [[host.host_op_at(lo), (hi - lo) * 1e-6] for lo, hi in gaps]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in idle]}


def read_chrome_trace(path: str) -> List[Event]:
    with open(path) as f:
        doc = json.load(f)
    out = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        out.append(Event(str(e.get("name", "")), str(e.get("cat", "")),
                         float(e["ts"]), float(e["dur"])))
    return out


def capture(run_units, units: int,
            host: bool = False) -> Tuple[List[Event], float]:
    """Run ``run_units(units)`` under the profiler, recording device
    activity, and host ops too with ``host``. Returns the trace's events
    and the slice's length in seconds on the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_units(units)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="qbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = read_chrome_trace(path)
    finally:
        os.remove(path)
    return events, window
