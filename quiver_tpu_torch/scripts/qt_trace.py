"""qt_trace — search, inspect and export tail-sampled traces
(counterpart of the JAX package's ``scripts/qt_trace.py``; the same
flags, defaults and output).

The last leg of the debugging runbook: a burn alert names a bad p99, a
``/metrics`` exemplar names the kept ``trace_id`` behind it, and this
tool shows that request: which replicas touched it, where the time
went (dominant span, queue-versus-execute split), and the whole span
timeline, exportable to Perfetto.

Reads ``trace`` JSONL records (the ones ``tailsampling.TailSampler``
emits through ``metrics.MetricsSink``) from one or more sink files,
each across its ``<path>.1`` rollover seam, assembles multi-replica
traces by the propagated global ``trace_id``, and renders:

- the default table: the newest assembled traces, one row each
  (trace_id, keep policy, duration, replicas, dominant span);
- ``--slowest N``: the N longest assembled traces;
- ``--errors``: only traces kept by the ``error`` or
  ``deadline_exceeded`` policies;
- ``--trace-id ID``: the detail view, each segment's span timeline and
  the cross-segment critical path;
- ``--export out.json``: Perfetto/Chrome trace JSON of the selected
  traces, one process track group per segment, joined by
  ``tracing.merge_chrome_traces``.

Standard library only: the port's ``tailsampling`` and ``tracing``
(both standard library only) load through a synthetic package, apart
from the package's ``__init__``, so the tool never imports torch, runs
in milliseconds beside a replica that holds the card, and runs by path
(``python quiver_tpu_torch/scripts/qt_trace.py``) as well as with
``-m``.

Usage: python -m quiver_tpu_torch.scripts.qt_trace [--jsonl PATH]
           [--replicas name=path,...] [--slowest N] [--errors]
           [--trace-id ID] [--export out.json] [--limit N]
"""

import argparse
import importlib
import json
import os
import sys
import tempfile
import time
import types

# the package directory that holds tailsampling.py and tracing.py
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RED = "\x1b[31m"
YELLOW = "\x1b[33m"
BOLD = "\x1b[1m"
DIM = "\x1b[2m"
RESET = "\x1b[0m"


def _load_pkg():
    """Load the port's tailsampling and tracing (standard library only)
    through a synthetic package, apart from the package's
    ``__init__``."""
    name = "_qt_trace_torch_pkg"
    pkg = sys.modules.get(name)
    if pkg is None:
        pkg = types.ModuleType(name)
        pkg.__path__ = [_PKG]
        sys.modules[name] = pkg
    return (importlib.import_module(name + ".tailsampling"),
            importlib.import_module(name + ".tracing"))


def read_trace_records(paths):
    """``trace``-kind records from every sink, across each rollover
    seam (``<path>.1`` first); unparseable lines skipped."""
    out = []
    for source, path in paths:
        for p in (path + ".1", path):
            if not os.path.exists(p):
                continue
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and rec.get("kind") == "trace":
                        out.append((source, rec))
    return out


def build_store(ts_mod, records, capacity=4096):
    store = ts_mod.TraceStore(capacity=capacity)
    for source, rec in records:
        store.add(rec, source)
    return store


def select(assembled, args):
    if args.trace_id is not None:
        return [t for t in assembled if t["trace_id"] == args.trace_id]
    if args.errors:
        assembled = [t for t in assembled
                     if set(t["policies"]) & {"error",
                                              "deadline_exceeded"}]
    if args.slowest:
        assembled = sorted(assembled, key=lambda t: -t["duration_ms"])
        assembled = assembled[:args.slowest]
    return assembled[:args.limit]


def fmt_row(t, c):
    dom = t.get("dominant") or {}
    dom_s = (f"{dom.get('name')} {dom.get('dur_ms', 0)}ms"
             + (f" ({100 * dom['share']:.0f}%)" if "share" in dom else "")
             if dom else "n/a")
    bad = set(t["policies"]) & {"error", "deadline_exceeded"}
    tint = RED if bad else YELLOW
    return c(tint, (
        f"  {t['trace_id']:<16} [{','.join(t['policies'])}] "
        f"{t['duration_ms']:>9.1f} ms  "
        f"{'+'.join(t['replicas'])}  dominant {dom_s}  "
        f"queue {t['queue_ms']}ms / exec {t['execute_ms']}ms"))


def detail(t, c):
    lines = [c(BOLD, f"trace {t['trace_id']} "
                     f"[{','.join(t['policies'])}] "
                     f"{t['duration_ms']} ms across "
                     f"{'+'.join(t['replicas'])}")]
    if t.get("errors"):
        lines.append(c(RED, f"  errors: {t['errors']}"))
    dom = t.get("dominant") or {}
    lines.append(f"  critical path: dominant "
                 f"{dom.get('name', 'n/a')} {dom.get('dur_ms', 0)} ms, "
                 f"queue {t['queue_ms']} ms, execute {t['execute_ms']} ms")
    for seg in t["segments"]:
        lines.append(c(BOLD, (
            f"  segment {seg.get('replica') or '?'} "
            f"(root {seg.get('root')}, policy {seg.get('policy')}, "
            f"{seg.get('duration_ms')} ms)")))
        for s in seg.get("spans") or ():
            args = s.get("args")
            lines.append(
                f"    {s.get('t0_ms', 0):>9.3f} ms  "
                f"{s.get('dur_ms', 0):>9.3f} ms  {s.get('name')}"
                + (c(DIM, f"  {args}") if args else ""))
    return "\n".join(lines)


def export(ts_mod, tracing_mod, traces, out_path):
    """Perfetto export through the existing merge path: each segment
    becomes one chrome-trace file (its own process track group), then
    ``tracing.merge_chrome_traces`` joins them."""
    d = tempfile.mkdtemp(prefix="qt_trace_export_")
    paths = []
    pid = 1
    for t in traces:
        for seg in t["segments"]:
            doc = {"traceEvents": ts_mod.trace_record_to_chrome_events(
                seg, pid=pid)}
            if "base_ns" in seg:
                # the segment's clock base: the merge lines segments of
                # one host up on it
                doc["baseTimeNanoseconds"] = seg["base_ns"]
            p = os.path.join(d, f"seg{pid}.json")
            with open(p, "w") as f:
                json.dump(doc, f)
            paths.append(p)
            pid += 1
    n = tracing_mod.merge_chrome_traces(paths, out_path)
    for p in paths:
        os.unlink(p)
    os.rmdir(d)
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jsonl",
                    default=os.environ.get("QT_METRICS_JSONL",
                                           "benchmarks/metrics.jsonl"))
    ap.add_argument("--replicas", default="",
                    help="extra sinks: name=path[,name=path...]")
    ap.add_argument("--slowest", type=int, default=0,
                    help="show only the N longest traces")
    ap.add_argument("--errors", action="store_true",
                    help="only error/deadline-kept traces")
    ap.add_argument("--trace-id", type=int, default=None,
                    help="detail view of ONE trace (the id a /metrics "
                         "exemplar names)")
    ap.add_argument("--export", default="",
                    help="write the selected traces as Perfetto/Chrome "
                         "trace JSON")
    ap.add_argument("--limit", type=int, default=20)
    ap.add_argument("--no-color", action="store_true")
    args = ap.parse_args(argv)
    ts_mod, tracing_mod = _load_pkg()
    color = not args.no_color and bool(sys.stdout.isatty()
                                       or os.environ.get("FORCE_COLOR"))
    c = (lambda code, s: f"{code}{s}{RESET}") if color else \
        (lambda code, s: s)
    paths = [("sink", args.jsonl)]
    for i, part in enumerate(p for p in args.replicas.split(",")
                             if p.strip()):
        part = part.strip()
        if "=" in part:
            name, path = part.split("=", 1)
        else:
            name, path = f"r{i}", part
        paths.append((name, path))
    records = read_trace_records(paths)
    store = build_store(ts_mod, records)
    assembled = store.assembled()
    picked = select(assembled, args)
    print(c(BOLD, f"qt_trace — {len(assembled)} kept traces from "
                  f"{len(paths)} sink(s)  "
                  f"({time.strftime('%H:%M:%S')})"))
    if not picked:
        print("  (no matching traces — is the TailSampler attached "
              "and emitting?)")
        return 1 if args.trace_id is not None else 0
    if args.trace_id is not None:
        for t in picked:
            print(detail(t, c))
    else:
        for t in picked:
            print(fmt_row(t, c))
    if args.export:
        n = export(ts_mod, tracing_mod, picked, args.export)
        print(f"exported {n} events ({len(picked)} traces) -> "
              f"{args.export}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
