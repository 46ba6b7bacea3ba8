"""qt_agg — the fleet observability aggregator and export endpoint
CLI (counterpart of the JAX package's ``scripts/qt_agg.py``; the same
flags, defaults and output).

Drives ``quiver_tpu_torch.fleet``: tail N replica processes'
``MetricsSink`` JSONL files, fold them into per-replica and fleet-wide
telemetry series, score each replica's health (SLO burn rate, shed
level, staleness: a replica whose sink stops advancing is detected, not
assumed healthy), and serve the fleet's picture over standard-library
HTTP: ``/metrics`` (Prometheus text exposition) and ``/healthz`` (the
fleet verdict as JSON). One ``fleet`` JSONL record per poll lands in
``--jsonl`` (so ``qt_top --fleet`` renders the same verdict), beside
``anomaly`` records for staleness transitions.

Replica sinks are named ``name=path`` (or bare paths, named ``r0..``);
every replica's own sink stays untouched: the aggregator only reads.
It imports torch through the package but never touches the card (no
``torch.cuda`` call, no device tensor), so it runs beside replicas
that hold it.

Usage:
    python -m quiver_tpu_torch.scripts.qt_agg
        --replicas r0=/tmp/r0.jsonl,r1=/tmp/r1.jsonl
        [--interval 2.0] [--stale-after S] [--port 9109]
        [--jsonl fleet.jsonl] [--once] [--smoke]

``--once`` runs a single aggregation pass, prints the fleet table and
exits. ``--smoke`` is a self-contained probe: it writes two replica
sinks (one across a rollover seam), aggregates them, scrapes its own
``/metrics`` and ``/healthz`` over real HTTP on 127.0.0.1, checks the
exposition format, and exits nonzero on any failure.
"""

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
import time
import urllib.request

def _parse_replicas(spec):
    """``name=path,name=path`` (or bare comma-separated paths) ->
    ordered {name: path}."""
    out = {}
    for i, part in enumerate(p for p in spec.split(",") if p.strip()):
        part = part.strip()
        if "=" in part:
            name, path = part.split("=", 1)
        else:
            name, path = f"r{i}", part
        if name in out:
            raise SystemExit(f"duplicate replica name {name!r}")
        out[name] = path
    if not out:
        raise SystemExit("need --replicas name=path[,name=path...]")
    return out


def _fleet_table(snap, color):
    c = (lambda code, s: f"\x1b[{code}m{s}\x1b[0m") if color else \
        (lambda code, s: s)
    fl = snap["fleet"]
    tint = {"ok": "32", "degraded": "33", "down": "31"}[fl["status"]]
    lines = [c(tint, f"fleet: {fl['replica_count']} replicas, status "
                     f"{fl['status']} (health min "
                     f"{fl['health_min']:.2f} / mean "
                     f"{fl['health_mean']:.2f}, {fl['stale_count']} "
                     f"stale, poll #{fl['polls']})")]
    for name, r in snap["replicas"].items():
        comp = r.get("components", {})
        burn = comp.get("burn")
        tint = ("31" if r["stale"] or r["health"] < 0.4
                else "33" if r["health"] < 0.75 else "32")
        who = r.get("meta") or {}
        attrib = (f"  [{who.get('replica', '?')}@{who.get('host', '?')}"
                  f" pid {who.get('pid', '?')}]" if who else "")
        lines.append(c(tint, (
            f"  {name}: health {r['health']:.2f}"
            f"{'  STALE' if r['stale'] else ''}"
            f"  age {r['age_s']:.1f}s  records {r['records']}"
            f"  burn {'n/a' if burn is None else f'{burn:.2f}'}"
            f"  shed {comp.get('shed_frac', 0.0):.2f}" + attrib)))
    return "\n".join(lines)


# one exposition line: name{labels} value, with an optional
# OpenMetrics exemplar suffix (` # {trace_id="..."} value [ts]`) —
# qt-tail stamps latency series with the newest kept trace
_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [0-9.eE+-]+"
    r"( # \{[^{}]*\} [0-9.eE+-]+( [0-9.eE+-]+)?)?$")


def check_exposition(text):
    """Minimal Prometheus text-format validation (what the smoke
    gate asserts): every non-comment line matches the
    ``name{labels} value`` grammar (an OpenMetrics exemplar suffix is
    allowed) and every sample's metric name was declared by a
    ``# TYPE`` line. Returns the list of violations."""
    bad = []
    typed = set()
    for ln in text.splitlines():
        if not ln.strip():
            continue
        if ln.startswith("# TYPE "):
            typed.add(ln.split()[2])
            continue
        if ln.startswith("#"):
            continue
        if not _PROM_LINE.match(ln):
            bad.append(f"malformed sample line: {ln!r}")
            continue
        name = re.split(r"[{ ]", ln, 1)[0]
        if name not in typed:
            bad.append(f"sample before its # TYPE: {ln!r}")
    return bad


def _smoke(args):
    """Self-contained aggregator + exporter probe (no replicas needed):
    synthesize two replica sinks — one crossing a MetricsSink rollover
    seam — aggregate, scrape over real HTTP, validate."""
    from .. import fleet
    from .. import metrics as qm

    d = tempfile.mkdtemp(prefix="qt_agg_smoke_")
    paths = {}
    for i in range(2):
        p = os.path.join(d, f"r{i}.jsonl")
        paths[f"r{i}"] = p
        # r1's sink rolls over mid-history: the aggregator must read
        # the <path>.1 seam like any other MetricsSink consumer
        sink = qm.MetricsSink(p, replica=f"smoke-r{i}",
                              max_bytes=600 if i else None)
        for step in range(4):
            sink.emit({"counters": {"hot_rows": 100 * (step + 1),
                                    "cold_rows": 50 * (step + 1)},
                       "wall": {"p50_ms": 2.0 + i}}, kind="step_stats")
        sink.emit({"windows": {"short": {"burn_rate": 0.5},
                               "long": {"burn_rate": 0.25}},
                   "budget_remaining": 0.95}, kind="slo")
        sink.close()
    assert os.path.exists(paths["r1"] + ".1"), \
        "smoke premise broken: r1's sink never rolled over"
    sink = (qm.MetricsSink(args.jsonl, replica="qt-agg")
            if args.jsonl else None)
    agg = fleet.FleetAggregator(paths, interval_s=0.5, sink=sink)
    exp = fleet.FleetExporter(agg, port=args.port)
    fail = []
    try:
        base = f"http://127.0.0.1:{exp.port}"
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        fail += check_exposition(body)
        for needle in ('qt_replica_health{replica="r0"}',
                       'qt_replica_health{replica="r1"}',
                       'qt_series{name="hot_hit_rate"}',
                       'qt_counter_total{replica="r1",'
                       'name="hot_rows"}'):
            if needle not in body:
                fail.append(f"/metrics missing {needle}")
        with urllib.request.urlopen(base + "/healthz",
                                    timeout=10) as h:
            verdict = json.loads(h.read())
            if h.status != 200:
                fail.append(f"/healthz status {h.status}")
        if verdict["fleet"]["status"] != "ok":
            fail.append(f"fleet not ok: {verdict['fleet']}")
        # seam check: every record of the rolled-over sink was folded
        r1 = verdict["replicas"]["r1"]
        if r1["records"] != 5:
            fail.append(f"rollover seam lost records: {r1['records']}"
                        " != 5")
        print(_fleet_table(agg.snapshot(), color=False))
        print(f"/metrics: {len(body.splitlines())} lines, "
              f"format {'OK' if not fail else 'BAD'}")
    finally:
        exp.close()
        agg.close()
        if sink is not None:
            sink.close()
        shutil.rmtree(d, ignore_errors=True)
    for f in fail:
        print(f"SMOKE FAIL: {f}", file=sys.stderr)
    return 1 if fail else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", default="",
                    help="name=path[,name=path...] replica sink files")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--stale-after", type=float, default=None,
                    help="seconds without new records before a replica "
                         "is stale (default 3x interval)")
    ap.add_argument("--port", type=int, default=0,
                    help="HTTP export port (0 = ephemeral, printed)")
    ap.add_argument("--no-http", action="store_true")
    ap.add_argument("--jsonl",
                    default=os.environ.get("QT_METRICS_JSONL", ""),
                    help="sink for fleet/anomaly records")
    ap.add_argument("--once", action="store_true",
                    help="one aggregation pass, print, exit")
    ap.add_argument("--smoke", action="store_true",
                    help="self-contained aggregator+exporter CI probe")
    ap.add_argument("--no-color", action="store_true")
    args = ap.parse_args(argv)
    color = not args.no_color and bool(sys.stdout.isatty()
                                       or os.environ.get("FORCE_COLOR"))
    if args.smoke:
        return _smoke(args)

    from .. import fleet
    from .. import metrics as qm

    replicas = _parse_replicas(args.replicas)
    sink = (qm.MetricsSink(args.jsonl, replica="qt-agg")
            if args.jsonl else None)
    agg = fleet.FleetAggregator(replicas, interval_s=args.interval,
                                stale_after_s=args.stale_after,
                                sink=sink)
    if args.once:
        snap = agg.poll()
        print(_fleet_table(snap, color))
        agg.close()
        if sink is not None:
            sink.close()
        return 0
    exp = None
    try:
        agg.start()
        if not args.no_http:
            exp = fleet.FleetExporter(agg, port=args.port)
            print(f"exporting on http://127.0.0.1:{exp.port}/metrics "
                  f"(+ /healthz)")
        while True:
            time.sleep(args.interval)
            print(_fleet_table(agg.snapshot(), color))
    except KeyboardInterrupt:
        return 0
    finally:
        if exp is not None:
            exp.close()
        agg.close()
        if sink is not None:
            sink.close()


if __name__ == "__main__":
    sys.exit(main())
