"""qt_top — a live ANSI dashboard over the metrics JSONL sink
(counterpart of the JAX package's ``scripts/qt_top.py``; the same
flags, defaults and frames).

``top`` for a run of the port: tail the ``metrics.MetricsSink`` JSONL
that a training loop, a server or a replica leaves behind
(``QT_METRICS_JSONL``) and render, in place, one compact frame per
refresh:

- a sparkline per time series (derived counter ratios out of
  ``step_stats`` records, bench values, per-request p99 and queue depth
  out of ``serving`` records, SLO burn rates);
- the SLO error-budget line (short and long burn, budget left,
  SHEDDING highlighted);
- recent ``anomaly`` records (red: the change-point detectors'
  verdicts), the latest ``advice`` per knob (yellow: the advisory
  re-planner's), the latest ``actuate`` record per knob and action (the
  actuator's actions: knob swaps plain, hot-set rotations cyan, fleet
  scale events magenta, refusals red), the latest ``regress`` verdicts,
  and ``lint`` findings (ERROR red, WARN yellow: the verifier's);
- the TENANT panel from ``tenant`` records: one row per tenant class,
  latest record wins (burn-rate sparkline, completed, shed and
  rejected counts, p99), shed classes colored;
- the capacity line from the newest ``capacity`` record (the
  prediction ``qt_capacity --predict`` emits), its replay verdict
  colored by ``within_tol``;
- the stage profiler's ``profile`` records and the tail sampler's
  kept ``trace`` records, one row each, latest wins;
- the FLEET panel from ``fleet`` records (point ``--jsonl`` at
  ``qt_agg``'s sink): one row per replica, health colored by threshold,
  STALE red, and the fleet status line. ``--fleet`` narrows the frame
  to that panel.

Reads across the sink's rollover seam (``<path>.1`` before ``<path>``,
the ``MetricsSink(max_bytes=...)`` convention), so a size-bounded
week-long watch still renders its whole retained window.

Standard library only: no torch, no numpy, no import of the package's
modules, no curses (ANSI escapes work in any terminal, over ssh, in
tmux). ``--once`` prints a single frame and exits.

Usage: python -m quiver_tpu_torch.scripts.qt_top [--jsonl PATH]
           [--interval 2.0] [--limit 4096] [--width 48] [--once]
           [--fleet] [--no-color]
"""

import argparse
import json
import os
import sys
import time

SPARK = "▁▂▃▄▅▆▇█"

RED = "\x1b[31m"
YELLOW = "\x1b[33m"
GREEN = "\x1b[32m"
MAGENTA = "\x1b[35m"
CYAN = "\x1b[36m"
BOLD = "\x1b[1m"
DIM = "\x1b[2m"
RESET = "\x1b[0m"


def read_records(path, limit):
    """The last ``limit`` records across the rollover seam: ``path.1``
    (the rolled-over older half) before ``path``; unparseable lines
    skipped (a live writer's torn tail must not kill the view)."""
    recs = []
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
                if isinstance(rec, dict):
                    recs.append(rec)
    return recs[-limit:]


def _num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def build_series(records):
    """kind-keyed record stream -> {series name: [values]} plus the
    event lists (anomalies, advice, act, regress, lint, profile,
    traces, slo, fleet)."""
    series = {}
    anomalies, advice, regress, lint, prof = [], {}, {}, {}, {}
    act = {}
    traces = {}
    tenants = {}
    slo = None
    fleet = None
    capacity = None

    def put(name, v):
        if _num(v):
            series.setdefault(name, []).append(float(v))

    def put_slo(rec):
        # every slo-bearing record contributes burn-rate POINTS (the
        # trend is the whole point of the sparkline); the newest
        # record also becomes the summary line
        w = rec.get("windows") or {}
        put("slo_burn_short", (w.get("short") or {}).get("burn_rate"))
        put("slo_burn_long", (w.get("long") or {}).get("burn_rate"))
        return rec

    for rec in records:
        kind = rec.get("kind")
        if kind == "step_stats" or kind == "serving":
            for k, v in (rec.get("derived") or {}).items():
                put(k, v)
            wall = rec.get("wall") or {}
            put("batch_p50_ms" if kind == "serving" else "step_p50_ms",
                wall.get("p50_ms"))
            req = rec.get("request") or {}
            put("request_p99_ms", req.get("p99_ms"))
            sv = rec.get("serving") or {}
            put("queue_depth", sv.get("queue_depth"))
            put("shed_level", sv.get("shed_level"))
            put("batch_fill", sv.get("mean_batch_fill"))
            if "slo" in rec:
                slo = put_slo(rec["slo"])
        elif kind == "slo":
            slo = put_slo(rec)
        elif kind == "bench":
            if _num(rec.get("value")):
                put(f"bench:{rec.get('metric', '?')}", rec["value"])
            for k in ("feature_gather_rows_per_s", "cold_rows_per_s",
                      "prefetch_hit_rate", "cold_staged_rows_per_s",
                      "gather_efficiency"):
                put(f"bench:{k}", rec.get(k))
        elif kind == "profile":
            # latest per (entry, stage) — repeated qt_prof passes
            # re-emit every stage and must not flood the panel
            entry = rec.get("entry", "?")
            if not str(entry).startswith("__"):
                for st in rec.get("stages") or []:
                    prof[(entry, st.get("stage", "?"))] = st
        elif kind == "fleet":
            # newest verdict wins; per-replica health becomes a series
            # so the panel shows the TREND, not just the last score
            fleet = rec
            for name, r in (rec.get("replicas") or {}).items():
                put(f"health:{name}", r.get("health"))
        elif kind == "tenant":
            # latest per tenant class (the lint/advice dedup
            # discipline: a server re-emits every class per snapshot
            # and only the newest counters matter) — but every record
            # contributes burn-rate POINTS so the panel shows trend
            name = rec.get("tenant", "?")
            tenants[name] = rec
            w = (rec.get("slo") or {}).get("windows") or {}
            put(f"tenant_burn:{name}",
                (w.get("short") or {}).get("burn_rate"))
        elif kind == "replay":
            # per-tenant measured p99 from a trace replay —
            # the proving-ground trend next to the tenant panel
            put(f"replay_p99:{rec.get('tenant', '?')}",
                (rec.get("latency") or {}).get("p99_ms"))
        elif kind == "capacity":
            capacity = rec                        # newest verdict wins
        elif kind == "anomaly":
            anomalies.append(rec)
        elif kind == "advice":
            advice[rec.get("key", "?")] = rec
        elif kind == "actuate":
            # latest per (key, action) — the lint/advice dedup
            # discipline: a settling loop re-emits apply records per
            # knob and must not flood the panel; the replica-count
            # trajectory becomes a series so scale events show their
            # trend, not just the last count
            act[(rec.get("key", "?"), rec.get("action", "?"))] = rec
            if rec.get("key") == "replicas":
                put("replica_count",
                    (rec.get("after") or {}).get("value"))
        elif kind == "regress":
            regress[(rec.get("metric", "?"),
                     rec.get("platform", "?"))] = rec
        elif kind == "lint" and rec.get("level") in ("ERROR", "WARN"):
            # latest per (rule, entry) — repeated suite runs re-emit
            # the same finding and must not flood the display window
            lint[(rec.get("rule", "?"), rec.get("entry", "?"))] = rec
        elif kind == "trace":
            # latest per trace_id (the lint/profile dedup discipline):
            # a trace kept on both sides of the wire lands twice with
            # the same id and must render as ONE row
            if rec.get("trace_id") is not None:
                traces[rec["trace_id"]] = rec
    return (series, anomalies, advice, act, regress, lint, prof,
            traces, tenants, capacity, slo, fleet)


def sparkline(values, width):
    v = values[-width:]
    lo, hi = min(v), max(v)
    if hi <= lo:
        return SPARK[0] * len(v)
    scale = (len(SPARK) - 1) / (hi - lo)
    return "".join(SPARK[int((x - lo) * scale)] for x in v)


def fmt(v):
    if abs(v) >= 1e5:
        return f"{v:.3g}"
    if abs(v) >= 100:
        return f"{v:.0f}"
    return f"{v:.3f}"


def render_fleet(fleet, series, width, c):
    """The multi-replica panel: fleet status line + one row per
    replica (health trend sparkline, score colored by threshold,
    STALE red)."""
    lines = []
    fl = fleet.get("fleet") or {}
    status = fl.get("status", "?")
    tint = {"ok": GREEN, "degraded": YELLOW}.get(status, RED)
    lines.append(c(tint, (
        f"fleet: {fl.get('replica_count', '?')} replicas, status "
        f"{status} (health min {fl.get('health_min', '?')} / mean "
        f"{fl.get('health_mean', '?')}, {fl.get('stale_count', 0)} "
        f"stale)")))
    reps = fleet.get("replicas") or {}
    name_w = max((len(n) for n in reps), default=0)
    for name in sorted(reps):
        r = reps[name]
        h = r.get("health")
        stale = bool(r.get("stale"))
        tint = (RED if stale or not _num(h) or h < 0.4
                else YELLOW if h < 0.75 else GREEN)
        trend = series.get(f"health:{name}", [])
        spark = sparkline(trend, width) if trend else ""
        comp = r.get("components") or {}
        burn = comp.get("burn")
        part = r.get("partition") or {}
        owns = (f"  part {part.get('home')}/{part.get('partitions')}"
                if _num(part.get("home")) else "")
        loc = r.get("locality_hit_rate")
        loc_s = f"  loc {loc:.2f}" if _num(loc) else ""
        lines.append(c(tint, (
            f"  {name:<{name_w}}  {spark:<{width}}  health "
            f"{h if _num(h) else '?'}"
            f"{'  STALE' if stale else ''}  "
            f"age {r.get('age_s', '?')}s  "
            f"burn {burn if _num(burn) else 'n/a'}  "
            f"shed {comp.get('shed_frac', 0)}"
            f"{owns}{loc_s}")))
    return lines


def render(path, limit, width, color=True, fleet_only=False):
    c = (lambda code, s: f"{code}{s}{RESET}") if color else \
        (lambda code, s: s)
    records = read_records(path, limit)
    (series, anomalies, advice, act, regress, lint, prof, traces,
     tenants, capacity, slo, fleet) = build_series(records)
    lines = [c(BOLD, f"qt_top — {path}  "
                     f"({len(records)} records, "
                     f"{time.strftime('%H:%M:%S')})")]
    if not records:
        lines.append("  (no records yet — is QT_METRICS_JSONL set and "
                     "the run emitting?)")
        return "\n".join(lines)
    def anomaly_lines():
        return [c(RED, f"  ANOMALY [{a.get('detector')}] "
                       f"{a.get('series')}: "
                       f"{a.get('baseline')} -> {a.get('value')} "
                       f"(step {a.get('step')})")
                for a in anomalies[-6:]]

    if fleet_only:
        if fleet is None:
            lines.append("  (no fleet records — point --jsonl at "
                         "scripts/qt_agg.py's sink)")
        else:
            lines += render_fleet(fleet, series, width, c)
        return "\n".join(lines + anomaly_lines())
    name_w = max((len(n) for n in series), default=0)
    for name in sorted(series):
        v = series[name]
        lines.append(f"  {name:<{name_w}}  "
                     f"{sparkline(v, width):<{width}}  "
                     f"{fmt(v[-1]):>10}  "
                     + c(DIM, f"(n={len(v)}, min {fmt(min(v))}, "
                              f"max {fmt(max(v))})"))
    if slo is not None:
        w = slo.get("windows") or {}
        s = (w.get("short") or {}).get("burn_rate")
        l = (w.get("long") or {}).get("burn_rate")
        rem = slo.get("budget_remaining")
        shedding = bool(slo.get("shedding"))
        txt = (f"slo: burn {s if s is not None else 'n/a'} (short) / "
               f"{l if l is not None else 'n/a'} (long), budget left "
               f"{rem if rem is not None else 'n/a'}")
        if shedding:
            txt += "  SHEDDING"
        lines.append(c(RED if shedding else GREEN, txt))
    # tenant panel: one row per class, newest record wins (ordered by
    # priority, highest first — the shed order reversed); burn trend
    # as a sparkline, shed counts colored by whether the class is
    # absorbing load shed right now
    name_t = max((len(n) for n in tenants), default=0)
    for name in sorted(tenants,
                       key=lambda n: (-tenants[n].get("priority", 0),
                                      n)):
        t = tenants[name]
        lat = t.get("latency") or {}
        p99 = lat.get("p99_ms")
        shed = t.get("shed", 0)
        sl = t.get("slo") or {}
        burn = ((sl.get("windows") or {}).get("short")
                or {}).get("burn_rate")
        trend = series.get(f"tenant_burn:{name}", [])
        spark = sparkline(trend, width) if trend else ""
        tint = (RED if _num(burn) and burn > 1.0
                else YELLOW if shed else GREEN)
        lines.append(c(tint, (
            f"  tenant {name:<{name_t}} p{t.get('priority', '?')}  "
            f"{spark:<{width}}  "
            f"done {t.get('completed', 0)}  shed {shed} "
            f"(rej {t.get('rejected', 0)} disp "
            f"{t.get('displaced', 0)} ddl "
            f"{t.get('deadline_expired', 0)})  "
            f"p99 {fmt(p99) if _num(p99) else 'n/a'} ms  "
            f"burn {fmt(burn) if _num(burn) else 'n/a'}")))
    if capacity is not None:
        v = capacity.get("verdict") or {}
        ok = v.get("within_tol")
        txt = (f"capacity: {capacity.get('replicas', '?')} replica(s) "
               f"sustain {fmt(capacity.get('predicted_rps', 0))} req/s "
               f"within p99 "
               f"{fmt(capacity.get('budget_p99_ms', 0))} ms "
               f"(fill {capacity.get('fill', '?')}"
               f"/{capacity.get('batch_cap', '?')})")
        if v:
            txt += (f"  replay {fmt(v.get('measured_rps', 0))} req/s, "
                    f"ratio {v.get('ratio', '?')} "
                    + ("WITHIN TOL" if ok else "OUT OF TOL"))
        lines.append(c(GREEN if ok or not v else RED, txt))
    if fleet is not None:
        lines += render_fleet(fleet, series, width, c)
    lines += anomaly_lines()
    for key in sorted(advice):
        rec = advice[key]
        lines.append(c(YELLOW, f"  advice [{key}]: "
                               f"{rec.get('current')} -> "
                               f"{rec.get('recommended')}  "
                               f"{rec.get('reason', '')}"))
    # act panel: the closed loop's actions — knob swaps plain, hot-set
    # rotation/promotion cyan, fleet scale events magenta, refusals of
    # out-of-census points red (the WARN that must be seen)
    for (key, action) in sorted(act):
        rec = act[(key, action)]
        before = (rec.get("before") or {}).get("value")
        after = (rec.get("after") or {}).get("value")
        tint = (RED if rec.get("level") == "WARN"
                else MAGENTA if action in ("scale_up", "scale_down")
                else CYAN if action in ("rotate", "promote")
                else DIM if action == "suppress" else GREEN)
        span = (f"{before} -> {after}" if after is not None
                else f"{before} -> {rec.get('recommended')}")
        lines.append(c(tint, f"  act [{key}] {action}: {span}  "
                            f"{rec.get('reason', '')}"))
    for key in sorted(lint)[:8]:
        rec = lint[key]
        bad = rec.get("level") == "ERROR"
        lines.append(c(RED if bad else YELLOW,
                       f"  lint {rec.get('level')} "
                       f"[{rec.get('rule')}] {rec.get('entry')}: "
                       f"{rec.get('msg')}"))
    for (entry, stage) in sorted(prof)[:12]:
        st = prof[(entry, stage)]
        eff = st.get("efficiency")
        # efficiency colored by threshold: >=50% of the probed peak is
        # healthy for a dispatch-bound stage, <15% is leaving the
        # hardware idle
        tint = (DIM if not _num(eff) else GREEN if eff >= 0.5
                else YELLOW if eff >= 0.15 else RED)
        eff_s = f"{100 * eff:.1f}% peak" if _num(eff) else "n/a"
        share = st.get("share")
        share_s = f"{100 * share:.0f}% of step" if _num(share) else ""
        lines.append(c(tint,
                       f"  prof [{entry}/{stage}]: "
                       f"{st.get('mean_ms', 0)} ms  "
                       f"{st.get('achieved_gbps', 0)} GB/s  "
                       f"{eff_s}  {share_s}"))
    # trace panel: the latest kept traces, newest last (record order);
    # error-kept red, the rest yellow — the rows qt_trace expands
    for rec in list(traces.values())[-6:]:
        dom = rec.get("dominant") or {}
        dom_s = (f"{dom.get('name')} {dom.get('dur_ms', 0)}ms"
                 if dom else "n/a")
        bad = rec.get("policy") in ("error", "deadline_exceeded")
        lines.append(c(RED if bad else YELLOW,
                       f"  trace {rec.get('trace_id')} "
                       f"[{rec.get('policy')}] "
                       f"{rec.get('duration_ms', 0)} ms  "
                       f"{rec.get('replica', '')}  "
                       f"dominant {dom_s}"))
    for (metric, platform) in sorted(regress):
        rec = regress[(metric, platform)]
        bad = bool(rec.get("regressed"))
        ratio = rec.get("ratio")
        lines.append(c(RED if bad else GREEN,
                       f"  regress [{metric} @ {platform}]: "
                       f"latest {rec.get('value')} vs best "
                       f"{rec.get('best')} "
                       f"(ratio {ratio if ratio is not None else 'n/a'})"
                       f"{'  REGRESSED' if bad else ''}"))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jsonl",
                    default=os.environ.get("QT_METRICS_JSONL",
                                           "benchmarks/metrics.jsonl"))
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--limit", type=int, default=4096,
                    help="render at most the last N records")
    ap.add_argument("--width", type=int, default=48,
                    help="sparkline width (points)")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen control)")
    ap.add_argument("--fleet", action="store_true",
                    help="multi-replica view: only the fleet panel "
                         "(point --jsonl at qt_agg's sink)")
    ap.add_argument("--no-color", action="store_true")
    args = ap.parse_args(argv)
    # color keys on the terminal, never on the mode: `--once >> log`
    # from cron must not fill the log with escape sequences
    color = not args.no_color and bool(sys.stdout.isatty()
                                       or os.environ.get("FORCE_COLOR"))
    if args.once:
        print(render(args.jsonl, args.limit, args.width, color=color,
                     fleet_only=args.fleet))
        return 0
    try:
        while True:
            frame = render(args.jsonl, args.limit, args.width,
                           color=color, fleet_only=args.fleet)
            # home, draw (clearing each line's stale tail), then clear
            # only BELOW the new frame — a full pre-clear would blank
            # the screen before the frame text arrives (per-interval
            # flicker on slow terminals)
            sys.stdout.write("\x1b[H"
                             + frame.replace("\n", "\x1b[K\n")
                             + "\x1b[K\n\x1b[0J")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
