"""qt_capacity — the fleet capacity report (counterpart of the JAX
package's ``scripts/qt_capacity.py``; the same flags, defaults and
output, and ``--device``).

Renders the newest ``capacity`` JSONL record (a prediction with its
replay verdict), and with ``--predict`` derives a fresh prediction from
the newest observed ``serving`` records in the same history (dispatch
p50, mean batch fill, knob readbacks: the ``capacity.observe_serving``
fold), the knobs given on the command line and, unless ``--no-probe``,
this machine's probe (``profile.machine_probe(quick=True)`` on
``--device``, the card by default; it raises where there is none),
and appends it to the history as a new ``capacity`` record.

The model is ``quiver_tpu_torch.capacity`` (host arithmetic; its
docstring gives the utilization heuristic, and a prediction is held
against a replayed measurement by ``capacity.verdict``, not trusted).
Reading and predicting touch no device unless the probe runs.

Usage: python -m quiver_tpu_torch.scripts.qt_capacity [--jsonl PATH]
           [--predict] [--replicas N] [--budget-ms F] [--batch-cap N]
           [--dispatch-ms F] [--max-wait-ms F] [--overhead-ms F]
           [--fill F] [--mix interactive=5,batch=3,best_effort=2]
           [--no-probe] [--device cuda|cpu] [--no-color]

Exit status 0 unless the report itself fails (1 without the knobs a
prediction needs, or when the probe finds no device); a ``within_tol =
False`` verdict renders red, and the gate belongs to the replay.
"""

import argparse
import os
import sys

from .. import capacity as qcap
from .. import metrics as qm


def _c(code: str, s: str, color: bool) -> str:
    return f"\x1b[{code}m{s}\x1b[0m" if color else s


def _parse_mix(text):
    if not text:
        return None
    mix = {}
    for part in text.split(","):
        name, _, w = part.partition("=")
        mix[name.strip()] = float(w) if w else 1.0
    return mix


def render(rec: dict, color: bool) -> str:
    lines = []
    per = rec.get("per_tenant_rps") or {}
    rate = _c("1", f"{rec.get('predicted_rps', 0.0):.0f} req/s", color)
    lines.append(
        f"capacity: {rec.get('replicas', '?')} replica(s) sustain "
        f"{rate} "
        f"within p99 {rec.get('budget_p99_ms', 0.0):.1f} ms "
        f"(cycle {rec.get('cycle_ms', rec.get('service_ms', 0.0)):.2f} ms,"
        f" fill "
        f"{rec.get('fill', 0.0):.1f}/{rec.get('batch_cap', '?')}, "
        f"utilization cap {rec.get('utilization_cap', 0.0):.2f})")
    if rec.get("floor_ms") is not None:
        lines.append(f"  roofline floor: {rec['floor_ms']:.3f} ms "
                     f"(dispatch measured {rec.get('dispatch_ms', 0.0):.3f} ms)")
    for t, rps in sorted(per.items()):
        share = (rec.get("mix") or {}).get(t)
        lines.append(f"  tenant {t}: {rps:.0f} req/s"
                     + (f" ({100.0 * share:.0f}% of mix)"
                        if share is not None else ""))
    v = rec.get("verdict")
    if isinstance(v, dict):
        ok = bool(v.get("within_tol"))
        tag = _c("32", "WITHIN TOL", color) if ok else \
            _c("31", "OUT OF TOL", color)
        lines.append(
            f"  replay verdict: predicted {v.get('predicted_rps', 0.0):.0f}"
            f" vs measured {v.get('measured_rps', 0.0):.0f} req/s — "
            f"ratio {v.get('ratio', 0.0):.2f} "
            f"(±{100.0 * v.get('tol', 0.0):.0f}% gate) {tag}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jsonl",
                    default=os.environ.get("QT_METRICS_JSONL",
                                           "benchmarks/metrics.jsonl"))
    ap.add_argument("--predict", action="store_true",
                    help="derive a fresh prediction from observed "
                         "serving records + these knobs")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--budget-ms", type=float, default=50.0)
    ap.add_argument("--batch-cap", type=int, default=None)
    ap.add_argument("--dispatch-ms", type=float, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--overhead-ms", type=float, default=0.0,
                    help="per-request host overhead (the coalescer "
                         "side of the pipeline; bench_capacity "
                         "calibrates it from a serial round-trip)")
    ap.add_argument("--fill", type=float, default=None)
    ap.add_argument("--mix", type=str, default=None,
                    help="tenant=weight[,tenant=weight...]")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the probe runs (default: the card)")
    ap.add_argument("--no-color", action="store_true")
    a = ap.parse_args(argv)
    color = not a.no_color and sys.stdout.isatty()

    recs = qm.read_jsonl(a.jsonl) if os.path.exists(a.jsonl) else []
    caps = [r for r in recs if r.get("kind") == "capacity"]
    if caps and not a.predict:
        print(render(caps[-1], color))
        return 0

    if not a.predict:
        print(f"no capacity records in {a.jsonl} "
              f"(run benchmarks/bench_capacity.py, or pass --predict)")
        return 0

    observed = qcap.observe_serving(
        [r for r in recs if r.get("kind") == "serving"])
    batch_cap = a.batch_cap or observed.get("batch_cap")
    dispatch_ms = a.dispatch_ms or observed.get("dispatch_ms")
    if batch_cap is None or dispatch_ms is None:
        print("need --batch-cap and --dispatch-ms (no observed "
              f"serving records in {a.jsonl} to derive them from)")
        return 1
    max_wait_ms = (a.max_wait_ms if a.max_wait_ms is not None
                   else observed.get("max_wait_ms", 2.0))
    probe = None
    if not a.no_probe:
        from ..profile import machine_probe
        try:
            probe = machine_probe(quick=True, device=a.device)
        except RuntimeError as e:
            print(f"qt_capacity: {e}", file=sys.stderr)
            return 1
    rec = qcap.predict(batch_cap=int(batch_cap),
                       dispatch_ms=float(dispatch_ms),
                       budget_p99_ms=a.budget_ms,
                       replicas=a.replicas,
                       max_wait_ms=float(max_wait_ms),
                       overhead_per_req_ms=a.overhead_ms,
                       fill=a.fill, mix=_parse_mix(a.mix),
                       probe=probe)
    rec["source"] = "qt_capacity --predict"
    print(render(rec, color))
    with qm.MetricsSink(a.jsonl) as sink:
        qcap.emit(sink, rec)
    print(f"capacity record appended -> {a.jsonl}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
