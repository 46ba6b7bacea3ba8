"""The verifier's command line (counterpart of ``scripts/qt_verify.py``).

Drives both halves of ``quiver_tpu_torch.analysis`` over the port:

- the host lint (standard library ``ast``): lock-held sink emission,
  unfinalized thread resources, blocking calls inside ``@hot_path``
  functions, swallowed worker exceptions; the tree's documented
  deviations (``host_lint.DOCUMENTED``) print as INFO;
- the op rules (one recorded run per registered entry point):
  ``no_host_sync``, ``donation_honored``, ``collective_divergence``,
  ``traffic_budget``, ``executable_census``, on ``--device`` (the card
  by default; ``cpu`` runs the plain versions).

Findings print one a line and, with ``--jsonl``, land as ``lint``-kind
records in the shared ``{ts, kind: "lint", rule, level, entry, msg[,
detail]}`` schema. Exit status 1 iff any ERROR.

Usage::

    python -m quiver_tpu_torch.analysis [--quick] [--entry NAME ...]
        [--device cuda|cpu] [--jsonl PATH] [--host-only] [--no-host]
        [--list] [--no-color]

Run by its path (``python quiver_tpu_torch/analysis/__main__.py
--host-only``) the host-only half imports no torch: it loads the two
standard-library modules beside this file without importing the
package (``-m`` imports the package, and with it torch).
"""

import argparse
import importlib
import json
import os
import sys
import time
import types

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))

RED, YELLOW, GREEN, DIM, RESET = ("\x1b[31m", "\x1b[33m", "\x1b[32m",
                                  "\x1b[2m", "\x1b[0m")


def _stdlib_analysis():
    """``findings`` and ``host_lint`` loaded without importing the
    package (whose ``__init__`` imports torch): a synthetic parent
    package pointed at this directory."""
    name = "_qt_torch_stdlib_analysis"
    if name not in sys.modules:
        pkg = types.ModuleType(name)
        pkg.__path__ = [_HERE]
        sys.modules[name] = pkg
    return (importlib.import_module(name + ".findings"),
            importlib.import_module(name + ".host_lint"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m quiver_tpu_torch.analysis",
        description="the port's static and recorded invariant verifier")
    ap.add_argument("--quick", action="store_true",
                    help="the quick entry-point matrix")
    ap.add_argument("--entry", action="append", default=[],
                    help="verify only this entry point (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="where the entries run: cuda (default) or cpu")
    ap.add_argument("--jsonl", default=None,
                    help="append lint-kind findings to this JSONL")
    ap.add_argument("--host-only", action="store_true",
                    help="the AST rules only (imports no torch)")
    ap.add_argument("--no-host", action="store_true",
                    help="skip the AST rules")
    ap.add_argument("--list", action="store_true",
                    help="list registered entry points and exit")
    ap.add_argument("--no-color", action="store_true")
    args = ap.parse_args(argv)
    color = not args.no_color and bool(
        sys.stdout.isatty() or os.environ.get("FORCE_COLOR"))
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    findings_mod, host_lint = _stdlib_analysis()

    if args.list:
        from quiver_tpu_torch.analysis.registry import entry_names
        quick = set(entry_names(quick=True))
        for n in entry_names():
            print(f"{n}{'  [quick]' if n in quick else ''}")
        return 0

    findings = []
    if not args.no_host:
        host = host_lint.run_host_lint(root=_ROOT)
        for f in host:
            why = host_lint.documented(f)
            if why is not None:
                f.level = findings_mod.INFO
                f.detail = dict(f.detail, documented=why)
        findings += host
        print(f"host lint: {len(host)} finding(s) over quiver_tpu_torch/ "
              f"({sum(f.level == findings_mod.ERROR for f in host)} "
              "error(s))")

    if not args.host_only:
        from quiver_tpu_torch.analysis.registry import run_registry
        fs, entries = run_registry(names=args.entry or None,
                                   quick=args.quick, device=args.device)
        findings += fs
        print(f"op rules: {len(entries)} entry point(s) on {args.device} "
              f"({', '.join(entries)})")

    findings = findings_mod.sort_findings(findings)
    tint = {findings_mod.ERROR: RED, findings_mod.WARN: YELLOW,
            findings_mod.INFO: DIM}
    for f in findings:
        line = str(f)
        print(f"{tint.get(f.level, '')}{line}{RESET}" if color else line)

    if args.jsonl:
        # the MetricsSink schema, written with the standard library so
        # the host-only path stays free of torch
        with open(args.jsonl, "a") as fh:
            for f in findings:
                fh.write(json.dumps({"ts": round(time.time(), 3),
                                     **f.record()}) + "\n")

    n_err = sum(1 for f in findings if f.level == findings_mod.ERROR)
    n_warn = sum(1 for f in findings if f.level == findings_mod.WARN)
    verdict = "FAIL" if n_err else "OK"
    msg = (f"verify: {verdict} — {n_err} error(s), {n_warn} warning(s), "
           f"{len(findings)} finding(s) total")
    print(f"{RED if n_err else GREEN}{msg}{RESET}" if color else msg)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
