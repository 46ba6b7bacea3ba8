"""The one finding record shared by both verifier halves (the port's
copy of ``quiver_tpu/analysis/findings.py``).

``python -m quiver_tpu_torch.analysis`` (and the tests) consume findings
from the op-trace verifier (``analysis.op_lint``) and the host-side AST
verifier (``analysis.host_lint``) through one shape: a rule id, a
severity, the entry point (or file) it anchors to, and a human message.
``record()`` is the ``lint``-kind JSONL payload the
``metrics.MetricsSink`` schema carries, the same keys as the JAX
package's, so the two packages' records compare. Standard library only,
so the host lint runs without importing torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

ERROR = "ERROR"
WARN = "WARN"
INFO = "INFO"

_SEVERITY = {ERROR: 0, WARN: 1, INFO: 2}


@dataclass
class Finding:
    rule: str                 # rule id, e.g. "collective_divergence"
    level: str                # ERROR | WARN | INFO
    entry: str                # entry-point name or source path
    msg: str
    detail: Dict = field(default_factory=dict)

    def record(self) -> dict:
        """The ``lint``-kind JSONL payload (``MetricsSink`` adds ts)."""
        rec = {"kind": "lint", "rule": self.rule, "level": self.level,
               "entry": self.entry, "msg": self.msg}
        if self.detail:
            rec["detail"] = self.detail
        return rec

    def __str__(self) -> str:
        return f"{self.level} [{self.rule}] {self.entry}: {self.msg}"


def sort_findings(findings: List[Finding]) -> List[Finding]:
    """Severity-major, then entry/rule — the CLI's print order."""
    return sorted(findings,
                  key=lambda f: (_SEVERITY.get(f.level, 3), f.entry,
                                 f.rule, f.msg))


def has_errors(findings: List[Finding]) -> bool:
    return any(f.level == ERROR for f in findings)
