"""Static and recorded analysis: the engine of
``python -m quiver_tpu_torch.analysis`` (counterpart of
``quiver_tpu/analysis``).

Two halves:

- :mod:`~quiver_tpu_torch.analysis.op_lint`, the op-trace verifier: one
  recorded eager run per registered entry point, read by the five rules
  (``no_host_sync``, ``donation_honored``, ``collective_divergence``,
  ``traffic_budget``, ``executable_census``) in place of JAX's jaxpr
  walks; :mod:`~.costmodel` prices the same recording;
- :mod:`~quiver_tpu_torch.analysis.host_lint`, the AST verifier of
  host-side bug classes (lock-held sink emission, unfinalized thread
  resources, blocking calls in ``@hot_path`` functions, swallowed
  worker exceptions); standard library only.

:mod:`~.registry` declares the real entry points with their budgets and
census lattices. This package imports the torch half lazily, so
``from quiver_tpu_torch.analysis import host_lint`` alone stays cheap.
"""

from . import host_lint  # noqa: F401  (stdlib-only half)
from .findings import ERROR, INFO, WARN, Finding, has_errors, \
    sort_findings  # noqa: F401

_TORCH_NAMES = {
    "CostModel": "costmodel", "cost_of": "costmodel",
    "cost_of_fn": "costmodel", "CensusSpec": "op_lint",
    "EntrySpec": "op_lint", "RULES": "op_lint", "run_rules": "op_lint",
    "OpRecorder": "op_lint", "record": "op_lint"}


def __getattr__(name):
    if name in _TORCH_NAMES:
        import importlib
        mod = importlib.import_module(f"{__name__}.{_TORCH_NAMES[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["CensusSpec", "CostModel", "ERROR", "EntrySpec", "Finding",
           "INFO", "OpRecorder", "RULES", "WARN", "cost_of", "cost_of_fn",
           "has_errors", "host_lint", "record", "run_rules",
           "sort_findings"]
