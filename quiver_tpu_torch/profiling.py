"""Profiling and tracing hooks (counterpart of ``quiver_tpu/profiling.py``).

The JAX package names its scopes and traces with JAX's own profiler;
here ``scope(name)`` is a ``torch.profiler.record_function``
range (plus an NVTX range when the card is in use, so an external
timeline shows it too) and ``trace(log_dir)`` is a ``torch.profiler``
run over the CPU and the card that writes a Chrome trace.
``ScopeTimer`` gives wall-clock numbers per named block, each also a
``scope.<name>`` span of the port's ``tracing``; ``hot_path`` marks the
functions that must never wait for the card (``analysis.host_lint``
checks them).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict

import torch

from . import tracing


def _nvtx():
    """``torch.cuda.nvtx`` when a card is in use, else None (a CPU build
    of torch has no NVTX)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return getattr(torch.cuda, "nvtx", None)


@contextlib.contextmanager
def scope(name: str):
    """A named range on the profiler's timeline: a
    ``torch.profiler.record_function`` range, and an NVTX range when
    the card is in use. Works on a CPU-only build."""
    nvtx = _nvtx()
    if nvtx is not None:
        nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx is not None:
            nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile the block over the CPU and, when there is one, the card,
    and write a Chrome trace to ``log_dir/name`` (open it in Perfetto
    or ``chrome://tracing``). Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))


def hot_path(fn):
    """Marker for functions that must never wait for the card: the
    contract ``analysis.host_lint`` checks statically (no ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()`` or ``synchronize()`` in the
    body). The marker adds no wrapper; it only stamps
    ``__qt_hot_path__`` so tools can find the marked set."""
    fn.__qt_hot_path__ = True
    return fn


def annotate(name: str):
    """Decorator form of :func:`scope`. ``functools.wraps`` keeps the
    wrapped function's signature, docstring, ``__module__`` and
    ``__wrapped__``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _cuda_devices(tree) -> set:
    """The cards of every CUDA tensor in a nested structure (tensors,
    tuples, lists, dicts, None)."""
    out: set = set()
    stack = [tree]
    while stack:
        x = stack.pop()
        if torch.is_tensor(x):
            if x.is_cuda:
                out.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    return out


class ScopeTimer:
    """Accumulating wall-clock timer. ``measure(name, block_on=...)``
    waits, before it stops the clock, for the card of every CUDA tensor
    in ``block_on`` (a tensor or a nested structure of them), and for
    nothing else.

    Every measured block also lands as a ``scope.<name>`` span in the
    port's ``tracing`` when tracing is enabled (the same clock reads),
    so ad-hoc stage timings show on the same timeline as the serving
    and pipeline spans.

    >>> t = ScopeTimer()
    >>> with t.measure("sample"):
    ...     out = sampler.sample(seeds)
    >>> t.summary()                    # printable
    >>> t.summary_dict()               # JSONL-ready payload
    >>> t.emit(sink)                   # -> {"kind": "scope_timer", ...}
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in _cuda_devices(block_on):
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            tracing.record(f"scope.{name}", t0, dt)

    def mean(self, name: str) -> float:
        # .get on both maps: indexing a defaultdict would insert a
        # phantom row for a name never measured
        c = self.counts.get(name, 0)
        return self.totals.get(name, 0.0) / c if c else 0.0

    def summary(self) -> str:
        lines = [f"{k}: {self.totals[k]:.4f}s total, "
                 f"{self.mean(k) * 1e3:.2f} ms/call x{self.counts[k]}"
                 for k in sorted(self.totals)]
        return "\n".join(lines)

    def summary_dict(self) -> Dict[str, dict]:
        """The numbers :meth:`summary` prints, as one JSONL-ready
        mapping: ``{name: {total_s, calls, mean_ms}}``."""
        return {k: {"total_s": round(self.totals[k], 6),
                    "calls": self.counts[k],
                    "mean_ms": round(self.mean(k) * 1e3, 3)}
                for k in sorted(self.totals)}

    def emit(self, sink, kind: str = "scope_timer") -> dict:
        """Append the timings to a ``metrics.MetricsSink`` under the
        shared ``{ts, kind, ...}`` schema (kind ``scope_timer``)."""
        return sink.emit({"scopes": self.summary_dict()}, kind=kind)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
