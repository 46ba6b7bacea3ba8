"""Profiling hooks (counterpart of ``quiver_tpu/profiling.py``) and the
torch side of ``tracing``'s spans.

The JAX package names its scopes and traces with JAX's own profiler;
here ``scope(name)`` is a span of ``tracing``, the port's one span
path, which under a profiler is a ``RecordFunction`` range, plus an NVTX
range when the card is in use, so an external timeline shows it too;
``trace(log_dir)`` is a ``torch.profiler`` run over the CPU and the
card that writes a Chrome trace. ``hot_path`` marks the functions that
must never wait for the card (``analysis.host_lint`` checks them).

Importing this module installs the torch side of every span
(``tracing.install_hook``):

- the switch: spans record while a ``torch.profiler`` session records
  on the calling thread (``torch._C._autograd._profiler_enabled``, one
  call of well under a microsecond), as well as while tracing is
  enabled;
- under a profiler each span is a ``RecordFunction`` range (a host op
  of its name), nested over the aten ops in any trace that records host
  ops;
- on a CUDA card each recording span records a pair of timing events,
  taken in turn from a fixed ring of ``POOL_PAIRS`` pairs, on the
  current stream at entry (the exit on the same stream). Nothing on the
  hot path reads them: ``tracing.resolve`` does, after the caller has
  synchronised; a span whose pair a later span has taken again reads no
  device time. CUDA events are not kernels, so a profiler trace's
  kernel count does not change;
- a span's tensor counters are copied without waiting into a row of a
  host buffer (pinned on a card), so a record keeps no tensor alive.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import List, Optional

import torch

from . import tracing

_profiler_on = torch._C._autograd._profiler_enabled
# the C++ range (about a tenth of record_function's cost); the plain one
# where a build lacks it
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                           torch.autograd.profiler.record_function)

# a fixed ring of timing-event pairs, each taken on a turn: a span's
# events stay readable until POOL_PAIRS later spans have taken the slot
POOL_PAIRS = 4096
_pool: List[Optional["_Events"]] = [None] * POOL_PAIRS
_turns = itertools.count()
# each device's current stream as last seen, and the event's record
# without the Python wrapper, whose stream lookup takes two thirds of
# its time (a build without CUDA has none and never records)
_streams: dict = {}
_record = getattr(torch._C._CudaEventBase, "record", None)


class _Events:
    __slots__ = ("start", "end", "turn")

    def __init__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.turn = -1


class _Taken:
    """A span's pair of events, as ``tracing.Mark`` reads it."""

    __slots__ = ("events", "turn")

    def __init__(self, events: _Events, turn: int):
        self.events = events
        self.turn = turn

    def elapsed(self) -> Optional[float]:
        """The span's device milliseconds; None once the pair has been
        taken again."""
        ev = self.events
        if ev.turn != self.turn:
            return None
        return float(ev.start.elapsed_time(ev.end))


def _current_stream():
    dev = torch._C._cuda_getDevice()
    raw = torch._C._cuda_getCurrentRawStream(dev)
    st = _streams.get(dev)
    if st is None or st.cuda_stream != raw:
        st = _streams[dev] = torch.cuda.current_stream(dev)
    return st


def _enter(name: str):
    rf = None
    if _profiler_on():
        rf = _record_function(name)
        rf.__enter__()
    if not torch.cuda.is_initialized():
        return rf, None, None
    turn = next(_turns)
    ev = _pool[turn % POOL_PAIRS]
    if ev is None:
        ev = _pool[turn % POOL_PAIRS] = _Events()
    ev.turn = turn
    st = _current_stream()
    _record(ev.start, st)
    return rf, _Taken(ev, turn), st


def _exit(token) -> Optional[_Taken]:
    rf, taken, st = token
    if taken is not None:
        _record(taken.events.end, st)
    if rf is not None:
        rf.__exit__(None, None, None)
    return taken


# a span's tensor counters are copied, without waiting, into a row of a
# host buffer (pinned for a card's), so no record keeps a tensor alive;
# a row is taken in turn, like the event pairs
COUNT_WIDTH = 4
_count_bufs: dict = {}
_count_turns = itertools.count()
_row_turns: List[int] = [-1] * POOL_PAIRS


class _Staged:
    """A span's counters as ``tracing.Mark`` reads them."""

    __slots__ = ("buf", "row", "turn", "names", "plain")

    def __init__(self, buf, row, turn, names, plain):
        self.buf, self.row, self.turn = buf, row, turn
        self.names, self.plain = names, plain

    def read(self) -> Optional[dict]:
        """The counters as ints; None once the row has been taken
        again."""
        if _row_turns[self.row] != self.turn:
            return None
        vals = dict(zip(self.names,
                        self.buf[self.row, :len(self.names)].tolist()))
        vals.update((k, int(v)) for k, v in self.plain.items())
        return vals


def _stage(counts: dict):
    tensors = [(k, v) for k, v in counts.items() if torch.is_tensor(v)]
    if not tensors:
        return counts
    if len(tensors) > COUNT_WIDTH:
        raise ValueError(f"a span holds at most {COUNT_WIDTH} tensor "
                         f"counters, got {len(tensors)}")
    kind = tensors[0][1].device.type
    buf = _count_bufs.get(kind)
    if buf is None:
        # a plain tensor even when first staged under inference mode,
        # so later spans outside it may write it
        with torch.inference_mode(False):
            buf = _count_bufs[kind] = torch.zeros(
                (POOL_PAIRS, COUNT_WIDTH), dtype=torch.int32,
                pin_memory=kind == "cuda")
    turn = next(_count_turns)
    row = turn % POOL_PAIRS
    _row_turns[row] = turn
    for j, (_, v) in enumerate(tensors):
        buf[row, j].copy_(v, non_blocking=True)
    return _Staged(buf, row, turn, [k for k, _ in tensors],
                   {k: v for k, v in counts.items() if not torch.is_tensor(v)})


tracing.install_hook(tracing._Hook(_profiler_on, _enter, _exit, _stage))


def _nvtx():
    """``torch.cuda.nvtx`` when a card is in use, else None (a CPU build
    of torch has no NVTX)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return getattr(torch.cuda, "nvtx", None)


@contextlib.contextmanager
def scope(name: str):
    """A named range on the profiler's timeline: a ``tracing`` span,
    which under a profiler is a ``RecordFunction`` range (a host op of
    its name), and an NVTX range when the card is in use. Works on a
    CPU-only build."""
    nvtx = _nvtx()
    if nvtx is not None:
        nvtx.range_push(name)
    try:
        # under a profiler the span is the RecordFunction range
        with tracing.span(name):
            yield
    finally:
        if nvtx is not None:
            nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile the block over the CPU and, when there is one, the card,
    and write a Chrome trace to ``log_dir/name`` (open it in Perfetto
    or ``chrome://tracing``). Yields the ``torch.profiler.profile``.
    The program's spans record while it runs."""
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
