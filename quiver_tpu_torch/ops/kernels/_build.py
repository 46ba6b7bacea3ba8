"""Build and load the port's CUDA kernels, and count their launches.

Each source under ``quiver_tpu_torch/csrc/`` is compiled by ``nvcc`` into
a shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The build happens at
first use, into ``build/quiver_tpu_torch/`` beside the package; the file
name carries a hash of the source, the ``*.cuh`` headers beside it and
the flags, so an edited source or header never loads a stale library.
Importing this module builds nothing.

It also holds the hook through which the wrappers report to the op
recorder of ``analysis.op_lint``: a ``ctypes`` launch never reaches
torch's dispatcher, so :func:`recorded` hands each wrapper call (its
arguments and its result) to the active recorder, and the ops the
wrapper runs inside (its plain version on the CPU, its allocations on
the card) are not recorded one by one. A CPU run and a card run thus
record the same calls. :func:`gated` marks a predicated branch's reads,
the port's counterpart of a JAX ``lax.cond`` branch.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "quiver_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}
# what ``nvcc -Xptxas -v`` said for each source (registers, spills), and
# the seconds its ``nvcc`` ran
build_logs: dict = {}
build_seconds: dict = {}

# launches of each kernel since the last reset_launches(); a wrapper adds
# one exactly where it launches its kernel. Wrappers run on several
# threads (a staging pipeline's worker beside the training loop), so the
# read-modify-write is made under a lock.
LAUNCHES = {"fused_sample_hop": 0, "fused_hot_hop": 0, "sample_layer": 0,
            "gather_rows": 0, "gather_elems": 0, "gather_rows_sharded": 0}
# the same for the packed int8 gathers, by the kernel a wrapper launched:
# the host design (a table or a block in pinned host memory) or the HBM
# design (every row in device memory), each counted also in LAUNCHES
PACKED_LAUNCHES = {"gather_rows_packed_kernel": 0,
                   "gather_rows_packed_hbm_kernel": 0,
                   "gather_rows_sharded_packed_kernel": 0,
                   "gather_rows_sharded_packed_hbm_kernel": 0}
# the same for the raw-row gathers, by the design a wrapper launched
# (gather.raw_design): the loop or the tile design
RAW_LAUNCHES = {"gather_rows_kernel": 0, "gather_rows_tile_kernel": 0,
                "gather_rows_sharded_kernel": 0,
                "gather_rows_sharded_tile_kernel": 0}
# the same for the 1-D topology gathers, each counted also under
# LAUNCHES["gather_elems"]: the flat form (an id array) and the span form
# (each seed's consecutive elements from its start and count)
ELEMS_LAUNCHES = {"gather_elems_kernel": 0, "gather_segments_kernel": 0}
_BY_KERNEL = (PACKED_LAUNCHES, RAW_LAUNCHES, ELEMS_LAUNCHES)
# launches of each gather kernel named to launched() since the process
# started, never reset: the whole of a run, across its count windows
KERNEL_TOTALS: dict = {}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for counts in (LAUNCHES, *_BY_KERNEL):
            for name in counts:
                counts[name] = 0


def launched(err: int, name: str, kernel: str | None = None) -> None:
    """Called by a wrapper right after its launch with the C function's
    ``cudaGetLastError()``: raises if the launch failed, else counts it
    (and ``kernel``, a gather's kernel, in ``KERNEL_TOTALS`` and in the
    one of ``PACKED_LAUNCHES``, ``RAW_LAUNCHES`` and ``ELEMS_LAUNCHES``
    that names it, if any)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    with _launch_lock:
        LAUNCHES[name] += 1
        if kernel is not None:
            KERNEL_TOTALS[kernel] = KERNEL_TOTALS.get(kernel, 0) + 1
            for counts in _BY_KERNEL:
                if kernel in counts:
                    counts[kernel] += 1


# the active op recorder (analysis.op_lint.OpRecorder), and how many
# predicated branches enclose the current call
_RECORDER = contextvars.ContextVar("qt_op_recorder", default=None)
_GATE = contextvars.ContextVar("qt_gate_depth", default=0)


@contextlib.contextmanager
def gated():
    """Mark the reads inside as a predicated branch's. Where the JAX
    package branches with ``lax.cond``, the port runs both branches and
    predicates the ids of the one not taken (-1 ids read nothing); the
    reads inside this block are that branch's, at one more depth for the
    op recorder's budget rule, as reads inside a ``lax.cond`` branch are
    for the jaxpr rules."""
    token = _GATE.set(_GATE.get() + 1)
    try:
        yield
    finally:
        _GATE.reset(token)


def gate_depth() -> int:
    """How many :func:`gated` blocks enclose the current call."""
    return _GATE.get()


def recorded(name: str):
    """Decorator for a kernel wrapper: while an op recorder is active
    the call is handed to it whole (``recorder.kernel_call(name, fn,
    args, kwargs)``), else it runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            rec = _RECORDER.get()
            if rec is None:
                return fn(*args, **kwargs)
            return rec.kernel_call(name, fn, args, kwargs)
        return inner
    return wrap


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only on a machine "
            "with the CUDA toolkit")
    return nvcc


def _target(name: str) -> tuple[Path, Path]:
    """The source and its library's path. The hash covers the source,
    every header beside it and the flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when the library is built."""
    src, lib = _target(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, time.perf_counter()


def _finish(name: str, job):
    """Wait for one ``nvcc``; the error message if it failed."""
    if job is None:
        return None
    proc, tmp, lib, t0 = job
    out, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = out
    if proc.returncode != 0:
        return f"nvcc failed for {name}.cu:\n{out}"
    os.replace(tmp, lib)
    return None


def build(names) -> None:
    """Compile the named sources, one ``nvcc`` each, all at once; every
    ``nvcc`` has ended when this returns or raises."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        errors = [_finish(n, job) for n, job in jobs.items()]
    errors = [e for e in errors if e is not None]
    if errors:
        raise RuntimeError("\n".join(errors))


class _LoadedLibraries:
    """The loaded kernel libraries seen as an executable cache:
    ``_cache_size()`` counts them, the hook ``StepStats.watch_compiles``
    and ``TelemetryHub.watch_compiles`` read (the JAX package hands them
    its jitted functions)."""

    def _cache_size(self) -> int:
        return len(_loaded)


loaded_libraries = _LoadedLibraries()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_target(name)[1]))
        return _loaded[name]
