"""Build and load the port's CUDA kernels.

Each source under ``quiver_tpu_torch/csrc/`` is compiled by ``nvcc`` into
a shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The build happens at
first use, into ``build/quiver_tpu_torch/`` beside the package; the file
name carries a hash of the source and the flags, so an edited source
never loads a stale library. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "quiver_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}
# what ``nvcc -Xptxas -v`` said for each source (registers, spills)
build_logs: dict = {}


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
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}_{digest[:16]}.so"


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
    return proc, tmp, lib


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, lib = job
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, lib)


def build(names) -> None:
    """Compile the named sources, one ``nvcc`` each, all at once."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            _finish(n, job)


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
