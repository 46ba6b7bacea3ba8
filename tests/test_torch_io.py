"""The port's parallel-IO reads (``quiver_tpu_torch/io.py``) against the
JAX package's (``quiver_tpu/io.py``), on the same numpy inputs from a
seed: the extent plans, alignment and coalescing factor equal; the
``ExtentReader`` equal to ``mm[rows]`` and to JAX's reader (rows and
stats) for the probed, buffered and modelled engines; the
``StorageModel``'s charges equal; the ``io.read`` and ``io.slow`` fault
sites retrying and falling back as JAX's do under the same plan; and
the reader's refusals and lifecycle."""

import threading

import numpy as np
import pytest

from quiver_tpu import faults as jfaults
from quiver_tpu import io as jio
from quiver_tpu_torch import faults
from quiver_tpu_torch import io

ROWS, DIM = 2000, 24


@pytest.fixture(scope="module")
def mm_file(tmp_path_factory):
    arr = np.random.default_rng(3).integers(
        -128, 127, (ROWS, DIM)).astype(np.int8)
    p = str(tmp_path_factory.mktemp("io") / "rows.npy")
    np.save(p, arr)
    return p, arr


def _row_sets(seed):
    g = np.random.default_rng(seed)
    return [np.unique(g.integers(0, ROWS, 300)),
            np.arange(100, 164),                  # one run
            np.concatenate([np.arange(5, 40), np.arange(41, 45),
                            np.arange(900, 1900, 7)]),
            np.array([0]), np.array([ROWS - 1]), np.array([], np.int64)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("row_bytes,cap", [(1, 1), (24, 512), (100, 1 << 20),
                                           (4096, 4096), (400, 300)])
def test_extent_math_equals_jax(seed, row_bytes, cap):
    for rows in _row_sets(seed):
        got = io.plan_extents(rows, row_bytes, cap)
        want = jio.plan_extents(rows, row_bytes, cap)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert int(got[:, 1].sum()) == rows.size
        assert io.coalescing_factor(rows.size, len(got)) == \
            jio.coalescing_factor(rows.size, len(want))
    g = np.random.default_rng(seed)
    for off, length in zip(g.integers(0, 1 << 30, 50),
                           g.integers(1, 1 << 22, 50)):
        for align in (1, 512, 4096):
            assert io.align_extent(int(off), int(length), align) == \
                jio.align_extent(int(off), int(length), align)


def test_extent_math_refusals():
    for mod in (io, jio):
        with pytest.raises(ValueError, match="sorted unique"):
            mod.plan_extents(np.array([3, 2]), 4)
        with pytest.raises(ValueError, match="sorted unique"):
            mod.plan_extents(np.array([2, 2]), 4)
        with pytest.raises(ValueError, match="alignment"):
            mod.align_extent(0, 4, 0)
    assert io.coalescing_factor(10, 0) is None
    assert io.DIRECT_ALIGNMENT == jio.DIRECT_ALIGNMENT
    assert io.DEFAULT_IO_CAP_BYTES == jio.DEFAULT_IO_CAP_BYTES
    assert io.TRANSIENT_ERRNOS == jio.TRANSIENT_ERRNOS
    assert io.IO_READ_RETRIES == jio.IO_READ_RETRIES


def _readers(mm_file, **kw):
    p, _ = mm_file
    out = []
    for mod in (io, jio):
        r = mod.ExtentReader.from_array(np.load(p, mmap_mode="r"), **kw)
        assert r is not None
        out.append(r)
    return out


@pytest.mark.parametrize("engine", ["auto", "pread"])
@pytest.mark.parametrize("qd,cap", [(1, 512), (4, 512), (8, 1 << 20)])
def test_reader_equals_mmap_and_jax(mm_file, engine, qd, cap):
    _, arr = mm_file
    r, jr = _readers(mm_file, qd=qd, io_cap_bytes=cap, engine=engine)
    try:
        assert r.engine == jr.engine
        for rows in _row_sets(qd):
            out, st = r.read_rows(rows)
            jout, jst = jr.read_rows(rows)
            assert out.dtype == arr.dtype
            np.testing.assert_array_equal(out, arr[rows])
            np.testing.assert_array_equal(out, jout)
            # the observed queue depth depends on thread timing at qd > 1
            keys = [k for k in st if k != "depth_peak" or qd == 1]
            assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
            assert 0 <= st["depth_peak"] <= qd
    finally:
        r.close()
        jr.close()


def test_modelled_reader_equals_jax(mm_file):
    p, arr = mm_file
    r = io.ExtentReader.from_array(np.load(p, mmap_mode="r"), qd=8,
                                   model=io.StorageModel(1, qd=8))
    jr = jio.ExtentReader.from_array(np.load(p, mmap_mode="r"), qd=8,
                                     model=jio.StorageModel(1, qd=8))
    try:
        rows = _row_sets(5)[0]
        out, st = r.read_rows(rows)
        jout, jst = jr.read_rows(rows)
        np.testing.assert_array_equal(out, arr[rows])
        assert st == jst and st["depth_peak"] == min(8, st["extents"])
        assert r.model.requests == jr.model.requests == st["extents"]
    finally:
        r.close()
        jr.close()


def test_storage_model_charges_equal_jax():
    for kw in ({"service_us": 3.0, "qd": 4},
               {"service_us": 1.0, "qd": 1, "bw_mbps": 2000.0}):
        m, jm = io.StorageModel(**kw), jio.StorageModel(**kw)
        for nbytes in (0, 4096, 1 << 20):
            assert m._cost_s(nbytes) == jm._cost_s(nbytes)
        for mod_m in (m, jm):
            mod_m.request(nbytes=4096, n=3)
            mod_m.request_deep(5, nbytes=512)
            mod_m.request_deep(0)
        assert m.requests == jm.requests == 8
        assert m.busy_s == pytest.approx(jm.busy_s, rel=0, abs=0)
    for mod in (io, jio):
        with pytest.raises(ValueError, match="queue depth"):
            mod.StorageModel(10, qd=0)


def test_reader_refusals_and_lifecycle(mm_file, tmp_path):
    p, arr = mm_file
    assert io.ExtentReader.from_array(np.zeros((4, 4))) is None
    assert io.ExtentReader.from_array(np.zeros(16)) is None
    mm = np.load(p, mmap_mode="r")
    assert io.ExtentReader.from_array(mm[2:]) is None      # a view
    with pytest.raises(ValueError, match="unknown io engine"):
        io.ExtentReader(p, np.int8, (ROWS, DIM), 128, engine="nope")
    with pytest.raises(ValueError, match="queue depth"):
        io.ExtentReader(p, np.int8, (ROWS, DIM), 128, qd=0)

    class Wrap:                       # attributes forwarded to a memmap
        def __init__(self, m):
            self._m = m

        def __getattr__(self, name):
            return getattr(self._m, name)

    with io.ExtentReader.from_array(Wrap(mm), qd=3) as r:
        np.testing.assert_array_equal(r.read_rows(np.arange(0, 600, 2))[0],
                                      arr[0:600:2])
        assert "open" in repr(r)
    assert r.closed and "closed" in repr(r)
    r.close()                                              # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        r.read_rows(np.arange(4))
    assert not [t for t in threading.enumerate()
                if t.name.startswith("qt-io-reader") and t.is_alive()]
    # a forced O_DIRECT engine never degrades quietly: it is direct or
    # it raises (tmpfs refuses O_DIRECT reads)
    f = str(tmp_path / "direct.npy")
    np.save(f, np.zeros((16, 4), np.int8))
    try:
        rd = io.ExtentReader.from_array(np.load(f, mmap_mode="r"),
                                        engine="direct")
    except OSError:
        return
    assert rd.engine == "direct"
    rd.close()


@pytest.mark.parametrize("spec", [
    "io.read:error,errno=EINTR,rate=0.5",
    "io.read:error,errno=EIO",                      # every attempt fails
    "io.read:error,errno=ENOSPC,times=3",           # permanent: no retry
    "io.slow:delay,delay_ms=1.0,rate=0.5"])
def test_io_fault_sites_behave_as_jax(mm_file, spec):
    """Under one plan armed in both packages, with one reader thread (so
    the sites are visited in one order), the port's reader returns the
    exact rows, and its retries, fallbacks and fired faults equal
    JAX's."""
    _, arr = mm_file
    rows = np.arange(0, 600, 3, dtype=np.int64)
    r, jr = _readers(mm_file, qd=1, io_cap_bytes=64)
    faults.install(faults.parse_spec(spec, seed=5))
    jfaults.install(jfaults.parse_spec(spec, seed=5))
    try:
        out, st = r.read_rows(rows)
        jout, jst = jr.read_rows(rows)
        fired, jfired = faults.drain_injected(), jfaults.drain_injected()
    finally:
        faults.disarm()
        jfaults.disarm()
        r.close()
        jr.close()
    np.testing.assert_array_equal(out, arr[rows])
    np.testing.assert_array_equal(jout, arr[rows])
    assert st == jst and fired == jfired and fired > 0
    if "EIO" in spec:
        assert st["fallback_extents"] == st["extents"] > 0
        assert st["retries"] == st["extents"] * io.IO_READ_RETRIES


def test_failed_fallback_raises_naming_the_extent(mm_file, tmp_path):
    r = io.ExtentReader.from_array(np.load(mm_file[0], mmap_mode="r"),
                                   qd=2)
    r._mm = None
    r.path = str(tmp_path / "gone.npy")             # the fallback fails too
    faults.install(faults.parse_spec("io.read:error,errno=EIO"))
    try:
        with pytest.raises(OSError, match=r"extent \(start_row="):
            r.read_rows(np.arange(40, dtype=np.int64))
    finally:
        faults.disarm()
        r.close()
