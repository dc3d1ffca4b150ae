"""The port's binding of the C++ I/O core (``jckx_torch/data/native_io.py``)
against jckx's (``jckx/data/native_io.py``): cache bytes under both of
jckx's engines, each package reading the other's file, the corrupt-header
cases of ``tests/test_native_io.py``, the shuffle, the three gathers, and
where the port builds its library.

jckx's binding builds ``native/libjckx_io.so`` with ``make`` on first use;
another worker may be doing that for ``tests/test_native_io.py``. So
jckx's engine is chosen here by patching its ``_load``: "native" hands it
the port's library (built from the same ``native/jckx_io.cpp``), "numpy"
hands it None (its fallback). Equality is exact throughout.
"""

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from jckx.data import native_io as jio
from jckx_torch.data import native_io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["native", "numpy"])
def jckx_engine(request, monkeypatch):
    lib = tio._load() if request.param == "native" else None
    assert request.param == "numpy" or lib is not None, tio.fallback_reason()
    monkeypatch.setattr(jio, "_load", lambda: lib)
    return request.param


def _set(n=37, shape=(8, 8, 3), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=(n, *shape)).astype(np.uint8),
            rng.randint(0, 100, size=n).astype(np.int32))


def test_library_builds_in_the_ports_build_dir():
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    assert tio.available(), tio.fallback_reason()
    path = tio.library_path()
    assert os.path.isfile(path) and tio.engine() == "native" and tio.fallback_reason() is None
    assert os.path.dirname(path) == os.path.join(REPO, "jckx_torch", "kernels", "build")
    assert os.path.basename(path).startswith("libjckx_io-") and path.endswith(".so")
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before


@pytest.mark.parametrize("port_engine", ["native", "numpy"])
def test_cache_bytes_equal_jckx_and_each_reads_the_other(tmp_path, jckx_engine, port_engine,
                                                         monkeypatch):
    imgs, labels = _set()
    ours, ref = str(tmp_path / "port.bin"), str(tmp_path / "jckx.bin")
    if port_engine == "numpy":
        monkeypatch.setattr(tio, "_load", lambda: None)
    tio.cache_write(ours, imgs, labels)
    jio.cache_write(ref, imgs, labels)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    assert os.path.getsize(ours) == 32 + 37 * (8 * 8 * 3 + 4)
    for reader, path in ((tio.cache_open, ref), (jio.cache_open, ours)):
        x, y = reader(path)
        np.testing.assert_array_equal(x, imgs)
        np.testing.assert_array_equal(y, labels)
    x, y = tio.cache_open(ours)
    assert not x.flags.writeable and not y.flags.writeable  # a read-only mapping


def _corrupt_cases():
    # header: magic u64 | n i64 | h i32 | w i32 | c i32 | reserved i32
    cases = [("garbage", None, None), ("missing", None, None)]
    cases += [(f"n={n}", 8, struct.pack("<q", n if n < (1 << 63) else n - (1 << 64)))
              for n in (-1, 0, 1 << 62, (1 << 64) - 8)]
    cases += [(f"dim@{off}={v}", off, struct.pack("<i", v))
              for off, v in ((16, -4), (20, 1 << 30), (24, 0))]
    return cases


@pytest.mark.parametrize("port_engine", ["native", "numpy"])
@pytest.mark.parametrize("case,off,patch", _corrupt_cases(), ids=[c[0] for c in _corrupt_cases()])
def test_cache_open_rejects_what_jckx_rejects(tmp_path, monkeypatch, port_engine, case, off, patch):
    if port_engine == "numpy":
        monkeypatch.setattr(tio, "_load", lambda: None)
    good = str(tmp_path / "good.bin")
    tio.cache_write(good, *_set(8, (4, 4, 3), seed=5))
    bad = str(tmp_path / "bad.bin")
    if case == "garbage":
        open(bad, "wb").write(b"not a cache file at all, definitely too short?" * 2)
    elif case != "missing":
        raw = bytearray(open(good, "rb").read())
        raw[off:off + len(patch)] = patch
        open(bad, "wb").write(bytes(raw))
    assert tio.cache_open(bad) is None
    assert tio.cache_open(good) is not None  # the checks are not over-eager


@pytest.mark.parametrize("n,seed", [(1000, 7), (1, 3), (4096, 0), (37, 12345)])
def test_shuffle_equals_jckx(n, seed, jckx_engine, monkeypatch):
    if jckx_engine == "numpy":
        monkeypatch.setattr(tio, "_load", lambda: None)
    got = tio.shuffle_indices(n, seed)
    np.testing.assert_array_equal(got, jio.shuffle_indices(n, seed))
    assert got.dtype == np.int32 and sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("workers", [1, 4])
def test_gathers_equal_numpy_indexing(workers):
    imgs, _ = _set(200, (6, 6, 3), seed=2)
    idx = np.random.RandomState(3).randint(0, 200, size=133).astype(np.int32)
    np.testing.assert_array_equal(tio.gather_rows(imgs, idx), imgs[idx])
    slab = np.zeros((150, 6, 6, 3), np.uint8)
    tio.gather_rows_into(imgs, idx, slab[10:143])  # into a contiguous slice
    np.testing.assert_array_equal(slab[10:143], imgs[idx])
    assert not slab[:10].any() and not slab[143:].any()
    with ThreadPoolExecutor(workers) as pool:
        np.testing.assert_array_equal(tio.gather_rows_mt(imgs, idx, workers, pool=pool), imgs[idx])
        out = np.empty((133, 6, 6, 3), np.uint8)
        assert tio.gather_rows_mt(imgs, idx, workers, pool=pool, out=out) is out
        np.testing.assert_array_equal(out, imgs[idx])
    ro = imgs.copy()
    ro.flags.writeable = False  # the cache's views: a read-only source gathers fine
    np.testing.assert_array_equal(tio.gather_rows(ro, idx), imgs[idx])
    with pytest.raises(ValueError, match="writable"):
        tio.gather_rows_into(imgs, idx, ro[:133])
    with pytest.raises(IndexError):
        tio.gather_rows(imgs, np.array([200], np.int32))


def test_gather_pool_under_more_workers_than_cores():
    """Sixteen gather threads, each copying its slice, with the interpreter
    switching threads every microsecond: every slab equals numpy's."""
    import sys

    imgs, _ = _set(300, (8, 8, 3), seed=6)
    rng = np.random.RandomState(7)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            for _ in range(40):
                idx = rng.randint(0, 300, size=rng.randint(32, 300)).astype(np.int32)
                np.testing.assert_array_equal(tio.gather_rows_mt(imgs, idx, 16, pool=pool),
                                              imgs[idx])
    finally:
        sys.setswitchinterval(interval)


def test_doctor_reports_native_io_and_the_fallback(monkeypatch):
    from jckx_torch import doctor

    report = doctor._native_io()
    assert report == {"available": True, "library": tio.library_path(), "note": None}
    monkeypatch.setattr(tio, "_lib", None)
    monkeypatch.setattr(tio, "_why_not", "OSError: no C++ compiler (g++, or $CXX) on PATH")
    report = doctor._native_io()
    assert report["available"] is False and report["library"] is None
    assert "numpy fallback active (OSError: no C++ compiler" in report["note"]
    assert tio.engine().startswith("numpy fallback (OSError: no C++ compiler")
