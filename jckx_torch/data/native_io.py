"""ctypes binding of the repo's C++ I/O core (``native/jckx_io.cpp``) — port
of ``jckx/data/native_io.py``.

The same library, the same calls and the same semantics as jckx's binding
(``:68-200``): the flat dataset cache (a 32-byte header, uint8 NHWC images,
int32 labels; written once after an archive parse, then mapped with no
copy), the seeded Fisher–Yates shuffle, and the gather of rows into one
contiguous slab, serial or split over a thread pool (the ctypes call drops
the GIL, so the workers copy in parallel).

The build is the port's own: ``g++ -O3 -fPIC -std=c++17 -shared``
(``native/Makefile``'s flags) from the checkout's ``native/jckx_io.cpp``
into ``jckx_torch/kernels/build/libjckx_io-<hash>.so``, keyed by a hash of
the source and the flags, written under a temporary name and moved into
place (``kernels/_build.py``'s pattern). It never runs ``make`` in
``native/`` and never writes ``native/libjckx_io.so``, which belongs to
the JAX package.

Where no compiler is found or the build fails, every call takes jckx's
numpy fallback (the same cache bytes, a ``RandomState`` permutation in
place of the native shuffle). ``fallback_reason()`` says why; ``doctor``
and the trainer's data-plane log line print it, and ``chip_smoke.py``
fails on the card if the library does not load.

The views ``cache_open`` returns lie over a read-only mapping and are
marked read-only: gather from them, never write to them or pin them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from jckx_torch.kernels._build import BUILD_DIR

SOURCE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native",
                                      "jckx_io.cpp"))
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_MAGIC = 0x4A434B58494F3031  # "JCKXIO01"
_HEADER = 32

_lib: Optional[ctypes.CDLL] = None
_tried = False
_why_not: Optional[str] = None
_open_handles: list = []  # native cache mappings stay alive for the process


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libjckx_io-{digest.hexdigest()[:16]}.so")


def _build() -> str:
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise OSError("no C++ compiler (g++, or $CXX) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True,
                         timeout=120)
    if out.returncode != 0:
        raise OSError(f"{os.path.basename(cxx)} exited {out.returncode}: {out.stderr.strip()}")
    os.replace(tmp, so)  # atomic: a concurrent reader never maps half a file
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _why_not
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.SubprocessError) as e:
        _why_not = f"{type(e).__name__}: {e}"
        return None
    lib.jckx_cache_write.restype = ctypes.c_int
    lib.jckx_cache_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_void_p]
    lib.jckx_cache_open.restype = ctypes.c_void_p
    lib.jckx_cache_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.jckx_cache_images.restype = ctypes.c_void_p
    lib.jckx_cache_images.argtypes = [ctypes.c_void_p]
    lib.jckx_cache_labels.restype = ctypes.c_void_p
    lib.jckx_cache_labels.argtypes = [ctypes.c_void_p]
    lib.jckx_cache_close.restype = None
    lib.jckx_cache_close.argtypes = [ctypes.c_void_p]
    lib.jckx_shuffle.restype = None
    lib.jckx_shuffle.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
    lib.jckx_gather.restype = None
    lib.jckx_gather.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def fallback_reason() -> Optional[str]:
    """Why the numpy fallback is active (None while the library loads)."""
    _load()
    return None if _lib is not None else (_why_not or "the native library is not loaded")


def engine() -> str:
    """'native' or 'numpy fallback (<reason>)', for logs and reports."""
    return "native" if available() else f"numpy fallback ({fallback_reason()})"


def cache_write(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    images = np.ascontiguousarray(images, np.uint8)
    labels = np.ascontiguousarray(labels, np.int32)
    n, h, w, c = images.shape
    lib = _load()
    if lib is not None:
        rc = lib.jckx_cache_write(path.encode(), images.ctypes.data, n, h, w, c,
                                  labels.ctypes.data)
        if rc != 0:
            raise OSError(f"jckx_cache_write failed rc={rc}")
        return
    with open(path, "wb") as f:  # the same layout as the native writer
        f.write(np.uint64(_MAGIC).tobytes())
        f.write(np.int64(n).tobytes())
        f.write(np.array([h, w, c, 0], np.int32).tobytes())
        f.write(images.tobytes())
        f.write(labels.tobytes())


def cache_open(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """→ (images uint8 NHWC, labels int32), read-only views of the mapped
    file, or None for a missing, foreign or corrupt file."""
    if not os.path.exists(path):
        return None
    lib = _load()
    if lib is not None:
        n, h, w, c = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
        handle = lib.jckx_cache_open(path.encode(), ctypes.byref(n), ctypes.byref(h),
                                     ctypes.byref(w), ctypes.byref(c))
        if not handle:
            return None
        _open_handles.append(handle)
        shape = (n.value, h.value, w.value, c.value)
        images = np.ctypeslib.as_array(
            ctypes.cast(lib.jckx_cache_images(handle), ctypes.POINTER(ctypes.c_uint8)), shape)
        labels = np.ctypeslib.as_array(
            ctypes.cast(lib.jckx_cache_labels(handle), ctypes.POINTER(ctypes.c_int32)),
            (n.value,))
        images.flags.writeable = labels.flags.writeable = False  # PROT_READ pages
        return images, labels
    with open(path, "rb") as f:
        head = f.read(28)
    if len(head) < 28 or np.frombuffer(head[:8], np.uint64)[0] != np.uint64(_MAGIC):
        return None
    n = int(np.frombuffer(head[8:16], np.int64)[0])
    h, w, c = (int(v) for v in np.frombuffer(head[16:28], np.int32))
    # the native reader's header checks: a corrupt header gives None, never
    # an exception or a view beyond the file
    if n <= 0 or h <= 0 or w <= 0 or c <= 0:
        return None
    if os.path.getsize(path) < _HEADER + n * (h * w * c + 4):  # python ints: no overflow
        return None
    images = np.memmap(path, np.uint8, "r", offset=_HEADER, shape=(n, h, w, c))
    labels = np.memmap(path, np.int32, "r", offset=_HEADER + n * h * w * c, shape=(n,))
    return np.asarray(images), np.asarray(labels)


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    idx = np.arange(n, dtype=np.int32)
    lib = _load()
    if lib is not None:
        lib.jckx_shuffle(idx.ctypes.data, n, ctypes.c_uint64(seed))
        return idx
    return np.random.RandomState(seed).permutation(n).astype(np.int32)


def gather_rows(images: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``images[idx]`` as one contiguous slab, through the native copy loop."""
    out = np.empty((len(idx),) + images.shape[1:], images.dtype)
    gather_rows_into(images, idx, out)
    return out


def gather_rows_into(images: np.ndarray, idx: np.ndarray, out: np.ndarray) -> None:
    """``images[idx]`` into ``out``: a preallocated C-contiguous slab or a
    contiguous slice of one (pool workers each fill a disjoint slice)."""
    images = np.ascontiguousarray(images)
    idx = np.ascontiguousarray(idx, np.int32)
    if not (out.flags["C_CONTIGUOUS"] and out.flags.writeable and out.shape[0] == len(idx)
            and out.shape[1:] == images.shape[1:] and out.dtype == images.dtype):
        raise ValueError(f"gather_rows_into: out {out.shape} {out.dtype} must be a writable "
                         f"C-contiguous ({len(idx)},) + {images.shape[1:]} {images.dtype} slab")
    if len(idx) and (idx.min() < 0 or idx.max() >= images.shape[0]):
        raise IndexError(f"gather_rows_into: a row outside [0, {images.shape[0]})")
    lib = _load()
    if lib is None:
        out[:] = images[idx]
        return
    lib.jckx_gather(images.ctypes.data, images.strides[0], idx.ctypes.data, len(idx),
                    out.ctypes.data)


def gather_rows_mt(images: np.ndarray, idx: np.ndarray, workers: int, pool=None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """Gather split over ``workers`` threads of ``pool``, each copying its
    slice of the slab (the role of the reference DataLoader's
    ``num_worker``, dcgan_data_preprocessor.py:69-75). ``out``, when
    given, is the slab to fill (a pinned host buffer's view). → the slab."""
    n = len(idx)
    if out is None:
        out = np.empty((n,) + images.shape[1:], images.dtype)
    workers = max(1, int(workers))
    if workers == 1 or n < 2 * workers or pool is None:
        gather_rows_into(images, idx, out)
        return out
    chunk = (n + workers - 1) // workers
    futs = [pool.submit(gather_rows_into, images, idx[a:a + chunk], out[a:a + chunk])
            for a in range(0, n, chunk)]
    for f in futs:
        f.result()
    return out
