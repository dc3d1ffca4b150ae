"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain ``extern "C"`` entry and compiles
on its own into ``build/lib<name>-<hash>.so`` beside this file (listed in
``.gitignore``). The first use of any of them builds every source that
has no library yet, one ``nvcc`` each, all started together, so a process
waits for one build however many kernels it goes on to launch (the
fine-tune launches the normalize kernel in its forward and the backward's
kernels after it). The hash covers the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source builds anew and a stale library is never loaded.
The sources include no PyTorch header: a build takes seconds, where
``torch.utils.cpp_extension.load`` takes minutes. Same pattern as the
JAX package's native IO library (``native/`` + ``jckx/data/native_io.py``),
but without its fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
# -Xptxas=-v writes each kernel's registers, shared memory and spills into
# the build log beside the library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# a local mesh's worker threads may make a kernel's first launch at once
_load_lock = threading.Lock()


def sources() -> list:
    """Names of every kernel source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc was not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's CUDA kernels are built from source")
    return found


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every header beside it, which a source may include
    for f in [name + ".cu"] + sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            digest.update(src.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile each named source (default: all) that has no library yet:
    one ``nvcc`` per source, all started together. Waits for every one
    and raises if any failed. → {name: library path}."""
    names = list(sources() if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, so in todo.items():
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        with open(todo[name] + ".log", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"nvcc exited {proc.returncode} on {name}.cu:\n{out}")
            continue
        os.replace(tmp, todo[name])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, first building every source
    that has no library yet, in one ``build`` (one build at a time in this
    process)."""
    with _load_lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build()[name])
        return _loaded[name]
