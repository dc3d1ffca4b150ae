"""Environment readiness check: ``python -m jckx_torch doctor`` — port of
``jckx/doctor.py:79-224``.

One JSON report answering "can this machine train and serve with the
port, and is its card healthy right now?". Each check is independent; a
failure is reported, never raised, and the card-touching checks run in a
thread with a timeout (``_boxed``): a doctor that hangs on a wedged card
is useless.

- backend: torch and CUDA versions, device count, the card's name and
  compute capability, and its name and power limit as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` reads them;
- link: a host→device put and a blocking device→host read, cold (the
  process's first) and steady;
- kernel (jckx's ``compile`` check): build ``fused_bn_act`` from its
  source (``kernels/_build.py``), launch it once, and its max abs error
  against ``normalize_act_plain``;
- toolchain: ``nvcc --version``, CUTLASS's include path, ``import triton``;
- native_io: whether the C++ I/O core (``data/native_io.py``, built from
  ``native/jckx_io.cpp``) loads, and why not when the numpy fallback is
  active (jckx's ``:150-161``);
- datasets and backbone: the archives under ``--data_dir`` and a
  fine-tuned metric backbone under ``<save_root>/iception_v3``, as in jckx.

Exit 0 when the backend and the kernel pass (the port can run), 1
otherwise; on a host without a card the report carries the backend's
error and stops there, as jckx's does. ``--link_only`` (jckx's fast
preflight, ``jckx/doctor.py:128-131``) stops after the backend and link
checks and exits 0 when both ran.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

_PROBE_THREAD_NAME = "jckx-torch-doctor-probe"
CUTLASS_INCLUDE = "/usr/local/cutlass/include"


def _boxed(fn, timeout_s: float) -> dict:
    """→ ``fn()``'s dict, or {"error": ...} on a raise or a timeout."""
    box: dict = {}

    def _run():
        try:
            box.update(fn())
        except Exception as e:  # noqa: BLE001 — the report is the channel
            box["error"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=_run, daemon=True, name=_PROBE_THREAD_NAME)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        return {"error": f"still blocked after {timeout_s:.0f}s — treat the card as sick; "
                         f"do not trust timings"}
    return box


def _hard_exit_needed() -> bool:
    """True when a timed-out probe thread is still blocked in native code:
    the caller then exits with ``os._exit`` after the report."""
    return any(t.name == _PROBE_THREAD_NAME and t.is_alive() for t in threading.enumerate())


def _command(cmd, timeout_s: float = 60.0) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, check=True)
    return out.stdout.strip()


def _backend() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(f"torch {torch.__version__} sees no CUDA device "
                           f"(torch.cuda.is_available() is false)")
    cap = torch.cuda.get_device_capability(0)
    info = {"platform": "cuda", "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda, "device_count": torch.cuda.device_count(),
            "device_kind": torch.cuda.get_device_name(0),
            "compute_capability": f"{cap[0]}.{cap[1]}"}
    try:
        info["nvidia_smi"] = _command(["nvidia-smi", "--query-gpu=name,power.limit",
                                       "--format=csv,noheader"]).splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = f"{type(e).__name__}: {e}"
    return info


def _link() -> dict:
    import torch

    reads = []
    for fill in (1.0, 2.0):  # the first read rides a cold context
        a = torch.full((8, 8), fill, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(a[0, 0])
        reads.append(round(time.perf_counter() - t0, 4))
    return {"cold_read_s": reads[0], "read_s": reads[1]}


def _kernel() -> dict:
    import torch

    from jckx_torch.kernels import _build
    from jckx_torch.kernels import fused_bn_act as fba

    t0 = time.perf_counter()
    _build.build(["fused_bn_act"])
    build_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4096, 256, generator=g, device="cuda")
    inv = torch.rand(256, generator=g, device="cuda") + 0.5
    shift = torch.randn(256, generator=g, device="cuda")
    y = fba.normalize_act(x, inv, shift, "relu")
    err = (y - fba.normalize_act_plain(x, inv, shift, "relu")).abs().max().item()
    return {"ok": bool(err <= 1e-5), "kernel": "fused_bn_act", "build_s": round(build_s, 2),
            "max_abs_err_vs_plain": err, "shape": [4096, 256], "dtype": "float32"}


def _toolchain() -> dict:
    out: dict = {}
    try:
        from jckx_torch.kernels._build import find_nvcc

        out["nvcc"] = _command([find_nvcc(), "--version"]).splitlines()[-1]
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        out["nvcc"] = f"{type(e).__name__}: {e}"
    out["cutlass_include"] = CUTLASS_INCLUDE if os.path.isdir(CUTLASS_INCLUDE) else None
    try:
        import triton

        out["triton"] = triton.__version__
    except ImportError as e:
        out["triton"] = f"ImportError: {e}"
    return out


def _native_io() -> dict:
    from jckx_torch.data import native_io

    ok = native_io.available()
    return {"available": ok, "library": native_io.library_path() if ok else None,
            "note": None if ok else
            f"numpy fallback active ({native_io.fallback_reason()}) — correct but slower for "
            f"host-streaming datasets"}


def run_checks(data_dir: str = "./data", probe_timeout_s: float = 60.0,
               save_root: str = "./save", link_only: bool = False) -> dict:
    """→ the report; never raises."""
    report: dict = {"ok": False}
    backend = _boxed(_backend, probe_timeout_s)
    report["backend"] = backend
    if "error" in backend:
        return report
    link = _boxed(_link, probe_timeout_s)
    if "read_s" in link:
        link["healthy"] = bool(link["read_s"] < 2.0)
    report["link"] = link
    if link_only:
        report["ok"] = bool(backend.get("device_count") and "read_s" in link)
        return report
    # the build gets its own window: nvcc takes seconds, a cold card longer
    kernel = _boxed(_kernel, max(probe_timeout_s, 180.0))
    kernel.setdefault("ok", False)
    report["kernel"] = kernel
    report["toolchain"] = _boxed(_toolchain, probe_timeout_s)
    report["native_io"] = _native_io()
    archives = {"cifar100": ("cifar-100-python.tar.gz", "cifar-100-python"),
                "cifar10": ("cifar-10-python.tar.gz", "cifar-10-batches-py"),
                "mnist": ("train-images-idx3-ubyte.gz", "train-images-idx3-ubyte")}
    report["datasets"] = {
        **{name: any(os.path.exists(os.path.join(data_dir, p)) for p in paths)
           for name, paths in archives.items()},
        "synthetic_fallback": True, "data_dir": os.path.abspath(data_dir)}
    bdir = os.path.join(save_root, "iception_v3")  # (sic) the reference's path
    found = [f for f in ("loss_bset.npz", "loss_bset.pt") if os.path.exists(os.path.join(bdir, f))]
    report["metric_backbone"] = {
        "found": found,
        "note": None if found else
        "no fine-tuned backbone — Metrics uses the seeded random init (FID / IS run; "
        "absolutes not comparable across stacks)"}
    report["ok"] = bool(backend.get("device_count") and kernel["ok"])
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="jckx_torch environment readiness check (JSON on stdout)")
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--save_root", default="./save")
    p.add_argument("--probe_timeout", type=float, default=60.0,
                   help="seconds before a card probe is declared blocked")
    p.add_argument("--link_only", action="store_true",
                   help="backend + link probe only (fast preflight)")
    args = p.parse_args(argv)
    report = run_checks(args.data_dir, args.probe_timeout, args.save_root, args.link_only)
    print(json.dumps(report, indent=2))
    code = 0 if report["ok"] else 1
    if _hard_exit_needed():
        # a probe thread is stuck in the driver; teardown could hang on it
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
