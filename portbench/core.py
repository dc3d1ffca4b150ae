"""The harness: finds a cell's files by name, runs the cell, and builds the
result line.

A cell ``<cell>`` is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``; both folders under ``root``, this folder unless a
test gives another) and its traffic kind, whose generator is
``traffic/<kind>.py`` (``run(ctx) -> Outcome``). The metrics a cell reports
are those of ``BENCHMARK.json`` (beside this folder) whose ``workloads``
list holds the cell, or that have none: the end-to-end ones from the
traffic's outcome (``setup_s`` from the harness), and in a traced run the
per-layer ones, each read by ``layer_metrics/<metric>.py``'s ``read(rec)``
from the traced window. A reader that finds nothing returns None, and the
metric is left out of the line. A configuration names its family's plain
reference, ``reference/<name>.py`` (``param_shapes(cfg)``). Traffic kinds,
readers and references are looked for under ``root`` first, then here.
Adding a cell, a configuration, a family, a traffic mix or a per-layer
metric adds files; no file here changes.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

from portbench import trace as tracing

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "jckx")  # top-level module names, compared whole


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Tuple[dict, dict]:
    """→ (the workload file of ``name``, its configuration file)."""
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (root / "workloads").glob("*.json"))
        raise SystemExit(f"portbench: no workload {name!r} (known: {', '.join(known)})")
    wl = load_json(path)
    return wl, load_json(root / "configs" / f"{wl['config']}.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _source(root: Path, folder: str, name: str) -> Path:
    """``<root>/<folder>/<name>.py``, else this folder's."""
    path = root / folder / f"{name}.py"
    return path if path.is_file() else ROOT / folder / f"{name}.py"


def traffic(kind: str, root: Path = ROOT):
    return load_module(_source(root, "traffic", kind), f"portbench_traffic_{kind}")


def reader(metric: str, root: Path = ROOT) -> Callable:
    mod = load_module(_source(root, "layer_metrics", metric),
                      "portbench_metric_" + metric.replace(".", "_"))
    return mod.read


def reference(cfg: dict, root: Path = ROOT):
    """The configuration's plain reference module, ``reference/<its
    "reference">.py``; this folder's is the package's own module."""
    name = cfg["reference"]
    path = _source(root, "reference", name)
    if path.parent == ROOT / "reference":
        return importlib.import_module(f"portbench.reference.{name}")
    return load_module(path, f"portbench_reference_{name}")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"portbench:{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclass
class Outcome:
    """What a traffic kind's ``run`` hands back."""

    e2e: Dict[str, float]                       # end-to-end metrics, setup_s aside
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]      # name → (value, limit): value ≤ limit
    memory_peak: int
    answered: bool = True                       # every answer due came, and said its shape
    counts: Dict[str, float] = field(default_factory=dict)  # for the per-layer readers
    facts: Dict[str, float] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)          # earlier lines for standard error
    numbers: Dict[str, float] = field(default_factory=dict)  # all the judge's, compared or not


class Context:
    """One run of a cell: its files, seed, window and device."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device,
                 t0: float, root: Path = ROOT):
        import torch

        self.name, self.seed, self.trace, self.t0, self.root = name, seed, trace, t0, root
        self.workload, self.config = load_cell(name, root)
        self.seconds = min(seconds, self.workload["trace_seconds"]) if trace else seconds
        self.device = torch.device(device)
        self.setup_s: Optional[float] = None
        self.setup_parts: Dict[str, float] = {}  # set-up's parts worth reading apart
        self.window_trace: Optional[tracing.Trace] = None
        self.tmp = tempfile.mkdtemp(prefix="portbench-")

    def seed_for(self, tag: str) -> int:
        return sub_seed(self.seed, tag)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        """Set-up ends where the first timed unit of work starts."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t0

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    @contextlib.contextmanager
    def window(self):
        """The measured window: profiled in a traced run, its trace kept."""
        with tracing.traced(self.tmp, self.sync, self.trace) as holder:
            yield
        self.window_trace = holder.trace

    def span(self, what: str):
        return tracing.span(what, self.trace)

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def limited(ctx: Context, numbers: Dict[str, float]) -> Dict[str, Tuple[float, float]]:
    """The numbers the cell's workload file limits, each beside its limit
    (the others are printed on standard error)."""
    return {k: (numbers[k], float(lim)) for k, lim in ctx.workload["limits"].items()}


def cell_metrics(spec: dict, section: str, cell: str) -> List[dict]:
    return [m for m in spec[section] if "workloads" not in m or cell in m["workloads"]]


def device_info(device) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             spec: dict, root: Path = ROOT) -> Tuple[dict, List[str]]:
    """→ (the result line's object, the lines for standard error)."""
    ctx = Context(name, seed, seconds, trace, device, t0, root)
    ctx.setup_parts["start_s"] = time.perf_counter() - t0  # torch and CUDA up
    try:
        out: Outcome = traffic(ctx.workload["traffic"], root).run(ctx)
    finally:
        ctx.close()
    passed = (out.answered and out.failed == 0
              and all(v <= lim for v, lim in out.checks.values()))  # NaN fails
    metrics, breakdown, tr = {}, None, ctx.window_trace
    if not trace:
        for m in cell_metrics(spec, "end_to_end", name):
            value = ctx.setup_s if m["name"] == "setup_s" else out.e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rec = SimpleNamespace(trace=tr, counts=out.counts, facts=out.facts,
                              workload=ctx.workload, config=ctx.config)
        for m in cell_metrics(spec, "per_layer", name):
            value = reader(m["name"], root)(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {**device_info(ctx.device), "memory_peak_bytes": out.memory_peak}
    if trace:
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = tr.breakdown()
    line = {"correct": bool(passed), "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if ctx.setup_parts:
        line["setup_parts"] = dict(ctx.setup_parts)
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    if not out.answered:
        line["checks"]["answers_missing_or_malformed"] = {"value": 1, "limit": 0}
    err = list(out.notes) + [f"setup part {k}: {v!r}" for k, v in ctx.setup_parts.items()]
    err += [f"{k}: {v!r} (not compared)" for k, v in out.numbers.items()
            if k not in out.checks]
    err += [f"check {k}: {v!r} (limit {lim!r}){'' if v <= lim else '  FAILED'}"
            for k, (v, lim) in out.checks.items()]
    if not out.answered:
        err.append("check answers_missing_or_malformed: 1 (limit 0)  FAILED")
    return line, err

