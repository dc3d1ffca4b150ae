"""A traced window, reduced: ``torch.profiler`` over the window, its Chrome
trace read back, and from it the device's intervals, its busy time (their
union), its idle gaps, the kernels' time by name, and the benchmark's own
spans (``record_function("portbench.<what>")``) that label each gap with
what the host was doing.

Device events are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; the profiler's annotations on the device timeline
(``gpu_user_annotation``) span idle time too and are left out. Every
interval is clipped to the window, the span ``portbench.window``.
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"
GAP_US = 10.0  # idle gaps counted per step: longer than this


@dataclass
class DeviceEvent:
    name: str
    cat: str
    start: float  # µs
    end: float


@dataclass
class Trace:
    window: Tuple[float, float]                     # µs
    device: List[DeviceEvent] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def union(self) -> List[Tuple[float, float]]:
        """The device's busy intervals: the union of its events, in order."""
        out: List[Tuple[float, float]] = []
        for s, e in sorted((d.start, d.end) for d in self.device):
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals inside the window: (start µs, length µs)."""
        out, at = [], self.window[0]
        for s, e in self.union():
            if s > at:
                out.append((at, s - at))
            at = max(at, e)
        if self.window[1] > at:
            out.append((at, self.window[1] - at))
        return out

    def kernel_time(self, words: tuple) -> Tuple[float, int]:
        """(seconds, count) of the kernels whose names hold any of ``words``."""
        hit = [d for d in self.device if d.cat == "kernel" and any(w in d.name for w in words)]
        return sum(d.end - d.start for d in hit) / 1e6, len(hit)

    def span_at(self, t: float) -> str:
        """The innermost benchmark span open at ``t`` (µs)."""
        best: Optional[Tuple[str, float, float]] = None
        for name, s, e in self.spans:
            if s <= t < e and name != WINDOW and (best is None or s >= best[1]):
                best = (name, s, e)
        return best[0] if best else WINDOW

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for d in self.device:
            by_name[d.name] = by_name.get(d.name, 0.0) + (d.end - d.start) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[name[:120], secs] for name, secs in ops],
                "idle_gaps": [[self.span_at(s), length / 1e6] for s, length in gaps]}


def from_chrome(events: list) -> Trace:
    """A ``Trace`` from the ``traceEvents`` of a Chrome trace."""
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("portbench.")]
    windows = [(s, e) for name, s, e in spans if name == WINDOW]
    if not windows:
        raise ValueError(f"the trace holds no {WINDOW} span")
    lo, hi = windows[0]
    device = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            s, t = max(s, lo), min(t, hi)
            if t > s:
                device.append(DeviceEvent(str(e.get("name", "")), e["cat"], s, t))
    return Trace((lo, hi), device, [sp for sp in spans if sp[2] > lo and sp[1] < hi])


@contextlib.contextmanager
def traced(tmpdir: str, device_sync, on: bool):
    """Profile the body as the window (``on``), then read the trace back.
    → yields a holder whose ``trace`` is the ``Trace`` once the body is
    done (None when not ``on``)."""
    holder = type("Traced", (), {"trace": None})()
    if not on:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    device_sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield holder
            device_sync()
    path = os.path.join(tmpdir, "window.trace.json")
    prof.export_chrome_trace(path)
    del prof
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    holder.trace = from_chrome(events)


def span(name: str, on: bool):
    """``record_function("portbench.<name>")`` in a traced run, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(f"portbench.{name}")
