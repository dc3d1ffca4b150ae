"""Spans at the port's layer boundaries, on the profiler's clock.

``span(name, n)`` marks one stretch of host work at a layer boundary: a
served request and its batches' renders and drains, a train launch and its
steps' feeds and replays, a graph's capture. Spans are on only while a
``torch.profiler`` records (an operator's ``train --profile_dir``, or any
profiled window), in the thread it records: torch's profiler follows the
thread that started it, so a local mesh's workers record spans only where
they profile themselves. Then each span also opens
``record_function("jckx_torch.<name>")``, so the Chrome trace shows it
beside the aten ops and kernels it enclosed, and its record is kept in
memory (the last ``CAPACITY``): ``recorded()`` returns them, ``clear()``
drops them, ``child_ns`` sums a span's children by name. Off, ``span``
costs one check of the profiler's flag and returns one shared no-op
context.

A record holds its name (with the prefix), start and end from
``time.perf_counter_ns()``, its id, its parent's id (0 for a root) and its
root's id, from a stack per thread, and ``n``: the work units at that
boundary (images, batches, steps).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple

import torch
from torch.autograd.profiler import record_function

PREFIX = "jckx_torch."
CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int  # 0: a root
    root: int
    n: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


_profiling = torch._C._autograd._profiler_enabled  # true while a profiler records
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The shared context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _On:
    __slots__ = ("name", "n", "id", "parent", "root", "start", "rf")

    def __init__(self, name: str, n: int):
        self.name, self.n = name, n

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent, self.root = (up.id, up.root) if up else (0, self.id)
        stack.append(self)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _local.stack.pop()
        _records.append(Span(self.name, self.start, end, self.id, self.parent, self.root, self.n))
        return False


def span(name: str, n: int = 0):
    """A context marking ``jckx_torch.<name>`` over ``n`` work units: recorded
    while a profiler records, else the shared no-op ``OFF``."""
    if not _profiling():
        return OFF
    return _On(PREFIX + name, n)


def recorded() -> List[Span]:
    """A copy of the kept spans, in the order they ended."""
    return list(_records)


def clear() -> None:
    _records.clear()


def child_ns(spans: Iterable[Span], parent: str, child: str) -> Dict[int, int]:
    """For each span named ``parent`` (without the prefix), the summed
    durations of its direct children named ``child``: {its id: ns}."""
    spans = list(spans)
    out = {s.id: 0 for s in spans if s.name == PREFIX + parent}
    for s in spans:
        if s.name == PREFIX + child and s.parent in out:
            out[s.parent] += s.ns
    return out
