"""CUDA graphs: the card's counterpart of jckx's compiled programs.

jckx compiles each of its programs once (``jax.jit``) and dispatches it
whole; the port captures the same work once as a CUDA graph and replays it,
so a call is one graph launch with no Python op-by-op dispatch.

- ``CudaGraph``: one capture on a side stream of the device, in the
  graph's own memory pool, after an eager warm call on that stream (which
  lets cuDNN and cuBLASLt choose their algorithms for these shapes).
  ``capture_error_mode="thread_local"``: another thread (the streaming
  plane's uploader) may use the card meanwhile.
- ``EagerGraph``: the CPU's stand-in. Its capture keeps the callable and
  runs nothing, its replay runs it again, so the host logic around a graph
  runs in the CPU tests.
- ``graph_for``: where a graph runs. On a CUDA device, not under
  ``--sanitize`` (anomaly detection checks each backward function as it
  runs, eagerly by nature, as ``jax_debug_nans`` de-optimizes jckx's
  programs), and with no mesh or a mesh whose collectives can be captured:
  a NCCL process mesh with a model axis of 1, any size of data axis
  (``parallel/mesh.py``). Its all-reduces and gathers are then nodes of
  the graph, as jckx's ``jax.jit`` programs hold their collectives. gloo's
  collectives run on the host, a local mesh renders from one thread per
  device, and a model axis over NCCL has not run between two cards: there
  the work stays eager, and the caller says why.
- ``GraphedProgram``: an inference program as ``jax.jit`` runs one. It is
  keyed by its inputs' shapes and dtypes. The first call at a key runs the
  program eagerly on the capture's stream; that call is also the call's
  answer. The program is then captured into its memory pool (one for all
  its keys), reading static input tensors and writing one static output
  kept outside the pool. Each later call copies its inputs into the
  static inputs, replays, and returns a **copy** of the static output, so
  that a caller may hold several answers (serving's window of undrained
  batches) while later replays overwrite the static one. ``EagerGraph``
  keeps one static output too, so the CPU tests catch a caller that would
  hold it across replays.

The kernel wrappers count their launches in Python
(``kernels/fused_bn_act.LAUNCHES``, ``MOMENTS_LAUNCHES``, ``BWD_LAUNCHES``), and the mesh its collectives
(``ProcessMesh.stats``), neither of which a replay runs. The warm call runs
the program's Python, so its counts are the graph's: a capture takes back
what it counted (it launches nothing) and every replay adds the warm
call's counts, its collectives marked as replayed.

Over a mesh every rank warms, captures and replays at the same call, so
the ranks' collective sequences stay one; the mesh's host-side agreement
(``any``, ``agree``) runs between replays, never inside one.

A failed capture or replay raises; nothing falls back to eager calls.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from jckx_torch.kernels import fused_bn_act
from jckx_torch.utils import spans


class CudaGraph:
    """Work captured as a ``torch.cuda.CUDAGraph`` on a side stream of
    ``device``, in the graph's own memory pool."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.pool_bytes = 0  # device memory the capture reserved

    def warm(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """``fn()`` eagerly on the capture's stream, ordered after and
        before the current stream's work."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        out.record_stream(current)
        return out

    def capture(self, fn: Callable[[], object], pool=None) -> None:
        """Capture ``fn()`` into this graph's own memory pool, or into
        ``pool`` (another graph's ``pool()``)."""
        # other threads (the streaming plane's uploader) may use the card
        # meanwhile: only this thread is held to capture-safe calls
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            fn()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before
        self.graph = graph

    def pool(self):
        return self.graph.pool()

    def replay(self) -> None:
        self.graph.replay()


class EagerGraph:
    """The CPU's stand-in for ``CudaGraph``: the capture keeps ``fn`` and
    runs nothing; a replay runs it again."""

    pool_bytes = 0

    def __init__(self, device: torch.device):
        self.fn: Optional[Callable[[], object]] = None

    def warm(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        return fn()

    def capture(self, fn: Callable[[], object], pool=None) -> None:
        self.fn = fn

    def pool(self):
        return None

    def replay(self) -> None:
        self.fn()


def graph_for(device: torch.device, sanitize: bool = False,
              mesh=None) -> Tuple[Optional[type], str]:
    """→ (the graph class work on ``device`` (over ``mesh``) runs as,
    ``""``), or (None, why the work stays eager there)."""
    if mesh is not None:
        why = mesh.eager_reason() if hasattr(mesh, "eager_reason") else (
            "its collectives cannot be captured")
        if why:
            return None, f"on a mesh that stays eager: {why}"
    if sanitize:
        return None, "under --sanitize, whose anomaly detection checks each backward eagerly"
    if device.type != "cuda":
        return None, f"on {device}: CUDA graphs need the card"
    return CudaGraph, ""


class Captured(NamedTuple):
    graph: object
    output: torch.Tensor  # the static output each replay overwrites
    launches: int         # fused-kernel launches in one call: added per replay
    seconds: float        # host seconds of the capture
    stats: object = None  # the mesh's CollectiveStats, or None
    collectives: tuple = ()  # the collectives of one call (stats.since's form): added per replay
    moments_launches: int = 0  # moments-kernel launches in one call: added per replay
    bwd_launches: int = 0  # BN + ReLU backward launches in one call: added per replay


def warm_and_capture(graph_cls: type, device: torch.device, warm: Callable[[], torch.Tensor],
                     body: Callable[[], torch.Tensor], pool=None,
                     mesh=None) -> Tuple[torch.Tensor, Captured]:
    """``warm()`` eagerly on a new graph's stream, then ``body()`` (the same
    work on the static inputs) captured, into ``pool`` if given, writing
    one static output (allocated outside the pool) shaped as warm's
    answer. ``mesh`` is the one the work's collectives run over: its
    ``stats`` keep the warm call's counts and not the capture's. Under a
    profiler the two are the span ``graph.capture``. → (warm's answer, the
    capture)."""
    with spans.span("graph.capture", 1):
        stats = getattr(mesh, "stats", None)
        graph = graph_cls(device)
        before = fused_bn_act.launch_counts()
        counted = stats.snapshot() if stats is not None else None
        y = graph.warm(warm)
        launches = _since(before)
        collectives = stats.since(counted) if stats is not None else ()
        output = torch.empty_like(y)
        before = fused_bn_act.launch_counts()
        counted = stats.snapshot() if stats is not None else None
        t0 = time.perf_counter()
        graph.capture(lambda: output.copy_(body()), pool)
        seconds = time.perf_counter() - t0
        fused_bn_act.add_launches(*(-n for n in _since(before)))
        if stats is not None:
            stats.restore(counted)
        return y, Captured(graph, output, launches[0], seconds, stats, collectives, launches[1],
                           launches[2])


def _since(before: tuple) -> tuple:
    """The kernel launches counted since ``fused_bn_act.launch_counts()``
    read ``before``, in its order."""
    return tuple(now - then for now, then in zip(fused_bn_act.launch_counts(), before))


def replay(cap: Captured) -> None:
    """One replay of ``cap``, its kernel launches and collectives counted
    as its warm call's."""
    before = fused_bn_act.launch_counts()
    counted = cap.stats.snapshot() if cap.stats is not None else None
    cap.graph.replay()
    counts = (cap.launches, cap.moments_launches, cap.bwd_launches)
    fused_bn_act.add_launches(*(want - n for want, n in zip(counts, _since(before))))
    if cap.stats is not None:
        cap.stats.restore(counted)
        cap.stats.add_replayed(cap.collectives)


class GraphedProgram:
    """``fn(*tensors) -> tensor`` captured once per input key and replayed
    (see the module docstring). ``graph_cls`` is ``CudaGraph`` on the card
    (``graph_for``), ``EagerGraph`` for the CPU tests; ``mesh`` is the one
    ``fn``'s collectives run over (their counts follow the replays). Inputs may lie on the
    host (a pinned tensor is copied without a synchronisation) or on the
    device. The keys' graphs share one memory pool: they replay one at a
    time on the caller's stream, and each keeps its inputs and output
    outside the pool, so one graph's temporaries may reuse another's."""

    def __init__(self, fn: Callable[..., torch.Tensor], device, graph_cls: type = CudaGraph,
                 mesh=None):
        self.fn = fn
        self.device = torch.device(device)
        self.graph_cls = graph_cls
        self.mesh = mesh  # the one ``fn``'s collectives run over, or None
        self._captures: Dict[tuple, Tuple[Tuple[Optional[torch.Tensor], ...], Captured]] = {}
        self.captures = 0     # captures so far (one more per new key, and after invalidate)
        self.replays = 0
        self.capture_s = 0.0  # host seconds of the last capture

    @property
    def keys(self) -> list:
        return list(self._captures)

    @property
    def pool_bytes(self) -> int:
        """Device memory the captures reserved for their graphs' pools."""
        return sum(cap.graph.pool_bytes for _, cap in self._captures.values())

    def invalidate(self) -> None:
        """Drop every graph (and its pool): the next call at each key is
        eager and recaptures."""
        self._captures.clear()

    def __call__(self, *args: Optional[torch.Tensor]) -> torch.Tensor:
        key = tuple(None if a is None else (tuple(a.shape), a.dtype) for a in args)
        if key not in self._captures:
            inputs = tuple(None if a is None else a.to(self.device, non_blocking=True, copy=True)
                           for a in args)
            pool = next(iter(self._captures.values()))[1].graph.pool() if self._captures else None
            y, cap = warm_and_capture(self.graph_cls, self.device, lambda: self.fn(*inputs),
                                      lambda: self.fn(*inputs), pool, self.mesh)
            self._captures[key] = inputs, cap
            self.captures += 1
            self.capture_s = cap.seconds
            return y
        inputs, cap = self._captures[key]
        for static, a in zip(inputs, args):
            if static is not None:
                static.copy_(a, non_blocking=True)
        replay(cap)
        self.replays += 1
        return cap.output.clone()
