"""The train step as one device program — port of jckx's superstep
(``jckx/train/gan_trainer.py:279-322``, launched at ``:681-691``; the
fine-tune's ``make_superstep``, ``jckx/metrics/inception_train.py:107-130``).

In jckx every train step is one compiled device program, and a launch
runs K of them (``lax.scan``) with one host round trip. On the card the
counterpart of a compiled program is a captured CUDA graph: ``Superstep``
records one step once and replays it, so a launch of k steps is k graph
launches with no Python op-by-op dispatch between them, and the host reads
the launch's telemetry once, at its end.

A ``Superstep`` holds:

- the step's **body** ``body(inputs) -> (n,)``: its device work on a dict
  of input tensors (a uint8 batch or the indices of one, labels, the
  step's draws), with no host read;
- the **static inputs**, device tensors the graph reads, and the **static
  output** it writes (the six telemetry scalars, or the fine-tune's loss
  and accuracy);
- the **capture**. The first step after a build or an ``invalidate`` runs
  eagerly (``warm``, the caller's own step by default the body), on the
  side stream the capture then uses: it trains the state like any step,
  creates Adam's and SGD's state and lets cuDNN pick its algorithms for
  these shapes. The body is then captured on that stream into the graph's
  own memory pool. A capture records the step without running it; the
  next step is the graph's first replay;
- ``replay(k, feed)``: for each step j, ``feed(j)`` does the host's part of
  the step (the lr of a cosine schedule, the draws, which a capture would
  freeze) and returns its inputs, which are copied into the static inputs
  before the replay; the outputs are stacked into a ``(k, n)`` device
  buffer that the caller reads once;
- ``invalidate()``: after anything rebinds a tensor the graph reads (a
  checkpoint's optimizer state loaded, a rollback), the next step
  recaptures.

The kernel wrapper counts its launches in Python
(``kernels/fused_bn_act.LAUNCHES``), which a replay does not run. The warm
step runs the body's Python, so its count is the graph's: a capture takes
back what it counted (it launches nothing) and every replay adds the
warm step's count.

A failed capture or replay raises; nothing falls back to eager steps.
``graph_for`` says where the graph runs: on a CUDA device, and not under
``--sanitize`` (anomaly detection checks each backward function as it
runs, eagerly by nature, as ``jax_debug_nans`` de-optimizes jckx's
programs) nor on a mesh (gloo's collectives run on the host and cannot be
captured). ``EagerGraph`` is the CPU's stand-in for a graph: its capture
keeps the callable and runs nothing, its replay runs it again on the
static inputs, so the host logic runs in the CPU tests.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from jckx_torch.kernels import fused_bn_act

Inputs = Dict[str, torch.Tensor]


class CudaGraph:
    """One step captured as a ``torch.cuda.CUDAGraph`` on a side stream of
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

    def capture(self, fn: Callable[[], object]) -> None:
        # other threads (the streaming plane's uploader) may use the card
        # meanwhile: only this thread is held to capture-safe calls
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
            fn()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before
        self.graph = graph

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

    def capture(self, fn: Callable[[], object]) -> None:
        self.fn = fn

    def replay(self) -> None:
        self.fn()


def graph_for(device: torch.device, sanitize: bool = False,
              mesh=None) -> Tuple[Optional[type], str]:
    """→ (the graph class a step on ``device`` runs as, ``""``), or (None,
    why the step stays eager there)."""
    if mesh is not None:
        return None, ("on a mesh, whose collectives cannot be captured (gloo runs on the host; "
                      "NCCL runs as a world of one on one card)")
    if sanitize:
        return None, "under --sanitize, whose anomaly detection checks each backward eagerly"
    if device.type != "cuda":
        return None, f"on {device}: CUDA graphs need the card"
    return CudaGraph, ""


class Superstep:
    """See the module docstring. ``graph`` is ``CudaGraph`` on the card
    (``graph_for``), ``EagerGraph`` for the CPU tests."""

    def __init__(self, body: Callable[[Inputs], torch.Tensor], device: torch.device,
                 graph: type = CudaGraph):
        self.body = body
        self.device = device
        self.graph_cls = graph
        self.graph = None
        self.inputs: Optional[Inputs] = None
        self.output: Optional[torch.Tensor] = None
        self.launches = 0     # fused-kernel launches in one step: added per replay
        self.captures = 0     # captures so far (one more after each invalidate)
        self.capture_s = 0.0  # host seconds of the last capture
        self.replays = 0

    @property
    def captured(self) -> bool:
        return self.graph is not None

    @property
    def pool_bytes(self) -> int:
        """Device memory the last capture reserved for the graph's pool."""
        return self.graph.pool_bytes if self.graph is not None else 0

    def invalidate(self) -> None:
        """Drop the graph: the next step is eager and recaptures."""
        self.graph = self.inputs = self.output = None

    def replay(self, k: int, feed: Callable[[int], Inputs],
               warm: Optional[Callable[[Inputs], torch.Tensor]] = None) -> torch.Tensor:
        """k steps → their outputs, ``(k, n)`` on the device. ``feed(j)``
        prepares step j on the host and returns its inputs; ``warm(inputs)``
        is the eager step that precedes a capture (the body by default)."""
        out = None
        for j in range(k):
            x = feed(j)
            if self.graph is None:
                y = self._warm_and_capture(x, warm or self.body)
            else:
                for name, t in x.items():
                    self.inputs[name].copy_(t)
                before = fused_bn_act.LAUNCHES
                self.graph.replay()
                fused_bn_act.add_launches(before + self.launches - fused_bn_act.LAUNCHES)
                self.replays += 1
                y = self.output
            if out is None:
                out = torch.empty((k, *y.shape), dtype=y.dtype, device=y.device)
            out[j].copy_(y)
        return out

    def _warm_and_capture(self, x: Inputs, warm: Callable[[Inputs], torch.Tensor]) -> torch.Tensor:
        graph = self.graph_cls(self.device)
        before = fused_bn_act.LAUNCHES
        y = graph.warm(lambda: warm(x))
        self.launches = fused_bn_act.LAUNCHES - before
        self.inputs = {name: t.clone() for name, t in x.items()}
        self.output = torch.empty_like(y)
        before = fused_bn_act.LAUNCHES
        t0 = time.perf_counter()
        graph.capture(lambda: self.output.copy_(self.body(self.inputs)))
        self.capture_s = time.perf_counter() - t0
        fused_bn_act.add_launches(before - fused_bn_act.LAUNCHES)
        self.graph = graph
        self.captures += 1
        return y
