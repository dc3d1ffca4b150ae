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
  buffer that the caller reads once. Under a profiler each replayed step's
  input copies and graph launch are the span ``superstep.replay``;
- ``invalidate()``: after anything rebinds a tensor the graph reads (a
  checkpoint's optimizer state loaded, a rollback), the next step
  recaptures.

The kernel wrapper counts its launches in Python
(``kernels/fused_bn_act.LAUNCHES``), and a process mesh its collectives
(``mesh.stats``), neither of which a replay runs. The warm step runs the
body's Python, so its counts are the graph's: a capture takes back what it
counted (it launches nothing) and every replay adds the warm step's
counts, the collectives marked as replayed.

Over a NCCL process mesh (model axis 1) the step's collectives, sync-BN's
all-reduces, the flat gradient average and the telemetry mean, are nodes of
the graph; every rank warms, captures and replays at the same step, and a
restore invalidates every rank's graph at the same step.

A failed capture or replay raises; nothing falls back to eager steps.
The graph classes live in ``utils/graphs.py`` with the inference
programs' ``GraphedProgram``: ``graph_for`` says where the graph runs (on
a CUDA device, not under ``--sanitize``, with no mesh or a NCCL one whose
model axis is 1), and
``EagerGraph`` is the CPU's stand-in for a graph: its capture keeps the
callable and runs nothing, its replay runs it again on the static inputs,
so the host logic runs in the CPU tests.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from jckx_torch.utils import spans
from jckx_torch.utils.graphs import (CudaGraph, EagerGraph, graph_for,  # noqa: F401 (re-exported)
                                     replay, warm_and_capture)

Inputs = Dict[str, torch.Tensor]


class Superstep:
    """See the module docstring. ``graph`` is ``CudaGraph`` on the card
    (``graph_for``), ``EagerGraph`` for the CPU tests; ``mesh`` is the one
    the step's collectives run over."""

    def __init__(self, body: Callable[[Inputs], torch.Tensor], device: torch.device,
                 graph: type = CudaGraph, mesh=None):
        self.body = body
        self.device = device
        self.graph_cls = graph
        self.mesh = mesh
        self.cap = None  # the capture (utils/graphs.Captured)
        self.inputs: Optional[Inputs] = None
        self.launches = 0     # fused-kernel launches in one step: added per replay
        self.captures = 0     # captures so far (one more after each invalidate)
        self.capture_s = 0.0  # host seconds of the last capture
        self.replays = 0

    @property
    def captured(self) -> bool:
        return self.cap is not None

    @property
    def pool_bytes(self) -> int:
        """Device memory the last capture reserved for the graph's pool."""
        return self.cap.graph.pool_bytes if self.cap is not None else 0

    def invalidate(self) -> None:
        """Drop the graph: the next step is eager and recaptures."""
        self.cap = self.inputs = None

    def replay(self, k: int, feed: Callable[[int], Inputs],
               warm: Optional[Callable[[Inputs], torch.Tensor]] = None) -> torch.Tensor:
        """k steps → their outputs, ``(k, n)`` on the device. ``feed(j)``
        prepares step j on the host and returns its inputs; ``warm(inputs)``
        is the eager step that precedes a capture (the body by default)."""
        out = None
        for j in range(k):
            x = feed(j)
            if self.cap is None:
                inputs = self.inputs = {name: t.clone() for name, t in x.items()}
                y, self.cap = warm_and_capture(self.graph_cls, self.device,
                                               lambda: (warm or self.body)(x),
                                               lambda: self.body(inputs), mesh=self.mesh)
                self.launches, self.capture_s = self.cap.launches, self.cap.seconds
                self.captures += 1
            else:
                with spans.span("superstep.replay", 1):
                    for name, t in x.items():
                        self.inputs[name].copy_(t)
                    replay(self.cap)
                    self.replays += 1
                y = self.cap.output
            if out is None:
                out = torch.empty((k, *y.shape), dtype=y.dtype, device=y.device)
            out[j].copy_(y)
        return out
