"""Convolutions — port of ``jckx/ops/conv.py:76-119``.

``jckx/ops/conv.py`` emulates exactly torch's bias-free ``nn.Conv2d`` and
``nn.ConvTranspose2d``; here they are the real thing (cuDNN on the card;
the convolutions lie outside the Pallas kernel in the JAX package too).
Weights are in torch layout: ``(Cout, Cin, kh, kw)`` for a convolution,
``(Cin, Cout, kh, kw)`` for a transposed one. Activations are NCHW-logical
in ``torch.channels_last`` memory, the layout the fused BN kernel reads
as ``(N·H·W, C)`` rows; the ``contiguous`` below costs nothing when the
convolution already returned that layout.

The sub-pixel ConvTranspose form (``jckx/ops/conv.py:122-156``) is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Cross-correlation, torch Conv2d semantics (bias-free)."""
    y = F.conv2d(x, w, stride=stride, padding=padding)
    return y.contiguous(memory_format=torch.channels_last)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """torch ConvTranspose2d(k, stride, padding, bias=False) semantics."""
    y = F.conv_transpose2d(x, w, stride=stride, padding=padding)
    return y.contiguous(memory_format=torch.channels_last)
