"""Convolutions — port of ``jckx/ops/conv.py``.

``jckx/ops/conv.py`` emulates exactly torch's bias-free ``nn.Conv2d`` and
``nn.ConvTranspose2d``; here they are the real thing (cuDNN on the card;
the convolutions lie outside the Pallas kernel in the JAX package too).
Weights are in torch layout: ``(Cout, Cin, kh, kw)`` for a convolution,
``(Cin, Cout, kh, kw)`` for a transposed one. Activations are NCHW-logical
in ``torch.channels_last`` memory, the layout the fused BN kernel reads
as ``(N·H·W, C)`` rows; the ``contiguous`` below costs nothing when the
convolution already returned that layout.

``conv_transpose2d(..., subpixel=True)`` realizes the k4 s2 p1 transposed
convolution in its kernel-segregated (sub-pixel) form
(``jckx/ops/conv.py:122-156``): four dense 2×2 stride-1 convolutions on the
flipped kernel's phase slices, interleaved into 2H×2W. Same products as
the dilated form minus the 75 % that hit structural zeros. jckx switches
it on with a trace-time scope (``subpixel_inference``); here it is an
argument, passed down from the serving sampler to G's forward. The int8
sampler (``ops/quant.py``) runs the same decomposition with integer
accumulation through ``conv_transpose2d_subpixel_k4s2p1``'s ``conv2x2``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Cross-correlation, torch Conv2d semantics (bias-free)."""
    y = F.conv2d(x, w, stride=stride, padding=padding)
    return y.contiguous(memory_format=torch.channels_last)


def is_subpixel_layer(w: torch.Tensor, stride: int, padding: int) -> bool:
    """The (k, stride, padding) the sub-pixel form covers: k4 s2 p1."""
    return stride == 2 and padding == 1 and tuple(w.shape[2:]) == (4, 4)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     padding: int = 0, subpixel: bool = False) -> torch.Tensor:
    """torch ConvTranspose2d(k, stride, padding, bias=False) semantics.
    ``subpixel``: the k4 s2 p1 layers take the sub-pixel form; any other
    (k, stride, padding) takes ``F.conv_transpose2d`` either way."""
    if subpixel and is_subpixel_layer(w, stride, padding):
        return conv_transpose2d_subpixel_k4s2p1(x, w)
    y = F.conv_transpose2d(x, w, stride=stride, padding=padding)
    return y.contiguous(memory_format=torch.channels_last)


def subpixel_phase(x: torch.Tensor, w: torch.Tensor, a: int, b: int):
    """Output phase (a, b) of ConvTranspose2d(k4, s2, p1) as a dense 2×2
    stride-1 cross-correlation: → (x padded by (1-a, a) rows and (1-b, b)
    columns, its ``(Cout, Cin, 2, 2)`` kernel ``flip(w)[:, :, a::2, b::2]``).

    Derivation (``jckx/ops/conv.py:131-138``): with the flipped kernel wf
    and the dilated input xd (xd[2r] = x[r], odd taps zero), output row
    u = 2i + a only receives taps p ≡ a (mod 2); with p = 2t + a the
    contributing input row is i + t + a - 1."""
    wf = torch.flip(w, dims=(2, 3))[:, :, a::2, b::2]   # (Cin, Cout, 2, 2)
    return F.pad(x, (1 - b, b, 1 - a, a)), wf.transpose(0, 1)


def interleave_phases(phases) -> torch.Tensor:
    """Four NCHW phase maps (N, C, H, W), in the order (0,0), (0,1), (1,0),
    (1,1) → the (N, C, 2H, 2W) output, y[..., 2i + a, 2j + b] = phase (a, b)
    [..., i, j], in channels_last memory."""
    n, c, h, wd = phases[0].shape
    y = torch.stack([p.permute(0, 2, 3, 1) for p in phases])  # (a·2+b, N, H, W, C)
    y = y.reshape(2, 2, n, h, wd, c).permute(2, 3, 0, 4, 1, 5)  # (N, H, a, W, b, C)
    return y.reshape(n, 2 * h, 2 * wd, c).contiguous().permute(0, 3, 1, 2)


def conv_transpose2d_subpixel_k4s2p1(
        x: torch.Tensor, w: torch.Tensor,
        conv2x2: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """Kernel-segregated form of ConvTranspose2d(k=4, s=2, p=1).
    ``conv2x2(x_padded, kernel)`` computes one phase (an unpadded stride-1
    cross-correlation, ``F.conv2d`` by default); the int8 sampler passes
    its integer one, so the phase / padding derivation has one home."""
    if not is_subpixel_layer(w, 2, 1):
        raise ValueError(f"the sub-pixel form is for k4 s2 p1, got a {tuple(w.shape[2:])} kernel")
    conv2x2 = conv2x2 or F.conv2d
    return interleave_phases([conv2x2(*subpixel_phase(x, w, a, b)) for a in (0, 1) for b in (0, 1)])
