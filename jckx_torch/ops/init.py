"""Weight-initialization laws — port of ``jckx/ops/init.py:19-26``.

The reference's ``weights_init`` (model/DCGAN.py:70-76): every Conv*
weight ~ N(0, 0.02); every BatchNorm scale ~ N(1, 0.02), bias = 0. Draws
come from an explicit ``torch.Generator``; they are not jax.random's.
"""

from __future__ import annotations

from typing import Tuple

import torch


def conv_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """N(0, 0.02) in f32 — reference weights_init for Conv/ConvTranspose."""
    return 0.02 * torch.randn(shape, generator=gen, device=gen.device)


def bn_scale_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """N(1, 0.02) in f32 — reference weights_init for BatchNorm scale."""
    return 1.0 + 0.02 * torch.randn(shape, generator=gen, device=gen.device)
