"""Weight-initialization laws — port of ``jckx/ops/init.py:19-37``.

The reference's ``weights_init`` (model/DCGAN.py:70-76): every Conv*
weight ~ N(0, 0.02); every BatchNorm scale ~ N(1, 0.02), bias = 0. The
CGAN discriminator's Linears keep torch's default init, because
``weights_init`` matches only Conv and BatchNorm names (model/CGAN.py:
165-171): ``linear_init``. Draws come from an explicit ``torch.Generator``;
they are not jax.random's.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def conv_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """N(0, 0.02) in f32 — reference weights_init for Conv/ConvTranspose."""
    return 0.02 * torch.randn(shape, generator=gen, device=gen.device)


def bn_scale_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """N(1, 0.02) in f32 — reference weights_init for BatchNorm scale."""
    return 1.0 + 0.02 * torch.randn(shape, generator=gen, device=gen.device)


def linear_init(gen: torch.Generator, fan_in: int, fan_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nn.Linear``'s default init in f32: Kaiming-uniform(a=√5) for the
    weight, which reduces to U(±1/√fan_in), and U(±1/√fan_in) for the bias.
    → (weight (fan_out, fan_in), torch's layout; bias (fan_out,))."""
    bound = 1.0 / math.sqrt(fan_in)

    def uniform(*shape):
        return (2.0 * torch.rand(shape, generator=gen, device=gen.device) - 1.0) * bound

    return uniform(fan_out, fan_in), uniform(fan_out)
