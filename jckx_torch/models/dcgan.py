"""DCGAN generator / discriminator — port of ``jckx/models/dcgan.py``.

Architecture as the reference's ``model/DCGAN.py``: G maps z(100) through
five bias-free ConvTranspose2d(k4) with batch-stat BN + ReLU between and
tanh out (4×4×512 → … → 64×64×C); D mirrors it with Conv2d(k4 s2 p1) +
BN + LeakyReLU(0.2) and a final Conv2d(k4 s1 p0) to one LOGIT per sample.

Layouts: the public forward functions keep the JAX package's NHWC
(images ``(N, S, S, C)``), so tests compare like with like. Inside,
activations are NCHW-logical tensors in ``torch.channels_last`` memory, so
the fused BN kernel reads each one as ``(N·H·W, C)`` rows without a copy.

Parameters carry the reference's state-dict names (``conv{i}.weight``,
``norm{i}.weight`` / ``norm{i}.bias``), and each norm registers the
``running_mean`` / ``running_var`` / ``num_batches_tracked`` buffers of
``nn.BatchNorm2d``, so a reference ``.pt`` loads with ``strict=True``. The
buffers are never read: BN always uses batch statistics, as in the
reference, which never switches its GAN nets to eval mode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from jckx_torch.kernels.fused_bn_act import bn_act
from jckx_torch.ops.conv import conv2d, conv_transpose2d
from jckx_torch.ops.init import bn_scale_init, conv_init


@dataclass(frozen=True)
class GANGeometry:
    """The port's copy of ``jckx.models.dcgan.GANGeometry``."""

    z_dim: int = 100
    image_size: int = 64
    channels: int = 3
    base_width: int = 64

    @property
    def n_up(self) -> int:
        n = int(math.log2(self.image_size)) - 2
        if 2 ** (n + 2) != self.image_size or n < 1:
            raise ValueError(f"image_size must be a power of two >= 8, got {self.image_size}")
        return n

    def stage_widths(self) -> list:
        # widths at 4x4, 8x8, ... (reference: 512,256,128,64 for 64x64)
        return [self.base_width * 2 ** (self.n_up - 1 - i) for i in range(self.n_up)]


class _ConvWeight(nn.Module):
    """One bias-free convolution's weight, under the key ``weight``."""

    def __init__(self, shape):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape))


class _BatchStatNorm(nn.Module):
    """``nn.BatchNorm2d``'s state-dict layout; only weight and bias are read."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))


def weights_init(net: nn.Module, gen: torch.Generator) -> None:
    """The reference's init law, drawn in registration order from ``gen``
    (the order in which ``jckx``'s ``*_init`` split their keys)."""
    with torch.no_grad():
        for m in net.children():
            if isinstance(m, _ConvWeight):
                m.weight.copy_(conv_init(gen, tuple(m.weight.shape)))
            elif isinstance(m, _BatchStatNorm):
                m.weight.copy_(bn_scale_init(gen, tuple(m.weight.shape)))
                m.bias.zero_()


class Generator(nn.Module):
    """Reference G. ``gen`` draws the init weights; without it the
    parameters stay zero until a state dict is loaded."""

    def __init__(self, geo: GANGeometry = GANGeometry(), gen: Optional[torch.Generator] = None):
        super().__init__()
        self.geo = geo
        prev = geo.z_dim
        for i, w in enumerate(geo.stage_widths()):
            setattr(self, f"conv{i + 1}", _ConvWeight((prev, w, 4, 4)))
            setattr(self, f"norm{i + 1}", _BatchStatNorm(w))
            prev = w
        setattr(self, f"conv{geo.n_up + 1}", _ConvWeight((prev, geo.channels, 4, 4)))
        if gen is not None:
            weights_init(self, gen)

    def forward(self, z: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """z: (N, z_dim) or (N, 1, 1, z_dim) → images (N, S, S, C) in [-1, 1],
        in ``compute_dtype`` — counterpart of ``generator_apply``, with its
        casts: z and the weights in the compute dtype, BN output in x's
        dtype, tanh in f32 cast back to the compute dtype."""
        n_up = self.geo.n_up
        x = z.reshape(z.shape[0], -1, 1, 1).to(compute_dtype)
        for i in range(n_up):
            w = getattr(self, f"conv{i + 1}").weight.to(compute_dtype)
            stride, pad = (1, 0) if i == 0 else (2, 1)
            x = conv_transpose2d(x, w, stride=stride, padding=pad)
            norm = getattr(self, f"norm{i + 1}")
            x = bn_act(x, norm.weight, norm.bias, act="relu")
        w = getattr(self, f"conv{n_up + 1}").weight.to(compute_dtype)
        x = conv_transpose2d(x, w, stride=2, padding=1)
        return torch.tanh(x.float()).to(compute_dtype).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """Reference D, returning LOGITS (the reference module ends in a sigmoid,
    which jckx applies where the loss and the penalty need it)."""

    def __init__(self, geo: GANGeometry = GANGeometry(), gen: Optional[torch.Generator] = None):
        super().__init__()
        self.geo = geo
        prev = geo.channels
        for i, w in enumerate(reversed(geo.stage_widths())):  # 64,128,256,512
            setattr(self, f"conv{i + 1}", _ConvWeight((w, prev, 4, 4)))
            setattr(self, f"norm{i + 1}", _BatchStatNorm(w))
            prev = w
        setattr(self, f"conv{geo.n_up + 1}", _ConvWeight((1, prev, 4, 4)))
        if gen is not None:
            weights_init(self, gen)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """images (N, S, S, C) → per-sample logits (N,) in f32 — counterpart
        of ``discriminator_apply``."""
        n_up = self.geo.n_up
        x = x.permute(0, 3, 1, 2).to(compute_dtype)
        for i in range(n_up):
            w = getattr(self, f"conv{i + 1}").weight.to(compute_dtype)
            x = conv2d(x, w, stride=2, padding=1)
            norm = getattr(self, f"norm{i + 1}")
            x = bn_act(x, norm.weight, norm.bias, act="leaky_relu", negative_slope=0.2)
        x = conv2d(x, getattr(self, f"conv{n_up + 1}").weight.to(compute_dtype))
        return x.reshape(x.shape[0]).float()
