"""DCGAN generator / discriminator — port of ``jckx/models/dcgan.py``.

Architecture as the reference's ``model/DCGAN.py``: G maps z(100) through
five bias-free ConvTranspose2d(k4) with batch-stat BN + ReLU between and
tanh out (4×4×512 → … → 64×64×C); D mirrors it with Conv2d(k4 s2 p1) +
BN + LeakyReLU(0.2) and a final Conv2d(k4 s1 p0) to one LOGIT per sample.

Layouts: the public forward functions keep the JAX package's NHWC
(images ``(N, S, S, C)``), so tests compare like with like. Inside,
activations are NCHW-logical tensors in ``torch.channels_last`` memory, so
the fused BN kernel reads each one as ``(N·H·W, C)`` rows without a copy.

Each layer runs through a layout (``parallel/layout.py``): whole
activations by default; under a mesh's model axis, sharded channels
(``parallel/tp.py``) or rows (``parallel/spatial.py``).

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
from jckx_torch.ops.conv import conv2d
from jckx_torch.ops.init import bn_scale_init, conv_init
from jckx_torch.parallel.layout import Layout


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


def init_module(m: nn.Module, gen: torch.Generator) -> None:
    """The reference's init law for one convolution or norm; other modules
    are left as they are."""
    with torch.no_grad():
        if isinstance(m, _ConvWeight):
            m.weight.copy_(conv_init(gen, tuple(m.weight.shape)))
        elif isinstance(m, _BatchStatNorm):
            m.weight.copy_(bn_scale_init(gen, tuple(m.weight.shape)))
            m.bias.zero_()


def weights_init(net: nn.Module, gen: torch.Generator) -> None:
    """The reference's init law, drawn in registration order from ``gen``
    (the order in which ``jckx``'s ``*_init`` split their keys)."""
    for m in net.children():
        init_module(m, gen)


class Generator(nn.Module):
    """Reference G. ``gen`` draws the init weights; without it the
    parameters stay zero until a state dict is loaded. ``in_dim`` is the
    width of G's input, ``z_dim`` unless a condition is concatenated to z
    (``generator_init(key, geo, in_dim=…)``)."""

    def __init__(self, geo: GANGeometry = GANGeometry(), gen: Optional[torch.Generator] = None,
                 in_dim: Optional[int] = None):
        super().__init__()
        self.geo = geo
        prev = geo.z_dim if in_dim is None else in_dim
        for i, w in enumerate(geo.stage_widths()):
            setattr(self, f"conv{i + 1}", _ConvWeight((prev, w, 4, 4)))
            setattr(self, f"norm{i + 1}", _BatchStatNorm(w))
            prev = w
        setattr(self, f"conv{geo.n_up + 1}", _ConvWeight((prev, geo.channels, 4, 4)))
        if gen is not None:
            weights_init(self, gen)

    def forward(self, z: torch.Tensor, compute_dtype=torch.float32,
                subpixel: bool = False, mesh=None, par=None) -> torch.Tensor:
        """z: (N, in_dim) or (N, 1, 1, in_dim) → images (N, S, S, C) in [-1, 1],
        in ``compute_dtype`` — counterpart of ``generator_apply``, with its
        casts: z and the weights in the compute dtype, BN output in x's
        dtype, tanh in f32 cast back to the compute dtype. ``subpixel``:
        the stride-2 layers in the sub-pixel form (``ops/conv.py``).
        ``mesh``: z is this member's rows of a batch sharded on its data
        axis, and BN takes the global statistics (``parallel/mesh.py``).
        ``par``: a model-axis layout (``parallel/layout.py``) in place of
        ``mesh``; under ``spatial`` the images are this member's rows."""
        # this module's bn_act, looked up per call (a test may route it elsewhere)
        lay = par if par is not None else Layout(mesh, subpixel, bn_act)
        n_up = self.geo.n_up
        x = z.reshape(z.shape[0], -1, 1, 1).to(compute_dtype)
        h = 1
        for i, width in enumerate(self.geo.stage_widths()):
            w = getattr(self, f"conv{i + 1}").weight.to(compute_dtype)
            stride, pad = (1, 0) if i == 0 else (2, 1)
            x = lay.conv_transpose2d(x, w, stride, pad, h)
            h = 4 if i == 0 else 2 * h
            norm = getattr(self, f"norm{i + 1}")
            x = lay.bn_act(x, norm.weight, norm.bias, "relu", width, h)
        w = getattr(self, f"conv{n_up + 1}").weight.to(compute_dtype)
        x = lay.conv_transpose2d(x, w, 2, 1, h)
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

    def trunk(self, x: torch.Tensor, compute_dtype, lay) -> torch.Tensor:
        """images (N, S, S, C) → the last stage's NCHW activation (N, C, s, s)
        with all its rows (the part both families share)."""
        x = x.permute(0, 3, 1, 2).to(compute_dtype)
        h = self.geo.image_size
        for i, width in enumerate(reversed(self.geo.stage_widths())):
            w = getattr(self, f"conv{i + 1}").weight.to(compute_dtype)
            x = lay.conv2d(x, w, 2, 1, h)
            h //= 2
            norm = getattr(self, f"norm{i + 1}")
            x = lay.bn_act(x, norm.weight, norm.bias, "leaky_relu", width, h)
        return lay.full_height(x, h)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32, mesh=None,
                par=None) -> torch.Tensor:
        """images (N, S, S, C) → per-sample logits (N,) in f32 — counterpart
        of ``discriminator_apply``; ``mesh`` and ``par`` as in
        ``Generator.forward``."""
        lay = par if par is not None else Layout(mesh)
        x = self.trunk(x, compute_dtype, lay)
        x = conv2d(x, getattr(self, f"conv{self.geo.n_up + 1}").weight.to(compute_dtype))
        return x.reshape(x.shape[0]).float()
