"""Conditional GAN generator / discriminator — port of
``jckx/models/cgan.py:40-110`` (the reference's model/CGAN.py:79-162).

- ``CGenerator``: the one-hot label (N, K) is concatenated to z at 1×1, and
  the DCGAN stack runs on ``in_dim = z_dim + K`` (200 → 512 → … → C at the
  reference's K = 100).
- ``CDiscriminator``: the image runs through the DCGAN trunk (four k4 s2 p1
  convolutions, each with batch-stat BN + LeakyReLU(0.2)) and is flattened
  in NCHW order (C, H, W), as the reference flattens it, so a reference
  ``.pt`` loads as it is; the label runs through Linear(K → 2K) +
  LeakyReLU(0.2); the two are concatenated and fused by Linear(flat + 2K →
  256) → Dropout(0.25) → Linear(256 → 1). The head runs in f32, as in jckx.
  ``forward`` returns LOGITS (the reference module ends in a sigmoid).

Dropout takes its keep-mask as an argument, ``keep`` (N, 256) of 0 / 1,
and computes ``h · keep / 0.75``, jckx's ``where(keep, h / 0.75, 0)``; the
caller draws the mask (``train/steps.py``) so that a test can inject
jckx's. ``keep=None`` is eval mode.

Parameters carry the reference's names in its registration order:
``label_embedding``, ``conv1..4`` / ``norm1..4``, ``linear1``, ``linear2``.
That order is the order of the torch Adam state that jckx's importer reads
(``jckx/checkpoint/torch_convert.py:149-164``). The Linears take torch's
default init (``linear_init``); the reference's ``weights_init`` matches
only Conv and BatchNorm names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from jckx_torch.models.dcgan import (Discriminator, GANGeometry, Generator, _BatchStatNorm,
                                     _ConvWeight, init_module)
from jckx_torch.ops.init import linear_init
from jckx_torch.parallel.layout import Layout

HIDDEN = 256    # linear1's width (model/CGAN.py:112)
DROPOUT = 0.25  # model/CGAN.py:120


class _Linear(nn.Module):
    """One ``nn.Linear``'s parameters: ``weight`` (out, in) and ``bias``."""

    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(fan_out, fan_in))
        self.bias = nn.Parameter(torch.zeros(fan_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def weights_init(net: nn.Module, gen: torch.Generator) -> None:
    """The reference's init laws, drawn in registration order from ``gen``."""
    for m in net.children():
        if isinstance(m, _Linear):
            w, b = linear_init(gen, m.weight.shape[1], m.weight.shape[0])
            with torch.no_grad():
                m.weight.copy_(w)
                m.bias.copy_(b)
        else:
            init_module(m, gen)


class CGenerator(Generator):
    """Reference CGAN G: the DCGAN stack on [z, one-hot]."""

    def __init__(self, geo: GANGeometry = GANGeometry(), num_classes: int = 100,
                 gen: Optional[torch.Generator] = None):
        super().__init__(geo, gen=gen, in_dim=geo.z_dim + num_classes)
        self.num_classes = num_classes

    def forward(self, z: torch.Tensor, labels_onehot: torch.Tensor,
                compute_dtype=torch.float32, subpixel: bool = False, mesh=None,
                par=None) -> torch.Tensor:
        """z (N, z_dim) or (N, 1, 1, z_dim), one-hot labels (N, K) → images
        (N, S, S, C) in [-1, 1] — counterpart of ``cgenerator_apply``;
        ``mesh`` and ``par`` as in ``Generator.forward``."""
        z = z.reshape(z.shape[0], -1)
        return super().forward(torch.cat([z, labels_onehot.to(z.dtype)], dim=-1), compute_dtype,
                               subpixel, mesh, par)


class CDiscriminator(nn.Module):
    """Reference CGAN D, returning LOGITS."""

    def __init__(self, geo: GANGeometry = GANGeometry(), num_classes: int = 100,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.geo = geo
        self.num_classes = num_classes
        self.label_embedding = _Linear(num_classes, 2 * num_classes)
        prev = geo.channels
        for i, w in enumerate(reversed(geo.stage_widths())):  # 64,128,256,512
            setattr(self, f"conv{i + 1}", _ConvWeight((w, prev, 4, 4)))
            setattr(self, f"norm{i + 1}", _BatchStatNorm(w))
            prev = w
        flat = (geo.image_size // 2 ** geo.n_up) ** 2 * prev  # 8192 at 64²
        self.linear1 = _Linear(flat + 2 * num_classes, HIDDEN)
        self.linear2 = _Linear(HIDDEN, 1)
        if gen is not None:
            weights_init(self, gen)

    trunk = Discriminator.trunk

    def forward(self, x: torch.Tensor, labels_onehot: torch.Tensor, compute_dtype=torch.float32,
                keep: Optional[torch.Tensor] = None, mesh=None, par=None) -> torch.Tensor:
        """images (N, S, S, C), one-hot labels (N, K), the dropout keep-mask
        (N, 256) or None → per-sample logits (N,) in f32 — counterpart of
        ``cdiscriminator_apply``; ``mesh`` and ``par`` as in
        ``Generator.forward``."""
        lay = par if par is not None else Layout(mesh)
        feat = self.trunk(x, compute_dtype, lay)
        feat = feat.reshape(feat.shape[0], -1).float()  # NCHW-logical: (C, H, W) rows
        k2 = 2 * self.num_classes
        lab = lay.linear(labels_onehot.float(), self.label_embedding.weight,
                         self.label_embedding.bias, k2)
        lab = torch.where(lab >= 0, lab, 0.2 * lab)
        h = lay.linear(torch.cat([feat, lab], dim=-1), self.linear1.weight, self.linear1.bias,
                       HIDDEN)
        if keep is not None:
            h = h * keep.to(h.dtype) / (1.0 - DROPOUT)
        out = lay.linear(h, self.linear2.weight, self.linear2.bias, 1)
        return out.reshape(out.shape[0])
