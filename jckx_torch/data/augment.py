"""On-device RandomResizedCrop + horizontal flip — port of
``random_resized_crop_flip`` (``jckx/data/augment.py:19-66``).

Per image: a crop area drawn in ``scale`` · (H·W), an aspect ratio drawn
log-uniformly in ``ratio``, the box clamped into the image (jckx's clamp,
not torchvision's rejection sampling), a uniform offset, the crop
resampled bilinearly to ``out_size``², and a flip with p = 0.5. As jckx,
the flip is applied to the small input, with the box's x offset mirrored:
bilinear resampling commutes with mirroring.

The resample is ``jax.image.scale_and_translate(..., method="bilinear")``
with its default antialias (``compute_weight_mat`` in jax's
``_src/image/scale.py``): sample positions at half-pixel centres, a
triangle kernel widened by ``max(1/scale, 1)``, weights renormalized over
the taps, and zero weight where the sample falls outside
``[-0.5, in − 0.5]``. ``F.interpolate`` and ``grid_sample`` differ from it
at crop edges, so each image gets its own row and column weight matrices
(``out × in``), applied with two batched products.

The per-image draws are a ``CropDraws``, injectable so that a test can
hand both packages the same numbers; ``draw_crops`` makes them from a
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

SCALE = (0.08, 1.0)
RATIO = (3.0 / 4.0, 4.0 / 3.0)


class CropDraws(NamedTuple):
    """Per-image draws, each (N,): ``area`` the crop's share of the image
    in ``[scale0, scale1)``, ``log_ratio`` in ``[log ratio0, log ratio1)``,
    ``y`` / ``x`` offset uniforms in [0, 1), ``flip`` bool."""
    area: torch.Tensor
    log_ratio: torch.Tensor
    y: torch.Tensor
    x: torch.Tensor
    flip: torch.Tensor


def draw_crops(n: int, generator: torch.Generator, device=None, scale=SCALE,
               ratio=RATIO) -> CropDraws:
    """Draw ``n`` images' crops from ``generator`` (on ``device``)."""
    def u(lo=0.0, hi=1.0):
        return torch.rand(n, generator=generator, device=device) * (hi - lo) + lo

    lr = (math.log(ratio[0]), math.log(ratio[1]))
    return CropDraws(u(*scale), u(*lr), u(), u(), u() < 0.5)


def _weights(in_size: int, out_size: int, scale: torch.Tensor,
             translation: torch.Tensor) -> torch.Tensor:
    """(N,) scales and translations → (N, out, in) bilinear resampling
    weights, as jax's ``compute_weight_mat`` with the triangle kernel and
    antialias on (transposed: jax builds (in, out))."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * inv_scale
              - translation[:, None] * inv_scale - 0.5)                       # (N, out)
    dist = (sample[:, :, None] - torch.arange(in_size, dtype=torch.float32, device=dev)).abs()
    w = torch.clamp(1.0 - dist / kernel_scale[:, :, None], min=0.0)          # (N, out, in)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, 0.0)


def random_resized_crop_flip(images: torch.Tensor, out_size: int = 299,
                             draws: Optional[CropDraws] = None,
                             generator: Optional[torch.Generator] = None,
                             scale=SCALE, ratio=RATIO) -> torch.Tensor:
    """(N, H, W, C) float → (N, out_size, out_size, C) in the same dtype.
    ``draws`` default to ``draw_crops`` from ``generator``."""
    n, h, w, _ = images.shape
    if draws is None:
        draws = draw_crops(n, generator, images.device, scale, ratio)
    area = draws.area.float() * (h * w)
    r = torch.exp(draws.log_ratio.float())
    cw = torch.clamp(torch.sqrt(area * r), 1.0, float(w))
    ch = torch.clamp(torch.sqrt(area / r), 1.0, float(h))
    y0 = draws.y.float() * (h - ch)
    x0 = draws.x.float() * (w - cw)
    flip = draws.flip.bool()
    imgs = torch.where(flip[:, None, None, None], images.flip(2), images)
    x0 = torch.where(flip, (w - cw) - x0, x0)
    wy = _weights(h, out_size, out_size / ch, -y0 * out_size / ch)           # (N, out, H)
    wx = _weights(w, out_size, out_size / cw, -x0 * out_size / cw)           # (N, out, W)
    out = torch.einsum("nih,nhwc->niwc", wy, imgs.float())
    out = torch.einsum("njw,niwc->nijc", wx, out)
    return out.to(images.dtype)
