"""GAN losses and the gradient penalty — port of ``jckx/ops/losses.py``.

- BCE on sigmoid outputs against the smoothed labels 0.9 / 0.1, kept on
  logits in the stable softplus form (``:23-32``);
- the instance-noise blend ``(1 - f)·x + f·n`` (``:35-38``). jckx draws
  ``n`` inside; here the caller passes it, so a test can inject jckx's;
- the WGAN-GP penalty on D's *sigmoid* score at α-interpolates
  (``:41-65``), the reference's form (dcgan_trainer.py:110-127), with the
  grad of the summed score taken by ``torch.autograd.grad``. With
  ``create_graph=True`` the penalty is differentiable with respect to D's
  parameters (double backward); without it, it is a value only.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def bce_from_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """mean BCE(sigmoid(logits), target) = mean(softplus(l) − t·l), in f32."""
    logits = logits.float()
    return torch.mean(F.softplus(logits) - target * logits)


def instance_noise_blend(x: torch.Tensor, noise: torch.Tensor,
                         noise_frac: float = 0.1) -> torch.Tensor:
    """``(1 - f)·x + f·noise`` in x's dtype (jckx casts its f32 draw to it)."""
    return (1.0 - noise_frac) * x + noise_frac * noise.to(x.dtype)


def gradient_penalty(d_score_fn: Callable[[torch.Tensor], torch.Tensor],
                     alpha: torch.Tensor, real: torch.Tensor, fake: torch.Tensor,
                     create_graph: bool = True, layout=None, image_h: int = 0) -> torch.Tensor:
    """``mean((‖∇ₓ Σ D(x̂)‖₂ − 1)²)`` at x̂ = α·real + (1 − α)·fake.

    ``d_score_fn`` maps images to per-sample sigmoid scores (N,); ``alpha``
    is (N, 1, 1, 1), U[0, 1) per sample, cast to the images' dtype. The
    per-sample norm is taken in f32 with ``+1e-24`` inside the root, as in
    jckx, so its grad stays finite at a zero gradient. Over a mesh's model
    axis ``layout`` (``parallel/layout.py``) turns this member's gradient
    into the global score's and sums each row's squares over the members
    that hold its pixels; ``image_h`` is the images' global height."""
    n = real.shape[0]
    alpha = alpha.to(real.dtype)
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_score_fn(interp).sum(), interp,
                                   create_graph=create_graph)
    if layout is not None:
        grads = layout.input_grad(grads, image_h)
    grads = grads.reshape(n, -1).float()
    sumsq = torch.sum(grads * grads, dim=1)
    if layout is not None:
        sumsq = layout.row_sumsq(sumsq, image_h)
    norms = torch.sqrt(sumsq + 1e-24)
    return torch.mean((norms - 1.0) ** 2)
