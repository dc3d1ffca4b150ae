"""FID, intra-FID and Inception-Score math — port of
``jckx/metrics/fid.py:54-125``, plain torch in f32, on the features' device.

- ``psd_sqrtm``: √A of a symmetric PSD matrix through ``eigh``, negative
  eigenvalues clamped at 0;
- ``frechet_distance``: ‖μ₁−μ₂‖² + tr Σ₁ + tr Σ₂ − 2 tr √(√Σ₁ Σ₂ √Σ₁), the
  symmetrized form (the trace of √(Σ₁Σ₂) without leaving symmetric PSD
  matrices), as jckx computes it;
- ``mean_and_cov``: row-observation mean and unbiased covariance;
- ``intra_fid_sum``: Σ over superclasses of FID(real s ‖ fake s), all of
  them in one batched call (jckx vmaps the same functions);
- ``inception_score_from_probs``: the reference's 10 contiguous splits
  (metrics.py:97-110).

The first three take leading batch dimensions: a stack of S matrices or
feature sets gives S results.
"""

from __future__ import annotations

from typing import Tuple

import torch


def psd_sqrtm(a: torch.Tensor) -> torch.Tensor:
    a = 0.5 * (a + a.mT).float()
    w, v = torch.linalg.eigh(a)
    return (v * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]) @ v.mT


def _trace(a: torch.Tensor) -> torch.Tensor:
    return a.diagonal(dim1=-2, dim2=-1).sum(-1)


def frechet_distance(mu1: torch.Tensor, sigma1: torch.Tensor,
                     mu2: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    mu1, mu2 = mu1.float(), mu2.float()
    s1 = psd_sqrtm(sigma1)
    covmean = psd_sqrtm(s1 @ sigma2.float() @ s1)
    diff = torch.sum((mu1 - mu2) ** 2, dim=-1)
    return diff + _trace(sigma1.float()) + _trace(sigma2.float()) - 2.0 * _trace(covmean)


def mean_and_cov(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    feats = feats.float()
    mu = feats.mean(-2)
    x = feats - mu[..., None, :]
    return mu, (x.mT @ x) / (feats.shape[-2] - 1)


def intra_fid_sum(feats: torch.Tensor, bucket_idx: torch.Tensor,
                  mu_real: torch.Tensor, sigma_real: torch.Tensor) -> torch.Tensor:
    """Σ_s FID(real superclass s ‖ fake superclass s). ``feats`` (N, d) fake
    features; ``bucket_idx`` (S, k) the rows of each superclass's fakes
    (one bucket size, as the class-major grid gives at K = 100);
    ``mu_real`` / ``sigma_real`` (S, d) / (S, d, d) the real statistics."""
    mu_f, sigma_f = mean_and_cov(feats.float()[bucket_idx])  # (S, k, d) → (S, d), (S, d, d)
    return frechet_distance(mu_real, sigma_real, mu_f, sigma_f).sum()


def inception_score_from_probs(probs: torch.Tensor, splits: int = 10) -> torch.Tensor:
    """mean over splits of exp(mean_i KL(p(y|xᵢ) ‖ p(y))); rows past
    ``splits · (n // splits)`` are unused, as in the reference."""
    chunk = probs.shape[0] // splits
    p = probs[: chunk * splits].reshape(splits, chunk, -1).float()
    py = p.mean(1, keepdim=True)
    kl = torch.sum(p * (torch.log(p + 1e-12) - torch.log(py + 1e-12)), dim=-1)
    return torch.mean(torch.exp(kl.mean(1)))
