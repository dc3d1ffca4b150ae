"""KID and precision / recall / density / coverage — port of
``jckx/metrics/extra.py``, in the feature space FID uses (the backbone's
logits, one extraction per eval).

- ``kid``: the Kernel Inception Distance (Bińkowski et al. 2018), the
  unbiased MMD² with the polynomial kernel k(x, y) = (γ·xᵀy + c)³, its
  mean and (population) std over ``subsets`` subsets, each drawing
  ``subset_size`` rows of each set without replacement. The draws are an
  argument, as the train step's are: ``perms`` (one (real, fake) pair of
  index vectors per subset) or, by default, ``torch.randperm`` from a CPU
  ``torch.Generator`` seeded with ``seed``, so the subsets do not depend on
  the device. jckx draws them with ``jax.random.permutation``; the tests
  pass jckx's.
- ``manifold_metrics``: improved precision and recall (Kynkäänniemi et
  al. 2019) and density and coverage (Naeem et al. 2020) from per-point
  k-NN radii. Every pairwise sweep is row-chunked (``row_chunk`` × n
  distance tiles), so an n × n matrix never materializes.

jckx computes both in plain jnp (no Pallas kernel), and here they are
plain torch matmuls in f32 on the features' device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch


def _features(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _check_pair(real: torch.Tensor, fake: torch.Tensor, what: str) -> None:
    if real.dim() != 2 or fake.dim() != 2 or real.shape[1] != fake.shape[1]:
        raise ValueError(f"{what} expects (n, d) feature arrays with equal d, got "
                         f"{tuple(real.shape)} vs {tuple(fake.shape)}")


def kid_permutations(n_real: int, n_fake: int, subsets: int, seed: int = 0) -> list:
    """The default subset draws: per subset a permutation of the real rows,
    then one of the fake rows, from one CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randperm(n_real, generator=gen), torch.randperm(n_fake, generator=gen))
            for _ in range(subsets)]


def kid(real_features, fake_features, *, subsets: int = 100, subset_size: int = 1000,
        degree: int = 3, gamma: Optional[float] = None, coef0: float = 1.0, seed: int = 0,
        perms: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
        device=None) -> Tuple[float, float]:
    """Kernel Inception Distance → (mean, std) over the subsets. Each
    subset takes the first m = min(``subset_size``, n_real, n_fake) rows of
    its permutations (``perms``, default ``kid_permutations(seed)``).
    ``gamma`` defaults to 1 / feature dim."""
    real, fake = _features(real_features, device), _features(fake_features, device)
    _check_pair(real, fake, "kid")
    m = int(min(subset_size, real.shape[0], fake.shape[0]))
    if m < 2:
        raise ValueError(f"kid needs >= 2 rows per subset, got {m}")
    g = 1.0 / real.shape[1] if gamma is None else float(gamma)
    if perms is None:
        perms = kid_permutations(real.shape[0], fake.shape[0], subsets, seed)
    if len(perms) != subsets:
        raise ValueError(f"kid: {len(perms)} permutation pairs for {subsets} subsets")

    def kpoly(a, b):
        return (g * (a @ b.T) + coef0) ** degree

    off = 1.0 / (m * (m - 1.0))
    vals = []
    for pr, pf in perms:
        x = real[torch.as_tensor(pr, device=real.device)[:m]]
        y = fake[torch.as_tensor(pf, device=fake.device)[:m]]
        kxx, kyy = kpoly(x, x), kpoly(y, y)
        vals.append((kxx.sum() - kxx.trace()) * off + (kyy.sum() - kyy.trace()) * off
                    - 2.0 * kpoly(x, y).mean())
    vals = torch.stack(vals)
    return float(vals.mean()), float(vals.std(unbiased=False))


def _dists(q: torch.Tensor, a: torch.Tensor, a_sq: torch.Tensor) -> torch.Tensor:
    """Euclidean distances (c, n) of a query tile against the whole set."""
    d2 = (q * q).sum(1)[:, None] + a_sq[None, :] - 2.0 * (q @ a.T)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def real_knn_radii(x, k: int = 3, chunk: int = 2048, device=None) -> torch.Tensor:
    """Per row, the distance to its k-th nearest other row (n,): rank 0 of
    the ascending order is the row itself, so the k-th neighbour is rank k.
    The radii of a fixed set, computed once (``manifold_metrics``'s
    ``real_radii``)."""
    x = _features(x, device)
    x_sq = (x * x).sum(1)
    return torch.cat([torch.topk(_dists(x[i:i + chunk], x, x_sq), k + 1, dim=1,
                                 largest=False).values[:, k]
                      for i in range(0, x.shape[0], chunk)])


def _manifold_sweep(q: torch.Tensor, a: torch.Tensor, radii_a: torch.Tensor, chunk: int):
    """Per query row against the manifold {ball(a_i, radii_a[i])}: (hit
    count, any hit, min distance), one row-chunked sweep serving density,
    precision and recall, and coverage."""
    a_sq = (a * a).sum(1)
    cnt, anyhit, dmin = [], [], []
    for i in range(0, q.shape[0], chunk):
        d = _dists(q[i:i + chunk], a, a_sq)
        hit = d <= radii_a[None, :]
        cnt.append(hit.sum(1))
        anyhit.append(hit.any(1))
        dmin.append(d.min(1).values)
    return torch.cat(cnt), torch.cat(anyhit), torch.cat(dmin)


def manifold_metrics(real_features, fake_features, *, k: int = 3, row_chunk: int = 2048,
                     real_radii=None, device=None) -> Dict[str, float]:
    """Precision, recall, density and coverage of fake against real:

    - precision: the share of fakes inside at least one real k-NN ball;
    - recall: the share of reals inside at least one fake k-NN ball;
    - density: the mean count of real balls holding a fake, ÷ k;
    - coverage: the share of reals whose nearest fake lies in their own ball.

    ``real_radii``: the real set's k-NN radii for this k, computed once by
    a caller that scores many fake sets against one real set."""
    real, fake = _features(real_features, device), _features(fake_features, device)
    _check_pair(real, fake, "manifold_metrics")
    if min(real.shape[0], fake.shape[0]) <= k:
        raise ValueError(f"manifold_metrics needs > k={k} rows in each set, got "
                         f"{real.shape[0]} real / {fake.shape[0]} fake")
    chunk = int(row_chunk)
    radii_r = (real_knn_radii(real, k, chunk) if real_radii is None
               else torch.as_tensor(real_radii, dtype=torch.float32, device=real.device))
    radii_f = real_knn_radii(fake, k, chunk)
    f_cnt, f_any, _ = _manifold_sweep(fake, real, radii_r, chunk)
    _, r_any, r_dmin = _manifold_sweep(real, fake, radii_f, chunk)
    return {"precision": float(f_any.float().mean()), "recall": float(r_any.float().mean()),
            "density": float(f_cnt.float().mean() / k),
            "coverage": float((r_dmin <= radii_r).float().mean())}
