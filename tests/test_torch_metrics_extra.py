"""The port's KID, PRDC (jckx_torch/metrics/extra.py, ``Metrics.kid`` /
``Metrics.prdc``) and space-to-depth InceptionV3 stem against jckx's.

- KID with jckx's subset permutations injected (``jax.random.permutation``
  of the keys ``jckx.metrics.extra._kid_device`` splits), and precision /
  recall / density / coverage: within 1e-5 relative of
  ``jckx.metrics.extra`` on the same seeded features; row-chunk invariant;
  the full-set KID equals jckx's float64 numpy reference. KID's std,
  a spread of near-equal estimates, within 1e-5 of the mean's magnitude.
- The engine: ``Metrics.kid`` / ``prdc`` on its real features, the real
  k-NN radii swept once per k, and the ``-s2d`` real-feature cache key.
- The s2d stem: ``Conv2d_1a_3x3`` in its space-to-depth form against the
  strided convolution and against jckx's ``_bconv_1a_s2d`` (f32, 1e-5 of
  the largest magnitude), and the whole ``fast_stem`` forward against
  jckx's ``apply(..., fast_stem=True)`` at 75² (1e-3 of the largest
  logit, as tests/test_torch_metrics.py holds the plain forward).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jckx.metrics import extra as jextra
from jckx.metrics import inception_v3 as jiv
from jckx_torch.metrics import extra as textra
from jckx_torch.metrics import inception_v3 as tiv
from jckx_torch.metrics.metrics import Metrics
from torch_threads import one_torch_thread  # noqa: F401

K = 10


def _features(seed=0, n_real=300, n_fake=200, d=10):
    rng = np.random.RandomState(seed)
    real = rng.randn(n_real, d).astype(np.float32)
    fake = (rng.randn(n_fake, d) * 1.1 + 0.2).astype(np.float32)
    return real, fake


def jckx_perms(n_real, n_fake, subsets, seed):
    """The subset draws of ``jckx.metrics.extra.kid(..., seed=seed)``."""
    out = []
    for k in jax.random.split(jax.random.PRNGKey(seed), subsets):
        kr, kf = jax.random.split(k)
        out.append((torch.from_numpy(np.array(jax.random.permutation(kr, n_real))),
                    torch.from_numpy(np.array(jax.random.permutation(kf, n_fake)))))
    return out


@pytest.mark.parametrize("subset_size", [50, 150, 1000])
def test_kid_matches_jckx_with_its_permutations(subset_size):
    real, fake = _features()
    ref = jextra.kid(real, fake, subsets=6, subset_size=subset_size, seed=3)
    got = textra.kid(real, fake, subsets=6, subset_size=subset_size,
                     perms=jckx_perms(300, 200, 6, 3))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    # the std of near-equal subset estimates: f32 rounding of the mean's size
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5 * abs(ref[0]))
    # with m = both whole sets every subset is the full-set estimator (jckx's f64 reference)
    full = textra.kid(real[:200], fake, subsets=2, subset_size=subset_size)
    if subset_size >= 200:
        np.testing.assert_allclose(full[0], jextra.kid_numpy_full(real[:200], fake), rtol=1e-4)
    # the default draws come from a CPU torch generator: deterministic in the seed
    assert textra.kid(real, fake, subsets=6, seed=1) == textra.kid(real, fake, subsets=6, seed=1)
    with pytest.raises(ValueError, match="permutation pairs"):
        textra.kid(real, fake, subsets=6, perms=jckx_perms(300, 200, 2, 0))


@pytest.mark.parametrize("k", [3, 5])
def test_prdc_matches_jckx_and_is_chunk_invariant(k):
    real, fake = _features(1)
    ref = jextra.manifold_metrics(real, fake, k=k)
    for chunk in (2048, 64, 7):
        got = textra.manifold_metrics(real, fake, k=k, row_chunk=chunk)
        assert set(got) == set(ref)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(textra.real_knn_radii(real, k).numpy(),
                               np.asarray(jextra.real_knn_radii(real, k)), rtol=1e-5)
    with pytest.raises(ValueError, match="needs > k"):
        textra.manifold_metrics(real[:k], fake, k=k)


class _Pool(torch.nn.Module):
    """InceptionV3's interface on a seeded linear map of a 4×4 pool."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(48, K)
        self.stems = []

    def forward(self, x, compute_dtype=torch.float32, fast_stem=False):
        self.stems.append(fast_stem)
        pooled = torch.nn.functional.adaptive_avg_pool2d(x.permute(0, 3, 1, 2).float(), 4)
        return self.fc(pooled.flatten(1))


def test_engine_kid_prdc_and_s2d_cache_key(tmp_path):
    rng = np.random.RandomState(2)
    real = rng.randint(0, 256, (40, 16, 16, 3), np.uint8)
    labels = np.arange(40, dtype=np.int32) % K
    net = _Pool()
    kw = dict(backbone=net, batch_size=40, compute_dtype=torch.float32, cache_dir=str(tmp_path),
              num_classes=K, device="cpu")
    m = Metrics((real, labels), **kw)
    s2d = Metrics((real, labels), fast_stem=True, **kw)
    assert net.stems == [False, True] and sorted(f.endswith("-s2d.npz")
                                                 for f in os.listdir(tmp_path)) == [False, True]
    fake = rng.randn(30, K).astype(np.float32)
    ref = jextra.kid(m.real_features, fake, subsets=4, subset_size=20, seed=0)
    np.testing.assert_allclose(
        m.kid(features=fake, subsets=4, subset_size=20, perms=jckx_perms(40, 30, 4, 0)), ref,
        rtol=1e-5)
    got = m.prdc(features=fake)
    want = jextra.manifold_metrics(m.real_features, fake)
    assert got == pytest.approx(want, rel=1e-5)
    radii = m._real_knn_radii[3]
    m.prdc(features=fake[:10])
    assert m._real_knn_radii[3] is radii and s2d.fast_stem and not m.fast_stem


@pytest.fixture(scope="module")
def seeded():
    return jiv.init(0, num_classes=K), tiv.init(0, num_classes=K)


@pytest.mark.parametrize("side", [299, 76])
def test_s2d_stem_equals_the_strided_conv_and_jckx(seeded, side):
    jp, net = seeded
    x = np.random.RandomState(3).randn(2, side, side, 3).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    stem = net.Conv2d_1a_3x3
    with torch.no_grad():
        got, plain = stem.stem_s2d(xt), stem(xt)
    ref = np.asarray(jiv._bconv_1a_s2d(jp["Conv2d_1a_3x3"], jnp.asarray(x))).transpose(0, 3, 1, 2)
    assert got.shape == plain.shape == ref.shape == (2, 32, (side - 3) // 2 + 1,
                                                    (side - 3) // 2 + 1)
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


def test_fast_stem_forward_matches_jckx(seeded):
    jp, net = seeded
    x = np.random.RandomState(4).randn(2, 75, 75, 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jiv.apply(p, v, jnp.float32, fast_stem=True))(jp, x))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.float32, fast_stem=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * np.abs(ref).max())
