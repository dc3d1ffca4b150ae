"""The port's jax random numbers (jckx_torch/rng.py) against jax.random
itself (JAX 0.9, ``jax_threefry_partitionable`` on): the key of a seed and
the Threefry bits equal jax's exactly, the uniforms too, and the normals
(XLA's float32 erfinv rebuilt in torch ops) lie within 2e-6 of
``jax.random.normal`` — the artifact's z for a seed
(``jckx/export.py:92-103``)."""

import numpy as np
import jax
import pytest
import torch

from jckx_torch import rng

SEEDS = [0, 1, 7, 12345, 2**31 - 2, -3]
SHAPES = [(64, 100), (7,), (3, 5, 2), (512, 100)]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_equals_prngkey(seed):
    ref = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).astype(np.int64)
    assert [int(k) for k in rng.key_from_seed(seed)] == ref.tolist()
    assert [int(k) for k in rng.key_from_seed(torch.tensor(seed, dtype=torch.int32))] == ref.tolist()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_equal_jax(seed, shape):
    ref = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape)).astype(np.int64)
    got = rng.bits(rng.key_from_seed(seed), shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_equals_jax(seed):
    key = jax.random.PRNGKey(seed)
    for lo, hi in ((0.0, 1.0), (-1.0 + 2.0 ** -24, 1.0), (-3.0, 5.0)):
        ref = np.asarray(jax.random.uniform(key, (64, 100), minval=lo, maxval=hi))
        got = rng.uniform(rng.key_from_seed(seed), (64, 100), lo, hi).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_2e6_of_jax(seed, shape):
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = rng.normal_from_seed(seed, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)


def test_erfinv_edges_and_torch_erfinv():
    x = torch.tensor([-1.0, -0.999999, -0.5, 0.0, 0.25, 0.9999, 1.0])
    got = rng.erfinv(x)
    assert got[0] == -float("inf") and got[-1] == float("inf") and got[3] == 0.0
    # the same function as torch's to a few float32 ulps in the body
    torch.testing.assert_close(got[1:-1], torch.erfinv(x[1:-1]), rtol=2e-5, atol=1e-6)
