"""The port's losses (jckx_torch/ops/losses.py) against ``jckx.ops.losses``
on the same numpy inputs: BCE and the blend within 1e-5 (the same f32
arithmetic in another order; the bf16 blend within one bf16 ulp). The
penalty runs both packages' DCGAN D at the tiny geometry (16², width 8,
batch 8, f32) on the same weights (``params_from_jax``), with jckx's α
rebuilt from its key and handed to the port: within 1e-4 relative, as
it goes through D's convolutions and their gradients, summed in another
order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jckx.models import dcgan as jdcgan
from jckx.ops import losses as jl
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.models import dcgan as tdcgan
from jckx_torch.ops import losses as tl

GEO = dict(z_dim=16, image_size=16, channels=3, base_width=8)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("target", [0.9, 0.1, 1.0, 0.0])
def test_bce_from_logits_matches_jckx(target):
    logits = (np.random.RandomState(0).randn(64) * 4).astype(np.float32)
    ref = float(jl.bce_from_logits(jnp.asarray(logits), target))
    got = float(tl.bce_from_logits(torch.from_numpy(logits), target))
    np.testing.assert_allclose(got, ref, **TOL)


def test_bce_equals_torch_bce_on_sigmoid():
    logits = np.random.RandomState(1).randn(32).astype(np.float32)
    t = torch.from_numpy(logits)
    ref = torch.nn.BCELoss()(torch.sigmoid(t), torch.full_like(t, 0.9))
    np.testing.assert_allclose(float(tl.bce_from_logits(t, 0.9)), float(ref), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_noise_blend_matches_jckx(dtype):
    x = np.random.RandomState(2).rand(4, 8, 8, 3).astype(np.float32) * 2 - 1
    key = jax.random.PRNGKey(5)
    ref = jl.instance_noise_blend(key, jnp.asarray(x).astype(getattr(jnp, dtype)), 0.1)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    got = tl.instance_noise_blend(torch.from_numpy(x).to(getattr(torch, dtype)),
                                  torch.from_numpy(noise), 0.1)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2  # one bf16 ulp at |y| < 2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("create_graph", [True, False])
def test_gradient_penalty_matches_jckx(create_graph):
    geo = jdcgan.GANGeometry(**GEO)
    p = {k: np.asarray(v) for k, v in jdcgan.discriminator_init(jax.random.PRNGKey(0), geo).items()}
    rng = np.random.RandomState(3)
    real = rng.rand(8, 16, 16, 3).astype(np.float32) * 2 - 1
    fake = rng.rand(8, 16, 16, 3).astype(np.float32) * 2 - 1
    key = jax.random.PRNGKey(7)
    ref = float(jl.gradient_penalty(
        lambda x: jax.nn.sigmoid(jdcgan.discriminator_apply(p, x, geo)),
        key, jnp.asarray(real), jnp.asarray(fake)))
    alpha = np.asarray(jax.random.uniform(key, (8, 1, 1, 1), jnp.float32))

    D = tdcgan.Discriminator(tdcgan.GANGeometry(**GEO))
    D.load_state_dict(params_from_jax(p, D.geo, which="d"))
    gp = tl.gradient_penalty(lambda x: torch.sigmoid(D(x)), torch.from_numpy(alpha),
                             torch.from_numpy(real), torch.from_numpy(fake),
                             create_graph=create_graph)
    np.testing.assert_allclose(float(gp.detach()), ref, rtol=1e-4, atol=1e-5)
    assert gp.requires_grad == create_graph
    if create_graph:  # double backward reaches D's parameters
        gp.backward()
        assert all(q.grad is not None and torch.isfinite(q.grad).all() for q in D.parameters())
