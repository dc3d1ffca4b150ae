"""The port's DCGAN G and D (jckx_torch/models/dcgan.py) against the JAX
package's ``generator_apply`` / ``discriminator_apply`` on the same weights,
carried over by ``params_from_jax``, on the same numpy inputs.

Tolerances: the small geometry (16², width 8, batch 8, f32) within 1e-4 —
f32 convolutions summed in another order, through BN, over 3 layers. The
full-width G (batch 2) within 3e-3: XLA-CPU's oneDNN convolutions take
Winograd-class algorithms (~1e-3 relative error) and the error compounds
over five layers (tests/test_model_torch_parity.py:15-18).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jckx.checkpoint.torch_convert import (
    _discriminator_map,
    _generator_map,
    params_to_torch,
)
from jckx.models import dcgan as jdcgan
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.models import dcgan as tdcgan

SMALL = dict(z_dim=16, image_size=16, channels=3, base_width=8)


def _jparams(net, geo, seed):
    init = jdcgan.generator_init if net == "g" else jdcgan.discriminator_init
    return {k: np.asarray(v) for k, v in init(jax.random.PRNGKey(seed), geo).items()}


def _port(net, jparams, geo):
    cls = tdcgan.Generator if net == "g" else tdcgan.Discriminator
    m = cls(tdcgan.GANGeometry(**vars(geo)))
    m.load_state_dict(params_from_jax(jparams, m.geo, which=net), strict=True)
    return m


@pytest.mark.parametrize("geo_kw,n,tol", [(SMALL, 8, 1e-4), ({}, 2, 3e-3)],
                         ids=["small", "full_width"])
def test_generator_matches_jckx(geo_kw, n, tol):
    geo = jdcgan.GANGeometry(**geo_kw)
    p = _jparams("g", geo, 0)
    z = np.random.RandomState(1).randn(n, geo.z_dim).astype(np.float32)
    ref = np.asarray(jdcgan.generator_apply(p, jnp.asarray(z), geo))
    with torch.no_grad():
        got = _port("g", p, geo)(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (n, geo.image_size, geo.image_size, geo.channels)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_discriminator_matches_jckx():
    geo = jdcgan.GANGeometry(**SMALL)
    p = _jparams("d", geo, 2)
    x = np.random.RandomState(3).rand(8, 16, 16, 3).astype(np.float32) * 2 - 1
    ref = np.asarray(jdcgan.discriminator_apply(p, jnp.asarray(x), geo))
    with torch.no_grad():
        got = _port("d", p, geo)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (8,)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("net", ["g", "d"])
def test_reference_state_dict_loads_strictly(net):
    geo = jdcgan.GANGeometry(**SMALL)
    p = _jparams(net, geo, 4)
    entries = _generator_map(geo) if net == "g" else _discriminator_map(geo)
    ref_sd = {k: torch.from_numpy(np.array(v))
              for k, v in params_to_torch(p, entries).items()}
    cls = tdcgan.Generator if net == "g" else tdcgan.Discriminator
    m = cls(tdcgan.GANGeometry(**SMALL))
    m.load_state_dict(ref_sd, strict=True)
    ours = params_from_jax(p, m.geo, which=net)
    assert set(ours) == set(ref_sd)
    for k, v in ours.items():
        torch.testing.assert_close(v, ref_sd[k], rtol=0, atol=0, msg=k)


def test_seeded_init_follows_reference_law():
    geo = tdcgan.GANGeometry()
    g1 = tdcgan.Generator(geo, gen=torch.Generator().manual_seed(0))
    g2 = tdcgan.Generator(geo, gen=torch.Generator().manual_seed(0))
    d = tdcgan.Discriminator(geo, gen=torch.Generator().manual_seed(1))
    # the reference geometry's parameter counts
    assert sum(p.numel() for p in g1.parameters()) == 3_576_704
    assert sum(p.numel() for p in d.parameters()) == 2_765_696
    for k, v in g1.state_dict().items():
        torch.testing.assert_close(v, g2.state_dict()[k], rtol=0, atol=0, msg=k)
    w = g1.conv2.weight
    assert abs(w.mean().item()) < 1e-3 and abs(w.std().item() - 0.02) < 1e-3
    s = g1.norm2.weight
    assert abs(s.mean().item() - 1.0) < 5e-3 and torch.all(g1.norm2.bias == 0)
