"""The port's CGAN G and D (jckx_torch/models/cgan.py) against the JAX
package's ``cgenerator_apply`` / ``cdiscriminator_apply`` on the same
weights (``params_from_jax``) and the same numpy inputs, at the tiny setup
(16², width 8, batch 8, f32, K = 100), and the reference ``.pt`` format in
both directions through jckx's exporter and importer.

D's dropout: jckx draws its keep-mask inside from ``dropout_key``; the test
draws the same mask with ``jax.random.bernoulli`` on that key and hands it
to the port. Tolerance: f32 within 1e-5 — the convolutions and Linears of
three small layers, summed in another order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from jckx.checkpoint.torch_convert import (export_torch_gan_checkpoint,
                                           import_torch_gan_checkpoint)
from jckx.models import cgan as jcgan
from jckx.models.dcgan import GANGeometry as JGeo
from jckx.train.state import make_template_state
from jckx_torch.checkpoint.checkpoint import save_checkpoint, state_payload
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.configs import Config
from jckx_torch.models import cgan as tcgan
from jckx_torch.models.dcgan import GANGeometry
from jckx_torch.train.state import create_cgan_state

SMALL = dict(z_dim=16, image_size=16, channels=3, base_width=8)
K, N = 100, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(N, 16, 16, 3).astype(np.float32) * 2 - 1
    z = rng.randn(N, SMALL["z_dim"]).astype(np.float32)
    onehot = np.eye(K, dtype=np.float32)[rng.randint(0, K, N)]
    return x, z, onehot


def _port_nets(pg, pd, geo):
    G, D = tcgan.CGenerator(geo, K), tcgan.CDiscriminator(geo, K)
    G.load_state_dict(params_from_jax(_np(pg), geo, "cg"), strict=True)
    D.load_state_dict(params_from_jax(_np(pd), geo, "cd"), strict=True)
    return G, D


def test_generator_matches_jckx():
    jgeo = JGeo(**SMALL)
    pg = jcgan.cgenerator_init(jax.random.PRNGKey(0), jgeo, K)
    G, _ = _port_nets(pg, jcgan.cdiscriminator_init(jax.random.PRNGKey(1), jgeo, K),
                      GANGeometry(**SMALL))
    _, z, onehot = _inputs(1)
    ref = np.asarray(jcgan.cgenerator_apply(pg, jnp.asarray(z), jnp.asarray(onehot), jgeo))
    with torch.no_grad():
        got = G(torch.from_numpy(z), torch.from_numpy(onehot)).numpy()
    assert got.shape == ref.shape == (N, 16, 16, 3)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("dropout", [False, True], ids=["eval-mode", "jckx-mask"])
def test_discriminator_matches_jckx(dropout):
    jgeo = JGeo(**SMALL)
    pd = jcgan.cdiscriminator_init(jax.random.PRNGKey(2), jgeo, K)
    _, D = _port_nets(jcgan.cgenerator_init(jax.random.PRNGKey(3), jgeo, K), pd,
                      GANGeometry(**SMALL))
    x, _, onehot = _inputs(2)
    key = jax.random.PRNGKey(7) if dropout else None
    ref = np.asarray(jcgan.cdiscriminator_apply(pd, jnp.asarray(x), jnp.asarray(onehot), jgeo,
                                                dropout_key=key))
    keep = (torch.from_numpy(np.asarray(jax.random.bernoulli(key, 1 - tcgan.DROPOUT,
                                                             (N, tcgan.HIDDEN)), np.float32))
            if dropout else None)
    with torch.no_grad():
        got = D(torch.from_numpy(x), torch.from_numpy(onehot), keep=keep).numpy()
    assert got.shape == ref.shape == (N,)
    np.testing.assert_allclose(got, ref, **TOL)
    if dropout:  # the mask matters: eval mode gives other logits
        with torch.no_grad():
            assert not np.allclose(D(torch.from_numpy(x), torch.from_numpy(onehot)).numpy(), ref)


def _is_adam(s):
    return isinstance(s, optax.ScaleByAdamState)


def _adam_of(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=_is_adam) if _is_adam(s)]
    return adam


def _with_random_moments(opt_state, rng):
    """Distinct random Adam moments, so that a wrong order or layout of the
    optimizer state cannot pass."""
    adam = _adam_of(opt_state)

    def rand(tree):
        return {k: np.abs(rng.randn(*np.shape(v))).astype(np.float32) + 1e-3
                for k, v in tree.items()}

    new = adam._replace(count=np.asarray(3, np.int32), mu=rand(adam.mu), nu=rand(adam.nu))
    return jax.tree_util.tree_map(lambda s: new if _is_adam(s) else s, opt_state,
                                  is_leaf=_is_adam)


def _jckx_state_with_moments():
    st = make_template_state(JGeo(**SMALL), conditional=True, num_classes=K)
    rng = np.random.RandomState(4)
    return st.replace(opt_g=_with_random_moments(st.opt_g, rng),
                      opt_d=_with_random_moments(st.opt_d, rng))


def test_reference_pt_loads_into_the_port(tmp_path):
    """A reference ``.pt`` written by jckx's exporter: strict load, jckx's
    logits, and Adam's moments in the port's parameter order."""
    st = _jckx_state_with_moments()
    geo, jgeo = GANGeometry(**SMALL), JGeo(**SMALL)
    path = str(tmp_path / "cgan.pt")
    export_torch_gan_checkpoint(st, conditional=True, geo=jgeo, num_classes=K, path=path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    G, D = tcgan.CGenerator(geo, K), tcgan.CDiscriminator(geo, K)
    G.load_state_dict(ckpt["model_g"], strict=True)
    D.load_state_dict(ckpt["model_d"], strict=True)

    x, z, onehot = _inputs(3)
    with torch.no_grad():
        got_d = D(torch.from_numpy(x), torch.from_numpy(onehot)).numpy()
        got_g = G(torch.from_numpy(z), torch.from_numpy(onehot)).numpy()
    np.testing.assert_allclose(got_d, np.asarray(jcgan.cdiscriminator_apply(
        st.params_d, jnp.asarray(x), jnp.asarray(onehot), jgeo)), **TOL)
    np.testing.assert_allclose(got_g, np.asarray(jcgan.cgenerator_apply(
        st.params_g, jnp.asarray(z), jnp.asarray(onehot), jgeo)), **TOL)

    state = create_cgan_state(Config(), G, D)
    state.opt_d.load_state_dict(ckpt["optimizer_d"])
    mu = params_from_jax(_np(_adam_of(st.opt_d).mu), geo, "cd")
    names = [n for n, _ in D.named_parameters()]
    assert names[:2] == ["label_embedding.weight", "label_embedding.bias"]
    assert names[-2:] == ["linear2.weight", "linear2.bias"]
    for name, p in D.named_parameters():
        torch.testing.assert_close(state.opt_d.state[p]["exp_avg"], mu[name], rtol=0, atol=0,
                                   msg=name)


def test_port_checkpoint_reads_back_in_jckx(tmp_path):
    """A CGAN checkpoint the port writes: jckx's importer recognizes it and
    gives the port's logits and the port's Adam moments."""
    geo, jgeo = GANGeometry(**SMALL), JGeo(**SMALL)
    gen = torch.Generator().manual_seed(5)
    G, D = tcgan.CGenerator(geo, K, gen=gen), tcgan.CDiscriminator(geo, K, gen=gen)
    cfg = Config()
    cfg.max_learning_rate = 2e-4
    state = create_cgan_state(cfg, G, D)
    for opt, net in ((state.opt_g, G), (state.opt_d, D)):  # one Adam step on random grads
        for p in net.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    path = str(tmp_path / "port.pt")
    save_checkpoint(path, state_payload(state))

    jst, info = import_torch_gan_checkpoint(path, lr=2e-4)
    assert info["conditional"] and info["num_classes"] == K and info["geo"] == jgeo
    x, z, onehot = _inputs(4)
    with torch.no_grad():
        got_d = D(torch.from_numpy(x), torch.from_numpy(onehot)).numpy()
        got_g = G(torch.from_numpy(z), torch.from_numpy(onehot)).numpy()
    np.testing.assert_allclose(np.asarray(jcgan.cdiscriminator_apply(
        jst.params_d, jnp.asarray(x), jnp.asarray(onehot), jgeo)), got_d, **TOL)
    np.testing.assert_allclose(np.asarray(jcgan.cgenerator_apply(
        jst.params_g, jnp.asarray(z), jnp.asarray(onehot), jgeo)), got_g, **TOL)
    mu = params_from_jax(_np(_adam_of(jst.opt_d).mu), geo, "cd")
    for name, p in D.named_parameters():
        torch.testing.assert_close(mu[name], state.opt_d.state[p]["exp_avg"], rtol=0, atol=0,
                                   msg=name)


def test_seeded_init_follows_reference_laws():
    geo = GANGeometry()
    gen = torch.Generator().manual_seed(0)
    G, D = tcgan.CGenerator(geo, 100, gen=gen), tcgan.CDiscriminator(geo, 100, gen=gen)
    # the reference geometry's parameter counts (model/CGAN.py, K = 100)
    assert sum(p.numel() for p in G.parameters()) == 4_395_904
    assert sum(p.numel() for p in D.parameters()) == 4_926_569
    assert G.conv1.weight.shape == (200, 512, 4, 4)
    w = D.linear1.weight.detach()  # torch's default Linear law: U(±1/√fan_in)
    bound = 1 / np.sqrt(w.shape[1])
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.99 * bound
    assert abs(float(w.mean())) < 1e-3 * bound * 10
    assert float(D.conv1.weight.detach().std()) == pytest.approx(0.02, rel=0.05)
    assert torch.all(D.norm1.bias == 0) and abs(float(D.norm1.weight.mean()) - 1) < 5e-3
    G2 = tcgan.CGenerator(geo, 100, gen=torch.Generator().manual_seed(0))
    assert torch.equal(G2.conv1.weight, G.conv1.weight)
