"""The port's CGAN train step (``make_cgan_train_step``, jckx_torch/train/
steps.py) against jckx's jitted ``make_cgan_train_step`` on the same weights
(``params_from_jax``), the same batches and labels, and the same random
draws, at the tiny setup (16², width 8, batch 8, f32, K = 10).

jckx draws inside its step from an 8-way split of ``fold_in(state.rng,
state.step)``: real noise, z, fake noise, α, and the dropout keys of D's
real, fake, penalty and G passes. The test rebuilds those draws with the
same key arithmetic (the masks as jckx's ``bernoulli`` gives them) and
injects them into the port's step.

Tolerances, as tests/test_torch_train_step.py and for the reasons of
tests/test_step_torch_parity.py:22-35: telemetry within 3e-3; Adam deltas
where the port's last gradient clears 1 % of its leaf's maximum, within 5 %
of lr per step taken, the mask covering most elements.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jckx.train.state import create_cgan_state, geometry
from jckx.train.steps import make_cgan_train_step as jstep
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.models import cgan as tcgan
from jckx_torch.models.dcgan import GANGeometry
from jckx_torch.train import state as tstate
from jckx_torch.train.steps import METRIC_NAMES, StepDraws, make_cgan_train_step, make_draws
from test_torch_train_step import LR, N, TINY, _assert_deltas, _cfgs, _port_sd
from torch_threads import one_torch_thread  # noqa: F401

K = 10
CASES = {"1step": ({}, 1), "3steps": ({}, 3), "ema-3steps": (dict(ema_decay=0.9), 3)}


def _draws(state, geo):
    k = jax.random.fold_in(state.rng, int(state.step))
    k_real, k_z, k_fake, k_alpha, k_dr, k_df, k_di, k_dg = jax.random.split(k, 8)
    shape = (N, geo.image_size, geo.image_size, geo.channels)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    keep = {name: t(jax.random.bernoulli(kk, 1 - tcgan.DROPOUT, (N, tcgan.HIDDEN)))
            for name, kk in (("keep_real", k_dr), ("keep_fake", k_df), ("keep_gp", k_di),
                             ("keep_g", k_dg))}
    return StepDraws(real_noise=t(jax.random.normal(k_real, shape, jnp.float32)),
                     z=t(jax.random.normal(k_z, (N, geo.z_dim), jnp.float32)),
                     fake_noise=t(jax.random.normal(k_fake, shape, jnp.float32)),
                     alpha=t(jax.random.uniform(k_alpha, (N, 1, 1, 1), jnp.float32)), **keep)


@pytest.mark.parametrize("case", list(CASES))
def test_cgan_step_matches_jckx(case):
    over, steps = CASES[case]
    jc, tc = _cfgs({"num_classes": K, **over})
    geo = geometry(jc)
    st = create_cgan_state(jc, jax.random.PRNGKey(1))
    if jc.ema_decay > 0:
        st = st.replace(ema_g=jax.tree_util.tree_map(jnp.copy, st.params_g))
    rng = np.random.RandomState(11)
    real = [rng.rand(N, 16, 16, 3).astype(np.float32) * 2 - 1 for _ in range(steps)]
    onehot = [np.eye(K, dtype=np.float32)[rng.randint(0, K, N)] for _ in range(steps)]

    tgeo = GANGeometry(**vars(geo))
    G, D = tcgan.CGenerator(tgeo, K), tcgan.CDiscriminator(tgeo, K)
    g0, d0 = _port_sd(st.params_g, tgeo, "cg"), _port_sd(st.params_d, tgeo, "cd")
    for net, params, which in ((G, st.params_g, "cg"), (D, st.params_d, "cd")):
        net.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()}, tgeo,
                                            which))
    ts = tstate.create_cgan_state(tc, G, D)

    jit_step = jax.jit(jstep(jc, geo))
    port_step = make_cgan_train_step(tc, tgeo)
    for i in range(steps):
        draws = _draws(st, geo)
        st, jm = jit_step(st, jnp.asarray(real[i]), jnp.asarray(onehot[i]))
        tm = port_step(ts, torch.from_numpy(real[i]), torch.from_numpy(onehot[i]), draws)
        assert set(tm) == set(METRIC_NAMES)
        for name in METRIC_NAMES:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=3e-3, atol=3e-3,
                                       err_msg=f"step {i}: {name}")
    assert ts.step == int(st.step) == steps

    g_grads = {k: p.grad.numpy() for k, p in G.named_parameters()}
    d_grads = {k: p.grad.numpy() for k, p in D.named_parameters()}
    _assert_deltas(g0, _port_sd(st.params_g, tgeo, "cg"), G, g_grads, LR, steps, "G")
    _assert_deltas(d0, _port_sd(st.params_d, tgeo, "cd"), D, d_grads, LR, steps, "D")
    if jc.ema_decay > 0:
        _assert_deltas(g0, _port_sd(st.ema_g, tgeo, "cg"), ts.ema_g, g_grads, LR, steps, "EMA",
                       scale=1 - jc.ema_decay)


def test_cgan_draws_add_four_masks():
    geo = GANGeometry(**{k: TINY[k] for k in ("z_dim", "image_size", "channels", "base_width")})
    a = make_draws(3, 2, 64, geo, torch.device("cpu"), conditional=True)
    b = make_draws(3, 2, 64, geo, torch.device("cpu"))
    for name in ("real_noise", "z", "fake_noise", "alpha"):  # DCGAN's draws come first
        assert torch.equal(getattr(a, name), getattr(b, name))
    masks = [a.keep_real, a.keep_fake, a.keep_gp, a.keep_g]
    assert b.keep_real is None and all(m.shape == (64, tcgan.HIDDEN) for m in masks)
    assert all(set(m.unique().tolist()) == {0.0, 1.0} for m in masks)
    assert not torch.equal(masks[0], masks[1])
    assert abs(float(torch.stack(masks).mean()) - (1 - tcgan.DROPOUT)) < 0.02
