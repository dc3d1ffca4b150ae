"""The port's DCGAN train step (jckx_torch/train/steps.py) against jckx's
jitted ``make_dcgan_train_step`` on the same weights (``params_from_jax``)
and the same random draws, at the tiny setup of
tests/test_step_torch_parity.py (16², width 8, batch 8, f32).

jckx draws inside its step from ``fold_in(state.rng, state.step)``; the
test rebuilds those draws with the same key arithmetic and injects them
into the port's step, so both evaluate the same function.

Tolerances, with the reasons of tests/test_step_torch_parity.py:22-35:
- the six telemetry scalars of every step within 3e-3 (batch means);
- parameter deltas from the start, compared only where the port's last
  gradient clears 1 % of its leaf's maximum (elsewhere the sign of an
  Adam update is conv-noise), within 5 % of lr per step taken; the mask
  must cover most elements. A wiring fault moves whole fractions of a
  leaf by about lr.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jckx.configs import Config as JConfig
from jckx.train.state import create_dcgan_state, geometry
from jckx.train.steps import make_dcgan_train_step as jstep
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.configs import Config
from jckx_torch.models import dcgan as tdcgan
from jckx_torch.train import state as tstate
from jckx_torch.train.steps import METRIC_NAMES, StepDraws, make_dcgan_train_step
from torch_threads import one_torch_thread  # noqa: F401

N = 8
LR = 2e-4
TINY = dict(image_size=16, base_width=8, channels=3, batch_size=N, z_dim=16,
            compute_dtype="float32", max_learning_rate=LR)

CASES = {  # name: (config overrides, steps)
    "gp1-1step": (dict(gp_in_d_grad=True), 1),
    "gp0-1step": (dict(gp_in_d_grad=False), 1),
    "gp1-3steps": (dict(gp_in_d_grad=True), 3),
    "gp0-3steps": (dict(gp_in_d_grad=False), 3),
    "ema-3steps": (dict(ema_decay=0.9), 3),
    "cosine-3steps": (dict(lr_schedule="cosine", lr_decay_steps=4,
                           min_learning_rate=2e-5), 3),
}


def _cfgs(over):
    jc, tc = JConfig(), Config()
    for k, v in {**TINY, **over}.items():
        setattr(jc, k, v)
        setattr(tc, k, v)
    return jc, tc


def _draws(state, geo):
    """steps.py's in-step draws, rebuilt with the same key arithmetic."""
    k = jax.random.fold_in(state.rng, int(state.step))
    k_real, k_z, k_fake, k_alpha = jax.random.split(k, 4)
    shape = (N, geo.image_size, geo.image_size, geo.channels)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return StepDraws(real_noise=t(jax.random.normal(k_real, shape, jnp.float32)),
                     z=t(jax.random.normal(k_z, (N, geo.z_dim), jnp.float32)),
                     fake_noise=t(jax.random.normal(k_fake, shape, jnp.float32)),
                     alpha=t(jax.random.uniform(k_alpha, (N, 1, 1, 1), jnp.float32)))


def _port_sd(params, geo, which):
    return {k: v.numpy() for k, v in params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, geo, which).items()
        if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def _assert_deltas(p0, p_jax, module, grads_of, lr, steps, label, scale=1.0):
    total = covered = 0
    for k, a0 in p0.items():
        dj = p_jax[k] - a0
        dt = module.state_dict()[k].numpy() - a0
        g = np.abs(grads_of[k])
        mask = g > 1e-2 * g.max() + 1e-12
        total += mask.size
        covered += int(mask.sum())
        np.testing.assert_allclose(dj[mask], dt[mask], rtol=0, atol=0.05 * lr * steps * scale,
                                   err_msg=f"{label}/{k}: masked Adam deltas disagree")
    assert covered / total > 0.5, f"{label}: the mask covers {covered}/{total} elements"


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jckx(case):
    over, steps = CASES[case]
    jc, tc = _cfgs(over)
    geo = geometry(jc)
    st = create_dcgan_state(jc, jax.random.PRNGKey(0))
    if jc.ema_decay > 0:
        st = st.replace(ema_g=jax.tree_util.tree_map(jnp.copy, st.params_g))
    real = [np.random.RandomState(10 + i).rand(N, 16, 16, 3).astype(np.float32) * 2 - 1
            for i in range(steps)]

    tgeo = tdcgan.GANGeometry(**vars(geo))
    G, D = tdcgan.Generator(tgeo), tdcgan.Discriminator(tgeo)
    G.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in st.params_g.items()}, tgeo, "g"))
    D.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in st.params_d.items()}, tgeo, "d"))
    ts = tstate.create_dcgan_state(tc, G, D)
    g0, d0 = _port_sd(st.params_g, tgeo, "g"), _port_sd(st.params_d, tgeo, "d")

    jit_step = jax.jit(jstep(jc, geo))
    port_step = make_dcgan_train_step(tc, tgeo)
    for i in range(steps):
        draws = _draws(st, geo)
        st, jm = jit_step(st, jnp.asarray(real[i]))
        tm = port_step(ts, torch.from_numpy(real[i]), draws)
        assert set(tm) == set(METRIC_NAMES) and all(v.dtype == torch.float32 for v in tm.values())
        for name in METRIC_NAMES:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=3e-3, atol=3e-3,
                                       err_msg=f"step {i}: {name}")
    assert ts.step == int(st.step) == steps

    g_grads = {k: p.grad.numpy() for k, p in G.named_parameters()}
    d_grads = {k: p.grad.numpy() for k, p in D.named_parameters()}
    _assert_deltas(g0, _port_sd(st.params_g, tgeo, "g"), G, g_grads, LR, steps, "G")
    _assert_deltas(d0, _port_sd(st.params_d, tgeo, "d"), D, d_grads, LR, steps, "D")
    if jc.ema_decay > 0:
        # the EMA moves by (1 - decay) of G's moves, and so does its noise
        _assert_deltas(g0, _port_sd(st.ema_g, tgeo, "g"), ts.ema_g, g_grads, LR, steps, "EMA",
                       scale=1 - jc.ema_decay)
    if jc.lr_schedule == "cosine":
        assert tstate.adam_count(ts.opt_g) == steps
        f = tstate.cosine_factor(tc, steps - 1)
        assert ts.opt_g.param_groups[0]["lr"] == pytest.approx(LR * f)


def test_port_draws_follow_seed_and_step():
    from jckx_torch.train.steps import make_draws

    geo = tdcgan.GANGeometry(z_dim=16, image_size=16, channels=3, base_width=8)
    a = make_draws(1, 5, 4, geo, torch.device("cpu"))
    b = make_draws(1, 5, 4, geo, torch.device("cpu"))
    c = make_draws(1, 6, 4, geo, torch.device("cpu"))
    for name in ("real_noise", "z", "fake_noise", "alpha"):
        assert torch.equal(getattr(a, name), getattr(b, name))
        assert not torch.equal(getattr(a, name), getattr(c, name))
    assert a.real_noise.shape == (4, 16, 16, 3) and a.alpha.shape == (4, 1, 1, 1)
    assert 0 <= float(a.alpha.min()) and float(a.alpha.max()) < 1


def test_cosine_factor_matches_optax():
    import optax

    _, tc = _cfgs(dict(lr_schedule="cosine", lr_decay_steps=10, min_learning_rate=1e-5))
    sched = optax.cosine_decay_schedule(1.0, 10, alpha=1e-5 / LR)
    for count in (0, 1, 5, 10, 12):
        assert tstate.cosine_factor(tc, count) == pytest.approx(float(sched(count)), rel=1e-6)
    _, bad = _cfgs(dict(lr_schedule="cosine"))
    with pytest.raises(ValueError, match="lr_decay_steps"):
        tstate.make_optimizer(bad, [torch.nn.Parameter(torch.zeros(1))])
