"""The port's FusedProp steps (``cfg.fused_prop = 1``, jckx_torch/train/
steps.py) against jckx's jitted ``make_dcgan_train_step`` /
``make_cgan_train_step`` with ``fused_prop = 1``, on the same weights, the
same batches and jckx's draws injected, at the tiny setup (16², width 8,
batch 8, f32).

Tolerances are those of tests/test_torch_train_step.py and
tests/test_torch_cgan_step.py: telemetry within 3e-3; Adam deltas where
the port's last gradient clears 1 % of its leaf's maximum, within 5 % of
lr per step taken. FusedProp reports ``d_gz2 == d_gz1`` exactly (one
shared forward). It composes with ``--remat``, and ``--fused_prop 1``
trains through the CLI for both families.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jckx.train.state import create_cgan_state, create_dcgan_state, geometry
from jckx.train.steps import make_cgan_train_step as jcstep
from jckx.train.steps import make_dcgan_train_step as jstep
from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.configs import get_arg_parse
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.models import cgan as tcgan
from jckx_torch.models import dcgan as tdcgan
from jckx_torch.train import main as tmain
from jckx_torch.train import state as tstate
from jckx_torch.train.steps import (METRIC_NAMES, make_cgan_train_step, make_dcgan_train_step,
                                    make_draws)
from test_torch_cgan_step import K
from test_torch_cgan_trainer import StubMetrics as CGANStubMetrics
from test_torch_cgan_step import _draws as _cgan_draws
from test_torch_train_step import LR, N, _assert_deltas, _cfgs, _port_sd
from test_torch_train_step import _draws as _dcgan_draws
from test_torch_trainer import StubMetrics
from torch_threads import one_torch_thread  # noqa: F401

DCGAN_CASES = {  # name: (config overrides, steps)
    "gp1-1step": (dict(gp_in_d_grad=True), 1),
    "gp0-1step": (dict(gp_in_d_grad=False), 1),
    "gp1-3steps": (dict(gp_in_d_grad=True), 3),
    "ema-3steps": (dict(ema_decay=0.9), 3),
    "remat-both-2steps": (dict(remat="both"), 2),
}
CGAN_CASES = {"1step": ({}, 1), "3steps": ({}, 3), "remat-d-2steps": (dict(remat="d"), 2)}


def _load(net, params, geo, which):
    net.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()}, geo, which))
    return net


def _run(jc, tc, st, nets, which, steps, batches, jit_step, port_step, draws_of):
    """Both steps side by side; → the port's state after ``steps``."""
    tgeo = tdcgan.GANGeometry(**vars(geometry(jc)))
    G, D = (_load(n, p, tgeo, w) for n, p, w in zip(nets, (st.params_g, st.params_d), which))
    ts = tstate.create_dcgan_state(tc, G, D)
    g0, d0 = _port_sd(st.params_g, tgeo, which[0]), _port_sd(st.params_d, tgeo, which[1])
    for i in range(steps):
        draws = draws_of(st, geometry(jc))
        st, jm = jit_step(st, *[jnp.asarray(b) for b in batches[i]])
        tm = port_step(ts, *[torch.from_numpy(b) for b in batches[i]], draws)
        assert set(tm) == set(METRIC_NAMES)
        assert torch.equal(tm["d_gz1"], tm["d_gz2"]), "one shared fake-side forward"
        for name in METRIC_NAMES:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=3e-3, atol=3e-3,
                                       err_msg=f"step {i}: {name}")
    assert ts.step == int(st.step) == steps
    g_grads = {k: p.grad.numpy() for k, p in G.named_parameters()}
    d_grads = {k: p.grad.numpy() for k, p in D.named_parameters()}
    _assert_deltas(g0, _port_sd(st.params_g, tgeo, which[0]), G, g_grads, LR, steps, "G")
    _assert_deltas(d0, _port_sd(st.params_d, tgeo, which[1]), D, d_grads, LR, steps, "D")
    if jc.ema_decay > 0:
        _assert_deltas(g0, _port_sd(st.ema_g, tgeo, which[0]), ts.ema_g, g_grads, LR, steps,
                       "EMA", scale=1 - jc.ema_decay)


@pytest.mark.parametrize("case", list(DCGAN_CASES))
def test_dcgan_fused_prop_step_matches_jckx(case):
    over, steps = DCGAN_CASES[case]
    jc, tc = _cfgs({"fused_prop": 1, **over})
    geo = geometry(jc)
    st = create_dcgan_state(jc, jax.random.PRNGKey(0))
    if jc.ema_decay > 0:
        st = st.replace(ema_g=jax.tree_util.tree_map(jnp.copy, st.params_g))
    batches = [(np.random.RandomState(10 + i).rand(N, 16, 16, 3).astype(np.float32) * 2 - 1,)
               for i in range(steps)]
    tgeo = tdcgan.GANGeometry(**vars(geo))
    _run(jc, tc, st, (tdcgan.Generator(tgeo), tdcgan.Discriminator(tgeo)), ("g", "d"), steps,
         batches, jax.jit(jstep(jc, geo)), make_dcgan_train_step(tc, tgeo), _dcgan_draws)


@pytest.mark.parametrize("case", list(CGAN_CASES))
def test_cgan_fused_prop_step_matches_jckx(case):
    over, steps = CGAN_CASES[case]
    jc, tc = _cfgs({"fused_prop": 1, "num_classes": K, **over})
    geo = geometry(jc)
    st = create_cgan_state(jc, jax.random.PRNGKey(1))
    rng = np.random.RandomState(11)
    batches = [(rng.rand(N, 16, 16, 3).astype(np.float32) * 2 - 1,
                np.eye(K, dtype=np.float32)[rng.randint(0, K, N)]) for _ in range(steps)]
    tgeo = tdcgan.GANGeometry(**vars(geo))
    _run(jc, tc, st, (tcgan.CGenerator(tgeo, K), tcgan.CDiscriminator(tgeo, K)), ("cg", "cd"),
         steps, batches, jax.jit(jcstep(jc, geo)), make_cgan_train_step(tc, tgeo), _cgan_draws)


def test_fused_prop_differs_from_the_faithful_step_only_by_its_semantics():
    """Same state, same draws: D's update is the same function in both
    modes (its fake side is one forward either way), G's is not (FusedProp
    takes it through the pre-update D), and the draws of one (seed, step)
    are the same in both modes."""
    _, tc = _cfgs({})
    _, tf = _cfgs({"fused_prop": 1})
    tgeo = tdcgan.GANGeometry(z_dim=16, image_size=16, channels=3, base_width=8)
    real = torch.from_numpy(np.random.RandomState(3).rand(N, 16, 16, 3).astype(np.float32) * 2 - 1)
    out = {}
    for name, cfg in (("faithful", tc), ("fused", tf)):
        gen = torch.Generator().manual_seed(5)
        ts = tstate.create_dcgan_state(cfg, tdcgan.Generator(tgeo, gen=gen),
                                       tdcgan.Discriminator(tgeo, gen=gen))
        m = make_dcgan_train_step(cfg, tgeo)(ts, real)
        out[name] = (m, ts)
    (mf, sf), (mp, sp) = out["faithful"], out["fused"]
    for name in ("loss_d", "gp", "d_x", "d_gz1"):
        torch.testing.assert_close(mp[name], mf[name], rtol=1e-5, atol=1e-6)
    for a, b in zip(sf.D.parameters(), sp.D.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert not torch.equal(mp["d_gz2"], mf["d_gz2"])
    assert torch.equal(mp["d_gz1"], mp["d_gz2"])
    a = make_draws(5, 0, N, tgeo, torch.device("cpu"), conditional=True)
    b = make_draws(5, 0, N, tgeo, torch.device("cpu"), conditional=True)
    assert torch.equal(a.keep_fake, b.keep_fake) and torch.equal(a.keep_g, b.keep_g)


@pytest.mark.parametrize("model,dataset", [("DCGAN", "synthetic"), ("CGAN", "cifar10")])
def test_cli_trains_with_fused_prop(tmp_path, model, dataset):
    argv = ["-m", model, "--fused_prop", "1", "--device", "cpu", "--dataset", dataset,
            "--synthetic_size", "32", "-b", "16", "-e", "1", "--image_size", "16",
            "--base_width", "8", "--compute_dtype", "float32", "-mlr", "2e-4",
            "--log_every", "2", "--eval_every", "2", "--save_root", str(tmp_path),
            "--data_dir", str(tmp_path / "data"), "-pm", "r", "--remat", "g"]
    cfg = get_arg_parse(argv)
    assert cfg.fused_prop == 1 and cfg.remat == "g"
    G0 = None
    try:
        tr = tmain.run(cfg, metrics=CGANStubMetrics() if model == "CGAN" else StubMetrics())
        G0 = tr.state.G
    finally:
        MainLogger.reset()
    assert tr.state.step == 2 and tr.evals == [2]
    assert os.path.exists(tmp_path / model.lower() / "r" / "latest.ckpt")
    assert all(torch.isfinite(p).all() for p in G0.parameters())

