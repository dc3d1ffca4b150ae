"""The train step's ``--remat``, and the run's ``--sanitize`` and
``--profile_dir`` (jckx_torch/train/steps.py, jckx_torch/train/main.py), on
the CPU at the tiny setup (16², width 8, batch 8, f32).

- ``--remat g|d|both`` recomputes activations and changes nothing else:
  every updated leaf equals the ``none`` step's within 1e-6 relative, for
  both families and both step modes, with the penalty's double backward
  through the checkpointed D (the DCGAN cases take the penalty into D's
  gradient, so a D that is not twice differentiable fails them).
- ``--sanitize``: a clean step under anomaly detection equals the plain
  step bit for bit; a real batch holding a NaN raises anomaly mode's error,
  which names the backward function; the global flag is restored after.
- ``--profile_dir``: a tiny run writes a Chrome trace that names
  ``aten::convolution``.
"""

import glob
import json

import numpy as np
import pytest
import torch

from jckx_torch.configs import get_arg_parse
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.models import cgan as tcgan
from jckx_torch.models import dcgan as tdcgan
from jckx_torch.train import main as tmain
from jckx_torch.train import state as tstate
from jckx_torch.train.steps import make_cgan_train_step, make_dcgan_train_step
from test_torch_train_step import N, _cfgs
from test_torch_trainer import StubMetrics
from torch_threads import one_torch_thread  # noqa: F401

K = 10
GEO = tdcgan.GANGeometry(z_dim=16, image_size=16, channels=3, base_width=8)


def _steps(over, conditional, steps=2):
    """``steps`` port steps from one seeded state → (state, metrics)."""
    _, cfg = _cfgs({"num_classes": K, **over})
    gen = torch.Generator().manual_seed(2)
    if conditional:
        G, D = tcgan.CGenerator(GEO, K, gen=gen), tcgan.CDiscriminator(GEO, K, gen=gen)
        step = make_cgan_train_step(cfg, GEO)
    else:
        G, D = tdcgan.Generator(GEO, gen=gen), tdcgan.Discriminator(GEO, gen=gen)
        step = make_dcgan_train_step(cfg, GEO)
    ts = tstate.create_dcgan_state(cfg, G, D)
    rng = np.random.RandomState(4)
    ms = []
    for _ in range(steps):
        real = torch.from_numpy(rng.rand(N, 16, 16, 3).astype(np.float32) * 2 - 1)
        if conditional:
            onehot = torch.from_numpy(np.eye(K, dtype=np.float32)[rng.randint(0, K, N)])
            ms.append(step(ts, real, onehot))
        else:
            ms.append(step(ts, real))
    return ts, ms


def _leaves(ts):
    out = {f"G.{k}": v for k, v in ts.G.state_dict().items()}
    out.update({f"D.{k}": v for k, v in ts.D.state_dict().items()})
    for name, opt in (("opt_g", ts.opt_g), ("opt_d", ts.opt_d)):
        for i, s in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{m}": s[m] for m in ("exp_avg", "exp_avg_sq")})
    return out


@pytest.mark.parametrize("fused_prop", [0, 1])
@pytest.mark.parametrize("model", ["DCGAN", "CGAN"])
def test_remat_modes_equal_none(model, fused_prop):
    conditional = model == "CGAN"
    ref, ref_m = _steps({"fused_prop": fused_prop}, conditional)
    want = _leaves(ref)
    for mode in ("g", "d", "both"):
        ts, ms = _steps({"fused_prop": fused_prop, "remat": mode}, conditional)
        got = _leaves(ts)
        assert got.keys() == want.keys()
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=1e-6, atol=1e-6 * float(v.abs().max()),
                                       msg=f"remat={mode}: {k}")
        for a, b in zip(ms, ref_m):
            for name, v in b.items():
                torch.testing.assert_close(a[name], v, rtol=1e-6, atol=0)
        # the norms' running buffers are never written, even by the recompute
        for net in (ts.G, ts.D):
            for name, buf in net.named_buffers():
                assert torch.equal(buf, torch.ones_like(buf) if name.endswith("running_var")
                                   else torch.zeros_like(buf)), name
    with pytest.raises(ValueError, match="remat"):
        _steps({"remat": "all"}, conditional, steps=1)


def test_sanitize_clean_step_is_bit_identical_and_nan_raises():
    _, cfg = _cfgs({"sanitize": True})
    plain, _ = _steps({}, False)
    device = torch.device("cpu")
    with tmain.run_modes(cfg, device):
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        checked, _ = _steps({}, False)
    assert not torch.is_anomaly_enabled()
    a, b = _leaves(plain), _leaves(checked)
    assert all(torch.equal(a[k], b[k]) for k in a)

    gen = torch.Generator().manual_seed(2)
    ts = tstate.create_dcgan_state(cfg, tdcgan.Generator(GEO, gen=gen),
                                   tdcgan.Discriminator(GEO, gen=gen))
    real = torch.zeros(N, 16, 16, 3)
    real[0, 3, 4, 1] = float("nan")
    with tmain.run_modes(cfg, device):
        with pytest.warns(UserWarning, match="Traceback of forward call"):
            with pytest.raises(RuntimeError, match=r"Function '\w+Backward\d*' returned nan"):
                make_dcgan_train_step(cfg, GEO)(ts, real)
    assert not torch.is_anomaly_enabled()


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    argv = ["--device", "cpu", "--dataset", "synthetic", "--synthetic_size", "16", "-b", "8",
            "-e", "1", "--image_size", "16", "--base_width", "8", "--compute_dtype", "float32",
            "-mlr", "2e-4", "--log_every", "1", "--eval_every", "1", "--save_root",
            str(tmp_path), "--data_dir", str(tmp_path / "data"), "-pm", "r",
            "--profile_dir", str(tmp_path / "prof"), "--sanitize"]
    cfg = get_arg_parse(argv)
    try:
        tr = tmain.run(cfg, metrics=StubMetrics())
    finally:
        MainLogger.reset()
    assert tr.state.step == 2 and not torch.is_anomaly_enabled()
    (trace,) = glob.glob(str(tmp_path / "prof" / "jckx_torch_*.pt.trace.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names and "jckx_torch::normalize_act" in names
    # the program's own spans, on the trace's timeline
    assert {"jckx_torch.train.launch", "jckx_torch.train.telemetry_read"} <= names
    # a resume does not inherit the trace dir: it is the host's, not the run's
    resumed = get_arg_parse(["--resume", "-pm", "r", "--save_root", str(tmp_path)])
    assert resumed.profile_dir == "" and resumed.sanitize
