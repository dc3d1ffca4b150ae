"""The port's DCGAN trainer and entry point (jckx_torch/train/) on the CPU
at the tiny setup of tests/test_trainer.py (16², width 8, batch 16, f32,
synthetic data), with a stub metrics engine in place of InceptionV3.

- The iterations evaluated and the launch boundaries equal those of
  jckx's ``DCGANTrainer`` on the same config (both with stubs).
- Resume is exact: a run cut by SIGTERM mid-epoch, or stopped after an
  epoch, and resumed from ``latest.ckpt`` ends with the same parameters
  and Adam state, bit for bit, as one uninterrupted run.
- A checkpoint the port writes is read back by jckx's
  ``import_torch_gan_checkpoint`` and by the port's ``GeneratorService``,
  with equal parameters.
- The CLI's flags and refusals, nan_guard and the artifacts.
"""

import io
import json
import os

import numpy as np
import jax
import pytest
import torch
from PIL import Image

from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.configs import Config, check_ported, get_arg_parse
from jckx_torch.data.pipeline import DCGANDataPreprocessor
from jckx_torch.logging.artifacts import encode_png, loss_curve_image
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.models.dcgan import Discriminator, Generator
from jckx_torch.train import main as tmain
from jckx_torch.train.gan_trainer import DCGANTrainer
from jckx_torch.train.state import geometry
from torch_threads import one_torch_thread  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

TINY = dict(dataset="synthetic", batch_size=16, epoch=2, image_size=16, base_width=8,
            num_classes=10, compute_dtype="float32", max_learning_rate=2e-4,
            log_every=3, eval_every=5, log_file=1)


@pytest.fixture(autouse=True)
def _fresh_logger():
    """Each test's runs log into its own ``tmp_path``, which goes after it."""
    MainLogger.reset()
    yield
    MainLogger.reset()


class StubMetrics:
    """Deterministic stand-in for the InceptionV3 engine; ``on_eval`` runs
    at every eval (the tests use it to deliver SIGTERM)."""

    def __init__(self, on_eval=None):
        self.calls = 0
        self.on_eval = on_eval

    def extract_features(self, images):
        assert images.shape[1:] == (16, 16, 3)
        return np.random.RandomState(0).randn(len(images), 8).astype(np.float32)

    def inception_score(self, images=None, splits=10, logits=None):
        self.calls += 1
        if self.on_eval is not None:
            self.on_eval(self.calls)
        return 1.0 + 0.1 * self.calls

    def fid(self, images_tanh=None, features=None):
        return 100.0 / self.calls


def _cfg(root, name="run", **over):
    cfg = Config()
    for k, v in {**TINY, "device": "cpu", "save_root": str(root), "data_dir": str(root / "data"),
                 "save_path": os.path.join(str(root), "dcgan", name), **over}.items():
        setattr(cfg, k, v)
    return cfg


def _data(cfg, n=128):
    data = DCGANDataPreprocessor(cfg)
    data.images_u8, data.labels_np = data.images_u8[:n], data.labels_np[:n]
    return data


def _trainer(cfg, metrics=None, seed=1):
    gen = torch.Generator().manual_seed(seed)
    geo = geometry(cfg)
    tr = DCGANTrainer(cfg, Generator(geo, gen=gen), Discriminator(geo, gen=gen), _data(cfg),
                      metrics=metrics or StubMetrics())
    return tr


def _jsonl(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_eval_iterations_match_jckx(tmp_path):
    from jckx.configs import Config as JConfig
    from jckx.data.pipeline import DCGANDataPreprocessor as JPre
    from jckx.logging.main_logger import MainLogger as JLogger
    from jckx.models import dcgan as jdcgan
    from jckx.train.gan_trainer import DCGANTrainer as JTrainer

    # 8 steps/epoch, 2 epochs, K = min(3, 5, 8) = 3: launches end at 3, 6, 8, 11, 14, 16
    jc = JConfig()
    for k, v in {**TINY, "save_root": str(tmp_path), "data_dir": str(tmp_path / "data"),
                 "save_path": str(tmp_path / "jckx")}.items():
        setattr(jc, k, v)
    jdata = JPre(jc)
    jdata.images_u8, jdata.labels_np = jdata.images_u8[:128], jdata.labels_np[:128]
    geo = jdcgan.GANGeometry(z_dim=100, image_size=16, channels=3, base_width=8)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jtr = JTrainer(jc, jdcgan.generator_init(k1, geo), jdcgan.discriminator_init(k2, geo),
                   jdata, metrics=StubMetrics())
    jtr.train()
    JLogger.reset()
    ref = _jsonl(jc.save_path)

    tr = _trainer(_cfg(tmp_path))
    tr.train()
    got = _jsonl(tr.save_path)
    evals = lambda recs: [r["step"] for r in recs if "fid" in r]  # noqa: E731
    launches = lambda recs: [r["step"] for r in recs if "step_ms" in r]  # noqa: E731
    assert evals(got) == evals(ref) == tr.evals == [3, 6, 11, 16]
    assert launches(got) == launches(ref) == [3, 6, 8, 11, 14, 16]
    assert set(got[1]) == set(ref[1])  # the same scalar keys
    for f in ("real_image.png", "loss.png", "latest.ckpt", "fid/16_25.0000.pt",
              "fid/16_fake_image.png", "is/16_1.4000.pt"):
        assert os.path.exists(os.path.join(tr.save_path, f)), f


def _final(tr):
    s = tr.state
    return ({k: v.clone() for k, v in s.G.state_dict().items()},
            {k: v.clone() for k, v in s.D.state_dict().items()},
            s.opt_g.state_dict(), s.opt_d.state_dict(), s.step)


def _assert_same(a, b):
    for sa, sb in zip(a[:2], b[:2]):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for oa, ob in zip(a[2:4], b[2:4]):
        for i, st in oa["state"].items():
            for k, v in st.items():
                assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a[4] == b[4]


@pytest.mark.parametrize("cut", ["sigterm-mid-epoch", "after-epoch-1"])
def test_resume_is_exact(tmp_path, cut):
    straight = _trainer(_cfg(tmp_path, "straight"))
    straight.train()
    ref = _final(straight)
    MainLogger.reset()

    if cut == "sigterm-mid-epoch":
        import signal

        # SIGTERM during the first eval (step 3): the trainer saves
        # latest.ckpt at the next launch boundary (step 6) and returns
        first = _trainer(_cfg(tmp_path, "cut"), StubMetrics(
            lambda calls: calls == 1 and os.kill(os.getpid(), signal.SIGTERM)))
        first.train()
        assert first.preempted and first.state.step == 6
    else:
        first = _trainer(_cfg(tmp_path, "cut", epoch=1))
        first.train()
        assert first.state.step == 8
    MainLogger.reset()

    resumed = _trainer(_cfg(tmp_path, "cut", resume=True), seed=99)  # weights come from the file
    assert resumed.state.step == first.state.step
    resumed.train()
    _assert_same(_final(resumed), ref)
    assert len(resumed._resumed_losses) == 16


def test_checkpoint_reads_back_in_jckx_and_the_service(tmp_path):
    from jckx.checkpoint import import_torch_gan_checkpoint
    from jckx_torch.serve import GeneratorService

    tr = _trainer(_cfg(tmp_path, ema_decay=0.5, epoch=1))
    tr.train()
    (path,) = [os.path.join(tr.save_path, "fid", f) for f in os.listdir(os.path.join(tr.save_path, "fid"))
               if f.endswith(".pt")]
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert {"step", "seed", "ema_g", "bests", "serve_config", "iters"} <= set(saved)

    state, info = import_torch_gan_checkpoint(path, lr=2e-4)
    assert info["step"] == saved["step"] == 8 and not info["conditional"]
    for which, key, params in (("g", "model_g", state.params_g), ("d", "model_d", state.params_d)):
        ours = params_from_jax({k: np.asarray(v) for k, v in params.items()}, tr.geo, which)
        for k, v in ours.items():
            assert torch.equal(v.float(), saved[key][k].float()), (key, k)
    # the service serves the run's EMA generator by default, G when asked (jckx/serve.py:183-228)
    svc = GeneratorService(path, batch_size=8, compute_dtype=torch.float32, device="cpu")
    live = GeneratorService(path, batch_size=8, compute_dtype=torch.float32, device="cpu",
                            use_ema=False)
    assert svc.used_ema and not live.used_ema and svc.step == 8
    for k, v in svc.G.state_dict().items():
        assert torch.equal(v, saved["ema_g"][k]), k
        assert torch.equal(live.G.state_dict()[k], saved["model_g"][k]), k
    assert svc.sample(4, seed=0).shape == (4, 16, 16, 3)


def test_nan_guard_aborts_and_rolls_back(tmp_path):
    tr = _trainer(_cfg(tmp_path, epoch=1))
    with pytest.raises(FloatingPointError, match="non-finite"):
        real_step = tr.step_fn
        tr.step_fn = lambda st, real: {k: v * float("nan") for k, v in real_step(st, real).items()}
        tr.train()
    with pytest.raises(RuntimeError, match="no latest.ckpt"):
        tr.train()


def test_cli_flags_and_refusals(tmp_path):
    from jckx.configs import get_arg_parse as jparse

    ours, ref = get_arg_parse([]), jparse([])
    for name in ("test", "model_path", "log_file", "num_worker", "batch_size", "epoch",
                 "max_learning_rate", "min_learning_rate", "weight_decay", "nesterov",
                 "lambda_gp", "adam_beta1", "adam_beta2", "label_real", "label_fake",
                 "instance_noise", "eval_every", "log_every", "gp_in_d_grad", "base_width",
                 "z_dim", "image_size", "dataset", "seed", "compute_dtype", "ema_decay",
                 "sample_count", "eval_batch_size", "nan_guard", "preempt_save", "lr_schedule"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.max_learning_rate == 0.1 and ours.device == "cuda" and ours.model == "DCGAN"
    a = get_arg_parse(["-b", "32", "-e200", "-mlr", "2e-4", "--gp_in_d_grad", "0",
                       "--dataset", "mnist", "--device", "cpu"])
    assert (a.batch_size, a.epoch, a.max_learning_rate, a.gp_in_d_grad) == (32, 200, 2e-4, False)
    assert (a.channels, a.num_classes, a.device) == (1, 10, "cpu")

    base = ["--device", "cpu", "--save_root", str(tmp_path)]
    # the train step's modes and the data planes are ported
    # (tests/test_torch_fused_prop.py, tests/test_torch_remat.py and
    # tests/test_torch_stream_trainer.py train with them), and so are the
    # mesh's data axis (tests/test_torch_dp_trainer.py) and its model axis
    # (tests/test_torch_model_axis_trainer.py); knobs out of their range
    # are refused by name, and a mesh larger than the world raises naming
    # torchrun, as jckx's does
    modes = ["--fused_prop", "1", "--remat", "both", "--sanitize", "--profile_dir", "p"]
    planes = ["--data_placement", "stream", "--hbm_data_budget", "1", "-w", "3"]
    mesh = ["--mesh_shape", "2,1", "--mesh_axes", "data,model", "--multihost"]
    cfg = get_arg_parse(["-m", "CGAN"] + modes + planes + mesh)
    assert (cfg.fused_prop, cfg.remat, cfg.sanitize, cfg.profile_dir) == (1, "both", True, "p")
    assert (cfg.data_placement, cfg.hbm_data_budget, cfg.num_worker) == ("stream", 1, 3)
    assert (cfg.mesh_shape, cfg.mesh_axes, cfg.multihost) == ("2,1", "data,model", True)
    check_ported(cfg)
    model_axis = ["--mesh_shape", "1,2", "--mesh_axes", "data,model"]
    check_ported(get_arg_parse(["-m", "CGAN"] + model_axis + modes + [
        "--model_axis_mode", "spatial", "--tp_min_dim", "64", "--spatial_replicate_grads", "0"]))
    for argv, item in ((["-m", "CGAN", "--mesh_shape", "2,2"] + modes, "mesh_axes"),
                       (["-t", "1"], "-pm"), (["-t", "1", "-pm", "nope"], "no latest.ckpt"),
                       (["--fused_prop", "1", "--model_axis_mode", "spatial", "--tp_min_dim", "0"],
                        "tp_min_dim"),
                       (model_axis + planes + ["--tp_min_dim", "-1"], "tp_min_dim"),
                       (["--remat", "g", "--hbm_data_budget", "1", "--spatial_replicate_grads",
                         "2"], "spatial_replicate_grads"),
                       (["--mesh_shape", "1,2,1", "--mesh_axes", "data,model,data"], "at most once")):
        with pytest.raises(SystemExit, match=item) as err:
            tmain.main(argv + base)
        assert not [f for f in ("fused_prop", "remat", "data_placement", "hbm_data_budget")
                    if f in str(err.value)]
    for argv in (["--mesh_shape", "2"], ["--mesh_shape", "2"] + planes + modes, model_axis,
                 ["-m", "CGAN"] + model_axis + modes + ["--model_axis_mode", "spatial"]):
        with pytest.raises(ValueError, match="needs 2 ranks, have 1.*torchrun --nproc_per_node 2"):
            tmain.main(argv + base)
    assert os.listdir(tmp_path) == []  # refused before any run dir

    from jckx_torch.__main__ import main as cli

    assert cli(["nope"]) == 2 and cli([]) == 0
    with pytest.raises(SystemExit) as e:  # plan answers (its flags, then the config's)
        cli(["plan", "-h"])
    assert e.value.code == 0
    assert cli(["finetune", "--device", "cpu", "--dataset", "synthetic", "--synthetic_size", "16",
                "-b", "8", "-e", "1", "--image_size", "75", "--compute_dtype", "float32",
                "--eval_samples", "8", "--save_dir", str(tmp_path / "bk"),
                "--data_dir", str(tmp_path / "data")]) == 0
    MainLogger.reset()
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        cli(["train", "-m", "CGAN", "--fused_prop", "1", "--data_placement", "stream",
             "--multihost"] + model_axis + base)
    with pytest.raises(SystemExit, match="1-D"):
        cli(["serve", "--ckpt", "x.pt", "--mesh_shape", "4,2"])
    with pytest.raises(SystemExit, match="jckx.serve"):
        cli(["serve", "--ckpt", "x.jaxexp"])


def test_cli_trains_and_resume_inherits_its_config(tmp_path):
    argv = ["--device", "cpu", "--dataset", "synthetic", "--synthetic_size", "48", "-b", "16",
            "-e", "1", "--image_size", "16", "--base_width", "8", "--compute_dtype", "float32",
            "-mlr", "2e-4", "--log_every", "2", "--eval_every", "2", "--save_root", str(tmp_path),
            "--data_dir", str(tmp_path / "data"), "-pm", "r"]
    tr = tmain.run(get_arg_parse(argv), metrics=StubMetrics())
    assert tr.evals == [2, 3] and tr.state.step == 3
    with open(tmp_path / "dcgan" / "r" / "config.json") as f:
        assert json.load(f)["max_learning_rate"] == 2e-4
    MainLogger.reset()
    cfg = get_arg_parse(["--resume", "-pm", "r", "--device", "cpu", "--save_root", str(tmp_path)])
    assert cfg.inherited_from and cfg.max_learning_rate == 2e-4 and cfg.image_size == 16
    tr2 = tmain.run(cfg, metrics=StubMetrics())
    assert tr2.state.step == 3 and tr2.evals == []


def test_loss_curve_raster():
    img = loss_curve_image([2.0, 1.5, float("nan"), 1.0, 0.8], [0.5, 0.7, 0.9, 1.1, 1.2])
    assert img.shape == (600, 800, 3) and img.dtype == np.uint8
    colors = {tuple(c) for c in img.reshape(-1, 3)}
    assert {(31, 119, 180), (255, 127, 14), (0, 0, 0), (255, 255, 255)} <= colors
    dec = np.asarray(Image.open(io.BytesIO(encode_png(img))))
    np.testing.assert_array_equal(dec, img)
    assert loss_curve_image([], []).shape == (600, 800, 3)
