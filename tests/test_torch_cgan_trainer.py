"""The port's CGAN trainer, ``evaluate`` and ``-t 1`` on the CPU, at the tiny
setup of tests/test_torch_trainer.py (16², width 8, batch 16, f32,
synthetic data, K = 10).

- The iterations evaluated and the launch boundaries equal those of
  jckx's ``CGANTrainer`` on the same config (both with stub metrics); the
  labelled panel and the ``fid/``, ``is/`` and ``intra_fid/`` checkpoints
  are written, their names carrying (IS, FID, intra-FID).
- Resume is exact, and a CGAN checkpoint the port writes is read by jckx's
  importer and served by the port with labels.
- Chunked eval sampling: under batch-stat BN the chunks of 500 are part of
  the function.
- ``evaluate`` and ``-t 1`` reproduce the FID, IS and intra-FID that the
  run logged at the checkpoint's step, through the real metrics engine
  (real-feature cache, superclass maps) over a small stand-in backbone:
  the seeded InceptionV3 at 299² is too slow for the CPU tests.
"""

import os

import numpy as np
import jax
import pytest
import torch
import torch.nn.functional as F

from jckx_torch.checkpoint.torch_convert import params_from_jax
from jckx_torch.configs import Config, get_arg_parse
from jckx_torch.data.pipeline import CGANDataPreprocessor
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.metrics import inception_v3
from jckx_torch.models.cgan import CDiscriminator, CGenerator
from jckx_torch.models.dcgan import GANGeometry
from jckx_torch.train import main as tmain
from jckx_torch.train.gan_trainer import CGANTrainer, fixed_eval_inputs, sample_eval_images
from jckx_torch.train.state import geometry
from test_torch_trainer import TINY, _assert_same, _final, _jsonl
from torch_threads import one_torch_thread  # noqa: F401

K = 10


@pytest.fixture(autouse=True)
def _fresh_logger():
    """Each run attaches its own log file to the process-wide logger."""
    MainLogger.reset()
    yield
    MainLogger.reset()


class StubMetrics:
    """The DCGAN stub of tests/test_torch_trainer.py with intra-FID."""

    def __init__(self):
        self.calls = 0

    def extract_features(self, images):
        assert images.shape == (10 * K, 16, 16, 3)
        return np.random.RandomState(0).randn(len(images), 8).astype(np.float32)

    def inception_score(self, images=None, splits=10, logits=None):
        self.calls += 1
        return 1.0 + 0.1 * self.calls

    def fid(self, images_tanh=None, intra_fid=False, label=0, features=None):
        return 100.0 / self.calls

    def intra_fid(self, images_tanh=None, features=None):
        return 50.0 / self.calls


def _cfg(root, name="run", **over):
    cfg = Config()
    for k, v in {**TINY, "model": "CGAN", "device": "cpu", "save_root": str(root),
                 "data_dir": str(root / "data"), "save_path": os.path.join(str(root), "cgan", name),
                 **over}.items():
        setattr(cfg, k, v)
    return cfg


def _trainer(cfg, seed=1):
    data = CGANDataPreprocessor(cfg)
    data.images_u8, data.labels_np = data.images_u8[:128], data.labels_np[:128]
    gen = torch.Generator().manual_seed(seed)
    geo = geometry(cfg)
    return CGANTrainer(cfg, CGenerator(geo, K, gen=gen), CDiscriminator(geo, K, gen=gen), data,
                       metrics=StubMetrics())


def test_cgan_eval_iterations_match_jckx(tmp_path):
    from jckx.configs import Config as JConfig
    from jckx.data.pipeline import CGANDataPreprocessor as JPre
    from jckx.enums import ModelEnum
    from jckx.logging.main_logger import MainLogger as JLogger
    from jckx.models import cgan as jcgan
    from jckx.models.dcgan import GANGeometry as JGeo
    from jckx.train.gan_trainer import CGANTrainer as JTrainer

    jc = JConfig()
    for k, v in {**TINY, "save_root": str(tmp_path), "data_dir": str(tmp_path / "data"),
                 "save_path": str(tmp_path / "jckx")}.items():
        setattr(jc, k, v)
    jc.model = ModelEnum.CGAN
    jdata = JPre(jc)
    jdata.images_u8, jdata.labels_np = jdata.images_u8[:128], jdata.labels_np[:128]
    geo = JGeo(z_dim=100, image_size=16, channels=3, base_width=8)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jtr = JTrainer(jc, jcgan.cgenerator_init(k1, geo, K), jcgan.cdiscriminator_init(k2, geo, K),
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
    assert set(got[1]) == set(ref[1])
    last = [r for r in got if "fid" in r][-1]
    assert set(last) == {"step", "fid", "is", "intra_fid"} and last["intra_fid"] == 50.0 / 4
    # the best-metric files carry (IS, FID, intra-FID), as jckx's
    for f in ("16_1.4000_25.0000_12.5000.pt", "16_fake_image.png"):
        for typ in ("fid", "is", "intra_fid"):
            assert os.path.exists(os.path.join(tr.save_path, typ, f)), (typ, f)
    assert sorted(os.listdir(os.path.join(tr.save_path, "img"))) == sorted(
        os.listdir(os.path.join(jc.save_path, "img")))
    saved = torch.load(os.path.join(tr.save_path, "latest.ckpt"), weights_only=True)
    assert saved["serve_config"]["conditional"] and saved["serve_config"]["num_classes"] == K
    assert saved["bests"]["intra_fid"] == 12.5


def test_cgan_resume_is_exact(tmp_path):
    straight = _trainer(_cfg(tmp_path, "straight"))
    straight.train()
    ref = _final(straight)
    MainLogger.reset()
    first = _trainer(_cfg(tmp_path, "cut", epoch=1))
    first.train()
    assert first.state.step == 8
    MainLogger.reset()
    resumed = _trainer(_cfg(tmp_path, "cut", resume=True), seed=99)  # weights come from the file
    assert resumed.state.step == 8
    resumed.train()
    _assert_same(_final(resumed), ref)


def test_cgan_checkpoint_reads_back_in_jckx_and_serves_labels(tmp_path):
    from jckx.checkpoint import import_torch_gan_checkpoint
    from jckx_torch.serve import GeneratorService

    tr = _trainer(_cfg(tmp_path, epoch=1))
    tr.train()
    sub = os.path.join(tr.save_path, "intra_fid")
    (path,) = [os.path.join(sub, f) for f in os.listdir(sub) if f.endswith(".pt")]
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state, info = import_torch_gan_checkpoint(path, lr=2e-4)
    assert info["conditional"] and info["num_classes"] == K and info["step"] == saved["step"]
    for which, key, params in (("cg", "model_g", state.params_g), ("cd", "model_d", state.params_d)):
        ours = params_from_jax({k: np.asarray(v) for k, v in params.items()}, tr.geo, which)
        for k, v in ours.items():
            assert torch.equal(v.float(), saved[key][k].float()), (key, k)
    svc = GeneratorService(path, batch_size=8, compute_dtype=torch.float32, device="cpu")
    assert svc.conditional and svc.num_classes == K
    assert svc.sample(4, labels=[2, 7], seed=0).shape == (4, 16, 16, 3)


def test_eval_sampling_is_chunked_by_500():
    geo = GANGeometry(z_dim=8, image_size=8, channels=3, base_width=4)
    G = CGenerator(geo, 100, gen=torch.Generator().manual_seed(0))
    z, onehot = fixed_eval_inputs(1, geo, True, 100, 64, torch.device("cpu"))
    assert z.shape == (1000, 8) and torch.equal(onehot.argmax(1), torch.arange(100).repeat_interleave(10))
    got = sample_eval_images(G, z, onehot, torch.float32)
    with torch.no_grad():
        halves = torch.cat([G(z[:500], onehot[:500]), G(z[500:], onehot[500:])])
        whole = G(z, onehot)
    assert torch.equal(got, halves) and not torch.allclose(got, whole, atol=1e-6)
    z2, none = fixed_eval_inputs(1, geo, False, 100, 64, torch.device("cpu"))
    assert z2.shape == (64, 8) and none is None and torch.equal(z2, z[:64])


class _StandInBackbone(torch.nn.Module):
    """InceptionV3's interface (NHWC 299² in, ``num_classes`` logits out)
    on a 4×4 average pool and a seeded Linear."""

    def __init__(self, seed, num_classes):
        super().__init__()
        self.fc = torch.nn.Linear(48, num_classes)
        with torch.no_grad():
            self.fc.weight.copy_(torch.randn(num_classes, 48,
                                             generator=torch.Generator().manual_seed(seed)))
            self.fc.bias.zero_()

    def forward(self, x, compute_dtype=torch.float32, fast_stem=False):
        self.fast_stem = fast_stem
        return self.fc(F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2).float(), 4).flatten(1))


@pytest.mark.parametrize("model", ["CGAN", "DCGAN"])
def test_evaluate_reproduces_the_logged_metrics(tmp_path, monkeypatch, model):
    from jckx_torch import evaluate as tevaluate

    monkeypatch.setattr(inception_v3, "init", lambda seed, num_classes=100:
                        _StandInBackbone(seed, num_classes))
    where = ["--device", "cpu", "--save_root", str(tmp_path), "--data_dir", str(tmp_path / "data")]
    argv = ["-m", model, "--dataset", "cifar10", "--synthetic_size", "48", "-b", "16", "-e", "1",
            "--image_size", "16", "--base_width", "8", "--compute_dtype", "float32", "-mlr", "2e-4",
            "--log_every", "2", "--eval_every", "2", "--eval_batch_size", "40", "--ema_decay",
            "0.5", "-pm", "r"] + where
    tr = tmain.main(argv)
    MainLogger.reset()
    assert tr.evals == [2, 3]
    logged = {r["step"]: r for r in _jsonl(tr.save_path) if "fid" in r}
    keys = ("fid", "is") + (("intra_fid",) if model == "CGAN" else ())
    assert all(np.isfinite(logged[3][k]) and logged[3][k] != logged[2][k] for k in keys)

    best = "intra_fid" if model == "CGAN" else "fid"
    (pt,) = [f for f in os.listdir(os.path.join(tr.save_path, best)) if f.endswith(".pt")]
    step = int(pt.split("_")[0])
    got = tevaluate.main(["--ckpt", os.path.join(tr.save_path, best, pt), "--dataset", "cifar10",
                          "--synthetic_size", "48", "--eval_batch_size", "40",
                          "--compute_dtype", "float32"] + where[:2] + where[4:])
    assert got["step"] == step and got["n"] == (10 * K if model == "CGAN" else 64)
    for k in keys:
        assert got[k] == pytest.approx(logged[step][k], rel=1e-6), k
    MainLogger.reset()

    # -t 1 scores latest.ckpt (step 3) with the run's stored config
    res = tmain.main(["-t", "1", "-pm", "r"] + where)
    assert res["step"] == 3 and set(res) == {"step", "n"} | set(keys)
    for k in keys:
        assert res[k] == pytest.approx(logged[3][k], rel=1e-6), k
    MainLogger.reset()

    # the EMA generator by default (the run kept one), G when asked
    latest = os.path.join(tr.save_path, "latest.ckpt")
    ema, g = tevaluate.load_generator(latest)[0], tevaluate.load_generator(latest, use_ema=0)[0]
    assert not torch.equal(ema.conv1.weight, g.conv1.weight)
    ckpt = torch.load(latest, weights_only=True)
    del ckpt["ema_g"]
    torch.save(ckpt, tmp_path / "no_ema.pt")
    with pytest.raises(ValueError, match="no EMA"):
        tevaluate.load_generator(str(tmp_path / "no_ema.pt"), use_ema=1)


def test_evaluate_refuses_what_it_cannot_read(tmp_path, monkeypatch):
    """A malformed jckx msgpack ``.ckpt`` is refused, naming the file (a
    well-formed one is read: tests/test_torch_jckx_ckpt.py); ``--kid``,
    ``--prdc`` and ``--eval_fast_stem`` (once refused) are accepted and add
    jckx's keys."""
    from jckx_torch import evaluate as tevaluate

    (tmp_path / "run.ckpt").write_bytes(b"\x82\xa5flax")  # truncated msgpack
    with pytest.raises(ValueError, match="run.ckpt is a malformed jckx checkpoint"):
        tevaluate.load_generator(str(tmp_path / "run.ckpt"))
    backbones = []

    def stand_in(seed, num_classes=100):
        backbones.append(_StandInBackbone(seed, num_classes))
        return backbones[-1]

    monkeypatch.setattr(inception_v3, "init", stand_in)
    geo = GANGeometry(z_dim=100, image_size=16, channels=3, base_width=8)
    gen = torch.Generator().manual_seed(0)
    g, d = CGenerator(geo, K, gen=gen), CDiscriminator(geo, K, gen=gen)
    torch.save({"model_g": g.state_dict(), "model_d": d.state_dict()}, tmp_path / "c.pt")
    base = ["--ckpt", str(tmp_path / "c.pt"), "--dataset", "cifar10", "--synthetic_size", "48",
            "--eval_batch_size", "40", "--compute_dtype", "float32", "--device", "cpu",
            "--save_root", str(tmp_path), "--data_dir", str(tmp_path / "data")]
    plain = tevaluate.main(base)
    got = tevaluate.main(base + ["--kid", "1", "--prdc", "1", "--eval_fast_stem", "1"])
    extra = {"kid", "kid_std", "precision", "recall", "density", "coverage"}
    assert set(got) == set(plain) | extra and all(np.isfinite(got[k]) for k in extra)
    assert backbones[-1].fast_stem is True and backbones[0].fast_stem is False
    # the s2d stem's real features live under their own cache key
    assert sum("-s2d" in f for f in os.listdir(tmp_path / "data")) == 1
