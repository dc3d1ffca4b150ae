"""jckx command lines run under the port (ROADMAP C1): each argv of
``evaluate``, ``export`` and ``doctor`` that jckx's parser takes is fed to
the port's too, and the port's command runs on the CPU with tiny weights.

- ``evaluate --use_ema`` is a bare flag in jckx (``jckx/evaluate.py:58``);
  the port's also takes ``0`` / ``1``. ``--conditional``,
  ``--num_classes`` and the geometry flags are held against the weights.
- ``export --platforms`` (``jckx/export.py:265``) must name the platform
  of ``--device``; ``tpu`` is skipped with a warning.
- ``doctor --link_only`` (``jckx/doctor.py:231``) stops after the backend
  and link checks.
"""

import json

import numpy as np
import pytest
import torch

from jckx import doctor as jdoctor
from jckx import evaluate as jevaluate
from jckx import export as jexport
from jckx.checkpoint.torch_convert import export_torch_gan_checkpoint
from jckx.models import dcgan as jdcgan
from jckx.train.state import make_template_state
from jckx_torch import convert as tconvert
from jckx_torch import doctor as tdoctor
from jckx_torch import evaluate as tevaluate
from jckx_torch import export as texport

GEO = jdcgan.GANGeometry(z_dim=16, image_size=16, channels=3, base_width=8)


def _ckpt(tmp_path, conditional=False):
    state = make_template_state(GEO, conditional=conditional, num_classes=10)
    path = str(tmp_path / ("cgan.pt" if conditional else "dcgan.pt"))
    export_torch_gan_checkpoint(state, conditional=conditional, geo=GEO, num_classes=10, path=path)
    return path


class _StubMetrics:
    def extract_features(self, images):
        assert torch.isfinite(images).all()
        return np.random.RandomState(0).randn(len(images), 8).astype(np.float32)

    def inception_score(self, logits=None):
        return 1.5

    def fid(self, features=None):
        return 12.0

    def intra_fid(self, features=None):
        return 20.0


def test_evaluate_takes_jckx_use_ema_and_overrides(tmp_path, monkeypatch):
    ref = _ckpt(tmp_path)
    with_ema = str(tmp_path / "run.ckpt")
    assert tconvert.main(["--src", ref, "--dst", with_ema, "--with_ema"]) == 0
    cgan = _ckpt(tmp_path, conditional=True)
    seen = []
    real = tevaluate.load_generator

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append((a[1], out.used_ema))
        return out

    monkeypatch.setattr(tevaluate, "load_generator", spy)
    geo = ["--image_size", "16", "--channels", "3", "--base_width", "8", "--z_dim", "16"]
    cases = [(["--ckpt", with_ema, "--use_ema"], (True, True)),
             (["--ckpt", with_ema], (None, True)),
             (["--ckpt", with_ema, "--use_ema", "0"], (False, False)),
             (["--ckpt", cgan, "--conditional", "--num_classes", "10", *geo], (None, False))]
    for argv, ema in cases:
        jevaluate.get_args([a for a in argv if a != "0"])  # jckx's parser takes it too
        args = tevaluate.get_args(argv + ["--device", "cpu", "--compute_dtype", "float32"])
        res = tevaluate.evaluate(args, metrics=_StubMetrics())
        assert seen[-1] == ema and res["is"] == 1.5 and res["fid"] == 12.0, argv
    assert res["n"] == 100 and res["intra_fid"] == 20.0
    for argv in (["--ckpt", cgan, "--num_classes", "5"], ["--ckpt", ref, "--conditional"],
                 ["--ckpt", ref, "--base_width", "64"]):
        jevaluate.get_args(argv)
        with pytest.raises(ValueError, match="contradict"):
            tevaluate.evaluate(tevaluate.get_args(argv + ["--device", "cpu"]),
                               metrics=_StubMetrics())


def test_export_takes_jckx_platforms(tmp_path, capsys):
    ref = _ckpt(tmp_path)
    dst = str(tmp_path / "g.pt2")
    argv = ["--ckpt", ref, "--dst", dst, "-b", "4", "--platforms", "cpu,tpu",
            "--compute_dtype", "float32"]
    assert jexport.get_args(argv).platforms == "cpu,tpu"
    assert texport.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out)["platforms"] == ["cpu"]
    assert "tpu" in out.err and "skipped" in out.err
    texport.check_platforms(None, "cpu")  # absent: the device's own platform
    texport.check_platforms("cuda,cpu", "cpu")
    for platforms, device in (("tpu", "cpu"), ("cpu,tpu", None), ("cuda", "cpu")):
        with pytest.raises(SystemExit, match="does not name"):
            texport.check_platforms(platforms, device)


def test_doctor_takes_jckx_link_only(monkeypatch, capsys):
    got = {}

    def jckx_checks(*a, link_only=False, **k):
        got["link_only"] = link_only
        return {"ok": True}

    monkeypatch.setattr(jdoctor, "run_checks", jckx_checks)
    assert jdoctor.main(["--link_only"]) == 0 and got["link_only"] is True
    capsys.readouterr()
    # here, without a card, the port's report stops at the backend's error
    assert tdoctor.main(["--link_only", "--probe_timeout", "5"]) == (
        0 if torch.cuda.is_available() else 1)
    report = json.loads(capsys.readouterr().out)
    assert "kernel" not in report and "datasets" not in report
    # with a card: backend and link, then stop, exit 0; the kernel is not built
    monkeypatch.setattr(tdoctor, "_backend", lambda: {"platform": "cuda", "device_count": 1})
    monkeypatch.setattr(tdoctor, "_link", lambda: {"cold_read_s": 0.5, "read_s": 0.01})
    monkeypatch.setattr(tdoctor, "_kernel", lambda: pytest.fail("--link_only built the kernel"))
    assert tdoctor.main(["--link_only"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["link"]["healthy"] and set(report) == {"ok", "backend", "link"}
