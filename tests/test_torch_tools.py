"""The port's operations tools on the CPU: ``convert``, ``inspect``,
``doctor`` and the ``python -m jckx_torch`` front door.

- ``convert``: a reference ``.pt`` written by jckx → the port's checkpoint →
  ``.pt`` gives back equal tensors, as jckx's own ``.pt`` → ``.ckpt`` →
  ``.pt`` round trip does; the EMA flags; contradicting hints, two ``.pt``
  sides and a jckx msgpack ``.ckpt`` are refused by name.
- ``inspect``: each kind (the port's checkpoint, a reference ``.pt``, a
  ``.pt2``, a ``.jaxexp``) agrees with ``jckx.inspect`` where both read the
  same file, and nothing initializes CUDA (``torch.cuda._lazy_init``
  patched to raise).
- ``doctor`` on a host without a card: exit 1 with the backend's error, and
  a blocked probe is reported after its timeout instead of hanging.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jckx import convert as jconvert
from jckx import export as jexport
from jckx import inspect as jinspect
from jckx_torch import convert as tconvert
from jckx_torch import doctor as tdoctor
from jckx_torch import export as texport
from jckx_torch import inspect as tinspect
from jckx_torch.__main__ import main as cli
from test_torch_serve import _ckpt, _port_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _convert(src, dst, **kw):
    args = tconvert.get_args(["--src", src, "--dst", dst])
    for k, v in kw.items():
        setattr(args, k, v)
    return tconvert.convert(args)


def _jconvert(src, dst):
    return jconvert.convert(argparse.Namespace(
        src=src, dst=dst, lr=2e-4, use_ema=False, with_ema=False, conditional=None,
        num_classes=None, image_size=None, channels=None, base_width=None, z_dim=None))


def _tensors_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


@pytest.mark.parametrize("conditional", [False, True])
def test_convert_round_trip_equals_jckx(tmp_path, conditional):
    _, ref = _ckpt(tmp_path, conditional=conditional)
    info = _convert(ref, str(tmp_path / "run.ckpt"), with_ema=True)
    assert info["conditional"] == conditional and info["ema"] and info["image_size"] == 16
    ck = torch.load(tmp_path / "run.ckpt", weights_only=True)
    assert ck["step"] == info["step"] and ck["serve_config"]["ema"]
    _tensors_equal(ck["ema_g"], ck["model_g"])
    back = _convert(str(tmp_path / "run.ckpt"), str(tmp_path / "back.pt"), lr=1e-3)
    assert back["step"] == info["step"]
    ours = torch.load(tmp_path / "back.pt", weights_only=True)
    orig = torch.load(ref, weights_only=True)
    assert set(ours) == {"model_g", "model_d", "optimizer_g", "optimizer_d"}
    for key in ("model_g", "model_d"):
        _tensors_equal(ours[key], orig[key])
    assert {g["lr"] for g in ours["optimizer_g"]["param_groups"]} == {1e-3}
    _jconvert(ref, str(tmp_path / "j.ckpt"))
    _jconvert(str(tmp_path / "j.ckpt"), str(tmp_path / "j.pt"))
    theirs = torch.load(tmp_path / "j.pt", weights_only=False)
    for key in ("model_g", "model_d"):
        _tensors_equal(ours[key], theirs[key])


def test_convert_ema_and_refusals(tmp_path):
    latest = str(tmp_path / "latest.ckpt")
    g, e = _port_checkpoint(latest, step=7, seed=1)
    _convert(latest, str(tmp_path / "ema.pt"), use_ema=True)
    _tensors_equal(torch.load(tmp_path / "ema.pt", weights_only=True)["model_g"], e.state_dict())
    info = _convert(latest, str(tmp_path / "g.pt"))
    assert info["step"] == 7
    _tensors_equal(torch.load(tmp_path / "g.pt", weights_only=True)["model_g"], g.state_dict())
    # Adam state absent from the source is written fresh
    assert torch.load(tmp_path / "g.pt", weights_only=True)["optimizer_g"]["state"] == {}
    for kw, match in ((dict(image_size=32), "contradict"), (dict(conditional=True), "contradict")):
        with pytest.raises(ValueError, match=match):
            _convert(latest, str(tmp_path / "x.pt"), **kw)
    with pytest.raises(ValueError, match="one side must be .pt"):
        _convert(str(tmp_path / "g.pt"), str(tmp_path / "y.pt"))
    (tmp_path / "jckx.ckpt").write_bytes(b"\x82\xa5flax")  # truncated msgpack
    with pytest.raises(ValueError, match="jckx.ckpt is a malformed jckx checkpoint"):
        _convert(str(tmp_path / "jckx.ckpt"), str(tmp_path / "z.pt"))
    _port_checkpoint(latest, step=3, seed=2, ema=False)
    with pytest.raises(ValueError, match="no EMA"):
        _convert(latest, str(tmp_path / "ema2.pt"), use_ema=True)


@pytest.fixture
def no_cuda_init(monkeypatch):
    def refuse():
        raise AssertionError("inspect initialized CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)


def test_inspect_every_kind_without_cuda(tmp_path, no_cuda_init):
    _, ref = _ckpt(tmp_path, conditional=True)
    latest = str(tmp_path / "latest.ckpt")
    _port_checkpoint(latest, step=12, seed=1)
    jexport.export_generator(ref, ref + ".jaxexp", batch_size=4, compute_dtype=jnp.float32,
                             platforms=("cpu",))
    texport.export_generator(ref, ref + "2", batch_size=4, compute_dtype=torch.float32,
                             device="cpu")
    got = tinspect.inspect_path(ref)
    want = jinspect.inspect_path(ref)
    for k in ("kind", "step", "conditional", "num_classes", "geometry", "ema", "params_g",
              "params_d", "file_bytes"):
        assert got[k] == want[k], k
    port = tinspect.inspect_path(latest)
    assert port["kind"] == "jckx_torch checkpoint" and port["step"] == 12 and port["ema"]
    assert port["params_ema_g"] == port["params_g"] and port["sidecar_present"]
    for path, kind in ((ref + "2", "torch.export"), (ref + ".jaxexp", "StableHLO")):
        info = tinspect.inspect_path(path)
        assert kind in info["kind"] and info["file_bytes"] == os.path.getsize(path)
        assert info["batch_size"] == 4 and info["conditional"] and info["num_classes"] == 10
    assert {k: v for k, v in tinspect.inspect_path(ref + ".jaxexp").items() if k != "kind"} == {
        k: v for k, v in jinspect.inspect_path(ref + ".jaxexp").items() if k != "kind"}
    with pytest.raises(ValueError, match="sidecar"):
        os.remove(ref + "2.json")
        tinspect.inspect_path(ref + "2")


def test_doctor_without_a_card_reports_and_exits_1():
    out = subprocess.run([sys.executable, "-m", "jckx_torch", "doctor"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    report = json.loads(out.stdout)
    assert report["ok"] is False and "no CUDA device" in report["backend"]["error"]


def test_doctor_reports_a_blocked_probe_instead_of_hanging(monkeypatch):
    release = threading.Event()
    monkeypatch.setattr(tdoctor, "_backend", lambda: release.wait(60) and {})
    t0 = time.perf_counter()
    try:
        report = tdoctor.run_checks(probe_timeout_s=0.5)
        assert time.perf_counter() - t0 < 10 and tdoctor._hard_exit_needed()
        assert report["ok"] is False and "still blocked" in report["backend"]["error"]
    finally:
        release.set()
    probes = [t for t in threading.enumerate() if t.name == tdoctor._PROBE_THREAD_NAME]
    for t in probes:
        t.join(timeout=10)
    assert not tdoctor._hard_exit_needed()


def test_front_door_dispatches_every_command(tmp_path, capsys):
    _, ref = _ckpt(tmp_path)
    assert cli(["inspect", "--ckpt", ref]) == 0
    assert json.loads(capsys.readouterr().out)["kind"] == "reference torch checkpoint"
    assert cli(["convert", "--src", ref, "--dst", str(tmp_path / "r.ckpt")]) == 0
    assert json.loads(capsys.readouterr().out)["wrote"].endswith("r.ckpt")
    assert cli(["export", "--ckpt", str(tmp_path / "r.ckpt"), "--dst", str(tmp_path / "g.pt2"),
                "-b", "4", "--compute_dtype", "float32", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["inputs"] == ["seed:i32[]"]
    assert cli(["serve", "--ckpt", str(tmp_path / "g.pt2"), "-n", "6", "--device", "cpu",
                "-o", str(tmp_path / "g.png")]) == 0
    assert "wrote 6 samples" in capsys.readouterr().out
    assert cli(["doctor", "--probe_timeout", "5"]) == 1
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:  # plan is a command now
        cli(["plan", "-h"])
    assert e.value.code == 0 and "--peak_tflops" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:  # finetune is a command now
        cli(["finetune", "-h"])
    assert e.value.code == 0 and "--max_steps_per_epoch" in capsys.readouterr().out
    assert cli([]) == 0
    usage = capsys.readouterr().out
    assert all(c in usage for c in ("export", "convert", "inspect", "doctor", "panel", "finetune",
                                    "plan"))
    np.testing.assert_array_equal(  # the served artifact is the exported one
        texport.load_exported(str(tmp_path / "g.pt2"), device="cpu")(0).shape, (4, 16, 16, 3))
