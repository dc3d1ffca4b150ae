"""The port's fine-tune end to end on the CPU (``python -m jckx_torch
finetune``, ``jckx_torch/metrics/inception_train.py``), in the port alone:
the cases of ``tests/test_inception_train.py`` (the synthetic-size
protocol, a tiny run, resume equal to an uninterrupted run, the npz
holdout), ``--scan_steps``, ``--nan_guard``, the refusals, and the
``*_bset.npz`` files read by both packages' ``Metrics``.

Runs are tiny: 75² (InceptionV3's minimum, as jckx's tests), batch 8,
f32, a few steps; the JAX package is imported only to read and write its
side of the ``.npz`` files. ``--dataset folder`` is held in
tests/test_torch_data_planes.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jckx.metrics import inception_v3 as jiv
from jckx.metrics.inception_train import get_args as jckx_get_args
from jckx.metrics.inception_train import save_npz as jckx_save_npz
from jckx.metrics.metrics import Metrics as JMetrics
from jckx.metrics.metrics import flatten_params
from jckx_torch.__main__ import main as cli
from jckx_torch.data.datasets import load_dataset
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.metrics import inception_v3 as tiv
from jckx_torch.metrics.inception_train import get_args, train
from jckx_torch.metrics.metrics import Metrics as TMetrics
from torch_threads import one_torch_thread  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_port_logger():
    yield
    MainLogger.reset()


def _args(tmp_path, save, *extra):
    return get_args(["--device", "cpu", "--compute_dtype", "float32", "--image_size", "75",
                     "-mlr", "0.01", "--save_dir", str(save), "--save_path", str(tmp_path),
                     "--data_dir", str(tmp_path / "data"), *extra])


def test_synthetic_size_flag_reference_protocol():
    a = get_args(["--dataset", "synthetic", "--synthetic_size", "1000"])
    assert a.synthetic_size == 1000 and a.device is None and a.compute_dtype == "bfloat16"
    x, y, ncls, _, syn = load_dataset(a.dataset, a.data_dir, train=True, seed=a.seed,
                                      synthetic_n=a.synthetic_size)
    xt, _, _, _, _ = load_dataset(a.dataset, a.data_dir, train=False, seed=a.seed + 1,
                                  synthetic_n=a.synthetic_size // 5)
    assert syn and x.shape == (1000, 32, 32, 3) and xt.shape == (200, 32, 32, 3)
    assert ncls == 100 and y.dtype == np.int32


def test_parser_takes_every_jckx_flag(monkeypatch):
    import argparse

    def flags(get_args_fn):
        seen = set()

        def grab(self, *a, **k):
            seen.update(s for act in self._actions for s in act.option_strings)
            raise SystemExit(0)

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            get_args_fn([])
        monkeypatch.undo()
        return seen

    ours = flags(get_args)
    assert flags(jckx_get_args) <= ours and {"--device", "--compute_dtype"} <= ours


def test_train_end_to_end_tiny(tmp_path):
    save = tmp_path / "bk"
    run = train(_args(tmp_path, save, "--dataset", "synthetic", "--synthetic_size", "32",
                      "-b", "8", "-e", "2", "--eval_samples", "16", "--eval_train", "1"))
    assert 0.0 <= run.best_acc <= 1.0 and np.isfinite(run.best_loss) and run.best_loss < 1e9
    assert [e["steps"] for e in run.epochs] == [4, 4]
    assert all({"train_eval_top1", "train_eval_loss", "top5", "superclass"} <= set(e)
               for e in run.epochs)
    assert all(np.isfinite(e["train_loss"]) for e in run.epochs)
    for f in ("loss_bset.npz", "last_bset.npz", "summary.json", "train_state.npz"):
        assert (save / f).exists(), f
    assert not [f for f in os.listdir(save) if ".tmp" in f]
    if run.best_acc > 0:  # saved only on a strict top-1 improvement over 0 (jckx's rule)
        assert (save / "acc_bset.npz").exists()
    side = json.loads((save / "summary.json").read_text())
    assert side["epochs_run"] == 2 and side["synthetic_fallback"] is True
    assert side["batch_size"] == 8 and side["best_top1"] == run.best_acc
    assert set(side) == {"dataset", "synthetic_fallback", "epochs_run", "epoch_budget",
                         "batch_size", "best_top1", "best_loss", "wall_s"}
    with np.load(save / "last_bset.npz") as z:
        assert set(z.files) == set(flatten_params(jiv.init(0, num_classes=100)))
        assert z["fc/w"].shape == (2048, 100)


def test_resume_matches_uninterrupted(tmp_path):
    """2 epochs + ``--resume 1`` for a third ≡ 3 epochs straight, bit for
    bit: weights, running statistics, momentum buffers, the generator's
    state and the shuffle stream all carry over."""
    def run(save, epochs, resume=0):
        return train(_args(tmp_path, save, "--dataset", "synthetic", "--synthetic_size", "24",
                           "-b", "8", "-e", str(epochs), "--max_steps_per_epoch", "2",
                           "--eval_samples", "8", "--resume", str(resume)))

    a, b = tmp_path / "straight", tmp_path / "resumed"
    run(a, 3)
    run(b, 2)
    r = run(b, 3, resume=1)
    assert r.start_epoch == 2 and [e["epoch"] for e in r.epochs] == [2]
    za, zb = np.load(a / "last_bset.npz"), np.load(b / "last_bset.npz")
    assert set(za.files) == set(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    again = run(b, 3, resume=1)  # nothing left to train
    assert again.start_epoch == 3 and again.epochs == []


def test_scan_steps_changes_no_result(tmp_path):
    outs = []
    for k in ("0", "2"):
        save = tmp_path / f"scan{k}"
        train(_args(tmp_path, save, "--dataset", "synthetic", "--synthetic_size", "40",
                    "-b", "8", "-e", "1", "--max_steps_per_epoch", "3", "--eval_samples", "8",
                    "--scan_steps", k))
        MainLogger.reset()
        with np.load(save / "last_bset.npz") as z:
            outs.append({f: z[f] for f in z.files})
    for f in outs[0]:
        np.testing.assert_array_equal(outs[0][f], outs[1][f], err_msg=f)


def test_train_on_custom_npz_with_holdout(tmp_path):
    rng = np.random.RandomState(5)
    p = str(tmp_path / "custom.npz")
    with open(p, "wb") as f:
        np.savez(f, x=rng.randint(0, 256, (40, 32, 32, 3)).astype(np.uint8), y=rng.randint(0, 4, 40))
    save = tmp_path / "bk"
    run = train(_args(tmp_path, save, "--dataset", "npz", "--data_path", p, "-b", "8", "-e", "1",
                      "--eval_samples", "8"))
    assert np.isfinite(run.best_loss) and run.epochs[0]["steps"] == 4  # 36 of 40 train, 4 held out
    assert json.loads((save / "summary.json").read_text())["synthetic_fallback"] is False
    with np.load(save / "loss_bset.npz") as z:
        assert z["fc/w"].shape == (2048, 4)
    MainLogger.reset()
    run = train(_args(tmp_path, tmp_path / "bk2", "--dataset", "npz", "--data_path", p,
                      "--valid_data_path", p, "-b", "8", "-e", "1", "--eval_samples", "8"))
    assert run.epochs[0]["steps"] == 5  # an explicit valid split: all 40 rows train


def test_nan_guard_aborts_a_diverged_run(tmp_path):
    with pytest.raises(FloatingPointError, match="diverged"):
        train(_args(tmp_path, tmp_path / "bk", "--dataset", "synthetic", "--synthetic_size", "24",
                    "-b", "8", "-e", "1", "--eval_samples", "8", "-mlr", "1e30"))


def _jckx_metrics_params(path):
    """jckx's ``Metrics`` backbone loader on ``--metric_backbone path``."""
    m = JMetrics.__new__(JMetrics)
    from jckx.logging.main_logger import MainLogger as JLogger

    m._logger = JLogger(None)
    cfg = type("Cfg", (), {"metric_backbone": str(path), "save_root": ""})()
    return m._load_backbone(cfg)


def test_bset_npz_loads_in_both_packages_metrics(tmp_path):
    """The port's ``loss_bset.npz`` is a backbone for jckx's ``Metrics``
    (``_unflatten`` of its flat layout), and jckx's ``save_npz`` output is
    one for the port's ``Metrics``."""
    save = tmp_path / "bk"
    train(_args(tmp_path, save, "--dataset", "synthetic", "--synthetic_size", "16", "-b", "8",
                "-e", "1", "--eval_samples", "8"))
    with np.load(save / "loss_bset.npz") as z:
        ours = dict(z)
    loaded = flatten_params(_jckx_metrics_params(save / "loss_bset.npz"))
    ref = flatten_params(jiv.init(0, num_classes=100))
    assert set(loaded) == set(ref)
    for k, v in loaded.items():
        assert v.shape == ref[k].shape, k
        np.testing.assert_array_equal(np.asarray(v), ours[k], err_msg=k)

    jpath = tmp_path / "jckx" / "loss_bset.npz"
    jparams = jiv.init(3, num_classes=10)
    jckx_save_npz(str(jpath), jparams)
    m = TMetrics.__new__(TMetrics)
    m._logger, m.num_classes = MainLogger(None), 10
    net = m._load_backbone(type("Cfg", (), {"metric_backbone": str(jpath), "save_root": ""})())
    back = tiv.to_jckx_flat(net)
    for k, v in flatten_params(jparams).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_cli_finetune_and_its_refusals(tmp_path, capsys):
    save = tmp_path / "bk"
    assert cli(["finetune", "--device", "cpu", "--dataset", "synthetic", "--synthetic_size", "16",
                "-b", "8", "-e", "1", "--image_size", "75", "--compute_dtype", "float32",
                "--eval_samples", "8", "-mlr", "0.01", "--save_dir", str(save),
                "--data_dir", str(tmp_path / "data")]) == 0
    assert (save / "loss_bset.npz").exists()
    with pytest.raises(SystemExit, match="1-D"):
        cli(["finetune", "--mesh_shape", "4,2"])
    for argv in (["--mesh_shape", "8"], ["--mesh_shape", "8", "--multihost", "1"]):
        with pytest.raises(ValueError, match="needs 8 ranks, have 1.*torchrun --nproc_per_node 8"):
            cli(["finetune", "--device", "cpu", *argv])
    with pytest.raises(SystemExit) as e:
        cli(["finetune", "-h"])
    assert e.value.code == 0 and "--scan_steps" in capsys.readouterr().out
    if not torch.cuda.is_available():  # the card is the default: no quiet fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli(["finetune", "--dataset", "synthetic", "--save_dir", str(tmp_path / "x"),
                 "--data_dir", str(tmp_path / "data")])
    out = subprocess.run([sys.executable, "-m", "jckx_torch.metrics.inception_train", "-h"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--max_steps_per_epoch" in out.stdout


def _array_digest(path) -> str:
    """sha256 of an ``.npz``'s arrays: each name, dtype, shape and bytes, in
    name order (the zip's own bytes hold its write time)."""
    import hashlib

    h = hashlib.sha256()
    with np.load(path) as z:
        for k in sorted(z.files):
            a = np.ascontiguousarray(z[k])
            h.update(f"{k}|{a.dtype}|{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("route", ["eager", "graph"])
def test_train_writes_what_it_wrote_before_launch_was_factored_out(tmp_path, monkeypatch, route):
    """``train()`` as the epoch loop around ``prepare`` and ``launch``
    writes, bit for bit, what it wrote when its launch body was inline:
    the numbers below were pinned from that tree, with this run (two epochs
    of 3 steps, ``--scan_steps 2``: a launch that ends in its read and one
    that does not), one torch thread, eager and through ``EagerGraph``."""
    from jckx_torch.metrics import inception_train
    from jckx_torch.utils.graphs import EagerGraph

    if route == "graph":
        monkeypatch.setattr(inception_train, "graph_for", lambda *a, **k: (EagerGraph, ""))
    save = tmp_path / "bk"
    run = train(_args(tmp_path, save, "--dataset", "synthetic", "--synthetic_size", "40", "-b",
                      "8", "-e", "2", "--max_steps_per_epoch", "3", "--eval_samples", "8",
                      "--scan_steps", "2"))
    assert (run.superstep is not None) == (route == "graph")
    side = json.loads((save / "summary.json").read_text())
    del side["wall_s"]
    assert side == {"dataset": "synthetic", "synthetic_fallback": True, "epochs_run": 2,
                    "epoch_budget": 2, "batch_size": 8, "best_top1": 0.125,
                    "best_loss": 77631.453125}
    assert [e["train_loss"] for e in run.epochs] == [4.954097747802734, 4.392150402069092]
    assert _array_digest(save / "last_bset.npz") == (
        "4fa572dcd9db4efa734d5223159fb01971d3ac060f1b28d905a66960599e9778")
    assert _array_digest(save / "train_state.npz") == (
        "dbe0141d45d80314d65f1c70a27b335b3ca201c1a3be678962737934595de7ea")
