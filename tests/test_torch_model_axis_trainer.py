"""``python -m jckx_torch train`` with a model axis (``--mesh_shape D,M
--mesh_axes data,model --model_axis_mode tp|spatial``), each rank a gloo
child of the test (tests/_torch_model_axis_child.py, ``train.main.run``
with a metrics engine that reads the eval renders' pixels), at the tiny
setup (16², base width 16, ``--tp_min_dim 16``, global batch 8, f32, 32
synthetic rows: 4 steps an epoch, an eval every 4 steps, EMA 0.9), against
the single-process run of the same command.

- A TP run's ``latest.ckpt`` holds full tensors: the single run's keys and
  shapes (model, EMA and Adam state), and its values within the masked
  Adam-delta rule of tests/test_torch_dp_trainer.py (5 % of lr per step on
  all but 0.1 % of the elements whose gradient RMS clears 1 % of its
  leaf's maximum), the logged losses within 1e-4 relative; so does a
  spatial run's (on the streaming plane), a CGAN TP run's on a (2, 2)
  mesh and a CGAN spatial run's with ``--spatial_replicate_grads 0``.
- ``--spatial_replicate_grads 0`` (Adam on each rank's slice of the flat
  parameters) ends where ``1`` ends, within 1e-6 of every leaf's largest
  magnitude: the same update with its gradient summed in another order.
- A TP run cut after one epoch and continued with ``--resume`` under the
  spatial layout, and another continued in one process, end where the
  uninterrupted single run ends (the same rule); the TP checkpoint loads
  in ``serve`` and ``evaluate``, and ``convert`` writes a reference ``.pt``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from jckx_torch.configs import get_arg_parse
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.models.cgan import CDiscriminator, CGenerator
from jckx_torch.models.dcgan import Discriminator, Generator
from jckx_torch.train import main as tmain
from jckx_torch.train.state import geometry
from _torch_dp_child import RenderStub, spawn
from _torch_model_axis_child import train_rank
from torch_threads import one_torch_thread  # noqa: F401

LR, STEPS = 2e-4, 8
TP = ["--mesh_axes", "data,model", "--model_axis_mode", "tp", "--multihost"]
SPATIAL = ["--mesh_axes", "data,model", "--model_axis_mode", "spatial", "--multihost"]


def _argv(root, run, model="DCGAN", epochs=2, extra=()):
    return ["-m", model, "--device", "cpu", "--dataset",
            "cifar10" if model == "CGAN" else "synthetic", "--synthetic_size", "32", "-b", "8",
            "-e", str(epochs), "--image_size", "16", "--base_width", "16", "--tp_min_dim", "16",
            "--compute_dtype", "float32", "-mlr", str(LR), "--log_every", "4",
            "--eval_every", "4", "--eval_batch_size", "10", "--sample_count", "10",
            "--ema_decay", "0.9", "--save_root", str(root), "--data_dir", str(root / "data"),
            "-pm", run, *extra]


def _single(argv):
    MainLogger.reset()
    try:
        return tmain.run(get_arg_parse(argv), metrics=RenderStub())
    finally:
        MainLogger.reset()


def _mesh_run(tmp, shape, argv, name):
    out = tmp / f"ranks_{name}"
    out.mkdir()
    spawn(train_rank, (shape, str(out / "store"), argv + ["--mesh_shape", f"{shape[0]},{shape[1]}"],
                       str(out)), world=shape[0] * shape[1], timeout=180)


def _ckpt(root, model, run):
    return torch.load(os.path.join(root, model.lower(), run, "latest.ckpt"), weights_only=True)


def _init(model, argv):
    cfg = get_arg_parse(argv)
    gen = torch.Generator().manual_seed(cfg.seed)
    geo = geometry(cfg)
    if model == "CGAN":
        return CGenerator(geo, 10, gen=gen), CDiscriminator(geo, 10, gen=gen)
    return Generator(geo, gen=gen), Discriminator(geo, gen=gen)


def _assert_same_layout(got, want):
    for key in ("model_g", "model_d", "ema_g"):
        assert {k: v.shape for k, v in got[key].items()} == \
            {k: v.shape for k, v in want[key].items()}, key
    for key in ("optimizer_g", "optimizer_d"):
        for i, st in want[key]["state"].items():
            assert {k: getattr(v, "shape", None) for k, v in got[key]["state"][i].items()} == \
                {k: getattr(v, "shape", None) for k, v in st.items()}, (key, i)


def _assert_matches(got, want, nets):
    """Masked Adam deltas (see the module docstring) and the step count."""
    assert got["step"] == want["step"] == STEPS
    for key, opt_key, net in (("model_g", "optimizer_g", nets[0]),
                              ("model_d", "optimizer_d", nets[1])):
        names = [k for k, _ in net.named_parameters()]
        init = net.state_dict()
        total = covered = 0
        for i, k in enumerate(names):
            rms = want[opt_key]["state"][i]["exp_avg_sq"].sqrt()
            mask = rms > 1e-2 * rms.max() + 1e-12
            bad = ((got[key][k] - init[k]) - (want[key][k] - init[k])).abs() > 0.05 * LR * STEPS
            n_bad = int(bad[mask].sum())
            assert n_bad <= 1e-3 * int(mask.sum()), f"{key}.{k}: {n_bad} masked deltas differ"
            total += mask.numel()
            covered += int(mask.sum())
        assert covered / total > 0.5, f"{key}: the mask covers {covered}/{total}"
    np.testing.assert_allclose(np.array(got["losses"]), np.array(want["losses"]), rtol=1e-4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis_trainer")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _single(_argv(tmp / "one", "r"))
        _single(_argv(tmp / "one", "c", model="CGAN"))
        _mesh_run(tmp, (1, 2), _argv(tmp / "tp", "r", extra=TP), "tp")
        _mesh_run(tmp, (1, 2), _argv(tmp / "sp", "r", extra=SPATIAL + [
            "--data_placement", "stream", "-w", "2"]), "sp")
        _mesh_run(tmp, (1, 2), _argv(tmp / "sp0", "r", extra=SPATIAL + [
            "--spatial_replicate_grads", "0"]), "sp0")
        _mesh_run(tmp, (2, 2), _argv(tmp / "ctp", "c", model="CGAN", extra=TP), "ctp")
        _mesh_run(tmp, (1, 2), _argv(tmp / "csp", "c", model="CGAN", extra=SPATIAL + [
            "--spatial_replicate_grads", "0"]), "csp")
        # one epoch under TP, then the second under spatial / in one process
        _mesh_run(tmp, (1, 2), _argv(tmp / "cut", "r", epochs=1, extra=TP), "cut")
        shutil.copytree(tmp / "cut", tmp / "cut1")
        _mesh_run(tmp, (1, 2), _argv(tmp / "cut", "r", extra=SPATIAL + ["--resume"]), "resume")
        _single(_argv(tmp / "cut1", "r", extra=["--resume", "--mesh_shape", "",
                                                 "--mesh_axes", "data"]))
    finally:
        torch.set_num_threads(before)
    return tmp


def test_tp_checkpoint_is_full_and_matches_the_single_run(runs):
    one, tp = _ckpt(runs / "one", "DCGAN", "r"), _ckpt(runs / "tp", "DCGAN", "r")
    _assert_same_layout(tp, one)
    _assert_matches(tp, one, _init("DCGAN", _argv(runs, "r")))


def test_spatial_run_matches_the_single_run(runs):
    one, sp = _ckpt(runs / "one", "DCGAN", "r"), _ckpt(runs / "sp", "DCGAN", "r")
    _assert_same_layout(sp, one)
    _assert_matches(sp, one, _init("DCGAN", _argv(runs, "r")))


@pytest.mark.parametrize("run", ["ctp", "csp"])
def test_cgan_on_the_model_axis_matches_the_single_run(runs, run):
    one, got = _ckpt(runs / "one", "CGAN", "c"), _ckpt(runs / run, "CGAN", "c")
    _assert_same_layout(got, one)
    _assert_matches(got, one, _init("CGAN", _argv(runs, "c", model="CGAN")))


def test_spatial_replicate_grads_0_equals_1(runs):
    on, off = _ckpt(runs / "sp", "DCGAN", "r"), _ckpt(runs / "sp0", "DCGAN", "r")
    _assert_same_layout(off, on)
    for key in ("model_g", "model_d", "ema_g"):
        for k, v in on[key].items():
            if v.is_floating_point():
                tol = 1e-6 * float(v.abs().max()) + 1e-12
                assert float((off[key][k] - v).abs().max()) <= tol, f"{key}.{k}"
    for key in ("optimizer_g", "optimizer_d"):
        for i, st in on[key]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                tol = 1e-6 * float(st[k].abs().max()) + 1e-12
                assert float((off[key]["state"][i][k] - st[k]).abs().max()) <= tol, (key, i, k)
            assert float(off[key]["state"][i]["step"]) == float(st["step"]) == STEPS


@pytest.mark.parametrize("run", ["cut", "cut1"])
def test_resume_under_another_layout_continues_the_run(runs, run):
    one, got = _ckpt(runs / "one", "DCGAN", "r"), _ckpt(runs / run, "DCGAN", "r")
    _assert_same_layout(got, one)
    _assert_matches(got, one, _init("DCGAN", _argv(runs, "r")))


def test_tp_checkpoint_loads_in_serve_evaluate_and_convert(runs, tmp_path):
    from jckx_torch import convert
    from jckx_torch.evaluate import evaluate, get_args
    from jckx_torch.serve import GeneratorService

    path = str(runs / "tp" / "dcgan" / "r" / "latest.ckpt")
    svc = GeneratorService(path, batch_size=8, compute_dtype=torch.float32, device="cpu")
    images = svc.sample(8)
    assert tuple(images.shape) == (8, 16, 16, 3) and svc.step == STEPS
    result = evaluate(get_args(["--ckpt", path, "--dataset", "synthetic", "--synthetic_size", "32",
                                "--eval_batch_size", "10", "--sample_count", "10",
                                "--compute_dtype", "float32", "--device", "cpu",
                                "--save_root", str(tmp_path), "--data_dir", str(tmp_path / "d")]),
                      metrics=RenderStub())
    logged = [json.loads(line) for line in open(runs / "tp" / "dcgan" / "r" / "metrics.jsonl")]
    assert result["step"] == STEPS and result["fid"] == [m for m in logged if "fid" in m][-1]["fid"]
    convert.main(["--src", path, "--dst", str(tmp_path / "r.pt")])
    ref = torch.load(tmp_path / "r.pt", weights_only=True)
    assert ref["model_g"]["conv1.weight"].shape == (100, 32, 4, 4)  # full, not a slice
