"""``python -m jckx_torch train --mesh_shape 2 --multihost`` under
``torchrun --standalone --nproc_per_node 2`` on the CPU (gloo), at the
tiny setup (16², width 8, global batch 8, f32, 32 synthetic rows: 4 steps
an epoch, an eval at each epoch's end over the seeded InceptionV3), against
the single-rank run of the same command.

- The final parameters match the single-rank run's: Adam deltas from the
  seeded init within 5 % of lr per step on all but 0.1 % of the elements
  whose gradient RMS (the single run's Adam second moment) clears 1 % of
  its leaf's maximum (tests/test_torch_dp_step.py's rule); the logged
  losses within 1e-4 relative (8 steps of reassociated sums).
- Each rank has a private save root and data dir ("{rank}" in the
  arguments, tests/_torch_dp_child.py): rank 1 writes no file, rank 0
  writes what the single run writes.
- The streaming plane under 2 ranks, cut after one epoch and continued
  with ``--resume``, ends bit-identical to the resident plane's
  uninterrupted run: the planes hand the step the same rows, and the
  draws follow (seed, step).
- CGAN once, in spawned ranks with a metrics engine that reads the eval
  renders' pixels (10 per class, split over the ranks): its final
  parameters and logged metrics match the single-rank run as above, and
  rank 1 writes no file.
"""

import glob
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from jckx_torch.configs import get_arg_parse
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.models.cgan import CDiscriminator, CGenerator
from jckx_torch.models.dcgan import Discriminator, Generator
from jckx_torch.train import main as tmain
from jckx_torch.train.state import geometry
from _torch_dp_child import RenderStub, spawn, train_rank
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_dp_child.py")
LR, STEPS = 2e-4, 8


def _argv(root, data, run, model="DCGAN", epochs=2, extra=()):
    return ["-m", model, "--device", "cpu", "--dataset",
            "cifar10" if model == "CGAN" else "synthetic", "--synthetic_size", "32", "-b", "8",
            "-e", str(epochs), "--image_size", "16", "--base_width", "8",
            "--compute_dtype", "float32", "-mlr", str(LR), "--log_every", "4",
            "--eval_every", "4", "--eval_batch_size", "10", "--sample_count", "10",
            "--save_root", str(root), "--data_dir", str(data), "-pm", run, *extra]


def _torchrun(argv, script=None, timeout=240):
    """Two ranks of ``python -m jckx_torch train <argv>`` (or of ``script``)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    target = [script, "train"] if script else ["-m", "jckx_torch", "train"]
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", *target, "--mesh_shape", "2", "--multihost",
                          *argv], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, f"torchrun exited {out.returncode}:\n{out.stdout}\n{out.stderr}"
    return out


def _single(argv):
    MainLogger.reset()  # an earlier test's logger would keep its run dir's files
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmain.main(argv)
    finally:
        torch.set_num_threads(before)
        MainLogger.reset()


def _ckpt(root, model, run):
    return torch.load(os.path.join(root, model.lower(), run, "latest.ckpt"), weights_only=True)


def _init(model, argv):
    cfg = get_arg_parse(argv)
    gen = torch.Generator().manual_seed(cfg.seed)
    geo = geometry(cfg)
    if model == "CGAN":
        return CGenerator(geo, 10, gen=gen), CDiscriminator(geo, 10, gen=gen)
    return Generator(geo, gen=gen), Discriminator(geo, gen=gen)


def _assert_matches_single(dp, one, nets):
    """Masked Adam deltas (see the module docstring) and the step count."""
    assert dp["step"] == one["step"] == STEPS
    for key, opt_key, net in (("model_g", "optimizer_g", nets[0]),
                              ("model_d", "optimizer_d", nets[1])):
        names = [k for k, _ in net.named_parameters()]
        init = net.state_dict()
        total = covered = 0
        for i, k in enumerate(names):
            rms = one[opt_key]["state"][i]["exp_avg_sq"].sqrt()
            mask = rms > 1e-2 * rms.max() + 1e-12
            bad = ((dp[key][k] - init[k]) - (one[key][k] - init[k])).abs() > 0.05 * LR * STEPS
            n_bad = int(bad[mask].sum())
            assert n_bad <= 1e-3 * int(mask.sum()), f"{key}.{k}: {n_bad} masked deltas differ"
            total += mask.numel()
            covered += int(mask.sum())
        assert covered / total > 0.5, f"{key}: the mask covers {covered}/{total}"


def _logged(root, model, run):
    with open(os.path.join(root, model.lower(), run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**"),
                                                              recursive=True)
                  if os.path.isfile(p))


@pytest.fixture(scope="module")
def dcgan(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_trainer")
    data = tmp / "data"
    _single(_argv(tmp / "single", data, "r"))
    _torchrun(_argv(tmp / "rank{rank}", tmp / "data{rank}", "r"), script=CHILD)
    # the streaming plane: one epoch, then --resume for the second
    shutil.copytree(data, tmp / "data_s")  # the real-feature cache: no extraction
    stream = _argv(tmp / "stream", tmp / "data_s", "s", epochs=1,
                   extra=("--data_placement", "stream", "-w", "2"))
    _torchrun(stream)
    _torchrun(_argv(tmp / "stream", tmp / "data_s", "s", extra=("--resume",)))
    return tmp


def test_two_ranks_match_the_single_rank_run(dcgan):
    argv = _argv(dcgan / "single", dcgan / "data", "r")
    _assert_matches_single(_ckpt(dcgan / "rank0", "DCGAN", "r"),
                           _ckpt(dcgan / "single", "DCGAN", "r"), _init("DCGAN", argv))
    dp, one = _logged(dcgan / "rank0", "DCGAN", "r"), _logged(dcgan / "single", "DCGAN", "r")
    keys = ("loss_d", "loss_g", "d_x", "gp", "fid")
    assert [sorted(r) for r in dp] == [sorted(r) for r in one]
    for a, b in zip(dp, one):
        for k in keys:
            if k in b:
                assert a[k] == pytest.approx(b[k], rel=1e-4), (k, a, b)


def test_only_rank_zero_writes(dcgan):
    assert _files(dcgan / "rank1") == [] and not (dcgan / "data1").exists()
    strip = lambda fs: sorted(f for f in fs if not f.endswith(".log"))  # noqa: E731
    assert strip(_files(dcgan / "rank0")) == strip(_files(dcgan / "single"))
    assert len(_files(dcgan / "data0")) == 1  # the real-feature cache, written by rank 0
    assert len([f for f in _files(dcgan / "rank0") if f.endswith(".log")]) == 1


def test_streamed_and_resumed_run_equals_the_resident_one(dcgan):
    a, b = _ckpt(dcgan / "stream", "DCGAN", "s"), _ckpt(dcgan / "rank0", "DCGAN", "r")
    assert a["step"] == b["step"] == STEPS
    for key in ("model_g", "model_d"):
        for k, v in b[key].items():
            assert torch.equal(a[key][k], v), f"{key}.{k}"
    cfg = json.load(open(dcgan / "stream" / "dcgan" / "s" / "config.json"))
    assert cfg["data_placement"] == "stream" and cfg["mesh_shape"] == "2"
    assert [r["step"] for r in _logged(dcgan / "stream", "DCGAN", "s") if "fid" in r] == [4, 8]


def test_cgan_over_two_ranks_matches_the_single_rank_run(tmp_path):
    """In-process ranks (``spawn``) with a metrics engine that reads the
    renders' pixels, so the logged metrics follow the mesh's eval renders
    (10 per class, in one chunk of 100 split over the ranks)."""
    argv = _argv(tmp_path / "single", tmp_path / "data", "c", model="CGAN")
    MainLogger.reset()
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmain.run(get_arg_parse(argv), metrics=RenderStub())
    finally:
        torch.set_num_threads(before)
        MainLogger.reset()
    spawn(train_rank, (2, str(tmp_path / "store"),
                       _argv(tmp_path / "dp{rank}", tmp_path / "data", "c", model="CGAN")
                       + ["--mesh_shape", "2", "--multihost"], str(tmp_path)), timeout=180)
    _assert_matches_single(_ckpt(tmp_path / "dp0", "CGAN", "c"),
                           _ckpt(tmp_path / "single", "CGAN", "c"), _init("CGAN", argv))
    assert _files(tmp_path / "dp1") == []
    dp, one = _logged(tmp_path / "dp0", "CGAN", "c"), _logged(tmp_path / "single", "CGAN", "c")
    evals = [(a, b) for a, b in zip(dp, one) if "intra_fid" in b]
    assert len(evals) == 2
    for a, b in evals:
        for k in ("fid", "intra_fid", "is"):
            assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-6), (k, a[k], b[k])
