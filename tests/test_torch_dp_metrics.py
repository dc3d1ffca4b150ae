"""Data-parallel evaluation and fine-tune on two gloo ranks of CPU
processes (``jckx_torch/metrics/metrics.py``,
``jckx_torch/metrics/inception_train.py`` over a process mesh).

- ``evaluate``'s protocol over 2 ranks: G's renders of the eval inputs
  (each rank its rows, sync-BN, gathered in order) within 1e-5 of the
  single rank's; the metrics engine's features of a host set (the real
  side, each rank uploading its rows of every batch, the last batch
  padded) and of a device set (the fakes) within 1e-5 of the single
  rank's (the forward is per-sample; f32 convolutions of other batch
  sizes round apart). Rank 0 alone writes the real-feature cache.
- One fine-tune step at ``--image_size 75`` on 2 ranks against one, from
  the same seed, batch and draws: held at the level of update norms, as
  the SKILL's parity contract says of deep nets — each leaf's SGD delta
  within 10 % in norm of the single rank's (a ``dgamma`` / ``dbeta`` left
  at the global sums would double the BN leaves' deltas), and so the
  running statistics' moves (they are the global batch's; elementwise
  they part as the weights do, by the reassociation of the sums through
  94 BN layers), and rank 1 writes no file. One step: this seeded random
  backbone's gradients run to norms in the hundreds, so the second step's
  loss moves more under a 1e-7 relative perturbation of the initial
  weights than between the one-rank and the two-rank run; a second step
  compares noise, not the mesh.
"""

import os

import numpy as np
import pytest
import torch

from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.metrics import inception_train, inception_v3
from _torch_dp_child import eval_features, features_rank, finetune_rank, spawn
from torch_threads import one_torch_thread  # noqa: F401
from torch_tmp import drop_tmp_path  # noqa: F401


def test_eval_protocol_over_two_ranks_matches_one(tmp_path):
    rng = np.random.RandomState(0)
    data = {"geo": dict(z_dim=16, image_size=16, channels=3, base_width=8),
            "z": rng.randn(8, 16).astype(np.float32),
            "real": rng.randint(0, 256, (11, 16, 16, 3)).astype(np.uint8),  # 3 batches, padded
            "labels": rng.randint(0, 10, 11), "batch_size": 4}
    one = eval_features(data, str(tmp_path / "cache_single"))
    torch.save(data, tmp_path / "inputs.pt")
    spawn(features_rank, (2, str(tmp_path / "store"), str(tmp_path / "inputs.pt"), str(tmp_path)),
          timeout=180)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for r in ranks:
        torch.testing.assert_close(r["renders"], one["renders"], rtol=0, atol=1e-5)
        for side in ("real", "fake"):
            assert r[side].shape == one[side].shape
            np.testing.assert_allclose(r[side], one[side], rtol=0,
                                       atol=1e-5 * np.abs(one[side]).max())
    np.testing.assert_array_equal(ranks[0]["fake"], ranks[1]["fake"])
    assert len(ranks[0]["cache"]) == 1 and ranks[1]["cache"] == []


def test_finetune_over_two_ranks_matches_one_in_update_norms(tmp_path):
    argv = ["--device", "cpu", "--dataset", "synthetic", "--synthetic_size", "32", "-b", "8",
            "-e", "1", "--max_steps_per_epoch", "1", "--image_size", "75",
            "--compute_dtype", "float32", "-mlr", "0.01", "--eval_samples", "6",
            "--data_dir", str(tmp_path / "data")]
    MainLogger.reset()
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = inception_train.train(inception_train.get_args(
            argv + ["--save_dir", str(tmp_path / "single")]))
    finally:
        torch.set_num_threads(before)
        MainLogger.reset()
    one = {k: v.detach().clone() for k, v in run.net.state_dict().items()}
    spawn(finetune_rank, (2, str(tmp_path / "store"), argv + ["--mesh_shape", "2"],
                          str(tmp_path)), timeout=240)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for k in one:
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k
    init = inception_v3.init(12345, num_classes=one["fc.weight"].shape[0]).state_dict()
    dp = ranks[0]["params"]
    worst = 0.0
    for k, v in one.items():
        if k.endswith("num_batches_tracked"):
            continue
        d_one, d_dp = (v - init[k]).norm().item(), (dp[k] - init[k]).norm().item()
        assert d_one > 0, k
        gap = abs(d_dp - d_one) / d_one
        worst = max(worst, gap)
        assert gap <= 0.10, f"{k}: delta norm {d_dp} on 2 ranks against {d_one} on one"
    assert worst > 0  # the two runs sum in another order
    assert ranks[0]["epochs"][0]["train_loss"] == pytest.approx(run.epochs[0]["train_loss"],
                                                                rel=1e-5)
    assert sorted(os.listdir(tmp_path / "save0")) == sorted(os.listdir(tmp_path / "single"))
    assert not (tmp_path / "save1").exists()
