"""Each fault a cell can have, planted under a run that is otherwise the
benchmark's own (the harness's look for a chip skipped, on the CPU at a
tiny size, with the cells' own limits), comes out as not correct; the
same run unbroken comes out correct.

Training cells: a step that leaves the state unchanged; half of the batch
left out of the losses, the mean taken over the rest, in every step or in
the replayed steps alone (the first step sound). Serving cells: an
image altered where it is produced; half of the batch left out of the BN
statistics. One chip: no exchange between chips to leave out."""

import pytest
import torch
import torch.nn.functional as F

import jckx_torch.kernels.fused_bn_act as fba
import jckx_torch.serve as serve
import jckx_torch.train.gan_trainer as gan_trainer
import jckx_torch.train.steps as steps
from conftest import run_tiny

TRAIN = ["dcgan-64.train", "cgan-64.train"]
SERVE = ["cgan-64.serve-bulk"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_unbroken_runs_are_correct(tiny_root, cell):
    assert run_tiny(tiny_root, cell)[0]["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    line, _ = run_tiny(tiny_root, cell)
    assert not line["correct"]
    assert line["checks"]["change_median_gap"]["value"] > line["checks"]["change_median_gap"]["limit"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_of_the_losses(tiny_root, cell, monkeypatch):
    def half_mean(logits, target):
        logits = logits.float()[: logits.shape[0] // 2]
        return torch.mean(F.softplus(logits) - target * logits)

    monkeypatch.setattr(steps, "bce_from_logits", half_mean)
    assert not run_tiny(tiny_root, cell)[0]["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_in_the_replayed_steps_alone(tiny_root, cell, monkeypatch):
    """From the second step on, as the launches after the capture run:
    the first step's numbers stay sound, the step-by-step ones do not."""
    late = {"on": False}
    plain_bce, plain_launch = steps.bce_from_logits, gan_trainer._BaseGANTrainer._launch

    def half_mean(logits, target):
        if not late["on"]:
            return plain_bce(logits, target)
        logits = logits.float()[: logits.shape[0] // 2]
        return torch.mean(F.softplus(logits) - target * logits)

    def launch(self, batches):
        late["on"] = self.state.step >= 1
        return plain_launch(self, batches)

    monkeypatch.setattr(steps, "bce_from_logits", half_mean)
    monkeypatch.setattr(gan_trainer._BaseGANTrainer, "_launch", launch)
    line, err = run_tiny(tiny_root, cell)
    assert not line["correct"]
    over = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    assert over and over <= {"fwd_step_gap", "grad_step_gap"}


@pytest.mark.parametrize("cell", SERVE)
def test_an_image_altered_where_it_is_produced(tiny_root, cell, monkeypatch):
    plain = serve.tanh_to_u8

    def altered(imgs):
        out = plain(imgs)
        out[1] = 255 - out[1]
        return out

    monkeypatch.setattr(serve, "tanh_to_u8", altered)
    line, _ = run_tiny(tiny_root, cell, seconds=1.0)
    assert not line["correct"] and line["checks"]["worst_image_lsb"]["value"] > 10


@pytest.mark.parametrize("cell", SERVE)
def test_half_the_batch_left_out_of_the_statistics(tiny_root, cell, monkeypatch):
    plain = fba._stats

    def half(x2d, mesh=None, axis="data"):
        return plain(x2d[: x2d.shape[0] // 2], mesh, axis)

    monkeypatch.setattr(fba, "_stats", half)
    assert not run_tiny(tiny_root, cell, seconds=1.0)[0]["correct"]
