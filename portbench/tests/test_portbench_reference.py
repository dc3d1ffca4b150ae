"""The plain reference against the program at a tiny size on the CPU: in
float32 the two agree to round-off, so the reference follows the
program's semantics (draws, order, decode, the step, the sampler)."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import gan
from conftest import run_tiny


def numbers(err):
    out = {}
    for line in err:
        name, _, rest = line.partition(": ")
        if name.startswith("check "):
            name = name[len("check "):]
        if name.endswith("_gap") or name.endswith("_lsb"):
            out[name] = float(rest.split()[0])
    return out


@pytest.mark.parametrize("cell", ["dcgan-64.train", "cgan-64.train"])
def test_the_reference_step_is_the_programs(tiny_root_f32, cell):
    line, err = run_tiny(tiny_root_f32, cell)
    got = numbers(err)
    assert line["correct"]
    assert got["fwd1_gap"] < 1e-5 and got["loss_gap"] < 1e-4
    assert got["grad_gap"] < 1e-4 and got["change_median_gap"] < 1e-4
    assert got["fwd_step_gap"] < 1e-5 and got["grad_step_gap"] < 1e-5
    assert got["grad_step_median_gap"] < 1e-5


def test_the_reference_sampler_is_the_programs(tiny_root_f32):
    line, err = run_tiny(tiny_root_f32, "cgan-64.serve-bulk")
    got = numbers(err)
    assert line["correct"] and got["worst_image_lsb"] < 0.05 and got["mean_lsb"] < 0.01


def test_weights_follow_the_init_laws():
    cfg = {"image_size": 64, "base_width": 64, "z_dim": 100, "channels": 3,
           "conditional": True, "num_classes": 100}
    p = weights.make(cfg, 3, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in p["g"].items()} == gan.param_shapes(cfg)["g"]
    conv = torch.cat([v.flatten() for k, v in p["g"].items() if k.startswith("conv")])
    scale = torch.cat([v for k, v in p["d"].items() if k.startswith("norm") and k.endswith("weight")])
    assert abs(conv.std().item() - 0.02) < 1e-3 and abs(conv.mean().item()) < 1e-4
    assert abs(scale.mean().item() - 1.0) < 5e-3
    assert all(not v.any() for k, v in p["d"].items() if k.startswith("norm") and k.endswith("bias"))
    w = p["d"]["linear1.weight"]
    assert w.abs().max().item() <= 1 / np.sqrt(w.shape[1])
    again = weights.make(cfg, 3, torch.device("cpu"))
    assert all(torch.equal(again["g"][k], v) for k, v in p["g"].items())
