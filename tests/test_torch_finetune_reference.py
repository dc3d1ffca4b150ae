"""The port's fine-tune (``jckx_torch/metrics/inception_train.py``) against
the benchmark's plain reference (``portbench/reference/inception.py``) on
the CPU, at the configuration's ``tiny`` size (75², 10 classes, batch 4,
float32): the reference's parameters are the program's at the published
size, the train-mode forward, one step's gradients and running statistics,
and three steps through ``prepare`` / ``launch`` (the superstep's route,
``EagerGraph`` in place of a CUDA graph) as the benchmark judges them; and
the judge reads a missing dropout mask and the float8 control above the
limits the program passes, its own and the cell's CPU cut's (``tiny``).

Tolerances, and why they are not tighter. Through 94 layers of
batch-statistic BN at batch 4 the step amplifies float32 rounding (the
program's one-pass variance, E[x²] − E[x]², against the reference's
``F.batch_norm``; sums in another order): at this size the float32
reference is itself 19–25 % from a float64 run in its leaves' gradients
(measured on the CPU), and the program sits within 8.4 % of it. So:
- the network's input (crop, flip, normalization) within 1e-5 absolute;
- logits within 5e-3 of their largest magnitude (measured 1.5e-3), the
  loss within 1e-4 relative (measured 2.4e-5);
- running statistics within 5e-3 of their layer's largest (measured
  8.7e-4);
- each leaf's gradient within 0.25 of max(its norm, the median leaf's)
  (measured 0.084; the missing dropout mask reads 1.05, the float8
  control 2.1).
"""

import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jckx_torch.metrics import inception_train as it
from jckx_torch.metrics import inception_v3 as iv
from jckx_torch.data.augment import random_resized_crop_flip
from jckx_torch.utils.graphs import EagerGraph
from portbench import judge
from portbench.reference import inception as ref
from portbench.traffic import finetune as traffic
from torch_threads import one_torch_thread  # noqa: F401

CONFIG = Path(__file__).resolve().parent.parent / "portbench" / "configs" / "inception-v3-299.json"
SEED, WEIGHTS = 2 ** 31 + 11, 2 ** 31 + 12
GRAD_TOL, FWD_TOL, STAT_TOL, LOGIT_TOL = 0.25, 1e-4, 5e-3, 5e-3


def _config(tiny: bool = True) -> dict:
    cfg = json.loads(CONFIG.read_text())
    over = cfg.pop("tiny")
    if tiny:
        cfg = {**cfg, **over, "train": {**cfg["train"], **over["train"]}}
    return {**cfg, "compute_dtype": "float32"}


CFG = _config()
BS = CFG["train"]["batch_size"]
CELL = CONFIG.parent.parent / "workloads" / "inception-v3-299.finetune.json"
TINY_LIMITS = json.loads(CELL.read_text())["tiny"]["limits"]  # the CPU cut's, float32


def _data():
    rng = np.random.RandomState(5)
    return (rng.randint(0, 256, (32, 32, 32, 3)).astype(np.uint8),
            rng.randint(0, CFG["num_classes"], 32).astype(np.int32))


def _net(state: dict) -> iv.InceptionV3:
    net = iv.InceptionV3(CFG["num_classes"])
    missing, unexpected = net.load_state_dict({**state["p"], **state["stats"]}, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return net


def _rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_parameters_are_the_programs_at_the_published_size():
    full = _config(tiny=False)
    for cfg in (full, CFG):
        shapes = ref.param_shapes(cfg)["net"]
        prog = {k: tuple(v.shape) for k, v in iv.InceptionV3(cfg["num_classes"]).named_parameters()}
        assert list(shapes) == list(prog) and shapes == prog
    assert sum(math.prod(s) for s in ref.param_shapes(full)["net"].values()) == 21_990_468
    assert full["params"] == {"net": 21_990_468} and len(ref.basic_convs(full)) == 94


def test_train_forward_matches_the_reference():
    """The network's input from the same rows and draws, then the
    train-mode forward's logits, loss and running statistics."""
    state = ref.init_state(CFG, WEIGHTS, torch.device("cpu"))
    x_u8, y = _data()
    u8, labels = torch.from_numpy(x_u8[:BS]), torch.from_numpy(y[:BS].astype(np.int64))
    d = ref.step_draws(SEED, 1, BS, torch.device("cpu"))[0]
    prog_draws = it.draw_step(torch.Generator().manual_seed(SEED), BS)
    assert all(torch.equal(getattr(prog_draws.crops, k), d[k])
               for k in ("area", "log_ratio", "y", "x", "flip"))
    assert torch.equal(prog_draws.keep, d["keep"])

    x = ref.inputs(u8, CFG, d)
    mean, std = torch.tensor(ref.MEAN), torch.tensor(ref.STD)
    prog_x = (random_resized_crop_flip(u8.float() / 255.0, CFG["image_size"], prog_draws.crops)
              - mean) / std
    assert float((prog_x.permute(0, 3, 1, 2) - x).abs().max()) <= 1e-5

    net = _net(state)
    logits = net.forward_train(prog_x, prog_draws.keep, torch.float32)
    stats = {k: v.clone() for k, v in state["stats"].items()}
    want = ref.forward(state["p"], stats, CFG, x, d["keep"])
    assert _rel_max(logits.detach(), want) <= LOGIT_TOL
    loss, want_loss = torch.nn.functional.cross_entropy(logits, labels), ref.loss_fn(want, labels)
    assert abs(float(loss) - float(want_loss)) <= FWD_TOL * abs(float(want_loss))
    bufs = dict(net.named_buffers())
    assert max(_rel_max(bufs[k], v) for k, v in stats.items()) <= STAT_TOL


def _args(scan_steps: int = 0):
    return it.get_args(["--device", "cpu", "--compute_dtype", "float32", "--image_size",
                        str(CFG["image_size"]), "-b", str(BS), "--scan_steps", str(scan_steps),
                        "--seed", str(SEED)])


def _prepared(monkeypatch, graph=EagerGraph):
    """``prepare`` on the tiny rows, the reference's starting state loaded:
    → (run, the starting state on the host, the epoch's batches, the
    benchmark's ``Steps`` over the same rows, batches and draws)."""
    monkeypatch.setattr(it, "graph_for", lambda *a, **k: (graph, "") if graph else (None, "test"))
    x, y = _data()
    run = it.prepare(_args(), x, y, CFG["num_classes"], torch.device("cpu"))
    start = ref.init_state(CFG, WEIGHTS, torch.device("cpu"))
    run.net.load_state_dict({**start["p"], **start["stats"]}, strict=False)
    order = np.random.RandomState(SEED).permutation(len(y))[: len(y) // BS * BS].reshape(-1, BS)
    ctx = SimpleNamespace(device=torch.device("cpu"), config=CFG)
    return run, traffic.host_state(start), order, traffic.Steps(ctx, x, y, order, SEED)


def test_one_step_matches_the_reference(monkeypatch):
    """The eager step: each leaf's gradient as SGD got it (read from the
    momentum buffer) and the running statistics."""
    run, start, order, steps = _prepared(monkeypatch, graph=None)
    assert run.superstep is None
    rows, read = it.launch(run, torch.from_numpy(order), 0, 1)
    assert read is None and rows.shape == (1, 2)
    prog = traffic.program_state(run)
    want = steps.walk(start, 0, 1)
    assert abs(float(rows[0, 0]) - want["loss"][0]) <= FWD_TOL * abs(want["loss"][0])
    tr = CFG["train"]
    g, gr = (traffic.applied_gradient(start, s, tr) for s in (prog, want["states"][0]))
    assert max(judge.diff_gaps(g, gr, judge.moving_leaves(gr))) <= GRAD_TOL
    assert max(_rel_max(prog["stats"][k], v) for k, v in want["states"][0]["stats"].items()) \
        <= STAT_TOL


def _three_launches(monkeypatch):
    """Three steps, one launch each, through the superstep's route (the
    eager step before the capture, then two replays): → (run, start,
    order, steps, the program's three steps)."""
    run, start, order, steps = _prepared(monkeypatch)
    order_dev = torch.from_numpy(order)
    prog = {"states": [], "loss": []}
    for s in range(3):
        rows, _ = it.launch(run, order_dev, s, 1)
        prog["loss"].append(float(rows[0, 0]))
        prog["states"].append(traffic.program_state(run))
    assert (run.superstep.captures, run.superstep.replays) == (1, 2)
    return run, start, order, steps, prog


def test_three_launches_equal_the_reference(monkeypatch):
    """The three steps judged as the benchmark judges them."""
    run, start, order, steps, prog = _three_launches(monkeypatch)
    got = steps.numbers(start, prog)
    assert got["grad_step_gap"] <= GRAD_TOL and got["fwd_step_gap"] <= FWD_TOL
    assert got["stat_step_gap"] <= STAT_TOL
    assert all(got[k] <= lim for k, lim in TINY_LIMITS.items()), got
    rows, read = it.launch(run, torch.from_numpy(order), 3, 2)  # a launch of two, unread
    assert read is None and rows.shape == (2, 2) and torch.isfinite(rows).all()


@pytest.mark.parametrize("kind", ["nodrop", "fp8"])
def test_a_fault_or_the_control_reads_above_the_limits(monkeypatch, kind):
    """The program with its dropout mask left out, and the reference in
    float8 in the program's place, each read above a limit that the sound
    program passes (``test_three_launches_equal_the_reference``)."""
    if kind == "nodrop":
        plain = iv.InceptionV3.forward_train

        def no_mask(self, x, dropout_keep=None, *a, **k):
            return plain(self, x, None, *a, **k)

        monkeypatch.setattr(iv.InceptionV3, "forward_train", no_mask)
        _, start, _, steps, prog = _three_launches(monkeypatch)
    else:
        _, start, _, steps = _prepared(monkeypatch)
        prog = steps.walk(start, 0, 3, precision="fp8")
    got = steps.numbers(start, prog)
    assert got["grad_step_gap"] > GRAD_TOL and got["fwd_step_gap"] > FWD_TOL
    assert any(got[k] > lim for k, lim in TINY_LIMITS.items()), got  # the cell's CPU cut too


def test_the_reference_in_bfloat16_and_float64():
    """The reference's two other precisions, with which the cell's readings
    show where the program's gaps come from: ``"bf16"`` rounds a product's
    operands and result, and the gradient back through it, to bfloat16;
    ``"f64"`` takes the step in float64 (its state back in float32 on the
    host). Against the float64 step, the float32 step's worst leaf reads
    0.027 here (float32's rounding, amplified by BN over 4 rows; ≤ 0.1
    asked) and the bfloat16 step's 1.6 (≥ 0.5 asked): the rounding alone
    gives the gradient gap that the program's bfloat16 step reads."""
    x = torch.linspace(-3.0, 5.0, 97, dtype=torch.float32, requires_grad=True)
    y = ref._q(x, "bf16")
    assert torch.equal(y.detach(), x.detach().bfloat16().float())
    (g,) = torch.autograd.grad((y * y).sum(), x)
    assert torch.equal(g, (2 * y.detach()).bfloat16().float())
    assert ref._q(x, "f64") is x and ref._q(x, "f32") is x
    start = ref.init_state(CFG, WEIGHTS, torch.device("cpu"))
    x_u8, y = _data()
    u8, labels = torch.from_numpy(x_u8[:BS]), torch.from_numpy(y[:BS].astype(np.int64))
    d = ref.step_draws(SEED, 1, BS, torch.device("cpu"))[0]
    out = {p: ref.train_step(start, CFG, u8, labels, d, p) for p in ("f32", "f64", "bf16")}
    assert out["f64"]["grad"]["fc.weight"].dtype == torch.float64
    assert traffic.host_state(out["f64"]["state"])["p"]["fc.weight"].dtype == torch.float32
    exact = out["f64"]["grad"]
    worst = {p: max(judge.diff_gaps(out[p]["grad"], exact, judge.moving_leaves(exact)))
             for p in ("f32", "bf16")}
    assert worst["f32"] <= 0.1 and worst["bf16"] >= 0.5, worst


def test_the_step_counts():
    """The yardstick's counts at the published size: 4.384e12 FLOP a bs128
    step (forward, backward and the crop's products), and the BN kernel's
    bytes (each of the 94 maps read and written once in bfloat16, two
    vectors each)."""
    t0 = time.perf_counter()
    full = _config(tiny=False)
    maps = ref.bn_maps(full, 128)
    assert len(maps) == 94 and maps[0] == (128, 32, 149, 149) and maps[2] == (128, 64, 147, 147)
    assert ref.bn_act_bytes(full, 128, 2) == sum(4 * math.prod(m) + 8 * m[1] for m in maps)
    assert ref.step_flops(full, 128) == pytest.approx(4.384e12, rel=1e-3)
    assert time.perf_counter() - t0 < 30
