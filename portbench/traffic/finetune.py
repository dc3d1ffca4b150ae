"""Traffic kind ``finetune``: InceptionV3's fine-tune (the program's
``jckx_torch.metrics.inception_train``) on its own launch path, on a
resident data set.

Set-up makes the data (the workload's ``data``: uint8 rows and class
labels drawn from the seed, as ``train``'s) and the weights (the
reference's ``init_state`` from the seed), builds the program's fine-tune
state on them with ``inception_train.prepare`` (the configuration's batch,
compute dtype, optimizer and ``scan_steps``; no evals, no files) and drives
it with the window's own call, ``inception_train.launch``, over the
epoch's permuted batches as ``train()`` takes them: the first three steps
one launch each (the eager step before the capture, then two replays),
the state after each kept for the check, then one launch of ``scan_steps``
steps to warm the window's shapes. The window runs launches of
``scan_steps`` steps (fewer at an epoch's end, a new permutation after
it), each ending in its one read of the steps' loss and accuracy, until
``--seconds`` have passed.

``train_img_s`` is every image trained in the window over the window's
time. The check (``numbers``) holds the three checked steps to the plain
reference (``reference/inception.py``), which takes them from the same
weights, rows, crops, flips and keep masks, computed whole after the
window's memory is freed (batch statistics cannot be split by rows):

- ``grad_step{s}_gap`` (s = 1, 2, 3; the worst of the three without the
  digit): the loss's gradient of each parameter in step s, read from each
  side's state as SGD got it (the momentum buffer after the step less μ
  times the one before, less the weight decay), against the reference's
  one step from the state the program began step s in: the worst leaf's
  ‖program − reference‖ / max(‖reference‖, the median leaf's), leaves whose
  reference gradient is under a thousandth of the median leaf's left out
  (``judge.diff_gaps``); ``grad_step_median_gap`` the median leaf's;
- ``fwd_step{s}_gap``: that step's loss, |program − reference| /
  |reference|;
- ``stat_step{s}_gap``: the batch statistics that step folded into each
  BN layer's running mean and variance, read from the running statistics
  before and after it ((after − (1 − m) · before) / m), the worst layer's
  max |program − reference| over that layer's largest |reference|, of the
  mean or of the variance;
- over the three steps from the same start (the reference's own three):
  ``change_gap`` / ``change_median_gap``, the parameters' change by norm
  as the GAN cells measure it (``judge.leaf_gaps``), and ``loss_gap``.

Which of them a cell compares, and their limits, its workload file says.
A workload's own ``compute_dtype``, where it states one, runs the program
in it in place of the configuration's (the CPU cut's runs float32).
A program without ``prepare`` and ``launch`` is refused at once, naming
what is missing.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench import core, judge
from portbench.reference import inception as ref
from portbench.traffic.train import epoch_order, make_rows

REPLAYED_STEPS = True  # the control and the half batch are read in the replayed steps alone too
CHECK_STEPS = 3
NEEDS = ("prepare", "launch")  # the program's calls this kind drives


def _program():
    """The program's fine-tune module, refused at once where it lacks the
    calls this kind drives."""
    from jckx_torch.metrics import inception_train

    missing = [name for name in NEEDS if not hasattr(inception_train, name)]
    if missing:
        raise SystemExit("portbench: jckx_torch.metrics.inception_train has no "
                         + " / ".join(f"`{name}`" for name in missing)
                         + ": the fine-tune's launch path this traffic kind drives")
    return inception_train


def _data(ctx):
    return make_rows(ctx.seed_for("data"), ctx.workload["data"])


def _seed(ctx) -> int:
    return ctx.seed_for("trainer") % 2 ** 32  # the shuffle's RandomState takes 32 bits


def compute_dtype(ctx) -> str:
    """The program's compute dtype: the workload's where it states one,
    else the configuration's."""
    return ctx.workload.get("compute_dtype", ctx.config["compute_dtype"])


def program_args(it, cfg: dict, seed: int, device, dtype: str):
    """The fine-tune's arguments: the configuration's settings, the compute
    dtype ``dtype`` and the seed."""
    tr = cfg["train"]
    return it.get_args(["--device", str(device), "--compute_dtype", dtype,
                        "--image_size", str(cfg["image_size"]), "-b", str(tr["batch_size"]),
                        "-mlr", str(tr["learning_rate"]), "-wd", str(tr["weight_decay"]),
                        "-snt", str(int(tr["nesterov"])), "--scan_steps", str(tr["scan_steps"]),
                        "--seed", str(seed)])


def host_state(st: dict) -> dict:
    return {k: {n: v.detach().float().cpu().clone() for n, v in st[k].items()} for k in st}


def program_state(run) -> dict:
    """Host copies of the program's state in ``init_state``'s layout:
    parameters, momentum buffers (zero before SGD's first step), running
    statistics."""
    p = {k: v.detach().float().cpu().clone() for k, v in run.net.named_parameters()}
    buf = {}
    for k, v in run.net.named_parameters():
        b = run.opt.state.get(v, {}).get("momentum_buffer")
        buf[k] = torch.zeros_like(p[k]) if b is None else b.detach().float().cpu().clone()
    stats = {k: v.detach().float().cpu().clone() for k, v in run.net.named_buffers()
             if ".running_" in k}
    return {"p": p, "buf": buf, "stats": stats}


class Steps:
    """What a step reads besides the state: the rows and labels on the
    device, the epoch's batches, the first steps' draws."""

    def __init__(self, ctx, rows: np.ndarray, labels: np.ndarray, order: np.ndarray, seed: int):
        dev = ctx.device
        self.ctx, self.order = ctx, order
        self.rows = torch.from_numpy(rows).to(dev)
        self.labels = torch.from_numpy(labels.astype(np.int64)).to(dev)
        bs = ctx.config["train"]["batch_size"]
        self.draws = ref.step_draws(seed, CHECK_STEPS, bs, dev)

    def walk(self, start: dict, first: int, steps: int, precision: str = "f32",
             fault: str = "", from_step: int = 0) -> dict:
        """The reference's steps ``first`` … ``first + steps − 1`` from the
        host state ``start``, at ``precision`` with ``fault`` from step
        ``from_step`` on → {"states": host copies after each, "loss"}."""
        dev, cfg = self.ctx.device, self.ctx.config
        st = {k: {n: v.to(dev) for n, v in start[k].items()} for k in start}
        states, losses = [], []
        for s in range(first, first + steps):
            late = s >= from_step
            idx = torch.from_numpy(self.order[s].astype(np.int64)).to(dev)
            out = ref.train_step(st, cfg, self.rows[idx], self.labels[idx], self.draws[s],
                                 precision if late else "f32", fault if late else "")
            st = out["state"]
            states.append(host_state(st))
            losses.append(out["loss"])
        return {"states": states, "loss": losses}

    def numbers(self, start: dict, prog: dict) -> dict:
        befores = [start] + prog["states"][:-1]
        single = [self.walk(before, s, 1) for s, before in enumerate(befores)]
        return numbers(start, prog, self.walk(start, 0, CHECK_STEPS), single,
                       self.ctx.config["train"])


def applied_gradient(before: dict, after: dict, tr: dict) -> dict:
    """The loss's gradient SGD got in the step from ``before`` to ``after``:
    (buf' − μ · buf) − wd · p."""
    mu, wd = tr["momentum"], tr["weight_decay"]
    return {k: after["buf"][k] - mu * before["buf"][k] - wd * before["p"][k]
            for k in after["buf"]}


def batch_stats(before: dict, after: dict) -> dict:
    """The batch statistics a step folded into each running statistic."""
    m = ref.MOMENTUM
    return {k: (after["stats"][k] - (1.0 - m) * before["stats"][k]) / m for k in after["stats"]}


def _worst_layer(prog: dict, ref: dict) -> float:
    return max(float((prog[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30))
               for k in ref)


def numbers(start: dict, prog: dict, ref: dict, single: list, tr: dict) -> dict:
    """``start``: the state before step 1; ``prog`` / ``ref``: the
    program's and the reference's three steps from it, {"states": the
    state after each, "loss": each step's}; ``single[s]``: the reference's
    one step from the state the program began step s + 1 in → the numbers
    (module docstring)."""
    out = {}
    befores = [start] + prog["states"][:-1]
    medians = []
    for s, (before, after, one) in enumerate(zip(befores, prog["states"], single), 1):
        r_after = one["states"][0]
        gr = applied_gradient(before, r_after, tr)
        gaps = judge.diff_gaps(applied_gradient(before, after, tr), gr, judge.moving_leaves(gr))
        out[f"grad_step{s}_gap"] = max(gaps)
        medians.append(statistics.median(gaps))
        out[f"fwd_step{s}_gap"] = abs(prog["loss"][s - 1] - one["loss"][0]) / abs(one["loss"][0])
        out[f"stat_step{s}_gap"] = _worst_layer(batch_stats(before, after),
                                                batch_stats(before, r_after))
    for name in ("grad_step", "fwd_step", "stat_step"):
        out[f"{name}_gap"] = max(out[f"{name}{s}_gap"] for s in range(1, len(single) + 1))
    out["grad_step_median_gap"] = max(medians)
    change = judge.leaf_gaps({k: v - start["p"][k] for k, v in prog["states"][-1]["p"].items()},
                             {k: v - start["p"][k] for k, v in ref["states"][-1]["p"].items()})
    out["change_gap"], out["change_median_gap"] = max(change), statistics.median(change)
    out["loss_gap"] = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    return out


def readings(ctx, precision: str = "f32", fault: str = "", from_step: int = 0) -> dict:
    """The judge's numbers for the reference at ``precision`` with ``fault``
    (``"half"``, ``"nodrop"``, ``"unchanged"``) put in the program's place
    from step ``from_step`` on (0: every step; 1: the replayed steps alone),
    on this run's weights, rows and draws at the cell's size."""
    cfg = ctx.config
    seed = _seed(ctx)
    rows, labels = _data(ctx)
    start = host_state(ref.init_state(cfg, ctx.seed_for("weights"), ctx.device))
    check = Steps(ctx, rows, labels,
                  epoch_order(len(rows), cfg["train"]["batch_size"], np.random.RandomState(seed)),
                  seed)
    return check.numbers(start, check.walk(start, 0, CHECK_STEPS, precision, fault, from_step))


def run(ctx) -> core.Outcome:
    it = _program()
    cfg, dev = ctx.config, ctx.device
    tr = cfg["train"]
    bs, k_launch = tr["batch_size"], tr["scan_steps"]
    seed = _seed(ctx)
    rows, labels = _data(ctx)
    init = ref.init_state(cfg, ctx.seed_for("weights"), dev)
    start = host_state(init)
    dtype = compute_dtype(ctx)
    run_ = it.prepare(program_args(it, cfg, seed, dev, dtype), rows, labels, cfg["num_classes"],
                      dev)
    missing, unexpected = run_.net.load_state_dict({**init["p"], **init["stats"]}, strict=False)
    del init
    counts = {"net": sum(p.numel() for p in run_.net.parameters())}
    if unexpected or [k for k in missing if not k.endswith("num_batches_tracked")] \
            or counts != cfg["params"]:
        raise SystemExit(f"portbench: the program's InceptionV3 holds {counts} parameters "
                         f"(missing {missing}, unexpected {unexpected}), the configuration "
                         f"{cfg['params']}")

    spe = len(rows) // bs
    rng = np.random.RandomState(seed)  # train()'s shuffle stream
    order = epoch_order(len(rows), bs, rng)
    order_dev = torch.from_numpy(order).to(dev)

    def launch(first: int, k: int) -> np.ndarray:
        with ctx.span("launch"):
            out, read = it.launch(run_, order_dev, first, k)
            if read is None:  # a launch shorter than scan_steps ends in no read of its own
                with ctx.span("telemetry_read"):
                    read = out.cpu().numpy()
            return read

    prog = {"states": [], "loss": []}
    for s in range(CHECK_STEPS):  # the eager step before the capture, then two replays
        prog["loss"].append(float(launch(s, 1)[0, 0]))
        prog["states"].append(program_state(run_))
    done = CHECK_STEPS
    launch(done, k_launch)  # warm: the window's launch shape
    done += k_launch
    steps = bad = 0
    ctx.setup_done()

    t0 = time.perf_counter()
    with ctx.window():
        while time.perf_counter() - t0 < ctx.seconds:
            if done >= spe:  # the next epoch: train()'s next permutation
                order, done = epoch_order(len(rows), bs, rng), 0
                order_dev = torch.from_numpy(order).to(dev)
            k = min(k_launch, spe - done)
            vals = launch(done, k)
            bad += int((~np.isfinite(vals)).any(axis=1).sum())
            done += k
            steps += k
    elapsed = time.perf_counter() - t0
    peak = ctx.memory_peak()
    del run_
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    check = Steps(ctx, rows, labels, epoch_order(len(rows), bs, np.random.RandomState(seed)),
                  seed)
    nums = check.numbers(start, prog)
    notes = [f"loss step {s + 1}: program {v!r}" for s, v in enumerate(prog["loss"])]
    element = 2 if dtype == "bfloat16" else 4
    return core.Outcome(
        e2e={"train_img_s": steps * bs / elapsed}, attempted=steps, failed=bad,
        checks=core.limited(ctx, nums), memory_peak=peak, counts={"steps": steps},
        facts={"flops_per_step": ref.step_flops(cfg, bs),
               "bn_act_bytes_per_step": ref.bn_act_bytes(cfg, bs, element),
               "bn_act_layers": len(ref.basic_convs(cfg))},
        notes=notes, numbers=nums)
