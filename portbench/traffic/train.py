"""Traffic kind ``train``: the GAN trainers' own launch path on a resident
data set.

Set-up makes the data (the workload's ``data``: rows of uint8 images and
class labels drawn from the seed, handed to the program as its ``npz``
data set) and the weights (``weights.make``), builds the program's
trainer on them (``--data_placement hbm``, evals and checkpoints off), and
drives it from the seed through its first steps with the window's own
call, ``_BaseGANTrainer._launch``, over the epoch's permuted batches as
``train()`` takes them: one step at a time (the eager step before the
capture, then two replays), the state after each kept for the check. One
launch of ``log_every`` steps warms the shapes of the window. The window
then runs launches of ``log_every`` steps (fewer at an epoch's end, a new
permutation after it), each ending in its one telemetry read, until
``--seconds`` have passed.

``train_img_s`` is every image trained in the window over the window's
time. The check (``judge.train_numbers``): the plain reference takes the
same three steps from the same weights, rows and draws, and one step from
each state the program began a step in.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from portbench import core, judge, weights
from portbench.reference import cost, frozen, gan


def make_rows(seed: int, data: dict):
    """→ (uint8 (rows, size, size, channels), int32 labels (rows,)) from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (data["rows"], data["size"], data["size"], data["channels"]),
                     dtype=np.uint8)
    return x, rng.integers(0, data["classes"], data["rows"], dtype=np.int32)


def program_config(cfg: dict, seed: int, npz: str, tmp: str, device):
    """The trainer's ``Config``: the configuration's settings, the window's
    plane, no evals, no checkpoints, no log file."""
    from jckx_torch.configs import Config

    tr = cfg["train"]
    return Config(model="CGAN" if cfg["conditional"] else "DCGAN", batch_size=tr["batch_size"],
                  epoch=1_000_000, max_learning_rate=tr["learning_rate"],
                  adam_beta1=tr["adam_betas"][0], adam_beta2=tr["adam_betas"][1],
                  lambda_gp=tr["lambda_gp"], instance_noise=tr["instance_noise"],
                  label_real=tr["label_real"], label_fake=tr["label_fake"],
                  gp_in_d_grad=tr["gp_in_d_grad"], ema_decay=tr["ema_decay"],
                  log_every=tr["log_every"], eval_every=0, base_width=cfg["base_width"],
                  z_dim=cfg["z_dim"], num_classes=cfg["num_classes"],
                  image_size=cfg["image_size"], channels=cfg["channels"], dataset="npz",
                  data_path=npz, data_dir=tmp, save_root=os.path.join(tmp, "save"), seed=seed,
                  device=str(device), compute_dtype=cfg["compute_dtype"], log_file=0,
                  preempt_save=False, data_placement="hbm")


def build_trainer(cfg: dict, pcfg, params: dict):
    """The program's trainer around nets that hold ``params``."""
    from jckx_torch.data.pipeline import CGANDataPreprocessor, DCGANDataPreprocessor
    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
    from jckx_torch.train.gan_trainer import CGANTrainer, DCGANTrainer

    geo = GANGeometry(z_dim=cfg["z_dim"], image_size=cfg["image_size"],
                      channels=cfg["channels"], base_width=cfg["base_width"])
    if cfg["conditional"]:
        data = CGANDataPreprocessor(pcfg)
        G, D = CGenerator(geo, cfg["num_classes"]), CDiscriminator(geo, cfg["num_classes"])
    else:
        data = DCGANDataPreprocessor(pcfg)
        G, D = Generator(geo), Discriminator(geo)
    G.load_state_dict(weights.state_dict(params["g"]))
    D.load_state_dict(weights.state_dict(params["d"]))
    counts = {net: sum(p.numel() for p in mod.parameters()) for net, mod in (("g", G), ("d", D))}
    if counts != cfg["params"]:
        raise SystemExit(f"portbench: G, D hold {counts} parameters, the configuration "
                         f"{cfg['params']}")
    return (CGANTrainer if cfg["conditional"] else DCGANTrainer)(pcfg, G, D, data)


def program_state(st) -> dict:
    """Host copies of the program's state in ``gan.TrainState.snapshot``'s
    layout (moments zero and count 0 where an optimizer took no step)."""
    out = {"ema": {k: p.detach().float().cpu().clone() for k, p in st.ema_g.named_parameters()}}
    for net, mod, opt in (("g", st.G, st.opt_g), ("d", st.D, st.opt_d)):
        out[net], out[f"m_{net}"], out[f"v_{net}"], out[f"t_{net}"] = {}, {}, {}, 0
        for k, p in mod.named_parameters():
            state = opt.state.get(p, {})
            out[net][k] = p.detach().float().cpu().clone()
            for key, name in (("exp_avg", "m"), ("exp_avg_sq", "v")):
                out[f"{name}_{net}"][k] = (state[key].detach().float().cpu().clone()
                                           if key in state else torch.zeros_like(out[net][k]))
            if "step" in state:
                out[f"t_{net}"] = int(float(state["step"]))
    return out


REPLAYED_STEPS = True  # the control and the half batch are read in the replayed steps alone too
TELEMETRY = ("loss_d", "gp", "d_x", "d_gz1", "loss_g")  # a step's readings the judge compares
CHECK_STEPS = 3


class Steps:
    """What a step reads besides the state: the data, the epoch's order of
    rows and the trainer's seed, from which the draws are made."""

    def __init__(self, ctx, rows: np.ndarray, labels: np.ndarray, order: np.ndarray, seed: int):
        self.ctx, self.rows, self.labels, self.order, self.seed = ctx, rows, labels, order, seed

    def inputs(self, s: int):
        """Step ``s``'s (0-based) real rows, draws and one-hot labels on the device."""
        cfg, dev = self.ctx.config, self.ctx.device
        idx = self.order[s]
        real = frozen.decode(torch.from_numpy(self.rows[idx]).to(dev), cfg["image_size"])
        draws = frozen.step_draws(self.seed, s, len(idx), cfg["image_size"], cfg["channels"],
                                  cfg["z_dim"], dev, cfg["conditional"])
        onehot = None
        if cfg["conditional"]:
            lab = torch.from_numpy(self.labels[idx].astype(np.int64)).to(dev)
            onehot = torch.nn.functional.one_hot(lab, cfg["num_classes"]).float()
        return real, draws, onehot

    def walk(self, start: dict, first: int, steps: int, precision: str = "f32",
             fault: str = "", from_step: int = 0) -> dict:
        """The reference's steps ``first`` … ``first + steps − 1`` from the
        state ``start``, computed at ``precision`` with ``fault`` from step
        ``from_step`` on → {"states": the state after each, "telemetry"}."""
        gan.no_tf32()
        st = gan.TrainState.restore(start, self.ctx.config, self.ctx.device)
        states, telemetry = [], []
        for s in range(first, first + steps):
            late = s >= from_step
            out = gan.train_step(st, self.ctx.config, *self.inputs(s),
                                 precision if late else "f32", fault if late else "")
            telemetry.append({k: out[k] for k in TELEMETRY})
            states.append(st.snapshot())
        return {"states": states, "telemetry": telemetry}

    def numbers(self, start: dict, prog: dict) -> dict:
        """``prog``'s three steps from ``start`` judged: against the
        reference's own three, and each against the reference's one step
        from the state ``prog`` began it in."""
        befores = [start] + prog["states"][:-1]
        single = [self.walk(before, s, 1) for s, before in enumerate(befores)]
        tr = self.ctx.config["train"]
        return judge.train_numbers(start, prog, self.walk(start, 0, CHECK_STEPS), single,
                                   tr["lambda_gp"], tr["adam_betas"][0])


def epoch_order(rows: int, bs: int, rng: np.random.RandomState) -> np.ndarray:
    """``train()``'s permutation of an epoch, in whole batches: (steps, bs)."""
    spe = rows // bs
    return rng.permutation(rows)[:spe * bs].reshape(spe, bs)


def readings(ctx, precision: str = "f32", fault: str = "", from_step: int = 0) -> dict:
    """The judge's numbers for the reference at ``precision`` with ``fault``
    put in the program's place (the control: ``"fp8"``) from step
    ``from_step`` on (0: every step; 1: the replayed steps alone), on this
    run's weights, rows and draws at the cell's size."""
    cfg, wl = ctx.config, ctx.workload
    seed = ctx.seed_for("trainer") % 2 ** 32
    rows, labels = make_rows(ctx.seed_for("data"), wl["data"])
    params = weights.make(cfg, ctx.seed_for("weights"), ctx.device)
    start = gan.TrainState(params["g"], params["d"], cfg).snapshot()
    del params
    check = Steps(ctx, rows, labels,
                  epoch_order(len(rows), cfg["train"]["batch_size"], np.random.RandomState(seed)),
                  seed)
    return check.numbers(start, check.walk(start, 0, CHECK_STEPS, precision, fault, from_step))


def run(ctx) -> core.Outcome:
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    tr = cfg["train"]
    bs, k_launch = tr["batch_size"], tr["log_every"]
    seed = ctx.seed_for("trainer") % 2 ** 32  # the trainer's seed: its shuffle takes 32 bits
    rows, labels = make_rows(ctx.seed_for("data"), wl["data"])
    npz = os.path.join(ctx.tmp, "data.npz")
    np.savez(npz, x=rows, y=labels)
    params = weights.make(cfg, ctx.seed_for("weights"), dev)
    start = gan.TrainState(params["g"], params["d"], cfg).snapshot()
    pcfg = program_config(cfg, seed, npz, ctx.tmp, dev)
    trainer = build_trainer(cfg, pcfg, params)
    del params
    os.remove(npz)
    st = trainer.state

    spe = len(rows) // bs
    rng = np.random.RandomState(seed)  # train()'s shuffle stream
    order = epoch_order(len(rows), bs, rng)
    check = Steps(ctx, rows, labels, order, seed)

    def launch(first: int, k: int) -> np.ndarray:
        with ctx.span("launch"):
            idx = torch.from_numpy(order[first:first + k].astype(np.int64)).to(dev)
            vals = trainer._launch([{"idx": idx[j]} for j in range(k)])
            with ctx.span("telemetry_read"):
                return vals.cpu().numpy()  # the launch's one sync

    from jckx_torch.train.steps import METRIC_NAMES

    prog = {"states": [], "telemetry": []}
    for s in range(CHECK_STEPS):  # the eager step before the capture, then two replays
        vals = launch(s, 1)[0]
        prog["telemetry"].append({k: float(vals[METRIC_NAMES.index(k)]) for k in TELEMETRY})
        prog["states"].append(program_state(st))
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
            k = min(k_launch, spe - done)
            vals = launch(done, k)
            bad += int((~np.isfinite(vals)).any(axis=1).sum())
            done += k
            steps += k
    elapsed = time.perf_counter() - t0
    peak = ctx.memory_peak()
    del trainer, st
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    nums = check.numbers(start, prog)
    notes = [f"{name} step {s + 1}: program {t[name]!r}"
             for s, t in enumerate(prog["telemetry"]) for name in ("loss_d", "loss_g")]
    return core.Outcome(
        e2e={"train_img_s": steps * bs / elapsed}, attempted=steps, failed=bad,
        checks=core.limited(ctx, nums), memory_peak=peak,
        counts={"steps": steps},
        facts={"flops_per_step": cost.step_flops(cfg, bs)}, notes=notes, numbers=nums)
