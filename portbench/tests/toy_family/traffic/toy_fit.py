"""Traffic kind ``toy_fit`` of the toy family: its classifier as
``torch.nn`` modules trained by ``torch.optim.SGD`` on rows drawn from the
seed, one batch after another, for ``--seconds``. Set-up takes the first
``check_steps`` steps through the window's own step; the check compares
the parameters after them with the family's plain reference's."""

from __future__ import annotations

import time

import torch

from portbench import core

REPLAYED_STEPS = False  # no captured steps to read apart


def _inputs(ctx):
    """→ (rows, labels, the starting parameters), all from the seed."""
    cfg, wl = ctx.config, ctx.workload
    gen = torch.Generator().manual_seed(ctx.seed_for("data"))
    x = torch.randn(wl["rows"], cfg["inputs"], generator=gen)
    y = torch.randint(0, cfg["classes"], (wl["rows"],), generator=gen)
    gen.manual_seed(ctx.seed_for("weights"))
    shapes = core.reference(cfg, ctx.root).param_shapes(cfg)["net"]
    start = {k: 0.1 * torch.randn(s, generator=gen) for k, s in shapes.items()}
    return x.to(ctx.device), y.to(ctx.device), {k: v.to(ctx.device) for k, v in start.items()}


def _batch(ctx, x, y, s: int):
    bs = ctx.workload["batch_size"]
    at = (s * bs) % (len(x) - bs + 1)
    return x[at:at + bs], y[at:at + bs]


def _walk(ctx, x, y, start: dict, dtype=torch.float32) -> dict:
    """The reference's parameters after the checked steps, computed in ``dtype``."""
    ref = core.reference(ctx.config, ctx.root)
    p = {k: v.to(dtype) for k, v in start.items()}
    for s in range(ctx.workload["check_steps"]):
        bx, by = _batch(ctx, x, y, s)
        p = ref.sgd_step(p, bx.to(dtype), by, ctx.config["learning_rate"])
    return p


def _numbers(ctx, x, y, start: dict, got: dict) -> dict:
    """The worst leaf's max |got − reference| / max |reference|."""
    want = _walk(ctx, x, y, start)
    return {"param_gap": max(((got[k].float() - v).abs().max() / v.abs().max()).item()
                             for k, v in want.items())}


def readings(ctx, precision: str = "f32", fault: str = "") -> dict:
    """The judge's number for the reference put in the program's place,
    computed in bfloat16 where ``precision`` is not ``"f32"`` (the control)."""
    x, y, start = _inputs(ctx)
    dtype = torch.float32 if precision == "f32" else torch.bfloat16
    return _numbers(ctx, x, y, start, _walk(ctx, x, y, start, dtype))


def run(ctx) -> core.Outcome:
    cfg, wl = ctx.config, ctx.workload
    x, y, start = _inputs(ctx)
    net = torch.nn.Sequential(torch.nn.Linear(cfg["inputs"], cfg["hidden"]), torch.nn.ReLU(),
                              torch.nn.Linear(cfg["hidden"], cfg["classes"])).to(ctx.device)
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(start[k])
    counts = {"net": sum(p.numel() for p in net.parameters())}
    if counts != cfg["params"]:
        raise SystemExit(f"portbench: the net holds {counts} parameters, the "
                         f"configuration {cfg['params']}")
    opt = torch.optim.SGD(net.parameters(), lr=cfg["learning_rate"])

    def step(s: int) -> None:
        bx, by = _batch(ctx, x, y, s)
        opt.zero_grad(set_to_none=True)
        torch.nn.functional.cross_entropy(net(bx), by).backward()
        opt.step()

    for s in range(wl["check_steps"]):
        step(s)
    got = {k: p.detach().clone() for k, p in net.named_parameters()}
    done = wl["check_steps"]
    ctx.setup_done()
    t0 = time.perf_counter()
    with ctx.window():
        while time.perf_counter() - t0 < ctx.seconds:
            with ctx.span("step"):
                step(done)
            done += 1
    elapsed = time.perf_counter() - t0
    steps = done - wl["check_steps"]
    nums = _numbers(ctx, x, y, start, got)
    return core.Outcome(e2e={"train_img_s": steps * wl["batch_size"] / elapsed},
                        attempted=steps, failed=0, checks=core.limited(ctx, nums),
                        memory_peak=ctx.memory_peak(), counts={"steps": steps}, numbers=nums)
