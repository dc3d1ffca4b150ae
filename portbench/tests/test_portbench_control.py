"""The control, the plain reference computed in float8 in the program's
place (in every step, or in a training cell's replayed steps alone), and
the half batch in the replayed steps, come out as not correct: on the card
at each cell's own size, three seeds, against the cell's own limits
(``gpu``, skipped without a card); on the CPU, the float8 rounding itself,
to the second order the penalty needs."""

import time

import pytest
import torch

from portbench import core
from portbench.reference import gan

SPEC = core.load_json(core.ROOT.parent / "BENCHMARK.json")


def _cases():
    """(cell, precision, fault, from_step): the control in every step, and
    for cells whose traffic kind has replayed steps (its ``REPLAYED_STEPS``)
    the control and the half batch in the replayed steps alone."""
    for w in SPEC["workloads"]:
        yield w["name"], "fp8", "", 0
        if core.traffic(w["traffic"]).REPLAYED_STEPS:
            yield w["name"], "fp8", "", 1
            yield w["name"], "f32", "half", 1


@pytest.mark.gpu
@pytest.mark.parametrize("cell,precision,fault,from_step", list(_cases()))
def test_the_control_is_not_correct_at_the_cells_size(cell, precision, fault, from_step):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ctx = core.Context(cell, seed, 20.0, False, "cuda:0", time.perf_counter())
        try:
            mod = core.traffic(ctx.workload["traffic"])
            extra = {"from_step": from_step} if from_step else {}
            got = mod.readings(ctx, precision, fault, **extra)
        finally:
            ctx.close()
        over = {k: got[k] for k, lim in ctx.workload["limits"].items() if got[k] > lim}
        assert over, f"{cell} seed {seed}: the control passes every limit: {got}"


def test_float8_rounding_forward_and_backward():
    x = torch.linspace(-3.0, 5.0, 97, dtype=torch.float32, requires_grad=True)
    y = gan._q(x, "fp8")
    scale = 5.0 / 448.0
    assert torch.equal(y.detach(), (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale)
    assert (y.detach() - x.detach()).abs().max() <= 5.0 * 2 ** -4
    (g,) = torch.autograd.grad((y * y).sum(), x, create_graph=True)
    assert torch.equal(g.detach(), gan._round(2 * y.detach(), torch.float8_e5m2))
    (gg,) = torch.autograd.grad(g.sum(), x)  # the penalty's double backward runs through it
    assert torch.isfinite(gg).all() and gg.abs().sum() > 0
    assert gan._q(x, "f32") is x


def test_the_control_reads_above_the_program_on_the_cpu(tiny_root):
    """At a tiny size the float8 renders stand far from the reference where
    the program's bfloat16 ones do not (the cells' own limits hold at their
    size, on the card)."""
    from conftest import run_tiny

    line, _ = run_tiny(tiny_root, "cgan-64.serve-bulk")
    ctx = core.Context("cgan-64.serve-bulk", 2 ** 31 + 17, 0.5, False, "cpu",
                       time.perf_counter(), tiny_root)
    try:
        control = core.traffic("serve_bulk").readings(ctx, "fp8")
    finally:
        ctx.close()
    assert control["worst_image_lsb"] > 5 * line["checks"]["worst_image_lsb"]["value"]
    assert control["mean_lsb"] > 5 * line["checks"]["mean_lsb"]["value"]
