"""BigGAN's generator (``jckx_torch/models/biggan.py``) on the CPU, at the
benchmark configuration's ``tiny`` size (``portbench/configs/
biggan-128.json``: the same five blocks at 128² with attention at 64², ch
4, 10 classes, shared embedding 8, z 24), float32, against the plain
reference ``portbench/reference/biggan.py`` on its seeded weights (every
bias and the output BN's affine drawn from N(0, 1), |γ| ≥ 1, so that a
wrong index or a left-out attention shows): served through
``GeneratorService.sample``
with labels and a seed, its conditional BN's plain route, its attention's
CPU route, ``load_generator``'s recognition of the file, the published
parameter count, the CLI and the refusals.

Tolerances: the program's f32 output before ``tanh_to_u8`` within 1e-4 of
the reference's (the two sum in other orders, the program takes each
shortcut's 1×1 convolution before the upsampling and folds γ into the
attention's output convolution: 2.4e-5 seen); the uint8 images at most 1
LSB apart (``floor`` maps two values a rounding apart to neighbouring
levels) and at least 99.9 % equal.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from jckx_torch.checkpoint.checkpoint import load_generator
from jckx_torch.kernels import fused_bn_act as fba
from jckx_torch.models.biggan import BigGANGenerator, biggan_geometry
from jckx_torch.ops import attention as attn
from jckx_torch.serve import GeneratorService, get_args, main, serving_mesh
from jckx_torch.utils import spans
from portbench.reference import biggan as ref
from portbench.reference import frozen
from torch_threads import one_torch_thread  # noqa: F401

CONFIG = Path(__file__).resolve().parent.parent / "portbench" / "configs" / "biggan-128.json"
FULL = json.loads(CONFIG.read_text())
TINY = {**FULL, **{k: v for k, v in FULL["tiny"].items() if k != "serve"}}
LABELS = [3, 1, 7, 0, 9, 2]


@pytest.fixture(scope="module")
def weights():
    return ref.make_weights(TINY, 5, torch.device("cpu"))


@pytest.fixture
def ckpt(tmp_path, weights):
    path = str(tmp_path / "biggan.pt")
    ref.write_checkpoint(path, weights)
    return path


def _svc(path, **kw):
    return GeneratorService(path, batch_size=4, compute_dtype=torch.float32, device="cpu", **kw)


def _reference_images(weights, seed, n, labels):
    out = []
    with torch.no_grad():
        for z, ids, take in frozen.request_latents(seed, n, 4, TINY["z_dim"], "cpu", labels):
            onehot = torch.nn.functional.one_hot(ids, TINY["num_classes"]).float()
            out.append(frozen.to_u8(ref.generator(weights, TINY, z, onehot))[:take])
    return torch.cat(out).numpy()


def test_served_images_match_the_reference(ckpt, weights):
    """``sample`` (two batches, labels cycled, a seed) against the
    reference's renders of the same z and labels; before ``tanh_to_u8``,
    the program's f32 output against the reference's."""
    assert abs(float(weights["blocks.3.1.gamma"])) >= 1  # the attention counts
    svc = _svc(ckpt)
    got = svc.sample(8, labels=LABELS, seed=11)
    want = _reference_images(weights, 11, 8, LABELS)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == (8, 128, 128, 3) and got.dtype == np.uint8
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    z, ids, _ = frozen.request_latents(11, 8, 4, TINY["z_dim"], "cpu", LABELS)[0]
    onehot = torch.nn.functional.one_hot(ids, TINY["num_classes"]).float()
    with torch.inference_mode():
        out = svc.G(z, onehot, torch.float32)
    assert (out - ref.generator(weights, TINY, z, onehot)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("up", [1, 2])
def test_conditional_normalize_against_the_reference_cbn(up):
    """``cbn_act``'s plain route, and its CPU route through the registered
    operator (bit for bit the same), against the reference's conditional
    BN and ReLU, relu(x̂ · (1 + g) + b) an affine a sample, upsampled ×2 by
    nearest neighbour where ``up`` is 2 (as a block's first feeds its
    convolution); the once-rounded route within f32 rounding of it."""
    gen = torch.Generator().manual_seed(2)
    x = (torch.randn(6, 16, 8, 8, generator=gen) * 3 + 1).contiguous(
        memory_format=torch.channels_last)
    g, b = torch.randn(6, 16, generator=gen), torch.randn(6, 16, generator=gen)
    want = torch.relu(ref._norm(x, 1e-5) * (1 + g)[:, :, None, None] + b[:, :, None, None])
    want = ref._up2(want) if up == 2 else want
    with torch.no_grad():
        got = fba.cbn_act(x, 1 + g, b, up=up)
        plain = fba.cbn_act_plain(x, 1 + g, b, up=up)
        once = fba.cbn_act_one_rounding(x, 1 + g, b, up=up)
    assert torch.equal(got, plain) and got.is_contiguous(memory_format=torch.channels_last)
    assert (plain - want).abs().max().item() <= 1e-5
    assert (once - want).abs().max().item() <= 1e-5


def test_attention_cpu_route_is_the_materialized_softmax():
    """``ops/attention``'s CPU route: softmax over the pooled positions of
    q kᵀ with no 1/√d, times v, against the same in f64."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, n, d, generator=gen) for n, d in ((64, 3), (16, 3), (16, 12)))
    want = torch.softmax(q.double() @ k.double().transpose(1, 2), dim=-1) @ v.double()
    got = attn.attention(q, k, v)
    assert got.shape == (2, 64, 12) and got.dtype == torch.float32
    assert (got.double() - want).abs().max().item() <= 1e-5


def test_load_generator_recognizes_a_biggan_file(ckpt):
    """The family, geometry and classes from the weights alone, at the tiny
    size loaded and at the published one read from shapes on meta."""
    lg = load_generator(ckpt)
    assert isinstance(lg.G, BigGANGenerator) and lg.conditional and lg.num_classes == 10
    geo = lg.geo
    assert (geo.z_dim, geo.image_size, geo.channels, geo.base_width, geo.shared_dim,
            geo.attention) == (24, 128, 3, 4, 8, 64)
    with torch.device("meta"):
        sd = BigGANGenerator().state_dict()
    geo, classes = biggan_geometry(sd)
    assert (geo.z_dim, geo.image_size, geo.base_width, geo.attention, classes) == (
        120, 128, 96, 64, 1000)
    assert biggan_geometry({"conv1.weight": torch.zeros(1)}) is None
    with pytest.raises(ValueError, match="contradict"):
        load_generator(ckpt, num_classes=100)


def test_the_published_parameter_count():
    """G at the published widths on meta: 70,448,772 parameters, the
    reference's names and shapes, and one σ buffer an SN'd layer."""
    with torch.device("meta"):
        g = BigGANGenerator()
    shapes = ref.param_shapes(FULL)["g"]
    assert sum(p.numel() for p in g.parameters()) == FULL["params"]["g"] == 70_448_772
    assert {k: tuple(p.shape) for k, p in g.named_parameters()} == shapes
    assert {k for k, _ in g.named_buffers()} == {f"{k}.sv0" for k in ref.sn_layers(FULL)}


@pytest.mark.parametrize("refused", ["quant", "subpixel", "mesh", "export"])
def test_what_biggan_has_no_form_for_is_refused(ckpt, tmp_path, refused):
    if refused == "export":
        from jckx_torch.export import export_generator

        with pytest.raises(ValueError, match="BigGAN"):
            export_generator(ckpt, str(tmp_path / "g.pt2"), batch_size=4,
                             compute_dtype=torch.float32, device="cpu")
        return
    kw = {"quant": {"quant": "int8"}, "subpixel": {"subpixel": True},
          "mesh": {"mesh": serving_mesh("2", "cpu")}}[refused]
    if refused == "mesh":
        with pytest.raises(ValueError, match="BigGAN"):
            GeneratorService(ckpt, batch_size=4, compute_dtype=torch.float32, **kw)
        return
    with pytest.raises(ValueError, match="BigGAN"):
        _svc(ckpt, **kw)


def test_truncation_interpolation_and_the_cli(ckpt, tmp_path, capsys):
    """Truncated z, a walk between two classes (a lerp of one-hots is a lerp
    of embeddings) and ``python -m jckx_torch.serve --ckpt <biggan.pt>``."""
    svc = _svc(ckpt, truncation=0.5)
    a, b = svc.sample(4, labels=[2], seed=1), svc.sample(4, labels=[2], seed=1)
    assert np.array_equal(a, b) and a.shape == (4, 128, 128, 3)
    walk = svc.interpolate(1, 2, steps=4, label_a=0, label_b=9)
    assert walk.shape == (4, 128, 128, 3)
    out = tmp_path / "s.png"
    main(get_args(["--ckpt", ckpt, "-n", "6", "--batch_size", "4", "--device", "cpu",
                   "--labels", "1,2", "-o", str(out)]))
    assert out.stat().st_size > 0 and "wrote 6 samples" in capsys.readouterr().out


def test_spans_of_an_eager_render(ckpt):
    """Under a profiler an eager render records ``biggan.block`` for each of
    the five blocks (``n`` its output's rows) and ``biggan.attention``
    once (``n`` images)."""
    from torch.profiler import ProfilerActivity, profile

    svc = _svc(ckpt)
    z = torch.randn(4, 24, generator=torch.Generator().manual_seed(4))
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        svc.render(z, torch.tensor([0, 1, 2, 3]))
    got = [(s.name, s.n) for s in spans.recorded() if "biggan" in s.name]
    assert got == [(spans.PREFIX + "biggan.block", 4 * s * s) for s in (8, 16, 32, 64)] + [
        (spans.PREFIX + "biggan.attention", 4), (spans.PREFIX + "biggan.block", 4 * 128 * 128)]


def test_the_residual_sum_adds_the_upsampled_shortcut():
    """``jckx_torch::up2_add_``'s CPU route (the kernel's plain version):
    y += the nearest ×2 upsampling of s, in place, channels_last."""
    from jckx_torch.kernels.up2_add import up2_add_op

    gen = torch.Generator().manual_seed(8)
    y = torch.randn(2, 5, 6, 8, generator=gen).contiguous(memory_format=torch.channels_last)
    s = torch.randn(2, 5, 3, 4, generator=gen).contiguous(memory_format=torch.channels_last)
    want = y + torch.nn.functional.interpolate(s, scale_factor=2, mode="nearest")
    up2_add_op(y, s)
    assert torch.equal(y, want) and y.is_contiguous(memory_format=torch.channels_last)
