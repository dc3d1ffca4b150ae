"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Every test here needs a CUDA card and skips without one; the
check is made inside each test, so every worker collects the same tests.

On a machine with a card (which need not have JAX, whose set-up lives in
tests/conftest.py):

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: f32 within 1e-5 (the kernel's FMA against a separate multiply
and add); bf16 within one bf16 ulp of the larger magnitude.
"""

import pytest
import torch

from jckx_torch.kernels import fused_bn_act as fba
from jckx_torch.models.dcgan import GANGeometry, Generator

pytestmark = pytest.mark.gpu

ACTS = ["relu", "leaky_relu", "none"]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(y, ref):
    assert y.dtype == ref.dtype and y.shape == ref.shape
    a, b = y.float(), ref.float()
    if y.dtype == torch.float32:
        assert (a - b).abs().max().item() <= 1e-5
    else:
        m = torch.maximum(a.abs(), b.abs())
        ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7), torch.zeros_like(m))
        assert bool(((a - b).abs() <= ulp + 1e-5).all())


def _inputs(rows, chans, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, chans, generator=g, device=dev) * 2 + 0.5
    inv = torch.rand(chans, generator=g, device=dev) + 0.5
    shift = torch.randn(chans, generator=g, device=dev)
    return x, inv, shift


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("rows,chans", [(512 * 4 * 4, 512), (8 * 32 * 32, 64), (1000, 3),
                                        (8 * 7 * 7, 100), (1, 1)])
def test_kernel_matches_plain(rows, chans, act, dtype):
    dev = _card()
    x, inv, shift = _inputs(rows, chans, dev)
    x = x.to(getattr(torch, dtype))
    y = fba.normalize_act(x, inv, shift, act, 0.2)
    ref = fba.normalize_act_plain(x, inv, shift, act, 0.2)
    torch.cuda.synchronize()
    _assert_close(y, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_misaligned_rows_take_the_element_path(dtype):
    dev = _card()
    x, inv, shift = _inputs(256, 64, dev, seed=1)
    flat = torch.zeros(x.numel() + 1, device=dev, dtype=getattr(torch, dtype))
    xm = flat[1:].view(256, 64)  # contiguous, but not 16-byte aligned
    xm.copy_(x)
    y = fba.normalize_act(xm, inv, shift, "leaky_relu", 0.2)
    torch.cuda.synchronize()
    _assert_close(y, fba.normalize_act_plain(xm, inv, shift, "leaky_relu", 0.2))


def test_bn_act_launches_once_and_refuses_grad():
    dev = _card()
    x = torch.randn(4, 32, 8, 8, device=dev).to(memory_format=torch.channels_last)
    scale, bias = torch.rand(32, device=dev) + 0.5, torch.randn(32, device=dev)
    before = fba.LAUNCHES
    y = fba.bn_act(x, scale, bias, act="relu")
    assert fba.LAUNCHES == before + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    _assert_close(y, fba.bn_act_plain(x, scale, bias, act="relu"))
    with pytest.raises(RuntimeError, match="not ported yet"):
        fba.bn_act(x, scale.requires_grad_(), bias, act="relu")
    with pytest.raises(ValueError, match="channels_last"):
        fba.bn_act(x.contiguous(), scale.detach(), bias, act="relu")


def test_generator_on_card_matches_cpu():
    dev = _card()
    geo = GANGeometry(z_dim=16, image_size=16, channels=3, base_width=8)
    g = Generator(geo, gen=torch.Generator().manual_seed(0)).requires_grad_(False)
    z = torch.randn(8, geo.z_dim, generator=torch.Generator().manual_seed(1))
    ref = g(z)
    before = fba.LAUNCHES
    got = g.to(dev)(z.to(dev))
    assert fba.LAUNCHES == before + geo.n_up
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
