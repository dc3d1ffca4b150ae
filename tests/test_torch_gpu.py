"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card, at the shapes of serving, training and CGAN's eval chunks.
Every test here needs a CUDA card and skips without one; the check is made
inside each test, so every worker collects the same tests.

On a machine with a card (which need not have JAX, whose set-up lives in
tests/conftest.py):

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: f32 within 1e-5 (the kernel's FMA against a separate multiply
and add); bf16 within one bf16 ulp of the larger magnitude. The int8
convolution's ``torch._int_mm`` route: int32 bit-identical to the exact f64
route. Whole renders (float, sub-pixel, int8): bit-identical to the plain
route whose multiply-add is rounded once, within 1 LSB of ``bn_act_plain``.
The BN statistics' moments kernels: within twice the plain route's error
against f64 sums of the same x (plus one f32 epsilon of the magnitude), the
same bits on every call. The fine-tune's BN + ReLU backward kernels: against
autograd through the plain route rounded once (the kernels' ReLU mask), dx
within one ulp of its dtype plus 1e-3 of its largest magnitude, dgamma /
dbeta within 1e-3 of theirs; against jckx's twice-rounded mask, the same
except on the few elements where the masks differ.
"""

import pytest
import torch

from jckx_torch.kernels import fused_bn_act as fba
from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator

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
                                        (8 * 7 * 7, 100), (1, 1),
                                        (512 * 8 * 8, 256), (512 * 16 * 16, 128),
                                        (512 * 32 * 32, 64), (64 * 4 * 4, 512),
                                        (64 * 8 * 8, 256), (64 * 16 * 16, 128),
                                        (64 * 32 * 32, 64)])
def test_kernel_matches_plain(rows, chans, act, dtype):
    dev = _card()
    x, inv, shift = _inputs(rows, chans, dev)
    x = x.to(getattr(torch, dtype))
    y = fba.normalize_act(x, inv, shift, act, 0.2)
    ref = fba.normalize_act_plain(x, inv, shift, act, 0.2)
    torch.cuda.synchronize()
    _assert_close(y, ref)


@pytest.mark.parametrize("spatial,chans", [(4, 512), (8, 256), (16, 128), (32, 64)])
def test_kernel_at_the_cgan_eval_chunk_shapes(spatial, chans):
    """G's four BN layers at the CGAN trainer's eval chunk of 500 rows of
    z: 8,000 to 512,000 rows."""
    dev = _card()
    x32, inv, shift = _inputs(500 * spatial * spatial, chans, dev, seed=spatial)
    for dtype in (torch.float32, torch.bfloat16):
        for act in ACTS:
            x = x32.to(dtype)
            y = fba.normalize_act(x, inv, shift, act, 0.2)
            torch.cuda.synchronize()
            _assert_close(y, fba.normalize_act_plain(x, inv, shift, act, 0.2))


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


# the moments kernels (csrc/bn_moments.cu): G's four BN layers at the bs512
# bf16 serving shapes, the int8 sampler's f32 at the CGAN eval chunk's
# largest layer, C of 24 and 100 (the vector path, and bf16's element path)
MOMENTS_SHAPES = [(512 * 4 * 4, 512, "bfloat16"), (512 * 8 * 8, 256, "bfloat16"),
                  (512 * 16 * 16, 128, "bfloat16"), (512 * 32 * 32, 64, "bfloat16"),
                  (500 * 32 * 32, 64, "float32"), (4096, 24, "bfloat16"), (4096, 24, "float32"),
                  (50000, 100, "bfloat16"), (50000, 100, "float32")]


def _moments_error(sums, x):
    """The largest error of (2, C) f32 sums against f64 sums of the same x,
    each relative to its channel's Σ|x| or Σx² (so every channel counts)."""
    xd = x.double()
    ref = torch.stack([xd.sum(0), (xd * xd).sum(0)])
    scale = torch.stack([xd.abs().sum(0), (xd * xd).sum(0)]).clamp_min(1e-300)
    return ((sums.double() - ref).abs() / scale).max().item()


def _check_moments(x):
    """The kernels' sums within twice the plain route's error against f64
    (both are f32 sums of the same values in other orders; the kernel's
    sums are shorter runs combined in a tree, so they should not be worse;
    one f32 epsilon of the magnitude beside it, for a shape where the plain
    sum happens to round to the exact value), and the same bits twice."""
    before = fba.MOMENTS_LAUNCHES
    got = fba.bn_moments(x)
    again = fba.bn_moments(x)
    plain = fba.bn_moments_plain(x)
    torch.cuda.synchronize()
    assert fba.MOMENTS_LAUNCHES == before + 4
    assert got.dtype == torch.float32 and got.shape == (2, x.shape[1])
    assert torch.equal(got, again)
    err, err_plain = _moments_error(got, x), _moments_error(plain, x)
    assert err <= 2 * err_plain + 2.0 ** -24, (err, err_plain)
    return err, err_plain


@pytest.mark.parametrize("rows,chans,dtype", MOMENTS_SHAPES)
def test_moments_kernel_against_f64(rows, chans, dtype):
    dev = _card()
    x, _, _ = _inputs(rows, chans, dev, seed=rows % 97)
    _check_moments(x.to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moments_of_misaligned_rows_take_the_element_path(dtype):
    dev = _card()
    x, _, _ = _inputs(4096, 64, dev, seed=2)
    flat = torch.zeros(x.numel() + 1, device=dev, dtype=getattr(torch, dtype))
    xm = flat[1:].view(4096, 64)  # contiguous, but not 16-byte aligned
    xm.copy_(x)
    _check_moments(xm)


def test_moments_wrapper_refuses_on_the_card():
    dev = _card()
    for x in (torch.zeros(64, 8, device=dev, dtype=torch.float16),
              torch.zeros(64, 8, device=dev, dtype=torch.float64),
              torch.zeros(8, 64, device=dev).t(), torch.zeros(0, 8, device=dev),
              torch.zeros(2, 8, 8, device=dev)):
        with pytest.raises(ValueError):
            fba.bn_moments(x)


@pytest.mark.parametrize("batch", [512, 64, 500])  # serving, the DCGAN eval, a CGAN eval chunk
@pytest.mark.parametrize("side,chans", [(4, 512), (8, 256), (16, 128), (32, 64)])
def test_bn_act_launches_the_moments_kernels_where_no_gradient_is_taken(batch, side, chans):
    """One ``bn_act`` without grad at one of G's four bf16 BN layers: one
    normalize launch (``LAUNCHES``) and two moments launches
    (``MOMENTS_LAUNCHES``), each counted once (the profiler's counts of
    both are held in a served replay, below); its channels_last output
    within one bf16 ulp of ``bn_act_plain``'s. With x requiring grad under
    grad mode, neither kernel."""
    dev = _card()
    x = torch.randn(batch, chans, side, side, device=dev).to(torch.bfloat16,
                                                             memory_format=torch.channels_last)
    scale, bias = torch.rand(chans, device=dev) + 0.5, torch.randn(chans, device=dev)
    before = (fba.LAUNCHES, fba.MOMENTS_LAUNCHES)
    with torch.no_grad():
        y = fba.bn_act(x, scale, bias, act="relu")
    assert (fba.LAUNCHES, fba.MOMENTS_LAUNCHES) == (before[0] + 1, before[1] + 2)
    assert y.is_contiguous(memory_format=torch.channels_last)
    _assert_close(y, fba.bn_act_plain(x, scale, bias, act="relu"))
    xs = x.clone().requires_grad_()
    before = (fba.LAUNCHES, fba.MOMENTS_LAUNCHES)
    fba.bn_act(xs, scale, bias, act="relu").float().sum().backward()
    fba.bn_act_plain(xs, scale, bias, act="relu")
    assert (fba.LAUNCHES, fba.MOMENTS_LAUNCHES) == before and xs.grad is not None


# BigGAN-128's ten conditional BN maps (side, channels, upsampling) at ch 96:
# each block's two, the first writing its output upsampled x2
BIGGAN_CBN_MAPS = [(4, 1536, 2), (8, 1536, 1), (8, 1536, 2), (16, 768, 1), (16, 768, 2),
                   (32, 384, 1), (32, 384, 2), (64, 192, 1), (64, 192, 2), (128, 96, 1)]


@pytest.mark.parametrize("side,chans,up", BIGGAN_CBN_MAPS)
def test_conditional_bn_kernel_at_biggans_maps(side, chans, up):
    """``cbn_act`` without grad at one of BigGAN-128's conditional maps, bs256
    bf16 (an affine a sample, (256, C)), upsampled where G upsamples it:
    bit for bit the plain route with its multiply-add rounded once
    (``cbn_act_one_rounding``, which takes the same statistics kernels'
    sums), within one bf16 ulp of ``cbn_act_plain``, and channels_last."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(side + chans)
    x = (torch.randn(256, chans, side, side, generator=g, device=dev) * 2 + 0.5).to(
        torch.bfloat16, memory_format=torch.channels_last)
    scale = torch.randn(256, chans, generator=g, device=dev) + 1.0
    bias = torch.randn(256, chans, generator=g, device=dev)
    with torch.no_grad():
        y = fba.cbn_act(x, scale, bias, up=up)
        want = fba.cbn_act_one_rounding(x, scale, bias, up=up)
        plain = fba.cbn_act_plain(x, scale, bias, up=up)
    torch.cuda.synchronize()
    assert y.shape == (256, chans, up * side, up * side)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, want)
    _assert_close(y, plain)


@pytest.mark.parametrize("up", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("samples,height,width,chans", [(256, 4, 4, 1536), (7, 3, 3, 3),
                                                        (3, 5, 1, 100), (70000, 1, 1, 8)])
def test_conditional_normalize_matches_plain(samples, height, width, chans, dtype, up):
    """The conditional normalize kernel alone, vector and element paths
    (C = 3, 100), more samples than a grid's rows (70,000), with and
    without the ×2 upsampling of each sample's map: within the per-channel
    kernel's tolerance of ``cbn_normalize_act_plain``."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(height * width)
    rows = samples * height * width
    x = (torch.randn(rows, chans, generator=g, device=dev) * 2 + 0.5).to(getattr(torch, dtype))
    inv = torch.rand(samples, chans, generator=g, device=dev) + 0.5
    shift = torch.randn(samples, chans, generator=g, device=dev)
    y = fba.cbn_normalize_act(x, inv, shift, width, up)
    torch.cuda.synchronize()
    assert y.shape == (rows * up * up, chans)
    _assert_close(y, fba.cbn_normalize_act_plain(x, inv, shift, width, up))


def test_conditional_normalize_refuses_on_the_card():
    dev = _card()
    x, inv = torch.zeros(64, 8, device=dev), torch.zeros(4, 8, device=dev)
    for args in ((x.half(), inv, inv), (x, inv[:, :4], inv), (x, inv.double(), inv),
                 (x, torch.zeros(3, 8, device=dev), torch.zeros(3, 8, device=dev)),
                 (x.t(), inv, inv), (x, inv, inv.t().contiguous().t())):
        with pytest.raises(ValueError):
            fba.cbn_normalize_act(*args)
    for width, up in ((3, 1), (4, 3), (0, 2)):  # 16 rows a sample: 3 does not divide them
        with pytest.raises(ValueError):
            fba.cbn_normalize_act(x, inv, inv, width, up)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,chans,side", [(256, 1536, 4), (256, 768, 8), (256, 384, 16),
                                          (256, 192, 32), (256, 96, 64), (5, 3, 7), (3, 100, 2)])
def test_the_residual_sum_kernel_matches_plain(n, chans, side, dtype):
    """``up2_add_`` (y += the nearest ×2 upsampling of s, in place) at
    BigGAN-128's five shortcut sums at bs256 and on the element path (C =
    3, 100): bit for bit its plain version, a sum in f32 rounded once."""
    from jckx_torch.kernels.up2_add import up2_add_, up2_add_plain_

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(chans)
    cl = torch.channels_last
    y = torch.randn(n, chans, 2 * side, 2 * side, generator=g, device=dev).to(
        getattr(torch, dtype), memory_format=cl)
    s = torch.randn(n, chans, side, side, generator=g, device=dev).to(
        getattr(torch, dtype), memory_format=cl)
    want = y.clone()
    up2_add_plain_(want, s)
    up2_add_(y, s)
    torch.cuda.synchronize()
    assert torch.equal(y, want) and y.is_contiguous(memory_format=cl)
    with pytest.raises(ValueError):
        up2_add_(y, s.contiguous())


def test_biggan_attention_route_matches_plain():
    """``ops/attention.attention`` on the card at BigGAN-128's widths (4096
    positions against 1024 pooled, q and k 24 wide, v 96), batch 8, bf16,
    no 1/√d: within 2 % of the largest output of the f32 plain route (the
    fused kernel's probabilities round to bf16 before the product with v).
    The route's kernel is named in a profiled replay, at the end of this
    file (a profiler opened early in the process can make a later test's
    profiler miss records)."""
    from jckx_torch.ops import attention as attn

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    q, k = (torch.randn(8, n, 24, generator=g, device=dev).to(torch.bfloat16) * 0.5
            for n in (4096, 1024))
    v = torch.randn(8, 1024, 96, generator=g, device=dev).to(torch.bfloat16)
    y = attn.attention(q, k, v)
    want = attn.attention_plain(q, k, v).float()
    assert y.shape == (8, 4096, 96) and y.dtype == torch.bfloat16
    assert (y.float() - want).abs().max().item() <= 0.02 * want.abs().max().item()


def test_bn_act_launches_once_and_refuses_grad():
    """Without grad, bn_act launches the kernel once; with an input that
    requires grad under grad mode it takes the plain composition instead
    (no launch), which is what the train step differentiates to second
    order: its double backward on the card matches the CPU's."""
    dev = _card()
    x = torch.randn(4, 32, 8, 8, device=dev).to(memory_format=torch.channels_last)
    scale, bias = torch.rand(32, device=dev) + 0.5, torch.randn(32, device=dev)
    before = fba.LAUNCHES
    y = fba.bn_act(x, scale, bias, act="relu")
    assert fba.LAUNCHES == before + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    _assert_close(y, fba.bn_act_plain(x, scale, bias, act="relu"))
    with torch.no_grad():  # no grad mode: the kernel again
        fba.bn_act(x, scale.clone().requires_grad_(), bias, act="relu")
    assert fba.LAUNCHES == before + 2
    with pytest.raises(ValueError, match="channels_last"):
        fba.bn_act(x.contiguous(), scale, bias, act="relu")

    w = torch.randn(x.shape, device=dev)

    def grads(device):
        xs, s, b = (t.to(device).clone().requires_grad_() for t in (x, scale, bias))
        out = fba.bn_act(xs, s, b, act="relu")
        assert out.requires_grad
        (gx,) = torch.autograd.grad((out * w.to(device)).sum(), xs, create_graph=True)
        gx.square().sum().backward()  # double backward, as the gradient penalty takes it
        return [t.grad.cpu() for t in (xs, s, b)]

    on_card, on_cpu = grads(dev), grads(torch.device("cpu"))
    assert fba.LAUNCHES == before + 2
    for a, b in zip(on_card, on_cpu):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()) + 1e-6)


@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("fused_prop", [0, 1])
def test_train_step_on_card_matches_cpu(deterministic_cudnn, fused_prop, conditional):
    """The tiny train step (16², width 8, batch 8, f32, TF32 off, cuDNN
    deterministic), faithful and FusedProp, DCGAN and CGAN (K = 10, its four
    dropout masks), on the card against the CPU, from the same weights,
    draws and labels: telemetry within 3e-3 (FusedProp: ``d_gz2 ==
    d_gz1``); Adam's deltas within 5 % of lr where the CPU's gradient clears
    1 % of its leaf's maximum (elsewhere the sign of a first Adam step is
    rounding noise, tests/test_step_torch_parity.py:22-35); and no kernel
    launch. cuDNN's default algorithms sum in an order that changes from run
    to run: at full width one masked delta of CGAN's ``G.norm1.weight``
    changed sign in 2 of 7 such runs on an H100, in none of 3 with
    deterministic algorithms."""
    from jckx_torch.configs import Config
    from jckx_torch.data.pipeline import one_hot
    from jckx_torch.models.cgan import HIDDEN, CDiscriminator, CGenerator
    from jckx_torch.train.state import create_dcgan_state
    from jckx_torch.train.steps import StepDraws, make_cgan_train_step, make_dcgan_train_step

    dev = _card()
    geo = GANGeometry(z_dim=16, image_size=16, channels=3, base_width=8)
    cfg = Config()
    cfg.compute_dtype, cfg.max_learning_rate, cfg.fused_prop = "float32", 2e-4, fused_prop
    g = torch.Generator().manual_seed(5)
    draws = [torch.randn(8, 16, 16, 3, generator=g), torch.randn(8, 16, generator=g),
             torch.randn(8, 16, 16, 3, generator=g), torch.rand(8, 1, 1, 1, generator=g)]
    real = torch.rand(8, 16, 16, 3, generator=g) * 2 - 1
    if conditional:
        draws += [(torch.rand(8, HIDDEN, generator=g) < 0.75).float() for _ in range(4)]
        labels = (one_hot(torch.randint(0, 10, (8,), generator=g), 10),)
    out = []
    for device in (torch.device("cpu"), dev):
        gen = torch.Generator().manual_seed(0)
        if conditional:
            G, D = CGenerator(geo, 10, gen=gen), CDiscriminator(geo, 10, gen=gen)
            step, extra = make_cgan_train_step(cfg, geo), tuple(t.to(device) for t in labels)
        else:
            G, D = Generator(geo, gen=gen), Discriminator(geo, gen=gen)
            step, extra = make_dcgan_train_step(cfg, geo), ()
        nets = {"G.": G, "D.": D}
        p0 = {p + k: v.clone() for p, net in nets.items() for k, v in net.named_parameters()}
        state = create_dcgan_state(cfg, G.to(device), D.to(device))
        before = fba.LAUNCHES
        m = step(state, real.to(device), *extra, StepDraws(*(d.to(device) for d in draws)))
        assert fba.LAUNCHES == before
        out.append(({k: float(v) for k, v in m.items()},
                    {p + k: (v.detach().cpu() - p0[p + k], v.grad.cpu())
                     for p, net in nets.items() for k, v in net.named_parameters()}))
    (m_cpu, p_cpu), (m_card, p_card) = out
    for k in m_cpu:
        assert abs(m_cpu[k] - m_card[k]) <= 3e-3, k
    if fused_prop:
        assert m_card["d_gz1"] == m_card["d_gz2"]
    covered = total = 0
    for k, (d_cpu, g_cpu) in p_cpu.items():
        mask = g_cpu.abs() > 1e-2 * g_cpu.abs().max() + 1e-12
        covered, total = covered + int(mask.sum()), total + mask.numel()
        torch.testing.assert_close(p_card[k][0][mask], d_cpu[mask], rtol=0, atol=0.05 * 2e-4, msg=k)
    assert covered / total > 0.5


def test_eval_sampling_launches_four_per_g_forward(tmp_path):
    """The trainer at 64² (four G BN layers) on the card: its eval sample
    launches the kernel 4 times, its train steps never, and its images in
    uint8 match the plain route within 1 LSB, >= 99.9 % exactly."""
    import numpy as np

    from jckx_torch.configs import Config
    from jckx_torch.serve import tanh_to_u8
    from jckx_torch.train.gan_trainer import DCGANTrainer

    _card()
    cfg = Config()
    for k, v in dict(dataset="synthetic", batch_size=8, epoch=1, base_width=8,
                     max_learning_rate=2e-4, log_every=2, eval_every=0, log_file=0,
                     save_root=str(tmp_path), data_dir=str(tmp_path / "data"),
                     save_path=str(tmp_path / "run")).items():
        setattr(cfg, k, v)

    class Data:
        images_u8 = np.random.RandomState(0).randint(0, 256, (16, 32, 32, 3), np.uint8)
        labels_np = np.zeros(16, np.int32)
        num_classes = 10
        metric_source = (images_u8, labels_np)

    geo = GANGeometry(z_dim=100, image_size=64, channels=3, base_width=8)
    gen = torch.Generator().manual_seed(0)
    tr = DCGANTrainer(cfg, Generator(geo, gen=gen), Discriminator(geo, gen=gen), Data())
    before = fba.LAUNCHES
    last = tr.train()  # 2 steps, no eval
    assert fba.LAUNCHES == before and tr.state.step == 2 and np.isfinite(last["loss_d"])
    fake = tr.sample_eval()
    torch.cuda.synchronize()
    assert fba.LAUNCHES == before + 4
    assert fake.shape == (64, 64, 64, 3) and fake.dtype == torch.bfloat16
    assert torch.isfinite(fake.float()).all()
    ref = _with_bn(fba.bn_act_plain, tr.sample_eval)
    diff = (tanh_to_u8(fake).int() - tanh_to_u8(ref).int()).abs()
    assert diff.max().item() <= 1 and (diff == 0).float().mean().item() >= 0.999


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


def test_cgan_served_images_match_the_plain_route(tmp_path, monkeypatch):
    """A CGAN checkpoint at 64² (width 8, K = 100) served on the card with
    labels: 4 launches per batch; a labelled request equals the render of
    its z with the labels' one-hots; uint8 within 1 LSB of the plain route,
    and equal to the plain route whose multiply-add is rounded once, as the
    kernel's FMA rounds it (the share of exactly equal pixels against the
    twice-rounded route depends on the weights: ROADMAP C). Under
    ``no_grad`` on the card both references take their sums from the
    moments kernels, as the served route does; so the render is also held
    within 1 LSB of the plain route with the plain sums
    (``bn_moments_plain``), which shares no code with the kernels."""
    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.serve import GeneratorService, _request_seed

    dev = _card()
    geo = GANGeometry(z_dim=100, image_size=64, channels=3, base_width=8)
    gen = torch.Generator().manual_seed(0)
    g, d = CGenerator(geo, 100, gen=gen), CDiscriminator(geo, 100, gen=gen)
    path = str(tmp_path / "cgan.pt")
    torch.save({"model_g": g.state_dict(), "model_d": d.state_dict()}, path)
    svc = GeneratorService(path, batch_size=64)
    assert svc.conditional and svc.device.type == "cuda"
    before = fba.LAUNCHES
    imgs = svc.sample(70, labels=[3, 17, 42], seed=4)  # two batches of 64
    assert fba.LAUNCHES == before + 8 and imgs.shape == (70, 64, 64, 3)

    g_seed = torch.Generator(device=dev).manual_seed(_request_seed(4, 0))
    z = torch.randn((64, 100), generator=g_seed, device=dev)
    lab = torch.tensor([[3, 17, 42][i % 3] for i in range(64)], device=dev)
    got = svc.render(z, lab)
    assert (got.cpu().numpy() == imgs[:64]).all()
    refs = [_with_bn(bn, lambda: svc.render(z, lab))
            for bn in (fba.bn_act_plain, fba.bn_act_one_rounding)]
    assert (got.int() - refs[0].int()).abs().max().item() <= 1
    assert torch.equal(got, refs[1])
    monkeypatch.setattr(fba, "bn_moments_op", fba.bn_moments_plain)
    before = fba.MOMENTS_LAUNCHES
    apart = _with_bn(fba.bn_act_plain, lambda: svc.render(z, lab))
    assert fba.MOMENTS_LAUNCHES == before
    assert (got.int() - apart.int()).abs().max().item() <= 1



def _with_bn(bn, render):
    """``render()`` with every BN layer of G's float and int8 forwards
    routed through ``bn``, and every graphed program (``utils/graphs.py``)
    run eagerly meanwhile: a replay would not see the swap."""
    import jckx_torch.models.dcgan as tdcgan
    import jckx_torch.ops.quant as tquant
    from jckx_torch.utils.graphs import GraphedProgram

    call = GraphedProgram.__call__
    tdcgan.bn_act = tquant.bn_act = bn
    GraphedProgram.__call__ = lambda self, *args: self.fn(*args)
    try:
        return render()
    finally:
        tdcgan.bn_act = tquant.bn_act = fba.bn_act
        GraphedProgram.__call__ = call


@pytest.mark.parametrize("batch", [64, 512])  # the artifact's batch, serving's
@pytest.mark.parametrize("in_dim", [100, 200])
def test_int_mm_route_is_exact_on_the_card(in_dim, batch, monkeypatch):
    """Every G layer at 64², base width 64 (batch 64 and 512): the card's
    im2col + ``_int_mm`` route gives the exact f64 route's int32, bit for
    bit."""
    import jckx_torch.ops.quant as tquant

    dev = _card()
    calls = []
    real = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm", lambda a, b: (calls.append(a.shape), real(a, b))[1])
    g = torch.Generator(device=dev).manual_seed(in_dim)
    layers = [(in_dim, 512, 1, 1, 0), (512, 256, 4, 2, 1), (256, 128, 8, 2, 1),
              (128, 64, 16, 2, 1), (64, 3, 32, 2, 1)]
    for cin, cout, hw, stride, pad in layers:
        x = torch.randint(-127, 128, (batch, cin, hw, hw), generator=g, device=dev,
                          dtype=torch.int8).contiguous(memory_format=torch.channels_last)
        w = torch.randint(-127, 128, (cin, cout, 4, 4), generator=g, device=dev, dtype=torch.int8)
        got = tquant.conv_transpose2d_int8(x, w, stride, pad)
        want = tquant.conv_transpose2d_int8_exact(x, w, stride, pad)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want), (cin, cout, hw)
    assert len(calls) == 1 + 4 * 4  # one product for the 1x1 layer, four phases for the others


def _gan_ckpt(path, conditional, base_width=8):
    from jckx_torch.models.cgan import CDiscriminator, CGenerator

    geo = GANGeometry(z_dim=100, image_size=64, channels=3, base_width=base_width)
    gen = torch.Generator().manual_seed(0)
    if conditional:
        g, d = CGenerator(geo, 100, gen=gen), CDiscriminator(geo, 100, gen=gen)
    else:
        g, d = Generator(geo, gen=gen), Discriminator(geo, gen=gen)
    torch.save({"model_g": g.state_dict(), "model_d": d.state_dict()}, path)
    return path


@pytest.mark.parametrize("conditional", [False, True])
def test_int8_serving_matches_the_once_rounded_route(tmp_path, conditional):
    """int8 serving at 64² (width 8, batch 64) on the card: 4 f32 kernel
    launches per batch, renders bit-identical to the same int8 forward with
    ``bn_act_one_rounding``. Against ``bn_act_plain`` within 4 LSB on all
    but 1 % of the pixels: a one-ulp difference at a quantization boundary
    flips an int8 activation by a step (chip_smoke.py counts the flips)."""
    from jckx_torch.serve import GeneratorService

    dev = _card()
    svc = GeneratorService(_gan_ckpt(str(tmp_path / "g.pt"), conditional), batch_size=64,
                           quant="int8")
    labels = [3, 17, 42] if conditional else None
    before = fba.LAUNCHES
    imgs = svc.sample(70, labels=labels, seed=4)  # two batches
    assert fba.LAUNCHES == before + 8 and imgs.shape == (70, 64, 64, 3)
    g = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn(64, 100, generator=g, device=dev)
    lab = torch.randint(0, 100, (64,), generator=g, device=dev) if conditional else None
    args = (z, lab) if conditional else (z,)
    got = svc.render(*args)
    plain = _with_bn(fba.bn_act_plain, lambda: svc.render(*args))
    once = _with_bn(fba.bn_act_one_rounding, lambda: svc.render(*args))
    diff = (got.int() - plain.int()).abs()
    assert diff.max().item() <= 4 and (diff == 0).float().mean().item() >= 0.99
    assert torch.equal(got, once)


def test_subpixel_sampler_on_the_card(tmp_path):
    """The sub-pixel sampler at 64² (width 8, batch 64): in f32 (TF32 off)
    within 1 LSB of the default sampler on the same z (tests/test_serve.py:
    67-78); in bf16 bit-identical to its once-rounded route; 4 launches."""
    from jckx_torch.serve import GeneratorService

    dev = _card()
    path = _gan_ckpt(str(tmp_path / "g.pt"), False)
    z = torch.randn(64, 100, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    f32 = [GeneratorService(path, batch_size=64, compute_dtype=torch.float32, subpixel=s).render(z)
           for s in (False, True)]
    assert (f32[0].int() - f32[1].int()).abs().max().item() <= 1
    sub = GeneratorService(path, batch_size=64, subpixel=True)
    before = fba.LAUNCHES
    got = sub.render(z)
    assert fba.LAUNCHES == before + 4
    assert torch.equal(got, _with_bn(fba.bn_act_one_rounding, lambda: sub.render(z)))


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("conditional", [False, True])
def test_artifact_on_the_card_takes_the_kernel(tmp_path, conditional, quant):
    """A ``.pt2`` exported on the card (64², width 8, batch 64, bf16 or
    int8) launches the kernel 4 times per batch through its
    ``jckx_torch::normalize_act`` nodes and renders a seed's z bit for bit
    as the service does; against the plain route within 1 LSB (int8: 4 LSB
    on all but 1 % of the pixels, as the int8 sampler)."""
    from jckx_torch import rng
    from jckx_torch.export import ArtifactService, export_generator, load_exported
    from jckx_torch.serve import GeneratorService

    dev = _card()
    path = _gan_ckpt(str(tmp_path / "g.pt"), conditional)
    info = export_generator(path, str(tmp_path / "g.pt2"), batch_size=64, quant=quant)
    assert info["platforms"] == ["cuda"] and info["quant"] == quant
    sample = load_exported(str(tmp_path / "g.pt2"))
    svc = GeneratorService(path, batch_size=64, quant=quant)
    labels = torch.tensor([[3, 17, 42][i % 3] for i in range(64)], device=dev)
    z = rng.normal_from_seed(5, (64, 100), device=dev)
    args = (z, labels) if conditional else (z,)
    before = fba.LAUNCHES
    got = sample(5, labels.cpu().numpy() if conditional else None)
    assert fba.LAUNCHES == before + 4 and got.device.type == "cuda"
    assert torch.equal(got, svc.render(*args))
    diff = (got.int() - _with_bn(fba.bn_act_plain, lambda: svc.render(*args)).int()).abs()
    if quant is None:
        assert diff.max().item() <= 1
    else:
        assert diff.max().item() <= 4 and (diff == 0).float().mean().item() >= 0.99
    art = ArtifactService(str(tmp_path / "g.pt2"))
    assert art.sample(70, labels=[3, 17, 42] if conditional else None, seed=9).shape == (
        70, 64, 64, 3)


# The most elements, as a share of a map's, whose ReLU mask rounded once (the
# backward kernels') may differ from jckx's, which rounds x·a and + sh apart:
# only where x·a + sh lies within half an f32 ulp of x·a of zero. On an H100
# the test's maps at seeds 0, 1, 2 differ in 2, 0, 2 of 90,935,296 elements in
# f32 (2.2e-8) and in none in bf16; the fine-tune cell's 94 maps a step
# (1,147,838,464 elements, bf16) in none at three seeds.
MASK_SHARE = 1e-7


# the stem map C 32 at 149² in both dtypes; the fine-tune's bf16 at its largest
# stem map, Conv2d_3b's and Conv2d_4a's maps and a Mixed_7c map; a Mixed_5d
# branch's map whose gradient is a channel slice of its block's concatenation
@pytest.mark.parametrize("dtype,chans,side,pad", [
    pytest.param("float32", 32, 149, None, id="float32-32-149"),
    pytest.param("bfloat16", 32, 149, None, id="bfloat16-32-149"),
    pytest.param("bfloat16", 64, 147, None, id="bfloat16-64-147"),
    pytest.param("bfloat16", 448, 8, None, id="bfloat16-448-8"),
    pytest.param("bfloat16", 80, 73, None, id="bfloat16-80-73"),
    pytest.param("bfloat16", 192, 71, None, id="bfloat16-192-71"),
    pytest.param("bfloat16", 96, 35, (128, 64), id="bfloat16-96-35-channel-slice")])
def test_bn_relu_train_on_the_card_matches_its_plain_version(dtype, chans, side, pad,
                                                             monkeypatch):
    """``bn_relu_train`` at fine-tune maps (bs128, 299²: C 32 at 149², 64 at
    147², 80 at 73², 192 at 71², 448 at 8², and Mixed_5d's 96 at 35² as
    channels 128–223 of its block's 288, whose gradient ``torch.cat``'s
    backward hands on as a channel slice): one normalize launch and three of
    the backward's; ``out`` bit-identical to the plain route rounded once;
    statistics equal; the hand-written backward against autograd through
    those plain ops (whose ReLU mask, rounded once, is the kernels'): dx
    within one ulp of its dtype plus 1e-3 of its largest magnitude, dgamma /
    dbeta within 1e-3 of theirs (sums of 2.8 M products in another order).
    Against jckx's twice-rounded route dx is held the same way except where
    the two masks differ (each such element a whole a·dout off), on at most
    ``MASK_SHARE`` of the elements; dgamma / dbeta within 1e-3 there too.
    The kernels read a channel-slice gradient in place, at its row stride,
    and a gradient of another layout (the dense cases' NCHW) from one
    channels_last copy."""
    from jckx_torch.ops.norm import _moments_affine, bn_relu_train, bn_relu_train_plain

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    dt = getattr(torch, dtype)
    x = (torch.randn(128, chans, side, side, generator=g, device=dev) * 2 + 0.5).to(
        dt, memory_format=torch.channels_last)
    scale = torch.rand(chans, generator=g, device=dev) + 0.5
    bias = torch.randn(chans, generator=g, device=dev)
    width = chans + sum(pad or ())
    dout = torch.randn(128, width, side, side, generator=g, device=dev)
    if pad is not None:
        dout = dout.to(dt, memory_format=torch.channels_last)
    lib, seen = fba._bwd_lib(), []

    class Recording:  # what the kernels' entries are handed: the gradient's pointer and row stride
        def __getattr__(self, name):
            def call(*args):
                seen.append((name, args[1], args[2]))
                return getattr(lib, name)(*args)
            return call

    monkeypatch.setattr(fba, "_bwd_lib", Recording)

    def run(fn):
        xx = x.detach().requires_grad_(True)
        s, b = scale.detach().requires_grad_(True), bias.detach().requires_grad_(True)
        out, mean, var = fn(xx, s, b)
        if pad is None:
            (out.float() * dout).sum().backward()
        else:
            zeros = [torch.zeros(128, c, side, side, device=dev, dtype=dt).contiguous(
                memory_format=torch.channels_last) for c in pad]
            torch.cat([zeros[0], out, zeros[1]], 1).backward(dout)
        return out.detach(), mean, var, xx.grad, s.grad, b.grad

    before = fba.launch_counts()
    got = run(bn_relu_train)
    torch.cuda.synchronize()
    assert fba.launch_counts() == (before[0] + 1, before[1], before[2] + 3)
    assert [name for name, *_ in seen] == ["jckx_bn_relu_bwd_sums", "jckx_bn_relu_bwd_dx"]
    if pad is None:
        assert all(stride == chans for *_, stride in seen)
    else:
        ptr = dout[:, pad[0]:pad[0] + chans].data_ptr()
        assert all(p == ptr and stride == width for _, p, stride in seen)
    plain = run(lambda *a: bn_relu_train_plain(*a, one_rounding=True))
    assert torch.equal(got[0], plain[0]) and got[0].is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
    assert got[3].is_contiguous(memory_format=torch.channels_last)
    dx, ref = got[3].float(), plain[3].float()
    m = torch.maximum(dx.abs(), ref.abs())
    ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - (23 if dtype == "float32" else 7)),
                      torch.zeros_like(m))
    assert bool(((dx - ref).abs() <= ulp + 1e-3 * ref.abs().max()).all())
    for a, b in zip(got[4:], plain[4:]):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()
    # jckx's mask rounds x·a and + sh apart: against that route dx is off only
    # where the two masks differ, on at most MASK_SHARE of the elements
    twice = run(bn_relu_train_plain)
    _, _, _, a, sh = _moments_affine(x.float(), scale, bias, 1e-3)
    a, sh = a[:, None, None], sh[:, None, None]
    xf = x.float()
    differ = ((xf.double() * a.double() + sh.double()) > 0) != (xf * a + sh > 0)
    del xf
    ref = twice[3].float()
    m = torch.maximum(dx.abs(), ref.abs())
    ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - (23 if dtype == "float32" else 7)),
                      torch.zeros_like(m))
    off = (dx - ref).abs() > ulp + 1e-3 * ref.abs().max()
    assert not bool((off & ~differ).any())
    assert int(differ.sum()) <= MASK_SHARE * x.numel()
    for a, b in zip(got[4:], twice[4:]):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()
    with pytest.raises(ValueError, match="channels_last"):
        bn_relu_train(x.contiguous(), scale, bias)


def test_forward_train_on_the_card_matches_cpu():
    """One train-mode forward of the backbone at 75², batch 8, f32 (TF32
    off) on the card against the CPU: 94 kernel launches; logits within
    2e-3 of their largest magnitude and the updated running statistics
    within 1e-3 of their layer's largest (the CPU tests' bounds against
    jckx: 94 batch-statistic BN layers amplify f32 sums taken in another
    order)."""
    from jckx_torch.metrics import inception_v3 as tiv

    dev = _card()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 75, 75, 3, generator=g)
    keep = torch.rand(8, 2048, generator=g) < 0.5
    cpu, card = tiv.init(0, num_classes=10), tiv.init(0, num_classes=10).to(dev)
    ref = cpu.forward_train(x, keep)
    before = fba.LAUNCHES
    got = card.forward_train(x.to(dev), keep.to(dev))
    torch.cuda.synchronize()
    assert fba.LAUNCHES == before + 94
    assert (got.cpu() - ref).abs().max() <= 2e-3 * ref.abs().max()
    a, b = tiv.to_jckx_flat(card), tiv.to_jckx_flat(cpu)
    for k in a:
        if k.endswith(("bn_mean", "bn_var")):
            assert abs(a[k] - b[k]).max() <= 1e-3 * abs(b[k]).max(), k


# Mixed_5c's pool input at batch 8; Mixed_5b's at the fine-tune's batch of 128
@pytest.mark.parametrize("batch,chans", [(8, 288), (128, 192)])
def test_branch_pool_backward_on_the_card_matches_cpu(batch, chans):
    """The InceptionV3 branch pool on a channels_last tensor (the fine-tune
    step's layout): forward and backward on the card against the CPU's
    (f32, within 1e-6 relative). The card's ``F.avg_pool2d`` gradient for
    a channels_last input is wrong in torch 2.11.0+cu128; the port's pool
    takes its backward as the pool of the gradient."""
    from jckx_torch.metrics import inception_v3 as tiv

    dev = _card()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(batch, chans, 35, 35, generator=g)
    dy = torch.randn(batch, chans, 35, 35, generator=g)
    out = {}
    for d in ("cpu", dev):
        t = x.to(d).contiguous(memory_format=torch.channels_last).detach().requires_grad_(True)
        y = tiv._avg_pool(t)
        y.backward(dy.to(d))
        out[str(d)] = (y.detach().cpu(), t.grad.cpu())
    (yc, gc), (yg, gg) = out["cpu"], out[str(dev)]
    assert (yg - yc).norm() <= 1e-6 * yc.norm() and (gg - gc).norm() <= 1e-6 * gc.norm()


@pytest.mark.parametrize("route", ["serve", "evaluate"])
@pytest.mark.parametrize("family", ["dcgan", "cgan"])
def test_jckx_checkpoint_renders_through_the_kernel(family, route):
    """The committed jckx fixture (tests/data/jckx_ckpt) on the card in f32,
    served (``GeneratorService``) or rendered by ``evaluate``'s route
    (``load_generator`` + ``make_sampler`` + ``sample_eval_images``): its
    batch of 16 renders through the kernel (2 launches per forward at 16²)
    within 1 LSB of jckx's own renders of the same z."""
    import os

    import numpy as np

    from jckx_torch.checkpoint.checkpoint import load_generator
    from jckx_torch.data.pipeline import one_hot
    from jckx_torch.ops.quant import make_sampler
    from jckx_torch.serve import GeneratorService, tanh_to_u8
    from jckx_torch.train.gan_trainer import sample_eval_images

    dev = _card()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jckx_ckpt")
    z = torch.from_numpy(np.load(os.path.join(root, "z.npy")))
    labels = torch.from_numpy(np.load(os.path.join(root, "cgan_labels.npy")))
    want = tanh_to_u8(torch.from_numpy(np.load(os.path.join(root, f"{family}_renders.npy"))))
    path = os.path.join(root, family, "run", "latest.ckpt")
    cgan = family == "cgan"
    if route == "serve":
        svc = GeneratorService(path, batch_size=16, compute_dtype=torch.float32, device=dev)
        n_up = svc.geo.n_up
        render = lambda: svc.render(z, labels if cgan else None)  # noqa: E731
    else:
        lg = load_generator(path)
        params, apply = make_sampler(lg.G.to(dev), compute_dtype=torch.float32)
        onehot = one_hot(labels, lg.num_classes).to(dev) if cgan else None
        n_up = lg.geo.n_up
        render = lambda: tanh_to_u8(sample_eval_images(  # noqa: E731
            lambda zz, *rest: apply(params, zz, rest[0] if cgan else None), z.to(dev), onehot,
            torch.float32))
    before = fba.LAUNCHES
    got = render().cpu()
    assert fba.LAUNCHES == before + n_up
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1 and (diff == 0).float().mean().item() >= 0.99


def _copy_and_kernel_streams(prof, tmp_path) -> tuple:
    """→ ({stream: [bytes of each host→device copy]}, {stream: {names of
    its kernels}}) from the profiler's Chrome trace."""
    import json

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    copies, kernels = {}, {}
    for e in json.loads(path.read_text())["traceEvents"]:
        args = e.get("args") or {}
        if "stream" not in args:
            continue
        if e.get("cat") == "kernel":
            kernels.setdefault(args["stream"], set()).add(e.get("name", "")[:80])
        elif "memcpy" in e.get("cat", "").lower() and "HtoD" in e.get("name", ""):
            copies.setdefault(args["stream"], []).append(args.get("bytes"))
    return copies, kernels


@pytest.mark.parametrize("conditional", [False, True])
def test_streamed_trainer_on_the_card_equals_resident(tmp_path, monkeypatch, conditional):
    """The tiny trainer (16², width 8, batch 8, f32, K = 2, 6 launches) on
    the card with deterministic algorithms: ``--data_placement stream -w
    2`` ends with the parameters and Adam state of the resident plane, bit
    for bit, and each launch's slab (images and labels) is copied on a
    stream that runs none of the train step's kernels. The first training
    run of a process on an H100 ends up to 7.45e-9 away from every later
    identical run, on either plane and with or without cuDNN or
    deterministic algorithms (later runs are equal), so a resident run
    warms the process up first. Deterministic algorithms are on, without
    filling fresh memory (that would put fill kernels on the copy
    stream)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from jckx_torch.configs import Config
    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.train.gan_trainer import CGANTrainer, DCGANTrainer

    _card()
    rng = np.random.RandomState(0)

    class Data:
        images_u8 = rng.randint(0, 256, (48, 32, 32, 3)).astype(np.uint8)
        labels_np = rng.randint(0, 10, 48).astype(np.int32)
        num_classes = 10
        idx_to_labels = {i: str(i) for i in range(10)}
        metric_source = (images_u8, labels_np)

    geo = GANGeometry(z_dim=100, image_size=16, channels=3, base_width=8)
    finals, deterministic = {}, torch.backends.cudnn.deterministic
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(torch.utils.deterministic, "fill_uninitialized_memory", False)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        for placement in ("warm-up", "hbm", "stream"):
            cfg = Config()
            for k, v in dict(dataset="synthetic", batch_size=8, epoch=2, image_size=16,
                             base_width=8, compute_dtype="float32", max_learning_rate=2e-4,
                             log_every=2, eval_every=0, log_file=0,
                             data_placement="stream" if placement == "stream" else "hbm",
                             num_worker=2, save_root=str(tmp_path), model_path=placement,
                             save_path=str(tmp_path / placement)).items():
                setattr(cfg, k, v)
            gen = torch.Generator().manual_seed(0)
            if conditional:
                tr = CGANTrainer(cfg, CGenerator(geo, 10, gen=gen), CDiscriminator(geo, 10, gen=gen),
                                 Data())
            else:
                tr = DCGANTrainer(cfg, Generator(geo, gen=gen), Discriminator(geo, gen=gen), Data())
            assert tr._streaming is (placement == "stream")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tr.train()
                torch.cuda.synchronize()
            s = tr.state
            finals[placement] = ({**{f"G.{k}": v for k, v in s.G.state_dict().items()},
                                  **{f"D.{k}": v for k, v in s.D.state_dict().items()}},
                                 [s.opt_g.state_dict(), s.opt_d.state_dict()], s.step)
        copies, kernels = _copy_and_kernel_streams(prof, tmp_path)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.use_deterministic_algorithms(False)
    (p_hbm, o_hbm, step_hbm), (p_st, o_st, step_st) = finals["hbm"], finals["stream"]
    assert step_hbm == step_st == 12
    for k in p_hbm:
        assert torch.equal(p_hbm[k], p_st[k]), k
    for a, b in zip(o_hbm, o_st):
        for i, st in a["state"].items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(v), torch.as_tensor(b["state"][i][k])), (i, k)
    slab = [st for st, sizes in copies.items() if 16 * 32 * 32 * 3 in sizes]
    assert len(slab) == 1 and copies[slab[0]].count(16 * 32 * 32 * 3) == 6, copies
    assert 16 * 8 in copies[slab[0]] and slab[0] not in kernels, (copies, kernels)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_bn_act_on_a_local_mesh_matches_unsharded(dtype):
    """Sync-BN over ``[cuda:0, cuda:0]``: each member normalizes its rows
    with the statistics summed over both (the kernel once per member),
    within one ulp of the unsharded call (the sums reassociate)."""
    from jckx_torch.parallel import make_mesh

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(64, 256, 8, 8, generator=g, device=dev) * 2 + 0.5).to(
        getattr(torch, dtype), memory_format=torch.channels_last)
    scale = torch.rand(256, generator=g, device=dev) + 0.5
    bias = torch.randn(256, generator=g, device=dev)
    mesh = make_mesh((2,), devices=[dev, dev])
    with torch.no_grad():
        before = fba.LAUNCHES
        parts = mesh.run(lambda i, d: fba.bn_act(mesh.rows(x), scale, bias, "relu", mesh=mesh))
        torch.cuda.synchronize()
        assert fba.LAUNCHES - before == 2
        ref = fba.bn_act(x, scale, bias, "relu")
        torch.cuda.synchronize()
        assert fba.LAUNCHES - before == 3
    for p in parts:
        assert p.is_contiguous(memory_format=torch.channels_last)
    _assert_close(torch.cat(parts), ref)


@pytest.fixture
def nccl_world_of_one(tmp_path):
    """A one-rank NCCL process group over a file store, and its mesh."""
    import torch.distributed as dist

    from jckx_torch.parallel import make_mesh

    dev = torch.device("cuda", _card().index or 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1,), device=dev), dev
    finally:
        dist.destroy_process_group()


def test_nccl_world_of_one_all_reduce_is_the_identity(nccl_world_of_one):
    mesh, dev = nccl_world_of_one
    assert mesh.distributed and mesh.size == 1
    t = torch.randn(2, 512, device=dev)
    assert torch.equal(mesh.all_reduce(t), t) and torch.equal(mesh.all_gather_rows(t), t)
    leaf = t.clone().requires_grad_(True)
    y = mesh.all_reduce(leaf)
    (g,) = torch.autograd.grad((y * y).sum(), leaf, create_graph=True)
    assert torch.equal(g, 2 * t)
    p = torch.nn.Parameter(torch.zeros(3, device=dev))
    p.grad = torch.tensor([1.0, -2.0, 3.5], device=dev)
    mesh.average_grads([p])
    assert torch.equal(p.grad, torch.tensor([1.0, -2.0, 3.5], device=dev))
    assert mesh.any(True) and not mesh.any(False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sync_bn_relu_train_on_a_world_of_one_equals_the_plain_one(nccl_world_of_one, dtype):
    """``bn_relu_train`` over a one-rank NCCL mesh: its forward (the
    kernel) and its hand-written backward, whose sums pass through the
    all-reduce, equal the call without a mesh bit for bit."""
    from jckx_torch.ops.norm import bn_relu_train

    mesh, dev = nccl_world_of_one
    g = torch.Generator(device=dev).manual_seed(4)
    x0 = torch.randn(16, 64, 15, 15, generator=g, device=dev).to(
        getattr(torch, dtype), memory_format=torch.channels_last)
    dout = torch.randn(16, 64, 15, 15, generator=g, device=dev).to(
        getattr(torch, dtype), memory_format=torch.channels_last)
    scale0 = torch.rand(64, generator=g, device=dev) + 0.5
    bias0 = torch.randn(64, generator=g, device=dev)
    outs = []
    for m in (mesh, None):
        x = x0.clone().requires_grad_(True)
        scale, bias = scale0.clone().requires_grad_(True), bias0.clone().requires_grad_(True)
        out, mean, var = bn_relu_train(x, scale, bias, mesh=m)
        out.backward(dout)
        outs.append((out, mean, var, x.grad, scale.grad, bias.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mesh", [["--devices", "8"],
                                  ["--devices", "2", "--mesh_shape", "1,2", "--mesh_axes",
                                   "data,model", "--model_axis_mode", "spatial"]],
                         ids=["dp8", "spatial"])
def test_plan_on_the_card_reads_its_memory(mesh):
    """A toy ``plan --device cuda``: the memory is the card's allocator's
    (no ``error``), fits, and its peak holds the arguments and the
    temporaries; the fake group is gone afterwards."""
    import torch.distributed as dist

    from jckx_torch.plan import plan

    _card()
    r = plan(["--image_size", "16", "-b", "16", "--base_width", "16", "--tp_min_dim", "16",
              "--device", "cuda", *mesh])
    mem = r["per_chip"]["memory"]
    assert "error" not in mem and mem["fits"], mem
    assert 0 < mem["argument_mb"] <= mem["peak_mb"] < mem["hbm_mb"]
    assert abs(mem["peak_mb"] - mem["argument_mb"] - mem["temp_mb"]) <= 0.16  # each rounded
    assert "CAVEAT" not in r["backend"] and r["per_chip"]["step_flops"] > 0
    assert not dist.is_initialized()


class _TinyData:
    """48 seeded 32² rows, 10 classes: the tiny trainers' resident set."""

    def __init__(self):
        import numpy as np

        rng = np.random.RandomState(0)
        self.images_u8 = rng.randint(0, 256, (48, 32, 32, 3)).astype(np.uint8)
        self.labels_np = rng.randint(0, 10, 48).astype(np.int32)
        self.num_classes = 10
        self.idx_to_labels = {i: str(i) for i in range(10)}
        self.metric_source = (self.images_u8, self.labels_np)


def _tiny_trainer(tmp_path, name, conditional=False, mesh=None, **over):
    """The tiny trainer (16², width 8, batch 8, f32, EMA 0.5, no evals) on
    the card from seed-0 weights, over ``mesh`` if given."""
    from jckx_torch.configs import Config
    from jckx_torch.models.cgan import CDiscriminator, CGenerator
    from jckx_torch.train.gan_trainer import CGANTrainer, DCGANTrainer

    geo = GANGeometry(z_dim=100, image_size=16, channels=3, base_width=8)
    cfg = Config()
    for k, v in dict(dataset="synthetic", batch_size=8, epoch=1, image_size=16, base_width=8,
                     compute_dtype="float32", max_learning_rate=2e-4, ema_decay=0.5,
                     log_every=8, eval_every=0, log_file=0, save_root=str(tmp_path),
                     model_path=name, save_path=str(tmp_path / name), **over).items():
        setattr(cfg, k, v)
    gen = torch.Generator().manual_seed(0)
    if conditional:
        return CGANTrainer(cfg, CGenerator(geo, 10, gen=gen), CDiscriminator(geo, 10, gen=gen),
                           _TinyData(), mesh=mesh)
    return DCGANTrainer(cfg, Generator(geo, gen=gen), Discriminator(geo, gen=gen), _TinyData(),
                        mesh=mesh)


def _trainer_state(tr):
    s = tr.state
    out = {f"{m}.{k}": v for m, net in (("G", s.G), ("D", s.D), ("EMA", s.ema_g))
           for k, v in net.state_dict().items()}
    for name, opt in (("opt_g", s.opt_g), ("opt_d", s.opt_d)):
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()})
    return out


@pytest.fixture
def deterministic_cudnn():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


@pytest.mark.parametrize("mode", ["dcgan", "cgan", "fused_prop", "remat_both", "cosine"])
def test_replayed_gan_steps_equal_eager_steps(tmp_path, deterministic_cudnn, mode):
    """8 steps of the tiny trainer through its superstep (the first eager,
    then captured, 7 replayed under ``set_sync_debug_mode("error")``: no
    host synchronisation inside a replayed step) against 8 eager steps from
    the same weights on the same rows (no launch of the BN + ReLU
    backward's kernels): parameters, Adam's moments and
    counts, the EMA and the telemetry bit for bit, with cuDNN
    deterministic (its default algorithms may sum in another order from
    run to run). A process's first tiny run can end a few ulp from later
    ones (PERF.md §7), so a throwaway run goes first."""
    from jckx_torch.train.superstep import CudaGraph

    _card()
    over = {"cgan": {}, "fused_prop": {"fused_prop": 1}, "remat_both": {"remat": "both"},
            "cosine": {"lr_schedule": "cosine", "min_learning_rate": 5e-5,
                       "lr_decay_steps": 8}}.get(mode, {})
    conditional = mode == "cgan"
    perm = torch.randperm(48, generator=torch.Generator().manual_seed(1)).to("cuda")
    rows = [{"idx": perm[(8 * j) % 48:(8 * j) % 48 + 8]} for j in range(8)]
    warm = _tiny_trainer(tmp_path, "warm", conditional, **over)
    warm.superstep = None
    warm._launch(rows[:2])
    eager = _tiny_trainer(tmp_path, "eager", conditional, **over)
    graphed = _tiny_trainer(tmp_path, "graphed", conditional, **over)
    assert graphed.superstep.graph_cls is CudaGraph
    eager.superstep = None
    bwd = fba.BWD_LAUNCHES
    want = eager._launch(rows)
    got = [graphed._launch(rows[:1])]  # the eager step, then the capture
    torch.cuda.set_sync_debug_mode("error")
    try:
        got.append(graphed._launch(rows[1:]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ss = graphed.superstep
    assert (ss.captures, ss.replays, ss.launches) == (1, 7, 0) and fba.BWD_LAUNCHES == bwd
    assert eager.state.step == graphed.state.step == 8
    assert torch.equal(torch.cat(got), want)
    a, b = _trainer_state(graphed), _trainer_state(eager)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def _tiny_finetune(dev):
    """InceptionV3's fine-tune step at 75², batch 8, f32 on the card from
    seed-0 weights, over 64 seeded rows."""
    from jckx_torch.metrics import inception_v3 as tiv
    from jckx_torch.metrics.inception_train import make_optimizer, make_train_step

    g = torch.Generator().manual_seed(11)
    data = torch.randint(0, 256, (64, 32, 32, 3), generator=g, dtype=torch.uint8).to(dev)
    labels = torch.randint(0, 10, (64,), generator=g).to(dev)
    net = tiv.init(0, num_classes=10).to(dev)
    step = make_train_step(net, make_optimizer(net, 0.01), torch.float32, 75)
    return net, step, data, labels


def test_finetune_superstep_equals_its_eager_run(deterministic_cudnn, monkeypatch):
    """The fine-tune step through its superstep: one eager step and the
    capture, then a launch of K = 4 replays under ``set_sync_debug_mode
    ("error")``, against 5 eager steps from the same weights, rows and
    draws: the weights, running statistics, loss and accuracy bit for
    bit; 94 normalize launches and 94 × 3 of the BN + ReLU backward's
    counted per step either way. Every one of the 94 backwards a step reads
    its incoming gradient in place (none is copied to make its rows
    equally spaced)."""
    from jckx_torch.metrics import inception_v3 as tiv
    from jckx_torch.metrics.inception_train import draw_step, make_superstep, step_inputs
    from jckx_torch.train.superstep import CudaGraph

    dev = _card()
    order = torch.randperm(64, generator=torch.Generator().manual_seed(2))[:40].view(5, 8).to(dev)
    net_e, step_e, data, labels = _tiny_finetune(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    rows_of, in_place = fba._gradient_rows, []

    def gradient_rows(g):
        rows = rows_of(g)
        in_place.append(rows.untyped_storage().data_ptr() == g.untyped_storage().data_ptr())
        return rows

    monkeypatch.setattr(fba, "_gradient_rows", gradient_rows)
    before = fba.launch_counts()
    want = torch.stack([torch.stack(step_e(data, labels, order[i], draw_step(gen, 8, dev)))
                        for i in range(5)])
    assert [a - b for a, b in zip(fba.launch_counts(), before)] == [5 * 94, 0, 5 * 94 * 3]
    assert len(in_place) == 5 * 94 * 2 and all(in_place)

    net_g, step_g, _, _ = _tiny_finetune(dev)
    ss = make_superstep(step_g, data, labels, CudaGraph)
    gen = torch.Generator(device=dev).manual_seed(3)
    before = fba.launch_counts()
    got = [ss.replay(1, lambda j: step_inputs(order[j], draw_step(gen, 8, dev)))]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got.append(ss.replay(4, lambda j: step_inputs(order[1 + j], draw_step(gen, 8, dev))))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(fba.launch_counts(), before)] == [5 * 94, 0, 5 * 94 * 3]
    assert ss.launches == 94 and (ss.captures, ss.replays) == (1, 4) and ss.pool_bytes > 0
    assert torch.equal(torch.cat(got), want)
    a, b = tiv.to_jckx_flat(net_g), tiv.to_jckx_flat(net_e)
    for k in b:
        assert (a[k] == b[k]).all(), k


def test_profiler_counts_the_replayed_kernel_launches():
    """In one replay of the fine-tune's graph the profiler sees the fused
    kernel (``bn_act`` kernels) launched as often as the superstep added to
    ``LAUNCHES``: 94. The profiler may drop a record (CUPTI), never add one,
    so a window that sees fewer is taken again, up to three."""
    from torch.profiler import ProfilerActivity, profile

    from jckx_torch.metrics.inception_train import draw_step, make_superstep, step_inputs
    from jckx_torch.train.superstep import CudaGraph

    dev = _card()
    _, step, data, labels = _tiny_finetune(dev)
    ss = make_superstep(step, data, labels, CudaGraph)
    gen = torch.Generator(device=dev).manual_seed(3)
    idx = torch.arange(8, device=dev)
    feed = lambda j: step_inputs(idx, draw_step(gen, 8, dev))  # noqa: E731
    ss.replay(2, feed)  # the eager step, the capture, one replay
    seen = []
    for _ in range(3):
        torch.cuda.synchronize()
        before = fba.LAUNCHES
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ss.replay(1, feed)
            torch.cuda.synchronize()
        assert fba.LAUNCHES - before == 94
        seen.append(sum(e.device_type == torch.autograd.DeviceType.CUDA and "bn_act" in e.name
                        for e in prof.events()))
        if seen[-1] == 94:
            break
    assert max(seen) <= 94 and seen[-1] == 94, seen


def _forced_live_step_child(rank, store, root):
    """A NCCL world of one whose mesh has every axis live (the port skips
    an axis of size 1), its sums issued as ``PREMUL_SUM`` by 1.0 (x · 1.0 =
    x; NCCL runs an in-place sum over one rank as no device work, a scaled
    one as a kernel): the tiny DCGAN trainer's superstep over it (the first
    step eager, then captured, 7 replays under ``set_sync_debug_mode
    ("error")``) against 8 eager steps over it, bit for bit, and
    ``mesh.stats`` holding 7 times the eager step's collectives as replayed."""
    import pathlib

    import torch.distributed as dist

    from jckx_torch.parallel.mesh import ProcessMesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    premul_one = dist._make_nccl_premul_sum(1.0)

    class ForcedLiveMesh(ProcessMesh):
        def _live(self, axis):
            return self.distributed

        def _sum(self, t, axis):
            dist.all_reduce(t, op=premul_one, group=self._groups[axis])

    try:
        mesh = ForcedLiveMesh((1,), ("data",), dev)
        root = pathlib.Path(root)
        perm = torch.randperm(48, generator=torch.Generator().manual_seed(1)).to(dev)
        rows = [{"idx": perm[(8 * j) % 48:(8 * j) % 48 + 8]} for j in range(8)]
        warm = _tiny_trainer(root, "warm", mesh=mesh)
        warm.superstep = None
        warm._launch(rows[:2])
        eager = _tiny_trainer(root, "eager", mesh=mesh)
        graphed = _tiny_trainer(root, "graphed", mesh=mesh)
        assert graphed.superstep is not None and eager.superstep is not None
        eager.superstep = None
        snap = mesh.stats.snapshot()
        want = eager._launch(rows)
        one_step = {k: (mesh.stats.calls[k] - snap["calls"][k]) // 8 for k in mesh.stats.KINDS}
        got = [graphed._launch(rows[:1])]
        snap = mesh.stats.snapshot()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got.append(graphed._launch(rows[1:]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert one_step["all_reduce"] > 0
        for k, calls in one_step.items():
            assert mesh.stats.calls[k] - snap["calls"][k] == 7 * calls, k
            assert mesh.stats.replayed[k] - snap["replayed"][k] == 7 * calls, k
        assert (graphed.superstep.captures, graphed.superstep.replays) == (1, 7)
        assert torch.equal(torch.cat(got), want)
        a, b = _trainer_state(graphed), _trainer_state(eager)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    finally:
        dist.destroy_process_group()


def test_forced_live_nccl_step_replays_as_eager(tmp_path):
    """``_forced_live_step_child`` in a child process (its NCCL group and
    its graphs die with it); its checks raise there and fail here."""
    import torch.multiprocessing as mp

    _card()
    mp.spawn(_forced_live_step_child, args=(str(tmp_path / "store"), str(tmp_path)), nprocs=1)


# ---------------------------------------------- inference programs as graphs

@pytest.fixture
def renders_without_sync(monkeypatch):
    """Each batch's render of ``sample()`` (not its drain, which copies to
    the host) runs under ``set_sync_debug_mode("error")``."""
    import jckx_torch.export as texport
    import jckx_torch.serve as tserve

    real = tserve.pipelined_sample

    def guarded(n, bs, render):
        def render_no_sync(made):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return render(made)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        return real(n, bs, render_no_sync)

    monkeypatch.setattr(tserve, "pipelined_sample", guarded)
    monkeypatch.setattr(texport, "pipelined_sample", guarded)


@pytest.mark.parametrize("kind", ["dcgan", "cgan", "cgan_random", "pt2_dcgan", "pt2_cgan",
                                  "int8", "subpixel", "truncation"])
def test_served_requests_replay_one_graph_per_batch(tmp_path, deterministic_cudnn,
                                                    renders_without_sync, kind):
    """A bs64 bf16 service at 64² (width 8; the float, int8, sub-pixel or
    truncated (0.7) sampler), or its ``.pt2``: the first request renders
    eagerly and captures; a request of 4.5 batches is one replay per batch
    with no host synchronisation in a render, 4 launches counted per batch,
    and its bytes equal the same object's eager route (its program set to
    None)."""
    import numpy as np

    from jckx_torch.export import ArtifactService, export_generator
    from jckx_torch.serve import GeneratorService
    from jckx_torch.utils.graphs import CudaGraph

    _card()
    conditional = "cgan" in kind
    path = _gan_ckpt(str(tmp_path / "g.pt"), conditional)
    if kind.startswith("pt2"):
        export_generator(path, str(tmp_path / "g.pt2"), batch_size=64)
        svc = ArtifactService(str(tmp_path / "g.pt2"))
    else:
        sampler = {"int8": {"quant": "int8"}, "subpixel": {"subpixel": True},
                   "truncation": {"truncation": 0.7}}.get(kind, {})
        svc = GeneratorService(path, batch_size=64, **sampler)
    labels = [3, 17, 42] if conditional and kind != "cgan_random" else None
    assert svc.program.graph_cls is CudaGraph
    svc.sample(64, labels=labels, seed=1)  # eager, then the capture
    before = fba.LAUNCHES
    got = svc.sample(288, labels=labels, seed=2)
    assert fba.LAUNCHES - before == 4 * 5
    assert (svc.program.captures, svc.program.replays) == (1, 5) and svc.program.pool_bytes > 0
    program, svc.program = svc.program, None
    try:
        want = svc.sample(288, labels=labels, seed=2)
    finally:
        svc.program = program
    assert got.shape == (288, 64, 64, 3) and np.array_equal(got, want)
    assert len({got[i:i + 64].tobytes() for i in range(0, 256, 64)}) == 4


def test_a_reply_is_page_locked_up_to_its_limit(tmp_path, deterministic_cudnn, monkeypatch):
    """A bs512 bf16 CGAN service at 64² (width 8): requests of 4096 (48
    MiB), 5000 (59 MiB, more batches than ``WINDOW``) and 10,900 images
    (127.7 MiB) land in page-locked replies, one of 11,000 (128.9 MiB) in a
    pageable one, each
    counted once in ``REPLIES``; every reply equals the same request's
    eager renders copied batch by batch and concatenated (the route before
    the copy stream), and each held reply is unchanged after the later
    requests."""
    import numpy as np

    import jckx_torch.serve as tserve

    _card()
    svc = tserve.GeneratorService(_gan_ckpt(str(tmp_path / "g.pt"), True), batch_size=512)
    labels = [3, 17, 42]
    svc.sample(512, labels=labels, seed=0)  # eager, then the capture
    real, batches = tserve.pipelined_sample, []

    def concatenated(n, bs, render):
        def kept(made):
            imgs = render(made)
            batches.append(imgs[:min(bs, n - made)].cpu().numpy())
            return imgs

        real(n, bs, kept)
        return np.concatenate(batches)

    replies = []
    for n, memory in ((4096, "pinned"), (5000, "pinned"), (10900, "pinned"),
                      (11000, "pageable")):
        before = dict(tserve.REPLIES)
        got = svc.sample(n, labels=labels, seed=n)
        assert {k: tserve.REPLIES[k] - before[k] for k in before} == {
            "pinned": int(memory == "pinned"), "pageable": int(memory == "pageable")}
        assert torch.from_numpy(got).is_pinned() == (memory == "pinned")
        assert got.shape == (n, 64, 64, 3) and got.dtype == np.uint8 and got.flags.c_contiguous
        program, svc.program = svc.program, None
        batches.clear()
        monkeypatch.setattr(tserve, "pipelined_sample", concatenated)
        try:
            want = svc.sample(n, labels=labels, seed=n)
        finally:
            svc.program = program
            monkeypatch.setattr(tserve, "pipelined_sample", real)
        assert np.array_equal(got, want)
        replies.append((got, want))
    assert all(np.array_equal(got, want) for got, want in replies)


@pytest.mark.parametrize("sampler", [{}, {"quant": "int8"}, {"subpixel": True},
                                     {"truncation": 0.7}])
def test_a_capture_makes_no_host_synchronisation(tmp_path, sampler):
    """The first render (the eager call and the capture) and a replay, both
    under ``set_sync_debug_mode("error")``: nothing in the float, int8,
    sub-pixel or truncated sampler's body reads the card from the host."""
    from jckx_torch.serve import GeneratorService

    dev = _card()
    svc = GeneratorService(_gan_ckpt(str(tmp_path / "g.pt"), False), batch_size=64, **sampler)
    z = torch.randn(64, 100, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = svc.render(z)
        b = svc.render(z)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (svc.program.captures, svc.program.replays) == (1, 1)
    assert torch.equal(a, b)


def test_a_program_replays_its_keys_in_any_order(tmp_path, deterministic_cudnn):
    """Two input shapes of one program, captured into its one shared pool,
    replayed in either order: each render equals the eager route's."""
    from jckx_torch.serve import GeneratorService

    dev = _card()
    svc = GeneratorService(_gan_ckpt(str(tmp_path / "g.pt"), False), batch_size=64)
    g = torch.Generator(device=dev).manual_seed(6)
    zs = [torch.randn(n, 100, generator=g, device=dev) for n in (64, 24)]
    for z in zs + zs[::-1]:
        svc.render(z)
    got = [svc.render(z) for z in zs[::-1] + zs]
    assert (svc.program.captures, svc.program.replays) == (2, 6)
    program, svc.program = svc.program, None
    try:
        want = [svc.render(z) for z in zs[::-1] + zs]
    finally:
        svc.program = program
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_profiler_counts_a_served_replay(tmp_path, quant):
    """In one replay of a served batch's graph (the float or the int8
    sampler) the profiler sees the fused kernel as often as the program
    added to ``LAUNCHES``: 4, and the moments kernels as often as it added
    to ``MOMENTS_LAUNCHES``: 8 (a window that falls short, a record CUPTI
    dropped, is taken again, up to three)."""
    from torch.profiler import ProfilerActivity, profile

    from jckx_torch.serve import GeneratorService

    dev = _card()
    svc = GeneratorService(_gan_ckpt(str(tmp_path / "g.pt"), False), batch_size=64, quant=quant)
    z = torch.randn(64, 100, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    svc.render(z)  # eager, then the capture
    seen = []
    for _ in range(3):
        torch.cuda.synchronize()
        before, moments = fba.LAUNCHES, fba.MOMENTS_LAUNCHES
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            svc.render(z)
            torch.cuda.synchronize()
        assert fba.LAUNCHES - before == 4 and fba.MOMENTS_LAUNCHES - moments == 8
        kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.append((sum("bn_act" in k for k in kernels), sum("bn_moments" in k for k in kernels)))
        if seen[-1] == (4, 8):
            break
    assert max(a for a, _ in seen) <= 4 and max(b for _, b in seen) <= 8, seen
    assert seen[-1] == (4, 8), seen


def _biggan_ckpt(path, ch=96, classes=1000):
    """A BigGAN-128 checkpoint at width ``ch`` of the benchmark's seeded
    weights (``portbench/reference/biggan.py``)."""
    from portbench.reference import biggan as ref

    cfg = {"ch": ch, "image_size": 128, "channels": 3, "z_dim": 120, "z_chunks": 6,
           "shared_dim": 128, "num_classes": classes, "attention": 64, "bn_eps": 1e-5}
    ref.write_checkpoint(path, ref.make_weights(cfg, 11, torch.device("cuda")))
    return path


def test_profiler_counts_a_biggan_replay(tmp_path):
    """One replay of a served BigGAN-128 batch (ch 96, bs256, bf16): the
    profiler sees the conditional normalize kernel 10 times, the
    per-channel one once (the output BN), the statistics' kernels 22 times
    (two a layer), the residual sum's 5 times (a block) and the attention
    route's kernel (``ops/attention.ROUTE_KERNELS``), so that a change of
    route fails here and not in the benchmark's readers (a window that
    falls short, a record CUPTI dropped, is taken again, up to three). The
    counters the BN wrappers keep add 1 and 22 a replay."""
    from torch.profiler import ProfilerActivity, profile

    from jckx_torch.ops.attention import ROUTE_KERNELS
    from jckx_torch.serve import GeneratorService

    dev = _card()
    svc = GeneratorService(_biggan_ckpt(str(tmp_path / "g.pt")), batch_size=256)
    gen = torch.Generator(device=dev).manual_seed(5)
    z = torch.randn(256, 120, generator=gen, device=dev)
    labels = torch.randperm(1000, generator=gen, device=dev)[:256]
    svc.render(z, labels)  # eager, then the capture
    want = (10, 1, 22, 5)
    seen = []
    for _ in range(3):
        torch.cuda.synchronize()
        before, moments = fba.LAUNCHES, fba.MOMENTS_LAUNCHES
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            svc.render(z, labels)
            torch.cuda.synchronize()
        assert (fba.LAUNCHES - before, fba.MOMENTS_LAUNCHES - moments) == (1, 22)
        kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.append(tuple(sum(word in k for k in kernels)
                          for word in ("cbn_normalize", "bn_act", "bn_moments", "up2_add")))
        attn = sum(any(w in k for w in ROUTE_KERNELS) for k in kernels)
        if seen[-1] == want and attn:
            break
    assert all(a <= b for got in seen for a, b in zip(got, want)), seen
    assert seen[-1] == want and attn >= 1, (seen, attn)


def test_a_biggan_render_never_holds_the_scores(tmp_path):
    """A BigGAN-128 bs256 bf16 render, eager (every allocation its own), and
    a replay: each raises the memory peak by less than one (256, 4096, 1024)
    f32 score buffer (4.3 GB), so neither route materializes the scores;
    the images are uint8 (256, 128, 128, 3)."""
    from jckx_torch.serve import GeneratorService

    dev = _card()
    svc = GeneratorService(_biggan_ckpt(str(tmp_path / "g.pt")), batch_size=256)
    z = torch.randn(256, 120, generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    labels = torch.arange(256, device=dev)
    scores = 256 * 4096 * 1024 * 4
    program = svc.program
    for route in ("eager", "replay"):
        svc.program = None if route == "eager" else program
        svc.render(z, labels)  # warm: the folded weights, cuDNN's choices, the capture
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        imgs = svc.render(z, labels)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated(dev) - base
        assert imgs.shape == (256, 128, 128, 3) and imgs.dtype == torch.uint8
        assert rise < scores, (route, rise)
