"""The fine-tune's building blocks in the port against the JAX package, on
the CPU: ``ops/norm.bn_relu_train`` against ``jckx.ops.norm.bn_relu_train``
(forward, statistics, and the hand-written backward), ``data/augment``'s
crop + flip against ``jckx.data.augment.random_resized_crop_flip`` on the
same draws, InceptionV3's train-mode forward against ``apply_train``, and
the flat ``.npz`` layout both ways.

Inputs are made with numpy from a seed. Tolerances: f32 within 1e-5 (the
same f32 arithmetic summed in another order); a bf16 output within one
bf16 ulp of the larger magnitude plus 1e-5 (the two frameworks' f32
values may straddle a bf16 rounding point). The whole train forward is
held within 2e-3 of the logits' largest magnitude, and each updated
running statistic within 1e-3 of its layer's largest (measured 1.6e-3 and
3.2e-4): through 94 layers of batch-statistic BN, f32 rounding
differences in the statistics grow, most where Mixed_7's 1×1 maps at 75²
leave 8 values per channel (see ``tests/test_torch_finetune_step.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jckx.data.augment import random_resized_crop_flip as jckx_rrc
from jckx.metrics import inception_v3 as jiv
from jckx.metrics.metrics import flatten_params
from jckx.ops.norm import bn_relu_train as jckx_bn_relu_train
from jckx_torch.data.augment import CropDraws, draw_crops, random_resized_crop_flip
from jckx_torch.kernels import fused_bn_act as tfba
from jckx_torch.metrics import inception_v3 as tiv
from jckx_torch.ops.norm import bn_relu_train
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(8, 6, 6, 5), (32, 7)]


def _to_port(x):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _from_port(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).float().numpy()


def _within_bf16_ulp(a, b):
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = np.where(m > 0, np.exp2(np.floor(np.log2(np.where(m > 0, m, 1))) - 7), 0)
    return np.abs(a - b) <= ulp + 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_relu_train_matches_jckx_forward_and_backward(shape, dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    s = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    dout = rng.randn(*shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jx = jnp.asarray(x).astype(jdt)

    def loss(xx, ss, bb):
        out, _, _ = jckx_bn_relu_train(xx, ss, bb, 1e-3)
        return jnp.sum(out.astype(jnp.float32) * dout)

    (jout, jmean, jvar) = jckx_bn_relu_train(jx, jnp.asarray(s), jnp.asarray(b), 1e-3)
    jdx, jds, jdb = jax.grad(loss, argnums=(0, 1, 2))(jx, jnp.asarray(s), jnp.asarray(b))

    tx = _to_port(x).to(getattr(torch, dtype)).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    out, mean, var = bn_relu_train(tx, ts, tb, 1e-3)
    assert out.dtype == tx.dtype and mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad  # the stats carry no gradient
    (out.float() * _to_port(dout)).sum().backward()
    assert tx.grad.dtype == tx.dtype

    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5, atol=1e-5)
    for got, ref in ((out, jout), (tx.grad, jdx)):
        got, ref = _from_port(got), np.asarray(ref.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        else:
            assert _within_bf16_ulp(got, ref).all()
    for got, ref in ((ts.grad, jds), (tb.grad, jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def test_bn_relu_train_routes_its_normalize_pass_through_the_operator(monkeypatch):
    """The forward's normalize + ReLU is ``jckx_torch::normalize_act`` (the
    kernel on the card); on the CPU that operator is the plain version and
    launches nothing."""
    seen = []
    real = tfba.normalize_act_plain

    def spy(x2d, inv, shift, act="none", negative_slope=0.2):
        seen.append((tuple(x2d.shape), act))
        return real(x2d, inv, shift, act, negative_slope)

    monkeypatch.setattr(tfba, "normalize_act_plain", spy)
    before = tfba.LAUNCHES
    x = torch.randn(4, 3, 5, 5).contiguous(memory_format=torch.channels_last)
    out, _, _ = bn_relu_train(x, torch.ones(3), torch.zeros(3))
    assert seen == [((100, 3), "relu")] and tfba.LAUNCHES == before
    assert out.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_bn_relu_train_takes_its_statistics_from_the_moments_operator(layout, dtype,
                                                                      monkeypatch):
    """The forward's sums are ``jckx_torch::bn_moments`` of x, once a call
    (the moments kernels on the card); on the CPU that operator is the
    plain f32 sum and sum of squares over N, H, W, so the statistics are
    those sums over the row count, bit for bit, and nothing launches.
    ``bn_relu_train_plain``, differentiated through its statistics, takes
    the plain sums and not the operator."""
    from jckx_torch.ops.norm import bn_relu_train_plain

    seen = []
    real = tfba.bn_moments_op

    def spy(x):
        seen.append((tuple(x.shape), x.dtype))
        return real(x)

    monkeypatch.setattr(tfba, "bn_moments_op", spy)
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(4, 3, 5, 5, generator=g) * 2 + 0.5).to(getattr(torch, dtype))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    scale, bias = torch.rand(3, generator=g) + 0.5, torch.randn(3, generator=g)
    x.requires_grad_(True)
    before = tfba.launch_counts()
    _, mean, var = bn_relu_train(x, scale, bias)
    assert seen == [((4, 3, 5, 5), x.dtype)] and tfba.launch_counts() == before
    xf = x.detach().float()
    s1, s2 = xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))
    assert torch.equal(mean, s1 / 100) and torch.equal(var, s2 / 100 - mean * mean)
    _, mean_p, var_p = bn_relu_train_plain(x, scale, bias)
    assert len(seen) == 1
    assert torch.equal(mean_p, mean) and torch.equal(var_p, var)


def _jckx_crop_draws(key, n):
    """jckx's per-image draws, rebuilt from its key split (augment.py:34-44)."""
    k_area, k_ratio, k_y, k_x, k_flip = jax.random.split(key, 5)
    t = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    return CropDraws(
        t(jax.random.uniform(k_area, (n,), minval=0.08, maxval=1.0)),
        t(jax.random.uniform(k_ratio, (n,), minval=jnp.log(3 / 4), maxval=jnp.log(4 / 3))),
        t(jax.random.uniform(k_y, (n,))), t(jax.random.uniform(k_x, (n,))),
        t(jax.random.bernoulli(k_flip, 0.5, (n,))))


def test_random_resized_crop_flip_matches_jckx():
    n = 16
    imgs = np.random.RandomState(1).rand(n, 32, 32, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jckx_rrc(key, jnp.asarray(imgs), out_size=75))
    draws = _jckx_crop_draws(key, n)
    # the draws hold a flipped image and one whose box the clamp cuts
    r = torch.exp(draws.log_ratio)
    area = draws.area * 32 * 32
    clamped = (torch.sqrt(area * r) > 32) | (torch.sqrt(area / r) > 32)
    assert draws.flip.any() and (~draws.flip).any() and clamped.any()
    got = random_resized_crop_flip(torch.from_numpy(imgs), 75, draws=draws)
    assert got.shape == (n, 75, 75, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_random_resized_crop_flip_draws_from_a_generator():
    imgs = torch.rand(4, 32, 32, 3)
    a = random_resized_crop_flip(imgs, 48, generator=torch.Generator().manual_seed(0))
    b = random_resized_crop_flip(imgs, 48, draws=draw_crops(4, torch.Generator().manual_seed(0)))
    c = random_resized_crop_flip(imgs, 48, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and (a - c).abs().max() > 1e-3
    assert a.min() >= -1e-3 and a.max() <= 1 + 1e-3  # bilinear of [0, 1]


@pytest.fixture(scope="module")
def seeded():
    params = jiv.init(0, num_classes=10)
    return params, tiv.from_jckx_flat(flatten_params(params))


def test_flat_layout_round_trips(seeded):
    params, net = seeded
    flat = flatten_params(params)
    back = tiv.to_jckx_flat(net)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape and back[k].dtype == np.float32, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    back["fc/b"][0] = 7.0  # a copy, not a view of the live weights
    assert float(net.fc.bias[0]) == 0.0


def test_train_forward_matches_apply_train(seeded):
    """Logits with dropout, and the updated running statistics (momentum
    0.1, unbiased variance), against jckx's ``apply_train``."""
    params, _ = seeded
    net = tiv.from_jckx_flat(flatten_params(params))
    rng = np.random.RandomState(0)
    x = rng.randn(8, 75, 75, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    keep = np.asarray(jax.random.bernoulli(key, 0.5, (8, 2048)))
    ref, new_params = jax.jit(lambda p, xx: jiv.apply_train(p, xx, dropout_key=key))(
        params, jnp.asarray(x))
    got = net.forward_train(torch.from_numpy(x), torch.from_numpy(keep.copy()))
    assert got.shape == (8, 10) and got.dtype == torch.float32 and got.requires_grad is False
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-3 * np.abs(ref).max())
    stats_ref = flatten_params(jax.device_get(new_params))
    stats = tiv.to_jckx_flat(net)
    for k in stats:
        if k.endswith(("bn_mean", "bn_var")):  # measured: <= 3.2e-4, in Mixed_7c
            np.testing.assert_allclose(stats[k], stats_ref[k], rtol=0,
                                       atol=1e-3 * np.abs(stats_ref[k]).max(), err_msg=k)
    assert all(m.bn_momentum is None for m in net.modules() if isinstance(m, tiv.BasicConv2d))


def test_avg_pool_backward_is_the_pool_of_the_gradient():
    """The branch pools' backward (the 3×3 pool applied to the gradient)
    equals autograd through the pool's definition, a sum of nine shifted
    slices of the zero-padded input over 9, in either memory layout."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 5, 7, 6))
    dy = torch.from_numpy(rng.randn(2, 5, 7, 6))

    def by_definition(t):
        p = torch.nn.functional.pad(t, (1, 1, 1, 1))
        return sum(p[:, :, i:i + 7, j:j + 6] for i in range(3) for j in range(3)) / 9

    ref = x.clone().requires_grad_(True)
    by_definition(ref).backward(dy)
    for layout in (torch.contiguous_format, torch.channels_last):
        t = x.clone(memory_format=layout).requires_grad_(True)
        y = tiv._avg_pool(t)
        y.backward(dy)
        np.testing.assert_allclose(y.detach().numpy(), by_definition(x).numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(t.grad.numpy(), ref.grad.numpy(), rtol=1e-12, atol=1e-12)
