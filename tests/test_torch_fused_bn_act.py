"""The port's fused BN + activation (jckx_torch/kernels/fused_bn_act.py)
against the JAX package's (jckx/kernels/fused_bn_act.py) on the CPU.

Inputs are made with numpy from a seed and handed to both. Tolerances:
f32 within 1e-5 (the same f32 arithmetic in another order); bf16 within
2e-2 (outputs round to bf16, whose ulp at |y| < 4 is at most 2**-6, and a
one-ulp difference in rounding is expected where the two frameworks'
f32 values straddle a rounding point).
The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py and
chip_smoke.py); here the wrapper takes the plain path because its tensors
lie on the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jckx.kernels import fused_bn_act as jfba
from jckx_torch.kernels import _build
from jckx_torch.kernels import fused_bn_act as tfba

ACTS = ["relu", "leaky_relu", "none"]
# NHWC, or (rows, C): lane-aligned, ragged C, ragged rows
SHAPES = [(16, 4, 4, 128), (8, 7, 7, 100), (3, 5, 7, 3), (1000, 3), (7, 64)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    s = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    return x, s, b


def _to_port(x):
    """NHWC numpy → NCHW-logical channels_last torch (the port's layout)."""
    t = torch.from_numpy(x)
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _from_port(t):
    t = t.permute(0, 2, 3, 1) if t.dim() == 4 else t
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_jckx_xla(act, shape, dtype):
    x, s, b = _inputs(shape)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = np.asarray(jfba._bn_act_xla(jx, jnp.asarray(s), jnp.asarray(b), act, 0.2, 1e-5)
                     .astype(jnp.float32))
    tx = _to_port(x).to(getattr(torch, dtype))
    got = tfba.bn_act_plain(tx, torch.from_numpy(s), torch.from_numpy(b), act)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_from_port(got), ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_one_rounding_plain_version_matches_jckx_xla(act, dtype):
    """The plain version with the kernel's single rounding, which the card
    compares whole renders with bit for bit, computes jckx's function."""
    x, s, b = _inputs((8, 7, 7, 100), seed=4)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = np.asarray(jfba._bn_act_xla(jx, jnp.asarray(s), jnp.asarray(b), act, 0.2, 1e-5)
                     .astype(jnp.float32))
    tx = _to_port(x).to(getattr(torch, dtype))
    got = tfba.bn_act_one_rounding(tx, torch.from_numpy(s), torch.from_numpy(b), act)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_from_port(got), ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_interpreted_pallas_kernel(act, monkeypatch):
    monkeypatch.setenv("JCKX_PALLAS_INTERPRET", "1")
    x, s, b = _inputs((16, 4, 4, 128), seed=1)  # C % 128 == 0, rows % 8 == 0
    ref = np.asarray(jfba._bn_act_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                         act, 0.2, 1e-5))
    got = tfba.bn_act_plain(_to_port(x), torch.from_numpy(s), torch.from_numpy(b), act)
    np.testing.assert_allclose(_from_port(got), ref, rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_takes_plain_path_without_a_launch():
    x, s, b = _inputs((8, 7, 7, 100), seed=2)
    tx, ts, tb = _to_port(x), torch.from_numpy(s), torch.from_numpy(b)
    before = tfba.LAUNCHES
    got = tfba.bn_act(tx, ts, tb, act="leaky_relu")
    assert tfba.LAUNCHES == before
    torch.testing.assert_close(got, tfba.bn_act_plain(tx, ts, tb, act="leaky_relu"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_registered_operator_on_cpu_is_the_plain_version(dtype):
    x, s, b = _inputs((300, 24), seed=5)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    inv, shift = torch.from_numpy(s), torch.from_numpy(b)
    before = tfba.LAUNCHES
    got = torch.ops.jckx_torch.normalize_act(tx, inv, shift, "leaky_relu", 0.2)
    assert tfba.LAUNCHES == before
    assert torch.equal(got, tfba.normalize_act_plain(tx, inv, shift, "leaky_relu", 0.2))


def test_bn_act_exports_as_the_registered_operator():
    """``torch.export`` records the operator as one node (by its fake
    implementation), so a sealed program on the card launches the kernel;
    the program runs the plain version here."""

    class Layer(torch.nn.Module):
        def forward(self, x, scale, bias):
            return tfba.bn_act(x, scale, bias, act="relu")

    x, s, b = _inputs((4, 5, 5, 16), seed=6)
    args = (_to_port(x).contiguous(memory_format=torch.channels_last), torch.from_numpy(s),
            torch.from_numpy(b))
    with torch.no_grad():
        program = torch.export.export(Layer(), args, strict=False)
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.jckx_torch.normalize_act.default) == 1
    assert torch.equal(program.module()(*args), tfba.bn_act_plain(*args, act="relu"))


def _sums_as_before(x2d):
    """The statistics' sums as ``_stats`` took them before the moments
    kernel: an f32 copy, its square, two column sums, stacked."""
    xf = x2d.float()
    return torch.stack([xf.sum(0), (xf * xf).sum(0)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 24), (8 * 7 * 7, 100), (16 * 4 * 4, 128)])
def test_moments_operator_on_cpu_is_the_plain_sums(shape, dtype):
    """``jckx_torch::bn_moments`` on a CPU tensor is the plain composition,
    bit for bit, and launches nothing."""
    x, _, _ = _inputs(shape, seed=7)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    before = (tfba.LAUNCHES, tfba.MOMENTS_LAUNCHES)
    got = torch.ops.jckx_torch.bn_moments(tx)
    assert (tfba.LAUNCHES, tfba.MOMENTS_LAUNCHES) == before
    assert got.dtype == torch.float32 and got.shape == (2, shape[1])
    assert torch.equal(got, _sums_as_before(tx))
    assert torch.equal(tfba.bn_moments_plain(tx), _sums_as_before(tx))


def test_bn_act_exports_the_moments_and_normalize_operators():
    """``torch.export`` of ``bn_act`` records exactly one
    ``jckx_torch::bn_moments`` and one ``jckx_torch::normalize_act`` node
    (by their fake implementations), so a sealed program on the card
    launches both kernels; here it equals ``bn_act_plain``."""

    class Layer(torch.nn.Module):
        def forward(self, x, scale, bias):
            return tfba.bn_act(x, scale, bias, act="leaky_relu")

    x, s, b = _inputs((4, 6, 6, 24), seed=8)
    args = (_to_port(x).to(torch.bfloat16).contiguous(memory_format=torch.channels_last),
            torch.from_numpy(s), torch.from_numpy(b))
    with torch.no_grad():
        program = torch.export.export(Layer(), args, strict=False)
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.jckx_torch.bn_moments.default) == 1
    assert ops.count(torch.ops.jckx_torch.normalize_act.default) == 1
    assert torch.equal(program.module()(*args), tfba.bn_act_plain(*args, act="leaky_relu"))


def test_statistics_stay_differentiable_where_x_needs_a_gradient(monkeypatch):
    """With grad on and x requiring it, ``_stats`` takes the plain sums
    (never the operator), and the gradients of ``bn_act_plain`` to second
    order are those of the composition as it was before the kernel."""
    x, s, b = _inputs((2, 5, 5, 12), seed=9)
    w = torch.from_numpy(np.random.RandomState(10).randn(2, 12, 5, 5).astype(np.float32))

    def grads(stats_sums):
        monkeypatch.setattr(tfba, "bn_moments_plain", stats_sums)
        xs, ss, bs = (t.clone().requires_grad_()
                      for t in (_to_port(x).contiguous(), torch.from_numpy(s),
                                torch.from_numpy(b)))
        out = tfba.bn_act_plain(xs, ss, bs, act="leaky_relu")
        (gx,) = torch.autograd.grad((out * w).sum(), xs, create_graph=True)
        gx.square().sum().backward()
        assert bs.grad is None  # the penalty's term does not reach the bias
        return xs.grad, ss.grad

    def refused(x2d):
        raise AssertionError("bn_moments_op on an input that needs its gradient")

    monkeypatch.setattr(tfba, "bn_moments_op", refused)
    got = grads(tfba.bn_moments_plain)
    want = grads(_sums_as_before)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_moments_operator_on_cpu_sums_an_nchw_map_over_its_rows(layout, dtype):
    """``jckx_torch::bn_moments`` of an NCHW map (the fine-tune's forward
    hands it x as it comes) on the CPU: the f32 sum and sum of squares over
    N, H, W, bit for bit, as the forward took them before the operator;
    the same numbers, to f32 rounding, as the sums of its (rows, C) view."""
    x, _, _ = _inputs((6 * 5 * 7, 12), seed=9)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).reshape(6, 5, 7, 12).permute(0, 3, 1, 2)
    if layout == "nchw":
        tx = tx.contiguous()
    got = torch.ops.jckx_torch.bn_moments(tx)
    xf = tx.float()
    assert got.shape == (2, 12)
    assert torch.equal(got, torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))]))
    torch.testing.assert_close(got, _sums_as_before(tfba._rows(tx)), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("x, match", [
    (torch.zeros(64, 8, dtype=torch.float16), "float32 or bfloat16"),
    (torch.zeros(64, 8, dtype=torch.float64), "float32 or bfloat16"),
    (torch.zeros(8, 64).t(), "contiguous"),
    (torch.zeros(0, 8), "non-empty"),
    (torch.zeros(4, 8, 8), "rows, C"),
    (torch.zeros(64, 8), "CUDA"),
    (torch.zeros(64, 8, dtype=torch.bfloat16), "CUDA"),
])
def test_moments_wrapper_refuses_what_the_kernel_does_not_take(x, match):
    before = tfba.MOMENTS_LAUNCHES
    with pytest.raises(ValueError, match=match):
        tfba.bn_moments(x)
    assert tfba.MOMENTS_LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    x, s, b = _inputs((64, 8), seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        tfba.normalize_act(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["fused_bn_act"])
    assert "fused_bn_act" in _build.sources()


def test_build_lists_the_moments_source():
    assert "bn_moments" in _build.sources()
    assert _build.library_path("bn_moments") != _build.library_path("fused_bn_act")
