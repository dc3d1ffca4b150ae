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
