"""Fused BatchNorm (batch statistics) + activation — port of
``jckx/kernels/fused_bn_act.py``.

The normalize + activate stage runs in a CUDA kernel written by hand for
Hopper (``csrc/fused_bn_act.cu``), which replaces the JAX package's Pallas
TPU kernel (``_partitioned_pallas_call`` → ``raw`` → ``kernel``,
``jckx/kernels/fused_bn_act.py:108-131``). The kernel is bound by HBM
bandwidth: at the generator's serving shapes (batch 512, bf16) it must
move 16.8 / 33.6 / 67.1 / 134.2 MB, 5.0 / 10.0 / 20.0 / 40.1 µs at the
H100 SXM's 3.35 TB/s (computed from the shapes; the source has the table).

- ``bn_act_plain``: the plain PyTorch composition, counterpart of
  ``_bn_act_xla`` (``:74-85``). The CPU path, and the reference the tests
  and ``chip_smoke.py`` hold the kernel against.
- ``normalize_act``: the kernel's wrapper on a CUDA ``(rows, C)`` tensor;
  ``normalize_act_plain`` is its plain version on the same inputs.
- ``bn_act``: takes ``bn_act_plain`` for a tensor on the CPU, and the
  statistics in plain torch + the kernel for a tensor on the card. There
  is no fallback from the card to the plain path.

Activations are either ``(rows, C)`` or NCHW-logical tensors in
``torch.channels_last`` memory, whose ``(N·H·W, C)`` row view is free.

The kernel is forward-only, as the Pallas kernel is in jckx, whose train
step keeps the differentiable ``_bn_act_xla`` because the WGAN-GP penalty
needs grad-of-grad. On the card, ``bn_act`` refuses tensors that require
grad under grad mode until the training path is ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from jckx_torch.kernels import _build

# Kernel launches since the last reset; chip_smoke.py reads it to show
# that the serving path went through the kernel.
LAUNCHES = 0

_ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(rows, C) view of a 2-D tensor or of an NCHW channels_last one."""
    if x.dim() == 2:
        return x
    if x.dim() == 4:
        return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    raise ValueError(f"bn_act takes (rows, C) or NCHW tensors, got shape {tuple(x.shape)}")


def _unrows(y2d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dim() == 2:
        return y2d
    n, c, h, w = like.shape
    return y2d.reshape(n, h, w, c).permute(0, 3, 1, 2)


def _stats(x2d: torch.Tensor):
    """f32 batch mean and E[x²] − mean², as jckx's ``_stats`` (``:66-71``)."""
    xf = x2d.float()
    mean = xf.mean(0)
    var = (xf * xf).mean(0) - mean * mean
    return mean, var


def _affine(x2d, scale, bias, eps):
    mean, var = _stats(x2d)
    inv = torch.rsqrt(var + eps) * scale.float()
    shift = bias.float() - mean * inv
    return inv, shift


def _activate(y: torch.Tensor, act: str, negative_slope: float) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "leaky_relu":
        return torch.where(y >= 0, y, negative_slope * y)
    if act != "none":
        raise ValueError(f"unknown act {act}")
    return y


def normalize_act_plain(x2d, inv, shift, act="none", negative_slope=0.2):
    """The kernel's plain version: ``act(f32(x) * inv + shift)`` in x's dtype
    (a multiply and an add where the kernel fuses them into one FMA)."""
    return _activate(x2d.float() * inv + shift, act, negative_slope).to(x2d.dtype)


def bn_act_plain(x, scale, bias, act="none", negative_slope=0.2, eps=1e-5):
    """Batch-stat BN + activation in plain PyTorch (``_bn_act_xla``)."""
    x2d = _rows(x)
    inv, shift = _affine(x2d, scale, bias, eps)
    return _unrows(normalize_act_plain(x2d, inv, shift, act, negative_slope), x)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("fused_bn_act").jckx_bn_act
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def normalize_act(x2d, inv, shift, act="none", negative_slope=0.2):
    """Launch the kernel: ``x2d`` a contiguous CUDA ``(rows, C)`` tensor in
    bf16 or f32, ``inv`` / ``shift`` contiguous f32 ``(C,)`` on the same
    device. → a new tensor like ``x2d``. Raises on anything else."""
    global LAUNCHES
    if x2d.device.type != "cuda":
        raise ValueError(f"normalize_act launches a CUDA kernel; x is on {x2d.device}")
    if x2d.dtype not in _DTYPES:
        raise ValueError(f"normalize_act takes float32 or bfloat16, got {x2d.dtype}")
    if act not in _ACTS:
        raise ValueError(f"unknown act {act}")
    if x2d.dim() != 2 or not x2d.is_contiguous() or x2d.numel() == 0:
        raise ValueError("normalize_act needs a non-empty contiguous (rows, C) tensor")
    rows, chans = x2d.shape
    for name, v in (("inv", inv), ("shift", shift)):
        if (v.dtype != torch.float32 or v.device != x2d.device
                or v.shape != (chans,) or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({chans},) "
                             f"tensor on {x2d.device}")
    y = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        rc = _entry()(x2d.data_ptr(), inv.data_ptr(), shift.data_ptr(), y.data_ptr(),
                      rows, chans, _DTYPES[x2d.dtype], _ACTS[act], float(negative_slope),
                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jckx_bn_act failed with CUDA error {rc}")
    LAUNCHES += 1
    return y


def bn_act(x, scale, bias, act="none", negative_slope=0.2, eps=1e-5):
    """Batch-stat BN fused with activation. See the module docstring."""
    if x.device.type == "cpu":
        return bn_act_plain(x, scale, bias, act, negative_slope, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        raise RuntimeError("bn_act on the card is forward-only: the training "
                           "path is not ported yet (run under torch.no_grad())")
    if x.dim() == 4 and not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bn_act on the card needs a channels_last NCHW tensor")
    x2d = _rows(x)
    inv, shift = _affine(x2d, scale, bias, eps)
    return _unrows(normalize_act(x2d, inv, shift, act, negative_slope), x)
