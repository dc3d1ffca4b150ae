"""A GBlock's residual sum in place: ``y += up2(s)``, up2 the nearest ×2
upsampling, on channels_last NCHW maps y (N, C, 2H, 2W) and s (N, C, H, W)
(``models/biggan.py``). On the card a hand-written kernel
(``csrc/up2_add.cu``, which replaces no Pallas kernel: the JAX package has
no BigGAN); torch's add against a broadcast view of s takes its strided
elementwise path. ``up2_add_plain_`` is that add, the CPU's route and the
tests' reference: bit for bit the kernel's (a sum in f32, rounded once).
The registered operator ``jckx_torch::up2_add_`` takes one or the other by
device. No counter counts its launches; the profiler names them
(``up2_add``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from jckx_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _blocks_of(y: torch.Tensor) -> torch.Tensor:
    """A channels_last (N, C, 2H, 2W) map as the (N, H, 2, W, 2, C) view of
    its 2×2 blocks."""
    n, c, hh, ww = y.shape
    return y.permute(0, 2, 3, 1).view(n, hh // 2, 2, ww // 2, 2, c)


def up2_add_plain_(y: torch.Tensor, s: torch.Tensor) -> None:
    """``y += up2(s)`` through a broadcast view of s against y's 2×2 blocks."""
    _blocks_of(y).add_(s.permute(0, 2, 3, 1)[:, :, None, :, None])


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("up2_add").jckx_up2_add
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, i64, i64, i64, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def up2_add_(y: torch.Tensor, s: torch.Tensor) -> None:
    """Launch the kernel: y a CUDA channels_last (N, C, 2H, 2W) map in bf16
    or f32, s a channels_last (N, C, H, W) map of its dtype on its device;
    y is updated in place. Raises on anything else."""
    if y.device.type != "cuda" or s.device != y.device:
        raise ValueError(f"up2_add_ launches a CUDA kernel; y is on {y.device}, s on {s.device}")
    if y.dtype not in _DTYPES or s.dtype != y.dtype:
        raise ValueError(f"up2_add_ takes two float32 or bfloat16 maps, got {y.dtype} and "
                         f"{s.dtype}")
    if (y.dim() != 4 or s.dim() != 4 or y.numel() == 0
            or tuple(y.shape) != (s.shape[0], s.shape[1], 2 * s.shape[2], 2 * s.shape[3])
            or not y.is_contiguous(memory_format=torch.channels_last)
            or not s.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"up2_add_ needs channels_last maps (N, C, 2H, 2W) and (N, C, H, W), "
                         f"got {tuple(y.shape)} and {tuple(s.shape)}")
    n, c, h, w = s.shape
    with torch.cuda.device(y.device):
        rc = _entry()(y.data_ptr(), s.data_ptr(), n * h, w, c, _DTYPES[y.dtype],
                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jckx_up2_add failed with CUDA error {rc}")


@torch.library.custom_op("jckx_torch::up2_add_", mutates_args=("y",))
def up2_add_op(y: torch.Tensor, s: torch.Tensor) -> None:
    """``up2_add_`` on a CUDA tensor, ``up2_add_plain_`` on a CPU one (the
    kernel has no CPU form)."""
    if y.device.type == "cuda":
        up2_add_(y, s)
    else:
        up2_add_plain_(y, s)
