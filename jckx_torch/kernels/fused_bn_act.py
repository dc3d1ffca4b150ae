"""Fused BatchNorm (batch statistics) + activation — port of
``jckx/kernels/fused_bn_act.py``.

The normalize + activate stage runs in a CUDA kernel written by hand for
Hopper (``csrc/fused_bn_act.cu``), which replaces the JAX package's Pallas
TPU kernel (``_partitioned_pallas_call`` → ``raw`` → ``kernel``,
``jckx/kernels/fused_bn_act.py:108-131``). The kernel is bound by HBM
bandwidth: at the generator's serving shapes (batch 512, bf16) it must
move 16.8 / 33.6 / 67.1 / 134.2 MB, 5.0 / 10.0 / 20.0 / 40.1 µs at the
H100 SXM's 3.35 TB/s (computed from the shapes; the source has the table).

The batch statistics in front of it, the per-channel sum and sum of
squares, run in a second hand-written kernel on the inference route
(``csrc/bn_moments.cu``), which replaces no Pallas kernel: jckx takes them
in XLA (``_stats``, ``:66-71``), as one fused pass, where the plain torch
composition takes four (an f32 copy, its square, two column sums). It reads
the activation once: 62.9 M elements, 125.8 MB a bs512 bf16 render, 37.6 µs
at 3.35 TB/s.

- ``bn_act_plain``: the plain PyTorch composition, counterpart of
  ``_bn_act_xla`` (``:74-85``). The CPU path, and the reference the tests
  and ``chip_smoke.py`` hold the kernel against.
- ``normalize_act``: the kernel's wrapper on a CUDA ``(rows, C)`` tensor;
  ``normalize_act_plain`` is its plain version on the same inputs.
- ``normalize_act_op``: the registered operator ``jckx_torch::normalize_act``
  that ``bn_act`` calls: the kernel on a CUDA tensor, the plain version on a
  CPU one. As an operator with a fake (shape-only) implementation it is one
  node of a ``torch.export`` program, so a sealed artifact launches the
  kernel too (``export.py``); a ctypes launch alone cannot be traced.
- ``bn_moments``: the moments kernels' wrapper, ``(rows, C)`` → the (2, C)
  f32 sums; ``bn_moments_plain`` its plain version, ``bn_moments_op`` the
  registered operator ``jckx_torch::bn_moments`` (the kernels on a CUDA
  tensor, the plain version, bit for bit, on a CPU one), which ``_stats``
  calls wherever x needs no gradient: in ``bn_act``'s kernel route, and in
  ``bn_act_plain`` / ``bn_act_one_rounding`` under ``no_grad``, so all
  three take the same sums.
- ``bn_relu_bwd_sums`` / ``bn_relu_bwd_dx``: the wrappers of the
  fine-tune's BN + ReLU backward (``ops/norm.bn_relu_train``), two more
  hand-written kernels (``csrc/bn_relu_bwd.cu``) that replace no Pallas
  kernel: jckx's VJP is plain jnp, which XLA fuses into two sweeps, where
  the plain torch composition takes about fifteen full-size f32 passes. The
  first reads x and the incoming gradient once and writes this rank's
  (2, C) f32 sums (Σdz, Σdz·x), the second reads them again and writes dx;
  sync-BN's all-reduce of the sums runs between them. Their plain versions
  (``bn_relu_bwd_sums_plain``, ``bn_relu_bwd_dx_plain``) are the port's
  earlier backward, op for op, and the registered operators
  ``jckx_torch::bn_relu_bwd_sums`` / ``jckx_torch::bn_relu_bwd_dx`` take
  them on a CPU tensor, bit for bit.
- ``bn_act``: routes by grad mode (below).
- ``cbn_act``: BigGAN's class-conditional BN + ReLU
  (``models/biggan.py``), the same split with an affine a sample: the
  scale and bias are (N, C), sample n owning the rows [n·HW, (n+1)·HW) of
  the (N·HW, C) view, and ``up=2`` writes the output upsampled ×2 by
  nearest neighbour (a GBlock's first BN feeds its convolution so). Its
  statistics are ``_stats`` (``bn_moments_op`` on the card), its normalize
  the registered operator ``jckx_torch::cbn_normalize_act``: a hand-written
  kernel on the card (``csrc/cbn_act.cu``, which replaces no Pallas kernel:
  the JAX package has no conditional BN), ``cbn_normalize_act_plain`` on
  the CPU. No counter counts its launches; the profiler names them
  (``cbn_normalize``).

Activations are either ``(rows, C)`` or NCHW-logical tensors in
``torch.channels_last`` memory, whose ``(N·H·W, C)`` row view is free.

The kernel is forward-only, as the Pallas kernel is in jckx: jckx's train
step keeps the differentiable ``_bn_act_xla`` (``:74-85``) because the
WGAN-GP penalty needs grad-of-grad through D, and only its inference
programs take the kernel (``pallas_inference``, ``:42-63``). ``bn_act``
makes the same split by grad mode:

- with grad enabled and any of x, scale, bias requiring grad:
  ``bn_act_plain``, which autograd differentiates to any order (the train
  step);
- otherwise (``torch.no_grad()``, inference mode, or no input that
  requires grad): the statistics through ``bn_moments_op``, then
  ``normalize_act_op`` (on the card the two kernels; on the CPU their plain
  versions, with the same result as ``bn_act_plain``).

This is a rule on grad mode, not a fallback on failure: a kernel that
does not build or launch raises.

Sync-BN over a mesh (``mesh``, ``parallel/mesh.py``): the statistics are
the per-channel sum and sum of squares, one (2, C) f32 tensor, summed over
the mesh's data axis (``axis``; over data × model, ``"world"``, where the
activation's height is sharded on the model axis) before the division by
the global row count. That is jckx's global batch statistics, which a sharded jit has by construction
(``jckx/ops/norm.py:9-12``), and the GPU form of its ``custom_partitioning``
rule (``:133-171``): each rank, or each device of a local mesh, then
normalizes its own rows with the global ``inv`` / ``shift``, through the
kernel on the card (one launch per member per layer). In the
differentiated route the sum is taken inside autograd, so the penalty's
input gradient carries every rank's terms. ``mesh=None`` is one device.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from jckx_torch.kernels import _build

# Kernel launches since the last reset; chip_smoke.py reads it to show
# that the serving path and the trainer's eval sampling went through the
# kernel, and the differentiated train steps did not. A replayed CUDA graph
# launches its kernels without this wrapper: utils/graphs.py adds the warm
# call's counts per replay (``add_launches``). LAUNCHES counts the
# normalize kernel alone, MOMENTS_LAUNCHES the moments kernels (two
# launches a ``bn_moments``: the partial sums, then their combine),
# BWD_LAUNCHES the BN + ReLU backward's (three a backward: the partial
# sums, their combine, dx; 94 × 3 a fine-tune step, 0 elsewhere).
LAUNCHES = 0
MOMENTS_LAUNCHES = 0
BWD_LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()  # a local mesh launches from one thread per device


def add_launches(n: int, moments: int = 0, bwd: int = 0) -> None:
    """Add ``n`` to ``LAUNCHES``, ``moments`` to ``MOMENTS_LAUNCHES`` and
    ``bwd`` to ``BWD_LAUNCHES`` (negative: take back what a capture
    counted)."""
    global LAUNCHES, MOMENTS_LAUNCHES, BWD_LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES += n
        MOMENTS_LAUNCHES += moments
        BWD_LAUNCHES += bwd


def launch_counts() -> tuple:
    """(``LAUNCHES``, ``MOMENTS_LAUNCHES``, ``BWD_LAUNCHES``): ``add_launches``'s order."""
    return LAUNCHES, MOMENTS_LAUNCHES, BWD_LAUNCHES


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


def _axes(x: torch.Tensor) -> tuple:
    """The axes that hold x's rows: (0, 2, 3) of NCHW, 0 of (rows, C)."""
    return (0, 2, 3) if x.dim() == 4 else (0,)


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(C,) → broadcastable against x (NCHW or (rows, C))."""
    return v[:, None, None] if x.dim() == 4 else v


def _gradient_rows(g: torch.Tensor) -> torch.Tensor:
    """The (rows, C) view of a gradient (NCHW or (rows, C)) whose channels
    are adjacent and whose rows are equally spaced: a channels_last one, or
    a channel slice of one, as ``torch.cat``'s backward hands it on (its
    rows then lie further apart than C). Any other layout: the rows of its
    channels_last copy."""
    r = g.permute(0, 2, 3, 1) if g.dim() == 4 else g
    chans = r.shape[-1]
    step, span, even = chans, None, r.stride(-1) == 1 or chans == 1
    for size, stride in zip(reversed(r.shape[:-1]), reversed(r.stride()[:-1])):
        if size == 1:
            continue
        if span is None:
            step = stride
        elif stride != span:
            even = False
        span = stride * size
    if even and step >= chans:
        return r.as_strided((r.numel() // chans, chans), (step, 1))
    if g.dim() == 4:
        return _rows(g.contiguous(memory_format=torch.channels_last))
    return g.contiguous()


def bn_moments_plain(x2d: torch.Tensor) -> torch.Tensor:
    """The per-channel sum and sum of squares of ``(rows, C)`` x in f32, as
    one (2, C) tensor: the moments kernels' plain version, which autograd
    differentiates."""
    xf = x2d.float()
    return torch.stack([xf.sum(0), (xf * xf).sum(0)])


def _stats(x2d: torch.Tensor, mesh=None, axis: str = "data"):
    """f32 batch mean and E[x²] − mean², as jckx's ``_stats`` (``:66-71``):
    the per-channel sum and sum of squares as one (2, C) tensor, summed
    over ``mesh``'s ``axis`` when a mesh is given (``"data"``; ``"world"``
    for a height-sharded activation), over the global row count. The sums
    are ``bn_moments_plain`` where x's gradient is taken (the train step's
    grad-of-grad), else ``bn_moments_op`` (the kernels on the card)."""
    if torch.is_grad_enabled() and x2d.requires_grad:
        sums = bn_moments_plain(x2d)
    else:
        sums = bn_moments_op(x2d)
    n = x2d.shape[0]
    if mesh is not None:
        sums = mesh.all_reduce(sums, axis)
        n *= mesh.axis_size(axis)
    mean = sums[0] / n
    var = sums[1] / n - mean * mean
    return mean, var


def _affine(x2d, scale, bias, eps, mesh=None, axis="data"):
    mean, var = _stats(x2d, mesh, axis)
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


def bn_act_plain(x, scale, bias, act="none", negative_slope=0.2, eps=1e-5, mesh=None,
                 axis="data"):
    """Batch-stat BN + activation in plain PyTorch (``_bn_act_xla``)."""
    x2d = _rows(x)
    inv, shift = _affine(x2d, scale, bias, eps, mesh, axis)
    return _unrows(normalize_act_plain(x2d, inv, shift, act, negative_slope), x)


def bn_act_one_rounding(x, scale, bias, act="none", negative_slope=0.2, eps=1e-5, mesh=None,
                        axis="data"):
    """``bn_act_plain`` with the kernel's rounding: the multiply-add in f64,
    rounded once to f32 as the kernel's ``fmaf`` rounds it (the product of
    a bf16 or f32 x and an f32 inv is exact in f64). A whole render through
    it equals the kernel's bit for bit, where the twice-rounded plain
    version drifts by one ulp here and there and batch statistics carry
    that through the later layers (chip_smoke.py, tests/test_torch_gpu.py)."""
    x2d = _rows(x)
    inv, shift = _affine(x2d, scale, bias, eps, mesh, axis)
    y = (x2d.double() * inv.double() + shift.double()).float()
    return _unrows(_activate(y, act, negative_slope).to(x2d.dtype), x)


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
    add_launches(1)
    return y


@functools.lru_cache(maxsize=None)
def _moments_lib():
    lib = _build.load("bn_moments")
    lib.jckx_bn_moments.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int64, ctypes.c_void_p]
    lib.jckx_bn_moments.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _wave_blocks(index: int) -> int:
    """The most blocks of the moments' and the backward's grids on card
    ``index``, 2 an SM (one wave), and so the rows of their sums'
    workspaces."""
    return 2 * torch.cuda.get_device_properties(index).multi_processor_count


def bn_moments(x2d: torch.Tensor) -> torch.Tensor:
    """Launch the moments kernels: ``x2d`` a non-empty contiguous CUDA
    ``(rows, C)`` tensor in bf16 or f32 → its (2, C) f32 sum and sum of
    squares, a new tensor. Raises on anything else."""
    if x2d.dtype not in _DTYPES:
        raise ValueError(f"bn_moments takes float32 or bfloat16, got {x2d.dtype}")
    if x2d.dim() != 2 or not x2d.is_contiguous() or x2d.numel() == 0:
        raise ValueError("bn_moments needs a non-empty contiguous (rows, C) tensor")
    if x2d.device.type != "cuda":
        raise ValueError(f"bn_moments launches a CUDA kernel; x is on {x2d.device}")
    rows, chans = x2d.shape
    lib = _moments_lib()
    with torch.cuda.device(x2d.device):
        blocks = _wave_blocks(x2d.device.index)
        ws = torch.empty((blocks, 2, chans), dtype=torch.float32, device=x2d.device)
        out = torch.empty((2, chans), dtype=torch.float32, device=x2d.device)
        rc = lib.jckx_bn_moments(x2d.data_ptr(), ws.data_ptr(), out.data_ptr(), rows, chans,
                                 _DTYPES[x2d.dtype], blocks,
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jckx_bn_moments failed with CUDA error {rc}")
    add_launches(0, 2)
    return out


@torch.library.custom_op("jckx_torch::bn_moments", mutates_args=())
def bn_moments_op(x2d: torch.Tensor) -> torch.Tensor:
    """``bn_moments`` on a CUDA tensor, ``bn_moments_plain`` on a CPU one
    (the kernels have no CPU form)."""
    if x2d.device.type == "cuda":
        return bn_moments(x2d)
    return bn_moments_plain(x2d)


@bn_moments_op.register_fake
def _bn_moments_fake(x2d):
    return x2d.new_empty((2, x2d.shape[1]), dtype=torch.float32)


def _relu_grad_plain(x, dout, a, sh):
    """(x in f32, dz): dout in f32 where ``x · a + sh`` (a multiply and an
    add, each rounded, as jckx's mask) is positive, else 0."""
    xf = x.float()
    pos = xf * _per_channel(a, x) + _per_channel(sh, x) > 0.0
    return xf, torch.where(pos, dout.float(), 0.0)


def bn_relu_bwd_sums_plain(x, dout, a, sh):
    """The backward's per-channel (Σdz, Σdz·x) of x (NCHW or (rows, C)) and
    its gradient ``dout``, as one (2, C) f32 tensor: the sums kernels'
    plain version."""
    xf, dz = _relu_grad_plain(x, dout, a, sh)
    axes = _axes(x)
    return torch.stack([dz.sum(axes), (dz * xf).sum(axes)])


def bn_relu_bwd_dx_plain(x, dout, a, sh, mean, g1, k):
    """``a · (dz − g1 − (x − mean) · k)`` in f32, cast to x's dtype (jckx's
    dx with g1 = dbeta / n and k = inv · dgamma / n): the dx kernel's plain
    version."""
    xf, dz = _relu_grad_plain(x, dout, a, sh)
    pc = functools.partial(_per_channel, x=x)
    return (pc(a) * (dz - pc(g1) - (xf - pc(mean)) * pc(k))).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = _build.load("bn_relu_bwd")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.jckx_bn_relu_bwd_sums.argtypes = [p, p, i64, p, p, p, p, i64, i64, ctypes.c_int, i64, p]
    lib.jckx_bn_relu_bwd_dx.argtypes = [p, p, i64, p, p, p, p, p, p, i64, i64, ctypes.c_int,
                                        i64, p]
    lib.jckx_bn_relu_bwd_sums.restype = lib.jckx_bn_relu_bwd_dx.restype = ctypes.c_int
    return lib


def _bwd_operands(x, dout, vectors):
    """The kernels' operands, checked: (x's rows, dout's rows, C). x is a
    CUDA channels_last NCHW or contiguous (rows, C) tensor in bf16 or f32,
    ``dout`` its gradient in the same dtype (any layout: ``_gradient_rows``),
    ``vectors`` contiguous f32 (C,) tensors on its device. Raises on
    anything else."""
    if x.dtype not in _DTYPES or dout.dtype != x.dtype or dout.shape != x.shape:
        raise ValueError(f"the BN + ReLU backward takes x and dout of one shape in float32 or "
                         f"bfloat16, got {x.dtype} {tuple(x.shape)} and {dout.dtype} "
                         f"{tuple(dout.shape)}")
    dense = x.is_contiguous(memory_format=torch.channels_last if x.dim() == 4
                            else torch.contiguous_format)
    if x.dim() not in (2, 4) or not dense or x.numel() == 0:
        raise ValueError("the BN + ReLU backward needs a non-empty channels_last NCHW or "
                         "contiguous (rows, C) x")
    x2d = _rows(x)
    chans = x2d.shape[1]
    for v in vectors:
        if (v.dtype != torch.float32 or v.device != x.device or v.shape != (chans,)
                or not v.is_contiguous()):
            raise ValueError(f"per-channel vectors must be contiguous float32 ({chans},) "
                             f"tensors on {x.device}")
    if x.device.type != "cuda" or dout.device != x.device:
        raise ValueError(f"the BN + ReLU backward launches CUDA kernels; x is on {x.device}, "
                         f"dout on {dout.device}")
    return x2d, _gradient_rows(dout), chans


def bn_relu_bwd_sums(x, dout, a, sh):
    """Launch the backward's sums kernels (``_bwd_operands`` says what they
    take) → this rank's (2, C) f32 Σdz and Σdz·x, a new tensor."""
    x2d, g2d, chans = _bwd_operands(x, dout, (a, sh))
    with torch.cuda.device(x.device):
        blocks = _wave_blocks(x.device.index)
        ws = torch.empty((blocks, 2, chans), dtype=torch.float32, device=x.device)
        out = torch.empty((2, chans), dtype=torch.float32, device=x.device)
        rc = _bwd_lib().jckx_bn_relu_bwd_sums(
            x2d.data_ptr(), g2d.data_ptr(), g2d.stride(0), a.data_ptr(), sh.data_ptr(),
            ws.data_ptr(), out.data_ptr(), x2d.shape[0], chans, _DTYPES[x.dtype], blocks,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jckx_bn_relu_bwd_sums failed with CUDA error {rc}")
    add_launches(0, 0, 2)
    return out


def bn_relu_bwd_dx(x, dout, a, sh, mean, g1, k):
    """Launch the backward's dx kernel (``_bwd_operands`` says what it
    takes) → dx, a new tensor like x (channels_last where x is)."""
    x2d, g2d, chans = _bwd_operands(x, dout, (a, sh, mean, g1, k))
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _bwd_lib().jckx_bn_relu_bwd_dx(
            x2d.data_ptr(), g2d.data_ptr(), g2d.stride(0), a.data_ptr(), sh.data_ptr(),
            mean.data_ptr(), g1.data_ptr(), k.data_ptr(), _rows(dx).data_ptr(), x2d.shape[0],
            chans, _DTYPES[x.dtype], _wave_blocks(x.device.index),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jckx_bn_relu_bwd_dx failed with CUDA error {rc}")
    add_launches(0, 0, 1)
    return dx


@torch.library.custom_op("jckx_torch::bn_relu_bwd_sums", mutates_args=())
def bn_relu_bwd_sums_op(x: torch.Tensor, dout: torch.Tensor, a: torch.Tensor,
                        sh: torch.Tensor) -> torch.Tensor:
    """``bn_relu_bwd_sums`` on a CUDA tensor, ``bn_relu_bwd_sums_plain`` on
    a CPU one (the kernels have no CPU form)."""
    if x.device.type == "cuda":
        return bn_relu_bwd_sums(x, dout, a, sh)
    return bn_relu_bwd_sums_plain(x, dout, a, sh)


@bn_relu_bwd_sums_op.register_fake
def _bn_relu_bwd_sums_fake(x, dout, a, sh):
    return x.new_empty((2, a.shape[0]), dtype=torch.float32)


@torch.library.custom_op("jckx_torch::bn_relu_bwd_dx", mutates_args=())
def bn_relu_bwd_dx_op(x: torch.Tensor, dout: torch.Tensor, a: torch.Tensor, sh: torch.Tensor,
                      mean: torch.Tensor, g1: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``bn_relu_bwd_dx`` on a CUDA tensor, ``bn_relu_bwd_dx_plain`` on a
    CPU one (the kernel has no CPU form)."""
    if x.device.type == "cuda":
        return bn_relu_bwd_dx(x, dout, a, sh, mean, g1, k)
    return bn_relu_bwd_dx_plain(x, dout, a, sh, mean, g1, k)


@bn_relu_bwd_dx_op.register_fake
def _bn_relu_bwd_dx_fake(x, dout, a, sh, mean, g1, k):
    return torch.empty_like(x)


def _up_rows(y2d: torch.Tensor, samples: int, width: int, up: int) -> torch.Tensor:
    """(N·H·W, C) rows of N maps ``width`` wide → the rows of their nearest
    ×``up`` upsampling, (N·up·H·up·W, C)."""
    if up == 1:
        return y2d
    chans = y2d.shape[1]
    y = y2d.reshape(samples, -1, width, chans)
    return y.repeat_interleave(up, dim=1).repeat_interleave(up, dim=2).reshape(-1, chans)


def cbn_normalize_act_plain(x2d, inv, shift, width=1, up=1):
    """The conditional kernel's plain version: ``relu(f32(x) * inv[n] +
    shift[n])`` in x's dtype over the rows of each sample n (``inv`` and
    ``shift`` (N, C) f32; sample n owns the rows [n·R, (n+1)·R) of the
    (N·R, C) ``x2d``), a multiply and an add where the kernel fuses them;
    with ``up`` 2 each sample's map (``width`` columns) upsampled ×2 by
    nearest neighbour."""
    n, chans = inv.shape
    y = x2d.float().reshape(n, -1, chans) * inv[:, None] + shift[:, None]
    y = torch.relu(y).reshape(x2d.shape).to(x2d.dtype)
    return _up_rows(y, n, width, up)


@functools.lru_cache(maxsize=None)
def _cbn_entry():
    fn = _build.load("cbn_act").jckx_cbn_act
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p, p, p, p, i64, i64, i64, i64, i32, i32, p]
    fn.restype = ctypes.c_int
    return fn


def cbn_normalize_act(x2d, inv, shift, width=1, up=1):
    """Launch the conditional kernel: ``x2d`` a non-empty contiguous CUDA
    ``(N·R, C)`` tensor in bf16 or f32, ``inv`` / ``shift`` contiguous f32
    ``(N, C)`` on the same device, N dividing the rows; ``up`` 1, or 2 for
    the nearest ×2 upsampling of each sample's map of ``width`` columns
    (dividing R). → a new (N·up²·R, C) tensor like ``x2d``. Raises on
    anything else."""
    if x2d.device.type != "cuda":
        raise ValueError(f"cbn_normalize_act launches a CUDA kernel; x is on {x2d.device}")
    if x2d.dtype not in _DTYPES:
        raise ValueError(f"cbn_normalize_act takes float32 or bfloat16, got {x2d.dtype}")
    if up not in (1, 2):
        raise ValueError(f"upsampling {up}: 1 or 2")
    if x2d.dim() != 2 or not x2d.is_contiguous() or x2d.numel() == 0:
        raise ValueError("cbn_normalize_act needs a non-empty contiguous (rows, C) tensor")
    rows, chans = x2d.shape
    samples = inv.shape[0] if inv.dim() == 2 else 0
    for name, v in (("inv", inv), ("shift", shift)):
        if (v.dtype != torch.float32 or v.device != x2d.device or v.dim() != 2
                or v.shape != (samples, chans) or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 (N, {chans}) tensor on "
                             f"{x2d.device}, one row a sample")
    if samples == 0 or rows % samples or width < 1 or (rows // samples) % width:
        raise ValueError(f"{samples} samples of maps {width} wide do not divide the {rows} rows")
    y = x2d.new_empty((rows * up * up, chans))
    with torch.cuda.device(x2d.device):
        rc = _cbn_entry()(x2d.data_ptr(), inv.data_ptr(), shift.data_ptr(), y.data_ptr(),
                          samples, rows // samples, width, chans, _DTYPES[x2d.dtype], up,
                          torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jckx_cbn_act failed with CUDA error {rc}")
    return y


@torch.library.custom_op("jckx_torch::cbn_normalize_act", mutates_args=())
def cbn_normalize_act_op(x2d: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor, width: int,
                         up: int) -> torch.Tensor:
    """``cbn_normalize_act`` on a CUDA tensor, ``cbn_normalize_act_plain`` on
    a CPU one (the kernel has no CPU form)."""
    if x2d.device.type == "cuda":
        return cbn_normalize_act(x2d, inv, shift, width, up)
    return cbn_normalize_act_plain(x2d, inv, shift, width, up)


@cbn_normalize_act_op.register_fake
def _cbn_normalize_act_fake(x2d, inv, shift, width, up):
    return x2d.new_empty((x2d.shape[0] * up * up, x2d.shape[1]))


@torch.library.custom_op("jckx_torch::normalize_act", mutates_args=())
def normalize_act_op(x2d: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor, act: str,
                     negative_slope: float) -> torch.Tensor:
    """``normalize_act`` on a CUDA tensor, ``normalize_act_plain`` on a CPU
    one (the kernel has no CPU form)."""
    if x2d.device.type == "cuda":
        return normalize_act(x2d, inv, shift, act, negative_slope)
    return normalize_act_plain(x2d, inv, shift, act, negative_slope)


@normalize_act_op.register_fake
def _normalize_act_fake(x2d, inv, shift, act, negative_slope):
    return torch.empty_like(x2d)


def bn_act(x, scale, bias, act="none", negative_slope=0.2, eps=1e-5, mesh=None, axis="data"):
    """Batch-stat BN fused with activation. See the module docstring."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return bn_act_plain(x, scale, bias, act, negative_slope, eps, mesh, axis)
    if (x.device.type == "cuda" and x.dim() == 4
            and not x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("bn_act on the card needs a channels_last NCHW tensor")
    x2d = _rows(x)
    inv, shift = _affine(x2d, scale, bias, eps, mesh, axis)
    return _unrows(normalize_act_op(x2d, inv, shift, act, negative_slope), x)


def _cbn_affine(x2d, scale, bias, eps):
    """The conditional BN's (N, C) f32 ``inv`` = scale · rstd and ``shift``
    = bias − mean · inv from x's batch statistics (``_stats``)."""
    mean, var = _stats(x2d)
    inv = torch.rsqrt(var + eps)[None] * scale.float()
    return inv, bias.float() - mean[None] * inv


def _cbn_out(y2d: torch.Tensor, like: torch.Tensor, up: int) -> torch.Tensor:
    """The NCHW (channels_last) view of a conditional BN's rows, its map
    ``up`` times ``like``'s."""
    n, c, h, w = like.shape
    return y2d.reshape(n, up * h, up * w, c).permute(0, 3, 1, 2)


def cbn_act_plain(x, scale, bias, eps=1e-5, up=1):
    """Class-conditional batch-stat BN + ReLU in plain PyTorch: x (NCHW)
    normalized by its batch statistics, then ``relu(x̂ · scale[n] +
    bias[n])`` for sample n (``scale``, ``bias`` (N, C)); with ``up`` 2 the
    result upsampled ×2 by nearest neighbour."""
    x2d = _rows(x)
    inv, shift = _cbn_affine(x2d, scale, bias, eps)
    y = cbn_normalize_act_plain(x2d, inv, shift, x.shape[3], up)
    return _cbn_out(y, x, up)


def cbn_act_one_rounding(x, scale, bias, eps=1e-5, up=1):
    """``cbn_act_plain`` with the kernel's rounding: the multiply-add in f64,
    rounded once to f32, as ``bn_act_one_rounding``."""
    x2d = _rows(x)
    inv, shift = _cbn_affine(x2d, scale, bias, eps)
    n, chans = inv.shape
    y = (x2d.double().reshape(n, -1, chans) * inv.double()[:, None]
         + shift.double()[:, None]).float()
    y = torch.relu(y).reshape(x2d.shape).to(x2d.dtype)
    return _cbn_out(_up_rows(y, n, x.shape[3], up), x, up)


def cbn_act(x, scale, bias, eps=1e-5, up=1):
    """Class-conditional batch-stat BN fused with ReLU, and with the
    nearest ×2 upsampling of its output where ``up`` is 2: ``bn_act``'s
    route by grad mode, with a (N, C) scale and bias (module docstring). x
    is NCHW, channels_last on the card."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return cbn_act_plain(x, scale, bias, eps, up)
    if x.dim() != 4 or (x.device.type == "cuda"
                        and not x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("cbn_act needs an NCHW tensor, channels_last on the card")
    x2d = _rows(x)
    inv, shift = _cbn_affine(x2d, scale, bias, eps)
    return _cbn_out(cbn_normalize_act_op(x2d, inv, shift, x.shape[3], up), x, up)
