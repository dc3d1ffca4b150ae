"""Int8 (W8A8) post-training quantization of the serving generator — port
of ``jckx/ops/quant.py``.

The int8 forward mirrors G layer for layer (``models/dcgan.py``; CGAN's G
is the same stack on [z, one-hot]):

    quantize(act) → int8 ConvTranspose (int32 accumulation) → dequantize →
    BatchNorm (batch statistics, f32) + ReLU → … → tanh (f32)

- Weights: symmetric int8 per OUTPUT channel, scale_c = amax_c / 127 over
  each channel's (Cin, kh, kw) slice; torch's ConvTranspose weight is
  (Cin, Cout, kh, kw), so the amax runs over dims (0, 2, 3).
- Activations: symmetric per-tensor int8 with static scales calibrated from
  a few float probe batches (``calibrate_generator``): divide by the scale,
  round half to even (``torch.round``, as ``jnp.round``), clip to ±127.
- Accumulation: int32 and exact (4·4·512·127² < 2³¹), then one f32
  dequantizing multiply per layer. Batch-statistic BN absorbs any
  per-channel rescale of its input, so the per-channel part of the weight
  error cancels (``jckx/ops/quant.py:25-32``).

The stride-2 layers always take the sub-pixel form (``ops/conv.py``): in
integers the two forms are identical. The int8 convolution lies outside
any Pallas kernel in jckx (``lax.conv_general_dilated`` with an int32
result, ``jckx/ops/quant.py:93-109``), and here it is a library route:

- on the card, im2col and ``torch._int_mm`` (cuBLASLt int8 × int8 →
  int32). Each 2×2 phase's patch matrix is four shifted slices of the
  padded NHWC input side by side, ``(N·H·W, 4·Cin)``; G's first layer (1×1
  input, k4 s1 p0) is one product ``(N, Cin) @ (Cin, 16·Cout)``. ``_int_mm``
  takes more than 16 rows and K and N that are multiples of 8, so rows, K
  and N are padded with zeros, which keeps the result exact (DCGAN's
  in_dim 100 → K 104; the output layer's Cout 3 → N 8; a short
  interpolation row → 32 rows).
- on the CPU, the plain version ``conv_transpose2d_int8_exact``: the same
  convolution in f64 (``F.conv_transpose2d`` / ``F.conv2d``), rounded and
  cast to int32. Exact: every partial sum is an integer below 2⁵³.

The BN + ReLU of the int8 path run on f32 tensors (``jckx/ops/quant.py:208``),
so on the card they take the hand-written kernel's f32 variant: four
launches per G forward, on channels_last tensors.

``make_sampler`` is the one home of the float-vs-int8 dispatch and of the
calibration seed (seed + 0x5ca1e, ``jckx/ops/quant.py:217-230``), shared by
``jckx_torch.serve`` and ``jckx_torch.evaluate --quant``, so the int8
params that ``evaluate --quant int8 --calib_seed s`` scores are, bit for
bit, those that ``serve --quant int8 --seed s`` serves. Its probe batches
come from a CPU ``torch.Generator`` (so they do not depend on the device)
and may be passed in (the tests feed jckx's). Its calibration forwards
take the plain BN composition, as jckx's run outside ``pallas_inference``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from jckx_torch.kernels.fused_bn_act import bn_act, bn_act_plain
from jckx_torch.models.dcgan import GANGeometry
from jckx_torch.ops.conv import (conv_transpose2d, conv_transpose2d_subpixel_k4s2p1,
                                 is_subpixel_layer)

QuantParams = Dict[str, torch.Tensor]
CALIB_SALT = 0x5ca1e
_INT_MM_MIN_ROWS = 32  # _int_mm on the card takes more than 16 rows


# ------------------------------------------------------------- quantizers

def quantize_weight_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Cin, Cout, kh, kw) float → (int8 weights, f32 per-Cout scales).
    A dead (all-zero) channel gets a tiny scale, not 0, so the dequantizing
    multiply stays finite."""
    w = w.detach().float()
    scale = torch.clamp(w.abs().amax(dim=(0, 2, 3)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale[None, :, None, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 with a static (calibrated) scale."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


# --------------------------------------------------- int8 transposed conv

def conv_transpose2d_int8_exact(x: torch.Tensor, w: torch.Tensor, stride: int,
                                padding: int) -> torch.Tensor:
    """The plain version of ``conv_transpose2d_int8``, on any device: f64
    convolutions of the integer values, rounded and cast to int32."""
    xd, wd = x.double(), w.double()
    if is_subpixel_layer(w, stride, padding):
        y = conv_transpose2d_subpixel_k4s2p1(xd, wd)
    else:
        y = conv_transpose2d(xd, wd, stride=stride, padding=padding)
    return torch.round(y).to(torch.int32).contiguous(memory_format=torch.channels_last)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm_padded(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a @ b_t.T`` for int8 ``a`` (M, K) and ``b_t`` (N, K) through
    ``torch._int_mm`` → int32 (M, N). Rows, K and N are zero-padded to what
    ``_int_mm`` takes (M > 16; K, N multiples of 8), which changes no sum."""
    (m, k), n = a.shape, b_t.shape[0]
    kp, mp, npad = _round_up(k, 8), max(m, _INT_MM_MIN_ROWS), _round_up(n, 8)
    a = F.pad(a, (0, kp - k, 0, mp - m)) if (kp, mp) != (k, m) else a
    b_t = F.pad(b_t, (0, kp - k, 0, npad - n)) if (kp, npad) != (k, n) else b_t
    y = torch._int_mm(a.contiguous(), b_t.contiguous().t())  # B column-major
    return y[:m, :n] if (mp, npad) != (m, n) else y


def _conv2x2_int8_int_mm(xp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """One sub-pixel phase on the card: ``xp`` the padded int8 input
    (N, Cin, H+1, W+1), ``k`` its (Cout, Cin, 2, 2) kernel → int32
    (N, Cout, H, W). The patch matrix is four shifted NHWC slices side by
    side, columns (di, dj, ci), against the kernel as (Cout, (di, dj, ci))."""
    n, cin, hp, wp = xp.shape
    h, wd, cout = hp - 1, wp - 1, k.shape[0]
    xh = xp.permute(0, 2, 3, 1)
    a = torch.cat([xh[:, di:di + h, dj:dj + wd, :] for di in (0, 1) for dj in (0, 1)], dim=-1)
    y = int_mm_padded(a.reshape(n * h * wd, 4 * cin), k.permute(0, 2, 3, 1).reshape(cout, 4 * cin))
    return y.reshape(n, h, wd, cout).permute(0, 3, 1, 2)


def _conv_transpose2d_int8_int_mm(x: torch.Tensor, w: torch.Tensor, stride: int,
                                  padding: int) -> torch.Tensor:
    if is_subpixel_layer(w, stride, padding):
        return conv_transpose2d_subpixel_k4s2p1(x, w, conv2x2=_conv2x2_int8_int_mm)
    cin, cout, kh, kw = w.shape
    if x.shape[2:] != (1, 1) or stride != 1 or padding != 0:
        raise ValueError(f"the int8 card route takes k4 s2 p1 or a 1x1 input at s1 p0; got "
                         f"input {tuple(x.shape)}, kernel {kh}x{kw}, stride {stride}, padding {padding}")
    n = x.shape[0]
    # out[n, co, i, j] = sum_ci x[n, ci] * w[ci, co, i, j]: columns (i, j, co)
    y = int_mm_padded(x.reshape(n, cin), w.permute(2, 3, 1, 0).reshape(kh * kw * cout, cin))
    return y.reshape(n, kh, kw, cout).permute(0, 3, 1, 2)


def conv_transpose2d_int8(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """Int8 ConvTranspose2d (torch semantics) with exact int32 accumulation:
    x int8 (N, Cin, H, W), w int8 (Cin, Cout, kh, kw) → int32 (N, Cout, H',
    W') in channels_last memory. On a CPU tensor the f64 plain version; on
    a CUDA tensor ``torch._int_mm``, which raises on what it does not take."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"conv_transpose2d_int8 takes int8 inputs, got {x.dtype} and {w.dtype}")
    if x.device.type == "cpu":
        return conv_transpose2d_int8_exact(x, w, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"conv_transpose2d_int8 runs on the CPU or a CUDA card, not {x.device}")
    return _conv_transpose2d_int8_int_mm(x, w, stride, padding)


# ------------------------------------------------------------- calibration

def generator_act_amax(G, z: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """One float forward of ``G`` (a ``Generator`` or ``CGenerator``) on its
    full input z (N, in_dim) → the amax of every ConvTranspose INPUT,
    stacked (n_up + 1,), f32. BN is the plain composition (see the module
    docstring)."""
    n_up = G.geo.n_up
    x = z.reshape(z.shape[0], -1, 1, 1).to(compute_dtype)
    amaxes: List[torch.Tensor] = []
    for i in range(n_up):
        amaxes.append(x.float().abs().amax())
        stride, pad = (1, 0) if i == 0 else (2, 1)
        x = conv_transpose2d(x, getattr(G, f"conv{i + 1}").weight.to(compute_dtype),
                             stride=stride, padding=pad)
        norm = getattr(G, f"norm{i + 1}")
        x = bn_act_plain(x, norm.weight, norm.bias, act="relu")
    amaxes.append(x.float().abs().amax())
    return torch.stack(amaxes)


def calibration_probes(seed: int, geo: GANGeometry, in_dim: int, batches: int = 4,
                       batch_size: int = 64) -> List[torch.Tensor]:
    """The probe batches of the serving z (and label) distribution, on the
    CPU: each batch its z ~ N(0, 1), then (CGAN, in_dim > z_dim) random
    classes as one-hots on the tail, from one generator seeded with
    ``seed + 0x5ca1e``."""
    gen = torch.Generator().manual_seed(seed + CALIB_SALT)
    ncls = in_dim - geo.z_dim
    out = []
    for _ in range(batches):
        z = torch.randn((batch_size, geo.z_dim), generator=gen)
        if ncls > 0:
            lab = torch.randint(0, ncls, (batch_size,), generator=gen)
            z = torch.cat([z, F.one_hot(lab, ncls).float()], dim=-1)
        out.append(z)
    return out


def calibrate_generator(G, probes: Sequence[torch.Tensor], compute_dtype=torch.float32) -> torch.Tensor:
    """Static activation scales: the running max of each layer's input amax
    over ``probes`` (each (N, in_dim)), → (n_up + 1,) = amax / 127."""
    dev = G.conv1.weight.device
    amax = None
    with torch.inference_mode():
        for z in probes:
            a = generator_act_amax(G, z.to(dev), compute_dtype)
            amax = a if amax is None else torch.maximum(amax, a)
    return torch.clamp(amax, min=1e-12) / 127.0


def quantize_generator(G, act_scales: torch.Tensor) -> QuantParams:
    """Float generator + calibrated activation scales → the int8 serving
    params of ``quantized_generator_apply``, on G's device, under jckx's
    names (``convt{i}_q``, ``convt{i}_wscale``, ``bn{i}_scale``,
    ``bn{i}_bias``, ``a{i}_scale``, ``convt_out_*``)."""
    n_up = G.geo.n_up
    act_scales = act_scales.float()
    if act_scales.shape != (n_up + 1,):
        raise ValueError(f"act_scales must have shape ({n_up + 1},) — one per ConvTranspose "
                         f"input — got {tuple(act_scales.shape)}")
    qp: QuantParams = {}
    for i in range(n_up):
        qp[f"convt{i}_q"], qp[f"convt{i}_wscale"] = quantize_weight_per_channel(
            getattr(G, f"conv{i + 1}").weight)
        norm = getattr(G, f"norm{i + 1}")
        qp[f"bn{i}_scale"] = norm.weight.detach().float()
        qp[f"bn{i}_bias"] = norm.bias.detach().float()
        qp[f"a{i}_scale"] = act_scales[i]
    qp["convt_out_q"], qp["convt_out_wscale"] = quantize_weight_per_channel(
        getattr(G, f"conv{n_up + 1}").weight)
    qp[f"a{n_up}_scale"] = act_scales[n_up]
    return qp


# ------------------------------------------------------------ int8 forward

def _dequantize(y: torch.Tensor, act_scale: torch.Tensor, wscale: torch.Tensor) -> torch.Tensor:
    x = y.float() * (act_scale * wscale)[None, :, None, None]
    return x.contiguous(memory_format=torch.channels_last)


def quantized_generator_apply(qp: QuantParams, z: torch.Tensor, geo: GANGeometry,
                              mesh=None) -> torch.Tensor:
    """Int8 serving forward: z (N, in_dim) → images (N, S, S, C) in [-1, 1],
    f32 (tanh), ready for ``serve.tanh_to_u8``; over ``mesh`` z is this
    member's rows and BN takes the global statistics."""
    x = z.reshape(z.shape[0], -1, 1, 1).float()
    for i in range(geo.n_up):
        a = qp[f"a{i}_scale"]
        stride, pad = (1, 0) if i == 0 else (2, 1)
        y = conv_transpose2d_int8(quantize_act(x, a), qp[f"convt{i}_q"], stride, pad)
        x = bn_act(_dequantize(y, a, qp[f"convt{i}_wscale"]), qp[f"bn{i}_scale"],
                   qp[f"bn{i}_bias"], act="relu", mesh=mesh)
    a = qp[f"a{geo.n_up}_scale"]
    y = conv_transpose2d_int8(quantize_act(x, a), qp["convt_out_q"], 2, 1)
    return torch.tanh(_dequantize(y, a, qp["convt_out_wscale"])).permute(0, 2, 3, 1)


# ----------------------------------------------- serving single-source API


def make_sampler(G, *, quant: Optional[str] = None, compute_dtype=torch.bfloat16, seed: int = 0,
                 subpixel: bool = False, probes: Optional[Sequence[torch.Tensor]] = None):
    """→ ``(params, apply)``; ``apply(params, z, onehot_or_None, mesh=None)``
    renders tanh images (N, S, S, C) (over ``mesh``: this member's rows of a
    sharded batch, with global BN statistics). ``G`` is a loaded ``Generator`` or
    ``CGenerator`` on its device.

    ``quant`` None: the float forward of ``G`` itself in ``compute_dtype``
    (``subpixel``: the stride-2 layers in the sub-pixel form).
    ``quant="int8"``: calibrate on ``probes`` (default: the
    ``calibration_probes`` of ``seed``, 4 batches of 64, never the serving
    batch size, so the scales depend only on the seed), quantize, and
    render with the int8 forward; the one-hot labels are concatenated onto
    z."""
    if quant not in (None, "int8"):
        raise ValueError(f"quant={quant!r}: supported modes are None (float) and 'int8'")
    geo = G.geo
    if quant is None:
        def apply(p, z, onehot=None, mesh=None):
            if onehot is not None:
                return p(z, onehot, compute_dtype, subpixel, mesh)
            return p(z, compute_dtype, subpixel, mesh)

        return G, apply
    if probes is None:
        probes = calibration_probes(seed, geo, G.conv1.weight.shape[0])
    params = quantize_generator(G, calibrate_generator(G, probes, compute_dtype))

    def apply(p, z, onehot=None, mesh=None):
        z = z.reshape(z.shape[0], -1).float()
        if onehot is not None:
            z = torch.cat([z, onehot.to(z.dtype)], dim=-1)
        return quantized_generator_apply(p, z, geo, mesh)

    return params, apply
