"""The plain reference of BigGAN's generator at 128²: PyTorch operations on
a dict of named tensors, float32, NCHW, with TF32 off. It imports nothing
of the program.

The net is Brock, Donahue and Simonyan's (arXiv:1809.11096, appendix B's
128×128 architecture), as BigGAN-PyTorch builds it (``BigGAN.py``,
``layers.py``: ``G_ch`` = ch, hierarchical z, a shared embedding), written
from its equations under BigGAN-PyTorch's state-dict names, with SN(W) = W
/ σ, σ the stored largest singular value of W reshaped to (out, −1) (the
buffer ``<layer>.sv0``), and up2 the nearest ×2 upsampling:

- z (N, z_dim) splits into ``z_chunks`` chunks; e = onehot @ E
  (``shared.weight``, no SN);
- the stem SN-Linear(chunk → 4·4·16ch)(z₀) with a bias, viewed (N, 16ch,
  4, 4);
- five GBlocks, (C_in, C_out) = ch · (16, 16), (16, 8), (8, 4), (4, 2),
  (2, 1), each with its condition cᵢ = [e, zᵢ₊₁]: t = SN-Conv3×3(up2(ReLU(
  CBN₁(x; cᵢ)))), t = SN-Conv3×3(ReLU(CBN₂(t; cᵢ))), x ← t +
  SN-Conv1×1(up2(x)), each convolution with a bias; CBN(x; c) = x̂ · (1 +
  SN-Linear_g(c)) + SN-Linear_b(c), the Linears with a bias, x̂ the batch
  statistics' normalization (biased variance, ε ``bn_eps``) with no affine;
- after the block whose output is ``attention`` wide (64²): θ, φ, g by
  bias-free SN-Conv1×1 (C → C/8, C/8, C/2), φ and g max-pooled 2×2, the
  softmax over the pooled positions of θᵢᵀφⱼ materialized (no 1/√d), x ← x
  + γ · SN-Conv1×1(C/2 → C)(g βᵀ);
- ReLU(BN(x)) with its own affine (``output_layer.0.gain`` / ``.bias``),
  SN-Conv3×3(ch → 3) with a bias, tanh; images NHWC.

A batch is computed whole: batch statistics cannot be split by rows.

Departures from BigGAN-PyTorch, each the configuration's (``assumed``):
the CBN Linears carry a bias (its shared-embedding build has none, and
counts 70,433,988 parameters where this counts 70,448,772); σ is stored,
never power-iterated; no standing statistics. The weights come from the
seed (``make_weights``): every parameter N(0, 1) in one draw on the device
(SN'd weights, E, the biases, the output BN's affine), so that a wrong
index into a bias shows, and γ = sign(u) · (1 + |u|) of its draw u, so
that the attention moves the images well beyond bfloat16's rounding and a
left-out attention shows (at |γ| 0.2–0.4 it moved them by 1–3 LSB, as
little as the program's own rounding); each SN'd weight's σ is computed
exactly, ``torch.linalg.matrix_norm(W.reshape(out, -1).double(), 2)``.
BigGAN's own init is orthogonal, with zero biases and γ = 0.

``precision="fp8"`` is the control: every product's operands and results
(the Linears, the convolutions, the attention's two batched products and
its softmax's weights) and every activation they give rounded to e4m3
under a per-tensor scale (``gan._round``), the statistics f32. ``fault``
plants one of this model's faults: ``"nocond"`` leaves the class condition
out (gain 1 and shift 0 in every CBN), ``"noattn"`` the attention (γ · o
dropped).

``forward_flops`` counts a forward's operations by ``FlopCounterMode`` on
the meta device; ``bn_layer_bytes`` / ``bn_bytes`` the least bytes G's
eleven BN layers move (x read once, y written once as the next convolution
reads it, ×2 upsampled after each block's first, their (N, C) and (C,)
vectors);
``attention_flops`` / ``attention_bytes`` the attention product's work at
its published widths.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.gan import _round, no_tf32

Params = Dict[str, torch.Tensor]
ARCH = {128: ((16, 16, 8, 4, 2), (16, 8, 4, 2, 1))}  # BigGAN-PyTorch's G_arch over ch
BOTTOM = 4
META = torch.device("meta")


def blocks(cfg: dict) -> list:
    """Each GBlock's (C_in, C_out)."""
    ins, outs = ARCH[cfg["image_size"]]
    return [(cfg["ch"] * a, cfg["ch"] * b) for a, b in zip(ins, outs)]


def attention_block(cfg: dict) -> int:
    """The block after which attention runs (its output ``attention`` wide)."""
    return [BOTTOM * 2 ** (i + 1) for i in range(len(blocks(cfg)))].index(cfg["attention"])


def z_chunk(cfg: dict) -> int:
    if cfg["z_chunks"] != len(blocks(cfg)) + 1 or cfg["z_dim"] % cfg["z_chunks"]:
        raise ValueError(f"z {cfg['z_dim']} in {cfg['z_chunks']} chunks: BigGAN's "
                         f"hierarchical z has one chunk a block and one for the stem")
    return cfg["z_dim"] // cfg["z_chunks"]


def param_shapes(cfg: dict) -> dict:
    """{"g": {name: shape}}: G's parameters (the σ buffers aside)."""
    widths, cond = blocks(cfg), cfg["shared_dim"] + z_chunk(cfg)
    g = {"shared.weight": (cfg["num_classes"], cfg["shared_dim"]),
         "linear.weight": (BOTTOM * BOTTOM * widths[0][0], z_chunk(cfg)),
         "linear.bias": (BOTTOM * BOTTOM * widths[0][0],)}
    for i, (cin, cout) in enumerate(widths):
        p = f"blocks.{i}.0."
        for bn, c in (("bn1", cin), ("bn2", cout)):
            for part in ("gain", "bias"):
                g[f"{p}{bn}.{part}.weight"], g[f"{p}{bn}.{part}.bias"] = (c, cond), (c,)
        for name, shape in (("conv1", (cout, cin, 3, 3)), ("conv2", (cout, cout, 3, 3)),
                            ("conv_sc", (cout, cin, 1, 1))):
            g[f"{p}{name}.weight"], g[f"{p}{name}.bias"] = shape, (cout,)
        if i == attention_block(cfg):
            a = f"blocks.{i}.1."
            g[a + "theta.weight"] = g[a + "phi.weight"] = (cout // 8, cout, 1, 1)
            g[a + "g.weight"] = (cout // 2, cout, 1, 1)
            g[a + "o.weight"] = (cout, cout // 2, 1, 1)
            g[a + "gamma"] = ()
    ch = widths[-1][1]
    g["output_layer.0.gain"] = g["output_layer.0.bias"] = (ch,)
    g["output_layer.2.weight"], g["output_layer.2.bias"] = (cfg["channels"], ch, 3, 3), \
        (cfg["channels"],)
    return {"g": g}


def sn_layers(cfg: dict) -> list:
    """The spectrally normalized layers: every ``<layer>.weight`` but E's."""
    return [k[:-len(".weight")] for k in param_shapes(cfg)["g"]
            if k.endswith(".weight") and k != "shared.weight"]


def sigma(w: torch.Tensor) -> torch.Tensor:
    """The largest singular value of ``w`` reshaped to (out, −1), exact (in
    f64), as a (1,) f32 tensor."""
    return torch.linalg.matrix_norm(w.reshape(w.shape[0], -1).double(), 2).float().reshape(1)


def make_weights(cfg: dict, seed: int, device) -> Params:
    """G's parameters from ``seed`` in one N(0, 1) draw on ``device``, and
    each SN'd layer's exact σ as ``<layer>.sv0`` (module docstring)."""
    shapes = param_shapes(cfg)["g"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).clone()
        at += n
        if name.endswith("gamma"):
            out[name] = out[name].sign() * (1.0 + out[name].abs())
    for layer in sn_layers(cfg):
        out[layer + ".sv0"] = sigma(out[layer + ".weight"])
    return out


def write_checkpoint(path: str, g: Params) -> None:
    """The file the program's loader reads: the reference trainers' dict
    with G's state dict under ``model_g`` and no D."""
    torch.save({"model_g": {k: v.cpu() for k, v in g.items()}, "model_d": {}}, path)


def read_checkpoint(path: str, device) -> Params:
    """G's weights and σ from such a file, f32 on ``device``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)["model_g"]
    return {k: v.float().to(device) for k, v in sd.items()}


def _sn(g: Params, layer: str) -> torch.Tensor:
    return g[layer + ".weight"] / g[layer + ".sv0"]


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def generator(g: Params, cfg: dict, z: torch.Tensor, onehot: torch.Tensor,
              precision: str = "f32", fault: str = "") -> torch.Tensor:
    """z (N, z_dim), one-hot labels (N, K) → images (N, S, S, C) in [-1, 1]."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision {precision!r}: f32 or fp8")
    if fault not in ("", "nocond", "noattn"):
        raise ValueError(f"fault {fault!r}: '', 'nocond' or 'noattn'")
    no_tf32()

    def q(t):
        return t if precision == "f32" else _round(t, torch.float8_e4m3fn)

    def linear(x, layer):
        return q(F.linear(q(x), q(_sn(g, layer)), g[layer + ".bias"]))

    def conv(x, layer, pad=0, bias=True):
        return q(F.conv2d(q(x), q(_sn(g, layer)), g[layer + ".bias"] if bias else None,
                          padding=pad))

    def cbn(x, c, bn):
        x = _norm(x, cfg["bn_eps"])
        if fault == "nocond":
            return x
        gain, bias = linear(c, bn + ".gain"), linear(c, bn + ".bias")
        return x * (1.0 + gain[:, :, None, None]) + bias[:, :, None, None]

    n = z.shape[0]
    chunks = z.split(z_chunk(cfg), dim=1)
    e = q(q(onehot) @ q(g["shared.weight"]))
    x = linear(chunks[0], "linear").reshape(n, -1, BOTTOM, BOTTOM)
    for i in range(len(blocks(cfg))):
        p, c = f"blocks.{i}.0.", torch.cat([e, chunks[i + 1]], dim=1)
        t = conv(_up2(torch.relu(cbn(x, c, p + "bn1"))), p + "conv1", 1)
        t = conv(torch.relu(cbn(t, c, p + "bn2")), p + "conv2", 1)
        x = t + conv(_up2(x), p + "conv_sc")
        if i == attention_block(cfg) and fault != "noattn":
            a = f"blocks.{i}.1."
            _, _, hgt, wid = x.shape
            theta = conv(x, a + "theta", bias=False).reshape(n, -1, hgt * wid)
            phi = F.max_pool2d(conv(x, a + "phi", bias=False), 2).reshape(n, -1, hgt * wid // 4)
            gg = F.max_pool2d(conv(x, a + "g", bias=False), 2).reshape(n, -1, hgt * wid // 4)
            beta = torch.softmax(q(torch.bmm(q(theta).transpose(1, 2), q(phi))), dim=-1)
            o = q(torch.bmm(q(gg), q(beta).transpose(1, 2))).reshape(n, -1, hgt, wid)
            x = x + g[a + "gamma"] * conv(o, a + "o", bias=False)
    x = _norm(x, cfg["bn_eps"]) * g["output_layer.0.gain"][:, None, None] \
        + g["output_layer.0.bias"][:, None, None]
    x = conv(torch.relu(x), "output_layer.2", 1)
    return torch.tanh(x).permute(0, 2, 3, 1)


def forward_flops(cfg: dict, batch: int) -> int:
    """Operations of one forward of ``batch`` images, counted on meta."""
    shapes = param_shapes(cfg)["g"]
    g = {k: torch.empty(tuple(s), device=META) for k, s in shapes.items()}
    g.update({layer + ".sv0": torch.empty(1, device=META) for layer in sn_layers(cfg)})
    z = torch.empty((batch, cfg["z_dim"]), device=META)
    onehot = torch.empty((batch, cfg["num_classes"]), device=META)
    with FlopCounterMode(display=False) as counter:
        generator(g, cfg, z, onehot)
    return int(counter.get_total_flops())


def bn_layers(cfg: dict) -> list:
    """G's BN layers in order: (side, channels, conditional, up), ``up`` 2
    where the next convolution reads the layer's output upsampled ×2 (each
    block's first), else 1."""
    out, side = [], BOTTOM
    for cin, cout in blocks(cfg):
        out += [(side, cin, True, 2), (2 * side, cout, True, 1)]
        side *= 2
    return out + [(side, blocks(cfg)[-1][1], False, 1)]


def bn_layer_bytes(cfg: dict, batch: int, element_bytes: int) -> list:
    """Each BN layer's least bytes in one forward of ``batch`` images, in
    ``bn_layers``' order: x read once and y written once as the next
    convolution reads it (up² times the layer's own map where it is
    upsampled), ``element_bytes`` an element; its (C,) f32 pair read once
    (the sums, or a per-channel layer's scale and shift), and a conditional
    layer's (N, C) f32 scale and shift, whatever computes them."""
    out = []
    for side, c, conditional, up in bn_layers(cfg):
        elements = batch * side * side * c
        out.append((1 + up * up) * elements * element_bytes + 2 * c * 4
                   + (2 * batch * c * 4 if conditional else 0))
    return out


def bn_bytes(cfg: dict, batch: int, element_bytes: int) -> int:
    """The least bytes G's eleven BN layers move in one forward of
    ``batch`` images (``bn_layer_bytes``)."""
    return sum(bn_layer_bytes(cfg, batch, element_bytes))


def _attention_shape(cfg: dict) -> tuple:
    """(L, M, d, dv): positions, pooled positions, θ's and g's widths."""
    c = blocks(cfg)[attention_block(cfg)][1]
    side = cfg["attention"]
    return side * side, side * side // 4, c // 8, c // 2


def attention_flops(cfg: dict) -> int:
    """The attention's two batched products for one image, at its published
    widths: 2·L·M·d (θᵀφ) + 2·L·M·dv (g βᵀ)."""
    length, pooled, d, dv = _attention_shape(cfg)
    return 2 * length * pooled * (d + dv)


def attention_bytes(cfg: dict, element_bytes: int) -> int:
    """The least bytes of the attention product for one image: θ, φ and g
    read once, its output written once."""
    length, pooled, d, dv = _attention_shape(cfg)
    return (length * d + pooled * d + pooled * dv + length * dv) * element_bytes
