"""BigGAN's generator at 128² — Brock, Donahue and Simonyan, "Large Scale
GAN Training for High Fidelity Natural Image Synthesis" (arXiv:1809.11096,
appendix B), as the authors' BigGAN-PyTorch builds it (``BigGAN.py``,
``layers.py``: ``G_ch`` 96, ``dim_z`` 120, hierarchical z, a shared class
embedding of 128, attention at 64², 1,000 classes). The port serves it; it
does not train it.

The forward, with SN(W) = W / σ(W) (σ the largest singular value of W
reshaped to (out, −1)) and up2 the nearest ×2 upsampling:

1. z (N, 120) splits into six chunks z₀ … z₅ of 20; e = onehot @ E, the
   shared embedding (K × 128, no SN).
2. Stem: SN-Linear(20 → 4·4·16ch)(z₀), viewed as (N, 16ch, 4, 4).
3. Five GBlocks, (C_in, C_out) = ch · (16, 16), (16, 8), (8, 4), (4, 2),
   (2, 1); block i takes the condition cᵢ = [e, zᵢ₊₁] (148 wide) and
   computes t = SN-Conv3×3(up2(ReLU(CBN₁(x; cᵢ)))), t = SN-Conv3×3(ReLU(CBN₂(t;
   cᵢ))), x ← t + SN-Conv1×1(up2(x)), each convolution with a bias.
4. CBN(x; c) = x̂ · (1 + SN-Linear_g(c)) + SN-Linear_b(c), both Linears
   148 → C with a bias, x̂ batch-normalized with no affine (biased
   variance, ε = 1e-5): an affine a sample and a channel.
5. After the block whose output is 64² (C = 192), self-attention: θ =
   SN-Conv1×1(C → C/8)(x), φ = maxpool2(SN-Conv1×1(C → C/8)(x)), g =
   maxpool2(SN-Conv1×1(C → C/2)(x)), β = softmax over j of θᵢᵀφⱼ (no 1/√d),
   x ← x + γ · SN-Conv1×1(C/2 → C)(g βᵀ); none of the four has a bias.
6. ReLU(BN(x)) with its own affine over ch channels, SN-Conv3×3(ch → 3,
   bias), tanh.

How the port computes it (``forward``): activations are NCHW-logical
tensors in ``torch.channels_last`` memory, as in ``models/dcgan.py``, so
the BN kernels read each as ``(N·H·W, C)`` rows without a copy. The ten
conditional BNs run through ``kernels/fused_bn_act.cbn_act`` (the
statistics kernels, then the conditional normalize kernel on the card),
the output BN through ``bn_act``, the attention's product through
``ops/attention.attention`` (a fused route on the card that never
materializes the scores). Rewrites that change no value in exact
arithmetic, each to spare a pass over a map:

- a block's first CBN writes its output upsampled (``cbn_act(up=2)``:
  the kernel stores each value to its 2×2 block), so no upsampling pass
  runs on that path;
- the shortcut takes its 1×1 convolution before the upsampling (a 1×1
  convolution and a nearest upsampling commute: a quarter of the work),
  and is added to t in place, never upsampled itself
  (``kernels/up2_add.py``: a kernel on the card); the second
  convolution's bias rides on the shortcut's (both are added to the same
  sum);
- the first convolution's bias is not added: the batch-statistic CBN that
  follows subtracts its channel's mean, which moves by exactly that bias,
  and its variance does not move, so BN(t + b) = BN(t);
- γ is folded into the attention's output convolution, and each block's
  four CBN Linears are one product on the condition.

The CBN Linears and the BN affines run in f32 (the affine the kernels take
is f32), everything else in the compute dtype.

Spectral norm is folded when a dtype is first used on a device
(``_serving``): each SN'd weight is divided by its stored σ once, in f32,
then cast to the compute dtype (channels_last where it is a 3×3
convolution's), as BigGAN-PyTorch's eval mode divides by its stored σ; no
power iteration runs. The folded copy is kept until the module moves or
loads new weights.

Parameters carry BigGAN-PyTorch's state-dict names (``shared.weight``,
``linear.*``, ``blocks.{i}.0.{bn1,conv1,bn2,conv2,conv_sc}.*``, the
attention's ``blocks.{i}.1.{theta,phi,g,o}.weight`` and ``gamma``,
``output_layer.0.{gain,bias}``, ``output_layer.2.*``), each SN'd layer
its σ as the buffer ``sv0``. The port keeps no power-iteration vector
(``u0``) and no stored BN statistics: serving takes batch statistics.
Until a state dict is loaded the parameters are zero.

Spans (``utils/spans.py``): ``biggan.block`` around each GBlock (``n`` its
output's rows, N·H·W), ``biggan.attention`` around the attention (``n``
images).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from jckx_torch.kernels.fused_bn_act import bn_act, cbn_act
from jckx_torch.kernels.up2_add import up2_add_op
from jckx_torch.models.dcgan import require_form
from jckx_torch.ops.attention import attention
from jckx_torch.utils import spans

# each block's (C_in, C_out) over ch, by resolution (BigGAN-PyTorch's G_arch)
ARCH = {128: ((16, 16, 8, 4, 2), (16, 8, 4, 2, 1))}
BOTTOM = 4      # the stem's map is 4 × 4
BN_EPS = 1e-5


@dataclass(frozen=True)
class BigGANGeometry:
    """BigGAN's shape. ``base_width`` is the paper's ch (``G_ch``);
    ``attention`` the resolution of the block output that attention
    follows (0: none)."""

    z_dim: int = 120
    image_size: int = 128
    channels: int = 3
    base_width: int = 96
    shared_dim: int = 128
    attention: int = 64

    def __post_init__(self):
        if self.image_size not in ARCH:
            raise ValueError(f"BigGAN image_size {self.image_size}: the port builds "
                             f"{sorted(ARCH)}")
        if self.z_dim % (self.n_blocks + 1):
            raise ValueError(f"BigGAN z_dim {self.z_dim} does not split into "
                             f"{self.n_blocks + 1} chunks")
        outs = [BOTTOM * 2 ** (i + 1) for i in range(self.n_blocks)]
        if self.attention and self.attention not in outs:
            raise ValueError(f"BigGAN attention at {self.attention}: no block outputs it "
                             f"({outs})")

    @property
    def n_blocks(self) -> int:
        return len(ARCH[self.image_size][0])

    @property
    def z_chunk(self) -> int:
        return self.z_dim // (self.n_blocks + 1)

    def block_widths(self) -> list:
        """Each block's (C_in, C_out)."""
        ins, outs = ARCH[self.image_size]
        return [(self.base_width * a, self.base_width * b) for a, b in zip(ins, outs)]

    def attention_block(self) -> int:
        """The index of the block that attention follows, −1 for none."""
        for i in range(self.n_blocks):
            if BOTTOM * 2 ** (i + 1) == self.attention:
                return i
        return -1


class _SN(nn.Module):
    """A spectrally normalized layer: ``weight``, ``bias`` where it has one,
    and its stored σ, ``sv0`` (BigGAN-PyTorch's name)."""

    def __init__(self, shape, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape))
        if bias:
            self.bias = nn.Parameter(torch.zeros(shape[0]))
        self.register_buffer("sv0", torch.ones(1))

    def folded(self) -> torch.Tensor:
        """The weight over its stored σ, in f32."""
        return self.weight.float() / self.sv0.float()


class _CCBN(nn.Module):
    """A conditional BN's two SN-Linears, condition → C."""

    def __init__(self, cond: int, chans: int):
        super().__init__()
        self.gain = _SN((chans, cond))
        self.bias = _SN((chans, cond))


class _GBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cond: int):
        super().__init__()
        self.bn1 = _CCBN(cond, cin)
        self.conv1 = _SN((cout, cin, 3, 3))
        self.bn2 = _CCBN(cond, cout)
        self.conv2 = _SN((cout, cout, 3, 3))
        self.conv_sc = _SN((cout, cin, 1, 1))


class _Attention(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.theta = _SN((ch // 8, ch, 1, 1), bias=False)
        self.phi = _SN((ch // 8, ch, 1, 1), bias=False)
        self.g = _SN((ch // 2, ch, 1, 1), bias=False)
        self.o = _SN((ch, ch // 2, 1, 1), bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))


class _OutBN(nn.Module):
    """The output BN's affine (BigGAN-PyTorch's ``layers.bn``: ``gain``, ``bias``)."""

    def __init__(self, chans: int):
        super().__init__()
        self.gain = nn.Parameter(torch.ones(chans))
        self.bias = nn.Parameter(torch.zeros(chans))


class _Embedding(nn.Module):
    def __init__(self, classes: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(classes, dim))


class BigGANGenerator(nn.Module):
    """BigGAN's G (module docstring). ``forward`` takes z and the class
    one-hot as ``CGenerator`` does. It is served in the float form alone
    (``forms``): it has no transposed convolution for the sub-pixel form or
    the int8 sampler, no mesh layout, and no ``.pt2`` export."""

    family, forms = "BigGAN", frozenset({"float"})

    def __init__(self, geo: BigGANGeometry = BigGANGeometry(), num_classes: int = 1000):
        super().__init__()
        self.geo, self.num_classes = geo, num_classes
        widths = geo.block_widths()
        cond = geo.shared_dim + geo.z_chunk
        self.shared = _Embedding(num_classes, geo.shared_dim)
        self.linear = _SN((BOTTOM * BOTTOM * widths[0][0], geo.z_chunk))
        self.blocks = nn.ModuleList()
        for i, (cin, cout) in enumerate(widths):
            inner = nn.ModuleList([_GBlock(cin, cout, cond)])
            if i == geo.attention_block():
                inner.append(_Attention(cout))
            self.blocks.append(inner)
        self.output_layer = nn.Sequential(_OutBN(widths[-1][1]), nn.ReLU(),
                                          _SN((geo.channels, widths[-1][1], 3, 3)))
        self._cache: Dict[Tuple, Dict[str, torch.Tensor]] = {}

    def _apply(self, fn, *args, **kwargs):
        self._cache = {}  # moved or cast: fold again
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        self._cache = {}
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def _fold(self, dtype) -> Dict[str, torch.Tensor]:
        """The weights as the forward reads them (module docstring)."""
        def conv(m):
            return m.folded().to(dtype).contiguous(memory_format=torch.channels_last)

        out = {"shared": self.shared.weight.to(dtype),
               "linear.weight": self.linear.folded().to(dtype),
               "linear.bias": self.linear.bias.to(dtype)}
        for i, inner in enumerate(self.blocks):
            b, p = inner[0], f"blocks.{i}.0."
            lin = (b.bn1.gain, b.bn1.bias, b.bn2.gain, b.bn2.bias)
            out[p + "cbn.weight"] = torch.cat([m.folded() for m in lin])
            out[p + "cbn.bias"] = torch.cat([m.bias.float() for m in lin])
            for name in ("conv1", "conv2", "conv_sc"):
                out[p + name + ".weight"] = conv(getattr(b, name))
            out[p + "conv_sc.bias"] = (b.conv_sc.bias.float() + b.conv2.bias.float()).to(dtype)
            if len(inner) > 1:
                at, a = inner[1], f"blocks.{i}.1."
                out[a + "theta.weight"] = conv(at.theta)
                out[a + "phig.weight"] = torch.cat([at.phi.folded(), at.g.folded()]).to(
                    dtype).contiguous(memory_format=torch.channels_last)
                out[a + "o.weight"] = (at.gamma.float() * at.o.folded()).to(dtype).contiguous(
                    memory_format=torch.channels_last)
        last = self.output_layer[2]
        out["output.weight"], out["output.bias"] = conv(last), last.bias.to(dtype)
        return out

    def _serving(self, dtype, device) -> Dict[str, torch.Tensor]:
        """The folded weights for ``dtype`` on ``device``, made on first use
        (as ordinary tensors, also when the first call runs in inference
        mode)."""
        key = (dtype, torch.device(device))
        if key not in self._cache:
            with torch.inference_mode(False), torch.no_grad():
                self._cache = {key: self._fold(dtype)}
        return self._cache[key]

    def _block(self, i: int, x: torch.Tensor, cond: torch.Tensor, w: dict) -> torch.Tensor:
        p = f"blocks.{i}.0."
        n, cin, hgt, wid = x.shape
        cout = w[p + "conv1.weight"].shape[0]
        with spans.span("biggan.block", n * 4 * hgt * wid):
            aff = F.linear(cond, w[p + "cbn.weight"], w[p + "cbn.bias"])
            g1, b1, g2, b2 = aff.split([cin, cin, cout, cout], dim=1)
            h = cbn_act(x, 1.0 + g1, b1, eps=BN_EPS, up=2)
            h = F.conv2d(h, w[p + "conv1.weight"], padding=1)  # its bias cancels in the CBN
            h = cbn_act(h, 1.0 + g2, b2, eps=BN_EPS)
            h = F.conv2d(h, w[p + "conv2.weight"], padding=1)
            sc = F.conv2d(x, w[p + "conv_sc.weight"], w[p + "conv_sc.bias"])
            up2_add_op(h, sc)
            return h

    def _attention(self, i: int, x: torch.Tensor, w: dict) -> torch.Tensor:
        a = f"blocks.{i}.1."
        n, _, hgt, wid = x.shape
        with spans.span("biggan.attention", n):
            theta = F.conv2d(x, w[a + "theta.weight"])
            pooled = F.max_pool2d(F.conv2d(x, w[a + "phig.weight"]), 2)
            d = theta.shape[1]
            q = theta.permute(0, 2, 3, 1).reshape(n, hgt * wid, d)
            kv = pooled.permute(0, 2, 3, 1).reshape(n, hgt * wid // 4, pooled.shape[1])
            o = attention(q, kv[..., :d], kv[..., d:])
            o = o.reshape(n, hgt, wid, o.shape[-1]).permute(0, 3, 1, 2)
            return x.add_(F.conv2d(o, w[a + "o.weight"]))  # γ is in o's weight

    def forward(self, z: torch.Tensor, labels_onehot: torch.Tensor, compute_dtype=torch.float32,
                subpixel: bool = False, mesh=None, par=None) -> torch.Tensor:
        """z (N, z_dim) or (N, 1, 1, z_dim), class weights (N, K) (a one-hot,
        or a lerp of two) → images (N, S, S, C) in [-1, 1] in
        ``compute_dtype``. ``subpixel``, ``mesh`` and ``par`` (the DCGAN
        generators' options) raise: none is among its ``forms``."""
        if subpixel:
            require_form(self, "subpixel")
        if mesh is not None or par is not None:
            require_form(self, "mesh")
        geo, dt = self.geo, compute_dtype
        w = self._serving(dt, z.device)
        n = z.shape[0]
        chunks = z.reshape(n, -1).to(dt).split(geo.z_chunk, dim=1)
        e = labels_onehot.to(dt) @ w["shared"]
        x = F.linear(chunks[0], w["linear.weight"], w["linear.bias"])
        x = x.reshape(n, -1, BOTTOM, BOTTOM).contiguous(memory_format=torch.channels_last)
        for i, inner in enumerate(self.blocks):
            x = self._block(i, x, torch.cat([e, chunks[i + 1]], dim=1).float(), w)
            if len(inner) > 1:
                x = self._attention(i, x, w)
        out_bn = self.output_layer[0]
        x = bn_act(x, out_bn.gain, out_bn.bias, "relu", eps=BN_EPS)
        x = F.conv2d(x, w["output.weight"], w["output.bias"], padding=1)
        return torch.tanh(x.float()).to(dt).permute(0, 2, 3, 1)


def biggan_geometry(sd: dict) -> Optional[Tuple[BigGANGeometry, int]]:
    """A generator state dict → (its BigGAN geometry, its class count), or
    None where it is not a BigGAN's (no ``shared.weight`` beside
    ``blocks.0.0.conv1.weight``). Every size comes from the weights."""
    if "shared.weight" not in sd or "blocks.0.0.conv1.weight" not in sd:
        return None
    n_blocks = sum(1 for k in sd if k.startswith("blocks.") and k.endswith(".0.conv1.weight"))
    attn = [i for i in range(n_blocks) if f"blocks.{i}.1.theta.weight" in sd]
    classes, shared_dim = sd["shared.weight"].shape
    out_w = sd["output_layer.2.weight"]
    geo = BigGANGeometry(z_dim=sd["linear.weight"].shape[1] * (n_blocks + 1),
                         image_size=BOTTOM * 2 ** n_blocks, channels=out_w.shape[0],
                         base_width=out_w.shape[1], shared_dim=shared_dim,
                         attention=BOTTOM * 2 ** (attn[0] + 1) if attn else 0)
    return geo, int(classes)
