"""InceptionV3's eval forward, the FID / IS backbone — port of
``jckx/metrics/inception_v3.py`` (``init``, ``apply``,
``convert_torch_state_dict``).

The graph is written out by hand (the card's machine has no torchvision):
torchvision's ``inception_v3`` with ``aux_logits=False``,
``transform_input=False`` and the classifier replaced by
``Linear(2048, K)``, as the reference builds it (metrics.py:46-52). The
modules carry torchvision's state-dict names (``Mixed_5b.branch1x1.conv
.weight``, ``….bn.running_var``, ``fc.weight``), so a torchvision
checkpoint loads with ``load_state_dict``; the reference's ``fc.0.*``
(a Sequential-wrapped Linear) is renamed by ``from_torchvision``.

Eval (``forward``): each BasicConv2d is conv → BN from its running
statistics at eps 1e-3, folded into one f32 scale and shift
(``:133-138``) → ReLU, in the compute dtype. The pools are jckx's: max 3×3 stride 2, and average
3×3 stride 1 pad 1 counting the padding (``:48-65``). ``fast_stem``
takes the space-to-depth form of ``Conv2d_1a_3x3`` (``stem_s2d``, jckx's
``_bconv_1a_s2d``, ``:141-180``): the same function, summed in another
order.

Train (``forward_train``, jckx's ``apply_train`` and ``_bconv_apply``'s
train branch, ``:109-131, 374-421``): each BasicConv2d is conv →
``ops/norm.bn_relu_train`` (batch statistics; on the card its normalize
pass is the hand kernel), and its running statistics are updated in place
with momentum 0.1 and the unbiased variance, as jckx's ``_BNCtx``; after
the global average pool, dropout p = 0.5 on the f32 features from an
injected keep mask, then the fc. ``to_jckx_flat`` writes the weights in
jckx's flat ``.npz`` layout, the inverse of ``from_jckx_flat``.

``init(seed)`` reproduces jckx's seeded backbone: the same numpy
``RandomState`` draws in the same order (``_bconv_init``, ``:70-89``:
He-scaled normals clipped at ±2, identity BN statistics; then the fc
uniform), so the two packages' seeded backbones are equal.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from jckx_torch.ops.norm import bn_relu_train

BN_EPS = 1e-3


class _Weight(nn.Module):
    def __init__(self, shape):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape), requires_grad=False)


class _BN(nn.Module):
    """``nn.BatchNorm2d``'s state-dict layout."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.conv = _Weight((cout, cin, kh, kw))
        self.bn = _BN(cout)
        self.stride, self.padding = stride, padding
        # set by InceptionV3.forward_train for the length of one call:
        # batch-statistic BN (over bn_mesh's data axis when one is set), and
        # this momentum for the running statistics
        self.bn_momentum: Optional[float] = None
        self.bn_mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.conv.weight.to(x.dtype), stride=self.stride, padding=self.padding)
        if self.bn_momentum is None:
            return self.bn_relu(y, x.dtype)
        mesh = self.bn_mesh
        out, mean, var = bn_relu_train(y, self.bn.weight, self.bn.bias, BN_EPS, mesh)
        n = y.numel() // y.shape[1] * (mesh.size if mesh is not None else 1)
        m, bn = self.bn_momentum, self.bn
        with torch.no_grad():
            bn.running_mean.mul_(1 - m).add_(m * mean)
            bn.running_var.mul_(1 - m).add_(m * (var * (n / max(n - 1, 1))))
        return out

    def bn_relu(self, y: torch.Tensor, dtype, eps: float = BN_EPS) -> torch.Tensor:
        """BN from the running statistics, folded into an f32 scale and
        shift, then ReLU, cast to ``dtype``."""
        bn = self.bn
        inv = torch.rsqrt(bn.running_var.float() + eps) * bn.weight.float()
        shift = bn.bias.float() - bn.running_mean.float() * inv
        y = y.float() * inv[:, None, None] + shift[:, None, None]
        return torch.relu(y).to(dtype)

    def stem_s2d(self, x: torch.Tensor) -> torch.Tensor:
        """This 3×3 stride-2 unpadded convolution (``Conv2d_1a_3x3``) in its
        space-to-depth form: 2×2 pixel blocks become channels (N, 4C, H/2,
        W/2), channels ordered (row in block, column in block, c), and the
        kernel, zero-padded to 4×4, becomes a 2×2 stride-1 kernel over those
        4C channels: output (i, j) reads input rows 2i..2i+2, the s2d rows
        i..i+1. Every tap appears once and the added ones multiply zeros;
        a 48-deep contraction in place of a 27-deep strided one. An odd
        side is padded by one row / column at the end."""
        n, c, h, w = x.shape
        x = F.pad(x, (0, w % 2, 0, h % 2))
        hp, wp = x.shape[2] // 2, x.shape[3] // 2
        y = x.reshape(n, c, hp, 2, wp, 2).permute(0, 3, 5, 1, 2, 4).reshape(n, 4 * c, hp, wp)
        if x.is_cuda:
            y = y.contiguous(memory_format=torch.channels_last)
        wt = self.conv.weight.to(x.dtype)                        # (O, C, 3, 3)
        w4 = F.pad(wt, (0, 1, 0, 1))                             # (O, C, 4, 4): di = 2u + bi
        w2 = w4.reshape(-1, c, 2, 2, 2, 2).permute(0, 3, 5, 1, 2, 4).reshape(-1, 4 * c, 2, 2)
        return self.bn_relu(F.conv2d(y, w2), x.dtype)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


class _AvgPool3x3(torch.autograd.Function):
    """avg_pool2d(3, stride 1, pad 1, count_include_pad) whose backward is
    the same pool applied to the gradient: the operator is a symmetric box
    filter over zero padding, so it is its own adjoint. The card's build of
    torch (2.11.0+cu128) returns a wrong ``avg_pool2d`` gradient (~100 %
    relative error against the sum-of-slices definition) for a
    channels_last input, the layout of the fine-tune's train step; its
    forward is right (``tests/test_torch_gpu.py``)."""

    @staticmethod
    def forward(ctx, x):
        return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)

    @staticmethod
    def backward(ctx, dy):
        return F.avg_pool2d(dy, 3, stride=1, padding=1, count_include_pad=True)


def _avg_pool(x):
    return _AvgPool3x3.apply(x)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for name in ("branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5"):
            bd = getattr(self, name)(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionV3(nn.Module):
    """Modules registered in jckx's ``init`` order, which is torchvision's."""

    def __init__(self, num_classes: int = 100):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32,
                fast_stem: bool = False) -> torch.Tensor:
        """images (N, H, W, 3) NHWC, ImageNet-normalized (H, W ≥ 75; 299 in
        use) → logits (N, K) in f32 — counterpart of ``apply``. ``fast_stem``:
        the first convolution in its space-to-depth form."""
        return self._head(self._pooled(x, compute_dtype, fast_stem))

    def forward_train(self, x: torch.Tensor, dropout_keep: Optional[torch.Tensor] = None,
                      compute_dtype=torch.float32, momentum: float = 0.1,
                      mesh=None) -> torch.Tensor:
        """The train-mode forward (``apply_train``): batch-statistic BN with
        the running statistics updated in place (no gradient), then dropout
        ``where(keep, x / 0.5, 0)`` on the pooled f32 features when
        ``dropout_keep`` (N, 2048) bool is given. → logits (N, K) f32.
        ``mesh``: x is this rank's rows, and every BN takes (and keeps as
        running statistics) the statistics of the global batch."""
        convs = [m for m in self.modules() if isinstance(m, BasicConv2d)]
        for m in convs:
            m.bn_momentum, m.bn_mesh = momentum, mesh
        try:
            x = self._pooled(x, compute_dtype, fast_stem=False)
        finally:
            for m in convs:
                m.bn_momentum = m.bn_mesh = None
        if dropout_keep is not None:
            x = torch.where(dropout_keep, x / 0.5, 0.0)
        return self._head(x)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.fc.weight.float().t() + self.fc.bias.float()

    def _pooled(self, x: torch.Tensor, compute_dtype, fast_stem: bool) -> torch.Tensor:
        """The trunk and the global average pool → (N, 2048) f32."""
        x = x.to(compute_dtype).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        stem = self.Conv2d_1a_3x3
        x = stem.stem_s2d(x) if fast_stem else stem(x)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(x))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)).float()


def init(seed: int = 0, num_classes: int = 100) -> InceptionV3:
    """The seeded backbone of jckx's ``init(seed)``: the same draws, in the
    same order, laid out for torch (HWIO → OIHW, fc (2048, K) → (K, 2048))."""
    net = InceptionV3(num_classes)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BasicConv2d):
                cout, cin, kh, kw = m.conv.weight.shape
                std = math.sqrt(2.0 / (kh * kw * cin))
                w = rng.standard_normal((kh, kw, cin, cout)).astype(np.float32)
                w = np.clip(w, -2.0, 2.0) * std
                m.conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
        bound = 1.0 / math.sqrt(2048)
        w = rng.uniform(-bound, bound, (2048, num_classes)).astype(np.float32)
        net.fc.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
        net.fc.bias.zero_()
    return net


def from_torchvision(state_dict: Dict[str, torch.Tensor]) -> InceptionV3:
    """A torchvision ``inception_v3`` state dict with a K-class fc (the
    reference's ``fc.0.*`` or a plain ``fc.*``) → the backbone. Keys the
    eval graph does not use (``AuxLogits.*``) are dropped."""
    sd = {k.replace("fc.0.", "fc.", 1) if k.startswith("fc.0.") else k: v
          for k, v in state_dict.items() if not k.startswith("AuxLogits.")}
    net = InceptionV3(num_classes=sd["fc.weight"].shape[0])
    net.load_state_dict(sd, strict=True)
    return net


def from_jckx_flat(flat: Dict[str, np.ndarray]) -> InceptionV3:
    """jckx's flat ``a/b/c`` backbone arrays (the fine-tune's ``.npz``,
    HWIO kernels) → the backbone."""
    names = {"w": "conv.weight", "bn_scale": "bn.weight", "bn_bias": "bn.bias",
             "bn_mean": "bn.running_mean", "bn_var": "bn.running_var"}
    sd = {}
    for key, a in flat.items():
        *path, leaf = key.split("/")
        a = np.array(a, np.float32)
        if path == ["fc"]:
            sd[f"fc.{'weight' if leaf == 'w' else 'bias'}"] = torch.from_numpy(
                np.ascontiguousarray(a.T if leaf == "w" else a))
            continue
        if leaf == "w":
            a = a.transpose(3, 2, 0, 1)
        sd[".".join(path) + "." + names[leaf]] = torch.from_numpy(np.ascontiguousarray(a))
    net = InceptionV3(num_classes=sd["fc.weight"].shape[0])
    missing, unexpected = net.load_state_dict(sd, strict=False)
    if unexpected or [k for k in missing if not k.endswith("num_batches_tracked")]:
        raise KeyError(f"backbone arrays do not match InceptionV3: missing {missing}, "
                       f"unexpected {unexpected}")
    return net


def to_jckx_flat(net: InceptionV3) -> Dict[str, np.ndarray]:
    """The backbone → jckx's flat ``a/b/c`` arrays (``flatten_params`` of
    its params tree: HWIO kernels, fc ``(2048, K)``, ``bn_mean`` /
    ``bn_var`` from the running statistics): f32 copies on the host."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32, copy=True).numpy()

    flat = {}
    for name, m in net.named_modules():
        if isinstance(m, BasicConv2d):
            key = name.replace(".", "/")
            flat[f"{key}/w"] = np.ascontiguousarray(host(m.conv.weight).transpose(2, 3, 1, 0))
            flat[f"{key}/bn_scale"] = host(m.bn.weight)
            flat[f"{key}/bn_bias"] = host(m.bn.bias)
            flat[f"{key}/bn_mean"] = host(m.bn.running_mean)
            flat[f"{key}/bn_var"] = host(m.bn.running_var)
    flat["fc/w"] = np.ascontiguousarray(host(net.fc.weight).T)
    flat["fc/b"] = host(net.fc.bias)
    return flat
