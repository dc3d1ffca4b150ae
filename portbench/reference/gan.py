"""The plain reference of the DCGAN and CGAN generators, discriminators
and train step: PyTorch operations on dicts of named tensors, float32,
with TF32 off. It imports nothing of the program.

The nets are the reference's ``model/DCGAN.py`` (Radford et al.,
arXiv:1511.06434) and ``model/CGAN.py`` (Mirza and Osindero,
arXiv:1411.1784), at the widths of a configuration file, with their
state-dict names (``conv{i}.weight``, ``norm{i}.weight`` / ``.bias``,
CGAN's ``label_embedding``, ``linear1``, ``linear2``):

- G: z (with CGAN's one-hot label beside it) through bias-free
  transposed convolutions (k4; s1 p0, then s2 p1), batch-statistic BN and
  ReLU between them, tanh out; images NHWC;
- D: bias-free convolutions (k4 s2 p1) with batch-statistic BN and
  LeakyReLU(0.2), a last k4 s1 p0 convolution to one logit (DCGAN); CGAN
  flattens the trunk in (C, H, W) order beside LeakyReLU(Linear(K, 2K))
  of the label, then Linear → 256, dropout by a keep-mask, Linear → 1.

One train step (``train_step``) is the faithful iteration of the
reference trainers as the configuration states it: instance noise 0.1,
BCE against 0.9 / 0.1, the gradient penalty (lambda 10) on D's sigmoid
score at alpha-interpolates in D's gradient, Adam (beta 0.5, 0.999, eps
1e-8) on D, then G's loss through the updated D with the same fake noise,
Adam on G, and the EMA of G.

``precision="fp8"`` is the control, the recipe of float8 training: every
convolution's and linear's operands and results rounded to e4m3 (where the
program holds bfloat16 activations) and the gradients flowing back through
them to e5m2, each under a per-tensor scale, to any order of
differentiation; the statistics and the rest float32. That is the step a
lower-precision port would be tempted to take. ``fault`` plants a fault:
``"half"`` takes every loss's and score's mean over the first half of the
batch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.frozen import KEEP

Params = Dict[str, torch.Tensor]
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # largest finite values


def stage_widths(cfg: dict) -> list:
    """G's widths at 4x4, 8x8, ... (512, 256, 128, 64 at 64², base 64)."""
    n_up = int(math.log2(cfg["image_size"])) - 2
    return [cfg["base_width"] * 2 ** (n_up - 1 - i) for i in range(n_up)]


def param_shapes(cfg: dict) -> dict:
    """{net: {name: shape}} of G ("g") and D ("d") at the configuration's
    widths: the family's parameters, which its ``params`` count."""
    widths = stage_widths(cfg)
    k = cfg.get("num_classes", 0) if cfg["conditional"] else 0
    g, prev = {}, cfg["z_dim"] + k
    for i, w in enumerate(widths):
        g[f"conv{i + 1}.weight"] = (prev, w, 4, 4)
        g[f"norm{i + 1}.weight"] = g[f"norm{i + 1}.bias"] = (w,)
        prev = w
    g[f"conv{len(widths) + 1}.weight"] = (prev, cfg["channels"], 4, 4)
    d, prev = {}, cfg["channels"]
    if k:
        d["label_embedding.weight"], d["label_embedding.bias"] = (2 * k, k), (2 * k,)
    for i, w in enumerate(reversed(widths)):
        d[f"conv{i + 1}.weight"] = (w, prev, 4, 4)
        d[f"norm{i + 1}.weight"] = d[f"norm{i + 1}.bias"] = (w,)
        prev = w
    if k:
        flat = (cfg["image_size"] // 2 ** len(widths)) ** 2 * prev
        d["linear1.weight"], d["linear1.bias"] = (256, flat + 2 * k), (256,)
        d["linear2.weight"], d["linear2.bias"] = (1, 256), (1,)
    else:
        d[f"conv{len(widths) + 1}.weight"] = (1, prev, 4, 4)
    return {"g": g, "d": d}


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one per-tensor scale, back in x's dtype."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX[dtype]
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Forward: ``x`` rounded to ``fwd``; backward: the incoming gradient
    rounded to e5m2, through this same function, so the penalty's double
    backward is rounded too."""

    @staticmethod
    def forward(ctx, x, fwd):
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _Fp8.apply(g, torch.float8_e5m2), None


def _q(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand of a convolution or a linear: e4m3 in the control."""
    if precision == "f32":
        return x
    if precision != "fp8":
        raise ValueError(f"precision {precision!r}: f32 or fp8")
    return _Fp8.apply(x, torch.float8_e4m3fn)


def _qg(y: torch.Tensor, precision: str) -> torch.Tensor:
    """A convolution's or a linear's result, held as the program holds its
    bfloat16 activations: e4m3 in the control, its gradient e5m2."""
    return _q(y, precision)


def _bn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + 1e-5) * scale[None, :, None, None]
    return (x - mean) * inv + bias[None, :, None, None]


def generator(p: Params, cfg: dict, z: torch.Tensor, onehot: Optional[torch.Tensor] = None,
              precision: str = "f32") -> torch.Tensor:
    """z (N, z_dim) [and one-hot (N, K)] → images (N, S, S, C) in [-1, 1]."""
    x = z if onehot is None else torch.cat([z, onehot], dim=-1)
    x = x.reshape(x.shape[0], -1, 1, 1)
    widths = stage_widths(cfg)
    for i in range(len(widths)):
        stride, pad = (1, 0) if i == 0 else (2, 1)
        x = _qg(F.conv_transpose2d(_q(x, precision), _q(p[f"conv{i + 1}.weight"], precision),
                                   stride=stride, padding=pad), precision)
        x = torch.relu(_bn(x, p[f"norm{i + 1}.weight"], p[f"norm{i + 1}.bias"]))
    x = _qg(F.conv_transpose2d(_q(x, precision), _q(p[f"conv{len(widths) + 1}.weight"],
                                                    precision), stride=2, padding=1), precision)
    return torch.tanh(x).permute(0, 2, 3, 1)


def _trunk(p: Params, cfg: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    x = x.permute(0, 3, 1, 2)
    for i in range(len(stage_widths(cfg))):
        x = _qg(F.conv2d(_q(x, precision), _q(p[f"conv{i + 1}.weight"], precision), stride=2,
                         padding=1), precision)
        x = F.leaky_relu(_bn(x, p[f"norm{i + 1}.weight"], p[f"norm{i + 1}.bias"]), 0.2)
    return x


def _linear(x, w, b, precision):
    return _qg(F.linear(_q(x, precision), _q(w, precision), b), precision)


def discriminator(p: Params, cfg: dict, x: torch.Tensor, onehot: Optional[torch.Tensor] = None,
                  keep: Optional[torch.Tensor] = None, precision: str = "f32") -> torch.Tensor:
    """images (N, S, S, C) [, one-hot (N, K), keep-mask (N, 256)] → logits (N,)."""
    h = _trunk(p, cfg, x, precision)
    if onehot is None:
        last = f"conv{len(stage_widths(cfg)) + 1}.weight"
        return _qg(F.conv2d(_q(h, precision), _q(p[last], precision)),
                   precision).reshape(h.shape[0])
    lab = F.leaky_relu(_linear(onehot, p["label_embedding.weight"], p["label_embedding.bias"],
                               precision), 0.2)
    h = _linear(torch.cat([h.reshape(h.shape[0], -1), lab], dim=-1), p["linear1.weight"],
                p["linear1.bias"], precision)
    if keep is not None:
        h = h * keep / KEEP
    return _linear(h, p["linear2.weight"], p["linear2.bias"], precision).reshape(h.shape[0])


def _mean_sigmoid(logits: torch.Tensor, fault: str) -> torch.Tensor:
    if fault == "half":
        logits = logits[: logits.shape[0] // 2]
    return torch.sigmoid(logits.detach()).mean()


def _bce(logits: torch.Tensor, target: float, fault: str) -> torch.Tensor:
    if fault == "half":
        logits = logits[: logits.shape[0] // 2]
    return torch.mean(F.softplus(logits) - target * logits)


def losses(g: Params, d: Params, cfg: dict, real: torch.Tensor, draws: Dict[str, torch.Tensor],
           onehot: Optional[torch.Tensor] = None, precision: str = "f32", fault: str = ""):
    """D's side of a step on the current nets → (D's loss with the penalty,
    the fake, the fake noise, {"gp", "d_x", "d_gz1"}): the part of the step
    that the FLOP count and ``train_step`` share."""
    tr = cfg["train"]
    f = tr["instance_noise"]
    real_n = (1.0 - f) * real + f * draws["real_noise"]
    fake = generator(g, cfg, draws["z"], onehot, precision)
    fake_n = (1.0 - f) * fake.detach() + f * draws["fake_noise"]
    logits_r = discriminator(d, cfg, real_n, onehot, draws.get("keep_real"), precision)
    logits_f = discriminator(d, cfg, fake_n, onehot, draws.get("keep_fake"), precision)
    bce = _bce(logits_r, tr["label_real"], fault) + _bce(logits_f, tr["label_fake"], fault)
    alpha = draws["alpha"]
    interp = (alpha * real_n + (1.0 - alpha) * fake_n).detach().requires_grad_(True)
    score = torch.sigmoid(discriminator(d, cfg, interp, onehot, draws.get("keep_gp"), precision))
    (grad,) = torch.autograd.grad(score.sum(), interp, create_graph=True)
    norms = torch.sqrt(torch.sum(grad.reshape(grad.shape[0], -1) ** 2, dim=1) + 1e-24)
    if fault == "half":
        norms = norms[: norms.shape[0] // 2]
    gp = torch.mean((norms - 1.0) ** 2)
    seen = {"gp": gp, "d_x": _mean_sigmoid(logits_r, fault),
            "d_gz1": _mean_sigmoid(logits_f, fault)}
    return bce + tr["lambda_gp"] * gp, fake, draws["fake_noise"], seen


def g_loss(g_fake: torch.Tensor, fake_noise: torch.Tensor, d: Params, cfg: dict,
           draws: Dict[str, torch.Tensor], onehot: Optional[torch.Tensor] = None,
           precision: str = "f32", fault: str = "") -> torch.Tensor:
    f = cfg["train"]["instance_noise"]
    logits = discriminator(d, cfg, (1.0 - f) * g_fake + f * fake_noise, onehot,
                           draws.get("keep_g"), precision)
    return _bce(logits, cfg["train"]["label_real"], fault)


class Adam:
    """torch.optim.Adam's update, written out: m, v, the step count, bias
    corrections, ``p -= lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps)``."""

    def __init__(self, params: Params, lr: float, betas=(0.5, 0.999), eps: float = 1e-8):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Params, grads: Params) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
                p.sub_(self.lr / bc1 * self.m[k] / denom)


class TrainState:
    """G, D, G's EMA, the two optimizers, as float32 leaves on one device."""

    def __init__(self, g: Params, d: Params, cfg: dict):
        tr = cfg["train"]
        self.g = {k: v.detach().float().clone() for k, v in g.items()}
        self.d = {k: v.detach().float().clone() for k, v in d.items()}
        self.ema = {k: v.clone() for k, v in self.g.items()}
        self.opt_g = Adam(self.g, tr["learning_rate"], tuple(tr["adam_betas"]))
        self.opt_d = Adam(self.d, tr["learning_rate"], tuple(tr["adam_betas"]))
        self.decay = tr["ema_decay"]

    def snapshot(self) -> dict:
        """Host copies of what a step reads and writes: ``g``, ``d``,
        ``ema``, each optimizer's moments ``m_g`` / ``v_g`` / ``m_d`` /
        ``v_d`` and counts ``t_g`` / ``t_d``."""
        def host(tree):
            return {k: v.detach().float().cpu().clone() for k, v in tree.items()}

        return {"g": host(self.g), "d": host(self.d), "ema": host(self.ema),
                "m_g": host(self.opt_g.m), "v_g": host(self.opt_g.v), "t_g": self.opt_g.t,
                "m_d": host(self.opt_d.m), "v_d": host(self.opt_d.v), "t_d": self.opt_d.t}

    @classmethod
    def restore(cls, rec: dict, cfg: dict, device) -> "TrainState":
        """A state on ``device`` holding a ``snapshot``'s values."""
        def dev(tree):
            return {k: v.to(device).float().clone() for k, v in tree.items()}

        st = cls(dev(rec["g"]), dev(rec["d"]), cfg)
        st.ema = dev(rec["ema"])
        for net, opt in (("g", st.opt_g), ("d", st.opt_d)):
            opt.m, opt.v, opt.t = dev(rec[f"m_{net}"]), dev(rec[f"v_{net}"]), rec[f"t_{net}"]
        return st


def _grads(loss: torch.Tensor, params: Params) -> Params:
    keys = list(params)
    return dict(zip(keys, torch.autograd.grad(loss, [params[k] for k in keys])))


def train_step(st: TrainState, cfg: dict, real: torch.Tensor, draws: Dict[str, torch.Tensor],
               onehot: Optional[torch.Tensor] = None, precision: str = "f32",
               fault: str = "") -> Dict[str, float]:
    """One faithful step on ``st`` in place → its losses, the penalty, the
    mean D scores of the real and fake rows (``d_x``, ``d_gz1``), and the
    gradients the optimizers got (``grad_d``, ``grad_g``: host copies)."""
    for p in list(st.g.values()) + list(st.d.values()):
        p.requires_grad_(True)
    loss_d, fake, fake_noise, seen = losses(st.g, st.d, cfg, real, draws, onehot, precision,
                                            fault)
    grad_d = _grads(loss_d, st.d)
    st.opt_d.step(st.d, grad_d)
    loss_g = g_loss(fake, fake_noise, st.d, cfg, draws, onehot, precision, fault)
    grad_g = _grads(loss_g, st.g)
    st.opt_g.step(st.g, grad_g)
    with torch.no_grad():
        for k, e in st.ema.items():
            e.mul_(st.decay).add_(st.g[k], alpha=1.0 - st.decay)
    for p in list(st.g.values()) + list(st.d.values()):
        p.requires_grad_(False)
    return {"loss_d": float(loss_d.detach()), "loss_g": float(loss_g.detach()),
            **{k: float(v.detach()) for k, v in seen.items()},
            "grad_d": {k: v.detach().cpu() for k, v in grad_d.items()},
            "grad_g": {k: v.detach().cpu() for k, v in grad_g.items()}}


def no_tf32() -> None:
    """float32 products in float32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
