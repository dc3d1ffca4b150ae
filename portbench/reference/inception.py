"""The plain reference of InceptionV3's fine-tune step: PyTorch operations
on dicts of named tensors, float32, NCHW, with TF32 off. It imports nothing
of the program.

The net is InceptionV3 (Szegedy et al., "Rethinking the Inception
Architecture for Computer Vision", arXiv:1512.00567) as torchvision's
``inception_v3(aux_logits=False, transform_input=False)`` builds it, with
its fc replaced by ``Linear(2048, K)`` (the reference repository's
``inceptionnet.ipynb``, ``metrics.py:46-52``), written out layer by layer
from torchvision's ``inception.py`` under its state-dict names
(``Mixed_5b.branch1x1.conv.weight``, ``….bn.running_var``, ``fc.weight``):
each BasicConv2d is a bias-free convolution, batch-statistic BN at eps
1e-3 (``F.batch_norm`` in training mode: the running statistics move by
momentum 0.1 toward the batch mean and the unbiased batch variance) and
ReLU; the pools are max 3×3 stride 2 and average 3×3 stride 1 pad 1
counting the padding; after the global average pool, dropout 0.5 and the
fc.

One fine-tune step (``train_step``) is the notebook's: the batch's uint8
rows / 255, RandomResizedCrop to the configuration's side and a horizontal
flip (``crop_flip``), ImageNet normalization, the train-mode forward,
dropout from the step's keep mask, mean cross-entropy, and one step of
``torch.optim.SGD`` with nesterov momentum 0.9 and weight decay 5e-4 at lr
0.1, written out (``sgd``).

Departures from torchvision, each the program's rule, which the benchmark
holds the program to:

- the crop is jckx's, not torchvision's ``RandomResizedCrop``: an area
  share and a log-ratio drawn once and the box clamped into the image (no
  rejection sampling), resampled by ``jax.image.scale_and_translate``'s
  bilinear weights with its antialias (``crop_flip``, computed here); the
  flip mirrors the small image with the box's offset mirrored;
- the draws (crops, flips, keep masks) are the program's, made here again
  from its seed in its order (``step_draws``);
- the weights are drawn by the law of the program's seeded init (He-scaled
  normals clipped at ±2, identity BN, a uniform fc) from the run's seed,
  on the device (``init_state``);
- the net runs in NCHW; the program runs channels_last on the card. NCHW
  also sidesteps the card's channels_last ``avg_pool2d`` backward fault
  (``jckx_torch/metrics/inception_v3._AvgPool3x3``).

``precision="fp8"`` is the control: every convolution's and the fc's
operands and results rounded to e4m3 and the gradients through them to
e5m2, each under a per-tensor scale (``gan._q``), the statistics and the
rest float32. ``"bf16"`` rounds the same operands, results and gradients
to bfloat16, the configuration's compute dtype: the reference's own
reading of that precision, against which the program's gaps are read.
``"f64"`` runs the step in float64, to read float32's own error.
``fault`` plants a fault: ``"half"`` takes the loss's mean over the first
half of the batch, ``"nodrop"`` leaves the dropout mask out.

``step_flops`` counts one step's operations by ``FlopCounterMode`` on the
meta device; ``bn_act_bytes`` the bytes the program's BN + ReLU kernel
must move in one step's forward: each of the 94 maps read once and written
once in the compute dtype, and its two per-channel f32 vectors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import gan

Params = Dict[str, torch.Tensor]
FEATURES = 2048
EPS = 1e-3
MOMENTUM = 0.1
KEEP = 0.5  # dropout p = 0.5
MEAN = (0.485, 0.456, 0.406)  # ImageNet normalization
STD = (0.229, 0.224, 0.225)
SCALE = (0.08, 1.0)           # the crop's area share
RATIO = (3.0 / 4.0, 4.0 / 3.0)


def _basic(name, cin, cout, k, stride=1, pad=0):
    kh, kw = (k, k) if isinstance(k, int) else k
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    return (name, cin, cout, kh, kw, stride, ph, pw)


def _a(m, cin, pool):
    return [_basic(f"{m}.branch1x1", cin, 64, 1), _basic(f"{m}.branch5x5_1", cin, 48, 1),
            _basic(f"{m}.branch5x5_2", 48, 64, 5, pad=2),
            _basic(f"{m}.branch3x3dbl_1", cin, 64, 1),
            _basic(f"{m}.branch3x3dbl_2", 64, 96, 3, pad=1),
            _basic(f"{m}.branch3x3dbl_3", 96, 96, 3, pad=1),
            _basic(f"{m}.branch_pool", cin, pool, 1)]


def _b(m, cin):
    return [_basic(f"{m}.branch3x3", cin, 384, 3, stride=2),
            _basic(f"{m}.branch3x3dbl_1", cin, 64, 1),
            _basic(f"{m}.branch3x3dbl_2", 64, 96, 3, pad=1),
            _basic(f"{m}.branch3x3dbl_3", 96, 96, 3, stride=2)]


def _c(m, cin, c7):
    return [_basic(f"{m}.branch1x1", cin, 192, 1), _basic(f"{m}.branch7x7_1", cin, c7, 1),
            _basic(f"{m}.branch7x7_2", c7, c7, (1, 7), pad=(0, 3)),
            _basic(f"{m}.branch7x7_3", c7, 192, (7, 1), pad=(3, 0)),
            _basic(f"{m}.branch7x7dbl_1", cin, c7, 1),
            _basic(f"{m}.branch7x7dbl_2", c7, c7, (7, 1), pad=(3, 0)),
            _basic(f"{m}.branch7x7dbl_3", c7, c7, (1, 7), pad=(0, 3)),
            _basic(f"{m}.branch7x7dbl_4", c7, c7, (7, 1), pad=(3, 0)),
            _basic(f"{m}.branch7x7dbl_5", c7, 192, (1, 7), pad=(0, 3)),
            _basic(f"{m}.branch_pool", cin, 192, 1)]


def _d(m, cin):
    return [_basic(f"{m}.branch3x3_1", cin, 192, 1),
            _basic(f"{m}.branch3x3_2", 192, 320, 3, stride=2),
            _basic(f"{m}.branch7x7x3_1", cin, 192, 1),
            _basic(f"{m}.branch7x7x3_2", 192, 192, (1, 7), pad=(0, 3)),
            _basic(f"{m}.branch7x7x3_3", 192, 192, (7, 1), pad=(3, 0)),
            _basic(f"{m}.branch7x7x3_4", 192, 192, 3, stride=2)]


def _e(m, cin):
    return [_basic(f"{m}.branch1x1", cin, 320, 1), _basic(f"{m}.branch3x3_1", cin, 384, 1),
            _basic(f"{m}.branch3x3_2a", 384, 384, (1, 3), pad=(0, 1)),
            _basic(f"{m}.branch3x3_2b", 384, 384, (3, 1), pad=(1, 0)),
            _basic(f"{m}.branch3x3dbl_1", cin, 448, 1),
            _basic(f"{m}.branch3x3dbl_2", 448, 384, 3, pad=1),
            _basic(f"{m}.branch3x3dbl_3a", 384, 384, (1, 3), pad=(0, 1)),
            _basic(f"{m}.branch3x3dbl_3b", 384, 384, (3, 1), pad=(1, 0)),
            _basic(f"{m}.branch_pool", cin, 192, 1)]


def basic_convs(cfg: dict) -> List[tuple]:
    """The 94 BasicConv2d of torchvision's module order: (name, cin, cout,
    kh, kw, stride, pad h, pad w)."""
    c = cfg["channels"]
    return ([_basic("Conv2d_1a_3x3", c, 32, 3, stride=2), _basic("Conv2d_2a_3x3", 32, 32, 3),
             _basic("Conv2d_2b_3x3", 32, 64, 3, pad=1), _basic("Conv2d_3b_1x1", 64, 80, 1),
             _basic("Conv2d_4a_3x3", 80, 192, 3)]
            + _a("Mixed_5b", 192, 32) + _a("Mixed_5c", 256, 64) + _a("Mixed_5d", 288, 64)
            + _b("Mixed_6a", 288) + _c("Mixed_6b", 768, 128) + _c("Mixed_6c", 768, 160)
            + _c("Mixed_6d", 768, 160) + _c("Mixed_6e", 768, 192) + _d("Mixed_7a", 768)
            + _e("Mixed_7b", 1280) + _e("Mixed_7c", 2048))


def param_shapes(cfg: dict) -> dict:
    """{"net": {name: shape}}: the parameters of torchvision's state dict
    (each BasicConv2d's ``conv.weight``, ``bn.weight``, ``bn.bias``; the
    fc), which the configuration's ``params`` counts."""
    out = {}
    for name, cin, cout, kh, kw, *_ in basic_convs(cfg):
        out[f"{name}.conv.weight"] = (cout, cin, kh, kw)
        out[f"{name}.bn.weight"] = out[f"{name}.bn.bias"] = (cout,)
    out["fc.weight"], out["fc.bias"] = (cfg["num_classes"], FEATURES), (cfg["num_classes"],)
    return {"net": out}


def stat_names(cfg: dict) -> List[str]:
    """The running statistics' names (buffers of the state dict)."""
    return [f"{name}.bn.running_{s}" for name, *_ in basic_convs(cfg) for s in ("mean", "var")]


def init_state(cfg: dict, seed: int, device) -> dict:
    """A starting state from ``seed`` on ``device``, by the law of the
    program's seeded init: convolution weights N(0, 1) clipped at ±2 times
    sqrt(2 / fan_in), BN scales 1 and biases 0, running means 0 and
    variances 1, the fc's weight U(±1 / sqrt(2048)) and bias 0; momentum
    buffers zero (no step taken). → {"p", "buf", "stats"}."""
    shapes = param_shapes(cfg)["net"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    convs = [k for k in shapes if k.endswith(".conv.weight")]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in convs), generator=gen, device=device)
    p, at = {}, 0
    for name, shape in shapes.items():
        if name.endswith(".conv.weight"):
            n = math.prod(shape)
            std = math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
            p[name] = flat[at:at + n].view(shape).clamp(-2.0, 2.0) * std
            at += n
        elif name.endswith(".bn.weight"):
            p[name] = torch.ones(shape, device=device)
        else:
            p[name] = torch.zeros(shape, device=device)
    bound = 1.0 / math.sqrt(FEATURES)
    p["fc.weight"] = (2.0 * torch.rand(shapes["fc.weight"], generator=gen, device=device)
                      - 1.0) * bound
    stats = {}
    for name in stat_names(cfg):
        c = shapes[name.rsplit(".", 2)[0] + ".bn.weight"]
        stats[name] = (torch.zeros if name.endswith("mean") else torch.ones)(c, device=device)
    return {"p": p, "buf": {k: torch.zeros_like(v) for k, v in p.items()}, "stats": stats}


def step_draws(seed: int, steps: int, n: int, device) -> List[Dict[str, torch.Tensor]]:
    """The first ``steps`` steps' draws of a run seeded with ``seed``, from
    one generator on ``device`` in the program's order (its
    ``draw_step``): per image the crop's area share, log-ratio, y and x
    offsets and flip, then the (n, 2048) dropout keep mask."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def u(lo=0.0, hi=1.0):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo

    out = []
    for _ in range(steps):
        d = {"area": u(*SCALE), "log_ratio": u(math.log(RATIO[0]), math.log(RATIO[1])),
             "y": u(), "x": u(), "flip": u() < 0.5}
        d["keep"] = torch.rand(n, FEATURES, generator=gen, device=device) < KEEP
        out.append(d)
    return out


def _resample(in_size: int, out_size: int, scale: torch.Tensor,
              translation: torch.Tensor) -> torch.Tensor:
    """(N,) scales and translations → (N, out, in) weights of
    ``jax.image.scale_and_translate``'s bilinear (triangle) kernel with
    antialias: sample points at half-pixel centres, the kernel widened by
    max(1 / scale, 1), each row renormalized, zero outside [-0.5, in - 0.5]."""
    dev = scale.device
    inv = 1.0 / scale[:, None]
    width = torch.clamp(inv, min=1.0)
    at = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * inv
          - translation[:, None] * inv - 0.5)
    w = torch.clamp(1.0 - (at[:, :, None]
                           - torch.arange(in_size, dtype=torch.float32, device=dev)).abs()
                    / width[:, :, None], min=0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    return torch.where(((at >= -0.5) & (at <= in_size - 0.5))[:, :, None], w, 0.0)


def crop_flip(images: torch.Tensor, size: int, d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(N, H, W, C) f32 → (N, size, size, C): each image's clamped box and
    flip from the draws ``d``, resampled to ``size``²."""
    n, h, w, _ = images.shape
    area, r = d["area"] * (h * w), torch.exp(d["log_ratio"])
    cw = torch.clamp(torch.sqrt(area * r), 1.0, float(w))
    ch = torch.clamp(torch.sqrt(area / r), 1.0, float(h))
    y0, x0 = d["y"] * (h - ch), d["x"] * (w - cw)
    flip = d["flip"]
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    x0 = torch.where(flip, (w - cw) - x0, x0)
    wy = _resample(h, size, size / ch, -y0 * size / ch)
    wx = _resample(w, size, size / cw, -x0 * size / cw)
    return torch.einsum("njw,niwc->nijc", wx, torch.einsum("nih,nhwc->niwc", wy, images))


def inputs(u8: torch.Tensor, cfg: dict, d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A batch's uint8 rows (N, h, w, C) → the net's input (N, C, S, S):
    / 255, crop and flip, ImageNet normalization."""
    x = crop_flip(u8.float() / 255.0, cfg["image_size"], d)
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


class _Bf16(torch.autograd.Function):
    """x rounded to bfloat16 and back; its gradient rounded so too."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _q(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand or a result of a convolution or the fc at ``precision``:
    bfloat16's rounding for ``"bf16"``, unrounded for ``"f64"``, else as
    ``gan._q``."""
    if precision == "bf16":
        return _Bf16.apply(x)
    return x if precision == "f64" else gan._q(x, precision)


class _Net:
    """One forward's parameters, running statistics, precision, and a
    record of each BasicConv2d's output shape."""

    def __init__(self, p: Params, stats: Optional[Params], precision: str):
        self.p, self.stats, self.precision = p, stats, precision
        self.shapes: List[Tuple[int, ...]] = []
        self.spec = {}

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """BasicConv2d: conv → batch-statistic BN (its running statistics
        moved in place) → ReLU."""
        _, _, _, _, _, stride, ph, pw = self.spec[name]
        q = self.precision
        y = _q(F.conv2d(_q(x, q), _q(self.p[f"{name}.conv.weight"], q),
                        stride=stride, padding=(ph, pw)), q)
        self.shapes.append(tuple(y.shape))
        rm = rv = None
        if self.stats is not None:
            rm, rv = self.stats[f"{name}.bn.running_mean"], self.stats[f"{name}.bn.running_var"]
        y = F.batch_norm(y, rm, rv, self.p[f"{name}.bn.weight"], self.p[f"{name}.bn.bias"],
                         training=True, momentum=MOMENTUM, eps=EPS)
        return torch.relu(y)


def _avg(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1)  # counts the padding, torchvision's default


def _max(x):
    return F.max_pool2d(x, 3, stride=2)


def _block_a(n, m, x):
    b1 = n.conv(f"{m}.branch1x1", x)
    b5 = n.conv(f"{m}.branch5x5_2", n.conv(f"{m}.branch5x5_1", x))
    b3 = n.conv(f"{m}.branch3x3dbl_1", x)
    b3 = n.conv(f"{m}.branch3x3dbl_3", n.conv(f"{m}.branch3x3dbl_2", b3))
    return torch.cat([b1, b5, b3, n.conv(f"{m}.branch_pool", _avg(x))], 1)


def _block_b(n, m, x):
    b3 = n.conv(f"{m}.branch3x3", x)
    bd = n.conv(f"{m}.branch3x3dbl_1", x)
    bd = n.conv(f"{m}.branch3x3dbl_3", n.conv(f"{m}.branch3x3dbl_2", bd))
    return torch.cat([b3, bd, _max(x)], 1)


def _block_c(n, m, x):
    b1 = n.conv(f"{m}.branch1x1", x)
    b7 = n.conv(f"{m}.branch7x7_1", x)
    b7 = n.conv(f"{m}.branch7x7_3", n.conv(f"{m}.branch7x7_2", b7))
    bd = n.conv(f"{m}.branch7x7dbl_1", x)
    for i in (2, 3, 4, 5):
        bd = n.conv(f"{m}.branch7x7dbl_{i}", bd)
    return torch.cat([b1, b7, bd, n.conv(f"{m}.branch_pool", _avg(x))], 1)


def _block_d(n, m, x):
    b3 = n.conv(f"{m}.branch3x3_2", n.conv(f"{m}.branch3x3_1", x))
    b7 = x
    for i in (1, 2, 3, 4):
        b7 = n.conv(f"{m}.branch7x7x3_{i}", b7)
    return torch.cat([b3, b7, _max(x)], 1)


def _block_e(n, m, x):
    b1 = n.conv(f"{m}.branch1x1", x)
    b3 = n.conv(f"{m}.branch3x3_1", x)
    b3 = torch.cat([n.conv(f"{m}.branch3x3_2a", b3), n.conv(f"{m}.branch3x3_2b", b3)], 1)
    bd = n.conv(f"{m}.branch3x3dbl_2", n.conv(f"{m}.branch3x3dbl_1", x))
    bd = torch.cat([n.conv(f"{m}.branch3x3dbl_3a", bd), n.conv(f"{m}.branch3x3dbl_3b", bd)], 1)
    return torch.cat([b1, b3, bd, n.conv(f"{m}.branch_pool", _avg(x))], 1)


BLOCKS = (("Mixed_5b", _block_a), ("Mixed_5c", _block_a), ("Mixed_5d", _block_a),
          ("Mixed_6a", _block_b), ("Mixed_6b", _block_c), ("Mixed_6c", _block_c),
          ("Mixed_6d", _block_c), ("Mixed_6e", _block_c), ("Mixed_7a", _block_d),
          ("Mixed_7b", _block_e), ("Mixed_7c", _block_e))


def forward(p: Params, stats: Optional[Params], cfg: dict, x: torch.Tensor,
            keep: Optional[torch.Tensor], precision: str = "f32", fault: str = "",
            shapes: Optional[list] = None) -> torch.Tensor:
    """The train-mode forward: x (N, C, S, S) → logits (N, K). ``stats``
    (running statistics, moved in place; None: left alone), ``keep`` the
    (N, 2048) dropout keep mask (None or ``fault="nodrop"``: no dropout).
    ``shapes`` collects each BasicConv2d's output shape."""
    net = _Net(p, stats, precision)
    net.spec = {s[0]: s for s in basic_convs(cfg)}
    x = net.conv("Conv2d_1a_3x3", x)
    x = net.conv("Conv2d_2b_3x3", net.conv("Conv2d_2a_3x3", x))
    x = _max(x)
    x = _max(net.conv("Conv2d_4a_3x3", net.conv("Conv2d_3b_1x1", x)))
    for name, block in BLOCKS:
        x = block(net, name, x)
    x = x.mean(dim=(2, 3))
    if keep is not None and fault != "nodrop":
        x = x * keep / KEEP
    if shapes is not None:
        shapes.extend(net.shapes)
    q = precision
    return _q(F.linear(_q(x, q), _q(p["fc.weight"], q), p["fc.bias"]), q)


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, fault: str = "") -> torch.Tensor:
    if fault == "half":
        logits, labels = logits[: logits.shape[0] // 2], labels[: labels.shape[0] // 2]
    return F.cross_entropy(logits, labels)


def sgd(p: Params, buf: Params, grads: Params, tr: dict) -> Tuple[Params, Params]:
    """One step of ``torch.optim.SGD`` (dampening 0): g + wd·p, the buffer
    μ·buf + g (g itself on the first step, which a zero buffer gives),
    nesterov's g + μ·buf, p − lr · that. → (new parameters, new buffers)."""
    lr, mu, wd = tr["learning_rate"], tr["momentum"], tr["weight_decay"]
    new_p, new_buf = {}, {}
    with torch.no_grad():
        for k, v in p.items():
            g = grads[k] + wd * v
            b = mu * buf[k] + g
            d = g + mu * b if tr["nesterov"] else b
            new_p[k], new_buf[k] = v - lr * d, b
    return new_p, new_buf


def train_step(state: dict, cfg: dict, u8: torch.Tensor, labels: torch.Tensor,
               d: Dict[str, torch.Tensor], precision: str = "f32", fault: str = "") -> dict:
    """One step from ``state`` ({"p", "buf", "stats"}, left as it is) on a
    batch's uint8 rows, labels and draws → {"state": the state after it,
    "loss", "grad": the loss's gradient of each parameter}. ``fault``
    ``"unchanged"``: the state after is the state before."""
    gan.no_tf32()
    dt = torch.float64 if precision == "f64" else torch.float32
    p = {k: v.detach().to(dt).clone().requires_grad_(True) for k, v in state["p"].items()}
    stats = {k: v.to(dt).clone() for k, v in state["stats"].items()}
    logits = forward(p, stats, cfg, inputs(u8, cfg, d).to(dt), d["keep"], precision, fault)
    loss = loss_fn(logits, labels, fault)
    keys = list(p)
    grads = dict(zip(keys, torch.autograd.grad(loss, [p[k] for k in keys])))
    del logits
    if fault == "unchanged":
        after = {k: {n: v.clone() for n, v in state[k].items()} for k in ("p", "buf", "stats")}
    else:
        new_p, new_buf = sgd({k: v.detach() for k, v in p.items()},
                             {k: v.to(dt) for k, v in state["buf"].items()}, grads, cfg["train"])
        after = {"p": new_p, "buf": new_buf, "stats": stats}
    return {"state": after, "loss": float(loss.detach()), "grad": grads}


META = torch.device("meta")


def _meta_step(cfg: dict, batch: int, shapes: Optional[list] = None) -> FlopCounterMode:
    p = {k: torch.empty(s, device=META, requires_grad=True)
         for k, s in param_shapes(cfg)["net"].items()}
    u8 = torch.empty((batch, 32, 32, cfg["channels"]), dtype=torch.uint8, device=META)
    d = {k: torch.empty(batch, device=META) for k in ("area", "log_ratio", "y", "x")}
    d["flip"] = torch.empty(batch, dtype=torch.bool, device=META)
    keep = torch.empty((batch, FEATURES), dtype=torch.bool, device=META)
    labels = torch.zeros(batch, dtype=torch.long, device=META)
    with FlopCounterMode(display=False) as counter:
        loss = loss_fn(forward(p, None, cfg, inputs(u8, cfg, d), keep, shapes=shapes), labels)
        torch.autograd.grad(loss, list(p.values()))
    return counter


def step_flops(cfg: dict, batch: int) -> int:
    """Operations of one step at ``batch``: the crop's resampling products,
    the forward, and the backward to every parameter (SGD's elementwise work
    is not counted, as no FLOP counter counts it)."""
    return int(_meta_step(cfg, batch).get_total_flops())


def bn_maps(cfg: dict, batch: int) -> List[Tuple[int, ...]]:
    """Each BasicConv2d's output shape (N, C, H, W) at ``batch``, in the
    forward's order: the maps the BN + ReLU kernel normalizes."""
    shapes: list = []
    _meta_step(cfg, batch, shapes)
    return shapes


def bn_act_bytes(cfg: dict, batch: int, element_bytes: int) -> int:
    """Bytes the program's BN + ReLU kernel must move in one step's forward
    at ``batch``: each map read once and written once (``element_bytes``
    each), and its two per-channel f32 vectors (scale, shift) read once."""
    return sum(2 * math.prod(s) * element_bytes + 2 * s[1] * 4 for s in bn_maps(cfg, batch))
