"""The yardstick's counts against hand arithmetic: FlopCounterMode over the
plain reference's G forward and train step at a tiny width, and the BN
kernel's bytes."""

import pytest

from portbench.reference import cost, gan

TRAIN = {"instance_noise": 0.1, "label_real": 0.9, "label_fake": 0.1, "lambda_gp": 10.0}


def tiny(conditional=False):
    return {"image_size": 16, "base_width": 8, "z_dim": 8, "channels": 3,
            "conditional": conditional, "num_classes": 10, "train": TRAIN}


def conv_flops(cfg, n):
    """Each convolution's forward FLOPs, 2 · N · (input pixels) · Cin · Cout · 16
    for G's transposed k4 layers, 2 · N · (output pixels) · Cin · Cout · 16 for D's."""
    widths = gan.stage_widths(cfg)
    k = cfg["num_classes"] if cfg["conditional"] else 0
    g, prev, side = [], cfg["z_dim"] + k, 1
    for i, w in enumerate(widths):
        g.append(2 * n * side * side * prev * w * 16)
        prev, side = w, 4 if i == 0 else 2 * side
    g.append(2 * n * side * side * prev * cfg["channels"] * 16)
    d, prev, side = [], cfg["channels"], cfg["image_size"]
    for w in reversed(widths):
        side //= 2
        d.append(2 * n * side * side * prev * w * 16)
        prev = w
    d.append(2 * n * 1 * 1 * prev * 1 * 16)  # the k4 s1 p0 head on the last 4x4 map
    return g, d


@pytest.mark.parametrize("conditional", [False, True])
def test_generator_forward_flops(conditional):
    cfg = tiny(conditional)
    g, _ = conv_flops(cfg, 4)
    assert cost.forward_flops(cfg, 4) == sum(g)


def test_train_step_flops():
    """G forward and its backward (weight grads everywhere, input grads past
    the first layer): 3·ΣG − G1; D: four forwards, the real and fake passes'
    backward (2·(2·ΣD − D1)), the penalty's input gradient (ΣD), its double
    backward (4·ΣD − D1) and G's pass back through D (ΣD): 14·ΣD − 3·D1."""
    cfg = tiny()
    g, d = conv_flops(cfg, 4)
    assert cost.step_flops(cfg, 4) == 3 * sum(g) - g[0] + 14 * sum(d) - 3 * d[0]


def test_full_size_counts():
    cfg = {**tiny(), "image_size": 64, "base_width": 64, "z_dim": 100}
    assert cost.forward_flops(cfg, 512) / 512 == pytest.approx(2.0926e8, rel=1e-4)
    g, d = conv_flops(cfg, 128)
    assert cost.step_flops(cfg, 128) == 3 * sum(g) - g[0] + 14 * sum(d) - 3 * d[0]


def test_bn_act_bytes():
    cfg = {**tiny(), "image_size": 64, "base_width": 64}
    # bs512 bf16: 4x4x512, 8x8x256, 16x16x128, 32x32x64, each read and written, + scale, shift
    want = sum(2 * 512 * s * s * c * 2 + 2 * c * 4
               for s, c in ((4, 512), (8, 256), (16, 128), (32, 64)))
    assert cost.bn_act_bytes(cfg, 512, 2) == want == 251_665_920
