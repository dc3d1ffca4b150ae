"""BigGAN's two readers, ``biggan.bn_roofline`` and ``biggan.attn_roofline``,
on synthetic traced windows, beside the readers ``test_the_readers``
(test_portbench_trace.py) checks: the shares they read, and None where
their kernels did not run (a program without BigGAN's route); and the
facts they read, as ``reference/biggan.py`` counts them at the published
widths."""

from types import SimpleNamespace

import pytest

from portbench import core
from portbench.layer_metrics._device import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from portbench.reference import biggan
from portbench.trace import DeviceEvent, Trace

NS = "void (anonymous namespace)::"
FACTS = {"bn_bytes_per_image": 2.5e7, "attn_flops_per_image": 1.0e9,
         "attn_bytes_per_image": 1.2e6}
SDPA = "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x128"


def _window(*named):
    """A 1 ms window holding kernels (name, start µs, length µs)."""
    return Trace((0.0, 1000.0), [DeviceEvent(n, "kernel", t, t + d) for n, t, d in named],
                 [("portbench.window", 0.0, 1000.0)])


def _rec(trace, images=4, facts=FACTS):
    return SimpleNamespace(trace=trace, facts=facts, counts={"rendered_images": images})


def test_the_bn_reader():
    tr = _window((NS + "bn_moments_partial<__nv_bfloat16, 8>", 0.0, 20.0),
                 (NS + "bn_moments_combine(float const*, float*, long, long)", 20.0, 5.0),
                 (NS + "cbn_normalize_vec<__nv_bfloat16, 1, 2>", 25.0, 40.0),
                 ("sm90_xmma_fprop_implicit_gemm_bf16bf16", 65.0, 100.0),
                 (NS + "bn_act_vec<__nv_bfloat16, 1>", 165.0, 35.0),
                 (NS + "up2_add_vec<__nv_bfloat16>", 200.0, 30.0))
    # 4 images of 2.5e7 bytes at 3.35 TB/s against the BN kernels' 100 µs
    want = 100.0 * 4 * 2.5e7 / PEAK_HBM_BYTES / 100e-6
    assert core.reader("biggan.bn_roofline")(_rec(tr)) == pytest.approx(want)


def test_the_attention_reader():
    tr = _window(("Memset (Device)", 0.0, 1.0), (SDPA, 1.0, 50.0),
                 ("sm90_xmma_fprop_implicit_gemm_bf16bf16", 51.0, 100.0))
    # compute-bound: 4 images of 1e9 FLOP at 989 TFLOP/s against 50 µs
    want = 100.0 * 4 * 1.0e9 / PEAK_BF16_FLOPS / 50e-6
    assert core.reader("biggan.attn_roofline")(_rec(tr)) == pytest.approx(want)
    slow = dict(FACTS, attn_bytes_per_image=1.0e7)  # bytes bound it
    assert core.reader("biggan.attn_roofline")(_rec(tr, facts=slow)) == pytest.approx(
        100.0 * 4 * 1.0e7 / PEAK_HBM_BYTES / 50e-6)


@pytest.mark.parametrize("metric", ["biggan.bn_roofline", "biggan.attn_roofline"])
def test_the_readers_find_nothing_without_their_kernels(metric):
    read = core.reader(metric)
    other = _window(("fmha_cutlassF_bf16_aligned_64x128_rf_sm80", 0.0, 50.0),
                    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", 50.0, 100.0))
    for nothing in (_rec(other), _rec(None), _rec(Trace((0.0, 1.0))),
                    _rec(_window((SDPA, 0.0, 9.0), (NS + "bn_act_vec<float, 1>", 9.0, 9.0)),
                         facts={}),
                    _rec(_window((SDPA, 0.0, 9.0), (NS + "bn_act_vec<float, 1>", 9.0, 9.0)),
                         images=0)):
        assert read(nothing) is None


def test_the_facts_at_the_published_widths():
    """One image's forward 42.24 GFLOP (41.23 in the convolutions, 1.007 in
    the attention's two products), G's eleven BN layers 6,119,424 elements
    of which 4,546,560 conditional and 1,499,136 written upsampled ×2 (each
    block's first), the output BN (the per-channel kernel's one layer)
    128²×96, the attention's products 1.0066 GFLOP and 1.2288 MB in bf16."""
    cfg = core.load_json(core.ROOT / "configs" / "biggan-128.json")
    assert biggan.forward_flops(cfg, 1) == pytest.approx(42.24e9, rel=1e-3)
    layers = biggan.bn_layers(cfg)
    assert len(layers) == 11
    assert sum(s * s * c for s, c, _, _ in layers) == 6_119_424
    assert sum(s * s * c for s, c, cond, _ in layers if cond) == 4_546_560
    assert sum(s * s * c for s, c, _, up in layers if up == 2) == 1_499_136
    assert [up for *_, up in layers] == [2, 1] * 5 + [1]
    assert biggan.attention_flops(cfg) == 2 * 4096 * 1024 * (24 + 96) == 1_006_632_960
    assert biggan.attention_bytes(cfg, 2) == 2 * (4096 * 24 + 1024 * 24 + 1024 * 96 + 4096 * 96)
    # x read and y written (four times where upsampled) in bf16, the (C,)
    # sums and the (N, C) scale and shift in f32
    each = [256 * s * s * c * 2 * (1 + up * up) + 2 * c * 4 + (2 * 256 * c * 4 if cond else 0)
            for s, c, cond, up in layers]
    assert biggan.bn_layer_bytes(cfg, 256, 2) == each
    assert biggan.bn_bytes(cfg, 256, 2) == sum(each)
    # the output BN as bn_act_roofline counts a layer (reference/cost.bn_act_bytes)
    assert each[-1] == 2 * 256 * 128 * 128 * 96 * 2 + 2 * 96 * 4
