"""biggan.bn_roofline: BigGAN's eleven BN layers, their HBM bound over their
kernels' time, in %. The bound: the least bytes those layers move a
rendered image (``reference/biggan.bn_bytes``: each layer's x read once and
y written once in the compute dtype as the next convolution reads it, so
four times the layer's own map after each block's first conditional BN,
whose output that convolution reads upsampled ×2; its (C,) sums and a
conditional layer's (N, C) scale and shift read once, whatever computes its
statistics) times the images rendered in the traced window, at 3.35 TB/s.
The time: the summed time of every kernel of those layers, by name: the
statistics (``bn_moments``), the per-channel normalize (``bn_act``) and the
conditional one (``cbn_normalize``, which writes the upsampled maps). The
bound reads the same work however the layer is built, so a later fusion
cannot push the share past 100 %, and the upsampling's writes count
whether a BN kernel or a pass of their own makes them; the two-pass design
(x read by the statistics, then read by the normalize, which writes y)
tops out near 73 %. None where none of those kernels ran."""

from portbench.layer_metrics._device import PEAK_HBM_BYTES

KERNELS = ("bn_moments", "bn_act", "cbn_normalize")


def read(rec):
    tr = rec.trace
    per_image, images = rec.facts.get("bn_bytes_per_image"), rec.counts.get("rendered_images")
    if tr is None or not per_image or not images:
        return None
    seconds, launches = tr.kernel_time(KERNELS)
    if not launches or seconds <= 0:
        return None
    return 100.0 * (per_image * images / PEAK_HBM_BYTES) / seconds
