"""biggan.attn_roofline: BigGAN's attention product, its roofline bound over
its kernels' time, in %. The bound, an image: the larger of its two
batched products at their published widths (``reference/biggan.
attention_flops``: 2 · 4096 · 1024 · (24 + 96) at 64², never the route's
padded shapes) at the bf16 peak, and θ, φ and g read once and the output
written once (``attention_bytes``) at 3.35 TB/s; times the images rendered
in the traced window. The time: the summed time of the attention route's
kernels by name (``jckx_torch/ops/attention.py``'s card route, cuDNN's
fused kernel, ``…_native_sdpa_sm90…``; the GPU tests hold the route to
that name). An
image's 4.2 M exponentials take about as long on the card's special
function units as the products on its tensor cores, so about 50 % is a
practical ceiling. None where no such kernel ran."""

from portbench.layer_metrics._device import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

KERNELS = ("native_sdpa",)


def read(rec):
    tr = rec.trace
    flops, nbytes = rec.facts.get("attn_flops_per_image"), rec.facts.get("attn_bytes_per_image")
    images = rec.counts.get("rendered_images")
    if tr is None or not flops or not nbytes or not images:
        return None
    seconds, launches = tr.kernel_time(KERNELS)
    if not launches or seconds <= 0:
        return None
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * images
    return 100.0 * bound / seconds
