"""serve.mfu_pct: one image's generator forward (the plain reference G,
counted by FlopCounterMode) × the images rendered in the traced window,
over the window × the bf16 peak, in %."""

from portbench.layer_metrics._device import PEAK_BF16_FLOPS


def read(rec):
    images, flops = rec.counts.get("rendered_images", 0), rec.facts.get("flops_per_image")
    if not images or not flops or rec.trace is None or not rec.trace.device:
        return None
    return 100.0 * flops * images / (rec.trace.window_s * PEAK_BF16_FLOPS)
