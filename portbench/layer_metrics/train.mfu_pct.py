"""train.mfu_pct: one step's operations (the plain reference step, counted
by FlopCounterMode) × the steps completed in the traced window, over the
window × the bf16 peak, in %."""

from portbench.layer_metrics._device import PEAK_BF16_FLOPS


def read(rec):
    steps, flops = rec.counts.get("steps", 0), rec.facts.get("flops_per_step")
    if not steps or not flops or rec.trace is None or not rec.trace.device:
        return None
    return 100.0 * flops * steps / (rec.trace.window_s * PEAK_BF16_FLOPS)
