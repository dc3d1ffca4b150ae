"""bn_act_roofline: the fused BN + activation kernel's HBM bound over its
time, in %. The bound: the bytes of each of its launches in the traced
window (each input byte read once, each output byte written once, the
per-channel vectors; ``reference/cost.bn_act_bytes`` per render of the
configuration's G) at 3.35 TB/s; its time: the summed time of the
profiler's kernels named ``bn_act``."""

from portbench.layer_metrics._device import PEAK_HBM_BYTES


def read(rec):
    tr = rec.trace
    per_render, layers = rec.facts.get("bn_act_bytes_per_render"), rec.facts.get("bn_act_layers")
    if tr is None or not per_render or not layers:
        return None
    seconds, launches = tr.kernel_time(("bn_act",))
    if not launches or seconds <= 0:
        return None
    return 100.0 * (per_render * launches / layers / PEAK_HBM_BYTES) / seconds
