"""finetune.bn_act_roofline: the fused BN + ReLU kernel's HBM bound over its
time in the fine-tune's train steps, in %. The bound: its launches in the
traced window times the bytes of an average launch (each map read once and
written once in the compute dtype, its two per-channel f32 vectors;
``reference/inception.bn_act_bytes`` per step's forward over its 94 maps)
at 3.35 TB/s; its time: the summed time of the profiler's kernels named
``bn_act``."""

from portbench.layer_metrics._device import PEAK_HBM_BYTES


def read(rec):
    tr = rec.trace
    per_step, layers = rec.facts.get("bn_act_bytes_per_step"), rec.facts.get("bn_act_layers")
    if tr is None or not per_step or not layers:
        return None
    seconds, launches = tr.kernel_time(("bn_act",))
    if not launches or seconds <= 0:
        return None
    return 100.0 * (per_step * launches / layers / PEAK_HBM_BYTES) / seconds
