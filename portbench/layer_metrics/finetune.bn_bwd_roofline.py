"""finetune.bn_bwd_roofline: the BN + ReLU backward's HBM bound over its
time in the fine-tune's train steps, in %. The bound: the launches of its
kernel named ``bn_relu_bwd_dx`` in the traced window (one a backward) times
1.5 × the bytes of an average forward launch (``reference/inception.
bn_act_bytes`` per step over its 94 maps: each map read and written once in
the compute dtype), at 3.35 TB/s; the backward's least traffic reads x and
its gradient once and writes dx once, 6 bytes an element in bf16 against
the forward's 4, so the bound reads the same work however the backward is
built. Its time: the summed time of the profiler's kernels named
``bn_relu_bwd`` (the sums, their combine and dx). None where no such kernel
ran."""

from portbench.layer_metrics._device import PEAK_HBM_BYTES

BACKWARD_BYTES = 1.5  # the backward's bytes an element over the forward's


def read(rec):
    tr = rec.trace
    per_step, layers = rec.facts.get("bn_act_bytes_per_step"), rec.facts.get("bn_act_layers")
    if tr is None or not per_step or not layers:
        return None
    seconds, _ = tr.kernel_time(("bn_relu_bwd",))
    _, launches = tr.kernel_time(("bn_relu_bwd_dx",))
    if not launches or seconds <= 0:
        return None
    return 100.0 * (BACKWARD_BYTES * per_step * launches / layers / PEAK_HBM_BYTES) / seconds
