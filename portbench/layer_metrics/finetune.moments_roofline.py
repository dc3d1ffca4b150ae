"""finetune.moments_roofline: the BN statistics' HBM bound over their time
in the fine-tune's train steps, in %. The bound: the launches of the
kernel named ``bn_moments_partial`` in the traced window (one a forward BN
layer) times 0.5 × the bytes of an average forward launch
(``reference/inception.bn_act_bytes`` per step over its 94 maps: each map
read and written once in the compute dtype), at 3.35 TB/s; the statistics'
least traffic reads x once, 2 bytes an element in bf16 against the
forward's 4. Its time: the summed time of the profiler's kernels named
``bn_moments`` (the partial sums and their combine). None where no such
kernel ran: a fine-tune whose forward takes the plain sums, or a cell
without ``bn_act_bytes_per_step`` (serving)."""

from portbench.layer_metrics._device import PEAK_HBM_BYTES

MOMENTS_BYTES = 0.5  # the statistics' bytes an element over the forward's


def read(rec):
    tr = rec.trace
    per_step, layers = rec.facts.get("bn_act_bytes_per_step"), rec.facts.get("bn_act_layers")
    if tr is None or not per_step or not layers:
        return None
    seconds, _ = tr.kernel_time(("bn_moments",))
    _, launches = tr.kernel_time(("bn_moments_partial",))
    if not launches or seconds <= 0:
        return None
    return 100.0 * (MOMENTS_BYTES * per_step * launches / layers / PEAK_HBM_BYTES) / seconds
