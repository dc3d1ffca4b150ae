"""finetune.pool_pct: the pooling kernels' time, forward and backward (the
profiler's kernels whose names hold ``pool``: the max and average pools
and their gradients), as a share of the device's busy time in the traced
window, in %."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    seconds, launches = tr.kernel_time(("pool",))
    busy = tr.busy_s()
    return 100.0 * seconds / busy if launches and busy > 0 else None
