"""train.gap_ms_per_step: the device's idle gaps longer than 10 µs inside
the traced window, summed, over the steps completed there, in ms."""

from portbench.trace import GAP_US


def read(rec):
    steps = rec.counts.get("steps", 0)
    if not steps or rec.trace is None or not rec.trace.device:
        return None
    return sum(g for _, g in rec.trace.gaps() if g > GAP_US) / 1e3 / steps
