"""Shared by the per-layer readers: the chip's peaks and the window's idle share.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16, 3.35 TB/s HBM.
"""

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def idle_pct(rec):
    """Share of the traced window in which no device event runs, in %."""
    tr = rec.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
