"""train.idle_pct: share of the traced window in which no device event runs, in %."""

from portbench.layer_metrics._device import idle_pct


def read(rec):
    return idle_pct(rec)
