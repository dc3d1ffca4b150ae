"""train.host_ms_per_step: the host's own work per step in the trainer's
launches of the traced window: the summed durations of the
``jckx_torch.train.feed`` spans that the program recorded while the
profiler ran (each a step's lr and draws, made on the host before its
replay) over the steps they fed, in ms. The replay's enqueue is left out:
it blocks at the card's pace once the launch queue is full. It reads one
sample a step (about 200 in a 3 s window of a train cell). None where the
program records no such span."""


def read(rec):
    try:
        from jckx_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    feeds = [s for s in spans.recorded() if s.name == spans.PREFIX + "train.feed"]
    steps = sum(s.n for s in feeds)
    return sum(s.ns for s in feeds) / 1e6 / steps if steps else None
