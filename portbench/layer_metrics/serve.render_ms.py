"""serve.render_ms: for each served request of the traced window (a
``jckx_torch.serve.sample`` span that the program recorded while the
profiler ran), the summed durations of its ``serve.render`` spans: the
host's part of its batches (draws, input copies, the replay's enqueue, the
output's copy); the median over the window's requests, in ms. It reads one
sample a request completed in the window (about 40 in a 3 s window of
``cgan-64.serve-bulk``). None where the program records no such span."""

import statistics


def read(rec):
    try:
        from jckx_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    per = spans.child_ns(spans.recorded(), "serve.sample", "serve.render")
    return statistics.median(per.values()) / 1e6 if per else None
