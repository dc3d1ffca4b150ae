"""serve.assemble_ms: for each served request of the traced window (a
``jckx_torch.serve.sample`` span that the program recorded while the
profiler ran), the duration of its ``serve.assemble`` span: the reply array
built from the drained batches; the median over the window's requests, in
ms. It reads one sample a request completed in the window (about 40 in a
3 s window of ``cgan-64.serve-bulk``). None where the program records no
such span."""

import statistics


def read(rec):
    try:
        from jckx_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    per = spans.child_ns(spans.recorded(), "serve.sample", "serve.assemble")
    return statistics.median(per.values()) / 1e6 if per else None
