"""% of the traced window in which the device is idle while the innermost
open program span is `norepeat.engine`: the native engine's own host work
(its heap loop, its gathers, the crossing into Python), outside its
`norepeat.refill` calls (`spans.py`'s split over the traced renders'
`info["timeline"]`). Nothing without a device trace, or where no render's
timeline holds the engine's span."""

from bench_torch import records, spans

SPAN = "norepeat.engine"


def read(run):
    host = records.timeline(run)
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device or not any(n == SPAN for n, _, _ in host):
        return None
    return 100.0 * spans._idle_split(tr, host).get(SPAN, 0.0) / tr.window_s
