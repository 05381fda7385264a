"""Share of the bytes a render uploaded through `ops/copies.py` that came
from registered (page-locked) host memory, %, the mean over the window's
renders (`info["h2d_pinned_bytes"]` over `info["h2d_bytes"]`). A program
without these counters gives nothing."""


def read(run):
    per = [100.0 * r.info.get("h2d_pinned_bytes", 0) / r.info["h2d_bytes"]
           for r in run.records if r.info and r.info.get("h2d_bytes")]
    return sum(per) / len(per) if per else None
