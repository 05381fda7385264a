"""Share of the bytes a render copied to the host through `ops/copies.py`
that landed in page-locked memory, %, the mean over the window's renders
(`info["d2h_pinned_bytes"]` over `info["d2h_bytes"]`). A program without
these counters gives nothing."""


def read(run):
    per = [100.0 * r.info.get("d2h_pinned_bytes", 0) / r.info["d2h_bytes"]
           for r in run.records if r.info and r.info.get("d2h_bytes")]
    return sum(per) / len(per) if per else None
