"""Candidate entries the native engine read a block, the mean over the
window's renders (`info["engine_entries"]` over the render's blocks): how
deep the global greedy goes into the blocks' sorted lists. The Python
engine reports no count, so a window of it gives nothing."""


def read(run):
    per = [r.info["engine_entries"] / run.sizes["B"] for r in run.records
           if r.info and "engine_entries" in r.info]
    return sum(per) / len(per) if per else None
