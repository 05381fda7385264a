"""Stale heap entries the native global greedy requeued a block
(`info["engine_requeues"]` over the render's blocks: pops whose key was
older than the block's first unused entry), the mean over the window's
renders that hold the count."""


def read(run):
    per = [r.info["engine_requeues"] / run.sizes["B"] for r in run.records
           if r.info and "engine_requeues" in r.info]
    return sum(per) / len(per) if per else None
