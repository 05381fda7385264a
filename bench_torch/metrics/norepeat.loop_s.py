"""Seconds a render of the native engine's own loop (`info["engine_loop_s"]`:
its whole call less its refill callbacks, their gathers and its host masked
scans; for the global greedy, the heap over the blocks' sorted lists), the
mean over the window's renders that hold it."""


def read(run):
    xs = [r.info["engine_loop_s"] for r in run.records if r.info and "engine_loop_s" in r.info]
    return sum(xs) / len(xs) if xs else None
