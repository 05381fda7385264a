"""Seconds a render of the native engine's refill batching
(`info["engine_gather_s"]`: each event's scan of the B blocks for nearly
dry ones and its append of the returned entries), the mean over the
window's renders that hold the engine's counters; nothing where no render
made a refill callback."""

from bench_torch.records import with_callbacks


def read(run):
    rec = with_callbacks(run, "engine_gather_s")
    return sum(i["engine_gather_s"] for i in rec) / len(rec) if rec else None
