"""What the window's render records hold beyond their spans, in the form
the metrics read: the program's spans on the trace's clock (`info["timeline"]`,
`[name, start_us, end_us]` an entry, written by
`emosaic_tpu_torch.monitor.span` while the profiler records) for `spans.py`'s
split of the device's idle time, and the native engine's counters
(`emosaic_tpu_torch.native.STATS`)."""

from __future__ import annotations


def timeline(run) -> list:
    """(name, start, end) of every span in the window's timelines, in
    microseconds of the trace's clock; [] where no render holds one (a
    run without a trace, or a program that writes none)."""
    return [(name, s0, s1) for r in run.records if r.info
            for name, s0, s1 in r.info.get("timeline", ())]


def with_callbacks(run, key: str) -> list:
    """The `info` of the window's renders that hold `key` beside the native
    engine's refill callback count (`engine_cb_events`), or [] where no
    render made a refill callback: the callback's readings are then not
    there to read."""
    rec = [r.info for r in run.records if r.info and key in r.info
           and "engine_cb_events" in r.info]
    return rec if any(i["engine_cb_events"] > 0 for i in rec) else []
