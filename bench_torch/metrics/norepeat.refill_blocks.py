"""Blocks a device refill covered, over the window (`info["refill_blocks"]`
over `info["refill_events"]`): how many nearly dry blocks ride along in
each call."""


def read(run):
    rec = [r.info for r in run.records if r.info and "refill_blocks" in r.info]
    events = sum(i["refill_events"] for i in rec)
    return sum(i["refill_blocks"] for i in rec) / events if events else None
