"""Device refills the no-repeat assignment asked for, a render, over the
window (`info["refill_events"]`: each time a block's candidate list ran
out, the engine asked the device for more rows)."""


def read(run):
    ev = [r.info["refill_events"] for r in run.records
          if r.info and "refill_events" in r.info]
    return sum(ev) / len(ev) if ev else None
