"""Host masked scans the in-render no-repeat engine made, a render, over
the window (`info["refill_host_events"]` of the renders that hold the
`sequence.engine` span: each time a block's list ran dry, the engine
scanned the unused library rows for the next 256)."""


def read(run):
    ev = [r.info["refill_host_events"] for r in run.records
          if r.info and "sequence.engine" in r.info.get("spans", {})]
    return sum(ev) / len(ev) if ev else None
