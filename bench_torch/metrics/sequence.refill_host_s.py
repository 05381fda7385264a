"""Seconds of the in-render no-repeat engine's host masked scans, a render,
over the window (`info["refill_host_s"]` of the renders that hold the
`sequence.engine` span)."""


def read(run):
    xs = [r.info["refill_host_s"] for r in run.records
          if r.info and "sequence.engine" in r.info.get("spans", {})]
    return sum(xs) / len(xs) if xs else None
