"""Blocks the adaptive scorer certified over the blocks it scored, over the
window (`info["scoring"]["certified"] / ["blocks"]`); the two-level route
reports no certificate count, so a window of it gives nothing."""


def read(run):
    sc = [r.info["scoring"] for r in run.records
          if r.info and "certified" in r.info.get("scoring", {})]
    blocks = sum(s["blocks"] for s in sc)
    return 100.0 * sum(s["certified"] for s in sc) / blocks if blocks else None
