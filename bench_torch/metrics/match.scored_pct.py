"""Rows the repeat match's argmin scored over the blocks, the mean over the
window's renders that record their match (`info["match"]["scored"] /
["blocks"]`, `render/matched.py` `match_blocks`): 100 where the dedup gate
does not fire. A program that records no match gives nothing."""


def read(run):
    m = [r.info["match"] for r in run.records
         if r.info and r.info.get("match", {}).get("blocks")]
    return sum(100.0 * x["scored"] / x["blocks"] for x in m) / len(m) if m else None
