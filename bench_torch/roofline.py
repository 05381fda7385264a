"""A kernel's share of its roofline: the least time the card could take for
the work the cell's inputs need (the operations at the published peak, or
the bytes at the memory rate, whichever is longer) over the kernel's device
time a render in the trace. The operations and bytes come from
`kernels/<kernel>.py`; a kernel the trace does not show gives no share."""

from __future__ import annotations


def share(run, name: str) -> float | None:
    if run.trace is None or run.peaks is None:
        return None
    k = run.kernel(name)
    seconds = run.trace.per_render(k.PATTERN)
    if seconds is None:
        return None
    ops, nbytes, peak = k.work(run)
    least = max(ops / run.peaks[peak], nbytes / run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / seconds
