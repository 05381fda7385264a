"""% of the traced window in which the device is idle and no program span
below the root `render` is open: idle time the spans do not explain
(`spans.unattributed_pct` over the traced renders' `info["timeline"]`).
Nothing without a device trace, or where no render holds a timeline."""

from bench_torch import records, spans


def read(run):
    host = records.timeline(run)
    if run.trace is None or not host:
        return None
    return spans.unattributed_pct(run.trace, host)
