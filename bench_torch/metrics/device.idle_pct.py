"""100 - the union of the device's kernel and copy intervals over the traced
window's wall, in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
