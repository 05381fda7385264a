"""Device time a render of the device-to-host copies in the trace, ms."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.per_render(r"^Memcpy DtoH")
    return None if s is None else 1e3 * s
