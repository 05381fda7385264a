"""`torch.cuda.max_memory_allocated` over the window, GB (1e9 bytes)."""


def read(run):
    peak = run.memory.get("window_peak_bytes", 0)
    return peak / 1e9 if peak else None
