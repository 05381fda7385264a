"""Output megapixels of every render completed in the window over the
window's seconds (a failed render adds no pixels)."""

from bench_torch.measure import rate


def read(run):
    return rate(sum(r.pixels for r in run.records) / 1e6, run.window_s)
