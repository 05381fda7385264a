"""K2's share of its roofline (`kernels/k2.py`), in %."""

from bench_torch.roofline import share


def read(run):
    return share(run, "k2")
