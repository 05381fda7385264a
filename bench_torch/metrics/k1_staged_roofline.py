"""K1's staged path's share of its roofline (`kernels/k1_staged.py`), in %."""

from bench_torch.roofline import share


def read(run):
    return share(run, "k1_staged")
