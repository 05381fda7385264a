"""The tiny size of `greedy_m32`, registered with `tests.tiny.TINY` for every
test under `bench_torch/`, whichever file is run: (mode, tile size, tiles,
photo height, photo width)."""

from bench_torch.tests import tiny

#: greedy_m32: mode 8, tiles of 8, 300 tiles, 128 x 128 photos (B = 256)
tiny.TINY.setdefault("greedy_m32", (8, 8, 300, 128, 128))
