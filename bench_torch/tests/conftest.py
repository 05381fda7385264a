"""The tiny size of each configuration added after `tiny.TINY` was
written: (mode, tile size, tiles, photo height, photo width)."""

from . import tiny

#: service_m16: full consumption, as in the cell (B = T = 64)
tiny.TINY.setdefault("service_m16", (8, 16, 64, 64, 64))
