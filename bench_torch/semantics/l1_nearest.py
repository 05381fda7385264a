"""The repeat render (`render_nto1`): exact L1, each block's nearest library
row, the lowest among equal distances; the composite of the items."""

from bench_torch import reference


def render(src, pal, stack, cfg, bits=8):
    return reference.render(src, pal, stack, cfg["mode"], reference.nearest, bits)
