"""The no-repeat render (`render_nto1_no_repeat`): exact L1, the global
greedy assignment (each tile used once, by its nearer orientation); the
composite of the items."""

from bench_torch import reference


def render(src, pal, stack, cfg, bits=8):
    return reference.render(src, pal, stack, cfg["mode"], reference.greedy, bits)
