"""Mean seconds a render of the render's prologue (the `render.prologue`
span, `render/matched.py` `start_render`: the photo's blocks and the
library built on the card)."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "render.prologue")
